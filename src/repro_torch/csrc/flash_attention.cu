// Causal / sliding-window / tanh-capped GQA attention with an online
// softmax, one thread block per (q-tile, q-head, batch).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py
// (flash_attention: (m, l, acc) carried in VMEM scratch across the
// sequential kv grid dimension).  Here the kv dimension is a loop inside
// the block, so nothing carries over between blocks.
//
// Per query row i (at key position i + Sk - Sq) and key j:
//   s = (q_i . k_j) * scale;  s = tanh(s / cap) * cap  (cap != 0);
//   s = NEG_INF where j > i (causal) or j <= i - window (window != 0);
//   m' = max(m, max_j s);  p = exp(s - m');  l = l exp(m - m') + sum p;
//   acc = acc exp(m - m') + p @ v;  out = acc / max(l, 1e-30)
// with NEG_INF = -2.3819763e38, finite, so that exp(m - m') of a row whose
// keys so far were all masked is exp(0) = 1 and never NaN.  Keys past Sk
// (the ragged last tile) are -inf: they are not keys at all.
//
// Tiles of keys wholly above the causal diagonal or wholly outside the
// window of every row of the q-tile are skipped.  A row that is masked in
// every tile it visits would get 0 instead of the mean of v; the wrapper
// refuses the one such case (causal with Sq > Sk).
//
// What bounds it: operations.  Prefill at gemma2-9b's shapes (B=2, 16 q
// heads, S=4608, D=256) is ~3.5e11 FLOP per layer with the causal skip,
// 0.35 ms at the card's 989 TFLOP/s bf16; its bytes (q, k, v, out once)
// are ~0.07 ms.  So bf16 runs both products on the tensor cores
// (mma.sync m16n8k16, float32 accumulate), FlashAttention-2 style: four
// warps of 16 query rows each, q, k and v tiles in shared memory (rows
// padded by 16 bytes, so the ldmatrix fragment loads are free of bank
// conflicts), k and v brought in by asynchronous copies (cp.async; v lands
// while the scores are formed), the scores and the output accumulator in
// registers, and the probabilities handed from the score fragments to the
// second product without a trip through memory, as two bf16 terms (hi +
// lo) so that they keep the reference's float32 precision.  float32 inputs
// (held to 2e-5, which rules out TF32) run both products on the CUDA
// cores: each thread owns a 4x4 block of the 64x64 score tile and a
// 4 x D/16 block of the accumulator, tiles in shared memory as float32
// with row stride D + 1.  wgmma, TMA and warp specialisation are later
// work.
//
// Inputs are read through strides, so the model's [B, S, H, D] layout is
// used in place; the head dimension must be contiguous and rows 16-byte
// aligned.  No --use_fast_math: tanhf and expf are the accurate ones.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -2.3819763e38f;
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // float32: 16 x 16 threads, 4 rows x 4 keys
constexpr int MMA_THREADS = 128;   // bf16: 4 warps x 16 query rows

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hkv, Sq, Sk;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  float scale, cap;
  int causal, window;
};

// ---- float32 on the CUDA cores ------------------------------------------

// rows [row0, row0 + 64) of a [nrows, D] slice (row stride rs) into shared
// memory with row stride D + 1; rows past nrows become 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long rs, int row0,
                                          int nrows) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < 64 * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i % CH) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < nrows)
      x = *reinterpret_cast<const float4*>(
          src + static_cast<long long>(row0 + r) * rs + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * 64 * (D + 1) + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;    // BQ x (BK + 1) probabilities

  // heaviest (last) causal q-tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.Hq / p.Hkv);
  const float* q = static_cast<const float*>(p.q) + b * p.q_b + h * p.q_h;
  const float* k = static_cast<const float*>(p.k) + b * p.k_b + g * p.k_h;
  const float* v = static_cast<const float*>(p.v) + b * p.v_b + g * p.v_h;
  float* o = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;     // rows ty + 16 i
  const int tx = tid & 15;     // keys / columns tx + 16 j
  const int q0 = qt * BQ;
  const int off = p.Sk - p.Sq;

  load_tile<D>(Qs, q, p.q_s, q0, p.Sq);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  // the keys any row of this q-tile can see
  const int qlo = q0 + off;
  const int qhi = min(q0 + BQ, p.Sq) - 1 + off;
  int kbeg = 0;
  int kend = p.Sk;
  if (p.causal) kend = min(kend, qhi + 1);
  if (p.window) kbeg = max(0, qlo - p.window + 1);
  kbeg = (kbeg / BK) * BK;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();           // the previous tile's readers are done
    load_tile<D>(Ks, k, p.k_s, k0, p.Sk);
    load_tile<D>(Vs, v, p.v_s, k0, p.Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.cap != 0.0f) x = tanhf(x / p.cap) * p.cap;
        bool ok = true;
        if (p.causal) ok = ok && kj <= qp;
        if (p.window) ok = ok && kj > qp - p.window;
        x = ok ? x : NEG_INF;
        s[i][j] = kj < p.Sk ? x : -INFINITY;
      }
    }

    // online softmax: a row's 64 scores live in the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float mn = fmaxf(m[i], mt);
      const float corr = expf(m[i] - mn);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    const int nk = min(BK, p.Sk - k0);
    for (int j = 0; j < nk; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[static_cast<long long>(qi) * p.o_s + tx + 16 * c] = acc[i][c] * inv;
  }
}


// ---- bfloat16 on the tensor cores ---------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and receives (row i / 4, columns 2 (i % 4), +1) of each
__device__ __forceinline__ void ldsm_x4(unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3,
                                        const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_u32(ptr)));
}

// the same, transposed: lane i receives (rows 2 (i % 4), +1; column i / 4)
__device__ __forceinline__ void ldsm_x4_t(unsigned& r0, unsigned& r1,
                                          unsigned& r2, unsigned& r3,
                                          const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_u32(ptr)));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// (a, b) as bf16 pairs hi + lo with hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// rows [row0, row0 + 64) of a [nrows, D] slice (row stride rs) into shared
// memory (row stride LDS) as one group of async copies; rows past nrows 0
template <int D, int LDS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long rs, int row0,
                                          int nrows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += MMA_THREADS) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    bf16* d = dst + r * LDS + c;
    if (row0 + r < nrows)
      cp_async16(d, src + static_cast<long long>(row0 + r) * rs + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * 3 * 64 * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma_kernel(Params p) {
  constexpr int LDS = D + 8;   // shared row stride: 16 bytes of padding
  constexpr int NT = BK / 8;   // key columns of the score tile, by 8
  constexpr int ND = D / 8;    // output columns, by 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LDS;
  bf16* Vs = Ks + BK * LDS;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.Hq / p.Hkv);
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_b + h * p.q_h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_b + g * p.k_h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_b + g * p.v_h;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_b + h * p.o_h;

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;   // this warp's rows of the tile
  const int gr = lane >> 2;                 // fragment rows gr and gr + 8
  const int tq = lane & 3;                  // fragment columns 2 tq, +1
  const int q0 = qt * BQ;
  const int off = p.Sk - p.Sq;

  copy_rows<D, LDS>(Qs, q, p.q_s, q0, p.Sq);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};   // this thread's part of the row sums

  const int qlo = q0 + off;
  const int qhi = min(q0 + BQ, p.Sq) - 1 + off;
  int kbeg = 0;
  int kend = p.Sk;
  if (p.causal) kend = min(kend, qhi + 1);
  if (p.window) kbeg = max(0, qlo - p.window + 1);
  kbeg = (kbeg / BK) * BK;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();           // the previous tile's readers are done
    copy_rows<D, LDS>(Ks, k, p.k_s, k0, p.Sk);
    copy_rows<D, LDS>(Vs, v, p.v_s, k0, p.Sk);
    cp_async_wait<1>();        // q and k have landed
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a0, a1, a2, a3;
      ldsm_x4(a0, a1, a2, a3,
              Qs + (r0 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                Ks + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                    + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], a0, a1, a2, a3, b0, b1);
        mma_bf16(s[n + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // scale, cap, mask; the row max over the quad that shares the rows
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + r0 + gr + (e >> 1) * 8 + off;
        const int kj = k0 + n * 8 + tq * 2 + (e & 1);
        float x = s[n][e] * p.scale;
        if (p.cap != 0.0f) x = tanhf(x / p.cap) * p.cap;
        bool ok = true;
        if (p.causal) ok = ok && kj <= qp;
        if (p.window) ok = ok && kj > qp - p.window;
        x = ok ? x : NEG_INF;
        x = kj < p.Sk ? x : -INFINITY;
        s[n][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float mn = fmaxf(m[i], mt[i]);
      corr[i] = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    cp_async_wait<0>();        // v has landed
    __syncthreads();
    // acc += p v: the score fragments of keys 16 kk .. 16 kk + 15 are the
    // A fragment of the second product.  p goes in as two bf16 terms,
    // p = hi + lo, so the product keeps p to ~16 bits as the reference's
    // float32 p @ v does (v is exact in bf16); one bf16 term alone would
    // round p to 8 bits.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        unsigned b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3,
                  Vs + (kk * 16 + (lane & 15)) * LDS + n * 8
                      + (lane >> 4) * 8);
        mma_bf16(acc[n], hi[0], hi[1], hi[2], hi[3], b0, b1);
        mma_bf16(acc[n + 1], hi[0], hi[1], hi[2], hi[3], b2, b3);
        mma_bf16(acc[n], lo[0], lo[1], lo[2], lo[3], b0, b1);
        mma_bf16(acc[n + 1], lo[0], lo[1], lo[2], lo[3], b2, b3);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + r0 + gr + i * 8;
    if (row >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<unsigned*>(
          o + static_cast<long long>(row) * p.o_s + n * 8 + tq * 2) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  flash_attention_f32_kernel<D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  flash_attention_mma_kernel<D><<<grid, MMA_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int dtype, int B, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(p, B, stream);
  if (dtype == 1) return launch_bf16<D>(p, B, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const Params& p, int dtype, int B, int D,
                     cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32>(p, dtype, B, stream);
    case 64: return launch<64>(p, dtype, B, stream);
    case 96: return launch<96>(p, dtype, B, stream);
    case 128: return launch<128>(p, dtype, B, stream);
    case 256: return launch<256>(p, dtype, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; the head
// dimension is contiguous.  Returns the CUDA error of the launch (0: ok).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Sk, int D,
    long long q_b, long long q_h, long long q_s,
    long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s,
    long long o_b, long long o_h, long long o_s,
    float scale, float cap, int causal, int window, void* stream) {
  Params p{q, k, v, o, Hq, Hkv, Sq, Sk,
           q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s,
           scale, cap, causal, window};
  return static_cast<int>(
      dispatch(p, dtype, B, D, static_cast<cudaStream_t>(stream)));
}
