// Capacity-batched expert matmul (the MoE grouped GEMM):
//   out[e, c, f] = sum_d buf[e, c, d] * w[e, d, f]
// summed in float32 and rounded once to the input dtype.
//
// Replaces the Pallas kernel repro/kernels/moe_gmm/kernel.py
// (expert_matmul: grid (E, C/bc, F/bf, D/bd), the contraction the
// innermost sequential grid dimension with a float32 VMEM accumulator).
// Here the contraction is a loop inside the block, so nothing carries over
// between blocks.
//
// What bounds it depends on C, the rows per expert (moe_capacity):
// - Prefill (granite-moe-3b-a800m at B=2 x 4096 tokens: E=40, C=2048,
//   D=1536, F=512) does 2 E C D F = 1.3e11 operations on ~0.4 GB: about
//   0.13 ms at the card's 989 TFLOP/s bf16, so bf16 runs on the tensor
//   cores (mma.sync m16n8k16, float32 accumulate): 128 x 128 output tiles
//   per block, 8 warps of 32 x 64, k-tiles of 32 brought into shared
//   memory by asynchronous copies (cp.async) two deep, so the next tile
//   lands while this one is multiplied; rows padded by 16 bytes, so the
//   ldmatrix fragment loads are free of bank conflicts.
// - Decode (C = 4 at B=2) reads every expert's weights for a few rows:
//   ~63 MB of one weight stack per launch, 0.019 ms at 3.35 TB/s, while
//   its operations are negligible.  A tensor-core tile would idle, so
//   C <= 8 runs on the CUDA cores, built around streaming w once: a block
//   owns 128 columns of one expert, each lane 4 neighbouring columns (so a
//   warp reads 256 or 512 contiguous bytes of a row), the 16 warps split
//   the rows of w between them, and a tree through shared memory adds the
//   warps' partial sums in a fixed order.
// - float32 inputs (held to tol * d with float32 accumulation, which rules
//   out TF32) with C > 8 run a tiled CUDA-core GEMM: 64 x 64 tiles, 4 x 4
//   outputs per thread, k-tiles of 16 in shared memory.
// Rows past C, columns past F and depth past D are masked; D and F must be
// multiples of 8 (16-byte copies), which the wrapper checks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---- C <= 8: CUDA cores, streaming the weights once ----------------------

constexpr int SK_MAXC = 8;       // rows per expert this path takes
constexpr int SK_WARPS = 16;
constexpr int SK_COLS = 128;     // columns per block: 32 lanes x 4

// four neighbouring weights of row d as float
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<unsigned*>(&a);
  x.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = x;
}

template <typename T>
__global__ void __launch_bounds__(SK_WARPS * 32)
expert_matmul_skinny(const T* __restrict__ buf, const T* __restrict__ w,
                     T* __restrict__ out, int C, int D, int F) {
  __shared__ float red[SK_WARPS / 2][SK_MAXC][SK_COLS];
  const int e = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * SK_COLS + lane * 4;
  const bool live = col < F;
  const T* a = buf + static_cast<long long>(e) * C * D;
  const T* wb = w + static_cast<long long>(e) * D * F + col;

  float acc[SK_MAXC][4];
#pragma unroll
  for (int c = 0; c < SK_MAXC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.0f;

  if (live) {
    int d = warp;
    // four rows in flight per warp
    for (; d + 3 * SK_WARPS < D; d += 4 * SK_WARPS) {
      float v[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        load4(wb + static_cast<long long>(d + u * SK_WARPS) * F, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < SK_MAXC; ++c) {
          if (c < C) {
            const float x = to_f(a[static_cast<long long>(c) * D + d +
                                   u * SK_WARPS]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[c][j] += x * v[u][j];
          }
        }
      }
    }
    for (; d < D; d += SK_WARPS) {
      float v[4];
      load4(wb + static_cast<long long>(d) * F, v);
#pragma unroll
      for (int c = 0; c < SK_MAXC; ++c) {
        if (c < C) {
          const float x = to_f(a[static_cast<long long>(c) * D + d]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[c][j] += x * v[j];
        }
      }
    }
  }

  // warps [h, 2h) hand their sums to warps [0, h), h = 8, 4, 2, 1
#pragma unroll
  for (int h = SK_WARPS / 2; h >= 1; h >>= 1) {
    if (warp >= h && warp < 2 * h) {
#pragma unroll
      for (int c = 0; c < SK_MAXC; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[warp - h][c][lane * 4 + j] = acc[c][j];
    }
    __syncthreads();
    if (warp < h) {
#pragma unroll
      for (int c = 0; c < SK_MAXC; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] += red[warp][c][lane * 4 + j];
    }
    __syncthreads();
  }
  if (warp == 0 && live) {
    T* o = out + static_cast<long long>(e) * C * F + col;
#pragma unroll
    for (int c = 0; c < SK_MAXC; ++c)
      if (c < C) store4(o + static_cast<long long>(c) * F, acc[c]);
  }
}

// ---- bf16, C > 8: tensor cores --------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int MMA_THREADS = 256;   // 8 warps: 4 along M x 2 along N
constexpr int LDA = BK + 8;        // shared row strides, 16 bytes of padding
constexpr int LDB = BN + 8;

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

__device__ __forceinline__ void ldsm_x4(unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3,
                                        const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_u32(ptr)));
}

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

// the k-tile [k0, k0 + BK) of A (rows m0..) and B (columns n0..) as one
// group of async copies; chunks outside the matrices become 0
__device__ __forceinline__ void load_tiles(bf16* As, bf16* Bs,
                                           const bf16* a, const bf16* b,
                                           int m0, int n0, int k0, int C,
                                           int D, int F) {
  for (int i = threadIdx.x; i < BM * (BK / 8); i += MMA_THREADS) {
    const int r = i / (BK / 8);
    const int c = (i % (BK / 8)) * 8;
    bf16* dst = As + r * LDA + c;
    if (m0 + r < C && k0 + c < D)
      cp_async16(dst, a + static_cast<long long>(m0 + r) * D + k0 + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < BK * (BN / 8); i += MMA_THREADS) {
    const int r = i / (BN / 8);
    const int c = (i % (BN / 8)) * 8;
    bf16* dst = Bs + r * LDB + c;
    if (k0 + r < D && n0 + c < F)
      cp_async16(dst, b + static_cast<long long>(k0 + r) * F + n0 + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(MMA_THREADS)
expert_matmul_mma(const bf16* __restrict__ buf, const bf16* __restrict__ w,
                  bf16* __restrict__ out, int C, int D, int F) {
  __shared__ __align__(16) bf16 As[2][BM * LDA];
  __shared__ __align__(16) bf16 Bs[2][BK * LDB];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bf16* a = buf + static_cast<long long>(e) * C * D;
  const bf16* b = w + static_cast<long long>(e) * D * F;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * 32;     // this warp's rows of the tile
  const int wn = (warp >> 2) * 64;    // and columns
  const int gr = lane >> 2;           // fragment rows gr and gr + 8
  const int tq = lane & 3;            // fragment columns 2 tq, +1

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  const int nk = (D + BK - 1) / BK;
  load_tiles(As[0], Bs[0], a, b, m0, n0, 0, C, D, F);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tiles(As[st ^ 1], Bs[st ^ 1], a, b, m0, n0, (kt + 1) * BK, C, D,
                 F);
      cp_async_wait<1>();            // tile kt has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* At = As[st];
    const bf16* Bt = Bs[st];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i][0], af[i][1], af[i][2], af[i][3],
                At + (wm + i * 16 + (lane & 15)) * LDA + kk * 16
                    + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        unsigned b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3,
                  Bt + (kk * 16 + (lane & 15)) * LDB + wn + j * 8
                      + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], b0,
                   b1);
          mma_bf16(acc[i][j + 1], af[i][0], af[i][1], af[i][2], af[i][3],
                   b2, b3);
        }
      }
    }
    __syncthreads();                 // this stage's readers are done
  }

  bf16* o = out + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + gr + h * 8;
      if (row >= C) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn + j * 8 + tq * 2;
        if (col < F) {
          __nv_bfloat162 v = __floats2bfloat162_rn(acc[i][j][2 * h],
                                                   acc[i][j][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              o + static_cast<long long>(row) * F + col) = v;
        }
      }
    }
  }
}

// ---- float32, C > 8: CUDA cores -------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;
constexpr int F_THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(F_THREADS)
expert_matmul_f32(const float* __restrict__ buf, const float* __restrict__ w,
                  float* __restrict__ out, int C, int D, int F) {
  __shared__ __align__(16) float As[FK][FM + 4];   // A transposed: [k][m]
  __shared__ __align__(16) float Bs[FK][FN + 4];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;
  const float* a = buf + static_cast<long long>(e) * C * D;
  const float* b = w + static_cast<long long>(e) * D * F;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  // this thread's element of each tile load
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int bk = tid >> 4, bn = (tid & 15) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += FK) {
    float4 av = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 bv = av;
    if (m0 + ar < C && k0 + ak < D)
      av = __ldg(reinterpret_cast<const float4*>(
          a + static_cast<long long>(m0 + ar) * D + k0 + ak));
    if (k0 + bk < D && n0 + bn < F)
      bv = __ldg(reinterpret_cast<const float4*>(
          b + static_cast<long long>(k0 + bk) * F + n0 + bn));
    __syncthreads();                 // the previous tile's readers are done
    As[ak + 0][ar] = av.x;
    As[ak + 1][ar] = av.y;
    As[ak + 2][ar] = av.z;
    As[ak + 3][ar] = av.w;
    *reinterpret_cast<float4*>(&Bs[bk][bn]) = bv;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 y = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float xa[4] = {x.x, x.y, x.z, x.w};
      const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xa[i] * ya[j];
    }
  }
  float* o = out + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    const int col = n0 + tx * 4;
    if (row < C && col < F)
      store4(o + static_cast<long long>(row) * F + col, acc[i]);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  buf [E, C, D], w [E, D, F] and out
// [E, C, F] are contiguous; D and F are multiples of 8.  Returns the CUDA
// error of the launch (0: ok).
extern "C" int expert_matmul_launch(const void* buf, const void* w,
                                    void* out, int dtype, int E, int C,
                                    int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C <= SK_MAXC) {
    const dim3 grid((F + SK_COLS - 1) / SK_COLS, E);
    if (dtype == 0)
      expert_matmul_skinny<float><<<grid, SK_WARPS * 32, 0, s>>>(
          static_cast<const float*>(buf), static_cast<const float*>(w),
          static_cast<float*>(out), C, D, F);
    else if (dtype == 1)
      expert_matmul_skinny<bf16><<<grid, SK_WARPS * 32, 0, s>>>(
          static_cast<const bf16*>(buf), static_cast<const bf16*>(w),
          static_cast<bf16*>(out), C, D, F);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (dtype == 1) {
    const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
    expert_matmul_mma<<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(buf), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), C, D, F);
  } else if (dtype == 0) {
    const dim3 grid((F + FN - 1) / FN, (C + FM - 1) / FM, E);
    expert_matmul_f32<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(buf), static_cast<const float*>(w),
        static_cast<float*>(out), C, D, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
