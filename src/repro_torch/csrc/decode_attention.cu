// Attention of one new token over a (ring) KV cache, GQA, tanh logit cap:
// flash-decoding with the cache split along its length.
//
// Replaces the Pallas kernel repro/kernels/decode_attention/kernel.py
// (decode_attention: the cache streamed through VMEM block by block along
// the sequential grid dimension, (m, l, acc) of every query head in VMEM
// scratch).
//
// Per query head h (kv head g = h / rep) and cache slot c:
//   s = (q_h . k_cg) * scale;  s = tanh(s / cap) * cap  (cap != 0);
//   s = NEG_INF where kv_pos[c] < 0 (an empty or out-of-window slot);
//   out_h = softmax(s) @ v_g,  the sum divided by max(l, 1e-30)
// with NEG_INF = -2.3819763e38, finite, as in the reference.
//
// What bounds it: bytes.  Each step reads the whole cache of the layer
// once (gemma2-9b at B=2, C=4648: 76 MB of K and V, ~0.023 ms at
// 3.35 TB/s) and does ~2 rep FLOP per byte.  A block per (batch, kv head)
// computes all rep = Hq/Hkv query heads of its group, so each cache row is
// read once per group; B x Hkv is only 16 blocks at that shape, so the
// cache is also split along its length into `nsplit` chunks (about two
// blocks per SM in all).  Each block streams its chunk in tiles of 64
// slots: K and V tiles come into shared memory by 16-byte asynchronous
// copies (cp.async, all of a tile in flight at once; V lands
// while the scores are formed), then eight lanes per slot form the rep dot
// products with a shuffle reduction, one warp per head runs the online
// softmax over the tile, and each thread accumulates its columns of the
// rep output rows in registers.  Each block writes (acc, m, l) of its
// chunk; a second kernel merges the chunks:
//   M = max_i m_i;  L = sum_i l_i exp(m_i - M);
//   out = sum_i acc_i exp(m_i - M) / max(L, 1e-30).
// No --use_fast_math: tanhf and expf are the accurate ones.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -2.3819763e38f;
constexpr int TK = 64;         // cache slots per tile
constexpr int THREADS = 128;   // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 16;    // query heads per kv head
constexpr int MAX_DC = 2;      // D <= 256: columns per thread
constexpr int LPK = 8;         // lanes per cache slot in the score phase

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_pos;
  float* ws;                   // [B*Hkv, nsplit, rep, D + 2]
  void* o;
  int Hq, Hkv, C, D, nsplit, tiles_per_split;
  long long q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h;
  float scale, cap;
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// one 16-byte load, widened to float
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// asynchronous 16-byte copy from device to shared memory (no register
// staging, so all of a tile's copies are in flight at once)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// dst[r][0:D] = src row (row0 + r) for r < n, as one group of async copies
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long rs,
                                          int row0, int n, int D) {
  constexpr int V = Vec<T>::N;
  const int ch = D / V;
  for (int i = threadIdx.x; i < n * ch; i += THREADS) {
    const int r = i / ch;
    const int c = (i % ch) * V;
    cp_async16(dst + r * D + c,
               src + static_cast<long long>(row0 + r) * rs + c);
  }
  cp_async_commit();
}

template <typename T>
size_t partial_smem(int rep, int D) {
  return 2 * sizeof(T) * TK * D + sizeof(int) * TK
         + sizeof(float) * (rep * D + rep * TK + 3 * rep);
}

// MAXR: a compile-time bound on rep (the next power of two), so that the
// per-head loops unroll into straight-line code
template <typename T, int MAXR>
__global__ void __launch_bounds__(THREADS) decode_partial_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rep = p.Hq / p.Hkv;
  const int D = p.D;
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TK * D;
  int* ps = reinterpret_cast<int*>(Vs + TK * D);       // kv_pos of the tile
  float* qs = reinterpret_cast<float*>(ps + TK);       // rep x D
  float* ss = qs + rep * D;                            // rep x TK
  float* ms = ss + rep * TK;
  float* ls = ms + rep;
  float* cs = ls + rep;

  const int bg = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bg / p.Hkv;
  const int g = bg % p.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* q = static_cast<const T*>(p.q) + b * p.q_b + (g * rep) * p.q_h;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + g * p.k_h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + g * p.v_h;

  for (int i = tid; i < rep * D; i += THREADS)
    qs[i] = to_float(q[(i / D) * p.q_h + i % D]);
  for (int r = tid; r < rep; r += THREADS) {
    ms[r] = NEG_INF;
    ls[r] = 0.0f;
  }
  float acc[MAXR][MAX_DC];
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
#pragma unroll
    for (int c = 0; c < MAX_DC; ++c) acc[r][c] = 0.0f;

  constexpr int V = Vec<T>::N;
  const int c_begin = split * p.tiles_per_split * TK;
  const int c_end = min(p.C, c_begin + p.tiles_per_split * TK);
  for (int c0 = c_begin; c0 < c_end; c0 += TK) {
    const int nk = min(TK, c_end - c0);
    __syncthreads();           // q loaded / the previous tile is consumed
    copy_tile(Ks, k, p.k_s, c0, nk, D);
    copy_tile(Vs, v, p.v_s, c0, nk, D);
    if (tid < nk) ps[tid] = p.kv_pos[c0 + tid];
    cp_async_wait<1>();        // K has landed; V is still in flight
    __syncthreads();

    // scores: 8 lanes per slot (4 slots per warp at a time), each lane
    // over 16-byte chunks of the row, summed over the 8 lanes
    for (int j0 = warp * (32 / LPK); j0 < TK; j0 += WARPS * (32 / LPK)) {
      const int j = j0 + lane / LPK;
      float dot[MAXR];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) dot[r] = 0.0f;
      if (j < nk) {
        for (int d0 = (lane % LPK) * V; d0 < D; d0 += LPK * V) {
          float kv[V];
          load16(Ks + j * D + d0, kv);
#pragma unroll
          for (int r = 0; r < MAXR; ++r) {
            if (r < rep) {
#pragma unroll
              for (int e = 0; e < V; ++e) dot[r] += qs[r * D + d0 + e] * kv[e];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rep) {
#pragma unroll
          for (int w = LPK / 2; w >= 1; w >>= 1)
            dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], w);
        }
      }
      if (lane % LPK == 0) {
        const int pos = j < nk ? ps[j] : -1;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < rep) {
            float x = dot[r] * p.scale;
            if (p.cap != 0.0f) x = tanhf(x / p.cap) * p.cap;
            x = pos >= 0 ? x : NEG_INF;
            ss[r * TK + j] = j < nk ? x : -INFINITY;   // past the chunk
          }
        }
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per query head
    for (int r = warp; r < rep; r += WARPS) {
      const float a = ss[r * TK + lane];
      const float c = ss[r * TK + lane + 32];
      float mt = fmaxf(a, c);
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float mp = ms[r];
      const float mn = fmaxf(mp, mt);
      const float ea = expf(a - mn);
      const float ec = expf(c - mn);
      ss[r * TK + lane] = ea;
      ss[r * TK + lane + 32] = ec;
      float sum = ea + ec;
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float corr = expf(mp - mn);
        cs[r] = corr;
        ls[r] = ls[r] * corr + sum;
        ms[r] = mn;
      }
    }
    cp_async_wait<0>();        // V has landed
    __syncthreads();

    // acc[r][d] = acc[r][d] * corr_r + sum_j p[r][j] v[j][d]
#pragma unroll
    for (int dc = 0; dc < MAX_DC; ++dc) {
      const int d = tid + dc * THREADS;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r < rep) acc[r][dc] *= cs[r];
#pragma unroll 4
        for (int j = 0; j < nk; ++j) {
          const float vv = to_float(Vs[j * D + d]);
#pragma unroll
          for (int r = 0; r < MAXR; ++r)
            if (r < rep) acc[r][dc] += ss[r * TK + j] * vv;
        }
      }
    }
  }

  float* w = p.ws + (static_cast<size_t>(bg) * p.nsplit + split) * rep *
                        (D + 2);
#pragma unroll
  for (int dc = 0; dc < MAX_DC; ++dc) {
    const int d = tid + dc * THREADS;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < rep) w[r * (D + 2) + d] = acc[r][dc];
    }
  }
  if (tid < rep) {
    w[tid * (D + 2) + D] = ms[tid];
    w[tid * (D + 2) + D + 1] = ls[tid];
  }
}

// one block per (batch, kv head, query head of the group)
template <typename T>
__global__ void __launch_bounds__(THREADS) decode_combine_kernel(Params p) {
  extern __shared__ float wts[];   // exp(m_i - M) of each chunk i
  const int rep = p.Hq / p.Hkv;
  const int D = p.D;
  const int bg = blockIdx.x / rep;
  const int r = blockIdx.x % rep;
  const int b = bg / p.Hkv;
  const int g = bg % p.Hkv;
  const int lane = threadIdx.x & 31;
  const float* w = p.ws + static_cast<size_t>(bg) * p.nsplit * rep * (D + 2)
                   + r * (D + 2);
  const size_t step = static_cast<size_t>(rep) * (D + 2);
  float M = -INFINITY;         // every warp reduces the same maximum
  for (int i = lane; i < p.nsplit; i += 32) M = fmaxf(M, w[i * step + D]);
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, s));
  for (int i = threadIdx.x; i < p.nsplit; i += THREADS)
    wts[i] = expf(w[i * step + D] - M);
  __syncthreads();
  float L = 0.0f;
  for (int i = lane; i < p.nsplit; i += 32) L += w[i * step + D + 1] * wts[i];
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1)
    L += __shfl_xor_sync(0xffffffffu, L, s);
  const float inv = 1.0f / fmaxf(L, 1e-30f);
  T* o = static_cast<T*>(p.o) + b * p.o_b + (g * rep + r) * p.o_h;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.0f;
    for (int i = 0; i < p.nsplit; ++i) a += w[i * step + d] * wts[i];
    store(o + d, a * inv);
  }
}

template <typename T, int MAXR>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int rep = p.Hq / p.Hkv;
  const size_t bytes = partial_smem<T>(rep, p.D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<T, MAXR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  decode_partial_kernel<T, MAXR><<<dim3(B * p.Hkv, p.nsplit), THREADS,
                                   bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * p.Hkv * rep, THREADS,
                             sizeof(float) * p.nsplit, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, cudaStream_t stream) {
  const int rep = p.Hq / p.Hkv;
  if (rep <= 1) return launch<T, 1>(p, B, stream);
  if (rep <= 2) return launch<T, 2>(p, B, stream);
  if (rep <= 4) return launch<T, 4>(p, B, stream);
  if (rep <= 8) return launch<T, 8>(p, B, stream);
  if (rep <= MAX_REP) return launch<T, MAX_REP>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention_tile() { return TK; }
extern "C" int decode_attention_max_rep() { return MAX_REP; }

// dtype: 0 float32, 1 bfloat16.  q [B, Hq, D]; k, v [B, C, Hkv, D] with
// strides in elements (D contiguous); kv_pos [C] int32; ws: float32
// scratch of B*Hkv*nsplit*(Hq/Hkv)*(D+2).  Returns the CUDA error (0: ok).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_pos,
    void* ws, void* o, int dtype, int B, int Hq, int Hkv, int C, int D,
    int nsplit, int tiles_per_split,
    long long q_b, long long q_h, long long k_b, long long k_s,
    long long k_h, long long v_b, long long v_s, long long v_h,
    long long o_b, long long o_h, float scale, float cap, void* stream) {
  Params p{q, k, v, static_cast<const int*>(kv_pos),
           static_cast<float*>(ws), o, Hq, Hkv, C, D, nsplit,
           tiles_per_split, q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b,
           o_h, scale, cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(p, B, s));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(p, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
