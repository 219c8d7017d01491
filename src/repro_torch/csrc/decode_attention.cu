// Attention of one new token over a (ring) KV cache, GQA, tanh logit cap:
// the cache of each (batch, kv head) split over a thread-block cluster,
// streamed by TMA, and merged inside the cluster.
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
// 3.35 TB/s) and does ~2 rep FLOP per byte, far below the card's ratio of
// operations to bytes.  So the design keeps the cache stream dense:
// - The cache of one (batch, kv head) group is split, in whole tiles, over
//   the blocks of a thread-block cluster (at most 8, the portable size;
//   the wrapper picks the size from the card's occupancy so that the grid
//   fills the SMs once).
// - In each block one producer thread keeps a ring of STAGES tiles in
//   flight by TMA: a tile is TK slots of K and of V (4-D tensor maps over
//   the caller's [B, C, Hkv, D] strides, no swizzle, so a tile lands as a
//   dense [TK][D] array) and the TK kv_pos entries beside them, all
//   completing on one mbarrier.  The ring holds ~96 KB.
// - The consumer warps work on the tiles that have landed, on the CUDA
//   cores, each warp on its own share of every tile with its own online
//   softmax, so the loop over the tiles has no block barrier: a warp waits
//   for a tile, forms its slots' scores (eight lanes per slot, 16-byte
//   reads of K, q in float32), updates its (m, l) with shuffles, adds p v
//   into its lanes' columns (D / 32 each) and frees the stage with one
//   arrive.  The warps split a tile by slots, and for wide groups (rep 8
//   and 16, q read from shared memory at every tile) by heads too, so
//   that a lane holds the sums of at most two heads; a single query head
//   per kv head with tiles of 64 slots (zamba2's shared block) gets 16
//   consumer warps, the others 8.
// - The warps' (m, l, acc) are merged in warp order in shared memory, and
//   the blocks of a cluster inside the launch: each writes its (acc, m, l)
//   into rank 0's shared memory (distributed shared memory, each rank in
//   its own slot) and leaves; rank 0 merges the ranks in rank order:
//     M = max_i m_i;  L = sum_i l_i exp(m_i - M);
//     out = sum_i acc_i exp(m_i - M) / max(L, 1e-30),
//   and, where the caller asks for it, each row's log-sum-exp M + log L
//   (float32 [B, Hq]): the weight by which parts of one row computed
//   over disjoint slices of a cache merge across launches or ranks.
//   So one launch, no workspace, no atomics, and bitwise repeatable.
// The products stay on the CUDA cores: at ~2 rep FLOP per byte they are
// a small part of a tile's work.  clock64 stamps of an instrumented copy
// (not kept) showed where a block's time went while the consumers still
// met at two block barriers per tile: the producer waited on free stages
// for most of a block's life and the consumers seldom waited on data, so
// the consumers set the pace; deeper rings, larger tiles and two blocks
// to an SM (clusters of 16) did not help there, independent warps did.
// No --use_fast_math: tanhf and expf are the accurate ones.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr float NEG_INF = -2.3819763e38f;
constexpr int MAX_REP = 16;                // query heads per kv head
constexpr int MAX_CLUSTER = 8;             // blocks per (batch, kv head)
constexpr int LPK = 8;                     // lanes per slot in the scores
constexpr int RING_BYTES = 96 * 1024;      // the ring's budget
constexpr int BAR_CONSUMERS = 1;           // named barrier of the consumers

__host__ __device__ constexpr int cmin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}
__host__ __device__ constexpr int up(int x, int a) {
  return (x + a - 1) / a * a;
}

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType TMA =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// the tiling of one instantiation
template <typename T, int D, int MAXR>
struct Cfg {
  static constexpr int ROW = D * static_cast<int>(sizeof(T));  // bytes
  // slots per tile: about 16 KB of K (and of V) per stage
  static constexpr int TK = ROW >= 1024 ? 16 : ROW >= 512 ? 32 : 64;
  static constexpr int TILE = TK * ROW;
  static constexpr int POS = up(TK * 4, 128);           // kv_pos of a tile
  static constexpr int STAGE = 2 * TILE + POS;
  static constexpr int TX = 2 * TILE + TK * 4;          // TMA bytes a stage
  static constexpr int STAGES = cmin(8, cmax(3, RING_BYTES / STAGE));
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  // q held in registers across the tiles (narrow groups), or read from
  // shared memory at every tile (wide ones, where it would crowd out the
  // sums); two blocks to an SM where it is held
  static constexpr bool QREG = (MAXR <= 2 && MAXR * D <= 512)
                               || MAXR * D <= 256;
  // consumer warps (and one producer warp): 8, or 16 for a single query
  // head per kv head with tiles of 64 slots (zamba2's shared block), where
  // more warps keep more of the stream moving
  static constexpr int CWARPS = QREG && MAXR == 1 && TK == 64 ? 16 : 8;
  static constexpr int CTHREADS = CWARPS * 32;
  static constexpr int THREADS = CTHREADS + 32;
  // the warps split a tile's heads WH ways and its slots WS ways: narrow
  // groups by slots alone, wide ones by heads too, so that a lane holds
  // the sums of at most HPW heads
  static constexpr int WH = QREG ? 1 : cmin(MAXR, 8);
  static constexpr int HPW = MAXR / WH;                 // heads per warp
  static constexpr int WS = CWARPS / WH;
  static constexpr int SPW = TK / WS;                   // slots per warp
  static constexpr int PASSES = (SPW + 32 / LPK - 1) / (32 / LPK);
  static constexpr int CPL = D / 32;                    // p v: columns a lane
  static constexpr int RED = (MAXR * D + CTHREADS - 1) / CTHREADS;
  static constexpr int MINB = QREG && CWARPS == 8 ? 2 : 1;  // blocks an SM
  static constexpr int QD = up(D, LPK * VEC);           // q's row stride
  // the ring, later the warps' partial sums, and in rank 0 the parts of
  // every rank of the cluster, one after the other in the same bytes
  static constexpr int REGION = up(cmax(STAGES * STAGE,
      cmax(WS * MAXR * D * 4, MAX_CLUSTER * MAXR * (D + 2) * 4)), 1024);
  static constexpr int QS = MAXR * QD * 4;              // q, float32
  static constexpr int WARPS8 = cmax(WS, MAX_CLUSTER);
  static constexpr int SMALL = (2 * MAXR + 2 * WARPS8 * MAXR) * 4;
  static constexpr int BARS = 2 * STAGES * 8;
  static constexpr int SMEM = 1024 + REGION + QS + up(SMALL, 16) + BARS;
};

struct Params {
  const void* q;
  void* o;
  float* lse;                  // [B, Hq] log-sum-exp of the scores, or null
  int Hq, Hkv, C, per, tiles;
  long long q_b, q_h, o_b, o_h;
  float scale, cap;
};

__device__ __forceinline__ void ld_f4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
// one 16-byte chunk of a cache row, widened to float
__device__ __forceinline__ void load16(const float* p, float* out) {
  ld_f4(p, out);
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
// four neighbouring columns of a cache row
__device__ __forceinline__ void load4(const float* p, float* out) {
  ld_f4(p, out);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
// CPL neighbouring columns of a cache row (the lane's share of p v)
template <int CPL>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (CPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CPL; i += 4) ld_f4(p + i, out + i);
  } else if constexpr (CPL == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i) out[i] = p[i];
  }
}
template <int CPL>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float* out) {
  if constexpr (CPL % 8 == 0) {
#pragma unroll
    for (int i = 0; i < CPL; i += 8) load16(p + i, out + i);
  } else if constexpr (CPL == 4) {
    load4(p, out);
  } else if constexpr (CPL == 2) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x; out[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i) out[i] = __bfloat162float(p[i]);
  }
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ``x`` through a register move the compiler cannot see through, so
// that what is read at an address derived from it is not hoisted out of
// a loop
__device__ __forceinline__ int opaque32(int x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

// where q[d] lives in shared memory: lane ``sub`` of a slot's eight reads
// the VEC values d = pass LPK VEC + sub VEC + e, and each 4-value half of
// them is stored so that eight lanes read 128 contiguous bytes
template <int VEC>
__device__ __forceinline__ int q_index(int d) {
  const int pass = d / (LPK * VEC);
  const int sub = (d / VEC) % LPK;
  const int e = d % VEC;
  return pass * LPK * VEC + (e / 4) * LPK * 4 + sub * 4 + e % 4;
}

// grid (cluster, B * Hkv), cluster (cluster, 1, 1): rank r of the cluster
// owns tiles [r per, (r + 1) per) of its group's cache.
template <typename T, int D, int MAXR>
__global__ void __launch_bounds__(Cfg<T, D, MAXR>::THREADS,
                                     Cfg<T, D, MAXR>::MINB)
decode_attention_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tp, Params p) {
  using K = Cfg<T, D, MAXR>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* region = base;
  float* qs = reinterpret_cast<float*>(base + K::REGION);
  float* ms = qs + MAXR * K::QD;               // the block's m and l
  float* ls = ms + MAXR;
  float* wts = ls + MAXR;                      // [warp or rank][MAXR]
  float* inv = wts + K::WARPS8 * MAXR;         // [warp][MAXR] / [MAXR]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + K::REGION + K::QS + up(K::SMALL, 16));
  uint64_t* empty = full + K::STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncl = static_cast<int>(gridDim.x);  // the cluster spans x
  const int bg = blockIdx.y;
  const int b = bg / p.Hkv;
  const int g = bg % p.Hkv;
  const int rep = p.Hq / p.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t_begin = rank * p.per;
  const int ntiles = max(0, min(p.tiles, t_begin + p.per) - t_begin);

  if (tid == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], K::CWARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == K::CWARPS) {
    // ---- producer: one thread keeps the ring full ----------------------
    if (lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % K::STAGES;
        if (t >= K::STAGES) mbar_wait(&empty[s], ((t / K::STAGES) - 1) & 1);
        unsigned char* st = region + s * K::STAGE;
        const int c0 = (t_begin + t) * K::TK;
        mbar_expect_tx(&full[s], K::TX);
        tma_load_4d(st, &tk, &full[s], 0, c0, g, b);
        tma_load_4d(st + K::TILE, &tv, &full[s], 0, c0, g, b);
        tma_load_2d(st + 2 * K::TILE, &tp, &full[s], c0, 0);
      }
    }
    __syncwarp();
  }

  float red[K::RED];
  if (warp < K::CWARPS) {
    // ---- consumers: warp w owns heads hw0 .. hw0 + HPW - 1 and slots
    // ws SPW .. (ws + 1) SPW - 1 of every tile --------------------------
    const T* q = static_cast<const T*>(p.q) + b * p.q_b + (g * rep) * p.q_h;
    for (int i = tid; i < rep * D; i += K::CTHREADS)
      qs[(i / D) * K::QD + q_index<K::VEC>(i % D)] =
          to_float(q[(i / D) * p.q_h + i % D]);
    const int hw0 = (warp % K::WH) * K::HPW;
    const int ws = warp / K::WH;
    const int grp = lane / LPK;                // slot of the lane in a pass
    const int sub = lane % LPK;
    float m[K::HPW], l[K::HPW], acc[K::HPW][K::CPL];
#pragma unroll
    for (int r = 0; r < K::HPW; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < K::CPL; ++c) acc[r][c] = 0.0f;
    }
    bar_sync(BAR_CONSUMERS, K::CTHREADS);      // q is in

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % K::STAGES;
      const unsigned char* st = region + s * K::STAGE;
      const T* Ks = reinterpret_cast<const T*>(st);
      const T* Vs = reinterpret_cast<const T*>(st + K::TILE);
      const int* ps = reinterpret_cast<const int*>(st + 2 * K::TILE);
      const int nk = min(K::TK, p.C - (t_begin + t) * K::TK);
      mbar_wait(&full[s], (t / K::STAGES) & 1);

      // scores of the warp's slots, LPK lanes per slot: every lane of a
      // slot's group ends with its scores
      const float* qw = qs + (K::QREG ? 0 : opaque32(0)) + hw0 * K::QD;
      float sv[K::PASSES][K::HPW];
#pragma unroll
      for (int ps8 = 0; ps8 < K::PASSES; ++ps8) {
        const int jj = ps8 * (32 / LPK) + grp;
        const int j = ws * K::SPW + jj;
        const bool in = jj < K::SPW && j < nk;
        float dot[K::HPW];
#pragma unroll
        for (int r = 0; r < K::HPW; ++r) dot[r] = 0.0f;
        if (in) {
#pragma unroll
          for (int d0 = sub * K::VEC; d0 < D; d0 += LPK * K::VEC) {
            float kv[K::VEC];
            load16(Ks + j * D + d0, kv);
            const int qi = (d0 / (LPK * K::VEC)) * LPK * K::VEC + sub * 4;
#pragma unroll
            for (int r = 0; r < K::HPW; ++r) {
              if (hw0 + r < rep) {
#pragma unroll
                for (int h = 0; h < K::VEC / 4; ++h) {
                  float qv[4];
                  ld_f4(qw + r * K::QD + qi + h * LPK * 4, qv);
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    dot[r] += qv[e] * kv[h * 4 + e];
                }
              }
            }
          }
        }
        const int pos = in ? ps[j] : -1;
#pragma unroll
        for (int r = 0; r < K::HPW; ++r) {
#pragma unroll
          for (int w = LPK / 2; w >= 1; w >>= 1)
            dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], w);
          float x = dot[r] * p.scale;
          if (p.cap != 0.0f) x = tanhf(x / p.cap) * p.cap;
          x = pos >= 0 ? x : NEG_INF;
          sv[ps8][r] = in ? x : -INFINITY;     // past the cache
        }
      }

      // online softmax over the warp's slots, then p v
#pragma unroll
      for (int r = 0; r < K::HPW; ++r) {
        float mt = sv[0][r];
#pragma unroll
        for (int ps8 = 1; ps8 < K::PASSES; ++ps8) mt = fmaxf(mt, sv[ps8][r]);
#pragma unroll
        for (int w = LPK; w < 32; w <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
        const float mn = fmaxf(m[r], mt);
        float sum = 0.0f;
#pragma unroll
        for (int ps8 = 0; ps8 < K::PASSES; ++ps8) {
          sv[ps8][r] = expf(sv[ps8][r] - mn);
          sum += sv[ps8][r];
        }
#pragma unroll
        for (int w = LPK; w < 32; w <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, w);
        const float corr = expf(m[r] - mn);
        l[r] = l[r] * corr + sum;
        m[r] = mn;
#pragma unroll
        for (int c = 0; c < K::CPL; ++c) acc[r][c] *= corr;
      }
#pragma unroll
      for (int ps8 = 0; ps8 < K::PASSES; ++ps8) {
#pragma unroll
        for (int g8 = 0; g8 < 32 / LPK; ++g8) {
          const int jj = ps8 * (32 / LPK) + g8;
          const int j = ws * K::SPW + jj;
          if (jj >= K::SPW || j >= nk) continue;   // uniform in the warp
          float vv[K::CPL];
          load_cols<K::CPL>(Vs + j * D + lane * K::CPL, vv);
#pragma unroll
          for (int r = 0; r < K::HPW; ++r) {
            const float pj = __shfl_sync(0xffffffffu, sv[ps8][r], g8 * LPK);
#pragma unroll
            for (int c = 0; c < K::CPL; ++c) acc[r][c] += pj * vv[c];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the slot groups' (m, l, acc) of each head, merged in group order
    bar_sync(BAR_CONSUMERS, K::CTHREADS);      // the ring is consumed
    float* part = reinterpret_cast<float*>(region);   // [WS][rep][D]
#pragma unroll
    for (int r = 0; r < K::HPW; ++r) {
      const int h = hw0 + r;
      if (h < rep) {
#pragma unroll
        for (int c = 0; c < K::CPL; ++c)
          part[(ws * rep + h) * D + lane * K::CPL + c] = acc[r][c];
        if (lane == 0) {
          wts[ws * MAXR + h] = m[r];
          inv[ws * MAXR + h] = l[r];
        }
      }
    }
    bar_sync(BAR_CONSUMERS, K::CTHREADS);
    if (tid < rep) {
      float M = -INFINITY;
      for (int w8 = 0; w8 < K::WS; ++w8) M = fmaxf(M, wts[w8 * MAXR + tid]);
      float L = 0.0f;
      for (int w8 = 0; w8 < K::WS; ++w8) {
        const float e = expf(wts[w8 * MAXR + tid] - M);
        L += inv[w8 * MAXR + tid] * e;
        wts[w8 * MAXR + tid] = e;
      }
      ms[tid] = M;
      ls[tid] = L;
    }
    bar_sync(BAR_CONSUMERS, K::CTHREADS);
#pragma unroll
    for (int i = 0; i < K::RED; ++i) {
      const int e = tid + i * K::CTHREADS;
      float sum = 0.0f;
      if (e < rep * D) {
        const int r = e / D;
        for (int w8 = 0; w8 < K::WS; ++w8)
          sum += part[w8 * rep * D + e] * wts[w8 * MAXR + r];
      }
      red[i] = sum;
    }
  }

  // every block of the cluster is done with its shared memory before any
  // block writes into rank 0's
  cluster_arrive();
  cluster_wait();
  float* parts = cluster.map_shared_rank(reinterpret_cast<float*>(region), 0)
                 + rank * rep * (D + 2);       // [rep][D + 2] of this rank
  if (warp < K::CWARPS) {
#pragma unroll
    for (int i = 0; i < K::RED; ++i) {
      const int e = tid + i * K::CTHREADS;
      if (e < rep * D) parts[(e / D) * (D + 2) + e % D] = red[i];
    }
    if (tid < rep) {
      parts[tid * (D + 2) + D] = ms[tid];
      parts[tid * (D + 2) + D + 1] = ls[tid];
    }
  }
  cluster_arrive();
  if (rank != 0) return;

  // rank 0 merges the ranks in rank order
  cluster_wait();
  const float* all = reinterpret_cast<const float*>(region);
  const int step = rep * (D + 2);
  if (tid < rep) {
    float M = -INFINITY;
    for (int r8 = 0; r8 < ncl; ++r8)
      M = fmaxf(M, all[r8 * step + tid * (D + 2) + D]);
    float L = 0.0f;
    for (int r8 = 0; r8 < ncl; ++r8) {
      const float w = expf(all[r8 * step + tid * (D + 2) + D] - M);
      wts[r8 * MAXR + tid] = w;
      L += all[r8 * step + tid * (D + 2) + D + 1] * w;
    }
    inv[tid] = 1.0f / fmaxf(L, 1e-30f);
    if (p.lse != nullptr)
      p.lse[static_cast<long long>(b) * p.Hq + g * rep + tid] = M + logf(L);
  }
  __syncthreads();
  T* o = static_cast<T*>(p.o) + b * p.o_b + (g * rep) * p.o_h;
  for (int e = tid; e < rep * D; e += K::THREADS) {
    const int r = e / D;
    const int d = e % D;
    float a = 0.0f;
    for (int r8 = 0; r8 < ncl; ++r8)
      a += all[r8 * step + r * (D + 2) + d] * wts[r8 * MAXR + r];
    store(o + r * p.o_h + d, a * inv[r]);
  }
}

// a tensor map (D, C, Hkv, B) over a [B, C, Hkv, D] cache with element
// strides (b, c, h), boxes of one tile (D, TK, 1, 1)
template <typename T, int D, int MAXR>
bool cache_map(CUtensorMap* map, const void* base, int B, int C, int Hkv,
               long long sb, long long sc, long long sh) {
  using K = Cfg<T, D, MAXR>;
  const long long es = sizeof(T);
  // a dimension of size 1 is never stepped: give it a valid stride
  const long long big = (static_cast<long long>(C) * Hkv * D + 8) * es;
  const uint64_t sizes[4] = {static_cast<uint64_t>(D),
                             static_cast<uint64_t>(C),
                             static_cast<uint64_t>(Hkv),
                             static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {
      static_cast<uint64_t>(C > 1 ? sc * es : big),
      static_cast<uint64_t>(Hkv > 1 ? sh * es : big),
      static_cast<uint64_t>(B > 1 ? sb * es : big)};
  const uint32_t box[4] = {static_cast<uint32_t>(D),
                           static_cast<uint32_t>(K::TK), 1, 1};
  return make_tensor_map_dense(map, Elem<T>::TMA, base, 4, sizes, strides,
                               box) == CUDA_SUCCESS;
}

// once per instantiation: the shared memory above 48 KB
template <typename T, int D, int MAXR>
cudaError_t prepare() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, D, MAXR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<T, D, MAXR>::SMEM);
  return attr;
}

struct Args {
  const void *q, *k, *v, *kv_pos;
  void* o;
  float* lse;
  int B, Hq, Hkv, C, cluster, per;
  long long q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h;
  float scale, cap;
};

template <typename T, int D, int MAXR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using K = Cfg<T, D, MAXR>;
  const auto kernel = decode_attention_kernel<T, D, MAXR>;
  const cudaError_t attr = prepare<T, D, MAXR>();
  if (attr != cudaSuccess) return attr;
  if (a.cluster < 1 || a.cluster > MAX_CLUSTER || a.per < 1)
    return cudaErrorInvalidValue;
  const int tiles = (a.C + K::TK - 1) / K::TK;
  if (static_cast<long long>(a.cluster) * a.per < tiles)
    return cudaErrorInvalidValue;
  CUtensorMap tk, tv, tp;
  const uint64_t p_sizes[2] = {static_cast<uint64_t>(a.C), 1};
  const uint64_t p_strides[1] = {static_cast<uint64_t>(up(a.C * 4, 16))};
  const uint32_t p_box[2] = {static_cast<uint32_t>(K::TK), 1};
  if (!cache_map<T, D, MAXR>(&tk, a.k, a.B, a.C, a.Hkv, a.k_b, a.k_s,
                             a.k_h) ||
      !cache_map<T, D, MAXR>(&tv, a.v, a.B, a.C, a.Hkv, a.v_b, a.v_s,
                             a.v_h) ||
      make_tensor_map_dense(&tp, CU_TENSOR_MAP_DATA_TYPE_INT32, a.kv_pos, 2,
                            p_sizes, p_strides, p_box) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  Params p{a.q, a.o, a.lse, a.Hq, a.Hkv, a.C, a.per, tiles, a.q_b, a.q_h,
           a.o_b, a.o_h, a.scale, a.cap};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.B * a.Hkv);
  cfg.blockDim = dim3(K::THREADS);
  cfg.dynamicSmemBytes = K::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tk, tv, tp, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// f.operator()<T, D, MAXR>() of the instantiation that serves (dtype, D,
// rep), -1 where there is none.  MAXR: a compile-time bound on rep (the
// next power of two), so that the per-head loops unroll into straight-line
// code.
template <typename T, int D, typename F>
long long by_rep(int rep, const F& f) {
  if (rep <= 1) return f.template operator()<T, D, 1>();
  if (rep <= 2) return f.template operator()<T, D, 2>();
  if (rep <= 4) return f.template operator()<T, D, 4>();
  if (rep <= 8) return f.template operator()<T, D, 8>();
  return f.template operator()<T, D, MAX_REP>();
}

template <typename T, typename F>
long long by_dim(int D, int rep, const F& f) {
  switch (D) {
    case 32: return by_rep<T, 32>(rep, f);
    case 64: return by_rep<T, 64>(rep, f);
    case 96: return by_rep<T, 96>(rep, f);
    case 128: return by_rep<T, 128>(rep, f);
    case 256: return by_rep<T, 256>(rep, f);
    default: return -1;
  }
}

template <typename F>
long long by_shape(int dtype, int D, int rep, const F& f) {
  if (rep < 1 || rep > MAX_REP) return -1;
  if (dtype == 0) return by_dim<float>(D, rep, f);
  if (dtype == 1) return by_dim<__nv_bfloat16>(D, rep, f);
  return -1;
}

struct TileOf {
  template <typename T, int D, int MAXR> long long operator()() const {
    return Cfg<T, D, MAXR>::TK;
  }
};
// blocks of the instantiation that fit one SM (its registers, shared
// memory and threads), or -1
struct BlocksPerSm {
  template <typename T, int D, int MAXR> long long operator()() const {
    int n = 0;
    if (prepare<T, D, MAXR>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, decode_attention_kernel<T, D, MAXR>,
            Cfg<T, D, MAXR>::THREADS, Cfg<T, D, MAXR>::SMEM) != cudaSuccess)
      return -1;
    return n;
  }
};
struct Launch {
  const Args& a;
  cudaStream_t stream;
  template <typename T, int D, int MAXR> long long operator()() const {
    return static_cast<long long>(launch<T, D, MAXR>(a, stream));
  }
};

}  // namespace

// the most blocks of a cluster and query heads per kv head it takes
extern "C" int decode_attention_max_cluster() { return MAX_CLUSTER; }
extern "C" int decode_attention_max_rep() { return MAX_REP; }

// cache slots per tile and blocks per SM of the instantiation that serves
// (dtype, D, rep); -1 if there is none
extern "C" int decode_attention_tile(int dtype, int D, int rep) {
  return static_cast<int>(by_shape(dtype, D, rep, TileOf{}));
}
extern "C" int decode_attention_blocks_per_sm(int dtype, int D, int rep) {
  return static_cast<int>(by_shape(dtype, D, rep, BlocksPerSm{}));
}

// dtype: 0 float32, 1 bfloat16.  q [B, Hq, D]; k, v [B, C, Hkv, D] with
// strides in elements (D contiguous, the others multiples of 16 bytes),
// 16-byte aligned; kv_pos [C] int32, 16-byte aligned.  The cache of each
// (batch, kv head) is split into ``cluster`` parts of ``per`` tiles.
// lse: null, or float32 [B, Hq] contiguous for each row's log-sum-exp.
// Returns the CUDA error (0: ok).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_pos,
    void* o, void* lse, int dtype, int B, int Hq, int Hkv, int C, int D,
    int cluster, int per, long long q_b, long long q_h, long long k_b,
    long long k_s, long long k_h, long long v_b, long long v_s,
    long long v_h, long long o_b, long long o_h, float scale, float cap,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || C <= 0 || B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, kv_pos, o, static_cast<float*>(lse), B, Hq, Hkv, C,
               cluster, per, q_b, q_h,
               k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h, scale, cap};
  const long long err = by_shape(dtype, D, Hq / Hkv,
                                 Launch{a, static_cast<cudaStream_t>(stream)});
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue)
                 : static_cast<int>(err);
}
