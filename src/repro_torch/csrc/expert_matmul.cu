// Capacity-batched expert matmul (the MoE grouped GEMM):
//   out[e, c, f] = sum_d buf[e, c, d] * w[e, d, f]
// summed in float32 and rounded once to the input dtype.
//
// Replaces the Pallas kernel repro/kernels/moe_gmm/kernel.py
// (expert_matmul: grid (E, C/bc, F/bf, D/bd), the contraction the
// innermost sequential grid dimension with a float32 VMEM accumulator).
// Here the contraction is a loop inside the block (or a cluster of
// blocks), so nothing carries over between launches.
//
// What bounds it depends on C, the rows per expert (moe_capacity):
// - Prefill (granite-moe-3b-a800m at B=2 x 4096 tokens: E=40, C=2048,
//   D=1536, F=512) does 2 E C D F = 1.3e11 operations, 0.13 ms at the
//   card's 989 TFLOP/s bf16, and moves ~0.4 GB (buf, w and out once: 0.12
//   ms at 3.35 TB/s), so it is near both bounds.  bf16 with C > 8 runs on
//   Hopper's warpgroup MMA, one persistent block per SM walking 128 x 256
//   output tiles: a producer warpgroup whose one thread brings (A 128 x
//   64, B 64 x 256) bf16 k-tiles by TMA into a ring of 3 stages (128-byte
//   swizzle, completion on mbarriers), running on into the next tile while
//   the consumers finish this one; two consumer warpgroups of 64 rows each
//   run wgmma.m64n256k16 from shared memory into float32 registers, one
//   k-tile's batch in flight while the next is issued; setmaxnreg hands
//   the producer's registers to them (40 / 232).  A = buf[e] is K-major;
//   B = w[e] is [D, F] with F contiguous, MN-major, which wgmma reads
//   through its transpose bit, so w is never copied.  The epilogue rounds
//   once to bf16 into swizzled shared memory and leaves by TMA stores, so
//   the output is written in whole lines and the next tile's products do
//   not wait for it.  Ragged C, D and F come from TMA's zero fill and
//   clipped stores (3-D tensor maps (D, C, E), (F, D, E) and (F, C, E),
//   so an expert's tile never touches its neighbour's rows).
// - Decode (C = 4 at B=2) reads every expert's weights for a few rows:
//   ~63 MB of one weight stack per launch, 0.019 ms at 3.35 TB/s, while
//   its operations are negligible.  What bounds it is bytes in flight:
//   3.35 TB/s at ~1 us of latency needs ~25 KB outstanding per SM.  So bf16
//   with C <= 8 splits D across the blocks of a thread-block cluster (up to
//   8, about 256 rows of w each): a block owns 64 columns of one expert,
//   each lane 8 of them (16-byte loads, a warp reading 4 rows of 128 bytes
//   at once), 4 rows in flight per thread, the first issued before the
//   block stages its rows of buf in shared memory as float32; small
//   blocks (256 threads, <= 64 registers at C <= 4), so that 4 of them
//   share an SM and one's loads run while another adds up.  The partial
//   sums meet in a fixed order: across the 4 row groups of a warp by
//   shuffles, across the 8 warps through shared memory, then each block
//   writes its sums into rank 0's shared memory (distributed shared
//   memory) and leaves, and rank 0 adds them in rank order.  So the result
//   is bitwise the same at every launch, with no atomics and in one
//   launch; no tensor maps are built per decode launch.
// - float32 inputs (held to tol * d with float32 accumulation, which rules
//   out TF32) are on no served path and keep the CUDA-core kernels: C > 8 a
//   tiled GEMM (64 x 64 tiles, 4 x 4 outputs per thread, k-tiles of 16 in
//   shared memory), C <= 8 a block per 128 columns of one expert with 16
//   warps splitting the rows and a fixed-order tree through shared memory.
// D and F must be multiples of 8 (16-byte rows for loads and TMA), which
// the wrapper checks.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace hopper;

// ---- float32, C <= 8: CUDA cores, streaming the weights once --------------

__device__ __forceinline__ float to_f(float x) { return x; }

constexpr int SK_MAXC = 8;       // rows per expert this path takes
constexpr int SK_WARPS = 16;
constexpr int SK_COLS = 128;     // columns per block: 32 lanes x 4

// four neighbouring weights of row d as float
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

// ---- bf16, C <= 8: a cluster of blocks splits D -------------------------

constexpr int DC_COLS = 64;        // columns per block: 8 lanes x 8
constexpr int DC_THREADS = 256;    // 8 warps x 4 row groups of 8 lanes
constexpr int DC_GROUPS = 32;      // row groups per block
constexpr int DC_ROWS = 256;       // rows of w per block, about
constexpr int DC_UNROLL = 4;       // rows in flight per thread

__device__ __forceinline__ void unpack8(const uint4& x, float* v) {
  const uint32_t u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// grid (F / 64, E, cluster), cluster (1, 1, cluster): block rank r of the
// cluster owns rows [r rpr, (r + 1) rpr) of D.  Dynamic shared memory:
// the block's buf rows as float32, [MAXC][rpr].
template <int MAXC>
__global__ void __launch_bounds__(DC_THREADS, MAXC == 4 ? 4 : 2)
expert_matmul_decode(const bf16* __restrict__ buf, const bf16* __restrict__ w,
                     bf16* __restrict__ out, int C, int D, int F, int rpr) {
  extern __shared__ float xs[];
  __shared__ float red[DC_THREADS / 32][MAXC][DC_COLS];
  __shared__ float parts[8][MAXC][DC_COLS];   // rank 0: every rank's sums
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncl = static_cast<int>(gridDim.z);   // the cluster spans z
  const int e = blockIdx.y;
  const int n0 = blockIdx.x * DC_COLS;
  const int d0 = rank * rpr;
  const int nrows = max(0, min(D - d0, rpr));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cgp = lane & 7;                    // column group: 8 columns
  const int rg = warp * 4 + (lane >> 3);       // row group: rows rg + 32 i
  const int col = n0 + cgp * 8;
  const bf16* a = buf + static_cast<long long>(e) * C * D + d0;
  const bf16* wb = w + (static_cast<long long>(e) * D + d0) * F + col;
  // every block of the cluster has started before any writes into rank
  // 0's shared memory (the wait comes after the loads)
  cluster_arrive_relaxed();

  // DC_UNROLL rows of w in flight per thread, the first ones issued
  // before the block stages its rows of buf
  uint4 raw[DC_UNROLL];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < DC_UNROLL; ++u) {
      const int r = base + rg + u * DC_GROUPS;
      raw[u] = col < F && r < nrows
                   ? __ldg(reinterpret_cast<const uint4*>(
                         wb + static_cast<long long>(r) * F))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load(0);
  for (int i = threadIdx.x; i < MAXC * nrows; i += DC_THREADS) {
    const int c = i / nrows, r = i % nrows;
    xs[c * rpr + r] = c < C ? __bfloat162float(
        a[static_cast<long long>(c) * D + r]) : 0.0f;
  }
  __syncthreads();

  float acc[MAXC][8];
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[c][j] = 0.0f;
  for (int base = 0; base < nrows; base += DC_UNROLL * DC_GROUPS) {
    if (base > 0) load(base);
#pragma unroll
    for (int u = 0; u < DC_UNROLL; ++u) {
      const int r = base + rg + u * DC_GROUPS;
      if (r < nrows) {
        float v[8];
        unpack8(raw[u], v);
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const float x = xs[c * rpr + r];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[c][j] += x * v[j];
        }
      }
    }
  }

  // the 4 row groups of a warp (lanes cgp, +8, +16, +24), then the warps
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], 8);
      acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], 16);
    }
  if (lane < 8) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][c][cgp * 8 + j] = acc[c][j];
  }
  __syncthreads();
  // this block's sums into rank 0's shared memory, in its rank's slot
  cluster_wait();
  float* dst = cluster.map_shared_rank(&parts[0][0][0], 0)
               + rank * MAXC * DC_COLS;
  for (int i = threadIdx.x; i < MAXC * DC_COLS; i += DC_THREADS) {
    const int c = i / DC_COLS, n = i % DC_COLS;
    float sum = 0.0f;
#pragma unroll
    for (int w8 = 0; w8 < DC_THREADS / 32; ++w8) sum += red[w8][c][n];
    dst[i] = sum;
  }
  cluster_arrive();
  if (rank != 0) return;
  // rank 0 adds the ranks' sums in rank order
  cluster_wait();
  for (int i = threadIdx.x; i < C * DC_COLS; i += DC_THREADS) {
    const int c = i / DC_COLS, n = i % DC_COLS;
    if (n0 + n >= F) continue;
    float sum = 0.0f;
    for (int q = 0; q < ncl; ++q) sum += parts[q][c][n];
    out[(static_cast<long long>(e) * C + c) * F + n0 + n] =
        __float2bfloat16_rn(sum);
  }
}

// ---- bf16, C > 8: wgmma on TMA tiles, persistent -------------------------

constexpr int GM = 128, GN = 256, GK = 64;   // output tile and k-tile
constexpr int G_STAGES = 3;
constexpr int G_THREADS = 384;               // 2 consumer warpgroups + 1
constexpr int G_A_BYTES = GM * GK * 2;       // 16 KB: one 128-row box
constexpr int G_BOX = 64 * 64 * 2;           // 8 KB: 64 rows x 128 bytes
constexpr int G_B_BYTES = (GN / 64) * G_BOX;
constexpr int G_E_BYTES = (GN / 64) * G_BOX; // a warpgroup's 64 output rows
constexpr int G_SMEM = 1024 + G_STAGES * (G_A_BYTES + G_B_BYTES)
                       + 2 * G_E_BYTES + 16 * G_STAGES;

// one block per SM walks the output tiles (n fastest, then m, then the
// expert), so that the producer loads the next tile's first k-tiles while
// the consumers store this one
__global__ void __launch_bounds__(G_THREADS, 1)
expert_matmul_wgmma(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tc, int E, int C,
                    int D, int F) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Bs = As + G_STAGES * G_A_BYTES;
  unsigned char* Es = Bs + G_STAGES * G_B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Es + 2 * G_E_BYTES);
  uint64_t* empty = full + G_STAGES;
  const int nt_n = (F + GN - 1) / GN;
  const int nt_m = (C + GM - 1) / GM;
  const int ntile = nt_n * nt_m * E;
  const int nk = (D + GK - 1) / GK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < G_STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);     // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    regs_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x) {
        const int n0 = (tile % nt_n) * GN;
        const int m0 = (tile / nt_n % nt_m) * GM;
        const int e = tile / (nt_n * nt_m);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % G_STAGES;
          const int r = it / G_STAGES;
          if (r > 0) mbar_wait(empty + s, (r - 1) & 1);
          mbar_expect_tx(full + s, G_A_BYTES + G_B_BYTES);
          tma_load_3d(As + s * G_A_BYTES, &ta, full + s, kt * GK, m0, e);
          for (int j = 0; j < GN / 64; ++j)
            tma_load_3d(Bs + s * G_B_BYTES + j * G_BOX, &tb, full + s,
                        n0 + 64 * j, kt * GK, e);
        }
      }
    }
  } else {
    // ---- consumers: rows m0 + 64 wg .. + 63, all GN columns ----
    regs_inc<232>();
    const int lane = threadIdx.x & 31;
    const int wtid = threadIdx.x & 127;
    const int gr = lane >> 2, tq = lane & 3;
    const int wrow = 16 * (wtid >> 5) + gr;    // rows wrow, wrow + 8
    unsigned char* Ew = Es + wg * G_E_BYTES;
    float acc[GN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x) {
      const int n0 = (tile % nt_n) * GN;
      const int m0 = (tile / nt_n % nt_m) * GM;
      const int e = tile / (nt_n * nt_m);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % G_STAGES;
        mbar_wait(full + s, (it / G_STAGES) & 1);
        wgmma_fence();
        const unsigned char* At = As + s * G_A_BYTES + wg * 64 * 128;
        const unsigned char* Bt = Bs + s * G_B_BYTES;
#pragma unroll
        for (int kk = 0; kk < GK / 16; ++kk)
          wgmma_ss_n256<1>(acc, smem_desc(At + kk * 32, 16, 1024, 1),
                           smem_desc(Bt + kk * 16 * 128, G_BOX, 1024, 1),
                           kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();             // k-tile kt - 1 is done
        fence_regs(acc);
        if (kt > 0 && lane == 0) mbar_arrive(empty + (it - 1) % G_STAGES);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + (it - 1) % G_STAGES);

      // epilogue: bf16 into this warpgroup's staging boxes (64 rows x 128
      // bytes, 128-byte swizzle, as the store's tensor map reads them),
      // then one TMA store per box, clipped at C and F.  The previous
      // tile's store must have read the boxes first.
      if (wtid == 0) bulk_wait<0, true>();
      bar_sync(1 + wg, 128);
#pragma unroll
      for (int n = 0; n < GN / 8; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wrow + 8 * h;
          __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * n + 2 * h],
                                                   acc[4 * n + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              Ew + (n / 8) * G_BOX + r * 128 + (((n % 8) ^ (r & 7)) << 4)
              + tq * 4) = v;
        }
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if (wtid == 0) {
        for (int j = 0; j < GN / 64; ++j)
          tma_store_3d(&tc, Ew + j * G_BOX, n0 + 64 * j, m0 + 64 * wg, e);
        bulk_commit();
      }
    }
    if (wtid == 0) bulk_wait<0, false>();
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
  if (dtype == 1 && C <= SK_MAXC) {
    // the cluster: about DC_ROWS rows of w per block, at most 8 blocks
    const int ncl = min(8, max(1, (D + DC_ROWS - 1) / DC_ROWS));
    const int rpr = (D + ncl - 1) / ncl;
    const int maxc = C <= 4 ? 4 : 8;
    const size_t smem = sizeof(float) * maxc * rpr;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((F + DC_COLS - 1) / DC_COLS, E, ncl);
    cfg.blockDim = dim3(DC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = ncl;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const bf16* b = static_cast<const bf16*>(buf);
    const bf16* wt = static_cast<const bf16*>(w);
    bf16* o = static_cast<bf16*>(out);
    cudaError_t err;
    if (maxc == 4) {
      err = cudaFuncSetAttribute(expert_matmul_decode<4>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err == cudaSuccess)
        err = cudaLaunchKernelEx(&cfg, expert_matmul_decode<4>, b, wt, o, C,
                                 D, F, rpr);
    } else {
      err = cudaFuncSetAttribute(expert_matmul_decode<8>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err == cudaSuccess)
        err = cudaLaunchKernelEx(&cfg, expert_matmul_decode<8>, b, wt, o, C,
                                 D, F, rpr);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (C <= SK_MAXC) {
    if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((F + SK_COLS - 1) / SK_COLS, E);
    expert_matmul_skinny<float><<<grid, SK_WARPS * 32, 0, s>>>(
        static_cast<const float*>(buf), static_cast<const float*>(w),
        static_cast<float*>(out), C, D, F);
  } else if (dtype == 1) {
    CUtensorMap ta, tb, tc;
    const uint64_t a_sizes[3] = {static_cast<uint64_t>(D),
                                 static_cast<uint64_t>(C),
                                 static_cast<uint64_t>(E)};
    const uint64_t a_strides[2] = {2ull * D, 2ull * C * D};
    const uint32_t a_box[3] = {GK, GM, 1};
    const uint64_t b_sizes[3] = {static_cast<uint64_t>(F),
                                 static_cast<uint64_t>(D),
                                 static_cast<uint64_t>(E)};
    const uint64_t b_strides[2] = {2ull * F, 2ull * D * F};
    const uint32_t b_box[3] = {64, GK, 1};
    const uint64_t c_sizes[3] = {static_cast<uint64_t>(F),
                                 static_cast<uint64_t>(C),
                                 static_cast<uint64_t>(E)};
    const uint64_t c_strides[2] = {2ull * F, 2ull * C * F};
    const uint32_t c_box[3] = {64, 64, 1};
    if (make_tensor_map_bf16(&ta, buf, 3, a_sizes, a_strides, a_box, 128)
            != CUDA_SUCCESS ||
        make_tensor_map_bf16(&tb, w, 3, b_sizes, b_strides, b_box, 128)
            != CUDA_SUCCESS ||
        make_tensor_map_bf16(&tc, out, 3, c_sizes, c_strides, c_box, 128)
            != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
    static int sms = 0;              // one persistent block per SM
    if (sms == 0) {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaError_t err = cudaFuncSetAttribute(
        expert_matmul_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = static_cast<long long>((F + GN - 1) / GN)
                            * ((C + GM - 1) / GM) * E;
    const int grid = static_cast<int>(tiles < sms ? tiles : sms);
    expert_matmul_wgmma<<<grid, G_THREADS, G_SMEM, s>>>(ta, tb, tc, E, C,
                                                         D, F);
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
