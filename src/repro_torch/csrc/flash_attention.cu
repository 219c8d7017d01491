// Causal / sliding-window / tanh-capped GQA attention with an online
// softmax, one thread block per (q-tile, q-head, batch).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py
// (flash_attention: (m, l, acc) carried in VMEM scratch across the
// sequential kv grid dimension).  Here the kv dimension is a loop inside
// the block, so nothing carries over between blocks.
//
// Per query row i (at key position i + qoff; qoff = Sk - Sq unless the
// caller gives another, e.g. a rank's block of a sequence-sharded query)
// and key j:
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
// refuses the one such case (causal with qoff < 0).
//
// What bounds it: operations.  Prefill at gemma2-9b's shapes (B=2, 16 q
// heads, S=4608, D=256) is ~3.5e11 FLOP per layer with the causal skip,
// 0.35 ms at the card's 989 TFLOP/s bf16; its bytes (q, k, v, out once)
// are ~0.07 ms.  p @ v runs as two bf16 products (p = hi + lo, below), so
// the tensor cores do 1.5x the bound's work: 0.53 ms at their peak.  At
// granite's D=64 a score carries only 192 multiply-adds of tensor-core
// work, so there the scalar chain per score (scale, cap, mask, exp, split)
// sets the pace as much as the products do.
//
// bf16, FlashAttention-3 style, for Hopper:
// - A block owns 128 query rows of one head (grid: heads fastest, then
//   batch, then q-tiles from the last, so every head's heaviest causal
//   tile is handed out first): two warpgroups of 64 rows, 256 threads.
//   Thread 0 brings q and the first tiles of k and v by TMA into two rings
//   of 4 stages of 64 keys (D = 256: 2 stages, a tile 32 KiB, which with
//   q's 64 KiB fills the 227 KiB a block may have), completion signalled
//   on mbarriers; from then on the last of the 8 warps to be done with a
//   stage (a count in shared memory) brings the ring's next tile into it.
//   There is no producer warpgroup: built with one (384 threads,
//   setmaxnreg 240 for the consumers, 24 for the producer), ptxas reported
//   168 registers, and at D = 256 the accumulator (128 registers a
//   thread), s and p's two terms spilled and serialised the wgmmas; why
//   ptxas did not use the 240 was not established.  At 256 threads a
//   thread may hold 255.  The tensor maps are 4-D (D, S, H, B) over the caller's strides,
//   so the model's [B, S, H, D] tensors are read in place; rows past Sq
//   or Sk arrive as zeros.
// - s = q k^T is a wgmma with both operands in shared memory (K-major,
//   128-byte swizzle; 64-byte for D = 32 and 96); its first k16 step only
//   writes s, so s holds no registers between its last read and the next
//   tile.  p v is a wgmma with A in registers: the score accumulator, once
//   turned into probabilities, is already the A fragment, as two bf16
//   terms hi + lo (below) so that p keeps ~16 bits as the reference's
//   float32 p @ v does (one bf16 term moved gemma2-9b's logits past the
//   wiring bar); v is the MN-major B operand through the transpose bit, so
//   nothing is copied.  At D = 256 p v is split by N into two m64n128
//   products, two accumulator ranges of 64 registers.
// - Overlap: a warpgroup issues q k_t^T and p_{t-1} v_{t-1} together,
//   waits for the scores alone and runs tile t's softmax while
//   p_{t-1} v_{t-1} runs (FlashAttention-3's intra-warpgroup overlap);
//   the two warpgroups run their tiles independently, so one's softmax
//   also runs beside the other's products.
// - Scalar work per score, each choice with its error against the float32
//   reference (all far inside the bf16 bar of 1e-3 + 1.6e-2 |plain|).
//   What bounds the softmax is the MUFU pipe (ex2, rcp) and the bf16
//   converts beside it, so each score takes at most: without a cap (scale
//   > 0) the row max of the raw scores and p = 2^(s c - m c), c = scale
//   log2 e, one FMA and one ex2.approx (~2 ulp relative); with a cap, x =
//   cap log2 e (1 - 2 / (1 + 2^(2 y log2 e))), y = s scale / cap, on
//   ex2.approx and rcp.approx, then p = 2^(x - m): the cap's absolute
//   error is ~1e-7 cap, 5e-6 at cap 50, where tanh.approx's relative 2^-11
//   would be ~2e-2 of a score.  p's hi term is p with its low 16 bits cut
//   (integer ops, exact in bf16) and lo = bf16(p - hi): one convert per two
//   scores, and hi + lo keeps p to ~2^-16.  The no-cap and the cap paths
//   are two instantiations of the kernel, so each compiles one softmax
//   (both in one kernel cost registers).  The masks run only on tiles
//   that cross the diagonal, the window's edge or Sk for some row of the
//   warpgroup; the accumulator is rescaled only when some row's max moved
//   (x 1.0 is exact, so skipping it changes no bit).  Both warpgroups run
//   every tile of the block, so that every wgmma is issued on a path that
//   all threads take (ptxas serialises wgmmas issued under a branch); a
//   tile that none of a warpgroup's rows sees gives p = 0 there, or is
//   wiped by the next correction exp(NEG_INF - m) = 0, as in the
//   reference.
// float32 inputs (held to 2e-5, which rules out TF32) run both products on
// the CUDA cores: each thread owns a 4x4 block of the 64x64 score tile and
// a 4 x D/16 block of the accumulator, tiles in shared memory as float32
// with row stride D + 1.
//
// Inputs are read through strides; the head dimension must be contiguous
// and rows 16-byte aligned.  The float32 path uses the accurate tanhf and
// expf.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -2.3819763e38f;
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // float32: 16 x 16 threads, 4 rows x 4 keys

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hkv, Sq, Sk;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  float scale, cap;
  int causal, window;
  int qoff;                    // key position of query row 0
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
  const int off = p.qoff;

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


// ---- bfloat16 on Hopper: wgmma, TMA ------------------------------------

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int W_THREADS = 256;   // 2 warpgroups, no producer
constexpr int W_BQ = 128;        // query rows per block, 64 a warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr bool WIDE = D == 256;
  static constexpr int SW = D % 64 == 0 ? 128 : 64;   // swizzle = row bytes
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;    // descriptor layout
  static constexpr int EPB = SW / 2;                  // elements per box row
  static constexpr int NBOX = D / EPB;                // boxes along D
  static constexpr int BKN = 64;                      // keys per tile
  // k and v tiles in flight: at D = 256 a 64-key tile of k or v is 32 KiB,
  // and only 2 stages fit beside q in a block's 227 KiB
  static constexpr int STAGES = WIDE ? 2 : 4;
  // p v's N per wgmma: its accumulator is CHN / 2 registers that wgmma
  // needs as one range (D = 256: two products of 128)
  static constexpr int CHN = D % 64 ? 32 : D < 128 ? D : 128;
  static constexpr int NCH = D / CHN;                 // p v products by N
  static constexpr int Q_BOX = W_BQ * SW;             // bytes of a q box
  static constexpr int KV_BOX = BKN * SW;
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;
  // q, the k and v rings, their barriers and release counts
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES
                              + 8 * (1 + 2 * STAGES) + 4 * 2 * STAGES;
  static_assert(CHN * NCH == D && CHN % EPB == 0, "p v's N splits D");
  static_assert(SMEM <= 232448, "a block has 227 KiB of shared memory");
};

// s (+)= q k^T over one k16 step; FIRST: s = q k^T, s only written
template <bool FIRST>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  if constexpr (FIRST) wgmma_ss_n64_first<0>(d, a, b);
  else wgmma_ss_n64<0>(d, a, b, 1);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 32) wgmma_rs_n32<1>(d, a, b, 1);
  else if constexpr (N == 64) wgmma_rs_n64<1>(d, a, b, 1);
  else wgmma_rs_n128<1>(d, a, b, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) as bf16 pairs hi + lo: hi = x with its low 16 bits cut (exact
// in bf16), lo = bf16(x - hi), x - hi exact in float32.  hi + lo holds x
// to ~2^-16 relative (lo's rounding), as a rounded hi would to ~2^-17;
// cutting takes integer ops where rounding would take a second convert,
// and the converts share a pipe with ex2.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);
  lo = pack_bf16(a - __uint_as_float(ua & 0xffff0000u),
                 b - __uint_as_float(ub & 0xffff0000u));
}

// the max over each of the two rows of a score fragment (elements i with
// (i >> 1) & 1 = row), across the quad of lanes that shares the rows
template <int NS>
__device__ __forceinline__ void row_max(const float (&sc)[NS],
                                        float (&mt)[2]) {
  float a[4] = {sc[0], sc[1], sc[2], sc[3]};   // two chains per row
#pragma unroll
  for (int i = 4; i < NS; ++i) a[i & 3] = fmaxf(a[i & 3], sc[i]);
  mt[0] = fmaxf(a[0], a[1]);
  mt[1] = fmaxf(a[2], a[3]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
  }
}

// the causal and window masks (NEG_INF) and keys past Sk (-inf) on a
// score fragment whose element i sits at key k0 + 8 (i >> 2) + (i & 1)
// (k0 with the lane's column offset) and query position pos0, or pos0 + 8
// for (i >> 1) & 1 = 1
template <int NS>
__device__ __forceinline__ void apply_masks(float (&sc)[NS], const Params& p,
                                            int k0, int pos0) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int kj = k0 + (i >> 2) * 8 + (i & 1);
    const int qp = pos0 + ((i & 2) ? 8 : 0);
    bool ok = true;
    if (p.causal) ok = ok && kj <= qp;
    if (p.window) ok = ok && kj > qp - p.window;
    const float x = ok ? sc[i] : NEG_INF;
    sc[i] = kj < p.Sk ? x : -INFINITY;
  }
}

// s = q k^T over the head dimension, both in shared memory (dq, dk: the
// tiles' first k16 step), issued and committed as one group
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<D>::BKN / 2],
                                         uint64_t dq, uint64_t dk) {
  using T = Tile<D>;
  constexpr int STEPS = T::EPB / 16;   // k16 steps per box row
  wgmma_fence();
  wgmma_ss<true>(sc, dq, dk);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    // the next k16 step: 32 bytes on along the row, or the next box; a
    // descriptor's low bits are the start address / 16, and each goes
    // through a register move the compiler cannot see through, so that
    // one descriptor of each operand is live at a time
    const bool wrap = kk % STEPS == 0;
    dq = opaque(dq + ((wrap ? T::Q_BOX - (STEPS - 1) * 32 : 32) >> 4));
    dk = opaque(dk + ((wrap ? T::KV_BOX - (STEPS - 1) * 32 : 32) >> 4));
    wgmma_ss<false>(sc, dq, dk);
  }
  wgmma_commit();
}

// acc += p v as two bf16 products, hi and lo (p in registers, the A
// fragments; v MN-major in shared memory at vd), issued and committed as
// one group
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[Tile<D>::NCH][Tile<D>::CHN / 2],
    const uint32_t (&ph)[Tile<D>::BKN / 16][4],
    const uint32_t (&pl)[Tile<D>::BKN / 16][4], uint64_t vd) {
  using T = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BKN / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) {
      const uint64_t d = vd + (((c * T::CHN / T::EPB) * T::KV_BOX
                                + kk * 16 * T::SW) >> 4);
      wgmma_rs<T::CHN>(acc[c], ph[kk], d);
      wgmma_rs<T::CHN>(acc[c], pl[kk], d);
    }
  }
  wgmma_commit();
}

template <int NCH, int N>
__device__ __forceinline__ void fence_acc(float (&acc)[NCH][N]) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) fence_regs(acc[c]);
}

// The online softmax of one tile's scores, in place (sc becomes p): the
// masks where ``edge`` (kcol: the key of the lane's first column, pos0:
// the key position of its first row), the new row max, p, and l; corr is
// the factor on acc for the max's move.
template <bool FUSED, int NS>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[NS], float (&m)[2], float (&moff)[2], float (&l)[2],
    float (&corr)[2], bool edge, const Params& p, int kcol, int pos0,
    float sl2, float c1, float c3) {
  if constexpr (FUSED) {
    // no cap, scale > 0: the row max of the raw scores, then
    // p = 2^(s (scale log2 e) - m (scale log2 e)), one FMA and one ex2 a
    // score.  A row with no visible key yet keeps offset 0, so its masked
    // scores give p = 0 (the reference's p = 1 there is wiped by the next
    // correction, exp(NEG_INF - m) = 0, all the same); every row has a
    // visible key in some tile.
    if (edge) apply_masks(sc, p, kcol, pos0);
    float mt[2];
    row_max<NS>(sc, mt);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], mt[r]);
      const float o2 = mn == NEG_INF ? 0.0f : mn * sl2;
      // acc and l are still 0 while no key was visible
      corr[r] = m[r] == NEG_INF ? 0.0f : ex2(moff[r] - o2);
      m[r] = mn;
      moff[r] = o2;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i)
      sc[i] = ex2(fmaf(sc[i], sl2, -moff[(i >> 1) & 1]));
  } else {
    // scores in log2 units, x = tanh(s scale / cap) cap log2 e
    if (p.cap != 0.0f) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        sc[i] = c1 - 2.0f * c1 * rcp(1.0f + ex2(sc[i] * c3));
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] *= sl2;
    }
    if (edge) apply_masks(sc, p, kcol, pos0);
    float mt[2];
    row_max<NS>(sc, mt);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], mt[r]);
      corr[r] = ex2(moff[r] - mn);
      m[r] = mn;
      moff[r] = mn;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = ex2(sc[i] - moff[(i >> 1) & 1]);
  }
  float ls[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NS; ++i) ls[(i >> 1) & 1] += sc[i];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
}

// acc *= corr by row; a max that moved in no row of the warp leaves acc
// as it is (x 1.0 is exact, so skipping it changes no bit)
template <int NCH, int N>
__device__ __forceinline__ void rescale(float (&acc)[NCH][N],
                                        const float (&corr)[2]) {
  if (!__all_sync(0xffffffffu, corr[0] == 1.0f && corr[1] == 1.0f)) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < N; ++i) acc[c][i] *= corr[(i >> 1) & 1];
  }
}

// p's A fragments for p v: sc's pairs as bf16 hi and lo terms
template <int NP>
__device__ __forceinline__ void split_p(const float (&sc)[NP * 8],
                                        uint32_t (&ph)[NP][4],
                                        uint32_t (&pl)[NP][4]) {
#pragma unroll
  for (int kk = 0; kk < NP; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], ph[kk][j],
                 pl[kk][j]);
}

// one of the 8 warps is done with a stage of a ring: the last of the 8
// (``count`` counts every warp's releases) refills it
template <class Refill>
__device__ __forceinline__ void release(unsigned* count, Refill refill) {
  __threadfence_block();
  if ((atomicAdd(count, 1u) & 7u) == 7u) {
    __threadfence_block();
    refill();
  }
}

// FUSED: no cap and scale > 0 (the launcher's choice), one softmax path
// compiled per kernel, which keeps the registers down
template <int D, bool FUSED>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             Params p) {
  using T = Tile<D>;
  constexpr int BKN = T::BKN, S = T::STAGES, SW = T::SW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + T::Q_BYTES;
  unsigned char* Vs = Ks + S * T::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + S * T::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  // each stage's releases so far, k's then v's
  unsigned* k_count = reinterpret_cast<unsigned*>(v_full + S);
  unsigned* v_count = k_count + S;

  // grid (Hq, B, q-tiles), heads fastest: every head's heaviest (last)
  // causal q-tile is handed out first, and the light ones fill the tail
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (p.Hq / p.Hkv);
  const int q0 = qt * W_BQ;
  const int off = p.qoff;
  // the keys any row of this q-tile can see
  const int qlo = q0 + off;
  const int qhi = min(q0 + W_BQ, p.Sq) - 1 + off;
  int kbeg = 0;
  int kend = p.Sk;
  if (p.causal) kend = min(kend, qhi + 1);
  if (p.window) kbeg = max(0, qlo - p.window + 1);
  kbeg = (kbeg / BKN) * BKN;
  const int ntiles = kend > kbeg ? (kend - kbeg + BKN - 1) / BKN : 0;

  // tile t of k or v into its stage
  const CUtensorMap* mk = &map_k;
  const CUtensorMap* mv = &map_v;
  auto load_k = [&](int t) {
    const int s = t % S;
    mbar_expect_tx(k_full + s, T::KV_BYTES);
    for (int j = 0; j < T::NBOX; ++j)
      tma_load_4d(Ks + s * T::KV_BYTES + j * T::KV_BOX, mk, k_full + s,
                  j * T::EPB, kbeg + t * BKN, g, b);
  };
  auto load_v = [&](int t) {
    const int s = t % S;
    mbar_expect_tx(v_full + s, T::KV_BYTES);
    for (int j = 0; j < T::NBOX; ++j)
      tma_load_4d(Vs + s * T::KV_BYTES + j * T::KV_BOX, mv, v_full + s,
                  j * T::EPB, kbeg + t * BKN, g, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      k_count[i] = 0;
      v_count[i] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // q, and the first S tiles of k and v; the warps refill the rings
    mbar_expect_tx(q_full, T::Q_BYTES);
    for (int j = 0; j < T::NBOX; ++j)
      tma_load_4d(Qs + j * T::Q_BOX, &map_q, q_full, j * T::EPB, q0, h, b);
    for (int t = 0; t < min(S, ntiles); ++t) {
      load_k(t);
      load_v(t);
    }
  }

  // ---- two warpgroups, 64 query rows each ----
  constexpr int NS = BKN / 2;          // score accumulator per thread
  constexpr int NP = BKN / 16;         // k16 blocks of p
  constexpr int CHN = T::CHN, NCH = T::NCH;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int wtid = threadIdx.x & 127;
  const int gr = lane >> 2;            // fragment rows gr and gr + 8
  const int tq = lane & 3;             // fragment columns 2 tq, +1
  const int row0 = q0 + 64 * wg + 16 * (wtid >> 5) + gr;
  const int pos0 = row0 + off;         // key position of row0; row0 + 8
  // the key positions of this warpgroup's first and last rows
  const int plo = q0 + 64 * wg + off;
  const int phi = min(q0 + 64 * wg + 64, p.Sq) - 1 + off;

  const float sl2 = p.scale * LOG2E;
  const float c1 = p.cap * LOG2E;
  const float c3 = p.cap != 0.0f ? 2.0f * p.scale * LOG2E / p.cap : 0.0f;

  float acc[NCH][CHN / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < CHN / 2; ++i) acc[c][i] = 0.0f;
  float sc[NS];
  uint32_t ph[NP][4], pl[NP][4];
  // running max per row (raw scores when fused, else log2 units), its
  // offset in the exponent (log2 units), this thread's part of the row
  // sums, and the factor on acc for the max's last move
  float m[2] = {NEG_INF, NEG_INF};
  float moff[2] = {FUSED ? 0.0f : NEG_INF, FUSED ? 0.0f : NEG_INF};
  float l[2] = {0.0f, 0.0f};
  float corr[2];

  const uint64_t q_desc = smem_desc(Qs + 64 * wg * SW, 16, 8 * SW,
                                    T::LAYOUT);
  const uint64_t k_desc = smem_desc(Ks, 16, 8 * SW, T::LAYOUT);
  const uint64_t v_desc = smem_desc(Vs, T::KV_BOX, 8 * SW, T::LAYOUT);

  // tile t of k or v, once it has arrived (its descriptor)
  auto k_at = [&](int t) {
    mbar_wait(k_full + t % S, (t / S) & 1);
    return opaque(k_desc) + (t % S * T::KV_BYTES >> 4);
  };
  auto v_at = [&](int t) {
    mbar_wait(v_full + t % S, (t / S) & 1);
    return opaque(v_desc) + (t % S * T::KV_BYTES >> 4);
  };
  // this warp is done with tile t of k or v (lane 0 reports): the last
  // warp to be done brings tile t + S into the stage
  auto done_k = [&](int t) {
    if (lane == 0)
      release(k_count + t % S, [&] { if (t + S < ntiles) load_k(t + S); });
  };
  auto done_v = [&](int t) {
    if (lane == 0)
      release(v_count + t % S, [&] { if (t + S < ntiles) load_v(t + S); });
  };
  // the masks run only on a tile that crosses the diagonal, the window's
  // edge or Sk for some row of this warpgroup
  auto edge = [&](int k0) {
    return (p.causal && k0 + BKN - 1 > plo)
           || (p.window && k0 <= phi - p.window) || k0 + BKN > p.Sk;
  };

  // Tile t: issue s = q k_t^T and acc += p_{t-1} v_{t-1}; wait for s alone
  // and run tile t's softmax while p_{t-1} v_{t-1} runs; then wait for it,
  // rescale acc and form p_t.  Every wgmma is issued on a path that all
  // threads take.
  mbar_wait(q_full, 0);
  if (ntiles > 0) {
    issue_qk<D>(sc, opaque(q_desc), k_at(0));
    wgmma_wait<0>();
    fence_regs(sc);
    done_k(0);
    softmax_tile<FUSED>(sc, m, moff, l, corr, edge(kbeg), p, kbeg + tq * 2,
                        pos0, sl2, c1, c3);
    split_p(sc, ph, pl);
    for (int t = 1; t < ntiles; ++t) {
      const int k0 = kbeg + t * BKN;
      issue_qk<D>(sc, opaque(q_desc), k_at(t));
      issue_pv<D>(acc, ph, pl, v_at(t - 1));
      wgmma_wait<1>();
      fence_regs(sc);
      done_k(t);
      softmax_tile<FUSED>(sc, m, moff, l, corr, edge(k0), p, k0 + tq * 2,
                          pos0, sl2, c1, c3);
      wgmma_wait<0>();
      fence_acc(acc);
      done_v(t - 1);
      rescale(acc, corr);
      split_p(sc, ph, pl);
    }
    issue_pv<D>(acc, ph, pl, v_at(ntiles - 1));
    wgmma_wait<0>();
    fence_acc(acc);
    done_v(ntiles - 1);
  }

  bf16* o = static_cast<bf16*>(p.o) + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int n = 0; n < CHN / 8; ++n)
        *reinterpret_cast<uint32_t*>(
            o + static_cast<long long>(row) * p.o_s + c * CHN + n * 8
            + tq * 2) = pack_bf16(acc[c][4 * n + 2 * r] * inv,
                                  acc[c][4 * n + 2 * r + 1] * inv);
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

// a 4-D tensor map (D, S, H, B) over a bf16 [B, H, S, D] tensor with
// element strides (b, h, s), boxes of (EPB, rows, 1, 1)
template <int D>
bool head_map(CUtensorMap* map, const void* base, int B, int H, int S,
              long long sb, long long sh, long long ss, int rows) {
  using T = Tile<D>;
  // a dimension of size 1 is never stepped: give it a valid stride
  const long long big = (static_cast<long long>(S) * D + 8) * 2;
  const uint64_t sizes[4] = {static_cast<uint64_t>(D),
                             static_cast<uint64_t>(S > 0 ? S : 1),
                             static_cast<uint64_t>(H),
                             static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {
      static_cast<uint64_t>(S > 1 ? ss * 2 : big),
      static_cast<uint64_t>(H > 1 ? sh * 2 : big),
      static_cast<uint64_t>(B > 1 ? sb * 2 : big)};
  const uint32_t box[4] = {static_cast<uint32_t>(T::EPB),
                           static_cast<uint32_t>(rows), 1, 1};
  return make_tensor_map_bf16(map, base, 4, sizes, strides, box, T::SW)
         == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap tq, tk, tv;
  if (!head_map<D>(&tq, p.q, B, p.Hq, p.Sq, p.q_b, p.q_h, p.q_s, W_BQ) ||
      !head_map<D>(&tk, p.k, B, p.Hkv, p.Sk, p.k_b, p.k_h, p.k_s, T::BKN) ||
      !head_map<D>(&tv, p.v, B, p.Hkv, p.Sk, p.v_b, p.v_h, p.v_s, T::BKN))
    return cudaErrorInvalidValue;
  const bool fused = p.cap == 0.0f && p.scale > 0.0f;
  const auto kernel = fused ? flash_attention_wgmma_kernel<D, true>
                            : flash_attention_wgmma_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hq, B, (p.Sq + W_BQ - 1) / W_BQ);
  kernel<<<grid, W_THREADS, T::SMEM, stream>>>(tq, tk, tv, p);
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
// dimension is contiguous.  q_offset: the key position of query row 0.
// Returns the CUDA error of the launch (0: ok).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Sk, int D,
    long long q_b, long long q_h, long long q_s,
    long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s,
    long long o_b, long long o_h, long long o_s,
    float scale, float cap, int causal, int window, int q_offset,
    void* stream) {
  Params p{q, k, v, o, Hq, Hkv, Sq, Sk,
           q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s,
           scale, cap, causal, window, q_offset};
  return static_cast<int>(
      dispatch(p, dtype, B, D, static_cast<cudaStream_t>(stream)));
}
