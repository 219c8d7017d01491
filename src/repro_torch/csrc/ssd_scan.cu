// Mamba2 SSD (state-space duality) scan, chunk-parallel: the sequence is
// cut into chunks that run in parallel, and only a short recurrence over
// the chunks' states runs in order.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan/kernel.py (ssd_scan:
// grid (B, H, chunks) with the chunk dimension sequential and the [P, N]
// state carried in VMEM scratch between grid steps).
//
// Per head h (group g = h / (H / G)), step t, with a_t = dt_t A_h:
//   S_t = exp(a_t) S_{t-1} + (dt_t x_t) B_t^T        state [P, N]
//   y_t = S_t C_t                                     [P]
// With the sequence cut into chunks of CHUNK = 256 steps, the state at a
// chunk's end is S_c = d_c S_{c-1} + s_c, where d_c = exp(sum of a over the
// chunk) and s_c is the chunk's own state (its steps run from a zero
// state).  So three kernels, launched one after the other on the stream:
//  1. the state pass, one block per (chunk, head, batch), all in
//     parallel: s_c and d_c into a workspace;
//  2. the carry pass, one thread per four elements of a (batch, head)'s
//     state, walking the chunks in order: S_c = d_c S_{c-1} + s_c, each
//     chunk's s_c replaced in the workspace by its entry state S_{c-1},
//     and the last S_c written as the final state.  Its traffic is linear
//     in the number of chunks (each state read and written once), and its
//     loads do not depend on the recurrence, so eight are in flight at once;
//  3. the output pass, one block per (chunk, head, batch), all in
//     parallel: y of the chunk's steps from its entry state.
// Inside a block, a chunk is walked a tile of TL = 64 steps at a time in
// the chunked (SSD) form: with cum the inclusive prefix of a over the tile,
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) S_prev C_i
//   S    = exp(cum_last) S_prev + sum_j dt_j x_j B_j^T exp(cum_last - cum_j)
// which is exact for any tile and chunk length: the reference's chunk
// (256) is a TPU tiling, and these lengths are this kernel's own.  Steps
// past the end of the sequence are zero (dt = 0, x = 0), which leaves the
// state as it is.
//
// The four products of a tile (C B^T, only its blocks on and below the
// diagonal; the masked and decayed scores times x; C S_prev^T; and the
// state update x^T (B scaled by dt and the decay to the tile's end)) run on
// the tensor cores as warp-level mma.sync.m16n8k8 in TF32, each done three
// times (v = hi + lo, both TF32; hi lo' + lo hi' + hi hi', float32 sums),
// which keeps float32's accuracy to a few ulps and the reference's 2e-4
// bar; plain TF32 would not keep it.  P and N (multiples of 16 up to 128)
// are padded with zeros to HP and HN parts of 64, and the products run
// over the padding, so that their extents are constants (the served heads,
// 64 and 128 wide, have none): each warp owns the same 16 x 32 block of
// every 64 x 64 part of a product, and stores only what lies inside P and
// N.  The warp's blocks of the state stay in its
// registers across the tiles; the output pass copies them to shared memory
// once a tile for C S^T.  Fragments are read from shared memory with row
// strides of 64 HP + 8 or 64 HN + 8 floats (rows read across) and 64 HN + 4
// or TL + 4 (rows read along), so that the 32 lanes of each read hit 32
// banks.  x, B, C and dt of a tile are copied as they are, all in flight at
// once (cp.async, each thread its rows and 16-byte columns).
//
// What bounds it: bytes.  zamba2-1.2b's prefill (B=2, S=4096, H=64,
// P=N=64) reads x and writes y, 0.27 GB in all (~0.082 ms at 3.35 TB/s);
// the plain recurrence's ~1.1e10 operations (5 P N per step and head) take
// ~0.065 ms at the tensor cores' TF32 rate over three.  What is left on the
// table: a block waits for each tile's loads (one buffer, two blocks to an
// SM), and C B^T is formed per head though all heads of a group share it.
// No --use_fast_math: expf is the accurate one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TL = 64;           // steps per tile
constexpr int CHUNK = 256;       // steps per chunk
constexpr int THREADS = 256;     // 8 warps
constexpr int MAXD = 128;        // largest P and N
constexpr int LS = TL + 4;       // row stride of the score tile
constexpr int CARRY_DEPTH = 8;   // chunks whose loads the carry issues at once

struct Dims {
  int S, H, P, G, N, nc;
};

// asynchronous copies into shared memory, zero-filled where ``valid`` is
// false (no bytes are read then), so that all of a tile's loads are in
// flight at once
__device__ __forceinline__ void cp16(float* smem, const float* gmem,
                                     bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp4(float* smem, const float* gmem,
                                    bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] (16 x 8 each, nt < nts <= 4) += A (16 x K) B (K x 32), K from kb
// to ke (multiples of 8), 3xTF32.  A(m, k) = a[m lda + k], or a[k lda + m]
// if AT; B(k, n) = b[n ldb + k] if BT, else b[k ldb + n].  ROLLED keeps the
// loop over K rolled, where unrolled products would not fit the registers.
template <bool AT, bool BT, bool ROLLED>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4], const float* a,
                                         int lda, const float* b, int ldb,
                                         int kb, int ke, int nts, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll (ROLLED ? 1 : 8)
  for (int k0 = kb; k0 < ke; k0 += 8) {
    const float av[4] = {
        AT ? a[(k0 + t) * lda + g] : a[g * lda + k0 + t],
        AT ? a[(k0 + t) * lda + g + 8] : a[(g + 8) * lda + k0 + t],
        AT ? a[(k0 + t + 4) * lda + g] : a[g * lda + k0 + t + 4],
        AT ? a[(k0 + t + 4) * lda + g + 8] : a[(g + 8) * lda + k0 + t + 4]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= nts) break;                    // uniform in the warp
      const int n = 8 * nt + g;
      const float b0 = BT ? b[n * ldb + k0 + t] : b[(k0 + t) * ldb + n];
      const float b1 = BT ? b[n * ldb + k0 + t + 4]
                          : b[(k0 + t + 4) * ldb + n];
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b0, bh0, bl0);
      split_tf32(b1, bh1, bl1);
      mma_tf32(acc[nt], al, bh0, bh1);
      mma_tf32(acc[nt], ah, bl0, bl1);
      mma_tf32(acc[nt], ah, bh0, bh1);
    }
  }
}

// the shared tiles of a kernel whose P and N are padded to PW = 64 HP and
// NW = 64 HN: row strides of rows read across (x: LX, B scaled: LBP) and
// along (B, C and the state: LR), and the floats of the state pass (OUT
// false) and the output pass
template <int HP, int HN>
struct Tiles {
  static constexpr int PW = 64 * HP, NW = 64 * HN;
  static constexpr int LX = PW + 8, LBP = NW + 8, LR = NW + 4;
  static constexpr size_t floats(bool out) {
    return static_cast<size_t>(TL) * (LX + LBP)
           + (out ? static_cast<size_t>(TL) * (2 * LR + LS)
                        + static_cast<size_t>(PW) * LR : 0)
           + 4 * TL;
  }
};

// grid (chunks, H, B).  OUT false: the chunk's own state s_c (from zero,
// [P][N]) and decay d_c into ws and dec.  OUT true: y of the chunk's steps
// from its entry state, which the carry pass left in ws.
template <int HP, int HN, bool OUT>
__global__ void __launch_bounds__(THREADS, HP * HN > 1 ? 1 : 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ ws, float* __restrict__ dec, Dims d) {
  using T = Tiles<HP, HN>;
  constexpr int LX = T::LX, LBP = T::LBP, LR = T::LR, NW = T::NW;
  constexpr bool ROLLED = HP * HN > 2;     // P = N = 128: spills unrolled
  extern __shared__ __align__(16) float sm[];
  const int S = d.S, H = d.H, G = d.G, P = d.P, N = d.N;
  float* Xs = sm;                          // [TL][LX]   x
  float* Bp = Xs + TL * LX;                // [TL][LBP]  B dt eout
  float* Bs = Bp + TL * LBP;               // [TL][LR]   B          (OUT)
  float* Cs = Bs + (OUT ? TL * LR : 0);    // [TL][LR]   C          (OUT)
  float* Ss = Cs + (OUT ? TL * LR : 0);    // [TL][LS]   scores     (OUT)
  float* St = Ss + (OUT ? TL * LS : 0);    // [PW][LR]   the state  (OUT)
  float* cum = St + (OUT ? T::PW * LR : 0);
  float* ein = cum + TL;                   // exp(cum_i)
  float* eout = ein + TL;                  // exp(cum_last - cum_j)
  float* dts = eout + TL;                  // dt

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const float Ah = A[h];
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = 16 * (warp & 3);          // the warp's 16 rows
  const int wn = 32 * (warp >> 2);         // and 32 columns of each part
  const int fg = lane >> 2, ft = lane & 3; // fragment row and column pair
  const long long bh = static_cast<long long>(b) * H + h;
  float* wsc = ws + (bh * d.nc + c) * P * N;   // this chunk's state

  // the warp's blocks of the state S(p, n), p = 64 hp + wm + fg (+ 8), n =
  // 64 hn + wn + 8 nt + 2 ft (+ 1), as mma accumulators
  float sacc[HP * HN][4][4];
#pragma unroll
  for (int q = 0; q < HP * HN; ++q)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[q][nt][i] = 0.0f;
  if (OUT) {
    // the entry state, zero past P and N
    for (int i = tid * 4; i < T::PW * NW; i += THREADS * 4) {
      const int p = i / NW, n = i % NW;
      *reinterpret_cast<float4*>(St + p * LR + n) =
          p < P && n < N ? ld4(wsc + p * N + n)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int hp = 0; hp < HP; ++hp)
#pragma unroll
      for (int hn = 0; hn < HN; ++hn)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sacc[hp * HN + hn][nt][i] =
                St[(64 * hp + wm + fg + 8 * (i >> 1)) * LR + 64 * hn + wn
                   + 8 * nt + 2 * ft + (i & 1)];
  }

  const int t_begin = c * CHUNK;
  const int t_end = min(S, t_begin + CHUNK);
  float decay_all = 1.0f;
  for (int t0 = t_begin; t0 < t_end; t0 += TL) {
    const bool last = t0 + TL >= t_end;
    __syncthreads();   // the previous tile's readers are done
    if (tid < TL) {
      const int t = t0 + tid;
      cp4(dts + tid, dt + (static_cast<long long>(b) * S + min(t, S - 1))
                         * H + h, t < S);
    }
    // rows j = ty + 16 k of the tile; 16-byte columns 64 h + 4 tx, zero
    // past the sequence and past P and N
#pragma unroll
    for (int k = 0; k < TL / 16; ++k) {
      const int j = ty + 16 * k;
      const int t = t0 + j;
      const long long row = static_cast<long long>(b) * S + min(t, S - 1);
#pragma unroll
      for (int hp = 0; hp < HP; ++hp) {
        const int col = 64 * hp + 4 * tx;
        const bool ok = t < S && col < P;
        cp16(Xs + j * LX + col, x + (row * H + h) * P + (ok ? col : 0), ok);
      }
#pragma unroll
      for (int hn = 0; hn < HN; ++hn) {
        const int col = 64 * hn + 4 * tx;
        const bool ok = t < S && col < N;
        const long long off = (row * G + g) * N + (ok ? col : 0);
        if (OUT) {
          cp16(Bs + j * LR + col, Bm + off, ok);
          cp16(Cs + j * LR + col, Cm + off, ok);
        } else {
          cp16(Bp + j * LBP + col, Bm + off, ok);
        }
      }
    }
    cp_wait_all();
    __syncthreads();   // the tile is in

    if (tid < 32) {
      // inclusive prefix of a over the tile: two steps a lane
      const float a0 = dts[2 * tid] * Ah;
      const float a1 = dts[2 * tid + 1] * Ah;
      float inc = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += u;
      }
      float ex = __shfl_up_sync(0xffffffffu, inc, 1);
      if (tid == 0) ex = 0.0f;
      cum[2 * tid] = ex + a0;
      cum[2 * tid + 1] = ex + a0 + a1;
    }
    __syncthreads();   // cum is in

    if (tid < TL) {
      ein[tid] = expf(cum[tid]);
      eout[tid] = expf(cum[TL - 1] - cum[tid]);
    }
    if (OUT) {
      // scores C B^T on the warp's block, masked and decayed, dt folded
      // in; the blocks above the diagonal are neither formed nor read
      const int nsc = wm + 15 < wn ? 0 : min(4, (wm + 15 - wn) / 8 + 1);
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
      warp_mma<false, true, ROLLED>(acc, Cs + wm * LR, LR, Bs + wn * LR, LR,
                                    0, NW, nsc, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= nsc) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wm + fg + 8 * (i >> 1);
          const int col = wn + 8 * nt + 2 * ft + (i & 1);
          Ss[r * LS + col] = col <= r
              ? acc[nt][i] * expf(cum[r] - cum[col]) * dts[col] : 0.0f;
        }
      }
    }
    __syncthreads();   // scores, ein and eout are in

    if (!OUT || !last) {
      // B' = B dt exp(cum_last - cum), for the state update
#pragma unroll
      for (int k = 0; k < TL / 16; ++k) {
        const int j = ty + 16 * k;
        const float f = eout[j] * dts[j];
#pragma unroll
        for (int hn = 0; hn < HN; ++hn) {
          const int col = 64 * hn + 4 * tx;
          const float4 v = ld4((OUT ? Bs + j * LR : Bp + j * LBP) + col);
          *reinterpret_cast<float4*>(Bp + j * LBP + col) =
              make_float4(v.x * f, v.y * f, v.z * f, v.w * f);
        }
      }
    }
    if (OUT) {
      // y = scores x + exp(cum) C S^T on the warp's blocks (rows r,
      // columns p); the scores vanish past the diagonal
#pragma unroll
      for (int hp = 0; hp < HP; ++hp) {
        float y1[4][4], y2[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) y1[nt][i] = y2[nt][i] = 0.0f;
        warp_mma<false, false, ROLLED>(y1, Ss + wm * LS, LS,
                                       Xs + 64 * hp + wn, LX, 0, wm + 16, 4,
                                       lane);
        warp_mma<false, true, ROLLED>(y2, Cs + wm * LR, LR,
                                      St + (64 * hp + wn) * LR, LR, 0, NW, 4,
                                      lane);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm + fg + 8 * half;
          const int t = t0 + r;
          if (t >= S) continue;
          const float e = ein[r];
          float* yo = y + ((static_cast<long long>(b) * S + t) * H + h) * P;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int p = 64 * hp + wn + 8 * nt + 2 * ft;
            if (p >= P) break;                 // P is a multiple of 16
            *reinterpret_cast<float2*>(yo + p) = make_float2(
                y1[nt][2 * half] + e * y2[nt][2 * half],
                y1[nt][2 * half + 1] + e * y2[nt][2 * half + 1]);
          }
        }
      }
      if (last) break;           // the chunk's end state is not needed
    }
    __syncthreads();   // B' is in; (OUT) the state's readers are done

    // S(p, n) = exp(cum_last) S(p, n) + sum_j x[j][p] B'[j][n]
    const float decay = ein[TL - 1];
    decay_all *= decay;
#pragma unroll
    for (int hp = 0; hp < HP; ++hp)
#pragma unroll
      for (int hn = 0; hn < HN; ++hn) {
        float (&s)[4][4] = sacc[hp * HN + hn];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[nt][i] *= decay;
        warp_mma<true, false, ROLLED>(s, Xs + 64 * hp + wm, LX,
                                      Bp + 64 * hn + wn, LBP, 0, TL, 4, lane);
        if (OUT) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              *reinterpret_cast<float2*>(
                  St + (64 * hp + wm + fg + 8 * half) * LR + 64 * hn + wn
                  + 8 * nt + 2 * ft) =
                  make_float2(s[nt][2 * half], s[nt][2 * half + 1]);
        }
      }
  }
  if (!OUT) {
#pragma unroll
    for (int hp = 0; hp < HP; ++hp)
#pragma unroll
      for (int hn = 0; hn < HN; ++hn) {
        if (64 * hp + wm >= P) continue;       // P is a multiple of 16
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (64 * hn + wn + 8 * nt >= N) break;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(
                wsc + (64 * hp + wm + fg + 8 * half) * N + 64 * hn + wn
                + 8 * nt + 2 * ft) =
                make_float2(sacc[hp * HN + hn][nt][2 * half],
                            sacc[hp * HN + hn][nt][2 * half + 1]);
        }
      }
    if (tid == 0) dec[bh * d.nc + c] = decay_all;
  }
}

// One thread per float4 of every (batch, head)'s state ([P][N], pn4
// float4s), walking the chunks in order: S_c = d_c S_{c-1} + s_c, with
// each chunk's own state s_c in ws replaced by its entry state S_{c-1}
// (zero for the first chunk), and the last S_c written to st_out.
__global__ void __launch_bounds__(THREADS)
ssd_carry_kernel(float* __restrict__ ws, const float* __restrict__ dec,
                 float* __restrict__ st_out, int nc, int pn4,
                 long long total) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long bh = idx / pn4;
  float4* w = reinterpret_cast<float4*>(ws) + bh * nc * pn4 + (idx - bh * pn4);
  const float* dc = dec + bh * nc;
  float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = 0; k0 < nc; k0 += CARRY_DEPTH) {
    float4 s[CARRY_DEPTH];
    float dk[CARRY_DEPTH];
#pragma unroll
    for (int j = 0; j < CARRY_DEPTH; ++j) {   // the loads, all at once
      const bool in = k0 + j < nc;
      s[j] = in ? w[static_cast<long long>(k0 + j) * pn4]
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dk[j] = in ? dc[k0 + j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < CARRY_DEPTH; ++j) {
      if (k0 + j >= nc) break;
      w[static_cast<long long>(k0 + j) * pn4] = run;
      run = make_float4(dk[j] * run.x + s[j].x, dk[j] * run.y + s[j].y,
                        dk[j] * run.z + s[j].z, dk[j] * run.w + s[j].w);
    }
  }
  reinterpret_cast<float4*>(st_out)[idx] = run;
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HP, int HN>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, float* y, float* st_out,
                   float* ws, float* dec, int B, const Dims& d,
                   cudaStream_t stream) {
  const auto state = ssd_chunk_kernel<HP, HN, false>;
  const auto out = ssd_chunk_kernel<HP, HN, true>;
  const size_t b_state = sizeof(float) * Tiles<HP, HN>::floats(false);
  const size_t b_out = sizeof(float) * Tiles<HP, HN>::floats(true);
  // once per instantiation
  static const cudaError_t attr = [&] {
    const cudaError_t e = prepare(state, b_state);
    return e != cudaSuccess ? e : prepare(out, b_out);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(d.nc, d.H, B);
  state<<<grid, THREADS, b_state, stream>>>(x, dt, A, Bm, Cm, y, ws, dec, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pn4 = d.P * d.N / 4;
  const long long total = static_cast<long long>(B) * d.H * pn4;
  ssd_carry_kernel<<<static_cast<unsigned>((total + THREADS - 1) / THREADS),
                     THREADS, 0, stream>>>(ws, dec, st_out, d.nc, pn4,
                                           total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  out<<<grid, THREADS, b_out, stream>>>(x, dt, A, Bm, Cm, y, ws, dec, d);
  return cudaGetLastError();
}

}  // namespace

// the largest P and N the kernel takes (both multiples of 16), and its
// chunk: the workspace holds one [P][N] state and one decay per chunk
extern "C" int ssd_scan_max_dim() { return MAXD; }
extern "C" int ssd_scan_chunk() { return CHUNK; }

// x [B, S, H, P], dt [B, S, H], A [H], Bm and Cm [B, S, G, N], y [B, S, H,
// P] and st_out [B, H, P, N], all float32 and contiguous; ws float32 of
// B H nc P N and dec of B H nc, nc = ceil(S / ssd_scan_chunk()).  Returns
// the CUDA error of the launches (0: ok).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* st_out, void* ws, void* dec, int B,
                               int S, int H, int P, int G, int N,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || N <= 0 ||
      P % 16 || N % 16 || P > MAXD || N > MAXD || B > 65535 || H > 65535 ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{S, H, P, G, N, (S + CHUNK - 1) / CHUNK};
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bf = static_cast<const float*>(Bm);
  const auto* Cf = static_cast<const float*>(Cm);
  auto* yf = static_cast<float*>(y);
  auto* sf = static_cast<float*>(st_out);
  auto* wf = static_cast<float*>(ws);
  auto* df = static_cast<float*>(dec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (P <= 64 && N <= 64)
    err = launch<1, 1>(xf, dtf, Af, Bf, Cf, yf, sf, wf, df, B, d, s);
  else if (N <= 64)
    err = launch<2, 1>(xf, dtf, Af, Bf, Cf, yf, sf, wf, df, B, d, s);
  else if (P <= 64)
    err = launch<1, 2>(xf, dtf, Af, Bf, Cf, yf, sf, wf, df, B, d, s);
  else
    err = launch<2, 2>(xf, dtf, Af, Bf, Cf, yf, sf, wf, df, B, d, s);
  return static_cast<int>(err);
}
