// Mamba2 SSD (state-space duality) scan, one thread block per (head,
// batch) walking the sequence in order.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan/kernel.py (ssd_scan:
// grid (B, H, chunks) with the chunk dimension sequential and the [P, N]
// state carried in VMEM scratch between grid steps).  Here the walk over
// the sequence is a loop inside the block, and the state stays in shared
// memory from the first step to the last.
//
// Per head h (group g = h / (H / G)), step t, with a_t = dt_t A_h:
//   S_t = exp(a_t) S_{t-1} + (dt_t x_t) B_t^T        state [P, N]
//   y_t = S_t C_t                                     [P]
// computed a tile of TL = 64 steps at a time in the chunked (SSD) form:
// with cum the inclusive prefix of a over the tile,
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) S_prev C_i
//   S    = exp(cum_last) S_prev + sum_j dt_j x_j B_j^T exp(cum_last - cum_j)
// which is exact for any tile length: the reference's chunk (256) is a
// TPU tiling, and this kernel's tile of 64 is its own.  Steps past the end
// of the sequence are zero (dt = 0, x = 0), which leaves the state as it
// is.
//
// What bounds it: operations.  zamba2-1.2b's prefill (B=2, S=4096, H=64,
// P=N=64) needs ~1.1e10 float32 operations even as the plain recurrence
// (5 P N per step and head), ~0.16 ms at the card's 67 TFLOP/s outside
// the tensor cores, against ~23 MB of traffic (~0.007 ms).  The reference
// holds the scan to 2e-4, which TF32 would not keep, so all three products
// of a tile run on the CUDA cores in float32: C B^T (64 x 64), its masked
// and decayed product with dt x (64 x P) plus C S_prev^T, and the state
// update dt x^T (B scaled by the decay to the tile's end) (P x N), each
// thread owning a 4 x 4 (or 4 x P/16, P/16 x N/16) block, the tiles in
// shared memory with rows padded so that the float4 reads of neighbouring
// rows hit different banks.  Only B x H blocks run (128 at zamba2's
// shapes, about one per SM); splitting the sequence across blocks is later
// work.  No --use_fast_math: expf is the accurate one.
#include <cuda_runtime.h>

namespace {

constexpr int TL = 64;           // steps per tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int MAXD = 128;        // largest P and N

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc += a.x * b.x;
  acc += a.y * b.y;
  acc += a.z * b.z;
  acc += a.w * b.w;
  return acc;
}

size_t smem_floats(int P, int N) {
  const int LN = N + 4;
  return static_cast<size_t>(TL) * P + 2 * TL * LN + TL * (TL + 4)
         + static_cast<size_t>(P) * LN + 4 * TL;
}

// PC: the most columns of P or N a thread owns (max(P, N) / 16, rounded
// up to 2, 4 or 8), so that the per-thread arrays fit the shapes
template <int PC>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ st_out, int S, int H, int P, int G,
                int N) {
  extern __shared__ __align__(16) float sm[];
  const int LN = N + 4;          // row stride of B, C and the state
  const int LS = TL + 4;         // row stride of the score tile
  float* Xs = sm;                // [TL][P]   dt x
  float* Bs = Xs + TL * P;       // [TL][LN]  B, then B exp(cum_last - cum)
  float* Cs = Bs + TL * LN;      // [TL][LN]
  float* Ss = Cs + TL * LN;      // [TL][LS]  (C B^T) exp(cum_i - cum_j)
  float* St = Ss + TL * LS;      // [P][LN]   the state
  float* cum = St + P * LN;      // [TL]
  float* ein = cum + TL;         // exp(cum_i)
  float* eout = ein + TL;        // exp(cum_last - cum_j)
  float* dts = eout + TL;        // dt

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float Ah = A[h];
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int pc = P / 16;
  const int nc = N / 16;
  const int P4 = P / 4;
  const int N4 = N / 4;

  for (int i = tid; i < P * LN; i += THREADS) St[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += TL) {
    if (tid < TL) {
      const int t = t0 + tid;
      dts[tid] = t < S ? dt[(static_cast<long long>(b) * S + t) * H + h]
                       : 0.0f;
    }
    __syncthreads();   // dts is in; the previous tile's readers are done

    for (int i = tid; i < TL * P4; i += THREADS) {
      const int j = i / P4;
      const int c = (i % P4) * 4;
      const int t = t0 + j;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t < S)
        v = __ldg(reinterpret_cast<const float4*>(
            x + ((static_cast<long long>(b) * S + t) * H + h) * P + c));
      const float d = dts[j];
      *reinterpret_cast<float4*>(Xs + j * P + c) =
          make_float4(v.x * d, v.y * d, v.z * d, v.w * d);
    }
    for (int i = tid; i < TL * N4; i += THREADS) {
      const int j = i / N4;
      const int c = (i % N4) * 4;
      const int t = t0 + j;
      float4 vb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 vc = vb;
      if (t < S) {
        const long long off =
            ((static_cast<long long>(b) * S + t) * G + g) * N + c;
        vb = __ldg(reinterpret_cast<const float4*>(Bm + off));
        vc = __ldg(reinterpret_cast<const float4*>(Cm + off));
      }
      *reinterpret_cast<float4*>(Bs + j * LN + c) = vb;
      *reinterpret_cast<float4*>(Cs + j * LN + c) = vc;
    }
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
    __syncthreads();   // the tile and cum are in

    if (tid < TL) {
      ein[tid] = expf(cum[tid]);
      eout[tid] = expf(cum[TL - 1] - cum[tid]);
    }
    // scores: C B^T, masked and decayed
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      for (int n = 0; n < N; n += 4) {
        float4 c4[4], b4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          c4[i] = *reinterpret_cast<const float4*>(Cs + (ty + 16 * i) * LN
                                                   + n);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b4[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * LN
                                                   + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(c4[i], b4[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          Ss[r * LS + c] = c <= r ? s[i][j] * expf(cum[r] - cum[c]) : 0.0f;
        }
      }
    }
    __syncthreads();   // scores, ein and eout are in

    // B scaled by the decay to the tile's end, for the state update
    for (int i = tid; i < TL * N; i += THREADS) {
      const int j = i / N;
      Bs[j * LN + i % N] *= eout[j];
    }
    // y = scores (dt x) + exp(cum) C S_prev^T
    {
      float acc[4][PC], acc2[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < PC; ++q) acc[i][q] = acc2[i][q] = 0.0f;
      for (int j = 0; j < TL; j += 4) {
        float4 s4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s4[i] = *reinterpret_cast<const float4*>(Ss + (ty + 16 * i) * LS
                                                   + j);
#pragma unroll
        for (int q = 0; q < PC; ++q) {
          if (q < pc) {
            const int p = tx + 16 * q;
            const float4 xv = make_float4(Xs[j * P + p], Xs[(j + 1) * P + p],
                                          Xs[(j + 2) * P + p],
                                          Xs[(j + 3) * P + p]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][q] = dot4(s4[i], xv,
                                                         acc[i][q]);
          }
        }
      }
      for (int n = 0; n < N; n += 4) {
        float4 c4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          c4[i] = *reinterpret_cast<const float4*>(Cs + (ty + 16 * i) * LN
                                                   + n);
#pragma unroll
        for (int q = 0; q < PC; ++q) {
          if (q < pc) {
            const float4 sv = *reinterpret_cast<const float4*>(
                St + (tx + 16 * q) * LN + n);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc2[i][q] = dot4(c4[i], sv,
                                                          acc2[i][q]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int t = t0 + r;
        if (t >= S) continue;
        float* yo = y + ((static_cast<long long>(b) * S + t) * H + h) * P;
#pragma unroll
        for (int q = 0; q < PC; ++q)
          if (q < pc) yo[tx + 16 * q] = acc[i][q] + ein[r] * acc2[i][q];
      }
    }
    __syncthreads();   // the state's readers are done; B is scaled

    // S = exp(cum_last) S_prev + (dt x)^T (B exp(cum_last - cum))
    {
      float acc[PC][PC];
#pragma unroll
      for (int q = 0; q < PC; ++q)
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[q][k] = 0.0f;
      for (int j = 0; j < TL; ++j) {
        float xv[PC], bv[PC];
#pragma unroll
        for (int q = 0; q < PC; ++q)
          xv[q] = q < pc ? Xs[j * P + ty + 16 * q] : 0.0f;
#pragma unroll
        for (int k = 0; k < PC; ++k)
          bv[k] = k < nc ? Bs[j * LN + tx + 16 * k] : 0.0f;
#pragma unroll
        for (int q = 0; q < PC; ++q)
#pragma unroll
          for (int k = 0; k < PC; ++k) acc[q][k] += xv[q] * bv[k];
      }
      const float decay = ein[TL - 1];
#pragma unroll
      for (int q = 0; q < PC; ++q) {
        if (q >= pc) continue;
#pragma unroll
        for (int k = 0; k < PC; ++k) {
          if (k >= nc) continue;
          float* sp = St + (ty + 16 * q) * LN + tx + 16 * k;
          *sp = *sp * decay + acc[q][k];
        }
      }
    }
  }
  __syncthreads();
  float* so = st_out + (static_cast<long long>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS)
    so[i] = St[(i / N) * LN + i % N];
}

}  // namespace

// the largest P and N the kernel takes (both multiples of 16)
extern "C" int ssd_scan_max_dim() { return MAXD; }

// x [B, S, H, P], dt [B, S, H], A [H], Bm and Cm [B, S, G, N], y [B, S, H,
// P] and st_out [B, H, P, N], all float32 and contiguous.  Returns the
// CUDA error of the launch (0: ok).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* st_out, int B, int S, int H, int P,
                               int G, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || N <= 0 ||
      P % 16 || N % 16 || P > MAXD || N > MAXD || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = P > N ? P : N;
  const auto kernel = m <= 32 ? ssd_scan_kernel<2>
                    : m <= 64 ? ssd_scan_kernel<4> : ssd_scan_kernel<8>;
  const size_t bytes = sizeof(float) * smem_floats(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(st_out), S, H, P, G, N);
  return static_cast<int>(cudaGetLastError());
}
