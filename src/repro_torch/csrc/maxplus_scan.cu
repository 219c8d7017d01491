// Exclusive prefix of factored max-plus block operators: each (trial,
// worker) column scanned in the registers of one warp or part of one.
//
// Replaces the Pallas kernel repro/kernels/maxplus_scan/kernel.py
// (maxplus_scan, the VMEM-resident Hillis-Steele doubling scan).
//
// A block operator (d, b) maps a free-at vector wf to max(wf + d, b),
// elementwise over the W workers; "op1 then op2" composes in closed form:
//   compose((d1, b1), (d2, b2)) = (d1 + d2, max(b1 + d2, b2))
// with identity (0, -inf).  For a trial's tape of nb operators the kernel
// returns every block's entry vector entries[k] = apply(op_0..op_{k-1},
// wf0) (row 0 is wf0) and wf_out = apply(op_0..op_{nb-1}, wf0).
//
// What bounds it: the launch.  The tape is 2 * nb * W floats in and
// nb * W out, and the scan ~3 * nb * W * log2(nb) float operations; at
// the engine's shapes (nb tens, W = 15) that is a few KB and well under a
// microsecond of the card's rates, so the design keeps the fixed cost per
// launch down: no shared memory and no barrier.  The W columns of a trial
// are independent, so each (trial, worker) column is scanned by C lanes
// of one warp (C the smallest power of two >= nb, up to 32); lane l holds
// blocks l, l + C, l + 2C, ... in R registers of d and of b.  A doubling
// sweep by s < C takes block k - s from lane l - s by a shuffle (from the
// lane's previous register where l < s); a sweep by s >= C is a multiple
// of C and moves values between the lane's own registers.  Tapes longer
// than 32 * kMaxRegs blocks (only narrow pools, since nb * W is bounded)
// run the same sweeps in one CTA's shared memory, a barrier between each.
//
// Both kernels run the same doubling sweeps as the plain PyTorch version
// in repro_torch/kernels/maxplus_scan/ops.py, with the same adds and maxes
// per element in the same order (__fadd_rn, NaN-propagating max), so the
// results are bitwise equal to it on any tape.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRegThreads = 128;   // register kernel: 4 warps a CTA
constexpr int kMaxRegs = 32;       // register kernel: nb <= 32 * 32
constexpr int kSmemThreads = 256;
constexpr size_t kMaxSmemBytes = 232448;   // 227 KB: the H100's CTA limit

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// One doubling sweep by S (a compile-time power of two) over a column
// held as R registers in each of C lanes: element k = r * C + l.
template <int R, int C, int S>
__device__ __forceinline__ void sweep(float (&d)[R], float (&b)[R], int l) {
  if constexpr (S < C) {
    // block k - S is lane l - S's register r, or for l < S the register
    // r - 1 of lane l - S + C (the identity at r = 0): every lane reads
    // its own register r of lane (l - S) mod C and keeps the last one
    const int src = (l - S) & (C - 1);
    const bool own = l >= S;
    float cd = 0.0f, cb = -INFINITY;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xd = __shfl_sync(0xffffffffu, d[r], src, C);
      const float xb = __shfl_sync(0xffffffffu, b[r], src, C);
      const float dsh = own ? xd : cd;
      const float bsh = own ? xb : cb;
      cd = xd;
      cb = xb;
      b[r] = max_nan(__fadd_rn(bsh, d[r]), b[r]);
      d[r] = __fadd_rn(dsh, d[r]);
    }
  } else {
    constexpr int M = S / C;       // whole registers; descending, in place
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const float dsh = r >= M ? d[r >= M ? r - M : 0] : 0.0f;
      const float bsh = r >= M ? b[r >= M ? r - M : 0] : -INFINITY;
      b[r] = max_nan(__fadd_rn(bsh, d[r]), b[r]);
      d[r] = __fadd_rn(dsh, d[r]);
    }
  }
}

template <int R, int C, int LG>
__device__ __forceinline__ void sweeps(float (&d)[R], float (&b)[R], int l,
                                       int nb) {
  if constexpr ((1 << LG) < R * C) {
    if ((1 << LG) >= nb) return;
    sweep<R, C, (1 << LG)>(d, b, l);
    sweeps<R, C, LG + 1>(d, b, l, nb);
  }
}

template <int R, int C>
__global__ void __launch_bounds__(kRegThreads)
maxplus_scan_reg_kernel(const float* __restrict__ diag,
                        const float* __restrict__ off,
                        const float* __restrict__ wf0,
                        float* __restrict__ entries,
                        float* __restrict__ wf_out, int T, int nb, int W) {
  const int g = blockIdx.x * kRegThreads + threadIdx.x;
  const int l = g & (C - 1);
  const int cols = T * W;
  // every lane joins the shuffles; a lane past the last column scans a
  // copy of it and stores nothing
  const bool active = g / C < cols;
  const int col = active ? g / C : cols - 1;
  const int t = col / W;
  const int w = col - t * W;
  const size_t base = static_cast<size_t>(t) * nb * W + w;
  float d[R], b[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = r * C + l;
    const bool in = k < nb;
    d[r] = in ? __ldg(diag + base + static_cast<size_t>(k) * W) : 0.0f;
    b[r] = in ? __ldg(off + base + static_cast<size_t>(k) * W) : -INFINITY;
  }
  const float w0 = __ldg(wf0 + col);
  sweeps<R, C, 0>(d, b, l, nb);
  // entries[k] applies the inclusive prefix of block k - 1 (the identity
  // at k = 0) to wf0: a shift by one block, as in the sweeps
  const int src = (l - 1) & (C - 1);
  const bool own = l >= 1;
  float cd = 0.0f, cb = -INFINITY;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float xd = __shfl_sync(0xffffffffu, d[r], src, C);
    const float xb = __shfl_sync(0xffffffffu, b[r], src, C);
    const float pd = own ? xd : cd;
    const float pb = own ? xb : cb;
    cd = xd;
    cb = xb;
    const int k = r * C + l;
    if (active && k < nb) {
      entries[base + static_cast<size_t>(k) * W] =
          max_nan(__fadd_rn(w0, pd), pb);
    }
    if (active && k == nb - 1) {
      wf_out[col] = max_nan(__fadd_rn(w0, d[r]), b[r]);
    }
  }
}

// Tapes beyond the register kernel: one CTA per trial, the tape in shared
// memory (double-buffered), one thread per (block, worker) element and a
// barrier between sweeps.
__global__ void maxplus_scan_smem_kernel(const float* __restrict__ diag,
                                         const float* __restrict__ off,
                                         const float* __restrict__ wf0,
                                         float* __restrict__ entries,
                                         float* __restrict__ wf_out,
                                         int nb, int W) {
  extern __shared__ float smem[];
  const int n = nb * W;
  float* d_cur = smem;
  float* b_cur = d_cur + n;
  float* d_nxt = b_cur + n;
  float* b_nxt = d_nxt + n;
  const size_t tape = static_cast<size_t>(blockIdx.x) * n;
  const float* w0 = wf0 + static_cast<size_t>(blockIdx.x) * W;

  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    d_cur[e] = diag[tape + e];
    b_cur[e] = off[tape + e];
  }
  __syncthreads();
  // inclusive doubling sweeps: afterwards row k holds op_0 .. op_k
  for (int s = 1; s < nb; s <<= 1) {
    const int shift = s * W;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const bool in = e >= shift;
      const float d_sh = in ? d_cur[e - shift] : 0.0f;
      const float b_sh = in ? b_cur[e - shift] : -INFINITY;
      const float d = d_cur[e];
      d_nxt[e] = __fadd_rn(d_sh, d);
      b_nxt[e] = max_nan(__fadd_rn(b_sh, d), b_cur[e]);
    }
    __syncthreads();
    float* t = d_cur; d_cur = d_nxt; d_nxt = t;
    t = b_cur; b_cur = b_nxt; b_nxt = t;
  }
  // entries: row k applies the EXCLUSIVE prefix (rows < k) to wf0
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int w = e % W;
    const bool in = e >= W;
    const float pd = in ? d_cur[e - W] : 0.0f;
    const float pb = in ? b_cur[e - W] : -INFINITY;
    entries[tape + e] = max_nan(__fadd_rn(w0[w], pd), pb);
  }
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int last = (nb - 1) * W + w;
    wf_out[static_cast<size_t>(blockIdx.x) * W + w] =
        max_nan(__fadd_rn(w0[w], d_cur[last]), b_cur[last]);
  }
}

template <int R, int C>
void launch_reg(const float* diag, const float* off, const float* wf0,
                float* entries, float* wf_out, int T, int nb, int W,
                cudaStream_t stream) {
  const long threads = static_cast<long>(T) * W * C;
  const int blocks = static_cast<int>((threads + kRegThreads - 1) /
                                      kRegThreads);
  maxplus_scan_reg_kernel<R, C><<<blocks, kRegThreads, 0, stream>>>(
      diag, off, wf0, entries, wf_out, T, nb, W);
}

__global__ void noop_kernel() {}

}  // namespace

extern "C" {

// Largest nb * W the launcher takes (the shared-memory kernel's four
// nb * W float buffers); the Python wrapper reads it once.
int maxplus_scan_max_elems() {
  return static_cast<int>(kMaxSmemBytes / (4 * sizeof(float)));
}

// Longest tape the register kernel takes; longer ones run in shared
// memory.
int maxplus_scan_max_reg_blocks() { return 32 * kMaxRegs; }

// diag/off/entries: (T, nb, W) row-major; wf0/wf_out: (T, W).
// lanes/regs: the wrapper's plan (scan_plan in ops.py), checked here;
// lanes = 0 runs the shared-memory kernel.  Returns the first CUDA error
// of the attribute call or the launch.
int maxplus_scan_launch(const float* diag, const float* off,
                        const float* wf0, float* entries, float* wf_out,
                        int T, int nb, int W, int lanes, int regs,
                        cudaStream_t stream) {
  if (T <= 0 || nb <= 0 || W <= 0 || nb > maxplus_scan_max_elems() / W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lanes == 0) {
    const size_t smem = 4 * static_cast<size_t>(nb) * W * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          maxplus_scan_smem_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    maxplus_scan_smem_kernel<<<T, kSmemThreads, smem, stream>>>(
        diag, off, wf0, entries, wf_out, nb, W);
    return static_cast<int>(cudaGetLastError());
  }
  const bool pow2 = lanes > 0 && regs > 0 && (lanes & (lanes - 1)) == 0 &&
                    (regs & (regs - 1)) == 0;
  if (!pow2 || lanes > 32 || regs > kMaxRegs || lanes * regs < nb ||
      (regs > 1 && lanes != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define MS_ARGS diag, off, wf0, entries, wf_out, T, nb, W, stream
  switch (regs) {
    case 1:
      switch (lanes) {
        case 1: launch_reg<1, 1>(MS_ARGS); break;
        case 2: launch_reg<1, 2>(MS_ARGS); break;
        case 4: launch_reg<1, 4>(MS_ARGS); break;
        case 8: launch_reg<1, 8>(MS_ARGS); break;
        case 16: launch_reg<1, 16>(MS_ARGS); break;
        default: launch_reg<1, 32>(MS_ARGS); break;
      }
      break;
    case 2: launch_reg<2, 32>(MS_ARGS); break;
    case 4: launch_reg<4, 32>(MS_ARGS); break;
    case 8: launch_reg<8, 32>(MS_ARGS); break;
    case 16: launch_reg<16, 32>(MS_ARGS); break;
    default: launch_reg<32, 32>(MS_ARGS); break;
  }
#undef MS_ARGS
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of one warp, launched as the scan is: the launch floor
// that the scan's device time is held against.
int maxplus_scan_noop_launch(cudaStream_t stream) {
  noop_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
