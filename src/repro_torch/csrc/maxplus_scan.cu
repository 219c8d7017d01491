// Exclusive prefix of factored max-plus block operators, one CTA per trial.
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
// What bounds it: bytes.  The tape is 2 * nb * W floats in and nb * W out,
// and the scan does ~3 * nb * W * log2(nb) float operations, far below
// the card's compute rate; at the engine's shapes (nb tens, W = 15) one
// trial's tape is a few KB.  So the design reads the tape once into
// shared memory (double-buffered), runs the log2(nb) doubling sweeps
// there with one thread per (block, worker) element and a __syncthreads
// between sweeps, and writes each entry once.  The launcher refuses a
// tape larger than the shared memory a CTA can hold (16 * nb * W bytes).
//
// Each element goes through exactly the adds and maxes of the plain
// PyTorch version in repro_torch/kernels/maxplus_scan/ops.py, in the same
// order (__fadd_rn, NaN-propagating max), so the two are bitwise equal.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmemBytes = 232448;   // 227 KB: the H100's CTA limit

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void maxplus_scan_kernel(const float* __restrict__ diag,
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

}  // namespace

extern "C" {

// Largest nb * W the launcher takes (four nb * W float buffers in shared
// memory); the Python wrapper checks it before it calls.
int maxplus_scan_max_elems() {
  return static_cast<int>(kMaxSmemBytes / (4 * sizeof(float)));
}

// diag/off/entries: (T, nb, W) row-major; wf0/wf_out: (T, W).
// Returns the first CUDA error of the attribute call or the launch.
int maxplus_scan_launch(const float* diag, const float* off,
                        const float* wf0, float* entries, float* wf_out,
                        int T, int nb, int W, cudaStream_t stream) {
  if (T <= 0 || nb <= 0 || W <= 0 || nb > maxplus_scan_max_elems() / W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 4 * static_cast<size_t>(nb) * W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        maxplus_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  maxplus_scan_kernel<<<T, kThreads, smem, stream>>>(diag, off, wf0, entries,
                                                     wf_out, nb, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
