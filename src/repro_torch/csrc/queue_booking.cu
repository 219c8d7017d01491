// Sequential best-fit booking of ready-sorted event streams, one warp per
// trial.
//
// Replaces the Pallas kernel repro/kernels/queue_booking/kernel.py
// (queue_booking, the VMEM-resident fori_loop over each block of events).
//
// Per event i of a trial's stream (ready r, service s), against the
// per-worker free-at vector wf:
//   key_w = wf_w <= r ? wf_w : -wf_w      (free workers by wf, busy by -wf)
//   w     = argmax_w key_w                (lowest index wins a tie)
//   start = max(r, -key_w);  fin = start + s;  wf_w = fin
// An event with r = +-inf books nothing: worker -1, start and fin inf.
//
// What bounds it: the chain of N dependent argmax steps per trial, not
// bytes (each event is 8 bytes in, 12 bytes out).  Each step is a handful
// of register compares plus a 5-level warp-shuffle reduction, so the
// design keeps the whole W-vector in registers (worker lane + 32 * j lives
// in slot j of lane `lane`), reduces with __shfl_xor_sync, and stages the
// events and outputs of `tile` events at a time through shared memory so
// that every global load and store is coalesced.  The tile only chunks
// the stream: the result does not depend on it.  Trials are independent
// (one CTA of one warp each), so T trials use T SMs.
//
// Arithmetic is compare/select and one float add (__fadd_rn, so nothing
// can be contracted); results are bitwise those of the plain PyTorch
// version in repro_torch/kernels/queue_booking/ops.py.
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

// max that propagates NaN like torch.maximum / jnp.maximum (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <int SLOTS>
__global__ void queue_booking_kernel(const float* __restrict__ ready,
                                     const float* __restrict__ service,
                                     const float* __restrict__ wf0,
                                     float* __restrict__ fin,
                                     float* __restrict__ start,
                                     int* __restrict__ worker,
                                     float* __restrict__ wf_out,
                                     int N, int W, int tile) {
  extern __shared__ float smem[];
  float* r_s = smem;
  float* s_s = r_s + tile;
  float* f_s = s_s + tile;
  float* st_s = f_s + tile;
  int* w_s = reinterpret_cast<int*>(st_s + tile);

  const int lane = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * N;
  const float* r_row = ready + row;
  const float* s_row = service + row;

  float wf[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int w = lane + 32 * j;
    wf[j] = w < W ? wf0[static_cast<size_t>(blockIdx.x) * W + w] : 0.0f;
  }

  for (int base = 0; base < N; base += tile) {
    const int n = min(tile, N - base);
    for (int i = lane; i < n; i += 32) {
      r_s[i] = r_row[base + i];
      s_s[i] = s_row[base + i];
    }
    __syncwarp();
    for (int i = 0; i < n; ++i) {
      const float r = r_s[i];
      const float s = s_s[i];
      float k = -INFINITY;
      int idx = INT_MAX;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int w = lane + 32 * j;
        if (w < W) {
          const float kj = wf[j] <= r ? wf[j] : -wf[j];
          if (kj > k || (kj == k && w < idx)) {
            k = kj;
            idx = w;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ko = __shfl_xor_sync(0xffffffffu, k, off);
        const int io = __shfl_xor_sync(0xffffffffu, idx, off);
        if (ko > k || (ko == k && io < idx)) {
          k = ko;
          idx = io;
        }
      }
      const bool live = !isinf(r);
      const float st = max_nan(r, -k);
      const float f = __fadd_rn(st, s);
      if (live) {
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) {
          if (lane + 32 * j == idx) wf[j] = f;
        }
      }
      if (lane == 0) {
        f_s[i] = live ? f : INFINITY;
        st_s[i] = live ? st : INFINITY;
        w_s[i] = live ? idx : -1;
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      fin[row + base + i] = f_s[i];
      start[row + base + i] = st_s[i];
      worker[row + base + i] = w_s[i];
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int w = lane + 32 * j;
    if (w < W) wf_out[static_cast<size_t>(blockIdx.x) * W + w] = wf[j];
  }
}

}  // namespace

extern "C" {

// Largest pool and tile the launcher takes; the Python wrapper checks both
// before it calls.
int queue_booking_max_workers() { return 32 * 8; }
int queue_booking_max_tile() { return 2048; }

// ready/service/fin/start/worker: (T, N) row-major; wf0/wf_out: (T, W).
// Returns cudaGetLastError() right after the launch.
int queue_booking_launch(const float* ready, const float* service,
                         const float* wf0, float* fin, float* start,
                         int* worker, float* wf_out, int T, int N, int W,
                         int tile, cudaStream_t stream) {
  if (T <= 0 || W <= 0 || W > queue_booking_max_workers() || tile <= 0 ||
      tile > queue_booking_max_tile()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 5 * static_cast<size_t>(tile) * sizeof(float);
  if (W <= 32) {
    queue_booking_kernel<1><<<T, 32, smem, stream>>>(
        ready, service, wf0, fin, start, worker, wf_out, N, W, tile);
  } else if (W <= 64) {
    queue_booking_kernel<2><<<T, 32, smem, stream>>>(
        ready, service, wf0, fin, start, worker, wf_out, N, W, tile);
  } else if (W <= 128) {
    queue_booking_kernel<4><<<T, 32, smem, stream>>>(
        ready, service, wf0, fin, start, worker, wf_out, N, W, tile);
  } else {
    queue_booking_kernel<8><<<T, 32, smem, stream>>>(
        ready, service, wf0, fin, start, worker, wf_out, N, W, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
