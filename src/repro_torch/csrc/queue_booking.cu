// Sequential best-fit booking of ready-sorted event streams: each trial's
// W-vector in the registers of L lanes (one lane for W <= 16).
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
// What bounds it: the N dependent argmax steps per trial, not bytes (each
// event is 8 bytes in, 12 bytes out).  So nothing but the steps sits on
// the chain:
// - A trial has L lanes (the wrapper's plan: the smallest power of two
//   with ceil(W / L) <= 16; L = 1 at the engine's W = 15, whose S = W
//   slots hold the whole pool).  Lane q holds workers q*S .. q*S + S-1 in
//   registers (S = 16 where L > 1); workers past W are padding at +inf,
//   whose key is -inf for every live event, so they never win (a tie goes
//   to the lower index) and are never written.
// - One event is S compare-selects for the keys, a balanced compare-select
//   tree over them (lower indices on the left; the right side wins only if
//   strictly greater, so a tie keeps the lowest index), log2(L) width-L
//   shuffles across the trial's lanes (none at L = 1), the max and the add,
//   and a select into the winning register.
// - The loads and stores are off the chain: the next group of kGroup
//   events is loaded into registers while the current one is booked, and
//   each group's fin, start and worker are stored together (as 16-byte
//   vectors where every row is 16-byte aligned).  There is no barrier and
//   no __syncwarp in the loop; the trials of a warp are independent.
// At W = 15 an event is ~15 dependent instructions but ~107 compares and
// selects, which the ALU pipe takes at one warp instruction every second
// cycle: those, not the chain, set the pace (the SASS counts that
// chip_smoke.py prints).
//
// Arithmetic is compare/select and one float add (__fadd_rn, so nothing
// can be contracted), with the same comparisons as the plain PyTorch
// version in repro_torch/kernels/queue_booking/ops.py: the results are
// bitwise equal to it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 16;
constexpr int kMaxSlots = 16;
constexpr int kGroup = 8;          // events loaded and stored together

// max that propagates NaN like torch.maximum / jnp.maximum (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The balanced argmax tree over the first N entries, in place, one level
// per template: entry j of a level is the better of entries 2j and
// 2j + 1 (the right one only if strictly greater, so a tie keeps the lower
// index); an odd last entry moves up unopposed.  Every index is a
// constant, so the arrays stay in registers.
template <int S, int N>
__device__ __forceinline__ void argmax_tree(float (&k)[S], int (&ix)[S]) {
  if constexpr (N > 1) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const bool right = k[2 * j + 1] > k[2 * j];
      k[j] = right ? k[2 * j + 1] : k[2 * j];
      ix[j] = right ? ix[2 * j + 1] : ix[2 * j];
    }
    if constexpr (N % 2 == 1) {
      k[N / 2] = k[N - 1];
      ix[N / 2] = ix[N - 1];
    }
    argmax_tree<S, (N + 1) / 2>(k, ix);
  }
}

// One trial's booking state in one lane: S workers, first index q * S.
template <int L, int S>
struct Booker {
  float wf[S];
  int first;                       // index of this lane's first worker

  __device__ __forceinline__ void event(float r, float s, float& fo,
                                        float& so, int& wo) {
    float k[S];
    int ix[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      k[j] = wf[j] <= r ? wf[j] : -wf[j];
      ix[j] = j;
    }
    argmax_tree<S, S>(k, ix);
    float key = k[0];
    int idx = first + ix[0];
#pragma unroll
    for (int off = L / 2; off >= 1; off /= 2) {
      const float ko = __shfl_xor_sync(0xffffffffu, key, off, L);
      const int io = __shfl_xor_sync(0xffffffffu, idx, off, L);
      const bool take = ko > key || (ko == key && io < idx);
      key = take ? ko : key;
      idx = take ? io : idx;
    }
    const bool live = !isinf(r);
    const float st = max_nan(r, -key);
    const float f = __fadd_rn(st, s);
    const int mine = live ? idx - first : -1;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (mine == j) wf[j] = f;
    }
    fo = live ? f : INFINITY;
    so = live ? st : INFINITY;
    wo = live ? idx : -1;
  }
};

template <int L, int S, bool VEC>
__global__ void __launch_bounds__(32)
queue_booking_kernel(const float* __restrict__ ready,
                     const float* __restrict__ service,
                     const float* __restrict__ wf0, float* __restrict__ fin,
                     float* __restrict__ start, int* __restrict__ worker,
                     float* __restrict__ wf_out, int T, int N, int W) {
  const int g = blockIdx.x * 32 + threadIdx.x;
  const int q = g % L;
  // every lane of the warp takes part in the shuffles: lanes past the last
  // trial book a copy of it and store nothing
  const bool active = g / L < T;
  const int t = active ? g / L : T - 1;
  Booker<L, S> bk;
  bk.first = q * S;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int w = bk.first + j;
    bk.wf[j] = w < W ? wf0[static_cast<size_t>(t) * W + w] : INFINITY;
  }
  const size_t row = static_cast<size_t>(t) * N;
  const float* r_row = ready + row;
  const float* s_row = service + row;
  const bool writer = active && q == 0;
  const int groups = N / kGroup;

  float rn[kGroup], sn[kGroup];
  auto load = [&](int base) {
    if (VEC) {
#pragma unroll
      for (int e = 0; e < kGroup; e += 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(
            r_row + base + e));
        const float4 b = __ldg(reinterpret_cast<const float4*>(
            s_row + base + e));
        rn[e] = a.x; rn[e + 1] = a.y; rn[e + 2] = a.z; rn[e + 3] = a.w;
        sn[e] = b.x; sn[e + 1] = b.y; sn[e + 2] = b.z; sn[e + 3] = b.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        rn[e] = __ldg(r_row + base + e);
        sn[e] = __ldg(s_row + base + e);
      }
    }
  };
  if (groups > 0) load(0);
#pragma unroll 1
  for (int gi = 0; gi < groups; ++gi) {
    float rc[kGroup], sc[kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      rc[e] = rn[e];
      sc[e] = sn[e];
    }
    // the next group's loads are in flight while this one is booked
    load(min(gi + 1, groups - 1) * kGroup);
    float fo[kGroup], so[kGroup];
    int wo[kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) bk.event(rc[e], sc[e], fo[e], so[e],
                                              wo[e]);
    if (writer) {
      const size_t at = row + static_cast<size_t>(gi) * kGroup;
      if (VEC) {
#pragma unroll
        for (int e = 0; e < kGroup; e += 4) {
          *reinterpret_cast<float4*>(fin + at + e) =
              make_float4(fo[e], fo[e + 1], fo[e + 2], fo[e + 3]);
          *reinterpret_cast<float4*>(start + at + e) =
              make_float4(so[e], so[e + 1], so[e + 2], so[e + 3]);
          *reinterpret_cast<int4*>(worker + at + e) =
              make_int4(wo[e], wo[e + 1], wo[e + 2], wo[e + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kGroup; ++e) {
          fin[at + e] = fo[e];
          start[at + e] = so[e];
          worker[at + e] = wo[e];
        }
      }
    }
  }
  // the last N % kGroup events, one at a time
#pragma unroll 1
  for (int i = groups * kGroup; i < N; ++i) {
    float fo, so;
    int wo;
    bk.event(r_row[i], s_row[i], fo, so, wo);
    if (writer) {
      fin[row + i] = fo;
      start[row + i] = so;
      worker[row + i] = wo;
    }
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int w = bk.first + j;
    if (active && w < W) wf_out[static_cast<size_t>(t) * W + w] = bk.wf[j];
  }
}

template <int L, int S>
void launch(bool vec, const float* ready, const float* service,
            const float* wf0, float* fin, float* start, int* worker,
            float* wf_out, int T, int N, int W, cudaStream_t stream) {
  const int blocks = (T * L + 31) / 32;
  if (vec) {
    queue_booking_kernel<L, S, true><<<blocks, 32, 0, stream>>>(
        ready, service, wf0, fin, start, worker, wf_out, T, N, W);
  } else {
    queue_booking_kernel<L, S, false><<<blocks, 32, 0, stream>>>(
        ready, service, wf0, fin, start, worker, wf_out, T, N, W);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Largest pool and tile the launcher takes; the Python wrapper reads both
// once.  The tile is the event block of the reference kernel's signature:
// this kernel has none, and the result does not depend on it.
int queue_booking_max_workers() { return kMaxLanes * kMaxSlots; }
int queue_booking_max_tile() { return 2048; }
// Events one pass of the kernel's main loop books (for reading its SASS).
int queue_booking_group() { return kGroup; }

// ready/service/fin/start/worker: (T, N) row-major; wf0/wf_out: (T, W).
// lanes/slots: the wrapper's plan (booking_plan in ops.py), checked here.
// Returns cudaGetLastError() right after the launch.
int queue_booking_launch(const float* ready, const float* service,
                         const float* wf0, float* fin, float* start,
                         int* worker, float* wf_out, int T, int N, int W,
                         int tile, int lanes, int slots,
                         cudaStream_t stream) {
  // one lane of 1 to 16 slots (booking_plan's at W <= 16), or 2 to 16
  // lanes of a power of two of slots (its plan is 16; fewer lanes' worth
  // of slots for timing other plans, launch/bench_kernels.py)
  const bool pow2 = (lanes & (lanes - 1)) == 0 && (slots & (slots - 1)) == 0;
  const bool plan = slots >= 1 && slots <= kMaxSlots &&
                    (lanes == 1 || (lanes > 1 && lanes <= kMaxLanes && pow2));
  if (T <= 0 || N < 0 || W <= 0 || W > queue_booking_max_workers() ||
      tile <= 0 || tile > queue_booking_max_tile() || !plan ||
      lanes * slots < W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = N % 4 == 0 && aligned16(ready) && aligned16(service) &&
                   aligned16(fin) && aligned16(start) && aligned16(worker);
#define QB_ARGS vec, ready, service, wf0, fin, start, worker, wf_out, T, N, \
                W, stream
  if (lanes == 1) {
    switch (slots) {
      case 1: launch<1, 1>(QB_ARGS); break;
      case 2: launch<1, 2>(QB_ARGS); break;
      case 3: launch<1, 3>(QB_ARGS); break;
      case 4: launch<1, 4>(QB_ARGS); break;
      case 5: launch<1, 5>(QB_ARGS); break;
      case 6: launch<1, 6>(QB_ARGS); break;
      case 7: launch<1, 7>(QB_ARGS); break;
      case 8: launch<1, 8>(QB_ARGS); break;
      case 9: launch<1, 9>(QB_ARGS); break;
      case 10: launch<1, 10>(QB_ARGS); break;
      case 11: launch<1, 11>(QB_ARGS); break;
      case 12: launch<1, 12>(QB_ARGS); break;
      case 13: launch<1, 13>(QB_ARGS); break;
      case 14: launch<1, 14>(QB_ARGS); break;
      case 15: launch<1, 15>(QB_ARGS); break;
      default: launch<1, 16>(QB_ARGS); break;
    }
  } else {
#define QB_LANES(L)                              \
  switch (slots) {                               \
    case 1: launch<L, 1>(QB_ARGS); break;        \
    case 2: launch<L, 2>(QB_ARGS); break;        \
    case 4: launch<L, 4>(QB_ARGS); break;        \
    case 8: launch<L, 8>(QB_ARGS); break;        \
    default: launch<L, 16>(QB_ARGS); break;      \
  }
    switch (lanes) {
      case 2: QB_LANES(2); break;
      case 4: QB_LANES(4); break;
      case 8: QB_LANES(8); break;
      default: QB_LANES(16); break;
    }
#undef QB_LANES
  }
#undef QB_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
