// Fused pull-based scheduling bursts (Algorithm 1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package's kernels/sched_step.py:
// sched_events (_sched_events_kernel) and sched_step (_sched_kernel), which is
// the ARRIVAL-only specialisation here (template flag kArrivalOnly).
//
// Per event, in order:
//   ARRIVAL(f): the least-connections worker among those with idle[f,w] > 0
//               (lowest index on ties); if none, the least-connections worker
//               overall.  Dequeue one idle instance if pulled, open a connection.
//   FINISH(f,w): idle[f,w] += 1, conns[w] = max(conns[w] - 1, 0).
//   EVICT(f,w):  idle[f,w] -= 1 while it is above 0.
//   kind >= 3:   no-op.
// Bitwise equal to kernels/ref.py::sched_events_ref.  Workers of ARRIVAL
// events are -1 and are clamped to 0 before any use (as sched_step.py:113).
// Events whose func (or, for FINISH/EVICT, worker) is out of range are
// skipped as no-ops rather than read out of bounds.
//
// What bounds it on this card: neither bytes nor operations.  A burst moves
// well under a megabyte and does a few comparisons per worker per event, but
// each ARRIVAL depends on the state left by the one before, so the burst is
// a serial chain and its time is the latency of one event (a pass over the
// idle row, a block-wide argmin, two barriers) times the event count.
// Design: one CTA per burst; the W workers are spread over the threads, each
// thread looping over ceil(W / blockDim) of them, so W is not capped at 1024.
// (conns, index) pairs are packed into one 64-bit key whose minimum is the
// least-connections, lowest-index worker, reduced with warp shuffles and then
// across warps in shared memory.  conns stays in shared memory for the whole
// burst when it fits (W * 4 bytes <= kSmemConnsBytes, i.e. W <= 51,200);
// above that it stays in global memory.  idle is updated in global memory,
// one cell per event.  The launch uses few threads for small W (8 workers a
// thread) so that the two barriers per ARRIVAL stay cheap.

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kNone = ~0ull;
constexpr int kSmemConnsBytes = 200 * 1024;

// Signed conns order mapped to unsigned order in the high word, worker index
// in the low word: the minimum key is the least-connections, lowest-index one.
__device__ __forceinline__ unsigned long long key_of(int c, int w) {
  return ((unsigned long long)((unsigned)c ^ 0x80000000u) << 32) | (unsigned)w;
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = kmin(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <bool kArrivalOnly>
__global__ void sched_events_kernel(const int* __restrict__ kinds, const int* __restrict__ funcs,
                                    const int* __restrict__ workers, int* idle, int* conns_g,
                                    int* __restrict__ assign, int* __restrict__ warm, int R,
                                    int F, int W, int conns_in_smem) {
  extern __shared__ int smem_conns[];
  __shared__ unsigned long long red_pull[32];
  __shared__ unsigned long long red_fb[32];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthr + 31) >> 5;
  int* conns = conns_in_smem ? smem_conns : conns_g;
  if (conns_in_smem)
    for (int w = tid; w < W; w += nthr) conns[w] = conns_g[w];

  for (int i = 0; i < R; ++i) {
    const int kind = kArrivalOnly ? 0 : kinds[i];
    const int f = funcs[i];
    if (kind == 0 && f >= 0 && f < F) {
      __syncthreads();  // the previous event's updates are visible
      const int* row = idle + (size_t)f * W;
      unsigned long long bp = kNone, bf = kNone;
      for (int w = tid; w < W; w += nthr) {
        const unsigned long long k = key_of(conns[w], w);
        bf = kmin(bf, k);
        if (row[w] > 0) bp = kmin(bp, k);
      }
      bp = warp_min(bp);
      bf = warp_min(bf);
      if (lane == 0) {
        red_pull[warp] = bp;
        red_fb[warp] = bf;
      }
      __syncthreads();
      if (warp == 0) {
        bp = lane < nwarps ? red_pull[lane] : kNone;
        bf = lane < nwarps ? red_fb[lane] : kNone;
        bp = warp_min(bp);
        bf = warp_min(bf);
        if (lane == 0) {
          const bool has_idle = bp != kNone;
          const int w = (int)((has_idle ? bp : bf) & 0xffffffffull);
          if (has_idle) idle[(size_t)f * W + w] -= 1;
          conns[w] += 1;
          assign[i] = w;
          warm[i] = has_idle ? 1 : 0;
        }
      }
    } else if (tid == 0) {
      int w = kArrivalOnly ? -1 : workers[i];
      w = w < 0 ? 0 : w;
      if (f >= 0 && f < F && w < W) {
        int* cell = idle + (size_t)f * W + w;
        if (kind == 1) {
          *cell += 1;
          const int c = conns[w] - 1;
          conns[w] = c < 0 ? 0 : c;
        } else if (kind == 2 && *cell > 0) {
          *cell -= 1;
        }
      }
      assign[i] = -1;
      warm[i] = 0;
    }
  }
  __syncthreads();
  if (conns_in_smem)
    for (int w = tid; w < W; w += nthr) conns_g[w] = conns[w];
}

template <bool kArrivalOnly>
cudaError_t launch(const int* kinds, const int* funcs, const int* workers, int* idle, int* conns,
                   int* assign, int* warm, int R, int F, int W, cudaStream_t stream) {
  int threads = ((W + 7) / 8 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t conns_bytes = (size_t)W * sizeof(int);
  const int in_smem = conns_bytes <= (size_t)kSmemConnsBytes;
  const size_t smem = in_smem ? conns_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sched_events_kernel<kArrivalOnly>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sched_events_kernel<kArrivalOnly><<<1, threads, smem, stream>>>(
      kinds, funcs, workers, idle, conns, assign, warm, R, F, W, in_smem);
  return cudaGetLastError();
}

}  // namespace

// idle (F, W) and conns (W,) are updated in place: the caller passes copies.
// kinds and workers are ignored (may be null) when arrival_only is set.
extern "C" int sched_events_launch(const int* kinds, const int* funcs, const int* workers,
                                   int* idle, int* conns, int* assign, int* warm, int R, int F,
                                   int W, int arrival_only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      arrival_only ? launch<true>(kinds, funcs, workers, idle, conns, assign, warm, R, F, W, s)
                   : launch<false>(kinds, funcs, workers, idle, conns, assign, warm, R, F, W, s);
  return (int)err;
}
