// Fused pull-based scheduling bursts (Algorithm 1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package's kernels/sched_step.py:
// sched_events (_sched_events_kernel) and sched_step (_sched_kernel), which is
// the ARRIVAL-only instance here (template flag kArrivalOnly).
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
// no-ops with assign -1 rather than reads out of bounds.  Precondition:
// idle and conns non-negative, conns below 2**30.  idle/conns are read and
// idle'/conns' written out of place.  The three event columns may be strided
// views of one (R, 3) tensor: they share one element stride.
//
// What bounds it: a serial chain of latency.  Every ARRIVAL reads the conns
// and idle state that the events before it wrote, so no two ARRIVALs
// overlap; bytes (well under a megabyte a burst) and operations (a few per
// worker per event) bound nothing.  sched_chain_probe_launch measures on the
// card the least time of one dependent step of each kind: for an ARRIVAL
// (t_arr), one warp reads a shared-memory word at an address that depends
// on the previous step, takes one __reduce_min_sync, and lane 0 writes the
// result to shared memory for the next step to read; for a FINISH or EVICT
// (t_step), one thread's dependent shared-memory load -> add -> store.
// FINISH and EVICT events between two ARRIVALs do not depend on each other
// (updates of one cell reduce to a segmented scan that lanes could apply in
// parallel), so a maximal run of them costs at least one dependent step, not
// one per event.  Any design that keeps the state in shared memory and
// reads what the previous events wrote pays at least n_arrival * t_arr +
// n_runs * t_step for a burst, n_runs the runs of FINISH/EVICT that an
// ARRIVAL follows.  With one warp on the chain, each dependent instruction
// also waits its full latency and a warp-wide integer instruction takes two
// issue cycles, so the loop below keeps its per-event instruction count and
// dependency depth low.
//
// On-chip path (sched_onchip), for W <= 2048 and a state that fits in the
// 227 KB of shared memory: keys 4 * Wp + bits 256 * F + counts F * Wp bytes,
// Wp = 32 * CHUNK, so F <= 116 at W = 1600 and F <= 96 at W = 2048.  CHUNK
// (slots a lane) is the least of 16, 32, 52 and 64 that holds
// 4 * ceil(W / 128): 52 is W = 1600's own, and a narrower state runs at the
// next instantiation up, its pad workers keyed ~0u so that they never win.
// - One warp runs the event loop; the other warps only load the state
//   (coalesced 16-byte loads) and write it back at the end.  Workers are
//   dealt to lanes in groups of four: worker w belongs to lane (w / 4) % 32
//   as its slot (w / 128) * 4 + w % 4, CHUNK slots a lane.  During an ARRIVAL every lane reads only its own state words (its
//   workers' keys, its occupancy bits and counts), values cross lanes only
//   through the *_sync intrinsics, and the lane that owns a cell is the
//   only one to read or write it in the loop, so the loop needs no barrier
//   and no per-event __syncwarp.  (Were a word written by one lane and read
//   by another, a __syncwarp would have to order the two: under independent
//   thread scheduling a lane's shared-memory write is not ordered before
//   another lane's read without it.  That is the fault that passes at small
//   W.)
// - conns as one 32-bit key per worker, (conns << 11) | w, at keys[w]: lane
//   l's uint4 g holds workers 128 g + 4 l .. + 3, conflict-free.  Keys are
//   distinct and order by (conns, w), so their minimum is the
//   least-connections worker with the lowest index: one __reduce_min_sync
//   gives the winner and the tie rule of sched_events_ref, and the lane
//   whose own minimum it is owns the winner.  The prologue checks that
//   max(conns) + R <= 2**20 - 2, so every key stays below 2**31 for the
//   whole burst (bit 31 masks workers out of the pulled set); if not, this
//   kernel runs the block-wide path below instead.
// - PQ_f occupancy as one bit per (f, slot): one uint64 per (f, lane).  An
//   ARRIVAL reads its lane's word, __any_sync decides pull or fallback, and
//   each lane takes the minimum key over its pulled slots, or over all its
//   slots when no lane has any: one warp reduction per event.  Lane minima
//   are three-way trees (VIMNMX3).
// - idle counts as a saturating byte per (f, w) ([F][Wp]).  A byte of 255
//   means "255 or more": the exact count of such a cell lives in idle' in
//   device memory and is read and written there (only saturated cells touch
//   device memory inside the loop).  A count that falls below 255 goes back
//   on chip, so every count stays exact whatever the data.
// - Events are loaded 32 at a time, one per lane, a tile ahead of their
//   use; each lane turns its event into a descriptor (class, owner lane and
//   the shared-memory slots it touches; describe_event) and the tile is
//   staged in shared memory (two buffers, one __syncwarp per tile), whence
//   each event is read with a broadcast load a step ahead of its use, two
//   events a turn.  An ARRIVAL's updates are stored by every lane, the
//   owner's to the cell and the others' to a scratch word of their own, so
//   that the code has no divergent branch; the device-memory path of a
//   saturated cell is marked unlikely.
//   assign/warm are kept by the event's lane and stored as one coalesced
//   32-wide tile.  The chain holds no device-memory load (saturated cells
//   aside).
//
// Large-state path (sched_large, and the fallback above): one CTA, W spread
// over the threads, (conns, index) packed into one 64-bit key reduced with
// warp shuffles and then across warps (two barriers per ARRIVAL), conns in
// shared memory when W * 4 <= 200 KB (W <= 51,200) else in device memory,
// idle updated in device memory.  Taken for W > 2048 or a state too large
// for shared memory (chosen by shape in sched_events_launch), and when the
// prologue finds conns too large for the keys (chosen by the data, in the
// kernel); never because a launch or a build failed.  Its idle' (and conns'
// when in device memory) is first copied from idle (conns) with
// cudaMemcpyAsync.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kOnchipThreads = 512;
constexpr int kMaxSmem = 232448 - 2048;       // 227 KB a block can use, less static smem
constexpr int kSmemConnsBytes = 200 * 1024;   // large path: conns on chip up to here
constexpr int kIdxBits = 11;                  // W <= 2048 on the on-chip path
constexpr unsigned kConnsLimit = (1u << (31 - kIdxBits)) - 2;  // max conns on chip
constexpr unsigned kSat = 255;                // saturated idle byte

// ------------------------------------------------------------ large-state path
constexpr unsigned long long kNone = ~0ull;

// Signed conns order mapped to unsigned order in the high word, worker index
// in the low word: the minimum key is the least-connections, lowest-index one.
__device__ __forceinline__ unsigned long long key64(int c, int w) {
  return ((unsigned long long)((unsigned)c ^ 0x80000000u) << 32) | (unsigned)w;
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long warp_min64(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = kmin(v, __shfl_down_sync(FULL, v, off));
  return v;
}

// The whole burst with the block's threads over W; idle (device memory) and
// conns (shared or device memory) already hold the starting state.
template <bool kArrivalOnly>
__device__ void burst_blockwide(const int* __restrict__ kinds, const int* __restrict__ funcs,
                                const int* __restrict__ workers, long long st, int* idle,
                                int* conns, int* __restrict__ assign, int* __restrict__ warm,
                                int R, int F, int W) {
  __shared__ unsigned long long red_pull[32];
  __shared__ unsigned long long red_fb[32];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthr + 31) >> 5;
  for (int i = 0; i < R; ++i) {
    const int kind = kArrivalOnly ? 0 : kinds[i * st];
    const int f = funcs[i * st];
    if (kind == 0 && f >= 0 && f < F) {
      __syncthreads();  // the previous event's updates are visible
      const int* row = idle + (size_t)f * W;
      unsigned long long bp = kNone, bf = kNone;
      for (int w = tid; w < W; w += nthr) {
        const unsigned long long k = key64(conns[w], w);
        bf = kmin(bf, k);
        if (row[w] > 0) bp = kmin(bp, k);
      }
      bp = warp_min64(bp);
      bf = warp_min64(bf);
      if (lane == 0) {
        red_pull[warp] = bp;
        red_fb[warp] = bf;
      }
      __syncthreads();
      if (warp == 0) {
        bp = lane < nwarps ? red_pull[lane] : kNone;
        bf = lane < nwarps ? red_fb[lane] : kNone;
        bp = warp_min64(bp);
        bf = warp_min64(bf);
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
      int w = kArrivalOnly ? -1 : workers[i * st];
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
}

template <bool kArrivalOnly>
__global__ void sched_large(const int* __restrict__ kinds, const int* __restrict__ funcs,
                            const int* __restrict__ workers, long long st,
                            const int* __restrict__ conns_in, int* idle_out, int* conns_out,
                            int* __restrict__ assign, int* __restrict__ warm, int R, int F, int W,
                            int conns_in_smem) {
  extern __shared__ uint4 smem_large[];
  int* conns = conns_in_smem ? reinterpret_cast<int*>(smem_large) : conns_out;
  if (conns_in_smem) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) conns[w] = conns_in[w];
  }
  __syncthreads();  // a FINISH first in the burst reads conns by thread 0
  burst_blockwide<kArrivalOnly>(kinds, funcs, workers, st, idle_out, conns, assign, warm, R, F, W);
  if (conns_in_smem) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) conns_out[w] = conns[w];
  }
}

// --------------------------------------------------------------- on-chip path
// The on-chip layout deals workers to lanes in groups of four: worker w
// belongs to lane (w / 4) % 32 as its slot k = (w / 128) * 4 + w % 4.  So
// keys[w] sits where lane l's uint4 g = w / 128 reads it (conflict-free),
// and a lane's slots ascend with the worker index.
__device__ __forceinline__ int lane_of(int w) { return (w >> 2) & 31; }
__device__ __forceinline__ int slot_of(int w) { return (w >> 7) * 4 + (w & 3); }

// Minimum of p[O .. O+N) as a balanced three-way tree (VIMNMX3 on sm_90),
// so a single warp waits on a few levels rather than a chain of N.
template <int N, int O = 0, int M>
__device__ __forceinline__ unsigned tree_min(const unsigned (&p)[M]) {
  if constexpr (N == 1) {
    return p[O];
  } else if constexpr (N == 2) {
    return min(p[O], p[O + 1]);
  } else if constexpr (N == 3) {
    return min(min(p[O], p[O + 1]), p[O + 2]);
  } else {
    constexpr int A = N / 3, B = (N - A) / 2;
    return min(min(tree_min<A, O>(p), tree_min<B, O + A>(p)), tree_min<N - A - B, O + A + B>(p));
  }
}

// Minimum of this lane's keys (the fallback); pad slots hold ~0u and never win.
template <int CHUNK>
__device__ __forceinline__ unsigned lane_min_all(const uint4 (&q)[CHUNK / 4]) {
  unsigned v[CHUNK];
#pragma unroll
  for (int g = 0; g < CHUNK / 4; ++g)
    v[4 * g] = q[g].x, v[4 * g + 1] = q[g].y, v[4 * g + 2] = q[g].z, v[4 * g + 3] = q[g].w;
  return tree_min<CHUNK>(v);
}

// Minimum of this lane's keys whose occupancy bit is set in b.  A worker
// without the bit gets bit 31 of its key set: live keys are below 2**31
// (conns <= 2**20 - 2), so any live worker beats it, and a lane with none
// returns a value that loses to every lane that has one.
template <int CHUNK>
__device__ __forceinline__ unsigned lane_min_pull(const uint4 (&q)[CHUNK / 4],
                                                  unsigned long long b) {
  const unsigned nlo = ~(unsigned)b, nhi = ~(unsigned)(b >> 32);
  unsigned v[CHUNK];
#pragma unroll
  for (int g = 0; g < CHUNK / 4; ++g) {
    const unsigned n = g < 8 ? nlo : nhi;
    const int s = (4 * g) & 31;  // bit of slot 4g in its word
    v[4 * g] = q[g].x | ((n << (31 - s)) & 0x80000000u);
    v[4 * g + 1] = q[g].y | ((n << (30 - s)) & 0x80000000u);
    v[4 * g + 2] = q[g].z | ((n << (29 - s)) & 0x80000000u);
    v[4 * g + 3] = q[g].w | ((n << (28 - s)) & 0x80000000u);
  }
  return tree_min<CHUNK>(v);
}

// A saturated cell (byte 255): its exact count lives in idle'.  delta = +1
// (FINISH) or -1 (pulled ARRIVAL, EVICT; the count is >= 255 > 0).  A count
// that falls below 255 goes back on chip.
__device__ __forceinline__ void cell_exact(unsigned char* cnt, int* exact, int delta) {
  const int v = *exact + delta;
  if (v < (int)kSat) *cnt = (unsigned char)v;
  else *exact = v;
}

// An event as two words for the on-chip loop, built by the event's lane
// when its tile is staged, so the serial loop decodes nothing:
//   x: class (ARRIVAL, FINISH, EVICT, or no-op for a padding kind or an
//      out-of-range func or worker) in bits 30-31; for FINISH/EVICT the
//      owner lane in bits 24-29 (32 for a no-op: no lane), the worker's bit
//      in its occupancy half-word in bits 19-23, and the cell's count byte
//      f * Wp + w in bits 0-18; for ARRIVAL the count row f * Wp.
//   y: ARRIVAL: the occupancy row f * 32; FINISH/EVICT: the occupancy
//      half-word (f * 32 + owner) * 2 + slot / 32 in bits 16-31 and the
//      worker in bits 0-15.
constexpr unsigned kArrival = 0, kFinish = 1, kEvict = 2, kNoop = 3;
constexpr unsigned kCellBits = 19;  // F * 32 * CHUNK < 2**19 on this path

template <bool kArrivalOnly, int CHUNK>
__device__ __forceinline__ uint2 describe_event(int kind, int f, int w, int F, int W) {
  constexpr int Wp = 32 * CHUNK;
  if (kArrivalOnly) kind = 0;
  w = w < 0 ? 0 : w;
  const bool ok = f >= 0 && f < F && (kind == 0 || ((kind == 1 || kind == 2) && w < W));
  if (!ok) return make_uint2(kNoop << 30 | 32u << 24, 0);
  if (kind == 0) return make_uint2((unsigned)(f * Wp), (unsigned)(f * 32));
  const int o = lane_of(w), k = slot_of(w);
  return make_uint2((unsigned)kind << 30 | (unsigned)o << 24 | (unsigned)(k & 31) << kCellBits |
                        (unsigned)(f * Wp + w),
                    (unsigned)((f * 32 + o) * 2 + (k >> 5)) << 16 | (unsigned)w);
}

template <bool kArrivalOnly, int CHUNK>
__global__ void __launch_bounds__(kOnchipThreads, 1)
    sched_onchip(const int* __restrict__ kinds, const int* __restrict__ funcs,
                 const int* __restrict__ workers, long long st, const int* __restrict__ idle_in,
                 const int* __restrict__ conns_in, int* idle_out, int* __restrict__ conns_out,
                 int* __restrict__ assign, int* __restrict__ warm, int R, int F, int W) {
  constexpr int Wp = 32 * CHUNK;  // padded row of the count bytes
  extern __shared__ uint4 smem[];
  unsigned* keys = reinterpret_cast<unsigned*>(smem);                               // [Wp]
  unsigned long long* bits = reinterpret_cast<unsigned long long*>(keys + Wp);      // [F][32]
  unsigned char* counts = reinterpret_cast<unsigned char*>(bits + (size_t)F * 32);  // [F][Wp]
  __shared__ unsigned s_max[32];
  __shared__ uint2 ev_s[2][32];  // the event tiles, as descriptors
  __shared__ unsigned scratch_s[32][2];  // per lane: an ARRIVAL's stores by a non-owner
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Prologue 1: does every conns fit the key's 20-bit field for the whole burst?
  unsigned mx = 0;
  for (int w = tid; w < W; w += nthr) mx = max(mx, (unsigned)conns_in[w]);  // < 0 -> huge
  mx = __reduce_max_sync(FULL, mx);
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  mx = 0;
  for (int i = 0; i < nthr / 32; ++i) mx = max(mx, s_max[i]);
  if ((unsigned long long)mx + (unsigned)R > kConnsLimit) {
    // conns too large for the on-chip keys: the block-wide path, conns in
    // the keys' shared memory (Wp >= W words)
    int* conns = reinterpret_cast<int*>(keys);
    for (int w = tid; w < W; w += nthr) conns[w] = conns_in[w];
    for (size_t j = tid; j < (size_t)F * W; j += nthr) idle_out[j] = idle_in[j];
    __syncthreads();
    burst_blockwide<kArrivalOnly>(kinds, funcs, workers, st, idle_out, conns, assign, warm, R, F,
                                  W);
    for (int w = tid; w < W; w += nthr) conns_out[w] = conns[w];
    return;
  }

  // Prologue 2: keys, zeroed count bytes, then the counts (saturated cells'
  // exact values to idle'), then the occupancy bits.
  for (int w = tid; w < Wp; w += nthr)
    keys[w] = w < W ? ((unsigned)conns_in[w] << kIdxBits) | (unsigned)w : ~0u;
  uint4* c4 = reinterpret_cast<uint4*>(counts);
  for (int j = tid; j < F * Wp / 16; j += nthr) c4[j] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const bool vec = (W & 3) == 0 && (reinterpret_cast<size_t>(idle_in) & 15) == 0 &&
                   (reinterpret_cast<size_t>(idle_out) & 15) == 0;
  if (vec) {
    const int4* in4 = reinterpret_cast<const int4*>(idle_in);
    const int n4 = F * W / 4, W4 = W / 4;
    constexpr int kBatch = 8;  // 16-byte loads in flight per thread
    for (int j0 = tid; j0 < n4; j0 += kBatch * nthr) {
      int4 vs[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        vs[u] = j0 + u * nthr < n4 ? in4[j0 + u * nthr] : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * nthr;
        if (j >= n4) break;
        const int4 v = vs[u];
        const int f = j / W4, w = (j - f * W4) * 4;
        const unsigned b = min((unsigned)v.x, kSat) | min((unsigned)v.y, kSat) << 8 |
                           min((unsigned)v.z, kSat) << 16 | min((unsigned)v.w, kSat) << 24;
        *reinterpret_cast<unsigned*>(counts + (size_t)f * Wp + w) = b;
        if (b & 0x80808080u) {  // some byte >= 128: write the saturated ones' exact values
          int* out = idle_out + (size_t)j * 4;
          if ((unsigned)v.x >= kSat) out[0] = v.x;
          if ((unsigned)v.y >= kSat) out[1] = v.y;
          if ((unsigned)v.z >= kSat) out[2] = v.z;
          if ((unsigned)v.w >= kSat) out[3] = v.w;
        }
      }
    }
  } else {
    for (int j = tid; j < F * W; j += nthr) {
      const int v = idle_in[j];
      const int f = j / W, w = j - f * W;
      counts[(size_t)f * Wp + w] = (unsigned char)min((unsigned)v, kSat);
      if ((unsigned)v >= kSat) idle_out[j] = v;
    }
  }
  __syncthreads();
  for (int p = tid; p < F * 32; p += nthr) {
    const int f = p >> 5, l = p & 31;
    const unsigned char* row = counts + (size_t)f * Wp + l * 4;
    unsigned long long m = 0;
#pragma unroll
    for (int g = 0; g < CHUNK / 4; ++g) {
      const unsigned x = *reinterpret_cast<const unsigned*>(row + 128 * g);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((x >> (8 * e)) & 0xff) m |= 1ull << (4 * g + e);
    }
    bits[p] = m;
  }
  __syncthreads();

  // The event loop: warp 0 alone, every state word private to one lane.
  if (warp == 0) {
    const uint4* keys4 = reinterpret_cast<const uint4*>(keys);
    unsigned* bits32 = reinterpret_cast<unsigned*>(bits);
    unsigned* scratch = scratch_s[lane];
    unsigned char* scratch_c = reinterpret_cast<unsigned char*>(scratch + 1);
    int nk = 0, nf = 0, nw = 0;  // the next tile's event of this lane, raw
    if (lane < R) {
      if (!kArrivalOnly) nk = kinds[lane * st], nw = workers[lane * st];
      nf = funcs[lane * st];
    }
    for (int base = 0, buf = 0; base < R; base += 32, buf ^= 1) {
      // Stage this tile's events in shared memory as descriptors, and issue
      // the next tile's loads.  The __syncwarp orders the descriptors before
      // every lane's reads; two buffers let the next tile's writes wait for
      // no one.
      ev_s[buf][lane] = describe_event<kArrivalOnly, CHUNK>(nk, nf, nw, F, W);
      __syncwarp();
      const int nxt = base + 32 + lane;
      if (nxt < R) {
        if (!kArrivalOnly) nk = kinds[nxt * st], nw = workers[nxt * st];
        nf = funcs[nxt * st];
      }
      int my_assign = -1, my_warm = 0;
      // One event.  ARRIVAL: each lane reads only its own words and the
      // owner of the winner writes; FINISH/EVICT: the lane that owns the
      // cell reads and writes it.
      auto step = [&](uint2 d, int j) {
        const unsigned cls = d.x >> 30;
        if (cls == kArrival) {
          uint4 q[CHUNK / 4];
#pragma unroll
          for (int g = 0; g < CHUNK / 4; ++g) q[g] = keys4[g * 32 + lane];
          const unsigned long long b = bits[d.y + lane];
          const bool pull = __any_sync(FULL, b != 0);
          const unsigned mine = pull ? lane_min_pull<CHUNK>(q, b) : lane_min_all<CHUNK>(q);
          // this lane's candidate cell's count, loaded before the reduction
          // decides whether the lane owns the winner
          const int wl = (int)(mine & ((1u << kIdxBits) - 1));
          const int k = slot_of(wl);
          unsigned char* cnt = counts + (d.x & ((1u << kCellBits) - 1)) + wl;
          const unsigned c = pull && mine < 0x80000000u ? *cnt : 0;
          const unsigned key = __reduce_min_sync(FULL, mine);
          const bool own = mine == key;  // keys are distinct: one lane owns the winner
          const bool dec = own && pull;
          // stores go to the cell for the owner and to the lane's scratch
          // word for the others: straight-line code, no divergent branch
          const unsigned h = (unsigned)(k < 32 ? b : b >> 32);
          const unsigned bit = 1u << (k & 31);
          if (own) keys[wl] = key + (1u << kIdxBits);
          *(dec ? cnt : scratch_c) = (unsigned char)(c == kSat ? c : c - 1);
          *(dec ? bits32 + (d.y + lane) * 2 + (k >> 5) : scratch) = c == 1 ? h & ~bit : h;
          if (__builtin_expect(dec && c == kSat, 0))
            cell_exact(cnt, idle_out + (size_t)(d.y >> 5) * W + wl, -1);
          if (lane == j) my_assign = (int)(key & ((1u << kIdxBits) - 1)), my_warm = pull;
        } else if (!kArrivalOnly) {  // FINISH, EVICT or no-op
          const bool fin = cls == kFinish;
          const bool own = (int)((d.x >> 24) & 63) == lane;
          const unsigned cell = d.x & ((1u << kCellBits) - 1);
          unsigned char* cnt = counts + cell;
          unsigned* hw = bits32 + (d.y >> 16);
          unsigned* kp = keys + (d.y & 0xffff);
          const unsigned bit = 1u << ((d.x >> kCellBits) & 31);
          unsigned c = 0, h = 0, kv = 0;
          if (own) c = *cnt, h = *hw, kv = *kp;
          const bool up = own && c != kSat;  // the count is on chip
          if (up) {
            *cnt = (unsigned char)(fin ? c + 1 : c - (c > 0));
            *hw = fin ? h | bit : (c == 1 ? h & ~bit : h);
          }
          if (own && fin && kv >> kIdxBits) *kp = kv - (1u << kIdxBits);
          if (__builtin_expect((up && fin && c == kSat - 1) || (own && c == kSat), 0)) {
            const int f = (int)(cell / Wp);  // device memory, rare
            int* exact = idle_out + (size_t)f * W + (cell - f * Wp);
            if (c == kSat) cell_exact(cnt, exact, fin ? 1 : -1);
            else *exact = (int)kSat;  // the count saturates: idle' holds it from now on
          }
        }
      };
      // two events per turn, each one's descriptor loaded a step ahead
      const int n = min(32, R - base);
      uint2 d0 = ev_s[buf][0];
      for (int j = 0; j < n; j += 2) {
        const uint2 d1 = ev_s[buf][j + 1 < n ? j + 1 : j];
        step(d0, j);
        d0 = ev_s[buf][j + 2 < n ? j + 2 : j];
        if (j + 1 < n) step(d1, j + 1);
      }
      if (base + lane < R) {
        assign[base + lane] = my_assign;
        warm[base + lane] = my_warm;
      }
    }
  }
  __syncthreads();

  // Epilogue: conns' and every unsaturated count to idle'.
  for (int w = tid; w < W; w += nthr) conns_out[w] = keys[w] >> kIdxBits;
  if (vec) {
    int4* out4 = reinterpret_cast<int4*>(idle_out);
    const int n4 = F * W / 4, W4 = W / 4;
#pragma unroll 4
    for (int j = tid; j < n4; j += nthr) {
      const int f = j / W4, w = (j - f * W4) * 4;
      const unsigned b = *reinterpret_cast<const unsigned*>(counts + (size_t)f * Wp + w);
      const int4 v = make_int4(b & 0xff, (b >> 8) & 0xff, (b >> 16) & 0xff, b >> 24);
      if (v.x != (int)kSat && v.y != (int)kSat && v.z != (int)kSat && v.w != (int)kSat) {
        out4[j] = v;
      } else {
        int* out = idle_out + (size_t)j * 4;
        if (v.x != (int)kSat) out[0] = v.x;
        if (v.y != (int)kSat) out[1] = v.y;
        if (v.z != (int)kSat) out[2] = v.z;
        if (v.w != (int)kSat) out[3] = v.w;
      }
    }
  } else {
    for (int j = tid; j < F * W; j += nthr) {
      const int f = j / W, w = j - f * W;
      const unsigned c = counts[(size_t)f * Wp + w];
      if (c != kSat) idle_out[j] = (int)c;
    }
  }
}

template <bool A, int CHUNK>
cudaError_t launch_onchip(const int* kinds, const int* funcs, const int* workers, long long st,
                          const int* idle, const int* conns, int* idle_out, int* conns_out,
                          int* assign, int* warm, int R, int F, int W, size_t smem,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sched_onchip<A, CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sched_onchip<A, CHUNK><<<1, kOnchipThreads, smem, stream>>>(
      kinds, funcs, workers, st, idle, conns, idle_out, conns_out, assign, warm, R, F, W);
  return cudaGetLastError();
}

template <bool A>
cudaError_t launch(const int* kinds, const int* funcs, const int* workers, long long st,
                   const int* idle, const int* conns, int* idle_out, int* conns_out, int* assign,
                   int* warm, int R, int F, int W, cudaStream_t stream) {
  const int need = (W + 127) / 128 * 4;  // slots per lane
  const int chunk = need <= 16 ? 16 : need <= 32 ? 32 : need <= 52 ? 52 : 64;
  const size_t smem = (size_t)chunk * 32 * (4 + (size_t)F) + (size_t)F * 32 * 8;
  if (need <= 64 && smem <= (size_t)kMaxSmem) {
#define SCHED_CHUNK(C)                                                                      \
  case C:                                                                                   \
    return launch_onchip<A, C>(kinds, funcs, workers, st, idle, conns, idle_out, conns_out, \
                               assign, warm, R, F, W, smem, stream);
    switch (chunk) { SCHED_CHUNK(16) SCHED_CHUNK(32) SCHED_CHUNK(52) SCHED_CHUNK(64) }
#undef SCHED_CHUNK
  }
  const size_t idle_bytes = (size_t)F * W * sizeof(int);
  cudaError_t err = cudaMemcpyAsync(idle_out, idle, idle_bytes, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  const size_t conns_bytes = (size_t)W * sizeof(int);
  const int in_smem = conns_bytes <= (size_t)kSmemConnsBytes;
  if (!in_smem) {
    err = cudaMemcpyAsync(conns_out, conns, conns_bytes, cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
  }
  int threads = ((W + 7) / 8 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem_l = in_smem ? conns_bytes : 0;
  if (smem_l > 48 * 1024) {
    err = cudaFuncSetAttribute(sched_large<A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_l);
    if (err != cudaSuccess) return err;
  }
  sched_large<A><<<1, threads, smem_l, stream>>>(kinds, funcs, workers, st, conns, idle_out,
                                                 conns_out, assign, warm, R, F, W, in_smem);
  return cudaGetLastError();
}

// ------------------------------------------------------------- latency probe
constexpr int kProbeWords = 1024;

// mode 0: the ARRIVAL step (one warp: a dependent shared-memory read per
// lane, __reduce_min_sync, lane 0 publishes to shared memory); mode 1: the
// FINISH/EVICT step (one thread: dependent shared-memory load -> add ->
// store).  init: kProbeWords values in [0, kProbeWords); out[0] keeps the
// chain's result alive.
__global__ void sched_chain_probe(const int* __restrict__ init, int* out, int n, int mode) {
  __shared__ unsigned buf[kProbeWords];
  __shared__ unsigned cell;
  const int lane = threadIdx.x;
  for (int i = lane; i < kProbeWords; i += 32) buf[i] = (unsigned)init[i];
  __syncwarp();
  unsigned r = 0;
  if (mode == 0) {
    for (int i = 0; i < n; ++i) {
      const unsigned v = buf[(r + lane) & (kProbeWords - 1)];
      const unsigned m = __reduce_min_sync(FULL, v);
      if (lane == 0) cell = m;
      __syncwarp();
      r = cell;
      __syncwarp();
    }
  } else if (lane == 0) {
    volatile unsigned* b = buf;
    for (int i = 0; i < n; ++i) {
      const unsigned v = b[r];
      b[r] = v + 1;
      r = v & (kProbeWords - 1);
    }
  }
  if (lane == 0) out[0] = (int)r;
}

}  // namespace

// idle (F, W) and conns (W,) are read; idle_out and conns_out get the state
// after the burst.  kinds, funcs and workers are read at i * stride; kinds
// and workers are ignored (may be null) when arrival_only is set.
extern "C" int sched_events_launch(const int* kinds, const int* funcs, const int* workers,
                                   long long stride, const int* idle, const int* conns,
                                   int* idle_out, int* conns_out, int* assign, int* warm, int R,
                                   int F, int W, int arrival_only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      arrival_only ? launch<true>(kinds, funcs, workers, stride, idle, conns, idle_out, conns_out,
                                  assign, warm, R, F, W, s)
                   : launch<false>(kinds, funcs, workers, stride, idle, conns, idle_out,
                                   conns_out, assign, warm, R, F, W, s);
  return (int)err;
}

// One launch of the latency probe: n dependent steps of the ARRIVAL chain
// (mode 0) or the FINISH/EVICT chain (mode 1).  init holds 1024 int32 values
// in [0, 1024); out one int32.
extern "C" int sched_chain_probe_launch(const int* init, int* out, int n, int mode, void* stream) {
  sched_chain_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(init, out, n, mode);
  return (int)cudaGetLastError();
}
