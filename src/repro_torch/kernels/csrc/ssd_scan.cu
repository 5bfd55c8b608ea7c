// Mamba2 SSD chunked scan for Hopper (sm_90a), in its chunk-parallel form.
//
// Replaces the Pallas TPU kernel of the JAX package's kernels/ssd_scan.py
// (ssd_scan, body _ssd_kernel).  For each chunk of Q positions, with
// cs = cumsum(dt * A) over the chunk and h the (P, N) state entering it:
//   y[q]  = sum_{k <= q} (C_q . B_k) exp(cs_q - cs_k) dt_k x_k   (quadratic term)
//         + exp(cs_q) C_q . h                                    (carried term)
//   h'    = exp(cs_last) h + sum_k exp(cs_last - cs_k) dt_k B_k (x) x_k
// The state is zero (or init_state) at chunk 0.  Same function as
// kernels/ref.py::ssd_scan_ref, in float32 throughout; x, B, C and y may be
// float32 or bfloat16, dt, A and the state are float32.  B and C have G
// groups; head h reads group h / (H / G).
//
// What bounds it on this card: operations.  At mamba2-130m width (H=24, P=64,
// N=128, Q=256) one layer call at B=1, S=1024 moves ~14.5 MB and does ~1.25
// GFLOP counted once, above the float32 ridge of the CUDA cores.  Tensor cores
// are not used: TF32 misses the 1e-4 / 1e-3 tolerance this kernel is held to.
//
// Design.  The TPU kernel walked the chunks in order per head block, holding
// the (Q, Q, heads) decay matrix in VMEM.  Here only the state recurrence is
// sequential, and it is elementwise; the rest is split as the SSD algorithm
// splits it, into three launches on one stream:
//   1. chunk_prep, two kinds of independent CTA in one grid:
//      (a) chunk_scores: CB = C_c . B_c^T, one (Q, Q) float32 matrix per
//          (batch, chunk, group), in 64 x 64 tiles on and below the diagonal;
//          every head of the group reads it, so it is computed once, not once
//          per head;
//      (b) chunk_states: per (batch, chunk, head, 64 x 64 tile of (N, P)) the
//          chunk's own state S_c = sum_k exp(cs_last - cs_k) dt_k B_k (x) x_k,
//          with the chunk's cumsum taken by a block-wide scan (stored for 3).
//   2. state_pass: per (batch, head, state element) h <- exp(cs_last) h + S_c
//      over the chunks in order, overwriting S_c in place with the state that
//      enters chunk c, and writing the final state.
//   3. chunk_out: per (batch, chunk, head, 64-row q tile, 64 columns of P) the
//      carried term from the entering state, then the quadratic term from CB
//      with the decay exp(cs_q - cs_k) and dt_k applied while staging, into
//      one register tile; the q tiles nearest the end of the chunk, which
//      carry the most key tiles, launch first.
// Every product runs on 256 threads, each owning a 4 x 4 register tile of
// the output, with operands read from shared memory as float4: 8 loads per
// 64 FMAs, where scalar dot products read two per FMA.  The next 64 x 64
// stage is loaded into registers while the current one's products run, so
// the L2 latency of the staging overlaps the math.  At B=1, S=1024,
// mamba2-130m width chunk_out has 384 CTAs and chunk_prep 192 + 40 live
// ones.  Chunk 0 skips the carried term when there is no init_state.
// Decays are exponentials of differences, never quotients of exponentials.
// Padded rows (dt = 0) leave the state unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16, each thread a 4 x 4 output tile
constexpr int kT = 64;         // output tile edge
constexpr int kNC = 32;        // depth of one staged slice of N
constexpr int kMaxQ = 1024;    // longest chunk (cumsum and dt staged whole)
constexpr int kLd = kT + 4;    // padded row of a 64-wide tile (float4-aligned)
constexpr int kLdN = kNC + 4;  // padded row of a 32-deep slice

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// acc[r][c] += sum_j A[r][j] * Bt[j][c] over 4 consecutive j, where the
// thread's rows of A are a[r] (float4 along j) and Bt's rows j are b[j]
// (float4 along the thread's 4 columns)
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 (&a)[4],
                                       const float4 (&b)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float ar = at(a[r], j);
      acc[r][0] = fmaf(ar, b[j].x, acc[r][0]);
      acc[r][1] = fmaf(ar, b[j].y, acc[r][1]);
      acc[r][2] = fmaf(ar, b[j].z, acc[r][2]);
      acc[r][3] = fmaf(ar, b[j].w, acc[r][3]);
    }
}

// (a) CB[b, c, g] = C_c . B_c^T for one 64 x 64 tile (qt, kt), kt <= qt.
// Thread (ty, tx) owns rows q0 + 4 ty + r and columns k0 + tx + 16 c: the
// strided columns make the float4 reads of B's rows conflict-free.
template <typename T>
__device__ void chunk_scores(const T* __restrict__ Bm, const T* __restrict__ Cm,
                             float* __restrict__ CB, int qt, int kt, int g, int bc, int S, int G,
                             int N, int Q, int nc, float* Cs, float* Bs) {
  const int b = bc / nc, c = bc % nc;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * kT, k0 = kt * kT;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += kNC) {
    __syncthreads();
    for (int e = tid; e < kT * kNC; e += kThreads) {
      const int i = e / kNC, n = e % kNC;
      const bool nin = n0 + n < N;
      Cs[i * kLdN + n] = nin && q0 + i < Q ? to_f(Cm[((t0 + q0 + i) * G + g) * N + n0 + n]) : 0.f;
      Bs[i * kLdN + n] = nin && k0 + i < Q ? to_f(Bm[((t0 + k0 + i) * G + g) * N + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int n4 = 0; n4 < kNC; n4 += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(&Cs[(ty * 4 + r) * kLdN + n4]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ld4(&Bs[(tx + 16 * j) * kLdN + n4]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = dot4(a[r], bb[j], acc[r][j]);
    }
  }
  float* out = CB + ((size_t)bc * G + g) * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = q0 + ty * 4 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (q < Q && k < Q) out[(size_t)q * Q + k] = acc[r][j];
    }
  }
}

// Inclusive cumsum of dt * a over the chunk into cs[0, Q), by all threads:
// a warp scan per 256-long segment, then a scan of the 8 warp totals.  The
// products are rounded to float32 and summed in float64, so the sum's error
// in any order lies far below float32's rounding and cs is the float32
// rounding of it, bar a rare last-bit tie (it is not exact: products of
// exponents more than 29 bits apart, dt ~1e-9 beside ~10, can round in the
// double).  kernels/ref.py::ssd_scan_bwd_ref sums the same way, so the two
// agree to an ulp, not bit for bit; |cs| reaches hundreds over a chunk,
// where float32 sums in two orders would differ in the decays exp(cs_q - cs_k).
__device__ void chunk_cumsum(const float* __restrict__ dt, size_t row0, int H, int h, float a,
                             int Q, float* cs, float* dts, double* wtot) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = kThreads / 32;
  double carry = 0.0;
  for (int base = 0; base < Q; base += kThreads) {
    const int q = base + tid;
    const float d = q < Q ? dt[(row0 + q) * H + h] : 0.f;
    const float da = d * a;
    double v = da;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    if (lane == 31) wtot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      double w = lane < kWarps ? wtot[lane] : 0.0;
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += o;
      }
      if (lane < kWarps) wtot[lane] = w;
    }
    __syncthreads();
    if (q < Q) {
      cs[q] = (float)(carry + (warp > 0 ? wtot[warp - 1] : 0.0) + v);
      dts[q] = d;
    }
    carry += wtot[kWarps - 1];
    __syncthreads();  // wtot is rewritten by the next segment
  }
}

// Staging of 64 x 64 tiles: thread t loads column t % 64 of rows t / 64 + 4 i,
// i < 16, into registers one stage ahead of the products that read them.
constexpr int kPer = kT * kT / kThreads;

// (b) The chunk's own state, stored transposed as st[b, c, h] (N, P):
// st[n][p] = sum_k w_k B_k[n] x_k[p], w_k = exp(cs_last - cs_k) dt_k.
// Thread (ty, tx) owns n = n0 + 4 ty + r and p = p0 + 4 tx + c.
template <typename T>
__device__ void chunk_states(const T* __restrict__ x, const float* __restrict__ dt,
                             const float* __restrict__ A, const T* __restrict__ Bm,
                             float* __restrict__ st, float* __restrict__ cs_out, int nt, int pt,
                             int h, int bc, int S, int H, int G, int P, int N, int Q, int nc,
                             float* Bs, float* Xs, float* cs, float* ws, double* wtot) {
  const int b = bc / nc, c = bc % nc;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col = tid % kT, row0 = tid / kT;
  const int n0 = nt * kT, p0 = pt * kT;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;

  chunk_cumsum(dt, t0, H, h, A[h], Q, cs, ws, wtot);
  const float cl = cs[Q - 1];
  for (int q = tid; q < Q; q += kThreads) {
    if (nt == 0 && pt == 0) cs_out[((size_t)bc * H + h) * Q + q] = cs[q];
    ws[q] = expf(cl - cs[q]) * ws[q];
  }

  float rb[kPer], rx[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = k0 + row0 + 4 * i;
      rb[i] = k < Q && n0 + col < N ? to_f(Bm[((t0 + k) * G + g) * N + n0 + col]) : 0.f;
      rx[i] = k < Q && p0 + col < P ? to_f(x[((t0 + k) * H + h) * P + p0 + col]) : 0.f;
    }
  };
  float acc[4][4] = {};
  fetch(0);
  for (int k0 = 0; k0 < Q; k0 += kT) {
    __syncthreads();  // ws is ready; the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = row0 + 4 * i;
      Bs[r * kLd + col] = rb[i];
      Xs[r * kLd + col] = k0 + r < Q ? ws[k0 + r] * rx[i] : 0.f;
    }
    __syncthreads();
    if (k0 + kT < Q) fetch(k0 + kT);  // in flight while this tile's products run
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      const float4 bn = ld4(&Bs[j * kLd + ty * 4]);
      const float4 xp = ld4(&Xs[j * kLd + tx * 4]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float br = at(bn, r);
        acc[r][0] = fmaf(br, xp.x, acc[r][0]);
        acc[r][1] = fmaf(br, xp.y, acc[r][1]);
        acc[r][2] = fmaf(br, xp.z, acc[r][2]);
        acc[r][3] = fmaf(br, xp.w, acc[r][3]);
      }
    }
  }
  float* out = st + ((size_t)bc * H + h) * N * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + ty * 4 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (n < N && p < P) out[(size_t)n * P + p] = acc[r][j];
    }
  }
}

// (a) and (b) in one launch, which they share as independent CTAs: x < nsx
// are (b) tiles of head y; the rest are (a) tiles of group y (y < G).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_prep(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ CB,
           float* __restrict__ st, float* __restrict__ cs_out, int S, int H, int G, int P, int N,
           int Q, int nc) {
  __shared__ __align__(16) float Bs[kT * kLd];
  __shared__ __align__(16) float Xs[kT * kLd];
  __shared__ float cs[kMaxQ];
  __shared__ float ws[kMaxQ];
  __shared__ double wtot[kThreads / 32];
  const int nnt = (N + kT - 1) / kT, npt = (P + kT - 1) / kT, nsx = nnt * npt;
  const int bx = blockIdx.x, y = blockIdx.y, bc = blockIdx.z;
  if (bx < nsx) {
    chunk_states<T>(x, dt, A, Bm, st, cs_out, bx % nnt, bx / nnt, y, bc, S, H, G, P, N, Q, nc,
                    Bs, Xs, cs, ws, wtot);
    return;
  }
  const int nqt = (Q + kT - 1) / kT, tile = bx - nsx;
  const int qt = tile / nqt, kt = tile % nqt;
  if (y >= G || kt > qt) return;  // above the diagonal: never read
  chunk_scores<T>(Bm, Cm, CB, qt, kt, y, bc, S, G, N, Q, nc, Bs, Xs);
}

// (c) h <- exp(cs_last) h + S_c over the chunks in order.  st[b, c, h] is
// overwritten with the state entering chunk c; the final state goes to
// state_out (B, H, P, N).  One thread per state element; the loads of 8
// chunks are issued before their chain of updates.
__global__ void __launch_bounds__(kThreads)
state_pass(float* __restrict__ st, const float* __restrict__ cs,
           const float* __restrict__ init_state, float* __restrict__ state_out, int H, int P,
           int N, int Q, int nc) {
  constexpr int kBatch = 8;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= N * P) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n = e / P, p = e % P;
  const size_t at_out = (((size_t)b * H + h) * P + p) * N + n;
  float hv = init_state != nullptr ? init_state[at_out] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float own[kBatch], decay[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const size_t bch = ((size_t)b * nc + c0 + i) * H + h;
      own[i] = c0 + i < nc ? st[bch * N * P + e] : 0.f;
      decay[i] = c0 + i < nc ? cs[bch * Q + Q - 1] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < nc) {
        st[(((size_t)b * nc + c0 + i) * H + h) * N * P + e] = hv;
        hv = fmaf(expf(decay[i]), hv, own[i]);
      }
    }
  }
  state_out[at_out] = hv;
}

// (d) y for one 64-row q tile and 64 columns of P of one (batch, chunk, head):
// sum_n (exp(cs_q) C_q[n]) h_in[n] over 64-deep slices of N, then
// sum_{k <= q} (CB[q][k] exp(cs_q - cs_k) dt_k) x_k over the key tiles up to
// the diagonal, all into one register tile (the carried term is skipped in
// chunk 0 when there is no init_state).  Thread (ty, tx) owns
// q = q0 + 4 ty + r and p = p0 + 4 tx + c.  The q tiles are launched last
// first (z reversed): the tiles nearest the diagonal of a late q tile carry
// the most key tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_out(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Cm,
          const float* __restrict__ CB, const float* __restrict__ cs_in,
          const float* __restrict__ st, T* __restrict__ y, int S, int H, int G, int P, int N,
          int Q, int nc, int has_init) {
  __shared__ __align__(16) float As[kT * kLd];  // (q, n) C e^{cs_q} / (q, k) decayed scores
  __shared__ __align__(16) float Bs[kT * kLd];  // (n, p) h_in / (k, p) x
  __shared__ float cs[kMaxQ];
  __shared__ float dts[kMaxQ];
  __shared__ float eq[kT];
  const int npt = (P + kT - 1) / kT;
  const int tile = gridDim.z - 1 - blockIdx.z;
  const int qt = tile / npt, pt = tile % npt;
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / nc, c = bc % nc;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col = tid % kT, row0 = tid / kT;
  const int q0 = qt * kT, p0 = pt * kT;
  const int q_end = min(Q, q0 + kT);
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t bch = (size_t)bc * H + h;
  const float* hin = st + bch * N * P;
  const float* cb = CB + ((size_t)bc * G + g) * Q * Q;

  for (int i = tid; i < q_end; i += kThreads) {
    cs[i] = cs_in[bch * Q + i];
    dts[i] = dt[(t0 + i) * H + h];
  }
  __syncthreads();
  if (tid < kT) eq[tid] = q0 + tid < Q ? expf(cs[q0 + tid]) : 0.f;

  // stages: nin slices of N for the carried term, then qt + 1 key tiles
  const int nin = c == 0 && !has_init ? 0 : (N + kT - 1) / kT, nst = nin + qt + 1;
  float ra[kPer], rb[kPer];
  auto fetch = [&](int s) {
    if (s < nin) {
      const int n = s * kT + col;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = row0 + 4 * i;
        ra[i] = q0 + r < Q && n < N ? to_f(Cm[((t0 + q0 + r) * G + g) * N + n]) : 0.f;
        rb[i] = s * kT + r < N && p0 + col < P ? hin[(size_t)(s * kT + r) * P + p0 + col] : 0.f;
      }
    } else {
      const int k0 = (s - nin) * kT, k = k0 + col;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = row0 + 4 * i, q = q0 + r;
        ra[i] = k <= q && q < Q ? cb[(size_t)q * Q + k] : 0.f;
        rb[i] = k0 + r < Q && p0 + col < P ? to_f(x[((t0 + k0 + r) * H + h) * P + p0 + col]) : 0.f;
      }
    }
  };

  float acc[4][4] = {};
  fetch(0);
  for (int s = 0; s < nst; ++s) {
    __syncthreads();  // the previous stage's readers are done (and eq is visible)
    if (s < nin) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = row0 + 4 * i;
        As[r * kLd + col] = ra[i] * eq[r];
        Bs[r * kLd + col] = rb[i];
      }
    } else {
      const int k = (s - nin) * kT + col;
      const float ck = k < q_end ? cs[k] : 0.f, dk = k < q_end ? dts[k] : 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = row0 + 4 * i, q = q0 + r;
        As[r * kLd + col] = k <= q && q < Q ? ra[i] * expf(cs[q] - ck) * dk : 0.f;
        Bs[r * kLd + col] = rb[i];
      }
    }
    __syncthreads();
    if (s + 1 < nst) fetch(s + 1);  // in flight while this stage's products run
#pragma unroll 2
    for (int k4 = 0; k4 < kT; k4 += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(&As[(ty * 4 + r) * kLd + k4]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ld4(&Bs[(k4 + j) * kLd + tx * 4]);
      outer4(acc, a, bb);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = q0 + ty * 4 + r;
    if (q >= Q) continue;
    T* out = y + ((t0 + q) * H + h) * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (p < P) store(&out[p], acc[r][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                   const float* init_state, void* y, float* state_out, float* CB, float* cs,
                   float* st, int B, int S, int H, int G, int P, int N, int Q,
                   cudaStream_t stream) {
  const int nc = S / Q;
  const int nqt = (Q + kT - 1) / kT, nnt = (N + kT - 1) / kT, npt = (P + kT - 1) / kT;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  chunk_prep<T><<<dim3(nnt * npt + nqt * nqt, H, B * nc), kThreads, 0, stream>>>(
      xt, dt, A, Bt, Ct, CB, st, cs, S, H, G, P, N, Q, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_pass<<<dim3((N * P + kThreads - 1) / kThreads, H, B), kThreads, 0, stream>>>(
      st, cs, init_state, state_out, H, P, N, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_out<T><<<dim3(H, B * nc, nqt * npt), kThreads, 0, stream>>>(
      xt, dt, Ct, CB, cs, st, static_cast<T*>(y), S, H, G, P, N, Q, nc, init_state != nullptr);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_max_chunk() { return kMaxQ; }

// x, y: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, G, N); init_state
// (may be null) and state_out: (B, H, P, N).  Scratch, float32, allocated by
// the caller: CB (B, S/Q, G, Q, Q), cs (B, S/Q, H, Q), st (B, S/Q, H, N, P).
// S must be a multiple of Q, Q at most ssd_scan_max_chunk(), H a multiple of
// G; x, Bm, Cm and y are bfloat16 when is_bf16.  Three launches on `stream`.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A, const void* Bm,
                               const void* Cm, const float* init_state, void* y,
                               float* state_out, float* CB, float* cs, float* st, int B, int S,
                               int H, int G, int P, int N, int Q, int is_bf16, void* stream) {
  if (B < 1 || Q < 1 || Q > kMaxQ || S < Q || S % Q != 0 || G < 1 || H % G != 0 || P < 1 ||
      N < 1 || B * (S / Q) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init_state, y, state_out, CB, cs, st, B, S, H, G,
                              P, N, Q, s)
      : launch<float>(x, dt, A, Bm, Cm, init_state, y, state_out, CB, cs, st, B, S, H, G, P, N,
                      Q, s));
}
