// The gradient of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a).
//
// No TPU kernel: the JAX package differentiates its einsum form, ssd_chunked
// in models/mamba.py, by autodiff.  Same function as
// kernels/ref.py::ssd_scan_bwd_ref, whose docstring sets out the chunked
// decomposition this kernel follows; float32 arithmetic throughout on the
// CUDA cores (TF32 misses the 1e-4 / 1e-3 tolerance, as in the forward).  x,
// B, C, dy and dx, dB, dC may be float32 or bfloat16; dt, A, the states and
// every other gradient are float32.  B and C have G groups; head h reads
// group h / (H / G).
//
// It starts from the forward's own scratch: CB = C.B^T per (batch, chunk,
// group), the chunk cumsums cs and the state entering each chunk, so no
// forward pass is repeated.
//
// What bounds it on this card: operations.  At mamba2-130m width (H=24,
// P=64, N=128, Q=256) one layer at B=2, S=1024 does ~5 GFLOP counted once,
// about twice the forward's, and moves ~50 MB.
//
// Design.  Five launches on one stream, in the forward's three parts reversed:
//   1. bwd_prep, two kinds of independent CTA in one grid, per (batch, chunk,
//      head):
//      (a) the carried term's state gradient dh_c = sum_q exp(cs_q) C_q (x)
//          dy_q, one 64 x 64 tile of (N, P) each;
//      (b) for each 64 x 64 tile pair (q, k) on and below the diagonal
//          D = dy_q . x_k, and from it this head's dCB = D exp(cs_q - cs_k)
//          dt_k (written out) and the sums over the tile's rows and columns
//          of Z = D CB exp(cs_q - cs_k) and T = Z dt_k, for ddt and d cs.
//   2. state_bwd: per (batch, head, state element) from the last chunk down,
//      G <- exp(cs_last) G + dh_c, overwriting dh_c with the gradient G of
//      the state leaving chunk c and writing the gradient entering chunk 0;
//      and per chunk the block's sum of G * h_c (d cs_last).
//   3. dcb_reduce (only when a group has several heads): dCB summed over
//      the heads of each group, in head order.
//   4. chunk_grads, three kinds of CTA in one grid:
//      dC per (batch, chunk, group, q tile, n tile): sum over the group's
//          heads of exp(cs_q) dy_q h, then sum_k dCB_qk B_k;
//      dB per (batch, chunk, group, k tile, n tile): sum over the group's
//          heads of w_k G^T x_k, then sum_q dCB_qk C_q;
//      dx per (batch, chunk, head, k tile, p tile): V = C h^T (its rows'
//          dots with dy give the carried d cs), U = B G^T (its rows' dots
//          with x give dw), then dx = w U + sum_q M_qk dy_q.
//   5. dt_bwd: per head, over (batch, chunk) in order: every d cs gathered
//      from the partial sums above, the reverse cumsum inside the chunk
//      (da), ddt, and dA = sum of da dt.
// They count as one launch.  Every product runs on 256 threads, each owning
// a 4 x 4 register tile, operands staged 64 x 64 at a time through shared
// memory (the next stage's loads in flight while the current one's products
// run), as in the forward.  No atomics: every sum that crosses threads or
// CTAs (dB and dC over a group's heads, the row and column sums, dA over
// batch and positions) is taken in a fixed order, so two runs agree bit for
// bit.  The sums that cancel are taken in float64: the row and column sums
// of T, the partial sums of d cs, its reverse cumsum, dA (and the state
// pass's sum of G * h); the products stay float32.  Decays are exponentials of differences on and below the diagonal,
// never quotients of exponentials.  Padded rows (dt = 0, x = B = C = 0) get
// gradients that the caller cuts off; they leave the state gradient alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16, each thread a 4 x 4 output tile
constexpr int kT = 64;         // tile edge
constexpr int kMaxQ = 1024;    // longest chunk (cumsum and dt staged whole)
constexpr int kLd = kT + 4;    // padded row of a 64-wide tile (float4-aligned)
constexpr int kPer = kT * kT / kThreads;  // staged elements per thread
constexpr int kPerQ = kMaxQ / kThreads;   // chunk positions per thread in dt_bwd

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

// acc[r][c] += sum over nst stages of sum_d A_s[4 ty + r][d] * Bt_s[d][4 tx + c],
// each stage a 64-deep slice: fa(s, r, d) gives A_s's element (row r, depth
// d), fb(s, d, c) gives Bt_s's (depth d, column c), zero outside the data.
// Thread t stages elements (t / 64 + 4 i, t % 64) of each tile, or with
// kTransA / kTransB their transposes (t % 64, t / 64 + 4 i): the flag names
// the operand whose first index runs along memory, so that neighbouring
// threads read neighbouring addresses.  The next stage is fetched into
// registers while the current one's products run.
template <bool kTransA, bool kTransB, class FA, class FB>
__device__ __forceinline__ void mma_stages(float (&acc)[4][4], int nst, FA fa, FB fb,
                                           float* As, float* Bs) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col = tid % kT, row0 = tid / kT;
  float ra[kPer], rb[kPer];
  auto fetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = row0 + 4 * i;
      ra[i] = kTransA ? fa(s, col, r) : fa(s, r, col);
      rb[i] = kTransB ? fb(s, col, r) : fb(s, r, col);
    }
  };
  if (nst > 0) fetch(0);
  for (int s = 0; s < nst; ++s) {
    __syncthreads();  // the previous stage's (or the caller's) readers are done
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = row0 + 4 * i;
      As[kTransA ? col * kLd + r : r * kLd + col] = ra[i];
      Bs[kTransB ? col * kLd + r : r * kLd + col] = rb[i];
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
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float ar = at(a[r], j);
          acc[r][0] = fmaf(ar, bb[j].x, acc[r][0]);
          acc[r][1] = fmaf(ar, bb[j].y, acc[r][1]);
          acc[r][2] = fmaf(ar, bb[j].z, acc[r][2]);
          acc[r][3] = fmaf(ar, bb[j].w, acc[r][3]);
        }
    }
  }
  __syncthreads();  // As and Bs are free for the caller
}

// The sums over each row of a 64 x 64 tile held as the threads' 4 x 4
// register tiles (rows 4 ty + r, columns 4 tx + c), in column order and in
// float64, by threads 0-63 (row = tid) into sums[row]; `red` is a 64 x kLd
// shared tile.
__device__ __forceinline__ void row_sums(const float (&v)[4][4], float* red, double* sums) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(ty * 4 + r) * kLd + tx * 4 + c] = v[r][c];
  __syncthreads();
  if (tid < kT) {
    double s = 0.0;
    for (int c = 0; c < kT; ++c) s += red[tid * kLd + c];
    sums[tid] = s;
  }
  __syncthreads();
}

// Sum of v over the block, in a fixed tree order; every thread gets it.
__device__ __forceinline__ double block_sum(double v, double* red) {
  const int tid = threadIdx.x;
  __syncthreads();  // red's previous readers are done
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

// Loads cs[b, c, h] (Q) into sh.
__device__ __forceinline__ void load_cs(const float* __restrict__ cs, size_t bch, int Q,
                                        float* sh) {
  for (int q = threadIdx.x; q < Q; q += kThreads) sh[q] = cs[bch * Q + q];
}

// ---------------------------------------------------------------- launch 1
// (a) dh_c[n][p] = sum_q exp(cs_q) C_q[n] dy_q[p], stored as (N, P) in dst.
template <typename T>
__device__ void carry_state(const T* __restrict__ dy, const T* __restrict__ Cm,
                            float* __restrict__ dst, const float* csh, int nt, int pt, int h,
                            int bc, int S, int H, int G, int P, int N, int Q, int nc, float* As,
                            float* Bs) {
  const int b = bc / nc, c = bc % nc, g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = nt * kT, p0 = pt * kT, nqt = (Q + kT - 1) / kT;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  float acc[4][4] = {};
  mma_stages<true, false>(
      acc, nqt,
      [&](int s, int r, int d) {  // (n, q): exp(cs_q) C_q[n]
        const int q = s * kT + d, n = n0 + r;
        return q < Q && n < N ? expf(csh[q]) * to_f(Cm[((t0 + q) * G + g) * N + n]) : 0.f;
      },
      [&](int s, int d, int cc) {  // (q, p): dy_q[p]
        const int q = s * kT + d, p = p0 + cc;
        return q < Q && p < P ? to_f(dy[((t0 + q) * H + h) * P + p]) : 0.f;
      },
      As, Bs);
  float* out = dst + ((size_t)bc * H + h) * N * P;
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

// (b) For the tile pair (qt, kt), kt <= qt, of head h: D = dy_q . x_k, then
// dCBh = D e dt_k (e = exp(cs_q - cs_k) for k <= q, else 0) written out, and
// the row sums of T = Z dt_k into rowT[kt], the column sums of T into
// colT[qt] and of Z = D CB e into colZ[qt].
template <typename T>
__device__ void pair_tile(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ dt, const float* __restrict__ CB,
                          float* __restrict__ dCBh, double* __restrict__ rowT,
                          double* __restrict__ colT, double* __restrict__ colZ, const float* csh,
                          int qt, int kt, int h, int bc, int S, int H, int G, int P, int Q, int nc,
                          float* As, float* Bs) {
  const int b = bc / nc, c = bc % nc, g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * kT, k0 = kt * kT, npt = (P + kT - 1) / kT, nqt = (Q + kT - 1) / kT;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t bch = (size_t)bc * H + h;
  float acc[4][4] = {};
  mma_stages<false, true>(
      acc, npt,
      [&](int s, int r, int d) {  // (q, p): dy_q[p]
        const int q = q0 + r, p = s * kT + d;
        return q < Q && p < P ? to_f(dy[((t0 + q) * H + h) * P + p]) : 0.f;
      },
      [&](int s, int d, int cc) {  // (p, k): x_k[p]
        const int k = k0 + cc, p = s * kT + d;
        return k < Q && p < P ? to_f(x[((t0 + k) * H + h) * P + p]) : 0.f;
      },
      As, Bs);
  const float* cb = CB + ((size_t)bc * G + g) * Q * Q;
  float* dcb = dCBh + bch * Q * Q;
  float tv[4][4], zv[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = q0 + ty * 4 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      const bool live = k <= q && q < Q;
      const float e = live ? expf(csh[q] - csh[k]) : 0.f;
      const float dtk = live ? dt[(t0 + k) * H + h] : 0.f;
      const float cbv = live ? cb[(size_t)q * Q + k] : 0.f;
      zv[r][j] = acc[r][j] * cbv * e;
      tv[r][j] = zv[r][j] * dtk;
      if (q < Q && k < Q) dcb[(size_t)q * Q + k] = acc[r][j] * e * dtk;
    }
  }
  // row sums of T (over this tile's k) and column sums of T and Z (over q)
  double* sums = reinterpret_cast<double*>(Bs);  // 64 doubles; the tile is in As
  row_sums(tv, As, sums);
  if (tid < kT && q0 + tid < Q) rowT[(bch * nqt + kt) * Q + q0 + tid] = sums[tid];
  // the column sums: T^T and then Z^T through shared memory, rows summed
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) As[(tx * 4 + j) * kLd + ty * 4 + r] = tv[r][j];
  __syncthreads();
  if (tid < kT && k0 + tid < Q) {
    double s = 0.0;
    for (int i = 0; i < kT; ++i) s += As[tid * kLd + i];
    colT[(bch * nqt + qt) * Q + k0 + tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) As[(tx * 4 + j) * kLd + ty * 4 + r] = zv[r][j];
  __syncthreads();
  if (tid < kT && k0 + tid < Q) {
    double s = 0.0;
    for (int i = 0; i < kT; ++i) s += As[tid * kLd + i];
    colZ[(bch * nqt + qt) * Q + k0 + tid] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bwd_prep(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Cm,
         const T* __restrict__ dy, const float* __restrict__ CB, const float* __restrict__ cs,
         float* __restrict__ dst, float* __restrict__ dCBh, double* __restrict__ rowT,
         double* __restrict__ colT, double* __restrict__ colZ, int S, int H, int G, int P, int N,
         int Q, int nc) {
  __shared__ __align__(16) float As[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  __shared__ float csh[kMaxQ];
  const int nnt = (N + kT - 1) / kT, npt = (P + kT - 1) / kT, nqt = (Q + kT - 1) / kT;
  const int bx = blockIdx.x, h = blockIdx.y, bc = blockIdx.z;
  const int ncarry = nnt * npt;
  if (bx >= ncarry) {
    const int tile = bx - ncarry, qt = tile / nqt, kt = tile % nqt;
    if (kt > qt) return;  // above the diagonal: all zero, never read
  }
  load_cs(cs, (size_t)bc * H + h, Q, csh);
  __syncthreads();
  if (bx < ncarry) {
    carry_state<T>(dy, Cm, dst, csh, bx % nnt, bx / nnt, h, bc, S, H, G, P, N, Q, nc, As, Bs);
  } else {
    const int tile = bx - ncarry;
    pair_tile<T>(x, dy, dt, CB, dCBh, rowT, colT, colZ, csh, tile / nqt, tile % nqt, h, bc, S, H,
                 G, P, Q, nc, As, Bs);
  }
}

// ---------------------------------------------------------------- launch 2
// Per (batch, head, state element e = n * P + p), the chunks from last to
// first: dst[c] (dh_c on entry) becomes G_c, the gradient of the state
// leaving chunk c; G_{c-1} = exp(cs_last) G_c + dh_c; the gradient entering
// chunk 0 goes to d_init (B, H, P, N).  For each chunk the block's sum of
// G_c * h_c times exp(cs_last) goes to part_decay[b, c, h, block].
__global__ void __launch_bounds__(kThreads)
state_bwd(float* __restrict__ dst, const float* __restrict__ st, const float* __restrict__ cs,
          const float* __restrict__ d_final, float* __restrict__ d_init,
          double* __restrict__ part_decay, int H, int P, int N, int Q, int nc) {
  __shared__ double red[kThreads];
  const int e = blockIdx.x * kThreads + threadIdx.x, nblk = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool live = e < N * P;  // every thread takes part in the block sums
  const int n = live ? e / P : 0, p = live ? e % P : 0;
  const size_t at_out = (((size_t)b * H + h) * P + p) * N + n;
  float gv = live && d_final != nullptr ? d_final[at_out] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t bch = ((size_t)b * nc + c) * H + h;
    const float own = live ? dst[bch * N * P + e] : 0.f;
    const float hc = live ? st[bch * N * P + e] : 0.f;
    const float decay = expf(cs[bch * Q + Q - 1]);
    const double sum = block_sum((double)gv * hc, red);
    if (threadIdx.x == 0) part_decay[bch * nblk + blockIdx.x] = decay * sum;
    if (live) dst[bch * N * P + e] = gv;
    gv = fmaf(decay, gv, own);
  }
  if (live) d_init[at_out] = gv;
}

// ---------------------------------------------------------------- launch 3
// dCBg[b, c, g] = sum over the group's heads, in order, of dCBh[b, c, h], on
// and below the diagonal tiles.
__global__ void __launch_bounds__(kThreads)
dcb_reduce(const float* __restrict__ dCBh, float* __restrict__ dCBg, int H, int G, int Q) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)Q * Q) return;
  const int q = (int)(e / Q), k = (int)(e % Q);
  if (k / kT > q / kT) return;
  const int g = blockIdx.y, bc = blockIdx.z, rep = H / G;
  const float* src = dCBh + ((size_t)bc * H + (size_t)g * rep) * Q * Q + e;
  float s = 0.f;
  for (int r = 0; r < rep; ++r) s += src[(size_t)r * Q * Q];
  dCBg[((size_t)bc * G + g) * Q * Q + e] = s;
}

// ---------------------------------------------------------------- launch 4
// dC for one (q tile, n tile) of group g: sum over the group's heads of
// exp(cs_q) dy_q h_c, then sum_{k <= q} dCB_qk B_k.
template <typename T>
__device__ void grad_C(const T* __restrict__ dy, const T* __restrict__ Bm,
                       const float* __restrict__ cs, const float* __restrict__ st,
                       const float* __restrict__ dCBg, T* __restrict__ dC, int qt, int nt, int g,
                       int bc, int S, int H, int G, int P, int N, int Q, int nc, float* As,
                       float* Bs) {
  const int b = bc / nc, c = bc % nc, rep = H / G;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * kT, n0 = nt * kT, npt = (P + kT - 1) / kT;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  float acc[4][4] = {};
  // carried: stage s is slice s % npt of P of head g * rep + s / npt
  mma_stages<false, true>(
      acc, rep * npt,
      [&](int s, int r, int d) {  // (q, p): exp(cs_q) dy_q[p] of the stage's head
        const int h = g * rep + s / npt, q = q0 + r, p = (s % npt) * kT + d;
        return q < Q && p < P
                   ? expf(cs[((size_t)bc * H + h) * Q + q]) *
                         to_f(dy[((t0 + q) * H + h) * P + p])
                   : 0.f;
      },
      [&](int s, int d, int cc) {  // (p, n): h_c[n][p]
        const int h = g * rep + s / npt, p = (s % npt) * kT + d, n = n0 + cc;
        return p < P && n < N ? st[(((size_t)bc * H + h) * N + n) * P + p] : 0.f;
      },
      As, Bs);
  const float* dcb = dCBg + ((size_t)bc * G + g) * Q * Q;
  mma_stages<false, false>(
      acc, qt + 1,
      [&](int s, int r, int d) {  // (q, k): dCB_qk, k <= q
        const int q = q0 + r, k = s * kT + d;
        return k <= q && q < Q ? dcb[(size_t)q * Q + k] : 0.f;
      },
      [&](int s, int d, int cc) {  // (k, n): B_k[n]
        const int k = s * kT + d, n = n0 + cc;
        return k < Q && n < N ? to_f(Bm[((t0 + k) * G + g) * N + n]) : 0.f;
      },
      As, Bs);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = q0 + ty * 4 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (q < Q && n < N) store(&dC[((t0 + q) * G + g) * N + n], acc[r][j]);
    }
  }
}

// dB for one (k tile, n tile) of group g: sum over the group's heads of
// w_k G^T x_k (w_k = exp(cs_last - cs_k) dt_k), then sum_{q >= k} dCB_qk C_q.
template <typename T>
__device__ void grad_B(const T* __restrict__ x, const float* __restrict__ dt,
                       const T* __restrict__ Cm, const float* __restrict__ cs,
                       const float* __restrict__ dst, const float* __restrict__ dCBg,
                       T* __restrict__ dB, int kt, int nt, int g, int bc, int S, int H, int G,
                       int P, int N, int Q, int nc, float* As, float* Bs) {
  const int b = bc / nc, c = bc % nc, rep = H / G;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = kt * kT, n0 = nt * kT, npt = (P + kT - 1) / kT, nqt = (Q + kT - 1) / kT;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  float acc[4][4] = {};
  mma_stages<false, true>(
      acc, rep * npt,
      [&](int s, int r, int d) {  // (k, p): w_k x_k[p] of the stage's head
        const int h = g * rep + s / npt, k = k0 + r, p = (s % npt) * kT + d;
        if (k >= Q || p >= P) return 0.f;
        const float* c_h = cs + ((size_t)bc * H + h) * Q;
        const float w = expf(c_h[Q - 1] - c_h[k]) * dt[(t0 + k) * H + h];
        return w * to_f(x[((t0 + k) * H + h) * P + p]);
      },
      [&](int s, int d, int cc) {  // (p, n): G_c[n][p]
        const int h = g * rep + s / npt, p = (s % npt) * kT + d, n = n0 + cc;
        return p < P && n < N ? dst[(((size_t)bc * H + h) * N + n) * P + p] : 0.f;
      },
      As, Bs);
  const float* dcb = dCBg + ((size_t)bc * G + g) * Q * Q;
  mma_stages<true, false>(
      acc, nqt - kt,
      [&](int s, int r, int d) {  // (k, q): dCB_qk, q >= k
        const int k = k0 + r, q = (kt + s) * kT + d;
        return k <= q && q < Q ? dcb[(size_t)q * Q + k] : 0.f;
      },
      [&](int s, int d, int cc) {  // (q, n): C_q[n]
        const int q = (kt + s) * kT + d, n = n0 + cc;
        return q < Q && n < N ? to_f(Cm[((t0 + q) * G + g) * N + n]) : 0.f;
      },
      As, Bs);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + ty * 4 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (k < Q && n < N) store(&dB[((t0 + k) * G + g) * N + n], acc[r][j]);
    }
  }
}

// dx for one (k tile, p tile) of head h, and this p tile's share of two row
// dots: part_carry[k] = exp(cs_k) dy_k . V_k with V = C h_c^T (the carried
// term's d cs) and part_dw[k] = x_k . U_k with U = B G_c^T; then dx = w U +
// sum_{q >= k} M_qk dy_q, M_qk = CB_qk exp(cs_q - cs_k) dt_k.
template <typename T>
__device__ void grad_x(const T* __restrict__ x, const float* __restrict__ dt,
                       const T* __restrict__ Bm, const T* __restrict__ Cm,
                       const T* __restrict__ dy, const float* __restrict__ CB,
                       const float* __restrict__ cs, const float* __restrict__ st,
                       const float* __restrict__ dst, T* __restrict__ dx,
                       double* __restrict__ part_carry, double* __restrict__ part_dw, int kt, int pt,
                       int h, int bc, int S, int H, int G, int P, int N, int Q, int nc, float* As,
                       float* Bs, float* csh, float* dts) {
  const int b = bc / nc, c = bc % nc, g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = kt * kT, p0 = pt * kT;
  const int nnt = (N + kT - 1) / kT, npt = (P + kT - 1) / kT, nqt = (Q + kT - 1) / kT;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t bch = (size_t)bc * H + h;
  load_cs(cs, bch, Q, csh);
  for (int q = tid; q < Q; q += kThreads) dts[q] = dt[(t0 + q) * H + h];
  __syncthreads();
  auto at_kp = [&](const T* m, int r, int j) {  // m (B, S, H, P) at this thread's (k, p)
    const int k = k0 + ty * 4 + r, p = p0 + tx * 4 + j;
    return k < Q && p < P ? to_f(m[((t0 + k) * H + h) * P + p]) : 0.f;
  };
  double* sums = reinterpret_cast<double*>(Bs);  // 64 doubles; row_sums reduces through As
  auto slice = [&](const float* m) {  // (n, p) of an (N, P) matrix of this head
    return [=](int s, int d, int cc) {
      const int n = s * kT + d, p = p0 + cc;
      return n < N && p < P ? m[(size_t)n * P + p] : 0.f;
    };
  };
  auto rows_of = [&](const T* m) {  // (k, n) of B or C
    return [=](int s, int r, int d) {
      const int k = k0 + r, n = s * kT + d;
      return k < Q && n < N ? to_f(m[((t0 + k) * G + g) * N + n]) : 0.f;
    };
  };

  // V = C h_c^T, and exp(cs_k) dy_k . V_k over this p tile
  float acc[4][4] = {};
  mma_stages<false, false>(acc, nnt, rows_of(Cm), slice(st + bch * N * P), As, Bs);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] *= at_kp(dy, r, j);
  row_sums(acc, As, sums);
  if (tid < kT && k0 + tid < Q)
    part_carry[(bch * npt + pt) * Q + k0 + tid] = (double)expf(csh[k0 + tid]) * sums[tid];

  // U = B G_c^T, x_k . U_k over this p tile, then dx = w U
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  mma_stages<false, false>(acc, nnt, rows_of(Bm), slice(dst + bch * N * P), As, Bs);
  float xu[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) xu[r][j] = acc[r][j] * at_kp(x, r, j);
  row_sums(xu, As, sums);
  if (tid < kT && k0 + tid < Q) part_dw[(bch * npt + pt) * Q + k0 + tid] = sums[tid];
  const float cl = csh[Q - 1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + ty * 4 + r;
    const float w = k < Q ? expf(cl - csh[k]) * dts[k] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] *= w;
  }

  // + sum_{q >= k} M_qk dy_q over the q tiles from this one down
  const float* cb = CB + ((size_t)bc * G + g) * Q * Q;
  mma_stages<true, false>(
      acc, nqt - kt,
      [&](int s, int r, int d) {  // (k, q): M_qk
        const int k = k0 + r, q = (kt + s) * kT + d;
        return k <= q && q < Q ? cb[(size_t)q * Q + k] * expf(csh[q] - csh[k]) * dts[k]
                               : 0.f;
      },
      [&](int s, int d, int cc) {  // (q, p): dy_q[p]
        const int q = (kt + s) * kT + d, p = p0 + cc;
        return q < Q && p < P ? to_f(dy[((t0 + q) * H + h) * P + p]) : 0.f;
      },
      As, Bs);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + ty * 4 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (k < Q && p < P) store(&dx[((t0 + k) * H + h) * P + p], acc[r][j]);
    }
  }
}

// dC and dB CTAs first (their chains over a group's heads are the longest),
// then dx: x < 2 nqt nnt G are (dC, dB) tiles, the rest dx tiles; y is the
// (batch, chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_grads(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const T* __restrict__ dy, const float* __restrict__ CB,
            const float* __restrict__ cs, const float* __restrict__ st,
            const float* __restrict__ dst, const float* __restrict__ dCBg, T* __restrict__ dx,
            T* __restrict__ dB, T* __restrict__ dC, double* __restrict__ part_carry,
            double* __restrict__ part_dw, int S, int H, int G, int P, int N, int Q, int nc) {
  __shared__ __align__(16) float As[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  __shared__ float csh[kMaxQ];
  __shared__ float dts[kMaxQ];
  const int nnt = (N + kT - 1) / kT, npt = (P + kT - 1) / kT, nqt = (Q + kT - 1) / kT;
  const int per_group = nqt * nnt, bc = blockIdx.y;
  int u = blockIdx.x;
  if (u < 2 * per_group * G) {
    const int kind = u / (per_group * G);  // 0: dC, 1: dB
    u %= per_group * G;
    const int g = u / per_group, tile = u % per_group, t = tile / nnt, nt = tile % nnt;
    if (kind == 0)
      grad_C<T>(dy, Bm, cs, st, dCBg, dC, t, nt, g, bc, S, H, G, P, N, Q, nc, As, Bs);
    else
      grad_B<T>(x, dt, Cm, cs, dst, dCBg, dB, t, nt, g, bc, S, H, G, P, N, Q, nc, As, Bs);
    return;
  }
  u -= 2 * per_group * G;
  const int h = u / (nqt * npt), tile = u % (nqt * npt);
  grad_x<T>(x, dt, Bm, Cm, dy, CB, cs, st, dst, dx, part_carry, part_dw, tile / npt, tile % npt,
            h, bc, S, H, G, P, N, Q, nc, As, Bs, csh, dts);
}

// ---------------------------------------------------------------- launch 5
// Per head, over the (batch, chunk)s in order: thread t owns the chunk
// positions [t * per, (t + 1) * per).  d cs_q is gathered from the partial
// sums (carried, quadratic rows and columns, the state term's -w_q dw_q, and
// at the last position sum_k w_k dw_k and the state pass's decay term); da is
// its reverse cumsum inside the chunk; ddt = exp(cs_last - cs_q) dw_q +
// sum of Z's column + da A, and dA sums da dt.  All in float64: the row and
// column sums of T cancel in the cumsum (their difference summed over q >= t
// is the sum of T over q >= t > k alone), and dA sums over every position.
__global__ void __launch_bounds__(kThreads)
dt_bwd(const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ cs,
       const double* __restrict__ rowT, const double* __restrict__ colT,
       const double* __restrict__ colZ, const double* __restrict__ part_carry,
       const double* __restrict__ part_dw, const double* __restrict__ part_decay,
       float* __restrict__ ddt, float* __restrict__ dA, int B, int S, int H, int P, int N, int Q,
       int nc) {
  __shared__ double red[kThreads];
  const int h = blockIdx.x, tid = threadIdx.x;
  const int npt = (P + kT - 1) / kT, nqt = (Q + kT - 1) / kT;
  const int nblk = (N * P + kThreads - 1) / kThreads;
  const int per = (Q + kThreads - 1) / kThreads, q_lo = tid * per;
  const double a = A[h];
  double dA_acc = 0.0;
  for (int b = 0; b < B; ++b) {
    for (int c = 0; c < nc; ++c) {
      const size_t bch = ((size_t)b * nc + c) * H + h;
      const size_t t0 = (size_t)b * S + (size_t)c * Q;
      const float* c_h = cs + bch * Q;
      const float cl = c_h[Q - 1];
      double dcs[kPerQ], part[kPerQ], dtv[kPerQ];
      double wdw = 0.0;
#pragma unroll
      for (int e = 0; e < kPerQ; ++e) {
        const int q = q_lo + e;
        dcs[e] = part[e] = dtv[e] = 0.0;
        if (e >= per || q >= Q) continue;
        const int it = q / kT;
        double dw = 0.0, carry = 0.0;
        for (int pt = 0; pt < npt; ++pt) {
          dw += part_dw[(bch * npt + pt) * Q + q];
          carry += part_carry[(bch * npt + pt) * Q + q];
        }
        double quad = 0.0, z = 0.0;
        for (int j = 0; j <= it; ++j) quad += rowT[(bch * nqt + j) * Q + q];
        for (int i = it; i < nqt; ++i) {
          quad -= colT[(bch * nqt + i) * Q + q];
          z += colZ[(bch * nqt + i) * Q + q];
        }
        dtv[e] = dt[(t0 + q) * H + h];
        const double decay = expf(cl - c_h[q]), w = decay * dtv[e];
        dcs[e] = carry + quad - w * dw;
        part[e] = decay * dw + z;
        wdw += w * dw;
      }
      // sum_k w_k dw_k and the state pass's decay term, at the last position
      const double wdw_sum = block_sum(wdw, red);
      const int e_last = (Q - 1) - q_lo;
      if (e_last >= 0 && e_last < per) {
        double extra = wdw_sum;
        for (int i = 0; i < nblk; ++i) extra += part_decay[bch * nblk + i];
#pragma unroll
        for (int e = 0; e < kPerQ; ++e)
          if (e == e_last) dcs[e] += extra;
      }
      // reverse cumsum: this thread's segment total, the totals of the
      // segments after it (thread 0, in order), then inside the segment
      double seg = 0.0;
#pragma unroll
      for (int e = 0; e < kPerQ; ++e) seg += dcs[e];
      __syncthreads();  // every thread has read block_sum's red[0]
      red[tid] = seg;
      __syncthreads();
      if (tid == 0) {
        double after = 0.0;
        for (int t = kThreads - 1; t >= 0; --t) {
          const double v = red[t];
          red[t] = after;
          after += v;
        }
      }
      __syncthreads();
      double run = red[tid], dadt = 0.0;
#pragma unroll
      for (int e = kPerQ - 1; e >= 0; --e) {
        const int q = q_lo + e;
        if (e >= per || q >= Q) continue;
        run += dcs[e];
        ddt[(t0 + q) * H + h] = (float)(part[e] + run * a);
        dadt += run * dtv[e];
      }
      const double sum = block_sum(dadt, red);
      if (tid == 0) dA_acc += sum;
    }
  }
  if (tid == 0) dA[h] = (float)dA_acc;
}

size_t align4(size_t n) { return (n + 3) / 4 * 4; }

// The scratch the launcher carves up, in floats: dh / G (the state
// gradients), dCB per head and per group (float32), and the float64 partial
// sums for d cs, ddt and dA (two floats each).
struct Scratch {
  size_t dst, dCBh, dCBg, rowT, colT, colZ, part_carry, part_dw, part_decay, total;
  Scratch(int B, int S, int H, int G, int P, int N, int Q) {
    const size_t nc = S / Q, bcH = (size_t)B * nc * H;
    const size_t nqt = (Q + kT - 1) / kT, npt = (P + kT - 1) / kT;
    const size_t nblk = ((size_t)N * P + kThreads - 1) / kThreads;
    size_t off = 0;
    auto take = [&](size_t floats) {
      const size_t at = off;
      off += align4(floats);
      return at;
    };
    dst = take(bcH * N * P);
    dCBh = take(bcH * Q * Q);
    dCBg = G == H ? dCBh : take((size_t)B * nc * G * Q * Q);
    rowT = take(2 * bcH * nqt * Q);
    colT = take(2 * bcH * nqt * Q);
    colZ = take(2 * bcH * nqt * Q);
    part_carry = take(2 * bcH * npt * Q);
    part_dw = take(2 * bcH * npt * Q);
    part_decay = take(2 * bcH * nblk);
    total = off;
  }
};

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                   const void* dy, const float* d_final, const float* CB, const float* cs,
                   const float* st, void* dx, float* ddt, float* dA, void* dB, void* dC,
                   float* d_init, float* work, int B, int S, int H, int G, int P, int N, int Q,
                   cudaStream_t stream) {
  const int nc = S / Q;
  const int nqt = (Q + kT - 1) / kT, nnt = (N + kT - 1) / kT, npt = (P + kT - 1) / kT;
  const int nblk = (N * P + kThreads - 1) / kThreads;
  const Scratch sc(B, S, H, G, P, N, Q);
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  float* dst = work + sc.dst;
  float* dCBh = work + sc.dCBh;
  float* dCBg = work + sc.dCBg;
  auto f64 = [&](size_t at) { return reinterpret_cast<double*>(work + at); };
  double* rowT = f64(sc.rowT);
  double* colT = f64(sc.colT);
  double* colZ = f64(sc.colZ);
  double* part_carry = f64(sc.part_carry);
  double* part_dw = f64(sc.part_dw);
  double* part_decay = f64(sc.part_decay);
  bwd_prep<T><<<dim3(nnt * npt + nqt * nqt, H, B * nc), kThreads, 0, stream>>>(
      xt, dt, Ct, dyt, CB, cs, dst, dCBh, rowT, colT, colZ, S, H, G, P, N, Q, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_bwd<<<dim3(nblk, H, B), kThreads, 0, stream>>>(dst, st, cs, d_final, d_init, part_decay,
                                                       H, P, N, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (G != H) {
    dcb_reduce<<<dim3((Q * Q + kThreads - 1) / kThreads, G, B * nc), kThreads, 0, stream>>>(
        dCBh, dCBg, H, G, Q);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  chunk_grads<T><<<dim3(2 * nqt * nnt * G + nqt * npt * H, B * nc), kThreads, 0, stream>>>(
      xt, dt, Bt, Ct, dyt, CB, cs, st, dst, dCBg, static_cast<T*>(dx), static_cast<T*>(dB),
      static_cast<T*>(dC), part_carry, part_dw, S, H, G, P, N, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dt_bwd<<<H, kThreads, 0, stream>>>(dt, A, cs, rowT, colT, colZ, part_carry, part_dw, part_decay,
                                     ddt, dA, B, S, H, P, N, Q, nc);
  return cudaGetLastError();
}

bool valid(int B, int S, int H, int G, int P, int N, int Q) {
  return B >= 1 && Q >= 1 && Q <= kMaxQ && S >= Q && S % Q == 0 && G >= 1 && H % G == 0 &&
         P >= 1 && N >= 1 && B * (S / Q) <= 65535 && H <= 65535;
}

}  // namespace

// Floats of the scratch ssd_scan_bwd_launch needs (0 for invalid shapes).
extern "C" long long ssd_scan_bwd_scratch_floats(int B, int S, int H, int G, int P, int N,
                                                 int Q) {
  return valid(B, S, H, G, P, N, Q) ? (long long)Scratch(B, S, H, G, P, N, Q).total : 0;
}

// x, dy, dx: (B, S, H, P); dt, ddt: (B, S, H); A, dA: (H,); Bm, Cm, dB, dC:
// (B, S, G, N); d_final (may be null: zero) and d_init: (B, H, P, N).  From
// the forward (ssd_scan_launch with the same inputs): CB (B, S/Q, G, Q, Q),
// cs (B, S/Q, H, Q) and st (B, S/Q, H, N, P), the state entering each chunk.
// work: ssd_scan_bwd_scratch_floats() floats of scratch, 16-byte aligned.  S a
// multiple of Q, Q at most 1024, H a multiple of G; x, Bm, Cm, dy, dx, dB
// and dC are bfloat16 when is_bf16.  Five launches (four when G == H) on
// `stream`.
extern "C" int ssd_scan_bwd_launch(const void* x, const float* dt, const float* A, const void* Bm,
                                   const void* Cm, const void* dy, const float* d_final,
                                   const float* CB, const float* cs, const float* st, void* dx,
                                   float* ddt, float* dA, void* dB, void* dC, float* d_init,
                                   float* work, int B, int S, int H, int G, int P, int N, int Q,
                                   int is_bf16, void* stream) {
  if (!valid(B, S, H, G, P, N, Q)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, d_final, CB, cs, st, dx, ddt, dA, dB, dC,
                              d_init, work, B, S, H, G, P, N, Q, s)
      : launch<float>(x, dt, A, Bm, Cm, dy, d_final, CB, cs, st, dx, ddt, dA, dB, dC, d_init,
                      work, B, S, H, G, P, N, Q, s));
}
