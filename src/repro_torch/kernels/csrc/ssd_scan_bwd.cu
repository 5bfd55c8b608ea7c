// The gradient of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a).
//
// No TPU kernel: the JAX package differentiates its einsum form, ssd_chunked
// in models/mamba.py, by autodiff.  Same function as
// kernels/ref.py::ssd_scan_bwd_ref, whose docstring sets out the chunked
// decomposition this kernel follows.  x, B, C, dy and dx, dB, dC may be
// float32 or bfloat16; dt, A, the states and every other gradient are
// float32.  B and C have G groups; head h reads group h / (H / G).
//
// It starts from the forward's own scratch: CB = C.B^T per (batch, chunk,
// group), the chunk cumsums cs and the state entering each chunk, so no
// forward pass is repeated.
//
// What bounds it on this card: operations.  At mamba2-130m width (H=24,
// P=64, N=128, Q=256) one layer at B=2, S=1024 does ~5 GFLOP counted once,
// about twice the forward's, and moves ~50 MB.  The products run on the
// tensor cores in split-precision TF32 (3xTF32, as CUTLASS's
// OpMultiplyAddFastF32): a float32 operand x is big = tf32(x) plus small =
// tf32(x - big), a.b is small.big + big.small + big.big, each term exact in
// float32 and summed in float32; the dropped small.small is ~2^-22 |a||b|,
// so each product stays within ~2^-21 of its terms' magnitude, far under
// the 1e-4 / 1e-3 the gradients are held to, also where |cs| reaches
// hundreds over a chunk (one TF32 product, ~2^-11, misses it:
// tests/test_torch_tf32x3.py); each 8-deep step goes into a fresh
// accumulator added to the running sum in float32, as the tensor cores
// truncate what they accumulate.  Three TF32 products at 495 TFLOP/s bound
// the float32 work at ~165 TFLOP/s.  What holds the call above that is the
// staging of each 64 x 64 operand tile (scalar loads, their addresses and
// the decays' exponentials computed as they are staged) and its longest
// chain of dependent stages in one CTA; so the per-group sums of dC and dB
// are split across CTAs by slices of kSlice heads.
//
// Design.  Six launches on one stream, in the forward's three parts
// reversed, and five when G == H:
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
//      dC per (batch, chunk, group, head slice, q tile, n tile): sum over
//          the slice's heads of exp(cs_q) dy_q h, and in the first slice
//          sum_k dCB_qk B_k;
//      dB per (batch, chunk, group, head slice, k tile, n tile): sum over
//          the slice's heads of w_k G^T x_k, and in the first slice
//          sum_q dCB_qk C_q;
//      dx per (batch, chunk, head, k tile, p tile): V = C h^T (its rows'
//          dots with dy give the carried d cs), U = B G^T (its rows' dots
//          with x give dw), then dx = w U + sum_q M_qk dy_q.
//      Each dC and dB CTA writes its slice's float32 partial, and
//   4b. slice_sum adds the partials in slice order into dC and dB.
//      The three kinds of chunk_grads are device functions compiled apart
//      (__noinline__): inlined into one kernel they spilled 1,256 bytes a
//      thread at the 128-register cap, apart 52-212 bytes each.
//   5. dt_bwd: per head, over (batch, chunk) in order: every d cs gathered
//      from the partial sums above, the reverse cumsum inside the chunk
//      (da), ddt, and dA = sum of da dt.
// They count as one launch.  Every product goes through mma_stages: 256
// threads, operands staged 64 x 64 at a time through shared memory, each
// element split into its TF32 halves once as it is staged (the next stage's
// loads in flight while the current one's products run), each warp a 16 x
// 32 share of the output tile in mma.sync m16n8k8 fragments.  No
// atomics: every sum that crosses threads or CTAs (dB and dC over a group's
// heads and slices, the row and column sums, dA over batch and positions)
// is taken in a fixed order, so two runs agree bit for bit.  The sums that
// cancel are taken in float64: the row and column sums of T, the partial
// sums of d cs, its reverse cumsum, dA (and the state pass's sum of G * h);
// the products stay float32.  Decays are exponentials of differences on and
// below the diagonal, never quotients of exponentials.  Padded rows (dt =
// 0, x = B = C = 0) get gradients that the caller cuts off; they leave the
// state gradient alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, each a 16 x 32 share of a 64 x 64 output tile
constexpr int kT = 64;         // tile edge
constexpr int kMaxQ = 1024;    // longest chunk (cumsum and dt staged whole)
constexpr int kLd = kT + 8;    // row of a staged 64-wide tile (see at())
constexpr int kPer = kT * kT / kThreads;  // staged elements per thread
constexpr int kPerQ = kMaxQ / kThreads;   // chunk positions per thread in dt_bwd
constexpr int kSlice = 8;      // heads of a group that one dC or dB CTA sums
// dynamic shared memory of bwd_prep and chunk_grads: mma_stages' two split
// tiles, then the chunk's cumsum and dt
constexpr size_t kSmem = sizeof(float) * (4 * kT * kLd + 2 * kMaxQ);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// element (r, c) of a staged 64 x kLd tile: rows 4-7 mod 8 swap their
// 8-column groups, so that the paired loads along a row and the loads of
// rows 2t and 2t + 1 both hit 32 distinct banks
__device__ __forceinline__ int at(int r, int c) { return r * kLd + (c ^ ((r & 4) << 1)); }

// The dynamic shared memory of bwd_prep and chunk_grads, named in each
// function that uses it (so that the compiler knows the pointers are
// shared in the functions compiled apart): mma_stages' two split tiles,
// the chunk's cumsum and dt of the CTA's head.
struct Smem {
  float *As, *Bs, *csh, *dts;
};
__device__ __forceinline__ Smem smem_parts() {
  extern __shared__ __align__(16) float smem[];
  return Smem{smem, smem + 2 * kT * kLd, smem + 4 * kT * kLd, smem + 4 * kT * kLd + kMaxQ};
}

// This thread's share of a 64 x 64 accumulator tile, acc[nt][e]: warp w
// holds rows 16 (w / 2) .. + 16 and columns 32 (w % 2) .. + 32 as four
// m16n8 tiles; element e of tile nt is at (frag_row(e), frag_col(nt, e)).
__device__ __forceinline__ int frag_row(int e) {
  return threadIdx.x / 64 * 16 + threadIdx.x % 32 / 4 + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int nt, int e) {
  return threadIdx.x / 32 % 2 * 32 + nt * 8 + threadIdx.x % 4 * 2 + (e & 1);
}

// x rounded to TF32 (to nearest, ties away from zero, as cvt.rna.tf32.f32
// for finite x: two integer operations where cvt takes about four)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A split-precision TF32 operand: big = tf32(x), small = tf32(x - big)
template <int N> struct Frag {
  uint32_t big[N], small[N];
};
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b over one 8-deep step in split precision, the small terms first.
// The tensor cores truncate what they accumulate, so the step is summed into
// a fresh accumulator and added to d in float32, rounding to nearest.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  float step[4] = {0.f, 0.f, 0.f, 0.f};
  mma(step, a.big, b.small);
  mma(step, a.small, b.big);
  mma(step, a.big, b.big);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += step[e];
}

// acc[nt][e] += sum over nst stages of sum_d A_s[row][d] * Bt_s[d][col], each
// stage a 64-deep slice: fa(s, r, d) gives A_s's element (row r, depth d),
// fb(s, d, c) gives Bt_s's (depth d, column c), zero outside the data.
// Thread t stages elements (t / 64 + 4 i, t % 64) of each tile, or with
// kTransA / kTransB their transposes (t % 64, t / 64 + 4 i): the flag names
// the operand whose first index runs along memory, so that neighbouring
// threads read neighbouring addresses.  Either way thread t writes staged
// element (t / 64 + 4 i, t % 64): A is staged (row, depth), or (depth, row)
// with kTransA; B (depth, column), or (column, depth) with kTransB.  Each
// element is split once as it is staged, into the big and small halves of
// As and Bs (two kT x kLd tiles each, big first).  The next stage is fetched
// into registers while the current one's products run on the tensor cores:
// mma.sync m16n8k8 in split-precision TF32, each warp its 16 x 32 share,
// k-slot t standing for depth 2t and slot t + 4 for 2t + 1 of each 8-deep
// step in both operands.
template <bool kTransA, bool kTransB, class FA, class FB>
__device__ __forceinline__ void mma_stages(float (&acc)[4][4], int nst, FA fa, FB fb,
                                           float* As, float* Bs) {
  constexpr int kTile = kT * kLd;
  const int tid = threadIdx.x, g = tid % 32 / 4, t = tid % 4;
  const int m0 = tid / 64 * 16, n0 = tid / 32 % 2 * 32;
  const int col = tid % kT, row0 = tid / kT;
  uint32_t* Au = reinterpret_cast<uint32_t*>(As);
  uint32_t* Bu = reinterpret_cast<uint32_t*>(Bs);
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
      const int at_i = at(row0 + 4 * i, col);
      const uint32_t a = tf32(ra[i]), b = tf32(rb[i]);
      Au[at_i] = a;
      Au[kTile + at_i] = tf32(ra[i] - __uint_as_float(a));
      Bu[at_i] = b;
      Bu[kTile + at_i] = tf32(rb[i] - __uint_as_float(b));
    }
    __syncthreads();
    if (s + 1 < nst) fetch(s + 1);  // in flight while this stage's products run
#pragma unroll 1  // unrolled further, the fetched stage and the fragments spill more
    for (int kk = 0; kk < kT; kk += 8) {
      Frag<4> a;
      if (kTransA) {  // staged (depth, row)
        const int i0 = at(kk + 2 * t, m0 + g), i1 = at(kk + 2 * t, m0 + g + 8);
        const int i2 = at(kk + 2 * t + 1, m0 + g), i3 = at(kk + 2 * t + 1, m0 + g + 8);
        a.big[0] = Au[i0], a.big[1] = Au[i1], a.big[2] = Au[i2], a.big[3] = Au[i3];
        a.small[0] = Au[kTile + i0], a.small[1] = Au[kTile + i1];
        a.small[2] = Au[kTile + i2], a.small[3] = Au[kTile + i3];
      } else {  // staged (row, depth)
        const int i0 = at(m0 + g, kk + 2 * t), i1 = i0 + 8 * kLd;
        const uint2 lo = *reinterpret_cast<const uint2*>(&Au[i0]);
        const uint2 hi = *reinterpret_cast<const uint2*>(&Au[i1]);
        const uint2 los = *reinterpret_cast<const uint2*>(&Au[kTile + i0]);
        const uint2 his = *reinterpret_cast<const uint2*>(&Au[kTile + i1]);
        a.big[0] = lo.x, a.big[1] = hi.x, a.big[2] = lo.y, a.big[3] = hi.y;
        a.small[0] = los.x, a.small[1] = his.x, a.small[2] = los.y, a.small[3] = his.y;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + nt * 8 + g;
        Frag<2> b;
        if (kTransB) {  // staged (column, depth)
          const int i0 = at(n, kk + 2 * t);
          const uint2 v = *reinterpret_cast<const uint2*>(&Bu[i0]);
          const uint2 w = *reinterpret_cast<const uint2*>(&Bu[kTile + i0]);
          b.big[0] = v.x, b.big[1] = v.y, b.small[0] = w.x, b.small[1] = w.y;
        } else {  // staged (depth, column)
          const int i0 = at(kk + 2 * t, n), i1 = at(kk + 2 * t + 1, n);
          b.big[0] = Bu[i0], b.big[1] = Bu[i1], b.small[0] = Bu[kTile + i0];
          b.small[1] = Bu[kTile + i1];
        }
        mma3(acc[nt], a, b);
      }
    }
  }
  __syncthreads();  // As and Bs are free for the caller
}

// Sums of the 64 rows of a 64 x kLd shared tile in float64, in a fixed
// order: thread t sums the 16 columns [16 (t / 64), + 16) of row t % 64,
// then threads 0-63 add the four quarters in order into sums[row].
// `part` holds 256 doubles; the caller synchronises before the call.
__device__ __forceinline__ void sum_rows(const float* tile, double* part, double* sums) {
  const int tid = threadIdx.x, r = tid % kT, q = tid / kT;
  double s = 0.0;
#pragma unroll
  for (int c = 0; c < 16; ++c) s += tile[r * kLd + q * 16 + c];
  part[tid] = s;
  __syncthreads();
  if (tid < kT) sums[tid] = ((part[tid] + part[tid + kT]) + part[tid + 2 * kT]) + part[tid + 3 * kT];
  __syncthreads();
}

// The sums over each row of a 64 x 64 tile held as the threads' accumulator
// shares (frag_row, frag_col), in float64 (sum_rows), through `red`, a 64 x
// kLd shared tile, into sums[row]; `part` holds 256 doubles.
__device__ __forceinline__ void row_sums(const float (&v)[4][4], float* red, double* part,
                                         double* sums) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[frag_row(e) * kLd + frag_col(nt, e)] = v[nt][e];
  __syncthreads();
  sum_rows(red, part, sums);
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
                            float* __restrict__ dst, int nt, int pt, int h, int bc, int S, int H,
                            int G, int P, int N, int Q, int nc) {
  const Smem sm = smem_parts();
  const float* csh = sm.csh;
  float *As = sm.As, *Bs = sm.Bs;
  const int b = bc / nc, c = bc % nc, g = h / (H / G);
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
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + frag_row(e), p = p0 + frag_col(f, e);
      if (n < N && p < P) out[(size_t)n * P + p] = acc[f][e];
    }
}

// (b) For the tile pair (qt, kt), kt <= qt, of head h: D = dy_q . x_k, then
// dCBh = D e dt_k (e = exp(cs_q - cs_k) for k <= q, else 0) written out, and
// the row sums of T = Z dt_k into rowT[kt], the column sums of T into
// colT[qt] and of Z = D CB e into colZ[qt].
template <typename T>
__device__ void pair_tile(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ CB, float* __restrict__ dCBh,
                          double* __restrict__ rowT, double* __restrict__ colT,
                          double* __restrict__ colZ, int qt, int kt, int h, int bc, int S, int H,
                          int G, int P, int Q, int nc) {
  const Smem sm = smem_parts();
  const float *csh = sm.csh, *dts = sm.dts;
  float *As = sm.As, *Bs = sm.Bs;
  const int b = bc / nc, c = bc % nc, g = h / (H / G);
  const int tid = threadIdx.x;
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
  // T = Z dt_k by rows, T and Z = D CB e transposed, each written to shared
  // memory as it is formed; then the row sums of T (over this tile's k) and
  // the column sums of T and Z (over q), in float64
  constexpr int kTile = kT * kLd;
  float* Trow = As;
  float* Tcol = As + kTile;
  float* Zcol = Bs + kTile;
  double* part = reinterpret_cast<double*>(Bs);  // 256 doubles, then 64 sums
  double* sums = part + kThreads;
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = frag_row(j), cc = frag_col(f, j), q = q0 + r, k = k0 + cc;
      const bool live = k <= q && q < Q;
      const float e = live ? expf(csh[q] - csh[k]) : 0.f;
      const float dtk = live ? dts[k] : 0.f;
      const float cbv = live ? cb[(size_t)q * Q + k] : 0.f;
      const float z = acc[f][j] * cbv * e;
      Trow[r * kLd + cc] = Tcol[cc * kLd + r] = z * dtk;
      Zcol[cc * kLd + r] = z;
      if (q < Q && k < Q) dcb[(size_t)q * Q + k] = acc[f][j] * e * dtk;
    }
  __syncthreads();
  sum_rows(Trow, part, sums);
  if (tid < kT && q0 + tid < Q) rowT[(bch * nqt + kt) * Q + q0 + tid] = sums[tid];
  sum_rows(Tcol, part, sums);
  if (tid < kT && k0 + tid < Q) colT[(bch * nqt + qt) * Q + k0 + tid] = sums[tid];
  sum_rows(Zcol, part, sums);
  if (tid < kT && k0 + tid < Q) colZ[(bch * nqt + qt) * Q + k0 + tid] = sums[tid];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bwd_prep(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Cm,
         const T* __restrict__ dy, const float* __restrict__ CB, const float* __restrict__ cs,
         float* __restrict__ dst, float* __restrict__ dCBh, double* __restrict__ rowT,
         double* __restrict__ colT, double* __restrict__ colZ, int S, int H, int G, int P, int N,
         int Q, int nc) {
  const int nnt = (N + kT - 1) / kT, npt = (P + kT - 1) / kT, nqt = (Q + kT - 1) / kT;
  const int bx = blockIdx.x, h = blockIdx.y, bc = blockIdx.z;
  const int ncarry = nnt * npt;
  if (bx >= ncarry) {
    const int tile = bx - ncarry, qt = tile / nqt, kt = tile % nqt;
    if (kt > qt) return;  // above the diagonal: all zero, never read
  }
  const Smem sm = smem_parts();
  load_cs(cs, (size_t)bc * H + h, Q, sm.csh);
  if (bx >= ncarry) {  // the pair tiles read dt of the chunk
    const size_t t0 = (size_t)(bc / nc) * S + (size_t)(bc % nc) * Q;
    for (int q = threadIdx.x; q < Q; q += kThreads) sm.dts[q] = dt[(t0 + q) * H + h];
  }
  __syncthreads();
  if (bx < ncarry) {
    carry_state<T>(dy, Cm, dst, bx % nnt, bx / nnt, h, bc, S, H, G, P, N, Q, nc);
  } else {
    const int tile = bx - ncarry;
    pair_tile<T>(x, dy, CB, dCBh, rowT, colT, colZ, tile / nqt, tile % nqt, h, bc, S, H, G, P, Q,
                 nc);
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
// The heads [h_lo, h_hi) of group g that one dC or dB CTA sums: slice sl of
// kSlice heads.
struct Slice {
  int h_lo, h_hi, sl;
};

// Writes this thread's share of a dC or dB tile to the slice's float32
// partial (the tile's (row, n) of part[b, c, g, sl], Q x N) for slice_sum.
__device__ __forceinline__ void store_rows(const float (&acc)[4][4], float* __restrict__ part,
                                           int r0, int n0, int g, int bc, Slice sl, int nsl,
                                           int G, int N, int Q) {
  float* pt = part + (((size_t)bc * G + g) * nsl + sl.sl) * Q * N;
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + frag_row(e), n = n0 + frag_col(f, e);
      if (r < Q && n < N) pt[(size_t)r * N + n] = acc[f][e];
    }
}

// dC for one (q tile, n tile) of group g, slice sl of its heads: the sum
// over the slice's heads of exp(cs_q) dy_q h_c, and for the first slice
// sum_{k <= q} dCB_qk B_k.
template <typename T>
__device__ __noinline__ void grad_C(const T* __restrict__ dy, const T* __restrict__ Bm,
                                    const float* __restrict__ cs, const float* __restrict__ st,
                                    const float* __restrict__ dCBg,
                                    float* __restrict__ part, int qt, int nt, int g, Slice sl,
                                    int nsl, int bc, int S, int H, int G, int P, int N, int Q,
                                    int nc) {
  const Smem sm = smem_parts();
  float *As = sm.As, *Bs = sm.Bs;
  const int b = bc / nc, c = bc % nc;
  const int q0 = qt * kT, n0 = nt * kT, npt = (P + kT - 1) / kT;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  float acc[4][4] = {};
  // carried: stage s is slice s % npt of P of head h_lo + s / npt
  mma_stages<false, true>(
      acc, (sl.h_hi - sl.h_lo) * npt,
      [&](int s, int r, int d) {  // (q, p): exp(cs_q) dy_q[p] of the stage's head
        const int h = sl.h_lo + s / npt, q = q0 + r, p = (s % npt) * kT + d;
        return q < Q && p < P
                   ? expf(cs[((size_t)bc * H + h) * Q + q]) *
                         to_f(dy[((t0 + q) * H + h) * P + p])
                   : 0.f;
      },
      [&](int s, int d, int cc) {  // (p, n): h_c[n][p]
        const int h = sl.h_lo + s / npt, p = (s % npt) * kT + d, n = n0 + cc;
        return p < P && n < N ? st[(((size_t)bc * H + h) * N + n) * P + p] : 0.f;
      },
      As, Bs);
  const float* dcb = dCBg + ((size_t)bc * G + g) * Q * Q;
  mma_stages<false, false>(
      acc, sl.sl == 0 ? qt + 1 : 0,
      [&](int s, int r, int d) {  // (q, k): dCB_qk, k <= q
        const int q = q0 + r, k = s * kT + d;
        return k <= q && q < Q ? dcb[(size_t)q * Q + k] : 0.f;
      },
      [&](int s, int d, int cc) {  // (k, n): B_k[n]
        const int k = s * kT + d, n = n0 + cc;
        return k < Q && n < N ? to_f(Bm[((t0 + k) * G + g) * N + n]) : 0.f;
      },
      As, Bs);
  store_rows(acc, part, q0, n0, g, bc, sl, nsl, G, N, Q);
}

// dB for one (k tile, n tile) of group g, slice sl of its heads: the sum
// over the slice's heads of w_k G^T x_k (w_k = exp(cs_last - cs_k) dt_k),
// and for the first slice sum_{q >= k} dCB_qk C_q.
template <typename T>
__device__ __noinline__ void grad_B(const T* __restrict__ x, const float* __restrict__ dt,
                                    const T* __restrict__ Cm, const float* __restrict__ cs,
                                    const float* __restrict__ dst, const float* __restrict__ dCBg,
                                    float* __restrict__ part, int kt, int nt,
                                    int g, Slice sl, int nsl, int bc, int S, int H, int G, int P,
                                    int N, int Q, int nc) {
  const Smem sm = smem_parts();
  float *As = sm.As, *Bs = sm.Bs;
  const int b = bc / nc, c = bc % nc;
  const int k0 = kt * kT, n0 = nt * kT, npt = (P + kT - 1) / kT, nqt = (Q + kT - 1) / kT;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  float acc[4][4] = {};
  mma_stages<false, true>(
      acc, (sl.h_hi - sl.h_lo) * npt,
      [&](int s, int r, int d) {  // (k, p): w_k x_k[p] of the stage's head
        const int h = sl.h_lo + s / npt, k = k0 + r, p = (s % npt) * kT + d;
        if (k >= Q || p >= P) return 0.f;
        const float* c_h = cs + ((size_t)bc * H + h) * Q;
        const float w = expf(c_h[Q - 1] - c_h[k]) * dt[(t0 + k) * H + h];
        return w * to_f(x[((t0 + k) * H + h) * P + p]);
      },
      [&](int s, int d, int cc) {  // (p, n): G_c[n][p]
        const int h = sl.h_lo + s / npt, p = (s % npt) * kT + d, n = n0 + cc;
        return p < P && n < N ? dst[(((size_t)bc * H + h) * N + n) * P + p] : 0.f;
      },
      As, Bs);
  const float* dcb = dCBg + ((size_t)bc * G + g) * Q * Q;
  mma_stages<true, false>(
      acc, sl.sl == 0 ? nqt - kt : 0,
      [&](int s, int r, int d) {  // (k, q): dCB_qk, q >= k
        const int k = k0 + r, q = (kt + s) * kT + d;
        return k <= q && q < Q ? dcb[(size_t)q * Q + k] : 0.f;
      },
      [&](int s, int d, int cc) {  // (q, n): C_q[n]
        const int q = (kt + s) * kT + d, n = n0 + cc;
        return q < Q && n < N ? to_f(Cm[((t0 + q) * G + g) * N + n]) : 0.f;
      },
      As, Bs);
  store_rows(acc, part, k0, n0, g, bc, sl, nsl, G, N, Q);
}

// dx for one (k tile, p tile) of head h, and this p tile's share of two row
// dots: part_carry[k] = exp(cs_k) dy_k . V_k with V = C h_c^T (the carried
// term's d cs) and part_dw[k] = x_k . U_k with U = B G_c^T; then dx = w U +
// sum_{q >= k} M_qk dy_q, M_qk = CB_qk exp(cs_q - cs_k) dt_k.
template <typename T>
__device__ __noinline__ void grad_x(const T* __restrict__ x, const float* __restrict__ dt,
                                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                                    const T* __restrict__ dy, const float* __restrict__ CB,
                                    const float* __restrict__ cs, const float* __restrict__ st,
                                    const float* __restrict__ dst, T* __restrict__ dx,
                                    double* __restrict__ part_carry, double* __restrict__ part_dw,
                                    int kt, int pt, int h, int bc, int S, int H, int G, int P,
                                    int N, int Q, int nc) {
  const Smem sm = smem_parts();
  float *As = sm.As, *Bs = sm.Bs, *csh = sm.csh, *dts = sm.dts;
  const int b = bc / nc, c = bc % nc, g = h / (H / G);
  const int tid = threadIdx.x;
  const int k0 = kt * kT, p0 = pt * kT;
  const int nnt = (N + kT - 1) / kT, npt = (P + kT - 1) / kT, nqt = (Q + kT - 1) / kT;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t bch = (size_t)bc * H + h;
  load_cs(cs, bch, Q, csh);
  for (int q = tid; q < Q; q += kThreads) dts[q] = dt[(t0 + q) * H + h];
  __syncthreads();
  auto at_kp = [&](const T* m, int f, int e) {  // m (B, S, H, P) at element (f, e)'s (k, p)
    const int k = k0 + frag_row(e), p = p0 + frag_col(f, e);
    return k < Q && p < P ? to_f(m[((t0 + k) * H + h) * P + p]) : 0.f;
  };
  double* part = reinterpret_cast<double*>(Bs);  // 256 doubles, then 64 sums; row_sums
  double* sums = part + kThreads;                 // reduces through As
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
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] *= at_kp(dy, f, e);
  row_sums(acc, As, part, sums);
  if (tid < kT && k0 + tid < Q)
    part_carry[(bch * npt + pt) * Q + k0 + tid] = (double)expf(csh[k0 + tid]) * sums[tid];

  // U = B G_c^T, x_k . U_k over this p tile, then dx = w U
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  mma_stages<false, false>(acc, nnt, rows_of(Bm), slice(dst + bch * N * P), As, Bs);
  float xu[4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) xu[f][e] = acc[f][e] * at_kp(x, f, e);
  row_sums(xu, As, part, sums);
  if (tid < kT && k0 + tid < Q) part_dw[(bch * npt + pt) * Q + k0 + tid] = sums[tid];
  const float cl = csh[Q - 1];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = k0 + frag_row(e);
    const float w = k < Q ? expf(cl - csh[k]) * dts[k] : 0.f;
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[f][e] *= w;
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
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + frag_row(e), p = p0 + frag_col(f, e);
      if (k < Q && p < P) store(&dx[((t0 + k) * H + h) * P + p], acc[f][e]);
    }
}

// dC and dB CTAs first (their chains over a slice's heads are the longest,
// the first slice's with the dCB term first of all), then dx: x < 2 nqt nnt
// G nsl are (dC, dB) tiles, the rest dx tiles; y is the (batch, chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_grads(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const T* __restrict__ dy, const float* __restrict__ CB,
            const float* __restrict__ cs, const float* __restrict__ st,
            const float* __restrict__ dst, const float* __restrict__ dCBg, T* __restrict__ dx,
            float* __restrict__ part_dB,
            float* __restrict__ part_dC, double* __restrict__ part_carry,
            double* __restrict__ part_dw, int S, int H, int G, int P, int N, int Q, int nc) {
  const int nnt = (N + kT - 1) / kT, npt = (P + kT - 1) / kT, nqt = (Q + kT - 1) / kT;
  const int rep = H / G, nsl = (rep + kSlice - 1) / kSlice;
  const int per_kind = nqt * nnt * G * nsl, bc = blockIdx.y;
  int u = blockIdx.x;
  if (u < 2 * per_kind) {
    // u = ((sl * G + g) * 2 + kind) * nqt * nnt + tile: slice 0 of every
    // group, dC and dB, first
    const int tile = u % (nqt * nnt), t = tile / nnt, nt = tile % nnt;
    u /= nqt * nnt;
    const int kind = u % 2, g = u / 2 % G, s = u / 2 / G;
    const Slice sl{g * rep + s * kSlice, min(g * rep + (s + 1) * kSlice, (g + 1) * rep), s};
    if (kind == 0)
      grad_C<T>(dy, Bm, cs, st, dCBg, part_dC, t, nt, g, sl, nsl, bc, S, H, G, P, N, Q, nc);
    else
      grad_B<T>(x, dt, Cm, cs, dst, dCBg, part_dB, t, nt, g, sl, nsl, bc, S, H, G, P, N, Q, nc);
    return;
  }
  u -= 2 * per_kind;
  const int h = u / (nqt * npt), tile = u % (nqt * npt);
  grad_x<T>(x, dt, Bm, Cm, dy, CB, cs, st, dst, dx, part_carry, part_dw, tile / npt, tile % npt,
            h, bc, S, H, G, P, N, Q, nc);
}

// dC and dB (y = kind * G + g, kind 0 and 1) summed over the slices' partials in slice order and cast
// to the output type; x runs over the (row, n) of one chunk, z is the
// (batch, chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads)
slice_sum(const float* __restrict__ part_dC, const float* __restrict__ part_dB,
          T* __restrict__ dC, T* __restrict__ dB, int S, int G, int N, int Q, int nc, int nsl) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= Q * N) return;
  const int kind = blockIdx.y / G, g = blockIdx.y % G, bc = blockIdx.z, b = bc / nc, c = bc % nc;
  const float* src =
      (kind == 0 ? part_dC : part_dB) + ((size_t)bc * G + g) * nsl * Q * N + e;
  float s = 0.f;
  for (int i = 0; i < nsl; ++i) s += src[(size_t)i * Q * N];
  const int r = e / N, n = e % N;
  T* out = kind == 0 ? dC : dB;
  store(&out[(((size_t)b * S + (size_t)c * Q + r) * G + g) * N + n], s);
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

// Slices of kSlice heads in each group of H / G.
int slices(int H, int G) { return (H / G + kSlice - 1) / kSlice; }

// The scratch the launcher carves up, in floats: dh / G (the state
// gradients), dCB per head and per group, dC and dB per head slice
// (float32), and the float64 partial sums for d cs, ddt
// and dA (two floats each).
struct Scratch {
  size_t dst, dCBh, dCBg, part_dC, part_dB, rowT, colT, colZ, part_carry, part_dw, part_decay,
      total;
  Scratch(int B, int S, int H, int G, int P, int N, int Q) {
    const size_t nc = S / Q, bcH = (size_t)B * nc * H;
    const size_t nqt = (Q + kT - 1) / kT, npt = (P + kT - 1) / kT;
    const size_t nblk = ((size_t)N * P + kThreads - 1) / kThreads;
    const size_t per_slice = B * nc * G * slices(H, G) * Q * N;
    size_t off = 0;
    auto take = [&](size_t floats) {
      const size_t at = off;
      off += align4(floats);
      return at;
    };
    dst = take(bcH * N * P);
    dCBh = take(bcH * Q * Q);
    dCBg = G == H ? dCBh : take((size_t)B * nc * G * Q * Q);
    part_dC = take(per_slice);
    part_dB = take(per_slice);
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
  const int nblk = (N * P + kThreads - 1) / kThreads, nsl = slices(H, G);
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
  static bool opted_in = false;  // the attributes are set once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(bwd_prep<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chunk_grads<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  bwd_prep<T><<<dim3(nnt * npt + nqt * nqt, H, B * nc), kThreads, kSmem, stream>>>(
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
  chunk_grads<T><<<dim3(2 * nqt * nnt * G * nsl + nqt * npt * H, B * nc), kThreads, kSmem,
                   stream>>>(
      xt, dt, Bt, Ct, dyt, CB, cs, st, dst, dCBg, static_cast<T*>(dx), work + sc.part_dB,
      work + sc.part_dC, part_carry, part_dw, S, H, G, P, N, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  slice_sum<T><<<dim3((Q * N + kThreads - 1) / kThreads, 2 * G, B * nc), kThreads, 0, stream>>>(
      work + sc.part_dC, work + sc.part_dB, static_cast<T*>(dC), static_cast<T*>(dB), S, G, N, Q,
      nc, nsl);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dt_bwd<<<H, kThreads, 0, stream>>>(dt, A, cs, rowT, colT, colZ, part_carry, part_dw, part_decay,
                                     ddt, dA, B, S, H, P, N, Q, nc);
  return cudaGetLastError();
}

bool valid(int B, int S, int H, int G, int P, int N, int Q) {
  return B >= 1 && Q >= 1 && Q <= kMaxQ && S >= Q && S % Q == 0 && G >= 1 && H % G == 0 &&
         P >= 1 && N >= 1 && B * (S / Q) <= 65535 && H <= 65535 && 2 * G <= 65535;
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
// and dC are bfloat16 when is_bf16.  Six launches on `stream`, five when
// G == H.
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
