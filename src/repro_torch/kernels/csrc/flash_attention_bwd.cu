// Backward flash attention for Hopper (sm_90a): dq, dk and dv of
// flash_attention.cu's forward, for training.
//
// The JAX package has no Pallas backward: it differentiates its einsum
// attention (models/attention.py::sdpa) with autodiff, and its TPU kernel
// kernels/flash_attention.py has no custom_vjp.  So this kernel replaces no
// TPU kernel; it keeps the plain attention off the card's train path.  Same
// function as kernels/ref.py::flash_attention_bwd_ref.  With the scaled
// logits u_ij = q_i . k_j / sqrt(hd), s = u (or softcap * tanh(u / softcap)
// with a softcap), the forward's row log-sum-exp lse_i and its output o_i:
//   P_ij = exp(s_ij - lse_i) over the live (i, j), 0 elsewhere
//   D_i  = dO_i . o_i
//   dS_ij = P_ij (dO_i . v_j - D_i)  (times 1 - tanh^2(u_ij / softcap))
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j = sum_i P_ij dO_i,
// where dk and dv sum over the query heads of each kv head's group (GQA).
// The masks are the forward's: j <= i (causal) and i - j < window, each only
// where Sk == S; keys of another length (cross-attention) are all live.
// Head dims (q/k hd, v hd_v): equal in 16, 32, 64, 80, 128, 256, or MLA's
// (192, 128), scaled by 1/sqrt(hd) as the forward is; k and v may be read
// at a head stride (MLA's v is the tail of each head's [k_nope | v] row);
// float32 or bfloat16 inputs, float32 arithmetic, outputs in the inputs'
// type, dq and dk at hd, dv at hd_v, all contiguous.
//
// What bounds it on this card: operations.  Seven products of 2 hd
// operations a live (i, j) pair (q.k and dO.v twice, then dv, dk and dq)
// against the forward's two: at minicpm-2b training (B=2, S=1024, H=36,
// hd=64, causal) ~33.9 GFLOP against ~85 MB of q, k, v, o, dO, the
// gradients and lse.  The products run on the tensor cores in
// split-precision TF32 (3xTF32, as CUTLASS's OpMultiplyAddFastF32): a
// float32 operand x is big = tf32(x) plus small = tf32(x - big), and a.b is
// small.big + big.small + big.big, each term exact in float32 and summed in
// float32; the dropped small.small and the rounding of small are ~2^-22
// |a||b| each, so a product stays within ~2^-21 of its terms' magnitude, far
// under the 1e-4 / 1e-3 the gradients are held to (one TF32 product, ~2^-11,
// misses it: tests/test_torch_tf32x3.py).  The tensor cores truncate what
// they accumulate, so each step of 8 (the scores) or 32 (dv, dk, dq) terms
// goes into a fresh accumulator that is added to the running sum in float32.
// A bfloat16 operand is exact in TF32: its small part is zero and its terms
// are skipped, so q.k and dO.v take one product in bfloat16 and the others
// two.  Three TF32 products at 495 TFLOP/s bound the float32 work at ~165
// TFLOP/s; at minicpm-2b's shape ~102 GFLOP of TF32 work, >= 0.21 ms.  What
// holds it above that is the instructions around the products (the splits,
// the fragment loads, P and dS) and the occupancy that 255 registers and
// the staged tiles leave: 8 warps an SM at hd 64 and 80.
//
// A softcap in float32 forms the logits in float32 instead, by FFMA on the
// CUDA cores over the staged q and k tiles (kF32Logits): where the cap
// bends them the logits reach ~+-60, and split precision's ~2^-21 of them
// moves P (and so dk) by ~2x the float32 plain version's error there
// (tests/test_torch_tf32x3.py::test_softcap_bwd_float32_logits_within_limit).
// The other four products stay split.  No config of the repo sets a
// softcap, so no train path runs this variant.
//
// Design.  Three launches, deterministic and free of atomics, so two runs
// agree bit for bit:
//   (a) dsum_kernel: D = rowsum(dO * o), one warp a (batch, row, head);
//   (b) dkdv_kernel: one CTA per (key tile, kv head, batch).  Its K and V
//       tiles stay in shared memory; it loops over its group's query heads
//       and, for each, over the query tiles (BC rows) the masks leave live
//       for its keys, the next tile's Q, dO, lse and D in flight (cp.async)
//       while the current one's products run;
//   (c) dq_kernel: one CTA per (query tile, head, batch), last tile first as
//       the forward launches, its Q and dO tiles in shared memory, looping
//       over the live key tiles the same way.
// Each warp owns 16 rows of the CTA's tile (keys in (b), queries in (c)) and
// hd / WC columns of its q/k accumulators (hd_v / WC of dv's), and runs
// mma.sync.m16n8k8 TF32
// (mma.sync rather than wgmma: wgmma takes TF32 operands only K-major from
// shared memory, so dk = dS^T q and dv = P^T dO would need transposed copies
// of q and dO, and P and dS would go through shared memory; mma.sync takes
// them from registers).  A warp forms the 16 x BC scores and dO.v^T (s^T =
// K Q^T and dp^T = V dO^T in (b)) in registers, turns them into P and dS in
// place (the masks skipped where the warp's whole tile is live), and uses
// them at once as the A operand of dv += P^T dO and dk += dS^T q (dq += dS
// k in (c)): the m16n8 accumulator holds columns 2t and 2t+1 of each row
// where the m16n8k8 A fragment wants k-slots t and t + 4, so slot t stands
// for column 2t and slot t + 4 for 2t + 1, and B's rows are read in that
// order.  The head-dim products read their pairs (2t, 2t + 1) the same way,
// as one 8-byte load.  A float32 streamed tile is split once a step by the
// whole CTA into big and small arrays (one stage of it as it arrived, the
// next stage's copy issued once the split is done, or with float32 logits
// once they are formed), so no warp splits a B operand; the CTA's own tiles
// are split as their A fragments are read.
// Staged rows are D + 8 elements long (D = hd or hd_v) and every 8-column
// group of rows 4-7 mod 8 is swapped with its neighbour (column c ^ 8), so
// that both the paired loads along a row and the loads of rows 2t and 2t +
// 1 hit 32 distinct banks; the swap is a constant of each thread, folded
// into its offsets.  Recomputing P in both (b) and (c) costs seven products
// against the five of a design that adds dq across CTAs with atomics; it
// buys the determinism.  Masks are per element, so any S and Sk work; rows
// past S or Sk are zero-filled and masked, and each CTA visits exactly the
// tiles the masks leave live for its rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDsumThreads = 256;  // dsum_kernel: one warp a row

// WR warps of 16 rows each (the CTA's own rows), times WC slices of the head
// dims for the accumulators (each slice's warps recompute the 16 x BC scores,
// which keeps hd 128, 192 and 256 within the registers); BC rows of the
// streamed tile a step; MinB CTAs an SM for the register budget.  Keyed by
// the q/k head dim.
template <int HD> struct Cfg;
template <> struct Cfg<16> { static constexpr int WR = 4, WC = 1, BC = 32, MinB = 3; };
template <> struct Cfg<32> { static constexpr int WR = 4, WC = 1, BC = 32, MinB = 3; };
template <> struct Cfg<64> { static constexpr int WR = 4, WC = 1, BC = 32, MinB = 2; };
template <> struct Cfg<80> { static constexpr int WR = 4, WC = 1, BC = 32, MinB = 2; };
template <> struct Cfg<128> { static constexpr int WR = 4, WC = 2, BC = 32, MinB = 1; };
template <> struct Cfg<192> { static constexpr int WR = 4, WC = 2, BC = 32, MinB = 1; };
template <> struct Cfg<256> { static constexpr int WR = 2, WC = 4, BC = 16, MinB = 1; };

template <int HD> __host__ __device__ constexpr int threads() {
  return 32 * Cfg<HD>::WR * Cfg<HD>::WC;
}
template <int HD> __host__ __device__ constexpr int rows() { return 16 * Cfg<HD>::WR; }
// a staged row of D elements (D = hd or hd_v)
template <int D> __host__ __device__ constexpr int row_ld() { return D + 8; }
template <typename T> __host__ __device__ constexpr bool exact() { return sizeof(T) == 2; }
// Shared memory: the CTA's two own tiles (rows x hd and rows x hd_v) of T;
// the two streamed tiles (BC x hd and BC x hd_v) of T as they arrive, in two
// stages for bfloat16 and one for float32, whose tiles are split once a step
// into big and small TF32 arrays of the same layout; the streamed rows' lse
// and D in two stages (dkdv_kernel) or the own rows' (dq_kernel).
template <typename T, int HD, int HDV> __host__ __device__ constexpr size_t smem_bytes() {
  constexpr size_t R = rows<HD>(), BC = Cfg<HD>::BC, LD2 = row_ld<HD>() + row_ld<HDV>();
  return sizeof(T) * LD2 * (R + (exact<T>() ? 2 : 1) * BC) +
         (exact<T>() ? 0 : sizeof(uint32_t) * 2 * BC * LD2) + sizeof(float) * 4 * (BC > R ? BC : R);
}

// element (r, c) of a staged tile of D-element rows: rows 4-7 mod 8 swap
// their 8-column groups
template <int D> __device__ __forceinline__ int at(int r, int c) {
  return r * row_ld<D>() + (c ^ ((r & 4) << 1));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// rows [row0, row0 + NR) of head `head` of a (B, S, heads, D) tensor whose
// heads lie ld elements apart (ld = D when contiguous) into a staged (NR,
// row_ld) tile, by the CTA's NT threads; rows at or past S are zero-filled
template <typename T, int D, int NR, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int b, int row0,
                                          int S, int heads, int head, int ld) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kChunks = D / kPer;
  for (int e = threadIdx.x; e < NR * kChunks; e += NT) {
    const int r = e / kChunks, ch = e % kChunks;
    const int row = row0 + r;
    const bool in = row < S;
    const T* from = in ? src + (((size_t)b * S + row) * heads + head) * ld + ch * kPer : src;
    cp_async16(dst + at<D>(r, ch * kPer), from, in);
  }
}

// x rounded to TF32 (to nearest, ties away from zero, as cvt.rna.tf32.f32
// for finite x: two integer operations where cvt takes about four)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A split-precision operand fragment: big = tf32(x), small = tf32(x - big);
// with kExact (a bfloat16 value, exact in TF32) small is never read.
template <int N> struct Frag {
  uint32_t big[N], small[N];
};
template <bool kExact, int N>
__device__ __forceinline__ void split(Frag<N>& f, int i, float x) {
  f.big[i] = kExact ? __float_as_uint(x) : tf32(x);
  if (!kExact) f.small[i] = tf32(x - __uint_as_float(f.big[i]));
}

// A streamed tile as TF32 operands: float32 tiles split once a step into
// big and small arrays, bfloat16 tiles read as they arrived (exact)
template <typename T> struct View;
template <> struct View<float> {
  const uint32_t* big;
  const uint32_t* small;
  __device__ __forceinline__ void pair(Frag<2>& f, int off) const {
    const uint2 b = *reinterpret_cast<const uint2*>(big + off);
    const uint2 s = *reinterpret_cast<const uint2*>(small + off);
    f.big[0] = b.x, f.big[1] = b.y, f.small[0] = s.x, f.small[1] = s.y;
  }
  __device__ __forceinline__ void one(Frag<2>& f, int i, int off) const {
    f.big[i] = big[off];
    f.small[i] = small[off];
  }
};
template <> struct View<__nv_bfloat16> {
  const __nv_bfloat16* raw;
  __device__ __forceinline__ void pair(Frag<2>& f, int off) const {
    const float2 v = ld_pair(raw + off);
    f.big[0] = __float_as_uint(v.x), f.big[1] = __float_as_uint(v.y);
  }
  __device__ __forceinline__ void one(Frag<2>& f, int i, int off) const {
    f.big[i] = __float_as_uint(__bfloat162float(raw[off]));
  }
};

// Splits n floats (a multiple of 4, 16-byte aligned) into big and small, by
// the CTA's NT threads.
template <int NT>
__device__ __forceinline__ void split_tiles(const float* raw, uint32_t* big, uint32_t* small,
                                            int n) {
  for (int e = threadIdx.x * 4; e < n; e += NT * 4) {
    const float4 x = *reinterpret_cast<const float4*>(raw + e);
    uint4 b, s;
    b.x = tf32(x.x), b.y = tf32(x.y), b.z = tf32(x.z), b.w = tf32(x.w);
    s.x = tf32(x.x - __uint_as_float(b.x)), s.y = tf32(x.y - __uint_as_float(b.y));
    s.z = tf32(x.z - __uint_as_float(b.z)), s.w = tf32(x.w - __uint_as_float(b.w));
    *reinterpret_cast<uint4*>(big + e) = b;
    *reinterpret_cast<uint4*>(small + e) = s;
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b over one 8-deep step in split precision, the small terms first;
// an exact operand's small terms are skipped.  The tensor cores truncate
// what they accumulate, so a split product sums its step into a fresh
// accumulator and adds that to d in float32, rounding to nearest: the
// truncation then touches one step's terms, not the running sum (with
// every term in d, dO.v - D lost up to ~1e-4 on the rows where it cancels).
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3_into(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  if (!kExactB) mma(d, a.big, b.small);
  if (!kExactA) mma(d, a.small, b.big);
  mma(d, a.big, b.big);
}
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  if (kExactA && kExactB) {
    mma(d, a.big, b.big);
    return;
  }
  float step[4] = {0.f, 0.f, 0.f, 0.f};
  mma3_into<kExactA, kExactB>(step, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += step[e];
}
// 8-deep steps of the dv, dk and dq products that share one fresh
// accumulator: the truncation touches 4 steps' terms, and the float32 adds
// come once for 4 steps
constexpr int kStepGroup = 4;

// This thread's offsets into a staged tile of D-element rows, so that every
// fragment load is a base plus a constant.  Pattern 1 reads the pair (row
// r0 + g, columns kk + 2t, kk + 2t + 1): row1[kk & 8 ? 1 : 0] + r0 * ld +
// kk.  Pattern 2 reads (rows j0 + 2t and j0 + 2t + 1, column c0 + n0 + g):
// row2[n0 & 8 ? 1 : 0] + j0 * ld + n0 (and + ld), c0 a multiple of 16.  The
// swizzle of at() is a constant of the thread in both: rows g and 2t fix
// bit 2 of the row.
template <int D> struct Offs {
  int row1[2], row2[2];
  __device__ __forceinline__ explicit Offs(int c0) {
    constexpr int LD = row_ld<D>();
    const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
    const int s1 = (g & 4) << 1, s2 = (t & 2) << 2;
    row1[0] = g * LD + 2 * t + s1;
    row1[1] = g * LD + 2 * t - s1;
    row2[0] = 2 * t * LD + c0 + g + s2;
    row2[1] = 2 * t * LD + c0 + g - s2;
  }
};

// The A fragment of own rows [m0, m0 + 16) and head-dim columns [kk, kk + 8):
// k-slot t is column kk + 2t, slot t + 4 is kk + 2t + 1
template <bool kExact, int D, typename T>
__device__ __forceinline__ Frag<4> a_rows(const T* tile, int off) {
  const float2 lo = ld_pair(tile + off);
  const float2 hi = ld_pair(tile + off + 8 * row_ld<D>());
  Frag<4> f;
  split<kExact>(f, 0, lo.x);
  split<kExact>(f, 1, hi.x);
  split<kExact>(f, 2, lo.y);
  split<kExact>(f, 3, hi.y);
  return f;
}

// The B fragment of rows [j0, j0 + 8) (the k dim) and columns [n0, n0 + 8)
// of a streamed tile: k-slot t is row j0 + 2t and slot t + 4 row j0 + 2t +
// 1, the order in which an accumulator serves as the A operand (acc_as_a)
template <int D, typename V>
__device__ __forceinline__ Frag<2> b_cols(const V& v, int off) {
  Frag<2> f;
  v.one(f, 0, off);
  v.one(f, 1, off + row_ld<D>());
  return f;
}

// An m16n8 accumulator (rows g and g + 8, columns 2t and 2t + 1) as the
// m16n8k8 A operand with the k-slots of b_cols
__device__ __forceinline__ Frag<4> acc_as_a(const float (&c)[4]) {
  Frag<4> f;
  split<false>(f, 0, c[0]);
  split<false>(f, 1, c[2]);
  split<false>(f, 2, c[1]);
  split<false>(f, 3, c[3]);
  return f;
}

// P and dS from the scores s = q.k and dp = dO.v, in place; lse2 is in
// log2 units
struct Grad {
  float scale_log2, cap_in, cap_out;
  int S, Sk, causal, window;
  // whether every (query, key) of queries [q_lo, q_hi] x keys [k_lo, k_hi]
  // is live
  __device__ __forceinline__ bool all_live(int q_lo, int q_hi, int k_lo, int k_hi) const {
    return q_hi < S && k_hi < Sk && (!causal || k_hi <= q_lo) &&
           (window <= 0 || q_hi - k_lo < window);
  }
  template <bool kCap, bool kAllLive>
  __device__ __forceinline__ void apply(float& s, float& dp, int qi, int kj, float lse2,
                                        float dsum) const {
    if (!kAllLive &&
        !(qi < S && kj < Sk && (!causal || kj <= qi) && (window <= 0 || qi - kj < window))) {
      s = dp = 0.f;
      return;
    }
    if (kCap) {
      const float t = tanhf(s * cap_in);
      s = exp2f(cap_out * t - lse2);
      dp = s * (dp - dsum) * (1.f - t * t);
    } else {
      s = exp2f(s * scale_log2 - lse2);
      dp = s * (dp - dsum);
    }
  }
  // every element of a warp's 16 x 8 NT tile: at(nt, e) gives its (query,
  // key), lse(nt, e) and dsum(nt, e) its row's values; the softcap and the
  // masks chosen once for the tile
  template <int NT, class At, class Lse, class Dsum>
  __device__ __forceinline__ void tile(float (&s)[NT][4], float (&dp)[NT][4], bool live, At at,
                                       Lse lse, Dsum dsum) const {
    if (cap_out > 0.f) {
      if (live) each<true, true>(s, dp, at, lse, dsum);
      else each<true, false>(s, dp, at, lse, dsum);
    } else {
      if (live) each<false, true>(s, dp, at, lse, dsum);
      else each<false, false>(s, dp, at, lse, dsum);
    }
  }
  template <bool kCap, bool kAllLive, int NT, class At, class Lse, class Dsum>
  __device__ __forceinline__ void each(float (&s)[NT][4], float (&dp)[NT][4], At at, Lse lse,
                                       Dsum dsum) const {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 qk = at(nt, e);
        apply<kCap, kAllLive>(s[nt][e], dp[nt][e], qk.x, qk.y, lse(nt, e), dsum(nt, e));
      }
  }
};

template <typename T>
__global__ void __launch_bounds__(kDsumThreads)
dsum_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
            int S, int H, int hd, long long rows) {
  const long long row = (long long)blockIdx.x * (kDsumThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_float(orow[d]), to_float(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {  // row = (b * S + i) * H + h; D is (B, H, S)
    const long long h = row % H, i = (row / H) % S, b = row / ((long long)H * S);
    dsum[(b * H + h) * S + i] = acc;
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float x) {
  x = fmaf(a.x, b.x, x);
  x = fmaf(a.y, b.y, x);
  x = fmaf(a.z, b.z, x);
  return fmaf(a.w, b.w, x);
}

// The 16 x BC logits of this warp's rows m0.. of the own float32 tile R1
// against the BC rows of the streamed float32 tile C1 as they arrived, over
// the q/k head dim, by FFMA in float32 (the accumulator layout of mma's
// m16n8: rows g and g + 8, columns 2t and 2t + 1 of each 8-column tile)
template <int HD, int NT>
__device__ __forceinline__ void logits_f32(float (&s)[NT][4], const float* R1, const float* C1,
                                           int m0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < HD; kk += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(R1 + at<HD>(m0 + g, kk));
    const float4 a1 = *reinterpret_cast<const float4*>(R1 + at<HD>(m0 + g + 8, kk));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 b0 = *reinterpret_cast<const float4*>(C1 + at<HD>(nt * 8 + 2 * t, kk));
      const float4 b1 = *reinterpret_cast<const float4*>(C1 + at<HD>(nt * 8 + 2 * t + 1, kk));
      s[nt][0] = dot4(a0, b0, s[nt][0]);
      s[nt][1] = dot4(a0, b1, s[nt][1]);
      s[nt][2] = dot4(a1, b0, s[nt][2]);
      s[nt][3] = dot4(a1, b1, s[nt][3]);
    }
  }
}

// The 16 x BC scores (over hd) and dO.v^T (over hd_v) of this warp's rows
// m0.. of the own tiles R1 (hd) and R2 (hd_v) against the BC rows of the
// streamed tiles C1 and C2; with kF32Logits the scores in float32 from the
// streamed tile C1raw as it arrived (float32 only)
template <int HD, int HDV, bool kF32Logits, typename T>
__device__ __forceinline__ void scores(float (&s)[Cfg<HD>::BC / 8][4],
                                       float (&dp)[Cfg<HD>::BC / 8][4], const T* R1,
                                       const T* R2, const View<T>& C1, const View<T>& C2,
                                       const T* C1raw, int m0, const Offs<HD>& ok,
                                       const Offs<HDV>& ov) {
  constexpr int NT = Cfg<HD>::BC / 8, LDK = row_ld<HD>(), LDV = row_ld<HDV>();
  constexpr bool kExact = exact<T>();
  if constexpr (HD == HDV && !kF32Logits) {  // one loop over the shared head dim
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      const int off = ok.row1[(kk >> 3) & 1] + kk;
      const Frag<4> a1 = a_rows<kExact, HD>(R1, off + m0 * LDK);
      const Frag<4> a2 = a_rows<kExact, HD>(R2, off + m0 * LDK);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        Frag<2> b1, b2;
        C1.pair(b1, off + nt * 8 * LDK);
        C2.pair(b2, off + nt * 8 * LDK);
        mma3<kExact, kExact>(s[nt], a1, b1);
        mma3<kExact, kExact>(dp[nt], a2, b2);
      }
    }
  } else {
    if constexpr (kF32Logits) {
      logits_f32<HD>(s, R1, C1raw, m0);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 8) {
        const int off = ok.row1[(kk >> 3) & 1] + kk;
        const Frag<4> a1 = a_rows<kExact, HD>(R1, off + m0 * LDK);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          Frag<2> b1;
          C1.pair(b1, off + nt * 8 * LDK);
          mma3<kExact, kExact>(s[nt], a1, b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDV; kk += 8) {
      const int off = ov.row1[(kk >> 3) & 1] + kk;
      const Frag<4> a2 = a_rows<kExact, HDV>(R2, off + m0 * LDV);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        Frag<2> b2;
        C2.pair(b2, off + nt * 8 * LDV);
        mma3<kExact, kExact>(dp[nt], a2, b2);
      }
    }
  }
}

// The streamed stage's two tiles (BC x hd, then BC x hd_v) as operands:
// split once (float32, into `split`: big of both tiles, then small of
// both) or read as they are
template <int HD, int HDV, int BC, int NT>
__device__ __forceinline__ void views(const float* raw, uint32_t* split, View<float>& c1,
                                      View<float>& c2) {
  constexpr int n1 = BC * row_ld<HD>(), n = n1 + BC * row_ld<HDV>();
  split_tiles<NT>(raw, split, split + n, n);
  c1 = View<float>{split, split + n};
  c2 = View<float>{split + n1, split + n + n1};
}
template <int HD, int HDV, int BC, int NT>
__device__ __forceinline__ void views(const __nv_bfloat16* raw, uint32_t*,
                                      View<__nv_bfloat16>& c1, View<__nv_bfloat16>& c2) {
  c1 = View<__nv_bfloat16>{raw};
  c2 = View<__nv_bfloat16>{raw + BC * row_ld<HD>()};
}

template <typename T, int HD, int HDV, bool kF32Logits>
__global__ void __launch_bounds__(threads<HD>(), Cfg<HD>::MinB)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int H, int KH,
            int ldk, int ldv, float scale, Grad grad) {
  using C = Cfg<HD>;
  constexpr int LDK = row_ld<HD>(), LDV = row_ld<HDV>(), R = rows<HD>(), BC = C::BC;
  constexpr int NT = BC / 8, NTH = threads<HD>();
  constexpr int ND = HD / C::WC / 8, NDV = HDV / C::WC / 8, NDM = ND > NDV ? ND : NDV;
  constexpr int kStages = exact<T>() ? 2 : 1, STAGE = BC * (LDK + LDV);
  constexpr bool kExact = exact<T>();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + R * LDK;
  T* raw = Vs + R * LDV;  // kStages x (Q tile (BC, LDK), dO tile (BC, LDV))
  uint32_t* split = reinterpret_cast<uint32_t*>(raw + kStages * STAGE);
  float* lse_s = reinterpret_cast<float*>(split + (kExact ? 0 : 2 * STAGE));  // 2 x BC
  float* D_s = lse_s + 2 * BC;

  const int S = grad.S, Sk = grad.Sk;
  const int k0 = blockIdx.x * R, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int m0 = warp / C::WC * 16, c0 = warp % C::WC * (HD / C::WC);
  const int c0v = warp % C::WC * (HDV / C::WC);
  const Offs<HD> ok(c0);
  const Offs<HDV> ov(c0v);

  load_tile<T, HD, R, NTH>(Ks, k, b, k0, Sk, KH, kh, ldk);
  load_tile<T, HDV, R, NTH>(Vs, v, b, k0, Sk, KH, kh, ldv);

  // the query rows that see a key of this tile (masks only where Sk == S);
  // step i is query head kh * G + i / n_qt, query tile i % n_qt
  const int q_lo = grad.causal ? k0 : 0;
  const int q_hi = grad.window > 0 ? min(S, k0 + R - 1 + grad.window) : S;
  const int q_start = (q_lo / BC) * BC;
  const int n_qt = q_hi > q_start ? (q_hi - q_start + BC - 1) / BC : 0;
  const int n_steps = G * n_qt;
  auto issue = [&](int i) {
    const int h = kh * G + i / n_qt, q0 = q_start + i % n_qt * BC;
    T* st = raw + i % kStages * STAGE;
    load_tile<T, HD, BC, NTH>(st, q, b, q0, S, H, h, HD);
    load_tile<T, HDV, BC, NTH>(st + BC * LDK, dout, b, q0, S, H, h, HDV);
    for (int r = threadIdx.x; r < BC; r += NTH) {
      const bool in = q0 + r < S;
      const size_t row = ((size_t)b * H + h) * S + (in ? q0 + r : 0);
      cp_async4(lse_s + (i & 1) * BC + r, lse + row, in);
      cp_async4(D_s + (i & 1) * BC + r, dsum + row, in);
    }
  };
  if (n_steps > 0) issue(0);
  cp_async_commit();

  float dk_acc[NDM][4], dv_acc[NDM][4];
#pragma unroll
  for (int nd = 0; nd < NDM; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait_all();
    __syncthreads();  // step i's tiles are in; step i - 1's readers are done
    const T* st = raw + i % kStages * STAGE;
    View<T> Qv, dOv;
    views<HD, HDV, BC, NTH>(st, split, Qv, dOv);
    if (!kExact) __syncthreads();  // the split tiles are in
    if constexpr (!kF32Logits) {  // the raw stage is free
      if (i + 1 < n_steps) issue(i + 1);
      cp_async_commit();
    }
    const int q0 = q_start + i % n_qt * BC;
    const float* ls = lse_s + (i & 1) * BC;
    const float* Ds = D_s + (i & 1) * BC;

    // s^T = K Q^T and dp^T = V dO^T, then P^T and dS^T in place
    float s[NT][4], dp[NT][4];
    scores<HD, HDV, kF32Logits>(s, dp, Ks, Vs, Qv, dOv, st, m0, ok, ov);
    if constexpr (kF32Logits) {  // the raw Q tile is read: its stage is free
      __syncthreads();
      if (i + 1 < n_steps) issue(i + 1);
      cp_async_commit();
    }
    grad.tile(
        s, dp, grad.all_live(q0, q0 + BC - 1, k0 + m0, k0 + m0 + 15),
        [&](int nt, int e) {
          return make_int2(q0 + nt * 8 + 2 * t + (e & 1), k0 + m0 + g + (e >> 1) * 8);
        },
        [&](int nt, int e) { return ls[nt * 8 + 2 * t + (e & 1)] * kLog2e; },
        [&](int nt, int e) { return Ds[nt * 8 + 2 * t + (e & 1)]; });
    // dv += P^T dO and dk += dS^T Q over this tile's queries, KG 8-query
    // steps summed into a fresh accumulator at a time
    constexpr int KG = kStepGroup < NT ? kStepGroup : NT;
#pragma unroll
    for (int k0g = 0; k0g < NT; k0g += KG) {
      Frag<4> ap[KG], ad[KG];
#pragma unroll
      for (int kq = 0; kq < KG; ++kq) {
        ap[kq] = acc_as_a(s[k0g + kq]);
        ad[kq] = acc_as_a(dp[k0g + kq]);
      }
#pragma unroll
      for (int nd = 0; nd < NDM; ++nd) {
        float sv[4] = {0.f, 0.f, 0.f, 0.f}, sk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kq = 0; kq < KG; ++kq) {
          if (nd < NDV)
            mma3_into<false, kExact>(
                sv, ap[kq], b_cols<HDV>(dOv, ov.row2[nd & 1] + (k0g + kq) * 8 * LDV + nd * 8));
          if (nd < ND)
            mma3_into<false, kExact>(
                sk, ad[kq], b_cols<HD>(Qv, ok.row2[nd & 1] + (k0g + kq) * 8 * LDK + nd * 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (nd < NDV) dv_acc[nd][e] += sv[e];
          if (nd < ND) dk_acc[nd][e] += sk[e];
        }
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the CTA

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = k0 + m0 + g + half * 8;
    if (kj >= Sk) continue;
    const size_t row = ((size_t)b * Sk + kj) * KH + kh;
#pragma unroll
    for (int nd = 0; nd < NDM; ++nd) {
      if (nd < ND)
        store2(&dk[row * HD + c0 + nd * 8 + 2 * t], dk_acc[nd][2 * half] * scale,
               dk_acc[nd][2 * half + 1] * scale);
      if (nd < NDV)
        store2(&dv[row * HDV + c0v + nd * 8 + 2 * t], dv_acc[nd][2 * half],
               dv_acc[nd][2 * half + 1]);
    }
  }
}

template <typename T, int HD, int HDV, bool kF32Logits>
__global__ void __launch_bounds__(threads<HD>(), Cfg<HD>::MinB)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, T* __restrict__ dq, int H, int KH, int ldk, int ldv,
          float scale, Grad grad) {
  using C = Cfg<HD>;
  constexpr int LDK = row_ld<HD>(), LDV = row_ld<HDV>(), R = rows<HD>(), BC = C::BC;
  constexpr int NT = BC / 8, NTH = threads<HD>(), ND = HD / C::WC / 8;
  constexpr int kStages = exact<T>() ? 2 : 1, STAGE = BC * (LDK + LDV);
  constexpr bool kExact = exact<T>();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + R * LDK;
  T* raw = dOs + R * LDV;  // kStages x (K tile (BC, LDK), V tile (BC, LDV))
  uint32_t* split = reinterpret_cast<uint32_t*>(raw + kStages * STAGE);
  float* lse_s = reinterpret_cast<float*>(split + (kExact ? 0 : 2 * STAGE));  // R
  float* D_s = lse_s + R;

  const int S = grad.S, Sk = grad.Sk;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;  // last tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int m0 = warp / C::WC * 16, c0 = warp % C::WC * (HD / C::WC);
  const Offs<HD> ok(c0);
  const Offs<HDV> ov(warp % C::WC * (HDV / C::WC));

  load_tile<T, HD, R, NTH>(Qs, q, b, q0, S, H, h, HD);
  load_tile<T, HDV, R, NTH>(dOs, dout, b, q0, S, H, h, HDV);
  for (int r = threadIdx.x; r < R; r += NTH) {
    const bool in = q0 + r < S;
    const size_t row = ((size_t)b * H + h) * S + (in ? q0 + r : 0);
    cp_async4(lse_s + r, lse + row, in);
    cp_async4(D_s + r, dsum + row, in);
  }

  // the live key tiles of this query tile
  const int k_lo = grad.window > 0 ? max(0, q0 - grad.window + 1) : 0;
  const int k_hi = grad.causal ? min(q0 + R, S) : Sk;
  const int k_start = (k_lo / BC) * BC;
  const int n_steps = k_hi > k_start ? (k_hi - k_start + BC - 1) / BC : 0;
  auto issue = [&](int i) {
    T* st = raw + i % kStages * STAGE;
    load_tile<T, HD, BC, NTH>(st, k, b, k_start + i * BC, Sk, KH, kh, ldk);
    load_tile<T, HDV, BC, NTH>(st + BC * LDK, v, b, k_start + i * BC, Sk, KH, kh, ldv);
  };
  if (n_steps > 0) issue(0);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float lse2[2], Dr[2];

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait_all();
    __syncthreads();  // step i's tiles are in; step i - 1's readers are done
    if (i == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        lse2[half] = lse_s[m0 + g + half * 8] * kLog2e;
        Dr[half] = D_s[m0 + g + half * 8];
      }
    }
    const T* st = raw + i % kStages * STAGE;
    View<T> Kv, Vv;
    views<HD, HDV, BC, NTH>(st, split, Kv, Vv);
    if (!kExact) __syncthreads();  // the split tiles are in
    if constexpr (!kF32Logits) {  // the raw stage is free
      if (i + 1 < n_steps) issue(i + 1);
      cp_async_commit();
    }
    const int k0 = k_start + i * BC;

    // s = Q K^T and dp = dO V^T, then P and dS in place, then dq += dS K
    float s[NT][4], dp[NT][4];
    scores<HD, HDV, kF32Logits>(s, dp, Qs, dOs, Kv, Vv, st, m0, ok, ov);
    if constexpr (kF32Logits) {  // the raw K tile is read: its stage is free
      __syncthreads();
      if (i + 1 < n_steps) issue(i + 1);
      cp_async_commit();
    }
    grad.tile(
        s, dp, grad.all_live(q0 + m0, q0 + m0 + 15, k0, k0 + BC - 1),
        [&](int nt, int e) {
          return make_int2(q0 + m0 + g + (e >> 1) * 8, k0 + nt * 8 + 2 * t + (e & 1));
        },
        [&](int, int e) { return lse2[e >> 1]; }, [&](int, int e) { return Dr[e >> 1]; });
    constexpr int KG = kStepGroup < NT ? kStepGroup : NT;
#pragma unroll
    for (int k0g = 0; k0g < NT; k0g += KG) {
      Frag<4> ad[KG];
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) ad[kk] = acc_as_a(dp[k0g + kk]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        float sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KG; ++kk)
          mma3_into<false, kExact>(
              sq, ad[kk], b_cols<HD>(Kv, ok.row2[nd & 1] + (k0g + kk) * 8 * LDK + nd * 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] += sq[e];
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + m0 + g + half * 8;
    if (qi >= S) continue;
    const size_t row = (((size_t)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store2(&dq[row + c0 + nd * 8 + 2 * t], acc[nd][2 * half] * scale,
             acc[nd][2 * half + 1] * scale);
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD, int HDV, bool kF32Logits>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* dsum, void* dq, void* dk, void* dv, int B, int S,
                   int Sk, int H, int KH, int ldk, int ldv, int causal, int window,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD, HDV>();
  constexpr int R = rows<HD>();
  if (ldk < HD || ldv < HDV || (ldk * sizeof(T)) % 16 || (ldv * sizeof(T)) % 16)
    return cudaErrorInvalidValue;
  static bool opted_in = false;  // the attributes are set once per instantiation
  if (!opted_in) {
    cudaError_t err = opt_in(dkdv_kernel<T, HD, HDV, kF32Logits>, smem);
    if (err == cudaSuccess) err = opt_in(dq_kernel<T, HD, HDV, kF32Logits>, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const float scale = 1.0f / sqrtf((float)HD);
  Grad grad{scale * kLog2e, softcap > 0.f ? scale / softcap : 0.f,
            softcap > 0.f ? softcap * kLog2e : 0.f, S, Sk, causal, window};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long n_rows = (long long)B * S * H;
  constexpr int kRowsPerBlock = kDsumThreads / 32;
  dsum_kernel<T><<<(unsigned)((n_rows + kRowsPerBlock - 1) / kRowsPerBlock), kDsumThreads, 0,
                   stream>>>(
      static_cast<const T*>(o), dot, dsum, S, H, HDV, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, HD, HDV, kF32Logits><<<dim3((Sk + R - 1) / R, KH, B), threads<HD>(), smem,
                                        stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), H, KH, ldk, ldv,
      scale, grad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, HD, HDV, kF32Logits><<<dim3((S + R - 1) / R, H, B), threads<HD>(), smem,
                                      stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), H, KH, ldk, ldv, scale, grad);
  return cudaGetLastError();
}

// a softcap in float32 takes the float32 logits (kF32Logits); bfloat16 is
// exact in TF32 and keeps its one product
template <typename T, int HD, int HDV>
cudaError_t launch_cap(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                       void* dv, int B, int S, int Sk, int H, int KH, int ldk, int ldv,
                       int causal, int window, float softcap, cudaStream_t s) {
  if constexpr (!exact<T>()) {
    if (softcap > 0.f)
      return launch<T, HD, HDV, true>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Sk, H, KH,
                                      ldk, ldv, causal, window, softcap, s);
  }
  return launch<T, HD, HDV, false>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Sk, H, KH,
                                   ldk, ldv, causal, window, softcap, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                     void* dv, int B, int S, int Sk, int H, int KH, int hd, int hd_v, int ldk,
                     int ldv, int causal, int window, float softcap, cudaStream_t s) {
#define REPRO_FLASH_BWD_CASE(D, DV)                                                        \
  if (hd == D && hd_v == DV)                                                               \
  return launch_cap<T, D, DV>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Sk, H, KH,    \
                              ldk, ldv, causal, window, softcap, s)
  REPRO_FLASH_BWD_CASE(16, 16);
  REPRO_FLASH_BWD_CASE(32, 32);
  REPRO_FLASH_BWD_CASE(64, 64);
  REPRO_FLASH_BWD_CASE(80, 80);
  REPRO_FLASH_BWD_CASE(128, 128);
  REPRO_FLASH_BWD_CASE(256, 256);
  REPRO_FLASH_BWD_CASE(192, 128);  // MLA: nope + rope against v
#undef REPRO_FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dq: (B, S, H, hd); o, dout: (B, S, H, hd_v); all four contiguous.  k:
// (B, Sk, KH, hd) and v: (B, Sk, KH, hd_v) with their heads ldk and ldv
// elements apart (the head dim when contiguous; each a multiple of 16
// bytes); dk, dv: contiguous, of k's and v's shapes.  q, k, v and dout
// 16-byte aligned, all float32 or (when is_bf16) bfloat16; lse: (B, H, S)
// float32, the forward's row log-sum-exp (flash_attention_launch); dsum: (B,
// H, S) float32 scratch.  (hd, hd_v) with hd_v == hd one of 16, 32, 64, 80,
// 128, 256, or (192, 128); H % KH == 0; window <= 0 means no window; causal
// or a window only with Sk == S; softcap <= 0 means none.  Three launches on
// `stream`: D, then dk and dv, then dq.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          float* dsum, void* dq, void* dk, void* dv, int B,
                                          int S, int Sk, int H, int KH, int hd, int hd_v,
                                          int ldk, int ldv, int causal, int window, int is_bf16,
                                          float softcap, void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || KH < 1 || H % KH != 0 || B > 65535 || H > 65535 ||
      (Sk != S && (causal || window > 0)) || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S,
                                                 Sk, H, KH, hd, hd_v, ldk, ldv, causal, window,
                                                 softcap, s)
                       : dispatch<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Sk, H,
                                         KH, hd, hd_v, ldk, ldv, causal, window, softcap, s));
}
