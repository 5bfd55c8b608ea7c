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
// Equal head dims only (16, 32, 64, 80, 128, 256); float32 or bfloat16
// inputs, float32 arithmetic, outputs in the inputs' type.
//
// What bounds it on this card: operations.  Seven products of 2 hd
// operations a live (i, j) pair (q.k and dO.v twice, then dv, dk and dq)
// against the forward's two: at minicpm-2b training (B=2, S=1024, H=36,
// hd=64, causal) ~33.6 GFLOP against ~85 MB of q, k, v, o, dO, the
// gradients and lse.  The products run on CUDA cores in float32, as the
// forward's: TF32 or bf16 tensor cores would miss the float32 tolerance the
// gradients are held to.  A wgmma path is later work (ROADMAP Queue 2).
//
// Design.  Three launches, deterministic and free of atomics, so two runs
// agree bit for bit:
//   (a) dsum_kernel: D = rowsum(dO * o), one warp a (batch, row, head);
//   (b) dkdv_kernel: one CTA per (key tile, kv head, batch).  It keeps its K
//       and V tiles in shared memory and its dk and dv tiles in registers,
//       and loops over its group's query heads and, for each, over the query
//       tiles the masks leave live for its keys: it recomputes the scores
//       and dO . v^T, forms P and dS in registers from lse and D, writes them
//       transposed to shared memory and accumulates dv += P^T dO and
//       dk += dS^T q;
//   (c) dq_kernel: one CTA per (query tile, head, batch), last tile first as
//       the forward launches, loops over the live key tiles, recomputes P and
//       dS the same way and accumulates dq += dS k.
// Recomputing P in both (b) and (c) costs seven products against the five
// of a design that adds dq across CTAs with atomics; it buys the
// determinism.  The products use the forward's register tiles: a thread
// owns RS query rows x BT / TS keys of the scores, and RA rows x its float4
// column groups of an accumulator; tiles are copied with cp.async and read
// as float4 (bf16 converted when read).  Masks are per element, so any S and
// Sk work; rows past S or Sk are zero-filled and masked, and each CTA visits
// exactly the tiles the forward visits for its rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;

// BT rows of a query tile and of a key tile; the score products: RS rows x TS
// lanes a row group; the accumulations over the head dim: RA rows x TA lanes,
// each lane HD / 4 / TA float4 column groups.  BT / RS * TS == BT / RA * TA
// == kThreads.
template <int HD> struct Cfg;
template <> struct Cfg<16> { static constexpr int BT = 64, RS = 4, TS = 16, RA = 1, TA = 4, MinB = 2; };
template <> struct Cfg<32> { static constexpr int BT = 64, RS = 4, TS = 16, RA = 2, TA = 8, MinB = 2; };
template <> struct Cfg<64> { static constexpr int BT = 64, RS = 4, TS = 16, RA = 4, TA = 16, MinB = 2; };
template <> struct Cfg<80> { static constexpr int BT = 64, RS = 4, TS = 16, RA = 1, TA = 4, MinB = 1; };
template <> struct Cfg<128> { static constexpr int BT = 64, RS = 4, TS = 16, RA = 4, TA = 16, MinB = 1; };
template <> struct Cfg<256> { static constexpr int BT = 32, RS = 2, TS = 16, RA = 2, TA = 16, MinB = 1; };

template <typename T, int HD> __host__ __device__ constexpr int row_ld() {
  return HD + 16 / (int)sizeof(T);
}
// four (BT, row_ld) tiles of T, two (BT, BT + 4) float tiles, lse and D rows
template <typename T, int HD> __host__ __device__ constexpr size_t smem_bytes() {
  using C = Cfg<HD>;
  return sizeof(T) * 4 * (size_t)C::BT * row_ld<T, HD>() +
         sizeof(float) * (2 * (size_t)C::BT * (C::BT + 4) + 2 * (size_t)C::BT);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// rows [row0, row0 + BT) of head `head` of a contiguous (B, S, heads, HD)
// tensor into a (BT, row_ld) tile; rows at or past S are zero-filled
template <typename T, int HD, int BT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int b, int row0,
                                          int S, int heads, int head) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kChunks = HD / kPer;
  constexpr int LD = row_ld<T, HD>();
  for (int e = threadIdx.x; e < BT * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks;
    const int row = row0 + r;
    const bool in = row < S;
    const T* from = in ? src + (((size_t)b * S + row) * heads + head) * HD + ch * kPer : src;
    cp_async16(dst + r * LD + ch * kPer, from, in);
  }
}

// s[r][c] = A[ty * RS + r] . Bm[tx + TS * c] over HD, both (BT, row_ld) tiles
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&s)[Cfg<HD>::RS][Cfg<HD>::BT / Cfg<HD>::TS],
                                       const T* A, const T* Bm, int ty, int tx) {
  using C = Cfg<HD>;
  constexpr int RS = C::RS, TS = C::TS, CM = C::BT / C::TS, LD = row_ld<T, HD>();
#pragma unroll
  for (int r = 0; r < RS; ++r)
#pragma unroll
    for (int c = 0; c < CM; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[RS], bv[CM];
#pragma unroll
    for (int r = 0; r < RS; ++r) a[r] = load4(A + (ty * RS + r) * LD + d);
#pragma unroll
    for (int c = 0; c < CM; ++c) bv[c] = load4(Bm + (tx + TS * c) * LD + d);
#pragma unroll
    for (int r = 0; r < RS; ++r)
#pragma unroll
      for (int c = 0; c < CM; ++c) s[r][c] = dot4(a[r], bv[c], s[r][c]);
  }
}

// acc[r][4g + e] += sum_kk P[ty * RA + r][kk] * V[kk][4 (tx + TA g) + e], kk < BT;
// P a (BT, BT + 4) float tile, V a (BT, row_ld) tile
template <typename T, int HD>
__device__ __forceinline__ void accumulate(float (&acc)[Cfg<HD>::RA][HD / Cfg<HD>::TA],
                                           const float* P, const T* V, int ty, int tx) {
  using C = Cfg<HD>;
  constexpr int RA = C::RA, TA = C::TA, GPL = HD / 4 / TA, LD = row_ld<T, HD>();
  constexpr int LDP = C::BT + 4;
#pragma unroll 2
  for (int kk = 0; kk < C::BT; kk += 4) {
    float4 pv[RA];
#pragma unroll
    for (int r = 0; r < RA; ++r) pv[r] = load4(P + (ty * RA + r) * LDP + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int g = 0; g < GPL; ++g) {
        const float4 vv = load4(V + (kk + i) * LD + 4 * (tx + TA * g));
#pragma unroll
        for (int r = 0; r < RA; ++r) {
          const float p = at(pv[r], i);
          acc[r][4 * g + 0] = fmaf(p, vv.x, acc[r][4 * g + 0]);
          acc[r][4 * g + 1] = fmaf(p, vv.y, acc[r][4 * g + 1]);
          acc[r][4 * g + 2] = fmaf(p, vv.z, acc[r][4 * g + 2]);
          acc[r][4 * g + 3] = fmaf(p, vv.w, acc[r][4 * g + 3]);
        }
      }
    }
  }
}

// P and dS of one (query tile q0, key tile k0) pair from the scores s = q.k
// and dp = dO.v of this thread's elements; lse_s is in log2 units
struct Grad {
  float scale_log2, cap_in, cap_out;
  int S, Sk, causal, window;
  __device__ __forceinline__ void operator()(float s, float dp, int qi, int kj, float lse2,
                                             float dsum, float& p, float& ds) const {
    const bool ok = qi < S && kj < Sk && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
    p = 0.f;
    ds = 0.f;
    if (!ok) return;
    float x, dcap = 1.f;
    if (cap_out > 0.f) {
      const float t = tanhf(s * cap_in);
      x = cap_out * t;
      dcap = 1.f - t * t;
    } else {
      x = s * scale_log2;
    }
    p = exp2f(x - lse2);
    ds = p * (dp - dsum) * dcap;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dsum_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
            int S, int H, int hd, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, Cfg<HD>::MinB)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int H, int KH,
            float scale, Grad grad) {
  using C = Cfg<HD>;
  constexpr int BT = C::BT, RS = C::RS, TS = C::TS, CM = BT / TS, RA = C::RA, TA = C::TA;
  constexpr int GPL = HD / 4 / TA, LD = row_ld<T, HD>(), LDP = BT + 4;
  static_assert(BT / RS * TS == kThreads && BT / RA * TA == kThreads, "thread tiles");
  static_assert(32 % TS == 0 && 32 % TA == 0 && (HD / 4) % TA == 0, "lane groups");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BT * LD;
  T* Qs = Vs + BT * LD;
  T* dOs = Qs + BT * LD;
  float* PT = reinterpret_cast<float*>(dOs + BT * LD);  // (keys, queries): P transposed
  float* dST = PT + BT * LDP;                           // dS transposed
  float* lse_s = dST + BT * LDP;
  float* D_s = lse_s + BT;

  const int S = grad.S, Sk = grad.Sk;
  const int k0 = blockIdx.x * BT, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x;
  const int ty = tid / TS, tx = tid % TS, ya = tid / TA, xa = tid % TA;

  load_tile<T, HD, BT>(Ks, k, b, k0, Sk, KH, kh);
  load_tile<T, HD, BT>(Vs, v, b, k0, Sk, KH, kh);
  cp_async_commit();

  float dk_acc[RA][4 * GPL], dv_acc[RA][4 * GPL];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int j = 0; j < 4 * GPL; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;

  // the query rows that see a key of this tile (masks only where Sk == S)
  const int q_lo = grad.causal ? k0 : 0;
  const int q_hi = grad.window > 0 ? min(S, k0 + BT - 1 + grad.window) : S;
  const int q_start = (q_lo / BT) * BT;
  for (int h = kh * G; h < (kh + 1) * G; ++h) {
    for (int q0 = q_start; q0 < q_hi; q0 += BT) {
      __syncthreads();  // the previous tile's Qs, dOs, PT, dST, lse_s, D_s are free
      load_tile<T, HD, BT>(Qs, q, b, q0, S, H, h);
      load_tile<T, HD, BT>(dOs, dout, b, q0, S, H, h);
      cp_async_commit();
      for (int i = tid; i < BT; i += kThreads) {
        const int qi = q0 + i;
        const size_t at_row = ((size_t)b * H + h) * S + qi;
        lse_s[i] = qi < S ? lse[at_row] * kLog2e : 0.f;
        D_s[i] = qi < S ? dsum[at_row] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      float s[RS][CM], dp[RS][CM];
      scores<T, HD>(s, Qs, Ks, ty, tx);
      scores<T, HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const int i = ty * RS + r;
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          const int j = tx + TS * c;
          float p, ds;
          grad(s[r][c], dp[r][c], q0 + i, k0 + j, lse_s[i], D_s[i], p, ds);
          PT[j * LDP + i] = p;
          dST[j * LDP + i] = ds;
        }
      }
      __syncthreads();
      accumulate<T, HD>(dv_acc, PT, dOs, ya, xa);
      accumulate<T, HD>(dk_acc, dST, Qs, ya, xa);
    }
  }
  cp_async_wait_all();  // no copy outlives the CTA (a tile with no live query)

#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int kj = k0 + ya * RA + r;
    if (kj >= Sk) continue;
    const size_t at_row = (((size_t)b * Sk + kj) * KH + kh) * HD;
#pragma unroll
    for (int g = 0; g < GPL; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store(&dk[at_row + 4 * (xa + TA * g) + e], dk_acc[r][4 * g + e] * scale);
        store(&dv[at_row + 4 * (xa + TA * g) + e], dv_acc[r][4 * g + e]);
      }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, Cfg<HD>::MinB)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, T* __restrict__ dq, int H, int KH, float scale,
          Grad grad) {
  using C = Cfg<HD>;
  constexpr int BT = C::BT, RS = C::RS, TS = C::TS, CM = BT / TS, RA = C::RA, TA = C::TA;
  constexpr int GPL = HD / 4 / TA, LD = row_ld<T, HD>(), LDP = BT + 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BT * LD;
  T* Ks = dOs + BT * LD;
  T* Vs = Ks + BT * LD;
  float* dSs = reinterpret_cast<float*>(Vs + BT * LD);  // (queries, keys)
  float* lse_s = dSs + BT * LDP;
  float* D_s = lse_s + BT;

  const int S = grad.S, Sk = grad.Sk;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // last tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int ty = tid / TS, tx = tid % TS, ya = tid / TA, xa = tid % TA;
  const int q_end = min(q0 + BT, S);

  load_tile<T, HD, BT>(Qs, q, b, q0, S, H, h);
  load_tile<T, HD, BT>(dOs, dout, b, q0, S, H, h);
  cp_async_commit();
  for (int i = tid; i < BT; i += kThreads) {
    const int qi = q0 + i;
    const size_t at_row = ((size_t)b * H + h) * S + qi;
    lse_s[i] = qi < S ? lse[at_row] * kLog2e : 0.f;
    D_s[i] = qi < S ? dsum[at_row] : 0.f;
  }

  float acc[RA][4 * GPL];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int j = 0; j < 4 * GPL; ++j) acc[r][j] = 0.f;

  // the forward's live key tiles of this query tile
  const int k_lo = grad.window > 0 ? max(0, q0 - grad.window + 1) : 0;
  const int k_hi = grad.causal ? q_end : Sk;
  for (int k0 = (k_lo / BT) * BT; k0 < k_hi; k0 += BT) {
    __syncthreads();  // the previous tile's Ks, Vs and dSs are free
    load_tile<T, HD, BT>(Ks, k, b, k0, Sk, KH, kh);
    load_tile<T, HD, BT>(Vs, v, b, k0, Sk, KH, kh);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[RS][CM], dp[RS][CM];
    scores<T, HD>(s, Qs, Ks, ty, tx);
    scores<T, HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int i = ty * RS + r;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        const int j = tx + TS * c;
        float p, ds;
        grad(s[r][c], dp[r][c], q0 + i, k0 + j, lse_s[i], D_s[i], p, ds);
        dSs[i * LDP + j] = ds;
      }
    }
    __syncthreads();
    accumulate<T, HD>(acc, dSs, Ks, ya, xa);
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int qi = q0 + ya * RA + r;
    if (qi >= S) continue;
    const size_t at_row = (((size_t)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < GPL; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(&dq[at_row + 4 * (xa + TA * g) + e], acc[r][4 * g + e] * scale);
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* dsum, void* dq, void* dk, void* dv, int B, int S,
                   int Sk, int H, int KH, int causal, int window, float softcap,
                   cudaStream_t stream) {
  using C = Cfg<HD>;
  constexpr size_t smem = smem_bytes<T, HD>();
  static bool opted_in = false;  // the attributes are set once per instantiation
  if (!opted_in) {
    cudaError_t err = opt_in(dkdv_kernel<T, HD>, smem);
    if (err == cudaSuccess) err = opt_in(dq_kernel<T, HD>, smem);
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
  const long long rows = (long long)B * S * H;
  dsum_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                   stream>>>(static_cast<const T*>(o), dot, dsum, S, H, HD, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, HD><<<dim3((Sk + C::BT - 1) / C::BT, KH, B), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), H, KH, scale, grad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, HD><<<dim3((S + C::BT - 1) / C::BT, H, B), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), H, KH, scale, grad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                     void* dv, int B, int S, int Sk, int H, int KH, int hd, int causal,
                     int window, float softcap, cudaStream_t s) {
#define REPRO_FLASH_BWD_CASE(D)                                                              \
  case D:                                                                                    \
    return launch<T, D>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Sk, H, KH, causal,   \
                        window, softcap, s)
  switch (hd) {
    REPRO_FLASH_BWD_CASE(16);
    REPRO_FLASH_BWD_CASE(32);
    REPRO_FLASH_BWD_CASE(64);
    REPRO_FLASH_BWD_CASE(80);
    REPRO_FLASH_BWD_CASE(128);
    REPRO_FLASH_BWD_CASE(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_BWD_CASE
}

}  // namespace

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, Sk, KH, hd); all contiguous,
// 16-byte aligned, float32 or (when is_bf16) bfloat16; lse: (B, H, S) float32,
// the forward's row log-sum-exp (flash_attention_launch); dsum: (B, H, S)
// float32 scratch.  hd one of 16, 32, 64, 80, 128, 256; H % KH == 0; window
// <= 0 means no window; causal or a window only with Sk == S; softcap <= 0
// means none.  Three launches on `stream`: D, then dk and dv, then dq.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          float* dsum, void* dq, void* dk, void* dv, int B,
                                          int S, int Sk, int H, int KH, int hd, int causal,
                                          int window, int is_bf16, float softcap, void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || KH < 1 || H % KH != 0 || B > 65535 || H > 65535 ||
      (Sk != S && (causal || window > 0)) || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S,
                                                 Sk, H, KH, hd, causal, window, softcap, s)
                       : dispatch<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Sk, H,
                                         KH, hd, causal, window, softcap, s));
}
