// Forward flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's
// kernels/flash_attention.py (flash_attention, body _fa_kernel).  For query
// q_i of head h (i < S) and the keys k_j, values v_j of kv head h / (H / KH)
// (j < Sk):
//   out_i = sum_j softmax_j(q_i . k_j / sqrt(hd)) v_j   over the live j,
// where j is live when j <= i (causal) and i - j < window (window set).  Sk
// is S for self-attention; whisper's cross-attention runs S decoder queries
// over Sk = T encoded frames (1,500 for 30 s of audio) with neither mask,
// which the TPU kernel did not take (it asserted one length).  Same
// function as kernels/ref.py::flash_attention_ref: masked logits never count,
// the running (m, l, acc) are float32, out = acc / max(l, 1e-30) in q's type.
// A logit softcap (gemma-style, softcap > 0) replaces each scaled logit u by
// softcap * tanh(u / softcap) before the mask, as the JAX package's sdpa
// does.  When the caller wants a gradient it passes lse, and the kernel
// writes each row's log-sum-exp of the live logits there, (B, H, S) float32
// in natural-log units: ln l + m.  flash_attention_bwd.cu recomputes the
// probabilities from it; lse is null on the serving path, which writes
// nothing more than before.
// The value head dim HDV may differ from the q/k head dim HD: MLA's prefill
// (deepseek-v3) attends with q/k heads of 192 (nope 128 + rope 64) and value
// heads of 128, instantiated as (192, 128).  K and V are read at a head
// stride the caller gives, so MLA's V is read in place as the tail of each
// head's [k_nope | v] row, with no copy.
//
// What bounds it on this card: operations.  At minicpm-2b prefill (B=1,
// S=1024, H=36, hd=64, causal) it does ~4.8 GFLOP against ~38 MB of q, k, v
// and out, far above the float32 ridge.  Tensor cores are not used: TF32 or
// bf16 products would miss the float32 tolerance (2e-5) this kernel is held to.
//
// Design.  The TPU kernel walked the kv blocks as the sequential last grid
// axis with (m, l, acc) in VMEM scratch.  Here one CTA takes one (head,
// batch, BQ-row q tile) and loops over the kv tiles itself, visiting only the
// tiles the causal mask and the window leave live.  What it does about the
// operation bound, on CUDA cores:
//   - register tiles: the threads form (BQ / RM) row groups of TC lanes; a
//     thread owns RM query rows x BK / TC keys of the scores (8 x 4 at
//     hd=64) and RM rows x its float4 column groups of acc.  Q, K and V sit
//     in shared memory row-major with a 16-byte pad, so both products read
//     float4: q.k takes RM + BK/TC float4 loads per 4 * RM * BK/TC FMAs,
//     P.V RM + 4 * groups per 16 * RM * groups (>= 10 FMAs per load at
//     hd=64, against 2 with scalar reads of a 4 x 4 tile).  A lane's keys
//     are strided by TC, so the float4 reads of K rows fall in distinct banks;
//   - cp.async: K and V tiles are copied 16 bytes at a time straight to
//     shared memory (cp.async.cg, zero-filled past Sk), K_{j+1} while P.V of
//     tile j runs and V_{j+1} while the scores of tile j+1 run, so one K and
//     one V buffer overlap every copy with math; bf16 stays bf16 in shared
//     memory and is converted when read;
//   - exp2f with scale * log2(e) folded into the scores;
//   - the q tiles launch last-first, so under the causal mask the longest
//     CTAs start first and the tail is short; at 1,024 tokens, 64-row tiles
//     give 576 CTAs at minicpm-2b width, three per SM.
// Masks are per element, so any S and Sk work (the TPU kernel asserted
// S % block == 0): a key tile stops at Sk, its rows past Sk are zero-filled
// and masked.  q, k and v must be 16-byte aligned (the wrapper checks).
//
// At MLA's (192, 128) the work is 4 x 160 operations a live pair against 1.3
// KB of q/k/v a row: in bfloat16 at deepseek-v3 prefill (S=1024, 128 heads)
// ~11 GFLOP, bound by operations at the bf16 tensor-core rate, which these
// CUDA-core products do not reach (ROADMAP Queue 2: a tensor-core path).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// BQ query rows per CTA, BK keys per tile, RM rows and TC lanes per row group
template <int HD> struct Cfg;
template <> struct Cfg<16> { static constexpr int BQ = 64, BK = 16, RM = 8, TC = 4, MinB = 1; };
template <> struct Cfg<32> { static constexpr int BQ = 64, BK = 32, RM = 8, TC = 8, MinB = 1; };
template <> struct Cfg<64> { static constexpr int BQ = 64, BK = 64, RM = 8, TC = 16, MinB = 3; };
template <> struct Cfg<80> { static constexpr int BQ = 64, BK = 16, RM = 4, TC = 4, MinB = 1; };
template <> struct Cfg<128> { static constexpr int BQ = 64, BK = 64, RM = 4, TC = 16, MinB = 1; };
template <> struct Cfg<256> { static constexpr int BQ = 64, BK = 64, RM = 4, TC = 16, MinB = 1; };
template <> struct Cfg<192> { static constexpr int BQ = 64, BK = 64, RM = 4, TC = 16, MinB = 1; };

template <int HD> __host__ __device__ constexpr int threads() {
  return Cfg<HD>::BQ / Cfg<HD>::RM * Cfg<HD>::TC;
}
// shared-memory row of Q, K and V in elements: the head dim plus 16 bytes
template <typename T, int HD> __host__ __device__ constexpr int row_ld() {
  return HD + 16 / (int)sizeof(T);
}
template <typename T, int HD, int HDV> constexpr size_t smem_bytes() {
  using C = Cfg<HD>;
  return sizeof(T) * ((size_t)(C::BQ + C::BK) * row_ld<T, HD>() +
                      (size_t)C::BK * row_ld<T, HDV>()) +
         sizeof(float) * (size_t)C::BQ * (C::BK + 4);
}

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
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [row0, row0 + R) of head `head` of a (B, S, heads, HD) tensor whose
// heads lie ld elements apart (ld = HD when contiguous) into a (R, row_ld)
// tile; rows at or past S are zero-filled (S: the tensor's own length, S for
// q, Sk for k and v)
template <typename T, int HD, int R, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int b, int row0,
                                          int S, int heads, int head, int ld) {
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int kChunks = HD / kPer;         // copies per row
  constexpr int LD = row_ld<T, HD>();
  for (int e = threadIdx.x; e < R * kChunks; e += NT) {
    const int r = e / kChunks, ch = e % kChunks;
    const int row = row0 + r;
    const bool in = row < S;
    const T* from = in ? src + (((size_t)b * S + row) * heads + head) * ld + ch * kPer : src;
    cp_async16(dst + r * LD + ch * kPer, from, in);
  }
}

// CAP: the logit softcap, a template parameter so that the serving path's
// score loop carries no branch for it
template <typename T, int HD, int HDV, bool CAP>
__global__ void __launch_bounds__(threads<HD>(), Cfg<HD>::MinB)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, float* __restrict__ lse, int S, int Sk, int H,
                       int KH, int ldk, int ldv, float scale_log2, float cap_in, float cap_out,
                       int causal, int window) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, RM = C::RM, TC = C::TC;
  constexpr int NT = threads<HD>();
  constexpr int CM = BK / TC;               // score columns per thread
  constexpr int NG = HDV / 4;               // float4 column groups of acc
  constexpr int GPL = NG / TC;              // groups per lane
  constexpr int LD = row_ld<T, HD>();
  constexpr int LDV = row_ld<T, HDV>();
  constexpr int LDP = BK + 4;
  static_assert(BK % TC == 0 && NG % TC == 0 && 32 % TC == 0 && BQ % RM == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // (BQ, LD)
  T* Ks = Qs + BQ * LD;                    // (BK, LD)
  T* Vs = Ks + BK * LD;                    // (BK, LDV)
  float* Ps = reinterpret_cast<float*>(Vs + BK * LDV);  // (BQ, LDP) probabilities

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // last tile first
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, ty = tid / TC, tx = tid % TC;
  const int q_end = min(q0 + BQ, S);

  // live keys of this q tile: [k_lo, k_hi) (causal and window only where
  // Sk == S, which the wrapper checks)
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_end : Sk;
  const int k_start = (k_lo / BK) * BK;

  load_tile<T, HD, BQ, NT>(Qs, q, b, q0, S, H, h, HD);
  load_tile<T, HD, BK, NT>(Ks, k, b, k_start, Sk, KH, kh, ldk);
  cp_async_commit();
  load_tile<T, HDV, BK, NT>(Vs, v, b, k_start, Sk, KH, kh, ldv);
  cp_async_commit();

  float m[RM], l[RM], acc[RM][4 * GPL];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * GPL; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = k_start; k0 < k_hi; k0 += BK) {
    const bool more = k0 + BK < k_hi;
    cp_async_wait<1>();  // Q and K_j have landed (V_j may be in flight)
    __syncthreads();

    float s[RM][CM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CM; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RM], kv[CM];
#pragma unroll
      for (int r = 0; r < RM; ++r) qv[r] = load4(Qs + (ty * RM + r) * LD + d);
#pragma unroll
      for (int c = 0; c < CM; ++c) kv[c] = load4(Ks + (tx + TC * c) * LD + d);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < CM; ++c) s[r][c] = dot4(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int qi = q0 + ty * RM + r;
      bool ok[CM];
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        const int kj = k0 + tx + TC * c;
        ok[c] = kj < Sk && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
        if constexpr (CAP) {
          s[r][c] = cap_out * tanhf(s[r][c] * cap_in);
        } else {
          s[r][c] *= scale_log2;
        }
        if (ok[c]) mt = fmaxf(mt, s[r][c]);
      }
#pragma unroll
      for (int off = TC / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = exp2f(m[r] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        const float p = ok[c] ? exp2f(s[r][c] - m_new) : 0.f;
        Ps[(ty * RM + r) * LDP + tx + TC * c] = p;
        ls += p;
      }
#pragma unroll
      for (int off = TC / 2; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
      l[r] = l[r] * alpha + ls;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * GPL; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();  // K_j is free and P is visible
    if (more) load_tile<T, HD, BK, NT>(Ks, k, b, k0 + BK, Sk, KH, kh, ldk);
    cp_async_commit();
    cp_async_wait<1>();  // V_j has landed (K_{j+1} may be in flight)
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) pv[r] = load4(Ps + (ty * RM + r) * LDP + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int g = 0; g < GPL; ++g) {
          const float4 vv = load4(Vs + (kk + i) * LDV + 4 * (tx + TC * g));
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float p = at(pv[r], i);
            acc[r][4 * g + 0] = fmaf(p, vv.x, acc[r][4 * g + 0]);
            acc[r][4 * g + 1] = fmaf(p, vv.y, acc[r][4 * g + 1]);
            acc[r][4 * g + 2] = fmaf(p, vv.z, acc[r][4 * g + 2]);
            acc[r][4 * g + 3] = fmaf(p, vv.w, acc[r][4 * g + 3]);
          }
        }
      }
    }
    __syncthreads();  // V_j and P are free
    if (more) load_tile<T, HDV, BK, NT>(Vs, v, b, k0 + BK, Sk, KH, kh, ldv);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy outlives the CTA

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int qi = q0 + ty * RM + r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    if (lse != nullptr && tx == 0) lse[((size_t)b * H + h) * S + qi] = (m[r] + log2f(l[r])) * kLn2;
    T* out = o + (((size_t)b * S + qi) * H + h) * HDV;
#pragma unroll
    for (int g = 0; g < GPL; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(&out[4 * (tx + TC * g) + e], acc[r][4 * g + e] * inv);
  }
}

template <typename T, int HD, int HDV, bool CAP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int Sk, int H, int KH, int ldk, int ldv, int causal, int window,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD, HDV>();
  static bool opted_in = false;  // the attribute is set once per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD, HDV, CAP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  if (ldk < HD || ldv < HDV || (ldk * sizeof(T)) % 16 || (ldv * sizeof(T)) % 16)
    return cudaErrorInvalidValue;
  const dim3 grid(H, B, (S + Cfg<HD>::BQ - 1) / Cfg<HD>::BQ);
  const float scale = 1.0f / sqrtf((float)HD);
  flash_attention_kernel<T, HD, HDV, CAP><<<grid, threads<HD>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, Sk, H, KH, ldk, ldv, scale * kLog2e,
      CAP ? scale / softcap : 0.f, CAP ? softcap * kLog2e : 0.f, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int S, int Sk, int H, int KH, int hd, int hd_v, int ldk, int ldv, int causal,
                     int window, float softcap, cudaStream_t s) {
#define REPRO_FLASH_CASE(D, DV)                                                             \
  if (hd == D && hd_v == DV)                                                                \
    return softcap > 0.f                                                                    \
               ? launch<T, D, DV, true>(q, k, v, o, lse, B, S, Sk, H, KH, ldk, ldv, causal, \
                                        window, softcap, s)                                 \
               : launch<T, D, DV, false>(q, k, v, o, lse, B, S, Sk, H, KH, ldk, ldv, causal,\
                                         window, softcap, s)
  REPRO_FLASH_CASE(16, 16);
  REPRO_FLASH_CASE(32, 32);
  REPRO_FLASH_CASE(64, 64);
  REPRO_FLASH_CASE(80, 80);
  REPRO_FLASH_CASE(128, 128);
  REPRO_FLASH_CASE(256, 256);
  REPRO_FLASH_CASE(192, 128);  // MLA: nope + rope against v
#undef REPRO_FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B, S, H, hd), o: (B, S, H, hd_v), both contiguous; k: (B, Sk, KH, hd)
// and v: (B, Sk, KH, hd_v) with their heads ldk and ldv elements apart (the
// head dim when contiguous; each a multiple of 16 bytes); all 16-byte
// aligned, float32 or (when is_bf16) bfloat16.  H % KH == 0; (hd, hd_v) with
// hd_v == hd one of 16, 32, 64, 80, 128, 256, or (192, 128); window <= 0
// means no window; causal or a window only with Sk == S; softcap <= 0 means
// none.  lse: null, or (B, H, S) float32 for the rows' log-sum-exp.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int B, int S, int Sk, int H, int KH, int hd,
                                      int hd_v, int ldk, int ldv, int causal, int window,
                                      int is_bf16, float softcap, void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || KH < 1 || H % KH != 0 || B > 65535 ||
      (Sk != S && (causal || window > 0)) || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, B, S, Sk, H, KH, hd, hd_v,
                                                 ldk, ldv, causal, window, softcap, s)
                       : dispatch<float>(q, k, v, o, lse, B, S, Sk, H, KH, hd, hd_v, ldk, ldv,
                                         causal, window, softcap, s));
}
