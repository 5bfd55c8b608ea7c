// One-token decode attention (flash-decoding) for Hopper (sm_90a), in one
// launch.
//
// Replaces the Pallas TPU kernel of the JAX package's
// kernels/decode_attention.py (decode_attention, body _dec_kernel).  For the
// new token's query q_h of head h, against the cache rows of kv head
// h / (H / KH):
//   out_h = sum_p softmax_p(q_h . k_p / sqrt(hd)) v_p   over the live p,
// where p is live when p <= valid_len and, with a window, valid_len - p <
// window.  valid_len is one length for the batch or one per batch row
// (continuous batching: each slot at its own age).  Same function as
// kernels/ref.py::decode_attention_ref, with the running (m, l, acc) in
// float32 and out = acc / max(l, 1e-30) in q's type (zeros for a row with no
// live position, as the Pallas kernel writes).  q is float32 or bfloat16;
// the cache is float32, bfloat16 or float8_e4m3fn, read in its own type and
// converted to float32 in registers (fp8 through cuda_fp8.h, which converts
// exactly), as _dec_kernel upcasts each tile.  A logit softcap (softcap > 0)
// replaces each scaled logit u by softcap * tanh(u / softcap) before the mask,
// as the JAX package's sdpa does.
//
// What bounds it on this card: bytes, at the cache's element size.  Each
// live K/V row is read once and used for 4 x G x hd operations, so at
// minicpm-2b width (KH=36, hd=64, ~1,025 live rows, ~19 MB in float32) the
// cache takes ~5.6 us at 3.35 TB/s; an fp8 cache moves a quarter of those
// bytes.  One call is one short wave, so what it pays besides the bytes is
// fixed per call: the launch, each CTA's prologue and epilogue, and the
// merge of the splits.
//
// Design:
// * Geometry from the shapes only (kernels/ops.py::decode_geometry: B, KH,
//   G, hd, the cache's element size and the SM count), never from
//   valid_len: grid (splits, KH x head groups, B), one wave of up to 4 CTAs
//   an SM.  Each CTA reads its batch row's valid_len itself (from device
//   memory when the caller passed a tensor, so a captured CUDA graph can be
//   replayed with new values), derives [lo, hi] and takes an equal share of
//   it in whole 16-row granules (ops.py::decode_share is the same
//   arithmetic); a CTA with an empty share writes an empty partial.
// * No shared memory and no barrier on the per-row path.  A row of hd
//   elements is read by LPR lanes with 16-byte loads (hd=64 float32: 16
//   lanes, so one load instruction covers two rows; an fp8 row carries 16
//   values a load).  Each warp owns a
//   contiguous run of its CTA's rows and streams them through registers in
//   batches of U row groups: as soon as a batch is unpacked its registers
//   take the loads of the next batch, so one batch is in flight while the
//   other is computed.  The U dot products of a batch reduce with shuffles
//   inside each row's lanes, interleaved, and the online softmax rescales
//   once a batch (one max, U + 1 exponentials).  q (GB heads), m, l and the
//   lane's slice of acc stay in registers.  The sub-groups of a warp merge
//   by shuffles, the warps of a CTA once through shared memory.  Deeper
//   batches, and a cp.async ring in shared memory 6-16 row groups deep, were
//   no faster on the card (PERF.md, section 6).
// * Heads per pass GB keeps q and acc within ~32 registers a lane (G=1 and
//   G=2 at the model widths take one pass; G=32 takes several, each a head
//   group of its own in the grid, re-reading the rows).
// * The splits merge in the same launch: each CTA writes its partial
//   (m, l, acc) in float32 and thread 0 takes a ticket per (batch, kv head,
//   head group) with an acquire-release atomic add; the CTA that draws the
//   last ticket merges the partials (still in L2, read with ld.cg, 8 splits'
//   loads in flight a thread) and writes out, then resets the ticket to 0
//   for the next call or graph replay.
// Positions outside [lo, hi] are never read.
//
// The absorbed-MLA entry (decode_attention_latent_launch, below) is the same
// function on DeepSeek-V2/V3's latent cache: every query head reads the one
// latent row of a position, so it is laid out by head groups over a row
// tile instead; its own note follows.

#include <cuda.h>  // CUtensorMap and the types of its encoder
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxG = 32;        // query heads per kv head
constexpr int kMaxSplits = 1024;
constexpr int kShareRows = 16;   // a CTA's share is a whole number of these
constexpr int kMerge = 8;        // splits a merging thread loads at a time
constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pow2ceil(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// the cache's geometry: T is the cache's element type
template <typename T, int HD>
struct Cfg {
  static constexpr int VEC = 16 / (int)sizeof(T);       // elements in one 16-byte load
  static constexpr int CH = HD / VEC;                   // 16-byte chunks in a row
  static constexpr int LPR = CH >= 32 ? 32 : pow2ceil(CH);  // lanes a row (hd=80: some idle)
  static constexpr int NCH = (CH + LPR - 1) / LPR;      // chunks a lane per row
  static constexpr int RPW = 32 / LPR;                  // rows a warp per load instruction
  static constexpr int E = NCH * VEC;                   // elements a lane per row
  static constexpr int GB = E >= 16 ? 1 : 16 / E;       // heads per pass (ops.decode_heads_per_pass)
  static constexpr int U = 2;                           // row groups a batch
  static constexpr int WARPS = HD * (int)sizeof(T) >= 1024 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static_assert(GB * HD / 4 <= THREADS, "one merge column of 4 a thread");
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 loaded bytes of cache elements of type T as floats
template <typename T>
__device__ void unpack(const uint4& x, float (&f)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& x, float (&f)[4]) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& x, float (&f)[8]) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bfloat16 pairs, low half first
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack<__nv_fp8_e4m3>(const uint4& x, float (&f)[16]) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // e4m3 pairs, low byte first; exact through half
      const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * j)) & 0xffffu), __NV_E4M3));
      const float2 v = __half22float2(h);
      f[4 * i + 2 * j] = v.x;
      f[4 * i + 2 * j + 1] = v.y;
    }
  }
}

// TQ: q's and out's type; TC: the cache's
template <typename TQ, typename TC, int HD>
__global__ void __launch_bounds__(Cfg<TC, HD>::THREADS, 16 / Cfg<TC, HD>::WARPS)
decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
              TQ* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets,
              const int* __restrict__ valid_dev, int valid_stride, int valid_host, int S,
              int KH, int G, int window, float scale_log2, float cap_in, float cap_out) {
  using C = Cfg<TC, HD>;
  constexpr int VEC = C::VEC, CH = C::CH, LPR = C::LPR, NCH = C::NCH, RPW = C::RPW;
  constexpr int GB = C::GB, U = C::U, WARPS = C::WARPS, THREADS = C::THREADS;
  __shared__ float s_acc[WARPS][GB][HD];
  __shared__ float s_m[WARPS][GB], s_l[WARPS][GB];
  __shared__ float4 s_red[THREADS];
  __shared__ float s_rm[THREADS], s_rl[THREADS];
  __shared__ int s_last;

  const int split = blockIdx.x, splits = gridDim.x;
  const int n_hg = gridDim.y / KH, kh = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int b = blockIdx.z;
  const int unit = b * gridDim.y + blockIdx.y;  // (batch, kv head, head group)
  const int ng = min(GB, G - hg * GB);
  const int H = KH * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR, sl = lane % LPR;

  // this CTA's share of its row's live range, then this warp's run of it
  const long long valid =
      valid_dev ? (long long)valid_dev[(size_t)b * valid_stride] : (long long)valid_host;
  const long long lo = window > 0 ? max(0LL, valid - window + 1) : 0LL;
  const long long hi = min(valid, (long long)S - 1);
  int beg = 0, end = 0;
  if (hi >= lo) {
    const long long n = hi - lo + 1;
    const long long per = ((n + kShareRows - 1) / kShareRows + splits - 1) / splits * kShareRows;
    const long long bb = lo + split * per, ee = min(hi + 1, bb + per);
    if (ee > bb) {
      beg = (int)bb;
      end = (int)ee;
    }
  }
  const int per_w = (end - beg + WARPS - 1) / WARPS;
  const int wbeg = beg + warp * per_w;
  const int wend = min(end, wbeg + per_w);
  const int n_it = wend > wbeg ? (wend - wbeg + RPW - 1) / RPW : 0;

  float qr[GB][NCH][VEC], acc[GB][NCH][VEC], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = sl + c * LPR;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[g][c][e] = 0.f;
        qr[g][c][e] = (g < ng && chunk < CH)
            ? to_f(q[((size_t)b * H + kh * G + hg * GB + g) * HD + chunk * VEC + e]) : 0.f;
      }
    }
  }

  const size_t row_stride = (size_t)KH * HD;
  const TC* kbase = kc + ((size_t)b * S * KH + kh) * HD;
  const TC* vbase = vc + ((size_t)b * S * KH + kh) * HD;
  uint4 kb[U][NCH], vb[U][NCH];
#pragma unroll
  for (int s = 0; s < U; ++s)
#pragma unroll
    for (int c = 0; c < NCH; ++c) kb[s][c] = vb[s][c] = make_uint4(0u, 0u, 0u, 0u);

#define REPRO_DECODE_LOAD(S_, IT_)                                                       \
  do {                                                                                   \
    const int row_ = wbeg + (IT_) * RPW + sub;                                           \
    if ((IT_) < n_it && row_ < wend) {                                                   \
      _Pragma("unroll") for (int c = 0; c < NCH; ++c) {                                  \
        const int chunk = sl + c * LPR;                                                  \
        if (chunk < CH) {                                                                \
          const size_t at = (size_t)row_ * row_stride + chunk * VEC;                     \
          kb[S_][c] = __ldg(reinterpret_cast<const uint4*>(kbase + at));                 \
          vb[S_][c] = __ldg(reinterpret_cast<const uint4*>(vbase + at));                 \
        }                                                                                \
      }                                                                                  \
    }                                                                                    \
  } while (0)

#pragma unroll
  for (int s = 0; s < U; ++s) REPRO_DECODE_LOAD(s, s);

  for (int base = 0; base < n_it; base += U) {
    float kf[U][NCH][VEC], vf[U][NCH][VEC];
    bool ok[U];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      ok[s] = base + s < n_it && wbeg + (base + s) * RPW + sub < wend;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        unpack<TC>(kb[s][c], kf[s][c]);
        unpack<TC>(vb[s][c], vf[s][c]);
      }
      REPRO_DECODE_LOAD(s, base + s + U);
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < ng) {
        float d[U];
#pragma unroll
        for (int s = 0; s < U; ++s) {
          d[s] = 0.f;
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int e = 0; e < VEC; ++e) d[s] = fmaf(qr[g][c][e], kf[s][c][e], d[s]);
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
          for (int s = 0; s < U; ++s) d[s] += __shfl_xor_sync(0xffffffffu, d[s], o);
        float mn = m[g];
#pragma unroll
        for (int s = 0; s < U; ++s) {
          d[s] = cap_out > 0.f ? cap_out * tanhf(d[s] * cap_in) : d[s] * scale_log2;
          if (ok[s]) mn = fmaxf(mn, d[s]);
        }
        const float al = exp2f(m[g] - mn);
        l[g] *= al;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][c][e] *= al;
#pragma unroll
        for (int s = 0; s < U; ++s) {
          if (ok[s]) {
            const float p = exp2f(d[s] - mn);
            l[g] += p;
#pragma unroll
            for (int c = 0; c < NCH; ++c)
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[g][c][e] = fmaf(p, vf[s][c][e], acc[g][c][e]);
          }
        }
        m[g] = mn;
      }
    }
  }
#undef REPRO_DECODE_LOAD

  // merge the RPW row sub-groups of the warp (lanes sl, sl + LPR, ... hold
  // the same columns)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < ng) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mn = fmaxf(m[g], mo);
        const float a = exp2f(m[g] - mn), bo = exp2f(mo - mn);
        l[g] = l[g] * a + lo_ * bo;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][c][e] = acc[g][c][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][c][e], o) * bo;
        m[g] = mn;
      }
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < ng) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int chunk = sl + c * LPR;
          if (chunk < CH) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) s_acc[warp][g][chunk * VEC + e] = acc[g][c][e];
          }
        }
        if (lane == 0) {
          s_m[warp][g] = m[g];
          s_l[warp][g] = l[g];
        }
      }
    }
  }
  __syncthreads();

  // this CTA's partial: acc (units, splits, GB, HD), then (m, l) (units,
  // splits, 2, GB)
  const int n_units = gridDim.z * gridDim.y;
  float* acc_part = part;
  float* ml_part = part + (size_t)n_units * splits * GB * HD;
  const size_t pidx = (size_t)unit * splits + split;
  for (int i = threadIdx.x; i < ng * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = exp2f(s_m[w][g] - M);
      L += s_l[w][g] * a;
      A += s_acc[w][g][d] * a;
    }
    acc_part[pidx * GB * HD + i] = A;
    if (d == 0) {
      ml_part[pidx * 2 * GB + g] = M;
      ml_part[pidx * 2 * GB + GB + g] = L;
    }
  }
  __syncthreads();  // every store of the partial issued; thread 0 releases them
  if (threadIdx.x == 0) {  // acquire-release: the last CTA sees every partial
    int t;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(t) : "l"(&tickets[unit]) : "memory");
    s_last = t == splits - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last CTA of this unit merges the splits' partials: each thread
  // takes one column of 4 floats over every phases-th split, loading kMerge
  // splits' (m, l, acc) at a time (independent loads, one L2 round trip
  // each batch) and merging them online; then the phases merge in shared
  // memory
  const float* accs = acc_part + (size_t)unit * splits * GB * HD;
  const float* mls = ml_part + (size_t)unit * splits * 2 * GB;
  const int nq = ng * HD / 4;  // columns of 4 floats
  const int phases = THREADS / nq;
  const int qd = threadIdx.x % nq, ph = threadIdx.x / nq, gq = qd * 4 / HD;
  float M = kNegInf, L = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ph < phases) {
    for (int i0 = ph; i0 < splits; i0 += kMerge * phases) {
      float mm[kMerge], ll[kMerge];
      float4 x[kMerge];
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        const int i = i0 + j * phases;
        if (i < splits) {
          mm[j] = __ldcg(mls + i * 2 * GB + gq);
          ll[j] = __ldcg(mls + i * 2 * GB + GB + gq);
          x[j] = __ldcg(reinterpret_cast<const float4*>(accs + (size_t)i * GB * HD) + qd);
        } else {
          mm[j] = kNegInf;
          ll[j] = 0.f;
          x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      float mb = M;
#pragma unroll
      for (int j = 0; j < kMerge; ++j) mb = fmaxf(mb, mm[j]);
      const float r = exp2f(M - mb);
      L *= r;
      a = make_float4(a.x * r, a.y * r, a.z * r, a.w * r);
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        const float w = exp2f(mm[j] - mb);
        L = fmaf(ll[j], w, L);
        a = make_float4(fmaf(x[j].x, w, a.x), fmaf(x[j].y, w, a.y), fmaf(x[j].z, w, a.z),
                        fmaf(x[j].w, w, a.w));
      }
      M = mb;
    }
  }
  s_red[threadIdx.x] = a;
  s_rm[threadIdx.x] = M;
  s_rl[threadIdx.x] = L;
  __syncthreads();
  if (threadIdx.x < nq) {
    for (int p = 1; p < phases; ++p) M = fmaxf(M, s_rm[p * nq + qd]);
    float Lt = 0.f;
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < phases; ++p) {
      const float w = exp2f(s_rm[p * nq + qd] - M);
      const float4 y = s_red[p * nq + qd];
      Lt = fmaf(s_rl[p * nq + qd], w, Lt);
      a = make_float4(fmaf(y.x, w, a.x), fmaf(y.y, w, a.y), fmaf(y.z, w, a.z), fmaf(y.w, w, a.w));
    }
    const float inv = 1.f / fmaxf(Lt, 1e-30f);
    TQ* o = out + ((size_t)b * H + kh * G + hg * GB) * HD + qd * 4;
    store(o, a.x * inv);
    store(o + 1, a.y * inv);
    store(o + 2, a.z * inv);
    store(o + 3, a.w * inv);
  }
  if (threadIdx.x == 0) tickets[unit] = 0;  // ready for the next call
}

template <typename TQ, typename TC, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* out, float* part,
                   int* tickets, const int* valid_dev, int valid_stride, int valid_host, int B,
                   int S, int H, int KH, int window, float softcap, int gb, int splits,
                   cudaStream_t stream) {
  using C = Cfg<TC, HD>;
  const int G = H / KH;
  if (gb != C::GB) return cudaErrorInvalidValue;
  const int n_hg = (G + C::GB - 1) / C::GB;
  const float scale = 1.0f / sqrtf((float)HD);
  decode_kernel<TQ, TC, HD><<<dim3(splits, KH * n_hg, B), C::THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc), static_cast<const TC*>(vc),
      static_cast<TQ*>(out), part, tickets, valid_dev, valid_stride, valid_host, S, KH, G,
      window, scale * kLog2e, softcap > 0.f ? scale / softcap : 0.f,
      softcap > 0.f ? softcap * kLog2e : 0.f);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t dispatch(const void* q, const void* kc, const void* vc, void* out, float* part,
                     int* tickets, const int* valid_dev, int valid_stride, int valid_host, int B,
                     int S, int H, int KH, int hd, int window, float softcap, int gb, int splits,
                     cudaStream_t s) {
#define REPRO_DECODE_CASE(D)                                                                 \
  case D:                                                                                    \
    return launch<TQ, TC, D>(q, kc, vc, out, part, tickets, valid_dev, valid_stride,        \
                             valid_host, B, S, H, KH, window, softcap, gb, splits, s)
  switch (hd) {
    REPRO_DECODE_CASE(16);
    REPRO_DECODE_CASE(32);
    REPRO_DECODE_CASE(64);
    REPRO_DECODE_CASE(80);
    REPRO_DECODE_CASE(128);
    REPRO_DECODE_CASE(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CASE
}

template <typename TQ>
cudaError_t dispatch_cache(int cache_code, const void* q, const void* kc, const void* vc,
                           void* out, float* part, int* tickets, const int* valid_dev,
                           int valid_stride, int valid_host, int B, int S, int H, int KH, int hd,
                           int window, float softcap, int gb, int splits, cudaStream_t s) {
  switch (cache_code) {
    case 0: return dispatch<TQ, float>(q, kc, vc, out, part, tickets, valid_dev, valid_stride,
                                       valid_host, B, S, H, KH, hd, window, softcap, gb, splits,
                                       s);
    case 1: return dispatch<TQ, __nv_bfloat16>(q, kc, vc, out, part, tickets, valid_dev,
                                               valid_stride, valid_host, B, S, H, KH, hd,
                                               window, softcap, gb, splits, s);
    case 2: return dispatch<TQ, __nv_fp8_e4m3>(q, kc, vc, out, part, tickets, valid_dev,
                                               valid_stride, valid_host, B, S, H, KH, hd,
                                               window, softcap, gb, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ absorbed MLA
// One-token decode against MLA's latent cache (DeepSeek-V2/V3's absorbed
// decode; the JAX package computes it with einsums in
// models/attention.py::mla_decode).  For head h of the new token, with q_lat
// = q_nope absorbed through W_UK (dc wide) and q_rope (dr wide), against the
// latent rows c_p (dc) and rope keys r_p (dr) of the live positions p <=
// valid_len:
//   out_h = sum_p softmax_p((q_lat_h . c_p + q_rope_h . r_p) * scale) c_p,
// (dc, dr) = (512, 64) at deepseek-v3.  Same function as
// kernels/ref.py::decode_attention_latent_ref: float32 running (m, l, acc),
// out = acc / max(l, 1e-30) in q's type, zeros for a row with none live.
//
// What bounds it on this card: all 128 query heads share each cache row, so
// a row of 576 values (1,152 bytes in bfloat16) feeds 128 x 2 x (576 + 512)
// operations, ~242 a byte: just under the bf16 tensor cores' ~295 a byte,
// so bound by bytes, and only on the tensor cores; on the CUDA cores in
// float32 (67 TFLOP/s) the operations take ~12x the bytes' time.  A call is
// one short wave (deepseek-v3's batch: ~2,400 live rows, 2.8 MB, 0.67 GFLOP),
// so what it pays besides is fixed: the launch, each CTA's q load, the
// splits' partials and their merge.
//
// Design, bfloat16 q and cache (latent_tc_kernel; deepseek-v3 serves in
// bfloat16, so every path the card times is here):
// * Grid (splits, head groups of kTcHeads = 64, B), from
//   ops.py::latent_geometry (shapes and SM count only, so a captured call
//   replays with new valid_len), 256 threads: two warpgroups.  Each CTA
//   takes its share of its row's live range in whole 64-row tiles
//   (ops.py::decode_share with that granule); 128 heads are 2 head groups,
//   so each live row is read twice, not 8 times as with 16 heads a CTA.
// * Shared memory: the CTA's 64 heads of [q_lat | q_rope] (64 x 576
//   bfloat16, 72 KB) once, and two 64-row tiles of [c | r] (72 KB each),
//   all as 64-column blocks under the 128-byte swizzle: 221,184 bytes and
//   1 KB to align the swizzle, of the 232,448 a CTA may opt into, so one
//   CTA an SM.  q and every whole tile come by TMA (9 boxes of 64 x 64 from
//   2-D tensor maps over q_lat, q_rope, c and r, issued by one thread,
//   completing on an mbarrier); the share's last rows, when they are not a
//   whole tile, come by cp.async from all threads, zero-filled past the
//   share, so no row past valid_len is read (a box would read them).  The
//   next tile is in flight while one is computed.
// * Scores: each warpgroup computes all of S = Q . [c | r]^T (64 heads x 64
//   rows) with 36 wgmma.m64n64k16 (bf16 in, float32 out, both operands
//   K-major from shared memory), so that P never leaves its registers and
//   the warpgroups share nothing but the tiles: the second copy of the
//   score product costs tensor-core time (~0.6 us a tile), where passing P
//   and the row maxima through shared memory would cost two more barriers
//   a tile.  The online softmax runs on the accumulator fragments in
//   float32 (exp2 of the scores times scale * log2 e); rows past the share
//   are -2e38 before the max, as in the decode kernel.
// * Values: O += P . c with P rounded to bfloat16 and fed from registers
//   (the score accumulator's layout is the A fragment's); warpgroup w owns
//   latent columns [256 w, 256 w + 256): 4 wgmma.m64n256k16 a tile, 128
//   float32 accumulators a thread, B the tile's own c columns read
//   MN-major (the transpose bit), so the tile is never copied twice.
// * Splits: each CTA with a non-empty share writes its partial (m, l and
//   acc, 64 x 512 float32) and a second launch (latent_merge, grid (H, B),
//   counted with the first as one call) merges each head's live splits, 4
//   columns a thread, in a group of threads for each 8 splits (at most 4);
//   it reads valid_len itself to know which splits are live.  No atomics
//   and no tickets: two runs agree bit for bit.  (A cluster of a unit's
//   splits merging through distributed shared memory, and a TMA store of
//   the partial, were no faster on the card: PERF.md, section 6.)
//
// Float32 and mixed q / cache types keep the CUDA-core kernel that follows
// (latent_kernel; no timed path reaches it): the grid is (splits, head
// groups of kLatHeads = 16, B), from ops.py::latent_geometry(...,
// tensor_cores=False).  Each CTA copies tiles of kLatRows = 16 rows of its
// share into shared memory (double-buffered, cp.async, rows outside the
// share zero-filled), and on each tile
//   1. scores: the 16 lanes of a half-warp share a head; lane k holds the
//      head's query chunks k, k + 16, ... (36 of its 576 values, float32 in
//      registers for the whole call) and forms its partial dot with each of
//      the tile's 16 rows; a transposing butterfly (15 shuffles) leaves lane
//      j the score of row j; then the head's online softmax over the tile
//      with 16-lane shuffles;
//   2. values: each thread owns 4 heads x 8 latent columns of acc in
//      registers (16 x 512 float32 over 256 threads) and adds p * c_p for
//      the tile's rows.
// Its splits merge in the same launch through the tickets, as above; the
// last CTA reads splits x 32 KB a head group, so ops.py caps its splits at
// 16.  (ROADMAP Queue 2: a split-precision TF32 path for these types.)
constexpr int kLatHeads = 16;    // query heads a CTA (ops.LATENT_F32_HEADS)
constexpr int kLatRows = 16;     // cache rows a tile (ops.LATENT_F32_ROWS)
constexpr int kLatThreads = kLatHeads * kLatRows;
constexpr int kLatCols = 8;      // latent columns of acc a thread
constexpr int kLatHeadsPer = 4;  // heads of acc a thread
constexpr int kLatChunk = 4;     // query / row elements a chunk of the scores

__device__ __forceinline__ void lat_cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void lat_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void lat_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <typename TC, int DC, int DR>
struct LatCfg {
  static constexpr int DQ = DC + DR;
  static constexpr int LDT = DQ + 16 / (int)sizeof(TC);  // a tile row, padded 16 bytes
  static constexpr int VEC = 16 / (int)sizeof(TC);
  static constexpr int NQ = DQ / (kLatChunk * kLatRows);  // query chunks a lane
  static constexpr size_t smem = sizeof(TC) * 2 * kLatRows * LDT +       // two tiles
                                 sizeof(float) * kLatRows * kLatHeads;   // p
  static_assert(DC % 16 == 0 && DR % 16 == 0, "16-byte chunks of c and r");
  static_assert(DC % kLatChunk == 0 && DQ % (kLatChunk * kLatRows) == 0, "query chunks");
  static_assert(DC / kLatCols * (kLatHeads / kLatHeadsPer) == kLatThreads, "acc layout");
};

__device__ __forceinline__ float4 lat_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lat_load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

// rows [row0, row0 + kLatRows) of the caches into a tile: c in columns
// [0, DC), r in [DC, DC + DR); rows at or past `end` zero-filled
template <typename TC, int DC, int DR>
__device__ __forceinline__ void lat_load_tile(TC* tile, const TC* __restrict__ cc,
                                              const TC* __restrict__ rc, int b, int S, int row0,
                                              int end) {
  using C = LatCfg<TC, DC, DR>;
  constexpr int CC = DC / C::VEC, CR = DR / C::VEC;  // 16-byte chunks of a c and an r row
  for (int e = threadIdx.x; e < kLatRows * (CC + CR); e += kLatThreads) {
    const int r = e / (CC + CR), ch = e % (CC + CR);
    const int row = row0 + r;
    const bool in = row < end;
    const TC* from = ch < CC ? cc + ((size_t)b * S + (in ? row : 0)) * DC + ch * C::VEC
                             : rc + ((size_t)b * S + (in ? row : 0)) * DR + (ch - CC) * C::VEC;
    lat_cp_async16(tile + r * C::LDT + ch * C::VEC, from, in);
  }
}

template <typename TQ, typename TC, int DC, int DR>
__global__ void __launch_bounds__(kLatThreads)
latent_kernel(const TQ* __restrict__ q_lat, const TQ* __restrict__ q_rope,
              const TC* __restrict__ cc, const TC* __restrict__ rc, TQ* __restrict__ out,
              float* __restrict__ part, int* __restrict__ tickets,
              const int* __restrict__ valid_dev, int valid_stride, int valid_host, int S, int H,
              float scale_log2) {
  using C = LatCfg<TC, DC, DR>;
  constexpr int LDT = C::LDT, VEC = C::VEC, NQ = C::NQ;
  extern __shared__ __align__(16) unsigned char lat_smem[];
  TC* tiles = reinterpret_cast<TC*>(lat_smem);                       // 2 x (kLatRows, LDT)
  float* ps = reinterpret_cast<float*>(tiles + 2 * kLatRows * LDT);  // (kLatRows, kLatHeads)
  __shared__ __align__(16) float s_alpha[kLatHeads];
  __shared__ int s_last;

  const int split = blockIdx.x, splits = gridDim.x;
  const int hg = blockIdx.y, b = blockIdx.z;
  const int unit = b * gridDim.y + hg;  // (batch, head group)
  const int h0 = hg * kLatHeads;
  const int tid = threadIdx.x;

  // this CTA's share of its row's live range [0, hi], in whole tiles
  const long long valid =
      valid_dev ? (long long)valid_dev[(size_t)b * valid_stride] : (long long)valid_host;
  const long long hi = min(valid, (long long)S - 1);
  int beg = 0, end = 0;
  if (hi >= 0) {
    const long long n = hi + 1;
    const long long per = ((n + kLatRows - 1) / kLatRows + splits - 1) / splits * kLatRows;
    const long long bb = split * per, ee = min(hi + 1, bb + per);
    if (ee > bb) {
      beg = (int)bb;
      end = (int)ee;
    }
  }
  const int n_tiles = (end - beg + kLatRows - 1) / kLatRows;
  if (n_tiles > 0) lat_load_tile<TC, DC, DR>(tiles, cc, rc, b, S, beg, end);
  lat_commit();

  // scores: thread (sh, sj) = (head, lane of the head's half-warp), which
  // holds the query chunks sj + 16 i and ends with the score of row sj;
  // values: thread (vh, vc) = (heads 4 vh .. 4 vh + 3, latent columns 8 vc ..
  // 8 vc + 7)
  const int sh = tid / kLatRows, sj = tid % kLatRows;
  float4 qr[NQ];
  {
    const size_t row = (size_t)b * H + h0 + sh;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int d = (sj + kLatRows * i) * kLatChunk;  // a chunk never straddles q_lat | q_rope
      const TQ* src = d < DC ? q_lat + row * DC + d : q_rope + row * DR + d - DC;
      qr[i] = make_float4(to_f(src[0]), to_f(src[1]), to_f(src[2]), to_f(src[3]));
    }
  }
  const int vh = tid / (DC / kLatCols), vc = tid % (DC / kLatCols);
  float m = kNegInf, l = 0.f;  // head sh's running max and sum
  float acc[kLatHeadsPer][kLatCols];
#pragma unroll
  for (int i = 0; i < kLatHeadsPer; ++i)
#pragma unroll
    for (int c = 0; c < kLatCols; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int row0 = beg + t * kLatRows;
    if (t + 1 < n_tiles)
      lat_load_tile<TC, DC, DR>(tiles + ((t + 1) & 1) * kLatRows * LDT, cc, rc, b, S,
                                row0 + kLatRows, end);
    lat_commit();
    lat_wait<1>();  // tile t has landed
    __syncthreads();
    const TC* tile = tiles + (t & 1) * kLatRows * LDT;

    // 1. lane sj's partial dots of head sh with every row of the tile, then
    // the transposing butterfly: at each step a lane keeps the half of the
    // rows whose bit `off` matches its own and adds its partner's partials
    // of them, so lane sj ends with the whole score of row sj
    float part[kLatRows];
#pragma unroll
    for (int j = 0; j < kLatRows; ++j) {
      const TC* trow = tile + j * LDT + sj * kLatChunk;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float4 x = lat_load4(trow + i * kLatRows * kLatChunk);
        acc0 = fmaf(qr[i].x, x.x, acc0);
        acc1 = fmaf(qr[i].y, x.y, acc1);
        acc0 = fmaf(qr[i].z, x.z, acc0);
        acc1 = fmaf(qr[i].w, x.w, acc1);
      }
      part[j] = acc0 + acc1;
    }
#pragma unroll
    for (int off = kLatRows / 2; off > 0; off >>= 1) {
      const bool upper = (sj & off) != 0;
#pragma unroll
      for (int r = 0; r < off; ++r) {
        const float send = upper ? part[r] : part[r + off];
        const float keep = upper ? part[r + off] : part[r];
        part[r] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    }
    const bool live = row0 + sj < end;
    const float sc = part[0] * scale_log2;
    float mt = live ? sc : kNegInf;
#pragma unroll
    for (int o = kLatRows / 2; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float mn = fmaxf(m, mt);
    const float alpha = exp2f(m - mn);
    const float p = live ? exp2f(sc - mn) : 0.f;
    float ls = p;
#pragma unroll
    for (int o = kLatRows / 2; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
    l = l * alpha + ls;
    m = mn;
    ps[sj * kLatHeads + sh] = p;
    if (sj == 0) s_alpha[sh] = alpha;
    __syncthreads();

    // 2. acc[head][col] = acc * alpha + sum over the tile's rows of p * c
    const float4 al = *reinterpret_cast<const float4*>(s_alpha + kLatHeadsPer * vh);
    const float alv[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
    for (int i = 0; i < kLatHeadsPer; ++i)
#pragma unroll
      for (int c = 0; c < kLatCols; ++c) acc[i][c] *= alv[i];
#pragma unroll 4
    for (int j = 0; j < kLatRows; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + j * kLatHeads + kLatHeadsPer * vh);
      const float pj[4] = {pv.x, pv.y, pv.z, pv.w};
      float x[kLatCols];
#pragma unroll
      for (int c = 0; c < kLatCols; c += VEC) {
        float y[VEC];
        unpack<TC>(*reinterpret_cast<const uint4*>(tile + j * LDT + vc * kLatCols + c), y);
#pragma unroll
        for (int e = 0; e < VEC && c + e < kLatCols; ++e) x[c + e] = y[e];
      }
#pragma unroll
      for (int i = 0; i < kLatHeadsPer; ++i)
#pragma unroll
        for (int c = 0; c < kLatCols; ++c) acc[i][c] = fmaf(pj[i], x[c], acc[i][c]);
    }
    __syncthreads();  // tile t and p are free for the next copy
  }
  lat_wait<0>();  // no copy outlives the CTA

  // this CTA's partial: acc (units, splits, kLatHeads, DC), then (m, l)
  // (units, splits, 2, kLatHeads)
  const int n_units = gridDim.z * gridDim.y;
  float* acc_part = part;
  float* ml_part = part + (size_t)n_units * splits * kLatHeads * DC;
  const size_t pidx = (size_t)unit * splits + split;
#pragma unroll
  for (int i = 0; i < kLatHeadsPer; ++i) {
    float4* dst = reinterpret_cast<float4*>(
        acc_part + (pidx * kLatHeads + kLatHeadsPer * vh + i) * DC + vc * kLatCols);
#pragma unroll
    for (int c = 0; c < kLatCols; c += 4)
      dst[c / 4] = make_float4(acc[i][c], acc[i][c + 1], acc[i][c + 2], acc[i][c + 3]);
  }
  if (sj == 0) {
    ml_part[pidx * 2 * kLatHeads + sh] = m;
    ml_part[pidx * 2 * kLatHeads + kLatHeads + sh] = l;
  }
  __syncthreads();  // every store of the partial issued; thread 0 releases them
  if (tid == 0) {   // acquire-release: the last CTA sees every partial
    int tk;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(tk) : "l"(&tickets[unit]) : "memory");
    s_last = tk == splits - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last CTA merges the splits: one column of 4 floats a thread at a
  // time, kMerge splits' (m, l, acc) loaded together (one L2 round trip
  // each batch) and merged online
  const float* accs = acc_part + (size_t)unit * splits * kLatHeads * DC;
  const float* mls = ml_part + (size_t)unit * splits * 2 * kLatHeads;
  for (int i = tid; i < kLatHeads * DC / 4; i += kLatThreads) {
    const int h = i * 4 / DC;
    float M = kNegInf, L = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += kMerge) {
      float mm[kMerge], ll[kMerge];
      float4 x[kMerge];
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        const int sp = s0 + j;
        if (sp < splits) {
          mm[j] = __ldcg(mls + sp * 2 * kLatHeads + h);
          ll[j] = __ldcg(mls + sp * 2 * kLatHeads + kLatHeads + h);
          x[j] = __ldcg(reinterpret_cast<const float4*>(accs + (size_t)sp * kLatHeads * DC) +
                        i);
        } else {
          mm[j] = kNegInf;
          ll[j] = 0.f;
          x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      float mb = M;
#pragma unroll
      for (int j = 0; j < kMerge; ++j) mb = fmaxf(mb, mm[j]);
      const float r = exp2f(M - mb);
      L *= r;
      a = make_float4(a.x * r, a.y * r, a.z * r, a.w * r);
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        const float w = exp2f(mm[j] - mb);
        L = fmaf(ll[j], w, L);
        a = make_float4(fmaf(x[j].x, w, a.x), fmaf(x[j].y, w, a.y), fmaf(x[j].z, w, a.z),
                        fmaf(x[j].w, w, a.w));
      }
      M = mb;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    TQ* o = out + ((size_t)b * H + h0) * DC + i * 4;
    store(o, a.x * inv);
    store(o + 1, a.y * inv);
    store(o + 2, a.z * inv);
    store(o + 3, a.w * inv);
  }
  if (tid == 0) tickets[unit] = 0;  // ready for the next call
}

template <typename TQ, typename TC, int DC, int DR>
cudaError_t latent_launch(const void* q_lat, const void* q_rope, const void* cc, const void* rc,
                          void* out, float* part, int* tickets, const int* valid_dev,
                          int valid_stride, int valid_host, int B, int S, int H, int splits,
                          float scale, cudaStream_t stream) {
  constexpr size_t smem = LatCfg<TC, DC, DR>::smem;
  static bool opted_in = false;  // the attribute is set once per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(latent_kernel<TQ, TC, DC, DR>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  latent_kernel<TQ, TC, DC, DR><<<dim3(splits, H / kLatHeads, B), kLatThreads, smem, stream>>>(
      static_cast<const TQ*>(q_lat), static_cast<const TQ*>(q_rope), static_cast<const TC*>(cc),
      static_cast<const TC*>(rc), static_cast<TQ*>(out), part, tickets, valid_dev, valid_stride,
      valid_host, S, H, scale * kLog2e);
  return cudaGetLastError();
}


// ---------------------------------------------- the tensor-core latent kernel
constexpr int kTcHeads = 64;     // query heads a CTA: one wgmma M tile (ops.LATENT_HEADS)
constexpr int kTcRows = 64;      // cache rows a tile (ops.LATENT_ROWS)
constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kTcDC = 512, kTcDR = 64, kTcDQ = kTcDC + kTcDR;
constexpr int kTcChunks = kTcDQ / 8;            // 16-byte chunks of a row: 72
constexpr int kTcBlock = 64 * 128;              // a 64-column block of 64 rows
constexpr int kTcTile = kTcDQ / 64 * kTcBlock;  // 9 blocks: 73,728 bytes
constexpr int kTcSmem = 3 * kTcTile + 1024;     // q, two tiles, 1 KB to align the swizzle
constexpr int kTcMergeThreads = kTcDC / 4;      // latent_merge: 4 columns a thread,
constexpr int kTcMergeGroups = 4;               // in up to 4 groups of the splits
static_assert(kTcSmem <= 232448, "a CTA's shared memory");

// rows [row0, row0 + 64) of a (rows, 576) bfloat16 operand whose columns
// [0, 512) are rows of `a` and [512, 576) rows of `b`, into the tile at
// shared address `dst`: nine 64-column blocks of 64 rows x 128 bytes, the
// 16-byte chunk j of row r at chunk j ^ (r % 8) of its block row (the
// 128-byte swizzle wgmma reads); rows at or past `end` zero-filled, not read
__device__ __forceinline__ void tc_load(uint32_t dst, const __nv_bfloat16* __restrict__ a,
                                        const __nv_bfloat16* __restrict__ b, int row0,
                                        int end) {
  for (int e = threadIdx.x; e < kTcRows * kTcChunks; e += kTcThreads) {
    const int r = e / kTcChunks, j = e % kTcChunks;
    const bool in = row0 + r < end;
    const size_t row = in ? row0 + r : 0;
    const __nv_bfloat16* src = j < kTcDC / 8 ? a + row * kTcDC + j * 8
                                             : b + row * kTcDR + (j - kTcDC / 8) * 8;
    const uint32_t d = dst + (j / 8) * kTcBlock + r * 128 + (((j % 8) ^ (r % 8)) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0));
  }
}

// a wgmma shared-memory matrix descriptor under the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t tc_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}
// K-major (scores, both operands): 8-row groups 1,024 bytes apart; a k-step
// of 16 columns is 32 bytes into the block's swizzled rows
__device__ __forceinline__ uint64_t tc_desc_k(uint32_t addr) { return tc_desc(addr, 16, 1024); }
// MN-major (values' B, the transpose bit): 64-column blocks kTcBlock bytes
// apart along N, 8-row groups 1,024 bytes apart along K
__device__ __forceinline__ uint64_t tc_desc_mn(uint32_t addr) {
  return tc_desc(addr, kTcBlock, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" :::
               "memory");
}
// keeps the compiler from moving a register's use across the wgmma wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S (64 x 64, float32) += A (64 x 16) . B (16 x 64), both bfloat16 in shared
// memory, K-major under the 128-byte swizzle
__device__ __forceinline__ void wgmma_s(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// O (64 x 256, float32) += P (64 x 16, bfloat16 in registers: each warp's
// 16 rows as the m16n8k16 A fragment) . B (16 x 256, bfloat16 in shared
// memory, MN-major under the 128-byte swizzle: the transpose bit)
__device__ __forceinline__ void wgmma_o(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// TMA: whole 64 x 64 boxes (128-byte rows, under the 128-byte swizzle, so
// a box lands as one block of the tile layout above), completing on an
// mbarrier that counts the bytes
struct LatMaps {  // q_lat (B*H, 512), q_rope (B*H, 64), c (B*S, 512), r (B*S, 64)
  CUtensorMap q, qr, c, r;
};
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n@!done bra LAB_WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int x, int y,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar) : "memory");
}
// rows [y, y + 64) of a pair of maps (64-column boxes of `a`, then one of
// `b`) into a tile at `dst`: 9 boxes, kTcTile bytes on `bar`
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* a, const CUtensorMap* b,
                                         int y, uint32_t bar) {
  mbar_expect(bar, kTcTile);
#pragma unroll
  for (int j = 0; j < kTcDC / 64; ++j) tma_box(dst + j * kTcBlock, a, 64 * j, y, bar);
  tma_box(dst + kTcDC / 64 * kTcBlock, b, 0, y, bar);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the live share [beg, end) of split `split` of `splits` over the live range
// [0, hi] of a row, in whole g-row granules (ops.py::decode_share); empty
// (beg == end) past it
__device__ __forceinline__ void latent_share(long long hi, int split, int splits, int g,
                                             int& beg, int& end) {
  beg = end = 0;
  if (hi < 0) return;
  const long long per = ((hi + 1 + g - 1) / g + splits - 1) / splits * g;
  const long long bb = split * per, ee = min(hi + 1, bb + per);
  if (ee > bb) {
    beg = (int)bb;
    end = (int)ee;
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
latent_tc_kernel(const __grid_constant__ LatMaps maps, const __nv_bfloat16* __restrict__ cc,
                 const __nv_bfloat16* __restrict__ rc, float* __restrict__ part,
                 const int* __restrict__ valid_dev, int valid_stride, int valid_host, int S,
                 int H, float scale_log2) {
  extern __shared__ unsigned char tc_smem[];
  __shared__ __align__(8) uint64_t bars[3];  // q's, and each tile buffer's
  const int split = blockIdx.x, splits = gridDim.x;
  const int hg = blockIdx.y, b = blockIdx.z;
  const int h0 = hg * kTcHeads;
  const long long valid =
      valid_dev ? (long long)valid_dev[(size_t)b * valid_stride] : (long long)valid_host;
  int beg, end;
  latent_share(min(valid, (long long)S - 1), split, splits, kTcRows, beg, end);
  if (end <= beg) return;  // an empty share: latent_merge reads no partial of it
  const int n_tiles = (end - beg + kTcRows - 1) / kTcRows;

  const uint32_t q_s = ((uint32_t)__cvta_generic_to_shared(tc_smem) + 1023) & ~1023u;
  const uint32_t tiles = q_s + kTcTile;  // tile t at tiles + (t & 1) * kTcTile
  const uint32_t bar_q = (uint32_t)__cvta_generic_to_shared(bars);  // buffer j's: + 8 (1 + j)
  const __nv_bfloat16* cb = cc + (size_t)b * S * kTcDC;
  const __nv_bfloat16* rb = rc + (size_t)b * S * kTcDR;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) mbar_init(bar_q + 8 * j);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // q by TMA (rows past H are other heads' or zeros: their scores and
  // outputs are never stored); a whole tile of the share by TMA from one
  // thread, the share's last rows (a part of a tile) by cp.async from all,
  // zero-filled past `end`, so that no row past valid_len is read
  auto issue = [&](int t) {
    const int row0 = beg + t * kTcRows;
    const uint32_t dst = tiles + (t & 1) * kTcTile;
    if (row0 + kTcRows <= end) {
      if (threadIdx.x == 0)
        tma_tile(dst, &maps.c, &maps.r, b * S + row0, bar_q + 8 * (1 + (t & 1)));
    } else {
      tc_load(dst, cb, rb, row0, end);
      lat_commit();
    }
  };
  if (threadIdx.x == 0) tma_tile(q_s, &maps.q, &maps.qr, b * H + h0, bar_q);
  issue(0);
  if (n_tiles > 1) issue(1);

  // thread (warpgroup wg, warp w of it, lane): heads r0 and r0 + 8 of the
  // group in every fragment; in each 8 columns of S (cache rows of the
  // tile) and of O (latent columns 256 wg ...) the two at q2 and q2 + 1
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) % 4 * 16 + lane / 4, q2 = lane % 4 * 2;
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  // heads r0 and r0 + 8: running max, and the sum over this thread's columns
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int row0 = beg + t * kTcRows;
    const uint32_t tile = tiles + (t & 1) * kTcTile;
    if (row0 + kTcRows <= end) {  // tile t has landed (buffer t & 1's use t / 2)
      mbar_wait(bar_q + 8 * (1 + (t & 1)), (t >> 1) & 1);
    } else {
      lat_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    }
    if (t == 0) mbar_wait(bar_q, 0);
    __syncthreads();

    // 1. S = Q . [c | r]^T over 36 k-steps of 16 columns
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTcDQ / 16; ++k) {
      const uint32_t off = k / 4 * kTcBlock + k % 4 * 32;
      wgmma_s(s, tc_desc_k(q_s + off), tc_desc_k(tile + off));
    }
    wgmma_commit_wait();
    reg_fence(s);

    // 2. the online softmax of heads r0 and r0 + 8 over the tile's rows:
    // s[4 i + 2 x + e] is head r0 + 8 x at row 8 i + q2 + e
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = row0 + 8 * i + q2 + e < end;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float& v = s[4 * i + 2 * x + e];
          v = live ? v * scale_log2 : kNegInf;
          mx[x] = fmaxf(mx[x], v);
        }
      }
    uint32_t p[16];  // P in bfloat16 pairs: p[2 i + x] = head r0 + 8 x, rows 8 i + q2, + 1
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      const float mn = fmaxf(m[x], mx[x]);  // a real score: every tile has a live row
      const float alpha = exp2f(m[x] - mn);
      m[x] = mn;
      float ls = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p0 = exp2f(s[4 * i + 2 * x] - mn), p1 = exp2f(s[4 * i + 2 * x + 1] - mn);
        ls += p0 + p1;
        p[2 * i + x] = pack_bf16(p0, p1);
      }
      l[x] = l[x] * alpha + ls;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o[4 * i + 2 * x] *= alpha;
        o[4 * i + 2 * x + 1] *= alpha;
      }
    }

    // 3. O += P . c: k-step kk takes the tile's rows 16 kk .. 16 kk + 15,
    // whose A fragment is p[4 kk .. 4 kk + 3]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk)
      wgmma_o(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
              tc_desc_mn(tile + wg * 4 * kTcBlock + kk * 16 * 128));
    wgmma_commit_wait();
    reg_fence(o);
    reg_fence(p);
    __syncthreads();  // both warpgroups are done with tile t's buffer
    if (t + 2 < n_tiles) issue(t + 2);
  }

  // this CTA's partial: acc (units, splits, kTcHeads, DC), then (m, l)
  // (units, splits, 2, kTcHeads); heads past H are not stored
  const int n_units = gridDim.z * gridDim.y;
  const size_t pidx = ((size_t)b * gridDim.y + hg) * splits + split;
  float* acc = part + pidx * kTcHeads * kTcDC;
  float* ml = part + (size_t)n_units * splits * kTcHeads * kTcDC + pidx * 2 * kTcHeads;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    const int r = r0 + 8 * x;
    if (h0 + r < H) {
      float* dst = acc + (size_t)r * kTcDC + wg * 256 + q2;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(o[4 * i + 2 * x],
                                                               o[4 * i + 2 * x + 1]);
      if (wg == 0 && lane % 4 == 0) {
        ml[r] = m[x];
        ml[kTcHeads + r] = l[x];
      }
    }
  }
}

// out for head h (blockIdx.x) of batch row b (blockIdx.y): the live splits'
// partials merged, 4 columns a thread; the block's groups of
// kTcMergeThreads threads (blockDim.x / kTcMergeThreads, at most
// kTcMergeGroups: one for each kMerge splits) each take every groups-th
// split, kMerge splits' loads in flight a thread, and group 0 merges the
// groups' (m, l, acc)
template <typename TQ>
__global__ void __launch_bounds__(kTcMergeThreads * kTcMergeGroups)
latent_merge(const float* __restrict__ part, TQ* __restrict__ out,
             const int* __restrict__ valid_dev, int valid_stride, int valid_host, int S, int H,
             int splits) {
  __shared__ float4 g_acc[kTcMergeGroups - 1][kTcMergeThreads];
  __shared__ float g_ml[kTcMergeGroups - 1][2];
  const int h = blockIdx.x, b = blockIdx.y;
  const int i = threadIdx.x % kTcMergeThreads, g = threadIdx.x / kTcMergeThreads;
  const int groups = blockDim.x / kTcMergeThreads;
  const int n_hg = (H + kTcHeads - 1) / kTcHeads;
  const long long valid =
      valid_dev ? (long long)valid_dev[(size_t)b * valid_stride] : (long long)valid_host;
  const long long hi = min(valid, (long long)S - 1);
  int live = 0;  // the splits whose share is not empty (latent_share)
  if (hi >= 0) {
    const long long tiles = (hi + kTcRows) / kTcRows;
    const long long per = (tiles + splits - 1) / splits;
    live = (int)((tiles + per - 1) / per);
  }
  const size_t unit = (size_t)b * n_hg + h / kTcHeads;
  const int row = h % kTcHeads;
  const float* accs = part + unit * splits * kTcHeads * kTcDC + (size_t)row * kTcDC;
  const float* mls = part + (size_t)gridDim.y * n_hg * splits * kTcHeads * kTcDC +
                     unit * splits * 2 * kTcHeads + row;
  float M = kNegInf, L = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = g; s0 < live; s0 += groups * kMerge) {
    float mm[kMerge], ll[kMerge];
    float4 x[kMerge];
#pragma unroll
    for (int j = 0; j < kMerge; ++j) {
      const int sp = s0 + j * groups;
      if (sp < live) {
        mm[j] = mls[sp * 2 * kTcHeads];
        ll[j] = mls[sp * 2 * kTcHeads + kTcHeads];
        x[j] = reinterpret_cast<const float4*>(accs + (size_t)sp * kTcHeads * kTcDC)[i];
      } else {
        mm[j] = kNegInf;
        ll[j] = 0.f;
        x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float mb = M;
#pragma unroll
    for (int j = 0; j < kMerge; ++j) mb = fmaxf(mb, mm[j]);
    const float r = exp2f(M - mb);
    L *= r;
    a = make_float4(a.x * r, a.y * r, a.z * r, a.w * r);
#pragma unroll
    for (int j = 0; j < kMerge; ++j) {
      const float w = exp2f(mm[j] - mb);
      L = fmaf(ll[j], w, L);
      a = make_float4(fmaf(x[j].x, w, a.x), fmaf(x[j].y, w, a.y), fmaf(x[j].z, w, a.z),
                      fmaf(x[j].w, w, a.w));
    }
    M = mb;
  }
  if (g > 0) {
    g_acc[g - 1][i] = a;
    if (i == 0) {
      g_ml[g - 1][0] = M;
      g_ml[g - 1][1] = L;
    }
  }
  __syncthreads();
  if (g > 0) return;
  float mb = M;
  for (int k = 0; k < groups - 1; ++k) mb = fmaxf(mb, g_ml[k][0]);
  const float r = exp2f(M - mb);
  L *= r;
  a = make_float4(a.x * r, a.y * r, a.z * r, a.w * r);
  for (int k = 0; k < groups - 1; ++k) {
    const float w = exp2f(g_ml[k][0] - mb);
    const float4 x = g_acc[k][i];
    L = fmaf(g_ml[k][1], w, L);
    a = make_float4(fmaf(x.x, w, a.x), fmaf(x.y, w, a.y), fmaf(x.z, w, a.z),
                    fmaf(x.w, w, a.w));
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  TQ* o = out + ((size_t)b * H + h) * kTcDC + i * 4;
  store(o, a.x * inv);
  store(o + 1, a.y * inv);
  store(o + 2, a.z * inv);
  store(o + 3, a.w * inv);
}

// cuTensorMapEncodeTiled, looked up through the runtime (no libcuda link)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) row-major bfloat16 matrix in 64 x 64 boxes under the
// 128-byte swizzle; rows past the end read as zeros
bool box_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, 64}, step[2] = {1, 1};
  return encode && encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                          dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t latent_tc_launch(const void* q_lat, const void* q_rope, const void* cc,
                             const void* rc, void* out, float* part, const int* valid_dev,
                             int valid_stride, int valid_host, int B, int S, int H, int splits,
                             float scale, cudaStream_t stream) {
  if (((uintptr_t)q_lat | (uintptr_t)q_rope) % 16 != 0) return cudaErrorMisalignedAddress;
  LatMaps maps;  // by value in the launch: a captured graph keeps them
  if (!box_map(&maps.q, q_lat, (uint64_t)B * H, kTcDC) ||
      !box_map(&maps.qr, q_rope, (uint64_t)B * H, kTcDR) ||
      !box_map(&maps.c, cc, (uint64_t)B * S, kTcDC) ||
      !box_map(&maps.r, rc, (uint64_t)B * S, kTcDR))
    return cudaErrorInvalidValue;
  static bool opted_in = false;  // the attribute is set once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        latent_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  using bf16 = __nv_bfloat16;
  latent_tc_kernel<<<dim3(splits, (H + kTcHeads - 1) / kTcHeads, B), kTcThreads, kTcSmem,
                     stream>>>(maps, static_cast<const bf16*>(cc), static_cast<const bf16*>(rc),
                               part, valid_dev, valid_stride, valid_host, S, H, scale * kLog2e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int groups = min(kTcMergeGroups, (splits + kMerge - 1) / kMerge);
  latent_merge<bf16><<<dim3(H, B), kTcMergeThreads * groups, 0, stream>>>(
      part, static_cast<bf16*>(out), valid_dev, valid_stride, valid_host, S, H, splits);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t latent_dispatch(int dc, int dr, const void* q_lat, const void* q_rope,
                            const void* cc, const void* rc, void* out, float* part, int* tickets,
                            const int* valid_dev, int valid_stride, int valid_host, int B, int S,
                            int H, int splits, float scale, cudaStream_t s) {
  if (dc == 512 && dr == 64)  // deepseek-v3: kv_lora 512, qk_rope 64
    return latent_launch<TQ, TC, 512, 64>(q_lat, q_rope, cc, rc, out, part, tickets, valid_dev,
                                          valid_stride, valid_host, B, S, H, splits, scale, s);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t latent_dispatch_cache(int cache_code, int dc, int dr, const void* q_lat,
                                  const void* q_rope, const void* cc, const void* rc, void* out,
                                  float* part, int* tickets, const int* valid_dev,
                                  int valid_stride, int valid_host, int B, int S, int H,
                                  int splits, float scale, cudaStream_t s) {
  switch (cache_code) {
    case 0: return latent_dispatch<TQ, float>(dc, dr, q_lat, q_rope, cc, rc, out, part, tickets,
                                              valid_dev, valid_stride, valid_host, B, S, H,
                                              splits, scale, s);
    case 1:
      // bfloat16 q and cache: the tensor-core kernel (no tickets)
      if (std::is_same<TQ, __nv_bfloat16>::value)
        return dc == kTcDC && dr == kTcDR
                   ? latent_tc_launch(q_lat, q_rope, cc, rc, out, part, valid_dev, valid_stride,
                                      valid_host, B, S, H, splits, scale, s)
                   : cudaErrorInvalidValue;
      return latent_dispatch<TQ, __nv_bfloat16>(dc, dr, q_lat, q_rope, cc, rc, out, part,
                                                tickets, valid_dev, valid_stride, valid_host, B,
                                                S, H, splits, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_max_group() { return kMaxG; }

// q, out: (B, H, hd), float32 (q_code 0) or bfloat16 (1); k_cache, v_cache:
// (B, S, KH, hd), float32 (cache_code 0), bfloat16 (1) or float8_e4m3fn (2);
// all contiguous, the caches 16-byte aligned.  valid_len is read from
// valid_dev (int32 in device memory; row b reads valid_dev[b * valid_stride],
// so stride 0 gives one length for the batch and stride 1 one a row) when
// that is not null, else valid_host; window 0 means none.  gb heads per pass
// (must equal the kernel's, ops.py::decode_heads_per_pass at the cache's
// element size) and splits <= 1024 CTAs a (batch, kv head, head group) unit,
// from ops.py::decode_geometry.  Scratch: part, float32, units * splits * gb
// * (hd + 2); tickets, int32, one per unit (units = B * KH * ceil(G / gb)),
// zero before the first call and left zero by every call.  Calls that share
// tickets must not overlap in time.  G = H / KH at most
// decode_attention_max_group(); hd one of 16, 32, 64, 80, 128, 256.  softcap
// > 0 caps each scaled logit u to softcap * tanh(u / softcap) before the mask;
// 0 means none.
extern "C" int decode_attention_launch(const void* q, const void* kc, const void* vc, void* out,
                                       float* part, int* tickets, const int* valid_dev,
                                       int valid_stride, int valid_host, int B, int S, int H,
                                       int KH, int hd, int window, int gb, int splits,
                                       int q_code, int cache_code, float softcap, void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0 || H / KH > kMaxG || window < 0 || gb < 1 ||
      splits < 1 || splits > kMaxSplits || valid_stride < 0 || valid_stride > 1 ||
      !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_code) {
    case 0: return (int)dispatch_cache<float>(cache_code, q, kc, vc, out, part, tickets,
                                              valid_dev, valid_stride, valid_host, B, S, H, KH,
                                              hd, window, softcap, gb, splits, s);
    case 1: return (int)dispatch_cache<__nv_bfloat16>(cache_code, q, kc, vc, out, part, tickets,
                                                      valid_dev, valid_stride, valid_host, B, S,
                                                      H, KH, hd, window, softcap, gb, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q_lat, out: (B, H, dc) and q_rope: (B, H, dr), float32 (q_code 0) or
// bfloat16 (1); c_cache: (B, S, dc) and r_cache: (B, S, dr), float32
// (cache_code 0) or bfloat16 (1), 16-byte aligned; all contiguous.  (dc, dr)
// = (512, 64); H a multiple of 16.  valid_len as for decode_attention_launch
// (no window).  splits <= 1024 CTAs a (batch, head group) unit, from
// ops.py::latent_geometry.  bfloat16 q and cache run the tensor-core kernel
// and latent_merge, two launches: head groups of 64 (units = B * ceil(H /
// 64)), scratch part float32, units * splits * 64 * (dc + 2), q 16-byte
// aligned too; tickets not read (may be null).  Other types run the
// CUDA-core kernel, one launch: head groups of 16 (units = B * H / 16), part
// units * splits * 16 * (dc + 2), tickets as for decode_attention_launch,
// one per unit.  scale multiplies the scores (MLA: 1/sqrt(qk_nope +
// qk_rope)).
extern "C" int decode_attention_latent_launch(const void* q_lat, const void* q_rope,
                                              const void* cc, const void* rc, void* out,
                                              float* part, int* tickets, const int* valid_dev,
                                              int valid_stride, int valid_host, int B, int S,
                                              int H, int dc, int dr, int splits, float scale,
                                              int q_code, int cache_code, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < kLatHeads || H % kLatHeads != 0 || splits < 1 ||
      splits > kMaxSplits || valid_stride < 0 || valid_stride > 1 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)cc | (uintptr_t)rc) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_code) {
    case 0: return (int)latent_dispatch_cache<float>(cache_code, dc, dr, q_lat, q_rope, cc, rc,
                                                     out, part, tickets, valid_dev,
                                                     valid_stride, valid_host, B, S, H, splits,
                                                     scale, s);
    case 1: return (int)latent_dispatch_cache<__nv_bfloat16>(cache_code, dc, dr, q_lat, q_rope,
                                                             cc, rc, out, part, tickets,
                                                             valid_dev, valid_stride, valid_host,
                                                             B, S, H, splits, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
