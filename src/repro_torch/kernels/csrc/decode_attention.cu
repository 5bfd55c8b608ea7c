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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// a row of 576 values (1.1 KB in bfloat16) feeds 128 x 2 x (576 + 512)
// operations, ~240 a byte: bound by the bf16 tensor-core rate at best, and
// far from the memory rate.  These products run on CUDA cores in float32
// (ROADMAP Queue 2: wgmma for the 128-head score and value products).
//
// Design (a simple one): the grid is (splits, head groups of kLatHeads, B),
// from ops.py::latent_geometry (shapes and SM count only, so a captured call
// replays with new valid_len).  Each CTA takes its share of its row's live
// range in whole kLatRows-row tiles (ops.py::decode_share with that
// granule), copies the tiles' c and r rows into shared memory with cp.async
// (double-buffered, rows outside the share zero-filled, so no dead row is
// ever read from the cache), and on each tile
//   1. scores: the 16 lanes of a half-warp share a head; lane k holds the
//      head's query chunks k, k + 16, ... (36 of its 576 values, float32 in
//      registers for the whole call) and forms its partial dot with each of
//      the tile's 16 rows, reading only the rows from shared memory; a
//      transposing butterfly (15 shuffles) leaves lane j the score of row
//      j; then the head's online softmax over the tile with 16-lane
//      shuffles;
//   2. values: each thread owns 4 heads x 8 latent columns of acc in
//      registers (16 x 512 float32 over 256 threads) and adds p * c_p for
//      the tile's rows.
// The 16 heads of a CTA keep 16 x 512 float32 accumulators: the whole 128
// would take 256 KB, beyond a CTA's registers and shared memory, so the 8
// head groups each read the rows (the later ones mostly from L2).  The
// splits merge in the same launch through the tickets, as above; the last
// CTA reads splits x 32 KB a head group, so ops.py caps the splits at 16.
constexpr int kLatHeads = 16;    // query heads a CTA (ops.LATENT_HEADS)
constexpr int kLatRows = 16;     // cache rows a tile (ops.LATENT_ROWS)
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
    case 1: return latent_dispatch<TQ, __nv_bfloat16>(dc, dr, q_lat, q_rope, cc, rc, out, part,
                                                      tickets, valid_dev, valid_stride,
                                                      valid_host, B, S, H, splits, scale, s);
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
// ops.py::latent_geometry.  Scratch: part, float32, units * splits * 16 *
// (dc + 2); tickets as for decode_attention_launch, one per unit (units = B
// * H / 16).  scale multiplies the scores (MLA: 1/sqrt(qk_nope + qk_rope)).
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
