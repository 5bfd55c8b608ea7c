// One-token decode attention (flash-decoding) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's
// kernels/decode_attention.py (decode_attention, body _dec_kernel).  For the
// new token's query q_h of head h, against the cache rows of kv head
// h / (H / KH):
//   out_h = sum_p softmax_p(q_h . k_p / sqrt(hd)) v_p   over the live p,
// where p is live when p <= valid_len and, with a window, valid_len - p <
// window.  Same function as kernels/ref.py::decode_attention_ref, with the
// running (m, l, acc) in float32 and out = acc / max(l, 1e-30) in q's type.
//
// What bounds it on this card: bytes.  Each live K/V row is read once and
// used for a handful of operations (2 x G x hd per row for G query heads),
// so at minicpm-2b width (KH=36, hd=64, ~1,031 live rows) the ~19 MB of live
// cache take ~6 us at 3.35 TB/s and the arithmetic is negligible.
// Design: the TPU kernel ran one program per (batch, kv head) and walked the
// cache blocks in order; at batch 1 that is 36 CTAs at minicpm-2b and 4 at
// gemma3-4b, too few for 132 SMs to pull the cache at full rate.  Here the
// live range [lo, hi] is split into n_splits chunks (the wrapper picks them
// from valid_len), and one CTA per (chunk, kv head, batch) streams its rows
// through shared memory once for all G query heads of its kv head (the TPU
// kernel packed G as the matmul's M dimension), keeping partial (m, l, acc)
// for each head.  A second small kernel merges the partials.  Positions
// outside [lo, hi] are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 32;  // query heads per kv head
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// four consecutive elements in one load: 16 bytes of float, 8 of bfloat16
struct Four {
  float v[4];
};
__device__ __forceinline__ Four load4(const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  return {{x.x, x.y, x.z, x.w}};
}
__device__ __forceinline__ Four load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  return {{a.x, a.y, b.x, b.y}};
}

template <int HD> __host__ __device__ constexpr int kv_tile() { return HD >= 256 ? 32 : 64; }

template <int HD>
size_t smem_bytes(int G) {
  constexpr int BK = kv_tile<HD>();
  return sizeof(float) *
         ((size_t)BK * (HD + 1) + (size_t)BK * HD + 2 * (size_t)G * HD + (size_t)G * BK + 3 * G);
}

// Partial attention of one chunk of positions for the G heads of one kv head.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      float* __restrict__ acc_part, int S, int KH, int G, int lo, int hi,
                      int chunk, float scale) {
  constexpr int BK = kv_tile<HD>();
  constexpr int LDK = HD + 1;  // padded: thread j reads row j, rows in distinct banks
  constexpr int NV = BK * HD / 4;                      // 4-element loads per tile and tensor
  constexpr int PER = (NV + kThreads - 1) / kThreads;  // ... per thread, all in flight at once
  extern __shared__ float smem[];
  float* Ks = smem;           // (BK, LDK)
  float* Vs = Ks + BK * LDK;  // (BK, HD)
  float* Qs = Vs + BK * HD;   // (G, HD)
  float* As = Qs + G * HD;    // (G, HD) running acc
  float* Ss = As + G * HD;    // (G, BK) scores, then probabilities
  float* Ms = Ss + G * BK;    // (G) running max
  float* Ls = Ms + G;         // (G) running sum
  float* Al = Ls + G;         // (G) rescale of this tile

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int H = KH * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < G * HD; e += kThreads) {
    Qs[e] = to_f(q[((size_t)b * H + kh * G) * HD + e]);
    As[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }

  const int p_begin = lo + split * chunk;
  const int p_end = min(hi + 1, p_begin + chunk);
  for (int p0 = p_begin; p0 < p_end; p0 += BK) {
    const int n = min(BK, p_end - p0);
    __syncthreads();  // the previous tile's readers are done (and Q is visible)
    Four kr[PER], vr[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) {  // issue every load of the tile before storing any
      const int e = tid + r * kThreads, j = e / (HD / 4), d = (e % (HD / 4)) * 4;
      if (e < NV && j < n) {
        const size_t at = (((size_t)b * S + p0 + j) * KH + kh) * HD + d;
        kr[r] = load4(kc + at);
        vr[r] = load4(vc + at);
      } else {
        kr[r] = vr[r] = Four{{0.f, 0.f, 0.f, 0.f}};
      }
    }
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int e = tid + r * kThreads, j = e / (HD / 4), d = (e % (HD / 4)) * 4;
      if (e < NV) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Ks[j * LDK + d + i] = kr[r].v[i];
          Vs[j * HD + d + i] = vr[r].v[i];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < G * BK; e += kThreads) {
      const int g = e / BK, j = e % BK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s += Qs[g * HD + d] * Ks[j * LDK + d];
      Ss[e] = s * scale;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // one warp per head: the tile's stats
      float mt = kNegInf;
      for (int j = lane; j < n; j += 32) mt = fmaxf(mt, Ss[g * BK + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mt);
      float ls = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = j < n ? expf(Ss[g * BK + j] - m_new) : 0.f;
        Ss[g * BK + j] = p;
        ls += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ls[g] = Ls[g] * alpha + ls;
        Ms[g] = m_new;
        Al[g] = alpha;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * HD; e += kThreads) {
      const int g = e / HD, d = e % HD;
      float a = As[e] * Al[g];
      for (int j = 0; j < n; ++j) a += Ss[g * BK + j] * Vs[j * HD + d];
      As[e] = a;
    }
  }
  __syncthreads();
  const size_t base = ((size_t)b * KH + kh) * n_splits + split;  // (b, kh, split) row of G heads
  for (int e = tid; e < G * HD; e += kThreads) acc_part[base * G * HD + e] = As[e];
  for (int g = tid; g < G; g += kThreads) {
    m_part[base * G + g] = Ms[g];
    l_part[base * G + g] = Ls[g];
  }
}

// Merge the n_splits partials of each (batch, head): one CTA per 32 output
// columns of a head, its warps taking the splits in turn, so that each thread
// has several independent loads in flight.
constexpr int kCombineWarps = 8;
constexpr int kMaxSplits = 4096;

template <typename T>
__global__ void __launch_bounds__(32 * kCombineWarps)
decode_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                      const float* __restrict__ acc_part, T* __restrict__ out, int KH, int G,
                      int hd, int n_splits) {
  extern __shared__ float sm[];
  float* ws = sm;                // (n_splits) partial maxima, then weights exp(m_i - M)
  float* ls = ws + n_splits;     // (n_splits) partial sums
  float* part = ls + n_splits;   // (kCombineWarps, 32) partial outputs
  const int col_blocks = (hd + 31) / 32;
  const int h = blockIdx.x / col_blocks, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d = (blockIdx.x % col_blocks) * 32 + lane;
  const int kh = h / G, g = h % G;
  const size_t base = ((size_t)b * KH + kh) * n_splits;
  for (int i = tid; i < n_splits; i += blockDim.x) {
    ws[i] = m_part[(base + i) * G + g];
    ls[i] = l_part[(base + i) * G + g];
  }
  __syncthreads();
  float M = kNegInf;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, ws[i]);
  __syncthreads();  // every thread has M before the weights overwrite the maxima
  for (int i = tid; i < n_splits; i += blockDim.x) ws[i] = expf(ws[i] - M);
  __syncthreads();
  float a = 0.f;
  if (d < hd) {
#pragma unroll 4
    for (int i = warp; i < n_splits; i += kCombineWarps)
      a += acc_part[((base + i) * G + g) * hd + d] * ws[i];
  }
  part[warp * 32 + lane] = a;
  __syncthreads();
  if (warp == 0 && d < hd) {
    float L = 0.f, s = 0.f;
    for (int i = 0; i < n_splits; ++i) L += ls[i] * ws[i];
    for (int w = 0; w < kCombineWarps; ++w) s += part[w * 32 + lane];
    store(&out[((size_t)b * KH * G + h) * hd + d], s / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* out, float* m_part,
                   float* l_part, float* acc_part, int B, int S, int H, int KH, int lo, int hi,
                   int chunk, int n_splits, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = smem_bytes<HD>(G);
  static size_t opted_in = 48 * 1024;  // the largest size set so far for this instantiation
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  decode_partial_kernel<T, HD><<<dim3(n_splits, KH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), m_part,
      l_part, acc_part, S, KH, G, lo, hi, chunk, 1.0f / sqrtf((float)HD));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t combine_smem = sizeof(float) * (2 * (size_t)n_splits + 32 * kCombineWarps);
  decode_combine_kernel<T><<<dim3(H * ((HD + 31) / 32), B), 32 * kCombineWarps, combine_smem,
                             stream>>>(m_part, l_part, acc_part, static_cast<T*>(out), KH, G,
                                       HD, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kc, const void* vc, void* out, float* m_part,
                     float* l_part, float* acc_part, int B, int S, int H, int KH, int hd, int lo,
                     int hi, int chunk, int n_splits, cudaStream_t s) {
#define REPRO_DECODE_CASE(D) \
  case D: return launch<T, D>(q, kc, vc, out, m_part, l_part, acc_part, B, S, H, KH, lo, hi, chunk, n_splits, s)
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

}  // namespace

extern "C" int decode_attention_max_group() { return kMaxG; }

// q, out: (B, H, hd); k_cache, v_cache: (B, S, KH, hd), all contiguous, float32
// or (when is_bf16) bfloat16; the caches aligned to 4 elements.  Live positions [lo, hi], 0 <= lo <= hi < S,
// cut into n_splits <= 4096 chunks of `chunk` rows (n_splits * chunk >= hi - lo + 1).
// Scratch, float32: m_part and l_part (B, KH, n_splits, G), acc_part
// (B, KH, n_splits, G, hd).  G = H / KH at most decode_attention_max_group();
// hd one of 16, 32, 64, 80, 128, 256.
extern "C" int decode_attention_launch(const void* q, const void* kc, const void* vc, void* out,
                                       float* m_part, float* l_part, float* acc_part, int B,
                                       int S, int H, int KH, int hd, int lo, int hi, int chunk,
                                       int n_splits, int is_bf16, void* stream) {
  if (B < 1 || KH < 1 || H % KH != 0 || H / KH > kMaxG || lo < 0 || hi < lo || hi >= S ||
      chunk < 1 || n_splits < 1 || n_splits > kMaxSplits ||
      (long long)n_splits * chunk < hi - lo + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(q, kc, vc, out, m_part, l_part, acc_part, B, S,
                                                 H, KH, hd, lo, hi, chunk, n_splits, s)
                       : dispatch<float>(q, kc, vc, out, m_part, l_part, acc_part, B, S, H, KH,
                                         hd, lo, hi, chunk, n_splits, s));
}
