// Forward flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's
// kernels/flash_attention.py (flash_attention, body _fa_kernel).  For query
// q_i of head h and the keys k_j, values v_j of kv head h / (H / KH):
//   out_i = sum_j softmax_j(q_i . k_j / sqrt(hd)) v_j   over the live j,
// where j is live when j <= i (causal) and i - j < window (window set).  Same
// function as kernels/ref.py::flash_attention_ref: masked logits never count,
// the running (m, l, acc) are float32, out = acc / max(l, 1e-30) in q's type.
//
// What bounds it on this card: operations.  At minicpm-2b prefill (B=1,
// S=1024, H=36, hd=64, causal) it does ~4.8 GFLOP against ~38 MB of q, k, v
// and out, far above the float32 ridge.  Tensor cores are not used: TF32 or
// bf16 products would miss the float32 tolerance (2e-5) this kernel is held to.
// Design: the TPU kernel walked the kv blocks as the sequential last grid axis
// with (m, l, acc) in VMEM scratch.  Here one CTA takes one (batch, head,
// 64-row q tile) and loops over the kv tiles itself, visiting only the tiles
// the causal mask and the window leave live (the counterpart of the TPU
// kernel's pl.when(jnp.any(ok)) skip): the loop bounds come from the q tile's
// row range.  Q and each K/V tile are staged in shared memory as float32;
// 256 threads form a 16 x 16 grid, each owning a 4-row register tile of the
// scores and of acc, so the row statistics reduce over 16 lanes of one warp
// with shuffles.  Masks are computed per element, so any S works (the TPU
// kernel asserted S % block == 0).  At 1,024 tokens, 64-row q tiles give
// 576 CTAs for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per CTA
constexpr int kRM = kBQ / 16;  // rows per thread
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// kv rows per tile: smaller for the wide heads so that Q, K, V and P fit
template <int HD> __host__ __device__ constexpr int kv_tile() { return HD >= 128 ? 32 : 64; }

template <int HD>
constexpr size_t smem_bytes() {
  constexpr int BK = kv_tile<HD>();
  return sizeof(float) * ((size_t)(kBQ + BK) * (HD + 1) + (size_t)BK * HD + (size_t)kBQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int S, int H, int KH, float scale, int causal,
                       int window) {
  constexpr int BK = kv_tile<HD>();
  constexpr int LDQ = HD + 1;  // padded: the 16 key rows a half-warp reads sit in distinct banks
  constexpr int LDP = BK + 1;
  constexpr int CM = BK / 16;  // score columns per thread
  constexpr int DM = HD / 16;  // acc columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // (kBQ, LDQ)
  float* Ks = Qs + kBQ * LDQ;    // (BK, LDQ)
  float* Vs = Ks + BK * LDQ;     // (BK, HD)
  float* Ps = Vs + BK * HD;      // (kBQ, LDP) probabilities of the tile

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q_end = min(q0 + kBQ, S);

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    Qs[i * LDQ + d] = q0 + i < S ? to_f(q[(((size_t)b * S + q0 + i) * H + h) * HD + d]) : 0.f;
  }

  float m[kRM], l[kRM], acc[kRM][DM];
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DM; ++j) acc[r][j] = 0.f;
  }

  // live keys of this q tile: [k_lo, k_hi)
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_end : S;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and Q is visible)
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const bool in = k0 + j < S;
      const size_t at = (((size_t)b * S + k0 + j) * KH + kh) * HD + d;
      Ks[j * LDQ + d] = in ? to_f(k[at]) : 0.f;
      Vs[j * HD + d] = in ? to_f(v[at]) : 0.f;
    }
    __syncthreads();

    float s[kRM][CM];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int c = 0; c < CM; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qr[kRM], kc[CM];
#pragma unroll
      for (int r = 0; r < kRM; ++r) qr[r] = Qs[(ty * kRM + r) * LDQ + d];
#pragma unroll
      for (int c = 0; c < CM; ++c) kc[c] = Ks[(tx + 16 * c) * LDQ + d];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < CM; ++c) s[r][c] += qr[r] * kc[c];
    }

#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      const int qi = q0 + ty * kRM + r;
      bool ok[CM];
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        const int kj = k0 + tx + 16 * c;
        ok[c] = kj < S && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
        s[r][c] *= scale;
        if (ok[c]) mt = fmaxf(mt, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        Ps[(ty * kRM + r) * LDP + tx + 16 * c] = p;
        ls += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
      l[r] = l[r] * alpha + ls;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DM; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vr[DM];
#pragma unroll
      for (int j = 0; j < DM; ++j) vr[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const float p = Ps[(ty * kRM + r) * LDP + c];
#pragma unroll
        for (int j = 0; j < DM; ++j) acc[r][j] += p * vr[j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int qi = q0 + ty * kRM + r;
    if (qi < S) {
      const float denom = fmaxf(l[r], 1e-30f);
      T* out = o + (((size_t)b * S + qi) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < DM; ++j) store(&out[tx + 16 * j], acc[r][j] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int KH, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool opted_in = false;  // the attribute is set once per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KH, 1.0f / sqrtf((float)HD), causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                     int KH, int hd, int causal, int window, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KH, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KH, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KH, causal, window, s);
    case 80: return launch<T, 80>(q, k, v, o, B, S, H, KH, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KH, causal, window, s);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KH, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, KH, hd), all contiguous, float32 or (when
// is_bf16) bfloat16.  H % KH == 0; hd one of 16, 32, 64, 80, 128, 256;
// window <= 0 means no window.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int S, int H, int KH, int hd, int causal, int window,
                                      int is_bf16, void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KH, hd, causal, window, s)
                       : dispatch<float>(q, k, v, o, B, S, H, KH, hd, causal, window, s));
}
