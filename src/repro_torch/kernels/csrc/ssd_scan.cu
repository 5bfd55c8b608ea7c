// Mamba2 SSD chunked scan (ngroups = 1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's kernels/ssd_scan.py
// (ssd_scan, body _ssd_kernel).  For each chunk of Q positions, with
// cs = cumsum(dt * A) over the chunk and h the (P, N) state entering it:
//   y[q]  = sum_{k <= q} (C_q . B_k) exp(cs_q - cs_k) dt_k x_k   (quadratic term)
//         + exp(cs_q) C_q . h                                    (carried term)
//   h'    = exp(cs_last) h + sum_k exp(cs_last - cs_k) dt_k B_k (x) x_k
// The state is zero (or init_state) at chunk 0.  Same function as
// kernels/ref.py::ssd_scan_ref, in float32 throughout; x, B, C and y may be
// float32 or bfloat16, dt, A and the state are float32.
//
// What bounds it on this card: operations.  At mamba2-130m width (H=24, P=64,
// N=128, Q=256) one layer call at B=1, S=1024 moves ~14.5 MB but does ~1.2
// GFLOP counted once (more as computed here, see below), so it sits above the
// float32 ridge of CUDA cores; tensor cores are not used because TF32 would
// break the 1e-4 / 1e-3 tolerance this kernel is held to.
// Design: the TPU kernel held the (Q, Q, heads) decay matrix whole in VMEM
// (2 MB at Q=256 and 8 heads), which no SM holds.  Here one CTA takes one
// (batch, head, slice of kPT columns of P) and loops over the chunks in
// order, keeping its (kPT, N) state slice and the chunk's cumsum in shared
// memory.  The quadratic term runs in kTQ-row tiles against kTK-key tiles of
// B and x up to the diagonal, with the causal mask and the exp(cs_q - cs_k)
// decay applied on the fly; then the carried term; then the state update.
// Splitting P over CTAs gives B*H*P/kPT CTAs (96 at B=1) instead of B*H (24)
// so more of the 132 SMs work, at the price of recomputing C . B^T per slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 32;  // query rows per tile
constexpr int kTK = 32;  // key rows per tile
constexpr int kPT = 16;  // columns of P per CTA
constexpr int kMaxN = 256;
constexpr int kAcc = (kTQ * kPT + kThreads - 1) / kThreads;
constexpr int kSt = (kPT * kMaxN + kThreads - 1) / kThreads;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ init_state, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * kPT;
  const int tid = threadIdx.x;
  const int ld = N + 1;  // padded row stride of the N-wide tiles (no bank conflicts)
  float* cs = smem;                 // (Q) cumsum of dt*A over the chunk
  float* dtv = cs + Q;              // (Q) dt over the chunk
  float* hs = dtv + Q;              // (kPT, ld) state slice
  float* Cs = hs + kPT * ld;        // (kTQ, ld)
  float* Bs = Cs + kTQ * ld;        // (kTK, ld)
  float* Xs = Bs + kTK * ld;        // (kTK, kPT)
  float* Ss = Xs + kTK * kPT;       // (kTQ, kTK) masked, decayed scores
  float* wk = Ss + kTQ * kTK;       // (kTK) exp(cs_last - cs_k) * dt_k
  const float a = A[h];
  const size_t head_state = ((size_t)b * H + h) * P;

  for (int e = tid; e < kPT * N; e += kThreads) {
    const int p = e / N, n = e % N;
    hs[p * ld + n] = (init_state != nullptr && p0 + p < P)
                         ? init_state[(head_state + p0 + p) * N + n] : 0.f;
  }

  const int nc = S / Q;
  for (int c = 0; c < nc; ++c) {
    const size_t t0 = (size_t)b * S + (size_t)c * Q;  // first row of the chunk
    for (int q = tid; q < Q; q += kThreads) dtv[q] = dt[(t0 + q) * H + h];
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum of dt*A by one warp
      const int per = (Q + 31) / 32;
      const int lo = tid * per, hi = min(Q, lo + per);
      float run = 0.f;
      for (int q = lo; q < hi; ++q) {
        run += dtv[q] * a;
        cs[q] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
      for (int q = lo; q < hi; ++q) cs[q] += excl;
    }
    __syncthreads();

    // ---- output rows, one kTQ tile at a time
    for (int q0 = 0; q0 < Q; q0 += kTQ) {
      for (int e = tid; e < kTQ * N; e += kThreads) {
        const int i = e / N, n = e % N;
        Cs[i * ld + n] = q0 + i < Q ? to_f(Cm[(t0 + q0 + i) * N + n]) : 0.f;
      }
      __syncthreads();
      float acc[kAcc];
#pragma unroll
      for (int r = 0; r < kAcc; ++r) {  // carried term from the entering state
        const int o = tid + r * kThreads;
        const int i = o / kPT, p = o % kPT;
        float s = 0.f;
        if (o < kTQ * kPT && q0 + i < Q) {
          for (int n = 0; n < N; ++n) s += Cs[i * ld + n] * hs[p * ld + n];
          s *= expf(cs[q0 + i]);
        }
        acc[r] = s;
      }
      const int kend = min(q0 + kTQ, Q);
      for (int k0 = 0; k0 < kend; k0 += kTK) {
        for (int e = tid; e < kTK * N; e += kThreads) {
          const int j = e / N, n = e % N;
          Bs[j * ld + n] = k0 + j < Q ? to_f(Bm[(t0 + k0 + j) * N + n]) : 0.f;
        }
        for (int e = tid; e < kTK * kPT; e += kThreads) {
          const int j = e / kPT, p = e % kPT;
          Xs[e] = (k0 + j < Q && p0 + p < P) ? to_f(x[((t0 + k0 + j) * H + h) * P + p0 + p]) : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < kTQ * kTK; e += kThreads) {
          const int i = e / kTK, j = e % kTK;
          const int q = q0 + i, k = k0 + j;
          float v = 0.f;
          if (k <= q && q < Q) {
            for (int n = 0; n < N; ++n) v += Cs[i * ld + n] * Bs[j * ld + n];
            v *= expf(cs[q] - cs[k]) * dtv[k];
          }
          Ss[e] = v;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kAcc; ++r) {
          const int o = tid + r * kThreads;
          if (o < kTQ * kPT) {
            const int i = o / kPT, p = o % kPT;
            float s = 0.f;
            for (int j = 0; j < kTK; ++j) s += Ss[i * kTK + j] * Xs[j * kPT + p];
            acc[r] += s;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < kAcc; ++r) {
        const int o = tid + r * kThreads;
        const int i = o / kPT, p = o % kPT;
        if (o < kTQ * kPT && q0 + i < Q && p0 + p < P)
          store(&y[((t0 + q0 + i) * H + h) * P + p0 + p], acc[r]);
      }
    }

    // ---- state update: h' = exp(cs_last) h + sum_k exp(cs_last - cs_k) dt_k B_k x_k
    const float cl = cs[Q - 1];
    float st[kSt];
#pragma unroll
    for (int r = 0; r < kSt; ++r) {
      const int e = tid + r * kThreads;
      st[r] = e < kPT * N ? expf(cl) * hs[(e / N) * ld + e % N] : 0.f;
    }
    for (int k0 = 0; k0 < Q; k0 += kTK) {
      for (int e = tid; e < kTK * N; e += kThreads) {
        const int j = e / N, n = e % N;
        Bs[j * ld + n] = k0 + j < Q ? to_f(Bm[(t0 + k0 + j) * N + n]) : 0.f;
      }
      for (int e = tid; e < kTK * kPT; e += kThreads) {
        const int j = e / kPT, p = e % kPT;
        Xs[e] = (k0 + j < Q && p0 + p < P) ? to_f(x[((t0 + k0 + j) * H + h) * P + p0 + p]) : 0.f;
      }
      if (tid < kTK) wk[tid] = k0 + tid < Q ? expf(cl - cs[k0 + tid]) * dtv[k0 + tid] : 0.f;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kSt; ++r) {
        const int e = tid + r * kThreads;
        if (e < kPT * N) {
          const int p = e / N, n = e % N;
          float s = 0.f;
          for (int j = 0; j < kTK; ++j) s += wk[j] * Bs[j * ld + n] * Xs[j * kPT + p];
          st[r] += s;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kSt; ++r) {
      const int e = tid + r * kThreads;
      if (e < kPT * N) hs[(e / N) * ld + e % N] = st[r];
    }
    __syncthreads();
  }

  for (int e = tid; e < kPT * N; e += kThreads) {
    const int p = e / N, n = e % N;
    if (p0 + p < P) state_out[(head_state + p0 + p) * N + n] = hs[p * ld + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                   const float* init_state, void* y, float* state_out, int B, int S, int H, int P,
                   int N, int Q, cudaStream_t stream) {
  const int ld = N + 1;
  const size_t smem = sizeof(float) *
      ((size_t)2 * Q + (size_t)(kPT + kTQ + kTK) * ld + kTK * kPT + kTQ * kTK + kTK);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(H, B, (P + kPT - 1) / kPT);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init_state, static_cast<T*>(y), state_out, S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_max_n() { return kMaxN; }

// x, y: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, 1, N); init_state
// (may be null) and state_out: (B, H, P, N).  S must be a multiple of Q and
// N at most ssd_scan_max_n(); x, Bm, Cm and y are bfloat16 when is_bf16.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A, const void* Bm,
                               const void* Cm, const float* init_state, void* y,
                               float* state_out, int B, int S, int H, int P, int N, int Q,
                               int is_bf16, void* stream) {
  if (N > kMaxN || Q < 1 || S % Q != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init_state, y, state_out, B, S, H, P, N, Q, s)
              : launch<float>(x, dt, A, Bm, Cm, init_state, y, state_out, B, S, H, P, N, Q, s);
  return (int)err;
}
