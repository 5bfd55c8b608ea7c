// Dense float32 products C = A . B on Hopper's tensor cores (sm_90a), in
// split-precision TF32, for the served prefill's projections.
//
// Replaces no Pallas kernel: the JAX package leaves its dense products to
// XLA (jnp.einsum / @ in models/attention.py and models/layers.py).  The
// port's float32 products went to cuBLAS, which at float32 without TF32
// runs them on the CUDA cores (67 TFLOP/s on an H100); at the served
// prefill's shapes they took ~185 ms of a 221-ms minicpm-2b prefill.  One
// TF32 product is not float32 (its operands keep 10 mantissa bits: the
// served logits move by ~1e-3 of their largest), so each operand is split:
// x = big + small with big = tf32(x) and small = tf32(x - big), both to
// nearest (ties away from zero, as cvt.rna.tf32.f32), and
//   a.b = small(a).big(b) + big(a).small(b) + big(a).big(b),
// each term exact in float32 (small.small, ~2^-22 |a||b|, is dropped).  Same
// function as kernels/ref.py::linear_tf32x3_ref.
//
// A is (M, K) float32, rows lda floats apart.  B is float32 in one of two
// layouts: (K, N) rows ldb apart ("KN": every projection and MLP weight,
// the q/k/v weights (d, H, hd) read as (d, H hd)), or (N, K) rows ldb apart
// ("NK": the tied embedding table, which the unembedding multiplies by its
// transpose).  C is (M, N) float32, contiguous.  Up to kMaxGroup products
// that share A (q, k, v; gate and up) run as one launch, each with its own
// B, N and C.
//
// What bounds it on this card: operations.  Three TF32 products at 495
// TFLOP/s bound the float32 product at 165 TFLOP/s; a 1,523-token prefill's
// 8.3 TFLOP of dense products, >= 50 ms.  The tensor cores truncate what
// they accumulate (each wgmma's k-step of 8 terms rounds the running sum
// toward zero): with every k-step of every term in one accumulator the
// error grows with K, ~2e-5 of the result at K = 2,304 and ~5e-5 at 5,760,
// 60-170 x a float32 product's.  So each 32-deep k-tile's 12 wgmmas go into
// a fresh accumulator, added to the running sum in float32 (to nearest),
// which keeps the error at a float32 product's (~5e-7).
//
// wgmma takes TF32 operands from shared memory only K-major, and the KN
// weights are N-major: they are transposed in the pass that splits them.
// No weight copy is kept, split or transposed, outside shared memory.
//
// Design: one CTA a 128 x 128 tile of C, 384 threads, one CTA an SM (197 KB
// of shared memory):
// * Tiles: blockIdx.x walks the M tiles fastest, then the N tiles of each
//   product in turn, so the CTAs of a wave share A's rows and a band of B's
//   columns in L2.
// * Loads: one thread keeps TMA loads of raw float32 tiles in flight in a
//   ring of kStages stages (A's 128 x 32 box under the 128-byte swizzle,
//   K-major as wgmma reads it; B's 32 x 128 box, N-major, unswizzled, for KN
//   and its 128 x 32 box under the swizzle for NK), each completing on a
//   full barrier (an mbarrier counting the bytes); an empty barrier per
//   stage counts the threads done reading it.
// * Warpgroup 2 (the transform group; 40 registers) splits each B tile into
//   big and small tiles, K-major under the 128-byte swizzle, in a ring of
//   kSplitBufs (a KN tile is transposed on the way: a thread reads one
//   column's 4 k values, conflict-free across a warp, and writes them as one
//   16-byte chunk), then releases the raw stage and signals the split
//   buffer's full barrier.
// * Warpgroups 0 and 1 (232 registers) each own 64 rows of the tile.  A
//   thread loads its A fragment (the m64nNk8 layout: rows g and g + 8 of its
//   warp's 16, k slots t and t + 4) from the raw stage, splits it in
//   registers, and issues 12 wgmma.m64n128k8.tf32 a k-tile (4 k-steps x
//   the three terms, the small ones first) with A from registers and B's
//   big or small tile from shared memory, into a fresh accumulator; after
//   the wait it releases the split buffer and adds the fresh sum to the
//   running one.  The two warpgroups fall into turns on the tensor cores:
//   one adds and splits while the other's wgmmas run.
// * Epilogue: each thread stores its 2 x 32 pairs straight from registers
//   (float2 where N is even, else single floats, masked at M and N: the
//   unembedding's N, 122,753, is odd, so its rows are not 16-byte aligned
//   and TMA cannot store them).
// Rows past M and columns past N read as zeros (TMA's out-of-bounds fill)
// and are not stored; K past the last whole k-tile reads as zeros.

#include <cuda.h>  // CUtensorMap and the types of its encoder
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;  // a CTA's tile; a k-tile's depth
constexpr int kStages = 4;                     // raw (A, B) tiles in flight
constexpr int kSplitBufs = 2;                  // split B tiles (big, small)
constexpr int kConsumers = 256;                // warpgroups 0 and 1
constexpr int kThreads = kConsumers + 128;     // and the transform group
constexpr int kTile = kBM * kBK * 4;           // 16 KB: a raw A or B tile, a big or small tile
constexpr int kSmem = (2 * kStages + 2 * kSplitBufs) * kTile + 1024;  // 1 KB to align the swizzle
constexpr int kMaxGroup = 3;
static_assert(kBN * kBK * 4 == kTile, "B tiles are A tiles' size");
static_assert(kSmem <= 232448, "a CTA's shared memory");

struct Maps {  // A, and each product's B
  CUtensorMap a;
  CUtensorMap b[kMaxGroup];
};
struct Outs {
  float* c[kMaxGroup];
  int n[kMaxGroup];
  int col_tiles[kMaxGroup];  // N tiles of each product
};

// x rounded to TF32 (to nearest, ties away from zero, as cvt.rna.tf32.f32
// for finite x)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ uint32_t tf32_rest(float x, uint32_t big) {
  return tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// waits until the barrier's phase of parity `parity` has completed
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

// a wgmma shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: 128-byte rows (32 TF32 values), 8-row groups 1,024 bytes apart;
// a k-step of 8 values is 32 bytes into the rows
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(16 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
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

// D (64 x 128, float32) = A (64 x 8, TF32 in registers: each warp's 16 rows
// as the m16n8k8 A fragment) . B (8 x 128, TF32 in shared memory, K-major
// under the 128-byte swizzle), plus D where `accumulate`
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// B's raw tile at `raw` split into big and small tiles at `big` / `small`
// (generic pointers to shared memory), K-major under the 128-byte swizzle:
// the 16-byte chunk c (k values 4c .. 4c + 3) of column n at n * 128 +
// ((c ^ (n % 8)) << 4).  KN: raw is 32 rows of k x 128 columns, 512 bytes a
// row; NK: raw already has the target layout.  By the transform group's
// thread `tt`, 8 chunks each.
template <bool kNK>
__device__ __forceinline__ void split_b(const unsigned char* raw, unsigned char* big,
                                        unsigned char* small, int tt) {
#pragma unroll 2
  for (int i = 0; i < kBN * kBK / 4 / 128; ++i) {
    const int idx = tt + 128 * i;
    float4 x;
    int off;
    if (kNK) {
      off = idx * 16;
      x = *reinterpret_cast<const float4*>(raw + off);
    } else {
      const int n = idx % kBN, c = idx / kBN;
      const float* col = reinterpret_cast<const float*>(raw) + 4 * c * kBN + n;
      x = make_float4(col[0], col[kBN], col[2 * kBN], col[3 * kBN]);
      off = n * 128 + ((c ^ (n % 8)) << 4);
    }
    uint4 b, s;
    b.x = tf32(x.x), b.y = tf32(x.y), b.z = tf32(x.z), b.w = tf32(x.w);
    s.x = tf32_rest(x.x, b.x), s.y = tf32_rest(x.y, b.y);
    s.z = tf32_rest(x.z, b.z), s.w = tf32_rest(x.w, b.w);
    *reinterpret_cast<uint4*>(big + off) = b;
    *reinterpret_cast<uint4*>(small + off) = s;
  }
}

template <bool kNK>
__global__ void __launch_bounds__(kThreads, 1)
linear_tf32x3_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Outs outs, int M,
                     int K, int m_tiles) {
  extern __shared__ unsigned char smem_raw[];
  // per stage: full (TMA bytes), empty (threads done reading); per split
  // buffer: full (the transform group's writes), empty (consumers' wgmmas)
  __shared__ __align__(8) uint64_t bars[2 * kStages + 2 * kSplitBufs];

  // the tile: M tiles fastest, then each product's N tiles
  int col = blockIdx.x / m_tiles, g = 0;
  const int m0 = (blockIdx.x % m_tiles) * kBM;
  while (g < kMaxGroup - 1 && col >= outs.col_tiles[g]) col -= outs.col_tiles[g++];
  const int n0 = col * kBN;
  const int kt = (K + kBK - 1) / kBK;

  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw_s + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw_s);
  // [A raw x kStages][B raw x kStages][big x kSplitBufs][small x kSplitBufs]
  const uint32_t a_raw = base, b_raw = base + kStages * kTile;
  const uint32_t big_s = base + 2 * kStages * kTile, small_s = big_s + kSplitBufs * kTile;
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(bars);
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kStages + s); };
  auto split_full = [&](int b) { return bar0 + 8 * (2 * kStages + b); };
  auto split_empty = [&](int b) { return bar0 + 8 * (2 * kStages + kSplitBufs + b); };
  const CUtensorMap* bmap = &maps.b[g];

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kThreads);
    }
#pragma unroll
    for (int b = 0; b < kSplitBufs; ++b) {
      mbar_init(split_full(b), 128);
      mbar_init(split_empty(b), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ the transform group
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int tt = threadIdx.x - kConsumers;
    auto issue = [&](int t) {  // k-tile t into stage t % kStages
      const int s = t % kStages;
      mbar_expect(full(s), 2 * kTile);
      tma_box(a_raw + s * kTile, &maps.a, t * kBK, m0, full(s));
      if (kNK)
        tma_box(b_raw + s * kTile, bmap, t * kBK, n0, full(s));
      else
        tma_box(b_raw + s * kTile, bmap, n0, t * kBK, full(s));
    };
    if (tt == 0)
      for (int t = 0; t < kStages && t < kt; ++t) issue(t);
    for (int t = 0; t < kt; ++t) {
      const int s = t % kStages, b = t % kSplitBufs;
      // the stage of k-tile t - 1 takes k-tile t - 1 + kStages once read
      if (tt == 0 && t >= 1 && t - 1 + kStages < kt) {
        mbar_wait(empty((t - 1) % kStages), ((t - 1) / kStages) & 1);
        issue(t - 1 + kStages);
      }
      mbar_wait(full(s), (t / kStages) & 1);
      if (t >= kSplitBufs) mbar_wait(split_empty(b), ((t - kSplitBufs) / kSplitBufs) & 1);
      split_b<kNK>(gbase + (b_raw - base) + s * kTile, gbase + (big_s - base) + b * kTile,
                   gbase + (small_s - base) + b * kTile, tt);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      mbar_arrive(split_full(b));
      mbar_arrive(empty(s));
    }
  } else {
    // ------------------------------------------------ the consumer groups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int gq = lane / 4, tq = lane % 4;
    const int r0 = 64 * wg + 16 * ((threadIdx.x / 32) % 4) + gq;  // and r0 + 8; r0 % 8 == gq
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;  // part: overwritten a k-tile
    uint32_t ab[16], as[16];  // A's fragment: [4 kk + 2 h + x] = (row r0 + 8 x, k 8 kk + tq + 4 h)

    for (int t = 0; t < kt; ++t) {
      const int s = t % kStages, b = t % kSplitBufs;
      mbar_wait(full(s), (t / kStages) & 1);
      const unsigned char* at = gbase + (a_raw - base) + s * kTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int r = r0 + 8 * x, c = 8 * kk + tq + 4 * h;
            const float v = *reinterpret_cast<const float*>(
                at + r * 128 + ((((c >> 2) ^ gq) << 4) | ((c & 3) << 2)));
            const int i = 4 * kk + 2 * h + x;
            ab[i] = tf32(v);
            as[i] = tf32_rest(v, ab[i]);
          }
      mbar_arrive(empty(s));
      mbar_wait(split_full(b), (t / kSplitBufs) & 1);
      const uint32_t bb = big_s + b * kTile, bs = small_s + b * kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t* a_b = ab + 4 * kk;
        const uint32_t* a_s = as + 4 * kk;
        wgmma_tf32(part, a_s[0], a_s[1], a_s[2], a_s[3], kmajor_desc(bb + 32 * kk), kk > 0);
        wgmma_tf32(part, a_b[0], a_b[1], a_b[2], a_b[3], kmajor_desc(bs + 32 * kk), 1);
        wgmma_tf32(part, a_b[0], a_b[1], a_b[2], a_b[3], kmajor_desc(bb + 32 * kk), 1);
      }
      wgmma_commit_wait();
      reg_fence(part);
      reg_fence(ab);
      reg_fence(as);
      mbar_arrive(split_empty(b));
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }

    // acc[4 j + 2 x + e] is row r0 + 8 x, column 8 j + 2 tq + e of the tile
    float* C = outs.c[g];
    const int N = outs.n[g];
    const bool pairs = N % 2 == 0;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = m0 + r0 + 8 * x;
      if (row >= M) continue;
      float* crow = C + (size_t)row * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * tq;
        const float v0 = acc[4 * j + 2 * x], v1 = acc[4 * j + 2 * x + 1];
        if (pairs) {
          if (n < N) *reinterpret_cast<float2*>(crow + n) = make_float2(v0, v1);
        } else {
          if (n < N) crow[n] = v0;
          if (n + 1 < N) crow[n + 1] = v1;
        }
      }
    }
  }
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

// a (rows, cols) float32 matrix, rows `ld` floats apart, in boxes of
// box_cols x box_rows; under the 128-byte swizzle (32-column boxes) or none
bool box_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols, uint64_t ld,
             uint32_t box_cols, uint32_t box_rows, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {ld * sizeof(float)};
  const cuuint32_t box[2] = {box_cols, box_rows}, step[2] = {1, 1};
  return encode && encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                          strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kNK>
cudaError_t launch(const Maps& maps, const Outs& outs, int tiles, int M, int K, int m_tiles,
                   cudaStream_t stream) {
  static bool opted_in = false;  // the attribute is set once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        linear_tf32x3_kernel<kNK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  linear_tf32x3_kernel<kNK><<<tiles, kThreads, kSmem, stream>>>(maps, outs, M, K, m_tiles);
  return cudaGetLastError();
}

}  // namespace

// C_g = A . B_g for g < G (G <= kMaxGroup), A (M, K) rows lda apart, B_g
// (K, N_g) rows ldb_g apart (nk == 0) or (N_g, K) (nk == 1), C_g (M, N_g)
// contiguous.  Base addresses 16-byte aligned, lda and ldb multiples of 4
// (TMA's 16-byte strides), M, K, N_g >= 1.  Returns a cudaError_t.
extern "C" int linear_tf32x3_launch(const void* a, const void* b0, const void* b1,
                                    const void* b2, void* c0, void* c1, void* c2, int n0,
                                    int n1, int n2, int ldb0, int ldb1, int ldb2, int G, int M,
                                    int K, int lda, int nk, void* stream) {
  const void* bs[kMaxGroup] = {b0, b1, b2};
  void* cs[kMaxGroup] = {c0, c1, c2};
  const int ns[kMaxGroup] = {n0, n1, n2}, lds[kMaxGroup] = {ldb0, ldb1, ldb2};
  if (G < 1 || G > kMaxGroup || M < 1 || K < 1 || lda % 4 || (uintptr_t)a % 16)
    return cudaErrorInvalidValue;
  Maps maps;  // by value in the launch
  Outs outs = {};
  if (!box_map(&maps.a, a, M, K, lda, kBK, kBM, true)) return cudaErrorInvalidValue;
  int col_tiles = 0;
  for (int g = 0; g < G; ++g) {
    if (ns[g] < 1 || lds[g] % 4 || (uintptr_t)bs[g] % 16) return cudaErrorInvalidValue;
    const bool ok = nk ? box_map(&maps.b[g], bs[g], ns[g], K, lds[g], kBK, kBN, true)
                       : box_map(&maps.b[g], bs[g], K, ns[g], lds[g], kBN, kBK, false);
    if (!ok) return cudaErrorInvalidValue;
    outs.c[g] = static_cast<float*>(cs[g]);
    outs.n[g] = ns[g];
    outs.col_tiles[g] = (ns[g] + kBN - 1) / kBN;
    col_tiles += outs.col_tiles[g];
  }
  for (int g = G; g < kMaxGroup; ++g) maps.b[g] = maps.b[0];
  const int m_tiles = (M + kBM - 1) / kBM;
  const long long tiles = (long long)m_tiles * col_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nk ? launch<true>(maps, outs, (int)tiles, M, K, m_tiles, s)
            : launch<false>(maps, outs, (int)tiles, M, K, m_tiles, s);
}
