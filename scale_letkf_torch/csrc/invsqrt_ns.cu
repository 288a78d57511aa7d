// Fused coupled Newton–Schulz inverse square root for batches of small SPD
// matrices: the LETKF ensemble-space solve (C^{-1/2} and C^{-1} of the K×K
// Gram matrix at every gridpoint).
//
// Replaces the TPU kernel scale_letkf_tpu/ops/invsqrt.py _ns_fused_kernel
// (launched by invsqrt_ns_pallas). Same algorithm, rethought for Hopper:
//   phase 1: it_lo iterations  T = 1.5I − 0.5·Z·Y ; Y ← Y·T ; Z ← T·Z
//            from (Y, Z) = (areg, I), areg the spectrum-floored matrix
//   re-anchor Y = A·Z on the true matrix A
//   phase 2: it_hi polish iterations, then Z ← (Z + Zᵀ)/2
//   out: isq = Z, inv = Z·Z
//
// What bounds it: matrix products. Per matrix (3·it_lo + 3·it_hi + 2) kp³
// multiply-adds — 62 kp³, 32.5 MFLOP at kp = 64 — against 4 kp² floats of
// device memory traffic (a and areg read once, isq and inv written once:
// 1.90 GB, 0.57 ms at 3.35 TB/s for the 28,928 Grams of one level chunk),
// so it sits far above the ridge point. TMA or a deeper copy pipeline would
// hide loads that take a tenth of the run and buy nothing; what counts is
// the rate of the products and of the instructions that feed them.
//
// What bounds it now: the tensor-core instruction. On an H100 SXM at 700 W
// (PERF.md §6) one level chunk takes 12.8 ms: 3 TF32 passes over
// 940 GFLOP at 220 TFLOP/s, 68% of the 324 TFLOP/s that mma.sync TF32
// reaches there alone (python -m scale_letkf_torch.invsqrt_compare) and
// 44% of the 495 TFLOP/s of wgmma. The rest goes to what feeds the mma: a
// warp's k-step issues 6 shared loads, 16 splits (4 operations each) and
// 24 mma, and an iteration waits at 3 barriers.
//
// The products run on the tensor cores (mma.sync m16n8k8, TF32 in, FP32
// accumulate) with a 3xTF32 split that keeps FP32-level accuracy: each
// operand element x becomes hi = x rounded to TF32 (to nearest, ties away
// from zero, as cvt.rna.tf32.f32 rounds) and lo = x − hi cut to TF32
// (toward zero), so hi + lo is x to 2^-21; every k-step of 8 issues lo·hi
// and hi·lo first and then hi·hi into one float accumulator. Split and
// order are those of CUTLASS's fast-FP32 tensor-op MMA; lo·lo, ~2^-21
// relative, is dropped. One TF32 pass alone is not enough: the
// coupled iteration has neutral error modes, so a low-precision phase 1
// floors at ~1e-2 however well phase 2 polishes. Y, Z and T stay FP32
// planes in shared memory and are split in registers after each load.
//
// Why mma.sync and not wgmma: for 32-bit types wgmma takes both operands
// K-major from shared memory in its swizzled layout. Each of Y, Z and T is
// the B operand of some product, so all three would sit in shared memory
// pre-split as hi and lo — 96 KB a matrix at kp = 64, which halves the
// matrices in flight, and more than a CTA may hold at kp = 128.
// Why not nvcuda::wmma: measured on the H100 (PERF.md §6) the wmma
// form of this kernel was slower than the FP32-FMA kernel it replaces:
// its fragment loads compile to generic LD, not LDS, one scalar load per
// element, and cvt.rna.tf32 adds a range check per element. With mma.sync
// the fragment layout is documented, so this kernel chooses it:
//   - the k index of an 8-step is permuted (mma column t ↔ k 2t, t + 4 ↔
//     2t + 1), and so are the rows of a 16-row block (mma row g ↔ 2g,
//     g + 8 ↔ 2g + 1) and the columns of a warp's 32 (mma column c of
//     n8-block j ↔ 4c + j). A product is the same sum under any consistent
//     relabelling, and then an A fragment is two 64-bit loads and the
//     B fragments of four n8-blocks two 128-bit loads, and each thread's
//     accumulators are 8 adjacent columns of 2 rows: 128-bit stores;
//   - the TF32 rounding is the integer (bits + 0x1000) & ~0x1fff, equal to
//     cvt.rna.tf32.f32 on finite values without its range check; lo is cut
//     by the mask alone (rounding it too cost 6%; leaving the cut to the
//     tensor cores, which read the top 19 bits only, changed nothing).
//
// Layout:
//   - one CTA per matrix; Y, Z, T in dynamic shared memory as kp × S
//     floats, S = kp + 4: 3·64·68·4 = 52,224 bytes at kp = 64 (four CTAs an
//     SM), 202,752 bytes at kp = 128 (one). Banks (word (row, col) in bank
//     (row·S + col) mod 32, S ≡ 4): an A load (a half-warp of 64-bit words
//     at rows 2g, cols 2t) covers 8g + 2t + {0, 1}, a B load (a quarter-warp
//     of 128-bit words at row 2t, cols 4g) 8t + 4g + {0..3}: both
//     conflict-free; the accumulator stores (once per product) are two-way;
//   - warp w owns a 32 × 32 tile of every product (2 m16-blocks × 4
//     n8-blocks: 4 warps at kp = 64, 16 at kp = 128) and keeps its
//     accumulators in registers; each loaded and split A fragment serves 4
//     n8-blocks, each B fragment 2 m16-blocks, so a k-step splits 16
//     elements for 24 mma. Y·T and T·Z are both computed from the old Y, Z
//     and T, and written back after a barrier;
//   - T = 1.5I − 0.5·Z·Y is applied to the accumulators before their store;
//   - the re-anchor stages A in T (free at that point), so every product
//     reads shared memory; inv = Z·Z is stored straight to global memory.
//
// C entry point (ctypes): invsqrt_ns_launch(a, areg, isq, inv, B, kp,
// it_lo, it_hi, stream) — (B, kp, kp) float32 row-major device arrays,
// kp ∈ {64, 128}, inv 16-byte aligned; launches on `stream`, does not
// synchronise, and returns the launch's cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// A warp's tile of a product: MR m16-blocks × 4 n8-blocks, 32 × 32.
constexpr int MR = 2;
constexpr int WT = 32;

template <int KP>
struct Shape {
  static constexpr int S = KP + 4;        // shared-memory row stride
  static constexpr int WC = KP / WT;      // warps across the columns
  static constexpr int NT = 32 * WC * WC;  // threads per CTA
  static constexpr int MIN_CTAS = KP == 64 ? 4 : 1;  // as shared memory allows
  static_assert(KP % WT == 0, "tiles must divide kp");
};

constexpr uint32_t kTf32Mask = 0xffffe000u;  // TF32: the low 13 bits clear

// x = hi + lo: hi rounded to TF32 (to nearest, ties away from zero), lo the
// rest cut to TF32 (toward zero)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32Mask;
}

// d += a·b on one m16n8k8 TF32 tile (PTX ISA fragment layouts)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j][e]: the warp's tile (rows m0.., columns n0..) of X·W, X and W
// kp × kp in shared memory with row stride S, by 3xTF32 products. Thread
// (g, t) = (lane / 4, lane % 4) holds, for m16-block i and n8-block j,
// e = 2r + h at row m0 + 16i + 2g + r, column n0 + 8t + 4h + j.
template <int KP>
__device__ __forceinline__ void mm(const float* __restrict__ X,
                                   const float* __restrict__ W, int m0,
                                   int n0, int g, int t,
                                   float (&acc)[MR][4][4]) {
  using Sh = Shape<KP>;
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const float* xp = X + (m0 + 2 * g) * Sh::S + 2 * t;
  const float* wp = W + 2 * t * Sh::S + n0 + 4 * g;
#pragma unroll 4
  for (int k = 0; k < KP; k += 8) {
    uint32_t ah[MR][4], al[MR][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const float2 r0 = *reinterpret_cast<const float2*>(
          xp + 16 * i * Sh::S + k);
      const float2 r1 = *reinterpret_cast<const float2*>(
          xp + (16 * i + 1) * Sh::S + k);
      split(r0.x, ah[i][0], al[i][0]);
      split(r1.x, ah[i][1], al[i][1]);
      split(r0.y, ah[i][2], al[i][2]);
      split(r1.y, ah[i][3], al[i][3]);
    }
    const float4 w0 = *reinterpret_cast<const float4*>(wp + k * Sh::S);
    const float4 w1 = *reinterpret_cast<const float4*>(wp + (k + 1) * Sh::S);
    split(w0.x, bh[0][0], bl[0][0]);
    split(w1.x, bh[0][1], bl[0][1]);
    split(w0.y, bh[1][0], bl[1][0]);
    split(w1.y, bh[1][1], bl[1][1]);
    split(w0.z, bh[2][0], bl[2][0]);
    split(w1.z, bh[2][1], bl[2][1]);
    split(w0.w, bh[3][0], bl[3][0]);
    split(w1.w, bh[3][1], bl[3][1]);
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(acc[i][j], al[i], bh[j]);
        mma_tf32(acc[i][j], ah[i], bl[j]);
        mma_tf32(acc[i][j], ah[i], bh[j]);
      }
  }
}

// The warp's tile of acc into M (row stride ld, 16-byte aligned rows).
__device__ __forceinline__ void store_tile(float* M, int ld, int m0, int n0,
                                           int g, int t,
                                           const float (&acc)[MR][4][4]) {
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* row = M + (m0 + 16 * i + 2 * g + r) * ld + n0 + 8 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(row + 4 * h) = make_float4(
            acc[i][0][2 * r + h], acc[i][1][2 * r + h], acc[i][2][2 * r + h],
            acc[i][3][2 * r + h]);
    }
}

// One coupled iteration on the shared-memory Y, Z with scratch T.
// Entry and exit: Y, Z complete and visible to the whole CTA.
template <int KP>
__device__ __forceinline__ void ns_step(float* Y, float* Z, float* T, int m0,
                                        int n0, int g, int t) {
  using Sh = Shape<KP>;
  {
    float acc[MR][4][4];
    mm<KP>(Z, Y, m0, n0, g, t, acc);                     // Z·Y
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + 16 * i + 2 * g + e / 2;
          const int c = n0 + 8 * t + 4 * (e % 2) + j;
          acc[i][j][e] = (r == c ? 1.5f : 0.f) - 0.5f * acc[i][j][e];
        }
    store_tile(T, Sh::S, m0, n0, g, t, acc);
  }
  __syncthreads();
  float ay[MR][4][4], az[MR][4][4];
  mm<KP>(Y, T, m0, n0, g, t, ay);                            // Y·T
  mm<KP>(T, Z, m0, n0, g, t, az);                            // T·Z
  __syncthreads();                 // every read of the old Y, Z is done
  store_tile(Y, Sh::S, m0, n0, g, t, ay);
  store_tile(Z, Sh::S, m0, n0, g, t, az);
  __syncthreads();
}

template <int KP>
__global__ void __launch_bounds__(Shape<KP>::NT, Shape<KP>::MIN_CTAS)
ns_fused_kernel(const float* __restrict__ a, const float* __restrict__ areg,
                float* __restrict__ isq, float* __restrict__ inv,
                int it_lo, int it_hi) {
  using Sh = Shape<KP>;
  extern __shared__ __align__(16) float smem[];
  float* Y = smem;
  float* Z = Y + KP * Sh::S;
  float* T = Z + KP * Sh::S;
  const size_t base = static_cast<size_t>(blockIdx.x) * KP * KP;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = warp / Sh::WC * WT, n0 = warp % Sh::WC * WT;

  for (int e = tid; e < KP * KP; e += Sh::NT) {
    const int r = e / KP, c = e % KP;
    Y[r * Sh::S + c] = areg[base + e];
    Z[r * Sh::S + c] = (r == c) ? 1.f : 0.f;
  }
  __syncthreads();
  for (int it = 0; it < it_lo; ++it)
    ns_step<KP>(Y, Z, T, m0, n0, g, t);

  // re-anchor the invariant Y = A·Z on the true matrix, A staged in T
  for (int e = tid; e < KP * KP; e += Sh::NT)
    T[(e / KP) * Sh::S + e % KP] = a[base + e];
  __syncthreads();
  {
    float acc[MR][4][4];
    mm<KP>(T, Z, m0, n0, g, t, acc);                         // Y is not read
    store_tile(Y, Sh::S, m0, n0, g, t, acc);
  }
  __syncthreads();
  for (int it = 0; it < it_hi; ++it)
    ns_step<KP>(Y, Z, T, m0, n0, g, t);

  // symmetrize into T: T = (Z + Zᵀ)/2 is the returned A^{-1/2}
  for (int e = tid; e < KP * KP; e += Sh::NT) {
    const int r = e / KP, c = e % KP;
    T[r * Sh::S + c] = 0.5f * (Z[r * Sh::S + c] + Z[c * Sh::S + r]);
  }
  __syncthreads();
  for (int e = tid; e < KP * KP; e += Sh::NT)
    isq[base + e] = T[(e / KP) * Sh::S + e % KP];
  float acc[MR][4][4];
  mm<KP>(T, T, m0, n0, g, t, acc);                           // A^{-1}
  store_tile(inv + base, KP, m0, n0, g, t, acc);
}

template <int KP>
int launch(const float* a, const float* areg, float* isq, float* inv, int B,
           int it_lo, int it_hi, cudaStream_t stream) {
  using Sh = Shape<KP>;
  const int smem = 3 * KP * Sh::S * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ns_fused_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_fused_kernel<KP><<<B, Sh::NT, smem, stream>>>(a, areg, isq, inv, it_lo,
                                                   it_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int invsqrt_ns_launch(const float* a, const float* areg,
                                 float* isq, float* inv, int B, int kp,
                                 int it_lo, int it_hi, void* stream) {
  if (B < 0 || it_lo < 0 || it_hi < 0 ||
      reinterpret_cast<uintptr_t>(inv) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kp) {
    case 64:
      return launch<64>(a, areg, isq, inv, B, it_lo, it_hi, s);
    case 128:
      return launch<128>(a, areg, isq, inv, B, it_lo, it_hi, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
