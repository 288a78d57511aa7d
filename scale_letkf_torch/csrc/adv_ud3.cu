// Tracer tendencies of the compressible core: −∇·(F q/ρ) − kdiff4 ∇⁴q for
// every tracer of every member of a batch, in one launch.
//
// Replaces the TPU kernel scale_letkf_tpu/ops/pallas_stencil.py
// _adv_div_kernel (launched by adv_flux_divergence_pallas), which computed
// one tracer's UD3 flux divergence per call on uniform dz. Here:
//   - one launch covers all NQ tracers of all B members (the vmap over
//     tracers of dycore.tendencies);
//   - φ = q/ρ is formed in the kernel, with no floor on ρ (dycore.py
//     scalar_tend), so no mixing-ratio copy of the tracers is written;
//   - the vertical metric is the per-level cell thickness dzc (stretched
//     levels of the shipped configurations; the TPU kernel took one dz);
//   - kdiff4 ≠ 0 adds the tracer's ∇⁴ hyperdiffusion, the rest of
//     scalar_tend; kdiff4 = 0 is exactly the TPU kernel's scope.
//
// What bounds it: device memory. Per output point it must read q and write
// the tendency, plus ρ, fx, fy and fw once per member for all NQ tracers:
// (2·NQ + 4)·4 bytes against ~60 flops and ~12 divisions per tracer — nine
// by constants (stencil.cuh div_rcp), the rest by ρ (quot). In practice
// instruction issue limits it well above that bound (PERF.md §6).
// Design (stencil.cuh): one CTA per (member, 32 × 8 tile) marches up the
// column. Per level it copies ρ, fx, fy into shared memory once, then
// passes the NQ tracer planes through the same tile; each plane (with its
// 2-cell halo, periodic or edge-clamped) arrives by cp.async while the
// previous one computes. φ = q/ρ is divided once per loaded point into a
// shared plane
// that the 13 UD3 taps read, and ∇⁴q = lap(lap q) comes from a shared
// Laplacian plane. The z stencil reads the thread's own column: φ(k−2 …
// k+2) in a per-thread ring in shared memory, filled two levels ahead from
// device memory, and fw at the faces k and k+1 in registers.
//
// C entry point (ctypes): adv_ud3_launch(q, rho, fx, fy, fw, dzc, out, B,
// nq, nz, ny, nx, dx, dy, kdiff4, open, stream) — open ≠ 0: the lateral
// mode 'open' (edge-clamped x and y, stencil.cuh), else periodic; q and out
// (B, nq, nz, ny, nx),
// rho, fx, fy (B, nz, ny, nx), fw (B, nz+1, ny, nx), dzc (nz,), float32,
// contiguous, on the device; 64-bit offsets (a full-size batch spans
// ~1.9e9 elements). Launches on `stream`, does not synchronise, and returns
// the launch's cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for sizes the grid or shared memory cannot hold.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using stencil::NT;
using stencil::PLANE;
using stencil::Tile;

constexpr int COL = 5;  // φ(k−2 … k+2) of the thread's own column

// Shared floats of one CTA: two stages of (ρ, fx, fy), two stages of a
// tracer plane, the φ and lap(q) planes, and the column ring of each tracer.
__host__ __device__ constexpr int64_t smem_floats(int64_t nq) {
  return 2 * 3 * PLANE + 2 * PLANE + 2 * PLANE + nq * COL * NT;
}

// four CTAs an SM, as its shared memory allows: at most 64 registers
template <bool OPEN>
__global__ void __launch_bounds__(NT, 4)
adv_ud3_kernel(const float* __restrict__ q, const float* __restrict__ rho,
               const float* __restrict__ fx, const float* __restrict__ fy,
               const float* __restrict__ fw, const float* __restrict__ dzc,
               float* __restrict__ out, int nq, int nz, int ny, int nx,
               int tiles_x, float dx, float dy, float kdiff4) {
  extern __shared__ float smem[];
  float* lvl = smem;                  // [stage][ρ, fx, fy][PLANE]
  float* qs = lvl + 2 * 3 * PLANE;    // [stage][PLANE]
  float* phi = qs + 2 * PLANE;
  float* lapq = phi + PLANE;
  float* col = lapq + PLANE;          // [tracer][level % COL][NT]

  const Tile t(blockIdx.x, tiles_x, ny, nx, OPEN);
  const stencil::Nbr<OPEN> n(t, ny, nx);
  const int b = blockIdx.y;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const float* rho_b = rho + static_cast<int64_t>(b) * nz * plane;
  const float* fx_b = fx + static_cast<int64_t>(b) * nz * plane;
  const float* fy_b = fy + static_cast<int64_t>(b) * nz * plane;
  const float* fw_b = fw + static_cast<int64_t>(b) * (nz + 1) * plane;
  const float* q_b = q + static_cast<int64_t>(b) * nq * nz * plane;
  float* out_b = out + static_cast<int64_t>(b) * nq * nz * plane;
  const bool diffuse = kdiff4 != 0.f;
  const float rdx = 1.f / dx, rdy = 1.f / dy;
  auto qplane = [&](int tr, int k) {
    return q_b + (static_cast<int64_t>(tr) * nz + k) * plane;
  };
  auto colv = [&](int tr, int k) -> float& {
    return col[(tr * COL + k % COL) * NT + t.tid];
  };

  // item (k, tr) = tracer tr at level k; stage = item parity
  auto prefetch = [&](int k, int tr, int item) {
    if (tr == 0) {
      float* l = lvl + (k & 1) * 3 * PLANE;
      t.load(l, rho_b + k * plane);
      t.load(l + PLANE, fx_b + k * plane);
      t.load(l + 2 * PLANE, fy_b + k * plane);
    }
    t.load(qs + (item & 1) * PLANE, qplane(tr, k));
    __pipeline_commit();
  };

  prefetch(0, 0, 0);
  if (t.active)
    for (int tr = 0; tr < nq; ++tr)
      for (int k = 0; k < 2 && k < nz; ++k)
        colv(tr, k) = stencil::quot(__ldg(qplane(tr, k) + t.own),
                                    __ldg(rho_b + k * plane + t.own));
  float fw0 = t.active ? __ldg(fw_b + t.own) : 0.f;

  int item = 0;
  for (int k = 0; k < nz; ++k) {
    const float fw1 = t.active ? __ldg(fw_b + (k + 1) * plane + t.own) : 0.f;
    const float dzc_k = dzc[k], rdzc_k = 1.f / dzc_k;
    const float* l = lvl + (k & 1) * 3 * PLANE;
    for (int tr = 0; tr < nq; ++tr, ++item) {
      // own column two levels ahead, loaded before the wait
      const bool ahead = t.active && k + 2 < nz;
      float qa = 0.f, ra = 1.f;
      if (ahead) {
        qa = __ldg(qplane(tr, k + 2) + t.own);
        ra = __ldg(rho_b + (k + 2) * plane + t.own);
      }
      __pipeline_wait_prior(0);
      __syncthreads();  // item's planes in; the previous item's reads done
      if (tr + 1 < nq)
        prefetch(k, tr + 1, item + 1);
      else if (k + 1 < nz)
        prefetch(k + 1, 0, item + 1);

      const float* qk = qs + (item & 1) * PLANE;
      stencil::for_region(t.tid, 0,
                          [&](int s) { phi[s] = stencil::quot(qk[s], l[s]); });
      if (diffuse)
        stencil::for_region(t.tid, 1,
                            [&](int s) { lapq[s] = stencil::lap(qk, s); });
      if (ahead) colv(tr, k + 2) = stencil::quot(qa, ra);
      __syncthreads();

      if (t.active) {
        float v = stencil::scalar_adv(
            phi, l + PLANE, l + 2 * PLANE, t.c, n, colv(tr, k + COL - 2),
            colv(tr, k + COL - 1), colv(tr, k + 1), colv(tr, k + 2), fw0, fw1,
            dzc_k, rdzc_k, nz, k, dx, rdx, dy, rdy);
        if (diffuse) v = v + stencil::hyperdiff4(lapq, kdiff4, t.c, n);
        out_b[(static_cast<int64_t>(tr) * nz + k) * plane + t.own] = v;
      }
    }
    fw0 = fw1;
  }
}

}  // namespace

extern "C" int adv_ud3_launch(const void* q, const void* rho, const void* fx,
                              const void* fy, const void* fw, const void* dzc,
                              void* out, int64_t B, int64_t nq, int64_t nz,
                              int64_t ny, int64_t nx, float dx, float dy,
                              float kdiff4, int open, void* stream) {
  const int64_t tiles_x = (nx + stencil::TX - 1) / stencil::TX;
  const int64_t tiles_y = (ny + stencil::TY - 1) / stencil::TY;
  const int64_t smem = smem_floats(nq) * static_cast<int64_t>(sizeof(float));
  if (B < 1 || nq < 1 || nz < 2 || nx < 2 || ny < 2 || B > 65535 ||
      tiles_x * tiles_y > 0x7fffffff || ny * nx > 0x7fffffff ||
      smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = open ? adv_ud3_kernel<true> : adv_ud3_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y),
                  static_cast<unsigned>(B));
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(rho),
      static_cast<const float*>(fx), static_cast<const float*>(fy),
      static_cast<const float*>(fw), static_cast<const float*>(dzc),
      static_cast<float*>(out), static_cast<int>(nq), static_cast<int>(nz),
      static_cast<int>(ny), static_cast<int>(nx), static_cast<int>(tiles_x),
      dx, dy, kdiff4);
  return static_cast<int>(cudaGetLastError());
}
