// Tracer tendencies of the compressible core: −∇·(F q/ρ) − kdiff4 ∇⁴q for
// every tracer of every member of a batch, in one launch.
//
// Replaces the TPU kernel scale_letkf_tpu/ops/pallas_stencil.py
// _adv_div_kernel (launched by adv_flux_divergence_pallas), which computed
// one tracer's UD3 flux divergence per call on uniform dz. Here:
//   - one launch covers all NQ tracers of all B members (the vmap over
//     tracers of dycore.tendencies), the slabs in the grid's z dimension;
//   - φ = q/ρ is formed in the kernel, with no floor on ρ (dycore.py
//     scalar_tend), so no mixing-ratio copy of the tracers is written;
//   - the vertical metric is the per-level cell thickness dzc (stretched
//     levels of the shipped configurations; the TPU kernel took one dz);
//   - kdiff4 ≠ 0 adds the tracer's ∇⁴ hyperdiffusion, the rest of
//     scalar_tend; kdiff4 = 0 is exactly the TPU kernel's scope.
// The Mosaic artifacts of the TPU kernel (x pre-haloed on the caller side,
// block_y dividing ny, three overlapping φ blocks) are gone: periodic x/y is
// index arithmetic and the composed stencil radius is 2 in x and y.
//
// What bounds it: device memory. Per output point it needs q, ρ, fx, fy, fw
// and writes one value — about 16 bytes of compulsory traffic for q and the
// output plus the per-member ρ and fluxes shared by the NQ tracers — against
// ~60 flops. One thread per output point reads its 13-point φ stencil and 3
// z neighbours through L1/L2; neighbouring threads share most of them.
// Shared-memory tiles with halos are the next step if the profile asks.
//
// C entry point (ctypes): adv_ud3_launch(q, rho, fx, fy, fw, dzc, out, B,
// nq, nz, ny, nx, dx, dy, kdiff4, stream) — q and out (B, nq, nz, ny, nx),
// rho, fx, fy (B, nz, ny, nx), fw (B, nz+1, ny, nx), dzc (nz,), float32,
// contiguous, on the device; 64-bit offsets (a full-size batch spans
// ~1.9e9 elements). Launches on `stream`, does not synchronise, and returns
// the launch's cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for sizes the grid cannot hold.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using stencil::Field;

__global__ void adv_ud3_kernel(const float* __restrict__ q,
                               const float* __restrict__ rho,
                               const float* __restrict__ fx,
                               const float* __restrict__ fy,
                               const float* __restrict__ fw,
                               const float* __restrict__ dzc,
                               float* __restrict__ out, int nq, int nz, int ny,
                               int nx, int tiles_x, float dx, float dy,
                               float kdiff4) {
  const int tj = blockIdx.x / tiles_x;
  const int ti = blockIdx.x - tj * tiles_x;
  const int i = ti * stencil::TX + threadIdx.x;
  const int j = tj * stencil::TY + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int k = blockIdx.y;
  const int bq = blockIdx.z;  // member · nq + tracer
  const int b = bq / nq;

  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t cen = static_cast<int64_t>(b) * nz * plane;
  const int64_t fac = static_cast<int64_t>(b) * (nz + 1) * plane;
  const int64_t qoff = static_cast<int64_t>(bq) * nz * plane;
  const Field f{q + qoff, ny, nx};
  const Field r{rho + cen, ny, nx};
  const Field u{fx + cen, ny, nx};
  const Field v{fy + cen, ny, nx};
  const Field w{fw + fac, ny, nx};

  float t = stencil::scalar_adv(f, r, u, v, w, dzc[k], nz, k, j, i, dx, dy);
  if (kdiff4 != 0.f) t = t + stencil::hyperdiff4(f, kdiff4, k, j, i);
  out[qoff + k * plane + static_cast<int64_t>(j) * nx + i] = t;
}

}  // namespace

extern "C" int adv_ud3_launch(const void* q, const void* rho, const void* fx,
                              const void* fy, const void* fw, const void* dzc,
                              void* out, int64_t B, int64_t nq, int64_t nz,
                              int64_t ny, int64_t nx, float dx, float dy,
                              float kdiff4, void* stream) {
  const int64_t tiles_x = (nx + stencil::TX - 1) / stencil::TX;
  const int64_t tiles_y = (ny + stencil::TY - 1) / stencil::TY;
  if (B < 1 || nq < 1 || nz < 2 || nx < 2 || ny < 2 ||
      tiles_x * tiles_y > 0x7fffffff || nz > 65535 || B * nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(stencil::TX, stencil::TY);
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y),
                  static_cast<unsigned>(nz), static_cast<unsigned>(B * nq));
  adv_ud3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(rho),
      static_cast<const float*>(fx), static_cast<const float*>(fy),
      static_cast<const float*>(fw), static_cast<const float*>(dzc),
      static_cast<float*>(out), static_cast<int>(nq), static_cast<int>(nz),
      static_cast<int>(ny), static_cast<int>(nx), static_cast<int>(tiles_x),
      dx, dy, kdiff4);
  return static_cast<int>(cudaGetLastError());
}
