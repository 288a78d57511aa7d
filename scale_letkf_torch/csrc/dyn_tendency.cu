// Whole dynamics tendency of the compressible core in one pass: drho,
// drhou, drhov, drhow and drhot of dycore.tendencies for a batch of
// members — continuity, UD3 ρθ advection, 2nd-order staggered momentum
// advection, the pressure gradient of p′, buoyancy, ∇⁴ hyperdiffusion and
// divergence damping. p′ = p(ρθ, q) − p_ref comes in from the caller (one
// plain pass of pow; no stencil).
//
// Replaces the TPU kernel scale_letkf_tpu/ops/pallas_tendency.py
// _tendency_kernel (launched by dyn_tendencies_pallas). What it computes is
// the same; what differs:
//   - the vertical metric is per level: dzc (cell thickness, nz) divides
//     every flux divergence at centers, dzf (center spacing at the interior
//     faces, nz−1) divides the w advection, the vertical pressure gradient
//     and the vertical divergence damping, with α_z = divdmp·dzf²/dt per
//     face. The stretched levels of the shipped configurations run here;
//     the TPU kernel took a scalar dz;
//   - the TPU kernel's 8-row DMA halo, y-slab grid and sublane rolls are
//     Mosaic artifacts and are gone: x/y wrap by index arithmetic, the
//     composed stencil radius is 2 in x and y;
//   - the batch of members is the grid's z dimension.
// Vertical boundaries are kept exactly: centered ρθ faces next to the rigid
// boundaries, ρw zero at faces 0 and nz in input and output, the u/v
// vertical fluxes zero at those faces, and ρ at the boundary faces taken
// from the adjacent center.
//
// What bounds it: device memory. One thread per (member, level, y, x)
// computes all five outputs there (the thread of level nz only the top
// ρw face): 7 input fields read, 5 written, ~48 bytes of compulsory traffic
// per point against several hundred flops; the many overlapping neighbour
// reads go through L1/L2. Shared-memory tiles with a 2-cell halo, and a
// column walk that keeps the z neighbours in registers, are the next steps
// if the profile asks.
//
// C entry point (ctypes): dyn_tendency_launch(rho, rhou, rhov, rhow, rhot,
// p_pert, rho_ref, dzc, dzf, o_rho, o_rhou, o_rhov, o_rhow, o_rhot, B, nz,
// ny, nx, dx, dy, kdiff4, alpha_h, divdmp, dt, grav, stream) — centered
// fields (B, nz, ny, nx), rhow and o_rhow (B, nz+1, ny, nx), rho_ref and dzc
// (nz,), dzf (nz−1,), float32, contiguous, on the device; alpha_h =
// divdmp·dx²/dt, divdmp ≤ 0 switches divergence damping off. Launches on
// `stream`, does not synchronise, and returns the launch's
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for sizes the
// grid cannot hold.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using stencil::Field;

struct Args {
  const float* __restrict__ rho;
  const float* __restrict__ rhou;
  const float* __restrict__ rhov;
  const float* __restrict__ rhow;
  const float* __restrict__ rhot;
  const float* __restrict__ pp;
  const float* __restrict__ rho_ref;
  const float* __restrict__ dzc;
  const float* __restrict__ dzf;
  float* __restrict__ o_rho;
  float* __restrict__ o_rhou;
  float* __restrict__ o_rhov;
  float* __restrict__ o_rhow;
  float* __restrict__ o_rhot;
  int nz, ny, nx, tiles_x;
  float dx, dy, kdiff4, alpha_h, divdmp, dt, grav;
};

__global__ void dyn_tendency_kernel(const Args a) {
  const int tj = blockIdx.x / a.tiles_x;
  const int ti = blockIdx.x - tj * a.tiles_x;
  const int i = ti * stencil::TX + threadIdx.x;
  const int j = tj * stencil::TY + threadIdx.y;
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  if (i >= nx || j >= ny) return;
  const int kk = blockIdx.y;  // level 0..nz: center kk (< nz) and face kk
  const int b = blockIdx.z;

  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t cen = static_cast<int64_t>(b) * nz * plane;
  const int64_t fac = static_cast<int64_t>(b) * (nz + 1) * plane;
  const int64_t ij = static_cast<int64_t>(j) * nx + i;
  const Field rho{a.rho + cen, ny, nx};
  const Field rhou{a.rhou + cen, ny, nx};
  const Field rhov{a.rhov + cen, ny, nx};
  const Field rhow{a.rhow + fac, ny, nx};
  const Field rhot{a.rhot + cen, ny, nx};
  const Field pp{a.pp + cen, ny, nx};
  const float dx = a.dx, dy = a.dy;
  const bool damp = a.divdmp > 0.f;

  // mass-flux divergence at center k
  auto div = [&](int k, int jj, int ii) {
    return (rhou(k, jj, ii) - rhou(k, jj, ii - 1)) / dx +
           (rhov(k, jj, ii) - rhov(k, jj - 1, ii)) / dy +
           (rhow(k + 1, jj, ii) - rhow(k, jj, ii)) / a.dzc[k];
  };

  // ---- ρw at face kk: interior faces 1..nz-1, zero at the rigid faces
  float dw = 0.f;
  if (kk >= 1 && kk <= nz - 1) {
    const int kf = kk;
    const float dzf = a.dzf[kf - 1];
    // ρ at face kf' (boundary faces take the adjacent center), w = ρw/ρ
    auto w_full = [&](int kf2, int jj, int ii) {
      const float rf =
          kf2 == 0 ? rho(0, jj, ii)
                   : kf2 == nz ? rho(nz - 1, jj, ii)
                               : 0.5f * (rho(kf2, jj, ii) + rho(kf2 - 1, jj, ii));
      return rhow(kf2, jj, ii) / rf;
    };
    // vertical flux of ρw at center kc
    auto adv_w_z = [&](int kc) {
      const float fw_c = 0.5f * (rhow(kc + 1, j, i) + rhow(kc, j, i));
      return fw_c * 0.5f * (w_full(kc + 1, j, i) + w_full(kc, j, i));
    };
    float dadv = (adv_w_z(kf) - adv_w_z(kf - 1)) / dzf;
    auto adv_w_x = [&](int ii) {  // at (face kf, j, ii+1/2)
      const float f = 0.5f * (rhou(kf, j, ii) + rhou(kf - 1, j, ii));
      return f * 0.5f * (w_full(kf, j, ii) + w_full(kf, j, ii + 1));
    };
    dadv = dadv + (adv_w_x(i) - adv_w_x(i - 1)) / dx;
    auto adv_w_y = [&](int jj) {  // at (face kf, jj+1/2, i)
      const float f = 0.5f * (rhov(kf, jj, i) + rhov(kf - 1, jj, i));
      return f * 0.5f * (w_full(kf, jj, i) + w_full(kf, jj + 1, i));
    };
    dadv = dadv + (adv_w_y(j) - adv_w_y(j - 1)) / dy;
    const float dpz = (pp(kf, j, i) - pp(kf - 1, j, i)) / dzf;
    const float rp_face = 0.5f * ((rho(kf, j, i) - a.rho_ref[kf]) +
                                  (rho(kf - 1, j, i) - a.rho_ref[kf - 1]));
    const float buoy = -rp_face * a.grav;
    dw = -dadv - dpz + buoy + stencil::hyperdiff4(rhow, a.kdiff4, kf, j, i);
    if (damp) {
      const float alpha_z = a.divdmp * dzf * dzf / a.dt;
      dw = dw + alpha_z * (div(kf, j, i) - div(kf - 1, j, i)) / dzf;
    }
  }
  a.o_rhow[fac + kk * plane + ij] = dw;
  if (kk == nz) return;

  // ---- center k: continuity, ρθ, ρu at x-face i+1/2, ρv at y-face j+1/2
  const int k = kk;
  const float dzc = a.dzc[k];
  const float div0 = div(k, j, i);
  const int64_t out = cen + k * plane + ij;
  a.o_rho[out] = -div0;
  a.o_rhot[out] =
      stencil::scalar_adv(rhot, rho, rhou, rhov, rhow, dzc, nz, k, j, i, dx,
                          dy) +
      stencil::hyperdiff4(rhot, a.kdiff4, k, j, i);

  // u at x-faces and v at y-faces of level k2
  auto u_face = [&](int k2, int jj, int ii) {
    return rhou(k2, jj, ii) / (0.5f * (rho(k2, jj, ii) + rho(k2, jj, ii + 1)));
  };
  auto v_face = [&](int k2, int jj, int ii) {
    return rhov(k2, jj, ii) / (0.5f * (rho(k2, jj, ii) + rho(k2, jj + 1, ii)));
  };

  // ρu: x-flux at centers, y-flux at corners, z-flux at the face's z-faces
  auto adv_u_x = [&](int ii) {  // center (k, j, ii)
    const float f = 0.5f * (rhou(k, j, ii) + rhou(k, j, ii - 1));
    return f * 0.5f * (u_face(k, j, ii) + u_face(k, j, ii - 1));
  };
  auto adv_u_y = [&](int jj) {  // corner (k, jj+1/2, i+1/2)
    const float f = 0.5f * (rhov(k, jj, i) + rhov(k, jj, i + 1));
    return f * 0.5f * (u_face(k, jj, i) + u_face(k, jj + 1, i));
  };
  auto adv_u_z = [&](int kf) {  // z-face kf of the x-face (j, i+1/2)
    if (kf == 0 || kf == nz) return 0.f;
    const float f = 0.5f * (rhow(kf, j, i) + rhow(kf, j, i + 1));
    return f * (0.5f * (u_face(kf, j, i) + u_face(kf - 1, j, i)));
  };
  float dadv_u = (adv_u_x(i + 1) - adv_u_x(i)) / dx;
  dadv_u = dadv_u + (adv_u_y(j) - adv_u_y(j - 1)) / dy;
  dadv_u = dadv_u + (adv_u_z(k + 1) - adv_u_z(k)) / dzc;
  const float dpx = (pp(k, j, i + 1) - pp(k, j, i)) / dx;
  float du = -dadv_u - dpx + stencil::hyperdiff4(rhou, a.kdiff4, k, j, i);

  // ρv, the mirror of ρu
  auto adv_v_y = [&](int jj) {  // center (k, jj, i)
    const float f = 0.5f * (rhov(k, jj, i) + rhov(k, jj - 1, i));
    return f * 0.5f * (v_face(k, jj, i) + v_face(k, jj - 1, i));
  };
  auto adv_v_x = [&](int ii) {  // corner (k, j+1/2, ii+1/2)
    const float f = 0.5f * (rhou(k, j, ii) + rhou(k, j + 1, ii));
    return f * 0.5f * (v_face(k, j, ii) + v_face(k, j, ii + 1));
  };
  auto adv_v_z = [&](int kf) {  // z-face kf of the y-face (j+1/2, i)
    if (kf == 0 || kf == nz) return 0.f;
    const float f = 0.5f * (rhow(kf, j, i) + rhow(kf, j + 1, i));
    return f * (0.5f * (v_face(kf, j, i) + v_face(kf - 1, j, i)));
  };
  float dadv_v = (adv_v_y(j + 1) - adv_v_y(j)) / dy;
  dadv_v = dadv_v + (adv_v_x(i) - adv_v_x(i - 1)) / dx;
  dadv_v = dadv_v + (adv_v_z(k + 1) - adv_v_z(k)) / dzc;
  const float dpy = (pp(k, j + 1, i) - pp(k, j, i)) / dy;
  float dv = -dadv_v - dpy + stencil::hyperdiff4(rhov, a.kdiff4, k, j, i);

  // divergence damping (acoustic filter): ∂ρu/∂t += α ∂D/∂x, D = ∇·(ρu)
  if (damp) {
    du = du + a.alpha_h * (div(k, j, i + 1) - div0) / dx;
    dv = dv + a.alpha_h * (div(k, j + 1, i) - div0) / dy;
  }
  a.o_rhou[out] = du;
  a.o_rhov[out] = dv;
}

}  // namespace

extern "C" int dyn_tendency_launch(
    const void* rho, const void* rhou, const void* rhov, const void* rhow,
    const void* rhot, const void* p_pert, const void* rho_ref,
    const void* dzc, const void* dzf, void* o_rho, void* o_rhou,
    void* o_rhov, void* o_rhow, void* o_rhot, int64_t B, int64_t nz,
    int64_t ny, int64_t nx, float dx, float dy, float kdiff4, float alpha_h,
    float divdmp, float dt, float grav, void* stream) {
  const int64_t tiles_x = (nx + stencil::TX - 1) / stencil::TX;
  const int64_t tiles_y = (ny + stencil::TY - 1) / stencil::TY;
  if (B < 1 || nz < 2 || nx < 2 || ny < 2 ||
      tiles_x * tiles_y > 0x7fffffff || nz + 1 > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(rho),    static_cast<const float*>(rhou),
         static_cast<const float*>(rhov),   static_cast<const float*>(rhow),
         static_cast<const float*>(rhot),   static_cast<const float*>(p_pert),
         static_cast<const float*>(rho_ref), static_cast<const float*>(dzc),
         static_cast<const float*>(dzf),    static_cast<float*>(o_rho),
         static_cast<float*>(o_rhou),       static_cast<float*>(o_rhov),
         static_cast<float*>(o_rhow),       static_cast<float*>(o_rhot),
         static_cast<int>(nz),              static_cast<int>(ny),
         static_cast<int>(nx),              static_cast<int>(tiles_x),
         dx, dy, kdiff4, alpha_h, divdmp, dt, grav};
  const dim3 block(stencil::TX, stencil::TY);
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y),
                  static_cast<unsigned>(nz + 1), static_cast<unsigned>(B));
  dyn_tendency_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
