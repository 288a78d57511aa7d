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
//     Mosaic artifacts and are gone (stencil.cuh has the halo).
// Vertical boundaries are kept exactly: centered ρθ faces next to the rigid
// boundaries, ρw zero at faces 0 and nz in input and output, the u/v
// vertical fluxes zero at those faces, and ρ at the boundary faces taken
// from the adjacent center.
//
// What bounds it: device memory. Per point it must read 6 fields and ρw and
// write 5 tendencies, ~48 bytes, against several hundred flops and ~25
// divisions, most by constants (stencil.cuh div_rcp); in practice
// instruction issue limits it well above that bound (PERF.md §6).
// Design (stencil.cuh): one CTA per (member, 32 × 8 tile) marches up the
// column; iteration k computes the centers of level k and
// the z-face k below them. The six input planes of each level (ρ, ρu, ρv,
// ρw at face k, ρθ, p′) sit with their 2-cell halo (periodic or
// edge-clamped, stencil.cuh) in a ring of 4
// level slots in shared memory: levels k−1, k, k+1 are read, level k+2
// arrives by cp.async meanwhile. Derived values are computed once per
// point into shared planes — φ = ρθ/ρ, u and v at their faces, w at face
// k, the mass-flux divergence, and the Laplacians of ρθ, ρu, ρv, ρw — and
// the taps read those. The thread's own column carries φ(k−2 … k+2) (φ(k+2)
// loaded two levels ahead), and u, v, w and the divergence of level k−1,
// in registers.
//
// C entry point (ctypes): dyn_tendency_launch(rho, rhou, rhov, rhow, rhot,
// p_pert, rho_ref, dzc, dzf, o_rho, o_rhou, o_rhov, o_rhow, o_rhot, B, nz,
// ny, nx, dx, dy, kdiff4, alpha_h, divdmp, dt, grav, open, stream) — open ≠
// 0: the lateral mode 'open' (edge-clamped x and y), else periodic; centered
// fields (B, nz, ny, nx), rhow and o_rhow (B, nz+1, ny, nx), rho_ref and dzc
// (nz,), dzf (nz−1,), float32, contiguous, on the device; alpha_h =
// divdmp·dx²/dt, divdmp ≤ 0 switches divergence damping off. Launches on
// `stream`, does not synchronise, and returns the launch's
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for sizes the
// grid cannot hold.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

using stencil::NT;
using stencil::PLANE;
using stencil::div_rcp;
using stencil::quot;
using stencil::Tile;
using stencil::W;

// fields of a ring slot, and its size
enum { RHO, RU, RV, RW, RT, PP, NFIELD };
constexpr int SLOT = NFIELD * PLANE;
constexpr int NSLOT = 4;
// derived planes: φ, the Laplacians of ρθ, ρu, ρv, ρw, u, v, w, divergence
enum { PHI, LT, LU, LV, LW, UF, VF, WF, DV, NDERIVED };
constexpr int SMEM_BYTES =
    (NSLOT * SLOT + NDERIVED * PLANE) * static_cast<int>(sizeof(float));

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

template <bool OPEN>
__global__ void __launch_bounds__(NT) dyn_tendency_kernel(const Args a) {
  extern __shared__ float smem[];
  float* ring = smem;                     // [level & 3][field][PLANE]
  float* der = smem + NSLOT * SLOT;       // [derived][PLANE]
  float* phi = der + PHI * PLANE;
  float* uf = der + UF * PLANE;
  float* vf = der + VF * PLANE;
  float* wf = der + WF * PLANE;
  float* divp = der + DV * PLANE;

  const int nz = a.nz;
  const Tile t(blockIdx.x, a.tiles_x, a.ny, a.nx, OPEN);
  const stencil::Nbr<OPEN> n(t, a.ny, a.nx);
  const int64_t plane = static_cast<int64_t>(a.ny) * a.nx;
  const int64_t cen = static_cast<int64_t>(blockIdx.y) * nz * plane;
  const int64_t fac = static_cast<int64_t>(blockIdx.y) * (nz + 1) * plane;
  const float dx = a.dx, dy = a.dy, rdx = 1.f / dx, rdy = 1.f / dy;
  const bool damp = a.divdmp > 0.f;
  const bool diffuse = a.kdiff4 != 0.f;
  const int c = t.c;

  auto slot = [&](int L) { return ring + (L & (NSLOT - 1)) * SLOT; };
  auto prefetch = [&](int L) {  // level L's planes (ρw alone at L = nz)
    float* s = slot(L);
    const int64_t o = cen + L * plane;
    if (L < nz) {
      t.load(s + RHO * PLANE, a.rho + o);
      t.load(s + RU * PLANE, a.rhou + o);
      t.load(s + RV * PLANE, a.rhov + o);
      t.load(s + RT * PLANE, a.rhot + o);
      t.load(s + PP * PLANE, a.pp + o);
    }
    t.load(s + RW * PLANE, a.rhow + fac + L * plane);
    __pipeline_commit();
  };
  auto phi_own = [&](int L) {
    return __ldg(a.rhot + cen + L * plane + t.own) /
           __ldg(a.rho + cen + L * plane + t.own);
  };

  prefetch(0);
  prefetch(1);
  // own column: φ(k−2 … k+1), and u, v, w and the divergence of level k−1
  float ph_m2 = 0.f, ph_m1 = 0.f, ph_0 = 0.f, ph_p1 = 0.f;
  if (t.active) {
    ph_0 = phi_own(0);
    ph_p1 = phi_own(1);
  }
  float uf_m1 = 0.f, vf_m1 = 0.f, wf_m1 = 0.f, dv_m1 = 0.f;

  for (int k = 0; k < nz; ++k) {
    const bool ahead = t.active && k + 2 < nz;
    float ta = 0.f, ra = 1.f;
    if (ahead) {
      ta = __ldg(a.rhot + cen + (k + 2) * plane + t.own);
      ra = __ldg(a.rho + cen + (k + 2) * plane + t.own);
    }
    const float dzc_k = a.dzc[k], rdzc_k = 1.f / dzc_k;
    __pipeline_wait_prior(0);
    __syncthreads();  // levels ≤ k+1 in; the previous iteration's reads done
    if (k + 2 <= nz) prefetch(k + 2);

    const float* s0 = slot(k);
    const float* sm = slot(k - 1);  // level k−1 (read only for k ≥ 1)
    const float* sp = slot(k + 1);  // level k+1 (ρw alone when k+1 = nz)
    const float* rho0 = s0 + RHO * PLANE;
    const float* ru0 = s0 + RU * PLANE;
    const float* rv0 = s0 + RV * PLANE;
    const float* rw0 = s0 + RW * PLANE;
    const float* rwp = sp + RW * PLANE;

    stencil::for_region(t.tid, 0, [&](int s) {
      phi[s] = s0[RT * PLANE + s] / rho0[s];
    });
    stencil::for_region(t.tid, 1, [&](int s) {
      uf[s] = quot(ru0[s], 0.5f * (rho0[s] + rho0[s + 1]));
      vf[s] = quot(rv0[s], 0.5f * (rho0[s] + rho0[s + W]));
      if (k >= 1)
        wf[s] = quot(rw0[s], 0.5f * (rho0[s] + sm[RHO * PLANE + s]));
      divp[s] = div_rcp(ru0[s] - ru0[s - 1], dx, rdx) +
                div_rcp(rv0[s] - rv0[s - W], dy, rdy) +
                div_rcp(rwp[s] - rw0[s], dzc_k, rdzc_k);
      if (diffuse) {
        der[LT * PLANE + s] = stencil::lap(s0 + RT * PLANE, s);
        der[LU * PLANE + s] = stencil::lap(ru0, s);
        der[LV * PLANE + s] = stencil::lap(rv0, s);
        der[LW * PLANE + s] = stencil::lap(rw0, s);
      }
    });
    const float ph_p2 = ahead ? ta / ra : 0.f;
    __syncthreads();

    if (t.active) {
      const int64_t out = cen + k * plane + t.own;
      const float div0 = divp[c];
      a.o_rho[out] = -div0;
      float dth = stencil::scalar_adv(phi, ru0, rv0, c, n, ph_m2, ph_m1,
                                      ph_p1, ph_p2, rw0[c], rwp[c], dzc_k,
                                      rdzc_k, nz, k, dx, rdx, dy, rdy);
      if (diffuse)
        dth = dth + stencil::hyperdiff4(der + LT * PLANE, a.kdiff4, c, n);
      a.o_rhot[out] = dth;

      // ρu at x-face i+1/2: x-flux at centers, y-flux at corners, z-flux
      // at the face's z-faces (zero at the rigid faces). The flux at
      // centers takes u at (s, m), m the face below s: open, at i = 0 the
      // face below is the edge face itself (u's stencil is along x, so its
      // value beyond the left edge is not the clamped inputs')
      const bool top = k + 1 == nz;
      const float uf_p1 =
          top ? 0.f
              : sp[RU * PLANE + c] /
                    (0.5f * (sp[RHO * PLANE + c] + sp[RHO * PLANE + c + 1]));
      auto adv_u_x = [&](int s, int m) {  // center (k, j, ·) of index s
        const float f = 0.5f * (ru0[s] + ru0[m]);
        return f * 0.5f * (uf[s] + uf[m]);
      };
      auto adv_u_y = [&](int s) {  // corner (k, ·+1/2, i+1/2)
        const float f = 0.5f * (rv0[s] + rv0[s + 1]);
        return f * 0.5f * (uf[s] + uf[s + W]);
      };
      auto adv_u_z = [&](const float* rw, float u_hi, float u_lo) {
        const float f = 0.5f * (rw[c] + rw[c + 1]);
        return f * (0.5f * (u_hi + u_lo));
      };
      const float uz_p = top ? 0.f : adv_u_z(rwp, uf_p1, uf[c]);
      const float uz_m = k == 0 ? 0.f : adv_u_z(rw0, uf[c], uf_m1);
      float dadv_u = div_rcp(adv_u_x(c + n.xp, c + n.xp - 1) -
                                 adv_u_x(c, c - n.xm),
                             dx, rdx);
      dadv_u = dadv_u + div_rcp(adv_u_y(c) - adv_u_y(c - n.ym), dy, rdy);
      dadv_u = dadv_u + div_rcp(uz_p - uz_m, dzc_k, rdzc_k);
      const float* pp0 = s0 + PP * PLANE;
      const float dpx = div_rcp(pp0[c + 1] - pp0[c], dx, rdx);
      float du = -dadv_u - dpx;
      if (diffuse)
        du = du + stencil::hyperdiff4(der + LU * PLANE, a.kdiff4, c, n);

      // ρv, the mirror of ρu
      const float vf_p1 =
          top ? 0.f
              : sp[RV * PLANE + c] /
                    (0.5f * (sp[RHO * PLANE + c] + sp[RHO * PLANE + c + W]));
      auto adv_v_y = [&](int s, int m) {  // center (k, ·, i)
        const float f = 0.5f * (rv0[s] + rv0[m]);
        return f * 0.5f * (vf[s] + vf[m]);
      };
      auto adv_v_x = [&](int s) {  // corner (k, j+1/2, ·+1/2)
        const float f = 0.5f * (ru0[s] + ru0[s + W]);
        return f * 0.5f * (vf[s] + vf[s + 1]);
      };
      auto adv_v_z = [&](const float* rw, float v_hi, float v_lo) {
        const float f = 0.5f * (rw[c] + rw[c + W]);
        return f * (0.5f * (v_hi + v_lo));
      };
      const float vz_p = top ? 0.f : adv_v_z(rwp, vf_p1, vf[c]);
      const float vz_m = k == 0 ? 0.f : adv_v_z(rw0, vf[c], vf_m1);
      float dadv_v = div_rcp(adv_v_y(c + n.yp, c + n.yp - W) -
                                 adv_v_y(c, c - n.ym),
                             dy, rdy);
      dadv_v = dadv_v + div_rcp(adv_v_x(c) - adv_v_x(c - n.xm), dx, rdx);
      dadv_v = dadv_v + div_rcp(vz_p - vz_m, dzc_k, rdzc_k);
      const float dpy = div_rcp(pp0[c + W] - pp0[c], dy, rdy);
      float dv_ = -dadv_v - dpy;
      if (diffuse)
        dv_ = dv_ + stencil::hyperdiff4(der + LV * PLANE, a.kdiff4, c, n);

      // divergence damping (acoustic filter): ∂ρu/∂t += α ∂D/∂x
      if (damp) {
        du = du + div_rcp(a.alpha_h * (divp[c + n.xp] - div0), dx, rdx);
        dv_ = dv_ + div_rcp(a.alpha_h * (divp[c + n.yp] - div0), dy, rdy);
      }
      a.o_rhou[out] = du;
      a.o_rhov[out] = dv_;

      // ρw at face k: interior faces 1..nz-1, zero at the rigid faces
      float dw = 0.f;
      if (k >= 1) {
        const float dzf = a.dzf[k - 1], rdzf = 1.f / dzf;
        // w at face k+1 (ρ there from the adjacent center at face nz)
        const float rf_p1 = top ? rho0[c]
                                : 0.5f * (sp[RHO * PLANE + c] + rho0[c]);
        const float wf_p1 = quot(rwp[c], rf_p1);
        const float* rwm = sm + RW * PLANE;
        auto adv_w_z = [&](float rw_hi, float rw_lo, float w_hi,
                           float w_lo) {  // vertical flux at a center
          const float fw_c = 0.5f * (rw_hi + rw_lo);
          return fw_c * 0.5f * (w_hi + w_lo);
        };
        float dadv = div_rcp(adv_w_z(rwp[c], rw0[c], wf_p1, wf[c]) -
                                 adv_w_z(rw0[c], rwm[c], wf[c], wf_m1),
                             dzf, rdzf);
        const float* rum = sm + RU * PLANE;
        const float* rvm = sm + RV * PLANE;
        auto adv_w_x = [&](int s) {  // (face k, j, ·+1/2)
          const float f = 0.5f * (ru0[s] + rum[s]);
          return f * 0.5f * (wf[s] + wf[s + 1]);
        };
        dadv = dadv + div_rcp(adv_w_x(c) - adv_w_x(c - n.xm), dx, rdx);
        auto adv_w_y = [&](int s) {  // (face k, ·+1/2, i)
          const float f = 0.5f * (rv0[s] + rvm[s]);
          return f * 0.5f * (wf[s] + wf[s + W]);
        };
        dadv = dadv + div_rcp(adv_w_y(c) - adv_w_y(c - n.ym), dy, rdy);
        const float dpz = div_rcp(pp0[c] - sm[PP * PLANE + c], dzf, rdzf);
        const float rp_face = 0.5f * ((rho0[c] - a.rho_ref[k]) +
                                      (sm[RHO * PLANE + c] - a.rho_ref[k - 1]));
        const float buoy = -rp_face * a.grav;
        dw = -dadv - dpz + buoy;
        if (diffuse)
          dw = dw + stencil::hyperdiff4(der + LW * PLANE, a.kdiff4, c, n);
        if (damp) {
          const float alpha_z = a.divdmp * dzf * dzf / a.dt;
          dw = dw + div_rcp(alpha_z * (div0 - dv_m1), dzf, rdzf);
        }
      }
      a.o_rhow[fac + k * plane + t.own] = dw;
      if (top) a.o_rhow[fac + nz * plane + t.own] = 0.f;

      uf_m1 = uf[c];
      vf_m1 = vf[c];
      wf_m1 = k == 0 ? quot(rw0[c], rho0[c]) : wf[c];
      dv_m1 = div0;
    }
    ph_m2 = ph_m1;
    ph_m1 = ph_0;
    ph_0 = ph_p1;
    ph_p1 = ph_p2;
  }
}

}  // namespace

extern "C" int dyn_tendency_launch(
    const void* rho, const void* rhou, const void* rhov, const void* rhow,
    const void* rhot, const void* p_pert, const void* rho_ref,
    const void* dzc, const void* dzf, void* o_rho, void* o_rhou,
    void* o_rhov, void* o_rhow, void* o_rhot, int64_t B, int64_t nz,
    int64_t ny, int64_t nx, float dx, float dy, float kdiff4, float alpha_h,
    float divdmp, float dt, float grav, int open, void* stream) {
  const int64_t tiles_x = (nx + stencil::TX - 1) / stencil::TX;
  const int64_t tiles_y = (ny + stencil::TY - 1) / stencil::TY;
  if (B < 1 || nz < 2 || nx < 2 || ny < 2 || B > 65535 ||
      tiles_x * tiles_y > 0x7fffffff || ny * nx > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      open ? dyn_tendency_kernel<true> : dyn_tendency_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y),
                  static_cast<unsigned>(B));
  kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
