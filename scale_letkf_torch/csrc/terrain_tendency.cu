// The terrain-following slow tendency of the compressible core for a batch
// of members: model/terrain.py tendencies_terrain — the J-weighted face
// fluxes and the contravariant J·ρW, continuity, UD3 advection and ∇⁴ of ρθ
// and the tracers, the metric-consistent centred momentum advection, the
// pressure gradient of p′ with its −(G/J)·∂p′/∂ζ correction, buoyancy, ∇⁴
// of the momenta and divergence damping — in two launches: the dynamics
// (ρ, ρu, ρv, ρw) and the scalars (ρθ and the NQ tracers).
//
// Replaces no TPU kernel: scale_letkf_tpu/model/terrain.py's tendency is
// plain XLA. Added because the plain PyTorch tendency, ~190 full-field
// passes a call, took 77% of the 18-km forecast over terrain (PERF.md §5);
// kernels #2 and #3 carry the flat metric only.
//
// What bounds it: device memory. A call reads ρ, ρu, ρv, ρw, ρθ, the NQ
// tracers and the moist pressure p, and writes the 5 + NQ tendencies: 23
// float32 fields a member at NQ = 6, ~92 bytes a point (5.7 GB at 10 × 36 ×
// 360 × 480, 1.7 ms at 3.35 TB/s). The metrics (J, Gx, Gy at centres and
// z-faces) are member-independent: a block walks the members of the batch
// with its tile fixed, so it reads a metric plane once for all of them.
//
// Design (stencil.cuh): a block holds one level k of a 32 × 8 tile, the
// levels of a tile neighbouring blocks so the planes above and below come
// from L2. For each member the input planes come into shared memory with
// their 2-cell halo (Tile: periodic wraps, open clamps to the edge cell);
// every derived quantity — the face mass fluxes J·ρu, J·ρv, the
// contravariant J·ρW, φ = ρq/ρ, the face velocities, ∂p′/∂ζ, the inner
// Laplacian of ∇⁴, the divergence, the UD3 face fluxes — is computed once a
// point into shared planes over the tile and the part of its ring it is
// read at, and each thread combines them at its own point. A derived field
// is read at in-domain points only: across an open edge through Nbr
// (offset 0), since the plain path rolls derived fields too and so clamps
// their values, not their inputs. What only the thread's own column needs
// (φ at k ± 1, k ± 2; J·ρW, ρw and ρ at level k − 1 or k − 2) it reads
// itself.
//
// Arithmetic: the plain PyTorch path's on the card, operation for operation
// and in its order (the additions of each `+=` chain, `0.5 * (a + b)`, the
// Laplacian's four neighbours then −4·g), so that the two agree bit for
// bit. A Python-float scalar is rounded to float32 as PyTorch rounds it; a
// division by a Python float (dx, dy, 6, dt) is PyTorch's CUDA division by
// a CPU scalar: the product with the float32 reciprocal; a division by a
// tensor (ρ, J, dzc, dzf) is IEEE division (stencil.cuh quot). The library
// is built with -fmad=false (utils/kernels.py): no product is fused into a
// sum.
//
// C entry point (ctypes): terrain_tendency_launch(rho, rhou, rhov, rhow,
// rhot, rhoq, p, p_ref, rho_ref, jac, gx, gy, gx_zf, gy_zf, dzc, dzf, o_rho,
// o_rhou, o_rhov, o_rhow, o_rhot, o_rhoq, B, nq, nz, ny, nx, inv_dx,
// inv_dy, kdiff4, alpha_h, divdmp, inv_dt, grav, damp, open, stream).
// Centred fields and p (B, nz, ny, nx), ρw (B, nz+1, ny, nx), ρq (B, nq, nz,
// ny, nx), the outputs likewise; p_ref, rho_ref, dzc (nz,), dzf (nz−1,); jac
// (ny, nx), gx, gy (nz, ny, nx), gx_zf, gy_zf (nz+1, ny, nx); float32,
// contiguous, on the device, no output aliasing an input. inv_dx, inv_dy,
// inv_dt: the float32 reciprocals of dx, dy, dt; alpha_h = divdmp·dx²/dt;
// damp ≠ 0: divergence damping (divdmp > 0); open ≠ 0: the lateral mode
// 'open', else periodic. Launches on `stream`, does not synchronise, and
// returns the launches' cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes it does not take (nz, ny or nx below 2, a
// member of 2**31 points or more, or a grid it cannot hold).

#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace {

using stencil::PLANE;
using stencil::quot;
using stencil::Tile;
using stencil::W;
using stencil::NT;
using stencil::TX;
using stencil::TY;

// PyTorch's float32 reciprocal of the Python 6.0 the UD3 faces divide by
constexpr float R6 = 1.f / 6.f;

struct Args {
  const float* __restrict__ rho;
  const float* __restrict__ rhou;
  const float* __restrict__ rhov;
  const float* __restrict__ rhow;
  const float* __restrict__ rhot;
  const float* __restrict__ rhoq;
  const float* __restrict__ p;
  const float* __restrict__ p_ref;
  const float* __restrict__ rho_ref;
  const float* __restrict__ jac;
  const float* __restrict__ gx;
  const float* __restrict__ gy;
  const float* __restrict__ gx_zf;
  const float* __restrict__ gy_zf;
  const float* __restrict__ dzc;
  const float* __restrict__ dzf;
  float* __restrict__ o_rho;
  float* __restrict__ o_rhou;
  float* __restrict__ o_rhov;
  float* __restrict__ o_rhow;
  float* __restrict__ o_rhot;
  float* __restrict__ o_rhoq;
  int B, nq, nz, ny, nx, tiles_x;
  float inv_dx, inv_dy, kdiff4, alpha_h, divdmp, inv_dt, grav;
  int damp;
};

// UD3 face values (ud3_face_x/y/z): upwind (flux ≥ 0) from fm1, f0, fp1;
// downwind from f0, fp1, fp2
__device__ __forceinline__ float ud3_pos(float fm1, float f0, float fp1) {
  return (2.f * fp1 + 5.f * f0 - fm1) * R6;
}
__device__ __forceinline__ float ud3_neg(float f0, float fp1, float fp2) {
  return (2.f * f0 + 5.f * fp1 - fp2) * R6;
}

// One member's fields and the index maps. Every function takes a point
// whose j, i are already mapped into the domain.
template <bool OPEN>
struct Member {
  int nz, ny, nx;
  const float* rho;
  const float* rhou;
  const float* rhov;
  const float* rhow;
  const float* p;
  const float* jac_;
  const float* gx_zf;
  const float* gy_zf;
  const float* dzc_;

  __device__ __forceinline__ Member(const Args& a, int b)
      : nz(a.nz), ny(a.ny), nx(a.nx), jac_(a.jac), gx_zf(a.gx_zf),
        gy_zf(a.gy_zf), dzc_(a.dzc) {
    const int64_t plane = static_cast<int64_t>(ny) * nx;
    const int64_t cen = static_cast<int64_t>(b) * nz * plane;
    rho = a.rho + cen;
    rhou = a.rhou + cen;
    rhov = a.rhov + cen;
    rhow = a.rhow + cen + b * plane;
    p = a.p + cen;
  }

  // the column i+n and the row j+n: wrapped when periodic (|n| ≤ nx),
  // clamped to the edge when open
  __device__ __forceinline__ int X(int r) const {
    if (OPEN) return stencil::clamp_idx(r, nx);
    return r < 0 ? r + nx : (r >= nx ? r - nx : r);
  }
  __device__ __forceinline__ int Y(int r) const {
    if (OPEN) return stencil::clamp_idx(r, ny);
    return r < 0 ? r + ny : (r >= ny ? r - ny : r);
  }

  __device__ __forceinline__ float ld(const float* f, int k, int j,
                                      int i) const {
    return __ldg(f + (k * ny + j) * nx + i);
  }
  __device__ __forceinline__ float dzc(int k) const {
    return __ldg(dzc_ + k);
  }

  // metrics: J, J at the x- and y-faces
  __device__ __forceinline__ float jac(int j, int i) const {
    return __ldg(jac_ + j * nx + i);
  }
  __device__ __forceinline__ float jxf(int j, int i) const {
    return 0.5f * (jac(j, i) + jac(j, X(i + 1)));
  }
  __device__ __forceinline__ float jyf(int j, int i) const {
    return 0.5f * (jac(j, i) + jac(Y(j + 1), i));
  }

  // the horizontal mass fluxes J·ρu, J·ρv at their faces
  __device__ __forceinline__ float fx(int k, int j, int i) const {
    return jxf(j, i) * ld(rhou, k, j, i);
  }
  __device__ __forceinline__ float fy(int k, int j, int i) const {
    return jyf(j, i) * ld(rhov, k, j, i);
  }

  // J·ρW at z-face kf (contravariant_w · J), zero at the rigid faces
  __device__ __forceinline__ float rgw(int kf, int j, int i) const {
    if (kf == 0 || kf == nz) return 0.f;
    const int xm = X(i - 1), ym = Y(j - 1);
    const float ru_hi = 0.5f * (ld(rhou, kf, j, i) + ld(rhou, kf, j, xm));
    const float ru_lo =
        0.5f * (ld(rhou, kf - 1, j, i) + ld(rhou, kf - 1, j, xm));
    const float rv_hi = 0.5f * (ld(rhov, kf, j, i) + ld(rhov, kf, ym, i));
    const float rv_lo =
        0.5f * (ld(rhov, kf - 1, j, i) + ld(rhov, kf - 1, ym, i));
    const float gxc = 0.5f * (ld(gx_zf, kf, j, i) + ld(gx_zf, kf, j, xm));
    const float gyc = 0.5f * (ld(gy_zf, kf, j, i) + ld(gy_zf, kf, ym, i));
    const float jc = jac(j, i);
    const float gw = quot(ld(rhow, kf, j, i) - gxc * (0.5f * (ru_hi + ru_lo)) -
                              gyc * (0.5f * (rv_hi + rv_lo)),
                          jc);
    return gw * jc;
  }
};

// The dynamics. A block holds one level k of a tile and walks the members.
// For each, the input planes it needs come into shared memory with their
// halo (stencil.cuh Tile): ρ, ρu, ρv and p at levels k−1, k, k+1 and ρw at
// faces k and k+1; the metric planes (J, Gx and Gy at faces k and k+1) once
// for all members. The derived quantities are computed once a point into
// shared planes over the tile and the part of its ring they are read at —
// J·ρu and J·ρv at levels k and k−1, u and v at their faces, w at face k,
// J·ρW at faces k and k+1, ∂p′/∂ζ, the Laplacians of ρu, ρv and ρw, then
// the divergence — and each thread combines them at its point. A derived
// plane is read at an in-domain point only: across an open edge through
// Nbr (offset 0), as the plain path's roll of a derived field clamps it.
enum {
  // member planes
  R0, RM, RP, U0, UM, UP, V0, VM, VP, W0, WP, P0, PM, PP,
  // metric planes
  JC, GX0, GX1, GY0, GY1,
  // derived planes
  FX0, FY0, FXM, FYM, UF0, VF0, WF0, RG0, RG1, DP0, DV0, LU, LV, LW, NPLANE
};
constexpr int DYN_SMEM = NPLANE * PLANE * static_cast<int>(sizeof(float));

// Calls f(s, x, y) for every plane index s of the tile's points with local
// column x in [x0, x1] and row y in [y0, y1] (the tile's own points are 0 …
// TX−1, 0 … TY−1; the halo reaches HALO beyond), spread over the threads.
template <class F>
__device__ __forceinline__ void for_rect(int tid, int x0, int x1, int y0,
                                         int y1, F&& f) {
  const int w = x1 - x0 + 1, n = w * (y1 - y0 + 1);
  for (int r = tid; r < n; r += NT) {
    const int y = r / w + y0, x = r - (r / w) * w + x0;
    f((y + stencil::HALO) * W + x + stencil::HALO, x, y);
  }
}

template <bool OPEN>
__global__ void __launch_bounds__(NT) terrain_dyn_kernel(const Args a) {
  extern __shared__ float smem[];
  auto P = [&](int q) { return smem + q * PLANE; };
  const int tile = blockIdx.x / a.nz;
  const int k = blockIdx.x - tile * a.nz, nz = a.nz;
  const Tile t(tile, a.tiles_x, a.ny, a.nx, OPEN);
  const stencil::Nbr<OPEN> n(t, a.ny, a.nx);
  const int j = t.j, i = t.i, c = t.c;
  // the tile's origin, for the open edges of the divergence's points
  const int ty0 = j - t.ly, tx0 = i - t.lx;
  const int64_t plane = static_cast<int64_t>(a.ny) * a.nx;
  const bool lo = k > 0, hi = k + 1 < nz;
  const float dzc_k = __ldg(a.dzc + k);

  t.load(P(JC), a.jac);
  t.load(P(GX0), a.gx_zf + k * plane);
  t.load(P(GY0), a.gy_zf + k * plane);
  t.load(P(GX1), a.gx_zf + (k + 1) * plane);
  t.load(P(GY1), a.gy_zf + (k + 1) * plane);
  for (int b = 0; b < a.B; ++b) {
    const Member<OPEN> m(a, b);
    __syncthreads();  // the last member's reads done
    auto level = [&](int q, const float* f, int kk) {
      t.load(P(q), f + kk * plane);
    };
    level(R0, m.rho, k);
    level(U0, m.rhou, k);
    level(V0, m.rhov, k);
    level(P0, m.p, k);
    level(W0, m.rhow, k);
    level(WP, m.rhow, k + 1);
    if (lo) {
      level(RM, m.rho, k - 1);
      level(UM, m.rhou, k - 1);
      level(VM, m.rhov, k - 1);
      level(PM, m.p, k - 1);
    }
    if (hi) {
      level(RP, m.rho, k + 1);
      level(UP, m.rhou, k + 1);
      level(VP, m.rhov, k + 1);
      level(PP, m.p, k + 1);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const float* jc = P(JC);
    auto pp = [&](int q, int kk, int s) {  // p′ at level kk from plane q
      return P(q)[s] - __ldg(a.p_ref + kk);
    };
    // the horizontal mass fluxes at levels k and k−1
    for_rect(t.tid, -1, TX, 0, TY, [&](int s, int, int) {
      P(FX0)[s] = (0.5f * (jc[s] + jc[s + 1])) * P(U0)[s];
    });
    for_rect(t.tid, 0, TX, -1, TY, [&](int s, int, int) {
      P(FY0)[s] = (0.5f * (jc[s] + jc[s + W])) * P(V0)[s];
    });
    if (lo) {
      for_rect(t.tid, -1, TX - 1, 0, TY - 1, [&](int s, int, int) {
        P(FXM)[s] = (0.5f * (jc[s] + jc[s + 1])) * P(UM)[s];
      });
      for_rect(t.tid, 0, TX - 1, -1, TY - 1, [&](int s, int, int) {
        P(FYM)[s] = (0.5f * (jc[s] + jc[s + W])) * P(VM)[s];
      });
    }
    // face velocities, the Laplacians of the momenta
    for_rect(t.tid, -1, TX, -1, TY, [&](int s, int, int) {
      const float* r = P(R0);
      P(UF0)[s] = quot(P(U0)[s], 0.5f * (r[s] + r[s + 1]));
      P(VF0)[s] = quot(P(V0)[s], 0.5f * (r[s] + r[s + W]));
      if (lo) P(WF0)[s] = quot(P(W0)[s], 0.5f * (r[s] + P(RM)[s]));
      P(LU)[s] = stencil::lap(P(U0), s);
      P(LV)[s] = stencil::lap(P(V0), s);
      P(LW)[s] = stencil::lap(P(W0), s);
    });
    // J·ρW at faces k and k+1 (zero at the rigid faces), ∂p′/∂ζ
    auto rgw = [&](int s, int qu_hi, int qu_lo, int qv_hi, int qv_lo,
                   int qw, int qgx, int qgy) {
      const float* uh = P(qu_hi);
      const float* ul = P(qu_lo);
      const float* vh = P(qv_hi);
      const float* vl = P(qv_lo);
      const float ru_hi = 0.5f * (uh[s] + uh[s - 1]);
      const float ru_lo = 0.5f * (ul[s] + ul[s - 1]);
      const float rv_hi = 0.5f * (vh[s] + vh[s - W]);
      const float rv_lo = 0.5f * (vl[s] + vl[s - W]);
      const float gxc = 0.5f * (P(qgx)[s] + P(qgx)[s - 1]);
      const float gyc = 0.5f * (P(qgy)[s] + P(qgy)[s - W]);
      const float gw = quot(P(qw)[s] - gxc * (0.5f * (ru_hi + ru_lo)) -
                                gyc * (0.5f * (rv_hi + rv_lo)),
                            jc[s]);
      return gw * jc[s];
    };
    for_rect(t.tid, 0, TX, 0, TY, [&](int s, int, int) {
      P(RG0)[s] = lo ? rgw(s, U0, UM, V0, VM, W0, GX0, GY0) : 0.f;
      P(RG1)[s] = hi ? rgw(s, UP, U0, VP, V0, WP, GX1, GY1) : 0.f;
      float d;
      if (!lo)
        d = quot(pp(PP, 1, s) - pp(P0, 0, s), __ldg(a.dzf));
      else if (!hi)
        d = quot(pp(P0, k, s) - pp(PM, k - 1, s), __ldg(a.dzf + k - 1));
      else
        d = quot(pp(PP, k + 1, s) - pp(PM, k - 1, s),
                 __ldg(a.dzf + k) + __ldg(a.dzf + k - 1));
      P(DP0)[s] = d;
    });
    __syncthreads();
    // the divergence at the tile's points and their east and north
    // neighbours (at a point on an open west or south edge the face
    // below is the point's own)
    for_rect(t.tid, 0, TX, 0, TY, [&](int s, int x, int y) {
      const int xm = OPEN && tx0 + x == 0 ? 0 : 1;
      const int ym = OPEN && ty0 + y == 0 ? 0 : W;
      float acc = (P(FX0)[s] - P(FX0)[s - xm]) * a.inv_dx;
      acc = acc + (P(FY0)[s] - P(FY0)[s - ym]) * a.inv_dy;
      acc = acc + quot(P(RG1)[s] - P(RG0)[s], dzc_k);
      P(DV0)[s] = quot(acc, jc[s]);
    });
    __syncthreads();
    if (!t.active) continue;

    const float* fx = P(FX0);
    const float* fy = P(FY0);
    const float* uf = P(UF0);
    const float* vf = P(VF0);
    const float* rg0 = P(RG0);
    const float* rg1 = P(RG1);
    const float* dv = P(DV0);
    const float* dp = P(DP0);
    const int64_t cen = (static_cast<int64_t>(b) * nz + k) * plane + t.own;
    const int64_t fac = (static_cast<int64_t>(b) * (nz + 1) + k) * plane + t.own;
    const float div0 = dv[c];
    a.o_rho[cen] = -div0;

    // ρu at x-face i+1/2
    {
      auto adv_x = [&](int s, int sm) {  // centre (k, j, ·) of index s
        return (0.5f * (fx[s] + fx[sm])) * (0.5f * (uf[s] + uf[sm]));
      };
      auto adv_y = [&](int s) {  // corner (k, ·+1/2, i+1/2) of row s
        return (0.5f * (fy[s] + fy[s + n.xp])) * (0.5f * (uf[s] + uf[s + W]));
      };
      // u at the z-faces k and k+1 (zero flux at the rigid faces)
      float adv_hi = 0.f, adv_lo = 0.f;
      if (hi) {
        const float uf_p = quot(P(UP)[c], 0.5f * (P(RP)[c] + P(RP)[c + 1]));
        adv_hi = (0.5f * (rg1[c] + rg1[c + n.xp])) * (0.5f * (uf_p + uf[c]));
      }
      if (lo) {
        const float uf_m = quot(P(UM)[c], 0.5f * (P(RM)[c] + P(RM)[c + 1]));
        adv_lo = (0.5f * (rg0[c] + rg0[c + n.xp])) * (0.5f * (uf[c] + uf_m));
      }
      // adv_y of the row below: its north neighbour is always its own +W
      const float adv_y_j = (0.5f * (fy[c] + fy[c + n.xp])) *
                            (0.5f * (uf[c] + uf[c + n.yp]));
      float dadv =
          (adv_x(c + n.xp, c + n.xp - 1) - adv_x(c, c - n.xm)) * a.inv_dx;
      dadv = dadv + (adv_y_j - adv_y(c - n.ym)) * a.inv_dy;
      dadv = dadv + quot(adv_hi - adv_lo, dzc_k);
      const float jx = 0.5f * (jc[c] + jc[c + 1]);
      dadv = quot(dadv, jx);
      const float dpx = (pp(P0, k, c + 1) - pp(P0, k, c)) * a.inv_dx -
                        quot(__ldg(a.gx + k * plane + t.own), jx) *
                            (0.5f * (dp[c] + dp[c + 1]));
      float du = (-dadv - dpx) + stencil::hyperdiff4(P(LU), a.kdiff4, c, n);
      if (a.damp)
        du = du + (a.alpha_h * (dv[c + n.xp] - div0)) * a.inv_dx;
      a.o_rhou[cen] = du;
    }

    // ρv at y-face j+1/2, the mirror of ρu
    {
      auto adv_y = [&](int s, int sm) {
        return (0.5f * (fy[s] + fy[sm])) * (0.5f * (vf[s] + vf[sm]));
      };
      auto adv_x = [&](int s) {  // corner (k, j+1/2, ·+1/2) of column s
        return (0.5f * (fx[s] + fx[s + n.yp])) * (0.5f * (vf[s] + vf[s + 1]));
      };
      float adv_hi = 0.f, adv_lo = 0.f;
      if (hi) {
        const float vf_p = quot(P(VP)[c], 0.5f * (P(RP)[c] + P(RP)[c + W]));
        adv_hi = (0.5f * (rg1[c] + rg1[c + n.yp])) * (0.5f * (vf_p + vf[c]));
      }
      if (lo) {
        const float vf_m = quot(P(VM)[c], 0.5f * (P(RM)[c] + P(RM)[c + W]));
        adv_lo = (0.5f * (rg0[c] + rg0[c + n.yp])) * (0.5f * (vf[c] + vf_m));
      }
      const float adv_x_i = (0.5f * (fx[c] + fx[c + n.yp])) *
                            (0.5f * (vf[c] + vf[c + n.xp]));
      float dadv =
          (adv_y(c + n.yp, c + n.yp - W) - adv_y(c, c - n.ym)) * a.inv_dy;
      dadv = dadv + (adv_x_i - adv_x(c - n.xm)) * a.inv_dx;
      dadv = dadv + quot(adv_hi - adv_lo, dzc_k);
      const float jy = 0.5f * (jc[c] + jc[c + W]);
      dadv = quot(dadv, jy);
      const float dpy = (pp(P0, k, c + W) - pp(P0, k, c)) * a.inv_dy -
                        quot(__ldg(a.gy + k * plane + t.own), jy) *
                            (0.5f * (dp[c] + dp[c + W]));
      float dv_ = (-dadv - dpy) + stencil::hyperdiff4(P(LV), a.kdiff4, c, n);
      if (a.damp)
        dv_ = dv_ + (a.alpha_h * (dv[c + n.yp] - div0)) * a.inv_dy;
      a.o_rhov[cen] = dv_;
    }

    // ρw at face k: interior faces 1 … nz−1, zero at the rigid faces
    float dw = 0.f;
    if (lo) {
      const float* wf = P(WF0);
      const float* fxm = P(FXM);
      const float* fym = P(FYM);
      const float dzf_k = __ldg(a.dzf + k - 1);
      // w at faces k+1 and k−1 of the column (ρ at the rigid faces from
      // the adjacent centre), J·ρW at face k−1
      const float rf_p = hi ? 0.5f * (P(RP)[c] + P(R0)[c]) : P(R0)[c];
      const float wf_p = quot(P(WP)[c], rf_p);
      const float rf_m = k == 1 ? P(RM)[c]
                                : 0.5f * (P(RM)[c] + m.ld(m.rho, k - 2, j, i));
      const float wf_m = quot(m.ld(m.rhow, k - 1, j, i), rf_m);
      const float rg_m = m.rgw(k - 1, j, i);
      const float adv_hi = (0.5f * (rg1[c] + rg0[c])) * (0.5f * (wf_p + wf[c]));
      const float adv_lo = (0.5f * (rg0[c] + rg_m)) * (0.5f * (wf[c] + wf_m));
      float dadv = quot(adv_hi - adv_lo, dzf_k);
      auto adv_x = [&](int s, int se) {  // (face k, j, ·+1/2) of column s
        return (0.5f * (fx[s] + fxm[s])) * (0.5f * (wf[s] + wf[se]));
      };
      auto adv_y = [&](int s, int sn) {  // (face k, ·+1/2, i) of row s
        return (0.5f * (fy[s] + fym[s])) * (0.5f * (wf[s] + wf[sn]));
      };
      dadv = dadv + (adv_x(c, c + n.xp) - adv_x(c - n.xm, c - n.xm + 1)) *
                        a.inv_dx;
      dadv = dadv + (adv_y(c, c + n.yp) - adv_y(c - n.ym, c - n.ym + W)) *
                        a.inv_dy;
      dadv = quot(dadv, jc[c]);
      const float dpz =
          quot(quot(pp(P0, k, c) - pp(PM, k - 1, c), dzf_k), jc[c]);
      const float rp_hi = P(R0)[c] - __ldg(a.rho_ref + k);
      const float rp_lo = P(RM)[c] - __ldg(a.rho_ref + k - 1);
      const float buoy = -(0.5f * (rp_hi + rp_lo)) * a.grav;
      dw = (-dadv - dpz) + buoy + stencil::hyperdiff4(P(LW), a.kdiff4, c, n);
      if (a.damp) {
        // the divergence at level k−1 of the column
        float acc = (fxm[c] - fxm[c - n.xm]) * a.inv_dx;
        acc = acc + (fym[c] - fym[c - n.ym]) * a.inv_dy;
        acc = acc + quot(rg0[c] - rg_m, __ldg(a.dzc + k - 1));
        const float div_m = quot(acc, jc[c]);
        const float alpha_z = a.divdmp * dzf_k * dzf_k * a.inv_dt;
        dw = dw + quot(alpha_z * (div0 - div_m), dzf_k);
      }
    }
    a.o_rhow[fac] = dw;
    if (!hi) a.o_rhow[fac + plane] = 0.f;
  }
}

// UD3 x-face value at the face right of plane index s (phi a shared plane
// of φ with its halo), chosen by the sign of the face flux w
__device__ __forceinline__ float face_x(const float* phi, int s, float w) {
  return w >= 0.f ? ud3_pos(phi[s - 1], phi[s], phi[s + 1])
                  : ud3_neg(phi[s], phi[s + 1], phi[s + 2]);
}
__device__ __forceinline__ float face_y(const float* phi, int s, float w) {
  return w >= 0.f ? ud3_pos(phi[s - W], phi[s], phi[s + W])
                  : ud3_neg(phi[s], phi[s + W], phi[s + 2 * W]);
}

// ρθ and the tracers. A block holds one level k of a tile and walks the
// members, and for each the scalars: the member's ρ plane at level k (once)
// and the scalar's come into shared memory with their halo (stencil.cuh
// Tile), φ = f/ρ and the inner Laplacian of ∇⁴ are computed once a point
// into shared planes, then each thread's x- and y-face fluxes (and the
// tile's west and south faces) into two more; the z-faces take φ of the
// thread's own column.
template <bool OPEN>
__global__ void __launch_bounds__(NT) terrain_scalar_kernel(const Args a) {
  __shared__ float sf[PLANE], sr[PLANE], sphi[PLANE], slap[PLANE];
  __shared__ float sflx[PLANE], sfly[PLANE];
  const int tile = blockIdx.x / a.nz;
  const int k = blockIdx.x - tile * a.nz, nz = a.nz;
  const Tile t(tile, a.tiles_x, a.ny, a.nx, OPEN);
  const stencil::Nbr<OPEN> n(t, a.ny, a.nx);
  const int j = t.j, i = t.i, c = t.c;
  const int64_t plane = static_cast<int64_t>(a.ny) * a.nx;
  const int64_t field = nz * plane;  // one member's (or tracer's) field
  const int64_t own = k * plane + t.own;
  for (int b = 0; b < a.B; ++b) {
    const Member<OPEN> m(a, b);
    // the member's mass fluxes through the thread's faces (the tile's
    // west and south faces too), shared by its scalars
    float fx = 0.f, fx_w = 0.f, fy = 0.f, fy_s = 0.f, w_lo = 0.f, w_hi = 0.f;
    float jc = 1.f;
    if (t.active) {
      fx = m.fx(k, j, i);
      fy = m.fy(k, j, i);
      if (t.lx == 0) fx_w = m.fx(k, j, m.X(i - 1));
      if (t.ly == 0) fy_s = m.fy(k, m.Y(j - 1), i);
      w_lo = m.rgw(k, j, i);
      w_hi = m.rgw(k + 1, j, i);
      jc = m.jac(j, i);
    }
    // ρ of the thread's column at k−2 … k+2 (k itself from the plane)
    float rc[5] = {1.f, 1.f, 1.f, 1.f, 1.f};
    if (t.active) {
#pragma unroll
      for (int d = -2; d <= 2; ++d)
        if (d != 0 && k + d >= 0 && k + d < nz)
          rc[d + 2] = m.ld(m.rho, k + d, j, i);
    }
    for (int q = -1; q < a.nq; ++q) {
      const float* f = q < 0 ? a.rhot + b * field
                             : a.rhoq + (static_cast<int64_t>(b) * a.nq + q) *
                                            field;
      t.load(sf, f + k * plane);
      if (q < 0) t.load(sr, m.rho + k * plane);  // once for its scalars
      __pipeline_commit();
      // φ of the thread's column at k−2 … k+2 (k itself from the plane)
      float ph[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (t.active) {
#pragma unroll
        for (int d = -2; d <= 2; ++d)
          if (d != 0 && k + d >= 0 && k + d < nz)
            ph[d + 2] = quot(m.ld(f, k + d, j, i), rc[d + 2]);
      }
      __pipeline_wait_prior(0);
      __syncthreads();  // the planes in; the last scalar's reads done
      stencil::for_region(t.tid, 0,
                          [&](int s) { sphi[s] = quot(sf[s], sr[s]); });
      stencil::for_region(t.tid, 1,
                          [&](int s) { slap[s] = stencil::lap(sf, s); });
      __syncthreads();
      if (t.active) {
        sflx[c] = fx * face_x(sphi, c, fx);
        if (t.lx == 0) sflx[c - 1] = fx_w * face_x(sphi, c - 1, fx_w);
        sfly[c] = fy * face_y(sphi, c, fy);
        if (t.ly == 0) sfly[c - W] = fy_s * face_y(sphi, c - W, fy_s);
      }
      __syncthreads();
      if (!t.active) continue;
      ph[2] = sphi[c];
      // the z-flux through face K (k or k+1): centred next to the rigid
      // faces, zero at them
      auto fl_z = [&](int K, float w, const float* p) {  // p[1] = φ(K−1)
        if (K == 0 || K == nz) return 0.f;
        const float face =
            K == 1 || K == nz - 1 ? 0.5f * (p[2] + p[1])
            : w >= 0.f            ? ud3_pos(p[0], p[1], p[2])
                                  : ud3_neg(p[1], p[2], p[3]);
        return w * face;
      };
      float acc = (sflx[c] - sflx[c - n.xm]) * a.inv_dx;
      acc = acc + (sfly[c] - sfly[c - n.ym]) * a.inv_dy;
      acc = acc + quot(fl_z(k + 1, w_hi, ph + 1) - fl_z(k, w_lo, ph),
                       m.dzc(k));
      acc = quot(acc, jc);
      const float out = stencil::hyperdiff4(slap, a.kdiff4, c, n) - acc;
      if (q < 0)
        a.o_rhot[b * field + own] = out;
      else
        a.o_rhoq[(static_cast<int64_t>(b) * a.nq + q) * field + own] = out;
    }
  }
}

}  // namespace

extern "C" int terrain_tendency_launch(
    const void* rho, const void* rhou, const void* rhov, const void* rhow,
    const void* rhot, const void* rhoq, const void* p, const void* p_ref,
    const void* rho_ref, const void* jac, const void* gx, const void* gy,
    const void* gx_zf, const void* gy_zf, const void* dzc, const void* dzf,
    void* o_rho, void* o_rhou, void* o_rhov, void* o_rhow, void* o_rhot,
    void* o_rhoq, int64_t B, int64_t nq, int64_t nz, int64_t ny, int64_t nx,
    float inv_dx, float inv_dy, float kdiff4, float alpha_h, float divdmp,
    float inv_dt, float grav, int damp, int open, void* stream) {
  const int64_t tiles_x = (nx + TX - 1) / TX;
  const int64_t blocks = tiles_x * ((ny + TY - 1) / TY) * nz;
  if (B < 1 || nq < 0 || nz < 2 || ny < 2 || nx < 2 ||
      (nz + 1) * ny * nx > 0x7fffffff || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto g = [](void* q) { return static_cast<float*>(q); };
  const Args a{f(rho),    f(rhou),    f(rhov),   f(rhow),   f(rhot),
               f(rhoq),   f(p),       f(p_ref),  f(rho_ref), f(jac),
               f(gx),     f(gy),      f(gx_zf),  f(gy_zf),  f(dzc),
               f(dzf),    g(o_rho),   g(o_rhou), g(o_rhov), g(o_rhow),
               g(o_rhot), g(o_rhoq),  static_cast<int>(B),
               static_cast<int>(nq),  static_cast<int>(nz),
               static_cast<int>(ny),  static_cast<int>(nx),
               static_cast<int>(tiles_x), inv_dx, inv_dy, kdiff4,
               alpha_h, divdmp, inv_dt, grav, damp};
  const auto dyn = open ? terrain_dyn_kernel<true> : terrain_dyn_kernel<false>;
  const auto scal =
      open ? terrain_scalar_kernel<true> : terrain_scalar_kernel<false>;
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaError_t err = cudaFuncSetAttribute(
      dyn, cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dyn<<<grid, NT, DYN_SMEM, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scal<<<grid, NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
