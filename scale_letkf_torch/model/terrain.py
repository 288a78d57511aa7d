"""Terrain-following dynamics: the metric terms of the Gal-Chen coordinate.

Port of scale_letkf_tpu/model/terrain.py (reference: common_scale.f90
scale_calc_z :1434, z = (H − h)/H·ζ + h). With z(ζ) = (1 − h/H)·ζ + h:

  J(x, y)    = ∂z/∂ζ = 1 − h/H            (column-constant Jacobian)
  Gx(k,x,y)  = ∂z/∂x|_ζ = s_k·∂h/∂x,  s_k = 1 − ζ_k/H

and the flux-form equations prognose J-weighted densities with the
contravariant vertical mass flux ρW = (ρw − Gx·ρu − Gy·ρv)/J and the
horizontal pressure gradient corrected by −(Gx/J)·∂p/∂ζ. The prognostic
variables stay the physical (ρ, ρu, …): J is applied and removed inside the
tendency, so the DA state is unchanged. Flat topography reduces to
dycore.tendencies.

Differences from the JAX module:
- fields may carry leading batch (member) axes: levels at -3, tracers at
  -4; the metrics (ny, nx) and (nz[+1], ny, nx) broadcast over them;
- the lateral mode is an explicit argument (`cfg.lateral`) of the
  stencils, not a module global. `make_metrics` always rolls periodically:
  the reference builds the metrics in CycleDriver.__init__, outside any
  lateral_bc context, so its ∂h/∂x and ∂h/∂y wrap even when the domain's
  lateral mode is 'open';
- the six tracers go through the UD3 flux divergence in one pass over the
  tracer axis (the reference's jax.vmap), accumulated in place so that a
  batch holds few tracer-sized temporaries at once;
- `rk3_step_terrain` takes the optional timer sections `tendencies` and
  `sponge`, as dycore.rk3_step does.

This is plain PyTorch on either device: the reference computes it in plain
XLA, and no kernel stands behind it (kernels #2 and #3 carry the flat
metric only).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scale_letkf_torch.constants import GRAV
from scale_letkf_torch.model.dycore import (
    DycoreConfig, DycoreState, VGrid, _axpy, _check_lateral, metric,
    mixing_ratios, moist_pressure, rayleigh_sponge,
)
from scale_letkf_torch.ops.finite_diff import (
    hyperdiff4, roll_x, roll_y, ud3_face_x, ud3_face_y, ud3_face_z, zsl,
)
from scale_letkf_torch.utils.timing import Timer, maybe_section


class TerrainMetrics(NamedTuple):
    jac: torch.Tensor     # (ny, nx)       J = 1 − h/H
    gx: torch.Tensor      # (nz, ny, nx)   ∂z/∂x|_ζ at x-faces (i+1/2)
    gy: torch.Tensor      # (nz, ny, nx)   ∂z/∂y|_ζ at y-faces (j+1/2)
    gx_zf: torch.Tensor   # (nz+1, ny, nx) the same at z-faces (for ρW)
    gy_zf: torch.Tensor


def make_metrics(topo: torch.Tensor, cz: np.ndarray, fz: np.ndarray,
                 dx: float, dy: float) -> TerrainMetrics:
    """The metrics of topography topo (ny, nx) on its device and in its
    dtype; ∂h/∂x and ∂h/∂y by periodic differences, as the reference."""
    H = float(fz[-1])
    jac = 1.0 - topo / H
    dhdx = (roll_x(topo, 1, "periodic") - topo) / dx      # at x-faces i+1/2
    dhdy = (roll_y(topo, 1, "periodic") - topo) / dy

    def s(levels):
        return torch.as_tensor(1.0 - np.asarray(levels) / H, dtype=topo.dtype,
                               device=topo.device)[:, None, None]
    s_c, s_f = s(cz), s(fz)
    return TerrainMetrics(jac=jac, gx=s_c * dhdx, gy=s_c * dhdy,
                          gx_zf=s_f * dhdx, gy_zf=s_f * dhdy)


def _faces(f: torch.Tensor) -> torch.Tensor:
    """Center field → its nz+1 z-faces: the edge values at the boundary
    faces, the mean of the two neighbours inside."""
    return torch.cat([zsl(f, None, 1),
                      0.5 * (zsl(f, 1) + zsl(f, None, -1)),
                      zsl(f, -1)], dim=-3)


def _zero_ends(f: torch.Tensor) -> torch.Tensor:
    """f with its first and last level (the rigid faces) set to zero."""
    f[..., 0, :, :] = 0.0
    f[..., -1, :, :] = 0.0
    return f


def contravariant_w(s: DycoreState, m: TerrainMetrics,
                    lateral: str = "periodic") -> torch.Tensor:
    """ρW at the z-faces: (ρw − Gx·ρu − Gy·ρv)/J with the momenta
    interpolated to cell centers and z-faces. The boundary faces keep ρW = 0
    (free slip over terrain: the flow follows the surface)."""
    rhou_c = 0.5 * (s.rhou + roll_x(s.rhou, -1, lateral))
    rhov_c = 0.5 * (s.rhov + roll_y(s.rhov, -1, lateral))
    rhou_zf = 0.5 * (zsl(rhou_c, 1) + zsl(rhou_c, None, -1))
    rhov_zf = 0.5 * (zsl(rhov_c, 1) + zsl(rhov_c, None, -1))
    # the slopes live at x/y faces: to cell centers, as the momenta
    gx_c = 0.5 * (m.gx_zf + roll_x(m.gx_zf, -1, lateral))
    gy_c = 0.5 * (m.gy_zf + roll_y(m.gy_zf, -1, lateral))
    gw_int = (zsl(s.rhow, 1, -1) - zsl(gx_c, 1, -1) * rhou_zf
              - zsl(gy_c, 1, -1) * rhov_zf) / m.jac
    zeros = torch.zeros_like(zsl(s.rhow, None, 1))
    return torch.cat([zeros, gw_int, zeros], dim=-3)


def tendencies_terrain(s: DycoreState, cfg: DycoreConfig,
                       rho_ref: torch.Tensor, p_ref: torch.Tensor,
                       m: TerrainMetrics,
                       vg: VGrid | None = None) -> DycoreState:
    """Flux-form tendencies with terrain metrics; rho_ref/p_ref (nz, 1, 1),
    vg the stretched vertical metric (None ⇒ uniform cfg.dz). Reduces to
    the flat core when the topography is zero (J = 1, Gx = Gy = 0)."""
    lat = cfg.lateral
    _check_lateral(lat)
    dx, dy = cfg.dx, cfg.dy
    vg = metric(s, cfg, vg)
    dzc, dzf = vg.dzc, vg.dzf
    jac = m.jac

    def rx(f, n):
        return roll_x(f, n, lat)

    def ry(f, n):
        return roll_y(f, n, lat)

    def div_center(fx_, fy_, fw_full):
        """((∂x + ∂y) + ∂ζ) / J of face fluxes, accumulated in place."""
        acc = (fx_ - rx(fx_, -1)) / dx
        acc += (fy_ - ry(fy_, -1)) / dy
        acc += (zsl(fw_full, 1) - zsl(fw_full, None, -1)) / dzc
        return acc.div_(jac)

    p_pert = moist_pressure(s.rhot, mixing_ratios(s)) - p_ref

    # fluxes: horizontal J-weighted at faces; vertical contravariant
    jac_xf = 0.5 * (jac + roll_x(jac, 1, lat))
    jac_yf = 0.5 * (jac + roll_y(jac, 1, lat))
    fx = jac_xf * s.rhou
    fy = jac_yf * s.rhov
    rgw = contravariant_w(s, m, lat) * jac     # J·ρW at z-faces
    drho = -div_center(fx, fy, rgw)

    # ρθ and the tracers: UD3 flux divergence + ∇⁴, the tracers in one pass
    # over their axis (the reference's jax.vmap of the same function)
    def scalar_tend(fcen, rho, fx_, fy_, rgw_int):
        phi = fcen / rho
        fl = fx_ * ud3_face_x(phi, fx_, lat)
        acc = (fl - rx(fl, -1)) / dx
        fl = fy_ * ud3_face_y(phi, fy_, lat)
        acc += (fl - ry(fl, -1)) / dy
        fl = rgw_int * ud3_face_z(phi, rgw_int)
        del phi
        zeros = torch.zeros_like(zsl(fl, None, 1))
        fl = torch.cat([zeros, fl, zeros], dim=-3)
        acc += (zsl(fl, 1) - zsl(fl, None, -1)) / dzc
        del fl
        acc.div_(jac)
        return hyperdiff4(fcen, cfg.kdiff4, lat).sub_(acc)

    rgw_int = zsl(rgw, 1, -1)
    drhot = scalar_tend(s.rhot, s.rho, fx, fy, rgw_int)
    drhoq = scalar_tend(s.rhoq, *(f.unsqueeze(-4) for f in (
        s.rho, fx, fy, rgw_int)))

    # momentum advection (2nd-order centered, metric-consistent mass
    # fluxes) and the pressure gradient with its metric correction
    u_face = s.rhou / (0.5 * (s.rho + rx(s.rho, 1)))
    v_face = s.rhov / (0.5 * (s.rho + ry(s.rho, 1)))

    # ∂p'/∂ζ at cell centers: one-sided at the ends, centered inside
    dp_dz_c = torch.cat([
        (zsl(p_pert, 1, 2) - zsl(p_pert, 0, 1)) / vg.dzf[:1],
        (zsl(p_pert, 2) - zsl(p_pert, None, -2))
        / (vg.dzf[1:] + vg.dzf[:-1]),
        (zsl(p_pert, -1) - zsl(p_pert, -2, -1)) / vg.dzf[-1:]], dim=-3)

    adv = 0.5 * (fx + rx(fx, -1)) * (0.5 * (u_face + rx(u_face, -1)))
    dadv = (rx(adv, 1) - adv) / dx
    adv = 0.5 * (fy + rx(fy, 1)) * (0.5 * (u_face + ry(u_face, 1)))
    dadv += (adv - ry(adv, -1)) / dy
    adv = _zero_ends(0.5 * (rgw + rx(rgw, 1)) * _faces(u_face))
    dadv += (zsl(adv, 1) - zsl(adv, None, -1)) / dzc
    dadv /= jac_xf
    # PG at x-faces: ∂p'/∂x|_ζ − (Gx/J)·∂p'/∂ζ
    dpx = ((rx(p_pert, 1) - p_pert) / dx
           - m.gx / jac_xf * (0.5 * (dp_dz_c + rx(dp_dz_c, 1))))
    drhou = (-dadv - dpx).add_(hyperdiff4(s.rhou, cfg.kdiff4, lat))
    del u_face

    adv = 0.5 * (fy + ry(fy, -1)) * (0.5 * (v_face + ry(v_face, -1)))
    dadv = (ry(adv, 1) - adv) / dy
    adv = 0.5 * (fx + ry(fx, 1)) * (0.5 * (v_face + rx(v_face, 1)))
    dadv += (adv - rx(adv, -1)) / dx
    adv = _zero_ends(0.5 * (rgw + ry(rgw, 1)) * _faces(v_face))
    dadv += (zsl(adv, 1) - zsl(adv, None, -1)) / dzc
    dadv /= jac_yf
    dpy = ((ry(p_pert, 1) - p_pert) / dy
           - m.gy / jac_yf * (0.5 * (dp_dz_c + ry(dp_dz_c, 1))))
    drhov = (-dadv - dpy).add_(hyperdiff4(s.rhov, cfg.kdiff4, lat))
    del v_face, dp_dz_c, dpx, dpy

    # w momentum at the interior z-faces
    w_full = s.rhow / _faces(s.rho)
    w_face = zsl(w_full, 1, -1)
    adv = (0.5 * (zsl(rgw, 1) + zsl(rgw, None, -1))
           * (0.5 * (zsl(w_full, 1) + zsl(w_full, None, -1))))
    dadv = (zsl(adv, 1) - zsl(adv, None, -1)) / dzf
    adv = (0.5 * (zsl(fx, 1) + zsl(fx, None, -1))
           * (0.5 * (w_face + rx(w_face, 1))))
    dadv += (adv - rx(adv, -1)) / dx
    adv = (0.5 * (zsl(fy, 1) + zsl(fy, None, -1))
           * (0.5 * (w_face + ry(w_face, 1))))
    dadv += (adv - ry(adv, -1)) / dy
    dadv /= jac
    del adv, w_full, w_face
    # vertical PG (1/J)·∂p'/∂ζ, buoyancy of the density perturbation
    dpz = (zsl(p_pert, 1) - zsl(p_pert, None, -1)) / dzf / jac
    rho_pert = s.rho - rho_ref
    buoy = -(0.5 * (zsl(rho_pert, 1) + zsl(rho_pert, None, -1))) * GRAV
    drhow_int = ((-dadv - dpz) + buoy).add_(
        hyperdiff4(zsl(s.rhow, 1, -1), cfg.kdiff4, lat))
    del dadv, dpz, buoy, rho_pert
    zeros_face = torch.zeros_like(zsl(s.rhow, None, 1))

    if cfg.divdmp > 0:
        alpha = cfg.divdmp * dx * dx / cfg.dt
        div = -drho
        drhou += alpha * (rx(div, 1) - div) / dx
        drhov += alpha * (ry(div, 1) - div) / dy
        alpha_z = cfg.divdmp * dzf * dzf / cfg.dt
        drhow_int += alpha_z * (zsl(div, 1) - zsl(div, None, -1)) / dzf
    drhow = torch.cat([zeros_face, drhow_int, zeros_face], dim=-3)
    return DycoreState(rho=drho, rhou=drhou, rhov=drhov, rhow=drhow,
                       rhot=drhot, rhoq=drhoq)


def rk3_step_terrain(s: DycoreState, cfg: DycoreConfig, rho_ref, p_ref,
                     z_center, m: TerrainMetrics, vg: VGrid | None = None,
                     timer: Timer | None = None) -> DycoreState:
    """One Wicker–Skamarock RK3 step of the explicit core with terrain
    metrics, then the Rayleigh sponge. timer: optional sections
    `tendencies` and `sponge`."""
    dt = cfg.dt

    def f(s_from):
        with maybe_section(timer, "tendencies"):
            return tendencies_terrain(s_from, cfg, rho_ref, p_ref, m, vg)

    s1 = _axpy(s, f(s), 1.0 / 3.0, dt)
    s2 = _axpy(s, f(s1), 0.5, dt)
    s3 = _axpy(s, f(s2), 1.0, dt)
    with maybe_section(timer, "sponge"):
        return rayleigh_sponge(s3, s, cfg, z_center, dt)
