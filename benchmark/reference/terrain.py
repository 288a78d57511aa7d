"""Plain reference of the terrain-following core: the Gal-Chen metrics of a
topography, the flux-form slow tendencies with them, and the
split-explicit step that integrates them.

Written from the model's equations (SCALE-RM's scale_calc_z,
common_scale.f90:1434: z = (H − h)/H·ζ + h), with z(ζ) = (1 − h/H)·ζ + h:

  J(x, y)    = ∂z/∂ζ = 1 − h/H
  Gx(k,x,y)  = ∂z/∂x|ζ = (1 − ζ_k/H)·∂h/∂x     (Gy likewise)

The prognostic fields stay the physical densities (ρ, ρu, ρv, ρw, ρθ,
ρq): each flux divergence is taken of J-weighted face fluxes and divided by
J, the vertical mass flux is the contravariant ρW = (ρw − Gx·ρu − Gy·ρv)/J
(zero at the rigid bottom and top: the flow follows the surface), and the
horizontal pressure gradient at constant ζ is corrected by −(G/J)·∂p′/∂ζ.
Advection is model.py's (UD3 scalars, centred momenta), ∇⁴ and the
divergence damping too. Plain PyTorch in the dtype of the inputs; fields
carry a leading member axis, the metrics broadcast over it.

Departures from SCALE-RM, where they lie below: ∂h/∂x and ∂h/∂y are
periodic differences and every stencil is periodic (the deployment's
lateral boundaries are open; regional.py relaxes a buffer wider than the
stencils toward the boundary data); the acoustic substeps of `si_step`
are model.py's flat-metric ones (J and G enter through the slow
tendencies alone), where SCALE-RM's HEVI carries the metric into its
acoustic operator.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference.model import rx, ry, zsl


class Metrics(NamedTuple):
    jac: torch.Tensor      # (ny, nx)       J
    gx: torch.Tensor       # (nz, ny, nx)   Gx at the x-faces i+1/2
    gy: torch.Tensor       # (nz, ny, nx)   Gy at the y-faces j+1/2
    gx_zf: torch.Tensor    # (nz+1, ny, nx) Gx at the z-faces
    gy_zf: torch.Tensor


def metrics(topo: torch.Tensor, col: M.Column) -> Metrics:
    """The metrics of the topography topo (ny, nx), in its dtype and on
    its device."""
    H = float(col.fz[-1])
    dhdx = (rx(topo, 1) - topo) / col.dx
    dhdy = (ry(topo, 1) - topo) / col.dy

    def s(levels):
        return torch.as_tensor(1.0 - np.asarray(levels) / H,
                               dtype=topo.dtype,
                               device=topo.device)[:, None, None]
    return Metrics(jac=1.0 - topo / H, gx=s(col.cz) * dhdx,
                   gy=s(col.cz) * dhdy, gx_zf=s(col.fz) * dhdx,
                   gy_zf=s(col.fz) * dhdy)


def zface_avg(f):
    """Centre values at the nz+1 z-faces: the edge values at the rigid
    faces, the neighbours' mean inside."""
    return torch.cat([zsl(f, None, 1), 0.5 * (zsl(f, 1) + zsl(f, None, -1)),
                      zsl(f, -1)], dim=-3)


def zero_ends(f):
    """f's interior z-faces, zero at the rigid ones."""
    return faces(zsl(f, 1, -1))


def faces(f_int):
    """Values at the nz−1 interior z-faces, with zeros at the rigid
    ones."""
    zeros = torch.zeros_like(zsl(f_int, None, 1))
    return torch.cat([zeros, f_int, zeros], dim=-3)


def contravariant_w(s: M.State, m: Metrics):
    """J·ρW at the z-faces (zero at the rigid ones)."""
    rhou_c = 0.5 * (s.rhou + rx(s.rhou, -1))
    rhov_c = 0.5 * (s.rhov + ry(s.rhov, -1))
    gx_c = 0.5 * (m.gx_zf + rx(m.gx_zf, -1))
    gy_c = 0.5 * (m.gy_zf + ry(m.gy_zf, -1))
    w = (zsl(s.rhow, 1, -1)
         - zsl(gx_c, 1, -1) * (0.5 * (zsl(rhou_c, 1) + zsl(rhou_c, None, -1)))
         - zsl(gy_c, 1, -1) * (0.5 * (zsl(rhov_c, 1)
                                      + zsl(rhov_c, None, -1)))) / m.jac
    return faces(w) * m.jac


def scalar_tendency(f, rho, fx, fy, fw_int, dzc, col: M.Column, jac):
    """−(1/J)∇·(F f/ρ) − kdiff4 ∇⁴f with the J-weighted face fluxes F and
    J·ρW at the interior z-faces fw_int."""
    phi = f / rho
    fl_x = fx * M.ud3_x(phi, fx)
    fl_y = fy * M.ud3_y(phi, fy)
    fl_z = faces(fw_int * M.ud3_z(phi, fw_int))
    div = ((fl_x - rx(fl_x, -1)) / col.dx + (fl_y - ry(fl_y, -1)) / col.dy
           + (zsl(fl_z, 1) - zsl(fl_z, None, -1)) / dzc)
    return M.hyperdiff4(f, col.kdiff4) - div / jac


def tendencies(s: M.State, col: M.Column, rho_ref, p_ref, dzc, dzf,
               m: Metrics) -> M.State:
    """The slow tendencies of the terrain-following core; dzc (nz, 1, 1)
    and dzf (nz−1, 1, 1) the level and interior-face spacings."""
    dx, dy, kdiff4, jac = col.dx, col.dy, col.kdiff4, m.jac
    p_pert = M.moist_pressure(s.rhot, M.mixing_ratios(s)) - p_ref
    rho = s.rho
    jac_xf = 0.5 * (jac + rx(jac, 1))
    jac_yf = 0.5 * (jac + ry(jac, 1))
    fx = jac_xf * s.rhou
    fy = jac_yf * s.rhov
    rgw = contravariant_w(s, m)
    div = ((fx - rx(fx, -1)) / dx + (fy - ry(fy, -1)) / dy
           + (zsl(rgw, 1) - zsl(rgw, None, -1)) / dzc) / jac
    drho = -div
    rgw_int = zsl(rgw, 1, -1)
    drhot = scalar_tendency(s.rhot, rho, fx, fy, rgw_int, dzc, col, jac)
    drhoq = scalar_tendency(s.rhoq, *(f.unsqueeze(-4) for f in (
        rho, fx, fy, rgw_int)), dzc, col, jac)

    u_face = s.rhou / (0.5 * (rho + rx(rho, 1)))
    v_face = s.rhov / (0.5 * (rho + ry(rho, 1)))
    # ∂p′/∂ζ at the centres: one-sided at the bottom and top levels
    dp_dz = torch.cat([
        (zsl(p_pert, 1, 2) - zsl(p_pert, 0, 1)) / dzf[:1],
        (zsl(p_pert, 2) - zsl(p_pert, None, -2)) / (dzf[1:] + dzf[:-1]),
        (zsl(p_pert, -1) - zsl(p_pert, -2, -1)) / dzf[-1:]], dim=-3)

    adv = 0.5 * (fx + rx(fx, -1)) * (0.5 * (u_face + rx(u_face, -1)))
    dadv_u = (rx(adv, 1) - adv) / dx
    adv = 0.5 * (fy + rx(fy, 1)) * (0.5 * (u_face + ry(u_face, 1)))
    dadv_u = dadv_u + (adv - ry(adv, -1)) / dy
    adv = zero_ends(0.5 * (rgw + rx(rgw, 1)) * zface_avg(u_face))
    dadv_u = (dadv_u + (zsl(adv, 1) - zsl(adv, None, -1)) / dzc) / jac_xf
    pg_x = ((rx(p_pert, 1) - p_pert) / dx
            - m.gx / jac_xf * (0.5 * (dp_dz + rx(dp_dz, 1))))
    drhou = (-dadv_u - pg_x) + M.hyperdiff4(s.rhou, kdiff4)

    adv = 0.5 * (fy + ry(fy, -1)) * (0.5 * (v_face + ry(v_face, -1)))
    dadv_v = (ry(adv, 1) - adv) / dy
    adv = 0.5 * (fx + ry(fx, 1)) * (0.5 * (v_face + rx(v_face, 1)))
    dadv_v = dadv_v + (adv - rx(adv, -1)) / dx
    adv = zero_ends(0.5 * (rgw + ry(rgw, 1)) * zface_avg(v_face))
    dadv_v = (dadv_v + (zsl(adv, 1) - zsl(adv, None, -1)) / dzc) / jac_yf
    pg_y = ((ry(p_pert, 1) - p_pert) / dy
            - m.gy / jac_yf * (0.5 * (dp_dz + ry(dp_dz, 1))))
    drhov = (-dadv_v - pg_y) + M.hyperdiff4(s.rhov, kdiff4)

    w_full = s.rhow / zface_avg(rho)
    w_face = zsl(w_full, 1, -1)
    adv = (0.5 * (zsl(rgw, 1) + zsl(rgw, None, -1))
           * (0.5 * (zsl(w_full, 1) + zsl(w_full, None, -1))))
    dadv_w = (zsl(adv, 1) - zsl(adv, None, -1)) / dzf
    adv = (0.5 * (zsl(fx, 1) + zsl(fx, None, -1))
           * (0.5 * (w_face + rx(w_face, 1))))
    dadv_w = dadv_w + (adv - rx(adv, -1)) / dx
    adv = (0.5 * (zsl(fy, 1) + zsl(fy, None, -1))
           * (0.5 * (w_face + ry(w_face, 1))))
    dadv_w = (dadv_w + (adv - ry(adv, -1)) / dy) / jac
    dpz = (zsl(p_pert, 1) - zsl(p_pert, None, -1)) / dzf / jac
    rho_pert = rho - rho_ref
    buoy = -(0.5 * (zsl(rho_pert, 1) + zsl(rho_pert, None, -1))) * M.GRAV
    drhow_int = ((-dadv_w - dpz) + buoy) + M.hyperdiff4(zsl(s.rhow, 1, -1),
                                                        kdiff4)

    if col.divdmp > 0:
        alpha = col.divdmp * dx * dx / col.dt
        drhou = drhou + alpha * (rx(div, 1) - div) / dx
        drhov = drhov + alpha * (ry(div, 1) - div) / dy
        alpha_z = col.divdmp * dzf * dzf / col.dt
        drhow_int = drhow_int + alpha_z * (zsl(div, 1)
                                           - zsl(div, None, -1)) / dzf
    return M.State(drho, drhou, drhov, faces(drhow_int), drhot, drhoq)


def si_step(s: M.State, col: M.Column, rho_ref, p_ref, dzc, dzf, z_c,
            m: Metrics) -> M.State:
    """One split-explicit RK3 step over terrain: stages of dt/3, dt/2 and
    dt with n_small//3, n_small//2 and n_small flat-metric acoustic
    substeps about the stage's terrain tendencies, then the sponge."""
    dt, n = col.dt, col.n_small

    def stage(s_from, dt_stage, ns):
        slow = tendencies(s_from, col, rho_ref, p_ref, dzc, dzf, m)
        return M.acoustic(s, s_from, slow, col, dzc, dzf, ns, dt_stage)

    s1 = stage(s, dt / 3.0, max(1, n // 3))
    s2 = stage(s1, dt / 2.0, max(1, n // 2))
    s3 = stage(s2, dt, n)
    return M.sponge(s3, col, z_c)
