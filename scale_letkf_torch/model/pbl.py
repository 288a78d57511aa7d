"""Boundary-layer turbulence: local K closure + implicit vertical diffusion.

Port of scale_letkf_tpu/model/pbl.py: a Richardson-number-dependent
first-order local closure (Louis-type, the level-2 reduction of
Mellor–Yamada) diagnoses eddy diffusivities on the vertical interfaces, and
u, v, θ, qv are diffused with a backward-Euler implicit column solve, with
the bulk surface fluxes (model/surface.py) as an implicit lower boundary
condition.

The column solve is the dynamical core's Thomas algorithm
(model/dycore_si.py `_thomas_solve`: the reference's `tridiag_solve` has
the same recurrence), along the levels (axis −3) of fields with any
leading member axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scale_letkf_torch.constants import FVIRT, GRAV, PRE00, RD
from scale_letkf_torch.model.dycore import DycoreState, moist_pressure
from scale_letkf_torch.model.dycore_si import _thomas_solve
from scale_letkf_torch.model.physics import CPDRY, qsat_liq, tracer
from scale_letkf_torch.model.surface import SurfaceFluxes, surface_fluxes
from scale_letkf_torch.ops.finite_diff import roll_x, roll_y, zsl

KARMAN = 0.4
LAMBDA_MIX = 150.0    # asymptotic mixing length [m]
RI_CRIT = 0.25
K_MIN = 1.0e-3        # background diffusivity [m^2/s]
K_MAX = 200.0
PRANDTL = 0.74


def _dz(f):
    """f[k+1] − f[k] on the interior interfaces (..., nz−1, ny, nx)."""
    return zsl(f, 1) - zsl(f, None, -1)


def _mid(f):
    return 0.5 * (zsl(f, 1) + zsl(f, None, -1))


def eddy_diffusivity(u, v, thv, zc, dz):
    """K_m, K_h on the interior interfaces (..., nz−1, ny, nx) from the local
    shear and stability (Louis-type level-2 closure). zc: cell-center
    heights (nz,)."""
    du = _dz(u) / dz
    dv = _dz(v) / dz
    s2 = du * du + dv * dv
    n2 = GRAV / _mid(thv) * _dz(thv) / dz
    ri = n2 / torch.clamp(s2, min=1.0e-10)

    z_i = 0.5 * (zc[1:] + zc[:-1])
    l_mix = KARMAN * z_i / (1.0 + KARMAN * z_i / LAMBDA_MIX)
    l2s = (l_mix ** 2)[:, None, None] * torch.sqrt(s2)

    f_un = torch.sqrt(torch.clamp(1.0 - 16.0 * ri, min=1.0))
    f_st = torch.clamp(1.0 - ri / RI_CRIT, min=0.0) ** 2
    f = torch.where(ri < 0.0, f_un, f_st)
    km = torch.clamp(l2s * f + K_MIN, K_MIN, K_MAX)
    kh = torch.clamp(km / PRANDTL, K_MIN, K_MAX)
    return km, kh


def diffuse_column(phi, rhok_int, rho_c, dt, dz, sfc_coef, sfc_val):
    """Backward-Euler vertical diffusion of the cell-centered `phi` (..., nz,
    ny, nx). rhok_int: ρK at the interior interfaces; rho_c: ρ at the
    centers. Surface exchange enters implicitly: flux = sfc_coef·(sfc_val −
    φ₁) with sfc_coef in kg/m²/s (surface slabs (..., ny, nx))."""
    zero = torch.zeros_like(zsl(phi, None, 1))
    c_up = torch.cat([rhok_int / (zsl(rho_c, None, -1) * dz * dz), zero],
                     dim=-3)
    c_dn = torch.cat([zero, rhok_int / (zsl(rho_c, 1) * dz * dz)], dim=-3)
    sfc = sfc_coef / (rho_c[..., 0, :, :] * dz)

    diag = 1.0 + dt * (c_up + c_dn)
    diag[..., 0, :, :] += dt * sfc
    rhs = phi.clone()
    rhs[..., 0, :, :] += dt * sfc * sfc_val
    return _thomas_solve(-dt * c_dn, diag, -dt * c_up, rhs, dim=-3)


class PblResult(NamedTuple):
    state: DycoreState
    sfc: SurfaceFluxes


class PblColumns(NamedTuple):
    """The column part of a PBL step: the centre-wind increments (du, dv),
    the diffused ρθ and ρq, and the surface fluxes."""
    du: torch.Tensor
    dv: torch.Tensor
    rhot: torch.Tensor
    rhoq: torch.Tensor
    sfc: SurfaceFluxes


def centre_winds(s: DycoreState, rhou_w: torch.Tensor, rhov_s: torch.Tensor):
    """(u, v) at the cell centres: the face momenta averaged with their
    west (rhou_w) and south (rhov_s) neighbours, over ρ."""
    return 0.5 * (s.rhou + rhou_w) / s.rho, 0.5 * (s.rhov + rhov_s) / s.rho


def pbl_columns(s: DycoreState, u, v, dt: float, dz: float,
                zc: torch.Tensor, tsfc: torch.Tensor, z0: float = 1.0e-2,
                z0h: float = 1.0e-3, beta: float = 1.0) -> PblColumns:
    """The surface layer and the implicit vertical diffusion of u, v, θ and
    qv, each column on its own: centre winds (u, v) in, their increments
    out (no lateral neighbour is read)."""
    rho = s.rho
    theta = s.rhot / rho
    qv = tracer(s.rhoq, 0) / rho

    p = moist_pressure(s.rhot, s.rhoq / rho.unsqueeze(-4))
    t_full = theta * (p / PRE00) ** (RD / CPDRY)
    thv = theta * (1.0 + FVIRT * qv)

    def lev0(f):
        return f[..., 0, :, :]

    # surface: extrapolate the surface pressure hydrostatically from level 0
    psfc = lev0(p) + lev0(rho) * GRAV * zc[0]
    sfc = surface_fluxes(lev0(u), lev0(v), lev0(t_full), lev0(qv), lev0(p),
                         lev0(rho), zc[0], tsfc, psfc, z0=z0, z0h=z0h,
                         beta=beta)

    km, kh = eddy_diffusivity(u, v, thv, zc, dz)
    rho_i = _mid(rho)
    rkm = rho_i * km
    rkh = rho_i * kh

    ths = tsfc / (psfc / PRE00) ** (RD / CPDRY)
    qs_sfc = beta * qsat_liq(tsfc, psfc)
    zero_val = torch.zeros_like(tsfc)

    u_new = diffuse_column(u, rkm, rho, dt, dz, sfc.cd_mod, zero_val)
    v_new = diffuse_column(v, rkm, rho, dt, dz, sfc.cd_mod, zero_val)
    th_new = diffuse_column(theta, rkh, rho, dt, dz, sfc.ch_mod, ths)
    qv_new = diffuse_column(qv, rkh, rho, dt, dz, sfc.ce_mod, qs_sfc)

    rhoq = torch.cat([(rho * torch.clamp(qv_new, min=0.0)).unsqueeze(-4),
                      s.rhoq[..., 1:, :, :, :]], dim=-4)
    return PblColumns(du=u_new - u, dv=v_new - v, rhot=rho * th_new,
                      rhoq=rhoq, sfc=sfc)


def face_momenta(s: DycoreState, du, dv, du_e, dv_n, rho_e, rho_n):
    """Back to staggered momenta: (ρu, ρv) plus the face averages of the
    centre increments and of ρ with the east (du_e, rho_e) and north
    (dv_n, rho_n) neighbours."""
    rhou = s.rhou + 0.5 * (du + du_e) * 0.5 * (s.rho + rho_e)
    rhov = s.rhov + 0.5 * (dv + dv_n) * 0.5 * (s.rho + rho_n)
    return rhou, rhov


def pbl_step(s: DycoreState, dt: float, dz: float, zc: torch.Tensor,
             tsfc: torch.Tensor, z0: float = 1.0e-2, z0h: float = 1.0e-3,
             beta: float = 1.0, lateral: str = "periodic") -> PblResult:
    """One surface-layer + PBL-diffusion step on the dycore state.

    zc: cell-center heights (nz,); tsfc: the surface skin temperature (...,
    ny, nx); lateral: the dynamical core's lateral mode, for the face ↔
    center averages of the momenta (centre_winds, face_momenta: the one
    horizontal part; parallel/halo.py physics_step_blocks runs them with
    halo slices). Diffuses u, v, θ, qv; mass is untouched."""
    u, v = centre_winds(s, roll_x(s.rhou, -1, lateral),
                        roll_y(s.rhov, -1, lateral))
    col = pbl_columns(s, u, v, dt, dz, zc, tsfc, z0=z0, z0h=z0h, beta=beta)
    del u, v
    rhou, rhov = face_momenta(
        s, col.du, col.dv, roll_x(col.du, 1, lateral),
        roll_y(col.dv, 1, lateral), roll_x(s.rho, 1, lateral),
        roll_y(s.rho, 1, lateral))
    return PblResult(state=s._replace(rhou=rhou, rhov=rhov, rhot=col.rhot,
                                      rhoq=col.rhoq),
                     sfc=col.sfc)
