"""Bulk surface-layer scheme (Louis 1979) + screen-level diagnostics.

Port of scale_letkf_tpu/model/surface.py: the surface fluxes (the lower
boundary condition of the PBL vertical diffusion, model/pbl.py) and the
10-m wind / 2-m temperature and humidity diagnostics of the history fields,
from the lowest-level state, with the Louis analytic stability functions
(no iterative Monin–Obukhov solve). Every field argument is a surface slab
(..., ny, nx) with any leading member axes; the arithmetic is elementwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scale_letkf_torch.constants import FVIRT, GRAV, PRE00, RD
from scale_letkf_torch.model.physics import CPDRY, LHV, qsat_liq

KARMAN = 0.4


class SurfaceFluxes(NamedTuple):
    """Kinematic surface fluxes and exchange diagnostics, all (..., ny, nx)."""
    taux: torch.Tensor     # momentum flux u [kg/m/s^2] (ρ CD |U| u1, down = +)
    tauy: torch.Tensor
    shf: torch.Tensor      # sensible heat flux [W/m^2] (+: surface → atmos)
    lhf: torch.Tensor      # latent heat flux [W/m^2]
    wtheta: torch.Tensor   # kinematic θ flux ρ⁻¹ SH/cp [K m/s]
    wq: torch.Tensor       # kinematic moisture flux [kg/kg m/s]
    ch_mod: torch.Tensor   # ρ C_H |U| [kg/m^2/s] (implicit-BC coefficient)
    ce_mod: torch.Tensor   # ρ C_E |U|
    cd_mod: torch.Tensor   # ρ C_D |U|
    ustar: torch.Tensor    # friction velocity [m/s]
    u10: torch.Tensor      # 10-m wind components (log-profile reduction)
    v10: torch.Tensor
    t2: torch.Tensor       # 2-m temperature [K]
    q2: torch.Tensor       # 2-m specific humidity [kg/kg]


def louis_stability(rib, z1_over_z0, a2):
    """Louis (1979) analytic stability functions f_m, f_h of the bulk
    Richardson number, b = c = d = 5 (the classical coefficients)."""
    b = c = d = 5.0
    sq = torch.sqrt(torch.clamp(-rib, min=0.0) * z1_over_z0)
    denom_m = 1.0 + 3.0 * b * c * a2 * sq
    fm_un = 1.0 - 2.0 * b * rib / denom_m
    fh_un = 1.0 - 3.0 * b * rib / denom_m
    rib_p = torch.clamp(rib, min=0.0)
    fm_st = 1.0 / (1.0 + 2.0 * b * rib_p / torch.sqrt(1.0 + d * rib_p))
    fh_st = 1.0 / (1.0 + 3.0 * b * rib_p * torch.sqrt(1.0 + d * rib_p))
    unstable = rib < 0.0
    return (torch.where(unstable, fm_un, fm_st),
            torch.where(unstable, fh_un, fh_st))


def surface_fluxes(u1, v1, t1, qv1, p1, rho1, z1, tsfc, psfc,
                   z0: float = 1.0e-2, z0h: float = 1.0e-3,
                   beta: float = 1.0, min_wind: float = 0.5
                   ) -> SurfaceFluxes:
    """Bulk aerodynamic surface fluxes from the lowest-level state. z1 (the
    level-1 height) is a tensor of the slabs' shape or a 0-d one. `beta` is
    the surface evaporation efficiency (1 over water), `min_wind` the
    gustiness floor of |U|."""
    kappa = RD / CPDRY
    exner1 = (p1 / PRE00) ** kappa
    exner_s = (psfc / PRE00) ** kappa
    th1 = t1 / exner1
    ths = tsfc / exner_s
    qs_sfc = beta * qsat_liq(tsfc, psfc)
    thv1 = th1 * (1.0 + FVIRT * qv1)
    thvs = ths * (1.0 + FVIRT * qs_sfc)

    wind = torch.clamp(torch.sqrt(u1 * u1 + v1 * v1), min=min_wind)

    rib = (GRAV * z1 * (thv1 - thvs)
           / (0.5 * (thv1 + thvs) * wind * wind))
    ln_m = torch.log(z1 / z0)
    ln_h = torch.log(z1 / z0h)
    a2_m = (KARMAN / ln_m) ** 2
    a2_h = KARMAN * KARMAN / (ln_m * ln_h)
    fm, fh = louis_stability(rib, z1 / z0, a2_m)
    cd = a2_m * fm
    ch = a2_h * fh
    ce = ch  # moisture exchange = heat exchange (standard bulk assumption)

    cd_mod = rho1 * cd * wind
    taux = cd_mod * u1
    tauy = cd_mod * v1
    wtheta = ch * wind * (ths - th1)
    wq = ce * wind * (qs_sfc - qv1)

    # screen-level diagnostics: neutral log-profile reduction between the
    # surface value and level 1 (history fields u10m/v10m/t2m/q2m)
    r10 = torch.clamp(math.log(max(10.0, z0 * 2.0) / z0) / ln_m, max=1.0)
    r2 = torch.clamp(math.log(max(2.0, z0h * 2.0) / z0h) / ln_h, max=1.0)
    return SurfaceFluxes(
        taux=taux, tauy=tauy, shf=rho1 * CPDRY * wtheta * exner_s,
        lhf=rho1 * LHV * wq, wtheta=wtheta, wq=wq,
        ch_mod=rho1 * ch * wind, ce_mod=rho1 * ce * wind, cd_mod=cd_mod,
        ustar=torch.sqrt(torch.sqrt(taux ** 2 + tauy ** 2) / rho1),
        u10=u1 * r10, v10=v1 * r10,
        t2=(ths + (th1 - ths) * r2) * exner_s,
        q2=qs_sfc + (qv1 - qs_sfc) * r2)
