"""Radiation: gray two-stream longwave + Beer-law shortwave.

Port of scale_letkf_tpu/model/radiation.py: a broadband gray-gas longwave
scheme with water-vapour/cloud/ice absorbers and a single-beam shortwave
with Rayleigh + vapour + cloud extinction. The reference's two longwave
flux ladders are `lax.scan`s over the levels; here they are Python loops
over the levels, each step on whole (member, y, x) slabs. The shortwave
path is two cumulative sums along the levels (axis −3).

Returns heating rates as ρθ tendencies plus the surface radiative budget
terms the slab surface temperature needs (model/physics_suite.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scale_letkf_torch.constants import PRE00, RD
from scale_letkf_torch.model.dycore import DycoreState, moist_pressure
from scale_letkf_torch.model.physics import CPDRY, tracer
from scale_letkf_torch.ops.finite_diff import zsl

SIGMA_SB = 5.670374e-8

# Broadband gray mass-absorption coefficients [m^2/kg]
K_LW_QV = 0.10
K_LW_CLOUD = 60.0     # liquid (qc+qr)
K_LW_ICE = 30.0       # ice (qi+qs+qg)
K_LW_DRY = 2.0e-4     # well-mixed gases (CO2 etc.)
K_SW_QV = 2.0e-3
K_SW_CLOUD = 30.0
K_SW_RAYLEIGH = 1.0e-5

S0 = 1361.0           # solar constant [W/m^2]


class RadResult(NamedTuple):
    drhot: torch.Tensor        # ρθ tendency [kg K /m^3 /s] (..., nz, ny, nx)
    lw_down_sfc: torch.Tensor  # surface downward LW [W/m^2] (..., ny, nx)
    sw_down_sfc: torch.Tensor  # surface downward SW [W/m^2]
    olr: torch.Tensor          # outgoing LW at TOA [W/m^2]
    heating: torch.Tensor      # temperature tendency [K/s] (diagnostic)


def _lw_fluxes(temp, trans, emis, tsfc, eps_sfc):
    """Gray longwave flux ladders, one loop over the levels each.

    temp/trans/emis: (..., nz, ny, nx) layer temperature, transmission,
    emission = 1 − trans. Returns the fluxes on the interfaces (..., nz+1,
    ny, nx): up[k] at the bottom interface of layer k (up[nz] = TOA), down
    likewise."""
    nz = temp.shape[-3]
    b = SIGMA_SB * temp ** 4

    def level(f, k):
        return f[..., k, :, :]

    # upward: from the surface up through the layers
    up0 = eps_sfc * SIGMA_SB * tsfc ** 4
    up = [up0]
    for k in range(nz):
        up.append(up[-1] * level(trans, k) + level(b, k) * level(emis, k))

    # downward: from TOA down through the layers
    zero = torch.zeros_like(up0)
    down = [zero]
    for k in range(nz - 1, -1, -1):
        down.append(down[-1] * level(trans, k) + level(b, k) * level(emis, k))
    return torch.stack(up, dim=-3), torch.stack(down[::-1], dim=-3)


def radiation_step(s: DycoreState, dz, mu0, albedo: float = 0.2,
                   eps_sfc: float = 0.98, tsfc=None) -> RadResult:
    """Radiative heating of the current state.

    mu0: cosine solar zenith angle (a number, or a (ny, nx) tensor); 0 =
    night. tsfc: surface skin temperature (..., ny, nx); None takes the
    lowest-level air temperature."""
    rho = s.rho
    q_mr = s.rhoq / rho.unsqueeze(-4)
    p = moist_pressure(s.rhot, q_mr)
    exner = (p / PRE00) ** (RD / CPDRY)
    temp = (s.rhot / rho) * exner
    if tsfc is None:
        tsfc = temp[..., 0, :, :]

    qv = tracer(q_mr, 0)
    q_liq = tracer(q_mr, 1) + tracer(q_mr, 2)
    q_ice = tracer(q_mr, 3) + tracer(q_mr, 4) + tracer(q_mr, 5)

    dtau_lw = (K_LW_QV * qv + K_LW_CLOUD * q_liq + K_LW_ICE * q_ice
               + K_LW_DRY) * rho * dz
    trans = torch.exp(-1.66 * dtau_lw)         # 1.66: diffusivity factor
    up, down = _lw_fluxes(temp, trans, 1.0 - trans, tsfc, eps_sfc)
    net_lw = up - down                          # (..., nz+1, ny, nx), + upward

    # shortwave: direct beam attenuated from TOA
    mu = torch.clamp(torch.as_tensor(mu0, dtype=rho.dtype, device=rho.device),
                     min=0.0)
    dtau_sw = (K_SW_QV * qv + K_SW_CLOUD * (q_liq + q_ice)
               + K_SW_RAYLEIGH) * rho * dz
    mu_safe = torch.clamp(mu, min=1.0e-3)
    # cumulative optical depth above each interface (top-down)
    tau_above = torch.cumsum(dtau_sw.flip(-3), dim=-3).flip(-3)
    sw_top = S0 * mu
    flux_at_lower = sw_top * torch.exp(-tau_above / mu_safe)
    top = torch.ones_like(zsl(flux_at_lower, None, 1))
    sw_down = torch.cat([flux_at_lower, sw_top * top], dim=-3)
    sw_down_sfc = sw_down[..., 0, :, :]
    # upward reflected beam: absorbed on the way up with the same dtau
    tau_below = torch.cumsum(dtau_sw, dim=-3) - dtau_sw     # below layer k
    sw_up_sfc = (albedo * sw_down_sfc).unsqueeze(-3)
    sw_up = torch.cat([sw_up_sfc * top,
                       sw_up_sfc * torch.exp(-(tau_below + dtau_sw)
                                             / mu_safe)], dim=-3)

    net = net_lw + (sw_up - sw_down)            # + upward
    # heating = −1/(ρ cp) dF_net/dz with F_net positive upward
    div = (zsl(net, 1) - zsl(net, None, -1)) / dz
    heating = -div / (rho * CPDRY)
    return RadResult(drhot=rho * heating / exner,
                     lw_down_sfc=down[..., 0, :, :], sw_down_sfc=sw_down_sfc,
                     olr=up[..., -1, :, :], heating=heating)
