"""Moist physics: saturation adjustment + Kessler-type warm rain.

Port of scale_letkf_tpu/model/physics.py, the stand-in for the reference
system's Tomita08 bulk microphysics: it updates qv, qc and qr of the
6-tracer state and leaves the ice categories advected but unchanged.

The reference runs one member under `jax.vmap`; here the fields carry any
leading member axes, the levels are axis −3 and the tracers axis −4 of ρq.
Like the reference it is plain elementwise arithmetic (no kernel), with one
upwind sweep along the levels for the sedimentation.
"""

from __future__ import annotations

import torch

from scale_letkf_torch.constants import (
    CVDRY, PRE00, PSAT0, RD, RV, T00, TETENS_A_LIQ, TETENS_B_LIQ,
)
from scale_letkf_torch.model.dycore import DycoreState, moist_pressure
from scale_letkf_torch.ops.finite_diff import zsl

LHV = 2.501e6      # latent heat of vaporization [J/kg]
CPDRY = RD + CVDRY


def qsat_liq(temp, pres):
    es = PSAT0 * torch.exp(TETENS_A_LIQ * (temp - T00) / (temp - TETENS_B_LIQ))
    return 0.622 * es / torch.clamp(pres - 0.378 * es, min=1.0)


def tracer(rhoq: torch.Tensor, i: int) -> torch.Tensor:
    """Tracer i of a (..., NQ, nz, ny, nx) stack."""
    return rhoq[..., i, :, :, :]


def temperature(s: DycoreState, q: torch.Tensor):
    """(T, p) of the state with tracer mixing ratios q = ρq/ρ (no floor on
    ρ, as the reference's physics divides)."""
    p = moist_pressure(s.rhot, q)
    qdry = 1.0 - torch.sum(q, dim=-4)
    rtot = RD * qdry + RV * tracer(q, 0)
    return p / (s.rho * rtot), p


def fall_speed_cap(vt: torch.Tensor, dz, dt: float) -> torch.Tensor:
    """min(vt, 0.9·dz/dt): the sedimentation's CFL cap; dz a number or a
    per-level (nz, 1, 1) thickness."""
    return torch.minimum(vt, torch.as_tensor(0.9 * dz / dt, dtype=vt.dtype,
                                             device=vt.device))


def sediment_upwind(q: torch.Tensor, rho: torch.Tensor, vt: torch.Tensor,
                    dz, dt: float) -> torch.Tensor:
    """q + dt·(inflow − flux)/(ρ dz) with the downward flux ρ q vt at the
    centers, the inflow into level k from level k+1 above (none into the
    top level), floored at 0."""
    flux = rho * q * vt
    inflow = torch.cat([zsl(flux, 1), torch.zeros_like(zsl(flux, None, 1))],
                       dim=-3)
    return torch.clamp(q + dt * (inflow - flux) / (rho * dz), min=0.0)


def kessler_step(s: DycoreState, dt: float, dz) -> DycoreState:
    """One Kessler microphysics step on the dycore state: saturation
    adjustment (condensation/evaporation of qc), autoconversion qc→qr,
    accretion of qc by qr, rain evaporation, and rain sedimentation with
    the Marshall–Palmer fall speed. Latent heating feeds back on ρθ. dz: a
    number, or the per-level thickness (nz, 1, 1) of stretched levels."""
    rho = s.rho
    q_mr = s.rhoq / rho.unsqueeze(-4)
    qv, qc, qr = (tracer(q_mr, i) for i in range(3))
    temp, p = temperature(s, q_mr)

    # --- saturation adjustment (single Newton step)
    qs = qsat_liq(temp, p)
    dqsdT = qs * (TETENS_A_LIQ * (T00 - TETENS_B_LIQ)
                  / (temp - TETENS_B_LIQ) ** 2)
    cond = (qv - qs) / (1.0 + (LHV / CPDRY) * dqsdT)
    cond = torch.maximum(cond, -qc)    # cannot evaporate more cloud than exists
    qv = qv - cond
    qc = qc + cond
    dtheta_fac = LHV / CPDRY * (PRE00 / p) ** (RD / CPDRY)
    theta_heat = dtheta_fac * cond

    # --- warm-rain conversions (Kessler 1969 coefficients)
    auto = torch.clamp(1.0e-3 * (qc - 1.0e-3), min=0.0) * dt
    accr = 2.2 * qc * torch.clamp(qr, min=0.0) ** 0.875 * dt
    dqc = torch.minimum(auto + accr, qc)
    qc = qc - dqc
    qr = qr + dqc

    # --- rain evaporation in subsaturated air
    subsat = torch.clamp(qs - qv, min=0.0)
    evap = torch.minimum(subsat, torch.minimum(
        qr, 1.0e-3 * dt * subsat
        * (rho * torch.clamp(qr, min=0.0)) ** 0.65))
    qv = qv + evap
    qr = qr - evap
    theta_heat = theta_heat - dtheta_fac * evap

    # --- sedimentation (upwind flux with the MP fall speed, CFL-capped);
    # the density ratio is to the top level, as in the reference
    vt = 36.34 * (rho * torch.clamp(qr, min=0.0)) ** 0.1364 * torch.sqrt(
        torch.clamp(zsl(rho, -1) / rho, min=0.1))
    qr = sediment_upwind(qr, rho, fall_speed_cap(vt, dz, dt), dz, dt)

    rhoq = torch.cat([torch.stack([qv * rho, qc * rho, qr * rho], dim=-4),
                      s.rhoq[..., 3:, :, :, :]], dim=-4)
    return s._replace(rhot=s.rhot + rho * theta_heat, rhoq=rhoq)
