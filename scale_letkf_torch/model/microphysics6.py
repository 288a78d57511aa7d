"""Single-moment 6-category bulk microphysics (NSW6 / Tomita-2008 class).

Port of scale_letkf_tpu/model/microphysics6.py: the Lin/Tomita
single-moment scheme on the 6-tracer state (qv, qc, qr, qi, qs, qg) with

  warm:  saturation adjustment (cond/evap of qc), autoconversion qc→qr,
         accretion qr∙qc, rain evaporation
  cold:  ice nucleation/deposition, autoconversion qi→qs, riming qs∙qc,
         graupel conversion & accretion qg∙(qc,qr,qs), melting qs,qg→qr,
         freezing qr→qg, sublimation
  sedimentation of qr, qs, qg with category fall speeds,

latent heating fed back on ρθ through the moist Exner relation. Fields
carry any leading member axes (levels axis −3, tracers axis −4 of ρq); the
arithmetic is elementwise plain PyTorch, as it was plain XLA in the
reference.
"""

from __future__ import annotations

import torch

from scale_letkf_torch.constants import (
    PRE00, PSAT0, RD, T00, TETENS_A_ICE, TETENS_A_LIQ, TETENS_B_ICE,
    TETENS_B_LIQ,
)
from scale_letkf_torch.model.dycore import DycoreState
from scale_letkf_torch.model.physics import (
    CPDRY, LHV, fall_speed_cap, sediment_upwind, temperature, tracer,
)
from scale_letkf_torch.ops.finite_diff import zsl

LHS = 2.834e6    # sublimation
LHF = LHS - LHV  # fusion

# fall-speed power laws V = a (ρ q)^b · (ρ0/ρ)^0.5  [m/s], Lin-type
FALL_A = {"qr": 36.34, "qs": 7.0, "qg": 22.0}
FALL_B = {"qr": 0.1364, "qs": 0.11, "qg": 0.125}

# process rate coefficients (Lin et al. 1983 / Tomita 2008 magnitudes)
AUTO_QC = 1.0e-3       # qc→qr autoconversion rate [1/s]
AUTO_QC_THRESH = 1.0e-3
AUTO_QI = 1.0e-3       # qi→qs
AUTO_QI_THRESH = 6.0e-4
ACC_RC = 2.2           # rain collecting cloud
ACC_SC = 1.0           # snow riming cloud
ACC_GC = 3.0           # graupel collecting cloud
ACC_GR = 2.0           # graupel collecting rain (T<T0)
MELT_RATE = 1.0e-2     # [1/s/K] melting of qs/qg above T0
FREEZE_RATE = 1.0e-2   # [1/s/K] rain freezing below T_frz
T_FRZ = 268.15
EVAP_R = 1.0e-3
SUBL = 1.0e-3


def qsat(temp, pres, ice: bool):
    if ice:
        es = PSAT0 * torch.exp(TETENS_A_ICE * (temp - T00)
                               / (temp - TETENS_B_ICE))
    else:
        es = PSAT0 * torch.exp(TETENS_A_LIQ * (temp - T00)
                               / (temp - TETENS_B_LIQ))
    return 0.622 * es / torch.clamp(pres - 0.378 * es, min=1.0)


def _lim(rate, avail):
    """A (positive) conversion limited to the available source amount."""
    return torch.minimum(torch.clamp(rate, min=0.0),
                         torch.clamp(avail, min=0.0))


def _pos(x):
    return torch.clamp(x, min=0.0)


def nsw6_step(s: DycoreState, dt: float, dz) -> DycoreState:
    """One microphysics step; returns the updated dycore state. dz: a
    number or the per-level thickness (nz, 1, 1)."""
    rho = s.rho
    q = s.rhoq / rho.unsqueeze(-4)
    qv, qc, qr, qi, qs_, qg = (tracer(q, i) for i in range(6))
    temp, p = temperature(s, q)
    exner_fac = (PRE00 / p) ** (RD / CPDRY)
    warm = temp >= T00
    cold = ~warm

    # --- saturation adjustment: liquid where warm, ice where cold
    qs_liq = qsat(temp, p, ice=False)
    dqsdT = qs_liq * (TETENS_A_LIQ * (T00 - TETENS_B_LIQ)
                      / (temp - TETENS_B_LIQ) ** 2)
    cond = (qv - qs_liq) / (1.0 + (LHV / CPDRY) * dqsdT)
    cond = torch.where(warm, torch.maximum(cond, -qc), 0.0)
    qv = qv - cond
    qc = qc + cond
    heat = (LHV / CPDRY) * exner_fac * cond     # accumulated θ heating [K]

    qs_ice = qsat(temp, p, ice=True)
    dqsdT_i = qs_ice * (TETENS_A_ICE * (T00 - TETENS_B_ICE)
                        / (temp - TETENS_B_ICE) ** 2)
    dep = (qv - qs_ice) / (1.0 + (LHS / CPDRY) * dqsdT_i)
    dep = torch.where(warm, 0.0, torch.maximum(dep, -qi))
    qv = qv - dep
    qi = qi + dep
    heat = heat + (LHS / CPDRY) * exner_fac * dep

    # --- warm rain
    auto_r = _lim(AUTO_QC * (qc - AUTO_QC_THRESH) * dt, qc)
    accr_rc = _lim(ACC_RC * qc * _pos(qr) ** 0.875 * dt, qc - auto_r)
    qc = qc - auto_r - accr_rc
    qr = qr + auto_r + accr_rc

    subsat = _pos(qs_liq - qv)
    evap = _lim(EVAP_R * subsat * (rho * _pos(qr)) ** 0.65 * dt, qr)
    qv = qv + evap
    qr = qr - evap
    heat = heat - (LHV / CPDRY) * exner_fac * evap

    # --- ice-phase conversions (cold regions)
    auto_s = torch.where(cold, _lim(AUTO_QI * (qi - AUTO_QI_THRESH) * dt, qi),
                         0.0)
    qi = qi - auto_s
    qs_ = qs_ + auto_s

    # riming: snow collects cloud water → snow (light) or graupel (heavy)
    rim = torch.where(cold, _lim(ACC_SC * qc * _pos(qs_) ** 0.875 * dt, qc),
                      0.0)
    to_g = torch.where(qs_ > 1.0e-3, rim, 0.0)     # heavy riming → graupel
    qc = qc - rim
    qs_ = qs_ + (rim - to_g)
    qg = qg + to_g
    heat = heat + (LHF / CPDRY) * exner_fac * rim   # freezing of collected qc

    # graupel collecting cloud and rain (cold)
    acc_gc = torch.where(cold, _lim(ACC_GC * qc * _pos(qg) ** 0.875 * dt, qc),
                         0.0)
    acc_gr = torch.where(cold, _lim(ACC_GR * _pos(qr) * _pos(qg) ** 0.875
                                    * dt, qr), 0.0)
    qc = qc - acc_gc
    qr = qr - acc_gr
    qg = qg + acc_gc + acc_gr
    heat = heat + (LHF / CPDRY) * exner_fac * (acc_gc + acc_gr)

    # rain freezing to graupel in strongly supercooled air
    frz = _lim(FREEZE_RATE * _pos(T_FRZ - temp) * qr * dt, qr)
    qr = qr - frz
    qg = qg + frz
    heat = heat + (LHF / CPDRY) * exner_fac * frz

    # melting of snow/graupel above freezing
    melt_s = _lim(MELT_RATE * _pos(temp - T00) * qs_ * dt, qs_)
    melt_g = _lim(MELT_RATE * _pos(temp - T00) * qg * dt, qg)
    qs_ = qs_ - melt_s
    qg = qg - melt_g
    qr = qr + melt_s + melt_g
    heat = heat - (LHF / CPDRY) * exner_fac * (melt_s + melt_g)

    # sublimation of snow/graupel in ice-subsaturated air
    subsat_i = _pos(qs_ice - qv)
    subl_s = _lim(SUBL * subsat_i * (rho * _pos(qs_)) ** 0.65 * dt, qs_)
    subl_g = _lim(SUBL * subsat_i * (rho * _pos(qg)) ** 0.65 * dt, qg)
    qs_ = qs_ - subl_s
    qg = qg - subl_g
    qv = qv + subl_s + subl_g
    heat = heat - (LHS / CPDRY) * exner_fac * (subl_s + subl_g)

    # --- sedimentation (upwind, CFL-capped fall speeds); the density ratio
    # is to the top level, as in the reference
    ratio = torch.sqrt(torch.clamp(zsl(rho, -1) / rho, min=0.1))

    def sediment(qx, name):
        vt = FALL_A[name] * (rho * _pos(qx)) ** FALL_B[name] * ratio
        return sediment_upwind(qx, rho, fall_speed_cap(vt, dz, dt), dz, dt)

    qr = sediment(qr, "qr")
    qs_ = sediment(qs_, "qs")
    qg = sediment(qg, "qg")

    q_new = torch.stack([qv, _pos(qc), qr, _pos(qi), qs_, qg], dim=-4)
    return s._replace(rhot=s.rhot + rho * heat,
                      rhoq=q_new * rho.unsqueeze(-4))
