"""Model state contract: restart variables ↔ analysis variables.

Port of scale_letkf_tpu/state.py (reference: common_scale.f90:36-51 variable
sets, state_trans at :1181-1226, state_trans_inv at :1229-1289). Layout
(..., NV3D, nz, ny, nx), variables stacked on the fourth axis from the end.

The transforms write into one preallocated output and accumulate the moist
sums tracer by tracer, so a full-size ensemble costs one extra copy of
itself plus a few single-variable temporaries, never a stacked copy.
"""

from __future__ import annotations

import torch

from scale_letkf_torch.constants import RD, RV, CVDRY, PRE00, TRACER_CV

# Restart (prognostic) stacking order: ρ, ρu, ρv, ρw, ρθ, q×6
IR_RHO, IR_RHOU, IR_RHOV, IR_RHOW, IR_RHOT = 0, 1, 2, 3, 4
IR_Q0 = 5
# Analysis (LETKF) stacking order: u, v, w, T, p, q×6
IA_U, IA_V, IA_W, IA_T, IA_P = 0, 1, 2, 3, 4
IA_Q0 = 5
NV3D = 11
NQ = 6
V3D_ANAL_NAMES = ("U", "V", "W", "T", "PRES",
                  "QV", "QC", "QR", "QI", "QS", "QG")


def _var(a: torch.Tensor, i: int) -> torch.Tensor:
    return a[..., i, :, :, :]


def _moist_rtot_cvtot(q: torch.Tensor):
    """R_tot, CV_tot from the 6-tracer moisture stack q (..., NQ, nz, ny, nx)."""
    qdry = 1.0 - torch.sum(q, dim=-4)
    cvtot = CVDRY * qdry
    for i in range(NQ):
        cvtot.add_(_var(q, i), alpha=float(TRACER_CV[i]))
    rtot = RD * qdry
    rtot.add_(_var(q, 0), alpha=RV)
    return rtot, cvtot


def state_trans(restart: torch.Tensor) -> torch.Tensor:
    """Restart [ρ, ρu, ρv, ρw, ρθ, q×6] → analysis [u, v, w, T, p, q×6]:
    p = PRE00 (ρθ R_tot / PRE00)^(Cp/Cv), T = p / (ρ R_tot), u = ρu/ρ."""
    q = restart[..., IR_Q0:, :, :, :]
    rtot, cvtot = _moist_rtot_cvtot(q)
    cpovcv = (cvtot + rtot) / cvtot
    del cvtot
    rho = _var(restart, IR_RHO)
    out = torch.empty_like(restart)
    pres = _var(out, IA_P)
    torch.pow(_var(restart, IR_RHOT) * rtot / PRE00, cpovcv, out=pres)
    pres.mul_(PRE00)
    torch.div(pres, rho * rtot, out=_var(out, IA_T))
    for ia, ir in ((IA_U, IR_RHOU), (IA_V, IR_RHOV), (IA_W, IR_RHOW)):
        torch.div(_var(restart, ir), rho, out=_var(out, ia))
    out[..., IA_Q0:, :, :, :] = q
    return out


def state_trans_inv(anal: torch.Tensor, *, positive_definite_q: bool = False,
                    positive_definite_qhyd: bool = False) -> torch.Tensor:
    """Analysis → restart: ρ = p/(R_tot T), ρθ = PRE00/R_tot (p/PRE00)^(Cv/Cp),
    ρu = u·ρ. POSITIVE_DEFINITE_Q / _QHYD clip qv / the hydrometeors at 0
    before the transform."""
    out = torch.empty_like(anal)
    q = out[..., IR_Q0:, :, :, :]
    q.copy_(anal[..., IA_Q0:, :, :, :])
    if positive_definite_q:
        _var(q, 0).clamp_(min=0.0)
    if positive_definite_qhyd:
        q[..., 1:, :, :, :].clamp_(min=0.0)
    rtot, cvtot = _moist_rtot_cvtot(q)
    cvovcp = cvtot / (cvtot + rtot)
    del cvtot
    pres = _var(anal, IA_P)
    rho = _var(out, IR_RHO)
    torch.div(pres, rtot * _var(anal, IA_T), out=rho)
    rhot = _var(out, IR_RHOT)
    torch.pow(pres / PRE00, cvovcp, out=rhot)
    rhot.mul_(PRE00 / rtot)
    for ir, ia in ((IR_RHOU, IA_U), (IR_RHOV, IA_V), (IR_RHOW, IA_W)):
        torch.mul(_var(anal, ia), rho, out=_var(out, ir))
    return out


def ensemble_mean(stack: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Ensemble mean over the member axis (ensmean_grd analogue)."""
    return torch.mean(stack, dim=dim)


def ensemble_spread(stack: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Ensemble spread, stdev with 1/(K-1) (enssprd_grd analogue)."""
    return torch.std(stack, dim=dim, correction=1)
