"""Model state contract: restart variables ↔ analysis variables ↔ the
history view of the observation operators.

Port of scale_letkf_tpu/state.py (reference: common_scale.f90:36-51 variable
sets, state_trans at :1181-1226, state_trans_inv at :1229-1289,
state_to_history at :1292-1404). Layout (..., NV3D, nz, ny, nx), variables
stacked on the fourth axis from the end.

The transforms write into one preallocated output and accumulate the moist
sums tracer by tracer, so a full-size ensemble costs one extra copy of
itself plus a few single-variable temporaries, never a stacked copy.
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.constants import (
    CVDRY, FVIRT, GRAV, PRE00, PSAT0, RD, RV, T00, TETENS_A_LIQ, TETENS_B_LIQ,
    TRACER_CV,
)

# Restart (prognostic) stacking order: ρ, ρu, ρv, ρw, ρθ, q×6
IR_RHO, IR_RHOU, IR_RHOV, IR_RHOW, IR_RHOT = 0, 1, 2, 3, 4
IR_Q0 = 5
# Analysis (LETKF) stacking order: u, v, w, T, p, q×6
IA_U, IA_V, IA_W, IA_T, IA_P = 0, 1, 2, 3, 4
IA_Q0 = 5
NV3D = 11
NQ = 6
# SCALE's restart variable names (common_scale.f90:52-54), in restart order
V3D_RESTART_NAMES = ("DENS", "MOMX", "MOMY", "MOMZ", "RHOT",
                     "QV", "QC", "QR", "QI", "QS", "QG")
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


def relative_humidity(temp: torch.Tensor, pres: torch.Tensor,
                      qv: torch.Tensor) -> torch.Tensor:
    """RH [%] over liquid water (Tetens). The reference model leaves the
    history RH unfilled (common_scale.f90:1330 is commented out); the
    reference package diagnoses it so RH obs are assimilable."""
    es = PSAT0 * torch.exp(TETENS_A_LIQ * (temp - T00) / (temp - TETENS_B_LIQ))
    qs = 0.622 * es / torch.clamp(pres - 0.378 * es, min=1.0)
    return 100.0 * qv / qs


def state_to_history(anal: torch.Tensor, z_full: torch.Tensor,
                     topo: torch.Tensor | None = None, z0: float = 1.0e-2,
                     tsfc=None) -> dict[str, torch.Tensor]:
    """Analysis variables (..., NV3D, nz, ny, nx) → the obs operators' field
    view. 3-D: u, v, w, t, p, q, qc, qr, qi, qs, qg (views of anal), rh (the
    one new full field), hgt (z_full expanded); 2-D: topo (expanded; None is
    flat) and the surface diagnostics from the lowest level — ps
    (hydrostatic, level-1 virtual temperature), t2m (θ-conserving reduction
    to 2 m), u10m/v10m (neutral log profile), q2m (level-1 qv).

    tsfc: the slab skin temperature (..., ny, nx) of the physics suite
    (CycleDriver persists it across forecasts). When given, t2m, q2m, u10m
    and v10m come from model/surface.py's stability-corrected bulk surface
    layer (Louis scheme) instead of the neutral reductions."""
    names3d = ("u", "v", "w", "t", "p", "q", "qc", "qr", "qi", "qs", "qg")
    lead = anal.shape[:-4]
    f = {n: anal[..., i, :, :, :] for i, n in enumerate(names3d)}
    f["rh"] = relative_humidity(f["t"], f["p"], f["q"])
    f["hgt"] = z_full.expand(lead + z_full.shape)
    if topo is None:
        topo = z_full.new_zeros(z_full.shape[-2:])
    else:
        topo = torch.as_tensor(topo, dtype=z_full.dtype, device=z_full.device)
    f["topo"] = topo.expand(lead + topo.shape)

    t1 = f["t"][..., 0, :, :]
    p1 = f["p"][..., 0, :, :]
    qv1 = torch.clamp(f["q"][..., 0, :, :], min=0.0)
    z1 = torch.clamp(z_full[0] - topo, min=1.0)   # level-1 height above ground
    tv1 = t1 * (1.0 + FVIRT * qv1)
    kappa = RD / (RD + CVDRY)
    ps = p1 * torch.exp(GRAV * z1 / (RD * tv1))
    th1 = t1 * (PRE00 / p1) ** kappa
    p2m = ps * torch.exp(-GRAV * 2.0 / (RD * tv1))
    f["ps"] = ps
    f["t2m"] = th1 * (p2m / PRE00) ** kappa
    r10 = torch.clamp(np.log(10.0 / z0)
                      / torch.log(torch.clamp(z1, min=2.0 * z0) / z0),
                      0.0, 1.0)
    u1, v1 = f["u"][..., 0, :, :], f["v"][..., 0, :, :]
    f["u10m"] = u1 * r10
    f["v10m"] = v1 * r10
    f["q2m"] = qv1

    if tsfc is not None:
        from scale_letkf_torch.model.surface import surface_fluxes
        sf = surface_fluxes(u1, v1, t1, qv1, p1, p1 / (RD * tv1), z1,
                            torch.as_tensor(tsfc, dtype=t1.dtype,
                                            device=t1.device), ps, z0=z0)
        f.update(t2m=sf.t2, q2m=sf.q2, u10m=sf.u10, v10m=sf.v10)
    return f


def member_sum(stack: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The sum over the member axis `dim`, added in member order.
    Element-wise adds, so every point's sum has the same bits whatever the
    layout around it — the whole domain, a level, a batch of points, or a
    process grid's share of its columns (a reduction kernel's summation
    order depends on the tensor's shape)."""
    stack = stack.movedim(dim, 0)
    acc = stack[0].clone()
    for k in range(1, stack.shape[0]):
        acc += stack[k]
    return acc


def ensemble_mean(stack: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Ensemble mean over the member axis (ensmean_grd analogue):
    member_sum over K, the same bits in any layout."""
    return member_sum(stack, dim).div_(stack.shape[dim])


def ensemble_spread(stack: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Ensemble spread, stdev with 1/(K-1) (enssprd_grd analogue), two-pass
    about ensemble_mean, the squares summed in member order (as
    ensemble_mean, the same bits in any layout)."""
    stack = stack.movedim(dim, 0)
    mean = ensemble_mean(stack)
    acc = torch.zeros_like(mean)
    for k in range(stack.shape[0]):
        d = stack[k] - mean
        acc += d.mul_(d)
    return acc.div_(stack.shape[0] - 1).sqrt_()
