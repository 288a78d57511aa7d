"""Batched LETKF ensemble-transform core (Hunt et al. 2007).

Port of scale_letkf_tpu/ops/letkf_core.py (reference:
common/common_letkf.f90:52-257). All leading dimensions are batch
dimensions: one row per gridpoint.

Padding convention (replaces the reference's variable `nobsl`): each row
carries a fixed-capacity obs dimension L; unused slots must have rloc == 0
(and finite rdiag > 0). Every observation enters the algebra only through
hdxbᵀR⁻¹·rloc or dep²/r·rloc terms, so such slots contribute exactly zero,
including nobsl == 0: the shifted Gram matrix is then ((K-1)/ρ)·I, whose
transform is sqrt(ρ)·I — the reference's zero-obs branch
(common_letkf.f90:89-107).

Solvers for the K×K inverse square root (`solver=`):
  'ns_kernel' — the fused Newton–Schulz iteration (ops/invsqrt.py
                invsqrt_ns): the CUDA kernel on a CUDA tensor, its plain
                torch version on a CPU tensor; float32, K ≤ 128
  'ns'        — the plain coupled Newton–Schulz iteration
  'eigh'      — torch.linalg.eigh (the reference's 'lax'), EIGH_MAX_BATCH
                matrices a call
  'jacobi'    — the parallel cyclic Jacobi eigensolver (ops/eigh_jacobi.py),
                even K
  'auto'      — AUTO_SMALL_K_SOLVER for even K ≤ 16, 'ns_kernel' for
                float32 with K ≤ 128, else 'ns' (letkf_core.py:90-97 of the
                reference, whose choice at K ≤ 16 is its Jacobi)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scale_letkf_torch.ops.eigh_jacobi import eigh_jacobi
from scale_letkf_torch.ops.invsqrt import invsqrt_newton_schulz, invsqrt_ns
from scale_letkf_torch.state import member_sum
from scale_letkf_torch.utils.device import full_fp32
from scale_letkf_torch.utils.timing import Timer, maybe_section

# Error stdev of the inflation parameter in the adaptive-inflation Kalman
# filter (Miyoshi 2011): the reference constant sigma_b (common_letkf.f90:79).
SIGMA_B_INFL = 0.04

SOLVERS = ("auto", "ns_kernel", "ns", "eigh", "jacobi")
# 'auto''s solver at even K ≤ 16: the faster of 'jacobi' and 'eigh' on the
# card (chip_smoke.py's `jacobi` phase, PERF.md §5)
AUTO_SMALL_K_SOLVER = "eigh"
# Matrices per torch.linalg.eigh call: cuSOLVER's batched eigensolver
# refuses one 18-km level (172,800 Grams) with CUSOLVER_STATUS_INVALID_VALUE
# and takes 16,384 (chip_smoke.py's `jacobi` phase on an NVIDIA H100 80GB
# HBM3 at 700.00 W)
EIGH_MAX_BATCH = 16384
# Columns of the departure block that (HδX)ᵀR⁻¹ and Pa multiply: the
# departures (and the deterministic member's) as columns of an 8-wide
# block, zeros beside them. cuBLAS sums a batched matrix-vector product's
# obs in an order set by the batch count, so a gridpoint's w̄ moved with
# the chunk or grid share it was analysed in; its matrix-matrix product of
# 8 columns gives each matrix the same bits in any batch of 7 or more
# (gpu_check.batch_invariance, run by chip_smoke.py's mesh_checks on an
# NVIDIA H100 80GB HBM3 at 700.00 W)
DEP_COLUMNS = 8


def _eigh(gram: torch.Tensor):
    """torch.linalg.eigh of (..., K, K) in calls of at most EIGH_MAX_BATCH
    matrices."""
    K = gram.shape[-1]
    flat = gram.reshape(-1, K, K)
    if flat.shape[0] <= EIGH_MAX_BATCH:
        return torch.linalg.eigh(gram)
    parts = [torch.linalg.eigh(flat[b0:b0 + EIGH_MAX_BATCH])
             for b0 in range(0, flat.shape[0], EIGH_MAX_BATCH)]
    return (torch.cat([w for w, _ in parts]).reshape(gram.shape[:-1]),
            torch.cat([v for _, v in parts]).reshape(gram.shape))


class LetkfResult(NamedTuple):
    trans: torch.Tensor     # (..., K, K) perturbation transform W
    transm: torch.Tensor    # (..., K)    mean-update weight w̄
    pao: torch.Tensor       # (..., K, K) analysis covariance in ensemble space
    infl: torch.Tensor      # (...,)      updated inflation parameter
    transmd: torch.Tensor   # (..., K)    deterministic-member weight
                            #             (zeros when depd is not given)


def pick_solver(solver: str, K: int, dtype: torch.dtype) -> str:
    """Resolve 'auto' to a concrete solver."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown LETKF solver {solver!r}; one of {SOLVERS}")
    if solver != "auto":
        return solver
    if K <= 16 and K % 2 == 0:
        return AUTO_SMALL_K_SOLVER
    if K <= 128 and dtype == torch.float32:
        return "ns_kernel"
    return "ns"


@full_fp32()
def letkf_core(
    hdxb: torch.Tensor,        # (..., L, K) ensemble H(x) perturbations
    rdiag: torch.Tensor,       # (..., L)    obs error variances
    rloc: torch.Tensor,        # (..., L)    localization weights (0 = padded)
    dep: torch.Tensor,         # (..., L)    departures y - H(x̄)
    parm_infl: torch.Tensor,   # (...,)      multiplicative inflation parameter
    *,
    rdiag_wloc: bool = False,  # rdiag already includes /rloc (common_letkf.f90:111)
    infl_update: bool = False,
    depd: torch.Tensor | None = None,  # (..., L) deterministic-member departures
    min_infl: float = 0.0,
    solver: str = "auto",
    timer: Timer | None = None,
) -> LetkfResult:
    """LETKF transform for a batch of local analysis problems. The compute
    dtype follows the inputs. transmd = Pa (HδX)ᵀR⁻¹·depd, the weight of
    the deterministic member (letkf_tools.f90:489-497), when depd is given.
    timer, when given, gets the sections 'gram', 'solve' and 'weights'."""
    K = hdxb.shape[-1]
    dtype = hdxb.dtype
    km1 = K - 1
    solver = pick_solver(solver, K, dtype)

    with maybe_section(timer, "gram"):
        # R^{-1}·rloc weighting of the obs perturbations
        # (common_letkf.f90:111-123)
        w_r = 1.0 / rdiag if rdiag_wloc else rloc / rdiag
        hdxb_rinv = hdxb * w_r[..., None]
        # C = hdxbᵀ R⁻¹ hdxb + (K-1)/ρ I  (common_letkf.f90:127-143)
        gram = hdxb_rinv.transpose(-1, -2) @ hdxb
        shift = km1 / parm_infl
        gram.diagonal(dim1=-2, dim2=-1).add_(shift[..., None])

    with maybe_section(timer, "solve"):
        if solver == "ns_kernel":
            # the phase-1 eigenvalue floor uses the exact bound
            # λ_min(gram) ≥ (K-1)/ρ, the shift added above
            inv_sqrt, pao = invsqrt_ns(gram, shift)
            trans = inv_sqrt * km1 ** 0.5
        elif solver == "ns":
            inv_sqrt, pao = invsqrt_newton_schulz(gram)
            trans = inv_sqrt * km1 ** 0.5
        else:
            _, _, pao, trans = solve_eigh(gram, km1, solver == "jacobi")
        del gram

    with maybe_section(timer, "weights"):
        # w̄ = Pa (HδX)ᵀ R⁻¹ d (common_letkf.f90:169-187), obs dim first;
        # d and the deterministic member's d as columns of one block
        # (DEP_COLUMNS: the same bits in any batch)
        cols = dep.new_zeros(dep.shape + (DEP_COLUMNS,))
        cols[..., 0] = dep
        if depd is not None:
            cols[..., 1] = depd
        tm = pao @ (hdxb_rinv.transpose(-1, -2) @ cols)
        del cols
        transm = tm[..., 0]
        transmd = (tm[..., 1] if depd is not None
                   else torch.zeros_like(transm))

        # adaptive multiplicative inflation (Miyoshi 2011;
        # common_letkf.f90:233-254); rows without obs keep parm_infl
        if infl_update:
            if rdiag_wloc:
                p1 = torch.sum(dep * dep / rdiag, dim=-1)
            else:
                p1 = torch.sum(dep * dep / rdiag * rloc, dim=-1)
            p2 = torch.sum(hdxb_rinv * hdxb, dim=(-2, -1)) / km1
            p3 = torch.sum(rloc, dim=-1)
            has_obs = p3 > 0
            p2s = torch.where(has_obs, p2, 1.0)
            p3s = torch.where(has_obs, p3, 1.0)
            p4 = (p1 - p3s) / p2s - parm_infl
            sigma_o = 2.0 / p3s * ((parm_infl * p2s + p3s) / p2s) ** 2
            gain = SIGMA_B_INFL ** 2 / (sigma_o + SIGMA_B_INFL ** 2)
            new_infl = parm_infl + gain * p4
            if min_infl > 0:
                new_infl = torch.clamp(new_infl, min=min_infl)
            infl_out = torch.where(has_obs, new_infl, parm_infl)
        else:
            infl_out = parm_infl
    return LetkfResult(trans=trans, transm=transm, pao=pao, infl=infl_out,
                       transmd=transmd)


def solve_eigh(gram: torch.Tensor, km1: int, jacobi: bool = False):
    """The eigensolver path of letkf_core: (eigenvalues, eigenvectors, Pa,
    W) of the Grams (..., K, K) by torch.linalg.eigh, or the Jacobi
    (ops/eigh_jacobi.py) when `jacobi`; km1 = K − 1."""
    eival, eivec = eigh_jacobi(gram) if jacobi else _eigh(gram)
    # Pa = V Λ⁻¹ Vᵀ (common_letkf.f90:151-157)
    pao = (eivec / eival[..., None, :]) @ eivec.transpose(-1, -2)
    # W = V sqrt((K-1) Λ⁻¹) Vᵀ (common_letkf.f90:199)
    trans = ((eivec * torch.sqrt(km1 / eival)[..., None, :])
             @ eivec.transpose(-1, -2))
    return eival, eivec, pao, trans


def det_increment(pert: torch.Tensor, transmd: torch.Tensor) -> torch.Tensor:
    """The deterministic member's increment Σ_k Xb'_k·transmd_k
    (letkf_tools.f90:489-497) of several variables at once: pert (V, B, K),
    transmd (B, K); returns (V, B). Summed over the members in member
    order (member_sum), so a point has the same bits in any batch (the
    einsum over (v, b, k) did not: 784 of the 1,056 elements of 96 points
    at K = 50 took other bits, gpu_check.batch_invariance's det_einsum on
    an NVIDIA H100 80GB HBM3 at 700.00 W)."""
    return member_sum(pert * transmd, -1)


def _eye_like(K: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(K, dtype=ref.dtype, device=ref.device)


def total_weight(trans_rlx: torch.Tensor, transm: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
    """Total weight W' = (W_rlx + 1 w̄ᵀ)·β + (1-β)·I
    (letkf_tools.f90:472-477); w̄ is added along the row index k, the same
    for every analysis member column m."""
    K = trans_rlx.shape[-1]
    b = beta[..., None, None]
    w = (trans_rlx + transm[..., :, None]) * b
    return w + (1.0 - b) * _eye_like(K, trans_rlx)


def apply_weights(pert: torch.Tensor, mean: torch.Tensor,
                  w_total: torch.Tensor) -> torch.Tensor:
    """Analysis ensemble xa_m = x̄ + Σ_k Xb'_k W'_{km} (letkf_tools.f90:480-487).
    pert (..., K), mean (...), w_total (..., K, K)."""
    return mean[..., None] + (pert[..., None, :] @ w_total)[..., 0, :]


def weight_update(pert: torch.Tensor, w_total: torch.Tensor) -> torch.Tensor:
    """Σ_k Xb'_k W'_{km} of several variables at once: pert (V, B, K) —
    each variable's perturbations at B points — and w_total (B, K, K);
    returns (V, B, K). Computed as W'ᵀ·Xb'ᵀ per point, the form cuBLAS
    gives the same bits for a point in any batch (the einsum over (v, b, k)
    took another kernel for 96 of 4,096 points at K = 50:
    gpu_check.batch_invariance on an NVIDIA H100 80GB HBM3 at 700.00 W),
    with at least DEP_COLUMNS columns: fewer variables (a var-local group
    of one) are padded with zero ones, since one column made it a batched
    matrix-vector product, batch-dependent (17,569 of the 25,000 elements
    of 500 points at K = 50, batch_invariance's apply_1, same card)."""
    V = pert.shape[0]
    if V < DEP_COLUMNS:
        pert = torch.cat([pert, pert.new_zeros(
            (DEP_COLUMNS - V,) + pert.shape[1:])])
    upd = w_total.transpose(-1, -2) @ pert.permute(1, 2, 0).contiguous()
    return upd.permute(2, 0, 1)[:V]


def weight_rtpp(trans: torch.Tensor, infl: torch.Tensor,
                alpha: float) -> torch.Tensor:
    """Relaxation to prior perturbations, Zhang et al. 2004
    (letkf_tools.f90:1953-1968): W ← (1-α)·W + α·√infl·I."""
    K = trans.shape[-1]
    diag = alpha * torch.sqrt(infl)
    return ((1.0 - alpha) * trans
            + diag[..., None, None] * _eye_like(K, trans))


def rtps_factor(pao: torch.Tensor, xb: torch.Tensor, infl: torch.Tensor,
                alpha: float) -> torch.Tensor:
    """The RTPS factor m = α·sqrt(var_g·infl / (var_a·(K-1))) − α + 1 of
    each variable's perturbations xb (..., B, K) at B points, var_g =
    Σ_k xb_k², var_a = xbᵀ Pao xb (pao (B, K, K)); m = 1 where either
    variance is not positive (letkf_tools.f90:1971-2004). Pao·xb is
    weight_update's product, the sums over the members member_sum's: the
    same bits for a point in any batch."""
    K = pao.shape[-1]
    pa_xb = weight_update(xb.reshape(-1, *xb.shape[-2:]),
                          pao.transpose(-1, -2).contiguous()).reshape(
        xb.shape)
    var_g = member_sum(xb * xb, -1)
    var_a = member_sum(xb * pa_xb, -1)
    safe = (var_g > 0) & (var_a > 0)
    ratio = var_g * infl / (torch.where(safe, var_a, 1.0) * (K - 1))
    return torch.where(safe, alpha * torch.sqrt(ratio) - alpha + 1.0, 1.0)


def rtps_update(pert: torch.Tensor, trans: torch.Tensor,
                transm: torch.Tensor, beta: torch.Tensor,
                m: torch.Tensor) -> torch.Tensor:
    """Σ_k Xb'_k W'_{km} with each variable's RTPS weights W' =
    total_weight(W·m_v, w̄, β): β·m_v·(Xb'·W) + β·(Xb'·w̄) + (1 − β)·Xb'.
    pert (V, B, K), trans (B, K, K), transm (B, K), beta (B,), m (V, B);
    returns (V, B, K). Xb'·W is weight_update's product and Xb'·w̄ a
    member_sum, so a point has the same bits in any batch (the einsum over
    (v, b, k) of per-variable weights did not: gpu_check.batch_invariance
    on an NVIDIA H100 80GB HBM3 at 700.00 W)."""
    b = beta[:, None]
    return (weight_update(pert, trans) * (m[..., None] * b)
            + (member_sum(pert * transm, -1) * beta)[..., None]
            + (1.0 - b) * pert)


def relax_beta(dist_to_boundary: torch.Tensor, z: torch.Tensor, *,
               buffer_width: float = 0.0, radar_only: bool = False,
               radar_zmax: float = 99.0e3,
               vert_cutoff: float = 0.0) -> torch.Tensor:
    """Damping factor β for the lateral-boundary buffer and radar-top
    capping (letkf_tools.f90:1911-1948)."""
    beta = torch.ones_like(z)
    if buffer_width > 0.0:
        beta = torch.clamp(dist_to_boundary / buffer_width, 0.0, 1.0)
    if radar_only:
        beta = torch.where(z > radar_zmax + vert_cutoff, 0.0, beta)
    return beta
