"""LETKF analysis: the batched das_letkf.

Port of scale_letkf_tpu/da/letkf.py (reference: scale/letkf/
letkf_tools.f90:50-932). Where the reference loops over gridpoints and
calls a scalar letkf_core per point, `analyze` loops over vertical levels
and, within a level, over chunks of gridpoints, each chunk one batch:

  per chunk: per-ctype candidate weights (vectorized obs_local_cal)
             → obs-number limit (top-k)
             → one gather of (dep, hdxb) shared by all var-local groups
             → batched K×K letkf_core per var-local group
             → RTPP/RTPS relaxation, boundary β damping, weight application
             → Q_UPDATE_TOP and the q-spread limiter (both per gridpoint)

Var-local dedup (letkf_tools.f90:129-163) is exact: the selection uses
factor-1 weights; within one ctype the factor is one constant, so it never
changes the per-ctype top-k order, and a factor of 0 removes the ctype,
which zeroing (rloc, dep, hdxb) after the shared gather reproduces.

Gridpoint chunks replace the reference's level batching and mesh sharding:
the chunk is sized so that its candidate arrays and gather take a fixed
share of the free device memory (gridpoint_chunk).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scale_letkf_torch.config import Config
from scale_letkf_torch.da.letkf_obs import ObsContext
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.io.convert import DeviceObsContext, obs_context_to_device
from scale_letkf_torch.ops.letkf_core import (
    letkf_core, weight_rtpp, weight_rtps, total_weight, relax_beta,
)
from scale_letkf_torch.ops.obs_select import (
    candidate_width, gather_candidates, local_weights, limit_obs_topk,
    gather_obs_data,
)
from scale_letkf_torch.state import IA_P, IA_Q0
from scale_letkf_torch.utils.device import full_fp32
from scale_letkf_torch.utils.timing import Timer, maybe_section

# Share of the free device memory (plus the allocator's cached blocks) that
# one gridpoint chunk's selection, gather and transform may take, and the
# budget used for CPU tensors.
CHUNK_MEMORY_SHARE = 0.5
CPU_CHUNK_BYTES = 1 << 30

# cfg.letkf.eigh_impl (the reference's solver names) → letkf_core solver
_SOLVER_OF_EIGH_IMPL = {"auto": "auto", "ns_pallas": "ns_kernel", "ns": "ns",
                        "lax": "eigh", "jacobi": "eigh"}


@dataclass
class AnalysisDiag:
    nobs_per_level: np.ndarray       # (nz,) mean local obs count
    infl_field: np.ndarray | None    # updated adaptive inflation (nz, ny, nx)
    rtps_field: np.ndarray | None    # (NV3D, nz, ny, nx) RTPS factor
                                     # (RELAX_SPREAD_OUT, letkf_tools.f90:735)
    nobs_field: np.ndarray | None = None  # (nz, ny, nx) local obs counts
                                          # (NOBS_OUT, letkf_tools.f90:763-798)
    chunk: int = 0                   # gridpoints per chunk (gridpoint_chunk)


@dataclass(frozen=True)
class _CtypePlan:
    hori_scale: float
    vert_scale: float
    vert_is_z: bool
    max_nobs: int


@dataclass(frozen=True)
class _Plan:
    """What the config and the obs context fix for the whole analysis."""
    ctypes: tuple[_CtypePlan, ...]
    group_vars: tuple[tuple[int, ...], ...]       # model vars per var-local group
    group_factors: tuple[tuple[float, ...], ...]  # per group, per ctype
    criterion: int
    adaptive: bool
    min_infl: float
    relax_alpha: float
    relax_alpha_spread: float
    relax_to_inflated_prior: bool
    relax_spread_out: bool
    boundary_buffer_width: float
    q_update_top: float
    q_sprd_max: float
    solver: str


def _make_plan(ctx: ObsContext, cfg: Config, nv: int) -> _Plan:
    # variable-localization groups: model variables sharing a column of the
    # var_local table share one transform (var_local_n2n dedup)
    vl_table = cfg.var_local.table(nv)            # (9, nv)
    cols = [tuple(float(x) for x in vl_table[:, v]) for v in range(nv)]
    unique_cols = list(dict.fromkeys(cols))
    eigh_impl = str(cfg.letkf.eigh_impl)
    if eigh_impl not in _SOLVER_OF_EIGH_IMPL:
        raise ValueError(f"unknown letkf.eigh_impl {eigh_impl!r}")
    return _Plan(
        ctypes=tuple(_CtypePlan(
            hori_scale=float(ct.hori_scale), vert_scale=float(ct.vert_scale),
            vert_is_z=(ct.vert_kind == "z"), max_nobs=int(ct.max_nobs))
            for ct in ctx.ctypes),
        group_vars=tuple(tuple(v for v in range(nv) if cols[v] == c)
                         for c in unique_cols),
        group_factors=tuple(tuple(col[ct.varlocal_group] for ct in ctx.ctypes)
                            for col in unique_cols),
        criterion=int(cfg.letkf_obs.max_nobs_per_grid_criterion),
        adaptive=bool(cfg.letkf.infl_mul_adaptive or cfg.letkf.infl_mul <= 0),
        min_infl=float(cfg.letkf.infl_mul_min),
        relax_alpha=float(cfg.letkf.relax_alpha),
        relax_alpha_spread=float(cfg.letkf.relax_alpha_spread),
        relax_to_inflated_prior=bool(cfg.letkf.relax_to_inflated_prior),
        relax_spread_out=bool(cfg.letkf.relax_spread_out),
        boundary_buffer_width=float(cfg.letkf.boundary_buffer_width),
        q_update_top=float(cfg.letkf.q_update_top),
        q_sprd_max=float(cfg.letkf.q_sprd_max),
        solver=_SOLVER_OF_EIGH_IMPL[eigh_impl],
    )


def gridpoint_chunk(B: int, cand_width: int, sel_width: int, K: int,
                    device: torch.device) -> int:
    """Gridpoints per chunk: as many as fit CHUNK_MEMORY_SHARE of the free
    device memory (CPU_CHUNK_BYTES for the CPU), at a conservative 16 bytes
    per candidate (id, distance, rloc, rdiag) and 16 bytes per selected
    obs and member (gather, R⁻¹-weighted copy, masked copy, products)."""
    per_gp = 16 * cand_width + 16 * sel_width * (K + 1)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        free += (torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))
        budget = CHUNK_MEMORY_SHARE * free
    else:
        budget = CPU_CHUNK_BYTES
    return int(max(1, min(B, budget // per_gp)))


def _select(plan: _Plan, dctx: DeviceObsContext, gp_x, gp_y, logp, z):
    """Shared local-obs selection of one chunk (factor-1 weights + top-k):
    (idx, rloc, rdiag) of shape (Bc, L) and the per-ctype widths of L."""
    parts = []
    for ic, cp in enumerate(plan.ctypes):
        cand = gather_candidates(dctx.ctypes[ic].buckets, gp_x, gp_y,
                                 dctx.tables[ic])
        nd2, rloc, rdiag = local_weights(
            cand, dctx.x, dctx.y, dctx.vert, dctx.err, gp_x, gp_y,
            z if cp.vert_is_z else logp, cp.hori_scale, cp.vert_scale)
        if cp.max_nobs > 0:
            parts.append(limit_obs_topk(cand, nd2, rloc, rdiag, cp.max_nobs,
                                        plan.criterion))
        else:
            parts.append((cand.masked_fill_(rloc <= 0, -1), rloc, rdiag))
    if not parts:    # no usable obs types: one all-padded slot
        Bc = gp_x.shape[0]
        return (torch.full((Bc, 1), -1, dtype=torch.int32,
                           device=gp_x.device),
                gp_x.new_zeros((Bc, 1)), gp_x.new_ones((Bc, 1)), [1])
    idx, rloc, rdiag = (torch.cat(p, dim=-1) for p in zip(*parts))
    return idx, rloc, rdiag, [p[0].shape[-1] for p in parts]


def _group_inputs(facs, widths, rloc0, rdiag0, dep_l, hdxb_l):
    """One var-local group's (rloc, rdiag, dep, hdxb): the shared selection
    scaled by the group's per-ctype factors, factor-0 slots zeroed."""
    if not facs or all(f == 1.0 for f in facs):
        return rloc0, rdiag0, dep_l, hdxb_l
    fac = torch.cat([torch.full((w,), f, dtype=rloc0.dtype,
                                device=rloc0.device)
                     for w, f in zip(widths, facs)])
    rloc_g = rloc0 * fac
    sel = rloc_g > 0
    rdiag_g = torch.where(sel, rdiag0 / torch.clamp(fac, min=1e-30), 1.0)
    dep_g = dep_l.masked_fill(~sel, 0.0)
    hdxb_g = hdxb_l.masked_fill(~sel[..., None], 0.0)
    return rloc_g, rdiag_g, dep_g, hdxb_g


def _q_limits(plan: _Plan, anal_q, pert_q, mean_c):
    """Q_UPDATE_TOP (keep the guess moisture where the mean p is below
    Q_UPDATE_TOP, letkf_tools.f90:371) and the q-spread limiter
    (letkf_tools.f90:500-513), in place on anal_q (NQ, Bc, K); both act
    per gridpoint. pert_q (NQ, Bc, K) and mean_c (nv, Bc) are the guess
    perturbations and mean."""
    if plan.q_update_top > 0:
        keep = (mean_c[IA_P] < plan.q_update_top)[None, :, None]
        gues_q = pert_q + mean_c[IA_Q0:, :, None]
        anal_q.copy_(torch.where(keep, gues_q, anal_q))
    if plan.q_sprd_max > 0:
        q = anal_q[0]                                   # qv (Bc, K)
        K = q.shape[-1]
        q_mean = q.mean(dim=-1, keepdim=True)
        q_pert = q - q_mean
        q_sprd = (torch.sqrt(torch.sum(q_pert ** 2, dim=-1, keepdim=True)
                             / (K - 1))
                  / torch.clamp(torch.abs(q_mean), min=1e-30))
        scale = torch.where(q_sprd > plan.q_sprd_max,
                            plan.q_sprd_max / torch.clamp(q_sprd, min=1e-30),
                            1.0)
        anal_q[0] = q_mean + q_pert * scale


@full_fp32()
def analyze(
    gues: torch.Tensor,            # (K, NV3D, nz, ny, nx) analysis variables
    ctx: ObsContext,
    cfg: Config,
    grid: Grid,
    z_full: torch.Tensor,          # (nz, ny, nx) heights
    infl_field: torch.Tensor | None = None,   # (nz, ny, nx); None → INFL_MUL
    *,
    device: torch.device,
    gues_det: torch.Tensor | None = None,
    addi_ens: torch.Tensor | None = None,
    mesh=None,
    timer: Timer | None = None,
) -> tuple[torch.Tensor, AnalysisDiag]:
    """Analysis update of the ensemble `gues` on `device`. Returns (anal,
    diag): anal a new (K, NV3D, nz, ny, nx) tensor, diag on the host.
    timer, when given, gets the sections 'level', 'select', 'gather',
    'gram', 'solve', 'weights' and 'apply'. Float32 products run in full
    FP32 whatever matmul precision the caller set (full_fp32)."""
    if gues_det is not None:
        raise NotImplementedError(
            "deterministic member: not ported yet (ROADMAP queue 1, the "
            "deterministic member and da/inflation.py)")
    if addi_ens is not None or cfg.letkf.infl_add > 0:
        raise NotImplementedError(
            "additive inflation: not ported yet (ROADMAP queue 1, the "
            "deterministic member and da/inflation.py)")
    if mesh is not None:
        raise NotImplementedError(
            "multi-device mesh: not ported yet (ROADMAP queue 1, "
            "parallel/)")
    if gues.device != device:
        raise ValueError(f"gues is on {gues.device}, analysis on {device}")
    if cfg.letkf.relax_spread_out and cfg.letkf.relax_alpha_spread == 0.0:
        raise ValueError("RELAX_SPREAD_OUT requires RELAX_ALPHA_SPREAD")
    K, nv, nz, ny, nx = gues.shape
    dtype = gues.dtype
    B = ny * nx
    plan = _make_plan(ctx, cfg, nv)
    dctx = obs_context_to_device(ctx, device, dtype)

    def host(a):
        return torch.as_tensor(np.ascontiguousarray(a).reshape(-1),
                               dtype=dtype, device=device)

    # gridpoint coordinates in projection space, in the analysis dtype (the
    # bucket-cell floor sees the same float32 coordinates as the reference)
    xs, ys = grid.xy
    xx = np.broadcast_to(xs[None, :], (ny, nx))
    yy = np.broadcast_to(ys[:, None], (ny, nx))
    gp_x, gp_y = host(xx), host(yy)
    dist_bdy = host(np.minimum(np.minimum(xx - xs[0], xs[-1] - xx),
                               np.minimum(yy - ys[0], ys[-1] - yy)))
    z_zb = z_full.to(device=device, dtype=dtype).reshape(nz, B)
    if infl_field is None:
        infl0 = torch.full((nz, B), cfg.letkf.infl_mul, dtype=dtype,
                           device=device)
    else:
        infl0 = infl_field.to(device=device, dtype=dtype).reshape(nz, B)

    g = gues.reshape(K, nv, nz, B)
    # preallocated and written chunk by chunk, so the peak is the guess, this
    # output and one chunk's working set; within a chunk the mean is added
    # and the padding zeroed in place, on buffers nothing else holds
    anal = torch.empty_like(g)
    infl_out = infl0.clone() if plan.adaptive else None
    nobs_out = torch.empty((nz, B), dtype=torch.int32, device=device)
    rtps_out = (torch.ones((nv, nz, B), dtype=dtype, device=device)
                if plan.relax_spread_out else None)

    cand_w = sum(candidate_width(ct.buckets) for ct in ctx.ctypes)
    sel_w = sum(cp.max_nobs if cp.max_nobs > 0
                else candidate_width(ct.buckets)
                for cp, ct in zip(plan.ctypes, ctx.ctypes)) or 1
    chunk = gridpoint_chunk(B, cand_w, sel_w, K, device)
    use_rtps = plan.relax_alpha == 0.0 and plan.relax_alpha_spread != 0.0

    for lev in range(nz):
        with maybe_section(timer, "level"):
            g_l = g[:, :, lev]                          # (K, nv, B) view
            mean_l = g_l.mean(dim=0)                    # (nv, B)
            logp_l = torch.log(torch.clamp(mean_l[IA_P], min=1e-3))
        for b0 in range(0, B, chunk):
            sl = slice(b0, min(B, b0 + chunk))
            infl_c = infl0[lev, sl]
            with maybe_section(timer, "select"):
                if plan.boundary_buffer_width > 0:
                    beta = relax_beta(dist_bdy[sl], z_zb[lev, sl],
                                      buffer_width=plan.boundary_buffer_width)
                else:
                    beta = torch.ones_like(infl_c)
                idx, rloc0, rdiag0, widths = _select(
                    plan, dctx, gp_x[sl], gp_y[sl], logp_l[sl], z_zb[lev, sl])
                nobs_out[lev, sl] = torch.sum(rloc0 > 0, dim=-1,
                                              dtype=torch.int32)
            with maybe_section(timer, "gather"):
                dep_l, hdxb_l = gather_obs_data(idx, dctx.dep, dctx.hdxb)
                del idx
            mean_c = mean_l[:, sl]                                # (nv, Bc)
            pert = (g_l[:, :, sl] - mean_c[None]).permute(1, 2, 0)  # (nv,Bc,K)
            parm = infl_c if plan.relax_to_inflated_prior \
                else torch.ones_like(infl_c)
            anal_c = torch.empty_like(pert)
            for gi, vidx in enumerate(plan.group_vars):
                rloc_g, rdiag_g, dep_g, hdxb_g = _group_inputs(
                    plan.group_factors[gi], widths, rloc0, rdiag0, dep_l,
                    hdxb_l)
                res = letkf_core(hdxb_g, rdiag_g, rloc_g, dep_g, infl_c,
                                 rdiag_wloc=True,
                                 infl_update=plan.adaptive and gi == 0,
                                 min_infl=max(plan.min_infl, 0.0),
                                 solver=plan.solver, timer=timer)
                del rloc_g, rdiag_g, dep_g, hdxb_g
                if gi == 0 and plan.adaptive:
                    infl_out[lev, sl] = res.infl
                with maybe_section(timer, "apply"):
                    vi = list(vidx)
                    pert_g = pert[vi]                             # (nvg,Bc,K)
                    if use_rtps:
                        # RTPS is per variable (xb = that variable's perts)
                        trans_v, m_g = weight_rtps(
                            res.trans, res.pao, pert_g, parm,
                            plan.relax_alpha_spread)
                        w_tot = total_weight(trans_v, res.transm, beta)
                        upd = torch.einsum("vbk,vbkm->vbm", pert_g, w_tot)
                        if rtps_out is not None:
                            for j, v in enumerate(vi):
                                rtps_out[v, lev, sl] = m_g[j]
                    else:
                        trans = (weight_rtpp(res.trans, parm, plan.relax_alpha)
                                 if plan.relax_alpha != 0.0 else res.trans)
                        w_tot = total_weight(trans, res.transm, beta)
                        upd = torch.einsum("vbk,bkm->vbm", pert_g, w_tot)
                    anal_c[vi] = upd.add_(mean_c[vi][..., None])
            with maybe_section(timer, "apply"):
                _q_limits(plan, anal_c[IA_Q0:], pert[IA_Q0:], mean_c)
                anal[:, :, lev, sl] = anal_c.permute(2, 0, 1)

    nobs_np = nobs_out.cpu().numpy()
    diag = AnalysisDiag(
        nobs_per_level=nobs_np.mean(axis=1),
        infl_field=(infl_out.reshape(nz, ny, nx).cpu().numpy()
                    if plan.adaptive else None),
        rtps_field=(rtps_out.reshape(nv, nz, ny, nx).cpu().numpy()
                    if rtps_out is not None else None),
        nobs_field=(nobs_np.reshape(nz, ny, nx).astype(np.float64)
                    if cfg.letkf.nobs_out else None),
        chunk=chunk)
    return anal.reshape(K, nv, nz, ny, nx), diag
