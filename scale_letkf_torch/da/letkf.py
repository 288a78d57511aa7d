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
             → deterministic-member update (transmd weights)
  post:      additive inflation (da/inflation.py), one member at a time

A context carrying a good mask (DeviceObsContext.good, the fused cycle's
in-graph QC, da/fastcycle.py) zeroes the weight of its bad candidates
before the top-k, so they neither take selection slots nor touch the
transform (reference da/letkf.py:294-301).

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
from typing import NamedTuple

import numpy as np
import torch

from scale_letkf_torch.config import Config
from scale_letkf_torch.da import inflation
from scale_letkf_torch.da.letkf_obs import ObsContext
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.io.convert import DeviceObsContext, obs_context_to_device
from scale_letkf_torch.obs.types import ID_RADAR_REF
from scale_letkf_torch.ops.letkf_core import (
    det_increment, letkf_core, relax_beta, rtps_factor, rtps_update,
    total_weight, weight_rtpp, weight_update,
)
from scale_letkf_torch.ops.obs_select import (
    candidate_width, gather_candidates, local_weights, limit_obs_topk,
    gather_obs_data,
)
from scale_letkf_torch.state import (
    IA_P, IA_Q0, ensemble_mean, ensemble_spread,
)
from scale_letkf_torch.utils.device import full_fp32
from scale_letkf_torch.utils.timing import Timer, maybe_section

# Share of the free device memory (plus the allocator's cached blocks) that
# one gridpoint chunk's selection, gather and transform may take, and the
# budget used for CPU tensors.
CHUNK_MEMORY_SHARE = 0.5
CPU_CHUNK_BYTES = 1 << 30

# cfg.letkf.eigh_impl (the reference's solver names) → letkf_core solver
_SOLVER_OF_EIGH_IMPL = {"auto": "auto", "ns_pallas": "ns_kernel", "ns": "ns",
                        "lax": "eigh", "jacobi": "jacobi"}


@dataclass
class AnalysisDiag:
    nobs_per_level: np.ndarray       # (nz,) mean local obs count
    infl_field: np.ndarray | None    # updated adaptive inflation (nz, ny, nx)
    rtps_field: np.ndarray | None    # (NV3D, nz, ny, nx) RTPS factor
                                     # (RELAX_SPREAD_OUT, letkf_tools.f90:735)
    nobs_field: np.ndarray | None = None  # (nz, ny, nx) local obs counts
                                          # (NOBS_OUT, letkf_tools.f90:763-798)
    chunk: int = 0                   # gridpoints per chunk (gridpoint_chunk)
    anal_det: torch.Tensor | None = None  # (NV3D, nz, ny, nx) analysed
                                          # deterministic member, on the
                                          # analysis device (DET_RUN)
    # under a process grid (analyze(mesh=)): the guess and analysis
    # ensemble means and spreads (NV3D, nz, ny, nx) on the analysis device,
    # taken where each gridpoint holds all K members, and (points, chunk)
    # of each of this process's shares
    stats: dict | None = None
    share_chunks: list | None = None


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
        if dctx.good is not None:   # padded candidates carry rloc 0 already
            rloc.masked_fill_(~dctx.good[cand.clamp(min=0)], 0.0)
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


def _group_inputs(facs, widths, rloc0, rdiag0, dep_l, hdxb_l, depd_l=None):
    """One var-local group's (rloc, rdiag, dep, hdxb, depd): the shared
    selection scaled by the group's per-ctype factors, factor-0 slots
    zeroed (depd None stays None)."""
    if not facs or all(f == 1.0 for f in facs):
        return rloc0, rdiag0, dep_l, hdxb_l, depd_l
    fac = torch.cat([torch.full((w,), f, dtype=rloc0.dtype,
                                device=rloc0.device)
                     for w, f in zip(widths, facs)])
    rloc_g = rloc0 * fac
    sel = rloc_g > 0
    rdiag_g = torch.where(sel, rdiag0 / torch.clamp(fac, min=1e-30), 1.0)
    dep_g = dep_l.masked_fill(~sel, 0.0)
    hdxb_g = hdxb_l.masked_fill(~sel[..., None], 0.0)
    depd_g = None if depd_l is None else depd_l.masked_fill(~sel, 0.0)
    return rloc_g, rdiag_g, dep_g, hdxb_g, depd_g


def _gather(idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """values (nobs,) at the selected ids idx (Bc, L), zero in the padding."""
    if values.shape[0] == 0:
        return values.new_zeros(idx.shape)
    return values[idx.clamp(min=0)].masked_fill_(idx < 0, 0.0)


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


def chunk_for(plan: _Plan, ctx, B: int, K: int,
              device: torch.device) -> int:
    """gridpoint_chunk of a block of B gridpoints, from the widths of the
    obs context's (host or device) candidate tables and of the selection
    (max_nobs per ctype, the candidate width where unlimited)."""
    cand_w = sum(candidate_width(ct.buckets) for ct in ctx.ctypes)
    sel_w = sum(cp.max_nobs if cp.max_nobs > 0
                else candidate_width(ct.buckets)
                for cp, ct in zip(plan.ctypes, ctx.ctypes)) or 1
    return gridpoint_chunk(B, cand_w, sel_w, K, device)


def gridpoint_coords(grid: Grid, device: torch.device, dtype: torch.dtype):
    """(gp_x, gp_y, dist_bdy), each (ny·nx,) in `dtype` on `device`: the
    gridpoints' projection coordinates (the bucket-cell floor sees the same
    float32 coordinates as the reference) and their distance to the
    nearest lateral edge."""
    ny, nx = grid.ny, grid.nx

    def host(a):
        return torch.as_tensor(np.ascontiguousarray(a).reshape(-1),
                               dtype=dtype, device=device)

    xs, ys = grid.xy
    xx = np.broadcast_to(xs[None, :], (ny, nx))
    yy = np.broadcast_to(ys[:, None], (ny, nx))
    return host(xx), host(yy), host(
        np.minimum(np.minimum(xx - xs[0], xs[-1] - xx),
                   np.minimum(yy - ys[0], ys[-1] - yy)))


class PointsResult(NamedTuple):
    anal: torch.Tensor               # (K, nv, nz, B)
    infl: torch.Tensor | None        # (nz, B) when adaptive
    nobs: torch.Tensor               # (nz, B) int32 local obs counts
    rtps: torch.Tensor | None        # (nv, nz, B) under RELAX_SPREAD_OUT
    anal_det: torch.Tensor | None    # (nv, nz, B) with a det member
    chunk: int                       # gridpoints per chunk


def analyze_points(plan: _Plan, dctx: DeviceObsContext,
                   members: torch.Tensor, mean: torch.Tensor | None,
                   infl0: torch.Tensor, gp_x: torch.Tensor,
                   gp_y: torch.Tensor, dist_bdy: torch.Tensor,
                   z: torch.Tensor, *, det: torch.Tensor | None = None,
                   timer: Timer | None = None) -> PointsResult:
    """The LETKF update of a block of B gridpoints (any set: the whole
    domain for `analyze`, a row tile for the tile executors), level by
    level and, within a level, in chunks sized from the device memory
    left once the outputs exist (chunk_for).

    members (K, nv, nz, B): the ensemble when `mean` is None (its mean is
    taken level by level), else its perturbations about `mean` (nv, nz, B).
    infl0 and z (nz, B): the prior multiplicative inflation and the
    heights; gp_x, gp_y, dist_bdy (B,): the gridpoints' coordinates
    (gridpoint_coords); det (nv, nz, B): a deterministic member, analysed
    with the transmd weights of dctx.depd. timer, when given, gets the
    sections 'select', 'gather', 'gram', 'solve', 'weights' and 'apply'.

    Returns a PointsResult."""
    K, nv, nz, B = members.shape
    dtype, device = members.dtype, members.device
    # preallocated and written chunk by chunk, so the peak is the input,
    # this output and one chunk's working set; within a chunk the mean is
    # added and the padding zeroed in place, on buffers nothing else holds
    anal = torch.empty_like(members)
    infl_out = infl0.clone() if plan.adaptive else None
    nobs_out = torch.empty((nz, B), dtype=torch.int32, device=device)
    rtps_out = (torch.ones((nv, nz, B), dtype=dtype, device=device)
                if plan.relax_spread_out else None)
    anal_det = None if det is None else torch.empty_like(det)
    chunk = chunk_for(plan, dctx, B, K, device)
    use_rtps = plan.relax_alpha == 0.0 and plan.relax_alpha_spread != 0.0
    # each var-local group's variables as a slice where they are
    # consecutive, else an index tensor made once: indexing by a Python
    # list would copy it from the host, and wait for the device, per chunk
    groups = [slice(v[0], v[-1] + 1) if v == tuple(range(v[0], v[-1] + 1))
              else torch.as_tensor(v, device=device)
              for v in plan.group_vars]

    for lev in range(nz):
        g_l = members[:, :, lev]                        # (K, nv, B) view
        mean_l = ensemble_mean(g_l) if mean is None else mean[:, lev]
        logp_l = torch.log(torch.clamp(mean_l[IA_P], min=1e-3))
        for b0 in range(0, B, chunk):
            sl = slice(b0, min(B, b0 + chunk))
            infl_c = infl0[lev, sl]
            with maybe_section(timer, "select"):
                if plan.boundary_buffer_width > 0:
                    beta = relax_beta(dist_bdy[sl], z[lev, sl],
                                      buffer_width=plan.boundary_buffer_width)
                else:
                    beta = torch.ones_like(infl_c)
                idx, rloc0, rdiag0, widths = _select(
                    plan, dctx, gp_x[sl], gp_y[sl], logp_l[sl], z[lev, sl])
                nobs_out[lev, sl] = torch.sum(rloc0 > 0, dim=-1,
                                              dtype=torch.int32)
            with maybe_section(timer, "gather"):
                dep_l, hdxb_l = gather_obs_data(idx, dctx.dep, dctx.hdxb)
                depd_l = None if det is None else _gather(idx, dctx.depd)
                del idx
            mean_c = mean_l[:, sl]                                # (nv, Bc)
            pert = (g_l[:, :, sl] if mean is not None
                    else g_l[:, :, sl] - mean_c[None]).permute(1, 2, 0)
            parm = infl_c if plan.relax_to_inflated_prior \
                else torch.ones_like(infl_c)
            anal_c = torch.empty_like(pert)
            for gi, vidx in enumerate(plan.group_vars):
                rloc_g, rdiag_g, dep_g, hdxb_g, depd_g = _group_inputs(
                    plan.group_factors[gi], widths, rloc0, rdiag0, dep_l,
                    hdxb_l, depd_l)
                res = letkf_core(hdxb_g, rdiag_g, rloc_g, dep_g, infl_c,
                                 rdiag_wloc=True,
                                 infl_update=plan.adaptive and gi == 0,
                                 depd=depd_g,
                                 min_infl=max(plan.min_infl, 0.0),
                                 solver=plan.solver, timer=timer)
                del rloc_g, rdiag_g, dep_g, hdxb_g, depd_g
                if gi == 0 and plan.adaptive:
                    infl_out[lev, sl] = res.infl
                with maybe_section(timer, "apply"):
                    vi = groups[gi]
                    pert_g = pert[vi]                             # (nvg,Bc,K)
                    if use_rtps:
                        # RTPS is per variable (xb = that variable's perts)
                        m_g = rtps_factor(res.pao, pert_g, parm,
                                          plan.relax_alpha_spread)
                        upd = rtps_update(pert_g, res.trans, res.transm,
                                          beta, m_g)
                        if rtps_out is not None:
                            for j, v in enumerate(vidx):
                                rtps_out[v, lev, sl] = m_g[j]
                    else:
                        trans = (weight_rtpp(res.trans, parm, plan.relax_alpha)
                                 if plan.relax_alpha != 0.0 else res.trans)
                        w_tot = total_weight(trans, res.transm, beta)
                        upd = weight_update(pert_g, w_tot)
                    anal_c[vi] = upd.add_(mean_c[vi][..., None])
                    if det is not None:
                        # det + β·Σ_k Xb'_k transmd_k (letkf_tools.f90:489-497)
                        incr = det_increment(pert_g, res.transmd)
                        anal_det[vi, lev, sl] = (det[vi, lev, sl]
                                                 + incr * beta[None])
            with maybe_section(timer, "apply"):
                _q_limits(plan, anal_c[IA_Q0:], pert[IA_Q0:], mean_c)
                anal[:, :, lev, sl] = anal_c.permute(2, 0, 1)
    return PointsResult(anal, infl_out, nobs_out, rtps_out, anal_det, chunk)


@full_fp32()
def analyze(
    gues,                          # (K, NV3D, nz, ny, nx), or Sharded blocks
    ctx: ObsContext,
    cfg: Config,
    grid: Grid,
    z_full: torch.Tensor,          # (nz, ny, nx) heights
    infl_field: torch.Tensor | None = None,   # (nz, ny, nx); None → INFL_MUL
    *,
    device: torch.device,
    gues_det: torch.Tensor | None = None,
    addi_ens: torch.Tensor | None = None,
    rng: np.random.Generator | None = None,
    mesh=None,
    timer: Timer | None = None,
):
    """Analysis update of the ensemble `gues` on `device`. Returns (anal,
    diag): anal a new (K, NV3D, nz, ny, nx) tensor, diag on the host but
    for diag.anal_det.

    gues_det (NV3D, nz, ny, nx): the deterministic member (DET_RUN,
    letkf_tools.f90:489-497), analysed with the transmd weights of the
    obs context's depd into diag.anal_det. addi_ens (K, NV3D, nz, ny, nx),
    on the device or on the host: the additive-inflation source ensemble,
    required when INFL_ADD > 0 (da/inflation.py; rng shuffles its members
    under INFL_ADD_SHUFFLE, default_rng(0) when None).

    mesh: a process grid (parallel/mesh.py). gues is then a Sharded of
    (K/n_member, NV3D, nz, ny_b, nx_b) blocks in the forecast layout (or
    the global ensemble, sharded here), consumed (its dict emptied) once
    transposed, and anal a Sharded in the same layout. The 'ensemble
    transpose' (the reference's da/letkf.py:141-183, layout ('dy', 'dx',
    'member')): each spatial block's gridpoints are split over its member
    slabs by an all-to-all along the member axis only, each block analyses
    its share for all K members, and the inverse all-to-all brings the
    analysis back. Per-gridpoint outputs (inflation, obs counts, RTPS
    factor, the deterministic member, and the ensemble means and spreads
    in diag.stats) are gathered onto every process. Without a mesh the
    whole domain is the one share.

    timer, when given, gets the sections 'select', 'gather', 'gram',
    'solve', 'weights', 'apply' and 'addi', and under a mesh 'transpose'
    and 'collect'. Float32 products run in full FP32 whatever
    matmul precision the caller set (full_fp32)."""
    _check_inputs(cfg, ctx, addi_ens, gues_det)
    if mesh is not None:
        from scale_letkf_torch.parallel.mesh import Sharded
        if not isinstance(gues, Sharded):
            gues = mesh.shard_ensemble(gues)
        K, proto = gues.K, next(iter(gues.blocks.values()))
    else:
        K, proto = gues.shape[0], gues
    if proto.device != device:
        raise ValueError(f"gues is on {proto.device}, analysis on {device}")
    nv, nz = proto.shape[1:3]
    ny, nx = grid.ny, grid.nx
    dtype = proto.dtype
    B = ny * nx
    plan = _make_plan(ctx, cfg, nv)
    dctx = obs_context_to_device(ctx, device, dtype)
    gp_x, gp_y, dist_bdy = gridpoint_coords(grid, device, dtype)
    z_zb = z_full.to(device=device, dtype=dtype).reshape(nz, B)
    if infl_field is None:
        infl0 = torch.full((nz, B), cfg.letkf.infl_mul, dtype=dtype,
                           device=device)
    else:
        infl0 = infl_field.to(device=device, dtype=dtype).reshape(nz, B)
    det = (None if gues_det is None
           else gues_det.to(device=device, dtype=dtype).reshape(nv, nz, B))
    addi = None
    if cfg.letkf.infl_add > 0:
        weight, shuffle = _addi_weight_shuffle(cfg, ctx, gp_x, gp_y, rng,
                                               K, dtype)
        addi = addi_ens.reshape(K, nv, nz, B)
    if mesh is not None:
        with maybe_section(timer, "transpose"):
            shares = mesh.to_points(gues)
            gues.blocks.clear()
        points = {b: mesh.share_index(b, ny, nx, shares[b].device)
                  for b in shares}
    else:
        shares, points = {0: gues.reshape(K, nv, nz, B)}, {0: slice(None)}
    stats = ("gues_mean", "gues_sprd", "anal_mean", "anal_sprd")
    outs: dict[str, dict] = {k: {} for k in (
        "infl", "nobs", "rtps", "det") + stats}
    chunks = []
    for b in list(shares):
        pts = points[b]
        g = shares.pop(b)
        gues_mean = None
        if mesh is not None or (addi is not None
                                and cfg.letkf.infl_add_q_ratio):
            gues_mean = ensemble_mean(g)
        if mesh is not None:
            outs["gues_mean"][b] = gues_mean
            outs["gues_sprd"][b] = ensemble_spread(g)
        res = analyze_points(
            plan, dctx, g, None, infl0[:, pts], gp_x[pts], gp_y[pts],
            dist_bdy[pts], z_zb[:, pts],
            det=None if det is None else det[..., pts], timer=timer)
        anal = res.anal
        del g
        if addi is not None:
            with maybe_section(timer, "addi"):
                inflation.apply_additive_inflation(
                    anal, addi[..., pts if isinstance(pts, slice)
                               else pts.to(addi.device)],
                    cfg.letkf.infl_add, shuffle=shuffle,
                    weight=None if weight is None else weight[pts],
                    q_ratio=cfg.letkf.infl_add_q_ratio, gues_mean=gues_mean)
        shares[b] = anal
        if mesh is not None:
            outs["anal_mean"][b] = ensemble_mean(anal)
            outs["anal_sprd"][b] = ensemble_spread(anal)
        outs["nobs"][b] = res.nobs
        for k, v in (("infl", res.infl), ("rtps", res.rtps),
                     ("det", res.anal_det)):
            if v is not None:
                outs[k][b] = v
        chunks.append((anal.shape[-1], res.chunk))
    if mesh is not None:
        with maybe_section(timer, "transpose"):
            anal = mesh.from_points(shares, K, ny, nx)
            shares.clear()
        with maybe_section(timer, "collect"):
            glob = {k: mesh.gather_points(v, ny, nx) if v else None
                    for k, v in outs.items()}
    else:
        anal = shares.pop(0).reshape(K, nv, nz, ny, nx)
        glob = {k: v.get(0) for k, v in outs.items()}
    nobs_np = glob["nobs"].cpu().numpy()
    diag = AnalysisDiag(
        nobs_per_level=nobs_np.mean(axis=1),
        infl_field=(glob["infl"].reshape(nz, ny, nx).cpu().numpy()
                    if plan.adaptive else None),
        rtps_field=(glob["rtps"].reshape(nv, nz, ny, nx).cpu().numpy()
                    if glob["rtps"] is not None else None),
        nobs_field=(nobs_np.reshape(nz, ny, nx).astype(np.float64)
                    if cfg.letkf.nobs_out else None),
        chunk=min(c for _, c in chunks),
        anal_det=(None if glob["det"] is None
                  else glob["det"].reshape(nv, nz, ny, nx)),
        stats=(None if mesh is None else
               {k: glob[k].reshape(nv, nz, ny, nx) for k in stats}),
        share_chunks=None if mesh is None else chunks)
    return anal, diag


def _check_inputs(cfg: Config, ctx: ObsContext, addi_ens, gues_det):
    if cfg.letkf.relax_spread_out and cfg.letkf.relax_alpha_spread == 0.0:
        raise ValueError("RELAX_SPREAD_OUT requires RELAX_ALPHA_SPREAD")
    if cfg.letkf.infl_add > 0 and addi_ens is None:
        raise ValueError(
            "INFL_ADD > 0 requires an additive-inflation ensemble "
            "(addi_ens; reference INFL_ADD_IN_BASENAME files)")
    if gues_det is not None and ctx.depd is None:
        raise ValueError("a deterministic member needs the obs context's "
                         "depd (build_obs_context(..., ensval_det=))")


def _addi_weight_shuffle(cfg: Config, ctx: ObsContext, gp_x, gp_y, rng,
                         K: int, dtype):
    """The additive inflation's INFL_ADD_REF_ONLY weight (B,) from the radar
    reflectivity obs (zero without them; None when not asked for) and its
    INFL_ADD_SHUFFLE member permutation (None when not asked for)."""
    weight = None
    if cfg.letkf.infl_add_ref_only:
        ref_ct = [ct for ct in ctx.ctypes if ct.elem == ID_RADAR_REF]
        if ref_ct:
            ct = ref_ct[0]
            weight = inflation.radar_proximity_weight(
                gp_x, gp_y, ctx.x[ct.obs_idx], ctx.y[ct.obs_idx],
                ct.hori_scale, buckets=ct.buckets, obs_x_all=ctx.x,
                obs_y_all=ctx.y)
        else:
            weight = torch.zeros_like(gp_x)
        weight = weight.to(dtype)
    shuffle = (inflation.knuth_shuffle(rng or np.random.default_rng(0), K)
               if cfg.letkf.infl_add_shuffle else None)
    return weight, shuffle
