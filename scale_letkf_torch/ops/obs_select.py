"""Local observation selection: bucket grid + fixed-capacity candidate gather.

Port of scale_letkf_tpu/ops/obs_select.py (reference: letkf_obs.f90:660-855
bucket counting sort per combined obs type; letkf_tools.f90:1325-1759
obs_local rectangle search + QUICKSELECT top-k). The bucket tables are built
once per analysis on the host (numpy + the C++ counting sort); everything
per gridpoint runs as dense tensor gathers on the device:

  host:   obs (x, y) → (mesh_ny, mesh_nx, cap) int32 bucket table (-1 pad)
  device: gridpoint (x, y) → (2·nsch+1)² bucket neighborhood → candidate ids
          → vectorized obs_local_cal weights → torch.topk obs-number limit

The reference's TPU workarounds are left out: no bf16 pair-packed obs table
and no size gate choosing between sort payloads. The selection is a top-k
over the score, whose order within ties is unspecified, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scale_letkf_torch.ops.localization import DIST_ZERO_FAC_SQ, gauss_taper


@dataclass(frozen=True)
class BucketGrid:
    """Fixed-capacity obs bucket table for one combined obs type."""
    table: np.ndarray      # (mesh_ny, mesh_nx, cap) int32 obs indices, -1 pad
    x0: float              # mesh origin
    y0: float
    spacing_x: float
    spacing_y: float
    n_dropped: int         # obs dropped due to capacity overflow (0 normally)
    nsch: int = 1          # search halo in cells: the candidate gather scans
                           # (2·nsch+1)² cells, so nsch·spacing must cover the
                           # localization cutoff (the reference's ngrdsch,
                           # letkf_obs.f90:676-677)

    @property
    def mesh_shape(self):
        return self.table.shape[:2]


def bucket_sort_backend() -> str:
    """Which counting sort build_buckets runs: 'native' (the C++ library,
    built at first use) or 'numpy' (its fallback when no toolchain is
    available)."""
    from scale_letkf_torch.utils import native
    return "native" if native.load() is not None else "numpy"


def build_buckets(
    x: np.ndarray, y: np.ndarray,
    x0: float, y0: float, x1: float, y1: float,
    spacing: float,
    min_capacity: int = 4,
    max_capacity: int = 0,
    index_map: np.ndarray | None = None,
    nsch: int = 1,
) -> BucketGrid:
    """Host-side counting sort of obs into mesh cells
    (letkf_obs.f90:746-806 analogue). Capacity = max cell count (rounded up
    to a multiple of 4) so nothing is dropped unless min_capacity forces it.

    max_capacity > 0 bounds the per-cell capacity independently of the
    global max cell count — the memory-capacity analogue of the reference's
    incremental-radius obs-number limit (letkf_tools.f90:1479-1617): cells
    holding more obs are stratified-thinned (every n/cap-th obs in stable
    order, spatially unbiased for ray/file-ordered radar volumes) and the
    dropped count is reported in n_dropped.

    index_map: optional (nobs,) mapping from local to global obs ids,
    applied to the stored table entries."""
    nx = max(1, int(np.ceil((x1 - x0) / spacing)))
    ny = max(1, int(np.ceil((y1 - y0) / spacing)))

    n_prethinned = 0
    if max_capacity > 0 and len(x) > 0:
        # stratified pre-thinning of overflowing cells (vectorized)
        ci0 = np.clip(((x - x0) / spacing).astype(np.int64), 0, nx - 1)
        cj0 = np.clip(((y - y0) / spacing).astype(np.int64), 0, ny - 1)
        flat0 = cj0 * nx + ci0
        order = np.argsort(flat0, kind="stable")
        sf = flat0[order]
        counts = np.bincount(flat0, minlength=nx * ny)
        # position of each (sorted) obs within its cell
        first_of_cell = np.zeros(nx * ny, np.int64)
        np.cumsum(counts[:-1], out=first_of_cell[1:])
        pos = np.arange(len(x)) - first_of_cell[sf]
        n_cell = counts[sf]
        cap = max_capacity
        keep_sorted = ((pos + 1) * cap) // np.maximum(n_cell, 1) \
            > (pos * cap) // np.maximum(n_cell, 1)
        keep_sorted |= n_cell <= cap
        keep = np.zeros(len(x), bool)
        keep[order] = keep_sorted
        n_prethinned = int((~keep).sum())
        if n_prethinned:
            x = x[keep]
            y = y[keep]
            index_map = (index_map[keep] if index_map is not None
                         else np.nonzero(keep)[0].astype(np.int32))

    def _remap(table):
        if index_map is None:
            return table
        return np.where(table >= 0,
                        index_map[np.clip(table, 0, None)], -1).astype(
            np.int32)

    from scale_letkf_torch.utils import native
    lib = native.load()
    if lib is not None and len(x):
        import ctypes
        xd = np.ascontiguousarray(x, np.float64)
        yd = np.ascontiguousarray(y, np.float64)
        pd = ctypes.POINTER(ctypes.c_double)
        cap = lib.bucket_max_count(xd.ctypes.data_as(pd),
                                   yd.ctypes.data_as(pd), len(x),
                                   x0, y0, spacing, spacing, nx, ny)
        cap = -(-max(cap, min_capacity) // 4) * 4
        table = np.empty(ny * nx * cap, np.int32)
        dropped = lib.bucket_sort(
            xd.ctypes.data_as(pd), yd.ctypes.data_as(pd), len(x),
            x0, y0, spacing, spacing, nx, ny, cap,
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return BucketGrid(table=_remap(table.reshape(ny, nx, cap)),
                          x0=x0, y0=y0,
                          spacing_x=spacing, spacing_y=spacing,
                          n_dropped=int(dropped) + n_prethinned,
                          nsch=nsch)

    ci = np.clip(((x - x0) / spacing).astype(np.int64), 0, nx - 1)
    cj = np.clip(((y - y0) / spacing).astype(np.int64), 0, ny - 1)
    flat = cj * nx + ci
    counts = np.bincount(flat, minlength=nx * ny)
    cap = max(min_capacity, int(counts.max()) if len(x) else min_capacity)
    cap = -(-cap // 4) * 4
    table = np.full((ny * nx, cap), -1, np.int32)
    # vectorized counting sort: rank of each obs within its cell, in stable
    # order, fills the slots; ranks past the capacity are dropped
    order = np.argsort(flat, kind="stable")
    sf = flat[order]
    first_of_cell = np.zeros(nx * ny, np.int64)
    np.cumsum(counts[:-1], out=first_of_cell[1:])
    slot = np.arange(len(order)) - first_of_cell[sf]
    fits = slot < cap
    table[sf[fits], slot[fits]] = order[fits]
    dropped = int((~fits).sum())
    return BucketGrid(table=_remap(table.reshape(ny, nx, cap)),
                      x0=x0, y0=y0,
                      spacing_x=spacing, spacing_y=spacing,
                      n_dropped=dropped + n_prethinned,
                      nsch=nsch)


def _cell_offsets(nsch: int, size: int) -> list[int]:
    """Search offsets along one mesh axis. Offsets out of range for every
    gridpoint are skipped, so small domains keep a narrow candidate width
    instead of columns of -1 padding."""
    return [d for d in range(-nsch, nsch + 1) if -d < size and d < size]


def candidate_width(grid: BucketGrid) -> int:
    """Width of gather_candidates' output for this bucket grid."""
    ny, nx, cap = grid.table.shape
    return (len(_cell_offsets(grid.nsch, ny))
            * len(_cell_offsets(grid.nsch, nx)) * cap)


def gather_candidates(grid: BucketGrid, gx: torch.Tensor, gy: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """Candidate obs ids for each gridpoint from its (2·nsch+1)² bucket
    neighborhood (the reference's ngrdsch search rectangle).

    gx, gy: (B,) gridpoint coordinates in the bucket coordinate system.
    table: grid.table as a tensor on the gridpoints' device.
    Returns (B, candidate_width(grid)) int32 with -1 padding."""
    ny, nx, cap = table.shape
    ci = torch.floor((gx - grid.x0) / grid.spacing_x).to(torch.int64)
    cj = torch.floor((gy - grid.y0) / grid.spacing_y).to(torch.int64)
    flat_table = table.reshape(ny * nx, cap)
    dis = _cell_offsets(grid.nsch, nx)
    out = []
    for dj in _cell_offsets(grid.nsch, ny):
        jj = cj + dj
        in_j = (jj >= 0) & (jj < ny)
        jj = jj.clamp(0, ny - 1)
        for di in dis:
            ii = ci + di
            inside = in_j & (ii >= 0) & (ii < nx)
            vals = flat_table[jj * nx + ii.clamp(0, nx - 1)]     # (B, cap)
            out.append(vals.masked_fill_(~inside[:, None], -1))
    return torch.cat(out, dim=-1)


def local_weights(
    cand_idx: torch.Tensor,       # (B, C) candidate obs ids, -1 pad
    obs_x: torch.Tensor, obs_y: torch.Tensor,   # (nobs,) obs coords [m]
    obs_vert: torch.Tensor,       # (nobs,) ln p (conventional) or z (radar)
    obs_err: torch.Tensor,        # (nobs,) obs error stdev
    gp_x: torch.Tensor, gp_y: torch.Tensor,     # (B,) gridpoint coords [m]
    gp_vert: torch.Tensor,        # (B,) gridpoint ln p or z
    hori_scale: float,
    vert_scale: float,            # 0 => no vertical localization
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorized obs_local_cal (letkf_tools.f90:1793-1906).

    Returns (ndist2, rloc, rdiag) of shape (B, C); rejected or padded
    candidates get ndist2 = -1, rloc = 0 and rdiag = 1. rdiag is err²/rloc
    (the rdiag_wloc convention the reference uses)."""
    valid = cand_idx >= 0
    safe = cand_idx.clamp(min=0)
    dx = gp_x[:, None] - obs_x[safe]
    dy = gp_y[:, None] - obs_y[safe]
    nd_h2 = (dx * dx + dy * dy) / (hori_scale * hori_scale)
    del dx, dy
    if vert_scale > 0:
        nd_v = torch.abs(obs_vert[safe] - gp_vert[:, None]) / vert_scale
        nd_v2 = nd_v * nd_v
        del nd_v
    else:
        nd_v2 = torch.zeros_like(nd_h2)
    ndist2 = nd_h2 + nd_v2
    reject = ((~valid) | (nd_h2 > DIST_ZERO_FAC_SQ)
              | (nd_v2 > DIST_ZERO_FAC_SQ) | (ndist2 > DIST_ZERO_FAC_SQ))
    del nd_h2, nd_v2, valid
    rloc = gauss_taper(ndist2).masked_fill_(reject, 0.0)
    oe = obs_err[safe]
    has = rloc > 0
    rdiag = torch.where(has, oe * oe / torch.where(has, rloc, 1.0), 1.0)
    return ndist2.masked_fill_(reject, -1.0), rloc, rdiag


def limit_obs_topk(
    cand_idx: torch.Tensor,     # (B, C)
    ndist2: torch.Tensor,       # (B, C) -1 for rejected
    rloc: torch.Tensor,         # (B, C) 0 for rejected
    rdiag: torch.Tensor,        # (B, C)
    max_nobs: int,              # output capacity L (> 0)
    criterion: int = 1,         # 1: nearest 3-D distance, 2: largest rloc,
                                # 3: smallest rdiag (MAX_NOBS_PER_GRID_CRITERION)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select up to max_nobs obs per gridpoint by the configured criterion
    (reference: QUICKSELECT by distance/weight/variance,
    letkf_tools.f90:1614-1617,1694-1703), best first.

    Returns (idx, rloc, rdiag) of shape (B, max_nobs) with -1/0/1 padding."""
    bad = rloc <= 0
    if criterion == 2:
        score = -rloc
    elif criterion == 3:
        score = rdiag.clone()
    else:
        score = ndist2.clone()
    score.masked_fill_(bad, float("inf"))
    B, C = cand_idx.shape
    k = min(max_nobs, C)
    _, pos = torch.topk(score, k, dim=-1, largest=False, sorted=True)
    del score
    rloc_k = rloc.gather(-1, pos)
    keep = rloc_k > 0        # rejected/padded candidates carry rloc == 0
    idx_k = cand_idx.gather(-1, pos).masked_fill_(~keep, -1)
    rdiag_k = rdiag.gather(-1, pos).masked_fill_(~keep, 1.0)
    if max_nobs > k:
        pad = max_nobs - k
        idx_k = torch.nn.functional.pad(idx_k, (0, pad), value=-1)
        rloc_k = torch.nn.functional.pad(rloc_k, (0, pad), value=0.0)
        rdiag_k = torch.nn.functional.pad(rdiag_k, (0, pad), value=1.0)
    return idx_k, rloc_k, rdiag_k


def gather_obs_data(
    idx: torch.Tensor,           # (B, L) selected obs ids, -1 pad
    dep: torch.Tensor,           # (nobs,) departures
    ensval_pert: torch.Tensor,   # (nobs, K) ensemble H(x) perturbations
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather (dep (B, L), hdxb (B, L, K)) for the selected obs; padded
    slots get zeros (harmless: their rloc is 0, the letkf_core padding
    contract)."""
    K = ensval_pert.shape[-1]
    if ensval_pert.shape[0] == 0:
        # zero-obs analysis (common_letkf.f90:89 zero-obs branch)
        return (dep.new_zeros(idx.shape),
                ensval_pert.new_zeros(idx.shape + (K,)))
    invalid = idx < 0
    safe = idx.clamp(min=0)
    d = dep[safe].masked_fill_(invalid, 0.0)
    h = ensval_pert[safe].masked_fill_(invalid[..., None], 0.0)
    return d, h
