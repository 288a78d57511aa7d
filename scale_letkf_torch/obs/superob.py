"""Super-observation (thinning/averaging) preprocessing.

Port of scale_letkf_tpu/obs/superob.py, numpy on the host as there, with
the port's own obs/types.py and grid.py. Equivalent of the reference's offline superobbing tool (reference:
scale/obs/superob.f90:1-14 + superob_tools.f90 — its documented pipeline is
"1. general removal, 2. vertical superob (multi-level platforms),
3. temporal superob, 4. all-grid (horizontal+vertical) superob"; legacy
GFS-era, not built in the reference's SCALE binaries but part of its
radar-DA toolchain). Dense volumes are averaged into one observation per
group per variable, reducing obs counts and representativeness error
before assimilation.

All four stages are provided, vectorized NumPy (host-side preprocessing,
like the bucket sort):

  general_removal   — drop configured (report type, variable) pairs
  superob_vertical  — average multi-level data within a platform column
  superob_temporal  — average repeated reports of one (place, level)
                      within a time window
  superob_radar     — (elem, x, y, z)-box average of a dense volume

`superob` chains them in the reference's order.
"""

from __future__ import annotations

import numpy as np

from scale_letkf_torch.obs.types import Observations
from scale_letkf_torch.grid import Grid

UNDEF = -9.99e33


def _group_average(obs: Observations, key: np.ndarray,
                   min_count: int) -> Observations:
    """Average obs fields per unique key row. err follows the
    error-of-the-mean convention with a representativeness floor of half
    the mean original error."""
    uniq, inv, counts = np.unique(key, axis=0, return_inverse=True,
                                  return_counts=True)
    n = len(uniq)

    def group_mean(v):
        out = np.zeros(n)
        np.add.at(out, inv, v)
        return out / counts

    keep = counts >= min_count
    return Observations(
        elem=np.rint(group_mean(obs.elem)).astype(np.int32)[keep],
        lon=group_mean(obs.lon)[keep],
        lat=group_mean(obs.lat)[keep],
        lev=group_mean(obs.lev)[keep],
        dat=group_mean(obs.dat)[keep],
        err=np.maximum(group_mean(obs.err)[keep] / np.sqrt(counts[keep]),
                       0.5 * group_mean(obs.err)[keep]),
        typ=np.rint(group_mean(obs.typ)).astype(np.int32)[keep],
        dif=group_mean(obs.dif)[keep],
        meta=obs.meta.copy())


def general_removal(obs: Observations,
                    drop: "list[tuple[int, int]]") -> Observations:
    """Stage 1: remove observations of the listed (report type, obs id)
    pairs (reference obmethod_g = 1, superob.f90:117-121). An entry of -1
    wildcards that slot: (typ, -1) drops the whole report type."""
    keep = np.ones(obs.nobs, bool)
    for typ, elem in drop:
        m = np.ones(obs.nobs, bool)
        if typ >= 0:
            m &= obs.typ == typ
        if elem >= 0:
            m &= obs.elem == elem
        keep &= ~m
    return obs.select(keep)


def superob_vertical(obs: Observations, box_z: float,
                     min_count: int = 1,
                     vert_is_pressure: bool = False) -> Observations:
    """Stage 2: vertical superobbing of multi-level platforms — average
    obs of the same variable at the SAME horizontal position (one
    sounding / one radar beam column) into vertical boxes of box_z
    ([m], or [Pa] with vert_is_pressure) (superob.f90 "vertical (only
    valid for multi-level observations) superob")."""
    z = obs.lev
    gk = np.floor(z / box_z).astype(np.int64)
    key = np.stack([obs.elem.astype(np.int64), obs.typ.astype(np.int64),
                    np.asarray(obs.lon, np.float64).view(np.int64),
                    np.asarray(obs.lat, np.float64).view(np.int64), gk],
                   axis=1)
    return _group_average(obs, key, min_count)


def superob_temporal(obs: Observations, box_t: float,
                     min_count: int = 1,
                     box_z_key: float = 0.0) -> Observations:
    """Stage 3: temporal superobbing — average repeated reports of one
    (variable, type, position, level) within time boxes of box_t seconds
    over the obs time offset dif (superob.f90 "temporal superob").

    box_z_key > 0 groups levels by vertical box index floor(lev/box_z_key)
    instead of bit-exact lev: after a preceding vertical-superob stage, lev
    holds data-dependent box MEANS that rarely bit-match across time
    windows, which would silently degrade the temporal merge to a no-op."""
    gt = np.floor(obs.dif / box_t).astype(np.int64)
    if box_z_key > 0:
        gl = np.floor(obs.lev / box_z_key).astype(np.int64)
    else:
        gl = np.asarray(obs.lev, np.float64).view(np.int64)
    key = np.stack([obs.elem.astype(np.int64), obs.typ.astype(np.int64),
                    np.asarray(obs.lon, np.float64).view(np.int64),
                    np.asarray(obs.lat, np.float64).view(np.int64),
                    gl, gt], axis=1)
    return _group_average(obs, key, min_count)


def superob_radar(
    obs: Observations,
    grid: Grid,
    box_xy: float,            # horizontal box size [m]
    box_z: float,             # vertical box size [m]
    min_count: int = 1,
) -> Observations:
    """Stage 4: average obs per (elem, x-box, y-box, z-box).

    The superob position is the data-weighted mean position; value and
    error follow the reference's averaging convention (mean value; error of
    the mean with a representativeness floor of the original error)."""
    x, y = grid.proj.lonlat_to_xy(obs.lon, obs.lat)
    x = np.asarray(x)
    y = np.asarray(y)
    gi = np.floor(x / box_xy).astype(np.int64)
    gj = np.floor(y / box_xy).astype(np.int64)
    gk = np.floor(obs.lev / box_z).astype(np.int64)
    key = np.stack([obs.elem.astype(np.int64), gi, gj, gk], axis=1)
    return _group_average(obs, key, min_count)


def superob(obs: Observations, grid: Grid,
            drop: "list[tuple[int, int]] | None" = None,
            box_z_vertical: float = 0.0,
            box_t: float = 0.0,
            box_xy: float = 0.0, box_z: float = 0.0,
            min_count: int = 1,
            min_count_vertical: int = 1,
            min_count_temporal: int = 1) -> Observations:
    """The reference pipeline in order (superob.f90:1-14): general removal
    → vertical → temporal → grid. Stages with a non-positive box are
    skipped.

    min_count applies to the GRID (radar-box) stage; the vertical and
    temporal stages take their own thresholds (default 1) so a radar-box
    threshold does not prune singleton reports in the earlier stages.
    When both the vertical and temporal stages run, the temporal merge
    keys levels by the vertical box index (lev holds box means after
    stage 2, which rarely bit-match across time windows)."""
    if drop:
        obs = general_removal(obs, drop)
    if box_z_vertical > 0:
        obs = superob_vertical(obs, box_z_vertical, min_count_vertical)
    if box_t > 0:
        obs = superob_temporal(obs, box_t, min_count_temporal,
                               box_z_key=box_z_vertical)
    if box_xy > 0 and box_z > 0:
        obs = superob_radar(obs, grid, box_xy, box_z, min_count)
    return obs
