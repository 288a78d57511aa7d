"""Additive covariance inflation.

Port of scale_letkf_tpu/da/inflation.py (reference: the additive-inflation
stage of das_letkf, scale/letkf/letkf_tools.f90:804-929): a source
ensemble (the INFL_ADD_IN_BASENAME files) is mean-removed, optionally
member-shuffled (Knuth_Shuffle, common/common_rand.f90:14), optionally
weighted by proximity to radar reflectivity obs and by the moisture mean
(q ratio), scaled by INFL_ADD and added to the analysis ensemble.

The reference forms the whole perturbation and increment ensembles; here
the increment is added in place one member at a time, so that the stage
costs a few member-sized fields on the device: the source's mean, one
member's increment and, for a host source, its upload. The source ensemble
may lie on the device or on the host, one member uploaded at a time (from
pinned memory without a staging copy).
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.ops.localization import DIST_ZERO_FAC_SQ
from scale_letkf_torch.ops.obs_select import gather_candidates
from scale_letkf_torch.state import IA_Q0


def knuth_shuffle(rng: np.random.Generator, k: int) -> np.ndarray:
    """Fisher–Yates member permutation (Knuth_Shuffle analogue); draws from
    rng exactly as the reference does."""
    idx = np.arange(k)
    for i in range(k - 1, 0, -1):
        j = int(rng.integers(0, i + 1))
        idx[i], idx[j] = idx[j], idx[i]
    return idx


def radar_proximity_weight(
    gp_x: torch.Tensor, gp_y: torch.Tensor,   # (B,) gridpoint coords
    ref_x: np.ndarray, ref_y: np.ndarray,     # radar-reflectivity obs coords
    hori_scale: float,
    buckets=None,                             # the ctype's BucketGrid
    obs_x_all: np.ndarray | None = None,      # global obs coords when the
    obs_y_all: np.ndarray | None = None,      # buckets hold global ids
) -> torch.Tensor:
    """INFL_ADD_REF_ONLY weight (B,), float64 on the gridpoints' device:
    Gaussian of the distance to the nearest radar reflectivity obs, zero
    beyond the localization cutoff (letkf_tools.f90:814-836). With
    `buckets` (spacing ≥ the cutoff) the nearest obs is searched among the
    bucket neighbourhood's candidates (gather_candidates), which is exact:
    every obs inside the cutoff lies there; without them, over all pairs."""
    dev = gp_x.device
    if len(ref_x) == 0:
        return torch.zeros(gp_x.shape, dtype=torch.float64, device=dev)
    gx, gy = gp_x.double(), gp_y.double()
    if buckets is not None:
        ox = torch.as_tensor(np.asarray(
            obs_x_all if obs_x_all is not None else ref_x), device=dev)
        oy = torch.as_tensor(np.asarray(
            obs_y_all if obs_y_all is not None else ref_y), device=dev)
        cand = gather_candidates(buckets, gp_x, gp_y,
                                 torch.as_tensor(buckets.table, device=dev))
        safe = cand.clamp(min=0).long()
        d2 = (gx[:, None] - ox[safe]) ** 2 + (gy[:, None] - oy[safe]) ** 2
        d2 = d2.masked_fill_(cand < 0, float("inf"))
    else:
        rx = torch.as_tensor(np.asarray(ref_x, np.float64), device=dev)
        ry = torch.as_tensor(np.asarray(ref_y, np.float64), device=dev)
        d2 = (gx[:, None] - rx[None]) ** 2 + (gy[:, None] - ry[None]) ** 2
    nd2 = d2.amin(dim=1) / (hori_scale * hori_scale)
    w = torch.exp(-0.5 * torch.clamp(nd2, max=700.0))
    return w.masked_fill_(nd2 > DIST_ZERO_FAC_SQ, 0.0)


def apply_additive_inflation(
    anal: torch.Tensor,       # (K, NV3D, nz, ny, nx) analysis variables
    add_ens: torch.Tensor,    # (K, NV3D, nz, ny, nx) source, device or host
    infl_add: float,
    *,
    shuffle: np.ndarray | None = None,       # member permutation
    weight: torch.Tensor | None = None,      # (ny, nx) spatial weight
    q_ratio: bool = False,
    gues_mean: torch.Tensor | None = None,   # (NV3D, nz, ny, nx), for q_ratio
) -> torch.Tensor:
    """anal_m += INFL_ADD · w(x) · [q̄ for moisture] · (add_{shuf(m)} −
    mean(add)), in place on anal, which is returned. The mean is the
    members' sum in member order times float32(1/K), the reference's
    arithmetic."""
    if q_ratio and gues_mean is None:
        raise ValueError("q_ratio requires gues_mean")
    K = anal.shape[0]
    dev, dtype = anal.device, anal.dtype

    def member(m):
        src = add_ens[m]
        if src.device != dev:
            # pinned host memory uploads straight from its pages
            return src.to(dev, dtype, non_blocking=True)
        return src.to(dtype)

    mean = member(0).clone()
    for m in range(1, K):
        mean += member(m)
    # XLA turns the reference's division by K into this product
    mean *= float(np.float32(1.0 / K))
    scale = torch.tensor(infl_add, dtype=dtype, device=dev)
    if weight is not None:
        scale = scale * weight.to(device=dev, dtype=dtype)
    for m in range(K):
        j = int(shuffle[m]) if shuffle is not None else m
        incr = member(j) - mean
        incr.mul_(scale)
        if q_ratio:
            incr[IA_Q0:].mul_(gues_mean[IA_Q0:])
        anal[m] += incr
        del incr
    return anal
