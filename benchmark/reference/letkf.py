"""Plain reference of the LETKF analysis at single gridpoints.

Written from the method (Hunt et al. 2007; SCALE-LETKF letkf_tools.f90
obs_local_cal and das_letkf, common_letkf.f90 letkf_core) and the
configuration's settings, in float64 PyTorch:

- the obs sorting mesh of each combined obs type and its capacity, cells
  over capacity thinned to every n/cap-th obs in obs order (the
  configuration's documented density approximation, letkf_obs.f90:660-855);
- Gaussian R-localization with the cut-off at 2·sqrt(10/3) normalized
  distances, horizontal and vertical, and the MAX_NOBS_PER_GRID nearest
  obs of each type;
- the K×K transform by a symmetric eigendecomposition: Pa = (HδXᵀR⁻¹HδX +
  (K-1)/ρ I)⁻¹, W = sqrt((K-1) Pa), w̄ = Pa HδXᵀR⁻¹d;
- relaxation to prior perturbations (RTPP) or spread (RTPS).

Selection is an order over distances, which rounding can break where two
distances tie at the cut or an obs sits on the cut-off, and QC is a
threshold; `select` reports such gridpoints, where the answer is not fixed
by the configuration to rounding, so that the comparison leaves them out.

`control=True` computes the transform the way a lower precision would: the
products with their operands rounded to TF32 (10-bit mantissa) and summed
in float32, the eigendecomposition in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DIST_ZERO_FAC = 2.0 * np.sqrt(10.0 / 3.0)
DIST_ZERO_FAC_SQ = DIST_ZERO_FAC * DIST_ZERO_FAC
SEL_TOL = 1e-4          # relative gap at the MAX_NOBS cut counted as a tie
CUT_TOL = 1e-4          # relative distance to the cut-off counted as on it


@dataclass
class Ctype:
    """One combined obs type: its obs ids entering the buckets (after
    thinning), scales and obs-number limit."""
    idx: np.ndarray
    hori: float
    vert: float
    vert_is_z: bool
    max_nobs: int


def sort_mesh(cutoff: float, max_nobs: int, min_spacing: float,
              grid_spacing: float, sort_spacing: float = 0.0):
    """(spacing, cap) of a type's sorting mesh: spacing from
    OBS_SORT_GRID_SPACING or 0.1·sqrt(MAX_NOBS)·OBS_MIN_SPACING within
    [cutoff/5, cutoff] and no finer than the grid; capacity twice the obs
    limit over the nsch² cells of one cut-off radius, at least 16."""
    if sort_spacing > 0:
        target = sort_spacing
    elif max_nobs > 0 and min_spacing > 0:
        target = 0.1 * np.sqrt(float(max_nobs)) * min_spacing
    else:
        target = cutoff
    spacing = max(float(np.clip(target, cutoff / 5.0, cutoff)), grid_spacing)
    nsch = max(1, int(np.ceil(cutoff / spacing)))
    cap = max(16, -(-2 * max_nobs // (nsch * nsch))) if max_nobs > 0 else 0
    return spacing, cap


def thin(x: np.ndarray, y: np.ndarray, x0: float, y0: float, x1: float,
         y1: float, spacing: float, cap: int) -> np.ndarray:
    """Mask of the obs kept in a mesh of `cap` per cell: in a cell of n > cap
    obs (taken in obs order) the p-th is kept where ⌊(p+1)·cap/n⌋ >
    ⌊p·cap/n⌋."""
    keep = np.ones(len(x), bool)
    if cap <= 0 or len(x) == 0:
        return keep
    nx = max(1, int(np.ceil((x1 - x0) / spacing)))
    ny = max(1, int(np.ceil((y1 - y0) / spacing)))
    ci = np.clip(((x - x0) / spacing).astype(np.int64), 0, nx - 1)
    cj = np.clip(((y - y0) / spacing).astype(np.int64), 0, ny - 1)
    cell = cj * nx + ci
    order = np.argsort(cell, kind="stable")
    counts = np.bincount(cell, minlength=nx * ny)
    first = np.zeros(nx * ny, np.int64)
    np.cumsum(counts[:-1], out=first[1:])
    pos = np.arange(len(x)) - first[cell[order]]
    n = counts[cell[order]]
    kept = ((pos + 1) * cap) // n > (pos * cap) // n
    keep[order] = kept | (n <= cap)
    return keep


def select(ctypes, ox, oy, overt, usable, doubtful, px, py, pvert_logp,
           pvert_z):
    """The local obs of B gridpoints: for each point the ids, localization
    weights and normalized squared distances of the selected obs of every
    type (lists of 1-D tensors), and whether the selection is fixed to
    rounding (`sure`, (B,) bool).

    ox, oy, overt (nobs,) float64 on the device; usable: the obs QC keeps;
    doubtful: obs whose QC outcome rounding could flip (they may or may not
    be usable). px, py, pvert_* (B,) float64."""
    B = px.shape[0]
    sure = torch.ones(B, dtype=torch.bool, device=px.device)
    parts = [[] for _ in range(B)]
    for ct in ctypes:
        ids = torch.as_tensor(ct.idx, device=px.device)
        if ids.numel() == 0:
            continue
        dx = px[:, None] - ox[ids][None]
        dy = py[:, None] - oy[ids][None]
        h2 = (dx * dx + dy * dy) / (ct.hori * ct.hori)
        del dx, dy
        pv = pvert_z if ct.vert_is_z else pvert_logp
        v2 = (((overt[ids][None] - pv[:, None]) / ct.vert) ** 2
              if ct.vert > 0 else torch.zeros_like(h2))
        d2 = h2 + v2
        inside = (h2 <= DIST_ZERO_FAC_SQ) & (v2 <= DIST_ZERO_FAC_SQ) & (
            d2 <= DIST_ZERO_FAC_SQ)
        # d2 >= h2, v2: only d2 decides whether an obs is inside
        near_cut = (d2 - DIST_ZERO_FAC_SQ).abs() <= CUT_TOL * DIST_ZERO_FAC_SQ
        use = usable[ids][None] & inside
        maybe = (doubtful[ids][None] & (inside | near_cut)) | (
            usable[ids][None] & near_cut)
        score = torch.where(use, d2, torch.inf)
        k = ct.max_nobs if ct.max_nobs > 0 else ids.numel()
        k = min(k, ids.numel())
        srt, pos = torch.sort(score, dim=1)
        # the worst distance that the cut keeps, and the first it leaves
        kth = srt[:, k - 1]
        nxt = srt[:, k] if k < ids.numel() else torch.full_like(kth, torch.inf)
        tie = torch.isfinite(nxt) & ((nxt - kth) <= SEL_TOL * (1.0 + kth))
        # a doubtful obs matters where it could rank within the cut
        reach = torch.where(torch.isfinite(nxt), nxt, torch.inf)
        doubt = (maybe & (d2 <= reach[:, None] * (1.0 + SEL_TOL)
                          + SEL_TOL)).any(dim=1)
        sure &= ~(tie | doubt)
        sel = pos[:, :k]
        ok = torch.isfinite(srt[:, :k])
        for b in range(B):
            take = sel[b][ok[b]]
            parts[b].append((ids[take], d2[b, take]))
        del h2, v2, d2, score, srt, pos
    out = []
    for b in range(B):
        if parts[b]:
            ids_b = torch.cat([p[0] for p in parts[b]])
            d2_b = torch.cat([p[1] for p in parts[b]])
        else:
            ids_b = torch.zeros(0, dtype=torch.long, device=px.device)
            d2_b = torch.zeros(0, dtype=torch.float64, device=px.device)
        out.append((ids_b, torch.exp(-0.5 * d2_b)))
    return out, sure


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to nearest on TF32's 10-bit mantissa."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x1000 + ((b >> 13) & 1) - 1) & ~0x1FFF
    return b.view(torch.float32)


def _mm(a, b, control: bool):
    if control:
        return _tf32(a) @ _tf32(b)
    return a @ b


def transform(hdxb, dep, err, rloc, xb, infl: float, *,
              rtpp: float = 0.0, rtps: float = 0.0, control: bool = False):
    """Analysis at B points: hdxb (B, L, K) ensemble H(x) perturbations of
    the selected obs (zero in the padding), dep (B, L), err (B, L) obs
    error stdevs, rloc (B, L) localization weights (0 in the padding), xb
    (B, V, K) the guess at the points. Returns (B, V, K)."""
    dtype = torch.float32 if control else torch.float64
    hdxb, dep, err, rloc, xb = (t.to(dtype) for t in (hdxb, dep, err, rloc,
                                                      xb))
    K = hdxb.shape[-1]
    mean = xb.mean(dim=-1, keepdim=True)
    pert = xb - mean
    w = torch.where(rloc > 0, rloc / (err * err), 0.0)
    hr = hdxb * w[..., None]                                   # R⁻¹ HδX
    gram = _mm(hr.transpose(1, 2), hdxb, control)
    gram.diagonal(dim1=1, dim2=2).add_((K - 1) / infl)
    lam, vec = torch.linalg.eigh(gram)
    pa = _mm(vec / lam[:, None, :], vec.transpose(1, 2), control)
    trans = _mm(vec * torch.sqrt((K - 1) / lam)[:, None, :],
                vec.transpose(1, 2), control)
    wbar = _mm(pa, _mm(hr.transpose(1, 2), dep[..., None], control),
               control)[..., 0]                                 # (B, K)
    upd_mean = _mm(pert, wbar[..., None], control)              # (B, V, 1)
    if rtps > 0:
        var_g = (pert * pert).sum(dim=-1)
        var_a = (pert * _mm(pert, pa, control)).sum(dim=-1)
        ok = (var_g > 0) & (var_a > 0)
        m = torch.where(ok, rtps * torch.sqrt(var_g / (torch.where(
            ok, var_a, 1.0) * (K - 1))) - rtps + 1.0, 1.0)
        upd = _mm(pert, trans, control) * m[..., None] + upd_mean
    else:
        if rtpp > 0:
            trans = ((1.0 - rtpp) * trans
                     + rtpp * torch.eye(K, dtype=dtype, device=trans.device))
        upd = _mm(pert, trans, control) + upd_mean
    return (mean + upd).to(torch.float64)


def padded(sel, n_max=None):
    """The selections of `select` as (ids (B, L), rloc (B, L)) padded with
    id 0 and weight 0."""
    L = max([len(i) for i, _ in sel] + [1]) if n_max is None else n_max
    B = len(sel)
    dev = sel[0][0].device
    ids = torch.zeros((B, L), dtype=torch.long, device=dev)
    rloc = torch.zeros((B, L), dtype=torch.float64, device=dev)
    for b, (i, r) in enumerate(sel):
        ids[b, :len(i)] = i
        rloc[b, :len(i)] = r
    return ids, rloc


def analyse(ctypes, ox, oy, overt, usable, doubtful, hdxb, dep, err, px, py,
            pvert_logp, pvert_z, xb, infl: float, *, rtpp: float = 0.0,
            rtps: float = 0.0, control: bool = False, chunk: int = 64):
    """The analysis (N, V, K) of N points with their guess xb (N, V, K),
    and `sure` (N,): whether each point's obs selection is fixed to
    rounding. hdxb (nobs, K), dep, err (nobs,) in obs space; the rest as
    `select` takes them."""
    outs, sures = [], []
    for b0 in range(0, px.shape[0], chunk):
        sl = slice(b0, b0 + chunk)
        sel, sure = select(ctypes, ox, oy, overt, usable, doubtful, px[sl],
                           py[sl], pvert_logp[sl], pvert_z[sl])
        ids, rloc = padded(sel)
        outs.append(transform(hdxb[ids], dep[ids], err[ids], rloc, xb[sl],
                              infl, rtpp=rtpp, rtps=rtps, control=control))
        sures.append(sure)
    return torch.cat(outs), torch.cat(sures)
