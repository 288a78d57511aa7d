"""The comparison that decides `correct`: where the program's answers are
read, and how far they lie from the reference's.

A gap is taken field by field: the largest |program − reference| over the
compared elements, over the field's scale of variation in the reference
(its largest deviation from the ensemble mean for an ensemble, from each
level's horizontal mean for a forecast field), so that an error the size
of a perturbation reads near 1 whatever the field's mean; the number is
the worst field's. Elements where the reference's answer is not fixed to
rounding (`sure` false) are left out; a field whose scale is zero reads 0
if the program's is exact, else infinity; a non-finite program value reads
infinity.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs import sub_seed
from benchmark.reference import model as M

RESTART = ("rho", "rhou", "rhov", "rhow", "rhot", "rhoq")


def gap(prog: dict, ref: dict, scale: dict,
        masks: dict | None = None) -> float:
    worst = 0.0
    for name, r in ref.items():
        p = prog[name].to(torch.float64).to(r.device)
        r = r.to(torch.float64)
        m = None if masks is None else masks.get(name)
        if m is not None:
            m = torch.broadcast_to(m.to(r.device), r.shape)
            p, r = p[m], r[m]
        if p.numel() == 0:
            continue
        if not bool(torch.isfinite(p).all()):
            return float("inf")
        num = float((p - r).abs().max())
        den = scale[name]
        worst = max(worst, num / den if den > 0 else
                    (0.0 if num == 0 else float("inf")))
    return worst


def member_scale(fields: dict) -> dict:
    """Each ensemble field's (K leading) largest deviation from its
    ensemble mean."""
    return {n: float((f - f.mean(dim=0)).abs().max())
            for n, f in fields.items()}


def level_scale(fields: dict) -> dict:
    """Each field's largest deviation from its levels' horizontal means."""
    return {n: float((f - f.mean(dim=(-2, -1), keepdim=True)).abs().max())
            for n, f in fields.items()}


def columns(seed: int, ny: int, nx: int, n: int, centre=None,
            radius: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """n distinct (j, i) columns drawn from the seed; with a radius (in
    cells), within it of centre (j, i)."""
    rng = np.random.default_rng(sub_seed(seed, 7))
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    ok = np.ones((ny, nx), bool)
    if radius > 0:
        ok = (jj - centre[0]) ** 2 + (ii - centre[1]) ** 2 <= radius ** 2
    flat = np.flatnonzero(ok)
    pick = rng.choice(flat, size=min(n, len(flat)), replace=False)
    return pick // nx, pick % nx


def site_sets(j: np.ndarray, i: np.ndarray, ny: int, nx: int):
    """The columns and their east and north neighbours (periodic): the
    points whose analyses make the restart state at the columns."""
    return [(j, i), (j, (i + 1) % nx), ((j + 1) % ny, i)]


def site_xy(sets, dom: dict) -> tuple[np.ndarray, np.ndarray]:
    """Projection coordinates of every level of site_sets' columns, in
    (set, level, column) order."""
    from benchmark.reference.obsop import grid_xy
    gx, gy = grid_xy(dom["nx"], dom["ny"], dom["dx"], dom["dy"])
    nz = dom["nz"]
    return (np.concatenate([np.tile(gx[i], nz) for _, i in sets]),
            np.concatenate([np.tile(gy[j], nz) for j, _ in sets]))


def restart_at(anal: torch.Tensor, sure: torch.Tensor, nz: int, P: int):
    """The restart fields at the columns from the analysis (N, NV, K) and
    `sure` (N,) of site_sets' points in (set, level, column) order: ρ, ρθ
    and the tracers from the column, ρu with the east and ρv with the
    north neighbour averaged to their faces, ρw to the interior z-faces.
    Returns (fields (K, ..., P), masks broadcastable to them, the share of
    points compared)."""
    K = anal.shape[-1]
    r = M.from_analysis(anal.reshape(3, nz, P, M.NV, K).permute(
        0, 4, 3, 1, 2)[..., None])[..., 0]                # (3, K, NV, nz, P)
    s0, se, sn = sure.reshape(3, nz, P)
    zeros = torch.zeros_like(r[0][:, 3, :1])
    rhow = torch.cat([zeros, 0.5 * (r[0][:, 3, 1:] + r[0][:, 3, :-1]), zeros],
                     dim=1)
    ends = torch.ones((1, P), dtype=torch.bool, device=s0.device)
    fields = {"rho": r[0][:, 0], "rhou": 0.5 * (r[0][:, 1] + r[1][:, 1]),
              "rhov": 0.5 * (r[0][:, 2] + r[2][:, 2]), "rhow": rhow,
              "rhot": r[0][:, 4]}
    masks = {"rho": s0, "rhou": s0 & se, "rhov": s0 & sn,
             "rhow": torch.cat([ends, s0[1:] & s0[:-1], ends]),
             "rhot": s0}
    for q in range(M.NQ):
        fields[f"rhoq{q}"] = r[0][:, 5 + q] * r[0][:, 0]
        masks[f"rhoq{q}"] = s0
    return fields, masks, float(sure.double().mean())


def program_at(state, j: np.ndarray, i: np.ndarray) -> dict:
    """The program's restart state (K leading) at the columns."""
    jt = torch.as_tensor(j, device=state.rho.device)
    it = torch.as_tensor(i, device=state.rho.device)
    out = {n: getattr(state, n)[..., jt, it].clone() for n in RESTART[:5]}
    rhoq = state.rhoq[..., jt, it]
    for q in range(M.NQ):
        out[f"rhoq{q}"] = rhoq[:, q].clone()
    return out


def variables(stack: torch.Tensor, axis: int = 0) -> dict:
    """A stack of variables as fields of their own."""
    return {f"v{v}": stack.select(axis, v) for v in range(stack.shape[axis])}
