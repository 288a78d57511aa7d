"""Lateral boundary forcing for limited-area runs (Davies relaxation).

Port of scale_letkf_tpu/model/boundary.py: within a buffer of `width`
cells from the lateral edges the prognostic fields are nudged toward a
time-interpolated boundary target with a cosine-shaped weight (Davies
1976). Over periodic stencils a relaxation buffer at least as wide as the
stencil leaves the wrap-around fluxes only boundary-relaxed values; a
nested child (nested.py) relaxes over open, edge-clamped ones.

A boundary target is shared by all members (its fields have the shape of
one member) or per member (a leading member axis). The boundary file is the
reference's npz format (two bracketing states under b0_* / b1_* and their
times), so either package's file loads in the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scale_letkf_torch.model.dycore import DycoreState


class BoundaryData(NamedTuple):
    """Boundary targets at two bracketing times (time-interpolated)."""
    state0: DycoreState
    state1: DycoreState
    t0: float
    t1: float


def relaxation_weight(ny: int, nx: int, width: int, tau: float,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """(ny, nx) Davies relaxation rate [1/s]: cosine ramp from 1/tau at the
    edge to 0 at `width` cells inside."""
    def ramp(n):
        d = np.minimum(np.arange(n), np.arange(n)[::-1]).astype(float)
        return np.where(d < width, 0.5 * (1 + np.cos(np.pi * d / width)), 0.0)
    w2 = np.maximum(ramp(nx)[None, :], ramp(ny)[:, None]) / tau
    return torch.as_tensor(w2, dtype=dtype, device=device)


def interp_boundary(bdy: BoundaryData, t: float) -> DycoreState:
    """The target at time t, linear between t0 and t1 and held beyond."""
    a = 0.0 if bdy.t1 == bdy.t0 else (t - bdy.t0) / (bdy.t1 - bdy.t0)
    a = min(max(a, 0.0), 1.0)
    return DycoreState(*((1.0 - a) * x0 + a * x1
                         for x0, x1 in zip(bdy.state0, bdy.state1)))


def apply_boundary_relaxation(s: DycoreState, target: DycoreState,
                              weight2d: torch.Tensor, dt: float
                              ) -> DycoreState:
    """Implicit nudging s ← (s + dt·w·target)/(1 + dt·w) in the buffer; the
    (ny, nx) weight broadcasts over the leading axes."""
    fac = dt * weight2d
    return DycoreState(*((x + fac * xt) / (1.0 + fac)
                         for x, xt in zip(s, target)))


def save_boundary(path, bdy: BoundaryData) -> None:
    """Boundary file: the two bracketing states and their times."""
    arrs = {}
    for tag, st in (("b0", bdy.state0), ("b1", bdy.state1)):
        for name, a in zip(DycoreState._fields, st):
            arrs[f"{tag}_{name}"] = (a.detach().cpu().numpy()
                                     if isinstance(a, torch.Tensor)
                                     else np.asarray(a))
    np.savez_compressed(path, t0=bdy.t0, t1=bdy.t1, **arrs)


def load_boundary(path, device: torch.device) -> BoundaryData:
    """A boundary file, its states as float32 tensors on `device`."""
    with np.load(path) as z:
        def state(tag):
            return DycoreState(*(torch.as_tensor(
                z[f"{tag}_{n}"], dtype=torch.float32, device=device)
                for n in DycoreState._fields))
        return BoundaryData(state0=state("b0"), state1=state("b1"),
                            t0=float(z["t0"]), t1=float(z["t1"]))
