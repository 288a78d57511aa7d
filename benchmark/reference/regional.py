"""Plain reference of the limited-area forecast: Davies relaxation toward
time-interpolated boundary data, and the composed forecast over terrain —
each step the split-explicit step over the terrain (terrain.py), then the
relaxation at the step's end time; the physics suite (suite.py) after every
phys_interval steps.

Davies (1976): in a buffer of `width` cells from the lateral edges each
field is nudged implicitly, x ← (x + dt·w·x_b)/(1 + dt·w), toward the
target x_b linear in time between two bracketing states, with the rate w
ramping as a cosine from 1/tau at the edge to 0 at `width` cells inside.
The clock is float32 from the forecast's start, as the model's.
Departure from SCALE-RM: the buffer relaxes fields whose stencils are
periodic (SCALE-RM's are open, with the boundary data outside them).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference import suite as S
from benchmark.reference import terrain as T


class Boundary(NamedTuple):
    """Boundary data: two states of one member's shape at times t0 < t1."""
    state0: M.State
    state1: M.State
    t0: float
    t1: float


def weight(ny: int, nx: int, width: int, tau: float, device):
    """(ny, nx) relaxation rate [1/s], float32."""
    def ramp(n):
        d = np.minimum(np.arange(n), np.arange(n)[::-1])
        return np.where(d < width, 0.5 * (1.0 + np.cos(np.pi * d / width)),
                        0.0)
    w = np.maximum(ramp(nx)[None, :], ramp(ny)[:, None]) / tau
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def relax(s: M.State, bdy: Boundary, w, t, dt: float) -> M.State:
    """The relaxation at time t (float32) toward the boundary data."""
    t0, t1 = np.float32(bdy.t0), np.float32(bdy.t1)
    a = float(np.clip((t - t0) / max(t1 - t0, np.float32(1e-9)), 0.0, 1.0))
    fac = dt * w
    return M.State(*((x + fac * ((1.0 - a) * x0 + a * x1)) / (1.0 + fac)
                     for x, x0, x1 in zip(s, bdy.state0, bdy.state1)))


class Setup(NamedTuple):
    """What the composed forecast holds fixed: the column, the terrain's
    metrics, the boundary data and its rate, the suite's settings, the
    physics interval and the physics' layer thickness."""
    col: M.Column
    metrics: T.Metrics
    bdy: Boundary | None
    w: torch.Tensor | None
    suite: S.Settings
    phys_interval: int
    dz_phys: float


def forecast(s: M.State, su: Setup, nsteps: int, t0: float, device,
             tsfc=None, store: torch.dtype | None = None):
    """nsteps steps from time t0 [s] in float32: the step over the terrain
    and the relaxation (when su.bdy), and a physics step over n·dt after
    every phys_interval steps and after the remainder, its index counting
    from 0 in this call (radiation recomputed at the first). tsfc: the
    slab's skin temperature (K, ny, nx), cold-started when None. store: a
    dtype the state and the skin temperature are rounded to at the start
    and after every step and physics step (the control's bfloat16), None
    for none. Returns (state, skin temperature). Runs with TF32 off, the
    caller's setting restored after: its operations are elementwise, sums
    and scans, and no product added to them may round to TF32."""
    backends = torch.backends
    flags = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
    backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = False
    try:
        return _forecast(s, su, nsteps, t0, device, tsfc, store)
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = flags


def _forecast(s: M.State, su: Setup, nsteps: int, t0: float, device, tsfc,
              store):
    f32 = torch.float32

    def held(x):
        return x if store is None else x.to(store).to(f32)
    s = M.State(*(held(f.to(f32)) for f in s))
    col = su.col
    rho_ref, p_ref = M.reference_columns(col, device, f32)
    dzc = torch.as_tensor(np.diff(col.fz)[:, None, None], dtype=f32,
                          device=device)
    dzf = torch.as_tensor(np.diff(col.cz)[:, None, None], dtype=f32,
                          device=device)
    z_c = torch.as_tensor(col.cz, dtype=f32, device=device)
    carry = S.start(s, tsfc)
    carry = carry._replace(tsfc=held(carry.tsfc))
    dt = np.float32(col.dt)
    chunk = min(su.phys_interval, nsteps)
    n_chunks, rem = divmod(nsteps, max(chunk, 1))
    for i, n in enumerate([chunk] * n_chunks + [rem] * (rem > 0)):
        tc = np.float32(t0) + np.float32(i) * np.float32(chunk * dt)
        for j in range(n):
            s = T.si_step(s, col, rho_ref, p_ref, dzc, dzf, z_c, su.metrics)
            if su.bdy is not None:
                s = relax(s, su.bdy, su.w, tc + np.float32(j + 1) * dt,
                          col.dt)
            s = M.State(*(held(f) for f in s))
        s, carry = S.step(s, carry, i, su.suite, col.dt * n, su.dz_phys, z_c)
        s = M.State(*(held(f) for f in s))
        carry = carry._replace(tsfc=held(carry.tsfc))
    return s, carry.tsfc
