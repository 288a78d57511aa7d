"""The forecast half of the DA cycle driver: the ensemble forecast
(scale-rm_ens step of every cycle).

Port of scale_letkf_tpu/cycle.py CycleDriver (:64-387): the dynamics step
composed from the config (split-explicit HEVI for core = 'si', explicit RK3
otherwise; stretched levels when the grid's are), and the forecast entry
points forecast, forecast_one and forecast_slots. The members advance in
batches sized from free device memory — a leading member axis through the
whole step, in place of the reference's jax.vmap — and every batch runs the
two hand-written tendency kernels on a CUDA device.

Not ported yet, each raising NotImplementedError that names its ROADMAP
item: physics, lateral boundary forcing from a file (Davies relaxation,
model/boundary.py), terrain, a device mesh and the explicit halo backends.
The analysis half (H(x), CycleDriver.analysis, run_osse) comes with H(x).
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.grid import Grid
from scale_letkf_torch.model.dycore import (
    DycoreConfig, DycoreState, make_vgrid, rk3_step, to_collocated,
)
from scale_letkf_torch.model.dycore_si import SplitConfig, rk3_step_si
from scale_letkf_torch.state import state_trans
from scale_letkf_torch.utils.timing import Timer

# Device memory a forecast batch may take: this share of the free memory,
# at FORECAST_FIELDS_PER_MEMBER member-sized fields (nz·ny·nx floats) per
# member — the step's live states, slow tendencies, acoustic carries and
# coefficients, the solve's sweeps and the temporaries of ~40 elementwise
# passes. Measured: 96 at the 18-km size (peak 54.5 GiB with 13 members a
# batch beside the 25.6 GiB input and output ensembles, on an NVIDIA H100
# 80GB HBM3 at 700.00 W).
FORECAST_MEMORY_SHARE = 0.5
FORECAST_FIELDS_PER_MEMBER = 96


def member_batch(K: int, field_bytes: int, device: torch.device) -> int:
    """Members per forecast batch: as many as fit FORECAST_MEMORY_SHARE of
    the free device memory, balanced so the batches of K members differ by
    at most one; all K on the CPU."""
    if device.type != "cuda":
        return K
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(
        device)
    cap = int(FORECAST_MEMORY_SHARE * free
              // (FORECAST_FIELDS_PER_MEMBER * field_bytes))
    cap = max(1, min(K, cap))
    n_batches = -(-K // cap)
    return -(-K // n_batches)


class CycleDriver:
    """Ensemble forecast driver composing the dynamics from the config:

    - core: 'explicit' (acoustic-resolving RK3) or 'si' (split-explicit
      HEVI, model/dycore_si.py — the reference's TIME_DT = 30 s /
      TIME_DT_ATMOS_DYN = 3 s regime);
    - stretched vertical levels when the grid's fz is non-uniform.

    rho_ref and p_ref (nz, 1, 1) are tensors on the device the forecast
    runs on; ensembles passed in must be on it too. Physics, terrain,
    boundary data (`bdy`) and a mesh are not ported yet and raise."""

    def __init__(self, grid: Grid, dycfg: DycoreConfig,
                 rho_ref: torch.Tensor, p_ref: torch.Tensor,
                 use_physics: bool = False, topo=None, phys_cfg=None,
                 mesh=None, core: str = "explicit", n_small: int = 6,
                 bdy=None):
        if use_physics or phys_cfg is not None:
            raise NotImplementedError(
                "physics (use_physics, [physics]) is not ported yet "
                "(ROADMAP queue 1, physics)")
        if topo is not None and bool(np.any(np.asarray(topo) != 0.0)):
            raise NotImplementedError(
                "terrain (topo_file, model/terrain.py) is not ported yet "
                "(ROADMAP queue 1, terrain)")
        if bdy is not None:
            raise NotImplementedError(
                "lateral boundary forcing from a file (bdy_file, Davies "
                "relaxation, model/boundary.py) is not ported yet (ROADMAP "
                "queue 1, boundary.py)")
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP queue 1, parallel/)")
        if dycfg.halo != "gspmd":
            raise NotImplementedError(
                f"halo={dycfg.halo!r}: the explicit halo backends are not "
                f"ported yet (ROADMAP queue 1, parallel/)")
        if core not in ("explicit", "si"):
            raise ValueError(f"unknown core {core!r} (valid: 'explicit', "
                             f"'si')")
        self.rho_ref = rho_ref
        self.p_ref = p_ref
        self.device = rho_ref.device
        self.core = core
        self.n_small = n_small
        self.timer = Timer(self.device)
        self.z_centers = torch.as_tensor(np.asarray(grid.cz),
                                         dtype=torch.float32,
                                         device=self.device)
        dzs = np.diff(np.asarray(grid.fz))
        self.vg = (make_vgrid(grid.cz, grid.fz, self.device)
                   if not np.allclose(dzs, dzs[0]) else None)
        self.batch = None          # members per batch of the last forecast
        if core == "si":
            split = SplitConfig(dtau=dycfg.dt / n_small)

            def dyn_step(s):
                return rk3_step_si(s, dycfg, split, rho_ref, p_ref,
                                   self.z_centers, n_small, self.vg,
                                   timer=self.timer)
        else:
            def dyn_step(s):
                return rk3_step(s, dycfg, rho_ref, p_ref, self.z_centers,
                                self.vg, timer=self.timer)
        self._dyn_step = dyn_step

    def forecast_one(self, s: DycoreState, nsteps: int) -> DycoreState:
        """nsteps dynamics steps of one member (the deterministic run) or of
        one batch of members (a leading member axis); no physics in this
        slice."""
        for _ in range(nsteps):
            s = self._dyn_step(s)
        return s

    # -- forecast step (scale-rm_ens equivalent) --
    def forecast(self, ens: DycoreState, nsteps: int) -> DycoreState:
        """The ensemble forecast (K leading on every field), in member
        batches sized from free device memory (member_batch), written into
        a new ensemble; timed as section `forecast` (with `tendencies`,
        `acoustic` and `sponge` inside)."""
        with self.timer.section("forecast"):
            K = ens.rho.shape[0]
            out = DycoreState(*(torch.empty_like(f) for f in ens))
            field_bytes = ens.rho[0].numel() * ens.rho.element_size()
            self.batch = B = member_batch(K, field_bytes, self.device)
            for b0 in range(0, K, B):
                res = self.forecast_one(
                    DycoreState(*(f[b0:b0 + B] for f in ens)), nsteps)
                for dst, src in zip(out, res):
                    dst[b0:b0 + B] = src
                del res
            return out

    def forecast_slots(self, ens: DycoreState, nsteps: int,
                       slot_steps: list[int]
                       ) -> tuple[DycoreState, torch.Tensor]:
        """Forecast with per-slot history snapshots for 4-D H(x) (the
        reference model's LTIMESLOT history output). slot_steps: step counts
        from the forecast start, which may exceed nsteps. Returns (state at
        nsteps, hist) with hist (K, S, NV3D, nz, ny, nx) in slot_steps
        order, in host memory (a full-size window does not fit the card
        beside the ensemble)."""
        points = sorted(set(slot_steps) | {nsteps})
        snaps = {}
        state = ens
        state_at_n = ens if nsteps == 0 else None
        cur = 0
        for pt in points:
            if pt > cur:
                state = self.forecast(state, pt - cur)
                cur = pt
            if pt == nsteps:
                state_at_n = state
            if pt in slot_steps:
                snaps[pt] = state_trans(to_collocated(state)).cpu()
        hist = torch.stack([snaps[s] for s in slot_steps], dim=1)
        return state_at_n, hist
