"""The DA cycle driver: ensemble forecast → H(x) → LETKF analysis, cycling.

Port of scale_letkf_tpu/cycle.py CycleDriver (reference workflow:
scale/run/cycle.sh:141-345, the per-cycle step sequence scale-rm_ens →
obsope → letkf). The dynamics step is composed from the config
(split-explicit HEVI for core = 'si', explicit RK3 otherwise; stretched
levels when the grid's are). The members advance in batches sized from free
device memory — a leading member axis through the whole step, in place of
the reference's jax.vmap — and every batch runs the two hand-written
tendency kernels on a CUDA device. The analysis step runs the obs operator
on the whole ensemble (a leading member axis), the host obs context, and
`analyze`, whose solver is the hand-written Newton–Schulz kernel.

At the full 18-km size each ensemble-sized tensor is freed as soon as the
next one exists (restart → guess → analysis → restart): `run_osse` hands
each ensemble on without keeping it, and `analysis` drops the forecast it
was given once the guess exists, so the analysis runs beside its guess and
its output alone, when the caller hands the ensemble over too (passes it
without keeping a reference). The analysis results carry the guess and
analysis ensemble mean and spread, not the ensembles.

Not ported yet, each raising NotImplementedError that names its ROADMAP
item: physics, lateral boundary forcing from a file (Davies relaxation,
model/boundary.py), terrain, a device mesh and the explicit halo backends;
the deterministic member and additive inflation (`analyze` raises).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from scale_letkf_torch.config import Config
from scale_letkf_torch.da.letkf import analyze
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.da.monitor import (
    DepartureStats, ObsDepRecord, monit_dep, monit_dep_bytype,
)
from scale_letkf_torch.da.obsmake import obsmake
from scale_letkf_torch.da.obsope import (
    ObsOpeResult, compute_hx_single, obsope_ensemble, obsope_slots,
)
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.model.dycore import (
    DycoreConfig, DycoreState, from_collocated, make_vgrid, rk3_step,
    to_collocated,
)
from scale_letkf_torch.model.dycore_si import SplitConfig, rk3_step_si
from scale_letkf_torch.obs.types import Observations
from scale_letkf_torch.state import (
    ensemble_mean, ensemble_spread, state_to_history, state_trans,
    state_trans_inv,
)
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


@dataclass
class CycleResult:
    """Per-cycle diagnostics of run_osse. nobs (obs kept by obsmake's QC)
    and info (the last cycle's analysis info, as `analysis` returns it) are
    the port's additions."""
    stats_gues: list[DepartureStats] = field(default_factory=list)
    stats_anal: list[DepartureStats] = field(default_factory=list)
    rmse_gues: list[float] = field(default_factory=list)   # vs truth (OSSE)
    rmse_anal: list[float] = field(default_factory=list)
    spread: list[float] = field(default_factory=list)      # guess, T
    nobs: list[int] = field(default_factory=list)
    infl_field: np.ndarray | None = None
    info: dict | None = None


class CycleDriver:
    """Cycling DA driver composing the forecast model from the config:

    - core: 'explicit' (acoustic-resolving RK3) or 'si' (split-explicit
      HEVI, model/dycore_si.py — the reference's TIME_DT = 30 s /
      TIME_DT_ATMOS_DYN = 3 s regime);
    - stretched vertical levels when the grid's fz is non-uniform.

    rho_ref and p_ref (nz, 1, 1) are tensors on the device the cycle runs
    on; ensembles passed in must be on it too. The topography is flat
    (z_full from grid.calc_z); physics, terrain, boundary data (`bdy`) and
    a mesh are not ported yet and raise."""

    def __init__(self, grid: Grid, cfg: Config, dycfg: DycoreConfig,
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
        self.grid = grid
        self.cfg = cfg
        self.rho_ref = rho_ref
        self.p_ref = p_ref
        self.device = rho_ref.device
        self.topo = torch.zeros((grid.ny, grid.nx), dtype=torch.float32,
                                device=self.device)
        self.z_full = grid.calc_z(self.topo)
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

    # -- analysis step (obsope + letkf equivalents) --
    def analysis(self, ens: DycoreState, obs: Observations,
                 infl_field=None, det: DycoreState | None = None,
                 precomputed_hx=None, addi_ens=None, hist_slots=None,
                 slots: np.ndarray | None = None):
        """The analysis of the ensemble `ens` (K leading). Returns (analysis
        DycoreState ensemble, info): info holds 'gues_mean', 'gues_sprd',
        'anal_mean', 'anal_sprd' (NV3D, nz, ny, nx tensors), the departure
        statistics 'stats_gues' / 'stats_anal' and by report type, the
        AnalysisDiag 'diag', the ObsDepRecord 'obsdep' and 'det' (None).

        infl_field (nz, ny, nx), array or tensor: the adaptive inflation of
        the previous cycle. precomputed_hx: an (ensval (K, nobs), qc (nobs,)
        [, lev]) tuple from a separate obsope run (the OBSDA_IN path,
        common_nml.f90:95). hist_slots (K, S, NV3D, nz, ny, nx, on the host
        or the device) with per-obs `slots`: the 4-D observation operator,
        each obs against its slot's snapshot (obsope_tools.f90:431-508); the
        update itself stays 3-D. `det` (DET_RUN) and `addi_ens` (INFL_ADD)
        reach `analyze`, which raises NotImplementedError for them.

        `ens` is dropped once the guess exists: a caller that hands it over
        (keeps no reference) frees it before the analysis.

        Timer sections: state_trans (with the guess mean and spread),
        obsope, process_obs, das_letkf (analyze's own inside),
        state_trans_inv (with the analysis mean and spread), monitor."""
        cfg = self.cfg
        with self.timer.section("state_trans"):
            gues = state_trans(to_collocated(ens))
            del ens
            gues_det = (state_trans(to_collocated(det))
                        if det is not None else None)
            gues_mean, gues_sprd = ensemble_mean(gues), ensemble_spread(gues)

        with self.timer.section("obsope"):
            if precomputed_hx is not None:
                lev = (np.asarray(precomputed_hx[2])
                       if len(precomputed_hx) > 2
                       and precomputed_hx[2] is not None else None)
                hx = ObsOpeResult(ensval=torch.as_tensor(precomputed_hx[0]),
                                  qc=np.asarray(precomputed_hx[1]), lev=lev)
            elif hist_slots is not None:
                hx = obsope_slots(hist_slots, obs, self.grid, cfg,
                                  self.z_full, self.topo, slots)
            else:
                hx = obsope_ensemble(
                    state_to_history(gues, self.z_full, self.topo), obs,
                    self.grid, cfg, self.z_full)

        with self.timer.section("process_obs"):
            ctx = build_obs_context(obs, hx.ensval.cpu().numpy(), hx.qc, cfg,
                                    self.grid, hx_lev=hx.lev)
            stats_gues = monit_dep(ctx.elem, ctx.dep, ctx.qc)

        with self.timer.section("das_letkf"):
            infl = (None if infl_field is None else torch.as_tensor(
                infl_field, dtype=torch.float32, device=self.device))
            anal, diag = analyze(gues, ctx, cfg, self.grid, self.z_full,
                                 infl_field=infl, device=self.device,
                                 gues_det=gues_det, addi_ens=addi_ens,
                                 timer=self.timer)
            del gues

        with self.timer.section("state_trans_inv"):
            anal_mean, anal_sprd = ensemble_mean(anal), ensemble_spread(anal)
            restart = state_trans_inv(
                anal, positive_definite_q=cfg.letkf.positive_definite_q,
                positive_definite_qhyd=cfg.letkf.positive_definite_qhyd)
            del anal
            # ρ and ρθ would be views pinning the whole restart stack
            ens_out = from_collocated(restart)
            ens_out = ens_out._replace(rho=ens_out.rho.clone(),
                                       rhot=ens_out.rhot.clone())
            del restart

        # O−A from the analysis mean against the preprocessed obs values
        # (ctx.dat: radar reflectivity in dBZ, as H(x) returns it)
        with self.timer.section("monitor"):
            y_a, _ = compute_hx_single(
                state_to_history(anal_mean, self.z_full, self.topo), obs,
                self.grid, cfg, self.z_full)
            oma = ctx.dat - y_a.cpu().numpy().astype(np.float64)
            stats_anal = monit_dep(ctx.elem, oma, ctx.qc)
            obsdep = ObsDepRecord(
                elem=ctx.elem, typ=ctx.typ, lon=obs.lon, lat=obs.lat,
                lev=obs.lev, dat=ctx.dat, err=ctx.err, qc=ctx.qc,
                omb=ctx.dep, oma=oma)

        return ens_out, {
            "gues_mean": gues_mean, "gues_sprd": gues_sprd,
            "anal_mean": anal_mean, "anal_sprd": anal_sprd,
            "stats_gues": stats_gues, "stats_anal": stats_anal,
            "stats_gues_bytype": monit_dep_bytype(ctx.elem, ctx.typ,
                                                  ctx.dep, ctx.qc),
            "stats_anal_bytype": monit_dep_bytype(ctx.elem, ctx.typ, oma,
                                                  ctx.qc),
            "diag": diag, "obsdep": obsdep, "det": None,
        }

    # -- full OSSE twin experiment --
    def run_osse(self, truth0: DycoreState, ens0: DycoreState,
                 obs_template: Observations, n_cycles: int,
                 steps_per_cycle: int, seed: int = 0
                 ) -> tuple[DycoreState, DycoreState, CycleResult]:
        """Perfect-model twin experiment: each cycle the nature run makes
        the obs (obsmake) and the ensemble assimilates them. Timer sections
        besides the forecast's and the analysis's: nature (the nature run's
        forecast) and obsmake.

        No reference to an ensemble outlives the step that consumes it, so
        a caller that hands ens0 over (keeps no reference to it) has it
        freed once the first forecast exists."""
        rng = np.random.default_rng(seed)
        res = CycleResult()
        truth, infl = truth0, None
        # the one reference to the ensemble; pop() hands it to the step
        ens = [ens0]
        del truth0, ens0
        for _ in range(n_cycles):
            res.info = None     # the last cycle's alone, not beside this one
            with self.timer.section("nature"):
                truth = self.forecast_one(truth, steps_per_cycle)
            ens.append(self.forecast(ens.pop(), steps_per_cycle))
            with self.timer.section("obsmake"):
                truth_anal = state_trans(to_collocated(truth))
                obs = obsmake(state_to_history(truth_anal, self.z_full,
                                               self.topo),
                              obs_template, self.grid, self.cfg, self.z_full,
                              rng)
            anal, res.info = self.analysis(ens.pop(), obs, infl_field=infl)
            ens.append(anal)
            del anal
            info = res.info
            if info["diag"].infl_field is not None:
                infl = info["diag"].infl_field

            def rmse(mean):   # u, v, w, T against the nature run
                return float(torch.sqrt(torch.mean(
                    (mean[:4] - truth_anal[:4]) ** 2)))
            res.rmse_gues.append(rmse(info["gues_mean"]))
            res.rmse_anal.append(rmse(info["anal_mean"]))
            res.spread.append(float(torch.mean(info["gues_sprd"][3])))
            res.nobs.append(obs.nobs)
            res.stats_gues.append(info["stats_gues"])
            res.stats_anal.append(info["stats_anal"])
            del info, truth_anal
        res.infl_field = infl
        return truth, ens.pop(), res
