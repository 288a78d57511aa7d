"""The DA cycle driver: ensemble forecast → H(x) → LETKF analysis, cycling.

Port of scale_letkf_tpu/cycle.py CycleDriver (reference workflow:
scale/run/cycle.sh:141-345, the per-cycle step sequence scale-rm_ens →
obsope → letkf). The forecast is composed from the config:
the dynamics step (split-explicit HEVI for core = 'si', explicit RK3
otherwise; stretched levels when the grid's are; terrain-following metrics
when the topography is not flat, model/terrain.py), Davies relaxation toward
lateral boundary data after every step (model/boundary.py, over the
periodic stencils, or a nested child's open ones), and Kessler
microphysics (use_physics) or the physics suite (phys_cfg: microphysics,
radiation, surface layer, PBL and a slab skin temperature,
model/physics_suite.py) every phys_interval steps. The members
advance in batches sized from free device memory — a leading member axis
through the whole step, in place of the reference's jax.vmap. Over flat
ground every batch runs the two hand-written tendency kernels on a CUDA
device; with topography the slow tendencies are terrain.tendencies_terrain,
plain PyTorch on either device, as the physics and the relaxation are: all
three were plain XLA in the reference. The analysis step runs the obs operator
on the whole ensemble (a leading member axis), the host obs context, and
`analyze`, whose solver is the hand-written Newton–Schulz kernel; a
deterministic member (DET_RUN) goes through H(x) beside the ensemble and is
analysed with its transmd weights, and an additive-inflation source
ensemble (INFL_ADD) is passed on to `analyze`.

At the full 18-km size each ensemble-sized tensor is freed as soon as the
next one exists (restart → guess → analysis → restart): `run_osse` hands
each ensemble on without keeping it, and `analysis` drops the forecast it
was given once the guess exists, so the analysis runs beside its guess and
its output alone, when the caller hands the ensemble over too (passes it
without keeping a reference). The analysis results carry the guess and
analysis ensemble mean and spread, not the ensembles.

On a process grid (`mesh`, parallel/mesh.py: member slabs × a 2-D X×Y
domain decomposition, the reference's COMM_e × COMM_d) the ensemble flows
as a Sharded — this process's blocks. A grid that decomposes the domain
forecasts through the explicit halo steps (parallel/halo.py) whatever
`DycoreConfig.halo` says: 'gspmd' (a compiler placing the collectives) has
no counterpart here, so it runs the explicit exchange; a member-only grid
forecasts each block's slab with the undecomposed step. Physics runs on
every block on the undecomposed schedule: Kessler and the suite's column
schemes per block, the PBL's face ↔ centre averages through a halo of one
column, and the suite's slab skin temperature sharded like the ensemble
(parallel/halo.py physics_step_blocks). The analysis gathers each member
slab over the domain for H(x) (with its skin temperature), builds the
same obs context on every process, and runs analyze(mesh=), the ensemble
transpose. The explicit core over terrain runs on every grid too, each
block with its halo-extended metrics; the reference refuses it, and
physics, under its explicit halo.
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
    HALO_MODES, DycoreConfig, DycoreState, from_collocated, make_vgrid,
    rk3_step, to_collocated,
)
from scale_letkf_torch.model.boundary import (
    BoundaryData, apply_boundary_relaxation, relaxation_weight,
)
from scale_letkf_torch.model.dycore_si import SplitConfig, rk3_step_si
from scale_letkf_torch.model.physics import kessler_step
from scale_letkf_torch.model.physics_suite import (
    PhysicsConfig, PhysicsState, physics_step, skin_temperature,
)
from scale_letkf_torch.model.terrain import make_metrics, rk3_step_terrain
from scale_letkf_torch.obs.types import ID_H08IR, Observations
from scale_letkf_torch.parallel import halo
from scale_letkf_torch.parallel.mesh import ProcessGrid, Sharded
from scale_letkf_torch.state import (
    ensemble_mean, ensemble_spread, state_to_history, state_trans,
    state_trans_inv,
)
from scale_letkf_torch.utils.timing import Timer

# Device memory a forecast batch may take: this share of the free memory,
# at FORECAST_FIELDS_PER_MEMBER member-sized fields (nz·ny·nx floats) per
# member — the step's live states, slow tendencies, acoustic carries and
# coefficients, the solve's sweeps and the temporaries of ~40 elementwise
# passes, and with the physics suite its radiation cache. Measured at the
# 18-km size on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py's
# `forecast_fields_per_member`, the forecast's peak above its input and
# output ensembles over batch × field): 96.2 for the dynamics alone, 97.5
# with the physics suite and Davies relaxation; a physics step alone takes
# 51.5, a relaxation 18.1.
FORECAST_MEMORY_SHARE = 0.5
FORECAST_FIELDS_PER_MEMBER = 98
# The same with terrain metrics: the slow tendency is plain PyTorch
# (terrain.tendencies_terrain) and its temporaries — the tracers' face
# fluxes and ∇⁴, the face winds, the metric products — add to the step's
# working set. Measured at the 18-km size on an NVIDIA H100 80GB HBM3 at
# 700.00 W (chip_smoke.py's production_cycle, batch 9): 106.4 fields a
# member for the forecast with the physics suite and Davies relaxation; a
# terrain dynamics step alone takes 88.1 above its input.
FORECAST_FIELDS_PER_MEMBER_TERRAIN = 107


def member_batch(K: int, field_bytes: int, device: torch.device,
                 fields_per_member: int = FORECAST_FIELDS_PER_MEMBER) -> int:
    """Members per forecast batch: as many as fit FORECAST_MEMORY_SHARE of
    the free device memory at fields_per_member member-sized fields each,
    balanced so the batches of K members differ by at most one; all K on
    the CPU."""
    if device.type != "cuda":
        return K
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(
        device)
    cap = int(FORECAST_MEMORY_SHARE * free
              // (fields_per_member * field_bytes))
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


def _contiguous_rho(s: DycoreState) -> DycoreState:
    """ρ and ρθ of from_collocated as fields of their own (views would pin
    the restart stack, and the kernels take contiguous fields)."""
    return s._replace(rho=s.rho.clone(), rhot=s.rhot.clone())


class CycleDriver:
    """Cycling DA driver composing the forecast model from the config:

    - core: 'explicit' (acoustic-resolving RK3) or 'si' (split-explicit
      HEVI, model/dycore_si.py — the reference's TIME_DT = 30 s /
      TIME_DT_ATMOS_DYN = 3 s regime);
    - stretched vertical levels when the grid's fz is non-uniform;
    - terrain-following metrics when some topography is not zero
      (model/terrain.py; scale_calc_z, common_scale.f90:1434): the SI core
      then takes them in its slow tendencies, the explicit core steps with
      rk3_step_terrain; flat topography keeps the kernels' path;
    - Kessler warm rain every phys_interval steps (use_physics), or the
      physics suite (phys_cfg) with its per-member slab skin temperature;
    - Davies relaxation toward `bdy` (BoundaryData, shared by all members
      or per member) over a buffer of bdy_width cells, time scale bdy_tau.

    rho_ref and p_ref (nz, 1, 1) are tensors on the device the cycle runs
    on; ensembles and boundary data passed in must be on it too. topo
    (ny, nx), array or tensor, None for flat: z_full = grid.calc_z(topo).

    mesh: a ProcessGrid (parallel/mesh.py). `forecast` and `analysis` then
    take a Sharded of this process's blocks, or a global ensemble, which
    they shard, and return a Sharded (`mesh.gather_ensemble` makes it
    global); boundary data is global, or per member sharded like the
    ensemble (a nested child's bracket, nested.py); the deterministic
    member, the inflation field and the additive-inflation source stay
    global."""

    def __init__(self, grid: Grid, cfg: Config, dycfg: DycoreConfig,
                 rho_ref: torch.Tensor, p_ref: torch.Tensor,
                 use_physics: bool = False, phys_interval: int = 5,
                 topo=None, phys_cfg: PhysicsConfig | None = None,
                 mesh: ProcessGrid | None = None, core: str = "explicit",
                 n_small: int = 6,
                 bdy: BoundaryData | None = None, bdy_width: int = 0,
                 bdy_tau: float = 300.0):
        if core not in ("explicit", "si"):
            raise ValueError(f"unknown core {core!r} (valid: 'explicit', "
                             f"'si')")
        if dycfg.halo not in HALO_MODES:
            raise ValueError(f"unknown halo backend {dycfg.halo!r}")
        self.grid = grid
        self.cfg = cfg
        self.dycfg = dycfg
        self.rho_ref = rho_ref
        self.p_ref = p_ref
        self.use_physics = use_physics
        self.phys_interval = phys_interval
        self.phys_cfg = phys_cfg
        self.device = rho_ref.device
        self.topo = (torch.zeros((grid.ny, grid.nx), dtype=torch.float32,
                                 device=self.device) if topo is None
                     else torch.as_tensor(topo, dtype=torch.float32,
                                          device=self.device))
        self.z_full = grid.calc_z(self.topo)
        # terrain metrics when any topography is present, built as the
        # reference's __init__ builds them: ∂h/∂x, ∂h/∂y periodic whatever
        # the lateral mode (ROADMAP §3)
        self.metrics = (make_metrics(self.topo, grid.cz, grid.fz, grid.dx,
                                     grid.dy)
                        if bool((self.topo != 0).any()) else None)
        self.fields_per_member = (FORECAST_FIELDS_PER_MEMBER
                                  if self.metrics is None
                                  else FORECAST_FIELDS_PER_MEMBER_TERRAIN)
        self.core = core
        self.n_small = n_small
        self.timer = Timer(self.device)
        self.z_centers = torch.as_tensor(np.asarray(grid.cz),
                                         dtype=torch.float32,
                                         device=self.device)
        dzs = np.diff(np.asarray(grid.fz))
        self.vg = (make_vgrid(grid.cz, grid.fz, self.device)
                   if not np.allclose(dzs, dzs[0]) else None)
        # Kessler alone (use_physics) sediments on the per-level thickness;
        # the suite runs with the lowest-level thickness on stretched
        # levels (where PBL mixing concentrates), the reference's known
        # simplification of column-aware physics
        self.dz_col = self.vg.dzc if self.vg is not None else dycfg.dz
        self.dz_phys = dycfg.dz if self.vg is None else float(dzs[0])
        # Davies relaxation toward self.bdy, whenever a buffer width is set
        # (bdy may be attached or swapped between cycles)
        self.bdy = bdy
        self._bdy_w2d = (relaxation_weight(grid.ny, grid.nx, bdy_width,
                                           bdy_tau, device=self.device)
                         if bdy_width > 0 else None)
        # per-member slab skin temperature (K, ny, nx) of the physics suite:
        # None until the first forecast cold-starts it, or set from a
        # checkpoint; threaded across forecast calls (on a grid a Sharded
        # of this process's blocks once a forecast ran; a global tensor set
        # by hand is sharded by the next forecast)
        self.tsfc = None
        self.batch = None          # members per batch of the last forecast
        self._check_grid(mesh)
        self.mesh = mesh
        if core == "si":
            split = SplitConfig(dtau=dycfg.dt / n_small)

            def dyn_step(s):
                return rk3_step_si(s, dycfg, split, rho_ref, p_ref,
                                   self.z_centers, n_small, self.vg,
                                   self.metrics, timer=self.timer)
        elif self.metrics is not None:
            def dyn_step(s):
                return rk3_step_terrain(s, dycfg, rho_ref, p_ref,
                                        self.z_centers, self.metrics,
                                        self.vg, timer=self.timer)
        else:
            def dyn_step(s):
                return rk3_step(s, dycfg, rho_ref, p_ref, self.z_centers,
                                self.vg, timer=self.timer)
        self._dyn_step = dyn_step
        self._metrics_ext = (halo.extended_metrics(
            mesh, self.metrics, dycfg.lateral == "periodic")
            if self.exchange else None)

    def _check_grid(self, mesh):
        """Whether the forecast exchanges halos: under halo='explicit*', or
        on a grid that decomposes the domain whatever dycfg.halo says. The
        reference's refusals of its explicit halo
        (scale_letkf_tpu/cycle.py:235-246) do not stand here: the explicit
        core over terrain takes each block's extended metrics
        (parallel/halo.py rk3_step_blocks), and physics runs on every grid
        (physics_step_blocks)."""
        self.exchange = self.dycfg.halo != "gspmd"
        if self.exchange and mesh is None:
            raise ValueError(f"halo={self.dycfg.halo!r} requires a process "
                             f"grid (mesh)")
        if mesh is not None and mesh.spatial:
            self.exchange = True

    def _step(self, s: DycoreState, t, bdy):
        """One dynamics step, then the Davies relaxation toward `bdy` at the
        step's end time t (section `boundary`)."""
        s = self._dyn_step(s)
        if self._bdy_w2d is not None and bdy is not None:
            with self.timer.section("boundary"):
                s = self._apply_bdy(s, t, bdy)
        return s

    def _apply_bdy(self, s: DycoreState, t, bdy: BoundaryData, w2d=None):
        """Davies nudging toward the target interpolated at t, the weight
        clipped to [0, 1]; w2d: the weight (a block's, on a grid), the
        domain's when None."""
        bt0, bt1 = np.float32(bdy.t0), np.float32(bdy.t1)
        a = float(np.clip((t - bt0) / max(bt1 - bt0, np.float32(1e-9)),
                          0.0, 1.0))
        target = DycoreState(*((1.0 - a) * x0 + a * x1
                               for x0, x1 in zip(bdy.state0, bdy.state1)))
        return apply_boundary_relaxation(
            s, target, self._bdy_w2d if w2d is None else w2d, self.dycfg.dt)

    def _chunks(self, s, nsteps: int, t0, step, physics=None):
        """nsteps steps s = step(s, t), t the step's end time (dynamics and
        relaxation; `s` a state, or a dict of blocks on a grid), and
        physics(s, i, dt_phys) after every phys_interval of them and after
        the remainder (section `physics`). Times are float32, as the
        reference's traced clock. Each state is dropped once the next
        exists: no caller's frame holds a chunk's input across its steps."""
        chunk = min(self.phys_interval, nsteps) if physics else nsteps
        n_chunks, rem = divmod(nsteps, max(chunk, 1))
        dt = self.dycfg.dt
        for i, n in enumerate([chunk] * n_chunks + [rem] * (rem > 0)):
            tc = t0 + np.float32(i) * np.float32(chunk * dt)
            for j in range(n):
                s = step(s, tc + np.float32(j + 1) * np.float32(dt))
            if physics:
                with self.timer.section("physics"):
                    s = physics(s, i, dt * n)
        return s

    def _fcst_phys(self, s: DycoreState, nsteps: int, t0, tsfc0, bdy):
        """The physics-suite forecast, threading the slab skin temperature;
        tsfc0 None cold-starts it from the lowest-level air temperature.
        Returns (state, tsfc). The radiation index restarts at 0 on every
        call, and step 0 always recomputes radiation, so the cache starts
        empty (the reference primes it with a call that step 0
        overwrites)."""
        tsfc = skin_temperature(s) if tsfc0 is None else tsfc0
        if nsteps == 0:
            return s, tsfc
        phys = [PhysicsState(tsfc=tsfc, drhot_rad=torch.zeros_like(s.rhot),
                             rad_sfc=torch.zeros_like(tsfc))]

        def suite(s, i, dt_phys):
            s, phys[0] = physics_step(s, phys[0], i, self.phys_cfg, dt_phys,
                                      self.dz_phys, self.z_centers,
                                      self.dycfg.lateral)
            return s

        s = self._chunks(s, nsteps, t0, self._stepper(bdy), suite)
        return s, phys[0].tsfc

    def _stepper(self, bdy):
        """step(s, t) of _chunks: one dynamics step and the relaxation."""
        return lambda s, t: self._step(s, t, bdy)

    def _fcst_one(self, s: DycoreState, nsteps: int, t0, bdy):
        """nsteps of the composed forecast: dynamics (+ boundary relaxation),
        with Kessler microphysics (use_physics, the per-level dz) or the
        physics suite (phys_cfg, cold-started slab) every phys_interval
        steps."""
        if nsteps == 0 or (not self.use_physics and self.phys_cfg is None):
            return self._chunks(s, nsteps, t0, self._stepper(bdy))
        if self.phys_cfg is not None:
            return self._fcst_phys(s, nsteps, t0, None, bdy)[0]
        return self._chunks(s, nsteps, t0, self._stepper(bdy),
                            lambda s, i, dt_phys:
                            kessler_step(s, dt_phys, self.dz_col))

    def _bdy_batch(self, bdy: BoundaryData | None, b0: int, B: int
                   ) -> BoundaryData | None:
        """The boundary data of members b0..b0+B of `bdy`: per-member
        targets (a leading member axis) sliced, a shared one whole."""
        if bdy is None or self._bdy_w2d is None:
            return None
        if bdy.state0.rho.dim() == 3:
            return bdy
        return bdy._replace(**{k: DycoreState(*(
            f[b0:b0 + B].to(self.device) for f in getattr(bdy, k)))
            for k in ("state0", "state1")})

    def _grid_step(self, blocks: dict) -> dict:
        """One dynamics step of this process's blocks (halo exchanges)."""
        if self.core == "si":
            return halo.rk3_step_si_blocks(
                self.mesh, blocks, self.dycfg, SplitConfig(
                    dtau=self.dycfg.dt / self.n_small), self.rho_ref,
                self.p_ref, self.z_centers, self.n_small, self.vg,
                self._metrics_ext, timer=self.timer)
        return halo.rk3_step_blocks(
            self.mesh, blocks, self.dycfg, self.rho_ref, self.p_ref,
            self.z_centers, self.vg,
            overlap=self.dycfg.halo == "explicit_overlap",
            metrics=self._metrics_ext, timer=self.timer)

    def _grid_batch(self, sh: Sharded) -> int:
        """Members per batch of every block, from the free memory at the
        halo-extended blocks' size, the least over the processes (every
        process must step the same batches: they exchange halos)."""
        h = halo.HALO_W
        ext = sum(f.shape[-3] * (f.shape[-2] + 2 * h) * (f.shape[-1] + 2 * h)
                  for f in (s.rho for s in sh.blocks.values()))
        f0 = next(iter(sh.blocks.values())).rho
        B = member_batch(f0.shape[0], ext * f0.element_size(), self.device,
                         self.fields_per_member)
        if self.mesh.world > 1:
            import torch.distributed as dist
            t = torch.tensor([B], device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
            B = int(t)
        return B

    def _grid_tsfc(self, sh: Sharded) -> Sharded:
        """The physics suite's slab skin temperature as this process's
        blocks of sh's grid: self.tsfc as it is when already sharded, cut
        into blocks when global (a checkpoint's, or set by hand), else
        cold-started on each block (column-local: the global cold start's
        bits)."""
        if isinstance(self.tsfc, Sharded):
            return self.tsfc
        if self.tsfc is not None:
            return self.mesh.shard_ensemble(torch.as_tensor(
                self.tsfc, dtype=torch.float32, device=self.device))
        return sh._replace(blocks={b: skin_temperature(s)
                                   for b, s in sh.blocks.items()})

    def _forecast_grid(self, ens, nsteps: int, t0) -> Sharded:
        """forecast on the process grid: _forecast_blocks toward self.bdy
        from self.tsfc (cold-started on each block when unset), whose
        result it keeps (a Sharded, threaded across calls)."""
        sh = ens if isinstance(ens, Sharded) else self.mesh.shard_ensemble(ens)
        del ens
        tsfc = self._grid_tsfc(sh) if self.phys_cfg is not None else None
        out, tsfc = self._forecast_blocks(sh, nsteps, t0, self.bdy, tsfc)
        if tsfc is not None:
            self.tsfc = tsfc
        return out

    def _forecast_blocks(self, sh: Sharded, nsteps: int, t0, bdy, tsfc
                         ) -> tuple[Sharded, Sharded | None]:
        """nsteps of the composed forecast of the ensemble sh on the grid
        toward `bdy` (its members' boundary data: per-member targets
        indexed by sh's own members, or shared, or sharded like sh; None
        without), from the suite's skin temperature `tsfc` (a Sharded like
        sh; None without the suite). Each block's member slab runs in
        batches, every block of the process stepping together (their halos
        exchanged each stage), the Davies relaxation per block, and physics
        on every block of the batch on _chunks' schedule — Kessler per
        block, the suite through halo.physics_step_blocks with each block's
        own slab skin temperature; a member-only grid forecasts each slab
        undecomposed. Returns (ensemble, skin temperature after, None
        without the suite); self.tsfc and self.bdy are left as they are
        (the member-streamed cycle forecasts each batch so)."""
        grid = self.mesh
        phys = self.phys_cfg is not None
        t_out = {}
        if not self.exchange:
            out = {}
            for b, s in sh.blocks.items():
                bdy_s = (None if bdy is None else
                         self._bdy_block(bdy, b, sh, 0, s.rho.shape[0]))
                out[b], t_out[b] = self._forecast_members(
                    s, nsteps, t0, bdy_s, tsfc.blocks[b] if phys else None)
            return (sh._replace(blocks=out),
                    tsfc._replace(blocks=t_out) if phys else None)
        self.batch = B = self._grid_batch(sh)
        w2d = None
        if self._bdy_w2d is not None and bdy is not None:
            w2d = {b: self._bdy_w2d[grid.rows(b, sh.ny), grid.cols(b, sh.nx)]
                   for b in sh.blocks}
        else:
            bdy = None
        if phys:
            t_out = {b: torch.empty_like(t) for b, t in tsfc.blocks.items()}
        periodic = self.dycfg.lateral == "periodic"

        def run(b0, batch):
            bdy_b = None
            if bdy is not None:
                bdy_b = {b: self._bdy_block(bdy, b, sh, b0, B) for b in batch}

            def step(batch, t):
                batch = self._grid_step(batch)
                if bdy_b is not None:
                    with self.timer.section("boundary"):
                        batch = {b: self._apply_bdy(s, t, bdy_b[b], w2d[b])
                                 for b, s in batch.items()}
                return batch

            physics = None
            if phys:
                ph = {b: PhysicsState(
                    tsfc=tsfc.blocks[b][b0:b0 + B],
                    drhot_rad=torch.zeros_like(s.rhot),
                    rad_sfc=torch.zeros_like(tsfc.blocks[b][b0:b0 + B]))
                    for b, s in batch.items()}

                def physics(batch, i, dt_phys):
                    batch, new = halo.physics_step_blocks(
                        grid, batch, ph, i, self.phys_cfg, dt_phys,
                        self.dz_phys, self.z_centers, periodic, self.timer)
                    ph.update(new)
                    return batch
            elif self.use_physics:
                def physics(batch, i, dt_phys):
                    return {b: kessler_step(s, dt_phys, self.dz_col)
                            for b, s in batch.items()}

            batch = self._chunks(batch, nsteps, t0, step, physics)
            if phys:
                for b, p in ph.items():
                    t_out[b][b0:b0 + B] = p.tsfc
            return batch

        out = self._in_batches(sh.blocks, B, run)
        return (sh._replace(blocks=out),
                tsfc._replace(blocks=t_out) if phys else None)

    @staticmethod
    def _in_batches(blocks: dict, B: int, run) -> dict:
        """Every block's members in batches of B: run(b0, batch) takes and
        returns a dict of DycoreState over the blocks (members b0..b0+B of
        each); the results are written into new ensembles."""
        out = {b: DycoreState(*(torch.empty_like(f) for f in s))
               for b, s in blocks.items()}
        K = next(iter(blocks.values())).rho.shape[0]
        for b0 in range(0, K, B):
            res = run(b0, {b: DycoreState(*(f[b0:b0 + B] for f in s))
                           for b, s in blocks.items()})
            for b, r in res.items():
                for dst, src in zip(out[b], r):
                    dst[b0:b0 + B] = src
            del res
        return out

    def _bdy_block(self, bdy: BoundaryData, b: int, sh: Sharded, b0: int,
                   B: int) -> BoundaryData:
        """Block b's part of `bdy` for its members b0..b0+B: per-member
        targets sliced by sh's member index (bdy's first member is sh's
        first), a shared one whole, each over the block's columns; a
        bracket sharded like the ensemble (a Sharded of per-member targets,
        nested.py) from block b's own."""
        grid = self.mesh
        if isinstance(bdy.state0, Sharded):
            return bdy._replace(**{k: DycoreState(*(
                f[b0:b0 + B] for f in getattr(bdy, k).blocks[b]))
                for k in ("state0", "state1")})
        ys, xs = grid.rows(b, sh.ny), grid.cols(b, sh.nx)
        m0 = grid.members(b, sh.K).start + b0
        per_member = bdy.state0.rho.dim() != 3
        return bdy._replace(**{k: DycoreState(*(
            (f[m0:m0 + B] if per_member else f)[..., ys, xs].to(self.device)
            for f in getattr(bdy, k))) for k in ("state0", "state1")})

    def forecast_one(self, s: DycoreState, nsteps: int,
                     t0: float = 0.0) -> DycoreState:
        """nsteps steps of the composed forecast of one member (the
        deterministic run) or of one batch of members (a leading member
        axis), from t0 [s] on the boundary data's clock. The physics suite
        cold-starts its slab. Boundary data must be shared by all members
        (per-member data needs `forecast`)."""
        bdy = None if self._bdy_w2d is None else self.bdy
        if bdy is not None and bdy.state0.rho.dim() != 3:
            raise ValueError("forecast_one takes boundary data shared by all "
                             "members; per-member boundary data needs "
                             "forecast")
        return self._fcst_one(s, nsteps, np.float32(t0), bdy)

    # -- forecast step (scale-rm_ens equivalent) --
    def forecast(self, ens: DycoreState, nsteps: int,
                 t0: float = 0.0) -> DycoreState:
        """The ensemble forecast (K leading on every field), in member
        batches sized from free device memory (member_batch), written into
        a new ensemble; t0 [s]: the start on the boundary data's clock.
        With the physics suite the per-member slab skin temperature
        (self.tsfc) is cold-started on the first call and threaded across
        calls. Timed as section `forecast` (with `tendencies`, `acoustic`,
        `sponge`, `physics` and `boundary` inside)."""
        with self.timer.section("forecast"):
            if self.mesh is not None:
                return self._forecast_grid(ens, nsteps, np.float32(t0))
            out, tsfc = self._forecast_members(ens, nsteps, np.float32(t0),
                                               self.bdy, self.tsfc)
            if tsfc is not None:
                self.tsfc = tsfc
            return out

    def _forecast_members(self, ens: DycoreState, nsteps: int, t0, bdy,
                          tsfc=None):
        """The undecomposed forecast of the members `ens` in member batches,
        toward `bdy` (these members' boundary data, or shared; None
        without); with the physics suite from these members' skin
        temperature `tsfc` (cold-started when None). Returns (ensemble,
        skin temperature after, None without the suite)."""
        K = ens.rho.shape[0]
        field_bytes = ens.rho[0].numel() * ens.rho.element_size()
        self.batch = B = member_batch(K, field_bytes, self.device,
                                      self.fields_per_member)
        phys = self.phys_cfg is not None
        if phys:
            tsfc = (skin_temperature(ens) if tsfc is None
                    else torch.as_tensor(tsfc, dtype=torch.float32,
                                         device=self.device))
            tsfc_out = torch.empty_like(tsfc)

        def run(b0, batch):
            bdy_b = self._bdy_batch(bdy, b0, B)
            if not phys:
                return {0: self._fcst_one(batch[0], nsteps, t0, bdy_b)}
            res, tsfc_out[b0:b0 + B] = self._fcst_phys(
                batch[0], nsteps, t0, tsfc[b0:b0 + B], bdy_b)
            return {0: res}

        out = self._in_batches({0: ens}, B, run)[0]
        return out, (tsfc_out if phys else None)

    def forecast_slots(self, ens: DycoreState, nsteps: int,
                       slot_steps: list[int], t0: float = 0.0
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
                state = self.forecast(state, pt - cur,
                                      t0=t0 + cur * self.dycfg.dt)
                cur = pt
            if pt == nsteps:
                state_at_n = state
            if pt in slot_steps:
                full = (state if self.mesh is None
                        else self.mesh.gather_ensemble(state))
                snaps[pt] = state_trans(to_collocated(full)).cpu()
                del full
        hist = torch.stack([snaps[s] for s in slot_steps], dim=1)
        return state_at_n, hist

    # -- analysis step (obsope + letkf equivalents) --
    def analysis(self, ens: DycoreState, obs: Observations,
                 infl_field=None, det: DycoreState | None = None,
                 precomputed_hx=None, addi_ens=None,
                 rng: np.random.Generator | None = None, hist_slots=None,
                 slots: np.ndarray | None = None):
        """The analysis of the ensemble `ens` (K leading). Returns (analysis
        DycoreState ensemble, info): info holds 'gues_mean', 'gues_sprd',
        'anal_mean', 'anal_sprd' (NV3D, nz, ny, nx tensors), the departure
        statistics 'stats_gues' / 'stats_anal' and by report type, the
        AnalysisDiag 'diag', the ObsDepRecord 'obsdep' and 'det'.

        infl_field (nz, ny, nx), array or tensor: the adaptive inflation of
        the previous cycle. precomputed_hx: an (ensval (K, nobs), qc (nobs,)
        [, lev]) tuple from a separate obsope run (the OBSDA_IN path,
        common_nml.f90:95). hist_slots (K, S, NV3D, nz, ny, nx, on the host
        or the device) with per-obs `slots`: the 4-D observation operator,
        each obs against its slot's snapshot (obsope_tools.f90:431-508); the
        update itself stays 3-D. `det`: the deterministic member (DET_RUN,
        common_nml.f90:46), whose H(x) gives the obs context's depd and whose
        analysis (transmd weights, letkf_tools.f90:489-497) comes back under
        'det' (None without it). `addi_ens` (K, NV3D, nz, ny, nx), on the
        device or the host: the additive-inflation source ensemble in
        analysis variables, required when INFL_ADD > 0 (reference
        INFL_ADD_IN_BASENAME files, common_nml.f90:117); rng shuffles its
        members under INFL_ADD_SHUFFLE.

        `ens` is dropped once the guess exists: a caller that hands it over
        (keeps no reference) frees it before the analysis.

        Timer sections: state_trans (with the guess mean and spread),
        obsope, process_obs, das_letkf (analyze's own inside),
        state_trans_inv (with the analysis mean and spread), monitor."""
        cfg = self.cfg
        grid = self.mesh
        with self.timer.section("state_trans"):
            if grid is None:
                gues = state_trans(to_collocated(ens))
                gues_mean, gues_sprd = (ensemble_mean(gues),
                                        ensemble_spread(gues))
            else:
                if not isinstance(ens, Sharded):
                    ens = grid.shard_ensemble(ens)
                gues = halo.to_collocated_blocks(grid, ens, self.timer)
                gues = gues._replace(blocks={b: state_trans(v) for b, v
                                             in gues.blocks.items()})
            del ens
            gues_det = (state_trans(to_collocated(det))
                        if det is not None else None)

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
            elif grid is not None:
                hx = self._obsope_grid(gues, obs)
            else:
                # with the physics suite, stability-corrected screen
                # diagnostics from the persisted skin temperature
                hx = obsope_ensemble(
                    state_to_history(gues, self.z_full, self.topo,
                                     tsfc=self.tsfc), obs,
                    self.grid, cfg, self.z_full)
            ensval_det = None
            if gues_det is not None:
                # the reference's deterministic H(x): neutral screen
                # diagnostics (no tsfc)
                y_det, _ = compute_hx_single(
                    state_to_history(gues_det, self.z_full, self.topo), obs,
                    self.grid, cfg, self.z_full)
                ensval_det = y_det.cpu().numpy()

        with self.timer.section("process_obs"):
            ctx = build_obs_context(obs, hx.ensval.cpu().numpy(), hx.qc, cfg,
                                    self.grid, ensval_det=ensval_det,
                                    hx_lev=hx.lev)
            stats_gues = monit_dep(ctx.elem, ctx.dep, ctx.qc)

        with self.timer.section("das_letkf"):
            infl = (None if infl_field is None else torch.as_tensor(
                infl_field, dtype=torch.float32, device=self.device))
            anal, diag = analyze(gues, ctx, cfg, self.grid, self.z_full,
                                 infl_field=infl, device=self.device,
                                 gues_det=gues_det, addi_ens=addi_ens,
                                 rng=rng, mesh=grid, timer=self.timer)
            del gues, gues_det

        with self.timer.section("state_trans_inv"):
            pd = dict(positive_definite_q=cfg.letkf.positive_definite_q,
                      positive_definite_qhyd=cfg.letkf.positive_definite_qhyd)
            if grid is None:
                anal_mean, anal_sprd = (ensemble_mean(anal),
                                        ensemble_spread(anal))
                restart = state_trans_inv(anal, **pd)
                del anal
                ens_out = from_collocated(restart)
            else:
                gues_mean, gues_sprd, anal_mean, anal_sprd = (
                    diag.stats[k] for k in ("gues_mean", "gues_sprd",
                                            "anal_mean", "anal_sprd"))
                restart = anal._replace(blocks={
                    b: state_trans_inv(v, **pd)
                    for b, v in anal.blocks.items()})
                del anal
                ens_out = halo.from_collocated_blocks(grid, restart,
                                                      self.timer)
            del restart
            # ρ and ρθ would be views pinning the whole restart stack
            ens_out = (_contiguous_rho(ens_out) if grid is None else
                       ens_out._replace(blocks={
                           b: _contiguous_rho(s)
                           for b, s in ens_out.blocks.items()}))
            det_out = None
            if diag.anal_det is not None:
                det_out = from_collocated(state_trans_inv(diag.anal_det,
                                                          **pd))
                diag.anal_det = None

        # O−A from the analysis mean against the preprocessed obs values
        # (ctx.dat: radar reflectivity in dBZ, as H(x) returns it)
        with self.timer.section("monitor"):
            y_a, _ = compute_hx_single(
                state_to_history(anal_mean, self.z_full, self.topo,
                                 tsfc=self._tsfc_mean()), obs,
                self.grid, cfg, self.z_full)
            y_a = y_a.cpu().numpy().astype(np.float64)
            # the H08 all-sky BT without its cloudy-sky sign flag
            y_a[obs.elem == ID_H08IR] = np.abs(y_a[obs.elem == ID_H08IR])
            oma = ctx.dat - y_a
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
            "diag": diag, "obsdep": obsdep, "det": det_out,
        }

    def _tsfc_mean(self):
        """The members' mean skin temperature (ny, nx) for the O−A monitor,
        summed in member order (state.ensemble_mean: the same bits from a
        grid's blocks as undecomposed); None without one."""
        if self.tsfc is None:
            return None
        tsfc = self.tsfc
        if isinstance(tsfc, Sharded):
            with self.timer.section("gather"):
                tsfc = self.mesh.gather_ensemble(tsfc)
        return ensemble_mean(torch.as_tensor(tsfc, dtype=torch.float32,
                                             device=self.device))

    def _obsope_grid(self, gues: Sharded, obs: Observations
                     ) -> ObsOpeResult:
        """The ensemble H(x) on the grid: each member slab's blocks gathered
        over the domain on the process holding its first block, with its
        skin temperature when the physics suite runs (the stability-
        corrected screen diagnostics of the undecomposed path), H(x) of
        the slab there, and every slab's values gathered onto every
        process, then reduced over all K members as obsope_ensemble does
        (qc the largest, lev and val2 the mean). Timer section `gather`
        for the moves."""
        grid = self.mesh
        tsfc = None
        if self.tsfc is not None:
            tsfc = self._grid_tsfc(gues)
        per_slab = []
        for m in range(grid.n_member):
            leader = grid.owner(grid.index(m, 0, 0))
            with self.timer.section("gather"):
                slab = grid.gather_slab(gues, m, leader)
                tsfc_m = (None if tsfc is None
                          else grid.gather_slab(tsfc, m, leader))
            payload = shapes = None
            if slab is not None:
                y, qc, lev, val2 = compute_hx_single(
                    state_to_history(slab, self.z_full, self.topo,
                                     tsfc=tsfc_m), obs,
                    self.grid, self.cfg, self.z_full, with_aux=True)
                del slab, tsfc_m
                payload = [y, qc.to(y.dtype), lev.to(y.dtype),
                           val2.to(y.dtype)]
            Km = gues.K // grid.n_member
            shapes = [(Km, obs.nobs)] * 4
            with self.timer.section("gather"):
                got = grid.route([(leader, dst, payload, shapes)
                                  for dst in range(grid.world)],
                                 torch.float32, self.device)
            per_slab.append(got[grid.rank])
        y, qc, lev, val2 = (torch.cat(p, dim=0) for p in zip(*per_slab))
        return ObsOpeResult(ensval=y,
                            qc=qc.to(torch.int32).amax(dim=0).cpu().numpy(),
                            lev=lev.mean(dim=0).cpu().numpy(),
                            val2=val2.mean(dim=0).cpu().numpy())

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
