"""Member-streamed full-size DA cycle: the ensemble lives in host memory.

Port of scale_letkf_tpu/da/bigcycle.py. The 18-km configuration at K = 50
is a 13.7-GB float32 ensemble, and its shipped 4-D window of 7 hourly
slots would need every slot's snapshot of every member at once if the
window were forecast first and observed after (CycleDriver.forecast_slots
keeps K × 7 snapshots in host memory). Here every phase streams:

- the ensemble forecast goes up member batch by member batch, and each
  batch's H(x) is taken during its integration: the window is integrated
  in segments between the slot points (the reference's obsope_tools.f90:
  431-508 time slots), each slot's obs against that batch's state at its
  point, so the window's history never exists at once;
- the guess comes down in analysis variables, and the analysis is the
  host-streamed tiled executor (da/letkf_tiled.py), in place;
- the analysis variables go back to the prognostic state batch by batch.

The stream carries the driver's whole composition: terrain, stretched
levels, the physics suite with its per-member slab skin temperature
(threaded through the segments, so in-window H(x) sees the live skin
state, and kept in host memory between cycles), Kessler physics, and
shared or per-member Davies boundary data (sliced per batch). Every
segment is one `_fcst_phys` call, which restarts the radiation index at 0,
so the segment boundaries are part of the numbers when the physics suite
runs; they are the reference's.

Per-phase wall-clock follows the reference's mpi_timer phase table
(letkf.f90:90-255): READ_GUES / ENS_FORECAST / OBS_OPERATOR / PROCESS_OBS /
DAS_LETKF / WRITE_ANAL (phase_table). Every section synchronises the card.

On a process grid (a driver with a mesh, parallel/mesh.py) only each
batch's forecast is decomposed, as the reference pins each batch's forecast
to its mesh (constrain_ensemble): a batch of b members, a multiple of the
grid's member slabs, is sharded as a b-member ensemble and forecast
segment by segment through the driver's grid forecast (its blocks kept
between segments, timer section `forecast`), and gathered on the device at
each slot point; the slot-matched H(x), the download, the tiled analysis,
the inverse transform and the monitor run undecomposed as above. The
stream runs in one process only: it brings each batch's guess to this
process's host memory and analyses every member of a tile there, which a
world of several processes (each holding its own members) cannot; there
the in-core grid cycle holds the ensemble.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.da.letkf_tiled import analyze_tiled
from scale_letkf_torch.da.monitor import monit_dep
from scale_letkf_torch.da.obsope import compute_hx_single
from scale_letkf_torch.model.dycore import (
    DycoreState, from_collocated, to_collocated,
)
from scale_letkf_torch.model.physics_suite import skin_temperature
from scale_letkf_torch.obs.types import ID_H08IR, QC_TIME, Observations
from scale_letkf_torch.state import (
    NV3D, state_to_history, state_trans, state_trans_inv,
)
from scale_letkf_torch.utils.staging import Stager


def batch_of(K: int, requested: int) -> int:
    """The largest divisor of K not above the request (uniform batches)."""
    b = max(1, min(requested, K))
    while K % b:
        b -= 1
    return b


def stream_batch(K: int, requested: int, mesh=None) -> int:
    """Members a streamed batch: batch_of(K, requested), on a grid of
    n_member slabs the largest such divisor that is a multiple of n_member
    (n_member · batch_of(K / n_member, requested // n_member))."""
    if mesh is None:
        return batch_of(K, requested)
    n = mesh.n_member
    if K % n:
        raise ValueError(f"K = {K} does not divide into {n} member slabs")
    return n * batch_of(K // n, requested // n)


def log(msg: str) -> None:
    print(f"[bigcycle +{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def slot_parts(obs: Observations, cfg, dt: float, nsteps: int):
    """The obs partitioned into the window's time slots (obsope_tools.f90:
    256's rule). Returns (parts, in_window): parts a list of (step point,
    obs subset, their indices, count) in ascending step order — the
    analysis time nsteps always present, with subset None when no slot
    falls on it — and in_window the per-obs mask; (None, None) for a
    single-slot window."""
    o = cfg.obsope
    if o.slot_end <= o.slot_start:
        return None, None
    spb = o.slot_tinterval / dt
    if abs(spb - round(spb)) > 1e-6:
        raise ValueError(
            f"slot_tinterval={o.slot_tinterval} must be a multiple of "
            f"the model dt={dt}")
    spb = int(round(spb))
    slots = (np.ceil(np.asarray(obs.dif) / o.slot_tinterval - 0.5)
             + o.slot_base).astype(np.int32)
    in_window = (slots >= o.slot_start) & (slots <= o.slot_end)
    step_of_slot = {s: max(0, nsteps + (s - o.slot_base) * spb)
                    for s in range(o.slot_start, o.slot_end + 1)}
    by_point: dict[int, list] = {}
    for s, pt in step_of_slot.items():
        m = np.nonzero(in_window & (slots == s))[0]
        if len(m):
            by_point.setdefault(pt, []).append(m)
    parts = []
    for pt in sorted(set(by_point) | {nsteps}):
        groups = by_point.get(pt)
        if groups is None:
            parts.append((pt, None, None, 0))
            continue
        m = np.concatenate(groups)
        parts.append((pt, obs.select(m), m, len(m)))
    return parts, in_window


def window_parts(obs: Observations, cfg, dt: float, nsteps: int):
    """slot_parts, with a single-slot window as one part at nsteps holding
    every obs (all in the window)."""
    parts, in_window = slot_parts(obs, cfg, dt, nsteps)
    if parts is None:
        parts = [(nsteps, obs, np.arange(obs.nobs), obs.nobs)]
        in_window = np.ones(obs.nobs, bool)
    return parts, in_window


def segment(driver, state, tsfc, n: int, t0, bdy):
    """n steps of the driver's composed forecast from window time t0,
    threading the slab skin temperature when it runs the physics suite
    (tsfc None otherwise). On the driver's grid state and tsfc are
    Sharded (the grid forecast, timer section `forecast`). Returns
    (state, tsfc)."""
    if driver.mesh is not None:
        with driver.timer.section("forecast"):
            return driver._forecast_blocks(state, n, t0, bdy, tsfc)
    if driver.phys_cfg is not None:
        return driver._fcst_phys(state, n, t0, tsfc, bdy)
    return driver._fcst_one(state, n, t0, bdy), tsfc


def slot_hx(driver, snap: torch.Tensor, tsfc, obs_s: Observations):
    """(y, qc) of the obs subset obs_s against the analysis-variable
    snapshot snap (b, NV3D, nz, ny, nx), with the live skin temperature."""
    fields = state_to_history(snap, driver.z_full, driver.topo, tsfc=tsfc)
    return compute_hx_single(fields, obs_s, driver.grid, driver.cfg,
                             driver.z_full)


def mean_hx(driver, obs: Observations, mean_vars: torch.Tensor,
            tsfc_mean) -> np.ndarray:
    """H(x) of the analysis mean (the O−A monitor, monit_obs_mpi) as
    float64, the H08 all-sky BT without its cloudy-sky sign flag."""
    fields = state_to_history(mean_vars, driver.z_full, driver.topo,
                              tsfc=tsfc_mean)
    y, _ = compute_hx_single(fields, obs, driver.grid, driver.cfg,
                             driver.z_full)
    y = y.cpu().numpy().astype(np.float64)
    h08 = obs.elem == ID_H08IR
    y[h08] = np.abs(y[h08])
    return y


def restart_of(driver, anal_b: torch.Tensor) -> DycoreState:
    """The prognostic state of analysis variables (leading member axis),
    with the configured positive-definite clipping; every field contiguous
    (ρ and ρθ would be views of the restart stack, which the stencil
    kernels do not take)."""
    cfg = driver.cfg
    return DycoreState(*(f.contiguous() for f in from_collocated(
        state_trans_inv(
            anal_b, positive_definite_q=cfg.letkf.positive_definite_q,
            positive_definite_qhyd=cfg.letkf.positive_definite_qhyd))))


class StreamedCycle:
    """Full-size cycle executor: member-streamed forecast with fused H(x),
    host-streamed tiled analysis.

    driver: a CycleDriver (the composed forecast, grid, config, boundary
    data, terrain and physics). member_batch: members a batch (the largest
    divisor of K not above it). tile_rows: the analysis tiles' height.
    pipeline=True overlaps the next batch's or tile's upload with the
    current one's work; the per-phase timers are then approximate (the
    blocking download absorbs what did not overlap). A driver on a process
    grid forecasts each batch on the grid (stream_batch sizes it); the grid
    must lie in this one process."""

    def __init__(self, driver, member_batch: int = 5, tile_rows: int = 24,
                 pipeline: bool = False, verbose: bool = False):
        if driver.mesh is not None and driver.mesh.world > 1:
            raise ValueError(
                f"the member-streamed cycle runs in one process: its grid "
                f"spreads over {driver.mesh.world} processes (the in-core "
                f"grid cycle holds the ensemble there)")
        self.d = driver
        self.member_batch = member_batch
        self.tile_rows = tile_rows
        self.pipeline = pipeline
        self.verbose = verbose
        # the per-member slab skin temperature (K, ny, nx) float32 in host
        # memory; None until the first physics forecast cold-starts it, or
        # set from a checkpoint
        self.tsfc_host = None

    @property
    def device(self) -> torch.device:
        return self.d.device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forecast_and_hx(self, ens_host: DycoreState, nsteps: int,
                        obs: Observations, t0: float = 0.0):
        """The streamed ensemble forecast with H(x). ens_host: a DycoreState
        of host arrays with K leading (left as it is). Returns (gues_host
        (K, NV3D, nz, ny, nx) float32 analysis variables at nsteps, ensval
        (K, nobs) float32, qc_worst (nobs,) with QC_TIME outside the
        window, timers). H(x) runs inside the forecast (OBS_OPERATOR is
        part of ENS_FORECAST)."""
        d = self.d
        mesh = d.mesh
        K = ens_host.rho.shape[0]
        b = stream_batch(K, self.member_batch, mesh)
        nz, ny, nx = d.grid.nz, d.grid.ny, d.grid.nx
        dt = d.dycfg.dt
        parts, in_window = window_parts(obs, d.cfg, dt, nsteps)
        has_phys = d.phys_cfg is not None
        cold = has_phys and self.tsfc_host is None
        if cold:
            self.tsfc_host = np.empty((K, ny, nx), np.float32)
        gues_host = np.empty((K, NV3D, nz, ny, nx), np.float32)
        ensval = np.empty((K, obs.nobs), np.float32)
        qc_worst = np.zeros(obs.nobs, np.int32)
        t = {"upload_s": 0.0, "fcst_s": 0.0, "download_s": 0.0,
             "fcst_compile_s": 0.0, "batches": K // b}
        stager = Stager(self.device, self.pipeline)
        t0 = np.float32(t0)

        def upload(i0):
            arrays = {k: getattr(ens_host, k)[i0:i0 + b]
                      for k in DycoreState._fields}
            if has_phys and not cold:
                arrays["tsfc"] = self.tsfc_host[i0:i0 + b]
            up, slot = stager.upload(arrays)
            return up, slot, d._bdy_batch(d.bdy, i0, b)

        def whole(x):
            """A batch's state or skin temperature over the domain (gathered
            on the grid)."""
            return x if mesh is None or x is None else mesh.gather_ensemble(x)

        def fcst_hx(up, slot, bdy):
            """The batch's segmented forecast with slot-matched H(x):
            (guess at nsteps, y, qc worst over the batch, tsfc)."""
            stager.ready(slot)
            state = DycoreState(*(up[k] for k in DycoreState._fields))
            tsfc = None
            if has_phys:
                tsfc = skin_temperature(state) if cold else up["tsfc"]
            if mesh is not None:
                state = mesh.shard_ensemble(state)
                tsfc = None if tsfc is None else mesh.shard_ensemble(tsfc)
            y = torch.zeros((b, obs.nobs), device=self.device)
            qc = torch.zeros((b, obs.nobs), dtype=torch.int32,
                             device=self.device)
            cur, gues = 0, None
            for pt, obs_s, midx, _ in parts:
                if pt > cur:
                    state, tsfc = segment(d, state, tsfc, pt - cur,
                                          t0 + np.float32(cur * dt), bdy)
                    cur = pt
                snap = state_trans(to_collocated(whole(state)))
                if pt == nsteps:
                    gues = snap
                if obs_s is not None:
                    idx = torch.as_tensor(midx, device=self.device)
                    y[:, idx], qc[:, idx] = slot_hx(d, snap, whole(tsfc),
                                                    obs_s)
                del snap
            stager.done(slot)
            return gues, y, qc.amax(dim=0), whole(tsfc)

        def download(i0, gues, y, qc_b, tsfc):
            nonlocal qc_worst
            stager.download(gues, gues_host[i0:i0 + b])
            stager.download(y, ensval[i0:i0 + b])
            qc_worst = np.maximum(qc_worst, stager.download(qc_b).numpy())
            if has_phys:
                stager.download(tsfc, self.tsfc_host[i0:i0 + b])

        if self.pipeline:
            t["pipelined"] = True
            args = upload(0)
            for i0 in range(0, K, b):
                tt = time.perf_counter()
                res = fcst_hx(*args)
                if i0 + b < K:
                    args = upload(i0 + b)          # overlaps the forecast
                download(i0, *res)                 # blocks
                del res
                dt_w = time.perf_counter() - tt
                if i0 == 0:
                    t["fcst_compile_s"] = dt_w
                else:
                    t["fcst_s"] += dt_w            # steady pipelined wall
                if self.verbose:
                    log(f"fcst+hx batch {i0 // b + 1}/{K // b} done")
        else:
            for i0 in range(0, K, b):
                tt = time.perf_counter()
                args = upload(i0)
                self._sync()
                t["upload_s"] += time.perf_counter() - tt
                tt = time.perf_counter()
                res = fcst_hx(*args)
                self._sync()
                dt_w = time.perf_counter() - tt
                if i0 == 0:
                    t["fcst_compile_s"] = dt_w    # the kernels' first use
                else:
                    t["fcst_s"] += dt_w
                tt = time.perf_counter()
                download(i0, *res)
                del res
                t["download_s"] += time.perf_counter() - tt
                if self.verbose:
                    log(f"fcst+hx batch {i0 // b + 1}/{K // b} done")
        # the steady-state rate leaves out the first batch
        if K > b:
            t["fcst_s"] *= K / (K - b)
        t["h2d_bytes"] = stager.h2d_bytes
        t["d2h_bytes"] = stager.d2h_bytes
        return (gues_host, ensval,
                np.where(in_window, qc_worst, QC_TIME).astype(np.int32), t)

    def analysis(self, gues_host: np.ndarray, obs: Observations, ensval,
                 qc_worst, infl_field=None):
        """Obs processing and the tiled analysis, which overwrites
        gues_host in place. Returns (anal_host, infl, ctx, timers)."""
        d = self.d
        t = {}
        tt = time.perf_counter()
        ctx = build_obs_context(obs, ensval, qc_worst, d.cfg, d.grid)
        t["process_obs_s"] = time.perf_counter() - tt
        if self.verbose:
            log(f"analysis: {ctx.nobs} obs, starting the tiled letkf")
        tt = time.perf_counter()
        anal, infl, stats = analyze_tiled(
            gues_host, ctx, d.cfg, d.grid, d.z_full, infl_field=infl_field,
            tile_rows=self.tile_rows, out=gues_host, pipeline=self.pipeline,
            device=self.device)
        t["das_letkf_s"] = time.perf_counter() - tt
        t.update({f"letkf_{k}": v for k, v in stats.items()})
        return anal, infl, ctx, t

    def to_state(self, anal_host: np.ndarray, out: DycoreState | None = None):
        """Analysis variables → prognostic DycoreState of host arrays,
        batch by batch (written into out's arrays when given). Timed as
        WRITE_ANAL."""
        K = anal_host.shape[0]
        b = batch_of(K, self.member_batch)
        nz, ny, nx = self.d.grid.nz, self.d.grid.ny, self.d.grid.nx
        if out is None:
            f = np.float32
            out = DycoreState(
                rho=np.empty((K, nz, ny, nx), f),
                rhou=np.empty((K, nz, ny, nx), f),
                rhov=np.empty((K, nz, ny, nx), f),
                rhow=np.empty((K, nz + 1, ny, nx), f),
                rhot=np.empty((K, nz, ny, nx), f),
                rhoq=np.empty((K, anal_host.shape[1] - 5, nz, ny, nx), f))
        stager = Stager(self.device)
        t = {"trans_inv_s": 0.0}
        for i0 in range(0, K, b):
            tt = time.perf_counter()
            up, slot = stager.upload({"anal": anal_host[i0:i0 + b]})
            s_b = restart_of(self.d, up["anal"])
            for name in DycoreState._fields:
                stager.download(getattr(s_b, name),
                                getattr(out, name)[i0:i0 + b])
            del s_b
            t["trans_inv_s"] += time.perf_counter() - tt
            if self.verbose:
                log(f"trans_inv batch {i0 // b + 1}/{K // b} done")
        t["trans_inv_h2d_bytes"] = stager.h2d_bytes
        t["trans_inv_d2h_bytes"] = stager.d2h_bytes
        return out, t

    def cycle(self, ens_host: DycoreState, obs: Observations, nsteps: int,
              infl_field=None, t0: float = 0.0, monitor: bool = True):
        """One full-size DA cycle. Returns (analysis DycoreState of host
        arrays, adaptive inflation or None, report: the phase timers and
        the O−B (stats_gues) and O−A (stats_anal) departure statistics).
        A caller that hands ens_host over (keeps no reference to it) has
        it freed once the guess exists."""
        total0 = time.perf_counter()
        gues_host, ensval, qc_worst, t_f = self.forecast_and_hx(
            ens_host, nsteps, obs, t0)
        del ens_host
        anal, infl, ctx, t_a = self.analysis(gues_host, obs, ensval,
                                             qc_worst, infl_field)
        report = {**t_f, **t_a}
        report["stats_gues"] = monit_dep(ctx.elem, ctx.dep, ctx.qc)
        if monitor:
            tt = time.perf_counter()
            tsfc_mean = (None if self.tsfc_host is None else torch.as_tensor(
                self.tsfc_host.mean(axis=0), device=self.device))
            mean = torch.from_numpy(anal).mean(dim=0).to(self.device)
            oma = ctx.dat - mean_hx(self.d, obs, mean, tsfc_mean)
            report["stats_anal"] = monit_dep(ctx.elem, oma, ctx.qc)
            report["monitor_s"] = time.perf_counter() - tt
            self.last_oma = oma
        self.last_ctx = ctx
        ens_out, t_i = self.to_state(anal)
        report.update(t_i)
        self._sync()
        report["total_s"] = time.perf_counter() - total0
        return ens_out, infl, report


def phase_table(report: dict) -> str:
    """The reference-style phase timer table (letkf.f90:90-255). Rows
    marked (est) are steady-state extrapolations (the first batch or tile
    imputed by n/(n-1)), so the column need not sum to TOTAL (measured)."""
    fcst_est = report.get("batches", 1) > 1
    letkf_est = bool(report.get("letkf_pipelined"))
    rows = [("READ_GUES (upload)", report.get("upload_s"), False),
            ("ENS_FORECAST", report.get("fcst_s"), fcst_est),
            ("  fcst compile", report.get("fcst_compile_s"), False),
            ("OBS_OPERATOR (fused)", report.get("obsope_s"), False),
            ("GUES download", report.get("download_s"), False),
            ("PROCESS_OBS", report.get("process_obs_s"), False),
            ("DAS_LETKF", report.get("das_letkf_s"), False),
            ("  letkf compute", report.get("letkf_compute_s"), letkf_est),
            ("  letkf transfer", report.get("letkf_transfer_s"), False),
            ("  letkf compile", report.get("letkf_compile_s"), False),
            ("MONITOR (O-A)", report.get("monitor_s"), False),
            ("WRITE_ANAL (inv)", report.get("trans_inv_s"), False),
            ("TOTAL", report.get("total_s"), False)]
    lines = ["== cycle phase timers =="]
    for name, v, est in rows:
        if v is not None:
            tag = " (est)" if est else ""
            lines.append(f"  {name + tag:28s} {v:10.2f} s")
    return "\n".join(lines)
