"""Device-resident full-size DA cycle: the ensemble lives on the card.

Port of scale_letkf_tpu/da/resident.py. The member-streamed executor
(da/bigcycle.py) moves the whole ensemble across the host link several
times a cycle; here it stays on the card, stored as

    mean : (NV3D, nz, ny, nx) float32      — ensemble mean, analysis vars
    dev  : (K, NV3D, nz, ny, nx) bfloat16  — member deviations from a
           float32 reference mean `ref`

(the 18-km configuration at K = 50: 6.84 GB of deviations against 13.7 GB
of float32 members). The split keeps the increments' relative precision:
the deviations carry bfloat16's relative error of the deviation, the size
of the perturbation transport of the tiled executor.

- forecast: member batches are read from the resident buffers in place
  (ref + dev → prognostic state), integrated with the driver's whole
  composition in segments — at the window's slot points, for their H(x),
  and every max_steps_per_call steps — and their analysis-time guess
  written back in place. Every segment is one `_fcst_phys` call, which
  restarts the radiation index at 0, so with the physics suite the
  segment boundaries, max_steps_per_call's (60, the reference's default)
  included, are part of the numbers. The forecast mean is accumulated, so
  after the phase member_i = ref + dev_i with mean = accum/K;
- analysis: row tiles are read from the resident buffers and written back
  in place (da/letkf.py analyze_points, the tile executors' body), the
  deviations rebased against the new mean; the obs-space arrays go up
  once;
- H(x) rides the forecast batches; ensval stays on the card until the obs
  context is built.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from scale_letkf_torch.da.bigcycle import (
    batch_of, log, mean_hx, restart_of, segment, slot_hx, window_parts,
)
from scale_letkf_torch.da.letkf import (
    _make_plan, analyze_points, gridpoint_coords,
)
from scale_letkf_torch.da.letkf_obs import build_obs_context
from scale_letkf_torch.da.letkf_tiled import (
    _tiled_guards, prior_inflation, tile_rows_of,
)
from scale_letkf_torch.da.monitor import monit_dep
from scale_letkf_torch.io.convert import obs_context_to_device
from scale_letkf_torch.model.dycore import from_collocated, to_collocated
from scale_letkf_torch.model.physics_suite import skin_temperature
from scale_letkf_torch.obs.types import QC_TIME, Observations
from scale_letkf_torch.state import state_trans, state_trans_inv
from scale_letkf_torch.utils.device import full_fp32
from scale_letkf_torch.utils.staging import Stager, host_tensor


class ResidentEnsemble:
    """A device-resident ensemble in analysis variables, split into a
    float32 mean and bfloat16 deviations.

    Invariant between cycles: member_i = ref + dev_i with ref == mean.
    During a cycle the forecast moves mean ahead of ref (the deviations
    stay against ref until the analysis rebases them)."""

    def __init__(self, mean: torch.Tensor, dev: torch.Tensor,
                 ref: torch.Tensor | None = None, tsfc=None, infl=None):
        self.mean = mean            # (NV3D, nz, ny, nx) float32
        self.dev = dev              # (K, NV3D, nz, ny, nx) bfloat16
        self.ref = mean if ref is None else ref
        self.tsfc = tsfc            # (K, ny, nx) float32 or None
        self.infl = infl            # (nz, ny, nx) float32 or None

    @property
    def K(self) -> int:
        return self.dev.shape[0]

    @classmethod
    def from_host_gues(cls, gues_host: np.ndarray, batch: int = 8, *,
                       device: torch.device) -> "ResidentEnsemble":
        """A host (K, NV3D, nz, ny, nx) float32 analysis-variable ensemble
        on `device`: its float32 member mean (numpy) and the bfloat16
        deviations from it, cast on the host and uploaded `batch` members
        at a time (half the bytes of float32 members)."""
        mean = gues_host.mean(axis=0, dtype=np.float32)
        mean_t = torch.from_numpy(mean)
        K = gues_host.shape[0]
        dev = torch.empty(gues_host.shape, dtype=torch.bfloat16,
                          device=device)
        stager = Stager(device)
        for i0 in range(0, K, batch):
            d = (host_tensor(gues_host[i0:i0 + batch]) - mean_t).to(
                torch.bfloat16)
            up, _ = stager.upload({"dev": d})
            dev[i0:i0 + batch] = up["dev"]
        ens = cls(mean_t.to(device), dev)
        ens.h2d_bytes = stager.h2d_bytes
        return ens

    def to_host_gues(self, batch: int = 8) -> np.ndarray:
        """The (K, NV3D, nz, ny, nx) float32 host ensemble, ref + dev by
        the storage invariant (mean is auxiliary)."""
        out = np.empty(self.dev.shape, np.float32)
        for i0 in range(0, self.K, batch):
            blk = self.ref[None] + self.dev[i0:i0 + batch].float()
            host_tensor(out[i0:i0 + batch]).copy_(blk)
        return out


class ResidentCycle:
    """Full-size cycle executor with the ensemble resident on the card.

    h2d_bytes / d2h_bytes in each report count what the cycle moved across
    the host link: the obs-space arrays (the obs context up, the ensemble
    H(x) and its QC down, the monitor's H(x) down) and per-member boundary
    batches, when the driver's boundary data are per member on the host."""

    def __init__(self, driver, member_batch: int = 5, tile_rows: int = 24,
                 verbose: bool = False, max_steps_per_call: int = 60):
        self.d = driver
        self.member_batch = member_batch
        self.tile_rows = tile_rows
        self.verbose = verbose
        self.max_steps_per_call = max_steps_per_call
        # per-obs departures of the latest monitored cycle
        self.last_ctx = None
        self.last_oma = None

    @property
    def device(self) -> torch.device:
        return self.d.device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forecast_and_hx(self, ens: ResidentEnsemble, nsteps: int,
                        obs: Observations, t0: float = 0.0):
        """The resident forecast with H(x). Updates `ens` (mean advances,
        the deviations stay against ens.ref until the analysis). Returns
        (ensval (K, nobs) on the card, qc_worst (nobs,) host, timers)."""
        d = self.d
        K = ens.K
        b = batch_of(K, self.member_batch)
        parts, in_window = window_parts(obs, d.cfg, d.dycfg.dt, nsteps)
        chunk = max(1, int(self.max_steps_per_call))
        dt_model = d.dycfg.dt
        has_phys = d.phys_cfg is not None
        t = {"fcst_s": 0.0, "fcst_compile_s": 0.0, "batches": K // b,
             "h2d_bytes": 0, "d2h_bytes": 0}

        if has_phys and ens.tsfc is None:
            # cold start: each member's lowest-level air temperature
            ens.tsfc = torch.cat([skin_temperature(from_collocated(
                state_trans_inv(ens.mean[None]
                                + ens.dev[i0:i0 + b].float())))
                for i0 in range(0, K, b)])
        accum = torch.zeros_like(ens.mean)
        ys = []
        qc_worst = np.zeros(obs.nobs, np.int32)
        # members are ref + dev by the storage invariant: ref equals mean
        # right after an analysis or a load, not after a forecast-only cycle
        mean0 = ens.ref
        per_member_bdy = (d.bdy is not None and d._bdy_w2d is not None
                          and d.bdy.state0.rho.dim() == 4)
        for i0 in range(0, K, b):
            tt = time.perf_counter()
            bdy = d._bdy_batch(d.bdy, i0, b)
            if per_member_bdy and d.bdy.state0.rho.device != self.device:
                t["h2d_bytes"] += sum(f.numel() * f.element_size()
                                      for s in (bdy.state0, bdy.state1)
                                      for f in s)
            state = restart_of(d, mean0[None] + ens.dev[i0:i0 + b].float())
            tsfc = ens.tsfc[i0:i0 + b] if has_phys else None
            y = torch.zeros((b, obs.nobs), device=self.device)
            qc = torch.zeros((b, obs.nobs), dtype=torch.int32,
                             device=self.device)
            cur = 0
            for pt, obs_s, midx, _ in parts:
                while cur < pt:
                    n = min(chunk, pt - cur)
                    state, tsfc = segment(d, state, tsfc, n,
                                          np.float32(t0 + cur * dt_model),
                                          bdy)
                    cur += n
                if pt == nsteps:
                    # the analysis-time write-back, before any segment
                    # beyond the window touches the state
                    gues = state_trans(to_collocated(state))
                    accum += gues.sum(dim=0)
                    ens.dev[i0:i0 + b] = (gues - mean0[None]).to(
                        ens.dev.dtype)
                    if has_phys:
                        ens.tsfc[i0:i0 + b] = tsfc
                    del gues
                if obs_s is not None:
                    idx = torch.as_tensor(midx, device=self.device)
                    snap = state_trans(to_collocated(state))
                    y[:, idx], qc[:, idx] = slot_hx(d, snap, tsfc, obs_s)
                    del snap
            del state
            ys.append(y)
            qc_worst = np.maximum(qc_worst, qc.amax(dim=0).cpu().numpy())
            t["d2h_bytes"] += qc.shape[1] * 4
            self._sync()
            dt_w = time.perf_counter() - tt
            if i0 == 0:
                t["fcst_compile_s"] = dt_w
            else:
                t["fcst_s"] += dt_w
            if self.verbose:
                log(f"resident fcst batch {i0 // b + 1}/{K // b}")
        if K > b:
            t["fcst_s"] *= K / (K - b)
        ens.ref = mean0
        ens.mean = accum / K
        ensval = torch.cat(ys)
        qc_worst = np.where(in_window, qc_worst, QC_TIME).astype(np.int32)
        return ensval, qc_worst, t

    def analysis(self, ens: ResidentEnsemble, obs: Observations, ensval,
                 qc_worst):
        """Obs processing and the resident tiled analysis. Returns (ctx,
        timers)."""
        d = self.d
        t = {}
        tt = time.perf_counter()
        ensval_h = ensval.cpu().numpy()
        ctx = build_obs_context(obs, ensval_h, qc_worst, d.cfg, d.grid)
        t["process_obs_s"] = time.perf_counter() - tt
        t["ensval_d2h_bytes"] = ensval_h.nbytes
        if self.verbose:
            log(f"resident analysis: {ctx.nobs} obs")
        tt = time.perf_counter()
        stats = analyze_resident(ens, ctx, d.cfg, d.grid, d.z_full,
                                 tile_rows=self.tile_rows,
                                 verbose=self.verbose)
        t["das_letkf_s"] = time.perf_counter() - tt
        t.update({f"letkf_{k}": v for k, v in stats.items()})
        return ctx, t

    def cycle(self, ens: ResidentEnsemble, obs: Observations, nsteps: int,
              t0: float = 0.0, monitor: bool = True) -> dict:
        """One full-size DA cycle; `ens` becomes the analysis ensemble.
        Returns a report: the phase timers, the O−B and O−A departure
        statistics, and h2d_bytes / d2h_bytes of the whole cycle."""
        total0 = time.perf_counter()
        ensval, qc_worst, t_f = self.forecast_and_hx(ens, nsteps, obs, t0)
        ctx, t_a = self.analysis(ens, obs, ensval, qc_worst)
        del ensval
        report = {**t_f, **t_a}
        report["stats_gues"] = monit_dep(ctx.elem, ctx.dep, ctx.qc)
        if monitor:
            tt = time.perf_counter()
            tsfc_mean = None if ens.tsfc is None else ens.tsfc.mean(dim=0)
            oma = ctx.dat - mean_hx(self.d, obs, ens.mean, tsfc_mean)
            report["stats_anal"] = monit_dep(ctx.elem, oma, ctx.qc)
            report["monitor_s"] = time.perf_counter() - tt
            report["d2h_bytes"] += obs.nobs * 4
            self.last_ctx, self.last_oma = ctx, oma
        report["h2d_bytes"] += report.get("letkf_h2d_bytes", 0)
        report["d2h_bytes"] += report["ensval_d2h_bytes"]
        self._sync()
        report["total_s"] = time.perf_counter() - total0
        return report


@full_fp32()
def analyze_resident(ens: ResidentEnsemble, ctx, cfg, grid, z_full,
                     tile_rows: int = 24, verbose: bool = False) -> dict:
    """The tiled LETKF analysis over the resident buffers, every tile read
    and written in place on the card (da/letkf_tiled.py's guards apply).
    Updates ens: the deviations rebased against the new analysis mean, ref
    and mean that mean, infl the adaptive field when adaptive. Returns
    stats: compute_s (steady state, the first tile left out and imputed),
    compile_s (the first tile), tiles, tile_rows, chunks (gridpoint chunks
    a level, over all tiles), nobs_mean and h2d_bytes (the obs context). Float32 products run in full FP32."""
    _tiled_guards(cfg)
    K, nv, nz, ny, nx = ens.dev.shape
    device = ens.dev.device
    tile_rows = tile_rows_of(ny, tile_rows)
    n_tiles = ny // tile_rows
    Bt = tile_rows * nx
    f32 = torch.float32

    plan = _make_plan(ctx, cfg, nv)
    dctx = obs_context_to_device(ctx, device, f32)
    h2d = sum(a.nbytes for a in (ctx.x, ctx.y, ctx.vert, ctx.err, ctx.dep,
                                 ctx.hdxb)) + sum(
        ct.buckets.table.nbytes for ct in ctx.ctypes)
    gp_x, gp_y, dist_bdy = gridpoint_coords(grid, device, f32)
    z_dev = torch.as_tensor(z_full, dtype=f32,
                            device=device).reshape(nz, ny * nx)
    infl_buf = (prior_inflation(cfg, nz, ny * nx, None, slice(None), device)
                .reshape(nz, ny, nx) if ens.infl is None
                else torch.as_tensor(ens.infl, dtype=f32,
                                     device=device).clone())

    stats = {"compute_s": 0.0, "compile_s": 0.0, "tiles": n_tiles,
             "transfer_s": 0.0, "tile_rows": tile_rows, "chunks": 0,
             "h2d_bytes": h2d}
    dev, meanbuf, mean0 = ens.dev, ens.mean, ens.ref
    nobs_means = []
    for ti in range(n_tiles):
        tc = time.perf_counter()
        rows = slice(ti * tile_rows, (ti + 1) * tile_rows)
        b = slice(rows.start * nx, rows.stop * nx)
        m1_t = meanbuf[:, :, rows, :]
        pert = dev[:, :, :, rows, :].float() - (m1_t - mean0[:, :, rows, :])
        anal, infl_z, nobs_z, _, _, chunk = analyze_points(
            plan, dctx, pert.reshape(K, nv, nz, Bt),
            m1_t.reshape(nv, nz, Bt), infl_buf[:, rows, :].reshape(nz, Bt),
            gp_x[b], gp_y[b], dist_bdy[b], z_dev[:, b])
        stats["chunks"] += -(-Bt // chunk)
        del pert
        # rebase the deviations against the tile's analysis mean
        anal_mean = anal.mean(dim=0)
        dev[:, :, :, rows, :] = (anal - anal_mean).to(dev.dtype).reshape(
            K, nv, nz, tile_rows, nx)
        meanbuf[:, :, rows, :] = anal_mean.reshape(nv, nz, tile_rows, nx)
        if infl_z is not None:
            infl_buf[:, rows, :] = infl_z.reshape(nz, tile_rows, nx)
        nobs_means.append(nobs_z.float().mean())
        del anal, anal_mean
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt_w = time.perf_counter() - tc
        if ti == 0:
            stats["compile_s"] = dt_w
        else:
            stats["compute_s"] += dt_w
        if verbose and (ti % 4 == 0 or ti == n_tiles - 1):
            log(f"resident tile {ti + 1}/{n_tiles}")
    if n_tiles > 1:
        stats["compute_s"] *= n_tiles / (n_tiles - 1)
    stats["nobs_mean"] = float(torch.stack(nobs_means).mean())
    ens.mean = meanbuf
    ens.ref = meanbuf
    if plan.adaptive:
        ens.infl = infl_buf
    return stats
