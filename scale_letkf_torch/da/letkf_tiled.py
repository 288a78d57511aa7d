"""Host-streamed tiled LETKF analysis: row tiles of a host ensemble through
the card.

Port of scale_letkf_tpu/da/letkf_tiled.py. The 18-km domain at K = 50
(480×360×36) is a 13.7-GB float32 ensemble, and the radar volume's ~888k
obs make the selection's working set large; both are analysed here from an
ensemble in host memory, one horizontal row tile at a time:

  host ensemble → per tile: member mean (numpy float32) and perturbations
  → bfloat16 perturbations and float32 mean up → analysis on the device
  (da/letkf.py analyze_points) → bfloat16 perturbations and float32 mean
  down → host assembly

Tiles need no halo: localization is resolved through the obs context's
global bucket tables, which go up once with the other obs-space arrays.
bfloat16 carries only the perturbations, so the increments keep their
relative precision (bfloat16 whole members would quantize T ≈ 280 K at
~1 K). Both sides of the bfloat16 casts round to nearest even, so they
agree bit for bit with the reference's ml_dtypes casts.

The tile loop does not thread a deterministic member, additive inflation
or the RTPS output field: those raise NotImplementedError (_tiled_guards),
as in the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from scale_letkf_torch.da.letkf import (
    _make_plan, analyze_points, gridpoint_coords,
)
from scale_letkf_torch.io.convert import obs_context_to_device
from scale_letkf_torch.utils.device import full_fp32
from scale_letkf_torch.utils.staging import Stager, as_numpy, host_tensor


def _tiled_guards(cfg) -> None:
    """The features the tile loops (here and da/resident.py) do not thread
    raise, as analyze's unsupported options do."""
    if cfg.letkf.infl_add > 0:
        raise NotImplementedError(
            "tiled analysis does not support additive inflation "
            "(INFL_ADD > 0; letkf_tools.f90:804-929) — use analyze()")
    if cfg.letkf.relax_spread_out:
        raise NotImplementedError(
            "tiled analysis does not support RELAX_SPREAD_OUT — "
            "use analyze()")
    if cfg.ensemble.det_run:
        raise NotImplementedError(
            "tiled analysis does not support a deterministic member "
            "(DET_RUN; letkf_tools.f90:489-497) — use analyze()")


def tile_rows_of(ny: int, requested: int) -> int:
    """The largest divisor of ny not above the request."""
    rows = max(1, min(requested, ny))
    while ny % rows:
        rows -= 1
    return rows


def prior_inflation(cfg, nz: int, B: int, infl_field, rows: slice,
                    device: torch.device) -> torch.Tensor:
    """(nz, B) prior inflation of the row tile `rows`: infl_field's, or the
    configured INFL_MUL as it is (deflation included), 1 as the adaptive
    cold start when INFL_MUL ≤ 0."""
    if infl_field is None:
        v = cfg.letkf.infl_mul if cfg.letkf.infl_mul > 0 else 1.0
        return torch.full((nz, B), v, dtype=torch.float32, device=device)
    return torch.as_tensor(infl_field[:, rows, :], dtype=torch.float32,
                           device=device).reshape(nz, B)


@full_fp32()
def analyze_tiled(gues_host: np.ndarray, ctx, cfg, grid, z_full,
                  infl_field=None, tile_rows: int = 24,
                  out: np.ndarray | None = None, pipeline: bool = False, *,
                  device: torch.device):
    """The analysis of the host ensemble gues_host (K, NV3D, nz, ny, nx)
    float32, tile by tile on `device`. Returns (anal (same shape, float32;
    written into `out` when given, which may be gues_host itself: each
    tile is read before it is written), the adaptive inflation (nz, ny,
    nx) or None, stats).

    stats: compute_s (steady state: the first tile, which pays the
    kernels' build and first launch, is left out and imputed by
    n/(n-1)), compile_s (that first tile), transfer_s, host_s, tiles,
    tile_rows, chunks (gridpoint chunks a level, over all tiles), and
    h2d_bytes / d2h_bytes. pipeline=True uploads tile t+1 on a stream of
    its own while tile t computes; the components are then not separable,
    and stats reports stream_s (the steady pipelined wall, compute_s
    aliased to it) and pipelined. Float32 products run in full FP32."""
    _tiled_guards(cfg)
    K, nv, nz, ny, nx = gues_host.shape
    tile_rows = tile_rows_of(ny, tile_rows)
    n_tiles = ny // tile_rows
    Bt = tile_rows * nx
    f32 = torch.float32

    plan = _make_plan(ctx, cfg, nv)
    dctx = obs_context_to_device(ctx, device, f32)
    gp_x, gp_y, dist_bdy = gridpoint_coords(grid, device, f32)
    z_dev = torch.as_tensor(as_numpy(z_full), dtype=f32,
                            device=device).reshape(nz, ny * nx)
    src = host_tensor(gues_host)
    anal_out = out if out is not None else np.empty_like(gues_host)
    dst = host_tensor(anal_out)
    infl_out = (np.empty((nz, ny, nx), np.float32) if plan.adaptive
                else None)
    stager = Stager(device, pipeline)
    stats = {"compute_s": 0.0, "transfer_s": 0.0, "compile_s": 0.0,
             "host_s": 0.0, "tiles": n_tiles, "tile_rows": tile_rows,
             "chunks": 0}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def prep_upload(t):
        """Tile t's member mean and bfloat16 perturbations on the host, up."""
        rows = slice(t * tile_rows, (t + 1) * tile_rows)
        th = time.perf_counter()
        slab = gues_host[:, :, :, rows, :]                # (K,nv,nz,tr,nx)
        mean = slab.mean(axis=0)                          # numpy float32
        pert = (src[:, :, :, rows, :] - torch.from_numpy(mean)).to(
            torch.bfloat16)
        stats["host_s"] += time.perf_counter() - th
        up, slot = stager.upload({"pert": pert, "mean": mean})
        return rows, up, slot

    def compute(rows, up, slot):
        """The analysis of one tile: (anal mean (nv, nz, Bt) float32,
        bfloat16 perturbations (K, nv, nz, Bt), inflation (nz, Bt))."""
        stager.ready(slot)
        b = slice(rows.start * nx, rows.stop * nx)
        res = analyze_points(
            plan, dctx, up["pert"].reshape(K, nv, nz, Bt).float(),
            up["mean"].reshape(nv, nz, Bt),
            prior_inflation(cfg, nz, Bt, infl_field, rows, device),
            gp_x[b], gp_y[b], dist_bdy[b], z_dev[:, b])
        stager.done(slot)
        stats["chunks"] += -(-Bt // res.chunk)
        anal, infl_z = res.anal, res.infl
        del res
        anal_mean = anal.mean(dim=0)
        return anal_mean, (anal - anal_mean).to(torch.bfloat16), infl_z

    def download(rows, anal_mean, anal_pert, infl_z):
        mean_h = stager.download(anal_mean)
        pert_h = stager.download(anal_pert)
        infl_h = (stager.download(infl_z) if infl_out is not None
                  else None)
        th = time.perf_counter()
        torch.add(mean_h[None], pert_h.float(),
                  out=dst[:, :, :, rows, :].view(K, nv, nz, Bt))
        if infl_out is not None:
            infl_out[:, rows, :] = infl_h.numpy().reshape(nz, -1, nx)
        stats["host_s"] += time.perf_counter() - th

    if pipeline:
        stats["pipelined"] = True
        stats["stream_s"] = 0.0
        args = prep_upload(0)
        for t in range(n_tiles):
            tc = time.perf_counter()
            res = compute(*args)
            if t + 1 < n_tiles:
                # the next tile's host prep and upload while this one
                # computes: the steady tile wall nears max(transfer, compute)
                nxt = prep_upload(t + 1)
            download(args[0], *res)
            del res
            if t + 1 < n_tiles:
                args = nxt
            dt = time.perf_counter() - tc
            if t == 0:
                stats["compile_s"] = dt
            else:
                stats["stream_s"] += dt
        if n_tiles > 1:
            stats["stream_s"] *= n_tiles / (n_tiles - 1)
        stats["compute_s"] = stats["stream_s"]
    else:
        for t in range(n_tiles):
            tt = time.perf_counter()
            h0 = stats["host_s"]
            args = prep_upload(t)
            sync()
            stats["transfer_s"] += (time.perf_counter() - tt
                                    - (stats["host_s"] - h0))
            tc = time.perf_counter()
            res = compute(*args)
            sync()
            dt = time.perf_counter() - tc
            if t == 0:
                stats["compile_s"] = dt       # first tile: build and launch
            else:
                stats["compute_s"] += dt
            tt = time.perf_counter()
            h0 = stats["host_s"]
            download(args[0], *res)
            del res
            stats["transfer_s"] += (time.perf_counter() - tt
                                    - (stats["host_s"] - h0))
        if n_tiles > 1:
            stats["compute_s"] *= n_tiles / (n_tiles - 1)
    stats["h2d_bytes"] = stager.h2d_bytes
    stats["d2h_bytes"] = stager.d2h_bytes
    return anal_out, infl_out, stats
