"""Topography preprocessing: the `scale-rm_pp_ens` step.

Port of scale_letkf_tpu/model/topo.py. The reference system delegates the
preparation of topography to SCALE's CNVTOPO (scale-rm_pp_ens.f90 →
scalerm_prep) and reads the prepared per-rank files (read_topo,
common_scale.f90:785); here the same step is one remap and a slope-limited
smoothing giving the (ny, nx) topography that Grid.calc_z and the terrain
metrics take:

  1. read a lat/lon DEM raster (flat binary or .npz),
  2. area-average it onto the model grid's (lon, lat) points (host numpy
     float64, as the reference),
  3. 1-2-1 Laplacian smoothing passes until the steepest slope is below a
     limit (CNVTOPO's maximum-slope-angle control) — the reference's
     lax.while_loop as a loop of passes on the caller's device, its
     stopping test the reference's float32 slope test,
  4. relax the lateral rings toward their mean, so the boundary forcing
     sees quasi-uniform terrain.
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.grid import Grid


def read_dem(path: str, *, nlon: int | None = None, nlat: int | None = None,
             lon0: float | None = None, dlon: float | None = None,
             lat0: float | None = None, dlat: float | None = None):
    """A lat/lon DEM in one of two layouts: ``.npz`` with arrays ``elev``
    (nlat, nlon), ``lon`` (nlon,) and ``lat`` (nlat,); or a flat float32
    raster (GrADS-style, what CNVTOPO reads for GTOPO30 tiles) with its
    geometry given. Returns (elev (nlat, nlon) float64, lon, lat)."""
    if path.endswith(".npz"):
        d = np.load(path)
        return (np.asarray(d["elev"], np.float64),
                np.asarray(d["lon"], np.float64),
                np.asarray(d["lat"], np.float64))
    if None in (nlon, nlat, lon0, dlon, lat0, dlat):
        raise ValueError("flat-binary DEM needs nlon/nlat/lon0/dlon/lat0/dlat")
    elev = np.fromfile(path, np.float32).astype(np.float64)
    if elev.size != nlon * nlat:
        raise ValueError(f"{path}: size {elev.size} != {nlon}x{nlat}")
    return (elev.reshape(nlat, nlon), lon0 + dlon * np.arange(nlon),
            lat0 + dlat * np.arange(nlat))


def remap_dem_to_grid(elev: np.ndarray, dem_lon: np.ndarray,
                      dem_lat: np.ndarray, grid: Grid,
                      supersample: int = 2) -> np.ndarray:
    """DEM raster → model-grid topography (ny, nx), float64: each model
    cell sampled on a supersample × supersample sub-grid of its footprint,
    each sample bilinear in the DEM (CNVTOPO's averaged interpolation);
    ocean or missing cells (elev < 0 or NaN) clamp to 0."""
    ny, nx = grid.ny, grid.nx
    s = max(1, int(supersample))
    off = (np.arange(s) + 0.5) / s - 0.5         # sub-cell offsets
    oj, oi = np.meshgrid(off, off, indexing="ij")
    jj, ii = np.meshgrid(np.arange(ny, dtype=np.float64),
                         np.arange(nx, dtype=np.float64), indexing="ij")
    ri = (ii[None, None] + oi[:, :, None, None]).reshape(-1, ny, nx)
    rj = (jj[None, None] + oj[:, :, None, None]).reshape(-1, ny, nx)
    lon, lat = (np.asarray(a) for a in grid.ij_to_lonlat(ri, rj))

    fi = np.interp(lon.ravel(), dem_lon, np.arange(len(dem_lon)))
    fj = np.interp(lat.ravel(), dem_lat, np.arange(len(dem_lat)))
    i0 = np.clip(fi.astype(int), 0, len(dem_lon) - 2)
    j0 = np.clip(fj.astype(int), 0, len(dem_lat) - 2)
    ai = np.clip(fi - i0, 0.0, 1.0)
    aj = np.clip(fj - j0, 0.0, 1.0)
    e = np.nan_to_num(elev, nan=0.0)
    v = (e[j0, i0] * (1 - ai) * (1 - aj) + e[j0, i0 + 1] * ai * (1 - aj)
         + e[j0 + 1, i0] * (1 - ai) * aj + e[j0 + 1, i0 + 1] * ai * aj)
    return np.maximum(v.reshape(s * s, ny, nx).mean(axis=0), 0.0)


def max_slope(h: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """max(|∂h/∂x|, |∂h/∂y|) of one-sided differences, in h's dtype."""
    gx = torch.abs(torch.diff(h, dim=1)) / dx
    gy = torch.abs(torch.diff(h, dim=0)) / dy
    return torch.maximum(gx.max(), gy.max())


def smooth_pass(h: torch.Tensor) -> torch.Tensor:
    """One conservative 1-2-1 pass (edge-repeating ghost cells):
    h + (Σ neighbours − 4h)/8."""
    hp = torch.nn.functional.pad(h[None, None], (1, 1, 1, 1),
                                 mode="replicate")[0, 0]
    lap = (hp[1:-1, :-2] + hp[1:-1, 2:] + hp[:-2, 1:-1] + hp[2:, 1:-1]
           - 4.0 * h)
    return h + 0.125 * lap


def smooth_topo(topo, dx: float, dy: float, max_slope_ratio: float = 0.5,
                itelim: int = 100, device: torch.device | None = None
                ) -> tuple[torch.Tensor, int]:
    """Slope-limited Laplacian smoothing (CNVTOPO's maximum-slope control):
    1-2-1 passes while max(|∂h/∂x|, |∂h/∂y|) > max_slope_ratio (the tangent
    of the steepest slope allowed), at most itelim passes, in float32 on
    `device` (topo's, or the CPU for numpy). The filter keeps the
    domain-mean elevation. Returns (topography, passes)."""
    h = torch.as_tensor(np.asarray(topo) if not isinstance(topo, torch.Tensor)
                        else topo, dtype=torch.float32, device=device)
    lim = torch.tensor(np.float32(max_slope_ratio), device=h.device)
    passes = 0
    # one host sync a pass, for the stopping test
    while passes < itelim and bool(max_slope(h, dx, dy) > lim):
        h = smooth_pass(h)
        passes += 1
    return h, passes


def flatten_halo(topo: torch.Tensor, width: int = 2) -> torch.Tensor:
    """Relax the outermost `width` rings toward their mean, so the lateral
    boundary forcing sees quasi-uniform terrain."""
    if width <= 0:
        return topo
    ny, nx = topo.shape
    edge = torch.cat([topo[:width].ravel(), topo[-width:].ravel(),
                      topo[:, :width].ravel(), topo[:, -width:].ravel()])
    mean = edge.mean()
    j = torch.arange(ny, device=topo.device)[:, None]
    i = torch.arange(nx, device=topo.device)[None, :]
    d = torch.minimum(torch.minimum(j, ny - 1 - j),
                      torch.minimum(i, nx - 1 - i))
    w = torch.clamp(d / width, 0.0, 1.0)          # 0 at the edge, 1 inside
    return topo * w + mean * (1.0 - w)


def prepare_topo(elev: np.ndarray, dem_lon: np.ndarray, dem_lat: np.ndarray,
                 grid: Grid, *, max_slope_ratio: float = 0.5,
                 halo_width: int = 2, supersample: int = 2,
                 device: torch.device | None = None
                 ) -> tuple[np.ndarray, int]:
    """The whole pp step: remap (host), smoothing and halo flattening (on
    `device`, the CPU by default). Returns ((ny, nx) float64, the smoothing
    passes)."""
    topo = remap_dem_to_grid(elev, dem_lon, dem_lat, grid,
                             supersample=supersample)
    h, passes = smooth_topo(topo, grid.dx, grid.dy,
                            max_slope_ratio=max_slope_ratio, device=device)
    return flatten_halo(h, halo_width).cpu().double().numpy(), passes
