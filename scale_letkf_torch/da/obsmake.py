"""Synthetic observations for OSSE twin experiments.

Port of scale_letkf_tpu/da/obsmake.py (reference `obsmake_cal`,
scale/obs/obsope_tools.f90:767-1060): H(x) of a nature run plus Gaussian
noise at the configured obs errors (PARAM_OBS_ERROR). The noise comes from
the caller's numpy Generator in the reference's order, so one seed gives
the same obs in both packages (to the float32 rounding of H(x)).
Himawari-8 obs take |BT| (the all-sky BT without its cloudy-sky sign flag)
and keep whole profiles, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.config import Config
from scale_letkf_torch.da.obsope import compute_hx_single
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.obs.types import (
    ID_H08IR, ID_PS, ID_Q, ID_RADAR_REF, ID_RADAR_VR, ID_RH, ID_T, ID_U,
    ID_V, QC_GOOD, QC_OUT_H, Observations,
)


def default_err(elem: np.ndarray, cfg: Config, lev=None) -> np.ndarray:
    """Obs error stdev per obs from cfg.obs_error; 1 for other elements.
    H08 obs (given lev) take the per-channel OBSERR_H08 entry at lev − 1,
    clipped to the table, as the reference indexes it."""
    e = cfg.obs_error
    table = {ID_U: e.u, ID_V: e.v, ID_T: e.t, ID_Q: e.q, ID_RH: e.rh,
             ID_PS: e.ps, ID_RADAR_REF: e.radar_ref, ID_RADAR_VR: e.radar_vr}
    out = np.ones(len(elem))
    for k, v in table.items():
        out[elem == k] = v
    m = elem == ID_H08IR
    if m.any() and lev is not None:
        ch = np.clip(np.asarray(lev)[m].astype(int) - 1, 0, len(e.h08) - 1)
        out[m] = np.asarray(e.h08)[ch]
    return out


def make_obs_network(grid: Grid, rng: np.random.Generator,
                     n_profiles: int = 20, elems=(ID_U, ID_V, ID_T, ID_Q),
                     levels_hpa=(850.0, 700.0, 500.0, 300.0),
                     typ: int = 0) -> Observations:
    """Random radiosonde-like network: n_profiles sites × levels × elems,
    sites two cells or more inside the domain's edge."""
    lon2d, lat2d = grid.lonlat
    ny, nx = lon2d.shape
    si = rng.integers(2, nx - 2, n_profiles)
    sj = rng.integers(2, ny - 2, n_profiles)
    nl, ne = len(levels_hpa), len(elems)
    n = n_profiles * nl * ne
    return Observations(
        elem=np.tile(np.asarray(elems, np.int32), n_profiles * nl),
        lon=np.repeat(lon2d[sj, si], nl * ne),
        lat=np.repeat(lat2d[sj, si], nl * ne),
        lev=np.tile(np.repeat(np.asarray(levels_hpa) * 100.0, ne),
                    n_profiles),
        dat=np.zeros(n), err=np.ones(n), typ=np.full(n, typ, np.int32),
        dif=np.zeros(n))


def obsmake(nature_fields: dict, obs_template: Observations, grid: Grid,
            cfg: Config, z_full: torch.Tensor,
            rng: np.random.Generator) -> Observations:
    """Nature-run H(x) + noise → synthetic obs (obsope_tools.f90:1000-1041);
    obs with bad QC (outside the domain or the levels) are dropped. H08
    profiles are written whole: their channels are kept whatever the
    channel gate says, unless the profile lies outside the domain."""
    y, qc = compute_hx_single(nature_fields, obs_template, grid, cfg, z_full)
    y = y.cpu().numpy().astype(np.float64)
    qc = qc.cpu().numpy()
    m_h08 = obs_template.elem == ID_H08IR
    y[m_h08] = np.abs(y[m_h08])
    err = default_err(obs_template.elem, cfg, obs_template.lev)
    obs = obs_template.select(slice(None))
    obs.err = err
    obs.dat = y + rng.standard_normal(len(y)) * err
    return obs.select((qc == QC_GOOD) | (m_h08 & (qc != QC_OUT_H)))
