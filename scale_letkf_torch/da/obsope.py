"""Observation-operator driver: the ensemble H(x), in one time slot or
matched to the time slots of a 4-D window.

Port of scale_letkf_tpu/da/obsope.py (reference `obsope_cal`,
scale/obs/obsope_tools.f90:38-762): obs coordinates to fractional grid
indices, the forward operators of obs/operators.py against each member's
history fields, and the worst QC over the members. Members are a leading
axis of every field (in place of the reference's jax.vmap), so one call
covers the ensemble.

The obs geometry (grid indices, wind rotation, radar beam angles) is
computed on the host in float64 and cast to the fields' dtype on their
device. The radar operator runs only when the batch holds radar obs, and
the Himawari-8 radiance operator (obs/h08.py) only when it holds H08 obs,
as in the reference; the port computes it on the H08 obs alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scale_letkf_torch.config import Config
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.obs import operators as op
from scale_letkf_torch.obs.h08 import satellite_zenith, trans_xtoy_h08
from scale_letkf_torch.obs.types import (
    ID_H08IR, ID_RADAR_REF, ID_RADAR_REF_ZERO, ID_RADAR_VR, QC_OUT_H,
    QC_RADAR_VHI, QC_TIME, Observations,
)
from scale_letkf_torch.state import state_to_history


def is_radar_elem(elem: np.ndarray) -> np.ndarray:
    return ((elem == ID_RADAR_REF) | (elem == ID_RADAR_REF_ZERO)
            | (elem == ID_RADAR_VR))


def assign_slots(dif: np.ndarray, cfg: Config) -> np.ndarray:
    """Time slot per obs (obsope_tools.f90:256: ceil(dif/Tslot - 0.5) + base)."""
    o = cfg.obsope
    return (np.ceil(dif / o.slot_tinterval - 0.5) + o.slot_base).astype(np.int32)


@dataclass
class ObsOpeResult:
    """Per-obs ensemble H(x) with QC (obs_da_value analogue). ensval
    (K, nobs) stays a tensor on the fields' device; qc (nobs,), the worst
    QC over the members, is host numpy, and so are lev and val2: the H08
    sensitive pressure [Pa] and clear-sky BT [K], means over the members
    (zero for the other obs)."""
    ensval: torch.Tensor
    qc: np.ndarray
    lev: np.ndarray | None = None
    val2: np.ndarray | None = None


@dataclass
class HxGeometry:
    """The obs geometry of compute_hx_single on the fields' device: grid
    indices, heights or pressures, wind rotation and elements of every obs;
    the radar beam angles and height limit when radar obs are present; the
    H08 obs's indices, bands, satellite zenith angles and out-of-domain
    flags when H08 obs are present (else None). Computed on the host in
    float64 (hx_geometry) and cast once; a fixed network keeps it."""
    ri: torch.Tensor
    rj: torch.Tensor
    lev: torch.Tensor
    rot: tuple
    elem: torch.Tensor
    radar: torch.Tensor | None = None
    radar_az: torch.Tensor | None = None
    radar_elev: torch.Tensor | None = None
    radar_at_site: torch.Tensor | None = None
    radar_too_high: torch.Tensor | None = None
    h08: torch.Tensor | None = None
    h08_band: np.ndarray | None = None
    h08_zenith: torch.Tensor | None = None
    h08_out: torch.Tensor | None = None


def hx_geometry(obs: Observations, grid: Grid, cfg: Config,
                dtype: torch.dtype, device: torch.device) -> HxGeometry:
    """HxGeometry of `obs` in `dtype` on `device`."""
    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    ri_h, rj_h = grid.lonlat_to_ij(obs.lon, obs.lat)
    g = HxGeometry(ri=put(ri_h), rj=put(rj_h), lev=put(obs.lev),
                   rot=tuple(put(a) for a in grid.proj.rotcoef(obs.lon,
                                                               obs.lat)),
                   elem=torch.as_tensor(obs.elem, device=device))
    radar_h = is_radar_elem(obs.elem)
    if radar_h.any():
        az, elev, at_site = op.radar_geometry(obs.lon, obs.lat, obs.lev,
                                              *obs.meta)
        g.radar = torch.as_tensor(radar_h, device=device)
        g.radar_az, g.radar_elev = put(az), put(elev)
        g.radar_at_site = torch.as_tensor(at_site, device=device)
        # radar height limit (RADAR_ZMAX, common_nml.f90:278)
        g.radar_too_high = torch.as_tensor(
            radar_h & (obs.lev > cfg.radar.radar_zmax), device=device)
    h08 = np.nonzero(obs.elem == ID_H08IR)[0]
    if len(h08):
        ny, nx = grid.ny, grid.nx
        g.h08 = torch.as_tensor(h08, device=device)
        g.h08_band = obs.lev[h08]
        g.h08_zenith = put(satellite_zenith(obs.lon[h08], obs.lat[h08]))
        g.h08_out = torch.as_tensor(
            (ri_h[h08] < 0) | (ri_h[h08] > nx - 1) | (rj_h[h08] < 0)
            | (rj_h[h08] > ny - 1), device=device)
    return g


def compute_hx_single(fields: dict, obs: Observations, grid: Grid,
                      cfg: Config, z_full: torch.Tensor,
                      with_aux: bool = False):
    """H(x) of history fields (state_to_history; any leading axes) for all
    obs: (y, qc), each (..., nobs) on the fields' device; with_aux adds
    (lev, val2), the H08 sensitive pressure and clear-sky BT (zero for the
    other obs)."""
    t = fields["t"]
    return hx_of_geometry(fields, hx_geometry(obs, grid, cfg, t.dtype,
                                              t.device),
                          cfg, z_full, with_aux)


def hx_of_geometry(fields: dict, g: HxGeometry, cfg: Config,
                   z_full: torch.Tensor, with_aux: bool = False):
    """compute_hx_single from the obs geometry g: device work alone, no
    transfer from the host."""
    # vertical coordinate: height for radar obs, log-p for the others
    rk, qc_vert = op.phys2ijk(fields["p"], g.elem, g.ri, g.rj, g.lev)
    if g.radar is not None:
        rk_z, qc_z = op.phys2ijkz(z_full, g.ri, g.rj, g.lev)
        rk = torch.where(g.radar, rk_z, rk)
        qc_vert = torch.where(g.radar, qc_z, qc_vert)

    y, qc = op.trans_xtoy_conv(g.elem, g.ri, g.rj, rk, g.rot, fields,
                               ps_adjust_thres=cfg.letkf.ps_adjust_thres)
    if g.radar is not None:
        r = cfg.radar
        y_rad, qc_rad = op.trans_xtoy_radar(
            g.elem, g.ri, g.rj, rk, g.rot, g.radar_az, g.radar_elev,
            g.radar_at_site, fields, method=r.method_ref_calc,
            use_terminal_velocity=r.use_terminal_velocity,
            min_radar_ref=r.min_radar_ref,
            min_radar_ref_dbz=r.min_radar_ref_dbz,
            low_ref_shift=r.low_ref_shift)
        y = torch.where(g.radar, y_rad, y)
        qc = torch.where(g.radar, qc_rad, qc)
    qc = torch.maximum(qc, qc_vert)
    if g.radar is not None:
        qc = torch.where(g.radar_too_high, QC_RADAR_VHI, qc)

    # Himawari-8 IR radiances (Trans_XtoY_H08; the band in obs lev,
    # letkf_obs.f90:463-465), on the H08 obs alone; they bypass the
    # vertical QC of phys2ijk
    if with_aux:
        lev_aux, val2 = torch.zeros_like(y), torch.zeros_like(y)
    if g.h08 is not None:
        h = cfg.h08
        y_h, bclr, plev, qc_h = trans_xtoy_h08(
            g.h08_band, g.ri[g.h08], g.rj[g.h08], g.h08_zenith, fields,
            ch_use=h.h08_ch_use, cldsky_thrs=h.h08_cldsky_thrs,
            reject_land=h.h08_reject_land)
        y[..., g.h08] = y_h
        qc[..., g.h08] = torch.where(g.h08_out, QC_OUT_H, qc_h)
        if with_aux:
            lev_aux[..., g.h08] = plev
            val2[..., g.h08] = bclr
    if with_aux:
        return y, qc, lev_aux, val2
    return y, qc


def obsope_ensemble(fields: dict, obs: Observations, grid: Grid, cfg: Config,
                    z_full: torch.Tensor) -> ObsOpeResult:
    """Ensemble H(x) in one time slot: fields from state_to_history of the
    ensemble, K leading."""
    y, qc, lev, val2 = compute_hx_single(fields, obs, grid, cfg, z_full,
                                         with_aux=True)
    return ObsOpeResult(ensval=y, qc=qc.amax(dim=0).cpu().numpy(),
                        lev=lev.mean(dim=0).cpu().numpy(),
                        val2=val2.mean(dim=0).cpu().numpy())


def obsope_slots(hist, obs: Observations, grid: Grid, cfg: Config,
                 z_full: torch.Tensor, topo: torch.Tensor | None,
                 slots: np.ndarray) -> ObsOpeResult:
    """Ensemble H(x) of a 4-D window: each obs against the history snapshot
    of its own time slot (obsope_tools.f90:431-508). hist (K, S, NV3D, nz,
    ny, nx) holds the analysis variables of slots SLOT_START..SLOT_END and
    may live on the host (CycleDriver.forecast_slots, io/checkpoint
    load_history, numpy or torch): each slot is moved to z_full's device on
    its own, and only the obs of that slot go through the operators. Obs
    outside the window get QC_TIME."""
    o = cfg.obsope
    K, S = hist.shape[:2]
    dev = z_full.device
    sl = np.clip(slots - o.slot_start, 0, S - 1)
    in_window = (slots >= o.slot_start) & (slots <= o.slot_end)
    y, lev, val2 = (torch.zeros((K, obs.nobs), dtype=z_full.dtype,
                                device=dev) for _ in range(3))
    qc = torch.zeros((K, obs.nobs), dtype=torch.int32, device=dev)
    for s in range(S):
        m = np.nonzero(sl == s)[0]
        if len(m) == 0:
            continue
        fields = state_to_history(
            torch.as_tensor(hist[:, s], dtype=z_full.dtype, device=dev),
            z_full, topo)
        idx = torch.as_tensor(m, device=dev)
        y[:, idx], qc[:, idx], lev[:, idx], val2[:, idx] = compute_hx_single(
            fields, obs.select(m), grid, cfg, z_full, with_aux=True)
        del fields
    qc_w = np.where(in_window, qc.amax(dim=0).cpu().numpy(), QC_TIME)
    return ObsOpeResult(ensval=y, qc=qc_w.astype(np.int32),
                        lev=lev.mean(dim=0).cpu().numpy(),
                        val2=val2.mean(dim=0).cpu().numpy())
