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
device. The radar operator runs only when the batch holds radar obs, as in
the reference. Himawari-8 radiances (obs/h08.py) are not ported: H08 obs
raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scale_letkf_torch.config import Config
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.obs import operators as op
from scale_letkf_torch.obs.types import (
    ID_H08IR, ID_RADAR_REF, ID_RADAR_REF_ZERO, ID_RADAR_VR, QC_RADAR_VHI,
    QC_TIME, Observations,
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
    QC over the members, is host numpy. lev and val2 (the H08 sensitive
    pressure and clear-sky BT) stay None until obs/h08.py is ported."""
    ensval: torch.Tensor
    qc: np.ndarray
    lev: np.ndarray | None = None
    val2: np.ndarray | None = None


def compute_hx_single(fields: dict, obs: Observations, grid: Grid,
                      cfg: Config, z_full: torch.Tensor):
    """H(x) of history fields (state_to_history; any leading axes) for all
    obs: (y, qc), each (..., nobs) on the fields' device."""
    if np.any(obs.elem == ID_H08IR):
        raise NotImplementedError(
            "Himawari-8 radiance obs (ID_H08IR, obs/h08.py) are not ported "
            "yet (ROADMAP queue 1, obs/h08.py)")
    t = fields["t"]

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=t.dtype, device=t.device)

    ri_h, rj_h = grid.lonlat_to_ij(obs.lon, obs.lat)
    ri, rj, lev = put(ri_h), put(rj_h), put(obs.lev)
    rot = tuple(put(a) for a in grid.proj.rotcoef(obs.lon, obs.lat))
    elem = torch.as_tensor(obs.elem, device=t.device)

    # vertical coordinate: height for radar obs, log-p for the others
    rk, qc_vert = op.phys2ijk(fields["p"], elem, ri, rj, lev)
    radar_h = is_radar_elem(obs.elem)
    has_radar = bool(radar_h.any())
    if has_radar:
        radar = torch.as_tensor(radar_h, device=t.device)
        rk_z, qc_z = op.phys2ijkz(z_full, ri, rj, lev)
        rk = torch.where(radar, rk_z, rk)
        qc_vert = torch.where(radar, qc_z, qc_vert)

    y, qc = op.trans_xtoy_conv(elem, ri, rj, rk, rot, fields,
                               ps_adjust_thres=cfg.letkf.ps_adjust_thres)
    if has_radar:
        r = cfg.radar
        az, elev, at_site = op.radar_geometry(obs.lon, obs.lat, obs.lev,
                                              *obs.meta)
        y_rad, qc_rad = op.trans_xtoy_radar(
            elem, ri, rj, rk, rot, put(az), put(elev),
            torch.as_tensor(at_site, device=t.device), fields,
            method=r.method_ref_calc,
            use_terminal_velocity=r.use_terminal_velocity,
            min_radar_ref=r.min_radar_ref,
            min_radar_ref_dbz=r.min_radar_ref_dbz,
            low_ref_shift=r.low_ref_shift)
        y = torch.where(radar, y_rad, y)
        qc = torch.where(radar, qc_rad, qc)
    qc = torch.maximum(qc, qc_vert)
    if has_radar:
        # radar height limit (RADAR_ZMAX, common_nml.f90:278)
        too_high = torch.as_tensor(radar_h & (obs.lev > cfg.radar.radar_zmax),
                                   device=t.device)
        qc = torch.where(too_high, QC_RADAR_VHI, qc)
    return y, qc


def obsope_ensemble(fields: dict, obs: Observations, grid: Grid, cfg: Config,
                    z_full: torch.Tensor) -> ObsOpeResult:
    """Ensemble H(x) in one time slot: fields from state_to_history of the
    ensemble, K leading."""
    y, qc = compute_hx_single(fields, obs, grid, cfg, z_full)
    return ObsOpeResult(ensval=y, qc=qc.amax(dim=0).cpu().numpy())


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
    y = torch.zeros((K, obs.nobs), dtype=z_full.dtype, device=dev)
    qc = torch.zeros((K, obs.nobs), dtype=torch.int32, device=dev)
    for s in range(S):
        m = np.nonzero(sl == s)[0]
        if len(m) == 0:
            continue
        fields = state_to_history(
            torch.as_tensor(hist[:, s], dtype=z_full.dtype, device=dev),
            z_full, topo)
        idx = torch.as_tensor(m, device=dev)
        y[:, idx], qc[:, idx] = compute_hx_single(fields, obs.select(m), grid,
                                                  cfg, z_full)
        del fields
    qc_w = np.where(in_window, qc.amax(dim=0).cpu().numpy(), QC_TIME)
    return ObsOpeResult(ensval=y, qc=qc_w.astype(np.int32))
