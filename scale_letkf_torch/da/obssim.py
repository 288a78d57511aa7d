"""Observation simulator: obs quantities at every gridpoint of a model
state.

Port of scale_letkf_tpu/da/obssim.py (reference `obssim_cal`,
scale/obs/obsope_tools.f90:1063+, driver scale/obs/obssim.f90): requested
obs variables (winds, temperature, humidity, surface pressure, radar
reflectivity and radial velocity) on the model grid, for visualization and
verification, and the flat-binary GrADS writer.
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.config import Config
from scale_letkf_torch.constants import FVIRT
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.obs.operators import calc_ref_vr, radar_geometry
from scale_letkf_torch.obs.types import (
    ID_PS, ID_Q, ID_RADAR_REF, ID_RADAR_VR, ID_RH, ID_T, ID_TV, ID_U, ID_V,
)


def obssim(fields: dict, elems: list[int], grid: Grid, cfg: Config,
           radar_lonlatz: tuple | None = None) -> dict[int, torch.Tensor]:
    """Simulated obs fields per requested variable id, from one state's
    history fields (state_to_history): (ny, nx) for PS, (nz, ny, nx) for
    the others. The radar beam geometry of every gridpoint is host float64
    (radar_geometry), cast to the fields' dtype."""
    out = {}
    if any(e in (ID_RADAR_REF, ID_RADAR_VR) for e in elems):
        if radar_lonlatz is None:
            raise ValueError("radar position required for radar simulation")
        t = fields["t"]
        lon2d, lat2d = grid.lonlat
        hgt = fields["hgt"].cpu().numpy().astype(np.float64)
        az, elev, _ = radar_geometry(np.broadcast_to(lon2d, hgt.shape),
                                     np.broadcast_to(lat2d, hgt.shape), hgt,
                                     *radar_lonlatz)
        ref, vr = calc_ref_vr(
            fields["q"], fields["qc"], fields["qr"], fields["qi"],
            fields["qs"], fields["qg"], fields["u"], fields["v"],
            fields["w"], t, fields["p"],
            torch.as_tensor(az, dtype=t.dtype, device=t.device),
            torch.as_tensor(elev, dtype=t.dtype, device=t.device),
            method=cfg.radar.method_ref_calc,
            use_terminal_velocity=cfg.radar.use_terminal_velocity)
        dbz = 10.0 * torch.log10(torch.clamp(ref, min=cfg.radar.min_radar_ref))
    simple = {ID_U: "u", ID_V: "v", ID_T: "t", ID_Q: "q", ID_RH: "rh",
              ID_PS: "ps"}
    for e in elems:
        if e in simple:
            out[e] = fields[simple[e]]
        elif e == ID_TV:
            out[e] = fields["t"] * (1.0 + FVIRT * fields["q"])
        elif e == ID_RADAR_REF:
            out[e] = dbz
        elif e == ID_RADAR_VR:
            out[e] = vr
        else:
            raise ValueError(f"obssim: unsupported variable id {e}")
    return out


def write_grads(path: str, fields3d: list, fields2d: list | None = None):
    """Flat-binary GrADS-style output: all 3-D variables (level-major), then
    the 2-D ones (write_grd_mpi analogue, obsope_tools.f90:1156); tensors
    on any device or arrays."""
    with open(path, "wb") as f:
        for a in [*fields3d, *(fields2d or [])]:
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            np.asarray(a, np.float32).tofile(f)
