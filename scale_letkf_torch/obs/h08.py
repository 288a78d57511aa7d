"""Himawari-8 AHI infrared radiance forward operator.

Port of scale_letkf_tpu/obs/h08.py (reference: Trans_XtoY_H08,
common_obs_scale.f90:2777-2970, around SCALE_RTTOV_fwd,
scale_H08_fwd.F90:6-26). RTTOV is not redistributable; the reference ships
a parameterized broadband band-emission model with the same interface —
per-band water-vapour absorption with pressure broadening, fixed-gas gray
absorption, gray liquid and ice absorption, a geostationary slant path and
Planck emission integrated from the top down — and so does the port.

Differences from the JAX module:
- the band coefficients (K_WV, K_FIX, WV_P_EXP) are an explicit
  `H08Coefficients` argument of `h08_rt_fwd` and `trans_xtoy_h08`, the
  module constants by default; `load_calibration` returns one instead of
  rebinding module globals (the reference's closes over them at trace time);
- `h08_rt_fwd(..., band=)` computes each profile's own band only: per
  profile the same arithmetic as the reference's ten bands followed by a
  pick, with (..., nobs, nz) intermediates instead of (..., nobs, nz, 10);
  `trans_xtoy_h08` takes that path;
- profiles carry any leading axes (a member axis in place of jax.vmap); the
  satellite zenith angle is obs geometry, computed on the host in float64
  (`satellite_zenith` takes numpy or tensors).
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from scale_letkf_torch.constants import D2R, GRAV
from scale_letkf_torch.obs.types import QC_GOOD, QC_OBS_BAD

NCHAN = 10  # AHI bands B07..B16 (common_nml.f90 nch)

# Band-center wavenumbers [cm^-1] of AHI B07..B16 (3.885 ... 13.281 um)
WAVENUM = (2574.0, 1602.0, 1441.0, 1361.0, 1164.0,
           1038.0, 961.0, 890.0, 808.0, 753.0)
# Water-vapour mass absorption [m^2/kg] at P0 per band
K_WV = (0.008, 1.6, 0.55, 0.22, 0.012, 0.010, 0.006, 0.006, 0.012, 0.010)
# Fixed-gas gray absorption [m^2 per kg of air]: CO2 (B16), O3 (B12)
K_FIX = (5e-6, 8e-6, 8e-6, 8e-6, 5e-6, 1.2e-4, 5e-6, 4e-6, 8e-6, 3.5e-4)
# Pressure-broadening exponent of the WV optical depth, k ~ (p/P0)^exp
WV_P_EXP = 0.8
P0 = 1.0e5  # Pa
# Gray hydrometeor mass absorption [m^2/kg] (liquid r_eff ~10 um, ice ~30 um)
K_LIQ = 140.0
K_ICE = 60.0
# Planck constants for wavenumber in cm^-1
C1 = 1.191042e-8   # W / (m^2 sr cm^-4)
C2 = 1.4387752     # K cm
# Himawari-8 sub-satellite longitude and geostationary altitude
SAT_LON = 140.7
SAT_ALT = 35786.0e3
R_EARTH = 6371.0e3


class H08Coefficients(NamedTuple):
    """The calibration surface of the band model."""
    k_wv: tuple = K_WV
    k_fix: tuple = K_FIX
    wv_p_exp: float = WV_P_EXP


DEFAULT_COEF = H08Coefficients()


def load_calibration(path: str) -> H08Coefficients:
    """Fitted band coefficients (obs/h08_calibrate.py's JSON output, e.g.
    docs/h08_calibration.json)."""
    with open(path) as f:
        d = json.load(f)
    return H08Coefficients(k_wv=tuple(float(v) for v in d["k_wv"]),
                           k_fix=tuple(float(v) for v in d["k_fix"]),
                           wv_p_exp=float(d["wv_p_exp"]))


def _band_const(values, like: torch.Tensor, band) -> torch.Tensor:
    """Per-band constants as a trailing band axis: (NCHAN,) for all bands,
    or each profile's own (..., 1) when band (...,) is given."""
    c = torch.as_tensor(values, dtype=like.dtype, device=like.device)
    return c if band is None else c[band][..., None]


def planck_rad(t: torch.Tensor, wn) -> torch.Tensor:
    """Planck radiance at temperature t [K], wavenumber wn [cm^-1]."""
    return C1 * wn ** 3 / (torch.exp(C2 * wn / t) - 1.0)


def planck_bt(rad: torch.Tensor, wn) -> torch.Tensor:
    """Inverse Planck: radiance → brightness temperature."""
    return C2 * wn / torch.log1p(C1 * wn ** 3 / torch.clamp(rad, min=1e-30))


def satellite_zenith(lon, lat):
    """Geostationary satellite zenith angle [rad] at (lon, lat) [deg] (the
    reference computes it inside SCALE_RTTOV_fwd, common_obs_scale.f90:2890).
    numpy in, numpy out (float64 host geometry); a tensor in, a tensor out."""
    xp = torch if isinstance(lon, torch.Tensor) else np
    cos_psi = xp.cos(lat * D2R) * xp.cos((lon - SAT_LON) * D2R)
    r = R_EARTH + SAT_ALT
    sin_zen = r * xp.sqrt(xp.clip(1.0 - cos_psi ** 2, 0.0, None)) / xp.sqrt(
        R_EARTH ** 2 + r ** 2 - 2.0 * R_EARTH * r * cos_psi)
    return xp.arcsin(xp.clip(sin_zen, 0.0, 1.0))


def h08_rt_fwd(p, t, qv, qliq, qice, tsfc, psfc, zenith,
               coef: H08Coefficients = DEFAULT_COEF, band=None):
    """Broadband IR radiative transfer (SCALE_RTTOV_fwd analogue).

    p, t, qv, qliq, qice (..., nz), k ascending (p decreasing); tsfc, psfc,
    zenith (...). Returns (btall, btclr, plev): all-sky and clear-sky BT and
    the all-sky weighting function's peak pressure [Pa], the obs' vertical
    localization level (common_obs_scale.f90:2910-2933) — each (..., NCHAN),
    or (...) for the bands `band` (..., long, 0-based) when given."""
    # layer air mass [kg/m^2] centered on each level: dm_k = -dp_k / g
    mid = 0.5 * (p[..., :-1] + p[..., 1:])
    p_lo = torch.cat([psfc[..., None], mid], dim=-1)
    p_hi = torch.cat([mid, 0.5 * p[..., -1:]], dim=-1)   # TOA at p_top/2
    dm = torch.clamp(p_lo - p_hi, min=0.0) / GRAV          # (..., nz)

    wn = _band_const(WAVENUM, p, band)
    pb = (torch.clamp(p, min=1.0) / P0) ** coef.wv_p_exp
    sec = (1.0 / torch.clamp(torch.cos(zenith), min=0.2))[..., None, None]

    # layer optical depths (..., nz, bands)
    od_gas = (_band_const(coef.k_wv, p, band)[..., None, :]
              * (qv * pb * dm)[..., None]
              + _band_const(coef.k_fix, p, band)[..., None, :]
              * dm[..., None]) * sec
    od_cld = (K_LIQ * (qliq * dm)[..., None]
              + K_ICE * (qice * dm)[..., None]) * sec
    b = planck_rad(torch.flip(t, dims=[-1])[..., None], wn[..., None, :])
    b_sfc = planck_rad(tsfc[..., None], wn)
    dp = torch.clamp(torch.flip(dm, dims=[-1]) * GRAV, min=1.0)[..., None]
    p_rev = torch.flip(p, dims=[-1])

    def integrate(od):
        # transmittance from TOA down to the top of each layer: accumulate
        # from the model top (flipped first); ensemble-perturbed inputs can
        # carry tiny negative q, hence the clamp
        od_rev = torch.clamp(torch.flip(od, dims=[-2]), min=0.0)
        tau_above = torch.exp(-torch.cumsum(od_rev, dim=-2) + od_rev)
        tau_below = tau_above * torch.exp(-od_rev)
        dtau = tau_above - tau_below                       # emission weight
        rad = torch.sum(b * dtau, dim=-2) + b_sfc * tau_below[..., -1, :]
        # weighting-function peak: max dtau/dp over the layers
        kmax = torch.argmax(dtau / dp, dim=-2)             # (..., bands)
        return planck_bt(rad, wn), torch.gather(p_rev, -1, kmax)

    btclr, _ = integrate(od_gas)
    btall, plev = integrate(od_gas + od_cld)
    if band is not None:
        return btall[..., 0], btclr[..., 0], plev[..., 0]
    return btall, btclr, plev


def band_index(ch: np.ndarray) -> np.ndarray:
    """0-based band of the AHI band numbers 7..16 that read_obs_H08 stores
    in obs lev (common_obs_scale.f90:3057), clipped to the bands."""
    return np.clip(np.asarray(ch).astype(np.int32) - 7, 0, NCHAN - 1)


def trans_xtoy_h08(ch: np.ndarray, ri: torch.Tensor, rj: torch.Tensor,
                   zenith: torch.Tensor, fields: dict, *,
                   ch_use: tuple = (0, 0, 1, 0, 0, 0, 0, 0, 0, 0),
                   cldsky_thrs: float = -5.0, reject_land: bool = False,
                   coef: H08Coefficients = DEFAULT_COEF):
    """Trans_XtoY_H08 analogue (common_obs_scale.f90:2777-2970) on history
    fields with any leading axes. ch: the obs' AHI band numbers (host);
    ri, rj, zenith: per-obs tensors in the fields' dtype.

    Returns (yobs, btclr, plev, qc), each (..., nobs). As in the reference,
    yobs is the all-sky BT negated when |BT_all − BT_clr| > cldsky_thrs
    flags the column cloudy (set_letkf_obs counts negative members as
    cloudy, letkf_obs.f90:448-455; a negative threshold flags every
    column), and H08_CH_USE gates the channels."""
    from scale_letkf_torch.obs.operators import itpl_2d, itpl_2d_column

    t = fields["t"]
    chi = band_index(ch)
    p = itpl_2d_column(fields["p"], ri, rj)
    prof = itpl_2d_column(t, ri, rj)
    qv = itpl_2d_column(fields["q"], ri, rj)
    qliq = itpl_2d_column(fields["qc"] + fields["qr"], ri, rj)
    qice = itpl_2d_column(fields["qi"] + fields["qs"] + fields["qg"], ri, rj)
    tsfc = itpl_2d(fields["t2m"], ri, rj)
    psfc = itpl_2d(fields["ps"], ri, rj)
    band = torch.as_tensor(chi, dtype=torch.long, device=t.device)
    bt, bc, pl = h08_rt_fwd(p, prof, qv, qliq, qice, tsfc, psfc,
                            zenith.expand(tsfc.shape), coef,
                            band.expand(tsfc.shape))
    yobs = torch.where(torch.abs(bt - bc) > cldsky_thrs, -bt, bt)
    use = np.asarray(ch_use, np.int32)[chi] == 1
    qc = torch.as_tensor(np.where(use, QC_GOOD, QC_OBS_BAD).astype(np.int32),
                         device=t.device).expand(yobs.shape)
    lsmask = fields.get("lsmask")
    if reject_land and lsmask is not None:
        qc = torch.where(itpl_2d(lsmask, ri, rj) > 0.5, QC_OBS_BAD, qc)
    return yobs, bc, pl, qc


def rttov_fwd(profiles: dict, coef: H08Coefficients = DEFAULT_COEF):
    """The reference's alias of the band model's forward driver: profiles
    'p', 't', 'qv', 'qliq', 'qice', 'tsfc', 'psfc' and optionally 'lon',
    'lat' (zenith 0 without them)."""
    if "lon" in profiles:
        zen = satellite_zenith(profiles["lon"], profiles["lat"])
    else:
        zen = torch.zeros_like(profiles["tsfc"])
    return h08_rt_fwd(profiles["p"], profiles["t"], profiles["qv"],
                      profiles["qliq"], profiles["qice"], profiles["tsfc"],
                      profiles["psfc"], zen, coef)
