"""Observation operators H(x): interpolation, vertical coordinate
conversion, the conventional and the radar forward operators.

Port of scale_letkf_tpu/obs/operators.py (reference:
scale/common/common_obs_scale.f90 — Trans_XtoY :264, Trans_XtoY_radar :342,
calc_ref_vr :626, prsadj :600, phys2ijk :999, phys2ijkz :1116,
itpl_2d/3d :1295-1366). Every function takes the whole obs batch and the
model fields at once; element-dependent results are computed for all obs
and selected by element.

Fields carry any leading axes (a member axis in place of the reference's
jax.vmap): a field (..., nz, ny, nx) gathered at per-obs points gives
(..., nobs). Gathers go through one flat index per member, (k·ny + j)·nx + i,
as in the reference. The horizontal coordinates ri, rj, the wind rotation
and the radar beam geometry are per-obs host data: the caller computes them
in float64 on the host (grid.lonlat_to_ij, Projection.rotcoef,
radar_geometry) and passes them as tensors in the fields' dtype.

Index convention: 0-based fractional gridpoint coordinates, ri ∈ [0, nx-1]
at cell centers; interpolation clamps to the valid box.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scale_letkf_torch.constants import D2R, GRAV, RD, RE
from scale_letkf_torch.obs.types import (
    ID_PS, ID_Q, ID_RADAR_REF, ID_RADAR_REF_ZERO, ID_RADAR_VR, ID_RH, ID_T,
    ID_TV, ID_U, ID_V, QC_GOOD, QC_OTYPE, QC_OUT_H, QC_OUT_VHI, QC_OUT_VLO,
    QC_PS_TER, QC_REF_LOW,
)

FVIRT_PRSADJ = 0.608  # virtual-T factor used by prsadj (common_obs_scale.f90:610)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

def _take(ff: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """ff (..., N) at flat indices idx (..., n), leading axes broadcast.
    (numpy's shape rule: torch.broadcast_shapes imports sympy on first use,
    seconds in a fresh process.)"""
    lead = np.broadcast_shapes(ff.shape[:-1], idx.shape[:-1])
    return torch.gather(ff.expand(lead + ff.shape[-1:]), -1,
                        idx.expand(lead + idx.shape[-1:]))


def _corner(r: torch.Tensor, n: int):
    """Lower corner index (clamped to [0, n-2]) of fractional coordinate r
    and the weight of the upper corner (clamped to [0, 1])."""
    i0 = torch.floor(r).long().clamp_(0, n - 2)
    return i0, torch.clamp(r - i0, 0.0, 1.0)


def itpl_2d(field: torch.Tensor, ri: torch.Tensor,
            rj: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of field (..., ny, nx) at (ri, rj): ri indexes
    x (the last axis), rj indexes y."""
    ny, nx = field.shape[-2:]
    i0, ai = _corner(ri, nx)
    j0, aj = _corner(rj, ny)
    ff = field.reshape(field.shape[:-2] + (ny * nx,))
    base = j0 * nx + i0
    return (_take(ff, base) * (1 - ai) * (1 - aj)
            + _take(ff, base + 1) * ai * (1 - aj)
            + _take(ff, base + nx) * (1 - ai) * aj
            + _take(ff, base + nx + 1) * ai * aj)


def itpl_3d(field: torch.Tensor, rk: torch.Tensor, ri: torch.Tensor,
            rj: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of field (..., nz, ny, nx) at (rk, ri, rj)."""
    nz, ny, nx = field.shape[-3:]
    k0, ak = _corner(rk, nz)
    i0, ai = _corner(ri, nx)
    j0, aj = _corner(rj, ny)
    ff = field.reshape(field.shape[:-3] + (nz * ny * nx,))
    base = (k0 * ny + j0) * nx + i0
    out = 0.0
    for dk, wk in ((0, 1 - ak), (1, ak)):
        for dj, wj in ((0, 1 - aj), (1, aj)):
            for di, wi in ((0, 1 - ai), (1, ai)):
                out = out + (_take(ff, base + (dk * ny + dj) * nx + di)
                             * wk * wj * wi)
    return out


def itpl_2d_column(field3d: torch.Tensor, ri: torch.Tensor,
                   rj: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of every level of field3d (..., nz, ny, nx) at
    the per-obs points (ri, rj) of shape (nobs,): profiles (..., nobs, nz)."""
    ny, nx = field3d.shape[-2:]
    i0 = torch.floor(ri).long().clamp_(0, nx - 2)
    j0 = torch.floor(rj).long().clamp_(0, ny - 2)
    ai = (ri - i0)[:, None]
    aj = (rj - j0)[:, None]
    ff = field3d.reshape(field3d.shape[:-2] + (ny * nx,))
    base = j0 * nx + i0

    def col(off):
        return ff.index_select(-1, base + off).movedim(-1, -2)
    return (col(0) * (1 - ai) * (1 - aj) + col(1) * ai * (1 - aj)
            + col(nx) * (1 - ai) * aj + col(nx + 1) * ai * aj)


# ---------------------------------------------------------------------------
# Vertical coordinate conversion
# ---------------------------------------------------------------------------

def _out_h(ri, rj, ny: int, nx: int) -> torch.Tensor:
    return (ri < 0) | (ri > nx - 1) | (rj < 0) | (rj > ny - 1)


def _bracket(prof: torch.Tensor, below: torch.Tensor):
    """Index kidx ∈ [1, nz-1] of the first level past the obs and the
    profile values at kidx-1 and kidx."""
    nz = prof.shape[-1]
    kidx = torch.sum(below, dim=-1).clamp_(1, nz - 1)[..., None]
    return (kidx[..., 0], torch.gather(prof, -1, kidx - 1)[..., 0],
            torch.gather(prof, -1, kidx)[..., 0])


def phys2ijk(p_full: torch.Tensor, elem: torch.Tensor, ri: torch.Tensor,
             rj: torch.Tensor, rlev: torch.Tensor):
    """Pressure level → fractional model level rk by log-p interpolation
    (common_obs_scale.f90:999-1110). p_full (..., nz, ny, nx); elem, ri, rj,
    rlev (nobs,). Surface obs (elem > 9999) pass rlev through as rk (the
    station elevation). Returns (rk, qc), each (..., nobs)."""
    ny, nx = p_full.shape[-2:]
    lnp = torch.log(itpl_2d_column(p_full, ri, rj))           # (..., nobs, nz)
    lnlev = torch.log(rlev)
    kidx, lo, hi = _bracket(lnp, lnp >= lnlev[:, None])
    rk3d = (kidx - 1) + (lnlev - lo) / (hi - lo)
    surface = elem > 9999
    rk = torch.where(surface, rlev, rk3d)
    qc = torch.full(rk.shape, QC_GOOD, dtype=torch.int32, device=rk.device)
    qc = torch.where(~surface & (lnlev < lnp[..., -1]), QC_OUT_VHI, qc)
    qc = torch.where(~surface & (lnlev > lnp[..., 0]), QC_OUT_VLO, qc)
    qc = torch.where(_out_h(ri, rj, ny, nx), QC_OUT_H, qc)
    return rk, qc


def phys2ijkz(z_full: torch.Tensor, ri: torch.Tensor, rj: torch.Tensor,
              rlev: torch.Tensor):
    """Height level → fractional model level rk (common_obs_scale.f90:
    1116-1236); z_full (..., nz, ny, nx) ascending in k."""
    ny, nx = z_full.shape[-2:]
    z_prof = itpl_2d_column(z_full, ri, rj)                    # (..., nobs, nz)
    kidx, lo, hi = _bracket(z_prof, z_prof <= rlev[:, None])
    rk = (kidx - 1) + (rlev - lo) / (hi - lo)
    qc = torch.full(rk.shape, QC_GOOD, dtype=torch.int32, device=rk.device)
    qc = torch.where(rlev > z_prof[..., -1], QC_OUT_VHI, qc)
    qc = torch.where(rlev < z_prof[..., 0], QC_OUT_VLO, qc)
    qc = torch.where(_out_h(ri, rj, ny, nx), QC_OUT_H, qc)
    return rk, qc


# ---------------------------------------------------------------------------
# Conventional forward operator
# ---------------------------------------------------------------------------

def prsadj(p, dz, t, q):
    """Hypsometric pressure adjustment to station height
    (common_obs_scale.f90:600-616): p' = p ((−γ·dz+Tv)/Tv)^(g/(γ Rd))."""
    gamma = 5.0e-3
    tv = t * (1.0 + FVIRT_PRSADJ * q)
    fac = ((-gamma * dz + tv) / tv) ** (GRAV / (gamma * RD))
    return torch.where(dz != 0, p * fac, p)


def _rotate(u, v, rot):
    """Grid-relative winds → true east/north with rot = (cosθ, sinθ)."""
    rotc, rots = rot
    return u * rotc - v * rots, u * rots + v * rotc


def trans_xtoy_conv(elem: torch.Tensor, ri: torch.Tensor, rj: torch.Tensor,
                    rk: torch.Tensor, rot, fields: dict, *,
                    fvirt: float = 0.608, ps_adjust_thres: float = 100.0):
    """Conventional H(x): U, V, T, Tv, Q, RH, PS (common_obs_scale.f90:
    264-338). rk is the fractional model level from phys2ijk, the station
    elevation [m] for PS obs; rot the per-obs (cosθ, sinθ) of
    Projection.rotcoef. Returns (yobs, qc)."""
    u_obs, v_obs = _rotate(itpl_3d(fields["u"], rk, ri, rj),
                           itpl_3d(fields["v"], rk, ri, rj), rot)
    t = itpl_3d(fields["t"], rk, ri, rj)
    q = itpl_3d(fields["q"], rk, ri, rj)
    rh = itpl_3d(fields["rh"], rk, ri, rj)
    tv = t * (1.0 + fvirt * q)

    # surface pressure with height adjustment
    dz = rk - itpl_2d(fields["topo"], ri, rj)
    ps = prsadj(itpl_2d(fields["ps"], ri, rj), dz,
                itpl_2d(fields["t2m"], ri, rj), itpl_2d(fields["q2m"], ri, rj))

    yobs = torch.full_like(u_obs, float("nan"))
    known = torch.zeros_like(elem, dtype=torch.bool)
    for ident, val in ((ID_U, u_obs), (ID_V, v_obs), (ID_T, t), (ID_TV, tv),
                       (ID_Q, q), (ID_RH, rh), (ID_PS, ps)):
        yobs = torch.where(elem == ident, val, yobs)
        known |= elem == ident
    qc = torch.full(yobs.shape, QC_GOOD, dtype=torch.int32,
                    device=yobs.device)
    qc = torch.where((elem == ID_PS) & (torch.abs(dz) > ps_adjust_thres),
                     QC_PS_TER, qc)
    qc = torch.where(~known, QC_OTYPE, qc)
    return yobs, qc


# ---------------------------------------------------------------------------
# Radar forward operator
# ---------------------------------------------------------------------------

def _positive(x):
    return torch.clamp(x, min=1e-30)


def _fall_speeds(qr, qs, qg, roc, rofactor, norc, nosc, nogc, rorc, rosc,
                 rogc):
    """Lin et al. 1983 reflectivity-weighted terminal velocities of rain,
    snow and graupel (cgs constants); zero where the species is absent."""
    a, b, c, d, cd = 2115.0, 0.8, 152.93, 0.25, 0.6
    lr = (math.pi * rorc * norc / (roc * _positive(qr))) ** 0.25
    wr = torch.where(qr > 0, 1e-2 * a * math.gamma(4.0 + b)
                     / (6.0 * lr ** b) * rofactor, 0.0)
    ls = (math.pi * rosc * nosc / (roc * _positive(qs))) ** 0.25
    ws = torch.where(qs > 0, 1e-2 * c * math.gamma(4.0 + d)
                     / (6.0 * ls ** d) * rofactor, 0.0)
    lg = (math.pi * rogc * nogc / (roc * _positive(qg))) ** 0.25
    wg = torch.where(qg > 0, 1e-2 * math.gamma(4.5)
                     * torch.sqrt(4.0 * GRAV * 100.0 * rogc / (3.0 * cd * roc))
                     / (6.0 * lg ** 0.5), 0.0)
    return wr, ws, wg


def calc_ref_vr(qv, qc_, qr, qi, qs, qg, u, v, w, t, p, az, elev, *,
                method: int = 3, use_terminal_velocity: bool = False):
    """Radar reflectivity [mm^6/m^3] and radial velocity [m/s]
    (common_obs_scale.f90:626-998); az, elev in degrees.

    method 1: Sun & Crook rain-only Marshall–Palmer (C-band)
    method 2: Tong & Xue 2006 rain/snow/graupel with Lin et al. fall speeds
    method 3: Xue 2007 power laws with melting-species mixtures (X-band)
    """
    ro = p / (RD * t)
    pi = math.pi
    if method == 1:
        nor, ror = 8.0e6, 1000.0
        cf = 1.0e19 * 72
        qt = qr + qs + qg
        ref = torch.where(qt > 0, cf * (ro * _positive(qt)) ** 1.75
                          / (pi ** 1.75 * nor ** 0.75 * ror ** 1.75), 0.0)
        wt = torch.where(qt > 0, 5.40 * (1.0e5 / p) ** 0.4
                         * _positive(qt) ** 0.125, 0.0)
    elif method == 2:
        nor, nos, nog = 8.0e6, 3.0e6, 4.0e4
        ror, ros, rog, roi = 1000.0, 100.0, 913.0, 917.0
        ki2, kr2 = 0.176, 0.930
        pip = pi ** 1.75
        cf = 1.0e18 * 720
        zr = torch.where(qr > 0, cf * (ro * _positive(qr)) ** 1.75
                         / (pip * nor ** 0.75 * ror ** 1.75), 0.0)
        ros_q = (ro * _positive(qs)) ** 1.75
        zs_cold = cf * ki2 * ros ** 0.25 * ros_q / (
            pip * kr2 * nos ** 0.75 * roi ** 2)
        zs_warm = cf * ros_q / (pip * nos ** 0.75 * roi ** 1.75)
        zs = torch.where(qs > 0, torch.where(t <= 273.16, zs_cold, zs_warm),
                         0.0)
        zg = torch.where(qg > 0, (cf / (pip * nog ** 0.75 * rog ** 1.75))
                         ** 0.95 * (ro * _positive(qg)) ** 1.6625, 0.0)
        ref = zr + zs + zg
        roc = ro * 1e-3
        wr, ws, wg = _fall_speeds(qr, qs, qg, roc, (1e-3 / roc) ** 0.25,
                                  nor * 1e-3, nos * 1e-3, nog * 1e-3,
                                  1.0, 0.1, 0.913)
        wt = torch.where(ref > 0, (wr * zr + ws * zs + wg * zg)
                         / _positive(ref), 0.0)
    elif method == 3:
        maxf = 0.5
        qr_s, qs_s, qg_s = _positive(qr), _positive(qs), _positive(qg)
        both_rg = (qr > 0) & (qg > 0)
        both_rs = (qr > 0) & (qs > 0)
        fg = torch.where(both_rg, maxf * torch.minimum(qr_s / qg_s, qg_s / qr_s)
                         ** (1 / 3), 0.0)
        fwg = torch.where(both_rg, qr / _positive(qr + qg), 0.0)
        fs = torch.where(both_rs, maxf * torch.minimum(qr_s / qs_s, qs_s / qr_s)
                         ** (1 / 3), 0.0)
        fws = torch.where(both_rs, qr / _positive(qr + qs), 0.0)
        qrp = (1.0 - fs - fg) * qr
        qsp = (1.0 - fs) * qs
        qgp = (1.0 - fg) * qg
        qms = fs * (qr + qs)
        qmg = fg * (qr + qg)

        def power(q, coef, expo):
            return torch.where(q > 0, coef * (ro * _positive(q) * 1e3) ** expo,
                               0.0)
        zr = power(qrp, 2.53e4, 1.84)
        zs = power(qsp, 3.48e3, 1.66)
        zg = power(qgp, 5.54e3, 1.70)
        zms = power(qms, (0.00491 + 5.75 * fws - 5.588 * fws ** 2) * 1.0e5,
                    1.67 - 0.202 * fws + 0.398 * fws ** 2)
        zmg = power(qmg, (0.809 + 10.13 * fwg - 5.98 * fwg ** 2) * 1.0e5,
                    1.48 + 0.0448 * fwg - 0.0313 * fwg ** 2)
        ref = zr + zg + zs + zms + zmg
        # Lin et al. 1983 fall speeds with Jung et al. 2007 parameters (cgs)
        roc = 1e-3 * ro
        wr, ws, wg = _fall_speeds(qr, qs, qg, roc, (0.001 / roc) ** 0.5,
                                  8.0e-2, 3.0e-2, 4.0e-4, 1.0, 0.1, 0.917)
        wt = torch.where(ref > 0, (wr * zr + ws * zs + ws * zms + wg * zg
                                   + wg * zmg) / _positive(ref), 0.0)
    else:
        raise ValueError(f"METHOD_REF_CALC={method}")

    elev_r = elev * D2R
    az_r = az * D2R
    vr = (u * torch.cos(elev_r) * torch.sin(az_r)
          + v * torch.cos(elev_r) * torch.cos(az_r))
    w_eff = w - wt if use_terminal_velocity else w
    return ref, vr + w_eff * torch.sin(elev_r)


def radar_geometry(lon, lat, lev, radar_lon, radar_lat, radar_z):
    """Azimuth and elevation [deg] of obs points seen from the radar site,
    and whether a point is the site itself (common_obs_scale.f90:405-440).
    Host float64 numpy: arccos loses precision next to the site."""
    lon, lat, lev = (np.asarray(a, np.float64) for a in (lon, lat, lev))
    dlon = lon - radar_lon
    dlat = lat - radar_lat
    az = np.arctan2(dlon * np.cos(radar_lat * D2R), dlat) / D2R
    az = np.where(az < 0, az + 360.0, az)
    # great-circle surface distance (com_distll_1, common/common.f90:401)
    cosd = (np.sin(lat * D2R) * np.sin(radar_lat * D2R)
            + np.cos(lat * D2R) * np.cos(radar_lat * D2R)
            * np.cos(dlon * D2R))
    dist = RE * np.arccos(np.clip(cosd, -1.0, 1.0))
    elev = np.arctan2(lev - radar_z, dist) / D2R
    return az, elev, (dlon == 0) & (dlat == 0)


def trans_xtoy_radar(elem: torch.Tensor, ri: torch.Tensor, rj: torch.Tensor,
                     rk: torch.Tensor, rot, az: torch.Tensor,
                     elev: torch.Tensor, at_site: torch.Tensor, fields: dict,
                     *, method: int = 3, use_terminal_velocity: bool = False,
                     min_radar_ref: float = 1.0, min_radar_ref_dbz: float = 0.0,
                     low_ref_shift: float = 0.0):
    """Radar H(x): reflectivity [dBZ] and radial velocity
    (common_obs_scale.f90:342-493); az, elev, at_site from radar_geometry.
    Returns (yobs, qc)."""
    def at(name):
        return itpl_3d(fields[name], rk, ri, rj)
    u_true, v_true = _rotate(at("u"), at("v"), rot)
    ref, vr = calc_ref_vr(at("q"), at("qc"), at("qr"), at("qi"), at("qs"),
                          at("qg"), u_true, v_true, at("w"), at("t"), at("p"),
                          az, elev, method=method,
                          use_terminal_velocity=use_terminal_velocity)
    is_ref = (elem == ID_RADAR_REF) | (elem == ID_RADAR_REF_ZERO)
    is_vr = elem == ID_RADAR_VR
    low = ref < min_radar_ref
    dbz = 10.0 * torch.log10(_positive(ref))
    y_ref = torch.where(low, min_radar_ref_dbz + low_ref_shift, dbz)
    yobs = torch.where(is_ref, y_ref, torch.where(is_vr, vr, float("nan")))
    qc = torch.full(yobs.shape, QC_GOOD, dtype=torch.int32,
                    device=yobs.device)
    qc = torch.where((is_ref | is_vr) & low, QC_REF_LOW, qc)
    qc = torch.where(~(is_ref | is_vr), QC_OTYPE, qc)
    qc = torch.where(at_site, QC_OUT_H, qc)
    return yobs, qc
