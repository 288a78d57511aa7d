"""Plain reference of the observation side: the Lambert conformal
projection of the grid, the history fields the operators read, the
phased-array radar's forward operators (reflectivity by the Xue 2007
power laws, radial velocity), and their QC codes.

Written from the operators' published formulas (SCALE-LETKF
common_obs_scale.f90: Trans_XtoY_radar, calc_ref_vr method 3, phys2ijkz)
in plain PyTorch and NumPy, for the whole obs batch at once; fields carry a leading member axis. The obs geometry is
host float64; the fields' dtype sets the arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.model import RD, RE

D2R = np.pi / 180.0
R2D = 180.0 / np.pi
ID_RADAR_REF, ID_RADAR_VR, ID_RADAR_REF_ZERO = 4001, 4002, 4004
TYP_PHARAD = 21
QC_GOOD, QC_REF_LOW = 0, 11
QC_RADAR_VHI, QC_OUT_VHI, QC_OUT_VLO, QC_OUT_H = 19, 20, 21, 98
QC_OTYPE = 90


@dataclass(frozen=True)
class Lambert:
    """Lambert conformal projection about a base point."""
    lon0: float
    lat0: float
    lat1: float
    lat2: float

    @property
    def cone(self):
        la1, la2 = self.lat1 * D2R, self.lat2 * D2R
        if abs(self.lat1 - self.lat2) < 1e-10:
            n = np.sin(la1)
        else:
            n = (np.log(np.cos(la1)) - np.log(np.cos(la2))) / (
                np.log(np.tan(np.pi / 4 + la2 / 2))
                - np.log(np.tan(np.pi / 4 + la1 / 2)))
        return n, np.cos(la1) * np.tan(np.pi / 4 + la1 / 2) ** n / n

    def to_xy(self, lon, lat):
        n, f = self.cone
        lam = (np.asarray(lon) - self.lon0) * D2R
        phi = np.asarray(lat) * D2R
        rho = RE * f / np.tan(np.pi / 4 + phi / 2) ** n
        rho0 = RE * f / np.tan(np.pi / 4 + self.lat0 * D2R / 2) ** n
        return rho * np.sin(n * lam), rho0 - rho * np.cos(n * lam)

    def to_lonlat(self, x, y):
        n, f = self.cone
        rho0 = RE * f / np.tan(np.pi / 4 + self.lat0 * D2R / 2) ** n
        yy = rho0 - np.asarray(y)
        x = np.asarray(x)
        rho = np.sqrt(x * x + yy * yy) * np.sign(n)
        lon = self.lon0 + np.arctan2(x, yy) / n * R2D
        lat = (2 * np.arctan((RE * f / rho) ** (1.0 / n)) - np.pi / 2) * R2D
        return lon, lat

    def rotation(self, lon):
        """(cos, sin) of the angle from true north to the grid's y."""
        ang = self.cone[0] * (np.asarray(lon, np.float64) - self.lon0) * D2R
        return np.cos(ang), np.sin(ang)


def projection_of(dom: dict) -> Lambert:
    p = dom.get("projection", {})
    if p.get("kind", "LC") != "LC":
        raise ValueError("the reference projects Lambert conformal grids only")
    return Lambert(p.get("basepoint_lon", 135.0), p.get("basepoint_lat", 35.0),
                   p.get("lc_lat1", 30.0), p.get("lc_lat2", 40.0))


def grid_xy(nx: int, ny: int, dx: float, dy: float):
    """Projection coordinates of the cell centres, the base point at the
    domain's centre."""
    return ((np.arange(nx) + 0.5 - nx / 2) * dx,
            (np.arange(ny) + 0.5 - ny / 2) * dy)


# --- fields and interpolation ---------------------------------------------

def history(anal: torch.Tensor) -> dict:
    """The operators' fields of analysis variables (K, NV, nz, ny, nx)."""
    names = ("u", "v", "w", "t", "p", "q", "qc", "qr", "qi", "qs", "qg")
    return {n: anal[:, i] for i, n in enumerate(names)}


def _corner(r, n):
    i0 = torch.floor(r).long().clamp_(0, n - 2)
    return i0, torch.clamp(r - i0, 0.0, 1.0)


def _take(flat, idx):
    """flat (..., N) at flat indices idx (..., n), leading axes broadcast."""
    lead = np.broadcast_shapes(flat.shape[:-1], idx.shape[:-1])
    return torch.gather(flat.expand(lead + flat.shape[-1:]), -1,
                        idx.expand(lead + idx.shape[-1:]))


def itpl_3d(field, rk, ri, rj):
    nz, ny, nx = field.shape[-3:]
    k0, ak = _corner(rk, nz)
    i0, ai = _corner(ri, nx)
    j0, aj = _corner(rj, ny)
    ff = field.reshape(field.shape[:-3] + (nz * ny * nx,))
    b = (k0 * ny + j0) * nx + i0
    out = 0.0
    for dk, wk in ((0, 1 - ak), (1, ak)):
        for dj, wj in ((0, 1 - aj), (1, aj)):
            for di, wi in ((0, 1 - ai), (1, ai)):
                out = out + _take(ff, b + (dk * ny + dj) * nx + di) * wk * wj * wi
    return out


def _bracket(prof, below):
    nz = prof.shape[-1]
    k = torch.sum(below, dim=-1).clamp_(1, nz - 1)[..., None]
    return (k[..., 0], torch.gather(prof, -1, k - 1)[..., 0],
            torch.gather(prof, -1, k)[..., 0])


def _out_h(ri, rj, ny, nx):
    return (ri < 0) | (ri > nx - 1) | (rj < 0) | (rj > ny - 1)


# --- operators -------------------------------------------------------------

@dataclass
class Geometry:
    """One obs batch's geometry on the device, in the fields' dtype."""
    elem: torch.Tensor
    ri: torch.Tensor
    rj: torch.Tensor
    lev: torch.Tensor
    rot_c: torch.Tensor
    rot_s: torch.Tensor
    az: torch.Tensor | None = None
    elev: torch.Tensor | None = None


def geometry(obs: dict, nx, ny, dx, dy, proj: Lambert, dtype, device
             ) -> Geometry:
    """obs: elem, lon, lat, lev (and for radar obs meta: the site's lon,
    lat, height)."""
    x, y = proj.to_xy(np.asarray(obs["lon"], np.float64),
                      np.asarray(obs["lat"], np.float64))

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    c, s = proj.rotation(obs["lon"])
    g = Geometry(elem=torch.as_tensor(obs["elem"], device=device),
                 ri=put(x / dx + nx / 2 - 0.5), rj=put(y / dy + ny / 2 - 0.5),
                 lev=put(obs["lev"]), rot_c=put(c), rot_s=put(s))
    if "meta" in obs:
        lon, lat, lev = (np.asarray(obs[k], np.float64)
                         for k in ("lon", "lat", "lev"))
        rlon, rlat, rz = obs["meta"]
        dlon, dlat = lon - rlon, lat - rlat
        az = np.arctan2(dlon * np.cos(rlat * D2R), dlat) / D2R
        az = np.where(az < 0, az + 360.0, az)
        cosd = (np.sin(lat * D2R) * np.sin(rlat * D2R) + np.cos(lat * D2R)
                * np.cos(rlat * D2R) * np.cos(dlon * D2R))
        dist = RE * np.arccos(np.clip(cosd, -1.0, 1.0))
        g.az, g.elev = put(az), put(np.arctan2(lev - rz, dist) / D2R)
    return g


def _true_wind(f, rk, g):
    u, v = itpl_3d(f["u"], rk, g.ri, g.rj), itpl_3d(f["v"], rk, g.ri, g.rj)
    return u * g.rot_c - v * g.rot_s, u * g.rot_s + v * g.rot_c


def _pos(x):
    return torch.clamp(x, min=1e-30)


def reflectivity(qr, qs, qg, t, p):
    """Radar reflectivity [mm⁶ m⁻³] by the Xue et al. (2007) power laws
    with the melting snow and graupel mixtures (calc_ref_vr method 3)."""
    ro = p / (RD * t)
    both_rg, both_rs = (qr > 0) & (qg > 0), (qr > 0) & (qs > 0)
    fg = torch.where(both_rg, 0.5 * torch.minimum(_pos(qr) / _pos(qg),
                                                  _pos(qg) / _pos(qr))
                     ** (1 / 3), 0.0)
    fwg = torch.where(both_rg, qr / _pos(qr + qg), 0.0)
    fs = torch.where(both_rs, 0.5 * torch.minimum(_pos(qr) / _pos(qs),
                                                  _pos(qs) / _pos(qr))
                     ** (1 / 3), 0.0)
    fws = torch.where(both_rs, qr / _pos(qr + qs), 0.0)

    def power(q, coef, expo):
        return torch.where(q > 0, coef * (ro * _pos(q) * 1e3) ** expo, 0.0)
    return (power((1.0 - fs - fg) * qr, 2.53e4, 1.84)
            + power((1.0 - fg) * qg, 5.54e3, 1.70)
            + power((1.0 - fs) * qs, 3.48e3, 1.66)
            + power(fs * (qr + qs), (0.00491 + 5.75 * fws - 5.588 * fws ** 2)
                    * 1.0e5, 1.67 - 0.202 * fws + 0.398 * fws ** 2)
            + power(fg * (qr + qg), (0.809 + 10.13 * fwg - 5.98 * fwg ** 2)
                    * 1.0e5, 1.48 + 0.0448 * fwg - 0.0313 * fwg ** 2))


def hx_radar(f: dict, g: Geometry, cz, min_ref: float = 1.0,
             min_ref_dbz: float = 0.0, zmax: float = 99.0e3):
    """(y, qc, ref), each (K, nobs), of reflectivity (dBZ, floored at
    min_ref_dbz below min_ref) and radial velocity (no fall speed) obs at
    heights lev over flat ground; ref the linear reflectivity at the obs."""
    ny, nx = f["p"].shape[-2:]
    z = torch.as_tensor(np.asarray(cz), dtype=g.lev.dtype, device=g.lev.device)
    k, lo, hi = _bracket(z.expand(g.lev.shape[0], -1),
                         z[None, :] <= g.lev[:, None])
    rk = (k - 1) + (g.lev - lo) / (hi - lo)

    def at(name):
        return itpl_3d(f[name], rk, g.ri, g.rj)
    u, v = _true_wind(f, rk, g)
    ref = reflectivity(at("qr"), at("qs"), at("qg"), at("t"), at("p"))
    el, az = g.elev * D2R, g.az * D2R
    vr = (u * torch.cos(el) * torch.sin(az) + v * torch.cos(el) * torch.cos(az)
          + at("w") * torch.sin(el))
    is_ref = (g.elem == ID_RADAR_REF) | (g.elem == ID_RADAR_REF_ZERO)
    is_vr = g.elem == ID_RADAR_VR
    low = ref < min_ref
    y_ref = torch.where(low, min_ref_dbz, 10.0 * torch.log10(_pos(ref)))
    y = torch.where(is_ref, y_ref, torch.where(is_vr, vr, float("nan")))
    qc = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
    qc = torch.where((is_ref | is_vr) & low, QC_REF_LOW, qc)
    qc = torch.where(~(is_ref | is_vr), QC_OTYPE, qc)
    qc_v = torch.where(g.lev > z[-1], QC_OUT_VHI, 0)
    qc_v = torch.where(g.lev < z[0], QC_OUT_VLO, qc_v)
    qc_v = torch.where(_out_h(g.ri, g.rj, ny, nx), QC_OUT_H, qc_v)
    qc = torch.maximum(qc, qc_v.to(torch.int32))
    qc = torch.where((is_ref | is_vr) & (g.lev > zmax), QC_RADAR_VHI, qc)
    return y, qc, ref
