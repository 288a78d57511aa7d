"""Observation file I/O: the LETKF binary formats.

The port's own copy of scale_letkf_tpu/obs/io.py (numpy and the repo's
native codec), so a file written by either package reads the same in the
other. Byte-compatible with the reference formats (reference:
scale/common/common_obs_scale.f90 — format spec :14-34, read_obs :2148 with
unit conversions, write_obs :2213, radar format with 3-scalar site header
:2411-2596, obsda ensemble-H(x) files :2275-2352, Himawari-8 profiles
:2972-3110, obsdep :2354).

All records are Fortran unformatted sequential (4-byte length framing).
Decoding uses the native C++ codec when available (native/libfortseq.so),
else a vectorized NumPy fallback.
"""

from __future__ import annotations

import numpy as np

from scale_letkf_torch.config import Config
from scale_letkf_torch.obs.types import (
    Observations, ID_U, ID_V, ID_T, ID_TV, ID_Q, ID_RH, ID_PS,
    ID_TCLON, ID_TCLAT, ID_TCMIP, TYP_PHARAD,
)
from scale_letkf_torch.utils import native

NCHAN = 10  # Himawari-8 AHI bands B07..B16 per profile (common_nml.f90 nch)

UNDEF = -9.99e33


# ---------------------------------------------------------------------------
# Fortran sequential framing (NumPy fallback)
# ---------------------------------------------------------------------------

def _np_read_records(path: str, skip: int, nrec: int) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    pos = 0
    for _ in range(skip):
        ln = raw[pos:pos + 4].view(np.int32)[0]
        pos += 8 + int(ln)
    body = raw[pos:]
    rec_bytes = 8 + nrec * 4
    if len(body) % rec_bytes != 0:
        raise ValueError(f"{path}: bad record framing")
    n = len(body) // rec_bytes
    arr = body.reshape(n, rec_bytes)
    heads = arr[:, :4].copy().view(np.int32)[:, 0]
    tails = arr[:, -4:].copy().view(np.int32)[:, 0]
    if not ((heads == nrec * 4).all() and (tails == nrec * 4).all()):
        raise ValueError(f"{path}: inconsistent record markers")
    return arr[:, 4:-4].copy().view(np.float32).reshape(n, nrec)


def _np_read_scalars(path: str, count: int) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    out = np.empty(count, np.float32)
    pos = 0
    for i in range(count):
        ln = int(raw[pos:pos + 4].view(np.int32)[0])
        if ln != 4:
            raise ValueError(f"{path}: expected scalar record")
        out[i] = raw[pos + 4:pos + 8].copy().view(np.float32)[0]
        pos += 8 + ln
    return out


def _np_write_records(path: str, header: np.ndarray | None,
                      data: np.ndarray, append: bool):
    mode = "ab" if append else "wb"
    n, nrec = data.shape
    with open(path, mode) as f:
        if header is not None:
            four = np.asarray([4], np.int32).tobytes()
            for h in np.asarray(header, np.float32):
                f.write(four + np.float32(h).tobytes() + four)
        ln = np.full(n, nrec * 4, np.int32)
        buf = np.empty((n, nrec * 4 + 8), np.uint8)
        buf[:, :4] = np.frombuffer(ln.tobytes(), np.uint8).reshape(n, 4)
        buf[:, 4:-4] = np.frombuffer(
            np.ascontiguousarray(data, np.float32).tobytes(),
            np.uint8).reshape(n, nrec * 4)
        buf[:, -4:] = buf[:, :4]
        f.write(buf.tobytes())


def read_records(path: str, skip: int, nrec: int) -> np.ndarray:
    """(n, nrec) float32 records after skipping `skip` header records."""
    lib = native.load()
    if lib is not None:
        import ctypes
        cnt = lib.fortseq_count_f32(path.encode(), skip, nrec)
        if cnt < 0:
            raise ValueError(f"{path}: framing error ({cnt})")
        out = np.empty((cnt, nrec), np.float32)
        got = lib.fortseq_read_f32(
            path.encode(), skip, nrec,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cnt)
        if got != cnt:
            raise ValueError(f"{path}: short read {got}/{cnt}")
        return out
    return _np_read_records(path, skip, nrec)


def write_records(path: str, data: np.ndarray,
                  header: np.ndarray | None = None, append: bool = False):
    lib = native.load()
    data = np.ascontiguousarray(data, np.float32)
    if lib is not None:
        import ctypes
        hdr = (np.ascontiguousarray(header, np.float32)
               if header is not None else np.empty(0, np.float32))
        r = lib.fortseq_write_f32(
            path.encode(),
            hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(hdr),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            data.shape[0], data.shape[1], int(append))
        if r != 0:
            raise OSError(f"cannot write {path}")
        return
    _np_write_records(path, header, data, append)


# ---------------------------------------------------------------------------
# Conventional obs format (8 columns; read_obs/write_obs)
# ---------------------------------------------------------------------------

_HPA_LEV_IDS = (ID_U, ID_V, ID_T, ID_TV, ID_Q, ID_RH)


def read_obs(path: str, cfg: Config | None = None) -> Observations:
    """Read the 8-column LETKF obs format with the reference's unit
    conversions (hPa→Pa levels, hPa→Pa PS values, % → fraction RH)."""
    wk = read_records(path, 0, 8).astype(np.float64)
    elem = np.rint(wk[:, 0]).astype(np.int32)
    lev = wk[:, 3]
    dat = wk[:, 4]
    err = wk[:, 5]
    m = np.isin(elem, _HPA_LEV_IDS) | (elem == ID_TCMIP) \
        | (elem == ID_TCLON) | (elem == ID_TCLAT)
    lev = np.where(m, lev * 100.0, lev)
    ps = elem == ID_PS
    dat = np.where(ps, dat * 100.0, dat)
    err = np.where(ps, err * 100.0, err)
    rh = elem == ID_RH
    dat = np.where(rh, dat * 0.01, dat)
    err = np.where(rh, err * 0.01, err)
    tcp = elem == ID_TCMIP
    dat = np.where(tcp, dat * 100.0, dat)
    err = np.where(tcp, err * 100.0, err)
    return Observations(
        elem=elem, lon=wk[:, 1], lat=wk[:, 2], lev=lev, dat=dat, err=err,
        typ=np.rint(wk[:, 6]).astype(np.int32) - 1,   # file is 1-based
        dif=wk[:, 7])


def write_obs(path: str, obs: Observations, append: bool = False,
              missing: bool = True):
    elem = obs.elem
    lev = obs.lev.copy()
    dat = obs.dat.copy()
    err = obs.err.copy()
    m = np.isin(elem, _HPA_LEV_IDS)
    lev[m] *= 0.01
    ps = elem == ID_PS
    dat[ps] *= 0.01
    err[ps] *= 0.01
    rh = elem == ID_RH
    dat[rh] *= 100.0
    err[rh] *= 100.0
    tcp = elem == ID_TCMIP
    dat[tcp] *= 0.01
    err[tcp] *= 0.01
    wk = np.stack([elem.astype(np.float32),
                   obs.lon, obs.lat, lev, dat, err,
                   (obs.typ + 1).astype(np.float32),
                   obs.dif], axis=1).astype(np.float32)
    if not missing:
        wk = wk[np.abs(obs.dat - UNDEF) > 1e-30]
    write_records(path, wk, append=append)


# ---------------------------------------------------------------------------
# Radar obs format (3 scalar header records + 7/8 columns)
# ---------------------------------------------------------------------------

def read_obs_radar(path: str, radar_obs_4d: bool = False) -> Observations:
    nrec = 8 if radar_obs_4d else 7
    lib = native.load()
    if lib is not None:
        import ctypes
        hdr = np.empty(3, np.float32)
        r = lib.fortseq_read_scalars_f32(
            path.encode(), hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 3)
        if r != 0:
            raise ValueError(f"{path}: bad radar header")
    else:
        hdr = _np_read_scalars(path, 3)
    wk = read_records(path, 3, nrec).astype(np.float64)
    n = len(wk)
    return Observations(
        elem=np.rint(wk[:, 0]).astype(np.int32),
        lon=wk[:, 1], lat=wk[:, 2], lev=wk[:, 3], dat=wk[:, 4], err=wk[:, 5],
        typ=np.full(n, TYP_PHARAD, np.int32),      # forced PHARAD (f90:2531)
        dif=wk[:, 7] if radar_obs_4d else np.zeros(n),
        meta=hdr.astype(np.float64))


def write_obs_radar(path: str, obs: Observations, radar_obs_4d: bool = False,
                    append: bool = False):
    nrec = 8 if radar_obs_4d else 7
    cols = [obs.elem.astype(np.float32), obs.lon, obs.lat, obs.lev,
            obs.dat, obs.err, (obs.typ + 1).astype(np.float32)]
    if radar_obs_4d:
        cols.append(obs.dif)
    wk = np.stack(cols, axis=1).astype(np.float32)
    write_records(path, wk, header=obs.meta.astype(np.float32),
                  append=append)


# ---------------------------------------------------------------------------
# Himawari-8 obs format — get_nobs_H08/read_obs_H08/write_obs_H08
# (f90:2972-3110): one record per profile, 4+nch floats
# (elm, typ, lon, lat, BT[nch]); lev gets the band number ch+6 (f90:3057)
# ---------------------------------------------------------------------------

def read_obs_h08(path: str, cfg: Config | None = None) -> Observations:
    errs = (np.asarray(cfg.obs_error.h08, np.float64) if cfg is not None
            else np.full(NCHAN, 5.0))
    wk = read_records(path, 0, 4 + NCHAN).astype(np.float64)
    nprof = len(wk)
    elem = np.repeat(np.rint(wk[:, 0]).astype(np.int32), NCHAN)
    typ = np.repeat(np.rint(wk[:, 1]).astype(np.int32) - 1, NCHAN)
    lon = np.repeat(wk[:, 2], NCHAN)
    lat = np.repeat(wk[:, 3], NCHAN)
    dat = wk[:, 4:].reshape(-1)
    ch = np.tile(np.arange(1, NCHAN + 1, dtype=np.float64), nprof)
    return Observations(
        elem=elem, lon=lon, lat=lat, lev=ch + 6.0, dat=dat,
        err=errs[(ch - 1).astype(int)], typ=typ,
        dif=np.zeros(nprof * NCHAN))


def write_obs_h08(path: str, obs: Observations, append: bool = False):
    """Inverse of read_obs_h08: obs must hold nprof×nch H08 records in
    channel-major order per profile (as produced by read/obsmake)."""
    if obs.nobs % NCHAN != 0:
        raise ValueError("H08 obs count must be a multiple of nch")
    nprof = obs.nobs // NCHAN
    el = obs.elem.reshape(nprof, NCHAN)
    ty = obs.typ.reshape(nprof, NCHAN)
    lo = obs.lon.reshape(nprof, NCHAN)
    la = obs.lat.reshape(nprof, NCHAN)
    bt = obs.dat.reshape(nprof, NCHAN)
    wk = np.concatenate([el[:, :1].astype(np.float32),
                         (ty[:, :1] + 1).astype(np.float32),
                         lo[:, :1], la[:, :1], bt], axis=1).astype(np.float32)
    write_records(path, wk, append=append)


# ---------------------------------------------------------------------------
# obsda (ensemble H(x)) files — read_obs_da/write_obs_da (f90:2275,2311):
# 4 sequential array records: set(int), idx(int), val(float), qc(int)
# ---------------------------------------------------------------------------

def write_obs_da(path: str, set_: np.ndarray, idx: np.ndarray,
                 val: np.ndarray, qc: np.ndarray,
                 lev: np.ndarray | None = None,
                 val2: np.ndarray | None = None):
    """Optional trailing lev/val2 records mirror the reference's H08 build
    (wk(5)=lev sensitive pressure, wk(6)=val2 clear-sky BT; read/write_obs_da
    under #ifdef H08, common_obs_scale.f90:2275-2352)."""
    arrs = [(set_, np.int32), (idx, np.int32), (val, np.float32),
            (qc, np.int32)]
    if lev is not None:
        arrs += [(lev, np.float32), (np.zeros_like(lev) if val2 is None
                                     else val2, np.float32)]
    with open(path, "wb") as f:
        for arr, dt in arrs:
            a = np.ascontiguousarray(arr, dt)
            ln = np.asarray([a.nbytes], np.int32).tobytes()
            f.write(ln + a.tobytes() + ln)


def read_obs_da(path: str, n: int):
    """Returns (set, idx, val, qc[, lev, val2]) — the trailing pair only
    when the file carries the H08 records."""
    raw = np.fromfile(path, dtype=np.uint8)
    out = []
    pos = 0
    dts = (np.int32, np.int32, np.float32, np.int32, np.float32, np.float32)
    for dt in dts:
        if pos >= raw.size:
            break
        ln = int(raw[pos:pos + 4].view(np.int32)[0])
        a = raw[pos + 4:pos + 4 + ln].copy().view(dt)
        out.append(a)
        pos += 8 + ln
    return tuple(out)


# ---------------------------------------------------------------------------
# obsdep files — write_obs_dep (common_obs_scale.f90:2354): 11-column f32
# sequential records (elm, lon, lat, lev, dat, err, typ, dif, qc, omb, oma)
# with the reference's output unit conversions
# ---------------------------------------------------------------------------

def write_obs_dep(path: str, elem, lon, lat, lev, dat, err, typ, dif,
                  qc, omb, oma):
    """Reference-binary obsdep output for offline scoring tools."""
    elem = np.asarray(elem)
    wk = np.stack([
        elem.astype(np.float32),
        np.asarray(lon, np.float32), np.asarray(lat, np.float32),
        np.asarray(lev, np.float32), np.asarray(dat, np.float32),
        np.asarray(err, np.float32), np.asarray(typ, np.float32),
        np.asarray(dif, np.float32), np.asarray(qc, np.float32),
        np.asarray(omb, np.float32), np.asarray(oma, np.float32)],
        axis=1)
    m = np.isin(elem, _HPA_LEV_IDS)
    wk[m, 3] *= 0.01                       # Pa -> hPa levels
    ps = elem == ID_PS
    wk[ps, 4] *= 0.01                      # Pa -> hPa PS values
    wk[ps, 5] *= 0.01
    rh = elem == ID_RH
    wk[rh, 4] *= 100.0                     # fraction -> percent
    wk[rh, 5] *= 100.0
    tcp = elem == ID_TCMIP
    wk[tcp, 4] *= 0.01
    wk[tcp, 5] *= 0.01
    write_records(path, wk)


def read_obs_dep(path: str):
    """Read an obsdep file back; returns the 11 columns with units
    restored to SI (inverse of write_obs_dep's conversions)."""
    wk = read_records(path, 0, 11).astype(np.float64)
    elem = wk[:, 0].astype(np.int32)
    m = np.isin(elem, _HPA_LEV_IDS)
    wk[m, 3] *= 100.0
    ps = elem == ID_PS
    wk[ps, 4] *= 100.0
    wk[ps, 5] *= 100.0
    rh = elem == ID_RH
    wk[rh, 4] /= 100.0
    wk[rh, 5] /= 100.0
    tcp = elem == ID_TCMIP
    wk[tcp, 4] *= 100.0
    wk[tcp, 5] *= 100.0
    return (elem, wk[:, 1], wk[:, 2], wk[:, 3], wk[:, 4], wk[:, 5],
            wk[:, 6].astype(np.int32), wk[:, 7],
            wk[:, 8].astype(np.int32), wk[:, 9], wk[:, 10])


# ---------------------------------------------------------------------------
# Dispatcher (read_obs_all analogue)
# ---------------------------------------------------------------------------

def read_obs_all(cfg: Config) -> list[Observations]:
    """Every configured obs input file (OBS_IN_NAME), read by its
    OBS_IN_FORMAT (common_obs_scale.f90:2596-2644)."""
    out = []
    for name, fmt in zip(cfg.obsope.obs_in_name, cfg.obsope.obs_in_format):
        if fmt.upper() == "RADAR":
            out.append(read_obs_radar(name))
        elif fmt.upper() == "PREPBUFR":
            out.append(read_obs(name, cfg))
        elif fmt.upper() == "HIMAWARI8":
            out.append(read_obs_h08(name, cfg))
        else:
            raise ValueError(f"unsupported obs format: {fmt}")
    return out
