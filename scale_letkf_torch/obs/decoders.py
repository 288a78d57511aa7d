"""Offline observation decoders (GFS-era tools re-hosted).

Port of scale_letkf_tpu/obs/decoders.py, numpy on the host as there, with
the port's own obs/types.py. The reference's offline obs converters
(reference: scale/obs/readdiag_conv.f90 — GSI diag_conv → LETKF obs2;
scale/obs/dec_prcp.f90 — gridded TMPA precipitation → rain obs). These are
host-side preprocessing tools (pure NumPy, no device work) feeding the
assimilation pipeline; the reference ships them unbuilt (they target the
GFS-LETKF heritage modules) but their file formats and QC semantics are
fully specified in the sources and reproduced here.

The remaining reference decoder, dec_prepbufr.f90, requires NCEP BUFRLIB
(an external library not shipped with the reference either); its output
format is the same obs2 stream produced here, so `write_obs2`/`read_obs2`
cover the interchange format.
"""

from __future__ import annotations

import numpy as np

from scale_letkf_torch.obs.types import (
    Observations, ID_U, ID_V, ID_T, ID_Q, ID_PS, ID_RAIN,
)

# ---------------------------------------------------------------------------
# Fortran unformatted sequential, variable-length records
# ---------------------------------------------------------------------------


def iter_fortran_records(raw: np.ndarray):
    """Yield payload byte-slices of a Fortran sequential file."""
    pos = 0
    n = len(raw)
    while pos + 8 <= n:
        ln = int(raw[pos:pos + 4].view(np.int32)[0])
        if pos + 8 + ln > n:
            raise ValueError("truncated Fortran record")
        tail = int(raw[pos + 4 + ln:pos + 8 + ln].view(np.int32)[0])
        if tail != ln:
            raise ValueError("inconsistent Fortran record markers")
        yield raw[pos + 4:pos + 4 + ln]
        pos += 8 + ln


def write_fortran_record(f, payload: bytes):
    ln = np.asarray([len(payload)], np.int32).tobytes()
    f.write(ln + payload + ln)


# ---------------------------------------------------------------------------
# obs2 format (GFS-era 10-record stream written by readdiag_conv/dec_prepbufr:
# elm, lon, lat, lev, dat, err, typ, dif, departure, qc —
# readdiag_conv.f90:124-285 wk(1..10))
# ---------------------------------------------------------------------------


def write_obs2(path: str, obs: Observations, omb: np.ndarray,
               qc: np.ndarray):
    """Write the 10-field obs2 stream (one Fortran record per obs)."""
    data = np.column_stack([
        obs.elem.astype(np.float32), obs.lon, obs.lat, obs.lev,
        obs.dat, obs.err, (obs.typ + 1).astype(np.float32),
        obs.dif, omb, qc,
    ]).astype(np.float32)
    with open(path, "wb") as f:
        for row in data:
            write_fortran_record(f, row.tobytes())


def read_obs2(path: str):
    """Read an obs2 stream → (Observations, omb, qc)."""
    raw = np.fromfile(path, dtype=np.uint8)
    rows = [rec.view(np.float32).copy() for rec in iter_fortran_records(raw)]
    if not rows:
        return Observations.empty(), np.zeros(0), np.zeros(0)
    wk = np.stack(rows)
    if wk.shape[1] != 10:
        raise ValueError(f"{path}: expected 10-field obs2 records, "
                         f"got {wk.shape[1]}")
    obs = Observations(
        elem=wk[:, 0].astype(np.int32), lon=wk[:, 1], lat=wk[:, 2],
        lev=wk[:, 3], dat=wk[:, 4], err=wk[:, 5],
        typ=wk[:, 6].astype(np.int32) - 1, dif=wk[:, 7])
    return obs, wk[:, 8].astype(np.float64), wk[:, 9].astype(np.float64)


# ---------------------------------------------------------------------------
# GSI diag_conv decoder (readdiag_conv.f90)
# ---------------------------------------------------------------------------

# PREPBUFR report type → (LETKF report type 1-based, used flag)
# (readdiag_conv.f90:171-247; table_2.htm platform classes)
_PLATFORM_MAP: list[tuple[tuple[int, ...], int, bool]] = [
    ((120, 132, 220, 221, 232), 1, True),        # ADPUPA
    ((122, 222), 1, False),
    ((133, 233), 2, True),                       # AIRCAR
    ((130, 131, 135, 230, 231, 235), 3, True),   # AIRCFT
    ((134, 234), 3, False),
    (tuple(range(241, 244)) + (245, 246) + tuple(range(250, 255))
     + (257, 258, 259), 4, True),                # SATWND
    ((240, 244, 247, 248, 249, 255, 256), 4, False),
    ((223, 228, 229), 5, True),                  # PROFLR
    ((227,), 5, False),
    ((224,), 6, True),                           # VADWND
    ((181, 183, 187, 281, 284, 287), 8, True),   # ADPSFC
    ((180, 182, 280, 282), 9, True),             # SFCSHP
    ((191,), 10, False),                         # SFCBOG
    ((150, 152, 283), 11, True),                 # SPSSMI
    ((111, 210), 12, False),                     # SYNDAT
    ((286,), 13, True),                          # ERS1DA
    ((151,) + tuple(range(156, 176)), 14, False),  # GOESND
    ((285,), 15, True),                          # QKSWND
    ((188, 288), 16, False),                     # MSONET
    ((153,), 17, True),                          # GPSIPW
    ((126,), 18, True),                          # RASSDA
    ((289,), 19, True),                          # WDSATR
    ((290,), 20, True),                          # ASCATW
]

_DTYPE_ID = {" uv": ID_U, "  t": ID_T, "  q": ID_Q, " ps": ID_PS}
MIN_INV_ERR = 1.0e-7


def _classify_platform(itypebufr: np.ndarray):
    """Vectorized PREPBUFR-report-type classification → (typ 1-based, used)."""
    typ = np.full(itypebufr.shape, 25, np.int32)   # "others" (nobtype+1)
    used = np.ones(itypebufr.shape, bool)
    for codes, t, ok in _PLATFORM_MAP:
        m = np.isin(itypebufr, codes)
        typ[m] = t
        used[m] = ok
    return typ, used


def read_gsi_diag_conv(path: str):
    """Decode a GSI diag_conv file.

    Returns (Observations, omb, qc, idate). QC follows the reference:
    0 when the platform is excluded, the final inverse obs error is below
    MIN_INV_ERR, or the PREPBUFR quality mark is outside [0, 2]
    (readdiag_conv.f90:157-266). ' uv' records expand to U and V obs
    (V value/omb in rdiag rows 20/21, readdiag_conv.f90:273-283); PS omb is
    converted hPa→Pa (:251-254).
    """
    raw = np.fromfile(path, dtype=np.uint8)
    it = iter_fortran_records(raw)
    idate = int(next(it).view(np.int32)[0])

    out: list[np.ndarray] = []
    while True:
        try:
            head = next(it)
        except StopIteration:
            break
        dtype = head[:3].tobytes().decode("ascii")
        nchar, nreal, ii, _mype = head[3:19].view(np.int32)
        data = next(it)
        if ii == 0:
            continue
        # cdiag: ii station ids of `nchar` chars, then rdiag (nreal, ii)
        # column-major float32
        rdiag = (data[ii * int(nchar):].view(np.float32)
                 .reshape(int(ii), int(nreal)).T)
        id_obs = _DTYPE_ID.get(dtype)
        if id_obs is None:
            continue

        lon, lat = rdiag[3], rdiag[2]
        lev = np.where(id_obs == ID_PS, rdiag[4], rdiag[5])
        dat = rdiag[16]
        inv_err = rdiag[15]
        err_ok = inv_err >= MIN_INV_ERR
        err = np.where(err_ok, 1.0 / np.where(err_ok, inv_err, 1.0), 1.0e10)
        typ, used = _classify_platform(np.rint(rdiag[0]).astype(np.int64))
        iqm = np.rint(rdiag[8]).astype(np.int64)
        qc = (err_ok & used & (iqm >= 0) & (iqm <= 2)).astype(np.float32)
        dif = np.full(ii, float(rdiag[7, -1]), np.float32) * 3600.0
        omb = dat - rdiag[17]
        if id_obs == ID_PS:
            omb = omb * 100.0

        out.append(np.column_stack([
            np.full(ii, id_obs, np.float32), lon, lat, lev, dat, err,
            typ.astype(np.float32), dif, omb, qc]))
        if dtype == " uv":
            out.append(np.column_stack([
                np.full(ii, ID_V, np.float32), lon, lat, lev,
                rdiag[19], err, typ.astype(np.float32), dif,
                rdiag[19] - rdiag[20], qc]))

    if not out:
        return Observations.empty(), np.zeros(0), np.zeros(0), idate
    wk = np.concatenate(out).astype(np.float64)
    obs = Observations(
        elem=wk[:, 0].astype(np.int32), lon=wk[:, 1], lat=wk[:, 2],
        lev=wk[:, 3], dat=wk[:, 4], err=wk[:, 5],
        typ=wk[:, 6].astype(np.int32) - 1, dif=wk[:, 7])
    return obs, wk[:, 8], wk[:, 9], idate


# ---------------------------------------------------------------------------
# Gridded-precipitation decoder (dec_prcp.f90)
# ---------------------------------------------------------------------------


def decode_prcp_grid(pr: np.ndarray, lons: np.ndarray, lats: np.ndarray,
                     obserr_rel: float = 0.5, obserr_min: float = 0.05,
                     obtype: int = 21) -> Observations:
    """Gridded precipitation field → rain Observations.

    Follows dec_prcp.f90: one obs per gridpoint with pr >= 0, value = rate,
    error = max(rel·value, min), element id_rain_obs, report type 21
    (1-based; PRECIP slot), lev unused (-9999).
    """
    pr = np.asarray(pr, np.float64)
    glon, glat = np.meshgrid(np.asarray(lons), np.asarray(lats),
                             indexing="xy")
    m = pr >= 0.0
    val = pr[m]
    return Observations(
        elem=np.full(val.shape, ID_RAIN, np.int32),
        lon=glon[m], lat=glat[m],
        lev=np.full(val.shape, -9999.0),
        dat=val,
        err=np.maximum(val * obserr_rel, obserr_min),
        typ=np.full(val.shape, obtype - 1, np.int32),
        dif=np.zeros(val.shape))
