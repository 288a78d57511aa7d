"""Observation taxonomy and the obs container.

The port's own copy of what it uses from scale_letkf_tpu/obs/types.py
(reference: scale/common/common_obs_scale.f90:43-170): variable ids, report
types, the QC codes the host obs context sets, and the obs_info container as
structure-of-arrays. tests/test_torch_config.py holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# --- observation variable ids (common_obs_scale.f90:47-71) ---
ID_U = 2819
ID_V = 2820
ID_T = 3073
ID_TV = 3074
ID_Q = 3330
ID_RH = 3331
ID_PS = 14593
ID_RAIN = 19999
ID_TCLON = 99991
ID_TCLAT = 99992
ID_TCMIP = 99993
ID_RADAR_REF = 4001
ID_RADAR_VR = 4002
ID_RADAR_PRH = 4003
ID_RADAR_REF_ZERO = 4004
ID_H08IR = 8800

ELEM_UID = (ID_U, ID_V, ID_T, ID_TV, ID_Q, ID_RH, ID_PS, ID_RAIN,
            ID_RADAR_REF, ID_RADAR_REF_ZERO, ID_RADAR_VR, ID_RADAR_PRH,
            ID_H08IR, ID_TCLON, ID_TCLAT, ID_TCMIP)
NID_OBS = len(ELEM_UID)

OBELM_NAMES = ("U", "V", "T", "Tv", "Q", "RH", "PS", "PRC", "REF", "RE0",
               "Vr", "PRH", "H08", "TCX", "TCY", "TCP")

# report types (common_obs_scale.f90:86-91); 0-based indices here
OBTYPE_NAMES = ("ADPUPA", "AIRCAR", "AIRCFT", "SATWND", "PROFLR",
                "VADWND", "SATEMP", "ADPSFC", "SFCSHP", "SFCBOG",
                "SPSSMI", "SYNDAT", "ERS1DA", "GOESND", "QKSWND",
                "MSONET", "GPSIPW", "RASSDA", "WDSATR", "ASCATW",
                "TMPAPR", "PHARAD", "H08IRB", "TCVITL")
NOBTYPE = len(OBTYPE_NAMES)
TYP_PHARAD = 21   # 0-based index of the phased-array radar report type (22 in 1-based)

# QC codes (common_obs_scale.f90:139-151) that the host obs context sets
QC_GOOD = 0
QC_GROSS_ERR = 5
QC_REF_MEM = 12
QC_OBS_BAD = 50
QC_OTYPE = 90


def uid_obs(elem: np.ndarray) -> np.ndarray:
    """Raw obs id → sequential uid 0..NID_OBS-1 (-1 on error)
    (common_obs_scale.f90:171-212; 1-based there)."""
    elem = np.atleast_1d(np.asarray(elem))
    out = np.full(elem.shape, -1, np.int32)
    for i, e in enumerate(ELEM_UID):
        out[elem == e] = i
    return out


def uid_obs_varlocal(elem: np.ndarray) -> np.ndarray:
    """Raw obs id → variable-localization group 0..8 (-1 on error)
    (common_obs_scale.f90:216-244): WND, T, MOI, PS, PRC, TCV, REF, Vr, H08."""
    elem = np.atleast_1d(np.asarray(elem))
    out = np.full(elem.shape, -1, np.int32)
    groups = {
        0: (ID_U, ID_V),
        1: (ID_T, ID_TV),
        2: (ID_Q, ID_RH),
        3: (ID_PS,),
        4: (ID_RAIN,),
        5: (ID_TCLON, ID_TCLAT, ID_TCMIP),
        6: (ID_RADAR_REF, ID_RADAR_REF_ZERO, ID_RADAR_PRH),
        7: (ID_RADAR_VR,),
        8: (ID_H08IR,),
    }
    for g, ids in groups.items():
        for e in ids:
            out[elem == e] = g
    return out


@dataclass
class Observations:
    """Host-side structure-of-arrays obs container (obs_info analogue,
    common_obs_scale.f90:96-110). All arrays have length nobs."""
    elem: np.ndarray          # int32 raw variable ids
    lon: np.ndarray           # deg
    lat: np.ndarray           # deg
    lev: np.ndarray           # Pa (pressure obs) or m (z-coordinate obs)
    dat: np.ndarray           # observed value
    err: np.ndarray           # obs error stdev
    typ: np.ndarray           # int32 report type (0-based)
    dif: np.ndarray           # time difference from analysis time [s]
    meta: np.ndarray = field(default_factory=lambda: np.zeros(3))  # radar lon/lat/z

    def __post_init__(self):
        self.elem = np.asarray(self.elem, np.int32)
        self.typ = np.asarray(self.typ, np.int32)
        for name in ("lon", "lat", "lev", "dat", "err", "dif"):
            setattr(self, name, np.asarray(getattr(self, name), np.float64))

    @property
    def nobs(self) -> int:
        return len(self.elem)

    def __len__(self):
        return self.nobs

    def select(self, mask_or_idx) -> "Observations":
        # np.array(): slices would otherwise return views, and callers
        # mutate the result (e.g. radar preprocessing)
        return Observations(
            elem=np.array(self.elem[mask_or_idx]),
            lon=np.array(self.lon[mask_or_idx]),
            lat=np.array(self.lat[mask_or_idx]),
            lev=np.array(self.lev[mask_or_idx]),
            dat=np.array(self.dat[mask_or_idx]),
            err=np.array(self.err[mask_or_idx]),
            typ=np.array(self.typ[mask_or_idx]),
            dif=np.array(self.dif[mask_or_idx]),
            meta=self.meta.copy())

    @staticmethod
    def concatenate(parts: list["Observations"]) -> "Observations":
        meta = next((p.meta for p in parts if np.any(p.meta != 0)),
                    np.zeros(3))
        return Observations(
            elem=np.concatenate([p.elem for p in parts]),
            lon=np.concatenate([p.lon for p in parts]),
            lat=np.concatenate([p.lat for p in parts]),
            lev=np.concatenate([p.lev for p in parts]),
            dat=np.concatenate([p.dat for p in parts]),
            err=np.concatenate([p.err for p in parts]),
            typ=np.concatenate([p.typ for p in parts]),
            dif=np.concatenate([p.dif for p in parts]),
            meta=meta)

    @staticmethod
    def empty() -> "Observations":
        z = np.zeros(0)
        return Observations(elem=z, lon=z, lat=z, lev=z, dat=z, err=z,
                            typ=z, dif=z)

