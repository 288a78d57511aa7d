"""Departure statistics monitor: per-variable O−B / O−A bias and RMSE, and
the per-obs departure record.

The port's own copy of scale_letkf_tpu/da/monitor.py, a numpy module
(reference: scale/common/common_obs_scale.f90 — monit_dep :1851,
monit_print :1899, obsdep output :2354; driver monit_obs_mpi
common_mpi_scale.f90:1481-1633).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from scale_letkf_torch.obs.types import (
    ID_H08IR, ID_PS, ID_Q, ID_RADAR_REF, ID_RADAR_REF_ZERO, ID_RADAR_VR,
    ID_RAIN, ID_RH, ID_T, ID_TV, ID_U, ID_V, OBTYPE_NAMES, QC_GOOD,
)

# monitored variable groups, mirroring monit_dep's columns
MONIT_GROUPS = (
    ("U", (ID_U,)),
    ("V", (ID_V,)),
    ("T", (ID_T, ID_TV)),
    ("Q", (ID_Q,)),
    ("RH", (ID_RH,)),
    ("PS", (ID_PS,)),
    ("RAIN", (ID_RAIN,)),
    ("REF", (ID_RADAR_REF, ID_RADAR_REF_ZERO)),
    ("Vr", (ID_RADAR_VR,)),
    ("H08", (ID_H08IR,)),
)


def _table(st: "DepartureStats", lead: str) -> list[str]:
    names = [n for n, _ in MONIT_GROUPS if st.nobs.get(n, 0) > 0]
    return [lead + "".join(f"{n:>12s}" for n in names),
            "NOBS" + lead[4:] + "".join(f"{st.nobs[n]:12d}" for n in names),
            "BIAS" + lead[4:] + "".join(f"{st.bias[n]:12.4g}" for n in names),
            "RMSE" + lead[4:] + "".join(f"{st.rmse[n]:12.4g}" for n in names)]


@dataclass
class DepartureStats:
    nobs: dict[str, int]
    bias: dict[str, float]
    rmse: dict[str, float]

    def format(self, label: str = "") -> str:
        if not any(self.nobs.get(n, 0) > 0 for n, _ in MONIT_GROUPS):
            return f"== departure stats {label}: no obs =="
        return "\n".join([f"== departure statistics {label} =="]
                         + _table(self, " " * 6))


def monit_dep(elem: np.ndarray, dep: np.ndarray,
              qc: np.ndarray) -> DepartureStats:
    """Per-group departure statistics over QC-good obs
    (common_obs_scale.f90:1851-1898)."""
    nobs, bias, rmse = {}, {}, {}
    good = qc == QC_GOOD
    for name, ids in MONIT_GROUPS:
        m = good & np.isin(elem, ids)
        n = int(m.sum())
        nobs[name] = n
        if n > 0:
            d = dep[m]
            bias[name] = float(d.mean())
            rmse[name] = float(np.sqrt((d * d).mean()))
        else:
            bias[name] = np.nan
            rmse[name] = np.nan
    return DepartureStats(nobs=nobs, bias=bias, rmse=rmse)


@dataclass
class TypedDepartureStats:
    """Per-(report type × variable) departure statistics (monit_obs_mpi,
    common_mpi_scale.f90:1481-1633)."""
    rows: dict[str, DepartureStats]     # report-type name → stats

    def format(self, label: str = "") -> str:
        lines = [f"== departure statistics by type {label} =="]
        for tname, st in self.rows.items():
            if any(st.nobs.get(n, 0) > 0 for n, _ in MONIT_GROUPS):
                lines += [f"  -- {tname}"] + _table(st, " " * 5)
        if len(lines) == 1:
            return f"== departure statistics by type {label}: no obs =="
        return "\n".join(lines)


def monit_dep_bytype(elem: np.ndarray, typ: np.ndarray, dep: np.ndarray,
                     qc: np.ndarray) -> TypedDepartureStats:
    """Departure statistics per report type × variable."""
    rows = {}
    for t in sorted(set(np.asarray(typ).tolist())):
        m = typ == t
        name = OBTYPE_NAMES[t] if 0 <= t < len(OBTYPE_NAMES) else f"TYP{t}"
        rows[name] = monit_dep(elem[m], dep[m], qc[m])
    return TypedDepartureStats(rows=rows)


@dataclass
class ObsDepRecord:
    """obsdep output record set (write_obs_dep analogue,
    common_obs_scale.f90:2354): per-obs QC, O−B, O−A for offline scoring."""
    elem: np.ndarray
    typ: np.ndarray
    lon: np.ndarray
    lat: np.ndarray
    lev: np.ndarray
    dat: np.ndarray
    err: np.ndarray
    qc: np.ndarray
    omb: np.ndarray
    oma: np.ndarray

    def save(self, path: str):
        np.savez(path, **{k: getattr(self, k) for k in
                          ("elem", "typ", "lon", "lat", "lev", "dat", "err",
                           "qc", "omb", "oma")})

    def save_binary(self, path: str, dif: np.ndarray | None = None):
        """Reference-binary obsdep (write_obs_dep, common_obs_scale.f90:2354)
        for the reference's offline scoring tools."""
        from scale_letkf_torch.obs import io as obsio
        obsio.write_obs_dep(
            path, self.elem, self.lon, self.lat, self.lev, self.dat,
            self.err, self.typ,
            np.zeros(len(self.elem)) if dif is None else dif,
            self.qc, self.omb, self.oma)

    @staticmethod
    def load(path: str) -> "ObsDepRecord":
        z = np.load(path)
        return ObsDepRecord(**{k: z[k] for k in z.files})
