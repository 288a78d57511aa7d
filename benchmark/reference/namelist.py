"""The SCALE-LETKF namelist defaults (common_nml.f90 PARAM_LETKF,
PARAM_LETKF_OBS, PARAM_LETKF_RADAR) that the reference reads where a
configuration file is silent, and the per-report-type lookup in which a
negative entry takes the first one's value."""

from __future__ import annotations

NOBTYPE = 24
HORI_LOCAL = (500.0e3,) + (-1.0,) * (NOBTYPE - 1)
VERT_LOCAL = (0.4,) + (-1.0,) * 20 + (1000.0, -1.0, -1.0)
MAX_NOBS_PER_GRID = (0,) + (-1,) * (NOBTYPE - 1)
OBS_SORT_GRID_SPACING = (0.0,) + (-1.0,) * (NOBTYPE - 1)
OBS_MIN_SPACING = (
    300.0e3, 100.0e3, 100.0e3, 150.0e3, 300.0e3, 150.0e3, 150.0e3, 100.0e3,
    150.0e3, 150.0e3, 150.0e3, 150.0e3, 150.0e3, 150.0e3, 150.0e3, 150.0e3,
    300.0e3, 150.0e3, 150.0e3, 150.0e3, 150.0e3, 1.0e3, 15.0e3, 1000.0e3)


def per_type(arr, typ: int):
    return arr[0] if arr[typ] < 0 else arr[typ]


def localization(raw: dict, typ: int) -> dict:
    """Horizontal and vertical scales, the obs-number limit and the sorting
    mesh's settings of report type typ (0-based)."""
    lo = raw.get("letkf_obs", {})
    oms = lo.get("obs_min_spacing", OBS_MIN_SPACING)
    return {"hori": per_type(lo.get("hori_local", HORI_LOCAL), typ),
            "vert": per_type(lo.get("vert_local", VERT_LOCAL), typ),
            "max_nobs": int(per_type(lo.get("max_nobs_per_grid",
                                            MAX_NOBS_PER_GRID), typ)),
            "min_spacing": oms[typ] if oms[typ] > 0 else oms[0],
            "sort_spacing": per_type(lo.get("obs_sort_grid_spacing",
                                            OBS_SORT_GRID_SPACING), typ)}


def letkf(raw: dict) -> dict:
    lt = raw.get("letkf", {})
    return {"infl": lt.get("infl_mul", 1.0),
            "rtpp": lt.get("relax_alpha", 0.0),
            "rtps": lt.get("relax_alpha_spread", 0.0),
            "gross": lt.get("gross_error", 5.0),
            "gross_ref": lt.get("gross_error_radar_ref", -1.0),
            "gross_vr": lt.get("gross_error_radar_vr", -1.0)}


def radar(raw: dict) -> dict:
    rd = raw.get("radar", {})
    return {"thres_dbz": rd.get("radar_ref_thres_dbz", 15.0),
            "min_member": rd.get("min_radar_ref_member", 1),
            "min_member_obsref": rd.get("min_radar_ref_member_obsref", 1),
            "min_ref_dbz": rd.get("min_radar_ref_dbz", 0.0),
            "low_ref_shift": rd.get("low_ref_shift", 0.0),
            "zmax": rd.get("radar_zmax", 99.0e3)}
