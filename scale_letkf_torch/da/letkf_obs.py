"""Observation preprocessing for the LETKF analysis: QC, departures, and the
per-combined-type selection context.

Port of scale_letkf_tpu/da/letkf_obs.py, the host (numpy) path only
(reference `set_letkf_obs`, scale/letkf/letkf_obs.f90:78-1184): radar dBZ
conversion and no-rain relabeling (:275-298), the (elm, typ) combined-type
registry with per-ctype localization scales (:308-342), ensemble-mean
departures and Hdx (:474-493), gross-error and radar min-member QC
(:384-561), and the bucket sort of obs into per-ctype sorting meshes
(:660-855). The context stays numpy; io/convert.py moves it to a device.
A structural context (the fused cycle's, da/fastcycle.py) runs the static
checks alone on an already preprocessed template.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np

from scale_letkf_torch.config import Config
from scale_letkf_torch.obs.types import (
    Observations, ID_RADAR_REF, ID_RADAR_REF_ZERO, ID_RADAR_VR, ID_RAIN,
    ID_PS, ID_H08IR, QC_GOOD, QC_GROSS_ERR, QC_OTYPE, QC_OBS_BAD,
    QC_REF_MEM, uid_obs, uid_obs_varlocal, TYP_PHARAD, ELEM_UID,
    OBTYPE_NAMES, OBELM_NAMES,
)
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.ops.localization import DIST_ZERO_FAC
from scale_letkf_torch.ops.obs_select import BucketGrid, build_buckets

UNDEF = -9.99e33


@dataclass
class CtypeContext:
    """Selection context for one (elem, typ) combined obs type."""
    elem: int
    typ: int
    hori_scale: float            # m
    vert_scale: float            # ln p, or m for radar; 0 = no vert loc
    vert_kind: str               # 'logp' | 'z' | 'ps_obs' | 'rain_base'
    max_nobs: int                # 0 = unlimited
    varlocal_group: int          # 0..8
    buckets: BucketGrid
    obs_idx: np.ndarray          # global obs indices of this ctype's members


@dataclass
class ObsContext:
    """Everything the analysis needs about observations, in global arrays."""
    nobs: int
    x: np.ndarray                # projection coords [m]
    y: np.ndarray
    vert: np.ndarray             # per-obs vertical localization coordinate
    err: np.ndarray
    dep: np.ndarray              # y - H(x̄)
    depd: np.ndarray | None      # deterministic-run departure
    hdxb: np.ndarray             # (nobs, K) ensemble H(x) perturbations
    qc: np.ndarray
    elem: np.ndarray
    typ: np.ndarray
    dat: np.ndarray | None = None    # preprocessed obs values (radar in dBZ)
    ctypes: list[CtypeContext] = field(default_factory=list)
    summary: str = ""


def obs_usage_table(obs: Observations, qc: np.ndarray) -> str:
    """Obs counts per (report type × variable), before/after QC — the
    diagnostic tables of letkf_obs.f90:702-739,870-921."""
    elem_u = uid_obs(obs.elem)
    lines = ["== obs usage (total / qc-good) =="]
    for t in sorted(set(obs.typ.tolist())):
        m_t = obs.typ == t
        parts = []
        for u in sorted(set(elem_u[m_t].tolist())):
            m = m_t & (elem_u == u)
            parts.append(f"{OBELM_NAMES[u]}:{int(m.sum())}/"
                         f"{int((m & (qc == QC_GOOD)).sum())}")
        name = OBTYPE_NAMES[t] if 0 <= t < len(OBTYPE_NAMES) else f"TYP{t}"
        lines.append(f"  {name:8s} " + "  ".join(parts))
    return "\n".join(lines)


def preprocess_radar_obs(obs: Observations, cfg: Config) -> Observations:
    """Radar reflectivity unit conversion and no-rain relabeling
    (letkf_obs.f90:275-298): linear-Z obs → dBZ; below-threshold obs become
    the ref-zero type pinned at MIN_RADAR_REF_DBZ + LOW_REF_SHIFT."""
    obs = obs.select(slice(None))  # copy
    r = cfg.radar
    m = obs.elem == ID_RADAR_REF
    valid = (obs.dat >= 0.0) & (obs.dat < 1.0e10)
    low = m & valid & (obs.dat < r.min_radar_ref)
    hi = m & valid & ~(obs.dat < r.min_radar_ref)
    obs.elem[low] = ID_RADAR_REF_ZERO
    obs.dat[low] = r.min_radar_ref_dbz + r.low_ref_shift
    obs.dat[hi] = 10.0 * np.log10(obs.dat[hi])
    obs.dat[m & ~valid] = UNDEF
    z = obs.elem == ID_RADAR_REF_ZERO
    obs.dat[z & ~m] = r.min_radar_ref_dbz + r.low_ref_shift
    if r.use_obserr_radar_ref:
        obs.err[(obs.elem == ID_RADAR_REF) | (obs.elem == ID_RADAR_REF_ZERO)] \
            = cfg.obs_error.radar_ref
    if r.use_obserr_radar_vr:
        obs.err[obs.elem == ID_RADAR_VR] = cfg.obs_error.radar_vr
    return obs


def qc_and_departures(
    obs: Observations,
    ensval: np.ndarray,            # (K, nobs) raw ensemble H(x)
    qc_in: np.ndarray,
    cfg: Config,
    ensval_det: np.ndarray | None = None,
    hx_lev: np.ndarray | None = None,
):
    """Ensemble-mean departures, Hdx perturbations, gross-error and radar
    min-member QC (letkf_obs.f90:384-561). Returns (dep, hdxb (nobs, K),
    qc, depd)."""
    qc = qc_in.astype(np.int32).copy()
    r = cfg.radar
    is_ref = (obs.elem == ID_RADAR_REF) | (obs.elem == ID_RADAR_REF_ZERO)
    is_vr = obs.elem == ID_RADAR_VR
    is_h08 = obs.elem == ID_H08IR

    # compare in float32: H(x) is float32 on the device paths, so members
    # within float32 eps of RADAR_REF_THRES_DBZ flip QC_REF_MEM identically
    mem_ref = ((np.asarray(ensval).astype(np.float32, copy=False)
                > np.float32(r.radar_ref_thres_dbz) + np.float32(1e-6))
               .sum(axis=0)
               if is_ref.any() else np.zeros(obs.nobs, np.int64))
    mem_cld = np.zeros(obs.nobs, np.int64)
    if is_h08.any():
        ensval = ensval.copy()
        mem_cld = ((ensval < 0) & is_h08[None, :]).sum(axis=0)
        ensval[:, is_h08] = np.abs(ensval[:, is_h08])
    mean = ensval.mean(axis=0)
    hdxb = (ensval - mean[None, :]).T      # (nobs, K)

    if not r.use_radar_ref:
        qc[is_ref & (qc == QC_GOOD)] = QC_OTYPE
    if not r.use_radar_vr:
        qc[is_vr & (qc == QC_GOOD)] = QC_OTYPE
    qc[is_ref & (obs.dat == UNDEF)] = QC_OBS_BAD

    # radar min-member check: enough members must see an echo
    if is_ref.any():
        obs_rainy = obs.dat > r.radar_ref_thres_dbz + 1e-6
        need = np.where(obs_rainy, r.min_radar_ref_member_obsref,
                        r.min_radar_ref_member)
        qc[is_ref & (qc == QC_GOOD) & (mem_ref < need)] = QC_REF_MEM

    # Himawari-8: cloudy members carry negated BT (common_obs_scale.f90:
    # 2957-2963); count then un-negate (letkf_obs.f90:432-470), reject obs
    # sensitive above H08_LIMIT_LEV
    if is_h08.any():
        qc[is_h08 & (obs.dat == UNDEF)] = QC_OBS_BAD
        if hx_lev is not None:
            qc[is_h08 & (hx_lev < cfg.h08.h08_limit_lev)] = QC_OBS_BAD
        qc[is_h08 & (obs.dat < cfg.h08.h08_bt_min)] = QC_GROSS_ERR

    dep = obs.dat - mean
    depd = (obs.dat - ensval_det) if ensval_det is not None else None

    # gross error by obs kind (letkf_obs.f90:503-561)
    thr = np.full(obs.nobs, cfg.letkf.gross_error)
    thr[obs.elem == ID_RAIN] = cfg.letkf.gross_thresh("rain")
    thr[is_ref] = cfg.letkf.gross_thresh("radar_ref")
    thr[is_vr] = cfg.letkf.gross_thresh("radar_vr")
    # H08 adaptive gross check: clear-sky background (few cloudy members)
    # gets a tight 1-sigma limit (letkf_obs.f90:521-537)
    thr[is_h08] = np.where(mem_cld[is_h08] < cfg.h08.h08_min_cld_member,
                           1.0, cfg.letkf.gross_thresh("h08"))
    qc[(qc == QC_GOOD) & (np.abs(dep) > thr * obs.err)] = QC_GROSS_ERR
    return dep, hdxb, qc, depd


def _sort_mesh(lo, typ: int, cutoff: float, max_nobs: int, grid: Grid):
    """(spacing, nsch, cap_max) of one ctype's sorting mesh: the reference's
    automatic sizing from OBS_SORT_GRID_SPACING / MAX_NOBS_PER_GRID ·
    OBS_MIN_SPACING (letkf_obs.f90:660-672). Cells finer than the cutoff
    widen the search halo (nsch cells ≈ the reference's ngrdsch), clamped
    to ≤ 5 cells so the candidate width stays bounded."""
    sgs = lo.obs_sort_grid_spacing[typ]
    if sgs < 0:
        sgs = lo.obs_sort_grid_spacing[0]
    oms = lo.obs_min_spacing[typ]
    if oms <= 0:
        oms = lo.obs_min_spacing[0]
    if sgs > 0:
        target = sgs
    elif max_nobs > 0 and oms > 0:
        target = 0.1 * np.sqrt(float(max_nobs)) * oms
    else:
        target = cutoff
    spacing = float(np.clip(target, cutoff / 5.0, cutoff))
    spacing = max(spacing, float(min(grid.dx, grid.dy)))
    nsch = max(1, int(np.ceil(cutoff / spacing)))
    # capacity bound: config override, else 2× the per-gridpoint obs limit
    # spread over the nsch² cells of one cutoff radius, floored at 16 (two
    # 8-level report columns sharing one fine cell), else unbounded
    if lo.max_bucket_capacity > 0:
        cap_max = lo.max_bucket_capacity
    elif max_nobs > 0:
        cap_max = max(16, -(-2 * max_nobs // (nsch * nsch)))
    else:
        cap_max = 0
    return spacing, nsch, cap_max


def _static_qc(obs: Observations, qc_in: np.ndarray, cfg: Config):
    """The checks that need no obs value or H(x): disabled radar kinds →
    QC_OTYPE, undefined template values → QC_OBS_BAD."""
    qc = qc_in.astype(np.int32).copy()
    r = cfg.radar
    is_ref = (obs.elem == ID_RADAR_REF) | (obs.elem == ID_RADAR_REF_ZERO)
    if not r.use_radar_ref:
        qc[is_ref & (qc == QC_GOOD)] = QC_OTYPE
    if not r.use_radar_vr:
        qc[(obs.elem == ID_RADAR_VR) & (qc == QC_GOOD)] = QC_OTYPE
    qc[obs.dat == UNDEF] = QC_OBS_BAD
    return qc


def build_obs_context(
    obs: Observations,
    ensval: np.ndarray | None,     # (K, nobs) raw ensemble H(x)
    qc_in: np.ndarray,
    cfg: Config,
    grid: Grid,
    ensval_det: np.ndarray | None = None,
    hx_lev: np.ndarray | None = None,
    structural: bool = False,
) -> ObsContext:
    """The set_letkf_obs pipeline → ObsContext with per-ctype buckets.

    structural=True builds the template-only context of the fused cycle
    (da/fastcycle.py), whose obs values are inputs of each cycle: no
    value-dependent preprocessing or QC runs — the template must already be
    preprocessed (preprocess_radar_obs) — only the static checks
    (_static_qc). Every obs passing them enters the buckets; dep and hdxb
    are zeros (K columns, 2 without ensval), and the per-cycle gross-error
    and radar min-member checks are the fused cycle's good mask."""
    if structural:
        obs = obs.select(slice(None))  # copy
        qc = _static_qc(obs, qc_in, cfg)
        K = 2 if ensval is None else int(ensval.shape[0])
        dep, hdxb, depd = np.zeros(obs.nobs), np.zeros((obs.nobs, K)), None
    else:
        obs = preprocess_radar_obs(obs, cfg)
        dep, hdxb, qc, depd = qc_and_departures(obs, ensval, qc_in, cfg,
                                                ensval_det, hx_lev)
    good = qc == QC_GOOD
    x, y = grid.proj.lonlat_to_xy(obs.lon, obs.lat)

    # per-obs vertical localization coordinate (obs_local_cal,
    # letkf_tools.f90:1851-1865)
    is_radar_typ = obs.typ == TYP_PHARAD
    vert = np.where(obs.lev > 0, np.log(np.maximum(obs.lev, 1e-10)), 0.0)
    vert[is_radar_typ] = obs.lev[is_radar_typ]                 # z coordinate
    m_ps = obs.elem == ID_PS
    vert[m_ps] = np.log(np.maximum(obs.dat[m_ps], 1e-10))      # obs ps value
    m_rain = obs.elem == ID_RAIN
    vert[m_rain] = np.log(cfg.letkf_obs.vert_local_rain_base)
    # H08: the weighting-function peak pressure from the obs operator
    m_h08 = obs.elem == ID_H08IR
    if m_h08.any() and hx_lev is not None:
        vert[m_h08] = np.log(np.maximum(hx_lev[m_h08], 1e-10))

    ctx = ObsContext(nobs=obs.nobs, x=x, y=y, vert=vert, err=obs.err,
                     dep=dep, depd=depd, hdxb=hdxb, qc=qc,
                     elem=obs.elem, typ=obs.typ, dat=obs.dat,
                     summary=obs_usage_table(obs, qc))

    # combined types present among good obs, in (typ, elem_uid) order
    lo = cfg.letkf_obs
    elem_u = uid_obs(obs.elem)
    vl_group = uid_obs_varlocal(obs.elem)
    half_x = grid.nx * grid.dx / 2
    half_y = grid.ny * grid.dy / 2
    pairs = sorted({(int(t), int(u)) for t, u in
                    zip(obs.typ[good], elem_u[good])})
    for typ, u in pairs:
        if not lo.use_obs[typ]:
            continue
        elem = ELEM_UID[u]
        idx = np.nonzero(good & (obs.typ == typ) & (elem_u == u))[0]
        if elem == ID_RADAR_REF_ZERO and lo.hori_local_radar_obsnoref > 0:
            hs = lo.hori_local_radar_obsnoref
        elif elem == ID_RADAR_VR and lo.hori_local_radar_vr > 0:
            hs = lo.hori_local_radar_vr
        else:
            hs = lo.hori_local_for(typ)
        if elem == ID_RADAR_VR and lo.vert_local_radar_vr > 0:
            vs = lo.vert_local_radar_vr
        else:
            vs = lo.vert_local_for(typ)
        if typ == TYP_PHARAD:
            vkind = "z"
        elif elem == ID_PS:
            vkind = "ps_obs"
        elif elem == ID_RAIN:
            vkind = "rain_base"
        else:
            vkind = "logp"
        max_nobs = lo.max_nobs_for(typ)
        spacing, nsch, cap_max = _sort_mesh(lo, typ, hs * DIST_ZERO_FAC,
                                            max_nobs, grid)
        buckets = build_buckets(x[idx], y[idx], -half_x, -half_y,
                                half_x, half_y, spacing,
                                max_capacity=cap_max,
                                index_map=idx.astype(np.int32),
                                nsch=nsch)
        if buckets.n_dropped > 0 and max_nobs <= 0:
            # with a top-k obs limit, capacity thinning is the documented
            # density approximation; without one, any drop is a real loss
            warnings.warn(
                f"obs bucket capacity overflow for ctype (elem={elem}, "
                f"typ={typ}): {buckets.n_dropped} obs dropped (cell cap "
                f"{cap_max}); raise letkf_obs.max_bucket_capacity if these "
                f"are vertically stacked reports", stacklevel=2)
        ctx.ctypes.append(CtypeContext(
            elem=elem, typ=typ, hori_scale=hs, vert_scale=vs,
            vert_kind=vkind, max_nobs=max_nobs,
            varlocal_group=int(vl_group[idx[0]]),
            buckets=buckets, obs_idx=idx))
    return ctx
