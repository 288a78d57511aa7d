"""Precipitation observation transforms (Gaussian anamorphosis).

Port of scale_letkf_tpu/obs/precip.py, numpy and scipy on the host as
there. Equivalent of the reference's precipitation-assimilation module
(reference: scale/common/common_precip.f90 — pptrans_normal :184-220,
pptrans_log :224-237, pptrans_normal_mdzero_def :241-310 modified
median-zero-rain treatment (Lien et al.), compact_tail :332+, dinvnorm
rational inverse normal). Offline/optional in the reference; vectorized
NumPy here (these run in obs preprocessing, not in the analysis).
"""

from __future__ import annotations

import numpy as np
from scipy.special import ndtri  # inverse standard normal CDF

NCDF = 200                      # number of CDF bins (common_precip.f90:37)
PPZERO_THRES = 0.06             # no-precip threshold (:40)
LOG_TRANS_TINY = 0.6            # log-transform offset (:47)
GAUSSTAIL_THRES = 0.001         # tail compaction (:48)


def compact_tail(pos_cdf: np.ndarray) -> np.ndarray:
    """Clip CDF positions away from 0/1 so the inverse normal stays finite
    (common_precip.f90 compact_tail)."""
    return np.clip(pos_cdf, GAUSSTAIL_THRES, 1.0 - GAUSSTAIL_THRES)


def empirical_cdf(samples: np.ndarray) -> tuple[np.ndarray, float]:
    """Build the (NCDF+1)-bin empirical precipitation CDF table and the
    zero-precip probability from a sample climatology (the reference reads
    these precomputed from files; this builds them from data)."""
    s = np.sort(np.asarray(samples, float))
    ppzero = float((s < PPZERO_THRES).mean())
    qs = np.linspace(0.0, 1.0, NCDF + 1)
    table = np.quantile(s, qs)
    return table, ppzero


def pptrans_normal(pp: np.ndarray, ppcdf: np.ndarray, ppzero: float) -> np.ndarray:
    """Gaussian transform of rain amounts through the empirical CDF
    (pptrans_normal, common_precip.f90:184-220). Zero-rain values map to the
    median of the zero-rain probability mass."""
    pp = np.asarray(pp, float)
    b = np.clip(np.searchsorted(ppcdf, pp, side="right"), 1, NCDF)
    lo = ppcdf[b - 1]
    hi = ppcdf[b]
    rr = np.where(hi > lo, (pp - lo) / np.where(hi > lo, hi - lo, 1.0), 0.0)
    pos = ((1.0 - rr) * (b - 1) + rr * b) / NCDF
    pos = np.where(pp < ppcdf[0], 0.0, pos)
    pos = np.where(pp >= ppcdf[-1], 1.0, pos)
    pos = np.where(pp < PPZERO_THRES, ppzero * 0.5, pos)
    return ndtri(compact_tail(pos))


def pptrans_log(pp: np.ndarray) -> np.ndarray:
    """Log transform with zero-rain floor (common_precip.f90:224-237)."""
    pp = np.asarray(pp, float)
    return np.where(pp < PPZERO_THRES, np.log(LOG_TRANS_TINY),
                    np.log(pp + LOG_TRANS_TINY))


def pptrans_normal_mdzero(pp_ens: np.ndarray, ppcdf: np.ndarray,
                          ppzero: float) -> tuple[np.ndarray, int, float, float]:
    """Modified median-zero-rain Gaussian transform of a member ensemble
    (pptrans_normal_mdzero_def, common_precip.f90:241-310): rainy members go
    through the CDF transform; zero-rain members are assigned a fitted
    Gaussian value so the transformed ensemble is consistent.

    Returns (transformed ensemble, zero_mem, ym, sigma)."""
    pp_ens = np.asarray(pp_ens, float).copy()
    K = len(pp_ens)
    zero = pp_ens < PPZERO_THRES
    zero_mem = int(zero.sum())
    rainy = ~zero
    if rainy.any():
        pp_ens[rainy] = pptrans_normal(pp_ens[rainy], ppcdf, ppzero)
    beta = pp_ens[rainy].sum() / K
    ppzero_b = zero_mem / K
    pprain_b = 1.0 - ppzero_b

    y_trace = ndtri(compact_tail(np.asarray(ppzero)))
    y_trace_b = ndtri(compact_tail(np.asarray(ppzero_b)))
    alpha = -np.exp(-0.5 * y_trace_b * y_trace_b) / np.sqrt(2.0 * np.pi)
    denom = alpha + pprain_b * y_trace_b
    if abs(denom) < 1e-12:
        ym, sigma = 0.0, 1.0
    else:
        ym = (alpha * y_trace + beta * y_trace_b) / denom
        sigma = (pprain_b * y_trace - beta) / denom
    if zero_mem:
        pos = ppzero_b * 0.5
        pp_ens[zero] = ym + sigma * ndtri(compact_tail(np.asarray(pos)))
    return pp_ens, zero_mem, float(ym), float(sigma)
