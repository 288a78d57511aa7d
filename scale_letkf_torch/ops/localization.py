"""R-localization weights: Gaussian taper with a hard cutoff.

Port of scale_letkf_tpu/ops/localization.py (reference: letkf_obs.f90:27-28
and letkf_tools.f90:1850-1906 obs_local_cal): normalized distances are
tapered with exp(-0.5 d²) and cut off at d = dist_zero_fac = 2·sqrt(10/3).
"""

from __future__ import annotations

import numpy as np
import torch

DIST_ZERO_FAC = 2.0 * np.sqrt(10.0 / 3.0)
DIST_ZERO_FAC_SQ = DIST_ZERO_FAC * DIST_ZERO_FAC


def gauss_taper(ndist2: torch.Tensor) -> torch.Tensor:
    """Localization weight from the normalized squared 3-D distance, zero
    beyond the cutoff (letkf_tools.f90:1899)."""
    w = torch.exp(-0.5 * ndist2)
    return torch.where(ndist2 > DIST_ZERO_FAC_SQ, torch.zeros_like(w), w)


def normalized_dist2(dx: torch.Tensor, dy: torch.Tensor, hori_scale,
                     dvert: torch.Tensor, vert_scale) -> torch.Tensor:
    """(d_h/σ_h)² + (d_v/σ_v)², σ_v == 0 meaning no vertical localization
    (letkf_tools.f90:1851-1897)."""
    hori_scale = torch.as_tensor(hori_scale, dtype=dx.dtype, device=dx.device)
    vert_scale = torch.as_tensor(vert_scale, dtype=dx.dtype, device=dx.device)
    nd_h2 = (dx * dx + dy * dy) / (hori_scale * hori_scale)
    has_v = vert_scale > 0
    safe_v = torch.where(has_v, vert_scale, torch.ones_like(vert_scale))
    nd_v2 = torch.where(has_v, (dvert / safe_v) ** 2,
                        torch.zeros_like(nd_h2))
    return nd_h2 + nd_v2


def gaspari_cohn(r: torch.Tensor) -> torch.Tensor:
    """Gaspari & Cohn (1999) 5th-order piecewise-rational compact taper, an
    alternative localization function (r normalized so that it reaches
    zero at r = 2)."""
    r = torch.abs(r)
    r2, r3 = r * r, r * r * r
    inner = (-0.25 * r3 * r2 + 0.5 * r2 * r2 + 0.625 * r3
             - (5.0 / 3.0) * r2 + 1.0)
    outer = ((1.0 / 12.0) * r3 * r2 - 0.5 * r2 * r2 + 0.625 * r3
             + (5.0 / 3.0) * r2 - 5.0 * r + 4.0
             - (2.0 / 3.0) / torch.clamp(r, min=1e-10))
    zero = torch.zeros_like(r)
    return torch.where(r <= 1.0, inner, torch.where(r <= 2.0, outer, zero))
