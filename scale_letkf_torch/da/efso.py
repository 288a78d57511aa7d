"""EFSO: ensemble forecast sensitivity to observations (Ota et al. 2013).

Port of scale_letkf_tpu/da/efso.py (reference: scale/letkf/efso.f90:186,
efso_tools.f90 — energy norm `lnorm` :52, localization advection :158, obs
impact :197; unbuilt in the reference). Each observation's contribution
to the forecast-error change,

  ΔJ_j ≈ 1/(K-1) · (δy_j / r_j) · Σ_k (HX^a)_{jk} · s_{jk}
  s_{jk} = Σ_x ρ_loc(x, x_j) · X^f_k(x) · C(x) · ē(x),

with X^f the forecast perturbations at the evaluation time, C the moist
total-energy weights and ē the mean forecast error. The localized sums s
are a Gaussian convolution of the K weighted error fields — separable 1-D
convolutions along x, y (and z), zero-padded — sampled at the obs
locations. Negative ΔJ: a beneficial observation.

The reference's lax.conv_general_dilated with padding 'SAME' is a
correlation with a symmetric kernel of odd length 2·half+1: F.conv1d with
padding=half computes the same. The products run in full FP32 (cuDNN
convolutions default to TF32 on the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from scale_letkf_torch.constants import CVDRY, RD
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.obs.operators import itpl_3d
from scale_letkf_torch.state import IA_P, IA_Q0, IA_T, IA_U, IA_V
from scale_letkf_torch.utils.device import full_fp32

CPDRY = RD + CVDRY
LHV = 2.501e6
TR = 280.0      # reference temperature  (efso_tools lnorm conventions)
PR = 1.0e5      # reference pressure
WQ = 1.0        # moist-energy switch weight


def energy_weights(nv: int, wq: float = WQ) -> np.ndarray:
    """Per-variable weights of the (moist) total energy norm
    (efso_tools.f90:52 lnorm): ½(u² + v² + cp/Tr·T² + wq·L²/(cp·Tr)·q²)."""
    w = np.zeros(nv)
    w[IA_U] = 1.0
    w[IA_V] = 1.0
    w[IA_T] = CPDRY / TR
    w[IA_Q0] = wq * LHV ** 2 / (CPDRY * TR)
    w[IA_P] = RD * TR / PR ** 2
    return 0.5 * w


def _gauss_kernel_1d(sigma_cells: float, device, cutoff_fac: float = 3.65):
    """The zero-cut Gaussian taps (2·half+1,), float32."""
    half = max(1, int(np.ceil(sigma_cells * cutoff_fac)))
    x = np.arange(-half, half + 1)
    k = np.exp(-0.5 * (x / max(sigma_cells, 1e-6)) ** 2)
    k[np.abs(x) > sigma_cells * cutoff_fac] = 0.0
    return torch.as_tensor(k, dtype=torch.float32, device=device)


def _conv1d(field: torch.Tensor, kernel: torch.Tensor,
            dim: int) -> torch.Tensor:
    """Same-size zero-padded 1-D correlation with the symmetric kernel
    along `dim`."""
    moved = field.movedim(dim, -1)
    shape = moved.shape
    flat = moved.reshape(-1, 1, shape[-1])
    out = F.conv1d(flat, kernel.to(flat.dtype).reshape(1, 1, -1),
                   padding=kernel.shape[0] // 2)
    return out.reshape(shape).movedim(-1, dim)


@full_fp32()
def localized_sums(fields: torch.Tensor, sigma_x: float, sigma_y: float,
                   sigma_z: float) -> torch.Tensor:
    """Gaussian-localized running sums of (K, nz, ny, nx) fields by
    separable convolutions (σ in cells; σ ≤ 0 skips that axis)."""
    out = fields
    for sigma, dim in ((sigma_x, -1), (sigma_y, -2), (sigma_z, -3)):
        if sigma > 0:
            out = _conv1d(out, _gauss_kernel_1d(sigma, fields.device), dim)
    return out


def advected_obs_coords(
    obs_ri: torch.Tensor, obs_rj: torch.Tensor, obs_rk: torch.Tensor,
    u_mean: torch.Tensor, v_mean: torch.Tensor,   # (nz, ny, nx) ½(ua + uf)
    grid: Grid,
    adv_time: float,                              # evaluation period eft [s]
    locadv_rate: float = 1.0,                     # LOCADV_RATE
) -> tuple[torch.Tensor, torch.Tensor]:
    """Advected localization (loc_advection, efso_tools.f90:158): the obs
    sampling location moves downstream with the mean wind interpolated at
    the obs, by locadv_rate·adv_time."""
    u_at = itpl_3d(u_mean, obs_rk, obs_ri, obs_rj)
    v_at = itpl_3d(v_mean, obs_rk, obs_ri, obs_rj)
    d = locadv_rate * adv_time
    return obs_ri + d * u_at / grid.dx, obs_rj + d * v_at / grid.dy


def weighted_error_fields(fcst_pert: torch.Tensor,
                          err_mean: torch.Tensor) -> torch.Tensor:
    """F_k(x) = Σ_v w_v · Xf_k,v(x) · ē_v(x), (K, nz, ny, nx), summed one
    variable at a time: no ensemble-sized temporary."""
    w = energy_weights(fcst_pert.shape[1])
    we = err_mean * torch.as_tensor(w, dtype=err_mean.dtype,
                                    device=err_mean.device)[:, None, None,
                                                            None]
    f_k = torch.zeros_like(fcst_pert[:, 0])
    for v in np.nonzero(w)[0]:
        f_k.addcmul_(fcst_pert[:, v], we[v])
    return f_k


def efso_impact(
    obs_ri: torch.Tensor,         # (nobs,) fractional x-index of each obs
    obs_rj: torch.Tensor,
    obs_rk: torch.Tensor,         # fractional level (0 for surface obs)
    dep: torch.Tensor,            # (nobs,) innovations y - H(x̄b)
    rdiag: torch.Tensor,          # (nobs,) obs error variances
    hdxa: torch.Tensor,           # (nobs, K) analysis-ensemble obs perturbations
    fcst_pert: torch.Tensor,      # (K, nv, nz, ny, nx) forecast perturbations
    err_mean: torch.Tensor,       # (nv, nz, ny, nx) (e_{t|0}+e_{t|-6})/2
    grid: Grid,
    hori_scale: float,            # localization scale [m]
    vert_scale_cells: float = 0.0,
    u_adv: torch.Tensor | None = None,   # (nz, ny, nx) ½(ua+uf) for advected
    v_adv: torch.Tensor | None = None,   # localization (None: no advection)
    adv_time: float = 0.0,               # evaluation period eft [s]
    locadv_rate: float = 1.0,
) -> torch.Tensor:
    """Per-obs forecast-error impact ΔJ (nobs,), negative = beneficial."""
    if u_adv is not None and adv_time > 0:
        obs_ri, obs_rj = advected_obs_coords(
            obs_ri, obs_rj, obs_rk, u_adv, v_adv, grid, adv_time,
            locadv_rate)
    K = fcst_pert.shape[0]
    s_k = localized_sums(weighted_error_fields(fcst_pert, err_mean),
                         hori_scale / grid.dx, hori_scale / grid.dy,
                         vert_scale_cells)                # (K, nz, ny, nx)
    s_at_obs = itpl_3d(s_k, obs_rk, obs_ri, obs_rj)       # (K, nobs)
    # ΔJ_j = 1/(K-1) · dep_j/r_j · Σ_k hdxa_jk s_kj
    inner = torch.sum(hdxa * s_at_obs.T, dim=-1)
    return dep / rdiag * inner / (K - 1)
