"""Calibration of the Himawari-8 band-emission model (obs/h08.py).

Port of scale_letkf_tpu/obs/h08_calibrate.py (reference: the RTTOV
coefficient role, scale_H08_fwd.F90:6-26). RTTOV's coefficients are not
redistributable, so the band model's free parameters (K_WV, K_FIX,
WV_P_EXP) are fitted against a higher-fidelity surrogate: a correlated-k
clear-sky model whose per-band water-vapour absorption spans several
decades of line strength, so that band transmittance saturates
sub-exponentially, where a gray k is wrong.

    python -m scale_letkf_torch.obs.h08_calibrate OUT.json [--device cpu]

generates a diverse clear-sky profile set, computes the surrogate BTs
(numpy, float64), fits the band model by Adam on the BT misfit on the
device (torch.optim.Adam at optax.adam's defaults, the reference's
optimizer), writes the fitted coefficients and residual statistics to
OUT.json and prints a residual table. h08.load_calibration reads the
result as an H08Coefficients.

The fit runs in float64 by default; the reference's runs in JAX's default
dtype (float32 unless x64 is enabled).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from scale_letkf_torch.constants import GRAV, RD
from scale_letkf_torch.obs import h08
from scale_letkf_torch.obs.h08 import DEFAULT_COEF, H08Coefficients

# k-distribution g-points: weights of a log-spaced absorption spectrum
# within each band; 4 points over 3 decades of line strength around the
# band-mean k reproduce Goody-model curve-of-growth behaviour
G_WEIGHTS = np.array([0.45, 0.3, 0.2, 0.05])
G_SCALES = np.array([0.12, 1.0, 6.0, 40.0])

# band-mean H2O absorption [m^2/kg] for AHI B07..B16, independent of (and
# deliberately different from) h08.K_WV, so that the fit target is not the
# model itself
KBAR_WV = np.array([0.010, 2.2, 0.75, 0.30, 0.017,
                    0.013, 0.008, 0.008, 0.018, 0.014])
KFIX_REF = np.array([6e-6, 9e-6, 9e-6, 9e-6, 6e-6,
                     1.5e-4, 6e-6, 5e-6, 9e-6, 4.2e-4])
P_EXP_REF = 0.75
BANDS = ("B07", "B08", "B09", "B10", "B11",
         "B12", "B13", "B14", "B15", "B16")


def _planck_rad(t, wn):
    return h08.C1 * wn ** 3 / (np.exp(h08.C2 * wn / t) - 1.0)


def _planck_bt(rad, wn):
    return h08.C2 * wn / np.log1p(h08.C1 * wn ** 3 / np.maximum(rad, 1e-30))


def surrogate_bt(p, t, qv, tsfc, psfc, zenith):
    """Correlated-k clear-sky BT (..., 10) of all bands: h08_rt_fwd's layer
    geometry, but per band a transmittance weighted over g-points instead
    of one exponential."""
    p, t, qv = np.asarray(p), np.asarray(t), np.asarray(qv)
    p_lo = np.concatenate([psfc[..., None],
                           0.5 * (p[..., :-1] + p[..., 1:])], axis=-1)
    p_hi = np.concatenate([0.5 * (p[..., :-1] + p[..., 1:]),
                           0.5 * p[..., -1:]], axis=-1)
    dm = np.maximum(p_lo - p_hi, 0.0) / GRAV
    pb = (np.maximum(p, 1.0) / h08.P0) ** P_EXP_REF
    sec = 1.0 / np.maximum(np.cos(zenith), 0.2)[..., None]

    u = (qv * pb * dm) * sec                       # (..., nz) scaled path
    u_rev = np.flip(u, axis=-1)
    dm_rev = np.flip(dm, axis=-1)
    t_rev = np.flip(t, axis=-1)
    wn = np.asarray(h08.WAVENUM)
    out = np.empty(p.shape[:-1] + (len(wn),))
    for b in range(len(wn)):
        # per-g-point gas optical depth, with the gray fixed gases
        tau_above = np.ones(p.shape[:-1] + (len(G_WEIGHTS),))
        rad = np.zeros(p.shape[:-1])
        cum_fix = np.zeros(p.shape[:-1])
        for k in range(p.shape[-1]):
            od_g = KBAR_WV[b] * G_SCALES * u_rev[..., k, None]
            od_f = KFIX_REF[b] * dm_rev[..., k] * sec[..., 0]
            tau_below = tau_above * np.exp(-od_g)
            fix_above = np.exp(-cum_fix)
            cum_fix = cum_fix + od_f
            fix_below = np.exp(-cum_fix)
            # emission weight of this layer: d(band transmittance)
            tr_above = (tau_above * G_WEIGHTS).sum(-1) * fix_above
            tr_below = (tau_below * G_WEIGHTS).sum(-1) * fix_below
            rad = rad + _planck_rad(t_rev[..., k], wn[b]) * (
                tr_above - tr_below)
            tau_above = tau_below
        tr_sfc = (tau_above * G_WEIGHTS).sum(-1) * np.exp(-cum_fix)
        rad = rad + _planck_rad(tsfc, wn[b]) * tr_sfc
        out[..., b] = _planck_bt(rad, wn[b])
    return out


def make_profile_set(n=64, nz=24, seed=0):
    """Diverse clear-sky profiles: surface temperature 245..305 K, scaled
    humidity 10%..95% of saturation, tropopause height varied."""
    rng = np.random.default_rng(seed)
    t0 = rng.uniform(245.0, 305.0, n)
    rh = rng.uniform(0.10, 0.95, n)
    gam = rng.uniform(5.5e-3, 7.5e-3, n)
    ztrop = rng.uniform(9e3, 17e3, n)
    z = np.linspace(200.0, 22e3, nz)
    t = np.maximum(t0[:, None] - gam[:, None] * z[None, :],
                   t0[:, None] - gam[:, None] * ztrop[:, None])
    h = RD * 260.0 / GRAV
    psfc = np.full(n, 1.0e5)
    p = psfc[:, None] * np.exp(-z[None, :] / h)
    # Tetens saturation on specific humidity
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    qs = 0.622 * es / np.maximum(p - 0.378 * es, 1.0)
    qv = np.minimum(rh[:, None] * qs, 0.03) * np.exp(-z[None, :] / 12e3)
    tsfc = t0 + rng.uniform(-2.0, 6.0, n)
    zen = rng.uniform(0.0, 1.05, n)     # 0..60 deg
    return dict(p=p, t=t, qv=qv, tsfc=tsfc, psfc=psfc, zenith=zen)


def initial_params(coef: H08Coefficients = DEFAULT_COEF, *,
                   device: torch.device,
                   dtype: torch.dtype = torch.float64) -> dict:
    """The free parameters of coef: log K_WV, log K_FIX, WV_P_EXP."""
    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)
    return {"log_kwv": torch.log(t(coef.k_wv)),
            "log_kfix": torch.log(t(coef.k_fix)),
            "p_exp": t(coef.wv_p_exp)}


def _model_bt(params: dict, prof: dict) -> torch.Tensor:
    """Band-model clear-sky BT (n, 10) with the free (log) coefficients of
    params (tensors, differentiable), on their device and in their dtype."""
    like = params["p_exp"]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                               device=like.device)
    k_wv = torch.exp(params["log_kwv"])
    k_fix = torch.exp(params["log_kfix"])
    p, temp, qv = t(prof["p"]), t(prof["t"]), t(prof["qv"])
    psfc, tsfc, zen = t(prof["psfc"]), t(prof["tsfc"]), t(prof["zenith"])
    wn = t(h08.WAVENUM)
    p_lo = torch.cat([psfc[..., None], 0.5 * (p[..., :-1] + p[..., 1:])],
                     dim=-1)
    p_hi = torch.cat([0.5 * (p[..., :-1] + p[..., 1:]), 0.5 * p[..., -1:]],
                     dim=-1)
    dm = torch.clamp(p_lo - p_hi, min=0.0) / GRAV
    pb = (torch.clamp(p, min=1.0) / h08.P0) ** params["p_exp"]
    sec = (1.0 / torch.clamp(torch.cos(zen), min=0.2))[..., None, None]
    od = (k_wv * (qv * pb * dm)[..., None] + k_fix * dm[..., None]) * sec
    od_rev = torch.clamp(torch.flip(od, dims=[-2]), min=0.0)
    tau_above = torch.exp(-torch.cumsum(od_rev, dim=-2) + od_rev)
    tau_below = tau_above * torch.exp(-od_rev)
    b = h08.planck_rad(torch.flip(temp, dims=[-1])[..., None], wn)
    rad = torch.sum(b * (tau_above - tau_below), dim=-2)
    rad = rad + h08.planck_rad(tsfc[..., None], wn) * tau_below[..., -1, :]
    return h08.planck_bt(rad, wn)


def fit(prof=None, bt_ref=None, steps=600, lr=0.05, seed=0,
        coef: H08Coefficients = DEFAULT_COEF, *, device: torch.device,
        dtype: torch.dtype = torch.float64):
    """Fits (K_WV, K_FIX, WV_P_EXP), starting from coef, to the surrogate
    BTs by Adam (lr, β 0.9/0.999, ε 1e-8: optax.adam's defaults) on
    `device`. Returns (fitted dict, stats dict with the residuals before
    and after)."""
    if prof is None:
        prof = make_profile_set(seed=seed)
    if bt_ref is None:
        bt_ref = surrogate_bt(prof["p"], prof["t"], prof["qv"],
                              prof["tsfc"], prof["psfc"], prof["zenith"])
    bt_ref = torch.as_tensor(np.asarray(bt_ref), dtype=dtype, device=device)
    params = initial_params(coef, device=device, dtype=dtype)

    def loss(ps):
        return torch.mean((_model_bt(ps, prof) - bt_ref) ** 2)

    def residuals(ps):
        with torch.no_grad():
            d = _model_bt(ps, prof) - bt_ref
            return (float(torch.sqrt(torch.mean(d ** 2))),
                    torch.sqrt(torch.mean(d ** 2, dim=0)).cpu().numpy())

    rmse0, per_band0 = residuals(params)
    for v in params.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    for _ in range(steps):
        opt.zero_grad()
        loss(params).backward()
        opt.step()
    params = {k: v.detach() for k, v in params.items()}
    rmse1, per_band1 = residuals(params)
    fitted = {"k_wv": torch.exp(params["log_kwv"]).cpu().tolist(),
              "k_fix": torch.exp(params["log_kfix"]).cpu().tolist(),
              "wv_p_exp": float(params["p_exp"])}
    stats = {"reference": "correlated-k 4-g-point surrogate (NOT RTTOV)",
             "n_profiles": int(np.asarray(prof["p"]).shape[0]),
             "bt_rmse_before_K": round(rmse0, 3),
             "bt_rmse_after_K": round(rmse1, 3),
             "per_band_rmse_before_K": [round(float(v), 3)
                                        for v in per_band0],
             "per_band_rmse_after_K": [round(float(v), 3)
                                       for v in per_band1]}
    return fitted, stats


def main(out_path: str, device: torch.device | None = None):
    """Fits on `device` (the GPU when None) and writes the coefficients and
    statistics to out_path (JSON), printing the residual table."""
    if device is None:
        from scale_letkf_torch.utils.device import require_cuda
        device = require_cuda()
    fitted, stats = fit(device=device)
    with open(out_path, "w") as f:
        json.dump({**fitted, "stats": stats}, f, indent=1)
    print(f"H08 band-model calibration vs {stats['reference']}")
    print(f"  overall BT RMSE: {stats['bt_rmse_before_K']} K -> "
          f"{stats['bt_rmse_after_K']} K")
    for b, r0, r1 in zip(BANDS, stats["per_band_rmse_before_K"],
                         stats["per_band_rmse_after_K"]):
        print(f"  {b}: {r0:7.3f} K -> {r1:7.3f} K")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="scale_letkf_torch.obs.h08_calibrate")
    ap.add_argument("out", help="output JSON path")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (fails without a GPU) or 'cpu'")
    a = ap.parse_args()
    main(a.out, None if a.device == "cuda" else torch.device(a.device))
