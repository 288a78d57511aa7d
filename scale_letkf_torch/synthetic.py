"""Synthetic ensembles and observation networks for tests and the smoke run.

The numpy helpers are copies of the reference's full-size bench generators
(scale_letkf_tpu/bench_fullsize.py _smooth_noise, _synthetic_gues,
_synthetic_conv_network), so both packages can be fed the same numbers.
`synthetic_gues_device` and `synthetic_ens_dycore_device` build the same
kinds of ensemble (analysis variables; the forecast's staggered restart
state) on a device from a seeded torch.Generator: a full-size ensemble
(13.7 GB at 18 km, K = 50) never crosses the host link and skips hundreds
of host smoothing passes.
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.constants import CVDRY, GRAV, PRE00, RD
from scale_letkf_torch.obs.types import Observations, ID_U, ID_V, ID_T, ID_Q, ID_PS
from scale_letkf_torch.model.dycore import DycoreState, hydrostatic_reference
from scale_letkf_torch.model.ideal import standard_theta_profile
from scale_letkf_torch.state import (
    NQ, NV3D, IA_U, IA_V, IA_W, IA_T, IA_P, IA_Q0,
)

_BASE = {IA_U: 5.0, IA_V: 0.0, IA_W: 0.0}
_AMP = {IA_U: 1.0, IA_V: 1.0, IA_W: 0.1, IA_T: 0.5, IA_P: 50.0}


def _profiles(cz: np.ndarray):
    """Float32 (T, p) reference profiles: a 6.5 K/km lapse rate and an
    isothermal 280 K scale height."""
    t_prof = (300.0 - 0.0065 * cz).astype(np.float32)
    p_prof = (1.0e5 * np.exp(-GRAV * cz / (RD * 280.0))).astype(np.float32)
    return t_prof, p_prof


def _var_profile(v: int, nz: int, t_prof, p_prof):
    prof = (t_prof if v == IA_T else p_prof if v == IA_P
            else np.full(nz, _BASE.get(v, 0.0), np.float32))
    return prof, _AMP.get(v, 1e-4 if v >= IA_Q0 else 0.5)


def smooth_noise(rng: np.random.Generator, shape, passes: int = 2):
    """Spatially correlated noise (1-2-1 smoothed) for ensemble perts."""
    a = rng.standard_normal(shape).astype(np.float32)
    for ax in (-1, -2):
        for _ in range(passes):
            a = 0.5 * a + 0.25 * (np.roll(a, 1, ax) + np.roll(a, -1, ax))
    return a


def synthetic_gues(rng: np.random.Generator, K: int, nz: int, ny: int,
                   nx: int, cz: np.ndarray) -> np.ndarray:
    """(K, NV3D, nz, ny, nx) float32 analysis-variable ensemble around a
    reference profile, generated var by var to bound host memory."""
    t_prof, p_prof = _profiles(cz)
    out = np.zeros((K, NV3D, nz, ny, nx), np.float32)
    for v in range(NV3D):
        prof, a = _var_profile(v, nz, t_prof, p_prof)
        for m in range(K):
            out[m, v] = prof[:, None, None] + a * smooth_noise(
                rng, (nz, ny, nx))
        if v == IA_Q0:
            out[:, v] = np.abs(out[:, v]) + 1e-3
    return out


def synthetic_gues_device(seed: int, K: int, nz: int, ny: int, nx: int,
                          cz: np.ndarray, device: torch.device) -> torch.Tensor:
    """synthetic_gues's construction on `device`, from a torch.Generator
    seeded with `seed` (the numbers differ from the numpy generator's)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t_prof, p_prof = _profiles(cz)
    out = torch.empty((K, NV3D, nz, ny, nx), dtype=torch.float32,
                      device=device)
    for v in range(NV3D):
        prof, a = _var_profile(v, nz, t_prof, p_prof)
        noise = torch.randn((K, nz, ny, nx), generator=gen,
                            dtype=torch.float32, device=device)
        for ax in (-1, -2):
            for _ in range(2):
                noise = 0.5 * noise + 0.25 * (torch.roll(noise, 1, ax)
                                              + torch.roll(noise, -1, ax))
        prof_t = torch.as_tensor(prof, device=device)[:, None, None]
        field = out[:, v]
        torch.add(prof_t, noise, alpha=a, out=field)
        del noise
        if v == IA_Q0:
            field.abs_().add_(1e-3)
    return out


def synthetic_ens_dycore_device(seed: int, K: int, grid, dom: dict,
                                device: torch.device, u0: float = 0.0,
                                amp_theta: float = 0.5,
                                smooth_passes: int = 1):
    """A K-member restart ensemble of the dynamical core on `device`: the
    reference's bench_fullsize._synthetic_ens_dycore construction from a
    torch.Generator seeded with `seed` — the hydrostatic base column of the
    standard θ profile, ρθ perturbed by amp_theta [K]·(1-2-1 smoothed
    noise) tapered to zero over 8 cells at the lateral edges, and the [domain]
    qv profile (qv_surface, qv_scale_height) in ρq[0]. u0 adds a uniform
    wind, ρu = ρ·u0, so the advection terms are not zero (a uniform wind
    over flat periodic terrain is a steady solution). Returns (DycoreState
    with K leading, rho_ref, p_ref), the columns (nz, 1, 1).

    smooth_passes > 1 smooths the noise by that many 1-2-1 passes along each
    horizontal axis (periodic) and up the column (edges held), a Gaussian
    of sqrt(passes/2) cells, and rescales it to the standard deviation of
    one horizontal pass, so an assimilation cycle sees perturbations
    correlated over the obs spacing and across levels."""
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    cz = np.asarray(grid.cz)
    dz0 = float(np.asarray(grid.fz)[1] - np.asarray(grid.fz)[0])
    theta = standard_theta_profile(nz, dz0, cz=cz)
    rho1d, _ = hydrostatic_reference(theta, dz0, cz=cz)
    theta, rho1d = theta.astype(np.float32), rho1d.astype(np.float32)
    qv0 = dom.get("qv_surface", 0.0)
    qv = (qv0 * np.exp(-cz / dom.get("qv_scale_height", 3000.0))
          if qv0 > 0 else np.zeros(nz)).astype(np.float32)
    p_ref = PRE00 * (rho1d * theta * RD / PRE00) ** ((RD + CVDRY) / CVDRY)
    tx = np.minimum(np.arange(nx), nx - 1 - np.arange(nx))
    ty = np.minimum(np.arange(ny), ny - 1 - np.arange(ny))
    taper = (np.minimum(1.0, tx / 8.0)[None, :]
             * np.minimum(1.0, ty / 8.0)[:, None]).astype(np.float32)

    def col(prof):
        return torch.as_tensor(np.asarray(prof, np.float32)[:, None, None],
                               device=device)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (K, nz, ny, nx)
    rho = col(rho1d).expand(shape).contiguous()
    noise = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
    for dim in (-1, -2):
        for _ in range(smooth_passes):
            noise = 0.5 * noise + 0.25 * (torch.roll(noise, 1, dim)
                                          + torch.roll(noise, -1, dim))
    if smooth_passes > 1:
        for _ in range(smooth_passes):
            up = torch.cat([noise[:, 1:], noise[:, -1:]], dim=1)
            down = torch.cat([noise[:, :1], noise[:, :-1]], dim=1)
            noise = 0.5 * noise + 0.25 * (up + down)
        # one horizontal pass keeps 0.375 of the noise's standard deviation
        noise.mul_(0.375 / float(noise.std()))
    noise.mul_(torch.as_tensor(taper, device=device)).mul_(amp_theta)
    rhot = noise.mul_(rho).add_(col(rho1d * theta))
    rhoq = torch.zeros((K, NQ, nz, ny, nx), dtype=torch.float32,
                       device=device)
    rhoq[:, 0] = col(qv * rho1d)
    ens = DycoreState(
        rho=rho, rhou=rho * u0, rhov=torch.zeros_like(rho),
        rhow=torch.zeros((K, nz + 1, ny, nx), dtype=torch.float32,
                         device=device),
        rhot=rhot, rhoq=rhoq)
    return ens, col(rho1d), col(p_ref)


def synthetic_conv_network(cfg, grid, rng: np.random.Generator,
                           n_sonde: int = 700, n_ps: int = 2000) -> Observations:
    """Synthetic PREPBUFR-style network: n_sonde sondes × 8 levels × 4 vars
    + n_ps surface pressure reports (JMA-era conventional density), dat
    filled with plausible constants."""
    nx, ny = grid.nx, grid.ny
    lon2d, lat2d = grid.lonlat
    si = rng.integers(2, nx - 2, n_sonde)
    sj = rng.integers(2, ny - 2, n_sonde)
    levs = np.asarray([925., 850., 700., 500., 400., 300., 250., 200.]) * 100
    e = cfg.obs_error
    kinds = ((ID_U, e.u), (ID_V, e.v), (ID_T, e.t), (ID_Q, e.q))
    nk, nl = len(kinds), len(levs)
    # sonde records in (sonde, level, variable) order, then the PS reports
    elem = np.concatenate([np.tile([k for k, _ in kinds], n_sonde * nl),
                           np.full(n_ps, ID_PS)]).astype(np.int32)
    err = np.concatenate([np.tile([r for _, r in kinds], n_sonde * nl),
                          np.full(n_ps, e.ps)])
    pi = rng.integers(2, nx - 2, n_ps)
    pj = rng.integers(2, ny - 2, n_ps)
    lon = np.concatenate([np.repeat(lon2d[sj, si], nl * nk), lon2d[pj, pi]])
    lat = np.concatenate([np.repeat(lat2d[sj, si], nl * nk), lat2d[pj, pi]])
    lev = np.concatenate([np.tile(np.repeat(levs, nk), n_sonde),
                          np.zeros(n_ps)])   # PS lev = station elevation [m]
    nobs = len(elem)
    dat = np.where(elem == ID_T, 280.0,
                   np.where(elem == ID_PS, 1000e2,
                            np.where(elem == ID_Q, 5e-3, 5.0))).astype(float)
    return Observations(elem=elem, lon=lon, lat=lat, lev=lev, dat=dat,
                        err=err, typ=np.zeros(nobs, np.int32),
                        dif=np.zeros(nobs))
