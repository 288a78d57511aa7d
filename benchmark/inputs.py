"""The benchmark's inputs, made from the run's seed: the ensemble on the
device, the radar volume's geometry on the host (its values come from the
reference's operator).

Each generator is a frozen copy of one in the program's synthetic inputs,
so the numbers do not move when the program changes; the copies name
their originals. Sub-seeds come from numpy's SeedSequence of (seed,
stream), so every seed up to 2**64 works and the streams are independent.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference import obsop as O


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed of (seed, stream), for torch.Generator and numpy."""
    ss = np.random.SeedSequence([int(seed), *[int(s) for s in stream]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def base_columns(cz: np.ndarray, dom: dict):
    """Float32 (θ, ρ, qv) base columns. Copied from
    scale_letkf_torch/synthetic.py base_columns (without rh_max)."""
    theta = M.theta_profile(cz)
    rho1d, _ = M.hydrostatic_column(theta, cz)
    qv0 = dom.get("qv_surface", 0.0)
    qv = (qv0 * np.exp(-cz / dom.get("qv_scale_height", 3000.0))
          if qv0 > 0 else np.zeros(len(cz)))
    return theta.astype(np.float32), rho1d.astype(np.float32), qv.astype(
        np.float32)


def ens_dycore(seed: int, K: int, dom: dict, device, u0: float = 0.0,
               amp_theta: float = 0.5, qr_blob: float = 0.0,
               stream: int = 1) -> M.State:
    """A K-member restart ensemble: the hydrostatic base column, ρθ
    perturbed by amp_theta·(one 1-2-1 pass of noise) tapered over 8 edge
    cells, the qv profile, a uniform wind u0 and, with qr_blob, a rain and
    cloud blob per member. Copied from scale_letkf_torch/synthetic.py
    synthetic_ens_dycore_device (smooth_passes 1, rh_max None)."""
    nz, ny, nx = dom["nz"], dom["ny"], dom["nx"]
    cz, _ = M.stretched_levels(nz, dom.get("dz", 500.0),
                               dom.get("dz_stretch", 1.0))
    theta, rho1d, qv = base_columns(cz, dom)
    tx = np.minimum(np.arange(nx), nx - 1 - np.arange(nx))
    ty = np.minimum(np.arange(ny), ny - 1 - np.arange(ny))
    taper = (np.minimum(1.0, tx / 8.0)[None, :]
             * np.minimum(1.0, ty / 8.0)[:, None]).astype(np.float32)

    def col(prof):
        return torch.as_tensor(np.asarray(prof, np.float32)[:, None, None],
                               device=device)

    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, stream))
    shape = (K, nz, ny, nx)
    rho = col(rho1d).expand(shape).contiguous()
    noise = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
    for dim in (-1, -2):
        noise = 0.5 * noise + 0.25 * (torch.roll(noise, 1, dim)
                                      + torch.roll(noise, -1, dim))
    noise.mul_(torch.as_tensor(taper, device=device)).mul_(amp_theta)
    rhot = noise.mul_(rho).add_(col(rho1d * theta))
    rhoq = torch.zeros((K, M.NQ, nz, ny, nx), dtype=torch.float32,
                       device=device)
    rhoq[:, 0] = col(qv * rho1d)
    if qr_blob > 0:
        c = 0.35 + 0.3 * torch.rand((K, 2, 1, 1, 1), generator=gen,
                                    device=device)
        k, j, i = (torch.arange(n, dtype=torch.float32, device=device)
                   for n in (nz, ny, nx))
        blob = torch.exp(-(((i - nx * c[:, 0]) / (0.12 * nx)) ** 2
                           + ((j[:, None] - ny * c[:, 1]) / (0.12 * ny)) ** 2
                           + ((k[:, None, None] - 0.3 * nz) / (0.2 * nz))
                           ** 2)) * (qr_blob * rho)
        rhoq[:, 2] += blob
        rhoq[:, 1] += 0.5 * blob
        del blob
    return M.State(rho=rho, rhou=rho * u0, rhov=torch.zeros_like(rho),
                   rhow=torch.zeros((K, nz + 1, ny, nx), dtype=torch.float32,
                                    device=device),
                   rhot=rhot, rhoq=rhoq)


def radar_volume(dom: dict, obs_error: dict, n_obs_target: int) -> dict:
    """A phased-array radar volume about the [domain] radar: 120 azimuths ×
    55 elevations (1–25°) × range gates from 2 to 58 km, the gates below 15
    km, each a reflectivity and a Doppler-velocity obs. Copied from
    scale_letkf_torch/synthetic.py synthetic_radar_volume (its placeholder
    values left out: the values come from the reference's operator)."""
    rlon, rlat = dom.get("radar_lon", 135.5), dom.get("radar_lat", 34.8)
    rz = dom.get("radar_z", 80.0)
    n_az, n_el = 120, 55
    n_gate = max(1, n_obs_target // (n_az * n_el * 2))
    azg, elg, rg = np.meshgrid(np.linspace(0, 360, n_az, endpoint=False),
                               np.linspace(1.0, 25.0, n_el),
                               np.linspace(2e3, 58e3, n_gate), indexing="ij")
    azr, elr, rr = np.deg2rad(azg).ravel(), np.deg2rad(elg).ravel(), rg.ravel()
    gx = rr * np.cos(elr) * np.sin(azr)
    gy = rr * np.cos(elr) * np.cos(azr)
    gz = rz + rr * np.sin(elr)
    lon = rlon + gx / (111e3 * np.cos(np.deg2rad(rlat)))
    lat = rlat + gy / 111e3
    keep = gz < 15e3
    n2 = int(keep.sum())
    elem = np.empty(2 * n2, np.int32)
    elem[0::2] = O.ID_RADAR_REF
    elem[1::2] = O.ID_RADAR_VR
    err = np.where(elem == O.ID_RADAR_REF, obs_error.get("radar_ref", 5.0),
                   obs_error.get("radar_vr", 3.0))
    return {"elem": elem, "lon": np.repeat(lon[keep], 2),
            "lat": np.repeat(lat[keep], 2), "lev": np.repeat(gz[keep], 2),
            "err": err.astype(np.float64),
            "typ": np.full(2 * n2, O.TYP_PHARAD, np.int32),
            "meta": np.asarray([rlon, rlat, rz])}
