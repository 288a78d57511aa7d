"""The regional forecast's inputs, made from the run's seed: the
topography, the Davies boundary data and the ensemble, with the vapour
capped below saturation outside the cloud systems every member holds.

Frozen copies of the program's synthetic generators, as inputs.py's are
(each names its original); the sub-seed streams continue inputs.py's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs as I
from benchmark.reference import model as M
from benchmark.reference import regional as RG
from benchmark.reference import suite as S


def topography(seed: int, ny: int, nx: int, amp: float, n_hills: int,
               taper: int) -> np.ndarray:
    """Smooth orography (ny, nx) float32: n_hills Gaussian hills of random
    centres, widths 3-11% of nx and heights up to amp [m], tapered to zero
    over `taper` cells at the lateral edges. Copied from
    scale_letkf_torch/synthetic.py synthetic_topo, drawn from the seed."""
    rng = np.random.default_rng(I.sub_seed(seed, 8))
    j, i = np.mgrid[0:ny, 0:nx]
    topo = np.zeros((ny, nx), np.float32)
    for _ in range(n_hills):
        cx = nx * rng.random()
        cy = ny * rng.random()
        sx = nx * (0.03 + 0.08 * rng.random())
        h = amp * rng.random()
        topo += h * np.exp(-(((i - cx) / sx) ** 2 + ((j - cy) / sx) ** 2))
    tx = np.minimum(i, nx - 1 - i) / taper
    ty = np.minimum(j, ny - 1 - j) / taper
    return (topo * np.clip(np.minimum(tx, ty), 0.0, 1.0)).astype(np.float32)


def base_saturation(dom: dict) -> tuple[np.ndarray, np.ndarray]:
    """The base column's temperature [K] and saturation mixing ratio (over
    ice below 0 °C), float64."""
    cz, _ = M.stretched_levels(dom["nz"], dom.get("dz", 500.0),
                               dom.get("dz_stretch", 1.0))
    _, p1d = M.hydrostatic_column(M.theta_profile(cz), cz)
    t = torch.as_tensor(M.theta_profile(cz) * (p1d / M.PRE00)
                        ** (M.RD / M.CPDRY))
    p = torch.as_tensor(p1d)
    sat = torch.where(t < M.T00, S.qsat(t, p, True), S.qsat(t, p, False))
    return t.numpy(), sat.numpy()


def capped_columns(dom: dict, rh_max: float):
    """Float32 (θ, ρ, qv) base columns with qv at most rh_max of the base
    column's saturation (over ice below 0 °C). Copied from
    scale_letkf_torch/synthetic.py base_columns (rh_max)."""
    cz, _ = M.stretched_levels(dom["nz"], dom.get("dz", 500.0),
                               dom.get("dz_stretch", 1.0))
    theta, rho1d, _ = I.base_columns(cz, dom)
    _, sat = base_saturation(dom)
    qv = dom.get("qv_surface", 0.0) * np.exp(
        -cz / dom.get("qv_scale_height", 3000.0))
    return theta, rho1d, np.minimum(qv, rh_max * sat).astype(np.float32)


# each condensate class's share of a cloud system's `q`: qc, qr liquid,
# qi, qs, qg ice
CONDENSATE = (1.0, 1.0, 0.5, 1.0, 0.5)
ICE = (False, False, True, True, True)


def add_clouds(e: M.State, seed: int, dom: dict, device, rh_max: float,
               systems: int, width_cells: float, jitter_cells: float,
               z_m: float, depth_m: float, rh: float, q: float) -> None:
    """Cloud systems in every member, in place: `systems` Gaussian patches
    of half-width ~width_cells at centres drawn from the seed in the
    domain's middle 60%, each member's centre moved by up to jitter_cells,
    their sum capped at 1 (h); a vertical profile v, Gaussian about z_m of
    scale depth_m. Where h·v is 1 the vapour is rh of saturation (from the
    capped column's), and each condensate class holds
    q·CONDENSATE·h·v, liquid classes above 0 °C and ice classes below
    -10 °C, shared linearly between."""
    nz, ny, nx = dom["nz"], dom["ny"], dom["nx"]
    K = e.rho.shape[0]
    rng = np.random.default_rng(I.sub_seed(seed, 11))
    cy = ny * (0.2 + 0.6 * rng.random(systems))
    cx = nx * (0.2 + 0.6 * rng.random(systems))
    sig = width_cells * (0.7 + 0.6 * rng.random(systems))
    dy = jitter_cells * (2.0 * rng.random((K, systems)) - 1.0)
    dx = jitter_cells * (2.0 * rng.random((K, systems)) - 1.0)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    j = dev(np.arange(ny))[None, :, None]
    i = dev(np.arange(nx))[None, None, :]
    h = torch.zeros((K, ny, nx), dtype=torch.float32, device=device)
    for n in range(systems):
        yc = dev(cy[n] + dy[:, n])[:, None, None]
        xc = dev(cx[n] + dx[:, n])[:, None, None]
        h += torch.exp(-(((j - yc) / sig[n]) ** 2
                         + ((i - xc) / sig[n]) ** 2))
    h.clamp_(max=1.0)
    cz, _ = M.stretched_levels(nz, dom.get("dz", 500.0),
                               dom.get("dz_stretch", 1.0))
    v = np.exp(-(((cz - z_m) / depth_m) ** 2))
    t, sat = base_saturation(dom)
    ice = np.clip((M.T00 - t) / 10.0, 0.0, 1.0)
    _, _, qv = capped_columns(dom, rh_max)
    hv = h[:, None] * dev(v)[:, None, None]                # (K, nz, ny, nx)
    rho = e.rho
    e.rhoq[:, 0] = rho * (dev(qv)[:, None, None]
                          + dev(rh * sat - qv)[:, None, None] * hv)
    for c, (share, is_ice) in enumerate(zip(CONDENSATE, ICE), start=1):
        phase = ice if is_ice else 1.0 - ice
        e.rhoq[:, c] = rho * dev(q * share * phase)[:, None, None] * hv
    del hv


def ensemble(seed: int, K: int, dom: dict, device, u0: float,
             amp_theta: float, rh_max: float, cloud: dict | None = None
             ) -> M.State:
    """inputs.ens_dycore's K members with their vapour capped at rh_max
    of saturation (scale_letkf_torch/synthetic.py
    synthetic_ens_dycore_device with rh_max), and with `cloud` (add_clouds'
    keywords) the cloud systems."""
    e = I.ens_dycore(seed, K, dom, device, u0=u0, amp_theta=amp_theta)
    _, rho1d, qv = capped_columns(dom, rh_max)
    e.rhoq[:, 0] = torch.as_tensor((qv * rho1d)[:, None, None],
                                   device=device)
    if cloud:
        add_clouds(e, seed, dom, device, rh_max, **cloud)
    return e


def boundary(seed: int, dom: dict, device, u0: float, amp_u: float,
             amp_theta: float, rh_max: float, seconds: float
             ) -> RG.Boundary:
    """Boundary data shared by every member: two states `seconds` apart,
    each the capped base column with the wind u0 and smooth perturbations
    of both wind components (amp_u [m/s]) and θ (amp_theta [K]): noise
    from the seed with two 1-2-1 passes along x and y."""
    nz, ny, nx = dom["nz"], dom["ny"], dom["nx"]
    theta, rho1d, qv = capped_columns(dom, rh_max)

    def col(prof):
        return torch.as_tensor(np.asarray(prof, np.float32)[:, None, None],
                               device=device)

    states = []
    for stream in (9, 10):
        gen = torch.Generator(device=device)
        gen.manual_seed(I.sub_seed(seed, stream))
        noise = torch.randn((3, nz, ny, nx), generator=gen,
                            dtype=torch.float32, device=device)
        for dim in (-1, -2):
            for _ in range(2):
                noise = 0.5 * noise + 0.25 * (torch.roll(noise, 1, dim)
                                              + torch.roll(noise, -1, dim))
        rho = col(rho1d).expand(nz, ny, nx).contiguous()
        rhoq = torch.zeros((M.NQ, nz, ny, nx), dtype=torch.float32,
                           device=device)
        rhoq[0] = col(qv * rho1d)
        states.append(M.State(
            rho=rho, rhou=rho * (u0 + amp_u * noise[0]),
            rhov=rho * (amp_u * noise[1]),
            rhow=torch.zeros((nz + 1, ny, nx), dtype=torch.float32,
                             device=device),
            rhot=rho * (col(theta) + amp_theta * noise[2]), rhoq=rhoq))
        del noise
    return RG.Boundary(states[0], states[1], 0.0, float(seconds))
