"""Synthetic ensembles and observation networks for the benches, the tests
and the smoke run.

The numpy helpers are copies of the reference's full-size bench generators
(scale_letkf_tpu/bench_fullsize.py _smooth_noise, _synthetic_gues,
_host_profiles, _synthetic_ens_dycore, _synthetic_conv_network,
_synthetic_topo), so both packages can be fed the same numbers;
`synthetic_h08_network` lays out a thinned Himawari-8 network in the
reference's file layout (one record per profile and band).
`synthetic_gues_device` and `synthetic_ens_dycore_device` build the same
kinds of ensemble (analysis variables; the forecast's staggered restart
state) on a device from a seeded torch.Generator: a full-size ensemble
(13.7 GB at 18 km, K = 50) never crosses the host link and skips hundreds
of host smoothing passes. `synthetic_resident_gues` builds the reference
bench's device-resident ensemble (float32 mean, bfloat16 deviations).
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.constants import CVDRY, GRAV, PRE00, RD, T00
from scale_letkf_torch.obs.types import (
    ID_H08IR, ID_PS, ID_Q, ID_T, ID_U, ID_V, OBTYPE_NAMES, Observations,
)
from scale_letkf_torch.model.boundary import BoundaryData
from scale_letkf_torch.model.dycore import DycoreState, hydrostatic_reference
from scale_letkf_torch.model.ideal import CPDRY, standard_theta_profile
from scale_letkf_torch.model.microphysics6 import qsat
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


def base_columns(grid, dom: dict, rh_max: float | None = None):
    """Float32 (θ, ρ, p, qv) base columns of the grid (the reference bench's
    _host_profiles): the standard θ profile, its hydrostatic density and
    pressure, and the [domain] qv profile (qv_surface, qv_scale_height; zero
    without qv_surface). rh_max caps qv at that fraction of saturation of
    the base column (over ice below 0 °C): the exponential profile is
    supersaturated over ice in the upper troposphere of a deep domain,
    where the physics suite's first step would deposit it as ice cloud."""
    cz = np.asarray(grid.cz)
    dz0 = float(np.asarray(grid.fz)[1] - np.asarray(grid.fz)[0])
    theta = standard_theta_profile(grid.nz, dz0, cz=cz)
    rho1d, p1d = hydrostatic_reference(theta, dz0, cz=cz)
    qv0 = dom.get("qv_surface", 0.0)
    qv = (qv0 * np.exp(-cz / dom.get("qv_scale_height", 3000.0))
          if qv0 > 0 else np.zeros(grid.nz))
    if rh_max is not None:
        t = torch.as_tensor(theta * (p1d / PRE00) ** (RD / (RD + CVDRY)))
        p = torch.as_tensor(p1d)
        sat = torch.where(t < T00, qsat(t, p, True), qsat(t, p, False))
        qv = np.minimum(qv, rh_max * sat.numpy())
    return (theta.astype(np.float32), rho1d.astype(np.float32),
            p1d.astype(np.float32), qv.astype(np.float32))


def base_boundary(grid, dom: dict, device: torch.device,
                  rh_max: float | None = None) -> BoundaryData:
    """The Davies target of the balanced base state, held for all time: the
    base columns broadcast to one member's 3-D fields, at rest, with the
    [domain] qv profile — the reference bench's stand-in for a parent-model
    boundary file (scale_letkf_tpu/bench_fullsize.py _make_fullsize_driver,
    BoundaryData(base, base, 0, 1e9)). The fields are expanded views of the
    columns; rh_max caps qv as base_columns does."""
    theta, rho1d, _, qv = base_columns(grid, dom, rh_max)
    nz, ny, nx = grid.nz, grid.ny, grid.nx

    def col(prof):
        return torch.as_tensor(prof[:, None, None],
                               device=device).expand(nz, ny, nx)

    zeros = torch.zeros((), device=device)
    rhoq = torch.zeros((NQ, nz, 1, 1), device=device)
    rhoq[0] = torch.as_tensor((qv * rho1d)[:, None, None], device=device)
    base = DycoreState(rho=col(rho1d), rhou=zeros.expand(nz, ny, nx),
                       rhov=zeros.expand(nz, ny, nx),
                       rhow=zeros.expand(nz + 1, ny, nx),
                       rhot=col(rho1d * theta),
                       rhoq=rhoq.expand(NQ, nz, ny, nx))
    return BoundaryData(state0=base, state1=base, t0=0.0, t1=1.0e9)


def synthetic_ens_dycore_device(seed: int, K: int, grid, dom: dict,
                                device: torch.device, u0: float = 0.0,
                                amp_theta: float = 0.5,
                                smooth_passes: int = 1,
                                qr_blob: float = 0.0,
                                rh_max: float | None = None):
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
    correlated over the obs spacing and across levels.

    qr_blob > 0 adds per-member rain and cloud blobs (the reference bench's
    construction): a 3-D Gaussian of widths 0.12·nx, 0.12·ny and 0.2·nz
    levels, centered at a random point of the middle 30% of the domain at
    0.3·nz, with peak qr_blob [kg/kg] of rain and half that of cloud water,
    so the radar operator sees echoes and the microphysics hydrometeors.

    rh_max caps the qv profile at that fraction of the base column's
    saturation (base_columns)."""
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    theta, rho1d, _, qv = base_columns(grid, dom, rh_max)
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
    ens = DycoreState(
        rho=rho, rhou=rho * u0, rhov=torch.zeros_like(rho),
        rhow=torch.zeros((K, nz + 1, ny, nx), dtype=torch.float32,
                         device=device),
        rhot=rhot, rhoq=rhoq)
    return ens, col(rho1d), torch.as_tensor(reference_pressure(theta, rho1d),
                                           device=device)


def reference_pressure(theta: np.ndarray, rho1d: np.ndarray) -> np.ndarray:
    """(nz, 1, 1) float32 reference pressure of the base columns: the
    equation of state of ρθ."""
    p_ref = PRE00 * (rho1d * theta * RD / PRE00) ** (CPDRY / CVDRY)
    return p_ref.astype(np.float32).reshape(-1, 1, 1)


def synthetic_ens_dycore(rng: np.random.Generator, K: int, grid, dom: dict,
                         amp_theta: float = 0.5, qr_blob: float = 0.0):
    """A K-member restart ensemble in host numpy arrays around the balanced
    base state (the reference bench's _synthetic_ens_dycore, the same
    numbers from the same generator): ρθ perturbed by amp_theta [K]·(one
    1-2-1 pass of noise) tapered to zero over 8 cells at the lateral edges
    (the reference's init_perturb.py recipe), the [domain] qv profile in
    ρq[0], and with qr_blob > 0 a rain blob (and half as much cloud water)
    per member for the radar operator. Returns (DycoreState of numpy arrays,
    K leading; rho_ref, p_ref (nz, 1, 1))."""
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    theta, rho1d, _, qv = base_columns(grid, dom)
    tx = np.minimum(np.arange(nx), nx - 1 - np.arange(nx))
    ty = np.minimum(np.arange(ny), ny - 1 - np.arange(ny))
    taper = (np.minimum(1.0, tx / 8.0)[None, :]
             * np.minimum(1.0, ty / 8.0)[:, None]).astype(np.float32)

    rho = np.broadcast_to(rho1d[:, None, None], (nz, ny, nx))
    s = DycoreState(
        rho=np.empty((K, nz, ny, nx), np.float32),
        rhou=np.zeros((K, nz, ny, nx), np.float32),
        rhov=np.zeros((K, nz, ny, nx), np.float32),
        rhow=np.zeros((K, nz + 1, ny, nx), np.float32),
        rhot=np.empty((K, nz, ny, nx), np.float32),
        rhoq=np.zeros((K, NQ, nz, ny, nx), np.float32))
    base_rhot = (rho1d * theta)[:, None, None]
    qv_rho = (qv * rho1d)[:, None, None]
    k, j, i = np.mgrid[0:nz, 0:ny, 0:nx]
    for m in range(K):
        s.rho[m] = rho
        dtheta = amp_theta * smooth_noise(rng, (nz, ny, nx), passes=1)
        s.rhot[m] = base_rhot + rho * dtheta * taper[None]
        s.rhoq[m, 0] = qv_rho
        if qr_blob > 0:
            cx = nx * (0.35 + 0.3 * rng.random())
            cy = ny * (0.35 + 0.3 * rng.random())
            blob = np.exp(-(((i - cx) / (0.12 * nx)) ** 2
                            + ((j - cy) / (0.12 * ny)) ** 2
                            + ((k - 0.3 * nz) / (0.2 * nz)) ** 2)
                          ).astype(np.float32)
            s.rhoq[m, 2] += qr_blob * blob * rho
            s.rhoq[m, 1] += 0.5 * qr_blob * blob * rho
    return s, rho1d.reshape(nz, 1, 1), reference_pressure(theta, rho1d)


def synthetic_resident_gues(seed: int, K: int, grid, batch: int = 10,
                            t_offset: float = 0.0, smooth_strides=(1,), *,
                            device: torch.device, noise=None):
    """A K-member analysis-variable ensemble made on `device` in the resident
    layout (da/resident.py ResidentEnsemble: float32 mean, bfloat16
    deviations from the reference profile), the reference bench's
    _synthetic_resident_gues: a hydrostatically consistent base (the
    standard θ profile, its hydrostatic p, T = θ·(p/p00)^(R/cp), T shifted by
    t_offset), U 5 m/s, qv 1e-3, plus smoothed noise at each variable's
    amplitude, moisture floored at |q| + 1e-3. The noise of each member
    batch is 1-2-1 smoothed, two passes along x and y at every stride of
    smooth_strides; for any other strides than (1,) (synoptic-scale
    perturbations that a K ~ 50 ensemble can span, for an OSSE) also two
    vertical passes, then renormalized by its horizontal standard deviation
    floored at 0.5. Batches of `batch` members (fewer when a batch's float32
    temporaries would pass ~0.6 GB) are written into the deviation buffer in
    place; the mean sums the members in member order.

    noise: None draws each batch from a torch.Generator seeded with `seed`
    (the reference draws from jax.random: other numbers); else a callable
    (i0, shape) → the float32 noise of the batch starting at member i0, so a
    caller can feed both packages the same numbers."""
    from scale_letkf_torch.da.bigcycle import batch_of
    from scale_letkf_torch.da.resident import ResidentEnsemble
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    cz = np.asarray(grid.cz)
    dz0 = float(np.asarray(grid.fz)[1] - np.asarray(grid.fz)[0])
    theta_p = np.asarray(standard_theta_profile(nz, dz0, cz=cz), np.float32)
    _, p_prof = (np.asarray(a, np.float32)
                 for a in hydrostatic_reference(theta_p, dz0, cz=cz))
    t_prof = theta_p * (p_prof / 1.0e5) ** (RD / CPDRY)
    prof = np.zeros((NV3D, nz), np.float32)
    prof[IA_T] = t_prof + t_offset
    prof[IA_P] = p_prof
    prof[IA_U] = 5.0
    prof[IA_Q0] = 1e-3
    amp = np.full(NV3D, 0.5, np.float32)
    amp[[IA_U, IA_V]] = 1.0
    amp[IA_W] = 0.1
    amp[IA_T] = 0.5
    amp[IA_P] = 50.0
    amp[IA_Q0:] = 1e-4
    prof_d = torch.as_tensor(prof, device=device)[:, :, None, None]
    amp_d = torch.as_tensor(amp, device=device)[:, None, None, None]

    field_elems = NV3D * nz * ny * nx
    b = batch_of(K, max(1, min(batch, int(150e6 // field_elems))))
    shape = (b, NV3D, nz, ny, nx)
    gen = None
    if noise is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dev = torch.empty((K, NV3D, nz, ny, nx), dtype=torch.bfloat16,
                      device=device)
    accum = torch.zeros((NV3D, nz, ny, nx), dtype=torch.float32,
                        device=device)
    for i0 in range(0, K, b):
        x = (torch.randn(shape, generator=gen, dtype=torch.float32,
                         device=device) if noise is None else
             torch.as_tensor(noise(i0, shape), dtype=torch.float32,
                             device=device))
        for st in smooth_strides:
            for dim in (-1, -2):
                for _ in range(2):
                    x = 0.5 * x + 0.25 * (torch.roll(x, st, dim)
                                          + torch.roll(x, -st, dim))
        if tuple(smooth_strides) != (1,):
            for _ in range(2):
                x = 0.5 * x + 0.25 * (torch.roll(x, 1, -3)
                                      + torch.roll(x, -1, -3))
            std = torch.std(x, dim=(-1, -2), keepdim=True, correction=0)
            x = x / torch.clamp(std, min=0.5)
        members = x.mul_(amp_d).add_(prof_d)
        members[:, IA_Q0].abs_().add_(1e-3)
        dev[i0:i0 + b] = (members - prof_d).to(torch.bfloat16)
        for m in members:
            accum += m
        del x, members
    return ResidentEnsemble(accum.div_(K), dev,
                            ref=prof_d.expand(NV3D, nz, ny, nx))


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


def synthetic_topo(rng: np.random.Generator, ny: int, nx: int,
                   amp: float = 400.0, n_hills: int = 12) -> np.ndarray:
    """Smooth synthetic orography (ny, nx) float32: n_hills Gaussian hills
    of random centers, widths 3-11% of nx and heights up to amp [m], tapered
    to zero over 12 cells at the lateral edges (the boundary buffer) — the
    reference bench's stand-in for the scale-rm_pp_ens topography, which
    its production driver draws with default_rng(7)."""
    j, i = np.mgrid[0:ny, 0:nx]
    topo = np.zeros((ny, nx), np.float32)
    for _ in range(n_hills):
        cx = nx * rng.random()
        cy = ny * rng.random()
        sx = nx * (0.03 + 0.08 * rng.random())
        h = amp * rng.random()
        topo += h * np.exp(-(((i - cx) / sx) ** 2 + ((j - cy) / sx) ** 2))
    tx = np.minimum(i, nx - 1 - i) / 12.0
    ty = np.minimum(j, ny - 1 - j) / 12.0
    return (topo * np.clip(np.minimum(tx, ty), 0.0, 1.0)).astype(
        np.float32)


def synthetic_h08_network(cfg, grid, spacing: int = 8,
                          margin: int = 10) -> Observations:
    """A thinned Himawari-8 AHI network: one profile of all ten bands
    (B07..B16, the band number in lev, as read_obs_h08 stores it) at every
    `spacing`-th cell center in x and y, `margin` cells or more inside the
    domain's edge; report type H08IRB, the per-band OBSERR_H08 errors, dat
    a placeholder BT of 250 K (obsmake gives the values)."""
    from scale_letkf_torch.obs.h08 import NCHAN
    lon2d, lat2d = grid.lonlat
    jj, ii = np.meshgrid(np.arange(margin, grid.ny - margin, spacing),
                         np.arange(margin, grid.nx - margin, spacing),
                         indexing="ij")
    n = jj.size * NCHAN
    band = np.arange(1, NCHAN + 1)
    return Observations(
        elem=np.full(n, ID_H08IR, np.int32),
        lon=np.repeat(lon2d[jj, ii].ravel(), NCHAN),
        lat=np.repeat(lat2d[jj, ii].ravel(), NCHAN),
        lev=np.tile(band + 6.0, jj.size), dat=np.full(n, 250.0),
        err=np.tile(np.asarray(cfg.obs_error.h08, np.float64)[band - 1],
                    jj.size),
        typ=np.full(n, OBTYPE_NAMES.index("H08IRB"), np.int32),
        dif=np.zeros(n))


def synthetic_radar_volume(cfg, dom: dict, rng: np.random.Generator,
                           n_obs_target: int = 1_000_000) -> Observations:
    """A synthetic phased-array radar volume (the reference bench's
    _synthetic_radar_volume): 120 azimuths × 55 elevations (1–25°) × range
    gates from 2 to 58 km around the [domain] radar, the gates below 15 km
    height, each a reflectivity and a Doppler-velocity obs (n_obs_target
    1e6 gives ~888k obs). dat holds plausible linear-Z and velocity noise;
    obs_from_truth overwrites it with H(nature)."""
    from scale_letkf_torch.obs.types import (
        ID_RADAR_REF, ID_RADAR_VR, TYP_PHARAD,
    )
    radar_lon = dom.get("radar_lon", 135.5)
    radar_lat = dom.get("radar_lat", 34.8)
    n_az, n_el = 120, 55
    n_gate = max(1, n_obs_target // (n_az * n_el * 2))
    az = np.linspace(0, 360, n_az, endpoint=False)
    el = np.linspace(1.0, 25.0, n_el)
    r = np.linspace(2e3, 58e3, n_gate)
    azg, elg, rg = np.meshgrid(az, el, r, indexing="ij")
    azr = np.deg2rad(azg).ravel()
    elr = np.deg2rad(elg).ravel()
    rr = rg.ravel()
    gx = rr * np.cos(elr) * np.sin(azr)
    gy = rr * np.cos(elr) * np.cos(azr)
    gz = dom.get("radar_z", 80.0) + rr * np.sin(elr)
    # metres per degree about the radar: enough for a synthetic volume
    lon = radar_lon + gx / (111e3 * np.cos(np.deg2rad(radar_lat)))
    lat = radar_lat + gy / 111e3
    keep = gz < 15e3
    n2 = int(keep.sum())
    elem = np.empty(2 * n2, np.int32)
    elem[0::2] = ID_RADAR_REF
    elem[1::2] = ID_RADAR_VR

    def dup(a):
        return np.repeat(a[keep], 2)

    dat = np.empty(2 * n2)
    dat[0::2] = 10.0 ** (np.clip(
        20.0 + 15.0 * smooth_noise(rng, (n2,), 0), 5.0, 55.0) / 10.0)
    dat[1::2] = 5.0 * rng.standard_normal(n2)
    err = np.where(elem == ID_RADAR_REF, cfg.obs_error.radar_ref,
                   cfg.obs_error.radar_vr)
    return Observations(
        elem=elem, lon=dup(lon), lat=dup(lat), lev=dup(gz), dat=dat,
        err=err, typ=np.full(2 * n2, TYP_PHARAD, np.int32),
        dif=np.zeros(2 * n2),
        meta=np.asarray([radar_lon, radar_lat, dom.get("radar_z", 80.0)]))


def obs_from_truth(sc, truth_1, obs: Observations, nsteps: int,
                   rng: np.random.Generator, radar: bool = False,
                   cfg=None) -> Observations:
    """obs with their values H(nature) plus noise at the obs error (the
    reference bench's _obs_from_truth): truth_1, a one-member DycoreState of
    host arrays, goes through a one-member StreamedCycle on sc's driver (its
    own executor, so the nature run's slab does not seed the ensemble's),
    each obs against the nature state at its slot. Obs whose operator QC
    failed are dropped; with `radar`, reflectivity returns to the files'
    linear Z and the gates below the echo floor (QC_REF_LOW) become weak
    echoes at half of cfg.radar.min_radar_ref."""
    from scale_letkf_torch.da.bigcycle import StreamedCycle
    from scale_letkf_torch.obs.types import ID_RADAR_REF, QC_GOOD, QC_REF_LOW
    one = StreamedCycle(sc.d, member_batch=1, tile_rows=sc.tile_rows,
                        verbose=sc.verbose)
    _, y, qc, _ = one.forecast_and_hx(truth_1, nsteps, obs)
    y = y[0]
    keep = (qc == QC_GOOD) | (radar & (qc == QC_REF_LOW))
    obs = obs.select(keep)
    yk = y[keep] + rng.standard_normal(int(keep.sum())) * obs.err
    if radar:
        m = obs.elem == ID_RADAR_REF
        yk[m] = 10.0 ** (yk[m] / 10.0)          # dBZ → linear Z
        low = m & (qc[keep] == QC_REF_LOW)
        yk[low] = 0.5 * cfg.radar.min_radar_ref
    obs.dat = yk
    return obs
