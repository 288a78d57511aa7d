"""Plain reference of the physics suite: six-class single-moment
microphysics, gray radiation, the bulk surface layer, the local-K boundary
layer with its implicit column solves, and the slab skin temperature, as
one physics step composes them.

Written from the schemes' equations as the program's configuration states
them, in plain PyTorch in the dtype of the inputs; fields carry a leading
member axis (levels −3, tracers −4 of ρq), surface slabs are (..., ny, nx).

Departures from SCALE-RM (Tomita08 microphysics, MSTRN-X radiation,
Beljaars–Uno surface fluxes, MYNN boundary layer), each noted where it
lies below: `nsw6` is a Lin/Tomita-class scheme with fixed process rates;
`radiation` one gray longwave band and one Beer-law shortwave beam under a
fixed sun; `surface` Louis (1979)'s analytic stability functions; `pbl` a
first-order local K closure; every scheme takes one layer thickness (the
lowest level's on stretched levels), where SCALE-RM's physics reads the
column's own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import model as M
from benchmark.reference.model import (
    CPDRY, FVIRT, GRAV, LHV, PRE00, PSAT0, RD, RV, T00, TETENS_A_LIQ,
    TETENS_B_LIQ, rx, ry, zsl,
)

TETENS_A_ICE = 21.875
TETENS_B_ICE = 7.66
LHS = 2.834e6                 # latent heat of sublimation [J/kg]
LHF = LHS - LHV               # of fusion
SIGMA_SB = 5.670374e-8
KARMAN = 0.4


class Settings(NamedTuple):
    """The suite's settings: the configuration's [physics] table over
    these defaults."""
    mp_scheme: str = "kessler"     # "kessler" | "nsw6" | "none"
    use_pbl: bool = True
    use_radiation: bool = True
    rad_interval: int = 10         # physics steps between radiation calls
    mu0: float = 0.5               # cosine of the solar zenith angle
    albedo: float = 0.2
    eps_sfc: float = 0.98
    z0: float = 1.0e-2             # roughness length, momentum [m]
    z0h: float = 1.0e-3            # roughness length, heat [m]
    beta: float = 1.0              # surface evaporation efficiency
    slab_capacity: float = 0.0     # [J/m²/K]; 0 holds the skin fixed


def settings(table: dict) -> Settings:
    unknown = set(table) - set(Settings._fields)
    if unknown:
        raise ValueError(f"unknown [physics] keys {sorted(unknown)}")
    return Settings(**table)


def qsat(temp, pres, ice: bool):
    """Saturation mixing ratio over liquid or ice (Tetens)."""
    a, b = (TETENS_A_ICE, TETENS_B_ICE) if ice else (TETENS_A_LIQ,
                                                       TETENS_B_LIQ)
    es = PSAT0 * torch.exp(a * (temp - T00) / (temp - b))
    return 0.622 * es / torch.clamp(pres - 0.378 * es, min=1.0)


def temperature(s: M.State, q):
    """(T, p) of the state, q the mixing ratios ρq/ρ."""
    p = M.moist_pressure(s.rhot, q)
    rtot = RD * (1.0 - torch.sum(q, dim=-4)) + RV * q[..., 0, :, :, :]
    return p / (s.rho * rtot), p


def sediment(q, rho, vt, dz, dt: float):
    """Upwind sedimentation: the downward flux ρ q vt, capped at the CFL
    limit 0.9 dz/dt, into each level from the one above."""
    vt = torch.minimum(vt, torch.as_tensor(0.9 * dz / dt, dtype=vt.dtype,
                                           device=vt.device))
    flux = rho * q * vt
    inflow = torch.cat([zsl(flux, 1), torch.zeros_like(zsl(flux, None, 1))],
                       dim=-3)
    return torch.clamp(q + dt * (inflow - flux) / (rho * dz), min=0.0)


# --- microphysics: six classes (qv, qc, qr, qi, qs, qg) --------------------

def _pos(x):
    return torch.clamp(x, min=0.0)


def _lim(rate, avail):
    """A conversion, at most what its source holds."""
    return torch.minimum(_pos(rate), _pos(avail))


def nsw6(s: M.State, dt: float, dz) -> M.State:
    """One step: saturation adjustment (liquid where T ≥ T0, ice below),
    autoconversion and accretion of rain, rain evaporation; below T0
    autoconversion to snow, riming (heavy riming to graupel) and graupel
    collecting cloud and rain; rain freezing below 268.15 K, melting of
    snow and graupel above T0, their sublimation; upwind sedimentation of
    rain, snow and graupel with power-law fall speeds. The latent heat goes
    to ρθ through the Exner function. Departure: Lin (1983) / Tomita (2008)
    magnitudes as fixed rates, not Tomita08's size-distribution integrals."""
    rho = s.rho
    q = s.rhoq / rho.unsqueeze(-4)
    qv, qc, qr, qi, qs, qg = (q[..., i, :, :, :] for i in range(6))
    temp, p = temperature(s, q)
    exner_fac = (PRE00 / p) ** (RD / CPDRY)
    warm = temp >= T00
    cold = ~warm

    qs_liq = qsat(temp, p, False)
    dqsdt = qs_liq * (TETENS_A_LIQ * (T00 - TETENS_B_LIQ)
                      / (temp - TETENS_B_LIQ) ** 2)
    cond = (qv - qs_liq) / (1.0 + (LHV / CPDRY) * dqsdt)
    cond = torch.where(warm, torch.maximum(cond, -qc), 0.0)
    qv = qv - cond
    qc = qc + cond
    heat = (LHV / CPDRY) * exner_fac * cond
    qs_ice = qsat(temp, p, True)
    dqsdt = qs_ice * (TETENS_A_ICE * (T00 - TETENS_B_ICE)
                      / (temp - TETENS_B_ICE) ** 2)
    dep = (qv - qs_ice) / (1.0 + (LHS / CPDRY) * dqsdt)
    dep = torch.where(warm, 0.0, torch.maximum(dep, -qi))
    qv = qv - dep
    qi = qi + dep
    heat = heat + (LHS / CPDRY) * exner_fac * dep

    auto = _lim(1.0e-3 * (qc - 1.0e-3) * dt, qc)
    accr = _lim(2.2 * qc * _pos(qr) ** 0.875 * dt, qc - auto)
    qc = qc - auto - accr
    qr = qr + auto + accr
    evap = _lim(1.0e-3 * _pos(qs_liq - qv) * (rho * _pos(qr)) ** 0.65 * dt,
                qr)
    qv = qv + evap
    qr = qr - evap
    heat = heat - (LHV / CPDRY) * exner_fac * evap

    to_snow = torch.where(cold, _lim(1.0e-3 * (qi - 6.0e-4) * dt, qi), 0.0)
    qi = qi - to_snow
    qs = qs + to_snow
    rime = torch.where(cold, _lim(1.0 * qc * _pos(qs) ** 0.875 * dt, qc), 0.0)
    to_g = torch.where(qs > 1.0e-3, rime, 0.0)
    qc = qc - rime
    qs = qs + (rime - to_g)
    qg = qg + to_g
    heat = heat + (LHF / CPDRY) * exner_fac * rime
    gc = torch.where(cold, _lim(3.0 * qc * _pos(qg) ** 0.875 * dt, qc), 0.0)
    gr = torch.where(cold, _lim(2.0 * _pos(qr) * _pos(qg) ** 0.875 * dt, qr),
                     0.0)
    qc = qc - gc
    qr = qr - gr
    qg = qg + gc + gr
    heat = heat + (LHF / CPDRY) * exner_fac * (gc + gr)
    frz = _lim(1.0e-2 * _pos(268.15 - temp) * qr * dt, qr)
    qr = qr - frz
    qg = qg + frz
    heat = heat + (LHF / CPDRY) * exner_fac * frz
    melt_s = _lim(1.0e-2 * _pos(temp - T00) * qs * dt, qs)
    melt_g = _lim(1.0e-2 * _pos(temp - T00) * qg * dt, qg)
    qs = qs - melt_s
    qg = qg - melt_g
    qr = qr + melt_s + melt_g
    heat = heat - (LHF / CPDRY) * exner_fac * (melt_s + melt_g)
    subsat = _pos(qs_ice - qv)
    subl_s = _lim(1.0e-3 * subsat * (rho * _pos(qs)) ** 0.65 * dt, qs)
    subl_g = _lim(1.0e-3 * subsat * (rho * _pos(qg)) ** 0.65 * dt, qg)
    qs = qs - subl_s
    qg = qg - subl_g
    qv = qv + subl_s + subl_g
    heat = heat - (LHS / CPDRY) * exner_fac * (subl_s + subl_g)

    # fall speeds a (ρq)^b (ρ_top/ρ)^½, the density ratio to the top level
    ratio = torch.sqrt(torch.clamp(zsl(rho, -1) / rho, min=0.1))
    qr = sediment(qr, rho, 36.34 * (rho * _pos(qr)) ** 0.1364 * ratio, dz, dt)
    qs = sediment(qs, rho, 7.0 * (rho * _pos(qs)) ** 0.11 * ratio, dz, dt)
    qg = sediment(qg, rho, 22.0 * (rho * _pos(qg)) ** 0.125 * ratio, dz, dt)
    q = torch.stack([qv, _pos(qc), qr, _pos(qi), qs, qg], dim=-4)
    return s._replace(rhot=s.rhot + rho * heat, rhoq=q * rho.unsqueeze(-4))


# --- radiation ---------------------------------------------------------------

def radiation(s: M.State, dz, st: Settings, tsfc):
    """(ρθ tendency, the surface's radiative input: downward longwave and
    absorbed shortwave). Longwave: one gray band (vapour, liquid, ice and
    the well-mixed gases; diffusivity factor 1.66), the emission of each
    layer carried up from the surface's and down from zero at the top.
    Shortwave: a direct beam from the top at cos ζ = mu0, extinguished by
    vapour, condensate and Rayleigh scattering, and reflected at the
    surface with the albedo. Departure: gray bands, a fixed sun."""
    rho = s.rho
    q = s.rhoq / rho.unsqueeze(-4)
    p = M.moist_pressure(s.rhot, q)
    exner = (p / PRE00) ** (RD / CPDRY)
    temp = (s.rhot / rho) * exner
    qv = q[..., 0, :, :, :]
    q_liq = q[..., 1, :, :, :] + q[..., 2, :, :, :]
    q_ice = q[..., 3, :, :, :] + q[..., 4, :, :, :] + q[..., 5, :, :, :]

    tau = (0.10 * qv + 60.0 * q_liq + 30.0 * q_ice + 2.0e-4) * rho * dz
    trans = torch.exp(-1.66 * tau)
    emis = 1.0 - trans
    b = SIGMA_SB * temp ** 4
    nz = temp.shape[-3]
    up = [st.eps_sfc * SIGMA_SB * tsfc ** 4]
    for k in range(nz):
        up.append(up[-1] * trans[..., k, :, :] + b[..., k, :, :]
                  * emis[..., k, :, :])
    down = [torch.zeros_like(up[0])]
    for k in range(nz - 1, -1, -1):
        down.append(down[-1] * trans[..., k, :, :] + b[..., k, :, :]
                    * emis[..., k, :, :])
    net = torch.stack(up, dim=-3) - torch.stack(down[::-1], dim=-3)

    mu = torch.clamp(torch.as_tensor(st.mu0, dtype=rho.dtype,
                                     device=rho.device), min=0.0)
    mu_safe = torch.clamp(mu, min=1.0e-3)
    tau = (2.0e-3 * qv + 30.0 * (q_liq + q_ice) + 1.0e-5) * rho * dz
    top = 1361.0 * mu
    above = torch.cumsum(tau.flip(-3), dim=-3).flip(-3)
    ones = torch.ones_like(zsl(tau, None, 1))
    sw_down = torch.cat([top * torch.exp(-above / mu_safe), top * ones],
                        dim=-3)
    reflected = (st.albedo * sw_down[..., 0, :, :]).unsqueeze(-3)
    below = torch.cumsum(tau, dim=-3) - tau
    sw_up = torch.cat([reflected * ones,
                       reflected * torch.exp(-(below + tau) / mu_safe)],
                      dim=-3)
    net = net + (sw_up - sw_down)
    heating = -((zsl(net, 1) - zsl(net, None, -1)) / dz) / (rho * CPDRY)
    return (rho * heating / exner,
            down[-1] + sw_down[..., 0, :, :] * (1.0 - st.albedo))


# --- surface layer and boundary layer --------------------------------------

def surface(u1, v1, t1, qv1, p1, rho1, z1, tsfc, psfc, st: Settings):
    """Bulk fluxes from the lowest level: (ρC_D|U|, ρC_H|U|, sensible and
    latent heat fluxes). |U| floored at 0.5 m/s; C_E = C_H. Departure:
    Louis (1979)'s analytic stability functions (b = c = d = 5), no
    iterated Monin–Obukhov solve."""
    kappa = RD / CPDRY
    exner_s = (psfc / PRE00) ** kappa
    th1 = t1 / (p1 / PRE00) ** kappa
    ths = tsfc / exner_s
    qs_sfc = st.beta * qsat(tsfc, psfc, False)
    thv1 = th1 * (1.0 + FVIRT * qv1)
    thvs = ths * (1.0 + FVIRT * qs_sfc)
    wind = torch.clamp(torch.sqrt(u1 * u1 + v1 * v1), min=0.5)
    rib = GRAV * z1 * (thv1 - thvs) / (0.5 * (thv1 + thvs) * wind * wind)
    ln_m = torch.log(z1 / st.z0)
    ln_h = torch.log(z1 / st.z0h)
    a2_m = (KARMAN / ln_m) ** 2
    a2_h = KARMAN * KARMAN / (ln_m * ln_h)
    sq = torch.sqrt(torch.clamp(-rib, min=0.0) * (z1 / st.z0))
    denom = 1.0 + 75.0 * a2_m * sq
    rib_p = torch.clamp(rib, min=0.0)
    unstable = rib < 0.0
    fm = torch.where(unstable, 1.0 - 10.0 * rib / denom,
                     1.0 / (1.0 + 10.0 * rib_p / torch.sqrt(1.0 + 5.0
                                                            * rib_p)))
    fh = torch.where(unstable, 1.0 - 15.0 * rib / denom,
                     1.0 / (1.0 + 15.0 * rib_p * torch.sqrt(1.0 + 5.0
                                                            * rib_p)))
    ch = a2_h * fh
    return (rho1 * (a2_m * fm) * wind, rho1 * ch * wind,
            rho1 * CPDRY * (ch * wind * (ths - th1)) * exner_s,
            rho1 * LHV * (ch * wind * (qs_sfc - qv1)))


def _dz(f):
    return zsl(f, 1) - zsl(f, None, -1)


def _mid(f):
    return 0.5 * (zsl(f, 1) + zsl(f, None, -1))


def diffuse(phi, rhok, rho, dt: float, dz, coef, value):
    """Backward-Euler vertical diffusion of the centre field phi with ρK at
    the interior faces, the surface flux coef·(value − φ₁) implicit."""
    zero = torch.zeros_like(zsl(phi, None, 1))
    up = torch.cat([rhok / (zsl(rho, None, -1) * dz * dz), zero], dim=-3)
    dn = torch.cat([zero, rhok / (zsl(rho, 1) * dz * dz)], dim=-3)
    sfc = coef / (rho[..., 0, :, :] * dz)
    diag = 1.0 + dt * (up + dn)
    diag[..., 0, :, :] += dt * sfc
    rhs = phi.clone()
    rhs[..., 0, :, :] += dt * sfc * value
    return M.thomas(-dt * dn, diag, -dt * up, rhs)


def pbl(s: M.State, dt: float, dz, zc, tsfc, st: Settings):
    """The surface layer and the implicit vertical diffusion of u, v, θ
    and qv (centre winds from the face momenta, their increments averaged
    back to the faces). K_m from the mixing length κz/(1 + κz/150 m) and
    the local shear, times the stability function of the gradient
    Richardson number (√(1 − 16 Ri) unstable, (1 − Ri/0.25)² stable),
    clipped to [1e-3, 200] m²/s; K_h = K_m/0.74. Returns (state, sensible
    and latent heat fluxes). Departure: a local first-order closure for
    MYNN's prognostic TKE."""
    rho = s.rho
    u = 0.5 * (s.rhou + rx(s.rhou, -1)) / rho
    v = 0.5 * (s.rhov + ry(s.rhov, -1)) / rho
    theta = s.rhot / rho
    qv = s.rhoq[..., 0, :, :, :] / rho
    p = M.moist_pressure(s.rhot, s.rhoq / rho.unsqueeze(-4))
    psfc = p[..., 0, :, :] + rho[..., 0, :, :] * GRAV * zc[0]
    cd, ch, shf, lhf = surface(
        u[..., 0, :, :], v[..., 0, :, :],
        (theta * (p / PRE00) ** (RD / CPDRY))[..., 0, :, :],
        qv[..., 0, :, :], p[..., 0, :, :], rho[..., 0, :, :], zc[0], tsfc,
        psfc, st)

    du, dv = _dz(u) / dz, _dz(v) / dz
    s2 = du * du + dv * dv
    thv = theta * (1.0 + FVIRT * qv)
    ri = GRAV / _mid(thv) * _dz(thv) / dz / torch.clamp(s2, min=1.0e-10)
    z_i = 0.5 * (zc[1:] + zc[:-1])
    mix = KARMAN * z_i / (1.0 + KARMAN * z_i / 150.0)
    f = torch.where(ri < 0.0, torch.sqrt(torch.clamp(1.0 - 16.0 * ri,
                                                     min=1.0)),
                    torch.clamp(1.0 - ri / 0.25, min=0.0) ** 2)
    km = torch.clamp((mix ** 2)[:, None, None] * torch.sqrt(s2) * f + 1.0e-3,
                     1.0e-3, 200.0)
    kh = torch.clamp(km / 0.74, 1.0e-3, 200.0)
    rho_i = _mid(rho)
    ths = tsfc / (psfc / PRE00) ** (RD / CPDRY)
    zero = torch.zeros_like(tsfc)
    du = diffuse(u, rho_i * km, rho, dt, dz, cd, zero) - u
    dv = diffuse(v, rho_i * km, rho, dt, dz, cd, zero) - v
    th = diffuse(theta, rho_i * kh, rho, dt, dz, ch, ths)
    qv = diffuse(qv, rho_i * kh, rho, dt, dz, ch,
                 st.beta * qsat(tsfc, psfc, False))
    rhoq = torch.cat([(rho * torch.clamp(qv, min=0.0)).unsqueeze(-4),
                      s.rhoq[..., 1:, :, :, :]], dim=-4)
    rhou = s.rhou + 0.5 * (du + rx(du, 1)) * 0.5 * (rho + rx(rho, 1))
    rhov = s.rhov + 0.5 * (dv + ry(dv, 1)) * 0.5 * (rho + ry(rho, 1))
    return (s._replace(rhou=rhou, rhov=rhov, rhot=rho * th, rhoq=rhoq),
            shf, lhf)


# --- the physics step --------------------------------------------------------

def skin_start(s: M.State):
    """The slab's cold start: the lowest level's air temperature."""
    rho, rhot, rhoq = (f[..., :1, :, :] for f in (s.rho, s.rhot, s.rhoq))
    p = M.moist_pressure(rhot, rhoq / rho.unsqueeze(-4))
    return ((rhot / rho) * (p / PRE00) ** (RD / CPDRY))[..., 0, :, :]


class Carried(NamedTuple):
    """What a physics step hands the next: the slab's skin temperature,
    the radiation's ρθ tendency and surface input between its calls."""
    tsfc: torch.Tensor
    drhot_rad: torch.Tensor
    rad_sfc: torch.Tensor


def step(s: M.State, c: Carried, index: int, st: Settings, dt: float, dz,
         zc) -> tuple[M.State, Carried]:
    """One physics step of length dt: the microphysics, radiation when
    `index` is a multiple of rad_interval (else its last tendency), the
    surface layer and PBL from the skin temperature, and the slab's
    energy budget (radiation in, emission and the turbulent fluxes out)."""
    if st.mp_scheme == "kessler":
        s = M.kessler(s, dt, dz)
    elif st.mp_scheme == "nsw6":
        s = nsw6(s, dt, dz)
    drhot_rad, rad_sfc = c.drhot_rad, c.rad_sfc
    if st.use_radiation:
        if index % st.rad_interval == 0:
            drhot_rad, rad_sfc = radiation(s, dz, st, c.tsfc)
        s = s._replace(rhot=s.rhot + dt * drhot_rad)
    tsfc = c.tsfc
    if st.use_pbl:
        s, shf, lhf = pbl(s, dt, dz, zc, tsfc, st)
        if st.slab_capacity > 0.0:
            net = rad_sfc - st.eps_sfc * SIGMA_SB * tsfc ** 4 - shf - lhf
            tsfc = tsfc + dt * net / st.slab_capacity
    return s, Carried(tsfc, drhot_rad, rad_sfc)


def start(s: M.State, tsfc=None) -> Carried:
    """The carry of a forecast's first physics step: the slab's skin
    temperature (cold-started when None) and an empty radiation cache."""
    return Carried(skin_start(s) if tsfc is None else tsfc,
                   torch.zeros_like(s.rhot),
                   torch.zeros_like(s.rhot[..., 0, :, :]))

