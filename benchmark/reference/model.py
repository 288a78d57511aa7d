"""Plain reference of the forecast: the split-explicit (HEVI) compressible
core over flat ground with periodic lateral boundaries, the Rayleigh
sponge, Kessler warm rain, and the transforms between the staggered
restart state, the collocated view and the analysis variables.

Written from the model's equations as the program's configuration states
them (C-grid flux form, UD3 scalar advection, centred momentum advection,
∇⁴ hyperdiffusion, divergence damping, Wicker–Skamarock RK3 with acoustic
substeps implicit in the vertical), in plain PyTorch: no kernel, no member
batching, no timers. Every function works in the dtype of its inputs;
`forecast` computes in float32 and can hold the state in a lower dtype
between steps (the control's bfloat16 state).
Fields carry a leading member axis: (K, nz, ny, nx), ρw (K, nz+1, ny, nx),
the tracers (K, NQ, nz, ny, nx).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

RE = 6.371e6
GRAV = 9.81
RD = 287.04
RV = 461.50
CVDRY = 717.60
CPDRY = RD + CVDRY
PRE00 = 1.0e5
T00 = 273.15
TRACER_CV = (1390.0, 4218.0, 4218.0, 2106.0, 2106.0, 2106.0)
FVIRT = RV / RD - 1.0
PSAT0 = 610.78
TETENS_A_LIQ = 17.269
TETENS_B_LIQ = 35.86
LHV = 2.501e6
BETA_OFF = 0.55
NQ = 6
NV = 11
# analysis-variable order: u, v, w, T, p, q×6; restart order ρ, ρu, ρv, ρw,
# ρθ, q×6
IA_U, IA_V, IA_W, IA_T, IA_P, IA_Q0 = 0, 1, 2, 3, 4, 5


class State(NamedTuple):
    rho: torch.Tensor
    rhou: torch.Tensor
    rhov: torch.Tensor
    rhow: torch.Tensor
    rhot: torch.Tensor
    rhoq: torch.Tensor


class Column(NamedTuple):
    """The grid's vertical column and the forecast's settings."""
    cz: np.ndarray           # (nz,) cell centres [m], float64
    fz: np.ndarray           # (nz+1,) faces [m]
    dx: float
    dy: float
    dt: float
    n_small: int
    sponge_height: float
    sponge_tau: float
    kdiff4: float
    divdmp: float
    phys_interval: int       # Kessler every this many steps; 0: off


def stretched_levels(nz: int, dz0: float, stretch: float):
    """(cz, fz) of geometrically stretched levels, dz0 at the surface."""
    if stretch == 1.0:
        fz = np.arange(nz + 1) * dz0
    else:
        fz = np.concatenate([[0.0], np.cumsum(dz0 * stretch ** np.arange(nz))])
    return 0.5 * (fz[:-1] + fz[1:]), fz


def column_of(dom: dict, physics_interval: int = 5) -> Column:
    """The Column of a configuration's [domain] table (the program's
    defaults where the table is silent)."""
    cz, fz = stretched_levels(dom["nz"], dom.get("dz", 500.0),
                              dom.get("dz_stretch", 1.0))
    return Column(cz=cz, fz=fz, dx=float(dom["dx"]), dy=float(dom["dy"]),
                  dt=float(dom.get("dt", 1.0)),
                  n_small=int(dom.get("n_small", 6)),
                  sponge_height=float(dom.get("sponge_height", 0.0)),
                  sponge_tau=float(dom.get("sponge_tau", 120.0)),
                  kdiff4=float(dom.get("kdiff4", 1.0e-3)),
                  divdmp=float(dom.get("divdmp", 0.05)),
                  phys_interval=(physics_interval
                                 if dom.get("use_physics", False) else 0))


def theta_profile(cz: np.ndarray) -> np.ndarray:
    """The base state's weakly stable θ: 300 K + 4 K/km."""
    return 300.0 + 0.004 * np.asarray(cz)


def hydrostatic_column(theta: np.ndarray, cz: np.ndarray):
    """(ρ, p) of the dry hydrostatic column of θ at the centres cz (host
    float64): the Exner function integrated upward from 1000 hPa."""
    kappa = RD / CPDRY
    pi = np.zeros(len(theta))
    pi[0] = 1.0 - GRAV / (CPDRY * theta[0]) * cz[0]
    for k in range(1, len(theta)):
        th_face = 0.5 * (theta[k - 1] + theta[k])
        pi[k] = pi[k - 1] - GRAV / (CPDRY * th_face) * (cz[k] - cz[k - 1])
    p = PRE00 * pi ** (1.0 / kappa)
    return p / (RD * theta * pi), p


def reference_columns(col: Column, device, dtype=torch.float32):
    """ρ_ref and p_ref (nz, 1, 1): the base column and the equation of
    state of its ρθ."""
    theta = theta_profile(col.cz)
    rho1d, _ = hydrostatic_column(theta, col.cz)
    p_ref = PRE00 * (rho1d * theta * RD / PRE00) ** (CPDRY / CVDRY)
    return (torch.as_tensor(rho1d[:, None, None], dtype=dtype, device=device),
            torch.as_tensor(p_ref[:, None, None], dtype=dtype, device=device))


# --- stencils (z = -3, y = -2, x = -1; periodic x and y) ------------------

def zsl(f, start=None, stop=None):
    return f[..., start:stop, :, :]


def rx(f, n):
    """The value from i+n."""
    return torch.roll(f, -n, dims=-1)


def ry(f, n):
    return torch.roll(f, -n, dims=-2)


def ud3_x(f, flux):
    fm1, f0, fp1, fp2 = rx(f, -1), f, rx(f, 1), rx(f, 2)
    return torch.where(flux >= 0, (2.0 * fp1 + 5.0 * f0 - fm1) / 6.0,
                       (2.0 * f0 + 5.0 * fp1 - fp2) / 6.0)


def ud3_y(f, flux):
    fm1, f0, fp1, fp2 = ry(f, -1), f, ry(f, 1), ry(f, 2)
    return torch.where(flux >= 0, (2.0 * fp1 + 5.0 * f0 - fm1) / 6.0,
                       (2.0 * f0 + 5.0 * fp1 - fp2) / 6.0)


def ud3_z(f, flux_w):
    """Face values at the interior z-faces; centred next to the rigid
    top and bottom."""
    nz = f.shape[-3]
    pos = (2.0 * zsl(f, 1) + 5.0 * zsl(f, None, -1)
           - torch.cat([zsl(f, None, 1), zsl(f, None, -2)], dim=-3)) / 6.0
    neg = (2.0 * zsl(f, None, -1) + 5.0 * zsl(f, 1)
           - torch.cat([zsl(f, 2), zsl(f, -1)], dim=-3)) / 6.0
    hi = torch.where(flux_w >= 0, pos, neg)
    centred = 0.5 * (zsl(f, 1) + zsl(f, None, -1))
    k = torch.arange(nz - 1, device=f.device)[:, None, None]
    return torch.where((k == 0) | (k == nz - 2), centred, hi)


def hyperdiff4(f, coef):
    def lap(g):
        return rx(g, 1) + rx(g, -1) + ry(g, 1) + ry(g, -1) - 4.0 * g
    return -coef * lap(lap(f))


def scalar_tendency(f, rho, fx, fy, fw, dzc, dx, dy, kdiff4):
    """−∇·(F f/ρ) − kdiff4 ∇⁴f."""
    phi = f / rho
    fl_x = fx * ud3_x(phi, fx)
    fl_y = fy * ud3_y(phi, fy)
    fw_int = zsl(fw, 1, -1)
    fl_z_int = fw_int * ud3_z(phi, fw_int)
    zeros = torch.zeros_like(zsl(fl_z_int, None, 1))
    fl_z = torch.cat([zeros, fl_z_int, zeros], dim=-3)
    out = -((fl_x - rx(fl_x, -1)) / dx + (fl_y - ry(fl_y, -1)) / dy
            + (zsl(fl_z, 1) - zsl(fl_z, None, -1)) / dzc)
    if kdiff4 != 0.0:
        out = out + hyperdiff4(f, kdiff4)
    return out


# --- thermodynamics -------------------------------------------------------

def rtot_cvtot(q):
    """R and Cv of moist air from the mixing ratios q (..., NQ, nz, ny,
    nx), the heat capacities summed tracer by tracer."""
    qdry = 1.0 - torch.sum(q, dim=-4)
    cvtot = CVDRY * qdry
    for i in range(NQ):
        cvtot.add_(q[..., i, :, :, :], alpha=TRACER_CV[i])
    rtot = RD * qdry
    rtot.add_(q[..., 0, :, :, :], alpha=RV)
    return rtot, cvtot


def moist_pressure(rhot, q):
    rtot, cvtot = rtot_cvtot(q)
    return PRE00 * (rhot * rtot / PRE00) ** ((cvtot + rtot) / cvtot)


def mixing_ratios(s: State):
    return s.rhoq / torch.clamp(s.rho, min=1e-10).unsqueeze(-4)


# --- slow tendencies -------------------------------------------------------

def tendencies(s: State, col: Column, rho_ref, p_ref, dzc, dzf) -> State:
    dx, dy, kdiff4 = col.dx, col.dy, col.kdiff4
    p_pert = moist_pressure(s.rhot, mixing_ratios(s)) - p_ref
    rho, fx, fy, rhow = s.rho, s.rhou, s.rhov, s.rhow
    div = ((fx - rx(fx, -1)) / dx + (fy - ry(fy, -1)) / dy
           + (zsl(rhow, 1) - zsl(rhow, None, -1)) / dzc)
    drho = -div
    drhot = scalar_tendency(s.rhot, rho, fx, fy, rhow, dzc, dx, dy, kdiff4)

    def zface_avg(f):
        return torch.cat([zsl(f, None, 1), 0.5 * (zsl(f, 1) + zsl(f, None, -1)),
                          zsl(f, -1)], dim=-3)

    def zero_ends(f):
        zeros = torch.zeros_like(zsl(f, None, 1))
        return torch.cat([zeros, zsl(f, 1, -1), zeros], dim=-3)

    u_face = fx / (0.5 * (rho + rx(rho, 1)))
    v_face = fy / (0.5 * (rho + ry(rho, 1)))

    adv = 0.5 * (fx + rx(fx, -1)) * 0.5 * (u_face + rx(u_face, -1))
    dadv_u = (rx(adv, 1) - adv) / dx
    adv = 0.5 * (fy + rx(fy, 1)) * 0.5 * (u_face + ry(u_face, 1))
    dadv_u = dadv_u + (adv - ry(adv, -1)) / dy
    adv = zero_ends(0.5 * (rhow + rx(rhow, 1)) * zface_avg(u_face))
    dadv_u = dadv_u + (zsl(adv, 1) - zsl(adv, None, -1)) / dzc
    drhou = (-dadv_u - (rx(p_pert, 1) - p_pert) / dx
             + hyperdiff4(fx, kdiff4))

    adv = 0.5 * (fy + ry(fy, -1)) * 0.5 * (v_face + ry(v_face, -1))
    dadv_v = (ry(adv, 1) - adv) / dy
    adv = 0.5 * (fx + ry(fx, 1)) * 0.5 * (v_face + rx(v_face, 1))
    dadv_v = dadv_v + (adv - rx(adv, -1)) / dx
    adv = zero_ends(0.5 * (rhow + ry(rhow, 1)) * zface_avg(v_face))
    dadv_v = dadv_v + (zsl(adv, 1) - zsl(adv, None, -1)) / dzc
    drhov = (-dadv_v - (ry(p_pert, 1) - p_pert) / dy
             + hyperdiff4(fy, kdiff4))

    w_full = rhow / zface_avg(rho)
    w_face = zsl(w_full, 1, -1)
    adv = (0.5 * (zsl(rhow, 1) + zsl(rhow, None, -1))
           * 0.5 * (zsl(w_full, 1) + zsl(w_full, None, -1)))
    dadv_w = (zsl(adv, 1) - zsl(adv, None, -1)) / dzf
    adv = 0.5 * (zsl(fx, 1) + zsl(fx, None, -1)) * 0.5 * (w_face
                                                         + rx(w_face, 1))
    dadv_w = dadv_w + (adv - rx(adv, -1)) / dx
    adv = 0.5 * (zsl(fy, 1) + zsl(fy, None, -1)) * 0.5 * (w_face
                                                         + ry(w_face, 1))
    dadv_w = dadv_w + (adv - ry(adv, -1)) / dy
    dpz = (zsl(p_pert, 1) - zsl(p_pert, None, -1)) / dzf
    rho_pert = rho - rho_ref
    buoy = -(0.5 * (zsl(rho_pert, 1) + zsl(rho_pert, None, -1))) * GRAV
    drhow_int = -dadv_w - dpz + buoy + hyperdiff4(zsl(rhow, 1, -1), kdiff4)

    if col.divdmp > 0:
        alpha = col.divdmp * dx * dx / col.dt
        drhou = drhou + alpha * (rx(div, 1) - div) / dx
        drhov = drhov + alpha * (ry(div, 1) - div) / dy
        alpha_z = col.divdmp * dzf * dzf / col.dt
        drhow_int = drhow_int + alpha_z * (zsl(div, 1)
                                           - zsl(div, None, -1)) / dzf
    zeros = torch.zeros_like(zsl(rhow, None, 1))
    drhow = torch.cat([zeros, drhow_int, zeros], dim=-3)
    drhoq = scalar_tendency(s.rhoq, rho.unsqueeze(-4), fx.unsqueeze(-4),
                            fy.unsqueeze(-4), rhow.unsqueeze(-4), dzc, dx, dy,
                            kdiff4)
    return State(drho, drhou, drhov, drhow, drhot, drhoq)


# --- acoustic substeps -----------------------------------------------------

def thomas(a, b, c, d):
    """Tridiagonal solve along axis -3: b x + a x[k-1] + c x[k+1] = d."""
    a, b, c, d = (t.movedim(-3, 0) for t in torch.broadcast_tensors(a, b, c, d))
    n = d.shape[0]
    cps, dps = torch.empty_like(d), torch.empty_like(d)
    cp, dp = torch.zeros_like(d[0]), torch.zeros_like(d[0])
    for k in range(n):
        denom = b[k] - a[k] * cp
        cp = torch.div(c[k], denom, out=cps[k])
        dp = torch.div(d[k] - a[k] * dp, denom, out=dps[k])
    xs = torch.empty_like(d)
    x = torch.zeros_like(d[0])
    for k in range(n - 1, -1, -1):
        x = torch.sub(dps[k], cps[k] * x, out=xs[k])
    return xs.movedim(0, -3)


def acoustic(s0: State, st: State, slow: State, col: Column, dzc, dzf,
             n_steps: int, dt_stage: float) -> State:
    """The acoustic system over dt_stage in n_steps substeps, linearized
    about the stage state st, from s0."""
    beta = BETA_OFF
    dtau = dt_stage / n_steps
    dx, dy = col.dx, col.dy
    rho0, rhot0 = st.rho, st.rhot
    p0 = moist_pressure(rhot0, mixing_ratios(st))
    theta0 = rhot0 / rho0
    c2 = (CPDRY / CVDRY) * p0 / rhot0
    theta_face = torch.cat([zsl(theta0, None, 1),
                            0.5 * (zsl(theta0, 1) + zsl(theta0, None, -1)),
                            zsl(theta0, -1)], dim=-3)
    g_half = dtau * beta * GRAV * 0.5
    abf = dtau * beta / dzf
    abc = dtau * beta / dzc
    abc_up, abc_dn = abc[1:], abc[:-1]
    c2_up, c2_dn = zsl(c2, 1), zsl(c2, None, -1)
    b_diag = (1.0 + abf * zsl(theta_face, 1, -1) * (c2_up * abc_up
                                                     + c2_dn * abc_dn)
              + g_half * (abc_up - abc_dn))
    c_sup = -abf * c2_up * abc_up * zsl(theta_face, 2) - g_half * abc_up
    a_sub = -abf * c2_dn * abc_dn * zsl(theta_face, None, -2) + g_half * abc_dn

    theta_xf = 0.5 * (theta0 + rx(theta0, 1))
    theta_yf = 0.5 * (theta0 + ry(theta0, 1))
    drho = s0.rho - rho0
    drhou = s0.rhou - st.rhou
    drhov = s0.rhov - st.rhov
    drhow = s0.rhow - st.rhow
    drhot = s0.rhot - rhot0
    for _ in range(n_steps):
        dp = c2 * drhot
        drhou = drhou + dtau * (-((rx(dp, 1) - dp) / dx) + slow.rhou)
        drhov = drhov + dtau * (-((ry(dp, 1) - dp) / dy) + slow.rhov)
        div_h = (drhou - rx(drhou, -1)) / dx + (drhov - ry(drhov, -1)) / dy
        u_th = drhou * theta_xf
        v_th = drhov * theta_yf
        div_h_th = (u_th - rx(u_th, -1)) / dx + (v_th - ry(v_th, -1)) / dy

        w_old = drhow
        flux_w = (zsl(w_old, 1) - zsl(w_old, None, -1)) / dzc
        wth_old = w_old * theta_face
        flux_wth = (zsl(wth_old, 1) - zsl(wth_old, None, -1)) / dzc
        rho_exp = (drho + dtau * (slow.rho - div_h)
                   - dtau * (1 - beta) * flux_w)
        rhot_exp = (drhot + dtau * (slow.rhot - div_h_th)
                    - dtau * (1 - beta) * flux_wth)
        dp_z = (zsl(dp, 1) - zsl(dp, None, -1)) / dzf
        rho_face_old = 0.5 * (zsl(drho, 1) + zsl(drho, None, -1))
        rhs = (zsl(w_old, 1, -1) + dtau * zsl(slow.rhow, 1, -1)
               - dtau * (1 - beta) * (dp_z + GRAV * rho_face_old)
               - abf * (c2_up * zsl(rhot_exp, 1)
                        - c2_dn * zsl(rhot_exp, None, -1))
               - g_half * (zsl(rho_exp, 1) + zsl(rho_exp, None, -1)))
        w_int = thomas(a_sub, b_diag, c_sup, rhs)
        zeros = torch.zeros_like(zsl(drhow, None, 1))
        drhow = torch.cat([zeros, w_int, zeros], dim=-3)
        drho = rho_exp - abc * (zsl(drhow, 1) - zsl(drhow, None, -1))
        wth = drhow * theta_face
        drhot = rhot_exp - abc * (zsl(wth, 1) - zsl(wth, None, -1))
    return State(rho=rho0 + drho, rhou=st.rhou + drhou, rhov=st.rhov + drhov,
                 rhow=st.rhow + drhow, rhot=rhot0 + drhot,
                 rhoq=s0.rhoq + dt_stage * slow.rhoq)


def sponge(s: State, col: Column, z_c: torch.Tensor) -> State:
    """Rayleigh damping of the momenta above sponge_height."""
    if col.sponge_height <= 0:
        return s
    ztop, zs, dt = float(col.fz[-1]), col.sponge_height, col.dt
    half_pi = 0.5 * np.pi
    zero = torch.zeros((), dtype=z_c.dtype, device=z_c.device)
    coef_c = torch.where(z_c > zs, torch.sin(half_pi * (z_c - zs)
                                             / (ztop - zs)) ** 2,
                         zero) / col.sponge_tau
    z_f = torch.cat([z_c[:1] - (z_c[1] - z_c[0]) * 0.5,
                     0.5 * (z_c[1:] + z_c[:-1]),
                     z_c[-1:] + (z_c[-1] - z_c[-2]) * 0.5])
    coef_f = torch.where(z_f > zs, torch.sin(half_pi * torch.clamp(
        (z_f - zs) / (ztop - zs), 0, 1)) ** 2, zero) / col.sponge_tau
    damp_c = (1.0 / (1.0 + dt * coef_c))[:, None, None]
    damp_f = (1.0 / (1.0 + dt * coef_f))[:, None, None]
    return s._replace(rhow=s.rhow * damp_f, rhou=s.rhou * damp_c,
                      rhov=s.rhov * damp_c)


def si_step(s: State, col: Column, rho_ref, p_ref, dzc, dzf, z_c) -> State:
    """One split-explicit RK3 step: stages of dt/3, dt/2 and dt with
    n_small//3, n_small//2 and n_small substeps, then the sponge."""
    dt, n = col.dt, col.n_small

    def stage(s_from, dt_stage, ns):
        slow = tendencies(s_from, col, rho_ref, p_ref, dzc, dzf)
        return acoustic(s, s_from, slow, col, dzc, dzf, ns, dt_stage)

    s1 = stage(s, dt / 3.0, max(1, n // 3))
    s2 = stage(s1, dt / 2.0, max(1, n // 2))
    s3 = stage(s2, dt, n)
    return sponge(s3, col, z_c)


# --- Kessler warm rain ----------------------------------------------------

def kessler(s: State, dt: float, dz) -> State:
    """Saturation adjustment, autoconversion, accretion, rain evaporation
    and upwind rain sedimentation (Marshall–Palmer fall speed, capped at
    0.9 dz/dt), the latent heat fed back on ρθ."""
    rho = s.rho
    q = s.rhoq / rho.unsqueeze(-4)
    qv, qc, qr = q[..., 0, :, :, :], q[..., 1, :, :, :], q[..., 2, :, :, :]
    p = moist_pressure(s.rhot, q)
    temp = p / (rho * (RD * (1.0 - torch.sum(q, dim=-4)) + RV * qv))
    es = PSAT0 * torch.exp(TETENS_A_LIQ * (temp - T00) / (temp - TETENS_B_LIQ))
    qs = 0.622 * es / torch.clamp(p - 0.378 * es, min=1.0)
    dqsdt = qs * (TETENS_A_LIQ * (T00 - TETENS_B_LIQ)
                  / (temp - TETENS_B_LIQ) ** 2)
    cond = torch.maximum((qv - qs) / (1.0 + (LHV / CPDRY) * dqsdt), -qc)
    qv = qv - cond
    qc = qc + cond
    fac = LHV / CPDRY * (PRE00 / p) ** (RD / CPDRY)
    heat = fac * cond
    auto = torch.clamp(1.0e-3 * (qc - 1.0e-3), min=0.0) * dt
    accr = 2.2 * qc * torch.clamp(qr, min=0.0) ** 0.875 * dt
    dqc = torch.minimum(auto + accr, qc)
    qc = qc - dqc
    qr = qr + dqc
    subsat = torch.clamp(qs - qv, min=0.0)
    evap = torch.minimum(subsat, torch.minimum(
        qr, 1.0e-3 * dt * subsat * (rho * torch.clamp(qr, min=0.0)) ** 0.65))
    qv = qv + evap
    qr = qr - evap
    heat = heat - fac * evap
    vt = 36.34 * (rho * torch.clamp(qr, min=0.0)) ** 0.1364 * torch.sqrt(
        torch.clamp(zsl(rho, -1) / rho, min=0.1))
    vt = torch.minimum(vt, torch.as_tensor(0.9 * dz / dt, dtype=vt.dtype,
                                           device=vt.device))
    flux = rho * qr * vt
    inflow = torch.cat([zsl(flux, 1), torch.zeros_like(zsl(flux, None, 1))],
                       dim=-3)
    qr = torch.clamp(qr + dt * (inflow - flux) / (rho * dz), min=0.0)
    rhoq = torch.cat([torch.stack([qv * rho, qc * rho, qr * rho], dim=-4),
                      s.rhoq[..., 3:, :, :, :]], dim=-4)
    return s._replace(rhot=s.rhot + rho * heat, rhoq=rhoq)


def forecast(s: State, col: Column, nsteps: int, device,
             store: torch.dtype | None = None) -> State:
    """nsteps steps of the composition in float32: the SI step, and Kessler
    over phys_interval·dt after every phys_interval steps and after the
    remainder (when phys_interval > 0). store: a dtype the state is
    rounded to at the start and after every step and physics step (the
    control's bfloat16 state), None for none."""
    f32 = torch.float32

    def held(x: State) -> State:
        if store is None:
            return x
        return State(*(f.to(store).to(f32) for f in x))
    s = held(State(*(f.to(f32) for f in s)))
    rho_ref, p_ref = reference_columns(col, device, f32)
    dzc = torch.as_tensor(np.diff(col.fz)[:, None, None], dtype=f32,
                          device=device)
    dzf = torch.as_tensor(np.diff(col.cz)[:, None, None], dtype=f32,
                          device=device)
    z_c = torch.as_tensor(col.cz, dtype=f32, device=device)
    chunk = min(col.phys_interval, nsteps) if col.phys_interval else nsteps
    n_chunks, rem = divmod(nsteps, max(chunk, 1))
    for n in [chunk] * n_chunks + [rem] * (rem > 0):
        for _ in range(n):
            s = held(si_step(s, col, rho_ref, p_ref, dzc, dzf, z_c))
        if col.phys_interval:
            s = held(kessler(s, col.dt * n, dzc))
    return s


# --- restart ↔ collocated ↔ analysis variables ----------------------------

def collocated(s: State) -> torch.Tensor:
    """(..., NV, nz, ny, nx) restart view at the centres: the momenta
    averaged from their faces, the tracers as mixing ratios."""
    core = torch.stack([s.rho, 0.5 * (s.rhou + rx(s.rhou, -1)),
                        0.5 * (s.rhov + ry(s.rhov, -1)),
                        0.5 * (zsl(s.rhow, 1) + zsl(s.rhow, None, -1)),
                        s.rhot], dim=-4)
    return torch.cat([core, mixing_ratios(s)], dim=-4)


def to_analysis(v: torch.Tensor) -> torch.Tensor:
    """Collocated restart view → u, v, w, T, p, q×6."""
    q = v[..., 5:, :, :, :]
    rtot, cvtot = rtot_cvtot(q)
    rho = v[..., 0, :, :, :]
    p = PRE00 * (v[..., 4, :, :, :] * rtot / PRE00) ** ((cvtot + rtot)
                                                        / cvtot)
    return torch.cat([torch.stack([v[..., 1, :, :, :] / rho,
                                   v[..., 2, :, :, :] / rho,
                                   v[..., 3, :, :, :] / rho,
                                   p / (rho * rtot), p], dim=-4), q], dim=-4)


def from_analysis(a: torch.Tensor) -> torch.Tensor:
    """Analysis variables → the collocated restart view: ρ = p/(R T),
    ρθ = p00/R (p/p00)^(Cv/Cp), ρu = u ρ."""
    q = a[..., 5:, :, :, :]
    rtot, cvtot = rtot_cvtot(q)
    p = a[..., IA_P, :, :, :]
    rho = p / (rtot * a[..., IA_T, :, :, :])
    rhot = (p / PRE00) ** (cvtot / (cvtot + rtot)) * (PRE00 / rtot)
    return torch.cat([torch.stack([rho, a[..., 0, :, :, :] * rho,
                                   a[..., 1, :, :, :] * rho,
                                   a[..., 2, :, :, :] * rho, rhot], dim=-4),
                      q], dim=-4)


def staggered(v: torch.Tensor) -> State:
    """Collocated restart view → the staggered state: centre momenta
    averaged to the faces east and north, ρw to the interior z-faces
    (zero at the rigid ones), the tracers as densities."""
    rho = v[..., 0, :, :, :]
    w_c = v[..., 3, :, :, :]
    zeros = torch.zeros_like(zsl(w_c, None, 1))
    return State(rho=rho, rhou=0.5 * (v[..., 1, :, :, :]
                                      + rx(v[..., 1, :, :, :], 1)),
                 rhov=0.5 * (v[..., 2, :, :, :] + ry(v[..., 2, :, :, :], 1)),
                 rhow=torch.cat([zeros, 0.5 * (zsl(w_c, 1)
                                               + zsl(w_c, None, -1)), zeros],
                                dim=-3),
                 rhot=v[..., 4, :, :, :],
                 rhoq=v[..., 5:, :, :, :] * rho.unsqueeze(-4))
