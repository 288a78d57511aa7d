"""Compressible nonhydrostatic finite-volume dynamical core.

Port of scale_letkf_tpu/model/dycore.py: Arakawa C-grid flux form (ρ, ρθ,
ρq at cell centers; ρu at x-faces i+1/2, ρv at y-faces j+1/2, ρw at the
nz+1 vertical faces, rigid top and bottom), UD3 scalar advection, centered
momentum advection, Wicker–Skamarock RK3, ∇⁴ hyperdiffusion, divergence
damping and a Rayleigh sponge near the model top.

Differences from the JAX module:
- fields may carry leading batch axes (the member axis of an ensemble),
  which replace `vmap`: every stencil works on the last three axes
  (z, y, x) = (-3, -2, -1), tracers stack on axis -4;
- the lateral boundary mode is an explicit argument (`cfg.lateral`), not a
  module global bound at trace time: 'periodic' wraps, 'open' repeats the
  edge value (zero-gradient ghost cells);
- `tendencies` has no `advection` knob: the device decides. CUDA tensors
  go through the hand-written kernels (ops/tendency.py, ops/stencil.py),
  CPU tensors through their plain PyTorch versions;
- the stencil helpers (`_shift_clamp`, `roll_x`/`roll_y`, `ud3_face_x/y/z`,
  `hyperdiff4`) live in ops/finite_diff.py, below both this module and the
  kernel wrappers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from scale_letkf_torch.constants import RD, CVDRY, PRE00, GRAV
from scale_letkf_torch.ops.finite_diff import roll_x, roll_y, zsl
from scale_letkf_torch.ops.stencil import adv_flux_divergence
from scale_letkf_torch.ops.tendency import dyn_tendencies
from scale_letkf_torch.state import (
    IR_RHO, IR_RHOU, IR_RHOV, IR_RHOW, IR_RHOT, IR_Q0, _moist_rtot_cvtot,
)
from scale_letkf_torch.utils.timing import Timer, maybe_section

CPDRY = RD + CVDRY
LATERAL_MODES = ("periodic", "open")
HALO_MODES = ("gspmd", "explicit", "explicit_overlap")


@dataclass(frozen=True)
class DycoreConfig:
    dx: float
    dy: float
    dz: float                  # nominal vertical spacing (a VGrid gives stretched levels)
    dt: float                  # model step (one RK3 step)
    divdmp: float = 0.05       # divergence damping coefficient (of dx²/dt)
    kdiff4: float = 1.0e-3     # 4th-order hyperdiffusion coefficient
    sponge_height: float = 0.0 # Rayleigh sponge bottom [m] (0: off)
    sponge_tau: float = 60.0   # sponge damping timescale [s]
    ztop: float = 0.0          # set from the grid
    lateral: str = "periodic"  # 'periodic' | 'open' (edge-clamped stencils)
    halo: str = "gspmd"        # halo backend under a spatial grid: 'gspmd'
                               # (the explicit exchange, there being no
                               # compiler to place collectives),
                               # 'explicit' or 'explicit_overlap'
                               # (parallel/halo.py)


class DycoreState(NamedTuple):
    """Staggered prognostic fields (C-grid); any leading axes are batch
    (member) axes shared by all six fields."""
    rho: torch.Tensor    # (..., nz, ny, nx) cell centers
    rhou: torch.Tensor   # (..., nz, ny, nx) x-faces (i+1/2)
    rhov: torch.Tensor   # (..., nz, ny, nx) y-faces (j+1/2)
    rhow: torch.Tensor   # (..., nz+1, ny, nx) z-faces; [0] and [nz] rigid (0)
    rhot: torch.Tensor   # (..., nz, ny, nx) ρθ
    rhoq: torch.Tensor   # (..., NQ, nz, ny, nx) tracer densities ρq


class VGrid(NamedTuple):
    """Stretched vertical metric (the reference's FZ levels)."""
    dzc: torch.Tensor    # (nz, 1, 1)   cell thickness fz[k+1] − fz[k]
    dzf: torch.Tensor    # (nz-1, 1, 1) center spacing cz[k] − cz[k-1]
                         #              (at interior z-faces k = 1..nz-1)


def make_vgrid(cz: np.ndarray, fz: np.ndarray, device: torch.device,
               dtype: torch.dtype = torch.float32) -> VGrid:
    cz = np.asarray(cz, np.float64)
    fz = np.asarray(fz, np.float64)
    return VGrid(
        dzc=torch.as_tensor((fz[1:] - fz[:-1])[:, None, None], dtype=dtype,
                            device=device),
        dzf=torch.as_tensor((cz[1:] - cz[:-1])[:, None, None], dtype=dtype,
                            device=device))


def uniform_vgrid(nz: int, dz: float, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> VGrid:
    """The VGrid of uniform spacing dz (what `vg=None` means)."""
    return VGrid(dzc=torch.full((nz, 1, 1), dz, dtype=dtype, device=device),
                 dzf=torch.full((max(nz - 1, 0), 1, 1), dz, dtype=dtype,
                                device=device))


def metric(s: DycoreState, cfg: DycoreConfig, vg: VGrid | None) -> VGrid:
    """vg, or the uniform metric of cfg.dz on s's device."""
    if vg is not None:
        return vg
    return uniform_vgrid(s.rho.shape[-3], cfg.dz, s.rho.device, s.rho.dtype)


# ---------------------------------------------------------------------------
# Thermodynamics
# ---------------------------------------------------------------------------

def moist_pressure(rhot: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p = PRE00 (ρθ R_tot/PRE00)^(Cp_tot/Cv_tot) with the moist R/CV of the
    DA state transform. q: mixing ratios (..., NQ, nz, ny, nx). The CV sum
    is taken tracer by tracer (state._moist_rtot_cvtot), never as a matrix
    product, so a caller's TF32 setting cannot touch it."""
    rtot, cvtot = _moist_rtot_cvtot(q)
    cpovcv = (cvtot + rtot) / cvtot
    return PRE00 * (rhot * rtot / PRE00) ** cpovcv


def mixing_ratios(s: DycoreState) -> torch.Tensor:
    """ρq / max(ρ, 1e-10): the tracers as mixing ratios (pressure only; the
    advection divides by ρ with no floor)."""
    return s.rhoq / torch.clamp(s.rho, min=1e-10).unsqueeze(-4)


def hydrostatic_reference(theta_prof: np.ndarray, dz: float,
                          p_sfc: float = PRE00,
                          cz: np.ndarray | None = None):
    """Dry hydrostatically balanced reference column ρ̄(z), p̄(z) for a
    potential-temperature profile at cell centers (host numpy, set-up
    time). cz: optional stretched cell-center heights; None ⇒ uniform dz."""
    nz = len(theta_prof)
    if cz is None:
        cz = (np.arange(nz) + 0.5) * dz
    cz = np.asarray(cz, np.float64)
    # dπ/dz = -g/(cp θ);  π = (p/p00)^(Rd/cp)
    kappa = RD / CPDRY
    pi_sfc = (p_sfc / PRE00) ** kappa
    pi = np.zeros(nz)
    pi[0] = pi_sfc - GRAV / (CPDRY * theta_prof[0]) * cz[0]
    for k in range(1, nz):
        th_face = 0.5 * (theta_prof[k - 1] + theta_prof[k])
        pi[k] = pi[k - 1] - GRAV / (CPDRY * th_face) * (cz[k] - cz[k - 1])
    p = PRE00 * pi ** (1.0 / kappa)
    t = theta_prof * pi
    rho = p / (RD * t)
    return rho, p


# ---------------------------------------------------------------------------
# Tendencies and time stepping
# ---------------------------------------------------------------------------

def _check_lateral(lateral: str) -> None:
    if lateral not in LATERAL_MODES:
        raise ValueError(f"unknown lateral BC {lateral!r} "
                         f"(valid: {', '.join(LATERAL_MODES)})")


def tendencies(s: DycoreState, cfg: DycoreConfig, rho_ref: torch.Tensor,
               p_ref: torch.Tensor, vg: VGrid | None = None) -> DycoreState:
    """Flux-form tendencies. rho_ref/p_ref: (nz, 1, 1) reference column;
    vg: stretched vertical metric (None ⇒ uniform cfg.dz).

    The counterpart of the reference's pallas_tendency.tendencies_fused:
    p′ = moist_pressure − p_ref in plain torch (pow, no stencil), then the
    five dynamics fields (kernel #2, ops/tendency.py) and the NQ tracers
    (kernel #3, ops/stencil.py). The device decides the path: CUDA tensors
    always go through the two hand-written kernels, one launch each (a
    single member runs as a batch of one), CPU tensors through their plain
    versions; either in both lateral modes."""
    _check_lateral(cfg.lateral)
    if s.rho.is_cuda and s.rho.dim() == 3:
        out = tendencies(DycoreState(*(f[None] for f in s)), cfg, rho_ref,
                         p_ref, vg)
        return DycoreState(*(f[0] for f in out))
    vg = metric(s, cfg, vg)
    p_pert = moist_pressure(s.rhot, mixing_ratios(s)) - p_ref
    dyn = dyn_tendencies(s.rho, s.rhou, s.rhov, s.rhow, s.rhot, p_pert,
                         rho_ref, vg.dzc, vg.dzf, cfg.dx, cfg.dy, cfg.kdiff4,
                         cfg.divdmp, cfg.dt, cfg.lateral)
    drhoq = adv_flux_divergence(s.rhoq, s.rho, s.rhou, s.rhov, s.rhow,
                                vg.dzc, cfg.dx, cfg.dy, cfg.kdiff4,
                                cfg.lateral)
    return DycoreState(*dyn, rhoq=drhoq)


def _axpy(s: DycoreState, t: DycoreState, a: float, dt) -> DycoreState:
    return DycoreState(*(x + a * dt * dx for x, dx in zip(s, t)))


def rayleigh_sponge(s: DycoreState, s0: DycoreState, cfg: DycoreConfig,
                    z_center: torch.Tensor, dt: float) -> DycoreState:
    """Damp w (and the horizontal winds) toward zero above sponge_height."""
    if cfg.sponge_height <= 0:
        return s
    ztop = cfg.ztop
    zs = cfg.sponge_height
    half_pi = 0.5 * np.pi
    zero = torch.zeros((), dtype=z_center.dtype, device=z_center.device)
    coef_c = torch.where(
        z_center > zs,
        torch.sin(half_pi * (z_center - zs) / (ztop - zs)) ** 2,
        zero) / cfg.sponge_tau
    dz_lo = z_center[1] - z_center[0]
    dz_hi = z_center[-1] - z_center[-2]
    z_face = torch.cat([z_center[:1] - dz_lo * 0.5,
                        0.5 * (z_center[1:] + z_center[:-1]),
                        z_center[-1:] + dz_hi * 0.5])
    coef_f = torch.where(
        z_face > zs,
        torch.sin(half_pi * torch.clamp((z_face - zs) / (ztop - zs), 0, 1))
        ** 2, zero) / cfg.sponge_tau
    damp_c = (1.0 / (1.0 + dt * coef_c))[:, None, None]
    damp_f = (1.0 / (1.0 + dt * coef_f))[:, None, None]
    return s._replace(rhow=s.rhow * damp_f, rhou=s.rhou * damp_c,
                      rhov=s.rhov * damp_c)


def rk3_step(s: DycoreState, cfg: DycoreConfig, rho_ref, p_ref, z_center,
             vg: VGrid | None = None, timer: Timer | None = None
             ) -> DycoreState:
    """One Wicker–Skamarock RK3 step: s1 = s + dt/3 f(s); s2 = s + dt/2
    f(s1); s3 = s + dt f(s2); then the Rayleigh sponge. timer: optional
    sections `tendencies` and `sponge`."""
    dt = cfg.dt

    def f(s_from):
        with maybe_section(timer, "tendencies"):
            return tendencies(s_from, cfg, rho_ref, p_ref, vg)

    s1 = _axpy(s, f(s), 1.0 / 3.0, dt)
    s2 = _axpy(s, f(s1), 0.5, dt)
    s3 = _axpy(s, f(s2), 1.0, dt)
    with maybe_section(timer, "sponge"):
        return rayleigh_sponge(s3, s, cfg, z_center, dt)


def integrate(s: DycoreState, cfg: DycoreConfig, rho_ref, p_ref, z_center,
              nsteps: int, vg: VGrid | None = None,
              timer: Timer | None = None) -> DycoreState:
    """nsteps RK3 steps."""
    for _ in range(nsteps):
        s = rk3_step(s, cfg, rho_ref, p_ref, z_center, vg, timer)
    return s


# ---------------------------------------------------------------------------
# Staggered dycore state ↔ collocated DA restart view
# ---------------------------------------------------------------------------

def to_collocated(s: DycoreState, lateral: str = "periodic") -> torch.Tensor:
    """Staggered → stacked collocated restart view (..., NV3D, nz, ny, nx);
    momenta averaged to cell centers."""
    return collocate(s, roll_x(s.rhou, -1, lateral),
                     roll_y(s.rhov, -1, lateral))


def collocate(s: DycoreState, rhou_w: torch.Tensor,
              rhov_s: torch.Tensor) -> torch.Tensor:
    """to_collocated with the faces west and south of each cell given (ρu at
    i−1/2, ρv at j−1/2): the halo path (parallel/halo.py) takes them from
    its neighbours' blocks."""
    rhou_c = 0.5 * (s.rhou + rhou_w)
    rhov_c = 0.5 * (s.rhov + rhov_s)
    rhow_c = 0.5 * (zsl(s.rhow, 1) + zsl(s.rhow, None, -1))
    core = torch.stack([s.rho, rhou_c, rhov_c, rhow_c, s.rhot], dim=-4)
    return torch.cat([core, mixing_ratios(s)], dim=-4)


def from_collocated(v: torch.Tensor, lateral: str = "periodic") -> DycoreState:
    """Stacked collocated restart view → staggered dycore state: center
    momenta averaged back to faces, w boundary faces set to 0."""
    return stagger(v, roll_x(v[..., IR_RHOU, :, :, :], 1, lateral),
                   roll_y(v[..., IR_RHOV, :, :, :], 1, lateral))


def stagger(v: torch.Tensor, rhou_e: torch.Tensor,
            rhov_n: torch.Tensor) -> DycoreState:
    """from_collocated with the center momenta east and north of each cell
    given (ρu at i+1, ρv at j+1), as `collocate` takes its faces."""
    def var(i):
        return v[..., i, :, :, :]
    rho = var(IR_RHO)
    rhou = 0.5 * (var(IR_RHOU) + rhou_e)
    rhov = 0.5 * (var(IR_RHOV) + rhov_n)
    rhow_c = var(IR_RHOW)
    rhow_int = 0.5 * (zsl(rhow_c, 1) + zsl(rhow_c, None, -1))
    zeros = torch.zeros_like(zsl(rhow_c, None, 1))
    rhow = torch.cat([zeros, rhow_int, zeros], dim=-3)
    return DycoreState(rho=rho, rhou=rhou, rhov=rhov, rhow=rhow,
                       rhot=var(IR_RHOT),
                       rhoq=v[..., IR_Q0:, :, :, :] * rho.unsqueeze(-4))
