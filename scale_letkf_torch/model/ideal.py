"""Idealized initial conditions: the balanced base state, the warm bubble
and initial ensemble perturbations.

Port of scale_letkf_tpu/model/ideal.py (the reference's scale-rm_init_ens
role for idealized runs; init_perturb.py's tapered random ρθ noise). The
profiles are host numpy, as in the reference; the states are tensors on the
device the caller names. `perturb_ensemble` draws from a torch.Generator,
which cannot reproduce jax.random's numbers, so parity tests make their
perturbations with numpy instead.
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.constants import RD, CVDRY, PRE00
from scale_letkf_torch.model.dycore import DycoreState, hydrostatic_reference
from scale_letkf_torch.state import NQ

CPDRY = RD + CVDRY


def standard_theta_profile(nz: int, dz: float, theta0: float = 300.0,
                           dthdz: float = 0.004,
                           cz: np.ndarray | None = None) -> np.ndarray:
    """Weakly stable boundary-layer θ profile at cell centers."""
    z = (np.arange(nz) + 0.5) * dz if cz is None else np.asarray(cz)
    return theta0 + dthdz * z


def balanced_state(nz: int, ny: int, nx: int, dz: float,
                   theta_prof: np.ndarray | None = None,
                   qv_prof: np.ndarray | None = None,
                   dtype: torch.dtype = torch.float32,
                   cz: np.ndarray | None = None,
                   device: torch.device = torch.device("cpu")):
    """Hydrostatically balanced, horizontally uniform base state on
    `device`: (DycoreState, rho_ref, p_ref), the reference columns shaped
    (nz, 1, 1). p_ref is the EOS of the base ρθ, so the dry base state is
    exactly steady. cz: optional stretched cell-center heights."""
    if theta_prof is None:
        theta_prof = standard_theta_profile(nz, dz, cz=cz)
    rho1d, _ = hydrostatic_reference(theta_prof, dz, cz=cz)

    def column(prof):
        t = torch.as_tensor(np.asarray(prof)[:, None, None], dtype=dtype,
                            device=device)
        return t.expand(nz, ny, nx).contiguous()

    rho = column(rho1d)
    rhoq = torch.zeros((NQ, nz, ny, nx), dtype=dtype, device=device)
    if qv_prof is not None:
        rhoq[0] = column(qv_prof) * rho
    s = DycoreState(
        rho=rho, rhou=torch.zeros_like(rho), rhov=torch.zeros_like(rho),
        rhow=torch.zeros((nz + 1, ny, nx), dtype=dtype, device=device),
        rhot=column(rho1d * theta_prof), rhoq=rhoq)
    p_ref_eos = PRE00 * (rho1d * theta_prof * RD / PRE00) ** (CPDRY / CVDRY)
    return (s, torch.as_tensor(rho1d[:, None, None], dtype=dtype,
                               device=device),
            torch.as_tensor(p_ref_eos[:, None, None], dtype=dtype,
                            device=device))


def add_warm_bubble(s: DycoreState, dz: float, dx: float, dy: float,
                    amplitude: float = 2.0, center: tuple | None = None,
                    radius: tuple = (4.0e3, 4.0e3, 2.0e3)) -> DycoreState:
    """Gaussian-cosine θ perturbation (classic warm-bubble test), added at
    constant ρ: ρθ += ρ·Δθ."""
    nz, ny, nx = s.rho.shape[-3:]
    if center is None:
        center = (nx * dx / 2, ny * dy / 2, 2.0e3)
    x = (np.arange(nx) + 0.5) * dx
    y = (np.arange(ny) + 0.5) * dy
    z = (np.arange(nz) + 0.5) * dz
    rx = (x - center[0]) / radius[0]
    ry = (y - center[1]) / radius[1]
    rz = (z - center[2]) / radius[2]
    r = np.sqrt(rx[None, None, :] ** 2 + ry[None, :, None] ** 2
                + rz[:, None, None] ** 2)
    dtheta = amplitude * np.cos(0.5 * np.pi * np.minimum(r, 1.0)) ** 2
    dtheta = torch.as_tensor(dtheta, dtype=s.rho.dtype, device=s.rho.device)
    return s._replace(rhot=s.rhot + s.rho * dtheta)


def perturb_ensemble(gen: torch.Generator, s: DycoreState, n_members: int,
                     amplitude: float = 0.5,
                     taper_top: float = 0.8) -> DycoreState:
    """Initial ensemble: smooth random ρθ perturbations per member, drawn
    from `gen` (on s's device). Returns a DycoreState with a leading member
    axis on every field."""
    nz, ny, nx = s.rho.shape
    noise = torch.randn((n_members, nz, ny, nx), generator=gen,
                        dtype=s.rhot.dtype, device=s.rhot.device)
    # 1-2-1 smoothing, 3 passes in each direction, so the members carry
    # spatially (and vertically) correlated perturbations
    for dim in (-1, -2):
        for _ in range(3):
            noise = 0.25 * (torch.roll(noise, 1, dim) + torch.roll(noise, -1, dim)) \
                + 0.5 * noise
    for _ in range(3):
        up = torch.cat([noise[:, :1], noise[:, :-1]], dim=1)
        dn = torch.cat([noise[:, 1:], noise[:, -1:]], dim=1)
        noise = 0.25 * (up + dn) + 0.5 * noise
    # vertical taper: no perturbation at the model top
    z_frac = (np.arange(nz) + 0.5) / nz
    taper = np.where(z_frac > taper_top, (1.0 - z_frac) / (1.0 - taper_top),
                     1.0)
    noise = noise * torch.as_tensor(taper[:, None, None], dtype=noise.dtype,
                                    device=noise.device)
    ens = DycoreState(*(f.expand(n_members, *f.shape).contiguous()
                        for f in s))
    return ens._replace(rhot=ens.rhot + amplitude * ens.rho * noise)
