"""Full physics suite driver: microphysics + surface/PBL + radiation.

Port of scale_letkf_tpu/model/physics_suite.py, composing the schemes as
SCALE-RM's time loop does: microphysics and surface + PBL every physics
step, radiation on its own longer interval (every rad_interval physics
steps, the cached tendency in between). The surface skin temperature is
prognostic (a slab of heat capacity slab_capacity; 0 holds it fixed).

Fields carry any leading member axes; the physics state holds one skin
temperature and one radiation cache per member. The step index is a Python
int here (the reference's traced counter under `lax.cond`). A timer, where
given, times the schemes as sections `microphysics`, `radiation` (the
recomputation and the cached tendency's use) and `pbl` (the surface layer,
the PBL diffusion and the slab).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from scale_letkf_torch.constants import PRE00, RD
from scale_letkf_torch.model.dycore import DycoreState, moist_pressure
from scale_letkf_torch.model.microphysics6 import nsw6_step
from scale_letkf_torch.model.pbl import pbl_step
from scale_letkf_torch.model.physics import CPDRY, kessler_step
from scale_letkf_torch.model.radiation import SIGMA_SB, radiation_step
from scale_letkf_torch.utils.timing import Timer, maybe_section


@dataclass(frozen=True)
class PhysicsConfig:
    """Physics-suite configuration (the PARAM_TIME physics-interval block
    and the scheme selectors of the reference config)."""
    mp_scheme: str = "kessler"     # "kessler" | "nsw6" | "none"
    use_pbl: bool = True
    use_radiation: bool = True
    rad_interval: int = 10         # physics steps between radiation calls
    mu0: float = 0.5               # cosine solar zenith angle (static sun)
    albedo: float = 0.2
    eps_sfc: float = 0.98
    z0: float = 1.0e-2             # roughness length (momentum) [m]
    z0h: float = 1.0e-3            # roughness length (heat) [m]
    beta: float = 1.0              # surface evaporation efficiency
    slab_capacity: float = 0.0     # surface heat capacity [J/m^2/K]; 0=fixed


class PhysicsState(NamedTuple):
    """Auxiliary prognostic physics state carried across steps."""
    tsfc: torch.Tensor          # surface skin temperature (..., ny, nx)
    drhot_rad: torch.Tensor     # cached radiation ρθ tendency
    rad_sfc: torch.Tensor       # cached (lw_down + sw_abs) at the surface


def skin_temperature(s: DycoreState) -> torch.Tensor:
    """The slab's cold start: the lowest-level air temperature θ·(p/p₀)^κ
    (..., ny, nx), computed on that level alone."""
    rho, rhot, rhoq = (f[..., :1, :, :] for f in (s.rho, s.rhot, s.rhoq))
    p = moist_pressure(rhot, rhoq / rho.unsqueeze(-4))
    return ((rhot / rho) * (p / PRE00) ** (RD / CPDRY))[..., 0, :, :]


def _radiation(s: DycoreState, tsfc, dz, pcfg: PhysicsConfig):
    """(ρθ tendency, surface radiative input lw_down + absorbed sw)."""
    rad = radiation_step(s, dz, pcfg.mu0, pcfg.albedo, pcfg.eps_sfc, tsfc)
    return rad.drhot, rad.lw_down_sfc + rad.sw_down_sfc * (1.0 - pcfg.albedo)


def init_physics_state(s: DycoreState, dz: float,
                       pcfg: PhysicsConfig) -> PhysicsState:
    """Skin temperature = lowest-level air temperature; the radiation cache
    primed with one call."""
    tsfc = skin_temperature(s)
    if pcfg.use_radiation:
        return PhysicsState(tsfc, *_radiation(s, tsfc, dz, pcfg))
    return PhysicsState(tsfc=tsfc, drhot_rad=torch.zeros_like(s.rhot),
                        rad_sfc=torch.zeros_like(tsfc))


def column_physics(s: DycoreState, phys: PhysicsState, step_index: int,
                   pcfg: PhysicsConfig, dt: float, dz: float,
                   timer: Timer | None = None
                   ) -> tuple[DycoreState, torch.Tensor, torch.Tensor]:
    """The microphysics and radiation of a physics step, each column on its
    own. Returns (state, drhot_rad, rad_sfc): radiation recomputed when
    step_index is a multiple of rad_interval, else the cache's. timer:
    optional sections `microphysics` and `radiation`."""
    with maybe_section(timer, "microphysics"):
        if pcfg.mp_scheme == "kessler":
            s = kessler_step(s, dt, dz)
        elif pcfg.mp_scheme == "nsw6":
            s = nsw6_step(s, dt, dz)

    drhot_rad, rad_sfc = phys.drhot_rad, phys.rad_sfc
    if pcfg.use_radiation:
        with maybe_section(timer, "radiation"):
            if step_index % pcfg.rad_interval == 0:
                drhot_rad, rad_sfc = _radiation(s, phys.tsfc, dz, pcfg)
            s = s._replace(rhot=s.rhot + dt * drhot_rad)
    return s, drhot_rad, rad_sfc


def slab_temperature(tsfc, rad_sfc, sfc, pcfg: PhysicsConfig, dt: float):
    """The slab skin temperature after dt of the net surface heating
    (radiation in, emission and the turbulent fluxes out); held when
    slab_capacity is 0."""
    if pcfg.slab_capacity > 0.0:
        net = (rad_sfc - pcfg.eps_sfc * SIGMA_SB * tsfc ** 4
               - sfc.shf - sfc.lhf)
        tsfc = tsfc + dt * net / pcfg.slab_capacity
    return tsfc


def physics_step(s: DycoreState, phys: PhysicsState, step_index: int,
                 pcfg: PhysicsConfig, dt: float, dz: float,
                 zc: torch.Tensor, lateral: str = "periodic",
                 timer: Timer | None = None
                 ) -> tuple[DycoreState, PhysicsState]:
    """One physics step of length `dt` (the physics interval, possibly
    several dynamics steps). Radiation is recomputed when step_index is a
    multiple of rad_interval, else its cache is reused. lateral: the
    dynamical core's lateral mode (the PBL's face ↔ center averages, the
    suite's one horizontal operation; parallel/halo.py physics_step_blocks
    is this step on a process grid's blocks). timer: optional sections
    `microphysics`, `radiation` and `pbl`."""
    s, drhot_rad, rad_sfc = column_physics(s, phys, step_index, pcfg, dt, dz,
                                           timer)
    tsfc = phys.tsfc
    if pcfg.use_pbl:
        with maybe_section(timer, "pbl"):
            res = pbl_step(s, dt, dz, zc, tsfc, z0=pcfg.z0, z0h=pcfg.z0h,
                           beta=pcfg.beta, lateral=lateral)
            s = res.state
            tsfc = slab_temperature(tsfc, rad_sfc, res.sfc, pcfg, dt)

    return s, PhysicsState(tsfc=tsfc, drhot_rad=drhot_rad, rad_sfc=rad_sfc)
