"""Split-explicit (HEVI) time integration of the compressible core.

Port of scale_letkf_tpu/model/dycore_si.py: the Wicker–Skamarock (2002)
scheme around the explicit core in dycore.py. Each RK3 stage evaluates the
full slow tendencies at the stage state — dycore.tendencies (on CUDA
tensors the two hand-written kernels), or with terrain metrics
terrain.tendencies_terrain (plain PyTorch on either device) — then integrates n acoustic
substeps linearized around it: horizontal momenta explicit; w, ρ and ρθ
implicit in the vertical, one tridiagonal solve per column (Thomas
algorithm). p'' = c²·(ρθ)'' with c² = (cp/cv)·p*/(ρθ)*. The acoustic step
is limited only by the horizontal sound CFL.

The substeps and the Thomas solve are plain PyTorch, as they were plain XLA
in the reference: each substep is ~40 full-field passes plus 2·(nz−1)
small sequential launches of the solve. Fields carry leading member axes;
the solve runs along z (axis −3).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from scale_letkf_torch.constants import RD, CVDRY, GRAV
from scale_letkf_torch.model.dycore import (
    DycoreConfig, DycoreState, VGrid, metric, mixing_ratios, moist_pressure,
    rayleigh_sponge, roll_x, roll_y, tendencies, zsl,
)
from scale_letkf_torch.model.terrain import (
    TerrainMetrics, tendencies_terrain,
)
from scale_letkf_torch.utils.timing import Timer, maybe_section

CPDRY = RD + CVDRY
BETA_OFF = 0.55   # implicit off-centering (slightly > 0.5 damps acoustics)


@dataclass(frozen=True)
class SplitConfig:
    dtau: float       # acoustic small step [s]
    beta: float = BETA_OFF


def _thomas_solve(a, b, c, d, dim: int = 0):
    """Tridiagonal solve along `dim`, vectorized over the other axes:
    b x + a x_{k-1} + c x_{k+1} = d, with a the sub-diagonal (a[0] unused),
    b the diagonal, c the super-diagonal (c[-1] unused). a, b, c broadcast
    to d's shape. A forward and a backward Python loop over the levels (the
    reference's two lax.scans)."""
    a, b, c, d = (t.movedim(dim, 0) for t in torch.broadcast_tensors(a, b, c, d))
    n = d.shape[0]
    cps = torch.empty_like(d)
    dps = torch.empty_like(d)
    cp_prev = torch.zeros_like(d[0])
    dp_prev = torch.zeros_like(d[0])
    for k in range(n):
        denom = b[k] - a[k] * cp_prev
        cp_prev = torch.div(c[k], denom, out=cps[k])
        dp_prev = torch.div(d[k] - a[k] * dp_prev, denom, out=dps[k])
    xs = torch.empty_like(d)
    x_next = torch.zeros_like(d[0])
    for k in range(n - 1, -1, -1):
        x_next = torch.sub(dps[k], cps[k] * x_next, out=xs[k])
    return xs.movedim(0, dim)


def acoustic_coeffs(s_stage: DycoreState, cfg: DycoreConfig,
                    split: SplitConfig, dtau: float,
                    vg: VGrid | None = None) -> dict:
    """The column operators of the acoustic system linearized around
    s_stage, for substeps of dτ: the metric (dzc, dzf) and its products
    with dτ·β (abf at interior faces, abc at centers), c², θ at centers and
    faces, and the implicit vertical solve's tridiagonal coefficients
    (a_sub, b_diag, c_sup at the interior faces k = 1..nz-1). Everything
    here is column-local, so the undecomposed substeps and those of a
    halo-extended block (parallel/halo.py) share it."""
    vg = metric(s_stage, cfg, vg)
    dzc, dzf = vg.dzc, vg.dzf
    beta = split.beta
    rho0 = s_stage.rho
    rhot0 = s_stage.rhot
    p0 = moist_pressure(rhot0, mixing_ratios(s_stage))
    theta0 = rhot0 / rho0
    # c² = ∂p/∂(ρθ) = (cp/cv)·p/(ρθ) (dry γ on the moist p)
    c2 = (CPDRY / CVDRY) * p0 / rhot0
    del p0
    theta_face = torch.cat([zsl(theta0, None, 1),
                            0.5 * (zsl(theta0, 1) + zsl(theta0, None, -1)),
                            zsl(theta0, -1)], dim=-3)

    g_half = dtau * beta * GRAV * 0.5
    abf = dtau * beta / dzf                     # at interior faces
    abc = dtau * beta / dzc                     # at centers
    abc_up = abc[1:]      # center k (above face k)
    abc_dn = abc[:-1]     # center k-1

    # tridiagonal coefficients at the interior faces k = 1..nz-1
    c2_up = zsl(c2, 1)
    c2_dn = zsl(c2, None, -1)
    tf_mid = zsl(theta_face, 1, -1)
    tf_up = zsl(theta_face, 2)
    tf_dn = zsl(theta_face, None, -2)
    return dict(
        dzc=dzc, dzf=dzf, abf=abf, abc=abc, c2=c2, c2_up=c2_up, c2_dn=c2_dn,
        theta0=theta0, theta_face=theta_face, g_half=g_half,
        b_diag=(1.0 + abf * tf_mid * (c2_up * abc_up + c2_dn * abc_dn)
                + g_half * (abc_up - abc_dn)),
        c_sup=-abf * c2_up * abc_up * tf_up - g_half * abc_up,
        a_sub=-abf * c2_dn * abc_dn * tf_dn + g_half * abc_dn)


def acoustic_column(co: dict, drho, drhow, drhot, dp, div_h, div_h_th,
                    slow: DycoreState, dtau: float, beta: float):
    """The vertical part of one acoustic substep, column by column, after
    the horizontal momenta: the explicit ρ'' and ρθ'' (with the (1-β) old
    vertical flux and the horizontal flux divergences div_h, div_h_th of the
    new momenta), the implicit solve for ρw'' at the interior faces, and the
    implicit corrections. co: acoustic_coeffs. Returns (ρ'', ρw'', ρθ'')."""
    dzc, dzf, abf, abc = co["dzc"], co["dzf"], co["abf"], co["abc"]
    c2_up, c2_dn, theta_face = co["c2_up"], co["c2_dn"], co["theta_face"]
    g_half = co["g_half"]
    # explicit parts of ρ'' and ρθ'' (with the (1-β) old vertical flux)
    w_old = drhow
    dflux_w = (zsl(w_old, 1) - zsl(w_old, None, -1)) / dzc
    wth_old = w_old * theta_face
    dflux_wth = (zsl(wth_old, 1) - zsl(wth_old, None, -1)) / dzc
    rho_exp = (drho + dtau * (slow.rho - div_h)
               - dtau * (1 - beta) * dflux_w)
    rhot_exp = (drhot + dtau * (slow.rhot - div_h_th)
                - dtau * (1 - beta) * dflux_wth)

    # right-hand side at the interior faces
    dp_z = (zsl(dp, 1) - zsl(dp, None, -1)) / dzf
    rho_face_old = 0.5 * (zsl(drho, 1) + zsl(drho, None, -1))
    d_rhs = (zsl(w_old, 1, -1)
             + dtau * zsl(slow.rhow, 1, -1)
             - dtau * (1 - beta) * (dp_z + GRAV * rho_face_old)
             - abf * (c2_up * zsl(rhot_exp, 1)
                      - c2_dn * zsl(rhot_exp, None, -1))
             - g_half * (zsl(rho_exp, 1) + zsl(rho_exp, None, -1)))

    w_new_int = _thomas_solve(co["a_sub"], co["b_diag"], co["c_sup"], d_rhs,
                              dim=-3)
    zeros = torch.zeros_like(zsl(drhow, None, 1))
    w_new = torch.cat([zeros, w_new_int, zeros], dim=-3)

    # implicit corrections to ρ'' and ρθ''
    drho = rho_exp - abc * (zsl(w_new, 1) - zsl(w_new, None, -1))
    wth_new = w_new * theta_face
    drhot = rhot_exp - abc * (zsl(wth_new, 1) - zsl(wth_new, None, -1))
    return drho, w_new, drhot


def acoustic_substeps(s_start: DycoreState, s_stage: DycoreState,
                      slow: DycoreState, cfg: DycoreConfig,
                      split: SplitConfig, n_steps: int, dt_stage: float,
                      vg: VGrid | None = None) -> DycoreState:
    """Integrate the acoustic system for dt_stage = n_steps·dτ, linearized
    around s_stage, from s_start; returns the updated full state. vg:
    stretched metric (None ⇒ uniform cfg.dz): dzc divides the flux
    divergences at centers, dzf the gradients at interior faces. The
    horizontal neighbours are rolls here; parallel/halo.py steps a block
    with halo exchanges in their place and shares acoustic_coeffs and
    acoustic_column."""
    lateral = cfg.lateral
    dx, dy = cfg.dx, cfg.dy
    dtau = dt_stage / n_steps
    co = acoustic_coeffs(s_stage, cfg, split, dtau, vg)
    c2, theta0 = co["c2"], co["theta0"]
    rho0, rhot0 = s_stage.rho, s_stage.rhot

    def rx(f, n):
        return roll_x(f, n, lateral)

    def ry(f, n):
        return roll_y(f, n, lateral)

    theta_xf = 0.5 * (theta0 + rx(theta0, 1))
    theta_yf = 0.5 * (theta0 + ry(theta0, 1))
    drho = s_start.rho - rho0
    drhou = s_start.rhou - s_stage.rhou
    drhov = s_start.rhov - s_stage.rhov
    drhow = s_start.rhow - s_stage.rhow
    drhot = s_start.rhot - rhot0
    for _ in range(n_steps):
        # pressure perturbation at the current acoustic time
        dp = c2 * drhot

        # explicit horizontal momenta
        drhou = drhou + dtau * (-((rx(dp, 1) - dp) / dx) + slow.rhou)
        drhov = drhov + dtau * (-((ry(dp, 1) - dp) / dy) + slow.rhov)

        # horizontal mass and θ flux divergence of the new momenta
        div_h = ((drhou - rx(drhou, -1)) / dx
                 + (drhov - ry(drhov, -1)) / dy)
        u_th = drhou * theta_xf
        v_th = drhov * theta_yf
        div_h_th = ((u_th - rx(u_th, -1)) / dx + (v_th - ry(v_th, -1)) / dy)

        drho, drhow, drhot = acoustic_column(co, drho, drhow, drhot, dp,
                                             div_h, div_h_th, slow, dtau,
                                             split.beta)

    # tracers advance with the slow tendency only (advected by the stage
    # winds; acoustic modes do not transport tracers)
    return DycoreState(rho=rho0 + drho, rhou=s_stage.rhou + drhou,
                       rhov=s_stage.rhov + drhov, rhow=s_stage.rhow + drhow,
                       rhot=rhot0 + drhot,
                       rhoq=s_start.rhoq + dt_stage * slow.rhoq)


def rk3_step_si(s: DycoreState, cfg: DycoreConfig, split: SplitConfig,
                rho_ref, p_ref, z_center, n_small: int,
                vg: VGrid | None = None,
                metrics: TerrainMetrics | None = None,
                timer: Timer | None = None) -> DycoreState:
    """One split-explicit RK3 step of length cfg.dt with n_small acoustic
    substeps in the final stage (the earlier stages n_small//3 and
    n_small//2). metrics: terrain metrics — the slow tendencies then carry
    the full terrain-following metric terms (terrain.tendencies_terrain)
    while the acoustic operator stays flat-metric, as in the reference (the
    acoustic deviations are linearized around the stage state without
    Gx/Gy corrections; J enters only through the slow forcing). timer:
    optional sections `tendencies`, `acoustic` and `sponge`."""
    dt = cfg.dt

    def stage(s_from, dt_stage, ns):
        with maybe_section(timer, "tendencies"):
            slow = (tendencies(s_from, cfg, rho_ref, p_ref, vg)
                    if metrics is None else tendencies_terrain(
                        s_from, cfg, rho_ref, p_ref, metrics, vg))
        with maybe_section(timer, "acoustic"):
            return acoustic_substeps(s, s_from, slow, cfg, split, ns,
                                     dt_stage, vg)

    s1 = stage(s, dt / 3.0, max(1, n_small // 3))
    s2 = stage(s1, dt / 2.0, max(1, n_small // 2))
    s3 = stage(s2, dt, n_small)
    with maybe_section(timer, "sponge"):
        return rayleigh_sponge(s3, s, cfg, z_center, dt)


def integrate_si(s, cfg, split, rho_ref, p_ref, z_center, nsteps, n_small,
                 vg: VGrid | None = None,
                 metrics: TerrainMetrics | None = None,
                 timer: Timer | None = None):
    """nsteps split-explicit steps."""
    for _ in range(nsteps):
        s = rk3_step_si(s, cfg, split, rho_ref, p_ref, z_center, n_small, vg,
                        metrics, timer)
    return s
