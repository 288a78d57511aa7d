"""Split-explicit (HEVI) time integration of the compressible core.

Port of scale_letkf_tpu/model/dycore_si.py: the Wicker–Skamarock (2002)
scheme around the explicit core in dycore.py. Each RK3 stage evaluates the
full slow tendencies at the stage state — dycore.tendencies (on CUDA
tensors the two hand-written kernels), or with terrain metrics
terrain.tendencies_terrain (on CUDA tensors kernel #5) — then integrates
n acoustic substeps linearized around it: horizontal momenta explicit; w, ρ
and ρθ implicit in the vertical, one tridiagonal solve per column (Thomas
algorithm). p'' = c²·(ρθ)'' with c² = (cp/cv)·p*/(ρθ)*. The acoustic step
is limited only by the horizontal sound CFL.

The device decides the substeps' path, as it does the tendencies': on CUDA
tensors every substep is one launch of the hand-written kernel
csrc/acoustic_substep.cu (acoustic_substeps_kernel: the horizontal momenta,
the explicit ρ'' and ρθ'', the Thomas solve and the implicit corrections
of all columns; the same arithmetic as the plain path, operation for
operation), on CPU tensors the plain PyTorch loop
(acoustic_substeps_plain: ~40 full-field passes a substep plus 2·(nz−1)
sequential steps of the solve, as they were plain XLA in the reference).
parallel/halo.py steps a process grid's blocks with the plain pieces
(acoustic_coeffs, acoustic_column) on either device. Fields carry leading
member axes; the solve runs along z (axis −3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from scale_letkf_torch.constants import RD, CVDRY, GRAV
from scale_letkf_torch.model.dycore import (
    DycoreConfig, DycoreState, VGrid, metric, mixing_ratios, moist_pressure,
    rayleigh_sponge, roll_x, roll_y, tendencies, zsl,
)
from scale_letkf_torch.model.terrain import (
    TerrainMetrics, tendencies_terrain,
)
from scale_letkf_torch.ops.stencil import _check_cuda_f32, lateral_flag
from scale_letkf_torch.utils import kernels
from scale_letkf_torch.utils.timing import Timer, maybe_section

CPDRY = RD + CVDRY
BETA_OFF = 0.55   # implicit off-centering (slightly > 0.5 damps acoustics)
# levels the acoustic kernel takes: its per-column stacks (4·nz − 2 floats
# a thread, 64 threads a block) must fit one block's shared memory
ACOUSTIC_NZ_MAX = 128


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


def stage_theta_c2(s_stage: DycoreState, p0: torch.Tensor | None = None):
    """θ = ρθ/ρ and c² = ∂p/∂(ρθ) = (cp/cv)·p/(ρθ) (dry γ on the moist p)
    of the stage state: the acoustic system's fields. p0: the stage's moist
    pressure where the caller has it."""
    rhot0 = s_stage.rhot
    if p0 is None:
        p0 = moist_pressure(rhot0, mixing_ratios(s_stage))
    return rhot0 / s_stage.rho, (CPDRY / CVDRY) * p0 / rhot0


def acoustic_coeffs(s_stage: DycoreState, cfg: DycoreConfig,
                    split: SplitConfig, dtau: float,
                    vg: VGrid | None = None,
                    p0: torch.Tensor | None = None) -> dict:
    """The column operators of the acoustic system linearized around
    s_stage, for substeps of dτ: the metric (dzc, dzf) and its products
    with dτ·β (abf at interior faces, abc at centers), c², θ at centers and
    faces, and the implicit vertical solve's tridiagonal coefficients
    (a_sub, b_diag, c_sup at the interior faces k = 1..nz-1). Everything
    here is column-local, so the undecomposed substeps and those of a
    halo-extended block (parallel/halo.py) share it. p0: the stage's moist
    pressure where the caller has it."""
    vg = metric(s_stage, cfg, vg)
    dzc, dzf = vg.dzc, vg.dzf
    beta = split.beta
    theta0, c2 = stage_theta_c2(s_stage, p0)
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


def acoustic_substeps_plain(s_start: DycoreState, s_stage: DycoreState,
                            slow: DycoreState, cfg: DycoreConfig,
                            split: SplitConfig, n_steps: int,
                            dt_stage: float,
                            vg: VGrid | None = None,
                            p0: torch.Tensor | None = None) -> DycoreState:
    """acoustic_substeps in plain PyTorch (the CPU path and the kernel's
    yardstick). The horizontal neighbours are rolls here; parallel/halo.py
    steps a block with halo exchanges in their place and shares
    acoustic_coeffs and acoustic_column."""
    lateral = cfg.lateral
    dx, dy = cfg.dx, cfg.dy
    dtau = dt_stage / n_steps
    co = acoustic_coeffs(s_stage, cfg, split, dtau, vg, p0)
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


def acoustic_substeps_kernel(s_start: DycoreState, s_stage: DycoreState,
                             slow: DycoreState, cfg: DycoreConfig,
                             split: SplitConfig, n_steps: int,
                             dt_stage: float,
                             vg: VGrid | None = None,
                             p0: torch.Tensor | None = None) -> DycoreState:
    """acoustic_substeps on the CUDA kernel (csrc/acoustic_substep.cu): one
    launch a substep on the current stream, no synchronisation. The first
    launch forms the deviations from s_start and s_stage, the last adds
    them to s_stage; between launches they ping-pong between two buffer
    sets (the kernel's neighbours read old values). θ and c² of the stage
    are plain passes (from p0, the stage's moist pressure, where the caller
    has it), the level tables tiny ones, each as acoustic_coeffs computes
    it. Fields (..., nz, ny, nx), ρw (..., nz+1, ny, nx), float32,
    contiguous, on one device; the leading axes run as one batch (a single
    member as a batch of one); 2 ≤ nz ≤ ACOUSTIC_NZ_MAX; x/y periodic or
    open. Raises on what the kernel does not take and on a non-zero launch
    status."""
    if not s_stage.rho.is_cuda:
        raise ValueError("acoustic_substeps_kernel takes CUDA tensors")
    open_ = lateral_flag(cfg.lateral)
    dev = s_stage.rho.device
    fields = {f"{w}.{n}": t for w, st in (("s_start", s_start),
                                          ("s_stage", s_stage),
                                          ("slow", slow))
              for n, t in zip(DycoreState._fields[:5], st[:5])}
    _check_cuda_f32("acoustic_substeps_kernel", dev, **fields)
    shape = s_stage.rho.shape
    if len(shape) < 3:
        raise ValueError(f"acoustic_substeps_kernel takes (..., nz, ny, nx) "
                         f"fields, got {tuple(shape)}")
    *lead, nz, ny, nx = shape
    wshape = (*lead, nz + 1, ny, nx)
    for k, t in fields.items():
        if t.shape != (wshape if k.endswith("rhow") else shape):
            raise ValueError(f"acoustic_substeps_kernel: {k} has shape "
                             f"{tuple(t.shape)}, expected "
                             f"{wshape if k.endswith('rhow') else shape}")
    if not 2 <= nz <= ACOUSTIC_NZ_MAX:
        raise ValueError(f"acoustic_substeps_kernel takes 2 <= nz <= "
                         f"{ACOUSTIC_NZ_MAX}, got {nz}")
    if n_steps < 1:
        raise ValueError(f"acoustic_substeps_kernel: n_steps {n_steps} < 1")
    B = math.prod(lead)
    if not 1 <= B <= 65535 or (nz + 1) * ny * nx >= 2 ** 31:
        raise ValueError(f"acoustic_substeps_kernel takes 1 to 65535 "
                         f"members of fewer than 2**31 points each, got "
                         f"{B} × {nz + 1} × {ny} × {nx}")
    dtau = dt_stage / n_steps
    beta = split.beta
    vg = metric(s_stage, cfg, vg)
    theta0, c2 = stage_theta_c2(s_stage, p0)
    abf = dtau * beta / vg.dzf
    abc = dtau * beta / vg.dzc
    g_half = dtau * beta * GRAV * 0.5
    tables = [t.reshape(-1) for t in (
        vg.dzc, vg.dzf, abf, abc, g_half * abc,
        g_half * (abc[1:] - abc[:-1]))]
    _check_cuda_f32("acoustic_substeps_kernel", dev, c2=c2, theta=theta0,
                    **dict(zip(("dzc", "dzf", "abf", "abc", "ga", "gd"),
                               tables)))
    if (c2.shape != shape or tables[0].numel() != nz
            or tables[1].numel() != nz - 1):
        raise ValueError("acoustic_substeps_kernel: p0 or vg does not match "
                         "the state")
    # the reciprocals PyTorch multiplies by where the plain path divides a
    # CUDA tensor by dx, dy (a float32 1/float32(d))
    inv_dx = float(np.float32(1.0) / np.float32(cfg.dx))
    inv_dy = float(np.float32(1.0) / np.float32(cfg.dy))
    src = [f.data_ptr() for f in s_start[:5]]
    stage = [f.data_ptr() for f in s_stage[:5]]
    fixed = [f.data_ptr() for f in (*slow[:5], c2, theta0, *tables)]
    out = bufs = None
    lib = kernels.load("acoustic_substep")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for n in range(n_steps):
            last = n == n_steps - 1
            if last:
                out = [torch.empty_like(f) for f in s_stage[:5]]
            else:
                if bufs is None:
                    bufs = [[torch.empty_like(f) for f in s_stage[:5]]
                            for _ in range(min(2, n_steps - 1))]
                out = bufs[n % 2]
            status = lib.acoustic_substep_launch(
                *src, *stage, *fixed, *(o.data_ptr() for o in out), B, nz,
                ny, nx, dtau, dtau * (1 - beta), g_half, GRAV, inv_dx,
                inv_dy, open_, int(n == 0), int(last), stream)
            if status != 0:
                raise RuntimeError(f"acoustic_substep kernel launch failed: "
                                   f"CUDA error {status}")
            kernels.LAUNCHES["acoustic_substep"] += 1
            src = [o.data_ptr() for o in out]
    return DycoreState(*out, rhoq=s_start.rhoq + dt_stage * slow.rhoq)


def acoustic_substeps(s_start: DycoreState, s_stage: DycoreState,
                      slow: DycoreState, cfg: DycoreConfig,
                      split: SplitConfig, n_steps: int, dt_stage: float,
                      vg: VGrid | None = None,
                      p0: torch.Tensor | None = None) -> DycoreState:
    """Integrate the acoustic system for dt_stage = n_steps·dτ, linearized
    around s_stage, from s_start; returns the updated full state. vg:
    stretched metric (None ⇒ uniform cfg.dz): dzc divides the flux
    divergences at centers, dzf the gradients at interior faces. p0: the
    stage's moist pressure where the caller has it (rk3_step_si: the one
    its slow tendencies used). CUDA tensors go through the kernel
    (acoustic_substeps_kernel, one launch a substep), CPU tensors through
    acoustic_substeps_plain."""
    args = (s_start, s_stage, slow, cfg, split, n_steps, dt_stage, vg, p0)
    if s_stage.rho.is_cuda:
        return acoustic_substeps_kernel(*args)
    if s_stage.rho.device.type == "cpu":
        return acoustic_substeps_plain(*args)
    raise ValueError(f"acoustic_substeps has no path for "
                     f"{s_stage.rho.device}")


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
            # the stage's moist pressure, for its p′ and its acoustic c²
            p = moist_pressure(s_from.rhot, mixing_ratios(s_from))
            slow = (tendencies(s_from, cfg, rho_ref, p_ref, vg, p)
                    if metrics is None else tendencies_terrain(
                        s_from, cfg, rho_ref, p_ref, metrics, vg, p))
        with maybe_section(timer, "acoustic"):
            return acoustic_substeps(s, s_from, slow, cfg, split, ns,
                                     dt_stage, vg, p)

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
