"""Whole dynamics tendency of the explicit core in one pass.

Port of the TPU kernel scale_letkf_tpu/ops/pallas_tendency.py
dyn_tendencies_pallas (driven by its tendencies_fused): drho, drhou, drhov,
drhow and drhot — continuity, UD3 ρθ advection, 2nd-order staggered
momentum advection, the pressure gradient of p′, buoyancy, ∇⁴
hyperdiffusion and divergence damping — with p′ computed outside (one
plain pass: moist_pressure). The port's kernel (csrc/dyn_tendency.cu)
takes the vertical metric as per-level arrays (dzc at centers, dzf at
interior faces), so it runs on the stretched levels of the shipped
configurations, and both lateral modes: periodic, and open (edge-clamped
x/y, the mode of a nested child, which the reference computes in plain
XLA); the Pallas kernel took a scalar dz and periodic x/y.

`dyn_tendencies_plain` is the same function in plain PyTorch (the kernel's
yardstick and the CPU path), with both lateral modes; `dyn_tendencies`
picks one by the device. model/dycore.py tendencies composes p′, the
dynamics fields and the tracers (ops/stencil.py), as the reference's
tendencies_fused does.
"""

from __future__ import annotations

import torch

from scale_letkf_torch.constants import GRAV
from scale_letkf_torch.ops.finite_diff import hyperdiff4, roll_x, roll_y, zsl
from scale_letkf_torch.ops.stencil import (
    _check_cuda_f32, lateral_flag, scalar_tendency,
)
from scale_letkf_torch.utils import kernels


def dyn_tendencies_plain(rho, rhou, rhov, rhow, rhot, p_pert, rho_ref, dzc,
                         dzf, dx: float, dy: float, kdiff4: float,
                         divdmp: float, dt: float,
                         lateral: str = "periodic"):
    """(drho, drhou, drhov, drhow, drhot) of dycore.tendencies. Fields
    (..., nz, ny, nx), rhow (..., nz+1, ny, nx); rho_ref, dzc (nz, 1, 1);
    dzf (nz-1, 1, 1). divdmp = 0 switches divergence damping off."""
    def rx(f, n):
        return roll_x(f, n, lateral)

    def ry(f, n):
        return roll_y(f, n, lateral)

    def div_center(fx_, fy_, fw_full):
        ddx = (fx_ - rx(fx_, -1)) / dx
        ddy = (fy_ - ry(fy_, -1)) / dy
        ddz = (zsl(fw_full, 1) - zsl(fw_full, None, -1)) / dzc
        return ddx + ddy + ddz

    fx, fy = rhou, rhov
    div = div_center(fx, fy, rhow)
    drho = -div
    drhot = scalar_tendency(rhot, rho, fx, fy, rhow, dzc, dx, dy, kdiff4,
                            lateral)

    # u-momentum at x-face i+1/2: x-flux at centers, y-flux at corners,
    # z-flux at the x-face's z-faces
    u_face = rhou / (0.5 * (rho + rx(rho, 1)))
    v_face = rhov / (0.5 * (rho + ry(rho, 1)))

    def zface_avg(f):
        """Center field → its nz+1 z-faces, edge values copied."""
        return torch.cat([zsl(f, None, 1), 0.5 * (zsl(f, 1) + zsl(f, None, -1)),
                          zsl(f, -1)], dim=-3)

    def zero_ends(f):
        zeros = torch.zeros_like(zsl(f, None, 1))
        return torch.cat([zeros, zsl(f, 1, -1), zeros], dim=-3)

    fx_c = 0.5 * (fx + rx(fx, -1))
    adv_u_x = fx_c * 0.5 * (u_face + rx(u_face, -1))
    dadv_u = (rx(adv_u_x, 1) - adv_u_x) / dx
    fy_corner = 0.5 * (fy + rx(fy, 1))
    adv_u_y = fy_corner * 0.5 * (u_face + ry(u_face, 1))
    dadv_u = dadv_u + (adv_u_y - ry(adv_u_y, -1)) / dy
    adv_u_z = zero_ends(0.5 * (rhow + rx(rhow, 1)) * zface_avg(u_face))
    dadv_u = dadv_u + (zsl(adv_u_z, 1) - zsl(adv_u_z, None, -1)) / dzc
    dpx = (rx(p_pert, 1) - p_pert) / dx
    drhou = -dadv_u - dpx + hyperdiff4(rhou, kdiff4, lateral)

    fy_c = 0.5 * (fy + ry(fy, -1))
    adv_v_y = fy_c * 0.5 * (v_face + ry(v_face, -1))
    dadv_v = (ry(adv_v_y, 1) - adv_v_y) / dy
    fx_corner = 0.5 * (fx + ry(fx, 1))
    adv_v_x = fx_corner * 0.5 * (v_face + rx(v_face, 1))
    dadv_v = dadv_v + (adv_v_x - rx(adv_v_x, -1)) / dx
    adv_v_z = zero_ends(0.5 * (rhow + ry(rhow, 1)) * zface_avg(v_face))
    dadv_v = dadv_v + (zsl(adv_v_z, 1) - zsl(adv_v_z, None, -1)) / dzc
    dpy = (ry(p_pert, 1) - p_pert) / dy
    drhov = -dadv_v - dpy + hyperdiff4(rhov, kdiff4, lateral)

    # w-momentum at the interior z-faces 1..nz-1
    w_full = rhow / zface_avg(rho)                  # 0 at the rigid faces
    w_face = zsl(w_full, 1, -1)
    fw_c = 0.5 * (zsl(rhow, 1) + zsl(rhow, None, -1))
    adv_w_z = fw_c * 0.5 * (zsl(w_full, 1) + zsl(w_full, None, -1))
    dadv_w = (zsl(adv_w_z, 1) - zsl(adv_w_z, None, -1)) / dzf
    fx_zface = 0.5 * (zsl(fx, 1) + zsl(fx, None, -1))
    adv_w_x = fx_zface * 0.5 * (w_face + rx(w_face, 1))
    dadv_w = dadv_w + (adv_w_x - rx(adv_w_x, -1)) / dx
    fy_zface = 0.5 * (zsl(fy, 1) + zsl(fy, None, -1))
    adv_w_y = fy_zface * 0.5 * (w_face + ry(w_face, 1))
    dadv_w = dadv_w + (adv_w_y - ry(adv_w_y, -1)) / dy
    dpz = (zsl(p_pert, 1) - zsl(p_pert, None, -1)) / dzf
    rho_pert = rho - rho_ref
    buoy = -(0.5 * (zsl(rho_pert, 1) + zsl(rho_pert, None, -1))) * GRAV
    drhow_int = (-dadv_w - dpz + buoy
                 + hyperdiff4(zsl(rhow, 1, -1), kdiff4, lateral))

    # divergence damping (acoustic filter): ∂ρu/∂t += α ∂D/∂x, D = ∇·(ρu)
    if divdmp > 0:
        alpha = divdmp * dx * dx / dt
        drhou = drhou + alpha * (rx(div, 1) - div) / dx
        drhov = drhov + alpha * (ry(div, 1) - div) / dy
        alpha_z = divdmp * dzf * dzf / dt
        drhow_int = drhow_int + alpha_z * (zsl(div, 1)
                                           - zsl(div, None, -1)) / dzf
    zeros = torch.zeros_like(zsl(rhow, None, 1))
    drhow = torch.cat([zeros, drhow_int, zeros], dim=-3)
    return drho, drhou, drhov, drhow, drhot


def dyn_tendencies_kernel(rho, rhou, rhov, rhow, rhot, p_pert, rho_ref, dzc,
                          dzf, dx: float, dy: float, kdiff4: float,
                          divdmp: float, dt: float,
                          lateral: str = "periodic"):
    """dyn_tendencies_plain's contract on the CUDA kernel: fields (B, nz,
    ny, nx), rhow (B, nz+1, ny, nx), rho_ref and dzc (nz,) or (nz, 1, 1),
    dzf (nz-1,) or (nz-1, 1, 1), x/y periodic or open; one launch on the
    current stream, no synchronisation. Raises on what the kernel does not
    take and on a non-zero launch status."""
    if not rho.is_cuda:
        raise ValueError("dyn_tendencies_kernel takes CUDA tensors")
    open_ = lateral_flag(lateral)
    rho_ref, dzc, dzf = (t.reshape(-1) for t in (rho_ref, dzc, dzf))
    _check_cuda_f32("dyn_tendencies_kernel", rho.device, rho=rho, rhou=rhou,
                    rhov=rhov, rhow=rhow, rhot=rhot, p_pert=p_pert,
                    rho_ref=rho_ref, dzc=dzc, dzf=dzf)
    if rho.dim() != 4:
        raise ValueError(f"dyn_tendencies_kernel takes (B, nz, ny, nx) "
                         f"fields, got {tuple(rho.shape)}")
    B, nz, ny, nx = rho.shape
    if (any(t.shape != rho.shape for t in (rhou, rhov, rhot, p_pert))
            or rhow.shape != (B, nz + 1, ny, nx) or rho_ref.shape != (nz,)
            or dzc.shape != (nz,) or dzf.shape != (max(nz - 1, 0),)):
        raise ValueError("dyn_tendencies_kernel: inconsistent shapes")
    outs = tuple(torch.empty_like(t) for t in (rho, rhou, rhov, rhow, rhot))
    if rho.numel() == 0:
        return outs
    if nz < 2 or ny < 2 or nx < 2:
        raise ValueError(f"dyn_tendencies_kernel takes nz, ny, nx >= 2, got "
                         f"{nz}, {ny}, {nx}")
    alpha_h = divdmp * dx * dx / dt if divdmp > 0 else 0.0
    lib = kernels.load("dyn_tendency")
    with torch.cuda.device(rho.device):
        stream = torch.cuda.current_stream(rho.device).cuda_stream
        status = lib.dyn_tendency_launch(
            rho.data_ptr(), rhou.data_ptr(), rhov.data_ptr(), rhow.data_ptr(),
            rhot.data_ptr(), p_pert.data_ptr(), rho_ref.data_ptr(),
            dzc.data_ptr(), dzf.data_ptr(), *(o.data_ptr() for o in outs),
            B, nz, ny, nx, dx, dy, kdiff4, alpha_h, max(divdmp, 0.0), dt,
            GRAV, open_, stream)
    if status != 0:
        raise RuntimeError(f"dyn_tendency kernel launch failed: CUDA error "
                           f"{status}")
    kernels.LAUNCHES["dyn_tendency"] += 1
    return outs


def dyn_tendencies(rho, rhou, rhov, rhow, rhot, p_pert, rho_ref, dzc, dzf,
                   dx: float, dy: float, kdiff4: float, divdmp: float,
                   dt: float, lateral: str = "periodic"):
    """(drho, drhou, drhov, drhow, drhot), x/y periodic or open: CUDA
    tensors (B, ...) go through the kernel, CPU tensors through
    dyn_tendencies_plain."""
    args = (rho, rhou, rhov, rhow, rhot, p_pert, rho_ref, dzc, dzf, dx, dy,
            kdiff4, divdmp, dt, lateral)
    if rho.is_cuda:
        return dyn_tendencies_kernel(*args)
    if rho.device.type == "cpu":
        return dyn_tendencies_plain(*args)
    raise ValueError(f"dyn_tendencies has no path for {rho.device}")

