"""UD3 advective flux divergence of the tracers, −∇·(F φ) (+ ∇⁴ term).

Port of the TPU kernel scale_letkf_tpu/ops/pallas_stencil.py
adv_flux_divergence_pallas, which computed one tracer's −∇·(F φ) with
upwind UD3 faces, centered z-faces next to the rigid boundaries and
periodic x/y, on uniform dz. The port's kernel (csrc/adv_ud3.cu) covers all
NQ tracers of all members of a batch in one launch (replacing the
`vmap(scalar_tend)` of dycore.tendencies), takes the vertical metric as
per-level cell thicknesses dzc, divides ρq by ρ itself (φ = ρq/ρ, no
floor, as dycore.scalar_tend), adds the tracer's hyperdiffusion
−kdiff4 ∇⁴(ρq) when kdiff4 ≠ 0 (kdiff4 = 0 is the Pallas kernel's scope),
and takes both lateral modes: periodic, and open (edge-clamped x/y, which
the reference computes in plain XLA).

`adv_flux_divergence_plain` is the same function in plain PyTorch (the
kernel's yardstick and the CPU path); `scalar_tendency` is its one-field
form, which ops/tendency.py also uses for ρθ.
"""

from __future__ import annotations

import torch

from scale_letkf_torch.ops.finite_diff import (
    hyperdiff4, roll_x, roll_y, ud3_face_x, ud3_face_y, ud3_face_z, zsl,
)
from scale_letkf_torch.utils import kernels


def scalar_tendency(f, rho, fx, fy, fw, dzc, dx: float, dy: float,
                    kdiff4: float, lateral: str = "periodic"):
    """−∇·(F f/ρ) − kdiff4 ∇⁴f for a center field f with ρ, the face mass
    fluxes fx, fy (..., nz, ny, nx) and fw (..., nz+1, ny, nx) broadcastable
    to it, and dzc (nz, 1, 1). dycore.py scalar_tend."""
    phi = f / rho
    fl_x = fx * ud3_face_x(phi, fx, lateral)
    fl_y = fy * ud3_face_y(phi, fy, lateral)
    fw_int = zsl(fw, 1, -1)
    fl_z_int = fw_int * ud3_face_z(phi, fw_int)
    zeros = torch.zeros_like(zsl(fl_z_int, None, 1))
    fl_z = torch.cat([zeros, fl_z_int, zeros], dim=-3)
    ddx = (fl_x - roll_x(fl_x, -1, lateral)) / dx
    ddy = (fl_y - roll_y(fl_y, -1, lateral)) / dy
    ddz = (zsl(fl_z, 1) - zsl(fl_z, None, -1)) / dzc
    out = -(ddx + ddy + ddz)
    if kdiff4 != 0.0:
        out = out + hyperdiff4(f, kdiff4, lateral)
    return out


def adv_flux_divergence_plain(q, rho, fx, fy, fw, dzc, dx: float, dy: float,
                              kdiff4: float = 0.0,
                              lateral: str = "periodic"):
    """Tracer tendencies (..., NQ, nz, ny, nx) of densities q (same shape):
    −∇·(F q/ρ) − kdiff4 ∇⁴q with ρ, fx, fy (..., nz, ny, nx), fw (..., nz+1,
    ny, nx), dzc (nz, 1, 1)."""
    return scalar_tendency(q, rho.unsqueeze(-4), fx.unsqueeze(-4),
                           fy.unsqueeze(-4), fw.unsqueeze(-4), dzc, dx, dy,
                           kdiff4, lateral)


def _check_cuda_f32(name: str, device, **tensors):
    for k, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {k} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")


def lateral_flag(lateral: str) -> int:
    """The kernels' lateral argument: 1 for 'open', 0 for 'periodic'."""
    if lateral not in ("periodic", "open"):
        raise ValueError(f"unknown lateral mode {lateral!r} (valid: "
                         f"'periodic', 'open')")
    return int(lateral == "open")


def adv_flux_divergence_kernel(q, rho, fx, fy, fw, dzc, dx: float, dy: float,
                               kdiff4: float = 0.0,
                               lateral: str = "periodic"):
    """adv_flux_divergence_plain's contract on the CUDA kernel: q (B, NQ,
    nz, ny, nx), rho/fx/fy (B, nz, ny, nx), fw (B, nz+1, ny, nx), dzc (nz,)
    or (nz, 1, 1), x/y periodic or open; one launch on the current stream,
    no synchronisation. Raises on what the kernel does not take and on a
    non-zero launch status."""
    if not rho.is_cuda:
        raise ValueError("adv_flux_divergence_kernel takes CUDA tensors")
    open_ = lateral_flag(lateral)
    dzc = dzc.reshape(-1)
    _check_cuda_f32("adv_flux_divergence_kernel", rho.device, q=q, rho=rho,
                    fx=fx, fy=fy, fw=fw, dzc=dzc)
    if rho.dim() != 4 or q.dim() != 5:
        raise ValueError(f"adv_flux_divergence_kernel takes q (B, NQ, nz, "
                         f"ny, nx) and rho (B, nz, ny, nx), got "
                         f"{tuple(q.shape)} and {tuple(rho.shape)}")
    B, nz, ny, nx = rho.shape
    nq = q.shape[1]
    if (q.shape != (B, nq, nz, ny, nx) or fx.shape != rho.shape
            or fy.shape != rho.shape or fw.shape != (B, nz + 1, ny, nx)
            or dzc.shape != (nz,)):
        raise ValueError("adv_flux_divergence_kernel: inconsistent shapes "
                         f"q {tuple(q.shape)}, rho {tuple(rho.shape)}, fx "
                         f"{tuple(fx.shape)}, fy {tuple(fy.shape)}, fw "
                         f"{tuple(fw.shape)}, dzc {tuple(dzc.shape)}")
    if nz < 2 or ny < 2 or nx < 2:
        raise ValueError(f"adv_flux_divergence_kernel takes nz, ny, nx >= 2, "
                         f"got {nz}, {ny}, {nx}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = kernels.load("adv_ud3")
    with torch.cuda.device(rho.device):
        stream = torch.cuda.current_stream(rho.device).cuda_stream
        status = lib.adv_ud3_launch(
            q.data_ptr(), rho.data_ptr(), fx.data_ptr(), fy.data_ptr(),
            fw.data_ptr(), dzc.data_ptr(), out.data_ptr(),
            B, nq, nz, ny, nx, dx, dy, kdiff4, open_, stream)
    if status != 0:
        raise RuntimeError(f"adv_ud3 kernel launch failed: CUDA error "
                           f"{status}")
    kernels.LAUNCHES["adv_ud3"] += 1
    return out


def adv_flux_divergence(q, rho, fx, fy, fw, dzc, dx: float, dy: float,
                        kdiff4: float = 0.0, lateral: str = "periodic"):
    """Tracer tendencies, x/y periodic or open: CUDA tensors (B, ...) go
    through the kernel, CPU tensors through adv_flux_divergence_plain."""
    args = (q, rho, fx, fy, fw, dzc, dx, dy, kdiff4, lateral)
    if rho.is_cuda:
        return adv_flux_divergence_kernel(*args)
    if rho.device.type == "cpu":
        return adv_flux_divergence_plain(*args)
    raise ValueError(f"adv_flux_divergence has no path for {rho.device}")
