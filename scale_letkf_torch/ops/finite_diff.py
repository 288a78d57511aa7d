"""Plain finite-difference stencil helpers of the dynamical core.

Port of the stencil helpers of scale_letkf_tpu/model/dycore.py. Axes: z =
-3, y = -2, x = -1; any leading axes are batch (member, tracer) axes. The
lateral mode is an explicit argument: 'periodic' wraps, 'open' repeats the
edge value (zero-gradient ghost cells); the vertical is always clamped.
model/dycore.py and the kernel wrappers (ops/tendency.py, ops/stencil.py)
build on these.
"""

from __future__ import annotations

import torch


def zsl(f: torch.Tensor, start=None, stop=None) -> torch.Tensor:
    """f[..., start:stop, :, :] (a slice along z)."""
    return f[..., start:stop, :, :]


def _shift_clamp(f: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Value from index i+n with edge clamp (ghost cells repeat the
    boundary value)."""
    size = f.shape[axis]
    if n > 0:
        main = f.narrow(axis, n, size - n)
        edge = f.narrow(axis, size - 1, 1)
        return torch.cat([main] + [edge] * n, dim=axis)
    main = f.narrow(axis, 0, size + n)
    edge = f.narrow(axis, 0, 1)
    return torch.cat([edge] * (-n) + [main], dim=axis)


def roll_x(f: torch.Tensor, n: int, lateral: str) -> torch.Tensor:
    """+n: the value from i+n."""
    if lateral == "open":
        return _shift_clamp(f, n, -1)
    return torch.roll(f, -n, dims=-1)


def roll_y(f: torch.Tensor, n: int, lateral: str) -> torch.Tensor:
    if lateral == "open":
        return _shift_clamp(f, n, -2)
    return torch.roll(f, -n, dims=-2)


def ud3_face_x(f, mflux, lateral: str = "periodic"):
    """3rd-order upwind-biased face value of center field f at x-face i+1/2,
    selected by the sign of the face mass flux."""
    fm1, f0, fp1, fp2 = (roll_x(f, -1, lateral), f, roll_x(f, 1, lateral),
                         roll_x(f, 2, lateral))
    pos = (2.0 * fp1 + 5.0 * f0 - fm1) / 6.0
    neg = (2.0 * f0 + 5.0 * fp1 - fp2) / 6.0
    return torch.where(mflux >= 0, pos, neg)


def ud3_face_y(f, mflux, lateral: str = "periodic"):
    fm1, f0, fp1, fp2 = (roll_y(f, -1, lateral), f, roll_y(f, 1, lateral),
                         roll_y(f, 2, lateral))
    pos = (2.0 * fp1 + 5.0 * f0 - fm1) / 6.0
    neg = (2.0 * f0 + 5.0 * fp1 - fp2) / 6.0
    return torch.where(mflux >= 0, pos, neg)


def ud3_face_z(f, mflux_w):
    """Face value at interior z-faces (k+1/2, k=0..nz-2), shape (..., nz-1,
    ny, nx). Falls back to centered 2nd order at the faces adjacent to the
    boundaries."""
    nz = f.shape[-3]
    pos = (2.0 * zsl(f, 1) + 5.0 * zsl(f, None, -1)
           - torch.cat([zsl(f, None, 1), zsl(f, None, -2)], dim=-3)) / 6.0
    neg = (2.0 * zsl(f, None, -1) + 5.0 * zsl(f, 1)
           - torch.cat([zsl(f, 2), zsl(f, -1)], dim=-3)) / 6.0
    hi = torch.where(mflux_w >= 0, pos, neg)
    centered = 0.5 * (zsl(f, 1) + zsl(f, None, -1))
    k = torch.arange(nz - 1, device=f.device)[:, None, None]
    edge = (k == 0) | (k == nz - 2)
    return torch.where(edge, centered, hi)


def hyperdiff4(f, coef: float, lateral: str = "periodic"):
    """Scale-selective 4th-order horizontal hyperdiffusion −coef ∇⁴f, the
    Laplacian in index space (coef absorbs dx)."""
    def lap(g):
        return (roll_x(g, 1, lateral) + roll_x(g, -1, lateral)
                + roll_y(g, 1, lateral) + roll_y(g, -1, lateral) - 4.0 * g)
    return -coef * lap(lap(f))
