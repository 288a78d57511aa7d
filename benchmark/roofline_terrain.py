"""Bytes the regional forecast moves at least beyond roofline.si_step_bytes:
the terrain tendency's metric reads and the Davies relaxation, counted from
shapes alone (every input byte read once, every output byte written once),
so that the whole step's bound stays a lower bound.
"""

from __future__ import annotations

from benchmark.roofline import F32


def metric_bytes(nz: int, ny: int, nx: int) -> float:
    """One read of the terrain metrics by a stage's slow tendency of a
    member batch: J (ny, nx), Gx and Gy at the centres' levels (nz) and at
    the z-faces (nz + 1)."""
    return F32 * ny * nx * (1 + 2 * nz + 2 * (nz + 1))


def buffer_points(ny: int, nx: int, width: int) -> int:
    """Columns in the Davies buffer: within `width` cells of an edge."""
    return ny * nx - max(0, ny - 2 * width) * max(0, nx - 2 * width)


def relaxation_bytes(nz: int, ny: int, nx: int, width: int) -> float:
    """A member-step's relaxation: the buffer's fields (ρ, ρu, ρv, ρθ and
    the six tracers at nz levels, ρw at nz + 1) read and written."""
    return 2 * F32 * buffer_points(ny, nx, width) * (11 * nz + 1)


def target_bytes(nz: int, ny: int, nx: int, width: int) -> float:
    """A batch-step's boundary target: the buffer of its two bracketing
    states and the (ny, nx) rate read once."""
    return F32 * (2 * buffer_points(ny, nx, width) * (11 * nz + 1)
                  + ny * nx)
