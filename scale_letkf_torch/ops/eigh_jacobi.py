"""Batched symmetric eigensolver by parallel cyclic Jacobi.

Port of scale_letkf_tpu/ops/eigh_jacobi.py (reference: the per-point
EISPACK `rs` call, common/common_mtx.f90:41), plain PyTorch as the
reference is plain XLA. It is the LETKF's 'jacobi' solver
(ops/letkf_core.py) for its batched K×K Gram matrices.

Round-robin parallel ordering: each round pairs the K indices into K/2
disjoint (p, q) pairs, and the K-1 rounds of a sweep touch every pair once.
The K/2 Givens rotations of a round commute, so they form one orthogonal
matrix J and the update is A ← JᵀAJ, V ← VJ. At small K (≤ ROWCOL_MAX_K)
the rotations are applied as elementwise combinations of the rows and
columns p and q (O(K²) work a round); above it as two batched products with
J (O(K³), in full FP32 whatever precision the caller set). The
off-diagonal norm decays quadratically: 6-10 sweeps reach float32
rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from scale_letkf_torch.utils.device import full_fp32

# Largest K of the row/column form; the matmul form above it (the
# reference's _ROWCOL_MAX_K)
ROWCOL_MAX_K = 64


def _round_robin_schedule(K: int) -> np.ndarray:
    """(K-1, K/2, 2) pairs (p < q): the round-robin tournament ordering."""
    if K % 2:
        raise ValueError(f"parallel Jacobi needs an even K, got {K}")
    players = list(range(K))
    rounds = []
    for _ in range(K - 1):
        pairs = [(players[i], players[K - 1 - i]) for i in range(K // 2)]
        rounds.append([(min(p, q), max(p, q)) for p, q in pairs])
        # rotate all but the first
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, np.int32)


def _angles(a: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """Stable Jacobi rotation (c, s) of each pair (..., K/2), annihilating
    a[p, q]; pairs with a[p, q] == 0 (or a[p, p] == a[q, q], as in the
    reference, whose sign(0) is 0) are not rotated."""
    app = a[..., p, p]
    aqq = a[..., q, q]
    apq = a[..., p, q]
    nz = apq.abs() > 0
    tau = (aqq - app) / (2.0 * torch.where(nz, apq, 1.0))
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(nz, t, 0.0)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _sorted(a: torch.Tensor, v: torch.Tensor):
    """Eigenvalues (the diagonal of the rotated A) ascending, with their
    eigenvector columns."""
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    w, order = torch.sort(w, dim=-1)
    return w, torch.take_along_dim(v, order[..., None, :], dim=-1)


def _eigh_jacobi_rowcol(a: torch.Tensor, sweeps: int = 8):
    """Row/column form: each round applies its K/2 rotations as elementwise
    combinations of the rows p, q of A, then of the columns p, q of A and
    V."""
    K = a.shape[-1]
    sched = torch.as_tensor(_round_robin_schedule(K), dtype=torch.int64,
                            device=a.device)
    a = a.clone()
    v = torch.eye(K, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    for _ in range(sweeps):
        for r in range(K - 1):
            p, q = sched[r, :, 0], sched[r, :, 1]
            c, s = _angles(a, p, q)
            cr, sr = c[..., None], s[..., None]
            # A ← JᵀA (rows), then ·J (columns); V ← V·J (columns)
            ap, aq = a[..., p, :], a[..., q, :]
            a[..., p, :] = cr * ap - sr * aq
            a[..., q, :] = sr * ap + cr * aq
            cc, sc = c[..., None, :], s[..., None, :]
            ap, aq = a[..., :, p], a[..., :, q]
            a[..., :, p] = cc * ap - sc * aq
            a[..., :, q] = sc * ap + cc * aq
            vp, vq = v[..., :, p], v[..., :, q]
            v[..., :, p] = cc * vp - sc * vq
            v[..., :, q] = sc * vp + cc * vq
        a = 0.5 * (a + a.transpose(-1, -2))
    return _sorted(a, v)


def _round_rotation(a: torch.Tensor, p: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """The (..., K, K) orthogonal matrix of the K/2 disjoint Givens
    rotations annihilating a[p, q] for each pair."""
    K = a.shape[-1]
    c, s = _angles(a, p, q)
    j = torch.eye(K, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    j[..., p, p] = c
    j[..., q, q] = c
    j[..., p, q] = s
    j[..., q, p] = -s
    return j


@full_fp32()
def eigh_jacobi(a: torch.Tensor, sweeps: int = 8):
    """Batched symmetric eigendecomposition of a (..., K, K), K even.
    Returns (eigenvalues ascending (..., K), eigenvectors (..., K, K)) with
    A = V diag(w) Vᵀ (columns are eigenvectors), as torch.linalg.eigh.
    The row/column form for K ≤ ROWCOL_MAX_K, the matmul form above."""
    K = a.shape[-1]
    if K <= ROWCOL_MAX_K:
        return _eigh_jacobi_rowcol(a, sweeps)
    sched = torch.as_tensor(_round_robin_schedule(K), dtype=torch.int64,
                            device=a.device)
    v = torch.eye(K, dtype=a.dtype, device=a.device).expand(a.shape)
    for _ in range(sweeps):
        for r in range(K - 1):
            j = _round_rotation(a, sched[r, :, 0], sched[r, :, 1])
            a = j.transpose(-1, -2) @ a @ j
            # re-symmetrize so that rounding does not accumulate
            a = 0.5 * (a + a.transpose(-1, -2))
            v = v @ j
    return _sorted(a, v)
