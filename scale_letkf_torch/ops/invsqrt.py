"""Batched SPD inverse square root and inverse by coupled Newton–Schulz.

Port of scale_letkf_tpu/ops/invsqrt.py. The LETKF transform needs only
C^{-1} (= Pa) and C^{-1/2} (= W/√(K-1)) of the K×K ensemble-space Gram
matrix, never its eigenpairs (common_letkf.f90:151-206), and the coupled
Newton–Schulz iteration (Higham, "Functions of Matrices", §6.3) computes
both from matrix products alone:

  A = C / c  (c ≥ λ_max),  Y₀ = A, Z₀ = I
  T_k = (3I − Z_k Y_k)/2 ;  Y_{k+1} = Y_k T_k ;  Z_{k+1} = T_k Z_k
  Y_k → A^{1/2},  Z_k → A^{-1/2}

Two forms:
- `invsqrt_newton_schulz`: the plain iteration on the Gershgorin-normalized
  matrix (the reference's XLA path), used for K > 128.
- `invsqrt_ns`: the fused form of the reference's Pallas kernel
  (invsqrt_ns_pallas): a tight power-iteration normalization, a spectrum
  floor for the first phase, a re-anchor on the true matrix and two polish
  iterations. On a CUDA tensor it launches the hand-written kernel
  csrc/invsqrt_ns.cu; on a CPU tensor it runs `invsqrt_ns_plain`, the same
  algorithm in torch float32 matmuls.
"""

from __future__ import annotations

import torch

from scale_letkf_torch.utils import kernels
from scale_letkf_torch.utils.device import full_fp32

# Phase-1 spectrum floor, as a fraction of the λ_max bound. The floor uses
# the exact lower bound λ_min(C) ≥ (K-1)/ρ (the LETKF inflation shift), so
# matrices with cond ≤ 1/EIG_FLOOR are untouched.
EIG_FLOOR = 1e-4


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def invsqrt_newton_schulz(c_mat: torch.Tensor, iters: int = 22):
    """Batched (C^{-1/2}, C^{-1}) of SPD c_mat (..., K, K), both symmetric.
    22 sweeps cover cond ≲ 1e5 at float32."""
    K = c_mat.shape[-1]
    # Gershgorin upper bound on λ_max: the spectrum of A lies in (0, 1]
    c = torch.amax(torch.sum(torch.abs(c_mat), dim=-1), dim=-1)
    c = torch.clamp(c, min=torch.finfo(c_mat.dtype).tiny)
    y = c_mat / c[..., None, None]
    eye = _eye(K, c_mat)
    z = eye.expand_as(y)
    for _ in range(iters):
        t = 1.5 * eye - 0.5 * (z @ y)
        y, z = y @ t, t @ z
    inv_sqrt = z * torch.rsqrt(c)[..., None, None]
    inv_sqrt = 0.5 * (inv_sqrt + inv_sqrt.transpose(-1, -2))
    inv = inv_sqrt @ inv_sqrt
    inv = 0.5 * (inv + inv.transpose(-1, -2))
    return inv_sqrt, inv


def power_bound(c_mat: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Per-matrix λ_max estimate: power iteration ×1.05, floored at
    Gershgorin/2.9. The floor is what makes it safe: NS converges for a
    normalized spectrum in (0, 3), and a start vector nearly orthogonal to
    the top eigenvector can underestimate λ_max badly (it produced NaNs on
    real radar Grams in the reference). gersh ≥ λ_max always, so
    c ≥ gersh/2.9 keeps λ_max/c ≤ 2.9."""
    gersh = torch.amax(torch.sum(torch.abs(c_mat), dim=-1), dim=-1)
    v = torch.ones(c_mat.shape[:-1] + (1,), dtype=c_mat.dtype,
                   device=c_mat.device)
    for _ in range(iters):
        v = c_mat @ v
        v = v / torch.linalg.vector_norm(v, dim=-2, keepdim=True)
    power = torch.linalg.vector_norm(c_mat @ v, dim=(-2, -1))
    return torch.maximum(1.05 * power, gersh / 2.9)


def ns_operands(c_mat: torch.Tensor, smin: torch.Tensor):
    """Normalize, floor and pad a batch of SPD matrices for the fused
    iteration.

    c_mat: (B, K, K) float32; smin: (B,) exact lower bound on λ_min (the
    LETKF inflation shift (K-1)/ρ; 0 for "unknown", then phase 1 always
    floors). Returns (a, areg, c): a = C/c and areg = a + bump·I, each
    padded block-diagonally with identity to (B, kp, kp), kp = ⌈K/64⌉·64
    (exact: identity is a fixed point of the iteration), and the
    normalization c (B,)."""
    B, K, _ = c_mat.shape
    kp = -(-K // 64) * 64
    c = torch.clamp(power_bound(c_mat), min=torch.finfo(c_mat.dtype).tiny)
    m = smin / c
    bump = torch.clamp(EIG_FLOOR - m, min=0.0)
    a = torch.zeros((B, kp, kp), dtype=c_mat.dtype, device=c_mat.device)
    a[:, :K, :K] = c_mat / c[:, None, None]
    if kp > K:
        idx = torch.arange(K, kp, device=c_mat.device)
        a[:, idx, idx] = 1.0
    areg = a.clone()
    diag = torch.arange(K, device=c_mat.device)
    areg[:, diag, diag] += bump[:, None]
    return a, areg, c


@full_fp32()
def invsqrt_ns_plain(a: torch.Tensor, areg: torch.Tensor,
                     it_lo: int = 18, it_hi: int = 2):
    """The fused kernel's algorithm in plain torch float32 matmuls — the
    kernel's yardstick and the CPU path. Takes ns_operands' (a, areg) and
    returns (Z, Z·Z) with Z ≈ a^{-1/2}, symmetrized:

      phase 1: it_lo iterations from (Y, Z) = (areg, I)
      re-anchor Y = a·Z on the true matrix
      phase 2: it_hi polish iterations

    Its products run in full FP32 (full_fp32, no TF32 on CUDA): the kernel's
    3xTF32 tensor-core products keep FP32 accuracy, and its yardstick must
    not lose it to one-pass TF32."""
    eye = _eye(a.shape[-1], a)

    def step(y, z):
        t = 1.5 * eye - 0.5 * (z @ y)
        return y @ t, t @ z

    y, z = areg, eye.expand_as(a)
    for _ in range(it_lo):
        y, z = step(y, z)
    y = a @ z
    for _ in range(it_hi):
        y, z = step(y, z)
    z = 0.5 * (z + z.transpose(-1, -2))
    return z, z @ z


def invsqrt_ns_kernel(a: torch.Tensor, areg: torch.Tensor,
                      it_lo: int = 18, it_hi: int = 2):
    """invsqrt_ns_plain's contract on the hand-written CUDA kernel: one
    launch on the current stream, no synchronisation. Raises on anything
    the kernel does not take and on a non-zero launch status."""
    if not (a.is_cuda and areg.device == a.device):
        raise ValueError("invsqrt_ns_kernel takes CUDA tensors on one device")
    if a.dtype != torch.float32 or areg.dtype != torch.float32:
        raise TypeError("invsqrt_ns_kernel takes float32")
    if a.dim() != 3 or a.shape != areg.shape or a.shape[1] != a.shape[2]:
        raise ValueError(f"invsqrt_ns_kernel takes two (B, kp, kp) tensors, "
                         f"got {tuple(a.shape)} and {tuple(areg.shape)}")
    B, kp, _ = a.shape
    if kp not in (64, 128):
        raise ValueError(f"invsqrt_ns_kernel takes kp 64 or 128, got {kp}")
    if not (a.is_contiguous() and areg.is_contiguous()):
        raise ValueError("invsqrt_ns_kernel takes contiguous tensors")
    isq = torch.empty_like(a)
    inv = torch.empty_like(a)
    if B == 0:
        return isq, inv
    lib = kernels.load("invsqrt_ns")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = lib.invsqrt_ns_launch(a.data_ptr(), areg.data_ptr(),
                                       isq.data_ptr(), inv.data_ptr(),
                                       B, kp, it_lo, it_hi, stream)
    if status != 0:
        raise RuntimeError(f"invsqrt_ns kernel launch failed: CUDA error "
                           f"{status}")
    kernels.LAUNCHES["invsqrt_ns"] += 1
    return isq, inv


def invsqrt_ns(c_mat: torch.Tensor, smin: torch.Tensor,
               it_lo: int = 18, it_hi: int = 2):
    """Batched (C^{-1/2}, C^{-1}) of SPD float32 c_mat (..., K, K), K ≤ 128,
    by the fused Newton–Schulz iteration; smin (...) is an exact lower bound
    on λ_min (see ns_operands). A CUDA tensor goes through the CUDA kernel,
    a CPU tensor through invsqrt_ns_plain."""
    *lead, K, _ = c_mat.shape
    if c_mat.dtype != torch.float32:
        raise TypeError(f"invsqrt_ns takes float32, got {c_mat.dtype}")
    if K > 128:
        raise ValueError(f"invsqrt_ns takes K ≤ 128, got {K}")
    c_flat = c_mat.reshape(-1, K, K)
    smin_flat = torch.as_tensor(smin, dtype=c_mat.dtype,
                                device=c_mat.device).expand(lead).reshape(-1)
    a, areg, c = ns_operands(c_flat, smin_flat)
    if c_mat.is_cuda:
        z, zz = invsqrt_ns_kernel(a, areg, it_lo, it_hi)
    elif c_mat.device.type == "cpu":
        z, zz = invsqrt_ns_plain(a, areg, it_lo, it_hi)
    else:
        raise ValueError(f"invsqrt_ns has no path for {c_mat.device}")
    isq = z[:, :K, :K] * torch.rsqrt(c)[:, None, None]
    inv = zz[:, :K, :K] / c[:, None, None]
    return isq.reshape(c_mat.shape), inv.reshape(c_mat.shape)
