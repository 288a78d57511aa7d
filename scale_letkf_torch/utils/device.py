"""Device selection for the port's GPU path: explicit, and never a fallback."""

from __future__ import annotations

import contextlib

import torch


def require_cuda(index: int = 0) -> torch.device:
    """The CUDA device `index`, or RuntimeError when there is no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the GPU path does not run on the CPU")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"CUDA device {index} requested, "
                           f"{torch.cuda.device_count()} present")
    return torch.device("cuda", index)


@contextlib.contextmanager
def full_fp32():
    """Float32 matrix products and cuDNN convolutions on CUDA in full FP32
    ("ieee", no TF32) for the duration, whatever precision the caller
    chose, which comes back on exit. The analysis's Gram and weight
    products, the kernel's plain yardstick and EFSO's convolutions (cuDNN's
    default is TF32) need it: the reference computes them at HIGHEST
    precision. Also a decorator."""
    knobs = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    saved = [k.fp32_precision for k in knobs]
    for k in knobs:
        k.fp32_precision = "ieee"
    try:
        yield
    finally:
        for k, v in zip(knobs, saved):
            k.fp32_precision = v
