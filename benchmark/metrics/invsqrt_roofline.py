"""Kernel #1's share of its roofline, %: the least time of the traced
units' Newton–Schulz work (benchmark/roofline.py invsqrt_s) over the
device time of the kernels named ns_fused_kernel."""

from benchmark.trace import kernel_s


def read(rec: dict):
    t = kernel_s(rec.get("kernels", {}), "ns_fused_kernel")
    b = rec.get("bounds", {}).get("invsqrt")
    return 100.0 * b / t if t > 0 and b else None
