"""Kernels #2 and #3 together, % of their roofline: the sum of their
bounds over the sum of the device times of the kernels named
dyn_tendency_kernel and adv_ud3_kernel."""

from benchmark.trace import kernel_s


def read(rec: dict):
    t = kernel_s(rec.get("kernels", {}), "dyn_tendency_kernel",
                 "adv_ud3_kernel")
    b = rec.get("bounds", {})
    if t <= 0 or not (b.get("dyn") and b.get("adv")):
        return None
    return 100.0 * (b["dyn"] + b["adv"]) / t
