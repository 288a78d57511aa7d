"""Reading a torch.profiler trace: device busy time, device time by kernel
name, and the longest device-idle gaps with what the host was doing.

The events are read from the profiler's own records (kineto's, before
they are turned into the profiler's Python event objects, which takes
minutes for the millions of events of an 18-km analysis: `Recorder`).
Device activity is every event that ran on the device (kernels, copies,
sets); busy time is the length of the union of their intervals (the
method of scale_letkf_torch/profile_analysis.py busy_seconds, copied).
"""

from __future__ import annotations



def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals in µs, as seconds."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def gaps(intervals, lo: float, hi: float):
    """The idle (start, end) gaps in µs between the union of intervals,
    within [lo, hi]."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class Recorder:
    """torch.profiler's recording (CPU activity, and CUDA with `cuda`)
    driven at kineto's level: `stop` returns kineto's events as they are,
    where leaving a torch.profiler.profile turns every one of them into a
    Python event object first (minutes for an 18-km analysis)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def start(self):
        from torch.autograd import (
            _enable_profiler, _prepare_profiler, profiler as ap)
        p = ap.profile(use_device="cuda" if self.cuda else None,
                       use_kineto=True)
        cfg = p.config(create_trace_id=True)
        _prepare_profiler(cfg, p.kineto_activities)
        _enable_profiler(cfg, p.kineto_activities)

    def stop(self):
        """The recorded events as (category, name, start µs, end µs): an
        event on the device is a "kernel" (copies and sets with the
        kernels), one on the host a "cpu_op"."""
        from torch.autograd import _disable_profiler
        return [("kernel" if "CUDA" in str(ev.device_type()) else "cpu_op",
                 ev.name(), ev.start_ns() / 1e3,
                 (ev.start_ns() + ev.duration_ns()) / 1e3)
                for ev in _disable_profiler().events()]


def summarize(events, top: int = 10) -> dict:
    """busy_s, kernel seconds by name, and the breakdown's device_ops and
    idle_gaps (each `top` long) of (category, name, start, end) events."""
    dev, host = [], []
    for cat, name, s, e in events:
        (dev if cat == "kernel" else host).append((s, e, name))
    by_name: dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    ivals = [(s, e) for s, e, _ in dev]
    busy = union_s(ivals)
    idle = []
    if dev:
        lo = min(s for s, _, _ in dev)
        hi = max(e for _, e, _ in dev)
        longest = sorted(gaps(ivals, lo, hi), key=lambda g: g[0] - g[1])[:top]
        for a, b in longest:
            mid = 0.5 * (a + b)
            # the innermost host event over the gap's middle
            over = [(e - s, n) for s, e, n in host if s <= mid <= e]
            label = min(over)[1] if over else "host idle"
            idle.append([label, (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "kernels": by_name,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}


def kernel_s(kernels: dict, *names: str) -> float:
    """Device seconds of every kernel whose name holds one of `names`."""
    return sum(s for n, s in kernels.items() if any(k in n for k in names))
