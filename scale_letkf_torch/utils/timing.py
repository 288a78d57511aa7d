"""Section timers (mpi_timer equivalent, common_mpi_scale.f90:1971-2057).

On a CUDA device each section synchronises at its start and end, so the
device work a section enqueues is charged to that section and not to the
next one that waits (the USE_MPI_BARRIER analogue). A Timer with enabled
False neither synchronises nor records: the untimed path of a caller that
must not wait for the device (da/fastcycle.py). An EventTimer, the timed
path of that caller, does not wait either: it times its sections on the
device's clock.

While torch.profiler records, an enabled section of either timer also
opens a host range named by the section's full path ('forecast/acoustic',
'das_letkf/select', ...), so the trace's host timeline nests as the
timer's paths do. The range is host-only (an ordinary CPU op in the
trace, not a user annotation, so it marks no device event); with no
profiler, or in a disabled Timer, none is opened."""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch


def _profiler_range(name: str):
    """A host-only range `name` in the profiler's trace while one
    records, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return nullcontext()


@dataclass
class Timer:
    device: torch.device
    enabled: bool = True
    records: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    _stack: list[str] = field(default_factory=list)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self):
        """The section's start mark."""
        self._sync()
        return time.perf_counter()

    def _stop(self, full: str, t0) -> None:
        """Ends the section `full` that started at mark t0."""
        self._sync()
        self.records[full] = (self.records.get(full, 0.0)
                              + time.perf_counter() - t0)

    @contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        with _profiler_range(full):
            t0 = self._start()
            try:
                yield
            finally:
                self._stop(full, t0)
                self.counts[full] = self.counts.get(full, 0) + 1
                self._stack.pop()

    def report(self) -> str:
        """Sections as an indented table: seconds and calls."""
        lines = ["== timing =="]
        for k in sorted(self.records):
            depth = k.count("/")
            lines.append(f"{'  ' * depth}{k.split('/')[-1]:<32s} "
                         f"{self.records[k]:10.3f} s  x{self.counts[k]}")
        return "\n".join(lines)


@dataclass
class EventTimer(Timer):
    """A Timer on the device's clock, for FusedCycle(timed=True), which
    must not wait for the device: on a CUDA device each section records a
    CUDA event at its start and end and never synchronises; `settle`
    (called by `report`) waits for the last event and adds the sections'
    device times to `records`. Elsewhere it is a Timer (the host clock,
    with nothing to wait for)."""
    _pending: list = field(default_factory=list)

    def _start(self):
        if self.device.type != "cuda":
            return super()._start()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _stop(self, full: str, t0) -> None:
        if self.device.type != "cuda":
            return super()._stop(full, t0)
        t1 = torch.cuda.Event(enable_timing=True)
        t1.record()
        self._pending.append((full, t0, t1))

    def settle(self) -> None:
        """Adds the pending sections' device times to records, waiting for
        the last section's end event."""
        if not self._pending:
            return
        self._pending[-1][2].synchronize()
        for full, a, b in self._pending:
            self.records[full] = (self.records.get(full, 0.0)
                                  + a.elapsed_time(b) / 1e3)
        self._pending.clear()

    def report(self) -> str:
        self.settle()
        return super().report()


@contextmanager
def maybe_section(timer: Timer | None, name: str):
    """timer.section(name), or nothing when timer is None."""
    if timer is None:
        yield
    else:
        with timer.section(name):
            yield
