"""Section timers (mpi_timer equivalent, common_mpi_scale.f90:1971-2057).

On a CUDA device each section synchronises at its start and end, so the
device work a section enqueues is charged to that section and not to the
next one that waits (the USE_MPI_BARRIER analogue). A Timer with enabled
False neither synchronises nor records: the untimed path of a caller that
must not wait for the device (da/fastcycle.py)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


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

    @contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.records[full] = self.records.get(full, 0.0) + dt
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


@contextmanager
def maybe_section(timer: Timer | None, name: str):
    """timer.section(name), or nothing when timer is None."""
    if timer is None:
        yield
    else:
        with timer.section(name):
            yield
