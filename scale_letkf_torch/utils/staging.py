"""Host ↔ device transfers of the streamed executors.

An ensemble that lives in host memory (da/letkf_tiled.py, da/bigcycle.py)
crosses to the card one row tile or member batch at a time, through pinned
staging buffers of one tile or batch (never by pinning a whole ensemble)
into device buffers of the same size. With `pipeline` two such pairs
alternate and the copies run on a stream of their own, so the next tile's
upload overlaps the current tile's compute: a pinned buffer is refilled
only after its copy has finished, a device buffer only after the work that
read it (both ordered by events). Downloads go through a pinned buffer
of their size. On the CPU nothing is copied. Every transfer is counted in bytes
each way.
"""

from __future__ import annotations

import numpy as np
import torch


def host_tensor(a) -> torch.Tensor:
    """A host array or tensor as a CPU tensor, sharing its memory."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(a)


class Stager:
    """Uploads named host tensors to `device` and downloads device tensors
    into host arrays; h2d_bytes and d2h_bytes count what crossed the link.

    upload() returns the device tensors and a slot; the caller calls
    ready(slot) before its work reads them and done(slot) once that work is
    queued. The tensors are overwritten by the upload after the next (the
    next, without pipeline): consume them before then."""

    def __init__(self, device: torch.device, pipeline: bool = False):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = (torch.cuda.Stream(device) if self.cuda and pipeline
                       else None)
        n = 2 if self.stream is not None else 1
        self._pinned: list[dict[str, torch.Tensor]] = [{} for _ in range(n)]
        self._dev: list[dict[str, torch.Tensor]] = [{} for _ in range(n)]
        self._copied: list = [None] * n     # events: copies finished
        self._read: list = [None] * n       # events: consumers finished
        self._next = 0
        self._down: dict = {}               # pinned download buffers
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    def upload(self, arrays: dict) -> tuple[dict, int]:
        """({name: device tensor}, slot) of the host tensors or arrays
        `arrays`. Their values are read before this returns, so the caller
        may reuse them."""
        if not self.cuda:
            return {k: host_tensor(a).to(self.device)
                    for k, a in arrays.items()}, 0
        i = self._next
        self._next = (i + 1) % len(self._pinned)
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        stream = self.stream or torch.cuda.current_stream(self.device)
        if self._read[i] is not None:
            stream.wait_event(self._read[i])
        out = {}
        for k, a in arrays.items():
            a = host_tensor(a)
            b, d = self._pinned[i].get(k), self._dev[i].get(k)
            if b is None or b.shape != a.shape or b.dtype != a.dtype:
                b = self._pinned[i][k] = torch.empty(
                    a.shape, dtype=a.dtype, pin_memory=True)
                d = self._dev[i][k] = torch.empty(a.shape, dtype=a.dtype,
                                                  device=self.device)
            b.copy_(a)
            with torch.cuda.stream(stream):
                d.copy_(b, non_blocking=True)
            out[k] = d
            self.h2d_bytes += a.numel() * a.element_size()
        ev = torch.cuda.Event()
        ev.record(stream)
        self._copied[i] = ev
        return out, i

    def ready(self, slot: int) -> None:
        """Orders the current stream after slot's copies."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._copied[slot])

    def done(self, slot: int) -> None:
        """Marks slot's device buffers free once the work queued so far on
        the current stream has run."""
        if self.stream is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._read[slot] = ev

    def download(self, t: torch.Tensor, out=None) -> torch.Tensor:
        """t on the host: copied into `out` (a host array or tensor of t's
        shape, possibly a strided view) when given, else a new tensor; from
        the card through a pinned buffer of t's size (the copy into
        pageable memory directly runs at a fraction of the link's rate)."""
        if not self.cuda:
            return t if out is None else host_tensor(out).copy_(t)
        self.d2h_bytes += t.numel() * t.element_size()
        b = self._down.get((t.shape, t.dtype))
        if b is None:
            b = self._down[(t.shape, t.dtype)] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        b.copy_(t)
        return (b.clone() if out is None
                else host_tensor(out).copy_(b))


def as_numpy(a) -> np.ndarray:
    """A host array of a tensor (any device) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
