"""The process grid of the (member × domain) decomposition.

Port of scale_letkf_tpu/parallel/mesh.py (reference: the MPI communicator
hierarchy of common_mpi_scale.f90:517-921 — COMM_e, the ensemble
communicator, and COMM_d, the 2-D X×Y domain decomposition — with the
member↔node mapping of set_mem_node_proc :367). The JAX package lays one
jax Mesh with axes (member, dy, dx) over its devices and lets GSPMD place
the collectives. The port has no compiler to place them, so the grid names
its blocks explicitly:

- block b = (m, j, i), b = (m·n_dy + j)·n_dx + i, holds member slab m
  (K/n_member consecutive members) over rows j·ny/n_dy … and columns
  i·nx/n_dx … of the global ensemble (numpy-style slices of it); the
  vertical is never decomposed;
- block b lives in process b // blocks_per_process: blocks in process
  order, so with blocks_per_process a multiple of n_dy·n_dx each member
  slab lands on whole processes (the reference's member↔node mapping);
- a process holds its blocks on its one device. Data moves between blocks
  through `route`: a view or device copy inside a process, and
  torch.distributed point-to-point messages between processes.

`make_mesh` gives every block to this process (the counterpart of the JAX
package's virtual CPU devices); parallel/distributed.py's
`global_device_mesh` spreads them over a torch.distributed world. A
`Sharded` holds this process's blocks of one ensemble (a DycoreState or a
tensor per block — the physics suite's per-member skin temperature
(K, ny, nx) is one, each block holding its (K_b, ny_b, nx_b) part) with
the global sizes; `shard_ensemble` cuts one out of a global ensemble,
`gather_ensemble` puts the global one back together on every process and
`gather_slab` one member slab over the domain on one process.

The shapes must divide: K by n_member, ny by n_dy, nx by n_dx (the
reference's shard_map specs ask the same).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

AXIS_MEMBER = "member"
AXIS_DY = "dy"
AXIS_DX = "dx"


class Sharded(NamedTuple):
    """This process's blocks of one ensemble. blocks: block index → its
    DycoreState or tensor, with the member slab leading (absent when
    K == 0: a state replicated over the member axis) and (y, x) last.
    K, ny, nx: the global sizes."""
    blocks: dict[int, Any]
    K: int
    ny: int
    nx: int


def _fields(x) -> list[torch.Tensor]:
    return list(x) if isinstance(x, tuple) else [x]


def _like(proto, fields: list[torch.Tensor]):
    return type(proto)(*fields) if isinstance(proto, tuple) else fields[0]


def _pack(tensors: list[torch.Tensor]) -> torch.Tensor:
    """One flat buffer of several tensors (one message instead of many:
    the reference's COMM_vars8 variable batching)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _unpack(buf: torch.Tensor, shapes: list[torch.Size]
            ) -> list[torch.Tensor]:
    out, o = [], 0
    for shp in shapes:
        n = int(np.prod(shp))
        out.append(buf[o:o + n].view(shp))
        o += n
    return out


@dataclass(frozen=True)
class ProcessGrid:
    """(n_member, n_dy, n_dx) blocks over `world` processes, this one
    being `rank`; each process holds n_blocks // world of them."""
    n_member: int = 1
    n_dy: int = 1
    n_dx: int = 1
    rank: int = 0
    world: int = 1
    _index: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    def __post_init__(self):
        if min(self.n_member, self.n_dy, self.n_dx) < 1:
            raise ValueError(f"grid {self.shape} needs every axis ≥ 1")
        if self.n_blocks % self.world:
            raise ValueError(f"{self.n_blocks} blocks do not divide over "
                             f"{self.world} processes")

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.n_member, self.n_dy, self.n_dx)

    @property
    def n_blocks(self) -> int:
        return self.n_member * self.n_dy * self.n_dx

    @property
    def blocks_per_process(self) -> int:
        return self.n_blocks // self.world

    @property
    def spatial(self) -> bool:
        """True when the domain is decomposed (halo exchanges needed)."""
        return self.n_dy * self.n_dx > 1

    def size(self, axis_name: str) -> int:
        return {AXIS_MEMBER: self.n_member, AXIS_DY: self.n_dy,
                AXIS_DX: self.n_dx}[axis_name]

    def coords(self, b: int) -> tuple[int, int, int]:
        """(m, j, i) of block b."""
        m, r = divmod(b, self.n_dy * self.n_dx)
        return (m, *divmod(r, self.n_dx))

    def index(self, m: int, j: int, i: int) -> int:
        return (m * self.n_dy + j) * self.n_dx + i

    def owner(self, b: int) -> int:
        """The process holding block b."""
        return b // self.blocks_per_process

    @property
    def local(self) -> tuple[int, ...]:
        """This process's blocks, in order."""
        n = self.blocks_per_process
        return tuple(range(self.rank * n, (self.rank + 1) * n))

    def position(self, b: int, axis_name: str) -> int:
        m, j, i = self.coords(b)
        return {AXIS_MEMBER: m, AXIS_DY: j, AXIS_DX: i}[axis_name]

    def neighbor(self, b: int, axis_name: str, step: int) -> int:
        """The block `step` places along `axis_name` from b, on the ring."""
        m, j, i = self.coords(b)
        if axis_name == AXIS_DY:
            j = (j + step) % self.n_dy
        elif axis_name == AXIS_DX:
            i = (i + step) % self.n_dx
        else:
            m = (m + step) % self.n_member
        return self.index(m, j, i)

    # -- the block bounds --
    @staticmethod
    def _part(n: int, parts: int, what: str, k: int) -> slice:
        if n % parts:
            raise ValueError(f"{what} = {n} does not divide into {parts}")
        w = n // parts
        return slice(k * w, (k + 1) * w)

    def members(self, b: int, K: int) -> slice:
        return self._part(K, self.n_member, "K", self.coords(b)[0])

    def rows(self, b: int, ny: int) -> slice:
        return self._part(ny, self.n_dy, "ny", self.coords(b)[1])

    def cols(self, b: int, nx: int) -> slice:
        return self._part(nx, self.n_dx, "nx", self.coords(b)[2])

    def points(self, b: int, ny: int, nx: int) -> np.ndarray:
        """Global flat gridpoint indices (y·nx + x) of block b's columns, in
        the block's row-major order."""
        ys, xs = self.rows(b, ny), self.cols(b, nx)
        return (np.arange(ys.start, ys.stop)[:, None] * nx
                + np.arange(xs.start, xs.stop)[None, :]).reshape(-1)

    def share(self, b: int, n_points: int) -> slice:
        """The part of a spatial block's n_points (its flattened columns)
        that block b = (p, j, i) analyses: share p of n_member, as
        contiguous runs of as even a size as the division allows (the
        'ensemble transpose')."""
        p = self.coords(b)[0]
        return slice(n_points * p // self.n_member,
                     n_points * (p + 1) // self.n_member)

    def local_members(self, K: int) -> list[int]:
        """The global members of this process's member slabs, in order
        (what it reads from a checkpoint)."""
        slabs = sorted({self.coords(b)[0] for b in self.local})
        w = self._part(K, self.n_member, "K", 0).stop
        return [m * w + k for m in slabs for k in range(w)]

    # -- moving data between blocks --
    def route(self, msgs: list, dtype: torch.dtype, device: torch.device
              ) -> list[list[torch.Tensor] | None]:
        """Deliver messages between processes. msgs: the same list on
        every process, each (src rank, dst rank, payload, shapes): payload
        the list of tensors on src (None elsewhere), shapes theirs. Returns
        per message what this process receives (None when it is not the
        destination): the payload itself inside a process, else fresh
        tensors. Messages between two processes are packed into one buffer
        each and posted in list order (NCCL matches in order, gloo by tag)
        through one batch_isend_irecv."""
        out: list = [None] * len(msgs)
        ops, recvs = [], []
        for n, (src, dst, payload, shapes) in enumerate(msgs):
            if src == self.rank and dst == self.rank:
                out[n] = payload
            elif src == self.rank:
                ops.append(dist.P2POp(dist.isend, _pack(payload), dst,
                                      tag=n))
            elif dst == self.rank:
                buf = torch.empty(sum(int(np.prod(s)) for s in shapes),
                                  dtype=dtype, device=device)
                ops.append(dist.P2POp(dist.irecv, buf, src, tag=n))
                recvs.append((n, buf, shapes))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for n, buf, shapes in recvs:
            out[n] = _unpack(buf, shapes)
        return out

    # -- whole ensembles --
    def shard_ensemble(self, ens, members: bool = True) -> Sharded:
        """This process's blocks of the global ensemble `ens` (a
        DycoreState or tensor, K leading when `members`, else one state
        replicated over the member slabs), each a contiguous copy."""
        f0 = _fields(ens)[0]
        K = f0.shape[0] if members else 0
        ny, nx = f0.shape[-2:]
        blocks = {}
        for b in self.local:
            ys, xs = self.rows(b, ny), self.cols(b, nx)
            ms = self.members(b, K) if members else slice(None)
            blocks[b] = _like(ens, [f[ms][..., ys, xs].contiguous()
                                    for f in _fields(ens)])
        return Sharded(blocks, K, ny, nx)

    def gather_ensemble(self, sh: Sharded):
        """The global ensemble of `sh` on every process (member slab 0's
        blocks for a replicated state), on the blocks' device."""
        proto = next(iter(sh.blocks.values()))
        fields = _fields(proto)
        dtype, device = fields[0].dtype, fields[0].device
        wanted = [b for b in range(self.n_blocks)
                  if sh.K or self.coords(b)[0] == 0]
        msgs = []
        for b in wanted:
            shapes = [f.shape for f in fields]
            for dst in range(self.world):
                payload = (_fields(sh.blocks[b]) if self.owner(b) == self.rank
                           else None)
                msgs.append((self.owner(b), dst, payload, shapes))
        got = self.route(msgs, dtype, device)
        per_block = {b: got[n * self.world + self.rank]
                     for n, b in enumerate(wanted)}
        out = []
        for k, f in enumerate(fields):
            lead = f.shape[1:-2] if sh.K else f.shape[:-2]
            shape = ((sh.K,) if sh.K else ()) + lead + (sh.ny, sh.nx)
            g = torch.empty(shape, dtype=dtype, device=device)
            for b, parts in per_block.items():
                ms = self.members(b, sh.K) if sh.K else slice(None)
                g[ms][..., self.rows(b, sh.ny), self.cols(b, sh.nx)] = \
                    parts[k]
            out.append(g)
        return _like(proto, out)

    def gather_slab(self, sh: Sharded, m: int, dst: int):
        """Member slab m of an ensemble (a tensor or a DycoreState per
        block) over the whole domain, on process `dst` (None on the
        others): its blocks gathered along (dy, dx), one message a block."""
        proto = next(iter(sh.blocks.values()))
        fields = _fields(proto)
        slab = [self.index(m, j, i) for j in range(self.n_dy)
                for i in range(self.n_dx)]
        got = self.route(
            [(self.owner(b), dst, _fields(sh.blocks[b])
              if self.owner(b) == self.rank else None,
              [f.shape for f in fields]) for b in slab],
            fields[0].dtype, fields[0].device)
        if dst != self.rank:
            return None
        out = [torch.empty(f.shape[:-2] + (sh.ny, sh.nx), dtype=f.dtype,
                           device=f.device) for f in fields]
        for b, parts in zip(slab, got):
            for o, part in zip(out, parts):
                o[..., self.rows(b, sh.ny), self.cols(b, sh.nx)] = part
        return _like(proto, out)

    def share_points(self, b: int, ny: int, nx: int) -> np.ndarray:
        """Global flat indices of the gridpoints block b analyses: its share
        of its spatial block's columns."""
        pts = self.points(b, ny, nx)
        return pts[self.share(b, pts.size)]

    def share_index(self, b: int, ny: int, nx: int,
                    device: torch.device) -> torch.Tensor:
        """share_points as an index tensor on `device`, made once for each
        (block, ny, nx, device): a caller that gathers every cycle copies
        nothing from the host (a copy that waits for the device) after the
        first."""
        key = (b, ny, nx, device)
        if key not in self._index:
            self._index[key] = torch.as_tensor(self.share_points(b, ny, nx),
                                               device=device)
        return self._index[key]

    def to_points(self, sh: Sharded) -> dict[int, torch.Tensor]:
        """The 'ensemble transpose' (the reference's
        scatter_grd_mpi_alltoall, common_mpi_scale.f90:1279): from blocks
        (K/n_member, *mid, ny_b, nx_b) in the forecast layout to each block
        (p, j, i) holding share p of spatial block (j, i)'s gridpoints for
        all K members, (K, *mid, B_p) — an all-to-all along the member
        axis only."""
        proto = next(iter(sh.blocks.values()))
        Km, mid = proto.shape[0], proto.shape[1:-2]
        nb = proto.shape[-2] * proto.shape[-1]
        msgs, order = [], []
        for b in range(self.n_blocks):
            _, j, i = self.coords(b)
            sl = self.share(b, nb)
            for m in range(self.n_member):
                src = self.index(m, j, i)
                payload = ([sh.blocks[src].reshape(Km, *mid, nb)[..., sl]]
                           if self.owner(src) == self.rank else None)
                msgs.append((self.owner(src), self.owner(b), payload,
                             [(Km, *mid, sl.stop - sl.start)]))
                order.append(b)
        got = self.route(msgs, proto.dtype, proto.device)
        parts: dict[int, list] = {b: [] for b in self.local}
        for b, g in zip(order, got):
            if g is not None:
                parts[b].append(g[0])
        return {b: torch.cat(p, dim=0) for b, p in parts.items()}

    def from_points(self, shares: dict[int, torch.Tensor], K: int, ny: int,
                    nx: int) -> Sharded:
        """The inverse of to_points: each block (m, j, i) gathers member
        slab m of every share of spatial block (j, i) back into its
        (K/n_member, *mid, ny_b, nx_b) forecast layout."""
        proto = next(iter(shares.values()))
        mid = proto.shape[1:-1]
        nyb, nxb = ny // self.n_dy, nx // self.n_dx
        msgs, order = [], []
        for b in range(self.n_blocks):
            m, j, i = self.coords(b)
            ms = self.members(b, K)
            for p in range(self.n_member):
                src = self.index(p, j, i)
                sl = self.share(src, nyb * nxb)
                payload = ([shares[src][ms]] if self.owner(src) == self.rank
                           else None)
                msgs.append((self.owner(src), self.owner(b), payload,
                             [(ms.stop - ms.start, *mid, sl.stop - sl.start)]))
                order.append(b)
        got = self.route(msgs, proto.dtype, proto.device)
        parts: dict[int, list] = {b: [] for b in self.local}
        for b, g in zip(order, got):
            if g is not None:
                parts[b].append(g[0])
        return Sharded({b: torch.cat(p, dim=-1).reshape(
            p[0].shape[:-1] + (nyb, nxb)) for b, p in parts.items()},
            K, ny, nx)

    def gather_points(self, shares: dict[int, torch.Tensor], ny: int,
                      nx: int) -> torch.Tensor:
        """Per-gridpoint results of every share (each (*lead, B_p)) as one
        (*lead, ny·nx) tensor on every process."""
        proto = next(iter(shares.values()))
        lead = proto.shape[:-1]
        nb = (ny // self.n_dy) * (nx // self.n_dx)
        msgs = []
        for b in range(self.n_blocks):
            sl = self.share(b, nb)
            for dst in range(self.world):
                msgs.append((self.owner(b), dst,
                             [shares[b]] if self.owner(b) == self.rank
                             else None, [(*lead, sl.stop - sl.start)]))
        got = self.route(msgs, proto.dtype, proto.device)
        out = torch.empty((*lead, ny * nx), dtype=proto.dtype,
                          device=proto.device)
        for b in range(self.n_blocks):
            out[..., self.share_index(b, ny, nx, proto.device)] = \
                got[b * self.world + self.rank][0]
        return out


def make_mesh(n_member: int = 1, n_dy: int = 1, n_dx: int = 1
              ) -> ProcessGrid:
    """The (member, dy, dx) grid with every block in this process."""
    return ProcessGrid(n_member, n_dy, n_dx)
