"""One-way nested DA cycling: the parent domain drives the child's boundaries.

Port of scale_letkf_tpu/nested.py (reference: NUM_DOMAIN/PRC_DOMAINS
online nesting, common_nml.f90:56-58; the nesting communicator split,
common_mpi_scale.f90:696-706). Each cycle the parent ensemble's start and
end states are interpolated to the child grid (model/nesting.py) and become
the child's per-member Davies boundary bracket.

Driven from TOML by a [nest] section of the experiment config (cli/main.py
`cycle`):

  [nest]
  i0 = 8.0        # parent fractional x-index of child cell (0,0)
  j0 = 8.0
  ratio = 3       # child dx = parent dx / ratio
  nx = 24
  ny = 24
  nz = 12         # child levels (may differ; interpolated in height)
  dz = 300.0
  bdy_width = 4
  bdy_tau = 120.0

On a process grid (parent and child each a CycleDriver(mesh=) of the same
grid shape) the ensembles flow as Shardeds and the bracket is sharded like
the child's ensemble: each parent member slab is gathered over the parent
domain on the process of its first block, interpolated there by
parent_to_child, and cut into the child's blocks of that slab (ProcessGrid
route), so no process holds the whole parent ensemble. The child's
forecast reads its blocks' bracket per member (CycleDriver._bdy_block).

Each ensemble is handed over and freed as in CycleDriver.run_osse: the
child's start bracket is interpolated from the parent's start ensemble
before the parent forecast consumes it, and both brackets are dropped once
the child forecast has run, so no parent ensemble is ever held twice (the
reference keeps the parent's start and forecast ensembles together).
"""

from __future__ import annotations

import numpy as np

from scale_letkf_torch.model.boundary import BoundaryData
from scale_letkf_torch.model.nesting import NestGeometry, parent_to_child
from scale_letkf_torch.obs.types import Observations
from scale_letkf_torch.parallel.mesh import Sharded


class NestedCycleDriver:
    """Parent + child CycleDrivers coupled one way per cycle."""

    def __init__(self, parent, child, geom: NestGeometry):
        self.parent = parent
        self.child = child
        self.geom = geom
        if child._bdy_w2d is None:
            raise ValueError(
                "child driver needs bdy_width > 0: the nest boundary is "
                "forced by the parent (Davies relaxation buffer)")
        shapes = [None if d.mesh is None else d.mesh.shape
                  for d in (parent, child)]
        if shapes[0] != shapes[1]:
            raise ValueError(f"parent and child need the same process grid "
                             f"(have {shapes[0]} and {shapes[1]})")
        self._zp = np.asarray(parent.grid.cz)
        self._zc = np.asarray(child.grid.cz)
        self._shape = (child.grid.nz, child.grid.ny, child.grid.nx)

    def p2c(self, ens):
        """A parent state or ensemble interpolated to the child grid; a
        parent Sharded to a Sharded of the child's blocks (_p2c_blocks)."""
        if isinstance(ens, Sharded):
            return self._p2c_blocks(ens)
        return parent_to_child(ens, self.geom, self._shape, self._zp,
                               self._zc)

    def _p2c_blocks(self, sh: Sharded) -> Sharded:
        """The child's blocks of parent_to_child of the parent's blocks
        `sh`: each member slab gathered over the parent domain on the
        process of its first block (gather_slab), interpolated there, and
        its child blocks routed to their processes (a view inside a
        process)."""
        grid = self.child.mesh
        nz, ny, nx = self._shape
        proto = next(iter(sh.blocks.values()))
        nz_p = proto.rho.shape[-3]
        # each field's child block shape: the parent's leading axes, its
        # levels moved by the child's level count (ρw keeps its extra face)
        shapes = [f.shape[:-3] + (f.shape[-3] - nz_p + nz, ny // grid.n_dy,
                                  nx // grid.n_dx) for f in proto]
        out = {}
        for m in range(grid.n_member):
            leader = grid.owner(grid.index(m, 0, 0))
            slab = grid.gather_slab(sh, m, leader)
            child = None if slab is None else self.p2c(slab)
            del slab
            dests = [grid.index(m, j, i) for j in range(grid.n_dy)
                     for i in range(grid.n_dx)]
            got = grid.route([(leader, grid.owner(b), None if child is None
                               else [f[..., grid.rows(b, ny),
                                       grid.cols(b, nx)].contiguous()
                                     for f in child], shapes)
                              for b in dests], proto.rho.dtype,
                             proto.rho.device)
            del child
            for b, parts in zip(dests, got):
                if parts is not None:
                    out[b] = type(proto)(*parts)
        return Sharded(out, sh.K, ny, nx)

    def child_boundary(self, p_start, p_end, t0: float, t1: float):
        """Per-member child boundary bracket from parent ensemble states."""
        return BoundaryData(state0=self.p2c(p_start),
                            state1=self.p2c(p_end), t0=t0, t1=t1)

    def cycle(self, p_ens, c_ens, p_obs: Observations,
              c_obs: Observations, steps_parent: int,
              steps_child: int, infl_p=None, infl_c=None):
        """One coupled DA cycle. Returns (p_ens_a, c_ens_a, info dict with
        the 'parent' and 'child' analysis infos).

        The child runs `steps_child` steps over the same window as the
        parent's `steps_parent` (its dt is finer by the nest ratio); its
        Davies targets interpolate between the parent's start and end
        states (per member, one way). A caller that hands p_ens and c_ens
        over (keeps no reference) has each freed once its forecast exists.
        The bracket's interpolations are the parent timer's section
        `nest_bracket`."""
        p, c = self.parent, self.child
        window = steps_parent * p.dycfg.dt
        if p.mesh is not None and not isinstance(p_ens, Sharded):
            p_ens = p.mesh.shard_ensemble(p_ens)
        # one-slot lists hand each ensemble to the step that consumes it
        p_ens, c_ens = [p_ens], [c_ens]
        with p.timer.section("nest_bracket"):
            state0 = self.p2c(p_ens[0])
        p_ens.append(p.forecast(p_ens.pop(), steps_parent))
        with p.timer.section("nest_bracket"):
            c.bdy = BoundaryData(state0=state0, state1=self.p2c(p_ens[0]),
                                 t0=0.0, t1=window)
        del state0
        c_ens.append(c.forecast(c_ens.pop(), steps_child, t0=0.0))
        c.bdy = None
        p_anal, p_info = p.analysis(p_ens.pop(), p_obs, infl_field=infl_p)
        c_anal, c_info = c.analysis(c_ens.pop(), c_obs, infl_field=infl_c)
        return p_anal, c_anal, {"parent": p_info, "child": c_info}
