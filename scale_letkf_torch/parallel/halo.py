"""Explicit halo exchange: the forecast step on a decomposed domain.

Port of scale_letkf_tpu/parallel/halo.py (reference: SCALE's COMM_vars8 /
COMM_wait, common_scale.f90:1385-1397). Each block is extended by HALO_W
cells in y and x from its neighbours' blocks, the same tendencies as the
undecomposed step run on the extended block with PERIODIC rolls (their wrap
pollutes only cells within RADIUS of the extended edge, which are cropped),
and the interior is kept. Open lateral boundaries live in the halo fill
(`exchange_axis` with periodic=False): a block on the domain's edge repeats
its edge value into the outer halo, the ghost-cell convention of the
undecomposed open step. So on a CUDA device kernels #2 and #3 run in their
periodic mode on every extended block, whatever the lateral mode, as the
reference's Pallas kernels do.

Where the reference runs under shard_map on one block's view, the port's
functions take the dict of this process's blocks (parallel/mesh.py
`Sharded.blocks`) and exchange through `ProcessGrid.route`: a copy between
blocks of one process, torch.distributed messages between processes. Each
exchange packs all the fields it carries into one message per direction and
axis. The global-array wrappers `rk3_step_halo`, `rk3_step_halo_ens` and
`rk3_step_si_halo_ens` (shard, step, gather) are the reference's entry
points; `rk3_step_blocks` and `rk3_step_si_blocks` step blocks in place of
them inside the cycle (cycle.py).

`physics_step_blocks` runs the physics suite's step on blocks: its
column schemes per block, the PBL's face ↔ centre averages through two
halo-1 exchanges (the reference runs physics only on its GSPMD path and
refuses it under its explicit halo).

Differences from the JAX module:
- the acoustic substeps exchange dp, then ρu and ρv together (two
  messages a substep carrying the reference's three halo-1 exchanges);
- timer sections `halo` around every exchange (nested in `acoustic` for
  the substeps');
- `to_collocated_blocks` / `from_collocated_blocks`: the restart ↔
  analysis transforms of the cycle's analysis on blocks, with a one-cell
  periodic halo of the momenta (the reference's GSPMD handles them).
"""

from __future__ import annotations

import dataclasses

import torch

from scale_letkf_torch.model.dycore import (
    DycoreConfig, DycoreState, VGrid, _axpy, collocate, rayleigh_sponge,
    stagger, tendencies,
)
from scale_letkf_torch.model.dycore_si import (
    SplitConfig, acoustic_column, acoustic_coeffs)
from scale_letkf_torch.model.pbl import (
    centre_winds, face_momenta, pbl_columns)
from scale_letkf_torch.model.physics_suite import (
    PhysicsConfig, PhysicsState, column_physics, slab_temperature)
from scale_letkf_torch.model.terrain import (
    TerrainMetrics, tendencies_terrain,
)
from scale_letkf_torch.parallel.mesh import (
    AXIS_DX, AXIS_DY, ProcessGrid, Sharded,
)
from scale_letkf_torch.state import IR_RHOU, IR_RHOV
from scale_letkf_torch.utils.timing import Timer, maybe_section

HALO_W = 4
RADIUS = 3      # total stencil radius (UD3 + momentum composition ≤ 3)


def _edge(f: torch.Tensor, dim: int, h: int, side: str) -> torch.Tensor:
    """Open-boundary halo: the edge slice repeated h times."""
    at = 0 if side == "lo" else f.shape[dim] - 1
    e = f.narrow(dim, at, 1)
    shape = list(e.shape)
    shape[dim] = h
    return e.expand(shape)


def _exchange(grid: ProcessGrid, blocks: dict, dim_from_end: int,
              axis_name: str, h: int, periodic: bool) -> dict:
    """Extend every block's fields (blocks: index → list of tensors) by h
    cells on both sides of the axis dim_from_end from the end (2: y, 1: x),
    from the ring neighbours along axis_name; with periodic=False the
    domain's first and last blocks repeat their edge value instead."""
    n = grid.size(axis_name)
    proto = next(iter(blocks.values()))
    dims = [f.dim() - dim_from_end for f in proto]

    def slab(fields, side):
        return [f.narrow(d, 0 if side == "lo" else f.shape[d] - h, h)
                for f, d in zip(fields, dims)]

    shapes = [s.shape for s in slab(proto, "lo")]
    left, right = {}, {}
    if n == 1:
        for b, fields in blocks.items():
            left[b], right[b] = slab(fields, "hi"), slab(fields, "lo")
    else:
        msgs, dests = [], []
        for b in range(grid.n_blocks):
            pos = grid.position(b, axis_name)
            for side, step, keep in (("hi", -1, left), ("lo", 1, right)):
                if not periodic and pos == (0 if step < 0 else n - 1):
                    continue
                nb = grid.neighbor(b, axis_name, step)
                src = grid.owner(nb)
                msgs.append((src, grid.owner(b),
                             slab(blocks[nb], side) if src == grid.rank
                             else None, shapes))
                dests.append((b, keep))
        got = grid.route(msgs, proto[0].dtype, proto[0].device)
        for (b, keep), parts in zip(dests, got):
            if parts is not None:
                keep[b] = parts
    out = {}
    for b, fields in blocks.items():
        pos = grid.position(b, axis_name)
        lo = left.get(b)
        hi = right.get(b)
        if not periodic and pos == 0:
            lo = [_edge(f, d, h, "lo") for f, d in zip(fields, dims)]
        if not periodic and pos == n - 1:
            hi = [_edge(f, d, h, "hi") for f, d in zip(fields, dims)]
        out[b] = [torch.cat([a, f, c], dim=d)
                  for a, f, c, d in zip(lo, fields, hi, dims)]
    return out


def exchange_axis(grid: ProcessGrid, local: dict, axis: int, axis_name: str,
                  h: int = HALO_W, periodic: bool = True) -> dict:
    """Extend each block's tensor (local: block index → tensor) with h halo
    cells on both sides of `axis` (-2 or -1, or its positive index), filled
    from the ring neighbours along grid axis `axis_name`; n == 1 wraps the
    block onto itself. With periodic=False the first and last blocks clamp
    their outer halo to the domain-edge value instead of wrapping."""
    f0 = next(iter(local.values()))
    dim_from_end = f0.dim() - (axis % f0.dim())
    ext = _exchange(grid, {b: [t] for b, t in local.items()}, dim_from_end,
                    axis_name, h, periodic)
    return {b: v[0] for b, v in ext.items()}


def extend_fields(grid: ProcessGrid, blocks: dict, h: int, periodic: bool,
                  timer: Timer | None = None) -> dict:
    """Extend every block's fields (index → list of tensors, (y, x) last) by
    h cells in y, then in x (corners from the y-extended neighbours): one
    packed message per direction and axis. Timer section `halo`."""
    with maybe_section(timer, "halo"):
        blocks = _exchange(grid, blocks, 2, AXIS_DY, h, periodic)
        return _exchange(grid, blocks, 1, AXIS_DX, h, periodic)


def extend_state(grid: ProcessGrid, blocks: dict, h: int = HALO_W,
                 periodic: bool = True, timer: Timer | None = None) -> dict:
    """Halo-extend every field of every block's DycoreState in y and x."""
    ext = extend_fields(grid, {b: list(s) for b, s in blocks.items()}, h,
                        periodic, timer)
    return {b: DycoreState(*v) for b, v in ext.items()}


def crop_state(s, h: int = HALO_W):
    """The interior of an extended DycoreState (or TerrainMetrics)."""
    return type(s)(*(a[..., h:-h, h:-h] for a in s))


def _strip(s, axis_from_end: int, start: int, stop: int):
    """Every field of a DycoreState (or TerrainMetrics) sliced along y
    (axis_from_end=2) or x (=1), as contiguous fields (the kernels take no
    views)."""
    return type(s)(*(a.narrow(a.dim() - axis_from_end, start,
                              stop - start).contiguous() for a in s))


def _tend_on(block: DycoreState, cfg: DycoreConfig, rho_ref, p_ref,
             vg: VGrid | None, metrics: TerrainMetrics | None
             ) -> DycoreState:
    """The tendencies of an extended block with periodic rolls: the open
    clamp lives in the halo fill."""
    cfg_p = dataclasses.replace(cfg, lateral="periodic")
    if metrics is not None:
        return tendencies_terrain(block, cfg_p, rho_ref, p_ref, metrics, vg)
    return tendencies(block, cfg_p, rho_ref, p_ref, vg)


def _local_tend(grid: ProcessGrid, blocks: dict, cfg: DycoreConfig, rho_ref,
                p_ref, vg, overlap: bool = False, metrics: dict | None = None,
                timer: Timer | None = None) -> dict:
    """Each block's slow tendencies from its HALO_W-extended state (section
    `tendencies`). overlap: the interior from the block alone, which needs
    no message, then the edge bands from strips of the extended block
    (height 3·RADIUS: the RADIUS target rows and RADIUS margin each side;
    the x strips span the extended y, so corners are covered) — the
    reference's first step of compute/communication overlap. metrics:
    each block's HALO_W-extended terrain metrics (extended_metrics), cut
    like the state: the interior's from the block's own columns, each
    strip's from the strip's rows and columns."""
    h, r = HALO_W, RADIUS
    periodic = cfg.lateral == "periodic"
    ext = extend_state(grid, blocks, h, periodic, timer)
    out = {}
    with maybe_section(timer, "tendencies"):
        for b, s_loc in blocks.items():
            m = None if metrics is None else metrics[b]
            if not overlap:
                out[b] = crop_state(_tend_on(ext[b], cfg, rho_ref, p_ref, vg,
                                             m), h)
                continue
            ny, nx = s_loc.rho.shape[-2:]
            t = DycoreState(*(f.clone() for f in _tend_on(
                s_loc, cfg, rho_ref, p_ref, vg,
                None if m is None else crop_state(m, h))))
            e = ext[b]
            for axis, at, start in ((2, 0, h - r), (2, ny - r, ny + h - 2 * r),
                                    (1, 0, h - r), (1, nx - r, nx + h - 2 * r)):
                st = _tend_on(_strip(e, axis, start, start + 3 * r), cfg,
                              rho_ref, p_ref, vg,
                              None if m is None
                              else _strip(m, axis, start, start + 3 * r))
                for dst, src in zip(t, st):
                    if axis == 2:
                        dst[..., at:at + r, :] = src[..., r:2 * r, h:h + nx]
                    else:
                        dst[..., :, at:at + r] = src[..., h:h + ny, r:2 * r]
            out[b] = t
    return out


def rk3_step_blocks(grid: ProcessGrid, blocks: dict, cfg: DycoreConfig,
                    rho_ref, p_ref, z_center, vg: VGrid | None = None,
                    overlap: bool = False, metrics: dict | None = None,
                    timer: Timer | None = None) -> dict:
    """One RK3 step of the explicit core on this process's blocks (index →
    DycoreState, any leading member axes), one halo exchange per stage,
    then the Rayleigh sponge (section `sponge`). With terrain, `metrics`:
    each block's extended metrics (extended_metrics), the slow tendencies
    model/terrain.py's rk3_step_terrain takes."""
    dt = cfg.dt

    def f(d):
        return _local_tend(grid, d, cfg, rho_ref, p_ref, vg, overlap,
                           metrics, timer)

    f1 = f(blocks)
    s1 = {b: _axpy(s, f1[b], 1.0 / 3.0, dt) for b, s in blocks.items()}
    del f1
    f2 = f(s1)
    s2 = {b: _axpy(s, f2[b], 0.5, dt) for b, s in blocks.items()}
    del f2, s1
    f3 = f(s2)
    s3 = {b: _axpy(s, f3[b], 1.0, dt) for b, s in blocks.items()}
    del f3, s2
    with maybe_section(timer, "sponge"):
        return {b: rayleigh_sponge(s3[b], s, cfg, z_center, dt)
                for b, s in blocks.items()}


def _xp1(ae):
    return ae[..., 1:-1, 2:]


def _xm1(ae):
    return ae[..., 1:-1, :-2]


def _yp1(ae):
    return ae[..., 2:, 1:-1]


def _ym1(ae):
    return ae[..., :-2, 1:-1]


def _acoustic_substeps_halo(grid: ProcessGrid, s_start: dict, s_stage: dict,
                            slow: dict, cfg: DycoreConfig, split: SplitConfig,
                            n_steps: int, dt_stage: float, vg=None,
                            timer: Timer | None = None) -> dict:
    """model/dycore_si.py acoustic_substeps on blocks: halo-1 exchanges
    where the undecomposed version rolls — θ's face values once a stage,
    and each substep dp (the pressure gradient needs dp at i+1, j+1), then
    the updated ρu and ρv (the divergences need them at i−1, j−1). The
    column operators and the vertical part of each substep are
    acoustic_substeps' own (acoustic_coeffs, acoustic_column: z stays
    column-local, the implicit solve needs no halo); the horizontal
    arithmetic is its, in its order, with halo slices for its rolls."""
    periodic = cfg.lateral == "periodic"
    dx, dy = cfg.dx, cfg.dy
    dtau = dt_stage / n_steps
    co, st = {}, {}
    for b, s in s_stage.items():
        co[b] = acoustic_coeffs(s, cfg, split, dtau, vg)
        s0 = s_start[b]
        st[b] = [s0.rho - s.rho, s0.rhou - s.rhou, s0.rhov - s.rhov,
                 s0.rhow - s.rhow, s0.rhot - s.rhot]

    th_e = extend_fields(grid, {b: [c["theta0"]] for b, c in co.items()}, 1,
                         periodic, timer)
    for b, c in co.items():
        c["theta_xf"] = 0.5 * (c["theta0"] + _xp1(th_e[b][0]))
        c["theta_yf"] = 0.5 * (c["theta0"] + _yp1(th_e[b][0]))
    del th_e
    tf_e = extend_fields(grid, {b: [c["theta_xf"], c["theta_yf"]]
                                for b, c in co.items()}, 1, periodic, timer)
    for b, c in co.items():
        c["theta_xf_m1"] = _xm1(tf_e[b][0])
        c["theta_yf_m1"] = _ym1(tf_e[b][1])
    del tf_e

    for _ in range(n_steps):
        dp = {b: co[b]["c2"] * st[b][4] for b in st}
        dpe = extend_fields(grid, {b: [d] for b, d in dp.items()}, 1,
                            periodic, timer)
        for b, (drho, drhou, drhov, drhow, drhot) in st.items():
            sl = slow[b]
            dpb = dp[b]
            drhou = drhou + dtau * (-((_xp1(dpe[b][0]) - dpb) / dx)
                                    + sl.rhou)
            drhov = drhov + dtau * (-((_yp1(dpe[b][0]) - dpb) / dy)
                                    + sl.rhov)
            st[b] = [drho, drhou, drhov, drhow, drhot]
        del dpe
        uve = extend_fields(grid, {b: [v[1], v[2]] for b, v in st.items()},
                            1, periodic, timer)
        for b, (drho, drhou, drhov, drhow, drhot) in st.items():
            c = co[b]
            ue, ve = uve[b]
            div_h = ((drhou - _xm1(ue)) / dx + (drhov - _ym1(ve)) / dy)
            u_th = drhou * c["theta_xf"]
            v_th = drhov * c["theta_yf"]
            div_h_th = ((u_th - _xm1(ue) * c["theta_xf_m1"]) / dx
                        + (v_th - _ym1(ve) * c["theta_yf_m1"]) / dy)
            drho, drhow, drhot = acoustic_column(
                c, drho, drhow, drhot, dp[b], div_h, div_h_th, slow[b],
                dtau, split.beta)
            st[b] = [drho, drhou, drhov, drhow, drhot]
        del uve, dp

    out = {}
    for b, (drho, drhou, drhov, drhow, drhot) in st.items():
        s, s0, sl = s_stage[b], s_start[b], slow[b]
        out[b] = DycoreState(rho=s.rho + drho, rhou=s.rhou + drhou,
                             rhov=s.rhov + drhov, rhow=s.rhow + drhow,
                             rhot=s.rhot + drhot,
                             rhoq=s0.rhoq + dt_stage * sl.rhoq)
    return out


def _extend_metrics(grid: ProcessGrid, m_blocks: dict, h: int,
                    periodic: bool) -> dict:
    """Halo-extend each block's (time-invariant) terrain metrics."""
    ext = extend_fields(grid, {b: list(m) for b, m in m_blocks.items()}, h,
                        periodic)
    return {b: TerrainMetrics(*v) for b, v in ext.items()}


def extended_metrics(grid: ProcessGrid, metrics: TerrainMetrics | None,
                     periodic: bool) -> dict | None:
    """This process's blocks of the global terrain metrics, each extended by
    HALO_W (None without metrics)."""
    if metrics is None:
        return None
    sh = grid.shard_ensemble(metrics, members=False)
    return _extend_metrics(grid, sh.blocks, HALO_W, periodic)


def rk3_step_si_blocks(grid: ProcessGrid, blocks: dict, cfg: DycoreConfig,
                       split: SplitConfig, rho_ref, p_ref, z_center,
                       n_small: int, vg: VGrid | None = None,
                       metrics: dict | None = None,
                       timer: Timer | None = None) -> dict:
    """One split-explicit (HEVI) RK3 step on this process's blocks: slow
    tendencies on HALO_W-extended blocks (with terrain, `metrics`: each
    block's extended metrics, extended_metrics), acoustic substeps with
    halo-1 exchanges, then the sponge. Timer sections `halo`,
    `tendencies`, `acoustic` (with its own `halo`) and `sponge`."""
    dt = cfg.dt

    def stage(s_from, dt_stage, ns):
        slow = _local_tend(grid, s_from, cfg, rho_ref, p_ref, vg,
                           metrics=metrics, timer=timer)
        with maybe_section(timer, "acoustic"):
            return _acoustic_substeps_halo(grid, blocks, s_from, slow, cfg,
                                           split, ns, dt_stage, vg, timer)

    s1 = stage(blocks, dt / 3.0, max(1, n_small // 3))
    s2 = stage(s1, dt / 2.0, max(1, n_small // 2))
    del s1
    s3 = stage(s2, dt, n_small)
    del s2
    with maybe_section(timer, "sponge"):
        return {b: rayleigh_sponge(s3[b], s, cfg, z_center, dt)
                for b, s in blocks.items()}


def physics_step_blocks(grid: ProcessGrid, blocks: dict, phys: dict,
                        step_index: int, pcfg: PhysicsConfig, dt: float,
                        dz: float, zc, periodic: bool,
                        timer: Timer | None = None) -> tuple[dict, dict]:
    """model/physics_suite.py physics_step on this process's blocks (index →
    DycoreState; phys: index → the block's PhysicsState). The microphysics,
    radiation, column solves and slab are each block's own; the PBL's face
    ↔ centre averages read one neighbour column, so (ρu, ρv) are exchanged
    with a halo of 1 before the column solve and (du, dv) with ρ after it
    (a halo column's du needs that column's solve, its skin temperature
    included: the results travel, not the inputs). Open lateral boundaries
    clamp the halo to the edge value, as roll_x/roll_y do at the domain's
    edge. The arithmetic is physics_step's, in its order. Returns (blocks,
    phys). Timer section `halo` for the exchanges."""
    pre = {b: column_physics(s, phys[b], step_index, pcfg, dt, dz)
           for b, s in blocks.items()}
    if not pcfg.use_pbl:
        return ({b: p[0] for b, p in pre.items()},
                {b: PhysicsState(phys[b].tsfc, p[1], p[2])
                 for b, p in pre.items()})
    ext = extend_fields(grid, {b: [p[0].rhou, p[0].rhov]
                               for b, p in pre.items()}, 1, periodic, timer)
    cols = {}
    for b, (s, _, _) in pre.items():
        u, v = centre_winds(s, _xm1(ext[b][0]), _ym1(ext[b][1]))
        cols[b] = pbl_columns(s, u, v, dt, dz, zc, phys[b].tsfc, z0=pcfg.z0,
                              z0h=pcfg.z0h, beta=pcfg.beta)
    del ext, u, v
    ext = extend_fields(grid, {b: [c.du, c.dv, pre[b][0].rho]
                               for b, c in cols.items()}, 1, periodic, timer)
    out, out_phys = {}, {}
    for b, c in cols.items():
        s, drhot_rad, rad_sfc = pre[b]
        due, dve, rhoe = ext[b]
        rhou, rhov = face_momenta(s, c.du, c.dv, _xp1(due), _yp1(dve),
                                  _xp1(rhoe), _yp1(rhoe))
        out[b] = s._replace(rhou=rhou, rhov=rhov, rhot=c.rhot, rhoq=c.rhoq)
        out_phys[b] = PhysicsState(
            slab_temperature(phys[b].tsfc, rad_sfc, c.sfc, pcfg, dt),
            drhot_rad, rad_sfc)
    return out, out_phys


# -- the reference's entry points: global states in and out --

def rk3_step_halo(s: DycoreState, cfg: DycoreConfig, rho_ref, p_ref,
                  z_center, mesh: ProcessGrid, vg: VGrid | None = None,
                  overlap: bool = False) -> DycoreState:
    """One explicit RK3 step of a global state (no member axis) with halo
    exchange per stage; the state is replicated over the member slabs."""
    sh = mesh.shard_ensemble(s, members=False)
    out = rk3_step_blocks(mesh, sh.blocks, cfg, rho_ref, p_ref, z_center, vg,
                          overlap)
    return mesh.gather_ensemble(sh._replace(blocks=out))


def rk3_step_halo_ens(ens: DycoreState, cfg: DycoreConfig, rho_ref, p_ref,
                      z_center, mesh: ProcessGrid, vg: VGrid | None = None,
                      overlap: bool = False) -> DycoreState:
    """The ensemble halo step: (K, ...) global state, the member axis over
    the grid's member slabs and (ny, nx) over (dy, dx)."""
    sh = mesh.shard_ensemble(ens)
    out = rk3_step_blocks(mesh, sh.blocks, cfg, rho_ref, p_ref, z_center, vg,
                          overlap)
    return mesh.gather_ensemble(sh._replace(blocks=out))


def rk3_step_si_halo_ens(ens: DycoreState, cfg: DycoreConfig,
                         split: SplitConfig, rho_ref, p_ref, z_center,
                         mesh: ProcessGrid, n_small: int,
                         vg: VGrid | None = None,
                         metrics: TerrainMetrics | None = None,
                         overlap: bool = False) -> DycoreState:
    """The split-explicit ensemble halo step of a (K, ...) global state;
    terrain metrics halo-extended once. overlap is accepted and unused, as
    in the reference (its SI slow tendencies always take the extended
    block)."""
    del overlap
    sh = mesh.shard_ensemble(ens)
    m = extended_metrics(mesh, metrics, cfg.lateral == "periodic")
    out = rk3_step_si_blocks(mesh, sh.blocks, cfg, split, rho_ref, p_ref,
                             z_center, n_small, vg, m)
    return mesh.gather_ensemble(sh._replace(blocks=out))


# -- the analysis's restart ↔ analysis transforms on blocks --

def to_collocated_blocks(grid: ProcessGrid, sh: Sharded,
                         timer: Timer | None = None) -> Sharded:
    """dycore.to_collocated (periodic, as CycleDriver.analysis) of every
    block: ρu and ρv take their west/south neighbours from a one-cell
    halo."""
    ext = extend_fields(grid, {b: [s.rhou, s.rhov]
                               for b, s in sh.blocks.items()}, 1, True, timer)
    return sh._replace(blocks={
        b: collocate(s, _xm1(ext[b][0]), _ym1(ext[b][1]))
        for b, s in sh.blocks.items()})


def from_collocated_blocks(grid: ProcessGrid, sh: Sharded,
                           timer: Timer | None = None) -> Sharded:
    """dycore.from_collocated (periodic) of every block of a stacked
    collocated view: the center momenta east and north from a one-cell
    halo."""
    ext = extend_fields(grid, {b: [v[..., IR_RHOU, :, :, :],
                                   v[..., IR_RHOV, :, :, :]]
                               for b, v in sh.blocks.items()}, 1, True, timer)
    return sh._replace(blocks={
        b: stagger(v, _xp1(ext[b][0]), _yp1(ext[b][1]))
        for b, v in sh.blocks.items()})
