"""The port's halo exchange and halo steps (scale_letkf_torch/parallel/halo.py)
against the reference's (scale_letkf_tpu/parallel/halo.py under shard_map on
the 8 virtual CPU devices), from the same numpy inputs, NZ, NY, NX = 12, 16,
16 as tests/test_halo.py.

Bounds:
- exchange_axis: exactly the reference's halo values (a copy);
- explicit halo steps (5 steps, as tests/test_halo.py; 2 for the overlap
  variant, whose reference step is the slow one here) against the
  reference's halo step on the same (1, 2, 2) or (2, 2, 2) mesh, per field:
  1e-4·max|increment| + 2 ulp of max|field| (tests/test_torch_dycore.py's
  bound for 3 undecomposed steps; the reference holds its own halo step
  to its global one at rtol 2e-6 / atol 1e-4) plus twice the port's own
  rounding floor (a second run from inputs perturbed by one rounding: the
  float32 steps amplify rounding, and over 5 steps ρw moves past the
  3-step bound), and in the periodic mode
  exactly the port's undecomposed step (the same arithmetic on the same
  values);
- the SI halo step with stretched levels and terrain (2 steps, (2, 2, 2)):
  the same bound (tests/test_torch_dycore_si.py's for the SI core), and the
  port's undecomposed SI step to rtol 3e-5 / atol 1e-4·max|field| (the
  reference's bound for its SI halo step against GSPMD).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from scale_letkf_tpu.grid import Grid as RefGrid
from scale_letkf_tpu.model import dycore as ref_dycore
from scale_letkf_tpu.model import dycore_si as ref_si
from scale_letkf_tpu.model import ideal as ref_ideal
from scale_letkf_tpu.model.terrain import make_metrics as ref_metrics
from scale_letkf_tpu.parallel import halo as ref_halo
from scale_letkf_tpu.parallel.mesh import make_mesh as ref_make_mesh
from scale_letkf_torch.io.convert import (
    dycore_config_from_dict, dycore_state_to_numpy, dycore_state_to_torch,
    vgrid_to_torch,
)
from scale_letkf_torch.model import dycore, dycore_si
from scale_letkf_torch.model.terrain import make_metrics
from scale_letkf_torch.parallel import halo
from scale_letkf_torch.parallel.mesh import make_mesh
from test_halo import DX, DY, DZ, NX, NY, NZ, _case

torch.set_num_threads(1)
CPU = torch.device("cpu")
STEPS = 5
STEPS_OVERLAP = 2     # the reference's overlap step costs ~2 s a step here


def _np(s):
    return [np.asarray(f) for f in s]


def _port(cfg_r, s_r, rho_ref, p_ref, zc, vg_r):
    cfg = dycore_config_from_dict(dataclasses.asdict(cfg_r))
    return (cfg, dycore_state_to_torch(_np(s_r), CPU),
            torch.as_tensor(np.asarray(rho_ref), dtype=torch.float32),
            torch.as_tensor(np.asarray(p_ref), dtype=torch.float32),
            torch.as_tensor(np.asarray(zc), dtype=torch.float32),
            None if vg_r is None else vgrid_to_torch(vg_r, CPU))


def _assert_close(out, ref, init, extra=None):
    """|out − ref| ≤ 1e-4·max|ref − init| + 2 ulp(max|init|) (+ extra)."""
    for k, (name, a, b, f0) in enumerate(zip(dycore.DycoreState._fields,
                                             out, ref, init)):
        a, b, f0 = (np.asarray(x, np.float64) for x in (a, b, f0))
        tol = (1e-4 * np.abs(b - f0).max()
               + 2 * np.spacing(np.float32(np.abs(f0).max()))
               + (extra[k] if extra else 0.0))
        err = np.abs(a - b).max()
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def _rounded(s, seed):
    """s with every value perturbed by one float32 rounding (relative
    2⁻²⁴·N(0, 1))."""
    gen = torch.Generator().manual_seed(seed)
    return type(s)(*(f * (1.0 + 2.0 ** -24 * torch.randn(
        f.shape, generator=gen, dtype=torch.float64)).to(f.dtype)
        for f in s))


def _floor(out, alt):
    """Twice the port's own rounding floor per field: |out − alt| of a run
    from inputs perturbed by one rounding."""
    return [2 * float((a - b).abs().max()) for a, b in zip(out, alt)]


def test_exchange_axis_matches_reference():
    """tests/test_halo.py's case: 16 values over 4 blocks along dx, a halo
    of 2 — the round trip, and block 0's left halo from the global right
    edge (periodic); and the open fill, the edge value repeated."""
    mesh_r = ref_make_mesh(1, 1, 4)

    @partial(shard_map, mesh=mesh_r, in_specs=(P(None, "dx"),),
             out_specs=P(None, "dx"))
    def ref_ext(loc):
        return ref_halo.exchange_axis(loc, 1, "dx", 2)

    x = np.arange(16.0).reshape(1, 16)
    want = np.asarray(ref_ext(jnp.asarray(x)))        # (1, 4 × 8)
    mesh = make_mesh(1, 1, 4)
    sh = mesh.shard_ensemble(torch.as_tensor(x), members=False)
    ext = halo.exchange_axis(mesh, sh.blocks, 1, "dx", 2)
    got = np.concatenate([ext[b].numpy() for b in range(4)], axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ext[0][0, :2].numpy(), [14.0, 15.0])
    np.testing.assert_array_equal(
        np.concatenate([ext[b][:, 2:-2].numpy() for b in range(4)], 1), x)
    opened = halo.exchange_axis(mesh, sh.blocks, -1, "dx", 2, periodic=False)
    np.testing.assert_array_equal(opened[0][0, :2].numpy(), [0.0, 0.0])
    np.testing.assert_array_equal(opened[3][0, -2:].numpy(), [15.0, 15.0])
    np.testing.assert_array_equal(opened[1][0, :2].numpy(), [2.0, 3.0])


@pytest.mark.parametrize("lateral,stretched,overlap", [
    ("periodic", False, False), ("open", False, False),
    ("periodic", True, False), ("periodic", False, True)])
def test_halo_step_matches_reference(lateral, stretched, overlap):
    cfg_r, s_r, rr_r, pr_r, zc_r, vg_r = _case(lateral, stretched)
    steps = STEPS_OVERLAP if overlap else STEPS
    mesh_r = ref_make_mesh(1, 2, 2)
    step_r = jax.jit(lambda st: ref_halo.rk3_step_halo(
        st, cfg_r, rr_r, pr_r, zc_r, mesh_r, vg=vg_r, overlap=overlap))
    ref = s_r
    for _ in range(steps):
        ref = step_r(ref)
    cfg, s, rr, pr, zc, vg = _port(cfg_r, s_r, rr_r, pr_r, zc_r, vg_r)
    mesh = make_mesh(1, 2, 2)

    def run(state):
        for _ in range(steps):
            state = halo.rk3_step_halo(state, cfg, rr, pr, zc, mesh, vg=vg,
                                       overlap=overlap)
        return state

    out = run(s)
    _assert_close(dycore_state_to_numpy(out), _np(ref), _np(s_r),
                  extra=_floor(out, run(_rounded(s, 7))))
    if lateral == "periodic":
        glob = s
        for _ in range(steps):
            glob = dycore.rk3_step(glob, cfg, rr, pr, zc, vg)
        for a, b in zip(out, glob):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _offcentre_bubble(lateral):
    """tests/test_halo.py's case with the bubble moved next to the domain's
    corner, so that the fields at the open edges are not uniform."""
    cfg_r, _, rr_r, pr_r, zc_r, vg_r = _case(lateral)
    s, _, _ = ref_ideal.balanced_state(NZ, NY, NX, DZ)
    s = ref_ideal.add_warm_bubble(s, DZ, DX, DY, amplitude=2.0,
                                  center=(2.5 * DX, 3.5 * DY, 1.5e3),
                                  radius=(4e3, 4e3, 1.5e3))
    return cfg_r, s, rr_r, pr_r, zc_r, vg_r


def test_open_halo_step_gap_to_the_global_open_step():
    """A known behaviour of the reference, which the port keeps: the open
    halo step clamps the halo's INPUTS at the domain edge, while the
    global open step clamps its derived fields too, so on a state whose
    edges are not uniform the two part (tests/test_halo.py hides this with
    a centred bubble). The port's open halo step equals the reference's
    (the bound above) and differs from the port's global open step."""
    cfg_r, s_r, rr_r, pr_r, zc_r, vg_r = _offcentre_bubble("open")
    mesh_r = ref_make_mesh(1, 2, 2)
    ref = jax.jit(lambda st: ref_halo.rk3_step_halo(
        st, cfg_r, rr_r, pr_r, zc_r, mesh_r))(s_r)
    cfg, s, rr, pr, zc, _ = _port(cfg_r, s_r, rr_r, pr_r, zc_r, vg_r)
    mesh = make_mesh(1, 2, 2)
    out = halo.rk3_step_halo(s, cfg, rr, pr, zc, mesh)
    _assert_close(dycore_state_to_numpy(out), _np(ref), _np(s_r),
                  extra=_floor(out, halo.rk3_step_halo(_rounded(s, 6), cfg,
                                                       rr, pr, zc, mesh)))
    glob = dycore.rk3_step(s, cfg, rr, pr, zc)
    gap = {n: float((a - b).abs().max() / b.abs().max())
           for n, a, b in zip(dycore.DycoreState._fields[:5], out, glob)}
    print("open halo step − global open step, relative to max|field|:",
          gap)
    assert max(gap.values()) > 1e-7


def _ensemble(s_r, K, seed):
    """K members: s_r with seeded relative noise of 1e-3 on every field
    (numpy, so both packages start from the same numbers)."""
    rng = np.random.default_rng(seed)
    return [np.stack([f * (1.0 + 1e-3 * rng.standard_normal(f.shape))
                      for _ in range(K)]).astype(np.float32)
            for f in _np(s_r)]


def test_halo_step_ensemble_member_axis():
    """rk3_step_halo_ens on the (2, 2, 2) mesh (members over the member
    axis), 3 steps as tests/test_halo.py."""
    cfg_r, s_r, rr_r, pr_r, zc_r, vg_r = _case()
    ens = _ensemble(s_r, 4, 0)
    mesh_r = ref_make_mesh(2, 2, 2)
    step_r = jax.jit(lambda st: ref_halo.rk3_step_halo_ens(
        st, cfg_r, rr_r, pr_r, zc_r, mesh_r))
    ref = ref_dycore.DycoreState(*(jnp.asarray(f) for f in ens))
    cfg, _, rr, pr, zc, _ = _port(cfg_r, s_r, rr_r, pr_r, zc_r, vg_r)
    mesh = make_mesh(2, 2, 2)
    for _ in range(3):
        ref = step_r(ref)

    def run(state):
        for _ in range(3):
            state = halo.rk3_step_halo_ens(state, cfg, rr, pr, zc, mesh)
        return state

    out = run(dycore_state_to_torch(ens, CPU))
    _assert_close(dycore_state_to_numpy(out), _np(ref), ens,
                  extra=_floor(out, run(_rounded(
                      dycore_state_to_torch(ens, CPU), 8))))


def _si_case():
    """tests/test_halo.py's SI case: stretched levels (1.05), qv, a bubble,
    Gaussian terrain of 120 m, 4 members, dt 4 s, 4 substeps."""
    grid = RefGrid.stretched(nx=NX, ny=NY, nz=NZ, dx=DX, dy=DY, dz0=DZ,
                             stretch=1.05)
    qv = 0.006 * np.exp(-np.asarray(grid.cz) / 3000.0)
    s, rr, pr = ref_ideal.balanced_state(NZ, NY, NX, DZ, qv_prof=qv,
                                         cz=grid.cz)
    s = ref_ideal.add_warm_bubble(s, DZ, DX, DY, amplitude=2.0)
    xg, yg = np.meshgrid(np.arange(NX), np.arange(NY))
    topo = (120.0 * np.exp(-(((xg - NX / 2) / 3.0) ** 2
                             + ((yg - NY / 2) / 3.0) ** 2))).astype(np.float32)
    cfg = ref_dycore.DycoreConfig(dx=DX, dy=DY, dz=DZ, dt=4.0,
                                  ztop=grid.ztop,
                                  sponge_height=0.8 * grid.ztop,
                                  sponge_tau=60.0)
    return grid, s, rr, pr, topo, cfg


def test_si_halo_step_with_terrain_matches_reference():
    grid, s_r, rr_r, pr_r, topo, cfg_r = _si_case()
    ens = _ensemble(s_r, 4, 3)
    vg_r = ref_dycore.make_vgrid(grid.cz, grid.fz)
    zc_r = jnp.asarray(grid.cz, jnp.float32)
    m_r = ref_metrics(jnp.asarray(topo), grid.cz, grid.fz, DX, DY)
    split = dycore_si.SplitConfig(dtau=1.0)
    mesh_r = ref_make_mesh(2, 2, 2)
    step_r = jax.jit(lambda st: ref_halo.rk3_step_si_halo_ens(
        st, cfg_r, ref_si.SplitConfig(dtau=1.0), rr_r, pr_r, zc_r, mesh_r,
        4, vg=vg_r, metrics=m_r))
    ref = ref_dycore.DycoreState(*(jnp.asarray(f) for f in ens))
    for _ in range(2):
        ref = step_r(ref)
    cfg, _, rr, pr, zc, vg = _port(cfg_r, s_r, rr_r, pr_r, zc_r, vg_r)
    metrics = make_metrics(torch.from_numpy(topo), grid.cz, grid.fz, DX, DY)
    mesh = make_mesh(2, 2, 2)

    def run(out):
        for _ in range(2):
            out = halo.rk3_step_si_halo_ens(out, cfg, split, rr, pr, zc,
                                            mesh, 4, vg=vg, metrics=metrics)
        return out

    out = run(dycore_state_to_torch(ens, CPU))
    alt = run(_rounded(dycore_state_to_torch(ens, CPU), 9))
    _assert_close(dycore_state_to_numpy(out), _np(ref), ens,
                  extra=_floor(out, alt))
    glob = dycore_state_to_torch(ens, CPU)
    for _ in range(2):
        glob = dycore_si.rk3_step_si(glob, cfg, split, rr, pr, zc, 4, vg,
                                     metrics)
    for a, b in zip(out, glob):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=3e-5, atol=1e-4 * scale)


def test_collocated_blocks_equal_the_global_transforms():
    """to_collocated / from_collocated on (2, 2, 2) blocks with their
    one-cell halo equal the global periodic transforms exactly."""
    cfg_r, s_r, *_ = _case()
    ens = dycore_state_to_torch(_ensemble(s_r, 4, 5), CPU)
    mesh = make_mesh(2, 2, 2)
    sh = mesh.shard_ensemble(ens)
    v = halo.to_collocated_blocks(mesh, sh)
    want = dycore.to_collocated(ens)
    torch.testing.assert_close(mesh.gather_ensemble(v), want, rtol=0, atol=0)
    back = mesh.gather_ensemble(halo.from_collocated_blocks(mesh, v))
    for a, b in zip(back, dycore.from_collocated(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
