"""One-way nesting of the port (model/nesting.py, nested.py) against the
reference package, on the CPU.

- interp_parent_field: the identity nest and exactness on a linear field
  (the reference's own checks, tests/test_nc_nesting.py), each also equal
  to the reference's function.
- parent_to_child with parent and child on different levels (ρw on the
  extrapolated faces) and a child reaching past the parent's edge (the
  clamped taps), seeded fields that vary from cell to cell: rtol 1e-6,
  atol 1e-6·max|field| — the port's taps and weights are float64 host
  geometry, the reference's float32.
- NestedCycleDriver.cycle at tests/test_nested_cycle.py's size (24×24×8
  parent, a ratio-3 24×24×8 child, K = 4, 4 parent and 8 child steps of
  the explicit core), the child periodic and open, obs in both domains:
  each domain's analysis to the restart increments bound of
  tests/test_torch_cycle.py plus twice the port's own float32 rounding
  floor (ROADMAP §3), measured by a second port run from inputs rounded
  once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu.cli.main import make_driver as ref_make_driver
from scale_letkf_tpu.cli.main import make_nested as ref_make_nested
from scale_letkf_tpu.model import nesting as ref_nesting
from scale_letkf_tpu.model.dycore import DycoreState as RefState
from scale_letkf_tpu.model.ideal import (
    add_warm_bubble, balanced_state, perturb_ensemble,
)
from scale_letkf_tpu.obs.types import Observations as RefObservations
from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
from scale_letkf_torch.cli.main import make_nested
from scale_letkf_torch.da.obsmake import make_obs_network, obsmake
from scale_letkf_torch.io.convert import (
    dycore_state_to_numpy, dycore_state_to_torch,
)
from scale_letkf_torch.model import nesting
from scale_letkf_torch.model.dycore import DycoreState, to_collocated
from scale_letkf_torch.state import state_to_history, state_trans
from test_nested_cycle import CONFIG
from test_torch_cycle import assert_increments, floor_of, rounded

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_interp_parent_identity():
    """A ratio-1 nest at the origin reproduces the parent exactly."""
    f = np.random.default_rng(0).standard_normal((5, 8, 8)).astype(np.float32)
    geom = nesting.NestGeometry(i0=0.0, j0=0.0, ratio=1)
    cj, ci = geom.child_coords(8, 8)
    out = nesting.interp_parent_field(torch.from_numpy(f), cj, ci).numpy()
    np.testing.assert_array_equal(out, f)
    ref = ref_nesting.interp_parent_field(jnp.asarray(f), cj, ci)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_interp_linear_field_exact():
    """Bilinear interpolation is exact on linear fields at refined points."""
    nz, ny, nx = 3, 10, 10
    k, j, i = np.mgrid[0:nz, 0:ny, 0:nx]
    f = (2.0 * i + 3.0 * j - k).astype(np.float32)
    geom = nesting.NestGeometry(i0=2.0, j0=3.0, ratio=2)
    cj, ci = geom.child_coords(6, 6)
    out = nesting.interp_parent_field(torch.from_numpy(f), cj, ci).numpy()
    expect = (2.0 * ci[None, None, :] + 3.0 * cj[None, :, None]
              - np.arange(nz)[:, None, None])
    np.testing.assert_allclose(out, expect, rtol=1e-6)
    ref = ref_nesting.interp_parent_field(jnp.asarray(f), cj, ci)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6)


def _levels(nz, dz0, stretch):
    fz = np.concatenate([[0.0], np.cumsum(dz0 * stretch ** np.arange(nz))])
    return 0.5 * (fz[1:] + fz[:-1])


@pytest.mark.parametrize("i0,j0,ratio", [(2.3, 1.7, 3), (-1.5, 4.25, 2)])
def test_parent_to_child_matches_reference(i0, j0, ratio):
    """A 2-member parent on 6 stretched levels into a child on 9 uniform
    levels (heights inside and above the parent's), fields varying cell to
    cell; (-1.5, 4.25, 2) puts the child across the parent's left and
    upper edges."""
    rng = np.random.default_rng(1)
    nz, ny, nx, K, nq = 6, 9, 11, 2, 6
    zp, zc = _levels(nz, 400.0, 1.2), _levels(9, 350.0, 1.0)
    fields = [rng.standard_normal((K, nz, ny, nx)) for _ in range(3)]
    fields.insert(3, rng.standard_normal((K, nz + 1, ny, nx)))
    fields += [rng.standard_normal((K, nz, ny, nx)) * 300.0,
               rng.standard_normal((K, nq, nz, ny, nx))]
    fields = [f.astype(np.float32) for f in fields]
    geom = nesting.NestGeometry(i0=i0, j0=j0, ratio=ratio)
    shape = (9, 7, 8)
    got = nesting.parent_to_child(dycore_state_to_torch(fields, CPU), geom,
                                  shape, zp, zc)
    ref = jax.vmap(lambda s: ref_nesting.parent_to_child(
        s, ref_nesting.NestGeometry(i0, j0, ratio), shape, zp, zc))(
        RefState(*(jnp.asarray(f) for f in fields)))
    for name, a, b in zip(DycoreState._fields, got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)
    # the same levels: the vertical step is the identity
    same = nesting.parent_to_child(dycore_state_to_torch(fields, CPU), geom,
                                   (nz, 7, 8), zp, zp)
    plain = nesting.parent_to_child(dycore_state_to_torch(fields, CPU), geom,
                                    (nz, 7, 8))
    for a, b in zip(same, plain):
        assert torch.equal(a, b)


def _nest_case(lateral, config=CONFIG, extra=""):
    """Both packages' parent and child drivers for `config` (CONFIG) with
    the child's lateral mode and the TOML `extra` appended (a [process]
    table), the parent ensemble and nature run (numpy), the child ensemble
    (the reference's parent_to_child of the parent's), and one cycle's obs
    in both domains (from the nature run advanced 4 steps)."""
    import tempfile
    from pathlib import Path
    text = config.replace("bdy_tau = 60.0",
                          f"bdy_tau = 60.0\nlateral = \"{lateral}\"") + extra
    path = Path(tempfile.mkdtemp()) / "exp.toml"
    path.write_text(text)
    cfg_r, grid_r, dycfg_r, dom_r = ref_load(str(path))
    parent_r = ref_make_driver(cfg_r, grid_r, dycfg_r, dom_r)
    child_r, geom_r, ncd_r = ref_make_nested(cfg_r, grid_r, dycfg_r, dom_r)
    cfg, grid, dycfg, dom = load_config_and_grid(str(path))
    parent = make_driver(cfg, grid, dycfg, dom, CPU)
    child, geom, ncd = make_nested(cfg, grid, dycfg, dom, CPU)
    assert child.dycfg.lateral == lateral == child_r.dycfg.lateral

    K = cfg.ensemble.member
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    s0, _, _ = balanced_state(nz, ny, nx, 500.0)
    s0 = add_warm_bubble(s0, 500.0, grid.dx, grid.dy, amplitude=2.0,
                         center=(nx * grid.dx / 2, ny * grid.dy / 2, 1.5e3),
                         radius=(9e3, 9e3, 1.2e3))
    allp = perturb_ensemble(jax.random.PRNGKey(0), s0, K + 1, amplitude=0.5)
    allp = DycoreState(*(np.asarray(f) for f in allp))
    truth = DycoreState(*(f[0] for f in allp))
    p_ens = DycoreState(*(np.ascontiguousarray(f[1:]) for f in allp))
    cshape = (child.grid.nz, child.grid.ny, child.grid.nx)
    c_ens = DycoreState(*(np.asarray(f) for f in jax.vmap(
        lambda s: ref_nesting.parent_to_child(
            s, geom_r, cshape, np.asarray(grid_r.cz),
            np.asarray(child_r.grid.cz)))(RefState(*map(jnp.asarray,
                                                        p_ens)))))

    rng = np.random.default_rng(0)
    truth_t = parent.forecast_one(dycore_state_to_torch(truth, CPU), 4)
    nf = state_to_history(state_trans(to_collocated(truth_t)),
                          parent.z_full, parent.topo)
    p_obs = obsmake(nf, make_obs_network(grid, rng, n_profiles=16,
                                         levels_hpa=(950.0, 850.0, 750.0)),
                    grid, cfg, parent.z_full, rng)
    ctruth = nesting.parent_to_child(truth_t, geom, cshape, grid.cz,
                                     child.grid.cz)
    cnf = state_to_history(state_trans(to_collocated(ctruth)), child.z_full,
                           child.topo)
    c_obs = obsmake(cnf, make_obs_network(child.grid, rng, n_profiles=10,
                                          levels_hpa=(950.0, 850.0)),
                    child.grid, cfg, child.z_full, rng)
    return ((parent_r, child_r, geom_r, ncd_r), (parent, child, geom, ncd),
            p_ens, c_ens, p_obs, c_obs)


def _ref_obs(o):
    return RefObservations(**{k: getattr(o, k) for k in (
        "elem", "lon", "lat", "lev", "dat", "err", "typ", "dif")})


@pytest.mark.parametrize("lateral", ["periodic", "open"])
def test_nested_cycle_matches_reference(lateral):
    """One coupled cycle: the parent's 4 steps and analysis, the child's 8
    steps forced by the parent's bracket and its analysis."""
    ref, port, p_ens, c_ens, p_obs, c_obs = _nest_case(lateral)
    nest_r = ref[3](*ref[:3])
    p_a_r, c_a_r, info_r = nest_r.cycle(
        RefState(*map(jnp.asarray, p_ens)), RefState(*map(jnp.asarray, c_ens)),
        _ref_obs(p_obs), _ref_obs(c_obs), steps_parent=4, steps_child=8)
    nest = port[3](*port[:3])

    def run(p, c):
        return nest.cycle(dycore_state_to_torch(p, CPU),
                          dycore_state_to_torch(c, CPU), p_obs, c_obs,
                          steps_parent=4, steps_child=8)
    p_a, c_a, info = run(p_ens, c_ens)
    p_a2, c_a2, _ = run(rounded(p_ens, 5), rounded(c_ens, 6))
    assert port[1].bdy is None          # both brackets freed
    assert_increments(dycore_state_to_numpy(p_a), p_ens,
                      [np.asarray(f) for f in p_a_r],
                      extra=floor_of(p_a2, p_a))
    assert_increments(dycore_state_to_numpy(c_a), c_ens,
                      [np.asarray(f) for f in c_a_r],
                      extra=floor_of(c_a2, c_a))
    # the bracket the child was forced with, from the same parent states
    bdy = nest.child_boundary(dycore_state_to_torch(p_ens, CPU),
                              dycore_state_to_torch(p_ens, CPU), 0.0, 8.0)
    bdy_r = nest_r.child_boundary(RefState(*map(jnp.asarray, p_ens)),
                                  RefState(*map(jnp.asarray, p_ens)), 0.0,
                                  8.0)
    assert (bdy.t0, bdy.t1) == (bdy_r.t0, bdy_r.t1)
    for a, b in zip(bdy.state1, bdy_r.state1):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max())
    for dom in ("parent", "child"):
        st, st_r = info[dom]["stats_gues"], info_r[dom]["stats_gues"]
        assert st.nobs == st_r.nobs and st.nobs["T"] > 0
        sa = info[dom]["stats_anal"]
        assert sa.rmse["T"] < st.rmse["T"], dom


def test_nested_driver_needs_a_boundary_buffer(tmp_path):
    """A child without a Davies buffer is refused, as the reference's."""
    (tmp_path / "exp.toml").write_text(CONFIG.replace("bdy_width = 4",
                                                      "bdy_width = 0"))
    cfg, grid, dycfg, dom = load_config_and_grid(str(tmp_path / "exp.toml"))
    parent = make_driver(cfg, grid, dycfg, dom, CPU)
    child, geom, ncd = make_nested(cfg, grid, dycfg, dom, CPU)
    with pytest.raises(ValueError, match="bdy_width"):
        ncd(parent, child, geom)


def test_gpu_check_nested_verb_on_cpu():
    """gpu_check.nested_verb_vs_cpu with the CPU in the card's place (the
    card's nested_small phase): its inputs, the verb's runs and its
    comparison run here, the CPU equal to itself, no kernel launched."""
    from scale_letkf_torch import gpu_check
    res = gpu_check.nested_verb_vs_cpu(CPU)
    assert res["finite"]
    assert not any(v for r in res["kernel_launches"].values()
                   for v in r.values())
    assert all(e == 0 for e in res["max_err_over_tol"].values()), res
    assert res["rounding_floor_over_1e-4_increment"]["child.rhot"] > 0
