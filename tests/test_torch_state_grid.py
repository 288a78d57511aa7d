"""PyTorch port of grid.py, state.py and cli/main.py's loader against the
reference package (float32, rtol 1e-6)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu import grid as ref_grid
from scale_letkf_tpu import state as ref_state
from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_torch import grid as port_grid
from scale_letkf_torch import state as port_state
from scale_letkf_torch.cli.main import load_config_and_grid
from scale_letkf_torch.io.convert import dycore_config_from_dict
from scale_letkf_torch.synthetic import synthetic_gues

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _grids(kind, stretched):
    proj_kw = dict(kind=kind, basepoint_lon=135.0, basepoint_lat=35.0)
    args = (30, 20, 6, 18e3, 15e3)
    pair = []
    for mod in (ref_grid, port_grid):
        proj = mod.Projection(**proj_kw)
        if stretched:
            pair.append(mod.Grid.stretched(*args, 300.0, 1.04, proj=proj))
        else:
            pair.append(mod.Grid.uniform(*args, 500.0, proj=proj))
    return pair


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("kind", ["LC", "MER", "PS", "EQ"])
def test_grid_geometry_matches_reference(kind, stretched):
    g_ref, g = _grids(kind, stretched)
    np.testing.assert_array_equal(g.cz, g_ref.cz)
    np.testing.assert_array_equal(g.fz, g_ref.fz)
    for a, b in zip(g.xy, g_ref.xy):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(g.lonlat, g_ref.lonlat):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12)
    rng = np.random.default_rng(0)
    ri, rj = rng.uniform(0, 29, 50), rng.uniform(0, 19, 50)
    lon, lat = g.ij_to_lonlat(ri, rj)
    lon_r, lat_r = g_ref.ij_to_lonlat(ri, rj)
    np.testing.assert_allclose(lon, np.asarray(lon_r), rtol=1e-12)
    np.testing.assert_allclose(lat, np.asarray(lat_r), rtol=1e-12)
    x, y = g.proj.lonlat_to_xy(lon, lat)
    x_r, y_r = g_ref.proj.lonlat_to_xy(lon, lat)
    np.testing.assert_allclose(x, x_r, rtol=1e-12, atol=1e-6)
    np.testing.assert_allclose(y, y_r, rtol=1e-12, atol=1e-6)
    topo = rng.uniform(0, 1500, (20, 30)).astype(np.float32)
    z = g.calc_z(torch.from_numpy(topo))
    z_r = np.asarray(g_ref.calc_z(jnp.asarray(topo)))
    assert z.shape == (6, 20, 30) and z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), z_r, rtol=1e-6)


def test_load_config_and_grid_matches_reference():
    path = str(CONFIGS / "18km_japan.toml")
    over = {"nx": 24, "ny": 20, "nz": 4}
    cfg_r, g_r, dycfg_r, dom_r = ref_load(path, over)
    cfg, g, dycfg, dom = load_config_and_grid(path, over)
    # the port's Config is its own class with the reference's fields
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_r)
    assert dom == dom_r
    assert dycfg == dycore_config_from_dict(dataclasses.asdict(dycfg_r))
    assert (g.nx, g.ny, g.nz, g.dx, g.dy, g.proj.kind) == \
        (g_r.nx, g_r.ny, g_r.nz, g_r.dx, g_r.dy, g_r.proj.kind)
    np.testing.assert_array_equal(g.fz, g_r.fz)


def _restart(seed=0):
    """float32 restart ensemble made from a synthetic analysis ensemble by
    the reference's state_trans_inv."""
    rng = np.random.default_rng(seed)
    cz = np.linspace(150.0, 15e3, 5)
    anal = synthetic_gues(rng, 3, 5, 6, 7, cz)
    return np.array(ref_state.state_trans_inv(jnp.asarray(anal))), anal


def test_state_trans_matches_reference():
    restart, _ = _restart()
    out_r = np.asarray(ref_state.state_trans(jnp.asarray(restart)))
    out = port_state.state_trans(torch.from_numpy(restart))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), out_r, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("pd_q,pd_qhyd", [(False, False), (True, True)])
def test_state_trans_inv_matches_reference(pd_q, pd_qhyd):
    _, anal = _restart(1)
    kw = dict(positive_definite_q=pd_q, positive_definite_qhyd=pd_qhyd)
    out_r = np.asarray(ref_state.state_trans_inv(jnp.asarray(anal), **kw))
    out = port_state.state_trans_inv(torch.from_numpy(anal), **kw)
    np.testing.assert_allclose(out.numpy(), out_r, rtol=1e-6, atol=1e-12)
    if pd_qhyd:
        assert float(out[:, port_state.IR_Q0 + 1:].min()) >= 0.0


def test_state_round_trip_and_ensemble_stats():
    restart, anal = _restart(2)
    back = port_state.state_trans(port_state.state_trans_inv(
        torch.from_numpy(anal)))
    np.testing.assert_allclose(back.numpy(), anal, rtol=1e-5, atol=1e-7)
    t = torch.from_numpy(anal)
    np.testing.assert_allclose(port_state.ensemble_mean(t).numpy(),
                               np.asarray(ref_state.ensemble_mean(
                                   jnp.asarray(anal))), rtol=1e-6)
    np.testing.assert_allclose(port_state.ensemble_spread(t).numpy(),
                               np.asarray(ref_state.ensemble_spread(
                                   jnp.asarray(anal))), rtol=1e-5, atol=1e-9)
    assert port_state.V3D_ANAL_NAMES == ref_state.V3D_ANAL_NAMES
    assert (port_state.IA_P, port_state.IA_Q0, port_state.NV3D) == \
        (ref_state.IA_P, ref_state.IA_Q0, ref_state.NV3D)
