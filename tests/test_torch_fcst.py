"""The forecast slice as a whole: the `fcst` verb of both packages' CLIs
(in process), from one numpy init checkpoint, on the tests/test_cli.py
experiment (12×12×8, dt 1 s, explicit core, qv_surface 0.008), K = 3 plus
a deterministic member, 3 steps. The outputs load in either package and
agree per field at the bound of tests/test_torch_dycore.py's RK3 test,
1e-4·max|increment| + 2 ulp of max|field|. Checkpoints written by either
package's io/checkpoint.py load in the other.
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu.bench_fullsize import _synthetic_ens_dycore
from scale_letkf_tpu.cli.main import load_config_and_grid as ref_load
from scale_letkf_tpu.cli.main import main as ref_main
from scale_letkf_tpu.cli.main import slot_steps_from_cfg as ref_slot_steps
from scale_letkf_tpu.io import checkpoint as ref_ckpt
from scale_letkf_tpu.model.dycore import DycoreState as RefState
from scale_letkf_torch.cli.main import (
    load_config_and_grid, main, make_driver, slot_steps_from_cfg,
)
from scale_letkf_torch.io import checkpoint
from scale_letkf_torch.io.convert import dycore_state_to_torch
from scale_letkf_torch.model import ideal
from scale_letkf_torch.model.dycore import DycoreState, to_collocated
from scale_letkf_torch.state import state_trans
from scale_letkf_torch.synthetic import synthetic_ens_dycore_device

torch.set_num_threads(1)
CPU = torch.device("cpu")
CONFIG_18KM = str(Path(__file__).resolve().parents[1] / "configs"
                  / "18km_japan.toml")

CONFIG = """
[domain]
nx = 12
ny = 12
nz = 8
dx = 2000.0
dy = 2000.0
dz = 500.0
dt = 1.0
qv_surface = 0.008

[ensemble]
member = 3
"""
K, STEPS = 3, 3


def _members(n, seed):
    """n float32 numpy members: the config's balanced state, a warm bubble,
    and seeded wind and ρθ noise."""
    nz, ny, nx, dz, dx = 8, 12, 12, 500.0, 2000.0
    cz = (np.arange(nz) + 0.5) * dz
    s, _, _ = ideal.balanced_state(nz, ny, nx, dz,
                                   qv_prof=0.008 * np.exp(-cz / 3000.0))
    s = ideal.add_warm_bubble(s, dz, dx, dx, amplitude=2.0)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = [a.numpy().copy() for a in s]
        f[1] += (2.0 * rng.standard_normal(f[1].shape) * f[0]).astype(np.float32)
        f[4] += (0.3 * rng.standard_normal(f[4].shape) * f[0]).astype(np.float32)
        out.append(f)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fcst")
    cfg = tmp / "exp.toml"
    cfg.write_text(CONFIG)
    members = _members(K + 1, 0)
    ens = DycoreState(*(np.stack(f) for f in zip(*members[:K])))
    det = DycoreState(*members[K])
    checkpoint.save_ensemble(tmp / "init", ens, basename="anal.@@@@",
                             aux={"infl": np.full((8, 12, 12), 1.1,
                                                  np.float32)},
                             meta={"cycle": 0}, det=det)
    common = ["fcst", "--config", str(cfg), "--init", str(tmp / "init"),
              "--steps", str(STEPS)]
    with contextlib.redirect_stdout(io.StringIO()):
        ref_main(common + ["--out", str(tmp / "ref")])
        main(common + ["--out", str(tmp / "port"), "--device", "cpu"])
    return tmp, ens, det


def _assert_rk3_close(out, expect, init):
    for name, a, b, f0 in zip(DycoreState._fields, expect, out, init):
        a, b, f0 = (np.asarray(x) for x in (a, b, f0))
        assert b.shape == a.shape and b.dtype == np.float32, name
        tol = (1e-4 * np.abs(a - f0).max()
               + 2 * np.spacing(np.abs(f0).max(), dtype=np.float32))
        err = np.abs(b - a).max()
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def test_fcst_verbs_agree(runs):
    tmp, ens, det = runs
    expect, aux_r, meta_r = ref_ckpt.load_ensemble(tmp / "ref")
    out, aux, meta = checkpoint.load_ensemble(tmp / "port")
    assert meta == meta_r == {"cycle": 0, "step": "fcst", "steps": STEPS}
    np.testing.assert_array_equal(aux["infl"], aux_r["infl"])
    _assert_rk3_close(out, expect, ens)
    _assert_rk3_close(checkpoint.load_det(tmp / "port"),
                      ref_ckpt.load_det(tmp / "ref"), det)
    assert float(np.abs(out.rhow).max()) > 0


def test_outputs_load_in_either_package(runs):
    tmp, _, _ = runs
    for d in ("ref", "port"):
        a, _, _ = ref_ckpt.load_ensemble(tmp / d)
        b, _, _ = checkpoint.load_ensemble(tmp / d)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)
        manifest = json.loads((tmp / d / "manifest.json").read_text())
        assert manifest["files"][0] == "gues.0001.npz" and manifest["det"]


def test_reference_checkpoint_loads_in_port(tmp_path):
    members = _members(2, 1)
    ens = RefState(*(jnp.asarray(np.stack(f)) for f in zip(*members)))
    ref_ckpt.save_ensemble(tmp_path, ens, basename="gues.@@@@",
                           meta={"x": 1}, det=RefState(*members[0]))
    out, aux, meta = checkpoint.load_ensemble(tmp_path)
    assert meta == {"x": 1} and aux == {}
    for a, b in zip(ens, out):
        np.testing.assert_array_equal(np.asarray(a), b)
    det = checkpoint.load_det(tmp_path)
    for a, b in zip(members[0], det):
        np.testing.assert_array_equal(a, b)
    # and on to a device: the port's state from the loaded arrays
    s = dycore_state_to_torch(out, torch.device("cpu"))
    assert s.rhoq.shape == (2, 6, 8, 12, 12) and s.rho.dtype == torch.float32


def test_filename_replace_mem_matches_reference():
    for tpl in ("gues.@@@@", "anal/<member>/init", "x"):
        for m in (0, 9, 99, "mean", "mdet"):
            assert (checkpoint.filename_replace_mem(tpl, m)
                    == ref_ckpt.filename_replace_mem(tpl, m))


def test_cuda_device_without_gpu_raises(tmp_path, runs):
    """--device cuda (the default) needs a GPU: no quiet move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tmp, _, _ = runs
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["fcst", "--config", str(tmp / "exp.toml"), "--init",
              str(tmp / "init"), "--steps", "1", "--out", str(tmp_path)])


def test_slot_steps_match_reference():
    cfg_r, _, dycfg_r, _ = ref_load(CONFIG_18KM, {"nx": 8, "ny": 8, "nz": 4})
    cfg, _, dycfg, _ = load_config_and_grid(CONFIG_18KM,
                                            {"nx": 8, "ny": 8, "nz": 4})
    for nsteps in (0, 120, 480):
        assert (slot_steps_from_cfg(cfg, nsteps, dycfg.dt)
                == ref_slot_steps(cfg_r, nsteps, dycfg_r.dt))


def test_forecast_slots_snapshots_the_forecast(runs):
    """forecast_slots returns the state at nsteps and, per slot, the
    analysis variables of the forecast at that step (a slot past nsteps
    keeps integrating)."""
    tmp, ens, _ = runs
    cfg, grid, dycfg, dom = load_config_and_grid(str(tmp / "exp.toml"))
    driver = make_driver(cfg, grid, dycfg, dom, CPU)
    e = dycore_state_to_torch(ens, CPU)
    state, hist = driver.forecast_slots(e, 2, [1, 2, 3])
    assert hist.shape == (K, 3, 11, 8, 12, 12)
    one = driver.forecast(e, 1)
    for a, b in zip(driver.forecast(one, 1), state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(hist[:, 0], state_trans(to_collocated(one)),
                               rtol=0, atol=0)
    three = driver.forecast(state, 1)
    torch.testing.assert_close(hist[:, 2], state_trans(to_collocated(three)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("key,value,item", [
    ("use_physics", True, "physics"),
    ("physics", {"mp": "kessler"}, "physics"),
    ("bdy_file", "bdy.npz", "boundary.py"),
])
def test_unported_options_raise(runs, key, value, item):
    """The options that raised NotImplementedError until the physics and
    boundary slice was ported now reach the driver as in the reference:
    use_physics builds a Kessler driver; a [physics] key PhysicsConfig does
    not have ("mp") raises ValueError naming it; a bdy_file that does not
    exist raises FileNotFoundError from load_boundary."""
    tmp, _, _ = runs
    cfg, grid, dycfg, dom = load_config_and_grid(str(tmp / "exp.toml"))
    dom = {**dom, key: value if key != "bdy_file" else str(tmp / value)}
    if key == "use_physics":
        driver = make_driver(cfg, grid, dycfg, dom, CPU)
        assert driver.use_physics and driver.phys_cfg is None
        assert driver.dz_col == dycfg.dz
    elif key == "physics":
        with pytest.raises(ValueError, match=r"unknown \[physics\] keys.*mp"):
            make_driver(cfg, grid, dycfg, dom, CPU)
    else:
        with pytest.raises(FileNotFoundError, match=value):
            make_driver(cfg, grid, dycfg, dom, CPU)


def test_terrain_and_mesh_raise(runs, tmp_path):
    """A topo_file, which raised NotImplementedError until model/terrain.py
    was ported, now builds a driver with terrain metrics and z_full on the
    topography; a [process] grid, which raised until parallel/ was ported,
    builds a driver on the grid; and terrain under the explicit core on a
    grid that decomposes the domain, which raised the reference's refusal
    of its explicit halo until the explicit halo step took metrics, builds
    a driver on the grid with each block's halo-extended metrics."""
    tmp, _, _ = runs
    cfg, grid, dycfg, dom = load_config_and_grid(str(tmp / "exp.toml"))
    np.savez(tmp_path / "topo.npz", topo=np.full((12, 12), 100.0))
    driver = make_driver(cfg, grid, dycfg,
                         {**dom, "topo_file": str(tmp_path / "topo.npz")},
                         CPU)
    assert driver.metrics is not None
    assert float(driver.z_full[0].min()) > 100.0
    cfg.process.mesh_member = 2
    assert make_driver(cfg, grid, dycfg, dom, CPU).mesh.shape == (2, 1, 1)
    cfg.process.mesh_y = 2
    driver = make_driver(cfg, grid, dycfg,
                         {**dom, "topo_file": str(tmp_path / "topo.npz")},
                         CPU)
    assert driver.core == "explicit" and driver.mesh.shape == (2, 2, 1)
    assert driver.exchange and driver.metrics is not None
    assert sorted(driver._metrics_ext) == list(driver.mesh.local)
    for b, m in driver._metrics_ext.items():
        assert m.gx.shape[-2:] == (12 // 2 + 8, 12 + 8)


def test_synthetic_ensemble_matches_reference_construction():
    """synthetic_ens_dycore_device's base state, qv and reference columns
    equal bench_fullsize._synthetic_ens_dycore's; the ρθ perturbations come
    from another generator but have its amplitude and lateral taper."""
    over = {"nx": 24, "ny": 20, "nz": 6}
    _, grid_r, _, dom = ref_load(CONFIG_18KM, over)
    _, grid, _, _ = load_config_and_grid(CONFIG_18KM, over)
    s_r, rr_r, pr_r = _synthetic_ens_dycore(np.random.default_rng(0), 2,
                                            grid_r, dom)
    s, rr, pr = synthetic_ens_dycore_device(0, 2, grid, dom, CPU, u0=10.0)
    np.testing.assert_allclose(rr.numpy(), rr_r, rtol=1e-7)
    np.testing.assert_allclose(pr.numpy(), pr_r, rtol=1e-6)
    for name in ("rho", "rhoq", "rhov", "rhow"):
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   getattr(s_r, name), rtol=1e-7)
    np.testing.assert_allclose(s.rhou.numpy(), 10.0 * s_r.rho, rtol=1e-7)
    dth = (s.rhot / s.rho).numpy() - (s_r.rhot / s_r.rho)
    dth_r = (s_r.rhot / s_r.rho) - (s_r.rhot / s_r.rho).mean(axis=(2, 3),
                                                              keepdims=True)
    assert np.abs(dth[..., 0, :]).max() < 1e-3     # tapered to 0 at the edge
    assert 0.5 < dth.std() / dth_r.std() < 2.0
