"""The port's process grid over several processes: 4 gloo processes × 2 blocks
of a (2, 2, 2) grid (tests/torch_mp_worker.py, which imports no jax)
against the same grid in one process (the SI halo step with terrain, and a
cycle without and with the physics suite), and the cycle verb with a
[process] table over 4 processes (--coordinator, --num-processes, --process-id,
--local-device-count) against the verb in one process.

The messages between processes carry the values exactly and the arithmetic
is the same, so the multi-process results equal the single-process ones
exactly. The reference's SI halo step on the same mesh of the 8 virtual
devices is computed here, written beside the inputs, and the workers' step
is held to it at tests/test_torch_halo.py's bound.
"""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from scale_letkf_tpu.model import dycore as ref_dycore
from scale_letkf_tpu.model import dycore_si as ref_si
from scale_letkf_tpu.model.terrain import make_metrics as ref_metrics
from scale_letkf_tpu.parallel import halo as ref_halo
from scale_letkf_tpu.parallel.mesh import make_mesh as ref_make_mesh
from scale_letkf_torch.cli.main import main
from scale_letkf_torch.io import checkpoint
from scale_letkf_torch.model.dycore import DycoreState
from scale_letkf_torch.parallel.mesh import make_mesh
from test_cli import CONFIG as CLI_CONFIG
from test_torch_cli import run
from test_torch_cycle import setup_pair, states
from test_torch_fcst import _members
from test_torch_halo import (
    _assert_close, _ensemble, _floor, _rounded, _si_case,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(argv_of_rank, cwd):
    """WORLD processes, one torch thread each; their outputs, each
    asserted to have exited 0."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(argv_of_rank(r), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=cwd)
             for r in range(WORLD)]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = pr.communicate()
        outs.append(out)
    for r, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"process {r} failed:\n{out[-3000:]}"
    return outs


def _fields(prefix, s):
    return {f"{prefix}_{k}": np.asarray(f)
            for k, f in zip(DycoreState._fields, s)}


def test_four_gloo_processes_equal_one_process(tmp_path):
    grid, s_r, rr, pr, topo, cfg_r = _si_case()
    si = _ensemble(s_r, 4, 3)
    vg_r = ref_dycore.make_vgrid(grid.cz, grid.fz)
    zc = np.asarray(grid.cz, np.float32)
    step_r = jax.jit(lambda st: ref_halo.rk3_step_si_halo_ens(
        st, cfg_r, ref_si.SplitConfig(dtau=1.0), rr, pr, jnp.asarray(zc),
        ref_make_mesh(2, 2, 2), 4, vg=vg_r,
        metrics=ref_metrics(jnp.asarray(topo), grid.cz, grid.fz,
                            cfg_r.dx, cfg_r.dy)))
    ref = ref_dycore.DycoreState(*(jnp.asarray(f) for f in si))
    for _ in range(2):
        ref = step_r(ref)
    np.savez(tmp_path / "reference.npz", **_fields("si", ref))
    g_r, dom = setup_pair()[2::3]
    nature, ens = states(g_r, dom)
    from scale_letkf_torch.model.physics_suite import skin_temperature
    tsfc = skin_temperature(DycoreState(*(torch.from_numpy(f) for f in ens)))
    tsfc = tsfc + torch.linspace(-2.0, 2.0, tsfc.shape[0])[:, None, None]
    np.savez(tmp_path / "inputs.npz", **_fields("si", si),
             **_fields("nat", nature), **_fields("ens", ens),
             tsfc=tsfc.numpy(),
             **{f"cfg_{k}": getattr(cfg_r, k) for k in (
                 "dx", "dy", "dz", "dt", "ztop", "sponge_height",
                 "sponge_tau")},
             dzc=np.asarray(vg_r.dzc), dzf=np.asarray(vg_r.dzf), topo=topo,
             cz=np.asarray(grid.cz), fz=np.asarray(grid.fz),
             rho_ref=np.asarray(rr), p_ref=np.asarray(pr), zc=zc)

    port = _free_port()
    worker = str(ROOT / "tests" / "torch_mp_worker.py")
    outs = _spawn(lambda r: [sys.executable, worker, str(r), str(WORLD),
                             str(port), str(tmp_path)], ROOT)
    assert all(f"OK {r}" in o for r, o in enumerate(outs))
    got = np.load(tmp_path / "out.npz")

    # the same in one process: the worker's step and cycle
    import torch_mp_worker as w
    z = np.load(tmp_path / "inputs.npz")
    mesh = make_mesh(2, 2, 2)
    cfg_p = w.DycoreConfig(**{k: float(z[f"cfg_{k}"]) for k in (
        "dx", "dy", "dz", "dt", "ztop", "sponge_height", "sponge_tau")})
    vg = w.VGrid(torch.from_numpy(z["dzc"]), torch.from_numpy(z["dzf"]))
    metrics = w.make_metrics(torch.from_numpy(topo), z["cz"], z["fz"],
                             cfg_p.dx, cfg_p.dy)
    col = [torch.from_numpy(z[k]) for k in ("rho_ref", "p_ref", "zc")]

    def steps(s):
        for _ in range(2):
            s = w.halo.rk3_step_si_halo_ens(s, cfg_p, w.SplitConfig(dtau=1.0),
                                            *col, mesh, 4, vg=vg,
                                            metrics=metrics)
        return s

    one = steps(w.state(z, "si"))
    for k, f in zip(DycoreState._fields, one):
        np.testing.assert_array_equal(got[f"si_{k}"], f.numpy(), k)
    ref_z = np.load(tmp_path / "reference.npz")
    _assert_close([got[f"si_{k}"] for k in DycoreState._fields],
                  [ref_z[f"si_{k}"] for k in DycoreState._fields], si,
                  extra=_floor(one, steps(_rounded(w.state(z, "si"), 9))))

    from scale_letkf_torch.cli.main import load_config_and_grid, make_driver
    c, grid_p, dycfg, dom_p = load_config_and_grid(w.CONFIG, w.OVER)
    c.ensemble.member = 6
    c.process.mesh_member, c.process.mesh_y, c.process.mesh_x = 2, 2, 2
    drv = make_driver(c, grid_p, dycfg, dom_p, w.CPU)
    tmpl = w.synthetic_conv_network(c, grid_p, np.random.default_rng(1),
                                    n_sonde=25, n_ps=40)
    _, ens_a, res = drv.run_osse(w.state(z, "nat"), w.state(z, "ens"), tmpl,
                                 n_cycles=1, steps_per_cycle=2, seed=3)
    ens_a = drv.mesh.gather_ensemble(ens_a)
    for k, f in zip(DycoreState._fields, ens_a):
        np.testing.assert_array_equal(got[f"ens_{k}"], f.numpy(), k)
    np.testing.assert_array_equal(got["anal_mean"],
                                  res.info["anal_mean"].numpy())
    np.testing.assert_array_equal(got["anal_sprd"],
                                  res.info["anal_sprd"].numpy())
    np.testing.assert_array_equal(got["rmse"],
                                  [res.rmse_gues[0], res.rmse_anal[0]])

    # the physics suite's cycle: the PBL's halo and the skin temperature
    # across processes
    drv = make_driver(c, grid_p, dycfg, {**dom_p, "physics": w.PHYS}, w.CPU)
    drv.tsfc = torch.from_numpy(z["tsfc"])
    _, ens_p, res_p = drv.run_osse(w.state(z, "nat"), w.state(z, "ens"),
                                   tmpl, n_cycles=1, steps_per_cycle=2,
                                   seed=3)
    ens_p = drv.mesh.gather_ensemble(ens_p)
    for k, f in zip(DycoreState._fields, ens_p):
        np.testing.assert_array_equal(got[f"phys_{k}"], f.numpy(), k)
    np.testing.assert_array_equal(
        got["phys_tsfc"], drv.mesh.gather_ensemble(drv.tsfc).numpy())
    np.testing.assert_array_equal(got["phys_anal_mean"],
                                  res_p.info["anal_mean"].numpy())
    np.testing.assert_array_equal(got["phys_rmse"],
                                  [res_p.rmse_gues[0], res_p.rmse_anal[0]])
    assert drv.timer.counts["forecast/physics/halo"] == 2
    assert not np.array_equal(got["phys_rhot"], got["ens_rhot"])


PROCESS = """
[process]
mesh_member = 2
mesh_y = 2
mesh_x = 2
"""


def test_cycle_verb_over_four_processes(tmp_path):
    """The cycle verb with [process] (2, 2, 2) on tests/test_cli.py's
    experiment, run by 4 processes of 2 blocks (each reading its own
    members' files), equals the verb in one process; and that equals the
    verb with no [process] table to tests/test_torch_cycle.py's increments
    bound."""
    from scale_letkf_torch.da.obsmake import make_obs_network, obsmake
    from scale_letkf_torch.grid import Grid, Projection
    from scale_letkf_torch.model.dycore import to_collocated
    from scale_letkf_torch.obs import io as obsio
    from scale_letkf_torch.state import state_to_history, state_trans
    from test_torch_cycle import assert_increments

    (tmp_path / "one.toml").write_text(CLI_CONFIG)
    (tmp_path / "grid.toml").write_text(CLI_CONFIG + PROCESS)
    members = _members(5, 3)
    checkpoint.save_ensemble(tmp_path / "init", DycoreState(*(
        np.stack(f) for f in zip(*members[1:]))), basename="anal.@@@@")
    grid = Grid.uniform(nx=12, ny=12, nz=8, dx=2000.0, dy=2000.0, dz=500.0,
                        proj=Projection())
    from scale_letkf_torch.cli.main import load_config_and_grid
    cfg = load_config_and_grid(str(tmp_path / "one.toml"))[0]
    nat = DycoreState(*(torch.from_numpy(f) for f in members[0]))
    z = grid.calc_z(torch.zeros((12, 12)))
    obs = obsmake(state_to_history(state_trans(to_collocated(nat)), z,
                                   torch.zeros((12, 12))),
                  make_obs_network(grid, np.random.default_rng(0),
                                   n_profiles=15, levels_hpa=(900.0, 800.0)),
                  grid, cfg, z, np.random.default_rng(5))
    for c in range(2):
        obsio.write_obs(str(tmp_path / f"obs{c}.dat"), obs)
    args = ["cycle", "--init", str(tmp_path / "init"), "--cycles", "2",
            "--steps-per-cycle", "2", "--obs-pattern",
            str(tmp_path / "obs{cycle}.dat"), "--device", "cpu"]
    run(main, *args[:1], "--config", str(tmp_path / "one.toml"), *args[1:],
        "--out", str(tmp_path / "one"))
    out = run(main, *args[:1], "--config", str(tmp_path / "grid.toml"),
              *args[1:], "--out", str(tmp_path / "grid"))
    assert "transpose" in out and "halo" in out
    port = _free_port()
    outs = _spawn(lambda r: [
        sys.executable, "-m", "scale_letkf_torch", "--coordinator",
        f"127.0.0.1:{port}", "--num-processes", str(WORLD), "--process-id",
        str(r), "--local-device-count", "2", *args[:1], "--config",
        str(tmp_path / "grid.toml"), *args[1:], "--out",
        str(tmp_path / "mp")], ROOT)
    assert all(o.count("=== cycle") == 2 for o in outs)
    mp, _, meta = checkpoint.load_ensemble(tmp_path / "mp")
    one_grid, _, _ = checkpoint.load_ensemble(tmp_path / "grid")
    one, _, _ = checkpoint.load_ensemble(tmp_path / "one")
    assert meta == {"cycles": 2}
    for a, b in zip(mp, one_grid):
        np.testing.assert_array_equal(a, b)
    init, _, _ = checkpoint.load_ensemble(tmp_path / "init")
    assert_increments(one_grid, init, one)
    shutil.rmtree(tmp_path / "init")


def test_fused_cycle_over_four_gloo_processes(tmp_path):
    """The fused radar cycle (tests/test_torch_fastcycle.py's radar case at
    16 × 16 columns, K = 8, 2 cycles of 5 steps through FusedCycle.run_osse)
    on a (2, 2, 2) grid over 4 gloo processes × 2 blocks, each process
    holding its own members' blocks (tests/torch_mp_worker.py run_fused),
    equals the same grid in one process exactly: the final ensemble, the
    nature run, the errors against it, the obs counts and the O−B / O−A
    by group. Here alone the fused cycle's cross-process reductions run:
    every slab's H(x) and QC routed to every process for the worst QC,
    the mean of H(x) and the radar min-member count, and the ensemble
    transpose between processes."""
    import torch_mp_worker as w
    from test_torch_fastcycle import _radar_case
    case = _radar_case(16, 16)
    d, t = case["driver_r"], case["template_r"]
    np.savez(tmp_path / "inputs.npz", **_fields("ens", case["ens"]),
             **_fields("nat", case["truth0"]),
             **{f"t_{k}": np.asarray(getattr(t, k)) for k in (
                 "elem", "lon", "lat", "lev", "dat", "err", "typ", "dif",
                 "meta")},
             g_cz=np.asarray(d.grid.cz), g_fz=np.asarray(d.grid.fz),
             g_dx=d.grid.dx, g_dz=d.dycfg.dz,
             rho_ref=np.asarray(d.rho_ref, np.float32),
             p_ref=np.asarray(d.p_ref, np.float32))
    port = _free_port()
    worker = str(ROOT / "tests" / "torch_mp_worker.py")
    outs = _spawn(lambda r: [sys.executable, worker, str(r), str(WORLD),
                             str(port), str(tmp_path), "fused"], ROOT)
    assert all(f"OK {r}" in o for r, o in enumerate(outs))
    got = np.load(tmp_path / "fused_out.npz")
    one = w.run_fused(np.load(tmp_path / "inputs.npz"), make_mesh(2, 2, 2))
    assert sorted(got.files) == sorted(one)
    for k, v in one.items():
        np.testing.assert_array_equal(got[k], v, k)
    assert (one["nobs_used"] > 0).all() and "omb_by_group_REF" in one
