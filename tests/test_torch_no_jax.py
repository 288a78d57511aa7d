"""The PyTorch port imports no jax and nothing of the JAX package: every
scale_letkf_torch module imports in a fresh interpreter where `import jax`
and `import scale_letkf_tpu` fail, and no import statement of the port or of
chip_smoke.py names scale_letkf_tpu."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import scale_letkf_torch

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        scale_letkf_torch.__path__, prefix="scale_letkf_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    for m in ("da.letkf", "ops.invsqrt", "model.dycore", "model.dycore_si",
              "model.ideal", "ops.finite_diff", "ops.tendency", "ops.stencil",
              "model.physics", "model.microphysics6", "model.radiation",
              "model.surface", "model.pbl", "model.physics_suite",
              "model.boundary", "model.terrain", "model.topo", "obs.h08",
              "ops.eigh_jacobi", "da.inflation", "da.efso",
              "obs.h08_calibrate", "obs.decoders", "obs.superob",
              "obs.precip", "cycle", "da.letkf_tiled", "da.bigcycle",
              "da.resident", "utils.staging", "model.nesting", "nested",
              "da.fastcycle", "io.netcdf",
              "io.checkpoint", "io.convert", "cli.main", "synthetic",
              "gpu_check", "__main__", "parallel.mesh", "parallel.halo",
              "parallel.distributed", "bench_fullsize"):
        assert f"scale_letkf_torch.{m}" in mods, m
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_jax_import_lines():
    for path in (ROOT / "scale_letkf_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (path, line)


def test_fcst_verb_runs_without_jax():
    """`python -m scale_letkf_torch fcst --help` with jax unimportable."""
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = ['scale_letkf_torch', 'fcst', '--help']\n"
            "runpy.run_module('scale_letkf_torch', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "--steps" in res.stdout and "--device" in res.stdout


def test_every_module_imports_without_the_jax_package():
    """... and without h5py, which the card's machine lacks: io/netcdf.py
    imports it inside its functions."""
    mods = _modules()
    for m in ("constants", "config", "obs.types", "utils.native",
              "io.netcdf"):
        assert f"scale_letkf_torch.{m}" in mods, m
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['scale_letkf_tpu'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "sys.modules['h5py'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from scale_letkf_torch.ops.obs_select import bucket_sort_backend\n"
        "assert bucket_sort_backend() in ('native', 'numpy')\n"
        "loaded = [k for k, v in sys.modules.items()\n"
        "          if k.startswith('scale_letkf_tpu') and v is not None]\n"
        "assert not loaded, loaded\n"
        "assert sys.modules['h5py'] is None\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_package_import_statements():
    """Every import statement, at top level or inside a function; comments
    and docstrings may name the reference's files."""
    paths = [*(ROOT / "scale_letkf_torch").rglob("*.py"),
             ROOT / "chip_smoke.py", ROOT / "mesh_gap_probe.py",
             ROOT / "tests" / "torch_mp_worker.py"]
    for path in paths:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "scale_letkf_tpu",
                                             "ml_dtypes"), \
                (path, mod)


def test_grid_physics_runs_without_jax():
    """The physics on a process grid (parallel/halo.py physics_step_blocks
    over model/pbl.py's split PBL and model/physics_suite.py's column
    part) imports and runs with jax and the JAX package unimportable: one
    suite step on the (1, 2, 2) blocks of a small moist 18-km ensemble
    equals the undecomposed step."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['scale_letkf_tpu'] = None\n"
        "import torch\n"
        "from scale_letkf_torch.cli.main import load_config_and_grid\n"
        "from scale_letkf_torch.model.physics_suite import (\n"
        "    PhysicsConfig, PhysicsState, physics_step, skin_temperature)\n"
        "from scale_letkf_torch.parallel.halo import physics_step_blocks\n"
        "from scale_letkf_torch.parallel.mesh import make_mesh\n"
        "from scale_letkf_torch.synthetic import synthetic_ens_dycore_device\n"
        "_, g, _, dom = load_config_and_grid('configs/18km_japan.toml',\n"
        "    {'nx': 16, 'ny': 16, 'nz': 8, 'dz': 1000.0})\n"
        "s = synthetic_ens_dycore_device(0, 2, g, dom, torch.device('cpu'),\n"
        "                                u0=10.0, qr_blob=2e-3)[0]\n"
        "zc = torch.as_tensor(g.cz, dtype=torch.float32)\n"
        "p = PhysicsConfig(mp_scheme='nsw6', slab_capacity=2e5)\n"
        "def ph(x):\n"
        "    t = skin_temperature(x)\n"
        "    return PhysicsState(t, torch.zeros_like(x.rhot),\n"
        "                        torch.zeros_like(t))\n"
        "want, _ = physics_step(s, ph(s), 0, p, 150.0, 1000.0, zc)\n"
        "mesh = make_mesh(1, 2, 2)\n"
        "sh = mesh.shard_ensemble(s)\n"
        "out, _ = physics_step_blocks(mesh, sh.blocks, {b: ph(x) for b, x\n"
        "    in sh.blocks.items()}, 0, p, 150.0, 1000.0, zc, True)\n"
        "got = mesh.gather_ensemble(sh._replace(blocks=out))\n"
        "assert all(torch.equal(a, b) for a, b in zip(got, want))\n"
        "assert not torch.equal(want.rhou, s.rhou)\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_grid_executors_run_without_jax():
    """This slice's grid paths import and run with jax and the JAX package
    unimportable: the explicit core over terrain on (1, 2, 2)
    (gpu_check.terrain_grid_step_on_device) bit-equal to the undecomposed
    step; a FusedCycle step of the radar configuration (16 × 16 columns,
    12 levels, K = 4, a dBZ template from a member) on (2, 2, 2) equal to
    the undecomposed step; and the nested bracket of a parent Sharded
    (NestedCycleDriver.p2c on two (2, 2, 2) drivers) equal to the global
    bracket."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['scale_letkf_tpu'] = None\n"
        "import numpy as np, torch\n"
        "from scale_letkf_torch import gpu_check\n"
        "from scale_letkf_torch.cli.main import (load_config_and_grid,\n"
        "    make_driver)\n"
        "from scale_letkf_torch.da.fastcycle import FusedCycle\n"
        "from scale_letkf_torch.model.dycore import to_collocated\n"
        "from scale_letkf_torch.model.nesting import NestGeometry\n"
        "from scale_letkf_torch.nested import NestedCycleDriver\n"
        "from scale_letkf_torch.state import state_to_history, state_trans\n"
        "from scale_letkf_torch.synthetic import synthetic_ens_dycore_device\n"
        "cpu = torch.device('cpu')\n"
        "r = gpu_check.terrain_grid_step_on_device(cpu,\n"
        "    'configs/18km_japan.toml')\n"
        "assert r['bit_equal'] and r['rhow_moved'] > 0\n"
        "cfg, g, dc, dom = load_config_and_grid(\n"
        "    'configs/bda_1km_radar.toml', {'nx': 16, 'ny': 16, 'nz': 12})\n"
        "cfg.ensemble.member = 4\n"
        "ens = synthetic_ens_dycore_device(0, 4, g, dom, cpu, u0=5.0,\n"
        "                                  qr_blob=2e-3)[0]\n"
        "d0 = make_driver(cfg, g, dc, dom, cpu)\n"
        "m0 = type(ens)(*(x[0] for x in ens))\n"
        "tmpl = gpu_check.dbz_template(state_to_history(state_trans(\n"
        "    to_collocated(m0)), d0.z_full, d0.topo),\n"
        "    gpu_check.radar_template(g, dom, 0, 96), g, cfg, d0.z_full,\n"
        "    np.random.default_rng(0))\n"
        "outs = []\n"
        "for shape in ((1, 1, 1), (2, 2, 2)):\n"
        "    (cfg.process.mesh_member, cfg.process.mesh_y,\n"
        "     cfg.process.mesh_x) = shape\n"
        "    d = make_driver(cfg, g, dc, dom, cpu)\n"
        "    fc = FusedCycle(d, tmpl, 2)\n"
        "    e, infl, diag = fc.step(ens, torch.as_tensor(fc.template.dat,\n"
        "        dtype=torch.float32), fc.initial_inflation())\n"
        "    e = d.mesh.gather_ensemble(e) if d.mesh else e\n"
        "    outs.append([*e, infl, diag['anal_mean'], diag['omb_rmse']])\n"
        "assert all(torch.equal(a, b) for a, b in zip(*outs))\n"
        "cfg, g, dc, dom = load_config_and_grid('configs/18km_japan.toml',\n"
        "    {'nx': 32, 'ny': 24, 'nz': 6})\n"
        "cfg.ensemble.member = 4\n"
        "cfg.process.mesh_member = cfg.process.mesh_y = 2\n"
        "cfg.process.mesh_x = 2\n"
        "p = make_driver(cfg, g, dc, dom, cpu)\n"
        "c = gpu_check._nest_grid_child(cfg, g, dc, dom, cpu)\n"
        "n = NestedCycleDriver(p, c, NestGeometry(12.0, 8.0, 3))\n"
        "e = synthetic_ens_dycore_device(1, 4, g, dom, cpu, u0=10.0)[0]\n"
        "got = c.mesh.gather_ensemble(n.p2c(p.mesh.shard_ensemble(e)))\n"
        "assert all(torch.equal(a, b) for a, b in zip(got, n.p2c(e)))\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_grid_stream_runs_without_jax():
    """The member-streamed cycle on a process grid imports and runs with
    jax and the JAX package unimportable: one cycle of the production
    composition (gpu_check.streamed_grid_on_device at 16 × 16, K = 6,
    batches of 2) on (2, 2, 2) equal to the undecomposed stream."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['scale_letkf_tpu'] = None\n"
        "import torch\n"
        "from scale_letkf_torch import gpu_check\n"
        "torch.set_num_threads(1)\n"
        "r = gpu_check.streamed_grid_on_device(torch.device('cpu'),\n"
        "    'configs/18km_japan.toml', 0, shape=(2, 2, 2),\n"
        "    member_batch=2, cycles=1, members=6, over={'nx': 16,\n"
        "    'ny': 16, 'nz': 8, 'dz': 1000.0, 'dz_stretch': 1.1})\n"
        "assert r['bit_equal'] and r['batches'] == 3, r\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_fullsize_benches_run_without_jax():
    """scale_letkf_torch/bench_fullsize.py runs with jax and the JAX package
    unimportable: the tendency bench and a coarse 18-km cycle on the CPU,
    and its command line refuses a name it does not know."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['scale_letkf_tpu'] = None\n"
        "from scale_letkf_torch import bench_fullsize as B\n"
        "r = B.bench_tendency_fused(nz=6, ny=8, nx=12, reps=2, device='cpu')\n"
        "assert r['fused_max_rel_err'] == 0.0\n"
        "out = B.bench_18km_cycle(nsteps=2, overrides={'nx': 16, 'ny': 16,\n"
        "    'nz': 12}, members=4, tile_rows=4, n_sonde=10, n_ps=10,\n"
        "    device='cpu')\n"
        "assert out['nobs_good'] > 0 and out['oma_rmse_T'] > 0\n"
        "loaded = [k for k, v in sys.modules.items()\n"
        "          if k.startswith(('jax', 'scale_letkf_tpu')) and v is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    res = subprocess.run([sys.executable, "-m",
                          "scale_letkf_torch.bench_fullsize", "nonsense"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 2 and "invalid choice" in res.stderr
