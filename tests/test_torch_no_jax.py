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
              "parallel.distributed"):
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
    paths = [*(ROOT / "scale_letkf_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in paths:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "scale_letkf_tpu",
                                             "ml_dtypes"), \
                (path, mod)
