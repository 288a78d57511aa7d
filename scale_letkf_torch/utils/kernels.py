"""Build and load the port's hand-written CUDA kernels.

Each kernel is one file `scale_letkf_torch/csrc/<name>.cu` with a plain C
entry point (it may include the shared headers `csrc/*.cuh`): #1
invsqrt_ns, #2 dyn_tendency, #3 adv_ud3, #4 acoustic_substep (the split-
explicit core's acoustic substep, model/dycore_si.py) and #5
terrain_tendency (the slow tendency over terrain, model/terrain.py). At
first use it is compiled by nvcc for sm_90a (with the kernel's
EXTRA_FLAGS) into a shared library under `build/kernels/` at the
repository root (gitignored), named by a hash of its source, the headers
and the flags so an edited source is rebuilt, and loaded with ctypes. A
missing nvcc or a failed build raises: there is no fallback.

LAUNCHES counts, per kernel, the launches its wrapper made; callers that
want to show a run went through a kernel reset it to 0 before the run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# argtypes of each kernel's C entry point (pointers and the stream as
# c_void_p, so ctypes passes them whole and not cut to 32 bits; floats as
# c_float, not the double ctypes would pass for a Python float; the sizes
# of the stencil grids as c_int64)
_SIGNATURES = {
    "invsqrt_ns": ("invsqrt_ns_launch",
                   [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p]),
    # rho, rhou, rhov, rhow, rhot, p_pert, rho_ref, dzc, dzf, 5 outputs;
    # B, nz, ny, nx; dx, dy, kdiff4, alpha_h, divdmp, dt, grav; open; stream
    "dyn_tendency": ("dyn_tendency_launch",
                     [ctypes.c_void_p] * 14 + [ctypes.c_int64] * 4
                     + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p]),
    # q, rho, fx, fy, fw, dzc, out; B, nq, nz, ny, nx; dx, dy, kdiff4; open;
    # stream
    "adv_ud3": ("adv_ud3_launch",
                [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 5
                + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]),
    # the acoustic substep (model/dycore_si.py acoustic_substeps): the old
    # deviations (or the start state), the stage state and the slow
    # tendencies, 5 fields each; c2, theta; the level tables dzc, dzf, abf,
    # abc, ga, gd; 5 outputs; B, nz, ny, nx; dtau, dt1b, g_half, grav,
    # inv_dx, inv_dy; open, first, last; stream
    "acoustic_substep": ("acoustic_substep_launch",
                         [ctypes.c_void_p] * 28 + [ctypes.c_int64] * 4
                         + [ctypes.c_float] * 6 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p]),
    # the slow tendency over terrain (model/terrain.py tendencies_terrain):
    # rho, rhou, rhov, rhow, rhot, rhoq, p, p_ref, rho_ref, jac, gx, gy,
    # gx_zf, gy_zf, dzc, dzf, 6 outputs; B, nq, nz, ny, nx; inv_dx, inv_dy,
    # kdiff4, alpha_h, divdmp, inv_dt, grav; damp, open; stream. Two
    # launches a call (the dynamics, the scalars)
    "terrain_tendency": ("terrain_tendency_launch",
                         [ctypes.c_void_p] * 22 + [ctypes.c_int64] * 5
                         + [ctypes.c_float] * 7 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p]),
}
# nvcc flags of one kernel beyond NVCC_FLAGS: the acoustic substep and the
# terrain tendency round every product and sum on their own, as the plain
# PyTorch passes they follow do (no contraction into fused multiply-adds)
EXTRA_FLAGS = {"acoustic_substep": ["-fmad=false"],
               "terrain_tendency": ["-fmad=false"]}

LAUNCHES = {name: 0 for name in _SIGNATURES}
BUILD_LOG: dict[str, dict] = {}
_LOADED: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _library(name: str) -> Path:
    """Where csrc/<name>.cu, built from its current source, headers and
    flags, lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, [])).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names) -> dict[str, Path]:
    """Compile each csrc/<name>.cu into build/kernels (unless already built
    from the same source), one nvcc process per source, all started
    together, and return the libraries' paths. Records each build's seconds
    and nvcc's ptxas report (registers, shared memory, spills) in
    BUILD_LOG[name]."""
    out, running = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = out[name] = _library(name)
        if so.exists():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "cached": True,
                                        "ptxas": ""})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in running.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}.cu "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        tmp.replace(out[name])
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "cached": False, "ptxas": err}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    """build_all for one kernel."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The built and loaded library of kernel `name` (built at first use)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
