"""PyTorch/CUDA port of the SCALE-LETKF ensemble data-assimilation framework.

The JAX package ``scale_letkf_tpu`` is the reference; this package mirrors its
module paths (``scale_letkf_torch/ops/invsqrt.py`` is the counterpart of
``scale_letkf_tpu/ops/invsqrt.py``) and is held against it by the
``tests/test_torch_*.py`` parity tests. It imports neither jax nor anything
of ``scale_letkf_tpu``: what it needs of the reference's jax-free host
modules (``config``, ``constants``, ``obs.types``, ``utils.native``) it keeps
as its own copies, which ``tests/test_torch_config.py`` holds equal to them.

Slices ported so far: the LETKF analysis (``da/letkf.py analyze``) with the
obs context, selection and localization, the batched K×K transform and the
hand-written Newton–Schulz CUDA kernel (``csrc/invsqrt_ns.cu``); the
ensemble forecast (``cycle.py CycleDriver.forecast``) with the split-explicit
core and the hand-written tendency and tracer-advection kernels
(``csrc/dyn_tendency.cu``, ``csrc/adv_ud3.cu``).

Every function that touches a device takes it explicitly; nothing picks a
device implicitly.
"""

__version__ = "0.1.0"
