"""The port's lateral boundary forcing (scale_letkf_torch/model/boundary.py)
on the CPU against the reference's (scale_letkf_tpu/model/boundary.py),
from the same seeded numpy inputs: the Davies weight, the time
interpolation of the target (before, inside and after its interval), the
relaxation with a target shared by all members and with one per member
(3 members of different states), and the npz boundary file, written by
either package and loaded by the other.

Tolerances: the weight to 1 float32 ulp of 1/tau (both are float64 numpy
cast once); interpolated targets and relaxed states to 2 ulp of each
field's largest magnitude (two to three float32 roundings a value).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu.model import boundary as ref_bdy
from scale_letkf_tpu.model.dycore import DycoreState as RefState
from scale_letkf_torch.model import boundary
from scale_letkf_torch.model.dycore import DycoreState

CPU = torch.device("cpu")
K, NZ, NY, NX = 3, 4, 14, 18
WIDTH, TAU, DT = 4, 300.0, 30.0


def random_state(rng, lead=()):
    """Float32 numpy DycoreState with leading axes `lead`."""
    def f(*shape, scale=1.0, base=0.0):
        return (base + scale * rng.standard_normal(lead + shape)).astype(
            np.float32)
    return DycoreState(rho=f(NZ, NY, NX, scale=0.01, base=1.0),
                       rhou=f(NZ, NY, NX, scale=5.0),
                       rhov=f(NZ, NY, NX, scale=5.0),
                       rhow=f(NZ + 1, NY, NX, scale=0.5),
                       rhot=f(NZ, NY, NX, scale=3.0, base=300.0),
                       rhoq=np.abs(f(6, NZ, NY, NX, scale=1e-3)))


def to_torch(s):
    return DycoreState(*(torch.from_numpy(f) for f in s))


def to_ref(s):
    return RefState(*(jnp.asarray(f) for f in s))


def assert_fields(got, want):
    for name, a, b in zip(DycoreState._fields, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        tol = 2 * np.spacing(np.float32(np.abs(b).max()))
        assert np.abs(a - b).max() <= tol, name


def test_relaxation_weight_matches_reference():
    w = boundary.relaxation_weight(NY, NX, WIDTH, TAU)
    w_r = np.asarray(ref_bdy.relaxation_weight(NY, NX, WIDTH, TAU))
    assert w.dtype == torch.float32 and w.shape == (NY, NX)
    np.testing.assert_allclose(w.numpy(), w_r, rtol=0,
                               atol=np.spacing(np.float32(1 / TAU)))
    assert float(w.max()) == pytest.approx(1 / TAU)
    assert float(w[WIDTH:-WIDTH, WIDTH:-WIDTH].abs().max()) == 0.0


@pytest.mark.parametrize("t", [-100.0, 0.0, 250.0, 600.0, 1e4])
def test_interp_boundary_matches_reference(t):
    rng = np.random.default_rng(0)
    s0, s1 = random_state(rng), random_state(rng)
    got = boundary.interp_boundary(boundary.BoundaryData(
        to_torch(s0), to_torch(s1), 0.0, 600.0), t)
    want = ref_bdy.interp_boundary(ref_bdy.BoundaryData(
        to_ref(s0), to_ref(s1), 0.0, 600.0), t)
    assert_fields(got, want)
    if t <= 0.0:
        assert_fields(got, s0)
    elif t >= 600.0:
        assert_fields(got, s1)


@pytest.mark.parametrize("per_member", [False, True])
def test_apply_boundary_relaxation_matches_reference(per_member):
    """The ensemble relaxed toward a target shared by all members (one
    member's shape, broadcast) or toward one target per member."""
    rng = np.random.default_rng(1)
    ens = random_state(rng, (K,))
    target = random_state(rng, (K,) if per_member else ())
    w = boundary.relaxation_weight(NY, NX, WIDTH, TAU)
    got = boundary.apply_boundary_relaxation(to_torch(ens),
                                             to_torch(target), w, DT)
    w_r = ref_bdy.relaxation_weight(NY, NX, WIDTH, TAU)
    want = [ref_bdy.apply_boundary_relaxation(
        RefState(*(jnp.asarray(f[m]) for f in ens)),
        RefState(*(jnp.asarray(f[m] if per_member else f) for f in target)),
        w_r, DT) for m in range(K)]
    assert_fields(got, [np.stack([np.asarray(x[i]) for x in want])
                        for i in range(6)])
    # the interior is untouched, the edge moved toward the target
    for a, b in zip(got, ens):
        np.testing.assert_array_equal(a[..., WIDTH:-WIDTH, WIDTH:-WIDTH],
                                      b[..., WIDTH:-WIDTH, WIDTH:-WIDTH])
    assert not np.array_equal(got.rhot[..., 0].numpy(), ens.rhot[..., 0])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_boundary_file_loads_in_either_package(tmp_path, writer):
    rng = np.random.default_rng(2)
    s0, s1 = random_state(rng, (K,)), random_state(rng, (K,))
    path = tmp_path / "bdy.npz"
    if writer == "port":
        boundary.save_boundary(path, boundary.BoundaryData(
            to_torch(s0), to_torch(s1), 0.0, 3600.0))
    else:
        ref_bdy.save_boundary(path, ref_bdy.BoundaryData(
            to_ref(s0), to_ref(s1), 0.0, 3600.0))
    got = boundary.load_boundary(path, CPU)
    want = ref_bdy.load_boundary(path)
    assert (got.t0, got.t1) == (want.t0, want.t1) == (0.0, 3600.0)
    for tag, s in (("state0", s0), ("state1", s1)):
        for name, a, b, f in zip(DycoreState._fields, getattr(got, tag),
                                 getattr(want, tag), s):
            assert a.dtype == torch.float32 and a.device == CPU
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), f)
