"""The port's dynamical core (scale_letkf_torch/model/dycore.py) on its plain
path (CPU tensors) against the reference's (scale_letkf_tpu/model/dycore.py,
the XLA default path), from the same numpy inputs.

Tendencies agree per field to 2e-5·max|reference| (the bound the reference
holds its own Pallas kernel to, tests/test_pallas_tendency.py), over uniform
and stretched vertical metrics, periodic and open lateral boundaries,
divergence damping off and on, and ny = 8, which the Pallas kernel cannot
trace. Three RK3 steps agree per field to 1e-4·max|increment| + 2 ulp of
max|field|: both sides round float32 sums in different orders, and the
rounding of ρθ ≈ 300 ρ is larger than the increments of some fields.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from scale_letkf_tpu.model import dycore as ref
from scale_letkf_tpu.model import ideal as ref_ideal
from scale_letkf_tpu.state import NQ
from scale_letkf_torch.io.convert import (
    dycore_config_from_dict, dycore_state_to_numpy, dycore_state_to_torch,
    vgrid_to_torch,
)
from scale_letkf_torch.model import dycore, ideal

torch.set_num_threads(1)
CPU = torch.device("cpu")


def random_state(rng, nz, ny, nx, dz=500.0):
    """float32 numpy fields of the tests/test_pallas_tendency.py
    construction: a hydrostatic column with 1% noise, winds ≈ 5 m/s, ρw
    zero at the rigid faces, tracers ≈ 1e-3. Returns (fields, rho_ref,
    p_ref)."""
    theta = 300.0 + 10.0 * np.linspace(0, 1, nz)
    rho1d, p1d = ref.hydrostatic_reference(theta, dz)
    rho = rho1d[:, None, None] * (1.0 + 0.01 * rng.standard_normal((nz, ny, nx)))
    rhot = rho * theta[:, None, None] * (
        1.0 + 0.01 * rng.standard_normal((nz, ny, nx)))
    rhou = 5.0 * rng.standard_normal((nz, ny, nx)) * rho
    rhov = 5.0 * rng.standard_normal((nz, ny, nx)) * rho
    rhow = 0.5 * rng.standard_normal((nz + 1, ny, nx))
    rhow[0] = rhow[-1] = 0.0
    rhoq = np.abs(1e-3 * rng.standard_normal((NQ, nz, ny, nx))) * rho
    f32 = [np.asarray(a, np.float32)
           for a in (rho, rhou, rhov, rhow, rhot, rhoq)]
    return (f32, np.asarray(rho1d[:, None, None], np.float32),
            np.asarray(p1d[:, None, None], np.float32))


def stretched_levels(nz, dz0=300.0, stretch=1.04):
    fz = np.concatenate([[0.0], np.cumsum(dz0 * stretch ** np.arange(nz))])
    return 0.5 * (fz[1:] + fz[:-1]), fz


def both(fields):
    """The same numpy fields as a reference DycoreState and a port one."""
    return (ref.DycoreState(*(jnp.asarray(a) for a in fields)),
            dycore_state_to_torch(fields, CPU))


def assert_fields_close(out, expect, rel, names=dycore.DycoreState._fields):
    for name, a, b in zip(names, expect, out):
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(np.asarray(b) - a).max())
        assert err <= rel * scale, f"{name}: {err:.3e} > {rel}·{scale:.3e}"


CASES = [(metric, lateral, divdmp, (8, 16, 16))
         for metric in ("uniform", "stretched")
         for lateral in ("periodic", "open")
         for divdmp in (0.0, 0.05)]
CASES += [("uniform", "periodic", 0.05, (6, 8, 12)),
          ("stretched", "open", 0.05, (6, 8, 12))]


@pytest.mark.parametrize("metric,lateral,divdmp,shape", CASES)
def test_tendencies_match_reference(metric, lateral, divdmp, shape):
    nz, ny, nx = shape
    rng = np.random.default_rng(nz * ny + nx)
    fields, rho_ref, p_ref = random_state(rng, nz, ny, nx)
    cfg_r = ref.DycoreConfig(dx=2000.0, dy=2000.0, dz=500.0, dt=4.0,
                             divdmp=divdmp, kdiff4=1e-3, lateral=lateral)
    cfg = dycore_config_from_dict(dataclasses.asdict(cfg_r))
    vg_r = vg = None
    if metric == "stretched":
        vg_r = ref.make_vgrid(*stretched_levels(nz))
        vg = vgrid_to_torch(vg_r, CPU)
    s_r, s = both(fields)
    with ref.lateral_bc(lateral):
        expect = ref.tendencies(s_r, cfg_r, jnp.asarray(rho_ref),
                                jnp.asarray(p_ref), vg_r)
    out = dycore.tendencies(s, cfg, torch.from_numpy(rho_ref),
                            torch.from_numpy(p_ref), vg)
    assert all(o.dtype == torch.float32 for o in out)
    assert_fields_close(dycore_state_to_numpy(out), expect, 2e-5)


def test_batched_tendencies_equal_per_member():
    """A leading member axis (the port's replacement of vmap) gives each
    member's tendencies exactly."""
    rng = np.random.default_rng(3)
    members = [random_state(rng, 6, 8, 12)[0] for _ in range(3)]
    _, rho_ref, p_ref = random_state(rng, 6, 8, 12)
    cfg = dycore.DycoreConfig(dx=2000.0, dy=2000.0, dz=500.0, dt=4.0)
    ens = dycore_state_to_torch([np.stack(f) for f in zip(*members)], CPU)
    out = dycore.tendencies(ens, cfg, torch.from_numpy(rho_ref),
                            torch.from_numpy(p_ref))
    for m, fields in enumerate(members):
        one = dycore.tendencies(dycore_state_to_torch(fields, CPU), cfg,
                                torch.from_numpy(rho_ref),
                                torch.from_numpy(p_ref))
        for a, b in zip(out, one):
            torch.testing.assert_close(a[m], b, rtol=0, atol=0)


def test_unknown_lateral_mode_raises():
    rng = np.random.default_rng(4)
    fields, rho_ref, p_ref = random_state(rng, 4, 8, 8)
    cfg = dycore.DycoreConfig(dx=1.0, dy=1.0, dz=1.0, dt=1.0,
                              lateral="closed")
    with pytest.raises(ValueError, match="lateral"):
        dycore.tendencies(dycore_state_to_torch(fields, CPU), cfg,
                          torch.from_numpy(rho_ref), torch.from_numpy(p_ref))


@pytest.mark.parametrize("lateral", ["periodic", "open"])
def test_collocated_round_trip_matches_reference(lateral):
    rng = np.random.default_rng(5)
    members = [random_state(rng, 5, 8, 10)[0] for _ in range(2)]
    fields = [np.stack(f) for f in zip(*members)]
    s_r, s = both(fields)
    with ref.lateral_bc(lateral):
        v_r = jax.vmap(ref.to_collocated)(s_r)
        back_r = jax.vmap(ref.from_collocated)(v_r)
    v = dycore.to_collocated(s, lateral)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_r), rtol=1e-6,
                               atol=1e-12)
    back = dycore.from_collocated(v, lateral)
    assert_fields_close(dycore_state_to_numpy(back), back_r, 1e-6)
    assert float(back.rhow[:, 0].abs().max()) == 0.0
    assert float(back.rhow[:, -1].abs().max()) == 0.0


def test_rayleigh_sponge_matches_reference():
    rng = np.random.default_rng(6)
    nz = 10
    fields, _, _ = random_state(rng, nz, 8, 8)
    cz, fz = stretched_levels(nz, dz0=1500.0)
    kw = dict(dx=2000.0, dy=2000.0, dz=1500.0, dt=30.0,
              sponge_height=float(cz[5]), sponge_tau=300.0,
              ztop=float(fz[-1]))
    s_r, s = both(fields)
    expect = ref.rayleigh_sponge(s_r, s_r, ref.DycoreConfig(**kw),
                                 jnp.asarray(cz, jnp.float32), 30.0)
    out = dycore.rayleigh_sponge(s, s, dycore.DycoreConfig(**kw),
                                 torch.as_tensor(cz, dtype=torch.float32),
                                 30.0)
    assert_fields_close(dycore_state_to_numpy(out), expect, 1e-6)
    assert float((out.rhou - s.rhou)[:5].abs().max()) == 0.0


def test_balanced_state_matches_reference():
    nz, ny, nx, dz = 8, 4, 6, 500.0
    cz, _ = stretched_levels(nz)
    qv = 0.012 * np.exp(-cz / 3000.0)
    s_r, rr_r, pr_r = ref_ideal.balanced_state(nz, ny, nx, dz, qv_prof=qv,
                                               cz=cz)
    s, rr, pr = ideal.balanced_state(nz, ny, nx, dz, qv_prof=qv, cz=cz)
    assert_fields_close(dycore_state_to_numpy(s), s_r, 1e-7)
    np.testing.assert_allclose(rr.numpy(), np.asarray(rr_r), rtol=1e-7)
    np.testing.assert_allclose(pr.numpy(), np.asarray(pr_r), rtol=1e-7)


def _cli_grid_init():
    """The tests/test_cli.py grid (12×12×8, dx 2 km, dz 500 m, dt 1 s,
    qv_surface 0.008) with a warm bubble and seeded ρθ/wind noise, as
    float32 numpy fields."""
    nz, ny, nx, dz, dx = 8, 12, 12, 500.0, 2000.0
    cz = (np.arange(nz) + 0.5) * dz
    s, rho_ref, p_ref = ideal.balanced_state(
        nz, ny, nx, dz, qv_prof=0.008 * np.exp(-cz / 3000.0))
    s = ideal.add_warm_bubble(s, dz, dx, dx, amplitude=2.0)
    rng = np.random.default_rng(7)
    fields = [f.numpy().copy() for f in s]
    fields[1] += (3.0 * rng.standard_normal((nz, ny, nx)) * fields[0]
                  ).astype(np.float32)
    fields[4] += (0.3 * rng.standard_normal((nz, ny, nx)) * fields[0]
                  ).astype(np.float32)
    cfg_kw = dict(dx=dx, dy=dx, dz=dz, dt=1.0, ztop=nz * dz,
                  sponge_height=2500.0, sponge_tau=120.0)
    return fields, rho_ref.numpy(), p_ref.numpy(), cz, cfg_kw


def test_rk3_steps_match_reference():
    fields, rho_ref, p_ref, cz, cfg_kw = _cli_grid_init()
    s_r, s = both(fields)
    zc = np.asarray(cz, np.float32)
    cfg_r = ref.DycoreConfig(**cfg_kw)
    expect = ref.integrate(s_r, cfg_r, jnp.asarray(rho_ref),
                           jnp.asarray(p_ref), jnp.asarray(zc), 3)
    out = dycore.integrate(s, dycore.DycoreConfig(**cfg_kw),
                           torch.from_numpy(rho_ref), torch.from_numpy(p_ref),
                           torch.from_numpy(zc), 3)
    for name, a, b, f0 in zip(dycore.DycoreState._fields, expect, out,
                              fields):
        a = np.asarray(a)
        tol = (1e-4 * np.abs(a - f0).max()
               + 2 * np.spacing(np.abs(f0).max(), dtype=np.float32))
        err = np.abs(b.numpy() - a).max()
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def test_perturb_ensemble_shapes_and_seed():
    """perturb_ensemble draws from a torch.Generator (jax.random's numbers
    cannot be reproduced): members differ, the same seed repeats, only ρθ
    changes, and the top level carries the tapered amplitude."""
    s, _, _ = ideal.balanced_state(10, 8, 12, 500.0)

    def draw(seed):
        return ideal.perturb_ensemble(torch.Generator().manual_seed(seed), s,
                                      4)

    a, b, c = draw(0), draw(0), draw(1)
    assert a.rhot.shape == (4, 10, 8, 12) and a.rhoq.shape == (4, 6, 10, 8, 12)
    torch.testing.assert_close(a.rhot, b.rhot, rtol=0, atol=0)
    assert float((a.rhot - c.rhot).abs().max()) > 0
    assert float((a.rhot[0] - a.rhot[1]).abs().max()) > 0
    for name in ("rho", "rhou", "rhov", "rhow", "rhoq"):
        torch.testing.assert_close(getattr(a, name)[2], getattr(s, name),
                                   rtol=0, atol=0)
    dth = (a.rhot - s.rhot) / s.rho
    assert float(dth[:, -1].abs().max()) < 0.5 * float(dth[:, 2].abs().max())
