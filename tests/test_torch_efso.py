"""The port's EFSO (da/efso.py) against the reference's on the same seeded
inputs: the energy weights exactly, the localized sums and the advected
coordinates to float32 rounding, and the per-obs impact ΔJ to
1e-5·max|ΔJ| — with and without vertical localization and advected
localization, on a 20×16×6 grid of 2-km cells with K = 8."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu.da import efso as ref
from scale_letkf_tpu.grid import Grid as RefGrid
from scale_letkf_torch.da import efso
from scale_letkf_torch.grid import Grid
from scale_letkf_torch.state import IA_T, IA_U, NV3D

torch.set_num_threads(1)
K, NZ, NY, NX = 8, 6, 16, 20


def _grids():
    kw = dict(nx=NX, ny=NY, nz=NZ, dx=2e3, dy=2e3, dz=500.0)
    return RefGrid.uniform(**kw), Grid.uniform(**kw)


def _inputs(seed=0, nobs=40):
    rng = np.random.default_rng(seed)
    pert = rng.standard_normal((K, NV3D, NZ, NY, NX)).astype(np.float32)
    pert -= pert.mean(axis=0, keepdims=True)
    err = rng.standard_normal((NV3D, NZ, NY, NX)).astype(np.float32)
    f32 = np.float32
    obs = dict(
        ri=rng.uniform(0, NX - 1, nobs).astype(f32),
        rj=rng.uniform(0, NY - 1, nobs).astype(f32),
        rk=rng.uniform(0, NZ - 1, nobs).astype(f32),
        dep=rng.standard_normal(nobs).astype(f32),
        rdiag=rng.uniform(0.5, 2.0, nobs).astype(f32),
        hdxa=rng.standard_normal((nobs, K)).astype(f32))
    u = (5.0 + rng.standard_normal((NZ, NY, NX))).astype(f32)
    v = rng.standard_normal((NZ, NY, NX)).astype(f32)
    return pert, err, obs, u, v


def test_energy_weights_equal():
    np.testing.assert_array_equal(efso.energy_weights(NV3D),
                                  ref.energy_weights(NV3D))
    np.testing.assert_array_equal(efso.energy_weights(NV3D, 0.0),
                                  ref.energy_weights(NV3D, 0.0))


@pytest.mark.parametrize("sig", [(2.0, 0.0, 0.0), (3.5, 1.2, 1.5),
                                 (0.4, 0.0, 0.0)])
def test_localized_sums_match_reference(sig):
    rng = np.random.default_rng(1)
    f = rng.standard_normal((K, NZ, NY, NX)).astype(np.float32)
    want = np.asarray(ref.localized_sums(jnp.asarray(f), *sig))
    got = efso.localized_sums(torch.from_numpy(f), *sig).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_advected_obs_coords_match_reference():
    grid_r, grid = _grids()
    _, _, obs, u, v = _inputs()
    ri_r, rj_r = ref.advected_obs_coords(
        jnp.asarray(obs["ri"]), jnp.asarray(obs["rj"]),
        jnp.asarray(obs["rk"]), jnp.asarray(u), jnp.asarray(v), grid_r,
        adv_time=600.0, locadv_rate=0.8)
    ri, rj = efso.advected_obs_coords(
        torch.from_numpy(obs["ri"]), torch.from_numpy(obs["rj"]),
        torch.from_numpy(obs["rk"]), torch.from_numpy(u),
        torch.from_numpy(v), grid, adv_time=600.0, locadv_rate=0.8)
    np.testing.assert_allclose(ri.numpy(), np.asarray(ri_r), rtol=1e-6)
    np.testing.assert_allclose(rj.numpy(), np.asarray(rj_r), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["horizontal", "vertical", "advected"])
def test_efso_impact_matches_reference(case):
    grid_r, grid = _grids()
    pert, err, obs, u, v = _inputs(2)
    kw = dict(hori_scale=5e3,
              vert_scale_cells=1.5 if case != "horizontal" else 0.0)
    adv = (dict(adv_time=600.0, locadv_rate=1.0) if case == "advected"
           else {})
    names = ("ri", "rj", "rk", "dep", "rdiag", "hdxa")
    dj_r = np.asarray(ref.efso_impact(
        *(jnp.asarray(obs[n]) for n in names), jnp.asarray(pert),
        jnp.asarray(err), grid_r, **kw,
        **({"u_adv": jnp.asarray(u), "v_adv": jnp.asarray(v), **adv}
           if adv else {})))
    dj = efso.efso_impact(
        *(torch.from_numpy(obs[n]) for n in names), torch.from_numpy(pert),
        torch.from_numpy(err), grid, **kw,
        **({"u_adv": torch.from_numpy(u), "v_adv": torch.from_numpy(v),
            **adv} if adv else {})).numpy()
    assert np.isfinite(dj).all() and np.abs(dj_r).max() > 0
    np.testing.assert_allclose(dj, dj_r, rtol=0,
                               atol=1e-5 * np.abs(dj_r).max())


def test_efso_sign_convention():
    """tests/test_efso.py's good observation: negative impact, and the
    opposite innovation the opposite impact."""
    rng = np.random.default_rng(0)
    k, nz, ny, nx = 16, 4, 12, 12
    grid = Grid.uniform(nx=nx, ny=ny, nz=nz, dx=2e3, dy=2e3, dz=500.0)
    pert = np.zeros((k, NV3D, nz, ny, nx), np.float32)
    base = rng.standard_normal((k, nz, ny, nx)).astype(np.float32)
    base -= base.mean(0, keepdims=True)
    pert[:, IA_T] = base
    err = np.zeros((NV3D, nz, ny, nx), np.float32)
    err[IA_T, :, 6, 6] = 1.0
    hdxa = torch.from_numpy(base[:, 2, 6, 6][None, :].copy())
    one = torch.tensor([6.0])
    args = (one, one, torch.tensor([2.0]))
    dj = efso.efso_impact(*args, torch.tensor([-1.0]), torch.tensor([1.0]),
                          hdxa, torch.from_numpy(pert), torch.from_numpy(err),
                          grid, hori_scale=6e3, vert_scale_cells=2.0)
    dj2 = efso.efso_impact(*args, torch.tensor([1.0]), torch.tensor([1.0]),
                           hdxa, torch.from_numpy(pert),
                           torch.from_numpy(err), grid, hori_scale=6e3,
                           vert_scale_cells=2.0)
    assert float(dj[0]) < 0.0
    np.testing.assert_allclose(float(dj2[0]), -float(dj[0]), rtol=1e-5)
    assert efso.energy_weights(NV3D)[IA_U] == 0.5
