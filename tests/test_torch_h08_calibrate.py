"""The port's H08 band-model calibration (obs/h08_calibrate.py) against the
reference's, float64 on both sides (the reference under the tests' x64):
the profile set and the surrogate BTs exactly equal in construction (numpy
on both sides; the surrogate to 1e-12 relative, its Planck functions being
jnp there), _model_bt to 1e-4 K and its gradient to rtol 1e-4, the fitted
coefficients after 50 Adam steps to rtol 1e-3, and a fit that lowers the
misfit. main writes where the caller says."""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from scale_letkf_tpu.obs import h08 as ref_h08
from scale_letkf_tpu.obs import h08_calibrate as ref
from scale_letkf_torch.obs import h08, h08_calibrate as port

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def profiles():
    prof = port.make_profile_set(n=12, nz=16, seed=1)
    prof_r = ref.make_profile_set(n=12, nz=16, seed=1)
    for k in prof:
        np.testing.assert_array_equal(prof[k], prof_r[k], k)
    bt = port.surrogate_bt(prof["p"], prof["t"], prof["qv"], prof["tsfc"],
                           prof["psfc"], prof["zenith"])
    bt_r = np.asarray(ref.surrogate_bt(
        prof["p"], prof["t"], prof["qv"], prof["tsfc"], prof["psfc"],
        prof["zenith"]))
    np.testing.assert_allclose(bt, bt_r, rtol=1e-12)
    assert np.isfinite(bt).all() and (bt > 150).all() and (bt < 330).all()
    return prof, bt


def _ref_params(k_wv, k_fix, p_exp):
    return {"log_kwv": jnp.log(jnp.asarray(k_wv, jnp.float64)),
            "log_kfix": jnp.log(jnp.asarray(k_fix, jnp.float64)),
            "p_exp": jnp.asarray(p_exp, jnp.float64)}


@pytest.mark.parametrize("coef", ["default", "shifted"])
def test_model_bt_and_gradient_match_reference(profiles, coef):
    prof, bt = profiles
    c = h08.DEFAULT_COEF
    if coef == "shifted":
        c = h08.H08Coefficients(k_wv=tuple(1.3 * np.asarray(c.k_wv)),
                                k_fix=tuple(0.7 * np.asarray(c.k_fix)),
                                wv_p_exp=0.7)
    ps = port.initial_params(c, device=CPU)
    ps_r = _ref_params(c.k_wv, c.k_fix, c.wv_p_exp)
    want = np.asarray(ref._model_bt(ps_r, prof))
    np.testing.assert_allclose(port._model_bt(ps, prof).numpy(), want,
                               rtol=0, atol=1e-4)

    def loss_r(p):
        return jnp.mean((ref._model_bt(p, prof) - jnp.asarray(bt)) ** 2)
    g_r = jax.grad(loss_r)(ps_r)
    for v in ps.values():
        v.requires_grad_(True)
    torch.mean((port._model_bt(ps, prof) - torch.as_tensor(bt)) ** 2
               ).backward()
    for k in ps:
        np.testing.assert_allclose(ps[k].grad.numpy(), np.asarray(g_r[k]),
                                   rtol=1e-4, err_msg=k)


def test_fit_matches_reference(profiles, monkeypatch):
    """50 Adam steps from the module coefficients: the same coefficients
    to rtol 1e-3 and the same residuals, the misfit lower."""
    prof, bt = profiles
    # the reference's h08 module constants are jnp arrays of the default
    # dtype (float32 at import); hand its fit the float64 values
    for name in ("K_WV", "K_FIX"):
        monkeypatch.setattr(ref_h08, name, jnp.asarray(
            np.asarray(getattr(h08, name)), jnp.float64))
    fit_r, st_r = ref.fit(prof, bt, steps=50)
    fit, st = port.fit(prof, bt, steps=50, device=CPU)
    for k in ("k_wv", "k_fix"):
        np.testing.assert_allclose(fit[k], fit_r[k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(fit["wv_p_exp"], fit_r["wv_p_exp"], rtol=1e-3)
    assert st["bt_rmse_before_K"] == st_r["bt_rmse_before_K"]
    assert abs(st["bt_rmse_after_K"] - st_r["bt_rmse_after_K"]) <= 0.002
    assert st["bt_rmse_after_K"] < st["bt_rmse_before_K"]


def test_main_writes_where_it_is_told(tmp_path, monkeypatch, capsys):
    """main(out_path) writes out_path, which h08.load_calibration reads."""
    small = port.make_profile_set(n=6, nz=10, seed=2)
    real_fit = port.fit
    monkeypatch.setattr(port, "make_profile_set", lambda **kw: small)
    monkeypatch.setattr(port, "fit", lambda **kw: real_fit(
        prof=small, steps=5, **kw))
    out = tmp_path / "cal.json"
    port.main(str(out), CPU)
    d = json.loads(out.read_text())
    coef = h08.load_calibration(str(out))
    assert len(coef.k_wv) == 10 and coef.wv_p_exp == d["wv_p_exp"]
    assert "NOT RTTOV" in d["stats"]["reference"]
    assert f"wrote {out}" in capsys.readouterr().out
