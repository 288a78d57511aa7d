"""PyTorch port of ops/letkf_core.py against the reference package and the
float64 NumPy oracle (tests/oracle_letkf.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from scale_letkf_tpu.ops import letkf_core as ref
from scale_letkf_torch.ops import invsqrt as port_invsqrt
from scale_letkf_torch.ops import letkf_core as port_core
from scale_letkf_torch.ops.letkf_core import (
    letkf_core, pick_solver, total_weight, apply_weights, weight_rtpp,
    rtps_factor, rtps_update, relax_beta,
)
from oracle_letkf import letkf_core_np, rtpp_np, rtps_np, total_weight_np
from test_letkf_core import make_problem

torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_pick_solver_follows_reference_auto():
    assert pick_solver("auto", 8, torch.float32) == "eigh"
    assert pick_solver("auto", 50, torch.float32) == "ns_kernel"
    assert pick_solver("auto", 128, torch.float32) == "ns_kernel"
    assert pick_solver("auto", 50, torch.float64) == "ns"
    assert pick_solver("auto", 129, torch.float32) == "ns"
    with pytest.raises(ValueError):
        pick_solver("lax", 50, torch.float32)


@pytest.mark.parametrize("K,solver", [(4, "eigh"), (8, "eigh"), (20, "eigh"),
                                      (20, "ns"), (20, "auto"), (8, "auto")])
def test_matches_oracle_f64(K, solver):
    rng = np.random.default_rng(0)
    B, L = 16, 30
    hdxb, rdiag, rloc, dep, infl, nl = make_problem(rng, B, L, K,
                                                    frac_empty=0.2)
    res = letkf_core(*_t(hdxb, rdiag, rloc, dep, infl), infl_update=True,
                     solver=solver)
    for b in range(B):
        o = letkf_core_np(hdxb[b], rdiag[b], rloc[b], dep[b], infl[b],
                          nobsl=nl[b], infl_update=True)
        np.testing.assert_allclose(res.trans[b], o["trans"], atol=1e-9)
        np.testing.assert_allclose(res.transm[b], o["transm"], atol=1e-9)
        np.testing.assert_allclose(res.pao[b], o["pao"], atol=1e-9)
        np.testing.assert_allclose(res.infl[b], o["infl"], atol=1e-9)


@pytest.mark.parametrize("solver", ["auto", "ns_kernel", "ns", "eigh"])
@pytest.mark.parametrize("K", [20, 50])
def test_matches_reference_pallas_f32(K, solver):
    """float32 against the reference letkf_core(eigh_impl='ns_pallas') with
    its Pallas kernel in interpret mode: trans to 1e-4·max|trans|, transm
    to 1e-3 (tests/test_invsqrt.py:66-70), with zero-obs rows."""
    rng = np.random.default_rng(3)
    B, L = 64, 30
    hdxb = rng.standard_normal((B, L, K)).astype(np.float32)
    rdiag = rng.uniform(0.5, 2.0, (B, L)).astype(np.float32)
    rloc = rng.uniform(0.0, 1.0, (B, L)).astype(np.float32)
    rloc[:4] = 0.0              # zero-obs rows
    dep = rng.standard_normal((B, L)).astype(np.float32)
    infl = np.full(B, 1.1, np.float32)
    with pltpu.force_tpu_interpret_mode():
        r = ref.letkf_core(*(jnp.asarray(a) for a in
                             (hdxb, rdiag, rloc, dep, infl)),
                           infl_update=True, eigh_impl="ns_pallas")
    res = letkf_core(*_t(hdxb, rdiag, rloc, dep, infl), infl_update=True,
                     solver=solver)
    scale = float(np.abs(np.asarray(r.trans)).max())
    np.testing.assert_allclose(res.trans.numpy(), np.asarray(r.trans),
                               rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(res.transm.numpy(), np.asarray(r.transm),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(res.pao.numpy(), np.asarray(r.pao), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(r.pao)).max()))
    np.testing.assert_allclose(res.infl.numpy(), np.asarray(r.infl),
                               rtol=1e-5)
    # zero-obs rows: W = sqrt(ρ)·I, w̄ = 0, ρ unchanged
    np.testing.assert_allclose(res.trans[:4].numpy(),
                               np.broadcast_to(np.sqrt(1.1) * np.eye(K),
                                               (4, K, K)), atol=1e-6)
    assert float(res.transm[:4].abs().max()) == 0.0
    np.testing.assert_array_equal(res.infl[:4].numpy(), infl[:4])


def test_zero_obs_identity():
    rng = np.random.default_rng(1)
    K, B, L = 8, 4, 12
    hdxb, rdiag, rloc, dep, infl, _ = make_problem(rng, B, L, K, nobsl=0)
    res = letkf_core(*_t(hdxb, rdiag, rloc, dep, infl), infl_update=True)
    for b in range(B):
        np.testing.assert_allclose(res.trans[b], np.sqrt(infl[b]) * np.eye(K),
                                   atol=1e-10)
        np.testing.assert_allclose(res.transm[b], 0.0, atol=1e-12)
        np.testing.assert_allclose(res.pao[b], infl[b] / (K - 1) * np.eye(K),
                                   atol=1e-12)
        np.testing.assert_allclose(res.infl[b], infl[b], atol=0)


def test_min_infl_and_rdiag_wloc_match_reference():
    rng = np.random.default_rng(8)
    K, B, L = 20, 16, 25
    hdxb, rdiag, rloc, dep, infl, _ = make_problem(rng, B, L, K)
    rdiag_w = np.where(rloc > 0, rdiag / np.maximum(rloc, 1e-30), 1.0)
    kw = dict(rdiag_wloc=True, infl_update=True, min_infl=1.15)
    r = ref.letkf_core(*(jnp.asarray(a) for a in
                         (hdxb, rdiag_w, rloc, dep, infl)), eigh_impl="lax",
                       **kw)
    res = letkf_core(*_t(hdxb, rdiag_w, rloc, dep, infl), solver="eigh", **kw)
    for name in ("trans", "transm", "pao", "infl"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(r, name)), atol=1e-9)
    assert float(res.infl.min()) >= 1.15


def test_rtpp_rtps_total_weight_match_oracle():
    rng = np.random.default_rng(5)
    B, L, K = 6, 18, 8
    hdxb, rdiag, rloc, dep, infl, _ = make_problem(rng, B, L, K)
    res = letkf_core(*_t(hdxb, rdiag, rloc, dep, infl))
    alpha = 0.6
    w_rtpp = weight_rtpp(res.trans, torch.from_numpy(infl), alpha)
    xb = rng.standard_normal((B, K))
    m = rtps_factor(res.pao, torch.from_numpy(xb), torch.from_numpy(infl),
                    alpha)
    beta = rng.uniform(0, 1, B)
    upd = rtps_update(torch.from_numpy(xb)[None], res.trans, res.transm,
                      torch.from_numpy(beta), m[None])[0]
    w_tot = total_weight(w_rtpp, res.transm, torch.from_numpy(beta))
    for b in range(B):
        np.testing.assert_allclose(
            w_rtpp[b], rtpp_np(res.trans[b].numpy(), infl[b], alpha),
            atol=1e-10)
        wr, mr = rtps_np(res.trans[b].numpy(), res.pao[b].numpy(), xb[b],
                         infl[b], alpha)
        np.testing.assert_allclose(m[b], mr, atol=1e-10)
        # the RTPS update is Xb'·W' with W' = total_weight(W·m, w̄, β)
        np.testing.assert_allclose(
            upd[b], xb[b] @ total_weight_np(wr, res.transm[b].numpy(),
                                            beta[b]), atol=1e-10)
        np.testing.assert_allclose(
            w_tot[b], total_weight_np(w_rtpp[b].numpy(),
                                      res.transm[b].numpy(), beta[b]),
            atol=1e-10)
    # RTPS with zero perturbations leaves W unchanged, m = 1
    m0 = rtps_factor(res.pao, torch.zeros(B, K, dtype=torch.float64),
                     torch.from_numpy(infl), alpha)
    np.testing.assert_array_equal(m0.numpy(), np.ones(B))
    beta_t = torch.from_numpy(beta)
    np.testing.assert_allclose(
        rtps_update(torch.from_numpy(xb)[None], res.trans, res.transm,
                    beta_t, m0[None])[0].numpy(),
        np.einsum("bk,bkm->bm", xb, total_weight(
            res.trans, res.transm, beta_t).numpy()), atol=1e-10)


def test_weights_match_reference_f32():
    rng = np.random.default_rng(9)
    B, K, nv = 12, 20, 3
    trans = rng.standard_normal((B, K, K)).astype(np.float32)
    pao = np.einsum("bik,bjk->bij", trans, trans).astype(np.float32)
    transm = rng.standard_normal((B, K)).astype(np.float32)
    infl = rng.uniform(1.0, 1.3, B).astype(np.float32)
    beta = rng.uniform(0, 1, B).astype(np.float32)
    pert = rng.standard_normal((nv, B, K)).astype(np.float32)
    mean = rng.standard_normal((nv, B)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in dict(
        trans=trans, pao=pao, transm=transm, infl=infl, beta=beta,
        pert=pert, mean=mean).items()}
    w_r = ref.total_weight(ref.weight_rtpp(j["trans"], j["infl"], 0.8),
                           j["transm"], j["beta"])
    w = total_weight(weight_rtpp(*_t(trans, infl), 0.8),
                     *_t(transm, beta))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), rtol=1e-6,
                               atol=1e-6)
    a_r = ref.apply_weights(j["pert"], j["mean"], w_r[None])
    a = apply_weights(*_t(pert, mean), w[None])
    np.testing.assert_allclose(a.numpy(), np.asarray(a_r), rtol=1e-5,
                               atol=1e-5)
    ws_r, m_r = ref.weight_rtps(j["trans"], j["pao"], j["pert"][0],
                                j["infl"], 0.7)
    upd_r = jnp.einsum("bk,bkm->bm", j["pert"][0],
                       ref.total_weight(ws_r, j["transm"], j["beta"]))
    m = rtps_factor(*_t(pao, pert[0], infl), 0.7)
    upd = rtps_update(*_t(pert[:1], trans, transm, beta), m[None])[0]
    np.testing.assert_allclose(m.numpy(), np.asarray(m_r), rtol=1e-5)
    np.testing.assert_allclose(upd.numpy(), np.asarray(upd_r), rtol=1e-5,
                               atol=1e-5)


def test_apply_weights_reduces_error():
    rng = np.random.default_rng(6)
    K, L = 20, 10
    truth = 5.0
    ens = truth + rng.standard_normal(K) * 2.0 + 1.5   # biased prior
    mean = ens.mean()
    pert = ens - mean
    obs = truth + rng.standard_normal(L) * 0.1
    hdxb = np.tile(pert[None, :], (L, 1))
    res = letkf_core(*_t(hdxb[None], np.full((1, L), 0.01), np.ones((1, L)),
                         (obs - mean)[None], np.ones(1)))
    w = total_weight(res.trans, res.transm, torch.ones(1, dtype=torch.float64))
    anal = apply_weights(torch.from_numpy(pert[None]),
                         torch.tensor([mean]), w)
    assert abs(float(anal.mean()) - truth) < abs(mean - truth) * 0.2


def test_relax_beta_matches_reference():
    z = np.asarray([0.0, 5e3, 20e3])
    d = np.asarray([1e3, 50e3, 200e3])
    for kw in (dict(buffer_width=100e3),
               dict(radar_only=True, radar_zmax=10e3, vert_cutoff=1e3),
               dict(buffer_width=100e3, radar_only=True, radar_zmax=10e3,
                    vert_cutoff=1e3)):
        np.testing.assert_allclose(
            relax_beta(*_t(d, z), **kw).numpy(),
            np.asarray(ref.relax_beta(jnp.asarray(d), jnp.asarray(z), **kw)),
            atol=1e-12)


def test_products_in_full_fp32_whatever_the_caller_chose(monkeypatch):
    """letkf_core and the kernel's plain version run their float32 products
    without TF32 even when the caller chose it, and give the choice back."""
    matmul = torch.backends.cuda.matmul
    seen = []

    def recording(fn):
        def wrapped(*args, **kwargs):
            seen.append(matmul.fp32_precision)
            return fn(*args, **kwargs)
        return wrapped

    # invsqrt_ns is called inside letkf_core, _eye inside invsqrt_ns_plain
    monkeypatch.setattr(port_core, "invsqrt_ns", recording(port_core.invsqrt_ns))
    monkeypatch.setattr(port_invsqrt, "_eye", recording(port_invsqrt._eye))
    rng = np.random.default_rng(4)
    hdxb, rdiag, rloc, dep, infl, _ = make_problem(rng, 4, 12, 20)
    args = _t(*(a.astype(np.float32) for a in (hdxb, rdiag, rloc, dep, infl)))
    a = torch.eye(64).expand(2, 64, 64).contiguous()
    saved = matmul.fp32_precision
    matmul.fp32_precision = "tf32"
    try:
        letkf_core(*args, solver="ns_kernel")
        assert matmul.fp32_precision == "tf32"
        port_invsqrt.invsqrt_ns_plain(a, a)
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = saved
    assert seen == ["ieee"] * 3


def _sub_batches(B):
    return [slice(0, 1), slice(3, 10), slice(B - 5, B)]


@pytest.mark.parametrize("V", [1, 2, 11])
def test_weight_update_pads_small_groups(V):
    """weight_update of a group of fewer than DEP_COLUMNS variables is the
    padded product's rows (one variable made a batched matrix-vector
    product, batch-dependent on the card), a point's bits do not depend on
    its batch, and the values are Σ_k Xb'_k W'_km."""
    rng = np.random.default_rng(V)
    B, K = 40, 20
    pert, w = _t(rng.standard_normal((V, B, K)).astype(np.float32),
                 rng.standard_normal((B, K, K)).astype(np.float32))
    got = port_core.weight_update(pert, w)
    assert got.shape == (V, B, K)
    pad = torch.cat([pert, torch.zeros((max(0, 8 - V), B, K))])
    assert torch.equal(got, port_core.weight_update(pad, w)[:V])
    for s in _sub_batches(B):
        assert torch.equal(port_core.weight_update(pert[:, s], w[s]),
                           got[:, s])
    want = np.einsum("vbk,bkm->vbm", pert.double().numpy(), w.double().numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_det_increment_is_member_order():
    """The deterministic member's increment is the member-order sum of
    Xb'_k·transmd_k (the einsum over (v, b, k) was batch-dependent on the
    card): the same bits in any batch, the einsum's values."""
    rng = np.random.default_rng(3)
    V, B, K = 11, 40, 50
    pert, transmd = _t(rng.standard_normal((V, B, K)).astype(np.float32),
                       rng.standard_normal((B, K)).astype(np.float32))
    got = port_core.det_increment(pert, transmd)
    acc = pert[..., 0] * transmd[:, 0]
    for k in range(1, K):
        acc = acc + pert[..., k] * transmd[:, k]
    assert torch.equal(got, acc)
    for s in _sub_batches(B):
        assert torch.equal(port_core.det_increment(pert[:, s], transmd[s]),
                           got[:, s])
    np.testing.assert_allclose(
        got.numpy(), np.einsum("vbk,bk->vb", pert.double().numpy(),
                               transmd.double().numpy()),
        rtol=1e-5, atol=1e-5)
