"""PyTorch port of ops/obs_select.py and ops/localization.py against the
reference package. Candidates must match exactly; selections are compared
as sets ordered by (score, idx), since the order of equal scores is
unspecified on both sides; rloc/rdiag to rtol 1e-6 (float32)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scale_letkf_tpu.ops import localization as ref_loc
from scale_letkf_tpu.ops import obs_select as ref
from scale_letkf_tpu.utils import native as ref_native
from scale_letkf_torch.ops import localization as loc
from scale_letkf_torch.ops import obs_select as port
from scale_letkf_torch.utils import native

torch.set_num_threads(1)

DOMAIN = 400.0e3     # [m]
HS = 30.0e3          # horizontal localization scale [m]
VS = 2000.0          # vertical localization scale [m]


def _network(seed, nobs=3000, stacked=0):
    """Random obs (x, y, vert, err) plus `stacked` obs sharing one column."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, DOMAIN, nobs)
    y = rng.uniform(0, DOMAIN, nobs)
    if stacked:
        x[:stacked] = 0.3 * DOMAIN
        y[:stacked] = 0.6 * DOMAIN
    v = rng.uniform(0, 10e3, nobs)
    e = rng.uniform(0.5, 2.0, nobs)
    return [a.astype(np.float32) for a in (x, y, v, e)]


def _gridpoints(seed, B=64):
    rng = np.random.default_rng(seed + 1)
    return [rng.uniform(0, DOMAIN, B).astype(np.float32),
            rng.uniform(0, DOMAIN, B).astype(np.float32),
            rng.uniform(0, 10e3, B).astype(np.float32)]


def _buckets(x, y, nsch=1, max_capacity=0, fallback=False, monkeypatch=None):
    cutoff = HS * ref_loc.DIST_ZERO_FAC
    args = (x.astype(np.float64), y.astype(np.float64), 0.0, 0.0, DOMAIN,
            DOMAIN, cutoff / nsch)
    kw = dict(max_capacity=max_capacity, nsch=nsch,
              index_map=np.arange(len(x), dtype=np.int32))
    if fallback:
        for lib in (ref_native, native):
            monkeypatch.setattr(lib, "load", lambda: None)
    return ref.build_buckets(*args, **kw), port.build_buckets(*args, **kw)


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("nsch,max_capacity", [(1, 0), (3, 0), (3, 8)])
def test_build_buckets_matches_reference(monkeypatch, fallback, nsch,
                                         max_capacity):
    x, y, _, _ = _network(0, stacked=40)
    b_ref, b = _buckets(x, y, nsch, max_capacity, fallback, monkeypatch)
    np.testing.assert_array_equal(b.table, b_ref.table)
    assert (b.n_dropped, b.nsch, b.x0, b.spacing_x) == \
        (b_ref.n_dropped, b_ref.nsch, b_ref.x0, b_ref.spacing_x)
    if max_capacity:
        assert b.n_dropped > 0


@pytest.mark.parametrize("nsch", [1, 3])
def test_gather_candidates_and_weights_match_reference(nsch):
    x, y, v, e = _network(1)
    gx, gy, gv = _gridpoints(1)
    b_ref, b = _buckets(x, y, nsch)
    cand_r = np.asarray(ref.gather_candidates(b_ref, jnp.asarray(gx),
                                              jnp.asarray(gy)))
    cand = port.gather_candidates(b, *map(torch.from_numpy, (gx, gy)),
                                  torch.from_numpy(b.table))
    np.testing.assert_array_equal(cand.numpy(), cand_r)
    assert cand.shape[-1] == port.candidate_width(b)
    for vs in (VS, 0.0):
        nd_r, rl_r, rd_r = (np.asarray(a) for a in ref.local_weights(
            jnp.asarray(cand_r), *(jnp.asarray(a) for a in (x, y, v, e, gx,
                                                            gy, gv)), HS, vs))
        nd, rl, rd = (a.numpy() for a in port.local_weights(
            cand, *map(torch.from_numpy, (x, y, v, e, gx, gy, gv)), HS, vs))
        np.testing.assert_allclose(nd, nd_r, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(rl, rl_r, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(rd, rd_r, rtol=1e-6)
        np.testing.assert_array_equal(rl > 0, rl_r > 0)


def _selected(idx, cand, score):
    """Per row: the selected obs as (score, idx) pairs in ascending order,
    the score read from the shared input arrays."""
    out = []
    for ir, cr, sr in zip(idx, cand, score):
        of = dict(zip(cr.tolist(), sr.tolist()))
        out.append(sorted((of[int(i)], int(i)) for i in ir if i >= 0))
    return out


@pytest.mark.parametrize("criterion", [1, 2, 3])
@pytest.mark.parametrize("max_nobs", [12, 40])
def test_limit_obs_topk_matches_reference(criterion, max_nobs):
    """Truncation is active (more obs within the cutoff than max_nobs) and
    the candidate width is ≥ 512, the reference analysis's own path."""
    x, y, v, e = _network(2, nobs=6000)
    gx, gy, gv = _gridpoints(2)
    b_ref, b = _buckets(x, y, 1)
    cand = port.gather_candidates(b, *map(torch.from_numpy, (gx, gy)),
                                  torch.from_numpy(b.table))
    assert cand.shape[-1] >= 512
    nd, rl, rd = port.local_weights(
        cand, *map(torch.from_numpy, (x, y, v, e, gx, gy, gv)), HS, VS)
    assert int((rl > 0).sum(-1).min()) > max_nobs       # truncation active
    jin = [jnp.asarray(a.numpy()) for a in (cand, nd, rl, rd)]
    outs_r = [ref.limit_obs_topk(*jin, max_nobs, criterion),
              ref.limit_obs_topk(*jin, max_nobs, criterion,
                                 obs_err=jnp.asarray(e))]
    idx, rloc, rdiag = (a.numpy() for a in port.limit_obs_topk(
        cand, nd, rl, rd, max_nobs, criterion))
    score = {1: nd, 2: -rl, 3: rd}[criterion].numpy()
    got = _selected(idx, cand.numpy(), score)
    for idx_r, rloc_r, rdiag_r in outs_r:
        idx_r, rloc_r, rdiag_r = (np.asarray(a) for a in
                                  (idx_r, rloc_r, rdiag_r))
        assert got == _selected(idx_r, cand.numpy(), score)
        # the same obs carry the same weights
        for row in range(idx.shape[0]):
            w = dict(zip(idx[row], zip(rloc[row], rdiag[row])))
            for i, r_l, r_d in zip(idx_r[row], rloc_r[row], rdiag_r[row]):
                if i >= 0:
                    np.testing.assert_allclose(w[i], (r_l, r_d), rtol=1e-6)
    assert idx.shape == (gx.shape[0], max_nobs)


def test_limit_obs_topk_pads_when_fewer_obs():
    ox = np.asarray([0.0, 1.0]); oy = np.asarray([0.0, 1.0])
    b = port.build_buckets(ox, oy, -10, -10, 10, 10, 100.0)
    t = torch.from_numpy
    z1 = torch.zeros(1, dtype=torch.float64)
    cand = port.gather_candidates(b, z1, z1, t(b.table))
    nd2, rloc, rdiag = port.local_weights(
        cand, t(ox), t(oy), torch.zeros(2, dtype=torch.float64),
        torch.ones(2, dtype=torch.float64), z1, z1, z1, 100.0, 0.0)
    idx, rloc_k, rdiag_k = port.limit_obs_topk(cand, nd2, rloc, rdiag, 50)
    assert idx.shape == (1, 50)
    assert int((idx[0] >= 0).sum()) == 2
    assert float(rloc_k[0][idx[0] < 0].max()) == 0.0
    assert float(rdiag_k[0][idx[0] < 0].min()) == 1.0


def test_gather_obs_data_matches_reference():
    rng = np.random.default_rng(4)
    dep = rng.standard_normal(50).astype(np.float32)
    ens = rng.standard_normal((50, 7)).astype(np.float32)
    idx = rng.integers(-1, 50, (9, 11)).astype(np.int32)
    d_r, h_r = ref.gather_obs_data(*(jnp.asarray(a) for a in (idx, dep, ens)))
    d, h = port.gather_obs_data(*map(torch.from_numpy, (idx, dep, ens)))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_r))
    d0, h0 = port.gather_obs_data(torch.from_numpy(idx),
                                  torch.zeros(0), torch.zeros((0, 7)))
    assert d0.shape == (9, 11) and h0.shape == (9, 11, 7)
    assert float(h0.abs().max()) == 0.0


def test_localization_matches_reference():
    nd2 = np.asarray([0.0, 1.0, 5.0, ref_loc.DIST_ZERO_FAC ** 2 * 0.999,
                      ref_loc.DIST_ZERO_FAC ** 2 * 1.01], np.float32)
    np.testing.assert_allclose(
        loc.gauss_taper(torch.from_numpy(nd2)).numpy(),
        np.asarray(ref_loc.gauss_taper(jnp.asarray(nd2))), rtol=1e-6)
    assert loc.DIST_ZERO_FAC == ref_loc.DIST_ZERO_FAC
    rng = np.random.default_rng(5)
    dx, dy, dv = (rng.standard_normal(20).astype(np.float32) * 1e4
                  for _ in range(3))
    for vs in (0.0, 500.0):
        np.testing.assert_allclose(
            loc.normalized_dist2(*map(torch.from_numpy, (dx, dy)), 3e4,
                                 torch.from_numpy(dv), vs).numpy(),
            np.asarray(ref_loc.normalized_dist2(
                jnp.asarray(dx), jnp.asarray(dy), 3e4, jnp.asarray(dv), vs)),
            rtol=1e-6)
