"""The port's own copies of the reference's jax-free modules agree with
them: configuration, physical constants, observation types and the native
bucket sort (scale_letkf_torch/{config,constants,obs/types,utils/native}.py
against their scale_letkf_tpu counterparts)."""

import dataclasses
import tomllib
from pathlib import Path

import numpy as np
import pytest

from scale_letkf_tpu import config as ref_config
from scale_letkf_tpu import constants as ref_constants
from scale_letkf_tpu.obs import types as ref_types
from scale_letkf_tpu.ops import obs_select as ref_select
from scale_letkf_tpu.utils import native as ref_native
from scale_letkf_torch import config, constants
from scale_letkf_torch.obs import types
from scale_letkf_torch.ops import obs_select
from scale_letkf_torch.utils import native

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SHIPPED = ("18km_japan.toml", "bda_1km_radar.toml")


def _sections(name):
    """The TOML's Config sections ([domain], [nest] and [physics] are read
    by the experiment loader, not by Config)."""
    with open(CONFIGS / name, "rb") as f:
        raw = tomllib.load(f)
    for key in ("domain", "nest", "physics"):
        raw.pop(key, None)
    return raw


@pytest.mark.parametrize("name", SHIPPED)
def test_config_from_dict_matches_reference(name):
    raw = _sections(name)
    assert dataclasses.asdict(config.Config.from_dict(raw)) == \
        dataclasses.asdict(ref_config.Config.from_dict(raw))


def test_config_defaults_and_errors_match_reference():
    assert dataclasses.asdict(config.Config()) == \
        dataclasses.asdict(ref_config.Config())
    assert (config.NOBTYPE, config.NID_OBS) == \
        (ref_config.NOBTYPE, ref_config.NID_OBS)
    for bad in ({"letkf": {"no_such_key": 1}}, {"no_such_section": {}}):
        with pytest.raises(ValueError):
            config.Config.from_dict(bad)


def test_config_from_toml_reads_a_plain_config(tmp_path):
    path = tmp_path / "c.toml"
    path.write_text("[ensemble]\nmember = 7\n[letkf]\ninfl_mul = 1.1\n"
                    "relax_alpha = 0.5\n")
    cfg, cfg_r = (m.Config.from_toml(str(path)) for m in (config, ref_config))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_r)
    assert cfg.ensemble.member == 7 and cfg.letkf.gross_thresh("rain") == 5.0


def test_constants_match_reference():
    names = [n for n in vars(constants) if n.isupper()]
    assert {"RE", "GRAV", "D2R", "R2D", "RD", "RV", "CVDRY", "PRE00",
            "TRACER_CV"} <= set(names)
    for n in names:
        np.testing.assert_array_equal(getattr(constants, n),
                                      getattr(ref_constants, n), err_msg=n)


def test_obs_types_match_reference():
    names = [n for n in vars(types) if n.isupper()]
    assert len(names) > 20
    for n in names:
        assert getattr(types, n) == getattr(ref_types, n), n
    elem = np.asarray(types.ELEM_UID + (1, 0))
    np.testing.assert_array_equal(types.uid_obs(elem), ref_types.uid_obs(elem))
    np.testing.assert_array_equal(types.uid_obs_varlocal(elem),
                                  ref_types.uid_obs_varlocal(elem))
    fields = [f.name for f in dataclasses.fields(types.Observations)]
    assert fields == [f.name for f in dataclasses.fields(
        ref_types.Observations)]


def test_observations_behave_like_reference():
    rng = np.random.default_rng(0)
    n = 50
    arrays = dict(elem=rng.choice(types.ELEM_UID, n), lon=rng.uniform(size=n),
                  lat=rng.uniform(size=n), lev=rng.uniform(size=n),
                  dat=rng.uniform(size=n), err=rng.uniform(size=n),
                  typ=rng.integers(0, types.NOBTYPE, n), dif=np.zeros(n))
    obs, obs_r = types.Observations(**arrays), ref_types.Observations(**arrays)
    mask = rng.uniform(size=n) < 0.5
    for a, b in ((obs, obs_r), (obs.select(mask), obs_r.select(mask)),
                 (types.Observations.concatenate([obs, obs.select(mask)]),
                  ref_types.Observations.concatenate([obs_r,
                                                      obs_r.select(mask)]))):
        assert a.nobs == b.nobs
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    assert types.Observations.empty().nobs == 0


@pytest.mark.parametrize("nsch,max_capacity", [(1, 0), (3, 8)])
def test_build_buckets_through_both_native_loaders(nsch, max_capacity):
    """The port's loader binds the same library as the reference's, and the
    port's build_buckets gives the reference's table through it."""
    assert (native.load() is None) == (ref_native.load() is None)
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 4.0e5, 2000)
    y = rng.uniform(0.0, 4.0e5, 2000)
    x[:30], y[:30] = 1.2e5, 2.4e5
    args = (x, y, 0.0, 0.0, 4.0e5, 4.0e5, 6.0e4 / nsch)
    kw = dict(max_capacity=max_capacity, nsch=nsch)
    b = obs_select.build_buckets(*args, **kw)
    b_r = ref_select.build_buckets(*args, **kw)
    np.testing.assert_array_equal(b.table, b_r.table)
    assert b.n_dropped == b_r.n_dropped
    assert obs_select.bucket_sort_backend() == (
        "native" if ref_native.load() is not None else "numpy")
