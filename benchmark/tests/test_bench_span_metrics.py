"""The readers of the program's spans inside the fused cycle on a hand-made
traced record: each gives its formula's value, and nothing when its span
is missing."""

import pytest

from benchmark import harness as H

SPANS = {"forecast": 34.6, "forecast/tendencies": 9.0,
         "forecast/acoustic": 16.0, "forecast/sponge": 0.6,
         "forecast/physics": 1.2, "state_trans": 0.1, "obsope": 1.4,
         "qc": 0.02, "das_letkf": 11.0, "das_letkf/select": 2.4,
         "das_letkf/gather": 0.8, "das_letkf/gram": 1.0,
         "das_letkf/solve": 6.2, "das_letkf/weights": 0.3,
         "das_letkf/apply": 0.2, "state_trans_inv": 0.1, "monitor": 0.05}
REC = {"units": 2, "plain_s": 48.0, "spans": SPANS}


def reader(name: str):
    return H.load_module(H.HERE / "metrics" / f"{name}.py",
                         f"bench_metric_{name}").read


@pytest.mark.parametrize("name,span", [("acoustic_s", "forecast/acoustic"),
                                       ("select_s", "das_letkf/select"),
                                       ("solve_s", "das_letkf/solve")])
def test_span_seconds_a_unit(name, span):
    read = reader(name)
    assert read(REC) == pytest.approx(SPANS[span] / 2)
    rest = {k: v for k, v in SPANS.items() if k != span}
    assert read({**REC, "spans": rest}) is None
    assert read({"units": 2, "plain_s": 48.0}) is None


def test_unspanned_share():
    read = reader("unspanned_share")
    top = (34.6 + 0.1 + 1.4 + 0.02 + 11.0 + 0.1 + 0.05)
    assert read(REC) == pytest.approx(100.0 * (1.0 - top / 48.0))
    # the child spans do not count: the parent's already holds them
    only_top = {k: v for k, v in SPANS.items() if "/" not in k}
    assert read({**REC, "spans": only_top}) == read(REC)
    assert read({**REC, "spans": {}}) is None
    assert read({"units": 2, "plain_s": 48.0}) is None
    assert read({**REC, "plain_s": 0.0}) is None
