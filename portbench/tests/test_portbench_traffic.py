"""The traffic generator: bit for bit per seed, another order per seed,
the same work for every seed, and its lengths within their clips."""
from __future__ import annotations

import collections
import itertools

import numpy as np
import pytest

from portbench import spec, traffic

MIXES = [p.stem for p in sorted((spec.HERE / "traffic").glob("*.json"))]


def _take(mix, seed, seconds=40.0, n=300):
    if mix["process"] == "closed":
        return list(itertools.islice(traffic.closed_loop(mix, seed), n))
    return traffic.open_loop(mix, seed, seconds)


@pytest.mark.parametrize("name", MIXES)
def test_repeats_for_a_seed_and_differs_across_seeds(name):
    mix = spec.traffic(name)
    a, b = _take(mix, 2147483659), _take(mix, 2147483659)
    c = _take(mix, 2147483660)
    assert a == b
    assert a != c
    ids = traffic.prompt_ids(2147483659, 3, 100, 256000)
    assert np.array_equal(ids, traffic.prompt_ids(2147483659, 3, 100, 256000))
    assert not np.array_equal(ids, traffic.prompt_ids(2147483660, 3, 100,
                                                      256000))
    assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < 256000


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_work(name):
    mix = spec.traffic(name)
    if mix["process"] == "closed":
        n = int(mix["pool"])
        runs = [_take(mix, s, n=n) for s in (1, 2)]
    else:
        runs = [_take(mix, s) for s in (1, 2)]
        gaps = [np.diff([0.0] + [a.at_s for a in r]) for r in runs]
        assert sorted(gaps[0]) == pytest.approx(sorted(gaps[1]))
    sizes = [collections.Counter((a.tenant, a.prompt_len, a.max_new)
                                 for a in r) for r in runs]
    assert sizes[0] == sizes[1]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_their_clips_and_weights_kept(name):
    mix = spec.traffic(name)
    arr = _take(mix, 5, seconds=200.0, n=2000)
    p = np.array([a.prompt_len for a in arr])
    m = np.array([a.max_new for a in arr])
    for got, d in ((p, mix["prompt_len"]), (m, mix["max_new"])):
        assert got.min() >= d["min"] and got.max() <= d["max"]
        if d["dist"] == "lognormal":
            assert abs(np.median(got) / d["median"] - 1) < 0.15
    share = collections.Counter(a.tenant for a in arr)
    w = {t: v["weight"] for t, v in mix["tenants"].items()}
    for t, v in w.items():
        assert share[t] / len(arr) == pytest.approx(v / sum(w.values()),
                                                    abs=0.01)
    if mix["process"] == "poisson":
        assert len(arr) / 200.0 == pytest.approx(mix["rate_rps"], rel=0.1)
        at = [a.at_s for a in arr]
        assert at == sorted(at) and at[-1] < 200.0


def test_lognormal_clips_hold_at_the_tails():
    rng = np.random.default_rng(0)
    d = {"dist": "lognormal", "median": 100, "sigma": 3.0, "min": 50,
         "max": 120}
    x = traffic.draw_lengths(d, rng, 10000)
    assert x.min() == 50 and x.max() == 120
    with pytest.raises(ValueError):
        traffic.draw_lengths(dict(d, min=0), rng, 1)


def test_tenant_labels_follow_weights_exactly():
    labels = traffic.tenant_labels({"a": {"weight": 3}, "b": {"weight": 1}},
                                   10)
    assert collections.Counter(labels) == {"a": 8, "b": 2}


def test_bursty_times_are_sorted_within_the_window():
    t = traffic.mmpp_times(np.random.default_rng(1), 2.0, 50.0, 2.0, 0.5,
                           30.0)
    assert len(t) > 30 and np.all(np.diff(t) >= 0) and t[-1] < 30.0


@pytest.mark.parametrize("grows, knee", [
    ((False, False, True, False, True), 6.0),
    ((False, False, False, False, False), None),  # the top is no knee
    ((True, True), None),                          # sweep lower
])
def test_the_knee_is_the_rate_before_the_first_that_grows(grows, knee):
    from portbench import sweep
    rows = [{"rate_rps": 5.0 + i, "grows": g} for i, g in enumerate(grows)]
    assert sweep.knee_of(rows) == knee
