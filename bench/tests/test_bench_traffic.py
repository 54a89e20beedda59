"""Seeded traffic: the same seed gives the same requests, every seed the
same sizes at the same clients, and the sizes are the mix's quantiles."""
import numpy as np
import pytest

from bench import clients

MIXES = ("azure-conv", "azure-code")
BIG = 2**31 + 12345


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = clients.load_mix(name)
    a, b = clients.plan(mix, 50272, BIG), clients.plan(mix, 50272, BIG)
    for ca, cb in zip(a, b, strict=True):
        for ra, rb in zip(ca, cb, strict=True):
            assert ra.budget == rb.budget
            np.testing.assert_array_equal(ra.prompt, rb.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_work(name):
    """Another seed draws other token ids for the same sizes, sent by the
    same clients in the same order."""
    mix = clients.load_mix(name)
    a, b = clients.plan(mix, 50272, BIG), clients.plan(mix, 50272, 7)
    for ca, cb in zip(a, b, strict=True):
        assert [(len(r.prompt), r.budget) for r in ca] == [(len(r.prompt), r.budget) for r in cb]
    assert not np.array_equal(a[0][0].prompt, b[0][0].prompt)
    # within a wave the sizes are dealt out of order, not sorted by client
    wave = [len(c[1].prompt) for c in a]
    assert wave != sorted(wave)


@pytest.mark.parametrize("name", MIXES)
def test_sizes_within_the_mix(name):
    mix = clients.load_mix(name)
    plans = clients.plan(mix, 50272, BIG)
    pr, out = mix["prompt"], mix["output"]
    n = mix["clients"] * mix["requests_per_client"]
    assert sorted(len(r.prompt) for c in plans for r in c) == sorted(
        clients.quantile_lengths(pr, n))
    assert sorted(c[0].budget for c in plans) == clients.residual_budgets(
        clients.quantile_lengths(out, n), mix["clients"])
    # the source's medians
    assert np.median([len(r.prompt) for c in plans for r in c]) == pytest.approx(pr["median"], abs=1)
    assert np.median([r.budget for c in plans for r in c[1:]]) == pytest.approx(out["median"], abs=1)
    for c in plans:
        for r in c:
            assert pr["min"] <= len(r.prompt) <= pr["max"]
            assert r.prompt.dtype == np.int32
            assert r.prompt.min() >= mix["first_token_id"] and r.prompt.max() < 50272
            assert len(r.prompt) + r.budget < mix["max_len"]
        assert all(out["min"] <= r.budget <= out["max"] for r in c[1:])
    # each wave spans the distribution
    for k in range(mix["requests_per_client"]):
        wave = sorted(len(c[k].prompt) for c in plans)
        assert wave[0] < pr["median"] < wave[-1]


def test_quantile_lengths_by_hand():
    got = clients.quantile_lengths({"median": 100, "sigma": 1.0, "min": 1, "max": 1000}, 4)
    # exp(ln 100 + z) at z = -1.1503, -0.3186, 0.3186, 1.1503
    assert list(got) == [32, 73, 138, 316]
    clipped = clients.quantile_lengths({"median": 100, "sigma": 1.0, "min": 50, "max": 200}, 4)
    assert list(clipped) == [50, 73, 138, 200]


def test_residual_budgets_are_renewal_quantiles():
    # outputs all of length 10: r is uniform over 1..10
    assert clients.residual_budgets(np.full(40, 10), 5) == [2, 3, 5, 7, 9]
    # outputs 4 and 12 alike: P(r) is twice as high at r <= 4 as above
    r = clients.residual_budgets(np.array([4, 12] * 10), 8)
    assert r == sorted(r) and r[-1] <= 12 and sum(x <= 4 for x in r) == 4
