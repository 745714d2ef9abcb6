"""Buy-and-hold compounding tests (ops/buyhold.py)."""

import math

import jax
import numpy as np
import pytest

from letf_tpu.ops.buyhold import gbm_buyhold, gbm_percentile_report


def test_xla_twin_matches_lognormal_theory():
    """Zero-cost GBM: log wealth ~ Normal(T*E[log1p(L r)], ...). With small
    daily moves, E[log1p(Lr)] ~= L*mu - 0.5 L^2 sigma^2 (the vol-drag law)."""
    n, years = 32768, 5
    t_days = years * 252
    mu, sigma = 0.08 / 252, 0.20 / math.sqrt(252)
    w, mdd = gbm_buyhold(jax.random.key(0), n, t_days, mu, sigma,
                         leverage=3.0, daily_cost=0.0)
    logw = np.log(np.asarray(w))
    expected_mean = t_days * (3 * mu - 0.5 * 9 * sigma ** 2)
    expected_std = math.sqrt(t_days) * 3 * sigma
    assert logw.mean() == pytest.approx(expected_mean, abs=4 * expected_std / math.sqrt(n) + 0.02)
    assert logw.std() == pytest.approx(expected_std, rel=0.03)
    assert np.all(np.asarray(mdd) >= 0) and np.all(np.asarray(mdd) < 1)


def test_costs_reduce_wealth_monotonically():
    n, t_days = 8192, 504
    mu, sigma = 0.10 / 252, 0.24 / math.sqrt(252)
    w0, _ = gbm_buyhold(jax.random.key(1), n, t_days, mu, sigma, 3.0, 0.0)
    w1, _ = gbm_buyhold(jax.random.key(1), n, t_days, mu, sigma, 3.0,
                        0.02 / 252)
    # Same RNG stream: every path strictly cheaper with costs.
    assert bool((np.asarray(w1) < np.asarray(w0)).all())


def test_percentile_report_structure():
    rep = gbm_percentile_report(0, 4096, 2)
    assert set(rep["percentiles"].keys()) == {
        "p10", "p25", "p40", "p50", "p60", "p75", "p90"}
    # Percentiles monotone increasing.
    vals = [rep["percentiles"][f"p{p}"] for p in (10, 25, 40, 50, 60, 75, 90)]
    assert all(a <= b for a, b in zip(vals, vals[1:]))
    assert 0 <= rep["median_max_drawdown"] <= 1
