"""Long-horizon envelope.

The reference's TIME_HORIZONS include 40 and 50 years (letf/config.py:26)
and SURVEY §5 sizes the time axis at up to ~13.9k days (50y·252 + 5y
buffer), but every production artifact through round 4 stopped at 30y.
These tests prove the envelope on the CPU mesh: the static plans (spell
capacity, the offset window) hold at 50y, the full engine runs
end-to-end, and the tax bridge buckets 50 years. bench.py's long_horizon
stage times one 50y full-engine chunk on the GPU.
"""

import jax
import numpy as np
import pytest

from letf_tpu import config as cfg
from letf_tpu.models.params import default_sim_model


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


def test_horizon_menu_includes_40_and_50():
    # Reference parity surface: letf/config.py:26.
    assert 40 in cfg.TIME_HORIZONS and 50 in cfg.TIME_HORIZONS


def test_50y_plans_fit(model):
    """Static plans at the envelope: regime spell capacity, and the
    shift-select window at 50y·252 + 5y buffer (offsets up to the whole
    buffer, 11 shift levels) against NumPy slicing."""
    from letf_tpu.ops.path_batched import plan_max_spells, window_series

    S, buf = 50 * 252, 1260
    T = S + buf
    ms = plan_max_spells(model, T)
    # Bound must cover the days with the model's min dwell (>= 1 day) but
    # stay static-shape sane (spell scan length is the compile-time cost).
    assert 0 < ms <= T
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, T, 3))
    vix, irx = rng.random((2, T)), rng.random((2, T))
    regime = rng.integers(0, 2, (2, T)).astype(np.int32)
    offs = np.array([buf - 1, 777], np.int32)
    got = window_series(x, vix, irx, regime, offs, S)
    for g, a in zip(got, (x[..., 0], x[..., 1], x[..., 2], vix, irx,
                          regime)):
        want = np.stack([a[b, o:o + S] for b, o in enumerate(offs)])
        np.testing.assert_array_equal(np.asarray(g), want)


def test_50y_full_engine_chunk(model):
    """Full institutional engine at 50y on the CPU mesh: finite wealth,
    plausible compounding, validity flags populated."""
    from letf_tpu.parallel.mc_runner import run_monte_carlo

    n = 4
    arr = run_monte_carlo(model, 50, num_simulations=n, seed=11,
                          chunk_size=n, progress=False,
                          mesh=None)
    assert arr.final_wealth.shape == (n, 19)
    assert np.isfinite(arr.final_wealth).all()
    assert arr.sim_days == 50 * 252
    # SPY buy-and-hold over 50y must have compounded away from the start.
    spy = arr.final_wealth[:, cfg.STRATEGY_INDEX["S2"]]
    assert (spy > 0).all() and not np.allclose(spy, cfg.INITIAL_CAPITAL)
    assert arr.path_finite.all()


def test_50y_exact_tax_bridge(model):
    """Tax bridge + vectorized netting at n_years=50: the year bucketing,
    income path, and bracket inflation all stretch to the envelope."""
    from letf_tpu.reporting import exact_post_tax_all_trials

    out = exact_post_tax_all_trials(model, 50, 4, chunk_size=4, seed=11,
                                    strategy_ids=["S7"])
    e = out["S7"]
    assert e["n_trials"] == 4 and e["nonfinite_trials"] == 0
    assert np.isfinite(e["median_tax"])
    assert e["post_tax_p50"] <= e["pre_tax_p50"]
