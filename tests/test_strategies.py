"""Strategy layer tests: rolling ops vs pandas, the batched 19-strategy
device scan vs the pandas host oracle, and trade-journal emission parity."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from letf_tpu import config as cfg
from letf_tpu.models.params import default_sim_model
from letf_tpu.ops import rolling as rl
from letf_tpu.ops.path_engine import generate_paths_batch
from letf_tpu.strategies import host
from letf_tpu.strategies.engine import run_all
from letf_tpu.strategies.host import TradeJournal, trades_from_emission

warnings.filterwarnings("ignore")


# ---------------------------------------------------------------------------
# Rolling ops match pandas semantics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def series():
    rng = np.random.default_rng(7)
    return rng.normal(0, 0.02, 300)


def _cmp(dev, ref, atol=1e-10):
    dev = np.asarray(dev)
    ref = np.asarray(ref)
    assert np.array_equal(np.isnan(dev), np.isnan(ref)), "NaN mask mismatch"
    m = ~np.isnan(ref)
    np.testing.assert_allclose(dev[m], ref[m], atol=atol)


def test_rolling_mean_matches_pandas(series):
    s = pd.Series(series)
    _cmp(rl.rolling_mean(jnp.asarray(series), 20),
         s.rolling(20).mean().values)
    _cmp(rl.rolling_mean(jnp.asarray(series), 20, 1),
         s.rolling(20, min_periods=1).mean().values)


def test_rolling_std_matches_pandas(series):
    s = pd.Series(series)
    _cmp(rl.rolling_std(jnp.asarray(series), 20),
         s.rolling(20).std().values)
    _cmp(rl.rolling_std(jnp.asarray(series), 20, 1),
         s.rolling(20, min_periods=1).std().values)


def test_rolling_skew_matches_pandas(series):
    s = pd.Series(series)
    _cmp(rl.rolling_skew(jnp.asarray(series), 60, 1),
         s.rolling(60, min_periods=1).skew().values, atol=1e-8)


def test_rolling_sum_and_pct_change_match_pandas(series):
    s = pd.Series(series)
    _cmp(rl.rolling_sum(jnp.asarray(series), 126, 1),
         s.rolling(126, min_periods=1).sum().values)
    price = np.cumprod(1 + series) * 100
    _cmp(rl.pct_change(jnp.asarray(price), 5),
         pd.Series(price).pct_change(5).values)


def test_rsi_matches_pandas(series):
    price = np.cumprod(1 + series) * 100
    s = pd.Series(price)
    delta = s.diff()
    gain = delta.where(delta > 0, 0).rolling(14).mean()
    loss = (-delta.where(delta < 0, 0)).rolling(14).mean()
    ref = (100 - 100 / (1 + gain / loss)).values
    _cmp(rl.rsi(jnp.asarray(price), 14), ref, atol=1e-8)


# ---------------------------------------------------------------------------
# Device scan vs host oracle: all 19 strategies, multiple trials
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    model = default_sim_model()
    B, S = 3, 2 * 252
    path = generate_paths_batch(
        model, jax.random.key(0), jnp.arange(B, dtype=jnp.int32),
        jnp.zeros(B, bool), sim_days=S, buffer_days=504)
    res = run_all(path, emit_trades=True)
    return path, res


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_all_strategies_match_host_oracle(batch, trial):
    path, res = batch
    df = host.sim_df_from_path(path, trial)
    regime = np.asarray(path.regime[trial])
    dev_w = np.asarray(res.final_wealth[trial])
    dev_t = np.asarray(res.num_trades[trial])
    dev_dd = np.asarray(res.max_dd[trial])

    for k, sid in enumerate(cfg.STRATEGY_IDS):
        ec, nt = host.run_strategy_fixed(df, sid, regime)
        hw = float(ec.iloc[-1])
        hm = np.maximum.accumulate(ec.values)
        hdd = float(np.abs((ec.values - hm) / np.where(hm > 0, hm, 1)).max())
        assert dev_w[k] == pytest.approx(hw, rel=1e-9), sid
        assert int(dev_t[k]) == nt, sid
        assert dev_dd[k] == pytest.approx(hdd, abs=1e-10), sid


def test_trade_emission_matches_host_journal(batch):
    """Device journal emission replayed through TradeJournal must equal the
    host oracle's journal for taxable strategies."""
    path, res = batch
    trial = 0
    df = host.sim_df_from_path(path, trial)
    regime = np.asarray(path.regime[trial])
    tj_alloc = np.asarray(res.tj_alloc)
    tj_value = np.asarray(res.tj_value)
    tj_price = np.asarray(res.tj_price)
    tj_asset = np.asarray(res.tj_asset)

    for col, sid in enumerate(cfg.TAXABLE_IDS):
        journal = TradeJournal()
        host.run_strategy_fixed(df, sid, regime, trade_journal=journal)
        host_trades = journal.get_full_trades()
        dev_trades = trades_from_emission(tj_alloc, tj_value, tj_price,
                                          tj_asset, trial, col)
        assert len(dev_trades) == len(host_trades), sid
        for d, h in zip(dev_trades, host_trades):
            assert d["day_index"] == h["day_index"], sid
            assert d["asset"] == h["asset"], sid
            assert d["action"] == h["action"], sid
            # rel=1e-6: device rolling stats use cumsum-differences
            # (~1e-12 relative in f64), which Kelly-style share formulas
            # amplify to ~1e-9 on share counts.
            assert d["shares"] == pytest.approx(h["shares"], rel=1e-6), sid
            assert d["price"] == pytest.approx(h["price"], rel=1e-9), sid


def test_apply_costs_false_increases_wealth(batch):
    path, _ = batch
    res_nc = run_all(path, apply_costs=False)
    res_c = run_all(path, apply_costs=True)
    # High-turnover strategies must be strictly cheaper with costs on.
    s7 = cfg.STRATEGY_INDEX["S7"]
    assert bool(jnp.all(res_nc.final_wealth[:, s7] > res_c.final_wealth[:, s7]))


# ---------------------------------------------------------------------------
# Cashflow overlays (DCA / withdrawals)
# ---------------------------------------------------------------------------

def test_dca_and_withdrawal_overlays(batch):
    import numpy as np
    from letf_tpu.strategies.engine import (
        dca_schedule, run_all, withdrawal_schedule)

    path, base = batch
    S = path.etf_ret.shape[1]
    dca = run_all(path, cashflows=dca_schedule(S, 500.0))
    wd = run_all(path, cashflows=withdrawal_schedule(S, 6000.0))

    # Contributions strictly raise final wealth; withdrawals strictly lower
    # (no strategy hits the zero floor on these paths).
    assert bool(jnp.all(dca.final_wealth > base.final_wealth))
    assert bool(jnp.all(wd.final_wealth <= base.final_wealth))
    assert bool(jnp.all(wd.final_wealth >= 0.0))


def test_withdrawal_ruin_floors_at_zero(batch):
    from letf_tpu.strategies.engine import run_all, withdrawal_schedule

    path, _ = batch
    S = path.etf_ret.shape[1]
    # Absurd withdrawal rate forces ruin; equity must floor at 0, not go
    # negative.
    wd = run_all(path, cashflows=withdrawal_schedule(S, 1e6))
    assert bool(jnp.all(wd.final_wealth >= 0.0))
    assert bool(jnp.any(wd.final_wealth == 0.0))
