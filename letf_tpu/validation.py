"""Validation battery: mathematical invariants + structural sanity checks.

Parity surface (letf/validation.py:18-392):
- validate_zero_drift_vol_drag: 10k zero-drift paths; a 3x LETF must realize
  -0.5 L^2 sigma^2 median annual drag within 1.5% absolute
- validate_flat_market_decay: 2x/3x decay vs theory within 2% over 5k paths
- run_institutional_sanity_checks: transition-matrix properties, RNG-stream
  uniqueness, tracking-model bounds, funding feature-activation probes
- run_rolling_oos_calibration_backtest: rolling train/test calibration drift
- run_validation_tests: orchestrates + writes JSON

The Monte Carlo invariants run fully vectorized on device (one jit, no
Python loops) — the device restatement of the reference's NumPy loops.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from letf_tpu import config as cfg


def _neutral_model(leverage: float):
    """default_sim_model with every cost/stress/TE channel zeroed and all
    assets at `leverage` — the clean zero-drift invariant configuration."""
    from letf_tpu.models.params import default_sim_model

    model = default_sim_model()
    A = model.assets
    zero = np.zeros_like(np.asarray(A.expense_ratio, np.float64))
    st, fu, tr = model.stress, model.funding, model.tracking
    return model._replace(
        assets=A._replace(leverage=np.full_like(zero, leverage),
                          expense_ratio=zero, fallback_spread=zero,
                          beta=np.ones_like(zero)),
        stress=jax.tree.map(np.zeros_like, st),
        funding=jax.tree.map(np.zeros_like, fu),
        tracking=tr._replace(rho=np.zeros_like(tr.rho),
                             te_scale=np.zeros_like(tr.te_scale),
                             clip_limit=np.zeros_like(tr.clip_limit)),
        cash_rate=np.zeros_like(np.asarray(model.cash_rate, np.float64)))


def _engine_zero_drift_median(key, leverage: float, daily_std: float,
                              n_sims: int, n_days: int):
    """Median annual compound return of Lx zero-drift paths, driven through
    the SHIPPED cost/compounding path (compose_letf_returns,
    ops/path_engine.py) with zero expense/borrow, so the invariant fails
    if anyone breaks the engine's leverage/financing math (reference
    validation.py:18-87). Returns (median, engine_name)."""
    from letf_tpu.ops.path_engine import _to_device, compose_letf_returns

    model = _neutral_model(leverage)

    @functools.partial(jax.jit, static_argnames=("n_sims", "n_days"))
    def run(key, n_sims: int, n_days: int):
        m = _to_device(model)
        z = jax.random.normal(key, (n_sims, n_days)) * daily_std
        underlying = jnp.broadcast_to(z[..., None],
                                      z.shape + (cfg.N_ASSETS,))
        rf = jnp.zeros(n_days, z.dtype)
        etf = jax.vmap(lambda u: compose_letf_returns(m, u, rf, None))(
            underlying)
        logw = jnp.sum(jnp.log1p(etf[..., 0]), axis=1)
        return jnp.median(jnp.expm1(logw))

    return float(run(key, n_sims, n_days)), "compose_letf_returns"


def _buyhold_engine_median(seed: int, leverage: float, daily_std: float,
                           n_sims: int, n_days: int):
    """Median compound return through the shipped buy-and-hold engine
    (ops/buyhold.py). Returns (median, engine)."""
    from letf_tpu.ops.buyhold import gbm_buyhold

    w, _ = gbm_buyhold(jax.random.key(seed), n_sims, n_days, mu=0.0,
                       sigma=float(daily_std),   # np scalar would
                       leverage=float(leverage),  # promote the f32 carry
                       daily_cost=0.0)
    return float(jnp.median(w) - 1.0), "gbm_buyhold"


def validate_zero_drift_vol_drag(n_sims: int = 10_000, seed: int = 42) -> Dict:
    """CRITICAL: with zero drift and vol sigma, an Lx daily-rebalanced LETF
    realizes -0.5 L^2 sigma^2 annually via geometric compounding."""
    annual_vol = 0.15
    daily_std = annual_vol / np.sqrt(252)
    leverage = 3.0
    n_days = 252

    print(f"\n{'=' * 80}")
    print("VALIDATION: ZERO-DRIFT VOLATILITY DRAG "
          f"({n_sims:,} paths x {n_days}d, {leverage}x, vol {annual_vol:.0%})")
    print(f"{'=' * 80}")

    actual, engine = _engine_zero_drift_median(
        jax.random.key(seed), leverage, daily_std, n_sims, n_days)
    expected = -0.5 * leverage ** 2 * annual_vol ** 2
    err = abs(actual - expected)
    passed = err < 0.015

    print(f"  expected {expected * 100:+.2f}%  simulated {actual * 100:+.2f}%"
          f"  error {err * 100:.2f}%  [{engine}] "
          f"-> {'PASSED' if passed else 'FAILED'}")
    return {"test_passed": bool(passed), "expected_drag": expected,
            "actual_drag": actual, "error_pct": err * 100, "engine": engine}


def validate_flat_market_decay(n_sims: int = 5_000, seed: int = 42) -> Dict:
    """2x and 3x decay in a flat 15%-vol market vs -0.5 L^2 sigma^2."""
    annual_vol = 0.15
    daily_std = annual_vol / np.sqrt(252)
    n_days = 252

    print(f"\n{'=' * 80}")
    print(f"VALIDATION: FLAT MARKET DECAY ({n_sims:,} paths x {n_days}d)")
    print(f"{'=' * 80}")

    results: Dict[str, Dict] = {}
    all_passed = True
    for leverage in (2.0, 3.0):
        actual, engine = _buyhold_engine_median(
            seed + int(leverage), leverage, daily_std, n_sims, n_days)
        expected = -0.5 * leverage ** 2 * annual_vol ** 2
        err = abs(actual - expected)
        passed = err < 0.02
        all_passed &= passed
        print(f"  {leverage}x: expected {expected * 100:+.2f}% "
              f"simulated {actual * 100:+.2f}% error {err * 100:.2f}% "
              f"[{engine}] -> {'PASSED' if passed else 'FAILED'}")
        results[f"{leverage}x"] = {
            "expected": expected, "actual_median": actual,
            "error": err, "passed": bool(passed), "engine": engine}
    results["all_passed"] = bool(all_passed)
    return results


def run_institutional_sanity_checks(regime_model: Dict, funding_model: Dict,
                                    tracking_residual_model: Dict) -> Dict:
    """Deterministic structural checks (validation.py:191-261):
    transition-matrix hygiene, RNG-stream uniqueness (the counter-based
    analogue of the reference's seed-collision check), tracking parameter
    bounds, and funding-model feature activation."""
    from letf_tpu.models.params import build_sim_model
    from letf_tpu.ops import rng as rngs
    from letf_tpu.ops.path_engine import borrow_spread_series, _to_device

    checks = {
        "transition_matrix_finite": False,
        "transition_matrix_row_stochastic": False,
        "transition_matrix_nonnegative": False,
        "te_seed_collision_free": False,
        "tracking_model_params_valid": False,
        "funding_vix_activates": False,
        "funding_inv_curve_activates": False,
        "funding_liquidity_activates": False,
        "funding_credit_activates": False,
        "all_passed": False,
    }

    tm = np.asarray(regime_model.get("transition_matrix", np.array([])), float)
    if tm.size > 0:
        checks["transition_matrix_finite"] = bool(np.isfinite(tm).all())
        checks["transition_matrix_row_stochastic"] = bool(
            np.allclose(tm.sum(axis=1), 1.0, atol=1e-6))
        checks["transition_matrix_nonnegative"] = bool((tm >= -1e-12).all())

    # Counter-based streams: per-trial keys and per-stream folds must be
    # pairwise distinct (replaces _stable_asset_seed collision check).
    key = jax.random.key(12345)
    keys = [tuple(np.asarray(jax.random.key_data(rngs.stream(
        rngs.trial_key(key, t), s))).ravel())
        for t in range(4) for s in range(10)]
    checks["te_seed_collision_free"] = len(keys) == len(set(keys))

    te_ok = True
    for _, p in (tracking_residual_model or {}).items():
        rho = float(p.get("rho", np.nan))
        scale = float(p.get("base_scale", np.nan))
        dfv = float(p.get("df", np.nan))
        if not (np.isfinite(rho) and 0.0 <= rho <= 0.9):
            te_ok = False
        if not (np.isfinite(scale) and scale > 0):
            te_ok = False
        if not (np.isfinite(dfv) and dfv > 2.0):
            te_ok = False
    checks["tracking_model_params_valid"] = te_ok

    # Funding feature activation probes on the device spread function.
    model = _to_device(build_sim_model({"funding_model": funding_model}))
    n = 10
    base_vix = jnp.full(n, 20.0)
    rf = jnp.full(n, 0.04)
    zeros = jnp.zeros(n)

    def mean_spread(vix, liq, cred):
        return float(jnp.nanmean(
            borrow_spread_series(model, vix, rf, liq, cred)))

    base = mean_spread(base_vix, zeros, zeros)
    checks["funding_vix_activates"] = mean_spread(
        jnp.full(n, 45.0), zeros, zeros) > base
    # Inverted curve is driven by credit stress in-sim (term = 1.25-1.1*cred);
    # credit > 1.14 flips the curve, activating both channels.
    checks["funding_inv_curve_activates"] = mean_spread(
        base_vix, zeros, jnp.full(n, 2.0)) > base
    checks["funding_liquidity_activates"] = mean_spread(
        base_vix, jnp.full(n, 2.5), zeros) > base
    checks["funding_credit_activates"] = mean_spread(
        base_vix, zeros, jnp.full(n, 2.5)) > base

    checks["all_passed"] = all(v for k, v in checks.items() if k != "all_passed")
    return checks


def run_rolling_oos_calibration_backtest(df, n_splits: int = 3,
                                         train_years: int = 8,
                                         test_years: int = 2) -> Dict:
    """Rolling out-of-sample calibration drift (validation.py:264-332):
    funding-model MAE and tracking residual std on held-out windows."""
    import pandas as pd
    from letf_tpu.calibration import (
        calibrate_funding_spread_model,
        calibrate_tracking_residual_model,
        predict_borrow_spread_series,
    )

    window_train = int(train_years * 252)
    window_test = int(test_years * 252)
    total_needed = window_train + window_test

    out = {
        "splits_run": 0,
        "funding_mae_mean": float("nan"),
        "tracking_residual_std_mean": float("nan"),
        "funding_beta_vix_drift": float("nan"),
        "sufficient_data": False,
    }
    if df is None or len(df) < total_needed + 252:
        return out

    starts = np.linspace(0, len(df) - total_needed, n_splits, dtype=int)
    maes, rstds, betas = [], [], []
    for start in starts:
        train_df = df.iloc[start:start + window_train].copy()
        test_df = df.iloc[start + window_train:start + total_needed].copy()
        if len(train_df) < window_train or len(test_df) < window_test:
            continue
        funding = calibrate_funding_spread_model(train_df, bypass_cache=True)
        calibrate_tracking_residual_model(train_df, funding_model=funding,
                                          bypass_cache=True)
        betas.append(float(funding.get("beta_vix", np.nan)))

        spread_input = pd.DataFrame(
            {"VIX": test_df["VIX"].values,
             "IRX": test_df.get("IRX", pd.Series(4.5, index=test_df.index)).values},
            index=test_df.index)
        if "TNX" in test_df.columns:
            spread_input["TNX"] = test_df["TNX"].values
        test_spread = predict_borrow_spread_series(spread_input, funding)
        maes.append(float(np.nanmean(np.abs(test_spread - funding["base"]))))

        split_stds = []
        for asset in ("TQQQ", "UPRO", "SSO"):
            col = f"{asset}_Real_Ret"
            if col not in test_df.columns:
                continue
            idx = (test_df["QQQ_Ret"] if (asset == "TQQQ"
                                          and "QQQ_Ret" in test_df.columns)
                   else test_df["SPY_Ret"])
            lev = cfg.ASSETS[asset].leverage
            rf = test_df.get("IRX", pd.Series(4.5, index=test_df.index)) \
                .fillna(4.5).values / 100.0
            finance = (lev - 1.0) * (rf + test_spread) / 252.0
            expected = (lev * idx.values - finance
                        - cfg.ASSETS[asset].expense_ratio / 252.0)
            resid = test_df[col].values - expected
            resid = resid[np.isfinite(resid)]
            if len(resid) > 20:
                split_stds.append(float(np.nanstd(resid)))
        if split_stds:
            rstds.append(float(np.nanmean(split_stds)))

    if maes:
        out["splits_run"] = len(maes)
        out["funding_mae_mean"] = float(np.nanmean(maes))
        out["tracking_residual_std_mean"] = (float(np.nanmean(rstds))
                                             if rstds else float("nan"))
        if len(betas) >= 2:
            out["funding_beta_vix_drift"] = float(np.nanmax(betas)
                                                  - np.nanmin(betas))
        out["sufficient_data"] = True
    return out


def run_validation_tests(df=None, regime_model: Optional[Dict] = None) -> Dict:
    """Run the full battery and save JSON (validation.py:335-392)."""
    print(f"\n{'=' * 80}")
    print("RUNNING VALIDATION TESTS")
    print(f"{'=' * 80}")

    results = {
        "zero_drift_test": validate_zero_drift_vol_drag(),
        "flat_market_test": validate_flat_market_decay(),
    }
    if regime_model is not None:
        results["institutional_sanity"] = run_institutional_sanity_checks(
            regime_model=regime_model,
            funding_model=regime_model.get("funding_model", {}),
            tracking_residual_model=regime_model.get(
                "tracking_residual_model", {}))
    if df is not None:
        results["rolling_oos"] = run_rolling_oos_calibration_backtest(df)

    cfg.init_cache()
    with open(cfg.VALIDATION_RESULTS, "w") as f:
        json.dump(results, f, indent=2, default=float)

    passed = results["zero_drift_test"]["test_passed"]
    print(f"\n  Zero-drift vol drag: {'PASSED' if passed else 'FAILED'}")
    if "institutional_sanity" in results:
        ok = results["institutional_sanity"].get("all_passed", False)
        print(f"  Institutional sanity: {'PASSED' if ok else 'FAILED'}")
    if "rolling_oos" in results:
        oos = results["rolling_oos"]
        if oos.get("sufficient_data"):
            print(f"  Rolling OOS: splits={oos['splits_run']}, "
                  f"funding MAE={oos['funding_mae_mean']:.6f}")
        else:
            print("  Rolling OOS: skipped (insufficient data)")
    return results
