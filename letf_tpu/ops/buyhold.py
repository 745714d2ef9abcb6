"""Buy-and-hold LETF compounding (the headline path).

BASELINE config #1 ("buy-and-hold 3x GBM, 10k trials x 30y, percentile
fan") and the 1M x 30y north-star run on device: a scan over days with a
[N] carry (log-wealth accumulator, running peak, max drawdown); only three
[N] result vectors leave the scan. Daily relation:
w += log1p(L*r - expense/252 - borrow_daily), i.e. the exact reference
compounding (engine.py:128-154 + utils.py:169-216) with volatility drag
emerging from geometric accumulation.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(
    jax.jit,
    static_argnames=("n_trials", "n_days", "mu", "sigma", "leverage",
                     "daily_cost"))
def gbm_buyhold(key, n_trials: int, n_days: int, mu: float, sigma: float,
                leverage: float = 3.0, daily_cost: float = 0.0):
    """[N] final wealth multiples and max drawdowns (float32) of Lx
    daily-rebalanced buy-and-hold over i.i.d. normal daily returns."""

    def step(carry, k):
        acc, peak, mdd = carry
        z = jax.random.normal(k, (n_trials,), jnp.float32)
        net = leverage * (mu + sigma * z) - daily_cost
        acc = acc + jnp.log1p(jnp.maximum(net, -0.999))
        peak = jnp.maximum(peak, acc)
        mdd = jnp.maximum(mdd, peak - acc)
        return (acc, peak, mdd), None

    keys = jax.random.split(key, n_days)
    zero = jnp.zeros(n_trials, jnp.float32)
    (acc, _, mdd), _ = jax.lax.scan(step, (zero, zero, zero), keys)
    return jnp.exp(acc), 1.0 - jnp.exp(-mdd)


def gbm_percentile_report(seed: int, n_trials: int, years: int,
                          annual_mu: float = 0.10, annual_sigma: float = 0.24,
                          leverage: float = 3.0, expense_ratio: float = 0.0086,
                          borrow_annual: float = 0.0):
    """BASELINE config #1/#2 headline: TQQQ-style buy-and-hold percentile
    fan. Returns a dict with wealth percentiles, CAGR percentiles, CVaR(5%),
    and median max drawdown — all reduced on device."""
    from letf_tpu.ops.reductions import PERCENTILES

    n_days = years * 252
    mu = annual_mu / 252.0
    sigma = annual_sigma / math.sqrt(252.0)
    daily_cost = expense_ratio / 252.0 + max(leverage - 1.0, 0.0) * borrow_annual / 252.0

    w, mdd = gbm_buyhold(jax.random.key(seed), n_trials, n_days,
                         mu, sigma, leverage, daily_cost)

    q = jnp.asarray(PERCENTILES)
    wp = jnp.percentile(w, q)
    n_tail = max(1, int(n_trials * 0.05))
    cvar = jnp.mean(jax.lax.top_k(-w, n_tail)[0]) * -1.0
    return {
        "percentiles": {f"p{int(p)}": float(v) for p, v in
                        zip(np.asarray(q), np.asarray(wp))},
        "cagr_percentiles": {f"p{int(p)}": float(v ** (1.0 / years) - 1.0)
                             for p, v in zip(np.asarray(q), np.asarray(wp))},
        "cvar_5pct_wealth": float(cvar),
        "median_max_drawdown": float(jnp.median(mdd)),
        "n_trials": n_trials,
        "years": years,
    }
