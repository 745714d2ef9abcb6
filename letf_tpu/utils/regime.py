"""Probabilistic stress-regime inference.

JAX rewrite of the reference logic (letf/utils.py:55-127): the
logistic stress score is fully vectorized; the EWMA smoothing and the
hysteresis state machine are ``lax.scan`` recurrences. NumPy variants are
provided for host-side calibration (identical math, f64).
"""

from __future__ import annotations

import numpy as np


def _prep_inputs_np(vix_series, realized_vol, term_spread):
    import pandas as pd

    vix = np.asarray(vix_series, dtype=float)
    n = len(vix)

    if realized_vol is None:
        rv = (pd.Series(vix).rolling(20, min_periods=5).std()
              .bfill().fillna(0).values / 100.0)
    else:
        rv = np.asarray(realized_vol, dtype=float)
        rv = pd.Series(rv).ffill().bfill().fillna(np.nanmedian(rv)).values

    if term_spread is None:
        ts = np.zeros(n)
    else:
        ts = np.asarray(term_spread, dtype=float)
        ts = pd.Series(ts).ffill().bfill().fillna(0.0).values
    return vix, rv, ts


def stress_logit(vix, rv, ts, xp=np):
    """Raw logistic stress score: higher VIX, higher realized vol, and a
    flatter/inverted curve imply higher stress probability."""
    logit = (-4.0
             + 0.22 * (xp.nan_to_num(vix, nan=20.0) - 20.0)
             + 6.5 * (xp.nan_to_num(rv, nan=0.18) - 0.18)
             + 0.10 * xp.clip(-ts, -5, 5))
    return 1.0 / (1.0 + xp.exp(-xp.clip(logit, -20, 20)))


def compute_high_vol_probability(vix_series, realized_vol=None, term_spread=None,
                                 smoothing: float = 0.94) -> np.ndarray:
    """P(high-vol regime) in [0.001, 0.999]: logistic score + EWMA smoothing."""
    vix, rv, ts = _prep_inputs_np(vix_series, realized_vol, term_spread)
    raw = stress_logit(vix, rv, ts)

    smoothed = np.zeros_like(raw)
    if len(raw) > 0:
        smoothed[0] = raw[0]
        for i in range(1, len(raw)):
            smoothed[i] = smoothing * smoothed[i - 1] + (1 - smoothing) * raw[i]
    return np.clip(smoothed, 0.001, 0.999)


def infer_regime_from_vix(vix_series, realized_vol=None, term_spread=None,
                          hysteresis: float = 0.08) -> np.ndarray:
    """Regime path from the smoothed stress probability with hysteresis
    thresholds (enter at 0.5 + h/2, exit at 0.5 - h/2)."""
    p_high = compute_high_vol_probability(vix_series, realized_vol, term_spread)
    enter_high = 0.50 + hysteresis / 2
    exit_high = 0.50 - hysteresis / 2

    regimes = np.zeros(len(p_high), dtype=int)
    if len(p_high) == 0:
        return regimes
    current = 1 if p_high[0] >= 0.50 else 0
    regimes[0] = current
    for i in range(1, len(p_high)):
        if current == 0 and p_high[i] >= enter_high:
            current = 1
        elif current == 1 and p_high[i] <= exit_high:
            current = 0
        regimes[i] = current
    return regimes


def infer_regime_from_vix_jax(vix, rv, ts, hysteresis: float = 0.08,
                              smoothing: float = 0.94):
    """Device-side regime inference: EWMA + hysteresis as one lax.scan.

    Inputs must be pre-cleaned (finite). Returns int32 regimes [T].
    """
    import jax.numpy as jnp
    from jax import lax

    raw = stress_logit(vix, rv, ts, xp=jnp)
    enter_high = 0.50 + hysteresis / 2
    exit_high = 0.50 - hysteresis / 2

    def step(carry, p):
        smoothed, current = carry
        smoothed = smoothing * smoothed + (1 - smoothing) * p
        current = jnp.where((current == 0) & (smoothed >= enter_high), 1,
                            jnp.where((current == 1) & (smoothed <= exit_high),
                                      0, current))
        return (smoothed, current), current

    init_current = jnp.where(raw[0] >= 0.50, 1, 0).astype(jnp.int32)
    (_, _), rest = lax.scan(step, (raw[0], init_current), raw[1:])
    return jnp.concatenate([init_current[None], rest])
