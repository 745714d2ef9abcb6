"""Rolling-window statistics with pandas-equivalent semantics, on device.

The reference strategies consume pandas ``rolling`` aggregates
(letf/strategy.py throughout): mean/std(ddof=1)/skew/sum over 5-200 day
windows, with ``min_periods`` warmup NaNs and ``.shift(1)`` lags. Here each
window aggregate is computed from causal windowed raw-moment sums via
cumsum differences — O(T), batched over the trial axis.

All functions take the time axis as a parameter (default -1).

NaN is used for warmup exactly like pandas; strategy code masks with
``jnp.isnan`` where the reference uses ``pd.isna``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _ax(x, axis):
    return axis if axis >= 0 else x.ndim + axis


def _slice_ax(x, axis, start, stop):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop)
    return x[tuple(idx)]


def _causal_window_sum(x: jax.Array, window: int, axis: int = -1) -> jax.Array:
    """Sum over the trailing window [t-w+1, t] along `axis`.

    Cumsum-difference (O(T)) instead of lax.reduce_window (O(T*w)): the
    200-day windows made signals a top-3 cost in the production engine.
    Precision: the difference of two prefix sums loses ~eps * |csum|/|wsum|
    relative accuracy — bounded by ~(T/w) here, i.e. ~1e-6 in f32
    production signals and ~1e-14 in the f64 parity suite, both far inside
    the comparison tolerances."""
    axis = _ax(x, axis)
    T = x.shape[axis]
    if window >= T:
        return jnp.cumsum(x, axis=axis)
    c = jnp.cumsum(x, axis=axis)
    lagged = jnp.concatenate(
        [jnp.zeros_like(_slice_ax(c, axis, 0, window)),
         _slice_ax(c, axis, 0, T - window)], axis=axis)
    return c - lagged


def _counts(x: jax.Array, window: int, axis: int) -> jax.Array:
    """Per-step in-window counts, broadcast-shaped along `axis`."""
    axis = _ax(x, axis)
    T = x.shape[axis]
    t = jnp.arange(T)
    n = jnp.minimum(t + 1, window).astype(x.dtype)
    shape = [1] * x.ndim
    shape[axis] = T
    return n.reshape(shape)


def rolling_sum(x: jax.Array, window: int, min_periods: int = 1,
                axis: int = -1) -> jax.Array:
    s = _causal_window_sum(x, window, axis)
    n = _counts(x, window, axis)
    return jnp.where(n >= min_periods, s, jnp.nan)


def rolling_mean(x: jax.Array, window: int, min_periods: int | None = None,
                 axis: int = -1) -> jax.Array:
    if min_periods is None:
        min_periods = window
    s = _causal_window_sum(x, window, axis)
    n = _counts(x, window, axis)
    return jnp.where(n >= min_periods, s / n, jnp.nan)


def rolling_std(x: jax.Array, window: int, min_periods: int | None = None,
                axis: int = -1) -> jax.Array:
    """Sample std (ddof=1), NaN where count < max(min_periods, 2)."""
    if min_periods is None:
        min_periods = window
    s1 = _causal_window_sum(x, window, axis)
    s2 = _causal_window_sum(x * x, window, axis)
    n = _counts(x, window, axis)
    mean = s1 / n
    var = jnp.maximum(s2 - n * mean * mean, 0.0) / jnp.maximum(n - 1, 1)
    ok = (n >= min_periods) & (n >= 2)
    return jnp.where(ok, jnp.sqrt(var), jnp.nan)


def rolling_skew(x: jax.Array, window: int, min_periods: int | None = None,
                 axis: int = -1) -> jax.Array:
    """Adjusted Fisher-Pearson skew (pandas formula):
    g = n/((n-1)(n-2)) * sum((x-mean)^3) / s^3,  NaN for n < 3."""
    if min_periods is None:
        min_periods = window
    s1 = _causal_window_sum(x, window, axis)
    s2 = _causal_window_sum(x * x, window, axis)
    s3 = _causal_window_sum(x * x * x, window, axis)
    n = _counts(x, window, axis)
    mean = s1 / n
    m2 = jnp.maximum(s2 - n * mean ** 2, 0.0)
    m3 = s3 - 3.0 * mean * s2 + 2.0 * n * mean ** 3
    var = m2 / jnp.maximum(n - 1, 1)
    s = jnp.sqrt(var)
    denom = jnp.maximum(n - 1, 1) * jnp.maximum(n - 2, 1) * s ** 3
    g = n * m3 / jnp.where(denom > 0, denom, jnp.nan)
    ok = (n >= min_periods) & (n >= 3) & (s > 0)
    return jnp.where(ok, g, jnp.nan)


def shift1(x: jax.Array, axis: int = -1) -> jax.Array:
    """pandas .shift(1) along `axis` (NaN at t=0)."""
    axis = _ax(x, axis)
    pad_shape = list(x.shape)
    pad_shape[axis] = 1
    pad = jnp.full(pad_shape, jnp.nan, x.dtype)
    return jnp.concatenate([pad, _slice_ax(x, axis, 0, x.shape[axis] - 1)],
                           axis=axis)


def pct_change(x: jax.Array, periods: int, axis: int = -1) -> jax.Array:
    """pandas .pct_change(periods) along `axis`."""
    axis = _ax(x, axis)
    pad_shape = list(x.shape)
    pad_shape[axis] = periods
    prev = jnp.concatenate(
        [jnp.full(pad_shape, jnp.nan, x.dtype),
         _slice_ax(x, axis, 0, x.shape[axis] - periods)], axis=axis)
    return x / prev - 1.0


def rsi(price: jax.Array, period: int = 14, axis: int = -1) -> jax.Array:
    """Simple-moving-average RSI on price diffs (strategy.py:321-325).

    pandas quirk preserved: ``delta.where(delta > 0, 0)`` converts the t=0
    NaN diff to 0, so the gain/loss series are NaN-free and the first valid
    RSI lands at t = period - 1 (window covering days 0..period-1)."""
    axis = _ax(price, axis)
    first = _slice_ax(price, axis, 0, 1)
    delta = price - jnp.concatenate(
        [first, _slice_ax(price, axis, 0, price.shape[axis] - 1)], axis=axis)
    gain = rolling_mean(jnp.where(delta > 0, delta, 0.0), period, axis=axis)
    loss = rolling_mean(jnp.where(delta < 0, -delta, 0.0), period, axis=axis)
    rs = gain / loss
    return 100.0 - 100.0 / (1.0 + rs)


def cummax(x: jax.Array, axis: int = -1) -> jax.Array:
    return lax.cummax(x, axis=axis if axis >= 0 else x.ndim + axis)


def max_drawdown(equity: jax.Array, axis: int = -1) -> jax.Array:
    """max peak-to-trough drawdown of an equity curve (positive fraction)."""
    running = cummax(equity, axis)
    dd = (equity - running) / jnp.where(running > 0, running, 1.0)
    return jnp.abs(jnp.min(dd, axis=axis))
