"""Device-side fitting primitives for the calibration layer.

The reference computes every calibration fit with pandas/NumPy host loops
(letf/calibration.py). Here the fits themselves are jitted JAX reductions
and linear algebra over fixed-shape masked arrays — the covariate
construction stays host-side (one-time data prep), but medians,
percentiles, AR(1) regressions, and the ridge solve all run on device.

All functions take an explicit validity mask instead of dropping NaNs
(fixed shapes jit cleanly); they run under jax.experimental.enable_x64 so
fitted parameters are f64-exact regardless of the ambient production
precision.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _masked_sort(x, mask):
    """Sort with invalid entries pushed to +inf; returns (sorted, n_valid)."""
    big = jnp.where(mask, x, jnp.inf)
    return jnp.sort(big), jnp.sum(mask)


def masked_quantile(x, mask, q):
    """Linear-interpolation quantile of the masked entries (numpy
    'linear' method); q may be a vector. Returns NaN when nothing valid."""
    s, n = _masked_sort(x, mask)
    q = jnp.atleast_1d(jnp.asarray(q, s.dtype))
    pos = q * (n - 1).astype(s.dtype)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, x.shape[0] - 1)
    hi = jnp.clip(lo + 1, 0, x.shape[0] - 1)
    frac = pos - lo.astype(s.dtype)
    val = s[lo] * (1.0 - frac) + s[hi] * frac
    return jnp.where(n > 0, val, jnp.nan)


def masked_median(x, mask):
    return masked_quantile(x, mask, 0.5)[0]


def masked_mean(x, mask):
    n = jnp.sum(mask)
    return jnp.where(n > 0, jnp.sum(jnp.where(mask, x, 0.0)) / n, jnp.nan)


def masked_std(x, mask):
    """Population std of masked entries (numpy nanstd semantics)."""
    m = masked_mean(x, mask)
    d = jnp.where(mask, x - m, 0.0)
    n = jnp.sum(mask)
    return jnp.where(n > 0, jnp.sqrt(jnp.sum(d * d) / n), jnp.nan)


def ar1_fit(x, y, mask, lo_phi, hi_phi, lo_sig, hi_sig,
            default_phi, default_sigma):
    """AR(1) slope through the origin of (x -> y) over masked pairs:
    phi = <x, y> / <x, x> clipped to [lo_phi, hi_phi]; sigma = std of the
    residual y - phi x (population), clipped. Falls back to the defaults
    when <x, x> is non-positive."""
    xm = jnp.where(mask, x, 0.0)
    ym = jnp.where(mask, y, 0.0)
    denom = jnp.sum(xm * xm)
    phi_raw = jnp.sum(xm * ym) / jnp.where(denom > 0, denom, 1.0)
    phi = jnp.where(denom > 0, jnp.clip(phi_raw, lo_phi, hi_phi), default_phi)
    resid = y - phi * x
    sigma_raw = masked_std(resid, mask)
    sigma = jnp.where(denom > 0, jnp.clip(sigma_raw, lo_sig, hi_sig),
                      default_sigma)
    return phi, sigma


def compress(x, mask):
    """dropna-equivalent: valid entries first in original order (stable),
    garbage tail after. Returns (compressed, n_valid). Pairing a compressed
    series reproduces the reference's dropna-then-lag AR(1) semantics
    (pairs may straddle invalid gaps)."""
    order = jnp.argsort(~mask, stable=True)
    return x[order], jnp.sum(mask)


def ridge_solve(X, y, mask, reg_diag):
    """Masked ridge regression beta = (X'X + diag(reg))^-1 X'y over the
    valid rows — the device replacement for dropna + np.linalg.solve.
    Invalid rows are zeroed in both operands (NaN-safe)."""
    w = mask[:, None]
    Xm = jnp.where(w, X, 0.0)
    ym = jnp.where(mask, y, 0.0)
    A = Xm.T @ Xm + jnp.diag(jnp.asarray(reg_diag, X.dtype))
    b = Xm.T @ ym
    return jnp.linalg.solve(A, b)


@functools.partial(jax.jit, static_argnames=())
def funding_fit_device(target, stress, inv_curve, liquidity, credit):
    """Device core of the funding-spread calibration: winsorize the implied
    spread at [P1, P99], masked ridge on the 5 covariates (non-negative
    slope clip), and the [P1, P99.5] spread bounds of the fitted series.

    Returns (beta [5], min_spread, max_spread, n_valid)."""
    n = target.shape[0]
    finite_t = jnp.isfinite(target)
    lohi = masked_quantile(target, finite_t, jnp.asarray([0.01, 0.99]))
    n_fin = jnp.sum(finite_t)
    tgt = jnp.where(n_fin > 20, jnp.clip(target, lohi[0], lohi[1]), target)
    med = masked_median(target, finite_t)
    tgt = jnp.where(jnp.isfinite(tgt), tgt,
                    jnp.where(n_fin > 0, med, 0.0060))

    X = jnp.stack([jnp.ones(n, tgt.dtype), stress, inv_curve,
                   jnp.clip(liquidity, 0.0, 3.0),
                   jnp.clip(credit, 0.0, 3.0)], axis=1)
    mask = jnp.isfinite(tgt) & jnp.all(jnp.isfinite(X), axis=1)
    beta = ridge_solve(X, tgt, mask, [1e-6, 1e-4, 1e-4, 1e-4, 1e-4])
    beta = beta.at[1:].set(jnp.clip(beta[1:], 0.0, None))

    predicted = X @ beta
    fin_p = jnp.isfinite(predicted)
    qs = masked_quantile(predicted, fin_p, jnp.asarray([0.01, 0.995]))
    min_spread = jnp.maximum(qs[0], 0.0025)
    max_spread = jnp.minimum(qs[1], 0.0300)
    max_spread = jnp.where(max_spread <= min_spread, min_spread + 0.005,
                           max_spread)
    enough = jnp.sum(fin_p) > 10
    min_spread = jnp.where(enough, min_spread, 0.0030)
    max_spread = jnp.where(enough, max_spread, 0.0300)
    return beta, min_spread, max_spread, jnp.sum(mask)


def _lag_pairs(x, mask):
    """Compress (dropna) then lag: returns (prev, nxt, pair_mask, n) where
    pairs are adjacent in the COMPRESSED series (reference dropna-then-lag
    semantics — pairs straddle invalid gaps)."""
    c, n = compress(x, mask)
    pos = jnp.arange(x.shape[0] - 1)
    pair = pos < (n - 1)
    return c[:-1], c[1:], pair, n


@jax.jit
def stress_channel_fit_device(liq, cred, rv, mask):
    """Device core of one regime's stress-state fit: medians of the two
    channels, demeaned AR(1) per channel (dropna-then-lag pairing), and
    the excess-realized-vol jump intensity. Returns the 8 regime params
    plus n_valid."""
    liq_mu = masked_median(liq, mask)
    cred_mu = masked_median(cred, mask)

    lp, ln, lpair, n = _lag_pairs(liq, mask)
    # Reference ar1() centers on the median of the compressed series (same
    # values as the masked median) and falls back below 20 samples.
    liq_phi, liq_sigma = ar1_fit(lp - liq_mu, ln - liq_mu, lpair,
                                 0.50, 0.98, 0.01, 0.30, 0.90, 0.08)
    cp, cn, cpair, _ = _lag_pairs(cred, mask)
    cred_phi, cred_sigma = ar1_fit(cp - cred_mu, cn - cred_mu, cpair,
                                   0.50, 0.98, 0.01, 0.30, 0.88, 0.07)
    few = n < 20
    liq_phi = jnp.where(few, 0.90, liq_phi)
    liq_sigma = jnp.where(few, 0.08, liq_sigma)
    cred_phi = jnp.where(few, 0.88, cred_phi)
    cred_sigma = jnp.where(few, 0.07, cred_sigma)

    excess_rv = masked_mean(jnp.maximum(rv - 0.25, 0.0), mask)
    jump_p = jnp.clip(0.0002 + 0.003 * excess_rv, 0.0002, 0.003)
    jump_s = jnp.clip(0.0005 + 0.002 * excess_rv, 0.0005, 0.0025)
    return (liq_mu, liq_phi, liq_sigma, cred_mu, cred_phi, cred_sigma,
            jump_p, jump_s, n)


@functools.partial(jax.jit, static_argnames=("lo_scale", "hi_scale"))
def tracking_residual_fit_device(residual, mask, lo_scale: float,
                                 hi_scale: float):
    """Device core of one asset's tracking-residual fit: AR(1) rho of the
    compressed residual, innovation scale, downside asymmetry, and the
    P99.5 tanh clip limit. Returns (rho, scale, downside_mult, clip_limit,
    n_valid, n_innov)."""
    prev, nxt, pair, n = _lag_pairs(residual, mask)
    xm = jnp.where(pair, prev, 0.0)
    ym = jnp.where(pair, nxt, 0.0)
    denom = jnp.sum(xm * xm)
    rho_raw = jnp.sum(xm * ym) / jnp.where(denom > 0, denom, 1.0)
    rho = jnp.where(denom > 0, jnp.clip(rho_raw, 0.0, 0.7), 0.25)

    innov = nxt - rho * prev
    scale = jnp.clip(masked_std(innov, pair), lo_scale, hi_scale)
    neg = pair & (innov < 0)
    pos = pair & (innov >= 0)
    down = jnp.where(jnp.any(neg),
                     masked_mean(jnp.abs(innov), neg), scale)
    up = jnp.where(jnp.any(pos), masked_mean(jnp.abs(innov), pos), scale)
    downside_mult = jnp.clip(down / jnp.maximum(up, 1e-9), 1.0, 2.0)

    n_innov = n - 1
    p995 = masked_quantile(jnp.abs(innov), pair, 0.995)[0] * 1.35
    clip_limit = jnp.clip(jnp.where(n_innov > 30, p995, 0.15), 0.08, 0.35)
    return rho, scale, downside_mult, clip_limit, n, n_innov


def to_x64(*arrays):
    """Host->device f64 staging helper for the calibration fits."""
    return tuple(jnp.asarray(np.asarray(a, np.float64)) for a in arrays)


from contextlib import contextmanager  # noqa: E402


@contextmanager
def fit_context():
    """Execution context for calibration fits: f64 (fitted parameters are
    part of the model SPEC and must not depend on the ambient production
    precision) on the XLA:CPU backend (f64 is slow or missing on
    accelerators; calibration is a one-time cost, so exactness wins over
    placement)."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.enable_x64(True):
        yield
