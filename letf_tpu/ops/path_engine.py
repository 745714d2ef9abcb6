"""The fused per-path simulation engine.

This replaces the reference's five sequential per-day Python loops
(simulate_single_path_fixed, engine.py:423-619; hot loops catalogued in
SURVEY.md §3.2) with scan-formulated recurrences over pre-generated
counter-based innovations:

  1. semi-Markov regime path         (engine.py:255-302)   -> lax.scan
  2. joint multivariate-t + GARCH/DCC (calibration.py:480-590)
     fused with the VIX AR(1)+jump path (engine.py:99-115) -> one lax.scan
  3. IRX short-rate noise            (engine.py:117-123)   -> elementwise
  4. latent stress channels + jumps  (calibration.py:787-830) -> lax.scan
  5. financing + LETF layer math     (engine.py:320-349, 360-420,
     utils.py:169-216) -> elementwise, all 6 assets at once
  6. tracking-error AR(1) + EMA de-bias (engine.py:157-203) -> one lax.scan
     across all assets simultaneously

Per-trial state is a few dozen floats, so the scan carry stays on chip;
parallelism comes from vmap over the trial axis and mesh
sharding of trial chunks (see letf_tpu.parallel). All math runs in the
ambient precision: f32 in production, f64 under the parity/x64 test config.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from letf_tpu import config as cfg
from letf_tpu.models.params import SimModel
from letf_tpu.ops import rng as rngs

_A = cfg.N_ASSETS


class PathOutputs(NamedTuple):
    """Per-trial simulation window outputs (leading axis = day)."""
    etf_ret: jax.Array       # [S, A] net daily LETF returns
    tlt_ret: jax.Array       # [S] raw TLT stream (sim_df TLT column)
    spy_ret: jax.Array       # [S] jump-adjusted SPY underlying stream
    qqq_ret: jax.Array       # [S] jump-adjusted QQQ underlying stream
    vix: jax.Array           # [S]
    regime: jax.Array        # [S] int32
    cash_ret: jax.Array      # [S] daily cash return
    risk_free: jax.Array     # [S] annual risk-free (decimal)
    start_offset: jax.Array  # scalar int32
    start_regime: jax.Array  # scalar int32
    initial_vix: jax.Array   # scalar
    jump_days: jax.Array     # scalar int32 (stress summary)
    liq_mean: jax.Array      # scalar
    credit_mean: jax.Array   # scalar
    valid: jax.Array         # scalar bool: POST-repair layer checks
    repaired: jax.Array      # scalar bool: failed pre-repair checks and got
                             # the bound-and-zero repair pass applied
    # Split validity components (VERDICT r4 next #5): the combined
    # reference-faithful flag saturates at 30y (the reference's VIX-range
    # check has no matching upper clip in its VIX process, engine.py:115
    # vs :226-229, so nearly every long path trips it) — these two
    # discriminate. valid == vix_ok (post-repair); repaired ==
    # ~(path_finite & vix_ok).
    path_finite: jax.Array = None   # scalar bool: pre-repair finite returns
    vix_ok: jax.Array = None        # scalar bool: 5 <= VIX <= 120 all days


def _chol3(c):
    """Closed-form lower Cholesky of a 3x3 SPD matrix (fused; no lapack)."""
    eps = 1e-18
    l11 = jnp.sqrt(jnp.maximum(c[0, 0], eps))
    l21 = c[1, 0] / l11
    l31 = c[2, 0] / l11
    l22 = jnp.sqrt(jnp.maximum(c[1, 1] - l21 * l21, eps))
    l32 = (c[2, 1] - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(c[2, 2] - l31 * l31 - l32 * l32, eps))
    z = jnp.zeros((), c.dtype)
    return jnp.array([[l11, z, z], [l21, l22, z], [l31, l32, l33]])


# ---------------------------------------------------------------------------
# Stage 1: semi-Markov regime path
# ---------------------------------------------------------------------------

def _draw_dwell(model: SimModel, r, u):
    """Dwell draw: empirical table inverse-CDF when available, else geometric
    from the clipped self-transition probability."""
    reg = model.regime
    cdf = reg.dwell_cdf[r]
    idx = jnp.sum(cdf < u).astype(jnp.int32)
    idx = jnp.minimum(idx, cdf.shape[-1] - 1)
    emp = reg.dwell_values[r, idx]
    p_stay = reg.p_stay[r]
    geo = jnp.ceil(jnp.log1p(-u) / jnp.log(p_stay))
    geo = jnp.maximum(geo, 1.0)
    return jnp.where(reg.has_dwell[r] > 0, emp, geo)


def _draw_next_regime(model: SimModel, r, u):
    """Next state from the off-diagonal transition mass (semi-Markov).

    The diagonal is zeroed with a mask rather than a scatter — a traced-index
    scatter inside a scan body triggers a pathological XLA:CPU compile.
    """
    row = model.regime.transition[r]
    row = row * (jnp.arange(row.shape[0]) != r)
    rs = jnp.sum(row)
    probs = jnp.where(rs > 0, row / jnp.maximum(rs, 1e-30), 0.0)
    nxt = jnp.sum(jnp.cumsum(probs) < u).astype(jnp.int32)
    nxt = jnp.minimum(nxt, row.shape[0] - 1)
    return jnp.where(rs > 0, nxt, r)


def simulate_regime_path(model: SimModel, key, start_regime, total_days: int):
    """[T] int32 regime path with explicit dwell-time draws."""
    model = _to_device(model)
    u = jax.random.uniform(key, (total_days + 1, 2))
    first_dwell = _draw_dwell(model, start_regime, u[0, 0])

    def step(carry, u_t):
        cur, rem = carry
        out = cur
        rem = rem - 1.0
        need = rem <= 0.0
        nxt = _draw_next_regime(model, cur, u_t[1])
        ndw = _draw_dwell(model, nxt, u_t[0])
        cur = jnp.where(need, nxt, cur)
        rem = jnp.where(need, ndw, rem)
        return (cur, rem), out

    (_, _), path = lax.scan(step, (start_regime, first_dwell), u[1:])
    return path.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Stage 2: joint multivariate-t returns + VIX (one fused scan)
# ---------------------------------------------------------------------------

def simulate_joint_and_vix(model: SimModel, regime_path, eps, u_chi, vix_noise,
                           moment_matching: bool = True):
    """Regime-conditional multivariate-t with GARCH/DCC-lite recursions,
    fused with the VIX AR(1)+jump path (which consumes the same day's SPY
    shock). Returns (returns [T,3], vix [T])."""
    J = model.joint
    V = model.vix
    reg = model.regime
    dt = eps.dtype

    def step(carry, xs):
        h, Q, prev_z, prev_r, vix_prev, t = carry
        r, e, u, vn = xs

        mu = J.mu[r]
        alpha = J.garch_alpha[r]
        beta = J.garch_beta[r]
        a_dcc = J.dcc_a[r]
        b_dcc = J.dcc_b[r]
        long_var = J.long_var[r]
        rbar = J.rbar[r]

        first = t == 0
        switch = (r != prev_r) & (~first)

        garch_h = jnp.clip((1 - alpha - beta) * long_var
                           + alpha * (prev_z ** 2) * h + beta * h, 1e-10, None)
        h_new = jnp.where(first, long_var,
                          jnp.where(switch, 0.10 * long_var + 0.90 * h, garch_h))
        dcc_Q = ((1 - a_dcc - b_dcc) * rbar
                 + a_dcc * jnp.outer(prev_z, prev_z) + b_dcc * Q)
        Q_new = jnp.where(first, rbar,
                          jnp.where(switch, 0.10 * rbar + 0.90 * Q, dcc_Q))

        d = jnp.sqrt(jnp.clip(jnp.diagonal(Q_new), 1e-12, None))
        R_t = Q_new / jnp.outer(d, d)
        sh = jnp.sqrt(h_new)
        cov_t = jnp.outer(sh, sh) * R_t

        L = _chol3(cov_t)
        z = jnp.dot(L, e, precision=lax.Precision.HIGHEST)
        scale = jnp.sqrt(J.nu[r] / jnp.maximum(u, 1e-12))
        x = jnp.clip(mu + z * scale, -0.95, 4.0)
        prev_z_new = (x - mu) / jnp.sqrt(jnp.clip(h_new, 1e-10, None))

        # VIX: spikes only on negative equity moves (same-day SPY shock).
        denom = jnp.maximum(reg.daily_std[r], 1e-4)
        shock = jnp.maximum(-x[0], 0.0) / denom
        vjump = V.jump_scale[r] * jnp.maximum(0.0, shock - V.jump_threshold[r])
        vix_ar = jnp.maximum(
            10.0, V.phi[r] * vix_prev + (1 - V.phi[r]) * V.target[r]
            + vjump + V.noise_std[r] * vn)
        vix_t = jnp.where(first, V.base[r].astype(dt), vix_ar)

        return (h_new, Q_new, prev_z_new, r, vix_t, t + 1), (x, vix_t)

    T = regime_path.shape[0]
    init = (jnp.zeros(3, dt), jnp.zeros((3, 3), dt), jnp.zeros(3, dt),
            regime_path[0], jnp.zeros((), dt), jnp.int32(0))
    _, (x, vix) = lax.scan(step, init, (regime_path, eps, u_chi, vix_noise))

    if moment_matching:
        # Long-horizon drift stabilization: nudge each stream 10% of the way
        # toward its theoretical (regime-average) mean.
        theo = jnp.asarray(J.theo_mean, dt)
        x = x + (theo - x.mean(axis=0)) * 0.1
    return x, vix


# ---------------------------------------------------------------------------
# Stage 4: latent stress channels + crisis jumps
# ---------------------------------------------------------------------------

def simulate_stress(model: SimModel, regime_path, vix, norms, u_jump, t_abs):
    """Two AR(1) stress channels (liquidity, credit) + Bernoulli-t jumps.
    Day 0 initializes at the regime means with no jump."""
    S = model.stress

    def step(carry, xs):
        liq, cred, t = carry
        r, v, n2, uj, ta = xs
        liq_new = jnp.clip(S.liq_mu[r] + S.liq_phi[r] * (liq - S.liq_mu[r])
                           + S.liq_sigma[r] * n2[0], 0.0, 3.0)
        cred_new = jnp.clip(S.credit_mu[r] + S.credit_phi[r] * (cred - S.credit_mu[r])
                            + S.credit_sigma[r] * n2[1], 0.0, 3.0)
        first = t == 0
        liq_new = jnp.where(first, S.liq_mu[r], liq_new)
        cred_new = jnp.where(first, S.credit_mu[r], cred_new)

        vix_amp = jnp.maximum((v - 25.0) / 30.0, 0.0)
        p = jnp.clip(S.jump_base_prob[r] + 0.008 * vix_amp + 0.003 * liq_new,
                     0.0, 0.01)
        jump = jnp.where((uj < p) & (~first), ta * S.jump_scale[r], 0.0)
        return (liq_new, cred_new, t + 1), (liq_new, cred_new, jump)

    dt = vix.dtype
    init = (jnp.zeros((), dt), jnp.zeros((), dt), jnp.int32(0))
    _, (liq, cred, jump) = lax.scan(
        step, init, (regime_path, vix, norms, u_jump, t_abs))
    return liq, cred, jump


# ---------------------------------------------------------------------------
# Stage 5: funding spread + LETF layer composition
# ---------------------------------------------------------------------------

def borrow_spread_series(model: SimModel, vix, risk_free, liq, cred,
                         use_funding_model: bool = True):
    """State-linked annual borrow spread [S] (predict_borrow_spread_series +
    the in-sim TNX proxy from credit stress, engine.py:328-342)."""
    F = model.funding
    if not use_funding_model:
        return None
    term_spread = 1.25 - 1.1 * jnp.clip(cred, 0.0, 3.0)
    inv_curve = jnp.maximum(-term_spread, 0.0)
    stress_v = jnp.maximum(vix - 20.0, 0.0)
    spread = (F.base + F.beta_vix * stress_v + F.beta_inv_curve * inv_curve
              + F.beta_liquidity * jnp.clip(liq, 0.0, 3.0)
              + F.beta_credit * jnp.clip(cred, 0.0, 3.0))
    return jnp.clip(spread, F.min_spread, F.max_spread)


def compose_letf_returns(model: SimModel, underlying, risk_free, spread):
    """Layer B/C: leverage math + expense + state-linked financing for all
    assets at once. underlying: [S, A]; returns [S, A] before tracking error.

    Daily borrow cost = (L-1) * max(rf + spread, 0) / 252, fused elementwise.
    """
    P = model.assets
    lev = jnp.asarray(P.leverage, underlying.dtype)
    if spread is None:
        sp = jnp.asarray(P.fallback_spread, underlying.dtype)[None, :]
    else:
        sp = spread[:, None]
    borrow_daily = (jnp.maximum(lev - 1.0, 0.0)[None, :]
                    * jnp.maximum(risk_free[:, None] + sp, 0.0) / 252.0)
    expense_daily = jnp.asarray(P.expense_ratio, underlying.dtype) / 252.0
    return lev[None, :] * underlying - expense_daily[None, :] - borrow_daily


# ---------------------------------------------------------------------------
# Stage 6: tracking error (all assets in one scan)
# ---------------------------------------------------------------------------

def simulate_tracking_error(model: SimModel, regime_path, vix, underlying,
                            t_draws):
    """AR(1) tracking residual with fat tails, downside asymmetry, and EMA
    de-bias (half-life ~126d), then smooth tanh saturation."""
    Tk = model.tracking
    dt = vix.dtype
    rho = jnp.asarray(Tk.rho, dt)
    sq = jnp.sqrt(jnp.maximum(1.0 - rho ** 2, 1e-6))
    te_scale = jnp.asarray(Tk.te_scale, dt)
    downside = jnp.asarray(Tk.downside_mult, dt)
    ema_alpha = 2.0 / (126 + 1)

    vix_mult = jnp.clip((vix / 20.0) ** 0.5, 0.5, 1.5)              # [S]
    regime_mult = jnp.where(regime_path == 0, 1.0, 1.15)            # [S]
    move_mult = ((1.0 + 0.3 * jnp.abs(underlying))
                 * jnp.where(underlying < 0, downside[None, :], 0.98))  # [S,A]

    innov = t_draws * te_scale[None, :] * (vix_mult * regime_mult)[:, None]

    def step(carry, xs):
        te, bias, t = carry
        innov_t, move_t = xs
        te_new = rho * te + sq * innov_t * move_t
        te_new = jnp.where(t == 0, 0.0, te_new)
        bias_new = ema_alpha * te_new + (1 - ema_alpha) * bias
        return (te_new, bias_new, t + 1), te_new - bias_new

    init = (jnp.zeros(_A, dt), jnp.zeros(_A, dt), jnp.int32(0))
    _, te = lax.scan(step, init, (innov, move_mult))

    cap = jnp.asarray(Tk.clip_limit, dt)
    return jnp.where(cap[None, :] > 0, cap[None, :] * jnp.tanh(te / cap[None, :]), te)


# ---------------------------------------------------------------------------
# Innovations: every random draw a trial consumes, pre-generated.
# This is the parity seam — the NumPy oracle (letf_tpu.oracle) consumes the
# exact same arrays, so engine-vs-oracle comparisons test the recursion math
# independent of RNG algorithm (threefry here vs PCG64 in the reference).
# ---------------------------------------------------------------------------

class Innovations(NamedTuple):
    start_offset: jax.Array   # scalar int32
    start_regime: jax.Array   # scalar int32
    initial_vix: jax.Array    # scalar
    regime_full: jax.Array    # [T] int32 (generated by the regime scan)
    eps: jax.Array            # [T, 3] joint normals (sign-flipped if antithetic)
    u_chi: jax.Array          # [T] chi-square(nu_t) mixing draws
    vix_noise: jax.Array      # [T] standard normals
    irx_noise: jax.Array      # [T] standard normals
    stress_norms: jax.Array   # [S, 2]
    u_jump: jax.Array         # [S] uniforms
    t_abs: jax.Array          # [S] |t_5| magnitudes
    jump_sign: jax.Array      # [S] ±1
    te_draws: jax.Array       # [S, A] Student-t(df_a)
    mode_key: jax.Array       # key material for legacy/parametric modes


def _to_device(model: SimModel) -> SimModel:
    """Move host numpy parameter arrays to jnp (respects the ambient x64
    config: f64 under the parity test config, f32 in production)."""
    return jax.tree.map(jnp.asarray, model)


def draw_innovations(model: SimModel, run_key, trial_id, antithetic,
                     sim_days: int, buffer_days: int = 0,
                     random_start_method: str = "offset",
                     anchors=None) -> Innovations:
    """Draw every random input for one trial from its counter-based streams.

    ``anchors``: optional (regimes [K] int32, vix [K]) arrays of historical
    anchor conditions for the 'historical_anchor' start method
    (random_start.py:60-129: regime from the anchor day's VIX threshold,
    initial VIX from the anchor row)."""
    model = _to_device(model)
    total_days = sim_days + buffer_days
    tk = rngs.trial_key(run_key, trial_id)

    # ---- random start conditions (random_start.py:132-209) ----
    kstart = rngs.stream(tk, rngs.START)
    k_off, k_reg, k_vix0 = jax.random.split(kstart, 3)
    anchor_vix = None
    if random_start_method == "offset" and buffer_days > 0:
        min_offset = min(50, buffer_days // 4)
        start_offset = jax.random.randint(k_off, (), min_offset, buffer_days)
        start_regime = jnp.int32(0)
    elif random_start_method == "regime_only" or (
            random_start_method == "historical_anchor" and anchors is None):
        # historical_anchor falls back to regime_only without anchor data
        # (random_start.py:199-201).
        start_offset = jnp.int32(0)
        probs = jnp.asarray(model.regime.start_probs)
        start_regime = jnp.sum(
            jnp.cumsum(probs / probs.sum())
            < jax.random.uniform(k_reg, ())).astype(jnp.int32)
    elif random_start_method == "historical_anchor":
        anchor_regimes, anchor_vix_arr = anchors
        idx = jax.random.randint(k_reg, (), 0, anchor_regimes.shape[0])
        start_offset = jnp.int32(0)
        start_regime = jnp.asarray(anchor_regimes)[idx].astype(jnp.int32)
        anchor_vix = jnp.asarray(anchor_vix_arr)[idx]
    else:
        start_offset = jnp.int32(0)
        start_regime = jnp.int32(0)
    vr = jnp.asarray([cfg.INITIAL_VIX_RANGE[r] for r in range(cfg.N_REGIMES)])
    lo, hi = vr[start_regime, 0], vr[start_regime, 1]
    initial_vix = jax.random.uniform(k_vix0, (), minval=lo, maxval=hi)
    if anchor_vix is not None:
        # Anchored starts use the historical VIX level, not a random draw
        # (random_start.py:204: RANDOMIZE_INITIAL_VIX skipped for anchors).
        initial_vix = anchor_vix

    regime_full = simulate_regime_path(
        model, rngs.stream(tk, rngs.REGIME), start_regime, total_days)

    sign = jnp.where(antithetic, -1.0, 1.0)
    eps = sign * jax.random.normal(rngs.stream(tk, rngs.JOINT_EPS),
                                   (total_days, 3))
    # Chi-square(nu_r) mixing draws: one scalar-shape gamma sampler per
    # regime, selected by the regime path. Distributionally identical to a
    # per-day varying-shape sampler but compiles a far smaller rejection
    # loop.
    k_chi = rngs.stream(tk, rngs.JOINT_CHI)
    nus = jnp.asarray(model.joint.nu)
    chis = jnp.stack([
        2.0 * jax.random.gamma(jax.random.fold_in(k_chi, r), nus[r] / 2.0,
                               (total_days,))
        for r in range(nus.shape[0])])
    u_chi = chis[regime_full, jnp.arange(total_days)]
    vix_noise = jax.random.normal(rngs.stream(tk, rngs.VIX_NOISE), (total_days,))
    irx_noise = jax.random.normal(rngs.stream(tk, rngs.IRX_NOISE), (total_days,))

    ks = rngs.stream(tk, rngs.STRESS_NORM)
    kj = rngs.stream(tk, rngs.STRESS_JUMP)
    stress_norms = jax.random.normal(ks, (sim_days, 2))
    kj_u, kj_t, kj_s = jax.random.split(kj, 3)
    u_jump = jax.random.uniform(kj_u, (sim_days,))
    t_abs = jnp.abs(jax.random.t(kj_t, 5.0, (sim_days,)))
    jump_sign = jnp.where(jax.random.uniform(kj_s, (sim_days,)) < 0.5, -1.0, 1.0)

    # Tracking-error t draws: per-asset df comes from the static asset
    # config (5 for LETFs, 10 for 1x funds), so sample once per distinct df
    # with a STATIC scalar shape parameter — varying-shape samplers bloat
    # the compiled rejection loop.
    k_te = rngs.stream(tk, rngs.TRACKING)
    static_dfs = cfg.asset_table().te_df
    te_cols = []
    for df_val in sorted(set(static_dfs.tolist())):
        cols = [a for a in range(_A) if static_dfs[a] == df_val]
        draws = jax.random.t(jax.random.fold_in(k_te, int(df_val)),
                             float(df_val), (sim_days, len(cols)))
        te_cols.extend(zip(cols, jnp.moveaxis(draws, 1, 0)))
    te_draws = jnp.stack([c for _, c in sorted(te_cols)], axis=1)

    return Innovations(
        start_offset=start_offset, start_regime=start_regime,
        initial_vix=initial_vix, regime_full=regime_full, eps=eps,
        u_chi=u_chi, vix_noise=vix_noise, irx_noise=irx_noise,
        stress_norms=stress_norms, u_jump=u_jump, t_abs=t_abs,
        jump_sign=jump_sign, te_draws=te_draws,
        mode_key=rngs.stream(tk, rngs.BOOTSTRAP))


def simulate_vix_given_returns(model: SimModel, regime_path, spy_returns,
                               vix_noise):
    """Standalone VIX AR(1)+jump recursion for engine modes whose returns
    are generated outside the fused joint scan (engine.py:99-115)."""
    V = model.vix
    reg = model.regime
    dt = spy_returns.dtype

    def step(carry, xs):
        vix_prev, t = carry
        r, s, vn = xs
        denom = jnp.maximum(reg.daily_std[r], 1e-4)
        shock = jnp.maximum(-s, 0.0) / denom
        vjump = V.jump_scale[r] * jnp.maximum(0.0, shock - V.jump_threshold[r])
        vix_ar = jnp.maximum(
            10.0, V.phi[r] * vix_prev + (1 - V.phi[r]) * V.target[r]
            + vjump + V.noise_std[r] * vn)
        vix_t = jnp.where(t == 0, V.base[r].astype(dt), vix_ar)
        return (vix_t, t + 1), vix_t

    _, vix = lax.scan(step, (jnp.zeros((), dt), jnp.int32(0)),
                      (regime_path, spy_returns, vix_noise))
    return vix


def generate_returns_parametric(model: SimModel, regime_path, key):
    """Pure parametric fallback mode (engine.py:81-97): regime-conditional
    correlated Student-t draws; QQQ/TLT as SPY loadings plus noise."""
    total_days = regime_path.shape[0]
    std = jnp.asarray(model.regime.daily_std)[regime_path]
    # Drawn in float32 whatever the ambient precision, so a float64 run
    # replays the float32 run's draws (tests/test_f32_path.py).
    z = jax.random.t(key, float(cfg.STUDENT_T_DF), (total_days, 3),
                     jnp.float32).astype(std.dtype)
    corr_low = np.linalg.cholesky(np.array(
        [[1.0, 0.85, -0.15], [0.85, 1.0, -0.10], [-0.15, -0.10, 1.0]]))
    corr_high = np.linalg.cholesky(np.array(
        [[1.0, 0.92, -0.45], [0.92, 1.0, -0.30], [-0.45, -0.30, 1.0]]))
    chol = jnp.where((regime_path == 0)[:, None, None],
                     jnp.asarray(corr_low), jnp.asarray(corr_high))
    x = jnp.einsum("tij,tj->ti", chol, z,
                   precision=lax.Precision.HIGHEST)
    mu = jnp.asarray(model.regime.daily_mean)[regime_path]
    spy = mu + std * x[:, 0]
    qqq = 1.15 * spy + 0.006 * x[:, 1]
    tlt = -0.12 * spy + 0.004 * x[:, 2]
    return spy, qqq, tlt


def blend_engine_noise(model: SimModel, regime_path, spy, qqq, tlt, key):
    """Engine-level bootstrap/noise blend (engine.py:56-80): correlated
    Student-t innovations scaled by regime vol, double-weighted exactly as
    the reference does (noise itself carries the (1-W) factor, then the
    blend applies another (1-W))."""
    total_days = regime_path.shape[0]
    w = float(np.clip(cfg.BOOTSTRAP_WEIGHT, 0.0, 1.0))
    noise_w = 1.0 - w
    z = jax.random.t(key, float(cfg.STUDENT_T_DF), (total_days, 3))
    chol_low = jnp.asarray(np.linalg.cholesky(np.array(
        [[1.0, 0.88, -0.18], [0.88, 1.0, -0.12], [-0.18, -0.12, 1.0]])))
    chol_high = jnp.asarray(np.linalg.cholesky(np.array(
        [[1.0, 0.94, -0.42], [0.94, 1.0, -0.30], [-0.42, -0.30, 1.0]])))
    chol = jnp.where((regime_path == 0)[:, None, None], chol_low, chol_high)
    x = jnp.einsum("tij,tj->ti", chol, z,
                   precision=lax.Precision.HIGHEST)
    spy_std = jnp.asarray(model.regime.daily_std)[regime_path]
    spy_noise = noise_w * spy_std * 0.55 * x[:, 0]
    qqq_noise = noise_w * 1.35 * spy_std * 0.45 * x[:, 1]
    tlt_noise = noise_w * 0.55 * spy_std * 0.35 * x[:, 2]
    return (w * spy + (1 - w) * (spy + spy_noise),
            w * qqq + (1 - w) * (qqq + qqq_noise),
            w * tlt + (1 - w) * (tlt + tlt_noise))


def path_from_innovations(model: SimModel, innov: Innovations,
                          sim_days: int,
                          moment_matching: bool = True,
                          use_funding_model: bool = True,
                          use_stress: bool = True,
                          engine_mode: str = "institutional_v1",
                          bootstrap_pools=None) -> PathOutputs:
    """Deterministic path math given pre-drawn innovations (jit-safe)."""
    model = _to_device(model)
    regime_full = innov.regime_full

    if engine_mode == "institutional_v1":
        x_full, vix_full = simulate_joint_and_vix(
            model, regime_full, innov.eps, innov.u_chi, innov.vix_noise,
            moment_matching=moment_matching)
        spy_f, qqq_f, tlt_f = x_full[:, 0], x_full[:, 1], x_full[:, 2]
    else:
        # Legacy/parametric modes generate returns outside the joint scan.
        key = innov.mode_key
        if engine_mode == "legacy_hybrid" and bootstrap_pools is not None:
            from letf_tpu.models.bootstrap import sample_bootstrap_returns
            k_boot, k_blend = jax.random.split(key)
            sampled = sample_bootstrap_returns(
                bootstrap_pools, regime_full, k_boot,
                n_days=int(regime_full.shape[0]))
            spy_f, qqq_f, tlt_f = blend_engine_noise(
                model, regime_full, sampled["SPY_Ret"], sampled["QQQ_Ret"],
                sampled["TLT_Ret"], k_blend)
        else:
            spy_f, qqq_f, tlt_f = generate_returns_parametric(
                model, regime_full, key)
        vix_full = simulate_vix_given_returns(model, regime_full, spy_f,
                                              innov.vix_noise)

    irx_full = jnp.clip(
        jnp.asarray(model.irx_base)[regime_full] + 0.5 * innov.irx_noise,
        0.0, 15.0)

    # ---- slice the simulation window at the random offset ----
    def window(a):
        return lax.dynamic_slice_in_dim(a, innov.start_offset, sim_days, axis=0)

    regime = window(regime_full)
    vix = window(vix_full)
    irx = window(irx_full)
    spy, qqq, tlt = window(spy_f), window(qqq_f), window(tlt_f)

    # ---- latent stress + symmetric signed jumps ----
    if use_stress:
        liq, cred, jump = simulate_stress(
            model, regime, vix, innov.stress_norms, innov.u_jump, innov.t_abs)
        signed_jump = jump * innov.jump_sign
        spy = jnp.clip(spy - signed_jump, -0.95, 3.0)
        qqq = jnp.clip(qqq - 1.12 * signed_jump, -0.95, 4.0)
        jump_days = jnp.sum(jump > 0).astype(jnp.int32)
        liq_mean, cred_mean = liq.mean(), cred.mean()
    else:
        liq = cred = jnp.zeros_like(vix)
        jump_days = jnp.int32(0)
        liq_mean = cred_mean = jnp.zeros((), vix.dtype)

    risk_free = jnp.clip(irx, 0.0, 20.0) / 100.0

    # ---- layer composition for all assets ----
    streams = jnp.stack([spy, qqq, tlt], axis=-1)                   # [S, 3]
    und_idx = jnp.asarray(model.assets.underlying)
    beta = jnp.asarray(model.assets.beta, streams.dtype)
    underlying = streams[:, und_idx] * beta[None, :]                # [S, A]

    spread = borrow_spread_series(model, vix, risk_free, liq, cred,
                                  use_funding_model=use_funding_model)
    lev_ret = compose_letf_returns(model, underlying, risk_free, spread)

    te = simulate_tracking_error(model, regime, vix, underlying, innov.te_draws)

    etf_ret = jnp.clip(lev_ret + te, -0.999, 10.0)

    cash_ret = jnp.asarray(model.cash_rate, vix.dtype)[regime] / 252.0

    # ---- layer validity checks (engine.py:206-231): clipping guarantees
    # price positivity; record finiteness + VIX range ----
    finite_pre = (jnp.all(jnp.isfinite(etf_ret)) & jnp.all(jnp.isfinite(tlt))
                  & jnp.all(jnp.isfinite(vix)))
    vix_ok = (jnp.all(jnp.isfinite(vix))
              & (vix.min() >= 5.0) & (vix.max() <= 120.0))
    valid_pre = finite_pre & vix_ok

    # ---- repair pass (engine.py:553-562): bound returns and zero any
    # non-finite values so one bad path cannot poison percentiles; prices
    # are cumprods computed downstream, so rebuilding is implicit. VIX is
    # deliberately NOT repaired (reference parity: a VIX-range failure
    # keeps is_valid False after repair). Identity on valid paths. ----
    repaired = ~valid_pre
    etf_ret = jnp.clip(jnp.where(jnp.isfinite(etf_ret), etf_ret, 0.0),
                       -0.999, 10.0)
    tlt = jnp.clip(jnp.where(jnp.isfinite(tlt), tlt, 0.0), -0.999, 10.0)
    valid = vix_ok     # post-repair re-validation: returns now finite

    return PathOutputs(
        etf_ret=etf_ret, tlt_ret=tlt, spy_ret=spy, qqq_ret=qqq, vix=vix,
        regime=regime, cash_ret=cash_ret, risk_free=risk_free,
        start_offset=innov.start_offset, start_regime=innov.start_regime,
        initial_vix=innov.initial_vix, jump_days=jump_days,
        liq_mean=liq_mean, credit_mean=cred_mean, valid=valid,
        repaired=repaired, path_finite=finite_pre, vix_ok=vix_ok)


@functools.partial(
    jax.jit,
    static_argnames=("sim_days", "buffer_days", "random_start_method",
                     "moment_matching", "use_funding_model", "use_stress",
                     "engine_mode"))
def generate_path(model: SimModel, run_key, trial_id, antithetic,
                  sim_days: int, buffer_days: int = 0,
                  random_start_method: str = "offset",
                  moment_matching: bool = True,
                  use_funding_model: bool = True,
                  use_stress: bool = True,
                  engine_mode: str = "institutional_v1",
                  bootstrap_pools=None, anchors=None) -> PathOutputs:
    """One Monte Carlo trial (jit; vmap over trial_id/antithetic for batches).

    Mirrors simulate_single_path_fixed (engine.py:423-619) stage by stage;
    the time axis stays a serial scan on-chip, all other axes vectorize.
    engine_mode selects the return generator: 'institutional_v1' (joint
    multivariate-t), 'legacy_hybrid' (block bootstrap + noise blend;
    requires bootstrap_pools), or 'parametric' (regime Student-t fallback).
    """
    innov = draw_innovations(model, run_key, trial_id, antithetic,
                             sim_days, buffer_days, random_start_method,
                             anchors=anchors)
    return path_from_innovations(
        model, innov, sim_days, moment_matching=moment_matching,
        use_funding_model=use_funding_model, use_stress=use_stress,
        engine_mode=engine_mode, bootstrap_pools=bootstrap_pools)


# Jitted single-trial wrappers (tests / host-side tooling).
draw_innovations_jit = jax.jit(
    draw_innovations,
    static_argnames=("sim_days", "buffer_days", "random_start_method"))
path_from_innovations_jit = jax.jit(
    path_from_innovations,
    static_argnames=("sim_days", "moment_matching", "use_funding_model",
                     "use_stress", "engine_mode"))


def generate_paths_batch(model: SimModel, run_key, trial_ids, antithetic,
                         sim_days: int, **static_kwargs) -> PathOutputs:
    """vmap of generate_path over a trial batch: trial_ids [B] int32,
    antithetic [B] bool. Output arrays gain a leading batch axis."""
    fn = functools.partial(generate_path, sim_days=sim_days, **static_kwargs)
    return jax.vmap(lambda t, a: fn(model, run_key, t, a))(trial_ids, antithetic)
