"""Batched engine: equivalence with the per-trial engine, distributional
correctness of the fast samplers, and the shift-select window."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from letf_tpu.models.params import build_dwell_tables, default_sim_model
from letf_tpu.ops import rng as rngs
from letf_tpu.ops.path_batched import (
    draw_innovations_batched,
    generate_paths_batched,
    path_from_innovations_batched,
    simulate_regime_paths_spell,
    t_int_df,
)
from letf_tpu.ops.path_engine import generate_paths_batch, simulate_regime_path


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


def test_batched_equals_vmapped_per_trial(model):
    """With identical innovations (fast_draws=False), the batched
    engine must reproduce the per-trial vmapped engine."""
    B, S = 8, 252
    ids = jnp.arange(B, dtype=jnp.int32) // 2
    anti = (jnp.arange(B) % 2).astype(bool)
    a = generate_paths_batch(model, jax.random.key(0), ids, anti,
                             sim_days=S, buffer_days=126)
    b = jax.jit(generate_paths_batched,
                static_argnames=("sim_days", "buffer_days",
                                 "random_start_method", "fast_draws"))(
        model, jax.random.key(0), ids, anti, sim_days=S, buffer_days=126,
        fast_draws=False)
    np.testing.assert_allclose(np.asarray(a.etf_ret), np.asarray(b.etf_ret),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(a.vix), np.asarray(b.vix),
                               atol=1e-9)
    np.testing.assert_array_equal(np.asarray(a.regime), np.asarray(b.regime))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))


def test_fast_draws_distribution(model):
    """fast_draws paths are statistically indistinguishable from the
    reference-stream paths (different bits, same distributions)."""
    B, S = 128, 504
    ids = jnp.arange(B, dtype=jnp.int32)
    anti = jnp.zeros(B, bool)
    f = jax.jit(generate_paths_batched,
                static_argnames=("sim_days", "buffer_days",
                                 "random_start_method", "fast_draws"))
    fast = f(model, jax.random.key(1), ids, anti, sim_days=S,
             buffer_days=252, fast_draws=True)
    ref = f(model, jax.random.key(1), ids, anti, sim_days=S,
            buffer_days=252, fast_draws=False)
    for name in ("spy_ret", "tlt_ret"):
        a = np.asarray(getattr(fast, name)).ravel()
        b = np.asarray(getattr(ref, name)).ravel()
        se = b.std() / np.sqrt(len(b))
        assert abs(a.mean() - b.mean()) < 6 * se, name
        # Wide tolerance: returns are GARCH-mixed Student-t, and the two
        # modes consume uniforms differently, so regime occupancy (and
        # hence realized vol) differs by spell-level sampling noise — the
        # effective sample is ~hundreds of regime spells, not B*S days.
        assert a.std() == pytest.approx(b.std(), rel=0.2), name
    assert np.asarray(fast.vix).mean() == pytest.approx(
        np.asarray(ref.vix).mean(), rel=0.15)


def test_repair_pass_bounds_invalid_paths(model):
    """A non-finite innovation must be repaired (returns bounded and
    zeroed, repaired flag set) instead of poisoning downstream percentiles
    — reference engine.py:553-562."""
    from letf_tpu.ops.path_batched import (
        draw_innovations_fast,
        path_from_innovations_batched,
    )

    B, S = 4, 64
    innov = jax.jit(draw_innovations_fast, static_argnames=(
        "sim_days", "buffer_days", "random_start_method"))(
        model, jax.random.key(2), jnp.arange(B, dtype=jnp.int32),
        jnp.zeros(B, bool), sim_days=S, buffer_days=0,
        random_start_method="none")
    # Poison one trial's tracking-error draws with NaN.
    bad_te = innov.te_draws.at[1, 10, 0].set(jnp.nan)
    innov = innov._replace(te_draws=bad_te)
    path = jax.jit(path_from_innovations_batched,
                   static_argnames=("sim_days",))(model, innov, sim_days=S)
    assert bool(path.repaired[1]) and not bool(path.repaired[0])
    # Post-repair, every return is finite and bounded for ALL trials.
    etf = np.asarray(path.etf_ret)
    assert np.isfinite(etf).all()
    assert (etf >= -0.999).all() and (etf <= 10.0).all()
    # The repaired trial passes post-repair validation (VIX untouched).
    assert bool(path.valid[1])
    # Split validity flags (VERDICT r4 next #5): path_finite is the
    # discriminating pre-repair finite-returns check; vix_ok mirrors the
    # reference's VIX-range check and equals the combined post-repair flag.
    assert not bool(path.path_finite[1]) and bool(path.path_finite[0])
    np.testing.assert_array_equal(np.asarray(path.vix_ok),
                                  np.asarray(path.valid))


def test_chi2_from_normal_quantile_exact():
    """The Chebyshev log-quantile sampler must match scipy's chi-square
    quantile function to <2e-4 relative across +-6.2 sigma for the nu range
    calibration produces (deterministic check, no sampling noise)."""
    from scipy import stats

    from letf_tpu.models.params import chi2_log_quantile_cheb
    from letf_tpu.ops.path_batched import chi2_from_normal

    for nu in (4.0, 4.5, 6.0, 8.37, 12.0, 30.0):
        cheb = jnp.asarray(chi2_log_quantile_cheb(nu))
        z = np.linspace(-6.2, 6.2, 4001)
        got = np.asarray(chi2_from_normal(jnp.asarray(z), cheb))
        want = stats.chi2.ppf(stats.norm.cdf(z), nu)
        rel = np.abs(got - want) / want
        assert rel.max() < 2e-4, (nu, rel.max())


def test_t_int_df_moments():
    """Fast integer-df t sampler: variance df/(df-2), symmetric."""
    x = np.asarray(t_int_df(jax.random.key(0), 5, (200_000,)))
    assert x.mean() == pytest.approx(0.0, abs=0.02)
    assert x.var() == pytest.approx(5 / 3, rel=0.05)
    x10 = np.asarray(t_int_df(jax.random.key(1), 10, (200_000,)))
    assert x10.var() == pytest.approx(10 / 8, rel=0.05)


def test_spell_regime_paths_match_scan_distribution(model):
    """Spell-based regime paths: same dwell distribution and occupancy as
    the scan engine (different uniform consumption, so not bit-equal)."""
    rng = np.random.default_rng(0)
    ds = {0: list(rng.integers(20, 700, 500)),
          1: list(rng.integers(5, 80, 300))}
    dv, dc, hd = build_dwell_tables(ds)
    m = model._replace(regime=model.regime._replace(
        dwell_values=dv, dwell_cdf=dc, has_dwell=hd))

    B, T = 128, 2500
    keys = jax.vmap(lambda t: rngs.stream(
        rngs.trial_key(jax.random.key(5), t), rngs.REGIME))(jnp.arange(B))
    start = jnp.zeros(B, jnp.int32)
    sp = np.asarray(simulate_regime_paths_spell(m, keys, start, T))
    sc = np.stack([np.asarray(simulate_regime_path(m, keys[b], jnp.int32(0), T))
                   for b in range(16)])
    assert abs(float((sp == 1).mean()) - float((sc == 1).mean())) < 0.03
    # Regime values are only 0/1 and paths start in regime 0.
    assert set(np.unique(sp)) <= {0, 1}
    assert (sp[:, 0] == 0).all()


def test_plan_max_spells_bitwise(model):
    """The model-derived static spell bound (plan_max_spells) must leave
    regime paths bitwise unchanged: spell draws are counter-indexed, so
    any K that covers the horizon yields identical paths."""
    from letf_tpu.ops import path_batched as pb
    from letf_tpu.ops import rng as rngs

    B, T = 512, 2520
    k_planned = pb.plan_max_spells(model, T)
    assert 64 <= k_planned <= max(64, T // 12)
    keys = jax.vmap(
        lambda t: rngs.stream(rngs.trial_key(jax.random.key(3), t),
                              rngs.REGIME))(jnp.arange(B))
    start = (jnp.arange(B) % 2).astype(jnp.int32)
    a = pb.simulate_regime_paths_spell(model, keys, start, T)
    b = pb.simulate_regime_paths_spell(model, keys, start, T,
                                       max_spells=k_planned)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["zero", "max", "random_nan", "no_buffer"])
def test_window_series_matches_numpy_slicing(case):
    """window_series' binary shift-select tree is pure data movement:
    out[b, s] = in[b, s + offset[b]] bit for bit (NaN payloads included),
    against plain NumPy slicing per trial."""
    from letf_tpu.ops.path_batched import window_series

    rng = np.random.default_rng(4)
    B, S = 6, 40
    T = S if case == "no_buffer" else S + 37
    x = rng.normal(size=(B, T, 3))
    vix = 20.0 + rng.normal(size=(B, T))
    irx = rng.random((B, T))
    regime = rng.integers(0, 2, (B, T)).astype(np.int32)
    if case == "zero" or case == "no_buffer":
        offs = np.zeros(B, np.int32)
    elif case == "max":
        offs = np.full(B, T - S, np.int32)
    else:
        offs = rng.integers(0, T - S + 1, B).astype(np.int32)
        offs[0], offs[1] = 0, T - S
        x[2, offs[2] + 5, 1] = np.nan
        vix[3, offs[3] + S - 1] = np.inf
    got = window_series(jnp.asarray(x), jnp.asarray(vix), jnp.asarray(irx),
                        jnp.asarray(regime), jnp.asarray(offs), S)
    want = [np.stack([a[b, o:o + S] for b, o in enumerate(offs)])
            for a in (x[..., 0], x[..., 1], x[..., 2], vix, irx, regime)]
    for name, g, w in zip(("spy", "qqq", "tlt", "vix", "irx", "regime"),
                          got, want):
        assert g.shape == (B, S), name
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=name)
    assert np.asarray(got[5]).dtype == np.int32
