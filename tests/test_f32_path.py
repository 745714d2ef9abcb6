"""The float32 path the GPU runs, against the float64 run on the same inputs.

The suite runs in float64 (conftest); the GPU runs float32. Random draws
depend on the precision, so each test draws its inputs once in float64,
casts them to float32, and runs the device code twice: under
``jax.enable_x64(False)`` on the float32 copy, and in float64 on the
original. What remains is float32 rounding, compounded over the days,
and the rare rebalance threshold that one precision crosses and the
other does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from letf_tpu import config as cfg
from letf_tpu.models.params import default_sim_model
from letf_tpu.ops.path_batched import (
    draw_innovations_batched,
    path_from_innovations_batched,
)
from letf_tpu.strategies.engine import run_strategies_batch
from letf_tpu.strategies.signals import compute_signals

B, YEARS, BUFFER = 32, 2, 126
S = YEARS * cfg.TRADING_DAYS


def _host(tree):
    """Every array leaf as a NumPy array (keys dropped to None)."""
    def leaf(a):
        if a is None or not hasattr(a, "dtype"):
            return a
        if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
            return None
        return np.asarray(a)
    return jax.tree.map(leaf, tree, is_leaf=lambda a: a is None)


def _as(tree, dt):
    """Float leaves cast to dt (NumPy), everything else unchanged."""
    return jax.tree.map(
        lambda a: a.astype(dt) if isinstance(a, np.ndarray)
        and np.issubdtype(a.dtype, np.floating) else a, tree,
        is_leaf=lambda a: a is None)


def _rel(a32, a64):
    a32 = np.asarray(a32, np.float64)
    a64 = np.asarray(a64, np.float64)
    return np.abs(a32 - a64) / np.maximum(np.abs(a64), 1.0)


def _chunk(model, innov, emit_trades=False):
    path = path_from_innovations_batched(model, innov, S)
    res = run_strategies_batch(path, compute_signals(path), apply_costs=True,
                               emit_trades=emit_trades)
    return path, res


@pytest.fixture(scope="module")
def runs():
    """Paths -> signals -> strategies for B trials x 2y, f32 and f64, from
    one set of float64 innovations (with the 'offset' random start)."""
    model = _host(default_sim_model())
    ids = jnp.arange(B, dtype=jnp.int32) // 2
    anti = (jnp.arange(B) % 2).astype(bool)
    innov = jax.jit(draw_innovations_batched, static_argnums=(4, 5, 6))(
        model, jax.random.key(21), ids, anti, S, BUFFER, "offset")
    innov = _host(innov._replace(mode_key=None))
    run = jax.jit(_chunk, static_argnames=("emit_trades",))
    p64, r64 = run(model, innov, emit_trades=True)
    with jax.enable_x64(False):
        p32, r32 = run(_as(model, np.float32), _as(innov, np.float32))
        r32 = _host(r32)
    assert np.asarray(r32.final_wealth).dtype == np.float32
    assert np.asarray(r64.final_wealth).dtype == np.float64
    return _host(r32), _host(r64), _host(p64)


@pytest.mark.parametrize(
    "sid", sorted(cfg.STRATEGY_INDEX, key=cfg.STRATEGY_INDEX.get))
def test_strategy_f32_matches_f64(runs, sid):
    r32, r64, _ = runs
    k = cfg.STRATEGY_INDEX[sid]
    rel = _rel(r32.final_wealth[:, k], r64.final_wealth[:, k])
    # Typical trial: float32 rounding over 504 days (~1e-6).
    assert np.median(rel) <= 1e-5, (sid, np.median(rel))
    # A one-precision threshold crossing moves a trial further; allow
    # two of the 32.
    assert np.mean(rel <= 1e-3) >= 30 / 32, (sid, np.sort(rel)[-4:])
    assert np.mean(r32.num_trades[:, k] == r64.num_trades[:, k]) >= 30 / 32
    dd = np.abs(r32.max_dd[:, k] - r64.max_dd[:, k])
    assert np.median(dd) <= 1e-5, (sid, np.median(dd))


@pytest.mark.parametrize("method", ["FIFO", "LIFO", "HIFO", "LOFO", "LTFO",
                                    "STFO", "MINTAX"])
def test_lot_election_f32_matches_f64(runs, method):
    """The device tax bridge on one strategy's trade emission (S7, the
    busiest trader), f32 vs f64, for every lot election."""
    from letf_tpu.tax.device_bridge import (
        max_buy_events,
        yearly_activity_from_emission,
    )

    _, r64, _ = runs
    col = 0                                                 # S7
    em = tuple(np.asarray(a[:, :, col]) for a in
               (r64.tj_alloc, r64.tj_value, r64.tj_price, r64.tj_asset))
    cap = None if method == "FIFO" else (
        -(-max_buy_events(*em) // 64) * 64)
    a64, n64 = yearly_activity_from_emission(
        *em, n_years=YEARS, method=method, lot_capacity=cap)
    with jax.enable_x64(False):
        a32, n32 = yearly_activity_from_emission(
            *_as(em, np.float32), n_years=YEARS, method=method,
            lot_capacity=cap)
        a32 = np.asarray(a32)
    assert a32.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(n32), np.asarray(n64))
    # Dollar gains/losses per (trial, year): f32 keeps ~7 digits of
    # share counts and prices.
    np.testing.assert_allclose(a32, np.asarray(a64), rtol=1e-4, atol=0.5,
                               err_msg=method)


@pytest.mark.parametrize("fan", ["wealth", "cagr", "drawdown"])
def test_report_fan_f32_matches_f64(runs, fan):
    """The report's fans (ops/reductions.py) over the f32 and f64
    strategy results: percentiles of 32 trials per strategy."""
    from letf_tpu.ops.reductions import percentile_fan, wealth_to_cagr

    r32, r64, _ = runs

    def fans(r):
        if fan == "drawdown":
            return jnp.median(jnp.asarray(r.max_dd), axis=0)
        w = percentile_fan(jnp.asarray(r.final_wealth))
        if fan == "cagr":
            w = wealth_to_cagr(w, cfg.INITIAL_CAPITAL, YEARS)
        return w

    want = np.asarray(fans(r64))
    with jax.enable_x64(False):
        got = np.asarray(fans(_as(r32, np.float32)))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4, err_msg=fan)


@pytest.mark.parametrize("start", ["offset", "none"])
@pytest.mark.parametrize("engine", ["batched", "institutional_v1",
                                    "parametric"])
def test_path_engine_f32_matches_f64(engine, start):
    """Path generation alone, on shared innovations: the production
    batched engine and the per-trial engine's two synthetic modes."""
    from letf_tpu.ops.path_engine import draw_innovations, path_from_innovations

    model = _host(default_sim_model())
    n, days = 8, cfg.TRADING_DAYS
    buf = BUFFER if start == "offset" else 0
    ids = jnp.arange(n, dtype=jnp.int32) // 2
    anti = (jnp.arange(n) % 2).astype(bool)
    key = jax.random.key(5)
    if engine == "batched":
        innov = jax.jit(draw_innovations_batched, static_argnums=(4, 5, 6))(
            model, key, ids, anti, days, buf, start)
        innov = _host(innov._replace(mode_key=None))

        def path_fn(m, i):
            return path_from_innovations_batched(m, i, days)
    else:
        innov = jax.jit(jax.vmap(
            lambda t, a: draw_innovations(model, key, t, a, days, buf,
                                          start)))(ids, anti)
        mode_keys = innov.mode_key
        innov = _host(innov._replace(mode_key=None))

        def path_fn(m, i):
            return jax.vmap(lambda x, k: path_from_innovations(
                m, x._replace(mode_key=k), days, engine_mode=engine))(
                    i, mode_keys)

    run = jax.jit(path_fn)
    p64 = _host(run(model, innov))
    with jax.enable_x64(False):
        p32 = _host(run(_as(model, np.float32), _as(innov, np.float32)))
    assert p32.etf_ret.dtype == np.float32
    assert p32.etf_ret.shape == (n, days, cfg.N_ASSETS)
    np.testing.assert_array_equal(p32.regime, p64.regime)
    np.testing.assert_array_equal(p32.start_offset, p64.start_offset)
    # Daily returns: f32 rounding through the GARCH/VIX recursions.
    np.testing.assert_allclose(p32.etf_ret, p64.etf_ret, rtol=0.0,
                               atol=5e-6)
    np.testing.assert_allclose(p32.vix, p64.vix, rtol=1e-4, atol=1e-3)
    lw32 = np.log1p(p32.etf_ret.astype(np.float64)).sum(axis=1)
    lw64 = np.log1p(p64.etf_ret).sum(axis=1)
    np.testing.assert_allclose(lw32, lw64, rtol=0.0, atol=1e-4)


@pytest.mark.gpu
def test_chunk_gpu_matches_cpu_f32(gpu_device):
    """The same float32 chunk (shared innovations) on the GPU and on the
    host CPU: the card's compiled code against XLA:CPU's."""
    model = _as(_host(default_sim_model()), np.float32)
    ids = jnp.arange(B, dtype=jnp.int32) // 2
    anti = (jnp.arange(B) % 2).astype(bool)
    with jax.enable_x64(False):
        innov = jax.jit(draw_innovations_batched, static_argnums=(4, 5, 6))(
            model, jax.random.key(21), ids, anti, S, BUFFER, "offset")
        innov = _host(innov._replace(mode_key=None))
        out = {}
        for dev in (gpu_device, jax.devices("cpu")[0]):
            args = jax.device_put((model, innov), dev)
            out[dev.platform] = _host(jax.jit(_chunk)(*args)[1])
    rel = _rel(out["gpu"].final_wealth, out["cpu"].final_wealth)
    assert np.median(rel) <= 1e-5
    assert np.mean(rel <= 1e-3) >= 0.95
