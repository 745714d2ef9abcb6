"""Chip smoke test: the main path once, at full size, on one GPU.

    python chip_smoke.py               # one GPU: all single-card phases
    python chip_smoke.py --four-cards  # four GPUs: sharded vs one-card only

Phases (one process, in order; the first failure ends the run with a
traceback and a non-zero exit, and nothing is caught and carried on past):

1. device     -- JAX's default device must be a GPU (no CPU fallback);
                 prints its kind, the device count and nvidia-smi's card
                 name and power limit.
2. headline   -- gbm_percentile_report, 1,048,576 trials x 30y buy-and-hold,
                 against the lognormal law computed by quadrature.
3. report     -- monte_carlo_report, REPORT_TRIALS x 30y, 19 strategies,
                 6 assets, 5y random-start buffer, sampled post-tax tables.
4. parity     -- run_monte_carlo on the GPU vs the same program on the host
                 CPU in this process (same trial ids and seed); batched path
                 generation on the GPU vs the float64 NumPy oracle.
5. exact_tax  -- exact_post_tax_all_trials, one FIFO 2048 x 30y chunk over
                 the 13 taxable strategies, timed; 256 trials on GPU vs CPU;
                 the golden tax tests.

``--four-cards`` runs only: monte_carlo_report and run_monte_carlo's
per-trial results on a 4-GPU trial mesh vs a 1-GPU mesh, and the sharded
FIFO exact-tax chunk (FOUR_CARD_TAX_TRIALS per device) vs the same trials
in single-device chunks of that size.

Times printed here are single observations (compile and warm run apart).
The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from letf_tpu import config as cfg

YEARS = 30
HEADLINE_TRIALS = 1_048_576
REPORT_TRIALS = 1_048_576
PARITY_TRIALS = 1024
ORACLE_TRIALS, ORACLE_YEARS = 64, 2
TAX_TRIALS, TAX_PARITY_TRIALS = 2048, 256
FOUR_CARD_TRIALS, FOUR_CARD_TAX_TRIALS = 262_144, 2048
BUFFER_DAYS = int(cfg.RANDOM_START_BUFFER_YEARS * cfg.TRADING_DAYS)


class SmokeFailure(AssertionError):
    """A check on the chip's output failed."""


# ---------------------------------------------------------------------------
# Checks: each prints its measured error beside its tolerance and reason.
# ---------------------------------------------------------------------------


def check_close(name: str, got, want, rtol: float, atol: float,
                why: str) -> float:
    """|got - want| <= atol + rtol * |want| elementwise (non-finite values
    must coincide). Prints the worst error; raises SmokeFailure on a
    mismatch. Returns the worst absolute error."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {got.shape} != {want.shape}")
    fin = np.isfinite(want)
    same_fin = bool(np.array_equal(np.isfinite(got), fin))
    err = np.where(fin, np.abs(got - want), 0.0)
    excess = err - (atol + rtol * np.abs(np.where(fin, want, 0.0)))
    worst = float(err.max()) if err.size else 0.0
    ok = same_fin and not bool((excess > 0).any())
    print(f"CHECK {name}: max|d| {worst:.3e} vs atol {atol:g} + rtol "
          f"{rtol:g}*|ref| ({why}) -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: max|d| {worst:.3e} over tolerance"
                           + ("" if same_fin else "; finiteness differs"))
    return worst


def check_share(name: str, share: float, min_share: float,
                why: str) -> None:
    """share >= min_share, printed with its reason."""
    ok = share >= min_share
    print(f"CHECK {name}: {share:.6f} >= {min_share:g} ({why}) -> "
          f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: {share:.6f} < {min_share:g}")


def check_true(name: str, ok: bool, detail: str) -> None:
    print(f"CHECK {name}: {detail} -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: {detail}")


def wealth_rel_err(got, want):
    """Relative final-wealth error per trial; wealth near ruin compares
    against $1 (initial capital is $10,000)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(np.abs(want), 1.0)


def result_line(kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": kind, "count": count}})


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def require_gpu(devices, n: int = 1):
    """The first n devices, which must all be GPUs."""
    if len(devices) < n or any(d.platform != "gpu" for d in devices[:n]):
        raise SmokeFailure(
            f"need {n} GPU device(s); JAX reports "
            f"{[d.platform for d in devices]}")
    return devices[:n]


def phase_device(n: int):
    devs = require_gpu(jax.devices(), n)
    print(f"device: platform {devs[0].platform}, kind {devs[0].device_kind}, "
          f"count {len(jax.devices())}")
    # A child that never imports JAX reads the card's name and limit.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print("nvidia-smi (name, power.limit):")
    for line in smi.stdout.strip().splitlines():
        print(line)
    return devs


def _lognormal_moments(mu, sigma, leverage, daily_cost):
    """Mean and std of one day's log-wealth increment of gbm_buyhold,
    log1p(max(L(mu + sigma z) - c, -0.999)), by Gauss-Hermite quadrature."""
    z, w = np.polynomial.hermite_e.hermegauss(96)
    w = w / w.sum()
    inc = np.log1p(np.maximum(leverage * (mu + sigma * z) - daily_cost,
                              -0.999))
    m = float((w * inc).sum())
    return m, float(np.sqrt((w * (inc - m) ** 2).sum()))


def phase_headline():
    from letf_tpu.ops.buyhold import gbm_percentile_report

    n, years = HEADLINE_TRIALS, YEARS
    t0 = time.perf_counter()
    gbm_percentile_report(0, n, years)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = gbm_percentile_report(1, n, years)
    warm = time.perf_counter() - t0
    days = years * 252
    print(f"headline buy-and-hold {n:,} x {years}y: first call {cold:.3f} s "
          f"(compile + run), warm {warm:.4f} s, "
          f"{n * days / warm:.4g} path-days/s")
    # gbm_percentile_report defaults: 10% drift, 24% vol, 3x, 0.86% fee.
    m, s = _lognormal_moments(0.10 / 252, 0.24 / math.sqrt(252), 3.0,
                              0.0086 / 252)
    mean, std = days * m, math.sqrt(days) * s
    zq = {"p10": -1.2815516, "p50": 0.0, "p90": 1.2815516}
    got = [math.log(rep["percentiles"][k]) for k in zq]
    want = [mean + q * std for q in zq.values()]
    # Sampling s.e. of these quantiles of log wealth at 1M trials is
    # <= 0.0066; the sum of 7560 i.i.d. days is normal to within a
    # Cornish-Fisher skew term of ~0.001.
    check_close("headline log-wealth p10/p50/p90 vs lognormal law", got,
                want, rtol=0.0, atol=0.05,
                why="6 sampling s.e. + skew term of the 7560-day sum")
    return warm


def _finite_report_values(rep):
    vals = []
    for sid, st in rep["strategies"].items():
        for fan in ("wealth", "cagr"):
            vals += list(st[fan].values())
        vals += [st["median_max_dd"], st["trades_per_year"]]
        if "post_tax" in st:
            vals += list(st["post_tax"]["wealth"].values())
            vals.append(st["post_tax"]["median_tax"])
    return np.asarray(vals, np.float64)


def phase_report(device):
    from letf_tpu.models.params import default_sim_model
    from letf_tpu.parallel.mc_runner import monte_carlo_report

    model = default_sim_model()
    n = REPORT_TRIALS
    kw = dict(num_simulations=n, seed=2, tax_mode="sampled")
    t0 = time.perf_counter()
    monte_carlo_report(model, YEARS, **kw)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = monte_carlo_report(model, YEARS, **kw)
    warm = time.perf_counter() - t0
    peak = (device.memory_stats() or {}).get("peak_bytes_in_use")
    days = YEARS * cfg.TRADING_DAYS
    print(f"report {n:,} x {YEARS}y (19 strategies, {cfg.N_ASSETS} assets, "
          f"+{BUFFER_DAYS}-day buffer, sampled post-tax): first call "
          f"{cold:.2f} s (compile + run), warm {warm:.2f} s "
          f"(post-tax part {rep['post_tax_seconds']} s), "
          f"{n * days / warm:.4g} path-days/s (simulated days), "
          f"peak_bytes_in_use {peak}")
    for k in ("valid_frac", "repaired_frac", "finite_frac", "vix_ok_frac"):
        print(f"  {k}: {rep[k]!r} ({round(rep[k] * n)} of {n:,} trials)")
    s1 = rep["strategies"]["S1"]
    print(f"  S1 (TQQQ buy-and-hold) wealth p50 {s1['wealth']['p50']:.2f}, "
          f"ruin share {s1['ruin_frac']:.4f}")
    check_true("report strategies", sorted(rep["strategies"]) ==
               sorted(cfg.STRATEGY_INDEX),
               f"{len(rep['strategies'])} of {cfg.N_STRATEGIES} present")
    taxed = [s for s in cfg.TAXABLE_IDS if "post_tax" in rep["strategies"][s]]
    check_true("report post-tax tables", len(taxed) == len(cfg.TAXABLE_IDS),
               f"{len(taxed)} of {len(cfg.TAXABLE_IDS)} taxable strategies")
    vals = _finite_report_values(rep)
    check_true("report fans finite", bool(np.isfinite(vals).all()),
               f"{int(np.isfinite(vals).sum())} of {vals.size} values")
    check_true("report path_finite share", rep["finite_frac"] == 1.0,
               f"finite_frac {rep['finite_frac']!r}")
    return warm


def run_parity(gpu, cpu, n_trials: int, years: int):
    """run_monte_carlo for trials [0, n_trials) on `gpu` and on `cpu`;
    returns (gpu MCArrays, cpu MCArrays). The GPU run is chunk-guarded
    (fault_tolerant) so a failed chunk shows as flagged, never silently."""
    from letf_tpu.models.params import default_sim_model
    from letf_tpu.parallel.mc_runner import run_monte_carlo
    from letf_tpu.parallel.mesh import trial_mesh

    model = default_sim_model()
    kw = dict(num_simulations=n_trials, seed=7, chunk_size=n_trials,
              progress=False)
    with jax.default_device(gpu):
        g = run_monte_carlo(model, years, mesh=trial_mesh([gpu]),
                            fault_tolerant=True, chunk_timeout=None,
                            chunk_retries=0, **kw)
    with jax.default_device(cpu):
        c = run_monte_carlo(model, years, mesh=trial_mesh([cpu]), **kw)
    return g, c


def compare_parity(g, c) -> None:
    """GPU vs CPU run of the same f32 program. Transcendentals differ by a
    few ulps between backends and sums run in another order; over 7560
    compounding days that leaves ~1e-5 relative wealth noise in the
    typical trial. A rebalance threshold crossed on one backend only
    moves that trial's later trades, so per-trial maxima and trade-count
    equality are printed but only the typical trial, the share of
    trials and the aggregates are held to a tolerance."""
    failed = int(np.asarray(g.chunk_failed).sum())
    check_true("parity failed chunks", failed == 0, f"{failed} flagged")
    rel = wealth_rel_err(g.final_wealth, c.final_wealth)       # [N, 19]
    mdd = np.abs(np.asarray(g.max_dd, np.float64)
                 - np.asarray(c.max_dd, np.float64))
    nt_g = np.asarray(g.num_trades, np.int64)
    nt_c = np.asarray(c.num_trades, np.int64)
    for sid in sorted(cfg.STRATEGY_INDEX, key=cfg.STRATEGY_INDEX.get):
        k = cfg.STRATEGY_INDEX[sid]
        print(f"  {sid}: final wealth rel err median {np.median(rel[:, k]):.3e}"
              f" max {rel[:, k].max():.3e}; max drawdown |d| median "
              f"{np.median(mdd[:, k]):.3e} max {mdd[:, k].max():.3e}; "
              f"trade counts agree {np.mean(nt_g[:, k] == nt_c[:, k]):.4f}")
    check_close("parity per-strategy median final-wealth rel err",
                np.median(rel, axis=0), np.zeros(rel.shape[1]), rtol=0.0,
                atol=1e-3, why="typical trial: f32 ulp noise compounded "
                               "over 7560 days, ~1e-5")
    check_share("parity final wealth rel err <= 1e-2 (share of trial x "
                "strategy)", float(np.mean(rel <= 1e-2)), 0.95,
                "a one-backend threshold crossing moves a trial by more")
    q = (10, 50, 90)
    check_close("parity final-wealth fan p10/p50/p90 per strategy",
                np.percentile(g.final_wealth, q, axis=0),
                np.percentile(c.final_wealth, q, axis=0), rtol=2e-2,
                atol=1.0, why="order statistics of 1024 trials; a flipped "
                              "trial can swap one rank")
    check_close("parity per-strategy median max-drawdown |d|",
                np.median(mdd, axis=0), np.zeros(mdd.shape[1]), rtol=0.0,
                atol=1e-3, why="ratios of the same equity curves")
    check_close("parity total trades per strategy", nt_g.sum(axis=0),
                nt_c.sum(axis=0), rtol=1e-2, atol=0.0,
                why="a threshold crossing adds or drops a trade or two in "
                    "a trial")
    check_true("parity path_finite flags equal",
               bool(np.array_equal(g.path_finite, c.path_finite)),
               f"{int(np.sum(g.path_finite))} vs {int(np.sum(c.path_finite))}"
               " finite trials")
    check_share("parity valid flags agree", float(np.mean(g.valid == c.valid)),
                0.99, "VIX-range check; a VIX extreme within ulps of 5 or "
                      "120 may flip")


def run_oracle(device, n_trials: int, years: int):
    """Batched path generation on `device` (ambient precision) from
    per-trial innovations, and the float64 NumPy oracle on the same
    innovations. Returns (device etf_ret [B, S, A], oracle etf_ret,
    device vix, oracle vix)."""
    from letf_tpu import oracle
    from letf_tpu.models.params import default_sim_model
    from letf_tpu.ops.path_batched import (
        draw_innovations_batched,
        path_from_innovations_batched,
    )

    model = default_sim_model()
    sim_days = years * cfg.TRADING_DAYS
    ids = jnp.arange(n_trials, dtype=jnp.int32) // 2
    anti = (jnp.arange(n_trials) % 2).astype(bool)
    with jax.default_device(device):
        innov = jax.jit(draw_innovations_batched, static_argnums=(4, 5, 6))(
            model, jax.random.key(11), ids, anti, sim_days, BUFFER_DAYS,
            "offset")
        path = jax.jit(path_from_innovations_batched, static_argnums=(2,))(
            model, innov, sim_days)
    host = jax.tree.map(np.asarray, innov._replace(mode_key=None))
    orc = [oracle.oracle_path(model, jax.tree.map(lambda a: a[b], host),
                              sim_days) for b in range(n_trials)]
    return (np.asarray(path.etf_ret), np.stack([o["etf_ret"] for o in orc]),
            np.asarray(path.vix), np.stack([o["vix"] for o in orc]))


def compare_oracle(etf, etf_o, vix, vix_o) -> None:
    """f32 path generation vs the float64 oracle on shared innovations.
    f32 rounding (~6e-8 relative) grows through the GARCH/DCC/VIX
    recursions over 1764 days to ~1e-6 on daily returns. With the
    contractions at TF32 (2^-11 relative) an H100 read 3.4e-4 on daily
    returns and 3.8e-2 on 2y log wealth, far over both limits."""
    check_close("oracle daily LETF returns (f32 vs f64 oracle)", etf, etf_o,
                rtol=0.0, atol=5e-6,
                why="f32 recursion drift over 1764 days; TF32 reads ~3e-4")
    check_close("oracle VIX", vix, vix_o, rtol=1e-4, atol=1e-3,
                why="VIX AR(1) recursion in f32")
    lw = np.log1p(etf).sum(axis=1)
    lw_o = np.log1p(etf_o).sum(axis=1)
    check_close("oracle 2y log wealth per asset", lw, lw_o, rtol=0.0,
                atol=1e-4, why="504 daily f32 roundings of ~1e-7")


def run_exact_tax(device, n_trials: int, seed: int = 4, mesh=None,
                  chunk_size: int | None = None):
    from letf_tpu.models.params import default_sim_model
    from letf_tpu.reporting import exact_post_tax_all_trials

    with jax.default_device(device):
        return exact_post_tax_all_trials(
            default_sim_model(), YEARS, n_trials,
            chunk_size=chunk_size or n_trials, seed=seed, mesh=mesh)


def compare_tax_tables(got, want, rtol: float, why: str,
                       name: str = "exact tax") -> None:
    """Every reported field: integers equal, floats within rtol (atol $1)."""
    check_true(f"{name} strategies", sorted(got) == sorted(want),
               f"{len(got)} strategies")
    check_true(f"{name} fields", all(sorted(got[s]) == sorted(want[s])
                                     for s in want),
               f"{len(next(iter(want.values())))} per strategy")
    ints, fg, fw = [], [], []
    for sid in sorted(want):
        for k, v in want[sid].items():
            if isinstance(v, float):
                fg.append(got[sid][k])
                fw.append(v)
            else:
                ints.append(got[sid][k] == v)
    check_true(f"{name} integer fields equal", all(ints),
               f"{sum(ints)} of {len(ints)}")
    check_close(f"{name} float fields", fg, fw, rtol=rtol, atol=1.0, why=why)


def emission_on(device, n_trials: int, years: int, seed: int = 6):
    """The strategy scan's trade emission for trials [0, n_trials), run
    on `device`, as host arrays (tj_alloc, tj_value, tj_price, tj_asset),
    each [days, n_trials, 13 taxable strategies]."""
    from letf_tpu.models.params import default_sim_model
    from letf_tpu.parallel.mc_runner import _mc_chunk, _trial_layout

    ids, anti = _trial_layout(n_trials, cfg.USE_ANTITHETIC_VARIATES)
    with jax.default_device(device):
        _, emission = _mc_chunk(
            jax.tree.map(jnp.asarray, default_sim_model()),
            jax.random.key(seed), jnp.asarray(ids, jnp.int32),
            jnp.asarray(anti), years * cfg.TRADING_DAYS, BUFFER_DAYS,
            random_start_method="offset", apply_costs=True, emit_trades=True)
    return tuple(np.asarray(e) for e in emission)


def bridge_tax_on(device, emission, years: int):
    """Device tax path (FIFO wash-sale/lot bridge + netting) for the 12
    single-leg taxable strategies folded into one batch, on `device`.
    Returns per-(trial, strategy) total tax [B * 12]."""
    from letf_tpu.income import simulate_wired_income_path
    from letf_tpu.tax.device_bridge import yearly_activity_from_emission
    from letf_tpu.tax.vectorized import total_tax_all_trials

    cols = [i for i, s in enumerate(cfg.TAXABLE_IDS) if s != "S8"]
    days = emission[0].shape[0]
    folded = [jax.device_put(e[:, :, cols].reshape(days, -1), device)
              for e in emission]
    income = jax.device_put(
        np.asarray(simulate_wired_income_path(150000, years, seed=42)), device)
    act, n_trades, skipped = yearly_activity_from_emission(
        *folded, n_years=years, assets=(0,))
    tax = total_tax_all_trials(act[..., :4], income, cfg.INITIAL_CAPITAL,
                               n_trades.astype(act.dtype) / years)
    check_true(f"bridge static asset claim on {device.platform}",
               not bool(skipped), "no skipped leg sold shares")
    return np.asarray(tax["total_tax"], np.float64)


def phase_exact_tax(gpu, cpu):
    from letf_tpu.tax import run_golden_tests

    t0 = time.perf_counter()
    run_exact_tax(gpu, TAX_TRIALS, seed=3)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run_exact_tax(gpu, TAX_TRIALS, seed=4)
    warm = time.perf_counter() - t0
    print(f"exact tax FIFO {TAX_TRIALS} x {YEARS}y x {len(out)} strategies: "
          f"first call {cold:.2f} s (compile + run), warm {warm:.2f} s")
    nonfin = sum(e["nonfinite_trials"] for e in out.values())
    check_true("exact tax finite", nonfin == 0, f"{nonfin} non-finite trials")
    # The tax path alone, GPU vs CPU on one shared emission: identical
    # trades, so only f32 summation order differs (cumulative share
    # curves, bracket sums).
    emission = emission_on(cpu, TAX_PARITY_TRIALS, YEARS)
    tg, tc = bridge_tax_on(gpu, emission, YEARS), bridge_tax_on(cpu, emission,
                                                                YEARS)
    d = np.abs(tg - tc)
    print(f"  bridge tax on shared emission: {tc.size} trial x strategy "
          f"cells, |d| median {np.median(d):.3e} max {d.max():.3e} dollars")
    check_share("bridge tax GPU vs CPU within $1 + 1e-4*|tax|",
                float(np.mean(d <= 1.0 + 1e-4 * np.abs(tc))), 0.99,
                "f32 summation order; a lot boundary met within ulps can "
                "move one sale to the next lot")
    # End to end at 256 trials: emission itself differs by threshold
    # crossings over 7560 days (see compare_parity).
    compare_tax_tables(run_exact_tax(gpu, TAX_PARITY_TRIALS),
                       run_exact_tax(cpu, TAX_PARITY_TRIALS), rtol=5e-2,
                       why="percentiles of 256 trials; a one-backend "
                           "threshold crossing changes a trial's trades and "
                           "can swap one rank",
                       name="exact tax GPU vs CPU")
    res = run_golden_tests()
    check_true("golden tax tests", res["failed"] == 0,
               f"{res['passed']}/{res['total']} passed")
    return warm


def _flat(d, path=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _flat(v, f"{path}.{k}")
    else:
        yield path, d


def print_field_diffs(name: str, got: dict, want: dict, keys,
                      rtol: float, top: int = 8) -> None:
    """The `top` float fields furthest over atol 1e-9 + rtol*|want|, with
    both values, so a failed comparison names what differs."""
    rows = []
    for k in keys:
        d = abs(got[k] - want[k])
        if d > 1e-9 + rtol * abs(want[k]):
            rows.append((d / max(abs(want[k]), 1e-30), k))
    print(f"  {name}: {len(rows)} of {len(keys)} fields over tolerance")
    for rel, k in sorted(rows, reverse=True)[:top]:
        print(f"    {k}: {got[k]!r} vs {want[k]!r} (rel {rel:.3e})")


def compare_trials(a, b, name: str) -> None:
    """Per trial, two runs of the same trial ids: integers equal, final
    wealth and drawdown within rtol 1e-5. Prints the bitwise-equal shares,
    which are what a sharded run of an unchanged per-device program
    should give."""
    fw_a, fw_b = (np.asarray(x.final_wealth) for x in (a, b))
    eq = fw_a == fw_b
    print(f"  {name}: final wealth bitwise equal in "
          f"{float(np.mean(eq)):.6f} of trial x strategy cells, "
          f"{float(np.mean(eq.all(axis=1))):.6f} of trials; max rel err "
          f"{float(wealth_rel_err(fw_a, fw_b).max()):.3e}")
    for fld in ("num_trades", "valid", "path_finite", "start_offset"):
        check_true(f"{name} {fld} equal",
                   bool(np.array_equal(getattr(a, fld), getattr(b, fld))),
                   f"{int(np.sum(getattr(a, fld) != getattr(b, fld)))} "
                   "cells differ")
    for fld in ("final_wealth", "max_dd"):
        check_close(f"{name} {fld}", getattr(a, fld), getattr(b, fld),
                    rtol=1e-5, atol=1e-9, why="SPMD fusion/reduction order")


def phase_four_cards(devs):
    """Sharded == single, at the tolerance of __graft_entry__'s dry run:
    integers equal, floats within rtol 1e-5 (SPMD partitioning can move
    fusion and reduction order by a few ulps). Both sides give each
    device the same per-device batch (the default chunk is
    DEVICE_CHUNK_TRIALS per device; the exact-tax chunk is
    FOUR_CARD_TAX_TRIALS per device), so each device runs the program a
    one-device run compiles.

    Every comparison runs and prints before the phase fails, so one run
    shows where a mismatch starts: per trial (run_monte_carlo through
    the same resident programs), in each mesh's repeated report, in the
    report, or in the exact-tax chunk."""
    from letf_tpu.models.params import default_sim_model
    from letf_tpu.parallel.mc_runner import monte_carlo_report, run_monte_carlo
    from letf_tpu.parallel.mesh import trial_mesh

    model = default_sim_model()
    kw = dict(num_simulations=FOUR_CARD_TRIALS, seed=5)
    meshes = {"4-GPU": trial_mesh(devs), "1-GPU": trial_mesh(devs[:1])}
    failures = []

    def soft(check, *args, **kwargs):
        try:
            check(*args, **kwargs)
        except SmokeFailure as e:
            failures.append(str(e))

    timings, reps, firsts, trials = {}, {}, {}, {}
    for label, mesh in meshes.items():
        firsts[label] = monte_carlo_report(model, YEARS, mesh=mesh,
                                           tax_mode="sampled", **kw)
        t0 = time.perf_counter()
        reps[label] = monte_carlo_report(model, YEARS, mesh=mesh,
                                         tax_mode="sampled", **kw)
        timings[label] = time.perf_counter() - t0
        for r in (firsts[label], reps[label]):
            r.pop("post_tax_seconds")
        trials[label] = run_monte_carlo(model, YEARS, mesh=mesh,
                                        progress=False, **kw)
    print(f"four cards: report {FOUR_CARD_TRIALS:,} x {YEARS}y warm "
          f"{timings['4-GPU']:.2f} s on 4 GPUs vs {timings['1-GPU']:.2f} s "
          "on 1 GPU")
    soft(compare_trials, trials["4-GPU"], trials["1-GPU"],
         "four cards per-trial")
    for label in meshes:
        print(f"  {label} report repeated: "
              f"{'identical' if firsts[label] == reps[label] else 'DIFFERS'}")
    f4, f1 = dict(_flat(reps["4-GPU"])), dict(_flat(reps["1-GPU"]))
    soft(check_true, "four cards report keys", f4.keys() == f1.keys(),
         f"{len(f1)} fields")
    fl = [k for k, v in f1.items() if isinstance(v, float) and k in f4]
    soft(check_true, "four cards report non-float fields equal",
         all(f4.get(k) == v for k, v in f1.items()
             if not isinstance(v, float)), "ints, strings, lists")
    print_field_diffs("four cards report", f4, f1, fl, rtol=1e-5)
    soft(check_close, "four cards report floats", [f4[k] for k in fl],
         [f1[k] for k in fl], rtol=1e-5, atol=1e-9,
         why="SPMD fusion/reduction order")
    n_tax = FOUR_CARD_TAX_TRIALS * len(devs)
    t0 = time.perf_counter()
    tax4 = run_exact_tax(devs[0], n_tax, mesh=meshes["4-GPU"])
    dt4 = time.perf_counter() - t0
    tax1 = run_exact_tax(devs[0], n_tax, chunk_size=FOUR_CARD_TAX_TRIALS)
    print(f"four cards: sharded exact-tax chunk {n_tax} x {YEARS}y "
          f"({FOUR_CARD_TAX_TRIALS} per device) first call {dt4:.2f} s")
    soft(compare_tax_tables, tax4, tax1, rtol=1e-5,
         why="SPMD fusion/reduction order", name="four cards exact tax")
    if failures:
        raise SmokeFailure("; ".join(failures))


def phases(four_cards: bool):
    """Names of the phases a run executes, in order."""
    if four_cards:
        return ["device", "four_cards"]
    return ["device", "headline", "report", "parity", "exact_tax"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-GPU sharded vs 1-GPU comparison")
    args = p.parse_args(argv)

    from letf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n_cards = 4 if args.four_cards else 1
    devs = None
    for name in phases(args.four_cards):
        print(f"== phase {name}", flush=True)
        if name == "device":
            devs = phase_device(n_cards)
        elif name == "headline":
            phase_headline()
        elif name == "report":
            phase_report(devs[0])
        elif name == "parity":
            cpu = jax.devices("cpu")[0]
            compare_parity(*run_parity(devs[0], cpu, PARITY_TRIALS, YEARS))
            compare_oracle(*run_oracle(devs[0], ORACLE_TRIALS, ORACLE_YEARS))
        elif name == "exact_tax":
            phase_exact_tax(devs[0], jax.devices("cpu")[0])
        elif name == "four_cards":
            phase_four_cards(devs)
    print(result_line(devs[0].device_kind, len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
