"""Benchmark: measurement stages on the GPU, one JSON line out.

    python bench.py                      # every stage, in order

Each stage runs in its own subprocess (``python bench.py --stage NAME``),
one at a time, so exactly one process holds the card and a stage that
fails or hangs costs only itself. The parent never imports JAX. A stage
that finds no GPU fails; there is no CPU fallback and no carried-over
result. The full record (every stage's output, with the platform, device
kind and device count it ran on) is written to ``--record``; stdout gets
one compact JSON line at the end.

Stages (the 1M x 30y buy-and-hold headline, the 1M x 30y report and the
exact-tax chunk are timed by chip_smoke.py, not here):
- long_horizon: one full-engine chunk at 50y
- calibrated_flagship: the 1M x 30y report under the calibrated model
- distribution: calibrated CAGR fans vs rolling history (quality scores
  and median-gap bands)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RESULT_PREFIX = "BENCH_STAGE_RESULT "
STAGE_TIMEOUT_S = 3000.0   # a stage that hangs is killed and recorded


# ---------------------------------------------------------------------------
# Stage implementations (each runs in its own subprocess; see main()).
# ---------------------------------------------------------------------------


def _device_info() -> dict:
    """The device this stage runs on; raises unless it is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"bench stages run on a GPU; JAX reports {devs[0].platform!r}")
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def _time_full_chunk(model, B: int, years: int, n_rep: int = 2):
    """One production chunk: offset random start (5y buffer), all 19
    strategies. Returns seconds per chunk."""
    import jax
    import jax.numpy as jnp

    from letf_tpu.ops.path_batched import plan_max_spells
    from letf_tpu.parallel.mc_runner import _mc_chunk

    sim_days = years * 252
    buffer_days = 1260
    ids = jnp.arange(B, dtype=jnp.int32) // 2
    anti = (jnp.arange(B) % 2).astype(bool)
    max_spells = plan_max_spells(model, sim_days + buffer_days)

    @jax.jit
    def chunk_scalar(seed_key):
        summaries, _ = _mc_chunk(model, seed_key, ids, anti,
                                 sim_days, buffer_days,
                                 random_start_method="offset",
                                 apply_costs=True, max_spells=max_spells)
        # Reduced on device, as in production (per-chunk summaries stay on
        # the device until the final percentile fan); the scalar fetch
        # forces completion without timing a [B, 19] transfer.
        return jnp.sum(summaries["final_wealth"])

    def run(seed):
        return float(chunk_scalar(jax.random.key(seed)))

    run(0)
    t0 = time.perf_counter()
    for rep in range(n_rep):
        run(rep + 1)
    return (time.perf_counter() - t0) / n_rep


# Per-(asset, horizon) quality-score thresholds at the reference's
# "acceptable" band (>= 50, historical.py:523-561) — a flat threshold could
# not catch an 85 -> 45 regression. TQQQ_30y sits lower by design; see
# tqqq_30y_gap_note in the record.
_DIST_THRESHOLDS = {("TQQQ", 30): 60.0, ("SSO", 30): 65.0}
_DIST_DEFAULT_THRESHOLD = 70.0

# Median-gap bands (|median_sim - median_hist| in CAGR points). The
# reference's full-credit criterion is < 3 pt (historical.py:523-561):
# unlevered SPY must meet it. Leverage multiplies the underlying's median
# log-gap (~2 pt conservatism from pricing the full regime distribution vs
# the post-1950-dominated rolling windows): 2x SSO ~2x + vol drag -> 7 pt
# band; 3x TQQQ ~3x + 0.5*L^2*dsigma^2 drag -> 10.5 pt; TQQQ_30y carries an
# explicit WAIVER band of 12 pt (the quality score still gates it at 60).
_MEDIAN_BANDS = {"SPY": 3.0, "SSO": 7.0, "TQQQ": 10.5}
_MEDIAN_WAIVERS = {("TQQQ", 30): 12.0}


def bench_distribution():
    """Distributional sanity gate: run the full engine under the CALIBRATED
    offline-synthetic model per horizon, record TQQQ/SPY/SSO CAGR fans plus
    the historical-validation quality scores, and GATE on (a) the per-pair
    scores and (b) the per-pair median-CAGR gaps against explicit bands.
    The fallback-model numbers (p50 TQQQ wealth 0 at 30y in
    chip_smoke.py's report) are the reference's own default parameters
    (letf/calibration.py:374-389): fat-tail drag + borrow costs make 30y
    TQQQ buy-and-hold ruin-heavy under that fallback — faithful behavior,
    not an engine bug."""
    import numpy as np

    os.environ.setdefault("LETF_NON_INTERACTIVE", "1")
    from letf_tpu import historical
    from letf_tpu.calibration import calibrate_all
    from letf_tpu.data import fetch_historical_data
    from letf_tpu.models.params import build_sim_model
    from letf_tpu.parallel.mc_runner import run_monte_carlo

    df = fetch_historical_data(force_synthetic=True)
    regime_model, _ = calibrate_all(df)
    model = build_sim_model(regime_model)

    n = 16384
    fans = {}
    scores = {}
    gate_ok = True
    for h in (10, 20, 30):
        arr = run_monte_carlo(model, h, num_simulations=n, seed=5,
                              chunk_size=n, progress=False)
        per_asset = {}
        for sid, asset, col in (("S1", "TQQQ", 0), ("S2", "SPY", 1),
                                ("S3", "SSO", 2)):
            w = np.maximum(arr.final_wealth[:, col], 1e-12)
            cagr = (w / 10_000.0) ** (1.0 / h) - 1.0
            per_asset[asset] = {f"p{p}": float(np.percentile(cagr, p))
                                for p in (10, 25, 50, 75, 90)}
            hist = historical.calculate_rolling_cagrs_all_data(df, asset, h)
            if len(hist) >= 5:
                thr = _DIST_THRESHOLDS.get((asset, h),
                                           _DIST_DEFAULT_THRESHOLD)
                sc = historical._score_comparison(np.asarray(hist), cagr)
                gap_pt = (float(sc["median_sim"])
                          - float(sc["median_hist"])) * 100.0
                waived = (asset, h) in _MEDIAN_WAIVERS
                band = (_MEDIAN_WAIVERS[(asset, h)] if waived
                        else _MEDIAN_BANDS[asset])
                med_ok = abs(gap_pt) <= band
                score_ok = sc["quality_score"] >= thr
                scores[f"{asset}_{h}y"] = {
                    "quality_score": float(sc["quality_score"]),
                    "overlap": float(sc["overlap"]),
                    "median_hist": float(sc["median_hist"]),
                    "median_sim": float(sc["median_sim"]),
                    "median_gap_pt": gap_pt,
                    "median_band_pt": band,
                    "median_waiver": waived,
                    "threshold": thr,
                    "pass": bool(score_ok and med_ok),
                }
                gate_ok &= score_ok and med_ok
        fans[f"{h}y"] = per_asset
    return {"model": "calibrated (offline-synthetic history)",
            "n_trials": n, "cagr_fans": fans, "quality_scores": scores,
            "gate_thresholds": {"default": _DIST_DEFAULT_THRESHOLD,
                                "TQQQ_30y": 60.0, "SSO_30y": 65.0},
            "median_bands_pt": {"SPY": _MEDIAN_BANDS["SPY"],
                                "SSO": _MEDIAN_BANDS["SSO"],
                                "TQQQ": _MEDIAN_BANDS["TQQQ"],
                                "TQQQ_30y_waiver": 12.0,
                                "reference_full_credit": 3.0},
            "gate_pass": bool(gate_ok),
            "tqqq_30y_gap_note": (
                "TQQQ 30y sim median CAGR sits ~10pt under the rolling-"
                "window history. Decomposition: (1) the regime-stationary "
                "model prices every 30y window at the century's long-run "
                "crisis frequency, while the overlapping historical 30y "
                "windows are dominated by post-1950 expansions — the same "
                "conservatism shows directly on unlevered SPY (about -2pt); "
                "(2) at 3x leverage the underlying median log-gap triples "
                "(~-6pt) and the calibrated fat tails add 0.5*L^2*dsigma^2 "
                "of extra vol drag on top. The per-pair score thresholds "
                "and median bands above bound how far it may drift, with "
                "the 30y waiver encoded as its own 12 pt band")}


def bench_calibrated_flagship():
    """The flagship 1M x 30y full-engine report on the CALIBRATED model:
    the fallback-model flagship is ruin-degenerate at 30y (p50 TQQQ wealth
    0 — the reference's own defaults), so the full-engine number is also
    measured on the distribution the production user gets. Gate: p50 TQQQ
    wealth > 0."""
    os.environ.setdefault("LETF_NON_INTERACTIVE", "1")
    from letf_tpu.calibration import calibrate_all
    from letf_tpu.data import fetch_historical_data
    from letf_tpu.models.params import build_sim_model
    from letf_tpu.parallel.mc_runner import monte_carlo_report

    df = fetch_historical_data(force_synthetic=True)
    regime_model, _ = calibrate_all(df)
    model = build_sim_model(regime_model)

    n_total = 1_048_576
    kw = dict(num_simulations=n_total, seed=2, tax_mode="none")
    monte_carlo_report(model, 30, **kw)           # warm
    t0 = time.perf_counter()
    rep = monte_carlo_report(model, 30, **kw)
    dt = time.perf_counter() - t0
    s1 = rep["strategies"]["S1"]
    s2 = rep["strategies"]["S2"]
    return {
        "model": "calibrated (offline-synthetic history)",
        "seconds": dt,
        "path_days_per_sec": n_total * 7560 / dt,
        "p50_tqqq_wealth": s1["wealth"]["p50"],
        "p50_tqqq_cagr": s1["cagr"]["p50"],
        "p90_tqqq_cagr": s1["cagr"]["p90"],
        "p50_spy_cagr": s2["cagr"]["p50"],
        "tqqq_ruin_frac": s1["ruin_frac"],
        "fan_sane": bool(s1["wealth"]["p50"] > 0.0),
        "finite_frac": rep["finite_frac"],
        "vix_ok_frac": rep["vix_ok_frac"],
        "valid_frac": rep["valid_frac"],
    }


def bench_long_horizon():
    """Long-horizon envelope: the reference's TIME_HORIZONS include 40 and
    50 (letf/config.py:26). One full-engine chunk at 50y (12,600 sim days
    + 5y buffer) checks the static plans (spell capacity, scans) hold."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from letf_tpu.models.params import default_sim_model
    from letf_tpu.ops.path_batched import plan_max_spells
    from letf_tpu.parallel.mc_runner import _mc_chunk

    model = default_sim_model()
    years, B = 50, 4096
    max_spells = plan_max_spells(model, years * 252 + 1260)
    dt = _time_full_chunk(model, B, years)
    ids = jnp.arange(B, dtype=jnp.int32) // 2
    anti = (jnp.arange(B) % 2).astype(bool)
    summaries, _ = _mc_chunk(model, jax.random.key(9), ids, anti,
                             years * 252, 1260,
                             random_start_method="offset",
                             apply_costs=True, max_spells=max_spells)
    fw = np.asarray(summaries["final_wealth"])
    return {
        "years": years, "trials": B,
        "seconds_per_batch": dt,
        "path_days_per_sec": B * years * 252 / dt,
        "max_spells_planned": int(max_spells),
        "sim_days": years * 252, "buffer_days": 1260,
        "spy_p50_wealth": float(np.percentile(fw[:, 1], 50)),
        "finite_wealth_frac": float(np.isfinite(fw).mean()),
    }


STAGES = {
    "long_horizon": bench_long_horizon,
    "calibrated_flagship": bench_calibrated_flagship,
    "distribution": bench_distribution,
}


# ---------------------------------------------------------------------------
# Parent process (never imports JAX).
# ---------------------------------------------------------------------------


def _sanitize(obj, path="", bad=None):
    """Replace non-finite floats with None (recording their paths) so the
    record is always valid strict JSON."""
    if bad is None:
        bad = []
    if isinstance(obj, dict):
        return {k: _sanitize(v, f"{path}.{k}", bad)[0]
                for k, v in obj.items()}, bad
    if isinstance(obj, list):
        return [_sanitize(v, f"{path}[{i}]", bad)[0]
                for i, v in enumerate(obj)], bad
    if isinstance(obj, float) and not math.isfinite(obj):
        bad.append(path)
        return None, bad
    return obj, bad


def run_stage(name: str):
    """Run one stage in a subprocess. Returns (data | None, status)."""
    env = dict(os.environ)
    env.setdefault("LETF_NON_INTERACTIVE", "1")
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--stage", name],
            timeout=STAGE_TIMEOUT_S, capture_output=True, text=True, env=env,
            cwd=HERE)
    except subprocess.TimeoutExpired:
        return None, {"ok": False, "seconds": time.perf_counter() - t0,
                      "error": f"timed out after {STAGE_TIMEOUT_S:.0f} s"}
    wall = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith(RESULT_PREFIX)]
    if r.returncode == 0 and lines:
        return json.loads(lines[-1][len(RESULT_PREFIX):]), {
            "ok": True, "seconds": wall}
    return None, {"ok": False, "seconds": wall,
                  "error": f"stage exited rc={r.returncode}",
                  "stderr_tail": r.stderr[-800:]}


def stage_main(name: str) -> int:
    """Child-process entry: run one stage, print its JSON on one line."""
    from letf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    data = {"device": _device_info(), **STAGES[name]()}
    print(RESULT_PREFIX + json.dumps(_sanitize(data)[0], allow_nan=False),
          flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stage", choices=sorted(STAGES),
                        help="run one stage in this process (internal)")
    parser.add_argument("--record",
                        default=os.path.join(HERE, "out", "bench_record.json"),
                        help="where to write the full record")
    args = parser.parse_args()
    if args.stage:
        return stage_main(args.stage)

    record = {"stages": {}, "stage_status": {}}
    os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
    for stage in STAGES:
        data, status = run_stage(stage)
        record["stage_status"][stage] = status
        if data is not None:
            record["stages"][stage] = data
        clean, bad = _sanitize(record)
        clean["nonfinite_paths"] = bad
        with open(args.record, "w") as f:
            json.dump(clean, f, indent=1, allow_nan=False)
            f.write("\n")

    failed = [s for s, st in record["stage_status"].items() if not st["ok"]]
    devices = [d["device"] for d in record["stages"].values()]
    compact = {
        "device": devices[0] if devices else None,
        "ok_stages": sorted(record["stages"]),
        "failed_stages": failed,
        "record": os.path.relpath(args.record, HERE),
    }
    print(json.dumps(_sanitize(compact)[0], allow_nan=False), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
