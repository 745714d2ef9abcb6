"""Smoke test: the reference's primary validation tool (quick_test.py:31-108)
re-expressed for the JAX build — golden tax tests, data, calibration, a
10-sim x 10y Monte Carlo over S1-S3, and summary statistics.
"""

import os
import time

from letf_tpu.utils.compile_cache import enable_compile_cache


def main() -> None:
    from letf_tpu import config as cfg
    from letf_tpu.calibration import calibrate_all
    from letf_tpu.data import fetch_historical_data
    from letf_tpu.parallel.mc_runner import parallel_monte_carlo_fixed
    from letf_tpu.reporting import create_summary_statistics
    from letf_tpu.tax.engine import run_golden_tests

    t0 = time.time()
    print("=" * 80)
    print("QUICK TEST - LETF Monte Carlo")
    print("=" * 80)

    run_golden_tests()

    cfg.init_cache()
    df = fetch_historical_data()
    regime_model, correlations = calibrate_all(df)

    mc = parallel_monte_carlo_fixed(
        strategy_ids=["S1", "S2", "S3"], time_horizon=10,
        regime_model=regime_model, correlation_matrices=correlations,
        historical_df=df, num_simulations=10)

    create_summary_statistics(mc, 10)

    print(f"\nQUICK TEST COMPLETE in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    os.environ.setdefault("LETF_NON_INTERACTIVE", "1")
    enable_compile_cache()
    main()
