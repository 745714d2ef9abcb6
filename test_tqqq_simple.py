"""TQQQ sanity check (reference test_tqqq_simple.py:1-159): 100 sims x 10y
of SPY/SSO/TQQQ CAGR distributions plus a leverage-consistency analysis —
in percentile space, higher leverage should widen the distribution and the
median ordering should reflect volatility drag vs drift.
"""

import os

from letf_tpu.utils.compile_cache import enable_compile_cache


def main() -> None:
    import numpy as np

    from letf_tpu import config as cfg
    from letf_tpu.parallel.mc_runner import parallel_monte_carlo_fixed

    years, sims = 10, 100
    mc = parallel_monte_carlo_fixed(["S1", "S2", "S3"], years, None,
                                    num_simulations=sims)

    print("\nHistorical context (2010-2020 realized): TQQQ ~38%, SSO ~20%, "
          "SPY ~13% CAGR — a strong-bull regime, not the expectation.")
    print(f"\n{'':<6}{'p10':>9}{'p25':>9}{'median':>9}{'p75':>9}{'p90':>9}"
          f"  (CAGR, {sims} sims x {years}y)")

    cagrs = {}
    for sid, name in (("S2", "SPY"), ("S3", "SSO"), ("S1", "TQQQ")):
        w = np.array([r["Final_Wealth"] for r in mc[sid]])
        c = (np.maximum(w, 1e-12) / cfg.INITIAL_CAPITAL) ** (1 / years) - 1
        cagrs[name] = c
        pcts = np.percentile(c, [10, 25, 50, 75, 90]) * 100
        print(f"{name:<6}" + "".join(f"{p:>8.1f}%" for p in pcts))

    print("\nLeverage-consistency analysis:")
    spread = {n: np.percentile(c, 90) - np.percentile(c, 10)
              for n, c in cagrs.items()}
    print(f"  p90-p10 CAGR spread: SPY {spread['SPY']:.1%} < "
          f"SSO {spread['SSO']:.1%} < TQQQ {spread['TQQQ']:.1%} "
          f"-> {'OK' if spread['SPY'] < spread['SSO'] < spread['TQQQ'] else 'VIOLATION'}")
    up = {n: (c > 0).mean() for n, c in cagrs.items()}
    print(f"  P(positive CAGR): SPY {up['SPY']:.0%}, SSO {up['SSO']:.0%}, "
          f"TQQQ {up['TQQQ']:.0%}")
    print("  (Vol drag: higher leverage trades median for tail upside.)")


if __name__ == "__main__":
    os.environ.setdefault("LETF_NON_INTERACTIVE", "1")
    enable_compile_cache()
    main()
