"""US tax engine for the JAX LETF framework.

Subsystem map (reference parity):
- engine.py        : IRC §1222/§1211(b)/§1212(b) capital-gains netting + golden tests
                     (reference letf/tax/engine.py)
- brackets.py      : 2024 federal/state/NIIT bracket tables (letf/tax/brackets.py)
- marginal.py      : progressive bracket math + stacked LTCG (letf/tax/marginal.py)
- wash_sale.py     : IRC §1091 ±30-day wash-sale tracker (letf/tax/wash_sale.py)
- lot_selection.py : FIFO/LIFO/HIFO/LOFO/LTFO/STFO/MINTAX (letf/tax/lot_selection.py)
- regimes.py       : tax-interpretation Monte Carlo (letf/tax/regimes.py)
- vectorized.py    : NEW capability — branch-free netting + bracket math over
                     (trial, year) tensors on device, enabling exact tax for ALL
                     trials instead of the reference's 50-sample interpolation.
"""

from letf_tpu.tax.engine import (
    CapitalGainsResult,
    CapitalLossUsageStrategy,
    LotSelectionMethod,
    AMTCreditTiming,
    TaxpayerElections,
    compute_capital_gains,
    GOLDEN_TESTS,
    run_golden_tests,
)
