"""All 19 trading strategies as ONE batched equity scan.

The reference runs 15 per-day Python loops per strategy per trial
(run_strategy_fixed, letf/strategy.py:55-1277). Here every strategy's
allocation rule is a few branch-free vector ops over the trial axis inside
a single ``lax.scan`` over days; the carry holds only (equity, prev_alloc,
position states, trade counters, running max / max drawdown) — no equity
curve is materialized. Signals come precomputed from
letf_tpu.strategies.signals.

Semantics parity notes (quirks preserved deliberately):
- S7 vol targeting earns NO cash on the unallocated fraction
  (strategy.py:295: ret = r_asset * position) while S9-S19 blend with cash.
- S8 composite applies no transaction costs (no cost logic in that branch).
- S9 skips days with NaN signals entirely (equity frozen, prev_alloc kept).
- S19 only rebalances when |Δalloc| > 5%; otherwise holds prev_alloc.
- S6 recomputes embedded leverage from each single day's return
  (strategy.py:184-196), not cumulatively.
- SMA strategies apply regime-dependent spread + rebalance cost
  (compute_transaction_costs, strategy.py:8-53) on flip days only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from letf_tpu import config as cfg
from letf_tpu.ops.path_engine import PathOutputs
from letf_tpu.strategies.signals import (
    IDX_SPY,
    IDX_SSO,
    IDX_TMF,
    IDX_TQQQ,
    SignalSet,
    compute_signals,
)

NS = cfg.N_STRATEGIES          # 19
N_TAX = len(cfg.TAXABLE_IDS)   # 13 (S7..S19)
_TAX_OFFSET = 6                # taxable strategies start at column 6 (S7)

INITIAL_CAPITAL = cfg.INITIAL_CAPITAL
_SPREAD = 0.0003               # Roth bid-ask spread per unit turnover
_TURNOVER_EPS = 1e-4

# S8 position encoding.
_POS_CASH, _POS_SAFE, _POS_RISKY = 0, 1, 2


class StrategyResults(NamedTuple):
    final_wealth: jax.Array    # [B, NS]
    num_trades: jax.Array      # [B, NS] int32
    max_dd: jax.Array          # [B, NS]
    # Trade-journal emission (only when emit_trades=True, else None):
    tj_alloc: Optional[jax.Array]     # [S, B, N_TAX] new alloc (NaN = no trade)
    tj_value: Optional[jax.Array]     # [S, B, N_TAX] portfolio value (equity[i-1])
    tj_price: Optional[jax.Array]     # [S, B, N_TAX] journal asset price
    tj_asset: Optional[jax.Array]     # [S, B, N_TAX] int8 asset index


def _nan_to(x, default):
    return jnp.where(jnp.isnan(x), default, x)


def _vol_family_step(alloc, prev_alloc, r_asset, cash, apply_costs,
                     include_cash=True, threshold=_TURNOVER_EPS):
    """Common turnover/cost/return machinery for S7, S9-S18."""
    turnover = jnp.abs(alloc - prev_alloc)
    traded = turnover > threshold
    cost = jnp.where(traded, turnover * _SPREAD, 0.0)
    if include_cash:
        ret = alloc * r_asset + (1.0 - alloc) * cash
    else:
        ret = alloc * r_asset
    if apply_costs:
        ret = ret - cost
    return ret, traded, alloc


def dca_schedule(sim_days: int, monthly_amount: float,
                 start_day: int = 0) -> np.ndarray:
    """Dollar-cost-averaging contributions: +amount every 21 trading days."""
    cf = np.zeros(sim_days)
    cf[start_day::21] = monthly_amount
    if start_day == 0:
        cf[0] = 0.0   # day 0 is the initial-capital day
    return cf


def withdrawal_schedule(sim_days: int, annual_amount: float,
                        monthly: bool = True) -> np.ndarray:
    """Retirement withdrawals: -amount/12 monthly (or -amount yearly)."""
    cf = np.zeros(sim_days)
    if monthly:
        cf[21::21] = -annual_amount / 12.0
    else:
        cf[252::252] = -annual_amount
    return cf


@functools.partial(jax.jit, static_argnames=("apply_costs", "emit_trades"))
def run_strategies_batch(path: PathOutputs, sig: SignalSet,
                         apply_costs: bool = True,
                         emit_trades: bool = False,
                         cashflows=None) -> StrategyResults:
    """Run S1-S19 over a path batch. path/sig arrays are [B, S, ...].

    ``cashflows``: optional [S] per-day dollar flows (positive =
    contribution, negative = withdrawal) applied to every strategy's
    equity after the day's return — the DCA / retirement-withdrawal
    overlays of BASELINE configs #4/#5 (a capability beyond the
    reference). Equity is floored at zero (ruin absorbs).
    """
    B, S, A = path.etf_ret.shape
    dt = path.etf_ret.dtype

    # Time-major xs for the scan: [S, B, ...]
    def tm(x):
        return jnp.moveaxis(x, 1, 0)

    vix = tm(path.vix)                      # [S, B]
    spy_price = tm(sig.spy_price)           # [S, B]

    def prev_of(x):
        """x is [S, ...]: value at the previous day (NaN at day 0)."""
        first = jnp.full_like(x[:1], jnp.nan)
        return jnp.concatenate([first, x[:-1]], axis=0)

    # Every per-day input is a flat [S, B] channel (trials on the minor,
    # contiguous axis); the [S, B, A] forms would stride each per-day read
    # by A=6.
    CH: dict = {}

    def ch(name, arr):
        CH[name] = arr

    for a in range(A):
        ch(f"r{a}", tm(path.etf_ret[:, :, a]))
    for a in range(A):
        ch(f"price{a}", tm(sig.prices[:, :, a]))
    ch("cash", tm(path.cash_ret))
    ch("regime", tm(path.regime).astype(dt))   # 0/1, exact as float
    ch("vix", vix)
    ch("vix_prev", prev_of(vix))
    ch("spy_price_prev", prev_of(spy_price))
    # signals read at i-1 (pandas shift(1) semantics):
    ch("std20_mp20_prev", prev_of(tm(sig.tqqq_std20_mp20)))
    ch("dstd20_mp20_prev", prev_of(tm(sig.tqqq_dstd20_mp20)))
    ch("std5_prev", prev_of(tm(sig.tqqq_std5)))
    ch("std10_prev", prev_of(tm(sig.tqqq_std10)))
    ch("std20_prev", prev_of(tm(sig.tqqq_std20)))
    ch("std60_prev", prev_of(tm(sig.tqqq_std60)))
    ch("dstd20_prev", prev_of(tm(sig.tqqq_dstd20)))
    ch("skew60_prev", prev_of(tm(sig.tqqq_skew60)))
    ch("mean60_prev", prev_of(tm(sig.tqqq_mean60_ann)))
    ch("volmom5_prev", prev_of(tm(sig.tqqq_volmom5)))
    ch("sum126_prev", prev_of(tm(sig.spy_sum126)))
    ch("sma200_mp1_prev", prev_of(tm(sig.spy_sma200_mp1)))
    ch("sma200_prev", prev_of(tm(sig.spy_sma200)))
    ch("sma100_mp1_prev", prev_of(tm(sig.spy_sma100_mp1)))
    ch("rsi14_prev", prev_of(tm(sig.spy_rsi14)))
    # S7 reads its vol signal UNshifted (strategy.py:255,261):
    ch("std20_mp20_cur", tm(sig.tqqq_std20_mp20))

    xs = {
        "x": CH,                                 # dict of [S, B] channels
        "t": jnp.arange(S, dtype=jnp.int32),
        "cashflow": (jnp.zeros(S, dt) if cashflows is None
                     else jnp.asarray(cashflows, dt)),
    }

    s6_w_a, s6_w_b = 0.6, 0.4
    s6_assets = (IDX_TQQQ, IDX_TMF)
    s6_lev_a = float(cfg.ASSETS["TQQQ"].leverage)
    s6_lev_b = float(cfg.ASSETS["TMF"].leverage)
    spread_bps = jnp.asarray([cfg.BASE_SPREAD_BPS[0], cfg.BASE_SPREAD_BPS[1]], dt)
    tqqq_lev = cfg.ASSETS["TQQQ"].leverage

    # Layout note: all per-strategy carries are [NS, B] — the TRIAL axis is
    # last (contiguous), so every per-strategy row is one dense [B] vector
    # (no trailing small dims on hot tensors). S6's two-asset
    # position/leverage state is kept as four flat [B] components for the
    # same reason.
    def step(carry, x):
        (equity, prev_alloc, pos4, pos5, pos8,
         s6_pos0, s6_pos1, s6_emb0, s6_emb1,
         trades, run_max, mdd) = carry

        t = x["t"]
        first = t == 0
        xt = x["x"]                       # dict of [B] channels

        def g(name):
            return xt[name]

        cashr = g("cash")                 # [B]
        reg1 = g("regime") == 1.0         # [B] bool (regime is 0/1)
        r_tqqq = g(f"r{IDX_TQQQ}")
        r_spy = g(f"r{IDX_SPY}")
        r_sso = g(f"r{IDX_SSO}")

        rets = []           # per-strategy [B] daily return
        traded = []         # per-strategy [B] bool (counted as a trade)
        allocs_new = []     # matching prev_alloc columns

        # Journal emission buffers (taxable cols S7..S19).
        tj_alloc = jnp.full((B, N_TAX), jnp.nan, dt)
        tj_value = jnp.zeros((B, N_TAX), dt)
        tj_price = jnp.zeros((B, N_TAX), dt)
        tj_asset = jnp.full((B, N_TAX), IDX_TQQQ, jnp.int8)
        tqqq_price = g(f"price{IDX_TQQQ}")
        spy_asset_price = g(f"price{IDX_SPY}")

        def emit(col, do, alloc, eq_prev, price, asset=IDX_TQQQ):
            nonlocal tj_alloc, tj_value, tj_price, tj_asset
            if not emit_trades:
                return
            do = do & (~first)   # reference loops never trade on day 0
            tj_alloc = tj_alloc.at[:, col].set(jnp.where(do, alloc, jnp.nan))
            tj_value = tj_value.at[:, col].set(eq_prev)
            tj_price = tj_price.at[:, col].set(price)
            if isinstance(asset, int):
                tj_asset = tj_asset.at[:, col].set(jnp.int8(asset))
            else:
                tj_asset = tj_asset.at[:, col].set(asset.astype(jnp.int8))

        # ---- S1-S3 benchmarks ----
        for rb in (r_tqqq, r_spy, r_sso):
            rets.append(rb)
            traded.append(jnp.zeros((B,), bool))
            allocs_new.append(prev_alloc[len(rets) - 1])

        # ---- S4/S5 SMA state machines ----
        pp = g("spy_price_prev")
        sma1 = g("sma200_mp1_prev")
        buy4 = pp >= sma1                      # NaN-safe: NaN -> False
        buy4 = jnp.where(jnp.isnan(pp) | jnp.isnan(sma1), False, buy4)
        sell4 = pp < sma1
        sell4 = jnp.where(jnp.isnan(pp) | jnp.isnan(sma1), False, sell4)
        new4 = jnp.where(pos4 == 0, jnp.where(buy4, 1, 0),
                         jnp.where(sell4, 0, 1)).astype(pos4.dtype)
        new4 = jnp.where(first, pos4, new4)
        flip4 = new4 != pos4

        thresh5 = sma1 * (1.0 - 0.02)
        buy5 = jnp.where(jnp.isnan(pp) | jnp.isnan(thresh5), False, pp >= thresh5)
        sell5 = jnp.where(jnp.isnan(pp) | jnp.isnan(thresh5), False, pp < thresh5)
        new5 = jnp.where(pos5 == 0, jnp.where(buy5, 1, 0),
                         jnp.where(sell5, 0, 1)).astype(pos5.dtype)
        new5 = jnp.where(first, pos5, new5)
        flip5 = new5 != pos5

        sma_cost = (jnp.where(reg1, spread_bps[1], spread_bps[0]) / 10000.0
                    + cfg.REBALANCE_COST_PER_DOLLAR * tqqq_lev * jnp.abs(r_tqqq))
        for newp, flip in ((new4, flip4), (new5, flip5)):
            ret_s = jnp.where(newp == 1, r_tqqq, cashr)
            if apply_costs:
                ret_s = ret_s - jnp.where(flip, sma_cost, 0.0)
            rets.append(ret_s)
            traded.append(flip)
            allocs_new.append(prev_alloc[len(rets) - 1])

        # ---- S6 60/40 TQQQ/TMF with leverage-drift turnover ----
        # Component-wise over the two sleeves (same math as the stacked
        # [B, 2] form, lane-packed over trials).
        r6a, r6b = g(f"r{s6_assets[0]}"), g(f"r{s6_assets[1]}")
        pg0 = s6_pos0 * (1.0 + r6a)
        pg1 = s6_pos1 * (1.0 + r6b)
        u6a, u6b = r6a / s6_lev_a, r6b / s6_lev_b
        den_a, den_b = 1.0 + s6_lev_a * u6a, 1.0 + s6_lev_b * u6b
        emb0 = jnp.where(jnp.abs(den_a) > 0.01,
                         s6_lev_a * (1.0 + u6a) / den_a, s6_lev_a)
        emb1 = jnp.where(jnp.abs(den_b) > 0.01,
                         s6_lev_b * (1.0 + u6b) / den_b, s6_lev_b)
        total6 = pg0 + pg1
        is_rebal = (t % 21 == 0) & (~first)
        inv_t6 = 1.0 / jnp.maximum(total6, 1e-30)
        cw0, cw1 = pg0 * inv_t6, pg1 * inv_t6
        w_turn = jnp.abs(cw0 - s6_w_a) + jnp.abs(cw1 - s6_w_b)
        lev_turn = (jnp.abs(emb0 - s6_lev_a) / s6_lev_a * cw0
                    + jnp.abs(emb1 - s6_lev_b) / s6_lev_b * cw1)
        tot_turn = w_turn + lev_turn
        do_cost = is_rebal & (tot_turn > 0.01) if apply_costs else jnp.zeros((B,), bool)
        total_after = jnp.where(
            do_cost, total6 * (1.0 - tot_turn * cfg.REBALANCE_COST_PER_DOLLAR),
            total6)
        s6_pos_new0 = jnp.where(is_rebal, total_after * s6_w_a, pg0)
        s6_pos_new1 = jnp.where(is_rebal, total_after * s6_w_b, pg1)
        s6_emb_new0 = jnp.where(is_rebal, s6_lev_a, emb0)
        s6_emb_new1 = jnp.where(is_rebal, s6_lev_b, emb1)
        s6_pos_new0 = jnp.where(first, s6_pos0, s6_pos_new0)
        s6_pos_new1 = jnp.where(first, s6_pos1, s6_pos_new1)
        s6_emb_new0 = jnp.where(first, s6_emb0, s6_emb_new0)
        s6_emb_new1 = jnp.where(first, s6_emb1, s6_emb_new1)
        equity6 = jnp.where(first, equity[5], total_after)
        rets.append(jnp.zeros((B,), dt))          # placeholder; handled below
        traded.append(jnp.broadcast_to(is_rebal & (~first), (B,)))
        allocs_new.append(prev_alloc[5])

        # ---- S7 vol targeting 20% (NO cash on idle fraction) ----
        v7 = g("std20_mp20_cur")
        pos7 = jnp.where(jnp.isnan(v7) | (v7 < 0.01), 1.0,
                         jnp.clip(0.20 / v7, 0.2, 2.0))
        ret7, tr7, new_a7 = _vol_family_step(pos7, prev_alloc[6], r_tqqq,
                                             cashr, apply_costs,
                                             include_cash=False)
        emit(0, tr7, pos7, equity[6], tqqq_price)
        rets.append(ret7); traded.append(tr7); allocs_new.append(new_a7)

        # ---- S8 composite regime (TQQQ / SPY / cash; NO costs) ----
        price8 = g("spy_price_prev")
        sma8 = g("sma200_prev")
        rsi8 = g("rsi14_prev")
        vix8 = g("vix_prev")
        sc = (jnp.where(jnp.isnan(price8) | jnp.isnan(sma8), 0,
                        (price8 > sma8).astype(jnp.int32))
              + jnp.where(jnp.isnan(rsi8), 0,
                          ((rsi8 > 40) & (rsi8 < 80)).astype(jnp.int32))
              + jnp.where(jnp.isnan(vix8), 0, (vix8 < 25.0).astype(jnp.int32)))
        target8 = jnp.where(sc == 3, _POS_RISKY,
                            jnp.where(sc == 2, _POS_SAFE, _POS_CASH))
        ret8 = jnp.where(target8 == _POS_RISKY, r_tqqq,
                         jnp.where(target8 == _POS_SAFE, r_spy, cashr))
        switch8 = (target8 != pos8) & (~first)
        target8 = jnp.where(first, pos8, target8)
        ret8 = jnp.where(first, 0.0, ret8)
        # Journal (reference quirk, strategy.py:366-381): log the TARGET's
        # asset with alloc 1/1/0; the exited asset is never sold.
        asset8 = jnp.where(target8 == _POS_RISKY, IDX_TQQQ, IDX_SPY)
        alloc8 = jnp.where(target8 == _POS_CASH, 0.0, 1.0)
        price8j = jnp.where(target8 == _POS_RISKY, tqqq_price, spy_asset_price)
        emit(1, switch8, alloc8, equity[7], price8j, asset8)
        rets.append(ret8); traded.append(switch8); allocs_new.append(prev_alloc[7])

        # ---- S9 adaptive vol target (skips NaN days entirely) ----
        v9 = g("std20_mp20_prev")
        sma9 = g("sma200_prev")
        p9 = g("spy_price_prev")
        skip9 = jnp.isnan(v9) | jnp.isnan(sma9) | (v9 < 0.001)
        bull9 = p9 > sma9
        target_v9 = jnp.where(bull9, 0.35, 0.12)
        alloc9 = jnp.clip(target_v9 / jnp.where(skip9, 1.0, v9), 0.0, 1.0)
        alloc9 = jnp.where(skip9, prev_alloc[8], alloc9)
        ret9, tr9, new_a9 = _vol_family_step(alloc9, prev_alloc[8], r_tqqq,
                                             cashr, apply_costs)
        ret9 = jnp.where(skip9, 0.0, ret9)
        tr9 = tr9 & (~skip9)
        emit(2, tr9, alloc9, equity[8], tqqq_price)
        rets.append(ret9); traded.append(tr9); allocs_new.append(new_a9)

        # ---- S10 Sortino (downside vol target) ----
        dv10 = g("dstd20_mp20_prev")
        alloc10 = jnp.where(jnp.isnan(dv10) | (dv10 < 0.001), 1.0,
                            jnp.clip(0.15 / dv10, 0.0, 1.5))
        ret10, tr10, new_a10 = _vol_family_step(alloc10, prev_alloc[9],
                                                r_tqqq, cashr, apply_costs)
        emit(3, tr10, alloc10, equity[9], tqqq_price)
        rets.append(ret10); traded.append(tr10); allocs_new.append(new_a10)

        # ---- S11 hyper-convex ----
        v11 = _nan_to(g("std20_prev"), 0.5)
        v11 = jnp.where(v11 < 0.001, 0.5, v11)
        alloc11 = 0.25 / v11
        bull11 = g("spy_price_prev") > g("sma200_mp1_prev")
        bull11 = jnp.where(jnp.isnan(g("spy_price_prev"))
                           | jnp.isnan(g("sma200_mp1_prev")), False, bull11)
        alloc11 = jnp.where(bull11, alloc11 ** 1.2, alloc11)
        alloc11 = jnp.clip(alloc11, 0.0, 1.0)
        ret11, tr11, new_a11 = _vol_family_step(alloc11, prev_alloc[10],
                                                r_tqqq, cashr, apply_costs)
        emit(4, tr11, alloc11, equity[10], tqqq_price)
        rets.append(ret11); traded.append(tr11); allocs_new.append(new_a11)

        # ---- S12 vol velocity (max of fast/slow vols) ----
        v12 = jnp.maximum(g("std20_prev"), g("std5_prev"))  # NaN -> NaN
        v12 = jnp.where(jnp.isnan(v12) | (v12 < 0.001), 0.5, v12)
        alloc12 = jnp.clip(0.22 / v12, 0.0, 1.0)
        ret12, tr12, new_a12 = _vol_family_step(alloc12, prev_alloc[11],
                                                r_tqqq, cashr, apply_costs)
        emit(5, tr12, alloc12, equity[11], tqqq_price)
        rets.append(ret12); traded.append(tr12); allocs_new.append(new_a12)

        # ---- S13 vol-of-vol momentum ----
        v13 = jnp.where(jnp.isnan(g("std20_prev")) | (g("std20_prev") < 0.001),
                        0.5, g("std20_prev"))
        vm13 = g("volmom5_prev")
        alloc13 = 0.25 / v13
        alloc13 = jnp.where(~jnp.isnan(vm13) & (vm13 < -0.10),
                            alloc13 * 1.2, alloc13)
        alloc13 = jnp.where(~jnp.isnan(vm13) & (vm13 > 0.10),
                            alloc13 * 0.7, alloc13)
        alloc13 = jnp.clip(alloc13, 0.0, 1.0)
        ret13, tr13, new_a13 = _vol_family_step(alloc13, prev_alloc[12],
                                                r_tqqq, cashr, apply_costs)
        emit(6, tr13, alloc13, equity[12], tqqq_price)
        rets.append(ret13); traded.append(tr13); allocs_new.append(new_a13)

        # ---- S14 skewness-adjusted convex ----
        v14 = jnp.where(jnp.isnan(g("std20_prev")) | (g("std20_prev") < 0.001),
                        0.5, g("std20_prev"))
        s14 = g("skew60_prev")
        alloc14 = 0.25 / v14
        alloc14 = jnp.where(~jnp.isnan(s14) & (s14 > 0), alloc14 ** 1.3, alloc14)
        alloc14 = jnp.where(~jnp.isnan(s14) & (s14 < -0.5), alloc14 * 0.5, alloc14)
        alloc14 = jnp.clip(alloc14, 0.0, 1.0)
        ret14, tr14, new_a14 = _vol_family_step(alloc14, prev_alloc[13],
                                                r_tqqq, cashr, apply_costs)
        emit(7, tr14, alloc14, equity[13], tqqq_price)
        rets.append(ret14); traded.append(tr14); allocs_new.append(new_a14)

        # ---- S15 meta-ensemble ----
        dv15 = jnp.where(jnp.isnan(g("dstd20_prev")) | (g("dstd20_prev") < 0.001),
                         0.25, g("dstd20_prev"))
        alloc15 = 0.28 / dv15
        bull15 = g("spy_price_prev") > g("sma200_mp1_prev")
        bull15 = jnp.where(jnp.isnan(g("spy_price_prev"))
                           | jnp.isnan(g("sma200_mp1_prev")), False, bull15)
        alloc15 = jnp.where(bull15, alloc15 ** 1.2, alloc15)
        brake15 = g("std5_prev") > 1.5 * g("std20_prev")
        brake15 = jnp.where(jnp.isnan(g("std5_prev")) | jnp.isnan(g("std20_prev")),
                            False, brake15)
        alloc15 = jnp.where(brake15, alloc15 * 0.5, alloc15)
        alloc15 = jnp.clip(alloc15, 0.0, 1.0)
        ret15, tr15, new_a15 = _vol_family_step(alloc15, prev_alloc[14],
                                                r_tqqq, cashr, apply_costs)
        emit(8, tr15, alloc15, equity[14], tqqq_price)
        rets.append(ret15); traded.append(tr15); allocs_new.append(new_a15)

        # ---- S16 crisis alpha (regime asymmetric) ----
        vr16 = g("std5_prev") / g("std60_prev")
        crisis16 = (g("vix") > 25.0) | jnp.where(jnp.isnan(vr16), False,
                                                 vr16 > 1.5)
        target16 = jnp.where(crisis16, 0.08, 0.30)
        rv16 = g("std5_prev")
        alloc16 = jnp.where(jnp.isnan(rv16) | (rv16 < 0.001), 0.5,
                            jnp.clip(target16 / rv16, 0.0, 1.2))
        ret16, tr16, new_a16 = _vol_family_step(alloc16, prev_alloc[15],
                                                r_tqqq, cashr, apply_costs)
        emit(9, tr16, alloc16, equity[15], tqqq_price)
        rets.append(ret16); traded.append(tr16); allocs_new.append(new_a16)

        # ---- S17 tail-risk optimizer (skew-aware Kelly) ----
        vol17 = jnp.where(jnp.isnan(g("std20_prev")) | (g("std20_prev") < 0.001),
                          0.25, g("std20_prev"))
        dvol17 = jnp.where(jnp.isnan(g("dstd20_prev")) | (g("dstd20_prev") < 0.001),
                           vol17 * 0.6, g("dstd20_prev"))
        skew17 = _nan_to(g("skew60_prev"), 0.0)
        mean17 = _nan_to(g("mean60_prev"), 0.08)
        eff17 = jnp.where(skew17 < -0.5, dvol17 * 1.5,
                          jnp.where(skew17 < 0, dvol17 * 1.2,
                                    jnp.where(skew17 > 0.5, vol17 * 0.9, vol17)))
        pen17 = jnp.where(skew17 < -0.5, 0.6,
                          jnp.where(skew17 < 0, 0.8,
                                    jnp.where(skew17 > 0.5, 1.2, 1.0)))
        kelly17 = jnp.where(eff17 > 0.01,
                            jnp.clip((mean17 - 0.03) / (eff17 ** 2) * 0.7,
                                     0.2, 2.0), 1.0)
        alloc17 = jnp.clip((0.30 / eff17) * pen17 * (kelly17 / 1.5), 0.0, 1.5)
        ret17, tr17, new_a17 = _vol_family_step(alloc17, prev_alloc[16],
                                                r_tqqq, cashr, apply_costs)
        emit(10, tr17, alloc17, equity[16], tqqq_price)
        rets.append(ret17); traded.append(tr17); allocs_new.append(new_a17)

        # ---- S18 momentum-vol convergence ----
        mom18 = _nan_to(g("sum126_prev"), 0.0)
        vf18 = jnp.where(jnp.isnan(g("std10_prev")) | (g("std10_prev") < 0.001),
                         0.30, g("std10_prev"))
        vs18 = jnp.where(jnp.isnan(g("std60_prev")) | (g("std60_prev") < 0.001),
                         0.25, g("std60_prev"))
        mm18 = jnp.where(mom18 > 0.05, 1.3, jnp.where(mom18 > 0, 1.0, 0.5))
        vr18 = vf18 / vs18
        vm18 = jnp.where(vr18 < 0.8, 1.2, jnp.where(vr18 > 1.3, 0.6, 1.0))
        eff18 = jnp.where((vr18 < 0.8) | (vr18 > 1.3), vf18, vs18)
        alloc18 = jnp.clip(0.28 * mm18 * vm18 / eff18, 0.0, 1.5)
        ret18, tr18, new_a18 = _vol_family_step(alloc18, prev_alloc[17],
                                                r_tqqq, cashr, apply_costs)
        emit(11, tr18, alloc18, equity[17], tqqq_price)
        rets.append(ret18); traded.append(tr18); allocs_new.append(new_a18)

        # ---- S19 conviction compounder (5% rebalance threshold) ----
        mom19 = _nan_to(g("sum126_prev"), 0.0)
        dv19 = jnp.where(jnp.isnan(g("dstd20_prev")) | (g("dstd20_prev") < 0.001),
                         0.20, g("dstd20_prev"))
        vf19 = jnp.where(jnp.isnan(g("std5_prev")) | (g("std5_prev") < 0.001),
                         0.30, g("std5_prev"))
        vs19 = jnp.where(jnp.isnan(g("std60_prev")) | (g("std60_prev") < 0.001),
                         0.25, g("std60_prev"))
        mom_score = jnp.where(mom19 > 0.15, 1.0,
                              jnp.where(mom19 > 0.05, 0.7,
                                        jnp.where(mom19 > 0, 0.4, 0.0)))
        trend19 = g("spy_price_prev") > g("sma100_mp1_prev")
        trend19 = jnp.where(jnp.isnan(g("spy_price_prev"))
                            | jnp.isnan(g("sma100_mp1_prev")), False, trend19)
        trend_score = jnp.where(trend19, 0.5, 0.0)
        vr19 = vf19 / vs19
        vol_score = jnp.where(vr19 < 0.9, 0.5, jnp.where(vr19 < 1.2, 0.3, 0.0))
        conviction = mom_score + trend_score + vol_score
        raw19 = (0.32 / dv19) * (0.3 + conviction * 0.55)
        cand19 = jnp.clip(raw19, 0.0, 1.5)
        turn19 = jnp.abs(cand19 - prev_alloc[18])
        rebal19 = turn19 > 0.05
        alloc19 = jnp.where(rebal19, cand19, prev_alloc[18])
        cost19 = jnp.where(rebal19, turn19 * _SPREAD, 0.0)
        ret19 = alloc19 * r_tqqq + (1.0 - alloc19) * cashr
        if apply_costs:
            ret19 = ret19 - cost19
        emit(12, rebal19, cand19, equity[18], tqqq_price)
        rets.append(ret19); traded.append(rebal19); allocs_new.append(alloc19)

        # ---- combine ([NS, B]: strategies major, trials minor) ----
        ret_all = jnp.stack(rets, axis=0)              # [NS, B]
        # Reference quirk: benchmark cumprods include day 0 (strategy.py:93),
        # while every loop strategy starts compounding at day 1.
        bench_mask = jnp.arange(NS) < 3
        ret_all = jnp.where(first & ~bench_mask[:, None], 0.0, ret_all)
        equity_new = equity * (1.0 + ret_all)
        # S6 equity computed from positions, not a return.
        equity_new = equity_new.at[5].set(equity6)

        # Cashflow overlay (DCA contributions / withdrawals), floored at 0;
        # S6 positions scale proportionally so weights are preserved.
        cf = x["cashflow"]
        equity_cf = jnp.maximum(equity_new + cf, 0.0)
        s6_scale = equity_cf[5] / jnp.maximum(equity_new[5], 1e-30)
        s6_pos_new0 = s6_pos_new0 * s6_scale
        s6_pos_new1 = s6_pos_new1 * s6_scale
        equity_new = equity_cf

        traded_all = jnp.stack(traded, axis=0) & (~first)
        inc = traded_all.astype(jnp.int32)
        inc = inc.at[5].set(inc[5] * 2)                # S6 counts 2 per rebalance
        trades_new = trades + inc

        prev_alloc_new = jnp.stack(allocs_new, axis=0)
        prev_alloc_new = jnp.where(first, prev_alloc, prev_alloc_new)

        # Running max accumulates from the day-0 equity (which for benchmarks
        # already includes the day-0 return).
        run_max_new = jnp.where(first, equity_new,
                                jnp.maximum(run_max, equity_new))
        dd = (equity_new - run_max_new) / jnp.where(run_max_new > 0,
                                                    run_max_new, 1.0)
        mdd_new = jnp.maximum(mdd, -dd)

        pos4n = jnp.where(first, pos4, new4)
        pos5n = jnp.where(first, pos5, new5)
        pos8n = jnp.where(first, pos8, target8)

        carry_new = (equity_new, prev_alloc_new, pos4n, pos5n, pos8n,
                     s6_pos_new0, s6_pos_new1, s6_emb_new0, s6_emb_new1,
                     trades_new, run_max_new, mdd_new)
        out = ((tj_alloc, tj_value, tj_price, tj_asset)
               if emit_trades else None)
        return carry_new, out

    init_equity = jnp.full((NS, B), INITIAL_CAPITAL, dt)
    init = (
        init_equity,
        jnp.zeros((NS, B), dt),                       # prev_alloc
        jnp.zeros((B,), jnp.int32),                   # pos4
        jnp.zeros((B,), jnp.int32),                   # pos5
        jnp.full((B,), _POS_CASH, jnp.int32),         # pos8
        jnp.full((B,), INITIAL_CAPITAL * s6_w_a, dt),  # s6_pos0
        jnp.full((B,), INITIAL_CAPITAL * s6_w_b, dt),  # s6_pos1
        jnp.full((B,), s6_lev_a, dt),                  # s6_emb0
        jnp.full((B,), s6_lev_b, dt),                  # s6_emb1
        jnp.zeros((NS, B), jnp.int32),
        init_equity,                                  # running max
        jnp.zeros((NS, B), dt),                       # max drawdown
    )

    carry, outs = lax.scan(step, init, xs)
    equity = carry[0].T
    trades = carry[9].T
    mdd = carry[11].T

    if emit_trades:
        tj_alloc, tj_value, tj_price, tj_asset = outs
    else:
        tj_alloc = tj_value = tj_price = tj_asset = None

    return StrategyResults(
        final_wealth=equity, num_trades=trades, max_dd=mdd,
        tj_alloc=tj_alloc, tj_value=tj_value, tj_price=tj_price,
        tj_asset=tj_asset)


def run_all(path: PathOutputs, apply_costs: bool = True,
            emit_trades: bool = False, cashflows=None) -> StrategyResults:
    """Convenience: compute signals then run the batched strategy scan."""
    sig = compute_signals(path)
    return run_strategies_batch(path, sig, apply_costs=apply_costs,
                                emit_trades=emit_trades, cashflows=cashflows)
