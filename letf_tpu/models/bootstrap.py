"""Block bootstrap: historical-block return generation, device-reformulated.

The reference stitches variable-length blocks in a Python while-loop with
momentum-biased and Gaussian-kernel-weighted block selection
(letf/simulation/bootstrap.py:303-458). Here (SURVEY.md §7.3 plan):

1. Host-side, once: overlapping blocks (stride 21) from history become two
   padded tensor pools — Pool A "economy" [SPY, TLT, VIX, IRX] over all
   history, Pool B "tech" [SPY, QQQ, TLT, VIX, IRX] over the real-QQQ era —
   split by regime (VIX median >= 25), each with per-block SPY returns for
   momentum/macro matching.
2. Device-side, per trial: segment lengths are pre-drawn geometric draws
   (clipped 21..168); a short scan over segments (not days!) carries the
   momentum state and picks blocks by Gumbel-top-1 over log-weights —
   uniform, sign-masked (momentum bias), or Gaussian-kernel macro-matched.
3. One gather maps each day to (segment -> block, sub-offset) and pulls the
   stitched series; the shared Cholesky Student-t noise blend with
   mean-preserving drift correction is elementwise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from letf_tpu import config as cfg
from letf_tpu.utils import load_cache, save_cache

L = cfg.BOOTSTRAP_BLOCK_SIZE          # 168 rows per stored block
_STRIDE = 21


class BootstrapPools(NamedTuple):
    """Padded per-regime block pools (host numpy; converted at trace time)."""
    a_data: np.ndarray    # [R, N, L, 4]  SPY, TLT, VIX, IRX
    a_ret: np.ndarray     # [R, N] block SPY return
    a_count: np.ndarray   # [R]
    b_data: np.ndarray    # [R, N, L, 5]  SPY, QQQ, TLT, VIX, IRX
    b_ret: np.ndarray     # [R, N]
    b_count: np.ndarray   # [R]


def build_bootstrap_pools(df) -> BootstrapPools:
    """Slice history into overlapping regime-labeled blocks (parity with
    BlockBootstrapReturns._create_regime_blocks, bootstrap.py:49-161)."""
    import pandas as pd

    vix = df["VIX"].to_numpy(float)
    spy = df["SPY_Ret"].to_numpy(float)
    qqq = (df["QQQ_Ret"].to_numpy(float) if "QQQ_Ret" in df.columns
           else spy * 1.25)
    tlt = (df["TLT_Ret"].to_numpy(float) if "TLT_Ret" in df.columns
           else spy * -0.25)
    irx = (df["IRX"].to_numpy(float) if "IRX" in df.columns
           else np.full(len(df), 4.5))
    dates = df.index
    has_real_qqq = dates >= pd.Timestamp("1999-03-10")

    a_blocks = {0: [], 1: []}
    a_rets = {0: [], 1: []}
    b_blocks = {0: [], 1: []}
    b_rets = {0: [], 1: []}

    n = len(df)
    for start in range(0, n - L + 1, _STRIDE):
        end = start + L
        block_vix = vix[start:end]
        regime = 0 if np.nanmedian(block_vix) < 25 else 1
        block_spy = spy[start:end]
        if np.isnan(block_spy).sum() > L // 4:
            continue
        block_ret = float(np.prod(1 + np.nan_to_num(block_spy)) - 1)

        a = np.column_stack([
            np.nan_to_num(block_spy),
            np.nan_to_num(tlt[start:end]),
            np.nan_to_num(block_vix, nan=20.0),
            np.nan_to_num(irx[start:end], nan=4.5),
        ])
        a_blocks[regime].append(a)
        a_rets[regime].append(block_ret)

        if bool(np.all(has_real_qqq[start:end])):
            b = np.column_stack([
                np.nan_to_num(block_spy),
                np.nan_to_num(qqq[start:end]),
                np.nan_to_num(tlt[start:end]),
                np.nan_to_num(block_vix, nan=20.0),
                np.nan_to_num(irx[start:end], nan=4.5),
            ])
            b_blocks[regime].append(b)
            b_rets[regime].append(block_ret)

    def synthetic_block(regime: int, cols: int, seed: int) -> np.ndarray:
        """Fallback when a pool is empty (bootstrap.py:273-301)."""
        rng = np.random.default_rng(seed)
        std, vix_base, irx_base = ((0.011, 15.0, 3.5) if regime == 0
                                   else (0.035, 40.0, 1.5))
        s = rng.standard_t(cfg.STUDENT_T_DF, L) * std
        rows = [s, s * 1.25, -s * 0.25,
                np.full(L, vix_base) + rng.normal(0, 3, L),
                np.clip(np.full(L, irx_base) + rng.normal(0, 0.5, L), 0, 15)]
        if cols == 4:
            rows = [rows[0], rows[2], rows[3], rows[4]]
        return np.column_stack(rows)

    def pad(blocks, rets, cols):
        n_max = max(1, max(len(blocks[r]) for r in range(2)))
        data = np.zeros((2, n_max, L, cols))
        ret = np.zeros((2, n_max))
        count = np.zeros(2, np.int32)
        for r in range(2):
            if not blocks[r]:
                data[r, 0] = synthetic_block(r, cols, seed=1000 + r)
                ret[r, 0] = float(np.prod(1 + data[r, 0, :, 0]) - 1)
                count[r] = 1
                continue
            for i, b in enumerate(blocks[r]):
                data[r, i] = b
                ret[r, i] = rets[r][i]
            count[r] = len(blocks[r])
            # Pad tail with the last block so gathers stay in-bounds.
            data[r, count[r]:] = data[r, count[r] - 1]
            ret[r, count[r]:] = ret[r, count[r] - 1]
        return data, ret, count

    a_data, a_ret, a_count = pad(a_blocks, a_rets, 4)
    b_data, b_ret, b_count = pad(b_blocks, b_rets, 5)
    return BootstrapPools(a_data=a_data, a_ret=a_ret, a_count=a_count,
                          b_data=b_data, b_ret=b_ret, b_count=b_count)


def create_bootstrap_sampler(df) -> BootstrapPools:
    """Build-and-cache (reference create_bootstrap_sampler,
    bootstrap.py:461-477)."""
    cached = load_cache(cfg.BOOTSTRAP_CACHE)
    if cached is not None:
        print("[OK] Using cached bootstrap pools")
        return cached
    print("  Building block bootstrap pools from historical data...")
    pools = build_bootstrap_pools(df)
    cfg.init_cache()
    save_cache(pools, cfg.BOOTSTRAP_CACHE)
    return pools


# ---------------------------------------------------------------------------
# Device sampler
# ---------------------------------------------------------------------------

def _pick_block(ret_table, count, regime, desired_sign, have_sign, bias,
                target, use_kernel, u_bias, gumbel):
    """Gumbel-top-1 block selection with momentum sign-masking and optional
    Gaussian-kernel macro matching (bootstrap.py:193-271)."""
    n_max = ret_table.shape[1]
    idx = jnp.arange(n_max)
    valid = idx < count[regime]
    rets = ret_table[regime]

    same_sign = jnp.where(desired_sign >= 0, rets >= 0, rets < 0)
    sign_ok = have_sign & (u_bias < bias) & jnp.any(same_sign & valid)
    cand = valid & jnp.where(sign_ok, same_sign, True)

    n_cand = jnp.sum(cand)
    # Kernel weights over candidates (sigma = candidate block-return std).
    mean_c = jnp.sum(jnp.where(cand, rets, 0.0)) / jnp.maximum(n_cand, 1)
    var_c = (jnp.sum(jnp.where(cand, (rets - mean_c) ** 2, 0.0))
             / jnp.maximum(n_cand, 1))
    sigma = jnp.sqrt(jnp.maximum(var_c, 0.0))
    sigma = jnp.where(sigma < 1e-8, 0.05, sigma)
    logw = -0.5 * ((rets - target) / sigma) ** 2
    apply_kernel = use_kernel & (n_cand > 5)
    logw = jnp.where(apply_kernel, logw, 0.0)

    score = jnp.where(cand, logw + gumbel, -jnp.inf)
    return jnp.argmax(score)


@functools.partial(jax.jit, static_argnames=("n_days",))
def sample_bootstrap_returns(pools: BootstrapPools, regime_path, key,
                             n_days: int, add_noise: bool = True):
    """Stitch a [n_days] joint return path from the two synchronized pools.

    Returns dict with SPY_Ret/QQQ_Ret/TLT_Ret/VIX/IRX (the engine's VIX/IRX
    recursions override the pool columns, matching the reference where
    generate_fat_tailed_returns recomputes them — engine.py:99-123)."""
    pools = jax.tree.map(jnp.asarray, pools)
    max_seg = n_days // cfg.BOOTSTRAP_BLOCK_MIN + 2

    k_len, k_sel, k_noise = jax.random.split(key, 3)
    # Segment lengths: geometric(1/mean) clipped to [min, max].
    u_len = jax.random.uniform(k_len, (max_seg,))
    p_stay = 1.0 - 1.0 / cfg.BOOTSTRAP_BLOCK_MEAN
    lengths = jnp.clip(jnp.ceil(jnp.log1p(-u_len) / jnp.log(p_stay)),
                       cfg.BOOTSTRAP_BLOCK_MIN, cfg.BOOTSTRAP_BLOCK_MAX
                       ).astype(jnp.int32)
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(lengths)[:-1]])
    seg_end = jnp.minimum(starts + lengths, n_days)
    seg_len = jnp.maximum(seg_end - starts, 0)

    # Majority regime per segment via cumulative sum of the regime path.
    csum = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(regime_path.astype(jnp.int32))])
    s_clip = jnp.clip(starts, 0, n_days)
    frac_high = ((csum[jnp.clip(seg_end, 0, n_days)] - csum[s_clip])
                 / jnp.maximum(seg_len, 1))
    seg_regime = (frac_high >= 0.5).astype(jnp.int32)

    bias_by_regime = jnp.asarray(
        [cfg.BOOTSTRAP_MOMENTUM_BIAS_BY_REGIME[r] for r in range(2)])

    ks = jax.random.split(k_sel, max_seg)

    def seg_step(carry, xs):
        last_a, have_a, last_b, have_b = carry
        k, regime, slen = xs
        k1, k2, k3, k4, k5, k6 = jax.random.split(k, 6)
        bias = bias_by_regime[regime]

        blk_a = _pick_block(
            pools.a_ret, pools.a_count, regime,
            jnp.where(last_a >= 0, 1, -1), have_a, bias,
            jnp.zeros(()), jnp.bool_(False),
            jax.random.uniform(k1),
            jax.random.gumbel(k2, pools.a_ret.shape[1:]))
        off_a = jax.random.randint(k3, (), 0, L - slen + 1)
        # SPY return of the chosen sub-section drives macro matching.
        spy_block = pools.a_data[regime, blk_a, :, 0]
        lc = jnp.cumsum(jnp.log1p(spy_block))
        lc = jnp.concatenate([jnp.zeros(1), lc])
        spy_ret_a = jnp.expm1(lc[off_a + slen] - lc[off_a])

        blk_b = _pick_block(
            pools.b_ret, pools.b_count, regime,
            jnp.where(last_b >= 0, 1, -1), have_b, bias,
            spy_ret_a, jnp.bool_(True),
            jax.random.uniform(k4),
            jax.random.gumbel(k5, pools.b_ret.shape[1:]))
        off_b = jax.random.randint(k6, (), 0, L - slen + 1)
        qqq_block = pools.b_data[regime, blk_b, :, 1]
        lcb = jnp.concatenate([jnp.zeros(1), jnp.cumsum(jnp.log1p(qqq_block))])
        qqq_ret_b = jnp.expm1(lcb[off_b + slen] - lcb[off_b])

        new_carry = (spy_ret_a, jnp.bool_(True), qqq_ret_b, jnp.bool_(True))
        return new_carry, (blk_a, off_a, blk_b, off_b)

    init = (jnp.zeros(()), jnp.bool_(False), jnp.zeros(()), jnp.bool_(False))
    _, (blk_a, off_a, blk_b, off_b) = lax.scan(
        seg_step, init, (ks, seg_regime, seg_len))

    # Day -> segment mapping, then gather the stitched series.
    day = jnp.arange(n_days)
    seg_of_day = jnp.searchsorted(jnp.cumsum(lengths), day, side="right")
    seg_of_day = jnp.minimum(seg_of_day, max_seg - 1)
    within = day - starts[seg_of_day]
    r_d = seg_regime[seg_of_day]

    row_a = off_a[seg_of_day] + within
    row_b = off_b[seg_of_day] + within
    a_sel = pools.a_data[r_d, blk_a[seg_of_day], row_a]      # [n_days, 4]
    b_sel = pools.b_data[r_d, blk_b[seg_of_day], row_b]      # [n_days, 5]

    spy = a_sel[:, 0]
    vix = a_sel[:, 2]
    irx = a_sel[:, 3]
    qqq = b_sel[:, 1]
    tlt = b_sel[:, 2]

    if add_noise:
        # Sampler-internal shared Cholesky Student-t blend with
        # mean-preserving drift correction (bootstrap.py:395-450).
        w = 0.85
        noise_w = 1.0 - w
        scale_spy = jnp.where(regime_path == 0, 0.007, 0.022)
        z = jax.random.t(k_noise, float(cfg.STUDENT_T_DF), (n_days, 3))
        corr_low = jnp.asarray(np.linalg.cholesky(np.array(
            [[1.0, 0.835, -0.207], [0.835, 1.0, -0.150], [-0.207, -0.150, 1.0]])))
        corr_high = jnp.asarray(np.linalg.cholesky(np.array(
            [[1.0, 0.950, -0.447], [0.950, 1.0, -0.400], [-0.447, -0.400, 1.0]])))
        chol = jnp.where((regime_path == 0)[:, None, None], corr_low, corr_high)
        cz = jnp.einsum("tij,tj->ti", chol, z,
                        precision=lax.Precision.HIGHEST)
        spy_n = cz[:, 0] * scale_spy
        qqq_n = cz[:, 1] * scale_spy * 1.35
        tlt_n = cz[:, 2] * scale_spy * 0.5
        spy = w * spy + noise_w * (spy_n + spy.mean())
        qqq = w * qqq + noise_w * (qqq_n + qqq.mean())
        tlt = w * tlt + noise_w * (tlt_n + tlt.mean())

    return {"SPY_Ret": spy, "QQQ_Ret": qqq, "TLT_Ret": tlt,
            "VIX": vix, "IRX": irx}
