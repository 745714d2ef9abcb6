"""Batched path engine (the production formulation).

The per-trial engine (path_engine.py) vmaps functions whose state has
trailing dims of 3 (mu, h, 3x3 Q), so every op works on [B, 3] /
[B, 3, 3] intermediates with a tiny minor axis. This module reformulates
the same math component-wise: every state element (h0..h2, the six unique
entries of the symmetric Q, VIX, stress channels, per-asset TE) is a flat
[B] array, so all ops run as dense vector ops over trials.

Numerics are IDENTICAL to the per-trial engine given the same innovations
(pure algebraic restatement; verified by the batched-vs-vmapped equality
test).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from letf_tpu import config as cfg
from letf_tpu.models.params import SimModel
from letf_tpu.ops.path_engine import (
    Innovations,
    PathOutputs,
    _to_device,
    borrow_spread_series,
    draw_innovations,
)

_A = cfg.N_ASSETS


def draw_innovations_batched(model: SimModel, run_key, trial_ids, antithetic,
                             sim_days: int, buffer_days: int = 0,
                             random_start_method: str = "offset",
                             anchors=None) -> Innovations:
    """vmap of the per-trial innovation draws: identical streams, [B, ...]
    leaves."""
    fn = functools.partial(draw_innovations, sim_days=sim_days,
                           buffer_days=buffer_days,
                           random_start_method=random_start_method,
                           anchors=anchors)
    return jax.vmap(lambda t, a: fn(model, run_key, t, a))(trial_ids, antithetic)


# ---------------------------------------------------------------------------
# Fast innovation draws (production path)
#
# Same distributions as the reference streams, cheaper samplers:
# - Student-t with INTEGER df via t = z / sqrt(chisq_df / df), where
#   chisq(2k) = -2 log(prod of k uniforms) and chisq(2k+1) adds one squared
#   normal — pure elementwise ops instead of gamma rejection loops.
# - The semi-Markov regime scan consumes PREcomputed dwell/next lookups
#   (one vectorized inverse-CDF pass over the whole [B, T] grid) so the
#   scan body is elementwise — no per-step [256]-table search.
# NOTE: these draw different bits than the per-trial reference streams, so
# fast mode is distribution-equivalent, not draw-identical (the parity
# seam — shared Innovations — is unaffected).
# ---------------------------------------------------------------------------


def _clenshaw(t, c):
    """Chebyshev series sum c[k] T_k(t) via Clenshaw; c is a [K] array whose
    entries are consumed as scalars (K static)."""
    b1 = jnp.zeros_like(t)
    b2 = jnp.zeros_like(t)
    for k in range(c.shape[0] - 1, 0, -1):
        b1, b2 = c[k] + 2.0 * t * b1 - b2, b1
    return c[0] + t * b1 - b2


def chi2_from_normal(z, cheb_coeffs):
    """Chi-square(nu) draw from one standard normal: exp(cheb(z/zmax)) where
    cheb fits log chi2_ppf(Phi(z), nu) (params.chi2_log_quantile_cheb).
    Quantile-exact to <5e-5 relative over +-6.3 sigma; pure FMAs + one exp,
    no gamma rejection loop."""
    from letf_tpu.models.params import CHI_CHEB_ZMAX

    t = jnp.clip(z / CHI_CHEB_ZMAX, -1.0, 1.0)
    return jnp.exp(_clenshaw(t, cheb_coeffs))


def _chisq_int(key, df: int, shape):
    """Exact chi-square with integer df from uniforms/normals only."""
    k_even = df // 2
    k_u, k_n = jax.random.split(key)
    out = jnp.zeros(shape)
    if k_even > 0:
        u = jax.random.uniform(k_u, (k_even,) + tuple(shape),
                               minval=1e-12, maxval=1.0)
        out = -2.0 * jnp.sum(jnp.log(u), axis=0)
    if df % 2 == 1:
        z = jax.random.normal(k_n, shape)
        out = out + z * z
    return out


def t_int_df(key, df: int, shape):
    """Student-t with integer df: z / sqrt(chisq_df / df)."""
    k_z, k_c = jax.random.split(key)
    z = jax.random.normal(k_z, shape)
    c = _chisq_int(k_c, df, shape)
    return z * jnp.sqrt(df / jnp.maximum(c, 1e-12))


def simulate_regime_paths_batched(model: SimModel, keys, start_regime,
                                  total_days: int):
    """Batched semi-Markov regime paths: [B] keys -> [B, T] int32.

    All dwell draws (per day, per candidate regime) and next-regime draws
    are precomputed with one vectorized inverse-CDF pass; the scan body is
    pure elementwise selection. Distribution identical to
    path_engine.simulate_regime_path."""
    reg = model.regime
    B = keys.shape[0]
    u = jax.vmap(lambda k: jax.random.uniform(k, (total_days + 1, 2)))(keys)

    dwell_cdf = jnp.asarray(reg.dwell_cdf)          # [R, D]
    dwell_val = jnp.asarray(reg.dwell_values)       # [R, D]
    has_dwell = jnp.asarray(reg.has_dwell)          # [R]
    p_stay = jnp.asarray(reg.p_stay)                # [R]
    trans = jnp.asarray(reg.transition)             # [R, R]
    R = trans.shape[0]
    D = dwell_cdf.shape[1]

    u_dwell = u[..., 0]                             # [B, T+1]
    u_next = u[..., 1]

    # Inverse-CDF dwell candidates for every regime: [R, B, T+1]
    # (idx = sum(cdf < u) == searchsorted(cdf, u, 'left'); binary search
    # avoids materializing a [R, B, T, D] broadcast).
    emp_rows = []
    for r in range(R):
        idx = jnp.minimum(
            jnp.searchsorted(dwell_cdf[r], u_dwell, side="left"), D - 1)
        emp_rows.append(dwell_val[r][idx])
    emp = jnp.stack(emp_rows)                        # [R, B, T+1]
    geo = jnp.maximum(jnp.ceil(jnp.log1p(-u_dwell)[None]
                               / jnp.log(p_stay)[:, None, None]), 1.0)
    dwell_cand = jnp.where(has_dwell[:, None, None] > 0, emp, geo)

    # Next-regime candidates [R, B, T+1] via off-diagonal inverse CDF.
    mask = 1.0 - jnp.eye(R)
    row = trans * mask
    rs = row.sum(axis=1, keepdims=True)
    probs = jnp.where(rs > 0, row / jnp.maximum(rs, 1e-30), 0.0)
    cum = jnp.cumsum(probs, axis=1)                 # [R, R]
    nxt_rows = []
    for r in range(R):
        nxt_rows.append(jnp.minimum(
            jnp.searchsorted(cum[r], u_next, side="left"), R - 1))
    nxt_cand = jnp.stack(nxt_rows).astype(jnp.int32)
    degenerate = (rs[:, 0] <= 0)
    nxt_cand = jnp.where(degenerate[:, None, None],
                         jnp.arange(R, dtype=jnp.int32)[:, None, None],
                         nxt_cand)

    def pick(cand, r, t):
        """cand [R, B, T+1] select per-trial (r[b], b, t)."""
        if R == 2:
            return jnp.where(r == 1, cand[1, :, t], cand[0, :, t])
        return cand[r, jnp.arange(B), t]

    first_dwell = pick(dwell_cand, start_regime, 0)

    def step(carry, t):
        cur, rem = carry
        out = cur
        rem = rem - 1.0
        need = rem <= 0.0
        nxt = pick(nxt_cand, cur, t + 1)
        ndw = pick(dwell_cand, nxt, t + 1)
        cur = jnp.where(need, nxt, cur)
        rem = jnp.where(need, ndw, rem)
        return (cur, rem), out

    (_, _), path = lax.scan(step, (start_regime, first_dwell),
                            jnp.arange(total_days))
    return jnp.moveaxis(path, 0, 1).astype(jnp.int32)   # [B, T]


_MIX_M1 = np.uint32(0x85EBCA6B)
_MIX_M2 = np.uint32(0xC2B2AE35)
_MIX_GOLD = np.uint32(0x9E3779B9)
_MIX_CTR = np.uint32(0x7FEB352D)


def _mix_u32(x):
    """murmur3 finalizer on uint32 — full avalanche bijection."""
    x = x ^ (x >> np.uint32(16))
    x = x * _MIX_M1
    x = x ^ (x >> np.uint32(13))
    x = x * _MIX_M2
    x = x ^ (x >> np.uint32(16))
    return x


def counter_uniforms(keys, n: int):
    """[B] per-trial threefry keys -> [B, n] f32 uniforms in (0, 1) via
    the murmur counter expansion (key words hashed with a counter, top 24
    bits + half-ulp offset).

    Key derivation stays on the threefry fold_in chain (ops/rng.py), so
    the stream discipline — per-(trial, purpose) keys, replay from
    (seed, trial_id), antithetic pairs sharing draws — is unchanged; only
    the per-counter EXPANSION is the cheap mixer: a few integer ops per
    draw instead of a vmapped threefry jax.random.uniform over [B] keys."""
    w = jax.random.key_data(keys).astype(jnp.uint32)          # [B, 2]
    lane = _mix_u32(w[..., 0] * _MIX_GOLD ^ w[..., 1])        # [B]
    ctr = jnp.arange(n, dtype=jnp.uint32) * _MIX_CTR          # [n]
    bits = _mix_u32(_mix_u32(lane[:, None] ^ ctr[None, :]))
    return ((bits >> np.uint32(8)).astype(jnp.float32)
            * jnp.float32(1.0 / 16777216.0)
            + jnp.float32(0.5 / 16777216.0))


def plan_max_spells(model: SimModel, total_days: int,
                    sigmas: float = 8.0) -> int:
    """Static spell-count bound for simulate_regime_paths_spell, computed
    HOST-SIDE from a concrete model (call before jit; the dwell tables
    are traced inside).

    The spell path's cost is dominated by the [B, K, nb] / [B, K, W]
    one-hot builds, linear in K; the default K = T/12 is sized for a
    pathological 12-day mean spell. With the model's actual dwell
    means/variances, the smallest n with n*mu_pair - sigmas*
    sqrt(n*var_pair) >= T bounds the pair count at ~Phi(-sigmas)
    (~6e-16/trial at 8 sigma) overflow probability — overflowing trials
    keep their final regime, the same documented fallback as the
    default. Clamped to [64, default] and rounded up to a multiple of 8."""
    import numpy as np_

    reg = model.regime
    default = max(64, total_days // 12)
    means, variances = [], []
    for r in range(2):
        if float(np_.asarray(reg.has_dwell)[r]) > 0:
            cdf = np_.asarray(reg.dwell_cdf)[r].astype(np_.float64)
            val = np_.asarray(reg.dwell_values)[r].astype(np_.float64)
            p = np_.diff(cdf, prepend=0.0)
            p = np_.clip(p, 0.0, None)
            tot = p.sum()
            if tot <= 0:
                return default
            p /= tot
            m = float((p * val).sum())
            v = float((p * val * val).sum() - m * m)
        else:
            ps = float(np_.asarray(reg.p_stay)[r])
            ps = min(max(ps, 0.0), 1.0 - 1e-9)
            m = 1.0 / (1.0 - ps)
            v = ps / (1.0 - ps) ** 2
        means.append(max(m, 1.0))
        variances.append(max(v, 0.0))
    mu_p = means[0] + means[1]
    var_p = variances[0] + variances[1]
    x = (sigmas * var_p ** 0.5
         + (sigmas * sigmas * var_p + 4.0 * mu_p * total_days) ** 0.5
         ) / (2.0 * mu_p)
    n_pairs = int(x * x) + 1
    k = 2 * n_pairs + 2
    k = min(max(64, -(-k // 8) * 8), default)
    return k


def simulate_regime_paths_spell(model: SimModel, keys, start_regime,
                                total_days: int,
                                max_spells: int | None = None):
    """Scan-free semi-Markov regime paths for R=2.

    With two regimes and off-diagonal next-state sampling, the regime
    SEQUENCE alternates deterministically — only the dwell lengths are
    random. So: draw all spell lengths at once (inverse-CDF over the dwell
    tables for the alternating regimes), then regime[t] = start XOR parity
    of completed spells, built from a scatter of spell boundaries and a
    cumsum. No scan, no per-step table search.

    max_spells bounds the draw count; a path needing more spells than that
    (mean dwell < total_days / max_spells, astronomically unlikely for
    calibrated dwell tables) keeps its final regime for the remainder.
    Degenerate transition rows (zero off-diagonal mass) are not handled
    here — calibrated 2-regime models always mix; the scan engine remains
    the general path."""
    reg = model.regime
    B = keys.shape[0]
    if max_spells is None:
        # Mean spell length below 12 days would mean 2500+ regime switches
        # in 30y — far outside anything the dwell calibration produces.
        max_spells = max(64, total_days // 12)
    K = max_spells

    # Counter-expanded uniforms (see counter_uniforms).
    u = counter_uniforms(keys, K)                               # [B, K]

    dwell_cdf = jnp.asarray(reg.dwell_cdf)
    dwell_val = jnp.asarray(reg.dwell_values)
    has_dwell = jnp.asarray(reg.has_dwell)
    p_stay = jnp.asarray(reg.p_stay)
    D = dwell_cdf.shape[1]

    # Regime of spell k alternates from the start regime.
    parity = (jnp.arange(K, dtype=jnp.int32) % 2)[None, :]      # [1, K]
    spell_regime = start_regime[:, None] ^ parity                # [B, K]

    # Inverse-CDF dwell per spell, for both regimes, selected by parity.
    # Exact two-level search: the sorted [D] cdf is viewed as [G, Dg]
    # blocks; level 1 compares u against the G block maxima, level 2
    # against the selected block's Dg entries (block pulled out with a
    # one-hot select, never a gather). idx == min(sum(cdf < u), D-1)
    # bit-for-bit, at ~D/(2*Dg) the compare volume of the flat reduction.
    G = 16
    Dg = (D + G - 1) // G
    pad = G * Dg - D
    dwells = []
    for r in range(2):
        cdf_p = jnp.pad(dwell_cdf[r], (0, pad), constant_values=jnp.inf)
        val_p = jnp.pad(dwell_val[r], (0, pad))
        cdfm = cdf_p.reshape(G, Dg)                 # [G, Dg] sorted blocks
        valm = val_p.reshape(G, Dg)
        c1 = jnp.sum((cdfm[None, None, :, -1] < u[:, :, None])
                     .astype(jnp.int32), axis=-1)    # [B, K] blocks below u
        # Clamp to the last block containing REAL entries, not G-1: when u
        # exceeds every real cdf value and the real entries end exactly on
        # a block boundary, block G-1 can be all padding and the one-hot
        # pull below would return the pad value instead of dwell_val[D-1].
        # Unreachable with build_dwell_tables output (cdf ends at 1.0,
        # u < 1) but restores exact min(sum(cdf<u), D-1) equivalence for
        # any custom cdf that ends below 1.0.
        i_hi = jnp.minimum(c1, (D - 1) // Dg)
        hi_oh = (i_hi[:, :, None]
                 == jnp.arange(G)[None, None, :])    # [B, K, G]
        blk = jnp.sum(jnp.where(hi_oh[..., None], cdfm[None, None], 0.0),
                      axis=2)                        # [B, K, Dg]
        c2 = jnp.sum((blk < u[:, :, None]).astype(jnp.int32), axis=-1)
        idx = jnp.minimum(i_hi * Dg + c2, D - 1)
        vrow = jnp.sum(jnp.where(hi_oh[..., None], valm[None, None], 0.0),
                       axis=2)                       # [B, K, Dg]
        lo_oh = ((idx % Dg)[:, :, None]
                 == jnp.arange(Dg)[None, None, :])
        emp = jnp.sum(jnp.where(lo_oh, vrow, 0.0), axis=-1)
        geo = jnp.maximum(jnp.ceil(jnp.log1p(-u) / jnp.log(p_stay[r])), 1.0)
        dwells.append(jnp.where(has_dwell[r] > 0, emp, geo))
    dwell = jnp.where(spell_regime == 0, dwells[0], dwells[1])   # [B, K]

    # Spell boundaries -> parity of completed spells per day. The scan
    # engine decrements a float remainder, so a non-integer dwell d acts as
    # ceil(d) days — match that exactly.
    # completed[t] = #{spells with end <= t} (day t of a boundary belongs to
    # the NEXT spell). Decomposed over W-day buckets so the O(K*T) count
    # runs as a batched matrix product instead of a compare-reduction:
    #   ends <= t  <=>  eb < tb  OR  (eb == tb AND ep <= tp)
    #   with eb = ends // W, ep = ends % W, tb = t // W, tp = t % W.
    #   within[b, tb, tp] = sum_k H[b,k,tb] * C[b,k,tp]   (batched matmul)
    #   coarse[b, tb]     = exclusive-cumsum of within[b, :, W-1]
    # One-hot operands are exact in bf16 and accumulate in f32, so counts
    # (<= W per bucket) are exact integers; parity is exact.
    ends = jnp.cumsum(jnp.ceil(dwell).astype(jnp.int32), axis=1)  # [B, K]
    W = 64
    nb = (total_days + W - 1) // W
    eb = ends // W                                   # [B, K]
    ep = ends - eb * W
    H = (eb[:, :, None] == jnp.arange(nb)[None, None, :])          # [B,K,nb]
    C = (ep[:, :, None] <= jnp.arange(W)[None, None, :])           # [B,K,W]
    within = jnp.einsum("bkt,bkp->btp", H.astype(jnp.bfloat16),
                        C.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)        # [B,nb,W]
    within = within.astype(jnp.int32)
    bucket_counts = within[:, :, -1]                               # [B, nb]
    coarse = jnp.cumsum(bucket_counts, axis=1) - bucket_counts     # exclusive
    completed = (coarse[:, :, None] + within).reshape(B, nb * W)
    completed = completed[:, :total_days]                          # [B, T]
    return (start_regime[:, None] ^ (completed % 2)).astype(jnp.int32)


def draw_innovations_fast(model: SimModel, run_key, trial_ids, antithetic,
                          sim_days: int, buffer_days: int = 0,
                          random_start_method: str = "offset",
                          anchors=None,
                          joint_draws: bool = True,
                          aux_draws: bool = True,
                          max_spells: int | None = None) -> Innovations:
    """Production innovation draws: same streams-per-(trial, purpose)
    discipline and identical distributions, using the fast samplers and the
    batched regime scan. Antithetic pairs still share trial keys and negate
    the joint normals only. ``max_spells`` (static) bounds the spell-path
    draw count — see plan_max_spells."""
    from letf_tpu.ops import rng as rngs

    model = _to_device(model)
    total_days = sim_days + buffer_days
    B = trial_ids.shape[0]
    tks = jax.vmap(lambda t: rngs.trial_key(run_key, t))(trial_ids)

    def streams(sid):
        return jax.vmap(lambda k: rngs.stream(k, sid))(tks)

    # ---- start conditions (same logic as the per-trial path) ----
    kstart = streams(rngs.START)
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(kstart)
    k_off, k_reg, k_vix0 = ks[:, 0], ks[:, 1], ks[:, 2]
    if random_start_method == "offset" and buffer_days > 0:
        min_offset = min(50, buffer_days // 4)
        start_offset = jax.vmap(
            lambda k: jax.random.randint(k, (), min_offset, buffer_days))(k_off)
        start_regime = jnp.zeros((B,), jnp.int32)
    elif random_start_method == "regime_only" or (
            random_start_method == "historical_anchor" and anchors is None):
        start_offset = jnp.zeros((B,), jnp.int32)
        probs = jnp.asarray(model.regime.start_probs)
        uu = jax.vmap(lambda k: jax.random.uniform(k, ()))(k_reg)
        start_regime = jnp.sum(jnp.cumsum(probs / probs.sum())[None, :]
                               < uu[:, None], axis=1).astype(jnp.int32)
    elif random_start_method == "historical_anchor":
        anchor_regimes, anchor_vix_arr = anchors
        idx = jax.vmap(lambda k: jax.random.randint(
            k, (), 0, anchor_regimes.shape[0]))(k_reg)
        start_offset = jnp.zeros((B,), jnp.int32)
        start_regime = jnp.asarray(anchor_regimes)[idx].astype(jnp.int32)
    else:
        start_offset = jnp.zeros((B,), jnp.int32)
        start_regime = jnp.zeros((B,), jnp.int32)
    vr = jnp.asarray([cfg.INITIAL_VIX_RANGE[r] for r in range(cfg.N_REGIMES)])
    lo = vr[start_regime, 0]
    hi = vr[start_regime, 1]
    u0 = jax.vmap(lambda k: jax.random.uniform(k, ()))(k_vix0)
    initial_vix = lo + u0 * (hi - lo)
    if random_start_method == "historical_anchor" and anchors is not None:
        initial_vix = jnp.asarray(anchors[1])[idx]

    regime_full = simulate_regime_paths_spell(
        model, streams(rngs.REGIME), start_regime, total_days,
        max_spells=max_spells)

    if not joint_draws:
        # Callers that need only the regime/start draws (emit_regime_paths)
        # skip the joint/VIX/IRX innovations.
        eps = u_chi = vix_noise = irx_noise = None
    else:
        sign = jnp.where(antithetic, -1.0, 1.0)[:, None, None]
        k_eps = streams(rngs.JOINT_EPS)
        eps = sign * jax.vmap(
            lambda k: jax.random.normal(k, (total_days, 3)))(k_eps)

        # chi-square(nu_r) from ONE normal per day via the tabulated
        # log-quantile Chebyshev (params.chi_cheb) — no gamma rejection
        # loops, no [B, R, T] staging tensor, no gather.
        z_chi = jax.vmap(lambda k: jax.random.normal(k, (total_days,)))(
            streams(rngs.JOINT_CHI))
        cheb = jnp.asarray(model.joint.chi_cheb)             # [R, K]
        chi_r = [chi2_from_normal(z_chi, cheb[r])
                 for r in range(cheb.shape[0])]
        if len(chi_r) == 2:
            u_chi = jnp.where(regime_full == 1, chi_r[1], chi_r[0])
        else:
            u_chi = jnp.select([regime_full == r for r in range(len(chi_r))],
                               chi_r)

        vix_noise = jax.vmap(lambda k: jax.random.normal(k, (total_days,)))(
            streams(rngs.VIX_NOISE))
        irx_noise = jax.vmap(lambda k: jax.random.normal(k, (total_days,)))(
            streams(rngs.IRX_NOISE))

    if not aux_draws:
        # Same for the stress/jump/TE innovations (~11 [B, S] tensors).
        stress_norms = u_jump = t_abs = jump_sign = te_draws = None
    else:
        stress_norms = jax.vmap(lambda k: jax.random.normal(k, (sim_days, 2)))(
            streams(rngs.STRESS_NORM))
        kj = jax.vmap(lambda k: jax.random.split(k, 3))(
            streams(rngs.STRESS_JUMP))
        u_jump = jax.vmap(lambda k: jax.random.uniform(k, (sim_days,)))(
            kj[:, 0])
        t_abs = jnp.abs(jax.vmap(
            lambda k: t_int_df(k, 5, (sim_days,)))(kj[:, 1]))
        jump_sign = jnp.where(
            jax.vmap(lambda k: jax.random.uniform(k, (sim_days,)))(kj[:, 2])
            < 0.5, -1.0, 1.0)

        # TE t draws with static integer dfs via the fast sampler.
        k_te = streams(rngs.TRACKING)
        static_dfs = cfg.asset_table().te_df
        cols_by_df = {}
        for a in range(_A):
            cols_by_df.setdefault(int(static_dfs[a]), []).append(a)
        te_parts = {}
        for df_val, cols in sorted(cols_by_df.items()):
            draws = jax.vmap(lambda k: t_int_df(
                jax.random.fold_in(k, df_val), df_val,
                (sim_days, len(cols))))(k_te)
            for j, a in enumerate(cols):
                te_parts[a] = draws[..., j]
        te_draws = jnp.stack([te_parts[a] for a in range(_A)], axis=-1)

    return Innovations(
        start_offset=start_offset, start_regime=start_regime,
        initial_vix=initial_vix, regime_full=regime_full, eps=eps,
        u_chi=u_chi, vix_noise=vix_noise, irx_noise=irx_noise,
        stress_norms=stress_norms, u_jump=u_jump, t_abs=t_abs,
        jump_sign=jump_sign, te_draws=te_draws,
        mode_key=streams(rngs.BOOTSTRAP))


def window_series(x_full, vix_full, irx_full, regime_full, start_offset,
                  sim_days: int):
    """Per-trial offset windowing of the generated series:
    out[b, s] = in[b, s + start_offset[b]].

    Returns (spy, qqq, tlt, vix, irx [B, S] float, regime [B, S] int32).
    A binary shift-select tree (~11 dense conditional rolls) instead of a
    gather; bit-identical to take_along_axis (pure data movement)."""
    B, T = regime_full.shape
    if T == sim_days:
        # No buffer => every start_offset is 0 (only the 'offset' method
        # draws nonzero offsets, and it requires buffer_days > 0): skip
        # the windowing entirely.
        return (x_full[..., 0], x_full[..., 1], x_full[..., 2],
                vix_full, irx_full, regime_full)

    dt = x_full.dtype
    offs = start_offset                                 # [B]
    packed = jnp.concatenate([
        x_full, vix_full[..., None], irx_full[..., None],
        regime_full.astype(dt)[..., None]], axis=-1)    # [B, T, 6]
    max_off = T - sim_days
    for k in reversed(range(max(1, int(max_off).bit_length()))):
        # MSB-first: once bit k is applied the remaining shift is at most
        # 2^k - 1, so the working tensor truncates to sim_days + 2^k - 1 —
        # the early (largest) levels shrink the copies the later levels
        # pay for.
        shift = 1 << k
        bit = ((offs >> k) & 1) > 0
        rolled = jnp.concatenate(
            [packed[:, shift:], packed[:, :shift]], axis=1)
        packed = jnp.where(bit[:, None, None], rolled,
                           packed)[:, :sim_days + shift - 1]
    w = packed[:, :sim_days]
    spy, qqq, tlt = w[..., 0], w[..., 1], w[..., 2]
    vix, irx = w[..., 3], w[..., 4]
    regime = w[..., 5].astype(jnp.int32)
    return spy, qqq, tlt, vix, irx, regime


def _gather_r(table, r):
    """table [R, ...] gathered by regime r [B] -> [B, ...] (R=2 fast path)."""
    if table.shape[0] == 2:
        t0 = table[0]
        t1 = table[1]
        cond = (r == 1)
        cond = cond.reshape(cond.shape + (1,) * (t0.ndim))
        return jnp.where(cond, t1, t0)
    return table[r]


def simulate_joint_and_vix_batched(model: SimModel, regime, eps, u_chi,
                                   vix_noise, moment_matching: bool = True):
    """Batched joint multivariate-t + GARCH/DCC + VIX.

    regime [B, T] int32; eps [B, T, 3]; u_chi, vix_noise [B, T].
    Returns (x [B, T, 3], vix [B, T]). State lives as [B]-shaped components.
    """
    J, V, reg = model.joint, model.vix, model.regime
    dt = eps.dtype
    B, T = regime.shape

    # Per-regime parameter tables pre-split into components [R].
    mu = jnp.asarray(J.mu, dt)                  # [R, 3]
    lv = jnp.asarray(J.long_var, dt)            # [R, 3]
    rb = jnp.asarray(J.rbar, dt)                # [R, 3, 3]
    alpha_t = jnp.asarray(J.garch_alpha, dt)
    beta_t = jnp.asarray(J.garch_beta, dt)
    a_t = jnp.asarray(J.dcc_a, dt)
    b_t = jnp.asarray(J.dcc_b, dt)
    nu_t = jnp.asarray(J.nu, dt)
    vphi = jnp.asarray(V.phi, dt)
    vtarget = jnp.asarray(V.target, dt)
    vnoise = jnp.asarray(V.noise_std, dt)
    vjthr = jnp.asarray(V.jump_threshold, dt)
    vjscl = jnp.asarray(V.jump_scale, dt)
    vbase = jnp.asarray(V.base, dt)
    dstd = jnp.asarray(reg.daily_std, dt)

    # Time-major inputs.
    regime_t = jnp.moveaxis(regime, 1, 0)                  # [T, B]
    eps_t = jnp.moveaxis(eps, 1, 0)                        # [T, B, 3]
    u_t = jnp.moveaxis(u_chi, 1, 0)                        # [T, B]
    vn_t = jnp.moveaxis(vix_noise, 1, 0)                   # [T, B]

    eps0, eps1, eps2 = eps_t[..., 0], eps_t[..., 1], eps_t[..., 2]

    idx = (jnp.zeros((B,), jnp.int32), None)  # placeholder (unused)
    del idx

    def g(tab, r):
        """[R] table -> [B] by regime (R=2 select)."""
        return jnp.where(r == 1, tab[1], tab[0])

    def g3(tab, r, k):
        """[R, 3] table, component k -> [B]."""
        return jnp.where(r == 1, tab[1, k], tab[0, k])

    def g33(tab, r, i, j):
        return jnp.where(r == 1, tab[1, i, j], tab[0, i, j])

    def step(carry, xs):
        (h0, h1, h2, q00, q01, q02, q11, q12, q22,
         z0, z1, z2, prev_r, vix_prev, t) = carry
        r, e0, e1, e2, u, vn = xs

        alpha = g(alpha_t, r)
        beta = g(beta_t, r)
        ad = g(a_t, r)
        bd = g(b_t, r)
        nu = g(nu_t, r)

        first = t == 0
        switch = (r != prev_r) & (~first)

        def sel(lv_k, garch_k, blend_k, h_k):
            return jnp.where(first, lv_k,
                             jnp.where(switch, 0.10 * lv_k + 0.90 * h_k,
                                       garch_k))

        lv0, lv1, lv2 = g3(lv, r, 0), g3(lv, r, 1), g3(lv, r, 2)
        one_ab = 1.0 - alpha - beta
        g0 = jnp.clip(one_ab * lv0 + alpha * z0 * z0 * h0 + beta * h0, 1e-10, None)
        g1 = jnp.clip(one_ab * lv1 + alpha * z1 * z1 * h1 + beta * h1, 1e-10, None)
        g2 = jnp.clip(one_ab * lv2 + alpha * z2 * z2 * h2 + beta * h2, 1e-10, None)
        h0n = sel(lv0, g0, None, h0)
        h1n = sel(lv1, g1, None, h1)
        h2n = sel(lv2, g2, None, h2)

        one_abd = 1.0 - ad - bd

        def qsel(rb_ij, dcc_ij, q_ij):
            return jnp.where(first, rb_ij,
                             jnp.where(switch, 0.10 * rb_ij + 0.90 * q_ij,
                                       dcc_ij))

        rb00, rb01, rb02 = g33(rb, r, 0, 0), g33(rb, r, 0, 1), g33(rb, r, 0, 2)
        rb11, rb12, rb22 = g33(rb, r, 1, 1), g33(rb, r, 1, 2), g33(rb, r, 2, 2)
        q00n = qsel(rb00, one_abd * rb00 + ad * z0 * z0 + bd * q00, q00)
        q01n = qsel(rb01, one_abd * rb01 + ad * z0 * z1 + bd * q01, q01)
        q02n = qsel(rb02, one_abd * rb02 + ad * z0 * z2 + bd * q02, q02)
        q11n = qsel(rb11, one_abd * rb11 + ad * z1 * z1 + bd * q11, q11)
        q12n = qsel(rb12, one_abd * rb12 + ad * z1 * z2 + bd * q12, q12)
        q22n = qsel(rb22, one_abd * rb22 + ad * z2 * z2 + bd * q22, q22)

        # R_t = Q / outer(d, d); cov = outer(sqrt(h), sqrt(h)) * R_t.
        d0 = jnp.sqrt(jnp.clip(q00n, 1e-12, None))
        d1 = jnp.sqrt(jnp.clip(q11n, 1e-12, None))
        d2 = jnp.sqrt(jnp.clip(q22n, 1e-12, None))
        s0 = jnp.sqrt(h0n)
        s1 = jnp.sqrt(h1n)
        s2 = jnp.sqrt(h2n)
        c00 = (q00n / (d0 * d0)) * s0 * s0
        c01 = (q01n / (d0 * d1)) * s0 * s1
        c02 = (q02n / (d0 * d2)) * s0 * s2
        c11 = (q11n / (d1 * d1)) * s1 * s1
        c12 = (q12n / (d1 * d2)) * s1 * s2
        c22 = (q22n / (d2 * d2)) * s2 * s2

        # Closed-form 3x3 Cholesky, componentwise (path_engine._chol3).
        epsv = 1e-18
        l00 = jnp.sqrt(jnp.maximum(c00, epsv))
        l10 = c01 / l00
        l20 = c02 / l00
        l11 = jnp.sqrt(jnp.maximum(c11 - l10 * l10, epsv))
        l21 = (c12 - l20 * l10) / l11
        l22 = jnp.sqrt(jnp.maximum(c22 - l20 * l20 - l21 * l21, epsv))

        zz0 = l00 * e0
        zz1 = l10 * e0 + l11 * e1
        zz2 = l20 * e0 + l21 * e1 + l22 * e2

        scale = jnp.sqrt(nu / jnp.maximum(u, 1e-12))
        mu0, mu1, mu2 = g3(mu, r, 0), g3(mu, r, 1), g3(mu, r, 2)
        x0 = jnp.clip(mu0 + zz0 * scale, -0.95, 4.0)
        x1 = jnp.clip(mu1 + zz1 * scale, -0.95, 4.0)
        x2 = jnp.clip(mu2 + zz2 * scale, -0.95, 4.0)

        z0n = (x0 - mu0) / jnp.sqrt(jnp.clip(h0n, 1e-10, None))
        z1n = (x1 - mu1) / jnp.sqrt(jnp.clip(h1n, 1e-10, None))
        z2n = (x2 - mu2) / jnp.sqrt(jnp.clip(h2n, 1e-10, None))

        denom = jnp.maximum(g(dstd, r), 1e-4)
        shock = jnp.maximum(-x0, 0.0) / denom
        vjump = g(vjscl, r) * jnp.maximum(0.0, shock - g(vjthr, r))
        phi = g(vphi, r)
        vix_ar = jnp.maximum(10.0, phi * vix_prev + (1 - phi) * g(vtarget, r)
                             + vjump + g(vnoise, r) * vn)
        vix_t = jnp.where(first, g(vbase, r), vix_ar)

        carry = (h0n, h1n, h2n, q00n, q01n, q02n, q11n, q12n, q22n,
                 z0n, z1n, z2n, r, vix_t, t + 1)
        return carry, (x0, x1, x2, vix_t)

    zB = jnp.zeros((B,), dt)
    init = (zB, zB, zB, zB, zB, zB, zB, zB, zB, zB, zB, zB,
            regime_t[0], zB, jnp.int32(0))
    _, (x0, x1, x2, vix) = lax.scan(
        step, init, (regime_t, eps0, eps1, eps2, u_t, vn_t))

    x = jnp.stack([jnp.moveaxis(x0, 0, 1), jnp.moveaxis(x1, 0, 1),
                   jnp.moveaxis(x2, 0, 1)], axis=-1)          # [B, T, 3]
    vix = jnp.moveaxis(vix, 0, 1)                             # [B, T]

    if moment_matching:
        theo = jnp.asarray(J.theo_mean, dt)
        x = x + (theo[None, None, :] - x.mean(axis=1, keepdims=True)) * 0.1
    return x, vix


def simulate_stress_batched(model: SimModel, regime, vix, norms, u_jump, t_abs):
    """Batched latent stress: regime/vix [B, S]; norms [B, S, 2]."""
    S = model.stress
    dt = vix.dtype
    B = regime.shape[0]

    def g(tab, r):
        tab = jnp.asarray(tab, dt)
        return jnp.where(r == 1, tab[1], tab[0])

    regime_t = jnp.moveaxis(regime, 1, 0)
    vix_t = jnp.moveaxis(vix, 1, 0)
    n0 = jnp.moveaxis(norms[..., 0], 1, 0)
    n1 = jnp.moveaxis(norms[..., 1], 1, 0)
    uj = jnp.moveaxis(u_jump, 1, 0)
    ta = jnp.moveaxis(t_abs, 1, 0)

    def step(carry, xs):
        liq, cred, t = carry
        r, v, a, b, u, tv = xs
        lmu, cmu = g(S.liq_mu, r), g(S.credit_mu, r)
        liq_new = jnp.clip(lmu + g(S.liq_phi, r) * (liq - lmu)
                           + g(S.liq_sigma, r) * a, 0.0, 3.0)
        cred_new = jnp.clip(cmu + g(S.credit_phi, r) * (cred - cmu)
                            + g(S.credit_sigma, r) * b, 0.0, 3.0)
        first = t == 0
        liq_new = jnp.where(first, lmu, liq_new)
        cred_new = jnp.where(first, cmu, cred_new)
        vix_amp = jnp.maximum((v - 25.0) / 30.0, 0.0)
        p = jnp.clip(g(S.jump_base_prob, r) + 0.008 * vix_amp
                     + 0.003 * liq_new, 0.0, 0.01)
        jump = jnp.where((u < p) & (~first), tv * g(S.jump_scale, r), 0.0)
        return (liq_new, cred_new, t + 1), (liq_new, cred_new, jump)

    zB = jnp.zeros((B,), dt)
    _, (liq, cred, jump) = lax.scan(step, (zB, zB, jnp.int32(0)),
                                    (regime_t, vix_t, n0, n1, uj, ta))
    return (jnp.moveaxis(liq, 0, 1), jnp.moveaxis(cred, 0, 1),
            jnp.moveaxis(jump, 0, 1))


def simulate_tracking_error_batched(model: SimModel, regime, vix, underlying,
                                    t_draws):
    """Batched TE: one scan whose state is [B, A]."""
    Tk = model.tracking
    dt = vix.dtype
    B = regime.shape[0]
    rho = jnp.asarray(Tk.rho, dt)
    sq = jnp.sqrt(jnp.maximum(1.0 - rho ** 2, 1e-6))
    te_scale = jnp.asarray(Tk.te_scale, dt)
    downside = jnp.asarray(Tk.downside_mult, dt)
    ema_alpha = 2.0 / (126 + 1)

    vix_mult = jnp.clip((vix / 20.0) ** 0.5, 0.5, 1.5)
    regime_mult = jnp.where(regime == 0, 1.0, 1.15)
    move_mult = ((1.0 + 0.3 * jnp.abs(underlying))
                 * jnp.where(underlying < 0, downside[None, None, :], 0.98))
    innov = t_draws * te_scale[None, None, :] * (vix_mult * regime_mult)[..., None]

    innov_t = jnp.moveaxis(innov, 1, 0)         # [S, B, A]
    move_t = jnp.moveaxis(move_mult, 1, 0)

    def step(carry, xs):
        te, bias, t = carry
        iv, mv = xs
        te_new = rho[None, :] * te + sq[None, :] * iv * mv
        te_new = jnp.where(t == 0, 0.0, te_new)
        bias_new = ema_alpha * te_new + (1 - ema_alpha) * bias
        return (te_new, bias_new, t + 1), te_new - bias_new

    zBA = jnp.zeros((B, _A), dt)
    _, te = lax.scan(step, (zBA, zBA, jnp.int32(0)), (innov_t, move_t))
    te = jnp.moveaxis(te, 0, 1)                 # [B, S, A]

    cap = jnp.asarray(Tk.clip_limit, dt)
    return jnp.where(cap[None, None, :] > 0,
                     cap * jnp.tanh(te / cap), te)


def path_from_innovations_batched(model: SimModel, innov: Innovations,
                                  sim_days: int,
                                  moment_matching: bool = True,
                                  use_funding_model: bool = True,
                                  use_stress: bool = True) -> PathOutputs:
    """Batched twin of path_from_innovations: [B, ...] innovations in,
    [B, ...] PathOutputs out, numerics identical."""
    model = _to_device(model)
    regime_full = innov.regime_full                     # [B, T]
    B, T = regime_full.shape

    x_full, vix_full = simulate_joint_and_vix_batched(
        model, regime_full, innov.eps, innov.u_chi, innov.vix_noise,
        moment_matching=moment_matching)

    irx_full = jnp.clip(
        _gather_r(jnp.asarray(model.irx_base, x_full.dtype), regime_full)
        + 0.5 * innov.irx_noise, 0.0, 15.0)

    spy, qqq, tlt, vix, irx, regime = window_series(
        x_full, vix_full, irx_full, regime_full, innov.start_offset,
        sim_days)

    if use_stress:
        liq, cred, jump = simulate_stress_batched(
            model, regime, vix, innov.stress_norms, innov.u_jump, innov.t_abs)
        signed_jump = jump * innov.jump_sign
        spy = jnp.clip(spy - signed_jump, -0.95, 3.0)
        qqq = jnp.clip(qqq - 1.12 * signed_jump, -0.95, 4.0)
        jump_days = jnp.sum(jump > 0, axis=1).astype(jnp.int32)
        liq_mean, cred_mean = liq.mean(axis=1), cred.mean(axis=1)
    else:
        liq = cred = jnp.zeros_like(vix)
        jump_days = jnp.zeros((B,), jnp.int32)
        liq_mean = cred_mean = jnp.zeros((B,), vix.dtype)

    risk_free = jnp.clip(irx, 0.0, 20.0) / 100.0

    streams = jnp.stack([spy, qqq, tlt], axis=-1)
    # underlying[..., a] = streams[..., und_idx[a]] * beta[a] as a one-hot
    # contraction (tiny matmul) instead of a [B, S, A] gather. HIGHEST
    # precision: a default-precision f32 contraction may run in TF32 on
    # the GPU, rounding every trial-day's return to ~3 decimal digits.
    und_oh = (jnp.asarray(model.assets.underlying)[None, :]
              == jnp.arange(3)[:, None]).astype(streams.dtype)     # [3, A]
    beta = jnp.asarray(model.assets.beta, streams.dtype)
    underlying = jnp.einsum("bsk,ka->bsa", streams, und_oh * beta[None, :],
                            precision=lax.Precision.HIGHEST)

    spread = borrow_spread_series(model, vix, risk_free, liq, cred,
                                  use_funding_model=use_funding_model)
    P = model.assets
    lev = jnp.asarray(P.leverage, underlying.dtype)
    sp = (jnp.asarray(P.fallback_spread, underlying.dtype)[None, None, :]
          if spread is None else spread[..., None])
    borrow_daily = (jnp.maximum(lev - 1.0, 0.0)[None, None, :]
                    * jnp.maximum(risk_free[..., None] + sp, 0.0) / 252.0)
    lev_ret = (lev[None, None, :] * underlying
               - jnp.asarray(P.expense_ratio, underlying.dtype)[None, None, :]
               / 252.0 - borrow_daily)

    te = simulate_tracking_error_batched(model, regime, vix, underlying,
                                         innov.te_draws)
    etf_ret = jnp.clip(lev_ret + te, -0.999, 10.0)
    cash_ret = _gather_r(jnp.asarray(model.cash_rate, vix.dtype),
                         regime) / 252.0

    return _finish_path(model, innov, etf_ret, tlt, spy, qqq, vix, regime,
                        cash_ret, risk_free, jump_days, liq_mean, cred_mean)


def _finish_path(model, innov, etf_ret, tlt, spy, qqq, vix, regime,
                 cash_ret, risk_free, jump_days, liq_mean,
                 cred_mean) -> PathOutputs:
    """Validity checks + repair pass + PathOutputs assembly."""
    finite_pre = (jnp.all(jnp.isfinite(etf_ret), axis=(1, 2))
                  & jnp.all(jnp.isfinite(tlt), axis=1)
                  & jnp.all(jnp.isfinite(vix), axis=1))
    vix_ok = (jnp.all(jnp.isfinite(vix), axis=1)
              & (vix.min(axis=1) >= 5.0) & (vix.max(axis=1) <= 120.0))
    valid_pre = finite_pre & vix_ok

    # Repair pass — twin of path_engine.path_from_innovations (reference
    # engine.py:553-562): bound + zero non-finite returns; VIX is not
    # repaired. Identity on valid paths.
    repaired = ~valid_pre
    etf_ret = jnp.clip(jnp.where(jnp.isfinite(etf_ret), etf_ret, 0.0),
                       -0.999, 10.0)
    tlt = jnp.clip(jnp.where(jnp.isfinite(tlt), tlt, 0.0), -0.999, 10.0)
    valid = vix_ok

    return PathOutputs(
        etf_ret=etf_ret, tlt_ret=tlt, spy_ret=spy, qqq_ret=qqq, vix=vix,
        regime=regime, cash_ret=cash_ret, risk_free=risk_free,
        start_offset=innov.start_offset, start_regime=innov.start_regime,
        initial_vix=innov.initial_vix, jump_days=jump_days,
        liq_mean=liq_mean, credit_mean=cred_mean, valid=valid,
        repaired=repaired, path_finite=finite_pre, vix_ok=vix_ok)


def generate_paths_batched(model: SimModel, run_key, trial_ids, antithetic,
                           sim_days: int, buffer_days: int = 0,
                           random_start_method: str = "offset",
                           moment_matching: bool = True,
                           use_funding_model: bool = True,
                           use_stress: bool = True,
                           fast_draws: bool = True,
                           anchors=None,
                           max_spells: int | None = None) -> PathOutputs:
    """Batched path generation (institutional_v1 mode).

    fast_draws=True uses the cheap exact samplers (distribution-equivalent
    streams); False reproduces the per-trial engine's draws bit-for-bit."""
    if not fast_draws:
        innov = draw_innovations_batched(model, run_key, trial_ids,
                                         antithetic, sim_days, buffer_days,
                                         random_start_method, anchors=anchors)
        return path_from_innovations_batched(
            model, innov, sim_days, moment_matching=moment_matching,
            use_funding_model=use_funding_model, use_stress=use_stress)

    innov = draw_innovations_fast(model, run_key, trial_ids, antithetic,
                                  sim_days, buffer_days,
                                  random_start_method, anchors=anchors,
                                  max_spells=max_spells)
    return path_from_innovations_batched(
        model, innov, sim_days, moment_matching=moment_matching,
        use_funding_model=use_funding_model, use_stress=use_stress)
