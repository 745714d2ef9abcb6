"""Calibration: fit every stochastic model from historical data.

Parity surface (letf/calibration.py:16-944), same dict outputs so the
SimModel builder and any reference-format consumer can use them:

- calibrate_regime_model_volatility : volatility-driven 2-regime fit with
  probabilistic stress inference, transition matrix, empirical dwell-time
  samples, steady state, and VIX dynamics
- calibrate_vix_dynamics            : per-regime AR(1) phi / noise / jump
- calibrate_joint_return_model      : per-regime mu/cov/nu + GARCH/DCC
  parameters. The reference's optional `arch` dependency is replaced by a
  JAX route: an optax/jax maximum-likelihood GARCH(1,1) fit
  (device-jitted) with the reference's autocorrelation proxy as fallback.
- calibrate_funding_spread_model    : ridge regression of implied borrow
  spread on VIX-stress / inverted-curve / liquidity / credit covariates
- calibrate_stress_state_model      : AR(1) params for latent channels
- calibrate_tracking_residual_model : per-asset residual AR(1) vs expected
  L*idx - financing - expense
- calibrate_correlations_time_varying + defaults
- predict_borrow_spread_series
- calibrate_all                     : the orchestrator's one-shot helper
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
from scipy import stats

from letf_tpu import config as cfg
from letf_tpu.utils import (
    compute_high_vol_probability,
    infer_regime_from_vix,
    load_cache,
    nearest_psd_matrix,
    save_cache,
)

R = cfg.N_REGIMES


# ---------------------------------------------------------------------------
# Regime model
# ---------------------------------------------------------------------------

def calibrate_regime_model_volatility(df: pd.DataFrame) -> Dict:
    """Volatility-driven regime fit: stress-score inference with hysteresis,
    per-regime return stats, transition matrix, empirical dwell samples,
    steady state, and VIX dynamics."""
    cached = load_cache(cfg.REGIME_MODEL_CACHE)
    if cached is not None:
        print("[OK] Using cached regime model")
        return cached

    print("\nCalibrating volatility-driven regime model...")
    vix_series = df["VIX"].values
    realized_vol = (df["SPY_Ret"].rolling(20, min_periods=5).std()
                    .bfill().fillna(0) * np.sqrt(252))
    term_spread = ((df["TNX"] - df["IRX"]).values
                   if "TNX" in df.columns and "IRX" in df.columns else None)

    regimes = infer_regime_from_vix(vix_series, realized_vol.values, term_spread)
    p_high = compute_high_vol_probability(vix_series, realized_vol.values,
                                          term_spread)

    regime_params = {}
    spy = df["SPY_Ret"].values
    for rid in range(R):
        mask = regimes == rid
        rets = spy[mask]
        daily_mean = float(rets.mean()) if mask.sum() > 0 else 0.0
        daily_std = float(rets.std()) if mask.sum() > 0 else 0.01
        regime_params[rid] = {
            "daily_mean": daily_mean,
            "daily_std": daily_std,
            "annual_mean": daily_mean * 252,
            "annual_vol": daily_std * np.sqrt(252),
            "frequency": mask.sum() / max(len(regimes), 1),
            "avg_vix": (float(np.nanmean(vix_series[mask]))
                        if mask.sum() > 0 else 20.0),
        }

    transitions = np.zeros((R, R))
    for a, b in zip(regimes[:-1], regimes[1:]):
        transitions[int(a), int(b)] += 1
    row_sums = transitions.sum(axis=1, keepdims=True)
    row_sums[row_sums == 0] = 1.0
    tm = transitions / row_sums
    tm = np.nan_to_num(tm, nan=0.0, posinf=0.0, neginf=0.0)
    for i in range(R):
        rs = tm[i].sum()
        if rs <= 0:
            tm[i, i] = 1.0
        else:
            tm[i] = tm[i] / rs

    for i in range(R):
        p_stay = tm[i, i]
        regime_params[i]["avg_duration_days"] = (1.0 / (1.0 - p_stay)
                                                 if p_stay < 1.0 else np.inf)

    duration_samples = {i: [] for i in range(R)}
    if len(regimes) > 0:
        run_regime, run_len = int(regimes[0]), 1
        for r in regimes[1:]:
            if int(r) == run_regime:
                run_len += 1
            else:
                duration_samples[run_regime].append(run_len)
                run_regime, run_len = int(r), 1
        duration_samples[run_regime].append(run_len)
    for i in range(R):
        samples = (duration_samples[i] if duration_samples[i]
                   else [int(max(1, cfg.MIN_REGIME_DURATION[i]))])
        regime_params[i]["duration_median_days"] = float(np.median(samples))
        regime_params[i]["duration_p90_days"] = float(np.percentile(samples, 90))

    eigenvalues, eigenvectors = np.linalg.eig(tm.T)
    idx = np.argmin(np.abs(eigenvalues - 1.0))
    steady = np.real(eigenvectors[:, idx])
    steady = steady / steady.sum()

    expected_return = sum(steady[i] * regime_params[i]["annual_mean"]
                          for i in range(R))
    for i in range(R):
        p = regime_params[i]
        print(f"  {cfg.REGIME_NAMES[i]:<9}: ret {p['annual_mean']:+.1%} "
              f"vol {p['annual_vol']:.1%} freq {p['frequency']:.1%} "
              f"avgVIX {p['avg_vix']:.1f} "
              f"dwell med {p['duration_median_days']:.0f}d")

    result = {
        "regime_params": regime_params,
        "transition_matrix": tm,
        "steady_state": steady,
        "expected_return": expected_return,
        "regimes_historical": regimes,
        "duration_samples": duration_samples,
        "regime_probability_high": p_high,
        "vix_dynamics": calibrate_vix_dynamics(df, regimes),
    }
    save_cache(result, cfg.REGIME_MODEL_CACHE)
    return result


def calibrate_vix_dynamics(df: pd.DataFrame, regimes: np.ndarray) -> Dict:
    """Per-regime VIX AR(1): persistence phi, innovation scale, and the jump
    response to standardized negative equity shocks."""
    vix = df["VIX"].astype(float).values
    spy = df["SPY_Ret"].astype(float).values
    dynamics = {}
    for regime in range(R):
        idx = np.where(regimes == regime)[0]
        if len(idx) < 80:
            dynamics[regime] = {
                "phi": 0.90, "noise_std": 1.25, "jump_threshold_sigma": 2.0,
                "jump_scale": 6.0, "target_vix": 15.0 if regime == 0 else 35.0,
                "residual_skew": 0.0, "residual_kurtosis": 3.0,
            }
            continue

        vix_reg = vix[idx]
        spy_reg = spy[idx]
        target = float(np.nanmedian(vix_reg))

        prev, nxt = vix_reg[:-1], vix_reg[1:]
        valid = np.isfinite(prev) & np.isfinite(nxt)
        if valid.sum() < 30:
            phi, noise_std, residual = 0.90, 1.25, np.zeros(10)
        else:
            x = prev[valid] - target
            y = nxt[valid] - target
            denom = float(np.dot(x, x))
            phi = 0.90 if denom <= 0 else float(np.clip(np.dot(x, y) / denom,
                                                        0.70, 0.985))
            residual = y - phi * x
            noise_std = float(np.clip(np.nanstd(residual), 0.5, 4.0))

        shock_sigma = np.nanstd(spy_reg) or 0.01
        shock_z = np.abs(spy_reg) / shock_sigma
        jump_threshold = float(np.clip(np.nanpercentile(shock_z, 90), 1.5, 3.5))

        vdiff = np.diff(vix_reg)
        excess = np.maximum(0, shock_z[1:] - jump_threshold)
        vj = np.isfinite(vdiff) & np.isfinite(excess)
        if vj.sum() > 20 and np.any(excess[vj] > 0):
            xj, yj = excess[vj], np.maximum(0, vdiff[vj])
            jump_scale = float(np.dot(xj, yj) / (np.dot(xj, xj) + 1e-8))
        else:
            jump_scale = 6.0 if regime == 0 else 9.0
        jump_scale = float(np.clip(jump_scale, 2.0, 15.0))

        dynamics[regime] = {
            "phi": phi, "noise_std": noise_std,
            "jump_threshold_sigma": jump_threshold, "jump_scale": jump_scale,
            "target_vix": target,
            "residual_skew": (float(stats.skew(residual, nan_policy="omit"))
                              if len(residual) > 3 else 0.0),
            "residual_kurtosis": (float(stats.kurtosis(residual, fisher=False,
                                                       nan_policy="omit"))
                                  if len(residual) > 3 else 3.0),
        }
    return dynamics


# ---------------------------------------------------------------------------
# Joint return model (device-side GARCH MLE with proxy fallback)
# ---------------------------------------------------------------------------

def fit_garch11_mle(returns: np.ndarray, nu: float = 8.0,
                    maxiter: int = 300):
    """GARCH(1,1) by Student-t maximum likelihood on device (jit + optax),
    the JAX replacement for the reference's optional `arch`
    dependency (which also fits Student-t GARCH — calibration.py:405-440).

    The t-likelihood matters: Gaussian QML on fat-tailed returns inflates
    alpha because tail events masquerade as ARCH shocks. Parameterized
    through sigmoids for unconstrained optimization; returns (alpha, beta)
    or None on failure."""
    try:
        import jax
        import jax.numpy as jnp
        import optax
    except ImportError:
        return None

    r = np.asarray(returns, float)
    r = r[np.isfinite(r)]
    if len(r) < 200:
        return None
    r = r - r.mean()
    var0 = float(r.var())
    rj = np.asarray(r)
    nu = float(np.clip(nu, 2.5, 30.0))

    def unpack(p):
        alpha = 0.30 * jax.nn.sigmoid(p[0])
        beta = (1.0 - alpha) * 0.999 * jax.nn.sigmoid(p[1])
        omega = var0 * (1.0 - alpha - beta)
        return omega, alpha, beta

    def nll(p, r2):
        omega, alpha, beta = unpack(p)

        def step(h, x2):
            # Score the CURRENT observation against the variance formed from
            # past data only, then update (no look-ahead). Student-t NLL
            # with Var = h: 0.5 log h + (nu+1)/2 log(1 + x^2/(h(nu-2))).
            ll = (0.5 * jnp.log(h)
                  + 0.5 * (nu + 1.0) * jnp.log1p(x2 / (h * (nu - 2.0))))
            h_next = jnp.maximum(omega + alpha * x2 + beta * h, 1e-12)
            return h_next, ll

        _, ll = jax.lax.scan(step, jnp.asarray(var0), r2)
        return jnp.mean(ll)

    @jax.jit
    def fit(r2):
        params = jnp.array([-1.5, 2.0])
        opt = optax.adam(5e-2)
        state = opt.init(params)

        def body(carry, _):
            p, s = carry
            g = jax.grad(nll)(p, r2)
            updates, s = opt.update(g, s)
            return (optax.apply_updates(p, updates), s), None

        (params, _), _ = jax.lax.scan(body, (params, state), None,
                                      length=maxiter)
        return params

    try:
        p = np.asarray(fit(jnp.asarray(rj ** 2)))
        alpha = float(0.30 / (1 + np.exp(-p[0])))
        beta = float((1.0 - alpha) * 0.999 / (1 + np.exp(-p[1])))
        if not (0.001 < alpha < 0.295 and 0 < beta < 1
                and alpha + beta < 0.9999):
            return None
        return alpha, beta
    except Exception:  # noqa: BLE001
        return None


def _acf_proxy(arr: np.ndarray, mu: np.ndarray):
    """Vol-clustering persistence proxy from |r| autocorrelation
    (calibration.py:441-452 fallback)."""
    abs_ret = np.abs(arr - mu)
    if abs_ret.shape[0] <= 2:
        acf1 = 0.25
    else:
        acfs = [np.corrcoef(abs_ret[:-1, j], abs_ret[1:, j])[0, 1]
                for j in range(abs_ret.shape[1])]
        acf1 = float(np.nanmean(acfs))
    if not np.isfinite(acf1):
        acf1 = 0.25
    return acf1


def calibrate_joint_return_model(df: pd.DataFrame, regimes: np.ndarray,
                                 use_mle: bool = True) -> Dict:
    """Regime-conditional multivariate Student-t model over SPY/QQQ/TLT:
    mu, PSD-cleaned cov, kurtosis-mapped nu, GARCH alpha/beta (device MLE
    or ACF proxy), DCC a/b proxies."""
    cached = load_cache(cfg.JOINT_RETURN_MODEL_CACHE)
    if cached is not None:
        return cached

    assets = ["SPY_Ret", "QQQ_Ret", "TLT_Ret"]
    model = {"assets": assets, "regimes": {}}

    for regime in range(R):
        mask = regimes == regime
        reg_df = df.loc[mask, assets].dropna()
        if len(reg_df) < 80:
            mu = np.array([0.08, 0.10, 0.03]) / 252.0
            vol = (np.array([0.16, 0.24, 0.12]) if regime == 0
                   else np.array([0.28, 0.42, 0.16]))
            corr = np.array([
                [1.0, 0.90 if regime == 0 else 0.96, -0.20 if regime == 0 else -0.05],
                [0.90 if regime == 0 else 0.96, 1.0, -0.18 if regime == 0 else -0.03],
                [-0.20 if regime == 0 else -0.05, -0.18 if regime == 0 else -0.03, 1.0],
            ])
            dvol = vol / np.sqrt(252)
            cov = np.outer(dvol, dvol) * corr
            nu = 5.0 if regime == 0 else 4.0
            garch_alpha = 0.06 if regime == 0 else 0.09
            garch_beta = 0.90 if regime == 0 else 0.86
            dcc_a = 0.02 if regime == 0 else 0.04
            dcc_b = 0.95 if regime == 0 else 0.90
        else:
            arr = reg_df.values
            mu = np.nanmean(arr, axis=0)
            cov = np.cov(arr, rowvar=False)
            d = np.sqrt(np.diag(cov))
            cov = nearest_psd_matrix(cov / np.outer(d, d)) * np.outer(d, d)

            k = np.nanmean([stats.kurtosis(reg_df[c], fisher=False,
                                           nan_policy="omit") for c in assets])
            if np.isfinite(k) and k > 3.05:
                nu = float(np.clip(4 + 6 / (k - 3 + 1e-6), 3.2, 12.0))
            else:
                nu = 8.0

            garch_alpha = garch_beta = None
            if use_mle and len(reg_df) >= 200:
                fits = [fit_garch11_mle(reg_df[c].values, nu=nu)
                        for c in assets]
                if all(f is not None for f in fits):
                    garch_alpha = float(np.mean([f[0] for f in fits]))
                    garch_beta = float(np.mean([f[1] for f in fits]))
            if garch_alpha is None:
                acf1 = _acf_proxy(arr, mu)
                garch_alpha = float(np.clip(0.05 + 0.10 * max(acf1, 0),
                                            0.04, 0.15))
                garch_beta = float(np.clip(0.98 - garch_alpha, 0.78, 0.94))

            acf1 = _acf_proxy(arr, mu)
            dcc_a = float(np.clip(0.015 + 0.04 * max(acf1, 0), 0.01, 0.08))
            dcc_b = float(np.clip(0.97 - dcc_a, 0.84, 0.97))

        model["regimes"][regime] = {
            "mu": mu, "cov": cov, "nu": nu,
            "garch_alpha": garch_alpha, "garch_beta": garch_beta,
            "dcc_a": dcc_a, "dcc_b": dcc_b,
        }

    save_cache(model, cfg.JOINT_RETURN_MODEL_CACHE)
    return model


# ---------------------------------------------------------------------------
# Funding spread model
# ---------------------------------------------------------------------------

def calibrate_funding_spread_model(df: pd.DataFrame,
                                   bypass_cache: bool = False) -> Dict[str, float]:
    """Ridge regression of the implied borrow spread (from observed LETF
    return gaps) on VIX-stress / inverted-curve / liquidity / credit
    covariates (calibration.py:593-702)."""
    cached = None if bypass_cache else load_cache(cfg.FUNDING_MODEL_CACHE)
    if cached is not None:
        return cached

    n = len(df)
    default = {
        "base": 0.0050, "beta_vix": 0.00035, "beta_inv_curve": 0.0014,
        "beta_liquidity": 0.0010, "beta_credit": 0.0014,
        "min_spread": 0.0030, "max_spread": 0.0450,
    }
    if n == 0:
        if not bypass_cache:
            save_cache(default, cfg.FUNDING_MODEL_CACHE)
        return default

    vix = df["VIX"].ffill().bfill().fillna(20.0).to_numpy(float)
    irx = df.get("IRX", pd.Series(4.5, index=df.index)) \
        .ffill().bfill().fillna(4.5).to_numpy(float)
    tnx = (df["TNX"].ffill().bfill().fillna(pd.Series(irx + 1.0, index=df.index))
           .to_numpy(float) if "TNX" in df.columns else irx + 1.0)

    term_spread = tnx - irx
    stress = np.maximum(vix - 20.0, 0.0)
    inv_curve = np.maximum(-term_spread, 0.0)
    rv = (df["SPY_Ret"].rolling(20, min_periods=5).std().bfill()
          .fillna(0.15 / np.sqrt(252)).to_numpy(float) * np.sqrt(252))
    liquidity = np.maximum(vix - 18.0, 0.0) / 25.0 + np.maximum(rv - 0.18, 0.0)
    credit = np.maximum(-term_spread, 0.0)

    implied = []
    for asset in ("TQQQ", "UPRO", "SSO"):
        col = f"{asset}_Real_Ret"
        if col not in df.columns:
            continue
        lev = cfg.ASSETS[asset].leverage
        if lev <= 1.0:
            continue
        idx = (df["QQQ_Ret"] if (asset == "TQQQ" and "QQQ_Ret" in df.columns)
               else df["SPY_Ret"])
        expense_daily = cfg.ASSETS[asset].expense_ratio / 252.0
        imp = ((lev * idx.to_numpy(float) - expense_daily
                - df[col].to_numpy(float)) * 252.0 / (lev - 1.0)) - irx / 100.0
        implied.append(imp)

    if implied:
        target = np.nanmedian(np.vstack(implied), axis=0)
    else:
        target = 0.0045 + 0.00035 * stress + 0.0012 * inv_curve

    # Winsorize + masked ridge + spread bounds all run ON DEVICE in f64
    # (ops/fitting.funding_fit_device); the host only stages covariates and
    # applies the small-sample fallback.
    from letf_tpu.ops.fitting import fit_context, funding_fit_device, to_x64

    with fit_context():
        beta_d, min_d, max_d, n_valid = funding_fit_device(
            *to_x64(target, stress, inv_curve, liquidity, credit))
        beta = np.asarray(beta_d)
        min_spread, max_spread = float(min_d), float(max_d)
    if int(n_valid) < 120:
        beta = np.array([0.0045, 0.00035, 0.0014, 0.0010, 0.0014])
        # Bounds still come from the fitted-series percentiles of THIS beta:
        X = np.column_stack([np.ones(n), stress, inv_curve,
                             np.clip(liquidity, 0.0, 3.0),
                             np.clip(credit, 0.0, 3.0)])
        pf = (X @ beta)
        pf = pf[np.isfinite(pf)]
        if pf.size > 10:
            min_spread = float(max(np.nanpercentile(pf, 1.0), 0.0025))
            max_spread = float(min(np.nanpercentile(pf, 99.5), 0.0300))
            if max_spread <= min_spread:
                max_spread = min_spread + 0.005
        else:
            min_spread, max_spread = 0.0030, 0.0300

    model = {
        "base": float(max(beta[0], 0.0015)),
        "beta_vix": float(beta[1]),
        "beta_inv_curve": float(beta[2]),
        "beta_liquidity": float(beta[3]),
        "beta_credit": float(beta[4]),
        "min_spread": min_spread,
        "max_spread": max_spread,
    }
    if not bypass_cache:
        save_cache(model, cfg.FUNDING_MODEL_CACHE)
    return model


def predict_borrow_spread_series(df: pd.DataFrame, funding_model: Dict,
                                 stress_state: Optional[Dict] = None) -> np.ndarray:
    """Annual borrow spread (decimal) from stress covariates
    (calibration.py:833-857) — host-side counterpart of the device
    path-engine's fused spread computation."""
    vix = df["VIX"].ffill().bfill().fillna(20.0).values
    stress = np.maximum(vix - 20.0, 0.0)
    inv_curve = np.zeros(len(df))
    if "TNX" in df.columns and "IRX" in df.columns:
        inv_curve = np.maximum(-(df["TNX"] - df["IRX"]).fillna(0.0).values, 0.0)
    spread = (funding_model["base"] + funding_model["beta_vix"] * stress
              + funding_model["beta_inv_curve"] * inv_curve)
    if stress_state is not None:
        liq = np.asarray(stress_state.get("liquidity", np.zeros(len(spread))), float)
        cred = np.asarray(stress_state.get("credit", np.zeros(len(spread))), float)
        spread = spread + (funding_model.get("beta_liquidity", 0.0012)
                           * np.clip(liq, 0, 3)
                           + funding_model.get("beta_credit", 0.0018)
                           * np.clip(cred, 0, 3))
    return np.clip(spread, funding_model["min_spread"], funding_model["max_spread"])


# ---------------------------------------------------------------------------
# Stress state model
# ---------------------------------------------------------------------------

def calibrate_stress_state_model(df: pd.DataFrame, regimes: np.ndarray) -> Dict:
    """Latent liquidity/credit AR(1) channels + crisis-jump intensity
    (calibration.py:705-784)."""
    cached = load_cache(cfg.STRESS_STATE_CACHE)
    if cached is not None:
        return cached

    vix = df["VIX"].ffill().bfill().fillna(20.0).values
    rv = (df["SPY_Ret"].rolling(20, min_periods=5).std().bfill()
          .fillna(0.15 / np.sqrt(252)).values * np.sqrt(252))
    if "TNX" in df.columns and "IRX" in df.columns:
        credit_proxy = np.maximum(-(df["TNX"] - df["IRX"]).fillna(0.0).values, 0.0)
    else:
        credit_proxy = np.maximum(vix - 20.0, 0.0) / 20.0
    liquidity_proxy = (np.maximum(vix - 18.0, 0.0) / 25.0
                       + np.maximum(rv - 0.18, 0.0))

    # Per-regime medians, demeaned AR(1) channels, and jump intensities run
    # ON DEVICE as masked reductions (ops/fitting.stress_channel_fit_device)
    # — the regime mask replaces the reference's boolean-index compression.
    from letf_tpu.ops.fitting import fit_context, stress_channel_fit_device, to_x64

    model = {"regimes": {}}
    with fit_context():
        liq_d, cred_d, rv_d = to_x64(liquidity_proxy, credit_proxy, rv)
        regimes_d = jnp.asarray(np.asarray(regimes))
        for regime in range(R):
            n_regime = int((regimes == regime).sum())
            if n_regime < 60:
                model["regimes"][regime] = {
                    "liq_mu": 0.10 if regime == 0 else 0.35, "liq_phi": 0.90,
                    "liq_sigma": 0.08,
                    "credit_mu": 0.05 if regime == 0 else 0.25,
                    "credit_phi": 0.88, "credit_sigma": 0.07,
                    "jump_base_prob": 0.0002 if regime == 0 else 0.001,
                    "jump_scale": 0.0005 if regime == 0 else 0.002,
                }
                continue
            mask = ((regimes_d == regime) & jnp.isfinite(liq_d)
                    & jnp.isfinite(cred_d))
            (liq_mu, liq_phi, liq_sigma, cred_mu, cred_phi, cred_sigma,
             jump_p, jump_s, _) = stress_channel_fit_device(
                liq_d, cred_d, rv_d, mask)
            model["regimes"][regime] = {
                "liq_mu": float(liq_mu), "liq_phi": float(liq_phi),
                "liq_sigma": float(liq_sigma),
                "credit_mu": float(cred_mu), "credit_phi": float(cred_phi),
                "credit_sigma": float(cred_sigma),
                "jump_base_prob": float(jump_p),
                "jump_scale": float(jump_s),
            }
    save_cache(model, cfg.STRESS_STATE_CACHE)
    return model


# ---------------------------------------------------------------------------
# Tracking residual model
# ---------------------------------------------------------------------------

def calibrate_tracking_residual_model(df: pd.DataFrame,
                                      funding_model: Optional[Dict] = None,
                                      bypass_cache: bool = False) -> Dict:
    """Per-asset AR(1) of the residual between observed post-inception LETF
    returns and the expected L*idx - financing - expense
    (calibration.py:860-944)."""
    cached = None if bypass_cache else load_cache(cfg.TRACKING_RESIDUAL_CACHE)
    if cached is not None:
        return cached

    model = {}
    for asset in ("TQQQ", "UPRO", "SSO"):
        col = f"{asset}_Real_Ret"
        if col not in df.columns:
            continue
        real = df[col]
        idx = (df.get("QQQ_Ret", df["SPY_Ret"]) if asset == "TQQQ"
               else df["SPY_Ret"])
        lev = cfg.ASSETS[asset].leverage
        rf = df.get("IRX", pd.Series(4.5, index=df.index)).fillna(4.5).values / 100.0

        if funding_model is not None:
            sdf = pd.DataFrame({"VIX": df["VIX"].values}, index=df.index)
            for c in ("IRX", "TNX"):
                if c in df.columns:
                    sdf[c] = df[c].values
            spread = predict_borrow_spread_series(sdf, funding_model)
        else:
            spread = np.full(len(df), 0.0075)

        financing = (lev - 1.0) * (rf + spread) / 252.0
        expected = lev * idx.values - financing - cfg.ASSETS[asset].expense_ratio / 252.0
        residual = real.values - expected
        mask = np.isfinite(residual) & np.isfinite(df["VIX"].values)

        base = cfg.ASSETS[asset].tracking_error_base
        if mask.sum() < 120:
            model[asset] = {"rho": 0.25, "base_scale": base,
                            "downside_mult": 1.25,
                            "df": cfg.ASSETS[asset].tracking_error_df,
                            "clip_limit": 0.15}
            continue

        # AR(1)/asymmetry/clip-limit fit on device (ops/fitting).
        from letf_tpu.ops.fitting import (
            fit_context,
            to_x64,
            tracking_residual_fit_device,
        )

        with fit_context():
            (rho, scale, downside_mult, clip_limit, _, _) = \
                tracking_residual_fit_device(
                    *to_x64(residual), jnp.asarray(np.asarray(mask)),
                    lo_scale=base * 0.5, hi_scale=base * 8.0)
        model[asset] = {"rho": float(rho), "base_scale": float(scale),
                        "downside_mult": float(downside_mult),
                        "df": cfg.ASSETS[asset].tracking_error_df,
                        "clip_limit": float(clip_limit)}

    if not bypass_cache:
        save_cache(model, cfg.TRACKING_RESIDUAL_CACHE)
    return model


# ---------------------------------------------------------------------------
# Time-varying correlations
# ---------------------------------------------------------------------------

def get_default_correlation_for_regime_time_varying(regime: int) -> np.ndarray:
    if regime == 0:
        corr = np.array([
            [1.000, 0.850, 0.850, -0.200, 0.850],
            [0.850, 1.000, 0.980, -0.200, 0.980],
            [0.850, 0.980, 1.000, -0.200, 0.980],
            [-0.200, -0.200, -0.200, 1.000, -0.200],
            [0.850, 0.980, 0.980, -0.200, 1.000],
        ])
    else:
        corr = np.array([
            [1.000, 0.950, 0.950, -0.050, 0.950],
            [0.950, 1.000, 0.985, -0.050, 0.985],
            [0.950, 0.985, 1.000, -0.050, 0.985],
            [-0.050, -0.050, -0.050, 1.000, -0.050],
            [0.950, 0.985, 0.985, -0.050, 1.000],
        ])
    return nearest_psd_matrix(corr)


def get_default_correlations_time_varying() -> Dict[int, np.ndarray]:
    return {r: get_default_correlation_for_regime_time_varying(r)
            for r in range(R)}


def calibrate_correlations_time_varying(df: pd.DataFrame,
                                        regime_model: Dict) -> Dict:
    """Regime-conditional full correlation matrices; equity correlations
    forced >= 0.95 in the high-vol regime (diversification failure —
    calibration.py:145-252)."""
    cached = load_cache(cfg.CORRELATION_CACHE)
    if cached is not None:
        print("[OK] Using cached correlations")
        return cached

    regimes = regime_model.get("regimes_historical", None)
    if regimes is None or len(regimes) != len(df):
        print("  [WARN] No historical regimes - using defaults")
        return get_default_correlations_time_varying()

    full = {}
    for regime in range(R):
        mask = regimes[:len(df)] == regime
        reg_df = df[mask]
        cols = [c for c in ("QQQ_Ret", "SPY_Ret", "TLT_Ret")
                if c in reg_df.columns]
        if len(reg_df) < 60 or len(cols) < 2:
            full[regime] = get_default_correlation_for_regime_time_varying(regime)
            continue
        corr = reg_df[cols].corr()
        qqq_spy = (corr.loc["QQQ_Ret", "SPY_Ret"]
                   if {"QQQ_Ret", "SPY_Ret"} <= set(cols)
                   else (0.85 if regime == 0 else 0.95))
        tlt_spy = (corr.loc["TLT_Ret", "SPY_Ret"]
                   if {"TLT_Ret", "SPY_Ret"} <= set(cols)
                   else (-0.20 if regime == 0 else -0.05))
        if regime == 1:
            qqq_spy = max(qqq_spy, 0.95)
        m = np.array([
            [1.000, qqq_spy, qqq_spy, tlt_spy, qqq_spy],
            [qqq_spy, 1.000, 0.980, tlt_spy, 0.980],
            [qqq_spy, 0.980, 1.000, tlt_spy, 0.980],
            [tlt_spy, tlt_spy, tlt_spy, 1.000, tlt_spy],
            [qqq_spy, 0.980, 0.980, tlt_spy, 1.000],
        ])
        full[regime] = nearest_psd_matrix(m)
        print(f"  {cfg.REGIME_NAMES[regime]:<9}: QQQ-SPY={qqq_spy:.3f} "
              f"TLT-SPY={tlt_spy:.3f} ({int(mask.sum())} days)")

    save_cache(full, cfg.CORRELATION_CACHE)
    return full


# ---------------------------------------------------------------------------
# One-shot calibration
# ---------------------------------------------------------------------------

def calibrate_all(df: pd.DataFrame):
    """Run every calibration and assemble the regime_model dict the way the
    orchestrator threads it (reference __init__.py:104-130)."""
    regime_model = calibrate_regime_model_volatility(df)
    regime_model["joint_return_model"] = calibrate_joint_return_model(
        df, regime_model["regimes_historical"])
    regime_model["funding_model"] = calibrate_funding_spread_model(df)
    regime_model["stress_state_model"] = calibrate_stress_state_model(
        df, regime_model["regimes_historical"])
    regime_model["tracking_residual_model"] = calibrate_tracking_residual_model(
        df, funding_model=regime_model["funding_model"])
    correlations = calibrate_correlations_time_varying(df, regime_model)
    return regime_model, correlations
