"""Configuration for the JAX LETF Monte Carlo framework.

Mirrors the semantics of the reference configuration (see
``/root/reference/letf/config.py``: ASSETS at config.py:62, STRATEGIES at
config.py:348, MC params at config.py:150-166, random-start config at
config.py:296-345) but is re-expressed as frozen dataclasses and
struct-of-arrays tables that jit cleanly as static arguments / pytrees.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

# ============================================================================
# Date / capital constants (reference config.py:10-26)
# ============================================================================
DATA_START_DATE = "1926-07-01"
DATA_END_DATE = "2025-12-31"
INITIAL_CAPITAL = 10_000.0

ANALYSIS_START_DATE = "1926-07-01"
ANALYSIS_END_DATE = "2025-12-31"

FAMA_FRENCH_END_DATE = "1949-12-31"
YFINANCE_START_DATE = "1950-01-01"

TIME_HORIZONS = [1, 2, 5, 10, 20, 30, 40, 50]

START_DATE_OPTIONS = {
    1: {"date": "1926-07-01", "name": "Full History",
        "description": "Includes Great Depression, WWII, all major events"},
    2: {"date": "1950-01-01", "name": "Post-WWII",
        "description": "More reliable data, excludes pre-war period"},
    3: {"date": "1980-01-01", "name": "Modern Era",
        "description": "After stagflation, more relevant to today"},
    4: {"date": "2000-01-01", "name": "21st Century",
        "description": "Includes dot-com crash, 2008 crisis, COVID"},
    5: {"date": "2010-01-01", "name": "Post-Crisis",
        "description": "TQQQ real data begins, bull market era"},
    6: {"date": "2015-01-01", "name": "Recent History",
        "description": "Last 10 years only"},
}

TRADING_DAYS = 252

# ============================================================================
# Assets (reference config.py:62-135). Order matters: it defines the asset
# axis of every [*, n_assets] tensor in the simulator.
# ============================================================================

# Underlying index streams produced by the joint return model.
UNDERLYING_SPY = 0
UNDERLYING_QQQ = 1
UNDERLYING_TLT = 2
UNDERLYING_NAMES = ("SPY_Ret", "QQQ_Ret", "TLT_Ret")


@dataclasses.dataclass(frozen=True)
class AssetConfig:
    name: str
    long_name: str
    inception: str
    leverage: float
    expense_ratio: float
    underlying: int          # index into UNDERLYING_NAMES
    beta_to_spy: float
    tracking_error_base: float
    tracking_error_df: float
    borrow_spread: float


ASSETS: Dict[str, AssetConfig] = {
    "TQQQ": AssetConfig("TQQQ", "3x NASDAQ-100", "2010-02-11", 3.0, 0.0086,
                        UNDERLYING_QQQ, 1.0, 0.0002, 5.0, 0.0075),
    "UPRO": AssetConfig("UPRO", "3x S&P 500", "2009-06-25", 3.0, 0.0091,
                        UNDERLYING_SPY, 1.0, 0.00015, 5.0, 0.0060),
    "SSO": AssetConfig("SSO", "2x S&P 500", "2006-07-11", 2.0, 0.0089,
                       UNDERLYING_SPY, 1.0, 0.0001, 5.0, 0.0050),
    "TMF": AssetConfig("TMF", "3x 20Y Treasury", "2009-04-16", 3.0, 0.0108,
                       UNDERLYING_TLT, -0.3, 0.0003, 5.0, 0.0040),
    "SPY": AssetConfig("SPY", "S&P 500 (No Leverage)", "1993-01-29", 1.0, 0.000945,
                       UNDERLYING_SPY, 1.0, 0.00005, 10.0, 0.0),
    "QQQ": AssetConfig("QQQ", "NASDAQ-100 (No Leverage)", "1999-03-10", 1.0, 0.0020,
                       UNDERLYING_QQQ, 1.0, 0.00005, 10.0, 0.0),
}

ASSET_NAMES: Tuple[str, ...] = tuple(ASSETS.keys())
ASSET_INDEX: Dict[str, int] = {name: i for i, name in enumerate(ASSET_NAMES)}
N_ASSETS = len(ASSET_NAMES)

# Alias kept for API familiarity with the reference (config.py:138).
LETF_CONFIGS = ASSETS


@dataclasses.dataclass(frozen=True)
class AssetTable:
    """Struct-of-arrays view of ASSETS for vectorized device math.

    Beta semantics match the reference: ``map_underlying_series_for_asset``
    (engine.py:305-317) multiplies the chosen underlying stream by
    ``beta_to_spy`` for equity assets and passes TLT through unscaled for TMF.
    """
    leverage: np.ndarray          # [A]
    expense_ratio: np.ndarray     # [A]
    borrow_spread: np.ndarray     # [A]
    te_base: np.ndarray           # [A]
    te_df: np.ndarray             # [A]
    underlying: np.ndarray        # [A] int32 index into the 3 joint streams
    beta: np.ndarray              # [A] multiplier applied to the underlying


def asset_table() -> AssetTable:
    cfgs = list(ASSETS.values())
    beta = []
    for c in cfgs:
        # TMF passes TLT through unscaled (engine.py:315-316).
        beta.append(1.0 if c.underlying == UNDERLYING_TLT else c.beta_to_spy)
    return AssetTable(
        leverage=np.array([c.leverage for c in cfgs], np.float64),
        expense_ratio=np.array([c.expense_ratio for c in cfgs], np.float64),
        borrow_spread=np.array([c.borrow_spread for c in cfgs], np.float64),
        te_base=np.array([c.tracking_error_base for c in cfgs], np.float64),
        te_df=np.array([c.tracking_error_df for c in cfgs], np.float64),
        underlying=np.array([c.underlying for c in cfgs], np.int32),
        beta=np.array(beta, np.float64),
    )


# ============================================================================
# Transaction costs / cash (reference config.py:141-148)
# ============================================================================
BASE_SPREAD_BPS = {0: 2.0, 1: 8.0}
REBALANCE_COST_PER_DOLLAR = 0.0001
CASH_RATE_BY_REGIME = {0: 0.010, 1: -0.020}

# ============================================================================
# Monte Carlo parameters (reference config.py:150-166)
# ============================================================================
NUM_SIMULATIONS = 200
USE_ANTITHETIC_VARIATES = True
USE_MOMENT_MATCHING = True
USE_LATIN_HYPERCUBE = False
DEBUG = False

# Trials per device per chunk in the sharded MC runner: a chunk over an
# n-device mesh holds n times this many paths, so every device runs the
# same [DEVICE_CHUNK_TRIALS, days] shapes whatever the mesh: it bounds the
# device-memory footprint, and each device compiles the program a
# one-device run uses. run_monte_carlo callers can pass chunk_size
# explicitly.
DEVICE_CHUNK_TRIALS = 16384

# Chunks per device dispatch in the resident loop (a lax.scan over trial
# chunks inside one program; parallel/mc_runner.py).
CHUNKS_PER_DISPATCH = 4

# ============================================================================
# Regimes (reference config.py:168-176)
# ============================================================================
N_REGIMES = 2
REGIME_NAMES = {0: "Low Vol", 1: "High Vol"}
MIN_REGIME_DURATION = {0: 60, 1: 20}
# Fixed dwell-table capacity for the in-scan semi-Markov sampler.
MAX_DWELL_SAMPLES = 256

# ============================================================================
# Cache (reference config.py:179-218, 286-293)
# ============================================================================
CACHE_DIR = Path("letf_tpu_cache_v1")

DATA_CACHE = CACHE_DIR / "historical_data.pkl"
REGIME_MODEL_CACHE = CACHE_DIR / "regime_model.pkl"
CORRELATION_CACHE = CACHE_DIR / "correlations.pkl"
VALIDATION_RESULTS = CACHE_DIR / "validation_results.json"
JOINT_RETURN_MODEL_CACHE = CACHE_DIR / "joint_return_model.pkl"
FUNDING_MODEL_CACHE = CACHE_DIR / "funding_spread_model.pkl"
TRACKING_RESIDUAL_CACHE = CACHE_DIR / "tracking_residual_model.pkl"
STRESS_STATE_CACHE = CACHE_DIR / "stress_state_model.pkl"
BOOTSTRAP_CACHE = CACHE_DIR / "bootstrap_data.pkl"


def init_cache() -> None:
    CACHE_DIR.mkdir(exist_ok=True)


def get_cache_filenames(start_date: str, end_date: str) -> Dict[str, Path]:
    date_suffix = f"{start_date[:4]}_{end_date[:4]}"
    return {
        "data": CACHE_DIR / f"historical_data_{date_suffix}.pkl",
        "regime": CACHE_DIR / f"regime_model_{date_suffix}.pkl",
        "correlation": CACHE_DIR / f"correlations_{date_suffix}.pkl",
        "validation": CACHE_DIR / f"validation_results_{date_suffix}.json",
    }


def clear_all_caches() -> None:
    if CACHE_DIR.exists():
        for f in CACHE_DIR.glob("*.pkl"):
            f.unlink()
        for f in CACHE_DIR.glob("*.json"):
            f.unlink()
        print("All caches cleared")


# ============================================================================
# Bootstrap / engine mode (reference config.py:221-267)
# ============================================================================
BOOTSTRAP_BLOCK_MIN = 21
BOOTSTRAP_BLOCK_MAX = 168
BOOTSTRAP_BLOCK_MEAN = 84
BOOTSTRAP_BLOCK_SIZE = BOOTSTRAP_BLOCK_MAX
BOOTSTRAP_MOMENTUM_BIAS_BY_REGIME = {0: 0.54, 1: 0.505}
STUDENT_T_DF = 5
BOOTSTRAP_WEIGHT = 0.80
USE_BLOCK_BOOTSTRAP = True
SIM_ENGINE_MODE = "institutional_v1"


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Canonical simulation configuration object (reference config.py:270-284)."""
    engine_mode: str
    use_block_bootstrap: bool
    bootstrap_weight: float


def get_simulation_config() -> SimulationConfig:
    return SimulationConfig(
        engine_mode=SIM_ENGINE_MODE,
        use_block_bootstrap=USE_BLOCK_BOOTSTRAP,
        bootstrap_weight=float(BOOTSTRAP_WEIGHT),
    )


# ============================================================================
# Random start (reference config.py:296-345)
# ============================================================================
USE_RANDOM_START = True
RANDOM_START_METHOD = "offset"   # 'regime_only' | 'offset' | 'historical_anchor'
START_REGIME_PROBABILITIES = {0: 0.80, 1: 0.20}
RANDOM_START_BUFFER_YEARS = 5
MIN_HISTORY_FOR_ANCHOR = 2
RANDOMIZE_INITIAL_VIX = True
INITIAL_VIX_RANGE = {0: (12.0, 20.0), 1: (25.0, 45.0)}
TRACK_START_CONDITIONS = True

# ============================================================================
# Strategies S1-S19 (reference config.py:348-437). Kept as plain dicts so the
# registry in strategies/engine.py can compile the full batch.
# ============================================================================
STRATEGIES = {
    "S1": {"name": "TQQQ Buy Hold", "type": "benchmark", "asset": "TQQQ"},
    "S2": {"name": "SPY Buy Hold", "type": "benchmark", "asset": "SPY"},
    "S3": {"name": "SSO BuyHold (2x)", "type": "benchmark", "asset": "SSO"},
    "S4": {"name": "200-SMA Simple", "type": "sma", "asset": "TQQQ", "sma_period": 200},
    "S5": {"name": "SMA +/-2% Band", "type": "sma_band", "asset": "TQQQ",
           "sma_period": 200, "band": 0.02},
    "S6": {"name": "60/40 TQQQ/TMF", "type": "portfolio",
           "assets": {"TQQQ": 0.6, "TMF": 0.4}, "rebalance_freq": 21},
    "S7": {"name": "Vol Targeting (20%)", "type": "vol_targeting", "asset": "TQQQ",
           "target_vol": 0.20, "lookback": 20},
    "S8": {"name": "Composite Regime", "type": "composite", "asset": "TQQQ",
           "defensive_asset": "SPY", "sma_period": 200, "rsi_period": 14,
           "vix_threshold": 25.0},
    "S9": {"name": "Adaptive Vol Target", "type": "adaptive_vol", "asset": "TQQQ",
           "bull_target": 0.35, "bear_target": 0.12, "lookback": 20, "sma_period": 200},
    "S10": {"name": "Sortino Optimize", "type": "downside_vol", "asset": "TQQQ",
            "target_downside_vol": 0.15, "lookback": 20},
    "S11": {"name": "Hyper-Convex", "type": "convex_vol", "asset": "TQQQ",
            "target_vol": 0.25, "power": 1.2, "sma_period": 200},
    "S12": {"name": "Vol-Velocity", "type": "vol_velocity", "asset": "TQQQ",
            "target_vol": 0.22},
    "S13": {"name": "VoV Momentum", "type": "vol_mom", "asset": "TQQQ",
            "target_vol": 0.25},
    "S14": {"name": "Skewness-Adjusted", "type": "skew_convex", "asset": "TQQQ",
            "target_vol": 0.25},
    "S15": {"name": "Meta-Ensemble", "type": "meta_ensemble", "asset": "TQQQ",
            "target_vol": 0.28},
    "S16": {"name": "Crisis Alpha", "type": "regime_asymmetric", "asset": "TQQQ",
            "base_target_vol": 0.30, "crisis_target_vol": 0.08,
            "vix_alarm_level": 25, "vol_expansion_threshold": 1.5,
            "lookback_fast": 5, "lookback_slow": 60},
    "S17": {"name": "Tail Risk Optimizer", "type": "skew_kelly", "asset": "TQQQ",
            "base_target_vol": 0.30, "skew_lookback": 60, "vol_lookback": 20,
            "kelly_fraction": 0.7},
    "S18": {"name": "Mom. Vol Conv.", "type": "mom_vol_convergence", "asset": "TQQQ",
            "base_target_vol": 0.28, "momentum_lookback": 126, "vol_fast": 10,
            "vol_slow": 60, "momentum_threshold": 0.05},
    "S19": {"name": "Conviction Compounder", "type": "conviction_compounder",
            "asset": "TQQQ", "base_target_vol": 0.32, "momentum_lookback": 126,
            "vol_lookback": 20, "trend_sma": 100, "rebalance_threshold": 0.05},
}

STRATEGY_IDS: Tuple[str, ...] = tuple(STRATEGIES.keys())
STRATEGY_INDEX: Dict[str, int] = {sid: i for i, sid in enumerate(STRATEGY_IDS)}
N_STRATEGIES = len(STRATEGY_IDS)

ROTH_IDS = ["S1", "S2", "S3", "S4", "S5", "S6"]
TAXABLE_IDS = ["S7", "S8", "S9", "S10", "S11", "S12", "S13", "S14", "S15",
               "S16", "S17", "S18", "S19"]


def print_banner() -> None:
    import jax
    n_dev = len(jax.devices())
    print(f"\n{'=' * 80}")
    print("LETF MONTE CARLO (JAX/XLA)")
    print(f"{'=' * 80}")
    print("Engine: fused lax.scan path generation, vmapped trials, pjit-sharded mesh")
    print("  1. Volatility drag: correct geometric compounding of L*r - costs")
    print("  2. Tracking error: additive AR(1) with fat tails + EMA de-bias")
    print("  3. Regime model: volatility-driven semi-Markov with dwell tables")
    print("  4. Joint returns: regime-conditional multivariate-t + GARCH/DCC-lite")
    print("  5. State-linked funding spread + latent liquidity/credit stress")
    print("  6. Full US tax engine (IRC 1222/1211/1212, wash sale, lot selection)")
    print(f"{'=' * 80}")
    print(f"System: {n_dev} device(s), {NUM_SIMULATIONS} sims/horizon")
    print(f"{'=' * 80}\n")
