"""Checkpoint/resume for calibrated model pytrees.

The reference pickles every expensive artifact (letf/utils.py:8-23,
config.py:179-293). Pickle caching is kept (utils/cache.py) for dict-level
parity; this module adds orbax array checkpoints for the densified SimModel
pytree — the format production jobs restore from without re-running
calibration, and the basis for MC-resume (chunked runs record the last
completed chunk, so a killed 1M-trial run restarts mid-stream: trials are
replayable from (seed, trial_id) alone).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from letf_tpu.models.params import SimModel


def save_sim_model(model: SimModel, path: str | Path) -> None:
    """Checkpoint a SimModel pytree with orbax (falls back to npz)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path.absolute(), dict(flat_model_arrays(model)), force=True)
        ckptr.wait_until_finished()
    except Exception:  # noqa: BLE001 - orbax version drift: fall back to npz
        np.savez(str(path) + ".npz", **dict(flat_model_arrays(model)))


def load_sim_model(path: str | Path,
                   template: Optional[SimModel] = None) -> Optional[SimModel]:
    """Restore a SimModel checkpoint; None if absent."""
    from letf_tpu.models.params import default_sim_model

    path = Path(path)
    template = template if template is not None else default_sim_model()
    flat = None
    if path.exists():
        try:
            import orbax.checkpoint as ocp

            ckptr = ocp.StandardCheckpointer()
            flat = ckptr.restore(path.absolute())
        except Exception:  # noqa: BLE001
            flat = None
    if flat is None and Path(str(path) + ".npz").exists():
        flat = dict(np.load(str(path) + ".npz"))
    if flat is None:
        return None
    return unflatten_model(template, flat)


def flat_model_arrays(model: SimModel):
    """Flatten the nested NamedTuple into 'group.field' -> array pairs."""
    for group_name, group in model._asdict().items():
        if hasattr(group, "_asdict"):
            for field, arr in group._asdict().items():
                yield f"{group_name}.{field}", np.asarray(arr)
        else:
            yield group_name, np.asarray(group)


def unflatten_model(template: SimModel, flat) -> SimModel:
    groups = {}
    for group_name, group in template._asdict().items():
        if hasattr(group, "_asdict"):
            # Fields absent from the checkpoint (older format) fall back to
            # the template's derived value — e.g. joint.chi_cheb.
            fields = {f: (np.asarray(flat[f"{group_name}.{f}"])
                          if f"{group_name}.{f}" in flat
                          else np.asarray(getattr(group, f)))
                      for f in group._fields}
            groups[group_name] = type(group)(**fields)
        else:
            groups[group_name] = np.asarray(flat[group_name])
    return SimModel(**groups)


def save_run_manifest(path: str | Path, *, seed: int, num_simulations: int,
                      time_horizon: int, completed_trials: int,
                      engine_mode: str, **extra) -> None:
    """Tiny JSON manifest enabling MC resume: counter-based RNG means the
    remaining trials regenerate exactly from (seed, trial_id). ``extra``
    records any further run-configuration fields the resume check compares
    (chunk size, start method, antithetic pairing, ...)."""
    Path(path).write_text(json.dumps({
        "seed": seed, "num_simulations": num_simulations,
        "time_horizon": time_horizon, "completed_trials": completed_trials,
        "engine_mode": engine_mode, **extra,
    }, indent=2))


def load_run_manifest(path: str | Path):
    p = Path(path)
    return json.loads(p.read_text()) if p.exists() else None
