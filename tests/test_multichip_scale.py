"""Production-shaped multichip evidence (VERDICT r2 weak #6).

8192 trials x 10y (plus the 5y offset buffer) through the FULL
institutional engine on the virtual 8-device mesh, compared against the
single-device mesh, with relative walltimes recorded — the round-2 mesh
tests only ever exercised 16 trials x 1y.

Runs in a subprocess pinned to f32 (the production dtype): the conftest
pins the suite to f64 for oracle parity, where this shape costs ~10x more
on the 1-core host.
"""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_CODE = r'''
import os, sys, time, json
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_ENABLE_X64"] = "0"
sys.path.insert(0, os.getcwd())
import jax
from letf_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import numpy as np
from letf_tpu.models.params import default_sim_model
from letf_tpu.parallel.mc_runner import run_monte_carlo
from letf_tpu.parallel.mesh import trial_mesh

model = default_sim_model()
kw = dict(num_simulations=8192, seed=17, chunk_size=4096, progress=False,
          chunks_per_dispatch=2)
t0 = time.perf_counter()
multi = run_monte_carlo(model, 10, mesh=trial_mesh(jax.devices()[:8]), **kw)
dt8 = time.perf_counter() - t0
t0 = time.perf_counter()
single = run_monte_carlo(model, 10, mesh=trial_mesh(jax.devices()[:1]), **kw)
dt1 = time.perf_counter() - t0

out = {
    "n": int(multi.final_wealth.shape[0]),
    "bitwise": bool(np.array_equal(multi.final_wealth, single.final_wealth)),
    "max_rel": float(np.max(np.abs(multi.final_wealth - single.final_wealth)
                            / np.maximum(np.abs(single.final_wealth), 1e-9))),
    "trades_equal": bool(np.array_equal(multi.num_trades,
                                        single.num_trades)),
    "finite": bool(np.isfinite(multi.final_wealth).all()),
    "walltime_8dev_s": round(dt8, 1),
    "walltime_1dev_s": round(dt1, 1),
}
print("RESULT " + json.dumps(out))
'''


def test_sharded_equals_single_8192x10y():
    res = subprocess.run([sys.executable, "-c", _CODE], cwd=ROOT,
                         capture_output=True, text=True, timeout=1500)
    assert res.returncode == 0, res.stderr[-2000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    print(f"multichip scale: {out}")
    assert out["n"] == 8192
    assert out["finite"]
    assert out["trades_equal"]
    # f32 across two different SPMD partitionings: demand near-bitwise
    # agreement (fusion differences can move a few ulps).
    assert out["bitwise"] or out["max_rel"] < 1e-5, out
