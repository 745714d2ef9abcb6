"""Parallel execution: device mesh management and the sharded MC driver.

The reference's process-pool data parallelism (mc_runner.py:141-208, pickled
args per trial) maps to: a batched trial axis on each device + sharding of
that axis across the local devices. Cross-device communication is only the
final gather of KB-scale summary tensors.
"""

from letf_tpu.parallel.mesh import trial_mesh, trial_sharding
from letf_tpu.parallel.mc_runner import (
    MCArrays,
    run_monte_carlo,
    parallel_monte_carlo_fixed,
)
