"""Device mesh helpers: a 1-D 'trials' mesh over all local devices.

Monte Carlo over independent trials is pure data parallelism, so the mesh
is one axis; paths, signals, and strategy state all carry the trial axis
and shard over the devices with zero resharding. Summary tensors (final wealth per
strategy, trade counts, max drawdown) are the only cross-device traffic.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TRIAL_AXIS = "trials"


def trial_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return jax.make_mesh((len(devices),), (TRIAL_AXIS,), devices=devices)


def trial_sharding(mesh: Optional[Mesh] = None) -> NamedSharding:
    mesh = mesh if mesh is not None else trial_mesh()
    return NamedSharding(mesh, P(TRIAL_AXIS))


def replicated(mesh: Optional[Mesh] = None) -> NamedSharding:
    mesh = mesh if mesh is not None else trial_mesh()
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
