"""letf_tpu: Leveraged-ETF Monte Carlo framework in JAX, compiled by XLA.

A ground-up rebuild of the capabilities of the reference CPU simulator
(djbm10/LETF-Monte-Carlo) for an accelerator (an NVIDIA GPU; the test
suite runs it on the CPU):

- path generation is a fused ``lax.scan`` over days with a small per-trial
  carry, batched over trials and sharded over a 1-D device mesh
- all randomness is counter-based threefry keyed by (trial, day, stream)
- the 19 trading strategies run as a batched strategy axis inside a single
  equity scan; only summary tensors (final wealth, max drawdown, trade
  counts) leave device memory
- the tax engine preserves exact IRC §1222/§1211/§1212 scalar semantics
  (6/6 golden tests) and adds a vectorized (trial, year) device path

Entry point: ``letf_tpu.run()`` — mirrors the reference pipeline
(letf/__init__.py:19-202): golden tax gate -> data -> calibration ->
validation -> per-horizon Monte Carlo -> reporting -> historical comparison.
"""

from letf_tpu.runner import run  # noqa: F401

__version__ = "0.1.0"
