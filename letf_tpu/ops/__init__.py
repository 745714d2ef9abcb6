"""Device compute ops: the fused path engine, the buy-and-hold
compounding scan, rolling-window signals, and summary reductions."""
