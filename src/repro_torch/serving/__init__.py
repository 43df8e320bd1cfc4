"""Serving layer of the port: the paged and slot-ring continuous-batching
engine with its P/D handoff surface, its KV page bookkeeping, run
metrics, and copies of the JAX package's discrete-event simulators and
cost model."""
