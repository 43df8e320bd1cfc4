"""Distribution substrate of the port: divisibility-aware sharding rules
(``sharding.py``), AdamW with ZeRO-1 state sharding and the int8
error-feedback all-reduce (``optimizer.py``), checkpointing, and the
simulators' fault-tolerance monitors (a copy of the JAX package's
``fault_tolerance.py``)."""

from .sharding import (
    constrain,
    logical_to_spec,
    param_shardings,
    batch_spec,
)

__all__ = ["constrain", "logical_to_spec", "param_shardings", "batch_spec"]
