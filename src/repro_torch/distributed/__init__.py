"""Training substrate of the port on one device: the AdamW optimizer and
checkpointing, plus the simulators' fault-tolerance monitors (a copy of
the JAX package's ``fault_tolerance.py``). The JAX package's sharding
rules and compressed all-reduce are multi-device and come later
(ROADMAP.md A9)."""
