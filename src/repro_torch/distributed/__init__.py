"""Training substrate of the port on one device: the AdamW optimizer and
checkpointing (the JAX package's sharding rules and compressed
all-reduce are multi-device and come later, ROADMAP.md A10)."""
