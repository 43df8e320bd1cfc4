"""The JAX package's four examples on the port, each run as
``python -m repro_torch.examples.<name>``: ``quickstart`` and
``drift_demo`` (the scheduler and the simulator, host only),
``multi_tenant_serving`` (the slot-ring engine under DriftScheduler,
on the card) and ``train_lm`` (the training launcher)."""
