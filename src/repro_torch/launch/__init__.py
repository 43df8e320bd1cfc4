"""Launchers: serve, train, and the one-card dry run (``dryrun``, with
its roofline in ``analysis`` and the H100 constants in ``mesh``)."""
