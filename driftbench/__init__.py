"""The port's benchmark: open-loop multi-tenant traffic through
``repro_torch``'s scheduler and slot-ring engine (see ``run.py``)."""
