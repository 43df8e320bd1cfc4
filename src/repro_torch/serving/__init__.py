"""Serving layer of the port: the paged continuous-batching engine, its
KV page bookkeeping and run metrics."""
