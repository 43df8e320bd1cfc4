"""itl_mean_ms.bursty: ``itl_mean_ms`` read in the bursty cell, a metric
of its own so that its bound, or the end-to-end metric it moves, is the
bursty cell's (see ``itl_mean_ms.py``)."""

from driftbench.bench import reader

read = reader("itl_mean_ms")
