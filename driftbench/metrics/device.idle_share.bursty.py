"""device.idle_share.bursty: ``device.idle_share`` read in the bursty cell, a metric
of its own so that its bound, or the end-to-end metric it moves, is the
bursty cell's (see ``device.idle_share.py``)."""

from driftbench.bench import reader

read = reader("device.idle_share")
