"""model.decode_mfu.bursty: ``model.decode_mfu`` read in the bursty cell, a metric
of its own so that its bound, or the end-to-end metric it moves, is the
bursty cell's (see ``model.decode_mfu.py``)."""

from driftbench.bench import reader

read = reader("model.decode_mfu")
