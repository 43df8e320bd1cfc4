"""engine.iteration_ms.bursty: ``engine.iteration_ms`` read in the bursty cell, a metric
of its own so that its bound, or the end-to-end metric it moves, is the
bursty cell's (see ``engine.iteration_ms.py``)."""

from driftbench.bench import reader

read = reader("engine.iteration_ms")
