"""device.idle_share.flood: ``device.idle_share`` read in the flood cell,
where it moves ``output_tokens_per_s`` (see ``device.idle_share.py``)."""

from driftbench.bench import reader

read = reader("device.idle_share")
