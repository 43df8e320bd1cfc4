"""model.decode_mfu.flood: ``model.decode_mfu`` read in the flood cell,
where it moves ``output_tokens_per_s`` (see ``model.decode_mfu.py``)."""

from driftbench.bench import reader

read = reader("model.decode_mfu")
