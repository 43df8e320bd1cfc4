"""Hand-written Hopper kernels, their plain PyTorch versions (``ref``)
and the dispatch layer the models call (``ops``)."""
