"""Model code of the port: the dense decoder-only transformer (the
training forward and the slot-ring and paged serving paths) and Mamba-2
(the training forward)."""
