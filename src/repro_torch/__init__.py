"""PyTorch / CUDA port of DriftSched for one NVIDIA H100.

Sits beside the JAX package ``repro`` and keeps its module layout, so
each module here has a counterpart of the same path there. The port
imports ``torch`` and ``numpy`` only; the host layers it needs
(scheduler core, observability, workload, KV page bookkeeping, the
training data pipeline) are its own copies. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``. The kernels of its
paths (the attention kernels of the slot-ring and paged serving paths,
flash attention and the Mamba-2 SSD scan of the trainer) are CUDA C++
written for Hopper (``kernels/csrc``).
"""
