"""Mesh construction and the hardware constants of the port's roofline
(functions only: importing this module touches no device or
process-group state).

Port of the JAX package's ``launch/mesh.py`` on
``torch.distributed.device_mesh``, with JAX's axis names:

    single pod: 16 x 16 = 256 ranks, axes (data, model)
    multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model) -- the
                pod axis carries pure data parallelism

A mesh needs an initialised default process group of its size. The dry
run and the roofline count the production meshes without devices, on
the fake process group of :func:`open_fake_group` (the counterpart of
the 512 placeholder host devices JAX creates in those two modules):
collectives on it return at once and move nothing.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, *, device_type: str = "cuda") -> DeviceMesh:
    """Arbitrary mesh over the default group's ranks (tests use small
    ones)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def open_fake_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size``
    ranks, this process rank 0 (an open fake group of another size is
    closed first). Only the dry run and the roofline call it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is open; the fake "
                               "group would replace it")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


# NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense rates without
# sparsity, at the card's full 700 W power limit; a card set below it
# runs slower under load): bf16 tensor cores 989 TFLOP/s, HBM3 80 GB at
# 3.35 TB/s, NVLink 4 900 GB/s per GPU, 450 GB/s each way. "ici_bw"
# keeps the JAX key of the collective term's link rate.
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s per card
    "hbm_bw": 3.35e12,           # bytes/s per card
    "ici_bw": 450e9,             # bytes/s each way per card (NVLink 4)
    "hbm_bytes": 80e9,           # 80 GB of HBM3 per card
}
