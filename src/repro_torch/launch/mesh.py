"""Production mesh construction.

The port of the JAX package's ``launch/mesh.py``: a ``DeviceMesh`` with
named dims over the current ``torch.distributed`` process group, whose
world size must be the mesh's size. Nothing here creates a group, at
import time or later: the dry run (:mod:`repro_torch.launch.dryrun`)
initialises a ``"fake"`` group of the production size first, a real
launcher an NCCL group of its cards.
"""
from __future__ import annotations

import math

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``."""
    return make_mesh(*PRODUCTION[multi_pod])


def make_mesh(shape, axes):
    """Elastic-scaling entry point: any (shape, axes) the launcher asks
    for, over the current process group, on the group's devices (``"cuda"``
    for NCCL ranks, ``"cpu"`` for gloo and the dry run's fake group, whose
    tensors are meta). Raises, naming both sizes, when the group's world
    size is not the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.distributed import mesh_device_type

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {shape} needs a process group of "
                           f"{math.prod(shape)} ranks "
                           f"(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the mesh {dict(zip(axes, shape))} has "
                         f"{math.prod(shape)} ranks, the process group "
                         f"{world}")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)
