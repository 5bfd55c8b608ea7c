"""Device meshes (counterpart of the JAX package's ``launch/mesh.py``).

``make_production_mesh`` is a FUNCTION (not a module constant), so importing
this module touches no device or process group.  The single-pod mesh is 16 x
16 = 256 cards ("data", "model"); the multi-pod mesh is 2 x 16 x 16 = 512
("pod", "data", "model"), the "pod" axis composing with "data" for batch and
FSDP sharding.  Both are ``torch.distributed`` ``DeviceMesh``es and need a
process group of that many ranks, one a card (NCCL).

``make_host_mesh`` is the (1, 1) mesh of one process, for running the
sharded code paths on one device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import default_device

AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")
SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def make_production_mesh(*, multi_pod: bool = False):
    from torch.distributed.device_mesh import init_device_mesh

    shape = MULTI_POD_SHAPE if multi_pod else SHAPE
    return init_device_mesh("cuda", shape, mesh_dim_names=MULTI_POD_AXES if multi_pod else AXES)


def make_host_mesh(device=None):
    """The (1, 1) ("data", "model") mesh of this process on ``device`` (the
    card unless ``device="cpu"``).  Without a process group it first
    initialises a world of one on an in-process ``HashStore`` (gloo on the
    CPU, NCCL on the card), so no port is opened."""
    from torch.distributed.device_mesh import DeviceMesh

    device = default_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"a host mesh needs a world of one, not {dist.get_world_size()}")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return DeviceMesh(device.type, torch.zeros((1, 1), dtype=torch.int64), mesh_dim_names=AXES)
