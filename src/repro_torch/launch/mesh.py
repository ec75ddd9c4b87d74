"""Device meshes over ``torch.distributed`` process groups.

Counterpart of the JAX package's ``launch/mesh.py``: ``make_mesh``,
``make_production_mesh`` and ``single_device_mesh`` build a
``DeviceMesh`` with named axes (``init_device_mesh``).  Each needs a default
process group; ``init_distributed`` starts one, gloo on the CPU and NCCL on
the card, from the ``torchrun`` environment (``env://``: ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), else as a world of one
on an in-memory store.  The device follows the
port's rule: the card unless ``cpu`` is asked for.  Importing this module
starts nothing.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device


def init_distributed(device=None) -> torch.device:
    """Start the default process group (if none is running) for ``device``'s
    backend, and make this rank's card current.  Returns the device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device=None):
    """Arbitrary mesh (tests / elastic rescale) over the default process group;
    its size must be the world's."""
    dev = init_distributed(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def single_device_mesh(*, device=None):
    return make_mesh((1,), ("data",), device=device)
