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

``init_fake_world(n)`` is the dry run's counterpart of the JAX package's
``--xla_force_host_platform_device_count=512``: it starts PyTorch's
``"fake"`` process group as rank 0 of a world of ``n`` (256 for ``pod``,
512 for ``multipod``) in this one process, whose collectives move nothing,
and ``make_production_mesh`` then builds the mesh on it (a ``pod`` mesh in
a world of 512 takes its first 256 ranks, as the JAX dry run's ``pod``
mesh takes 256 of its 512 host devices).  A process has
one default group, so the dry run runs in its own process (its CLI, or a
subprocess), as the JAX dry run sets ``XLA_FLAGS`` before JAX starts.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

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


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """Start the ``"fake"`` process group as ``rank`` of ``world_size`` ranks
    in this process, unless a fake world at least that large runs already
    (a smaller mesh then takes its first ranks).  Raises if a real group, or
    a smaller fake world, is running: its groups cannot be replaced within a
    process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() >= world_size:
            return
        raise RuntimeError(f"a {dist.get_backend()} group of {dist.get_world_size()} ranks is "
                           f"running: the fake world of {world_size} needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device=None):
    """Arbitrary mesh (tests / elastic rescale) over the default process group;
    its size must be the world's."""
    dev = init_distributed(device)
    n = math.prod(shape)
    if dist.get_backend() == "fake" and dist.get_world_size() > n:  # the dry run's pod in 512
        return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def single_device_mesh(*, device=None):
    return make_mesh((1,), ("data",), device=device)
