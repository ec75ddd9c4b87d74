"""The ``repro_torch`` operator namespace of the kernels' launches.

Each launch of a Hopper kernel is an operator of ``torch.library``
(``torch.ops.repro_torch.<name>``) with three parts:
  * its CUDA implementation, which checks the layout, launches the kernel
    through ``ctypes`` and counts the launch;
  * a fake implementation (``register_fake``), which gives the outputs'
    shapes and dtypes and launches nothing, so a ``FakeTensor`` (the dry
    run's stand-ins, whatever their device label) passes through the
    kernel's call without reaching ``ctypes``;
  * a FLOP formula (``torch.utils.flop_counter.register_flop_formula``): the
    operations the kernel performs on those shapes, which any
    ``FlopCounterMode`` and the dry run's counter read.
No operator has a CPU implementation: a real CPU tensor takes the kernel's
plain version in its wrapper and never reaches the operator.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

LIB = torch.library.Library("repro_torch", "FRAGMENT")


def is_fake(t) -> bool:
    """``t`` is a ``FakeTensor``: shapes only, no storage to launch on."""
    return isinstance(t, FakeTensor)


def define(schema: str, cuda, fake, flops):
    """Define ``repro_torch::<schema>`` with its CUDA implementation, its
    fake implementation and its FLOP formula; returns the operator's default
    overload."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    packet = getattr(torch.ops.repro_torch, name)
    register_flop_formula(packet)(flops)
    return packet.default
