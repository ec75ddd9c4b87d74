"""JAX parameter pytree -> the port's parameters.

The JAX package stacks the parameters of its repeating block pattern along a
leading dim (``stack/blocks/sub{j}``, one slice per repeat) and keeps the
remainder layers as ``stack/tail/tail{j}``; the port keeps one subtree per
layer, in execution order (repeat r, pattern position j -> layer r*P + j,
then the tail).  ``from_jax_params`` takes the JAX tree as nested dicts of
numpy arrays and raises on any leaf it does not consume or whose shape is
not the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchSpec
from repro_torch.models import model as M
from repro_torch.models.layers import map_with_path


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def from_jax_params(tree, spec: ArchSpec, device=None, *, dtype=torch.float32):
    """``tree``: the JAX ``init_params`` pytree as nested dicts of arrays."""
    dev = resolve_device(device)
    src = dict(_leaves(tree))
    used = set()
    pattern, reps, _ = spec.block_pattern()
    n_scanned = reps * len(pattern)

    def source(path):
        if path[0] != "stack":
            return path, None
        i, rest = path[1], path[2:]
        if i < n_scanned:
            return ("stack", "blocks", f"sub{i % len(pattern)}") + rest, i // len(pattern)
        return ("stack", "tail", f"tail{i - n_scanned}") + rest, None

    def convert(path, d):
        jpath, rep = source(path)
        if jpath not in src:
            raise ValueError(f"JAX params have no leaf {'/'.join(jpath)}")
        a = np.asarray(src[jpath])
        if rep is not None:
            if a.shape[:1] != (reps,):
                raise ValueError(f"JAX leaf {'/'.join(jpath)} stacks {a.shape[:1]} "
                                 f"repeats; the spec has {reps}")
            a = a[rep]
        if a.shape != d.shape:
            raise ValueError(f"JAX leaf {'/'.join(jpath)} has shape {a.shape}; "
                             f"the port wants {d.shape}")
        used.add(jpath)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    out = map_with_path(convert, M.model_param_defs(spec))
    unused = sorted("/".join(p) for p in set(src) - used)
    if unused:
        raise ValueError(f"JAX leaves not consumed by the conversion: {unused}")
    return out
