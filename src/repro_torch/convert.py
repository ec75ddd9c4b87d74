"""JAX parameter pytree <-> the port's parameters, and train states.

The JAX package stacks the parameters of its repeating block pattern along a
leading dim (``stack/blocks/sub{j}``, one slice per repeat) and keeps the
remainder layers as ``stack/tail/tail{j}``; the port keeps one subtree per
layer, in execution order (repeat r, pattern position j -> layer r*P + j,
then the tail).  ``from_jax_params`` takes the JAX tree as nested dicts of
numpy arrays and raises on any leaf it does not consume or whose shape is
not the port's.  ``to_jax_params`` is its inverse: it re-stacks the layers
into ``stack/blocks/sub{j}`` and ``stack/tail/tail{j}``.  ``to_jax_state`` /
``from_jax_state`` map a whole train state (params, m, v, master, step) the
same way, so a checkpoint crosses between the packages in both directions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt.checkpoint import is_bf16, to_host, to_tensor
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
        return to_tensor(a, dtype, dev)

    out = map_with_path(convert, M.model_param_defs(spec))
    unused = sorted("/".join(p) for p in set(src) - used)
    if unused:
        raise ValueError(f"JAX leaves not consumed by the conversion: {unused}")
    return out


def to_jax_params(params, spec: ArchSpec) -> dict:
    """The port's parameters as the JAX ``init_params`` tree (nested dicts of
    numpy arrays in each leaf's dtype; bf16 as f32, which numpy lacks)."""
    pattern, reps, rem = spec.block_pattern()
    layers = params["stack"]
    if len(layers) != reps * len(pattern) + len(rem):
        raise ValueError(f"{len(layers)} layers; the spec has {reps} x {len(pattern)} + {len(rem)}")

    def tree(t):
        return {k: tree(v) for k, v in t.items()} if isinstance(t, dict) else to_host(t)

    def stacked(j):
        subs = [tree(layers[r * len(pattern) + j]) for r in range(reps)]
        return map_with_path(lambda path, _: np.stack([_at(sub, path) for sub in subs]), subs[0])

    out = {k: tree(v) for k, v in params.items() if k != "stack"}
    out["stack"] = {
        "blocks": {f"sub{j}": stacked(j) for j in range(len(pattern))},
        "tail": {f"tail{j}": tree(layers[reps * len(pattern) + j]) for j in range(len(rem))},
    }
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def to_jax_state(state, spec: ArchSpec) -> dict:
    """A port train state as the JAX ``init_state`` tree of numpy arrays."""
    out = {k: to_jax_params(state[k], spec) for k in ("params", "m", "v", "master") if k in state}
    out["step"] = np.asarray(int(state["step"]), dtype=np.int32)
    return out


def from_jax_state(tree, spec: ArchSpec, device=None) -> dict:
    """A JAX train state (nested dicts of arrays) as the port's, each tree in
    its leaves' dtype (params bf16 where the JAX params are)."""
    dev = resolve_device(device)
    out = {}
    for k in ("params", "m", "v", "master"):
        if k in tree:
            dtype = torch.bfloat16 if is_bf16(np.asarray(_first(tree[k]))) else torch.float32
            out[k] = from_jax_params(tree[k], spec, dev, dtype=dtype)
    out["step"] = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=dev)
    return out


def _first(tree):
    return next(leaf for _, leaf in _leaves(tree))
