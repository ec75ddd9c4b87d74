"""Checkpointing: atomic, async-capable.

Counterpart of the JAX package's ``ckpt/checkpoint.py``, in its format: one
directory ``step_{step:08d}`` per checkpoint holding ``arrays.npz`` (one
array per leaf, keyed by the leaf's path written as ``keystr`` writes it,
``['params']['stack'][0]['mixer']['wq']``) and ``meta.json``.

* atomic  — written to ``.tmp_step_*`` and renamed; a crash mid-write never
            leaves a partial ``step_*`` directory.
* async   — ``AsyncCheckpointer`` snapshots to host memory synchronously and
            persists on a background thread, overlapping the next steps.
* restore — into the structure of a given tree, with shape checks, onto the
            device the caller names, or onto a device mesh (the elastic
            path: a checkpoint written from any mesh is placed by the new
            plan).
* sharded — a ``DTensor`` leaf is gathered whole before it is written
            (every rank takes part), and only rank 0 writes, behind a
            barrier.

The keys are the port's own tree paths (one subtree per layer), not the JAX
package's stacked ones: a state crosses between the packages through
``repro_torch.convert`` (``to_jax_state`` / ``from_jax_state``), and
``load_arrays`` + ``unflatten`` read a checkpoint of the JAX package as its
tree.  numpy has
no bfloat16, so a bf16 leaf is stored as its exact f32 value and cast back
on restore; a bfloat16 array written by the JAX package (2-byte, from
``ml_dtypes``) reads back bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.parallel.sharding import ShardingPlan, placements, plan_for_mesh


def _key(path) -> str:
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]" for p in path)


def flatten(tree, path=(), is_leaf=lambda _: False) -> dict[str, Any]:
    """{keystr path: leaf} over nested dicts and lists (and tuples, unless
    ``is_leaf`` takes them)."""
    if is_leaf(tree):
        return {_key(path): tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flatten(sub, path + (key,), is_leaf).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flatten(sub, path + (i,), is_leaf).items()}
    return {_key(path): tree}


def unflatten(values: dict[str, Any]):
    """The nested dicts (lists where the keys are 0..n-1) that ``flatten``
    made ``values`` from: a checkpoint of either package as a tree."""
    root: dict = {}
    for key, leaf in values.items():
        parts = [int(a) if a else b for a, b in re.findall(r"\[(\d+)\]|\['([^']*)'\]", key)]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def lists(t):
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        return [t[i] for i in range(len(t))] if t and set(t) == set(range(len(t))) else t
    return lists(root)


def is_bf16(arr: np.ndarray) -> bool:
    """A 2-byte array that is not a numpy number: bfloat16 (``ml_dtypes``, or
    its raw bits as numpy reads an npz without it)."""
    return arr.dtype.itemsize == 2 and arr.dtype.kind not in "fiub"


def _unflatten_like(like, values: dict[str, Any], path=()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, values, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, values, path + (i,)) for i, v in enumerate(like))
    return values[_key(path)]


def _ranks() -> tuple[int, int]:
    """(this rank, world size) of the default process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _ranks()[1] > 1:
        dist.barrier()


def to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array: a tensor copied to the host (bf16 as f32); a
    ``DTensor`` gathered whole first (a collective: every rank calls it)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(leaf)


def to_tensor(arr: np.ndarray, dtype=None, device=None) -> torch.Tensor:
    """A numpy array as a tensor; a 2-byte non-numeric array (``ml_dtypes``
    bfloat16) is read as bfloat16 bits."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()  # (np.ascontiguousarray would make a 0-d array 1-d)
    if is_bf16(arr):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def save(ckpt_dir: str | Path, tree, step: int, meta: dict | None = None) -> Path:
    """Atomic checkpoint write by rank 0; every rank returns once it is
    written.  Returns the final directory."""
    arrays = {k: to_host(v) for k, v in flatten(tree).items()}
    final = Path(ckpt_dir) / f"step_{step:08d}"
    if _ranks()[0] == 0:
        _write(ckpt_dir, arrays, step, meta)
    _barrier()
    return final


def _write(ckpt_dir, arrays: dict[str, np.ndarray], step: int, meta: dict | None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **{k.replace("/", "\x1f"): v for k, v in arrays.items()})
    (tmp / "meta.json").write_text(json.dumps({
        "step": step, "keys": list(arrays.keys()),
        "time": time.time(), **(meta or {}),
    }))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*") if p.is_dir()]
    return max(steps) if steps else None


def load_arrays(ckpt_dir: str | Path, step: int | None = None) -> tuple[dict[str, np.ndarray], int]:
    """Every array of a checkpoint (the latest unless ``step``), by key."""
    ckpt_dir = Path(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    with np.load(ckpt_dir / f"step_{step:08d}" / "arrays.npz") as z:
        return {k.replace("\x1f", "/"): z[k] for k in z.files}, step


def restore(ckpt_dir: str | Path, like_tree, *, step: int | None = None, device=None,
            mesh=None, axes=None, plan: ShardingPlan | None = None):
    """Restore into the structure, dtypes and (unless ``device``) devices of
    ``like_tree``; raises on a missing key or a shape that differs.

    The elastic path (JAX ``restore(shardings=)``, :60-90): with ``mesh``
    and ``axes`` (a tree of logical axes mirroring ``like_tree``), every
    leaf comes back a ``DTensor`` placed on ``mesh`` by ``plan``
    (``plan_for_mesh(mesh)`` if none), whatever mesh wrote it.  Each rank
    keeps its own shards of the full arrays it reads."""
    arrays, step = load_arrays(ckpt_dir, step)
    plan = plan_for_mesh(mesh) if mesh is not None and plan is None else plan
    ax = flatten(axes, is_leaf=lambda x: isinstance(x, tuple)) if mesh is not None else {}
    out = {}
    for key, like in flatten(like_tree).items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(like.shape)}")
        if not isinstance(like, torch.Tensor):
            out[key] = arr.astype(np.asarray(like).dtype)
            continue
        t = to_tensor(arr, like.dtype, device or like.device)
        if mesh is not None:
            t = distribute_tensor(t, mesh, placements(plan.spec(ax[key], t.shape), mesh),
                                  src_data_rank=None)
        out[key] = t
    return _unflatten_like(like_tree, out), step


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, persist in the background."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, tree, step: int, meta: dict | None = None, block: bool = False):
        """Snapshot ``tree`` (every rank: sharded leaves are gathered) and
        write it on rank 0 in the background; ``block`` waits for the write
        and for every rank."""
        self.wait()
        host_tree = {k: to_host(v) for k, v in flatten(tree).items()}  # sync snapshot
        if _ranks()[0] != 0:
            if block:
                _barrier()
            return

        def _persist():
            try:
                _write(self.ckpt_dir, host_tree, step, meta)
                self._gc()
            except Exception as e:  # noqa: BLE001
                self.last_error = e

        self._thread = threading.Thread(target=_persist, daemon=True)
        self._thread.start()
        if block:
            self.wait()
            _barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1]) for p in self.ckpt_dir.glob("step_*"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s:08d}", ignore_errors=True)
