"""Batched serving engine: prefill + decode loop with static batching.

Counterpart of the JAX package's ``serve/engine.py``.  Prompts run through
``prefill`` (which fills the caches), then tokens decode step by step with
greedy (argmax) or temperature sampling from a ``torch.Generator`` seeded by
``seed``.  The engine runs on the card unless given ``device="cpu"``; its
timers wait for the card before reading the clock.  ``generate`` runs under
``torch.inference_mode``: parameters that require grad (a train state's)
build no graph, and the kernels take their lean forward-only path.

Under a plan (``plan=``, JAX :35) the parameters are ``DTensor``s on the
plan's mesh (``sharding.distribute_tree`` by ``M.param_axes``), the caches
are made on that mesh by ``M.cache_axes``, the prompts are placed by
``("batch", None)``, and each step's logits come back whole, so every rank
samples the same tokens and returns them.  With no plan nothing changes.

Each call is a ``serve.generate`` span of the program's tracer
(``runtime/tracing.py``) around ``serve.prefill`` and, a decode step each,
``serve.sample``, ``serve.to_host`` and ``serve.decode_step``; their
``request`` is the call's number on this engine, ``step`` the decode step's.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import resolve_device
from repro_torch.configs.base import ArchSpec
from repro_torch.models import model as M
from repro_torch.models.layers import map_with_path
from repro_torch.parallel.sharding import NULL_PLAN, ShardingPlan, distribute_tree, placements
from repro_torch.runtime import tracing
from repro_torch.serve import api


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0

    @property
    def decode_tok_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


def _mesh_of(params):
    """The mesh the parameters are ``DTensor``s on."""
    leaves = []
    map_with_path(lambda _, t: leaves.append(t), params)
    mesh = next((t.device_mesh for t in leaves if isinstance(t, DTensor)), None)
    if mesh is None:
        raise ValueError("under a plan the parameters must be DTensors on its mesh "
                         "(sharding.distribute_tree by M.param_axes)")
    return mesh


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


class Engine:
    def __init__(self, spec: ArchSpec, params, *, plan: ShardingPlan = NULL_PLAN,
                 max_len: int = 256, dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.spec = spec
        self.params = params
        self.plan = plan
        self.mesh = _mesh_of(params) if plan.axis_sizes else None
        self.max_len = max_len
        self.dtype = dtype
        self._prefill = api.make_prefill_step(spec, plan, compute_dtype=dtype)
        self._decode = api.make_serve_step(spec, plan, compute_dtype=dtype)
        self._requests = itertools.count()

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int = 32,
                 temperature: float = 0.0, seed: int = 0) -> tuple[np.ndarray, ServeStats]:
        """prompts: (B, S) int32 (same length; pad upstream)."""
        request = next(self._requests)
        with tracing.span("serve.generate", request=request):
            return self._generate(prompts, max_new, temperature, seed, request)

    def _generate(self, prompts, max_new, temperature, seed, request):
        b, s = prompts.shape
        if s + max_new > self.max_len:
            raise ValueError(f"{s} prompt + {max_new} new tokens exceed max_len {self.max_len}")
        stats = ServeStats()
        with tracing.span("serve.prefill", request=request):
            caches = M.init_caches(self.spec, b, self.max_len, dtype=self.dtype,
                                   device=self.device)
            tokens = torch.as_tensor(prompts, device=self.device)
            if self.mesh is not None:
                caches = distribute_tree(caches, M.cache_axes(self.spec, b, self.max_len),
                                         self.plan, self.mesh)
                tokens = distribute_tensor(tokens, self.mesh, placements(
                    self.plan.spec(("batch", None), tuple(tokens.shape)), self.mesh),
                    src_data_rank=None)

            t0 = self._clock()
            logits, caches = self._prefill(self.params, tokens, caches)
            stats.prefill_s = self._clock() - t0

        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = np.zeros((b, max_new), np.int32)
        t0 = self._clock()
        for i in range(max_new):
            with tracing.span("serve.sample", request=request, step=i):
                logits = _whole(logits)
                if temperature > 0:
                    probs = torch.softmax(logits.float() / temperature, dim=-1)
                    tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
                else:
                    tok = logits.argmax(dim=-1)
            with tracing.span("serve.to_host", request=request, step=i):
                out[:, i] = tok.cpu().numpy()
            with tracing.span("serve.decode_step", request=request, step=i):
                logits, caches = self._decode(self.params, caches, tok, s + i)
        stats.decode_s = self._clock() - t0
        stats.tokens_out = b * max_new
        return out, stats
