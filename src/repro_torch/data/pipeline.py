"""Deterministic synthetic token pipeline with host-side sharding + prefetch.

The port's own copy of the JAX package's ``data/pipeline.py``: numpy only,
the same code, so each batch equals the JAX package's array for array for
the same (seed, step, host).  The train loop moves a batch to the card.

Production shape: each host materializes only its shard of the global batch
(``host_slice``), the stream is reproducible from (seed, step) — so a
restarted/elastically-rescaled job resumes mid-epoch with zero drift — and a
background thread keeps a bounded prefetch queue ahead of the train loop.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

from repro_torch.configs.base import ArchSpec


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Markov-ish synthetic token stream: deterministic per (seed, step),
    non-trivial enough that loss decreases when the model learns it."""

    def __init__(self, spec: ArchSpec, cfg: DataConfig):
        self.spec = spec
        self.cfg = cfg
        # fixed random transition structure (shared across hosts)
        rng = np.random.default_rng(cfg.seed)
        self.vocab = min(spec.vocab_size, 32_768)
        self._succ = rng.integers(0, self.vocab, size=(self.vocab, 4), dtype=np.int32)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.host_id))
        b, s = cfg.host_batch, cfg.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        branch = rng.integers(0, 4, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self._succ[toks[:, t], branch[:, t]]
        out: dict[str, Any] = {"labels": toks[:, 1:].copy()}
        if self.spec.frontend == "tokens":
            out["inputs"] = toks[:, :-1].copy()
        else:
            emb_rng = np.random.default_rng((cfg.seed, step, cfg.host_id, 7))
            out["inputs"] = emb_rng.standard_normal(
                (b, s, self.spec.d_model), dtype=np.float32) * 0.02
        return out


class Prefetcher:
    """Bounded background prefetch: keeps `depth` batches ready."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict[str, np.ndarray]]]:
        while True:
            yield self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
