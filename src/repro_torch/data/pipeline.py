"""Deterministic synthetic token pipeline with host-side sharding + prefetch.

The port's own copy of the JAX package's ``data/pipeline.py``: numpy only,
the same code, so each batch equals the JAX package's array for array for
the same (seed, step, host).  The train loop moves a batch to the card.

Production shape: each host materializes only its shard of the global batch
(``host_slice``), the stream is reproducible from (seed, step) — so a
restarted/elastically-rescaled job resumes mid-epoch with zero drift — and a
background thread keeps a bounded prefetch queue ahead of the train loop.
A batch the source fails to make is handed to the loop as its exception,
raised where the loop takes that batch.  The tracer (``runtime/tracing.py``)
sees the feed as ``data.make`` spans on its thread and the loop's wait as
``data.wait`` spans, each with the batch's ``step``.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

from repro_torch.configs.base import ArchSpec
from repro_torch.runtime import tracing


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


class _Failed:
    """What the feed hands the loop in place of a batch it failed to make."""

    def __init__(self, error: BaseException):
        self.error = error


class Prefetcher:
    """Bounded background prefetch: keeps `depth` batches ready."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = self._next = start_step
        self._failed: _Failed | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                with tracing.span("data.make", step=step):
                    item = (step, self.source.batch_at(step))
            except Exception as e:  # raised again in the loop's thread
                item = _Failed(e)
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, _Failed):
                return
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict[str, np.ndarray]]]:
        while True:
            if self._failed is None:
                with tracing.span("data.wait", step=self._next):
                    item = self.q.get()
                if isinstance(item, _Failed):
                    self._failed = item
            if self._failed is not None:
                raise self._failed.error
            self._next += 1
            yield item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
