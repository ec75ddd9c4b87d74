"""Process-wide switch + registry for the DSE memoization layers.

The batched evaluation engine memoizes two pure functions on the hot path
(trace generation and multi-dimensional collective timing).  Both caches are
keyed on fully-hashable value objects, so a hit is bit-identical to a miss
by construction; this module only provides

  * a global on/off switch (`set_caches_enabled`) so benchmarks can measure
    the uncached seed-equivalent path honestly, and
  * a registry so tests and long-lived searches can clear or inspect every
    cache in one call.

The `COSMIC_DISABLE_CACHES=1` environment variable disables caching at
import time (useful for A/B throughput runs without touching code).
"""
from __future__ import annotations

import functools
import os
from functools import lru_cache
from typing import Callable

_enabled: bool = os.environ.get("COSMIC_DISABLE_CACHES", "0") != "1"

# lru_cache-wrapped functions registered by the modules that own them
_registry: list = []

# bumped by clear_all_caches(); holders of per-instance memo dicts (e.g.
# CosmicEnv's evaluation memo) compare against it to invalidate lazily
_epoch: int = 0


def caches_enabled() -> bool:
    return _enabled


def set_caches_enabled(flag: bool) -> None:
    """Flip memoization globally (existing entries are kept; a disabled
    cache is simply bypassed)."""
    global _enabled
    _enabled = bool(flag)


def register_cache(fn) -> None:
    """Register an lru_cache-wrapped function for global clear/info."""
    _registry.append(fn)


def switchable_lru_cache(maxsize: int = 128):
    """Memoize a pure function of hashable value objects behind the global
    switch: enabled -> lru_cache (a hit is bit-identical to a miss by
    construction), disabled -> straight call-through.  The cache is
    auto-registered for clear_all_caches()/cache_stats()."""
    def deco(fn):
        cached = lru_cache(maxsize=maxsize)(fn)
        register_cache(cached)

        @functools.wraps(fn)
        def wrapper(*args):
            if _enabled:
                return cached(*args)
            return fn(*args)

        wrapper.cache_info = cached.cache_info
        wrapper.cache_clear = cached.cache_clear
        return wrapper
    return deco


def clear_all_caches() -> None:
    global _epoch
    _epoch += 1
    for fn in _registry:
        fn.cache_clear()


def cache_epoch() -> int:
    return _epoch


def cache_stats() -> dict[str, dict]:
    out = {}
    for fn in _registry:
        info = fn.cache_info()
        out[fn.__name__] = {
            "hits": info.hits, "misses": info.misses,
            "size": info.currsize, "max": info.maxsize,
        }
    return out
