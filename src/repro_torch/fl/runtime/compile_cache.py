"""Opt-in process-wide bounded cache of client programs.

A sweep that builds many ``Server`` s over the same apply fn, spec and
corpus shapes captures the client program once per server with the
per-server LRU (the default). Enabling this cache shares them: one
process-wide LRU keyed on what ``Server._client_key`` builds, which holds
everything a captured graph depends on: the apply fn (by identity, pinned
by the entry, so a reused object address never aliases a stale program),
the strategy's spec and in-axes, the params' shapes, the device, the
corpus signature and the cohort size. A captured program copies each
call's arguments into its own buffers, so any server whose arguments fit
it may replay it. On the CPU the entry is the eager vmapped function,
under the same key. The pipelined engine's speculative judge is cached
here too while it is on.

Usage::

    from repro_torch.fl.runtime import enable_process_cache
    cache = enable_process_cache(maxsize=32)
    ... build and run many servers ...
    print(cache.stats())            # {"hits": ..., "misses": ..., ...}
    disable_process_cache()

The transcription of ``repro.fl.runtime.compile_cache``. Like the
per-server cache it is thread-safe and builds outside its lock, once per
key (``BoundedGraphCache.get``), so servers run on several threads at once
can share it: a capture on one thread does not stall another's lookups,
and racing threads on one missing key build it once.
"""
from __future__ import annotations

from typing import Optional

from ..graph_cache import BoundedGraphCache


class ProcessCompileCache(BoundedGraphCache):
    """Bounded LRU shared by every Server in the process, with hit stats:
    a miss is a build (``captures``), so racing threads on one key count
    one miss, and a failed build counts nothing."""

    @property
    def misses(self) -> int:
        return self.captures

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self), "maxsize": self.maxsize}


_PROCESS_CACHE: Optional[ProcessCompileCache] = None


def enable_process_cache(maxsize: int = 32) -> ProcessCompileCache:
    """Turn on process-wide program sharing; returns the cache.

    Re-enabling with a different ``maxsize`` rebounds (and trims) the
    existing cache rather than dropping its programs.
    """
    global _PROCESS_CACHE
    if _PROCESS_CACHE is None:
        _PROCESS_CACHE = ProcessCompileCache(maxsize)
    else:
        _PROCESS_CACHE.trim(maxsize)
    return _PROCESS_CACHE


def disable_process_cache() -> None:
    """Drop the process cache; servers go back to their per-server LRUs."""
    global _PROCESS_CACHE
    _PROCESS_CACHE = None


def process_cache() -> Optional[ProcessCompileCache]:
    """The active process-wide cache, or None when disabled (default)."""
    return _PROCESS_CACHE
