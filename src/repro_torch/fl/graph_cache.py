"""The compiled client program: the vmapped ClientUpdate as a CUDA graph.

The reference jits the vmapped client program once per server and keeps
it in a bounded LRU (``BoundedJitCache``). The port's counterpart of a
jitted program is a captured ``torch.cuda.CUDAGraph``: the first round
with a new key runs the program once on a side stream to warm up, then
captures it; later rounds copy their inputs into the graph's
static buffers and replay it, so the E epochs x nb minibatches of the
local training cost one launch from the host instead of one dispatch
per op.

* :class:`CapturedProgram` — one captured program at fixed shapes.
* :class:`BoundedGraphCache` — a per-server LRU of them
  (``ServerConfig.jit_cache_size`` entries).
* :func:`disable_capture` — the counterpart of ``jax.disable_jit()``: the
  server runs the program eagerly on the card inside it.

A kernel wrapper counts its launches in Python (``fn.launches``), which a
replay never enters: a program records how far each count moved during
its capture, takes that back (the capture launched nothing), and adds it
on every replay, so the counts stay the device's launches.

On the CPU the program always runs eagerly: CUDA graphs do not exist
there. A capture that fails raises; nothing falls back to eager.

A capture runs in CUDA's global mode and holds
:data:`repro_torch.device.CAPTURE_LOCK` from its warm-up to its end: the
streaming plane's prefetch thread takes the same lock around each of its
CUDA calls, so none falls inside a capture (where it could fail or
invalidate the capture).
"""
from __future__ import annotations

import gc
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from ..device import CAPTURE_LOCK
from ..kernels._build import COUNTED

_disabled = 0
# eager runs on a side stream before the capture: one sets up the
# libraries' handles and workspaces; the captured route equals the eager
# route bit for bit after it (tests/test_torch_capture.py)
WARMUP_RUNS = 1


@contextmanager
def disable_capture():
    """Run client programs eagerly, on the card too, inside this block
    (nests; the counterpart of ``jax.disable_jit()``)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def capture_enabled() -> bool:
    """False inside :func:`disable_capture`."""
    return _disabled == 0


def _clone(t):
    return None if t is None else t.clone()


class CapturedProgram:
    """``fn`` captured into one CUDA graph at the shapes of ``args``.

    ``args`` is a tuple of trees of CUDA tensors (``None`` leaves allowed)
    on one card, ``device`` (default: the card of the first tensor); the
    warm-up, the capture and every replay run on that card's streams,
    whichever card is current. ``fn`` must be pure in its arguments —
    the warm-up runs change no state. Each
    call copies its arguments into the graph's static input buffers,
    replays the graph and returns the graph's static outputs: the next
    call overwrites them, so a caller clones whatever must outlive it.
    ``launches`` maps each counted kernel wrapper's name to its launches
    in one replay; ``capture_s`` is the host seconds of the capture (the
    warm-up runs apart).
    """

    def __init__(self, fn: Callable, args: tuple, device=None):
        if device is None:
            device = next(t.device for t in pytree.tree_leaves(args)
                          if isinstance(t, torch.Tensor))
        self.device = torch.device(device)
        with CAPTURE_LOCK, torch.cuda.device(self.device):
            self._capture(fn, args)

    def _capture(self, fn: Callable, args: tuple) -> None:
        inputs = pytree.tree_map(_clone, args)
        self._leaves, self._spec = pytree.tree_flatten(inputs)
        # the streams are this card's: the capture and its replays run on
        # the device of the arguments, whichever card is current
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                fn(*inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        counters = list(COUNTED)
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph collects garbage before a capture only under
        # torch.compiler.config.force_cudagraph_gc (False by default), so
        # a collection can fall inside one; one that destroys a dead
        # cycle's captured graph there invalidates the capture
        # (tests/test_torch_capture.py): hold the collector off until the
        # capture ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(
                    device=self.device)):
                self._outputs = fn(*inputs)
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self._counted = []
        for c, n in zip(counters, before):
            if c.launches != n:
                self._counted.append((c, c.launches - n))
                c.launches = n
        self.launches = {c.__name__: d for c, d in self._counted}

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        if spec != self._spec:
            raise ValueError("arguments differ in structure from the "
                             "captured program's")
        for dst, src in zip(self._leaves, leaves):
            if dst is None:
                continue
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"argument {tuple(src.shape)} {src.dtype} does not fit "
                    f"the captured {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)
        with torch.cuda.device(self.device):
            self.graph.replay()
        for c, d in self._counted:
            c.launches += d
        return self._outputs


class BoundedGraphCache:
    """LRU of captured programs, owned by one ``Server`` (or shared by all
    of a process, :mod:`repro_torch.fl.runtime.compile_cache`);
    ``captures`` counts the entries it has built (evicted ones
    included), ``hits`` the lookups that found one.

    Thread-safe, with the reference's ``BoundedJitCache`` semantics:
    ``make()`` runs outside the lock (a capture takes seconds and must not
    stall other keys' lookups), once per key: concurrent callers of one
    missing key wait for the building thread and take its entry (a hit).
    A failed build counts nothing and lets the next caller build. A
    server's round loop looks programs up from one thread (the streaming
    plane's prefetch thread makes no lookups); the lock is for servers run
    on several threads at once, which share the process cache.
    """

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._entries: OrderedDict[Any, Any] = OrderedDict()
        self._building: dict[Any, threading.Event] = {}
        self._lock = threading.RLock()
        self.captures = 0
        self.hits = 0

    def get(self, key, make: Callable[[], Any]):
        while True:
            with self._lock:
                if key in self._entries:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return self._entries[key]
                ev = self._building.get(key)
                if ev is None:
                    ev = self._building[key] = threading.Event()
                    break
            # another thread builds this key: wait, then look again (if
            # its build failed, or the entry was evicted meanwhile, this
            # thread builds on the next pass)
            ev.wait()
        try:
            entry = make()
        except BaseException:
            with self._lock:
                self._building.pop(key, None)
            ev.set()
            raise
        with self._lock:
            self._entries[key] = entry
            self.captures += 1
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
            self._building.pop(key, None)
        ev.set()
        return entry

    def clear(self) -> None:
        """Drop every captured program: a program's graph holds a private
        memory pool the size of its working set (about 1.5x its peak of
        live tensors) for as long as it is cached."""
        with self._lock:
            self._entries.clear()

    def trim(self, maxsize: int) -> None:
        """Rebound the LRU to ``maxsize`` entries, dropping the oldest."""
        with self._lock:
            self.maxsize = max(1, int(maxsize))
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
