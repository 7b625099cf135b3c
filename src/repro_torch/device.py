"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import threading

import torch

# Held by a CUDA graph capture (``fl.graph_cache.CapturedProgram``) and by
# every CUDA call another thread makes while the round thread may capture
# (the streaming plane's prefetch thread: its pinned allocations, copies
# and event waits). A capture runs in CUDA's global mode, in which such a
# call from any thread can fail or invalidate the capture; holding this
# lock keeps the two apart. Re-entrant: a program captured inside another
# program's warm-up takes it again on the same thread.
CAPTURE_LOCK = threading.RLock()


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a CUDA device
    and no card is present, or a card index that is not visible — the
    port never carries on on the CPU (or on another card) in place of the
    card asked for."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        count = torch.cuda.device_count()
        if device.index is not None and device.index >= count:
            raise RuntimeError(
                f"device {str(device)!r} requested but only {count} CUDA "
                f"device(s) are visible")
    return device


def canonical_device(device="cuda") -> torch.device:
    """:func:`resolve_device` with a card's index made explicit
    (``"cuda"`` is the current card), so two names of one device compare
    equal."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def visible_devices() -> list:
    """Every visible card, once each; the CPU alone where there is no
    card (as ``jax.devices()`` lists the host on a machine without an
    accelerator)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]
