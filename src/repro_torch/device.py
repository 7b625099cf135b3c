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
    and no card is present — the port never carries on on the CPU in
    place of the card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return device
