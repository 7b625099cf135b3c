"""Time one whole max-entropy judgment (Alg. 1) on the card, by route.

    PYTHONPATH=src python3 src/repro_torch/launch/time_judge.py \\
        [--m 10] [--c 10] [--seed 0] [--calls 500]

Host clock around ``MaxEntropyJudge(backend=...)(soft_labels, sizes)``,
which ends in the copy of the verdict to the host (a synchronise), over
``--calls`` calls after a warm-up, in turns: plain (``"torch"``), kernel
(``"cuda"``), kernel, plain. The soft labels are Dirichlet(0.3) rows and
the sizes integers in [10, 500), from ``--seed``. Prints one JSON line:
mean ms per judgment by route, the verdict, and the card's name.

It reaches the package only through ``repro_torch.fl.MaxEntropyJudge``,
so it times any version of the package that ``PYTHONPATH`` names (run it
by path, as above, to time another checkout's package).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.fl import MaxEntropyJudge

ROUTES = ("torch", "cuda")


def judgment_ms(soft_labels: torch.Tensor, sizes: torch.Tensor,
                calls: int = 500, warmup: int = 50) -> tuple[dict, tuple]:
    """(mean ms per whole judgment by route, the cuda route's verdict) on
    CUDA tensors, in turns: torch, cuda, cuda, torch."""
    if not soft_labels.is_cuda:
        raise ValueError("judgment_ms times the card: give it CUDA tensors")
    judges = {route: MaxEntropyJudge(backend=route) for route in ROUTES}
    times = {route: [] for route in ROUTES}
    verdict = None
    for route in ROUTES + ROUTES[::-1]:
        judge = judges[route]
        for _ in range(warmup):
            judge(soft_labels, sizes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            got = judge(soft_labels, sizes)
        times[route].append((time.perf_counter() - t0) / calls * 1e3)
        if route == "cuda":
            verdict = got
    return {route: sum(ts) / len(ts) for route, ts in times.items()}, verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--c", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=500)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_judge: no CUDA device available", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    soft = torch.tensor(rng.dirichlet(np.full(args.c, 0.3), size=args.m),
                        dtype=torch.float32, device="cuda")
    sizes = torch.tensor(rng.integers(10, 500, args.m), dtype=torch.float32,
                         device="cuda")
    ms, (accepted, rejected, ent) = judgment_ms(soft, sizes, args.calls)
    print(json.dumps({"judgment_ms": ms, "m": args.m, "c": args.c,
                      "seed": args.seed, "calls": args.calls,
                      "rejected": rejected, "accepted": accepted,
                      "entropy": ent,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
