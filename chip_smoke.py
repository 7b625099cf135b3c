#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which raises on failure (exit code non-zero):

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc;
2. hold the entropy-judge kernel (K1) against its plain PyTorch version;
3. hold the fused-aggregation kernel (K2) against its plain version;
4. drive the paper's FedEntropy round at full width — the CIFAR-shaped
   CNN, N = 100 clients, 10% participation, E = 5, batch 50 — for three
   rounds through both kernels, show by launch counts that it did, and
   repeat the rounds on the plain versions to check the result;
5. time both kernels, their plain versions and the PyTorch library call
   for K2, at the main path's shapes.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
a JSON object with every kernel's launches, error, times and bound.
Exits non-zero, printing no result, when no CUDA device is present.
Imports neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import fl  # noqa: E402
from repro_torch.core.judgment import judge_np  # noqa: E402
from repro_torch.data.corpus import ClientCorpus  # noqa: E402
from repro_torch.data.partition import partition  # noqa: E402
from repro_torch.data.synthetic import make_image_dataset  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.entropy_judge import entropy_judge_sweep  # noqa: E402
from repro_torch.kernels.fused_aggregate import (  # noqa: E402
    masked_weighted_sum)
from repro_torch.models import cnn  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, float32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

K1_ATOL = 1e-4          # the JAX package's kernel-test tolerance
K2_RTOL, K2_ATOL = 1e-5, 1e-6
PARAMS_RTOL = 1e-5      # cuda-route vs plain-route global params
ROUNDS = 3


def _phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def _time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events, warm caches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_pair(kernel, plain, **kw) -> tuple[float, float]:
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel,
    plain."""
    p1 = _time_ms(plain, **kw)
    k1 = _time_ms(kernel, **kw)
    k2 = _time_ms(kernel, **kw)
    p2 = _time_ms(plain, **kw)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _kernel_us(prof, names=()) -> dict:
    """Device microseconds by kernel name from a finished profiler, for
    kernels (and copies) whose name contains one of ``names`` (all when
    empty). Operator rows are skipped: they repeat their kernels' time."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:                               # older torch
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and (not names or any(n in e.key for n in names)):
            out[e.key] = out.get(e.key, 0.0) + us
    return out


def _device_ms(fn, names, iters: int = 50) -> float:
    """Device time per call, in ms, of the kernels ``fn`` launches whose
    names contain one of ``names`` (torch.profiler, warm caches)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(_kernel_us(prof, names).values()) / iters / 1e3


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _k1_inputs(m, c, seed, dtype=torch.float32, mask=None):
    rng = np.random.default_rng(seed)
    soft = rng.dirichlet(np.full(c, 0.3), size=m)
    sizes = rng.integers(10, 500, m).astype(np.float32)
    if mask is None:
        mask = (rng.random(m) < 0.7).astype(np.float32)
        mask[rng.integers(m)] = 1.0
    dev = torch.device("cuda")
    return (torch.tensor(soft, dtype=dtype, device=dev),
            torch.tensor(sizes, device=dev),
            torch.tensor(mask, dtype=torch.float32, device=dev))


def check_k1() -> float:
    worst = 0.0
    cases = [((10, 10), torch.float32, None), ((8, 10), torch.float32, None),
             ((16, 1000), torch.float32, None),
             ((10, 517), torch.float32, None),
             ((32, 4096), torch.float32, None),
             ((10, 151936), torch.float32, None),
             ((16, 1000), torch.bfloat16, None),
             ((10, 10), torch.float32, "single"),
             ((10, 10), torch.float32, "empty")]
    for i, ((m, c), dtype, special) in enumerate(cases):
        mask = None
        if special == "single":
            mask = np.zeros(m, np.float32)
            mask[3] = 1.0
        elif special == "empty":
            mask = np.zeros(m, np.float32)
        soft, sizes, mk = _k1_inputs(m, c, seed=i, dtype=dtype, mask=mask)
        ent_k, loo_k = entropy_judge_sweep(soft, sizes, mk)
        ent_p, loo_p = ref.entropy_judge_sweep_reference(soft, sizes, mk)
        torch.cuda.synchronize()
        err = max(float((ent_k - ent_p).abs()),
                  float((loo_k - loo_p).abs().max()))
        label = f"({m}, {c}) {str(dtype).split('.')[-1]}" + (
            f" mask={special}" if special else "")
        print(f"K1 {label}: max_abs_err={err:.3e}")
        if not err <= K1_ATOL:
            raise AssertionError(f"K1 {label} disagrees with its plain "
                                 f"version: {err} > {K1_ATOL}")
        if special == "single":
            if not (float(loo_k[3]) == -1.0 and
                    bool((loo_k[mk == 0] == ent_k).all())):
                raise AssertionError("K1 single-device conventions broken")
        if special == "empty":
            if not (abs(float(ent_k) - math.log(c)) < 1e-6 and
                    bool((loo_k == -1.0).all())):
                raise AssertionError("K1 empty-set conventions broken")
        worst = max(worst, err)
    return worst


def check_k2() -> float:
    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    # values in [0, 1) and weights in (0, 1]: sums without cancellation,
    # so the relative tolerance bounds a correct float32 sum
    for m, p in [(10, 62006), (3, 1), (16, 16 * 2 ** 20), (300, 4099)]:
        flat = torch.rand((m, p), generator=gen, device="cuda")
        w = torch.rand(m, generator=gen, device="cuda") + 1e-3
        w[0] = 0.0                                   # a masked-out client
        got = masked_weighted_sum(flat, w)
        want = ref.masked_weighted_sum_reference(flat, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"K2 ({m}, {p}): max_abs_err={err:.3e}")
        torch.testing.assert_close(got, want, rtol=K2_RTOL, atol=K2_ATOL)
        worst = max(worst, err)
        del flat
    return worst


class RecordingJudge:
    """Delegates to ``inner`` and keeps each round's judge inputs, so the
    float32 verdicts can be set beside the float64 oracle's."""

    def __init__(self, inner):
        self.inner = inner
        self.seen = []

    def __call__(self, soft_labels, sizes):
        self.seen.append((soft_labels.clone(), sizes.clone()))
        return self.inner(soft_labels, sizes)


def run_rounds(params, corpus, backend: str, judge=None):
    cfg = fl.ServerConfig(num_clients=100, participation=0.1, seed=0)
    server = fl.build(
        "fedentropy", cnn.apply, params, corpus, cfg, fl.LocalSpec(),
        judge=judge or fl.MaxEntropyJudge(backend=backend),
        aggregator=fl.FusedAverageAggregator(backend=backend),
        device="cuda")
    walls = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = server.round()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(f"[{backend}] round {rec['round']}: selected={rec['selected']}"
              f" positive={rec['positive']} negative={rec['negative']}"
              f" entropy={rec['entropy']:.6f}"
              f" comm_bytes={rec['comm']['total_bytes']}"
              f" wall_s={walls[-1]:.4f}", flush=True)
    return server, walls


def main_path():
    t0 = time.perf_counter()
    (xtr, ytr), (xte, yte) = make_image_dataset(
        num_classes=10, train_per_class=5000, hw=32, channels=3)
    parts = partition("case1", ytr, 100, 10)
    corpus = ClientCorpus.from_parts(xtr, ytr, parts, batch_multiple=50,
                                     device="cuda")
    params = cnn.init(torch.Generator().manual_seed(0), image_hw=32,
                      channels=3, num_classes=10)
    n_params = sum(t.numel() for layer in params.values()
                   for t in layer.values())
    print(f"corpus x{tuple(corpus['x'].shape)} {corpus.nbytes / 1e6:.1f} MB "
          f"resident; CNN params {n_params}; set-up "
          f"{time.perf_counter() - t0:.1f} s")

    judge = RecordingJudge(fl.MaxEntropyJudge(backend="cuda"))
    entropy_judge_sweep.launches = 0
    masked_weighted_sum.launches = 0
    server, walls = run_rounds(params, corpus, "cuda", judge=judge)
    metrics = server.evaluate(xte, yte)
    launches = {"entropy_judge_sweep": entropy_judge_sweep.launches,
                "masked_weighted_sum": masked_weighted_sum.launches}
    print(f"eval: {metrics}; launches in {ROUNDS} rounds: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    if not (0.0 <= metrics["accuracy"] <= 1.0
            and math.isfinite(metrics["loss"])):
        raise AssertionError(f"bad eval metrics {metrics}")
    for layer in server.global_params.values():
        for t in layer.values():
            if not bool(torch.isfinite(t).all()):
                raise AssertionError("non-finite global params")

    plain, _ = run_rounds(params, corpus, "torch")
    for a, b in zip(server.history, plain.history):
        for key in ("selected", "positive", "negative"):
            if a[key] != b[key]:
                raise AssertionError(f"round {a['round']} {key}: cuda "
                                     f"{a[key]} != plain {b[key]}")
        if a["comm"] != b["comm"]:
            raise AssertionError(f"round {a['round']} comm differs")
    worst_rel = 0.0
    for name, layer in server.global_params.items():
        for k, t in layer.items():
            u = plain.global_params[name][k]
            rel = float((t - u).abs().max() / u.abs().max().clamp(min=1e-30))
            worst_rel = max(worst_rel, rel)
    print(f"cuda route vs plain route: integer records equal; global "
          f"params max |diff| / max |value| per leaf = {worst_rel:.3e}")
    if not worst_rel <= PARAMS_RTOL:
        raise AssertionError(f"global params differ: {worst_rel} > "
                             f"{PARAMS_RTOL}")

    agree = 0
    for soft, sizes in judge.seen:
        a_np, r_np, _ = judge_np(soft.double().cpu().numpy(),
                                 sizes.double().cpu().numpy())
        a_k, r_k, _ = judge.inner(soft, sizes)
        agree += (a_np, r_np) == (a_k, r_k)
    print(f"(information) float32 kernel verdicts equal to the float64 "
          f"judge_np in {agree} of {len(judge.seen)} rounds")
    profile_round(server)
    return launches, walls, judge.seen[0], n_params


def profile_round(server) -> None:
    """One more round of ``server`` under torch.profiler: wall time,
    summed kernel time, the device's idle share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = _kernel_us(prof)
    busy = sum(by_kernel.values()) / 1e6
    print(f"profiled round: wall {wall:.4f} s, kernels {busy:.4f} s, "
          f"device idle share {1 - busy / wall:.3f} (profiler on)")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}")


def time_kernels(judge_inputs, p: int) -> dict:
    """K1 on the first round's soft labels and sizes with every device
    active; K2 on a (M, P) buffer of the main path's shape."""
    soft, sizes = judge_inputs
    m, c = soft.shape
    mask = torch.ones(m, device=soft.device)
    k1_ms, k1_plain = _time_pair(
        lambda: entropy_judge_sweep(soft, sizes, mask),
        lambda: ref.entropy_judge_sweep_reference(soft, sizes, mask))
    k1_bytes = m * c * 4 + 2 * m * 4 + (m + 1) * 4
    k1_flops = 2 * m * c + 3 * c + 6 * m * c

    gen = torch.Generator(device="cuda").manual_seed(1)
    flat = torch.randn((m, p), generator=gen, device="cuda")
    w = torch.rand(m, generator=gen, device="cuda")
    k2_ms, k2_plain = _time_pair(lambda: masked_weighted_sum(flat, w),
                                 lambda: ref.masked_weighted_sum_reference(
                                     flat, w))
    k2_lib = _time_ms(lambda: w @ flat)
    k2_bytes = (m * p + m + p) * 4
    k2_flops = 2 * m * p
    k1_call = lambda: entropy_judge_sweep(soft, sizes, mask)
    k2_call = lambda: masked_weighted_sum(flat, w)
    print(f"device time per call (torch.profiler): K1's two kernels "
          f"{_device_ms(k1_call, ('judge_',)):.5f} ms, every kernel of "
          f"the K1 wrapper {_device_ms(k1_call, ()):.5f} ms, K2 kernel "
          f"{_device_ms(k2_call, ('masked_weighted_sum',)):.5f} ms")
    return {"k1": (k1_ms, k1_plain, *_bound_ms(k1_bytes, k1_flops), (m, c)),
            "k2": (k2_ms, k2_plain, k2_lib, *_bound_ms(k2_bytes, k2_flops),
                   (m, p))}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cudnn.deterministic={torch.backends.cudnn.deterministic}")

    _phase("1. build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        print(f"-- nvcc {name} ({info['seconds']:.2f} s):\n"
              f"{info['log'].strip()}")

    _phase("2. K1 entropy_judge_sweep vs plain")
    k1_err = check_k1()
    _phase("3. K2 masked_weighted_sum vs plain")
    k2_err = check_k2()
    _phase("4. main path: fedentropy, N=100, CNN at 32x32x3, 10 classes")
    launches, walls, judge_inputs, n_params = main_path()
    _phase("5. times")
    t = time_kernels(judge_inputs, n_params)
    k1_ms, k1_plain, k1_bound, k1_by, k1_shape = t["k1"]
    k2_ms, k2_plain, k2_lib, k2_bound, k2_by, k2_shape = t["k2"]
    print(f"K1 {k1_shape}: {k1_ms:.5f} ms, plain {k1_plain:.5f} ms, "
          f"bound {k1_bound:.3e} ms ({k1_by})")
    print(f"K2 {k2_shape}: {k2_ms:.5f} ms, plain {k2_plain:.5f} ms, "
          f"library (w @ flat) {k2_lib:.5f} ms, bound {k2_bound:.3e} ms "
          f"({k2_by})")
    print(f"round wall s: {[round(x, 4) for x in walls]}, median "
          f"{statistics.median(walls):.4f}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    kernels = [
        {"name": "entropy_judge_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/entropy_judge.cu",
         "replaces": "src/repro/kernels/entropy_judge.py:68",
         "launches": launches["entropy_judge_sweep"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "masked_weighted_sum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_aggregate.cu",
         "replaces": "src/repro/kernels/fused_aggregate.py:65",
         "launches": launches["masked_weighted_sum"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
