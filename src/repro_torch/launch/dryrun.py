"""One-card dry-run: does every (arch x input shape) run, what does it
cost, and does it fit — without a card. The port of
``repro.launch.dryrun`` on one card.

For each combination this driver builds the model on the meta device in
the config's own dtype (weights, optimizer state, batch and cache are
shapes with no storage), builds the FedEntropy train step
(``core.distributed.make_train_step`` with ``FedSpec(num_clients=16)``,
the reference's client count on its single-pod mesh, and ``sgd(0.01,
0.5)``, donated) for train shapes or the serving prefill / decode step
(``make_serve_steps``) for inference shapes, runs it once under
:class:`.cost_analysis.CostCounter` and records:

  * ``memory_analysis``  — argument, output and temp bytes (the peak above
                           the arguments): does it fit the card's 80 GB?
  * ``hlo_flops_per_device`` / ``hlo_hbm_bytes_per_device`` — the
                           products' FLOPs and the eager ops' bytes of the
                           call (the reference's keys; here counted op by
                           op, backward and recomputation included)
  * ``model_flops_global`` = 6·N_active·D (train) / 2·N_active·D — the
                           analytic useful compute, for the ratio
  * ``roofline``         — compute, memory and collective seconds at the
                           card's peaks, and the dominant one.

A dry-run computes no values, so the meta device is its home, not a
fallback: it allocates nothing on a card and runs where none is present.
The step's judge runs one iteration of Alg. 1's loop (:func:`judge_once`):
a meta tensor has no value to decide a second, as the reference's HLO
walk counts a ``while`` body with no known trip count once.

One card holds the whole global batch and the port has no sharding rules;
``--multi-pod``, ``--seq-rule`` and ``--kv-time-rule`` wait for several
cards.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape prefill_32k
  python -m repro_torch.launch.dryrun --out results.json
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Any

import torch

from ..configs import ARCHS, ASSIGNED, SHAPES
from ..configs.base import ModelConfig, ShapeConfig
from ..core.distributed import FedSpec, make_serve_steps, make_train_step
from ..core.entropy import group_entropy, leave_one_out_entropies
from ..core.judgment import _TOL, JudgmentResult
from ..models.api import (Model, build_model, decode_window, input_specs,
                          supported)
from ..models.layers import dtype_of
from ..optim import sgd
from .cost_analysis import CostCounter

# NVIDIA H100 80GB HBM3 (SXM) peaks from its data sheet, the card that
# nvidia-smi names "NVIDIA H100 80GB HBM3" at a 700.00 W power limit:
# dense tensor-core bfloat16, float32 on the CUDA cores, HBM3's rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BW = 3.35e12             # bytes/s
NUM_CLIENTS = 16             # the reference's fl_clients_for(single pod)

# Each config's parameter count at full width and depth: the reference's
# jax.eval_shape of its init, which tests/test_torch_dryrun.py holds the
# port's meta build and the reference to, and chip_smoke.py the card's
PARAM_COUNTS = {
    "mamba2-130m": 129_100_224,
    "whisper-large-v3": 1_535_636_480,
    "qwen3-0.6b": 596_180_992,
    "granite-8b": 8_254_689_280,
    "internvl2-1b": 494_720_896,
    "gemma-7b": 8_537_680_896,
    "zamba2-2.7b": 1_955_541_680,
    "qwen3-moe-235b-a22b": 235_094_683_136,
    "chatglm3-6b": 6_243_584_000,
    "kimi-k2-1t-a32b": 1_042_174_407_680,
}


def judge_once(soft: torch.Tensor, sizes: torch.Tensor) -> JudgmentResult:
    """One iteration of Alg. 1's greedy loop over all M clients, reading
    nothing back: the initial group entropy, one leave-one-out sweep and
    the removal it admits (``core.judgment.judge``'s body once)."""
    p = soft.to(torch.float32)
    w = sizes.to(torch.float32)
    active = torch.ones(p.shape[0], device=p.device)
    ent0 = group_entropy(p, w, active)
    loo = leave_one_out_entropies(p, w, active)
    best = loo.argmax()
    improves = loo.max() > ent0 + _TOL
    mask = torch.where(improves, active.index_fill(0, best[None], 0.0),
                       active)
    ent = torch.where(improves, loo.max(), ent0)
    return JudgmentResult(mask=mask, entropy=ent, initial_entropy=ent0,
                          num_removed=improves.to(torch.int32))


def model_flops(cfg: ModelConfig, shape: ShapeConfig,
                params_shape: dict) -> float:
    """6*N_active*D (train) / 2*N_active*D (inference) analytic FLOPs,
    N = non-embedding active params (+ the LM-head matmul counted via the
    head/tied-embedding table). ``params_shape``: the weights' shapes by
    their dotted names (``Model.params()``)."""
    total_active = 0
    head_flops_per_tok = 2 * cfg.d_model * cfg.padded_vocab
    for path, leaf in params_shape.items():
        names = tuple(path.split("."))
        if names[-2:] == ("tok", "embed") or names[-2:] == ("tok", "head"):
            continue
        n = int(torch.Size(leaf.shape).numel())
        if "moe" in names and names[-1] in ("w_in", "w_gate", "w_out"):
            n = n // cfg.num_experts * cfg.experts_per_token
        total_active += n
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return mult * total_active * tokens + mult / 2 * head_flops_per_tok * \
        tokens


def count_call(fn, arguments) -> tuple[CostCounter, Any, float]:
    """(counter, output, seconds) of ``fn()`` run once under a
    :class:`CostCounter` that holds ``arguments`` as the call's."""
    counter = CostCounter()
    counter.track(arguments)
    t0 = time.perf_counter()
    with counter:
        out = fn()
    return counter, out, time.perf_counter() - t0


def step_call(model: Model, shape: ShapeConfig, specs: dict, *,
              chunked_head: bool = False, window: int = 0):
    """(call, arguments) of the step of ``shape``'s kind on ``model``: the
    donated train step, the prefill or the decode step."""
    params = {k: v.detach() for k, v in model.params().items()}
    if shape.kind == "train":
        opt = sgd(lr=0.01, momentum=0.5)
        fed = FedSpec(num_clients=NUM_CLIENTS, chunked_head=chunked_head)
        step = make_train_step(model, opt, fed, judge_once, donate=True)
        state = opt.init(params)
        return (lambda: step(params, state, specs),
                (params, state, specs))
    prefill_step, decode_step = make_serve_steps(model, window=window)
    if shape.kind == "prefill":
        return lambda: prefill_step(specs), (params, specs)
    return (lambda: decode_step(specs["cache"], specs["tokens"]),
            (params, specs))


def run_combo(arch: str, shape_name: str, *, attn: str = "torch",
              chunked_head: bool = False, remat: str | None = None,
              capacity_factor: float | None = None,
              reduced: bool = False) -> dict[str, Any]:
    """One (arch, shape) record. attn/chunked_head/remat/capacity_factor
    are the reference's knobs; ``reduced`` runs ``cfg.reduced()``."""
    cfg = ARCHS[arch]
    if reduced:
        cfg = cfg.reduced()
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    if capacity_factor is not None:
        cfg = cfg.replace(moe_capacity_factor=capacity_factor)
    shape = SHAPES[shape_name]
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "multi_pod": False,
                           "variant": {"attn": attn,
                                       "chunked_head": chunked_head,
                                       "remat": cfg.remat,
                                       "cf": cfg.moe_capacity_factor,
                                       "seq_rule": False,
                                       "kv_time_rule": False}}
    ok, why = supported(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec

    t0 = time.perf_counter()
    model = build_model(cfg, device="meta", kernels=attn)
    specs = input_specs(cfg, shape)
    call, arguments = step_call(model, shape, specs,
                                chunked_head=chunked_head,
                                window=decode_window(cfg, shape))
    counter, out, _ = count_call(call, arguments)
    trace_s = time.perf_counter() - t0
    cost = counter.summary()

    mf = model_flops(cfg, shape, model.params())
    flops = cost["flops"]
    terms = {"compute_s": flops / PEAK_FLOPS[dtype_of(cfg)],
             "memory_s": cost["hbm_bytes"] / HBM_BW,
             "collective_s": 0.0}
    rec.update({
        "status": "ok",
        "num_devices": 1,
        "num_params": model.num_params(),
        "trace_s": round(trace_s, 1),
        "memory_analysis": counter.memory_analysis(out, arguments),
        "peak_bytes": cost["peak_bytes"],
        "hlo_flops_per_device": flops,
        "hlo_hbm_bytes_per_device": cost["hbm_bytes"],
        "collective_bytes": cost["collective_bytes"],
        "collective_counts": cost["collective_counts"],
        "collective_bytes_total": cost["collective_bytes_total"],
        "model_flops_global": mf,
        "useful_flops_ratio": mf / max(flops, 1.0),
        "roofline": dict(terms, dominant=max(terms, key=terms.get)),
        "ops": cost["by_op"],
    })
    return rec


def fmt_row(r: dict) -> str:
    if r["status"] != "ok":
        return f"{r['arch']:24s} {r['shape']:12s} SKIP  ({r['reason'][:60]})"
    t = r["roofline"]
    mem = r["memory_analysis"]
    per_dev_gb = (mem.get("argument_size_in_bytes", 0) +
                  mem.get("temp_size_in_bytes", 0)) / 2**30
    return (f"{r['arch']:24s} {r['shape']:12s} "
            f"cmp={t['compute_s']*1e3:9.2f}ms "
            f"mem={t['memory_s']*1e3:9.2f}ms "
            f"col={t['collective_s']*1e3:9.2f}ms "
            f"dom={t['dominant'][:-2]:10s} "
            f"useful={r['useful_flops_ratio']*100:5.1f}% "
            f"dev={per_dev_gb:6.2f}GiB "
            f"trace={r['trace_s']:.0f}s")


SEVERAL_CARDS = ("the port runs on one card; sharding waits for the "
                 "gradient-level mesh step over several cards (ROADMAP "
                 "queue 1)")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", help="input shape or 'all'")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: " + SEVERAL_CARDS)
    ap.add_argument("--out", default="", help="write JSON records here")
    ap.add_argument("--attn", default="torch",
                    choices=["torch", "blockwise"],
                    help="attention route (blockwise: key blocks "
                         "recomputed in the backward)")
    ap.add_argument("--chunked-head", action="store_true",
                    help="stream vocab head in seq chunks")
    ap.add_argument("--remat", default=None,
                    choices=[None, "none", "full", "dots"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--seq-rule", action="store_true",
                    help="refused: " + SEVERAL_CARDS)
    ap.add_argument("--kv-time-rule", action="store_true",
                    help="refused: " + SEVERAL_CARDS)
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' reduced() variants")
    args = ap.parse_args(argv)
    for flag in ("multi_pod", "seq_rule", "kv_time_rule"):
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')}: {SEVERAL_CARDS}")

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]

    records = []
    for arch in archs:
        for shape in shapes:
            try:
                r = run_combo(arch, shape, attn=args.attn,
                              chunked_head=args.chunked_head,
                              remat=args.remat,
                              capacity_factor=args.capacity_factor,
                              reduced=args.reduced)
            except Exception as e:  # a failure here is a bug in the system
                r = {"arch": arch, "shape": shape, "status": "error",
                     "multi_pod": False,
                     "error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc()[-2000:]}
            records.append(r)
            if r["status"] == "error":
                print(f"{arch:24s} {shape:12s} ERROR {r['error'][:90]}",
                      flush=True)
            else:
                print(fmt_row(r), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {len(records)} records to {args.out}")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"== {n_ok} ok / {n_skip} skipped / {n_err} errors ==")
    if n_err:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
