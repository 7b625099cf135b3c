"""Batched serving: prefill a batch of prompts, then decode — the port
of ``repro.launch.serve``.

Serves random-init weights drawn from ``--seed``, or with ``--ckpt-dir``
the latest checkpoint there (``repro_torch.checkpoint``: what
``repro_torch.launch.train --ckpt-dir`` saves), restored into
``Model.params()`` with every shape checked, in float32, on the card
unless ``--device cpu``; ``--kernels cuda`` runs prefill attention,
decode attention and the SSD scan on the hand-written kernels,
``--kernels torch`` on their plain versions. ``--arch`` takes any of the
ten LM configs; the vlm and encdec families get random patch or frame
embeddings from ``--seed`` in place of their frontends.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --reduced --device cpu --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-large-v3 --reduced --device cpu --temperature 0
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import restore
from ..configs import ARCHS
from ..device import resolve_device
from ..models.api import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def request_batch(cfg, b: int, s: int, seed: int, device) -> dict:
    """``b`` random prompts of ``s`` tokens and, in place of the vlm and
    encdec families' frontends, random patch or frame embeddings (float32),
    drawn from ``seed`` in the reference's order: the prompts first."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (b, s)),
                                       dtype=torch.int64, device=device)}
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(
            rng.normal(size=(b, cfg.num_patches, cfg.d_model)),
            dtype=torch.float32, device=device)
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.float32, device=device)
    return batch


def main(argv=None) -> np.ndarray:
    """Runs the server; returns the generated tokens (B, gen)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m",
                    choices=sorted(n for n, c in ARCHS.items()
                                   if c.family != "cnn"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernels", default="cuda", choices=("cuda", "torch"))
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(remat="none", param_dtype="float32", dtype="float32")
    device = resolve_device(args.device)
    model = build_model(cfg, device=device, kernels=args.kernels,
                        seed=args.seed)
    if args.ckpt_dir:
        params, meta, step = restore(args.ckpt_dir, model.params())
        model.net.load_state_dict(params)
        print(f"restored step {step}: {meta}")

    b, s = args.batch, args.prompt_len
    batch = request_batch(cfg, b, s, args.seed, device)
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    window = args.window or None
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, window=window,
                                  cache_len=s + extra + args.gen)
    _sync(device)
    print(f"prefill {b}x{s}: {time.perf_counter() - t0:.2f}s")

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    tok = logits[:, -1:].argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache = model.decode_step(cache, tok, window=window)
        if args.temperature > 0:
            probs = torch.softmax(logits[:, -1] / args.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = logits[:, -1:].argmax(-1)
        out.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1).cpu().numpy()
    print(f"decoded {args.gen - 1} steps in {dt:.2f}s "
          f"({1000 * dt / max(args.gen - 1, 1):.1f} ms/step)")
    for i in range(min(b, 2)):
        print(f"  seq{i}: {tokens[i].tolist()}")
    return tokens


if __name__ == "__main__":
    main()
