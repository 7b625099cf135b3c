"""Batched serving of a (reduced) assigned architecture on the PyTorch
port — the twin of ``examples/serve_lm.py`` written against
``repro_torch``: prefill a prompt batch, decode with the position-tagged
KV / SSM-state cache.

``--kernels cuda`` (default) runs prefill attention on K3
(``flash_attention``), decode attention on K4 (``decode_attention``) and
the SSD scan on K5 (``ssd_chunked``); ``torch`` and ``blockwise`` take
their plain versions. It runs on the card unless ``--device cpu``, where
every kernel route takes its plain version:

  PYTHONPATH=src python examples/torch_serve_lm.py --arch zamba2-2.7b --gen 12
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, *, params=None) -> np.ndarray:
    """Serves one batch; returns the generated tokens (B, gen). ``params``
    (a state dict) replaces the seeded init."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding window (ring-buffer cache)")
    ap.add_argument("--kernels", default="cuda",
                    choices=["torch", "blockwise", "cuda"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch].reduced().replace(
        remat="none", param_dtype="float32", dtype="float32")
    device = resolve_device(args.device)
    model = build_model(cfg, device=device, kernels=args.kernels)
    if params is not None:
        model.net.load_state_dict(params)
    rng = np.random.default_rng(0)
    b, s = args.batch, args.prompt_len

    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, s)), dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(
            rng.normal(size=(b, cfg.num_patches, cfg.d_model)),
            dtype=torch.float32)
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.float32)
    batch = {k: v.to(device) for k, v in batch.items()}

    extra = cfg.num_patches if cfg.family == "vlm" else 0
    w = args.window or None
    _sync(device)
    t0 = time.time()
    logits, cache = model.prefill(batch, window=w,
                                  cache_len=s + extra + args.gen)
    _sync(device)
    print(f"prefill {b}x{s}: {time.time() - t0:.2f}s  "
          f"logits {tuple(logits.shape)}")

    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    toks = [tok]
    t0 = time.time()
    for _ in range(args.gen - 1):
        logits, cache = model.decode_step(cache, tok, window=w)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        toks.append(tok)
    _sync(device)
    print(f"decode {args.gen - 1} steps: {time.time() - t0:.2f}s")
    out = torch.cat(toks, 1).cpu().numpy()
    print("generated:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
