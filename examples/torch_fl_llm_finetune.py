"""FL fine-tuning of an assigned LM architecture through the registry's
scan engine on the PyTorch port — the twin of
``examples/fl_llm_finetune.py`` written against ``repro_torch``: the
weights-level paper loop (Alg. 2, E local epochs) at LM scale, R rounds
per block (one CUDA graph on the card).

The composition is ``fedentropy`` with its two LM-scale swaps:

* ``selector="pools-traced"`` — the paper's eps-greedy pools on a
  threefry stream bit-equal to ``jax.random``'s, so the pool draw/re-file
  folds INTO the block as a device-resident carry (no R=1 fallback; the
  script asserts it);
* ``ScanConfig(params_mode="remat")`` — the block stacks only soft
  labels/verdicts/cohorts, O(cohort x vocab) per round instead of R
  copies of the LM params; mismatched rounds rematerialize their rewind
  point by replaying the confirmed prefix.

The client rule is ``strategy="lmstep"``: every next-token position of
an (S, L+1) token window trains (minibatch SGD + momentum), and the soft
label is the weighted mean next-token distribution (paper Eq. 2, LM
analog). On the card the block judges with K1's loop
(``repro_torch.kernels``). ``--verify`` re-runs the same composition
on the sequential ``Server`` and asserts histories match record for
record — the scan is an execution strategy, not a different algorithm.
``--kernels`` picks the kernels: ``torch`` (default) the composition's
leaf-by-leaf weighted mean and the plain attention; ``blockwise`` the
attention over more than 512 keys in key blocks, recomputed in the
backward; ``cuda`` the admitted clients averaged in K2 (one flat
reduction, not bit-equal to the leaf-by-leaf mean) and the plain
attention (the CUDA attention kernels have no backward). It runs on the
card unless ``--device cpu``:

  PYTHONPATH=src python examples/torch_fl_llm_finetune.py --arch mamba2-130m
  PYTHONPATH=src python examples/torch_fl_llm_finetune.py --rounds 8 \\
      --verify --kernels cuda
  PYTHONPATH=src python examples/torch_fl_llm_finetune.py --device cpu \\
      --rounds 2 --rounds-per-scan 2 --seq-len 16
"""
import argparse
import time

import numpy as np
import torch

import repro_torch.fl as fl
from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.train import lm_window_apply, stack_lm_clients
from repro_torch.models.api import build_model


def build_setup(args):
    cfg = ARCHS[args.arch].reduced().replace(
        remat="none", param_dtype="float32", dtype="float32")
    model = build_model(cfg, device=resolve_device(args.device),
                        kernels="torch" if args.kernels == "cuda"
                        else args.kernels)
    logical, samples, seq = 8, 8, args.seq_len

    corpus, dom = make_token_dataset(
        vocab_size=min(cfg.vocab_size, 512), num_domains=logical,
        docs_per_domain=48, seq_len=seq)
    client_idx = [np.where(dom == c % logical)[0] for c in range(logical)]
    data = stack_lm_clients(corpus, client_idx, samples, seq, seed=0)

    config = fl.ServerConfig(num_clients=logical, participation=0.5,
                             eps=0.8, seed=0)
    local = fl.LocalSpec(lr=0.05, momentum=0.5, epochs=1, batch_size=4)
    params = {k: v.detach() for k, v in model.params().items()}
    return cfg, model, data, config, local, params


def build_server(args, setup, *, engine, runtime=None):
    cfg, model, data, config, local, params = setup
    aggregator = (fl.FusedAverageAggregator("cuda") if args.kernels == "cuda"
                  else None)
    return fl.build("fedentropy", lm_window_apply(model, cfg), params,
                    data, config, local, selector="pools-traced",
                    strategy="lmstep", aggregator=aggregator,
                    engine=engine, runtime=runtime, device=model.device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--rounds-per-scan", type=int, default=4)
    ap.add_argument("--params-mode", default="remat",
                    choices=["stack", "remat"])
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--kernels", default="torch",
                    choices=["torch", "blockwise", "cuda"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--verify", action="store_true",
                    help="also run the sequential Server and assert "
                         "histories match record-for-record")
    return ap


def main(argv=None):
    """Runs the scan engine (and with ``--verify`` the sequential
    server); returns the scan server."""
    args = parser().parse_args(argv)
    setup = build_setup(args)
    server = build_server(
        args, setup, engine="scan",
        runtime=fl.ScanConfig(rounds_per_scan=args.rounds_per_scan,
                              params_mode=args.params_mode))
    R = server.scan_rounds()
    assert R == args.rounds_per_scan, (
        f"scan fell back to sequential rounds: {server.fallback_reasons}")
    ys_bytes = server.stacked_ys_nbytes(R)
    print(f"scan: R={R} params_mode={args.params_mode} "
          f"stacked-ys={ys_bytes}B "
          f"({sorted(server.block_ys_shapes(R))} stacked)")

    t0 = time.time()
    for it in range(args.rounds):
        rec = server.round()
        print(f"round {it}: positives={len(rec['positive'])}/"
              f"{len(rec['selected'])} entropy={rec['entropy']:.3f} "
              f"spec={'hit' if rec['spec_hit'] else 'miss'}")
    dt = time.time() - t0
    s = server.stats()
    print(f"done: {args.rounds} rounds in {dt:.1f}s "
          f"({dt / args.rounds:.2f}s/round); blocks={s['blocks']} "
          f"mismatch_rounds={s['mismatch_rounds']} "
          f"selector={s['selector']}")

    if args.verify:
        seq_server = build_server(args, setup, engine="sequential")
        for _ in range(args.rounds):
            seq_server.round()
        for a, b in zip(server.history, seq_server.history):
            for k in ("round", "selected", "positive", "negative",
                      "entropy"):
                assert a[k] == b[k], (a, b)
        assert all(torch.equal(server.global_params[k],
                               seq_server.global_params[k])
                   for k in seq_server.global_params)
        print(f"verify: {args.rounds} scan rounds == sequential Server "
              "(histories and params bit-for-bit)")
    return server


if __name__ == "__main__":
    main()
