"""FL training entry point over the ``repro_torch.fl`` registry — the port of
``repro.launch.train``, on one card.

Two execution paths, one composition API:

* ``--engine mesh`` (default): the gradient-level FedEntropy round
  (``core/distributed.py``): one train step a round, the judge run inside
  it on the round's full-vocabulary soft labels (``--judge-backend
  cuda``: one launch of K1's loop a step), the selector feeding the
  step's client slots, on one card: ``--mesh`` takes only ``host`` (the
  gradient-level mesh step over several cards is not ported).
* ``--engine sequential | pipelined | async | scan``: the weights-level
  ``repro_torch.fl`` server (paper Alg. 2 with E local epochs) over the
  same token corpus, built with ``fl.build(..., engine=...)``;
  ``pipelined`` with ``--speculate`` speculates each verdict on the card
  (``--judge-backend cuda``: K1's loop), ``async`` streams updates under
  a simulated arrival clock, ``scan`` runs blocks of rounds as one CUDA
  graph. ``--judge-backend`` picks the device judge only, as the
  reference's flag does; the aggregator is the composition's. The
  pipelined and async engines shard the client axis over every visible
  card under their ``shard="auto"`` default when more than one is
  visible, as the reference's do (``fl.runtime.sharding``).

The model trains on the ``"torch"`` kernel route (the reference trains on
its default ``"xla"`` route), or with ``--attn blockwise`` (dryrun's
flag) on the ``"blockwise"`` route, which takes attention over more than
512 keys in key blocks recomputed in the backward: the hand-written
attention and SSD kernels have no backward. ``--remat`` sets
``cfg.remat`` (default the config's: ``"full"`` but at ``--reduced``;
the reference's ``main`` sets ``"none"``, which changes the memory and
not the numbers). ``--layers`` cuts the depth (an encdec model's encoder
and decoder both), to fit a card. The mesh step donates its params and
optimizer state, as the reference's jit does. Weights are random from
``--seed``, in float32. The run goes to the card unless ``--device
cpu``; ``run_*`` return their records (one dict a step or round) as
well as printing them. Example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --steps 3 --clients 4 --logical-clients 8 --seq-len 32 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 3 --clients 8 --judge-backend cuda
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch whisper-large-v3 --steps 3 --per-client-batch 1 \\
      --attn blockwise --judge-backend cuda
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import fl
from ..checkpoint import save
from ..configs import ARCHS
from ..core.distributed import FedSpec, make_train_step
from ..data.synthetic import make_token_dataset
from ..device import resolve_device
from ..models.api import build_model
from ..optim import adamw, sgd


def build_fl_corpus(cfg, num_clients: int, case: str, seq_len: int,
                    seed: int = 0):
    """Domain-skewed token corpus partitioned into logical FL clients:
    (tokens (docs, seq_len + 1) int32, per-client row indices)."""
    num_domains = max(4, num_clients // 2)
    x, dom = make_token_dataset(
        vocab_size=min(cfg.vocab_size, 2048),
        num_domains=num_domains,
        docs_per_domain=max(64, 8 * num_clients),
        seq_len=seq_len, seed=seed)
    rng = np.random.default_rng(seed)
    clients: list[np.ndarray] = []
    if case == "case1":          # one domain per client
        for i in range(num_clients):
            idx = np.where(dom == i % num_domains)[0]
            clients.append(rng.permutation(idx))
    elif case == "case2":        # two domains per client
        for i in range(num_clients):
            a, b = i % num_domains, (i + 1) % num_domains
            idx = np.where((dom == a) | (dom == b))[0]
            clients.append(rng.permutation(idx))
    else:                         # dirichlet over domains
        props = rng.dirichlet(np.full(num_domains, 0.3), size=num_clients)
        for i in range(num_clients):
            ds = rng.choice(num_domains, size=256, p=props[i])
            idx = np.concatenate([
                rng.choice(np.where(dom == d0)[0], 1) for d0 in ds])
            clients.append(idx)
    return x, clients


def _components(args, *, host_oracle: bool):
    """The selector and judge axes from the ``repro_torch.fl`` registry.

    ``host_oracle=True`` (server engines) keeps the round's judge on the
    float64 numpy oracle, the verdict of record; ``--judge-backend`` then
    only picks the device judge of speculation."""
    sel_cls = fl.get("selector", args.selector)
    config = fl.ServerConfig(num_clients=args.logical_clients,
                             participation=args.clients /
                             max(args.logical_clients, 1),
                             eps=args.eps, seed=args.seed,
                             group_size=args.group_size,
                             num_clusters=args.num_clusters)
    selector = sel_cls.from_config(config=config, local=None)
    if args.judge == "maxent":
        judge = fl.MaxEntropyJudge(
            backend="numpy" if host_oracle else args.judge_backend)
    else:
        judge = fl.get("judge", args.judge)()
    return config, selector, judge


_EXTRAS = {"vlm": ("patches", "num_patches"),
           "encdec": ("frames", "encoder_seq")}


def stub_frontend(cfg, kind: str, seed: int, device):
    """What the vlm and encdec families' stubbed frontend gives every row
    of a training batch: ``"zeros"`` (None: the reference's training
    adapters), or ``"random"``, one (num_patches or encoder_seq, d_model)
    float32 draw of N(0, 1) from ``seed`` on ``device``, the same for
    every row. Zero patches stay exactly 0 through every layer, where each
    RMSNorm's Jacobian is 1/sqrt(eps): at internvl2-1b's 24 layers the
    gradient overflows to inf and NaN, in the reference too (ROADMAP queue
    3); whisper's frames get sinusoids added and are not 0."""
    if kind == "zeros" or cfg.family not in _EXTRAS:
        return None
    rows = getattr(cfg, _EXTRAS[cfg.family][1])
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((rows, cfg.d_model), generator=gen, device=device)


def batch_extras(cfg, b: int, device, stub=None) -> dict:
    """The inputs a family's stubbed frontend takes beside a batch of
    ``b`` token rows: ``patches`` (b, num_patches, d_model) for vlm,
    ``frames`` (b, encoder_seq, d_model) for encdec, none otherwise;
    zeros, or ``stub`` (:func:`stub_frontend`) in every row."""
    if cfg.family not in _EXTRAS:
        return {}
    name, rows = _EXTRAS[cfg.family]
    if stub is None:
        return {name: torch.zeros((b, getattr(cfg, rows), cfg.d_model),
                                  device=device)}
    return {name: stub.to(device).expand(b, -1, -1)}


def lm_window_apply(model, cfg, stub=None):
    """Adapter: (params, x (B, L+1) tokens) -> ((B, L, V) next-token
    logits for targets ``x[:, 1:]``, feats): the full-window LM contract
    :class:`repro_torch.fl.LMWindowStrategy` (``--lm-objective window``)
    consumes. Every position trains; the soft label is the weighted mean
    next-token distribution over all positions. The vlm and encdec
    families see zero patches or frames, or ``stub``."""
    def apply_fn(params, x):
        batch = {"tokens": x[:, :-1],
                 **batch_extras(cfg, x.shape[0], x.device, stub)}
        logits, _ = model.apply(params, batch)
        logits = logits.to(torch.float32)
        return logits, logits[:, -1, :]
    return apply_fn


def lm_client_apply(model, cfg, stub=None):
    """Adapter: (params, x (B, L+1) tokens) -> (next-token logits at the
    last position, feats), so the classification client rule drives an
    LM: each window is a sample, its final token the label, the soft label
    the mean next-token distribution. The vlm and encdec families see zero
    patches or frames, or ``stub``."""
    def apply_fn(params, x):
        batch = {"tokens": x[:, :-1],
                 **batch_extras(cfg, x.shape[0], x.device, stub)}
        logits, _ = model.apply(params, batch)
        last = logits[:, -1, :].to(torch.float32)
        return last, last
    return apply_fn


def stack_lm_clients(corpus, client_idx, samples: int, seq_len: int,
                     seed: int) -> dict:
    """(N, S, L+1) int32 token windows, (N, S) int32 final-token labels
    and (N, S) float32 weights, as numpy, for the fl server."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for rows in client_idx:
        take = rng.choice(rows, samples)
        win = corpus[take, : seq_len + 1]
        xs.append(win)
        ys.append(win[:, -1])
    return {
        "x": np.stack(xs).astype(np.int32),
        "y": np.stack(ys).astype(np.int32),
        "w": np.ones((len(client_idx), samples), np.float32),
    }


def build_drift_events(args, config, corpus, client_idx) -> list:
    """One label-drift event at ``--drift-at``: half the clients (seeded
    choice) re-sample their windows from their ring neighbour's domain
    rows with a fresh draw stream."""
    n = config.num_clients
    rng = np.random.default_rng(args.seed)
    k = max(1, n // 2)
    drifting = sorted(int(c) for c in
                      rng.choice(n, size=k, replace=False))
    rotated = [client_idx[(c + 1) % n] for c in drifting]
    new = stack_lm_clients(corpus, rotated, args.samples_per_client,
                           args.seq_len, args.seed + 1)
    return [fl.DriftEvent(round=args.drift_at, clients=tuple(drifting),
                          data=new)]


def _init_params(model) -> dict:
    return {k: v.detach() for k, v in model.params().items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_server_engine(args, cfg, model, corpus, client_idx) -> list:
    """Weights-level rounds through ``fl.build``; returns the round
    records (``[]`` under ``--dryrun``)."""
    config, selector, judge = _components(args, host_oracle=True)
    data = stack_lm_clients(corpus, client_idx, args.samples_per_client,
                            args.seq_len, args.seed)
    drift = (build_drift_events(args, config, corpus, client_idx)
             if args.drift_at >= 0 else None)
    if args.engine == "async":
        if args.speculate:
            raise SystemExit(
                "--speculate is a pipelined-engine knob: the async engine "
                "has no round barrier to overlap the oracle with")
        runtime = fl.AsyncConfig(
            buffer_size=args.buffer_size,
            staleness_alpha=args.staleness_alpha,
            clock=args.clock, seed=args.seed)
    elif args.engine == "scan":
        if args.speculate:
            raise SystemExit(
                "--speculate is a pipelined-engine knob: the scan engine "
                "speculates every in-scan verdict already (the float64 "
                "oracle replays each R-round block)")
        runtime = fl.ScanConfig(rounds_per_scan=args.rounds_per_scan,
                                spec_backend=args.judge_backend,
                                params_mode=args.params_mode)
    else:
        runtime = fl.RuntimeConfig(speculate=args.speculate,
                                   spec_backend=args.judge_backend)
    if args.method:
        # a named composition resolves its own selector and judge axes;
        # refuse explicit axis flags rather than silently dropping them
        if args.selector != "pools" or args.judge != "maxent":
            raise SystemExit(
                f"--method {args.method} names a full composition; drop "
                "--selector/--judge (compose axes via the legacy flags "
                "without --method instead)")
        composition, selector, judge = args.method, None, None
    else:
        composition = "fedavg" if args.no_fedentropy else "fedentropy"
        if args.no_fedentropy:
            judge = None
    window = args.lm_objective == "window"
    if window and args.method:
        raise SystemExit(
            f"--lm-objective window swaps the client strategy for lmstep; "
            f"--method {args.method} composes its own strategy axis — "
            "drop one of the two")
    if args.num_clusters > 1 and window:
        raise SystemExit(
            "--num-clusters > 1 runs the plain vmapped ClientUpdate "
            "(per-client bank centers); --lm-objective window swaps in "
            "the lmstep strategy's own client fn — drop one of the two")
    apply_fn = (lm_window_apply if window else lm_client_apply)(
        model, cfg, stub_frontend(cfg, args.extras, args.seed, model.device))
    server = fl.build(
        composition, apply_fn, _init_params(model), data, config,
        fl.LocalSpec(epochs=args.local_epochs, lr=args.lr,
                     batch_size=args.per_client_batch),
        selector=selector, strategy="lmstep" if window else None,
        judge=judge,
        cluster=args.cluster_assign if args.num_clusters > 1 else None,
        drift=drift, engine=args.engine, runtime=runtime,
        data_plane=args.data_plane, device=model.device)
    if args.dryrun:
        rep = server.corpus.memory_report()
        m = max(1, int(round(config.num_clients * config.participation)))
        print(f"dryrun: engine={args.engine} data_plane={rep['plane']}")
        print(f"  host-mapped bytes:     {rep['host_mapped_bytes']}"
              f" (mmap={rep['host_is_mmap']})")
        print(f"  device-resident bytes: {rep['device_resident_bytes']}")
        print(f"  staging bytes:         {rep['staging_nbytes']}")
        print(f"  clients: N={rep['num_clients']} cohort |S_t|={m} "
              f"(~{server.corpus.cohort_nbytes(m)}B/round host-slice "
              "equivalent)")
        return []
    records = []
    _sync(model.device)
    t0 = time.perf_counter()
    for it in range(args.steps):
        rec = server.round()
        records.append(rec)
        extra = ""
        if "spec_hit" in rec:
            extra = (f" spec={'hit' if rec['spec_hit'] else 'miss'}"
                     f"{' redispatched' if rec['redispatched'] else ''}")
        if "staleness" in rec:
            extra = (f" t={rec['flush_time']:.2f}"
                     f" stale_max={max(rec['staleness'])}"
                     f" buf={rec['buffer_occupancy']}")
        if "cluster" in rec:
            occ = np.bincount(np.asarray(rec["cluster"]),
                              minlength=args.num_clusters)
            extra += f" clusters={'/'.join(str(int(c)) for c in occ)}"
        if "drift" in rec:
            extra += f" drift={sum(len(c) for c in rec['drift'])}cl"
        print(f"round {it:4d} pos={len(rec['positive'])}/"
              f"{len(rec['selected'])} ent={rec['entropy']:.4f}"
              f" comm={rec['comm']['total_bytes']}B{extra}", flush=True)
    _sync(model.device)
    dt = time.perf_counter() - t0
    # the SERVER's selector: a speculative hit adopts a copy
    stats = server.selector.stats()
    print(f"done: {args.steps} rounds in {dt:.1f}s "
          f"({dt / max(args.steps, 1):.2f}s/round); selector={stats}")
    if args.ckpt_dir:
        path = save(args.ckpt_dir, args.steps, server.global_params,
                    meta={"arch": cfg.name, "engine": args.engine,
                          "selector": stats})
        print("checkpoint:", path)
    return records


def run_mesh_engine(args, cfg, model, corpus, client_idx,
                    judge_fn=None) -> list:
    """Gradient-level rounds: one train step a round, the judge inside
    it. Returns one record a step: the cohort, its verdict, the step's
    metrics (read back in one copy) and its host seconds (to that read).
    ``judge_fn`` stands in for the ``--judge`` axis's traced judge (a
    caller's wrapper that records or checks the verdicts)."""
    _, selector, judge = _components(args, host_oracle=False)
    m = args.clients
    fed = FedSpec(num_clients=m, enabled=not args.no_fedentropy)
    opt = (sgd(lr=args.lr, momentum=0.5) if args.optimizer == "sgd"
           else adamw(lr=args.lr))
    step = make_train_step(model, opt, fed,
                           judge_fn=judge_fn or judge.traced(), donate=True)
    params = _init_params(model)
    opt_state = opt.init(params)
    stub = stub_frontend(cfg, args.extras, args.seed, model.device)
    rng = np.random.default_rng(args.seed)
    records = []
    _sync(model.device)
    t0 = time.perf_counter()
    for it in range(args.steps):
        t_step = time.perf_counter()
        sel = selector.select(m)                    # logical clients
        rows = []
        for c in sel:
            take = rng.choice(client_idx[c], args.per_client_batch)
            rows.append(corpus[take, : args.seq_len + 1])
        tokens = torch.from_numpy(np.concatenate(rows)).to(model.device)
        batch = {"tokens": tokens,
                 **batch_extras(cfg, tokens.shape[0], model.device, stub)}
        params, opt_state, metrics = step(params, opt_state, batch)
        host = torch.cat([metrics["mask"].reshape(-1)] + [
            metrics[k].reshape(1).to(torch.float32) for k in (
                "loss", "num_positive", "entropy", "grad_norm",
                "aux_loss")]).cpu()
        seconds = time.perf_counter() - t_step
        mask = host[:m].numpy()
        loss, npos, ent, gnorm, aux = host[m:].tolist()
        pos = [sel[i] for i in range(m) if mask[i] > 0]
        neg = [sel[i] for i in range(m) if mask[i] == 0]
        selector.update(pos, neg)
        records.append({"step": it, "selected": list(sel), "positive": pos,
                        "negative": neg, "mask": mask.tolist(),
                        "loss": loss, "num_positive": int(npos),
                        "entropy": ent, "grad_norm": gnorm,
                        "aux_loss": aux, "seconds": seconds})
        print(f"step {it:4d} loss={loss:.4f} pos={int(npos)}/{m} "
              f"ent={ent:.4f} gnorm={gnorm:.3f}", flush=True)
    _sync(model.device)
    dt = time.perf_counter() - t0
    print(f"done: {args.steps} rounds in {dt:.1f}s "
          f"({dt / max(args.steps, 1):.2f}s/round); "
          f"selector={selector.stats()}")
    if args.ckpt_dir:
        path = save(args.ckpt_dir, args.steps, params,
                    meta={"arch": cfg.name, "selector": selector.stats()})
        print("checkpoint:", path)
    return records


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--clients", type=int, default=8,
                    help="client slots per round (M = |S_t|)")
    ap.add_argument("--logical-clients", type=int, default=32,
                    help="logical FL population feeding the slots")
    ap.add_argument("--case", default="case1",
                    choices=["case1", "case2", "case3"])
    ap.add_argument("--per-client-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--no-fedentropy", action="store_true")
    ap.add_argument("--method", default="",
                    choices=["", "fedentropy", "fedavg", "fedcat",
                             "fedcat+maxent", "fedentropy+queue", "ifca",
                             "ifca+maxent", "fesem"],
                    help="named repro_torch.fl composition (server "
                         "engines)")
    ap.add_argument("--num-clusters", type=int, default=1,
                    help="K ModelBank centers (server engines); 1 keeps "
                         "the single global model")
    ap.add_argument("--cluster-assign", default="ifca",
                    choices=["ifca", "fesem"],
                    help="cluster assigner when --num-clusters > 1")
    ap.add_argument("--drift-at", type=int, default=-1,
                    help="re-partition half the clients' local data at "
                         "this round (server engines); -1 disables")
    ap.add_argument("--group-size", type=int, default=2,
                    help="FedCAT chain length (fedcat compositions)")
    ap.add_argument("--engine", default="mesh",
                    choices=["mesh", "sequential", "pipelined", "async",
                             "scan"],
                    help="mesh = the gradient-level step; sequential/"
                         "pipelined/async/scan = weights-level "
                         "repro_torch.fl engines")
    ap.add_argument("--rounds-per-scan", type=int, default=4,
                    help="scan engine: rounds a block (needs --selector "
                         "uniform or pools-traced to fold > 1)")
    ap.add_argument("--params-mode", default="stack",
                    choices=["stack", "remat"],
                    help="scan engine rewind points")
    ap.add_argument("--lm-objective", default="last-token",
                    choices=["last-token", "window"],
                    help="server engines: last-token treats each window "
                         "as a classification sample; window trains every "
                         "next-token position (the lmstep strategy)")
    ap.add_argument("--buffer-size", type=int, default=0,
                    help="async engine: screened arrivals per flush "
                         "(0 = cohort size)")
    ap.add_argument("--staleness-alpha", type=float, default=0.0,
                    help="async engine: (1+tau)^-alpha damping (0 = off)")
    ap.add_argument("--clock", default="zero",
                    choices=["zero", "uniform", "straggler"],
                    help="async engine: simulated arrival latency model")
    ap.add_argument("--selector", default="pools",
                    choices=["pools", "pools-traced", "uniform", "queue"],
                    help="repro_torch.fl Selector driving admission")
    ap.add_argument("--judge", default="maxent", choices=["maxent", "none"],
                    help="repro_torch.fl Judge axis (both engines)")
    ap.add_argument("--judge-backend", default="torch",
                    choices=["torch", "cuda"],
                    help="device judge (mesh step, speculation): torch = "
                         "the plain float32 loop, cuda = K1's loop")
    ap.add_argument("--speculate", action="store_true",
                    help="pipelined engine: overlap oracle judgment with "
                         "the next round's client compute")
    ap.add_argument("--data-plane", default="auto",
                    choices=["resident", "streaming", "auto"],
                    help="server engines: where client data lives")
    ap.add_argument("--dryrun", action="store_true",
                    help="server engines: build the server, print the "
                         "data-plane memory report, and exit")
    ap.add_argument("--local-epochs", type=int, default=1,
                    help="E local epochs (server engines)")
    ap.add_argument("--samples-per-client", type=int, default=16,
                    help="local dataset size per client (server engines)")
    ap.add_argument("--eps", type=float, default=0.8)
    ap.add_argument("--attn", default="torch",
                    choices=["torch", "blockwise"],
                    help="the model's kernel route: torch (plain "
                         "attention) or blockwise (over 512 keys, key "
                         "blocks recomputed in the backward)")
    ap.add_argument("--remat", default=None,
                    choices=["none", "full", "dots"],
                    help="cfg.remat (default: the config's)")
    ap.add_argument("--extras", default="zeros",
                    choices=["zeros", "random"],
                    help="the vlm and encdec families' stubbed frontend: "
                         "zero patches or frames (the reference's), or one "
                         "random draw from --seed in every row")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (encdec: "
                         "encoder and decoder each); 0 keeps the "
                         "config's depth")
    ap.add_argument("--mesh", default="host",
                    help="the mesh of the gradient-level step: host (the "
                         "one card) is the only one ported")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def train_config(args):
    """The config ``main`` trains: ``--arch`` (``--reduced``), in
    float32, with ``--remat`` and ``--layers`` applied."""
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(param_dtype="float32", dtype="float32")
    if args.remat is not None:
        cfg = cfg.replace(remat=args.remat)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers, **(
            {"num_encoder_layers": args.layers}
            if cfg.family == "encdec" else {}))
    return cfg


def main(argv=None) -> list:
    """Runs the training; returns the step or round records."""
    args = parser().parse_args(argv)
    if args.mesh != "host":
        raise SystemExit(
            f"--mesh {args.mesh}: the gradient-level step runs on one "
            "card, only the host mesh is ported; the step over several "
            "cards waits for "
            "ROADMAP queue 1, \"the gradient-level mesh step over several "
            "cards\" (the weights-level engines shard the client axis: "
            "--engine pipelined or async)")
    cfg = train_config(args)
    device = resolve_device(args.device)
    model = build_model(cfg, device=device, kernels=args.attn,
                        seed=args.seed)

    corpus, client_idx = build_fl_corpus(
        cfg, args.logical_clients, args.case, args.seq_len, args.seed)
    if args.engine != "mesh":
        return run_server_engine(args, cfg, model, corpus, client_idx)
    if args.data_plane != "auto" or args.dryrun:
        # the step takes token batches straight from the corpus: there is
        # no corpus object to place on a plane or to report memory for
        raise SystemExit(
            "--data-plane/--dryrun need a weights-level engine: use "
            "--engine sequential, pipelined, or async (the server "
            "owns the data-plane corpus)")
    if args.selector == "queue":
        # no ClientCorpus to bind entropy stats or data-queue schedules
        # to: it would silently run uniform
        raise SystemExit(
            "--selector queue needs a weights-level engine: use "
            "--engine sequential or pipelined (the server binds the "
            "corpus stats the queue selector ranks on)")
    if args.method:
        # the gradient-level step has no composition axis to honour a
        # named recipe; refusing beats silently running fedentropy
        raise SystemExit(
            f"--method {args.method} needs a weights-level engine: "
            "use --engine sequential or pipelined (the mesh engine "
            "is composed via --no-fedentropy/--selector/--judge)")
    if args.num_clusters > 1 or args.drift_at >= 0:
        # the step threads ONE model and owns no corpus object to
        # re-partition mid-run
        raise SystemExit(
            "--num-clusters/--drift-at need a weights-level engine: "
            "use --engine sequential or pipelined (the server carries "
            "the ModelBank and applies the drift schedule)")
    return run_mesh_engine(args, cfg, model, corpus, client_idx)


if __name__ == "__main__":
    main()
