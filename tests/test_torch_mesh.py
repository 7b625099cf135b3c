"""The gradient-level mesh step over several ranks
(``core.distributed.make_train_step`` under ``sharding.ctx.use_mesh``),
the expert-parallel ``moe_block_shard_map`` and ``launch.train``'s mesh
engine under a process group, on 4 (and 2) ``gloo`` ranks on the CPU,
against the live JAX reference.

One module fixture starts the ranks (``tests/_torch_mesh_worker.py``, a
``FileStore`` under ``tmp_path``, no fixed port) and, beside them, the
reference's shard_map run in a subprocess on 4 forced host devices, then
computes the reference's one-device steps while they run:

* qwen3-0.6b reduced, M = 8, 2 steps on (4, 1) with the params
  replicated and on (2, 2) laid out by ``param_logical_axes``; one step
  each of mamba2 (ssm), zamba2 (hybrid), internvl2 (vlm) and whisper
  (encdec) on (2, 2): against the reference's ``make_train_step`` on one
  device with the same weights and batch;
* qwen3-moe reduced (E = 4) on a (4,) mesh without a "model" axis
  against the reference's one-device step, and on (2, 2): the step, and
  ``moe_block_shard_map`` on its own (tokens split over the sequence,
  and replicated over "model"), against the reference's shard_map path
  on a (2, 2) JAX mesh: kept assignments exact, outputs and gradients
  within ``MOE_RTOL``;
* ``train.main --engine mesh`` on 2 ranks: rank 0 prints the one-rank
  run's lines, the masks equal;
* qwen3-0.6b reduced on (1, 4), where "model" splits the 4 query heads
  but not the 2 kv heads: 2 steps against the reference's one-device
  step; the microbatched step (2 microbatches, 2 steps) on (4, 1) and
  (2, 2) against the reference's ``make_microbatched_train_step`` on one
  device (masks exact, loss within ``MICRO_LOSS_RTOL``, params within
  ``MICRO_PARAM_ATOL``);
* ``sharding.vocab``'s softmax, log-softmax, pick and the pick's
  gradient over vocab-sharded logits on (1, 4) and (2, 2) against
  ``torch.softmax``, ``torch.log_softmax`` and plain autograd on the
  whole logits, within ``VOCAB_RTOL``;
* ``sharding.ctx.attention_on_ranks`` through ``mha_reference`` and
  ``mha_blockwise`` on (1, 4) and (2, 2), each layout of the worker's
  ``attention_layouts`` (the query heads with tensor positions, the
  sequence, the keys of a one-token query): the output and the
  gradients against the same function on plain tensors, within
  ``ATTN_RTOL``; the keys layout refuses autograd.

Masks and ``num_positive`` are exact; the entropy within 8 float32
spacings (ROADMAP F8's rule); loss, ``grad_norm`` and each parameter leaf
within ``RTOL`` relative.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_mesh.py
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.core import distributed as jdist
from repro.models.api import build_model as jax_build_model
from repro.optim import sgd as jsgd
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import train
from repro_torch.launch.train import batch_extras, build_fl_corpus

# measured on this sandbox's CPU: loss 1.4e-7, grad_norm 4.6e-7, params
# 3.3e-6 (zamba2), entropy 3 spacings; the moe block 1.7e-6
RTOL = 1e-5            # loss, grad_norm, params
ENT_SPACINGS = 8
MOE_RTOL = 1e-5        # moe block outputs and gradients, of their max
LR = 0.1
M, PER, SEQ = 8, 2, 17
MICRO = 2              # microbatches of the microbatched step
# the microbatched step against the reference's one-device one, as
# tests/test_distributed_mesh.py holds the reference's against its
# fused step
MICRO_LOSS_RTOL, MICRO_PARAM_ATOL = 1e-5, 5e-6
VOCAB_RTOL = 1e-6      # vocab-parallel softmax against torch's
VOCAB_SHAPE = (4, 5, 64)
ATTN_RTOL = 1e-5       # attention on ranks against the plain function
ATTN_LAYOUTS = ["heads", "seq", "seq_blockwise", "keys"]
FAMILIES = ["mamba2-130m", "zamba2-2.7b", "internvl2-1b",
            "whisper-large-v3"]
MOE = "qwen3-moe-235b-a22b"
ARCHS_RUN = ["qwen3-0.6b", *FAMILIES, MOE]
CASES = [
    {"name": "qwen3-4x1", "arch": "qwen3-0.6b", "mesh": [4, 1],
     "layout": "replicated", "steps": 2},
    {"name": "qwen3-2x2", "arch": "qwen3-0.6b", "mesh": [2, 2],
     "layout": "logical", "steps": 2},
    *[{"name": f"{a}-2x2", "arch": a, "mesh": [2, 2], "layout": "logical",
       "steps": 1} for a in FAMILIES],
    {"name": "moe-2x2", "arch": MOE, "mesh": [2, 2], "layout": "logical",
     "steps": 1, "moe_block": True},
    # no "model" axis: moe_block runs its single-device block, replicated
    {"name": "moe-4", "arch": MOE, "mesh": [4], "layout": "logical",
     "steps": 1},
    # "model" divides the 4 query heads and the vocabulary, not the 2 kv
    # heads: attention split over the query heads, the vocab-parallel
    # softmax, the head's FSDP product
    {"name": "qwen3-1x4", "arch": "qwen3-0.6b", "mesh": [1, 4],
     "layout": "logical", "steps": 2},
    *[{"name": f"qwen3-micro-{a}x{b}", "arch": "qwen3-0.6b",
       "mesh": [a, b], "layout": "logical", "steps": 2, "micro": MICRO}
      for a, b in ((4, 1), (2, 2))],
    {"name": "vocab", "kind": "vocab", "meshes": [[1, 4], [2, 2]]},
    {"name": "attention", "kind": "attention", "meshes": [[1, 4], [2, 2]]},
]
TRAIN_ARGV = ["--engine", "mesh", "--device", "cpu", "--reduced",
              "--steps", "3", "--clients", "4", "--logical-clients", "8",
              "--seq-len", "32"]
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir,
                                   "src"))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_mesh_worker.py")
TIMEOUT = 600

# The reference's shard_map path on a (2, 2) mesh of 4 forced host
# devices: the moe step under use_mesh, and moe_block_shard_map of layer
# 0 on each x with its kept assignments a shard (the reference's own
# routing on the shard's tokens, the capacity of the shard's count).
_JAX_MOE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import ARCHS
from repro.core import distributed as jdist
from repro.models import moe as jmoe
from repro.models.api import build_model
from repro.optim import sgd
from repro.sharding.ctx import use_mesh

out_path, in_path, lr, m = sys.argv[1], sys.argv[2], float(sys.argv[3]), \
    int(sys.argv[4])
inp = np.load(in_path)
cfg = ARCHS["qwen3-moe-235b-a22b"].reduced()
jm = build_model(cfg)
params = jm.init(jax.random.PRNGKey(0))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
res = {}
opt = sgd(lr=lr, momentum=0.5)
step = jax.jit(jdist.make_train_step(jm, opt, jdist.FedSpec(num_clients=m)))
with mesh, use_mesh(mesh):
    p, _, met = step(params, opt.init(params),
                     {"tokens": jnp.asarray(inp["tokens"])})
for k, v in met.items():
    res["step0/" + k] = np.asarray(v)
for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
    res["param/" + "/".join(str(getattr(q, "key", q)) for q in path)] = \
        np.asarray(leaf)
moe0 = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
ep = 2
for case in ("c1", "c3"):
    x, r = jnp.asarray(inp["x_" + case]), jnp.asarray(inp["r_" + case])

    def f(x, pm):
        out, aux = jmoe.moe_block_shard_map(cfg, pm, x, mesh)
        return jnp.sum(out * r) + 0.5 * aux, (out, aux)

    with mesh:
        (_, (out, aux)), (gx, gp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(x, moe0)
    res[case + "/out"], res[case + "/aux"] = np.asarray(out), np.asarray(aux)
    res[case + "/grad_x"] = np.asarray(gx)
    res[case + "/grad_router"] = np.asarray(gp["router"]["w"])
    for n in ("w_in", "w_gate", "w_out"):
        res[case + "/grad_" + n] = np.asarray(gp[n])
    b, s, d = x.shape
    kept = []
    for dr in range(2):
        for mr in range(ep):
            if s % ep == 0:
                xs = x[dr * b // 2:(dr + 1) * b // 2,
                       mr * s // ep:(mr + 1) * s // ep]
            elif (b // 2) % ep == 0:
                q = dr * ep + mr
                xs = x[q * b // 4:(q + 1) * b // 4]
            else:
                xs = x[dr * b // 2:(dr + 1) * b // 2]
            xt = xs.reshape(-1, d)
            _, top_i, _ = jmoe._route(cfg, moe0["router"]["w"], xt)
            order, _, pos, _ = jmoe._dispatch_indices(cfg, top_i)
            cap = jmoe._capacity(cfg, xt.shape[0])
            k_tok = np.zeros(pos.shape[0], bool)
            k_tok[np.asarray(order)] = np.asarray(pos) < cap
            kept.append(k_tok)
    res[case + "/kept"] = np.stack(kept)
np.savez(out_path, **res)
print("JAX-MOE-OK")
"""


def _tokens(cfg, m, per, s, seed=0):
    """Client-major (m * per, s) int32 windows, client i from domain i."""
    corpus, idx = build_fl_corpus(cfg, m, "case1", s - 1, seed)
    rng = np.random.default_rng(seed)
    return np.concatenate([corpus[rng.choice(idx[i], per)]
                           for i in range(m)]).astype(np.int32)


def _ranks(world: int, store: str, job: dict, path: str, logs: str):
    with open(path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(os.path.join(logs, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), store, path],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _join(procs, deadline: float, what: str) -> None:
    try:
        for p, log in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
            log.close()
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [p.returncode for p, _ in procs if p.returncode]
    assert not bad, f"{what} ranks exited {bad}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Runs every rank job and the reference; returns the results."""
    tmp = tmp_path_factory.mktemp("mesh")
    inputs, ref = {}, {}
    cfgs = {a: ARCHS[a].reduced() for a in ARCHS_RUN}
    jparams = {}
    for a in ARCHS_RUN:
        jm = jax_build_model(JAX_ARCHS[a].reduced())
        jparams[a] = (jm, jm.init(jax.random.PRNGKey(0)))
        for k, v in lm_params_from_numpy(
                cfgs[a], jax.tree.map(np.asarray, jparams[a][1])).items():
            inputs[f"{a}/param/{k}"] = v.numpy()
        toks = _tokens(cfgs[a], M, PER, SEQ)
        inputs[f"{a}/batch/tokens"] = toks
        for k, v in batch_extras(cfgs[a], toks.shape[0], "cpu").items():
            inputs[f"{a}/batch/{k}"] = v.numpy()
    rng = np.random.default_rng(1)
    d = cfgs[MOE].d_model
    # a direction every token shares concentrates the routing, so each
    # shard's capacity drops assignments (32 and 33 tokens a shard)
    moe_in = {f"x_{c}": (rng.standard_normal(shape) + 3 *
                         rng.standard_normal(d)).astype(np.float32)
              for c, shape in (("c1", (4, 32, d)), ("c3", (2, 33, d)))}
    for c in ("c1", "c3"):
        moe_in[f"r_{c}"] = rng.standard_normal(
            moe_in[f"x_{c}"].shape).astype(np.float32)
        inputs[f"moe/x_{c}"] = moe_in[f"x_{c}"]
        inputs[f"moe/r_{c}"] = moe_in[f"r_{c}"]
    inputs["vocab/x"] = (3 * rng.standard_normal(VOCAB_SHAPE)).astype(
        np.float32)
    inputs["vocab/t"] = rng.integers(0, VOCAB_SHAPE[-1],
                                     VOCAB_SHAPE[:2]).astype(np.int64)
    inputs["vocab/r"] = rng.standard_normal(VOCAB_SHAPE[:2]).astype(
        np.float32)
    # attention: (4, 8) queries of 4 heads of 8 against 2 kv heads; a
    # one-token query; positions per row, some kv slots empty (-1)
    for n, shape in (("q", (4, 8, 4, 8)), ("q1", (4, 1, 4, 8)),
                     ("k", (4, 8, 2, 8)), ("v", (4, 8, 2, 8)),
                     ("r", (4, 8, 4, 8))):
        inputs[f"attn/{n}"] = rng.standard_normal(shape).astype(np.float32)
    kv_pos = np.tile(np.arange(8), (4, 1))
    kv_pos[rng.random((4, 8)) < 0.25] = -1
    inputs["attn/kv_pos"] = kv_pos.astype(np.int64)
    inputs["attn/q_offset"] = rng.integers(0, 4, 4).astype(np.int64)
    inputs["attn/q1_offset"] = rng.integers(4, 8, 4).astype(np.int64)
    np.savez(tmp / "inputs.npz", **inputs)
    np.savez(tmp / "moe_in.npz", tokens=inputs[f"{MOE}/batch/tokens"],
             **moe_in)

    deadline = time.monotonic() + TIMEOUT
    (tmp / "steps").mkdir()
    (tmp / "train").mkdir()
    cases = [dict(c, lr=LR, m=M) for c in CASES]
    steps = _ranks(4, str(tmp / "steps"), {
        "kind": "steps", "inputs": str(tmp / "inputs.npz"),
        "out": str(tmp / "steps"), "cases": cases},
        str(tmp / "steps.json"), str(tmp / "steps"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               + os.environ.get("XLA_FLAGS", ""))
    jax_moe = subprocess.Popen(
        [sys.executable, "-c", _JAX_MOE, str(tmp / "jax_moe.npz"),
         str(tmp / "moe_in.npz"), str(LR), str(M)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the reference's one-device steps while the ranks run
        for c in CASES:
            if c.get("kind") or c["name"] == "moe-2x2":
                continue
            a, micro = c["arch"], c.get("micro", 0)
            if (a, c["steps"], micro) in ref:
                continue
            jm, p = jparams[a]
            opt = jsgd(lr=LR, momentum=0.5)
            fed = jdist.FedSpec(num_clients=M)
            step = jax.jit(
                jdist.make_microbatched_train_step(jm, opt, fed, micro)
                if micro else jdist.make_train_step(jm, opt, fed))
            batch = {k.split("/", 2)[2]: jnp.asarray(v)
                     for k, v in inputs.items()
                     if k.startswith(f"{a}/batch/")}
            s, mets = opt.init(p), []
            for _ in range(c["steps"]):
                p, s, met = step(p, s, batch)
                mets.append(jax.tree.map(np.asarray, met))
            ref[(a, c["steps"], micro)] = (mets,
                                           jax.tree.map(np.asarray, p))
        one_rank = train.main(TRAIN_ARGV)
        _join(steps, deadline, "step")
        trainers = _ranks(2, str(tmp / "train"), {
            "kind": "train", "argv": TRAIN_ARGV,
            "out": str(tmp / "train" / "records.json")},
            str(tmp / "train.json"), str(tmp / "train"))
        _join(trainers, deadline, "train")
        out, err = jax_moe.communicate(
            timeout=max(deadline - time.monotonic(), 1))
        assert jax_moe.returncode == 0 and "JAX-MOE-OK" in out, err[-3000:]
    finally:
        if jax_moe.poll() is None:
            jax_moe.kill()
            jax_moe.wait()
    got = {c["name"]: dict(np.load(tmp / "steps" / f"{c['name']}.npz"))
           for c in CASES}
    return {"cfgs": cfgs, "ref": ref, "got": got, "inputs": inputs,
            "jax_moe": dict(np.load(tmp / "jax_moe.npz")),
            "one_rank": one_rank,
            "ranks": json.loads((tmp / "train" /
                                 "records.json").read_text()),
            "logs": [(tmp / "train" / f"rank{r}.log").read_text()
                     for r in range(2)]}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _hold_metrics(got: dict, want: list, steps: int) -> None:
    for it in range(steps):
        w = want[it]
        np.testing.assert_array_equal(got[f"step{it}/mask"], w["mask"])
        assert int(got[f"step{it}/num_positive"]) == int(w["num_positive"])
        for key in ("entropy", "entropy_initial"):
            e = np.float32(w[key])
            assert abs(np.float32(got[f"step{it}/{key}"]) - e) <= \
                ENT_SPACINGS * np.spacing(e), key
        for key in ("loss", "grad_norm"):
            assert _rel(got[f"step{it}/{key}"], w[key]) <= RTOL, key
        assert _rel(got[f"step{it}/per_client_loss"],
                    w["per_client_loss"]) <= RTOL


def _hold_params(cfg, got: dict, want_tree) -> None:
    """Each leaf within RTOL of its own max |value|; the key projection's
    bias of a model without RoPE (whisper) gets gradient 0 in exact
    arithmetic (tests/test_torch_train.py::_check_zero_grad_leaves), so it
    is held within RTOL of the model's largest |param| instead."""
    want = lm_params_from_numpy(cfg, want_tree)
    scale = max(float(v.abs().max()) for v in want.values())
    for k, w in want.items():
        g = got[f"param/{k}"]
        if cfg.attn_bias and cfg.rope_style == "none" and \
                k.endswith("w_k.b"):
            assert np.abs(g - w.numpy()).max() <= RTOL * scale, k
        else:
            assert _rel(g, w.numpy()) <= RTOL, k


@pytest.mark.parametrize("name", ["qwen3-4x1", "qwen3-2x2", "qwen3-1x4"])
def test_qwen3_two_steps_match_reference(runs, name):
    got = runs["got"][name]
    mets, p = runs["ref"][("qwen3-0.6b", 2, 0)]
    _hold_metrics(got, mets, 2)
    assert sum(M - int(m["num_positive"]) for m in mets) > 0
    _hold_params(runs["cfgs"]["qwen3-0.6b"], got, p)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_step_on_2x2_matches_reference(runs, arch):
    got = runs["got"][f"{arch}-2x2"]
    mets, p = runs["ref"][(arch, 1, 0)]
    _hold_metrics(got, mets, 1)
    _hold_params(runs["cfgs"][arch], got, p)


def test_moe_step_on_2x2_matches_reference_shard_map(runs):
    got, want = runs["got"]["moe-2x2"], runs["jax_moe"]
    mets = [{k.split("/", 1)[1]: v for k, v in want.items()
             if k.startswith("step0/")}]
    _hold_metrics(got, mets, 1)
    assert _rel(got["step0/aux_loss"], mets[0]["aux_loss"]) <= RTOL
    tree: dict = {}
    for k, v in want.items():
        if k.startswith("param/"):
            node = tree
            *path, leaf = k.split("/")[1:]
            for q in path:
                node = node.setdefault(q, {})
            node[leaf] = v
    _hold_params(runs["cfgs"][MOE], got, tree)


def test_moe_step_without_a_model_axis_matches_reference(runs):
    """On a (4,) "data" mesh moe_block takes the single-device block on
    replicated inputs: the reference's one-device step."""
    got = runs["got"]["moe-4"]
    mets, p = runs["ref"][(MOE, 1, 0)]
    _hold_metrics(got, mets, 1)
    assert _rel(got["step0/aux_loss"], mets[0]["aux_loss"]) <= RTOL
    _hold_params(runs["cfgs"][MOE], got, p)


@pytest.mark.parametrize("name", ["qwen3-micro-4x1", "qwen3-micro-2x2"])
def test_microbatched_step_matches_reference(runs, name):
    """The microbatched step under a mesh (2 microbatches, each client's
    rows on their "data" shard, the accumulators placed like the params)
    against the reference's one-device microbatched step: masks exact,
    loss within MICRO_LOSS_RTOL, every param within MICRO_PARAM_ATOL."""
    got = runs["got"][name]
    mets, p = runs["ref"][("qwen3-0.6b", 2, MICRO)]
    for it, w in enumerate(mets):
        np.testing.assert_array_equal(got[f"step{it}/mask"], w["mask"])
        assert int(got[f"step{it}/num_positive"]) == int(w["num_positive"])
        assert _rel(got[f"step{it}/loss"], w["loss"]) <= MICRO_LOSS_RTOL
    assert sum(M - int(m["num_positive"]) for m in mets) > 0
    want = lm_params_from_numpy(runs["cfgs"]["qwen3-0.6b"], p)
    for k, w in want.items():
        np.testing.assert_allclose(got[f"param/{k}"], w.numpy(), rtol=0,
                                   atol=MICRO_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_vocab_parallel_softmax_matches_torch(runs, mesh):
    """Over logits whose vocabulary is split over "model" (4 or 2 ranks):
    softmax and log-softmax against torch's on the whole logits, the pick
    and its gradient against plain autograd, within VOCAB_RTOL of each
    one's max."""
    import torch
    got = runs["got"]["vocab"]
    assert got[f"{mesh}/vocab_ranks"].prod() > 1
    x = torch.from_numpy(runs["inputs"]["vocab/x"]).requires_grad_(True)
    t = torch.from_numpy(runs["inputs"]["vocab/t"])
    r = torch.from_numpy(runs["inputs"]["vocab/r"])
    logp = torch.log_softmax(x, dim=-1)
    picked = torch.take_along_dim(logp, t[..., None], dim=-1)[..., 0]
    grad, = torch.autograd.grad((picked * r).sum(), [x])
    want = {"softmax": torch.softmax(x, dim=-1), "log_softmax": logp,
            "pick": picked, "grad": grad}
    for key, w in want.items():
        assert _rel(got[f"{mesh}/{key}"], w.detach().numpy()) <= \
            VOCAB_RTOL, key


@pytest.mark.parametrize("case", ["c1", "c3"])
def test_moe_block_shard_map_matches_reference(runs, case):
    """Tokens split over the sequence (c1: (4, 32) tokens, 32 % 2 == 0)
    and replicated over "model" (c3: (2, 33), neither divides): each
    rank's kept assignments exact (some dropped), output, aux and every
    gradient within MOE_RTOL of its max."""
    got, want = runs["got"]["moe-2x2"], runs["jax_moe"]
    np.testing.assert_array_equal(got[f"moe/{case}/kept"],
                                  want[f"{case}/kept"])
    assert not want[f"{case}/kept"].all()
    for key in ("out", "aux", "grad_x", "grad_router", "grad_w_in",
                "grad_w_gate", "grad_w_out"):
        assert _rel(got[f"moe/{case}/{key}"], want[f"{case}/{key}"]) <= \
            MOE_RTOL, key


def test_train_main_on_two_ranks_prints_the_one_rank_lines(runs):
    one, two = runs["one_rank"], runs["ranks"]
    assert [r["mask"] for r in two] == [r["mask"] for r in one]
    assert [r["selected"] for r in two] == [r["selected"] for r in one]
    for a, b in zip(one, two):
        for key in ("loss", "grad_norm"):
            assert b[key] == pytest.approx(a[key], rel=RTOL)
    lines = [ln for ln in runs["logs"][0].splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 3 and lines[0].startswith("step    0 loss=")
    assert [int(ln.split("pos=")[1].split("/")[0]) for ln in lines] == \
        [r["num_positive"] for r in one]
    assert not any(ln.startswith(("step ", "done:"))
                   for ln in runs["logs"][1].splitlines())


def test_weights_level_engine_refuses_several_ranks(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="single controller"):
        train.main(["--engine", "sequential", "--device", "cpu",
                    "--reduced"])


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
@pytest.mark.parametrize("layout", ATTN_LAYOUTS)
def test_attention_on_ranks_matches_plain(runs, mesh, layout):
    """Attention run on each rank's block (``attention_on_ranks``)
    against the same function on the whole plain tensors: the output,
    and the gradients of sum(out * r) where the layout takes them,
    within ATTN_RTOL of each one's max; the keys layout, forward only,
    raises where autograd records."""
    import torch
    from _torch_mesh_worker import attention_layouts
    got = runs["got"]["attention"]
    a = {k.split("/", 1)[1]: torch.from_numpy(v)
         for k, v in runs["inputs"].items() if k.startswith("attn/")}
    fn, q, _, _, kw, grad = attention_layouts(a)[layout]
    key = f"{mesh}/{layout}"
    ins = [t.clone().requires_grad_(grad) for t in (q, a["k"], a["v"])]
    out = fn(*ins, causal=True, **kw)
    assert _rel(got[f"{key}/out"], out.detach().numpy()) <= ATTN_RTOL
    if not grad:
        assert bool(got[f"{key}/raises"])
        return
    grads = torch.autograd.grad((out * a["r"][:, :q.shape[1]]).sum(), ins)
    for n, g in zip("qkv", grads):
        assert _rel(got[f"{key}/grad_{n}"], g.numpy()) <= ATTN_RTOL, n
