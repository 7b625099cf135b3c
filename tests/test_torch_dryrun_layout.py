"""The mesh step's per-device layout (ROADMAP F14), the dry-run's op log
(``--save-hlo``) and the one-rank mesh step, on the CPU.

* The sharded dry-run of reduced qwen3-0.6b's train_4k (4 query heads, 2
  kv heads, a padded vocabulary of 512) on a (2, 4) ``("data",
  "model")`` mesh, where "model" divides the query heads and not the kv
  heads: the reference's ``run_combo(..., mesh=...)`` in a subprocess on
  8 forced host devices, once per module; the port's on 8 ``"fake"``
  ranks with its op log. Per-device arguments equal to the byte; no
  all-gather in the port's log outputs as much as the per-rank batch's
  whole-vocabulary logits; no attention score tensor holds more than
  the rank's own query heads (one) and batch rows. Both peaks are
  printed: a bound on the peak holds only at full width
  (``tests/torch_dryrun_gap.py --full``), where eager overheads do not
  dominate.
* The op log's columns sum to the record's FLOPs, bytes and collective
  bytes and its live column peaks at ``peak_bytes``, from ``run_combo``
  and from ``dryrun.main --save-hlo``.
* On a process group of one ``gloo`` rank, the (1, 1) mesh: the
  vocab-parallel softmax and log-softmax bit for bit ``torch.softmax``
  and ``torch.log_softmax``; the gradient step and the microbatched step
  under ``use_mesh`` bit for bit their plain runs (``chip_smoke.py``'s
  phase 23 holds the same on the card).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \\
        tests/test_torch_dryrun_layout.py -s
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import csv
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import LOG_COLUMNS
from repro_torch.launch.mesh import world_mesh

ARCH, SHAPE = "qwen3-0.6b", "train_4k"
MESH = (2, 4)
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir,
                                   "src"))

# the reference's sharded dry-run on a (2, 4) mesh of Auto axes (the
# installed JAX makes Explicit ones, whose with_sharding_constraint the
# reference's shard_act cannot call)
_JAX = r"""
import json, sys
import repro.launch.dryrun as d          # forces 512 host devices
import jax
import numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import ARCHS

arch, shape, a, b = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
d.ARCHS = {arch: ARCHS[arch].reduced()}
mesh = Mesh(np.array(jax.devices()[:a * b]).reshape(a, b),
            ("data", "model"), axis_types=(AxisType.Auto,) * 2)
rec = d.run_combo(arch, shape, mesh=mesh)
assert rec["status"] == "ok", rec
print(json.dumps({k: rec[k] for k in ("memory_analysis",
                                      "hlo_flops_per_device")}))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _JAX, ARCH, SHAPE,
                          *map(str, MESH)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _rows(path) -> list[dict]:
    with open(path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("layout") / "ops.tsv"
    with dryrun.fake_world(math.prod(MESH)):
        rec = dryrun.run_combo(ARCH, SHAPE, reduced=True,
                               mesh=world_mesh(MESH, ("data", "model")),
                               save_hlo=str(path))
    assert rec["status"] == "ok", rec
    return rec, _rows(path)


def _shapes(row: dict) -> list[tuple]:
    return [tuple(int(n) for n in s.split("x")) if s else ()
            for s in row["out_shapes"].split(";")]


def test_arguments_equal_reference(reference, port):
    rec, _ = port
    want = reference["memory_analysis"]
    got = rec["memory_analysis"]
    print(f"\nper device: arguments {got['argument_size_in_bytes']} B "
          f"(reference {want['argument_size_in_bytes']}); peak above them "
          f"{got['temp_size_in_bytes'] / 2**30:.3f} GiB (reference "
          f"{want['temp_size_in_bytes'] / 2**30:.3f}); product FLOPs "
          f"{rec['hlo_flops_per_device']:.6e} (reference "
          f"{reference['hlo_flops_per_device']:.6e})")
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"]


def test_no_gather_of_whole_vocab_logits(port):
    """The LM head's FSDP product and the vocab-parallel softmax keep
    the logits and their gradient split: no all-gather outputs the
    per-rank batch's whole-vocabulary logits or more."""
    _, rows = port
    cfg, shape = ARCHS[ARCH].reduced(), dryrun.SHAPES[SHAPE]
    logits = shape.global_batch // MESH[0] * shape.seq_len * \
        cfg.padded_vocab
    gathers = [r for r in rows if r["collective"] == "all-gather"]
    assert gathers
    worst = max(math.prod(s) for r in gathers for s in _shapes(r))
    assert worst < logits, worst


def test_scores_hold_only_the_rank_query_heads(port):
    """Attention split over the 4 query heads on "model" (4) with the 2
    kv heads replicated: every (..., S, T) score tensor holds one query
    head and the rank's batch rows."""
    _, rows = port
    cfg, shape = ARCHS[ARCH].reduced(), dryrun.SHAPES[SHAPE]
    s = shape.seq_len
    rows_a_rank = shape.global_batch // MESH[0]
    scores = {sh for r in rows for sh in _shapes(r)
              if len(sh) >= 4 and sh[-2:] == (s, s)}
    assert scores
    heads = cfg.num_heads // MESH[1]
    for sh in scores:
        assert sh[0] <= rows_a_rank and math.prod(sh[1:-2]) <= heads, sh


def _hold_log(rec: dict, rows: list[dict]) -> None:
    assert rows[0]["op"] == "<arguments>"
    assert sum(int(r["flops"]) for r in rows) == rec["hlo_flops_per_device"]
    assert sum(int(r["hbm_bytes"]) for r in rows) == \
        rec["hlo_hbm_bytes_per_device"]
    assert sum(int(r["collective_bytes"]) for r in rows) == \
        rec["collective_bytes_total"]
    assert max(int(r["live_bytes"]) for r in rows) == rec["peak_bytes"]


def test_op_log_sums_equal_the_record(port):
    rec, rows = port
    assert rec["collective_bytes_total"] > 0
    _hold_log(rec, rows)


def test_save_hlo_writes_one_log_a_combination(tmp_path):
    out = tmp_path / "records.json"
    dryrun.main(["--arch", ARCH, "--shape", SHAPE, "--reduced",
                 "--save-hlo", str(tmp_path / "logs"), "--out", str(out)])
    rec, = json.loads(out.read_text())
    path = tmp_path / "logs" / f"{ARCH}_{SHAPE}.ops.tsv"
    assert os.listdir(tmp_path / "logs") == [path.name]
    with open(path) as f:
        assert f.readline().rstrip("\n").split("\t") == list(LOG_COLUMNS)
    _hold_log(rec, _rows(path))


# ------------------------------------------------------ one gloo rank

@pytest.fixture
def one_rank(tmp_path):
    """A process group of one gloo rank and its (1, 1) mesh."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield world_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_vocab_softmax_bit_for_bit_on_one_rank(one_rank):
    from repro_torch.sharding import vocab
    from repro_torch.sharding.ctx import current, use_mesh
    from repro_torch.sharding.specs import distribute_full
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 5, 512)).astype(np.float32) * 3)
    with use_mesh(one_rank):
        xd = distribute_full(x, one_rank, current().placements(
            ("batch", "seq", "vocab"), x.shape))
        assert torch.equal(vocab.softmax(xd).to_local(),
                           torch.softmax(x, dim=-1))
        assert torch.equal(vocab.log_softmax(xd).to_local(),
                           torch.log_softmax(x, dim=-1))


def _steps(model, step_of, batch, mesh=None, steps=2):
    """Two steps of ``step_of(model)`` on ``batch``: plain, or under
    ``use_mesh(mesh)`` with the params laid out replicated (phase 23's
    layout); (metrics, params) as plain tensors."""
    from repro_torch.core.distributed import lay_out_params
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.optim import sgd
    opt = sgd(lr=0.1, momentum=0.5)
    step = step_of(model, opt)
    params = {k: v.detach().clone() for k, v in model.params().items()}
    mets = []
    if mesh is None:
        state = opt.init(params)
        for _ in range(steps):
            params, state, met = step(params, state, batch)
            mets.append(met)
        return mets, params
    with use_mesh(mesh):
        params = lay_out_params(params, mesh)
        state = opt.init(params)
        for _ in range(steps):
            params, state, met = step(params, state, batch)
            mets.append(met)
    return mets, {k: v.full_tensor() for k, v in params.items()}


@pytest.mark.parametrize("micro", [0, 2])
def test_mesh_step_on_one_rank_bit_for_bit(one_rank, micro):
    """The gradient step (``micro`` 0) and the microbatched step (2
    microbatches) on the (1, 1) mesh of one rank, params replicated:
    every metric and param bit for bit the plain run's."""
    from repro_torch.core import distributed as tdist
    from repro_torch.launch.train import build_fl_corpus
    from repro_torch.models.api import build_model
    cfg = ARCHS[ARCH].reduced()
    model = build_model(cfg, device="cpu", kernels="torch", seed=0)
    corpus, idx = build_fl_corpus(cfg, 4, "case1", 16, 0)
    toks = torch.from_numpy(np.concatenate([corpus[idx[c][:2]]
                                            for c in range(4)]))
    fed = tdist.FedSpec(num_clients=4)

    def step_of(model, opt):
        if micro:
            return tdist.make_microbatched_train_step(model, opt, fed, micro)
        return tdist.make_train_step(model, opt, fed)

    plain = _steps(model, step_of, {"tokens": toks})
    mesh = _steps(model, step_of, {"tokens": toks}, one_rank)
    for a, b in zip(plain[0], mesh[0]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k, v in plain[1].items():
        assert torch.equal(v, mesh[1][k]), k
