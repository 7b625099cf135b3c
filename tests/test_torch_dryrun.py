"""The port's dry-run (``repro_torch.launch.dryrun``), its cost counter
(``launch.cost_analysis``), the meta build and ``models.api``'s
``input_specs`` / ``supported`` / ``decode_window`` / ``attn_cache_len``
against the live JAX reference, on the CPU.

* ``supported``, ``decode_window`` and ``attn_cache_len`` equal for all
  11 archs x 4 shapes; ``input_specs`` equal in shapes and dtypes for
  train and prefill, and for decode in the cache's total bytes and the
  multiset of its leaf shapes (the reference stacks a layer axis that
  the port keeps as a list);
* at full width, each arch's parameter count equal to the reference's
  ``jax.eval_shape`` count and to ``dryrun.PARAM_COUNTS`` (which
  ``chip_smoke.py`` holds the card's build to), and ``model_flops``
  equal to the reference's for all ten archs x four shapes;
* at ``reduced()`` for one arch of each family, the counter's product
  FLOPs of a prefill and of a train step within ``FLOPS_RTOL`` of the
  reference's ``analyze_hlo_text`` of the same jitted function on the
  CPU; a ``for`` loop's products counted once an iteration; the peak
  following frees;
* ``build_model(cfg, device="meta")``: no storage, the CPU build's
  parameter names and shapes, and the CPU build's bits unchanged;
* ``dryrun.main`` over every (arch x shape) at ``reduced()`` with no
  error, and the several-card flags run on the fake group.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_dryrun.py
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import collections
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import api as japi
from repro_torch.configs import ARCHS, ASSIGNED, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.models import api

FLOPS_RTOL = 0.01
# one arch of each family, at reduced()
FAMILY_ARCHS = ["qwen3-0.6b", "qwen3-moe-235b-a22b", "mamba2-130m",
                "zamba2-2.7b", "internvl2-1b", "whisper-large-v3"]
# sha256 (first 32 hex digits) of the reduced CPU build's parameters
# (names and bytes) with seed 0, as the build drew them before the meta
# build existed
CPU_DIGESTS = {
    "qwen3-0.6b": "0ca6a08e320006353218c546ed1efd2f",
    "qwen3-moe-235b-a22b": "8c3f79e2b55a7c9b93c320461e7b7769",
    "mamba2-130m": "8b7527080f714349c3efe5ff54efab74",
    "zamba2-2.7b": "3ab34191c736b289d5db6a3fcd7a47ef",
    "internvl2-1b": "13ab34e3fd3dc12fe67a7f8065ae4714",
    "whisper-large-v3": "8413908ecde6444f7fa1cf96ae2effd9",
}
# the HLO walk reads dots and while trip counts, which the CPU backend's
# LLVM optimisation level leaves as they are; level 0 compiles faster
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun``, imported with JAX's backend already up:
    its import sets ``XLA_FLAGS`` for 512 host devices, which then
    changes nothing here, and the variable is restored for the worker's
    later tests and subprocesses."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _jax_params_shape(arch: str):
    model = japi.build_model(JAX_ARCHS[arch])
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


# ------------------------------------------------------ api: scope, specs

@pytest.mark.parametrize("arch", list(ARCHS))
def test_scope_window_and_cache_len_equal_reference(arch):
    for name in SHAPES:
        cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
        shape, jshape = SHAPES[name], JAX_SHAPES[name]
        assert api.supported(cfg, shape) == japi.supported(jcfg, jshape)
        assert api.decode_window(cfg, shape) == \
            japi.decode_window(jcfg, jshape)
        assert api.attn_cache_len(cfg, shape) == \
            japi.attn_cache_len(jcfg, jshape)
    assert api.LONG_CONTEXT_WINDOW == japi.LONG_CONTEXT_WINDOW


def _dt(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _jax_cache_leaves(cache) -> list:
    """(shape, dtype) of each leaf of the reference's cache, the stacked
    layer axes split off: ``layers`` and ``attn`` stack one, ``ssm`` two
    (groups, layers a group); ``cross`` is stacked in both packages."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        top = path[0].key
        lead = {"layers": 1, "attn": 1, "ssm": 2}.get(top, 0)
        copies = int(np.prod(leaf.shape[:lead], dtype=np.int64))
        out += [(tuple(leaf.shape[lead:]), _dt(leaf.dtype))] * copies
    return out


def _port_cache_leaves(tree) -> list:
    """(shape, dtype) of each tensor of the port's cache; the index, a
    Python int, as the reference's int32 scalar."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _port_cache_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _port_cache_leaves(v)]
    if isinstance(tree, int):
        return [((), "int32")]
    assert tree.is_meta
    return [(tuple(tree.shape), _dt(tree.dtype))]


def _nbytes(leaves) -> int:
    size = {"int32": 4, "float32": 4, "bfloat16": 2}
    return sum(int(np.prod(s, dtype=np.int64)) * size[d] for s, d in leaves)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_equal_reference(arch):
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    for name in SHAPES:
        shape, jshape = SHAPES[name], JAX_SHAPES[name]
        if not api.supported(cfg, shape)[0]:
            continue
        got = api.input_specs(cfg, shape)
        want = japi.input_specs(jcfg, jshape)
        assert set(got) == set(want), name
        for k in want:
            if k == "cache":
                continue
            assert got[k].is_meta
            assert tuple(got[k].shape) == want[k].shape, (name, k)
            assert _dt(got[k].dtype) == _dt(want[k].dtype), (name, k)
        if shape.kind == "decode":
            g = _port_cache_leaves(got["cache"])
            w = _jax_cache_leaves(want["cache"])
            assert collections.Counter(g) == collections.Counter(w), name
            assert _nbytes(g) == _nbytes(w)


# ----------------------------------------- full width: counts and flops

@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_count_equals_reference(arch):
    want = sum(int(np.prod(x.shape, dtype=np.int64))
               for x in jax.tree.leaves(_jax_params_shape(arch)))
    model = api.build_model(ARCHS[arch], device="meta")
    assert want == dryrun.PARAM_COUNTS[arch] == model.num_params()


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_equal_reference(jdry, arch):
    ps = _jax_params_shape(arch)
    params = api.build_model(ARCHS[arch], device="meta").params()
    for name in SHAPES:
        assert dryrun.model_flops(ARCHS[arch], SHAPES[name], params) == \
            jdry.model_flops(JAX_ARCHS[arch], JAX_SHAPES[name], ps), name


# ------------------------------------------------- the counter vs the HLO

def _reference_flops(arch: str, kind: str, seq: int, batch: int) -> float:
    """``analyze_hlo_text`` of the reference's jitted prefill or train
    step (the single-pod client count, sgd(0.01, 0.5)) at ``reduced()``."""
    from repro.core.distributed import (FedSpec, make_serve_steps,
                                        make_train_step)
    from repro.launch.hlo_analysis import analyze_hlo_text
    from repro.optim import sgd
    cfg = JAX_ARCHS[arch].reduced()
    shape = JShapeConfig("t", seq, batch, kind)
    model = japi.build_model(cfg)
    ps = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    specs = japi.input_specs(cfg, shape)
    if kind == "train":
        opt = sgd(lr=0.01, momentum=0.5)
        step = make_train_step(model, opt,
                               FedSpec(num_clients=dryrun.NUM_CLIENTS))
        lowered = jax.jit(step).lower(ps, jax.eval_shape(opt.init, ps),
                                      specs)
    else:
        prefill, _ = make_serve_steps(model, window=0)
        lowered = jax.jit(prefill).lower(ps, specs)
    return analyze_hlo_text(lowered.compile(FAST_COMPILE).as_text())["flops"]


@pytest.mark.parametrize("kind,seq,batch", [("prefill", 64, 2),
                                            ("train", 64, 16)],
                         ids=["prefill", "train"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_counter_flops_match_reference_hlo(arch, kind, seq, batch):
    cfg = ARCHS[arch].reduced()
    shape = ShapeConfig("t", seq, batch, kind)
    model = api.build_model(cfg, device="meta", kernels="torch")
    call, args = dryrun.step_call(model, shape, api.input_specs(cfg, shape))
    counter, out, _ = dryrun.count_call(call, args)
    want = _reference_flops(arch, kind, seq, batch)
    assert counter.flops == pytest.approx(want, rel=FLOPS_RTOL)
    # only products carry FLOPs, each counted where it ran
    assert {k for k, v in counter.by_op.items() if v["flops"]} <= \
        {"mm", "addmm", "bmm", "baddbmm"}
    assert counter.peak_bytes >= counter.argument_bytes > 0
    if kind == "train":            # the donated step returns its params
        mem = counter.memory_analysis(out, args)
        assert mem["alias_size_in_bytes"] >= sum(
            p.numel() * p.element_size() for p in model.net.parameters())


def test_counter_counts_each_loop_iteration():
    """The port's form of ``test_hlo_analyzer_counts_loop_iterations``:
    the eager loop's five products count five times, as the reference's
    HLO walk multiplies the scan's body by its trip count."""
    from repro.launch.hlo_analysis import analyze_hlo_text

    def jf(x, w):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(body, x, w)[0]

    want = analyze_hlo_text(jax.jit(jf).lower(
        jax.ShapeDtypeStruct((8, 16), jnp.float32),
        jax.ShapeDtypeStruct((5, 16, 16), jnp.float32)).compile().as_text())
    x = torch.empty((8, 16), device="meta")
    w = torch.empty((5, 16, 16), device="meta")
    counter = CostCounter()
    counter.track((x, w))
    with counter:
        h = x
        for wi in w:
            h = torch.tanh(h @ wi)
    assert counter.flops == 5 * 2 * 8 * 16 * 16
    assert counter.flops == pytest.approx(want["flops"], rel=0.01)
    assert counter.by_op["mm"]["calls"] == 5


def test_counter_peak_follows_frees():
    x = torch.empty((1000,), device="meta")
    counter = CostCounter()
    assert counter.track({"x": x, "view": x[:10]}) == 4000
    with counter:
        a = x * 2                     # +4000
        b = a + 1                     # +4000: the peak, 12000
        del a                         # -4000
        c = b.view(10, 100)           # a view: nothing new
        d = c.sum()                   # +4
    assert counter.peak_bytes == 12000
    assert counter.live_bytes == 8004
    mem = counter.memory_analysis((b, d), (x,))
    assert mem == {"argument_size_in_bytes": 4000,
                   "output_size_in_bytes": 4004,
                   "temp_size_in_bytes": 8000, "alias_size_in_bytes": 0}
    # bytes: each non-view op's inputs and outputs
    assert counter.hbm_bytes == 2 * 8000 + 4004


# ------------------------------------------------------------ meta build

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_build_matches_cpu_build(arch):
    cfg = ARCHS[arch].reduced()
    meta = api.build_model(cfg, device="meta")
    cpu = api.build_model(cfg, device="cpu", seed=0)
    assert all(p.is_meta for p in meta.net.parameters())
    assert {k: (tuple(v.shape), v.dtype) for k, v in meta.params().items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in cpu.params().items()}
    assert list(meta.params()) == list(cpu.params())
    cache = meta.init_cache(2, 16)
    assert all(t.is_meta for t in jax.tree.leaves(cache)
               if isinstance(t, torch.Tensor))
    h = hashlib.sha256()
    for k, v in cpu.net.named_parameters():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    assert h.hexdigest()[:32] == CPU_DIGESTS[arch]


# --------------------------------------------------------------- the CLI

def test_main_runs_every_combo_reduced(tmp_path, capsys):
    out = tmp_path / "records.json"
    records = dryrun.main(["--reduced", "--out", str(out)])
    status = collections.Counter(r["status"] for r in records)
    assert status == {"ok": 39, "skipped": 1}
    assert len(json.loads(out.read_text())) == 40
    text = capsys.readouterr().out
    assert "== 39 ok / 1 skipped / 0 errors ==" in text
    for r in records:
        if r["status"] == "ok":
            assert r["num_devices"] == 1
            assert r["hlo_flops_per_device"] > 0
            assert r["model_flops_global"] > 0
            assert r["memory_analysis"]["argument_size_in_bytes"] > 0


def test_full_width_prefill_record(capsys):
    """The README's example: gemma-7b's prefill_32k at full width, its
    arguments the bfloat16 weights and the int32 prompts."""
    (r,) = dryrun.main(["--arch", "gemma-7b", "--shape", "prefill_32k"])
    shape = SHAPES["prefill_32k"]
    mem = r["memory_analysis"]
    assert mem["argument_size_in_bytes"] == \
        dryrun.PARAM_COUNTS["gemma-7b"] * 2 + \
        shape.global_batch * shape.seq_len * 4
    assert r["num_params"] == dryrun.PARAM_COUNTS["gemma-7b"]
    assert r["roofline"]["collective_s"] == 0.0
    assert "dev=" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--multi-pod", "--seq-rule",
                                  "--kv-time-rule"])
def test_several_card_flags_refused(flag):
    """The several-card flags, refused until the mesh step was ported,
    now run the sharded dry-run on the fake group's production mesh:
    per-device memory below the one-card run's, collectives counted."""
    argv = ["--arch", "qwen3-0.6b", "--shape", "train_4k", "--reduced"]
    (one,) = dryrun.main(argv)
    (rec,) = dryrun.main(argv + [flag])
    assert rec["status"] == "ok"
    assert rec["num_devices"] == (512 if flag == "--multi-pod" else 256)
    assert rec["variant"]["seq_rule"] == (flag == "--seq-rule")
    assert rec["variant"]["kv_time_rule"] == (flag == "--kv-time-rule")
    mem, mem1 = rec["memory_analysis"], one["memory_analysis"]
    assert mem["argument_size_in_bytes"] < mem1["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] < mem1["temp_size_in_bytes"]
    assert rec["collective_bytes_total"] > 0
    assert one["collective_bytes_total"] == 0 and one["num_devices"] == 1
