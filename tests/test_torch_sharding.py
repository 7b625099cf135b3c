"""The port's sharding rules (``repro_torch.sharding``), its param and
cache logical axes (``core.distributed``) and the sharded dry-run
(``launch.dryrun`` on the ``"fake"`` group) against the live JAX
reference, on the CPU.

* ``logical_to_pspec`` equal to the reference's on the cases of its own
  tests (divisibility, prefix fallback, no mesh axis twice) and on every
  parameter and cache leaf of every assigned arch at full width, over
  the (16, 16) and (2, 16, 16) ``FakeMesh``;
* ``param_logical_axes`` and ``cache_logical_axes`` equal to the
  reference's leaf by leaf, less its layer-stacking dims;
* ``placements``: a dim over ``("pod", "data")`` is ``Shard(d)`` twice
  in mesh order, and each rank's block (``distribute_full``'s) is the
  major-to-minor one;
* ``shard_act`` the identity outside a context and on plain tensors;
* the sharded dry-run: per-device parameter bytes equal to the sum of
  the reference pspecs' shard shapes, and the data-parallel step's
  collective bytes equal to its gradients' all-reduce, reckoned by hand.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_sharding.py
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import math

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as JAX_ARCHS, SHAPES as JAX_SHAPES
from repro.core.distributed import (
    cache_logical_axes as jax_cache_axes,
    param_logical_axes as jax_param_axes)
from repro.models.api import (build_model as jax_build_model,
                              input_specs as jax_input_specs)
from repro.sharding.specs import (
    DEFAULT_RULES as JAX_RULES, logical_to_pspec as jax_pspec)
from repro_torch.configs import ARCHS, ASSIGNED, SHAPES
from repro_torch.core.distributed import (cache_logical_axes,
                                          distribute_batch, lay_out_params,
                                          param_logical_axes)
from repro_torch.launch import dryrun
from repro_torch.models.api import build_model, input_specs
from repro_torch.sharding.ctx import current, shard_act, use_mesh
from repro_torch.sharding.specs import (DEFAULT_RULES, P, _local_block,
                                        logical_to_pspec, placements,
                                        tree_shardings)


class FakeMesh:
    """Just enough of a mesh for the rule engine (the reference tests')."""

    def __init__(self, shape):
        self.shape = shape


MESH = FakeMesh({"data": 16, "model": 16})
MESH_MP = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": MESH_MP}


def _same(port, ref) -> bool:
    return tuple(port) == tuple(ref)


# ------------------------------------------------------------- the rules

@pytest.mark.parametrize("logical,shape,mesh", [
    (("embed", "kv_heads"), (4096, 2 * 128), "16x16"),    # 256 divides 16
    (("embed", "kv_heads"), (4096, 2 * 100), "16x16"),    # 200 does not
    (("batch",), (256,), "2x16x16"),                      # both axes
    (("batch",), (8,), "2x16x16"),                        # prefix: pod
    (("batch",), (1,), "2x16x16"),                        # replicate
    (("experts", "embed", "ffn"), (128, 4096, 1536), "16x16"),  # no reuse
    (("vocab", "embed"), (151936, 1024), "2x16x16"),
    (("batch", "kv_time", "kv_heads", None), (128, 32768, 2, 128),
     "16x16"),
])
def test_logical_to_pspec_equals_reference(logical, shape, mesh):
    m = MESHES[mesh]
    assert _same(logical_to_pspec(logical, shape, m),
                 jax_pspec(logical, shape, m))
    rules = dict(DEFAULT_RULES, kv_time=("model",), seq=("model",))
    jrules = dict(JAX_RULES, kv_time=("model",), seq=("model",))
    assert _same(logical_to_pspec(logical, shape, m, rules),
                 jax_pspec(logical, shape, m, jrules))


def test_rule_tables_equal_reference():
    assert DEFAULT_RULES == JAX_RULES


def test_two_mesh_dims_shard_one_dim_major_first():
    """("pod", "data") on one dim is Shard(d) on both mesh dims, in mesh
    order; the local block of rank (p, d) is block p * 2 + d of 4."""
    spec = logical_to_pspec(("batch", None), (8, 3), FakeMesh(
        {"pod": 2, "data": 2, "model": 2}))
    assert spec == P(("pod", "data"), None)

    class Grid:                     # one rank's view of a (2, 2, 2) mesh
        shape = {"pod": 2, "data": 2, "model": 2}
        mesh_dim_names = ("pod", "data", "model")
        ndim = 3

        def __init__(self, coord):
            self.coord = coord

        def size(self, i):
            return 2

        def get_coordinate(self):
            return self.coord

    pl = placements(spec, FakeMesh(Grid.shape))
    assert pl == (Shard(0), Shard(0), Replicate())
    t = torch.arange(24.0).reshape(8, 3)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                got = _local_block(t, Grid([p, d, m]), pl)
                assert torch.equal(got, t[(p * 2 + d) * 2:(p * 2 + d + 1)
                                          * 2])
    with pytest.raises(ValueError, match="mesh's order"):
        placements(P(("data", "pod")), FakeMesh(Grid.shape))


def test_tree_shardings_dicts_and_lists():
    mesh = FakeMesh({"data": 2, "model": 2})
    tree = {"a": torch.empty(4, 6), "b": [torch.empty(3, 4), 7]}
    axes = {"a": ("batch", "heads"), "b": [("batch", "ffn"), ()]}
    got = tree_shardings(axes, tree, mesh)
    assert got == {"a": (Shard(0), Shard(1)),
                   "b": [(Replicate(), Shard(1)), None]}


def test_shard_act_is_identity_without_a_context_and_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    assert shard_act(x, ("batch", "seq", "embed")) is x
    with use_mesh(MESH):
        assert shard_act(x, ("batch", "seq", "embed")) is x


# ---------------------------------------- param and cache logical axes

def _ref_leaves(tree, axes_tree):
    """{path without the stacking: (axes, shape)} of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    axes = jax.tree_util.tree_leaves(
        axes_tree, is_leaf=lambda x: isinstance(x, tuple))
    out = {}
    for (path, leaf), ax in zip(flat, axes):
        names = tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path)
        out[names] = (ax, tuple(getattr(leaf, "shape", ())))
    return out


def _port_path(name) -> tuple:
    """The reference tree's path of a port leaf: the per-layer (and
    per-group) indices dropped."""
    parts = name if isinstance(name, tuple) else tuple(name.split("."))
    return tuple(p for p in parts if not str(p).isdigit())


def _held(port_axes, port_shape, ref_axes, ref_shape):
    """The port's axes are the reference's trailing ones, its leading
    (stacking) ones None; the pspecs agree on every mesh."""
    pad = len(ref_axes) - len(port_axes)
    assert pad >= 0 and tuple(ref_axes[pad:]) == tuple(port_axes)
    assert all(a is None for a in ref_axes[:pad])
    assert tuple(ref_shape[pad:]) == tuple(port_shape)
    for mesh in MESHES.values():
        want = jax_pspec(ref_axes, ref_shape, mesh)
        assert all(p is None for p in tuple(want)[:pad])
        assert _same(logical_to_pspec(port_axes, port_shape, mesh),
                     tuple(want)[pad:])


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_logical_axes_equal_reference(arch):
    jm = jax_build_model(JAX_ARCHS[arch])
    shape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    ref = _ref_leaves(shape, jax_param_axes(shape))
    params = build_model(ARCHS[arch], device="meta").params()
    axes = param_logical_axes(params)
    assert set(axes) == set(params)
    seen = set()
    for name, leaf in params.items():
        path = _port_path(name)
        seen.add(path)
        _held(axes[name], tuple(leaf.shape), *ref[path])
    assert seen == set(ref)


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (str(i),))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_logical_axes_equal_reference(arch):
    jcache = jax_input_specs(JAX_ARCHS[arch], JAX_SHAPES["decode_32k"])[
        "cache"]
    ref = _ref_leaves(jcache, jax_cache_axes(jcache))
    cache = input_specs(ARCHS[arch], SHAPES["decode_32k"])["cache"]
    axes = dict(_port_leaves(cache_logical_axes(cache), ()))
    seen = set()
    for path, leaf in _port_leaves(cache):
        ax = axes[path]
        if not isinstance(leaf, torch.Tensor):       # the int index
            assert ax == () and ref[_port_path(path)][0] == ()
            seen.add(_port_path(path))
            continue
        seen.add(_port_path(path))
        _held(ax, tuple(leaf.shape), *ref[_port_path(path)])
    assert seen == set(ref)


# ------------------------------------------------- the sharded dry-run

def test_multi_pod_param_bytes_equal_reference_pspecs():
    """qwen3-0.6b reduced, train_4k, under --multi-pod on 512 fake ranks:
    the per-device parameter bytes are the sum over the reference's
    pspecs on the (2, 16, 16) mesh of each leaf's shard, and the step's
    collectives are counted."""
    (rec,) = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k",
                          "--reduced", "--multi-pod"])
    jm = jax_build_model(JAX_ARCHS["qwen3-0.6b"].reduced())
    shape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    want = 0
    for (path, leaf), ax in zip(
            jax.tree_util.tree_flatten_with_path(shape)[0],
            jax.tree_util.tree_leaves(jax_param_axes(shape),
                                      is_leaf=lambda x: isinstance(x,
                                                                   tuple))):
        spec = jax_pspec(ax, leaf.shape, MESH_MP)
        n = 1
        for dim, part in zip(leaf.shape, tuple(spec) + (None,) * 8):
            parts = part if isinstance(part, tuple) else (part,)
            div = math.prod(MESH_MP.shape[a] for a in parts if a)
            n *= dim // div
        want += n * leaf.dtype.itemsize
    assert rec["status"] == "ok" and rec["num_devices"] == 512
    assert rec["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["param_bytes_per_device"] == want
    assert rec["collective_bytes_total"] > 0
    assert rec["roofline"]["collective_s"] > 0


def test_data_parallel_step_collectives_are_the_gradient_all_reduce():
    """The (4, 1) data-parallel train step with replicated params: every
    collective but the step's own few is the all-reduce of one gradient,
    each leaf once, in its parameter's dtype; reckoned by hand:

    * all-reduce: every gradient (its param's bytes), the loss (one
      float32), the aux loss is a constant here (dense), the grad norm's
      sum of squares is over replicated gradients (no reduction);
    * all-gather: the soft labels (M / 4 clients of the padded vocab, in
      float32) and the per-client losses (M / 4 float32) to every rank.
    """
    cfg = ARCHS["qwen3-0.6b"].reduced()
    shape = SHAPES["train_4k"]
    model = build_model(cfg, device="meta", kernels="torch")
    with dryrun.fake_world(4):
        mesh = dryrun.world_mesh((4, 1), ("data", "model"))
        with use_mesh(mesh):
            params = lay_out_params(model.params(), mesh, "replicated")
            specs = distribute_batch(input_specs(cfg, shape), current())
            counter, _, _ = dryrun.count_call(*dryrun.step_call(
                model, shape, specs, params=params,
                num_clients=dryrun.fl_clients_for(mesh)))
    grads = sum(p.numel() * p.element_size() for p in params.values())
    m = 4                                   # one client group a data rank
    assert counter.summary()["collective_bytes"] == {
        "all-gather": float(m // 4 * cfg.padded_vocab * 4 + m // 4 * 4),
        "all-reduce": float(grads + 4)}
