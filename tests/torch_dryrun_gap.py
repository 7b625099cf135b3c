"""The sharded dry-run's per-device bytes, reference against port, on the
CPU: what the port's DTensor layout replicates where the reference's
GSPMD layout splits.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_dryrun_gap.py \
        [--arch qwen3-0.6b] [--shape train_4k] [--full]

Runs one combination (the reduced config unless ``--full``) on the
(2, 16, 16) multi-pod mesh in both packages: the reference's
``launch.dryrun.run_combo`` in a subprocess over 512 forced host devices,
on a mesh of ``Auto`` axes (the installed JAX makes meshes of
``Explicit`` axes, whose ``with_sharding_constraint`` the reference's
``shard_act`` cannot call), and the port's ``launch.dryrun.run_combo``
on 512 ``"fake"`` ranks. Prints each package's per-device argument and
peak bytes (``memory_analysis``: the argument bytes, and the temp bytes
above them), the product FLOPs a device, the argument bytes by group
(params, optimizer state, batch) from each leaf's per-device shape,
and every leaf whose per-device shape differs between the two, with
both shapes. Last line: one JSON object of the same.
"""
import argparse
import json
import math
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

# the reference's combination, each argument leaf's per-device shape and
# dtype: argv[1] the arch, argv[2] the shape, argv[3] "full" or "reduced"
_JAX = r"""
import json, sys
import repro.launch.dryrun as d          # 512 forced host devices
import jax
import numpy as np
from jax.sharding import AxisType, Mesh, NamedSharding
from repro.configs import ARCHS, SHAPES
from repro.core.distributed import param_logical_axes
from repro.launch.dryrun import batch_logical
from repro.models.api import build_model, input_specs
from repro.optim.optim import sgd
from repro.sharding.specs import logical_to_pspec, tree_shardings

arch, shape_name, size = sys.argv[1:4]
cfg = ARCHS[arch] if size == "full" else ARCHS[arch].reduced()
d.ARCHS = {arch: cfg}
mesh = Mesh(np.array(jax.devices()[:512]).reshape(2, 16, 16),
            ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
rec = d.run_combo(arch, shape_name, multi_pod=True, mesh=mesh)
assert rec["status"] == "ok", rec
model = build_model(cfg)
params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
p_axes = param_logical_axes(params)
opt = jax.eval_shape(sgd(lr=0.01, momentum=0.5).init, params)
specs = input_specs(cfg, SHAPES[shape_name])
groups = {
    "params": (params, tree_shardings(p_axes, params, mesh)),
    "optimizer": (opt, tree_shardings({"mu": p_axes, "count": ()}, opt,
                                      mesh)),
    "batch": (specs, jax.tree.map(
        lambda ax, s: NamedSharding(mesh, logical_to_pspec(ax, s.shape,
                                                           mesh)),
        batch_logical(cfg, specs), specs,
        is_leaf=lambda x: isinstance(x, tuple)))}
leaves = {}
for group, (tree, shardings) in groups.items():
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for (path, leaf), sh in zip(flat, jax.tree.leaves(shardings)):
        name = group + "/" + "/".join(str(getattr(k, "key", getattr(
            k, "idx", k))) for k in path)
        leaves[name] = [list(sh.shard_shape(leaf.shape)),
                        np.dtype(leaf.dtype).itemsize]
print(json.dumps({"memory_analysis": rec["memory_analysis"],
                  "hlo_flops_per_device": rec["hlo_flops_per_device"],
                  "leaves": leaves}))
"""


def reference(arch: str, shape: str, size: str) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _JAX, arch, shape, size],
                         env=env, capture_output=True, text=True,
                         timeout=3000)
    if res.returncode:
        raise RuntimeError(res.stderr[-3000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def port(arch: str, shape: str, size: str) -> dict:
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    captured = {}
    count_call = dryrun.count_call

    def keep(fn, arguments, **kw):
        captured["arguments"] = arguments
        return count_call(fn, arguments, **kw)

    dryrun.count_call = keep
    try:
        with dryrun.fake_world(512):
            rec = dryrun.run_combo(arch, shape, reduced=size != "full",
                                   mesh=make_production_mesh(
                                       multi_pod=True))
            params, state, batch = captured["arguments"]
            leaves = {}
            for group, tree in (("params", params), ("optimizer", state),
                                ("batch", batch)):
                flat = pytree.tree_flatten_with_path(tree)[0]
                for path, leaf in flat:
                    if not isinstance(leaf, torch.Tensor):
                        continue
                    local = dryrun._local(leaf)
                    name = group + "/" + "/".join(
                        str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
                    leaves[name] = [list(local.shape),
                                    local.element_size()]
    finally:
        dryrun.count_call = count_call
    assert rec["status"] == "ok", rec
    return {"memory_analysis": rec["memory_analysis"],
            "hlo_flops_per_device": rec["hlo_flops_per_device"],
            "leaves": leaves}


def _by_group(leaves: dict) -> dict:
    out = {}
    for name, (shape, itemsize) in leaves.items():
        group = name.split("/", 1)[0]
        out[group] = out.get(group, 0) + math.prod(shape) * itemsize
    return out


def _key(name: str) -> tuple[str, bool]:
    """A leaf's name in either package, for matching, and whether it is
    one layer of the reference's stacked layers: the port's params are
    flat ``"a.b.c"`` keys, one a layer (``layers.<i>.x``), where the
    reference nests ``a/b/c`` and stacks the layers (``layers/x``, the
    layer axis first)."""
    parts = name.replace(".", "/").replace("/mu/", "/").split("/")
    if len(parts) > 3 and parts[1] == "layers" and parts[2].isdigit():
        return "/".join(parts[:2] + parts[3:]), True
    return "/".join(parts), False


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    size = "full" if args.full else "reduced"
    ref, got = reference(args.arch, args.shape, size), \
        port(args.arch, args.shape, size)
    out = {"arch": args.arch, "shape": args.shape, "size": size}
    for name, rec in (("reference", ref), ("port", got)):
        mem = rec["memory_analysis"]
        out[name] = {"argument_bytes": mem["argument_size_in_bytes"],
                     "peak_above_arguments_bytes": mem["temp_size_in_bytes"],
                     "argument_bytes_by_group": _by_group(rec["leaves"]),
                     "flops_per_device": rec["hlo_flops_per_device"]}
        print(f"{name}: {json.dumps(out[name])}")
    want = {_key(k)[0]: v for k, v in ref["leaves"].items()}
    differ, seen = {}, set()
    for name, (shape, itemsize) in got["leaves"].items():
        key, one_layer = _key(name)
        seen.add(key)
        if key not in want:
            continue
        w_shape = want[key][0][1:] if one_layer else want[key][0]
        if w_shape != shape:
            differ[name] = {"port": shape, "reference": w_shape,
                            "port_bytes": math.prod(shape) * itemsize,
                            "reference_bytes": math.prod(w_shape)
                            * want[key][1]}
    unmatched = sorted(seen ^ set(want))
    out["leaves_that_differ"] = differ
    out["unmatched_leaves"] = unmatched
    for name, d in differ.items():
        print(f"differs: {name}: port {d['port']} ({d['port_bytes']} B), "
              f"reference {d['reference']} ({d['reference_bytes']} B)")
    if unmatched:
        print(f"leaves in one package only: {unmatched}")
    if not differ and not unmatched:
        print("every argument leaf has the same per-device shape in both")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
