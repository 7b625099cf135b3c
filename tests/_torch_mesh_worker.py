"""One rank of the CPU mesh tests (``tests/test_torch_mesh.py``): joins a
``gloo`` process group over a ``FileStore`` and runs a job, rank 0
writing the results.

    python tests/_torch_mesh_worker.py RANK WORLD STORE_DIR JOB.json

Jobs (JSON): ``{"kind": "steps", "inputs": npz, "out": dir, "cases":
[...]}`` runs the gradient-level step of each case on its mesh (the
microbatched step where the case names ``micro``, its microbatch count)
and, for the moe case, ``moe_block_shard_map`` on its own, a ``vocab``
case the vocab-parallel softmax, log-softmax and pick, and an
``attention`` case ``sharding.ctx.attention_on_ranks`` in each layout of
:func:`attention_layouts`;
``{"kind": "train", "argv": [...], "out": json}`` runs
``launch.train.main``. The worker imports the port only (no JAX).
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _step_case(case: dict, inputs, rank: int, out_dir: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS
    from repro_torch.core.distributed import (
        FedSpec, lay_out_params, make_microbatched_train_step,
        make_train_step)
    from repro_torch.core.judgment import judge
    from repro_torch.models.api import build_model
    from repro_torch.optim import Optimizer, sgd
    from repro_torch.sharding.ctx import use_mesh

    name, arch = case["name"], case["arch"]
    cfg = ARCHS[arch].reduced()
    model = build_model(cfg, device="cpu", kernels="torch")
    prefix = f"{arch}/param/"
    model.net.load_state_dict({k[len(prefix):]: torch.from_numpy(v)
                               for k, v in inputs.items()
                               if k.startswith(prefix)})
    mesh = init_device_mesh("cpu", tuple(case["mesh"]),
                            mesh_dim_names=("data", "model")[
                                :len(case["mesh"])])
    soft_seen = []

    def judge_fn(soft, sizes):
        soft_seen.append(soft.clone())
        return judge(soft, sizes)

    base = sgd(lr=case["lr"], momentum=0.5)

    def update(grads, state, params):
        # every gradient reaches the update in its parameter's placement
        for k, g in grads.items():
            if tuple(g.placements) != tuple(params[k].placements):
                raise AssertionError(f"{k}: gradient {g.placements}, "
                                     f"param {params[k].placements}")
        return base.update(grads, state, params)

    opt = Optimizer(base.init, update)
    fed = FedSpec(num_clients=case["m"])
    step = (make_microbatched_train_step(model, opt, fed, case["micro"],
                                         judge_fn=judge_fn)
            if case.get("micro") else
            make_train_step(model, opt, fed, judge_fn=judge_fn))
    batch = {k.split("/", 2)[2]: torch.from_numpy(v)
             for k, v in inputs.items() if k.startswith(f"{arch}/batch/")}
    res = {}
    with use_mesh(mesh):
        params = lay_out_params({k: v.detach() for k, v in
                                 model.params().items()}, mesh,
                                case["layout"])
        state = opt.init(params)
        for it in range(case["steps"]):
            params, state, met = step(params, state, batch)
            for k, v in met.items():
                res[f"step{it}/{k}"] = _np(v)
            res[f"step{it}/soft"] = _np(soft_seen[it])
        for k, v in params.items():
            res[f"param/{k}"] = _np(v.full_tensor())
    if case.get("moe_block"):
        res.update(_moe_block(cfg, model, inputs, mesh))
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{name}.npz"), **res)


def _vocab_case(case: dict, inputs, rank: int, out_dir: str) -> None:
    """The vocab-parallel softmax, log-softmax and pick
    (``sharding.vocab``) on each mesh of the case, the logits laid out
    on ("batch", "seq", "vocab"): the values gathered whole, and the
    gradient of sum(pick(log_softmax(x), t) * r) with respect to x."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import vocab
    from repro_torch.sharding.ctx import current, use_mesh
    from repro_torch.sharding.specs import distribute_full

    x = torch.from_numpy(inputs["vocab/x"])
    t = torch.from_numpy(inputs["vocab/t"])
    r = torch.from_numpy(inputs["vocab/r"])
    res = {}
    for shape in case["meshes"]:
        mesh = init_device_mesh("cpu", tuple(shape),
                                mesh_dim_names=("data", "model"))
        tag = "x".join(map(str, shape))
        with use_mesh(mesh):
            ctx = current()
            pl = ctx.placements(("batch", "seq", "vocab"), x.shape)
            xd = distribute_full(x, mesh, pl).requires_grad_(True)
            rd = distribute_full(r, mesh, ctx.placements(("batch", "seq"),
                                                         r.shape))
            logp = vocab.log_softmax(xd)
            picked = vocab.pick(logp, t)
            grad, = torch.autograd.grad((picked * rd).sum(), [xd])
            res[f"{tag}/vocab_ranks"] = np.array(
                [mesh.size(i) for i, q in enumerate(pl) if q.is_shard(2)])
            res[f"{tag}/softmax"] = _np(vocab.softmax(xd).full_tensor())
            res[f"{tag}/log_softmax"] = _np(logp.full_tensor())
            res[f"{tag}/pick"] = _np(picked.full_tensor())
            res[f"{tag}/grad"] = _np(grad.full_tensor())
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{case['name']}.npz"), **res)


def attention_layouts(a: dict) -> dict:
    """name -> (attention function, its query, q's and K's / V's
    placements on ("data", "model"), keyword arguments, whether the
    gradients are taken), over the ``attn/`` inputs ``a``: the batch rows
    on "data" and on "model" the query heads with tensor positions (4
    ranks do not divide the 2 kv heads, 2 do), the sequence (with a
    window, and blockwise), or the keys of a one-token query (forward
    only)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels import ref
    rows_heads, rows_seq = (Shard(0), Shard(2)), (Shard(0), Shard(1))
    rows = (Shard(0), Replicate())
    return {
        "heads": (ref.mha_reference, a["q"], rows_heads, rows,
                  dict(q_offset=a["q_offset"], kv_positions=a["kv_pos"]),
                  True),
        "seq": (ref.mha_reference, a["q"], rows_seq, rows_seq,
                dict(window=3), True),
        "seq_blockwise": (ref.mha_blockwise, a["q"], rows_seq, rows_seq,
                          dict(block_k=2), True),
        "keys": (ref.mha_reference, a["q1"], rows, rows_seq,
                 dict(q_offset=a["q1_offset"], kv_positions=a["kv_pos"]),
                 False),
    }


def _attention_case(case: dict, inputs, rank: int, out_dir: str) -> None:
    """Each layout of :func:`attention_layouts` on each mesh of the case
    (causal): the output gathered whole, the gradients of sum(out * r)
    with respect to q, k and v, and whether the keys layout raises where
    autograd records."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.specs import distribute_full

    a = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
         if k.startswith("attn/")}
    res = {}
    for shape in case["meshes"]:
        mesh = init_device_mesh("cpu", tuple(shape),
                                mesh_dim_names=("data", "model"))
        tag = "x".join(map(str, shape))
        with use_mesh(mesh):
            for name, (fn, q, q_pl, kv_pl, kw, grad) in \
                    attention_layouts(a).items():
                qd = distribute_full(q, mesh, q_pl)
                kd = distribute_full(a["k"], mesh, kv_pl)
                vd = distribute_full(a["v"], mesh, kv_pl)
                if not grad:
                    with torch.no_grad():
                        out = fn(qd, kd, vd, causal=True, **kw)
                    res[f"{tag}/{name}/out"] = _np(out.full_tensor())
                    try:
                        fn(qd.requires_grad_(True), kd, vd, causal=True,
                           **kw)
                        res[f"{tag}/{name}/raises"] = np.array(False)
                    except NotImplementedError:
                        res[f"{tag}/{name}/raises"] = np.array(True)
                    continue
                ins = [t.requires_grad_(True) for t in (qd, kd, vd)]
                out = fn(*ins, causal=True, **kw)
                r = a["r"][:, :q.shape[1]]
                grads = torch.autograd.grad((out * r).sum(), ins)
                res[f"{tag}/{name}/out"] = _np(out.full_tensor())
                for n, g in zip("qkv", grads):
                    res[f"{tag}/{name}/grad_{n}"] = _np(g.full_tensor())
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{case['name']}.npz"), **res)


def _moe_block(cfg, model, inputs, mesh) -> dict:
    """``moe_block_shard_map`` of layer 0's experts on each case's x: the
    output and aux (plain x), every rank's kept assignments (in rank
    order), and the gradients of sum(out * r) + aux / 2 with respect to
    x (a DTensor leaf) and the four weights."""
    from types import SimpleNamespace

    from repro_torch.models import moe as moe_mod
    from repro_torch.sharding.specs import distribute_full, placements

    block = model.net.layers[0].moe
    kept_seen = []
    dispatch = moe_mod.dispatch

    def recording(cfg_, top_i, cap):
        row, kept = dispatch(cfg_, top_i, cap)
        kept_seen.append(kept.clone())
        return row, kept

    out = {}
    moe_mod.dispatch = recording
    try:
        for case in ("c1", "c3"):
            x = torch.from_numpy(inputs[f"moe/x_{case}"])
            r = torch.from_numpy(inputs[f"moe/r_{case}"])
            kept_seen.clear()
            with torch.no_grad():
                y, aux = moe_mod.moe_block_shard_map(cfg, block, x, mesh)
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, _np(kept_seen[0]))
            out[f"moe/{case}/out"] = _np(y)
            out[f"moe/{case}/aux"] = _np(aux)
            out[f"moe/{case}/kept"] = np.stack(every)
            spec, _, _ = moe_mod.token_split(x.shape[0], x.shape[1], mesh)
            pl = placements(spec, mesh)
            xd = distribute_full(x, mesh, pl).requires_grad_(True)
            ws = [t.detach().clone().requires_grad_(True) for t in (
                block.router.w, block.w_in, block.w_gate, block.w_out)]
            p = SimpleNamespace(router=SimpleNamespace(w=ws[0]),
                                w_in=ws[1], w_gate=ws[2], w_out=ws[3])
            y, aux = moe_mod.moe_block_shard_map(cfg, p, xd, mesh)
            loss = (y * distribute_full(r, mesh, pl)).sum() + 0.5 * aux
            grads = torch.autograd.grad(loss, [xd] + ws)
            out[f"moe/{case}/grad_x"] = _np(grads[0].full_tensor())
            for n, g in zip(("router", "w_in", "w_gate", "w_out"),
                            grads[1:]):
                out[f"moe/{case}/grad_{n}"] = _np(g)
    finally:
        moe_mod.dispatch = dispatch
    return out


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store_dir, job_path = sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    import logging
    # DTensor warns at each two-step reduction over a (2, 2) mesh
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    with open(job_path) as f:
        job = json.load(f)
    try:
        if job["kind"] == "steps":
            inputs = dict(np.load(job["inputs"]))
            for case in job["cases"]:
                if case.get("kind") == "vocab":
                    _vocab_case(case, inputs, rank, job["out"])
                elif case.get("kind") == "attention":
                    _attention_case(case, inputs, rank, job["out"])
                else:
                    _step_case(case, inputs, rank, job["out"])
        else:
            from repro_torch.launch import train
            records = train.main(job["argv"])
            if rank == 0:
                with open(job["out"], "w") as f:
                    json.dump(records, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
