"""ClientStrategy implementations around ``core.strategies.client_update``.

The local-update math lives in ``core.strategies.client_update`` (one
function per client, mapped over the cohort); these classes name the
rule and own its cross-round state as an explicit tree of tensors
(``init_state``, threaded through ``update_state``), and describe how
that state is sliced onto the cohort's client axis (``client_inputs``,
``client_in_axes``) and folded back.

``CatChainStrategy`` (FedCAT) also builds its own client program and lays
the cohort out in groups: the optional ``prepare_round`` /
``make_client_fn`` / ``finish_round`` hooks the server calls.
``LMWindowStrategy`` ("lmstep") builds its own client program only: the
causal-LM rule over token windows.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
from torch.func import vjp, vmap
from torch.utils import _pytree as pytree

from ..core.strategies import LocalSpec, client_update
from ..models.transformer import token_nll
from .registry import register


def _rows(idx, like: torch.Tensor) -> torch.Tensor:
    """Host client ids as an int64 index on ``like``'s device."""
    return torch.as_tensor(np.asarray(idx, np.int64), device=like.device)


def _stacked(tree, num_clients: int):
    """Every leaf repeated on a new leading (num_clients,) axis."""
    return pytree.tree_map(
        lambda x: x.expand((num_clients,) + x.shape).clone(), tree)


def _take(stacked, idx):
    """The rows ``idx`` of every leaf of a (N, ...) tree."""
    return pytree.tree_map(lambda x: x.index_select(0, _rows(idx, x)),
                           stacked)


def _put(stacked, idx, rows):
    """A copy of the (N, ...) tree with rows ``idx`` replaced by ``rows``."""
    return pytree.tree_map(
        lambda full, new: full.index_copy(0, _rows(idx, full),
                                          new.to(full.dtype)),
        stacked, rows)


class _Strategy:
    """Shared base of the strategies: no cross-round state and no state
    slices unless a subclass (moon, scaffold) adds them."""

    name = "fedavg"
    doubles_uplink = False

    def __init__(self, spec: LocalSpec | None = None):
        spec = spec or LocalSpec()
        # the class picks the update rule; refuse a spec that names a
        # *different* rule rather than silently running the wrong method
        if spec.strategy not in (self.name, "fedavg"):
            raise ValueError(
                f"LocalSpec(strategy={spec.strategy!r}) conflicts with the "
                f"{self.name!r} strategy class; build the "
                f"{spec.strategy!r} composition instead or drop the field")
        self.spec = replace(spec, strategy=self.name)

    @classmethod
    def from_config(cls, config, local):
        return cls(local)

    def init_state(self, global_params, num_clients: int):
        return None

    def client_inputs(self, state, idx):
        return None, None, None

    def client_in_axes(self) -> tuple:
        return (None, 0, None, None, None)

    def update_state(self, state, global_params, out, idx, num_clients):
        return state


@register("strategy", "fedavg")
class FedAvgStrategy(_Strategy):
    """Plain local SGD(+momentum) [McMahan et al. 2017]."""
    name = "fedavg"


@register("strategy", "fedprox")
class FedProxStrategy(_Strategy):
    """FedAvg + proximal term to the global model [Li et al. 2020]."""
    name = "fedprox"


@register("strategy", "moon")
class MoonStrategy(_Strategy):
    """Model-contrastive learning [Li et al. 2021].

    State: ``prev_params`` — every client's last local model, stacked on a
    leading (num_clients,) axis.
    """
    name = "moon"

    def init_state(self, global_params, num_clients: int):
        return {"prev_params": _stacked(global_params, num_clients)}

    def client_inputs(self, state, idx):
        return _take(state["prev_params"], idx), None, None

    def client_in_axes(self) -> tuple:
        return (None, 0, 0, None, None)

    def update_state(self, state, global_params, out, idx, num_clients):
        return {"prev_params": _put(state["prev_params"], idx,
                                    out["params"])}


@register("strategy", "scaffold")
class ScaffoldStrategy(_Strategy):
    """Control-variate-corrected SGD [Karimireddy et al. 2020].

    State: server variate ``c_global`` plus per-client variates
    ``c_local`` stacked on a leading (num_clients,) axis. Pair with
    ``aggregator="scaffold"`` for the damped server step.
    """
    name = "scaffold"
    doubles_uplink = True           # uplink carries model + control variate

    def init_state(self, global_params, num_clients: int):
        return {
            "c_global": pytree.tree_map(torch.zeros_like, global_params),
            "c_local": pytree.tree_map(
                lambda x: x.new_zeros((num_clients,) + x.shape),
                global_params),
        }

    def client_inputs(self, state, idx):
        return None, _take(state["c_local"], idx), state["c_global"]

    def client_in_axes(self) -> tuple:
        return (None, 0, None, 0, None)

    def update_state(self, state, global_params, out, idx, num_clients):
        # c <- c + |S_t|/N * mean_i dc_i over the whole cohort, admitted
        # or not; the cohort's c_i rows are replaced
        frac = len(idx) / num_clients
        return {
            "c_global": pytree.tree_map(lambda c, d: c + frac * d.mean(0),
                                        state["c_global"], out["c_delta"]),
            "c_local": _put(state["c_local"], idx, out["c_local"]),
        }


def pulled_grad(f):
    """``torch.func.grad(f)``, the gradient of the scalar ``f`` in its
    first argument, pulled back through ``torch.func.vjp``: the same bits
    (``create_graph=True`` picks the backward formulas ``grad`` takes;
    ``silu``'s, for one, sums in another order under grad mode) and a
    lower peak. ``grad`` differentiates inside its own level, so its
    ``create_graph=True`` builds a graph of the gradients that holds
    every layer's backward tensors until the last layer is done; here
    the pull runs after the level has closed, so nothing records it."""
    def grad_fn(p, *args):
        out, pull = vjp(lambda q: f(q, *args), p)
        return pull(torch.ones_like(out), create_graph=True)[0]
    return grad_fn


@register("strategy", "lmstep")
class LMWindowStrategy(_Strategy):
    """Causal-LM local fine-tuning over full token windows.

    The classification strategies consume ``apply(params, x) -> (logits,
    feats)`` with one label per sample; the LM workload's unit is a token
    *window*: ``x`` is (S, L+1) int32 token ids, the model scores every
    next-token position at once (``apply(params, x) -> ((S, L, V) logits
    for targets x[:, 1:], feats)``), and ``y`` is unread. This is
    ``client_update`` re-derived for that contract: E epochs of minibatch
    SGD with momentum on the per-window mean next-token NLL (the sample
    weights ``w`` mask padded windows exactly; the tail that does not
    fill a minibatch is dropped), stateless, so every engine (the scan
    engine's blocks too) runs it.

    Soft label (paper Eq. 2, LM analog): the weighted mean next-token
    softmax over every window and position,
    ``einsum("s,slv->v", w, probs) / (sum(w) * L)``, a (V,) distribution
    the judge takes as it takes a num_classes-way soft label; ``size`` is
    ``sum(w)`` (windows, the FedAvg weight).

    The program is vmapped over the cohort like the classification rule,
    so the servers capture it as one CUDA graph on the card. The apply
    function must differentiate under ``torch.func``: a model built with
    ``kernels="torch"`` (the cuda route's attention and SSD kernels have
    no backward and refuse).
    """

    name = "lmstep"

    def make_client_fn(self, apply_fn):
        spec = self.spec

        def nll(p, bx, bw):
            logits, _ = apply_fn(p, bx)
            tok, _ = token_nll(logits, bx[:, 1:])
            per_window = tok.mean(dim=-1)
            return (per_window * bw).sum() / bw.sum().clamp(min=1e-12)

        grad_fn = pulled_grad(nll)

        def one(global_params, data, prev_p, c_loc, c_glob):
            del prev_p, c_loc, c_glob              # stateless
            x, w = data["x"], data["w"]
            s = x.shape[0]
            bs = min(spec.batch_size, s)
            nb = s // bs
            params = global_params
            mom = pytree.tree_map(torch.zeros_like, params)
            for _ in range(spec.epochs):
                for b in range(nb):
                    sl = slice(b * bs, (b + 1) * bs)
                    g = grad_fn(params, x[sl], w[sl])
                    mom = pytree.tree_map(
                        lambda m, gi: spec.momentum * m + gi, mom, g)
                    params = pytree.tree_map(lambda pi, m: pi - spec.lr * m,
                                             params, mom)
            logits, _ = apply_fn(params, x)
            probs = torch.softmax(logits.to(torch.float32), dim=-1)
            size = w.sum().clamp(min=1e-12)
            soft = (torch.einsum("s,slv->v", w, probs)
                    / (size * probs.shape[1]))
            return {"params": params, "soft_label": soft, "size": w.sum()}

        return vmap(one, in_dims=(None, 0, None, None, None))


@register("strategy", "catchain")
class CatChainStrategy(_Strategy):
    """FedCAT device-concatenation chains (arXiv 2202.12751).

    The round's cohort is partitioned into the selector's ordered groups
    (``last_groups``); within a group the devices train *sequentially*,
    each from its predecessor's output params and the first from the
    global model. The program is a Python loop over the K stages (K is
    fixed per layout, standing in for the reference's ``lax.scan``) inside
    a ``torch.func.vmap`` over the G groups, so the whole chain program
    is one function of its inputs and is captured as one CUDA graph on
    the card. The local rule is plain FedAvg SGD (the paper's); pair with
    ``DeviceConcatAggregator``.

    Ragged groups are padded to the longest chain by repeating the last
    member's data; padded stages carry ``valid = 0`` and are the identity
    (``torch.where`` leaf by leaf), so padding never leaks into a chain.
    Per-device outputs (the chain state after that device trained, its
    soft label and size) come back in cohort order with ``group_id`` and
    ``chain_pos`` for the aggregator.
    """

    name = "catchain"

    def __init__(self, spec: LocalSpec | None = None, group_size: int = 2):
        super().__init__(spec)
        self.group_size = max(1, int(group_size))

    @classmethod
    def from_config(cls, config, local):
        return cls(local, config.group_size)

    def layout(self, n: int, selector) -> dict:
        """The chain layout of an ``n``-device cohort, on the host: the
        groups of ``selector``'s ``last_groups`` (in selection order when
        it has none) as ``perm`` (G, K) cohort positions (a short group
        repeats its last member), ``valid`` (G, K), and each device's
        ``inv`` (its place in the (G, K) layout), ``group_id`` and
        ``chain_pos``, all int64 numpy."""
        groups = getattr(selector, "last_groups", None)
        if not groups:
            k = self.group_size
            groups = [list(range(i, min(i + k, n)))
                      for i in range(0, n, k)]
        g, k = len(groups), max(len(m) for m in groups)
        perm = np.zeros((g, k), np.int64)
        valid = np.zeros((g, k), np.int64)
        gid = np.zeros(n, np.int64)
        pos = np.zeros(n, np.int64)
        inv = np.zeros(n, np.int64)
        for gi, members in enumerate(groups):
            for j in range(k):
                perm[gi, j] = members[min(j, len(members) - 1)]
                valid[gi, j] = j < len(members)
            for j, m in enumerate(members):
                gid[m], pos[m], inv[m] = gi, j, gi * k + j
        return {"perm": perm, "valid": valid, "inv": inv, "group_id": gid,
                "chain_pos": pos}

    @staticmethod
    def layout_aux(lay: dict, device) -> dict:
        """A :meth:`layout` on ``device``, in one copy: ``perm`` flat,
        ``valid`` (G, K) float32, ``inv``, and ``group_id``/``chain_pos``
        int32."""
        g, k = lay["valid"].shape
        n = len(lay["inv"])
        ints = torch.as_tensor(np.concatenate(
            [lay["perm"].reshape(-1), lay["inv"], lay["group_id"],
             lay["chain_pos"], lay["valid"].reshape(-1)]), device=device)
        flat, inv_t, gid_t, pos_t, valid_t = ints.split(
            [g * k, n, n, n, g * k])
        return {"perm": flat, "valid": valid_t.reshape(g, k).to(
                    torch.float32),
                "inv": inv_t, "group_id": gid_t.to(torch.int32),
                "chain_pos": pos_t.to(torch.int32)}

    def prepare_round(self, data: dict, selector) -> tuple[dict, dict]:
        """Lay the gathered cohort out as (G, K, S, ...) chain groups.

        The layout's indices are computed on the host (:meth:`layout`) and
        cross to the device in one copy; the relayout itself is a device
        ``index_select``. ``aux`` carries the ``valid`` mask, the inverse
        permutation ``inv`` and the per-device ``group_id``/``chain_pos``
        (int32), all on the cohort's device.
        """
        lay = self.layout(data["x"].shape[0], selector)
        g, k = lay["valid"].shape
        aux = self.layout_aux(lay, data["x"].device)
        flat = aux.pop("perm")
        gdata = {key: v.index_select(0, flat).reshape((g, k) + v.shape[1:])
                 for key, v in data.items()}
        return gdata, aux

    def make_client_fn(self, apply_fn):
        """The chain program ``(global_params, gdata, prev_p, c_loc,
        c_glob, valid) -> (G, K, ...)`` stage outputs."""
        spec = self.spec

        def one_group(global_params, gd, gv):
            carry, stages = global_params, []
            for j in range(gv.shape[0]):
                d = {key: gd[key][j] for key in ("x", "y", "w")}
                o = client_update(apply_fn, carry, d, spec)
                live = gv[j] > 0
                carry = pytree.tree_map(
                    lambda a, b: torch.where(live, a, b), o["params"],
                    carry)
                stages.append({"params": carry,
                               "soft_label": o["soft_label"],
                               "size": o["size"]})
            return pytree.tree_map(lambda *xs: torch.stack(xs), *stages)

        groups = vmap(one_group, in_dims=(None, 0, 0))

        def chain_fn(global_params, gdata, prev_p, c_loc, c_glob, valid):
            del prev_p, c_loc, c_glob        # chains are stateless FedAvg
            return groups(global_params, gdata, valid)

        return chain_fn

    def finish_round(self, out: dict, aux: dict) -> dict:
        """(G, K, ...) stage outputs -> (|S_t|, ...) in cohort order, with
        ``group_id`` and ``chain_pos``. The gather makes new tensors, so a
        captured program's outputs are read once here and never kept."""
        inv = aux["inv"]
        res = pytree.tree_map(
            lambda x: x.reshape((-1,) + x.shape[2:]).index_select(0, inv),
            out)
        res["group_id"] = aux["group_id"]
        res["chain_pos"] = aux["chain_pos"]
        return res
