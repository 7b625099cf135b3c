"""Single-query (decode) attention: wrapper of ``csrc/decode_attention.cu``
(K4).

One new token per row, q (B, 1, H, D), against a position-tagged KV cache
k, v (B, T, KH, D) with tags (B, T) int32 (-1 = empty slot). A slot is
seen when 0 <= tag <= index[b] and, with a window, tag > index[b] -
window. ``index`` is the current position per row, (B,) or a scalar, as
the reference's ``q_offset``: the Pallas route's batch-wide
``max(kv_positions)`` agrees with it only when every row shares one index.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, :func:`.ref.mha_reference` with ``q_offset=index``.

The kernel splits the cache axis over the SMs. :func:`plan` computes the
whole launch from the shapes and the SM count alone: the number of splits,
the slots of each, the staging tile, the route (tensor cores from
``TENSOR_CORE_MIN_GROUP`` query heads a KV head, CUDA cores below), the
heads a block serves and the kernel's shared-memory layout, which the C
side takes as it is (its ``struct Plan``, the same fields in the same
order) and computes nothing of. A call runs one CUDA kernel when there is
one split and two (the splits, then their merge) otherwise; ``launches``
counts calls. The plain counterparts of the two are
:func:`.ref.decode_split_reference` and :func:`.ref.decode_merge_reference`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import ref
from ._build import bind, counted, launch, refuse_autograd

_KERNELS = {torch.float32: "decode_attention_f32",
            torch.bfloat16: "decode_attention_bf16"}
MAX_HEAD_DIM = 256
# query heads a KV head from which the group runs on the tensor cores; the
# CUDA cores take smaller groups (faster at g = 1 and 2, even at 4; PERF.md)
TENSOR_CORE_MIN_GROUP = 8
# An H100's limits: a block may opt into 232,448 bytes of shared memory,
# an SM holds 233,472 and reserves 1 KB of them a block; a block runs at
# most 16 warps (the split kernels' launch bounds), an SM 2048 threads.
_BLOCK_SMEM, _SM_SMEM, _BLOCK_RESERVED = 232448, 233472, 1024
_MAX_WARPS, _SM_THREADS = 16, 2048
# The kernel's shape: on the CUDA cores four teams of one warp, a tile the
# most of 32, 16 and 8 slots whose four two-stage rings fit _RING_BYTES;
# on the tensor cores a warp a 16-head m-tile, a tile of 8 slots, and as
# many heads a block and teams (at most four) as fit _BLOCK_SMEM. Up to
# four blocks an SM on the tensor cores, three on the CUDA cores (where
# three streamed Zamba2's cache faster than four).
_TEAMS, _TC_TILE = 4, 8
_RING_BYTES = 64 * 1024
_BLOCKS_PER_SM = {True: 4, False: 3}

_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int, ctypes.c_float,
                                      ctypes.c_void_p)


class Plan(NamedTuple):
    """One call's launch, in the order of the kernel's ``struct Plan``: the
    shapes; ``splits`` splits of ``split_len`` slots (the last may be
    shorter), each team of a block staging ``tile`` slots at a time
    through a ring of ``stages``; the route; the ``heads`` a block serves
    and the ``hgroups`` blocks a KV head's group spans; the block's ``rows``
    of q, its ``teams`` of ``team_warps`` warps; and its shared memory:
    row strides in elements (``rs`` of the teams' float32 states, ``ks``,
    ``vs``, ``qs`` of the staged K, V and q), offsets and sizes in bytes."""
    b: int
    t: int
    h: int
    kh: int
    d: int
    splits: int
    split_len: int
    tile: int
    stages: int
    tensor_cores: int
    heads: int
    hgroups: int
    rows: int
    teams: int
    team_warps: int
    rs: int
    ks: int
    vs: int
    qs: int
    v_off: int
    tag_off: int
    stage_bytes: int
    team_bytes: int
    q_off: int
    p_off: int
    smem: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _layout(d: int, itemsize: int, tile: int, stages: int, teams: int,
            rows: int, tensor_cores: bool) -> dict:
    """A block's shared memory: each team's ring of ``stages`` tiles (a
    slot's K and V rows and its tag), which takes the teams' states (m, l
    and acc a row) at the end of the split; then q (its TF32 hi and lo
    parts on the tensor cores, as it is on the CUDA cores) and, on the CUDA
    cores, each team's p. Row strides are padded so the fragment loads
    (4 words modulo 32) or the 16-byte row reads (K 16 (32 / tile) bytes
    modulo 128, 32 / tile lanes reading a slot) are free of bank
    conflicts, and the states' rows to 8 words modulo 32."""
    if tensor_cores:
        ks = vs = qs = (_round_up(d, 32) + 4 if itemsize == 4
                        else _round_up(d, 64) + 8)
        rs = d + 2 + (40 - (d + 2) % 32) % 32
    else:
        ks = (_round_up(d * itemsize, 128) + 16 * (32 // tile)) // itemsize
        vs = qs = _round_up(d, 16 // itemsize)
        rs = d + 2
    v_off = tile * ks * itemsize
    tag_off = v_off + tile * vs * itemsize
    stage_bytes = _round_up(tag_off + tile * 4, 16)
    team_bytes = stages * stage_bytes
    q_off = _round_up(max(teams * team_bytes, teams * rows * rs * 4), 16)
    p_off = q_off + _round_up(rows * qs * (8 if tensor_cores else itemsize),
                              16)
    return dict(rs=rs, ks=ks, vs=vs, qs=qs, v_off=v_off, tag_off=tag_off,
                stage_bytes=stage_bytes, team_bytes=team_bytes, q_off=q_off,
                p_off=p_off,
                smem=p_off + (0 if tensor_cores else teams * 8 * 32 * 4))


def _tc_block(g: int, d: int, itemsize: int) -> tuple[int, int, int, int]:
    """(heads, hgroups, team_warps, teams) on the tensor cores: the fewest
    blocks a KV head's group, then the most teams, whose layout (with a
    ring of two) fits a block's shared memory; a warp an m-tile of 16
    heads, at most 16 warps a block."""
    for hgroups in range(1, g + 1):
        heads = -(-g // hgroups)
        warps = -(-heads // 16)
        for teams in range(min(_TEAMS, _MAX_WARPS // warps), 0, -1):
            if _layout(d, itemsize, _TC_TILE, 2, teams, 16 * warps,
                       True)["smem"] <= _BLOCK_SMEM:
                return heads, -(-g // heads), warps, teams
    raise AssertionError("unreachable: 16 heads fit at any D <= 256")


def plan(b: int, t: int, h: int, kh: int, d: int, itemsize: int,
         sms: int) -> Plan:
    """The kernel's launch at these shapes on a card of ``sms`` SMs. It
    reads no tensor, so two calls on the same shapes run the same grid.

    The route: the tensor cores from ``TENSOR_CORE_MIN_GROUP`` heads a KV
    head, else the CUDA cores. The tile: 8 slots on the tensor cores, the
    largest of 32, 16 and 8 whose four teams' rings fit ``_RING_BYTES`` on
    the CUDA cores. The heads a block: on the tensor cores as
    :func:`_tc_block` finds; on the CUDA cores the group. The splits: the
    most (each at least one tile a team) whose blocks fit the card at
    once, as many an SM as shared memory and threads allow, up to
    ``_BLOCKS_PER_SM``. A team's ring holds one tile when it has only one,
    else two.
    """
    g = h // kh
    tc = g >= TENSOR_CORE_MIN_GROUP
    if tc:
        tile = _TC_TILE
        heads, hgroups, team_warps, teams = _tc_block(g, d, itemsize)
        rows = 16 * team_warps
    else:
        tile = next((w for w in (32, 16) if _TEAMS * _layout(
            d, itemsize, w, 2, 1, 0, False)["team_bytes"] <= _RING_BYTES), 8)
        heads, hgroups, team_warps, teams, rows = g, 1, 1, _TEAMS, g
    threads = 32 * team_warps * teams
    pairs = b * kh * hgroups                   # blocks a split
    most = -(-t // (teams * tile))
    for stages in (1, 2):
        smem = _layout(d, itemsize, tile, stages, teams, rows, tc)["smem"]
        per_sm = min(_BLOCKS_PER_SM[tc], _SM_THREADS // threads,
                     _SM_SMEM // (smem + _BLOCK_RESERVED))
        splits = min(most, max(1, per_sm * sms // pairs))
        split_len = -(-t // splits)
        per_team = -(-(-(-split_len // tile)) // teams)
        if per_team <= stages or stages == 2:
            stages = min(stages, per_team)
            return Plan(b, t, h, kh, d, -(-t // split_len), split_len, tile,
                        stages, int(tc), heads, hgroups, rows, teams,
                        team_warps, **_layout(d, itemsize, tile, stages,
                                              teams, rows, tc))
    raise AssertionError("unreachable")


@functools.lru_cache(maxsize=256)
def _launcher(index: int, dtype: torch.dtype, b: int, t: int, h: int,
              kh: int, d: int) -> tuple:
    """What a call at these shapes on CUDA device ``index`` launches with:
    the bound C function, the plan packed as the kernel's ``struct Plan``
    (kept alive here) and its address, and the number of splits."""
    p = plan(b, t, h, kh, d, dtype.itemsize,
             torch.cuda.get_device_properties(index).multi_processor_count)
    packed = (ctypes.c_int * len(p))(*p)
    return (bind("decode_attention", _KERNELS[dtype], _ARGTYPES), packed,
            ctypes.addressof(packed), p.splits)


@counted
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_positions: torch.Tensor,
                     index: torch.Tensor | int, *, window: int = 0,
                     scale: float | None = None) -> torch.Tensor:
    """Returns (B, 1, H, D) in q's dtype."""
    refuse_autograd("decode_attention", q, k, v)
    if q.device.type == "cpu":
        off = torch.as_tensor(index).reshape(-1, 1)
        return ref.mha_reference(q, k, v, causal=True, window=window,
                                 q_offset=off, kv_positions=kv_positions,
                                 scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b = q.shape[0]
    if q.dtype not in _KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q must be (B, 1, H, D) and "
                         f"k, v (B, T, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh < 1 or h % kh:
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if min(b, t, d) < 1 or d > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: needs non-empty shapes and "
                         f"D <= {MAX_HEAD_DIM}, got q {tuple(q.shape)}, "
                         f"cache {tuple(k.shape)}")
    if kv_positions.shape != (b, t) or kv_positions.dtype != torch.int32:
        raise ValueError(f"decode_attention: kv_positions must be int32 "
                         f"({b}, {t}), got {kv_positions.dtype} "
                         f"{tuple(kv_positions.shape)}")
    idx = index
    if not (isinstance(idx, torch.Tensor) and idx.dtype == torch.int32
            and idx.shape == (b,) and idx.device == q.device
            and idx.is_contiguous()):       # else make it so
        idx = torch.as_tensor(index, device=q.device)
        if idx.dtype not in (torch.int32, torch.int64) or idx.numel() not in (
                1, b):
            raise ValueError(f"decode_attention: index must be an integer "
                             f"scalar or ({b},), got {idx.dtype} "
                             f"{tuple(idx.shape)}")
        idx = idx.to(torch.int32).reshape(-1).expand(b).contiguous()
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and kv_positions.is_contiguous()):
        raise ValueError("decode_attention: q, k, v and kv_positions must "
                         "be contiguous")
    if not (q.device == k.device == v.device == kv_positions.device):
        raise ValueError("decode_attention: inputs on different devices")
    scale = d ** -0.5 if scale is None else scale
    dev = q.get_device()
    fn, _, plan_at, splits = _launcher(dev, q.dtype, b, t, h, kh, d)
    out = torch.empty_like(q)
    part = (torch.empty((splits, b, h, d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    launch(fn, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           kv_positions.data_ptr(), idx.data_ptr(), out.data_ptr(),
           0 if part is None else part.data_ptr(), plan_at, int(window),
           float(scale))
    decode_attention.launches += 1
    return out
