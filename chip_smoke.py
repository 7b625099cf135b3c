#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which raises on failure (exit code non-zero):

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc,
   one process per source, all at once; count the tensor-core (HMMA) and
   cp.async (LDGSTS) instructions in the flash-attention, SSD-scan and
   decode-attention libraries where cuobjdump exists, and print the SSD
   scan's and decode attention's ptxas register and spill lines;
2. hold the entropy-judge kernels (K1) against their plain PyTorch
   versions: the sweep, with its emptying conventions, and the greedy
   loop of Alg. 1 in one launch, on random active, protected and cap
   settings with tied duplicate rows, streamed at (64, 151,936), at
   forced grid sizes of 1-132 CTAs at 151,936 classes (streamed up to
   16, resident from 33), and twice on the same inputs (same bits);
3. hold the fused-aggregation kernel (K2) against its plain version, bit
   for bit;
4. drive the paper's FedEntropy round at full width — the CIFAR-shaped
   CNN, N = 100 clients, 10% participation, E = 5, batch 50 — for three
   rounds through the captured client program (one CUDA graph), K1's
   loop kernel (one launch a round, the sweep never) and K2, and show by
   launch counts that it did; run the same rounds with the client
   program eager (``fl.disable_capture()``), which must give the same
   bits, and on the plain versions, which must give equal integer
   records and params within PARAMS_RTOL; time a round of each route in
   turns (captured, eager, captured, eager), profile one round of each,
   and time a new server's first round (warm-up and capture) after 1 and
   after 3 warm-up runs in turns, each repeating round 0 to the bit;
5. time K1's sweep and loop and K2 at the main path's shapes in turns with
   their plain versions and, for K2, the PyTorch library call
   ``w @ flat``; time one whole judgment by route in turns (plain, kernel,
   kernel, plain); print K1's and K2's host microseconds per call by piece
   of the wrapper, the loop's plan at 151,936 classes and its time per
   iteration beside the bytes bound and the floor of its logarithms, the
   forced grid sizes, the sweep per iteration, and the launch floor (an
   empty kernel launched the same way);
6. hold flash attention (K3), decode attention (K4) and the SSD chunk
   scan (K5) against their plain versions, in float32 and bfloat16, at
   the JAX kernel tests' shapes and at the serve paths' (Zamba2-2.7B's;
   qwen3-moe-235b-a22b's 64 query heads over 4 KV heads, 16 on one staged
   tile, and chatglm3-6b's 32 over 2; gemma-7b's head width of 256; K4
   also at T not a multiple of its split and below one tile, a window
   shorter than a split, every valid slot in the first split, a row with
   no valid slot, one split, and groups of 128 heads at D = 128 and 48
   and 64 at D = 256 in one block, 272 over two; K5 with strong decay over 16 chunks; K4 and K5 twice on the same
   inputs, which must give the same bits); and at phase 18's shapes: K3
   not causal over whisper's 1,500 frames (1,500 x 1,500, and 64 and 1
   queries against 1,500 keys), its causal self prefill of 64, and
   internvl2's prefill of 1,024 over 14 heads on 2; K4 at whisper's g = 1
   and internvl2's g = 7, both at D = 64;
7. serve Zamba2-2.7B at full width (random weights, float32): 4 prompts
   of 1024 tokens, then 32 greedy tokens, through ``build_model(...,
   kernels="cuda")``; show by launch counts that K3, K4 and K5 ran, and
   replay the prompts and tokens through the plain route to check the
   logits;
8. time K3, K4 and K5 at the serve path's shapes in turns with their
   plain versions and the PyTorch library call where one exists (SDPA for
   K3 and K4), and print K3's and K5's two bounds: on the CUDA cores and
   on the tensor cores in 3xTF32; print K4's plan (splits, grid, heads
   a block, shared memory, bytes moved, single-read bound) and the
   kernels its profile shows a call run, also at qwen3-moe-235b-a22b's
   decode shape; time K5 once more at L = 8192 (32 chunks);
9. drive the paper's other compositions at the same width: moon (K1's
   loop and K2) and scaffold (K1's loop), three captured rounds each with
   launch counts, then on the plain route, which must give equal integer
   records (a verdict split where the two choices differ by less than
   float32's spacing at the entropy is printed and followed, ROADMAP F5)
   and params within PARAMS_RTOL; then the legacy ``FedEntropyTrainer``
   shim for one round of each golden variant's settings (K1's loop once
   for each judged variant, K2 once except for scaffold, finite params
   and its uplink bytes);
10. drive the pipelined engine (``fl.runtime.PipelinedServer``) at the
   same width, captured, each run against the sequential ``Server`` on
   the same route (the float64 oracle, ``FusedAverageAggregator`` on K2),
   which it must equal bit for bit in records, entropy and params:
   fedentropy with ``RuntimeConfig(speculate=True, spec_backend="cuda")``
   for 5 rounds (each round's verdict speculated in one launch of K1's
   loop and aggregated in K2; each round's ``spec_hit``/``redispatched``
   and launches printed, and for each miss the float64 gap where K1 and
   the oracle part, ROADMAP F5; then the host microseconds of the float64
   oracle, which speculation hides, and of the selector copy and draw,
   which it adds); the same with a traced form that admits
   everyone (every rejecting round misses and re-aggregates in K2);
   ``fedentropy+queue`` for 3 rounds (the queue must withhold data at
   round 0); a ``drift_schedule`` event (half the clients) at round 2 of
   4, across which round 1 must not speculate. Then time the pipelined
   and the sequential round in turns (pipelined, sequential, sequential,
   pipelined; 6 rounds on a new server each, no synchronise between
   rounds, the median of rounds 2-5) and profile one round of each for
   the device's idle share.
11. drive FedCAT at the same width with chains of 2 (5 a round), the
   chain program captured as one CUDA graph, devconcat merging leaf by
   leaf (no K2): ``fedcat`` and ``fedcat+maxent`` (judged by K1's loop,
   one launch a round) for 3 rounds each, equal bit for bit to the same
   rounds under ``fl.disable_capture()``, and ``fedcat+maxent`` on the
   plain judge under phase 9's rule; ``fedcat`` at group size 1 against
   ``fedavg`` on the same uniform stream (bit for bit, or the largest
   difference printed with the records equal); ``fedcat+maxent`` on the
   pipelined engine for 5 rounds, speculating in K1's loop, and with the
   traced form that admits everyone, each equal to the sequential server
   bit for bit; then fedcat+maxent's and fedentropy's round in turns and
   one profiled round of each.
12. drive the async buffered engine (``fl.runtime.AsyncBufferedServer``)
   at the same width, captured, admission judged in K1's loop and flushes
   aggregated in K2: ``AsyncConfig()`` for 3 flushes, equal bit for bit to
   the sequential ``Server`` on the same route; the golden's straggler
   clock (α = 0.5) for 3 flushes, equal bit for bit to the same run under
   ``fl.disable_capture()`` (each dispatch's outputs are cloned before a
   later cohort's replay overwrites them) and, on the plain judge, under
   phase 9's rule; each flush prints its K1 launches (and how many ran
   over a protected buffer), K2 launches, staleness and buffer occupancy;
   ``fedcat+maxent`` and a drift schedule must be refused; then a
   straggler flush beside phase 4's round in turns.
13. drive clusters (the K-center ``ModelBank``) at the same width:
   ``ifca+maxent`` at K = 3 with a drift of half the clients at round 2 of
   4, judged per cluster in K1's loop and merged by ``perclstr`` over K2
   (K launches a round), equal bit for bit to the eager route and, on the
   plain route, under phase 9's rule; the pipelined engine on the same
   run, speculating per cluster, and with the admit-all traced form, each
   equal to the sequential server bit for bit; ``fesem`` pipelined for 3
   rounds against sequential; ``ifca+maxent`` at K = 1 against
   fedentropy bit for bit; the IFCA assignment program's time; then a
   clustered round beside fedentropy's in turns and one profiled round of
   each.
14. drive the scan engine (``fl.runtime.ScanServer``) at the same width
   with ``FusedAverageAggregator("cuda")``: ``fedentropy-traced`` (the
   eps-greedy pools on the threefry stream) in blocks of 4 rounds, each
   block one captured CUDA graph holding the cohort draw, the gather, the
   client program, K1's loop and K2 of every round, 8 rounds in
   ``"stack"`` and in ``"remat"`` mode, each equal bit for bit to the
   sequential ``Server`` and to the same blocks run eagerly
   (``fl.disable_capture()``), with each block's K1 and K2 launches
   (counted per replay), each graph's capture time and each natural
   miss's float64 gap; the same with the traced form that admits
   everyone (every rejecting round misses and cuts its block; each depth
   is captured once, and the second block's time is a block's after a
   miss), with each block graph's pool memory; in ``"remat"``, a traced
   form that misses only one-removal rounds, so blocks are cut after
   confirmed rounds and rewound by a shorter block; ``fedavg``
   with host-drawn cohorts against sequential and with the device's
   threefry draw captured against eager; ``fedentropy`` (numpy pools)
   falling back to sequential rounds with its reason. Then, on the warm
   ``"stack"`` and sequential servers of the first run, a block of 4
   against 4 sequential rounds in turns, and one profiled block (its K1
   and K2 kernels in the trace held against the counts) and 4 profiled
   sequential rounds for the device's idle share; the two servers are
   then held equal again.
15. drive the streaming data plane at the same width over N = 1000
   clients of 500 uint8 samples each (phase 4's images quantised once,
   rows repeated across clients; 1.54 GB, over the 1 GiB resident
   budget, so ``data_plane="auto"`` streams it) with
   ``cifar10_normalizer()``: 3 rounds of fedentropy (K1's loop, K2) on
   the streaming, memory-mapped (``HostCorpus.save``/``open``) and
   resident planes, bit for bit, with the device bytes each corpus
   allocates and its ``memory_report()``; the pipelined engine on the
   streaming plane for 5 rounds (round t+1's cohort gathered into pinned
   memory and copied on a side stream by the prefetch thread while the
   oracle runs) against the sequential server bit for bit, prefetch hits
   equal to speculation hits, and with the admit-all traced form (each
   miss cancels its staged cohort); a capture while a prefetch is in
   flight; one cohort's host gather and copy times; the sequential and
   the pipelined round on the streaming and resident planes in turns.
16. LM training: ``launch.train``'s entry point (``main``, the command
   ``python -m repro_torch.launch.train --arch qwen3-0.6b --steps 3
   --clients 8 --judge-backend cuda``) runs the gradient-level FedEntropy
   step at qwen3-0.6b's full configuration (28 layers, 596,180,992
   float32 params, 8 clients x 2 windows of 129 tokens a step, the torch
   kernel route): K1's loop judges the (8, 152,064) soft labels inside
   each step, 3 launches in 3 steps, and nothing else launches; the peak
   device memory is printed beside its reckoning. The same 3 steps from
   the same params on the torch route, each verdict held against K1's
   loop on the same soft labels (a split only at a float32 tie, printed
   and followed, ROADMAP F5), must give equal masks, the loss and the
   gradient norm within a relative 1e-6 and the entropies within
   K1_ATOL; one more step is timed and profiled (idle share). Then
   lmstep (``fl.LMWindowStrategy`` over ``train.lm_window_apply``) at
   qwen3-0.6b's widths cut to 4 layers (218,638,336 params), 8 logical
   clients of 8 windows of 129 tokens, cohorts of 4, E = 1, K2
   aggregating: 3 rounds on the sequential server (K2 3) and on the
   pipelined engine speculating in K1's loop (K1 3, K2 3 + misses), each
   client program one CUDA graph, equal bit for bit, under the config's
   remat "full" (recomputed under ``torch.func``), the sequential
   server's graph dropped before the pipelined engine captures, each
   one's peak printed; one captured sequential round each under remat
   "none" and "full" with the gradient through ``vjp`` and through
   ``grad``, equal bit for bit, with their peaks; K1's loop at (8,
   152,064) and (4, 152,064) and K2 at (4, 218,638,336) timed in turns
   with their plain versions (and ``w @ flat``) beside their bytes
   bounds; at the reduced config the async engine (zero clock, K1 and K2
   a flush) and the scan engine (blocks of 2 captured, pools-traced)
   equal the sequential server bit for bit; and the cuda route of
   ``ops.attention`` and ``ops.ssd`` refuses tensors that require grad.
17. serve qwen3-moe-235b-a22b at its published widths (d_model 4096, 64
   heads of 128 over 4 KV heads, 128 experts of d_ff 1536, top 8, vocab
   151,936 padded to 152,064, untied) cut to 4 of its 94 layers,
   11,196,732,416 float32 params from a seed, one copy on the card: 4
   prompts of 1024 tokens, then 32 greedy tokens, through
   ``build_model(..., kernels="cuda")``, the reference's sort-based
   capacity dispatch in every layer; K3 4 launches, K4 124 and nothing
   else. The same model replays the prompts and tokens on the plain
   route (``Transformer.kernels`` switched): each layer's routing
   integers (top-k expert sets, positions in expert, dropped counts)
   must equal the kernel route's, except at a split, a token at a tie of
   its k-th and (k+1)-th experts at LOGITS_RTOL (its router input equal
   on both routes within LOGITS_RTOL, the two experts' float64
   probabilities within LOGITS_RTOL of each other), which is printed
   with float32's spacing at the probability, and everything downstream
   of it left out of the comparisons; logits within LOGITS_RTOL
   elsewhere. Prefill cold and
   warm, decode ms per step, a profile of the prefill and its stages
   (routing and dispatch, expert products, combine, attention, head) by
   CUDA events, the memory before the phase and its peak, and K3 and K4
   at this model's shapes in turns with their plain versions and SDPA
   (K4 also its plan and the kernels its profile shows a call run).
18. serve whisper-large-v3 (32 encoder and 32 decoder layers, d_model
   1280, 20 heads of 64, 1,535,636,480 params) and internvl2-1b (24
   layers, d_model 896, 14 heads over 2, 494,720,896 params) at their
   published widths and full depth, float32, random weights from a seed,
   through ``build_model(..., kernels="cuda")``: 4 utterances of 1,500
   random frames with prompts of 64 tokens, and 4 x 256 random patches
   with prompts of 768 tokens, each then 32 greedy tokens. The parameter
   counts must equal the reference's; K3 runs the encoder, the self and
   cross prefill and the cross attention of every decode step (whisper:
   32 + 32 + 32 + 32 x 31 = 1,088 launches; internvl2: 24), K4 every
   decoder layer's decode step (992 and 744), and nothing else launches.
   The same module replays the requests on the plain route, logits within
   LOGITS_RTOL; prefill cold and warm, decode ms per step, a profile of
   the prefill and of a decode step, the memory before each model and
   its peak, and K3 and K4 at these shapes in turns with their plain
   versions and SDPA, beside their bounds.
19. train the moe, vlm and encdec families through ``train.main``'s
   mesh step (8 clients, 3 steps, K1's loop judging each step's soft
   labels, 3 launches and nothing else, the parameter counts the
   reference's): whisper-large-v3 at full width and depth on the
   blockwise route with remat "full" (8 x 1 utterance of 1,500 zero
   frames and 129 tokens), internvl2-1b at full width and depth with
   remat "full" (8 x 2 windows of 129 tokens after 256 patches of one
   random draw: zero patches overflow its gradient at 24 layers) and
   qwen3-moe-235b-a22b at its published widths cut to 1 of 94 layers
   (3,733,467,392 params, 8 x 2 windows, each step's dropped assignments
   and aux loss; the forward's routing and the recomputation's must
   drop alike); each step's seconds, one more step profiled, the peak
   above the phase's start beside its reckoning. whisper at 4 + 4 layers
   three times from the same params, torch + "none", blockwise + "full"
   and torch + "full": masks equal (a split only at a float32 tie,
   followed), loss and gradient norm within TRAIN_RTOL; internvl2 again
   with the plain judge under phase 16's rule; internvl2's lmstep at 4
   layers: one captured sequential round at 4 windows a client under
   remat "none" and "full", each with the gradient through ``vjp`` and
   through ``grad``, equal bit for bit, with their peaks;
   the client program at 8 windows reckoned on the meta device
   (``launch.cost_analysis``); then at 8 windows sequential (K2 3) and
   pipelined (K1 3, K2 3 + misses), equal bit for bit; one whisper
   lmstep round at 4 + 4 layers (K2 1); qwen3-moe's lmstep at 1 layer
   reckoned on the meta device at internvl2's cohort and windows, run
   for a round only below LMSTEP_FIT_GIB (it reckons far above one
   card).
21. run the example twins' ``main`` on the card at their defaults:
   ``examples/torch_quickstart.py`` (16 round lines),
   ``torch_compare_strategies.py`` (4 rows),
   ``torch_fl_llm_finetune.py --verify --kernels cuda`` (8 rounds in
   scan blocks of 4, equal to the sequential server bit for bit; K1 and
   K2 at least once a round) and ``torch_serve_lm.py --kernels cuda`` (K3, K4 and K5
   launched; greedy tokens equal to ``--kernels torch``'s), each line
   echoed and held to the reference example's pattern.
22. the client axis over several shards at the main path's width (phase
   4's fedentropy, the pipelined engine, speculation through K1's loop,
   ``FusedAverageAggregator("cuda")``, three rounds; a sharded server
   lays out its own copy of phase 4's corpus):
   ``RuntimeConfig(shard=True)`` on a mesh of the one card, bit for bit
   the unsharded pipelined engine; on
   a mesh of three shard positions on that card (the corpus padded to
   102 rows, 34 a block, the cohort to 12, 4 a shard, one captured graph
   a shard), integer records equal to the sequential server's, and
   records and params bit for bit those of a sequential server whose
   program runs the same three blocks in turn (``blocked_server``; the
   params' distance from the plain sequential server's is printed and
   held within SHARD_PARAMS_RTOL: the vmap's width moves cuDNN's sums);
   ``fedcat+maxent`` on the three-shard mesh (5 chains of 2 padded to 6
   groups, 2 a shard), the same two checks; the round wall s of the
   unsharded, one-card and three-shard engines in turns (the servers of
   the checks, run on), the graphs a shard, the bytes the cohort
   gathers copied between shard blocks a round, the corpus's
   ``device_nbytes()`` and each block's bytes, and K1 and K2 launches,
   each beside the card's name and power limit. With more than one card
   visible it also runs the one-shard-per-card mesh against the
   sequential server; on one card it says so.
20. serve gemma-7b (28 layers, d_model 3072, 16 heads of 256, vocabulary
   256,000), granite-8b (36 layers, 32 heads over 8 of 128) and
   chatglm3-6b (28 layers, 32 heads over 2 of 128) at their published
   widths and full depth, float32, one at a time, as phase 18 serves
   its two: 4 prompts of 1024 tokens, 32 greedy tokens; the parameter
   counts the reference's and the dry-run's meta build's; K3 once a
   layer (28, 36, 28), K4 once a layer a decode step (868, 1,116, 868);
   logits within LOGITS_RTOL of the plain route; beside each model's
   measured peak, the dry-run's reckoning of the same prefill on the
   plain route (``launch.dryrun``'s counter over the meta build): its
   argument bytes equal to the weights' and the batch's on the card, and
   its peak above them within DRY_RTOL of ``max_memory_allocated()``
   above the memory allocated before the plain-route prefill; K3 and K4
   at the three models' shapes in turns with their plain versions and
   SDPA, beside their bounds.

Each path is driven with every kernel's launch count set to 0 just before
it and read just after.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
a JSON object with every kernel's launches, error, times (``ms`` per
wrapper call, ``kernel_ms`` of device time by the profiler, or
``kernel_ms_events`` where no profile kept 90% of the launches and CUDA
events timed the queued calls) and bounds. K1's loop and K2
also carry ``launches_by_path``: ``fedentropy`` (phase 4), ``moon`` and
``scaffold`` (phase 9), phase 10's ``pipelined``, ``pipelined+miss``
and ``fedentropy+queue``, phase 11's ``fedcat``, ``fedcat+maxent``,
``fedcat+maxent pipelined`` and ``fedcat+maxent pipelined+miss``, phase
12's ``async``, ``async straggler`` and ``async straggler+plain``,
phase 13's ``ifca+maxent``, ``ifca+maxent pipelined``,
``ifca+maxent pipelined+miss`` and ``fesem``, and phase 14's ``scan``,
``scan remat``, ``scan+miss``, ``scan remat+miss``, ``scan remat+rewind``
and ``scan fedavg``
(a block's launches include the eager run before its first capture), and
phase 15's ``streaming``, ``streaming pipelined`` and ``streaming
pipelined+miss``, and phase 16's ``lm mesh step``, ``lmstep sequential``,
``lmstep pipelined``, ``lmstep async`` and ``lmstep scan``, and phase
19's ``whisper mesh step``, ``whisper lmstep sequential``, ``internvl2
mesh step``, ``internvl2 lmstep sequential``, ``internvl2 lmstep
pipelined`` and ``qwen3-moe mesh step``, and phase 21's
``torch_fl_llm_finetune example``, and phase 22's ``shard one-card
mesh``, ``shard three shards`` and ``fedcat+maxent three shards``; they
also
carry ``lm_shapes``, phase 16's times at the LM shapes. K3 and K4 carry
``launches_by_path`` (``zamba2 serve``, phase 7, ``qwen3-moe serve``,
phase 17, ``whisper serve`` and ``internvl2 serve``, phase 18,
``gemma serve``, ``granite serve`` and ``chatglm3 serve``, phase 20,
``torch_serve_lm example``, phase 21; K5 the first and the last) and
``lm_shapes``, the times of phases 17, 18 and 20 at those models' shapes
(``whisper cross decode`` among them: one query against 1,500 keys); K4 also ``profiled_launches`` and ``kernels_per_call`` at both
serve decode shapes, from phase 8's kernel-alone profiles: the launches
of its split pass and of its merge that each kept over the calls
profiled, and the kernels a call ran by them (``launches`` counts
calls).
Exits non-zero, printing no result, when no CUDA device is present.

``python3 chip_smoke.py --k4-turns DIR`` times K4 and Zamba2-2.7B's
decode step of this checkout's package against DIR's (another checkout,
for example the parent commit unpacked by ``git archive``) on one card,
in turns (this, DIR, DIR, this), each in a process of its own
(``--k4-time --src``), and prints one JSON line of both.
``python3 chip_smoke.py --k1-turns DIR`` does the same for K1 (``--k1-time
--src``): the loop at the warp route's shapes (K1_WARP_SHAPES), at (8,
152,064), (4, 152,064) and (10, 151,936), and the sweep at (10, 10), µs
a call queued on the device and host µs; it fails unless the warp
route's packed output equals DIR's bit for bit at each of its shapes.
``python3 chip_smoke.py --width-gap`` shows what the vmap's width alone
does to the bits at phase 4's width (:func:`width_gap`): the client
program on 4 and on 1 of a cohort's rows against its 10-client run, and
the three-shard fan-out, which must equal its blocks' program bit for
bit.
Imports neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree as pytree

# the package: this checkout's, or with --src another's (--k4-time)
sys.path.insert(0, sys.argv[sys.argv.index("--src") + 1]
                if "--src" in sys.argv[:-1] else
                str(Path(__file__).resolve().parent / "src"))

from repro_torch import fl  # noqa: E402
from repro_torch.fl import graph_cache  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.entropy import group_entropy_np  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    FedSpec, make_train_step)
from repro_torch.core.judgment import (  # noqa: E402
    _TOL as TOL, judge, judge_np)
from repro_torch.data.corpus import ClientCorpus  # noqa: E402
from repro_torch.data.partition import (  # noqa: E402
    drift_schedule, partition)
from repro_torch.data.synthetic import make_image_dataset  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, entropy_judge, fused_aggregate, ref)
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels import decode_attention as k4  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.entropy_judge import (  # noqa: E402
    entropy_judge_loop, entropy_judge_sweep)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fused_aggregate import (  # noqa: E402
    masked_weighted_sum)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    LAUNCHES_PER_CALL as K5_LAUNCHES_PER_CALL, ssd_chunked)
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.dryrun import PARAM_COUNTS, count_call  # noqa: E402
from repro_torch.launch.time_judge import judgment_ms  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, float32 outside the
# tensor cores, TF32 on the tensor cores (dense).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

K1_ATOL = 1e-4          # the JAX package's kernel-test tolerance
PARAMS_RTOL = 1e-5      # cuda-route vs plain-route global params
ROUNDS = 3
# tests/test_kernels.py's tolerances for K3, K4, K5: (atol, rtol) by dtype
K3_TOL = {torch.float32: (2e-5, 1e-2), torch.bfloat16: (5e-2, 1e-2)}
K4_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (5e-2, 0.0)}
K5_TOL = {torch.float32: (2e-4, 5e-2), torch.bfloat16: (5e-1, 5e-2)}
# the kernels of K5's three passes, by name
K5_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
              "ssd_chunk_out_kernel")
# K4's split pass and, when a call has more than one split, its merge
K4_KERNELS = ("decode_split", "decode_merge")
# serve path: Zamba2-2.7B, B prompts of S tokens, then GEN greedy tokens
SERVE_ARCH, SERVE_B, SERVE_S, SERVE_GEN = "zamba2-2.7b", 4, 1024, 32
LOGITS_RTOL = 1e-4      # kernel vs plain route, of max |logit|
# phase 17: qwen3-moe-235b-a22b cut to MOE_LAYERS of its 94 layers at its
# published widths; the parameter count is jax.eval_shape's of the
# reference's init at that depth
MOE_ARCH, MOE_LAYERS, MOE_PARAMS = "qwen3-moe-235b-a22b", 4, 11_196_732_416
MOE_B, MOE_S, MOE_GEN = 4, 1024, 32
# phase 18: whisper-large-v3 and internvl2-1b at full width and depth,
# FAM_B requests of FAM_GEN greedy tokens each: whisper over WHISPER_T
# frames with prompts of WHISPER_S tokens (inside its 448-token decoder
# context), internvl2 over VLM_P patches with prompts of VLM_S tokens (a
# cache of VLM_T slots); the parameter counts are jax.eval_shape's of the
# reference's init
FAM_B, FAM_GEN = 4, 32
WHISPER_T, WHISPER_S = 1500, 64
VLM_P, VLM_S = 256, 768
VLM_T = VLM_P + VLM_S + FAM_GEN
FAM_ARCHS = ("whisper-large-v3", "internvl2-1b")
# phase 20: the dense models at full width and depth, phase 17's requests
# (FAM_B = MOE_B, FAM_GEN = MOE_GEN); the dry-run's peak above the
# arguments against the card's, relative
DENSE_ARCHS = ("gemma-7b", "granite-8b", "chatglm3-6b")
DRY_RTOL = 0.10

WRAPPERS = {"entropy_judge_sweep": entropy_judge_sweep,
            "entropy_judge_loop": entropy_judge_loop,
            "masked_weighted_sum": masked_weighted_sum,
            "flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "ssd_chunked": ssd_chunked}


def _reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


_START = time.perf_counter()


def _phase(name: str) -> None:
    print(f"\n== {name} (at {time.perf_counter() - _START:.1f} s)",
          flush=True)


def _time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events, warm caches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_turns(fns: dict, **kw) -> dict:
    """Mean ms per call of each function of ``fns``, measured in turns:
    the others first and the kernel (the first entry) in the middle, then
    back again (plain, library, kernel, kernel, library, plain)."""
    order = list(fns)[1:] + list(fns)[:1]
    times = {name: [] for name in fns}
    for name in order + order[::-1]:
        times[name].append(_time_ms(fns[name], **kw))
    return {name: sum(ts) / len(ts) for name, ts in times.items()}


def _kernel_us(prof, names=(), counts: dict | None = None) -> dict:
    """Device microseconds by kernel name from a finished profiler, for
    kernels (and copies) whose name contains one of ``names`` (all when
    empty). Operator rows are skipped: they repeat their kernels' time.
    ``counts``, when given, receives each name's recorded launches."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:                               # older torch
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and (not names or any(n in e.key for n in names)):
            out[e.key] = out.get(e.key, 0.0) + us
            if counts is not None:
                counts[e.key] = counts.get(e.key, 0) + e.count
    return out


def _busy_s(prof) -> float:
    """Seconds in which at least one kernel ran, from a finished
    profiler's device kernel intervals (their union: kernels that
    overlap, as the branches of a CUDA graph may, count once)."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def _queued_ms(fn, iters: int = 50) -> float:
    """Device time per call of everything ``fn`` launches: CUDA events
    around ``iters`` calls queued behind a kernel that sleeps longer than
    the host takes to launch them, so the card runs them back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)          # about 25 ms at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the port's kernels by name (the launches the wrappers' counters count)
PORT_KERNELS = ("judge_loop", "masked_weighted_sum",
                "flash_fwd", *K4_KERNELS, *K5_KERNELS, "empty_kernel")


class DeviceMs(float):
    """A device time in ms and how it was taken (``by``): "profiler", the
    kernels' own device time, or "events", CUDA events around everything
    a call launches (:func:`_queued_ms`). The kernels line reports the
    first as ``kernel_ms`` and the second as ``kernel_ms_events``."""

    def __new__(cls, ms: float, by: str):
        obj = super().__new__(cls, ms)
        obj.by = by
        return obj


def _kernel_ms_key(dev: DeviceMs) -> str:
    return "kernel_ms" if dev.by == "profiler" else "kernel_ms_events"


def _device_ms(fn, names, iters: int = 50, tries: int = 3,
               per_count: int = 1, kept: dict | None = None) -> DeviceMs:
    """Device time per call, in ms, of the kernels ``fn`` launches whose
    names contain one of ``names`` (every kernel when empty;
    torch.profiler, warm caches). ``per_count``: the kernels a counted
    launch runs (K4 counts a call of two kernels as one launch).
    ``kept``, when given, receives the launches of the port's kernels, by
    kernel name, that the last profile taken kept.

    The profiler can keep fewer kernels than were launched: kineto counts
    the rest out of its window. Late in a long run it kept 8 of 10 of
    K3's launches and 1 of 20 of K1's loop at (8, 152064); host idle time
    before and after the calls, and host markers at both ends with host
    activity recorded, kept no more. So the wrappers' counters, set to 0
    just before each profile, say how many of the port's kernels ``fn``
    launched (``iters`` a name for a kernel no wrapper counts); a profile
    that keeps fewer is printed. One that keeps at least 90% of them
    gives its kernel time scaled by launched / kept; one that keeps fewer
    is taken again after a pause, up to ``tries`` times. When none keeps
    enough, the time of everything ``fn`` launches, queued behind a
    sleeping kernel, stands in, with ``by="events"``. Raises if a name
    matches no kernel of a profile that kept its launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        if attempt:
            time.sleep(1.0)
        _reset_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        made = (sum(_read_counts().values()) * per_count or
                iters * max(1, len(names)))
        counts = {}
        _kernel_us(prof, names or PORT_KERNELS, counts)
        if kept is not None:
            kept.clear()
            _kernel_us(prof, PORT_KERNELS, kept)
        n_kept = sum(counts.values())
        if n_kept < made:
            print(f"(torch.profiler kept {n_kept} of {made} launches of "
                  f"{names or 'the port kernels'}; attempt {attempt + 1} "
                  f"of {tries})")
        if n_kept >= 0.9 * made:
            break
    else:
        ms = _queued_ms(fn, iters)
        print(f"(no profile kept 90% of the launches: {ms:.5f} ms by CUDA "
              f"events behind a sleeping kernel, for "
              f"{names or 'every kernel'})")
        return DeviceMs(ms, "events")
    by_kernel = _kernel_us(prof, names)
    missing = [n for n in names if not any(n in k for k in by_kernel)]
    if missing or not by_kernel:
        raise AssertionError(f"no kernel named {missing or names} in the "
                             f"profile; kernels seen: "
                             f"{sorted(_kernel_us(prof))}")
    return DeviceMs(sum(by_kernel.values()) * made / n_kept / iters / 1e3,
                    "profiler")


def _bound_ms(nbytes: float, flops: float,
              flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """(least ms, what bounds it) for moving ``nbytes`` and doing ``flops``
    at ``flop_per_s`` (float32 outside the tensor cores by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _k1_inputs(m, c, seed, dtype=torch.float32, mask=None):
    rng = np.random.default_rng(seed)
    soft = rng.dirichlet(np.full(c, 0.3), size=m)
    sizes = rng.integers(10, 500, m).astype(np.float32)
    if mask is None:
        mask = (rng.random(m) < 0.7).astype(np.float32)
        mask[rng.integers(m)] = 1.0
    dev = torch.device("cuda")
    return (torch.tensor(soft, dtype=dtype, device=dev),
            torch.tensor(sizes, device=dev),
            torch.tensor(mask, dtype=torch.float32, device=dev))


def check_k1_sweep() -> float:
    worst = 0.0
    cases = [((10, 10), torch.float32, None), ((8, 10), torch.float32, None),
             ((16, 1000), torch.float32, None),
             ((10, 517), torch.float32, None),
             ((32, 4096), torch.float32, None),
             ((10, 151936), torch.float32, None),
             ((16, 1000), torch.bfloat16, None),
             ((8, 152064), torch.bfloat16, None),
             ((10, 10), torch.float32, "single"),
             ((10, 10), torch.float32, "empty"),
             ((10, 4096), torch.float32, "single"),
             ((10, 4096), torch.float32, "empty")]
    for i, ((m, c), dtype, special) in enumerate(cases):
        mask = None
        if special == "single":
            mask = np.zeros(m, np.float32)
            mask[3] = 1.0
        elif special == "empty":
            mask = np.zeros(m, np.float32)
        soft, sizes, mk = _k1_inputs(m, c, seed=i, dtype=dtype, mask=mask)
        ent_k, loo_k = entropy_judge_sweep(soft, sizes, mk)
        ent_p, loo_p = ref.entropy_judge_sweep_reference(soft, sizes, mk)
        torch.cuda.synchronize()
        err = max(float((ent_k - ent_p).abs()),
                  float((loo_k - loo_p).abs().max()))
        label = f"({m}, {c}) {str(dtype).split('.')[-1]}" + (
            f" mask={special}" if special else "")
        print(f"K1 {label}: max_abs_err={err:.3e}")
        if not err <= K1_ATOL:
            raise AssertionError(f"K1 {label} disagrees with its plain "
                                 f"version: {err} > {K1_ATOL}")
        if special == "single":
            if not (float(loo_k[3]) == -1.0 and
                    bool((loo_k[mk == 0] == ent_k).all())):
                raise AssertionError("K1 single-device conventions broken")
        if special == "empty":
            if not (abs(float(ent_k) - math.log(c)) < 1e-6 and
                    bool((loo_k == -1.0).all())):
                raise AssertionError("K1 empty-set conventions broken")
        worst = max(worst, err)
    return worst


def _loop_inputs(m, c, seed):
    """K1 loop inputs on the card: Dirichlet(0.3) rows with rows 1 and
    m - 1 equal outliers (a tie: the first index must win) and, by seed
    % 3, everything active and nothing protected, random active and
    protected rows, or protected rows and a cap of 2."""
    rng = np.random.default_rng(seed)
    soft = rng.dirichlet(np.full(c, 0.3), size=m).astype(np.float32)
    sizes = rng.integers(10, 500, m).astype(np.float32)
    if m > 2:
        soft[[1, m - 1]] = 0.1 / c
        soft[[1, m - 1], 3] += 0.9
        sizes[[1, m - 1]] = 450.0
    active = protected = cap = None
    if seed % 3 == 1:
        active = (rng.random(m) < 0.8).astype(np.float32)
        active[[0, 1, m - 1]] = 1.0
    if seed % 3:
        protected = (rng.random(m) < 0.2).astype(np.float32)
        protected[[1, m - 1]] = 0.0
    if seed % 3 == 2:
        cap = 2
    t = lambda a: None if a is None else torch.tensor(a, device="cuda")
    return t(soft), t(sizes), t(active), t(protected), cap


def _split_margin(args, order_k, order_p) -> tuple[int, float]:
    """Where two removal orders on the same inputs part, and by how much
    the two choices differ in float64: (step, |gap|). At a step where both
    remove a device, the gap is between the group entropies after either
    removal; where one stops and the other removes, it is the removal's
    improvement less the 1e-6 margin of Alg. 1."""
    soft, sizes, active, _, _ = args
    p64 = soft.double().cpu().numpy()
    s64 = sizes.double().cpu().numpy()
    mask = (np.ones(len(s64)) if active is None
            else active.double().cpu().numpy())
    step = next(i for i in range(len(mask) + 1)
                if i >= len(order_k) or i >= len(order_p)
                or order_k[i] != order_p[i])
    mask[list(order_k[:step])] = 0.0

    def without(k):
        trial = mask.copy()
        trial[k] = 0.0
        return group_entropy_np(p64, s64, trial)

    if step < len(order_k) and step < len(order_p):
        return step, abs(without(order_k[step]) - without(order_p[step]))
    k = (order_k if step < len(order_k) else order_p)[step]
    return step, abs(without(k) - group_entropy_np(p64, s64, mask) - TOL)


def _loop_kernel_of(m: int, c: int, ctas: int | None = None) -> str:
    """Which kernel the loop runs at this shape, the CTA count forced or
    not: "four warps" or "grid of G CTAs of S classes, resident" (or
    "streamed")."""
    pl = entropy_judge.plan(m, c, ctas)
    if pl.kernel == "warp":
        return "four warps"
    return (f"grid of {pl.ctas} CTAs of {pl.slice} classes, "
            f"{'resident' if pl.resident else 'streamed'}")


def _loop_err(label, got, want, args) -> float:
    """Verdicts equal (mask, order, number removed) or raise; returns the
    larger entropy error. One exception, printed: the orders part at a
    step whose two choices differ by less than Alg. 1's own 1e-6 margin
    in float64 — a tie that float32 sums in another order decide either
    way (repro's xla and pallas routes part on such inputs too); then the
    orders must agree before it, and the entropies within K1_ATOL."""
    g, w = ref.unpack_judgment(got), ref.unpack_judgment(want)
    same = (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
            and int(g[2]) == int(w[2]))
    err = max(abs(float(g[3]) - float(w[3])), abs(float(g[4]) - float(w[4])))
    print(f"K1 loop {label}: removed {int(g[2])} "
          f"{g[1][:int(g[2])].tolist()}, entropy {float(g[3]):.6f}, "
          f"max_abs_err={err:.3e}")
    if not same:
        order_k = g[1][:int(g[2])].tolist()
        order_p = w[1][:int(w[2])].tolist()
        step, gap = _split_margin(args, order_k, order_p)
        if not gap < TOL:
            raise AssertionError(f"K1 loop {label}: verdicts differ from the "
                                 f"plain version at step {step} by {gap} in "
                                 f"float64: {order_k} vs {order_p}")
        print(f"  float32 tie: the plain version parts at step {step} "
              f"({order_p[step:step + 3]}...), where the two choices differ "
              f"by {gap:.3e} < {TOL} in float64; orders equal before it")
    if not err <= K1_ATOL:
        raise AssertionError(f"K1 loop {label}: entropies differ from the "
                             f"plain version: {err} > {K1_ATOL}")
    return err


def check_k1_loop() -> float:
    """The loop kernel against its plain version: every shape with three
    settings each (the last streamed), one active row and an empty active
    set, forced grid sizes at 151,936 and 10 classes, and two calls on
    the same inputs."""
    worst = 0.0
    shapes = [(10, 10), (8, 10), (100, 10), (16, 1000), (10, 517),
              (32, 4096), (10, 151936), (64, 151936)]
    for i, (m, c) in enumerate(shapes):
        for seed in range(3):
            args = _loop_inputs(m, c, 3 * i + seed)
            got = entropy_judge_loop(*args)
            want = ref.entropy_judge_loop_reference(*args)
            torch.cuda.synchronize()
            kernel = _loop_kernel_of(m, c)
            worst = max(worst, _loop_err(f"({m}, {c}) setting {seed}, "
                                         f"{kernel}", got, want, args))
    soft, sizes, _, _, _ = _loop_inputs(10, 10, 0)
    for label in ("single", "empty"):
        active = torch.zeros(10, device="cuda")
        if label == "single":
            active[3] = 1.0
        got = entropy_judge_loop(soft, sizes, active)
        want = ref.entropy_judge_loop_reference(soft, sizes, active)
        worst = max(worst, _loop_err(f"(10, 10) active={label}", got, want,
                                     (soft, sizes, active, None, None)))
        _, _, removed, ent, init = ref.unpack_judgment(got)
        if int(removed) != 0 or float(ent) != float(init):
            raise AssertionError(f"K1 loop {label}: removed a device")
        if label == "empty" and abs(float(init) - math.log(10)) > 1e-6:
            raise AssertionError("K1 loop empty set: entropy is not ln C")
    for m, c, sizes in ((10, 151936, (1, 2, 4, 8, 16, 33, 66, 132)),
                        (10, 10, (1, 2, 3))):
        args = _loop_inputs(m, c, 0)
        want = ref.entropy_judge_loop_reference(*args)
        for ctas in sizes:
            got = entropy_judge_loop(*args, _ctas=ctas)
            worst = max(worst, _loop_err(
                f"({m}, {c}) forced {_loop_kernel_of(m, c, ctas)}", got,
                want, args))
    for m, c in ((10, 10), (100, 10), (10, 151936), (64, 151936)):
        args = _loop_inputs(m, c, 1)
        first = entropy_judge_loop(*args)
        second = entropy_judge_loop(*args)
        if not torch.equal(first.view(torch.int32), second.view(torch.int32)):
            raise AssertionError(f"K1 loop ({m}, {c}): a second call gives "
                                 f"other bits")
    print("K1 loop: two calls on the same inputs equal bit for bit at "
          "(10, 10), (100, 10), (10, 151936) and (64, 151936)")
    return worst


def check_k2() -> float:
    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    # values in [0, 1) and weights in (0, 1], one weight 0 (a client the
    # judgment left out)
    for m, p in [(10, 62006), (1, 62006), (17, 62006), (3, 1),
                 (16, 16 * 2 ** 20), (300, 4099)]:
        flat = torch.rand((m, p), generator=gen, device="cuda")
        w = torch.rand(m, generator=gen, device="cuda") + 1e-3
        w[0] = 0.0
        got = masked_weighted_sum(flat, w)
        want = ref.masked_weighted_sum_reference(flat, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"K2 ({m}, {p}): max_abs_err={err:.3e}")
        # the kernel's arithmetic is the plain version's: equal bit for bit
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        worst = max(worst, err)
        del flat
    return worst


class RecordingJudge:
    """Delegates to ``inner`` and keeps each round's judge inputs and
    verdict, so the float32 verdicts can be set beside the float64
    oracle's and the plain route's."""

    def __init__(self, inner):
        self.inner = inner
        self.seen = []
        self.verdicts = []

    def __call__(self, soft_labels, sizes):
        self.seen.append((soft_labels.clone(), sizes.clone()))
        self.verdicts.append(self.inner(soft_labels, sizes))
        return self.verdicts[-1]


def _f32_ulp(x: float) -> float:
    """The spacing of float32 numbers at ``x``: 1.2e-07 in [1, 2), 2.4e-07
    in [2, 4); the group entropy of 10 classes is at most ln 10."""
    return float(np.spacing(np.float32(abs(x))))


class FollowingJudge:
    """Phase 9's plain-route judge: runs ``inner`` (the plain float32
    loop) on its round's inputs and holds the verdict against the kernel
    route's verdict of the same round (``leader``, a
    :class:`RecordingJudge`).

    Equal verdicts pass. Where they part, the inputs must be the kernel
    route's bit for bit, the removal orders must part where the two
    choices differ in float64 by less than one float32 spacing at the
    group entropy (a tie float32 cannot resolve; ROADMAP F5) and the
    entropies within K1_ATOL; the tie is printed and kept in ``ties``,
    and the plain route takes the kernel route's verdict, so the rounds
    after it stay comparable. Any other difference raises."""

    def __init__(self, inner, leader: RecordingJudge, what: str):
        self.inner, self.leader, self.what = inner, leader, what
        self.rounds = 0
        self.ties = []

    def __call__(self, soft_labels, sizes):
        r = self.rounds
        self.rounds += 1
        lead_soft, lead_sizes = self.leader.seen[r]
        lead = self.leader.verdicts[r]
        got = self.inner(soft_labels, sizes)
        if got[:2] == lead[:2]:
            return got
        if not (torch.equal(soft_labels, lead_soft)
                and torch.equal(sizes, lead_sizes)):
            raise AssertionError(f"{self.what}: round {r}: verdicts differ "
                                 f"({lead[1]} vs {got[1]}) on judge inputs "
                                 "that differ from the kernel route's")
        step, gap = _split_margin((soft_labels, sizes, None, None, None),
                                  lead[1], got[1])
        err = abs(got[2] - lead[2])
        ulp = _f32_ulp(lead[2])
        if not (gap < ulp and err <= K1_ATOL):
            raise AssertionError(
                f"{self.what}: round {r}: verdicts differ from the kernel "
                f"route's at step {step} by {gap} in float64, not below "
                f"float32's spacing {ulp:.3e} (entropies {err} apart): "
                f"{lead[1]} vs {got[1]}")
        print(f"{self.what}: round {r}: float32 tie: the plain loop removes "
              f"{got[1]}, the kernel {lead[1]}; they part at step {step}, "
              f"where the two choices differ by {gap:.3e} in float64, "
              f"below float32's spacing {ulp:.3e} at the entropy "
              f"(entropies {err:.3e} apart); the plain route follows the "
              "kernel route's verdict")
        self.ties.append((r, step, gap))
        return lead


def build_server(name: str, params, corpus, backend: str, judge=None,
                 **kw):
    """The composition ``name`` at the paper's configuration (N = 100,
    10% participation, E = 5, batch 50) with ``MaxEntropyJudge`` on
    ``backend`` (or ``judge``) and, except for scaffold (which keeps its
    leaf-wise average and server step), ``FusedAverageAggregator`` on
    it; ``kw`` goes to ``fl.build`` (``runtime``, ``drift``)."""
    cfg = fl.ServerConfig(num_clients=100, participation=0.1, seed=0)
    kw["judge"] = judge or fl.MaxEntropyJudge(backend=backend)
    if name != "scaffold":
        kw["aggregator"] = fl.FusedAverageAggregator(backend=backend)
    strategy = fl.get("composition", name).strategy
    return fl.build(name, cnn.apply, params, corpus, cfg,
                    fl.LocalSpec(strategy), device="cuda", **kw)


def timed_round(server, label: str) -> float:
    """One round of ``server``; prints its record, returns its wall s."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = server.round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[{label}] round {rec['round']}: selected={rec['selected']}"
          f" positive={rec['positive']} negative={rec['negative']}"
          f" entropy={rec['entropy']:.6f}"
          f" comm_bytes={rec['comm']['total_bytes']}"
          f" wall_s={wall:.4f}", flush=True)
    return wall


def run_rounds(server, label: str) -> list:
    return [timed_round(server, label) for _ in range(ROUNDS)]


def _leaves(tree) -> dict:
    """Leaves by dotted name: the CNN's {layer: {w, b}}, or an LM's
    ``Model.params()`` {name: tensor} as it is."""
    out = {}
    for k, sub in tree.items():
        if isinstance(sub, torch.Tensor):
            out[k] = sub
        else:
            out.update({f"{k}.{j}": t for j, t in sub.items()})
    return out


def compare_routes(a, b, what: str, rtol: float, ties: int = 0) -> float:
    """Raises unless servers ``a`` and ``b`` have equal integer records
    and global params (and strategy state) within ``rtol`` of max |value|
    per leaf; returns the worst such ratio. ``ties``: rounds where ``b``'s
    judge followed ``a``'s verdict at a float32 tie (printed)."""
    if len(a.history) != len(b.history):
        raise AssertionError(f"{what}: {len(a.history)} rounds against "
                             f"{len(b.history)}")
    for x, y in zip(a.history, b.history):
        for key in ("selected", "positive", "negative", "comm"):
            if x[key] != y[key]:
                raise AssertionError(f"{what}: round {x['round']} {key}: "
                                     f"{x[key]} != {y[key]}")
    trees = [(a.global_params, b.global_params)]
    if a.state is not None:
        trees += [(a.state[k], b.state[k]) for k in a.state]
    worst = 0.0
    for ta, tb in trees:
        la, lb = _leaves(ta), _leaves(tb)
        for name, t in la.items():
            u = lb[name]
            rel = float((t - u).abs().max()
                        / u.abs().max().clamp(min=1e-30))
            worst = max(worst, rel)
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what}: non-finite {name}")
    followed = f" ({ties} float32 ties followed)" if ties else ""
    print(f"{what}: integer records equal over {len(a.history)} rounds"
          f"{followed}; "
          f"params{' and state' if a.state is not None else ''} max |diff|"
          f" / max |value| per leaf = {worst:.3e} (limit {rtol:.0e})")
    if not worst <= rtol:
        raise AssertionError(f"{what}: {worst} > {rtol}")
    return worst


def paper_setup():
    """Phase 4's seeded data: the CNN's params, the N = 100 corpus on the
    card, the train split it was cut from and the test split."""
    (xtr, ytr), test = make_image_dataset(
        num_classes=10, train_per_class=5000, hw=32, channels=3)
    parts = partition("case1", ytr, 100, 10)
    corpus = ClientCorpus.from_parts(xtr, ytr, parts, batch_multiple=50,
                                     device="cuda")
    params = cnn.init(torch.Generator().manual_seed(0), image_hw=32,
                      channels=3, num_classes=10)
    return params, corpus, (xtr, ytr), test


def main_path():
    t0 = time.perf_counter()
    params, corpus, (xtr, ytr), (xte, yte) = paper_setup()
    n_params = sum(t.numel() for layer in params.values()
                   for t in layer.values())
    print(f"corpus x{tuple(corpus['x'].shape)} {corpus.nbytes / 1e6:.1f} MB "
          f"resident; CNN params {n_params}; set-up "
          f"{time.perf_counter() - t0:.1f} s")

    judge = RecordingJudge(fl.MaxEntropyJudge(backend="cuda"))
    server = build_server("fedentropy", params, corpus, "cuda", judge=judge)
    _reset_counts()
    walls = run_rounds(server, "cuda, captured")
    launches = _read_counts()
    metrics = server.evaluate(xte, yte)
    print(f"eval: {metrics}; launches in {ROUNDS} rounds: {launches}")
    if launches["masked_weighted_sum"] != ROUNDS:
        raise AssertionError(f"K2 launches in {ROUNDS} rounds: {launches}")
    # Alg. 1 runs in one launch of the loop kernel a round, the sweep never
    if launches["entropy_judge_loop"] != ROUNDS or \
            launches["entropy_judge_sweep"] != 0:
        raise AssertionError(f"K1 launches in {ROUNDS} rounds: {launches}; "
                             f"expected {ROUNDS} loop launches and no sweep")
    if not (0.0 <= metrics["accuracy"] <= 1.0
            and math.isfinite(metrics["loss"])):
        raise AssertionError(f"bad eval metrics {metrics}")
    print(f"first round (a cold process: library set-up, "
          f"{graph_cache.WARMUP_RUNS} warm-up runs "
          f"and the capture of the client program): {walls[0]:.4f} s")

    # the same rounds with the client program run eagerly on the card:
    # the captured route must give the same bits
    with fl.disable_capture():
        eager = build_server("fedentropy", params, corpus, "cuda")
        eager_walls = run_rounds(eager, "cuda, eager")
    compare_routes(server, eager, "captured route vs eager route", 0.0)
    if server.graphs_captured != 1 or eager.graphs_captured != 0:
        raise AssertionError(f"graphs captured: {server.graphs_captured} "
                             f"(captured route), {eager.graphs_captured} "
                             "(eager route); expected 1 and 0")
    print(f"graphs captured: {server.graphs_captured} (captured route), "
          f"{eager.graphs_captured} (eager route)")

    plain = build_server("fedentropy", params, corpus, "torch")
    run_rounds(plain, "torch, captured")
    compare_routes(server, plain, "cuda route vs plain route", PARAMS_RTOL)

    agree = 0
    for soft, sizes in judge.seen:
        a_np, r_np, _ = judge_np(soft.double().cpu().numpy(),
                                 sizes.double().cpu().numpy())
        a_k, r_k, _ = judge.inner(soft, sizes)
        agree += (a_np, r_np) == (a_k, r_k)
    print(f"(information) float32 kernel verdicts equal to the float64 "
          f"judge_np in {agree} of {len(judge.seen)} rounds")

    # round wall time by route, in turns
    turns = {"captured": [], "eager": []}
    for route in ("captured", "eager", "captured", "eager"):
        if route == "captured":
            turns[route].append(timed_round(server, "cuda, captured"))
        else:
            with fl.disable_capture():
                turns[route].append(timed_round(eager, "cuda, eager"))
    compare_routes(server, eager, "captured route vs eager route after the "
                   "turns", 0.0)
    print("round wall s in turns (captured, eager, captured, eager): "
          f"captured {[round(x, 4) for x in turns['captured']]}, eager "
          f"{[round(x, 4) for x in turns['eager']]}")
    profile_round(server, "captured")
    with fl.disable_capture():
        profile_round(eager, "eager")
    capture_cost(server.history[0], params, corpus)
    walls = {"captured": walls[1:] + turns["captured"],
             "eager": eager_walls[1:] + turns["eager"]}
    return (launches, walls, judge.seen[0], n_params, (params, corpus),
            (xtr, ytr))


def capture_cost(want: dict, params, corpus) -> None:
    """The first round of a new server in a warm process, which captures
    the client program, after 1 and after 3 warm-up runs in turns
    (1, 3, 3, 1); each must repeat the captured route's round 0 (``want``)
    to the bit in its records and entropy."""
    keep = graph_cache.WARMUP_RUNS
    walls = {1: [], 3: []}
    try:
        for n in (1, 3, 3, 1):
            graph_cache.WARMUP_RUNS = n
            fresh = build_server("fedentropy", params, corpus, "cuda")
            walls[n].append(timed_round(fresh, f"cuda, captured after {n} "
                                        "warm-up run(s)"))
            got = fresh.history[0]
            for key in ("selected", "positive", "negative", "comm",
                        "entropy"):
                if got[key] != want[key]:
                    raise AssertionError(f"{n} warm-up run(s): round 0 "
                                         f"{key}: {got[key]} != {want[key]}")
    finally:
        graph_cache.WARMUP_RUNS = keep
    print(f"first round of a new server in a warm process (warm-up runs "
          f"and capture included), in turns: 1 warm-up run "
          f"{[round(x, 4) for x in walls[1]]} s, 3 warm-up runs "
          f"{[round(x, 4) for x in walls[3]]} s; round 0 equal to the bit "
          f"after either (WARMUP_RUNS = {keep})")


def other_compositions(params, corpus) -> dict:
    """The paper's Table 3 partners of FedEntropy at the main path's
    width: moon (K1's loop and K2) and scaffold (K1's loop), 3 captured
    rounds each with launch counts, then the same rounds on the plain
    route; then the legacy shim for one round of each golden variant's
    settings. Returns each composition's launches and round walls."""
    from repro_torch.core.simulator import FedEntropyTrainer, FLConfig
    out = {}
    for name in ("moon", "scaffold"):
        judge = RecordingJudge(fl.MaxEntropyJudge(backend="cuda"))
        server = build_server(name, params, corpus, "cuda", judge=judge)
        _reset_counts()
        walls = run_rounds(server, f"{name}, cuda, captured")
        launches = _read_counts()
        print(f"{name}: launches in {ROUNDS} rounds: {launches}")
        k2 = ROUNDS if name == "moon" else 0
        if launches["entropy_judge_loop"] != ROUNDS or \
                launches["entropy_judge_sweep"] != 0 or \
                launches["masked_weighted_sum"] != k2:
            raise AssertionError(
                f"{name}: launches {launches}; expected {ROUNDS} K1 loop "
                f"launches, no sweep and {k2} K2 launches")
        if server.graphs_captured != 1:
            raise AssertionError(f"{name}: {server.graphs_captured} graphs")
        follow = FollowingJudge(fl.MaxEntropyJudge(backend="torch"), judge,
                                f"{name}, plain route")
        plain = build_server(name, params, corpus, "torch", judge=follow)
        run_rounds(plain, f"{name}, torch, captured")
        compare_routes(server, plain, f"{name}: cuda route vs plain route",
                       PARAMS_RTOL, ties=len(follow.ties))
        out[name] = {"launches": launches, "walls": walls,
                     "ties": follow.ties}
    print(f"round wall s: moon {[round(x, 4) for x in out['moon']['walls']]}"
          f", scaffold {[round(x, 4) for x in out['scaffold']['walls']]}"
          " (captured; the first round captures)")

    variants = {"fedentropy": ("fedavg", True, True),
                "fedavg_uniform": ("fedavg", False, False),
                "scaffold_fe": ("scaffold", True, True),
                "moon_nopools": ("moon", True, False)}
    for variant, (strategy, use_judgment, use_pools) in variants.items():
        tr = FedEntropyTrainer(
            cnn.apply, params, corpus,
            FLConfig(num_clients=100, participation=0.1,
                     use_judgment=use_judgment, use_pools=use_pools,
                     seed=0),
            fl.LocalSpec(strategy=strategy), device="cuda")
        _reset_counts()
        t0 = time.perf_counter()
        rec = tr.round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        want = {"entropy_judge_loop": int(use_judgment),
                "entropy_judge_sweep": 0,
                "masked_weighted_sum": int(strategy != "scaffold")}
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"shim {variant}: launches {launches}; "
                                 f"expected {want}")
        for name, t in _leaves(tr.global_params).items():
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"shim {variant}: non-finite {name}")
        total = fl.total_uplink_bytes(tr.history)
        if total <= 0:
            raise AssertionError(f"shim {variant}: {total} bytes")
        print(f"shim {variant}: selected={rec['selected']} "
              f"positive={rec['positive']} entropy={rec['entropy']:.6f} "
              f"comm_bytes={total}, params finite, launches {want}, first "
              f"round {wall:.4f} s")
    return out


# ------------------------------------------------------ pipelined engine

# unsharded on any machine: every pipelined baseline is held bit for bit
# to a sequential server, which a sharded run is not (the vmap's width)
SPEC = fl.RuntimeConfig(speculate=True, spec_backend="cuda", shard=False)
SPEC_ROUNDS = 5


class AdmitAllTraced(fl.MaxEntropyJudge):
    """The float64 oracle with a traced form that admits every device, so
    each round whose oracle rejects one misses (phase 10's forced
    miss)."""

    def traced(self, backend=None):
        return fl.PassThroughJudge().traced()


def build_fl(name: str, params, corpus, judge=None, **kw):
    """Phase 10's servers: ``build_server`` on the CUDA route with the
    float64 oracle ``MaxEntropyJudge()`` (or ``judge``) as the judge."""
    return build_server(name, params, corpus, "cuda",
                        judge=judge or fl.MaxEntropyJudge(), **kw)


def _same(x, y) -> bool:
    """Record values equal, a NaN entropy (a composition without
    judgment) equal to a NaN, also inside a clustered record's
    per-cluster verdicts."""
    if isinstance(x, dict) and isinstance(y, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    return x == y or (isinstance(x, float) and isinstance(y, float)
                      and math.isnan(x) and math.isnan(y))


def equal_to_sequential(seq, pip, what: str, flags: bool = True,
                        extra: frozenset = frozenset()) -> None:
    """Raises unless the pipelined server's records equal the sequential
    server's to the bit (entropy included; the two speculation flags
    apart) and its params and state are equal bit for bit. ``flags``:
    ``pip`` speculates, so its records carry the two flags; ``extra``:
    other keys only ``pip``'s records carry (the async engine's)."""
    if len(seq.history) != len(pip.history):
        raise AssertionError(f"{what}: {len(seq.history)} rounds against "
                             f"{len(pip.history)}")
    extra = set(extra) | ({"spec_hit", "redispatched"} if flags else set())
    for a, b in zip(seq.history, pip.history):
        if set(b) != set(a) | extra:
            raise AssertionError(f"{what}: record keys {sorted(b)}")
        for key in a:
            if not _same(b[key], a[key]):
                raise AssertionError(f"{what}: round {a['round']} {key}: "
                                     f"{b[key]} != {a[key]}")
    trees = [(seq.global_params, pip.global_params)]
    if seq.state is not None:
        trees += [(seq.state[k], pip.state[k]) for k in seq.state]
    for ta, tb in trees:
        la, lb = _leaves(ta), _leaves(tb)
        for name, t in la.items():
            if not torch.equal(t, lb[name]):
                raise AssertionError(f"{what}: {name} differs from the "
                                     "sequential server's")
    other = "the sequential server" if flags else "the other route"
    print(f"{what}: equal to {other} bit for bit over "
          f"{len(seq.history)} rounds (records, entropy, params"
          f"{', state' if seq.state is not None else ''})")


def run_speculative(seq, pip, rounds: int, label: str,
                    k2: int = 1) -> dict:
    """``rounds`` rounds of the sequential server, then of the pipelined
    one, with every count at 0 just before and read just after; prints
    each pipelined round's flags and K1-loop and K2 launches. Holds the
    two equal and returns the pipelined path's launches. ``k2``: the
    aggregator's K2 launches an aggregation (0: leaf-wise; K: perclstr
    over K centers)."""
    for _ in range(rounds):
        seq.round()
    _reset_counts()
    prev = _read_counts()
    for _ in range(rounds):
        rec = pip.round()
        now = _read_counts()
        print(f"[{label}] round {rec['round']}: spec_hit={rec['spec_hit']} "
              f"redispatched={rec['redispatched']} "
              f"negative={rec['negative']} launches this round: K1 loop "
              f"{now['entropy_judge_loop'] - prev['entropy_judge_loop']}, "
              f"K2 {now['masked_weighted_sum'] - prev['masked_weighted_sum']}",
              flush=True)
        prev = now
    torch.cuda.synchronize()
    launches = _read_counts()
    equal_to_sequential(seq, pip, label)
    misses = sum(not r["spec_hit"] for r in pip.history)
    want = {"entropy_judge_sweep": 0,
            "masked_weighted_sum": (rounds + misses) * int(k2)}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{label}: launches {launches}; expected "
                             f"{want} ({misses} misses)")
    for prev_rec, rec in zip(pip.history, pip.history[1:]):
        # a drift round was never dispatched ahead, so never re-dispatched
        if "drift" not in rec and \
                rec["redispatched"] != (not prev_rec["spec_hit"]):
            raise AssertionError(f"{label}: round {rec['round']} "
                                 f"redispatched={rec['redispatched']} after "
                                 f"spec_hit={prev_rec['spec_hit']}")
    print(f"{label}: {misses} of {rounds} rounds missed; launches "
          f"{launches}")
    return launches


def miss_margins(seq, pip, label: str) -> None:
    """For each missed round of ``pip``, K1's verdict on the round's judge
    inputs (recorded by ``seq``'s judge, the same bits) beside the float64
    oracle's, and the float64 gap where the two orders part, in float32
    spacings at the entropy (ROADMAP F5). A miss is a result, not an
    error: nothing is raised. These K1 launches compare; they are not the
    path's."""
    for rec in pip.history:
        if rec["spec_hit"]:
            continue
        r = rec["round"]
        soft, sizes = seq.judge.seen[r]
        oracle = seq.judge.verdicts[r]
        k1 = fl.MaxEntropyJudge(backend="cuda")(soft, sizes)
        step, gap = _split_margin((soft, sizes, None, None, None),
                                  k1[1], oracle[1])
        ulp = _f32_ulp(oracle[2])
        print(f"{label}: round {r} missed: K1 removes {k1[1]}, the float64 "
              f"oracle {oracle[1]}; they part at step {step}, where the two "
              f"choices differ by {gap:.3e} in float64: {gap / ulp:.2f} of "
              f"float32's spacing {ulp:.3e} at the entropy, "
              f"{'under' if gap < TOL else 'over'} Alg. 1's {TOL} margin")


def cluster_miss_margins(seq, pip, label: str) -> None:
    """``miss_margins`` for a clustered run: ``seq``'s judge (a
    :class:`RecordingJudge` around the float64 oracle) saw one call a
    cluster, clusters ascending; for each cluster of a missed round whose
    K1 verdict parts from the oracle's, the float64 gap where the two
    orders part, in float32 spacings at the cluster's entropy. Printed,
    never raised; these K1 launches compare, they are not the path's."""
    call = 0
    for rec, srec in zip(pip.history, seq.history):
        n = len(srec["clusters"])
        if not rec["spec_hit"]:
            for j, k in enumerate(sorted(srec["clusters"], key=int)):
                soft, sizes = seq.judge.seen[call + j]
                oracle = seq.judge.verdicts[call + j]
                k1 = fl.MaxEntropyJudge(backend="cuda")(soft, sizes)
                if k1[:2] == oracle[:2]:
                    continue
                step, gap = _split_margin((soft, sizes, None, None, None),
                                          k1[1], oracle[1])
                ulp = _f32_ulp(oracle[2])
                print(f"{label}: round {rec['round']} cluster {k} "
                      f"({len(sizes)} members) missed: K1 removes {k1[1]}, "
                      f"the float64 oracle {oracle[1]}; they part at step "
                      f"{step} by {gap:.3e} in float64: {gap / ulp:.2f} of "
                      f"float32's spacing {ulp:.3e} at the entropy, "
                      f"{'under' if gap < TOL else 'over'} Alg. 1's {TOL} "
                      "margin")
        call += n


def time_pipelined(params, corpus) -> None:
    """The pipelined and the sequential fedentropy round in turns
    (pipelined, sequential, sequential, pipelined), each on a new server
    for 6 rounds: a round's time is the host clock from the previous
    round's return to its own, with no synchronise between rounds (the
    pipelined round returns with round t+1 in flight); the median of
    rounds 2-5 per run. Then one profiled round of each."""
    times = {"pipelined": [], "sequential": []}
    last = {}
    for route in ("pipelined", "sequential", "sequential", "pipelined"):
        kw = {"runtime": SPEC} if route == "pipelined" else {}
        server = build_fl("fedentropy", params, corpus, **kw)
        torch.cuda.synchronize()
        stamps = [time.perf_counter()]
        for _ in range(6):
            server.round()
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        gaps = np.diff(stamps)
        times[route].append(float(statistics.median(gaps[2:6])))
        print(f"{route}: round s {[round(float(g), 5) for g in gaps]} "
              f"(rounds 0-5; round 0 captures), median of rounds 2-5 "
              f"{times[route][-1]:.5f}", flush=True)
        last[route] = server
    idle = {}
    for route, server in last.items():
        wall, busy = profile_round(server, route)
        idle[route] = 1 - busy / wall
    print("round s in turns (pipelined, sequential, sequential, "
          f"pipelined): pipelined {[round(x, 5) for x in times['pipelined']]}"
          f", sequential {[round(x, 5) for x in times['sequential']]}; "
          f"profiled idle share pipelined {idle['pipelined']:.3f}, "
          f"sequential {idle['sequential']:.3f}")


def pipelined_path(params, corpus, split) -> dict:
    """Phase 10: the pipelined engine at the main path's width, each run
    against the sequential server on the same route (float64 oracle,
    ``FusedAverageAggregator("cuda")``), captured, bit for bit:
    fedentropy speculating through K1's loop; the same with a traced form
    that admits everyone (a forced miss); fedentropy+queue; and a drift
    event at round 2 of 4, across which round 1 must not speculate. Then
    the two routes' round times in turns. Returns the launches by path."""
    out = {}
    seq = build_fl("fedentropy", params, corpus,
                   judge=RecordingJudge(fl.MaxEntropyJudge()))
    pip = build_fl("fedentropy", params, corpus, runtime=SPEC)
    out["pipelined"] = run_speculative(seq, pip, SPEC_ROUNDS, "pipelined")
    if out["pipelined"]["entropy_judge_loop"] != SPEC_ROUNDS:
        raise AssertionError(f"pipelined: {out['pipelined']}; expected "
                             f"{SPEC_ROUNDS} K1 loop launches")
    miss_margins(seq, pip, "pipelined")
    # the host work a speculative round can hide (the oracle) and the
    # work it adds before its dispatch (the selector's copy and draw)
    p64, s64 = (t.double().cpu().numpy() for t in seq.judge.seen[0])
    selector = pip.selector
    host = _host_us({
        "float64 oracle (judge_np on round 0's inputs)":
            lambda: judge_np(p64, s64),
        "selector deepcopy and select":
            lambda: copy.deepcopy(selector).select(10)}, calls=200)
    print("host us per call: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in host.items()))

    seq = build_fl("fedentropy", params, corpus)
    pip = build_fl("fedentropy", params, corpus, judge=AdmitAllTraced(),
                   runtime=SPEC)
    out["pipelined+miss"] = run_speculative(seq, pip, SPEC_ROUNDS,
                                            "pipelined+miss")
    for rec in pip.history:
        if rec["spec_hit"] == bool(rec["negative"]):
            raise AssertionError(f"pipelined+miss: round {rec['round']} "
                                 f"spec_hit={rec['spec_hit']} with "
                                 f"negative={rec['negative']}")
    forced = sum(not r["spec_hit"] for r in pip.history)
    if not forced or out["pipelined+miss"]["entropy_judge_loop"] != 0:
        raise AssertionError(f"pipelined+miss: {forced} misses, launches "
                             f"{out['pipelined+miss']}")

    seq = build_fl("fedentropy+queue", params, corpus)
    pip = build_fl("fedentropy+queue", params, corpus, runtime=SPEC)
    out["fedentropy+queue"] = run_speculative(seq, pip, 3,
                                              "fedentropy+queue")
    sizes = seq.corpus.sizes()
    act = seq.selector.queue.active(0, sizes)
    if not np.all(act < sizes) or \
            out["fedentropy+queue"]["entropy_judge_loop"] != 3:
        raise AssertionError(f"fedentropy+queue: round-0 release {act} of "
                             f"{sizes}; launches {out['fedentropy+queue']}")
    print(f"fedentropy+queue: round 0 released {sorted(set(act.tolist()))} "
          f"of {sorted(set(sizes.tolist()))} samples a client")

    xtr, ytr = split
    events = drift_schedule(xtr, ytr, 100, 10, at=2, frac=0.5,
                            samples_per_client=corpus.samples_per_client)
    seq = build_fl("fedentropy", params, corpus, drift=events)
    pip = build_fl("fedentropy", params, corpus, drift=events, runtime=SPEC)
    for _ in range(4):
        seq.round()
    _reset_counts()
    for r in range(4):
        rec = pip.round()
        if r == 1 and pip._pending is not None:
            raise AssertionError("drift: round 1 dispatched round 2 across "
                                 "the drift boundary")
        print(f"[drift at round 2] round {r}: spec_hit={rec['spec_hit']} "
              f"redispatched={rec['redispatched']} pending after it: "
              f"{pip._pending is not None}")
    torch.cuda.synchronize()
    print(f"drift: launches {_read_counts()}; {len(events[0].clients)} "
          f"clients drifted at round 2")
    equal_to_sequential(seq, pip, "drift at round 2")
    if pip.graphs_captured != 1:
        raise AssertionError(f"drift: {pip.graphs_captured} graphs")

    time_pipelined(params, corpus)
    return out


# ------------------------------------------------------------------ FedCAT

CAT_GROUP = 2            # 5 chains of 2 in a cohort of 10


def build_cat(name: str, params, corpus, group_size: int = CAT_GROUP,
              judge=None, **kw):
    """FedCAT (``fedcat`` or ``fedcat+maxent``) at phase 4's configuration
    with chains of ``group_size``: devconcat merges leaf by leaf, as in
    the reference (no K2); ``fedcat+maxent`` judges in K1's loop unless
    ``judge`` is given; ``kw`` goes to ``fl.build``."""
    cfg = fl.ServerConfig(num_clients=100, participation=0.1, seed=0,
                          group_size=group_size)
    if judge is None and name == "fedcat+maxent":
        judge = fl.MaxEntropyJudge(backend="cuda")
    if judge is not None:
        kw["judge"] = judge
    return fl.build(name, cnn.apply, params, corpus, cfg,
                    fl.LocalSpec("catchain"), device="cuda", **kw)


def fedcat_path(params, corpus) -> dict:
    """Phase 11: FedCAT at the paper's width, chains of 2. Returns the
    launches by path."""
    out = {}
    for name in ("fedcat", "fedcat+maxent"):
        judged = name == "fedcat+maxent"
        judge = (RecordingJudge(fl.MaxEntropyJudge(backend="cuda"))
                 if judged else None)
        server = build_cat(name, params, corpus, judge=judge)
        _reset_counts()
        walls = run_rounds(server, f"{name}, captured")
        launches = _read_counts()
        print(f"{name}: launches in {ROUNDS} rounds: {launches}; groups "
              f"of the last round {server.selector.last_groups}")
        want = {"entropy_judge_loop": ROUNDS if judged else 0,
                "entropy_judge_sweep": 0, "masked_weighted_sum": 0}
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"{name}: launches {launches}; expected "
                                 f"{want}")
        if server.graphs_captured != 1:
            raise AssertionError(f"{name}: {server.graphs_captured} graphs")
        for leaf, t in _leaves(server.global_params).items():
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name}: non-finite {leaf}")
        with fl.disable_capture():
            eager = build_cat(name, params, corpus)
            run_rounds(eager, f"{name}, eager")
        equal_to_sequential(eager, server, f"{name}: captured route vs "
                            "eager route", flags=False)
        if judged:
            follow = FollowingJudge(fl.MaxEntropyJudge(backend="torch"),
                                    judge, f"{name}, plain route")
            plain = build_cat(name, params, corpus, judge=follow)
            run_rounds(plain, f"{name}, torch, captured")
            compare_routes(server, plain, f"{name}: K1 route vs plain "
                           "route", PARAMS_RTOL, ties=len(follow.ties))
        out[name] = launches
        print(f"{name}: round wall s {[round(x, 4) for x in walls]} "
              "(captured; the first round captures)")

    # group size 1: every device its own chain, fedavg on the same
    # uniform stream
    k1 = build_cat("fedcat", params, corpus, group_size=1)
    fedavg = fl.build("fedavg", cnn.apply, params, corpus,
                      fl.ServerConfig(num_clients=100, participation=0.1,
                                      seed=0), fl.LocalSpec(),
                      device="cuda")
    run_rounds(k1, "fedcat, group size 1")
    run_rounds(fedavg, "fedavg, uniform")
    ours, theirs = _leaves(k1.global_params), _leaves(fedavg.global_params)
    diff = max(float((t - theirs[k]).abs().max()) for k, t in ours.items())
    if diff == 0.0:
        equal_to_sequential(fedavg, k1, "fedcat at group size 1 vs fedavg",
                            flags=False)
    else:
        compare_routes(fedavg, k1, "fedcat at group size 1 vs fedavg",
                       PARAMS_RTOL)
        print(f"fedcat at group size 1 vs fedavg: params part on the card "
              f"by at most {diff:.3e} (records equal)")

    # the pipelined engine: round t+1's chains laid out from the copy
    seq = build_cat("fedcat+maxent", params, corpus,
                    judge=RecordingJudge(fl.MaxEntropyJudge()))
    pip = build_cat("fedcat+maxent", params, corpus,
                    judge=fl.MaxEntropyJudge(), runtime=SPEC)
    label = "fedcat+maxent pipelined"
    out[label] = run_speculative(seq, pip, SPEC_ROUNDS, label, k2=False)
    if out[label]["entropy_judge_loop"] != SPEC_ROUNDS:
        raise AssertionError(f"{label}: {out[label]}; expected "
                             f"{SPEC_ROUNDS} K1 loop launches")
    miss_margins(seq, pip, label)
    seq = build_cat("fedcat+maxent", params, corpus,
                    judge=fl.MaxEntropyJudge())
    pip = build_cat("fedcat+maxent", params, corpus, judge=AdmitAllTraced(),
                    runtime=SPEC)
    label = "fedcat+maxent pipelined+miss"
    out[label] = run_speculative(seq, pip, SPEC_ROUNDS, label, k2=False)
    forced = sum(not r["spec_hit"] for r in pip.history)
    if not forced or out[label]["entropy_judge_loop"] != 0:
        raise AssertionError(f"{label}: {forced} misses, launches "
                             f"{out[label]}")

    time_fedcat(params, corpus)
    return out


def time_fedcat(params, corpus) -> None:
    """fedcat+maxent's and fedentropy's (phase 4's) captured round in
    turns (fedcat+maxent, fedentropy, fedentropy, fedcat+maxent), each on
    a new server for 4 rounds (round 0 captures), the median of rounds
    2-3 of each; then one profiled round of each: the device's busy time
    (the union of kernel intervals) and idle share."""
    times = {"fedcat+maxent": [], "fedentropy": []}
    last = {}
    for name in ("fedcat+maxent", "fedentropy", "fedentropy",
                 "fedcat+maxent"):
        server = (build_cat(name, params, corpus) if name != "fedentropy"
                  else build_server(name, params, corpus, "cuda"))
        walls = [timed_round(server, f"{name}, timed") for _ in range(4)]
        times[name].append(float(statistics.median(walls[2:4])))
        last[name] = server
    prof = {name: profile_round(server, name)
            for name, server in last.items()}
    print("round s in turns (fedcat+maxent, fedentropy, fedentropy, "
          "fedcat+maxent), medians of rounds 2-3: " + "; ".join(
              f"{name} {[round(x, 5) for x in ts]}"
              for name, ts in times.items()) + "; profiled: " + "; ".join(
              f"{name} wall {w:.4f} s busy {b:.4f} s idle {1 - b / w:.3f}"
              for name, (w, b) in prof.items()))


# ------------------------------------------------------------ async engine

ASYNC_FLUSHES = 3
ASYNC_KEYS = frozenset({"flush_time", "staleness", "buffer_occupancy",
                        "inflight", "seq", "admitted_seq"})
# the straggler settings of tests/golden/async_history.json
ASYNC_STRAGGLER = fl.AsyncConfig(clock="straggler", latency_scale=1.0,
                                 straggler_frac=0.25, straggler_factor=8.0,
                                 staleness_alpha=0.5, seed=0, shard=False)
# the zero clock, unsharded on any machine (as SPEC)
ASYNC = fl.AsyncConfig(shard=False)


class RecordingAdmit:
    """Delegates ``admit`` to ``inner`` and keeps each screened batch's
    inputs (host float64 rows) and verdict."""

    def __init__(self, inner):
        self.inner = inner
        self.seen = []
        self.verdicts = []

    def admit(self, buf_soft, buf_sizes, cand_soft, cand_sizes,
              device="cpu"):
        self.seen.append((buf_soft, buf_sizes, cand_soft, cand_sizes))
        self.verdicts.append(self.inner.admit(buf_soft, buf_sizes, cand_soft,
                                              cand_sizes, device=device))
        return self.verdicts[-1]


class FollowingAdmit(RecordingAdmit):
    """Phase 12's plain-route admission: phase 9's rule for one screened
    batch. ``inner`` (the plain float32 loop) admits over the batch and
    its protected buffer; where its verdict parts from the kernel route's
    (``leader``) on the same inputs by less than float32's spacing at the
    entropy in float64, the tie is printed and the leader's verdict
    followed; any other difference raises."""

    def __init__(self, inner, leader: RecordingAdmit, what: str):
        super().__init__(inner)
        self.leader, self.what = leader, what
        self.ties = []

    def admit(self, buf_soft, buf_sizes, cand_soft, cand_sizes,
              device="cpu"):
        r = len(self.verdicts)
        got = super().admit(buf_soft, buf_sizes, cand_soft, cand_sizes,
                            device)
        lead = self.leader.verdicts[r]
        if got[:2] == lead[:2]:
            return got
        same = all(np.array_equal(a, b) for a, b in
                   zip(self.seen[r], self.leader.seen[r]))
        if not same:
            raise AssertionError(f"{self.what}: screen {r}: verdicts differ "
                                 f"({lead[:2]} vs {got[:2]}) on inputs that "
                                 "differ from the kernel route's")
        nb = len(buf_sizes)
        soft = torch.from_numpy(np.concatenate([buf_soft, cand_soft]))
        sizes = torch.from_numpy(np.concatenate([buf_sizes, cand_sizes]))
        step, gap = _split_margin((soft, sizes, None, None, None),
                                  [nb + i for i in lead[1]],
                                  [nb + i for i in got[1]])
        err = abs(got[2] - lead[2])
        ulp = _f32_ulp(lead[2])
        if not (gap < ulp and err <= K1_ATOL):
            raise AssertionError(
                f"{self.what}: screen {r}: verdicts differ from the kernel "
                f"route's at step {step} by {gap} in float64, not below "
                f"float32's spacing {ulp:.3e}: {lead[:2]} vs {got[:2]}")
        print(f"{self.what}: screen {r}: float32 tie ({nb} protected rows): "
              f"the plain loop rejects {got[1]}, the kernel {lead[1]}; "
              f"they part at step {step} by {gap:.3e} in float64, below "
              f"float32's spacing {ulp:.3e}; the plain route follows")
        self.ties.append((r, step, gap))
        self.verdicts[r] = lead
        return lead


def run_async(server, label: str, flushes: int = ASYNC_FLUSHES) -> dict:
    """``flushes`` flushes of an async ``server`` with every count at 0
    just before and read just after. Prints each flush's screens, K1 loop
    launches (and how many ran over a protected, non-empty buffer), K2
    launches, staleness list and buffer occupancy. Returns the path's
    launches with ``screens`` and ``protected`` (K1 launches over a
    protected buffer) beside them."""
    screens = []
    inner = server._screen

    def screen(batch):
        before = entropy_judge_loop.launches
        buffered = len(server._buffer)
        inner(batch)
        screens.append((buffered, entropy_judge_loop.launches - before))

    server._screen = screen
    _reset_counts()
    prev = _read_counts()
    for _ in range(flushes):
        first = len(screens)
        rec = server.round()
        now = _read_counts()
        mine = screens[first:]
        k1 = now["entropy_judge_loop"] - prev["entropy_judge_loop"]
        print(f"[{label}] flush {rec['round']}: selected={rec['selected']} "
              f"positive={rec['positive']} screens {len(mine)}; K1 loop "
              f"{k1} ({sum(n for b, n in mine if b)} over a protected "
              f"buffer of {[b for b, _ in mine if b]} rows); K2 "
              f"{now['masked_weighted_sum'] - prev['masked_weighted_sum']}; "
              f"staleness {rec['staleness']}; buffer occupancy "
              f"{rec['buffer_occupancy']}; in flight {rec['inflight']}; "
              f"virtual time {rec['flush_time']:.4f}", flush=True)
        prev = now
    torch.cuda.synchronize()
    server._screen = inner
    launches = _read_counts()
    launches["screens"] = len(screens)
    launches["protected"] = sum(n for b, n in screens if b)
    return launches


def _refused(what: str, match: str, build) -> None:
    try:
        build()
    except ValueError as err:
        if match not in str(err):
            raise
        print(f"{what}: refused ({match})")
        return
    raise AssertionError(f"{what}: built; the reference refuses it")


def async_path(params, corpus, split) -> dict:
    """Phase 12: the async buffered engine at the main path's width,
    judged by K1's loop (admission over protected buffer rows) and
    aggregated in K2. Returns the launches by path."""
    out = {}
    ktwo = {"masked_weighted_sum": ASYNC_FLUSHES, "entropy_judge_sweep": 0}

    # (a) the zero clock reduces to the sequential server, bit for bit
    seq = build_server("fedentropy", params, corpus, "cuda")
    run_rounds(seq, "sequential, K1 and K2")
    asy = build_server("fedentropy", params, corpus, "cuda",
                       runtime=ASYNC)
    out["async"] = run_async(asy, "async")
    equal_to_sequential(seq, asy, "async (zero clock) vs sequential",
                        flags=False, extra=ASYNC_KEYS)
    want = dict(ktwo, entropy_judge_loop=ASYNC_FLUSHES, protected=0)
    if any(out["async"][k] != n for k, n in want.items()):
        raise AssertionError(f"async: launches {out['async']}; expected "
                             f"{want}")

    # (b) the straggler clock: captured against eager, bit for bit (each
    # dispatch's outputs are cloned before a later replay overwrites them)
    leader = RecordingAdmit(fl.MaxEntropyJudge(backend="cuda"))
    cap = build_server("fedentropy", params, corpus, "cuda", judge=leader,
                       runtime=ASYNC_STRAGGLER)
    out["async straggler"] = run_async(cap, "async straggler")
    got = out["async straggler"]
    if got["entropy_judge_loop"] != got["screens"] or not got["protected"] \
            or any(got[k] != n for k, n in ktwo.items()):
        raise AssertionError(f"async straggler: launches {got}; expected "
                             "one K1 loop launch a screen, some over a "
                             f"protected buffer, and {ktwo}")
    if not any(max(r["staleness"]) > 0 for r in cap.history):
        raise AssertionError("async straggler: no stale arrival")
    with fl.disable_capture():
        eager = build_server("fedentropy", params, corpus, "cuda",
                             runtime=ASYNC_STRAGGLER)
        for _ in range(ASYNC_FLUSHES):
            eager.round()
    equal_to_sequential(eager, cap, "async straggler: captured vs eager",
                        flags=False)
    if cap.graphs_captured != 1 or eager.graphs_captured != 0:
        raise AssertionError(f"async straggler: graphs {cap.graphs_captured}"
                             f", {eager.graphs_captured}")

    # (c) the same run on the plain route, under phase 9's rule
    follow = FollowingAdmit(fl.MaxEntropyJudge(backend="torch"), leader,
                            "async straggler, plain route")
    plain = build_server("fedentropy", params, corpus, "torch", judge=follow,
                         runtime=ASYNC_STRAGGLER)
    out["async straggler+plain"] = run_async(plain, "async straggler, plain")
    compare_routes(cap, plain, "async straggler: K1 route vs plain route",
                   PARAMS_RTOL, ties=len(follow.ties))
    for a, b in zip(cap.history, plain.history):
        if any(a[k] != b[k] for k in ("staleness", "seq", "admitted_seq")):
            raise AssertionError(f"async straggler, plain route: flush "
                                 f"{a['round']} stream differs")

    _refused("async fedcat+maxent", "prepare_round",
             lambda: build_cat("fedcat+maxent", params, corpus,
                               runtime=ASYNC))
    xtr, ytr = split
    events = drift_schedule(xtr, ytr, 100, 10, at=2, frac=0.5,
                            samples_per_client=corpus.samples_per_client)
    _refused("async with drift", "drift",
             lambda: build_server("fedentropy", params, corpus, "cuda",
                                  runtime=ASYNC, drift=events))
    time_async(params, corpus)
    return out


def time_async(params, corpus) -> None:
    """A zero-clock flush, a straggler flush (K1 and K2) and phase 4's
    captured fedentropy round in turns (zero, straggler, round, round,
    straggler, zero), each on a new server for 4 flushes or rounds (the
    first captures), the median of the last two."""
    runtimes = {"async zero-clock flush": ASYNC,
                "async straggler flush": ASYNC_STRAGGLER,
                "fedentropy round": None}
    times = {name: [] for name in runtimes}
    order = list(runtimes)
    for name in order + order[::-1]:
        kw = {} if runtimes[name] is None else {"runtime": runtimes[name]}
        server = build_server("fedentropy", params, corpus, "cuda", **kw)
        walls = [timed_round(server, f"{name}, timed") for _ in range(4)]
        times[name].append(float(statistics.median(walls[2:4])))
    print(f"wall s in turns ({', '.join(order + order[::-1])}), medians of "
          "the last two of 4: " + "; ".join(
              f"{name} {[round(x, 5) for x in ts]}"
              for name, ts in times.items()))


# ----------------------------------------------------------------- clusters

CLUSTERS = 3
CLUSTER_ROUNDS = 4


def build_clustered(name: str, params, corpus, backend: str = "cuda",
                    judge=None, k: int = CLUSTERS, **kw):
    """A clustered composition at phase 4's configuration with
    ``num_clusters = k``: ``PerClusterAggregator`` over
    ``FusedAverageAggregator`` on ``backend`` (K2 K times a round on
    "cuda"), and a maxent composition judged by ``MaxEntropyJudge`` on
    ``backend`` unless ``judge`` is given."""
    cfg = fl.ServerConfig(num_clients=100, participation=0.1, seed=0,
                          num_clusters=k)
    if judge is None and fl.get("composition", name).judge == "maxent":
        judge = fl.MaxEntropyJudge(backend=backend)
    if judge is not None:
        kw["judge"] = judge
    kw["aggregator"] = fl.PerClusterAggregator(
        fl.FusedAverageAggregator(backend=backend))
    return fl.build(name, cnn.apply, params, corpus, cfg, fl.LocalSpec(),
                    device="cuda", **kw)


def run_clustered(server, label: str, rounds: int = CLUSTER_ROUNDS) -> dict:
    """``rounds`` rounds with every count at 0 just before and read just
    after, printing each round's clusters and its K1-loop and K2
    launches."""
    _reset_counts()
    prev = _read_counts()
    for _ in range(rounds):
        rec = server.round()
        now = _read_counts()
        sizes = {k: len(v["members"]) for k, v in rec["clusters"].items()}
        print(f"[{label}] round {rec['round']}: cluster sizes {sizes} "
              f"positive={rec['positive']} entropy={rec['entropy']:.6f}"
              f"{' (drift)' if 'drift' in rec else ''}; launches this "
              f"round: K1 loop "
              f"{now['entropy_judge_loop'] - prev['entropy_judge_loop']}, "
              f"K2 {now['masked_weighted_sum'] - prev['masked_weighted_sum']}",
              flush=True)
        prev = now
    torch.cuda.synchronize()
    return _read_counts()


def cluster_path(params, corpus, split) -> dict:
    """Phase 13: the clustered ModelBank axis at the main path's width, K
    = 3, a drift of half the clients at round 2 of 4. Returns the
    launches by path."""
    out = {}
    xtr, ytr = split
    events = drift_schedule(xtr, ytr, 100, 10, at=2, frac=0.5,
                            samples_per_client=corpus.samples_per_client)

    # (a) ifca+maxent judged per cluster in K1's loop, perclstr over K2
    leader = RecordingJudge(fl.MaxEntropyJudge(backend="cuda"))
    cap = build_clustered("ifca+maxent", params, corpus, judge=leader,
                          drift=events)
    out["ifca+maxent"] = got = run_clustered(cap, "ifca+maxent")
    clusters = sum(len(r["clusters"]) for r in cap.history)
    want = {"entropy_judge_loop": clusters, "entropy_judge_sweep": 0,
            "masked_weighted_sum": CLUSTERS * CLUSTER_ROUNDS}
    if any(got[k] != n for k, n in want.items()):
        raise AssertionError(f"ifca+maxent: launches {got}; expected {want}")
    if [r["round"] for r in cap.history if "drift" in r] != [2]:
        raise AssertionError("ifca+maxent: the drift did not apply at 2")
    with fl.disable_capture():
        eager = build_clustered("ifca+maxent", params, corpus, drift=events)
        for _ in range(CLUSTER_ROUNDS):
            eager.round()
    equal_to_sequential(eager, cap, "ifca+maxent: captured vs eager",
                        flags=False)
    follow = FollowingJudge(fl.MaxEntropyJudge(backend="torch"), leader,
                            "ifca+maxent, plain route")
    plain = build_clustered("ifca+maxent", params, corpus, "torch",
                            judge=follow, drift=events)
    for _ in range(CLUSTER_ROUNDS):
        plain.round()
    compare_routes(cap, plain, "ifca+maxent: K1 route vs plain route",
                   PARAMS_RTOL, ties=len(follow.ties))
    if [r["cluster"] for r in cap.history] != \
            [r["cluster"] for r in plain.history]:
        raise AssertionError("ifca+maxent: assignments differ by route")
    print(f"ifca+maxent: bank stats {cap.cluster.stats()}")

    # (b) pipelined against sequential: speculation per cluster, a forced
    # miss
    seq = build_clustered("ifca+maxent", params, corpus,
                          judge=RecordingJudge(fl.MaxEntropyJudge()),
                          drift=events)
    pip = build_clustered("ifca+maxent", params, corpus,
                          judge=fl.MaxEntropyJudge(), drift=events,
                          runtime=SPEC)
    label = "ifca+maxent pipelined"
    out[label] = run_speculative(seq, pip, CLUSTER_ROUNDS, label, k2=CLUSTERS)
    clusters = sum(len(r["clusters"]) for r in pip.history)
    if out[label]["entropy_judge_loop"] != clusters:
        raise AssertionError(f"{label}: {out[label]}; expected {clusters} "
                             "K1 loop launches, one a cluster")
    cluster_miss_margins(seq, pip, label)
    seq = build_clustered("ifca+maxent", params, corpus,
                          judge=fl.MaxEntropyJudge(), drift=events)
    pip = build_clustered("ifca+maxent", params, corpus,
                          judge=AdmitAllTraced(), drift=events, runtime=SPEC)
    label = "ifca+maxent pipelined+miss"
    out[label] = run_speculative(seq, pip, CLUSTER_ROUNDS, label, k2=CLUSTERS)
    if not any(not r["spec_hit"] for r in pip.history) or \
            out[label]["entropy_judge_loop"] != 0:
        raise AssertionError(f"{label}: no miss, or launches {out[label]}")

    # (c) fesem: sticky weight-distance assignment, pipelined
    seq = build_clustered("fesem", params, corpus)
    pip = build_clustered("fesem", params, corpus, runtime=SPEC)
    out["fesem"] = run_speculative(seq, pip, ROUNDS, "fesem", k2=CLUSTERS)
    if seq.cluster.stats() != pip.cluster.stats():
        raise AssertionError("fesem: assignment state differs")
    print(f"fesem: {seq.cluster.stats()}")

    # (d) K = 1 is fedentropy, bit for bit
    one = build_clustered("ifca+maxent", params, corpus, k=1)
    fed = build_server("fedentropy", params, corpus, "cuda")
    run_rounds(one, "ifca+maxent, K = 1")
    run_rounds(fed, "fedentropy")
    if one.bank is not None:
        raise AssertionError("ifca+maxent at K = 1 carries a bank")
    equal_to_sequential(fed, one, "ifca+maxent at K = 1 vs fedentropy",
                        flags=False)

    # the IFCA assignment program: (3, 10) losses on the card, and with the
    # argmin's device-to-host copy
    sel = cap.history[-1]["selected"]
    loss_ms = _time_ms(lambda: cap.cluster.losses(sel), iters=20, warmup=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        cap.cluster.assign(sel)
    assign_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"IFCA assignment at K = {CLUSTERS}, m = {len(sel)}: losses "
          f"{loss_ms:.4f} ms (CUDA events), with the argmin and its host "
          f"copy {assign_ms:.4f} ms (host clock)")
    time_clustered(params, corpus)
    return out


def time_clustered(params, corpus) -> None:
    """ifca+maxent's (K = 3) and fedentropy's captured round in turns
    (ifca+maxent, fedentropy, fedentropy, ifca+maxent), each on a new
    server for 4 rounds, the median of rounds 2-3; then one profiled round
    of each."""
    times = {"ifca+maxent": [], "fedentropy": []}
    last = {}
    for name in ("ifca+maxent", "fedentropy", "fedentropy", "ifca+maxent"):
        server = (build_clustered(name, params, corpus)
                  if name != "fedentropy"
                  else build_server(name, params, corpus, "cuda"))
        walls = [timed_round(server, f"{name}, timed") for _ in range(4)]
        times[name].append(float(statistics.median(walls[2:4])))
        last[name] = server
    prof = {name: profile_round(server, name)
            for name, server in last.items()}
    print("round s in turns (ifca+maxent, fedentropy, fedentropy, "
          "ifca+maxent), medians of rounds 2-3: " + "; ".join(
              f"{name} {[round(x, 5) for x in ts]}"
              for name, ts in times.items()) + "; profiled: " + "; ".join(
              f"{name} wall {w:.4f} s busy {b:.4f} s idle {1 - b / w:.3f}"
              for name, (w, b) in prof.items()))



# ------------------------------------------------------------- scan engine

SCAN_R = 4               # rounds a block
SCAN_ROUNDS = 8          # two blocks in (a) and (b); (a)'s servers run
                         # 4 x SCAN_R more rounds in the timing
SCAN_SHORT = 4           # one block in (c) and (d)
# the kernels' names in a profile
K1_KERNELS = ("judge_loop_warp", "judge_loop_grid")
K2_KERNELS = ("masked_weighted_sum_kernel",)


class MissOnOneRemoval(fl.MaxEntropyJudge):
    """The float64 oracle with a traced form that is K1's verdict, except
    that a verdict removing exactly one device admits everyone: those
    rounds miss and the others hit, so a block is cut after confirmed
    rounds and its rewind point is read (``"stack"``) or rebuilt
    (``"remat"``)."""

    def traced(self, backend=None):
        inner = super().traced("cuda")

        def fn(soft, sizes):
            jr = inner(soft, sizes)
            return jr._replace(mask=torch.where(
                jr.num_removed == 1, torch.ones_like(jr.mask), jr.mask))
        return fn


def build_scan(name: str, params, corpus, judge=None, **kw):
    """Phase 14's servers: ``name`` at phase 4's configuration with the
    composition's own judge (the float64 oracle for maxent) unless
    ``judge`` is given, and ``FusedAverageAggregator("cuda")`` (K2);
    ``kw`` goes to ``fl.build`` (``runtime``)."""
    cfg = fl.ServerConfig(num_clients=100, participation=0.1, seed=0)
    if judge is not None:
        kw["judge"] = judge
    return fl.build(name, cnn.apply, params, corpus, cfg, fl.LocalSpec(),
                    aggregator=fl.FusedAverageAggregator(backend="cuda"),
                    device="cuda", **kw)


def scan_config(**kw) -> "fl.ScanConfig":
    return fl.ScanConfig(rounds_per_scan=SCAN_R, **kw)


def _block_programs(server) -> dict:
    """The server's captured blocks by depth."""
    return {key[1]: prog for key, prog in
            server._block_graphs._entries.items()}


def _pool_mib(prog) -> float:
    """MiB of device memory the private pool of ``prog``'s graph holds
    (its segments in the allocator's snapshot)."""
    pool = tuple(prog.graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool) / 2**20


def _graphs_line(server) -> str:
    """Each captured block of ``server`` by depth: capture seconds,
    launches a replay and its pool's MiB; then the captures its block
    and client caches made (evicted entries included)."""
    progs = _block_programs(server)
    return ("; ".join(f"depth {r}: capture {p.capture_s:.3f} s, launches "
                      f"a replay {p.launches}, pool {_pool_mib(p):.1f} MiB"
                      for r, p in sorted(progs.items()))
            + f"; block captures {server._block_graphs.captures}, client "
            f"program captures {server.graphs_captured}")


def run_scan(server, rounds: int, label: str) -> dict:
    """``rounds`` rounds of a scan server with every count at 0 just
    before and read just after; prints each round's flags and, on a
    round that ran blocks, their K1-loop and K2 launches and wall time."""
    _reset_counts()
    prev = _read_counts()
    for _ in range(rounds):
        blocks = server._blocks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = server.round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        now = _read_counts()
        ran = server._blocks - blocks
        line = (f"[{label}] round {rec['round']}: spec_hit={rec['spec_hit']}"
                f" redispatched={rec['redispatched']} "
                f"negative={rec['negative']}")
        if ran:
            k1, k2 = (now[k] - prev[k] for k in ("entropy_judge_loop",
                                                 "masked_weighted_sum"))
            line += (f"; ran {ran} block(s) in {wall:.4f} s, launches: K1 "
                     f"loop {k1}, K2 {k2}")
        print(line, flush=True)
        prev = now
    return _read_counts()


def _profiled_rounds(server, rounds: int):
    """``rounds`` rounds of ``server`` under torch.profiler: (wall s,
    device busy s, the device events' names)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            server.round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return wall, _busy_s(prof), names


def time_scan(servers: dict) -> None:
    """Blocks of 4 rounds against 4 sequential rounds on (a)'s warm
    servers (``servers``: "scan" the stack-mode scan server, "sequential"
    its sequential twin, each past 8 rounds), in turns (scan, sequential;
    sequential, scan; scan, sequential), so each pair runs the same rounds
    (8-11, 12-15, 16-19); a pair whose block missed is kept and labelled
    (its time holds the oracle round and, the first time a depth is
    needed, that depth's capture). Then one profiled block (rounds 20-23)
    and those 4 sequential rounds under the profiler for the device's
    idle share, with the block's K1 and K2 kernels in the profile held
    against the counts' deltas."""
    times = {"scan": [], "sequential": []}
    hit = []
    for order in (("scan", "sequential"), ("sequential", "scan"),
                  ("scan", "sequential")):
        for route in order:
            server = servers[route]
            start = len(server.history)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SCAN_R):
                server.round()
            torch.cuda.synchronize()
            times[route].append(time.perf_counter() - t0)
            flags = ""
            if route == "scan":
                flags = [r["spec_hit"] for r in server.history[start:]]
                hit.append(all(flags))
            print(f"{route}: rounds {start}-{start + SCAN_R - 1} "
                  f"{times[route][-1]:.5f} s {flags}", flush=True)
    idle = {}
    for route in ("scan", "sequential"):
        server = servers[route]
        start = len(server.history)
        before = _read_counts()
        wall, busy, names = _profiled_rounds(server, SCAN_R)
        after = _read_counts()
        idle[route] = 1 - busy / wall
        line = (f"profiled {route}, rounds {start}-{start + SCAN_R - 1}: wall "
                f"{wall:.4f} s, device busy {busy:.4f} s, idle share "
                f"{idle[route]:.3f}, {len(names)} device events "
                "(profiler on)")
        if route == "scan":
            seen = {"entropy_judge_loop": sum(
                any(k in n for k in K1_KERNELS) for n in names),
                "masked_weighted_sum": sum(
                any(k in n for k in K2_KERNELS) for n in names)}
            counted = {k: after[k] - before[k] for k in seen}
            hits = [r["spec_hit"] for r in server.history[start:]]
            line += (f"; spec_hit {hits}; K1 loop and K2 launches counted "
                     f"{counted}, in the profile {seen}")
            if counted != seen:
                raise AssertionError(f"scan: counted launches {counted} "
                                     f"differ from the profile's {seen}")
        print(line, flush=True)
    # the host work a block takes out of each round (the pools' draw on
    # the host, 3 threefry calls and 2 argsorts of small CPU tensors) and
    # what it adds once a block (the graph's launch)
    graph = _block_programs(servers["scan"])[SCAN_R].graph
    launch = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        launch.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    selector = copy.deepcopy(servers["sequential"].selector)
    host = _host_us({"TracedPoolSelector.select(10) at N = 100":
                     lambda: selector.select(10)}, calls=100)
    print(f"host: a depth-{SCAN_R} block graph's launch (replay() until it "
          f"returns) median {statistics.median(launch) * 1e3:.3f} ms of 5; "
          + ", ".join(f"{k} {v:.1f} us" for k, v in host.items()))
    equal_to_sequential(servers["sequential"], servers["scan"],
                        "scan after the timing: captured vs sequential")
    miss_margins(servers["sequential"], servers["scan"], "scan, timing")
    ratio = [s / q for s, q in zip(times["scan"], times["sequential"])]
    print(f"{SCAN_R} rounds s in turns (scan, sequential; sequential, "
          f"scan; scan, sequential): scan {times['scan']}, sequential "
          f"{times['sequential']}; block / sequential by pair "
          + ", ".join(f"{x:.4f} ({'hit' if h else 'missed'})"
                      for x, h in zip(ratio, hit))
          + f"; profiled idle share: block {idle['scan']:.3f}, sequential "
          f"{idle['sequential']:.3f}")


def scan_path(params, corpus) -> dict:
    """Phase 14: the scan engine at the main path's width. Returns the
    launches by path."""
    out = {}
    seq = build_scan("fedentropy-traced", params, corpus,
                     judge=RecordingJudge(fl.MaxEntropyJudge()))
    for _ in range(SCAN_ROUNDS):
        seq.round()

    # (a) fedentropy-traced, blocks of 4, each one captured graph with
    # K1's loop and K2 inside it: equal to sequential and to eager; the
    # stack server and seq go on to the timing
    timed = {"sequential": seq}
    for mode in ("stack", "remat"):
        label = "scan" if mode == "stack" else "scan remat"
        scan = build_scan("fedentropy-traced", params, corpus,
                          runtime=scan_config(params_mode=mode))
        t0 = time.perf_counter()
        got = run_scan(scan, SCAN_ROUNDS, label)
        stats = scan.stats()
        progs = _block_programs(scan)
        print(f"{label}: {stats['blocks']} blocks, "
              f"{stats['mismatch_rounds']} natural misses, "
              f"captured_block={stats['captured_block']}, launches {got}, "
              f"{time.perf_counter() - t0:.2f} s in all; graphs: "
              + _graphs_line(scan))
        if mode == "stack":
            timed["scan"] = scan
        if not stats["captured_block"] or SCAN_R not in progs:
            raise AssertionError(f"{label}: no captured depth-{SCAN_R} block")
        for r, p in progs.items():
            if p.launches != {"entropy_judge_loop": r,
                              "masked_weighted_sum": r}:
                raise AssertionError(f"{label}: depth {r} graph launches "
                                     f"{p.launches} a replay")
        equal_to_sequential(seq, scan, f"{label}: captured vs sequential")
        miss_margins(seq, scan, label)
        with fl.disable_capture():
            eager = build_scan("fedentropy-traced", params, corpus,
                               runtime=scan_config(params_mode=mode))
            for _ in range(SCAN_ROUNDS):
                eager.round()
            if eager.stats()["captured_block"] is not False:
                raise AssertionError(f"{label}: eager route captured")
        equal_to_sequential(eager, scan, f"{label}: captured vs eager",
                            flags=False)
        out[label] = got

    # (b) forced misses: the admit-all traced form; every rejecting round
    # must miss and cut its block. Each cut block runs at a new depth, so
    # the first 4 rounds capture depths 4..1 and the next 4 replay them:
    # their time is a block's after a miss, with no capture in it
    for mode in ("stack", "remat"):
        label = f"scan{' remat' if mode == 'remat' else ''}+miss"
        scan = build_scan("fedentropy-traced", params, corpus,
                          judge=AdmitAllTraced(),
                          runtime=scan_config(params_mode=mode))
        got = run_scan(scan, SCAN_ROUNDS, label)
        equal_to_sequential(seq, scan, f"{label}: captured vs sequential")
        for rec in scan.history:
            if rec["spec_hit"] == bool(rec["negative"]):
                raise AssertionError(f"{label}: round {rec['round']} "
                                     f"spec_hit={rec['spec_hit']} with "
                                     f"negative={rec['negative']}")
        if got["entropy_judge_loop"] != 0 or \
                all(r["spec_hit"] for r in scan.history):
            raise AssertionError(f"{label}: launches {got}, no miss")
        depths = _block_programs(scan)
        if scan._block_graphs.captures != len(depths):
            raise AssertionError(f"{label}: {scan._block_graphs.captures} "
                                 f"block captures for depths "
                                 f"{sorted(depths)}: a graph was evicted")
        print(f"{label}: {scan.stats()['mismatch_rounds']} misses, "
              f"{scan.stats()['blocks']} blocks, launches {got}; graphs: "
              + _graphs_line(scan))
        out[label] = got

    # (b') misses after confirmed rounds, in remat: each cut rewinds inside
    # its block to a depth-j block's output (stack's ys["params"][j - 1]
    # rewind runs in the card tests)
    label = "scan remat+rewind"
    scan = build_scan("fedentropy-traced", params, corpus,
                      judge=MissOnOneRemoval(),
                      runtime=scan_config(params_mode="remat"))
    got = run_scan(scan, SCAN_ROUNDS, label)
    equal_to_sequential(seq, scan, f"{label}: captured vs sequential")
    for rec in scan.history:
        if rec["spec_hit"] == (len(rec["negative"]) == 1):
            raise AssertionError(f"{label}: round {rec['round']} "
                                 f"spec_hit={rec['spec_hit']} with "
                                 f"negative={rec['negative']}")
    inside = [r["round"] for r, prev in zip(scan.history[1:], scan.history)
              if not r["spec_hit"] and prev["spec_hit"]
              and r["round"] % SCAN_R]
    print(f"{label}: misses at rounds "
          f"{[r['round'] for r in scan.history if not r['spec_hit']]}, cut "
          f"after confirmed rounds of a block at {inside}; launches {got}; "
          "graphs: " + _graphs_line(scan))
    if not inside:
        raise AssertionError(f"{label}: no block was cut after a confirmed "
                             "round")
    out[label] = got

    # (c) fedavg: host-drawn cohorts (replay) against sequential, and the
    # device's threefry draw, captured against eager
    seq = build_scan("fedavg", params, corpus)
    scan = build_scan("fedavg", params, corpus, runtime=scan_config())
    for _ in range(SCAN_SHORT):
        seq.round()
    out["scan fedavg"] = run_scan(scan, SCAN_SHORT, "scan fedavg")
    equal_to_sequential(seq, scan, "scan fedavg: captured vs sequential")
    dev = build_scan("fedavg", params, corpus,
                     runtime=scan_config(selection="device"))
    run_scan(dev, SCAN_SHORT, "scan fedavg device")
    with fl.disable_capture():
        eager = build_scan("fedavg", params, corpus,
                           runtime=scan_config(selection="device"))
        for _ in range(SCAN_SHORT):
            eager.round()
    equal_to_sequential(eager, dev, "scan fedavg device: captured vs eager",
                        flags=False)
    print("scan fedavg device: cohorts "
          f"{[r['selected'] for r in dev.history]}")

    # (d) the numpy pools cannot fold: sequential rounds, with the reason
    seq = build_scan("fedentropy", params, corpus)
    scan = build_scan("fedentropy", params, corpus, runtime=scan_config())
    for _ in range(SCAN_SHORT):
        seq.round()
        scan.round()
    codes = [r["code"] for r in scan.fallback_reasons]
    if codes != ["verdict-coupled-selector"] or scan.scan_rounds() != 1:
        raise AssertionError(f"fedentropy on scan: reasons {codes}")
    equal_to_sequential(seq, scan, "scan fedentropy (fallback) vs "
                        "sequential", flags=False,
                        extra=frozenset({"scan_fallback"}))

    capture_checks()
    time_scan(timed)
    return out


# ------------------------------------------------------- streaming plane

STREAM_N = 1000          # clients; 500 samples each, uint8, 1.536 GB of x
STREAM_S = 500
STREAM_COHORT = 10       # participation 0.01
STREAM_ROUNDS = 3
STREAM_SPEC = 5


def streamed_corpus(split) -> dict:
    """Phase 15's stacked dict: phase 4's 50,000 images quantised once to
    uint8 (the inverse of ``cifar10_normalizer``, clipped), and N = 1000
    clients of 500 seeded rows each from their case-1 class (client i
    holds class i % 10); rows repeat across clients."""
    from repro_torch.data.ingest import CIFAR10_MEAN, CIFAR10_STD
    xtr, ytr = split
    x8 = np.clip(np.rint((xtr * np.float32(CIFAR10_STD)
                          + np.float32(CIFAR10_MEAN)) * 255.0), 0, 255
                 ).astype(np.uint8)
    rng = np.random.default_rng(0)
    by_class = [np.where(ytr == c)[0] for c in range(10)]
    rows = np.stack([rng.choice(by_class[i % 10], STREAM_S, replace=False)
                     for i in range(STREAM_N)])
    return {"x": x8[rows], "y": ytr[rows].astype(np.int32),
            "w": np.ones((STREAM_N, STREAM_S), np.float32)}


def build_streamed(params, corpus, judge=None, **kw):
    """fedentropy at phase 4's configuration (E = 5, batch 50, lr 0.01,
    momentum 0.5, a cohort of 10) over ``corpus`` (a stacked dict, or a
    built corpus of either plane) with N = 1000: ``judge`` (default K1's
    loop) and ``FusedAverageAggregator("cuda")``; ``kw`` goes to
    ``fl.build`` (``data_plane``, ``runtime``)."""
    cfg = fl.ServerConfig(num_clients=STREAM_N,
                          participation=STREAM_COHORT / STREAM_N, seed=0)
    return fl.build("fedentropy", cnn.apply, params, corpus, cfg,
                    fl.LocalSpec(),
                    judge=judge or fl.MaxEntropyJudge(backend="cuda"),
                    aggregator=fl.FusedAverageAggregator(backend="cuda"),
                    device="cuda", **kw)


def _round_turns(servers: dict, rounds: int, sync: bool) -> dict:
    """Round seconds of two warm servers in turns (a, b, b, a), ``rounds``
    consecutive rounds each time: the host clock from one round's return
    to the next (with a synchronise after each round when ``sync``; a
    pipelined round returns with round t+1 in flight). Returns each
    server's median, the first round of each turn left out."""
    (a, sa), (b, sb) = servers.items()
    gaps = {a: [], b: []}
    for name, server in ((a, sa), (b, sb), (b, sb), (a, sa)):
        torch.cuda.synchronize()
        stamps = [time.perf_counter()]
        for _ in range(rounds):
            server.round()
            if sync:
                torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        gaps[name] += list(np.diff(stamps)[1:])
    return {name: float(statistics.median(g)) for name, g in gaps.items()}


def cohort_copy_times(data: dict, idx: np.ndarray) -> None:
    """One cohort's host gather into pinned memory and its copy to the
    card, each timed alone (the gather on the host clock, the copy with
    CUDA events), beside a pageable copy of the same bytes."""
    x = data["x"]
    pinned = torch.empty((len(idx),) + x.shape[1:], dtype=torch.uint8,
                         pin_memory=True)
    dev = torch.empty(pinned.shape, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    for _ in range(10):
        np.take(x, idx, axis=0, out=pinned.numpy(), mode="wrap")
    gather_ms = (time.perf_counter() - t0) / 10 * 1e3
    pinned_ms = _time_ms(lambda: dev.copy_(pinned, non_blocking=True),
                         iters=20, warmup=3)
    pageable = np.ascontiguousarray(x[idx])
    src = torch.from_numpy(pageable)
    pageable_ms = _time_ms(lambda: dev.copy_(src), iters=20, warmup=3)
    nbytes = pinned.numel()
    print(f"one cohort's x ({len(idx)} clients, {nbytes / 1e6:.2f} MB "
          f"uint8): host gather into pinned memory {gather_ms:.3f} ms; "
          f"copy to the card from pinned memory {pinned_ms:.3f} ms "
          f"({nbytes / pinned_ms / 1e6:.2f} GB/s), from pageable memory "
          f"{pageable_ms:.3f} ms ({nbytes / pageable_ms / 1e6:.2f} GB/s)")


def capture_during_prefetch(data: dict, transform, idx, want: dict) -> None:
    """A prefetch started inside a capture, so its worker reaches its CUDA
    calls while the round thread captures; the capture lock holds them
    until the capture ends. The program and the staged cohort must both
    be right."""
    hc = fl.HostCorpus(dict(data), transform=transform, device="cuda")
    hc.prefetcher()
    calls = []

    def fn(x):
        calls.append(time.perf_counter())
        if len(calls) == graph_cache.WARMUP_RUNS + 1:    # the capture
            hc.prefetch(idx)
            time.sleep(0.1)
        return x * 2 + 1

    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    prog = graph_cache.CapturedProgram(fn, (x,))
    held = time.perf_counter() - calls[-1]
    got = hc.cohort(idx)
    y = torch.randn(4096, device="cuda")
    ok = torch.equal(prog(y), y * 2 + 1)
    same = all(torch.equal(got[k], want[k]) for k in want)
    stats = hc.prefetch_stats()
    print(f"capture during an in-flight prefetch: the worker's copy waited "
          f"{stats['stage_s']:.4f} s (the capture held the lock "
          f"{held:.4f} s after the prefetch started); captured program "
          f"right: {ok}; staged cohort equal to the resident gather: "
          f"{same}; prefetch {stats}")
    if not (ok and same and stats["hits"] == 1
            and stats["stage_s"] >= 0.09):
        raise AssertionError("capture during an in-flight prefetch failed")


def streaming_path(params, split) -> dict:
    """Phase 15: the streaming plane at the main path's width over N =
    1000 clients (1.54 GB of uint8, over the 1 GiB budget, so "auto"
    streams it). Returns the launches by path."""
    from repro_torch.data.ingest import cifar10_normalizer
    from repro_torch.data.stream import RESIDENT_BUDGET_BYTES, HostCorpus
    out = {}
    t0 = time.perf_counter()
    data = streamed_corpus(split)
    norm = cifar10_normalizer()
    nbytes = sum(v.nbytes for v in data.values())
    print(f"corpus x{data['x'].shape} uint8: {nbytes / 1e9:.4f} GB "
          f"against a resident budget of {RESIDENT_BUDGET_BYTES / 1e9:.4f} "
          f"GB; built in {time.perf_counter() - t0:.1f} s")

    def host():
        return fl.as_data_plane(data, "streaming", transform=norm,
                                device="cuda")

    # fl.build resolves a stacked dict this size to the streaming plane
    probe = build_streamed(params, data)
    if not isinstance(probe.corpus, HostCorpus):
        raise AssertionError(f"auto gave {type(probe.corpus).__name__}")
    print(f"fl.build(..., data_plane=\"auto\") on the stacked dict: "
          f"{type(probe.corpus).__name__}")
    del probe

    # (a) the same rounds on the streaming ("auto"), memory-mapped and
    # resident planes, bit for bit; device memory at each build
    servers, alloc = {}, {}
    tmp = tempfile.TemporaryDirectory()
    try:
        for plane in ("streaming", "mmap", "resident"):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            if plane == "streaming":
                corpus = fl.as_data_plane(data, "auto", transform=norm,
                                          device="cuda")
                if not isinstance(corpus, HostCorpus):
                    raise AssertionError(f"auto gave {type(corpus)}")
            elif plane == "mmap":
                t1 = time.perf_counter()
                corpus = HostCorpus.open(servers["streaming"].corpus.save(
                    tmp.name), device="cuda")
                print(f"saved and memory-mapped in "
                      f"{time.perf_counter() - t1:.1f} s; mmap "
                      f"{corpus.memory_report()['host_is_mmap']}")
            else:
                corpus = fl.as_data_plane(data, "resident", transform=norm,
                                          device="cuda")
            torch.cuda.synchronize()
            alloc[plane] = torch.cuda.memory_allocated() - before
            servers[plane] = build_streamed(params, corpus)
        for plane, server in servers.items():
            _reset_counts()
            run_rounds_n(server, f"{plane}", STREAM_ROUNDS)
            torch.cuda.synchronize()
            launches = _read_counts()
            if plane == "streaming":
                out["streaming"] = launches
            if launches["entropy_judge_loop"] != STREAM_ROUNDS or \
                    launches["masked_weighted_sum"] != STREAM_ROUNDS:
                raise AssertionError(f"{plane}: launches {launches}")
        for plane in ("mmap", "resident"):
            equal_to_sequential(servers["streaming"], servers[plane],
                                f"streaming vs {plane}", flags=False)
        for plane, server in servers.items():
            print(f"{plane}: device bytes allocated when the corpus was "
                  f"built {alloc[plane]}; memory_report "
                  f"{server.corpus.memory_report()}")
        rep = servers["streaming"].corpus.memory_report()
        # one cohort's storage bytes (x uint8, y int32, w float32)
        cohort = STREAM_COHORT * STREAM_S * (
            int(np.prod(data["x"].shape[2:])) + 8)
        if alloc["streaming"] != 0 or \
                rep["device_resident_bytes"] > 2 * cohort or \
                alloc["resident"] < data["x"].nbytes:
            raise AssertionError(f"streaming holds {rep}, allocated "
                                 f"{alloc}; expected about one cohort")

        # (b) the pipelined engine on the streaming plane: round t+1's
        # cohort staged on the prefetch thread while the oracle runs; each
        # server has a HostCorpus (and a prefetcher) of its own over the
        # same host arrays
        seq = build_streamed(params, host(), judge=fl.MaxEntropyJudge())
        pip = build_streamed(params, host(), judge=fl.MaxEntropyJudge(),
                             runtime=SPEC)
        out["streaming pipelined"] = run_speculative(
            seq, pip, STREAM_SPEC, "streaming pipelined")
        stats = pip.corpus.prefetch_stats()
        hits = sum(r["spec_hit"] for r in pip.history)
        print(f"streaming pipelined: prefetch {stats}; speculation hits "
              f"{hits}")
        if stats["hits"] != hits or not hits or \
                out["streaming pipelined"]["entropy_judge_loop"] \
                != STREAM_SPEC:
            raise AssertionError("streaming pipelined: prefetch hits "
                                 f"{stats['hits']} != speculation hits "
                                 f"{hits}")

        # (c) a forced miss cancels the staged cohort
        seq_m = build_streamed(params, host(), judge=fl.MaxEntropyJudge())
        pip_m = build_streamed(params, host(), judge=AdmitAllTraced(),
                               runtime=SPEC)
        out["streaming pipelined+miss"] = run_speculative(
            seq_m, pip_m, STREAM_SPEC, "streaming pipelined+miss")
        stats = pip_m.corpus.prefetch_stats()
        misses = sum(not r["spec_hit"] for r in pip_m.history)
        print(f"streaming pipelined+miss: prefetch {stats}; misses "
              f"{misses}")
        if not misses or stats["cancelled"] != misses:
            raise AssertionError(f"forced miss: {misses} misses, prefetch "
                                 f"{stats}")

        # (d) a capture while a prefetch is in flight
        idx = np.asarray(servers["streaming"].history[0]["selected"])
        want = servers["resident"].corpus.cohort(idx)
        capture_during_prefetch(data, norm, idx, want)

        # (e) times: one cohort's gather and copy; the rounds in turns
        cohort_copy_times(data, idx)
        seq_t = _round_turns({"streaming": servers["streaming"],
                              "resident": servers["resident"]}, 5, True)
        res_pip = build_streamed(params, servers["resident"].corpus,
                                 judge=fl.MaxEntropyJudge(), runtime=SPEC)
        res_pip.round()
        pip_t = _round_turns({"streaming": pip, "resident": res_pip}, 5,
                             False)
        print(f"sequential round s in turns, medians: streaming "
              f"{seq_t['streaming']:.5f}, resident {seq_t['resident']:.5f}"
              f"; pipelined round s: streaming {pip_t['streaming']:.5f}, "
              f"resident {pip_t['resident']:.5f}; pipelined streaming "
              f"prefetch {pip.corpus.prefetch_stats()}")
    finally:
        tmp.cleanup()
    return out


def run_rounds_n(server, label: str, rounds: int) -> list:
    return [timed_round(server, label) for _ in range(rounds)]


def capture_checks() -> None:
    """What the block graph holds, each captured alone against its eager
    launch: the pool draw and the device selection's permutation (stable
    argsorts whose scratch comes from the graph's pool) against the CPU's
    integers, at N = 100 and N = 2000 (two sort rounds); K1's loop as the
    warp kernel at (10, 10) and as the grid kernel (a cooperative launch)
    at (10, 4096), at (10, 151936) on 132 CTAs and forced to 2 CTAs at
    (10, 10), bit for bit, one launch a replay."""
    from repro_torch.core import threefry
    from repro_torch.core.pools import pools_draw
    for n, num in ((100, 10), (2000, 200)):
        gen = np.random.default_rng(n)
        pos = torch.from_numpy((gen.random(n) < 0.5).astype(np.float32))
        key = threefry.prng_key(7)

        def draw(k, p, q, num=num, n=n):
            sel, k2 = pools_draw(k, p, q, num=num, eps=0.8)
            return sel, k2, threefry.permutation(k2, n)

        want = draw(key, pos, 1.0 - pos)
        args = (key.cuda(), pos.cuda(), (1.0 - pos).cuda())
        prog = graph_cache.CapturedProgram(draw, args)
        got = prog(*args)
        if not all(torch.equal(w, g.cpu()) for w, g in zip(want, got)):
            raise AssertionError(f"captured draw at N = {n} differs from "
                                 "the CPU's")
    print("captured pool draw and permutation equal the CPU's at N = 100 "
          "and N = 2000")
    for c, ctas in ((10, None), (4096, None), (151936, None), (10, 2)):
        soft, sizes, _ = _k1_inputs(10, c, seed=c)
        fn = (lambda s, z, ctas=ctas:
              entropy_judge_loop(s, z, _ctas=ctas))
        eager = fn(soft, sizes).clone()
        prog = graph_cache.CapturedProgram(fn, (soft, sizes))
        got = prog(soft, sizes)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), eager.view(torch.int32)) \
                or prog.launches != {"entropy_judge_loop": 1}:
            raise AssertionError(f"K1 loop captured at (10, {c}) CTAs "
                                 f"{ctas}: differs or {prog.launches}")
        print(f"K1 loop captured at (10, {c}) "
              f"({_loop_kernel_of(10, c, ctas)}): equal to its eager "
              f"launch bit for bit, {prog.launches} a replay")

def profile_round(server, label: str) -> tuple[float, float]:
    """One more round of ``server`` under torch.profiler: wall time,
    summed kernel time, the device's idle share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = _kernel_us(prof)
    summed = sum(by_kernel.values()) / 1e6
    busy = _busy_s(prof)
    print(f"profiled {label} round: wall {wall:.4f} s, kernels summed "
          f"{summed:.4f} s, device busy (union of kernel intervals) "
          f"{busy:.4f} s, device idle share {1 - busy / wall:.3f} "
          "(profiler on)")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    return wall, busy


def _host_us(pieces: dict, calls: int) -> dict:
    """Host microseconds per call of each function of ``pieces``, over
    ``calls`` calls each after 100 to warm up."""
    us = {}
    for name, piece in pieces.items():
        for _ in range(100):
            piece()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            piece()
        us[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return us


def k2_host_us(flat, w, calls: int = 10000) -> dict:
    """Host microseconds per call of each piece of K2's wrapper, over
    ``calls`` calls each: its checks, the output's allocation, the stream
    lookup and the ctypes call that launches the kernel; beside them the
    whole wrapper and the library call ``w @ flat``."""
    m, p = flat.shape
    index = flat.get_device()
    fn = fused_aggregate._fn()
    out = flat.new_empty(p)
    stream = _build.current_stream(index)
    ptrs = (flat.data_ptr(), w.data_ptr(), out.data_ptr())
    return _host_us({
        "checks": lambda: fused_aggregate._checked(flat, w,
                                                   fused_aggregate.BLOCK),
        "empty": lambda: flat.new_empty(p),
        "stream": lambda: _build.current_stream(index),
        "ctypes call": lambda: fn(*ptrs, m, p, fused_aggregate.BLOCK,
                                  stream),
        "whole wrapper": lambda: masked_weighted_sum(flat, w),
        "w @ flat": lambda: w @ flat,
    }, calls)


def k1_host_us(soft, sizes, mask, calls: int = 10000) -> dict:
    """Host microseconds per call of each piece of K1's sweep wrapper,
    over ``calls`` calls each: its checks, the plan (a cached lookup),
    the buffer's allocation, the stream lookup, the ctypes call that
    launches the kernel, and the whole wrapper."""
    m, c = soft.shape
    index = soft.get_device()
    pl = entropy_judge.plan(m, c, sweep=True)
    fn = entropy_judge._grid_fn()
    n = (2 * pl.ctas + 1) * (m + 1)
    buf = torch.empty(n, dtype=torch.float32, device=soft.device)
    stream = _build.current_stream(index)
    ptrs = (soft.data_ptr(), sizes.data_ptr(), mask.data_ptr(), None,
            buf.data_ptr(), buf.data_ptr() + 4 * (m + 1))
    args = (m, c, 0, *entropy_judge._grid_args(pl, True, soft.dtype))

    def checks():
        entropy_judge._check_labels(soft, entropy_judge._SWEEP_DTYPES)
        entropy_judge._vector(sizes, soft, m, "sizes")
        entropy_judge._vector(mask, soft, m, "mask")
    return _host_us({
        "checks": checks,
        "plan": lambda: entropy_judge.plan(m, c, sweep=True),
        "empty": lambda: torch.empty(n, dtype=torch.float32,
                                     device=soft.device),
        "stream": lambda: _build.current_stream(index),
        "ctypes call": lambda: fn(*ptrs, *args, stream),
        "whole wrapper": lambda: entropy_judge_sweep(soft, sizes, mask),
    }, calls)


def launch_floor() -> tuple[float, float]:
    """(ms per call, device ms) of an empty kernel of K1's library,
    launched through ``_build.launch`` as every wrapper launches."""
    fn = entropy_judge.empty_fn()
    index = torch.cuda.current_device()
    call = lambda: _build.launch(fn, index)
    return (_time_ms(call, iters=2000, warmup=200),
            _device_ms(call, ("empty_kernel",)))


def _k1_sweep_work(m: int, c: int) -> tuple[int, int]:
    """(bytes, operations) of one sweep: P read once, sizes and mask, the
    M + 1 results; per class the weighted sum (2 M) and the group term
    (3), per row and class its leave-one-out term (6)."""
    return m * c * 4 + 2 * m * 4 + (m + 1) * 4, 2 * m * c + 3 * c + 6 * m * c


def _k1_loop_work(m: int, c: int, packed) -> tuple[int, int, int]:
    """(bytes, operations, iterations) of one loop call with every row
    active and none protected, counted from its result: P read once, the
    sizes, the packed result; iteration i sums the M - i rows still in
    the set (2 per row and class) and forms their leave-one-out terms (6
    per row and class), and the first one the group term (3 per class).
    The last iteration is the sweep that found no improvement, unless
    the cap (M - 1) stopped the loop."""
    removed = int(ref.unpack_judgment(packed)[2])
    iters = removed + (removed < m - 1)
    ops = sum(8 * (m - i) * c for i in range(iters)) + 3 * c
    return m * c * 4 + m * 4 + (2 * m + 3) * 4, ops, iters


# FP32-pipe instructions of one accurate logf, an estimate (its range
# reduction, polynomial and selects without fast math), and the FP32
# pipe's instructions a clock on an H100 SM at its 1.98 GHz boost
LOGF_INSTRUCTIONS = 20
SM_FP32_PER_S = 128 * 1.98e9


def _k1_log_floor_ms(m: int, c: int) -> float:
    """The least time of one loop iteration's (M + 1) C accurate
    logarithms spread evenly over the card's 132 SMs: a floor beside the
    bytes bound, which the arithmetic of the logarithms, not the read,
    sets at these shapes."""
    return (m + 1) * c * LOGF_INSTRUCTIONS / (132 * SM_FP32_PER_S) * 1e3


def time_kernels(judge_inputs, p: int) -> dict:
    """K1's sweep and loop on the first round's soft labels and sizes with
    every device active, and the whole judgment by route; K2 on a (M, P)
    buffer of the main path's shape. Each kernel: (ms per call, plain ms,
    library ms or None, bound ms, bound_by, kernel ms, shape)."""
    soft, sizes = judge_inputs
    m, c = soft.shape
    mask = torch.ones(m, device=soft.device)
    sweep_call = lambda: entropy_judge_sweep(soft, sizes, mask)
    sweep = _time_turns({"kernel": sweep_call,
                         "plain": lambda: ref.entropy_judge_sweep_reference(
                             soft, sizes, mask)})
    loop_call = lambda: entropy_judge_loop(soft, sizes)
    loop = _time_turns({"kernel": loop_call,
                        "plain": lambda: ref.entropy_judge_loop_reference(
                            soft, sizes)})
    loop_bytes, loop_ops, iters = _k1_loop_work(m, c, loop_call())

    gen = torch.Generator(device="cuda").manual_seed(1)
    flat = torch.randn((m, p), generator=gen, device="cuda")
    w = torch.rand(m, generator=gen, device="cuda")
    k2_call = lambda: masked_weighted_sum(flat, w)
    k2 = _time_turns({"kernel": k2_call,
                      "plain": lambda: ref.masked_weighted_sum_reference(
                          flat, w),
                      "library": lambda: w @ flat}, iters=2000, warmup=200)
    k2_bytes = (m * p + m + p) * 4
    k2_flops = 2 * m * p
    sweep_dev = _device_ms(sweep_call, ("judge_loop_grid",))
    loop_dev = _device_ms(loop_call, ("judge_loop",))
    k2_dev = _device_ms(k2_call, ("masked_weighted_sum",))
    print(f"device time per call (torch.profiler): K1 sweep "
          f"{sweep_dev:.5f} ms, every kernel of the sweep wrapper "
          f"{_device_ms(sweep_call, ()):.5f} ms, K1 loop {loop_dev:.5f} ms "
          f"({iters} iterations, "
          f"{_loop_kernel_of(m, c)}), every "
          f"kernel of the loop wrapper {_device_ms(loop_call, ()):.5f} ms, "
          f"K2 kernel {k2_dev:.5f} ms")
    grid_dev = _device_ms(lambda: entropy_judge_loop(
        soft, sizes, _ctas=1), ("judge_loop_grid",))
    print(f"K1 loop at ({m}, {c}), kernel alone: {_loop_kernel_of(m, c)} "
          f"{loop_dev:.5f} ms, the grid kernel on one CTA "
          f"{grid_dev:.5f} ms; floor of the logarithms "
          f"{_k1_log_floor_ms(m, c):.3e} ms an iteration on 132 SMs")
    whole, verdict = judgment_ms(soft, sizes)
    print(f"whole judgment at ({m}, {c}), MaxEntropyJudge, host clock to "
          f"the verdict on the host, in turns (plain, kernel, kernel, "
          f"plain): plain loop {whole['torch']:.5f} ms, loop kernel "
          f"{whole['cuda']:.5f} ms; rejected {verdict[1]}")
    host = k1_host_us(soft, sizes, mask)
    print("K1 host us per call over 10000 calls: " + ", ".join(
        f"{name} {us:.3f}" for name, us in host.items()))
    host = k2_host_us(flat, w)
    print("K2 host us per call over 10000 calls: " + ", ".join(
        f"{name} {us:.3f}" for name, us in host.items()))
    return {"entropy_judge_sweep": (
                sweep["kernel"], sweep["plain"], None,
                *_bound_ms(*_k1_sweep_work(m, c)), sweep_dev, (m, c)),
            "entropy_judge_loop": (
                loop["kernel"], loop["plain"], None,
                *_bound_ms(loop_bytes, loop_ops), loop_dev, (m, c)),
            "masked_weighted_sum": (
                k2["kernel"], k2["plain"], k2["library"],
                *_bound_ms(k2_bytes, k2_flops), k2_dev, (m, p))}


def time_k1_wide(m: int = 10, c: int = 151936) -> None:
    """K1 at Qwen's vocabulary: the plan, the loop per iteration against
    the bytes bound of one read of P and against the floor of its
    accurate logarithms on 132 SMs, forced grid sizes, and the sweep per
    call (one iteration of the loop as a launch of its own)."""
    soft, sizes, _, _, _ = _loop_inputs(m, c, 0)
    pl = entropy_judge.plan(m, c)
    call = lambda: entropy_judge_loop(soft, sizes)
    nbytes, ops, iters = _k1_loop_work(m, c, call())
    ms = _time_ms(call, iters=50, warmup=5)
    dev = _device_ms(call, ("judge_loop",), iters=20)
    mask = torch.ones(m, device="cuda")
    sweep_call = lambda: entropy_judge_sweep(soft, sizes, mask)
    sweep_ms = _time_ms(sweep_call, iters=50, warmup=5)
    sweep_dev = _device_ms(sweep_call, ("judge_loop_grid",), iters=20)
    plain_ms = _time_ms(lambda: ref.entropy_judge_loop_reference(soft, sizes),
                        iters=5, warmup=1)
    per_iter_bound = m * c * 4 / HBM_BYTES_PER_S * 1e3
    bound, by = _bound_ms(nbytes, ops)
    print(f"K1 loop plan at ({m}, {c}): {pl}")
    print(f"K1 loop at ({m}, {c}), {_loop_kernel_of(m, c)}: {iters} "
          f"iterations, {ms:.5f} ms per call, kernel alone {dev:.5f} ms, "
          f"{dev / iters:.5f} ms per iteration = "
          f"{per_iter_bound / (dev / iters):.3f} of the "
          f"{per_iter_bound:.5f} ms bytes bound of one read of P; call "
          f"bound {bound:.3e} ms ({by}: {nbytes} bytes, {ops} operations); "
          f"floor of the logarithms {_k1_log_floor_ms(m, c):.3e} ms an "
          f"iteration on 132 SMs; plain loop {plain_ms:.5f} ms")
    print(f"K1 sweep at ({m}, {c}): {sweep_ms:.5f} ms per call, kernel "
          f"alone {sweep_dev:.5f} ms; {iters} sweeps: {iters * sweep_ms:.5f} "
          f"ms of calls, {iters * sweep_dev:.5f} ms of kernels")
    forced = {g: _time_ms(lambda: entropy_judge_loop(
        soft, sizes, _ctas=g), iters=10, warmup=2)
        for g in (1, 2, 4, 16, 33, 66, 132)}
    print("K1 loop ms per call by forced grid size (CUDA events; streamed "
          "up to 16 CTAs): " +
          ", ".join(f"{g}: {t:.5f}" for g, t in forced.items()))
    floor_ms, floor_dev = launch_floor()
    print(f"launch floor: an empty kernel through _build.launch "
          f"{floor_ms:.5f} ms per call, kernel alone {floor_dev:.5f} ms")


# ------------------------------------------------------------------ LM path

DEV = "cuda"            # where the LM phases run

def _randn(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _check_close(name, label, got, want, tol) -> float:
    atol, rtol = tol
    err = float((got.float() - want.float()).abs().max())
    print(f"{name} {label}: max_abs_err={err:.3e}")
    torch.testing.assert_close(
        got.float(), want.float(), atol=atol, rtol=rtol,
        msg=lambda m: f"{name} {label} disagrees with its plain version: "
                      f"{m}")
    return err


def _tags(b, t, index):
    """Slot tags of a cache filled up to each row's ``index`` (-1 past
    it), and the index as a (B,) int32 tensor."""
    index = torch.as_tensor(index, dtype=torch.int32, device=DEV)
    index = index.reshape(-1).expand(b).contiguous()
    slots = torch.arange(t, dtype=torch.int32, device=DEV)[None]
    return torch.where(slots <= index[:, None], slots, -1).contiguous(), index


def check_k3() -> float:
    """K3 against mha_reference; returns the largest float32 error."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    cases = [  # (b, s, t, h, kh, d, window)
        (2, 64, 64, 4, 2, 32, 0), (1, 37, 37, 4, 4, 16, 0),
        (2, 128, 128, 8, 1, 64, 0), (1, 16, 80, 4, 2, 32, 0),  # JAX tests
        (2, 64, 64, 4, 2, 32, 24),                          # JAX window
        (SERVE_B, SERVE_S, SERVE_S, 32, 32, 80, 0),         # Zamba2 prefill
        (SERVE_B, SERVE_S, SERVE_S, 32, 32, 80, 256),       # ... windowed
        (2, 512, 512, 16, 8, 128, 0),                       # Qwen3 GQA
        (2, 100, 100, 4, 2, 20, 0),                         # D % 8 != 0
        (1, 90, 90, 4, 4, 17, 0),                           # odd D
        (2, 300, 300, 4, 4, 80, 24),          # fully masked leading tiles
        (1, 16, 300, 4, 2, 80, 0),                          # S < T, T % 64
        (MOE_B, MOE_S, MOE_S, 64, 4, 128, 0),       # qwen3-moe prefill
        (MOE_B, MOE_S, MOE_S, 16, 16, 256, 0),      # gemma-7b's D = 256
        # whisper-large-v3 (phase 18): the encoder over 1,500 frames, not
        # causal; the decoder's causal self prefill; its cross attention
        # at the prefill and at each decode step (S = 1), 1,500 keys, not
        # a multiple of the tile
        (FAM_B, WHISPER_T, WHISPER_T, 20, 20, 64, 0, False),
        (FAM_B, WHISPER_S, WHISPER_S, 20, 20, 64, 0),
        (FAM_B, WHISPER_S, WHISPER_T, 20, 20, 64, 0, False),
        (FAM_B, 1, WHISPER_T, 20, 20, 64, 0, False),
        # internvl2-1b's prefill: 256 patches and 768 tokens, 14 over 2
        (FAM_B, VLM_P + VLM_S, VLM_P + VLM_S, 14, 2, 64, 0),
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, t, h, kh, d, window, *how in cases:
            q = _randn((b, s, h, d), gen, dtype)
            k = _randn((b, t, kh, d), gen, dtype)
            v = _randn((b, t, kh, d), gen, dtype)
            causal = how[0] if how else s == t
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = ref.mha_reference(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = _check_close(
                "K3", f"b={b} s={s} t={t} h={h} kh={kh} d={d} causal="
                f"{causal} window={window} {str(dtype)[6:]}", got, want,
                K3_TOL[dtype])
            if dtype == torch.float32:
                worst = max(worst, err)
    return worst


def check_k4() -> float:
    """K4 against mha_reference with per-row q_offset; returns the largest
    float32 error. The cases take one split (T = 7: the split kernel
    writes o) and many, and groups of up to 128 heads in one block and of
    272 over two. Then, at the two serve shapes in both dtypes, two calls
    give the same bits."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    t_serve = SERVE_S + SERVE_GEN
    ragged = [1055, 900, 700, 1030]
    cases = [  # (b, t, h, kh, d, window, index per row)
        (2, 64, 4, 2, 32, 0, 54), (2, 40, 8, 8, 16, 12, 30),
        (2, 100, 4, 1, 32, 16, 90),                         # JAX tests
        (SERVE_B, t_serve, 32, 32, 80, 0, 1040),            # Zamba2 decode
        (SERVE_B, t_serve, 32, 32, 80, 256, 1040),          # ... windowed
        (SERVE_B, t_serve, 32, 32, 80, 0, ragged),          # ragged
        (SERVE_B, t_serve, 16, 8, 128, 0, 1040),            # Qwen3 GQA
        # qwen3-moe-235b-a22b: g = 16, 16 query heads on one staged tile
        (MOE_B, t_serve, 64, 4, 128, 0, 1040),
        (MOE_B, t_serve, 64, 4, 128, 256, 1040),
        (MOE_B, t_serve, 64, 4, 128, 0, ragged),
        (MOE_B, t_serve, 64, 4, 128, 256, ragged),
        (MOE_B, t_serve, 32, 2, 128, 0, 1040),              # chatglm3-6b
        (MOE_B, t_serve, 16, 16, 256, 0, 1040),             # gemma-7b
        # T not a multiple of the split; T shorter than one tile
        (MOE_B, 1000, 64, 4, 128, 0, [999, 900, 700, 1]),
        (SERVE_B, 1057, 32, 32, 80, 0, [1056, 900, 700, 1030]),
        (MOE_B, 1057, 64, 4, 128, 0, 1056),
        (2, 7, 64, 4, 128, 0, [6, 3]), (2, 7, 32, 32, 80, 0, 6),
        (MOE_B, t_serve, 64, 4, 128, 20, 1040),     # window < one split
        # every valid slot in the first split
        (MOE_B, t_serve, 64, 4, 128, 0, 10),
        (SERVE_B, t_serve, 32, 32, 80, 0, 10),
        # a row with no valid slot (it averages all T slots)
        (MOE_B, t_serve, 64, 4, 128, 0, [-1, 900, 700, 1030]),
        (SERVE_B, t_serve, 32, 32, 80, 16, [-1, 900, 700, 1030]),
        # D not a multiple of 16 bytes (element copies, odd columns), and
        # K's pad columns on the tensor cores
        (2, 300, 16, 4, 17, 0, [299, 200]),
        (2, 200, 32, 2, 20, 16, [199, 150]),
        # teams of several warps (g > 16); a group of 128 or 64 wide heads
        # in one block of fewer teams; a group over two blocks (g > 256)
        (2, 300, 32, 1, 64, 16, [299, 200]), (1, 64, 128, 1, 128, 0, 63),
        (1, 64, 64, 1, 256, 0, 63), (2, 300, 48, 1, 256, 24, [299, 200]),
        (1, 64, 272, 1, 16, 0, 63),
        # the decoders of phase 18: whisper-large-v3 (g = 1 at D = 64, 64
        # prompt and 32 greedy tokens) and internvl2-1b (g = 7 at D = 64,
        # on the CUDA cores, 256 patches, 768 tokens, 32 greedy tokens)
        (FAM_B, WHISPER_S + FAM_GEN, 20, 20, 64, 0, WHISPER_S + FAM_GEN - 1),
        (FAM_B, WHISPER_S + FAM_GEN, 20, 20, 64, 0, [95, 80, 64, 70]),
        (FAM_B, VLM_T, 14, 2, 64, 0, VLM_T - 1),
        (FAM_B, VLM_T, 14, 2, 64, 0, [1055, 900, 700, 1030]),
    ]
    worst = 0.0
    plans = set()
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, h, kh, d, window, index in cases:
            q = _randn((b, 1, h, d), gen, dtype)
            k = _randn((b, t, kh, d), gen, dtype)
            v = _randn((b, t, kh, d), gen, dtype)
            tags, idx = _tags(b, t, index)
            got = decode_attention(q, k, v, tags, idx, window=window)
            want = ref.mha_reference(q, k, v, causal=True, window=window,
                                     q_offset=idx[:, None],
                                     kv_positions=tags)
            torch.cuda.synchronize()
            p = _k4_plan(q, k)
            plans.add((p.splits > 1, p.hgroups > 1))
            err = _check_close(
                "K4", f"b={b} t={t} h={h} kh={kh} d={d} window={window} "
                f"index={index} {str(dtype)[6:]} ({p.splits} splits of "
                f"{p.split_len}, tiles of {p.tile}, "
                f"{'tensor' if p.tensor_cores else 'CUDA'} cores, "
                f"{p.heads} heads in {p.teams} teams of {p.team_warps} "
                f"warps and {p.smem} bytes a block, {p.hgroups} block(s) "
                f"a KV head)", got, want, K4_TOL[dtype])
            if dtype == torch.float32:
                worst = max(worst, err)
        for b, h, kh, d in [(MOE_B, 64, 4, 128), (SERVE_B, 32, 32, 80)]:
            q = _randn((b, 1, h, d), gen, dtype)
            k = _randn((b, t_serve, kh, d), gen, dtype)
            v = _randn((b, t_serve, kh, d), gen, dtype)
            tags, idx = _tags(b, t_serve, ragged)
            one = decode_attention(q, k, v, tags, idx)
            two = decode_attention(q, k, v, tags, idx)
            torch.cuda.synchronize()
            if not torch.equal(one, two):
                raise AssertionError(f"K4 at ({b}, {t_serve}, {h} over "
                                     f"{kh}, {d}) {dtype} gives other bits "
                                     f"on a second call")
    if plans != {(False, False), (True, False), (True, True)}:
        raise AssertionError(f"K4's cases missed a kind of plan: {plans}")
    print("K4 at both serve shapes, float32 and bfloat16: two calls equal "
          "bit for bit")
    return worst


def _ssd_inputs(gen, b, l, h, p, g, n, dtype=torch.float32, strong=False):
    """dt ~ U(0.001, 0.1) and a = -exp(N(0, 1)); ``strong`` decay takes a
    ~ U(-20, -1), so cums reaches about -500 inside a 256-step chunk."""
    x = _randn((b, l, h, p), gen, dtype)
    dt = torch.rand((b, l, h), generator=gen, device=DEV) * 0.099 + 0.001
    if strong:
        a = -1.0 - 19.0 * torch.rand((h,), generator=gen, device=DEV)
    else:
        a = -torch.exp(torch.randn((h,), generator=gen, device=DEV))
    return (x, dt, a, _randn((b, l, g, n), gen, dtype),
            _randn((b, l, g, n), gen, dtype))


def check_k5() -> float:
    """K5 against ssd_chunked_reference; returns the largest float32
    error."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    cases = [  # (b, l, h, p, g, n, chunk, strong decay)
        (2, 64, 4, 8, 2, 16, 16, False), (1, 50, 4, 8, 1, 16, 16, False),
        (2, 32, 6, 16, 2, 8, 8, False),
        (1, 128, 2, 32, 1, 32, 32, False),                  # JAX tests
        (SERVE_B, SERVE_S, 80, 64, 1, 64, 256, False),      # Zamba2 prefill
        (1, 4096, 8, 64, 1, 64, 256, True),     # 16 chunks, cums to -500
        (2, 300, 4, 64, 2, 128, 256, False),    # mamba2-130m's N, ragged
        (1, 1, 4, 64, 1, 64, 256, False),                   # one token
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, l, h, p, g, n, q, strong in cases:
            x, dt, a, bm, cm = _ssd_inputs(gen, b, l, h, p, g, n, dtype,
                                           strong)
            y1, h1 = ssd_chunked(x, dt, a, bm, cm, chunk=q)
            y0, h0 = ref.ssd_chunked_reference(x, dt, a, bm, cm, chunk=q)
            torch.cuda.synchronize()
            label = (f"b={b} l={l} h={h} p={p} g={g} n={n} chunk={q}"
                     f"{' strong decay' if strong else ''} "
                     f"{str(dtype)[6:]}")
            err = max(_check_close("K5 y", label, y1, y0, K5_TOL[dtype]),
                      _check_close("K5 state", label, h1, h0,
                                   K5_TOL[dtype]))
            if dtype == torch.float32:
                worst = max(worst, err)
    # the same inputs twice give the same bits (no atomics, fixed order)
    x, dt, a, bm, cm = _ssd_inputs(gen, SERVE_B, SERVE_S, 80, 64, 1, 64)
    y1, h1 = ssd_chunked(x, dt, a, bm, cm)
    y2, h2 = ssd_chunked(x, dt, a, bm, cm)
    if not (torch.equal(y1, y2) and torch.equal(h1, h2)):
        raise AssertionError("K5 gives other bits on a second call")
    print("K5 at the serve shape: two calls equal bit for bit")
    return worst


def _profiled(fn) -> tuple[float, float, dict]:
    """(wall s, summed kernel s, kernel us by name) of one ``fn()`` under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = _kernel_us(prof)
    return wall, sum(by_kernel.values()) / 1e6, by_kernel


def _print_profile(what, wall, busy, by_kernel, top=8) -> None:
    print(f"profiled {what}: wall {wall * 1e3:.3f} ms, kernels "
          f"{busy * 1e3:.3f} ms, device idle share {1 - busy / wall:.3f} "
          f"(profiler on)")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}")


def serve_path() -> dict:
    """Zamba2-2.7B at full width through the port's entry points, on the
    kernel route, then replayed on the plain route."""
    cfg = ARCHS[SERVE_ARCH].replace(remat="none", param_dtype="float32",
                                    dtype="float32")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEV, kernels="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = model.num_params()
    print(f"{cfg.name}: {n_params} params ({n_params * 4 / 1e9:.2f} GB "
          f"float32), random init on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)), device=DEV)
    cache_len = SERVE_S + SERVE_GEN

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_logits, cache = model.prefill({"tokens": prompts},
                                          cache_len=cache_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = prefill_logits[:, -1:].argmax(-1)
    tokens, step_logits, step_ms = [tok], [], []
    for _ in range(SERVE_GEN - 1):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, tok)
        tok = logits[:, -1:].argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        step_logits.append(logits)
        tokens.append(tok)
    launches = _read_counts()

    groups, per = cfg.num_layers // cfg.attn_every, cfg.attn_every - 1
    expect = {"entropy_judge_sweep": 0, "entropy_judge_loop": 0,
              "masked_weighted_sum": 0,
              "flash_attention": groups, "decode_attention":
              groups * (SERVE_GEN - 1),
              "ssd_chunked": groups * per * K5_LAUNCHES_PER_CALL}
    print(f"launches in one request batch: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"serve launches {launches} != {expect}")
    gen_tokens = torch.cat(tokens, dim=1)
    if prefill_logits.shape != (SERVE_B, SERVE_S, cfg.padded_vocab) or \
            gen_tokens.shape != (SERVE_B, SERVE_GEN):
        raise AssertionError("serve output shapes are wrong")
    if not (bool(torch.isfinite(prefill_logits).all()) and all(
            bool(torch.isfinite(x).all()) for x in step_logits)):
        raise AssertionError("non-finite serve logits")
    print(f"prefill {SERVE_B}x{SERVE_S} (first call): {prefill_s:.4f} s; "
          f"decode median {statistics.median(step_ms):.3f} ms/step over "
          f"{SERVE_GEN - 1} steps (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f})")
    print(f"  seq0: {gen_tokens[0].tolist()}")

    # the same prompts and the kernel route's tokens on the plain route
    plain = build_model(cfg, device=DEV, kernels="torch", seed=0)
    plain.net.load_state_dict(model.net.state_dict())
    lg, pcache = plain.prefill({"tokens": prompts}, cache_len=cache_len)
    rel = [float((lg - prefill_logits).abs().max() /
                 prefill_logits.abs().max())]
    agree = int((lg[:, -1:].argmax(-1) == tokens[0]).sum())
    for i in range(SERVE_GEN - 1):
        lg, pcache = plain.decode_step(pcache, tokens[i])
        rel.append(float((lg - step_logits[i]).abs().max() /
                         step_logits[i].abs().max()))
        agree += int((lg[:, -1:].argmax(-1) == tokens[i + 1]).sum())
    del plain, pcache, lg
    print(f"kernel route vs plain route (teacher-forced): max |diff| / max "
          f"|logit| = {rel[0]:.3e} on the prefill, {max(rel[1:]):.3e} over "
          f"the decode steps (tolerance {LOGITS_RTOL}); greedy tokens "
          f"equal in {agree} of {SERVE_B * SERVE_GEN} (information)")
    if not max(rel) <= LOGITS_RTOL:
        raise AssertionError(f"kernel and plain route logits differ: "
                             f"{max(rel)} > {LOGITS_RTOL}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill({"tokens": prompts}, cache_len=cache_len)
    torch.cuda.synchronize()
    warm_prefill_s = time.perf_counter() - t0
    print(f"prefill {SERVE_B}x{SERVE_S} (warm): {warm_prefill_s:.4f} s")
    prof_prefill = _profiled(
        lambda: model.prefill({"tokens": prompts}, cache_len=cache_len))
    _print_profile("prefill", *prof_prefill)
    prof_step = _profiled(lambda: model.decode_step(cache, tok))
    _print_profile("decode step", *prof_step)
    del model, cache, prefill_logits, step_logits
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": prefill_s,
            "warm_prefill_s": warm_prefill_s,
            "decode_ms": statistics.median(step_ms), "rel": max(rel)}


def time_lm_kernels() -> dict:
    """K3, K4, K5 at the serve path's shapes, float32, each in turns with
    its plain version and the library call where one exists: (ms per call,
    plain ms, library ms or None, bound ms, bound_by, kernel ms)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    gen = torch.Generator(device=DEV).manual_seed(8)
    kw = dict(iters=20, warmup=3)
    b, s, h, d = SERVE_B, SERVE_S, 32, 80
    t = SERVE_S + SERVE_GEN
    out = {}

    q, k, v = (_randn((b, s, h, d), gen) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    call = lambda: flash_attention(q, k, v, causal=True)
    ms = _time_turns({
        "kernel": call,
        "plain": lambda: ref.mha_reference(q, k, v, causal=True),
        "library": lambda: sdpa(qt, kt, vt, is_causal=True)}, **kw)
    dev_ms = _device_ms(call, ("flash_fwd",), iters=10)
    nbytes, flops = 4 * b * s * h * d * 4, 2 * b * h * d * s * (s + 1)
    # K3 runs both products on the tensor cores in 3xTF32, three TF32
    # products for each float32 one: that is its bound. The CUDA-core
    # bound (float32 FMA) is kept beside it for the earlier kernel.
    out["flash_attention"] = (ms["kernel"], ms["plain"], ms["library"],
                              *_bound_ms(nbytes, 3 * flops,
                                         TF32_FLOP_PER_S), dev_ms)
    cc_bound, _ = _bound_ms(nbytes, flops)
    print(f"K3 bounds at ({b}, {s}, {h}, {d}) causal: tensor cores in "
          f"3xTF32 {out['flash_attention'][3]:.5f} ms "
          f"({out['flash_attention'][4]}; 3 x {flops / 1e9:.2f} GFLOP at "
          f"{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s TF32), CUDA cores "
          f"{cc_bound:.5f} ms ({flops / 1e9:.2f} GFLOP at "
          f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s), {nbytes / 1e6:.1f} MB "
          f"moved")
    out["cuda_core_bound_ms"] = cc_bound
    del q, k, v, qt, kt, vt

    q = _randn((b, 1, h, d), gen)
    kc, vc = (_randn((b, t, h, d), gen) for _ in range(2))
    tags, idx = _tags(b, t, t - 1)
    mask = ((tags >= 0) & (tags <= idx[:, None]))[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
    call = lambda: decode_attention(q, kc, vc, tags, idx)
    ms = _time_turns({
        "kernel": call,
        "plain": lambda: ref.mha_reference(q, kc, vc, causal=True,
                                           q_offset=idx[:, None],
                                           kv_positions=tags),
        "library": lambda: sdpa(qt, kt, vt, attn_mask=mask)}, **kw)
    dev_ms, *zamba2 = _k4_device_ms(call, _k4_plan(q, kc), require=True)
    seen = int(mask.sum()) // b        # valid slots per row in this run
    out["decode_attention"] = (ms["kernel"], ms["plain"], ms["library"],
                               *_bound_ms(
        (2 * b * seen * h * d + 2 * b * h * d + b * t + b) * 4,
        4 * b * h * seen * d), dev_ms)
    k4_layout(q, kc, seen)
    del q, kc, vc, qt, kt, vt
    # the kernels a call runs at qwen3-moe-235b-a22b's decode shape too,
    # read here: late in the run (phase 17) the profiler keeps too few
    cfg = _moe_config()
    q = _randn((MOE_B, 1, cfg.num_heads, cfg.head_dim), gen)
    kc, vc = (_randn((MOE_B, MOE_S + MOE_GEN, cfg.num_kv_heads,
                      cfg.head_dim), gen) for _ in range(2))
    tags, idx = _tags(MOE_B, MOE_S + MOE_GEN, MOE_S + MOE_GEN - 1)
    _, *moe = _k4_device_ms(lambda: decode_attention(q, kc, vc, tags, idx),
                            _k4_plan(q, kc), require=True)
    out["k4_profile"] = {"zamba2 serve": zamba2, "qwen3-moe serve": moe}
    del q, kc, vc

    hs, p, g, n, chunk = 80, 64, 1, 64, 256
    x, dt, a, bm, cm = _ssd_inputs(gen, b, s, hs, p, g, n)
    call = lambda: ssd_chunked(x, dt, a, bm, cm, chunk=chunk)
    ms = _time_turns({
        "kernel": call,
        "plain": lambda: ref.ssd_chunked_reference(x, dt, a, bm, cm,
                                                   chunk=chunk)}, **kw)
    dev_ms = _device_ms(call, K5_KERNELS, iters=10)
    # K5 runs its products on the tensor cores in 3xTF32: its bound_ms is
    # that bound; the CUDA-core bound is kept beside it
    k5_tc, k5_cc, k5_by = _k5_bounds(b, s, hs, p, g, n, chunk)
    out["ssd_chunked"] = (ms["kernel"], ms["plain"], None, k5_tc, k5_by,
                          dev_ms)
    out["k5_cuda_core_bound_ms"] = k5_cc
    flops = _k5_flops(b, s, hs, p, g, n, chunk)
    per_head = _k5_flops(b, s, hs, p, g, n, chunk, per_head_scores=True)
    print(f"K5 bounds at ({b}, {s}, {hs}, {p}, {g}, {n}, {chunk}): tensor "
          f"cores in 3xTF32 {k5_tc:.5f} ms ({k5_by}; 3 x "
          f"{flops / 1e9:.2f} GFLOP at {TF32_FLOP_PER_S / 1e12:.0f} "
          f"TFLOP/s TF32), CUDA cores {k5_cc:.5f} ms; with C B^T counted "
          f"once per head ({per_head / 1e9:.2f} GFLOP): "
          f"{3 * per_head / TF32_FLOP_PER_S * 1e3:.5f} and "
          f"{per_head / F32_FLOP_PER_S * 1e3:.5f} ms")
    del x, dt, a, bm, cm
    # a long sequence: 32 chunks, which the kernel runs side by side
    long_l = 8 * s
    x, dt, a, bm, cm = _ssd_inputs(gen, b, long_l, hs, p, g, n)
    call = lambda: ssd_chunked(x, dt, a, bm, cm, chunk=chunk)
    long_ms = _time_ms(call, iters=10, warmup=2)
    long_dev = _device_ms(call, K5_KERNELS, iters=5)
    long_tc, long_cc, _ = _k5_bounds(b, long_l, hs, p, g, n, chunk)
    print(f"K5 at ({b}, {long_l}, {hs}, {p}, {g}, {n}, {chunk}): "
          f"{long_ms:.5f} ms per call (kernel alone {long_dev:.5f} ms), "
          f"bound {long_tc:.5f} ms in 3xTF32, {long_cc:.5f} ms on the "
          f"CUDA cores")
    del x, dt, a, bm, cm
    for name in ("flash_attention", "decode_attention", "ssd_chunked"):
        ms, plain_ms, lib_ms, bound, by, dev_ms = out[name]
        lib = "none" if lib_ms is None else f"{lib_ms:.5f} ms"
        print(f"{name}: {ms:.5f} ms per call (kernel alone {dev_ms:.5f} "
              f"ms), plain {plain_ms:.5f} ms, library {lib} (in turns), "
              f"bound {bound:.5f} ms ({by})")
    return out


def _k4_plan(q, k) -> k4.Plan:
    """K4's plan for these q and cache tensors on this card."""
    b, _, h, d = q.shape
    return k4.plan(b, k.shape[1], h, k.shape[2], d, q.element_size(),
                   torch.cuda.get_device_properties(0).multi_processor_count)


def _k4_device_ms(call, p: k4.Plan, iters: int = 10,
                  require: bool = False) -> tuple:
    """K4's kernel-alone time (every kernel a call runs: the split pass,
    and the merge when there is more than one split) and, from the same
    profile, the launches of each that it kept over the ``iters`` calls
    and the kernels a call ran by them (kept launches over kept split
    passes; None when it kept none). Raises where a profile that kept a
    split pass shows the merge and the plan has one split, or no merge
    and the plan has more; with ``require``, also where it kept none."""
    names = K4_KERNELS[:1 + (p.splits > 1)]
    kept = {}
    dev = _device_ms(call, names, iters=iters, per_count=len(names),
                     kept=kept)
    launches = {"calls": iters, **{
        n: sum(c for key, c in kept.items() if n in key)
        for n in K4_KERNELS}}
    split, merge = (launches[n] for n in K4_KERNELS)
    if (split and (merge > 0) != (p.splits > 1)) or (require and not split):
        raise AssertionError(f"K4's profile shows {split} split passes and "
                             f"{merge} merges in {iters} calls; its plan "
                             f"has {p.splits} splits")
    per_call = (split + merge) / split if split else None
    print(f"K4's profile: {split} split passes and {merge} merges kept of "
          f"{iters} calls ({per_call} kernels a call)")
    return dev, launches, per_call


def k4_layout(q, k, seen: int) -> None:
    """Prints K4's plan at q's and k's shapes: splits, grid, route, heads
    a block, shared memory, the bytes a call moves and the single-read
    bound over ``seen`` valid slots a row."""
    b, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    p = _k4_plan(q, k)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sz = q.element_size()
    cache = 2 * b * t * kh * d * sz
    single = 2 * b * seen * kh * d * sz
    scratch = p.splits * b * h * (d + 2) * 4 if p.splits > 1 else 0
    blocks = p.splits * kh * p.hgroups * b
    print(f"K4 at ({b}, {t}, {h} over {kh}, {d}): {p.splits} splits of "
          f"{p.split_len} slots, tiles of {p.tile} in rings of "
          f"{p.stages}, on the "
          f"{'tensor' if p.tensor_cores else 'CUDA'} cores; grid "
          f"{p.splits} x {kh * p.hgroups} x {b} = {blocks} blocks on "
          f"{sms} SMs ({blocks / sms:.2f} an SM), {p.heads} query heads, "
          f"{p.teams} teams of {p.team_warps} warps and {p.smem} bytes of "
          f"shared memory a block; the split pass "
          f"{'and the merge' if p.splits > 1 else 'alone'} a call; each KV "
          f"head's cache read {p.hgroups} time(s): {cache / 1e6:.2f} MB "
          f"({cache / HBM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s), the "
          f"single-read bound over the {seen} valid slots a row "
          f"{single / 1e6:.2f} MB ({single / HBM_BYTES_PER_S * 1e3:.5f} "
          f"ms); split states {scratch / 1e6:.2f} MB written and read back "
          f"by the merge (L2)")


def _k5_flops(b, l, h, p, g, n, chunk, per_head_scores=False) -> int:
    """K5's operations: for each chunk and head the causal half of
    (C B^T o L)(dt x) and the chunk state, C h^T for every chunk but the
    first (which enters with h = 0), and the causal half of the scores
    C B^T once per head group (once per head, as the kernel before the
    redesign computed them, with ``per_head_scores``)."""
    chunks = -(-l // chunk)
    half = chunk * (chunk + 1) // 2
    scores = (h if per_head_scores else g) * half * n
    return 2 * b * (chunks * (h * (half * p + chunk * p * n) + scores) +
                    (chunks - 1) * h * chunk * p * n)


def _k5_bounds(b, l, h, p, g, n, chunk) -> tuple[float, float, str]:
    """K5's (3xTF32 tensor-core bound ms, CUDA-core bound ms, what bounds
    the first) for the operations of :func:`_k5_flops` against x, y, B,
    C, dt, a and the state moved once."""
    flops = _k5_flops(b, l, h, p, g, n, chunk)
    nbytes = (2 * b * l * h * p + 2 * b * l * g * n + b * l * h + h +
              b * h * p * n) * 4
    tc, by = _bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
    cc, _ = _bound_ms(nbytes, flops)
    return tc, cc, by


def ptxas_lines(log: str) -> list[str]:
    """The entry, register and spill lines of an ``nvcc -Xptxas -v`` log."""
    keep = ("Compiling entry function", "Used ", "spill")
    return [line.strip() for line in log.splitlines()
            if any(k in line for k in keep)]


def count_hmma(name: str = "flash_attention") -> str:
    """How many tensor-core (HMMA) instructions the built library of
    ``csrc/<name>.cu`` holds, by cuobjdump where the toolkit has it."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        return f"cuobjdump does not exist beside nvcc ({cuobjdump})"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return (f"{name}: {sass.count('HMMA')} HMMA (tensor-core) and "
            f"{sass.count('LDGSTS')} LDGSTS (cp.async) instructions in "
            f"its SASS, by cuobjdump")


# ------------------------------------------------------- 16. LM training

TRAIN_ARCH = "qwen3-0.6b"
# the acceptance command: python -m repro_torch.launch.train --arch
# qwen3-0.6b --steps 3 --clients 8 --judge-backend cuda (28 layers,
# 596,180,992 params; 8 clients x 2 windows of 129 tokens a step)
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", "3", "--clients", "8"]
TRAIN_STEPS = 3
TRAIN_PARAMS = 596_180_992
# the torch route's step against the cuda route's: with equal masks the
# two runs do the same arithmetic, so the loss and the gradient norm are
# held to a relative 1e-6 and the entropies (K1 against the plain loop,
# float32 sums over 152,064 classes in another order) to K1_ATOL
TRAIN_RTOL = 1e-6
LMSTEP_LAYERS = 4                     # depth cut; widths are qwen3-0.6b's
LMSTEP_PARAMS = 218_638_336
LMSTEP_ROUNDS = 3
LMSTEP_WINDOWS, LMSTEP_SEQ = 8, 128   # 8 windows of 129 tokens a client
LMSTEP_REDUCED_SEQ = 32
# phase 16's lmstep pair peak before the recompute applied under
# torch.func (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): both
# servers' captured graphs alive, the gradient through torch.func.grad,
# the layers run plainly. Another protocol than this run's: printed
# beside it, compared with nothing; remat_rounds splits the difference
# by cause within one run
LMSTEP_PEAK_BEFORE_GIB = 29.942
# lmstep's client program under (remat, gradient form): "vjp" is
# fl.strategies.pulled_grad, the port's; "grad" torch.func.grad, its
# form before (the same bits)
LMSTEP_VARIANTS = (("none", "grad"), ("none", "vjp"), ("full", "vjp"),
                   ("full", "grad"))


class CheckedJudge:
    """Phase 16's torch-route judge of the gradient step: the plain
    float32 loop on each step's soft labels, held against K1's loop on
    the same labels (launched outside the counted run). Equal verdicts
    pass; a split must be a float32 tie (the removal orders part where
    the two choices differ in float64 by less than float32's spacing at
    the entropy, ROADMAP F5), which is printed and followed, so the two
    runs take the same steps; any other split raises. Keeps each step's
    soft labels and sizes and the largest entropy gap."""

    def __init__(self):
        self.seen = []
        self.ties = []
        self.ent_err = 0.0

    def __call__(self, soft, sizes):
        self.seen.append((soft.clone(), sizes.clone()))
        plain = judge(soft, sizes, backend="torch")
        kern = judge(soft, sizes, backend="cuda")
        order_p = plain.removal_order[:int(plain.num_removed)].tolist()
        order_k = kern.removal_order[:int(kern.num_removed)].tolist()
        ent = float(kern.entropy)
        err = abs(float(plain.entropy) - ent)
        self.ent_err = max(self.ent_err, err)
        if order_p == order_k:
            return plain
        step, gap = _split_margin((soft, sizes, None, None, None), order_k,
                                  order_p)
        ulp = _f32_ulp(ent)
        if not (gap < ulp and err <= K1_ATOL):
            raise AssertionError(
                f"gradient step {len(self.seen) - 1}: the plain loop removes "
                f"{order_p}, K1 {order_k}; they part at step {step} by "
                f"{gap} in float64, not below float32's spacing {ulp:.3e}")
        print(f"gradient step {len(self.seen) - 1}: float32 tie: the plain "
              f"loop removes {order_p}, K1 {order_k}; they part at step "
              f"{step}, {gap:.3e} apart in float64 (spacing {ulp:.3e}); "
              "the torch route follows K1's verdict")
        self.ties.append((len(self.seen) - 1, step, gap))
        return kern


def _lm_config(layers: int | None = None):
    """The config ``train.main(TRAIN_ARGV)`` trains (its own
    ``remat="full"``), optionally cut to ``layers``."""
    cfg = train.train_config(train.parser().parse_args(TRAIN_ARGV))
    return cfg if layers is None else cfg.replace(num_layers=layers)


def _gib(n: int) -> str:
    return f"{n / 2**30:.3f} GiB"


def gradient_step() -> dict:
    """One more step of the cuda route at full width, timed and profiled:
    (the step's wall s, busy s, idle share)."""
    cfg = _lm_config()
    args = train.parser().parse_args(TRAIN_ARGV)
    model = build_model(cfg, device=DEV, kernels="torch", seed=args.seed)
    corpus, idx = train.build_fl_corpus(cfg, args.logical_clients,
                                        args.case, args.seq_len, args.seed)
    rows = np.concatenate([corpus[idx[c][:args.per_client_batch]]
                           for c in range(args.clients)])
    batch = {"tokens": torch.from_numpy(rows).to(DEV)}
    opt = sgd(lr=args.lr, momentum=0.5)
    step = make_train_step(model, opt, FedSpec(num_clients=args.clients),
        judge_fn=fl.MaxEntropyJudge("cuda").traced())
    params = {k: v.detach() for k, v in model.params().items()}
    state = opt.init(params)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _busy_s(prof)
    by_kernel = _kernel_us(prof)
    print(f"gradient step at full width, host clock ending in a "
          f"synchronise: {[round(w, 4) for w in walls]} s (first after "
          f"build), median of the last 3 {statistics.median(walls[1:]):.4f}"
          f" s")
    print(f"profiled gradient step: wall {wall:.4f} s, device busy (union "
          f"of kernel intervals) {busy:.4f} s, idle share "
          f"{1 - busy / wall:.3f} (profiler on)")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    return {"step_s": statistics.median(walls[1:]), "profiled_s": wall,
            "busy_s": busy}


def build_lmstep(model, cfg, data, engine="sequential", stub=None, **kw):
    """``fl.build("fedentropy", lm_window_apply(...), strategy="lmstep")``
    as ``launch.train --lm-objective window`` builds it: 8 logical
    clients, cohorts of 4, E = 1, minibatches of 2, lr 0.01; with K2
    aggregating (``FusedAverageAggregator("cuda")``, passed here: the
    CLI's aggregator is the composition's)."""
    params = {k: v.detach() for k, v in model.params().items()}
    return fl.build(
        "fedentropy", train.lm_window_apply(model, cfg, stub), params, data,
        fl.ServerConfig(num_clients=8, participation=0.5, seed=0),
        fl.LocalSpec(epochs=1, lr=0.01, batch_size=2), strategy="lmstep",
        aggregator=fl.FusedAverageAggregator("cuda"), engine=engine,
        device=DEV, **kw)


def _lm_data(cfg, seq: int, windows: int | None = None) -> dict:
    corpus, idx = train.build_fl_corpus(cfg, 8, "case1", seq, 0)
    return train.stack_lm_clients(corpus, idx, windows or LMSTEP_WINDOWS,
                                  seq, 0)


def _counted_rounds(server, label: str, rounds: int) -> tuple[dict, list]:
    _reset_counts()
    walls = [timed_round(server, label) for _ in range(rounds)]
    torch.cuda.synchronize()
    return _read_counts(), walls


def _time_lm_kernels(soft8, sizes8, soft4, sizes4, p: int) -> dict:
    """K1's loop on the gradient step's (8, 152064) soft labels and on
    lmstep's (4, 152064), each held against its plain version
    (:func:`_loop_err`), and K2 at (4, P), in turns with their plain
    versions (and ``w @ flat`` for K2), with device times and bounds.
    ``k1_err`` is the larger entropy error of the two K1 inputs."""
    times = {"k1_err": 0.0}
    for label, soft, sizes in (("K1 loop step", soft8, sizes8),
                               ("K1 loop lmstep", soft4, sizes4)):
        call = lambda: entropy_judge_loop(soft, sizes)
        times["k1_err"] = max(times["k1_err"], _loop_err(
            f"{label.removeprefix('K1 loop ')} {tuple(soft.shape)}", call(),
            ref.entropy_judge_loop_reference(soft, sizes),
            (soft, sizes, None, None, None)))
        t = _time_turns({"kernel": call,
                         "plain": lambda: ref.entropy_judge_loop_reference(
                             soft, sizes)}, iters=20, warmup=3)
        nbytes, ops, iters = _k1_loop_work(*soft.shape, call())
        bound, by = _bound_ms(nbytes, ops)
        dev = _device_ms(call, ("judge_loop",), iters=20)
        print(f"{label} at {tuple(soft.shape)}: {t['kernel']:.5f} ms per "
              f"call (kernel alone {dev:.5f} ms; {iters} iterations, "
              f"{_loop_kernel_of(*soft.shape)}), plain {t['plain']:.5f} ms,"
              f" bound {bound:.5f} ms ({by}); floor of the logarithms "
              f"{_k1_log_floor_ms(*soft.shape):.3e} ms an iteration on 132 "
              f"SMs")
        times[label] = (t["kernel"], t["plain"], None, bound, by, dev,
                        tuple(soft.shape))
    m = soft4.shape[0]
    gen = torch.Generator(device=DEV).manual_seed(2)
    flat = torch.randn((m, p), generator=gen, device=DEV)
    w = torch.rand(m, generator=gen, device=DEV)
    call = lambda: masked_weighted_sum(flat, w)
    if not torch.equal(call(), ref.masked_weighted_sum_reference(flat, w)):
        raise AssertionError(f"K2 at ({m}, {p}) differs from its plain "
                             "version")
    t = _time_turns({"kernel": call,
                     "plain": lambda: ref.masked_weighted_sum_reference(
                         flat, w),
                     "library": lambda: w @ flat}, iters=10, warmup=2)
    nbytes = (m * p + m + p) * 4
    bound, by = _bound_ms(nbytes, 2 * m * p)
    dev = _device_ms(call, ("masked_weighted_sum",), iters=10)
    print(f"K2 at ({m}, {p}) (lmstep's aggregation, {nbytes / 1e9:.3f} GB "
          f"moved, {m * p * 4 / 1e9:.3f} GB read): {t['kernel']:.5f} ms "
          f"per call (kernel alone {dev:.5f} ms), plain {t['plain']:.5f} "
          f"ms, w @ flat {t['library']:.5f} ms, bound {bound:.5f} ms ({by})"
          f"; {bound / dev:.3f} of the bound")
    times["K2 lmstep"] = (t["kernel"], t["plain"], t["library"], bound, by,
                          dev, (m, p))
    del flat
    return times


def lmstep_verdicts(rec: RecordingJudge, pip) -> float:
    """K1's loop on each lmstep round's (4, 152064) soft labels against its
    plain version (:func:`_loop_err`), and each missed speculation of the
    pipelined engine printed beside the float64 oracle's verdict (the
    sequential server's, ``rec``): a miss is allowed only where the two
    removal orders part at a tie, two choices within Alg. 1's 1e-6
    margin in float64. Returns the larger entropy error."""
    worst = 0.0
    for r, ((soft, sizes), (_, oracle, _), hist) in enumerate(zip(
            rec.seen, rec.verdicts, pip.history, strict=True)):
        args = (soft, sizes, None, None, None)
        got = entropy_judge_loop(soft, sizes)
        worst = max(worst, _loop_err(
            f"lmstep round {r} {tuple(soft.shape)}", got,
            ref.entropy_judge_loop_reference(soft, sizes), args))
        if hist["spec_hit"]:
            continue
        g = ref.unpack_judgment(got)
        spec = g[1][:int(g[2])].tolist()
        if spec == list(oracle):
            raise AssertionError(f"lmstep pipelined round {r} missed, but "
                                 f"K1 removed {spec} as the oracle did")
        step, gap = _split_margin(args, spec, list(oracle))
        print(f"lmstep pipelined round {r} missed: K1 removed rows {spec}, "
              f"the float64 oracle {list(oracle)}; they part at step {step}"
              f", {gap:.3e} apart in float64")
        if not gap < TOL:
            raise AssertionError(f"lmstep pipelined round {r} missed by "
                                 f"{gap} in float64, not at a tie")
    return worst


def hold_to_torch_judge(argv: list, cfg, n_params: int, recs_k: list,
                        what: str) -> "CheckedJudge":
    """The mesh step of ``argv`` again from the same params with the
    plain float32 judge (:class:`CheckedJudge`, each verdict held against
    K1's loop on the same labels) against ``recs_k``, the K1 run's
    records: masks equal (a split only at a float32 tie, followed), loss
    and gradient norm within TRAIN_RTOL relative, entropies within
    K1_ATOL. Returns the judge (its labels, ties and entropy gap)."""
    args = train.parser().parse_args(argv + ["--judge-backend", "torch",
                                             "--device", DEV])
    model = build_model(cfg, device=DEV, kernels=args.attn, seed=args.seed)
    if model.num_params() != n_params:
        raise AssertionError(f"{what}: {model.num_params()} params")
    corpus, idx = train.build_fl_corpus(cfg, args.logical_clients,
                                        args.case, args.seq_len, args.seed)
    checked = CheckedJudge()
    recs_p = train.run_mesh_engine(args, cfg, model, corpus, idx,
                                   judge_fn=checked)
    worst = _held_steps(recs_k, recs_p, what)
    print(f"{what}, torch judge vs K1 (cuda): masks equal over "
          f"{len(recs_k)} steps ({len(checked.ties)} float32 ties followed"
          f"), loss and grad norm within {worst:.3e} relative (limit "
          f"{TRAIN_RTOL:.0e}), K1 vs plain entropy within "
          f"{checked.ent_err:.3e} (limit {K1_ATOL:.0e})")
    return checked


def _held_steps(recs_a: list, recs_b: list, what: str) -> float:
    """Two mesh runs of the same steps: masks and cohorts equal, the
    entropies within K1_ATOL, finite; returns the larger relative gap of
    the loss and the gradient norm, which must be within TRAIN_RTOL."""
    worst = 0.0
    for a, b in zip(recs_a, recs_b, strict=True):
        if (a["mask"], a["selected"]) != (b["mask"], b["selected"]):
            raise AssertionError(f"{what}: step {a['step']}: masks "
                                 f"{a['mask']} vs {b['mask']}")
        if not all(math.isfinite(r[k]) for r in (a, b)
                   for k in ("loss", "grad_norm", "entropy")):
            raise AssertionError(f"{what}: non-finite step {a} / {b}")
        for key in ("loss", "grad_norm"):
            worst = max(worst, abs(a[key] - b[key]) / abs(a[key]))
        if abs(a["entropy"] - b["entropy"]) > K1_ATOL:
            raise AssertionError(f"{what}: step {a['step']}: entropy "
                                 f"{a['entropy']} vs {b['entropy']}")
        print(f"{what}: step {a['step']}: mask {a['mask']} on both; loss "
              f"{a['loss']:.7f} vs {b['loss']:.7f}; grad norm "
              f"{a['grad_norm']:.6f} vs {b['grad_norm']:.6f}; entropy "
              f"{a['entropy']:.6f} vs {b['entropy']:.6f}")
    if worst > TRAIN_RTOL:
        raise AssertionError(f"{what}: loss or grad norm apart by {worst} "
                             f"> {TRAIN_RTOL}")
    return worst


def lmstep_pair(cfg, n_params: int, what: str, stub=None,
                windows: int | None = None) -> dict:
    """lmstep at ``cfg`` (a depth cut), 8 logical clients of ``windows``
    (default LMSTEP_WINDOWS) windows of LMSTEP_SEQ + 1 tokens:
    LMSTEP_ROUNDS rounds on the sequential server (K2 a round) and on the
    pipelined engine speculating in K1's loop (K1 a round, K2 a round and
    one more a miss), each client program one CUDA graph, equal bit for
    bit; each miss only at a tie; ``stub`` the vlm and encdec families'
    frontend (``train.stub_frontend``). Returns the launches by path
    (``<what> sequential``, ``<what> pipelined``), round 0's judge inputs
    and the larger K1 entropy error."""
    model = build_model(cfg, device=DEV, kernels="torch", seed=0)
    if model.num_params() != n_params:
        raise AssertionError(f"{what}: {model.num_params()} params at "
                             f"depth {cfg.num_layers}")
    data = _lm_data(cfg, LMSTEP_SEQ, windows)
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    rec = RecordingJudge(fl.MaxEntropyJudge())
    seq = build_lmstep(model, cfg, data, judge=rec, stub=stub)
    ls, walls_s = _counted_rounds(seq, f"{what} sequential", LMSTEP_ROUNDS)
    # a captured client program's private pool stays reserved while it is
    # cached, about 1.5x its peak of live tensors, so two servers' graphs
    # need not fit beside each other: the sequential server's goes before
    # the pipelined engine captures its own (its records and params stay)
    torch.cuda.synchronize()
    seq_peak = torch.cuda.max_memory_allocated()
    seen_seq = torch.cuda.max_memory_reserved()
    held = torch.cuda.memory_allocated()
    seq.drop_graphs()
    gc_collect()
    held -= torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pip = build_lmstep(model, cfg, data, engine="pipelined", runtime=SPEC,
                       stub=stub)
    lp, walls_p = _counted_rounds(pip, f"{what} pipelined", LMSTEP_ROUNDS)
    torch.cuda.synchronize()
    pip_peak = torch.cuda.max_memory_allocated()
    equal_to_sequential(seq, pip, f"{what} pipelined vs sequential")
    misses = sum(not r["spec_hit"] for r in pip.history)
    k1_err = lmstep_verdicts(rec, pip)
    k1s, k2s, k1p, k2p = (ls["entropy_judge_loop"],
                          ls["masked_weighted_sum"],
                          lp["entropy_judge_loop"],
                          lp["masked_weighted_sum"])
    if (k1s, k2s, k1p, k2p) != (0, LMSTEP_ROUNDS, LMSTEP_ROUNDS,
                                LMSTEP_ROUNDS + misses):
        raise AssertionError(f"{what} launches: sequential K1 {k1s} K2 "
                             f"{k2s}, pipelined K1 {k1p} K2 {k2p} with "
                             f"{misses} misses")
    if seq.graphs_captured != 1 or pip.graphs_captured != 1:
        raise AssertionError(f"{what}: the client program was not "
                             "captured")
    print(f"{what} at depth {cfg.num_layers} ({n_params:,} params): "
          f"sequential K1 {k1s} K2 {k2s}; pipelined K1 {k1p} K2 {k2p} "
          f"({misses} misses); round s sequential "
          f"{[round(w, 4) for w in walls_s]}, pipelined "
          f"{[round(w, 4) for w in walls_p]}; remat {cfg.remat!r}, "
          f"recomputed under torch.func; peak device memory "
          f"{_gib(seq_peak)} on the sequential server (reserved "
          f"{_gib(seen_seq)}), whose graph then held {_gib(held)} "
          f"allocated and was dropped; {_gib(pip_peak)} on the pipelined "
          f"engine after it ({_gib(torch.cuda.max_memory_reserved())} "
          "reserved)")
    seen = rec.seen[0]
    del seq, pip, rec, model
    gc_collect()
    return {"launches": {f"{what} sequential": ls, f"{what} pipelined": lp},
            "seen": seen, "k1_err": k1_err,
            "peak": max(seq_peak, pip_peak), "seq_peak": seq_peak,
            "pip_peak": pip_peak, "held": held}


def lm_training_path() -> dict:
    """Phase 16: the gradient-level FedEntropy step at qwen3-0.6b's full
    configuration through ``launch.train``'s entry point (K1's loop once a
    step), against the torch route from the same params; lmstep at
    qwen3-0.6b widths, depth 4, sequential against pipelined (K1, K2);
    lmstep on the async and scan engines at the reduced config; the cuda
    route's refusal of autograd. Returns the paths' launches and the LM
    shapes' kernel times."""
    launches = {}
    cfg = _lm_config()
    n = TRAIN_PARAMS
    logits = 16 * 129 * cfg.padded_vocab * 4
    print(f"reckoning: {n:,} params, {_gib(n * 4)} each of the donated "
          f"weights, the gradients and the SGD momentum "
          f"({_gib(3 * n * 4)}); logits (16, 129, {cfg.padded_vocab}) "
          f"float32 {_gib(logits)} a copy, about 5 live; remat "
          f"{cfg.remat!r} keeps each layer's input: "
          f"{_gib(3 * n * 4 + 5 * logits)} expected at the peak")

    # (a) the gradient step: the CLI's main, counted
    gc_collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    # the command as a user gives it: no flag names the device, which
    # defaults to the card (a rehearsal on the CPU names it)
    recs_k = train.main(TRAIN_ARGV + ["--judge-backend", "cuda"] + (
        [] if DEV == "cuda" else ["--device", DEV]))
    torch.cuda.synchronize()
    launches["lm mesh step"] = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(WRAPPERS, 0)
    want["entropy_judge_loop"] = TRAIN_STEPS
    if launches["lm mesh step"] != want:
        raise AssertionError(f"gradient step launches "
                             f"{launches['lm mesh step']}; expected {want}")
    print(f"gradient step (cuda route, train.main, remat "
          f"{cfg.remat!r}): launches {launches['lm mesh step']}; peak "
          f"device memory {_gib(peak)} ({_gib(peak - base)} above the "
          f"{_gib(base)} held before; PR 25's step, remat 'none' and "
          f"undonated: 18.9 GiB above); step s "
          f"{[round(r['seconds'], 4) for r in recs_k]}")

    # the torch route from the same params, each verdict held against K1
    gc_collect()
    checked = hold_to_torch_judge(TRAIN_ARGV, cfg, TRAIN_PARAMS, recs_k,
                                  "gradient step")
    soft8, sizes8 = checked.seen[0]
    gc_collect()
    timed = gradient_step()
    gc_collect()

    # (b) lmstep at qwen3-0.6b widths, depth 4: sequential vs pipelined
    pair = lmstep_pair(_lm_config(LMSTEP_LAYERS), LMSTEP_PARAMS, "lmstep")
    launches.update(pair["launches"])
    gc_collect()
    forms = remat_rounds(_lm_config(LMSTEP_LAYERS), LMSTEP_PARAMS, "lmstep",
                         None, LMSTEP_WINDOWS, LMSTEP_VARIANTS)
    print(f"lmstep at depth 4, {LMSTEP_WINDOWS} windows: pair peak "
          f"{_gib(pair['peak'])} (sequential {_gib(pair['seq_peak'])}, "
          f"pipelined {_gib(pair['pip_peak'])} after the sequential graph's "
          f"{_gib(pair['held'])} were dropped); the pair before, both "
          f"graphs alive, grad, layers plain: {LMSTEP_PEAK_BEFORE_GIB:.3f} "
          f"GiB. One round, one graph: 'none'+grad (the client program "
          f"before) "
          f"{_gib(forms['none', 'grad'])}, 'none'+vjp "
          f"{_gib(forms['none', 'vjp'])}, 'full'+vjp "
          f"{_gib(forms['full', 'vjp'])}, 'full'+grad "
          f"{_gib(forms['full', 'grad'])}")
    soft4, sizes4 = pair["seen"]
    kernel_times = _time_lm_kernels(soft8, sizes8, soft4, sizes4,
                                    LMSTEP_PARAMS)
    k1_err = max(pair["k1_err"], checked.ent_err,
                 kernel_times.pop("k1_err"))
    gc_collect()

    # (c) the async and scan engines at the reduced config
    cfgr = ARCHS[TRAIN_ARCH].reduced()
    model_r = build_model(cfgr, device=DEV, kernels="torch", seed=0)
    data_r = _lm_data(cfgr, LMSTEP_REDUCED_SEQ)
    seq_r = build_lmstep(model_r, cfgr, data_r,
                         judge=fl.MaxEntropyJudge("cuda"))
    _counted_rounds(seq_r, "lmstep reduced sequential", LMSTEP_ROUNDS)
    asy = build_lmstep(model_r, cfgr, data_r,
                       judge=fl.MaxEntropyJudge("cuda"), engine="async",
                       runtime=ASYNC)
    launches["lmstep async"] = run_async(asy, "lmstep async", LMSTEP_ROUNDS)
    equal_to_sequential(seq_r, asy, "lmstep async (zero clock) vs "
                        "sequential", flags=False, extra=ASYNC_KEYS)
    seq_t = build_lmstep(model_r, cfgr, data_r, selector="pools-traced")
    for _ in range(2 * 2):
        seq_t.round()
    scan = build_lmstep(model_r, cfgr, data_r, selector="pools-traced",
                        engine="scan", runtime=fl.ScanConfig(
                            rounds_per_scan=2))
    launches["lmstep scan"] = run_scan(scan, 2 * 2, "lmstep scan")
    if not scan.stats()["captured_block"] or scan.scan_rounds() != 2:
        raise AssertionError(f"lmstep scan: {scan.stats()}")
    equal_to_sequential(seq_t, scan, "lmstep scan (2 blocks of 2) vs "
                        "sequential")
    del seq_r, asy, seq_t, scan, model_r
    gc_collect()

    # (d) the cuda route refuses autograd on the card
    q = torch.randn(1, 8, 2, 16, device=DEV, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, device=DEV)
    x = torch.randn(1, 8, 2, 16, device=DEV, requires_grad=True)
    dt, a = torch.rand(1, 8, 2, device=DEV), -torch.rand(2, device=DEV)
    b = torch.randn(1, 8, 1, 16, device=DEV)
    for what, call in (
            ("ops.attention(backend='cuda'), K3",
             lambda: kernel_ops.attention(q, k, k, backend="cuda")),
            ("ops.ssd(backend='cuda'), K5",
             lambda: kernel_ops.ssd(x, dt, a, b, b, chunk=8,
                                    backend="cuda"))):
        try:
            call()
        except RuntimeError as err:
            if "no backward" not in str(err):
                raise
            print(f"{what} on CUDA tensors that require grad: refused "
                  f"({str(err)[:60]}...)")
        else:
            raise AssertionError(f"{what} ran under autograd")
    return {"launches": launches, "kernels": kernel_times, **timed,
            "peak_bytes": peak, "k1_err": k1_err}


# ------------------------------------------- 17. qwen3-moe-235b-a22b serve

def _moe_config():
    return ARCHS[MOE_ARCH].replace(num_layers=MOE_LAYERS, remat="none",
                                   param_dtype="float32", dtype="float32")


class RoutingRecorder:
    """Forward pre-hooks on every layer's MoE block. For each call (the
    prefill, then each decode step) and layer they keep the block's input
    and its routing as ``moe.route`` and ``moe.positions`` compute it:
    the block's own functions on the block's own input. Everything stays
    on the card until :meth:`host` (no host read inside a timed step)."""

    def __init__(self, model):
        self.cfg, self.calls = model.cfg, []
        self.handles = [lp.moe.register_forward_pre_hook(self._hook(i))
                        for i, lp in enumerate(model.net.layers)]

    def _hook(self, layer):
        def hook(block, args):
            xt = args[0].reshape(-1, args[0].shape[-1])
            if layer == 0:
                self.calls.append([])
            _, top_i, _, probs = moe_mod.route(self.cfg, block.router.w, xt)
            self.calls[-1].append({
                "x": xt.clone(), "probs": probs, "top_i": top_i,
                "pos": moe_mod.positions(top_i),
                "cap": moe_mod.capacity(self.cfg, xt.shape[0])})
        return hook

    def host(self) -> list:
        """Removes the hooks; the calls with the integers as numpy."""
        for h in self.handles:
            h.remove()
        for call in self.calls:
            for rec in call:
                rec["top_i"] = rec["top_i"].cpu().numpy()
                rec["pos"] = rec["pos"].cpu().numpy()
        return self.calls


def _kth_margin(probs_row: torch.Tensor, k: int) -> float:
    """The k-th largest probability minus the (k+1)-th, float32."""
    top = torch.topk(probs_row, k + 1).values
    return float(top[k - 1] - top[k])


def _by_expert(top_i: np.ndarray, pos: np.ndarray, e: int) -> np.ndarray:
    """(T, E): each token's position in each expert, -1 where the token
    is not routed there."""
    t, k = top_i.shape
    out = np.full((t, e), -1, dtype=np.int64)
    out[np.repeat(np.arange(t), k), top_i.reshape(-1)] = pos
    return out


def routing_splits(model, rec_k: list, rec_p: list, b: int, s: int):
    """Holds the plain route's routing (``rec_p``) against the kernel
    route's (``rec_k``), call by call and layer by layer.

    A token whose top-k expert set differs between the routes is a
    split. The two routes' attention differs within its tolerance, so
    the router's inputs differ by that much, and a token at a near-tie
    of its k-th and (k+1)-th experts can change sides. A split is
    admissible when it is a tie at the phase's tolerance: the token's
    router input agrees between the routes within LOGITS_RTOL (max |diff|
    / max |x|), and the experts it swaps differ in router probability,
    recomputed in float64 from the kernel route's input, by less than
    LOGITS_RTOL of the larger one. Each split is printed with both
    routes' k-th/(k+1)-th float32 margins and float32's spacing at the
    probability (information). A split changes the token's output, so
    from the next layer on every later position of its row (causal
    attention) is downstream of it: left out of the set comparisons and
    of the logits. Positions in expert depend only on which earlier
    tokens an expert took, so each expert's positions are compared up to
    the first token whose membership in it differs, and its dropped count
    where none does. Returns (first, splits, bad, counts): first[r] the
    first position of row r downstream of a split (inf when none), every
    split, the failures, and how much each comparison covered."""
    cfg = model.cfg
    k, e = cfg.experts_per_token, cfg.num_experts
    first = np.full(b, np.inf)
    splits, bad = [], []
    counts = {"tokens": 0, "assignments": 0, "experts_dropped": 0,
              "order": 0, "pairs": 0}
    for c, (call_k, call_p) in enumerate(zip(rec_k, rec_p)):
        per_row = s if c == 0 else 1
        base = 0 if c == 0 else s + c - 1        # position of the token
        for layer, (lk, lp) in enumerate(zip(call_k, call_p)):
            ik, ip = lk["top_i"], lp["top_i"]
            t = ik.shape[0]
            rows = np.arange(t) // per_row
            where = base + np.arange(t) % per_row
            out = where >= first[rows]               # downstream of a split
            same = (np.sort(ik, 1) == np.sort(ip, 1)).all(1)
            counts["tokens"] += int((~out).sum())
            counts["order"] += int((~out & same & (ik != ip).any(1)).sum())
            counts["pairs"] += 1
            dk = _by_expert(ik, lk["pos"], e)
            dp = _by_expert(ip, lp["pos"], e)
            differ = (dk >= 0) != (dp >= 0)
            upto = np.where(differ.any(0), differ.argmax(0), t)
            ok = (np.arange(t)[:, None] < upto[None, :]) & (dk >= 0)
            if not np.array_equal(dk[ok], dp[ok]):
                bad.append(f"call {c} layer {layer}: positions in expert "
                           f"differ where the experts' earlier tokens agree")
            counts["assignments"] += int(ok.sum())
            whole = upto == t
            drop_k = (dk >= lk["cap"]).sum(0)[whole]
            drop_p = (dp >= lp["cap"]).sum(0)[whole]
            if not np.array_equal(drop_k, drop_p):
                bad.append(f"call {c} layer {layer}: dropped counts differ "
                           f"in experts whose tokens agree")
            counts["experts_dropped"] += int(whole.sum())
            w = model.net.layers[layer].moe.router.w.detach().double()
            for j in np.flatnonzero(~out & ~same):
                xk, xp = lk["x"][j], lp["x"][j]
                x_rel = float((xk - xp).abs().max() / xk.abs().max())
                p64 = torch.softmax(xk.double() @ w, -1).cpu()
                gone = sorted(set(ik[j].tolist()) - set(ip[j].tolist()))
                came = sorted(set(ip[j].tolist()) - set(ik[j].tolist()))
                gap, top = max((abs(float(p64[a] - p64[n])),
                                max(float(p64[a]), float(p64[n])))
                               for a in gone for n in came)
                split = {"call": c, "layer": layer, "row": int(rows[j]),
                         "position": int(where[j]), "kernel_only": gone,
                         "plain_only": came, "input_rel_diff": x_rel,
                         "float64_gap": gap, "probability": top,
                         "f32_spacing": _f32_ulp(top),
                         "kernel_margin": _kth_margin(lk["probs"][j], k),
                         "plain_margin": _kth_margin(lp["probs"][j], k)}
                print(f"routing split: {split}")
                splits.append(split)
                if not (x_rel <= LOGITS_RTOL and gap < LOGITS_RTOL * top):
                    bad.append(f"a split that is no tie at LOGITS_RTOL: "
                               f"{split}")
            for sp in splits:
                if sp["call"] == c and sp["layer"] == layer:
                    first[sp["row"]] = min(first[sp["row"]], sp["position"])
    return first, splits, bad, counts


def _stage_ms(fn) -> float:
    return _time_ms(fn, iters=5, warmup=2)


def moe_prefill_stages(model, rec: list, prefill_s: float) -> dict:
    """ms of each stage of the kernel route's prefill, summed over the
    layers, by CUDA events on each layer's own recorded MoE input: the
    routing and dispatch (``moe.route``, ``dispatch``, ``scatter`` into
    the (E, C, D) buffer), the expert products, the combine, the
    attention block (projections, qk-norm, RoPE, K3) and K3 alone, and the
    head."""
    cfg = model.cfg
    e = cfg.num_experts
    gen = torch.Generator(device=DEV).manual_seed(17)
    stages = {"routing and dispatch": 0.0, "expert products": 0.0,
              "combine": 0.0, "attention block (K3 inside)": 0.0,
              "K3 alone": 0.0}
    h = _randn((MOE_B, MOE_S, cfg.d_model), gen)
    positions = torch.arange(MOE_S, device=DEV)[None].expand(MOE_B, MOE_S)
    with torch.inference_mode():
        for lp, lrec in zip(model.net.layers, rec):
            xt, cap = lrec["x"], lrec["cap"]

            def dispatch(xt=xt, lp=lp, cap=cap):
                top_p, top_i, _, _ = moe_mod.route(cfg, lp.moe.router.w, xt)
                row, kept = moe_mod.dispatch(cfg, top_i, cap)
                return top_p, row, kept, moe_mod.scatter(xt, row, e, cap)

            top_p, row, kept, buf = dispatch()
            y = moe_mod.experts(lp.moe, buf)
            stages["routing and dispatch"] += _stage_ms(dispatch)
            stages["expert products"] += _stage_ms(
                lambda lp=lp, buf=buf: moe_mod.experts(lp.moe, buf))
            stages["combine"] += _stage_ms(
                lambda: moe_mod.combine(y, row, kept, top_p))
            stages["attention block (K3 inside)"] += _stage_ms(
                lambda lp=lp: attn_mod.self_attention(
                    cfg, lp.attn, h, positions=positions, kernels="cuda"))
            del y, buf, row, kept, top_p
        q = _randn((MOE_B, MOE_S, cfg.num_heads, cfg.head_dim), gen)
        kv = _randn((MOE_B, MOE_S, cfg.num_kv_heads, cfg.head_dim), gen)
        stages["K3 alone"] = MOE_LAYERS * _stage_ms(
            lambda: flash_attention(q, kv, kv, causal=True))
        stages["head"] = _stage_ms(lambda: model.net.tok.logits(h))
    whole = prefill_s * 1e3
    print(f"prefill stages, ms summed over {MOE_LAYERS} layers (CUDA "
          f"events, each stage alone, warm), against the warm prefill's "
          f"{whole:.1f} ms:")
    for name, ms in stages.items():
        print(f"  {ms:10.3f} ms  {ms / whole:6.3f}  {name}")
    rest = whole - sum(v for n, v in stages.items() if n != "K3 alone")
    print(f"  {rest:10.3f} ms  {rest / whole:6.3f}  the rest: the warm "
          f"prefill less the stages but K3 alone (embedding, norms, "
          f"residual adds, the host between them)")
    return stages


def _k3_times(gen, b, s, t, h, kh, d, causal) -> tuple:
    """K3 at (b, s against t, h over kh, d), float32, in turns with its
    plain version and SDPA: (ms per call, plain ms, library ms, bound ms,
    bound_by, kernel ms, shape). The bound is that of 3xTF32 on the tensor
    cores, as in phase 8."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    q = _randn((b, s, h, d), gen)
    k, v = (_randn((b, t, kh, d), gen) for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    call = lambda: flash_attention(q, k, v, causal=causal)
    ms = _time_turns({
        "kernel": call,
        "plain": lambda: ref.mha_reference(q, k, v, causal=causal),
        "library": lambda: sdpa(qt, kt, vt, is_causal=causal,
                                enable_gqa=h != kh)}, iters=20, warmup=3)
    dev_ms = _device_ms(call, ("flash_fwd",), iters=10)
    nbytes = (2 * b * s * h * d + 2 * b * t * kh * d) * 4
    flops = (2 * b * h * d * s * (s + 1) if causal
             else 4 * b * h * d * s * t)
    return (ms["kernel"], ms["plain"], ms["library"],
            *_bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S), dev_ms,
            (b, s, t, h, kh, d) if s != t else (b, s, h, kh, d))


def _k4_times(gen, b, t, h, kh, d) -> tuple:
    """K4 at a full cache of t slots (b, h over kh, d), float32, in turns
    with its plain version and SDPA (the tag mask); its plan printed; the
    tuple of :func:`_k3_times`, bound by one read of the valid slots."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    q = _randn((b, 1, h, d), gen)
    kc, vc = (_randn((b, t, kh, d), gen) for _ in range(2))
    tags, idx = _tags(b, t, t - 1)
    mask = ((tags >= 0) & (tags <= idx[:, None]))[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
    call = lambda: decode_attention(q, kc, vc, tags, idx)
    ms = _time_turns({
        "kernel": call,
        "plain": lambda: ref.mha_reference(q, kc, vc, causal=True,
                                           q_offset=idx[:, None],
                                           kv_positions=tags),
        "library": lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                enable_gqa=h != kh)}, iters=20, warmup=3)
    dev_ms, *_ = _k4_device_ms(call, _k4_plan(q, kc))
    seen = int(mask.sum()) // b
    k4_layout(q, kc, seen)
    return (ms["kernel"], ms["plain"], ms["library"], *_bound_ms(
        2 * b * seen * kh * d * 4 + (2 * b * h * d + b * t + b) * 4,
        4 * b * h * seen * d), dev_ms, (b, t, h, kh, d))


def _print_lm_times(times: dict) -> None:
    for label, (ms, plain_ms, lib_ms, bound, by, dev, shape) in \
            times.items():
        print(f"{label} {shape}: {ms:.5f} ms per call (kernel alone "
              f"{dev:.5f} ms), plain {plain_ms:.5f} ms, library "
              f"{lib_ms:.5f} ms (in turns), bound {bound:.5f} ms ({by})")


def time_moe_kernels() -> dict:
    """K3 and K4 at qwen3-moe-235b-a22b's serve shapes, float32, in turns
    with their plain versions and SDPA (``enable_gqa``): name -> (ms per
    call, plain ms, library ms, bound ms, bound_by, kernel ms, shape)."""
    cfg = _moe_config()
    gen = torch.Generator(device=DEV).manual_seed(9)
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {"flash_attention": _k3_times(gen, MOE_B, MOE_S, MOE_S, h, kh, d,
                                        True),
           "decode_attention": _k4_times(gen, MOE_B, MOE_S + MOE_GEN, h, kh,
                                         d)}
    _print_lm_times(out)
    return out


def moe_serve_path() -> dict:
    """Phase 17: qwen3-moe-235b-a22b at its published widths, MOE_LAYERS
    layers, through the port's entry points on the kernel route, then
    replayed on the plain route on the same weights."""
    cfg = _moe_config()
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    print(f"device memory allocated before the phase: {_gib(before)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEV, kernels="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = model.num_params()
    print(f"{cfg.name} at {cfg.num_layers} of 94 layers: {n_params} params "
          f"({_gib(n_params * 4)} float32), random init on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    if n_params != MOE_PARAMS:
        raise AssertionError(f"{n_params} params, expected {MOE_PARAMS}")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_B, MOE_S)), device=DEV)
    cache_len = MOE_S + MOE_GEN

    recorder = RoutingRecorder(model)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_logits, cache = model.prefill({"tokens": prompts},
                                          cache_len=cache_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = prefill_logits[:, -1:].argmax(-1)
    tokens, step_logits = [tok], []
    for _ in range(MOE_GEN - 1):
        logits, cache = model.decode_step(cache, tok)
        tok = logits[:, -1:].argmax(-1)
        step_logits.append(logits)
        tokens.append(tok)
    torch.cuda.synchronize()
    launches = _read_counts()
    expect = {name: 0 for name in WRAPPERS}
    expect["flash_attention"] = MOE_LAYERS
    expect["decode_attention"] = MOE_LAYERS * (MOE_GEN - 1)
    print(f"launches in one request batch: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"moe serve launches {launches} != {expect}")
    gen_tokens = torch.cat(tokens, dim=1)
    if prefill_logits.shape != (MOE_B, MOE_S, cfg.padded_vocab) or \
            gen_tokens.shape != (MOE_B, MOE_GEN):
        raise AssertionError("moe serve output shapes are wrong")
    if not (bool(torch.isfinite(prefill_logits).all()) and all(
            bool(torch.isfinite(x).all()) for x in step_logits)):
        raise AssertionError("non-finite moe serve logits")
    rec_k = recorder.host()
    drops = [sum(int((r["pos"] >= r["cap"]).sum()) for r in call)
             for call in rec_k]
    print(f"prefill {MOE_B}x{MOE_S} (first call, routing hooks on): "
          f"{prefill_s:.4f} s; capacity {rec_k[0][0]['cap']} a prefill "
          f"expert ({rec_k[1][0]['cap']} a decode step); assignments "
          f"dropped: {drops[0]} of {MOE_LAYERS * MOE_B * MOE_S * 8} in the "
          f"prefill, {sum(drops[1:])} in the decode steps")
    print(f"  seq0: {gen_tokens[0].tolist()}")

    # the plain route on the same module, teacher-forced
    recorder = RoutingRecorder(model)
    model.net.kernels = "torch"
    try:
        lg, pcache = model.prefill({"tokens": prompts}, cache_len=cache_len)
        plain_logits = [lg]
        for i in range(MOE_GEN - 1):
            lg, pcache = model.decode_step(pcache, tokens[i])
            plain_logits.append(lg)
    finally:
        model.net.kernels = "cuda"
    rec_p = recorder.host()
    first, splits, bad, counts = routing_splits(model, rec_k, rec_p, MOE_B,
                                                MOE_S)
    print(f"routing integers compared over {counts['pairs']} (call, "
          f"layer) pairs: top-k sets of {counts['tokens']} tokens, "
          f"positions in expert of {counts['assignments']} assignments, "
          f"dropped counts of {counts['experts_dropped']} experts; "
          f"{len(splits)} splits; {counts['order']} tokens with the same "
          f"set in another order (information)")
    # max |logit| over the real vocabulary: the padded slots hold -1e9
    v = cfg.vocab_size
    pos = torch.arange(MOE_S, device=DEV)
    keep = pos[None, :] < torch.as_tensor(first, device=DEV)[:, None]
    diff = (plain_logits[0] - prefill_logits)[..., :v].abs().amax(-1)
    scale = float(prefill_logits[..., :v].abs().max())
    rel = [float((diff * keep).max()) / scale]
    below = float((diff * ~keep).max()) / scale
    for i in range(MOE_GEN - 1):
        rows = torch.as_tensor(MOE_S + i < first, device=DEV)
        d = (plain_logits[i + 1] - step_logits[i])[..., :v].abs().amax(
            (1, 2))
        scale = float(step_logits[i][..., :v].abs().max())
        rel.append(float((d * rows).max()) / scale)
        below = max(below, float((d * ~rows).max()) / scale)
    left_out = int((~keep).sum())
    print(f"kernel route vs plain route (teacher-forced): max |diff| / max "
          f"|logit| = {rel[0]:.3e} on the prefill, {max(rel[1:]):.3e} over "
          f"the decode steps (tolerance {LOGITS_RTOL}); left out downstream "
          f"of a split: {left_out} of {MOE_B * MOE_S} prefill positions and "
          f"{int((MOE_S + MOE_GEN - 2 >= first).sum())} of {MOE_B} rows "
          f"from the last decode step, where the two routes part by "
          f"{below:.3e} (information)")
    del plain_logits, pcache, lg
    if bad:
        raise AssertionError("routing parts between the routes: " +
                             "; ".join(bad))
    if not max(rel) <= LOGITS_RTOL:
        raise AssertionError(f"kernel and plain route logits differ: "
                             f"{max(rel)} > {LOGITS_RTOL}")

    # warm timings on the kernel route, no hooks
    del step_logits, cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = model.prefill({"tokens": prompts}, cache_len=cache_len)
    torch.cuda.synchronize()
    warm_prefill_s = time.perf_counter() - t0
    if not torch.equal(lg, prefill_logits):
        raise AssertionError("a second prefill gives other bits")
    del lg
    step_ms = []
    for i in range(MOE_GEN - 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, tokens[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"prefill {MOE_B}x{MOE_S} (warm): {warm_prefill_s:.4f} s; decode "
          f"median {statistics.median(step_ms):.3f} ms/step over "
          f"{MOE_GEN - 1} steps (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f})")
    prof_prefill = _profiled(
        lambda: model.prefill({"tokens": prompts}, cache_len=cache_len))
    _print_profile("prefill", *prof_prefill, top=12)
    prof_step = _profiled(lambda: model.decode_step(cache, tokens[-1]))
    _print_profile("decode step", *prof_step)
    del cache, logits, prefill_logits
    stages = moe_prefill_stages(model, rec_k[0], warm_prefill_s)
    del rec_k, rec_p
    peak = torch.cuda.max_memory_allocated()
    print(f"device memory: {_gib(before)} before the phase, peak "
          f"{_gib(peak)} ({_gib(peak - before)} above it)")
    del model
    gc_collect()
    return {"launches": launches, "prefill_s": prefill_s,
            "warm_prefill_s": warm_prefill_s,
            "decode_ms": statistics.median(step_ms), "rel": max(rel),
            "splits": len(splits), "stages": stages, "peak_bytes": peak}


# ------------------------- 18. whisper-large-v3 and internvl2-1b serve

def _family_config(arch: str):
    return ARCHS[arch].replace(remat="none", param_dtype="float32",
                               dtype="float32")


def _family_batch(cfg) -> tuple[dict, int]:
    """Phase 18's and 20's requests, drawn by ``launch.serve`` from seed 0
    (the prompts, then the frames or patches), and the cache length."""
    if cfg.family == "encdec":
        return (serve.request_batch(cfg, FAM_B, WHISPER_S, 0, DEV),
                WHISPER_S + FAM_GEN)
    if cfg.family == "dense":
        return (serve.request_batch(cfg, MOE_B, MOE_S, 0, DEV),
                MOE_S + MOE_GEN)
    return (serve.request_batch(cfg, FAM_B, VLM_S, 0, DEV),
            cfg.num_patches + VLM_S + FAM_GEN)


def _family_launches(cfg) -> dict:
    """The launches of one request batch: K3 in every encoder layer and,
    in every decoder layer, the self prefill, the cross prefill and the
    cross attention of each decode step (encdec), or once a layer (vlm,
    dense); K4 once a decoder layer a decode step; nothing else."""
    layers, steps = cfg.num_layers, FAM_GEN - 1
    k3 = (cfg.num_encoder_layers + layers * (2 + steps)
          if cfg.family == "encdec" else layers)
    return {**{name: 0 for name in WRAPPERS}, "flash_attention": k3,
            "decode_attention": layers * steps}


def dry_prefill(cfg, batch: dict, cache_len: int) -> tuple[dict, float]:
    """The dry-run's reckoning of the plain-route prefill of ``batch``:
    ``launch.dryrun``'s counter over the meta build of ``cfg``, the batch
    as meta tensors of its shapes and dtypes. (memory_analysis, s)."""
    model = build_model(cfg, device="meta", kernels="torch")
    if model.num_params() != PARAM_COUNTS[cfg.name]:
        raise AssertionError(f"the meta build of {cfg.name} has "
                             f"{model.num_params()} params")
    specs = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
    args = (model.params(), specs)
    counter, out, secs = count_call(
        lambda: model.prefill(specs, cache_len=cache_len), args)
    return counter.memory_analysis(out, args), secs


def family_serve_path(arch: str) -> dict:
    """Phase 18 and 20, for one model: ``arch`` at its published widths
    and full depth through the port's entry points on the kernel route,
    then replayed on the plain route on the same module, teacher-forced;
    for a dense model, the plain-route prefill's peak held against the
    dry-run's reckoning (:func:`dry_prefill`)."""
    cfg = _family_config(arch)
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    print(f"-- {arch}: device memory allocated before it: {_gib(before)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEV, kernels="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = model.num_params()
    print(f"{cfg.name}: {n_params} params ({_gib(n_params * 4)} float32), "
          f"random init on the card in {time.perf_counter() - t0:.2f} s")
    if n_params != PARAM_COUNTS[arch]:
        raise AssertionError(f"{n_params} params, expected "
                             f"{PARAM_COUNTS[arch]}")
    batch, cache_len = _family_batch(cfg)
    b, s = batch["tokens"].shape

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_logits, cache = model.prefill(batch, cache_len=cache_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = prefill_logits[:, -1:].argmax(-1)
    tokens, step_logits = [tok], []
    for _ in range(FAM_GEN - 1):
        logits, cache = model.decode_step(cache, tok)
        tok = logits[:, -1:].argmax(-1)
        step_logits.append(logits)
        tokens.append(tok)
    torch.cuda.synchronize()
    launches = _read_counts()
    expect = _family_launches(cfg)
    print(f"launches in one request batch: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"{arch} serve launches {launches} != "
                             f"{expect}")
    gen_tokens = torch.cat(tokens, dim=1)
    if prefill_logits.shape != (b, s, cfg.padded_vocab) or \
            gen_tokens.shape != (b, FAM_GEN) or \
            cache["index"] != cache_len - 1:
        raise AssertionError(f"{arch} serve output shapes are wrong")
    if not (bool(torch.isfinite(prefill_logits).all()) and all(
            bool(torch.isfinite(x).all()) for x in step_logits)):
        raise AssertionError(f"non-finite {arch} serve logits")
    print(f"prefill {b}x{s} (first call): {prefill_s:.4f} s; cache of "
          f"{cache_len} slots at index {cache['index']}")
    print(f"  seq0: {gen_tokens[0].tolist()}")

    # the plain route on the same module, teacher-forced; max |logit|
    # over the real vocabulary (the padded slots hold -1e9)
    v = cfg.vocab_size
    model.net.kernels = "torch"
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    try:
        lg, pcache = model.prefill(batch, cache_len=cache_len)
        torch.cuda.synchronize()
        plain_above = torch.cuda.max_memory_allocated() - start
        rel = [float((lg - prefill_logits)[..., :v].abs().max()) /
               float(prefill_logits[..., :v].abs().max())]
        agree = int((lg[:, -1:].argmax(-1) == tokens[0]).sum())
        for i in range(FAM_GEN - 1):
            lg, pcache = model.decode_step(pcache, tokens[i])
            rel.append(float((lg - step_logits[i])[..., :v].abs().max()) /
                       float(step_logits[i][..., :v].abs().max()))
            agree += int((lg[:, -1:].argmax(-1) == tokens[i + 1]).sum())
    finally:
        model.net.kernels = "cuda"
    del pcache, lg
    print(f"kernel route vs plain route (teacher-forced): max |diff| / max "
          f"|logit| = {rel[0]:.3e} on the prefill, {max(rel[1:]):.3e} over "
          f"the decode steps (tolerance {LOGITS_RTOL}); greedy tokens equal "
          f"in {agree} of {b * FAM_GEN} (information)")
    if not max(rel) <= LOGITS_RTOL:
        raise AssertionError(f"{arch}: kernel and plain route logits "
                             f"differ: {max(rel)} > {LOGITS_RTOL}")
    dry = None
    if cfg.family == "dense":
        dry, dry_s = dry_prefill(cfg, batch, cache_len)
        args = n_params * 4 + sum(t.numel() * t.element_size()
                                  for t in batch.values())
        gap = dry["temp_size_in_bytes"] / plain_above - 1
        print(f"dry-run of the plain-route prefill ({dry_s:.2f} s on the "
              f"meta device): arguments {dry['argument_size_in_bytes']} "
              f"bytes (weights and batch on the card {args}), peak "
              f"{_gib(dry['temp_size_in_bytes'])} above them, output "
              f"{_gib(dry['output_size_in_bytes'])}; measured "
              f"max_memory_allocated() {_gib(plain_above)} above the "
              f"{_gib(start)} before the plain prefill: {gap:+.4%} "
              f"(bound {DRY_RTOL:.0%}); {dry['temp_size_in_bytes']} "
              f"against {plain_above} bytes")
        if dry["argument_size_in_bytes"] != args:
            raise AssertionError(f"{arch}: the dry-run's arguments "
                                 f"{dry['argument_size_in_bytes']} != {args}")
        if not abs(gap) <= DRY_RTOL:
            raise AssertionError(f"{arch}: the dry-run's peak is {gap:+.2%} "
                                 f"off the card's")

    # warm timings on the kernel route
    del step_logits, cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = model.prefill(batch, cache_len=cache_len)
    torch.cuda.synchronize()
    warm_prefill_s = time.perf_counter() - t0
    if not torch.equal(lg, prefill_logits):
        raise AssertionError(f"{arch}: a second prefill gives other bits")
    del lg, prefill_logits
    step_ms = []
    for i in range(FAM_GEN - 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, tokens[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"prefill {b}x{s} (warm): {warm_prefill_s:.4f} s; decode median "
          f"{statistics.median(step_ms):.3f} ms/step over {FAM_GEN - 1} "
          f"steps (min {min(step_ms):.3f}, max {max(step_ms):.3f})")
    _print_profile("prefill", *_profiled(
        lambda: model.prefill(batch, cache_len=cache_len)), top=10)
    _print_profile("decode step", *_profiled(
        lambda: model.decode_step(cache, tokens[-1])))
    del cache, logits
    peak = max(peak, torch.cuda.max_memory_allocated())
    print(f"device memory: {_gib(before)} before {arch}, peak {_gib(peak)} "
          f"({_gib(peak - before)} above it)")
    del model, batch
    gc_collect()
    return {"launches": launches, "prefill_s": prefill_s,
            "warm_prefill_s": warm_prefill_s,
            "decode_ms": statistics.median(step_ms), "rel": max(rel),
            "peak_bytes": peak, "plain_prefill_bytes": plain_above,
            "dry": dry}


def time_family_kernels() -> dict:
    """K3 and K4 at phase 18's shapes (:func:`_k3_times`,
    :func:`_k4_times`): (kernel name, label) -> their tuple."""
    gen = torch.Generator(device=DEV).manual_seed(18)
    out = {("flash_attention", label): _k3_times(gen, FAM_B, s, t, h, kh,
                                                 64, causal)
           for label, (s, t, h, kh, causal) in {
               "whisper encoder": (WHISPER_T, WHISPER_T, 20, 20, False),
               "whisper self prefill": (WHISPER_S, WHISPER_S, 20, 20, True),
               "whisper cross prefill": (WHISPER_S, WHISPER_T, 20, 20,
                                         False),
               "whisper cross decode": (1, WHISPER_T, 20, 20, False),
               "internvl2 prefill": (VLM_P + VLM_S, VLM_P + VLM_S, 14, 2,
                                     True)}.items()}
    out[("decode_attention", "whisper decode")] = _k4_times(
        gen, FAM_B, WHISPER_S + FAM_GEN, 20, 20, 64)
    out[("decode_attention", "internvl2 decode")] = _k4_times(
        gen, FAM_B, VLM_T, 14, 2, 64)
    _print_lm_times({" ".join(key): t for key, t in out.items()})
    return out


def time_dense_kernels() -> dict:
    """K3 and K4 at phase 20's shapes, as :func:`time_family_kernels`:
    each model's causal prefill of MOE_S tokens and its decode over a
    cache of MOE_S + MOE_GEN slots."""
    gen = torch.Generator(device=DEV).manual_seed(20)
    out = {}
    for arch in DENSE_ARCHS:
        cfg = ARCHS[arch]
        h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        name = arch.split("-")[0]
        out[("flash_attention", f"{name} prefill")] = _k3_times(
            gen, MOE_B, MOE_S, MOE_S, h, kh, d, True)
        out[("decode_attention", f"{name} decode")] = _k4_times(
            gen, MOE_B, MOE_S + MOE_GEN, h, kh, d)
    _print_lm_times({" ".join(key): t for key, t in out.items()})
    return out


# ------------------------------------- 19. moe, vlm and encdec training

# train.main's argv of phase 19: the mesh step, 8 clients, 3 steps, K1's
# loop judging each step's soft labels; the models at their published
# widths, whisper and internvl2 at full depth, qwen3-moe at 1 of 94
# layers; the parameter counts are jax.eval_shape's of the reference's
# init at those depths
FAM_STEP_ARGV = ["--steps", "3", "--clients", "8", "--judge-backend",
                 "cuda"]
FAM_TRAIN = {
    # 8 clients x 1 utterance of 1,500 zero frames and 129 tokens
    "whisper": (["--arch", "whisper-large-v3", "--per-client-batch", "1",
                 "--attn", "blockwise", "--remat", "full"], 1_535_636_480),
    # 8 clients x 2 windows of 129 tokens after 256 patches, one random
    # draw (zero patches overflow the gradient at 24 layers: ROADMAP
    # queue 3)
    "internvl2": (["--arch", "internvl2-1b", "--remat", "full",
                   "--extras", "random"], 494_720_896),
    # 8 clients x 2 windows of 129 tokens, one layer of 128 experts
    "qwen3-moe": (["--arch", MOE_ARCH, "--layers", "1", "--remat", "full"],
                  3_733_467_392),
}
FAM_CUT = 4             # the cut-depth comparisons: 4 (+ 4) layers
FAM_LMSTEP_WINDOWS = 8  # internvl2's lmstep: windows a client
FAM_REMAT_WINDOWS = 4   # internvl2's lmstep under "none" against "full"
WHISPER_LMSTEP_WINDOWS = 4
LMSTEP_FIT_GIB = 70     # a reckoned lmstep runs on the card below this
FAM_CUT_PARAMS = {"whisper": 250_163_200, "internvl2": 196_473_216}


def _dev_argv() -> list:
    return [] if DEV == "cuda" else ["--device", DEV]


class _Captured:
    """While open, ``train.build_model`` hands each model it builds to
    ``on_build`` and keeps it, and ``kernels.ops.entropy_judge_loop``
    records the shape of each batch of soft labels it sends to K1's loop
    (whose wrapper counts as before)."""

    def __init__(self, on_build=None):
        self.on_build, self.models, self.shapes = on_build, [], []

    def __enter__(self):
        self._build, self._loop = train.build_model, \
            kernel_ops.entropy_judge_loop

        def build(*args, **kw):
            model = self._build(*args, **kw)
            self.models.append(model)
            if self.on_build is not None:
                self.on_build(model)
            return model

        def loop(soft, *args, **kw):
            if kw.get("backend") == "cuda":
                self.shapes.append(tuple(soft.shape))
            return self._loop(soft, *args, **kw)

        train.build_model, kernel_ops.entropy_judge_loop = build, loop
        return self

    def __exit__(self, *exc):
        train.build_model = self._build
        kernel_ops.entropy_judge_loop = self._loop


class DroppedCounter:
    """Forward pre-hooks on every layer's MoE block of the model
    ``train.main`` builds: each call's dropped assignments (positions in
    expert at or past the capacity, ``moe.route`` and ``moe.positions``
    on the block's own input), kept on the card. Under ``remat="full"``
    a step calls each block twice, the forward and its recomputation in
    the backward, which must route alike."""

    def __init__(self):
        self.calls, self.handles = [], []

    def attach(self, model):
        @torch.no_grad()
        def hook(block, args):
            xt = args[0].reshape(-1, args[0].shape[-1])
            _, top_i, _, _ = moe_mod.route(block.cfg, block.router.w, xt)
            cap = moe_mod.capacity(block.cfg, xt.shape[0])
            self.calls.append((moe_mod.positions(top_i) >= cap).sum())
        self.handles = [lp.moe.register_forward_pre_hook(hook)
                        for lp in model.net.layers]

    def per_step(self, steps: int, layers: int) -> list:
        """Removes the hooks; each step's dropped assignments over its
        layers, after checking each recomputation's against its
        forward's."""
        for h in self.handles:
            h.remove()
        counts = [int(c) for c in self.calls]
        if len(counts) != 2 * steps * layers:
            raise AssertionError(f"{len(counts)} MoE calls in {steps} "
                                 f"steps of {layers} layers")
        out = []
        for i in range(steps):
            step = counts[2 * i * layers:2 * (i + 1) * layers]
            fwd, rec = step[:layers], step[layers:][::-1]
            if fwd != rec:
                raise AssertionError(f"step {i}: the recomputation drops "
                                     f"{rec}, the forward {fwd}")
            out.append(sum(fwd))
        return out


def family_training(name: str, on_build=None) -> dict:
    """``train.main`` of FAM_TRAIN[name], counted: K1's loop 3 launches
    on (8, padded vocabulary) soft labels and nothing else, the
    parameter count the reference's, finite steps. Prints each step and
    the peak device memory above the phase's start; returns the records,
    launches, peak and the model (its weights the trained params: the
    step donates them)."""
    argv, n_params = FAM_TRAIN[name]
    gc_collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _Captured(on_build) as cap:
        _reset_counts()
        recs = train.main(argv + FAM_STEP_ARGV + _dev_argv())
        torch.cuda.synchronize()
        launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    (model,) = cap.models
    cfg = model.cfg
    want = dict.fromkeys(WRAPPERS, 0)
    want["entropy_judge_loop"] = TRAIN_STEPS
    shapes = [(8, cfg.padded_vocab)] * TRAIN_STEPS
    if launches != want or cap.shapes != shapes:
        raise AssertionError(f"{name} mesh step: launches {launches} on "
                             f"{cap.shapes}; expected {want} on {shapes}")
    if model.num_params() != n_params:
        raise AssertionError(f"{name}: {model.num_params()} params, "
                             f"expected {n_params}")
    for r in recs:
        if not all(math.isfinite(r[k]) for k in ("loss", "grad_norm",
                                                 "entropy", "aux_loss")):
            raise AssertionError(f"{name}: non-finite step {r}")
        print(f"{name} step {r['step']}: loss {r['loss']:.6f} aux "
              f"{r['aux_loss']:.6f} grad norm {r['grad_norm']:.4f} mask "
              f"{r['mask']} entropy {r['entropy']:.6f} {r['seconds']:.4f} s")
    print(f"{name} mesh step (train.main, {cfg.num_layers} layers, remat "
          f"{cfg.remat!r}, route {model.kernels!r}, {n_params:,} params): "
          f"launches {launches} on {cap.shapes[0]}; step s "
          f"{[round(r['seconds'], 4) for r in recs]}; peak device memory "
          f"{_gib(peak)}, {_gib(peak - base)} above the {_gib(base)} held "
          "before")
    return {"records": recs, "launches": launches, "peak": peak - base,
            "model": model, "argv": argv}


def profiled_step(model, argv: list, name: str) -> dict:
    """Two more donated steps of ``model`` (its weights the trained
    params, a fresh momentum) on ``argv``'s first batch, the second under
    torch.profiler: (wall s, busy s, idle share), with the top kernels."""
    args = train.parser().parse_args(argv + FAM_STEP_ARGV + _dev_argv())
    cfg = model.cfg
    corpus, idx = train.build_fl_corpus(cfg, args.logical_clients,
                                        args.case, args.seq_len, args.seed)
    rows = np.concatenate([corpus[idx[c][:args.per_client_batch]]
                           for c in range(args.clients)])
    tokens = torch.from_numpy(rows).to(DEV)
    batch = {"tokens": tokens, **train.batch_extras(
        cfg, tokens.shape[0], DEV,
        train.stub_frontend(cfg, args.extras, args.seed, DEV))}
    opt = sgd(lr=args.lr, momentum=0.5)
    step = make_train_step(model, opt, FedSpec(num_clients=args.clients),
                           judge_fn=fl.MaxEntropyJudge("cuda").traced(),
                           donate=True)
    params = {k: v.detach() for k, v in model.params().items()}
    state = opt.init(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _busy_s(prof)
    print(f"{name}: a step unprofiled {warm:.4f} s; profiled: wall "
          f"{wall:.4f} s, device busy (union of kernel intervals) "
          f"{busy:.4f} s, idle share {1 - busy / wall:.3f} (profiler on)")
    for kname, us in sorted(_kernel_us(prof).items(),
                            key=lambda kv: -kv[1])[:6]:
        print(f"  {us / 1e3:9.3f} ms  {kname[:100]}")
    del params, state, step
    return {"step_s": warm, "profiled_s": wall, "busy_s": busy}


class StepLeader:
    """The K1 judge of a mesh run, keeping each step's inputs and
    verdict for :class:`StepFollower`."""

    def __init__(self):
        self.verdicts = []

    def __call__(self, soft, sizes):
        self.verdicts.append(judge(soft, sizes, backend="cuda"))
        return self.verdicts[-1]


class StepFollower:
    """The K1 judge of a second mesh run of the same steps on another
    route or remat: equal removal orders pass; where they part, the two
    choices must differ in float64 on this run's labels by less than
    float32's spacing at the entropy (ROADMAP F5), printed, and this run
    follows the leader's verdict, so the steps after it stay
    comparable."""

    def __init__(self, leader: StepLeader, what: str):
        self.leader, self.what, self.calls, self.ties = leader, what, 0, 0

    def __call__(self, soft, sizes):
        lead = self.leader.verdicts[self.calls]
        self.calls += 1
        own = judge(soft, sizes, backend="cuda")
        o_l = lead.removal_order[:int(lead.num_removed)].tolist()
        o_o = own.removal_order[:int(own.num_removed)].tolist()
        if o_l == o_o:
            return own
        step, gap = _split_margin((soft, sizes, None, None, None), o_l, o_o)
        ulp = _f32_ulp(float(own.entropy))
        if not gap < ulp:
            raise AssertionError(f"{self.what}: removal orders {o_l} vs "
                                 f"{o_o} part at step {step} by {gap} in "
                                 f"float64, not below {ulp:.3e}")
        print(f"{self.what}: float32 tie at step {step} ({gap:.3e} apart "
              f"in float64, spacing {ulp:.3e}): follows the leader's "
              f"verdict {o_l} over its own {o_o}")
        self.ties += 1
        return lead


def _cut_argv(name: str, *extra) -> list:
    return (FAM_TRAIN[name][0] + FAM_STEP_ARGV + _dev_argv()
            + ["--layers", str(FAM_CUT), *extra])


def cut_comparison(name: str) -> dict:
    """``name``'s mesh step at its widths cut to FAM_CUT (+ FAM_CUT)
    layers, the same 3 steps from the same params three times: on the
    torch route with ``remat="none"`` (the leader), on the blockwise
    route with ``"full"`` and on the torch route with ``"full"``, each
    held to the leader: masks equal (a split only at a float32 tie,
    followed), loss and gradient norm within TRAIN_RTOL relative,
    entropies within K1_ATOL; whether remat's run equals the leader's
    bits is printed. Returns each run's peak above its start."""
    leader, runs, peaks = StepLeader(), {}, {}
    for label, attn, remat in (("torch none", "torch", "none"),
                               ("blockwise full", "blockwise", "full"),
                               ("torch full", "torch", "full")):
        args = train.parser().parse_args(_cut_argv(name, "--attn", attn,
                                                   "--remat", remat))
        cfg = train.train_config(args)
        gc_collect()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device=DEV, kernels=args.attn,
                            seed=args.seed)
        if model.num_params() != FAM_CUT_PARAMS[name]:
            raise AssertionError(f"{name} at {FAM_CUT} layers: "
                                 f"{model.num_params()} params")
        corpus, idx = train.build_fl_corpus(
            cfg, args.logical_clients, args.case, args.seq_len, args.seed)
        runs[label] = train.run_mesh_engine(
            args, cfg, model, corpus, idx, judge_fn=leader if not runs
            else StepFollower(leader, f"{name} cut, {label}"))
        peaks[label] = torch.cuda.max_memory_allocated() - base
        print(f"{name} cut to {FAM_CUT} layers, {label}: peak "
              f"{_gib(peaks[label])} above the start; step s "
              f"{[round(r['seconds'], 4) for r in runs[label]]}")
        del model
    worst = _held_steps(runs["torch none"], runs["blockwise full"],
                        f"{name} cut: blockwise full vs torch none")
    worst_r = _held_steps(runs["torch none"], runs["torch full"],
                          f"{name} cut: torch full vs torch none")
    bits = all(a[k] == b[k] for a, b in zip(runs["torch none"],
                                            runs["torch full"])
               for k in ("loss", "grad_norm", "entropy", "aux_loss"))
    print(f"{name} cut to {FAM_CUT} layers: blockwise + remat 'full' "
          f"within {worst:.3e} of torch + 'none' (limit {TRAIN_RTOL:.0e}); "
          f"remat 'full' vs 'none' on the torch route within {worst_r:.3e}"
          f", the same bits (loss, grad norm, entropy, aux): {bits}")
    return {"peaks": peaks, "rel": worst, "remat_rel": worst_r,
            "remat_bits": bits}


def whisper_lmstep_round() -> dict:
    """One lmstep round of whisper at its widths cut to FAM_CUT + FAM_CUT
    layers, WHISPER_LMSTEP_WINDOWS windows a client, on the sequential server
    (K2 once, the client program one CUDA graph). Returns its
    launches."""
    args = train.parser().parse_args(_cut_argv("whisper"))
    cfg = train.train_config(args)
    model = build_model(cfg, device=DEV, kernels="torch", seed=0)
    if model.num_params() != FAM_CUT_PARAMS["whisper"]:
        raise AssertionError(f"whisper lmstep: {model.num_params()} params")
    torch.cuda.reset_peak_memory_stats()
    seq = build_lmstep(model, cfg, _lm_data(cfg, LMSTEP_SEQ,
                                            WHISPER_LMSTEP_WINDOWS),
                       judge=fl.MaxEntropyJudge())
    counts, walls = _counted_rounds(seq, "whisper lmstep sequential", 1)
    want = {**dict.fromkeys(WRAPPERS, 0), "masked_weighted_sum": 1}
    rec = seq.history[0]
    if counts != want or seq.graphs_captured != 1 or \
            not math.isfinite(rec["entropy"]):
        raise AssertionError(f"whisper lmstep: launches {counts}, graphs "
                             f"{seq.graphs_captured}, record {rec}")
    print(f"whisper lmstep at {FAM_CUT} + {FAM_CUT} layers: one round "
          f"{walls[0]:.4f} s (capture included), launches {counts}; peak "
          f"device memory {_gib(torch.cuda.max_memory_allocated())}")
    del seq, model
    gc_collect()
    return counts


def _reckon(name: str, n: int, extra: float, what: str) -> None:
    print(f"reckoning, {name}: {n:,} params, {_gib(n * 4)} float32 each "
          f"of the donated weights, the gradients and the SGD momentum "
          f"({_gib(3 * n * 4)}); {what} {_gib(extra)}: about "
          f"{_gib(3 * n * 4 + extra)} at the peak")


def whisper_training(launches: dict) -> dict:
    """Phase 19 (a): whisper-large-v3 at full depth, blockwise, remat
    "full"; the cut-depth comparisons; one lmstep round."""
    unit = 8 * 1500 * 1280 * 4        # one (8, 1500, 1280) float32
    _reckon("whisper-large-v3", FAM_TRAIN["whisper"][1],
            32 * 24 * unit + 5 * 8 * 129 * 51968 * 4,
            "the unchecked encoder's activations, about 24 (8, 1,500, "
            "1,280) float32 a layer over 32 layers, and the logits")
    run = family_training("whisper")
    launches["whisper mesh step"] = run["launches"]
    out = {"peak": run["peak"], **profiled_step(
        run["model"], run["argv"], "whisper-large-v3 step")}
    del run
    gc_collect()
    out["cut"] = cut_comparison("whisper")
    gc_collect()
    launches["whisper lmstep sequential"] = whisper_lmstep_round()
    return out


def internvl2_training(launches: dict) -> tuple[dict, float]:
    """Phase 19 (b): internvl2-1b at full depth, remat "full", against
    the torch judge; its lmstep at 4 layers, sequential and pipelined.
    Returns what it measured and the larger K1 entropy error."""
    _reckon("internvl2-1b", FAM_TRAIN["internvl2"][1],
            5 * 16 * 129 * 151808 * 4 + 24 * 16 * 385 * 896 * 4,
            "logits (16, 129, 151,808) about 5 live and each layer's "
            "input")
    run = family_training("internvl2")
    launches["internvl2 mesh step"] = run["launches"]
    recs, cfg = run["records"], run["model"].cfg
    out = {"peak": run["peak"], **profiled_step(
        run["model"], run["argv"], "internvl2-1b step")}
    del run
    gc_collect()
    checked = hold_to_torch_judge(FAM_TRAIN["internvl2"][0] + FAM_STEP_ARGV,
                                  cfg, FAM_TRAIN["internvl2"][1], recs,
                                  "internvl2 mesh step")
    k1_err = checked.ent_err
    del checked
    gc_collect()
    cfg4 = cfg.replace(num_layers=FAM_CUT)
    stub = train.stub_frontend(cfg4, "random", 0, DEV)
    out["remat"] = remat_rounds(cfg4, FAM_CUT_PARAMS["internvl2"],
                                "internvl2 lmstep", stub, FAM_REMAT_WINDOWS,
                                LMSTEP_VARIANTS)
    peak, args = lmstep_reckoning(cfg4, FAM_LMSTEP_WINDOWS, stub)
    print(f"reckoning, internvl2 lmstep at {FAM_CUT} layers, "
          f"{FAM_LMSTEP_WINDOWS} windows: the client program's peak "
          f"{_gib(peak)} ({_gib(args)} of it its arguments), counted on "
          "the meta device")
    # 8 windows a client: the soft label's pass over every window holds
    # (4, 8, 128, 151,808) float32 logits, 2.32 GiB a copy; on an H100
    # 80GB the client program peaks about 29 GiB above the start and its
    # graph's pool reserves about 45 GiB, so two servers' graphs do not
    # fit together: lmstep_pair holds one at a time
    pair = lmstep_pair(cfg4, FAM_CUT_PARAMS["internvl2"], "internvl2 lmstep",
                       stub, windows=FAM_LMSTEP_WINDOWS)
    launches.update(pair["launches"])
    out["lmstep_peak"] = pair["peak"]
    return out, max(k1_err, pair["k1_err"])


def lmstep_reckoning(cfg, windows: int, stub=None) -> tuple[int, int]:
    """(peak, argument) bytes of lmstep's client program for one cohort of
    4 at ``cfg``, ``windows`` windows of LMSTEP_SEQ + 1 tokens, minibatches
    of 2, counted on the meta device by the dry-run's counter: nothing is
    computed or allocated."""
    model = build_model(cfg, device="meta", kernels="torch")
    data = _lm_data(cfg, LMSTEP_SEQ, windows)
    cohort = {k: torch.as_tensor(v[:4]).to("meta") for k, v in data.items()}
    params = {k: v.detach() for k, v in model.params().items()}
    stub = None if stub is None else torch.empty_like(stub, device="meta")
    client = fl.LMWindowStrategy(fl.LocalSpec(
        epochs=1, lr=0.01, batch_size=2)).make_client_fn(
            train.lm_window_apply(model, cfg, stub))
    counter, _, _ = count_call(
        lambda: client(params, cohort, None, None, None), (params, cohort))
    return counter.peak_bytes, counter.argument_bytes


@contextlib.contextmanager
def grad_form(form: str):
    """lmstep servers built inside take their gradient as ``form``:
    "vjp" (``fl.strategies.pulled_grad``, the port's) or "grad"
    (``torch.func.grad``, its form before; the same bits)."""
    pulled = fl.strategies.pulled_grad
    if form == "grad":
        fl.strategies.pulled_grad = torch.func.grad
    elif form != "vjp":
        raise ValueError(f"gradient form {form!r}")
    try:
        yield
    finally:
        fl.strategies.pulled_grad = pulled


def remat_rounds(cfg, n_params: int, what: str, stub, windows: int,
                 variants=(("none", "vjp"), ("full", "vjp"))) -> dict:
    """One sequential lmstep round (the client program captured) at
    ``cfg`` under each (remat, gradient form) of ``variants``
    (:func:`grad_form`), ``windows`` windows a client, one server alive
    at a time: every round's record and global params equal the first's
    bit for bit; returns each variant's peak above the memory held
    before it."""
    peaks, first = {}, None
    for remat, form in variants:
        gc_collect()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg.replace(remat=remat), device=DEV,
                            kernels="torch", seed=0)
        if model.num_params() != n_params:
            raise AssertionError(f"{what}: {model.num_params()} params")
        with grad_form(form):
            seq = build_lmstep(model, cfg, _lm_data(cfg, LMSTEP_SEQ,
                                                    windows), stub=stub)
        timed_round(seq, f"{what} remat {remat!r} {form}")
        torch.cuda.synchronize()
        peaks[remat, form] = torch.cuda.max_memory_allocated() - base
        got = (seq.history[0], {k: v.cpu() for k, v in
                                _leaves(seq.global_params).items()})
        if seq.graphs_captured != 1:
            raise AssertionError(f"{what} remat {remat!r} {form}: not "
                                 "captured")
        del seq, model
        if first is None:
            first = got
            continue
        if got[0] != first[0] or any(not torch.equal(v, first[1][k])
                                     for k, v in got[1].items()):
            raise AssertionError(f"{what}: remat {remat!r} {form}'s round "
                                 f"differs from {variants[0]}'s")
    gc_collect()
    print(f"{what} at {cfg.num_layers} layers, {windows} windows a client, "
          "one captured round, peak above the start: " + "; ".join(
              f"remat {r!r} {f} {_gib(p)}" for (r, f), p in peaks.items())
          + "; records and global params equal bit for bit")
    return peaks


def moe_training(launches: dict) -> dict:
    """Phase 19 (c): qwen3-moe-235b-a22b at 1 of 94 layers, the first moe
    backward, with each step's dropped assignments and aux loss."""
    n = FAM_TRAIN["qwen3-moe"][1]
    _reckon("qwen3-moe-235b-a22b, 1 layer", n,
            5 * 16 * 129 * 152064 * 4 + 2 * 128 * 4096 * 1536 * 4,
            "logits (16, 129, 152,064) about 5 live and the donated "
            "update's temporaries of the largest leaf (an expert matrix, "
            "twice)")
    counter = DroppedCounter()
    run = family_training("qwen3-moe", on_build=counter.attach)
    launches["qwen3-moe mesh step"] = run["launches"]
    cfg = run["model"].cfg
    dropped = counter.per_step(TRAIN_STEPS, cfg.num_layers)
    t = 16 * 129 * cfg.experts_per_token
    for r, d in zip(run["records"], dropped):
        print(f"qwen3-moe step {r['step']}: {d} of {t} assignments "
              f"dropped ({d / t:.3f}), aux loss {r['aux_loss']:.6f}")
    out = {"peak": run["peak"], "dropped": dropped, **profiled_step(
        run["model"], run["argv"], "qwen3-moe-235b-a22b step")}
    del run
    gc_collect()
    out["lmstep"] = moe_lmstep(cfg, launches)
    return out


def moe_lmstep(cfg, launches: dict) -> int:
    """qwen3-moe-235b-a22b's lmstep at 1 of 94 layers, internvl2's cohort
    of 4 and FAM_LMSTEP_WINDOWS windows: reckoned on the meta device, and
    run for one sequential round (K2 once) only if the reckoning is below
    LMSTEP_FIT_GIB. Returns the reckoned peak."""
    n = FAM_TRAIN["qwen3-moe"][1]
    peak, args = lmstep_reckoning(cfg, FAM_LMSTEP_WINDOWS)
    print(f"reckoning, qwen3-moe lmstep at {cfg.num_layers} of 94 layers, "
          f"a cohort of 4, {FAM_LMSTEP_WINDOWS} windows of {LMSTEP_SEQ + 1} "
          f"tokens: the client program's peak {_gib(peak)} counted on the "
          f"meta device ({_gib(args)} of it its arguments); by hand, the "
          f"global params and each client's params, momentum and gradient "
          f"({n:,} float32 each) {_gib(13 * n * 4)}")
    if peak >= LMSTEP_FIT_GIB * 2**30:
        print(f"qwen3-moe lmstep: {_gib(peak)} does not fit on one card "
              f"(run below {LMSTEP_FIT_GIB} GiB only): not run")
        return peak
    model = build_model(cfg, device=DEV, kernels="torch", seed=0)
    torch.cuda.reset_peak_memory_stats()
    seq = build_lmstep(model, cfg, _lm_data(cfg, LMSTEP_SEQ,
                                            FAM_LMSTEP_WINDOWS))
    counts, walls = _counted_rounds(seq, "qwen3-moe lmstep sequential", 1)
    want = {**dict.fromkeys(WRAPPERS, 0), "masked_weighted_sum": 1}
    if counts != want or seq.graphs_captured != 1 or \
            not math.isfinite(seq.history[0]["entropy"]):
        raise AssertionError(f"qwen3-moe lmstep: launches {counts}, graphs "
                             f"{seq.graphs_captured}, {seq.history[0]}")
    launches["qwen3-moe lmstep sequential"] = counts
    print(f"qwen3-moe lmstep: one round {walls[0]:.4f} s (capture "
          f"included), launches {counts}; peak device memory "
          f"{_gib(torch.cuda.max_memory_allocated())}")
    del seq, model
    gc_collect()
    return peak


def family_training_path() -> dict:
    """Phase 19: the mesh step of whisper-large-v3 (blockwise, remat
    "full"), internvl2-1b (remat "full") and qwen3-moe-235b-a22b (1 of 94
    layers) through ``train.main`` with K1 judging each step, each step
    timed and one profiled; whisper's cut-depth comparisons of route and
    remat and one lmstep round; internvl2 against the torch judge and its
    lmstep at 4 layers, sequential and pipelined. Returns the paths'
    launches, what each measured and the larger K1 entropy error."""
    launches = {}
    out = {"whisper": whisper_training(launches)}
    out["internvl2"], k1_err = internvl2_training(launches)
    out["qwen3-moe"] = moe_training(launches)
    return {"launches": launches, "families": out, "k1_err": k1_err}


def gc_collect() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------ 21. the example twins

EXAMPLES = Path(__file__).resolve().parent / "examples"
EX_FINETUNE_ROUNDS = 8          # torch_fl_llm_finetune's default rounds


def run_example(name: str, argv: list) -> tuple[list, dict, object]:
    """(printed lines, launches, what ``main`` returns) of
    ``examples/<name>.py``'s ``main(argv)``, its counts set to 0 just
    before; echoes each line."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    _reset_counts()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    torch.cuda.synchronize()
    counts = _read_counts()
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[{name}] {line}")
    print(f"{name} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s, "
          f"launches {counts}", flush=True)
    return lines, counts, out


def _lines_like(name: str, lines: list, pattern: str, count: int) -> list:
    """The lines that match ``pattern``; raises unless there are
    ``count``."""
    found = [m for m in map(re.compile(pattern).fullmatch, lines) if m]
    if len(found) != count:
        raise AssertionError(f"{name}: {len(found)} lines like {pattern!r}, "
                             f"expected {count}: {lines}")
    return found


def examples_path() -> dict:
    """Phase 21: each example twin's ``main`` on the card at its default
    arguments (the device the card by default): what each prints held to
    the reference example's lines, and the kernels counted where they
    launch: torch_fl_llm_finetune on ``--kernels cuda``, whose scan
    blocks judge in K1's loop and aggregate in K2; torch_serve_lm on ``--kernels cuda`` runs K3, K4 and
    K5, its greedy tokens equal to the torch route's. Returns the
    launches by example."""
    launches = {}
    name = "torch_quickstart"
    lines, launches[name], servers = run_example(name, [])
    rounds = _lines_like(
        name, lines, r"  round \d+: positives=(\d+)/4 entropy=(\S+) "
        r"acc=(\S+) uplink_savings=\S+%", 16)
    if not all(math.isfinite(float(m[2])) for m in rounds[:8]) or \
            any(s.device.type != DEV for s in servers.values()):
        raise AssertionError(f"{name}: {lines}")
    _lines_like(name, lines, r"final: FedEntropy=\S+ vs FedAvg=\S+", 1)
    name = "torch_compare_strategies"
    lines, launches[name], servers = run_example(name, [])
    rows = _lines_like(name, lines, r"(\w+) +([\d.]+) +([\d.]+)", 4)
    if [m[1] for m in rows] != ["fedavg", "fedprox", "scaffold", "moon"] \
            or len(servers) != 8:
        raise AssertionError(f"{name}: {lines}")
    name = "torch_fl_llm_finetune"
    lines, launches[name], server = run_example(name, ["--verify",
                                                       "--kernels", "cuda"])
    _lines_like(name, lines, r"round \d+: positives=\d+/4 entropy=\S+ "
                r"spec=(hit|miss)", EX_FINETUNE_ROUNDS)
    _lines_like(name, lines, rf"verify: {EX_FINETUNE_ROUNDS} scan rounds == "
                r"sequential Server \(histories and params bit-for-bit\)", 1)
    got = launches[name]
    if got["entropy_judge_loop"] < EX_FINETUNE_ROUNDS or \
            got["masked_weighted_sum"] < EX_FINETUNE_ROUNDS or \
            not server.stats()["captured_block"]:
        raise AssertionError(f"{name}: launches {got}, {server.stats()}")
    name = "torch_serve_lm"
    lines, launches[name], tokens = run_example(name, ["--kernels", "cuda"])
    if any(launches[name][k] == 0 for k in
           ("flash_attention", "decode_attention", "ssd_chunked")):
        raise AssertionError(f"{name}: launches {launches[name]}")
    _, plain, plain_tokens = run_example(name, ["--kernels", "torch"])
    if any(plain.values()) or not np.array_equal(tokens, plain_tokens):
        raise AssertionError(f"{name}: the cuda route's tokens {tokens} "
                             f"against the torch route's {plain_tokens}")
    print("torch_serve_lm: the cuda route's greedy tokens equal the torch "
          "route's")
    return launches


# ------------------------------------------------- the client axis (22)

SHARD = fl.RuntimeConfig(shard=True, speculate=True, spec_backend="cuda")
SHARD_TURN_ROUNDS = 5
# how far a sharded run's params may part from the plain sequential
# server's after ROUNDS rounds, relative to each leaf's largest value: the
# vmap's width moves cuDNN's sums (an H100 80GB HBM3 at 700 W: 1.619e-03
# for fedentropy on three shards, 4.382e-07 for fedcat+maxent; 6.041e-05
# after one client update, chip_smoke.py --width-gap), so about three
# times the widest gap seen; a block trained on the wrong rows parts
# much further
SHARD_PARAMS_RTOL = 5e-3


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _server_device(corpus) -> torch.device:
    """The device phase 4's servers run on, with its index."""
    d = corpus.device
    return torch.device("cuda", torch.cuda.current_device()) \
        if d.type == "cuda" else d


def _blocked(program, n: int, axes: tuple):
    """``program`` run on n blocks of the cohort in turn, as the fan-out's
    shards run it, written apart from the port's fan-out: the axis-0
    arguments padded to a multiple of n by repeating the last row (or
    group), cut into n equal blocks, each block's outputs concatenated
    and cut back. A sequential server with this program computes what a
    mesh of n shards computes, on one device, in one graph."""
    def call(*args):
        m = pytree.tree_leaves(args[1])[0].shape[0]
        per = -(-m // n)

        def block(a, ax, j):
            if ax != 0 or a is None:
                return a
            return pytree.tree_map(lambda t: torch.cat(
                [t, t[-1:].expand((per * n - m,) + tuple(t.shape[1:]))])[
                    j * per:(j + 1) * per], a)
        outs = [program(*(block(a, ax, j) for a, ax in zip(args, axes)))
                for j in range(n)]
        return pytree.tree_map(lambda *xs: torch.cat(xs)[:m], *outs)
    return call


def blocked_server(server, n: int):
    """``server`` (sequential, no round run yet) with its client program
    run in n blocks (:func:`_blocked`)."""
    chain = getattr(server.strategy, "prepare_round", None) is not None
    axes = tuple(server._client_in_axes()) + ((0,) if chain else ())
    server._eager_fn = _blocked(server._eager_fn, n, axes)
    return server


def _sharded_rounds(seq, blocked, sharded, label: str,
                    k2: bool = True) -> dict:
    """ROUNDS rounds of the sequential server ``seq`` and of ``blocked``
    (the same with its program run in the mesh's blocks), not counted,
    then of ``sharded`` with every count at 0 just before and read just
    after. Raises unless ``sharded`` equals ``blocked`` bit for bit (the
    fan-out adds nothing to what its blocks compute), its integer records
    equal ``seq``'s, its params are within SHARD_PARAMS_RTOL of ``seq``'s
    (the vmap's width: cuDNN sums a grouped convolution's weight gradient
    in another order at 4 clients than at 10), and the K1 loop and K2
    launches are a speculated round's. Returns the launches."""
    for _ in range(ROUNDS):
        seq.round()
        blocked.round()
    sharded.corpus.block_copy_nbytes = 0
    _reset_counts()
    for _ in range(ROUNDS):
        sharded.round()
    torch.cuda.synchronize()
    launches = _read_counts()
    equal_to_sequential(blocked, sharded, f"{label} vs the sequential "
                        "server on the mesh's blocks")
    for a, b in zip(seq.history, sharded.history):
        for key in ("selected", "positive", "negative", "comm"):
            if a[key] != b[key]:
                raise AssertionError(f"{label}: round {a['round']} {key}: "
                                     f"{b[key]} != {a[key]}")
    la, lb = _leaves(seq.global_params), _leaves(sharded.global_params)
    gap = max(float((lb[k] - t).abs().max() / t.abs().max().clamp(
        min=1e-30)) for k, t in la.items())
    if not all(bool(torch.isfinite(t).all()) for t in lb.values()):
        raise AssertionError(f"{label}: non-finite params")
    print(f"{label}: integer records equal to the sequential server's over "
          f"{ROUNDS} rounds; params max |diff| / max |value| per leaf "
          f"{gap:.3e} against it, limit {SHARD_PARAMS_RTOL:g} (the blocked "
          "sequential server's gap, bit for bit: the vmap's width, not the "
          "fan-out)")
    if not gap <= SHARD_PARAMS_RTOL:
        raise AssertionError(f"{label}: params {gap:.3e} from the "
                             f"sequential server's, over {SHARD_PARAMS_RTOL}")
    misses = sum(not r["spec_hit"] for r in sharded.history)
    want = {"entropy_judge_loop": ROUNDS, "entropy_judge_sweep": 0,
            "masked_weighted_sum": (ROUNDS + misses) if k2 else 0}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{label}: launches {launches}; expected "
                             f"{want} ({misses} misses)")
    return launches


def _layout_lines(server, label: str, card: str) -> None:
    corpus, mesh = server.corpus, server.client_mesh()
    # each round's dispatch, a miss's re-dispatch, and the speculative
    # dispatch of the round after the last
    dispatches = ROUNDS + sum(not r["spec_hit"] for r in server.history) \
        + (server._pending is not None)
    print(f"[{card}] {label}: mesh {[str(d) for d in mesh.devices]}; "
          f"corpus {corpus.num_clients} clients padded to "
          f"{corpus.padded_num_clients}; device_nbytes() "
          f"{corpus.device_nbytes()} B, block bytes "
          f"{corpus.block_nbytes()}; graphs captured "
          f"{server.graphs_captured} ({server.graphs_captured / len(mesh):g}"
          f" a shard); bytes copied between shard blocks "
          f"{corpus.block_copy_nbytes} in {dispatches} dispatches "
          f"({corpus.block_copy_nbytes / dispatches:.0f} a dispatch)")


def width_gap(params, corpus, card: str) -> None:
    """``--width-gap``'s run. What a vmap's width does to the bits, on
    one cohort of phase 4's first round, eager: the client program's
    outputs on 4 and on 1 of its rows against the same rows of its
    10-client run (cuDNN picks its
    algorithms by the batch), and the three-shard fan-out against the
    same program run on its blocks in turn (``_blocked``), which must be
    equal bit for bit."""
    server = build_fl("fedentropy", params, corpus)
    idx = np.asarray(server.selector.select(10))
    data = corpus.cohort(idx)
    vm = server._eager_fn
    full = vm(server.global_params, data, None, None, None)

    def gap(a, b):
        return max(float((x - y).abs().max() / y.abs().max().clamp(
            min=1e-30)) for x, y in zip(pytree.tree_leaves(a),
                                        pytree.tree_leaves(b)))
    for m in (4, 1):
        part = vm(server.global_params, {k: v[:m] for k, v in data.items()},
                  None, None, None)
        print(f"[{card}] vmap width: the client program on {m} of the "
              f"cohort's rows against the same rows of its 10-client run: "
              f"max |diff| / max |value| per leaf "
              f"{gap(part, pytree.tree_map(lambda t: t[:m], full)):.3e}")
    dev = _server_device(corpus)
    fan = fl.runtime.make_sharded_client_fn(
        cnn.apply, server.strategy.spec, server._client_in_axes(),
        fl.make_client_mesh([dev] * 3), inner=vm, inner_axes=())
    got = fan(server.global_params, data, None, None, None)
    want = _blocked(vm, 3, tuple(server._client_in_axes()))(
        server.global_params, data, None, None, None)
    same = all(torch.equal(x, y) for x, y in zip(pytree.tree_leaves(got),
                                                   pytree.tree_leaves(want)))
    print(f"[{card}] the three-shard fan-out against the program on its "
          f"blocks in turn, eager: equal bit for bit {same}; against the "
          f"10-client run {gap(got, full):.3e}")
    if not same:
        raise AssertionError("the fan-out differs from its blocks' program")


def time_sharded(servers: dict, card: str) -> None:
    """The unsharded, one-card-mesh and three-shard pipelined engines of
    the checks (``servers``, route -> server), run on in turns
    (unsharded, one-card, three-shard, three-shard, one-card, unsharded),
    SHARD_TURN_ROUNDS rounds a turn: a round's time is the host clock
    from the previous round's return to its own (no synchronise between
    rounds); the median of rounds 1-4 a turn (round 0 takes the dispatch
    the turn before left pending). No round here runs under the profiler:
    a profiled round this late in the run has crashed the process once
    (a segmentation fault in the second of two), where the same phase
    run alone profiled without fault."""
    order = list(servers)
    times = {r: [] for r in servers}
    for route in order + order[::-1]:
        server = servers[route]
        torch.cuda.synchronize()
        stamps = [time.perf_counter()]
        for _ in range(SHARD_TURN_ROUNDS):
            server.round()
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        gaps = np.diff(stamps)
        times[route].append(float(statistics.median(gaps[1:])))
        print(f"[{card}] {route}: round s "
              f"{[round(float(g), 5) for g in gaps]}, median of rounds "
              f"1-{SHARD_TURN_ROUNDS - 1} {times[route][-1]:.5f}",
              flush=True)
    print(f"[{card}] fedentropy pipelined round wall s in turns (unsharded,"
          f" one-card mesh, three shards, three shards, one-card mesh, "
          f"unsharded): " + ", ".join(f"{r} {[round(x, 5) for x in ts]}"
                                      for r, ts in times.items()))


def shard_path(params, corpus) -> dict:
    """Phase 22: the client axis over several shards at the main path's
    width. Returns the launches by path."""
    card = _card_line()
    dev = _server_device(corpus)
    out = {}
    # a mesh of the one card: the unsharded pipelined engine's programs
    plain = build_fl("fedentropy", params, corpus, runtime=SPEC)
    one = build_fl("fedentropy", params, corpus, runtime=SHARD, mesh=[dev])
    label = "shard one-card mesh"
    out[label] = run_speculative(plain, one, ROUNDS, label)
    if out[label]["entropy_judge_loop"] != ROUNDS or \
            one.graphs_captured != 1:
        raise AssertionError(f"{label}: {out[label]}, "
                             f"{one.graphs_captured} graphs")
    _layout_lines(one, label, card)

    # three shard positions on the card
    seq = build_fl("fedentropy", params, corpus)
    blocked = blocked_server(build_fl("fedentropy", params, corpus), 3)
    three = build_fl("fedentropy", params, corpus, runtime=SHARD,
                     mesh=[dev] * 3)
    label = "shard three shards"
    out[label] = _sharded_rounds(seq, blocked, three, label)
    if three.corpus.padded_num_clients != 102 or \
            three.graphs_captured != 3 or corpus.mesh is not None:
        raise AssertionError(f"{label}: {three.corpus.padded_num_clients} "
                             f"rows, {three.graphs_captured} graphs, the "
                             f"shared corpus laid out over {corpus.mesh}")
    _layout_lines(three, label, card)
    print(f"[{card}] {label}: launches {out[label]}")
    del seq, blocked
    gc_collect()

    # FedCAT's whole groups over the three shards
    seq = build_cat("fedcat+maxent", params, corpus,
                    judge=fl.MaxEntropyJudge())
    blocked = blocked_server(build_cat(
        "fedcat+maxent", params, corpus, judge=fl.MaxEntropyJudge()), 3)
    cat = build_cat("fedcat+maxent", params, corpus,
                    judge=fl.MaxEntropyJudge(), runtime=SHARD,
                    mesh=[dev] * 3)
    label = "fedcat+maxent three shards"
    out[label] = _sharded_rounds(seq, blocked, cat, label, k2=False)
    groups = len(cat.selector.last_groups)
    if groups != 5 or cat.graphs_captured != 3:
        raise AssertionError(f"{label}: {groups} groups, "
                             f"{cat.graphs_captured} graphs")
    _layout_lines(cat, label, card)
    print(f"[{card}] {label}: {groups} chains of {CAT_GROUP} padded to 6 "
          f"groups, 2 a shard; launches {out[label]}")
    del seq, blocked, cat
    gc_collect()

    count = torch.cuda.device_count()
    if count > 1:
        seq = build_fl("fedentropy", params, corpus)
        blocked = blocked_server(build_fl("fedentropy", params, corpus),
                                 count)
        many = build_fl("fedentropy", params, corpus, runtime=SHARD)
        label = f"shard one shard a card ({count} cards)"
        out[label] = _sharded_rounds(seq, blocked, many, label)
        _layout_lines(many, label, card)
        del seq, blocked, many
        gc_collect()
    else:
        print(f"[{card}] ran on 1 card: the one-shard-per-card mesh is the "
              "one-card mesh above; no run here spans two cards")
    time_sharded({"unsharded": plain, "one-card mesh": one,
                  "three shards": three}, card)
    return out


def width_gap_main() -> int:
    """``--width-gap``: :func:`width_gap` on phase 4's seeded data, with
    the card settings of :func:`main`."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    _card_settings()
    params, corpus, _, _ = paper_setup()
    width_gap(params, corpus, _card_line())
    return 0


def _card_settings() -> None:
    """TF32 off for matmul and cuDNN, cuDNN deterministic."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    _card_settings()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cudnn.deterministic={torch.backends.cudnn.deterministic}")

    _phase("1. build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        print(f"-- nvcc {name} ({info['seconds']:.2f} s):\n"
              f"{info['log'].strip()}")
    print(count_hmma())
    print(count_hmma("ssd_scan"))
    print(count_hmma("decode_attention"))
    for name in ("ssd_scan", "decode_attention"):
        if name in built:
            print(f"{name} ptxas:\n  " + "\n  ".join(
                ptxas_lines(built[name]["log"])))

    _phase("2. K1 entropy_judge_sweep and entropy_judge_loop vs plain")
    k1_err = check_k1_sweep()
    k1_loop_err = check_k1_loop()
    _phase("3. K2 masked_weighted_sum vs plain")
    k2_err = check_k2()
    _phase("4. main path: fedentropy, N=100, CNN at 32x32x3, 10 classes")
    launches, walls, judge_inputs, n_params, setup, split = main_path()
    _phase("5. times")
    fl_times = time_kernels(judge_inputs, n_params)
    for name, (ms, plain_ms, lib_ms, bound, by, dev_ms,
               shape) in fl_times.items():
        lib = "none" if lib_ms is None else f"{lib_ms:.5f} ms"
        print(f"{name} {shape}: {ms:.5f} ms per call (kernel alone "
              f"{dev_ms:.5f} ms), plain {plain_ms:.5f} ms, library {lib} "
              f"(in turns), bound {bound:.3e} ms ({by})")
    time_k1_wide()
    for route, ws in walls.items():
        print(f"fedentropy round wall s, {route} route (rounds 2-3 and "
              f"the turns): {[round(x, 4) for x in ws]}, median "
              f"{statistics.median(ws):.4f}")

    _phase("6. K3 flash_attention, K4 decode_attention, K5 ssd_chunked "
           "vs plain")
    lm_err = {"flash_attention": check_k3(), "decode_attention": check_k4(),
              "ssd_chunked": check_k5()}
    _phase(f"7. serve {SERVE_ARCH} at full width: {SERVE_B} prompts of "
           f"{SERVE_S} tokens, {SERVE_GEN} greedy tokens")
    served = serve_path()
    _phase("8. LM kernel times at the serve shapes (float32)")
    lm_times = time_lm_kernels()
    _phase("9. moon and scaffold at the main path's width, and the "
           "FedEntropyTrainer shim")
    others = other_compositions(*setup)
    _phase("10. the pipelined engine at the main path's width: verdicts "
           "speculated through K1's loop, aggregated in K2")
    pipelined = pipelined_path(*setup, split)
    _phase("11. FedCAT at the main path's width: 5 chains of 2, "
           "fedcat+maxent judged in K1's loop, sequential and pipelined")
    fedcat = fedcat_path(*setup)
    _phase("12. the async buffered engine at the main path's width: "
           "admission in K1's loop over protected rows, flushes in K2")
    asynced = async_path(*setup, split)
    _phase("13. clusters at the main path's width: ifca+maxent at K = 3 "
           "judged per cluster in K1's loop, perclstr in K2, sequential "
           "and pipelined; fesem")
    clustered = cluster_path(*setup, split)
    _phase("14. the scan engine at the main path's width: blocks of 4 "
           "rounds, each one CUDA graph with K1's loop and K2 inside it")
    scanned = scan_path(*setup)
    _phase("15. the streaming plane at the main path's width: N = 1000 "
           "uint8 clients (1.54 GB) on the host, one cohort uploaded a "
           "round, staged ahead in pinned memory on a side stream")
    streamed = streaming_path(setup[0], split)
    _phase("16. LM training: the gradient-level step at qwen3-0.6b's full "
           "configuration with K1's loop judging 152,064-class soft labels; "
           "lmstep at its widths, depth 4, sequential and pipelined (K1, "
           "K2); async and scan at the reduced config")
    t16 = time.perf_counter()
    trained = lm_training_path()
    print(f"phase 16 took {time.perf_counter() - t16:.1f} s")
    _phase(f"17. serve {MOE_ARCH} at its published widths, {MOE_LAYERS} of "
           f"94 layers: {MOE_B} prompts of {MOE_S} tokens, {MOE_GEN} greedy "
           f"tokens, sort-based capacity dispatch over 128 experts; K3 and "
           f"K4 at g = 16")
    t17 = time.perf_counter()
    moe_served = moe_serve_path()
    moe_times = time_moe_kernels()
    print(f"phase 17 took {time.perf_counter() - t17:.1f} s")
    _phase(f"18. serve whisper-large-v3 and internvl2-1b at full width and "
           f"depth: {FAM_B} utterances of {WHISPER_T} frames with prompts "
           f"of {WHISPER_S} tokens, {FAM_B} x {VLM_P} patches with prompts "
           f"of {VLM_S} tokens, {FAM_GEN} greedy tokens each; cross "
           f"attention on K3, the decoders' caches on K4")
    t18 = time.perf_counter()
    fam_served = {arch.split("-")[0]: family_serve_path(arch)
                  for arch in FAM_ARCHS}
    fam_times = time_family_kernels()
    print(f"phase 18 took {time.perf_counter() - t18:.1f} s")
    _phase("19. training of the moe, vlm and encdec families: the mesh "
           "step of whisper-large-v3 (blockwise attention, remat 'full') "
           "and internvl2-1b at full width and depth and of "
           f"{MOE_ARCH} at 1 of 94 layers, K1's loop judging each step; "
           "whisper's route and remat held at 4 + 4 layers; internvl2 "
           "against the torch judge and its lmstep at 4 layers (remat "
           "'none' against 'full' at 4 windows; 8 windows sequential and "
           "pipelined); a whisper lmstep round; qwen3-moe's lmstep "
           "reckoned")
    t19 = time.perf_counter()
    fam_trained = family_training_path()
    print(f"phase 19 took {time.perf_counter() - t19:.1f} s")
    _phase(f"20. serve {', '.join(DENSE_ARCHS)} at full width and depth, "
           f"one at a time: {MOE_B} prompts of {MOE_S} tokens, {MOE_GEN} "
           f"greedy tokens each; the dry-run's reckoning of the plain "
           f"prefill held against the card's peak")
    t20 = time.perf_counter()
    fam_served.update({arch.split("-")[0]: family_serve_path(arch)
                       for arch in DENSE_ARCHS})
    fam_times.update(time_dense_kernels())
    print(f"phase 20 took {time.perf_counter() - t20:.1f} s")
    _phase("21. the example twins on the card: torch_quickstart, "
           "torch_compare_strategies, torch_fl_llm_finetune --verify "
           "--kernels cuda (K1, K2) and torch_serve_lm --kernels cuda (K3, K4, K5)")
    t21 = time.perf_counter()
    examples = examples_path()
    print(f"phase 21 took {time.perf_counter() - t21:.1f} s")
    _phase("22. the client axis over several shards at the main path's "
           "width: fedentropy pipelined on a mesh of the one card and on "
           "three shard positions of it, fedcat+maxent's whole groups on "
           "the three, K1's loop speculating and K2 aggregating on the "
           "server's device")
    t22 = time.perf_counter()
    sharded = shard_path(*setup)
    print(f"phase 22 took {time.perf_counter() - t22:.1f} s; phases 1-22 "
          f"{time.perf_counter() - _START:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    sources = {  # wrapper: (timed in phase 5, CUDA source, TPU kernel)
        "entropy_judge_sweep": (True, "entropy_judge.cu",
                                "entropy_judge.py:68"),
        "entropy_judge_loop": (True, "entropy_judge.cu",
                               "entropy_judge.py:68, run inside "
                               "src/repro/core/judgment.py::judge's "
                               "while_loop (:113)"),
        "masked_weighted_sum": (True, "fused_aggregate.cu",
                                "fused_aggregate.py:65"),
        "flash_attention": (None, "flash_attention.cu",
                            "flash_attention.py:75"),
        "decode_attention": (None, "decode_attention.cu",
                             "decode_attention.py:60"),
        "ssd_chunked": (None, "ssd_scan.cu", "ssd_scan.py:73")}
    errors = {"entropy_judge_sweep": k1_err,
              "entropy_judge_loop": max(k1_loop_err, trained["k1_err"],
                                        fam_trained["k1_err"]),
              "masked_weighted_sum": k2_err, **lm_err}
    kernels = []
    for name, (on_fl_path, cu, tpu) in sources.items():
        if on_fl_path:
            ms, plain_ms, lib_ms, bound, by, dev_ms, _ = fl_times[name]
            count = launches[name]
        else:
            ms, plain_ms, lib_ms, bound, by, dev_ms = lm_times[name]
            count = served["launches"][name]
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{cu}",
               "replaces": f"src/repro/kernels/{tpu}", "launches": count,
               "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
               _kernel_ms_key(dev_ms): dev_ms}
        if name == "flash_attention":
            row["tensor_core_bound_ms"] = bound
            row["cuda_core_bound_ms"] = lm_times["cuda_core_bound_ms"]
        if name == "decode_attention":
            profiled = lm_times["k4_profile"]
            row["profiled_launches"] = {path: x[0]
                                        for path, x in profiled.items()}
            row["kernels_per_call"] = {path: x[1]
                                       for path, x in profiled.items()}
        if name in moe_times:
            row["launches_by_path"] = {
                "zamba2 serve": count,
                "qwen3-moe serve": moe_served["launches"][name], **{
                    f"{model} serve": o["launches"][name]
                    for model, o in fam_served.items()},
                "torch_serve_lm example": examples["torch_serve_lm"][name]}
            shapes = {"qwen3-moe serve": moe_times[name], **{
                label: t for (kernel, label), t in fam_times.items()
                if kernel == name}}
            row["lm_shapes"] = {label: {
                "shape": list(t[6]), "ms": t[0], "plain_ms": t[1],
                "library_ms": t[2], "bound_ms": t[3], "bound_by": t[4],
                _kernel_ms_key(t[5]): t[5]} for label, t in shapes.items()}
        if name in ("entropy_judge_loop", "masked_weighted_sum"):
            row["launches_by_path"] = {"fedentropy": count, **{
                comp: o["launches"][name] for comp, o in others.items()}, **{
                path: n[name] for path, n in pipelined.items()}, **{
                path: n[name] for path, n in fedcat.items()}, **{
                path: n[name] for path, n in asynced.items()}, **{
                path: n[name] for path, n in clustered.items()}, **{
                path: n[name] for path, n in scanned.items()}, **{
                path: n[name] for path, n in streamed.items()}, **{
                path: n[name] for path, n in trained["launches"].items()},
                **{path: n[name] for path, n in
                   fam_trained["launches"].items()},
                "torch_fl_llm_finetune example":
                    examples["torch_fl_llm_finetune"][name],
                **{path: n[name] for path, n in sharded.items()}}
            row["lm_shapes"] = {
                label: {"shape": list(t[6]), "ms": t[0], "plain_ms": t[1],
                        "library_ms": t[2], "bound_ms": t[3],
                        "bound_by": t[4], _kernel_ms_key(t[5]): t[5]}
                for label, t in trained["kernels"].items()
                if label.startswith("K1") == (name == "entropy_judge_loop")}
        if name == "ssd_chunked":
            row["launches_by_path"] = {
                "zamba2 serve": count,
                "torch_serve_lm example": examples["torch_serve_lm"][name]}
            row["tensor_core_bound_ms"] = bound
            row["cuda_core_bound_ms"] = lm_times["k5_cuda_core_bound_ms"]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k4_time() -> int:
    """``--k4-time [--src DIR]``: K4 and Zamba2-2.7B's decode step through
    the ``repro_torch`` that ``--src`` names (this checkout's by default).
    At each serve decode shape in float32 and bfloat16, every slot valid
    at the last position: a call's host microseconds (:func:`_host_us`:
    100 calls issued without a wait, well inside the launch queue),
    its ms by CUDA events around calls issued back to back (phase 8's "ms
    per call": the host's time where that is the longer), the device ms
    of everything it launches queued behind a sleeping kernel, and its
    largest error against the plain version; in float32 also two
    yardsticks, queued the same way: the call at a cache of T / 32 and T
    / 4 slots (what does not scale with the cache), and ``k.clone();
    v.clone()``, which reads the cache once and writes it once (the
    card's rate for plain copies of those bytes). Then Zamba2-2.7B at full
    width (random weights, seed 0), 4 prompts of 1024 tokens, prefilled
    twice and each time followed by 31 greedy decode steps timed as phase
    7 times them (the step, its argmax and a wait for the card). Prints
    one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    _build.build()
    gen = torch.Generator(device=DEV).manual_seed(0)
    out = {"package": str(Path(repro_torch.__file__).resolve().parent)}
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, t, h, kh, d in (
                (SERVE_ARCH, SERVE_B, SERVE_S + SERVE_GEN, 32, 32, 80),
                (MOE_ARCH, MOE_B, MOE_S + MOE_GEN, 64, 4, 128)):
            q = _randn((b, 1, h, d), gen, dtype)
            k, v = (_randn((b, t, kh, d), gen, dtype) for _ in range(2))
            tags, idx = _tags(b, t, t - 1)
            call = lambda: decode_attention(q, k, v, tags, idx)
            want = ref.mha_reference(q, k, v, causal=True,
                                     q_offset=idx[:, None],
                                     kv_positions=tags)
            err = float((call().float() - want.float()).abs().max())
            row = out[f"K4 {label} {str(dtype)[6:]}"] = {
                "host_us": _host_us({"call": call}, 100)["call"],
                "ms": _time_ms(call, 100, 10),
                "queued_ms": _queued_ms(call, 100), "max_abs_err": err}
            if dtype == torch.float32:
                row["clone_kv_queued_ms"] = _queued_ms(
                    lambda: (k.clone(), v.clone()), 100)
                for cut in (32, 4):
                    ts, ix = _tags(b, t // cut, t // cut - 1)
                    ks, vs = k[:, :t // cut].contiguous(), \
                        v[:, :t // cut].contiguous()
                    row[f"queued_ms_at_t_{t // cut}"] = _queued_ms(
                        lambda: decode_attention(q, ks, vs, ts, ix), 100)
            del q, k, v, want
    cfg = ARCHS[SERVE_ARCH].replace(remat="none", param_dtype="float32",
                                    dtype="float32")
    model = build_model(cfg, device=DEV, kernels="cuda", seed=0)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)), device=DEV)
    steps = []
    for _ in range(2):
        logits, cache = model.prefill({"tokens": prompts},
                                      cache_len=SERVE_S + SERVE_GEN)
        tok = logits[:, -1:].argmax(-1)
        torch.cuda.synchronize()
        for _ in range(SERVE_GEN - 1):
            t1 = time.perf_counter()
            logits, cache = model.decode_step(cache, tok)
            tok = logits[:, -1:].argmax(-1)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t1) * 1e3)
    out[f"{SERVE_ARCH} decode step"] = {
        "median_ms": statistics.median(steps),
        "mean_ms": statistics.fmean(steps), "min_ms": min(steps),
        "steps": len(steps)}
    print(json.dumps(out))
    return 0


def _near_uniform(m: int, c: int, seed: int):
    """Soft labels of a model at random init: each row the softmax of
    logits N(0, 0.1^2), so the loop stops after its first sweep."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    soft = torch.softmax(0.1 * torch.randn((m, c), generator=gen,
                                           device="cuda"), dim=1)
    return soft, torch.full((m,), 64.0, device="cuda")


# the shapes of --k1-time below the paper's bound: K1's warp route
K1_WARP_SHAPES = ((10, 10), (4, 10), (3, 7), (16, 16), (32, 32))


def k1_time() -> int:
    """``--k1-time [--src DIR]``: K1 through the ``repro_torch`` that
    ``--src`` names (this checkout's by default). The loop at the paper's
    (10, 10) (phase 2's first inputs) and at the other K1_WARP_SHAPES
    (phase 2's inputs at those shapes), at (8, 152064) and (4, 152064)
    (soft labels of a model at random init: one iteration) and at (10,
    151936) (phase 5's inputs), and the sweep at (10, 10): a call's host
    microseconds (100 calls issued without a wait), its ms by CUDA events
    around calls back to back, the device ms of everything it launches
    queued behind a sleeping kernel, its iterations and its packed output
    as int32 bits. Prints one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch
    _build.build(("entropy_judge",))
    out = {"package": str(Path(repro_torch.__file__).resolve().parent)}
    cases = {f"loop {shape}": _loop_inputs(*shape, i)[:2]
             for i, shape in enumerate(K1_WARP_SHAPES)}
    cases.update({"loop (8, 152064)": _near_uniform(8, 152064, 1),
             "loop (4, 152064)": _near_uniform(4, 152064, 2),
             "loop (10, 151936)": _loop_inputs(10, 151936, 0)[:2]})
    for label, (soft, sizes) in cases.items():
        call = lambda: entropy_judge_loop(soft, sizes)
        packed = call()
        out[label] = {
            "host_us": _host_us({"call": call}, 100)["call"],
            "ms": _time_ms(call, 100, 10), "queued_ms": _queued_ms(call, 100),
            "iterations": _k1_loop_work(*soft.shape, packed)[2],
            "bits": packed.view(torch.int32).tolist()}
    soft, sizes, mask = _k1_inputs(10, 10, seed=0)
    call = lambda: entropy_judge_sweep(soft, sizes, mask)
    ent, loo = call()
    out["sweep (10, 10)"] = {
        "host_us": _host_us({"call": call}, 100)["call"],
        "ms": _time_ms(call, 100, 10), "queued_ms": _queued_ms(call, 100),
        "bits": torch.cat([ent[None], loo]).view(torch.int32).tolist()}
    print(json.dumps(out))
    return 0


def turns(other: str, mode: str) -> int:
    """``--k4-turns DIR`` (``mode`` "--k4-time", :func:`k4_time`) and
    ``--k1-turns DIR`` ("--k1-time", :func:`k1_time`): the timing run of
    this checkout's package and DIR's, in turns (this, DIR, DIR, this),
    each in a process of its own; prints each run's line as it comes and
    then one JSON line of all four with the card's name and power limit.
    For K1 it fails unless the warp route (K1_WARP_SHAPES) gives the same
    bits in all four runs."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    me = Path(__file__).resolve()
    srcs = {"this": str(me.parent / "src"),
            "other": str(Path(other).resolve() / "src")}
    runs = []
    for which in ("this", "other", "other", "this"):
        res = subprocess.run([sys.executable, str(me), mode, "--src",
                              srcs[which]], capture_output=True, text=True,
                             timeout=900)
        print(f"-- {which} ({srcs[which]}), exit {res.returncode}:\n"
              f"{res.stdout.strip()}", flush=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append({"which": which,
                     **json.loads(res.stdout.strip().splitlines()[-1])})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"card": smi, "turns": runs}))
    if mode == "--k1-time":
        for label in (k for k in runs[0] if k.startswith(("loop", "sweep"))):
            same = len({str(r[label]["bits"]) for r in runs}) == 1
            print(f"K1 {label}: packed output equal in all four runs: "
                  f"{same}")
            if label in {f"loop {s}" for s in K1_WARP_SHAPES} and not same:
                print(f"K1's warp route at {label} differs from DIR's bits",
                      file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    for flag, mode in (("--k4-turns", "--k4-time"),
                       ("--k1-turns", "--k1-time")):
        if flag in sys.argv[:-1]:
            sys.exit(turns(sys.argv[sys.argv.index(flag) + 1], mode))
    sys.exit(k4_time() if "--k4-time" in sys.argv else
             k1_time() if "--k1-time" in sys.argv else
             width_gap_main() if "--width-gap" in sys.argv else main())
