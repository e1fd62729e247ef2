#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``persia_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --ab ROOT OUT.npz     # K2, K4, K7-K9 of the tree ROOT
    python3 chip_smoke.py --ab-compare A.npz B.npz ...

(``--ab``: see ``ab_run``; it compares two trees' kernels, parent and
change, in one call.)

Phases, in order; any failure ends the run with a nonzero exit and no
result line:

1. build the port's CUDA kernels from ``persia_tpu_torch/csrc`` (nvcc,
   sm_90a); the flash-attention kernels' SASS must hold wgmma (HGMMA) and
   TMA loads (UTMALDG), the f32 one without spills; K5's kernels and the
   routing kernel on the dim-16 f32 path without spills; K6-K9's kernels
   (raw gather and its scatter-add, attention pool) and K2's two passes
   reported, K9 by template, K8 and K9 at the DIN path's template (2
   positions a lane) without spills;
2. flash_attention on the card vs its plain version (dense f32 softmax):
   the bf16 route (wgmma) and the f32 route (split TF32 on wgmma, its
   pre-pass held bit for bit to ``tf32_split_planes_reference``) at every
   head dim, ragged L=1000;
3. the DLRM kernels on the card vs their plain versions, at the bench
   shape and at edge shapes: the dot interaction and its backward, the
   grouped gather-pool forward and backward (zipf(1.2) ids at the bench
   shape, all positions on one row, a segment ending on a chunk edge, L=4,
   counts, f32 rows of dim 8, 24 and 10, a group of 70 slots), the
   backward's bitwise determinism and, without counts, its sums bit for
   bit against ``plans.pool_bwd_model`` (its own order, in numpy);
   (3b) the fused tier's kernels: K4 ``fused_gather`` bit for bit against
   its plain version, with and without the update keys it writes for the
   step, and those keys bit for bit the plain routing
   (``update_keys_reference``) (stacked at the bench shape on uniform and
   zipf(1.2) ids with pads, ids at the vocab's last row, past it and far
   past it, a bf16 table with a pooled (B, 5) slot, unstacked with NaN
   rows, dim 10), the standalone routing of the update ids (``update_keys``,
   the graph step's warm-up) bit for bit against its plain version (26 slots of
   B=4096 with pads, ids past the vocab and ids < -1; 130 slots, two
   launches), K5 ``sparse_update`` bit for bit against its plain version on
   the CPU (SGD, Adagrad, Adagrad vectorwise, all with weight decay, and
   Adam, on uniform, zipf(1.2) and one-row streams with pads, on hot
   segments (762, 318, 180 positions and the long threshold - 1, at it and
   + 1) and on segments ending on a staged tile's edge; the bench's 26
   stacked tables with Adagrad(0.05); a bf16 table), each case's longest
   segment printed;
   (3c) the DIN path's kernels at its shape (B=1024, L=50, dim 16, two raw
   slots of 26,000 and 9,000 distinct rows), both dtypes: K6
   ``raw_gather_fwd`` bit for bit; K7 ``raw_gather_bwd`` within twice the
   f32 sum-order bound and one rounding of its plain version (index_add_),
   bit for bit twice and against its schedule (``plans.raw_bwd_model``),
   on Taobao-length histories with an empty and a full one (where no row
   is long: also bit for bit its plain version run on the CPU) and on
   every position on one row (long rows), the pad row zero; K8
   ``attention_pool_fwd``
   (weights to 1e-6, the pooled rows inside their f64 envelope: an f32 sum
   in any order, then one rounding) and K9 ``attention_pool_bwd`` (d_hist
   bit for bit, d_logits inside its envelope), kernel and plain version
   alike, nothing at masked positions or on the empty row, no NaN; K8 and
   K9 again at their edges (``ATT_EDGE_CASES``: every template, a lane
   group walking past kAhead, the scalar path) on random masks;
   (3d) DNN's batch norm, K10 (train mode and the running statistics) and
   K11, at the DNN paths' shapes (``BN_CASES``: B=4096 and 256 by C=128
   and 32, B=128 by C=64 and 16), at one row (y = bias), at C=10, in f32
   and over unequal row spans of a cluster (B=2049, 4100): y and dx
   within one ulp of the dtype plus 1e-5 of the column's scale, the
   statistics and the parameters' gradients within 1e-5 of the
   plain versions on the card; bit for bit their schedules
   (``batch_norm_*_schedule``: the plain versions with the kernels' sum
   order) on the CPU and bit for bit twice; eval mode moves nothing;
4. the paths, each with the launch counts set to 0 just before and read
   just after: (a) the flash-attention entry point at (B=4, L=1024, H=8,
   D=64) in bf16 and in f32, causal and not, and its backward (a dense
   recompute that launches no kernel) against the CPU port's; (b) the
   serving slice at bench width — DLRM (13 dense features, 26 single-id
   slots of dim 16, bottom (256, 64, 16), top (512, 256)) behind
   ``InferenceEngine(InferCtx(...))`` on the native store and worker cores,
   answering 5 requests of B=4096 zipf ids through ``predict_from_bytes``,
   held against the same engine on the CPU over the numpy store; (c) the
   training slice at the same width — ``TrainCtx(...).train_step`` with
   device pooling, a bf16 wire, sparse Adagrad(0.05) on the native store and
   Adam(1e-3) on the dense tower: 2 warm-up and 8 measured steps, then 5
   steps stage by stage, its first 3 losses and its PS rows held against
   the same steps on the CPU over the numpy store; (d) the pipelined
   training path at the same width and the bench's settings —
   ``DataLoader(num_workers=4, staleness=4)`` and
   ``TrainCtx.train_step_prepared(..., fetch_metrics=False)`` over 32
   batches after 2 synchronous warm-up steps, the window whole after
   ``flush``, and 4 batches with ``reproducible=True, staleness=1`` held to
   ``train_step`` on the same batches. Phases 4b-4d fail unless the native
   cores build (``g++``) and serve them: no numpy fallback; (e) the fused
   all-on-card tier at the bench's configuration (``bench.py:100-221``: 26
   stacked tables of 1M x 16 f32 with their Adagrad(0.05) state on the
   card, Adam(1e-3), B=4096, uniform ids): the CUDA-graph step held bit for
   bit to the eager step over 5 steps from one state, its first 3 losses,
   the rows they touched and what the steps changed in them held to the
   CPU port's from a copy of the state, the graph step's capture counted
   (its warm-up and the capture: K4 and K5 twice, ``update_keys`` once,
   in the warm-up), 100 timed graph steps, synced
   steps, 100 eager steps (the counted run: a graph replay goes through no
   wrapper; K4, which routes the update ids, and K5 once a step,
   ``update_keys`` never), a zipf(1.2) stream, the
   card's busy time a graph step and its kernels' runs from the device
   trace (K4 and K5's three kernels once a step, the routing kernel
   never), beside the same with the update ids routed by the standalone
   kernel after K4 without keys (in turns: new, standalone, new; card busy,
   PyTorch elementwise kernels and kernel runs a step), and
   ``FusedTrainCtx.train_pipelined`` (depth 2) over
   32 batches; (f) durable state on the hybrid tier at the training path's
   width and settings (native store 2^25, 64 shards): (a) an uninterrupted
   run of 12 ``train_step``s after a cold ``resume``, ``snapshot_job``
   every 4 (each snapshot's PS capture, dense bytes and commit timed);
   a second run on fresh stores, snapshots at 4 and 8, abandoned after
   step 9; fresh stores and ctx ``resume(restore_ps=True)`` from the fence
   at 8 (timed) and replay steps 9-12 (the counted run: K0, K3, K1, K2 4
   times each): the dense state's flax bytes byte-equal and every PS
   shard's dump byte-equal to the uninterrupted run's, or the phase fails
   naming what differs; (b) ``resume(restore_ps=False)`` over the crashed
   run's store: the replayed step moves no entry, ``journal_skips`` at
   least 1 a replayed step; (c) ``EmbeddingWorker.dump`` of one replica
   and ``load`` into two (timed): each replica holds its own signs, their
   union the dump's entries; (d) the port's manifest read back, beside the
   reference's (``tests/fixtures/jax_train_ctx_manifest``): every blob's
   crc, the same layout, its dense state loaded into a DLRM on the card
   and its shards into native stores, both written back byte-equal; one
   snapshot and one rewind resume of the store filled to a quarter of its
   capacity with synthetic rows (ms a MiB; the restored dumps and dense
   bytes equal to the snapshot's); and the journal's host cost, the step's
   samples/s armed and not (96 steps a side in turns, the mean difference
   with its standard error, ``payload_crc`` timed); (g) DIN on Taobao at
   ``examples/taobao_din/train.py``'s width (B=1024, 50-long histories,
   dim 16, the items and cates feature groups, DIN attention (36,), top
   (200, 80), Adagrad(0.05) on two native-store replicas of 2^20 rows and
   16 shards, Adam(1e-3), the f32 wire, ``TaobaoSynthetic(seed=42)`` at its
   default vocabularies): 3 reproducible staleness-1 loader steps held to
   ``train_step`` on the CPU over numpy stores (losses 2e-2, PS rows
   1e-2), then 16 batches through ``DataLoader(num_workers=4,
   staleness=4)`` + ``train_step_prepared`` (the counted run: K6 and K7
   once a step, K8 and K9 once a raw slot), stage p50s, the card's busy
   time a step, the held-out AUC over 4 batches (not gated); (h) the
   trained dense state as flax's bytes loaded into a DIN behind
   ``InferenceEngine(InferCtx(...))``, 5 requests of B=1024 through
   ``predict_from_bytes`` held to the same weights on the CPU (2e-2; K6
   once, K8 twice a request); (i) DeepFM and DCN-v2 (3 cross layers) on
   Avazu at ``examples/avazu/train.py``'s width (21 fields of dim 16, deep
   (256, 128), B=4096): 8 ``TrainCtx.train_step``s each, the first 3
   losses held to the CPU port (2e-2), no kernel of the port launched
   (host pooling); (j) DNN with its batch statistics: (a) the adult-income
   example's exact configuration (``persia_tpu_torch.testing.adult_income``,
   from the reference's initial weights) for its 4 epochs on the card and
   on the CPU, each epoch's loss and AUC printed, the final AUC of both
   within 5e-3 of the example's pinned ``REPRODUCIBLE_AUC`` (the
   difference printed, and the first step whose loss leaves the CPU's by
   2e-2), K10 and K11 only (host pooling); (b) DNN at the serving bench's
   width (8 zipf(1.2) slots of dim 16 over 100,000 ids, 8 dense features,
   DNN(32, 128, (128, 64)), native store 2^18 / 4 shards, Adagrad(0.1),
   Adam(3e-3)) with device pooling: 2 + 8 ``train_step``s of B=4096 (the
   counted run: K1 and K2 once a step, K10 and K11 twice), the losses
   within 2e-2, ``batch_stats`` within 1e-2 and 99 % of the touched PS
   rows within 1e-2 (their Adagrad accumulators within 1e-2 of
   themselves; every row within 5e-2 and 0.1) of the CPU port over the
   numpy store (after the first step, from the same state: the rows within
   1e-2 and their accumulators within 1e-2 of themselves), the five widest
   rows with the steps that touched them, and the witness: the same steps
   in f32 compute, card against CPU after the first step (losses and
   statistics within 1e-5, rows and accumulators within twice the gaps
   the first batch with its samples permuted makes on each device, and at
   least 1e-4 and 1e-3), and
   after the first and the last beside the card against itself
   from Dense_2's kernel moved by one ulp (how far training grows a
   rounding-sized difference), samples/s, step p50 and the card's busy
   ms a step; then the trained state's flax bytes loaded into a bare DNN
   (``model_from_flax_bytes``) behind ``InferenceEngine(InferCtx(...))``,
   5 requests of B=256 (K1 once, K10 twice in eval mode a request) within
   2e-2 of the CPU engine, their p50; (c) kill and resume at
   ``bench.py:936-960``'s configuration on the card: the rewind resume bit
   for bit the uninterrupted run (dense bytes with ``batch_stats``, every
   PS shard), the journal resume skipping the replayed window,
   ``time_to_resume_s`` of both;
5. timings of each kernel beside its plain version, the library call that
   computes the same function, and the card's bound, each by CUDA-graph
   replay (host enqueue cost out of the number; eager times beside them):
   flash attention per route and mask (the f32 route's pre-pass also on
   its own), the name of the kernel SDPA runs for f32 (torch.profiler),
   the dot interaction and its backward, the gather-pool forward and
   backward at the training path's own inputs, warm and also cold (inputs
   rotated through more than the 50 MB L2, one copy per captured call,
   beside their library calls); the serving latency and throughput; the
   training throughput and stage breakdown; K4 (with the update keys, as
   the step calls it, and without them, in turns) and K5 at the fused path's
   inputs, warm and cold (fresh batches rotated over the 1.66 GB table;
   K5 on uniform and zipf(1.2) ids with the longest segment printed, each
   of its steps apart (torch.profiler), ``torch.sort``'s time beside it,
   and every position on one row); the standalone routing pass against its
   bound and its plain version, ``torch.sort`` beside both; K6-K9 at the DIN path's
   own step (K6 beside ``torch.index_select``, K7 beside ``index_add_``
   with their ratio, the longest segments, every position on one row and
   its kernels a call in the device trace, K8 beside the softmax + bmm
   composite, K9's registers and its kernels in the device trace), warm
   and cold; the one-launch floor (a one-element ``add_``, twice), the
   standalone routing pass's time over it, and the routing's cost inside
   K4 (K4 with keys − K4 without); K10 and K11 at the DNN training path's
   first batch norm (B=4096, C=128, bf16; C=32 and the B=256 eval mode
   beside), warm and cold, beside ``F.batch_norm`` and aten's
   ``native_batch_norm_backward``;
   and (5b) the flash-attention backward, a dense recompute, beside SDPA's
   backward.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

# the card's published peaks (H100 SXM data sheet, dense): HBM bytes/s and
# operations/s by type (float32: the FMA pipes; tf32: the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}

BATCH, N_DENSE, N_SLOTS, EMB_DIM, VOCAB = 4096, 13, 26, 16, 1_000_000
BOTTOM, TOP = (256, 64, EMB_DIM), (512, 256)
REQUESTS, WARM_BATCHES, SEED = 5, 8, 0
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_STAGED, TRAIN_CPU_STEPS = 2, 8, 5, 3
PIPE_WORKERS, PIPE_STALENESS, PIPE_BATCHES, PIPE_PROFILED, PIPE_REPRO = 4, 4, 32, 8, 4
# (lookup threads, variant): "serial_stage" lets one thread stage at a time,
# "switch_0.5ms" runs the interpreter's thread switch interval at 0.5 ms
PIPE_SWEEP = ((1, None), (2, None), (4, None), (4, "serial_stage"), (4, "switch_0.5ms"))
PIPE_SWEEP_BATCHES = 16
# phase 4f: the uninterrupted run's steps, the snapshot interval, the step
# the crashed run dies after, and the steps of each side of the journal's
# cost (armed and not, in turns)
DUR_STEPS, DUR_EVERY, DUR_KILL, JOURNAL_COST_STEPS = 12, 4, 9, 96
# phase 4f's store at a stated fill: synthetic rows loaded into the bench
# store (a quarter of its 2^25-row capacity) before one snapshot and one
# rewind resume
DUR_FILL_ROWS = 1 << 23
# job directories and the checkpoint of phase 4f (inside the checkout,
# ignored by git, removed when the phase ends)
STATE_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_state"
# a job directory the reference's TrainCtx wrote (tests/test_torch_resume.py
# writes it): DLRM of the flagship's shape, two replicas of 4 shards
FIXTURE_DIR = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_train_ctx_manifest"
FIXTURE_MODEL = dict(num_slots=5, bottom_mlp=(32, 16), top_mlp=(64, 32))
# phases 3c and 4g-4h: DIN on Taobao at examples/taobao_din/train.py's
# width (B, the history length, dim, the attention unit and the top MLP);
# the reproducible steps held to the CPU, the counted loader's batches, the
# held-out batches, the profiled steps and the serving requests
DIN_BATCH, DIN_HIST, DIN_DIM, DIN_ATT, DIN_TOP = 1024, 50, 16, (36,), (200, 80)
DIN_REPRO, DIN_BATCHES, DIN_EVAL, DIN_PROFILED, DIN_REQUESTS = 3, 16, 4, 4, 5
DIN_KERNELS = ("raw_gather_fwd", "raw_gather_bwd", "attention_pool_fwd", "attention_pool_bwd")
RAW_SOURCE, RAW_REPLACES = "persia_tpu_torch/csrc/raw_gather.cu", "persia_tpu/parallel/train_step.py:90"
ATT_SOURCE, ATT_REPLACES = "persia_tpu_torch/csrc/attention_pool.cu", "persia_tpu/models/din.py:67"
# K8/K9's template at the DIN path's shape (bf16, 16-byte vectors, 2
# positions a lane), and the kernels' edge cases (B, L, dim) that phase 3c
# and --ab add: positions a lane (L <= 32, 64, 256, 1536: 1, 2, 8, 48; past
# 256 K9's g goes through shared memory), a lane group walking more than
# kAhead positions (L = 200), the scalar path (dim 10)
ATT_DIN_TEMPLATE = "bf16,8,2"
ATT_EDGE_CASES = [(37, l, 16) for l in (32, 33, 64, 65, 200, 256, 257, 1536)] + [(37, 200, 10)]
# phase 4i: DeepFM and DCN-v2 on Avazu at examples/avazu/train.py's width
AVAZU_FIELDS, AVAZU_BATCH, AVAZU_STEPS, AVAZU_CPU_STEPS, AVAZU_DEEP = 21, 4096, 8, 3, (256, 128)
# phases 3d and 4j: DNN with its batch norms (K10, K11). (b) DNN at the
# serving bench's width (benchmarks/serving_bench.py:37-68): 8 slots of dim
# 16 over 100,000 ids, zipf(1.2), 8 dense features, DNN(32, 128, (128, 64)),
# device pooling; its warm-up and timed steps, the steps held to the CPU,
# the serving requests and their batch. (c) bench.py:936-960's kill and
# resume: DNN(8, 16, (32,)), 2 slots, B=64, 12 steps, a snapshot every 4,
# killed after 9
DNN_SLOTS, DNN_DIM, DNN_VOCAB, DNN_DENSE, DNN_MLP = 8, 16, 100_000, 8, (32, 128, (128, 64))
DNN_WARM, DNN_STEPS, DNN_CPU_STEPS, DNN_REQUESTS, DNN_SERVE_BATCH = 2, 8, 10, 5, 256
DNN_RESUME = dict(steps=12, every=4, kill=9, batch=64)
BN_SOURCE, BN_REPLACES = "persia_tpu_torch/csrc/batch_norm.cu", "persia_tpu/models/dnn.py:39"
BN_KERNELS = ("batch_norm_fwd", "batch_norm_bwd")
# phase 3d's cases (B, C, dtype): the DNN paths' own shapes (serving-bench
# width: B=4096 training, B=256 serving, C=128 and 32; adult income: B=128,
# C=64 and 16), one row (flax's variance 0), C not a multiple of 8, f32,
# rows split over a cluster into spans of unequal length (2049, 4100)
BN_CASES = [(4096, 128, "bfloat16"), (4096, 32, "bfloat16"), (256, 128, "bfloat16"), (256, 32, "bfloat16"),
            (128, 64, "bfloat16"), (128, 16, "bfloat16"), (1, 10, "bfloat16"), (37, 10, "bfloat16"),
            (2049, 128, "bfloat16"), (4100, 10, "bfloat16"), (4096, 128, "float32"), (1, 10, "float32"),
            (37, 10, "float32"), (4100, 10, "float32")]
FA_SOURCE = {"wgmma_bf16": "persia_tpu_torch/csrc/flash_attention_hopper.cu",
             "tf32x3": "persia_tpu_torch/csrc/flash_attention_tf32.cu"}
FA_REPLACES = "persia_tpu/ops/flash_attention.py:107"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_envelope(name, out, ref, envelope, ref_envelope) -> float:
    """Fail unless the kernel's ``out`` lies inside its f64 ``envelope``
    (lo, hi) and the plain version's ``ref`` inside ``ref_envelope``;
    returns the max abs error of out against ref."""
    import torch

    from persia_tpu_torch.testing.envelopes import outside

    bad, bad_ref = outside(out, envelope), outside(ref, ref_envelope)
    max_err = float((out.float() - ref.float()).abs().max())
    width = float((envelope[1] - envelope[0]).max())
    straddle = int((envelope[1] != envelope[0]).sum())
    ok = bool(torch.isfinite(out).all()) and bad == 0 and bad_ref == 0
    print(f"  {name}: max_abs_err={max_err:.3e}; outside the envelope: kernel {bad}, plain {bad_ref} of "
          f"{out.numel()} (envelope widest {width:.3e}, {straddle} not one value) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    return max_err


def check_close(name, out, ref, rtol, atol, base=None) -> float:
    """Fail unless |out - ref| <= atol + rtol * |ref| everywhere (in f32);
    returns the max abs error. ``base``, a tighter (rtol, atol), is only
    reported: how many elements exceed it and by what factor at most."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    max_err = float(err.max())
    atol_shown = float(atol.max()) if torch.is_tensor(atol) else atol
    ok = bool(torch.isfinite(out).all()) and bool((err <= atol + rtol * ref.abs()).all())
    extra = ""
    if base is not None:
        ratio = err / (base[1] + base[0] * ref.abs())
        extra = (f" [beyond rtol {base[0]:g} atol {base[1]:g}: {int((ratio > 1).sum())} of "
                 f"{ratio.numel()}, at most {float(ratio.max()):.2f}x]")
    print(f"  {name}: max_abs_err={max_err:.3e} tolerance=atol {atol_shown:.4g} + rtol {rtol:g}*|ref| "
          f"{'ok' if ok else 'FAIL'}{extra}", flush=True)
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    return max_err


def eager_ms(fn, iters=50, warmup=5) -> float:
    """Mean time of one eager call, by CUDA events around ``iters`` calls.
    Where a call's kernel is shorter than its host-side enqueue, this
    measures the host, not the card."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20, replays=10, warmup=3) -> float:
    """Mean device time of one call with the host out of the loop: ``calls``
    calls captured into one CUDA graph, the graph replayed ``replays``
    times between two events. A call that cannot be captured raises."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (builds, allocator) off the capture
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    torch.cuda.synchronize()
    return ms


def timings(fn, calls=20, eager_iters=50) -> dict:
    """Graph-replayed ms (the number every comparison uses) and eager ms."""
    return {"graph": graph_ms(fn, calls=calls), "eager": eager_ms(fn, iters=eager_iters)}


COLD_BYTES = 72e6  # rotated input copies per cold timing: more than the 50 MB L2


def cold_ms(fn, make_copy, nbytes: int) -> dict:
    """Graph-replayed ms of ``fn(*inputs)`` with the inputs cold in L2:
    copies from ``make_copy()`` (>= 8 of them, > COLD_BYTES in all), one per
    captured call in turn, so a copy is reused only after the others have
    passed through the cache."""
    import itertools

    n = max(8, -(-int(COLD_BYTES) // nbytes))
    copies = [make_copy() for _ in range(n)]
    it = itertools.cycle(copies)
    ms = graph_ms(lambda: fn(*next(it)), calls=n, replays=5)
    return {"ms": ms, "copies": n, "bytes_per_copy": nbytes}


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def zipf_ids(rng, n, vocab, offset, a=1.2):
    """Rank-skewed ids with a fixed per-slot shift (the bench's stream)."""
    raw = rng.zipf(a, n).astype(np.uint64)
    return (raw + np.uint64(offset)) % np.uint64(vocab)


def zipf_batch_maker(seed, labels=False):
    """The bench's batches: zipf ids per slot, normal dense features and,
    for training, 0/1 labels."""
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch

    rng = np.random.default_rng(seed)
    offsets = rng.integers(0, VOCAB, N_SLOTS, dtype=np.uint64)

    def make():
        ids = [
            IDTypeFeatureWithSingleID(f"cat_{i}", zipf_ids(rng, BATCH, VOCAB, offsets[i]))
            for i in range(N_SLOTS)
        ]
        dense = rng.normal(size=(BATCH, N_DENSE)).astype(np.float32)
        if not labels:
            return PersiaBatch(ids, non_id_type_features=[NonIDTypeFeature(dense)], requires_grad=False)
        y = [Label(rng.integers(0, 2, (BATCH, 1)).astype(np.float32))]
        return PersiaBatch(ids, non_id_type_features=[NonIDTypeFeature(dense)], labels=y, requires_grad=True)

    return make


def device_busy_ms(step, batches):
    """Kernel time per call of ``step`` summed by torch.profiler over the
    device's own events (kernels and copies; user annotations such as the
    optimizer's range, which span kernels, are left out), the largest
    ones (names cut to 80 chars), and how many times each of the port's
    kernels (``KERNEL_NAMES``) ran in all: the device's own count, which a
    CUDA graph's replays (which go through no wrapper) also show; under
    "elementwise", the runs of PyTorch's elementwise kernels; under
    "replays", one entry a ``cudaGraphLaunch`` in the trace: the runs of
    each of those kernels that carry its correlation id, and under
    "events" all its device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(b)
        torch.cuda.synchronize()
    per = {}
    runs = dict.fromkeys(KERNEL_NAMES + ("elementwise",), 0)
    replays = {e.id: dict.fromkeys(KERNEL_NAMES + ("events",), 0) for e in prof.events()
               if e.device_type == DeviceType.CPU and e.name.startswith("cudaGraphLaunch")}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        per[e.name[:80]] = per.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3 / len(batches)
        replay = replays.get(e.id)
        if replay is not None:
            replay["events"] += 1
        for k in KERNEL_NAMES:
            if re.search(rf"\b{k}\b", e.name):
                runs[k] += 1
                if replay is not None:
                    replay[k] += 1
        runs["elementwise"] += "elementwise_kernel" in e.name
    runs["replays"] = list(replays.values())
    if not sum(per.values()):
        return None, {}, runs
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:8])
    return sum(per.values()), top, runs


KERNEL_NAMES = ("fa_fwd_wgmma_kernel", "fa_fwd_tf32x3_kernel", "tf32_split_kernel",
                "dot_interaction_mma_kernel", "dot_interaction_kernel",
                "dot_interaction_bwd_mma_kernel", "dot_interaction_bwd_kernel",
                "gather_pool_fwd_kernel", "segment_sum_chunks_kernel", "segment_sum_rows_kernel",
                "fused_gather_kernel", "update_keys_kernel", "sparse_update_segments_kernel",
                "sparse_update_long_kernel", "sparse_update_short_kernel",
                "raw_gather_fwd_kernel", "raw_gather_bwd_kernel", "attention_pool_fwd_kernel",
                "attention_pool_bwd_kernel", "batch_norm_fwd_kernel", "batch_norm_bwd_kernel")
# the DIN path's kernels (K6-K9) and K2's two passes
DIN_KERNEL_NAMES = ("raw_gather_fwd_kernel", "raw_gather_bwd_kernel", "attention_pool_fwd_kernel",
                    "attention_pool_bwd_kernel")
K2_KERNEL_NAMES = ("segment_sum_chunks_kernel", "segment_sum_rows_kernel")
# K5's kernels, and the routing's: on the dim-16 f32 path none may spill
K5_KERNELS = ("sparse_update_segments_kernel", "sparse_update_long_kernel", "sparse_update_short_kernel")
K5_DIM16 = ("sparse_update_segments_kernel", "sparse_update_long_kernel<f32,4>",
            "sparse_update_short_kernel<f32,4,1>", "update_keys_kernel")
# SASS counted per kernel: Hopper's matrix and TMA instructions, and the
# 16-byte global loads and stores (and the shuffles) of the gather-pool
SASS_OPS = {"HGMMA": r"\bHGMMA\b", "UTMALDG": r"\bUTMALDG\b", "UTMASTG": r"\bUTMASTG\b",
            "HMMA": r"\bHMMA\b", "LDG.128": r"\bLDG\.E\.128\b", "STG.128": r"\bSTG\.E\.128\b",
            "STG.64": r"\bSTG\.E\.64\b", "SHFL": r"\bSHFL\."}
DOT_REPLACES = "persia_tpu/models/dlrm.py:50"
POOL_REPLACES = "persia_tpu/parallel/train_step.py:81"


def _template_arg(t) -> str:
    tok = t.group(0)
    if tok.startswith("13"):
        return "bf16"
    if t.group(1):
        return t.group(1)
    if t.group(2):
        return "true" if t.group(2) == "1" else "false"
    if t.group(3):
        return f"uint{t.group(3)}"
    return {"f": "f32", "j": "u32", "t": "u16"}.get(tok, "same")  # S<n>_: a type repeated


def kernel_label(mangled: str):
    """'fa_fwd_wgmma_kernel<64>' from a mangled kernel name (a kernel that
    is no template: its name alone), or None."""
    for name in KERNEL_NAMES:
        if name + "I" in mangled:
            args = mangled.split(name + "I", 1)[1].split("EEv", 1)[0]
            tokens = re.finditer(r"13__nv_bfloat16|Li(\d+)E|Lb([01])E|5uint([24])|S\d*_|f|j|t", args)
            return f"{name}<{','.join(map(_template_arg, tokens)) or args}>"
    for name in KERNEL_NAMES:
        if f"{len(name)}{name}" in mangled:
            return name
    return None


def build_summary(build_log: str, library) -> dict:
    """Per kernel: ptxas registers, static shared memory and spill bytes
    (from the build's -Xptxas -v), and counts of the instructions of
    SASS_OPS in its SASS (cuobjdump -sass on the built library)."""
    out, current = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = kernel_label(m.group(1))
            if current:
                out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            out[current]["registers"] = int(m.group(1))
            out[current]["static_smem_bytes"] = int(m.group(2) or 0)
    sass = subprocess.run(["cuobjdump", "-sass", str(library)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = kernel_label(line.split("Function :", 1)[1].strip())
            continue
        if current:
            for op, pattern in SASS_OPS.items():
                if re.search(pattern, line):
                    counts = out.setdefault(current, {}).setdefault("sass", {})
                    counts[op] = counts.get(op, 0) + 1
    return out


def phase_build():
    from persia_tpu_torch.ops import _kernels

    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    _kernels.library()
    print(f"  built {_kernels.library_path().name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_kernels.build_seconds:.1f} s)", flush=True)
    if not _kernels.build_log:
        print("  (library built before this run: no ptxas report, SASS counts only)", flush=True)
    summary = build_summary(_kernels.build_log, _kernels.library_path())
    for name, info in summary.items():
        print(f"  {name}: {json.dumps(info)}", flush=True)
    for kernel in ("fa_fwd_wgmma_kernel<64>", "fa_fwd_tf32x3_kernel<64>"):
        fa = summary.get(kernel, {}).get("sass", {})
        if not (fa.get("HGMMA") and fa.get("UTMALDG")):
            raise SystemExit(f"{kernel}'s SASS lacks HGMMA or UTMALDG: {fa}")
    spills = {k: v["spill_bytes"] for k, v in summary.items()
              if k.startswith("fa_fwd_tf32x3_kernel") and v.get("spill_bytes")}
    if spills:
        raise SystemExit(f"the f32 flash-attention kernel spills: {spills}")
    if _kernels.build_log:
        din = {k: v for k, v in summary.items() if k.split("<")[0] in DIN_KERNEL_NAMES}
        print(f"  K6-K9 (raw gather and its scatter-add, attention pool): {json.dumps(din)}", flush=True)
        k2 = {k: v for k, v in summary.items() if k.split("<")[0] in K2_KERNEL_NAMES}
        print(f"  K2 (the gather-pool's two-pass segment sum): {json.dumps(k2)}", flush=True)
        missing = [n for n in DIN_KERNEL_NAMES + K2_KERNEL_NAMES if not any(k.split("<")[0] == n for k in summary)]
        if missing:
            raise SystemExit(f"the build reported nothing for {missing}")
        k9 = {k: (v.get("registers"), v.get("spill_bytes")) for k, v in summary.items()
              if k.startswith("attention_pool_bwd_kernel<")}
        print(f"  K9 by template (registers, spill bytes): {k9}", flush=True)
        k4 = {k: (v.get("registers"), v.get("spill_bytes")) for k, v in summary.items()
              if k.startswith("fused_gather_kernel<")}
        print(f"  K4 by vector (registers, spill bytes): {k4}", flush=True)
        din_path = {f"{n}<{t}>": summary.get(f"{n}<{t}>", {}).get("spill_bytes")
                    for n in ("attention_pool_fwd_kernel", "attention_pool_bwd_kernel")
                    for t in (ATT_DIN_TEMPLATE, "f32,4,2")}
        print(f"  K8 and K9 on the DIN path, spill bytes: {din_path}", flush=True)
        if any(v is None or v for v in din_path.values()):
            raise SystemExit(f"K8 or K9 spills on the DIN path or was not reported: {din_path}")
        bn = {k: (v.get("registers"), v.get("spill_bytes")) for k, v in summary.items()
              if k.startswith(("batch_norm_fwd_kernel<", "batch_norm_bwd_kernel<"))}
        print(f"  K10 and K11 by template (registers, spill bytes): {bn}", flush=True)
        if not {"batch_norm_fwd_kernel<bf16,8>", "batch_norm_bwd_kernel<bf16,8>"} <= set(bn):
            raise SystemExit(f"the build reported nothing for K10 or K11 at the DNN path's template: {bn}")
        k5 = {k: summary.get(k, {}).get("spill_bytes") for k in K5_DIM16}
        print(f"  K5 and the routing on the dim-16 path, spill bytes: {k5}", flush=True)
        if any(v is None or v for v in k5.values()):
            raise SystemExit(f"K5's dim-16 path spills or was not reported: {k5}")
    return summary


def phase_flash_attention(dev):
    import torch

    from persia_tpu_torch.ops import flash_attention, tf32_split_planes
    from persia_tpu_torch.ops.flash_attention import (
        reference_attention, route_tolerance, tf32_split_planes_reference,
    )

    print("== phase 2: flash_attention vs reference_attention", flush=True)
    # tolerances and their reasons: ops/flash_attention.py::route_tolerance
    dtypes = (torch.bfloat16, torch.float32)
    cases = [
        ((4, 1024, 8, 64), dtype, causal) for dtype in dtypes for causal in (False, True)
    ] + [
        ((4, 1000, 8, 64), dtype, True) for dtype in dtypes
    ] + [
        ((2, 1000, 4, d), dtype, causal)
        for d in (16, 32, 128) for dtype in dtypes for causal in (False, True)
    ]
    g = torch.Generator(device="cpu").manual_seed(SEED)
    errs = {}
    # the f32 route's pre-pass: its planes equal the plain version's bit
    # for bit (the rounding is cvt.rna.tf32's)
    for shape in ((4, 1024, 8, 64), (2, 1000, 4, 16), (2, 1000, 4, 128)):
        q, k, v = (torch.randn(shape, generator=g).to(dev) for _ in range(3))
        planes = tf32_split_planes(q, k, v)
        torch.cuda.synchronize()
        ref = tf32_split_planes_reference(q, k, v)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(planes, ref))
        err = max(float((a - b).abs().max()) for a, b in zip(planes, ref))
        print(f"  tf32_split_planes{list(shape)}: bitwise {'ok' if same else 'FAIL'} "
              f"(max_abs_err={err:.3e})", flush=True)
        if not same:
            raise SystemExit("tf32_split_planes disagrees with its plain version")
        errs.setdefault("tf32_split_planes", err)
    for shape, dtype, causal in cases:
        q, k, v = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(3))
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v, causal=causal)
        name = f"flash_attention{list(shape)} {str(dtype)[6:]} causal={causal}"
        # reported beside it: bf16 held without the P-rounding term of its atol
        base = (2 ** -7, 1e-3) if dtype == torch.bfloat16 else None
        errs[(shape, dtype, causal)] = check_close(name, out, ref, *route_tolerance(v), base=base)
    return {"bf16": errs[((4, 1024, 8, 64), torch.bfloat16, False)],
            "f32": errs[((4, 1024, 8, 64), torch.float32, False)],
            "tf32_split_planes": errs["tf32_split_planes"]}


def pool_ids(rng, batch, L, d, ids):
    """(batch, L) row ids in [0, d): "clipped", zipf(1.2) ranks clipped at
    d - 1 (a pile on the last row); "zipf", the
    ranks mod d (the hottest row ~18 % of the positions); "one_row", every
    id on row 0; "edge", row 0 takes exactly 64 positions and row 1 the
    next 128, so both end on an edge of 64-position chunks (the rest zipf)."""
    z = rng.zipf(1.2, (batch, L)) - 1
    if ids == "clipped":
        return np.minimum(z, d - 1)
    if ids == "zipf":
        return z % d
    if ids == "one_row":
        return np.zeros((batch, L), np.int64)
    flat = np.concatenate([np.zeros(64), np.ones(128), 2 + z.reshape(-1)[192:] % (d - 2)])
    return rng.permutation(flat).reshape(batch, L).astype(np.int64)


def pool_inputs(dev, dtype, batch, specs, seed, dim=EMB_DIM, ids="clipped"):
    """A group of device-pooled slots as the staging gives them: rows padded
    to one P with zero rows past D, pads indexing row D, the CSR. ``specs``
    is [(distinct D, ids per sample L, counts?)]; ``ids`` as pool_ids."""
    import torch

    from persia_tpu_torch.ops import PoolSlot
    from persia_tpu_torch.ops.embedding_pool import pool_csr

    rng = np.random.default_rng(seed)
    p = max(d for d, _, _ in specs) + 1
    rows, slots = [], []
    for d, L, with_counts in specs:
        r = np.zeros((p, dim), np.float32)
        r[:d] = rng.standard_normal((d, dim))
        counts = rng.integers(0 if L > 1 else 1, L + 1, batch).astype(np.int32)
        index = np.full((batch, L), d, np.int32)
        keep = np.arange(L)[None, :] < counts[:, None]
        index[keep] = pool_ids(rng, batch, L, d, ids)[keep]
        order, offsets = pool_csr(index, p)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        rows.append(t(r).to(dtype))
        slots.append(PoolSlot(t(index), t(counts.reshape(-1, 1)) if with_counts else None,
                              t(order), t(offsets)))
    return rows, slots


def pool_schedule_bits(grad, slots, num_rows, dim):
    """What the backward kernel must give for slots without counts, by
    ``plans.pool_bwd_model`` (its f32 sums in its own order): a list of
    (P, dim) f32 arrays."""
    from persia_tpu_torch.ops import plans

    out = []
    g = grad.cpu().numpy()
    for s, slot in enumerate(slots):
        index = slot.index.cpu().numpy()
        order = slot.order.cpu().numpy()
        L = index.shape[1]
        plan = plans.pool_plan(index.shape[0], 1, dim, 4, num_rows, L)
        out.append(plans.pool_bwd_model(g[order // L, s], index.reshape(-1)[order], num_rows, plan))
    return out


def phase_kernels(dev):
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.dot_interaction import (
        dot_interaction_bwd_reference, dot_interaction_reference,
    )
    from persia_tpu_torch.ops.embedding_pool import (
        gather_pool_bwd_reference, gather_pool_fwd_reference,
    )

    print("== phase 3: DLRM kernels vs their plain versions", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    bench = (BATCH, N_SLOTS + 1, EMB_DIM)
    errs = {}
    # bf16 (tensor cores): f32 sums in the tensor cores' order, one bf16
    # rounding each side (<= 1 ulp apart); f32 (FMA walk): the same f32 sum
    for dtype, tol in ((torch.bfloat16, (2 ** -7, 1e-3)), (torch.float32, (1e-5, 1e-5))):
        x = torch.randn(bench, generator=g).to(dev, dtype)
        out = ops.dot_interaction(x)
        torch.cuda.synchronize()
        errs[("dot", dtype)] = check_close(f"dot_interaction{list(x.shape)} {str(dtype)[6:]}", out,
                                           dot_interaction_reference(x), *tol)
    # backward: bf16 rounds two f32 sums of ~n terms once (atol for the
    # sums near 0); f32 differs in summation order only. Edge shapes: n not
    # a multiple of 8 on the tensor cores, d=24 on the FMA walk
    for shape, dtype, tol in (
        (bench, torch.bfloat16, (2 ** -7, 1e-2)), (bench, torch.float32, (1e-5, 1e-5)),
        ((333, 13, 16), torch.bfloat16, (2 ** -7, 1e-2)), ((100, 27, 24), torch.bfloat16, (2 ** -7, 1e-2)),
        ((77, 32, 64), torch.float32, (1e-5, 1e-5)),
    ):
        b, n, d = shape
        x = torch.randn(shape, generator=g).to(dev, dtype)
        gr = torch.randn((b, n * (n - 1) // 2), generator=g).to(dev, dtype)
        out = ops.dot_interaction_bwd(x, gr)
        torch.cuda.synchronize()
        err = check_close(f"dot_interaction_bwd{list(shape)} {str(dtype)[6:]}", out,
                          dot_interaction_bwd_reference(x, gr), *tol)
        errs.setdefault(("dot_bwd", dtype), err)
    # gather-pool: the forward sums the same f32 values in l order on both
    # sides. The backward sums a row's n terms in its own fixed order,
    # index_add_ in the order of its atomics: each f32 sum is within (n-1) u
    # sum|x| of the exact one (u = 2^-24), so the two within twice that, per
    # element (hot zipf rows hold hundreds of terms); bf16 then rounds each
    # once. Cases without counts are also held bit for bit to the kernel's
    # own order (plans.pool_bwd_model), and the zipf ones to a second call
    cases = [
        ("bench", torch.bfloat16, BATCH, [(2000, 1, False)] * N_SLOTS, EMB_DIM, "clipped"),
        ("zipf(1.2) bench", torch.bfloat16, BATCH, [(1500, 1, False)] * N_SLOTS, EMB_DIM, "zipf"),
        ("one row", torch.bfloat16, BATCH, [(1500, 1, False)] * 4, EMB_DIM, "one_row"),
        ("chunk edge", torch.bfloat16, 1000, [(300, 1, False)] * 3, EMB_DIM, "edge"),
        ("L=4 counts", torch.bfloat16, 1000, [(300, 4, True), (50, 4, False), (700, 1, True)], EMB_DIM, "clipped"),
        ("L=4 counts", torch.float32, 1000, [(300, 4, True), (50, 4, False), (700, 1, True)], EMB_DIM, "clipped"),
        ("dim 8", torch.float32, 1000, [(300, 4, True), (50, 1, False)], 8, "zipf"),
        ("dim 24", torch.float32, 777, [(200, 2, True), (30, 1, False)], 24, "zipf"),
        ("dim 10 scalar path", torch.float32, 500, [(60, 1, False), (9, 3, False)], 10, "zipf"),
        ("70 slots", torch.bfloat16, 64, [(20 + s, 1 + s % 3, s % 2 == 0) for s in range(70)], EMB_DIM, "clipped"),
    ]
    for label, dtype, batch, specs, dim, ids in cases:
        rows, slots = pool_inputs(dev, dtype, batch, specs, seed=len(specs), dim=dim, ids=ids)
        out = ops.gather_pool_fwd(rows, slots)
        gr = torch.randn(out.shape, generator=g).to(dev)
        grads = ops.gather_pool_bwd(gr, rows, slots)
        torch.cuda.synchronize()
        name = f"gather_pool {label} {str(dtype)[6:]} B={batch} S={len(specs)} dim={dim}"
        err = check_close(f"{name} fwd", out, gather_pool_fwd_reference(rows, slots), 1e-6, 1e-6)
        errs.setdefault(("pool_fwd", dtype), err)
        ref = gather_pool_bwd_reference(gr, rows, slots)
        abs_sums = gather_pool_bwd_reference(gr.abs(), [r.float() for r in rows], slots)
        order = torch.cat([
            2 * (s.offsets[1:] - s.offsets[:-1]).float()[:, None] * 2 ** -24 * a
            for s, a in zip(slots, abs_sums)
        ])
        tol = (1e-6, order) if dtype == torch.float32 else (2 ** -7, 1e-3 + order)
        err = check_close(f"{name} bwd", torch.cat(grads), torch.cat(ref), *tol)
        errs.setdefault(("pool_bwd", dtype), err)
        if ids in ("clipped", "zipf") and label != "L=4 counts":
            again = ops.gather_pool_bwd(gr, rows, slots)
            same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(grads, again))
            print(f"  {name} bwd twice: bitwise {'ok' if same else 'FAIL'}", flush=True)
            if not same:
                raise SystemExit("gather_pool_bwd is not deterministic")
        if all(s.counts is None for s in slots):
            want = pool_schedule_bits(gr, slots, rows[0].shape[0], dim)
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            same = all(torch.equal(a.cpu().view(bits), torch.from_numpy(w).to(dtype).view(bits))
                       for a, w in zip(grads, want))
            print(f"  {name} bwd vs its schedule (plans.pool_bwd_model): bitwise {'ok' if same else 'FAIL'}",
                  flush=True)
            if not same:
                raise SystemExit("gather_pool_bwd does not follow its schedule")
    return {"dot_interaction": errs[("dot", torch.bfloat16)],
            "dot_interaction_bwd": errs[("dot_bwd", torch.bfloat16)],
            "gather_pool_fwd": errs[("pool_fwd", torch.bfloat16)],
            "gather_pool_bwd": errs[("pool_bwd", torch.bfloat16)]}


def path_flash_attention(dev):
    import torch

    from persia_tpu_torch import ops

    print("== phase 4a: flash-attention path (bf16 and f32, both masks, forward and backward)", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    qkv = [torch.randn((4, 1024, 8, 64), generator=g).to(dev) for _ in range(3)]
    bf = [x.to(torch.bfloat16) for x in qkv]
    leaves = [[x.clone().requires_grad_(True) for x in group] for group in (bf, qkv) for _ in range(2)]
    ops.reset_launch_counts()
    outs = [ops.flash_attention(*x, causal=c) for x, c in zip(leaves, (False, True, False, True))]
    for o in outs:  # the backward: a dense recompute, no kernel of its own
        o.float().sum().backward()
    torch.cuda.synchronize()
    routes = dict(ops.flash_attention.launches_by_route)
    split = ops.tf32_split_planes.launches
    for o, x in zip(outs, leaves):
        if o.shape != qkv[0].shape or not bool(torch.isfinite(o.float()).all()):
            raise SystemExit("flash_attention path: bad output")
        if o.grad_fn is None or not all(bool(torch.isfinite(t.grad.float()).all()) for t in x):
            raise SystemExit("flash_attention path: no finite q, k, v gradients")
    if routes != {"wgmma_bf16": 2, "tf32x3": 2} or ops.flash_attention.launches != 4 or split != 2:
        raise SystemExit(f"flash_attention path launched {routes} and the pre-pass {split} "
                         f"times, expected each route and the pre-pass twice")
    print(f"  flash_attention launches by route={routes}, tf32_split_planes={split} "
          f"(forward and backward of each)", flush=True)
    # the card's gradients against the CPU port's (both the dense
    # recompute) at a shape the CPU takes quickly, route tolerances
    from persia_tpu_torch.ops.flash_attention import route_tolerance

    grad_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for causal, scale in ((False, None), (True, None), (False, -0.2)):
            host = [torch.randn((2, 256, 2, 64), generator=g).to(dtype) for _ in range(3)]
            grads = []
            for d in (dev, "cpu"):
                x = [t.to(d).requires_grad_(True) for t in host]
                ops.flash_attention(*x, causal=causal, scale=scale).float().square().sum().backward()
                grads.append([t.grad.cpu().float() for t in x])
            rtol, atol = route_tolerance(host[2])
            for a, b in zip(*grads):
                grad_err = max(grad_err, check_close(
                    f"flash_attention dq/dk/dv [2, 256, 2, 64] {str(dtype)[6:]} causal={causal} "
                    f"scale={scale}, card vs cpu", a, b, rtol, atol))
    return {**routes, "tf32_split_planes": split, "grad_max_abs_err_vs_cpu": grad_err}


def make_store(backend, **kw):
    """A store of ``backend``; for "native", fail unless the C++ core and
    the native worker core both serve (no numpy fallback)."""
    from persia_tpu_torch.embedding import native_worker
    from persia_tpu_torch.embedding.native_store import create_store, store_backend_name

    store = create_store(backend, **kw)
    name = store_backend_name(store)
    if backend == "native":
        worker_core = native_worker.available()
        print(f"  store backend={name}, native worker core={worker_core}", flush=True)
        if name != "native" or not worker_core:
            raise SystemExit("the native store or worker core did not build or load")
    return store


def path_serving(dev):
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ctx import InferCtx
    from persia_tpu_torch.data import PersiaBatch
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.train_step import build_eval_step
    from persia_tpu_torch.serving.engine import InferenceEngine
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    print("== phase 4b: serving path (DLRM at bench width, 5 requests of B=4096)", flush=True)
    cfg = bench_cfg()
    make_batch = zipf_batch_maker(SEED)
    warm = [make_batch() for _ in range(WARM_BATCHES)]
    engines, sd = {}, None
    # the card's engine on the native cores; the CPU's on the numpy store
    # (the golden model), warmed alike: the two cores held to each other
    for device, backend in ((dev, "native"), ("cpu", "numpy")):
        store = make_store(backend, capacity=1 << 22, num_internal_shards=64,
                             optimizer=Adagrad(lr=0.05).config, seed=1)
        worker = EmbeddingWorker(cfg, [store], device_pooling=True)
        t0 = time.perf_counter()
        for b in warm:  # admit the stream's hot rows; the tail misses → zeros
            worker.forward_directly(b, train=True)
        print(f"  {backend} store warmed with {WARM_BATCHES} admitting lookups: {store.size()} rows "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device=device)
        sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
        model.load_state_dict(sd)
        engines[device] = InferenceEngine(InferCtx(model, worker, cfg, device=device), device=device)
    requests = [make_batch().to_bytes() for _ in range(REQUESTS)]

    engine = engines[dev]
    ops.reset_launch_counts()
    latencies, preds = [], []
    t_all = time.perf_counter()
    for raw in requests:
        t = time.perf_counter()
        preds.append(engine.predict_from_bytes(raw))  # ends in a device→host copy
        latencies.append(time.perf_counter() - t)
    wall = time.perf_counter() - t_all
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}

    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(dot_interaction=REQUESTS, gather_pool_fwd=REQUESTS)
    if launches != expected or engine.forwards != REQUESTS:
        raise SystemExit(f"serving path: launches {launches}, forwards {engine.forwards}; "
                         f"expected one dot_interaction and one gather_pool_fwd per forward")
    print(f"  launches={launches} forwards={engine.forwards}", flush=True)
    # where a request's time goes: the same requests again, stage by stage,
    # each stage ending in a synchronize (host clock); "forward_stream" is
    # the CUDA-event time between the forward's first and last launch,
    # gaps where the card waits for the host included
    ctx = engine.ctx
    eval_step = build_eval_step(ctx.model)
    stages = {k: [] for k in ("decode", "lookup", "stage_h2d", "forward", "forward_stream", "d2h")}
    device_batches = []
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for raw in requests:
        t0 = time.perf_counter()
        batch = PersiaBatch.from_bytes(raw)
        t1 = time.perf_counter()
        emb_batches = ctx.worker.forward_directly(batch, train=False)
        t2 = time.perf_counter()
        device_batch, _ = ctx.prepare_features(batch, emb_batches)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        device_batches.append(device_batch)
        ev0.record()
        out = eval_step(device_batch)
        ev1.record()
        ev1.synchronize()
        t4 = time.perf_counter()
        out.cpu()
        t5 = time.perf_counter()
        for k, a, b in (("decode", t0, t1), ("lookup", t1, t2), ("stage_h2d", t2, t3),
                        ("forward", t3, t4), ("d2h", t4, t5)):
            stages[k].append((b - a) * 1e3)
        stages["forward_stream"].append(ev0.elapsed_time(ev1))
    busy_ms, top_kernels, _ = device_busy_ms(eval_step, device_batches)

    # the same engine on the CPU (plain versions); bf16 rounds at other
    # points there, probabilities (sigmoid slope <= 1/4) agree to 2e-2
    err = 0.0
    for raw, p in zip(requests, preds):
        if p.shape != (BATCH, 1) or not np.isfinite(p).all():
            raise SystemExit(f"serving path: bad predictions, shape {p.shape}")
        ref = engines["cpu"].predict_from_bytes(raw)
        err = max(err, float(np.abs(p - ref).max()))
    print(f"  card vs cpu engine: max_abs_err={err:.3e} tolerance=2e-2 "
          f"{'ok' if err <= 2e-2 else 'FAIL'}", flush=True)
    if err > 2e-2:
        raise SystemExit("serving path: card and CPU predictions disagree")

    lat = [x * 1e3 for x in latencies]
    serving = {
        "requests": REQUESTS, "batch": BATCH,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "latency_ms_all": lat,
        "samples_per_s": REQUESTS * BATCH / wall,
        "pred_max_abs_err_vs_cpu": err,
        "stage_ms_p50": {k: float(np.percentile(v, 50)) for k, v in stages.items()},
        "stage_ms_all": stages,
        # summed kernel time per forward by torch.profiler (None: the
        # profiler saw no device time)
        "forward_device_busy_ms": busy_ms,
        "forward_top_kernels_ms": top_kernels,
    }
    feats_shape = (BATCH, N_SLOTS + 1, EMB_DIM)
    return launches, serving, feats_shape


def bench_cfg():
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig

    return EmbeddingConfig(
        slots_config={f"cat_{i}": SlotConfig(dim=EMB_DIM) for i in range(N_SLOTS)},
        feature_index_prefix_bit=8,
    )


def bench_train_ctx(device, backend, warm, sd=None, store=None):
    """The bench's training ctx (bf16 wire, Adagrad(0.05), Adam(1e-3)) over
    one store of ``backend`` (capacity 2^25, 64 internal shards; or over
    ``store``), warmed by admitting lookups of ``warm``; returns (ctx,
    store, weights)."""
    import torch

    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    cfg = bench_cfg()
    if store is None:
        store = make_store(backend, capacity=1 << 25, num_internal_shards=64,
                           optimizer=Adagrad(lr=0.05).config, seed=1)
    worker = EmbeddingWorker(cfg, [store], device_pooling=True)
    for b in warm:  # admit the stream's hot rows, as the serving path does
        worker.forward_directly(b, train=True)
    model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device="cpu")
    sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    model.load_state_dict(sd)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05),
                   worker, cfg, device=device, wire_dtype="bfloat16").__enter__()
    return ctx, store, sd


def batch_keys(batches, cfg=None):
    """The table keys (signs) of ``batches``' ids (under ``cfg``, the
    bench's by default), sorted and distinct."""
    from persia_tpu_torch.embedding.worker import preprocess_batch

    cfg = cfg or bench_cfg()
    return np.unique(np.concatenate([s.keys for b in batches for s in preprocess_batch(b.id_type_features, cfg)]))


def entries_of(store, signs):
    """{sign: whole entry} for the signs present in ``store``."""
    out = {}
    for sign in signs.tolist():
        e = store.get_embedding_entry(sign)
        if e is not None:
            out[sign] = e.copy()
    return out


def path_training(dev):
    """Phase 4c: ``TrainCtx.train_step`` at bench width on the card, over
    the native store and worker cores."""
    import torch

    from persia_tpu_torch import ops

    print(f"== phase 4c: training path (DLRM at bench width, B={BATCH}, TrainCtx.train_step)", flush=True)
    make_batch = zipf_batch_maker(SEED + 10, labels=True)
    warm = [make_batch() for _ in range(WARM_BATCHES)]
    batches = [make_batch() for _ in range(TRAIN_WARMUP + TRAIN_STEPS + TRAIN_STAGED + 2)]

    t0 = time.perf_counter()
    ctx, store, sd = bench_train_ctx(dev, "native", warm)
    print(f"  store warmed with {WARM_BATCHES} admitting lookups: {store.size()} rows "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    worker = ctx.worker

    def checked_step(batch):
        m = ctx.train_step(batch)
        if not np.isfinite(m["loss"]) or worker.staleness != 0:
            raise SystemExit(f"training path: loss {m['loss']}, staleness {worker.staleness}")
        return m["loss"]

    losses = [checked_step(b) for b in batches[:TRAIN_WARMUP]]
    ops.reset_launch_counts()
    step_ms = []
    for i, b in enumerate(batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS]):
        t = time.perf_counter()
        losses.append(checked_step(b))  # ends in the gradients' copy to the host and the update
        step_ms.append((time.perf_counter() - t) * 1e3)
        if len(losses) == TRAIN_CPU_STEPS:  # the PS rows after the steps the CPU repeats (untimed)
            snapshot = entries_of(store, batch_keys(warm + batches[:TRAIN_CPU_STEPS]))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(dot_interaction=TRAIN_STEPS, dot_interaction_bwd=TRAIN_STEPS,
                    gather_pool_fwd=TRAIN_STEPS, gather_pool_bwd=TRAIN_STEPS)
    if launches != expected:
        raise SystemExit(f"training path: launches {launches}, expected {expected}")
    print(f"  launches={launches} over {TRAIN_STEPS} steps; losses {[round(x, 5) for x in losses]}",
          flush=True)
    print(f"  step ms: {[round(x, 2) for x in step_ms]}", flush=True)

    # stage by stage, each stage ending in a synchronize (host clock); the
    # step's device span by CUDA events
    stages = {k: [] for k in ("lookup", "stage_h2d", "step", "step_stream", "grads_d2h", "update")}
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    staged = batches[TRAIN_WARMUP + TRAIN_STEPS:]
    for b in staged[:TRAIN_STAGED]:
        t0 = time.perf_counter()
        ref = worker.put_forward_ids(b)
        emb_batches = worker.forward_batch_id(ref, train=True)
        t1 = time.perf_counter()
        device_batch, counts = ctx.prepare_features(b, emb_batches, csr=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ev0.record()
        header, gpacked = ctx.run_step(device_batch)
        ev1.record()
        ev1.synchronize()
        t3 = time.perf_counter()
        metrics, emb_grads = ctx.fetch_step_output(header, gpacked, device_batch)
        t4 = time.perf_counter()
        slot_grads = ctx.emb_grads_to_slot_grads(emb_batches, emb_grads, counts)
        worker.update_gradient_batched(ref, slot_grads)
        t5 = time.perf_counter()
        for k, a, c in (("lookup", t0, t1), ("stage_h2d", t1, t2), ("step", t2, t3),
                        ("grads_d2h", t3, t4), ("update", t4, t5)):
            stages[k].append((c - a) * 1e3)
        stages["step_stream"].append(ev0.elapsed_time(ev1))
        losses.append(metrics["loss"])
    # device time of the step alone (these batches' gradients are dropped)
    refs, device_batches = [], []
    for b in staged[TRAIN_STAGED:]:
        refs.append(worker.put_forward_ids(b))
        device_batches.append(ctx.prepare_features(b, worker.forward_batch_id(refs[-1]), csr=True)[0])
    busy_ms, top_kernels, _ = device_busy_ms(ctx.run_step, device_batches)
    for ref in refs:
        worker.abort_gradient(ref)
    if worker.staleness != 0 or not all(np.isfinite(losses)):
        raise SystemExit(f"training path: staleness {worker.staleness}, losses {losses}")

    # the same first steps on the CPU over the numpy store (the golden
    # model): bf16 rounds at other points there
    cpu, cpu_store, _ = bench_train_ctx("cpu", "numpy", warm, sd)
    cpu_losses = [cpu.train_step(b)["loss"] for b in batches[:TRAIN_CPU_STEPS]]
    loss_err = max(abs(a - c) for a, c in zip(losses, cpu_losses))
    print(f"  first {TRAIN_CPU_STEPS} losses card {losses[:TRAIN_CPU_STEPS]} cpu {cpu_losses}: "
          f"max_abs_err={loss_err:.3e} tolerance=2e-2 {'ok' if loss_err <= 2e-2 else 'FAIL'}", flush=True)
    cpu_rows = {sign: vec for sh in cpu_store._shards for sign, (_, vec) in sh.entries.items()}
    if set(cpu_rows) != set(snapshot):
        raise SystemExit(f"training path: the card's native store holds {len(snapshot)} of the batches' "
                         f"signs, the CPU's numpy store {len(cpu_rows)}")
    row_err = max(float(np.abs(snapshot[k] - v).max()) for k, v in cpu_rows.items())
    print(f"  PS entries after {TRAIN_CPU_STEPS} steps, card (native store) vs cpu (numpy store), "
          f"{len(cpu_rows)} rows: max_abs_err={row_err:.3e} tolerance=1e-2 "
          f"{'ok' if row_err <= 1e-2 else 'FAIL'}", flush=True)
    if loss_err > 2e-2 or row_err > 1e-2:
        raise SystemExit("training path: card and CPU disagree")

    wall = sum(step_ms) / 1e3
    training = {
        "batch": BATCH, "measured_steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP,
        "store_backend": "native",
        "samples_per_s": TRAIN_STEPS * BATCH / wall,
        "step_ms_mean": wall / TRAIN_STEPS * 1e3,
        "step_ms_max": max(step_ms), "step_ms_all": step_ms,
        "losses": losses,
        "loss_max_abs_err_vs_cpu": loss_err, "ps_entry_max_abs_err_vs_cpu": row_err,
        "stage_ms_p50": {k: float(np.percentile(v, 50)) for k, v in stages.items()},
        "stage_ms_all": stages,
        "step_device_busy_ms": busy_ms,
        "step_top_kernels_ms": top_kernels,
        "store_rows": store.size(),
    }
    # the inputs of the kernels' timing: the last staged step's batch
    return launches, training, device_batches[-1]


def timed_calls(obj, name, sink, cpu_sink, lock=None):
    """Shadow ``obj.name`` (an object's method, or a module's or a class's
    function) with a wrapper that appends each call's ms to ``sink`` and
    the CPU ms its thread spent in it to ``cpu_sink`` (with ``lock``, calls
    run one at a time, the wait for it included); returns the function that
    takes the wrapper away."""
    fn = getattr(obj, name)
    own = name in vars(obj)  # a module's or a class's: put the original back

    def wrapper(*args, **kwargs):
        t, c = time.perf_counter(), time.thread_time()
        try:
            if lock is None:
                return fn(*args, **kwargs)
            with lock:
                return fn(*args, **kwargs)
        finally:
            sink.append((time.perf_counter() - t) * 1e3)
            cpu_sink.append((time.thread_time() - c) * 1e3)

    setattr(obj, name, wrapper)
    return (lambda: setattr(obj, name, fn)) if own else (lambda: delattr(obj, name))


def device_busy_union_ms(fn):
    """Wall ms of ``fn()`` and the ms in it that the card was busy: the
    union of the device's own event intervals (kernels and copies, on any
    stream) by torch.profiler, user annotations left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return wall, (busy / 1e3 if spans else None)


def path_pipelined(dev):
    """Phase 4d: the pipelined training path (``DataLoader`` +
    ``train_step_prepared``) at bench width and the bench's settings."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.data_loader import DataLoader

    print(f"== phase 4d: pipelined training (DataLoader num_workers={PIPE_WORKERS}, "
          f"staleness={PIPE_STALENESS}, B={BATCH}, train_step_prepared)", flush=True)
    make_batch = zipf_batch_maker(SEED + 20, labels=True)
    warm = [make_batch() for _ in range(WARM_BATCHES)]
    sync_warm = [make_batch() for _ in range(TRAIN_WARMUP)]
    batches = [make_batch() for _ in range(PIPE_BATCHES + PIPE_PROFILED)]
    sweep = [[make_batch() for _ in range(PIPE_SWEEP_BATCHES)] for _ in PIPE_SWEEP]
    repro = [make_batch() for _ in range(PIPE_REPRO)]
    ctx, store, sd = bench_train_ctx(dev, "native", warm)
    print(f"  store warmed with {WARM_BATCHES} admitting lookups: {store.size()} rows", flush=True)
    for b in sync_warm:
        ctx.train_step(b)

    def run(stream, step_ms=None, workers=PIPE_WORKERS, parts=None):
        """Train the whole stream through a fresh loader; returns it,
        flushed and shut down. ``step_ms`` gets each step's time since the
        previous step ended (the wait for its batch included); ``parts``
        the consumer's wait and step apart."""
        loader = DataLoader(iter(stream), ctx, num_workers=workers, staleness=PIPE_STALENESS)
        t = time.perf_counter()
        it = iter(loader)
        for tb in it:
            got = time.perf_counter()
            ctx.train_step_prepared(tb, loader, fetch_metrics=False)
            now = time.perf_counter()
            if step_ms is not None:
                step_ms.append((now - t) * 1e3)
            if parts is not None:
                parts["wait"].append((got - t) * 1e3)
                parts["step"].append((now - got) * 1e3)
            t = now
        loader.flush()
        loader.shutdown()
        return loader

    ops.reset_launch_counts()
    step_ms = []
    t0 = time.perf_counter()
    loader = run(batches[:PIPE_BATCHES], step_ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(dot_interaction=PIPE_BATCHES, dot_interaction_bwd=PIPE_BATCHES,
                    gather_pool_fwd=PIPE_BATCHES, gather_pool_bwd=PIPE_BATCHES)
    final = ctx.last_prepared_metrics()
    window = loader.staleness_state()
    print(f"  launches={launches} over {PIPE_BATCHES} batches; final loss {final['loss']:.5f}; "
          f"after flush: staleness {ctx.worker.staleness}, window {window}", flush=True)
    print(f"  step ms: {[round(x, 2) for x in step_ms]}", flush=True)
    if launches != expected:
        raise SystemExit(f"pipelined path: launches {launches}, expected {expected}")
    if not np.isfinite(final["loss"]) or ctx.worker.staleness != 0 or window != {
            "outstanding_gradient_batches": 0, "free_permits": PIPE_STALENESS, "staleness": PIPE_STALENESS}:
        raise SystemExit("pipelined path: non-finite loss, or the staleness window not whole after flush")

    # the card's busy share of the same loop over more batches, profiled
    # apart (the profiler's cost stays out of the numbers above)
    prof_wall, busy = device_busy_union_ms(lambda: run(batches[PIPE_BATCHES:]))
    print(f"  profiled loop of {PIPE_PROFILED} batches: {prof_wall:.1f} ms, card busy {busy} ms", flush=True)

    # where a pipelined batch's time goes, at 1, 2 and 4 lookup threads
    # and in two diagnostic variants (PIPE_SWEEP): the host stages timed
    # inside the loop (lookup and staging on the lookup threads, the update
    # on the gradient threads: wall ms and the CPU ms of the thread in
    # them; the consumer's wait for a batch and its step)
    sweep_out = {}
    for (workers, variant), stream in zip(PIPE_SWEEP, sweep):
        parts = {k: [] for k in ("lookup", "stage", "update", "wait", "step",
                                 "lookup_cpu", "stage_cpu", "update_cpu")}
        restore = [timed_calls(ctx.worker, "forward_batch_id", parts["lookup"], parts["lookup_cpu"]),
                   timed_calls(ctx, "prepare_features", parts["stage"], parts["stage_cpu"],
                               lock=threading.Lock() if variant == "serial_stage" else None),
                   timed_calls(ctx.worker, "update_gradient_batched", parts["update"], parts["update_cpu"])]
        interval = sys.getswitchinterval()
        if variant == "switch_0.5ms":
            sys.setswitchinterval(0.0005)
        try:
            t = time.perf_counter()
            run(stream, workers=workers, parts=parts)
            torch.cuda.synchronize()
            sweep_wall = time.perf_counter() - t
        finally:
            sys.setswitchinterval(interval)
            for undo in restore:
                undo()
        label = f"{workers}" + (f" {variant}" if variant else "")
        sweep_out[label] = {"samples_per_s": len(stream) * BATCH / sweep_wall,
                            **{f"{k}_ms_p50": float(np.percentile(v, 50)) for k, v in parts.items()},
                            "step_ms_max": max(parts["step"]), "wait_ms_max": max(parts["wait"])}
        print(f"  {label} lookup thread(s), {len(stream)} batches: "
              + ", ".join(f"{k} {v:.2f}" for k, v in sweep_out[label].items()), flush=True)

    # reproducible, staleness 1: the loader against train_step on the same
    # batches, from the same weights and an empty native store each
    results = []
    for pipelined in (False, True):
        c, st, _ = bench_train_ctx(dev, "native", [], sd)
        if pipelined:
            ld = DataLoader(iter(repro), c, num_workers=PIPE_WORKERS, staleness=1, reproducible=True)
            losses = [c.train_step_prepared(tb, ld)["loss"] for tb in ld]
            ld.flush()
            ld.shutdown()
        else:
            losses = [c.train_step(b)["loss"] for b in repro]
        results.append((losses, entries_of(st, batch_keys(repro)), st.size()))
    (l_sync, e_sync, n_sync), (l_pipe, e_pipe, n_pipe) = results
    loss_err = max(abs(a - b) for a, b in zip(l_sync, l_pipe))
    same_rows = set(e_sync) == set(e_pipe) and len(e_sync) == n_sync == n_pipe
    row_err = max(float(np.abs(e_sync[k] - e_pipe[k]).max()) for k in e_sync) if same_rows else float("inf")
    ok = same_rows and loss_err <= 1e-5 and row_err <= 1e-5
    print(f"  reproducible staleness=1 loader vs train_step, {PIPE_REPRO} batches: losses max_abs_err="
          f"{loss_err:.3e}, PS entries ({len(e_sync)} rows) max_abs_err={row_err:.3e} tolerance=1e-5 "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("pipelined path: the reproducible loader disagrees with train_step")

    return launches, {
        "batch": BATCH, "batches": PIPE_BATCHES, "num_workers": PIPE_WORKERS,
        "staleness": PIPE_STALENESS, "warmup_sync_steps": TRAIN_WARMUP, "store_backend": "native",
        "samples_per_s": PIPE_BATCHES * BATCH / wall,
        "wall_ms": wall * 1e3, "step_ms_max": max(step_ms),
        "step_ms_p50": float(np.percentile(step_ms, 50)), "step_ms_all": step_ms,
        "final_loss": final["loss"],
        "profiled_batches": PIPE_PROFILED, "profiled_wall_ms": prof_wall, "device_busy_ms": busy,
        "device_busy_share": busy / prof_wall if busy is not None else None,
        "repro_loss_max_abs_err": loss_err, "repro_ps_entry_max_abs_err": row_err,
        "by_lookup_threads": sweep_out,
        "store_rows": store.size(),
    }


def shard_dumps(store):
    return [store.dump_shard(i) for i in range(store.num_internal_shards)]


def dump_entries(dumps) -> dict:
    """{sign: the entry's bytes (dim, len and floats)} of shard dumps."""
    from persia_tpu_torch.checkpoint import iter_shard_entries
    return {s: e[8:] for blob in dumps for s, e in iter_shard_entries(blob)}


def synthetic_shard_blobs(rows, template, seed, chunk=1 << 20):
    """Shard payloads of ``rows`` entries with random signs and values, each
    laid out as ``template`` (an entry of a real dump: its dim and length),
    ``chunk`` entries a payload."""
    rng = np.random.default_rng(seed)
    dim, ln = (int(v) for v in np.frombuffer(template, "<u4", 2, 8))
    entry = np.dtype([("sign", "<u8"), ("dim", "<u4"), ("len", "<u4"), ("data", "<f4", (ln,))])
    for start in range(0, rows, chunk):
        e = np.empty(min(chunk, rows - start), entry)
        e["sign"] = rng.integers(1, 1 << 63, len(e), dtype=np.uint64)
        e["dim"], e["len"] = dim, ln
        e["data"] = rng.random((len(e), ln), dtype=np.float32)
        yield np.uint32(len(e)).tobytes() + e.tobytes()


def dense_diff(a, b) -> str:
    """Where two dense ``TrainState``s differ: each differing parameter or
    Adam state tensor with its largest difference."""
    out = []
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        pairs = [("", pa, pb)] + [(f".{k}", a.optimizer.state[pa][k], b.optimizer.state[pb][k])
                                  for k in ("exp_avg", "exp_avg_sq", "step")]
        for key, x, y in pairs:
            x, y = x.detach().double().cpu(), y.detach().double().cpu()
            if not (x == y).all():
                out.append(f"{name}{key} {float((x - y).abs().max()):.3e}")
    return "; ".join(out) or "none"


def tree_leaves(tree, prefix=""):
    """(path, dtype name) of a nested dict's leaves, layer numbers as "i"."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in tree_leaves(v, f"{prefix}['{k}']")]
    return [(re.sub(r"Dense_\d+", "Dense_i", prefix), None if tree is None else str(tree.dtype))]


def manifest_layout(m):
    """A manifest's layout: its meta keys, its components' names with the
    replica and shard numbers as "r" and "i", and its dense state's leaves."""
    from persia_tpu_torch.serialization import msgpack_restore

    names = {re.sub(r"replica_\d+_shard_\d+", "replica_r_shard_i", n) for n in m.components}
    return sorted(k for k in m.meta if k != "datetime"), names, sorted(set(tree_leaves(
        msgpack_restore(m.read_blob("dense.state")))))


def cross_package(dev, card_manifest):
    """(d): the reference's job directory (the fixture) read by the port on
    the card: every blob's crc, the same layout as the manifest the port
    wrote on the card, its dense state loaded into a DLRM on the card and
    written back to the reference's bytes, its shards restored into native
    stores and dumped back to the reference's bytes."""
    import torch

    from persia_tpu_torch import jobstate
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.train_step import init_train_state
    from persia_tpu_torch.weights import train_state_from_flax_bytes, train_state_to_flax_bytes

    fixture = jobstate.JobStateManager(str(FIXTURE_DIR)).latest()
    if fixture is None:
        raise SystemExit(f"durable state: no manifest in {FIXTURE_DIR}")
    for name in fixture.components:
        fixture.read_blob(name)
    same_layout = manifest_layout(fixture) == manifest_layout(card_manifest)
    raw = fixture.read_blob("dense.state")
    model = DLRM(N_DENSE, FIXTURE_MODEL["num_slots"], EMB_DIM, FIXTURE_MODEL["bottom_mlp"],
                 FIXTURE_MODEL["top_mlp"], device=dev)
    state = init_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    dense_same = train_state_to_flax_bytes(train_state_from_flax_bytes(state, raw)) == raw
    stores = [make_store("native", capacity=1 << 16, num_internal_shards=4) for _ in range(fixture.meta["ps_replicas"])]
    restored = jobstate.restore_ps(fixture, stores, optimizer=Adagrad(lr=0.1).config)
    shards_same = all(st.dump_shard(i) == fixture.read_blob(f"ps/replica_{r}_shard_{i}.emb")
                      for r, st in enumerate(stores) for i in range(st.num_internal_shards))
    print(f"  (d) the reference's manifest (step {fixture.step}) read on the card: crc ok, layout "
          f"{'same as' if same_layout else 'DIFFERS from'} the port's; dense state written back "
          f"{'byte-equal' if dense_same else 'DIFFERENT'}; {restored} PS entries restored and dumped back "
          f"{'byte-equal' if shards_same else 'DIFFERENT'}", flush=True)
    if not (same_layout and dense_same and shards_same):
        raise SystemExit(f"durable state: the reference's manifest and the port's disagree: "
                         f"{manifest_layout(fixture)} vs {manifest_layout(card_manifest)}")
    return restored


def path_durable(dev):
    """Phase 4f: durable state on the hybrid tier at bench width."""
    from persia_tpu_torch import ops

    print(f"== phase 4f: durable state (TrainCtx at bench width, B={BATCH}, native store: snapshot_job, "
          f"resume, the apply-journal, dump and load)", flush=True)
    shutil.rmtree(STATE_DIR, ignore_errors=True)
    try:
        return durable_cases(dev, ops)
    finally:
        shutil.rmtree(STATE_DIR, ignore_errors=True)


def durable_cases(dev, ops):
    import torch

    from persia_tpu_torch import ctx as ctx_module
    from persia_tpu_torch import jobstate
    from persia_tpu_torch.embedding import worker as worker_module
    from persia_tpu_torch.embedding.hashing import sign_to_shard
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.weights import train_state_to_flax_bytes

    make_batch = zipf_batch_maker(SEED + 30, labels=True)
    batches = [make_batch() for _ in range(DUR_STEPS)]
    cost_batches = [make_batch() for _ in range(JOURNAL_COST_STEPS + TRAIN_WARMUP)]
    job_base, job = STATE_DIR / "job_base", STATE_DIR / "job"

    # (a) the uninterrupted run: a cold resume arms the journal, 12 steps,
    # a snapshot every 4; each snapshot's parts timed
    parts = {k: [] for k in ("ps_capture", "dense_bytes", "commit")}
    undo = [timed_calls(jobstate, "capture_ps", parts["ps_capture"], []),
            timed_calls(ctx_module, "train_state_to_flax_bytes", parts["dense_bytes"], []),
            timed_calls(jobstate.EpochWriter, "commit", parts["commit"], [])]
    snap_ms, snaps = [], []
    try:
        base, base_store, sd = bench_train_ctx(dev, "native", [])
        if base.resume(job_base) is not None:
            raise SystemExit("durable state: a resume on an empty job directory found a manifest")
        for i, b in enumerate(batches):
            base.train_step(b)
            if (i + 1) % DUR_EVERY == 0:
                t = time.perf_counter()
                snaps.append(base.snapshot_job(job_base))
                snap_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        for u in undo:
            u()
    ps_bytes = [m.meta["ps_bytes"] for m in snaps]
    dense_bytes = len(snaps[-1].read_blob("dense.state"))
    print(f"  uninterrupted: {DUR_STEPS} steps, {base_store.size()} PS rows; snapshot ms {snap_ms} "
          f"(PS capture {parts['ps_capture']}, dense bytes {parts['dense_bytes']}, commit {parts['commit']}); "
          f"PS bytes {ps_bytes}, dense bytes {dense_bytes}", flush=True)

    # the crashed run on fresh stores: snapshots at 4 and 8, dies after 9
    # with step 9's gradients applied past the fence
    crash, crash_store, _ = bench_train_ctx(dev, "native", [], sd)
    crash.resume(job)
    for i, b in enumerate(batches[:DUR_KILL]):
        crash.train_step(b)
        if (i + 1) % DUR_EVERY == 0:
            crash.snapshot_job(job)
    del crash  # the trainer dies; its store survives for (b)

    # (a) rewind: fresh stores and ctx, the PS restored from the fence
    rebuilt, rebuilt_store, _ = bench_train_ctx(dev, "native", [], sd)
    t = time.perf_counter()
    m = rebuilt.resume(job, restore_ps=True)
    resume_s = time.perf_counter() - t
    info = rebuilt.last_resume_info
    fence = DUR_EVERY * (DUR_KILL // DUR_EVERY)
    if m is None or m.step != fence:
        raise SystemExit(f"durable state: resumed at {m and m.step}, expected the fence at {fence}")
    ops.reset_launch_counts()
    for b in batches[m.step:]:
        rebuilt.train_step(b)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    replayed = DUR_STEPS - m.step
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(dot_interaction=replayed, dot_interaction_bwd=replayed,
                    gather_pool_fwd=replayed, gather_pool_bwd=replayed)
    dense_same = train_state_to_flax_bytes(rebuilt.state) == train_state_to_flax_bytes(base.state)
    base_dumps = shard_dumps(base_store)
    ps_same = shard_dumps(rebuilt_store) == base_dumps
    print(f"  (a) rewind resume from the fence at {m.step}: {info['ps_entries_restored']} PS entries restored, "
          f"resume {resume_s:.4f} s (resume_job {info['time_to_resume_s']} s); replayed {replayed} steps, "
          f"launches={launches}; dense state bytes {'equal' if dense_same else 'DIFFER'} to the uninterrupted "
          f"run's, PS shard dumps ({len(base_dumps)}) {'equal' if ps_same else 'DIFFER'}", flush=True)
    if launches != expected:
        raise SystemExit(f"durable state: launches {launches}, expected {expected}")
    if not (dense_same and ps_same):
        a, b = dump_entries(shard_dumps(rebuilt_store)), dump_entries(base_dumps)
        moved = [k for k in b if a.get(k) != b[k]]
        err = max((float(np.abs(np.frombuffer(a[k][8:], np.float32) - np.frombuffer(b[k][8:], np.float32)).max())
                   for k in moved if k in a and len(a[k]) == len(b[k])), default=0.0)
        raise SystemExit(f"durable state: the resumed run differs from the uninterrupted one: dense "
                         f"{dense_diff(rebuilt.state, base.state)}; PS entries differing {len(moved)} of {len(b)} "
                         f"(max abs err {err:.3e})")
    del rebuilt, rebuilt_store

    # (b) journal resume: the crashed run's store as the crash left it; the
    # replayed window moves no entry, each replayed step skipped
    before = dump_entries(shard_dumps(crash_store))
    jctx, _, _ = bench_train_ctx(dev, "native", [], sd, store=crash_store)
    m = jctx.resume(job, restore_ps=False)
    for b in batches[m.step:DUR_KILL]:
        jctx.train_step(b)
    skips = jctx.worker.lookup_router.journal_skips
    unmoved = dump_entries(shard_dumps(crash_store)) == before
    print(f"  (b) journal resume from the fence at {m.step}: {DUR_KILL - m.step} replayed step(s), "
          f"journal_skips={skips}, PS entries ({len(before)}) {'unmoved' if unmoved else 'MOVED'}", flush=True)
    if not unmoved or skips < DUR_KILL - m.step:
        raise SystemExit("durable state: the journal resume applied a replayed batch again")
    del jctx, crash_store

    # (c) re-shard on load: the uninterrupted run's store dumped as one
    # replica, loaded into two
    ckpt = str(STATE_DIR / "ckpt")
    t = time.perf_counter()
    base.worker.dump(ckpt)
    dump_ms = (time.perf_counter() - t) * 1e3
    two = [make_store("native", capacity=1 << 25, num_internal_shards=64, optimizer=Adagrad(lr=0.05).config,
                      seed=1) for _ in range(2)]
    t = time.perf_counter()
    loaded = EmbeddingWorker(bench_cfg(), two, device_pooling=True).load(ckpt)
    load_ms = (time.perf_counter() - t) * 1e3
    src = dump_entries(base_dumps)
    halves = [dump_entries(shard_dumps(s)) for s in two]
    owned = all((sign_to_shard(np.fromiter(h, np.uint64, len(h)), 2) == r).all() for r, h in enumerate(halves))
    same = loaded == len(src) == len(halves[0]) + len(halves[1]) and {**halves[0], **halves[1]} == src
    print(f"  (c) re-shard on load: dump {dump_ms:.1f} ms, load into 2 replicas {load_ms:.1f} ms, "
          f"{loaded} entries ({len(halves[0])} + {len(halves[1])}); each replica holds its own signs: {owned}; "
          f"entries {'equal' if same else 'DIFFER'}", flush=True)
    if not (owned and same):
        raise SystemExit("durable state: the re-sharded load differs from the dump")
    del two, base, base_store

    # (d) across the packages: the manifest the port wrote here, read back
    # through the port's reader, beside the reference's
    card_manifest = jobstate.JobStateManager(str(job_base)).latest()
    if card_manifest is None or card_manifest.step != DUR_STEPS:
        raise SystemExit("durable state: the port's manifest does not read back")
    for name in card_manifest.components:
        card_manifest.read_blob(name)
    fixture_entries = cross_package(dev, card_manifest)

    fill = durable_at_fill(dev, sd, batches[0], base_dumps)

    # the journal's host cost: phase 4c's step with the journal armed and
    # not, on the same batches, in turns (plain, armed, armed, plain, ...);
    # payload_crc timed on its own in the armed steps
    plain, _, _ = bench_train_ctx(dev, "native", [], sd)
    armed, _, _ = bench_train_ctx(dev, "native", [], sd)
    armed.resume(STATE_DIR / "job_cost")
    for b in cost_batches[:TRAIN_WARMUP]:
        plain.train_step(b)
        armed.train_step(b)
    crc_ms, step_ms = [], {"plain": [], "armed": []}
    undo = timed_calls(worker_module, "payload_crc", crc_ms, [])
    try:
        for i, b in enumerate(cost_batches[TRAIN_WARMUP:]):
            order = (("plain", plain), ("armed", armed)) if i % 2 == 0 else (("armed", armed), ("plain", plain))
            for name, c in order:
                t = time.perf_counter()
                c.train_step(b)
                step_ms[name].append((time.perf_counter() - t) * 1e3)
    finally:
        undo()
    rate = {k: len(v) * BATCH / (sum(v) / 1e3) for k, v in step_ms.items()}
    # each batch's armed step less its plain step: the mean and its standard
    # error say whether the runs resolve the journal's cost
    diff = np.array(step_ms["armed"]) - np.array(step_ms["plain"])
    diff_mean, diff_se = float(diff.mean()), float(diff.std(ddof=1) / np.sqrt(len(diff)))
    print(f"  journal cost ({JOURNAL_COST_STEPS} steps a side): samples/s armed {rate['armed']:.1f}, not armed "
          f"{rate['plain']:.1f}; armed - plain step {diff_mean:.3f} ms (standard error {diff_se:.3f}: "
          f"{'resolved' if abs(diff_mean) > 2 * diff_se else 'not resolved'} at 2 standard errors); "
          f"payload_crc ms mean {np.mean(crc_ms):.3f}, max {max(crc_ms):.3f}", flush=True)
    return launches, {
        "batch": BATCH, "steps": DUR_STEPS, "snapshot_every": DUR_EVERY, "killed_after": DUR_KILL,
        "snapshot_ms": snap_ms, "snapshot_ps_capture_ms": parts["ps_capture"],
        "snapshot_dense_bytes_ms": parts["dense_bytes"], "snapshot_commit_ms": parts["commit"],
        "ps_bytes": ps_bytes, "dense_bytes": dense_bytes,
        "time_to_resume_s": resume_s, "resume_job_s": info["time_to_resume_s"],
        "ps_entries_restored": info["ps_entries_restored"],
        "rewind_dense_bytes_equal": dense_same, "rewind_ps_dumps_equal": ps_same,
        "journal_skips": skips, "journal_replay_unmoved": unmoved,
        "dump_ms": dump_ms, "load_ms": load_ms, "reshard_entries": loaded,
        "samples_per_s_journal_armed": rate["armed"], "samples_per_s_journal_not_armed": rate["plain"],
        "step_ms_armed": step_ms["armed"], "step_ms_not_armed": step_ms["plain"],
        "step_ms_armed_less_plain_mean": diff_mean, "step_ms_armed_less_plain_se": diff_se,
        "payload_crc_ms": crc_ms, "fixture_entries_restored": fixture_entries, "at_fill": fill,
    }


def durable_at_fill(dev, sd, batch, dumps):
    """One snapshot and one rewind resume of the bench store filled with
    ``DUR_FILL_ROWS`` synthetic rows (laid out as the trained rows of
    ``dumps``) and trained one step on ``batch``: each part's ms, ms a MiB of
    PS bytes, and the restored store's dumps and dense bytes equal to the
    snapshotted ones."""
    from persia_tpu_torch import ctx as ctx_module
    from persia_tpu_torch import jobstate
    from persia_tpu_torch.checkpoint import iter_shard_entries
    from persia_tpu_torch.weights import train_state_to_flax_bytes

    job = STATE_DIR / "job_fill"
    template = next(e for blob in dumps for _, e in iter_shard_entries(blob))
    filled, filled_store, _ = bench_train_ctx(dev, "native", [], sd)
    t = time.perf_counter()
    loaded = sum(filled_store.load_shard_bytes(b) for b in synthetic_shard_blobs(DUR_FILL_ROWS, template, SEED + 31))
    fill_s = time.perf_counter() - t
    filled.resume(job)
    filled.train_step(batch)
    rows, capacity = filled_store.size(), 1 << 25
    parts = {k: [] for k in ("ps_capture", "dense_bytes", "commit")}
    undo = [timed_calls(jobstate, "capture_ps", parts["ps_capture"], []),
            timed_calls(ctx_module, "train_state_to_flax_bytes", parts["dense_bytes"], []),
            timed_calls(jobstate.EpochWriter, "commit", parts["commit"], [])]
    try:
        t = time.perf_counter()
        snap = filled.snapshot_job(job)
        snap_ms = (time.perf_counter() - t) * 1e3
    finally:
        for u in undo:
            u()
    ps_mib = snap.meta["ps_bytes"] / 2**20

    rebuilt, rebuilt_store, _ = bench_train_ctx(dev, "native", [], sd)
    t = time.perf_counter()
    m = rebuilt.resume(job, restore_ps=True)
    resume_s = time.perf_counter() - t
    restored = rebuilt.last_resume_info["ps_entries_restored"]
    same = (m.step == snap.step and restored == rows
            and train_state_to_flax_bytes(rebuilt.state) == train_state_to_flax_bytes(filled.state)
            and all(filled_store.dump_shard(i) == rebuilt_store.dump_shard(i)
                    for i in range(filled_store.num_internal_shards)))
    print(f"  at fill: {loaded} synthetic rows loaded in {fill_s:.2f} s, {rows} rows after a step "
          f"({100 * rows / capacity:.1f} % of {capacity}); snapshot {snap_ms:.1f} ms (PS capture "
          f"{parts['ps_capture'][0]:.1f}, dense bytes {parts['dense_bytes'][0]:.1f}, commit {parts['commit'][0]:.1f}) "
          f"for {ps_mib:.1f} MiB of PS bytes, {parts['ps_capture'][0] / ps_mib:.3f} ms a MiB; rewind resume "
          f"{resume_s:.3f} s, {resume_s * 1e3 / ps_mib:.3f} ms a MiB, {restored} entries; dumps and dense bytes "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not same:
        raise SystemExit("durable state: the filled store's rewind resume differs from its snapshot")
    return {"rows": rows, "capacity": capacity, "fill_load_s": fill_s, "snapshot_ms": snap_ms,
            "ps_capture_ms": parts["ps_capture"][0], "dense_bytes_ms": parts["dense_bytes"][0],
            "commit_ms": parts["commit"][0], "ps_bytes": snap.meta["ps_bytes"],
            "ps_capture_ms_per_mib": parts["ps_capture"][0] / ps_mib, "time_to_resume_s": resume_s,
            "resume_ms_per_mib": resume_s * 1e3 / ps_mib, "ps_entries_restored": restored}


K4_SOURCE, K4_REPLACES = "persia_tpu_torch/csrc/fused_gather.cu", "persia_tpu/parallel/fused_step.py:242"
K5_SOURCE, K5_REPLACES = "persia_tpu_torch/csrc/sparse_update.cu", "persia_tpu/ops/sparse_update.py:123"
ROUTING_REPLACES = "persia_tpu/parallel/fused_step.py:389"


def same_bits(a, b) -> bool:
    """Bit-for-bit equality of two tensors (NaNs included)."""
    import torch

    a, b = a.detach().reshape(-1), b.detach().reshape(-1)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.cpu().view(torch.uint8), b.cpu().view(torch.uint8))


def fused_ids(rng, kind, n, vocab):
    """n ids in [0, vocab): uniform, zipf(1.2) (rank 1 at id 0) or one row."""
    if kind == "uniform":
        ids = rng.integers(0, vocab, n)
    elif kind == "zipf":
        ids = (rng.zipf(1.2, n) - 1) % vocab
    else:
        ids = np.full(n, vocab // 3)
    return ids.astype(np.int32)


def k5_lengths(n):
    """K5's chosen segment lengths: hot rows (as many positions as zipf(1.2)'s
    hottest rows of a bench slot hold) and the long threshold - 1, at it and
    + 1; segments ending on a staged tile's edge (1 and 2 tiles) and one
    row past it."""
    from persia_tpu_torch.ops import plans

    t, rows = plans.K5_LONG_MIN, plans.sparse_update_plan(n, EMB_DIM).tile_rows
    return {"hot": (762, 318, 180, t + 1, t, t - 1), "tile_edge": (rows, 2 * rows, rows + 1, 3 * rows)}


def k5_ids(rng, kind, n, vocab):
    """n ids for K5's exact check and the positions padding may not take:
    ``fused_ids``' streams, or (``k5_lengths``) uniform ids with rows of
    chosen lengths at random positions past the first 3."""
    keep = np.zeros(n, bool)
    if kind not in ("hot", "tile_edge"):
        return fused_ids(rng, kind, n, vocab), keep
    ids = rng.integers(0, vocab // 2, n).astype(np.int32)
    where = rng.permutation(n - 3) + 3
    k = 0
    for i, length in enumerate(k5_lengths(n)[kind]):
        ids[where[k:k + length]] = vocab // 2 + i  # rows the uniform ids never name
        keep[where[k:k + length]] = True
        k += length
    return ids, keep


def longest_segment(sids) -> int:
    """Positions of the longest run of one row among sorted ids (the
    padding sentinel's run left out)."""
    import torch

    from persia_tpu_torch.ops.sparse_update import PAD_SENTINEL

    live = sids[sids != PAD_SENTINEL]
    return int(torch.unique_consecutive(live, return_counts=True)[1].max()) if live.numel() else 0


def phase_fused_kernels(dev):
    """Phase 3b: K4, the routing and K5 against their plain versions at
    bench shapes."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.embedding.optim import SGD, Adagrad, Adam
    from persia_tpu_torch.ops.fused_gather import fused_gather_reference
    from persia_tpu_torch.ops.sparse_update import (
        init_sparse_state, sparse_update_reference, update_keys_reference,
    )

    print("== phase 3b: fused-tier kernels vs their plain versions", flush=True)
    rng = np.random.default_rng(SEED + 5)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def slot_ids(kind, shape, vocab=VOCAB):
        ids = fused_ids(rng, kind, int(np.prod(shape)), vocab)
        ids[rng.random(ids.size) < 0.05] = -1  # padding
        ids[:5] = vocab + np.array([0, 1, 2, -1, 1 << 30])  # past the slot's vocab, its last row, far past it
        return torch.from_numpy(ids.reshape(shape)).to(dev)

    # K4 copies rows: it must equal its plain version bit for bit (NaNs too),
    # with and without the update keys; the keys (integers) bit for bit the
    # plain routing
    table = torch.randn((N_SLOTS * VOCAB, EMB_DIM), device=dev, generator=g)
    offsets = [s * VOCAB for s in range(N_SLOTS)]
    narrow = torch.randn((3 * 1000, 10), device=dev, generator=g)
    cases = [
        ("bench: 26 stacked slots, uniform", table, [slot_ids("uniform", (BATCH,)) for _ in range(N_SLOTS)],
         offsets, VOCAB, True),
        ("bench: 26 stacked slots, zipf(1.2)", table, [slot_ids("zipf", (BATCH,)) for _ in range(N_SLOTS)],
         offsets, VOCAB, True),
        ("bf16 table, 3 single-id slots and a pooled (B, 5) slot", table[:4 * VOCAB].to(torch.bfloat16),
         [slot_ids("uniform", (BATCH,)) for _ in range(3)] + [slot_ids("zipf", (BATCH, 5))], offsets[:4], VOCAB,
         True),
        ("unstacked f32 (NaN past the vocab)", table[:VOCAB], [slot_ids("uniform", (BATCH,))], [0], VOCAB, False),
        ("unstacked bf16 (B, 3)", table[:VOCAB].to(torch.bfloat16), [slot_ids("zipf", (BATCH, 3))], [0], VOCAB,
         False),
        ("dim 10 (4-byte vectors), 3 slots", narrow, [slot_ids("uniform", (777,), 1000) for _ in range(3)],
         [0, 1000, 2000], 1000, True),
    ]
    for label, tbl, ids, offs, vocab, stacked in cases:
        vocabs = [vocab] * len(ids)
        out = ops.fused_gather(tbl, ids, offs, vocabs, stacked)
        rows, keys = ops.fused_gather(tbl, ids, offs, vocabs, stacked, keys=True)
        ref = fused_gather_reference(tbl, ids, offs, vocabs, stacked)
        ref_keys = update_keys_reference(ids, offs, vocabs)
        torch.cuda.synchronize()
        ok = same_bits(out, ref) and same_bits(rows, ref) and same_bits(keys, ref_keys)
        print(f"  fused_gather {label}: {out.shape[0]} rows ({int(out.isnan().any(1).sum())} NaN), with and "
              f"without keys; {keys.numel()} keys ({int((keys == 2 ** 31 - 1).sum())} at the sentinel): "
              f"max_abs_err=0 tolerance=0 (bitwise) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"fused_gather {label} disagrees with its plain version (rows or keys)")
    del table, cases

    # the standalone routing (the graph step's warm-up): integers, bit for
    # bit its plain version (the per-slot update_ids, on the card): the
    # bench's 26 slots with pads, ids past the vocab and ids < -1, and 130
    # slots (two launches) with (B, 3) slots
    def routed(nslots, shape, vocab):
        ids = [torch.from_numpy(rng.integers(-4, vocab + 4, shape).astype(np.int32)).to(dev)
               for _ in range(nslots)]
        return ids, [s * vocab for s in range(nslots)], [vocab] * nslots

    for label, (ids, offs, vocabs) in (("bench: 26 slots of B=4096", routed(N_SLOTS, (BATCH,), VOCAB)),
                                       ("130 slots of (64, 3)", routed(130, (64, 3), 1000))):
        out = ops.update_keys(ids, offs, vocabs)
        ok = same_bits(out, update_keys_reference(ids, offs, vocabs))
        torch.cuda.synchronize()
        print(f"  update_keys {label}: {out.numel()} keys ({int((out == 2 ** 31 - 1).sum())} at the sentinel): "
              f"max_abs_err=0 tolerance=0 (bitwise) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"update_keys {label} disagrees with its plain version")

    # K5 sums each row's gradients in sorted order, as the plain version on
    # the CPU does (index_add_ in index order), and rounds every operation
    # once, as the plain version does: the two must agree bit for bit. The
    # plain version on the card sums with index_add_'s atomics, in another
    # order: its difference is printed, not held
    n = N_SLOTS * BATCH
    adagrad = Adagrad(lr=0.05).config
    k5 = [("bench: 26 stacked slots of 1M, Adagrad(0.05), uniform", adagrad, "uniform", True, torch.float32),
          ("bench: 26 stacked slots of 1M, Adagrad(0.05), zipf(1.2)", adagrad, "zipf", True, torch.float32),
          ("bf16 table, Adagrad(0.05), zipf(1.2)", adagrad, "zipf", False, torch.bfloat16)]
    for name, opt in (("SGD(0.1, wd 0.01)", SGD(lr=0.1, weight_decay=0.01)),
                      ("Adagrad(0.05, momentum 0.95, wd 0.01)",
                       Adagrad(lr=0.05, g_square_momentum=0.95, weight_decay=0.01)),
                      ("Adagrad vectorwise(0.05, wd 0.01)", Adagrad(lr=0.05, vectorwise_shared=True, weight_decay=0.01)),
                      ("Adam(0.01, wd 0.1 ignored), powers at t=3", Adam(lr=0.01, weight_decay=0.1))):
        for kind in ("uniform", "zipf", "one_row", "hot", "tile_edge"):
            k5.append((f"{name}, {kind}", opt.config, kind, False, torch.float32))
    errs = {"fused_gather": 0.0, "update_keys": 0.0}
    for label, cfg, kind, bench, dtype in k5:
        vocab = N_SLOTS * VOCAB if bench else VOCAB
        keep = np.zeros(n, bool)
        if bench:  # each slot's ids in its own rows of the stacked table
            ids = np.concatenate([fused_ids(rng, kind, BATCH, VOCAB) + s * VOCAB for s in range(N_SLOTS)])
        else:
            ids, keep = k5_ids(rng, kind, n, vocab)
        ids[(rng.random(n) < 0.05) & ~keep] = -1  # masked padding
        ids[:3] = vocab + 1  # live past the table: dropped
        idt = torch.from_numpy(ids.astype(np.int32)).to(dev)
        mask = idt >= 0
        grads = torch.randn((n, EMB_DIM), device=dev, generator=g) * 0.1
        tbl = (torch.randn((vocab, EMB_DIM), device=dev, generator=g) * 0.05).to(dtype)
        st = init_sparse_state(cfg, vocab, EMB_DIM, device=dev)
        for k, v in st.items():
            v.uniform_(0.01, 1.0, generator=g)
        bs = torch.tensor([cfg.beta1 ** 3, cfg.beta2 ** 3], dtype=torch.float32, device=dev)
        cpu_tbl, cpu_st = tbl.cpu(), {k: v.cpu() for k, v in st.items()}
        plain_tbl, plain_st = tbl.clone(), {k: v.clone() for k, v in st.items()}
        ops.sparse_update(cfg, tbl, st, idt, grads, bs, mask=mask)
        sparse_update_reference(cfg, plain_tbl, plain_st, idt, grads, bs, mask=mask)
        sparse_update_reference(cfg, cpu_tbl, cpu_st, idt.cpu(), grads.cpu(), bs.cpu(), mask=mask.cpu())
        torch.cuda.synchronize()
        ok = same_bits(tbl, cpu_tbl) and all(same_bits(st[k], cpu_st[k]) for k in st)
        err = max([float((tbl.cpu().float() - cpu_tbl.float()).abs().max())]
                  + [float((st[k].cpu() - cpu_st[k]).abs().max()) for k in st])
        card_err = max([float((tbl.float() - plain_tbl.float()).abs().max())]
                       + [float((st[k] - plain_st[k]).abs().max()) for k in st])
        rows = int(torch.unique(idt[mask & (idt < vocab)]).numel())
        longest = longest_segment(torch.sort(idt[mask & (idt < vocab)])[0])
        print(f"  sparse_update {label}: {rows} rows touched, longest segment {longest}; vs the plain version on "
              f"the CPU: max_abs_err="
              f"{err:.3e} tolerance=0 (bitwise) {'ok' if ok else 'FAIL'}; vs the plain version on the card "
              f"(index_add_ atomics): {card_err:.3e}", flush=True)
        if not ok:
            raise SystemExit(f"sparse_update {label} disagrees with its plain version")
        errs.setdefault("sparse_update", err)
        del tbl, st, cpu_tbl, cpu_st, plain_tbl, plain_st
    torch.cuda.empty_cache()
    return errs


FUSED_HOST_BATCHES, FUSED_CHECK, FUSED_TIMED, FUSED_SYNCED, FUSED_PROFILED, FUSED_PIPE = 8, 5, 100, 40, 8, 32
# card against CPU after 3 fused steps, |delta_card - delta_cpu| / |delta_cpu|
# over the touched rows: both run DLRM in bf16, whose roundings differ, and
# read 7.2e-2 on the H100 (the accumulators do not move: Adagrad's 0.01
# start absorbs g^2 ~ 1e-10); twice that still fails an update that did
# nothing (1), half the step (0.5) or the wrong sign (2)
FUSED_DELTA_RTOL = 0.15


def fused_host_batches(seed, n, kind="uniform"):
    """The bench's fused batches (``bench.py:122-139``): for each slot in
    sorted order B int32 ids, uniform in [0, VOCAB) (or zipf(1.2) with a
    per-slot shift), then normal dense features and 0/1 labels."""
    rng = np.random.default_rng(seed)
    names = sorted(f"cat_{i}" for i in range(N_SLOTS))
    shift = dict(zip(names, rng.integers(0, VOCAB, N_SLOTS)))
    out = []
    for _ in range(n):
        if kind == "uniform":
            ids = {nm: rng.integers(0, VOCAB, BATCH, dtype=np.int32) for nm in names}
        else:
            ids = {nm: ((rng.zipf(1.2, BATCH) - 1 + shift[nm]) % VOCAB).astype(np.int32) for nm in names}
        dense = rng.normal(size=(BATCH, N_DENSE)).astype(np.float32)
        labels = rng.integers(0, 2, (BATCH, 1)).astype(np.float32)
        out.append({"dense": [dense], "labels": [labels], "ids": ids})
    return out


def check_launches(path, launches, expected):
    if launches != expected:
        raise SystemExit(f"{path}: launches {launches}, expected {expected}")


def fused_state_tensors(state):
    """Every tensor a fused step updates."""
    out = [p for p in state.model.parameters()]
    for st in state.optimizer.state.values():
        out.extend(v for v in st.values() if hasattr(v, "data_ptr"))
    out.extend(state.tables.values())
    for st in state.emb_state.values():
        out.extend(st.values())
    return out + [state.emb_batch_state, state.step]


def path_fused(dev):
    """Phase 4e: the fused all-on-card tier at bench width
    (``bench.py:100-221``): ``build_fused_train_step`` as a CUDA-graph
    step and eagerly, and ``FusedTrainCtx.train_pipelined``."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.fused_ctx import FusedTrainCtx
    from persia_tpu_torch.parallel.fused_step import (
        FusedSlotSpec, build_fused_train_step, fused_batch_to_device, group_stacked_specs, init_fused_state,
    )
    from persia_tpu_torch.weights import fused_state_from_flax, fused_state_to_flax

    print(f"== phase 4e: fused training (26 stacked tables of 1M x 16 on the card, B={BATCH}, "
          f"build_fused_train_step)", flush=True)
    specs = {f"cat_{i}": FusedSlotSpec(vocab=VOCAB, dim=EMB_DIM) for i in range(N_SLOTS)}
    cfg = Adagrad(lr=0.05).config
    (group,) = group_stacked_specs(specs, sorted(specs))

    def new_model(device):
        m = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device=device,
                 generator=torch.Generator().manual_seed(SEED))
        return m, torch.optim.Adam(m.parameters(), lr=1e-3)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_fused_state(*new_model(dev), torch.Generator().manual_seed(SEED), specs, cfg, stack=True,
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host = fused_host_batches(SEED + 30, FUSED_HOST_BATCHES)
    zipf_host = fused_host_batches(SEED + 31, FUSED_HOST_BATCHES, "zipf")
    graph_step = build_fused_train_step(cfg, specs, stack=True, jit=True)
    eager_step = build_fused_train_step(cfg, specs, stack=True, jit=False)

    def on_card(h):
        return fused_batch_to_device(h, dev)

    # the graph step against the eager step, FUSED_CHECK steps from one
    # state, bit for bit; the rows the first steps touch kept for the CPU
    manifest, arrays0 = fused_state_to_flax(state)
    twin = fused_state_from_flax(manifest, arrays0, *new_model(dev), device=dev)
    touched = torch.from_numpy(np.unique(np.concatenate(
        [h["ids"][nm] + off for h in host[:TRAIN_CPU_STEPS] for nm, off in zip(group.slots, group.offsets)])))

    def touched_rows(st):
        return st.tables[group.name][touched.to(st.tables[group.name].device)].cpu()

    init_rows = touched_rows(state)
    g_losses, e_losses = [], []
    for i in range(FUSED_CHECK):
        b = on_card(host[i % FUSED_HOST_BATCHES])
        if i == 0:  # the graph step's capture, counted: its warm-up and the capture go through the wrappers
            ops.reset_launch_counts()
        state, (loss, _) = graph_step(state, b)
        if i == 0:
            capture_launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
            expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
            # K4 routes the step's update ids; update_keys only in the warm-up
            expected.update(dot_interaction=2, dot_interaction_bwd=2, fused_gather=2, update_keys=1, sparse_update=2)
            print(f"  graph step's capture (warm-up and capture): launches={capture_launches}", flush=True)
            check_launches("fused path (graph step's capture)", capture_launches, expected)
        twin, (loss2, _) = eager_step(twin, b)
        g_losses.append(loss)
        e_losses.append(loss2)
        if i + 1 == TRAIN_CPU_STEPS:
            card_rows = touched_rows(state)
    torch.cuda.synchronize()
    same = same_bits(torch.stack(g_losses), torch.stack(e_losses)) and all(
        same_bits(a, c) for a, c in zip(fused_state_tensors(state), fused_state_tensors(twin)))
    g_losses = torch.stack(g_losses).cpu().tolist()
    print(f"  graph step vs eager step, {FUSED_CHECK} steps from one state: losses {g_losses}; losses, "
          f"tables, optimizer states and parameters bitwise {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise SystemExit("fused path: the graph step and the eager step disagree")

    # the same first steps on the CPU from a copy of the initial state
    cpu_state = fused_state_from_flax(manifest, arrays0, *new_model("cpu"), device="cpu")
    del arrays0
    cpu_step = build_fused_train_step(cfg, specs, stack=True)
    cpu_losses = []
    for h in host[:TRAIN_CPU_STEPS]:
        cpu_losses.append(float(cpu_step(cpu_state, fused_batch_to_device(h, "cpu"))[1][0]))
    loss_err = max(abs(a - c) for a, c in zip(g_losses, cpu_losses))
    cpu_rows = touched_rows(cpu_state)
    row_err = float((card_rows - cpu_rows).abs().max())
    # what the steps changed in the rows, card against CPU: the norm of the
    # difference of the deltas over the norm of the CPU's delta (an update
    # that did nothing reads 1, one that zeroed the rows far more)
    delta_max = float((cpu_rows - init_rows).abs().max())
    delta_err = float((card_rows - cpu_rows).norm() / (cpu_rows - init_rows).norm())
    ok = loss_err <= 2e-2 and row_err <= 1e-2 and delta_err <= FUSED_DELTA_RTOL
    print(f"  first {TRAIN_CPU_STEPS} losses card {g_losses[:TRAIN_CPU_STEPS]} cpu {cpu_losses}: "
          f"max_abs_err={loss_err:.3e} tolerance=2e-2; the {touched.numel()} rows they touched: "
          f"max_abs_err={row_err:.3e} tolerance=1e-2; their deltas (largest {delta_max:.3e}): "
          f"|card - cpu| / |cpu| = {delta_err:.3e} tolerance={FUSED_DELTA_RTOL:g} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit("fused path: card and CPU disagree")
    del cpu_state, card_rows, cpu_rows, init_rows

    def run(step, st, stream, n, synced=None):
        """n steps over the host batches (staged each step, as the bench
        stages them), then a synchronize; returns (state, seconds,
        losses). ``synced`` gets each step's ms with a synchronize after
        it."""
        losses = []
        t = time.perf_counter()
        for i in range(n):
            t1 = time.perf_counter()
            st, (loss, _) = step(st, on_card(stream[i % len(stream)]))
            losses.append(loss)
            if synced is not None:
                torch.cuda.synchronize()
                synced.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t, torch.stack(losses).cpu().numpy()

    state, wall, losses = run(graph_step, state, host, FUSED_TIMED)
    print(f"  graph step: {FUSED_TIMED} steps in {wall * 1e3:.1f} ms, {FUSED_TIMED * BATCH / wall:.1f} samples/s",
          flush=True)
    synced = []
    state, _, more = run(graph_step, state, host, FUSED_SYNCED, synced)
    # the main path as the wrappers count it: a graph replay goes through
    # no wrapper, so the counted run is the eager step's (the graph step's
    # kernels are counted on the card, from the trace, below)
    ops.reset_launch_counts()
    twin, e_wall, e_losses = run(eager_step, twin, host, FUSED_TIMED)
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(dot_interaction=FUSED_TIMED, dot_interaction_bwd=FUSED_TIMED,
                    fused_gather=FUSED_TIMED, sparse_update=FUSED_TIMED)
    print(f"  eager step: {FUSED_TIMED} steps, launches={launches}", flush=True)
    check_launches("fused path (eager step)", launches, expected)
    e_synced = []
    twin, _, _ = run(eager_step, twin, host, FUSED_SYNCED, e_synced)
    state, z_wall, z_losses = run(graph_step, state, zipf_host, FUSED_TIMED)
    all_losses = np.concatenate([losses, more, e_losses, z_losses])
    if not np.isfinite(all_losses).all():
        raise SystemExit("fused path: a non-finite loss")
    print(f"  eager step: {FUSED_TIMED * BATCH / e_wall:.1f} samples/s; graph step on zipf(1.2) ids: "
          f"{FUSED_TIMED * BATCH / z_wall:.1f} samples/s; synced step p50 graph "
          f"{np.percentile(synced, 50):.3f} ms (longest {max(synced):.3f}), eager "
          f"{np.percentile(e_synced, 50):.3f} ms (longest {max(e_synced):.3f})", flush=True)
    # where the eager step's host time goes: PyTorch's operators by their
    # own CPU time over 3 steps (torch.profiler), ms a step
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        twin, _, _ = run(eager_step, twin, host, 3)
    eager_cpu = {e.key[:60]: e.self_cpu_time_total / 1e3 / 3 for e in sorted(
        prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]}
    print(f"  eager step, host CPU ms a step by operator: {eager_cpu}", flush=True)
    del twin
    torch.cuda.empty_cache()

    # the card's own time a step (torch.profiler), and the kernels' runs;
    # then the same with the update ids routed by the standalone kernel
    # after K4 without keys (the step before the routing moved into K4), in
    # turns: new, standalone, new
    from persia_tpu_torch.parallel import fused_step as fused_step_module

    def standalone_routing(table, ids, offsets, vocabs, stacked=True, keys=False):
        rows = ops.fused_gather(table, ids, offsets, vocabs, stacked)
        return (rows, ops.update_keys(ids, offsets, vocabs)) if keys else rows

    prof_batches = [on_card(h) for h in host]
    step_ms = wall / FUSED_TIMED * 1e3

    def traced(step):
        """The graph steps over ``prof_batches``, traced until the trace
        holds every replay whole. A trace can lose device records, a
        replay's all of them too; a graph's replays run the same kernels,
        so a trace with fewer replays than steps, or with replays that
        differ, lost records: it is taken again (three traces at most).
        A fault of the step shows in every replay and is not retraced."""
        for attempt in range(1, 4):
            busy_, top_, runs_ = device_busy_ms(lambda b: step(state, b), prof_batches)
            replays = runs_["replays"]
            if len(replays) == len(prof_batches) and replays[0]["events"] and all(r == replays[0] for r in replays):
                return busy_, top_, runs_, runs_["elementwise"] / len(prof_batches)
            print(f"  trace {attempt} of the graph steps lost device records: {len(replays)} graph launches "
                  f"for {len(prof_batches)} steps, device events a launch {[r['events'] for r in replays]}",
                  flush=True)
        raise SystemExit("fused path: three traces of the graph steps each lost device records")

    def kernel_runs(runs_):
        return {"fused_gather": runs_["fused_gather_kernel"], "update_keys": runs_["update_keys_kernel"],
                **{k: runs_[k] for k in K5_KERNELS},
                "dot_interaction": runs_["dot_interaction_kernel"] + runs_["dot_interaction_mma_kernel"],
                "dot_interaction_bwd": runs_["dot_interaction_bwd_kernel"] + runs_["dot_interaction_bwd_mma_kernel"]}

    busy, top, runs, elementwise = traced(graph_step)
    fused_step_module.fused_gather = standalone_routing
    try:
        standalone_step = build_fused_train_step(cfg, specs, stack=True, jit=True)
        standalone_step(state, prof_batches[0])  # captured with the standalone routing kernel
    finally:
        fused_step_module.fused_gather = ops.fused_gather
    busy_alone, _, runs_alone, elementwise_alone = traced(standalone_step)
    busy2, _, runs2, elementwise2 = traced(graph_step)
    del standalone_step
    graph_runs, graph_runs2, alone_runs = kernel_runs(runs), kernel_runs(runs2), kernel_runs(runs_alone)
    print(f"  card busy {busy} ms of a {step_ms:.3f} ms graph step; top kernels {top}; kernel runs on the card "
          f"in {len(prof_batches)} graph steps (trace): {graph_runs}", flush=True)
    print(f"  routing in K4 vs by the standalone kernel, card busy a graph step: {busy} and {busy2} ms vs "
          f"{busy_alone} ms; PyTorch elementwise kernels a step: {elementwise} and {elementwise2} vs "
          f"{elementwise_alone}; kernel runs (trace) {graph_runs2} vs {alone_runs}", flush=True)
    per_step = dict.fromkeys(graph_runs, len(prof_batches))
    check_launches("fused path (graph step, traced)", graph_runs, {**per_step, "update_keys": 0})
    check_launches("fused path (graph step, traced again)", graph_runs2, {**per_step, "update_keys": 0})
    check_launches("fused path (graph step, standalone routing, traced)", alone_runs, per_step)

    # FusedTrainCtx.train_pipelined (depth 2, k=1) over FUSED_PIPE batches
    def persia_batch(h):
        ids = [IDTypeFeatureWithSingleID(nm, h["ids"][nm].astype(np.uint64)) for nm in sorted(h["ids"])]
        return PersiaBatch(ids, non_id_type_features=[NonIDTypeFeature(h["dense"][0])],
                           labels=[Label(h["labels"][0])], requires_grad=True)

    pbatches = [persia_batch(host[i % FUSED_HOST_BATCHES]) for i in range(FUSED_PIPE + 2)]
    ctx = FusedTrainCtx(*new_model(dev), Adagrad(lr=0.05), specs, stack=True, seed=SEED, device=dev)
    ctx.train_pipelined(pbatches[:2], pipeline_depth=2)  # builds the tables and captures the step
    t = time.perf_counter()
    m = ctx.train_pipelined(pbatches[2:], pipeline_depth=2, dispatch_k=1)
    pipe_wall = time.perf_counter() - t
    pipe_stats = ctx.pipeline_stats()
    if len(m["losses"]) != FUSED_PIPE or not np.isfinite(m["losses"]).all():
        raise SystemExit(f"fused path: pipelined losses {m.get('losses')}")
    print(f"  train_pipelined (depth 2, k=1), {FUSED_PIPE} batches: {FUSED_PIPE * BATCH / pipe_wall:.1f} "
          f"samples/s; {pipe_stats}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    del ctx

    fused = {
        "batch": BATCH, "slots": N_SLOTS, "vocab_per_slot": VOCAB, "dim": EMB_DIM, "stacked": True,
        "sparse_optimizer": "Adagrad(lr=0.05)", "dense_optimizer": "Adam(lr=1e-3)",
        "table_init_s": init_s, "peak_device_bytes": peak,
        "graph_equals_eager_steps": FUSED_CHECK,
        "loss_max_abs_err_vs_cpu": loss_err, "row_max_abs_err_vs_cpu": row_err, "rows_compared": touched.numel(),
        "row_delta_rel_err_vs_cpu": delta_err, "row_delta_max": delta_max, "delta_rel_tolerance": FUSED_DELTA_RTOL,
        "eager_step_launches": {k: launches[k] for k in ("fused_gather", "update_keys", "sparse_update",
                                                         "dot_interaction", "dot_interaction_bwd")},
        "graph_capture_launches": {k: capture_launches[k] for k in ("fused_gather", "update_keys", "sparse_update",
                                                                    "dot_interaction", "dot_interaction_bwd")},
        "graph_step_kernel_runs_traced": graph_runs, "traced_graph_steps": len(prof_batches),
        "standalone_routing_graph_step_kernel_runs_traced": alone_runs,
        "graph_samples_per_s": FUSED_TIMED * BATCH / wall, "graph_step_ms_mean": step_ms,
        "eager_samples_per_s": FUSED_TIMED * BATCH / e_wall,
        "zipf_graph_samples_per_s": FUSED_TIMED * BATCH / z_wall,
        "timed_steps": FUSED_TIMED,
        "graph_step_ms_p50_synced": float(np.percentile(synced, 50)), "graph_step_ms_max_synced": max(synced),
        "eager_step_ms_p50_synced": float(np.percentile(e_synced, 50)), "eager_step_ms_max_synced": max(e_synced),
        "graph_step_device_busy_ms": busy, "graph_step_device_busy_ms_runs": [busy, busy2],
        "graph_step_elementwise_kernels": elementwise,
        "standalone_routing_graph_step_device_busy_ms": busy_alone,
        "standalone_routing_graph_step_elementwise_kernels": elementwise_alone,
        "graph_step_idle_share": None if busy is None else 1 - busy / step_ms,
        "graph_step_top_kernels_ms": top, "eager_step_top_cpu_ms": eager_cpu,
        "pipelined_samples_per_s": FUSED_PIPE * BATCH / pipe_wall, "pipelined_batches": FUSED_PIPE,
        "pipelined_stats": pipe_stats,
        "losses_first": g_losses, "loss_last": float(all_losses[-1]),
    }
    inputs = {"table": state.tables[group.name], "state": state.emb_state[group.name], "group": group,
              "cfg": cfg, "batch": on_card(host[0]), "zipf_batch": on_card(zipf_host[0])}
    return launches, capture_launches, fused, inputs


# ---------------------------------------------------------------------------
# DIN on Taobao (examples/taobao_din/train.py) and DeepFM / DCN-v2 on Avazu
# (examples/avazu/train.py): phases 3c, 4g, 4h and 4i


def raw_inputs(dev, dtype, seed, case, batch=DIN_BATCH, hist=DIN_HIST, distinct=(26_000, 9_000)):
    """A raw group at the DIN path's shape: per slot ``d`` distinct rows of
    dim 16 (P = round_up_pow2(d + 1), rows past d zero) and a (B, L) index
    with Taobao's history lengths (1..L valid positions, pads at P - 1),
    sample 0 with no history and sample 1 with a full one ("taobao"), or
    every position on one row ("one_row"); with each slot's CSR (that of
    the package imported, ``ops.raw_csr``'s arrays in order)."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.utils import round_up_pow2

    rng = np.random.default_rng(seed)
    rows, slots = [], []
    for d in distinct:
        p = round_up_pow2(d + 1)
        r = np.zeros((p, DIN_DIM), np.float32)
        r[:d] = rng.standard_normal((d, DIN_DIM))
        if case == "one_row":
            index = np.full((batch, hist), 3, np.int32)
        else:
            lengths = rng.integers(1, hist + 1, batch)
            lengths[0], lengths[1] = 0, hist
            index = np.where(np.arange(hist)[None, :] < lengths[:, None], rng.integers(0, d, (batch, hist)),
                             p - 1).astype(np.int32)
        rows.append(torch.from_numpy(r).to(dev, dtype))
        slots.append(ops.RawSlot(*(torch.from_numpy(a).to(dev) for a in (index, *ops.raw_csr(index, p)))))
    return rows, slots


def raw_bwd_tolerance(grad, rows, slots, dtype):
    """Per element: twice the f32 sum-order bound of its row's n terms (the
    kernel sums a row in its fixed tree order, index_add_ in stream order),
    then one rounding: 1e-6 relative in f32, one bf16 ulp (2^-8) in bf16."""
    from persia_tpu_torch.ops.raw_gather import raw_gather_bwd_reference

    abs_sums = raw_gather_bwd_reference(grad.abs().float(), [r.float() for r in rows], slots)
    rtol = 1e-6 if dtype == np.float32 else 2 ** -8
    return rtol, [2 * (s.offsets[1:] - s.offsets[:-1]).float()[:, None] * 2 ** -24 * a
                  for s, a in zip(slots, abs_sums)]


def raw_schedule_bits(grad, slots, dtype):
    """K7's sums by ``plans.raw_bwd_model`` (its order, in numpy) for each
    slot, rounded to ``dtype``, as bits on the CPU."""
    import torch

    from persia_tpu_torch.ops import plans

    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    return [torch.from_numpy(plans.raw_bwd_model(g.reshape(-1, g.shape[-1]).float().cpu().numpy(),
                                                 s.order.cpu().numpy(), s.offsets.cpu().numpy())).to(dtype).view(bits)
            for g, s in zip(grad, slots)]


def att_inputs(dev, dtype, seed, batch=DIN_BATCH, hist=DIN_HIST, dim=DIN_DIM, prefix=True):
    """K8/K9's inputs, by default at the DIN path's shape: f32 logits,
    Taobao's masks (a valid prefix; ``prefix=False``: each position valid
    with probability 1/2), sample 0 with no history, sample 1 a full one,
    history rows zero at the pads, the pooled rows' gradient."""
    import torch

    rng = np.random.default_rng(seed)
    if prefix:
        lengths = rng.integers(1, hist + 1, batch)
        lengths[0], lengths[1] = 0, hist
        mask = np.arange(hist)[None, :] < lengths[:, None]
    else:
        mask = rng.random((batch, hist)) < 0.5
        mask[0], mask[1] = False, True
    h = rng.standard_normal((batch, hist, dim)).astype(np.float32)
    h[~mask] = 0.0
    logits = (2 * rng.standard_normal((batch, hist))).astype(np.float32)
    d_out = rng.standard_normal((batch, dim)).astype(np.float32)
    return (torch.from_numpy(logits).to(dev), torch.from_numpy(mask).to(dev), torch.from_numpy(h).to(dev, dtype),
            torch.from_numpy(d_out).to(dev, dtype))


def phase_din_kernels(dev):
    """Phase 3c: K6-K9 against their plain versions on the card."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.attention_pool import attention_pool_bwd_reference, attention_pool_fwd_reference
    from persia_tpu_torch.ops.raw_gather import raw_gather_bwd_reference, raw_gather_fwd_reference
    from persia_tpu_torch.testing.envelopes import attention_pool_bwd_envelope, attention_pool_fwd_envelope

    print(f"== phase 3c: DIN kernels vs their plain versions (B={DIN_BATCH}, L={DIN_HIST}, dim {DIN_DIM})",
          flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    errs = {}
    for dtype, ndt in ((torch.bfloat16, None), (torch.float32, np.float32)):
        name = str(dtype)[6:]
        for case in ("taobao", "one_row"):
            rows, slots = raw_inputs(dev, dtype, SEED + len(case), case)
            out = ops.raw_gather_fwd(rows, slots)
            grad = torch.randn(out.shape, generator=g).to(dev, dtype)
            grads = ops.raw_gather_bwd(grad, rows, slots)
            again = ops.raw_gather_bwd(grad, rows, slots)
            torch.cuda.synchronize()
            label = f"raw_gather {case} {name} {list(out.shape)}"
            same = torch.equal(out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                               raw_gather_fwd_reference(rows, slots).view(
                                   torch.int16 if dtype == torch.bfloat16 else torch.int32))
            print(f"  {label} fwd: bitwise {'ok' if same else 'FAIL'}", flush=True)
            if not same:
                raise SystemExit("raw_gather_fwd disagrees with its plain version")
            errs.setdefault(("raw_fwd", dtype), 0.0)
            rtol, extra = raw_bwd_tolerance(grad, rows, slots, ndt)
            err = check_close(f"{label} bwd", torch.cat(grads), torch.cat(raw_gather_bwd_reference(grad, rows, slots)),
                              rtol, torch.cat(extra) + 1e-30)
            errs.setdefault(("raw_bwd", dtype), err)
            twice = all(torch.equal(a, b) for a, b in zip(grads, again))
            print(f"  {label} bwd twice: bitwise {'ok' if twice else 'FAIL'}", flush=True)
            if not twice:
                raise SystemExit("raw_gather_bwd is not deterministic")
            # K7's own order (plans.raw_bwd_model), both slots; where no row
            # is long (the Taobao histories) that is the plain version's
            # stream order, run on the CPU; the pad row zero
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            sched = all(torch.equal(got.cpu().view(bits), want)
                        for got, want in zip(grads, raw_schedule_bits(grad, slots, dtype)))
            print(f"  {label} bwd vs its schedule (plans.raw_bwd_model): bitwise {'ok' if sched else 'FAIL'}",
                  flush=True)
            if not sched:
                raise SystemExit("raw_gather_bwd does not follow its schedule")
            if case == "taobao":
                if any(s.long_chunks.numel() for s in slots):
                    raise SystemExit("the Taobao histories were to have no long row")
                cpu = raw_gather_bwd_reference(grad.cpu(), [r.cpu() for r in rows],
                                               [ops.RawSlot(*(t.cpu() for t in s)) for s in slots])
                plain = all(torch.equal(a.cpu().view(bits), b.view(bits)) for a, b in zip(grads, cpu))
                print(f"  {label} bwd vs the plain version on the CPU: bitwise {'ok' if plain else 'FAIL'}",
                      flush=True)
                if not plain:
                    raise SystemExit("raw_gather_bwd disagrees with its plain version's stream order")
            if any(bool(got[-1].any()) for got in grads):
                raise SystemExit("raw_gather_bwd wrote the pad row")
        # the attention pool: weights to 1e-6 (exp and sums in another
        # order); the pooled rows and d_logits inside their f64 envelopes
        # (persia_tpu_torch.testing.envelopes: an f32 sum in any order, then
        # one rounding to the dtype), the kernel and the plain version each
        # with its own weights; d_hist bit for bit; nothing at masked
        # positions or on an empty row
        # (at the DIN shape first, its errors the ones reported; then the
        # kernels' edge cases, random masks)
        for b, l, dim in [(DIN_BATCH, DIN_HIST, DIN_DIM)] + ATT_EDGE_CASES:
            din = (b, l, dim) == (DIN_BATCH, DIN_HIST, DIN_DIM)
            logits, mask, hist, d_out = att_inputs(dev, dtype, SEED + 3 + (0 if din else l), b, l, dim, prefix=din)
            out, w = ops.attention_pool_fwd(logits, mask, hist)
            d_logits, d_hist = ops.attention_pool_bwd(d_out, mask, hist, w)
            torch.cuda.synchronize()
            ref_out, ref_w = attention_pool_fwd_reference(logits, mask, hist)
            ref_dl, ref_dh = attention_pool_bwd_reference(d_out, mask, hist, w)
            label = f"attention_pool {name} {list(hist.shape)}"
            check_close(f"{label} weights", w, ref_w, 1e-6, 1e-12)
            err = check_envelope(f"{label} fwd", out, ref_out, attention_pool_fwd_envelope(w, hist),
                                 attention_pool_fwd_envelope(ref_w, hist))
            errs.setdefault(("att_fwd", dtype), err)
            check_close(f"{label} bwd d_hist", d_hist, ref_dh, 0.0, 0.0)
            if not same_bits(d_hist, ref_dh):  # signed zeros at masked positions too
                raise SystemExit(f"{label} bwd d_hist is not bit for bit its plain version")
            env = attention_pool_bwd_envelope(d_out, mask, hist, w)
            err = check_envelope(f"{label} bwd d_logits", d_logits, ref_dl, env, env)
            errs.setdefault(("att_bwd", dtype), err)
            leak = bool(out[0].any()) or bool(d_logits[0].any()) or bool(d_logits[~mask].any())
            nan = not (bool(torch.isfinite(d_logits).all()) and bool(torch.isfinite(d_hist.float()).all()))
            print(f"  {label}: the empty row and masked positions zero, no NaN: "
                  f"{'FAIL' if leak or nan else 'ok'}", flush=True)
            if leak or nan:
                raise SystemExit("attention_pool leaks into masked positions or writes a NaN")
    # the path's dtypes: the f32 wire for K6/K7, bf16 compute for K8/K9
    return {"raw_gather_fwd": errs[("raw_fwd", torch.float32)], "raw_gather_bwd": errs[("raw_bwd", torch.float32)],
            "attention_pool_fwd": errs[("att_fwd", torch.bfloat16)],
            "attention_pool_bwd": errs[("att_bwd", torch.bfloat16)]}


def din_cfg():
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig

    raw = dict(dim=DIN_DIM, embedding_summation=False, sample_fixed_size=DIN_HIST)
    return EmbeddingConfig(
        slots_config={"item": SlotConfig(dim=DIN_DIM), "cate": SlotConfig(dim=DIN_DIM),
                      "hist_item": SlotConfig(**raw), "hist_cate": SlotConfig(**raw)},
        feature_index_prefix_bit=8,
        feature_groups={"items": ["item", "hist_item"], "cates": ["cate", "hist_cate"]},
    )


def din_ctx(device, backend, sd=None):
    """``examples/taobao_din/train.py``'s ``build_ctx`` through the port: two
    PS replicas of ``backend`` (2^20 rows, 16 shards, Adagrad(0.05), seeds
    13 and 14), DIN(attention (36,), top (200, 80)), Adam(1e-3), the f32
    wire; weights from SEED. Returns (ctx, stores, weights)."""
    import torch

    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DIN
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    cfg = din_cfg()
    stores = [make_store(backend, capacity=1 << 20, num_internal_shards=16, optimizer=Adagrad(lr=0.05).config,
                         seed=13 + r) for r in range(2)]
    model = DIN(1, 2, 2, DIN_DIM, DIN_ATT, DIN_TOP, device="cpu")
    sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    model.load_state_dict(sd)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05), EmbeddingWorker(cfg, stores),
                   cfg, device=device).__enter__()
    return ctx, stores, sd


def entries_of_stores(stores, batches, cfg):
    """{sign: entry} of ``batches``' signs over the replicas that hold them."""
    out = {}
    for store in stores:
        out.update(entries_of(store, batch_keys(batches, cfg)))
    return out


def path_din(dev):
    """Phases 4g (DIN on Taobao, hybrid training) and 4h (DIN serving)."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ctx import InferCtx, stage_embeddings
    from persia_tpu_torch.data_loader import DataLoader
    from persia_tpu_torch.models import DIN
    from persia_tpu_torch.serialization import msgpack_restore
    from persia_tpu_torch.serving.engine import InferenceEngine
    from persia_tpu_torch.testing import TaobaoSynthetic, roc_auc
    from persia_tpu_torch.weights import state_dict_from_flax, train_state_to_flax_bytes

    print(f"== phase 4g: DIN on Taobao, hybrid training (B={DIN_BATCH}, L={DIN_HIST}, DataLoader "
          f"num_workers={PIPE_WORKERS}, staleness={PIPE_STALENESS})", flush=True)
    t0 = time.perf_counter()
    n = DIN_REPRO + DIN_BATCHES + DIN_PROFILED
    batches = list(TaobaoSynthetic(num_samples=n * DIN_BATCH, max_hist=DIN_HIST, seed=42).batches(DIN_BATCH))
    held_out = list(TaobaoSynthetic(num_samples=DIN_EVAL * DIN_BATCH, max_hist=DIN_HIST, seed=4242).batches(
        DIN_BATCH, requires_grad=False))
    requests = [b.to_bytes() for b in TaobaoSynthetic(num_samples=DIN_REQUESTS * DIN_BATCH, max_hist=DIN_HIST,
                                                      seed=777).batches(DIN_BATCH, requires_grad=False)]
    print(f"  {n + DIN_EVAL + DIN_REQUESTS} TaobaoSynthetic batches in {time.perf_counter() - t0:.2f} s", flush=True)
    repro, train, profiled = batches[:DIN_REPRO], batches[DIN_REPRO:DIN_REPRO + DIN_BATCHES], batches[-DIN_PROFILED:]
    cfg = din_cfg()

    # reproducible, staleness 1 on the card; train_step on the CPU over the
    # numpy stores (the golden model) from the same weights and initial rows
    ctx, stores, sd = din_ctx(dev, "native")
    loader = DataLoader(iter(repro), ctx, num_workers=PIPE_WORKERS, staleness=1, reproducible=True)
    card_losses = [ctx.train_step_prepared(tb, loader)["loss"] for tb in loader]
    loader.flush()
    loader.shutdown()
    card_rows = entries_of_stores(stores, repro, cfg)
    cpu, cpu_stores, _ = din_ctx("cpu", "numpy", sd)
    cpu_losses = [cpu.train_step(b)["loss"] for b in repro]
    cpu_rows = entries_of_stores(cpu_stores, repro, cfg)
    loss_err = max(abs(a - c) for a, c in zip(card_losses, cpu_losses))
    print(f"  first {DIN_REPRO} losses (reproducible, staleness 1) card {card_losses} cpu {cpu_losses}: "
          f"max_abs_err={loss_err:.3e} tolerance=2e-2 {'ok' if loss_err <= 2e-2 else 'FAIL'}", flush=True)
    if set(card_rows) != set(cpu_rows) or not card_rows:
        raise SystemExit(f"DIN training: the card's stores hold {len(card_rows)} of the batches' signs, "
                         f"the CPU's {len(cpu_rows)}")
    row_err = max(float(np.abs(card_rows[k] - v).max()) for k, v in cpu_rows.items())
    print(f"  PS entries after {DIN_REPRO} steps, card (native) vs cpu (numpy), {len(cpu_rows)} rows: "
          f"max_abs_err={row_err:.3e} tolerance=1e-2 {'ok' if row_err <= 1e-2 else 'FAIL'}", flush=True)
    if loss_err > 2e-2 or row_err > 1e-2 or not all(np.isfinite(card_losses)):
        raise SystemExit("DIN training: card and CPU disagree")

    # the example's loop: DataLoader(num_workers=4, staleness=4), counted,
    # each host stage timed inside it
    parts = {k: [] for k in ("lookup", "stage", "update", "lookup_cpu", "stage_cpu", "update_cpu")}
    restore = [timed_calls(ctx.worker, "forward_batch_id", parts["lookup"], parts["lookup_cpu"]),
               timed_calls(ctx, "prepare_features", parts["stage"], parts["stage_cpu"]),
               timed_calls(ctx.worker, "update_gradient_batched", parts["update"], parts["update_cpu"])]
    ops.reset_launch_counts()
    step_ms = []
    t0 = time.perf_counter()
    try:
        loader = DataLoader(iter(train), ctx, num_workers=PIPE_WORKERS, staleness=PIPE_STALENESS)
        t = time.perf_counter()
        for tb in loader:
            ctx.train_step_prepared(tb, loader, fetch_metrics=False)
            now = time.perf_counter()
            step_ms.append((now - t) * 1e3)
            t = now
        loader.flush()
        loader.shutdown()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    finally:
        for undo in restore:
            undo()
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(raw_gather_fwd=DIN_BATCHES, raw_gather_bwd=DIN_BATCHES,
                    attention_pool_fwd=2 * DIN_BATCHES, attention_pool_bwd=2 * DIN_BATCHES)
    final = ctx.last_prepared_metrics()
    print(f"  launches={launches} over {DIN_BATCHES} batches; final loss {final['loss']:.5f}; "
          f"staleness after flush {ctx.worker.staleness}", flush=True)
    check_launches("DIN training path", launches, expected)
    if not np.isfinite(final["loss"]) or ctx.worker.staleness != 0:
        raise SystemExit("DIN training: non-finite loss, or gradients still in flight after flush")

    # the card's busy time a step: the device step alone, profiled apart
    refs, device_batches, looked_up = [], [], []
    for b in profiled:
        refs.append(ctx.worker.put_forward_ids(b))
        looked_up.append(ctx.worker.forward_batch_id(refs[-1], train=True))
        device_batches.append(ctx.prepare_features(b, looked_up[-1], csr=True)[0])
    busy_ms, top_kernels, _ = device_busy_ms(ctx.run_step, device_batches)
    for ref in refs:
        ctx.worker.abort_gradient(ref)
    # the host's staging of a looked-up batch without and with the CSRs the
    # backward kernels walk (raw_csr for the raw slots, pool_csr for the
    # pooled): what the CSRs cost the host a step (median of 3 passes)
    stage_host_ms = {}
    for csr in (False, True):
        times = []
        for _ in range(3):
            for embs in looked_up:
                t0 = time.perf_counter()
                stage_embeddings(embs, dtype=ctx.wire_dtype, csr=csr)
                times.append((time.perf_counter() - t0) * 1e3)
        stage_host_ms["with_csr" if csr else "without_csr"] = float(np.median(times))

    preds = np.concatenate([ctx.eval_batch(b) for b in held_out])
    auc = roc_auc(np.concatenate([b.labels[0].data for b in held_out]), preds)
    stage_p50 = {k: float(np.percentile(v, 50)) for k, v in parts.items()}
    training = {
        "batch": DIN_BATCH, "history": DIN_HIST, "batches": DIN_BATCHES, "num_workers": PIPE_WORKERS,
        "staleness": PIPE_STALENESS, "store_backend": "native", "wire": "float32",
        "samples_per_s": DIN_BATCHES * DIN_BATCH / wall, "wall_ms": wall * 1e3,
        "step_ms_p50": float(np.percentile(step_ms, 50)), "step_ms_max": max(step_ms), "step_ms_all": step_ms,
        "stage_ms_p50": stage_p50, "stage_host_ms": stage_host_ms, "final_loss": final["loss"],
        "repro_losses": card_losses,
        "loss_max_abs_err_vs_cpu": loss_err, "ps_entry_max_abs_err_vs_cpu": row_err,
        "step_device_busy_ms": busy_ms, "step_top_kernels_ms": top_kernels,
        "kernel_launches_per_step": {k: launches[k] / DIN_BATCHES for k in DIN_KERNELS},
        "held_out_auc": auc, "held_out_batches": DIN_EVAL,
        "store_rows": sum(s.size() for s in stores),
    }
    print(f"  {training['samples_per_s']:.1f} samples/s; step p50 {training['step_ms_p50']:.2f} ms, longest "
          f"{training['step_ms_max']:.2f}; stage p50 {json.dumps(stage_p50)}; staging a batch on the host "
          f"{json.dumps(stage_host_ms)} ms; card busy {busy_ms} ms a step; "
          f"launches a step {training['kernel_launches_per_step']}; held-out AUC {auc:.5f} "
          f"({DIN_EVAL} batches, not gated)", flush=True)

    # phase 4h: the trained dense state as flax's bytes, loaded into a
    # fresh DIN behind InferenceEngine(InferCtx) on the card; the same
    # weights on the CPU over the same stores (lookups only: zeros on miss)
    print(f"== phase 4h: DIN serving ({DIN_REQUESTS} requests of B={DIN_BATCH})", flush=True)
    params = msgpack_restore(train_state_to_flax_bytes(ctx.state))["params"]
    engines = {}
    for device in (dev, "cpu"):
        model = DIN(1, 2, 2, DIN_DIM, DIN_ATT, DIN_TOP, device=device)
        model.load_state_dict(state_dict_from_flax(model, params))
        engines[device] = InferenceEngine(InferCtx(model, ctx.worker, cfg, device=device), device=device)
    engine = engines[dev]
    ops.reset_launch_counts()
    latencies, served = [], []
    t_all = time.perf_counter()
    for raw in requests:
        t = time.perf_counter()
        served.append(engine.predict_from_bytes(raw))
        latencies.append((time.perf_counter() - t) * 1e3)
    wall = time.perf_counter() - t_all
    serving_launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(raw_gather_fwd=DIN_REQUESTS, attention_pool_fwd=2 * DIN_REQUESTS)
    print(f"  launches={serving_launches} forwards={engine.forwards}", flush=True)
    check_launches("DIN serving path", serving_launches, expected)
    err = 0.0
    for raw, p in zip(requests, served):
        if p.shape != (DIN_BATCH, 1) or not np.isfinite(p).all():
            raise SystemExit(f"DIN serving: bad predictions, shape {p.shape}")
        err = max(err, float(np.abs(p - engines["cpu"].predict_from_bytes(raw)).max()))
    print(f"  card vs cpu engine: max_abs_err={err:.3e} tolerance=2e-2 {'ok' if err <= 2e-2 else 'FAIL'}", flush=True)
    if err > 2e-2:
        raise SystemExit("DIN serving: card and CPU predictions disagree")
    serving = {
        "requests": DIN_REQUESTS, "batch": DIN_BATCH, "latency_ms_p50": float(np.percentile(latencies, 50)),
        "latency_ms_max": max(latencies), "latency_ms_all": latencies,
        "samples_per_s": DIN_REQUESTS * DIN_BATCH / wall, "pred_max_abs_err_vs_cpu": err,
    }
    print(f"  serving p50 {serving['latency_ms_p50']:.2f} ms, slowest (cold) {serving['latency_ms_max']:.2f} ms, "
          f"{serving['samples_per_s']:.1f} samples/s", flush=True)
    launches = {"din_training": launches, "din_serving": serving_launches}
    return launches, {"training": training, "serving": serving}, device_batches[-1]


def avazu_ctx(name, device, backend, sd=None):
    """``examples/avazu/train.py``'s ``build_ctx`` (hybrid) through the port:
    21 fields of dim 16, two PS replicas of ``backend`` (2^20 rows, 16
    shards, Adagrad(0.05), seeds 11 and 12), deep MLP (256, 128), DCN-v2
    with 3 full-rank cross layers, Adam(1e-3); weights from SEED."""
    import torch

    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DCNv2, DeepFM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    cfg = EmbeddingConfig(slots_config={f"field_{i}": SlotConfig(dim=EMB_DIM) for i in range(AVAZU_FIELDS)},
                          feature_index_prefix_bit=8)
    stores = [make_store(backend, capacity=1 << 20, num_internal_shards=16, optimizer=Adagrad(lr=0.05).config,
                         seed=11 + r) for r in range(2)]
    if name == "deepfm":
        model = DeepFM(2, AVAZU_FIELDS, EMB_DIM, AVAZU_DEEP, device="cpu")
    else:
        model = DCNv2(2, AVAZU_FIELDS, EMB_DIM, 3, None, AVAZU_DEEP, device="cpu")
    sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    model.load_state_dict(sd)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05), EmbeddingWorker(cfg, stores),
                   cfg, device=device).__enter__()
    return ctx, sd


def path_avazu(dev):
    """Phase 4i: DeepFM and DCN-v2 on Avazu, ``TrainCtx.train_step``."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.testing import AvazuSynthetic

    print(f"== phase 4i: DeepFM and DCN-v2 on Avazu, hybrid (B={AVAZU_BATCH}, {AVAZU_STEPS} steps each)", flush=True)
    batches = list(AvazuSynthetic(num_samples=AVAZU_STEPS * AVAZU_BATCH, seed=42).batches(AVAZU_BATCH))
    out, all_launches = {}, {}
    for name in ("deepfm", "dcnv2"):
        ctx, sd = avazu_ctx(name, dev, "native")
        ops.reset_launch_counts()
        losses, step_ms = [], []
        for b in batches:
            t = time.perf_counter()
            losses.append(ctx.train_step(b)["loss"])  # ends in the gradients' copy to the host and the update
            step_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
        # host-pooled fields (the example's worker): no kernel of this port runs
        check_launches(f"{name} on Avazu", launches, {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS})
        cpu, _ = avazu_ctx(name, "cpu", "numpy", sd)
        cpu_losses = [cpu.train_step(b)["loss"] for b in batches[:AVAZU_CPU_STEPS]]
        err = max(abs(a - c) for a, c in zip(losses, cpu_losses))
        ok = err <= 2e-2 and all(np.isfinite(losses)) and ctx.worker.staleness == 0
        print(f"  {name}: losses {[round(x, 5) for x in losses]}; first {AVAZU_CPU_STEPS} vs cpu max_abs_err="
              f"{err:.3e} tolerance=2e-2 {'ok' if ok else 'FAIL'}; step ms p50 {np.percentile(step_ms, 50):.2f}, "
              f"longest {max(step_ms):.2f}", flush=True)
        if not ok:
            raise SystemExit(f"{name} on Avazu: card and CPU disagree, or a loss is not finite")
        out[name] = {"batch": AVAZU_BATCH, "steps": AVAZU_STEPS, "losses": losses,
                     "loss_max_abs_err_vs_cpu": err, "step_ms_p50": float(np.percentile(step_ms, 50)),
                     "step_ms_max": max(step_ms), "step_ms_all": step_ms,
                     "samples_per_s": AVAZU_STEPS * AVAZU_BATCH / (sum(step_ms) / 1e3)}
        all_launches[name] = launches
    return all_launches, out


def bn_inputs(dev, b, c, dtype, seed):
    """(x, dy, scale, bias, running mean, running var) on ``dev``: x with
    per-column offsets and spreads (a mean a few stds off zero, as a Dense
    layer's output), f32 parameters and statistics."""
    import torch

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c)) * rng.uniform(0.5, 3.0, c) + rng.uniform(-2, 2, c)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    return (t(x, dtype), t(rng.standard_normal((b, c)), dtype), t(1 + 0.2 * rng.standard_normal(c)),
            t(0.1 * rng.standard_normal(c)), t(0.3 * rng.standard_normal(c)), t(rng.uniform(0.5, 2.0, c)))


def phase_bn_kernels(dev):
    """Phase 3d: K10 (train mode and the running statistics) and K11
    against their plain versions on the card, and bit for bit against their
    schedules (the plain versions with the kernels' sum order) on the CPU;
    two runs give the same bits."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.batch_norm import (
        batch_norm_bwd_reference, batch_norm_bwd_schedule, batch_norm_fwd_reference, batch_norm_fwd_schedule,
    )

    print("== phase 3d: DNN's batch norm kernels (K10 forward, train and eval; K11 backward) vs their plain "
          "versions", flush=True)
    errs = {}
    for b, c, dt in BN_CASES:
        dtype = getattr(torch, dt)
        x, dy, scale, bias, mean, var = bn_inputs(dev, b, c, dtype, SEED + 7 * b + c)
        # y and dx within one ulp of the dtype plus 1e-5 of the column's
        # scale (the sums in another order move the mean, which moves y
        # where x sits several stds off zero); the statistics and the
        # parameters' gradients within 1e-5
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        col = (x.float().abs().amax(0) + 1.0)[None, :]
        for train in (True, False):
            label = f"batch_norm {'train' if train else 'eval'} {dt} ({b}, {c})"
            rm, rv, prm, prv, rm2, rv2 = (t.clone() for t in (mean, var) * 3)
            y, saved = ops.batch_norm_fwd(x, scale, bias, rm, rv, train)
            dx, ds, db = ops.batch_norm_bwd(dy, x, scale, saved, train)
            y2, saved2 = ops.batch_norm_fwd(x, scale, bias, rm2, rv2, train)
            dx2, ds2, db2 = ops.batch_norm_bwd(dy, x, scale, saved2, train)
            torch.cuda.synchronize()
            py, psaved = batch_norm_fwd_reference(x, scale, bias, prm, prv, train)
            pdx, pds, pdb = batch_norm_bwd_reference(dy, x, scale, psaved, train)
            m = (psaved[1] * scale).abs()[None, :]
            e_y = check_close(f"{label} y", y, py, rel, 1e-5 * col * m)
            check_close(f"{label} mean and rstd", saved[:2], psaved[:2], 1e-5, 1e-5 * col)
            check_close(f"{label} running mean", rm, prm, 1e-5, 1e-6 * col[0])
            check_close(f"{label} running var", rv, prv, 1e-5, 1e-5 * col[0] ** 2)
            g = float(dy.float().abs().max()) * float(m.max())
            e_dx = check_close(f"{label} dx", dx, pdx, rel, 1e-5 * g)
            dsum = dy.float().abs().sum(0)
            terms = (dy.float() * (x.float() - psaved[0]) * psaved[1]).abs().sum(0)  # sum |dy * x_hat|
            check_close(f"{label} dscale", ds, pds, 1e-5, 1e-5 * terms)
            check_close(f"{label} dbias", db, pdb, 1e-5, 1e-5 * dsum)
            twice = all(torch.equal(p, q) for p, q in ((y, y2), (saved, saved2), (rm, rm2), (rv, rv2), (dx, dx2),
                                                       (ds, ds2), (db, db2)))
            host = [t.cpu() for t in (x, scale, bias, mean, var)]
            wy, wsaved, wrm, wrv = batch_norm_fwd_schedule(*host, train)
            wdx, wds, wdb = batch_norm_bwd_schedule(dy.cpu(), host[0], host[1], wsaved, train)
            sched = all(torch.equal(p.cpu(), q) for p, q in ((y, wy), (saved, wsaved), (rm, wrm), (rv, wrv),
                                                             (dx, wdx), (ds, wds), (db, wdb)))
            still = train or (torch.equal(rm, mean) and torch.equal(rv, var))
            print(f"  {label}: twice bitwise {'ok' if twice else 'FAIL'}; bitwise its schedule on the CPU "
                  f"{'ok' if sched else 'FAIL'}; running statistics {'moved' if train else 'untouched'} "
                  f"{'ok' if still else 'FAIL'}", flush=True)
            if not (twice and sched and still):
                raise SystemExit(f"{label}: not deterministic, off its schedule, or eval mode moved the statistics")
            if b == 1 and train and not torch.equal(y, bias.to(dtype)[None]):
                raise SystemExit(f"{label}: one row must give y = bias (flax's variance 0)")
            if (b, c, dt) == (BATCH, 128, "bfloat16") and train:
                errs = {"batch_norm_fwd": e_y, "batch_norm_bwd": e_dx}
    return errs


def dnn_cfg(slots=DNN_SLOTS, dim=DNN_DIM):
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig

    return EmbeddingConfig(slots_config={f"cat_{i}": SlotConfig(dim=dim) for i in range(slots)},
                           feature_index_prefix_bit=8)


def dnn_batch_maker(seed, rows, labels=True):
    """The serving bench's batches (``benchmarks/serving_bench.py``): per
    slot i, zipf(1.2) ids shifted by 1000 i, modulo 100,000; 8 normal dense
    features; 0/1 labels for training."""
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch

    rng = np.random.default_rng(seed)

    def make():
        ids = [IDTypeFeatureWithSingleID(f"cat_{i}", (rng.zipf(1.2, rows).astype(np.uint64) + np.uint64(i * 1000))
                                         % np.uint64(DNN_VOCAB)) for i in range(DNN_SLOTS)]
        dense = [NonIDTypeFeature(rng.normal(size=(rows, DNN_DENSE)).astype(np.float32))]
        if not labels:
            return PersiaBatch(ids, non_id_type_features=dense, requires_grad=False)
        y = [Label(rng.integers(0, 2, (rows, 1)).astype(np.float32))]
        return PersiaBatch(ids, non_id_type_features=dense, labels=y, requires_grad=True)

    return make


def dnn_ctx(device, backend, sd=None, compute_dtype=None):
    """The serving bench's ``_build_ctx`` through the port, with device
    pooling: one store of ``backend`` (2^18 rows, 4 shards, Adagrad(0.1),
    seed 7), DNN(32, 128, (128, 64)) in bf16 compute (or
    ``compute_dtype``), Adam(3e-3); weights from SEED, the statistics at
    flax's start (0 and 1). Returns (ctx, store, weights)."""
    import torch

    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    cfg = dnn_cfg()
    store = make_store(backend, capacity=1 << 18, num_internal_shards=4, optimizer=Adagrad(lr=0.1).config, seed=7)
    model = DNN(DNN_DENSE, [DNN_DIM] * DNN_SLOTS, *DNN_MLP, compute_dtype or torch.bfloat16, device="cpu")
    sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    model.load_state_dict(sd)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=3e-3), Adagrad(lr=0.1),
                   EmbeddingWorker(cfg, [store], device_pooling=True), cfg, device=device).__enter__()
    return ctx, store, sd


def dnn_gaps(card, cpu, card_store, cpu_store, keys):
    """Card against CPU after the same steps: the losses' largest gap, the
    batch statistics' (mean and var apart), and each PS row's largest gap
    of its embedding and relative gap of its Adagrad accumulator, by key."""
    from persia_tpu_torch.weights import batch_stats_to_flax

    a, b = batch_stats_to_flax(card.model), batch_stats_to_flax(cpu.model)
    stats = {k: max(float(np.abs(a[n][k] - b[n][k]).max()) for n in b) for k in ("mean", "var")}
    card_rows, cpu_rows = entries_of(card_store, keys), entries_of(cpu_store, keys)
    if set(card_rows) != set(cpu_rows) or not card_rows:
        raise SystemExit(f"DNN training: the card's store holds {len(card_rows)} of the batches' signs, the CPU's "
                         f"{len(cpu_rows)}")
    signs = np.array(sorted(cpu_rows), dtype=np.uint64)
    rows = np.array([float(np.abs(card_rows[k][:DNN_DIM] - cpu_rows[k][:DNN_DIM]).max()) for k in signs.tolist()])
    acc = np.array([float((np.abs(card_rows[k][DNN_DIM:] - cpu_rows[k][DNN_DIM:])
                           / np.maximum(np.abs(cpu_rows[k][DNN_DIM:]), 1e-30)).max()) for k in signs.tolist()])
    return stats, signs, rows, acc


def permuted_batch(batch, perm):
    """``batch`` with its samples in the order ``perm``: the same
    arithmetic, every sum over the batch taken in another order."""
    from persia_tpu_torch.data import IDTypeFeature, Label, NonIDTypeFeature, PersiaBatch

    return PersiaBatch([IDTypeFeature(f.name, [f.data[i] for i in perm]) for f in batch.id_type_features],
                       non_id_type_features=[NonIDTypeFeature(f.data[perm], f.name)
                                             for f in batch.non_id_type_features],
                       labels=[Label(f.data[perm], f.name) for f in batch.labels], requires_grad=batch.requires_grad)


def dnn_f32_witness(dev, batches, sd, cfg):
    """Phase 4j (b)'s witness: the same steps in f32 compute on the card,
    on the CPU, and on the card again from the same weights with one layer
    moved by one ulp (Dense_2's kernel, each element). After the first
    step, from the same state on both devices, the card must equal the CPU
    as far as the sums' order can part them, which the first batch with
    its samples permuted measures on each device (rows and accumulators
    within twice the larger of the two gaps, and at least 1e-4 and 1e-3):
    a fault of K1, K2, K10 or K11 shows there, rounding does not. The
    later steps measure
    how training itself grows a rounding-sized difference: Adam's first
    steps move a parameter by ~lr whatever its gradient's size, so a
    gradient near 0 that takes the other sign parts the two runs by 2 lr."""
    import torch

    moved = {k: v.clone() for k, v in sd.items()}
    moved["layers.2.weight"] = torch.nextafter(sd["layers.2.weight"], torch.tensor(float("inf")))
    runs = {name: dnn_ctx(device, backend, weights, torch.float32)[:2] for name, device, backend, weights in (
        ("card", dev, "native", sd), ("cpu", "cpu", "numpy", sd), ("card_ulp", dev, "native", moved))}
    losses = {name: [] for name in runs}
    readings = {}
    spread = {}
    for i, b in enumerate(batches):
        for name, (ctx, _) in runs.items():
            losses[name].append(ctx.train_step(b)["loss"])
        if i == 0:
            perm = np.random.default_rng(SEED).permutation(b.batch_size)
            for name, device, backend in (("card", dev, "native"), ("cpu", "cpu", "numpy")):
                ctx, store = dnn_ctx(device, backend, sd, torch.float32)[:2]
                ctx.train_step(permuted_batch(b, perm))
                _, _, rows, acc = dnn_gaps(runs[name][0], ctx, runs[name][1], store, batch_keys(batches[:1], cfg))
                spread[name] = {"rows_max": float(rows.max()), "rows_p99": float(np.percentile(rows, 99)),
                                "acc_max": float(acc.max())}
        if i in (0, len(batches) - 1):
            keys = batch_keys(batches[:i + 1], cfg)
            (card, card_store) = runs["card"]
            for other in ("cpu", "card_ulp"):
                stats, _, rows, acc = dnn_gaps(card, runs[other][0], card_store, runs[other][1], keys)
                readings[(i, other)] = {
                    "loss": max(abs(a - c) for a, c in zip(losses["card"], losses[other])),
                    "mean": stats["mean"], "var": stats["var"], "rows_max": float(rows.max()),
                    "rows_p99": float(np.percentile(rows, 99)), "acc_max": float(acc.max())}
    first = readings[(0, "cpu")]
    # a fault that drops or misroutes a position moves its row by that
    # position's whole step; rounding moves a row by up to what the
    # permuted batch shows (a relu whose pre-activation lies within
    # rounding of 0 takes the other sign, and its sample's rows move)
    rows_bound = max(1e-4, 2 * max(v["rows_max"] for v in spread.values()))
    acc_bound = max(1e-3, 2 * max(v["acc_max"] for v in spread.values()))
    ok = (first["loss"] <= 1e-5 and first["mean"] <= 1e-5 and first["var"] <= 1e-5
          and first["rows_max"] <= rows_bound and first["acc_max"] <= acc_bound)
    last = len(batches) - 1

    def fmt(r):
        return (f"losses {r['loss']:.3e}, means {r['mean']:.3e}, variances {r['var']:.3e}, rows max "
                f"{r['rows_max']:.3e} p99 {r['rows_p99']:.3e}, accumulators rel {r['acc_max']:.3e}")

    print(f"  f32 witness, card vs cpu after the first step: {fmt(first)} (losses and statistics 1e-5, rows "
          f"{rows_bound:.3e} and accumulators {acc_bound:.3e}: twice the first batch's permuted gaps, at least "
          f"1e-4 and 1e-3; card "
          f"{spread['card']}, cpu {spread['cpu']}) {'ok' if ok else 'FAIL'}; the card vs itself from Dense_2's "
          f"kernel moved by one ulp, after the first step: {fmt(readings[(0, 'card_ulp')])}; after {last + 1} "
          f"steps: card vs cpu "
          f"{fmt(readings[(last, 'cpu')])}"
          f"; card vs the card from Dense_2's kernel moved by one ulp {fmt(readings[(last, 'card_ulp')])}", flush=True)
    return ok, {"steps": last + 1, "first_step_vs_cpu": first, "first_step_permuted": spread,
                "last_step_vs_cpu": readings[(last, "cpu")],
                "last_step_vs_one_ulp": readings[(last, "card_ulp")],
                "first_step_vs_one_ulp": readings[(0, "card_ulp")]}


def bn_launches_expected(ops, **counts):
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(counts)
    return expected


def path_adult(dev):
    """Phase 4j (a): the adult-income example on the card, held to its
    pinned AUC and to the same run on the CPU."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.testing import adult_income

    ai = adult_income
    print(f"== phase 4j (a): adult income (examples/adult_income/train.py's config: VOCABS {ai.VOCABS}, dim "
          f"{ai.DIM}, DNN({ai.DENSE_MLP}, {ai.SPARSE_MLP}, {ai.HIDDEN}), numpy store 2^18 / 4 shards, "
          f"Adagrad(0.1), Adam(3e-3), B={ai.BATCH}, {ai.EPOCHS} epochs of {ai.TRAIN_SAMPLES}, test "
          f"{ai.TEST_SAMPLES}; host pooling)", flush=True)
    pinned = ai.reference_auc(pathlib.Path(__file__).resolve().parent)
    runs = {}
    for device in ("cpu", dev):
        ctx, _ = ai.build_ctx(device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        epochs = ai.train(ctx, on_epoch=lambda e, loss, auc, d=device: print(
            f"  {d} epoch {e}: loss={loss:.4f} test_auc={auc:.6f}", flush=True))
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[str(device)] = (epochs, wall, {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS},
                             dict(ops.batch_norm_fwd.launches_by_route))
    (card, card_wall, launches, by_route), (cpu, cpu_wall, _, _) = runs[str(dev)], runs["cpu"]
    steps = sum(len(losses) for losses, _ in card)
    evals = ai.EPOCHS * -(-ai.TEST_SAMPLES // ai.BATCH)
    check_launches("adult income", launches, bn_launches_expected(
        ops, batch_norm_fwd=2 * (steps + evals), batch_norm_bwd=2 * steps))
    if by_route != {"train": 2 * steps, "eval": 2 * evals}:
        raise SystemExit(f"adult income: K10's launches by mode {by_route}, expected {2 * steps} train and "
                         f"{2 * evals} eval")
    card_losses = np.concatenate([losses for losses, _ in card])
    cpu_losses = np.concatenate([losses for losses, _ in cpu])
    gap = np.abs(card_losses - cpu_losses)
    first_off = next((i for i, d in enumerate(gap) if d > 2e-2), None)
    auc, cpu_auc = card[-1][1], cpu[-1][1]
    ok = abs(auc - pinned) <= 5e-3 and abs(cpu_auc - pinned) <= 5e-3 and np.isfinite(card_losses).all()
    print(f"  final test AUC card {auc!r}, cpu {cpu_auc!r}, pinned REPRODUCIBLE_AUC {pinned!r}: card - pinned "
          f"{auc - pinned:+.3e}, cpu - pinned {cpu_auc - pinned:+.3e} (tolerance 5e-3) {'ok' if ok else 'FAIL'}; "
          f"per-step losses card vs cpu max |diff| {gap.max():.3e}, first step past 2e-2: {first_off}; "
          f"{steps} steps + {evals} eval batches in {card_wall:.2f} s (cpu {cpu_wall:.2f} s); launches {launches}",
          flush=True)
    if not ok:
        raise SystemExit("adult income: the final AUC is not within 5e-3 of the reference's pinned one")
    return launches, {
        "epochs": ai.EPOCHS, "batch": ai.BATCH, "steps": steps, "eval_batches": evals,
        "epoch_loss": [float(np.mean(losses)) for losses, _ in card], "epoch_auc": [a for _, a in card],
        "final_auc": auc, "cpu_final_auc": cpu_auc, "pinned_auc": pinned, "auc_minus_pinned": auc - pinned,
        "cpu_auc_minus_pinned": cpu_auc - pinned, "loss_max_abs_diff_vs_cpu": float(gap.max()),
        "first_step_past_2e-2": first_off, "wall_s": card_wall, "cpu_wall_s": cpu_wall,
        "launches_by_mode": by_route,
    }


def path_dnn_hybrid(dev):
    """Phase 4j (b): DNN at the serving bench's width on the hybrid tier,
    trained and then served."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ctx import InferCtx
    from persia_tpu_torch.embedding.worker import preprocess_batch
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.serving.engine import InferenceEngine
    from persia_tpu_torch.weights import model_from_flax_bytes, train_state_to_flax_bytes

    print(f"== phase 4j (b): DNN at the serving bench's width, hybrid ({DNN_SLOTS} slots of dim {DNN_DIM} over "
          f"{DNN_VOCAB} ids, zipf(1.2), DNN{DNN_MLP}, device pooling; {DNN_WARM} + {DNN_STEPS} steps of B={BATCH}, "
          f"then {DNN_REQUESTS} requests of B={DNN_SERVE_BATCH})", flush=True)
    make = dnn_batch_maker(SEED + 21, BATCH)
    batches = [make() for _ in range(DNN_WARM + DNN_STEPS)]
    profiled = [make() for _ in range(4)]
    cfg = dnn_cfg()
    ctx, store, sd = dnn_ctx(dev, "native")
    cpu, cpu_store, _ = dnn_ctx("cpu", "numpy", sd)
    # the first step, from the same state on both devices: the rows within
    # 1e-2 and their accumulators within 1e-2 of themselves
    card_losses = [ctx.train_step(batches[0])["loss"]]
    cpu_losses = [cpu.train_step(batches[0])["loss"]]
    first_stats, _, first_rows, first_acc = dnn_gaps(ctx, cpu, store, cpu_store, batch_keys(batches[:1], cfg))
    first = {"loss": abs(card_losses[0] - cpu_losses[0]), "stats": max(first_stats.values()),
             "rows_max": float(first_rows.max()), "acc_max": float(first_acc.max())}
    first_ok = (first["loss"] <= 2e-2 and first["stats"] <= 1e-2 and first["rows_max"] <= 1e-2
                and first["acc_max"] <= 1e-2)
    print(f"  bf16, card vs cpu after the first step: loss {first['loss']:.3e} (2e-2), batch_stats "
          f"{first['stats']:.3e} (1e-2), PS rows max {first['rows_max']:.3e} (1e-2), Adagrad accumulators rel max "
          f"{first['acc_max']:.3e} (1e-2) {'ok' if first_ok else 'FAIL'}", flush=True)
    card_losses += [ctx.train_step(b)["loss"] for b in batches[1:DNN_WARM]]
    ops.reset_launch_counts()
    step_ms = []
    for b in batches[DNN_WARM:]:
        t = time.perf_counter()
        card_losses.append(ctx.train_step(b)["loss"])  # ends in the gradients' copy to the host and the update
        step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    by_route = dict(ops.batch_norm_fwd.launches_by_route)
    check_launches("DNN training path", launches, bn_launches_expected(
        ops, gather_pool_fwd=DNN_STEPS, gather_pool_bwd=DNN_STEPS, batch_norm_fwd=2 * DNN_STEPS,
        batch_norm_bwd=2 * DNN_STEPS))
    if by_route != {"train": 2 * DNN_STEPS, "eval": 0}:
        raise SystemExit(f"DNN training: K10's launches by mode {by_route}")
    cpu_losses += [cpu.train_step(b)["loss"] for b in batches[1:DNN_CPU_STEPS]]
    loss_err = max(abs(a - c) for a, c in zip(card_losses, cpu_losses))
    keys = batch_keys(batches, cfg)
    stats, signs, gaps, acc_gaps = dnn_gaps(ctx, cpu, store, cpu_store, keys)
    stats_err = max(stats.values())
    # the rows after all the steps: training grows any rounding-sized
    # difference (the f32 witness below: card against CPU, and the card
    # against itself from weights moved by one ulp, part as far), so
    # 99 % of the rows within 1e-2 (embeddings) and 1e-2 of itself (the
    # accumulator), every row within 5e-2 and 0.1 (measured in bf16:
    # 2.28e-2 to 3.79e-2 and 4.2e-2 to 4.8e-2)
    row_err, acc_err = float(gaps.max()), float(acc_gaps.max())
    row_p99, acc_p99 = float(np.percentile(gaps, 99)), float(np.percentile(acc_gaps, 99))
    counts = dict(zip(*np.unique(np.concatenate([s.keys for b in batches for s in preprocess_batch(
        b.id_type_features, cfg)]), return_counts=True)))
    tail = [(float(gaps[i]), int(counts[signs[i]])) for i in np.argsort(gaps)[::-1][:5]]
    ok = (loss_err <= 2e-2 and stats_err <= 1e-2 and row_p99 <= 1e-2 and row_err <= 5e-2 and acc_p99 <= 1e-2
          and acc_err <= 0.1 and np.isfinite(card_losses).all())
    print(f"  losses card {[round(x, 5) for x in card_losses]} cpu {[round(x, 5) for x in cpu_losses]}: max_abs_err="
          f"{loss_err:.3e} (tolerance 2e-2); batch_stats max_abs_err mean {stats['mean']:.3e}, var "
          f"{stats['var']:.3e} (1e-2); PS rows ({len(gaps)}, native vs numpy) abs err p50 "
          f"{np.percentile(gaps, 50):.3e}, p99 {row_p99:.3e} (1e-2), max {row_err:.3e} (5e-2), "
          f"{float((gaps > 1e-2).mean()):.4%} past 1e-2; the 5 widest (gap, steps that touched the row) {tail}; "
          f"Adagrad accumulators rel err p99 {acc_p99:.3e} (1e-2), max {acc_err:.3e} (0.1) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    witness_ok, witness = dnn_f32_witness(dev, batches[:DNN_CPU_STEPS], sd, cfg)
    if not first_ok:
        raise SystemExit("DNN training: card and CPU disagree after the first step")
    if not ok:
        raise SystemExit("DNN training: card and CPU disagree")
    if not witness_ok:
        raise SystemExit("DNN training: card and CPU disagree in f32 compute")

    refs, device_batches = [], []
    for b in profiled:
        refs.append(ctx.worker.put_forward_ids(b))
        device_batches.append(ctx.prepare_features(b, ctx.worker.forward_batch_id(refs[-1], train=True), csr=True)[0])
    busy_ms, top_kernels, runs = device_busy_ms(ctx.run_step, device_batches)
    for ref in refs:
        ctx.worker.abort_gradient(ref)
    training = {
        "batch": BATCH, "steps": DNN_STEPS, "warm_steps": DNN_WARM, "store_backend": "native", "device_pooling": True,
        "samples_per_s": DNN_STEPS * BATCH / (sum(step_ms) / 1e3), "step_ms_p50": float(np.percentile(step_ms, 50)),
        "step_ms_max": max(step_ms), "step_ms_all": step_ms, "losses": card_losses,
        "loss_max_abs_err_vs_cpu": loss_err, "batch_stats_max_abs_err_vs_cpu": stats_err,
        "ps_row_max_abs_err_vs_cpu": row_err, "ps_row_p99_abs_err_vs_cpu": row_p99,
        "ps_accumulator_max_rel_err_vs_cpu": acc_err, "ps_accumulator_p99_rel_err_vs_cpu": acc_p99,
        "widest_rows_gap_and_touches": tail, "first_step_vs_cpu": first, "f32_witness": witness,
        "step_device_busy_ms": busy_ms, "step_top_kernels_ms": top_kernels,
        "bn_kernel_runs_4_steps": {k: runs[k] for k in ("batch_norm_fwd_kernel", "batch_norm_bwd_kernel")},
    }
    print(f"  {training['samples_per_s']:.1f} samples/s; step p50 {training['step_ms_p50']:.2f} ms, longest "
          f"{training['step_ms_max']:.2f}; card busy {busy_ms} ms a step; its kernels {json.dumps(top_kernels)}; "
          f"K10/K11 runs in 4 traced steps {training['bn_kernel_runs_4_steps']}", flush=True)

    # serving: the trained state as flax's bytes, loaded into a bare DNN
    # (model_from_flax_bytes: params and batch_stats) behind
    # InferenceEngine(InferCtx); the same bytes on the CPU over the same store
    raw_state = train_state_to_flax_bytes(ctx.state)
    requests = [b.to_bytes() for b in (dnn_batch_maker(SEED + 22, DNN_SERVE_BATCH, labels=False)()
                                       for _ in range(DNN_REQUESTS))]
    engines = {}
    for device in (dev, "cpu"):
        model = model_from_flax_bytes(DNN(DNN_DENSE, [DNN_DIM] * DNN_SLOTS, *DNN_MLP, device=device), raw_state)
        engines[device] = InferenceEngine(InferCtx(model, ctx.worker, cfg, device=device), device=device)
    engine = engines[dev]
    ops.reset_launch_counts()
    latencies, served = [], []
    for raw in requests:
        t = time.perf_counter()
        served.append(engine.predict_from_bytes(raw))
        latencies.append((time.perf_counter() - t) * 1e3)
    serving_launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    serve_route = dict(ops.batch_norm_fwd.launches_by_route)
    check_launches("DNN serving path", serving_launches, bn_launches_expected(
        ops, gather_pool_fwd=DNN_REQUESTS, batch_norm_fwd=2 * DNN_REQUESTS))
    if serve_route != {"train": 0, "eval": 2 * DNN_REQUESTS}:
        raise SystemExit(f"DNN serving: K10's launches by mode {serve_route}")
    err = 0.0
    for raw, p in zip(requests, served):
        if p.shape != (DNN_SERVE_BATCH, 1) or not np.isfinite(p).all():
            raise SystemExit(f"DNN serving: bad predictions, shape {p.shape}")
        err = max(err, float(np.abs(p - engines["cpu"].predict_from_bytes(raw)).max()))
    print(f"  serving launches {serving_launches} (K10 by mode {serve_route}); card vs cpu engine max_abs_err="
          f"{err:.3e} tolerance=2e-2 {'ok' if err <= 2e-2 else 'FAIL'}; p50 {np.percentile(latencies, 50):.2f} ms, "
          f"slowest (cold) {max(latencies):.2f}", flush=True)
    if err > 2e-2:
        raise SystemExit("DNN serving: card and CPU predictions disagree")
    serving = {"requests": DNN_REQUESTS, "batch": DNN_SERVE_BATCH,
               "latency_ms_p50": float(np.percentile(latencies, 50)), "latency_ms_max": max(latencies),
               "latency_ms_all": latencies, "pred_max_abs_err_vs_cpu": err}
    return {"dnn_training": launches, "dnn_serving": serving_launches}, {"training": training, "serving": serving}


def path_dnn_resume(dev):
    """Phase 4j (c): kill and resume at bench.py:936-960's configuration on
    the card, both modes."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.jobstate import JobStateManager
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.testing import SyntheticClickDataset
    from persia_tpu_torch.weights import (
        batch_stats_to_flax, seeded_flax_params_like, state_dict_from_flax, train_state_to_flax_bytes,
    )

    r = DNN_RESUME
    print(f"== phase 4j (c): DNN kill and resume (bench.py:936-960: DNN(8, 16, (32,)), 2 slots, B={r['batch']}, "
          f"{r['steps']} steps, a snapshot every {r['every']}, killed after {r['kill']})", flush=True)
    cfg = dnn_cfg(2, 8)
    batches = list(SyntheticClickDataset(num_samples=r["steps"] * r["batch"], vocab_sizes=(64, 32), seed=9)
                   .batches(r["batch"]))[:r["steps"]]
    model0 = DNN(5, [8, 8], 8, 16, (32,), device="cpu")
    sd = state_dict_from_flax(model0, seeded_flax_params_like(model0, SEED))

    def make_ctx(stores):
        model = DNN(5, [8, 8], 8, 16, (32,), device="cpu")
        model.load_state_dict(sd)
        return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=3e-3), Adagrad(lr=0.1),
                        EmbeddingWorker(cfg, stores), cfg, device=dev).__enter__()

    def make_stores():
        return [EmbeddingStore(capacity=1 << 16, num_internal_shards=4, seed=7) for _ in range(2)]

    def dumps(stores):
        return [st.dump_shard(i) for st in stores for i in range(st.num_internal_shards)]

    base_stores = make_stores()
    base = make_ctx(base_stores)
    for b in batches:
        base.train_step(b)
    want_bytes, want_dumps = train_state_to_flax_bytes(base.state), dumps(base_stores)
    out, launches = {}, {}
    shutil.rmtree(STATE_DIR, ignore_errors=True)
    try:
        for mode, restore_ps in (("rewind", True), ("journal", False)):
            mgr = JobStateManager(str(STATE_DIR / f"dnn_{mode}"))
            stores = make_stores()
            ctx1 = make_ctx(stores)
            ctx1.resume(mgr)
            for i in range(r["kill"]):
                ctx1.train_step(batches[i])
                if (i + 1) % r["every"] == 0:
                    ctx1.snapshot_job(mgr)
            del ctx1  # the trainer dies; the PS stores survive
            t0 = time.perf_counter()
            ctx2 = make_ctx(stores)
            m = ctx2.resume(mgr, restore_ps=restore_ps)
            resume_s = time.perf_counter() - t0
            ops.reset_launch_counts()
            for i in range(m.step, r["steps"]):
                ctx2.train_step(batches[i])
            torch.cuda.synchronize()
            launches[mode] = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
            replayed = r["steps"] - m.step
            check_launches(f"DNN resume ({mode})", launches[mode], bn_launches_expected(
                ops, batch_norm_fwd=2 * replayed, batch_norm_bwd=2 * replayed))
            router = ctx2.worker.lookup_router
            out[mode] = {"time_to_resume_s": resume_s, "resumed_at_step": m.step, "steps_replayed": replayed,
                         "journal_skips": router.journal_skips}
            if mode == "rewind":
                same_dense = train_state_to_flax_bytes(ctx2.state) == want_bytes
                same_ps = dumps(stores) == want_dumps
                stats = batch_stats_to_flax(ctx2.model)
                moved = all(not np.array_equal(v["var"], np.ones_like(v["var"])) for v in stats.values())
                out[mode].update(dense_bytes_equal=same_dense, ps_dumps_equal=same_ps)
                print(f"  rewind: resumed at step {m.step} in {resume_s:.4f} s, {replayed} steps replayed; dense "
                      f"bytes (params, batch_stats, Adam) equal to the uninterrupted run's: {same_dense}; every PS "
                      f"shard's dump equal: {same_ps}; batch_stats moved from flax's start: {moved}", flush=True)
                if not (same_dense and same_ps and moved):
                    raise SystemExit("DNN rewind resume: not bit for bit the uninterrupted run")
            else:
                applied = r["kill"] - m.step  # replayed steps the crashed run had applied
                print(f"  journal: resumed at step {m.step} in {resume_s:.4f} s, {replayed} steps replayed, "
                      f"{applied} of them applied before the crash; journal_skips {router.journal_skips}", flush=True)
                if router.journal_skips < applied:
                    raise SystemExit("DNN journal resume: a step the crashed run applied was applied again")
    finally:
        shutil.rmtree(STATE_DIR, ignore_errors=True)
    return {"dnn_resume": launches["rewind"]}, out


def path_dnn(dev):
    """Phase 4j: DNN with its batch statistics (a, b, c)."""
    adult_launches, adult = path_adult(dev)
    hybrid_launches, hybrid = path_dnn_hybrid(dev)
    resume_launches, resume = path_dnn_resume(dev)
    return ({"dnn_adult": adult_launches, **hybrid_launches, **resume_launches},
            {"adult_income": adult, **hybrid, "resume": resume})


def time_flash_backward(dev, card):
    """The flash-attention backward, a dense recompute (the gradient of
    ``reference_attention`` at the saved q, k, v; it launches no kernel of
    its own), against SDPA's backward on the same inputs and output
    gradient at (4, 1024, 8, 64): ``torch.autograd.grad`` of each forward's
    output, by CUDA events around 20 eager calls (a call is far longer than
    its host enqueue). Bound: 10·B·H·D·(key, query pairs) operations (S
    recomputed, dP, dS·K, dSᵀ·Q, Pᵀ·dO), bf16 at its tensor-core rate, f32
    at three TF32 passes as the forward's f32 rows; bytes q, k, v, dO read
    and dq, dk, dv written once."""
    import torch
    import torch.nn.functional as F

    from persia_tpu_torch import ops

    print("== phase 5b: flash-attention backward (dense recompute) vs SDPA's backward", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    b, l, h, d = 4, 1024, 8, 64
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (False, True):
            q, k, v, grad = (torch.randn((b, l, h, d), generator=g).to(dev, dtype) for _ in range(4))
            leaves = [t.requires_grad_(True) for t in (q, k, v)]
            ours = ops.flash_attention(*leaves, causal=causal)
            sdpa = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in leaves), is_causal=causal)
            grad_t = grad.transpose(1, 2)
            ours_bwd = lambda: torch.autograd.grad(ours, leaves, grad, retain_graph=True)  # noqa: E731
            sdpa_bwd = lambda: torch.autograd.grad(sdpa, leaves, grad_t, retain_graph=True)  # noqa: E731
            lib0, k0, k1, lib1 = (eager_ms(f, iters=20, warmup=3) for f in (sdpa_bwd, ours_bwd, ours_bwd, sdpa_bwd))
            err = max(float((a.float() - c.float()).abs().max()) for a, c in zip(ours_bwd(), sdpa_bwd()))
            pairs = l * (l + 1) // 2 if causal else l * l
            width = q.element_size()
            ops_ = 10 * b * h * d * pairs
            bms, by = (bound(7 * b * l * h * d * width, ops_, "bfloat16") if dtype == torch.bfloat16
                       else bound(7 * b * l * h * d * width, 3 * ops_, "tf32"))
            row = {"name": "flash_attention_bwd", "how": "dense recompute (reference_attention autograd)",
                   "replaces": "persia_tpu/ops/flash_attention.py:139", "shape": [b, l, h, d],
                   "dtype": str(dtype)[6:], "causal": causal, "ms": min(k0, k1), "ms_runs": [k0, k1],
                   "library_ms": min(lib0, lib1), "library_ms_runs": [lib0, lib1],
                   "library": "scaled_dot_product_attention backward", "bound_ms": bms, "bound_by": by,
                   "max_abs_diff_vs_library": err}
            print(json.dumps({"flash_bwd_timing": row, "card": card}), flush=True)
            rows.append(row)
            del ours, sdpa
    return rows


def sdpa_kernels(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` runs, by torch.profiler."""
    _, top, _ = device_busy_ms(lambda _: fn(), [None] * 3)
    return list(top)


def phase_timing(dev, card, launches, errs, feats_shape, train_batch, fused, din_batch, build):
    import torch
    import torch.nn.functional as F

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.dot_interaction import (
        dot_interaction_bwd_reference, dot_interaction_reference,
    )
    from persia_tpu_torch.ops.embedding_pool import (
        gather_pool_bwd_reference, gather_pool_fwd_reference,
    )
    from persia_tpu_torch.ops.flash_attention import (
        reference_attention, tf32_split_planes_reference,
    )
    from persia_tpu_torch.ops.plans import tf32_plan

    print("== phase 5: timing", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    rows = []
    # the one-launch floor: a one-element in-place add_, timed as every
    # kernel is (20 calls in a graph, 10 replays), twice
    one = torch.zeros(1, device=dev)
    floor = [graph_ms(lambda: one.add_(1.0)) for _ in range(2)]
    print(f"  launch_floor_ms {floor} (a one-element add_, graph-replayed)", flush=True)

    b, l, h, d = 4, 1024, 8, 64
    q, k, v = (torch.randn((b, l, h, d), generator=g).to(dev) for _ in range(3))
    def timed(row, kernel, plain, library=None, plain_calls=20):
        """Fill a row's times: graph-replayed (``ms``, ``plain_ms``,
        ``library_ms``) and eager (``*eager_ms``), kernel and library in
        turns (library, kernel, kernel, library) so drift shows."""
        lib0 = timings(library) if library else None
        k0, k1 = timings(kernel), timings(kernel)
        lib1 = timings(library) if library else None
        plain_t = timings(plain, calls=plain_calls, eager_iters=plain_calls)
        row.update(
            ms=min(k0["graph"], k1["graph"]), eager_ms=min(k0["eager"], k1["eager"]),
            ms_runs=[k0["graph"], k1["graph"]],
            plain_ms=plain_t["graph"], plain_eager_ms=plain_t["eager"],
            library_ms=min(lib0["graph"], lib1["graph"]) if library else None,
            library_eager_ms=min(lib0["eager"], lib1["eager"]) if library else None,
            library_ms_runs=[lib0["graph"], lib1["graph"]] if library else None,
        )
        return row

    # f32 rows are bounded by the split-TF32 work (three TF32 products per
    # product) on the tensor cores; the same work on the FMA pipes, once,
    # is printed beside it as fma_bound_ms
    cases = [("wgmma_bf16", torch.bfloat16, False), ("wgmma_bf16", torch.bfloat16, True),
             ("tf32x3", torch.float32, False), ("tf32x3", torch.float32, True)]
    for route, dtype, causal in cases:
        x = [t.to(dtype) for t in (q, k, v)]
        xt = [t.transpose(1, 2) for t in x]
        width = x[0].element_size()
        pairs = l * (l + 1) // 2 if causal else l * l
        ops_ = 4 * b * h * d * pairs
        extra = {}
        if route == "tf32x3":
            bms, by = bound(4 * b * l * h * d * width, 3 * ops_, "tf32")
            extra = dict(bound_note="3 x operations / 494.7 TFLOP/s (TF32)",
                         fma_bound_ms=bound(4 * b * l * h * d * width, ops_, "float32")[0])
        else:
            bms, by = bound(4 * b * l * h * d * width, ops_, "bfloat16")
        library = lambda: F.scaled_dot_product_attention(*xt, is_causal=causal)  # noqa: E731
        if dtype == torch.float32:
            extra["library_kernels"] = sdpa_kernels(library)
            print(f"  SDPA f32 causal={causal} runs: {extra['library_kernels']}", flush=True)
        rows.append(timed(
            dict(name="flash_attention", route="cuda", cuda_route=route,
                 source=FA_SOURCE[route], replaces=FA_REPLACES,
                 shape=[b, l, h, d], dtype=str(dtype)[6:], causal=causal,
                 launches=launches["flash_attention"][route],
                 max_abs_err=errs["flash_attention"]["bf16" if route == "wgmma_bf16" else "f32"],
                 bound_ms=bms, bound_by=by, **extra),
            kernel=lambda: ops.flash_attention(*x, causal=causal),
            plain=lambda: reference_attention(*x, causal=causal),
            library=library,
            plain_calls=4,
        ))

    # the f32 route's pre-pass alone (its time is inside the f32 rows):
    # reads q, k, v once, writes six planes; no PyTorch call computes it
    pad = tf32_plan(b, l, h, d, False).seq_pad
    bms, by = bound(3 * b * l * h * d * 4 + 6 * b * h * pad * d * 4, 0, "float32")
    rows.append(timed(
        dict(name="tf32_split_planes", route="cuda", cuda_route="tf32x3",
             source=FA_SOURCE["tf32x3"], replaces=FA_REPLACES,
             shape=[b, l, h, d], dtype="float32",
             launches=launches["flash_attention"]["tf32_split_planes"],
             max_abs_err=errs["flash_attention"]["tf32_split_planes"],
             bound_ms=bms, bound_by=by),
        kernel=lambda: ops.tf32_split_planes(q, k, v),
        plain=lambda: tf32_split_planes_reference(q, k, v),
        plain_calls=4,
    ))

    feats = torch.randn(feats_shape, generator=g).to(dev, torch.bfloat16)
    bsz, n, dim = feats_shape
    pairs = n * (n - 1) // 2
    bms, by = bound(bsz * n * dim * 2 + bsz * pairs * 2, 2 * bsz * pairs * dim, "bfloat16")
    rows.append(timed(
        dict(name="dot_interaction", route="cuda", cuda_route="cuda",
             source="persia_tpu_torch/csrc/dot_interaction.cu", replaces=DOT_REPLACES,
             shape=list(feats_shape), dtype="bfloat16",
             launches=launches["training"]["dot_interaction"],
             launches_by_path={p: launches[p]["dot_interaction"] for p in ("serving", "training", "pipelined", "durable")},
             max_abs_err=errs["dot_interaction"], bound_ms=bms, bound_by=by),
        kernel=lambda: ops.dot_interaction(feats),
        plain=lambda: dot_interaction_reference(feats),
        # the full (B, n, n) product: a superset of the function, the
        # nearest one-call yardstick
        library=lambda: torch.bmm(feats, feats.transpose(1, 2)),
    ))

    # the backward: reads feats and g, writes dfeats; 2 (n - 1) d FLOP per
    # feature row. Yardstick: bmm of the symmetrised (B, n, n) gradient
    gpair = torch.randn((bsz, pairs), generator=g).to(dev, torch.bfloat16)
    iu, ju = torch.triu_indices(n, n, offset=1, device=dev)
    gsym = torch.zeros((bsz, n, n), device=dev, dtype=torch.bfloat16)
    gsym[:, iu, ju] = gpair
    gsym[:, ju, iu] = gpair
    bms, by = bound(2 * bsz * n * dim * 2 + bsz * pairs * 2, 2 * bsz * n * (n - 1) * dim, "bfloat16")
    rows.append(timed(
        dict(name="dot_interaction_bwd", route="cuda", cuda_route="cuda",
             source="persia_tpu_torch/csrc/dot_interaction.cu", replaces=DOT_REPLACES,
             shape=list(feats_shape), dtype="bfloat16",
             launches=launches["training"]["dot_interaction_bwd"],
             launches_by_path={p: launches[p]["dot_interaction_bwd"] for p in ("training", "pipelined", "durable")},
             max_abs_err=errs["dot_interaction_bwd"], bound_ms=bms, bound_by=by),
        kernel=lambda: ops.dot_interaction_bwd(feats, gpair),
        plain=lambda: dot_interaction_bwd_reference(feats, gpair),
        library=lambda: torch.bmm(gsym, feats),
    ))

    # the gather-pool pair at the training path's own inputs (one staged
    # step's batch): bytes = each input once, each output once (the
    # function's: the backward kernel's index reads and partials are not
    # counted, so the rows compare across designs)
    emb = [e for e in train_batch["emb"] if "pool_index" in e]
    prow = [e["distinct"] for e in emb]
    pslots = [ops.PoolSlot(e["pool_index"], e.get("pool_counts"), e["pool_order"], e["pool_offsets"])
              for e in emb]
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts if t is not None)  # noqa: E731
    pooled = ops.gather_pool_fwd(prow, pslots)
    gpool = torch.randn(pooled.shape, generator=g).to(dev)
    p_rows, width = prow[0].shape
    shape = [bsz, len(prow), width, p_rows]
    # yardsticks: the slots' tables side by side, indexes shifted into them
    table = torch.cat(prow)
    shift = torch.arange(len(prow), device=dev, dtype=torch.int64)[None, :, None] * p_rows
    flat_idx = (torch.stack([s.index.long() for s in pslots], 1) + shift).reshape(bsz * len(prow), -1)
    acc = torch.zeros(table.shape, device=dev, dtype=torch.float32)
    grad_flat = gpool.reshape(bsz * len(prow), width)
    clone = lambda t: None if t is None else t.clone()  # noqa: E731

    def clone_group(rows_, slots_):
        return [r.clone() for r in rows_], [ops.PoolSlot(*map(clone, s)) for s in slots_]

    def with_cold(row, kernel, make_copy, copy_bytes, library=None, make_lib_copy=None, lib_bytes=0):
        """Cold times beside the warm ones (library, kernel, kernel, library)
        and the share read from the cold kernel time."""
        lib0 = cold_ms(library, make_lib_copy, lib_bytes) if library else None
        k0, k1 = cold_ms(kernel, make_copy, copy_bytes), cold_ms(kernel, make_copy, copy_bytes)
        lib1 = cold_ms(library, make_lib_copy, lib_bytes) if library else None
        row.update(
            cold_ms=min(k0["ms"], k1["ms"]), cold_ms_runs=[k0["ms"], k1["ms"]],
            cold_copies=k0["copies"], cold_bytes_per_copy=copy_bytes,
            library_cold_ms=min(lib0["ms"], lib1["ms"]) if library else None,
            library_cold_copies=lib0["copies"] if library else None,
        )
        row["cold_share"] = row["bound_ms"] / row["cold_ms"]
        return row

    fwd_in = nbytes(prow) + nbytes([s.index for s in pslots] + [s.counts for s in pslots])
    bms, by = bound(fwd_in + pooled.numel() * 4, pooled.numel() * flat_idx.shape[1], "float32")
    rows.append(with_cold(
        timed(
            dict(name="gather_pool_fwd", route="cuda", cuda_route="cuda",
                 source="persia_tpu_torch/csrc/embedding_pool.cu", replaces=POOL_REPLACES,
                 shape=shape, dtype=str(prow[0].dtype)[6:],
                 launches=launches["training"]["gather_pool_fwd"],
                 launches_by_path={p: launches[p]["gather_pool_fwd"] for p in ("serving", "training", "pipelined", "durable")},
                 max_abs_err=errs["gather_pool_fwd"], bound_ms=bms, bound_by=by,
                 library_note="F.embedding_bag(mode='sum') over the slots' tables side by side, bf16 out"),
            kernel=lambda: ops.gather_pool_fwd(prow, pslots),
            plain=lambda: gather_pool_fwd_reference(prow, pslots),
            library=lambda: F.embedding_bag(flat_idx, table, mode="sum"),
        ),
        kernel=ops.gather_pool_fwd, make_copy=lambda: clone_group(prow, pslots), copy_bytes=fwd_in,
        library=lambda i, t: F.embedding_bag(i, t, mode="sum"),
        make_lib_copy=lambda: (flat_idx.clone(), table.clone()), lib_bytes=nbytes([flat_idx, table]),
    ))
    bwd_in = gpool.numel() * 4 + nbytes([s.order for s in pslots] + [s.offsets for s in pslots]
                                        + [s.counts for s in pslots])
    bms, by = bound(bwd_in + nbytes(prow), gpool.numel() * flat_idx.shape[1], "float32")
    # a cold copy also holds the index the kernel reads
    bwd_copy = bwd_in + nbytes([s.index for s in pslots])
    single_id = flat_idx.shape[1] == 1
    rows.append(with_cold(
        timed(
            dict(name="gather_pool_bwd", route="cuda", cuda_route="cuda",
                 source="persia_tpu_torch/csrc/embedding_pool.cu", replaces=POOL_REPLACES,
                 shape=shape, dtype=str(prow[0].dtype)[6:],
                 launches=launches["training"]["gather_pool_bwd"],
                 launches_by_path={p: launches[p]["gather_pool_bwd"] for p in ("training", "pipelined", "durable")},
                 max_abs_err=errs["gather_pool_bwd"], bound_ms=bms, bound_by=by,
                 library_note="index_add_ of the (B*S, dim) f32 gradient into the tables side by side (L=1)"),
            kernel=lambda: ops.gather_pool_bwd(gpool, prow, pslots),
            plain=lambda: gather_pool_bwd_reference(gpool, prow, pslots),
            library=(lambda: acc.index_add_(0, flat_idx[:, 0], grad_flat)) if single_id else None,
        ),
        kernel=lambda gr, r, sl: ops.gather_pool_bwd(gr, r, sl),
        make_copy=lambda: (gpool.clone(), *clone_group(prow, pslots)), copy_bytes=bwd_copy,
        library=(lambda i, gr: acc.index_add_(0, i, gr)) if single_id else None,
        make_lib_copy=lambda: (flat_idx[:, 0].clone(), grad_flat.clone()),
        lib_bytes=nbytes([flat_idx[:, 0], grad_flat]),
    ))
    # the backward's two passes apart (torch.profiler), and its time where
    # every position of each slot hits one row (the bench shape otherwise)
    _, top, _ = device_busy_ms(lambda _: ops.gather_pool_bwd(gpool, prow, pslots), [None] * 20)
    rows[-1]["pass_ms"] = {re.search(r"segment_sum_\w+", k).group(0): v for k, v in top.items()
                           if "segment_sum" in k}
    one_rows, one_slots = pool_inputs(dev, prow[0].dtype, bsz, [(p_rows - 1, 1, False)] * len(prow),
                                      seed=SEED, ids="one_row")
    rows[-1]["one_row_ms"] = graph_ms(lambda: ops.gather_pool_bwd(gpool, one_rows, one_slots))

    # the fused tier's kernels at the fused path's own inputs (one bench
    # batch of 26 x 4096 ids, the stacked 26M x 16 table and its Adagrad
    # state, as phase 4e left them); warm (the same batch each call) and
    # cold (fresh batches, rotated: the rows they name spread over the
    # 1.66 GB table, > 72 MB of distinct rows in all), the share read from
    # the cold time
    from persia_tpu_torch.ops.fused_gather import fused_gather_reference, gather_rows
    from persia_tpu_torch.ops.sparse_update import (
        PAD_SENTINEL, sparse_update_reference, sparse_update_sorted, update_keys_reference,
    )

    grp, tbl, acc, cfg = fused["group"], fused["table"], fused["state"], fused["cfg"]
    vocabs = [VOCAB] * len(grp.slots)
    fresh = np.random.default_rng(SEED + 7)

    def fresh_ids(kind):
        """One fresh batch's ids per slot, as ``fused_host_batches`` draws
        them (zipf with a fresh per-slot shift: other hot rows each time)."""
        if kind == "uniform":
            ids = [fresh.integers(0, VOCAB, BATCH, dtype=np.int32) for _ in grp.slots]
        else:
            ids = [((fresh.zipf(1.2, BATCH) - 1 + fresh.integers(0, VOCAB)) % VOCAB).astype(np.int32)
                   for _ in grp.slots]
        return [torch.from_numpy(i).to(dev) for i in ids]

    def flat_rows(ids):
        return torch.cat([gather_rows(i, o, VOCAB, True) for i, o in zip(ids, grp.offsets)])

    ids = [fused["batch"]["ids"][nm] for nm in grp.slots]
    n_pos = sum(i.numel() for i in ids)
    k4_rows = flat_rows(ids)
    k4_copy = n_pos * 4 + n_pos * EMB_DIM * 4  # the ids and the rows they name
    # K4 as the step calls it, with the update keys: the ids read, each row
    # read and written, each key written; beside it K4 without keys (its
    # bound without the keys), before and after, so drift shows
    bms, by = bound(n_pos * 4 + 2 * n_pos * EMB_DIM * 4 + n_pos * 4, 0, "float32")
    no_keys = lambda: ops.fused_gather(tbl, ids, grp.offsets, vocabs, True)  # noqa: E731
    no_keys_cold = lambda: cold_ms(lambda i: ops.fused_gather(tbl, i, grp.offsets, vocabs, True),  # noqa: E731
                                   lambda: (fresh_ids("uniform"),), k4_copy)["ms"]
    nk_warm, nk_cold = [graph_ms(no_keys)], [no_keys_cold()]
    rows.append(with_cold(
        timed(
            dict(name="fused_gather", route="cuda", cuda_route="cuda", source=K4_SOURCE, replaces=K4_REPLACES,
                 shape=[n_pos, EMB_DIM, tbl.shape[0]], dtype="float32", keys=True,
                 launches=launches["fused"]["fused_gather"],
                 max_abs_err=errs["fused_gather"], bound_ms=bms, bound_by=by,
                 registers=build.get("fused_gather_kernel<uint4>", {}).get("registers"),
                 plain_note="fused_gather_reference and update_keys_reference",
                 library_note="torch.index_select of the table at the clamped, offset rows (int64); the rows "
                              "only: no one PyTorch call computes the keys"),
            kernel=lambda: ops.fused_gather(tbl, ids, grp.offsets, vocabs, True, keys=True),
            plain=lambda: (fused_gather_reference(tbl, ids, grp.offsets, vocabs, True),
                           update_keys_reference(ids, grp.offsets, vocabs)),
            library=lambda: torch.index_select(tbl, 0, k4_rows),
        ),
        kernel=lambda i: ops.fused_gather(tbl, i, grp.offsets, vocabs, True, keys=True),
        make_copy=lambda: (fresh_ids("uniform"),), copy_bytes=k4_copy,
        library=lambda r: torch.index_select(tbl, 0, r),
        make_lib_copy=lambda: (flat_rows(fresh_ids("uniform")),), lib_bytes=n_pos * 8 + n_pos * EMB_DIM * 4,
    ))
    nk_warm.append(graph_ms(no_keys))
    nk_cold.append(no_keys_cold())
    k4 = rows[-1]
    k4.update(no_keys_ms=min(nk_warm), no_keys_ms_runs=nk_warm, no_keys_cold_ms=min(nk_cold),
              no_keys_cold_ms_runs=nk_cold, no_keys_bound_ms=bound(n_pos * 4 + 2 * n_pos * EMB_DIM * 4, 0,
                                                                    "float32")[0])
    k4.update(routing_cost_ms=k4["ms"] - k4["no_keys_ms"], routing_cost_cold_ms=k4["cold_ms"] - k4["no_keys_cold_ms"])

    def k5_inputs(ids):
        """K5's inputs for one batch: the step's sentinel-routed update ids,
        sorted; gradients of the step's size; the touched rows; the bound."""
        flat = update_keys_reference(ids, grp.offsets, vocabs)
        sids, perm = torch.sort(flat, stable=True)
        grads = torch.randn((flat.numel(), EMB_DIM), generator=g).to(dev) * 1e-3
        touched = int(torch.unique(sids[sids != PAD_SENTINEL]).numel())
        n = flat.numel()
        # sorted ids, permutation and gradients read once; each touched
        # row and its accumulator read and written once; the segment sums
        # and ~8 operations a touched element
        nbytes = n * 4 + n * 8 + n * EMB_DIM * 4 + touched * EMB_DIM * 4 * 4
        b_, by_ = bound(nbytes + 8, n * EMB_DIM + touched * EMB_DIM * 8, "float32")
        return flat, sids, perm, grads, touched, nbytes, b_, by_

    bs = torch.ones(2, device=dev)
    k5 = {}
    for kind in ("uniform", "zipf"):
        batch = fused["batch" if kind == "uniform" else "zipf_batch"]
        flat, sids, perm, grads, touched, k5_bytes, bms, by = k5_inputs([batch["ids"][nm] for nm in grp.slots])
        runs = [graph_ms(lambda: sparse_update_sorted(cfg, tbl, acc, sids, perm, grads, bs)) for _ in range(2)]
        cold = [cold_ms(lambda si, pe, gr: sparse_update_sorted(cfg, tbl, acc, si, pe, gr, bs),
                        lambda: k5_inputs(fresh_ids(kind))[1:4], k5_bytes) for _ in range(2)]
        sort_ms = graph_ms(lambda: torch.sort(flat, stable=True))
        # each of K5's steps apart (torch.profiler over 20 warm calls)
        _, top, _ = device_busy_ms(lambda _: sparse_update_sorted(cfg, tbl, acc, sids, perm, grads, bs), [None] * 20)
        stages = {re.search(r"sparse_update_\w+_kernel|Memset", k).group(0): v for k, v in top.items()
                  if "sparse_update" in k or "Memset" in k}
        longest = longest_segment(sids)
        print(f"  sparse_update {kind}: {touched} rows touched, longest segment {longest}; warm {runs} ms, cold "
              f"{[c['ms'] for c in cold]} ms (bound {bms:.5f}); torch.sort {sort_ms:.5f} ms; steps {stages}",
              flush=True)
        k5[kind] = dict(ms=min(runs), ms_runs=runs, cold_ms=min(c["ms"] for c in cold),
                        longest_segment=longest, stage_ms=stages,
                        cold_ms_runs=[c["ms"] for c in cold], cold_copies=cold[0]["copies"], sort_ms=sort_ms,
                        bound_ms=bms, bound_by=by, touched_rows=touched, bytes=k5_bytes,
                        eager_ms=eager_ms(lambda: sparse_update_sorted(cfg, tbl, acc, sids, perm, grads, bs)),
                        # its boolean masks synchronise: timed eagerly, sort included
                        plain_ms=eager_ms(lambda: sparse_update_reference(cfg, tbl, acc, flat, grads, bs),
                                          iters=10, warmup=2))
    u, z = k5["uniform"], k5["zipf"]
    # every position of the batch on one row: one long segment
    one = torch.full((n_pos,), grp.offsets[0] + 5, dtype=torch.int32, device=dev)
    one_perm = torch.arange(n_pos, device=dev)
    one_grads = torch.randn((n_pos, EMB_DIM), generator=g).to(dev) * 1e-3
    one_row_ms = min(graph_ms(lambda: sparse_update_sorted(cfg, tbl, acc, one, one_perm, one_grads, bs))
                     for _ in range(2))
    print(f"  sparse_update one row ({n_pos} positions): {one_row_ms:.5f} ms", flush=True)
    rows.append(dict(
        name="sparse_update", route="cuda", cuda_route="cuda", source=K5_SOURCE, replaces=K5_REPLACES,
        shape=[n_pos, EMB_DIM, tbl.shape[0]], dtype="float32", optimizer="Adagrad(lr=0.05)",
        launches=launches["fused"]["sparse_update"], max_abs_err=errs["sparse_update"],
        ms=u["ms"], ms_runs=u["ms_runs"], eager_ms=u["eager_ms"], bound_ms=u["bound_ms"], bound_by=u["bound_by"],
        cold_ms=u["cold_ms"], cold_ms_runs=u["cold_ms_runs"], cold_copies=u["cold_copies"],
        cold_bytes_per_copy=u["bytes"], cold_share=u["bound_ms"] / u["cold_ms"],
        plain_ms=u["plain_ms"], plain_note="eager (boolean masks synchronise), the sort included",
        library_ms=None, library_note="none: no PyTorch call computes it",
        sort_ms=u["sort_ms"], touched_rows=u["touched_rows"],
        zipf_ms=z["ms"], zipf_ms_runs=z["ms_runs"], zipf_cold_ms=z["cold_ms"], zipf_cold_ms_runs=z["cold_ms_runs"],
        zipf_bound_ms=z["bound_ms"], zipf_cold_share=z["bound_ms"] / z["cold_ms"], zipf_sort_ms=z["sort_ms"],
        zipf_plain_ms=z["plain_ms"], zipf_touched_rows=z["touched_rows"],
        longest_segment=u["longest_segment"], zipf_longest_segment=z["longest_segment"],
        stage_ms=u["stage_ms"], zipf_stage_ms=z["stage_ms"], one_row_ms=one_row_ms,
    ))
    # the standalone routing pass (the graph step's warm-up; the step routes
    # inside K4) at the fused path's own batch: reads the ids, writes the
    # keys; its plain version (per-slot comparisons, a where, a cast and the
    # cat) and torch.sort beside it. Its launches: the graph step's capture
    # (the eager step launches it never)
    bms, by = bound(2 * n_pos * 4, 0, "float32")
    rows.append(timed(
        dict(name="update_keys", route="cuda", cuda_route="cuda", source=K5_SOURCE, replaces=ROUTING_REPLACES,
             shape=[len(ids), BATCH], dtype="int32", launches=launches["fused_capture"]["update_keys"],
             launches_by_path={"fused graph step's capture": launches["fused_capture"]["update_keys"],
                               "fused eager step": launches["fused"]["update_keys"]},
             max_abs_err=errs["update_keys"], bound_ms=bms, bound_by=by, sort_ms=u["sort_ms"],
             library_note="none: no one PyTorch call computes it"),
        kernel=lambda: ops.update_keys(ids, grp.offsets, vocabs),
        plain=lambda: update_keys_reference(ids, grp.offsets, vocabs),
    ))
    # K6-K9 at the DIN path's own inputs (one staged step of phase 4g: the
    # two raw slots of B x L positions with their CSR, the f32 wire) and,
    # for K8/K9, that step's history rows cast to bf16 as the model casts
    # them, with its masks; warm and cold (> 72 MB of input copies)
    from persia_tpu_torch.ops.attention_pool import attention_pool_bwd_reference, attention_pool_fwd_reference
    from persia_tpu_torch.ops.raw_gather import raw_gather_bwd_reference, raw_gather_fwd_reference

    raw_e = [e for e in din_batch["emb"] if "mask" in e]
    rrows = [e["distinct"] for e in raw_e]
    rslots = [ops.RawSlot(e["index"], e["order"], e["offsets"], e["long_chunks"]) for e in raw_e]
    gathered = ops.raw_gather_fwd(rrows, rslots)
    n_slots, bsz, hist_len, dim = gathered.shape
    elem = gathered.element_size()
    din_launches = {p: {k: launches[p][k] for k in DIN_KERNELS} for p in ("din_training", "din_serving")}
    table = torch.cat(rrows)
    starts = np.cumsum([0] + [r.shape[0] for r in rrows[:-1]])
    flat = torch.cat([s.index.reshape(-1).long() + int(o) for s, o in zip(rslots, starts)])

    def clone_raw(rows_, slots_):
        return [r.clone() for r in rows_], [ops.RawSlot(*map(clone, s)) for s in slots_]

    # K6 reads the index and the distinct rows it names, writes the positions' rows
    named = sum(int(torch.unique(s.index).numel()) for s in rslots) * dim * elem
    idx_bytes = nbytes([s.index for s in rslots])
    bms, by = bound(idx_bytes + named + gathered.numel() * elem, 0, "float32")
    raw_copy = nbytes(rrows) + idx_bytes
    rows.append(with_cold(
        timed(
            dict(name="raw_gather_fwd", route="cuda", cuda_route="cuda", source=RAW_SOURCE, replaces=RAW_REPLACES,
                 shape=[n_slots, bsz, hist_len, dim], dtype=str(gathered.dtype)[6:],
                 launches=launches["din_training"]["raw_gather_fwd"],
                 launches_by_path={p: v["raw_gather_fwd"] for p, v in din_launches.items()},
                 max_abs_err=errs["raw_gather_fwd"], bound_ms=bms, bound_by=by, named_rows_bytes=named,
                 library_note="torch.index_select of the slots' rows side by side (int64 index)"),
            kernel=lambda: ops.raw_gather_fwd(rrows, rslots),
            plain=lambda: raw_gather_fwd_reference(rrows, rslots),
            library=lambda: torch.index_select(table, 0, flat),
        ),
        kernel=lambda r, s: ops.raw_gather_fwd(r, s), make_copy=lambda: clone_raw(rrows, rslots), copy_bytes=raw_copy,
        library=lambda t, i: torch.index_select(t, 0, i),
        make_lib_copy=lambda: (table.clone(), flat.clone()), lib_bytes=nbytes([table, flat]),
    ))
    # K7 reads the live positions' gradients and their CSR entries, writes
    # every distinct row (the pad row's positions are not in the CSR)
    rgrad = torch.randn(gathered.shape, generator=g).to(dev, gathered.dtype)
    live = [int(s.offsets[-1]) for s in rslots]
    csr_bytes = nbytes([s.offsets for s in rslots]) + 4 * sum(live)
    bms, by = bound(sum(live) * dim * elem + csr_bytes + nbytes(rrows), sum(live) * dim, "float32")
    acc_lib = torch.zeros(table.shape, device=dev, dtype=table.dtype)
    rgrad_flat = rgrad.reshape(-1, dim)
    pad_rows = torch.cat([torch.full((s.index.numel(),), int(o) + r.shape[0] - 1, device=dev)
                          for s, o, r in zip(rslots, starts, rrows)])
    live_sel = torch.nonzero(flat != pad_rows).reshape(-1)
    flat_live, rgrad_live = flat[live_sel], rgrad_flat[live_sel]
    longest = [int((s.offsets[1:] - s.offsets[:-1]).max()) for s in rslots]
    rows.append(with_cold(
        timed(
            dict(name="raw_gather_bwd", route="cuda", cuda_route="cuda", source=RAW_SOURCE, replaces=RAW_REPLACES,
                 shape=[n_slots, bsz, hist_len, dim], dtype=str(gathered.dtype)[6:],
                 launches=launches["din_training"]["raw_gather_bwd"],
                 launches_by_path={p: v["raw_gather_bwd"] for p, v in din_launches.items()},
                 max_abs_err=errs["raw_gather_bwd"], bound_ms=bms, bound_by=by,
                 live_positions=live, longest_segment=longest,
                 library_note="Tensor.index_add_ (atomic) of the live positions' gradients into the slots' rows "
                              "side by side, in the wire dtype"),
            kernel=lambda: ops.raw_gather_bwd(rgrad, rrows, rslots),
            plain=lambda: raw_gather_bwd_reference(rgrad, rrows, rslots),
            library=lambda: acc_lib.index_add_(0, flat_live, rgrad_live),
        ),
        kernel=lambda gr, r, sl: ops.raw_gather_bwd(gr, r, sl),
        make_copy=lambda: (rgrad.clone(), *clone_raw(rrows, rslots)),
        copy_bytes=rgrad.numel() * elem + nbytes([s.order for s in rslots] + [s.offsets for s in rslots]) + raw_copy,
        library=lambda i, gr: acc_lib.index_add_(0, i, gr),
        make_lib_copy=lambda: (flat_live.clone(), rgrad_live.clone()), lib_bytes=nbytes([flat_live, rgrad_live]),
    ))
    # K7 with every position of both slots on one row (long rows: a block a
    # chunk), and the device's events over 20 calls by name (a kernel a
    # call, no memset; the trace may miss some events, so they are counted
    # by name, not held to 20)
    one_rows, one_slots = raw_inputs(dev, gathered.dtype, SEED, "one_row", batch=bsz, hist=hist_len,
                                     distinct=[r.shape[0] - 1 for r in rrows])
    k7 = rows[-1]
    k7["one_row_ms"] = min(graph_ms(lambda: ops.raw_gather_bwd(rgrad, one_rows, one_slots)) for _ in range(2))
    _, top, runs = device_busy_ms(lambda _: ops.raw_gather_bwd(rgrad, rrows, rslots), [None] * 20)
    k7["trace_20_calls"] = {"raw_gather_bwd_kernel": runs["raw_gather_bwd_kernel"],
                            "segment_sum": runs["segment_sum_chunks_kernel"] + runs["segment_sum_rows_kernel"],
                            "device_events_ms_a_call": top}
    k7["index_add_over_kernel"] = {"warm": k7["library_ms"] / k7["ms"], "cold": k7["library_cold_ms"] / k7["cold_ms"]}
    print(f"  raw_gather_bwd: live positions {live} of {bsz * hist_len} a slot, longest segment {longest}; "
          f"warm {k7['ms']:.5f} ms, cold {k7['cold_ms']:.5f} ms; index_add_ {k7['library_ms']:.5f} warm, "
          f"{k7['library_cold_ms']:.5f} cold (index_add_ / K7: {k7['index_add_over_kernel']['warm']:.3f} warm, "
          f"{k7['index_add_over_kernel']['cold']:.3f} cold); one row of {bsz * hist_len} positions a slot "
          f"{k7['one_row_ms']:.5f} ms; 20 calls in the trace: {k7['trace_20_calls']}", flush=True)

    # K8, K9: the step's masks and history rows in bf16; a masked position's
    # row is not needed (bound: the valid positions' rows)
    mask = raw_e[0]["mask"]
    hist = gathered[0].to(torch.bfloat16)
    logits = torch.randn(mask.shape, generator=g).to(dev)
    valid = int(mask.sum())
    out, w = ops.attention_pool_fwd(logits, mask, hist)
    d_out = torch.randn(out.shape, generator=g).to(dev, torch.bfloat16)
    small = logits.numel() * 4 + mask.numel()  # logits or d_logits, the mask
    bms, by = bound(small + valid * dim * 2 + out.numel() * 2 + w.numel() * 4, valid * dim * 2, "float32")
    masked = torch.where(mask, logits, float("-inf"))
    att_copy = nbytes([logits, mask, hist])

    def composite():  # two PyTorch calls: softmax over L, then the weighted sum
        return torch.bmm(torch.softmax(masked, dim=1).to(torch.bfloat16)[:, None, :], hist)

    rows.append(with_cold(
        timed(
            dict(name="attention_pool_fwd", route="cuda", cuda_route="cuda", source=ATT_SOURCE, replaces=ATT_REPLACES,
                 shape=[bsz, hist_len, dim], dtype="bfloat16", valid_positions=valid,
                 launches=launches["din_training"]["attention_pool_fwd"],
                 launches_by_path={p: v["attention_pool_fwd"] for p, v in din_launches.items()},
                 max_abs_err=errs["attention_pool_fwd"], bound_ms=bms, bound_by=by,
                 registers=build.get(f"attention_pool_fwd_kernel<{ATT_DIN_TEMPLATE}>", {}).get("registers"),
                 composite_ms=min(graph_ms(composite) for _ in range(2)),
                 library_note="none: no one PyTorch call computes it; composite_ms is torch.softmax + torch.bmm "
                              "(two calls, no mask on empty rows)"),
            kernel=lambda: ops.attention_pool_fwd(logits, mask, hist),
            plain=lambda: attention_pool_fwd_reference(logits, mask, hist),
        ),
        kernel=lambda lg, m, h: ops.attention_pool_fwd(lg, m, h),
        make_copy=lambda: (logits.clone(), mask.clone(), hist.clone()), copy_bytes=att_copy,
    ))
    # reads d_out, the mask, the valid rows and w; writes d_hist and d_logits
    bms, by = bound(small + d_out.numel() * 2 + valid * dim * 2 + w.numel() * 4 + hist.numel() * 2,
                    3 * valid * dim, "float32")
    rows.append(with_cold(
        timed(
            dict(name="attention_pool_bwd", route="cuda", cuda_route="cuda", source=ATT_SOURCE, replaces=ATT_REPLACES,
                 shape=[bsz, hist_len, dim], dtype="bfloat16", valid_positions=valid,
                 launches=launches["din_training"]["attention_pool_bwd"],
                 launches_by_path={p: v["attention_pool_bwd"] for p, v in din_launches.items()},
                 max_abs_err=errs["attention_pool_bwd"], bound_ms=bms, bound_by=by,
                 registers=build.get(f"attention_pool_bwd_kernel<{ATT_DIN_TEMPLATE}>", {}).get("registers"),
                 library_note="none: no one PyTorch call computes it"),
            kernel=lambda: ops.attention_pool_bwd(d_out, mask, hist, w),
            plain=lambda: attention_pool_bwd_reference(d_out, mask, hist, w),
        ),
        kernel=lambda d, m, h, w_: ops.attention_pool_bwd(d, m, h, w_),
        make_copy=lambda: (d_out.clone(), mask.clone(), hist.clone(), w.clone()),
        copy_bytes=att_copy + nbytes([d_out, w]) - logits.numel() * 4,
    ))
    # K9 is one kernel a call: the device's events over 20 calls by name
    k9 = rows[-1]
    _, top, runs = device_busy_ms(lambda _: ops.attention_pool_bwd(d_out, mask, hist, w), [None] * 20)
    k9["trace_20_calls"] = {"attention_pool_bwd_kernel": runs["attention_pool_bwd_kernel"],
                            "device_events_ms_a_call": top}
    print(f"  attention_pool_bwd: warm {k9['ms']:.5f} ms, cold {k9['cold_ms']:.5f} ms, bound {k9['bound_ms']:.5f} "
          f"({k9['bound_ms'] / k9['cold_ms']:.1%} cold); registers {k9['registers']} at <{ATT_DIN_TEMPLATE}>; "
          f"20 calls in the trace: {k9['trace_20_calls']}", flush=True)
    if not runs["attention_pool_bwd_kernel"] or any("attention_pool_bwd_kernel" not in n for n in top):
        raise SystemExit(f"attention_pool_bwd ran other device work than its kernel: {top}")
    # K10 and K11 at the DNN training path's first batch norm (serving-bench
    # width: B=4096, C=128, bf16) and, beside it, its second (C=32) and
    # the serving path's eval mode (B=256); warm and cold. Bound: x (and
    # dy) read once, y (dx) written once, the (C,) parameters and
    # statistics; the kernels read x twice, the second time from L2.
    # library: F.batch_norm(training=True) and aten's
    # native_batch_norm_backward on the same inputs (their running variance
    # is the unbiased one: a time comparison only)
    from persia_tpu_torch.ops.batch_norm import batch_norm_bwd_reference, batch_norm_fwd_reference

    bn_paths = ("dnn_adult", "dnn_training", "dnn_serving", "dnn_resume")
    bn_launches = {p: {k: launches[p][k] for k in BN_KERNELS} for p in bn_paths}
    bx, bdy, bscale, bbias, bmean, bvar = bn_inputs(dev, BATCH, 128, torch.bfloat16, SEED + 11)
    brm, brv, lrm, lrv = bmean.clone(), bvar.clone(), bmean.clone(), bvar.clone()
    n_el, cols = bx.numel(), bx.shape[1]
    _, bsaved = ops.batch_norm_fwd(bx, bscale, bbias, brm, brv, True)
    lib_saved = torch.ops.aten.native_batch_norm(bx, bscale, bbias, lrm, lrv, True, 0.01, 1e-5)[1:]

    def bn_fwd_lib(x_):
        return F.batch_norm(x_, lrm, lrv, bscale, bbias, True, 0.01, 1e-5)

    def bn_bwd_lib(dy_, x_):
        return torch.ops.aten.native_batch_norm_backward(dy_, x_, bscale, lrm, lrv, *lib_saved, True, 1e-5,
                                                         [True, True, True])

    def bn_extra(fn, b_, c_, train):
        x_, dy_, sc_, bi_, m_, v_ = bn_inputs(dev, b_, c_, torch.bfloat16, SEED + b_ + c_)
        _, sv_ = ops.batch_norm_fwd(x_, sc_, bi_, m_.clone(), v_.clone(), train)
        if fn == "fwd":
            return min(graph_ms(lambda: ops.batch_norm_fwd(x_, sc_, bi_, m_, v_, train)) for _ in range(2))
        return min(graph_ms(lambda: ops.batch_norm_bwd(dy_, x_, sc_, sv_, train)) for _ in range(2))

    bms, by = bound(2 * n_el * 2 + 4 * cols * 9, 8 * n_el, "float32")
    rows.append(with_cold(
        timed(
            dict(name="batch_norm_fwd", route="cuda", cuda_route="cuda", source=BN_SOURCE, replaces=BN_REPLACES,
                 shape=[BATCH, cols], dtype="bfloat16", launches=launches["dnn_training"]["batch_norm_fwd"],
                 launches_by_path={p: v["batch_norm_fwd"] for p, v in bn_launches.items()},
                 max_abs_err=errs["batch_norm_fwd"], bound_ms=bms, bound_by=by,
                 registers=build.get("batch_norm_fwd_kernel<bf16,8>", {}).get("registers"),
                 c32_ms=bn_extra("fwd", BATCH, 32, True), eval_256_ms=bn_extra("fwd", DNN_SERVE_BATCH, 128, False),
                 library_note="F.batch_norm(training=True), f32 parameters over bf16 x: its running variance is "
                              "the unbiased one, a time comparison only"),
            kernel=lambda: ops.batch_norm_fwd(bx, bscale, bbias, brm, brv, True),
            plain=lambda: batch_norm_fwd_reference(bx, bscale, bbias, brm, brv, True),
            library=lambda: bn_fwd_lib(bx),
        ),
        kernel=lambda x_: ops.batch_norm_fwd(x_, bscale, bbias, brm, brv, True), make_copy=lambda: (bx.clone(),),
        copy_bytes=n_el * 2, library=bn_fwd_lib, make_lib_copy=lambda: (bx.clone(),), lib_bytes=n_el * 2,
    ))
    bms, by = bound(3 * n_el * 2 + 4 * cols * 6, 12 * n_el, "float32")
    rows.append(with_cold(
        timed(
            dict(name="batch_norm_bwd", route="cuda", cuda_route="cuda", source=BN_SOURCE, replaces=BN_REPLACES,
                 shape=[BATCH, cols], dtype="bfloat16", launches=launches["dnn_training"]["batch_norm_bwd"],
                 launches_by_path={p: v["batch_norm_bwd"] for p, v in bn_launches.items()},
                 max_abs_err=errs["batch_norm_bwd"], bound_ms=bms, bound_by=by,
                 registers=build.get("batch_norm_bwd_kernel<bf16,8>", {}).get("registers"),
                 c32_ms=bn_extra("bwd", BATCH, 32, True),
                 library_note="torch.ops.aten.native_batch_norm_backward (dx, dscale, dbias) from "
                              "native_batch_norm's saved mean and invstd"),
            kernel=lambda: ops.batch_norm_bwd(bdy, bx, bscale, bsaved, True),
            plain=lambda: batch_norm_bwd_reference(bdy, bx, bscale, bsaved, True),
            library=lambda: bn_bwd_lib(bdy, bx),
        ),
        kernel=lambda dy_, x_: ops.batch_norm_bwd(dy_, x_, bscale, bsaved, True),
        make_copy=lambda: (bdy.clone(), bx.clone()), copy_bytes=2 * n_el * 2,
        library=bn_bwd_lib, make_lib_copy=lambda: (bdy.clone(), bx.clone()), lib_bytes=2 * n_el * 2,
    ))
    for r in rows[-2:]:
        print(f"  {r['name']} ({BATCH}, {cols}) bf16: warm {r['ms']:.5f} ms, cold {r['cold_ms']:.5f} ms, bound "
              f"{r['bound_ms']:.5f} ({r['cold_share']:.1%} cold); plain {r['plain_ms']:.5f}; library "
              f"{r['library_ms']:.5f} warm, {r['library_cold_ms']:.5f} cold; C=32 {r['c32_ms']:.5f}; registers "
              f"{r['registers']}; launches {r['launches_by_path']}", flush=True)
    uk = next(r for r in rows if r["name"] == "update_keys")
    uk["over_launch_floor"] = uk["ms"] / min(floor)
    print(f"  update_keys warm {uk['ms']:.5f} ms = {uk['over_launch_floor']:.3f}x the launch floor "
          f"{min(floor):.5f} ms", flush=True)
    print(f"  fused_gather with keys warm {k4['ms_runs']} cold {k4['cold_ms_runs']} ms (bound {k4['bound_ms']:.5f}, "
          f"{k4['cold_share']:.1%} cold), without keys warm {k4['no_keys_ms_runs']} cold {k4['no_keys_cold_ms_runs']} "
          f"ms (bound {k4['no_keys_bound_ms']:.5f}); registers {k4['registers']}; the routing inside K4 costs "
          f"{k4['routing_cost_ms']:.5f} ms warm, {k4['routing_cost_cold_ms']:.5f} cold, against "
          f"{uk['ms']:.5f} ms as the standalone launch (launch floor {floor})", flush=True)
    for r in rows:
        print(json.dumps({"kernel_timing": r, "card": card}), flush=True)
    return rows, floor


# --ab's K4 cases: (label, dtype, dim, slot shapes, vocab, stacked); the
# bench's batch (26 stacked slots of 4,096 from the 26M x 16 f32 table, its
# rows at the fused step's size) and edges of the vector width and slots
K4_AB_CASES = [
    ("bench", "float32", EMB_DIM, [(BATCH,)] * N_SLOTS, VOCAB, True),
    ("bf16_pooled", "bfloat16", EMB_DIM, [(512,), (512, 5)], 1000, True),
    ("unstacked_nan", "float32", EMB_DIM, [(777,)], 1000, False),
    ("dim_10", "float32", 10, [(300,), (50, 2)], 200, True),
    ("dim_3_f32", "float32", 3, [(300,)], 200, True),
    ("dim_3_bf16", "bfloat16", 3, [(300,)], 200, True),
    ("129_slots", "float32", EMB_DIM, [(64,)] * 129, 50, True),
]


def k4_ab(dev, ops, times, as_bits) -> dict:
    """``--ab``'s K4: each ``K4_AB_CASES`` case's rows (and, where this
    tree's ``fused_gather`` takes ``keys``, its rows and keys with them)
    and the plain routing's keys, as bits; into ``times``, at the bench
    case, K4 warm and cold without keys and with them (in turns), the
    standalone ``update_keys`` and the one-launch floor."""
    import inspect

    import torch

    from persia_tpu_torch.ops.sparse_update import update_keys_reference

    has_keys = "keys" in inspect.signature(ops.fused_gather).parameters
    rng = np.random.default_rng(SEED + 13)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    bits = {}
    for label, dtype, dim, shapes, vocab, stacked in K4_AB_CASES:
        table = torch.randn((vocab * len(shapes), dim), device=dev, generator=g).to(getattr(torch, dtype))
        ids = []
        for shape in shapes:
            a = rng.integers(-1, vocab + 3, shape).astype(np.int32)
            a.reshape(-1)[:4] = [vocab + 7, -1, vocab - 1, 1 << 30]
            ids.append(torch.from_numpy(a).to(dev))
        offs, vocabs = ([i * vocab for i in range(len(shapes))] if stacked else [0]), [vocab] * len(shapes)
        bits[f"k4_rows_{label}"] = as_bits(ops.fused_gather(table, ids, offs, vocabs, stacked))
        bits[f"k4_keys_ref_{label}"] = as_bits(update_keys_reference(ids, offs, vocabs))
        if has_keys:
            rows, keys = ops.fused_gather(table, ids, offs, vocabs, stacked, keys=True)
            bits[f"k4_rows_keys_{label}"], bits[f"k4_keys_{label}"] = as_bits(rows), as_bits(keys)
        if label != "bench":
            continue
        n_pos = sum(i.numel() for i in ids)
        fresh_rng = np.random.default_rng(SEED + 14)  # the cold calls' batches, apart from the cases' ids

        def fresh():
            return ([torch.from_numpy(fresh_rng.integers(0, vocab, BATCH, dtype=np.int32)).to(dev)
                     for _ in shapes],)

        def k4_times(kw):
            return {"warm_ms": graph_ms(lambda: ops.fused_gather(table, ids, offs, vocabs, True, **kw)),
                    "cold_ms": cold_ms(lambda i: ops.fused_gather(table, i, offs, vocabs, True, **kw), fresh,
                                       n_pos * 4 + n_pos * dim * 4)["ms"]}

        sides = [{}, {"keys": True}, {"keys": True}, {}] if has_keys else [{}, {}]
        runs = [(bool(kw), k4_times(kw)) for kw in sides]
        for name, with_keys in (("fused_gather", False), ("fused_gather_keys", True)):
            mine = [t for k, t in runs if k == with_keys]
            if mine:
                times[name] = {"warm_ms": [t["warm_ms"] for t in mine], "cold_ms": [t["cold_ms"] for t in mine]}
        times["update_keys"] = {"warm_ms": [graph_ms(lambda: ops.update_keys(ids, offs, vocabs)) for _ in range(2)]}
        one = torch.zeros(1, device=dev)
        times["launch_floor"] = {"warm_ms": [graph_ms(lambda: one.add_(1.0)) for _ in range(2)]}
        del table
    return bits


def ab_run(root: str, out_path: str) -> int:
    """``--ab ROOT OUT.npz``: K2, K4, K7, K8 and K9 of the package in the
    checkout ROOT (another commit's tree, unpacked), on this script's
    seeded inputs: phase 3c's for K7 (both dtypes, the Taobao histories
    and every position on one row), K8 and K9 (both dtypes, the DIN shape
    and ``ATT_EDGE_CASES``), phase 3's
    zipf(1.2) bench case for K2, ``K4_AB_CASES`` for K4 (without keys and,
    where the tree's K4 writes them, with; the plain routing beside them).
    Their outputs' bits go to OUT.npz; their
    graph-replayed times, warm and cold (K7 beside ``index_add_`` over the
    live positions, at f32; K8 and K9 at bf16; K4 at the fused step's batch
    with and without keys, the standalone ``update_keys`` and the
    one-launch floor), are printed as one JSON
    line. Run it over two trees in turns (A, B, B, A) in one call, then
    ``--ab-compare``."""
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import torch

    import persia_tpu_torch
    from persia_tpu_torch import ops

    from persia_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    pkg = str(pathlib.Path(persia_tpu_torch.__file__).resolve().parent)
    _kernels.library()
    if _kernels.build_log:  # registers, shared memory and spills of this tree's K2, K4, K7-K9
        summary = build_summary(_kernels.build_log, _kernels.library_path())
        print(json.dumps({"ab_build": {k: v for k, v in summary.items()
                                       if k.split("<")[0] in DIN_KERNEL_NAMES + K2_KERNEL_NAMES
                                       or k.startswith(("segment_sum", "fused_gather_kernel"))}, "package": pkg}),
              flush=True)
    as_bits = lambda t: t.contiguous().view(torch.uint8).cpu().numpy()  # noqa: E731
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    bits, times = {"root": np.array(str(pathlib.Path(root).resolve()))}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        logits, mask, hist, d_out = att_inputs(dev, dtype, SEED + 3)
        out, w = ops.attention_pool_fwd(logits, mask, hist)
        d_logits, d_hist = ops.attention_pool_bwd(d_out, mask, hist, w)
        bits.update({f"att_fwd_out_{name}": as_bits(out), f"att_fwd_w_{name}": as_bits(w),
                     f"att_bwd_dlogits_{name}": as_bits(d_logits), f"att_bwd_dhist_{name}": as_bits(d_hist)})
        for b, l, dim in ATT_EDGE_CASES:  # phase 3c's edge cases
            e_logits, e_mask, e_hist, e_dout = att_inputs(dev, dtype, SEED + 3 + l, b, l, dim, prefix=False)
            e_out, e_w = ops.attention_pool_fwd(e_logits, e_mask, e_hist)
            e_dl, e_dh = ops.attention_pool_bwd(e_dout, e_mask, e_hist, e_w)
            case = f"{name}_{b}x{l}x{dim}"
            bits.update({f"att_fwd_out_{case}": as_bits(e_out), f"att_fwd_w_{case}": as_bits(e_w),
                         f"att_bwd_dlogits_{case}": as_bits(e_dl), f"att_bwd_dhist_{case}": as_bits(e_dh)})
        if dtype == torch.bfloat16:
            copy = nbytes([logits, mask, hist])
            times["attention_pool_fwd"] = {
                "warm_ms": [graph_ms(lambda: ops.attention_pool_fwd(logits, mask, hist)) for _ in range(2)],
                "cold_ms": [cold_ms(lambda lg, m, h: ops.attention_pool_fwd(lg, m, h),
                                    lambda: (logits.clone(), mask.clone(), hist.clone()), copy)["ms"]
                            for _ in range(2)]}
            times["attention_pool_bwd"] = {
                "warm_ms": [graph_ms(lambda: ops.attention_pool_bwd(d_out, mask, hist, w)) for _ in range(2)],
                "cold_ms": [cold_ms(lambda d, m, h, w_: ops.attention_pool_bwd(d, m, h, w_),
                                    lambda: (d_out.clone(), mask.clone(), hist.clone(), w.clone()),
                                    nbytes([d_out, mask, hist, w]))["ms"] for _ in range(2)]}
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    for dtype in (torch.bfloat16, torch.float32):
        for case in ("taobao", "one_row"):
            rows, slots = raw_inputs(dev, dtype, SEED + len(case), case)
            grad = torch.randn((len(rows), DIN_BATCH, DIN_HIST, DIN_DIM), generator=g).to(dev, dtype)
            for i, r in enumerate(ops.raw_gather_bwd(grad, rows, slots)):
                bits[f"k7_{case}_{str(dtype)[6:]}_{i}"] = as_bits(r)
            if dtype == torch.float32:
                key = "raw_gather_bwd" if case == "taobao" else "raw_gather_bwd_one_row"
                times[key] = {"warm_ms": [graph_ms(lambda: ops.raw_gather_bwd(grad, rows, slots))
                                          for _ in range(2)]}
            if dtype == torch.float32 and case == "taobao":
                clone = lambda: (grad.clone(), [r.clone() for r in rows],  # noqa: E731
                                 [ops.RawSlot(*(t.clone() for t in s)) for s in slots])
                times[key]["cold_ms"] = [cold_ms(lambda gr, r, sl: ops.raw_gather_bwd(gr, r, sl), clone,
                                                 nbytes([grad, *rows, *(t for s in slots for t in s)]))["ms"]
                                         for _ in range(2)]
                # index_add_ of the live positions' gradients into the slots' rows side by side
                starts = np.cumsum([0] + [r.shape[0] for r in rows[:-1]])
                flat = torch.cat([s.index.reshape(-1).long() + int(o) for s, o in zip(slots, starts)])
                live = torch.cat([s.index.reshape(-1) != r.shape[0] - 1 for s, r in zip(slots, rows)])
                idx, src = flat[live], grad.reshape(-1, DIN_DIM)[live]
                acc = torch.zeros((sum(r.shape[0] for r in rows), DIN_DIM), device=dev, dtype=dtype)
                times["index_add_"] = {
                    "warm_ms": [graph_ms(lambda: acc.index_add_(0, idx, src)) for _ in range(2)],
                    "cold_ms": [cold_ms(lambda i, x: acc.index_add_(0, i, x), lambda: (idx.clone(), src.clone()),
                                        nbytes([idx, src]))["ms"] for _ in range(2)]}
    rows, slots = pool_inputs(dev, torch.bfloat16, BATCH, [(1500, 1, False)] * N_SLOTS, seed=N_SLOTS, ids="zipf")
    pooled = ops.gather_pool_fwd(rows, slots)
    gpool = torch.randn(pooled.shape, generator=g).to(dev)
    for i, r in enumerate(ops.gather_pool_bwd(gpool, rows, slots)):
        bits[f"k2_zipf_{i}"] = as_bits(r)
    times["gather_pool_bwd"] = {
        "warm_ms": [graph_ms(lambda: ops.gather_pool_bwd(gpool, rows, slots)) for _ in range(2)],
        "cold_ms": [cold_ms(lambda gr: ops.gather_pool_bwd(gr, rows, slots), lambda: (gpool.clone(),),
                            nbytes([gpool]))["ms"] for _ in range(2)]}
    del rows, slots, pooled, gpool
    bits.update(k4_ab(dev, ops, times, as_bits))
    torch.cuda.synchronize()
    np.savez(out_path, **bits)
    print(json.dumps({"ab": {"root": root, "package": pkg, "times": times}, "card": card_line()}), flush=True)
    return 0


def ab_compare(paths) -> int:
    """``--ab-compare A.npz B.npz ...``: K2's, K4's, K8's and K9's bits
    equal in every file that holds them (K4's keys and its rows with keys
    only where the tree's K4 writes keys), K7's in the files of one tree;
    in each file K4's keys equal to the plain routing and its rows with
    keys to its rows without; prints which differ."""
    runs = [dict(np.load(p)) for p in paths]
    report, ok = {}, True
    for key in sorted(set().union(*runs)):
        if key == "root":
            continue
        same_tree = key.startswith("k7_")
        groups = {}
        for run in runs:
            if key in run:
                groups.setdefault(str(run["root"]) if same_tree else "all", []).append(run[key])
        equal = all(np.array_equal(a, group[0]) for group in groups.values() for a in group)
        report[key] = "bitwise" if equal else "DIFFER"
        ok &= equal
    for run in runs:  # within a file: K4's keys against the plain routing, its rows with keys against without
        for key in sorted(k for k in run if k.startswith("k4_keys_") and not k.startswith("k4_keys_ref_")):
            case = key[len("k4_keys_"):]
            equal = (np.array_equal(run[key], run[f"k4_keys_ref_{case}"])
                     and np.array_equal(run[f"k4_rows_keys_{case}"], run[f"k4_rows_{case}"]))
            report[f"{key} vs plain routing, rows with keys vs without ({run['root']})"] = (
                "bitwise" if equal else "DIFFER")
            ok &= equal
    k7_trees = {str(r["root"]) for r in runs}
    if len(k7_trees) == 2:  # K7's bits between the trees: reported, not required
        a, b = ({k: v for k, v in r.items() if k.startswith("k7_")} for r in
                (next(r for r in runs if str(r["root"]) == t) for t in sorted(k7_trees)))
        report["k7_between_trees"] = {k: bool(np.array_equal(a[k], b[k])) for k in sorted(a)}
    print(json.dumps({"ab_compare": report, "files": list(paths), "ok": ok}), flush=True)
    return 0 if ok else 1


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ab"]:
        return ab_run(sys.argv[2], sys.argv[3])
    import persia_tpu_torch  # noqa: F401  (fails where the package is absent)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    build = phase_build()
    errs = {"flash_attention": phase_flash_attention(dev), **phase_kernels(dev), **phase_fused_kernels(dev),
            **phase_din_kernels(dev), **phase_bn_kernels(dev)}
    fa_routes = path_flash_attention(dev)
    serving_launches, serving, feats_shape = path_serving(dev)
    training_launches, training, train_batch = path_training(dev)
    pipelined_launches, pipelined = path_pipelined(dev)
    fused_launches, fused_capture_launches, fused, fused_inputs = path_fused(dev)
    durable_launches, durable = path_durable(dev)
    din_launches, din, din_batch = path_din(dev)
    avazu_launches, avazu = path_avazu(dev)
    dnn_launches, dnn = path_dnn(dev)
    launches = {"flash_attention": fa_routes, "serving": serving_launches,
                "training": training_launches, "pipelined": pipelined_launches,
                "durable": durable_launches, "fused": fused_launches, "fused_capture": fused_capture_launches,
                **din_launches, **dnn_launches}
    rows, floor = phase_timing(dev, card, launches, errs, feats_shape, train_batch, fused_inputs, din_batch, build)
    time_flash_backward(dev, card)
    print(json.dumps({"serving": serving, "card": card}), flush=True)
    print(json.dumps({"training": training, "card": card}), flush=True)
    print(json.dumps({"pipelined": pipelined, "card": card}), flush=True)
    print(json.dumps({"durable": durable, "card": card}), flush=True)
    print(json.dumps({"build": build, "card": card}), flush=True)
    print(json.dumps({"fused": fused, "card": card}), flush=True)
    print(json.dumps({"din": din, "card": card}), flush=True)
    print(json.dumps({"avazu": avazu, "avazu_launches": avazu_launches, "card": card}), flush=True)
    print(json.dumps({"dnn": dnn, "dnn_launches": dnn_launches, "card": card}), flush=True)

    # one entry per kernel (each flash-attention route by its non-causal
    # row); times graph-replayed, eager beside them
    keys = ("name", "route", "cuda_route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "eager_ms",
            "library_eager_ms", "cold_ms", "library_cold_ms", "sort_ms", "zipf_ms", "zipf_cold_ms",
            "zipf_bound_ms", "zipf_sort_ms", "longest_segment", "zipf_longest_segment", "one_row_ms",
            "composite_ms", "registers", "over_launch_floor", "no_keys_ms", "no_keys_cold_ms", "routing_cost_ms",
            "c32_ms", "eval_256_ms")
    kernels = [{k: r.get(k) for k in keys} for r in rows if not r.get("causal")]
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(ab_compare(sys.argv[2:]) if sys.argv[1:2] == ["--ab-compare"] else main())
