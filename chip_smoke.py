#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``persia_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure ends the run with a nonzero exit and no
result line:

1. build the port's CUDA kernels from ``persia_tpu_torch/csrc`` (nvcc,
   sm_90a); the flash-attention kernels' SASS must hold wgmma (HGMMA) and
   TMA loads (UTMALDG), the f32 one without spills;
2. flash_attention on the card vs its plain version (dense f32 softmax):
   the bf16 route (wgmma) and the f32 route (split TF32 on wgmma, its
   pre-pass held bit for bit to ``tf32_split_planes_reference``) at every
   head dim, ragged L=1000;
3. dot_interaction on the card vs its plain version at the serving shape;
4. the paths, each with the launch counts set to 0 just before and read
   just after: the flash-attention entry point at (B=4, L=1024, H=8, D=64)
   in bf16 and in f32, causal and not; and the serving slice at bench
   width — DLRM (13 dense features, 26
   single-id slots of dim 16, bottom (256, 64, 16), top (512, 256)) behind
   ``InferenceEngine(InferCtx(...))``, answering 5 requests of B=4096 zipf
   ids through ``predict_from_bytes``, held against the same engine on the
   CPU;
5. timings of each kernel beside its plain version, the library call that
   computes the same function, and the card's bound, each by CUDA-graph
   replay (host enqueue cost out of the number; eager times beside them):
   flash attention per route and mask (the f32 route's pre-pass also on
   its own), the name of the kernel SDPA runs for f32 (torch.profiler),
   the dot interaction; the serving latency and throughput.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

# the card's published peaks (H100 SXM data sheet, dense): HBM bytes/s and
# operations/s by type (float32: the FMA pipes; tf32: the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}

BATCH, N_DENSE, N_SLOTS, EMB_DIM, VOCAB = 4096, 13, 26, 16, 1_000_000
BOTTOM, TOP = (256, 64, EMB_DIM), (512, 256)
REQUESTS, WARM_BATCHES, SEED = 5, 8, 0
FA_SOURCE = {"wgmma_bf16": "persia_tpu_torch/csrc/flash_attention_hopper.cu",
             "tf32x3": "persia_tpu_torch/csrc/flash_attention_tf32.cu"}
FA_REPLACES = "persia_tpu/ops/flash_attention.py:107"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_close(name, out, ref, rtol, atol, base=None) -> float:
    """Fail unless |out - ref| <= atol + rtol * |ref| everywhere (in f32);
    returns the max abs error. ``base``, a tighter (rtol, atol), is only
    reported: how many elements exceed it and by what factor at most."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    max_err = float(err.max())
    ok = bool(torch.isfinite(out).all()) and bool((err <= atol + rtol * ref.abs()).all())
    extra = ""
    if base is not None:
        ratio = err / (base[1] + base[0] * ref.abs())
        extra = (f" [beyond rtol {base[0]:g} atol {base[1]:g}: {int((ratio > 1).sum())} of "
                 f"{ratio.numel()}, at most {float(ratio.max()):.2f}x]")
    print(f"  {name}: max_abs_err={max_err:.3e} tolerance=atol {atol:.4g} + rtol {rtol:g}*|ref| "
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


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def zipf_ids(rng, n, vocab, offset, a=1.2):
    """Rank-skewed ids with a fixed per-slot shift (the bench's stream)."""
    raw = rng.zipf(a, n).astype(np.uint64)
    return (raw + np.uint64(offset)) % np.uint64(vocab)


def zipf_batch_maker(seed):
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, NonIDTypeFeature, PersiaBatch

    rng = np.random.default_rng(seed)
    offsets = rng.integers(0, VOCAB, N_SLOTS, dtype=np.uint64)

    def make():
        ids = [
            IDTypeFeatureWithSingleID(f"cat_{i}", zipf_ids(rng, BATCH, VOCAB, offsets[i]))
            for i in range(N_SLOTS)
        ]
        dense = rng.normal(size=(BATCH, N_DENSE)).astype(np.float32)
        return PersiaBatch(ids, non_id_type_features=[NonIDTypeFeature(dense)], requires_grad=False)

    return make


def device_busy_ms(step, batches):
    """Kernel time per call of ``step`` summed by torch.profiler over the
    device's own events, and the largest kernels (names cut to 80 chars)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(b)
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # a CPU op's device time repeats its kernels' time
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        per[e.key[:80]] = per.get(e.key[:80], 0.0) + t / 1e3 / len(batches)  # us -> ms
    if not sum(per.values()):
        return None, {}
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:8])
    return sum(per.values()), top


KERNEL_NAMES = ("fa_fwd_wgmma_kernel", "fa_fwd_tf32x3_kernel", "tf32_split_kernel",
                "dot_interaction_mma_kernel", "dot_interaction_kernel")


def kernel_label(mangled: str):
    """'fa_fwd_wgmma_kernel<64>' from a mangled kernel name, or None."""
    for name in KERNEL_NAMES:
        if name + "I" in mangled:
            args = mangled.split(name + "I", 1)[1].split("EEv", 1)[0]
            tokens = re.finditer(r"13__nv_bfloat16|Li(\d+)E|f", args)
            parts = ["bf16" if t.group(0)[0] == "1" else (t.group(1) or "f32") for t in tokens]
            return f"{name}<{','.join(parts)}>"
    return None


def build_summary(build_log: str, library) -> dict:
    """Per kernel: ptxas registers, static shared memory and spill bytes
    (from the build's -Xptxas -v), and counts of the Hopper instructions in
    its SASS (cuobjdump -sass on the built library)."""
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
            for op in ("HGMMA", "UTMALDG", "UTMASTG", "HMMA"):
                if re.search(rf"\b{op}\b", line):
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


def phase_dot_interaction(dev):
    import torch

    from persia_tpu_torch.ops import dot_interaction
    from persia_tpu_torch.ops.dot_interaction import dot_interaction_reference

    print("== phase 3: dot_interaction vs its plain version", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    feats = torch.randn((BATCH, N_SLOTS + 1, EMB_DIM), generator=g)
    errs = {}
    # bf16 (tensor cores): f32 sums in the tensor cores' order, one bf16
    # rounding each side (<= 1 ulp apart); f32 (FMA walk): the same f32 sum
    for dtype, tol in ((torch.bfloat16, (2 ** -7, 1e-3)), (torch.float32, (1e-5, 1e-5))):
        x = feats.to(dev, dtype)
        out = dot_interaction(x)
        torch.cuda.synchronize()
        errs[dtype] = check_close(f"dot_interaction{list(x.shape)} {str(dtype)[6:]}", out,
                                  dot_interaction_reference(x), *tol)
    return errs[torch.bfloat16]  # the serving path's dtype


def path_flash_attention(dev):
    import torch

    from persia_tpu_torch import ops

    print("== phase 4a: flash-attention path (bf16 and f32, both masks)", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    qkv = [torch.randn((4, 1024, 8, 64), generator=g).to(dev) for _ in range(3)]
    bf = [x.to(torch.bfloat16) for x in qkv]
    ops.reset_launch_counts()
    outs = [ops.flash_attention(*x, causal=c) for x in (bf, qkv) for c in (False, True)]
    torch.cuda.synchronize()
    routes = dict(ops.flash_attention.launches_by_route)
    split = ops.tf32_split_planes.launches
    for o in outs:
        if o.shape != qkv[0].shape or not bool(torch.isfinite(o.float()).all()):
            raise SystemExit("flash_attention path: bad output")
    if routes != {"wgmma_bf16": 2, "tf32x3": 2} or ops.flash_attention.launches != 4 or split != 2:
        raise SystemExit(f"flash_attention path launched {routes} and the pre-pass {split} "
                         f"times, expected each route and the pre-pass twice")
    print(f"  flash_attention launches by route={routes}, tf32_split_planes={split}", flush=True)
    return {**routes, "tf32_split_planes": split}


def path_serving(dev):
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.ctx import InferCtx
    from persia_tpu_torch.data import PersiaBatch
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.train_step import build_eval_step
    from persia_tpu_torch.serving.engine import InferenceEngine
    from persia_tpu_torch.weights import dlrm_state_dict_from_flax, seeded_flax_params_like

    print("== phase 4b: serving path (DLRM at bench width, 5 requests of B=4096)", flush=True)
    cfg = EmbeddingConfig(
        slots_config={f"cat_{i}": SlotConfig(dim=EMB_DIM) for i in range(N_SLOTS)},
        feature_index_prefix_bit=8,
    )
    store = EmbeddingStore(capacity=1 << 22, num_internal_shards=64,
                           optimizer=Adagrad(lr=0.05).config, seed=1)
    worker = EmbeddingWorker(cfg, [store], device_pooling=True)
    make_batch = zipf_batch_maker(SEED)
    t0 = time.perf_counter()
    for _ in range(WARM_BATCHES):  # admit the stream's hot rows; the tail misses → zeros
        worker.forward_directly(make_batch(), train=True)
    print(f"  store warmed with {WARM_BATCHES} admitting lookups: {store.size()} rows "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    engines, sd = {}, None
    for device in (dev, "cpu"):
        model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device=device)
        sd = sd or dlrm_state_dict_from_flax(seeded_flax_params_like(model, SEED))
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

    if launches["dot_interaction"] != REQUESTS or engine.forwards != REQUESTS:
        raise SystemExit(f"serving path: launches {launches}, forwards {engine.forwards}; "
                         f"expected one dot_interaction per forward")
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
    busy_ms, top_kernels = device_busy_ms(eval_step, device_batches)

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


def sdpa_kernels(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` runs, by torch.profiler."""
    _, top = device_busy_ms(lambda _: fn(), [None])
    return list(top)


def phase_timing(dev, card, launches, errs, feats_shape):
    import torch
    import torch.nn.functional as F

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.dot_interaction import dot_interaction_reference
    from persia_tpu_torch.ops.flash_attention import (
        reference_attention, tf32_split_planes_reference,
    )
    from persia_tpu_torch.ops.plans import tf32_plan

    print("== phase 5: timing", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    rows = []

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
             source="persia_tpu_torch/csrc/dot_interaction.cu",
             replaces="persia_tpu/models/dlrm.py:50",
             shape=list(feats_shape), dtype="bfloat16",
             launches=launches["dot_interaction"], max_abs_err=errs["dot_interaction"],
             bound_ms=bms, bound_by=by),
        kernel=lambda: ops.dot_interaction(feats),
        plain=lambda: dot_interaction_reference(feats),
        # the full (B, n, n) product: a superset of the function, the
        # nearest one-call yardstick
        library=lambda: torch.bmm(feats, feats.transpose(1, 2)),
    ))
    for r in rows:
        print(json.dumps({"kernel_timing": r, "card": card}), flush=True)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import persia_tpu_torch  # noqa: F401  (fails where the package is absent)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    build = phase_build()
    errs = {"flash_attention": phase_flash_attention(dev),
            "dot_interaction": phase_dot_interaction(dev)}
    fa_routes = path_flash_attention(dev)
    launches, serving, feats_shape = path_serving(dev)
    launches["flash_attention"] = fa_routes
    rows = phase_timing(dev, card, launches, errs, feats_shape)
    print(json.dumps({"serving": serving, "card": card}), flush=True)
    print(json.dumps({"build": build, "card": card}), flush=True)

    # one entry per kernel (each flash-attention route by its non-causal
    # row); times graph-replayed, eager beside them
    keys = ("name", "route", "cuda_route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "eager_ms",
            "library_eager_ms")
    kernels = [{k: r[k] for k in keys} for r in rows if not r.get("causal")]
    print(json.dumps({"kernels": kernels, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
