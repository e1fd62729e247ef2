#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``persia_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure ends the run with a nonzero exit and no
result line:

1. build the port's CUDA kernels from ``persia_tpu_torch/csrc`` (nvcc, sm_90a);
2. flash_attention on the card vs its plain version (dense f32 softmax);
3. dot_interaction on the card vs its plain version at the serving shape;
4. the paths, each with the launch counts set to 0 just before and read
   just after: the flash-attention entry point at (B=4, L=1024, H=8, D=64),
   and the serving slice at bench width — DLRM (13 dense features, 26
   single-id slots of dim 16, bottom (256, 64, 16), top (512, 256)) behind
   ``InferenceEngine(InferCtx(...))``, answering 5 requests of B=4096 zipf
   ids through ``predict_from_bytes``, held against the same engine on the
   CPU;
5. CUDA-event timings of each kernel beside its plain version, the library
   call that computes the same function, and the card's bound; the serving
   latency and throughput.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# the card's published peaks (H100 SXM data sheet, dense): HBM bytes/s and
# operations/s by input type (f32 without the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

BATCH, N_DENSE, N_SLOTS, EMB_DIM, VOCAB = 4096, 13, 26, 16, 1_000_000
BOTTOM, TOP = (256, 64, EMB_DIM), (512, 256)
REQUESTS, WARM_BATCHES, SEED = 5, 8, 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_close(name, out, ref, rtol, atol) -> float:
    """Fail unless |out - ref| <= atol + rtol * |ref| everywhere (in f32);
    returns the max abs error."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    max_err = float(err.max())
    ok = bool(torch.isfinite(out).all()) and bool((err <= atol + rtol * ref.abs()).all())
    print(f"  {name}: max_abs_err={max_err:.3e} tolerance=atol {atol:g} + rtol {rtol:g}*|ref| "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    return max_err


def time_ms(fn, iters=50, warmup=5) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
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


def phase_build():
    from persia_tpu_torch.ops import _kernels

    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    _kernels.library()
    print(f"  built {_kernels.library_path().name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_kernels.build_seconds:.1f} s)", flush=True)
    print(_kernels.build_log, flush=True)


def phase_flash_attention(dev):
    import torch

    from persia_tpu_torch.ops import flash_attention
    from persia_tpu_torch.ops.flash_attention import reference_attention

    print("== phase 2: flash_attention vs reference_attention", flush=True)
    # f32: only the order of the 1024-term softmax sums differs; bf16: the
    # same f32 math on both sides, each rounding once to bf16 (<= 1 ulp)
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -7, 1e-3)}
    cases = [
        ((4, 1024, 8, 64), dtype, causal)
        for dtype in (torch.bfloat16, torch.float32) for causal in (False, True)
    ] + [
        ((4, 1000, 8, 64), torch.bfloat16, True),
        ((4, 1000, 8, 64), torch.float32, True),
        ((4, 256, 8, 16), torch.bfloat16, False),
        ((4, 256, 8, 16), torch.float32, True),
        ((2, 512, 4, 32), torch.float32, True),
        ((2, 512, 4, 128), torch.bfloat16, False),
    ]
    g = torch.Generator(device="cpu").manual_seed(SEED)
    errs = {}
    for shape, dtype, causal in cases:
        q, k, v = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(3))
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v, causal=causal)
        name = f"flash_attention{list(shape)} {str(dtype)[6:]} causal={causal}"
        errs[(shape, dtype, causal)] = check_close(name, out, ref, *tol[dtype])
    return errs[((4, 1024, 8, 64), torch.bfloat16, False)]


def phase_dot_interaction(dev):
    import torch

    from persia_tpu_torch.ops import dot_interaction
    from persia_tpu_torch.ops.dot_interaction import dot_interaction_reference

    print("== phase 3: dot_interaction vs its plain version", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    feats = torch.randn((BATCH, N_SLOTS + 1, EMB_DIM), generator=g)
    errs = {}
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

    print("== phase 4a: flash-attention path", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    q, k, v = (torch.randn((4, 1024, 8, 64), generator=g).to(dev, torch.bfloat16) for _ in range(3))
    ops.reset_launch_counts()
    outs = [ops.flash_attention(q, k, v, causal=c) for c in (False, True)]
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    for o in outs:
        if o.shape != q.shape or not bool(torch.isfinite(o.float()).all()):
            raise SystemExit("flash_attention path: bad output")
    if launches != 2:
        raise SystemExit(f"flash_attention path launched the kernel {launches} times, expected 2")
    print(f"  flash_attention launches={launches}", flush=True)
    return launches


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


def phase_timing(dev, card, launches, errs, feats_shape):
    import torch
    import torch.nn.functional as F

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.dot_interaction import dot_interaction_reference
    from persia_tpu_torch.ops.flash_attention import reference_attention

    print("== phase 5: timing", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    rows = []

    b, l, h, d = 4, 1024, 8, 64
    q, k, v = (torch.randn((b, l, h, d), generator=g).to(dev, torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for causal in (False, True):
        pairs = l * (l + 1) // 2 if causal else l * l
        bms, by = bound(4 * b * l * h * d * 2, 4 * b * h * d * pairs, "bfloat16")
        rows.append(dict(
            name="flash_attention", route="cuda",
            source="persia_tpu_torch/csrc/flash_attention.cu",
            replaces="persia_tpu/ops/flash_attention.py:107",
            shape=[b, l, h, d], dtype="bfloat16", causal=causal,
            launches=launches["flash_attention"], max_abs_err=errs["flash_attention"],
            ms=time_ms(lambda: ops.flash_attention(q, k, v, causal=causal)),
            plain_ms=time_ms(lambda: reference_attention(q, k, v, causal=causal), iters=10),
            bound_ms=bms, bound_by=by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)),
        ))

    feats = torch.randn(feats_shape, generator=g).to(dev, torch.bfloat16)
    bsz, n, dim = feats_shape
    pairs = n * (n - 1) // 2
    bms, by = bound(bsz * n * dim * 2 + bsz * pairs * 2, 2 * bsz * pairs * dim, "bfloat16")
    rows.append(dict(
        name="dot_interaction", route="cuda",
        source="persia_tpu_torch/csrc/dot_interaction.cu",
        replaces="persia_tpu/models/dlrm.py:50",
        shape=list(feats_shape), dtype="bfloat16",
        launches=launches["dot_interaction"], max_abs_err=errs["dot_interaction"],
        ms=time_ms(lambda: ops.dot_interaction(feats)),
        plain_ms=time_ms(lambda: dot_interaction_reference(feats)),
        bound_ms=bms, bound_by=by,
        # the full (B, n, n) product: a superset of the function, the
        # nearest one-call yardstick
        library_ms=time_ms(lambda: torch.bmm(feats, feats.transpose(1, 2))),
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

    phase_build()
    errs = {"flash_attention": phase_flash_attention(dev),
            "dot_interaction": phase_dot_interaction(dev)}
    fa_launches = path_flash_attention(dev)
    launches, serving, feats_shape = path_serving(dev)
    launches["flash_attention"] = fa_launches
    rows = phase_timing(dev, card, launches, errs, feats_shape)
    print(json.dumps({"serving": serving, "card": card}), flush=True)

    # one entry per kernel: the flash-attention row is the non-causal one
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} for r in rows if not r.get("causal")]
    print(json.dumps({"kernels": kernels, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
