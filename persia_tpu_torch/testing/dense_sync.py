"""Multi-rank runs of the hybrid tier's dense sync
(``TrainCtx(mesh=data_parallel_mesh(), dense_sync=mode)``): ``run_ranks``
starts ``world`` processes, one a rank, over a ``torch.distributed``
process group (gloo on the CPU; gloo or NCCL on a card), runs the same
list of cases in each and returns each rank's results; ``run_function``
runs any importable ``fn(mesh, *args)`` so (``ring_allreduce_rank``: the
ring alone; ``ring_allreduce_launches``: with its launches;
``divergent_rank``: ``grad_sync.build_sync_train_step`` with an algorithm
whose ranks hold their own parameters, or QAdam; ``lp_sync_rank``: the
LowPrecisionDecentralized sync alone).

A case is a dict: ``mode`` (a ``DENSE_SYNC_MODES`` mode), ``steps``,
``seed`` (the batches'), optionally ``snapshot`` ((job directory, k):
``snapshot_job`` once, after step k), ``stop_after`` (train
only that many steps), ``resume`` (a job directory: resume from its newest
manifest first, the servers rewound, and train the steps past it),
``state_bytes`` (return rank 0's dense bytes at the end) and ``loader``
(train through ``train_step_prepared``: rank 0 over a ``DataLoader(
reproducible=True, staleness=1)`` of the batches, the other ranks with
``None`` for the batch and the loader). The model, the
embedding configuration and the batches come from ``SPEC`` (or the
caller's ``spec``): DLRM over ``vocabs`` single-id slots with the
synthetic click data of ``testing.SyntheticClickDataset``, the servers two
stores of seed 7 (``store``: "numpy", the golden model, or "native", the
C++ core, for widths where the numpy store is too slow) under sparse
Adagrad(0.1), dense Adam(``lr``), the weights
``weights.seeded_flax_params_like(model, params_seed)``.

Each rank's result a case: ``losses`` (a step), the last ``preds``, the
flat parameters in the reference's ``ravel_pytree`` order, the ring's
``ef`` row, ``opt_state_bytes`` (``grad_sync.per_replica_opt_state_bytes``),
``wire_bytes``, ``sync_mode``, ``launches`` (the dense sync kernels' a
step, on a card) and on rank 0 ``entries`` (every server entry of the
vocabularies, unless ``spec["entries"]`` is false) and, where asked,
``state_bytes``.

Every process is joined within ``timeout`` seconds (killed past it) and
its process group made with ``parallel.mesh.DEFAULT_TIMEOUT``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import socket
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

SPEC = dict(dense=5, vocabs=(64, 32), dim=8, bottom=(16, 8), top=(32,), bsz=32, lr=3e-3, params_seed=11,
            compute="float32", store="numpy", entries=True)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def embedding_config(spec: Dict):
    from persia_tpu_torch import config as tcfg

    slots = {f"cat_{i}": tcfg.SlotConfig(dim=spec["dim"]) for i in range(len(spec["vocabs"]))}
    return tcfg.EmbeddingConfig(slots_config=slots, feature_index_prefix_bit=8)


def batches(spec: Dict, steps: int, seed: int):
    from persia_tpu_torch.testing import SyntheticClickDataset

    b = spec["bsz"]
    return list(SyntheticClickDataset(num_samples=steps * b, num_dense=spec["dense"], vocab_sizes=spec["vocabs"],
                                      seed=seed).batches(b))[:steps]


def model_and_params(spec: Dict, device="cpu"):
    """The port's DLRM at ``spec`` and its seeded flax weights, loaded."""
    import torch

    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    dtype = torch.float32 if spec["compute"] == "float32" else torch.bfloat16
    model = DLRM(spec["dense"], len(spec["vocabs"]), spec["dim"], tuple(spec["bottom"]), tuple(spec["top"]),
                 compute_dtype=dtype, device="cpu")
    params = seeded_flax_params_like(model, spec["params_seed"])
    model.load_state_dict(state_dict_from_flax(model, params))
    return model.to(device), params


def entries(stores, spec: Dict) -> Dict:
    """Every server entry of the vocabularies: {(slot, id): entry}."""
    from persia_tpu_torch.embedding.hashing import add_index_prefix

    cfg = embedding_config(spec)
    out = {}
    for i, vocab in enumerate(spec["vocabs"]):
        slot = f"cat_{i}"
        signs = add_index_prefix(np.arange(vocab, dtype=np.uint64), cfg.slot(slot).index_prefix, 8)
        for j, s in enumerate(signs.tolist()):
            e = next((st.get_embedding_entry(s) for st in stores if st.get_embedding_entry(s) is not None), None)
            if e is not None:
                out[(slot, j)] = np.array(e)
    return out


def _launch_counts() -> Dict[str, int]:
    from persia_tpu_torch.ops import block_int8, lp_ring, quantize_int8

    return {"block_quantize_int8": block_int8.block_quantize_int8.launches,
            "block_dequantize_int8": block_int8.block_dequantize_int8.launches,
            "block_requantize_int8": block_int8.block_requantize_int8.launches,
            "segment_absmax": quantize_int8.segment_absmax.launches,
            "quantize_int8_ef_shared": quantize_int8.quantize_int8_ef_shared.launches,
            "quantize_int8_ef": quantize_int8.quantize_int8_ef.launches,
            "lp_ring_mix": lp_ring.lp_ring_mix.launches}


def run_case(mesh, case: Dict, spec: Dict, device) -> Dict:
    """One case on this rank (see the module's docstring)."""
    import torch

    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import optim as toptim
    from persia_tpu_torch.embedding.native_store import create_store
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.parallel import grad_sync
    from persia_tpu_torch.weights import train_state_to_flax_bytes

    cfg = embedding_config(spec)
    model, _ = model_and_params(spec, device)
    stores, worker = None, None
    if mesh.rank == 0:
        capacity = 1 << (16 if spec["store"] == "numpy" else 22)
        stores = [create_store(spec["store"], capacity=capacity, num_internal_shards=4, seed=7,
                               optimizer=toptim.Adagrad(lr=0.1).config) for _ in range(2)]
        worker = EmbeddingWorker(cfg, stores)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=spec["lr"]), toptim.Adagrad(lr=0.1), worker, cfg,
                   device=device, mesh=mesh, dense_sync=case["mode"]).__enter__()
    ctx.init_state()
    data = batches(spec, case["steps"], case["seed"])
    start = 0
    if case.get("resume"):
        m = ctx.resume(case["resume"])
        start = ctx._global_step
        assert m is not None or mesh.rank != 0, "no manifest to resume from"
    stop = case.get("stop_after", case["steps"])
    snap = case.get("snapshot")
    losses, preds, launches = [], None, []
    loader = None
    if case.get("loader") and mesh.rank == 0:
        from persia_tpu_torch.data_loader import DataLoader

        loader = DataLoader(iter(data[start:stop]), ctx, num_workers=2, staleness=1, reproducible=True)
    prepared = iter(loader) if loader is not None else None
    for i in range(start, stop):
        before = _launch_counts()
        if case.get("loader"):
            met = ctx.train_step_prepared(next(prepared) if prepared is not None else None, loader)
        else:
            met = ctx.train_step(data[i])
        after = _launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
        losses.append(float(met["loss"]))
        preds = np.asarray(met["preds"])
        if snap and i + 1 == snap[1]:
            ctx.snapshot_job(snap[0])
    if loader is not None:
        loader.flush()
        loader.shutdown()
    leaves = grad_sync.dense_leaves(model)
    st = ctx.state.sync
    out = {
        "losses": losses, "preds": preds, "start": start,
        "params": grad_sync.ravel(leaves, lambda p: p.detach()).cpu().numpy(),
        "ef": st.ef.cpu().numpy() if st is not None and st.ef is not None else None,
        "opt_state_bytes": grad_sync.per_replica_opt_state_bytes(model, st),
        "wire_bytes": ctx.dense_wire_bytes_per_step(), "sync_mode": ctx.sync_mode, "launches": launches,
    }
    raw = train_state_to_flax_bytes(ctx.state) if case.get("state_bytes") else None  # every rank gathers
    if mesh.rank == 0:
        out["entries"] = entries(stores, spec) if spec["entries"] else None
        out["state_bytes"] = raw
    return out


def ring_allreduce_rank(mesh, block_size: int, per_rank: np.ndarray, ef: np.ndarray, device: str = "cpu"):
    """``grad_sync._block_ring_allreduce_flat`` of this rank's row of
    ``per_rank`` with its row of ``ef`` (tensors on ``device``): (sum, new
    ef) as numpy."""
    import torch

    from persia_tpu_torch.parallel import grad_sync

    v = torch.from_numpy(per_rank[mesh.rank].copy()).to(device)
    e = torch.from_numpy(ef[mesh.rank].copy()).to(device)
    flat_sum, new_ef = grad_sync._block_ring_allreduce_flat(v, e, grad_sync.BlockInt8Ring(block_size=block_size),
                                                            mesh)
    return flat_sum.cpu().numpy(), new_ef.cpu().numpy()


def ring_allreduce_launches(mesh, block_size: int, per_rank: np.ndarray, ef: np.ndarray, device: str = "cpu"):
    """``ring_allreduce_rank`` and the dense sync kernels' launches it made
    on this rank (on a card): (sum, new ef, launches)."""
    before = _launch_counts()
    flat_sum, new_ef = ring_allreduce_rank(mesh, block_size, per_rank, ef, device)
    after = _launch_counts()
    return flat_sum, new_ef, {k: after[k] - before[k] for k in after}


# --------------------------------------------- the divergent-replica algorithms

#: ``divergent_rank``'s algorithms by name
ALGORITHMS = ("decentralized", "local_sgd", "qadam", "lp", "f32")
RAW_ROWS, RAW_LEN = 8, 4  # the last slot's distinct rows (the last one the pad) and ids a sample


def algorithm(name: str, **kwargs):
    """The ``grad_sync`` algorithm of a ``divergent_rank`` case."""
    from persia_tpu_torch.parallel import grad_sync

    cls = {"decentralized": grad_sync.Decentralized, "local_sgd": grad_sync.LocalSGD, "qadam": grad_sync.QAdam,
           "lp": grad_sync.LowPrecisionDecentralized, "f32": grad_sync.GradientAllReduce}[name]
    return cls(**kwargs)


def host_batches(spec: Dict, steps: int, seed: int) -> List[Dict]:
    """``steps`` global batches of ``spec["bsz"]`` rows as host arrays in
    the step's layout (``parallel.train_step``), from a numpy seed: the
    dense features, 0/1 labels, every slot but the last host-pooled (B,
    dim) and the last a raw slot (``RAW_ROWS`` distinct rows, ``RAW_LEN``
    ids a sample, the last row the pad, masked out)."""
    rng = np.random.default_rng(seed)
    b, dim, slots = spec["bsz"], spec["dim"], len(spec["vocabs"])
    out = []
    for _ in range(steps):
        emb = [{"pooled": rng.normal(size=(b, dim)).astype(np.float32)} for _ in range(slots - 1)]
        index = rng.integers(0, RAW_ROWS, (b, RAW_LEN)).astype(np.int32)
        emb.append({"distinct": rng.normal(size=(RAW_ROWS, dim)).astype(np.float32), "index": index,
                    "mask": index != RAW_ROWS - 1})
        out.append({"dense": [rng.normal(size=(b, spec["dense"])).astype(np.float32)],
                    "labels": [rng.integers(0, 2, (b, 1)).astype(np.float32)], "emb": emb})
    return out


def rank_batch(mesh, batch: Dict, device) -> Dict:
    """This rank's rows of a ``host_batches`` batch as tensors on
    ``device`` (a raw slot's distinct rows whole, with the backward's CSR
    over the rank's rows)."""
    import torch

    from persia_tpu_torch.ops.raw_gather import raw_csr

    a, b = mesh.rows(batch["labels"][0].shape[0])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    emb = []
    for e in batch["emb"]:
        if "pooled" in e:
            emb.append({"pooled": t(e["pooled"][a:b])})
        else:
            index = e["index"][a:b]
            order, offsets, chunks = raw_csr(index, e["distinct"].shape[0])
            emb.append({"distinct": t(e["distinct"]), "index": t(index), "mask": t(e["mask"][a:b]),
                        "order": t(order), "offsets": t(offsets), "long_chunks": t(chunks)})
    return {"dense": [t(d[a:b]) for d in batch["dense"]], "labels": [t(l[a:b]) for l in batch["labels"]],
            "emb": emb}


def dnn_model(spec: Dict, device="cpu", params_seed=None):
    """DNN over ``spec``'s slots (dense MLP 16, sparse 32, hidden (32, 16),
    f32) with seeded flax weights and batch statistics, loaded: (model,
    params, batch_stats)."""
    import torch

    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.weights import seeded_batch_stats_like, seeded_flax_params_like, state_dict_from_flax

    model = DNN(spec["dense"], [spec["dim"]] * len(spec["vocabs"]), 16, 32, (32, 16), compute_dtype=torch.float32,
                device="cpu")
    seed = spec["params_seed"] if params_seed is None else params_seed
    params, stats = seeded_flax_params_like(model, seed), seeded_batch_stats_like(model, seed + 1)
    model.load_state_dict(state_dict_from_flax(model, params, stats))
    return model.to(device), params, stats


def divergent_case(mesh, case: Dict, spec: Dict, device) -> Dict:
    """One case of ``divergent_rank`` on this rank: the model (``case
    ["model"]``: "dlrm", ``model_and_params``, or "dnn", ``dnn_model``),
    each rank but 0 from other seeded weights, until ``replicate_for_local``
    starts them from rank 0's; Adam(``spec["lr"]``) (none for QAdam); the
    sync state from ``init_sync_opt_state``; ``case["steps"]`` steps of
    ``build_sync_train_step`` over ``host_batches(spec, steps,
    case["seed"])``, this rank's rows. Returns each step's loss (the
    header's), flat parameters and the sync kernels' launches, the last
    header and packed gradients, ``algo_state`` as numpy, the batch
    statistics (flax's tree) and, with ``case["collapse"]``, this rank's
    dense trees and ``collapse_local``'s result."""
    import torch

    from persia_tpu_torch.parallel import grad_sync
    from persia_tpu_torch.parallel.train_step import init_train_state
    from persia_tpu_torch.weights import _dense_tree, batch_stats_to_flax

    seed = spec["params_seed"] + (mesh.rank > 0)  # the other ranks' weights differ until replicated
    if case.get("model", "dlrm") == "dnn":
        model = dnn_model(spec, device, seed)[0]
    else:
        model = model_and_params(dict(spec, params_seed=seed), device)[0]
    algo = algorithm(case["algorithm"], **case.get("kwargs", {}))
    qadam = isinstance(algo, grad_sync.QAdam)
    opt = None if qadam else torch.optim.Adam(model.parameters(), lr=spec["lr"])
    grad_sync.replicate_for_local(model, opt, mesh)
    state = init_train_state(model, opt)
    state.sync = grad_sync.init_sync_opt_state(model, opt, mesh, algo, device=torch.device(device))
    step = grad_sync.build_sync_train_step(model, opt, mesh, algo)
    leaves = grad_sync.dense_leaves(model)
    losses, params, launches = [], [], []
    header = gpacked = None
    for batch in host_batches(spec, case["steps"], case["seed"]):
        device_batch = rank_batch(mesh, batch, device)
        before = _launch_counts()
        header, gpacked = step(state, device_batch)
        after = _launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
        losses.append(float(header[0]))
        params.append(grad_sync.ravel(leaves, lambda p: p.detach()).cpu().numpy())
    algo_state = state.sync.algo_state
    out = {"losses": losses, "params": params, "launches": launches, "header": header.cpu().numpy(),
           "gpacked": gpacked.cpu().numpy(), "batch_stats": batch_stats_to_flax(model),
           "algo_state": {k: v.cpu().numpy() for k, v in algo_state.items()} if algo_state else None}
    if case.get("collapse"):  # this rank's rows (flax's trees) and their mean over the ranks
        out["dense_tree"] = _dense_tree(state)
        out["collapse"] = grad_sync.collapse_local(state, mesh)
    return out


def divergent_rank(mesh, cases: List[Dict], spec: Dict, device: str = "cpu") -> List[Dict]:
    """``divergent_case`` of each case on this rank (``run_function``'s
    ``fn``)."""
    import torch

    return [divergent_case(mesh, c, spec, torch.device(device)) for c in cases]


#: K18's edge cases (segment lengths; ``lp_mix_inputs``): a leaf of each
#: size class, 512 segments, empty and 1-element segments, boundaries inside
#: a 4-element unit
LP_MIX_CASES = {
    "segments_512": [(i * 37) % 251 for i in range(512)],
    "empty_and_ones": [0, 1, 0, 1, 1, 5000, 0, 1, 3],
    "inside_units": [3, 5, 13, 2, 9, 4100, 1, 1, 6],
    "many_in_a_unit": [3] + [0] * 10 + [1] * 3 + [5000],
}


def lp_mix_inputs(lengths: List[int], device, seed: int, off16: bool = False, specials: bool = False):
    """K18's inputs over segments of ``lengths``: x and the three shadows
    (normal), the three code vectors (uniform in [-127, 127], the first
    elements of each segment -127, 127 and 0), the three scale vectors
    (10^-6 to 10, the first segment's 1e-30); ``specials``: a NaN, +inf and
    -inf in x; ``off16``: every tensor one element past its buffer's start
    (the scalar plan). Returns (list of the ten tensors, offsets)."""
    import torch

    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(int).tolist()
    n, segs = offsets[-1], len(lengths)
    rng = np.random.default_rng(seed)
    lead = int(off16)

    def on_device(a):
        buf = torch.zeros(a.size + lead, dtype=torch.from_numpy(a[:0]).dtype, device=device)
        buf[lead:] = torch.from_numpy(a).to(device)
        return buf[lead:]

    f32 = [rng.normal(size=n).astype(np.float32) for _ in range(4)]
    if specials and n >= 3:
        f32[0][[0, n // 2, n - 1]] = [np.nan, np.inf, -np.inf]
    codes = []
    for _ in range(3):
        q = rng.integers(-127, 128, n).astype(np.int8)
        for a, b in zip(offsets[:-1], offsets[1:]):
            q[a:min(b, a + 3)] = [-127, 127, 0][:min(b, a + 3) - a]
        codes.append(q)
    scales = [(10.0 ** rng.uniform(-6, 1, segs)).astype(np.float32) for _ in range(3)]
    for sc in scales:
        sc[:1] = np.float32(1e-30)
    return [on_device(a) for a in f32 + codes + scales], offsets


def lp_sync_rank(mesh, x: np.ndarray, shadows: Dict[str, np.ndarray], offsets: List[int], device: str = "cpu"):
    """``grad_sync.lp_ring_sync`` alone on this rank's row of ``x`` and of
    each of ``shadows`` (n, P): (the new x, the new shadows, the sync
    kernels' launches), as numpy."""
    import torch

    from persia_tpu_torch.parallel import grad_sync

    r = mesh.rank
    xt = torch.from_numpy(x[r].copy()).to(device)
    st = {k: torch.from_numpy(v[r].copy()).to(device) for k, v in shadows.items()}
    before = _launch_counts()
    grad_sync.lp_ring_sync(xt, st, offsets, mesh)
    after = _launch_counts()
    return xt.cpu().numpy(), {k: v.cpu().numpy() for k, v in st.items()}, {k: after[k] - before[k] for k in after}


def _rank_main(rank: int, world: int, port: int, job, out_path: str, device: str, backend: str) -> None:
    try:
        import torch
        import torch.distributed as dist

        from persia_tpu_torch.distributed import initialize_process_group
        from persia_tpu_torch.parallel.mesh import data_parallel_mesh

        torch.manual_seed(0)
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        initialize_process_group(backend=backend, init_method=f"tcp://localhost:{port}", world_size=world,
                                 rank=rank)
        mesh = data_parallel_mesh(world)
        fn, args = job
        result = fn(mesh, *args)
        dist.barrier()
        dist.destroy_process_group()
        payload = {"ok": True, "result": result}
    except BaseException:  # noqa: BLE001 — the parent reports it
        payload = {"ok": False, "error": traceback.format_exc()}
    with open(out_path, "wb") as f:
        pickle.dump(payload, f)


def _run_cases(mesh, cases: List[Dict], spec: Dict, device: str) -> List[Dict]:
    import torch

    return [run_case(mesh, c, spec, torch.device(device)) for c in cases]


def run_function(world: int, fn, *args, device: str = "cpu", backend: str = "gloo", timeout: float = 300.0) -> List:
    """``fn(mesh, *args)`` on ``world`` ranks (fresh spawned processes; ``fn``
    importable by name); returns each rank's result. Raises with a rank's
    traceback when one fails, and kills every process still running after
    ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(r, world, port, (fn, args), outs[r], device, backend),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still ran after {timeout:g} s")
        results = []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} of {world} exited with code {procs[r].exitcode} and no result")
            with open(path, "rb") as f:
                payload = pickle.load(f)
            if not payload["ok"]:
                raise RuntimeError(f"rank {r} of {world} failed:\n{payload['error']}")
            results.append(payload["result"])
    return results


def run_ranks(world: int, cases: List[Dict], spec: Optional[Dict] = None, device: str = "cpu",
              backend: str = "gloo", timeout: float = 300.0) -> List[List[Dict]]:
    """``cases`` on ``world`` ranks (``run_function``); returns
    ``results[rank][case]``."""
    return run_function(world, _run_cases, cases, dict(SPEC, **(spec or {})), device, device=device,
                        backend=backend, timeout=timeout)


__all__ = ["ALGORITHMS", "SPEC", "algorithm", "batches", "divergent_case", "divergent_rank", "dnn_model",
           "embedding_config", "entries", "free_port", "host_batches", "LP_MIX_CASES", "lp_mix_inputs", "lp_sync_rank",
           "model_and_params",
           "rank_batch", "ring_allreduce_launches", "ring_allreduce_rank", "run_case", "run_function", "run_ranks"]
