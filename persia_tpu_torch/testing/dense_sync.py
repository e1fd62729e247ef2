"""Multi-rank runs of the hybrid tier's dense sync
(``TrainCtx(mesh=data_parallel_mesh(), dense_sync=mode)``): ``run_ranks``
starts ``world`` processes, one a rank, over a ``torch.distributed``
process group (gloo on the CPU; gloo or NCCL on a card), runs the same
list of cases in each and returns each rank's results; ``run_function``
runs any importable ``fn(mesh, *args)`` so (``ring_allreduce_rank``: the
ring alone; ``ring_allreduce_launches``: with its launches).

A case is a dict: ``mode`` (a ``DENSE_SYNC_MODES`` mode), ``steps``,
``seed`` (the batches'), optionally ``snapshot`` ((job directory, k):
``snapshot_job`` once, after step k), ``stop_after`` (train
only that many steps), ``resume`` (a job directory: resume from its newest
manifest first, the servers rewound, and train the steps past it) and
``state_bytes`` (return rank 0's dense bytes at the end). The model, the
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
    from persia_tpu_torch.ops import block_int8, quantize_int8

    return {"block_quantize_int8": block_int8.block_quantize_int8.launches,
            "block_dequantize_int8": block_int8.block_dequantize_int8.launches,
            "block_requantize_int8": block_int8.block_requantize_int8.launches,
            "segment_absmax": quantize_int8.segment_absmax.launches,
            "quantize_int8_ef_shared": quantize_int8.quantize_int8_ef_shared.launches}


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
    for i in range(start, stop):
        before = _launch_counts()
        met = ctx.train_step(data[i])
        after = _launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
        losses.append(float(met["loss"]))
        preds = np.asarray(met["preds"])
        if snap and i + 1 == snap[1]:
            ctx.snapshot_job(snap[0])
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


__all__ = ["SPEC", "batches", "embedding_config", "entries", "free_port", "model_and_params", "ring_allreduce_launches",
           "ring_allreduce_rank", "run_case", "run_function", "run_ranks"]
