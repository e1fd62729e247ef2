"""Seeded inputs of the cache tier's kernels, K12 (``ops.cache_aux``) and
K13 (``ops.cached_gather``), shared by the tests and ``chip_smoke.py``: one
step's aux pieces on a group's pool, padded as the tier pads them, with or
without restores from an eviction ring; cache rows with pads (and eval's
misses); a step's restores alone (the plain ``restore_rows_reference``)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from persia_tpu_torch.embedding.hbm_cache.common import _bucket
from persia_tpu_torch.embedding.optim import SGD, Adagrad, Adam
from persia_tpu_torch.ops.cache_aux import ring_start
from persia_tpu_torch.ops.sparse_update import init_sparse_state
from persia_tpu_torch.utils import round_up_pow2

OPTIMIZERS = {"sgd": SGD(lr=0.1), "adagrad": Adagrad(lr=0.05), "adagrad_vw": Adagrad(lr=0.05, vectorwise_shared=True),
              "adam": Adam(lr=0.01)}


def _padded(rows: np.ndarray, fill: int) -> np.ndarray:
    out = np.full(_bucket(max(len(rows), 1)), fill, np.int32)
    out[:len(rows)] = rows
    return out


def aux_case(kind: str, C: int, dim: int, n_ev: int, n_warm: int, n_cold: int, reuse, bf16: bool,
             device, seed: int, n_restore: int = 0, ring_rows: int = 0, wb_bf16: bool = False,
             ring_pos: int = 0, table_dtype=torch.float32) -> Dict:
    """A pool (C+1, dim) with random rows and state (row C zero) and one
    step's pieces: ``n_ev`` evicted rows (padded with C), ``n_warm`` warm
    entries and ``n_cold`` cold seeds (rows padded with C+1, bf16 where
    ``bf16``). ``reuse`` (a share, True for 1): that share of the misses,
    at random, take rows evicted this step, at random slots (their count
    <= n_ev); the other misses take rows nobody evicts, and the slots no
    miss takes stay unclaimed. Empty pieces have 0 rows. Returns the
    keyword arguments of ``cache_aux`` but ``wb_bf16``, the pairing
    (``m_slot``, ``c_slot``, ``ev_free``) included.

    With ``ring_rows`` > 0 the case also holds a random ring
    (``ring_rows``, dim + state_dim), bf16 where ``wb_bf16``, its
    ``ring_pos`` and ``restores`` (r_src, r_dst, r_slot): ``n_restore``
    misses of a third kind, each restored from a random ring row outside
    the span the call stores its payload into (``ring_start(ring_rows,
    ring_pos, K_ev)`` on), padded (sources 0, rows C+1, slots -1); 0
    rows where ``n_restore`` is 0. ``table_dtype``: the pool's dtype (a
    bf16 pool is the same draws rounded; the other pieces do not change)."""
    cfg = OPTIMIZERS[kind].config
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    table = torch.randn((C + 1, dim), generator=g)
    table[C] = 0
    state = init_sparse_state(cfg, C + 1, dim)
    for s in state.values():
        s.copy_(torch.rand(s.shape, generator=g))
    width = dim + sum(s.shape[1] for s in state.values())
    n_miss = n_warm + n_cold + n_restore
    n_reuse = int(round(float(reuse) * n_miss))
    if n_reuse > n_ev:
        raise ValueError("reuse needs its share of the misses <= n_ev")
    perm = rng.permutation(C)
    ev = perm[:n_ev]
    who = rng.permutation(n_miss)[:n_reuse]  # the misses on evicted rows
    taken = rng.permutation(n_ev)[:n_reuse]  # the slots they overwrite
    miss = np.empty(n_miss, np.int64)
    slots = np.full(n_miss, -1, np.int32)
    miss[who], slots[who] = ev[taken], taken
    apart = np.setdiff1d(np.arange(n_miss), who)
    miss[apart] = perm[n_ev:n_ev + len(apart)]
    free = np.setdiff1d(np.arange(_bucket(n_ev) if n_ev else 0), taken).astype(np.int32)
    dt = torch.bfloat16 if bf16 else torch.float32

    def rows(r, fill):
        return torch.from_numpy(_padded(r, fill) if len(r) else np.empty(0, np.int32))

    m_rows, c_rows = rows(miss[:n_warm], C + 1), rows(miss[n_warm:n_warm + n_cold], C + 1)
    consts = {"sgd": (), "adagrad": (("acc", cfg.initialization),), "adagrad_vw": (("acc", cfg.initialization),),
              "adam": (("m", 0.0), ("v", 0.0))}[kind]
    out = dict(
        table=table.to(table_dtype), state=state, ev_rows=rows(ev, C), m_rows=m_rows,
        m_entries=torch.randn((m_rows.shape[0], width), generator=g).to(dt), c_rows=c_rows,
        c_emb=torch.randn((c_rows.shape[0], dim), generator=g).to(dt), state_consts=consts,
        m_slot=rows(slots[:n_warm], -1), c_slot=rows(slots[n_warm:n_warm + n_cold], -1), ev_free=rows(free, -1),
    )
    if ring_rows:
        k_ev = out["ev_rows"].shape[0]
        start = ring_start(ring_rows, ring_pos, k_ev)
        outside = np.setdiff1d(np.arange(ring_rows), np.arange(start, start + k_ev))
        src = rng.choice(outside, n_restore)
        out["ring"] = torch.randn((ring_rows, width), generator=g).to(torch.bfloat16 if wb_bf16 else torch.float32)
        out["ring_pos"] = ring_pos
        out["restores"] = (rows(src, 0), rows(miss[n_warm + n_cold:], C + 1), rows(slots[n_warm + n_cold:], -1))
    return {k: (v.to(device) if torch.is_tensor(v) else
                {kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict) else
                tuple(t.to(device) for t in v) if k == "restores" else v) for k, v in out.items()}


def all_pads(case: Dict, C: int) -> Dict:
    """``case`` (an ``aux_case``) with every row a pad: evictions C (the
    zero row), writes C+1 (dropped); no write claims a slot, so every slot
    is listed unclaimed."""
    case["ev_rows"].fill_(C)
    case["m_rows"].fill_(C + 1)
    case["c_rows"].fill_(C + 1)
    case["m_slot"].fill_(-1)
    case["c_slot"].fill_(-1)
    if "restores" in case:
        case["restores"][1].fill_(C + 1)
        case["restores"][2].fill_(-1)
    n_ev = case["ev_rows"].shape[0]
    case["ev_free"] = torch.arange(n_ev, dtype=torch.int32, device=case["ev_rows"].device)
    return case


def gather_case(S: int, B: int, L: int, C: int, dim: int, device, seed: int, pad_share: float = 0.25,
                scale: bool = False, miss: int = 0, zipf: bool = False, table_dtype=torch.float32) -> Dict:
    """A pool (C+1, dim) (row C zero) in ``table_dtype`` (a bf16 pool is the
    same draws rounded) and rows (S, B, L) int32 in [0, C] (zipf(1.2)-skewed
    where ``zipf``), ``pad_share`` of them C; with ``miss`` > 0 an f32 miss
    table (miss, dim) and rows up to C + miss; with ``scale`` a (S, B) f32
    scale."""
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    table = torch.randn((C + 1, dim), generator=g)
    table[C] = 0
    if zipf:
        r = ((rng.zipf(1.2, (S, B, L)) - 1) % C).astype(np.int64)
    else:
        r = rng.integers(0, C + 1 + miss, (S, B, L))
    r[rng.random((S, B, L)) < pad_share] = C
    out = {"table": table.to(table_dtype), "rows": torch.from_numpy(r.astype(np.int32))}
    if scale:
        out["scale"] = (1.0 / torch.sqrt(torch.randint(1, 5, (S, B), generator=g).float()))
    if miss:
        out["miss_table"] = torch.randn((miss, dim), generator=g)
    return {k: v.to(device) for k, v in out.items()}


def restore_case(kind: str, C: int, dim: int, ring_rows: int, n: int, bf16: bool, device, seed: int) -> Dict:
    """A pool (C+1, dim) with random rows and state (row C zero), a random
    eviction ring (ring_rows, dim + state_dim), bf16 where ``bf16``, and
    ``n`` restores: distinct rows of the pool from random ring rows, padded
    as the tier pads them (sources 0, rows C+1) to a power of two. Returns
    the keyword arguments of ``restore_rows_reference``."""
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    table = torch.randn((C + 1, dim), generator=g)
    table[C] = 0
    state = init_sparse_state(OPTIMIZERS[kind].config, C + 1, dim)
    for s in state.values():
        s.copy_(torch.rand(s.shape, generator=g))
    width = dim + sum(s.shape[1] for s in state.values())
    ring = torch.randn((ring_rows, width), generator=g).to(torch.bfloat16 if bf16 else torch.float32)
    size = round_up_pow2(n) if n else 0
    src = np.zeros(size, np.int32)
    dst = np.full(size, C + 1, np.int32)
    src[:n] = rng.integers(0, ring_rows, n)
    dst[:n] = rng.permutation(C)[:n]
    out = dict(table=table, state=state, ring=ring, src_idx=torch.from_numpy(src), dst_rows=torch.from_numpy(dst))
    return {k: (v.to(device) if torch.is_tensor(v) else {kk: vv.to(device) for kk, vv in v.items()})
            for k, v in out.items()}
