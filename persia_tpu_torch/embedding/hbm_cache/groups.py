"""Cache groups, the device state of the cache tier, and its device ops
(counterpart of ``persia_tpu/embedding/hbm_cache/groups.py``).

The device ops are the kernels K12 and K13 behind their wrappers, each
of which takes its plain version for a CPU tensor: ``_apply_aux``,
``_gather_entry_rows`` and the stream's restores are ``ops.cache_aux``
(plain version ``cache_aux_reference``; the restores alone, the
reference's ``_restore_rows``, are ``restore_rows_reference``, no kernel of
their own); the gather with ``_model_emb_from_gathered``'s mask, sum and
scale is ``ops.cached_gather`` (``cached_gather_reference``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from persia_tpu_torch.config import EmbeddingConfig
from persia_tpu_torch.embedding.optim import OPTIMIZER_ADAGRAD, OPTIMIZER_ADAM, OptimizerConfig
from persia_tpu_torch.ops.cache_aux import cache_aux, entry_state_cols, gather_entry_rows, restore_rows_reference
from persia_tpu_torch.ops.sparse_update import init_sparse_state

_apply_aux = cache_aux
_gather_entry_rows = gather_entry_rows
_entry_to_state_cols = entry_state_cols
_restore_rows = restore_rows_reference


@dataclass
class CachedTrainState:
    """The cache tier's training state, updated in place by a step:
    ``model`` and its ``optimizer`` (a ``torch.optim.Adam``), each group's
    table (C+1, dim) f32 or bf16 (row C the zero pad) and its f32
    optimizer state (C+1, ·), the sparse Adam's batch powers (a device
    f32[2]), the step count (a device int32) and, under the dynamic loss
    scale, its ``LossScaleState`` of device tensors (else None)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    tables: Dict[str, torch.Tensor]
    emb_state: Dict[str, Dict[str, torch.Tensor]]
    emb_batch_state: torch.Tensor
    step: torch.Tensor
    loss_scale: Optional[object] = None


@dataclass(frozen=True)
class CacheGroup:
    """One row pool on the card shared by every slot of one embedding dim."""

    name: str
    dim: int
    rows: int  # capacity C (the table has C+1 rows)
    state_dim: int
    pooled_slots: Tuple[str, ...]  # stacked: one gather and one update for all of them
    raw_slots: Tuple[str, ...]  # sequence slots, (B, L) rows each

    @property
    def slots(self) -> Tuple[str, ...]:
        return self.pooled_slots + self.raw_slots


@dataclass(frozen=True)
class CacheLayout:
    """Which slots a batch carries: ``stacked`` is ((group, (slot, ...)),
    ...) in stack order; ``ps`` the slots the parameter-server tier serves
    (hash-stacked or excluded), in the order of their ``batch["ps_emb"]``
    entries."""

    stacked: Tuple[Tuple[str, Tuple[str, ...]], ...]
    ps: Tuple[str, ...] = ()


def make_cache_groups(cfg: EmbeddingConfig, rows_per_group: Dict[int, int], sparse_cfg: OptimizerConfig,
                      exclude: Sequence[str] = ()) -> Tuple[List[CacheGroup], Tuple[str, ...]]:
    """One group a dim, in ascending dim, its slots sorted (a group dedups
    its signs across slots, so slots that share a sign share a row).
    Returns ``(groups, ps_slots)``: a hash-stack slot (many table keys an
    id, which cannot be cached) and every ``exclude``d one ride the
    parameter-server tier (sorted); an ``exclude``d name the config lacks
    raises ``KeyError``."""
    unknown = set(exclude) - set(cfg.slots_config)
    if unknown:
        raise KeyError(f"exclude names not in embedding config: {sorted(unknown)}")
    by_dim: Dict[int, Tuple[List[str], List[str]]] = {}
    ps_slots: List[str] = []
    for name, slot in cfg.slots_config.items():
        if slot.hash_stack_config.enabled or name in exclude:
            ps_slots.append(name)
            continue
        pooled, raw = by_dim.setdefault(slot.dim, ([], []))
        (pooled if slot.embedding_summation else raw).append(name)
    groups = [
        CacheGroup(name=f"cache_d{dim}", dim=dim, rows=rows_per_group[dim], state_dim=sparse_cfg.state_dim(dim),
                   pooled_slots=tuple(sorted(by_dim[dim][0])), raw_slots=tuple(sorted(by_dim[dim][1])))
        for dim in sorted(by_dim)
    ]
    return groups, tuple(sorted(ps_slots))


def init_cached_tables(groups: Sequence[CacheGroup], sparse_cfg: OptimizerConfig, device=None,
                       dtype=torch.float32):
    """Zeroed pools of C+1 rows in ``dtype`` (f32, or bf16: the reference's
    ``table_dtype``) and their fresh f32 optimizer state: rows arrive by
    the aux program's writes (rounded to the pool's dtype); only the pad
    row C's zeros matter, and no update touches it."""
    tables, emb_state = {}, {}
    for g in groups:
        tables[g.name] = torch.zeros((g.rows + 1, g.dim), dtype=dtype, device=device)
        emb_state[g.name] = init_sparse_state(sparse_cfg, g.rows + 1, g.dim, device=device)
    return tables, emb_state


def _state_init_consts(cfg: OptimizerConfig) -> Tuple[Tuple[str, float], ...]:
    """(key, value) of a fresh entry's state: the parameter server's
    ``init_state``."""
    if cfg.kind == OPTIMIZER_ADAGRAD:
        return (("acc", float(cfg.initialization)),)
    if cfg.kind == OPTIMIZER_ADAM:
        return (("m", 0.0), ("v", 0.0))
    return ()


def _slot_group_of(groups: Sequence[CacheGroup], slot: str) -> str:
    for g in groups:
        if slot in g.slots:
            return g.name
    raise KeyError(slot)


def _model_emb_from_gathered(layout: CacheLayout, pooled: Dict[str, torch.Tensor], raw: Dict[str, Tuple],
                             ps_inputs: Sequence = ()) -> List:
    """The model's per-slot inputs in sorted slot order (string order:
    ``cat_10`` before ``cat_2``): each stacked group's pooled (S, B, dim)
    split by slot, each raw slot's (rows, mask), and the parameter-server
    slots' inputs (``ps_inputs``, in ``layout.ps`` order)."""
    slot_emb: Dict[str, object] = {}
    for gname, names in layout.stacked:
        for i, name in enumerate(names):
            slot_emb[name] = pooled[gname][i]
    slot_emb.update(raw)
    slot_emb.update(zip(layout.ps, ps_inputs))
    return [slot_emb[n] for n in sorted(slot_emb)]
