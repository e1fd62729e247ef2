"""The cache tier's aux program: the CUDA kernel K12
(``csrc/cache_aux.cu``) and its plain PyTorch version.

For one cache group's table (C+1, dim) f32 or bf16 (the pool's dtype,
``init_cached_tables``' ``dtype``) and its f32 optimizer state columns
(Adagrad ``acc`` (C+1, dim or 1); Adam ``m`` and ``v`` (C+1, dim); SGD
none), in this order, what the reference's ``_apply_aux``
(``persia_tpu/embedding/hbm_cache/groups.py:260-293``) computes. A bf16
table's row is widened to f32 where it is read (the reference's
``concatenate`` of a bf16 row and the f32 state promotes it) and every
value written to it is rounded to bf16, to nearest, ties to even (its
``astype(table.dtype)``, ``groups.py:225-236,287``):

(a) the eviction payload ``[table | state][ev_rows]`` (K_ev, dim +
    state_dim), read before anything is written (a row evicted this step is
    usually the row a miss of this step is admitted into), f32 or, with
    ``wb_bf16``, rounded to bf16 (to nearest, ties to even);
(b) the warm entries (K_w, dim + state_dim), f32 or bf16 (the aux wire),
    written to the rows ``m_rows``: the table's columns and then each
    state's, widened to f32;
(c) the cold seeds (K_c, dim), f32 or bf16, written to ``c_rows``, their
    state set to ``state_consts`` (Adagrad's initial accumulator; Adam's
    zeros);
(d) with ``restores`` ``(r_src, r_dst, r_slot)``, the stream's in-flight
    restores (``_restore_rows``, ``groups.py:250-256``): the entries
    ``ring[r_src]`` (the ring holds payloads: the write-back wire's dtype)
    written to the rows ``r_dst``, widened to f32.

Rows past the table (the host pads with C+1) are dropped by (b)-(d); a
row of (a) is clamped into [0, C] as XLA's gather clamps (the host pads it
with C, the zero row), as is a restore's source into the ring (pads 0).
No miss is ever given the pad row C. The rows of (b)-(d) are distinct (the
directory hands out each row once), so no row is written twice. With a
``ring`` and a ``ring_pos`` (``_apply_aux_ring``, ``groups.py:296-314``)
the payload is also stored at ``ring[start:start + K_ev]``, ``start`` =
``ring_pos`` placed as ``lax.dynamic_update_slice`` places it
(``ring_start``); ``ring_pos=None`` stores nothing, and the ring is only
read by the restores. ``gather_entry_rows`` is (a) alone in f32, the
flush's and publish's read (``_gather_entry_rows``, ``groups.py:240-248``).
A bf16 table's payload row, widened and then (with ``wb_bf16``) rounded
back, keeps its bits.

**The pairing.** The kernel reads each evicted row in the thread that
rewrites it, so it needs to know which write overwrites which payload
slot: ``m_slot`` (K_w,), ``c_slot`` (K_c,) and ``r_slot`` (K_r,) int32
hold, for each write, the slot of ``ev_rows`` whose old contents it must
read first, or -1; ``ev_free`` int32 lists the slots no write claims (-1
pads). The plain version computes what it computed without them and, on
CPU tensors, checks them (``check_pairing``): a wrong pairing would make
the kernel read a row after its write.

**One launch's contract.** The restores read ring rows while the same
launch stores the payload into the ring: a live restore must not read a
row of the call's own span ``[start, start + K_ev)``, or two threads
race. The stream never asks for that (it reserves a step's span before
its gate looks for restores); the plain version raises on CPU tensors
(``check_restore_sources``), as it does on a write row that repeats
(``check_distinct_rows``).

A CPU table takes the plain version. A CUDA table launches one kernel a
call that has any rows (and none for a call without), which adds one to
``cache_aux.launches`` (``gather_entry_rows.launches``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from persia_tpu_torch.ops import _kernels
from persia_tpu_torch.ops.plans import cache_entry_vec

STATE_KEYS = ("acc", "m", "v")  # the column order of an entry's state tail
_DTYPES = {torch.float32: _kernels.DTYPE_F32, torch.bfloat16: _kernels.DTYPE_BF16}


def _states(state: Dict[str, torch.Tensor]):
    return [state[k] for k in STATE_KEYS if k in state]


def _clamped(rows: torch.Tensor, n: int) -> torch.Tensor:
    return rows.long().clamp(0, n - 1)


def gather_entry_rows_reference(table: torch.Tensor, state: Dict[str, torch.Tensor],
                                rows: torch.Tensor) -> torch.Tensor:
    """Plain version: ``cat([table[rows], *state[rows]], 1)`` in f32 (a
    bf16 table's rows widened)."""
    r = _clamped(rows, table.shape[0])
    return torch.cat([table[r].float()] + [s[r] for s in _states(state)], dim=1)


def _write_rows(dst: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> None:
    """``dst[rows] = vals`` with rows outside [0, C] dropped: a dropped
    row writes row C's own value back to row C (the pad row, never a
    miss's row), so no shape depends on the data (a CUDA graph captures
    it)."""
    C = dst.shape[0] - 1
    keep = (rows >= 0) & (rows <= C)
    r = torch.where(keep, rows, torch.full_like(rows, C)).long()
    dst.index_put_((r,), torch.where(keep[:, None], vals.to(dst.dtype), dst[C]))


def entry_state_cols(state: Dict[str, torch.Tensor], entry_tail: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Split an entry's state tail (M, state_dim) into the state's columns:
    a parameter server's entry is [emb | acc] (Adagrad) or [emb | m | v]
    (Adam)."""
    out, off = {}, 0
    for key in STATE_KEYS:
        if key in state:
            w = state[key].shape[1]
            out[key] = entry_tail[:, off:off + w]
            off += w
    return out


def _scatter_reference(table, state, rows, entries) -> None:
    dim = table.shape[1]
    vals = entries.float()
    _write_rows(table, rows, vals[:, :dim])
    for key, cols in entry_state_cols(state, vals[:, dim:]).items():
        _write_rows(state[key], rows, cols)


def check_distinct_rows(num_rows: int, rows: torch.Tensor) -> None:
    """Raise ``ValueError`` when a row inside [0, num_rows) repeats."""
    live = rows.long()[(rows >= 0) & (rows < num_rows)]
    if live.numel() and bool(torch.bincount(live, minlength=num_rows).gt(1).any()):
        raise ValueError("a write row repeats within one call: the concatenated writes are not the reference's")


def restore_rows_reference(table: torch.Tensor, state: Dict[str, torch.Tensor], ring: torch.Tensor,
                           src_idx: torch.Tensor, dst_rows: torch.Tensor) -> None:
    """(d) alone, in place: the reference's ``_restore_rows`` (a gather and
    ``index_put_``s). On CPU tensors it first checks that no row repeats."""
    if table.device.type == "cpu":
        check_distinct_rows(table.shape[0], dst_rows)
    entries = ring[src_idx.long().clamp(0, ring.shape[0] - 1)].float()
    dim = table.shape[1]
    _write_rows(table, dst_rows, entries[:, :dim])
    for key, cols in entry_state_cols(state, entries[:, dim:]).items():
        _write_rows(state[key], dst_rows, cols)


def check_restore_sources(num_rows: int, ring_rows: int, span_start: int, span_rows: int, r_src: torch.Tensor,
                          r_dst: torch.Tensor) -> None:
    """Raise ``ValueError`` when a live restore (its row inside [0,
    num_rows)) reads a ring row of ``[span_start, span_start +
    span_rows)``, the span the same call stores its payload into
    (sources clamped as the read clamps them)."""
    live = (r_dst >= 0) & (r_dst < num_rows)
    src = r_src.long()[live].clamp(0, ring_rows - 1)
    if bool(((src >= span_start) & (src < span_start + span_rows)).any()):
        raise ValueError("a restore reads a ring row of the span the same call stores its payload into")


def check_pairing(num_rows: int, ev_rows, m_rows, m_slot, c_rows, c_slot, ev_free, r_rows=None,
                  r_slot=None) -> None:
    """Raise ``ValueError`` unless the pairing lets the kernel read every
    payload slot before its row is written: each slot of ``ev_rows`` is
    claimed by exactly one write (``m_slot`` / ``c_slot`` / ``r_slot``, -1
    for none) or listed once in ``ev_free`` (-1 pads); a claimed slot's row
    is its writer's row, inside the table; and no write lands on the row of
    an unclaimed slot (clamped as the payload's read clamps it)."""
    if r_rows is None:
        r_rows = r_slot = m_rows[:0]
    n_ev = ev_rows.shape[0]
    for rows, slot, what in ((m_rows, m_slot, "m_slot"), (c_rows, c_slot, "c_slot"), (r_rows, r_slot, "r_slot")):
        if slot.shape != rows.shape:
            raise ValueError(f"{what} {tuple(slot.shape)} does not match its rows {tuple(rows.shape)}")
    slots = torch.cat([m_slot, c_slot, r_slot, ev_free]).long()
    if bool(((slots < -1) | (slots >= n_ev)).any()):
        raise ValueError(f"a pairing slot lies outside [-1, {n_ev})")
    listed = slots[slots >= 0]
    if listed.numel() != n_ev or torch.bincount(listed, minlength=n_ev).ne(1).any():
        raise ValueError("a payload slot is claimed twice, or neither claimed nor listed as unclaimed")
    writes_r = torch.cat([m_rows, c_rows, r_rows]).long()
    writes_s = torch.cat([m_slot, c_slot, r_slot]).long()
    claimed = writes_s >= 0
    if claimed.any():
        r, s = writes_r[claimed], writes_s[claimed]
        if bool(((r < 0) | (r >= num_rows)).any()) or not torch.equal(ev_rows.long()[s], r):
            raise ValueError("a write claims a payload slot whose row is not the row it writes")
    free = ev_free.long()[ev_free >= 0]
    live = writes_r[(writes_r >= 0) & (writes_r < num_rows)]
    if free.numel() and live.numel() and bool(torch.isin(_clamped(ev_rows.long()[free], num_rows), live).any()):
        raise ValueError("a write lands on the row of a payload slot no write claims")


def _plain(table, state, ev_rows, m_rows, m_entries, c_rows, c_emb, state_consts, wb_bf16, m_slot, c_slot, ev_free,
           ring, ring_pos, restores) -> torch.Tensor:
    """(a)-(d) in the reference's order: ``_apply_aux`` (or
    ``_apply_aux_ring`` with a ``ring_pos``), then ``_restore_rows``. On
    CPU tensors the call's contract is checked first, before any write."""
    if restores is not None and ring is None:
        raise ValueError("restores read the group's ring: pass it")
    r_src, r_dst, r_slot = restores if restores is not None else (None, None, None)
    if table.device.type == "cpu":
        check_pairing(table.shape[0], ev_rows, m_rows, m_slot, c_rows, c_slot, ev_free, r_dst, r_slot)
        check_distinct_rows(table.shape[0], torch.cat([m_rows, c_rows] + ([r_dst] if restores is not None else [])))
        if restores is not None and ring_pos is not None:
            check_restore_sources(table.shape[0], ring.shape[0], ring_start(ring.shape[0], ring_pos,
                                                                             ev_rows.shape[0]),
                                  ev_rows.shape[0], r_src, r_dst)
    payload = gather_entry_rows_reference(table, state, ev_rows)
    if wb_bf16:
        payload = payload.to(torch.bfloat16)
    _scatter_reference(table, state, m_rows, m_entries)
    _write_rows(table, c_rows, c_emb.float())
    for key, val in state_consts:
        s = state[key]
        _write_rows(s, c_rows, torch.full((c_rows.shape[0], s.shape[1]), val, dtype=s.dtype, device=s.device))
    if ring_pos is not None:
        start = ring_start(ring.shape[0], ring_pos, payload.shape[0])
        ring[start:start + payload.shape[0]] = payload.to(ring.dtype)
    if restores is not None:
        restore_rows_reference(table, state, ring, r_src, r_dst)
    return payload


def cache_aux_reference(table, state, ev_rows, m_rows, m_entries, c_rows, c_emb,
                        state_consts: Sequence[Tuple[str, float]], wb_bf16: bool = False, *,
                        m_slot: torch.Tensor, c_slot: torch.Tensor, ev_free: torch.Tensor,
                        ring: Optional[torch.Tensor] = None, restores=None) -> torch.Tensor:
    """Plain version of ``cache_aux`` without a ring store: index, ``cat``
    and ``index_put_``, then the ``restores`` (if any) from ``ring``. The
    pairing changes nothing it computes; on CPU tensors it is checked
    (``check_pairing``), as are the distinct rows. Returns the payload."""
    return _plain(table, state, ev_rows, m_rows, m_entries, c_rows, c_emb, state_consts, wb_bf16, m_slot, c_slot,
                  ev_free, ring, None, restores)


def ring_start(ring_rows: int, ring_pos: int, n_ev: int) -> int:
    """Where the payload lands in the ring, as ``lax.dynamic_update_slice``
    places it: a negative ``ring_pos`` counts from the end (+ ring_rows),
    then it is clamped into [0, ring_rows - n_ev]."""
    pos = int(ring_pos) + (ring_rows if ring_pos < 0 else 0)
    return min(max(pos, 0), ring_rows - n_ev)


def cache_aux_ring_reference(table, state, ring: torch.Tensor, ring_pos: int, ev_rows, m_rows, m_entries, c_rows,
                             c_emb, state_consts: Sequence[Tuple[str, float]], wb_bf16: bool = False, *,
                             m_slot: torch.Tensor, c_slot: torch.Tensor, ev_free: torch.Tensor,
                             restores=None) -> torch.Tensor:
    """Plain version of ``cache_aux`` with a ring (``_apply_aux_ring``):
    ``cache_aux_reference``'s writes, the payload also stored into ``ring``
    in place at ``ring_start(...)``, then the ``restores`` (if any) from
    ``ring``; on CPU tensors no live restore may read the span just stored
    (``check_restore_sources``). Returns the payload."""
    return _plain(table, state, ev_rows, m_rows, m_entries, c_rows, c_emb, state_consts, wb_bf16, m_slot, c_slot,
                  ev_free, ring, ring_pos, restores)


def _check(table, state, rows_and_data) -> list:
    dev = table.device
    if table.dtype not in _DTYPES or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("cache_aux needs a contiguous (C+1, dim) float32 or bfloat16 table")
    states = _states(state)
    if set(state) - set(STATE_KEYS) or len(states) > 2:
        raise ValueError(f"state keys {sorted(state)} are not an optimizer's ({STATE_KEYS})")
    for s in states:
        if s.dtype != torch.float32 or s.device != dev or not s.is_contiguous() or s.dim() != 2 \
                or s.shape[0] != table.shape[0]:
            raise ValueError(f"state must be contiguous ({table.shape[0]}, w) float32 on {dev}")
    for rows, data, width in rows_and_data:
        if rows.dtype != torch.int32 or rows.device != dev or rows.dim() != 1 or not rows.is_contiguous():
            raise ValueError("rows and slots must be contiguous (K,) int32 on the table's device")
        if data is not None and (data.dtype not in _DTYPES or data.device != dev or not data.is_contiguous()
                                 or data.shape != (rows.shape[0], width)):
            raise ValueError(f"data must be contiguous ({rows.shape[0]}, {width}) float32 or bfloat16")
    return states


def _aligned(*tensors) -> bool:
    return all(t.numel() == 0 or t.data_ptr() % 16 == 0 for t in tensors)


def _pool_args(table, states):
    widths = [s.shape[1] for s in states] + [0, 0]
    ptrs = [s.data_ptr() for s in states] + [0, 0]
    return [table.data_ptr(), _DTYPES[table.dtype], table.shape[0], table.shape[1], ptrs[0], widths[0], ptrs[1],
            widths[1]]


def cache_aux(table: torch.Tensor, state: Dict[str, torch.Tensor], ev_rows: torch.Tensor,
              m_rows: torch.Tensor, m_entries: torch.Tensor, c_rows: torch.Tensor, c_emb: torch.Tensor,
              state_consts: Sequence[Tuple[str, float]], wb_bf16: bool = False, *, m_slot: torch.Tensor,
              c_slot: torch.Tensor, ev_free: torch.Tensor, ring: Optional[torch.Tensor] = None,
              ring_pos: Optional[int] = 0, restores=None) -> torch.Tensor:
    """(a)-(d) of the module's docstring, ``table`` and ``state`` written in
    place, with the pairing ``m_slot``, ``c_slot``, ``ev_free`` (and the
    restores' ``r_slot``); returns the payload (K_ev, dim + state_dim),
    bf16 with ``wb_bf16`` else f32. ``ring``: (ring_rows, dim + state_dim)
    in the payload's dtype; with a ``ring_pos`` (ring_rows >= K_ev) the
    payload is also stored there, from ``ring_start(ring_rows, ring_pos,
    K_ev)``. ``restores``: (r_src, r_dst, r_slot) int32 (K_r,), read from
    ``ring``. Any piece may have 0 rows."""
    dim = table.shape[1]
    width = dim + sum(s.shape[1] for s in _states(state))
    pieces = [(ev_rows, None, 0), (m_rows, m_entries, width), (c_rows, c_emb, dim), (m_slot, None, 0),
              (c_slot, None, 0), (ev_free, None, 0)]
    if restores is not None:
        pieces += [(r, None, 0) for r in restores]
    states = _check(table, state, pieces)
    if m_slot.shape != m_rows.shape or c_slot.shape != c_rows.shape:
        raise ValueError("m_slot and c_slot must match m_rows and c_rows")
    if restores is not None and not restores[0].shape == restores[1].shape == restores[2].shape:
        raise ValueError("r_src, r_dst and r_slot must have one shape")
    consts = dict(state_consts)
    if set(consts) != set(k for k in STATE_KEYS if k in state):
        raise ValueError(f"state_consts {sorted(consts)} do not match the state {sorted(state)}")
    pay_dtype = torch.bfloat16 if wb_bf16 else torch.float32
    if ring is not None and (ring.dtype != pay_dtype or ring.device != table.device or not ring.is_contiguous()
                             or ring.dim() != 2 or ring.shape[1] != width or ring.shape[0] < 1
                             or (ring_pos is not None and ring.shape[0] < ev_rows.shape[0])):
        raise ValueError(f"ring must be contiguous (>= {max(1, ev_rows.shape[0])}, {width}) {pay_dtype} on the "
                         f"table's device")
    if restores is not None and ring is None:
        raise ValueError("restores read the group's ring: pass it")
    pairing = dict(m_slot=m_slot, c_slot=c_slot, ev_free=ev_free)
    if table.device.type == "cpu":
        if ring is not None and ring_pos is not None:
            return cache_aux_ring_reference(table, state, ring, ring_pos, ev_rows, m_rows, m_entries, c_rows, c_emb,
                                            state_consts, wb_bf16, restores=restores, **pairing)
        return cache_aux_reference(table, state, ev_rows, m_rows, m_entries, c_rows, c_emb, state_consts, wb_bf16,
                                   ring=ring, restores=restores, **pairing)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    payload = torch.empty((ev_rows.shape[0], width), dtype=pay_dtype, device=table.device)
    wide = wb_bf16 or torch.bfloat16 in (m_entries.dtype, c_emb.dtype, table.dtype)
    vec = cache_entry_vec([dim] + [s.shape[1] for s in states], wide,
                          _aligned(table, *states, payload, m_entries, c_emb, *([ring] if ring is not None else [])))
    c = [consts[k] for k in STATE_KEYS if k in state] + [0.0, 0.0]
    r_src, r_dst, r_slot = restores if restores is not None else (None, None, None)
    n_r = r_dst.shape[0] if restores is not None else 0
    lib = _kernels.library()
    with torch.cuda.device(table.device):
        rc = lib.persia_cache_aux(
            *_pool_args(table, states), vec, ev_rows.data_ptr(), ev_rows.shape[0], payload.data_ptr(),
            _DTYPES[pay_dtype], m_rows.data_ptr(), m_slot.data_ptr(), m_rows.shape[0], m_entries.data_ptr(),
            _DTYPES[m_entries.dtype], c_rows.data_ptr(), c_slot.data_ptr(), c_rows.shape[0], c_emb.data_ptr(),
            _DTYPES[c_emb.dtype], c[0], c[1], r_src.data_ptr() if n_r else None, r_dst.data_ptr() if n_r else None,
            r_slot.data_ptr() if n_r else None, n_r, ev_free.data_ptr(), ev_free.shape[0],
            ring.data_ptr() if ring is not None else None, ring.shape[0] if ring is not None else 0,
            int(ring is not None and ring_pos is not None), int(ring_pos or 0), _kernels.stream_handle(table),
        )
    _kernels.check(rc, "cache_aux")
    if m_rows.shape[0] + c_rows.shape[0] + n_r + ev_free.shape[0]:
        cache_aux.launches += 1
    return payload


def gather_entry_rows(table: torch.Tensor, state: Dict[str, torch.Tensor], rows: torch.Tensor) -> torch.Tensor:
    """(a) alone, in f32: the ``[table | state]`` entries of ``rows``
    (int32), the flush's and publish's read."""
    states = _check(table, state, [(rows, None, 0)])
    if table.device.type == "cpu":
        return gather_entry_rows_reference(table, state, rows)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    width = table.shape[1] + sum(s.shape[1] for s in states)
    payload = torch.empty((rows.shape[0], width), dtype=torch.float32, device=table.device)
    vec = cache_entry_vec([table.shape[1]] + [s.shape[1] for s in states], False, _aligned(table, *states, payload))
    lib = _kernels.library()
    with torch.cuda.device(table.device):
        rc = lib.persia_entry_rows(*_pool_args(table, states), vec, rows.data_ptr(), rows.shape[0],
                                   payload.data_ptr(), _kernels.stream_handle(table))
    _kernels.check(rc, "gather_entry_rows")
    if rows.shape[0]:
        gather_entry_rows.launches += 1
    return payload


cache_aux.launches = 0
gather_entry_rows.launches = 0
