"""The cache tier's aux program: the CUDA kernel K12
(``csrc/cache_aux.cu``) and its plain PyTorch version.

For one cache group's table (C+1, dim) f32 and its optimizer state columns
(Adagrad ``acc`` (C+1, dim or 1); Adam ``m`` and ``v`` (C+1, dim); SGD
none), in this order, what the reference's ``_apply_aux``
(``persia_tpu/embedding/hbm_cache/groups.py:260-293``) computes:

(a) the eviction payload ``[table | state][ev_rows]`` (K_ev, dim +
    state_dim), read before anything is written (a row evicted this step is
    usually the row a miss of this step is admitted into), f32 or, with
    ``wb_bf16``, rounded to bf16 (to nearest, ties to even);
(b) the warm entries (K_w, dim + state_dim), f32 or bf16 (the aux wire),
    written to the rows ``m_rows``: the table's columns and then each
    state's, widened to f32;
(c) the cold seeds (K_c, dim), f32 or bf16, written to ``c_rows``, their
    state set to ``state_consts`` (Adagrad's initial accumulator; Adam's
    zeros).

Rows past the table (the host pads with C+1) are dropped by (b) and (c); a
row of (a) is clamped into [0, C] as XLA's gather clamps (the host pads it
with C, the zero row). No miss is ever given the pad row C. The rows of (b) and (c) are distinct (the
directory hands out each row once), so no row is written twice.
``gather_entry_rows`` is (a) alone in f32, the flush's and publish's read
(``_gather_entry_rows``, ``groups.py:240-248``).

A CPU table takes the plain version. A CUDA table launches (a) and then (b)
with (c) as two kernels in stream order, one thread a float: the order is
what keeps the payload ahead of the writes. A call counts one launch in
``cache_aux.launches`` (``gather_entry_rows.launches``), whatever it runs.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from persia_tpu_torch.ops import _kernels

STATE_KEYS = ("acc", "m", "v")  # the column order of an entry's state tail
_DTYPES = {torch.float32: _kernels.DTYPE_F32, torch.bfloat16: _kernels.DTYPE_BF16}


def _states(state: Dict[str, torch.Tensor]):
    return [state[k] for k in STATE_KEYS if k in state]


def _clamped(rows: torch.Tensor, n: int) -> torch.Tensor:
    return rows.long().clamp(0, n - 1)


def gather_entry_rows_reference(table: torch.Tensor, state: Dict[str, torch.Tensor],
                                rows: torch.Tensor) -> torch.Tensor:
    """Plain version: ``cat([table[rows], *state[rows]], 1)`` in f32."""
    r = _clamped(rows, table.shape[0])
    return torch.cat([table[r]] + [s[r] for s in _states(state)], dim=1).float()


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


def cache_aux_reference(table, state, ev_rows, m_rows, m_entries, c_rows, c_emb,
                        state_consts: Sequence[Tuple[str, float]], wb_bf16: bool = False) -> torch.Tensor:
    """Plain version of ``cache_aux``: index, ``cat`` and ``index_put_``."""
    payload = gather_entry_rows_reference(table, state, ev_rows)
    if wb_bf16:
        payload = payload.to(torch.bfloat16)
    _scatter_reference(table, state, m_rows, m_entries)
    _write_rows(table, c_rows, c_emb.float())
    for key, val in state_consts:
        s = state[key]
        _write_rows(s, c_rows, torch.full((c_rows.shape[0], s.shape[1]), val, dtype=s.dtype, device=s.device))
    return payload


def _check(table, state, rows_and_data) -> list:
    dev = table.device
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("cache_aux needs a contiguous (C+1, dim) float32 table")
    states = _states(state)
    if set(state) - set(STATE_KEYS) or len(states) > 2:
        raise ValueError(f"state keys {sorted(state)} are not an optimizer's ({STATE_KEYS})")
    for s in states:
        if s.dtype != torch.float32 or s.device != dev or not s.is_contiguous() or s.dim() != 2 \
                or s.shape[0] != table.shape[0]:
            raise ValueError(f"state must be contiguous ({table.shape[0]}, w) float32 on {dev}")
    for rows, data, width in rows_and_data:
        if rows.dtype != torch.int32 or rows.device != dev or rows.dim() != 1 or not rows.is_contiguous():
            raise ValueError("rows must be contiguous (K,) int32 on the table's device")
        if data is not None and (data.dtype not in _DTYPES or data.device != dev or not data.is_contiguous()
                                 or data.shape != (rows.shape[0], width)):
            raise ValueError(f"data must be contiguous ({rows.shape[0]}, {width}) float32 or bfloat16")
    return states


def _launch(table, states, ev_rows, payload, m_rows, m_entries, c_rows, c_emb, consts) -> None:
    widths = [s.shape[1] for s in states] + [0, 0]
    ptrs = [s.data_ptr() for s in states] + [0, 0]
    lib = _kernels.library()
    with torch.cuda.device(table.device):
        rc = lib.persia_cache_aux(
            table.data_ptr(), table.shape[0], table.shape[1], ptrs[0], widths[0], ptrs[1], widths[1],
            ev_rows.data_ptr(), ev_rows.shape[0], payload.data_ptr() if payload is not None else None,
            _DTYPES[payload.dtype] if payload is not None else 0,
            m_rows.data_ptr(), m_rows.shape[0], m_entries.data_ptr(), _DTYPES[m_entries.dtype],
            c_rows.data_ptr(), c_rows.shape[0], c_emb.data_ptr(), _DTYPES[c_emb.dtype],
            consts[0], consts[1], _kernels.stream_handle(table),
        )
    _kernels.check(rc, "cache_aux")


def cache_aux(table: torch.Tensor, state: Dict[str, torch.Tensor], ev_rows: torch.Tensor,
              m_rows: torch.Tensor, m_entries: torch.Tensor, c_rows: torch.Tensor, c_emb: torch.Tensor,
              state_consts: Sequence[Tuple[str, float]], wb_bf16: bool = False) -> torch.Tensor:
    """(a)-(c) of the module's docstring, ``table`` and ``state`` written in
    place; returns the payload (K_ev, dim + state_dim), bf16 with
    ``wb_bf16`` else f32. Any piece may have 0 rows."""
    dim = table.shape[1]
    states = _check(table, state, [(ev_rows, None, 0), (m_rows, m_entries, dim + sum(s.shape[1] for s in _states(state))),
                                   (c_rows, c_emb, dim)])
    consts = dict(state_consts)
    if set(consts) != set(k for k in STATE_KEYS if k in state):
        raise ValueError(f"state_consts {sorted(consts)} do not match the state {sorted(state)}")
    if table.device.type == "cpu":
        return cache_aux_reference(table, state, ev_rows, m_rows, m_entries, c_rows, c_emb, state_consts, wb_bf16)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    width = dim + sum(s.shape[1] for s in states)
    payload = torch.empty((ev_rows.shape[0], width), dtype=torch.bfloat16 if wb_bf16 else torch.float32,
                          device=table.device)
    c = [consts[k] for k in STATE_KEYS if k in state] + [0.0, 0.0]
    _launch(table, states, ev_rows, payload, m_rows, m_entries, c_rows, c_emb, c)
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
    empty_rows = rows[:0]
    empty_data = payload[:0, :0]
    _launch(table, states, rows, payload, empty_rows, empty_data, empty_rows, empty_data, [0.0, 0.0])
    gather_entry_rows.launches += 1
    return payload


cache_aux.launches = 0
gather_entry_rows.launches = 0
