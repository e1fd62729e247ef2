"""The cache tier's stream (counterpart of
``persia_tpu/embedding/hbm_cache/stream.py``): ``CachedTrainCtx.train_stream``
runs ``run_train_stream``.

Four lanes, each a thread:

- the **feeder** admits a batch (``tier.prepare_batch``: the directory, the
  hazard gate, the servers' probe, the host arrays) and records the step's
  evictions in the pending map (sign → ring row) before the next admit;
- the **stager** copies a step's host arrays to the card on its own CUDA
  stream and records an event that the dispatch waits on; at
  ``pipeline_depth > 1`` it also dispatches the step's feed stage (below);
- the **dispatch** (the caller's thread, on its current stream) runs each
  step's card work in order (``ctx._dispatch``: K12 with the step's ring
  span and its restores, then the step), or up to ``dispatch_k``
  restore-free steps of one shape signature back to back as a pack
  (``ctx._dispatch_packed``), and hands each step's eviction payloads to
  the write-back with an event recorded after the step;
- the **write-back** waits on that event on its own CUDA stream, copies
  ``wb_flush_steps`` steps' payloads to pinned memory, writes them to the
  servers (``set_embedding``), then removes their pending-map entries and
  frees their ring spans.

**The parameter-server tier's lane** (``ps_slots``, hash-stacked slots).
The feeder also looks a batch's PS-tier slots up through the worker
(``ctx._ps_forward``, a staleness ref) and stages their entries with the
step. The dispatch queues the step's packed PS gradients (``("psgrad",
...)``, with an event recorded after the step) on the write-back queue,
before its evictions; such a step never joins a pack and a pipelined
stream never hoists its feed. The write-back gathers ``psgrad_batch`` of
them, copies them all to pinned memory on its stream, waits once, and
applies them to the worker in step order (``ctx._apply_ps_grads``, with
the global step's journal id under a job state); on a failure the refs
not yet applied are aborted. A PS-tier forward may so read entries whose
earlier gradients are still on their way: the staleness is bounded by
``prefetch + psgrad_batch`` steps, the reference's. No sign of a PS-tier
slot is ever cached (the tier's checks), so the two kinds of write-back
need no order between them. Every ref the stream took is aborted when it
ends (a no-op for an applied one), so a failure leaks none.

**The eviction ring.** A step's evicted entries also land in its group's
ring on the card, at a span the feeder reserves (``ring_alloc``) before
its hazard gate runs. A later miss on a sign whose write-back has not
landed is restored from the ring on the card (by the step's K12) instead
of read from the server. Spans are freed in step order once their write-back lands; a
feeder that finds no room asks the write-back to flush early and waits.

**Ordering.** Every card write of the pool runs on the dispatch's stream
in enqueue order, so a restore reads ring rows that earlier steps wrote, and
a span is rewritten only after every step that could restore from it has
dispatched. Lanes order their copies against it with recorded events only.

**The stage-pipelined stream** (``pipeline_depth`` > 1, the stage graph of
``parallel/stage_graph.py``). A step without restores has its feed stage
(``ctx._apply_feed``, K12) dispatched by the stager, up to depth − 1 steps
ahead of its own dense stage: its hazard sets come from the host arrays,
``reserve_feed`` holds it until its rows are disjoint from every in-flight
dense stage's trained rows (disjoint rows commute bit for bit), and it is
enqueued on the dispatch's stream behind the staging's event, under
``ctx._state_lock`` (held around every dense dispatch too), so the card
runs feeds and dense stages in the order they were enqueued. A restoring
step enters the window as a barrier and keeps the in-order path; no later
feed hoists across it. Feed-done steps dispatch their dense stages alone,
or ``min(dispatch_k, depth)`` of one dense signature as a pack
(``ctx._dispatch_packed_dense``). ``on_metrics`` forces depth 1.
Each copy takes a fresh pinned host buffer; PyTorch's pinned-memory
allocator hands a freed one out again only after the copy that used it has
completed.

**Every wait is bounded.** Each queue ``get``/``put`` and each condition
wait takes at most ``WAIT_S``, then looks at ``stop``; an exception in any
lane is stored, sets ``stop`` and wakes every waiter, and ``train_stream``
raises the first one stored. After ``stop`` each lane is joined for at
most ``JOIN_S`` altogether; one still alive raises a ``RuntimeError`` that
names it (chained to the first stored exception).

**Fences** (``snapshot_every`` with ``job_state`` or ``fence_callback``).
Before the step of every ``snapshot_every``-th global step (``start_step +
seq``, seq > 0) the feeder parks and sends a fence marker down the admitted
and the staged queues, behind every earlier step (the stager passes it on
without a feed). At the marker the dispatch, every earlier step dispatched,
flushes a partial pack, finds the stage graph's window empty
(``drain_for_fence``), sends a drain marker to the write-back and waits
until every earlier eviction has landed (the write-back answers it even
when its flush fails), checks that every group's ring is free (``heads ==
tails``) and the pending map empty, raising a ``RuntimeError`` that names
the groups otherwise, captures under ``ctx._state_lock``
(``ctx._fence_capture``: the cache flushed, one manifest committed), counts
the fence, runs ``fence_callback(global step)`` and unparks the feeder. A
callback's ``Exception`` is counted (``fence_callback_errors``) and logged,
and the stream goes on; a ``BaseException`` ends it as a lane's failure
does. The ring's positions carry on across a fence: its rows are stale but
no span is live. ``start_step`` offsets the cadence and ``ctx._global_step``
(``start_step + seq + 1`` after each step) for a resumed stream.

The health sentinel and quarantined steps are not part of this slice:
asking for either raises.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from persia_tpu_torch import jobstate
from persia_tpu_torch.embedding.hbm_cache.directory import PendingSignMap
from persia_tpu_torch.embedding.optim import OPTIMIZER_ADAM
from persia_tpu_torch.parallel.stage_graph import StageGraph, feed_hazard_info

WAIT_S = 0.25  # the longest a lane blocks before it looks at ``stop``
PACK_IDLE_S = 0.05  # a partial pack dispatches when no step arrives for this long
JOIN_S = 10.0  # the longest the lanes get to end after ``stop``
_END = object()  # the end of the batches, passed down the lanes

logger = logging.getLogger("persia_tpu_torch.hbm_cache.stream")


class _Stopped(Exception):
    """A lane saw ``stop`` while it waited."""


class _Fence:
    """The marker of a fence at global step ``step``, down the admitted and
    the staged queues."""

    def __init__(self, step: int):
        self.step = step


@contextmanager
def _lane_stream(device: torch.device):
    """A lane's own CUDA stream on ``device`` (None on the CPU)."""
    if device.type != "cuda":
        yield None
        return
    with torch.cuda.device(device):
        stream = torch.cuda.Stream(device=device)
        with torch.cuda.stream(stream):
            yield stream


def _staged_tensors(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            _staged_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _staged_tensors(v, out)
    elif torch.is_tensor(tree):
        out.append(tree)
    return out


def _unsupported(**options) -> None:
    on = sorted(k for k, v in options.items() if v)
    if on:
        raise NotImplementedError(f"the port's cache-tier stream has no {', '.join(on)} yet")


def run_train_stream(
    ctx,
    batches,
    prefetch: int = 3,
    on_metrics: Optional[Callable[[Dict], None]] = None,
    wb_flush_steps: int = 8,
    fetch_final: bool = True,
    psgrad_batch: int = 8,
    dispatch_k: int = 4,
    pipeline_depth: int = 1,
    snapshot_every: Optional[int] = None,
    job_state=None,
    start_step: int = 0,
    sentinel=None,
    skip_steps=None,
    fence_callback: Optional[Callable[[int], None]] = None,
) -> Optional[Dict]:
    """Train ``ctx`` (a ``CachedTrainCtx``) over an iterable of batches
    through the lanes of the module's docstring. Returns the last step's
    metrics; with ``fetch_final=False`` None, the last header kept on the
    card unread (``ctx.last_metrics()`` reads it). ``on_metrics(metrics)``
    gets every step's metrics (a read of each step's header; it sets
    ``dispatch_k`` and ``pipeline_depth`` to 1).

    ``prefetch``: the admitted and the staged steps each queue holds (the
    staged queue at least ``pipeline_depth``). ``wb_flush_steps``: the
    steps' payloads a write-back flush takes. ``dispatch_k``: the most
    steps a pack holds. ``pipeline_depth``: the stage graph's window (the
    module's docstring); 1 dispatches every feed in order.
    ``psgrad_batch``: the steps of PS-tier gradients the write-back fetches
    and applies together. ``snapshot_every``: the fences' cadence in global
    steps, run where ``job_state`` (a ``JobStateManager`` or its root: a
    manifest committed at each fence) or ``fence_callback`` is set (the
    module's docstring). ``start_step``: the global step of the first
    batch (a resumed stream's ``manifest.step``). ``sentinel`` and
    ``skip_steps`` raise unless left at their defaults."""
    _unsupported(sentinel=sentinel is not None, skip_steps=bool(skip_steps))
    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1, got {prefetch}")
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
    ctx._land_pending()  # a deferred synchronous step lands first
    if ctx.state is None:
        ctx.init_state()
    job_mgr = jobstate.coerce_manager(job_state) if job_state is not None else None
    if job_mgr is not None and ctx._job_epoch is None:
        ctx._job_epoch = 0
    fencing = bool(snapshot_every) and (job_mgr is not None or fence_callback is not None)
    fence_done = threading.Event()  # unparks the feeder after a fence
    tier, device = ctx.tier, ctx.device
    K = max(1, int(dispatch_k)) if on_metrics is None else 1
    pipelined = pipeline_depth > 1 and on_metrics is None  # on_metrics reads every header: in order
    graph = StageGraph(pipeline_depth if pipelined else 1)
    K_eff = min(K, graph.depth) if pipelined else K  # a full dense pack never outruns the window
    qcap = max(prefetch, graph.depth)  # or the queue, not the depth, would bound the feeds' lead
    slot_group = {s: g.name for s, g in tier._slot_group.items()}
    main = torch.cuda.current_stream(device) if device.type == "cuda" else None
    flush_steps = max(1, int(wb_flush_steps))
    ps_batch = max(1, int(psgrad_batch))
    stop = threading.Event()
    cv = threading.Condition()  # guards the ring accounting and errors
    errors: List[BaseException] = []
    prep_q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    staged_q: "queue.Queue" = queue.Queue(maxsize=qcap)
    wb_q: "queue.Queue" = queue.Queue(maxsize=flush_steps + qcap + ps_batch)
    flush_now = threading.Event()  # the feeder found the ring full
    sign_map = PendingSignMap()
    salts = dict(tier.group_salt)
    heads: Dict[str, int] = {}  # ring rows handed out, unwrapped
    tails: Dict[str, int] = {}  # ring rows freed, unwrapped
    spans: Dict[str, List[int]] = {}  # each live span's rows (with its skip), in step order
    lane_s = {"feeder": 0.0, "stager": 0.0, "dispatch": 0.0, "write_back": 0.0}
    ps_refs: List[int] = []  # every PS-tier ref the stream took, aborted at its end (a no-op once applied)
    # feed_leads[n]: the stager's feeds enqueued while n earlier steps' dense
    # stages were still to come (n > 0: the feed ran ahead of them)
    stats = {"dispatch_k": K, "packs": 0, "packed_steps": 0, "single_steps": 0, "pipelined_feeds": 0,
             "feed_leads": [0] * graph.depth, "restore_steps": 0, "restored_rows": 0, "ring_waits": 0, "flushes": 0,
             "psgrad_flushes": 0, "psgrad_steps": 0, "psgrad_bytes": 0,
             "fences": 0, "fence_callback_errors": 0, "fence_ms": [], "lane_s": lane_s}
    dense_done = [0]  # steps whose dense stage is enqueued (under the state lock)
    t_start = time.perf_counter()

    def fail(e: BaseException) -> None:
        with cv:
            errors.append(e)
            stop.set()
            cv.notify_all()
        flush_now.set()

    def put(q: "queue.Queue", item) -> None:
        while True:
            if stop.is_set():
                raise _Stopped
            try:
                q.put(item, timeout=WAIT_S)
                return
            except queue.Full:
                continue

    def get(q: "queue.Queue", timeout: float = WAIT_S):
        while True:
            if stop.is_set():
                raise _Stopped
            try:
                return q.get(timeout=timeout)
            except queue.Empty:
                if timeout < WAIT_S:
                    raise

    def wait_event(ev: torch.cuda.Event) -> None:
        """Poll a recorded event until it has completed (a host wait that
        still looks at ``stop``)."""
        while not ev.query():
            if stop.is_set():
                raise _Stopped
            time.sleep(1e-4)

    # ------------------------------------------------- the feeder's lane

    def ring_alloc(gname: str, kp: int) -> int:
        """Reserve ``kp`` rows of the group's ring for a step's evictions;
        a span never wraps (it skips to row 0 instead). Waits, asking the
        write-back to flush early, while the live spans leave no room."""
        W = ctx.ring_rows(gname)
        if kp > W:
            raise RuntimeError(f"one step evicts {kp} (padded) rows, more than the {W}-row eviction ring of group "
                               f"{gname!r}: raise wb_ring_rows")
        with cv:
            while not stop.is_set():
                head, tail = heads.get(gname, 0), tails.get(gname, 0)
                skip = W - head % W if head % W + kp > W else 0
                if head + skip + kp - tail <= W:
                    heads[gname] = head + skip + kp
                    spans.setdefault(gname, []).append(skip + kp)
                    return (head + skip) % W
                if tail == head and head % W:
                    # the ring is empty, only the skip does not fit: both
                    # ends move to the next turn of the ring
                    heads[gname] = tails[gname] = -(-head // W) * W
                    continue
                flush_now.set()
                stats["ring_waits"] += 1
                cv.wait(timeout=WAIT_S)
        raise _Stopped

    def gate(gname: str, miss_signs: np.ndarray):
        """The misses whose write-back is in flight: one restore from the
        group's ring, or None."""
        _hits, _tokens, srcs = sign_map.query(miss_signs, salt=salts[gname])
        pos = np.nonzero(srcs >= 0)[0]
        return [(None, srcs[pos], pos)] if len(pos) else None

    def feeder() -> None:
        try:
            seq = 0
            for batch in batches:
                if stop.is_set():
                    return
                if fencing and seq > 0 and (start_step + seq) % snapshot_every == 0:
                    # park before this step's admit: the capture sees the
                    # directory and the servers as step seq - 1 left them
                    fence_done.clear()
                    put(prep_q, _Fence(start_step + seq))
                    while not fence_done.wait(timeout=WAIT_S):
                        if stop.is_set():
                            raise _Stopped
                t0 = time.perf_counter()
                item = tier.prepare_batch(batch, hazard_gate=gate, ring_alloc=ring_alloc, pending_map=sign_map)
                ps_item = ctx._ps_forward(batch)
                if ps_item is not None:
                    ps_refs.append(ps_item[0])
                    item = ctx._with_ps(item[0], item[1], ps_item) + item[2:]
                # the evicted signs are in flight from here: a later admit
                # restores them from their ring rows
                for gname, (ev_signs, k, ring_pos) in item[6].items():
                    sign_map.insert_range(ev_signs[:k], ring_pos, seq, salt=salts[gname])
                restore = item[4]
                if restore:
                    stats["restore_steps"] += 1
                    stats["restored_rows"] += sum(int((dst <= ctx._group(g).rows).sum())
                                                  for g, (_src, dst, _slot) in restore.items())
                lane_s["feeder"] += time.perf_counter() - t0
                put(prep_q, (seq, item, ps_item))
                seq += 1
            put(prep_q, _END)
        except _Stopped:
            pass
        except BaseException as e:  # noqa: BLE001 — the caller raises it
            fail(e)

    # -------------------------------------------------- the stager's lane

    def wait_staged(item) -> None:
        """The dispatch's stream waits for the stager's copies of ``item``,
        whose tensors are then in use on it (not on the stager's stream)."""
        ready = item[8]
        if ready is not None:
            main.wait_event(ready)
            for t in _staged_tensors(item[1:8], []):
                t.record_stream(main)

    def hoist_feed(item):
        """The feed stage of a staged step, on the dispatch's stream, under
        the state lock: K12 for every touched group; its payloads."""
        seq, _inputs, _layout, miss, cold, _restore, ev_aux, ev_meta, _ready = item
        with ctx._state_lock, _dispatch_stream(device, main):
            wait_staged(item)
            stats["feed_leads"][min(seq - dense_done[0], graph.depth - 1)] += 1
            return ctx._apply_feed(miss, cold, ev_aux, ev_meta)

    def stager() -> None:
        try:
            with _lane_stream(device) as stream:
                while True:
                    got = get(prep_q)
                    if got is _END:
                        put(staged_q, _END)
                        return
                    if isinstance(got, _Fence):  # in order, no feed
                        put(staged_q, got)
                        continue
                    seq, (inputs, layout, miss, cold, restore, ev_aux, ev_meta), ps_item = got
                    t0 = time.perf_counter()
                    # a restoring step, or one with PS-tier slots, keeps the in-order path
                    pipelinable = pipelined and not restore and ps_item is None
                    # the hazard sets from the host arrays, before staging
                    hazard = feed_hazard_info(inputs, miss, cold, ev_aux, slot_group) if pipelinable else None
                    with graph.lane("feed"):
                        inputs, miss, cold, ev_aux, restore = ctx._stage(inputs, miss, cold, ev_aux, restore)
                        ready = None
                        if stream is not None:
                            ready = torch.cuda.Event()
                            ready.record(stream)
                    item = (seq, inputs, layout, miss, cold, restore, ev_aux, ev_meta, ready)
                    lane_s["stager"] += time.perf_counter() - t0
                    feed_payloads = None
                    if pipelined:
                        # a stall waits outside the lanes' busy time
                        if not graph.reserve_feed(seq, *(hazard or (None, None)), should_abort=stop.is_set,
                                                  barrier=not pipelinable):
                            raise _Stopped
                        if pipelinable:
                            t0 = time.perf_counter()
                            with graph.lane("feed"):
                                feed_payloads = hoist_feed(item)
                            lane_s["stager"] += time.perf_counter() - t0
                    put(staged_q, item + (feed_payloads, ps_item))
        except _Stopped:
            pass
        except BaseException as e:  # noqa: BLE001
            fail(e)

    # ----------------------------------------------- the write-back's lane

    def release(acc: List) -> None:
        """The landed steps' pending entries out (those of their own step
        only: a later eviction of the same sign stays) and their spans
        freed, in step order."""
        with cv:
            for seq, ev_meta, _payloads, _ev in acc:
                for gname, (ev_signs, k, _ring_pos) in ev_meta.items():
                    sign_map.remove(ev_signs[:k], seq, salt=salts[gname])
                    live = spans.get(gname)
                    if live:
                        tails[gname] = tails.get(gname, 0) + live.pop(0)
            cv.notify_all()
        acc.clear()

    def flush(acc: List, stream) -> None:
        if not acc:
            return
        with graph.lane("psgrad"):
            flush_inner(acc, stream)

    def flush_inner(acc: List, stream) -> None:
        t0 = time.perf_counter()
        hosts = []
        for _seq, ev_meta, payloads, ev in acc:
            if stream is None:
                hosts.append(payloads)
                continue
            stream.wait_event(ev)  # the payloads are written
            host = {}
            for gname in ev_meta:
                p = payloads[gname]
                p.record_stream(stream)
                host[gname] = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                host[gname].copy_(p, non_blocking=True)
            hosts.append(host)
        if stream is not None:
            done = torch.cuda.Event()
            done.record(stream)
            wait_event(done)
        for (_seq, ev_meta, _payloads, _ev), host in zip(acc, hosts):
            tier.write_back(ev_meta, host)
        release(acc)
        stats["flushes"] += 1
        lane_s["write_back"] += time.perf_counter() - t0

    def flush_ps(ps_acc: List, stream) -> None:
        """The PS-tier gradients of the steps in hand: every copy to pinned
        memory issued on the write-back's stream, one wait, then the applies
        in step order. A failed apply aborts the refs after it."""
        if not ps_acc:
            return
        with graph.lane("psgrad"):
            t0 = time.perf_counter()
            hosts = []
            for _tag, _ps_item, gp, _gstep, ev in ps_acc:
                parts = gp if isinstance(gp, tuple) else (gp,)
                if stream is not None:
                    stream.wait_event(ev)  # the step wrote them
                    copies = []
                    for t in parts:
                        t.record_stream(stream)
                        copies.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
                        copies[-1].copy_(t, non_blocking=True)
                    parts = tuple(copies)
                stats["psgrad_bytes"] += sum(t.numel() * t.element_size() for t in parts)
                hosts.append(parts if isinstance(gp, tuple) else parts[0])
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
                wait_event(done)
            applied = 0
            try:
                for (_tag, ps_item, _gp, gstep, _ev), host in zip(ps_acc, hosts):
                    ctx._apply_ps_grads(ps_item, ctx._ps_host(host), journal_step=gstep)
                    applied += 1
            except BaseException:
                for it in ps_acc[applied + 1:]:
                    ctx.worker.abort_gradient(it[1][0])
                raise
            finally:
                stats["psgrad_flushes"] += 1
                stats["psgrad_steps"] += applied
                ps_acc.clear()
            lane_s["write_back"] += time.perf_counter() - t0

    def writeback() -> None:
        acc: List = []
        ps_acc: List = []
        try:
            with _lane_stream(device) as stream:
                while True:
                    if stop.is_set():
                        raise _Stopped
                    try:
                        item = wb_q.get(timeout=WAIT_S)
                    except queue.Empty:
                        # the feeder waits on a full ring: no step can come
                        # until the spans in hand are freed
                        if flush_now.is_set() and acc:
                            flush_now.clear()
                            flush(acc, stream)
                        continue
                    if item is _END:
                        flush(acc, stream)
                        flush_ps(ps_acc, stream)
                        return
                    if isinstance(item, threading.Event):  # a fence's drain marker
                        try:
                            flush(acc, stream)
                            flush_ps(ps_acc, stream)
                        finally:  # answered even when the flush fails: the fence must not wait on it
                            item.set()
                        continue
                    if item[0] == "psgrad":
                        ps_acc.append(item)
                        if len(ps_acc) >= ps_batch:
                            flush_ps(ps_acc, stream)
                        continue
                    acc.append(item)
                    if len(acc) >= flush_steps or flush_now.is_set():
                        flush_now.clear()
                        flush(acc, stream)
        except _Stopped:
            release(acc)
        except BaseException as e:  # noqa: BLE001
            fail(e)
            release(acc)  # a feeder waiting on the ring must not wait on spans no flush will free

    # ----------------------------------------------- the caller's dispatch

    header = None
    label_shape = None
    pack: List = []
    pack_sig: List = [None]

    def step_event() -> Optional[torch.cuda.Event]:
        """An event recorded on the dispatch's stream after the step's work
        (None on the CPU)."""
        if main is None:
            return None
        ev = torch.cuda.Event()
        ev.record(main)
        return ev

    def post_step(seq, inputs, ev_meta, payloads) -> None:
        nonlocal label_shape
        label_shape = tuple(inputs["labels"][0].shape)
        ctx._global_step = start_step + seq + 1
        if ev_meta:
            put(wb_q, (seq, ev_meta, payloads, step_event()))
        if ctx.sparse_cfg.kind == OPTIMIZER_ADAM:
            # the servers' powers move once a step for every cached group
            for grp in ctx._cached_groups:
                tier.router.advance_batch_state(grp)

    def dispatch_one(item) -> None:
        nonlocal header
        seq, inputs, layout, miss, cold, restore, ev_aux, ev_meta, _ready, feed_payloads, ps_item = item
        with graph.lane("dense"), ctx._state_lock:
            wait_staged(item)
            if feed_payloads is not None:  # the feed went ahead from the stager: the dense stage alone
                header, payloads, ps = ctx._dispatch_dense(inputs, layout), feed_payloads, None
                stats["pipelined_feeds"] += 1
            else:
                header, payloads, ps = ctx._dispatch(inputs, layout, miss, cold, restore, ev_aux, ev_meta)
            dense_done[0] = seq + 1
        if pipelined:
            graph.note_dense(seq)
        stats["single_steps"] += 1
        if ps_item is not None:  # ahead of the step's evictions, as the reference queues them
            put(wb_q, ("psgrad", ps_item, ps, start_step + seq, step_event()))
        post_step(seq, inputs, ev_meta, payloads)
        if on_metrics is not None:
            ctx._last_metrics = ctx._parse_header(header.cpu().numpy(), label_shape)
            on_metrics(ctx._last_metrics)

    def flush_pack_single() -> None:
        """A partial pack (a signature change, a restoring step, an idle
        queue or the end) dispatches step by step, in order."""
        while pack:
            dispatch_one(pack.pop(0))

    def dispatch_pack() -> None:
        nonlocal header
        with graph.lane("dense"), ctx._state_lock:
            for it in pack:
                wait_staged(it)
            if pipelined:  # feed-done steps: their dense stages alone
                headers = ctx._dispatch_packed_dense([(it[1], it[2]) for it in pack])
                payloads = [it[9] for it in pack]
                stats["pipelined_feeds"] += len(pack)
            else:
                headers, payloads = ctx._dispatch_packed([(it[1], it[2], it[3], it[4], it[6], it[7])
                                                          for it in pack])
            dense_done[0] = pack[-1][0] + 1
        if pipelined:
            graph.note_dense(pack[-1][0])
        header = headers[-1]  # one header a pack
        stats["packs"] += 1
        stats["packed_steps"] += len(pack)
        for it, p in zip(pack, payloads):
            post_step(it[0], it[1], it[7], p)
        pack.clear()

    def run_fence(gstep: int) -> None:
        """The fence at global step ``gstep``: every earlier step has
        dispatched (the marker rode the queues behind it); the window, the
        write-back, the ring and the pending map drained, the capture, the
        callback; the feeder unparked. Its ms by part go to ``fence_ms``."""
        t0 = time.perf_counter()
        flush_pack_single()
        graph.drain_for_fence(gstep)
        t1 = time.perf_counter()
        drained = threading.Event()  # set by the write-back once every earlier eviction has landed
        put(wb_q, drained)
        while not drained.wait(timeout=WAIT_S):
            if stop.is_set():
                raise _Stopped
        t2 = time.perf_counter()
        with cv:
            rings = {g: {"head": heads.get(g, 0), "tail": tails.get(g, 0), "rows": ctx.ring_rows(g)}
                     for g in sorted(set(heads) | set(tails))}
            undrained = {g: (r["head"], r["tail"]) for g, r in rings.items() if r["head"] != r["tail"]}
            pending = len(sign_map)
            occupancy = {"resident_rows": {g.name: len(tier.dirs[g.name]) for g in tier.groups}, "ring": rings,
                         "pending_ledger_entries": pending}
            if tier.feed_shards is not None:  # a skewed shard: the salt fights the key distribution
                occupancy["feeder_shards"] = tier.feeder_shard_stats()
        if stop.is_set():
            raise _Stopped  # the write-back failed: its error ends the stream
        if undrained or pending:
            raise RuntimeError(f"fence at step {gstep}: after the write-back drain the eviction rings of groups "
                               f"{sorted(undrained)} still hold spans (head, tail) {undrained} and the pending map "
                               f"{pending} entries")
        ms = {"drain": (t1 - t0) * 1e3, "wb_drain": (t2 - t1) * 1e3}
        if job_mgr is not None:
            with ctx._state_lock:
                ctx._fence_capture(job_mgr, gstep, occupancy)
            ms.update(ctx.last_capture_ms)
        ms["total"] = (time.perf_counter() - t0) * 1e3
        stats["fences"] += 1
        stats["fence_ms"].append(ms)
        if fence_callback is not None:
            try:
                fence_callback(gstep)
            except Exception as e:  # noqa: BLE001 — the fence itself held: the stream goes on
                stats["fence_callback_errors"] += 1
                logger.warning("fence callback failed at step %d (the stream goes on): %r", gstep, e)
        fence_done.set()

    def shapes(d):
        return tuple(sorted((k, tuple(tuple(x.shape) for x in v) if isinstance(v, tuple) else tuple(v.shape))
                            for k, v in d.items()))

    def dense_signature(item):
        """A step's dense stage's shape signature: the model's inputs alone
        (a feed-done step's pack holds no aux)."""
        inputs, layout = item[1], item[2]
        return (layout, shapes(inputs["stacked_rows"]), shapes(inputs["raw_rows"]), "stacked_scale" in inputs,
                tuple(tuple(x.shape) for x in inputs["labels"]))

    def signature(item):
        """A step's shape signature: a pack's steps share one."""
        _seq, _inputs, _layout, miss, cold, _restore, ev_aux, ev_meta, _ready, _feed, _ps = item
        return dense_signature(item) + (shapes(miss), shapes(cold), shapes(ev_aux),
                                        tuple(sorted((g, m[2] >= 0) for g, m in ev_meta.items())))

    threads = [threading.Thread(target=feeder, name="cache-feeder", daemon=True),
               threading.Thread(target=stager, name="cache-stager", daemon=True),
               threading.Thread(target=writeback, name="cache-writeback", daemon=True)]
    for t in threads:
        t.start()
    try:
        with _dispatch_stream(device, main):
            while True:
                if pack:
                    try:
                        item = get(staged_q, timeout=PACK_IDLE_S)
                    except queue.Empty:
                        # never hold a partial pack while the queue idles: the
                        # feeder may be waiting on spans these steps free
                        t0 = time.perf_counter()
                        flush_pack_single()
                        lane_s["dispatch"] += time.perf_counter() - t0
                        continue
                else:
                    item = get(staged_q)
                t0 = time.perf_counter()
                if isinstance(item, _Fence):
                    run_fence(item.step)
                    lane_s["dispatch"] += time.perf_counter() - t0
                    continue
                if item is _END:
                    flush_pack_single()
                    # every feed's dense stage has dispatched: the window is empty
                    graph.drain_for_fence(stats["single_steps"] + stats["packed_steps"], reason="end")
                    lane_s["dispatch"] += time.perf_counter() - t0
                    break
                # feed-done steps pack by their dense signature; in order,
                # restore-free steps by their whole signature
                packable = item[9] is not None if pipelined else not item[5] and item[10] is None
                if K_eff > 1 and packable:
                    sig = dense_signature(item) if pipelined else signature(item)
                    if pack and sig != pack_sig[0]:
                        flush_pack_single()
                    if not pack:
                        pack_sig[0] = sig
                    pack.append(item)
                    if len(pack) == K_eff:
                        dispatch_pack()
                else:
                    flush_pack_single()  # a restore never overtakes the steps before it
                    dispatch_one(item)
                lane_s["dispatch"] += time.perf_counter() - t0
            put(wb_q, _END)
            while threads[2].is_alive():
                threads[2].join(timeout=WAIT_S)
                if stop.is_set():
                    break
    except _Stopped:
        pass
    except BaseException as e:  # noqa: BLE001
        fail(e)
    finally:
        stop.set()
        graph.abort()  # a stager parked in reserve_feed wakes
        flush_now.set()
        with cv:
            cv.notify_all()
        deadline = time.perf_counter() + JOIN_S
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        for ref in ps_refs:  # a no-op for every applied ref
            ctx.worker.abort_gradient(ref)
        stats["wall_s"] = time.perf_counter() - t_start
        stats["resident_rows"] = {g.name: len(tier.dirs[g.name]) for g in tier.groups}
        stats["tiers"] = {"cached_slots": sorted(s for g in tier.groups for s in g.slots),
                          "ps_slots": sorted(tier.ps_slots), "resident_rows": stats["resident_rows"],
                          "capacity_rows": {g.name: g.rows for g in tier.groups}}
        if tier.feed_shards is not None:
            stats["feeder"] = {"feed_threads": tier.feed_threads, "feed_shards": tier.feed_shards,
                               "shards": tier.feeder_shard_stats()}
        stats.update(graph.stats(stats["wall_s"]))
        ctx._stream_stats = stats
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise RuntimeError(f"the stream's lanes {alive} were still running {JOIN_S:g} s after it stopped"
                           ) from (errors[0] if errors else None)
    if errors:
        raise errors[0]
    if header is None:
        return ctx._last_metrics
    if on_metrics is not None or fetch_final:
        if on_metrics is None:
            ctx._last_metrics = ctx._parse_header(header.cpu().numpy(), label_shape)
        ctx._last_header_dev = None
        return ctx._last_metrics
    if main is not None:  # the last step done, nothing read back
        done = torch.cuda.Event()
        done.record(main)
        while not done.query():
            time.sleep(1e-4)
    ctx._last_header_dev = (header, label_shape)
    return None


@contextmanager
def _dispatch_stream(device: torch.device, main):
    """The dispatch's device and stream: the caller's current stream."""
    if main is None:
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(main):
        yield
