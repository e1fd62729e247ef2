"""The stage graph of a pipelined stream (counterpart of
``persia_tpu/parallel/stage_graph.py``): its in-flight window, its hazard
ledger and each lane's busy time.

A pipelined step has a FEED stage (in the cache tier: K12, which admits
the missed rows and reads the eviction payloads; in the fused tier: host
conversion and staging), a DENSE stage (the step on the card; a packed
window of K steps is one dense stage) and, in the cache tier, a PSGRAD
lane (the eviction write-back's copy to the host). The window holds one
entry per step whose feed has dispatched and whose dense stage has not;
its length is bounded by ``depth``, so a feed runs at most ``depth - 1``
steps ahead of its own dense stage. The feed thread appends through
``reserve_feed``, the dense thread retires through ``note_dense``; a fence
or the stream's end (``drain_for_fence``) asserts the window empty.

**Why hoisting a feed changes no bit.** A cache-tier feed touches exactly
the rows its step's admit assigned (the evicted rows it reads, the warm
and cold rows it writes); a dense stage touches exactly the rows its step
trains (gathers and the sparse update). Ops over disjoint rows of one pool
commute bit for bit, so a feed may run before earlier steps' dense stages
while its rows are disjoint from every in-flight entry's trained rows
(``feed_hazard_info`` computes both sets on the host). ``reserve_feed``
stalls a feed that collides until the dense stages in its way retire
(``stalls`` counts the stalled feeds). A step that the ledger already
orders (a restore from the eviction ring) enters the window as a barrier,
which every later feed waits behind.

In the fused tier every row lives on the card and the step holds the
sparse update, so no feed touches a row a dense stage trains: its window
only bounds the staged batches (``reserve_feed`` without row sets).
``on_rebuild``/``rebuild`` are the fence-point hooks a tier migration
fires. The reference's metrics counters and trace events are not ported:
stalls and drains are plain counts, read through ``stats``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

#: stage lanes of a pipelined step, in dataflow order
STAGES = ("feed", "dense", "psgrad")


def _rows_intersect(sorted_rows: np.ndarray, probe: np.ndarray) -> bool:
    """True when any value of ``probe`` occurs in ``sorted_rows``."""
    if sorted_rows.size == 0 or probe.size == 0:
        return False
    idx = np.searchsorted(sorted_rows, probe)
    np.minimum(idx, sorted_rows.size - 1, out=idx)
    return bool(np.any(sorted_rows[idx] == probe))


def feed_hazard_info(inputs: Dict, miss_aux: Dict, cold_aux: Dict, evict_aux: Dict,
                     slot_group: Dict[str, str]) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The hazard sets of one prepared cache-tier step, from its host
    arrays (before staging): ``(feed_rows, trained_rows)`` by group. The
    feed's rows are the evicted rows it reads and the warm and cold rows
    it writes (``evict_aux`` {group: (rows, unclaimed slots)},
    ``miss_aux`` / ``cold_aux`` {group: (rows, ...)}); the dense
    stage's are the *sorted* rows it gathers and updates (the stacked and
    raw rows; ``slot_group`` maps a raw slot to its group). Pads ride
    along in both, as in the reference."""
    feed: Dict[str, np.ndarray] = {}
    for gname in set(miss_aux) | set(cold_aux) | set(evict_aux):
        parts: List[np.ndarray] = []
        for aux in (evict_aux, miss_aux, cold_aux):
            got = aux.get(gname)
            if got is not None and np.size(got[0]):
                parts.append(np.asarray(got[0], dtype=np.int64).ravel())
        if parts:
            feed[gname] = np.concatenate(parts)
    by_group: Dict[str, List[np.ndarray]] = {}
    for gname, rows in inputs["stacked_rows"].items():
        by_group.setdefault(gname, []).append(np.asarray(rows, dtype=np.int64).ravel())
    for slot, rows in inputs.get("raw_rows", {}).items():
        by_group.setdefault(slot_group[slot], []).append(np.asarray(rows, dtype=np.int64).ravel())
    trained = {gname: np.sort(np.concatenate(parts) if len(parts) > 1 else parts[0])
               for gname, parts in by_group.items()}
    return feed, trained


class StageGraph:
    """In-flight window, hazard ledger and per-lane busy time of a
    pipelined stream."""

    def __init__(self, depth: int, clock=time.perf_counter):
        self.depth = max(1, int(depth))
        self._clock = clock
        # guards the window, the lane accounting and the abort flag
        self._pipe_cv = threading.Condition()
        # (seq, trained rows by group, or None for a barrier)
        self._window: "deque[Tuple[int, Optional[Dict[str, np.ndarray]]]]" = deque()
        self._aborted = False
        self.stalls = 0
        self.drains = 0
        self._lane_busy: Dict[str, float] = {s: 0.0 for s in STAGES}
        self._rebuild_hooks: List[Callable[[int], None]] = []

    # ----------------------------------------------------------- window

    def reserve_feed(self, seq: int, feed_rows: Optional[Dict[str, np.ndarray]] = None,
                     trained_rows: Optional[Dict[str, np.ndarray]] = None,
                     should_abort: Optional[Callable[[], bool]] = None, barrier: bool = False) -> bool:
        """Block until step ``seq`` may enter the window, then append it. A
        feed (``barrier=False``) also waits until ``feed_rows`` is disjoint
        from every in-flight entry's trained rows, and behind any barrier;
        a barrier waits only for room, and every later feed waits behind
        it. Each wait takes 0.05 s, then looks at ``should_abort``. Returns
        False when aborted: the caller unwinds without dispatching."""
        stalled = False
        with self._pipe_cv:
            while True:
                if self._aborted or (should_abort is not None and should_abort()):
                    return False
                if len(self._window) < self.depth:
                    if barrier or not self._conflict(feed_rows):
                        self._window.append((seq, None if barrier else (trained_rows or {})))
                        return True
                    if not stalled:  # counted once a stalled feed, not once a retry
                        stalled = True
                        self.stalls += 1
                self._pipe_cv.wait(timeout=0.05)

    def _conflict(self, feed_rows) -> Optional[str]:
        """What a feed waits behind: "barrier", a group whose rows collide,
        or None."""
        for _seq, trained in self._window:
            if trained is None:
                return "barrier"
            for gname, probe in (feed_rows or {}).items():
                srt = trained.get(gname)
                if srt is not None and _rows_intersect(srt, probe):
                    return gname
        return None

    def note_dense(self, seq: int) -> None:
        """Retire every entry up to and including ``seq``: its dense stage
        (single or packed) has dispatched."""
        with self._pipe_cv:
            while self._window and self._window[0][0] <= seq:
                self._window.popleft()
            self._pipe_cv.notify_all()

    def abort(self) -> None:
        with self._pipe_cv:
            self._aborted = True
            self._pipe_cv.notify_all()

    # ----------------------------------------------------- fences/rebuild

    def drain_for_fence(self, step: int, reason: str = "fence") -> None:
        """Assert the window empty and count the drain; raises while a feed
        is still in flight ahead of its dense stage."""
        with self._pipe_cv:
            n = len(self._window)
        if n:
            raise RuntimeError(
                f"pipeline drain at step {step} ({reason}): {n} feed stage(s) still in flight "
                "ahead of their dense stages"
            )
        self.drains += 1

    def on_rebuild(self, fn: Callable[[int], None]) -> None:
        self._rebuild_hooks.append(fn)

    def rebuild(self, step: int) -> None:
        """Run the registered hooks with ``step``: a fence fires it, with
        the window drained, after a tier migration re-registered groups."""
        for fn in list(self._rebuild_hooks):
            fn(step)

    # ------------------------------------------------------------- lanes

    @contextmanager
    def lane(self, stage: str):
        """Time one occupancy of a stage lane."""
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            with self._pipe_cv:
                self._lane_busy[stage] = self._lane_busy.get(stage, 0.0) + dt

    def stats(self, wall_s: float) -> Dict:
        """``stage_overlap_frac`` is the share of lane-busy time hidden
        under other lanes, ``max(0, (sum(busy) - wall) / sum(busy))``."""
        with self._pipe_cv:
            busy = dict(self._lane_busy)
        total = sum(busy.values())
        overlap = max(0.0, (total - wall_s) / total) if total > 0.0 else 0.0
        return {
            "pipeline_depth": self.depth,
            "pipeline_stalls": self.stalls,
            "pipeline_drains": self.drains,
            "stage_wall_s": {k: round(v, 6) for k, v in busy.items()},
            "stage_overlap_frac": round(overlap, 6),
        }
