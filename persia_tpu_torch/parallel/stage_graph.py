"""The in-flight window of a stage-pipelined stream (counterpart of the part
of ``persia_tpu/parallel/stage_graph.py`` that ``FusedPipeline`` uses).

A pipelined step has a FEED stage (host conversion and host→device
staging) and a DENSE stage (the step on the card). The window holds one
entry per step whose feed has dispatched and whose dense stage has not;
its length is bounded by ``depth``, so a feed runs at most ``depth - 1``
steps ahead of its own dense stage. The feed thread appends through
``reserve_feed``, the dense thread retires through ``note_dense``; a fence
(``drain_for_fence``) asserts the window empty. ``lane`` times each
stage's busy seconds for ``stats``.

In the fused tier every row lives on the card and the step holds the
sparse update, so no feed touches a row a dense stage trains: the window
only bounds the staged batches, and is the pipeline's one bound on them.
The reference's hazard ledger (feed and trained row sets, stalls on a
conflict, barrier entries, rebuild hooks) and its third lane (the host
PS's gradient stage) serve the hybrid and cached tiers' pipelined streams
and are not ported yet; nor are its metrics and trace events.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, Optional

#: stage lanes of the fused step, in dataflow order
STAGES = ("feed", "dense")


class StageGraph:
    """In-flight window and per-lane busy time of a pipelined stream."""

    def __init__(self, depth: int, clock=time.perf_counter):
        self.depth = max(1, int(depth))
        self._clock = clock
        # guards the window, the lane accounting and the abort flag
        self._pipe_cv = threading.Condition()
        self._window: "deque[int]" = deque()
        self._aborted = False
        self.drains = 0
        self._lane_busy: Dict[str, float] = {s: 0.0 for s in STAGES}

    def reserve_feed(self, seq: int, should_abort: Optional[Callable[[], bool]] = None) -> bool:
        """Block until step ``seq`` may enter the window, then append it.
        Returns False when aborted: the caller unwinds without staging.
        (The reference's row-set arguments feed its hazard ledger, which
        is not ported.)"""
        with self._pipe_cv:
            while True:
                if self._aborted or (should_abort is not None and should_abort()):
                    return False
                if len(self._window) < self.depth:
                    self._window.append(seq)
                    return True
                self._pipe_cv.wait(timeout=0.05)

    def note_dense(self, seq: int) -> None:
        """Retire every entry up to and including ``seq``: its dense stage
        (single or packed) has dispatched."""
        with self._pipe_cv:
            while self._window and self._window[0] <= seq:
                self._window.popleft()
            self._pipe_cv.notify_all()

    def abort(self) -> None:
        with self._pipe_cv:
            self._aborted = True
            self._pipe_cv.notify_all()

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
            "pipeline_drains": self.drains,
            "stage_wall_s": {k: round(v, 6) for k, v in busy.items()},
            "stage_overlap_frac": round(overlap, 6),
        }
