"""The pipelined host feeder (counterpart of ``persia_tpu/data_loader.py``):
prefetch, bounded staleness, reorder, and the background gradient return.

A feed thread numbers the batches; in ``reproducible`` mode a reorder
thread emits them in batch-id order with a ticket each. ``num_workers``
lookup threads take a staleness permit, look the batch up
(``put_forward_ids`` → ``forward_batch_id``) and stage it
(``ctx.prepare_features``); the consumer trains on it
(``TrainCtx.train_step_prepared``) and hands its gradients to the
``BackwardEngine``, whose thread applies them
(``worker.update_gradient_batched``) and returns the permit. So the
lookup of batch N+k overlaps the device step of batch N, at most
``staleness`` batches ahead of their gradients.

The threads overlap because the native worker and store cores release the
GIL. On the card, each lookup thread stages on a CUDA stream of its own,
from pinned host memory, and records an event in the
``PersiaTrainingBatch``; the consumer's stream waits on it. The CPU path
takes no stream.
"""

from __future__ import annotations

import heapq
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from persia_tpu_torch.data import PersiaBatch
from persia_tpu_torch.parallel.train_step import unpack_step_grads

_SENTINEL = object()
# bound of each queue between the pipeline's threads, and the reorder
# window of a gapped batch-id stream
_QUEUE_SIZE = 8
_GRADIENT_THREADS = 2


@dataclass
class PersiaTrainingBatch:
    """What the loader yields: a batch looked up and staged."""

    ref: int
    batch: PersiaBatch
    emb_batches: List
    device_batch: Dict
    counts: List
    batch_id: Optional[int] = None
    ticket: Optional[int] = None  # reorder emit sequence (reproducible mode)
    # recorded on the staging stream after the batch's host→device copies
    # (None on the CPU)
    ready: Optional[torch.cuda.Event] = None


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class BackwardEngine:
    """Asynchronous gradient return.

    ``push`` queues ``(ref, slot_grads, scale, journal_id)``; a worker
    thread applies ``worker.update_gradient_batched`` (through the PS
    apply-journal when ``journal_id`` is given) and releases the staleness
    permit.
    ``slot_grads`` may be a zero-argument callable that produces the per-slot
    gradients, so the device→host copy is waited for on this thread. An
    error aborts the batch's gradient (releasing its staleness slot) and is
    raised by the next ``push`` or ``flush``."""

    def __init__(self, emb_worker, release_permit: Callable[[], None]):
        self._worker = emb_worker
        self._release = release_permit
        # unbounded: the staleness permits bound what is pushed
        self._q: "queue.Queue" = queue.Queue()
        self._pending = 0
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._error: Optional[BaseException] = None
        self._threads = [
            threading.Thread(target=self._run, daemon=True, name=f"backward-{i}")
            for i in range(_GRADIENT_THREADS)
        ]
        for t in self._threads:
            t.start()

    @property
    def pending(self) -> int:
        """Gradient batches pushed and not yet applied."""
        with self._lock:
            return self._pending

    def push(self, ref: int, slot_grads, scale_factor: float = 1.0,
             journal_id: Optional[int] = None) -> None:
        with self._lock:
            if self._error is not None:
                raise RuntimeError("backward engine failed") from self._error
            self._pending += 1
        self._q.put((ref, slot_grads, scale_factor, journal_id))

    def _run(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            ref, slot_grads, scale, journal_id = item
            try:
                if callable(slot_grads):
                    slot_grads = slot_grads()
                # an un-journaled apply passes no journal id at all, as the
                # reference's engine does
                extra = {} if journal_id is None else {"journal_id": journal_id}
                self._worker.update_gradient_batched(ref, slot_grads, scale_factor=scale, **extra)
            except BaseException as e:  # noqa: BLE001 — raised to the trainer by flush/push
                self._worker.abort_gradient(ref)
                with self._lock:
                    self._error = e
            finally:
                self._release()
                with self._lock:
                    self._pending -= 1
                    self._done.notify_all()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every pushed gradient is applied; raise the first
        error an apply met."""
        with self._lock:
            if not self._done.wait_for(lambda: self._pending == 0, timeout=timeout):
                raise TimeoutError("backward engine flush timed out")
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("backward engine failed") from err

    def shutdown(self):
        for _ in self._threads:
            self._q.put(_SENTINEL)
        for t in self._threads:
            t.join(timeout=5)


class BatchCursor:
    """The loader cursor a job-state manifest records: wraps a batch
    iterable, counts what it hands out, and skips the batches a crashed run
    already consumed. Skipping happens here, before any lookup or staging;
    a source that yields the same batch at the same ordinal every run (what
    a bit-identical resume needs) resumes where the fence left it."""

    def __init__(self, batches: Iterable[PersiaBatch], skip: int = 0):
        self._batches = batches
        self.skip = int(skip)
        self.consumed = int(skip)  # the ordinal of the next batch handed out

    def __iter__(self) -> Iterator[PersiaBatch]:
        it = iter(self._batches)
        for _ in range(self.skip):
            next(it, None)
        for b in it:
            yield b
            self.consumed += 1

    def state(self) -> Dict:
        return {"consumed_batches": self.consumed}


class _Permits:
    """Counting semaphore whose free permits can be read."""

    def __init__(self, permits: int):
        self._cv = threading.Condition()
        self._permits = permits

    def acquire(self, ticket: Optional[int] = None) -> None:
        with self._cv:
            while self._permits <= 0:
                self._cv.wait()
            self._permits -= 1

    def release(self) -> None:
        with self._cv:
            self._permits += 1
            self._cv.notify_all()

    @property
    def available(self) -> int:
        with self._cv:
            return self._permits


class _OrderedSemaphore(_Permits):
    """Staleness permits granted in TICKET order: in reproducible mode the
    PS sees lookups in batch order whichever of the N workers asks first."""

    def __init__(self, permits: int):
        super().__init__(permits)
        self._next = 0

    def acquire(self, ticket: Optional[int] = None) -> None:
        with self._cv:
            while ticket != self._next or self._permits <= 0:
                self._cv.wait()
            self._permits -= 1
            self._next += 1
            self._cv.notify_all()


class DataLoader:
    """Pipelined iterator over a ``PersiaBatch`` source.

    - ``staleness``: most batches past lookup whose gradients have not
      returned. The ``BackwardEngine`` returns a permit after the update
      lands; ``mark_consumed`` returns one for a batch that trains no
      gradient (eval) or whose step failed.
    - ``reproducible``: batches are looked up and yielded strictly in
      batch-id order; with ``staleness=1`` the results are bit-identical
      for any ``num_workers``.
    - ``num_workers``: concurrent lookup threads.
    """

    def __init__(
        self,
        dataset: Iterable[PersiaBatch],
        ctx,
        num_workers: int = 3,
        staleness: int = 4,
        reproducible: bool = False,
        timeout_s: float = 120.0,
    ):
        if staleness < 1:
            raise ValueError("staleness must be >= 1")
        self.dataset = dataset
        self.ctx = ctx
        self.num_workers = max(1, num_workers)
        self.staleness = staleness
        self.reproducible = reproducible
        self.timeout_s = timeout_s
        self.staleness_sem = _OrderedSemaphore(staleness) if reproducible else _Permits(staleness)
        self.backward_engine = BackwardEngine(ctx.worker, release_permit=self.staleness_sem.release)
        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------- pipeline

    def _feed(self, in_q: "queue.Queue"):
        try:
            next_id = 0
            for batch in self.dataset:
                if batch.batch_id is None:
                    batch.batch_id = next_id
                next_id = batch.batch_id + 1
                in_q.put(batch)
        except BaseException as e:  # noqa: BLE001 — raised to the consumer
            in_q.put(_WorkerError(e))
        finally:
            in_q.put(_SENTINEL)

    def _reorder(self, in_q: "queue.Queue", out_q: "queue.Queue"):
        """Emit ``(ticket, batch)`` in ascending batch id: contiguous ids at
        once, gapped ids (a strided multi-trainer feed) through a look-ahead
        window of ``_QUEUE_SIZE`` batches."""
        heap: List = []
        expect: Optional[int] = None
        seq = 0  # tiebreak: duplicate batch ids must not compare batches
        ticket = 0
        try:
            while True:
                item = in_q.get()
                if item is _SENTINEL or isinstance(item, _WorkerError):
                    for _, _, b in sorted(heap):
                        out_q.put((ticket, b))
                        ticket += 1
                    out_q.put(item)
                    return
                heapq.heappush(heap, (item.batch_id, seq, item))
                seq += 1
                if expect is None:
                    expect = heap[0][0]
                while heap and (heap[0][0] <= expect or len(heap) > _QUEUE_SIZE):
                    bid, _, b = heapq.heappop(heap)
                    out_q.put((ticket, b))
                    ticket += 1
                    expect = bid + 1
        except BaseException as e:  # noqa: BLE001 — raised to the consumer
            out_q.put(_WorkerError(e))

    def _lookup_worker(self, in_q: "queue.Queue", out_q: "queue.Queue"):
        dev = self.ctx.device
        stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        while True:
            item = in_q.get()
            if item is _SENTINEL or isinstance(item, _WorkerError):
                in_q.put(item)  # let the sibling workers see it too
                out_q.put(item)
                return
            ticket, batch = item if self.reproducible else (None, item)
            # the try must follow the acquire at once: anything raising in
            # between would leak the permit and wedge the window
            self.staleness_sem.acquire(ticket)
            try:
                out_q.put(self._lookup_and_stage(batch, ticket, stream))
            except BaseException as e:  # noqa: BLE001 — raised to the consumer
                self.staleness_sem.release()
                out_q.put(_WorkerError(e))
                return

    def _lookup_and_stage(self, batch: PersiaBatch, ticket, stream) -> PersiaTrainingBatch:
        worker = self.ctx.worker
        train = batch.requires_grad
        ref = worker.put_forward_ids(batch)
        emb_batches = worker.forward_batch_id(ref, train=train)
        try:
            if stream is None:
                device_batch, counts = self.ctx.prepare_features(batch, emb_batches, csr=train)
                ready = None
            else:
                with torch.cuda.stream(stream):
                    device_batch, counts = self.ctx.prepare_features(
                        batch, emb_batches, csr=train, non_blocking=True
                    )
                    ready = torch.cuda.Event()
                    ready.record(stream)
        except BaseException:
            if train:
                worker.abort_gradient(ref)
            raise
        return PersiaTrainingBatch(ref=ref, batch=batch, emb_batches=emb_batches,
                                   device_batch=device_batch, counts=counts,
                                   batch_id=batch.batch_id, ticket=ticket, ready=ready)

    # ------------------------------------------------------------- consumer

    def __iter__(self) -> Iterator[PersiaTrainingBatch]:
        in_q: "queue.Queue" = queue.Queue(maxsize=_QUEUE_SIZE)
        staged_q: "queue.Queue" = queue.Queue(maxsize=_QUEUE_SIZE)
        self._threads = [threading.Thread(target=self._feed, args=(in_q,), daemon=True)]
        lookup_in = in_q
        if self.reproducible:
            lookup_in = queue.Queue(maxsize=_QUEUE_SIZE)
            self._threads.append(
                threading.Thread(target=self._reorder, args=(in_q, lookup_in), daemon=True)
            )
        for i in range(self.num_workers):
            self._threads.append(threading.Thread(
                target=self._lookup_worker, args=(lookup_in, staged_q), daemon=True,
                name=f"lookup-{i}",
            ))
        for t in self._threads:
            t.start()

        finished = 0
        emit_heap: List = []
        expect = 0  # next ticket to yield (reproducible mode)
        try:
            while True:
                try:
                    item = staged_q.get(timeout=self.timeout_s)
                except queue.Empty:
                    raise TimeoutError(
                        f"no staged batch within {self.timeout_s}s (staleness deadlock? "
                        "a batch neither trained nor passed to mark_consumed?)"
                    ) from None
                if isinstance(item, _WorkerError):
                    raise RuntimeError("data pipeline worker failed") from item.exc
                if item is _SENTINEL:
                    finished += 1
                    if finished >= self.num_workers:
                        for _, _, tb in sorted(emit_heap, key=lambda x: x[:2]):
                            yield tb
                        return
                    continue
                if self.reproducible:
                    heapq.heappush(emit_heap, (item.ticket, item.ref, item))
                    while emit_heap and emit_heap[0][0] == expect:
                        yield heapq.heappop(emit_heap)[2]
                        expect += 1
                else:
                    yield item
        finally:
            self.backward_engine.flush(timeout=self.timeout_s)

    # --------------------------------------------------------------- grads

    def backward_packed(self, training_batch: PersiaTrainingBatch, gpacked,
                        scale_factor: float = 1.0, journal_id: Optional[int] = None) -> None:
        """Queue a step's packed embedding gradients for asynchronous
        return. ``gpacked`` is a zero-argument callable returning their host
        f32 copy (it may wait for a device→host copy) or such an array; the
        engine thread splits it per slot. ``journal_id`` tags the apply for
        the PS apply-journal."""

        def slot_grads():
            packed = gpacked() if callable(gpacked) else np.asarray(gpacked, dtype=np.float32)
            emb_grads = unpack_step_grads(packed, training_batch.device_batch)
            return self.ctx.emb_grads_to_slot_grads(
                training_batch.emb_batches, emb_grads, training_batch.counts
            )

        self.backward_engine.push(training_batch.ref, slot_grads, scale_factor, journal_id)

    def mark_consumed(self, training_batch: PersiaTrainingBatch) -> None:
        """Return the staleness permit of a batch that sends no gradient (an
        eval batch, or one whose step failed), dropping its buffered ids."""
        if training_batch.batch.requires_grad:
            self.ctx.worker.abort_gradient(training_batch.ref)
        self.staleness_sem.release()

    def flush(self):
        """Wait until every queued gradient is applied."""
        self.backward_engine.flush(timeout=self.timeout_s)

    def staleness_state(self) -> Dict:
        """The staleness window: gradient batches still to apply, and free
        permits (``staleness`` of them after ``flush`` with nothing in
        flight)."""
        return {"outstanding_gradient_batches": self.backward_engine.pending,
                "free_permits": self.staleness_sem.available,
                "staleness": self.staleness}

    def shutdown(self):
        self.backward_engine.shutdown()
