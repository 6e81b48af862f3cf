"""Dynamic request batching (the port's copy of
``seervideoldm_tpu/serving/batcher.py``).

Requests that arrive together are grouped into one batch: the worker
blocks on the first request, then drains the queue until ``max_batch``
requests are collected or ``max_wait_ms`` elapses, and hands the group to
one handler call.  Under load a request rides a full batch; an idle server
still serves a lone request within ``max_wait_ms``.  The handler runs on
the batcher's one worker thread.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Any, Callable, Sequence


class BatcherOverloaded(RuntimeError):
    """Raised by submit() when the admission queue is full — callers should
    shed the request (HTTP 503) rather than let it pile up: a queued request
    still costs a full sampling slot even if its client has given up."""


class DynamicBatcher:
    """Single-worker batcher: ``submit()`` returns a Future; one worker
    thread forms batches and runs ``handler(items) -> results`` (results
    aligned with items).  The queue is bounded (``max_queue``, default
    4×max_batch): under overload submit() raises ``BatcherOverloaded``
    immediately instead of growing an unbounded backlog of work whose
    clients will have timed out by the time it runs."""

    def __init__(self, handler: Callable[[Sequence[Any]], Sequence[Any]],
                 max_batch: int, max_wait_ms: float = 50.0,
                 max_queue: int | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue is not None and max_queue < 1:
            # 0 would silently become the default and negatives would make
            # an UNBOUNDED stdlib queue — the exact hole the bound closes
            raise ValueError("max_queue must be >= 1 (or None for default)")
        self._handler = handler
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue(
            maxsize=max_queue if max_queue is not None else 4 * max_batch)
        self._thread: threading.Thread | None = None
        # guards the start/stop/submit lifecycle: without it a submit that
        # passed the liveness check could enqueue into a just-drained queue
        # and its Future would never resolve
        self._lifecycle = threading.Lock()
        # telemetry: batch-size distribution is the signal for tuning
        # max_batch/max_wait against real traffic
        self.batches = 0
        self.requests = 0

    def start(self) -> "DynamicBatcher":
        with self._lifecycle:
            if self._thread is not None:
                raise RuntimeError("batcher already started")
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="dynamic-batcher")
            self._thread.start()
        return self

    def stop(self) -> None:
        # flip the liveness marker under the lock (submit now fails fast),
        # but do the blocking put/join OUTSIDE it — holding the lock across
        # a full-queue put + a backlog-draining join would hang every
        # concurrent submit() on the lock instead of erroring immediately
        with self._lifecycle:
            worker = self._thread
            if worker is None:
                return
            self._thread = None
        self._q.put(None)  # blocking put: the sentinel must get through
        worker.join()
        # FIFO + the lock guarantee nothing can follow the sentinel; the
        # worker drained every request enqueued before it
        assert self._q.empty(), "requests enqueued after the stop sentinel"

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        with self._lifecycle:
            if self._thread is None:
                raise RuntimeError("batcher not started")
            try:
                self._q.put_nowait((item, fut))
            except queue.Full:
                raise BatcherOverloaded(
                    f"queue full ({self._q.maxsize} pending)") from None
        return fut

    def _run(self) -> None:
        import time

        while True:
            head = self._q.get()
            if head is None:
                return
            group = [head]
            deadline = time.monotonic() + self.max_wait_s
            while len(group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)  # re-post the sentinel for after this batch
                    break
                group.append(nxt)
            items = [it for it, _ in group]
            futures = [f for _, f in group]
            try:
                results = self._handler(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"handler returned {len(results)} results for "
                        f"{len(items)} requests"
                    )
            except Exception as exc:  # noqa: BLE001 — propagate to callers
                for f in futures:
                    f.set_exception(exc)
                continue
            self.batches += 1
            self.requests += len(items)
            for f, r in zip(futures, results):
                f.set_result(r)
