"""Concurrency toolkit — the accelerator-correct rewrite of reference src/concurrent.rs.

The reference's toolkit (DashMap wrappers, MPMC queues, rayon work stealing) is
intra-node CPU parallelism. On an accelerator the analog is *micro-batching*: concurrent
single-query requests are packed into one fixed-shape device batch, executed in
a single kernel launch, and the results fanned back out. ``BatchingExecutor``
is that component (SURVEY.md §2.2 "Concurrency toolkit" row: 'the accelerator analog of
all of this is the batching executor').

``AtomicCounters`` mirrors concurrent.rs:183-286; ``ConcurrentBatchProcessor``
mirrors concurrent.rs:376-451 for host-side CPU work (thread-pool batcher).
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generic, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

__all__ = ["AtomicCounters", "BatchingExecutor", "ConcurrentBatchProcessor"]

T = TypeVar("T")
R = TypeVar("R")


class AtomicCounters:
    """concurrent.rs:183-286: ops/success/fail/cache/index/search counters."""

    _FIELDS = (
        "total_ops", "successful_ops", "failed_ops",
        "cache_hits", "cache_misses", "index_ops", "search_ops",
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._vals = {f: 0 for f in self._FIELDS}

    def increment(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._vals[name] = self._vals.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._vals.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._vals)


@dataclass
class _Pending:
    query: np.ndarray
    k: int
    future: "concurrent.futures.Future[Any]"


class BatchingExecutor:
    """Packs concurrent vector queries into one device batch.

    submit(query, k) returns a Future. A background collector drains the queue:
    it waits up to ``max_wait_ms`` for up to ``max_batch`` requests (grouping by
    k), stacks them into one [B, dim] batch, runs ``search_batch_fn`` once, and
    resolves each Future with its row.

    This is why a device-backed vector DB serves high QPS at tiny per-query cost: the
    device sees large batches even when clients send single queries.
    """

    def __init__(
        self,
        search_batch_fn: Callable[[np.ndarray, int], Sequence[Any]],
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        counters: Optional[AtomicCounters] = None,
        pad_to: Optional[int] = None,
    ):
        self._fn = search_batch_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # pad_to: pad every launch to this many rows (one jit shape).
        self.pad_to = pad_to
        self.counters = counters or AtomicCounters()
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gvdb-batcher")
        self._thread.start()
        self.batches_run = 0
        self.queries_run = 0

    def submit(self, query: np.ndarray, k: int) -> "concurrent.futures.Future[Any]":
        fut: "concurrent.futures.Future[Any]" = concurrent.futures.Future()
        self._q.put(_Pending(np.asarray(query, dtype=np.float32), k, fut))
        return fut

    def search(self, query: np.ndarray, k: int, timeout_s: float = 30.0) -> Any:
        return self.submit(query, k).result(timeout=timeout_s)

    def _collect(self) -> List[_Pending]:
        """Block for the first request, then drain up to max_batch within the
        wait window."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _loop(self) -> None:
        while not self._stop:
            batch = self._collect()
            if not batch:
                continue
            # Group by k (fixed output shape per kernel launch).
            by_k: Dict[int, List[_Pending]] = {}
            for p in batch:
                by_k.setdefault(p.k, []).append(p)
            for k, group in by_k.items():
                try:
                    stacked = np.stack([p.query for p in group])
                    if self.pad_to and stacked.shape[0] < self.pad_to:
                        # One compiled shape for the serving path: without
                        # this, every distinct batch-size bucket compiles a
                        # separate program, and a fresh compile stalls the
                        # collector and every queued future behind it. Zero
                        # rows are discarded.
                        stacked = np.concatenate([
                            stacked,
                            np.zeros((self.pad_to - stacked.shape[0],
                                      stacked.shape[1]), stacked.dtype),
                        ])
                    results = self._fn(stacked, k)
                    for p, row in zip(group, results):
                        p.future.set_result(row)
                    self.counters.increment("search_ops", len(group))
                    self.counters.increment("successful_ops", len(group))
                    self.batches_run += 1
                    self.queries_run += len(group)
                except Exception as e:
                    for p in group:
                        if not p.future.done():
                            p.future.set_exception(e)
                    self.counters.increment("failed_ops", len(group))

    def close(self) -> None:
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=2.0)

    def stats(self) -> Dict[str, float]:
        return {
            "batches_run": float(self.batches_run),
            "queries_run": float(self.queries_run),
            "avg_batch": self.queries_run / self.batches_run if self.batches_run else 0.0,
            "queue_depth": float(self._q.qsize()),
        }


class ConcurrentBatchProcessor(Generic[T, R]):
    """Thread-pool batch map for host-side work (concurrent.rs:376-451)."""

    def __init__(self, workers: int = 4):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="gvdb-batch"
        )

    def map_batches(
        self, items: Sequence[T], fn: Callable[[Sequence[T]], R], batch_size: int = 64
    ) -> List[R]:
        chunks = [items[i:i + batch_size] for i in range(0, len(items), batch_size)]
        return list(self._pool.map(fn, chunks))

    def close(self) -> None:
        self._pool.shutdown(wait=False)
