"""Performance module (reference src/performance/, 879 LoC).

- CacheManager: query + embedding caches (cache_manager.rs:5-91; 50k/100k
  entries, 30min TTL) — built on the same TtlCache as the planner.
- IndexOptimizer: interval- or mutation-threshold-triggered ``optimize()``
  (index_optimizer.rs:11-154).
- PerformanceMonitor: background sampler pushing process stats into metric
  gauges (metrics.rs:412-452).

ParallelSearchExecutor's job (multi-query batching, parallel_search.rs) is
subsumed by services/concurrent.BatchingExecutor — on a device the batch dimension
IS the parallelism.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Sequence

from grape_vector_db_tpu.engine.cache import TtlCache
from grape_vector_db_tpu.services.metrics import MetricsCollector

__all__ = ["CacheManager", "CachingEmbedder", "IndexOptimizer", "PerformanceMonitor"]


class CacheManager:
    """cache_manager.rs:5-91: one place owning the query + embedding caches."""

    def __init__(self, query_size: int = 50_000, embedding_size: int = 100_000,
                 ttl_s: float = 1800.0):
        self.query_cache: TtlCache = TtlCache(query_size, ttl_s)
        self.embedding_cache: TtlCache = TtlCache(embedding_size, ttl_s)

    def invalidate_all(self) -> None:
        self.query_cache.invalidate_all()
        self.embedding_cache.invalidate_all()

    def stats(self) -> dict:
        return {
            "query_entries": len(self.query_cache),
            "query_hit_rate": self.query_cache.hit_rate,
            "embedding_entries": len(self.embedding_cache),
            "embedding_hit_rate": self.embedding_cache.hit_rate,
        }


class CachingEmbedder:
    """EmbeddingProvider wrapper with a text->vector cache (the reference's
    embedding cache tier)."""

    def __init__(self, inner, cache: Optional[TtlCache] = None,
                 cache_size: int = 100_000, ttl_s: float = 1800.0):
        self.inner = inner
        self.cache = cache if cache is not None else TtlCache(cache_size, ttl_s)

    def dimension(self) -> int:
        return self.inner.dimension()

    def generate_embedding(self, text: str):
        return self.generate_embeddings([text])[0]

    def generate_embeddings(self, texts: Sequence[str]) -> List[List[float]]:
        out: List[Optional[List[float]]] = []
        misses: List[int] = []
        for i, t in enumerate(texts):
            hit = self.cache.get(t)
            out.append(hit)
            if hit is None:
                misses.append(i)
        if misses:
            fresh = self.inner.generate_embeddings([texts[i] for i in misses])
            for i, emb in zip(misses, fresh):
                self.cache.put(texts[i], emb)
                out[i] = emb
        return out  # type: ignore[return-value]


class IndexOptimizer:
    """index_optimizer.rs:11-154: call optimize() when enough mutations have
    accumulated or enough time has passed. Drive via notify_mutations() +
    maybe_optimize(), or start() a background thread."""

    def __init__(
        self,
        optimize_fn: Callable[[], None],
        mutation_threshold: int = 10_000,
        interval_s: float = 600.0,
    ):
        self.optimize_fn = optimize_fn
        self.mutation_threshold = mutation_threshold
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._mutations = 0
        self._last_run = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.runs = 0

    def notify_mutations(self, n: int = 1) -> None:
        with self._lock:
            self._mutations += n

    def maybe_optimize(self) -> bool:
        with self._lock:
            due = (
                self._mutations >= self.mutation_threshold
                or time.monotonic() - self._last_run >= self.interval_s
            )
            if not due:
                return False
            self._mutations = 0
            self._last_run = time.monotonic()
        self.optimize_fn()
        self.runs += 1
        return True

    def start(self, poll_s: float = 5.0) -> None:
        def loop() -> None:
            while not self._stop.wait(poll_s):
                try:
                    self.maybe_optimize()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="gvdb-index-optimizer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)


class PerformanceMonitor:
    """metrics.rs:412-452: background sampler filling gauges."""

    def __init__(self, metrics: MetricsCollector, interval_s: float = 10.0):
        self.metrics = metrics
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self) -> None:
        try:
            import resource

            ru = resource.getrusage(resource.RUSAGE_SELF)
            self.metrics.set_gauge("process_max_rss_mb", ru.ru_maxrss / 1024.0)
            self.metrics.set_gauge("process_user_time_s", ru.ru_utime)
        except Exception:
            pass
        try:
            load1, _, _ = os.getloadavg()
            self.metrics.set_gauge("host_load1", load1)
        except OSError:
            pass

    def start(self) -> None:
        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.sample_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="gvdb-perf-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
