"""Metrics collection (reference src/metrics.rs).

``MetricsCollector``: sliding-window query latencies (10k samples) with
p50/p95/p99 (metrics.rs:47-86), hit/miss counters, a 60s-window QPS calculator
(metrics.rs:127-159), and named gauges. ``QueryTimer`` is the RAII timer
(metrics.rs:468-488) — a context manager here. A Prometheus text exposition
endpoint (same ``grape_vector_db_*`` metric names, metrics.rs:352-402) renders
from this collector in the server layer.

Device addition: ``record_device_time`` tracks kernel wall time separately from
end-to-end latency so HBM-bound kernels can be monitored against roofline.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Tuple

__all__ = ["PerformanceMetrics", "MetricsCollector", "QueryTimer"]


@dataclass
class PerformanceMetrics:
    """metrics.rs:13-44 PerformanceMetrics snapshot."""

    total_queries: int = 0
    successful_queries: int = 0
    failed_queries: int = 0
    avg_latency_ms: float = 0.0
    p50_latency_ms: float = 0.0
    p95_latency_ms: float = 0.0
    p99_latency_ms: float = 0.0
    max_latency_ms: float = 0.0
    qps: float = 0.0
    cache_hit_rate: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    insert_count: int = 0
    delete_count: int = 0
    device_time_ms_total: float = 0.0
    gauges: Dict[str, float] = field(default_factory=dict)


class MetricsCollector:
    def __init__(self, window_size: int = 10_000, qps_window_s: float = 60.0):
        self._lock = threading.Lock()
        self._latencies: Deque[float] = deque(maxlen=window_size)
        self._query_times: Deque[float] = deque()
        self._qps_window_s = qps_window_s
        self._total = 0
        self._ok = 0
        self._fail = 0
        self._cache_hits = 0
        self._cache_misses = 0
        self._inserts = 0
        self._deletes = 0
        self._device_ms = 0.0
        self._gauges: Dict[str, float] = {}

    # -- recording ----------------------------------------------------------

    def record_query(self, latency_ms: float, success: bool = True) -> None:
        now = time.monotonic()
        with self._lock:
            self._latencies.append(latency_ms)
            self._query_times.append(now)
            self._trim(now)
            self._total += 1
            if success:
                self._ok += 1
            else:
                self._fail += 1

    def record_cache(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self._cache_hits += 1
            else:
                self._cache_misses += 1

    def record_insert(self, n: int = 1) -> None:
        with self._lock:
            self._inserts += n

    def record_delete(self, n: int = 1) -> None:
        with self._lock:
            self._deletes += n

    def record_device_time(self, ms: float) -> None:
        with self._lock:
            self._device_ms += ms

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def record_hbm(self) -> None:
        """Sample device memory occupancy into gauges (SURVEY §2.2 metrics
        row: HBM gauge) for EVERY local device: ``hbm_bytes_in_use`` /
        ``hbm_bytes_limit`` / ``hbm_occupancy`` are the sums over devices
        (occupancy = summed use over summed limit), and each device also gets
        ``hbm_bytes_in_use_dev{i}``. GPU runtimes report these through
        ``Device.memory_stats()``; backends without stats (CPU) are a no-op.
        Called by snapshot(), so /metrics always carries a fresh sample."""
        try:
            import jax

            devices = jax.local_devices()
            per_dev = [d.memory_stats() for d in devices]
        except Exception:
            return
        gauges = {}
        used_sum = limit_sum = 0.0
        for i, stats in enumerate(per_dev):
            if not stats:
                continue
            used = stats.get("bytes_in_use")
            limit = stats.get("bytes_limit")
            if used is not None:
                gauges[f"hbm_bytes_in_use_dev{i}"] = float(used)
                used_sum += float(used)
            if limit:
                limit_sum += float(limit)
        if not gauges and not limit_sum:
            return
        gauges["hbm_bytes_in_use"] = used_sum
        if limit_sum:
            gauges["hbm_bytes_limit"] = limit_sum
            gauges["hbm_occupancy"] = used_sum / limit_sum
        with self._lock:
            self._gauges.update(gauges)

    def _trim(self, now: float) -> None:
        cutoff = now - self._qps_window_s
        while self._query_times and self._query_times[0] < cutoff:
            self._query_times.popleft()

    # -- reading --------------------------------------------------------------

    @staticmethod
    def _percentile(sorted_vals, q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
        return sorted_vals[idx]

    def snapshot(self) -> PerformanceMetrics:
        self.record_hbm()
        with self._lock:
            lats = sorted(self._latencies)
            self._trim(time.monotonic())
            qps = len(self._query_times) / self._qps_window_s
            hits, misses = self._cache_hits, self._cache_misses
            return PerformanceMetrics(
                total_queries=self._total,
                successful_queries=self._ok,
                failed_queries=self._fail,
                avg_latency_ms=(sum(lats) / len(lats)) if lats else 0.0,
                p50_latency_ms=self._percentile(lats, 0.50),
                p95_latency_ms=self._percentile(lats, 0.95),
                p99_latency_ms=self._percentile(lats, 0.99),
                max_latency_ms=lats[-1] if lats else 0.0,
                qps=qps,
                cache_hit_rate=hits / (hits + misses) if (hits + misses) else 0.0,
                cache_hits=hits,
                cache_misses=misses,
                insert_count=self._inserts,
                delete_count=self._deletes,
                device_time_ms_total=self._device_ms,
                gauges=dict(self._gauges),
            )

    def prometheus_text(self, prefix: str = "grape_vector_db") -> str:
        """Prometheus text exposition (same metric names as metrics.rs:352-402)."""
        m = self.snapshot()
        lines = []
        pairs: Tuple[Tuple[str, float], ...] = (
            ("queries_total", m.total_queries),
            ("queries_success_total", m.successful_queries),
            ("queries_failed_total", m.failed_queries),
            ("query_latency_ms_avg", m.avg_latency_ms),
            ("query_latency_ms_p50", m.p50_latency_ms),
            ("query_latency_ms_p95", m.p95_latency_ms),
            ("query_latency_ms_p99", m.p99_latency_ms),
            ("qps", m.qps),
            ("cache_hit_rate", m.cache_hit_rate),
            ("inserts_total", m.insert_count),
            ("deletes_total", m.delete_count),
            ("device_time_ms_total", m.device_time_ms_total),
        )
        for name, val in pairs:
            lines.append(f"{prefix}_{name} {val}")
        for g, val in m.gauges.items():
            lines.append(f"{prefix}_{g} {val}")
        return "\n".join(lines) + "\n"


class QueryTimer:
    """RAII query timer (metrics.rs:468-488) as a context manager."""

    def __init__(self, collector: Optional[MetricsCollector]):
        self.collector = collector
        self.latency_ms: float = 0.0
        self._ok = True

    def fail(self) -> None:
        self._ok = False

    def __enter__(self) -> "QueryTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.latency_ms = (time.perf_counter() - self._t0) * 1e3
        if self.collector is not None:
            self.collector.record_query(self.latency_ms, success=self._ok and exc_type is None)
