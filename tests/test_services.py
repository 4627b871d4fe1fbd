"""Runtime-service tests: resilience state machines (resilience.rs:762-892),
enterprise auth (enterprise.rs tests), batching executor, metrics percentiles
(metrics.rs:490-549)."""

import threading
import time

import numpy as np
import pytest

from grape_vector_db_tpu.errors import (
    AuthenticationError,
    AuthorizationError,
    CircuitOpenError,
    RateLimitError,
    TimeoutError_,
    UnavailableError,
)
from grape_vector_db_tpu.services.concurrent import AtomicCounters, BatchingExecutor
from grape_vector_db_tpu.services.enterprise import (
    AuthenticationManager,
    Permission,
    Role,
    SecurityPolicy,
)
from grape_vector_db_tpu.services.metrics import MetricsCollector, QueryTimer
from grape_vector_db_tpu.services.resilience import (
    BackoffPolicy,
    CircuitBreaker,
    CircuitBreakerConfig,
    CircuitState,
    ResilienceManager,
    ResourcePool,
    RetryConfig,
    RetryExecutor,
    TimeoutWrapper,
    TokenBucketRateLimiter,
)


# -- circuit breaker ----------------------------------------------------------


def test_breaker_opens_and_recovers():
    cb = CircuitBreaker(CircuitBreakerConfig(
        minimum_requests=10, sleep_window_s=0.1, half_open_max_probes=2))
    for _ in range(10):
        cb.record(False)
    assert cb.state == CircuitState.OPEN
    with pytest.raises(CircuitOpenError):
        cb.call(lambda: 1)
    time.sleep(0.12)
    assert cb.state == CircuitState.HALF_OPEN
    assert cb.call(lambda: 42) == 42
    assert cb.call(lambda: 43) == 43
    assert cb.state == CircuitState.CLOSED


def test_breaker_half_open_failure_reopens():
    cb = CircuitBreaker(CircuitBreakerConfig(minimum_requests=5, sleep_window_s=0.05))
    for _ in range(5):
        cb.record(False)
    time.sleep(0.06)
    assert cb.state == CircuitState.HALF_OPEN
    with pytest.raises(RuntimeError):
        cb.call(lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    assert cb.state == CircuitState.OPEN


# -- rate limiter -------------------------------------------------------------


def test_token_bucket_refill():
    rl = TokenBucketRateLimiter(rate_per_s=100.0, burst=5)
    assert all(rl.try_acquire() for _ in range(5))
    assert not rl.try_acquire()
    time.sleep(0.05)  # ~5 tokens refill
    assert rl.try_acquire()


# -- retry -------------------------------------------------------------------


def test_retry_counts_and_gives_up():
    calls = []

    def flaky():
        calls.append(1)
        raise UnavailableError("down")

    ex = RetryExecutor(RetryConfig(max_attempts=3, base_delay_s=0.001))
    with pytest.raises(UnavailableError):
        ex.execute(flaky)
    assert len(calls) == 3


def test_retry_only_retryable():
    calls = []

    def bad():
        calls.append(1)
        raise ValueError("not retryable")

    ex = RetryExecutor(RetryConfig(max_attempts=3, base_delay_s=0.001))
    with pytest.raises(ValueError):
        ex.execute(bad)
    assert len(calls) == 1


def test_retry_succeeds_midway():
    state = {"n": 0}

    def eventually():
        state["n"] += 1
        if state["n"] < 3:
            raise UnavailableError("warming")
        return "ok"

    ex = RetryExecutor(RetryConfig(max_attempts=5, base_delay_s=0.001,
                                   policy=BackoffPolicy.LINEAR))
    assert ex.execute(eventually) == "ok"


# -- timeout / pool ------------------------------------------------------------


def test_timeout_wrapper():
    tw = TimeoutWrapper(timeout_s=0.05)
    assert tw.execute(lambda: 7) == 7
    with pytest.raises(TimeoutError_):
        tw.execute(lambda: time.sleep(0.5))


def test_resource_pool_raii():
    pool = ResourcePool(factory=lambda: object(), size=2)
    with pool.acquire() as a:
        with pool.acquire() as b:
            assert pool.idle == 0
            with pytest.raises(UnavailableError):
                pool.acquire(timeout_s=0.01)
    assert pool.idle == 2


def test_resilience_manager_composes():
    mgr = ResilienceManager(
        limiter=TokenBucketRateLimiter(rate_per_s=1000, burst=2),
        retry=RetryExecutor(RetryConfig(max_attempts=2, base_delay_s=0.001)),
    )
    assert mgr.execute(lambda: "v") == "v"
    assert mgr.execute(lambda: "v") == "v"
    with pytest.raises(RateLimitError):
        mgr.execute(lambda: "v")  # bucket drained
    assert mgr.status().circuit_state == "closed"


# -- enterprise ----------------------------------------------------------------


def test_auth_user_lifecycle_and_rbac():
    am = AuthenticationManager()
    am.create_user("alice", "supersecret", Role.DATA_MANAGER)
    token = am.login("alice", "supersecret")
    assert am.authorize(token, Permission.WRITE_DATA) == "alice"
    with pytest.raises(AuthorizationError):
        am.authorize(token, Permission.MANAGE_USERS)


def test_auth_bad_password_and_lockout():
    am = AuthenticationManager(SecurityPolicy(max_failed_logins=3, lockout_window_s=60))
    am.create_user("bob", "password123", Role.READ_ONLY_USER)
    for _ in range(3):
        with pytest.raises(AuthenticationError):
            am.login("bob", "wrong")
    with pytest.raises(AuthenticationError, match="locked"):
        am.login("bob", "password123")  # correct password but locked out


def test_api_keys():
    am = AuthenticationManager()
    ak = am.create_api_key("svc", Role.READ_ONLY_USER)
    assert ak.key.startswith("gvdb_") and len(ak.key) == 5 + 32
    assert am.authorize(ak.key, Permission.READ_DATA) == "key:svc"
    with pytest.raises(AuthorizationError):
        am.authorize(ak.key, Permission.WRITE_DATA)
    am.revoke_api_key(ak.key)
    with pytest.raises(AuthenticationError):
        am.verify_api_key(ak.key)


def test_token_tampering_rejected():
    am = AuthenticationManager()
    am.create_user("eve", "longenough", Role.READ_ONLY_USER)
    token = am.login("eve", "longenough")
    body, sig = token.rsplit(".", 1)
    with pytest.raises(AuthenticationError):
        am.verify_token(body + "." + "0" * len(sig))
    assert am.verify_token(token)["sub"] == "eve"


def test_expired_api_key():
    am = AuthenticationManager()
    ak = am.create_api_key("tmp", Role.READ_ONLY_USER, ttl_s=0.01)
    time.sleep(0.02)
    with pytest.raises(AuthenticationError):
        am.verify_api_key(ak.key)


def test_audit_log_records():
    am = AuthenticationManager()
    am.create_user("carol", "password123", Role.READ_ONLY_USER)
    try:
        am.login("carol", "nope")
    except AuthenticationError:
        pass
    log = am.audit_log()
    assert any(e.action == "create_user" and e.success for e in log)
    assert any(e.action == "login" and not e.success for e in log)


# -- batching executor -----------------------------------------------------------


def test_batching_executor_packs_concurrent_queries():
    seen_batches = []

    def fake_search(batch, k):
        seen_batches.append(batch.shape[0])
        return [[(f"hit-{i}", 1.0)] * k for i in range(batch.shape[0])]

    ex = BatchingExecutor(fake_search, max_batch=16, max_wait_ms=20)
    futs = [ex.submit(np.full(4, i, dtype=np.float32), 3) for i in range(10)]
    results = [f.result(timeout=5) for f in futs]
    assert all(len(r) == 3 for r in results)
    ex.close()
    # concurrency actually batched: far fewer kernel launches than queries
    assert ex.batches_run < 10
    assert max(seen_batches) > 1


def test_batching_executor_propagates_errors():
    def boom(batch, k):
        raise RuntimeError("kernel failed")

    ex = BatchingExecutor(boom, max_batch=4, max_wait_ms=1)
    fut = ex.submit(np.zeros(4, np.float32), 1)
    with pytest.raises(RuntimeError):
        fut.result(timeout=5)
    ex.close()


def test_batching_executor_groups_by_k():
    ks = []

    def fake_search(batch, k):
        ks.append(k)
        return [[("x", 1.0)] * k] * batch.shape[0]

    ex = BatchingExecutor(fake_search, max_batch=8, max_wait_ms=20)
    f1 = ex.submit(np.zeros(4, np.float32), 2)
    f2 = ex.submit(np.zeros(4, np.float32), 5)
    assert len(f1.result(5)) == 2 and len(f2.result(5)) == 5
    ex.close()
    assert sorted(set(ks)) == [2, 5]


# -- metrics ---------------------------------------------------------------------


def test_metrics_percentiles_and_qps():
    mc = MetricsCollector()
    for i in range(100):
        mc.record_query(float(i + 1))
    snap = mc.snapshot()
    assert 49 <= snap.p50_latency_ms <= 52
    assert 94 <= snap.p95_latency_ms <= 97
    assert snap.max_latency_ms == 100.0
    assert snap.qps > 0


def test_query_timer_context():
    mc = MetricsCollector()
    with QueryTimer(mc):
        time.sleep(0.01)
    snap = mc.snapshot()
    assert snap.total_queries == 1
    assert snap.avg_latency_ms >= 10


def test_prometheus_text():
    mc = MetricsCollector()
    mc.record_query(5.0)
    mc.set_gauge("hbm_used_mb", 123.0)
    text = mc.prometheus_text()
    assert "grape_vector_db_queries_total 1" in text
    assert "grape_vector_db_hbm_used_mb 123.0" in text


def test_atomic_counters():
    c = AtomicCounters()
    c.increment("total_ops", 5)
    c.increment("cache_hits")
    assert c.get("total_ops") == 5
    assert c.snapshot()["cache_hits"] == 1


def test_tracing_helpers(tmp_path, capsys):
    from grape_vector_db_tpu.utils.tracing import setup_logging, trace_span

    log = setup_logging("debug")
    with trace_span("unit-test-span"):
        pass  # annotation path exercised; duration logged at debug
    assert log.level <= 10


def test_config_provider_constructors():
    """VectorDbConfig convenience constructors (lib.rs:792-824)."""
    from grape_vector_db_tpu.config import VectorDbConfig

    c = VectorDbConfig.with_openai_compatible(
        "https://api.openai.com/v1/embeddings", "sk-x", "text-embedding-3-small")
    assert c.embedding.provider == "openai" and c.embedding.api_key == "sk-x"
    c = VectorDbConfig.with_azure_openai(
        "https://r.openai.azure.com", "key", "deploy-1", "2023-05-15")
    assert (c.embedding.provider == "azure"
            and c.embedding.model == "deploy-1"
            and c.embedding.api_version == "2023-05-15")
    c = VectorDbConfig.with_ollama("http://localhost:11434", "nomic-embed-text")
    assert c.embedding.provider == "ollama" and c.embedding.api_key is None


def test_azure_provider_url_and_headers(monkeypatch):
    """Azure requests carry api-key header + api-version query param."""
    import json as _json
    from grape_vector_db_tpu.config import VectorDbConfig
    from grape_vector_db_tpu.services.embeddings import OpenAICompatibleProvider

    cfg = VectorDbConfig.with_azure_openai(
        "https://r.openai.azure.com/openai/deployments/d/embeddings",
        "secret", "deploy-1", "2023-05-15").embedding
    cfg.dimension = 4
    prov = OpenAICompatibleProvider(cfg)
    seen = {}

    class FakeResp:
        def __enter__(self):
            return self
        def __exit__(self, *a):
            return False
        def read(self):
            return _json.dumps(
                {"data": [{"index": 0, "embedding": [0.0, 1.0, 0.0, 0.0]}]}
            ).encode()

    def fake_urlopen(req, timeout=None):
        seen["url"] = req.full_url
        seen["headers"] = dict(req.header_items())
        return FakeResp()

    import urllib.request
    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    out = prov.generate_embeddings(["hi"])
    assert len(out) == 1 and len(out[0]) == 4
    assert "api-version=2023-05-15" in seen["url"]
    hdrs = {k.lower(): v for k, v in seen["headers"].items()}
    assert hdrs.get("api-key") == "secret"
    assert "authorization" not in hdrs


def test_batching_executor_pad_to_fixed_shape():
    """pad_to pads every launch to one row count (one jit shape) and
    each caller still gets exactly its own row back."""
    shapes = []

    def fake_search(batch, k):
        shapes.append(batch.shape[0])
        # row i echoes its first element so callers can check routing
        return [[(f"hit-{batch[i, 0]:.0f}", 1.0)] * k
                for i in range(batch.shape[0])]

    ex = BatchingExecutor(fake_search, max_batch=8, max_wait_ms=20, pad_to=8)
    futs = [ex.submit(np.full(4, i, dtype=np.float32), 2) for i in range(5)]
    rows = [f.result(timeout=5) for f in futs]
    ex.close()
    assert set(shapes) == {8}, f"every launch must pad to 8 rows: {shapes}"
    for i, row in enumerate(rows):
        assert row[0][0] == f"hit-{i}", "padding must not misroute results"
