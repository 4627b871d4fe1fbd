"""End-to-end database tests — the slice from SURVEY.md §7.2 plus the
reference's own lib.rs test suite shapes (CRUD roundtrip, semantic/hybrid
search, concurrent no-deadlock with timeout, batch-insert perf smoke;
lib.rs:827-1057)."""

import concurrent.futures
import time

import numpy as np
import pytest

from grape_vector_db_tpu import (
    Condition,
    Document,
    EmbeddedConfig,
    EmbeddedVectorDB,
    Filter,
    HybridSearchRequest,
    SearchRequest,
    VectorDatabase,
    VectorDbConfig,
)
from grape_vector_db_tpu.embedded import CheckStatus, DbState


def small_config(dim=32, **over):
    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.device.storage_dtype = "float32"
    cfg.index.initial_capacity = 256
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def make_docs(n, prefix="doc"):
    return [
        Document(
            id=f"{prefix}-{i}",
            title=f"Title {i}",
            content=f"the content body of document number {i} talks about topic{i % 5}",
            metadata={"category": "even" if i % 2 == 0 else "odd", "rank": i},
        )
        for i in range(n)
    ]


def test_crud_roundtrip():
    db = VectorDatabase(config=small_config())
    docs = make_docs(20)
    ids = db.batch_add_documents(docs)
    assert len(ids) == 20
    got = db.get_document("doc-7")
    assert got.title == "Title 7" and got.vector is not None

    assert db.delete_document("doc-7")
    assert db.get_document("doc-7") is None
    assert not db.delete_document("doc-7")
    st = db.stats()
    assert st.document_count == 19 and st.index_size == 19


def test_semantic_search_self_retrieval():
    db = VectorDatabase(config=small_config())
    db.batch_add_documents(make_docs(50))
    # mock embedder is deterministic: querying with a doc's own text returns it
    res = db.search_documents("Title 13 the content body of document number 13 talks about topic3")
    assert res
    # exact embedding match must rank first
    doc13 = db.get_document("doc-13")
    hits = db.vector_search(SearchRequest(vector=doc13.vector, limit=5))
    assert hits[0].id == "doc-13"
    assert hits[0].score > 0.99


def test_filtered_vector_search():
    db = VectorDatabase(config=small_config())
    db.batch_add_documents(make_docs(40))
    doc6 = db.get_document("doc-6")
    req = SearchRequest(
        vector=doc6.vector, limit=10,
        filter=Filter(must=[Condition("category", "eq", "odd")]),
    )
    hits = db.vector_search(req)
    assert hits
    assert all(int(h.id.split("-")[1]) % 2 == 1 for h in hits)


def test_hybrid_search_e2e():
    db = VectorDatabase(config=small_config())
    db.batch_add_documents(make_docs(30))
    res = db.hybrid_search(HybridSearchRequest(query="document number 11", limit=5))
    assert res
    assert any(r.document.id == "doc-11" for r in res)
    assert res[0].breakdown is not None


def test_persistence_and_reopen(tmp_path):
    path = str(tmp_path / "db")
    cfg = small_config()
    db = VectorDatabase(path=path, config=cfg)
    db.batch_add_documents(make_docs(25))
    doc3_vec = db.get_document("doc-3").vector
    db.close()

    db2 = VectorDatabase(path=path, config=small_config())
    assert db2.stats().document_count == 25
    hits = db2.vector_search(SearchRequest(vector=doc3_vec, limit=3))
    assert hits[0].id == "doc-3"
    db2.close()


def test_backup_restore_e2e(tmp_path):
    path, bak = str(tmp_path / "db"), str(tmp_path / "bak.gvdb")
    db = VectorDatabase(path=path, config=small_config())
    db.batch_add_documents(make_docs(15))
    db.create_backup(bak)
    db.batch_delete_documents([f"doc-{i}" for i in range(10)])
    assert db.stats().document_count == 5
    db.restore_backup(bak)
    assert db.stats().document_count == 15
    assert db.stats().index_size == 15
    db.close()


def test_rebuild_index():
    db = VectorDatabase(config=small_config())
    db.batch_add_documents(make_docs(12))
    n = db.rebuild_index()
    assert n == 12
    doc5 = db.get_document("doc-5")
    assert db.vector_search(SearchRequest(vector=doc5.vector, limit=1))[0].id == "doc-5"


def test_concurrent_no_deadlock():
    """20-task concurrent ops with a 10s wall-clock assertion (lib.rs:939-1010)."""
    db = VectorDatabase(config=small_config())
    db.batch_add_documents(make_docs(50))
    t0 = time.monotonic()

    def work(i):
        if i % 3 == 0:
            db.batch_add_documents(make_docs(5, prefix=f"w{i}"))
        elif i % 3 == 1:
            doc = db.get_document(f"doc-{i % 50}")
            if doc:
                db.vector_search(SearchRequest(vector=doc.vector, limit=5))
        else:
            db.search_documents(f"document number {i % 50}")
        return True

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        results = list(ex.map(work, range(20)))
    assert all(results)
    assert time.monotonic() - t0 < 10.0, "concurrent ops took too long (deadlock?)"


def test_concurrent_ingest_vs_bm25_search_consistency():
    """Heavier churn aimed at the threaded ingest path: while writer threads
    batch-add (BM25 indexed on the worker thread), reader threads run hybrid
    text searches. After the dust settles every acknowledged batch must be
    fully BM25-searchable (the worker is joined before each add returns)."""
    db = VectorDatabase(config=small_config())
    errs = []

    def writer(w):
        try:
            for b in range(5):
                docs = make_docs(8, prefix=f"w{w}b{b}")
                db.batch_add_documents(docs)
                # read-your-writes through the sparse channel, immediately
                hits = db.search_documents(f"number 3")
                assert isinstance(hits, list)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    def reader():
        try:
            for _ in range(20):
                db.search_documents("content body topic2")
        except Exception as e:  # pragma: no cover
            errs.append(e)

    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as ex:
        futs = [ex.submit(writer, w) for w in range(3)]
        futs += [ex.submit(reader) for _ in range(3)]
        for f in futs:
            f.result()
    assert not errs, errs
    # every acknowledged doc is in the sparse index
    assert len(db.sparse) == db.store.count()
    hits = db.search_documents("document number 1")
    assert hits


def test_batch_insert_perf_smoke():
    """50-doc batch insert must be fast (<1s target, bin/concurrent_insert_test.rs:23)."""
    db = VectorDatabase(config=small_config())
    db.batch_add_documents(make_docs(5))  # warm jit
    t0 = time.monotonic()
    db.batch_add_documents(make_docs(50, prefix="perf"))
    assert time.monotonic() - t0 < 1.0


def test_embedded_lifecycle(tmp_path):
    cfg = EmbeddedConfig(data_dir=str(tmp_path / "edb"), db=small_config())
    cfg.health_check_interval_s = 0  # no background thread in tests
    with EmbeddedVectorDB(cfg) as edb:
        assert edb.state == DbState.READY
        ids = edb.upsert(make_docs(10))
        assert len(ids) == 10
        doc = edb.get("doc-2")
        hits = edb.vector_search(SearchRequest(vector=doc.vector, limit=3))
        assert hits[0].id == "doc-2"
        health = edb.health_check()
        assert health.status == CheckStatus.HEALTHY
        assert edb.stats().document_count == 10
    assert edb.state == DbState.CLOSED
    from grape_vector_db_tpu.errors import StateError
    with pytest.raises(StateError):
        edb.get("doc-2")


def test_embedded_async(tmp_path):
    import asyncio

    cfg = EmbeddedConfig(data_dir=str(tmp_path / "adb"), db=small_config())
    cfg.health_check_interval_s = 0

    async def main():
        edb = EmbeddedVectorDB(cfg)
        await edb.upsert_async(make_docs(8))
        doc = edb.get("doc-1")
        hits = await edb.vector_search_async(SearchRequest(vector=doc.vector, limit=2))
        assert hits[0].id == "doc-1"
        edb.close()

    asyncio.run(main())


def test_binary_index_db_mode():
    cfg = small_config(dim=64)
    cfg.index.kind = "binary"
    cfg.index.initial_capacity = 512
    cfg.index.rescore_ratio = 0.3
    db = VectorDatabase(config=cfg)
    db.batch_add_documents(make_docs(100))
    doc = db.get_document("doc-42")
    hits = db.vector_search(SearchRequest(vector=doc.vector, limit=5))
    assert hits[0].id == "doc-42"


def test_enterprise_guarded_api():
    from grape_vector_db_tpu.services.enterprise import Role
    from grape_vector_db_tpu.errors import AuthorizationError, StateError

    db = VectorDatabase(config=small_config())
    with pytest.raises(StateError):
        db.search_with_auth("gvdb_nope", SearchRequest(query="x"))
    auth = db.enable_enterprise()
    writer = auth.create_api_key("writer", Role.DATA_MANAGER)
    reader = auth.create_api_key("reader", Role.READ_ONLY_USER)
    db.add_documents_with_auth(writer.key, make_docs(5))
    with pytest.raises(AuthorizationError):
        db.add_documents_with_auth(reader.key, make_docs(1, prefix="x"))
    doc = db.get_document("doc-1")
    res = db.search_with_auth(reader.key, SearchRequest(vector=doc.vector, limit=2))
    assert res and res[0].document.id == "doc-1"
    assert db.delete_documents_with_auth(writer.key, ["doc-0"]) == 1


def test_embedded_batched_single_queries(tmp_path):
    cfg = EmbeddedConfig(data_dir=str(tmp_path / "bdb"), db=small_config())
    cfg.health_check_interval_s = 0
    with EmbeddedVectorDB(cfg) as edb:
        edb.upsert(make_docs(30))
        vecs = [edb.get(f"doc-{i}").vector for i in range(8)]
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            rows = list(ex.map(lambda v: edb.vector_search_one(v, 3), vecs))
        for i, row in enumerate(rows):
            assert row[0].id == f"doc-{i}"
        assert edb.executor.queries_run == 8


def test_graph_index_db_mode():
    cfg = small_config(dim=48)
    cfg.index.kind = "graph"
    cfg.index.initial_capacity = 1024
    cfg.index.m = 8
    cfg.index.ef_search = 64
    db = VectorDatabase(config=cfg)
    db.batch_add_documents(make_docs(400))
    db.optimize()
    doc = db.get_document("doc-123")
    hits = db.vector_search(SearchRequest(vector=doc.vector, limit=5))
    assert hits[0].id == "doc-123"
    assert db.stats().index_kind == "graph"


def test_index_snapshot_save_load(tmp_path):
    cfg = small_config()
    db = VectorDatabase(config=cfg)
    db.batch_add_documents(make_docs(40))
    snap = str(tmp_path / "index.snap")
    info = db.save_index(snap)
    assert info["points"] == 40

    db2 = VectorDatabase(config=small_config())
    out = db2.load_index(snap)
    assert out["points"] == 40
    doc = db.get_document("doc-9")
    hits = db2.vector_search(SearchRequest(vector=doc.vector, limit=1))
    assert hits[0].id == "doc-9"

    # dimension mismatch rejected
    from grape_vector_db_tpu.errors import InvalidArgumentError
    db3 = VectorDatabase(config=small_config(dim=16))
    with pytest.raises(InvalidArgumentError):
        db3.load_index(snap)


def test_embedding_cache_dedupes_provider_calls():
    calls = {"n": 0}
    from grape_vector_db_tpu.services.embeddings import MockEmbeddingProvider

    class CountingProvider(MockEmbeddingProvider):
        def generate_embeddings(self, texts):
            calls["n"] += len(texts)
            return super().generate_embeddings(texts)

    cfg = small_config()
    db = VectorDatabase(config=cfg, embedder=CountingProvider(32))
    db.search_documents("same query text")
    first = calls["n"]
    db.search_documents("same query text")
    assert calls["n"] == first  # embedding came from cache


def test_index_optimizer_triggers():
    from grape_vector_db_tpu.engine.performance import IndexOptimizer

    ran = []
    opt = IndexOptimizer(lambda: ran.append(1), mutation_threshold=5, interval_s=9999)
    opt.notify_mutations(3)
    assert not opt.maybe_optimize()
    opt.notify_mutations(3)
    assert opt.maybe_optimize()
    assert len(ran) == 1


def test_pq_index_db_mode():
    cfg = small_config(dim=32)
    cfg.index.kind = "pq"
    cfg.index.initial_capacity = 2048
    cfg.index.rescore_ratio = 0.2
    db = VectorDatabase(config=cfg)
    db.batch_add_documents(make_docs(1200))
    doc = db.get_document("doc-77")
    hits = db.vector_search(SearchRequest(vector=doc.vector, limit=3))
    assert hits[0].id == "doc-77"
    assert db.stats().index_kind == "pq"


def test_filtered_hybrid_returns_matches_beyond_global_topk():
    """Regression: the filter must constrain channels BEFORE fusion truncation."""
    db = VectorDatabase(config=small_config())
    docs = make_docs(200)
    for d in docs:
        d.metadata["rare"] = d.id in ("doc-190", "doc-191", "doc-192")
    db.batch_add_documents(docs)
    req = HybridSearchRequest(
        query="the content body of document",  # matches everything broadly
        limit=3,
        filter=Filter(must=[Condition("rare", "eq", True)]),
    )
    res = db.hybrid_search(req)
    ids = {r.document.id for r in res}
    assert ids == {"doc-190", "doc-191", "doc-192"}, ids


def test_filtered_deep_pagination():
    """Regression: filtered pages past the old 400-item cap still return data."""
    db = VectorDatabase(config=small_config())
    cfg = db.config
    db.batch_add_documents(make_docs(900))
    doc = db.get_document("doc-0")
    f = Filter(must=[Condition("category", "eq", "even")])  # 450 matches
    page1 = db.vector_search(SearchRequest(vector=doc.vector, limit=10, offset=0, filter=f))
    deep = db.vector_search(SearchRequest(vector=doc.vector, limit=10, offset=420, filter=f))
    assert len(page1) == 10
    assert len(deep) == 10  # old cap made this empty


def test_list_and_count_documents():
    db = VectorDatabase(config=small_config())
    db.batch_add_documents(make_docs(30))
    assert db.count_documents() == 30
    f = Filter(must=[Condition("category", "eq", "even")])
    assert db.count_documents(f) == 15
    page = db.list_documents(offset=0, limit=10, filter=f)
    assert len(page) == 10 and all(d.metadata["category"] == "even" for d in page)
    page2 = db.list_documents(offset=10, limit=10, filter=f)
    assert len(page2) == 5
    assert {d.id for d in page} & {d.id for d in page2} == set()
    everything = db.list_documents(limit=1000)
    assert len(everything) == 30


def test_embedded_shutdown_hooks_and_drain(tmp_path):
    cfg = EmbeddedConfig(data_dir=str(tmp_path / "hdb"), db=small_config())
    cfg.health_check_interval_s = 0
    ran = []
    edb = EmbeddedVectorDB(cfg)
    edb.lifecycle.add_shutdown_hook(lambda: ran.append("hook"))
    edb.upsert(make_docs(5))
    edb.close()
    assert ran == ["hook"]
    edb.close()  # idempotent
    assert ran == ["hook"]


def test_cosine_scores_never_exceed_one():
    cfg = small_config(dim=64)
    cfg.device.storage_dtype = "bfloat16"
    db = VectorDatabase(config=cfg)
    db.batch_add_documents(make_docs(50))
    doc = db.get_document("doc-3")
    hits = db.vector_search(SearchRequest(vector=doc.vector, limit=5))
    assert hits[0].id == "doc-3"
    assert all(h.score <= 1.0 for h in hits)


def test_batch_mixing_ndarray_and_list_vectors(rng):
    """A batch whose first doc carries an ndarray vector and a later doc a
    Python list (e.g. embedder-filled) must not crash the fast stacking path
    (review-confirmed regression)."""
    cfg = small_config(dim=16)
    db = VectorDatabase(config=cfg)
    v = rng.standard_normal((3, 16)).astype(np.float32)
    docs = [
        Document(id="a", content="a", vector=v[0]),
        Document(id="b", content="b", vector=v[1].tolist()),
        Document(id="c", content="c", vector=v[2]),
    ]
    db.batch_add_documents(docs)
    hits = db.vector_search(SearchRequest(vector=v[1].tolist(), limit=1))
    assert hits[0].id == "b"


@pytest.mark.parametrize("kind", ["flat", "int8", "binary", "ivf", "ivf_pq",
                                  "ivf_int8", "ivf_int4", "graph", "pq",
                                  "ivf_int8_proj", "ivf_int4_proj",
                                  "sharded_flat",
                                  "sharded_ivf", "sharded_ivf_int8",
                                  "sharded_ivf_int4"])
def test_index_snapshot_roundtrip_every_engine(tmp_path, rng, kind):
    """save_index/load_index must round-trip EVERY engine kind (the
    reference's postcard+gzip snapshot covered one index type,
    query.rs:282-409) — including the quantized, projected, and
    mesh-sharded kinds, whose snapshots reconstruct from full-precision
    vectors via get_all()."""
    dim = 256 if kind.endswith("_proj") else 32  # proj_dim is 128-aligned
    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.device.storage_dtype = "float32"
    cfg.index.kind = kind
    cfg.index.initial_capacity = 1024
    cfg.index.nlist = 4
    cfg.index.proj_dim = 128
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    vecs = rng.standard_normal((300, dim)).astype(np.float32)
    if kind.endswith("_proj"):
        # decaying spectrum: the regime proj tiers are FOR — isotropic data
        # would (correctly) trip the build-time energy guard's warning
        vecs *= ((1.0 + np.arange(dim)) ** -1.0).astype(np.float32)[None, :]
    db.batch_add_documents([Document(id=f"d{i}", content=f"c{i}",
                                     vector=vecs[i].tolist())
                            for i in range(300)])
    p = str(tmp_path / "snap.gvdb")
    db.save_index(p)
    db2 = VectorDatabase(config=cfg)
    db2.load_index(p)
    hits = db2.index.search_batch(vecs[7:8], 3)[0]
    assert hits and hits[0][0] == "d7", (kind, hits[:2])


def test_write_after_close_raises_state_error():
    from grape_vector_db_tpu.errors import StateError

    db = VectorDatabase(config=small_config())
    db.batch_add_documents(make_docs(3))
    db.close()
    with pytest.raises(StateError):
        db.batch_add_documents(make_docs(1, prefix="late"))


@pytest.mark.parametrize("kind", ["ivf", "ivf_int8", "ivf_pq"])
def test_search_params_ef_overrides_ivf_nprobe(rng, kind):
    """SearchParams.ef (types.rs:156-171) maps to a per-request nprobe
    override on EVERY IVF family engine (each defines its own search_batch —
    the kwarg must exist on all of them): a clustered corpus searched at
    nprobe=1 misses cross-list neighbors that ef=nlist recovers, and params'
    with_vector flag overrides the request-level default."""
    from grape_vector_db_tpu import SearchParams

    dim = 32
    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.device.storage_dtype = "float32"
    cfg.index.kind = kind
    cfg.index.initial_capacity = 2048
    cfg.index.nlist = 8
    cfg.index.nprobe = 1
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    centers = rng.standard_normal((8, dim)).astype(np.float32) * 4
    pts = np.concatenate([c + 0.5 * rng.standard_normal((40, dim)).astype(np.float32)
                          for c in centers])
    db.batch_add_documents([
        Document(id=f"d{i}", content=f"c{i}", vector=pts[i].tolist())
        for i in range(len(pts))])
    db.index.optimize()

    # a query between clusters: nprobe=1 sees one list, ef=8 sees all
    q = ((centers[0] + centers[1]) / 2.0).tolist()
    base = db.vector_search(SearchRequest(vector=q, limit=20))
    wide = db.vector_search(SearchRequest(vector=q, limit=20,
                                          params=SearchParams(ef=8)))
    assert len(wide) >= len(base)
    # ef=8 == exhaustive probe: its result set must contain every base hit
    # and (on this geometry) strictly more mass from the second cluster
    base_ids = {h.id for h in base}
    wide_ids = {h.id for h in wide}
    assert base_ids <= wide_ids or len(wide_ids - base_ids) > 0

    # with_vector via params overrides the request default (False)
    hit = db.vector_search(SearchRequest(
        vector=q, limit=1, params=SearchParams(ef=8, with_vector=True)))[0]
    assert hit.vector is not None


def test_host_rescore_restores_recall_on_codes_only_index(rng):
    """config.query.host_rescore: the device index ranks over compressed
    codes (ivf_int4 capacity config, no bf16 shadow); the query engine
    re-ranks the C survivors exactly against the store's full-precision
    embeddings. On data noisy at the 4-bit quantization radius the
    device-only ranking misorders; the host tier must restore the exact
    order. Covers vector_search, vector_search_batch and the combined
    search path, plus the per-request SearchParams override."""
    from grape_vector_db_tpu import SearchParams

    dim, n = 64, 800
    # clusters tight relative to the int4 step so code-only ranking swaps
    centers = rng.standard_normal((8, dim)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 8, n)]
            + 0.05 * rng.standard_normal((n, dim))).astype(np.float32)

    def build(host_rescore):
        cfg = small_config(dim=dim)
        cfg.index.kind = "ivf_int4"
        cfg.index.nlist = 8
        cfg.index.nprobe = 8
        cfg.index.int8_rescore = 0            # no device rescore
        cfg.index.ivf_int8_keep_bf16 = False  # codes-only: no bf16 shadow
        cfg.index.initial_capacity = 1024
        cfg.query.host_rescore = host_rescore
        cfg.cache.enabled = False
        db = VectorDatabase(config=cfg)
        db.batch_add_documents([
            Document(id=f"d{i}", content=f"c{i}", vector=vecs[i])
            for i in range(n)])
        return db

    qi = rng.choice(n, 16, replace=False)
    q = vecs[qi]
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    oracle = np.argsort(-(vn[qi] @ vn.T), axis=1)[:, :5]

    def recall(db, params=None):
        got = 0
        for want, row in zip(oracle, q):
            hits = db.vector_search(SearchRequest(
                vector=row.tolist(), limit=5, params=params))
            have = {h.id for h in hits}
            got += sum(1 for w in want if f"d{w}" in have)
        return got / oracle.size

    raw_db = build(0)
    r_raw = recall(raw_db)
    # rescore width must exceed the ~100-member tight-cluster plateau: int4
    # scores within a cluster are near-ties, so the device candidate order
    # is ~random among them — C=192 guarantees the true top-5 is in the set
    resc_db = build(192)
    r_resc = recall(resc_db)
    assert r_resc >= 0.95, (r_raw, r_resc)
    assert r_resc > r_raw + 0.05, (r_raw, r_resc)

    # rescored scores are the exact cosine (bounded, self-match == ~1.0)
    top = resc_db.vector_search(SearchRequest(vector=vecs[3].tolist(), limit=1))
    assert top[0].id == "d3" and abs(top[0].score - 1.0) < 1e-3

    # batched path applies the same host tier
    rows = resc_db.vector_search_batch(q[:4], 5)
    got = sum(1 for want, row in zip(oracle[:4], rows)
              for w in want if f"d{w}" in {h.id for h in row})
    assert got / 20 >= 0.95

    # per-request override: params.host_rescore=64 on the raw (config=0) DB
    r_param = recall(raw_db, params=SearchParams(host_rescore=192))
    assert r_param >= 0.95, r_param
    # ...and params can disable it on the rescoring DB
    r_off = recall(resc_db, params=SearchParams(host_rescore=0))
    assert abs(r_off - r_raw) < 0.15, (r_off, r_raw)

    # combined dense+text search path rescorses too: exact self-match on top
    res = resc_db.search(SearchRequest(vector=vecs[11].tolist(), limit=3))
    assert res and res[0].document.id == "d11"


def test_tune_dispatch():
    """db.tune dispatches to the kind's auto-tuner and pins the knob."""
    # binary two-stage -> rescore budget
    cfg = small_config()
    cfg.index.kind = "binary"
    db = VectorDatabase(config=cfg)
    db.batch_add_documents(make_docs(200))
    out = db.tune(target_recall=0.9, k=5)
    assert out["kind"] == "binary"
    assert out["rescore_budget"] >= 64
    assert db.index.max_rescore == out["rescore_budget"]

    # ivf -> nprobe
    cfg2 = small_config()
    cfg2.index.kind = "ivf"
    cfg2.index.nlist = 8
    db2 = VectorDatabase(config=cfg2)
    db2.batch_add_documents(make_docs(200))
    out2 = db2.tune(target_recall=0.9, k=5)
    assert out2["kind"] == "ivf"
    if "nprobe" in out2:  # untrained small corpora may skip
        assert db2.index.nprobe == out2["nprobe"]

    # exact kind: nothing to tune, still returns the kind
    db3 = VectorDatabase(config=small_config())
    db3.batch_add_documents(make_docs(20))
    out3 = db3.tune()
    assert out3 == {"kind": "flat"}


def test_tune_hard_held_out_queries(rng):
    """Hard-query tuning: the self-recall protocol is the EASY bound —
    corpus-drawn queries' neighbors concentrate in their own list, so it
    can pick nprobe=1 where held-out queries need far more.
    tune(hard=True) sweeps nprobe x host_rescore against an exhaustive-probe
    + exact-rescore oracle on synthesized held-out queries and pins BOTH
    knobs."""
    dim, nclust, per = 48, 16, 192
    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.index.kind = "ivf_int8"
    cfg.index.initial_capacity = 4096
    cfg.index.nlist = 64          # k-means subdivides each cluster ~4x
    cfg.index.nprobe = 64
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    centers = rng.standard_normal((nclust, dim)).astype(np.float32) * 2.0
    pts = np.concatenate(
        [c + 0.8 * rng.standard_normal((per, dim)).astype(np.float32)
         for c in centers])
    db.batch_add_documents([
        Document(id=f"d{i}", content=f"c{i}", vector=pts[i])
        for i in range(len(pts))])

    qs = db.synth_tuning_queries(n=64, seed=3)
    assert qs.shape == (64, dim)
    # held-out by construction: midpoints are not corpus rows
    assert not any(np.allclose(q, p) for q in qs[:4] for p in pts[:64])

    out = db.tune(target_recall=0.9, k=10, hard=True)
    assert out["protocol"] == "held_out"
    assert out["recall"] >= 0.9
    assert db.index.nprobe == out["nprobe"]
    assert db.config.query.host_rescore == out["host_rescore"]
    assert out["sweep"], "sweep table missing"

    # the tuned operating point must hold up on FRESH held-out queries
    q2 = db.synth_tuning_queries(n=32, seed=11)
    saved_np = db.index.nprobe
    rows = db.index.search_batch(q2, max(10, out["host_rescore"]),
                                 nprobe=saved_np)
    if out["host_rescore"]:
        rows = db.engine._host_rescore_rows(q2, rows, 10)
    oracle_rows = db.index.search_batch(q2, 64, nprobe=db.index.nlist)
    oracle_rows = db.engine._host_rescore_rows(q2, oracle_rows, 10)
    denom = sum(len(r) for r in oracle_rows) or 1
    rec = sum(len({h[0] for h in a[:10]} & {h[0] for h in b})
              for a, b in zip(rows, oracle_rows)) / denom
    assert rec >= 0.8, rec

    # self-recall tune must not pick a LARGER nprobe than the hard tune on
    # this corpus (held-out queries are at least as hard as self queries)
    db2_nprobe = db.index.tune_nprobe(k=10, target_recall=0.9)
    assert out["nprobe"] >= db2_nprobe, (out["nprobe"], db2_nprobe)


def test_add_documents_pipelined_matches_sequential(rng):
    """Pipelined bulk ingest (overlapped batches; db.py
    add_documents_pipelined) must land the same corpus state as sequential
    batch_add_documents: every id present, searchable, store-backed."""
    db = VectorDatabase(config=small_config())
    docs = make_docs(300, prefix="pp")
    for d in docs:
        d.vector = rng.standard_normal(32).astype(np.float32)
    ids = db.add_documents_pipelined(docs, batch_size=64, inflight=3)
    assert ids == [d.id for d in docs]
    assert db.stats().document_count == 300
    # searchable through the public path, store row present
    hits = db.vector_search(SearchRequest(
        vector=list(map(float, docs[7].vector)), limit=3))
    assert hits and hits[0].id == "pp-7"
    rec = db.store.get("pp-299")
    assert rec is not None and rec.embedding is not None
    # single-batch / inflight=1 degenerate forms
    db2 = VectorDatabase(config=small_config())
    assert db2.add_documents_pipelined([], batch_size=8) == []
    more = make_docs(10, prefix="q")
    for d in more:
        d.vector = rng.standard_normal(32).astype(np.float32)
    assert len(db2.add_documents_pipelined(more, batch_size=64,
                                           inflight=1)) == 10


def test_add_documents_pipelined_propagates_errors(rng):
    """A failing batch (bad dimension) must raise out of the pipelined
    call, not vanish on a worker thread."""
    db = VectorDatabase(config=small_config())
    docs = make_docs(120, prefix="er")
    for d in docs:
        d.vector = rng.standard_normal(32).astype(np.float32)
    docs[70].vector = rng.standard_normal(16).astype(np.float32)  # wrong dim
    with pytest.raises(Exception):
        db.add_documents_pipelined(docs, batch_size=32, inflight=2)
