"""Sparse BM25 + hybrid fusion tests (reference sparse.rs:404-420 BM25 stats,
hybrid.rs:991-1025 RRF ordering property)."""

import numpy as np
import pytest

from grape_vector_db_tpu.engine.hybrid import (
    HybridSearchEngine,
    StatisticalFusionModel,
    classify_query_type,
    extract_snippet,
)
from grape_vector_db_tpu.engine.sparse import SimpleTokenizer, SparseIndex
from grape_vector_db_tpu.index import FlatDeviceIndex
from grape_vector_db_tpu.storage import MemoryDocumentStore
from grape_vector_db_tpu.types import (
    DocumentRecord,
    FusionStrategy,
    HybridSearchRequest,
    QueryMetrics,
)


def test_tokenizer_stopwords_and_cjk():
    t = SimpleTokenizer()
    toks = t.tokenize("The quick Brown fox AND the dog")
    assert "the" not in toks and "and" not in toks
    assert "quick" in toks and "brown" in toks
    toks_zh = t.tokenize("向量数据库")
    assert "向" in toks_zh and "量" in toks_zh


def test_bm25_ranks_relevant_doc_first():
    idx = SparseIndex()
    idx.add_document("d1", "rust systems programming language memory safety")
    idx.add_document("d2", "python scripting language easy")
    idx.add_document("d3", "cooking recipes pasta italian")
    hits = idx.search_bm25("rust memory safety", limit=3)
    assert hits[0][0] == "d1"
    assert all(h[1] >= hits[-1][1] for h in hits)


def test_bm25_incremental_avg_doc_len():
    idx = SparseIndex()
    idx.add_document("a", "one two three four")
    idx.add_document("b", "five six")
    avg1 = idx.avg_doc_len
    idx.remove_document("b")
    assert idx.avg_doc_len != avg1
    assert len(idx) == 1


def test_postings_churn_matches_bruteforce_oracle():
    """Interleaved batch-add / per-doc add / upsert / remove / search must
    match a from-scratch rebuild exactly — exercises the chunked-posting
    write paths, the cached view invalidation, tombstones, and compaction
    (the 25% threshold trips several times under this churn)."""
    rng = np.random.default_rng(7)
    words = [f"w{j}" for j in range(40)]

    def text(i):
        picks = rng.choice(len(words), size=6)
        return f"doc number {i} " + " ".join(words[p] for p in picks)

    idx = SparseIndex()
    alive = {}
    next_id = 0
    for step in range(60):
        op = rng.integers(0, 4)
        if op == 0:  # batch add (native path)
            ids, txts = [], []
            for _ in range(int(rng.integers(8, 30))):
                ids.append(f"d{next_id}")
                txts.append(text(next_id))
                next_id += 1
            idx.add_documents(ids, txts)
            alive.update(zip(ids, txts))
        elif op == 1:  # per-doc add (tail-buffer path)
            did, t = f"d{next_id}", text(next_id)
            next_id += 1
            idx.add_document(did, t)
            alive[did] = t
        elif op == 2 and alive:  # upsert an existing doc
            did = list(alive)[int(rng.integers(0, len(alive)))]
            t = text(int(did[1:]) + 1000)
            idx.add_documents([did], [did + " changed " + t])
            # small batches fall back to per-doc adds; both paths are churned
            alive[did] = did + " changed " + t
        elif alive:  # remove (may trigger compaction)
            for _ in range(min(len(alive), int(rng.integers(1, 6)))):
                did = list(alive)[int(rng.integers(0, len(alive)))]
                idx.remove_document(did)
                del alive[did]
        if step % 7 == 0 and alive:
            oracle = SparseIndex()
            for did, t in alive.items():
                oracle.add_document(did, t)
            q = f"{words[int(rng.integers(0, len(words)))]} number"
            got = idx.search_bm25(q, limit=10)
            want = oracle.search_bm25(q, limit=10)
            # tie order is handle-order-dependent (upserts re-handle docs),
            # so compare the score multiset and per-id scores, not the order
            gs = sorted(s for _, s in got)
            ws = sorted(s for _, s in want)
            assert len(gs) == len(ws), (step, got, want)
            assert all(abs(a - b) < 1e-9 for a, b in zip(gs, ws)), (step, got, want)
            wmap = dict(want)
            for did, s in got:
                if did in wmap:
                    assert abs(s - wmap[did]) < 1e-9, (step, did, s, wmap[did])
    assert len(idx) == len(alive)


def test_bm25_delete_then_compact():
    idx = SparseIndex()
    for i in range(20):
        idx.add_document(f"d{i}", f"token{i} shared common words here")
    for i in range(10):
        idx.remove_document(f"d{i}")
    hits = idx.search_bm25("token5", limit=5)
    assert all(h[0] != "d5" for h in hits)
    hits = idx.search_bm25("token15", limit=5)
    assert hits and hits[0][0] == "d15"


def test_sparse_vector_roundtrip():
    idx = SparseIndex()
    idx.build_vocabulary(["alpha beta gamma", "delta alpha"])
    sv = idx.document_to_sparse_vector("alpha alpha beta")
    assert len(sv.indices) == 2
    assert abs(sum(sv.values) - 1.0) < 1e-9  # relative term frequencies


def make_hybrid(rng):
    store = MemoryDocumentStore()
    index = FlatDeviceIndex(dimension=16, storage_dtype="float32", initial_capacity=64)
    sparse = SparseIndex()
    contents = {
        "d1": "machine learning on gpu hardware",
        "d2": "cooking pasta with tomato sauce",
        "d3": "gpu kernels and machine learning compilers",
        "d4": "gardening tips for spring",
    }
    vecs = {k: rng.standard_normal(16).astype(np.float32) for k in contents}
    vecs["d3"] = vecs["d1"] + 0.01 * rng.standard_normal(16).astype(np.float32)
    for k, c in contents.items():
        store.insert(DocumentRecord(id=k, content=c, embedding=vecs[k].tolist()))
        sparse.add_document(k, c)
        index.add(k, vecs[k])
    return HybridSearchEngine(index, sparse, store), vecs


@pytest.mark.parametrize("strategy", list(FusionStrategy))
def test_hybrid_all_strategies(rng, strategy):
    eng, vecs = make_hybrid(rng)
    req = HybridSearchRequest(
        query="machine learning gpu",
        dense_vector=vecs["d1"].tolist(),
        limit=3,
        fusion_strategy=strategy,
    )
    res = eng.search(req)
    assert res
    ids = [r.document.id for r in res]
    # multi-channel winners: d1/d3 are both dense- and sparse-relevant
    assert ids[0] in ("d1", "d3")
    assert res[0].breakdown is not None
    assert res[0].breakdown.final_score == res[0].score
    # descending
    assert all(res[i].score >= res[i + 1].score for i in range(len(res) - 1))


def test_rrf_multi_list_outranks_single_list(rng):
    """RRF property test (hybrid.rs:991-1025): a doc appearing in multiple
    channels outranks a doc in only one."""
    eng, vecs = make_hybrid(rng)
    req = HybridSearchRequest(
        query="machine learning",  # d1, d3 in sparse+text; dense favors d1/d3 too
        dense_vector=vecs["d1"].tolist(),
        limit=4,
        fusion_strategy=FusionStrategy.RRF,
    )
    res = eng.search(req)
    ids = [r.document.id for r in res]
    assert ids.index("d1") < ids.index("d2") if "d2" in ids else True
    assert "d1" in ids and "d3" in ids


def test_learned_fusion_updates():
    model = StatisticalFusionModel(learning_rate=0.2)
    w0 = model.weights_for("keyword")
    for _ in range(5):
        model.update("keyword", satisfaction=1.0)
    w1 = model.weights_for("keyword")
    assert w1.sparse > w0.sparse  # dominant channel reinforced
    assert abs(w1.dense + w1.sparse + w1.text - 1.0) < 1e-9


def test_adaptive_feedback_drift(rng):
    eng, _ = make_hybrid(rng)
    before = eng.get_stats()["adaptive_dense"]
    for _ in range(10):
        eng.record_query_metrics(
            QueryMetrics(query="machine learning", strategy="adaptive", satisfaction=0.0)
        )
    after = eng.get_stats()["adaptive_dense"]
    assert after < before  # unsatisfied -> dominant (dense) channel loses weight


def test_classify_query_type():
    assert classify_query_type("what is a gpu?") == "question"
    assert classify_query_type("gpu") == "keyword"
    assert classify_query_type("def foo(x): return x") == "code"
    assert classify_query_type("find documents about large scale systems") == "semantic"


def test_extract_snippet():
    content = "a" * 200 + " needle " + "b" * 200
    s = extract_snippet(content, ["needle"], window=20)
    assert "needle" in s and s.startswith("…") and s.endswith("…")
    assert extract_snippet("short text", ["missing"]) == "short text"


def test_native_tokenizer_matches_python():
    """native/gvdb_text.cpp must implement the EXACT ASCII SimpleTokenizer
    semantics (lowercase [a-z0-9_]+ runs, EN stopwords, counts); non-ASCII
    and custom-stopword tokenizers stay on the Python path."""
    import random
    import string
    from collections import Counter

    from grape_vector_db_tpu.engine.sparse import (
        SimpleTokenizer,
        _native_term_counts,
        _native_text_lib,
    )

    lib = _native_text_lib()
    if lib is None:
        import pytest

        pytest.skip("native toolchain unavailable")
    tk = SimpleTokenizer()
    rng = random.Random(7)
    for _ in range(200):
        n = rng.randint(0, 150)
        text = "".join(rng.choice(string.ascii_letters + string.digits +
                                  " _.,-!?\t\n") for _ in range(n))
        toks = tk.tokenize(text)
        assert _native_term_counts(lib, text) == (Counter(toks), len(toks))

    # non-ASCII falls back to Python (CJK chars still tokenized)
    c, t = tk.term_frequencies("深度 learning 模型")
    assert c["learning"] == 1 and c["深"] == 1 and t >= 3

    # custom stopword sets bypass the native loop
    tk2 = SimpleTokenizer(stopwords={"learning"})
    c2, _ = tk2.term_frequencies("learning models")
    assert "learning" not in c2 and c2["models"] == 1
