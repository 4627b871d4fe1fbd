"""DeviceHashEmbedder: the device-native local text embedder.

The reference's only offline provider is the mock (embeddings.rs:222-266),
whose vectors carry no similarity structure. The device embedder (signed
feature hashing + seeded matmul projection) must be deterministic AND give
lexically-similar texts similar vectors — that's what makes text-only
ingestion produce a usable dense channel without a network dependency.
"""

import numpy as np
import pytest

from grape_vector_db_tpu.config import VectorDbConfig
from grape_vector_db_tpu.db import VectorDatabase
from grape_vector_db_tpu.services.device_embedder import DeviceHashEmbedder
from grape_vector_db_tpu.services.embeddings import create_provider
from grape_vector_db_tpu.types import Document, SearchRequest


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def test_deterministic_across_instances():
    a = DeviceHashEmbedder(dim=128, buckets=4096)
    b = DeviceHashEmbedder(dim=128, buckets=4096)
    va = a.embed_array(["the quick brown fox jumps"])[0]
    vb = b.embed_array(["the quick brown fox jumps"])[0]
    np.testing.assert_array_equal(va, vb)


def test_unit_norm_and_shape():
    emb = DeviceHashEmbedder(dim=96, buckets=2048)
    out = emb.embed_array(["alpha beta gamma", "delta", ""])
    assert out.shape == (3, 96) and out.dtype == np.float32
    assert abs(np.linalg.norm(out[0]) - 1.0) < 1e-3
    # empty text has no features -> zero vector (cosine 0 vs everything)
    assert np.linalg.norm(out[2]) < 1e-6


def test_lexical_similarity_structure():
    emb = DeviceHashEmbedder(dim=256, buckets=8192)
    texts = [
        "distributed vector database with raft consensus replication",
        "a distributed vector database using raft consensus",   # near-dup
        "chocolate cake recipe with vanilla frosting sugar",    # unrelated
    ]
    v = emb.embed_array(texts)
    near = _cos(v[0], v[1])
    far = _cos(v[0], v[2])
    assert near > 0.5, f"near-duplicate texts should be similar, got {near}"
    assert near > far + 0.2, f"similarity must track lexical overlap ({near} vs {far})"


def test_subword_robustness():
    # Shared character n-grams link morphological variants even when the
    # whole-word feature differs.
    emb = DeviceHashEmbedder(dim=256, buckets=8192)
    v = emb.embed_array(["replication manager", "replicating managers",
                         "zebra quartz flux"])
    assert _cos(v[0], v[1]) > _cos(v[0], v[2])


def test_seed_changes_space():
    a = DeviceHashEmbedder(dim=128, buckets=4096, seed=0)
    b = DeviceHashEmbedder(dim=128, buckets=4096, seed=1)
    va = a.embed_array(["same text"])[0]
    vb = b.embed_array(["same text"])[0]
    assert _cos(va, vb) < 0.9


def test_generate_embeddings_matches_array():
    emb = DeviceHashEmbedder(dim=64, buckets=1024)
    lists = emb.generate_embeddings(["hello world"])
    arr = emb.embed_array(["hello world"])
    np.testing.assert_allclose(np.asarray(lists[0], np.float32), arr[0],
                               rtol=1e-6)


def test_factory_and_db_integration():
    cfg = VectorDbConfig(vector_dimension=128)
    cfg.embedding.provider = "device"
    cfg.embedding.hash_buckets = 4096
    cfg.index.initial_capacity = 64
    prov = create_provider(cfg.embedding)
    assert isinstance(prov, DeviceHashEmbedder)

    db = VectorDatabase(config=cfg)
    try:
        # documents without vectors get device-hash embeddings at ingest
        db.batch_add_documents([
            Document(id="raft", content="raft consensus leader election log"),
            Document(id="ivf", content="inverted file coarse quantizer probe"),
            Document(id="cake", content="chocolate cake vanilla frosting"),
        ])
        # stored rows must be ndarray (no per-float boxing on this path)
        rec = db.store.get("raft")
        assert rec is not None and rec.embedding is not None
        # a semantically-adjacent text query lands on the right doc
        res = db.search(SearchRequest(query="raft leader election", limit=1))
        assert res and res[0].document.id == "raft"
        res = db.search(SearchRequest(query="chocolate frosting", limit=1))
        assert res and res[0].document.id == "cake"
    finally:
        db.close()


def test_db_integration_cache_disabled_unwrap():
    # cache disabled -> embedder is the raw provider; the ingest embed_array
    # fast path must work both wrapped (cache on) and bare (cache off)
    cfg = VectorDbConfig(vector_dimension=128)
    cfg.embedding.provider = "device"
    cfg.embedding.hash_buckets = 4096
    cfg.index.initial_capacity = 64
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    try:
        db.batch_add_documents([Document(id="a", content="alpha beta gamma")])
        res = db.search(SearchRequest(query="alpha beta", limit=1))
        assert res and res[0].document.id == "a"
    finally:
        db.close()


@pytest.mark.parametrize("n", [1, 3, 17])
def test_batch_padding_consistency(n):
    # bucketed batch padding must not change per-text results
    emb = DeviceHashEmbedder(dim=64, buckets=1024, chunk=8)
    texts = [f"document number {i} about topic {i % 3}" for i in range(n)]
    batch = emb.embed_array(texts)
    for i, t in enumerate(texts):
        single = emb.embed_array([t])[0]
        np.testing.assert_allclose(batch[i], single, atol=1e-5)


def test_native_featurizer_exact_parity():
    """The C++ gvdb_hash_features loop must reproduce the Python featurizer
    bit-for-bit on ASCII text (same split as the BM25 tokenizer parity)."""
    from grape_vector_db_tpu.services.device_embedder import (
        DeviceHashEmbedder, _native_hash_lib)

    if _native_hash_lib() is None:
        import pytest
        pytest.skip("native toolchain unavailable")

    emb = DeviceHashEmbedder(dim=32, buckets=4096, seed=7, max_features=64)
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "the", "microbatching", "x1", "a_b", "zz",
             "tokenization", "and", "q"]
    texts = []
    for _ in range(200):
        k = int(rng.integers(1, 30))
        texts.append(" ".join(words[int(j)] for j in rng.integers(0, len(words), k)))
    texts += ["", "   ", "the and of", "UPPER Case MIX 123", "_", "<>",
              "a" * 300, ("word " * 100).strip()]

    # force-native vs force-python on identical inputs
    idx_n, val_n = emb._featurize(texts)

    import grape_vector_db_tpu.services.device_embedder as mod
    saved, saved_ready = mod._HASH_LIB, mod._HASH_LIB_READY
    mod._HASH_LIB, mod._HASH_LIB_READY = None, True
    try:
        idx_p, val_p = emb._featurize(texts)
    finally:
        mod._HASH_LIB, mod._HASH_LIB_READY = saved, saved_ready

    np.testing.assert_array_equal(idx_n, idx_p)
    np.testing.assert_array_equal(val_n, val_p)

    # non-ASCII rows route through Python inside the mixed batch
    mixed = ["ascii only here", "中文 内容 ascii", "naïve café"]
    idx_m, val_m = emb._featurize(mixed)
    mod._HASH_LIB, mod._HASH_LIB_READY = None, True
    try:
        idx_mp, val_mp = emb._featurize(mixed)
    finally:
        mod._HASH_LIB, mod._HASH_LIB_READY = saved, saved_ready
    np.testing.assert_array_equal(idx_m, idx_mp)
    np.testing.assert_array_equal(val_m, val_mp)


def test_device_direct_ingest_parity_and_fallbacks():
    """The text-only fast path (embed_ingest + add_batch_device: device
    f32 rows scattered without a host round trip, f16 rows to the store)
    must be search- and store-equivalent to the host path, and mixed /
    duplicate-id batches must take the host path."""
    cfg = VectorDbConfig(vector_dimension=128)
    cfg.embedding.provider = "device"
    cfg.embedding.hash_buckets = 4096
    cfg.index.initial_capacity = 64
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    try:
        texts = [f"theme {i % 5} document body number {i}" for i in range(33)]
        db.batch_add_documents(
            [Document(id=f"t{i}", content=texts[i]) for i in range(33)])
        # stored rows: f16, matching embed_array (same f16 wire) exactly
        ref = db.embedder.embed_array(texts)
        for i in (0, 7, 32):
            rec = db.store.get(f"t{i}")
            emb = np.asarray(rec.embedding, np.float32)
            np.testing.assert_allclose(emb, ref[i], atol=2e-3)
        # index rows live: text query self-match through the full engine
        res = db.search(SearchRequest(query=texts[7], limit=1))
        assert res and res[0].document.id == "t7"
        # mixed batch (one doc carries a vector): host path, still correct
        v = np.zeros(128, np.float32); v[0] = 1.0
        db.batch_add_documents([
            Document(id="mix_v", content="has a vector", vector=v),
            Document(id="mix_t", content="unique zebra xylophone text"),
        ])
        res = db.search(SearchRequest(query="unique zebra xylophone", limit=1))
        assert res and res[0].document.id == "mix_t"
        # duplicate ids in one text-only batch: host path dedupes, last wins
        db.batch_add_documents([
            Document(id="dup", content="first version of the dup doc"),
            Document(id="dup", content="second version wins the slot"),
        ])
        rec = db.store.get("dup")
        assert rec is not None
        assert len(db.index) == 33 + 2 + 1
    finally:
        db.close()
