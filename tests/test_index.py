"""Index-layer tests: upsert/delete/search on FlatDeviceIndex and
BinaryDeviceIndex, growth across capacity buckets, recall vs oracle."""

import numpy as np
import pytest

from grape_vector_db_tpu.index import FlatDeviceIndex, BinaryDeviceIndex


def make_data(rng, n, d):
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"doc-{i}" for i in range(n)]
    return ids, vecs


def oracle_topk(qs, ids, vecs, k):
    qn = qs / np.maximum(np.linalg.norm(qs, axis=-1, keepdims=True), 1e-12)
    vn = vecs / np.maximum(np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-12)
    scores = qn @ vn.T
    out = []
    for row in scores:
        order = np.argsort(-row)[:k]
        out.append([ids[i] for i in order])
    return out


@pytest.mark.parametrize("cls", [FlatDeviceIndex, BinaryDeviceIndex])
def test_crud_roundtrip(rng, cls):
    idx = cls(dimension=32, storage_dtype="float32", initial_capacity=64)
    ids, vecs = make_data(rng, 50, 32)
    idx.add_batch(ids, vecs)
    assert len(idx) == 50
    got = idx.get_vector("doc-7")
    np.testing.assert_allclose(got, vecs[7], rtol=1e-6)

    # overwrite an id in place
    new_vec = rng.standard_normal(32).astype(np.float32)
    idx.add("doc-7", new_vec)
    assert len(idx) == 50
    np.testing.assert_allclose(idx.get_vector("doc-7"), new_vec, rtol=1e-6)

    assert idx.remove("doc-7")
    assert not idx.remove("doc-7")
    assert len(idx) == 49
    assert idx.get_vector("doc-7") is None
    # removed doc never comes back in search
    hits = idx.search(new_vec, k=10)
    assert all(h[0] != "doc-7" for h in hits)


def test_flat_exact_recall(rng):
    idx = FlatDeviceIndex(dimension=48, storage_dtype="float32", initial_capacity=256)
    ids, vecs = make_data(rng, 200, 48)
    idx.add_batch(ids, vecs)
    qs = rng.standard_normal((8, 48)).astype(np.float32)
    got = idx.search_batch(qs, k=10)
    want = oracle_topk(qs, ids, vecs, 10)
    for g, w in zip(got, want):
        assert [h[0] for h in g] == w  # exact search: identical ranking


def test_growth_across_buckets(rng):
    idx = FlatDeviceIndex(dimension=16, storage_dtype="float32", initial_capacity=64)
    ids, vecs = make_data(rng, 500, 16)
    for start in range(0, 500, 100):
        idx.add_batch(ids[start:start + 100], vecs[start:start + 100])
    assert len(idx) == 500
    assert idx.capacity >= 512
    got_ids, got_vecs = idx.get_all()
    assert got_ids == ids
    np.testing.assert_allclose(got_vecs, vecs, rtol=1e-6)


def test_slot_reuse_after_delete(rng):
    idx = FlatDeviceIndex(dimension=16, storage_dtype="float32", initial_capacity=64)
    ids, vecs = make_data(rng, 40, 16)
    idx.add_batch(ids, vecs)
    idx.remove_batch(ids[:20])
    ids2 = [f"new-{i}" for i in range(20)]
    vecs2 = rng.standard_normal((20, 16)).astype(np.float32)
    idx.add_batch(ids2, vecs2)
    assert len(idx) == 40
    assert idx.capacity == 64  # tombstoned slots were recycled, no growth
    hits = idx.search(vecs2[3], k=1)
    assert hits[0][0] == "new-3"


def test_binary_two_stage_recall(rng):
    """Two-stage (Hamming pre-scan + rescore) must beat Hamming-only recall by a
    wide margin — the reference's pure-Hamming recall@5 was 17%
    (docs/week5-6-binary-quantization.md:62)."""
    d, n, k = 128, 2000, 5
    idx = BinaryDeviceIndex(
        dimension=d, storage_dtype="float32", initial_capacity=2048,
        rescore_ratio=0.5, max_rescore=1024,
    )
    ids, vecs = make_data(rng, n, d)
    idx.add_batch(ids, vecs)
    qs = vecs[:32] + 0.05 * rng.standard_normal((32, d)).astype(np.float32)
    want = oracle_topk(qs, ids, vecs, k)

    two_stage = idx.search_batch(qs, k=k)
    ham_only = idx.hamming_only_topk(qs, k=k)

    def recall(got):
        hit = sum(len(set(h[0] for h in g) & set(w)) for g, w in zip(got, want))
        return hit / (len(want) * k)

    r2, r1 = recall(two_stage), recall(ham_only)
    assert r2 >= 0.95, f"two-stage recall {r2}"
    assert r2 > r1, f"rescoring should improve over hamming-only ({r2} vs {r1})"


def test_binary_asym_prescan_beats_hamming_at_equal_budget(rng):
    """The default asymmetric prescan — dot(q_unit, sign(x)), the same
    matmul as Hamming but with the real-valued query (ops/hamming.py
    asym_topk) — must rank candidates at least as well as the symmetric
    Hamming prescan at the same (small) rescore budget on an isotropic
    corpus, and self-match exactly
    (recall@10 0.426/0.679/0.884 vs 0.170/0.330/0.554 at budgets
    64/256/1024 on 131k random)."""
    d, n, k = 128, 4096, 10
    ids, vecs = make_data(rng, n, d)
    qs = vecs[:32] + 0.05 * rng.standard_normal((32, d)).astype(np.float32)
    want = oracle_topk(qs, ids, vecs, k)

    def recall(got):
        hit = sum(len(set(h[0] for h in g) & set(w)) for g, w in zip(got, want))
        return hit / (len(want) * k)

    rs = {}
    for prescan in ("asym", "hamming"):
        idx = BinaryDeviceIndex(
            dimension=d, storage_dtype="float32", initial_capacity=4096,
            rescore_ratio=0.01, max_rescore=64, prescan=prescan,
        )
        idx.add_batch(ids, vecs)
        rs[prescan] = recall(idx.search_batch(qs, k=k))
        # exact self-match through the asym path too
        self_hits = idx.search_batch(vecs[:8], k=1)
        assert [h[0][0] for h in self_hits] == ids[:8], prescan
    assert rs["asym"] >= rs["hamming"], rs
    assert rs["asym"] >= 0.6, rs  # tight budget, asym holds useful recall


def test_binary_codes_only_asym_ranking(rng):
    """Codes-only capacity config with the asym prescan: ranking is
    dot(q_unit, sign(x))/sqrt(D) — scores in [-1, 1], self-match first,
    and recall beats the Hamming-only ranking of the same codes."""
    d, n, k = 128, 2000, 5
    ids, vecs = make_data(rng, n, d)
    idx = BinaryDeviceIndex(d, storage_dtype="float32", initial_capacity=2048,
                            keep_vectors=False, prescan="asym")
    idx.add_batch(ids, vecs)
    qs = vecs[:16] + 0.02 * rng.standard_normal((16, d)).astype(np.float32)
    want = oracle_topk(qs, ids, vecs, k)
    got = idx.search_batch(qs, k=k)
    ham = idx.hamming_only_topk(qs, k=k)

    def recall(rows):
        hit = sum(len(set(h[0] for h in g) & set(w)) for g, w in zip(rows, want))
        return hit / (len(want) * k)

    for row in got:
        assert all(-1.001 <= h[1] <= 1.001 for h in row)
    assert recall(got) >= recall(ham), (recall(got), recall(ham))


def test_duplicate_ids_in_batch_last_wins(rng):
    idx = FlatDeviceIndex(dimension=8, storage_dtype="float32", initial_capacity=64)
    v1 = rng.standard_normal(8).astype(np.float32)
    v2 = rng.standard_normal(8).astype(np.float32)
    idx.add_batch(["a", "a"], np.stack([v1, v2]))
    assert len(idx) == 1
    np.testing.assert_allclose(idx.get_vector("a"), v2, rtol=1e-6)


def test_dimension_mismatch(rng):
    from grape_vector_db_tpu.errors import DimensionMismatchError
    idx = FlatDeviceIndex(dimension=8, storage_dtype="float32")
    with pytest.raises(DimensionMismatchError):
        idx.add_batch(["a"], rng.standard_normal((1, 9)).astype(np.float32))


# -- int8 two-stage (bandwidth play; no reference analog) ---------------------------


def test_int8_index_matches_exact_oracle(rng):
    from grape_vector_db_tpu.index.int8 import Int8DeviceIndex

    dim, n, k = 48, 3000, 10
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"r{i}" for i in range(n)]
    idx = Int8DeviceIndex(dim, storage_dtype="float32", initial_capacity=4096,
                          rescore=64)
    idx.add_batch(ids, vecs)
    queries = vecs[:16] + 0.01 * rng.standard_normal((16, dim)).astype(np.float32)

    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    oracle = np.argsort(-(qn @ vn.T), axis=1)[:, :k]

    hits = idx.search_batch(queries, k)
    recall = np.mean([
        len({h[0] for h in row} & {f"r{j}" for j in want}) / k
        for row, want in zip(hits, oracle)
    ])
    assert recall >= 0.99, recall

    # upsert/delete round trip through the int8 code arrays
    idx.remove_batch(["r5"])
    assert all(h[0] != "r5" for h in idx.search_batch(vecs[5:6], 5)[0])
    idx.add_batch(["r5"], vecs[5:6])
    assert idx.search_batch(vecs[5:6], 1)[0][0][0] == "r5"

    # masked filtered search (mask folds into the int8 pre-scan)
    allowed = {"r1", "r2", "r77"}
    got = idx.search_batch(queries[:1], 3, mask=idx.compile_mask(allowed))[0]
    assert {h[0] for h in got} == allowed


def test_int8_index_dot_metric_keeps_row_magnitudes(rng):
    """Regression: the int8 stage-1 factor baked in the cosine norm division
    unconditionally, so metric='dot' selected candidates by cosine and the
    exact-dot rescore never saw high-norm rows."""
    from grape_vector_db_tpu.index.flat import FlatDeviceIndex
    from grape_vector_db_tpu.index.int8 import Int8DeviceIndex

    dim, n, k = 48, 2000, 10
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    # spread norms over two orders of magnitude so cosine != dot ordering
    vecs *= (10.0 ** rng.uniform(-1, 1, size=(n, 1))).astype(np.float32)
    ids = [f"r{i}" for i in range(n)]
    idx = Int8DeviceIndex(dim, metric="dot", storage_dtype="float32",
                          initial_capacity=2048, rescore=64)
    idx.add_batch(ids, vecs)
    ref = FlatDeviceIndex(dim, metric="dot", storage_dtype="float32",
                          initial_capacity=2048)
    ref.add_batch(ids, vecs)

    queries = rng.standard_normal((8, dim)).astype(np.float32)
    got = idx.search_batch(queries, k)
    want = ref.search_batch(queries, k)
    recall = np.mean([
        len({h[0] for h in g} & {h[0] for h in w}) / k
        for g, w in zip(got, want)
    ])
    assert recall >= 0.9, recall


def test_int8_index_rejects_euclidean():
    from grape_vector_db_tpu.index.int8 import Int8DeviceIndex

    with pytest.raises(ValueError):
        Int8DeviceIndex(16, metric="euclidean", storage_dtype="float32")


def test_padded_scatter_writes_no_phantom_slots(rng):
    """Regression: scatter padding used fill=-1, and JAX scatter wraps
    negative indices BEFORE mode='drop' checks bounds — every padded batch
    wrote a phantom valid zero-vector into the LAST slot (flat) / last cell
    of the last list (IVF recip plane), silently eating one result slot."""
    import jax.numpy as jnp

    from grape_vector_db_tpu.index.flat import FlatDeviceIndex
    from grape_vector_db_tpu.index.ivf import IvfDeviceIndex

    idx = FlatDeviceIndex(16, storage_dtype="float32", initial_capacity=128)
    idx.add_batch(["a", "b", "c"], rng.standard_normal((3, 16)).astype(np.float32))
    valid = np.asarray(idx.valid)
    assert valid.sum() == 3 and not valid[-1]

    ivf = IvfDeviceIndex(16, storage_dtype="float32", nlist=4, nprobe=4)
    vecs = rng.standard_normal((40, 16)).astype(np.float32)
    ivf.add_batch([f"r{i}" for i in range(40)], vecs)
    # 40 docs pad to 64: the phantom would land at (last list, last cell)
    assert np.asarray(ivf.valid).sum() == 40
    assert float(np.asarray(ivf.recip)[-1, -1]) == 0.0


def test_binary_capacity_config_codes_only(rng):
    """keep_vectors=False: only packed codes resident (32x), Hamming ranking,
    sign-vector reconstruction, deletes/growth work without the bf16 plane."""
    from grape_vector_db_tpu.index.binary import BinaryDeviceIndex

    d, n = 64, 600
    centers = rng.standard_normal((12, d)).astype(np.float32) * 3
    pts = np.concatenate(
        [c + 0.3 * rng.standard_normal((50, d)).astype(np.float32) for c in centers])
    ids = [f"b{i}" for i in range(len(pts))]
    idx = BinaryDeviceIndex(d, storage_dtype="float32", initial_capacity=256,
                            keep_vectors=False)
    idx.add_batch(ids, pts)   # grows 256 -> 1024 without a vectors plane
    assert idx.vectors is None and idx.capacity >= n

    # Hamming ranking retrieves the right cluster (sign structure survives)
    hits = idx.search_batch(pts[7:8], 10)[0]
    assert hits, "no hits"
    got_cluster = {int(h[0][1:]) // 50 for h in hits}
    assert 0 in got_cluster, hits[:3]
    assert all(0.0 <= h[1] <= 1.0 for h in hits)  # similarity = 1 - d/D

    # delete + re-add against the codes-only planes
    assert idx.remove_batch(["b7"]) == 1
    hits = idx.search_batch(pts[7:8], 5)[0]
    assert all(h[0] != "b7" for h in hits)

    # reconstruction: unit-norm sign vector, positively correlated
    v = idx.get_vector("b8")
    assert v is not None and abs(np.linalg.norm(v) - 1.0) < 1e-5
    cos = float(v @ pts[8] / np.linalg.norm(pts[8]))
    assert cos > 0.5, cos

    # 32x memory claim realized
    st = idx.get_stats()
    assert st.extra["keep_vectors"] == 0.0
    assert st.memory_usage_mb < 0.012 * idx.capacity / 100  # ~9 B/row at 64-d


def test_binary_capacity_config_snapshot_roundtrip(rng, tmp_path):
    """save_index/load_index on the codes-only config: the snapshot stores
    the RECONSTRUCTED sign vectors (the full-precision originals are gone by
    design), so a reload must preserve Hamming ranking exactly — signs of
    sign-vectors are the signs themselves."""
    from grape_vector_db_tpu import Document, VectorDatabase, VectorDbConfig

    d = 64
    cfg = VectorDbConfig(vector_dimension=d)
    cfg.device.storage_dtype = "float32"
    cfg.index.kind = "binary"
    cfg.index.initial_capacity = 512
    cfg.quantization.keep_vectors = False
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    centers = rng.standard_normal((6, d)).astype(np.float32) * 3
    pts = np.concatenate(
        [c + 0.3 * rng.standard_normal((40, d)).astype(np.float32)
         for c in centers])
    db.batch_add_documents([
        Document(id=f"b{i}", content=f"c{i}", vector=pts[i].tolist())
        for i in range(len(pts))])
    before = db.index.search_batch(pts[5:6], 10)[0]

    p = str(tmp_path / "bq.gvdb")
    db.save_index(p)
    db2 = VectorDatabase(config=cfg)
    db2.load_index(p)
    after = db2.index.search_batch(pts[5:6], 10)[0]
    assert [h[0] for h in after] == [h[0] for h in before], (before, after)
    assert all(abs(a[1] - b[1]) < 1e-6 for a, b in zip(after, before))


def test_binary_tune_rescore(rng):
    """tune_rescore picks the smallest budget meeting the recall target vs
    the index's own exact oracle, and pins the search path to it."""
    d, n, k = 128, 4000, 10
    idx = BinaryDeviceIndex(
        dimension=d, storage_dtype="float32", initial_capacity=4096,
        rescore_ratio=0.02, max_rescore=64,
    )
    ids, vecs = make_data(rng, n, d)
    idx.add_batch(ids, vecs)

    budget = idx.tune_rescore(k=k, target_recall=0.9, max_budget=2048)
    assert budget >= 64 and budget <= 2048
    assert idx.max_rescore == budget
    assert idx._rescore_count(k) == budget

    # The tuned index must actually deliver the target on held-out noisy
    # queries near the tuning distribution (self-recall protocol).
    qs = vecs[:64] + 0.02 * rng.standard_normal((64, d)).astype(np.float32)
    want = oracle_topk(qs, ids, vecs, k)
    got = idx.search_batch(qs, k=k)
    hit = sum(len(set(h[0] for h in g) & set(w)) for g, w in zip(got, want))
    assert hit / (len(want) * k) >= 0.8, "tuned budget recall regressed"

    # A stricter target must choose a budget at least as large.
    wider = idx.tune_rescore(k=k, target_recall=0.999, max_budget=2048)
    assert wider >= budget

    # Codes-only config has no rescore stage to tune.
    cap = BinaryDeviceIndex(dimension=d, keep_vectors=False,
                            initial_capacity=256)
    with pytest.raises(ValueError):
        cap.tune_rescore()
