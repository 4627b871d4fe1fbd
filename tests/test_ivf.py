"""IVF index tests: k-means, probing recall, overflow spill, optimize repack."""

import numpy as np
import pytest
import jax.numpy as jnp

from grape_vector_db_tpu.index.ivf import IvfDeviceIndex
from grape_vector_db_tpu.index import FlatDeviceIndex
from grape_vector_db_tpu.ops.kmeans import kmeans, assign_clusters


def clustered_data(rng, n_clusters=8, per=100, d=32, spread=0.05):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 3
    pts = np.concatenate(
        [c + spread * rng.standard_normal((per, d)).astype(np.float32) for c in centers]
    )
    return centers, pts


def test_kmeans_recovers_clusters(rng):
    centers, pts = clustered_data(rng)
    cents, assign = kmeans(jnp.asarray(pts), k=8, iters=15)
    cents, assign = np.asarray(cents), np.asarray(assign)
    # every true cluster should map to one recovered centroid (within spread)
    d = np.linalg.norm(centers[:, None, :] - cents[None, :, :], axis=-1)
    assert (d.min(axis=1) < 0.5).all()
    # points in the same true cluster get the same label (overwhelmingly)
    labels = assign.reshape(8, 100)
    agree = (labels == np.median(labels, axis=1, keepdims=True)).mean()
    assert agree > 0.95


def test_ivf_recall_on_clustered_data(rng):
    _, pts = clustered_data(rng, n_clusters=16, per=64)
    ids = [f"p{i}" for i in range(len(pts))]
    ivf = IvfDeviceIndex(32, storage_dtype="float32", nlist=16, nprobe=4,
                         initial_capacity=2048)
    flat = FlatDeviceIndex(32, storage_dtype="float32", initial_capacity=2048)
    ivf.add_batch(ids, pts)
    flat.add_batch(ids, pts)
    assert ivf.is_trained
    qs = pts[::97][:8] + 0.01 * rng.standard_normal((8, 32)).astype(np.float32)
    got = ivf.search_batch(qs, 10)
    want = flat.search_batch(qs, 10)
    recall = np.mean([
        len({h[0] for h in g} & {h[0] for h in w}) / 10 for g, w in zip(got, want)
    ])
    assert recall >= 0.9, f"ivf recall {recall}"


def test_ivf_untrained_falls_back_to_exact(rng):
    ivf = IvfDeviceIndex(16, storage_dtype="float32", nlist=32, nprobe=4)
    vecs = rng.standard_normal((20, 16)).astype(np.float32)  # < nlist*4: stays flat
    ivf.add_batch([f"a{i}" for i in range(20)], vecs)
    assert not ivf.is_trained
    hits = ivf.search_batch(vecs[3:4], 3)[0]
    assert hits[0][0] == "a3"


def test_ivf_auto_train_absorbs_backlog(rng):
    ivf = IvfDeviceIndex(16, storage_dtype="float32", nlist=8, nprobe=8,
                         initial_capacity=1024)
    vecs = rng.standard_normal((100, 16)).astype(np.float32)
    ivf.add_batch([f"a{i}" for i in range(10)], vecs[:10])   # backlog
    assert not ivf.is_trained
    ivf.add_batch([f"a{i}" for i in range(10, 100)], vecs[10:])  # triggers train
    assert ivf.is_trained
    assert len(ivf) == 100
    hits = ivf.search_batch(vecs[5:6], 1)[0]  # backlog point is searchable
    assert hits[0][0] == "a5"


def test_ivf_delete_upsert(rng):
    _, pts = clustered_data(rng, n_clusters=8, per=16, d=16)
    ivf = IvfDeviceIndex(16, storage_dtype="float32", nlist=8, nprobe=8)
    ids = [f"p{i}" for i in range(len(pts))]
    ivf.add_batch(ids, pts)
    assert ivf.remove_batch(["p0", "p1"]) == 2
    assert len(ivf) == len(pts) - 2
    hits = ivf.search_batch(pts[0:1], 5)[0]
    assert all(h[0] != "p0" for h in hits)
    # upsert new vector under existing id
    newv = rng.standard_normal(16).astype(np.float32)
    ivf.add_batch(["p2"], newv[None])
    np.testing.assert_allclose(ivf.get_vector("p2"), newv, rtol=1e-5)
    assert len(ivf) == len(pts) - 2


def test_ivf_overflow_spill_and_optimize(rng):
    # tiny list_cap forces spill into the overflow region
    ivf = IvfDeviceIndex(16, storage_dtype="float32", nlist=4, nprobe=4,
                         initial_capacity=256)
    ivf.list_cap = 32
    ivf._alloc(32)
    # one tight cluster: everything lands in one list -> overflow
    base = rng.standard_normal(16).astype(np.float32)
    pts = base + 0.01 * rng.standard_normal((200, 16)).astype(np.float32)
    ids = [f"p{i}" for i in range(200)]
    ivf.add_batch(ids, pts)
    assert len(ivf) == 200
    assert ivf.get_stats().extra["overflow"] > 0
    hits = ivf.search_batch(pts[150:151], 3)[0]
    assert hits[0][0] == "p150"  # overflow points are found exactly
    ivf.optimize()
    assert len(ivf) == 200
    assert ivf.get_stats().extra["overflow"] == 0  # repack absorbed the spill
    hits = ivf.search_batch(pts[150:151], 3)[0]
    assert hits[0][0] == "p150"


# -- product quantization ---------------------------------------------------------


def test_pq_train_encode_roundtrip(rng):
    import jax.numpy as jnp
    from grape_vector_db_tpu.ops.pq import train_pq, encode_pq

    vecs = rng.standard_normal((2000, 32)).astype(np.float32)
    books = train_pq(jnp.asarray(vecs), n_sub=4, nbits=8, iters=6)
    assert books.shape == (4, 256, 8)
    codes = np.asarray(encode_pq(jnp.asarray(vecs[:50]), books))
    assert codes.shape == (50, 4) and codes.dtype == np.uint8
    # reconstruction from codewords is closer to the original than random
    recon = np.concatenate(
        [np.asarray(books)[s, codes[:, s]] for s in range(4)], axis=1
    )
    err = np.linalg.norm(recon - vecs[:50], axis=1).mean()
    base = np.linalg.norm(vecs[:50] - vecs[50:100], axis=1).mean()
    assert err < base * 0.8


def test_pq_index_recall(rng):
    from grape_vector_db_tpu.index.pq import PqDeviceIndex
    from grape_vector_db_tpu.index import FlatDeviceIndex

    d, n, k = 64, 3000, 10
    pq = PqDeviceIndex(d, storage_dtype="float32", initial_capacity=4096,
                       n_sub=8, rescore_ratio=0.1, train_threshold=1024)
    flat = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=4096)
    ids = [f"p{i}" for i in range(n)]
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    pq.add_batch(ids, vecs)
    flat.add_batch(ids, vecs)
    assert pq.is_trained

    qs = vecs[:16] + 0.05 * rng.standard_normal((16, d)).astype(np.float32)
    got = pq.search_batch(qs, k)
    want = flat.search_batch(qs, k)
    recall = np.mean([
        len({h[0] for h in g} & {h[0] for h in w}) / k for g, w in zip(got, want)
    ])
    assert recall >= 0.8, f"pq+rescore recall {recall}"
    # self-retrieval exact
    assert got[0][0][0] == "p0"


def test_pq_untrained_falls_back_exact(rng):
    from grape_vector_db_tpu.index.pq import PqDeviceIndex

    pq = PqDeviceIndex(16, storage_dtype="float32", train_threshold=100000)
    vecs = rng.standard_normal((50, 16)).astype(np.float32)
    pq.add_batch([f"x{i}" for i in range(50)], vecs)
    assert not pq.is_trained
    hits = pq.search_batch(vecs[7:8], 3)[0]
    assert hits[0][0] == "x7"


def test_ivf_pq_recall(rng):
    from grape_vector_db_tpu.index.ivf_pq import IvfPqDeviceIndex

    d, n, k = 64, 4000, 10
    _, pts = clustered_data(rng, n_clusters=32, per=125, d=d, spread=0.3)
    ids = [f"p{i}" for i in range(len(pts))]
    ivfpq = IvfPqDeviceIndex(d, storage_dtype="float32", nlist=32, nprobe=8,
                             n_sub=8, rescore_k=256, initial_capacity=4096)
    flat = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=4096)
    ivfpq.add_batch(ids, pts)
    flat.add_batch(ids, pts)
    assert ivfpq.is_trained and ivfpq.codebooks is not None

    qs = pts[::71][:16] + 0.02 * rng.standard_normal((16, d)).astype(np.float32)
    got = ivfpq.search_batch(qs, k)
    want = flat.search_batch(qs, k)
    recall = np.mean([
        len({h[0] for h in g} & {h[0] for h in w}) / k for g, w in zip(got, want)
    ])
    assert recall >= 0.85, f"ivf-pq recall {recall}"
    assert got[0][0][1] <= 1.0 + 1e-5  # exact-rescored cosine, not ADC approx


def test_ivf_pq_delete_and_db_mode(rng):
    from grape_vector_db_tpu import Document, SearchRequest, VectorDatabase, VectorDbConfig

    cfg = VectorDbConfig(vector_dimension=32)
    cfg.device.storage_dtype = "float32"
    cfg.index.kind = "ivf_pq"
    cfg.index.nlist = 16
    cfg.index.nprobe = 8
    cfg.index.initial_capacity = 2048
    db = VectorDatabase(config=cfg)
    rng2 = np.random.default_rng(1)
    centers = rng2.standard_normal((16, 32)).astype(np.float32) * 3
    docs = [Document(id=f"d{i}", content=f"c{i}",
                     vector=(centers[i % 16]
                             + 0.1 * rng2.standard_normal(32)).astype(np.float32).tolist())
            for i in range(800)]
    db.batch_add_documents(docs)
    assert db.stats().index_kind == "ivf_pq"
    q = db.get_document("d123").vector
    hits = db.vector_search(SearchRequest(vector=q, limit=3))
    assert hits[0].id == "d123"
    db.delete_document("d123")
    hits = db.vector_search(SearchRequest(vector=q, limit=3))
    assert all(h.id != "d123" for h in hits)


def test_ivf_pallas_probe_interpret_path(rng, interpret_kernels):
    """The probe kernel behind the index (interpret mode on the CPU): same
    ids as the XLA probe, recip-plane maintenance across upsert/delete, and
    masks folded after the kernel."""
    from grape_vector_db_tpu.index.ivf import IvfDeviceIndex

    dim, n, k = 32, 1200, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    a = IvfDeviceIndex(dim, storage_dtype="float32", nlist=8, nprobe=8)
    b = IvfDeviceIndex(dim, storage_dtype="float32", nlist=8, nprobe=8)
    assert not a._use_kernel  # the CPU routes to the XLA probe
    a._use_kernel = True
    a.add_batch(ids, vecs)
    b.add_batch(ids, vecs)
    assert a.recip is not None and a.recip.shape == (8, a.list_cap)
    assert a.list_cap % 128 == 0

    queries = vecs[:6] + 0.01 * rng.standard_normal((6, dim)).astype(np.float32)
    ha = a.search_batch(queries, k)
    hb = b.search_batch(queries, k)
    for ra, rb in zip(ha, hb):
        assert [x[0] for x in ra] == [x[0] for x in rb]

    # delete zeroes the recip plane -> the slot disappears from results
    a.remove_batch(["d3"])
    assert all(h[0] != "d3" for h in a.search_batch(vecs[3:4], k)[0])
    # re-add restores it
    a.add_batch(["d3"], vecs[3:4])
    assert a.search_batch(vecs[3:4], 1)[0][0][0] == "d3"

    # masked search stays on the kernel (the mask folds into the
    # post-kernel selection) and matches the masked XLA path exactly
    allowed = {"d1", "d5", "d9"}
    got = a.search_batch(queries[:1], 3, mask=a.compile_mask(allowed))[0]
    assert {h[0] for h in got} == allowed
    got_xla = b.search_batch(queries[:1], 3, mask=b.compile_mask(allowed))[0]
    assert [h[0] for h in got] == [h[0] for h in got_xla]
    # a wide mask too: kernel+mask == xla+mask on every query
    wide = {f"d{i}" for i in range(0, n, 3)}
    ma, mb = a.compile_mask(wide), b.compile_mask(wide)
    for ra, rb in zip(a.search_batch(queries, k, mask=ma),
                      b.search_batch(queries, k, mask=mb)):
        assert [x[0] for x in ra] == [x[0] for x in rb]


def test_ivf_dot_metric_pallas_parity(rng, interpret_kernels):
    """metric="dot" through the (interpreted) probe kernel must rank by raw
    dots like the XLA probe (regression: the recip plane divided by norm
    unconditionally, returning cosine ranking)."""
    from grape_vector_db_tpu.index.ivf import IvfDeviceIndex

    dim, n, k = 32, 900, 5
    vecs = (rng.standard_normal((n, dim)).astype(np.float32)
            * rng.uniform(0.2, 5.0, (n, 1)).astype(np.float32))
    ids = [f"d{i}" for i in range(n)]
    a = IvfDeviceIndex(dim, metric="dot", storage_dtype="float32",
                       nlist=8, nprobe=8)
    a._use_kernel = True
    b = IvfDeviceIndex(dim, metric="dot", storage_dtype="float32",
                       nlist=8, nprobe=8)
    a.add_batch(ids, vecs)
    b.add_batch(ids, vecs)
    q = vecs[:6]
    for ra, rb in zip(a.search_batch(q, k), b.search_batch(q, k)):
        assert [x[0] for x in ra] == [x[0] for x in rb]
        np.testing.assert_allclose([x[1] for x in ra], [x[1] for x in rb],
                                   rtol=1e-3)


def test_ivf_optimize_keeps_pallas_alignment(rng):
    """optimize() regrows list capacity in 128 multiples, so capacities stay
    on few bucket sizes and the probe kernel's 64-row blocks stay whole
    after a repack (regression: regrow used base=64)."""
    from grape_vector_db_tpu.index.ivf import IvfDeviceIndex

    dim = 32
    idx = IvfDeviceIndex(dim, nlist=4, nprobe=4, initial_capacity=512)
    # skewed data: one heavy cluster forces a capacity regrow on optimize()
    heavy = rng.standard_normal((1, dim)).astype(np.float32) * 5
    rows = np.concatenate([
        heavy + 0.05 * rng.standard_normal((700, dim)).astype(np.float32),
        rng.standard_normal((100, dim)).astype(np.float32),
    ])
    ids = [f"d{i}" for i in range(len(rows))]
    idx.add_batch(ids, rows)
    idx.optimize()
    assert idx.list_cap % 128 == 0, idx.list_cap
    assert idx.search_batch(rows[3:4], 1)[0][0][0] == "d3"


def test_tune_nprobe_meets_recall_target(rng):
    """tune_nprobe picks the smallest probe count whose self-recall@k meets
    the target, measured against the exhaustive probe — the recall/latency
    knob the reference's IndexOptimizer never had."""
    from grape_vector_db_tpu.index.ivf import IvfDeviceIndex

    dim, n = 32, 2000
    centers = rng.standard_normal((16, dim)).astype(np.float32) * 4
    vecs = (centers[rng.integers(0, 16, n)]
            + 0.2 * rng.standard_normal((n, dim)).astype(np.float32))
    idx = IvfDeviceIndex(dim, storage_dtype="float32", nlist=16, nprobe=16)
    idx.add_batch([f"d{i}" for i in range(n)], vecs)

    chosen = idx.tune_nprobe(k=5, target_recall=0.9)
    assert idx.nprobe == chosen and 1 <= chosen <= 16

    # the chosen setting actually delivers the target on fresh queries
    q = vecs[:64] + 0.01 * rng.standard_normal((64, dim)).astype(np.float32)
    saved = idx.nprobe
    idx.nprobe = idx.nlist
    oracle = [set(h[0] for h in row) for row in idx.search_batch(q, 5)]
    idx.nprobe = saved
    got = idx.search_batch(q, 5)
    hits = sum(len(set(h[0] for h in row) & w) for row, w in zip(got, oracle))
    assert hits / sum(len(w) for w in oracle) >= 0.85  # small holdout slack

    # clustered data at nlist=16: the tuner should not need the exhaustive
    # probe to reach 0.9
    assert chosen < 16


@pytest.mark.parametrize("resident", ["bf16", "int8", "none"])
def test_ivf_pq_resident_planes(rng, resident):
    """Residual PQ with each rescore-plane config: bf16 shadow (exact),
    int8 shadow (near-exact, half the plane HBM), none (codes-only capacity
    tier — pure ADC ranking). Data regime has real score margins: on
    near-tie data (score gaps < quantization noise) the quantized ranks
    shuffle — the documented tight-cluster property, not a defect."""
    from grape_vector_db_tpu.index.ivf_pq import IvfPqDeviceIndex

    d, n, k = 64, 4000, 10
    _, pts = clustered_data(rng, n_clusters=32, per=125, d=d, spread=1.0)
    ids = [f"p{i}" for i in range(len(pts))]
    # ADC-only needs code budget for rank resolution (recall scales with
    # n_sub: 8->0.15, 32->0.59, 64->0.88 measured on this corpus)
    n_sub = 32 if resident == "none" else 8
    idx = IvfPqDeviceIndex(d, storage_dtype="float32", nlist=32, nprobe=8,
                           n_sub=n_sub, rescore_k=256, initial_capacity=4096,
                           resident=resident)
    flat = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=4096)
    idx.add_batch(ids, pts)
    flat.add_batch(ids, pts)

    qs = pts[::71][:16] + 0.3 * rng.standard_normal((16, d)).astype(np.float32)
    got = idx.search_batch(qs, k)
    want = flat.search_batch(qs, k)
    recall = np.mean([
        len({h[0] for h in g} & {h[0] for h in w}) / k for g, w in zip(got, want)
    ])
    floor = {"bf16": 0.95, "int8": 0.85, "none": 0.45}[resident]
    assert recall >= floor, f"resident={resident} recall {recall}"

    # delete works against every plane layout
    assert idx.remove_batch(["p7"]) == 1
    got = idx.search_batch(pts[7:8], 3)
    assert all(h[0] != "p7" for h in got[0])

    # capacity configs reconstruct rows for persistence/rebuild
    v = idx.get_vector("p12")
    assert v is not None and v.shape == (d,)
    cos = float(np.dot(v, pts[12]) / (np.linalg.norm(v) * np.linalg.norm(pts[12])))
    assert cos > 0.9, f"reconstruction degraded: cos={cos}"


def test_ivf_pq_residual_beats_plain_adc(rng):
    """Residual coding must improve ADC-only ranking on clustered data —
    the reason it is the default (FAISS IVF-PQ form)."""
    from grape_vector_db_tpu.index.ivf_pq import IvfPqDeviceIndex

    d, n, k = 64, 4000, 10
    _, pts = clustered_data(rng, n_clusters=32, per=125, d=d, spread=1.0)
    # normalize: with spherical (unit-norm) centroids the residual is only
    # meaningful relative to unit-scale data
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    ids = [f"p{i}" for i in range(len(pts))]
    flat = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=4096)
    flat.add_batch(ids, pts)
    qs = pts[::71][:16] + 0.05 * rng.standard_normal((16, d)).astype(np.float32)
    want = flat.search_batch(qs, k)

    recs = {}
    for residual in (False, True):
        idx = IvfPqDeviceIndex(d, storage_dtype="float32", nlist=32, nprobe=8,
                               n_sub=32, initial_capacity=4096,
                               resident="none", residual=residual)
        idx.add_batch(ids, pts)
        got = idx.search_batch(qs, k)
        recs[residual] = np.mean([
            len({h[0] for h in g} & {h[0] for h in w}) / k
            for g, w in zip(got, want)
        ])
    assert recs[True] >= recs[False] - 0.02, recs
    assert recs[True] >= 0.5, recs


def test_kmeans_chunked_matches_unchunked(rng):
    """The chunked scan (bounded [chunk, K] planes for large-nlist training)
    must reach the same fixed point as the unchunked form — same seed, same
    assignments, centroids equal to accumulation-order tolerance."""
    x = rng.standard_normal((1024, 16)).astype(np.float32)
    for mode in ("l2", "spherical"):
        c1, a1 = kmeans(jnp.asarray(x), k=8, iters=5, seed=3, mode=mode)
        c2, a2 = kmeans(jnp.asarray(x), k=8, iters=5, seed=3, mode=mode,
                        chunk=256)
        assert np.array_equal(np.asarray(a1), np.asarray(a2)), mode
        np.testing.assert_allclose(np.asarray(c1), np.asarray(c2),
                                   rtol=3e-5, atol=3e-5)


def test_ivf_train_large_nlist_chunks_the_assignment_plane(monkeypatch, rng):
    """train() must route large sample x nlist products through chunked
    k-means: the unchunked form materializes an [N, nlist] plane that OOMs
    a device whose storage planes are already resident (a 16M-row layout
    trains at nlist=16384). Guard: > 2^26 assignment cells."""
    import grape_vector_db_tpu.index.ivf as ivf_mod

    seen = {}
    real = ivf_mod.kmeans

    def spy(x, k, iters, seed, mode, chunk=None):
        seen["chunk"], seen["n"] = chunk, x.shape[0]
        return real(x[: 4 * k], k=k, iters=1, seed=seed, mode=mode)

    monkeypatch.setattr(ivf_mod, "kmeans", spy)
    idx = ivf_mod.IvfDeviceIndex(dimension=8, nlist=256, train_size=400_000,
                                 kmeans_iters=1)
    sample = rng.standard_normal((300_000, 8)).astype(np.float32)
    idx.train(sample)
    assert seen["chunk"] is not None
    assert seen["n"] % seen["chunk"] == 0
    # small samples keep the unchunked fast path
    seen.clear()
    idx2 = ivf_mod.IvfDeviceIndex(dimension=8, nlist=16, train_size=50_000,
                                  kmeans_iters=1)
    idx2.train(rng.standard_normal((2_048, 8)).astype(np.float32))
    assert seen["chunk"] is None
