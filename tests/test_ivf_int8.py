"""Int8IvfDeviceIndex — int8-resident IVF lists (bandwidth + capacity play).

Covers both configurations (bf16 shadow w/ exact rescore, int8-only
capacity), the probe kernel (interpret mode) vs the XLA probe, masked search,
mutation (upsert/delete/optimize), and the DB factory wiring.
"""

import numpy as np
import pytest

from grape_vector_db_tpu.index.ivf import IvfDeviceIndex
from grape_vector_db_tpu.index.ivf_int8 import Int8IvfDeviceIndex


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def clustered(rng, n, dim, centers=12, noise=0.15):
    c = rng.standard_normal((centers, dim)).astype(np.float32) * 2
    idx = rng.integers(0, centers, n)
    return (c[idx] + noise * rng.standard_normal((n, dim))).astype(np.float32)


def ids_of(hits):
    return [h[0] for h in hits]


def test_int8_ivf_matches_bf16_ivf(rng):
    """Bandwidth config: int8 probe + exact rescore returns the same ids as
    the full-precision IVF index on clustered data."""
    dim, n, k = 64, 1500, 5
    vecs = clustered(rng, n, dim)
    ids = [f"d{i}" for i in range(n)]
    a = Int8IvfDeviceIndex(dim, nlist=8, nprobe=8, rescore=64)
    b = IvfDeviceIndex(dim, nlist=8, nprobe=8)
    a.add_batch(ids, vecs)
    b.add_batch(ids, vecs)
    assert not a._use_kernel  # CPU default: XLA probe

    q = vecs[:8] + 0.01 * rng.standard_normal((8, dim)).astype(np.float32)
    ha, hb = a.search_batch(q, k), b.search_batch(q, k)
    agree = np.mean([len(set(ids_of(x)) & set(ids_of(y))) / k
                     for x, y in zip(ha, hb)])
    assert agree >= 0.95, agree
    # self-retrieval is exact thanks to the bf16 rescore
    for i, row in enumerate(a.search_batch(vecs[:8], 1)):
        assert row[0][0] == f"d{i}"


def test_int8_ivf_pallas_interpret_matches_xla(rng, interpret_kernels):
    """The int8 probe kernel behind the index (interpreted on the CPU)
    returns the same ids as the XLA probe, masked and unmasked."""
    dim, n, k = 32, 1200, 5
    vecs = clustered(rng, n, dim)
    ids = [f"d{i}" for i in range(n)]
    a = Int8IvfDeviceIndex(dim, nlist=8, nprobe=8)
    b = Int8IvfDeviceIndex(dim, nlist=8, nprobe=8)
    a._use_kernel = True
    a.add_batch(ids, vecs)
    b.add_batch(ids, vecs)
    assert a.factor.shape == (8, a.list_cap)

    q = vecs[:6] + 0.01 * rng.standard_normal((6, dim)).astype(np.float32)
    for ra, rb in zip(a.search_batch(q, k), b.search_batch(q, k)):
        assert ids_of(ra) == ids_of(rb)

    wide = {f"d{i}" for i in range(0, n, 3)}
    ma, mb = a.compile_mask(wide), b.compile_mask(wide)
    for ra, rb in zip(a.search_batch(q, k, mask=ma),
                      b.search_batch(q, k, mask=mb)):
        assert ids_of(ra) == ids_of(rb)
        assert set(ids_of(ra)) <= wide

    narrow = {"d1", "d5", "d9"}
    got = a.search_batch(q[:1], 3, mask=a.compile_mask(narrow))[0]
    assert {h[0] for h in got} == narrow


def test_int8_ivf_capacity_config(rng):
    """keep_bf16=False: no bf16 plane exists, search still ranks correctly,
    reconstruction round-trips within int8 tolerance, optimize() repacks."""
    dim, n, k = 48, 1400, 5
    vecs = clustered(rng, n, dim)
    ids = [f"d{i}" for i in range(n)]
    idx = Int8IvfDeviceIndex(dim, nlist=8, nprobe=8, keep_bf16=False)
    idx.add_batch(ids, vecs)
    assert idx.vecs is None and idx.recip is None

    for i, row in enumerate(idx.search_batch(vecs[:8], 1)):
        assert row[0][0] == f"d{i}"

    got = idx.get_vector("d7")
    cos = got @ vecs[7] / (np.linalg.norm(got) * np.linalg.norm(vecs[7]))
    assert cos > 0.9999, cos

    # delete / re-add via the factor plane
    idx.remove_batch(["d3"])
    assert all(h[0] != "d3" for h in idx.search_batch(vecs[3:4], k)[0])
    idx.add_batch(["d3"], vecs[3:4])
    assert idx.search_batch(vecs[3:4], 1)[0][0][0] == "d3"

    # optimize() reconstructs from codes and repacks
    idx.optimize()
    assert len(idx) == n
    assert idx.search_batch(vecs[5:6], 1)[0][0][0] == "d5"

    allowed = {"d2", "d4", "d6"}
    got = idx.search_batch(vecs[:1], 3, mask=idx.compile_mask(allowed))[0]
    assert {h[0] for h in got} == allowed


def test_int8_ivf_capacity_pallas_interpret(rng, interpret_kernels):
    """Capacity config through the interpreted probe kernel (rescore=0)."""
    dim, n = 32, 900
    vecs = clustered(rng, n, dim)
    ids = [f"d{i}" for i in range(n)]
    a = Int8IvfDeviceIndex(dim, nlist=8, nprobe=8, keep_bf16=False)
    a._use_kernel = True
    b = Int8IvfDeviceIndex(dim, nlist=8, nprobe=8, keep_bf16=False)
    a.add_batch(ids, vecs)
    b.add_batch(ids, vecs)
    q = vecs[:4]
    for ra, rb in zip(a.search_batch(q, 5), b.search_batch(q, 5)):
        assert ids_of(ra) == ids_of(rb)


def test_int8_ivf_via_db_factory(rng):
    from grape_vector_db_tpu.config import VectorDbConfig
    from grape_vector_db_tpu.db import VectorDatabase
    from grape_vector_db_tpu.types import Document, SearchRequest

    cfg = VectorDbConfig(vector_dimension=32)
    cfg.index.kind = "ivf_int8"
    cfg.index.nlist = 8
    cfg.index.nprobe = 8
    cfg.index.initial_capacity = 2048
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    vecs = clustered(rng, 600, 32)
    docs = [Document(id=f"v{i}", content=f"doc {i}", vector=vecs[i].tolist())
            for i in range(600)]
    db.batch_add_documents(docs)
    assert db.stats().index_kind == "ivf_int8"
    hits = db.vector_search(SearchRequest(vector=vecs[123].tolist(), limit=3))
    assert hits[0].id == "v123"
    db.delete_document("v123")
    hits = db.vector_search(SearchRequest(vector=vecs[123].tolist(), limit=3))
    assert all(h.id != "v123" for h in hits)


def test_int8_ivf_dot_metric_parity(rng, interpret_kernels):
    """metric="dot" must rank by raw dot products on every path (regression:
    the rescore divided by the corpus norm, silently returning cosine)."""
    dim, n, k = 32, 900, 5
    # vary norms wildly so dot and cosine order differently
    vecs = clustered(rng, n, dim) * rng.uniform(0.2, 5.0, (n, 1)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    a = Int8IvfDeviceIndex(dim, metric="dot", nlist=8, nprobe=8)
    a._use_kernel = True
    b = Int8IvfDeviceIndex(dim, metric="dot", nlist=8, nprobe=8)
    a.add_batch(ids, vecs)
    b.add_batch(ids, vecs)
    q = vecs[:6]
    ha, hb = a.search_batch(q, k), b.search_batch(q, k)
    for ra, rb in zip(ha, hb):
        assert ids_of(ra) == ids_of(rb)
    # oracle: raw dot against the full corpus
    for qi, row in enumerate(ha):
        want = np.argsort(-(vecs[qi] @ vecs.T))[:k]
        got = set(ids_of(row))
        overlap = len(got & {f"d{i}" for i in want}) / k
        assert overlap >= 0.8, (qi, overlap)


def test_int8_ivf_rescore_ignores_deleted(rng):
    """Deleted cells must never win the exact rescore (regression: the guard
    accepted finite -1e9 sentinels and stale norms of tombstoned rows)."""
    dim, n, k = 32, 600, 5
    vecs = clustered(rng, n, dim, centers=4)
    ids = [f"d{i}" for i in range(n)]
    idx = Int8IvfDeviceIndex(dim, nlist=4, nprobe=4, rescore=256)
    idx.add_batch(ids, vecs)
    # delete most of the corpus so the rescore set must include tombstones
    dead = [f"d{i}" for i in range(0, n, 2)]
    idx.remove_batch(dead)
    for row in idx.search_batch(vecs[:16], k):
        assert len(row) == k
        assert all(int(h[0][1:]) % 2 == 1 for h in row), row


def test_projected_int8_ivf_end_to_end(rng):
    """PCA-projected int8 IVF (the matmul capacity tier): recall, delete,
    persistence round-trip and optimize() refit at proj_dim = dim/2."""
    from grape_vector_db_tpu.index.ivf_proj import ProjectedInt8IvfIndex
    from grape_vector_db_tpu.index.flat import FlatDeviceIndex

    d, r, k = 256, 128, 10
    centers = rng.standard_normal((32, d)).astype(np.float32) * 3
    pts = np.concatenate(
        [c + 0.5 * rng.standard_normal((125, d)).astype(np.float32)
         for c in centers])
    ids = [f"p{i}" for i in range(len(pts))]
    idx = ProjectedInt8IvfIndex(d, proj_dim=r, storage_dtype="float32",
                                nlist=32, nprobe=8, initial_capacity=4096)
    flat = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=4096)
    idx.train(pts)
    idx.add_batch(ids, pts)
    flat.add_batch(ids, pts)
    assert idx.dimension == d and idx.proj.shape == (d, r)

    qs = pts[::71][:16] + 0.2 * rng.standard_normal((16, d)).astype(np.float32)
    got = idx.search_batch(qs, k)
    want = flat.search_batch(qs, k)
    recall = np.mean([
        len({h[0] for h in g} & {h[0] for h in w}) / k
        for g, w in zip(got, want)
    ])
    # isotropic noise is the projection's ADVERSARIAL regime (discarded
    # dims carry half the intra-cluster signal); realistic decaying
    # spectra are covered below
    assert recall >= 0.45, f"projected recall {recall}"

    # delete
    assert idx.remove_batch(["p7"]) == 1
    assert all(h[0] != "p7" for h in idx.search_batch(pts[7:8], 5)[0])

    # back-projected reconstruction correlates with the original
    v = idx.get_vector("p12")
    assert v is not None and v.shape == (d,)
    cos = float(v @ pts[12] / (np.linalg.norm(v) * np.linalg.norm(pts[12]) + 1e-12))
    assert cos > 0.7, cos

    # optimize refits projection + repacks without breaking retrieval
    idx.optimize()
    got = idx.search_batch(qs[:4], 5)
    assert all(row for row in got)

    st = idx.get_stats()
    assert st.extra["proj_dim"] == float(r)
    assert st.dimension == d


def test_projected_int8_ivf_decaying_spectrum(rng):
    """On realistic decaying-spectrum data (embedding-like energy
    concentration) half-dim projection retains ~full recall."""
    from grape_vector_db_tpu.index.ivf_proj import ProjectedInt8IvfIndex
    from grape_vector_db_tpu.index.flat import FlatDeviceIndex

    d, r, k = 256, 128, 10
    spec = (1.0 + np.arange(d)) ** -0.5
    centers = rng.standard_normal((32, d)).astype(np.float32) * 3
    pts = np.concatenate(
        [c + 0.5 * rng.standard_normal((125, d)).astype(np.float32)
         for c in centers])
    pts = (pts * spec[None, :]).astype(np.float32)
    ids = [f"p{i}" for i in range(len(pts))]
    idx = ProjectedInt8IvfIndex(d, proj_dim=r, storage_dtype="float32",
                                nlist=32, nprobe=8, initial_capacity=4096)
    flat = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=4096)
    idx.train(pts)
    idx.add_batch(ids, pts)
    flat.add_batch(ids, pts)
    qs = pts[::71][:16] + 0.2 * (
        rng.standard_normal((16, d)) * spec[None, :]).astype(np.float32)
    got = idx.search_batch(qs, k)
    want = flat.search_batch(qs, k)
    recall = np.mean([
        len({h[0] for h in g} & {h[0] for h in w}) / k
        for g, w in zip(got, want)
    ])
    assert recall >= 0.85, f"decaying-spectrum projected recall {recall}"


def test_projected_ivf_energy_guard(rng):
    """Build-time spectrum guard (docs/benchmarks.md tier guidance made
    self-enforcing): a flat-spectrum corpus warns (projection loss at this
    level is not rescore-recoverable), min_energy refuses outright, and a
    decaying-spectrum corpus fits silently with proj_energy in stats."""
    import warnings

    import pytest

    from grape_vector_db_tpu.index.ivf_proj import ProjectedInt8IvfIndex

    d, r = 256, 128
    # pure isotropic: energy@128 = 0.5 — the adversarial regime
    flat_pts = rng.standard_normal((2000, d)).astype(np.float32)
    idx = ProjectedInt8IvfIndex(d, proj_dim=r, storage_dtype="float32",
                                nlist=8, nprobe=8, initial_capacity=4096)
    with pytest.warns(RuntimeWarning, match="spectral energy"):
        idx.train(flat_pts)
    assert idx.proj_energy is not None and idx.proj_energy < 0.9
    assert idx.get_stats().extra["proj_energy"] == round(idx.proj_energy, 4)

    # refuse-to-build floor
    strict = ProjectedInt8IvfIndex(d, proj_dim=r, storage_dtype="float32",
                                   min_energy=0.9, nlist=8, nprobe=8,
                                   initial_capacity=4096)
    with pytest.raises(ValueError, match="min_energy"):
        strict.train(flat_pts)

    # decaying spectrum: no warning
    spec = (1.0 + np.arange(d)) ** -1.0
    good_pts = (rng.standard_normal((2000, d)) * spec[None, :]).astype(
        np.float32)
    ok = ProjectedInt8IvfIndex(d, proj_dim=r, storage_dtype="float32",
                               nlist=8, nprobe=8, initial_capacity=4096)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        ok.train(good_pts)
    assert ok.proj_energy is not None and ok.proj_energy >= 0.9
