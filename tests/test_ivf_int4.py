"""Int4IvfDeviceIndex — packed-nibble-resident IVF lists (the top rung of
the bandwidth/capacity ladder).

Covers the quantization/packing scheme itself (split-plane round-trip),
both index configurations (bf16 shadow w/ exact rescore, int4-only
capacity), the probe kernel (interpret mode) vs the XLA probe, masked search,
mutation, and the DB factory wiring.
"""

import numpy as np
import pytest

from grape_vector_db_tpu.index.ivf import IvfDeviceIndex
from grape_vector_db_tpu.index.ivf_int4 import Int4IvfDeviceIndex


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def clustered(rng, n, dim, centers=12, noise=0.15):
    c = rng.standard_normal((centers, dim)).astype(np.float32) * 2
    idx = rng.integers(0, centers, n)
    return (c[idx] + noise * rng.standard_normal((n, dim))).astype(np.float32)


def ids_of(hits):
    return [h[0] for h in hits]


def test_int4_pack_roundtrip(rng):
    """quantize_int4 -> unpack_int4 reconstructs each dim to within one
    quantization step, with the split-plane layout (low nibbles = first
    half of the dims) honored."""
    from grape_vector_db_tpu.ops.int4 import (quantize_int4, unpack_int4,
                                              unpack_int4_split)

    x = rng.standard_normal((64, 96)).astype(np.float32)
    packed, s = quantize_int4(x)
    packed, s = np.asarray(packed), np.asarray(s)
    # int8-typed storage (ops/int4.py: avoids a per-dispatch corpus bitcast)
    assert packed.shape == (64, 48) and packed.dtype == np.int8
    lev = np.asarray(unpack_int4(packed))
    assert lev.shape == (64, 96)
    assert lev.min() >= -8 and lev.max() <= 7
    recon = lev * s[:, None]
    err = np.abs(recon - x)
    assert err.max() <= (s[:, None] / 2 + 1e-6).max() * 1.01, err.max()
    # split-plane layout: low nibbles are dims [0, D/2)
    lo, hi = (np.asarray(a) for a in unpack_int4_split(packed))
    np.testing.assert_array_equal(lo, lev[:, :48])
    np.testing.assert_array_equal(hi, lev[:, 48:])


def test_int4_ivf_matches_bf16_ivf(rng):
    """Bandwidth config: int4 probe + exact rescore returns (nearly) the
    same ids as the full-precision IVF index on clustered data."""
    dim, n, k = 64, 1500, 5
    vecs = clustered(rng, n, dim)
    ids = [f"d{i}" for i in range(n)]
    a = Int4IvfDeviceIndex(dim, nlist=8, nprobe=8, rescore=128)
    b = IvfDeviceIndex(dim, nlist=8, nprobe=8)
    a.add_batch(ids, vecs)
    b.add_batch(ids, vecs)
    assert not a._use_kernel  # CPU default: XLA probe
    assert a.codes.dtype == np.int8 and a.codes.shape[-1] == dim // 2

    q = vecs[:8] + 0.01 * rng.standard_normal((8, dim)).astype(np.float32)
    ha, hb = a.search_batch(q, k), b.search_batch(q, k)
    agree = np.mean([len(set(ids_of(x)) & set(ids_of(y))) / k
                     for x, y in zip(ha, hb)])
    assert agree >= 0.9, agree
    # self-retrieval is exact thanks to the bf16 rescore
    for i, row in enumerate(a.search_batch(vecs[:8], 1)):
        assert row[0][0] == f"d{i}"


def test_int4_ivf_pallas_interpret_matches_xla(rng, interpret_kernels):
    """The int4 probe kernel behind the index (interpreted on the CPU)
    returns the same ids as the XLA probe, masked and unmasked."""
    dim, n, k = 32, 1200, 5
    vecs = clustered(rng, n, dim)
    ids = [f"d{i}" for i in range(n)]
    a = Int4IvfDeviceIndex(dim, nlist=8, nprobe=8)
    b = Int4IvfDeviceIndex(dim, nlist=8, nprobe=8)
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


def test_int4_ivf_capacity_config(rng):
    """keep_bf16=False: no bf16 plane exists, search still ranks correctly,
    reconstruction round-trips within int4 tolerance, optimize() repacks.

    noise=0.5: rows must sit further apart than the 4-bit quantization
    radius (~0.23 RMS/dim) for int4-only self-retrieval to be well-posed —
    tighter clusters are the rescore configs' job, not the capacity tier's."""
    dim, n, k = 48, 1400, 5
    vecs = clustered(rng, n, dim, noise=0.5)
    ids = [f"d{i}" for i in range(n)]
    idx = Int4IvfDeviceIndex(dim, nlist=8, nprobe=8, keep_bf16=False)
    idx.add_batch(ids, vecs)
    assert idx.vecs is None and idx.recip is None

    for i, row in enumerate(idx.search_batch(vecs[:8], 1)):
        assert row[0][0] == f"d{i}"

    got = idx.get_vector("d7")
    cos = got @ vecs[7] / (np.linalg.norm(got) * np.linalg.norm(vecs[7]))
    assert cos > 0.99, cos  # 4-bit reconstruction (vs 0.9999 for int8)

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


def test_int4_ivf_capacity_pallas_interpret(rng, interpret_kernels):
    """Capacity config through the interpreted probe kernel (rescore=0)."""
    dim, n = 32, 900
    vecs = clustered(rng, n, dim)
    ids = [f"d{i}" for i in range(n)]
    a = Int4IvfDeviceIndex(dim, nlist=8, nprobe=8, keep_bf16=False)
    a._use_kernel = True
    b = Int4IvfDeviceIndex(dim, nlist=8, nprobe=8, keep_bf16=False)
    a.add_batch(ids, vecs)
    b.add_batch(ids, vecs)
    q = vecs[:4]
    for ra, rb in zip(a.search_batch(q, 5), b.search_batch(q, 5)):
        assert ids_of(ra) == ids_of(rb)


def test_int4_ivf_dot_metric_parity(rng, interpret_kernels):
    """metric="dot" must rank by raw dot products on every path."""
    dim, n, k = 32, 900, 5
    vecs = clustered(rng, n, dim) * rng.uniform(0.2, 5.0, (n, 1)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    a = Int4IvfDeviceIndex(dim, metric="dot", nlist=8, nprobe=8)
    a._use_kernel = True
    b = Int4IvfDeviceIndex(dim, metric="dot", nlist=8, nprobe=8)
    a.add_batch(ids, vecs)
    b.add_batch(ids, vecs)
    q = vecs[:6]
    ha, hb = a.search_batch(q, k), b.search_batch(q, k)
    for ra, rb in zip(ha, hb):
        assert ids_of(ra) == ids_of(rb)
    # oracle: raw dot against the full corpus (rescore makes this exact-ish)
    for qi, row in enumerate(ha):
        want = np.argsort(-(vecs[qi] @ vecs.T))[:k]
        got = set(ids_of(row))
        overlap = len(got & {f"d{i}" for i in want}) / k
        assert overlap >= 0.8, (qi, overlap)


def test_int4_ivf_snapshot_roundtrip(rng, tmp_path):
    """Capacity-config snapshot: rows reconstructed from nibbles re-add and
    keep retrieving (the dequantized row IS the checkpoint payload)."""
    from grape_vector_db_tpu.config import VectorDbConfig
    from grape_vector_db_tpu.db import VectorDatabase
    from grape_vector_db_tpu.types import Document, SearchRequest

    cfg = VectorDbConfig(vector_dimension=32)
    cfg.index.kind = "ivf_int4"
    cfg.index.nlist = 8
    cfg.index.nprobe = 8
    cfg.index.ivf_int8_keep_bf16 = False
    cfg.index.initial_capacity = 2048
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    vecs = clustered(rng, 600, 32)
    docs = [Document(id=f"v{i}", content=f"doc {i}", vector=vecs[i])
            for i in range(600)]
    db.batch_add_documents(docs)
    assert db.stats().index_kind == "ivf_int4"
    p = str(tmp_path / "int4.idx")
    db.save_index(p)
    db.load_index(p)
    hits = db.vector_search(SearchRequest(vector=vecs[123].tolist(), limit=3))
    assert hits[0].id == "v123"


def test_projected_int4_ivf_end_to_end(rng):
    """PCA-projected int4 IVF (the deepest single-chip capacity tier):
    recall on decaying-spectrum data, delete/upsert, optimize() refit, and
    stats at proj_dim = dim/2. Mirrors the int8-proj test at the 4-bit rung
    — the rescore plane absorbs most of the extra quantization error."""
    from grape_vector_db_tpu.index.ivf_proj import ProjectedInt4IvfIndex

    d, r, n, k = 256, 128, 1600, 10
    spec = (1.0 + np.arange(d)) ** -0.5
    base = clustered(rng, n, d) * spec[None, :].astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    idx = ProjectedInt4IvfIndex(d, proj_dim=r, nlist=8, nprobe=8,
                                rescore=128, storage_dtype="float32")
    idx.train(base)
    idx.add_batch(ids, base)
    assert idx.dimension == d and idx.proj.shape == (d, r)
    assert idx.codes.dtype == np.int8 and idx.codes.shape[-1] == r // 2
    assert idx.get_stats().kind == "ivf_int4_proj"
    assert idx.get_stats().extra["proj_dim"] == float(r)

    q = base[:32] + 0.005 * rng.standard_normal((32, d)).astype(np.float32)
    oracle = np.argsort(-(q @ base.T) / np.linalg.norm(base, axis=1), axis=1)
    got = 0
    for want, row in zip(oracle[:, :k], idx.search_batch(q, k)):
        have = {h[0] for h in row}
        got += sum(1 for w in want if f"d{w}" in have)
    assert got / (32 * k) >= 0.8, got / (32 * k)

    # mutation through the projection wrapper
    idx.remove_batch(["d5"])
    assert all(h[0] != "d5" for h in idx.search_batch(base[5:6], k)[0])
    idx.add_batch(["d5"], base[5:6])
    assert idx.search_batch(base[5:6], 1)[0][0][0] == "d5"

    # optimize() refits projection + centroids from back-projected rows
    idx.optimize()
    assert len(idx) == n
    assert idx.search_batch(base[9:10], 1)[0][0][0] == "d9"
