"""Mesh-sharded search tests on the 8-device virtual CPU mesh: the sharded index
must return exactly what the single-device exact index returns."""

import numpy as np
import pytest
import jax

from grape_vector_db_tpu.index import FlatDeviceIndex
from grape_vector_db_tpu.parallel import ShardedFlatIndex, make_mesh


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def test_mesh_has_8_devices(mesh):
    assert mesh.shape["shard"] == 8


def test_sharded_matches_single_device(rng, mesh):
    d, n, k = 32, 700, 10
    ids = [f"doc-{i}" for i in range(n)]
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    sharded = ShardedFlatIndex(d, mesh=mesh, storage_dtype="float32", shard_capacity=128)
    single = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=1024)
    sharded.add_batch(ids, vecs)
    single.add_batch(ids, vecs)
    assert len(sharded) == n

    qs = rng.standard_normal((5, d)).astype(np.float32)
    got = sharded.search_batch(qs, k)
    want = single.search_batch(qs, k)
    for g, w in zip(got, want):
        assert [h[0] for h in g] == [h[0] for h in w]
        np.testing.assert_allclose(
            [h[1] for h in g], [h[1] for h in w], rtol=1e-5, atol=1e-5
        )


def test_sharded_balanced_placement(rng, mesh):
    idx = ShardedFlatIndex(16, mesh=mesh, storage_dtype="float32", shard_capacity=64)
    ids = [f"x-{i}" for i in range(80)]
    idx.add_batch(ids, rng.standard_normal((80, 16)).astype(np.float32))
    stats = idx.get_stats()
    counts = [stats.extra[f"shard_{i}_points"] for i in range(8)]
    assert max(counts) - min(counts) <= 1  # round-robin balance


def test_sharded_delete_and_reuse(rng, mesh):
    idx = ShardedFlatIndex(16, mesh=mesh, storage_dtype="float32", shard_capacity=32)
    ids = [f"x-{i}" for i in range(50)]
    vecs = rng.standard_normal((50, 16)).astype(np.float32)
    idx.add_batch(ids, vecs)
    assert idx.remove_batch(ids[:25]) == 25
    assert len(idx) == 25
    hits = idx.search_batch(vecs[30:31], 5)[0]
    assert hits[0][0] == "x-30"
    assert all(h[0] not in set(ids[:25]) for h in hits)
    # reuse freed slots
    idx.add_batch([f"y-{i}" for i in range(25)], rng.standard_normal((25, 16)).astype(np.float32))
    assert len(idx) == 50


def test_redistribute_to_smaller_mesh(rng, mesh):
    idx = ShardedFlatIndex(16, mesh=mesh, storage_dtype="float32", shard_capacity=64)
    ids = [f"x-{i}" for i in range(100)]
    vecs = rng.standard_normal((100, 16)).astype(np.float32)
    idx.add_batch(ids, vecs)
    small_mesh = make_mesh(n_shards=4)
    idx.redistribute(small_mesh, shard_capacity=64)
    assert idx.n_shards == 4 and len(idx) == 100
    hits = idx.search_batch(vecs[7:8], 3)[0]
    assert hits[0][0] == "x-7"


def test_2d_mesh_replica_sharded(rng):
    """(replica=2, shard=4) mesh: query batch splits over replicas, corpus
    shards over 4 devices per replica; results must match single-device exact."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from grape_vector_db_tpu.parallel import make_mesh_2d, replicated_sharded_topk

    mesh2 = make_mesh_2d(n_replicas=2)
    assert mesh2.shape["replica"] == 2 and mesh2.shape["shard"] == 4

    d, per_shard, b, k = 32, 64, 16, 5
    n = 4 * per_shard
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    norms = np.linalg.norm(vecs, axis=1).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    qs = rng.standard_normal((b, d)).astype(np.float32)

    v_dev = jax.device_put(jnp.asarray(vecs), NamedSharding(mesh2, P("shard", None)))
    n_dev = jax.device_put(jnp.asarray(norms), NamedSharding(mesh2, P("shard")))
    m_dev = jax.device_put(jnp.asarray(valid), NamedSharding(mesh2, P("shard")))
    q_dev = jax.device_put(jnp.asarray(qs), NamedSharding(mesh2, P("replica", None)))

    vals, idxs = replicated_sharded_topk(
        q_dev, v_dev, n_dev, m_dev, k=k, metric="cosine", chunk=per_shard,
        mesh=mesh2,
    )
    vals, idxs = np.asarray(vals), np.asarray(idxs)

    single = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=256)
    single.add_batch([str(i) for i in range(n)], vecs)
    want = single.search_batch(qs, k)
    for row_i, w in zip(idxs, want):
        assert [str(i) for i in row_i] == [h[0] for h in w]


# -- sharded IVF -------------------------------------------------------------------


def test_sharded_ivf_matches_single_device_full_probe(rng, mesh):
    """With nprobe == nlist the sharded IVF probe is exhaustive, so it must
    agree with the single-device flat oracle exactly."""
    from grape_vector_db_tpu.parallel import ShardedIvfIndex

    dim, n, k = 24, 800, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    flat = FlatDeviceIndex(dim, storage_dtype="float32", initial_capacity=1024)
    flat.add_batch(ids, vecs)
    ivf = ShardedIvfIndex(dim, mesh=mesh, storage_dtype="float32",
                          nlist=8, nprobe=8, initial_capacity=2048)
    ivf.add_batch(ids, vecs)
    assert len(ivf._overflow) == 0, "lists spilled; enlarge initial_capacity"
    queries = vecs[:16] + 0.001 * rng.standard_normal((16, dim)).astype(np.float32)
    want = flat.search_batch(queries, k)
    got = ivf.search_batch(queries, k)
    for w, g in zip(want, got):
        assert [x[0] for x in w] == [x[0] for x in g]


def test_sharded_ivf_recall_with_partial_probe(rng, mesh):
    """Clustered data + nprobe < nlist: high recall at a fraction of the scan."""
    from grape_vector_db_tpu.parallel import ShardedIvfIndex

    dim, k = 24, 10
    centers = rng.standard_normal((16, dim)).astype(np.float32) * 4
    rows = np.concatenate([
        c + 0.3 * rng.standard_normal((200, dim)).astype(np.float32)
        for c in centers
    ])
    ids = [f"d{i}" for i in range(len(rows))]
    ivf = ShardedIvfIndex(dim, mesh=mesh, storage_dtype="float32",
                          nlist=16, nprobe=4, initial_capacity=8192)
    ivf.add_batch(ids, rows)
    flat = FlatDeviceIndex(dim, storage_dtype="float32", initial_capacity=4096)
    flat.add_batch(ids, rows)
    queries = rows[::37][:32]
    want = flat.search_batch(queries, k)
    got = ivf.search_batch(queries, k)
    overlap = np.mean([
        len({x[0] for x in w} & {x[0] for x in g}) / k
        for w, g in zip(want, got)
    ])
    assert overlap >= 0.9, overlap


def test_sharded_ivf_upsert_delete_mask(rng, mesh):
    from grape_vector_db_tpu.parallel import ShardedIvfIndex

    dim = 16
    vecs = rng.standard_normal((300, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(300)]
    ivf = ShardedIvfIndex(dim, mesh=mesh, storage_dtype="float32",
                          nlist=4, nprobe=4, initial_capacity=2048)
    ivf.add_batch(ids, vecs)
    # delete then re-add with a new vector (slot reuse across shards)
    ivf.remove_batch(["d7"])
    assert ivf.search_batch(vecs[7:8], 1)[0][0][0] != "d7"
    ivf.add_batch(["d7"], vecs[7:8])
    assert ivf.search_batch(vecs[7:8], 1)[0][0][0] == "d7"
    # masked search returns only allowed ids
    allowed = {"d3", "d9", "d250"}
    hits = ivf.search_batch(vecs[3:4], 3, mask=ivf.compile_mask(allowed))[0]
    assert {h[0] for h in hits} == allowed


def test_sharded_int8_ivf_matches_flat(rng, mesh):
    """Sharded int8 IVF (bandwidth config): full probe + per-device exact
    rescore returns the exact index's ids."""
    from grape_vector_db_tpu.parallel import ShardedInt8IvfIndex

    dim, n, k = 24, 800, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    flat = FlatDeviceIndex(dim, storage_dtype="float32", initial_capacity=1024)
    flat.add_batch(ids, vecs)
    ivf = ShardedInt8IvfIndex(dim, mesh=mesh, storage_dtype="float32",
                              nlist=8, nprobe=8, initial_capacity=2048)
    ivf.add_batch(ids, vecs)
    assert len(ivf._overflow) == 0
    assert ivf.codes.shape[1] % 8 == 0  # capacity splits across the mesh

    queries = vecs[:16] + 0.001 * rng.standard_normal((16, dim)).astype(np.float32)
    want = flat.search_batch(queries, k)
    got = ivf.search_batch(queries, k)
    for w, g in zip(want, got):
        assert [x[0] for x in w] == [x[0] for x in g]


def test_sharded_int8_ivf_capacity_config(rng, mesh):
    """keep_bf16=False across the mesh: no bf16 plane, int8 SPMD scoring,
    delete/mask still correct."""
    from grape_vector_db_tpu.parallel import ShardedInt8IvfIndex

    dim, n, k = 16, 600, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    ivf = ShardedInt8IvfIndex(dim, mesh=mesh, storage_dtype="float32",
                              nlist=4, nprobe=4, initial_capacity=2048,
                              keep_bf16=False)
    ivf.add_batch(ids, vecs)
    assert ivf.vecs is None

    for i, row in enumerate(ivf.search_batch(vecs[:8], 1)):
        assert row[0][0] == f"d{i}"

    got = ivf.get_vector("d7")
    cos = got @ vecs[7] / (np.linalg.norm(got) * np.linalg.norm(vecs[7]))
    assert cos > 0.9999, cos

    ivf.remove_batch(["d7"])
    assert all(h[0] != "d7" for h in ivf.search_batch(vecs[7:8], k)[0])
    ivf.add_batch(["d7"], vecs[7:8])
    assert ivf.search_batch(vecs[7:8], 1)[0][0][0] == "d7"

    allowed = {"d1", "d5", "d9"}
    got = ivf.search_batch(vecs[:1], 3, mask=ivf.compile_mask(allowed))[0]
    assert {h[0] for h in got} == allowed


def test_sharded_ivf_pallas_matches_xla(rng, mesh, interpret_kernels):
    """The per-device probe kernel inside shard_map (interpreted on the CPU
    mesh) returns exactly what the XLA gather probe returns."""
    from grape_vector_db_tpu.parallel import ShardedIvfIndex

    dim, n, k = 16, 480, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    a = ShardedIvfIndex(dim, mesh=mesh, storage_dtype="float32",
                        nlist=4, nprobe=4, initial_capacity=2048)
    b = ShardedIvfIndex(dim, mesh=mesh, storage_dtype="float32",
                        nlist=4, nprobe=4, initial_capacity=2048)
    a._use_kernel = True
    a.add_batch(ids, vecs)
    b.add_batch(ids, vecs)
    assert a.recip is not None
    assert a.list_cap % 8 == 0

    q = vecs[:8]
    for ra, rb in zip(a.search_batch(q, k), b.search_batch(q, k)):
        assert [x[0] for x in ra] == [x[0] for x in rb]

    # delete + filter mask through the kernel path
    a.remove_batch(["d3"])
    assert all(h[0] != "d3" for h in a.search_batch(vecs[3:4], k)[0])
    allowed = {"d1", "d5", "d9"}
    got = a.search_batch(q[:1], 3, mask=a.compile_mask(allowed))[0]
    assert {h[0] for h in got} == allowed


def test_sharded_int8_ivf_pallas_matches_xla(rng, mesh, interpret_kernels):
    from grape_vector_db_tpu.parallel import ShardedInt8IvfIndex

    dim, n, k = 16, 480, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    for keep in (True, False):
        a = ShardedInt8IvfIndex(dim, mesh=mesh, storage_dtype="float32",
                                nlist=4, nprobe=4, initial_capacity=2048,
                                keep_bf16=keep)
        a._use_kernel = True
        b = ShardedInt8IvfIndex(dim, mesh=mesh, storage_dtype="float32",
                                nlist=4, nprobe=4, initial_capacity=2048,
                                keep_bf16=keep)
        a.add_batch(ids, vecs)
        b.add_batch(ids, vecs)
        assert a.factor.shape == (4, a.list_cap)
        q = vecs[:8]
        for ra, rb in zip(a.search_batch(q, k), b.search_batch(q, k)):
            assert [x[0] for x in ra] == [x[0] for x in rb], keep
        a.remove_batch(["d2"])
        assert all(h[0] != "d2" for h in a.search_batch(vecs[2:3], k)[0])


def test_sharded_int4_ivf_matches_flat(rng, mesh):
    """Sharded packed-int4 IVF (bandwidth config): nibble probe + per-device
    exact rescore returns the exact index's ids."""
    from grape_vector_db_tpu.parallel import ShardedInt4IvfIndex

    dim, n, k = 24, 800, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    flat = FlatDeviceIndex(dim, storage_dtype="float32", initial_capacity=1024)
    flat.add_batch(ids, vecs)
    ivf = ShardedInt4IvfIndex(dim, mesh=mesh, storage_dtype="float32",
                              nlist=8, nprobe=8, initial_capacity=2048)
    ivf.add_batch(ids, vecs)
    assert len(ivf._overflow) == 0
    assert ivf.codes.shape[2] == dim // 2  # packed nibbles
    assert str(ivf.codes.dtype) == "int8"

    queries = vecs[:16] + 0.001 * rng.standard_normal((16, dim)).astype(np.float32)
    want = flat.search_batch(queries, k)
    got = ivf.search_batch(queries, k)
    for w, g in zip(want, got):
        assert [x[0] for x in w] == [x[0] for x in g]


def test_sharded_int4_ivf_capacity_config(rng, mesh):
    """keep_bf16=False across the mesh: no bf16 plane, asymmetric nibble
    scoring, delete/mask still correct."""
    from grape_vector_db_tpu.parallel import ShardedInt4IvfIndex

    dim, n, k = 16, 600, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    ivf = ShardedInt4IvfIndex(dim, mesh=mesh, storage_dtype="float32",
                              nlist=4, nprobe=4, initial_capacity=2048,
                              keep_bf16=False)
    ivf.add_batch(ids, vecs)
    assert ivf.vecs is None

    for i, row in enumerate(ivf.search_batch(vecs[:8], 1)):
        assert row[0][0] == f"d{i}"

    got = ivf.get_vector("d7")
    cos = got @ vecs[7] / (np.linalg.norm(got) * np.linalg.norm(vecs[7]))
    assert cos > 0.98, cos  # 4-bit reconstruction

    ivf.remove_batch(["d7"])
    assert all(h[0] != "d7" for h in ivf.search_batch(vecs[7:8], k)[0])
    ivf.add_batch(["d7"], vecs[7:8])
    assert ivf.search_batch(vecs[7:8], 1)[0][0][0] == "d7"

    allowed = {"d1", "d5", "d9"}
    got = ivf.search_batch(vecs[:1], 3, mask=ivf.compile_mask(allowed))[0]
    assert {h[0] for h in got} == allowed


def test_sharded_int4_ivf_pallas_matches_xla(rng, mesh, interpret_kernels):
    from grape_vector_db_tpu.parallel import ShardedInt4IvfIndex

    dim, n, k = 16, 480, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    for keep in (True, False):
        a = ShardedInt4IvfIndex(dim, mesh=mesh, storage_dtype="float32",
                                nlist=4, nprobe=4, initial_capacity=2048,
                                keep_bf16=keep)
        a._use_kernel = True
        b = ShardedInt4IvfIndex(dim, mesh=mesh, storage_dtype="float32",
                                nlist=4, nprobe=4, initial_capacity=2048,
                                keep_bf16=keep)
        a.add_batch(ids, vecs)
        b.add_batch(ids, vecs)
        assert a.factor.shape == (4, a.list_cap)
        q = vecs[:8]
        for ra, rb in zip(a.search_batch(q, k), b.search_batch(q, k)):
            assert [x[0] for x in ra] == [x[0] for x in rb], keep
        a.remove_batch(["d2"])
        assert all(h[0] != "d2" for h in a.search_batch(vecs[2:3], k)[0])


def test_sharded_ivf_striped_placement_balances_devices(rng, mesh,
                                                        interpret_kernels):
    """Striped positions spread each list's rows uniformly across device
    slices (sequential packing would saturate device 0's slice while the
    rest idle — SPMD lockstep means the fullest slice gates every query),
    and the per-device ragged probe stays exact."""
    from grape_vector_db_tpu.parallel import ShardedIvfIndex

    dim, n = 24, 800
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    ivf = ShardedIvfIndex(dim, mesh=mesh, storage_dtype="float32",
                          nlist=8, nprobe=8, initial_capacity=2048)
    ivf._use_kernel = True
    ivf.add_batch(ids, vecs)
    s = ivf.n_shards
    c_local = ivf.list_cap // s
    valid = np.asarray(ivf.valid)             # [L, C]
    per_dev = valid.reshape(ivf.nlist, s, c_local).sum(axis=2)  # [L, S]
    for lst in range(ivf.nlist):
        occ = per_dev[lst]
        assert occ.max() - occ.min() <= 1, (lst, occ.tolist())

    # the striped + fill-bounded kernel path agrees with the XLA probe
    ivf2 = ShardedIvfIndex(dim, mesh=mesh, storage_dtype="float32",
                           nlist=8, nprobe=8, initial_capacity=2048)
    ivf2.add_batch(ids, vecs)
    queries = vecs[:8] + 0.001 * rng.standard_normal((8, dim)).astype(np.float32)
    for a, b in zip(ivf.search_batch(queries, 5),
                    ivf2.search_batch(queries, 5)):
        assert [x[0] for x in a] == [x[0] for x in b]


def test_sharded_ivf_2d_replica_mesh_matches_1d(rng):
    """2D (replica x shard) IVF: the query batch splits over replica rows,
    each row holding a full sharded corpus copy — per-query results must
    equal the 1D mesh (independent serving lanes)."""
    import jax

    from grape_vector_db_tpu.ops.kmeans import assign_clusters, kmeans
    from grape_vector_db_tpu.parallel import make_mesh
    from grape_vector_db_tpu.parallel.mesh import (
        make_mesh_2d,
        sharded_ivf_topk,
    )
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    dim, n, nlist, cap = 32, 512, 4, 256
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    cents, _ = kmeans(jnp.asarray(vecs), k=nlist, iters=4, seed=0,
                      mode="spherical")
    assign = np.asarray(assign_clusters(jnp.asarray(vecs), cents,
                                        mode="spherical"))
    iv = np.zeros((nlist, cap, dim), np.float32)
    inr = np.zeros((nlist, cap), np.float32)
    ival = np.zeros((nlist, cap), bool)
    nxt = np.zeros(nlist, np.int64)
    for i, a in enumerate(assign):
        p_ = int(nxt[a]); nxt[a] += 1
        iv[a, p_] = vecs[i]
        inr[a, p_] = np.linalg.norm(vecs[i])
        ival[a, p_] = True
    q = rng.standard_normal((8, dim)).astype(np.float32)

    mesh1 = make_mesh(n_shards=4)
    v1, s1 = sharded_ivf_topk(
        jnp.asarray(q), cents, jnp.asarray(iv), jnp.asarray(inr),
        jnp.asarray(ival), k=5, nprobe=4, metric="cosine", mesh=mesh1)

    mesh2 = make_mesh_2d(n_replicas=2, devices=jax.devices()[:8])
    repl_q = jax.device_put(jnp.asarray(q),
                            NamedSharding(mesh2, P("replica", None)))
    v2, s2 = sharded_ivf_topk(
        repl_q, cents, jnp.asarray(iv), jnp.asarray(inr), jnp.asarray(ival),
        k=5, nprobe=4, metric="cosine", mesh=mesh2,
        replica_axis="replica")
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-5)
