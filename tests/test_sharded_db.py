"""Sharded index kinds through the PRODUCT API.

The mesh engines (parallel/mesh.py) must be reachable from VectorDatabase /
EmbeddedVectorDB / ClusterNode — not just as raw index classes. These tests
drive `kind="sharded_*"` through `batch_add_documents`/`search` on the
8-device CPU mesh, including the ClusterNode-with-local-mesh composition
(DCN scatter-gather between nodes x NVLink shard_map within a node — the full
two-level form of the reference's scatter-gather, shard.rs:759-901).
"""

import numpy as np
import pytest

from grape_vector_db_tpu.config import VectorDbConfig
from grape_vector_db_tpu.db import VectorDatabase, build_index
from grape_vector_db_tpu.types import (
    Condition,
    Document,
    Filter,
    HybridSearchRequest,
    SearchRequest,
)

DIM = 64


def make_cfg(kind: str, **index_kw) -> VectorDbConfig:
    cfg = VectorDbConfig()
    cfg.vector_dimension = DIM
    cfg.index.kind = kind
    cfg.index.initial_capacity = 1024
    cfg.index.nlist = 8
    cfg.index.nprobe = 8
    cfg.device.storage_dtype = "float32"  # CPU-mesh speed; dtype is orthogonal
    cfg.cache.enabled = False
    for k, v in index_kw.items():
        setattr(cfg.index, k, v)
    return cfg


def make_docs(rng, n: int):
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    docs = [
        Document(
            id=f"doc-{i}",
            content=f"document number {i} about topic {i % 5}",
            vector=vecs[i].tolist(),
            metadata={"topic": i % 5},
        )
        for i in range(n)
    ]
    return docs, vecs


@pytest.mark.parametrize("kind", ["sharded_flat", "sharded_ivf",
                                  "sharded_ivf_int8", "sharded_ivf_int4"])
def test_db_sharded_kind_end_to_end(kind, rng):
    db = VectorDatabase(config=make_cfg(kind))
    docs, vecs = make_docs(rng, 200)
    db.batch_add_documents(docs)
    assert db.stats().index_kind == kind
    assert db.stats().index_size == 200

    # self-retrieval through the full product search path
    res = db.search(SearchRequest(vector=vecs[7].tolist(), limit=5))
    assert res and res[0].document.id == "doc-7"

    # batched vector search
    rows = db.vector_search_batch(vecs[:4], 3)
    assert len(rows) == 4 and rows[0][0].id == "doc-0"

    # delete removes from the sharded device arrays
    db.batch_delete_documents(["doc-7"])
    res = db.search(SearchRequest(vector=vecs[7].tolist(), limit=5))
    assert all(r.document.id != "doc-7" for r in res)

    # upsert overwrites in place
    moved = Document(id="doc-3", content="moved", vector=vecs[100].tolist())
    db.add_document(moved)
    res = db.search(SearchRequest(vector=vecs[100].tolist(), limit=2))
    assert {r.document.id for r in res} >= {"doc-3"} or res[0].document.id == "doc-100"


def test_db_sharded_filtered_search(rng):
    db = VectorDatabase(config=make_cfg("sharded_flat"))
    docs, vecs = make_docs(rng, 120)
    db.batch_add_documents(docs)
    flt = Filter(must=[Condition("topic", "eq", 2)])
    res = db.search(SearchRequest(vector=vecs[2].tolist(), limit=10, filter=flt))
    assert res and res[0].document.id == "doc-2"
    assert all(r.document.metadata["topic"] == 2 for r in res)


def test_db_sharded_hybrid_and_rebuild(rng):
    db = VectorDatabase(config=make_cfg("sharded_ivf"))
    docs, vecs = make_docs(rng, 150)
    db.batch_add_documents(docs)
    res = db.hybrid_search(
        HybridSearchRequest(query="topic 3", dense_vector=vecs[3].tolist(), limit=5)
    )
    assert res
    # rebuild_index round-trips through the sharded engine
    n = db.rebuild_index()
    assert n == 150
    res = db.search(SearchRequest(vector=vecs[11].tolist(), limit=3))
    assert res and res[0].document.id == "doc-11"


def test_db_sharded_snapshot_roundtrip(tmp_path, rng):
    db = VectorDatabase(config=make_cfg("sharded_flat"))
    docs, vecs = make_docs(rng, 64)
    db.batch_add_documents(docs)
    snap = str(tmp_path / "idx.snap")
    info = db.save_index(snap)
    assert info["points"] == 64

    db2 = VectorDatabase(config=make_cfg("sharded_flat"))
    db2.load_index(snap)
    hits = db2.index.search(vecs[5], 3)
    assert hits and hits[0][0] == "doc-5"


def test_sharded_flat_auto_grows_past_initial_capacity(rng):
    cfg = make_cfg("sharded_flat")
    cfg.index.initial_capacity = 1024  # floor: 8 shards x 128
    db = VectorDatabase(config=cfg)
    docs, vecs = make_docs(rng, 1500)  # > 8 * 128
    db.batch_add_documents(docs)
    assert db.stats().index_size == 1500
    res = db.search(SearchRequest(vector=vecs[1400].tolist(), limit=3))
    assert res and res[0].document.id == "doc-1400"


def test_auto_shard_upgrades_kind_on_multichip_host():
    cfg = make_cfg("flat")
    cfg.device.auto_shard = True
    idx = build_index(cfg)
    assert idx.kind == "sharded_flat"
    assert idx.n_shards == 8
    cfg2 = make_cfg("ivf_int8")
    cfg2.device.auto_shard = True
    assert build_index(cfg2).kind == "sharded_ivf_int8"
    # non-shardable kinds pass through untouched
    cfg3 = make_cfg("binary")
    cfg3.device.auto_shard = True
    assert build_index(cfg3).kind == "binary"


def test_sharded_2d_replica_mesh_through_db(rng):
    """n_replicas=2 builds the 2D replica x shard mesh; the query batch
    splits over replica lanes (independent serving lanes, scaling-book
    layout) while the corpus shards within each replica row."""
    cfg = make_cfg("sharded_flat")
    cfg.device.n_replicas = 2
    db = VectorDatabase(config=cfg)
    assert db.index.replica_axis == "replica"
    assert db.index.n_shards == 4 and db.index.n_replicas == 2
    docs, vecs = make_docs(rng, 96)
    db.batch_add_documents(docs)
    res = db.search(SearchRequest(vector=vecs[9].tolist(), limit=5))
    assert res and res[0].document.id == "doc-9"

    cfg2 = make_cfg("sharded_ivf_int8")
    cfg2.device.n_replicas = 2
    db2 = VectorDatabase(config=cfg2)
    assert db2.index.replica_axis == "replica"
    docs2, vecs2 = make_docs(rng, 160)
    db2.batch_add_documents(docs2)
    res2 = db2.search(SearchRequest(vector=vecs2[33].tolist(), limit=5))
    assert res2 and res2[0].document.id == "doc-33"


def test_embedded_db_sharded_kind(tmp_path, rng):
    from grape_vector_db_tpu.config import EmbeddedConfig
    from grape_vector_db_tpu.embedded import EmbeddedVectorDB

    ecfg = EmbeddedConfig(data_dir=str(tmp_path / "emb"))
    ecfg.db = make_cfg("sharded_flat")
    emb = EmbeddedVectorDB(config=ecfg)
    try:
        docs, vecs = make_docs(rng, 80)
        emb.db.batch_add_documents(docs)
        res = emb.db.search(SearchRequest(vector=vecs[17].tolist(), limit=3))
        assert res and res[0].document.id == "doc-17"
        assert emb.db.stats().index_kind == "sharded_flat"
    finally:
        emb.close()


def test_cluster_node_serves_local_mesh_index():
    """ClusterNode on a multi-device host auto-upgrades to the mesh-sharded
    engine: node-level DCN scatter-gather composed with NVLink shard_map — the
    full two-level form of the reference's scatter-gather (shard.rs:759-901,
    where the inner level was mock)."""
    from grape_vector_db_tpu.distributed.cluster_service import ClusterService
    from grape_vector_db_tpu.distributed.raft import RaftConfig
    from grape_vector_db_tpu.distributed.types import ClusterConfig, ConsistencyLevel

    ccfg = ClusterConfig(
        shard_count=8, replica_count=2, consistency=ConsistencyLevel.SESSION,
        heartbeat_interval_s=0.2, election_timeout_ms=(80, 160),
        raft_heartbeat_ms=25.0,
    )
    dcfg = VectorDbConfig(vector_dimension=16)
    dcfg.device.storage_dtype = "float32"
    dcfg.index.initial_capacity = 256
    dcfg.cache.enabled = False
    rcfg = RaftConfig(election_timeout_ms=(80, 160), heartbeat_ms=25.0, tick_ms=5.0)
    svc = ClusterService(["node-0", "node-1", "node-2"], cluster_config=ccfg,
                         db_config=dcfg, raft_config=rcfg)
    svc.start()
    try:
        for node in svc.nodes.values():
            assert node.db.index.kind == "sharded_flat", (
                "ClusterNode must serve a mesh-sharded index on a >1-device host"
            )
        rng = np.random.default_rng(3)
        docs = [
            Document(id=f"doc-{i}", content=f"body {i}",
                     vector=rng.standard_normal(16).astype(np.float32).tolist())
            for i in range(60)
        ]
        assert svc.upsert(docs) == 60
        hits = svc.any_node().search(docs[13].vector, k=3)
        assert hits and hits[0][0] == "doc-13"
    finally:
        svc.stop()


@pytest.mark.parametrize("kind", ["sharded_ivf_int8_proj",
                                  "sharded_ivf_int4_proj"])
def test_sharded_projected_capacity_kind(rng, kind):
    """sharded_ivf_int{8,4}_proj: the capacity tier times the mesh — PCA
    projection + quantized lists sharded within each list across devices."""
    cfg = make_cfg(kind)
    cfg.vector_dimension = 256
    cfg.index.proj_dim = 128
    cfg.index.nlist = 8
    cfg.index.nprobe = 8
    db = VectorDatabase(config=cfg)
    spec = (1.0 + np.arange(256)) ** -0.5
    vecs = (rng.standard_normal((240, 256)) * spec[None, :]).astype(np.float32)
    docs = [Document(id=f"p{i}", content=f"c{i}", vector=vecs[i])
            for i in range(240)]
    db.batch_add_documents(docs)
    st = db.stats()
    assert st.index_kind == kind
    assert db.index.n_shards == 8 and db.index.proj_dim == 128
    res = db.search(SearchRequest(vector=vecs[13].tolist(), limit=3))
    assert res and res[0].document.id == "p13"
    db.batch_delete_documents(["p13"])
    res = db.search(SearchRequest(vector=vecs[13].tolist(), limit=3))
    assert all(r.document.id != "p13" for r in res)
