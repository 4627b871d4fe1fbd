"""Multi-chip serving through the product API (r3): a VectorDatabase whose
index is mesh-sharded over every local device.

Run on any machine — the demo forces an 8-device virtual CPU mesh, the same
code path a real multi-GPU host takes (`jax.sharding.Mesh` + shard_map
local top-k + one all_gather over NVLink).

Shows:
- kind="sharded_ivf_int8" through the ordinary VectorDatabase facade
- the 2D replica x shard layout via device.n_replicas
- device.auto_shard (what ClusterNode enables: any >1-device host serves a
  mesh index automatically)
- the capacity tier kind="ivf_int8_proj" (PCA 768->384 + int8 lists)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from grape_vector_db_tpu import Document, SearchRequest, VectorDatabase, VectorDbConfig


def make_docs(rng, n, dim):
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    return [
        Document(id=f"doc-{i}", content=f"document {i}", vector=vecs[i])
        for i in range(n)
    ], vecs


def main() -> None:
    rng = np.random.default_rng(0)
    print(f"devices: {jax.device_count()} x {jax.default_backend()}")

    # 1) explicit sharded kind: corpus rows sharded across the mesh,
    #    searches run as one SPMD program with a single all_gather merge
    cfg = VectorDbConfig(vector_dimension=128)
    cfg.index.kind = "sharded_ivf_int8"
    cfg.index.nlist = 16
    cfg.index.nprobe = 8
    cfg.device.storage_dtype = "float32"
    db = VectorDatabase(config=cfg)
    docs, vecs = make_docs(rng, 400, 128)
    db.batch_add_documents(docs)
    hits = db.search(SearchRequest(vector=vecs[7].tolist(), limit=3))
    print("sharded_ivf_int8:", db.stats().index_kind,
          "->", [h.document.id for h in hits])

    # 2) 2D replica x shard mesh: the query batch splits over 2 replica
    #    lanes, the corpus shards over 4 devices within each lane
    cfg2 = VectorDbConfig(vector_dimension=128)
    cfg2.index.kind = "sharded_flat"
    cfg2.device.n_replicas = 2
    cfg2.device.storage_dtype = "float32"
    db2 = VectorDatabase(config=cfg2)
    db2.batch_add_documents(docs)
    hits = db2.search(SearchRequest(vector=vecs[11].tolist(), limit=3))
    print(f"sharded_flat 2D (replicas={db2.index.n_replicas} x "
          f"shards={db2.index.n_shards}):",
          "->", [h.document.id for h in hits])

    # 3) auto_shard: what ClusterNode turns on — plain kinds upgrade to
    #    their sharded twins whenever the host has >1 device
    cfg3 = VectorDbConfig(vector_dimension=128)
    cfg3.index.kind = "flat"
    cfg3.device.auto_shard = True
    cfg3.device.storage_dtype = "float32"
    db3 = VectorDatabase(config=cfg3)
    db3.batch_add_documents(docs[:100])
    print("auto_shard upgraded 'flat' ->", db3.stats().index_kind)

    # 4) capacity tier: PCA-projected int8 (the matmul-friendly way below
    #    int8's bytes/row — PQ's LUT/ADC scan is gather-bound)
    cfg4 = VectorDbConfig(vector_dimension=256)
    cfg4.index.kind = "ivf_int8_proj"
    cfg4.index.proj_dim = 128
    cfg4.index.nlist = 16
    cfg4.index.nprobe = 8
    cfg4.device.storage_dtype = "float32"
    db4 = VectorDatabase(config=cfg4)
    spec = (1.0 + np.arange(256)) ** -0.5
    docs4, vecs4 = make_docs(rng, 400, 256)
    for d, v in zip(docs4, vecs4):
        d.vector = (v * spec).astype(np.float32)
    db4.batch_add_documents(docs4)
    hits = db4.search(SearchRequest(vector=docs4[5].vector.tolist(), limit=3))
    print("ivf_int8_proj (768->384-style projection at 256->128):",
          "->", [h.document.id for h in hits])


if __name__ == "__main__":
    main()
