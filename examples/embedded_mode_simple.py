"""Embedded mode quick start (mirrors the reference's
examples/embedded_mode_simple.rs workload: create, upsert, search, stats)."""

import numpy as np

from grape_vector_db_tpu import (
    Document,
    EmbeddedConfig,
    EmbeddedVectorDB,
    SearchRequest,
    VectorDbConfig,
)


def main() -> None:
    cfg = EmbeddedConfig(
        data_dir="./example_data",
        db=VectorDbConfig(vector_dimension=384),
    )
    with EmbeddedVectorDB(cfg) as db:
        docs = [
            Document(id="rust", title="Rust", content="systems programming with memory safety"),
            Document(id="jax", title="JAX", content="composable function transformations on accelerators"),
            Document(id="gpu", title="GPU", content="tensor cores and high bandwidth memory"),
            Document(id="pasta", title="Pasta", content="boil water, add salt, cook al dente"),
        ]
        db.upsert(docs)

        results = db.search(SearchRequest(query="accelerator programming", limit=3))
        for r in results:
            print(f"{r.score:.3f}  {r.document.id:8s} {r.snippet}")

        stats = db.stats()
        print(f"\ndocs={stats.document_count} index={stats.index_kind} "
              f"mem={stats.index_memory_mb:.1f}MB health={db.health_check().status.value}")


if __name__ == "__main__":
    main()
