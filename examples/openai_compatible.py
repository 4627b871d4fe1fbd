"""Embedding-provider demo (reference examples/openai_compatible.rs): the
provider trait covering OpenAI-compatible HTTP endpoints (openai / azure /
nvidia / huggingface / ollama) and the deterministic offline Mock provider.

Runs fully offline with the Mock provider; flip ``provider`` to an HTTP config
(endpoint + api key) to hit a real service — same code path, with batching and
linear-backoff retry."""

import numpy as np

from grape_vector_db_tpu import Document, SearchRequest, VectorDatabase, VectorDbConfig
from grape_vector_db_tpu.services.embeddings import (
    MockEmbeddingProvider,
    create_provider,
)


def main() -> None:
    dim = 64
    # Offline deterministic provider (the reference's standard test fixture):
    provider = MockEmbeddingProvider(dim)
    # Real service instead (same code path, batching + retry built in):
    # from grape_vector_db_tpu.config import EmbeddingConfig
    # provider = create_provider(EmbeddingConfig(
    #     provider="openai", endpoint="https://api.openai.com/v1",
    #     api_key="sk-...", model="text-embedding-3-small", dimension=1536))

    texts = [
        "the mitochondria is the powerhouse of the cell",
        "GPUs multiply matrices very fast",
        "a recipe for sourdough bread",
        "matrix multiplication on accelerators",
    ]
    vectors = provider.generate_embeddings(texts)
    print(f"embedded {len(vectors)} texts at dim={len(vectors[0])}")
    # deterministic: same text -> same vector
    again = provider.generate_embedding(texts[0])
    assert np.allclose(vectors[0], again)

    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.index.initial_capacity = 256
    db = VectorDatabase(config=cfg)
    db.batch_add_documents([
        Document(id=f"t{i}", content=t, vector=list(map(float, v)))
        for i, (t, v) in enumerate(zip(texts, vectors))
    ])

    # The Mock provider is deterministic (hash-based, not semantic), so the
    # demo assertion is exact self-retrieval; a real provider makes this a
    # semantic search.
    q = provider.generate_embedding(texts[1])
    hits = db.vector_search(SearchRequest(vector=list(map(float, q)), limit=2))
    print("top-2:", [(h.id, round(h.score, 3)) for h in hits])
    assert hits[0].id == "t1"
    db.close()
    print("openai_compatible OK")


if __name__ == "__main__":
    main()
