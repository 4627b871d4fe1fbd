"""grape_vector_db_tpu — a vector database framework for NVIDIA GPUs.

A from-scratch rebuild of the capability surface of ``putao520/grape-vector-db``
(a Rust/sled/HNSW vector DB) designed accelerator-first: the search core is
batched JAX/XLA/Pallas kernels over device-resident vector shards (chunked matmul + top-k,
XOR+popcount Hamming pre-scan, masked filtered search), the corpus shards across
a ``jax.sharding.Mesh`` with per-shard top-k merged by one all_gather, and the
host side provides storage/WAL, hybrid BM25 fusion, filtering, lifecycle,
metrics, resilience, auth, and a distributed control plane.

Deployment modes (README.md:43-47 of the reference):
- embedded:    :class:`EmbeddedVectorDB` (in-process, blocking + async)
- single node: ``grape_vector_db_tpu.server`` (gRPC/REST service)
- cluster:     ``grape_vector_db_tpu.distributed`` (shards/replication/Raft)
"""

from grape_vector_db_tpu.config import (
    EmbeddedConfig,
    VectorDbConfig,
    load_config,
)
from grape_vector_db_tpu.db import DatabaseStats, VectorDatabase
from grape_vector_db_tpu.embedded import CheckResult, CheckStatus, DbState, EmbeddedVectorDB
from grape_vector_db_tpu.errors import VectorDbError
from grape_vector_db_tpu.types import (
    Condition,
    Document,
    Filter,
    FusionStrategy,
    FusionWeights,
    HybridSearchRequest,
    Point,
    ScoredPoint,
    SearchParams,
    SearchRequest,
    SearchResult,
    SparseVector,
)

__version__ = "0.1.0"

__all__ = [
    "VectorDatabase",
    "EmbeddedVectorDB",
    "DatabaseStats",
    "VectorDbConfig",
    "EmbeddedConfig",
    "load_config",
    "Document",
    "Point",
    "SparseVector",
    "SearchParams",
    "SearchRequest",
    "SearchResult",
    "ScoredPoint",
    "HybridSearchRequest",
    "FusionStrategy",
    "FusionWeights",
    "Filter",
    "Condition",
    "VectorDbError",
    "DbState",
    "CheckStatus",
    "CheckResult",
    "__version__",
]
