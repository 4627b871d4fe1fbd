"""Layered configuration — single config tree (file + env + overrides).

Replaces the reference's *two* same-named ``VectorDbConfig`` types (config.rs:167-471
and types.rs:949-998) with one layered system:

    defaults  <  TOML file  <  environment (GRAPE_*)  <  explicit kwargs

Defaults follow the reference's tables: vector_dimension=768 (config.rs:400),
HNSW m=16 / ef_construction=200 / ef_search=100 (config.rs:167-192), hybrid weights
0.7/0.2/0.1 with RRF k=60 (config.rs:113-138), sparse vocabulary 100k (config.rs:140-165).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

try:  # py3.11+
    import tomllib
except ImportError:  # pragma: no cover
    tomllib = None

__all__ = [
    "IndexConfig",
    "BinaryQuantizationConfig",
    "CacheConfig",
    "PersistenceConfig",
    "QueryConfig",
    "Bm25Config",
    "HybridSearchConfig",
    "SparseVectorConfig",
    "EmbeddingConfig",
    "DeviceConfig",
    "TlsConfig",
    "VectorDbConfig",
    "EmbeddedConfig",
    "load_config",
]


@dataclass
class IndexConfig:
    """ANN index parameters (reference index.rs:22-32, config.rs HnswConfig).

    ``kind`` selects the index family: "flat" (exact device scan), "binary"
    (Hamming pre-scan + rescore), "int8" (int8 scan at 2x HBM efficiency +
    exact rescore), "ivf"/"ivf_pq"/"pq" (partitioned / quantized scans),
    "graph" (batched fixed-degree beam search).
    """

    kind: str = "flat"
    # Graph parameters (HNSW-equivalent knobs)
    m: int = 16
    ef_construction: int = 200
    ef_search: int = 100
    max_layers: int = 16
    # IVF parameters
    nlist: int = 256
    nprobe: int = 16
    # Device array growth
    initial_capacity: int = 4096
    # When kind="binary"/"pq": candidates rescored = max(limit, rescore_ratio * n)
    rescore_ratio: float = 0.1
    # When kind="int8"/"ivf_int8": fixed rescore candidate count (int8 stage-1
    # ranking is near-exact, so a small constant suffices)
    int8_rescore: int = 64
    # When kind="ivf_int8": keep a bf16 shadow for exact rescore (bandwidth
    # config, 1.5x memory). False = int8-only capacity config (~2x rows/chip;
    # search returns dequantized scores, no exact rescore).
    ivf_int8_keep_bf16: bool = True
    # PQ parameters (kind="pq"/"ivf_pq"): subspaces (None -> dim // 8),
    # bits/code, residual coding, and the rescore plane ("bf16" shadow,
    # "int8" shadow, or "none" = codes-only capacity tier).
    pq_n_sub: Optional[int] = None
    pq_nbits: int = 8
    pq_residual: bool = True
    pq_resident: str = "bf16"
    pq_rescore_k: int = 256
    # When kind="ivf_int8_proj": PCA projection width (128-aligned, < dim) —
    # the matmul-friendly capacity tier (~dim/proj_dim x more rows/device than int8)
    proj_dim: int = 384


@dataclass
class BinaryQuantizationConfig:
    """Binary quantization knobs (reference quantization.rs:10-31)."""

    enabled: bool = False
    threshold: float = 0.0
    rescore_ratio: float = 0.1
    enable_cache: bool = True
    # False = codes-only capacity config: 32x compression, prescan ranking
    # (the reference's BinaryVectorStore promise, quantization.rs:286-354).
    keep_vectors: bool = True
    # "asym" = dot(q_unit, sign(x)) stage-1 ranking (same matmul as
    # Hamming, strictly better recall — index/binary.py); "hamming" = the
    # reference's symmetric ranking (quantization.rs:151-193).
    prescan: str = "asym"


@dataclass
class CacheConfig:
    """Result/embedding cache (reference performance/cache_manager.rs:5-91)."""

    enabled: bool = True
    query_cache_size: int = 50_000
    embedding_cache_size: int = 100_000
    ttl_seconds: float = 1800.0


@dataclass
class PersistenceConfig:
    sync_writes: bool = False
    flush_interval_ms: int = 1000
    compression: bool = True  # zlib payload compression


@dataclass
class QueryConfig:
    default_limit: int = 10
    max_limit: int = 100
    default_threshold: float = 0.0
    text_weight: float = 0.3
    timeout_ms: int = 30_000
    # Host-tier exact rescore width (0 = off). When > 0, dense searches
    # over-fetch this many candidates from the device index and re-rank them
    # exactly against the full-precision embeddings in the document store.
    # This is what lets the codes-only capacity configs (binary
    # keep_vectors=False, ivf_int4/ivf_int8 keep_bf16=False, projected kinds)
    # serve high-recall reads: HBM holds compressed codes, host RAM holds the
    # recall. The device-side analog of the reference rescoring binary
    # candidates from stored vectors (quantization.rs:286-354).
    host_rescore: int = 0
    # Selectivity-aware filtered search on probe-based indexes (IVF family,
    # mask_exact=False — an in-probe mask only covers the probed lists, so
    # at low selectivity most allowed rows sit in unprobed lists and recall
    # against the masked oracle collapses). When a filter allows at most ``filter_exact_max``
    # ids, the planner skips the device entirely and scores the allowed
    # rows' full-precision store embeddings on host (exact, and cheaper
    # than a dispatch at this size). Between that and
    # ``filter_exhaustive_below`` x index-size allowed rows, it runs the
    # exact device tier (ops/ivf_scan.py): compact gather-scan of just the
    # allowed rows when they fit the HBM budget, else one streaming corpus
    # pass + k-list probe. Above, the normal masked probe is near-exact.
    # 0 / 0.0 disable each tier.
    # The 0.25 threshold is a default: the in-probe mask's recall falls
    # with selectivity (near-exact when a quarter of the rows are allowed,
    # far from it at a few percent), and the exactness contract
    # (filtering.rs:374-400) needs the exact tier wherever it falls short.
    filter_exact_max: int = 8192
    filter_exhaustive_below: float = 0.25


@dataclass
class Bm25Config:
    """BM25 constants (reference sparse.rs:41-53)."""

    k1: float = 1.2
    b: float = 0.75


@dataclass
class HybridSearchConfig:
    """Fusion defaults (reference config.rs:113-138)."""

    fusion_strategy: str = "rrf"
    rrf_k: float = 60.0
    dense_weight: float = 0.7
    sparse_weight: float = 0.2
    text_weight: float = 0.1
    bm25: Bm25Config = field(default_factory=Bm25Config)
    max_candidates: int = 100


@dataclass
class SparseVectorConfig:
    """Sparse index sizing (reference config.rs:140-165)."""

    max_vocabulary_size: int = 100_000
    vocabulary_update_interval: int = 1000


@dataclass
class EmbeddingConfig:
    """Embedding provider selection (reference embeddings.rs / config.rs)."""

    provider: str = "mock"  # mock | device | openai | azure | nvidia | huggingface | ollama
    endpoint: Optional[str] = None
    api_key: Optional[str] = None
    # Azure deployments version their REST API via ?api-version= (lib.rs:806)
    api_version: Optional[str] = None
    model: str = "text-embedding-3-small"
    dimension: int = 768
    batch_size: int = 128
    max_retries: int = 3
    timeout_s: float = 30.0
    extra_headers: Dict[str, str] = field(default_factory=dict)
    # provider="device" (DeviceHashEmbedder — no reference analog): hashed
    # feature space size and projection seed; larger buckets = fewer
    # collisions at ~buckets*dimension*2 bytes of HBM for the projection
    hash_buckets: int = 32_768
    hash_seed: int = 0
    hash_max_features: int = 256


@dataclass
class DeviceConfig:
    """Device placement knobs (no reference analog — an accelerator addition)."""

    # Store vectors on device in this dtype; scores always accumulate in f32.
    storage_dtype: str = "bfloat16"
    # Device batch the executor packs concurrent queries into.
    max_query_batch: int = 64
    # How long the micro-batching executor waits to fill a batch. Higher =
    # fewer, fuller device launches (throughput); lower = lower p50 latency.
    # Where each launch carries a high fixed cost (a remote device, a busy
    # host), throughput-bound deployments want 5-10 ms here.
    micro_batch_wait_ms: float = 2.0
    # Coordinator-side leg batching: pack concurrent session-less
    # scatter-gather legs headed to the SAME node into one
    # data_search_batch RPC. Off by default: the per-node
    # BatchingExecutor already packs concurrent legs at the data-RPC
    # layer, so the coordinator window is a second serial wait in the
    # path (double batching). Default off; the knob remains for
    # deployments whose per-leg RPC overhead dominates (e.g. many
    # coordinator->node hops over a high-latency DCN where cutting leg
    # COUNT matters more than the window).
    coordinator_batch: bool = False
    # Mesh axis names for corpus sharding / replication.
    shard_axis: str = "shard"
    replica_axis: str = "replica"
    # Mesh construction for the sharded_* index kinds: corpus shards
    # (None = every local device) and data-parallel replica lanes
    # (n_replicas > 1 builds a 2D replica x shard mesh; the query batch
    # splits over replicas, the corpus shards within each replica).
    n_shards: Optional[int] = None
    n_replicas: int = 1
    # Auto-upgrade flat/ivf/ivf_int8 to their sharded twins when the host
    # has more than one local device (ClusterNode turns this on: DCN
    # scatter-gather between nodes, NVLink shard_map within a node).
    auto_shard: bool = False
    # Capacity bucket growth factor (re-jit happens per bucket).
    growth_factor: int = 2
    # Top-k engine: "exact" (iterative max-and-mask, recall 1.0) or "approx"
    # (lax.approx_max_k; recall_target below).
    search_mode: str = "exact"
    recall_target: float = 0.99


@dataclass
class TlsConfig:
    """Transport security for the gRPC + REST surfaces (reference
    EnterpriseConfig.tls, enterprise.rs:786,874 — there it was config-only;
    here it actually wires into the listeners and channels)."""

    enabled: bool = False
    cert_path: Optional[str] = None   # PEM server certificate (chain)
    key_path: Optional[str] = None    # PEM private key
    ca_path: Optional[str] = None     # root CA clients/peers verify against
    require_client_auth: bool = False  # mTLS: verify client certs against ca
    # Client-side: override the expected server name (self-signed/test certs).
    target_name_override: Optional[str] = None


@dataclass
class VectorDbConfig:
    """Top-level database config (unifies reference config.rs:167-192 and
    types.rs:949-998)."""

    vector_dimension: int = 768
    distance: str = "cosine"  # cosine | dot | euclidean
    index: IndexConfig = field(default_factory=IndexConfig)
    quantization: BinaryQuantizationConfig = field(default_factory=BinaryQuantizationConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    persistence: PersistenceConfig = field(default_factory=PersistenceConfig)
    query: QueryConfig = field(default_factory=QueryConfig)
    hybrid: HybridSearchConfig = field(default_factory=HybridSearchConfig)
    sparse: SparseVectorConfig = field(default_factory=SparseVectorConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    tls: TlsConfig = field(default_factory=TlsConfig)

    # -- embedding-provider convenience constructors (lib.rs:792-824) -------

    @classmethod
    def with_openai_compatible(cls, endpoint: str, api_key: str,
                               model: str) -> "VectorDbConfig":
        cfg = cls()
        cfg.embedding.provider = "openai"
        cfg.embedding.endpoint = endpoint
        cfg.embedding.api_key = api_key
        cfg.embedding.model = model
        return cfg

    @classmethod
    def with_azure_openai(cls, endpoint: str, api_key: str,
                          deployment_name: str,
                          api_version: Optional[str] = None) -> "VectorDbConfig":
        cfg = cls()
        cfg.embedding.provider = "azure"
        cfg.embedding.endpoint = endpoint
        cfg.embedding.api_key = api_key
        cfg.embedding.model = deployment_name
        cfg.embedding.api_version = api_version
        return cfg

    @classmethod
    def with_ollama(cls, endpoint: str, model: str) -> "VectorDbConfig":
        cfg = cls()
        cfg.embedding.provider = "ollama"
        cfg.embedding.endpoint = endpoint
        cfg.embedding.model = model
        return cfg


@dataclass
class EmbeddedConfig:
    """Embedded-mode lifecycle config (reference embedded.rs:32-68)."""

    data_dir: Optional[str] = None
    max_memory_mb: int = 512
    thread_pool_size: int = 4
    startup_timeout_s: float = 30.0
    shutdown_timeout_s: float = 30.0
    enable_warmup: bool = True
    health_check_interval_s: float = 30.0
    db: VectorDbConfig = field(default_factory=VectorDbConfig)


# ---------------------------------------------------------------------------
# Loading / merging
# ---------------------------------------------------------------------------

_ENV_PREFIX = "GRAPE_"


def _merge_into(obj: Any, data: Dict[str, Any]) -> Any:
    """Recursively apply a dict onto a dataclass tree."""
    for k, v in data.items():
        if not hasattr(obj, k):
            continue
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_into(cur, v)
        else:
            setattr(obj, k, v)
    return obj


def _apply_env(obj: Any, prefix: str = _ENV_PREFIX) -> None:
    """GRAPE_VECTOR_DIMENSION=512, GRAPE_INDEX__KIND=ivf (double underscore nests)."""
    for key, raw in os.environ.items():
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):].lower().split("__")
        target = obj
        for part in path[:-1]:
            if not hasattr(target, part):
                target = None
                break
            target = getattr(target, part)
        if target is None or not hasattr(target, path[-1]):
            continue
        cur = getattr(target, path[-1])
        try:
            if isinstance(cur, bool):
                val: Any = raw.lower() in ("1", "true", "yes", "on")
            elif isinstance(cur, int):
                val = int(raw)
            elif isinstance(cur, float):
                val = float(raw)
            else:
                val = raw
        except ValueError:
            continue
        setattr(target, path[-1], val)


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
    env: bool = True,
) -> VectorDbConfig:
    """Build a VectorDbConfig: defaults < TOML file < env < overrides.

    Mirrors the reference's SystemConfig path-fallback loader (config.rs:344-396):
    if ``path`` is None, tries ``config/system_config.toml`` then
    ``system_config.toml`` in the working directory.
    """
    cfg = VectorDbConfig()
    candidates = [path] if path else ["config/system_config.toml", "system_config.toml"]
    for cand in candidates:
        if cand and os.path.exists(cand) and tomllib is not None:
            with open(cand, "rb") as f:
                _merge_into(cfg, tomllib.load(f))
            break
    if env:
        _apply_env(cfg)
    if overrides:
        _merge_into(cfg, overrides)
    return cfg
