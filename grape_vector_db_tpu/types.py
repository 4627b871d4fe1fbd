"""Core schema / DTO module of the vector database.

This is the equivalent of the reference's ``src/types.rs`` (types.rs:5-536): the
`Point` / `Document` / `SparseVector` data model, search request/response types,
hybrid-search fusion strategies, and score breakdowns. Cluster/distributed types
live in :mod:`grape_vector_db_tpu.distributed.types`.

Design note: these are plain host-side Python dataclasses. Device-side state is
*never* stored here — vectors handed to the engine are converted to JAX arrays at
the shard boundary (see grape_vector_db_tpu.index.flat). That keeps the schema
layer import-light and serializable.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Point",
    "SparseVector",
    "Document",
    "DocumentRecord",
    "SearchParams",
    "SearchRequest",
    "SearchResult",
    "ScoredPoint",
    "ScoreBreakdown",
    "HybridSearchRequest",
    "FusionStrategy",
    "FusionWeights",
    "Filter",
    "Condition",
    "QueryMetrics",
    "new_id",
    "now_ms",
]


def new_id() -> str:
    return uuid.uuid4().hex


def now_ms() -> int:
    return int(time.time() * 1000)


# ---------------------------------------------------------------------------
# Vectors
# ---------------------------------------------------------------------------


@dataclass
class SparseVector:
    """Sparse vector with sorted, unique indices (reference types.rs:16-89).

    Supports dot product and cosine similarity against another sparse vector via
    sorted-merge, mirroring the reference's semantics exactly.
    """

    indices: List[int] = field(default_factory=list)
    values: List[float] = field(default_factory=list)

    def __post_init__(self) -> None:
        if len(self.indices) != len(self.values):
            raise ValueError("indices and values must have equal length")
        # Keep sorted by index (the reference maintains this invariant).
        if any(self.indices[i] >= self.indices[i + 1] for i in range(len(self.indices) - 1)):
            order = sorted(range(len(self.indices)), key=lambda i: self.indices[i])
            self.indices = [self.indices[i] for i in order]
            self.values = [self.values[i] for i in order]

    def dot(self, other: "SparseVector") -> float:
        """Sorted-merge dot product (reference types.rs:44-66)."""
        i = j = 0
        acc = 0.0
        a_idx, a_val = self.indices, self.values
        b_idx, b_val = other.indices, other.values
        while i < len(a_idx) and j < len(b_idx):
            if a_idx[i] == b_idx[j]:
                acc += a_val[i] * b_val[j]
                i += 1
                j += 1
            elif a_idx[i] < b_idx[j]:
                i += 1
            else:
                j += 1
        return acc

    def norm(self) -> float:
        return math.sqrt(sum(v * v for v in self.values))

    def cosine(self, other: "SparseVector") -> float:
        na, nb = self.norm(), other.norm()
        if na == 0.0 or nb == 0.0:
            return 0.0
        return self.dot(other) / (na * nb)

    def is_empty(self) -> bool:
        return not self.indices

    def to_dict(self) -> Dict[str, Any]:
        return {"indices": list(self.indices), "values": list(self.values)}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SparseVector":
        return SparseVector(list(d.get("indices", [])), list(d.get("values", [])))


@dataclass
class Point:
    """A vector point with payload (reference types.rs Point)."""

    id: str
    vector: List[float]
    payload: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Documents
# ---------------------------------------------------------------------------


@dataclass
class Document:
    """User-facing document (reference types.rs Document).

    ``vector`` may be None, in which case the embedding provider computes it at
    insert time (reference lib.rs:325-341).
    """

    id: str = ""
    content: str = ""
    title: Optional[str] = None
    language: Optional[str] = None
    version: Optional[str] = None
    doc_type: Optional[str] = None
    package_name: Optional[str] = None
    vector: Optional[List[float]] = None
    sparse_vector: Optional[SparseVector] = None
    metadata: Dict[str, Any] = field(default_factory=dict)
    created_at: int = field(default_factory=now_ms)
    updated_at: int = field(default_factory=now_ms)

    def to_dict(self) -> Dict[str, Any]:
        # hand-built (not dataclasses.asdict) — same rationale and
        # detachment contract as DocumentRecord.to_dict; this runs per
        # document on the cluster resync/migration wire paths
        vec = self.vector
        if isinstance(vec, list):
            vec = list(vec)
        elif hasattr(vec, "copy"):  # ndarray (this module stays numpy-free)
            vec = vec.copy()
        return {
            "id": self.id,
            "content": self.content,
            "title": self.title,
            "language": self.language,
            "version": self.version,
            "doc_type": self.doc_type,
            "package_name": self.package_name,
            "vector": vec,
            "sparse_vector": (None if self.sparse_vector is None
                              else self.sparse_vector.to_dict()),
            "metadata": dict(self.metadata),
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Document":
        d = dict(d)
        sv = d.get("sparse_vector")
        if sv is not None and not isinstance(sv, SparseVector):
            d["sparse_vector"] = SparseVector.from_dict(sv)
        known = {f.name for f in dataclasses.fields(Document)}
        return Document(**{k: v for k, v in d.items() if k in known})


@dataclass
class DocumentRecord:
    """Internal stored form of a Document (reference types.rs DocumentRecord):

    the persisted record keyed by id in the document store, carrying the dense
    embedding plus searchable text fields.
    """

    id: str
    content: str
    title: str = ""
    language: str = ""
    version: str = ""
    doc_type: str = ""
    package_name: str = ""
    embedding: Optional[List[float]] = None
    sparse_representation: Optional[SparseVector] = None
    metadata: Dict[str, Any] = field(default_factory=dict)
    created_at: int = field(default_factory=now_ms)
    updated_at: int = field(default_factory=now_ms)

    @staticmethod
    def from_document(doc: Document, embedding: Optional[List[float]] = None) -> "DocumentRecord":
        return DocumentRecord(
            id=doc.id,
            content=doc.content,
            title=doc.title or "",
            language=doc.language or "",
            version=doc.version or "",
            doc_type=doc.doc_type or "",
            package_name=doc.package_name or "",
            embedding=embedding if embedding is not None else doc.vector,
            sparse_representation=doc.sparse_vector,
            metadata=dict(doc.metadata),
            created_at=doc.created_at,
            updated_at=doc.updated_at,
        )

    def to_document(self) -> Document:
        return Document(
            id=self.id,
            content=self.content,
            title=self.title or None,
            language=self.language or None,
            version=self.version or None,
            doc_type=self.doc_type or None,
            package_name=self.package_name or None,
            vector=self.embedding,
            sparse_vector=self.sparse_representation,
            metadata=dict(self.metadata),
            created_at=self.created_at,
            updated_at=self.updated_at,
        )

    def to_dict(self) -> Dict[str, Any]:
        # hand-built rather than dataclasses.asdict: asdict deep-copies
        # recursively (5.5 us/record vs 0.5 — it was the top term of the
        # store serialization profile). Contract: the returned dict and the
        # embedding are detached at the top level; NESTED metadata values
        # are shared by reference (callers serialize immediately).
        emb = self.embedding
        if isinstance(emb, list):
            emb = list(emb)
        elif hasattr(emb, "copy"):  # ndarray (this module stays numpy-free)
            emb = emb.copy()
        return {
            "id": self.id,
            "content": self.content,
            "title": self.title,
            "language": self.language,
            "version": self.version,
            "doc_type": self.doc_type,
            "package_name": self.package_name,
            "embedding": emb,
            "sparse_representation": (
                None if self.sparse_representation is None
                else self.sparse_representation.to_dict()),
            "metadata": dict(self.metadata),
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DocumentRecord":
        d = dict(d)
        sv = d.get("sparse_representation")
        if sv is not None and not isinstance(sv, SparseVector):
            d["sparse_representation"] = SparseVector.from_dict(sv)
        known = {f.name for f in dataclasses.fields(DocumentRecord)}
        return DocumentRecord(**{k: v for k, v in d.items() if k in known})


# ---------------------------------------------------------------------------
# Filters (schema only — evaluation lives in engine/filtering.py)
# ---------------------------------------------------------------------------


@dataclass
class Condition:
    """A single filter condition (reference types.rs Filter/Condition).

    ``op`` is one of: eq, ne, gt, gte, lt, lte, like, in, is_null, is_not_null,
    exists, array_contains, text_match, geo_within_distance, geo_bounding_box.
    """

    field: str
    op: str
    value: Any = None

    def to_dict(self) -> Dict[str, Any]:
        return {"field": self.field, "op": self.op, "value": self.value}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Condition":
        return Condition(d["field"], d["op"], d.get("value"))


@dataclass
class Filter:
    """Boolean combination of conditions.

    ``must`` = AND, ``should`` = OR, ``must_not`` = NOT — Qdrant-style, matching
    the reference's Logical{And,Or,Not} filter expressions (filtering.rs:39-148).
    Members may be Condition or nested Filter.
    """

    must: List[Any] = field(default_factory=list)
    should: List[Any] = field(default_factory=list)
    must_not: List[Any] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not (self.must or self.should or self.must_not)

    def to_dict(self) -> Dict[str, Any]:
        def conv(x):
            return x.to_dict() if hasattr(x, "to_dict") else x

        return {
            "must": [conv(x) for x in self.must],
            "should": [conv(x) for x in self.should],
            "must_not": [conv(x) for x in self.must_not],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Filter":
        def conv(x):
            if isinstance(x, (Condition, Filter)):
                return x
            if isinstance(x, dict) and "op" in x:
                return Condition.from_dict(x)
            if isinstance(x, dict):
                return Filter.from_dict(x)
            raise ValueError(f"bad filter member: {x!r}")

        return Filter(
            must=[conv(x) for x in d.get("must", [])],
            should=[conv(x) for x in d.get("should", [])],
            must_not=[conv(x) for x in d.get("must_not", [])],
        )


# ---------------------------------------------------------------------------
# Search requests / responses
# ---------------------------------------------------------------------------


@dataclass
class SearchParams:
    """Per-request search tuning (reference types.rs:156-171 SearchParams).

    ``ef`` is the reference's HNSW beam-width knob; here it maps onto the
    engine's equivalent precision dial — the IVF families take it as a
    per-request ``nprobe`` override (clamped to [1, nlist]); engines with no
    per-request dial ignore it. ``with_vector``/``with_payload`` override the
    request-level flags when params are provided."""

    ef: Optional[int] = None
    with_vector: bool = False
    with_payload: bool = True
    # Per-request host-tier rescore width (overrides config.query.host_rescore
    # when set): the device index over-fetches this many candidates and the
    # query engine re-ranks them exactly against the full-precision embeddings
    # in the document store. 0 disables for this request.
    host_rescore: Optional[int] = None


@dataclass
class SearchRequest:
    """Dense / text search request (reference types.rs SearchRequest)."""

    query: Optional[str] = None
    vector: Optional[List[float]] = None
    limit: int = 10
    offset: int = 0
    score_threshold: Optional[float] = None
    filter: Optional[Filter] = None
    with_vectors: bool = False
    with_payload: bool = True
    params: Optional[SearchParams] = None


class FusionStrategy(str, enum.Enum):
    """5 fusion strategies (reference types.rs:226-260)."""

    RRF = "rrf"
    LINEAR = "linear"
    NORMALIZED = "normalized"
    LEARNED = "learned"
    ADAPTIVE = "adaptive"


@dataclass
class FusionWeights:
    """Dense/sparse/text weights (reference config defaults 0.7/0.2/0.1)."""

    dense: float = 0.7
    sparse: float = 0.2
    text: float = 0.1

    def normalized(self) -> "FusionWeights":
        s = self.dense + self.sparse + self.text
        if s <= 0:
            return FusionWeights(1.0, 0.0, 0.0)
        return FusionWeights(self.dense / s, self.sparse / s, self.text / s)


@dataclass
class HybridSearchRequest:
    """Hybrid dense+sparse+text request (reference types.rs HybridSearchRequest)."""

    query: Optional[str] = None
    dense_vector: Optional[List[float]] = None
    sparse_vector: Optional[SparseVector] = None
    limit: int = 10
    fusion_strategy: FusionStrategy = FusionStrategy.RRF
    rrf_k: float = 60.0
    weights: FusionWeights = field(default_factory=FusionWeights)
    filter: Optional[Filter] = None
    score_threshold: Optional[float] = None
    with_snippets: bool = True


@dataclass
class ScoreBreakdown:
    """Per-channel score contributions (reference types.rs:436-446)."""

    dense_score: Optional[float] = None
    sparse_score: Optional[float] = None
    text_score: Optional[float] = None
    final_score: float = 0.0


@dataclass
class ScoredPoint:
    """A scored hit (reference types.rs ScoredPoint)."""

    id: str
    score: float
    vector: Optional[List[float]] = None
    payload: Dict[str, Any] = field(default_factory=dict)
    breakdown: Optional[ScoreBreakdown] = None


@dataclass
class SearchResult:
    """Document-oriented search hit (reference types.rs SearchResult)."""

    document: Document
    score: float
    snippet: Optional[str] = None
    breakdown: Optional[ScoreBreakdown] = None

    @property
    def id(self) -> str:
        return self.document.id


@dataclass
class QueryMetrics:
    """Per-query metrics for the feedback loop (reference types.rs QueryMetrics)."""

    query: str = ""
    strategy: str = ""
    latency_ms: float = 0.0
    result_count: int = 0
    clicked_ids: List[str] = field(default_factory=list)
    satisfaction: Optional[float] = None
    timestamp: int = field(default_factory=now_ms)
