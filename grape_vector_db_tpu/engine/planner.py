"""QueryEngine — the unified query planner.

The reference carries *two* parallel QueryEngine types (query.rs:31-35 owns an
HNSW index and merges vector+text scores itself; query_engine.rs:38-43 delegates
to the store and adds a moka cache) — SURVEY.md §1 calls for unifying them. This
planner is that unification: it owns the device index, sparse index, and store;
dispatches vector / text / hybrid queries; applies optimizer rules; and fronts a
TTL result cache.

Optimizer rules (query_engine.rs:239-373): LimitMaxResults (cap 100),
MinSimilarityThreshold (floor 0.1 when requested threshold is lower but set),
and query rewrite (trim/normalize whitespace).

Dense+text merge semantics follow query.rs:75-182: dense hits get rank-decay
weighting, text hits come from the substring scan, scores merge additively.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from grape_vector_db_tpu.config import QueryConfig
from grape_vector_db_tpu.engine.cache import TtlCache
from grape_vector_db_tpu.engine.hybrid import HybridSearchEngine, extract_snippet
from grape_vector_db_tpu.engine.sparse import SparseIndex
from grape_vector_db_tpu.index.base import VectorIndex
from grape_vector_db_tpu.services.metrics import MetricsCollector, QueryTimer
from grape_vector_db_tpu.storage.store import DocumentStore
from grape_vector_db_tpu.types import (
    HybridSearchRequest,
    ScoredPoint,
    SearchRequest,
    SearchResult,
)

__all__ = ["QueryEngine", "QueryOptimizer"]


@dataclass
class QueryOptimizer:
    """Rule-based request rewriting (query_engine.rs:239-373)."""

    max_limit: int = 100
    min_threshold: float = 0.1

    def optimize(self, req: SearchRequest) -> SearchRequest:
        limit = min(max(1, req.limit), self.max_limit)
        threshold = req.score_threshold
        if threshold is not None and threshold < self.min_threshold:
            threshold = self.min_threshold
        query = " ".join(req.query.split()) if req.query else req.query
        return SearchRequest(
            query=query,
            vector=req.vector,
            limit=limit,
            offset=req.offset,
            score_threshold=threshold,
            filter=req.filter,
            with_vectors=req.with_vectors,
            with_payload=req.with_payload,
            params=req.params,
        )


class QueryEngine:
    def __init__(
        self,
        index: VectorIndex,
        sparse_index: SparseIndex,
        store: DocumentStore,
        config: Optional[QueryConfig] = None,
        metrics: Optional[MetricsCollector] = None,
        hybrid: Optional[HybridSearchEngine] = None,
        cache_size: int = 50_000,
        cache_ttl_s: float = 1800.0,
        enable_cache: bool = True,
        filter_engine=None,
    ):
        self.index = index
        self.sparse = sparse_index
        self.store = store
        self.config = config or QueryConfig()
        self.metrics = metrics or MetricsCollector()
        self.optimizer = QueryOptimizer(max_limit=self.config.max_limit)
        self.hybrid = hybrid or HybridSearchEngine(index, sparse_index, store)
        self.filter_engine = filter_engine
        self._cache: Optional[TtlCache] = (
            TtlCache(cache_size, cache_ttl_s) if enable_cache else None
        )

    # -- cache helpers ------------------------------------------------------------

    def _cache_key(self, kind: str, req: SearchRequest) -> Optional[tuple]:
        if self._cache is None:
            return None
        vec_key = None
        if req.vector is not None:
            vec_key = np.asarray(req.vector, dtype=np.float32).tobytes()
        filt_key = repr(req.filter.to_dict()) if req.filter else None
        ef = req.params.ef if req.params is not None else None
        return (kind, req.query, vec_key, req.limit, req.offset, req.score_threshold,
                filt_key, req.with_vectors, req.with_payload, ef)

    def invalidate_cache(self) -> None:
        if self._cache is not None:
            self._cache.invalidate_all()

    # -- filtering hook -------------------------------------------------------------

    def _allowed_ids(self, req: SearchRequest) -> Optional[set]:
        if req.filter is None or req.filter.is_empty():
            return None
        if self.filter_engine is None:
            return None
        return set(self.filter_engine.execute_filter(req.filter))

    def _apply_filter(self, hits: List[Tuple[str, float]], allowed: Optional[set]):
        if allowed is None:
            return hits
        return [(i, s) for i, s in hits if i in allowed]

    # -- host-tier exact rescore ------------------------------------------------------

    def _host_rescore_width(self, req: Optional[SearchRequest] = None) -> int:
        if (req is not None and req.params is not None
                and req.params.host_rescore is not None):
            return max(0, int(req.params.host_rescore))
        return max(0, int(getattr(self.config, "host_rescore", 0)))

    def _host_rescore_rows(
        self,
        queries: np.ndarray,
        rows: List[List[Tuple[str, float]]],
        k: int,
    ) -> List[List[Tuple[str, float]]]:
        """Exact re-rank of device candidates against the full-precision
        embeddings in the document store. The codes-only capacity configs
        (binary keep_vectors=False, ivf_int4/ivf_int8 keep_bf16=False, the
        projected kinds) rank approximately over compressed codes on-device;
        the store still holds the original vector, so recomputing the true
        metric for the C survivors restores recall at host cost O(C·D) per
        query. Reference parity: binary candidates rescored from stored
        vectors (quantization.rs:286-354), done at the query-engine tier so
        every index family gets it. Candidates without a stored embedding
        keep their device score."""
        metric = getattr(self.index, "metric", "cosine")
        out = []
        for q, row in zip(queries, rows):
            if not row:
                out.append(row)
                continue
            ids = [i for i, _ in row]
            recs = self.store.batch_get(ids)
            embs, keep = [], []
            for j, rec in enumerate(recs):
                if rec is not None and rec.embedding is not None:
                    embs.append(np.asarray(rec.embedding, dtype=np.float32))
                    keep.append(j)
            if not embs:
                out.append(row[:k])
                continue
            m = np.empty((len(embs), embs[0].shape[0]), np.float32)
            for j, e in enumerate(embs):
                m[j] = e
            q32 = np.asarray(q, dtype=np.float32)
            if metric == "dot":
                scores = m @ q32
            else:
                qn = q32 / max(float(np.linalg.norm(q32)), 1e-12)
                scores = (m @ qn) / np.maximum(
                    np.linalg.norm(m, axis=1), 1e-12)
            exact = {ids[j]: float(s) for j, s in zip(keep, scores)}
            rescored = [(i, exact.get(i, s)) for i, s in row]
            rescored.sort(key=lambda t: -t[1])
            out.append(rescored[:k])
        return out

    def _host_exact_over_ids(
        self,
        queries: np.ndarray,
        ids,
        k: int,
    ) -> Optional[List[List[Tuple[str, float]]]]:
        """Exact dense top-k over an explicit allowed-id set, scored on host
        from the store's full-precision embeddings. Used when a
        low-selectivity filter hits a probe-based index (``mask_exact`` is
        False): for small allowed sets the exact answer is cheaper than any
        device dispatch, and it is full-precision — strictly better than
        the quantized device scan would be. Returns None when the store
        holds no embeddings for the set (caller falls back to the device
        path)."""
        ids = list(ids)
        recs = self.store.batch_get(ids)
        kept_ids, embs = [], []
        for id_, rec in zip(ids, recs):
            if rec is not None and rec.embedding is not None:
                kept_ids.append(id_)
                embs.append(rec.embedding)
        if not embs:
            return None
        m = np.empty((len(embs), len(embs[0])), np.float32)
        for j, e in enumerate(embs):
            m[j] = e
        metric = getattr(self.index, "metric", "cosine")
        if metric == "cosine":
            m = m / np.maximum(
                np.linalg.norm(m, axis=1, keepdims=True), 1e-12)
        out = []
        kk = min(k, len(kept_ids))
        for q in np.asarray(queries, dtype=np.float32):
            if metric == "cosine":
                q = q / max(float(np.linalg.norm(q)), 1e-12)
            scores = m @ q
            part = np.argpartition(-scores, kk - 1)[:kk]
            order = part[np.argsort(-scores[part])]
            out.append([(kept_ids[j], float(scores[j])) for j in order])
        return out

    # -- vector search ------------------------------------------------------------------

    def vector_search(self, req: SearchRequest) -> List[ScoredPoint]:
        req = self.optimizer.optimize(req)
        if req.vector is None:
            raise ValueError("vector_search requires a vector")
        # SearchParams (types.rs:156-171): per-request precision dial + result
        # shaping. ef maps onto the IVF families' nprobe; params' with_*
        # flags take precedence over the request-level ones when provided.
        search_kw = {}
        if req.params is not None:
            import dataclasses as _dc

            req = _dc.replace(req, with_vectors=req.params.with_vector,
                              with_payload=req.params.with_payload)
            if req.params.ef and hasattr(self.index, "nprobe"):
                search_kw["nprobe"] = max(1, int(req.params.ef))
        key = self._cache_key("vec", req)
        if key is not None:
            cached = self._cache.get(key)
            self.metrics.record_cache(cached is not None)
            if cached is not None:
                return cached
        with QueryTimer(self.metrics):
            allowed = self._allowed_ids(req)
            fetch = req.limit + req.offset
            rescore_c = self._host_rescore_width(req)
            dev_fetch = max(fetch, rescore_c)
            if allowed is not None and self.index.supports_mask:
                # Masked top-k inside the search kernel (SURVEY §7.1 step 6;
                # filtering.rs:374-488 semantics done device-side): the filter
                # compiles to a slot mask fused into the scan's validity
                # predicate. On full-scan indexes (mask_exact) that is the
                # exact top-k over allowed rows at any selectivity. On the
                # probe-based IVF family the in-probe mask only covers the
                # probed lists (allowed rows in unprobed lists are never
                # seen, so recall collapses at low selectivity), so low
                # selectivity routes to an exact tier instead:
                #   |allowed| <= filter_exact_max     -> host full-precision
                #   |allowed| <  exhaustive_below * N -> exact device tier
                #     (ops/ivf_scan.py: compact gather-scan of just the
                #     allowed rows under the HBM budget, else one streaming
                #     corpus pass + k-list probe)
                # The (list, pos)-addressed mask must not race a concurrent
                # optimize() repack between compile and search.
                hits = None
                if not getattr(self.index, "mask_exact", True):
                    host_max = int(getattr(
                        self.config, "filter_exact_max", 0))
                    if len(allowed) <= host_max:
                        rows = self._host_exact_over_ids(
                            np.asarray(req.vector,
                                       dtype=np.float32)[None, :],
                            allowed, dev_fetch)
                        if rows is not None:
                            hits = rows[0]
                            rescore_c = 0  # already full-precision exact
                if hits is None:
                    exh_wanted = (not getattr(self.index, "mask_exact", True)
                                  and len(self.index) > 0
                                  and len(allowed) < float(getattr(
                                      self.config,
                                      "filter_exhaustive_below", 0.0))
                                  * len(self.index))
                    exh = exh_wanted and getattr(
                        self.index, "supports_exhaustive_mask", False)
                    if exh_wanted and not exh:
                        # Exactness backstop for probe indexes without an
                        # exhaustive scan (ivf_pq): the host full-precision
                        # tier, whatever the allowed-set size — matching the
                        # reference's always-exact filtered search
                        # (filtering.rs:374-400) at the reference's own
                        # cost model (a full pass over the allowed rows).
                        rows = self._host_exact_over_ids(
                            np.asarray(req.vector,
                                       dtype=np.float32)[None, :],
                            allowed, dev_fetch)
                        if rows is not None:
                            hits = rows[0]
                            rescore_c = 0
                if hits is None:
                    kw = dict(search_kw)
                    if exh:
                        kw["exhaustive"] = True
                    with self.index.locked():
                        mask = self.index.compile_mask(allowed)
                        hits = self.index.search_batch(
                            np.asarray(req.vector,
                                       dtype=np.float32)[None, :],
                            dev_fetch, mask=mask, **kw,
                        )[0]
            else:
                # Fallback (indexes without masked search): over-fetch so the
                # host post-filter still fills the page — scaled by the
                # requested offset so deep filtered pagination works.
                if allowed is not None:
                    dev_fetch = min(max(dev_fetch * 4, 64), 8192)
                hits = self.index.search_batch(
                    np.asarray(req.vector, dtype=np.float32)[None, :],
                    dev_fetch, **search_kw,
                )[0]
                hits = self._apply_filter(hits, allowed)
            if rescore_c:
                hits = self._host_rescore_rows(
                    np.asarray(req.vector, dtype=np.float32)[None, :],
                    [hits], fetch)[0]
            if req.score_threshold is not None:
                hits = [(i, s) for i, s in hits if s >= req.score_threshold]
            hits = hits[req.offset:req.offset + req.limit]
            out = []
            for id_, score in hits:
                payload: Dict = {}
                vec = None
                rec = self.store.get(id_)
                if req.with_payload and rec is not None:
                    payload = rec.metadata
                if req.with_vectors and rec is not None and rec.embedding is not None:
                    vec = list(rec.embedding)
                out.append(ScoredPoint(id=id_, score=score, vector=vec, payload=payload))
        if key is not None:
            self._cache.put(key, out)
        return out

    # -- text search ---------------------------------------------------------------------

    def text_search(self, req: SearchRequest) -> List[SearchResult]:
        req = self.optimizer.optimize(req)
        if not req.query:
            return []
        key = self._cache_key("txt", req)
        if key is not None:
            cached = self._cache.get(key)
            self.metrics.record_cache(cached is not None)
            if cached is not None:
                return cached
        with QueryTimer(self.metrics):
            allowed = self._allowed_ids(req)
            bm25 = self.sparse.search_bm25(req.query, req.limit * 4 + req.offset)
            sub = self.store.text_search(req.query, req.limit * 4 + req.offset)
            merged: Dict[str, float] = {}
            for id_, s in ((i, s) for i, s in bm25):
                merged[id_] = merged.get(id_, 0.0) + s
            for p in sub:
                merged[p.id] = merged.get(p.id, 0.0) + p.score
            hits = sorted(merged.items(), key=lambda kv: -kv[1])
            hits = self._apply_filter(hits, allowed)
            hits = hits[req.offset:req.offset + req.limit]
            terms = req.query.split()
            out = []
            for id_, score in hits:
                rec = self.store.get(id_)
                if rec is None:
                    continue
                out.append(
                    SearchResult(
                        document=rec.to_document(),
                        score=score,
                        snippet=extract_snippet(rec.content, terms),
                    )
                )
        if key is not None:
            self._cache.put(key, out)
        return out

    # -- combined dense+text (query.rs:75-182 semantics) -----------------------------------

    def search(self, req: SearchRequest) -> List[SearchResult]:
        """Dense search with rank-decay weights merged with text scan scores."""
        req = self.optimizer.optimize(req)
        with QueryTimer(self.metrics):
            allowed = self._allowed_ids(req)
            merged: Dict[str, float] = {}
            if req.vector is not None:
                rescore_c = self._host_rescore_width(req)
                dev_fetch = max(req.limit * 2, rescore_c)
                if allowed is not None and self.index.supports_mask:
                    with self.index.locked():
                        dense = self.index.search(
                            np.asarray(req.vector, dtype=np.float32),
                            dev_fetch,
                            mask=self.index.compile_mask(allowed),
                        )
                else:
                    dense = self.index.search(
                        np.asarray(req.vector, dtype=np.float32), dev_fetch
                    )
                    dense = self._apply_filter(dense, allowed)
                if rescore_c:
                    dense = self._host_rescore_rows(
                        np.asarray(req.vector, dtype=np.float32)[None, :],
                        [dense], req.limit * 2)[0]
                for rank, (id_, score) in enumerate(dense):
                    # rank-decay weighting (query.rs:90-96)
                    merged[id_] = merged.get(id_, 0.0) + score * (1.0 / (1.0 + 0.1 * rank))
            if req.query:
                text = self.store.text_search(req.query, req.limit * 2)
                for p in text:
                    if allowed is not None and p.id not in allowed:
                        continue
                    merged[p.id] = merged.get(p.id, 0.0) + p.score * self.config.text_weight
            ranked = sorted(merged.items(), key=lambda kv: -kv[1])
            if req.score_threshold is not None:
                ranked = [(i, s) for i, s in ranked if s >= req.score_threshold]
            ranked = ranked[req.offset:req.offset + req.limit]
            terms = (req.query or "").split()
            out = []
            for id_, score in ranked:
                rec = self.store.get(id_)
                if rec is None:
                    continue
                out.append(
                    SearchResult(
                        document=rec.to_document(),
                        score=score,
                        snippet=extract_snippet(rec.content, terms) if terms else None,
                    )
                )
            return out

    # -- hybrid -------------------------------------------------------------------------------

    def hybrid_search(self, req: HybridSearchRequest) -> List[SearchResult]:
        allowed = None
        if (req.filter is not None and not req.filter.is_empty()
                and self.filter_engine is not None):
            allowed = set(self.filter_engine.execute_filter(req.filter))
        with QueryTimer(self.metrics):
            return self.hybrid.search(req, allowed_ids=allowed)

    # -- batched dense search (the device-native primary path) ------------------------------------------

    def vector_search_batch(
        self, vectors: np.ndarray, limit: int
    ) -> List[List[ScoredPoint]]:
        """One device call for B queries — the batching executor feeds this."""
        with QueryTimer(self.metrics):
            q = np.asarray(vectors, dtype=np.float32)
            rescore_c = self._host_rescore_width()
            rows = self.index.search_batch(q, max(limit, rescore_c))
            if rescore_c:
                rows = self._host_rescore_rows(q, rows, limit)
        return [[ScoredPoint(id=i, score=s) for i, s in row] for row in rows]

    def cache_stats(self) -> Dict[str, float]:
        if self._cache is None:
            return {"enabled": 0.0}
        return {
            "enabled": 1.0,
            "entries": float(len(self._cache)),
            "hit_rate": self._cache.hit_rate,
        }
