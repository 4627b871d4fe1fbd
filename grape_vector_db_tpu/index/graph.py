"""GraphDeviceIndex — the HNSW-equivalent: bulk-built k-NN graph + batched beam.

STATUS: EXPERIMENTAL. A beam hop is a row gather + merge + dedup and a search
needs several hops, so graph search is expected to lose to the flat scan at
<=1M rows and to the IVF probe at larger scales (not measured on the GPU);
the >=10M capacity role is served by ivf_int8 / ivf_int8_proj. Kept (tested,
maintained) for users porting HNSW-shaped workloads — see README "Graph index
status".

Replaces the reference's HNSW index (index.rs:68-310) with the device-shaped
design from SURVEY.md §7.1 step 3:

- the graph is bulk-built on device (NN-descent, ops/graph.py) — no per-insert
  rebuild (the reference rebuilds the whole graph on *every* insert,
  index.rs:164-185);
- incremental inserts buffer into a "fresh" flat region that is scanned
  exactly and merged into results; when the fresh region exceeds
  ``rebuild_ratio`` of the graph (or ``optimize()`` is called) the graph is
  rebuilt in bulk over everything;
- search = batched beam over the graph + exact scan of the fresh region + a
  top-k merge; deletes tombstone the validity mask (the beam still routes
  *through* tombstoned nodes but never returns them — same trick DiskANN uses).

Parameter mapping to the reference (index.rs:22-32): ``m`` = graph degree,
``ef_search`` = pool size, ``ef_construction`` -> NN-descent rounds.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grape_vector_db_tpu.errors import DimensionMismatchError
from grape_vector_db_tpu.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu.index.flat import FlatDeviceIndex
from grape_vector_db_tpu.ops.graph import beam_search, build_knn_graph
from grape_vector_db_tpu.ops.kmeans import kmeans
from grape_vector_db_tpu.utils.buckets import next_bucket, pad_rows
from grape_vector_db_tpu.utils.fetch import fetch_scores_slots

__all__ = ["GraphDeviceIndex"]


@functools.partial(jax.jit, static_argnames=("e", "metric"))
def _probe_entries(q, centroids, reps, e: int, metric: str):
    """Per-query entry points: top-e centroids' representative points."""
    from grape_vector_db_tpu.ops.distance import prepare_queries

    qp = prepare_queries(q, metric)
    dots = jax.lax.dot_general(
        qp, centroids, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if metric == "cosine":
        cn = jnp.linalg.norm(centroids, axis=1)
        dots = dots / jnp.maximum(cn, 1e-12)[None, :]
    elif metric == "euclidean":
        c2 = jnp.sum(centroids * centroids, axis=1)[None, :]
        dots = -(jnp.sum(qp * qp, axis=1, keepdims=True) - 2 * dots + c2)
    _, top = jax.lax.top_k(dots, min(e, centroids.shape[0]))
    return reps[top]


class GraphDeviceIndex(VectorIndex):
    kind = "graph"

    def __init__(
        self,
        dimension: int,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        initial_capacity: int = 4096,
        growth_factor: int = 2,
        m: int = 16,
        ef_search: int = 128,
        ef_construction: int = 200,
        n_entries: int = 64,
        expand: int = 8,
        rebuild_ratio: float = 0.25,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        device: Optional[jax.Device] = None,
    ):
        self._dim = dimension
        self.metric = metric
        self.m = m
        # Layer-0 degree is 2*m, matching HNSW's max_m0 convention — the extra
        # edges are what lets NN-descent converge to ~0.99 graph recall.
        self.degree = 2 * m
        self.pool = next_bucket(max(ef_search, 16), base=16)
        self.expand = expand
        # ef_construction maps to NN-descent rounds (HNSW spends ~ef_c work per
        # insert; NN-descent spends `rounds` full passes total).
        self.build_rounds = max(4, min(12, ef_construction // 16))
        self.n_entries = n_entries
        self.rebuild_ratio = rebuild_ratio
        self._lock = threading.RLock()
        # Graph region: a flat index whose slot space the neighbor lists index.
        self._graph_store = FlatDeviceIndex(
            dimension, metric=metric, storage_dtype=storage_dtype,
            initial_capacity=initial_capacity, growth_factor=growth_factor,
            search_mode=search_mode, recall_target=recall_target, device=device,
        )
        self.neighbors: Optional[jax.Array] = None   # [graph_n, m] int32
        self.entries: Optional[jax.Array] = None     # [E] int32 (small graphs)
        self.centroids: Optional[jax.Array] = None   # [L, D] f32 (probe entries)
        self.reps: Optional[jax.Array] = None        # [L] int32
        self._graph_n = 0  # slots covered by the graph (high-water at build)
        # Fresh region: exact-scanned buffer of post-build inserts.
        self._fresh = FlatDeviceIndex(
            dimension, metric=metric, storage_dtype=storage_dtype,
            initial_capacity=1024, growth_factor=growth_factor,
            search_mode=search_mode, recall_target=recall_target, device=device,
        )
        self.search_iters = max(4, self.pool // max(expand, 1))
        self.builds = 0

    # -- properties ---------------------------------------------------------------

    @property
    def dimension(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return len(self._graph_store) + len(self._fresh)

    @property
    def is_built(self) -> bool:
        return self.neighbors is not None

    # -- mutation -------------------------------------------------------------------

    def add_batch(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, vectors.shape[1])
        if not len(ids):
            return
        with self._lock:
            # Upsert semantics: drop any existing copies first.
            existing = [i for i in ids
                        if self._graph_store.contains(i) or self._fresh.contains(i)]
            if existing:
                self._graph_store.remove_batch(existing)
                self._fresh.remove_batch(existing)
            self._fresh.add_batch(ids, vectors)
            graph_n = len(self._graph_store)
            if (self.neighbors is None and len(self._fresh) >= 256) or (
                graph_n and len(self._fresh) > self.rebuild_ratio * graph_n
            ):
                self._rebuild_locked()

    def remove_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            return self._graph_store.remove_batch(ids) + self._fresh.remove_batch(ids)

    def clear(self) -> None:
        with self._lock:
            self._graph_store.clear()
            self._fresh.clear()
            self.neighbors = None
            self.entries = None
            self.centroids = None
            self.reps = None
            self._graph_n = 0

    def optimize(self) -> None:
        """Bulk (re)build the graph over everything (absorbs the fresh region)."""
        with self._lock:
            self._rebuild_locked()

    def _rebuild_locked(self) -> None:
        f_ids, f_vecs = self._fresh.get_all()
        if f_ids:
            self._graph_store.add_batch(f_ids, f_vecs)
            self._fresh.clear()
        n = len(self._graph_store)
        if n < 2:
            self.neighbors = None
            return
        gs = self._graph_store
        self._graph_n = gs._high_water
        # Bucket the graph's slot range so jit caches stay stable across
        # rebuilds; padding rows are masked out by `valid` everywhere.
        self._nb_cap = min(next_bucket(self._graph_n, base=64), gs.capacity)
        nb = build_knn_graph(
            gs.vectors[: self._nb_cap],
            gs.norms[: self._nb_cap],
            gs.valid[: self._nb_cap],
            m=self.degree, rounds=self.build_rounds,
            nn_sample=min(self.degree, 8), metric=self.metric,
        )
        self.neighbors = jnp.asarray(nb, dtype=jnp.int32)
        # Entry points: a bare kNN graph is not navigable from a few static
        # entries at scale (recall collapses at ~100k rows), so
        # search probes k-means centroids per query and enters the graph at
        # each probed centroid's nearest live point.
        live = [s for s in range(self._graph_n) if gs._slot_to_id[s] is not None]
        n_live = len(live)
        n_cent = min(4096, max(self.n_entries, next_bucket(n_live // 32, base=64)))
        if n_live > n_cent:
            sample = np.asarray(live, dtype=np.int64)
            if n_live > 65536:
                sample = np.random.default_rng(0).choice(sample, 65536, replace=False)
            train = np.asarray(gs.vectors, dtype=np.float32)[sample]
            cents, _ = kmeans(jnp.asarray(train), k=n_cent, iters=8)
            self.centroids = cents
            # representative = nearest live point per centroid (exact top-1)
            from grape_vector_db_tpu.ops.distance import scored_topk

            _, rep_idx = scored_topk(
                cents, gs.vectors[: self._nb_cap], gs.norms[: self._nb_cap],
                gs.valid[: self._nb_cap], k=1, metric=self.metric, mode="exact",
            )
            self.reps = rep_idx[:, 0].astype(jnp.int32)
            self.entries = None
        else:
            self.centroids = None
            self.reps = None
            step = max(1, n_live // self.n_entries)
            self.entries = jnp.asarray(
                np.asarray(live[::step][: self.n_entries], dtype=np.int32)
            )
        self.builds += 1

    # -- search -----------------------------------------------------------------------

    def search_batch(self, queries: np.ndarray, k: int,
                     mask=None) -> List[List[SearchHit]]:
        if mask is not None:
            raise NotImplementedError(
                "graph index has no masked search; the planner falls back to "
                "over-fetch + host post-filter (supports_mask=False)"
            )
        queries = np.asarray(queries, dtype=np.float32)
        if queries.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, queries.shape[1])
        b = queries.shape[0]
        if b == 0 or len(self) == 0:
            return [[] for _ in range(b)]
        with self._lock:
            if self.neighbors is None:
                return self._fresh_plus_graph_exact(queries, k)
            bb = next_bucket(b, base=8)
            qp = pad_rows(queries, bb)
            gs = self._graph_store
            q_dev = jnp.asarray(qp)
            if self.centroids is not None:
                entries = _probe_entries(
                    q_dev, self.centroids, self.reps,
                    e=self.n_entries, metric=self.metric,
                )
            else:
                entries = self.entries
            vals, idxs = beam_search(
                q_dev,
                gs.vectors[: self._nb_cap],
                gs.norms[: self._nb_cap],
                gs.valid[: self._nb_cap],
                entries, self.neighbors,
                # over-fetch 2k: the pool may hold duplicate copies of a node
                # (history-based dedup is approximate); the host merge dedupes
                k=min(2 * k, self.pool), pool=self.pool, expand=self.expand,
                iters=self.search_iters, metric=self.metric,
            )
            h_vals, h_idxs = fetch_scores_slots(vals, idxs)
            graph_hits = gs.hits_from_slots(h_vals[:b], h_idxs[:b])
            # Points inserted after the last build live in graph slots beyond
            # the graph's slot range — scan them exactly through the store.
            extra_hits = self._post_build_hits(qp, b, k)
            fresh_hits = (
                self._fresh.search_batch(queries, k) if len(self._fresh)
                else [[] for _ in range(b)]
            )
        out: List[List[SearchHit]] = []
        for g, e, f in zip(graph_hits, extra_hits, fresh_hits):
            merged: Dict[str, float] = {}
            for id_, s in g + e + f:
                if id_ not in merged or s > merged[id_]:
                    merged[id_] = s
            ranked = sorted(merged.items(), key=lambda kv: -kv[1])[:k]
            out.append([(i, float(s)) for i, s in ranked])
        return out

    def _post_build_hits(self, qp: np.ndarray, b: int, k: int):
        """Slots written into the graph store after the last build (possible via
        slot reuse on upsert) are reachable only by exact scan."""
        gs = self._graph_store
        if gs._high_water <= self._graph_n:
            return [[] for _ in range(b)]
        vals, idxs = gs.raw_topk(qp, k)
        hits = gs.hits_from_slots(vals[:b], idxs[:b])
        keep = []
        for row in hits:
            keep.append([
                (i, s) for i, s in row
                if gs._id_to_slot.get(i, -1) >= self._graph_n
            ])
        return keep

    def _fresh_plus_graph_exact(self, queries: np.ndarray, k: int):
        """Before the first build: everything is exact."""
        a = self._fresh.search_batch(queries, k) if len(self._fresh) else None
        g = self._graph_store.search_batch(queries, k) if len(self._graph_store) else None
        if a is None:
            return g or [[] for _ in range(queries.shape[0])]
        if g is None:
            return a
        out = []
        for ra, rg in zip(a, g):
            merged = {i: s for i, s in ra}
            for i, s in rg:
                if i not in merged or s > merged[i]:
                    merged[i] = s
            out.append(sorted(merged.items(), key=lambda kv: -kv[1])[:k])
        return out

    # -- introspection -------------------------------------------------------------------

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        v = self._graph_store.get_vector(id_)
        return v if v is not None else self._fresh.get_vector(id_)

    def get_all(self) -> Tuple[List[str], np.ndarray]:
        g_ids, g_vecs = self._graph_store.get_all()
        f_ids, f_vecs = self._fresh.get_all()
        return g_ids + f_ids, np.concatenate([g_vecs, f_vecs], axis=0)

    def get_stats(self) -> IndexStats:
        gs = self._graph_store.get_stats()
        return IndexStats(
            point_count=len(self),
            dimension=self._dim,
            capacity=gs.capacity,
            kind=self.kind,
            is_built=self.is_built,
            memory_usage_mb=gs.memory_usage_mb
            + (self._graph_n * self.degree * 4) / 1e6,
            extra={
                "m": float(self.m),
                "degree": float(self.degree),
                "pool": float(self.pool),
                "graph_nodes": float(self._graph_n),
                "fresh": float(len(self._fresh)),
                "builds": float(self.builds),
            },
        )
