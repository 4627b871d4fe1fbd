"""Batched graph-ANN kernels: bulk k-NN graph build + beam search.

Device-native replacement for the reference's HNSW (index.rs:68-310, via the
instant-distance crate): HNSW is pointer-chasing and rebuilds the whole graph
on every insert (index.rs:164-185). Here:

- **Build** is bulk NN-descent: start from a random fixed-degree graph and
  iterate "score my neighbors' neighbors (+ reverse edges), keep the top-m" —
  every round is batched gathers + one einsum per node chunk, so a 100k-node
  graph builds in ~0.1s of device time instead of per-point graph surgery.
- **Search** is a batched best-first beam: a fixed-size candidate pool per
  query; each iteration expands the best unexpanded pool entries, gathers
  their neighbor lists, scores them in one einsum, and merges with sort-free
  broadcast-compare dedup (expansion-history ring + in-pool + within-batch
  checks — variadic sorts are the slow path). Static shapes, no
  data-dependent control flow — the whole search is one XLA program
  (lax.scan over a fixed iteration count).

Degree m maps to the reference's HNSW ``m`` (default 16, index.rs:22-32);
pool size maps to ``ef_search``; expansion rounds to the graph walk depth.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from grape_vector_db_tpu.ops.distance import prepare_queries, rowwise_dots

__all__ = ["build_knn_graph", "beam_search"]

NEG_INF = jnp.float32(-jnp.inf)


def _pairwise_scores(q, cvecs, cnorms, metric):
    """q [C, D] f32 vs cvecs [C, K, D] -> [C, K] similarity."""
    dots = rowwise_dots(q, cvecs)
    if metric == "cosine":
        return jnp.minimum(dots / jnp.maximum(cnorms, 1e-12), 1.0)
    if metric == "dot":
        return dots
    q_sq = jnp.sum(q * q, axis=-1, keepdims=True)
    return -(q_sq - 2.0 * dots + cnorms * cnorms)


def _dedup_by_index(idxs, vals, keep_first_key):
    """Sort rows by (index, keep_first_key); repeated indices after the first
    occurrence get -inf value. keep_first_key=0 entries win ties."""
    # int32 on purpose: slot indices are < 2^30 (HBM bounds capacity long
    # before), so idx*2+1 fits; jnp silently truncates int64 without x64
    # enabled anyway, and the explicit dtype kills the per-call warning
    order_key = idxs.astype(jnp.int32) * 2 + keep_first_key.astype(jnp.int32)
    order = jnp.argsort(order_key, axis=1)
    s_idx = jnp.take_along_axis(idxs, order, axis=1)
    s_val = jnp.take_along_axis(vals, order, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros_like(s_idx[:, :1], dtype=bool), s_idx[:, 1:] == s_idx[:, :-1]],
        axis=1,
    )
    s_val = jnp.where(dup, NEG_INF, s_val)
    return s_idx, s_val, order, dup


@functools.partial(jax.jit, static_argnames=("m", "metric", "chunk"))
def _refine_chunk(start, cand_idx, vectors, norms, valid, m, metric, chunk):
    """One NN-descent refinement step for the `chunk` nodes at offset `start`.

    `start` is a traced scalar so every chunk reuses ONE compiled program
    (slicing with Python offsets would compile once per offset). cand_idx
    [chunk, K] -> new neighbor lists [chunk, m] picked by true similarity,
    excluding self, invalid rows, and duplicates.
    """
    node_vecs = lax.dynamic_slice_in_dim(vectors, start, chunk, axis=0)
    node_ids = start + jax.lax.broadcasted_iota(jnp.int32, (chunk, 1), 0)[:, 0]
    q = prepare_queries(node_vecs.astype(jnp.float32), metric)
    cvecs = vectors[cand_idx]          # [C, K, D]
    cnorms = norms[cand_idx]           # [C, K]
    scores = _pairwise_scores(q, cvecs, cnorms, metric)
    scores = jnp.where(cand_idx == node_ids[:, None], NEG_INF, scores)  # no self
    scores = jnp.where(valid[cand_idx], scores, NEG_INF)
    s_idx, s_val, _, _ = _dedup_by_index(
        cand_idx, scores, jnp.zeros_like(cand_idx)
    )
    _, pos = lax.top_k(s_val, m)
    return jnp.take_along_axis(s_idx, pos, axis=1).astype(jnp.int32)


def build_knn_graph(
    vectors: jax.Array,     # [N, D] storage dtype (device)
    norms: jax.Array,       # [N] f32
    valid: jax.Array,       # [N] bool — invalid/padding rows never become neighbors
    m: int = 16,
    rounds: int = 6,
    nn_sample: int = 4,
    chunk: int = 2048,
    metric: str = "cosine",
    seed: int = 0,
) -> np.ndarray:
    """Bulk-build an m-NN graph via NN-descent. Returns neighbors [N, m] int32.

    Per round, each node's candidate set = its current neighbors + up to m
    reverse neighbors + the first ``nn_sample`` neighbors of each neighbor.
    Host assembles candidate lists (cheap integer work); the device scores them
    chunk-by-chunk.
    """
    n = int(vectors.shape[0])
    if n <= m + 1:
        # trivial graph: everyone links everyone
        base = np.arange(n, dtype=np.int32)
        nb = np.stack([np.roll(base, -(i + 1)) for i in range(max(m, 1))], axis=1)
        return nb[:, :m]
    rng = np.random.default_rng(seed)
    neighbors = rng.integers(0, n, size=(n, m), dtype=np.int32)
    self_fix = neighbors == np.arange(n, dtype=np.int32)[:, None]
    neighbors[self_fix] = (neighbors[self_fix] + 1) % n

    for _ in range(rounds):
        # reverse edges, capped at m per node (vectorized: sort edges by dst,
        # keep the first m per destination)
        src = np.repeat(np.arange(n, dtype=np.int32), m)
        dst = neighbors.reshape(-1)
        order = np.argsort(dst, kind="stable")
        dst_s, src_s = dst[order], src[order]
        # rank of each edge within its dst group
        first_pos = np.searchsorted(dst_s, np.arange(n))
        rank = np.arange(len(dst_s)) - first_pos[dst_s]
        keep = rank < m
        rev_arr = np.full((n, m), -1, dtype=np.int32)
        rev_arr[dst_s[keep], rank[keep]] = src_s[keep]
        # NN-descent join: candidates = N(v) ∪ R(v) ∪ N(N(v) ∪ R(v)) — the
        # neighbors-of-reverse-neighbors term is what makes the descent
        # converge (edges are asymmetric early on).
        rev_filled = np.where(rev_arr < 0, neighbors[:, :1], rev_arr)
        u = np.concatenate([neighbors, rev_filled], axis=1)          # [n, 2m]
        non = neighbors[u, :nn_sample].reshape(n, 2 * m * nn_sample)
        cand = np.concatenate([neighbors, rev_filled, non], axis=1)

        chunk_c = min(chunk, n)
        new = np.empty_like(neighbors)
        pending = []
        for start in range(0, n, chunk_c):
            end = min(start + chunk_c, n)
            c = end - start
            if c == chunk_c:
                ncand = cand[start:end]
                s = start
            else:
                # tail: shift the window back so the kernel keeps one shape
                s = n - chunk_c
                ncand = cand[s:n]
            out = _refine_chunk(
                jnp.int32(s), jnp.asarray(ncand), vectors, norms, valid,
                m=m, metric=metric, chunk=chunk_c,
            )
            pending.append((start, end, s, out))
        for start, end, s, out in pending:  # one sync point per round
            new[start:end] = np.asarray(out)[start - s:start - s + (end - start)]
        neighbors = new
    return neighbors


def _dots_to_scores(q, dots, cnorms, metric):
    """Same similarity conventions as _pairwise_scores, from precomputed
    dots [B, C] (so the gather kernel only has to move dot products)."""
    if metric == "cosine":
        return jnp.minimum(dots / jnp.maximum(cnorms, 1e-12), 1.0)
    if metric == "dot":
        return dots
    q_sq = jnp.sum(q * q, axis=-1, keepdims=True)
    return -(q_sq - 2.0 * dots + cnorms * cnorms)


def gather_dots(
    q: jax.Array,         # [B, D] f32 (already prepare_queries'd)
    vectors: jax.Array,   # [N, D] storage dtype, device-resident
    ids: jax.Array,       # [B, C] int32 row ids (out-of-range rows clamped;
                          #   caller masks their scores)
) -> jax.Array:
    """Returns dots [B, C] f32 = q[b] . vectors[ids[b, c]] (row gather +
    batched product)."""
    return rowwise_dots(q, vectors[ids])


@functools.partial(
    jax.jit, static_argnames=("k", "pool", "expand", "iters", "metric")
)
def beam_search(
    queries: jax.Array,     # [B, D] f32
    vectors: jax.Array,     # [N, D] storage dtype
    norms: jax.Array,       # [N] f32
    valid: jax.Array,       # [N] bool
    entries: jax.Array,     # [E] int32 global, or [B, E] per-query entry points
    neighbors: jax.Array,   # [N, M] int32
    k: int,
    pool: int = 128,
    expand: int = 8,
    iters: int = 12,
    metric: str = "cosine",
) -> Tuple[jax.Array, jax.Array]:
    """Batched best-first graph search. Returns (scores [B,k], indices [B,k]).

    Pool semantics: a per-query candidate pool of `pool` best-so-far nodes with
    an expanded flag. Each iteration expands the top `expand` unexpanded
    entries, scores their neighbors, and merges (sort-dedup keeps the expanded
    copy of a node so it is never re-expanded).

    ``entries`` may be per-query ([B, E], e.g. from a centroid probe — a bare
    kNN graph is not navigable from static entries at scale) or global ([E])."""
    b, d = queries.shape
    m = neighbors.shape[1]
    q = prepare_queries(queries, metric)
    rows = jnp.arange(b)[:, None]

    # init pool from entry points
    if entries.ndim == 1:
        entries = jnp.broadcast_to(entries[None, :], (b, entries.shape[0]))
    e = entries.shape[1]
    edots = gather_dots(q, vectors, entries)  # [B, E]
    enorms = norms[entries]             # [B, E]
    escores = _dots_to_scores(q, edots, enorms, metric)
    escores = jnp.where(valid[entries], escores, NEG_INF)

    pp = min(pool, max(e, k))
    expand = min(expand, pp)
    init_vals = jnp.full((b, pp), NEG_INF)
    # Padding slots use -1: index 0 is a real node, and the in_pool/seen
    # compares below would otherwise suppress it forever.
    init_idx = jnp.full((b, pp), -1, dtype=jnp.int32)
    take = min(e, pp)
    tv, tp = lax.top_k(escores, take)
    init_vals = init_vals.at[:, :take].set(tv)
    init_idx = init_idx.at[:, :take].set(jnp.take_along_axis(entries, tp, axis=1))
    init_exp = jnp.zeros((b, pp), dtype=bool)
    init_exp = init_exp.at[:, take:].set(True)  # padding slots never expand

    def step(state, _):
        pool_idx, pool_val, expanded = state
        sel_scores = jnp.where(expanded, NEG_INF, pool_val)
        _, sel_pos = lax.top_k(sel_scores, expand)          # [B, expand]
        sel_idx = jnp.take_along_axis(pool_idx, sel_pos, axis=1)
        expanded = expanded.at[rows, sel_pos].set(True)

        nbrs = neighbors[sel_idx].reshape(b, expand * m)     # [B, expand*M]
        cdots = gather_dots(q, vectors, nbrs)     # [B, expand*M]
        cnorms = norms[nbrs]
        cscores = _dots_to_scores(q, cdots, cnorms, metric)
        cscores = jnp.where(valid[nbrs], cscores, NEG_INF)
        # Dedup without sorts (broadcast compares are cheap elementwise work;
        # a variadic sort is the slow path). A candidate dies if it is already in the pool
        # or duplicates an earlier candidate in this batch — exactly the sort-
        # dedup semantics. NOTE: an expanded node that was evicted MAY re-enter
        # and be re-expanded; blocking that with a global history mask cut
        # exploration and dropped recall from 0.99 to 0.72 at 100k.
        in_pool = jnp.any(nbrs[:, :, None] == pool_idx[:, None, :], axis=-1)
        c = nbrs.shape[1]
        earlier = jnp.tril(jnp.ones((c, c), dtype=bool), k=-1)
        dup_in_batch = jnp.any(
            (nbrs[:, :, None] == nbrs[:, None, :]) & earlier[None], axis=-1
        )
        cscores = jnp.where(in_pool | dup_in_batch, NEG_INF, cscores)

        all_idx = jnp.concatenate([pool_idx, nbrs], axis=1)
        all_val = jnp.concatenate([pool_val, cscores], axis=1)
        all_exp = jnp.concatenate(
            [expanded, jnp.zeros_like(nbrs, dtype=bool)], axis=1
        )
        top_v, top_p = lax.top_k(all_val, pp)
        new_idx = jnp.take_along_axis(all_idx, top_p, axis=1)
        new_exp = jnp.take_along_axis(all_exp, top_p, axis=1)
        return (new_idx, top_v, new_exp), None

    (pool_idx, pool_val, _), _ = lax.scan(
        step, (init_idx, init_vals, init_exp), None, length=iters
    )
    kk = min(k, pp)
    vals, pos = lax.top_k(pool_val, kk)
    idxs = jnp.take_along_axis(pool_idx, pos, axis=1)
    if kk < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
        idxs = jnp.pad(idxs, ((0, 0), (0, k - kk)))
    return vals, idxs
