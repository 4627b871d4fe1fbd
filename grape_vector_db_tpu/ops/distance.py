"""Batched distance scoring + top-k over device-resident vector shards.

Replacement for the reference's per-point distance loops:
- HNSW graph walk with per-hop f32 L2 distances (reference index.rs:68-79, 212-231)
- full-scan cosine search (reference storage.rs:296-339, index.rs:620-640)

Design: the corpus lives as a fixed-capacity ``[capacity, dim]`` array (bf16 by
default) plus a precomputed f32 norm vector and a validity mask. A query batch
``[B, dim]`` is scored in one matmul (f32 accumulation) and selected with
one of two top-k engines:

- ``mode="exact"``: iterative max-and-mask — k passes of (argmax, mask),
  exact; or, on long axes, a verified approximate selection (exact too).
- ``mode="approx"``: ``lax.approx_max_k`` (partial reduction,
  recall_target configurable, default 0.99).

For corpora whose [B, N] score matrix would exceed ``max_score_elems`` the scan
falls back to a chunked ``lax.scan`` that never materializes all scores.

Similarity conventions (higher = better), matching the reference:
- cosine:     q.v / (|q||v|)        (storage.rs:851-865)
- dot:        q.v
- euclidean:  -|q - v|2             (negated squared L2; monotonic with L2)
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["l2_normalize", "prepare_queries", "score_block", "scored_topk",
           "rowwise_dots", "exact_engine", "score_weights"]

NEG_INF = jnp.float32(-jnp.inf)

# [B, N] f32 score-matrix budget before falling back to the chunked scan
# (2**27 elements = 512 MB).
MAX_SCORE_ELEMS = 2**27


def l2_normalize(x: jax.Array, axis: int = -1, eps: float = 1e-12) -> jax.Array:
    n = jnp.linalg.norm(x.astype(jnp.float32), axis=axis, keepdims=True)
    return x.astype(jnp.float32) / jnp.maximum(n, eps)


def prepare_queries(queries: jax.Array, metric: str) -> jax.Array:
    """Cosine queries get L2-normalized once so the per-chunk work is a plain
    matmul + corpus-norm division."""
    q = queries.astype(jnp.float32)
    if metric == "cosine":
        q = l2_normalize(q)
    return q


def rowwise_dots(q: jax.Array, rows: jax.Array, q_dtype=None) -> jax.Array:
    """Each query against its own rows: [B, D] x [B, ..., D] -> [B, ...] f32.

    The query is rounded to ``q_dtype`` — by default the rows' float type,
    bf16 for integer codes, as the kernels do — with ``lax.reduce_precision``:
    XLA on a GPU treats an f32 -> bf16 -> f32 convert pair as excess
    precision and drops it (``xla_allow_excess_precision``), which left the
    query unrounded and moved scores by up to 2.3e-4 at D = 768 against a
    reference that rounds. Products and sums are then f32 (``HIGHEST``: no
    TF32), exact for bf16 values and integer codes."""
    if q_dtype is None:
        q_dtype = (rows.dtype if jnp.issubdtype(rows.dtype, jnp.floating)
                   else jnp.bfloat16)
    qf = q.astype(jnp.float32)
    if jnp.dtype(q_dtype) == jnp.bfloat16:
        qf = lax.reduce_precision(qf, exponent_bits=8, mantissa_bits=7)
    return jnp.einsum("bd,b...d->b...", qf, rows.astype(jnp.float32),
                      precision=lax.Precision.HIGHEST)


def score_weights(norms: jax.Array, valid: jax.Array,
                  metric: str = "cosine") -> jax.Array:
    """Validity-masked score weights of any shape: 1/|v| for cosine (the
    norm division as one multiply), 1.0 for dot; 0 marks an invalid row.
    The kernels and the masked scans multiply dots by this plane."""
    if metric == "cosine":
        w = jnp.where(valid, 1.0 / jnp.maximum(norms, 1e-12), 0.0)
    else:
        w = jnp.where(valid, 1.0, 0.0)
    return w.astype(jnp.float32)


def score_block(
    q: jax.Array,          # [B, D] f32 (already prepare_queries'd)
    vecs: jax.Array,       # [C, D] storage dtype
    norms: jax.Array,      # [C]    f32  (L2 norms of the original f32 vectors)
    valid: jax.Array,      # [C]    bool
    metric: str,
) -> jax.Array:
    """Score one corpus block: returns [B, C] f32, -inf where invalid."""
    # Matmul with f32 accumulation. bf16 storage keeps HBM traffic at
    # 2 bytes/element; accumulate in f32 for exactness of the ranking. With f32
    # storage, request HIGHEST precision so XLA does not demote inputs to bf16.
    precision = lax.Precision.HIGHEST if vecs.dtype == jnp.float32 else lax.Precision.DEFAULT
    dots = lax.dot_general(
        q.astype(vecs.dtype),
        vecs,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )  # [B, C]
    if metric == "cosine":
        # clamp: bf16 rounding can push a self-match epsilon above 1.0
        scores = jnp.minimum(dots / jnp.maximum(norms, 1e-12)[None, :], 1.0)
    elif metric == "dot":
        scores = dots
    elif metric == "euclidean":
        q_sq = jnp.sum(q * q, axis=-1, keepdims=True)  # [B, 1]
        v_sq = (norms * norms)[None, :]  # [1, C]
        scores = -(q_sq - 2.0 * dots + v_sq)
    else:
        raise ValueError(f"unknown metric: {metric}")
    return jnp.where(valid[None, :], scores, NEG_INF)


def _iterative_topk(scores: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k via k passes of (argmax, mask): k streaming passes
    instead of a sort-based top-k over a long axis, for small k; exact
    because each pass removes the found maximum."""
    b = scores.shape[0]
    rows = jnp.arange(b)

    def body(s_cur, _):
        am = jnp.argmax(s_cur, axis=1)                       # [B]
        vals = jnp.take_along_axis(s_cur, am[:, None], axis=1)[:, 0]
        s_cur = s_cur.at[rows, am].set(NEG_INF)
        return s_cur, (vals, am.astype(jnp.int32))

    _, (vals, idxs) = lax.scan(body, scores, None, length=k)
    return jnp.moveaxis(vals, 0, 1), jnp.moveaxis(idxs, 0, 1)  # [B, k]


def _verified_exact_topk(scores: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k at ~approx_max_k speed.

    Take an over-fetched approx candidate set, then PROVE it contains the true
    top-k with one cheap full-matrix count: with tau = the candidates' k-th
    value, if the full matrix and the candidate set contain the same number of
    entries > tau, every entry above tau is a candidate, so the candidate
    top-k is the true top-k (boundary ties are interchangeable by value).
    On the rare failure, fall back to the iterative exact scan (one
    approximate pass and one count instead of k passes).
    """
    n = scores.shape[1]
    # Large over-fetch: approx_max_k's misses concentrate near its own
    # boundary (rank ~over), so with over >> k the true top-k is essentially
    # always captured and the proof passes; a small over-fetch falls back
    # to the slow path often.
    over = min(max(16 * k, 1024), n)
    avals, aidx = lax.approx_max_k(scores, over, recall_target=0.95)
    kvals, kpos = lax.top_k(avals, k)
    tau = kvals[:, -1:]                                   # [B, 1]
    cnt_full = jnp.sum(scores > tau, axis=1)              # [B]
    cnt_cand = jnp.sum(avals > tau, axis=1)               # [B]
    proven = jnp.all(cnt_full == cnt_cand)

    def fast(_):
        return kvals, jnp.take_along_axis(aidx, kpos, axis=1).astype(jnp.int32)

    def slow(_):
        return _iterative_topk(scores, k)

    return lax.cond(proven, fast, slow, None)


SEGMENT = 32  # segment width for the two-phase exact engine


def _dup_pick_mask(seg: jax.Array) -> jax.Array:
    """[B, r] bool: True where this segment id already appeared at an
    EARLIER position in the same row. The iterative selection's tail picks
    index 0 repeatedly once a plane is all -inf (fewer finite segments than
    picks — e.g. a large-capacity bucket holding few valid docs), and the
    -inf masking is then a no-op; without this mask the duplicated
    segment's rows would be rescored to the same FINITE values twice and
    lax.top_k could emit one row id twice, displacing a true top-k row."""
    r = seg.shape[1]
    return jnp.any(
        (seg[:, :, None] == seg[:, None, :])
        & (jnp.arange(r)[None, None, :] < jnp.arange(r)[None, :, None]),
        axis=2)


def _segmax_exact_topk(
    q: jax.Array,        # [B, D] f32 (prepared)
    vectors: jax.Array,  # [N, D]
    norms: jax.Array,    # [N]
    valid: jax.Array,    # [N]
    k: int,
    metric: str,
    chunk: int,
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k in ~1 streamed pass + a tiny rescore.

    Phase 1 reduces each 32-column segment of the score matrix to its max
    while the matmul scan streams the corpus (the [B, N] scores never hit
    HBM — only the 32x smaller segment maxima). Phase 2 takes the top-k
    segments per query and exactly rescores their k*32 member rows.

    Exactness: if a global top-k value lived outside the chosen segments,
    then k segments would each hold a strictly larger value — contradiction.
    Boundary ties are interchangeable by value, same convention as
    ``_verified_exact_topk``.
    """
    n, d = vectors.shape
    b = q.shape[0]
    num_seg = n // SEGMENT

    chunk = min(chunk, n)
    num_chunks = n // chunk
    seg_per_chunk = chunk // SEGMENT
    vecs_c = vectors.reshape(num_chunks, chunk, d)
    norms_c = norms.reshape(num_chunks, chunk)
    valid_c = valid.reshape(num_chunks, chunk)

    def body(carry, xs):
        vecs_i, norms_i, valid_i = xs
        scores = score_block(q, vecs_i, norms_i, valid_i, metric)
        segmax = scores.reshape(b, seg_per_chunk, SEGMENT).max(axis=-1)
        return carry, segmax

    _, segs = lax.scan(body, None, (vecs_c, norms_c, valid_c))
    segmax = jnp.moveaxis(segs, 0, 1).reshape(b, num_seg)

    # top-k segments (value order only; indices come from the rescore)
    kk = min(k, num_seg)
    if num_seg <= 262_144:
        _, seg_ids = _iterative_topk(segmax, kk)
    else:
        _, seg_ids = _verified_exact_topk(segmax, kk)

    # phase 2: exact rescore of the kk*SEGMENT candidate rows
    rows = (seg_ids[:, :, None] * SEGMENT
            + jnp.arange(SEGMENT, dtype=jnp.int32)[None, None, :]
            ).reshape(b, kk * SEGMENT)                        # [B, kk*32]
    dots = rowwise_dots(q, vectors[rows])                     # [B, C]
    cnorms = norms[rows]
    if metric == "cosine":
        rs = jnp.minimum(dots / jnp.maximum(cnorms, 1e-12), 1.0)
    elif metric == "dot":
        rs = dots
    else:
        q_sq = jnp.sum(q * q, axis=-1, keepdims=True)
        rs = -(q_sq - 2.0 * dots + cnorms * cnorms)
    rs = jnp.where(valid[rows], rs, NEG_INF)
    # degenerate-plane guard: repeated seg_ids picks (fewer finite segments
    # than kk — a large-capacity bucket holding few valid docs) would
    # rescore the same rows to equal finite values twice and top_k could
    # emit one row id twice, displacing a true top-k row
    rs = jnp.where(jnp.repeat(_dup_pick_mask(seg_ids), SEGMENT, axis=1),
                   NEG_INF, rs)
    fvals, fpos = lax.top_k(rs, min(k, rs.shape[1]))
    fidx = jnp.take_along_axis(rows, fpos, axis=1)
    return fvals, fidx.astype(jnp.int32)


def _select_topk(scores: jax.Array, k: int, mode: str,
                 recall_target: float) -> Tuple[jax.Array, jax.Array]:
    if mode == "approx":
        vals, idxs = lax.approx_max_k(scores, k, recall_target=recall_target)
        return vals, idxs.astype(jnp.int32)
    if k <= 64:
        # Both engines are exact; cost scales differently: iterative is k full
        # passes (wins on short axes), verified-approx is ~2.3 passes (wins on
        # long axes). The 262,144 crossover is an unmeasured default on GPUs.
        if scores.shape[1] <= 262_144:
            return _iterative_topk(scores, k)
        return _verified_exact_topk(scores, k)
    vals, idxs = lax.top_k(scores, k)
    return vals, idxs.astype(jnp.int32)


def exact_engine(n: int, d: int, b: int, k: int, dtype, metric: str,
                 mode: str = "exact", chunk: int = 65536,
                 platform: str | None = None) -> str:
    """Which engine ``scored_topk`` runs for these shapes:

    - ``"segmax_kernel"``: the fused segment-max kernel (ops/segmax_pallas.py),
      on a GPU only;
    - ``"segmax_xla"``: the same two-phase algorithm as an XLA scan;
    - ``"dense"``: one matmul over the whole [B, N] score matrix;
    - ``"chunked"``: a chunked scan with a per-chunk top-k.

    The row thresholds (262,144 and 131,072) are unmeasured defaults on GPUs.
    """
    from grape_vector_db_tpu.ops.segmax_pallas import segmax_kernel_fits

    platform = platform or jax.default_backend()
    kk = min(k, n)
    big_n = n > 262_144
    if mode == "exact" and kk <= 64 and n % SEGMENT == 0:
        if (platform == "gpu" and metric in ("cosine", "dot")
                and segmax_kernel_fits(n, d, dtype)
                and (big_n or (n >= 131_072 and b > 128))):
            return "segmax_kernel"
        if big_n and (n <= chunk or n % chunk == 0):
            return "segmax_xla"
    if b * n <= MAX_SCORE_ELEMS:
        return "dense"
    return "chunked"


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "chunk", "mode", "recall_target")
)
def scored_topk(
    queries: jax.Array,    # [B, D] raw f32 queries
    vectors: jax.Array,    # [N, D] storage dtype, N % chunk == 0 (capacity-padded)
    norms: jax.Array,      # [N] f32
    valid: jax.Array,      # [N] bool
    k: int,
    metric: str = "cosine",
    chunk: int = 65536,
    mode: str = "exact",
    recall_target: float = 0.99,
    mask: jax.Array | None = None,  # [N] bool filter mask (True = allowed)
) -> Tuple[jax.Array, jax.Array]:
    """Top-k scan over the whole shard.

    Returns (scores [B, k] f32, indices [B, k] int32). Invalid / padding rows
    can only appear in the tail of results when fewer than k valid rows exist;
    their score is -inf.

    ``mask`` implements masked filtered search (filtering.rs:374-488 semantics,
    done inside the kernel instead of execute-then-intersect): it is fused into
    the same validity predicate the scan already applies, so a 0.1%-selective
    filter still returns the exact top-k over the allowed rows — the host
    over-fetch fallback provably cannot guarantee that.
    """
    n, d = vectors.shape
    b = queries.shape[0]
    kk = min(k, n)
    engine = exact_engine(n, d, b, k, vectors.dtype, metric, mode, chunk)
    if engine == "segmax_kernel":
        # The [B, chunk] score blocks stay in registers; only the 32x
        # smaller segment maxima reach device memory.
        from grape_vector_db_tpu.ops.segmax_pallas import segmax_topk

        vals, idxs = segmax_topk(queries, vectors, norms, valid, k=kk,
                                 metric=metric, mask=mask)
        return _pad_k(vals, idxs, k)
    if mask is not None:
        valid = jnp.logical_and(valid, mask)
    q = prepare_queries(queries, metric)
    if engine == "segmax_xla":
        # Streams the corpus once instead of running k selection passes
        # over a materialized [B, N] score matrix.
        vals, idxs = _segmax_exact_topk(q, vectors, norms, valid, kk,
                                        metric, chunk)
        return _pad_k(vals, idxs, k)

    if b * n <= MAX_SCORE_ELEMS:
        # Fast path: one matmul, full [B, N] scores, fused top-k selection.
        scores = score_block(q, vectors, norms, valid, metric)
        vals, idxs = _select_topk(scores, kk, mode, recall_target)
        return _pad_k(vals, idxs, k)

    # Memory fallback: chunked scan, never materializing all scores.
    chunk = min(chunk, n)
    assert n % chunk == 0, f"capacity {n} must be a multiple of chunk {chunk}"
    num_chunks = n // chunk
    kc = min(k, chunk)
    vecs_c = vectors.reshape(num_chunks, chunk, d)
    norms_c = norms.reshape(num_chunks, chunk)
    valid_c = valid.reshape(num_chunks, chunk)
    offsets = jnp.arange(num_chunks, dtype=jnp.int32) * chunk

    def body(carry, xs):
        vecs_i, norms_i, valid_i, off = xs
        scores = score_block(q, vecs_i, norms_i, valid_i, metric)
        vals, idxs = _select_topk(scores, kc, mode, recall_target)
        return carry, (vals, idxs + off)

    _, (vals, idxs) = lax.scan(body, None, (vecs_c, norms_c, valid_c, offsets))
    vals = jnp.moveaxis(vals, 0, 1).reshape(b, num_chunks * kc)
    idxs = jnp.moveaxis(idxs, 0, 1).reshape(b, num_chunks * kc)
    fvals, fpos = lax.top_k(vals, min(k, num_chunks * kc))
    fidx = jnp.take_along_axis(idxs, fpos, axis=1)
    return _pad_k(fvals, fidx, k)


def _pad_k(vals: jax.Array, idxs: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Pad result columns with (-inf, 0) up to k when the corpus was < k rows."""
    got = vals.shape[1]
    if got >= k:
        return vals[:, :k], idxs[:, :k]
    pad = k - got
    vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-jnp.inf)
    idxs = jnp.pad(idxs, ((0, 0), (0, pad)), constant_values=0)
    return vals, idxs
