"""Exhaustive masked IVF scan — exact filtered search at any selectivity.

The probe visits ``nprobe`` lists per query, so a filter mask folded
into it is exact only over the probed lists: at low selectivity the masked
oracle's winners live in lists the centroid ranking never surfaces. This
module restores exactness without re-reading the corpus per query (a naive
nprobe=nlist probe would: the probe reads each probed list once per query
cell):

- **Phase 1** streams the whole bucketed layout once ([L, C, ...] in
  ``chunk_lists``-list chunks, one einsum per chunk) and reduces each
  list to its masked score maximum -> a [B, L] plane. No top-k inside the
  loop: the per-list max is a cheap reduce fused into the matmul's
  epilogue.
- **Phase 2** selects each query's top-``P`` lists from that plane (exact
  iterative selection over [B, L]) and probes exactly those lists through
  the same probe the normal search uses, with the mask
  folded into the final selection. Two-phase exactness argument: if a true
  top-k row's list were outside the top-k lists ranked by masked max, at
  least k rows in better-ranked lists would beat it — contradiction. So
  ``P >= k`` lists suffice.

Cost = one corpus read (the bytes a flat scan moves) + a k-list probe.
This is the planner's fallback when a filter's selectivity is below
``QueryConfig.filter_exhaustive_below`` on an index whose mask is not
exact (``mask_exact = False``, the IVF family).

Reference parity: filtering.rs:374-400 — the reference filters by
post-intersecting a full scan (always exact, never fast); this keeps the
exactness contract and adds the fast path for the common case.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from grape_vector_db_tpu.ops.distance import (_select_topk, prepare_queries,
                                              rowwise_dots)
from grape_vector_db_tpu.ops.int4 import unpack_int4
from grape_vector_db_tpu.ops.ivf_probe import finalize_probe_topk

__all__ = ["ivf_exhaustive_masked_topk", "ivf_compact_masked_topk",
           "compact_gather", "compact_topk_from_rows", "compact_scan_core",
           "default_chunk_lists", "probe_dup_mask"]


def probe_dup_mask(probe: jax.Array) -> jax.Array:
    """[B, P] True where a probe entry repeats an earlier column's list id.

    When fewer than P lists hold any allowed row, the iterative selection's
    argmax over an all--inf plane ties to column 0 and can REPEAT a list id.
    A repeated list duplicates its cells in the final top-k (the same slot
    twice), and the host-side id dedup then under-fills k — wrong results
    with >= k allowed rows (an ivf_int8 planner repro). Mask
    every occurrence after the first."""
    b, p = probe.shape
    iot = lax.broadcasted_iota(jnp.int32, (b, p, p), 1)
    return jnp.any((probe[:, :, None] == probe[:, None, :])
                   & (iot > jnp.swapaxes(iot, 1, 2)), axis=2)

# Keep each chunk's [B, chunk_lists * C] selection plane on the iterative
# exact path (ops/distance.py routes <= 262_144 there) and its [B, CL, C]
# score intermediate modest.
_MAX_CHUNK_CELLS = 262_144


def default_chunk_lists(nlist: int, cap: int) -> int:
    """Largest power-of-two list count per phase-1 chunk that divides
    ``nlist`` and keeps chunk cells <= 262k (the iterative-selection
    crossover; larger chunks gain nothing — phase 1 is bandwidth-bound)."""
    cl = 1
    while (cl * 2 <= nlist and nlist % (cl * 2) == 0
           and cl * 2 * cap <= _MAX_CHUNK_CELLS):
        cl *= 2
    return cl


def _dequant(dd: jax.Array, fmt: str) -> jax.Array:
    """Chunk rows -> bf16 candidates, matching each probe kernel's
    arithmetic (validated vs the probes at 50% selectivity: recall 1.0)."""
    if fmt == "bf16":
        return dd.astype(jnp.bfloat16)
    if fmt == "int8":
        return dd.astype(jnp.bfloat16)
    if fmt == "int4":
        return unpack_int4(dd).astype(jnp.bfloat16)
    raise ValueError(f"unknown scan format {fmt!r}")


@functools.partial(jax.jit, static_argnames=(
    "k", "metric", "fmt", "chunk_lists", "use_kernel"))
def ivf_exhaustive_masked_topk(
    queries: jax.Array,   # [B, D] f32 raw
    data: jax.Array,      # [L, C, D] bf16 | [L, C, D] int8 | [L, C, D/2] packed
    plane: jax.Array,     # [L, C] f32 weight plane (recip / factor; 0 = invalid)
    mask: jax.Array,      # [L, C] bool filter (True = allowed)
    k: int,
    metric: str = "cosine",
    fmt: str = "bf16",
    chunk_lists: int = 64,
    use_kernel: bool = False,          # probe kernel for phase 2 (GPU)
    fill: jax.Array | None = None,     # [L] int32 rows in use (kernel)
) -> Tuple[jax.Array, jax.Array]:
    """Exact masked top-k over EVERY list of a bucketed IVF layout.

    Returns (vals [B, k] f32, slots [B, k] int32 global cell ids lst*C+pos)
    — the ``_main_topk`` contract. Disallowed/invalid rows can only appear
    as -inf tail padding. ``k <= 64`` keeps both selections on the
    iterative exact path; larger k degrades to ``lax.top_k``.
    """
    b = queries.shape[0]
    l, c = mask.shape
    qp = prepare_queries(queries, metric)
    qb = qp.astype(jnp.bfloat16)

    nch = l // chunk_lists
    d3 = data.reshape((nch, chunk_lists) + tuple(data.shape[1:]))
    w0 = plane                                            # [L, C]
    p3 = w0.reshape(nch, chunk_lists, c)
    m3 = mask.reshape(nch, chunk_lists, c)

    def body(carry, xs):
        dd, ww, mm = xs
        cand = _dequant(dd, fmt)                          # [CL, C, D]
        dots = jnp.einsum("bd,lcd->blc", qb, cand,
                          preferred_element_type=jnp.float32)
        w = jnp.where(mm, ww, 0.0)
        sc = jnp.where(w[None] == 0.0, -jnp.inf, dots * w[None])
        return carry, sc.max(axis=2)                      # [B, CL]

    _, lmax = lax.scan(body, None, (d3, p3, m3))          # [nch, B, CL]
    lmax = jnp.moveaxis(lmax, 0, 1).reshape(b, l)         # [B, L]

    p = min(l, max(k, 8))
    _, probe = _select_topk(lmax, p, "exact", 0.99)       # [B, P]
    probe = probe.astype(jnp.int32)
    dup = probe_dup_mask(probe)                           # [B, P]

    if use_kernel:
        from grape_vector_db_tpu.ops.ivf_pallas import ivf_probe_scores

        scores = ivf_probe_scores(qp, probe, data, plane, fill=fill, fmt=fmt)
    else:
        # XLA gather phase 2: k lists per query is small, so the gather is
        # bounded even though per-row.
        cand = _dequant(data[probe], fmt)                 # [B, P, C, D]
        dots = rowwise_dots(qb, cand, q_dtype=jnp.bfloat16)
        w = w0[probe]                                     # [B, P, C]
        scores = jnp.where(w == 0.0, -1e9, dots * w)

    scores = jnp.where(dup[:, :, None], -jnp.inf, scores)
    return finalize_probe_topk(qp, probe, scores, k, metric, cell_mask=mask)


@functools.partial(jax.jit, static_argnames=("k", "metric", "fmt",
                                             "chunk_rows"))
def ivf_compact_masked_topk(
    queries: jax.Array,   # [B, D] f32 raw (proj kinds pass projected)
    data: jax.Array,      # [L, C, D] bf16 | [L, C, D] int8 | [L, C, D/2] packed
    plane: jax.Array,     # [L, C] f32 weight plane (recip / factor; 0 = invalid)
    cells: jax.Array,     # [R] int32 flat allowed cell ids lst*C+pos; -1 = pad
    k: int,
    metric: str = "cosine",
    fmt: str = "bf16",
    chunk_rows: int = 131_072,
) -> Tuple[jax.Array, jax.Array]:
    """Exact masked top-k by compaction: gather ONLY the allowed rows, scan
    those.

    The streaming exhaustive scan (above) reads the whole corpus per batch
    regardless of how few rows the filter allows. But the filter mask is
    query-INDEPENDENT: all B queries share one allowed set, so a single
    [R]-row gather amortizes over the batch, and the scan cost becomes
    proportional to selectivity instead of corpus size. At 1% of 16M rows
    that is ~160k rows: a flat-scan-sized problem.

    Same scoring arithmetic as the streaming scan (dot(q_hat, x) * w,
    w = 0 for invalid): the two tiers agree bar bf16 accumulation order.
    ``cells`` must be a padded power-of-two bucket (keeps the jit cache
    small); pad entries are -1 and can only surface as -inf tail.

    Returns (vals [B, k] f32, slots [B, k] int32) — the ``_main_topk``
    contract. Reference parity: filtering.rs:374-400 (the reference's
    always-exact post-intersected full scan; this is the same contract at
    selectivity-proportional cost).
    """
    rows, w = compact_gather(data, plane, cells)
    return compact_topk_from_rows(queries, rows, w, cells, k=k,
                                  metric=metric, fmt=fmt,
                                  chunk_rows=chunk_rows)


@jax.jit
def compact_gather(data: jax.Array, plane: jax.Array,
                   cells: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Gather the allowed rows (source dtype) and their score weights.

    Split out of ``ivf_compact_masked_topk`` so the index can CACHE the
    gathered block per filter: a row gather costs more per row than the
    scan, and production filters repeat (tenant scoping), so a repeat
    filtered query pays scan-only."""
    l, c = plane.shape
    flat = data.reshape((l * c,) + tuple(data.shape[2:]))
    safe = jnp.maximum(cells, 0)
    rows = flat[safe]                                     # [R, D or D/2]
    w = jnp.where(cells >= 0, plane.reshape(-1)[safe], 0.0)           # [R]
    return rows, w


@functools.partial(jax.jit, static_argnames=("k", "metric", "fmt",
                                             "chunk_rows"))
def compact_topk_from_rows(
    queries: jax.Array,   # [B, D] f32 raw
    rows: jax.Array,      # [R, ...] gathered allowed rows (compact_gather)
    w: jax.Array,         # [R] f32 score weights (0 = pad/invalid)
    cells: jax.Array,     # [R] int32 flat cell ids; -1 = pad
    k: int,
    metric: str = "cosine",
    fmt: str = "bf16",
    chunk_rows: int = 131_072,
) -> Tuple[jax.Array, jax.Array]:
    """Scan stage of the compact tier (see ``ivf_compact_masked_topk``)."""
    qp = prepare_queries(queries, metric)
    qb = qp.astype(jnp.bfloat16)
    vals, idx = compact_scan_core(qb, rows, w, k=k, fmt=fmt,
                                  chunk_rows=chunk_rows)
    kk = vals.shape[1]
    slots = jnp.take(cells, idx)                          # [B, kk] (-1 on pad)
    if metric == "cosine":
        vals = jnp.minimum(vals, 1.0)
    vals = jnp.where(jnp.isfinite(vals), vals, -jnp.inf)
    if kk < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
        slots = jnp.pad(slots, ((0, 0), (0, k - kk)))
    return vals, slots


def compact_scan_core(qb: jax.Array, rows: jax.Array, w: jax.Array,
                      k: int, fmt: str,
                      chunk_rows: int) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k over a compacted row block: chunked einsum + exact
    selection with a running top-k merge (shared by the single-chip and
    SPMD compact tiers — trace-level, callers jit). Returns
    (vals [B, kk] f32, idx [B, kk] int32 row indices into ``rows``),
    kk = min(k, chunk)."""
    b = qb.shape[0]
    r = rows.shape[0]
    cr = min(chunk_rows, r)
    nch = max(r // cr, 1)
    kk = min(k, cr)

    def chunk_topk(dd, ww, off):
        cand = _dequant(dd, fmt)                          # [CR, D]
        dots = jnp.einsum("bd,rd->br", qb, cand,
                          preferred_element_type=jnp.float32)
        sc = jnp.where(ww[None] == 0.0, -jnp.inf, dots * ww[None])
        v, i = _select_topk(sc, kk, "exact", 0.99)
        return v, i.astype(jnp.int32) + off

    if nch == 1:
        return chunk_topk(rows, w, jnp.int32(0))

    r3 = rows.reshape((nch, cr) + tuple(rows.shape[1:]))
    w3 = w.reshape(nch, cr)
    offs = jnp.arange(nch, dtype=jnp.int32) * cr

    def body(carry, xs):
        cv, ci = carry
        v, i = chunk_topk(*xs)
        mv = jnp.concatenate([cv, v], axis=1)             # [B, 2k]
        mi = jnp.concatenate([ci, i], axis=1)
        sv, si = _select_topk(mv, kk, "exact", 0.99)
        return (sv, jnp.take_along_axis(mi, si, axis=1)), None

    init = (jnp.full((b, kk), -jnp.inf, jnp.float32),
            jnp.zeros((b, kk), jnp.int32))
    (vals, idx), _ = lax.scan(body, init, (r3, w3, offs))
    return vals, idx
