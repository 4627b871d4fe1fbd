"""Fused matmul + segment-max kernel (Pallas, ``backend="triton"``) — the
exact large-corpus top-k engine on NVIDIA GPUs.

The XLA form of the two-phase exact engine (``ops/distance._segmax_exact_topk``)
writes a ``[B, chunk]`` f32 score block per corpus chunk to device memory and
reads it back to reduce it to segment maxima. This kernel keeps the scores in
registers: each program scores one ``[CB, D]`` corpus block against one query
tile and writes only the ``[bq, CB/32]`` segment maxima, so device memory sees
the corpus once plus a 32x smaller plane.

Segments are STRIDED within a block: a program walks its block as 32 sub-tiles
of ``sub`` rows and keeps a running element-wise max over the sub-tile score
tiles, so column ``j`` of block ``blk`` holds the max over rows
``blk * CB + j + m * sub`` for ``m`` in ``[0, 32)``. Phase 2 expands a chosen
segment back to those 32 rows with index arithmetic and rescores them exactly.
Exactness is partition-independent: if a true top-k value lay outside the
chosen segments, k segments would each hold a strictly larger value.

Reference parity: the exact search path of the reference's full-scan cosine
(storage.rs:296-339) at 1M+ rows.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from grape_vector_db_tpu.ops.distance import (
    SEGMENT as SEG, _dup_pick_mask, _iterative_topk, prepare_queries,
    rowwise_dots, score_weights)

__all__ = ["segmax_scores", "segmax_topk", "segmax_kernel_fits",
           "SEG", "SUB", "CB"]

SUB = 128           # rows per sub-tile = segment columns per program block
CB = SEG * SUB      # corpus rows per program (4096)
BQ = 64             # query rows per program (one wgmma row tile)

# Launch parameters of the compiled kernel: the fastest of six variants
# timed on an H100 at 1M x 768, B = 128 and 256.
_LAUNCH = {"bk": 64, "num_warps": 8, "num_stages": 3}


def segmax_kernel_fits(n: int, d: int, dtype) -> bool:
    """Shapes the kernel takes: bf16 rows (f32 storage asks for full-precision
    products, which the XLA form gives), whole blocks, and a dimension the
    contraction tile divides."""
    return (jnp.dtype(dtype) == jnp.bfloat16 and n % CB == 0
            and d % 16 == 0)


def _contraction_tile(d: int) -> int:
    bk = _LAUNCH["bk"]
    while d % bk:
        bk //= 2
    return bk


def _segmax_kernel(q_ref, v_ref, w_ref, o_ref, *, bk: int, nk: int):
    """One program: query tile ``qt`` x corpus block ``blk`` -> [BQ, SUB]
    strided segment maxima."""
    qt = pl.program_id(0)
    blk = pl.program_id(1)
    q0 = pl.multiple_of(qt * BQ, BQ)

    def sub_tile(m, run):
        base = pl.multiple_of(blk * CB + m * SUB, SUB)

        def k_step(kc, acc):
            k0 = pl.multiple_of(kc * bk, bk)
            qk = q_ref[pl.ds(q0, BQ), pl.ds(k0, bk)]          # [BQ, bk]
            vk = v_ref[pl.ds(base, SUB), pl.ds(k0, bk)]       # [SUB, bk]
            return acc + pl.dot(qk, vk, trans_b=True)

        acc = lax.fori_loop(0, nk, k_step,
                            jnp.zeros((BQ, SUB), jnp.float32))
        w = w_ref[pl.ds(base, SUB)]                            # [SUB]
        # select-style mask: -inf cannot be outranked, unlike a sentinel
        # bias against a large-negative dot-metric score
        sc = jnp.where(w[None, :] == 0.0, -jnp.inf, acc * w[None, :])
        return jnp.maximum(run, sc)

    run = lax.fori_loop(0, SEG, sub_tile,
                        jnp.full((BQ, SUB), -jnp.inf, jnp.float32))
    o_ref[pl.ds(q0, BQ), pl.ds(pl.multiple_of(blk * SUB, SUB), SUB)] = run


@functools.partial(jax.jit, static_argnames=("interpret",))
def segmax_scores(
    q: jax.Array,        # [B, D] f32 prepared (normalized for cosine)
    vectors: jax.Array,  # [N, D] bf16, N % CB == 0
    w: jax.Array,        # [N] f32 validity-masked score weight (0 = invalid)
    interpret: bool = False,
) -> jax.Array:
    """[B, N/SEG] f32 strided segment maxima. Segment g = blk * SUB + j covers
    rows blk * CB + j + m * SUB, m in [0, SEG)."""
    b, d = q.shape
    n = vectors.shape[0]
    if n % CB:
        raise ValueError(f"N={n} must be a multiple of {CB}")
    bk = _contraction_tile(d)
    bp = -(-b // BQ) * BQ
    qb = jnp.pad(q.astype(vectors.dtype), ((0, bp - b), (0, 0)))
    out = pl.pallas_call(
        functools.partial(_segmax_kernel, bk=bk, nk=d // bk),
        out_shape=jax.ShapeDtypeStruct((bp, n // SEG), jnp.float32),
        # query tiles vary fastest, so the tiles that share a corpus block
        # run side by side and its second read comes from L2
        grid=(bp // BQ, n // CB),
        compiler_params=plgpu.CompilerParams(
            num_warps=_LAUNCH["num_warps"], num_stages=_LAUNCH["num_stages"]),
        interpret=interpret,
        name="segmax_scan",
    )(qb, vectors, w)
    return out[:b]


def _twolevel_topk(plane: jax.Array, kk: int, fan: int = 128
                   ) -> Tuple[jax.Array, jax.Array]:
    """Exact top-kk over the minor axis via supersegment pre-selection.

    The iterative max-and-mask selection reads the whole [B, W] plane kk
    times. Reduce it to [B, W/fan] maxima over CONTIGUOUS fan-column blocks,
    select top-kk there, then take the top-kk over the chosen blocks'
    children (a [1, 1, fan] slice gather per pick). Exactness is the segment
    argument one level up: a top-kk column's block bounds it from above, so
    kk better blocks would imply kk better columns; boundary ties are
    interchangeable by value."""
    b, w = plane.shape
    ns = w // fan
    if ns < kk or w % fan:
        return _iterative_topk(plane, kk)
    p3 = plane.reshape(b, ns, fan)
    _, blks = _iterative_topk(p3.max(axis=-1), kk)          # [B, kk]
    cvals = jnp.take_along_axis(p3, blks[:, :, None], axis=1)  # [B, kk, fan]
    # Fewer than kk finite blocks: the selection's -inf tail repeats block 0,
    # whose children would then enter the final top-k twice.
    cvals = jnp.where(_dup_pick_mask(blks)[:, :, None], -jnp.inf, cvals)
    cvals = cvals.reshape(b, kk * fan)
    child = (blks[:, :, None] * fan
             + jnp.arange(fan, dtype=jnp.int32)[None, None, :]
             ).reshape(b, kk * fan)
    tv, tp = lax.top_k(cvals, kk)
    return tv, jnp.take_along_axis(child, tp, axis=1)


@functools.partial(jax.jit, static_argnames=("k", "metric", "interpret"))
def segmax_topk(
    queries: jax.Array,   # [B, D] f32 raw
    vectors: jax.Array,   # [N, D] bf16, N % CB == 0
    norms: jax.Array,     # [N] f32
    valid: jax.Array,     # [N] bool
    k: int,
    metric: str = "cosine",
    interpret: bool = False,
    mask: jax.Array | None = None,  # [N] bool filter (True = allowed)
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k via the segment-max kernel + an exact rescore of the
    chosen segments' rows. Same (vals, idxs) contract as
    ``ops.distance.scored_topk`` for cosine and dot."""
    n, d = vectors.shape
    b = queries.shape[0]
    if mask is not None:
        valid = jnp.logical_and(valid, mask)
    q = prepare_queries(queries, metric)
    w = score_weights(norms, valid, metric)
    segmax = segmax_scores(q, vectors, w, interpret=interpret)  # [B, N/SEG]
    num_seg = n // SEG
    kk = min(k, num_seg)
    select = _twolevel_topk if num_seg >= 16_384 else _iterative_topk
    _, seg_ids = select(segmax, kk)

    # strided member rows: segment g = blk * SUB + j covers
    # rows blk * CB + j + m * SUB, m in [0, SEG)
    blk = seg_ids // SUB
    j = seg_ids % SUB
    m = jnp.arange(SEG, dtype=jnp.int32)[None, None, :]
    rows = (blk[:, :, None] * CB + j[:, :, None] + m * SUB
            ).reshape(b, kk * SEG)                               # [B, kk*SEG]
    dots = rowwise_dots(q, vectors[rows])
    # same arithmetic form as phase 1 (multiply by the masked weight), so a
    # row scores the same in both phases up to accumulation order
    cw = w[rows]
    rs = jnp.where(cw == 0.0, -jnp.inf, dots * cw)
    if metric == "cosine":
        rs = jnp.minimum(rs, 1.0)
    # degenerate plane: fewer finite segments than kk repeats segment ids,
    # which would rescore the same rows to the same finite values twice
    rs = jnp.where(jnp.repeat(_dup_pick_mask(seg_ids), SEG, axis=1),
                   -jnp.inf, rs)
    fvals, fpos = lax.top_k(rs, min(k, rs.shape[1]))
    fidx = jnp.take_along_axis(rows, fpos, axis=1)
    return fvals, fidx.astype(jnp.int32)
