"""int8 symmetric-quantized scan — the memory-bandwidth play for flat search.

A full-corpus scan at small batch is bound by the corpus read. Per-row
symmetric int8 halves the bytes per row; an exact bf16 rescore of the top
candidates restores near-perfect ranking.

Layout: codes ``[N, D] int8`` (vi = round(127 * v / max|v|)) plus a per-row
``factor = (max|v| / 127) / |v|`` that folds dequantization and the cosine
norm division into one multiply. Query side quantizes the L2-normalized query
the same way; scores = (qi . vi) * q_scale * factor — a monotonic cosine
approximation. The int8 product accumulates in int32.

No reference analog (quantization.rs only has 1-bit); this engine exists
because device memory bandwidth rewards it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["quantize_int8", "int8_topk"]

NEG = jnp.float32(-jnp.inf)


@jax.jit
def quantize_int8(vecs: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """[M, D] f32 -> (codes [M, D] int8, scale [M] f32 = max|v| / 127)."""
    vf = vecs.astype(jnp.float32)
    s = jnp.max(jnp.abs(vf), axis=1) / 127.0
    vi = jnp.clip(
        jnp.round(vf / jnp.maximum(s, 1e-12)[:, None]), -127, 127
    ).astype(jnp.int8)
    return vi, s


def _block(qi, q_scale, codes_i, factor_i, valid_i, kk: int):
    """Local top-kk within one chunk; caller adds the chunk offset."""
    dots = lax.dot_general(qi, codes_i, (((1,), (1,)), ((), ())),
                           preferred_element_type=jnp.int32)      # int8 MMA
    scores = dots.astype(jnp.float32) * factor_i[None, :] * q_scale
    scores = jnp.where(valid_i[None, :], scores, NEG)
    # candidate selection only — the exact rescore stage decides ranking
    if kk > 16:
        vals, idxs = lax.approx_max_k(scores, kk, recall_target=0.95)
    else:
        vals, idxs = lax.top_k(scores, kk)
    return vals, idxs.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def int8_topk(
    queries: jax.Array,  # [B, D] f32 raw
    codes: jax.Array,    # [N, D] int8 (capacity-padded)
    factor: jax.Array,   # [N] f32 = scale / |v|  (dequant x cosine fold)
    valid: jax.Array,    # [N] bool
    k: int,
    chunk: int = 131_072,
) -> Tuple[jax.Array, jax.Array]:
    """Top-k approximate cosine over the int8 corpus.

    Returns (scores [B, k] f32, indices [B, k] int32) — candidates for an
    exact rescore (index/int8.py), scores are the quantized approximation.
    """
    n, d = codes.shape
    b = queries.shape[0]
    qf = queries.astype(jnp.float32)
    qf = qf / jnp.maximum(jnp.linalg.norm(qf, axis=1, keepdims=True), 1e-12)
    qs = jnp.max(jnp.abs(qf), axis=1, keepdims=True) / 127.0
    qi = jnp.clip(jnp.round(qf / qs), -127, 127).astype(jnp.int8)

    chunk = min(chunk, n)
    assert n % chunk == 0, f"capacity {n} must be a multiple of chunk {chunk}"
    num_chunks = n // chunk
    kk = min(k, chunk)

    if num_chunks == 1:
        vals, idxs = _block(qi, qs, codes, factor, valid, kk)
        return _pad(vals, idxs, k)

    codes_c = codes.reshape(num_chunks, chunk, d)
    factor_c = factor.reshape(num_chunks, chunk)
    valid_c = valid.reshape(num_chunks, chunk)
    offs = jnp.arange(num_chunks, dtype=jnp.int32) * chunk

    def body(carry, xs):
        codes_i, factor_i, valid_i, off = xs
        vals, idxs = _block(qi, qs, codes_i, factor_i, valid_i, kk)
        return carry, (vals, idxs + off)

    _, (vals, idxs) = lax.scan(body, None, (codes_c, factor_c, valid_c, offs))
    vals = jnp.moveaxis(vals, 0, 1).reshape(b, num_chunks * kk)
    idxs = jnp.moveaxis(idxs, 0, 1).reshape(b, num_chunks * kk)
    fvals, fpos = lax.top_k(vals, min(k, num_chunks * kk))
    fidx = jnp.take_along_axis(idxs, fpos, axis=1)
    return _pad(fvals, fidx, k)


def _pad(vals, idxs, k):
    got = vals.shape[1]
    if got >= k:
        return vals[:, :k], idxs[:, :k]
    pad = k - got
    return (
        jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-jnp.inf),
        jnp.pad(idxs, ((0, 0), (0, pad))),
    )
