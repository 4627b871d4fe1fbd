"""Binary quantization kernels: bit packing + XOR/popcount Hamming scan.

Device-native replacement for the reference's binary quantization
(quantization.rs:97-193): threshold binarization into packed bit-planes, Hamming
distance via XOR + popcount, and the top-candidate selection used by two-stage
search (Hamming pre-scan -> exact rescore).

Layout: each vector's bits are packed into ``ceil(dim / 32)`` uint32 words
(bit j of word w = coord ``w*32 + j`` > threshold). A corpus of N vectors is a
``[N, W]`` uint32 array — 32x smaller than f32, matching the reference's
compression claims; the reference scan is ``lax.population_count`` over
XOR'd words, the default scan a sign-bit matmul.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["words_per_vector", "pack_bits", "hamming_scores", "hamming_topk",
           "asym_topk"]


def words_per_vector(dim: int) -> int:
    return (dim + 31) // 32


def pack_bits(x: jax.Array, threshold: float = 0.0) -> jax.Array:
    """Binarize + pack: [N, D] float -> [N, W] uint32 (quantization.rs:97-103).

    Coordinates beyond D (padding to a multiple of 32) pack as 0 bits on both
    query and corpus sides, so they never contribute to Hamming distance.
    """
    n, d = x.shape
    w = words_per_vector(d)
    pad = w * 32 - d
    bits = (x > threshold).astype(jnp.uint32)
    if pad:
        bits = jnp.pad(bits, ((0, 0), (0, pad)))
    bits = bits.reshape(n, w, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def _unpack_signs(c: jax.Array) -> jax.Array:
    """[N, W] uint32 -> [N, W*32] bfloat16 in {-1, +1} (bit b -> 2b-1)."""
    bits = (c[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & jnp.uint32(1)
    return (2.0 * bits.astype(jnp.bfloat16) - 1.0).reshape(c.shape[0], -1)


def hamming_scores(qcodes: jax.Array, codes: jax.Array,
                   impl: str = "mxu") -> jax.Array:
    """Hamming distances: [B, W] x [C, W] -> [B, C] int32.

    impl="mxu" (default): sign-bit matmul — for s in {-1,+1}^D,
    dot(s_q, s_x) = D - 2*hamming, so the scan is one bf16 matmul on the
    matrix units after an on-the-fly bit->sign decode, instead of
    elementwise XOR + popcount work over a [B, C, W] broadcast. The decode
    materializes the chunk as bf16 (+2x chunk traffic), which is why the
    caller chunks the corpus. impl="xla" is the XOR + popcount form, kept as
    the reference. The reference popcounts on CPU with the `hamming` crate
    (quantization.rs:130-141).
    """
    if impl == "mxu":
        qs = _unpack_signs(qcodes)
        xs = _unpack_signs(codes)
        dot = lax.dot_general(qs, xs, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
        d_tot = jnp.float32(codes.shape[1] * 32)
        return ((d_tot - dot) * 0.5).astype(jnp.int32)
    if impl != "xla":
        raise ValueError(f"unknown hamming impl: {impl}")
    x = jnp.bitwise_xor(qcodes[:, None, :], codes[None, :, :])  # [B, C, W]
    return jnp.sum(lax.population_count(x), axis=-1, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "chunk", "impl"))
def hamming_topk(
    qcodes: jax.Array,   # [B, W] uint32
    codes: jax.Array,    # [N, W] uint32 (capacity-padded)
    valid: jax.Array,    # [N] bool
    k: int,
    chunk: int = 16384,
    impl: str = "xla",
) -> Tuple[jax.Array, jax.Array]:
    """Top-k *smallest* Hamming distance over the packed corpus.

    Returns (distances [B, k] int32, indices [B, k] int32). Invalid rows get
    distance INT32_MAX/2 so they sort last. This is the pre-scan stage of the
    reference's multi_stage_search (quantization.rs:151-193).
    """
    n, w = codes.shape
    b = qcodes.shape[0]
    chunk = min(chunk, n)
    assert n % chunk == 0
    num_chunks = n // chunk
    kk = min(k, chunk)
    big = jnp.int32(2**30)

    def block(codes_i, valid_i, off):
        d = hamming_scores(qcodes, codes_i, impl=impl)  # [B, chunk]
        d = jnp.where(valid_i[None, :], d, big)
        # Select the smallest distances. lax.top_k dominates the whole scan for
        # the large k this pre-stage uses (rescore candidates, k ~ 1024);
        # approx_max_k runs at roofline and a near-miss candidate set is fine —
        # the exact rescore stage decides the final ranking.
        if kk > 16:
            vals, idxs = lax.approx_max_k(-d.astype(jnp.float32), kk,
                                          recall_target=0.95)
            return (-vals).astype(jnp.int32), idxs.astype(jnp.int32) + off
        vals, idxs = lax.top_k(-d, kk)
        return -vals, idxs.astype(jnp.int32) + off

    if num_chunks == 1:
        vals, idxs = block(codes, valid, jnp.int32(0))
        return _pad_k(vals, idxs, k, big)

    codes_c = codes.reshape(num_chunks, chunk, w)
    valid_c = valid.reshape(num_chunks, chunk)
    offsets = jnp.arange(num_chunks, dtype=jnp.int32) * chunk

    def body(carry, xs):
        codes_i, valid_i, off = xs
        return carry, block(codes_i, valid_i, off)

    _, (vals, idxs) = lax.scan(body, None, (codes_c, valid_c, offsets))
    vals = jnp.moveaxis(vals, 0, 1).reshape(b, num_chunks * kk)
    idxs = jnp.moveaxis(idxs, 0, 1).reshape(b, num_chunks * kk)
    kf = min(k, num_chunks * kk)
    if kf > 16:
        fvals, fpos = lax.approx_max_k(-vals.astype(jnp.float32), kf,
                                       recall_target=0.95)
        fvals = (-fvals).astype(jnp.int32)
    else:
        nfvals, fpos = lax.top_k(-vals, kf)
        fvals = -nfvals
    fidx = jnp.take_along_axis(idxs, fpos, axis=1)
    return _pad_k(fvals, fidx, k, big)


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def asym_topk(
    queries: jax.Array,  # [B, D] f32 raw (normalized internally)
    codes: jax.Array,    # [N, W] uint32 (capacity-padded)
    valid: jax.Array,    # [N] bool
    k: int,
    chunk: int = 16384,
) -> Tuple[jax.Array, jax.Array]:
    """Asymmetric binary prescan: top-k LARGEST ``dot(q_unit, sign(x))``.

    The binary analog of asymmetric PQ/ADC scoring: the corpus side is the
    decoded sign vector (what the codes can express) but the query side
    keeps its real values instead of being crushed to signs. This is the
    SAME bf16 matmul as the Hamming form (hamming_scores
    impl="mxu" decodes to ±1 and matmuls sign(q)); only the left operand
    differs — so the scan costs the same and ranks strictly better.
    Recall@10 after exact rescore on an isotropic 131k x 768 corpus was
    0.426/0.679/0.884 at budgets 64/256/1024 vs Hamming's 0.170/0.330/0.554
    (clustered corpora tie at ~0.97). Returns (scores [B, k] f32 DESCENDING, indices [B, k] int32);
    invalid rows score -inf. No reference analog (quantization.rs ranks by
    symmetric Hamming only) — this exists because the matmul decode path
    makes the asymmetric form free.
    """
    n, w = codes.shape
    b = queries.shape[0]
    chunk = min(chunk, n)
    assert n % chunk == 0
    num_chunks = n // chunk
    kk = min(k, chunk)
    qn = queries / jnp.maximum(
        jnp.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    qb = qn.astype(jnp.bfloat16)

    def block(codes_i, valid_i, off):
        xs = _unpack_signs(codes_i)                       # [chunk, D] ±1
        dots = lax.dot_general(qb, xs, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32)
        dots = jnp.where(valid_i[None, :], dots, -jnp.inf)
        if kk > 16:
            vals, idxs = lax.approx_max_k(dots, kk, recall_target=0.95)
            return vals, idxs.astype(jnp.int32) + off
        vals, idxs = lax.top_k(dots, kk)
        return vals, idxs.astype(jnp.int32) + off

    if num_chunks == 1:
        vals, idxs = block(codes, valid, jnp.int32(0))
        return _pad_k(vals, idxs, k, -jnp.inf)

    codes_c = codes.reshape(num_chunks, chunk, w)
    valid_c = valid.reshape(num_chunks, chunk)
    offsets = jnp.arange(num_chunks, dtype=jnp.int32) * chunk

    def body(carry, xs):
        codes_i, valid_i, off = xs
        return carry, block(codes_i, valid_i, off)

    _, (vals, idxs) = lax.scan(body, None, (codes_c, valid_c, offsets))
    vals = jnp.moveaxis(vals, 0, 1).reshape(b, num_chunks * kk)
    idxs = jnp.moveaxis(idxs, 0, 1).reshape(b, num_chunks * kk)
    kf = min(k, num_chunks * kk)
    if kf > 16:
        fvals, fpos = lax.approx_max_k(vals, kf, recall_target=0.95)
    else:
        fvals, fpos = lax.top_k(vals, kf)
    fidx = jnp.take_along_axis(idxs, fpos, axis=1)
    return _pad_k(fvals, fidx, k, -jnp.inf)


def _pad_k(vals: jax.Array, idxs: jax.Array, k: int, fill) -> Tuple[jax.Array, jax.Array]:
    got = vals.shape[1]
    if got >= k:
        return vals[:, :k], idxs[:, :k]
    pad = k - got
    vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=fill)
    idxs = jnp.pad(idxs, ((0, 0), (0, pad)), constant_values=0)
    return vals, idxs
