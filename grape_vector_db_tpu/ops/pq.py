"""Product quantization: per-subspace codebooks + ADC scoring.

The reference trains PQ codebooks (index.rs:506-556 `train_pq_quantizer`:
per-subvector k-means) but never actually searches with them (its search is a
linear scan regardless, index.rs:620-640). Here PQ is functional end to end:

- ``train_pq``: k-means per subspace on device (reuses ops/kmeans).
- ``encode_pq``: nearest-codeword assignment per subspace -> uint8 codes
  ``[N, S]`` (S = dim / dsub; 8 bits per code => dim*4/S x compression).
- ``adc_topk``: asymmetric distance computation — per query build a
  ``[S, 256]`` lookup table of subspace dot products, then accumulate
  ``sum_s LUT[s, code[n, s]]`` over the corpus with a subspace scan.

Economics note: matrix units make dense bf16 dot products nearly free, so PQ
is a *capacity* play (e.g. 96 bytes/vector for 768-d PQ96 vs 1536 bf16
bytes — 16x more corpus per device), not a latency play. The ADC scan is
gather-bound; pair it with exact rescoring of the top candidates like the
binary index does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from grape_vector_db_tpu.ops.kmeans import kmeans

__all__ = ["train_pq", "encode_pq", "adc_topk"]


def train_pq(
    vectors: jax.Array,  # [N, D] f32 training sample
    n_sub: int,
    nbits: int = 8,
    iters: int = 10,
    seed: int = 0,
) -> jax.Array:
    """Train per-subspace codebooks. Returns [n_sub, 2^nbits, dsub] f32."""
    n, d = vectors.shape
    assert d % n_sub == 0, f"dim {d} must divide into {n_sub} subspaces"
    dsub = d // n_sub
    k = 2 ** nbits
    if n < k:
        raise ValueError(f"need >= {k} training vectors for {nbits}-bit PQ")
    subs = vectors.reshape(n, n_sub, dsub)
    books = []
    for s in range(n_sub):
        cents, _ = kmeans(subs[:, s, :], k=k, iters=iters, seed=seed + s)
        books.append(cents)
    return jnp.stack(books)  # [S, K, dsub]


@functools.partial(jax.jit)
def encode_pq(vectors: jax.Array, codebooks: jax.Array) -> jax.Array:
    """[N, D] x [S, K, dsub] -> [N, S] uint8 nearest-codeword codes."""
    n, d = vectors.shape
    s, k, dsub = codebooks.shape
    subs = vectors.reshape(n, s, dsub)
    # distances per subspace: |x|^2 - 2 x.c + |c|^2 -> argmin over K
    x2 = jnp.sum(subs * subs, axis=-1)[:, :, None]          # [N, S, 1]
    c2 = jnp.sum(codebooks * codebooks, axis=-1)[None]      # [1, S, K]
    xc = jnp.einsum("nsd,skd->nsk", subs, codebooks,
                    preferred_element_type=jnp.float32)
    d2 = x2 - 2.0 * xc + c2
    return jnp.argmin(d2, axis=-1).astype(jnp.uint8)        # [N, S]


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def adc_topk(
    queries: jax.Array,    # [B, D] f32
    codebooks: jax.Array,  # [S, K, dsub] f32
    codes: jax.Array,      # [N, S] uint8
    norms: jax.Array,      # [N] f32 (true norms for cosine normalization)
    valid: jax.Array,      # [N] bool
    k: int,
    chunk: int = 65536,
) -> Tuple[jax.Array, jax.Array]:
    """Approximate cosine top-k via ADC. Returns (scores [B,k], idx [B,k]).

    Approximate dot(q, x) = sum_s LUT[s, code[x, s]] with
    LUT[s, j] = dot(q_s, codebook[s, j]); cosine divides by the stored true
    norm of x.
    """
    b, d = queries.shape
    s, kk_, dsub = codebooks.shape
    n = codes.shape[0]
    q_subs = queries.reshape(b, s, dsub)
    lut = jnp.einsum("bsd,skd->bsk", q_subs, codebooks,
                     preferred_element_type=jnp.float32)     # [B, S, K]

    chunk = min(chunk, n)
    assert n % chunk == 0
    num_chunks = n // chunk
    kq = min(k, chunk)
    codes_c = codes.reshape(num_chunks, chunk, s)
    norms_c = norms.reshape(num_chunks, chunk)
    valid_c = valid.reshape(num_chunks, chunk)
    offs = jnp.arange(num_chunks, dtype=jnp.int32) * chunk

    def score_chunk(codes_i):
        # accumulate over subspaces: acc[b, c] += LUT[b, s, codes_i[c, s]]
        def sub_step(acc, sub):
            s_i, code_col = sub
            acc = acc + jnp.take(lut[:, s_i, :], code_col, axis=1)
            return acc, None

        cols = jnp.moveaxis(codes_i.astype(jnp.int32), 0, 1)   # [S, chunk]
        acc0 = jnp.zeros((b, codes_i.shape[0]), jnp.float32)
        acc, _ = lax.scan(sub_step, acc0,
                          (jnp.arange(s, dtype=jnp.int32), cols))
        return acc

    def body(carry, xs):
        codes_i, norms_i, valid_i, off = xs
        dots = score_chunk(codes_i)
        qn = jnp.linalg.norm(queries, axis=1, keepdims=True)
        scores = dots / jnp.maximum(norms_i[None, :] * qn, 1e-12)
        scores = jnp.where(valid_i[None, :], scores, -jnp.inf)
        vals, idxs = lax.top_k(scores, kq)
        return carry, (vals, idxs.astype(jnp.int32) + off)

    _, (vals, idxs) = lax.scan(body, None, (codes_c, norms_c, valid_c, offs))
    vals = jnp.moveaxis(vals, 0, 1).reshape(b, num_chunks * kq)
    idxs = jnp.moveaxis(idxs, 0, 1).reshape(b, num_chunks * kq)
    fvals, fpos = lax.top_k(vals, min(k, num_chunks * kq))
    return fvals, jnp.take_along_axis(idxs, fpos, axis=1)
