"""K-means as jitted matmul-argmin iterations.

Replaces the reference's hand-rolled CPU k-means (index.rs:429-503
`kmeans_clustering`) with the matmul form: each iteration is one
``[N, D] x [D, K]`` matmul for assignment plus a segment-sum for the centroid
update. Empty clusters keep their previous centroid (the reference re-seeds
randomly; keeping is deterministic and jit-friendly).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["kmeans", "assign_clusters"]


def _pairwise_sq_dist(x: jax.Array, c: jax.Array) -> jax.Array:
    """[N, D], [K, D] -> [N, K] squared L2 distances (f32 accumulation)."""
    x2 = jnp.sum(x * x, axis=-1, keepdims=True)          # [N, 1]
    c2 = jnp.sum(c * c, axis=-1)[None, :]                # [1, K]
    xc = lax.dot_general(
        x, c, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    return x2 - 2.0 * xc + c2


def _l2n(x: jax.Array, eps: float = 1e-12) -> jax.Array:
    return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), eps)


def assign_clusters(x: jax.Array, centroids: jax.Array,
                    mode: str = "l2") -> jax.Array:
    """[N, D] -> [N] int32 nearest-centroid ids.

    mode="spherical": assign by max cosine (centroids assumed unit-norm; x is
    normalized here). REQUIRED for cosine-metric IVF on near-isotropic
    high-dim data: under L2, |x - c|^2 = |x|^2 - 2x.c + |c|^2 and with x.c ~ 0
    the smallest-norm centroid captures almost every point (one list can
    take nearly half of a random 768-d corpus), which destroys IVF pruning.

    The assignment decides which list a row lands in, so its product runs
    at full f32 precision (``HIGHEST``, never TF32 on a GPU)."""
    if mode == "spherical":
        sims = lax.dot_general(
            _l2n(x), centroids, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )
        return jnp.argmax(sims, axis=-1).astype(jnp.int32)
    return jnp.argmin(_pairwise_sq_dist(x, centroids), axis=-1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "iters", "mode", "chunk"))
def kmeans(
    x: jax.Array, k: int, iters: int = 10, seed: int = 0, mode: str = "l2",
    chunk: int | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Lloyd's algorithm on device. Returns (centroids [k, D], assignment [N]).

    x must be f32 [N, D] with N >= k. mode="spherical" runs spherical k-means
    (unit-norm centroids, cosine assignment) — the correct variant for
    cosine/dot metrics.

    ``chunk``: process the sample in row chunks of this size (N % chunk == 0).
    The unchunked form materializes [N, K] one-hot/affinity planes — at
    k=16384 that is 4 GiB per 65k rows, so large-nlist training at large
    sample sizes needs the chunked scan (same fixed point, bounded memory).
    """
    n, d = x.shape
    key = jax.random.PRNGKey(seed)
    init_idx = jax.random.choice(key, n, shape=(k,), replace=False)
    centroids = x[init_idx]
    if mode == "spherical":
        x = _l2n(x)
        centroids = _l2n(centroids)

    def accumulate(centroids, xc):
        assign = assign_clusters(xc, centroids, mode=mode)
        one_hot = jax.nn.one_hot(assign, k, dtype=jnp.float32)      # [C, K]
        counts = jnp.sum(one_hot, axis=0)                           # [K]
        sums = lax.dot_general(
            one_hot, xc, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )                                                           # [K, D]
        return sums, counts

    if chunk is not None and chunk < n and n % chunk:
        # A silent fallback would materialize the [N, K] plane the chunk
        # argument exists to avoid (4 GiB per 65k rows at k=16384).
        raise ValueError(f"kmeans: n={n} must be a multiple of chunk={chunk}")
    use_chunks = chunk is not None and chunk < n
    if use_chunks:
        xc_all = x.reshape(n // chunk, chunk, d)

    def step(centroids, _):
        if use_chunks:
            def body(carry, xc):
                s, c = carry
                ds, dc = accumulate(centroids, xc)
                return (s + ds, c + dc), None

            (sums, counts), _ = lax.scan(
                body,
                (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32)),
                xc_all,
            )
        else:
            sums, counts = accumulate(centroids, x)
        new_c = sums / jnp.maximum(counts, 1.0)[:, None]
        if mode == "spherical":
            new_c = _l2n(new_c)
        # Empty clusters keep their previous centroid.
        new_c = jnp.where((counts > 0)[:, None], new_c, centroids)
        return new_c, None

    centroids, _ = lax.scan(step, centroids, None, length=iters)
    if use_chunks:
        assign = jnp.concatenate([
            assign_clusters(xc_all[i], centroids, mode=mode)
            for i in range(n // chunk)
        ])
    else:
        assign = assign_clusters(x, centroids, mode=mode)
    return centroids, assign
