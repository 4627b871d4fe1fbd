"""IVF probe helpers shared by the probe kernel (ops/ivf_pallas.py) and the
XLA probes (index/ivf*.py, parallel/mesh.py): list routing, the score-weight
planes, and the stage-2 selection.

The weight plane is ``[L, C]`` f32: it folds the cosine norm division (and,
for quantized layouts, the dequantization scale) into one multiply, and
``0`` marks an invalid cell.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from grape_vector_db_tpu.ops.distance import rowwise_dots

__all__ = ["probe_lists", "finalize_probe_topk", "make_factor",
           "use_probe_kernel", "FORMATS"]

FORMATS = ("bf16", "int8", "int4")


def use_probe_kernel(metric: str, platform: str | None = None) -> bool:
    """Whether the IVF kinds score probed lists with the kernel
    (ops/ivf_pallas.py): on a GPU, for the angular metrics it scores. Every
    other case takes the XLA gather probe."""
    platform = platform or jax.default_backend()
    return platform == "gpu" and metric in ("cosine", "dot")


def probe_lists(qp: jax.Array, centroids: jax.Array, nprobe: int,
                metric: str) -> jax.Array:
    """[B, P] ids of each query's ``nprobe`` nearest lists.

    The centroid product decides which lists are scanned at all, so it runs
    at full f32 precision (``HIGHEST``): a TF32 product could pick other lists
    than the reference and change the result set."""
    cq = lax.dot_general(qp, centroids, (((1,), (1,)), ((), ())),
                         preferred_element_type=jnp.float32,
                         precision=lax.Precision.HIGHEST)           # [B, L]
    if metric == "euclidean":
        c2 = jnp.sum(centroids * centroids, axis=-1)[None, :]
        cq = -(jnp.sum(qp * qp, axis=-1, keepdims=True) - 2 * cq + c2)
    _, probe = lax.top_k(cq, min(nprobe, centroids.shape[0]))
    return probe.astype(jnp.int32)


def finalize_probe_topk(
    qp: jax.Array,        # [B, D] prepared queries
    probe: jax.Array,     # [B, P] probed list ids
    scores: jax.Array,    # [B, P, C] stage-2 scores (invalid <= -1e9)
    k: int,
    metric: str,
    cell_mask: jax.Array | None = None,  # [L, C] bool filter
    rescore: int = 0,
    vecs: jax.Array | None = None,       # [L, C, D] rescore shadow
    weight_fn=None,       # (rl [B,R], rp [B,R]) -> [B,R] f32 score weight
                          #   (1/norm for cosine, 1 for dot; 0 = invalid)
) -> Tuple[jax.Array, jax.Array]:
    """Shared stage-2 selection: slot mapping, filter-mask fold, optional
    exact rescore of the top candidates, final top-k + pad.

    One implementation so the invalid-score sentinel contract (-1e9 from the
    scoring stage, -inf after mask/validity folds, ``rv > -1e8`` as the
    rescore guard) and the cosine <=1.0 clamp stay single-sourced across the
    bf16 / int8 / int4 kernel and XLA probes."""
    b, p, c = scores.shape
    pos = lax.broadcasted_iota(jnp.int32, (b, p, c), 2)
    gslot = (probe[:, :, None] * c + pos).reshape(b, p * c)
    flat = scores.reshape(b, p * c)
    if cell_mask is not None:
        allowed = cell_mask[probe]                             # [B, P, C]
        flat = jnp.where(allowed.reshape(b, p * c), flat, -jnp.inf)

    if rescore and vecs is not None:
        r = min(rescore, p * c)
        rv, ridx = lax.top_k(flat, r)
        rslot = jnp.take_along_axis(gslot, ridx, axis=1)       # [B, R]
        rl, rp = rslot // c, rslot % c
        cand = vecs[rl, rp]                                    # [B, R, D]
        w = weight_fn(rl, rp)                                  # [B, R]
        exact = rowwise_dots(qp, cand) * w
        if metric == "cosine":
            exact = jnp.minimum(exact, 1.0)
        # rv > -1e8 excludes masked (-inf) AND invalid (-1e9) candidates;
        # w > 0 excludes cells deleted after the candidate scores were built.
        exact = jnp.where((rv > -1e8) & (w > 0), exact, -jnp.inf)
        kk = min(k, r)
        vals, idx = lax.top_k(exact, kk)
        slots = jnp.take_along_axis(rslot, idx, axis=1)
    else:
        kk = min(k, p * c)
        vals, idx = lax.top_k(flat, kk)
        if metric == "cosine":
            vals = jnp.minimum(vals, 1.0)
        vals = jnp.where(vals > -1e8, vals, -jnp.inf)
        slots = jnp.take_along_axis(gslot, idx, axis=1)
    if kk < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
        slots = jnp.pad(slots, ((0, 0), (0, k - kk)))
    return vals, slots


def make_factor(scales: jax.Array, norms: jax.Array,
                valid: jax.Array, metric: str = "cosine") -> jax.Array:
    """[L, C] dequant scales + norms + valid -> [L, C] masked factor plane
    for the quantized probes: scale/|v| for cosine, scale for dot."""
    if metric == "cosine":
        f = scales / jnp.maximum(norms, 1e-12)
    else:
        f = scales
    return jnp.where(valid, f, 0.0).astype(jnp.float32)
