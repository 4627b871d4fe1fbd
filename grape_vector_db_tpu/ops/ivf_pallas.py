"""IVF probe kernel (Pallas, ``backend="triton"``) — score each query's probed
lists straight from the bucketed layout.

The XLA probe (``index/ivf._ivf_topk``) gathers ``vecs[probe]`` into a
``[B, P, C, D]`` array before the product: at B = 128, nprobe = 16, C = 512,
D = 768 in bf16 that is 1.6 GB written and read again per batch unless XLA
fuses the gather into the dot. Here one program scores one (query, probe
slot) cell: it reads its own list id and the list's fill (high-water mark),
walks the list in ``rb``-row blocks only up to the fill, dequantizes int8 and
int4 codes in registers, and writes the ``[B, P, C]`` score contract that
``ops/ivf_probe.finalize_probe_topk`` consumes. Rows past the fill are never
read; their scores are the invalid sentinel.

Code formats (a static argument):

- ``bf16``: ``[L, C, D]`` float rows (bf16, or f32 storage);
- ``int8``: ``[L, C, D]`` per-row symmetric codes (ops/int8.py);
- ``int4``: ``[L, C, D/2]`` split-plane packed nibbles (ops/int4.py): byte
  ``j`` holds dim ``j`` (low nibble) and dim ``j + D/2`` (high nibble).

Each score is ``dot(q, row) * w`` with ``w`` the ``[L, C]`` weight plane
(1/|v| for cosine, the dequant scale folded in for codes; 0 = invalid ->
-1e9). The query is rounded to the rows' float type (bf16 for codes) first,
as the XLA probes do.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from grape_vector_db_tpu.ops.distance import prepare_queries
from grape_vector_db_tpu.ops.ivf_probe import (FORMATS, finalize_probe_topk,
                                               probe_lists)

__all__ = ["ivf_probe_scores", "kernel_ivf_topk"]

INVALID = -1e9

# Launch parameters of the compiled kernel: the fastest of five variants
# timed on an H100 at nlist 2048 x 512 x 768, B = 128, nprobe = 16.
_LAUNCH = {"rb": 64, "bk": 256, "num_warps": 8, "num_stages": 2}


def _pow2_divisor(n: int, cap: int) -> int:
    t = cap
    while n % t:
        t //= 2
    return t


def _probe_tiles(c: int, row_width: int) -> Tuple[int, int]:
    """(rows per block, columns per contraction step) for a list capacity
    ``c`` and a stored row width: the largest powers of two, up to the
    launch sizes, that divide them (Triton tiles are powers of two and the
    kernel never slices past a list or a row)."""
    return (_pow2_divisor(c, _LAUNCH["rb"]),
            _pow2_divisor(row_width, _LAUNCH["bk"]))


def _probe_kernel(probe_ref, fill_ref, q_ref, x_ref, w_ref, o_ref, *,
                  fmt: str, p: int, c: int, d: int, rb: int, bk: int):
    pi = pl.program_id(0)
    bi = pl.program_id(1)
    cell = bi * p + pi
    lst = probe_ref[cell]
    nfill = jnp.minimum(fill_ref[lst], c)
    nb = (nfill + rb - 1) // rb
    row0 = lst * c
    out0 = cell * c
    q0 = bi * d
    width = x_ref.shape[1]
    rows = jnp.arange(rb, dtype=jnp.int32)

    def block(i, carry):
        r0 = pl.multiple_of(i * rb, rb)
        live = (r0 + rows) < nfill

        def k_step(kc, acc):
            k0 = pl.multiple_of(kc * bk, bk)
            x = plgpu.load(x_ref.at[pl.ds(row0 + r0, rb), pl.ds(k0, bk)],
                           mask=live[:, None], other=0)
            if fmt == "int4":
                xi = x.astype(jnp.int32)
                lo = jnp.bitwise_and(xi, 0xF).astype(jnp.float32) - 8.0
                hi = (jnp.bitwise_and(jnp.right_shift(xi, 4), 0xF)
                      .astype(jnp.float32) - 8.0)
                qlo = q_ref[pl.ds(q0 + k0, bk)].astype(jnp.float32)
                qhi = q_ref[pl.ds(q0 + width + k0, bk)].astype(jnp.float32)
                part = lo * qlo[None, :] + hi * qhi[None, :]
            else:
                qk = q_ref[pl.ds(q0 + k0, bk)].astype(jnp.float32)
                part = x.astype(jnp.float32) * qk[None, :]
            return acc + jnp.sum(part, axis=1)

        acc = lax.fori_loop(0, width // bk, k_step,
                            jnp.zeros((rb,), jnp.float32))
        w = plgpu.load(w_ref.at[pl.ds(row0 + r0, rb)], mask=live, other=0.0)
        o_ref[pl.ds(out0 + r0, rb)] = jnp.where(w == 0.0, INVALID, acc * w)
        return carry

    def pad(i, carry):
        o_ref[pl.ds(out0 + pl.multiple_of(i * rb, rb), rb)] = jnp.full(
            (rb,), INVALID, jnp.float32)
        return carry

    lax.fori_loop(0, nb, block, 0)
    lax.fori_loop(nb, c // rb, pad, 0)


@functools.partial(jax.jit, static_argnames=("fmt", "interpret"))
def ivf_probe_scores(
    q: jax.Array,       # [B, D] f32 prepared (L2-normalized for cosine)
    probe: jax.Array,   # [B, P] int32 list ids
    data: jax.Array,    # [L, C, D] bf16/int8, or [L, C, D/2] packed int4
    w: jax.Array,       # [L, C] f32 weight plane (0 = invalid)
    fill: jax.Array | None = None,  # [L] int32 rows in use per list
    fmt: str = "bf16",
    interpret: bool = False,
) -> jax.Array:
    """Returns [B, P, C] f32 scores; invalid or unfilled cells score -1e9."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown probe format {fmt!r}")
    b, d = q.shape
    p = probe.shape[1]
    l, c, width = data.shape
    if width != (d // 2 if fmt == "int4" else d):
        raise ValueError(f"row width {width} does not match dim {d} ({fmt})")
    if fill is None:
        fill = jnp.full((l,), c, jnp.int32)
    elif fill.shape != (l,):
        raise ValueError(f"fill shape {fill.shape} != ({l},)")
    rb, bk = _probe_tiles(c, width)
    # the query meets float rows in their own dtype, codes as bf16 (what
    # the XLA probes compute)
    qdt = data.dtype if fmt == "bf16" else jnp.bfloat16
    out = pl.pallas_call(
        functools.partial(_probe_kernel, fmt=fmt, p=p, c=c, d=d, rb=rb,
                          bk=bk),
        out_shape=jax.ShapeDtypeStruct((b * p * c,), jnp.float32),
        grid=(p, b),
        compiler_params=plgpu.CompilerParams(
            num_warps=_LAUNCH["num_warps"], num_stages=_LAUNCH["num_stages"]),
        interpret=interpret,
        name=f"ivf_probe_{fmt}",
    )(probe.reshape(b * p).astype(jnp.int32), fill.astype(jnp.int32),
      q.astype(qdt).reshape(b * d), data.reshape(l * c, width),
      w.reshape(l * c).astype(jnp.float32))
    return out.reshape(b, p, c)


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "metric", "fmt",
                                             "rescore", "interpret"))
def kernel_ivf_topk(
    queries: jax.Array,    # [B, D] f32 raw
    centroids: jax.Array,  # [L, D] f32 (unit-norm for cosine/dot)
    data: jax.Array,       # [L, C, D] or [L, C, D/2] (int4)
    w: jax.Array,          # [L, C] f32 weight plane (recip or factor)
    k: int,
    nprobe: int,
    metric: str = "cosine",
    fmt: str = "bf16",
    rescore: int = 0,
    vecs: jax.Array | None = None,   # [L, C, D] bf16 shadow (rescore > 0)
    recip: jax.Array | None = None,  # [L, C] f32 (rescore > 0)
    fill: jax.Array | None = None,   # [L] int32 rows in use per list
    cell_mask: jax.Array | None = None,  # [L, C] bool filter (True = allowed)
    interpret: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """(vals, slots) through the probe kernel — the ``_main_topk`` contract
    of every single-device IVF kind (cosine/dot). ``cell_mask`` folds a
    filter into the selection after the kernel (1 byte per scored cell).
    With ``rescore > 0`` and a bf16 shadow, the top ``rescore`` quantized
    candidates are exactly rescored (the reference's two-stage shape,
    quantization.rs:151-193)."""
    qp = prepare_queries(queries, metric)
    probe = probe_lists(qp, centroids, nprobe, metric)
    scores = ivf_probe_scores(qp, probe, data, w, fill=fill, fmt=fmt,
                              interpret=interpret)
    return finalize_probe_topk(
        qp, probe, scores, k, metric, cell_mask=cell_mask,
        rescore=rescore, vecs=vecs,
        weight_fn=None if vecs is None else (lambda rl, rp: recip[rl, rp]),
    )
