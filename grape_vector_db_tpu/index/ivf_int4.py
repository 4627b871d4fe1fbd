"""Int4IvfDeviceIndex — IVF partitioning over packed-int4-resident lists.

The next rung of the bandwidth/capacity ladder above `index/ivf_int8.py`:
packed nibbles store 0.5 byte/dim (384 B/row at D=768 — a QUARTER of bf16,
half of int8), so the probe (ops/ivf_pallas.py on a GPU) reads half the
int8 probe's bytes per list and a device holds ~2x more rows than the int8
capacity config (~4x bf16).

Two configurations (mirroring ivf_int8):

- **bandwidth** (``keep_bf16=True``, default): int4 codes + bf16 shadow.
  The probe scores packed nibbles, then the top ``rescore`` candidates are
  exactly rescored against bf16 rows (the reference's two-stage shape,
  quantization.rs:151-193) — near-exact ranking at the fastest probe.
- **capacity** (``keep_bf16=False``): int4 codes only — ~4x rows/chip vs
  bf16. Scores are asymmetric bf16-query x dequantized-nibble dots; 4-bit
  rank noise is the recall price (measure before choosing this tier).

Packing is split-plane (ops/int4.py): byte j of a row holds dim j (low
nibble) and dim j + D/2 (high nibble), so the kernel unpacks with two
elementwise ops and dots each half against the matching query half.

Reference parity: extends FaissIndexType::IvfFlat with a quantized tier the
reference never had (its IVF linear-scanned anyway, index.rs:620-640).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from grape_vector_db_tpu.index.ivf_int8 import Int8IvfDeviceIndex
from grape_vector_db_tpu.ops.distance import prepare_queries, rowwise_dots
from grape_vector_db_tpu.ops.int4 import quantize_int4, unpack_int4
from grape_vector_db_tpu.ops.ivf_probe import finalize_probe_topk, probe_lists

__all__ = ["Int4IvfDeviceIndex"]


@functools.partial(jax.jit, donate_argnums=(0, 1, 2),
                   static_argnames=("metric",))
def _int4_cell_scatter(codes, scales, factor, lists, pos, new_vecs, new_norms,
                       metric: str):
    """Quantize rows (per-row symmetric int4, ops/int4.py split-plane
    packing) and scatter packed codes + scale + factor planes at
    (list, pos)."""
    vi, s = quantize_int4(new_vecs)
    codes = codes.at[lists, pos].set(vi, mode="drop")
    scales = scales.at[lists, pos].set(s, mode="drop")
    if metric == "cosine":
        f = s / jnp.maximum(new_norms, 1e-12)
    else:
        f = s
    factor = factor.at[lists, pos].set(f, mode="drop")
    return codes, scales, factor


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "metric",
                                             "rescore"))
def _ivf_int4_topk(
    queries,     # [B, D] f32 raw
    centroids,   # [L, D] f32
    codes,       # [L, C, D/2] int8 packed nibbles
    factor,      # [L, C] f32 masked scale/norm (0 = invalid)
    vecs,        # [L, C, D] bf16 shadow or None (capacity config)
    norms,       # [L, C] f32 (rescore) or None
    cell_mask,   # [L, C] bool or None
    k: int,
    nprobe: int,
    metric: str,
    rescore: int,
):
    """XLA probe: same contract as ops/ivf_pallas.kernel_ivf_topk with
    fmt="int4"."""
    q = prepare_queries(queries, metric)
    probe = probe_lists(q, centroids, nprobe, metric)           # [B, P]

    f = factor[probe]                                           # [B, P, C]
    dots = rowwise_dots(q, unpack_int4(codes[probe]),
                        q_dtype=jnp.bfloat16)                   # [B, P, C]
    scores = dots * f + jnp.where(f == 0.0, -1e9, 0.0)

    def weight(rl, rp):
        # norms are NOT zeroed on delete; fold current validity explicitly
        # so the rescore guard (w > 0) drops cells deleted since scatter.
        cn = norms[rl, rp]
        live = factor[rl, rp] > 0
        if metric == "cosine":
            w = 1.0 / jnp.maximum(cn, 1e-12)
        else:
            w = jnp.ones_like(cn)
        return jnp.where(live & (cn > 0), w, 0.0)

    return finalize_probe_topk(
        q, probe, scores, k, metric, cell_mask=cell_mask,
        rescore=rescore, vecs=vecs,
        weight_fn=None if vecs is None else weight,
    )


class Int4IvfDeviceIndex(Int8IvfDeviceIndex):
    kind = "ivf_int4"
    codes_fmt = "int4"
    _xla_topk = staticmethod(_ivf_int4_topk)

    # -- storage seams --------------------------------------------------------

    def _alloc_codes(self, cap: int) -> None:
        if self._dim % 2:
            raise ValueError(f"ivf_int4 needs an even dim, got {self._dim}")
        # int8-typed (bit pattern of the unsigned packed nibbles): a uint8
        # corpus would force a materialized bitcast copy inside every probe
        # dispatch (ops/int4.py module docstring).
        self.codes = jnp.zeros((self.nlist, cap, self._dim // 2),
                               dtype=jnp.int8)

    def _scatter_codes(self, lists_p, pos_p, vecs_p, norms_p) -> None:
        self.codes, self.scales, self.factor = _int4_cell_scatter(
            self.codes, self.scales, self.factor, lists_p, pos_p, vecs_p,
            norms_p, metric=self.metric)

    def _host_rows(self) -> np.ndarray:
        if self.keep_bf16:
            return super(Int8IvfDeviceIndex, self)._host_rows()
        lev = np.asarray(unpack_int4(self.codes), dtype=np.float32)
        return lev * np.asarray(self.scales)[:, :, None]

    def _host_row(self, lst: int, pos: int) -> np.ndarray:
        if self.keep_bf16:
            return super(Int8IvfDeviceIndex, self)._host_row(lst, pos)
        lev = np.asarray(unpack_int4(self.codes[lst, pos]), dtype=np.float32)
        return lev * float(self.scales[lst, pos])

    # -- search ----------------------------------------------------------------

    # -- introspection -----------------------------------------------------------

    def get_stats(self):
        stats = super().get_stats()
        stats.kind = self.kind
        per_row = self._dim // 2 + 4 * 3  # packed + scale/norm + factor
        if self.keep_bf16:
            per_row += self.storage_dtype.itemsize * self._dim
        stats.memory_usage_mb = self.nlist * self.list_cap * per_row / 1e6
        return stats
