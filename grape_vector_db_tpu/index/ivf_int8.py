"""Int8IvfDeviceIndex — IVF partitioning over int8-resident lists.

The bandwidth AND capacity play combined: the probe reads each probed list
in place (ops/ivf_pallas.py on a GPU), and int8 codes halve the bytes per
list vs bf16 — the probe moves half the bytes AND the corpus fits ~2x more
rows per device (768 B/row at D=768 vs 1536 B bf16).

Two configurations (config.index.ivf_int8_keep_bf16):

- **bandwidth** (default): int8 codes + bf16 shadow. The probe scores int8,
  then the top ``rescore`` candidates are exactly rescored against the bf16
  rows (the reference's two-stage shape, quantization.rs:151-193). Memory is
  1.5x a bf16 IVF; ranking is near-exact (int8 cosine correlates ~0.9999
  with f32 on 768-d data).
- **capacity**: int8 codes only — ~2x rows/chip. Scores are asymmetric
  bf16-query x dequantized-int8-corpus dots; no exact rescore. get_vector /
  get_all / optimize() reconstruct rows by dequantizing codes.

Scoring is asymmetric (only the corpus side is quantized), which loses less
precision than symmetric int8 x int8.

Reference parity: completes FaissIndexType::IvfFlat with a quantized variant
the reference never had (its IVF linear-scanned anyway, index.rs:620-640).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grape_vector_db_tpu.index.ivf import IvfDeviceIndex
from grape_vector_db_tpu.ops.distance import prepare_queries, rowwise_dots
from grape_vector_db_tpu.ops.int8 import quantize_int8
from grape_vector_db_tpu.ops.ivf_probe import finalize_probe_topk, probe_lists
from grape_vector_db_tpu.utils.buckets import next_bucket

__all__ = ["Int8IvfDeviceIndex"]


@functools.partial(jax.jit, donate_argnums=(0, 1, 2),
                   static_argnames=("metric",))
def _int8_cell_scatter(codes, scales, factor, lists, pos, new_vecs, new_norms,
                       metric: str):
    """Quantize rows (per-row symmetric int8, ops/int8.py scheme) and scatter
    codes + scale + factor planes at (list, pos)."""
    vi, s = quantize_int8(new_vecs)
    codes = codes.at[lists, pos].set(vi, mode="drop")
    scales = scales.at[lists, pos].set(s, mode="drop")
    if metric == "cosine":
        f = s / jnp.maximum(new_norms, 1e-12)
    else:
        f = s
    factor = factor.at[lists, pos].set(f, mode="drop")
    return codes, scales, factor


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _nv_scatter(norms, valid, lists, pos, new_norms):
    norms = norms.at[lists, pos].set(new_norms, mode="drop")
    valid = valid.at[lists, pos].set(True, mode="drop")
    return norms, valid


@functools.partial(jax.jit, donate_argnums=(0,))
def _factor_invalidate(factor, lists, pos):
    return factor.at[lists, pos].set(0.0, mode="drop")


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "metric",
                                             "rescore"))
def _ivf_int8_topk(
    queries,     # [B, D] f32 raw
    centroids,   # [L, D] f32
    codes,       # [L, C, D] int8
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
    fmt="int8"."""
    q = prepare_queries(queries, metric)
    probe = probe_lists(q, centroids, nprobe, metric)           # [B, P]

    f = factor[probe]                                           # [B, P, C]
    dots = rowwise_dots(q, codes[probe])                        # [B, P, C]
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


class Int8IvfDeviceIndex(IvfDeviceIndex):
    kind = "ivf_int8"
    codes_fmt = "int8"   # the probe kernel's code format
    _xla_topk = staticmethod(_ivf_int8_topk)

    def __init__(self, *args, rescore: int = 64, keep_bf16: bool = True,
                 **kwargs):
        if kwargs.get("metric", "cosine") == "euclidean":
            raise ValueError("ivf_int8 supports cosine/dot metrics")
        self.rescore = int(rescore)
        self.keep_bf16 = bool(keep_bf16)
        super().__init__(*args, **kwargs)

    # -- storage seams --------------------------------------------------------

    def _alloc(self, cap: int) -> None:
        l, d = self.nlist, self._dim
        if self.keep_bf16:
            super()._alloc(cap)
        else:
            self.vecs = None
            self.norms = jnp.zeros((l, cap), dtype=jnp.float32)
            self.valid = jnp.zeros((l, cap), dtype=jnp.bool_)
            self.recip = None
        self._alloc_codes(cap)
        self.scales = jnp.zeros((l, cap), dtype=jnp.float32)
        self.factor = jnp.zeros((l, cap), dtype=jnp.float32)

    def _alloc_codes(self, cap: int) -> None:
        self.codes = jnp.zeros((self.nlist, cap, self._dim), dtype=jnp.int8)

    def _scatter_rows(self, lists_p, pos_p, vecs_p, norms_p) -> None:
        if self.keep_bf16:
            super()._scatter_rows(lists_p, pos_p, vecs_p, norms_p)
        else:
            self.norms, self.valid = _nv_scatter(
                self.norms, self.valid, lists_p, pos_p, norms_p)
        self._scatter_codes(lists_p, pos_p, vecs_p, norms_p)

    def _scatter_codes(self, lists_p, pos_p, vecs_p, norms_p) -> None:
        self.codes, self.scales, self.factor = _int8_cell_scatter(
            self.codes, self.scales, self.factor, lists_p, pos_p, vecs_p,
            norms_p, metric=self.metric)

    def _invalidate_cells(self, lists_p, pos_p) -> None:
        super()._invalidate_cells(lists_p, pos_p)
        self.factor = _factor_invalidate(self.factor, lists_p, pos_p)

    def _host_rows(self) -> np.ndarray:
        if self.keep_bf16:
            return super()._host_rows()
        return (np.asarray(self.codes, dtype=np.float32)
                * np.asarray(self.scales)[:, :, None])

    def _host_row(self, lst: int, pos: int) -> np.ndarray:
        if self.keep_bf16:
            return super()._host_row(lst, pos)
        return (np.asarray(self.codes[lst, pos], dtype=np.float32)
                * float(self.scales[lst, pos]))

    # -- search ----------------------------------------------------------------

    def _rescore_count(self, k: int) -> int:
        if not self.keep_bf16:
            return 0
        return next_bucket(max(self.rescore, k), base=64)

    def _scan_planes(self):
        return self.codes, self.factor, self.codes_fmt

    def _main_topk(self, qp: np.ndarray, k: int, mask, nprobe=None):
        nprobe = min(nprobe or self.nprobe, self.nlist)
        cm = None if mask is None else jnp.asarray(mask[0])
        r = self._rescore_count(k)
        if self._use_kernel:
            from grape_vector_db_tpu.ops.ivf_pallas import kernel_ivf_topk

            return kernel_ivf_topk(
                jnp.asarray(qp), self.centroids, self.codes, self.factor,
                k=k, nprobe=nprobe, metric=self.metric, fmt=self.codes_fmt,
                rescore=r, vecs=self.vecs if r else None,
                recip=self.recip if r else None,
                fill=self._list_fill(), cell_mask=cm,
            )
        return self._xla_topk(
            jnp.asarray(qp), self.centroids, self.codes, self.factor,
            self.vecs if r else None, self.norms if r else None, cm,
            k=k, nprobe=nprobe, metric=self.metric, rescore=r,
        )

    # -- introspection -----------------------------------------------------------

    def get_stats(self):
        stats = super().get_stats()
        stats.kind = self.kind
        per_row = self._dim + 4 * 3  # codes + scale/norm + factor
        if self.keep_bf16:
            per_row += self.storage_dtype.itemsize * self._dim
        stats.memory_usage_mb = self.nlist * self.list_cap * per_row / 1e6
        stats.extra["keep_bf16"] = float(self.keep_bf16)
        stats.extra["rescore_k"] = float(self._rescore_count(10))
        return stats
