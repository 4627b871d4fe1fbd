"""BinaryDeviceIndex — two-stage search: packed-bit pre-scan + exact rescore.

Device-native rebuild of the reference's binary quantization pipeline
(quantization.rs:86-193 `BinaryQuantizer::{quantize,hamming_distance,
multi_stage_search}`): vectors are threshold-binarized into packed uint32
bit-planes stored alongside the full-precision shard arrays. A query first runs
a pre-scan over the packed planes (32x less memory traffic than the float scan),
takes the best ``rescore_k`` candidates, then rescores exactly with a batched
gather + dot-product and returns the true top-k. The default pre-scan is
ASYMMETRIC — dot(q_unit, sign(x)), the same matmul as the Hamming form but
with the real-valued query — because the rescore gather is a per-row cost, so
a better prescan is the recall lever that doesn't cost QPS.
``prescan="hamming"`` restores the reference's symmetric XOR/popcount
ranking.

The reference measured Recall@5 = 17% for Hamming-only search
(docs/week5-6-binary-quantization.md:62); with rescoring this index holds
recall near 1.0.

Economics note: a full bf16 matmul scan is cheap on an accelerator, so binary
quantization is a *memory capacity* play — 32x more corpus per device when
full vectors are evicted — not a latency play. The same holds for PQ
(index/pq.py). For device-resident corpora prefer kind="flat".
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grape_vector_db_tpu.index.base import SearchHit
from grape_vector_db_tpu.index.flat import FlatDeviceIndex, _scatter_set
from grape_vector_db_tpu.errors import DimensionMismatchError
from grape_vector_db_tpu.ops.distance import prepare_queries, rowwise_dots
from grape_vector_db_tpu.ops.hamming import (asym_topk, hamming_topk,
                                             pack_bits, words_per_vector)
from grape_vector_db_tpu.utils.buckets import next_bucket, pad_rows
from grape_vector_db_tpu.utils.fetch import fetch_scores_slots

__all__ = ["BinaryDeviceIndex"]

_INVALID_DIST = 2**30


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("threshold",))
def _scatter_codes(codes, slots, new_vecs, threshold: float):
    new_codes = pack_bits(new_vecs, threshold)
    return codes.at[slots].set(new_codes, mode="drop")


@functools.partial(jax.jit, static_argnames=("new_cap",))
def _grow_codes(codes, new_cap: int):
    return jnp.pad(codes, ((0, new_cap - codes.shape[0]), (0, 0)))


@functools.partial(jax.jit, donate_argnums=(0,))
def _valid_set(valid, slots):
    return valid.at[slots].set(True, mode="drop")


@functools.partial(jax.jit, static_argnames=("new_cap",))
def _grow_valid(valid, new_cap: int):
    return jnp.pad(valid, (0, new_cap - valid.shape[0]))


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _rescore_topk(queries, vectors, norms, cand_idx, cand_dist, k: int, metric: str):
    """Gather candidates and rescore exactly.

    queries [B, D] f32, cand_idx [B, R] int32, cand_dist [B, R] int32 (Hamming,
    _INVALID_DIST for padding). Returns (scores [B, k], original indices [B, k]).
    """
    q = prepare_queries(queries, metric)
    cvecs = vectors[cand_idx]   # [B, R, D]
    cnorms = norms[cand_idx]    # [B, R]
    dots = rowwise_dots(q, cvecs)
    if metric == "cosine":
        scores = jnp.minimum(dots / jnp.maximum(cnorms, 1e-12), 1.0)
    elif metric == "dot":
        scores = dots
    else:  # euclidean
        q_sq = jnp.sum(q * q, axis=-1, keepdims=True)
        scores = -(q_sq - 2.0 * dots + cnorms * cnorms)
    scores = jnp.where(cand_dist < _INVALID_DIST, scores, -jnp.inf)
    kk = min(k, scores.shape[1])
    vals, pos = jax.lax.top_k(scores, kk)
    idx = jnp.take_along_axis(cand_idx, pos, axis=1)
    return vals, idx


class BinaryDeviceIndex(FlatDeviceIndex):
    """Two-stage binary-quantized index (drop-in VectorIndex)."""

    kind = "binary"

    def __init__(
        self,
        dimension: int,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        initial_capacity: int = 4096,
        growth_factor: int = 2,
        threshold: float = 0.0,
        rescore_ratio: float = 0.1,
        max_rescore: int = 4096,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        keep_vectors: bool = True,
        hamming_impl: str = "mxu",
        prescan: str = "asym",
        device: Optional[jax.Device] = None,
    ):
        # keep_vectors=False is the CAPACITY config the reference's
        # BinaryVectorStore promises (quantization.rs:286-354): only the
        # packed codes stay in HBM (32x compression — ~100 B/row at 768-d
        # incl. validity), ranking is Hamming similarity (1 - d/D), and
        # get_vector/get_all reconstruct unit-norm sign vectors. Recall is
        # the reference's Hamming-only table (its measured Recall@5 = 17%
        # on random data; far higher on separated clusters) — the price of
        # 32x. The default two-stage config keeps full vectors and exact
        # rescoring.
        self.keep_vectors = bool(keep_vectors)
        self.threshold = float(threshold)
        self.rescore_ratio = float(rescore_ratio)
        self.max_rescore = int(max_rescore)
        # Default scan is the sign-bit matmul (ops/hamming.py), which runs
        # on the matrix units; hamming_impl selects the A/B path: "mxu" |
        # "popcount" (the XOR + popcount reference, also spelled "xla").
        self.hamming_impl = ("xla" if hamming_impl == "popcount"
                             else hamming_impl)
        # prescan="asym" (default): rank stage-1 candidates by
        # dot(q_unit, sign(x)) — the same matmul as the Hamming scan but
        # with the real-valued query (ops/hamming.py asym_topk). The rescore
        # gather is a per-row cost, so a better prescan is the recall lever
        # that doesn't cost QPS. prescan="hamming" keeps the
        # reference's symmetric ranking (quantization.rs:151-193).
        if prescan not in ("asym", "hamming"):
            raise ValueError(f"prescan must be 'asym' or 'hamming', got {prescan!r}")
        self.prescan = prescan
        self._words = words_per_vector(dimension)
        super().__init__(
            dimension, metric=metric, storage_dtype=storage_dtype,
            initial_capacity=initial_capacity, growth_factor=growth_factor,
            search_mode=search_mode, recall_target=recall_target,
            device=device,
        )

    # -- storage hooks ---------------------------------------------------------

    def _alloc(self, capacity: int) -> None:
        if self.keep_vectors:
            super()._alloc(capacity)
            return
        self.vectors = None
        self.norms = None
        self.valid = self._put(jnp.zeros((capacity,), dtype=jnp.bool_))
        self.capacity = capacity
        self._alloc_extra(capacity)

    def _ensure_capacity(self, needed: int) -> None:
        if self.keep_vectors:
            super()._ensure_capacity(needed)
            return
        if needed <= self.capacity:
            return
        new_cap = next_bucket(needed, base=self._initial_capacity,
                              factor=self._growth_factor)
        self.valid = _grow_valid(self.valid, new_cap=new_cap)
        self._grow_extra(new_cap)
        self._slot_to_id.extend([None] * (new_cap - self.capacity))
        self.capacity = new_cap

    def _alloc_extra(self, capacity: int) -> None:
        self.codes = self._put(jnp.zeros((capacity, self._words), dtype=jnp.uint32))

    def _grow_extra(self, new_cap: int) -> None:
        self.codes = _grow_codes(self.codes, new_cap=new_cap)

    def _write(self, slots, vecs, norms) -> None:
        if self.keep_vectors:
            self.vectors, self.norms, self.valid = _scatter_set(
                self.vectors, self.norms, self.valid, slots, vecs, norms
            )
        else:
            self.valid = _valid_set(self.valid, slots)
        self.codes = _scatter_codes(self.codes, slots, vecs, threshold=self.threshold)

    # -- search ------------------------------------------------------------------

    def _scan_chunk(self) -> int:
        """Hamming-scan chunking: one full-axis selection instead of
        per-chunk selections plus a merge; cap the single block at 256k rows
        so the sign-decode transient stays bounded."""
        return min(self.capacity, 262_144)

    def _rescore_count(self, k: int) -> int:
        n = len(self)
        want = max(k, int(self.rescore_ratio * n))
        want = min(want, self.max_rescore, max(self.capacity, 1))
        return next_bucket(max(want, k), base=64)

    def raw_topk(self, queries: np.ndarray, k: int,
                 mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:  # updates donate buffers; see FlatDeviceIndex.raw_topk
            r = self._rescore_count(k)
            q = jnp.asarray(queries)
            chunk = self._scan_chunk()
            # Filter mask folds into the PRE-scan validity, so both stages
            # only ever consider allowed rows (two-stage filtered search;
            # quantization.rs:151-193 had no filter support at all).
            valid = self.valid if mask is None else jnp.logical_and(
                self.valid, jnp.asarray(mask))
            if not self.keep_vectors:
                # capacity config: the prescan ranking IS the result
                if self.prescan == "asym":
                    vals, idxs = asym_topk(q.astype(jnp.float32), self.codes,
                                           valid, k=k, chunk=chunk)
                    # similarity = cosine against the decoded sign vector
                    v_np, i_np = fetch_scores_slots(
                        vals / jnp.sqrt(jnp.float32(self._dim)), idxs)
                    return np.where(np.isfinite(v_np), v_np, -np.inf), i_np
                qcodes = pack_bits(q.astype(jnp.float32), self.threshold)
                dists, idxs = hamming_topk(qcodes, self.codes, valid, k=k,
                                           chunk=chunk, impl=self.hamming_impl)
                # one packed readback; distances are exact in f32 (<= dim,
                # and the 2^30 invalid sentinel is a power of two)
                d_np, i_np = fetch_scores_slots(dists, idxs)
                sims = 1.0 - d_np / float(self._dim)
                sims = np.where(d_np >= _INVALID_DIST, -np.inf, sims)
                return sims, i_np
            if self.prescan == "asym":
                pv, cand = asym_topk(q.astype(jnp.float32), self.codes,
                                     valid, k=r, chunk=chunk)
                # _rescore_topk's validity channel is the int32 Hamming
                # plane; synthesize it from the -inf padding sentinel
                dists = jnp.where(jnp.isfinite(pv), 0, _INVALID_DIST
                                  ).astype(jnp.int32)
            else:
                qcodes = pack_bits(q.astype(jnp.float32), self.threshold)
                dists, cand = hamming_topk(qcodes, self.codes, valid, k=r,
                                           chunk=chunk, impl=self.hamming_impl)
            vals, idxs = _rescore_topk(
                q, self.vectors, self.norms, cand, dists, k=k, metric=self.metric
            )
            return fetch_scores_slots(vals, idxs)

    # -- maintenance ------------------------------------------------------------

    def tune_rescore(self, queries: Optional[np.ndarray] = None, k: int = 10,
                     target_recall: float = 0.95,
                     max_budget: int = 8192) -> int:
        """Pick (and set) the smallest rescore budget whose recall@k on a
        validation query set meets ``target_recall``, measured against this
        index's own exact full-precision scan as the oracle. The binary
        analog of ``IvfDeviceIndex.tune_nprobe`` (the knob the reference's
        multi_stage_search hardcoded, quantization.rs:151-193).

        The rescore gather is a per-row cost, so recall@k is a monotone
        function of the
        budget and QPS is ~inverse in it — the sweep finds the cheapest
        point on that curve for THIS corpus and query distribution instead
        of shipping ``max_rescore=4096`` everywhere. ``queries`` defaults to
        a sample of the indexed vectors (the self-recall protocol). Each
        candidate budget is a separate jit variant; candidates grow
        geometrically so the sweep compiles O(log max_budget) kernels.

        Only meaningful in the two-stage config; the codes-only capacity
        config (``keep_vectors=False``) has no rescore stage."""
        if not self.keep_vectors:
            raise ValueError("tune_rescore needs the two-stage config "
                             "(keep_vectors=True); the codes-only capacity "
                             "config has no rescore stage")
        with self._lock:
            if not self._id_to_slot:
                return self.max_rescore
            if queries is None:
                slots = np.asarray(
                    [s for s in list(self._id_to_slot.values())[:256]],
                    dtype=np.int64)
                queries = np.asarray(
                    self.vectors[jnp.asarray(slots)]).astype(np.float32)
        queries = np.asarray(queries, dtype=np.float32)
        if queries.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, queries.shape[1])
        b = queries.shape[0]
        qp = pad_rows(queries, next_bucket(b, base=8))
        # Oracle: the exact full-precision scan over ALL rows (stage-2 math,
        # stage-1 bypassed) — what a budget of n would return.
        o_vals, o_slots = FlatDeviceIndex.raw_topk(self, qp, k)
        oracle = [frozenset(int(s) for v, s in zip(vr, sr) if np.isfinite(v))
                  for vr, sr in zip(o_vals[:b], o_slots[:b])]
        denom = sum(len(w) for w in oracle) or 1
        limit = min(int(max_budget), self.capacity)
        saved = (self.rescore_ratio, self.max_rescore)
        chosen: Optional[int] = None
        try:
            cand = next_bucket(max(64, k), base=64)
            while True:
                self.rescore_ratio = 1.0
                self.max_rescore = cand
                vals, slots = self.raw_topk(qp, k)
                hits = sum(
                    len({int(s) for v, s in zip(vr, sr) if np.isfinite(v)}
                        & want)
                    for vr, sr, want in zip(vals[:b], slots[:b], oracle))
                if hits / denom >= target_recall or cand >= limit:
                    chosen = cand
                    return cand
                cand = min(cand * 2, limit)
        finally:
            if chosen is None:
                self.rescore_ratio, self.max_rescore = saved
            else:
                n = len(self._id_to_slot) or 1
                self.rescore_ratio = min(1.0, chosen / n)
                self.max_rescore = chosen

    def hamming_only_topk(self, queries: np.ndarray, k: int) -> List[List[SearchHit]]:
        """Stage-1-only search (similarity = 1 - d/dim, quantization.rs:144-148).
        Exposed for parity with the reference's pure-Hamming mode and for the
        recall benchmarks that reproduce its 17% Recall@5 table."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, queries.shape[1])
        b = queries.shape[0]
        if b == 0 or not self._id_to_slot:
            return [[] for _ in range(b)]
        bb = next_bucket(b, base=8)
        with self._lock:
            qcodes = pack_bits(jnp.asarray(pad_rows(queries, bb)), self.threshold)
            chunk = self._scan_chunk()
            dists, idxs = hamming_topk(qcodes, self.codes, self.valid, k=k,
                                       chunk=chunk, impl=self.hamming_impl)
            dists, idxs = fetch_scores_slots(dists, idxs)
            dists, idxs = dists[:b], idxs[:b]
        sims = 1.0 - dists.astype(np.float64) / float(self._dim)
        sims = np.where(dists >= _INVALID_DIST, -np.inf, sims)
        return self.hits_from_slots(sims, idxs)

    # -- introspection (capacity config reconstructs sign vectors) -------------

    def _decode_signs(self, slots: np.ndarray) -> np.ndarray:
        codes = np.asarray(self.codes)[slots]              # [M, W]
        bits = (codes[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
        signs = (2.0 * bits.astype(np.float32) - 1.0).reshape(len(slots), -1)
        return signs[:, :self._dim] / np.sqrt(self._dim)

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        if self.keep_vectors:
            return super().get_vector(id_)
        slot = self._id_to_slot.get(id_)
        if slot is None:
            return None
        return self._decode_signs(np.asarray([slot]))[0]

    def get_all(self):
        if self.keep_vectors:
            return super().get_all()
        with self._lock:
            items = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
            if not items:
                return [], np.zeros((0, self._dim), dtype=np.float32)
            ids = [i for i, _ in items]
            slots = np.asarray([s for _, s in items], dtype=np.int64)
            return ids, self._decode_signs(slots)

    def get_stats(self):
        if self.keep_vectors:
            stats = super().get_stats()
        else:
            from grape_vector_db_tpu.index.base import IndexStats

            stats = IndexStats(
                point_count=len(self._id_to_slot), dimension=self._dim,
                capacity=self.capacity,
                memory_usage_mb=self.capacity * (self._words * 4 + 1) / 1e6,
            )
        stats.kind = self.kind
        stats.extra["packed_mb"] = self.capacity * self._words * 4 / 1e6
        stats.extra["keep_vectors"] = float(self.keep_vectors)
        stats.extra["rescore_k"] = float(self._rescore_count(10))
        stats.extra["prescan_asym"] = float(self.prescan == "asym")
        return stats
