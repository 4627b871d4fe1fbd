"""IvfDeviceIndex — k-means partitioned search with per-query probing.

The reference's ``FaissVectorIndex`` trains k-means/PQ but then linear-scans
with cosine distance regardless of index type (index.rs:620-640). This is the
real thing, shaped for an accelerator:

- storage: ``[nlist, list_cap, D]`` bucketed device array — vectors grouped by
  nearest centroid so a probe is a contiguous gather, not pointer chasing;
- search: one ``[B, L]`` matmul scores queries against centroids, top-``nprobe``
  lists are gathered per query and scored in a single batched einsum, masked
  top-k maps winners back to global slots;
- overflow: lists are fixed-capacity; spill goes to a flat exactly-scanned
  region (the buffered "fresh partition" of SURVEY.md §7.1 step 3), folded in
  by a top-k merge. ``optimize()`` retrains centroids and repacks everything.

Trade-off vs the flat scan: compute drops from O(N) to O(nprobe * list_cap) per
query at the cost of recall < 1 when the true neighbor's list isn't probed.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from grape_vector_db_tpu.errors import DimensionMismatchError
from grape_vector_db_tpu.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu.index.flat import FlatDeviceIndex
from grape_vector_db_tpu.ops.distance import prepare_queries, rowwise_dots
from grape_vector_db_tpu.ops.ivf_probe import probe_lists, use_probe_kernel
from grape_vector_db_tpu.ops.kmeans import assign_clusters, kmeans
from grape_vector_db_tpu.ops.topk import merge_topk
from grape_vector_db_tpu.utils.buckets import PAD_SLOT, next_bucket, pad_rows
from grape_vector_db_tpu.utils.fetch import fetch_scores_slots

__all__ = ["IvfDeviceIndex"]


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _ivf_scatter(vecs, norms, valid, list_ids, positions, new_vecs, new_norms):
    """Scatter rows into [nlist, cap, ...] buckets at (list, pos)."""
    vecs = vecs.at[list_ids, positions].set(new_vecs.astype(vecs.dtype), mode="drop")
    norms = norms.at[list_ids, positions].set(new_norms, mode="drop")
    valid = valid.at[list_ids, positions].set(True, mode="drop")
    return vecs, norms, valid


@functools.partial(jax.jit, donate_argnums=(0,))
def _ivf_invalidate(valid, list_ids, positions):
    return valid.at[list_ids, positions].set(False, mode="drop")


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("metric",))
def _recip_scatter(recip, list_ids, positions, new_norms, metric: str):
    """Maintain the [L, C] score-weight plane: 1/|v| for cosine (the norm
    division), 1.0 for dot (raw dots pass through); 0 = invalid."""
    if metric == "cosine":
        vals = 1.0 / jnp.maximum(new_norms, 1e-12)
    else:
        vals = jnp.ones_like(new_norms)
    return recip.at[list_ids, positions].set(vals, mode="drop")


@functools.partial(jax.jit, donate_argnums=(0,))
def _recip_invalidate(recip, list_ids, positions):
    return recip.at[list_ids, positions].set(0.0, mode="drop")


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "metric"))
def _ivf_topk(
    queries,      # [B, D] f32 raw
    centroids,    # [L, D] f32
    vecs,         # [L, C, D] storage dtype
    norms,        # [L, C] f32
    valid,        # [L, C] bool
    k: int,
    nprobe: int,
    metric: str,
):
    """Probe top-nprobe lists per query, score gathered candidates, top-k.

    Returns (scores [B, k], global slots [B, k]) with slot = list * C + pos.
    """
    b, d = queries.shape
    l, c, _ = vecs.shape
    q = prepare_queries(queries, metric)

    # Stage 1: pick lists (full-precision centroid affinity).
    probe = probe_lists(q, centroids, nprobe, metric)               # [B, P]

    # Stage 2: gather probed lists and score.
    cand_vecs = vecs[probe]      # [B, P, C, D]
    cand_norms = norms[probe]    # [B, P, C]
    cand_valid = valid[probe]    # [B, P, C]
    dots = rowwise_dots(q, cand_vecs)                                # [B, P, C]
    if metric == "cosine":
        scores = jnp.minimum(dots / jnp.maximum(cand_norms, 1e-12), 1.0)
    elif metric == "dot":
        scores = dots
    else:
        q_sq = jnp.sum(q * q, axis=-1)[:, None, None]
        scores = -(q_sq - 2.0 * dots + cand_norms * cand_norms)
    scores = jnp.where(cand_valid, scores, -jnp.inf)

    p = probe.shape[1]
    flat_scores = scores.reshape(b, p * c)
    pos_in_list = jax.lax.broadcasted_iota(jnp.int32, (b, p, c), 2)
    gslot = (probe[:, :, None] * c + pos_in_list).reshape(b, p * c)
    kk = min(k, p * c)
    vals, idx = lax.top_k(flat_scores, kk)
    slots = jnp.take_along_axis(gslot, idx, axis=1)
    if kk < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
        slots = jnp.pad(slots, ((0, 0), (0, k - kk)))
    return vals, slots


class IvfDeviceIndex(VectorIndex):
    kind = "ivf"
    supports_mask = True
    # A probe visits nprobe lists; a mask folded into it is exact only over
    # those lists — allowed rows elsewhere are invisible, so recall
    # collapses at low selectivity. The planner routes around this there;
    # see ops/ivf_scan.py.
    mask_exact = False
    supports_exhaustive_mask = True

    def __init__(
        self,
        dimension: int,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        initial_capacity: int = 4096,
        growth_factor: int = 2,
        nlist: int = 64,
        nprobe: int = 8,
        train_size: int = 50_000,
        kmeans_iters: int = 10,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        device: Optional[jax.Device] = None,
    ):
        self._dim = dimension
        self.metric = metric
        if metric not in ("cosine", "dot"):
            # the exhaustive masked scan scores weighted dots only
            # (ops/ivf_scan.py); euclidean filters use the in-probe mask +
            # the planner's host full-precision tier instead
            self.supports_exhaustive_mask = False
        self.storage_dtype = jnp.dtype(storage_dtype)
        self.nlist = nlist
        self.nprobe = min(nprobe, nlist)
        self.train_size = train_size
        self.kmeans_iters = kmeans_iters
        self._lock = threading.RLock()
        # Probe kernel (ops/ivf_pallas.py) on a GPU for the angular
        # metrics; the XLA gather probe everywhere else.
        self._use_kernel = use_probe_kernel(metric)
        # list capacity starts small and doubles on overflow pressure
        self.list_cap = max(128, next_bucket(
            initial_capacity // max(nlist, 1), base=128))
        self.centroids: Optional[jax.Array] = None  # [L, D] f32
        self._alloc(self.list_cap)
        # Overflow region: exact flat index holding spill until optimize().
        self._overflow = FlatDeviceIndex(
            dimension, metric=metric, storage_dtype=storage_dtype,
            initial_capacity=1024, growth_factor=growth_factor,
            search_mode=search_mode, recall_target=recall_target, device=device,
        )
        # id -> (list, pos) or ("overflow", id kept in _overflow)
        self._id_to_cell: Dict[str, Tuple[int, int]] = {}
        self._next_pos = np.zeros(nlist, dtype=np.int64)
        self._fill_cache = None  # device [L] int32; rebuilt when _next_pos moves
        self._free: List[List[int]] = [[] for _ in range(nlist)]
        self._cell_to_id: Dict[int, str] = {}
        # Compact filter tier: write-epoch-keyed one-entry cache of the
        # gathered allowed-row block (see _exhaustive_topk).
        self._mutation_epoch = 0
        self._compact_cache = None

    def _alloc(self, cap: int) -> None:
        l, d = self.nlist, self._dim
        self.vecs = jnp.zeros((l, cap, d), dtype=self.storage_dtype)
        self.norms = jnp.zeros((l, cap), dtype=jnp.float32)
        self.valid = jnp.zeros((l, cap), dtype=jnp.bool_)
        # Validity-masked score weights (1/|v| for cosine, 1 for dot,
        # 0 = invalid): what the probe kernel and the masked scans multiply
        # by; 4 bytes per cell.
        self.recip: Optional[jax.Array] = jnp.zeros((l, cap),
                                                    dtype=jnp.float32)

    @property
    def dimension(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return len(self._id_to_cell) + len(self._overflow)

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    # -- training ---------------------------------------------------------------

    @property
    def _kmeans_mode(self) -> str:
        # Spherical k-means for angular metrics: L2 Lloyd's on near-isotropic
        # high-dim data collapses onto the smallest-norm centroid (one list
        # can swallow ~half the corpus), killing IVF pruning. Unit-norm
        # centroids also make the stage-1 dot probe a true cosine affinity.
        return "spherical" if self.metric in ("cosine", "dot") else "l2"

    def _auto_train_threshold(self) -> int:
        """Corpus size that triggers auto-training on insert (seam: IVF-PQ
        additionally needs 2^nbits rows to fit its codebooks)."""
        return self.nlist * 4

    def train(self, sample: np.ndarray, seed: int = 0) -> None:
        """Fit centroids (index.rs train -> kmeans_clustering, but on device)."""
        sample = np.asarray(sample, dtype=np.float32)
        if sample.shape[0] < self.nlist:
            raise ValueError(f"need >= nlist={self.nlist} training points")
        if sample.shape[0] > self.train_size:
            sel = np.random.default_rng(seed).choice(
                sample.shape[0], self.train_size, replace=False
            )
            sample = sample[sel]
        # Unchunked Lloyd's materializes an [N, nlist] assignment plane; at
        # production nlist (16,384) with the storage planes already resident
        # (they allocate at construction) that plane OOMs the chip — cap it
        # at ~256 MB f32 and run the chunked scan (same fixed point).
        chunk = None
        if sample.shape[0] * self.nlist > (1 << 26):
            chunk = max(256, (1 << 26) // self.nlist)
            n_use = max((sample.shape[0] // chunk) * chunk,
                        min(chunk, sample.shape[0]))
            sample = sample[:n_use]
            if sample.shape[0] % chunk:
                chunk = sample.shape[0]
        cents, _ = kmeans(jnp.asarray(sample), k=self.nlist, iters=self.kmeans_iters,
                          seed=seed, mode=self._kmeans_mode, chunk=chunk)
        self.centroids = cents

    # -- mutation -----------------------------------------------------------------

    def add_batch(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, vectors.shape[1])
        if not len(ids):
            return
        with self._lock:
            # Remove any existing versions first (upsert semantics).
            existing = [i for i in ids if i in self._id_to_cell or self._overflow.contains(i)]
            if existing:
                self.remove_batch(existing)
            if self.centroids is None:
                if len(self) + len(ids) >= self._auto_train_threshold():
                    # Auto-train on first big enough batch (+ overflow backlog).
                    o_ids, o_vecs = self._overflow.get_all()
                    pool = np.concatenate([o_vecs, vectors]) if len(o_ids) else vectors
                    self.train(pool)
                    if o_ids:
                        self._overflow.clear()
                        self._place(o_ids, o_vecs)
                else:
                    self._overflow.add_batch(ids, vectors)
                    return
            self._place(list(ids), vectors)

    def _place(self, ids: List[str], vectors: np.ndarray) -> None:
        assign = np.asarray(assign_clusters(jnp.asarray(vectors), self.centroids,
                                            mode=self._kmeans_mode))
        list_ids = np.empty(len(ids), dtype=np.int32)
        positions = np.empty(len(ids), dtype=np.int32)
        spill_idx: List[int] = []
        for i, (id_, lst) in enumerate(zip(ids, assign)):
            lst = int(lst)
            if self._free[lst]:
                pos = self._free[lst].pop()
            elif self._next_pos[lst] < self.list_cap:
                # _next_pos counts occupancy; _phys_pos maps the logical
                # insert order to a physical column (identity here; the
                # sharded index stripes across devices for balance)
                pos = self._phys_pos(int(self._next_pos[lst]))
                self._next_pos[lst] += 1
            else:
                spill_idx.append(i)
                list_ids[i] = -1
                positions[i] = -1
                continue
            list_ids[i] = lst
            positions[i] = pos
            self._id_to_cell[id_] = (lst, pos)
            self._cell_to_id[lst * self.list_cap + pos] = id_
        self._fill_cache = None  # _next_pos may have advanced
        self._mutation_epoch += 1
        keep = list_ids >= 0
        if keep.any():
            kv = vectors[keep]
            m = next_bucket(int(keep.sum()), base=64)
            lists_p = jnp.asarray(pad_rows(list_ids[keep], m, fill=PAD_SLOT))
            pos_p = jnp.asarray(pad_rows(positions[keep], m, fill=PAD_SLOT))
            # ship in the storage dtype: half the upload bytes (see
            # flat.ship_batch); int8-resident subclasses quantize from the
            # same bf16 values the bf16 plane would store
            from grape_vector_db_tpu.index.flat import _row_norms, ship_batch

            vecs_p = jnp.asarray(ship_batch(pad_rows(kv, m),
                                            self.storage_dtype))

            norms_p = _row_norms(vecs_p)
            self._scatter_rows(lists_p, pos_p, vecs_p, norms_p)
            self._post_scatter(lists_p, pos_p, vecs_p)
        if spill_idx:
            self._overflow.add_batch(
                [ids[i] for i in spill_idx], vectors[spill_idx]
            )

    def _scatter_rows(self, lists_p, pos_p, vecs_p, norms_p) -> None:
        """Device scatter of placed rows (subclass seam: quantized layouts
        override to store codes instead of / alongside the bf16 plane)."""
        self.vecs, self.norms, self.valid = _ivf_scatter(
            self.vecs, self.norms, self.valid, lists_p, pos_p, vecs_p, norms_p,
        )
        if self.recip is not None:
            self.recip = _recip_scatter(self.recip, lists_p, pos_p, norms_p,
                                         metric=self.metric)

    def _post_scatter(self, list_ids, positions, vecs) -> None:
        """Hook for subclasses keeping extra per-cell arrays (e.g. PQ codes)."""

    def remove_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            cells = []
            n = 0
            for i in ids:
                cell = self._id_to_cell.pop(i, None)
                if cell is not None:
                    lst, pos = cell
                    self._free[lst].append(pos)
                    self._cell_to_id.pop(lst * self.list_cap + pos, None)
                    cells.append(cell)
                    n += 1
            n += self._overflow.remove_batch([i for i in ids if i not in self._id_to_cell])
            if cells:
                arr = np.asarray(cells, dtype=np.int32)
                m = next_bucket(len(cells), base=64)
                lists_p = jnp.asarray(pad_rows(arr[:, 0], m, fill=PAD_SLOT))
                pos_p = jnp.asarray(pad_rows(arr[:, 1], m, fill=PAD_SLOT))
                self._invalidate_cells(lists_p, pos_p)
            return n

    def _invalidate_cells(self, lists_p, pos_p) -> None:
        """Device invalidation of removed cells (subclass seam)."""
        self._mutation_epoch += 1
        self.valid = _ivf_invalidate(self.valid, lists_p, pos_p)
        if self.recip is not None:
            self.recip = _recip_invalidate(self.recip, lists_p, pos_p)

    def clear(self) -> None:
        with self._lock:
            self.centroids = None
            self._alloc(self.list_cap)
            self._overflow.clear()
            self._id_to_cell.clear()
            self._cell_to_id.clear()
            self._next_pos = np.zeros(self.nlist, dtype=np.int64)
            self._fill_cache = None
            self._mutation_epoch += 1
            self._compact_cache = None
            self._free = [[] for _ in range(self.nlist)]

    # -- search -------------------------------------------------------------------

    def compile_mask(self, allowed_ids):
        """Allowed ids -> ([nlist, list_cap] cell mask, overflow slot mask)."""
        with self._lock:
            main = np.zeros((self.nlist, self.list_cap), dtype=bool)
            for id_ in allowed_ids:
                cell = self._id_to_cell.get(id_)
                if cell is not None:
                    main[cell[0], cell[1]] = True
            return main, self._overflow.compile_mask(allowed_ids)

    def _phys_pos(self, n: int) -> int:
        """Logical insert order -> physical column (seam: sharded layouts
        stripe across the device axis so every slice fills uniformly)."""
        return n

    def _list_fill(self) -> jax.Array:
        """Per-list rows in use (high-water marks) as a device [L] int32:
        the probe kernel reads no row past a list's fill. Free-list holes
        below the mark are read and masked by the weight plane. Cached:
        _next_pos only changes in _place/clear/optimize."""
        if self._fill_cache is None:
            self._fill_cache = jnp.asarray(self._next_pos, dtype=jnp.int32)
        return self._fill_cache

    def _main_topk(self, qp: np.ndarray, k: int, mask, nprobe=None):
        """Top-k over the bucketed main region (subclass seam; lock held).
        ``nprobe`` is the per-request override (SearchParams.ef)."""
        nprobe = min(nprobe or self.nprobe, self.nlist)
        if self._use_kernel:
            # The kernel reads each probed list in place; a filter mask
            # folds into the selection after it (1 byte per scored cell).
            from grape_vector_db_tpu.ops.ivf_pallas import kernel_ivf_topk

            return kernel_ivf_topk(
                jnp.asarray(qp), self.centroids, self.vecs, self.recip,
                k=k, nprobe=nprobe, metric=self.metric, fmt="bf16",
                fill=self._list_fill(),
                cell_mask=None if mask is None else jnp.asarray(mask[0]),
            )
        # Filter mask ANDs into cell validity so probed lists score
        # only allowed rows (masked top-k in-kernel). Caveat inherent
        # to IVF: allowed rows in unprobed lists are not visited.
        valid = self.valid if mask is None else jnp.logical_and(
            self.valid, jnp.asarray(mask[0]))
        return _ivf_topk(
            jnp.asarray(qp), self.centroids, self.vecs, self.norms,
            valid, k=k, nprobe=nprobe, metric=self.metric,
        )

    def _scan_planes(self):
        """(data, weight plane, format) for the exhaustive masked scan —
        the same arrays the probe kernel reads (subclass seam)."""
        return self.vecs, self.recip, "bf16"

    # HBM budget for the compact tier's gathered row copy (the streaming
    # scan allocates none). A default: 1 GiB is ~0.7M bf16 rows or ~2.8M
    # int4 rows at D = 768.
    compact_max_bytes = 1 << 30

    def _exhaustive_topk(self, qp: np.ndarray, k: int, mask):
        """Exact masked top-k over EVERY list. Two engines, routed by the
        allowed-set size (the mask is query-independent, so its cost is
        paid once per filter, not per query):

        - compact tier: gather ONLY the allowed rows into a [R]-row block
          (source dtype — no decode amplification), exact-scan those
          (ops/ivf_scan.py ivf_compact_masked_topk). Cost ~ selectivity,
          not corpus size.
        - streaming tier: one corpus pass reducing each list to its masked
          max, then the top-k lists through the normal probe. Cost = one
          corpus read at ANY selectivity — the fallback when the allowed
          set outgrows the compact tier's device-memory budget.

        The planner's low-selectivity fallback — nprobe does not bound
        recall on either engine."""
        from grape_vector_db_tpu.ops.ivf_scan import (
            default_chunk_lists, ivf_exhaustive_masked_topk)

        data, plane, fmt = self._scan_planes()
        m = np.asarray(mask[0])
        r = int(m.sum())
        cdata, cplane, cfmt = data, plane, fmt
        if fmt != "bf16" and self.vecs is not None:
            # quantized kind keeping a bf16 shadow: the compact tier can
            # afford to gather full-precision rows (R is bounded by the
            # HBM budget), so its scores are exact, not quantized
            cdata, cplane, cfmt = self.vecs, self.recip, "bf16"
        row_bytes = int(np.prod(cdata.shape[2:])) * cdata.dtype.itemsize
        rp = next_bucket(max(r, 1), base=2048)
        if r > 0 and rp * row_bytes <= self.compact_max_bytes:
            from grape_vector_db_tpu.ops.ivf_scan import (
                compact_gather, compact_topk_from_rows)

            cells = np.full(rp, -1, dtype=np.int32)
            cells[:r] = np.flatnonzero(m.reshape(-1)).astype(np.int32)
            # One-entry gathered-block cache: production filters repeat
            # (tenant scoping), and a repeat filter then pays the scan
            # without the row gather. Keyed
            # on the mutation epoch so any write/delete/optimize/clear
            # invalidates; the old block is dropped BEFORE the new gather
            # so at most one budget-sized copy lives in HBM.
            key = (self._mutation_epoch, cfmt, rp,
                   hash(cells.tobytes()))
            cached = self._compact_cache
            if cached is not None and cached[0] == key:
                _, cells_d, rows, w = cached
            else:
                self._compact_cache = None
                cells_d = jnp.asarray(cells)
                rows, w = compact_gather(cdata, cplane, cells_d)
                self._compact_cache = (key, cells_d, rows, w)
            return compact_topk_from_rows(
                jnp.asarray(qp), rows, w, cells_d,
                k=k, metric=self.metric, fmt=cfmt,
                chunk_rows=min(131_072, rp))
        return ivf_exhaustive_masked_topk(
            jnp.asarray(qp), data, plane, jnp.asarray(mask[0]),
            k=k, metric=self.metric, fmt=fmt,
            chunk_lists=default_chunk_lists(self.nlist, data.shape[1]),
            use_kernel=self._use_kernel, fill=self._list_fill())

    def search_batch(self, queries: np.ndarray, k: int,
                     mask=None, nprobe=None,
                     exhaustive: bool = False) -> List[List[SearchHit]]:
        queries = np.asarray(queries, dtype=np.float32)
        if queries.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, queries.shape[1])
        b = queries.shape[0]
        if b == 0 or len(self) == 0:
            return [[] for _ in range(b)]
        with self._lock:
            if self.centroids is None:
                return self._overflow.search_batch(
                    queries, k, mask=None if mask is None else mask[1])
            bb = next_bucket(b, base=8)
            qp = pad_rows(queries, bb)
            if (exhaustive and mask is not None
                    and self.supports_exhaustive_mask):
                vals, slots = self._exhaustive_topk(qp, k, mask)
            else:
                vals, slots = self._main_topk(qp, k, mask, nprobe=nprobe)
            vals, slots = fetch_scores_slots(vals, slots)
            vals, slots = vals[:b], slots[:b]
            if len(self._overflow):
                o_vals, o_idx = self._overflow.raw_topk(
                    qp, k, mask=None if mask is None else mask[1])
                o_hits = self._overflow.hits_from_slots(o_vals[:b], o_idx[:b])
            else:
                o_hits = [[] for _ in range(b)]
        out: List[List[SearchHit]] = []
        for row_v, row_s, extra in zip(vals, slots, o_hits):
            hits: List[SearchHit] = []
            for v, s in zip(row_v, row_s):
                if not np.isfinite(v):
                    continue
                id_ = self._cell_to_id.get(int(s))
                if id_ is not None:
                    hits.append((id_, float(v)))
            hits.extend(extra)
            hits.sort(key=lambda h: -h[1])
            # Dedup (an id can't be in both regions, but keep it robust).
            seen = set()
            uniq = []
            for h in hits:
                if h[0] not in seen:
                    seen.add(h[0])
                    uniq.append(h)
            out.append(uniq[:k])
        return out

    # -- maintenance ----------------------------------------------------------------

    def tune_nprobe(self, queries: Optional[np.ndarray] = None, k: int = 10,
                    target_recall: float = 0.95,
                    max_nprobe: Optional[int] = None) -> int:
        """Pick (and set) the smallest nprobe whose recall@k on a validation
        query set meets ``target_recall``, measured against this index's own
        exhaustive probe (nprobe = nlist) as the oracle. The recall/latency
        knob the reference's IndexOptimizer never had — its IVF linear-
        scanned regardless (index.rs:620-640).

        ``queries`` defaults to a sample of the indexed vectors themselves
        (the standard self-recall protocol). Each candidate nprobe is a
        separate jit variant; candidates grow geometrically so the sweep
        compiles O(log nlist) kernels."""
        with self._lock:
            if self.centroids is None or not self._id_to_cell:
                return self.nprobe
            if queries is None:
                ids = list(self._id_to_cell)[:256]
                queries = np.stack([
                    self._host_row(*self._id_to_cell[i]) for i in ids
                ]).astype(np.float32)
        queries = np.asarray(queries, dtype=np.float32)
        limit = min(max_nprobe or self.nlist, self.nlist)
        saved = self.nprobe
        chosen: Optional[int] = None
        try:
            self.nprobe = self.nlist
            oracle = [frozenset(h[0] for h in row)
                      for row in self.search_batch(queries, k)]
            denom = sum(len(w) for w in oracle) or 1
            cand = 1
            while True:
                self.nprobe = cand
                got = self.search_batch(queries, k)
                hits = sum(len(set(h[0] for h in row) & want)
                           for row, want in zip(got, oracle))
                if hits / denom >= target_recall or cand >= limit:
                    chosen = cand
                    return cand
                cand = min(cand * 2, limit)
        finally:
            self.nprobe = chosen if chosen is not None else saved

    def optimize(self) -> None:
        """Retrain centroids on the full corpus and repack all lists (absorbs the
        overflow region) — the reference's IndexOptimizer trigger target
        (performance/index_optimizer.rs)."""
        with self._lock:
            ids, vecs = self.get_all()
            if len(ids) < self.nlist:
                return
            self.clear()
            self.train(vecs)
            # Size lists to the retrained cluster histogram (with 25% headroom)
            # so the repack absorbs the whole corpus without re-spilling.
            counts = np.bincount(
                np.asarray(assign_clusters(jnp.asarray(vecs), self.centroids,
                                           mode=self._kmeans_mode)),
                minlength=self.nlist,
            )
            need = int(counts.max())
            if need > self.list_cap:
                # base=128 keeps capacities on a few bucket sizes (one
                # compiled program each) and the kernel's row blocks whole
                self.list_cap = next_bucket(int(need * 1.25) + 1, base=128)
                self._alloc(self.list_cap)
            self._place(ids, vecs)

    # -- introspection ---------------------------------------------------------------

    def _host_rows(self) -> np.ndarray:
        """Host f32 [L, C, D] view of the main region (subclass seam:
        code-resident layouts reconstruct/dequantize here)."""
        return np.asarray(self.vecs, dtype=np.float32)

    def _host_row(self, lst: int, pos: int) -> np.ndarray:
        """Host f32 [D] read of one cell (subclass seam)."""
        return np.asarray(self.vecs[lst, pos], dtype=np.float32)

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        cell = self._id_to_cell.get(id_)
        if cell is None:
            return self._overflow.get_vector(id_)
        lst, pos = cell
        return self._host_row(lst, pos)

    def get_all(self) -> Tuple[List[str], np.ndarray]:
        with self._lock:
            ids: List[str] = []
            rows: List[np.ndarray] = []
            if self._id_to_cell:
                cells = sorted(self._id_to_cell.items(), key=lambda kv: kv[1])
                host = self._host_rows()
                for id_, (lst, pos) in cells:
                    ids.append(id_)
                    rows.append(host[lst, pos])
            main = np.stack(rows) if rows else np.zeros((0, self._dim), np.float32)
            o_ids, o_vecs = self._overflow.get_all()
            ids.extend(o_ids)
            return ids, np.concatenate([main, o_vecs], axis=0)

    def get_stats(self) -> IndexStats:
        fill = [int(self._next_pos[i]) - len(self._free[i]) for i in range(self.nlist)]
        return IndexStats(
            point_count=len(self),
            dimension=self._dim,
            capacity=self.nlist * self.list_cap,
            kind=self.kind,
            is_built=self.is_trained,
            memory_usage_mb=self.nlist * self.list_cap
            * (self.storage_dtype.itemsize * self._dim + 5) / 1e6,
            extra={
                "nlist": float(self.nlist),
                "nprobe": float(self.nprobe),
                "overflow": float(len(self._overflow)),
                "max_list_fill": float(max(fill) if fill else 0),
            },
        )
