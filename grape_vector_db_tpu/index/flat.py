"""FlatDeviceIndex — exact search over fixed-capacity HBM-resident shard arrays.

This is the framework's north-star structure (SURVEY.md §7.1 step 2): the corpus
is a ``[capacity, dim]`` device array (bf16 by default) + f32 norms + a validity
mask. Upsert/delete are jitted scatters (no rebuild — unlike the reference,
which rebuilds the whole HNSW graph on every insert, index.rs:164-185); search
is the chunked matmul + top-k scan in ops/distance.py.

Capacity grows by bucket doubling (one recompile per bucket). Deletes tombstone
slots via the validity mask and recycle them on later inserts — the reference
instead re-packs and rebuilds (index.rs:233-278).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grape_vector_db_tpu.errors import DimensionMismatchError
from grape_vector_db_tpu.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu.ops.distance import scored_topk
from grape_vector_db_tpu.utils.buckets import PAD_SLOT, next_bucket, pad_rows
from grape_vector_db_tpu.utils.fetch import fetch_scores_slots

__all__ = ["FlatDeviceIndex"]

_SEARCH_CHUNK = 65536


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _scatter_set(vectors, norms, valid, slots, new_vecs, new_norms):
    """Write a padded batch into shard arrays. Padding rows carry slot=-1 which
    scatter-mode 'drop' discards."""
    vectors = vectors.at[slots].set(new_vecs.astype(vectors.dtype), mode="drop")
    norms = norms.at[slots].set(new_norms, mode="drop")
    valid = valid.at[slots].set(True, mode="drop")
    return vectors, norms, valid


@jax.jit
def _row_norms(vecs):
    """f32 row norms of the stored rows (squares summed in f32)."""
    v = vecs.astype(jnp.float32)
    return jnp.sqrt(jnp.sum(v * v, axis=1))


def ship_batch(arr: np.ndarray, storage_dtype) -> np.ndarray:
    """Cast a host vector batch to the storage dtype BEFORE upload when it is
    narrower than f32: halves the host->device bytes on the write path's wire
    term (PCIe co-located, DCN on replicated ingest). The device scatter cast
    to the storage dtype anyway, so stored values are identical; norms
    computed from the shipped batch describe the stored row exactly (cosine
    self-match actually sharpens)."""
    if jnp.dtype(storage_dtype).itemsize < 4:
        return arr.astype(storage_dtype)
    return arr


@functools.partial(jax.jit, static_argnames=("dt",))
def _cast_rows(vecs, dt: str):
    """Storage-dtype cast + norms for a device-resident batch (the
    device-direct ingest path: the batch never visits the host)."""
    v = vecs.astype(dt)
    return v, _row_norms(v)


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_invalidate(valid, slots):
    return valid.at[slots].set(False, mode="drop")


# No donation: a grown output cannot alias the smaller input buffer, so
# donating only produced "donated buffers were not usable" warnings.
@functools.partial(jax.jit, static_argnames=("new_cap",))
def _grow(vectors, norms, valid, new_cap: int):
    pad = new_cap - vectors.shape[0]
    vectors = jnp.pad(vectors, ((0, pad), (0, 0)))
    norms = jnp.pad(norms, ((0, pad),))
    valid = jnp.pad(valid, ((0, pad),))
    return vectors, norms, valid


class FlatDeviceIndex(VectorIndex):
    """Exact device-scan index (recall = 1.0 by construction)."""

    kind = "flat"
    supports_mask = True

    def __init__(
        self,
        dimension: int,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        initial_capacity: int = 4096,
        growth_factor: int = 2,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        device: Optional[jax.Device] = None,
    ):
        if metric not in ("cosine", "dot", "euclidean"):
            raise ValueError(f"unknown metric {metric}")
        if search_mode not in ("exact", "approx"):
            raise ValueError(f"unknown search_mode {search_mode}")
        self._dim = dimension
        self.metric = metric
        self.search_mode = search_mode
        self.recall_target = recall_target
        self.storage_dtype = jnp.dtype(storage_dtype)
        self._initial_capacity = initial_capacity
        self._growth_factor = growth_factor
        self._device = device
        self._lock = threading.RLock()
        self._alloc(initial_capacity)
        # Host id <-> slot bookkeeping.
        self._id_to_slot: Dict[str, int] = {}
        self._slot_to_id: List[Optional[str]] = [None] * initial_capacity
        self._free: List[int] = []
        self._high_water = 0  # slots ever handed out

    # -- allocation ---------------------------------------------------------

    def _put(self, x):
        return jax.device_put(x, self._device) if self._device is not None else jnp.asarray(x)

    def _alloc(self, capacity: int) -> None:
        self.vectors = self._put(jnp.zeros((capacity, self._dim), dtype=self.storage_dtype))
        self.norms = self._put(jnp.zeros((capacity,), dtype=jnp.float32))
        self.valid = self._put(jnp.zeros((capacity,), dtype=jnp.bool_))
        self.capacity = capacity
        self._alloc_extra(capacity)

    def _alloc_extra(self, capacity: int) -> None:
        """Hook for subclasses holding extra per-slot device arrays."""

    def _grow_extra(self, new_cap: int) -> None:
        """Hook: grow extra per-slot arrays to new_cap."""

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = next_bucket(needed, base=self._initial_capacity, factor=self._growth_factor)
        self.vectors, self.norms, self.valid = _grow(
            self.vectors, self.norms, self.valid, new_cap=new_cap
        )
        self._grow_extra(new_cap)
        self._slot_to_id.extend([None] * (new_cap - self.capacity))
        self.capacity = new_cap

    # -- properties ----------------------------------------------------------

    @property
    def dimension(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return len(self._id_to_slot)

    # -- mutation -------------------------------------------------------------

    def _assign_slots(self, ids: Sequence[str]) -> np.ndarray:
        slots = np.empty(len(ids), dtype=np.int32)
        for i, id_ in enumerate(ids):
            slot = self._id_to_slot.get(id_)
            if slot is None:
                if self._free:
                    slot = self._free.pop()
                else:
                    slot = self._high_water
                    self._high_water += 1
                    self._ensure_capacity(self._high_water)
                self._id_to_slot[id_] = slot
                self._slot_to_id[slot] = id_
            slots[i] = slot
        return slots

    def add_batch(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[0] != len(ids):
            raise ValueError("vectors must be [len(ids), dim]")
        if vectors.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, vectors.shape[1])
        if not len(ids):
            return
        # Dedupe within the batch (last write wins) — device scatter order with
        # duplicate indices is unspecified.
        last: Dict[str, int] = {i: p for p, i in enumerate(ids)}
        if len(last) != len(ids):
            keep = sorted(last.values())
            ids = [ids[p] for p in keep]
            vectors = vectors[keep]
        with self._lock:
            slots = self._assign_slots(ids)
            m = next_bucket(len(ids), base=64)
            slots_p = pad_rows(slots, m, fill=PAD_SLOT)
            vecs_d = jnp.asarray(ship_batch(pad_rows(vectors, m),
                                            self.storage_dtype))
            # Norms on device: a host numpy norm walks the whole batch on
            # the ingest thread; on the device it is cheap and pipelines
            # with the scatter.
            norms_d = _row_norms(vecs_d)
            self._write(jnp.asarray(slots_p), vecs_d, norms_d)

    def add_batch_device(self, ids: Sequence[str],
                         chunks: Sequence[Tuple[jax.Array, int]]) -> None:
        """Scatter device-resident rows without a host round trip.

        ``chunks`` is ``[(device f32 [padded_rows, dim], n_valid), ...]``
        with ``sum(n_valid) == len(ids)`` — the shape ``DeviceHashEmbedder.
        embed_ingest`` hands back. Rows past ``n_valid`` in each chunk are
        padding and are dropped via PAD_SLOT. Caller guarantees ``ids`` are
        unique within the batch (the db's text-only ingest path checks);
        the host path ``add_batch`` remains the general entry.
        """
        if not len(ids):
            return
        total = sum(nv for _, nv in chunks)
        if total != len(ids):
            raise ValueError(f"chunks carry {total} rows for {len(ids)} ids")
        for dev, _ in chunks:
            if dev.ndim != 2 or dev.shape[1] != self._dim:
                raise DimensionMismatchError(self._dim, dev.shape[-1])
        with self._lock:
            slots = self._assign_slots(ids)
            off = 0
            for dev, nv in chunks:
                sp = pad_rows(slots[off:off + nv], dev.shape[0],
                              fill=PAD_SLOT)
                off += nv
                vecs_d, norms_d = _cast_rows(dev, str(self.storage_dtype))
                self._write(jnp.asarray(sp), vecs_d, norms_d)

    def _write(self, slots, vecs, norms) -> None:
        """Scatter one padded batch into the device arrays (overridable)."""
        self.vectors, self.norms, self.valid = _scatter_set(
            self.vectors, self.norms, self.valid, slots, vecs, norms
        )

    def remove_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            slots = [self._id_to_slot.pop(i) for i in ids if i in self._id_to_slot]
            if not slots:
                return 0
            for s in slots:
                self._slot_to_id[s] = None
                self._free.append(s)
            m = next_bucket(len(slots), base=64)
            slots_p = pad_rows(np.asarray(slots, dtype=np.int32), m, fill=PAD_SLOT)
            self.valid = _scatter_invalidate(self.valid, jnp.asarray(slots_p))
            return len(slots)

    def clear(self) -> None:
        with self._lock:
            self._alloc(self._initial_capacity)
            self._id_to_slot.clear()
            self._slot_to_id = [None] * self._initial_capacity
            self._free = []
            self._high_water = 0

    # -- search ---------------------------------------------------------------

    def compile_mask(self, allowed_ids) -> np.ndarray:
        """Allowed-id set -> capacity-aligned slot mask for masked top-k."""
        from grape_vector_db_tpu.engine.filtering import mask_from_allowed

        with self._lock:
            return mask_from_allowed(set(allowed_ids), self._slot_to_id,
                                     self._id_to_slot)

    def raw_topk(self, queries: np.ndarray, k: int,
                 mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Device top-k: returns (scores [B, k], slot indices [B, k]) as numpy.
        Rows beyond the true query count must be stripped by the caller.

        Holds the index lock: updates donate the shard buffers, so a search
        racing an update would read a deleted array."""
        with self._lock:
            chunk = min(_SEARCH_CHUNK, self.capacity)
            vals, idxs = scored_topk(
                jnp.asarray(queries), self.vectors, self.norms, self.valid,
                k=k, metric=self.metric, chunk=chunk,
                mode=self.search_mode, recall_target=self.recall_target,
                mask=None if mask is None else jnp.asarray(mask),
            )
            return fetch_scores_slots(vals, idxs)

    def search_batch(self, queries: np.ndarray, k: int,
                     mask: Optional[np.ndarray] = None) -> List[List[SearchHit]]:
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ValueError("queries must be [B, dim]")
        if queries.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, queries.shape[1])
        b = queries.shape[0]
        if b == 0 or not self._id_to_slot:
            return [[] for _ in range(b)]
        bb = next_bucket(b, base=8)
        vals, idxs = self.raw_topk(pad_rows(queries, bb), k, mask=mask)
        return self.hits_from_slots(vals[:b], idxs[:b])

    def hits_from_slots(self, vals: np.ndarray, idxs: np.ndarray) -> List[List[SearchHit]]:
        out: List[List[SearchHit]] = []
        for row_v, row_i in zip(vals, idxs):
            hits: List[SearchHit] = []
            for v, i in zip(row_v, row_i):
                if not np.isfinite(v):
                    continue
                id_ = self._slot_to_id[int(i)]
                if id_ is not None:
                    hits.append((id_, float(v)))
            out.append(hits)
        return out

    # -- introspection / persistence -------------------------------------------

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        slot = self._id_to_slot.get(id_)
        if slot is None:
            return None
        return np.asarray(self.vectors[slot], dtype=np.float32)

    def get_all(self) -> Tuple[List[str], np.ndarray]:
        with self._lock:
            items = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
            if not items:
                return [], np.zeros((0, self._dim), dtype=np.float32)
            ids = [i for i, _ in items]
            slots = np.asarray([s for _, s in items], dtype=np.int32)
            vecs = np.asarray(self.vectors, dtype=np.float32)[slots]
            return ids, vecs

    def get_stats(self) -> IndexStats:
        bytes_per_row = self.storage_dtype.itemsize * self._dim + 4 + 1
        return IndexStats(
            point_count=len(self._id_to_slot),
            dimension=self._dim,
            capacity=self.capacity,
            is_built=True,
            memory_usage_mb=self.capacity * bytes_per_row / 1e6,
            kind=self.kind,
        )
