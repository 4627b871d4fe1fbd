"""SPMD corpus sharding over a device mesh.

The SPMD rewrite of the reference's distributed query data plane:
- shard.rs hash-range ShardManager  ->  static block assignment: global slot s
  lives on device s // per_shard_capacity of the ``shard`` mesh axis.
- shard.rs:759-901 scatter-gather search (per-shard tasks + HTTP + sort-merge)
  ->  one shard_map: local chunked-matmul top-k per device, then a single
  ``all_gather`` over the device interconnect and a replicated global top-k
  merge.
- shard migration / rebalancing  ->  resharding is a device_put with a new
  NamedSharding over the same arrays (see redistribute()).

Queries are replicated (every device scores its local shard for the whole query
batch); the corpus is sharded along rows. This is the layout the scaling-book
recipe prescribes for corpus-parallel retrieval: collectives ride the device
interconnect (NVLink on a GPU host), payload gathers stay host-side.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from grape_vector_db_tpu.errors import DimensionMismatchError
from grape_vector_db_tpu.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu.index.ivf import IvfDeviceIndex
from grape_vector_db_tpu.index.ivf_int4 import (Int4IvfDeviceIndex,
    _int4_cell_scatter)
from grape_vector_db_tpu.index.ivf_int8 import (Int8IvfDeviceIndex,
    _factor_invalidate, _int8_cell_scatter, _nv_scatter)
from grape_vector_db_tpu.ops.distance import (prepare_queries, rowwise_dots,
                                              score_block)
from grape_vector_db_tpu.ops.ivf_probe import probe_lists
from grape_vector_db_tpu.ops.topk import take_topk
from grape_vector_db_tpu.utils.buckets import PAD_SLOT, next_bucket, pad_rows
from grape_vector_db_tpu.utils.fetch import fetch_scores_slots

__all__ = ["make_mesh", "sharded_scored_topk", "sharded_ivf_topk",
           "sharded_ivf_int8_topk", "sharded_ivf_exhaustive_topk",
           "sharded_ivf_compact_topk",
           "ShardedInt8IvfIndex", "ShardedInt4IvfIndex", "ShardedFlatIndex",
           "ShardedIvfIndex"]


def make_mesh(
    n_shards: Optional[int] = None,
    shard_axis: str = "shard",
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if n_shards is not None:
        devs = devs[:n_shards]
    return Mesh(np.asarray(devs), (shard_axis,))


def make_mesh_2d(
    n_replicas: int,
    n_shards: Optional[int] = None,
    replica_axis: str = "replica",
    shard_axis: str = "shard",
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """(replica, shard) mesh: the corpus shards over ``shard`` and is
    replicated over ``replica``; the query batch splits over ``replica``.
    Throughput scales with replicas at the cost of replica-times the corpus
    memory — the SPMD form of the reference's replica groups."""
    devs = list(devices) if devices is not None else jax.devices()
    total = len(devs) if n_shards is None else n_replicas * n_shards
    if total % n_replicas:
        raise ValueError(f"{total} devices not divisible by {n_replicas} replicas")
    devs = devs[:total]
    grid = np.asarray(devs).reshape(n_replicas, total // n_replicas)
    return Mesh(grid, (replica_axis, shard_axis))


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "chunk", "mesh", "shard_axis", "replica_axis",
                     "mode", "recall_target"),
)
def replicated_sharded_topk(
    queries: jax.Array,   # [B, D] f32, B % n_replicas == 0; split over replica
    vectors: jax.Array,   # [S*C, D] sharded over shard, replicated over replica
    norms: jax.Array,
    valid: jax.Array,
    k: int,
    metric: str,
    chunk: int,
    mesh: Mesh,
    shard_axis: str = "shard",
    replica_axis: str = "replica",
    mode: str = "exact",
    recall_target: float = 0.99,
) -> Tuple[jax.Array, jax.Array]:
    """2D query execution: each replica row serves its slice of the query
    batch against its full (sharded) copy of the corpus; one all_gather over
    the shard axis merges per-shard winners. No collective crosses the replica
    axis — replica rows are independent serving lanes."""
    n_shards = mesh.shape[shard_axis]
    per_shard = vectors.shape[0] // n_shards

    def spmd(q, vecs, nrm, msk):
        qp = prepare_queries(q, metric)
        vals, idxs = _local_topk(qp, vecs, nrm, msk, k, metric, chunk,
                                 mode=mode, recall_target=recall_target)
        shard_id = lax.axis_index(shard_axis)
        gidx = idxs + shard_id * per_shard
        all_vals = lax.all_gather(vals, shard_axis, axis=1, tiled=True)
        all_idx = lax.all_gather(gidx, shard_axis, axis=1, tiled=True)
        return take_topk(all_vals, all_idx, k)

    return jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=(P(replica_axis, None), P(shard_axis, None), P(shard_axis),
                  P(shard_axis)),
        out_specs=(P(replica_axis, None), P(replica_axis, None)),
        check_vma=False,
    )(queries, vectors, norms, valid)


def _local_topk(q, vecs, norms, valid, k: int, metric: str, chunk: int,
                mode: str = "exact", recall_target: float = 0.99):
    """Per-device top-k over the local shard rows (runs inside shard_map, so
    shapes here are the *local* shard shapes). Uses the same fast top-k engines
    as ops.distance (iterative exact / approx_max_k)."""
    from grape_vector_db_tpu.ops.distance import _select_topk

    n, d = vecs.shape
    b = q.shape[0]
    # Large local shards take the fused segment-max kernel (same gate as
    # scored_topk's single-device routing): the [B, n_local] score plane
    # never reaches device memory. q is already prepared — the engine's own
    # prepare_queries is idempotent for cosine and identity for dot.
    from grape_vector_db_tpu.ops.distance import exact_engine

    if exact_engine(n, d, b, k, vecs.dtype, metric, mode,
                    chunk) == "segmax_kernel":
        from grape_vector_db_tpu.ops.segmax_pallas import segmax_topk

        return segmax_topk(q, vecs, norms, valid, k=min(k, n), metric=metric)
    if b * n <= 2**27:
        s = score_block(q, vecs, norms, valid, metric)
        vals, idxs = _select_topk(s, min(k, n), mode, recall_target)
        return vals, idxs
    chunk = min(chunk, n)
    num_chunks = max(1, n // chunk)
    kk = min(k, chunk)
    vecs_c = vecs.reshape(num_chunks, chunk, d)
    norms_c = norms.reshape(num_chunks, chunk)
    valid_c = valid.reshape(num_chunks, chunk)
    offs = jnp.arange(num_chunks, dtype=jnp.int32) * chunk

    def body(carry, xs):
        v, nn, m, off = xs
        s = score_block(q, v, nn, m, metric)
        tv, ti = _select_topk(s, kk, mode, recall_target)
        return carry, (tv, ti + off)

    _, (vals, idxs) = lax.scan(body, None, (vecs_c, norms_c, valid_c, offs))
    vals = jnp.moveaxis(vals, 0, 1).reshape(b, num_chunks * kk)
    idxs = jnp.moveaxis(idxs, 0, 1).reshape(b, num_chunks * kk)
    return take_topk(vals, idxs, min(k, num_chunks * kk))


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "chunk", "mesh", "shard_axis", "mode",
                     "recall_target"),
)
def sharded_scored_topk(
    queries: jax.Array,   # [B, D] f32, replicated
    vectors: jax.Array,   # [S*C, D] sharded on rows over `shard_axis`
    norms: jax.Array,     # [S*C]   sharded
    valid: jax.Array,     # [S*C]   sharded
    k: int,
    metric: str,
    chunk: int,
    mesh: Mesh,
    shard_axis: str = "shard",
    mode: str = "exact",
    recall_target: float = 0.99,
) -> Tuple[jax.Array, jax.Array]:
    """Global top-k across all shards: local scan + one all_gather merge.

    Returns replicated (scores [B, k], *global* row indices [B, k]).
    """
    n_shards = mesh.shape[shard_axis]
    per_shard = vectors.shape[0] // n_shards

    def spmd(q, vecs, nrm, msk):
        qp = prepare_queries(q, metric)
        vals, idxs = _local_topk(qp, vecs, nrm, msk, k, metric, chunk,
                                 mode=mode, recall_target=recall_target)
        shard_id = lax.axis_index(shard_axis)
        gidx = idxs + shard_id * per_shard
        # One collective: gather every shard's top-k, then merge.
        all_vals = lax.all_gather(vals, shard_axis, axis=1, tiled=True)   # [B, S*k]
        all_idx = lax.all_gather(gidx, shard_axis, axis=1, tiled=True)
        return take_topk(all_vals, all_idx, k)

    return jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=(P(), P(shard_axis, None), P(shard_axis), P(shard_axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )(queries, vectors, norms, valid)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _sharded_scatter_set(vectors, norms, valid, slots, new_vecs, new_norms):
    """Global scatter into sharded arrays — XLA routes rows to owning devices."""
    vectors = vectors.at[slots].set(new_vecs.astype(vectors.dtype), mode="drop")
    norms = norms.at[slots].set(new_norms, mode="drop")
    valid = valid.at[slots].set(True, mode="drop")
    return vectors, norms, valid


@functools.partial(jax.jit, donate_argnums=(0,))
def _sharded_invalidate(valid, slots):
    return valid.at[slots].set(False, mode="drop")


class ShardedFlatIndex(VectorIndex):
    """Mesh-sharded exact index: same VectorIndex contract as FlatDeviceIndex but
    the corpus rows live distributed across the ``shard`` mesh axis.

    Slot assignment is round-robin across shards so load stays balanced (the
    static-block analog of the reference's consistent-hash ring, shard.rs:164-372).
    """

    kind = "sharded_flat"
    supports_mask = True

    def __init__(
        self,
        dimension: int,
        mesh: Optional[Mesh] = None,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        shard_capacity: int = 4096,
        shard_axis: str = "shard",
        search_chunk: int = 65536,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        replica_axis: Optional[str] = None,
    ):
        self._dim = dimension
        self.metric = metric
        self.search_mode = search_mode
        self.recall_target = recall_target
        self.mesh = mesh if mesh is not None else make_mesh(shard_axis=shard_axis)
        self.shard_axis = shard_axis
        # On a 2D (replica x shard) mesh the query batch splits over the
        # replica axis (independent serving lanes); 1D meshes replicate it.
        self.replica_axis = (
            replica_axis if replica_axis in self.mesh.axis_names else None
        )
        self.n_replicas = (
            self.mesh.shape[self.replica_axis] if self.replica_axis else 1
        )
        self.n_shards = self.mesh.shape[shard_axis]
        self.shard_capacity = shard_capacity
        self.search_chunk = search_chunk
        self.storage_dtype = jnp.dtype(storage_dtype)
        self._row_sharding = NamedSharding(self.mesh, P(shard_axis, None))
        self._vec_sharding = NamedSharding(self.mesh, P(shard_axis))
        self._repl = NamedSharding(self.mesh, P())
        cap = self.n_shards * shard_capacity
        self.capacity = cap
        self.vectors = jax.device_put(
            jnp.zeros((cap, dimension), dtype=self.storage_dtype), self._row_sharding
        )
        self.norms = jax.device_put(jnp.zeros((cap,), jnp.float32), self._vec_sharding)
        self.valid = jax.device_put(jnp.zeros((cap,), jnp.bool_), self._vec_sharding)
        self._id_to_slot: Dict[str, int] = {}
        self._slot_to_id: List[Optional[str]] = [None] * cap
        # Per-shard free lists + next pointers for round-robin placement.
        self._next_in_shard = [0] * self.n_shards
        self._free: List[List[int]] = [[] for _ in range(self.n_shards)]
        self._rr = 0
        # Update fns donate their buffers — searches hold this so they never
        # read a donated-away array (repo convention, CLAUDE.md). clear() and
        # redistribute() re-run __init__, so the lock object must SURVIVE it:
        # replacing a held lock would let another thread's search race the
        # continuing donation.
        if not hasattr(self, "_lock"):
            self._lock = threading.RLock()

    @property
    def dimension(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return len(self._id_to_slot)

    # -- slot assignment --------------------------------------------------------

    def _alloc_slot(self) -> int:
        for _ in range(self.n_shards):
            s = self._rr
            self._rr = (self._rr + 1) % self.n_shards
            if self._free[s]:
                return self._free[s].pop()
            if self._next_in_shard[s] < self.shard_capacity:
                slot = s * self.shard_capacity + self._next_in_shard[s]
                self._next_in_shard[s] += 1
                return slot
        raise MemoryError(
            f"sharded index full ({self.n_shards}x{self.shard_capacity}); "
            "resize via redistribute()"
        )

    # -- mutation -----------------------------------------------------------------

    def add_batch(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, vectors.shape[1])
        if not len(ids):
            return
        last = {i: p for p, i in enumerate(ids)}
        if len(last) != len(ids):
            keep = sorted(last.values())
            ids = [ids[p] for p in keep]
            vectors = vectors[keep]
        with self._lock:
            new = sum(1 for i in ids if i not in self._id_to_slot)
            if len(self._id_to_slot) + new > self.capacity:
                # Auto-grow: re-place the corpus at doubled per-shard capacity
                # (redistribute is the same O(N) device round-trip any growth
                # copy pays; the mesh layout stays put).
                cap = self.shard_capacity
                while self.n_shards * cap < len(self._id_to_slot) + new:
                    cap *= 2
                self.redistribute(self.mesh, shard_capacity=cap)
            slots = np.empty(len(ids), dtype=np.int32)
            for i, id_ in enumerate(ids):
                slot = self._id_to_slot.get(id_)
                if slot is None:
                    slot = self._alloc_slot()
                    self._id_to_slot[id_] = slot
                    self._slot_to_id[slot] = id_
                slots[i] = slot
            from grape_vector_db_tpu.index.flat import _row_norms, ship_batch

            m = next_bucket(len(ids), base=64)
            vecs_d = jax.device_put(
                jnp.asarray(ship_batch(pad_rows(vectors, m),
                                       self.storage_dtype)),
                self._repl)
            self.vectors, self.norms, self.valid = _sharded_scatter_set(
                self.vectors, self.norms, self.valid,
                jax.device_put(jnp.asarray(pad_rows(slots, m, fill=PAD_SLOT)), self._repl),
                vecs_d,
                _row_norms(vecs_d),
            )

    def remove_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            slots = []
            for i in ids:
                s = self._id_to_slot.pop(i, None)
                if s is not None:
                    self._slot_to_id[s] = None
                    self._free[s // self.shard_capacity].append(s)
                    slots.append(s)
            if not slots:
                return 0
            m = next_bucket(len(slots), base=64)
            self.valid = _sharded_invalidate(
                self.valid,
                jax.device_put(
                    jnp.asarray(pad_rows(np.asarray(slots, np.int32), m, fill=PAD_SLOT)), self._repl
                ),
            )
            return len(slots)

    def clear(self) -> None:
        with self._lock:
            self.__init__(
                self._dim, mesh=self.mesh, metric=self.metric,
                storage_dtype=str(self.storage_dtype), shard_capacity=self.shard_capacity,
                shard_axis=self.shard_axis, search_chunk=self.search_chunk,
                search_mode=self.search_mode, recall_target=self.recall_target,
                replica_axis=self.replica_axis,
            )

    # -- search ---------------------------------------------------------------------

    def compile_mask(self, allowed_ids) -> np.ndarray:
        from grape_vector_db_tpu.engine.filtering import mask_from_allowed

        return mask_from_allowed(set(allowed_ids), self._slot_to_id,
                                 self._id_to_slot)

    def search_batch(self, queries: np.ndarray, k: int,
                     mask: Optional[np.ndarray] = None) -> List[List[SearchHit]]:
        queries = np.asarray(queries, dtype=np.float32)
        if queries.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, queries.shape[1])
        b = queries.shape[0]
        with self._lock:
            if b == 0 or not self._id_to_slot:
                return [[] for _ in range(b)]
            bb = next_bucket(b, base=8)
            if self.n_replicas > 1:
                # batch must split evenly over replica lanes (n_replicas may
                # not be a power of two — ceil to a multiple, don't assume
                # bucket divisibility)
                bb = -(-bb // self.n_replicas) * self.n_replicas
            chunk = min(self.search_chunk, self.shard_capacity)
            valid = self.valid
            if mask is not None:
                # Mask rows are global-slot-aligned, i.e. already laid out per
                # shard — device_put with the same row sharding and AND in place;
                # the per-shard top-k then only scores allowed rows.
                valid = jnp.logical_and(
                    valid,
                    jax.device_put(jnp.asarray(mask), self._vec_sharding),
                )
            if self.replica_axis:
                q = jax.device_put(
                    jnp.asarray(pad_rows(queries, bb)),
                    NamedSharding(self.mesh, P(self.replica_axis, None)),
                )
                vals, idxs = replicated_sharded_topk(
                    q, self.vectors, self.norms, valid,
                    k=k, metric=self.metric, chunk=chunk, mesh=self.mesh,
                    shard_axis=self.shard_axis, replica_axis=self.replica_axis,
                    mode=self.search_mode, recall_target=self.recall_target,
                )
            else:
                q = jax.device_put(jnp.asarray(pad_rows(queries, bb)), self._repl)
                vals, idxs = sharded_scored_topk(
                    q, self.vectors, self.norms, valid,
                    k=k, metric=self.metric, chunk=chunk, mesh=self.mesh,
                    shard_axis=self.shard_axis, mode=self.search_mode,
                    recall_target=self.recall_target,
                )
            vals, idxs = fetch_scores_slots(vals, idxs)
            vals, idxs = vals[:b], idxs[:b]
            out: List[List[SearchHit]] = []
            for rv, ri in zip(vals, idxs):
                hits = []
                for v, i in zip(rv, ri):
                    if not np.isfinite(v):
                        continue
                    id_ = self._slot_to_id[int(i)]
                    if id_ is not None:
                        hits.append((id_, float(v)))
                out.append(hits)
            return out

    # -- resharding (the reference's shard migration, shard.rs:925-1674) -------------

    def redistribute(self, new_mesh: Mesh, shard_capacity: Optional[int] = None) -> None:
        """Re-place the corpus on a different mesh (node join/leave): read back
        live rows and re-ingest under the new static block assignment."""
        with self._lock:
            ids, vecs = self.get_all()
            self.__init__(
                self._dim, mesh=new_mesh, metric=self.metric,
                storage_dtype=str(self.storage_dtype),
                shard_capacity=shard_capacity or self.shard_capacity,
                shard_axis=self.shard_axis, search_chunk=self.search_chunk,
                search_mode=self.search_mode, recall_target=self.recall_target,
                replica_axis=self.replica_axis,
            )
            if ids:
                self.add_batch(ids, vecs)

    # -- introspection ------------------------------------------------------------------

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        with self._lock:
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
            slots = np.asarray([s for _, s in items], dtype=np.int64)
            vecs = np.asarray(self.vectors, dtype=np.float32)[slots]
            return ids, vecs

    def get_stats(self) -> IndexStats:
        per_shard_live = [0] * self.n_shards
        for s in self._id_to_slot.values():
            per_shard_live[s // self.shard_capacity] += 1
        return IndexStats(
            point_count=len(self._id_to_slot),
            dimension=self._dim,
            capacity=self.capacity,
            kind=self.kind,
            memory_usage_mb=self.capacity * (self.storage_dtype.itemsize * self._dim + 5) / 1e6,
            extra={f"shard_{i}_points": float(c) for i, c in enumerate(per_shard_live)},
        )


# -----------------------------------------------------------------------------------
# Sharded IVF: centroids replicated, list capacity sharded across devices
# -----------------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("k", "nprobe", "metric", "mesh", "shard_axis",
                     "use_kernel", "replica_axis"),
)
def sharded_ivf_topk(
    queries: jax.Array,    # [B, D] f32, replicated
    centroids: jax.Array,  # [L, D] f32, replicated
    vecs: jax.Array,       # [L, C, D] sharded over axis 1 (within-list)
    norms: jax.Array,      # [L, C]    sharded over axis 1
    valid: jax.Array,      # [L, C]    sharded over axis 1
    k: int,
    nprobe: int,
    metric: str,
    mesh: Mesh,
    shard_axis: str = "shard",
    recip: jax.Array | None = None,  # [L, C] weight plane, sharded axis 1
    use_kernel: bool = False,        # probe kernel: needs recip and fill
    fill: jax.Array | None = None,     # [L] int32 per-DEVICE rows in use
                                       # (replicated; striped placement makes
                                       # every slice's watermark uniform)
    replica_axis: str | None = None,   # 2D (replica x shard) mesh: the query
                                       # batch splits over replica rows, each
                                       # row holding a full sharded corpus
                                       # copy — independent serving lanes, no
                                       # collective crosses the replica axis
) -> Tuple[jax.Array, jax.Array]:
    """SPMD IVF probe (the sharded twin of index/ivf.py::_ivf_topk).

    Sharding *within* each list's capacity (P(None, shard, None)) keeps the
    program uniform: every device scores the SAME top-nprobe lists over its
    1/S slice of each list — no ownership branching, no load skew from hot
    lists — then one all_gather merges per-device winners. Returns
    replicated (scores [B, k], global slots [B, k]) with
    slot = list * C_global + shard_id * C_local + pos.

    With ``use_kernel`` (angular metrics; requires the ``recip`` weight
    plane) each device scores its local list slices with the probe kernel
    (ops/ivf_pallas.py) instead of the XLA row gather.
    """
    n_shards = mesh.shape[shard_axis]
    c_global = vecs.shape[1]
    c_local = c_global // n_shards

    def spmd(q, cents, v, nrm, msk, *rest):
        b, _ = q.shape
        qp = prepare_queries(q, metric)
        probe = probe_lists(qp, cents, nprobe, metric)                # [B, P]

        if use_kernel:
            from grape_vector_db_tpu.ops.ivf_pallas import ivf_probe_scores

            scores = ivf_probe_scores(qp, probe, v, rest[0], fill=rest[1],
                                      fmt="bf16")            # [B, P, C/S]
            if metric == "cosine":
                scores = jnp.minimum(scores, 1.0)
            # validity/filter fold (the recip==0 sentinel already handles
            # deletes; msk additionally carries the caller's filter mask)
            scores = jnp.where(msk[probe], scores, -jnp.inf)
        else:
            cand_vecs = v[probe]      # [B, P, C/S, D]
            cand_norms = nrm[probe]   # [B, P, C/S]
            cand_valid = msk[probe]
            dots = rowwise_dots(qp, cand_vecs)                  # [B, P, C/S]
            if metric == "cosine":
                scores = jnp.minimum(dots / jnp.maximum(cand_norms, 1e-12), 1.0)
            elif metric == "dot":
                scores = dots
            else:
                q_sq = jnp.sum(qp * qp, axis=-1)[:, None, None]
                scores = -(q_sq - 2.0 * dots + cand_norms * cand_norms)
            scores = jnp.where(cand_valid, scores, -jnp.inf)

        p = probe.shape[1]
        shard_id = lax.axis_index(shard_axis)
        pos = jax.lax.broadcasted_iota(jnp.int32, (b, p, c_local), 2)
        gslot = (probe[:, :, None] * c_global + shard_id * c_local + pos
                 ).reshape(b, p * c_local)
        kk = min(k, p * c_local)
        vals, pos_k = lax.top_k(scores.reshape(b, p * c_local), kk)
        slots = jnp.take_along_axis(gslot, pos_k, axis=1)
        # One collective: merge every device's local winners.
        all_vals = lax.all_gather(vals, shard_axis, axis=1, tiled=True)
        all_slots = lax.all_gather(slots, shard_axis, axis=1, tiled=True)
        fvals, fslots = take_topk(all_vals, all_slots, min(k, all_vals.shape[1]))
        if fvals.shape[1] < k:
            pad = k - fvals.shape[1]
            fvals = jnp.pad(fvals, ((0, 0), (0, pad)), constant_values=-jnp.inf)
            fslots = jnp.pad(fslots, ((0, 0), (0, pad)))
        return fvals, fslots

    specs = [P(), P(), P(None, shard_axis, None), P(None, shard_axis),
             P(None, shard_axis)]
    operands = [queries, centroids, vecs, norms, valid]
    if use_kernel:
        specs += [P(None, shard_axis), P()]
        operands += [recip, fill]
    qspec = P(replica_axis, None) if replica_axis else P()
    specs[0] = qspec
    return jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=tuple(specs),
        out_specs=(qspec, qspec),
        check_vma=False,
    )(*operands)


@functools.partial(
    jax.jit,
    static_argnames=("k", "nprobe", "metric", "rescore", "mesh", "shard_axis",
                     "use_kernel", "replica_axis", "codes_kind"),
)
def sharded_ivf_int8_topk(
    queries: jax.Array,    # [B, D] f32, replicated
    centroids: jax.Array,  # [L, D] f32, replicated
    codes: jax.Array,      # [L, C, D] int8 — or [L, C, D/2] int8 packed
                           # nibbles when codes_kind="int4"; sharded axis 1
    scales: jax.Array,     # [L, C] f32 dequant scales, sharded over axis 1
    norms: jax.Array,      # [L, C] f32, sharded over axis 1
    valid: jax.Array,      # [L, C] bool, sharded over axis 1
    vecs: jax.Array | None,  # [L, C, D] bf16 shadow (rescore > 0) or None
    k: int,
    nprobe: int,
    metric: str,
    rescore: int,
    mesh: Mesh,
    shard_axis: str = "shard",
    factor: jax.Array | None = None,  # [L, C] weight plane, sharded axis 1
    use_kernel: bool = False,        # probe kernel: needs factor and fill
    fill: jax.Array | None = None,     # [L] int32 per-DEVICE rows in use
    replica_axis: str | None = None,   # 2D mesh: see sharded_ivf_topk
    codes_kind: str = "int8",          # "int8" | "int4" (packed nibbles)
) -> Tuple[jax.Array, jax.Array]:
    """SPMD quantized IVF probe: the sharded twin of index/ivf_int8.py
    (and, with ``codes_kind="int4"``, of index/ivf_int4.py).

    Each device scores its 1/S slice of every probed list from the
    quantized codes (int8 = half the HBM bytes of the bf16 probe, packed
    int4 = a quarter); with ``rescore > 0`` each device exactly rescores its
    local top-``rescore`` candidates against its bf16 shard BEFORE the
    all_gather, so the collective carries exact scores and the merge stays a
    single gather + top-k."""
    n_shards = mesh.shape[shard_axis]
    c_global = codes.shape[1]
    c_local = c_global // n_shards
    with_v = rescore > 0 and vecs is not None

    def spmd(q, cents, cd, sc, nrm, msk, *rest):
        rest = list(rest)
        fct = rest.pop(0) if use_kernel else None
        lfill = rest.pop(0) if use_kernel else None
        v = rest[0] if rest else None
        b, _ = q.shape
        qp = prepare_queries(q, metric)
        probe = probe_lists(qp, cents, nprobe, metric)                # [B, P]

        if use_kernel:
            from grape_vector_db_tpu.ops.ivf_pallas import ivf_probe_scores

            scores = ivf_probe_scores(qp, probe, cd, fct, fill=lfill,
                                      fmt=codes_kind)
            if metric == "cosine":
                scores = jnp.minimum(scores, 1.0)
            scores = jnp.where(msk[probe], scores, -jnp.inf)
        elif codes_kind == "int4":
            from grape_vector_db_tpu.ops.int4 import unpack_int4

            if metric == "cosine":
                f = sc[probe] / jnp.maximum(nrm[probe], 1e-12)
            else:
                f = sc[probe]
            f = jnp.where(msk[probe], f, 0.0)
            dots = rowwise_dots(qp, unpack_int4(cd[probe]),
                                q_dtype=jnp.bfloat16)
            scores = dots * f + jnp.where(f == 0.0, -1e9, 0.0)
        else:
            if metric == "cosine":
                f = sc[probe] / jnp.maximum(nrm[probe], 1e-12)
            else:
                f = sc[probe]
            f = jnp.where(msk[probe], f, 0.0)
            dots = rowwise_dots(qp, cd[probe])              # [B, P, C/S]
            scores = dots * f + jnp.where(f == 0.0, -1e9, 0.0)

        p = probe.shape[1]
        shard_id = lax.axis_index(shard_axis)
        flat = scores.reshape(b, p * c_local)

        if with_v:
            r = min(rescore, p * c_local)
            rv, ridx = lax.top_k(flat, r)                      # [B, R] local
            pl_ = ridx // c_local
            pp = ridx % c_local
            lists = jnp.take_along_axis(probe, pl_, axis=1)    # [B, R]
            cvecs = v[lists, pp]                               # [B, R, D]
            cn = nrm[lists, pp]
            live = jnp.take_along_axis(
                msk[probe].reshape(b, p * c_local), ridx, axis=1)
            d2 = rowwise_dots(qp, cvecs)
            if metric == "cosine":
                exact = jnp.minimum(d2 / jnp.maximum(cn, 1e-12), 1.0)
            else:
                exact = d2
            exact = jnp.where((rv > -1e8) & live & (cn > 0), exact, -jnp.inf)
            gslot = lists * c_global + shard_id * c_local + pp
            vals, slots = exact, gslot
        else:
            pos = jax.lax.broadcasted_iota(jnp.int32, (b, p, c_local), 2)
            gslot = (probe[:, :, None] * c_global + shard_id * c_local + pos
                     ).reshape(b, p * c_local)
            kk = min(k, p * c_local)
            vals, pos_k = lax.top_k(flat, kk)
            vals = jnp.where(vals > -1e8, vals, -jnp.inf)
            slots = jnp.take_along_axis(gslot, pos_k, axis=1)

        all_vals = lax.all_gather(vals, shard_axis, axis=1, tiled=True)
        all_slots = lax.all_gather(slots, shard_axis, axis=1, tiled=True)
        fvals, fslots = take_topk(all_vals, all_slots,
                                  min(k, all_vals.shape[1]))
        if fvals.shape[1] < k:
            pad = k - fvals.shape[1]
            fvals = jnp.pad(fvals, ((0, 0), (0, pad)),
                            constant_values=-jnp.inf)
            fslots = jnp.pad(fslots, ((0, 0), (0, pad)))
        return fvals, fslots

    cell = P(None, shard_axis, None)
    cellv = P(None, shard_axis)
    specs = [P(), P(), cell, cellv, cellv, cellv]
    operands = [queries, centroids, codes, scales, norms, valid]
    if use_kernel:
        specs += [P(None, shard_axis), P()]
        operands += [factor, fill]
    if with_v:
        specs.append(cell)
        operands.append(vecs)
    qspec = P(replica_axis, None) if replica_axis else P()
    specs[0] = qspec
    return jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=tuple(specs),
        out_specs=(qspec, qspec),
        check_vma=False,
    )(*operands)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "mesh", "shard_axis", "replica_axis",
                     "codes_kind", "chunk_lists", "rescore"),
)
def sharded_ivf_exhaustive_topk(
    queries: jax.Array,   # [B, D] f32 (replica-split rows on 2D meshes)
    data: jax.Array,      # [L, C, D] bf16|int8 or [L, C, D/2] packed int4;
                          # sharded over axis 1
    scales: jax.Array | None,  # [L, C] f32 (quantized kinds), sharded axis 1
    norms: jax.Array,     # [L, C] f32, sharded axis 1
    allowed: jax.Array,   # [L, C] bool = validity AND filter mask, axis 1
    vecs: jax.Array | None,    # [L, C, D] bf16 exact shadow (rescore) or None
    k: int,
    metric: str,
    mesh: Mesh,
    shard_axis: str = "shard",
    replica_axis: str | None = None,
    codes_kind: str = "bf16",   # "bf16" | "int8" | "int4"
    chunk_lists: int = 8,
    rescore: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """SPMD exhaustive masked IVF scan — exact filtered search at any
    selectivity across the mesh (the sharded twin of
    ops/ivf_scan.py::ivf_exhaustive_masked_topk).

    Phase 1 is embarrassingly SPMD: each device streams its local [L, C/S]
    slice of every list once (chunked einsums) and reduces each list to
    its masked score maximum; one ``lax.pmax`` over the shard axis makes the
    [B, L] plane global, so every device selects the SAME top-``P`` lists
    (deterministic iterative selection — no cross-device divergence).
    Phase 2 scores each device's local cells of those lists and merges local
    winners with the same single all_gather + top-k the probe path uses.
    Exactness argument as in ops/ivf_scan.py: if a true top-k row's list were
    outside the top-k lists ranked by masked max, at least k rows in
    better-ranked lists would beat it. With ``rescore > 0`` and a bf16
    shadow, each device exactly rescores its local top-``rescore`` BEFORE the
    collective (same pre-collective trick as ``sharded_ivf_int8_topk``).

    Reference parity: filtering.rs:374-400 — the reference post-intersects a
    full scan, always exact; this keeps that contract on the sharded kinds.
    """
    n_shards = mesh.shape[shard_axis]
    c_global = data.shape[1]
    c_local = c_global // n_shards
    l = data.shape[0]
    with_v = rescore > 0 and vecs is not None

    def dequant(dd):
        if codes_kind == "int4":
            from grape_vector_db_tpu.ops.int4 import unpack_int4

            return unpack_int4(dd).astype(jnp.bfloat16)
        return dd.astype(jnp.bfloat16)

    def cell_weight(sc, nrm, msk):
        """Per-cell score weight, matching the probe paths' arithmetic:
        quantized kinds fold dequant scale / norm; bf16 folds 1/norm.
        0 = disallowed/invalid."""
        if codes_kind == "bf16":
            w = (1.0 / jnp.maximum(nrm, 1e-12) if metric == "cosine"
                 else jnp.ones_like(nrm))
        elif metric == "cosine":
            w = sc / jnp.maximum(nrm, 1e-12)
        else:
            w = sc
        return jnp.where(msk, w, 0.0)

    def spmd(q, dd_all, sc_all, nrm_all, msk_all, *rest):
        v = rest[0] if with_v else None
        b = q.shape[0]
        qp = prepare_queries(q, metric)
        qb = qp.astype(jnp.bfloat16)
        w_all = cell_weight(sc_all, nrm_all, msk_all)       # [L, C/S]

        # Phase 1: stream the local slice once, per-list masked max.
        nch = l // chunk_lists
        d3 = dd_all.reshape((nch, chunk_lists) + tuple(dd_all.shape[1:]))
        w3 = w_all.reshape(nch, chunk_lists, c_local)

        def body(carry, xs):
            dd, ww = xs
            cand = dequant(dd)                              # [CL, C/S, D]
            dots = jnp.einsum("bd,lcd->blc", qb, cand,
                              preferred_element_type=jnp.float32)
            sc_ = jnp.where(ww[None] == 0.0, -jnp.inf, dots * ww[None])
            return carry, sc_.max(axis=2)                   # [B, CL]

        _, lmax = lax.scan(body, None, (d3, w3))            # [nch, B, CL]
        lmax = jnp.moveaxis(lmax, 0, 1).reshape(b, l)       # [B, L] local
        lmax = lax.pmax(lmax, shard_axis)                   # [B, L] global

        from grape_vector_db_tpu.ops.distance import _select_topk
        from grape_vector_db_tpu.ops.ivf_scan import probe_dup_mask

        p = min(l, max(k, 8))
        _, probe = _select_topk(lmax, p, "exact", 0.99)     # [B, P] identical
        probe = probe.astype(jnp.int32)                     # on every device
        dup = probe_dup_mask(probe)

        # Phase 2: score this device's local cells of the selected lists.
        cand = dequant(dd_all[probe])                       # [B, P, C/S, D]
        dots = rowwise_dots(qb, cand, q_dtype=jnp.bfloat16)
        w = w_all[probe]                                    # [B, P, C/S]
        scores = jnp.where((w == 0.0) | dup[:, :, None], -jnp.inf, dots * w)
        if codes_kind == "bf16" and metric == "cosine":
            scores = jnp.minimum(scores, 1.0)

        shard_id = lax.axis_index(shard_axis)
        flat = scores.reshape(b, p * c_local)
        if with_v:
            r = min(rescore, p * c_local)
            rv, ridx = lax.top_k(flat, r)
            pl_ = ridx // c_local
            pp = ridx % c_local
            lists = jnp.take_along_axis(probe, pl_, axis=1)
            cvecs = v[lists, pp]                            # [B, R, D]
            cn = nrm_all[lists, pp]
            d2 = rowwise_dots(qp, cvecs)
            if metric == "cosine":
                exact = jnp.minimum(d2 / jnp.maximum(cn, 1e-12), 1.0)
            else:
                exact = d2
            vals = jnp.where(jnp.isfinite(rv) & (cn > 0), exact, -jnp.inf)
            slots = lists * c_global + shard_id * c_local + pp
        else:
            pos = lax.broadcasted_iota(jnp.int32, (b, p, c_local), 2)
            gslot = (probe[:, :, None] * c_global + shard_id * c_local + pos
                     ).reshape(b, p * c_local)
            kk = min(k, p * c_local)
            vals, pos_k = lax.top_k(flat, kk)
            slots = jnp.take_along_axis(gslot, pos_k, axis=1)

        all_vals = lax.all_gather(vals, shard_axis, axis=1, tiled=True)
        all_slots = lax.all_gather(slots, shard_axis, axis=1, tiled=True)
        fvals, fslots = take_topk(all_vals, all_slots,
                                  min(k, all_vals.shape[1]))
        if fvals.shape[1] < k:
            pad = k - fvals.shape[1]
            fvals = jnp.pad(fvals, ((0, 0), (0, pad)),
                            constant_values=-jnp.inf)
            fslots = jnp.pad(fslots, ((0, 0), (0, pad)))
        return fvals, fslots

    cell = P(None, shard_axis, None)
    cellv = P(None, shard_axis)
    qspec = P(replica_axis, None) if replica_axis else P()
    specs = [qspec, cell, cellv, cellv, cellv]
    operands = [queries, data,
                scales if scales is not None
                else jnp.zeros((l, c_global), jnp.float32),
                norms, allowed]
    if with_v:
        specs.append(cell)
        operands.append(vecs)
    return jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=tuple(specs),
        out_specs=(qspec, qspec),
        check_vma=False,
    )(*operands)


def sharded_ivf_compact_topk(
    queries: jax.Array,   # [B, D] f32 (replica-split rows on 2D meshes)
    data: jax.Array,      # [L, C, D] bf16|int8 or [L, C, D/2] int4, axis-1 sharded
    scales: jax.Array | None,  # [L, C] f32 (quantized kinds), axis-1 sharded
    norms: jax.Array,     # [L, C] f32, axis-1 sharded
    cells: jax.Array,     # [S, R] int32 LOCAL flat ids l*(C/S)+pos; -1 pad
    k: int,
    metric: str,
    mesh: Mesh,
    shard_axis: str = "shard",
    replica_axis: str | None = None,
    codes_kind: str = "bf16",
    chunk_rows: int = 131_072,
) -> Tuple[jax.Array, jax.Array]:
    """SPMD compact gather-scan — the sharded twin of
    ops/ivf_scan.py::ivf_compact_masked_topk.

    The streaming SPMD scan reads every device's whole local slice per
    batch; this tier instead gathers each device's ALLOWED rows once (the
    filter mask is query-independent) and exact-scans just those, so the
    cost is proportional to selectivity. Embarrassingly SPMD: no
    cross-device work at all until the single all_gather merge of local
    top-k — the same collective the probe path uses. The host builds
    ``cells`` per shard from the (list, pos)-addressed filter mask, padded
    to a shared power-of-two bucket so every device runs the same program.

    Reference parity: filtering.rs:374-400 (always-exact filtered search),
    at selectivity-proportional cost across the mesh.
    """
    n_shards = mesh.shape[shard_axis]
    c_global = data.shape[1]
    c_local = c_global // n_shards
    l = data.shape[0]

    def dequant(dd):
        if codes_kind == "int4":
            from grape_vector_db_tpu.ops.int4 import unpack_int4

            return unpack_int4(dd).astype(jnp.bfloat16)
        return dd.astype(jnp.bfloat16)

    def spmd(q, dd_all, sc_all, nrm_all, cl):
        from grape_vector_db_tpu.ops.ivf_scan import compact_scan_core

        qp = prepare_queries(q, metric)
        qb = qp.astype(jnp.bfloat16)
        cl = cl.reshape(-1)                                 # [R] local ids
        safe = jnp.maximum(cl, 0)
        flat = dd_all.reshape((l * c_local,) + tuple(dd_all.shape[2:]))
        rows = flat[safe]                                   # [R, ...]
        nrm = nrm_all.reshape(-1)[safe]
        ok = cl >= 0
        if codes_kind == "bf16":
            w = (1.0 / jnp.maximum(nrm, 1e-12) if metric == "cosine"
                 else jnp.ones_like(nrm))
        else:
            sc_ = sc_all.reshape(-1)[safe]
            w = (sc_ / jnp.maximum(nrm, 1e-12) if metric == "cosine"
                 else sc_)
        w = jnp.where(ok, w, 0.0)

        # identical rows=0-weight scoring core as the single-chip tier;
        # dequant here matches the streaming twin's arithmetic
        if codes_kind == "int4":
            fmt = "int4"
        elif codes_kind == "int8":
            fmt = "int8"
        else:
            fmt = "bf16"
        vals, idx = compact_scan_core(qb, rows, w, k=k, fmt=fmt,
                                      chunk_rows=chunk_rows)
        kk = vals.shape[1]
        cellv = jnp.take(cl, idx)                           # local flat id
        shard_id = lax.axis_index(shard_axis)
        ll = jnp.maximum(cellv, 0) // c_local
        pos = jnp.maximum(cellv, 0) % c_local
        slots = ll * c_global + shard_id * c_local + pos
        if metric == "cosine":
            vals = jnp.minimum(vals, 1.0)
        vals = jnp.where(jnp.isfinite(vals) & (cellv >= 0), vals, -jnp.inf)

        all_vals = lax.all_gather(vals, shard_axis, axis=1, tiled=True)
        all_slots = lax.all_gather(slots, shard_axis, axis=1, tiled=True)
        fvals, fslots = take_topk(all_vals, all_slots,
                                  min(k, all_vals.shape[1]))
        if fvals.shape[1] < k:
            pad = k - fvals.shape[1]
            fvals = jnp.pad(fvals, ((0, 0), (0, pad)),
                            constant_values=-jnp.inf)
            fslots = jnp.pad(fslots, ((0, 0), (0, pad)))
        return fvals, fslots

    cell = P(None, shard_axis, None)
    cellv = P(None, shard_axis)
    qspec = P(replica_axis, None) if replica_axis else P()
    operands = [queries, data,
                scales if scales is not None
                else jnp.zeros((l, c_global), jnp.float32),
                norms, cells]
    specs = [qspec, cell, cellv, cellv, P(shard_axis, None)]
    return jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=tuple(specs),
        out_specs=(qspec, qspec),
        check_vma=False,
    )(*operands)


class ShardedIvfIndex(IvfDeviceIndex):
    """Mesh-sharded IVF: the engine that carries the sublinear multi-chip
    story. Same VectorIndex/IvfDeviceIndex contract and
    host bookkeeping; the device arrays shard each list's capacity across the
    ``shard`` mesh axis and search runs as one shard_map with a single
    all_gather merge (scatter-gather of shard.rs:759-901, SPMD for real)."""

    kind = "sharded_ivf"
    supports_mask = True
    # Exact filtered search at any selectivity: the SPMD exhaustive masked
    # scan (sharded_ivf_exhaustive_topk) — each device streams its local
    # list slices once, pmax makes the per-list plane global, and the
    # k-list phase 2 merges through the same all_gather as the probe.
    supports_exhaustive_mask = True

    def __init__(
        self,
        dimension: int,
        mesh: Optional[Mesh] = None,
        shard_axis: str = "shard",
        replica_axis: Optional[str] = None,
        **kwargs,
    ):
        self.mesh = mesh if mesh is not None else make_mesh(shard_axis=shard_axis)
        self.shard_axis = shard_axis
        self.replica_axis = (
            replica_axis if replica_axis in self.mesh.axis_names else None
        )
        self.n_replicas = (
            self.mesh.shape[self.replica_axis] if self.replica_axis else 1
        )
        self.n_shards = self.mesh.shape[shard_axis]
        self._cell_sharding = NamedSharding(self.mesh, P(None, shard_axis, None))
        self._cellv_sharding = NamedSharding(self.mesh, P(None, shard_axis))
        self._repl = NamedSharding(self.mesh, P())
        super().__init__(dimension, **kwargs)

    def _shard_cap(self, cap: int) -> int:
        """Round list capacity so it splits evenly across the shard axis."""
        unit = self.n_shards
        return ((cap + unit - 1) // unit) * unit

    def _alloc(self, cap: int) -> None:
        cap = self._shard_cap(cap)
        self.list_cap = cap
        l, d = self.nlist, self._dim
        self.vecs = jax.device_put(
            jnp.zeros((l, cap, d), dtype=self.storage_dtype), self._cell_sharding)
        self.norms = jax.device_put(
            jnp.zeros((l, cap), dtype=jnp.float32), self._cellv_sharding)
        self.valid = jax.device_put(
            jnp.zeros((l, cap), dtype=jnp.bool_), self._cellv_sharding)
        self.recip = jax.device_put(
            jnp.zeros((l, cap), dtype=jnp.float32), self._cellv_sharding)

    def _phys_pos(self, n: int) -> int:
        """Stripe logical insert order across the shard axis: row n lands on
        device n % S at local column n // S. Sequential placement would fill
        device 0's slice first — SPMD runs in lockstep, so the fullest slice
        gates every query and the per-device ragged fetch would never help.
        Striped, every slice's watermark is ceil(n/S) and the ragged probe
        skips the same padding on every device."""
        s = self.n_shards
        return (n % s) * (self.list_cap // s) + n // s

    def _list_fill(self) -> jax.Array:
        """Per-DEVICE rows in use, replicated [L] (striping makes every
        device's watermark uniform to within one row)."""
        if self._fill_cache is None:
            per_dev = -(-self._next_pos // self.n_shards)  # ceil
            self._fill_cache = jax.device_put(
                jnp.asarray(per_dev, dtype=jnp.int32), self._repl)
        return self._fill_cache

    def train(self, sample, seed: int = 0) -> None:
        super().train(sample, seed=seed)
        self.centroids = jax.device_put(self.centroids, self._repl)

    def _place_queries(self, qp: np.ndarray) -> jax.Array:
        """Query placement: split over the replica axis on a 2D mesh (each
        replica row serves its slice of the batch), replicated otherwise."""
        if not self.replica_axis:
            return jax.device_put(jnp.asarray(qp), self._repl)
        r = self.n_replicas
        bb = -(-qp.shape[0] // r) * r
        if bb != qp.shape[0]:
            qp = np.concatenate(
                [qp, np.zeros((bb - qp.shape[0], qp.shape[1]), qp.dtype)])
        return jax.device_put(
            jnp.asarray(qp),
            NamedSharding(self.mesh, P(self.replica_axis, None)))

    def _main_topk(self, qp: np.ndarray, k: int, mask, nprobe=None):
        valid = self.valid
        if mask is not None:
            valid = jnp.logical_and(
                valid,
                jax.device_put(jnp.asarray(mask[0]), self._cellv_sharding),
            )
        q_dev = self._place_queries(qp)
        return sharded_ivf_topk(
            q_dev, self.centroids, self.vecs, self.norms, valid,
            k=k, nprobe=min(nprobe or self.nprobe, self.nlist),
            metric=self.metric,
            mesh=self.mesh, shard_axis=self.shard_axis,
            recip=self.recip, use_kernel=self._use_kernel,
            fill=self._list_fill() if self._use_kernel else None,
            replica_axis=self.replica_axis,
        )

    def _sharded_scan_operands(self, k: int):
        """(data, scales, fmt, rescore vecs, rescore count) for the SPMD
        exhaustive masked scan (subclass seam — quantized layouts swap in
        their code planes and the pre-collective exact rescore)."""
        return self.vecs, None, "bf16", None, 0

    def _exhaustive_topk(self, qp: np.ndarray, k: int, mask):
        """Exact masked top-k over EVERY list across the mesh — overrides
        the single-chip engines with their SPMD twins. Routed like the
        single-chip tier: compact gather-scan of just the allowed rows when
        each device's share fits the HBM budget (cost ~ selectivity), else
        the streaming scan (each device reads its whole local slice; one
        pmax + one all_gather)."""
        from grape_vector_db_tpu.ops.ivf_scan import default_chunk_lists
        from grape_vector_db_tpu.utils.buckets import next_bucket

        data, scales, fmt, vecs, rescore = self._sharded_scan_operands(k)

        # -- compact tier: per-shard allowed cells from the host mask
        m = np.asarray(mask[0])
        s, cg = self.n_shards, self.list_cap
        cl_ = cg // s
        m3 = m.reshape(m.shape[0], s, cl_)                # [L, S, C/S]
        counts = m3.sum(axis=(0, 2))
        r_max = int(counts.max())
        cdata, cscales, ckind = data, scales, fmt
        if vecs is not None:
            # quantized kind keeping a bf16 shadow: compact gathers full
            # precision (R is budget-bounded), scores exact (see
            # index/ivf.py _exhaustive_topk)
            cdata, cscales, ckind = vecs, None, "bf16"
        row_bytes = (int(np.prod(cdata.shape[2:]))
                     * cdata.dtype.itemsize)
        rp = next_bucket(max(r_max, 1), base=2048)
        q_dev = self._place_queries(qp)
        if r_max > 0 and rp * row_bytes <= self.compact_max_bytes:
            cells = np.full((s, rp), -1, dtype=np.int32)
            for si in range(s):
                loc = np.flatnonzero(m3[:, si, :].reshape(-1))
                cells[si, :loc.size] = loc.astype(np.int32)
            cells_d = jax.device_put(
                jnp.asarray(cells),
                NamedSharding(self.mesh, P(self.shard_axis, None)))
            return sharded_ivf_compact_topk(
                q_dev, cdata, cscales, self.norms, cells_d,
                k=k, metric=self.metric, mesh=self.mesh,
                shard_axis=self.shard_axis,
                replica_axis=self.replica_axis, codes_kind=ckind,
                chunk_rows=min(131_072, rp))

        allowed = jnp.logical_and(
            self.valid,
            jax.device_put(jnp.asarray(mask[0]), self._cellv_sharding))
        return sharded_ivf_exhaustive_topk(
            q_dev, data, scales, self.norms, allowed, vecs,
            k=k, metric=self.metric, mesh=self.mesh,
            shard_axis=self.shard_axis, replica_axis=self.replica_axis,
            codes_kind=fmt,
            chunk_lists=default_chunk_lists(
                self.nlist, self.list_cap // self.n_shards),
            rescore=rescore)


class ShardedInt8IvfIndex(ShardedIvfIndex, Int8IvfDeviceIndex):
    """Mesh-sharded int8 IVF: the capacity+bandwidth engine across chips.

    Combines ShardedIvfIndex's within-list capacity sharding (uniform SPMD,
    one all_gather merge) with Int8IvfDeviceIndex's int8-resident lists —
    the multi-chip configuration that carries N x ~16M rows at half the
    per-list HBM traffic. With ``keep_bf16`` each device exactly rescores
    its local winners BEFORE the collective, so the gather carries exact
    scores (same wire cost, exact ranking)."""

    kind = "sharded_ivf_int8"
    supports_mask = True
    codes_kind = "int8"

    def _sharded_scan_operands(self, k: int):
        r = self._rescore_count(k)
        return (self.codes, self.scales, self.codes_kind,
                self.vecs if r else None, r)

    def _alloc(self, cap: int) -> None:
        cap = self._shard_cap(cap)
        self.list_cap = cap
        l, d = self.nlist, self._dim
        # capacity config: the bf16 plane must never be materialized, even
        # transiently — at target fill it alone would OOM the mesh
        self.vecs = (jax.device_put(
            jnp.zeros((l, cap, d), dtype=self.storage_dtype),
            self._cell_sharding) if self.keep_bf16 else None)
        self.norms = jax.device_put(
            jnp.zeros((l, cap), dtype=jnp.float32), self._cellv_sharding)
        self.valid = jax.device_put(
            jnp.zeros((l, cap), dtype=jnp.bool_), self._cellv_sharding)
        self.recip = None  # the rescore folds norms on the fly
        self.codes = jax.device_put(
            jnp.zeros((l, cap, d), dtype=jnp.int8), self._cell_sharding)
        self.scales = jax.device_put(
            jnp.zeros((l, cap), dtype=jnp.float32), self._cellv_sharding)
        # the probe kernel's weight plane (the XLA probe folds scale, norm
        # and validity on the fly instead); 4 bytes per cell
        self.factor = jax.device_put(
            jnp.zeros((l, cap), dtype=jnp.float32), self._cellv_sharding)

    def _scatter_rows(self, lists_p, pos_p, vecs_p, norms_p) -> None:
        if self.keep_bf16:
            IvfDeviceIndex._scatter_rows(self, lists_p, pos_p, vecs_p, norms_p)
        else:
            self.norms, self.valid = _nv_scatter(
                self.norms, self.valid, lists_p, pos_p, norms_p)
        self.codes, self.scales, self.factor = _int8_cell_scatter(
            self.codes, self.scales, self.factor, lists_p, pos_p, vecs_p,
            norms_p, metric=self.metric)

    def _invalidate_cells(self, lists_p, pos_p) -> None:
        IvfDeviceIndex._invalidate_cells(self, lists_p, pos_p)
        self.factor = _factor_invalidate(self.factor, lists_p, pos_p)

    def _main_topk(self, qp: np.ndarray, k: int, mask, nprobe=None):
        valid = self.valid
        if mask is not None:
            valid = jnp.logical_and(
                valid,
                jax.device_put(jnp.asarray(mask[0]), self._cellv_sharding),
            )
        q_dev = self._place_queries(qp)
        r = self._rescore_count(k)
        return sharded_ivf_int8_topk(
            q_dev, self.centroids, self.codes, self.scales, self.norms,
            valid, self.vecs if r else None,
            k=k, nprobe=min(nprobe or self.nprobe, self.nlist),
            metric=self.metric, rescore=r,
            mesh=self.mesh, shard_axis=self.shard_axis,
            factor=self.factor, use_kernel=self._use_kernel,
            fill=self._list_fill() if self._use_kernel else None,
            replica_axis=self.replica_axis,
            codes_kind=self.codes_kind,
        )


class ShardedInt4IvfIndex(ShardedInt8IvfIndex, Int4IvfDeviceIndex):
    """Mesh-sharded packed-int4 IVF: the top capacity rung across chips.

    ShardedInt8IvfIndex's within-list capacity sharding and pre-collective
    exact rescore, over Int4IvfDeviceIndex's packed-nibble lists — a QUARTER
    of the bf16 HBM bytes per probed list (N x ~32M rows at D=768 across the
    mesh in the codes-only config). The SPMD probe streams [C/S, D/2] packed-byte
    blocks per device and unpacks split-plane (ops/int4.py)."""

    kind = "sharded_ivf_int4"
    codes_kind = "int4"

    def _alloc(self, cap: int) -> None:
        if self._dim % 2:
            raise DimensionMismatchError(
                f"ivf_int4 needs an even dim, got {self._dim}")
        super()._alloc(cap)
        l = self.nlist
        self.codes = jax.device_put(
            jnp.zeros((l, self.list_cap, self._dim // 2), dtype=jnp.int8),
            self._cell_sharding)

    def _scatter_rows(self, lists_p, pos_p, vecs_p, norms_p) -> None:
        if self.keep_bf16:
            IvfDeviceIndex._scatter_rows(self, lists_p, pos_p, vecs_p, norms_p)
        else:
            self.norms, self.valid = _nv_scatter(
                self.norms, self.valid, lists_p, pos_p, norms_p)
        self.codes, self.scales, self.factor = _int4_cell_scatter(
            self.codes, self.scales, self.factor, lists_p, pos_p, vecs_p,
            norms_p, metric=self.metric)
