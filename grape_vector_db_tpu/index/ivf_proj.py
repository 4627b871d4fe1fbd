"""ProjectedInt8IvfIndex — PCA-projected int8 IVF: the matmul-friendly
capacity tier beyond int8's 768 B/row.

Why not PQ for this: the classic LUT/ADC scan is a per-candidate table
*gather*, while a projected int8 probe stays a dense dot per row. The way to
shrink bytes/row further is to shrink the *dimension*, not the per-dim code:
project rows onto the
corpus's top-R principal directions (uncentered PCA — preserves dot/cosine
structure) and run the whole int8 engine at dim R. Everything downstream —
spherical k-means, the probe kernel, int8 quantization,
masked search — is inherited unchanged at dimension R; queries pay one [D, R]
matmul.

At R=384: ~424 B/row resident (codes + scales + factor + norms), i.e. ~2x the
rows/device of the 768-d int8 engine, with the same probe kernel.

Reference parity: this plays the capacity role of FaissIndexType::IvfPq
(index.rs:313-327) whose trained PQ the reference never searched with; the
projection is the OPQ-style rotation done the matmul-friendly way.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grape_vector_db_tpu.errors import DimensionMismatchError
from grape_vector_db_tpu.index.ivf_int4 import Int4IvfDeviceIndex
from grape_vector_db_tpu.index.ivf_int8 import Int8IvfDeviceIndex

__all__ = ["ProjectedInt8IvfIndex", "ProjectedInt4IvfIndex",
           "ShardedProjectedInt8IvfIndex", "ShardedProjectedInt4IvfIndex"]


@functools.partial(jax.jit, static_argnames=("r",))
def _fit_projection(sample: jax.Array, r: int) -> Tuple[jax.Array, jax.Array]:
    """Top-r eigenvectors of the uncentered second moment E[xx^T], plus the
    retained-energy fraction (sum of the top-r eigenvalues over the total).

    Uncentered (no mean subtraction) so that dot products — and therefore
    cosine ranking — are preserved on the retained subspace: for P spanning
    the top eigenspace, x.y ~= (P^T x).(P^T y). The energy fraction is the
    build-time tier-choice signal: what the projection drops is lost before
    any rescore sees it, so flat-spectrum corpora (low energy) should use
    full-dim int4 at equal bytes instead.
    """
    cov = jax.lax.dot_general(sample, sample, (((0,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    evals, evecs = jnp.linalg.eigh(cov)      # ascending eigenvalues
    evals = jnp.maximum(evals, 0.0)          # clip fp noise on near-zeros
    energy = evals[-r:].sum() / jnp.maximum(evals.sum(), 1e-30)
    return evecs[:, ::-1][:, :r], energy     # [D, r] top-r first, scalar


class ProjectedInt8IvfIndex(Int8IvfDeviceIndex):
    kind = "ivf_int8_proj"

    # Below this retained-energy fraction the projection loses recall that
    # no rescore recovers — warn and point at full-dim int4.
    ENERGY_WARN = 0.9

    def __init__(self, dimension: int, proj_dim: int = 384,
                 min_energy: float = 0.0, **kwargs):
        if proj_dim >= dimension:
            raise ValueError(
                f"proj_dim {proj_dim} must be < dimension {dimension}")
        if proj_dim % 128:
            raise ValueError(
                f"proj_dim {proj_dim} must be 128-aligned (the probe "
                f"kernel's power-of-two column tiles)")
        self.full_dim = dimension
        self.proj_dim = proj_dim
        self.min_energy = min_energy              # refuse-to-build floor
        self.proj_energy: Optional[float] = None  # retained energy at fit
        self.proj: Optional[jax.Array] = None     # [D, R] f32
        super().__init__(proj_dim, **kwargs)      # the engine runs at R

    # The external VectorIndex contract speaks full-dim vectors.
    @property
    def dimension(self) -> int:
        return self.full_dim

    # -- projection -------------------------------------------------------------

    def _project(self, vectors: np.ndarray) -> np.ndarray:
        return np.asarray(
            jnp.asarray(vectors, dtype=jnp.float32) @ self.proj)

    def _maybe_fit(self, sample: np.ndarray) -> None:
        if self.proj is not None:
            return
        proj, energy = _fit_projection(
            jnp.asarray(sample, dtype=jnp.float32), self.proj_dim)
        energy = float(np.asarray(energy))
        if energy < self.min_energy:
            raise ValueError(
                f"{self.kind}: sample retains only {energy:.3f} of spectral "
                f"energy at proj_dim={self.proj_dim} (< min_energy="
                f"{self.min_energy}) — projection loss at this level is not "
                f"rescore-recoverable; use full-dim kind='ivf_int4' at equal "
                f"bytes/row, or raise proj_dim")
        if energy < self.ENERGY_WARN:
            import warnings

            warnings.warn(
                f"{self.kind}: flat-spectrum corpus — the {self.proj_dim}-d "
                f"projection retains only {energy:.3f} of spectral energy "
                f"(< {self.ENERGY_WARN}); expect unrecoverable recall "
                f"loss. Prefer "
                f"full-dim kind='ivf_int4' at equal bytes/row, or raise "
                f"proj_dim.",
                RuntimeWarning, stacklevel=3)
        self.proj = proj
        self.proj_energy = energy

    # -- training / mutation ------------------------------------------------------

    def train(self, sample: np.ndarray, seed: int = 0) -> None:
        sample = np.asarray(sample, dtype=np.float32)
        if sample.shape[1] == self._dim and self.proj is not None:
            # already-projected rows (the parent's auto-train pools the
            # overflow region, which holds projected vectors)
            super().train(sample, seed=seed)
            return
        if sample.shape[1] != self.full_dim:
            raise DimensionMismatchError(self.full_dim, sample.shape[1])
        self._maybe_fit(sample)
        super().train(self._project(sample), seed=seed)

    def add_batch(self, ids, vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.full_dim:
            raise DimensionMismatchError(self.full_dim,
                                         vectors.shape[1] if vectors.ndim == 2
                                         else -1)
        # The projection fits on the first batch (refit via optimize());
        # quality tracks how representative that sample is — for bulk loads
        # call train() with a corpus sample first.
        self._maybe_fit(vectors)
        super().add_batch(ids, self._project(vectors))

    def _place(self, ids, vectors: np.ndarray) -> None:
        # optimize() re-places full-dim rows from get_all(); project them.
        if vectors.shape[1] == self.full_dim:
            vectors = self._project(vectors)
        super()._place(ids, vectors)

    def clear(self) -> None:
        super().clear()
        self.proj = None
        self.proj_energy = None

    def optimize(self) -> None:
        """Refit projection + centroids on the full corpus and repack (the
        parent's optimize would size lists with full-dim rows against R-dim
        centroids, so the projection step is explicit here)."""
        with self._lock:
            ids, vecs = self.get_all()          # full-dim (back-projected)
            if len(ids) < self.nlist:
                return
            self.clear()
            self.train(vecs)                    # refits projection + centroids
            pv = self._project(vecs)
            from grape_vector_db_tpu.ops.kmeans import assign_clusters
            from grape_vector_db_tpu.utils.buckets import next_bucket

            counts = np.bincount(
                np.asarray(assign_clusters(jnp.asarray(pv), self.centroids,
                                           mode=self._kmeans_mode)),
                minlength=self.nlist,
            )
            need = int(counts.max())
            if need > self.list_cap:
                self.list_cap = next_bucket(int(need * 1.25) + 1, base=128)
                self._alloc(self.list_cap)
            self._place(ids, pv)

    # -- search -------------------------------------------------------------------

    def search_batch(self, queries: np.ndarray, k: int,
                     mask=None, nprobe=None,
                     exhaustive: bool = False) -> List[List]:
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.full_dim:
            raise DimensionMismatchError(self.full_dim,
                                         queries.shape[1] if queries.ndim == 2
                                         else -1)
        if self.proj is None:
            return super().search_batch(queries[:, :self._dim], k, mask=mask,
                                        nprobe=nprobe, exhaustive=exhaustive)
        return super().search_batch(self._project(queries), k, mask=mask,
                                    nprobe=nprobe, exhaustive=exhaustive)

    # -- introspection (back-project to the caller's space) -----------------------

    def _back(self, rows_r: np.ndarray) -> np.ndarray:
        if self.proj is None:
            out = np.zeros((rows_r.shape[0], self.full_dim), np.float32)
            out[:, :rows_r.shape[1]] = rows_r
            return out
        return np.asarray(jnp.asarray(rows_r) @ self.proj.T)

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        v = super().get_vector(id_)
        if v is None:
            return None
        return self._back(v[None, :])[0]

    def get_all(self) -> Tuple[List[str], np.ndarray]:
        ids, rows = super().get_all()
        if not ids:
            return ids, np.zeros((0, self.full_dim), np.float32)
        return ids, self._back(rows)

    def get_stats(self):
        stats = super().get_stats()
        stats.kind = self.kind
        stats.dimension = self.full_dim
        stats.extra["proj_dim"] = float(self.proj_dim)
        if self.proj_energy is not None:
            stats.extra["proj_energy"] = round(self.proj_energy, 4)
        return stats


class ProjectedInt4IvfIndex(ProjectedInt8IvfIndex, Int4IvfDeviceIndex):
    """PCA projection over packed-int4 lists: the deepest single-chip
    capacity tier (R=384 -> 192 B codes + 40 B planes per row; ~4x the
    768-d int8 row ceiling). MRO routes the projection wrapper's super()
    calls into Int4IvfDeviceIndex, so everything downstream — split-plane
    packing, the int4 probe kernel, masked search — runs unchanged at
    dimension R."""

    kind = "ivf_int4_proj"


def _make_sharded_projected():
    """Deferred class build: importing parallel.mesh pulls jax.sharding —
    keep single-chip imports light."""
    from grape_vector_db_tpu.parallel.mesh import (ShardedInt4IvfIndex,
                                                   ShardedInt8IvfIndex)

    class ShardedProjectedInt8IvfIndex(ProjectedInt8IvfIndex,
                                       ShardedInt8IvfIndex):
        """Mesh-sharded PCA-projected int8 IVF — the capacity tier times the
        mesh: each device holds 1/S of every list's R-dim int8 codes, so a
        shard-axis of S carries S times the single-device rows at the same
        recall. MRO: projection wrappers (this file) over the sharded
        within-list layout (parallel/mesh.py) over the int8 planes."""

        kind = "sharded_ivf_int8_proj"

    class ShardedProjectedInt4IvfIndex(ProjectedInt8IvfIndex,
                                       ShardedInt4IvfIndex):
        """Mesh-sharded PCA-projected packed-int4 IVF: S x the int4-proj
        single-chip row ceiling."""

        kind = "sharded_ivf_int4_proj"

    return ShardedProjectedInt8IvfIndex, ShardedProjectedInt4IvfIndex


def __getattr__(name):
    # Lazy class resolution: `from ... import ShardedProjectedInt8IvfIndex`
    # builds the class on first access (PEP 562) instead of eagerly pulling
    # jax.sharding into every single-chip import.
    if name in ("ShardedProjectedInt8IvfIndex", "ShardedProjectedInt4IvfIndex"):
        i8, i4 = _make_sharded_projected()
        globals()["ShardedProjectedInt8IvfIndex"] = i8
        globals()["ShardedProjectedInt4IvfIndex"] = i4
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_sharded_projected_cls(codes_kind: str = "int8"):
    name = ("ShardedProjectedInt4IvfIndex" if codes_kind == "int4"
            else "ShardedProjectedInt8IvfIndex")
    cls = globals().get(name)
    return cls if cls is not None else __getattr__(name)
