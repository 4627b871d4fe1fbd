"""VectorIndex interface — the trait of the index layer.

Mirrors the reference's ``VectorIndex`` trait (index.rs:35-62):
add / add_batch / search / remove / len / optimize / clear / get_stats,
plus ``get_all`` for persistence (index.rs:120-137) and batched ``search_batch``
(the device-native primary entry point — single-query search delegates to it).

All host-facing array types are numpy; device residency is an implementation
detail of each index.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["VectorIndex", "IndexStats", "SearchHit"]


@dataclass
class IndexStats:
    """index.rs IndexStats / query.rs:413-419 equivalents."""

    point_count: int = 0
    dimension: int = 0
    capacity: int = 0
    is_built: bool = True
    memory_usage_mb: float = 0.0
    kind: str = ""
    extra: Dict[str, float] = field(default_factory=dict)


SearchHit = Tuple[str, float]  # (id, score)


class VectorIndex(abc.ABC):
    """Abstract index over (id, vector) pairs with batched device search."""

    #: True when search_batch accepts a ``mask`` compiled by ``compile_mask``
    #: — masked top-k inside the search kernel (filtering.rs:374-488 done
    #: device-side; SURVEY §7.1 step 6).
    supports_mask: bool = False

    #: Whether a mask folded into search_batch is EXACT over the allowed
    #: rows at ANY selectivity. Full-scan indexes (flat/int8/binary) fuse
    #: the mask into a corpus-wide scan, so yes. Probe-based indexes (the
    #: IVF family) only mask the probed lists — allowed rows in unprobed
    #: lists are invisible, so recall collapses at low selectivity — so
    #: the planner applies a
    #: selectivity-aware fallback when this is False.
    mask_exact: bool = True

    #: Probe-based indexes whose bucketed layout can run the exhaustive
    #: masked scan (ops/ivf_scan.py: one streaming pass + k-list probe)
    #: advertise it here; ``search_batch(..., exhaustive=True)`` then
    #: returns the exact masked top-k at any selectivity.
    supports_exhaustive_mask: bool = False

    @property
    @abc.abstractmethod
    def dimension(self) -> int: ...

    @abc.abstractmethod
    def add_batch(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        """Upsert a batch. ``vectors``: [M, dim] float32. Existing ids are
        overwritten in place (the reference rebuilds the whole graph here —
        index.rs:164-185; we scatter into device arrays)."""

    def add(self, id_: str, vector: np.ndarray) -> None:
        self.add_batch([id_], np.asarray(vector, dtype=np.float32)[None, :])

    @abc.abstractmethod
    def remove_batch(self, ids: Sequence[str]) -> int:
        """Tombstone ids; returns number actually removed."""

    def remove(self, id_: str) -> bool:
        return self.remove_batch([id_]) == 1

    @abc.abstractmethod
    def search_batch(
        self, queries: np.ndarray, k: int, mask=None
    ) -> List[List[SearchHit]]:
        """Batched search: [B, dim] -> per-query descending (id, score) lists.

        ``mask`` (only when ``supports_mask``): an index-layout-specific
        allowed-slot mask from ``compile_mask`` — the search kernel folds it
        into its validity predicate, so results are the exact top-k over the
        allowed rows (no over-fetch heuristics)."""

    def compile_mask(self, allowed_ids):
        """Compile an allowed-id set to this index's slot-mask layout."""
        raise NotImplementedError(f"{self.kind} index does not support masks")

    def locked(self):
        """Context manager over the index's internal lock (reentrant). A
        compiled mask is (list, pos)-addressed, so a concurrent optimize()
        repack between compile_mask and search_batch would silently remap
        every cell — callers pairing the two must hold this across both."""
        import contextlib

        lock = getattr(self, "_lock", None)
        return lock if lock is not None else contextlib.nullcontext()

    def search(self, query: np.ndarray, k: int, mask=None) -> List[SearchHit]:
        return self.search_batch(
            np.asarray(query, dtype=np.float32)[None, :], k, mask=mask
        )[0]

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def clear(self) -> None: ...

    @abc.abstractmethod
    def get_stats(self) -> IndexStats: ...

    @abc.abstractmethod
    def get_all(self) -> Tuple[List[str], np.ndarray]:
        """(ids, [n, dim] f32 vectors) for persistence/rebuild (index.rs:120-137)."""

    def contains(self, id_: str) -> bool:
        return self.get_vector(id_) is not None

    @abc.abstractmethod
    def get_vector(self, id_: str) -> Optional[np.ndarray]: ...

    def optimize(self) -> None:
        """Hook for compaction/re-layout (index.rs optimize). Default no-op."""
