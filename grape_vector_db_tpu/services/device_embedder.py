"""On-device text embedder: feature hashing + a matmul projection.

The reference's embedding story is an HTTP call-out (embeddings.rs:55-219)
or a per-text hash fixture (embeddings.rs:222-266, our
``MockEmbeddingProvider``) — the mock gives UNRELATED vectors to near-identical
texts, so text-only corpora get no usable dense channel without a network
dependency. This module is the device-native third option SURVEY §2.2 left open
("optionally on-device embedding via a JAX model later"): a deterministic
local embedder whose vectors DO carry lexical similarity, with the heavy math
on the chip.

Method (the classic hashing trick, fastText-shaped but training-free):

1. Host featurization: word tokens (``engine.sparse.SimpleTokenizer`` — same
   lowercasing/stopword/CJK semantics as the BM25 channel) plus character
   n-grams (3..5) over each token for subword robustness. Each feature string
   hashes to a bucket in ``[0, buckets)`` (crc32) and a ±1 sign (second crc32
   salt) — the signed hashing trick keeps the bucketed dot product an unbiased
   estimate of the exact feature dot product.
2. Device compute, one jitted dispatch per batch chunk: scatter the
   (bucket, sign·log(1+tf)) pairs into a ``[B, buckets]`` plane, multiply by a
   fixed seeded gaussian projection ``[buckets, dim]``, L2-normalize.
   Johnson-Lindenstrauss: the projection preserves the hashed-space cosine, so
   similar texts land near each other in the output space.

Same text → same vector across runs and processes (crc32 + fixed PRNG seed).
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from grape_vector_db_tpu.engine.sparse import SimpleTokenizer
from grape_vector_db_tpu.services.embeddings import EmbeddingProvider
from grape_vector_db_tpu.utils.buckets import next_bucket

__all__ = ["DeviceHashEmbedder"]

# One projection + jitted kernel per (buckets, dim, seed) — shared across
# embedder instances so a DB + its query path don't hold two 48MB planes.
_PROJ_CACHE: Dict[Tuple[int, int, int], object] = {}
_PROJ_LOCK = threading.Lock()

_HASH_LIB = None
_HASH_LIB_READY = False


def _native_hash_lib():
    """ctypes handle with gvdb_hash_features configured, or None (missing
    toolchain / stale .so without the symbol -> Python featurizer)."""
    global _HASH_LIB, _HASH_LIB_READY
    with _PROJ_LOCK:
        if _HASH_LIB_READY:
            return _HASH_LIB
        _HASH_LIB_READY = True
        try:
            import ctypes

            from grape_vector_db_tpu.engine.sparse import _native_text_lib

            lib = _native_text_lib()
            if lib is None:
                _HASH_LIB = None
                return None
            fn = lib.gvdb_hash_features  # AttributeError -> stale .so
            fn.restype = ctypes.c_int32
            i32p = ctypes.POINTER(ctypes.c_int32)
            fn.argtypes = [
                ctypes.c_char_p, i32p, ctypes.c_int32,      # texts, offsets, n
                ctypes.c_char_p, ctypes.c_int32,            # salt
                ctypes.c_int32, ctypes.c_int32,             # lo_n, hi_n
                ctypes.c_int32, ctypes.c_int32,             # buckets, m
                i32p, ctypes.POINTER(ctypes.c_float),       # out idx/val
            ]
            _HASH_LIB = lib
        except Exception:
            _HASH_LIB = None
        return _HASH_LIB


class DeviceHashEmbedder(EmbeddingProvider):
    """Deterministic local embedder: signed feature hashing → matmul projection.

    Parameters mirror ``EmbeddingConfig``: ``dimension`` is the output width,
    ``buckets`` the hashed feature space (more buckets = fewer collisions),
    ``max_features`` the per-text feature budget (texts keep their
    most-frequent features; ties break on bucket id so truncation is
    deterministic), ``ngram`` the character n-gram span taken over each word
    token.
    """

    def __init__(self, dim: int = 768, buckets: int = 32_768, seed: int = 0,
                 max_features: int = 256, ngram: Tuple[int, int] = (3, 5),
                 chunk: int = 1024):
        if dim <= 0 or buckets <= 0:
            raise ValueError("dim and buckets must be positive")
        self._dim = dim
        self._buckets = buckets
        self._seed = seed
        self._max_features = max_features
        self._ngram = ngram
        self._chunk = chunk
        self._tokenizer = SimpleTokenizer()
        self._seed_salt = f"|{seed}".encode()

    # -- EmbeddingProvider surface -------------------------------------------

    def dimension(self) -> int:
        return self._dim

    def generate_embeddings(self, texts: Sequence[str]) -> List[List[float]]:
        return [row.tolist() for row in self.embed_array(texts)]

    def embed_array(self, texts: Sequence[str]) -> np.ndarray:
        """Batch embed to a float32 ``[len(texts), dim]`` array (no per-float
        boxing — the ingest path stores these rows directly). Values ride the
        f16 readback wire (see ``embed_ingest``), so they carry f16 rounding
        (~5e-4 relative on unit rows) — deterministically, same text same
        vector."""
        if not texts:
            return np.zeros((0, self._dim), np.float32)
        _, drain = self.embed_ingest(texts)
        return drain().astype(np.float32)

    def embed_ingest(self, texts: Sequence[str]):
        """Ingest-path embedding: ``(chunks, drain)``.

        ``chunks`` is ``[(device f32 [padded, dim], n_valid), ...]`` — the
        projection outputs still resident on the device, for a device-direct
        index scatter (``FlatDeviceIndex.add_batch_device``) that skips the
        host round trip on the scatter operand entirely. ``drain()`` blocks
        on the f16 host copies (started async here, so the transfer overlaps
        the caller's scatter dispatch and host work) and returns the
        ``[len(texts), dim]`` float16 rows the document store keeps.

        Bytes per 4096x768 batch: reading back 12.6 MB f32 then re-uploading
        6.3 MB bf16 for the scatter would move 18.9 MB; this path moves
        6.3 MB f16 total.
        """
        if not texts:
            return [], lambda: np.zeros((0, self._dim), np.float16)
        idx, val = self._featurize(texts)
        fn, proj = self._kernel()
        step = self._chunk
        # dispatch every chunk asynchronously, then drain with one readback
        # pass: jax dispatch is async, so the per-chunk round trip would
        # otherwise serialize (4 chunks per 4096-doc ingest batch)
        chunks, parts = [], []
        for lo in range(0, len(texts), step):
            hi = min(lo + step, len(texts))
            b = next_bucket(hi - lo)
            ib = np.zeros((b, idx.shape[1]), np.int32)
            vb = np.zeros((b, idx.shape[1]), np.float32)
            ib[: hi - lo] = idx[lo:hi]
            vb[: hi - lo] = val[lo:hi]
            e32, e16 = fn(ib, vb, proj)
            try:
                e16.copy_to_host_async()
            except Exception:
                pass  # backend without async host copy: drain still works
            chunks.append((e32, hi - lo))
            parts.append((lo, hi, e16))

        def drain() -> np.ndarray:
            out = np.empty((len(texts), self._dim), np.float16)
            for lo, hi, e16 in parts:
                out[lo:hi] = np.asarray(e16)[: hi - lo]
            return out

        return chunks, drain

    # -- featurization (host) --------------------------------------------------

    def _features(self, text: str) -> Dict[int, float]:
        lo_n, hi_n = self._ngram
        acc: Dict[int, int] = {}
        for tok in self._tokenizer.tokenize(text):
            feats = [tok]
            padded = f"<{tok}>"
            for n in range(lo_n, hi_n + 1):
                if len(padded) < n:
                    break
                feats.extend(padded[i:i + n] for i in range(len(padded) - n + 1))
            for f in feats:
                raw = f.encode() + self._seed_salt
                b = zlib.crc32(raw) % self._buckets
                # signed-key encoding: +b for sign +1, -(b+1) for sign -1 —
                # opposite-sign hits on one bucket cancel in the scatter-add,
                # which is exactly the unbiased signed hashing trick
                key = b if zlib.crc32(b"#" + raw) & 1 else -(b + 1)
                acc[key] = acc.get(key, 0) + 1
        # log-damped term frequency, signed
        return {k: float(np.log1p(c)) for k, c in acc.items()}

    def _featurize(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        m = self._max_features
        idx = np.zeros((len(texts), m), np.int32)
        val = np.zeros((len(texts), m), np.float32)
        # ASCII texts take the native hot loop (exact-parity featurizer in
        # native/gvdb_text.cpp::gvdb_hash_features — the pure-Python n-gram
        # loop, one crc32 per feature, capped embed-at-ingest); non-ASCII
        # stays here so Unicode behavior is
        # single-sourced, same split as the BM25 tokenizer.
        remaining = range(len(texts))
        lib = _native_hash_lib()
        if lib is not None:
            ascii_ids = [i for i in remaining if texts[i].isascii()]
            if ascii_ids and self._hash_native(lib, texts, ascii_ids, idx, val):
                aset = set(ascii_ids)
                remaining = [i for i in range(len(texts)) if i not in aset]
        for i in remaining:
            feats = self._features(texts[i])
            if not feats:
                continue
            items = sorted(feats.items(), key=lambda kv: (-kv[1], kv[0]))[:m]
            for j, (key, w) in enumerate(items):
                if key >= 0:
                    idx[i, j], val[i, j] = key, w
                else:
                    idx[i, j], val[i, j] = -key - 1, -w
        return idx, val

    def _hash_native(self, lib, texts: Sequence[str], ids, idx: np.ndarray,
                     val: np.ndarray) -> bool:
        """Featurize ``texts[ids]`` (all ASCII) through the C++ loop into the
        matching rows of ``idx``/``val``. False -> caller falls back."""
        import ctypes

        m = self._max_features
        blobs = [texts[i].encode("ascii") for i in ids]
        offsets = np.zeros(len(blobs) + 1, np.int32)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        concat = b"".join(blobs)
        sub_idx = np.zeros((len(blobs), m), np.int32)
        sub_val = np.zeros((len(blobs), m), np.float32)
        lo_n, hi_n = self._ngram
        rc = lib.gvdb_hash_features(
            concat, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(blobs), self._seed_salt, len(self._seed_salt),
            lo_n, hi_n, self._buckets, m,
            sub_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            sub_val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            return False
        idx[ids] = sub_idx
        val[ids] = sub_val
        return True

    # -- device kernel ----------------------------------------------------------

    def _kernel(self):
        key = (self._buckets, self._dim, self._seed)
        hit = _PROJ_CACHE.get(key)
        if hit is not None:
            return hit
        with _PROJ_LOCK:
            hit = _PROJ_CACHE.get(key)
            if hit is not None:
                return hit
            import jax
            import jax.numpy as jnp
            from jax import random

            # bf16 is plenty for a random projection (the output is
            # L2-normalized); halves the plane's HBM + read bytes.
            proj = random.normal(random.PRNGKey(self._seed),
                                 (self._buckets, self._dim), jnp.bfloat16)

            @jax.jit
            def embed(idx, val, proj):
                b = idx.shape[0]
                plane = jnp.zeros((b, proj.shape[0]), jnp.float32)
                rows = jnp.arange(b, dtype=jnp.int32)[:, None]
                # pad entries carry val=0 at idx=0: a no-op add
                plane = plane.at[rows, idx].add(val)
                e = jax.lax.dot(plane.astype(jnp.bfloat16), proj,
                                preferred_element_type=jnp.float32)
                n = jnp.linalg.norm(e, axis=1, keepdims=True)
                out = e / jnp.maximum(n, 1e-12)
                # two outputs: f32 stays on device for a device-direct index
                # scatter; the f16 copy is what crosses the wire to the host
                # (half the readback bytes)
                return out, out.astype(jnp.float16)

            _PROJ_CACHE[key] = (embed, proj)
            return _PROJ_CACHE[key]
