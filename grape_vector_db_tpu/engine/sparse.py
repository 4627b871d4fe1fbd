"""Sparse inverted index + BM25 (reference src/sparse.rs).

Host-side tokenizer and vocabulary (sparse.rs:267-370 SimpleTokenizer: lowercase,
split, en+zh stopwords), postings kept as growable numpy arrays. BM25 scoring is
vectorized: per query term the posting arrays (doc handle, tf, doc_len) are
gathered and contributions accumulated into a dense score vector with
``np.add.at`` — the array form of the reference's per-posting-list accumulation
loop (sparse.rs:152-199).

Two deliberate fixes over the reference:
- avg document length is maintained incrementally instead of recomputed by full
  scan on every add/remove (sparse.rs:95-104, 135-147);
- deletes tombstone a doc handle instead of rewriting postings; compaction
  rebuilds postings when tombstones exceed 25%.

BM25 constants k1=1.2 b=0.75, IDF = ln((N-df+0.5)/(df+0.5)) (sparse.rs:41-53,
202-204).
"""

from __future__ import annotations

import math
import re
import threading
import unicodedata
from collections import Counter
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from grape_vector_db_tpu.config import Bm25Config, SparseVectorConfig
from grape_vector_db_tpu.types import SparseVector

__all__ = ["SimpleTokenizer", "SparseIndex", "Bm25Config"]

_EN_STOPWORDS: Set[str] = {
    "a", "an", "and", "are", "as", "at", "be", "by", "for", "from", "has", "he",
    "in", "is", "it", "its", "of", "on", "that", "the", "to", "was", "were",
    "will", "with", "this", "but", "they", "have", "had", "what", "when", "where",
    "who", "which", "why", "how", "or", "not", "no", "so", "if", "than", "then",
}
_ZH_STOPWORDS: Set[str] = {"的", "了", "和", "是", "在", "我", "有", "他", "这", "中",
                           "大", "来", "上", "国", "个", "到", "说", "们", "为"}

_TOKEN_RE = re.compile(r"[a-z0-9_]+", re.IGNORECASE)


def _is_cjk(ch: str) -> bool:
    # Codepoint-range check, NOT unicodedata.name: a per-character name
    # lookup is a dictionary search on the ingest hot path.
    # Ranges: CJK Unified (+ext A), compatibility ideographs, and the SIP
    # planes — the same set "CJK in name" matched for ideographs.
    cp = ord(ch)
    return (
        0x4E00 <= cp <= 0x9FFF      # CJK Unified Ideographs
        or 0x3400 <= cp <= 0x4DBF   # Extension A
        or 0xF900 <= cp <= 0xFAFF   # Compatibility Ideographs
        or 0x20000 <= cp <= 0x323AF  # Extensions B..H (SIP/TIP)
        or 0x2E80 <= cp <= 0x2EFF   # CJK Radicals Supplement
        or 0x31C0 <= cp <= 0x31EF   # CJK Strokes
    )


_UNSET = object()
_TEXT_LIB: object = _UNSET
_TEXT_LIB_LOCK = threading.Lock()
_BATCH_TLS = threading.local()


def _native_text_lib():
    """ctypes handle to native/gvdb_text.cpp (built on demand; None when the
    toolchain is unavailable). The native loop implements the EXACT ASCII
    SimpleTokenizer semantics; non-ASCII stays on the Python path so Unicode
    behavior is single-sourced. Build is locked and writes through an
    atomically-renamed temp file — concurrent first users (multi-node
    in-process clusters, multi-process tests) must not race g++ on the same
    output path or CDLL a half-written library."""
    global _TEXT_LIB
    with _TEXT_LIB_LOCK:
        if _TEXT_LIB is not _UNSET:
            return _TEXT_LIB
        try:
            import ctypes
            import os
            import subprocess

            ndir = os.path.abspath(os.path.join(
                os.path.dirname(__file__), os.pardir, os.pardir, "native"))
            so = os.path.join(ndir, "libgvdb_text.so")
            src = os.path.join(ndir, "gvdb_text.cpp")
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                tmp = f"{so}.tmp.{os.getpid()}"
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-shared",
                     "-o", tmp, src],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.gvdb_tokenize_counts.restype = ctypes.c_int32
            lib.gvdb_tokenize_counts.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ]
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.gvdb_tokenize_batch.restype = ctypes.c_int32
            lib.gvdb_tokenize_batch.argtypes = [
                ctypes.c_char_p, i32p, ctypes.c_int32,     # texts, offsets, n
                ctypes.c_char_p, ctypes.c_int32, i32p,     # term table
                i32p, i32p, i32p, ctypes.c_int32,          # pair arrays
                i32p,                                      # doc totals
                ctypes.POINTER(ctypes.c_int64),            # need_terms
                ctypes.POINTER(ctypes.c_int64),            # need_pairs
            ]
            _TEXT_LIB = lib
        except Exception:
            _TEXT_LIB = None
        return _TEXT_LIB


def _native_term_counts(lib, text: str) -> Optional[Tuple[Counter, int]]:
    """None = input unsupported by the native loop (e.g. a single token
    longer than the u16 record header) — caller falls back to Python."""
    import ctypes
    import struct

    raw = text.encode("ascii")
    cap = max(4 * len(raw) + 64, 256)
    while True:
        buf = ctypes.create_string_buffer(cap)
        total = ctypes.c_int32(0)
        n = lib.gvdb_tokenize_counts(raw, len(raw), buf, cap,
                                     ctypes.byref(total))
        if n == -(2**31):  # sentinel: token too long for the record format
            return None
        if n >= 0:
            break
        cap = -n
    counts: Counter = Counter()
    p = 0
    mv = buf.raw
    for _ in range(n):
        (l,) = struct.unpack_from("<H", mv, p)
        p += 2
        tok = mv[p:p + l].decode("ascii")
        p += l
        (c,) = struct.unpack_from("<I", mv, p)
        p += 4
        counts[tok] = c
    return counts, int(total.value)


def _native_batch_counts(lib, texts: Sequence[str]):
    """One native call tokenizing the whole ASCII batch. Returns
    (unique terms, pair_doc, pair_term, pair_count, doc_totals) — pairs are
    (document, term) occurrences with batch-local term ids — or None when the
    input is unsupported (caller falls back to the per-doc Python path)."""
    import ctypes
    import struct

    n = len(texts)
    enc = [t.encode("ascii") for t in texts]
    offs = np.zeros(n + 1, dtype=np.int32)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    blob = b"".join(enc)
    i32p = ctypes.POINTER(ctypes.c_int32)
    term_cap = max(2 * len(blob) + 64, 4096)
    pair_cap = max(len(blob) // 2, 256)
    # Thread-local buffer reuse: create_string_buffer zero-fills ~1 MB per
    # call. Safe because every consumer of the
    # returned slices copies before this can be called again on the thread
    # (fancy-indexing/astype in add_documents materialize new arrays) and
    # the C++ side fully writes dt and the first rc pair entries.
    bufs = getattr(_BATCH_TLS, "bufs", None)
    if (bufs is None or len(bufs[0]) < term_cap or len(bufs[1]) < pair_cap
            or len(bufs[4]) < n):
        bufs = (ctypes.create_string_buffer(max(term_cap, 1 << 20)),
                np.empty(max(pair_cap, 1 << 16), np.int32),
                np.empty(max(pair_cap, 1 << 16), np.int32),
                np.empty(max(pair_cap, 1 << 16), np.int32),
                np.empty(max(n, 8192), np.int32))
        _BATCH_TLS.bufs = bufs
    while True:
        tbuf = bufs[0] if len(bufs[0]) >= term_cap else \
            ctypes.create_string_buffer(term_cap)
        nt = ctypes.c_int32(0)
        pd = bufs[1] if len(bufs[1]) >= pair_cap else np.empty(pair_cap, np.int32)
        pt = bufs[2] if len(bufs[2]) >= pair_cap else np.empty(pair_cap, np.int32)
        pc = bufs[3] if len(bufs[3]) >= pair_cap else np.empty(pair_cap, np.int32)
        dt = bufs[4][:n] if len(bufs[4]) >= n else np.empty(n, np.int32)
        term_cap = len(tbuf)
        pair_cap = len(pd)
        need_t = ctypes.c_int64(0)
        need_p = ctypes.c_int64(0)
        rc = lib.gvdb_tokenize_batch(
            blob, offs.ctypes.data_as(i32p), n,
            tbuf, term_cap, ctypes.byref(nt),
            pd.ctypes.data_as(i32p), pt.ctypes.data_as(i32p),
            pc.ctypes.data_as(i32p), pair_cap,
            dt.ctypes.data_as(i32p),
            ctypes.byref(need_t), ctypes.byref(need_p),
        )
        if rc == -(2**31):  # token too long for the u16 record format
            return None
        if rc >= 0:
            break
        term_cap = max(term_cap, int(need_t.value))
        pair_cap = max(pair_cap, int(need_p.value), 1)
    terms: List[str] = []
    # memoryview, not .raw: .raw copies the ENTIRE buffer (>= 1 MB after the
    # thread-local reuse floor) to parse a prefix; mv slices are zero-copy
    mv = memoryview(tbuf)
    p = 0
    for _ in range(int(nt.value)):
        (l,) = struct.unpack_from("<H", mv, p)
        p += 2
        terms.append(bytes(mv[p:p + l]).decode("ascii"))
        p += l
    return terms, pd[:rc], pt[:rc], pc[:rc], dt


class SimpleTokenizer:
    """Lowercase + alphanumeric tokens; CJK runs emit single characters
    (sparse.rs SimpleTokenizer semantics: whitespace split, lowercase, en+zh
    stopword removal). Pure-ASCII text takes the native C++ hot loop
    (native/gvdb_text.cpp) when available — tokenization dominated the
    end-to-end write path in profiling."""

    def __init__(self, stopwords: Optional[Set[str]] = None):
        self.stopwords = stopwords if stopwords is not None else (_EN_STOPWORDS | _ZH_STOPWORDS)
        # the native loop bakes in the default EN stopword set; custom sets
        # must stay on the Python path
        self._native_ok = stopwords is None

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for m in _TOKEN_RE.finditer(text.lower()):
            tok = m.group(0)
            if tok not in self.stopwords:
                out.append(tok)
        if not text.isascii():  # ASCII text has no CJK — skip the char scan
            for ch in text:
                if _is_cjk(ch) and ch not in self.stopwords:
                    out.append(ch)
        return out

    def term_frequencies(self, text: str) -> Tuple[Counter, int]:
        if self._native_ok and text.isascii():
            lib = _native_text_lib()
            if lib is not None:
                out = _native_term_counts(lib, text)
                if out is not None:
                    return out
        toks = self.tokenize(text)
        return Counter(toks), len(toks)


class _GrowBuf:
    """Amortized-doubling numpy buffer: the list-backed postings paid a
    Python object per (doc, term) pair on the write path and an O(len)
    list->array conversion per query term on the read path; this holds the
    live prefix of a preallocated array instead."""

    __slots__ = ("buf", "n")

    def __init__(self, dtype, cap: int = 16):
        self.buf = np.empty(cap, dtype)
        self.n = 0

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "_GrowBuf":
        g = cls(arr.dtype, cap=max(len(arr), 16))
        g.buf[: len(arr)] = arr
        g.n = len(arr)
        return g

    def _ensure(self, extra: int) -> None:
        need = self.n + extra
        cap = self.buf.shape[0]
        if need > cap:
            new = np.empty(max(need, 2 * cap), self.buf.dtype)
            new[: self.n] = self.buf[: self.n]
            self.buf = new

    def append(self, v) -> None:
        self._ensure(1)
        self.buf[self.n] = v
        self.n += 1

    def extend(self, arr) -> None:
        m = len(arr)
        self._ensure(m)
        self.buf[self.n:self.n + m] = arr
        self.n += m

    def view(self) -> np.ndarray:
        return self.buf[: self.n]


class _Posting:
    """Posting list for one term.

    Write side: batch ingest appends SLICES of the batch-wide pair arrays
    (the sort by term partitions them perfectly, so the slices are zero-copy
    views sharing one parent per batch) to ``chunks``; single-doc adds go to
    the small ``tail`` buffers. Both are O(1) per call — the previous
    list-backed form paid a Python float/int object per pair, and a
    numpy-buffer form paid ~2us of slice-assign overhead per (term, batch).

    Read side: ``view()`` concatenates chunks+tail once and caches (mutation
    invalidates); the old form converted list->array per query term.

    INVARIANT: handles within one posting are unique (a document contributes
    one aggregated tf per term; re-adds mint a new handle), so BM25
    accumulation may use fancy-index += instead of np.add.at."""

    __slots__ = ("chunks_h", "chunks_t", "tail_h", "tail_t", "n", "_h", "_t")

    def __init__(self):
        self.chunks_h: List[np.ndarray] = []
        self.chunks_t: List[np.ndarray] = []
        # lazy: batch ingest never appends, and these are 4 allocations per
        # vocabulary term — real GC pressure at 100k+ vocabularies
        self.tail_h: Optional[_GrowBuf] = None
        self.tail_t: Optional[_GrowBuf] = None
        self.n = 0
        self._h: Optional[np.ndarray] = None
        self._t: Optional[np.ndarray] = None

    def append(self, handle: int, tf: float) -> None:
        if self.tail_h is None:
            self.tail_h = _GrowBuf(np.int64)
            self.tail_t = _GrowBuf(np.float64)
        self.tail_h.append(handle)
        self.tail_t.append(tf)
        self.n += 1
        self._h = self._t = None

    def extend(self, h_arr: np.ndarray, t_arr: np.ndarray) -> None:
        self.chunks_h.append(h_arr)
        self.chunks_t.append(t_arr)
        self.n += len(h_arr)
        self._h = self._t = None

    def view(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n == 0:
            return np.empty(0, np.int64), np.empty(0, np.float64)
        if self._h is None:
            tail = self.tail_h is not None and self.tail_h.n > 0
            hs = self.chunks_h + ([self.tail_h.view()] if tail else [])
            ts = self.chunks_t + ([self.tail_t.view()] if tail else [])
            if len(hs) == 1:
                # Single source: NO copy is made (ascontiguousarray returns
                # its input when dtype/contiguity already match). Aliasing is
                # safe because cached sources are never mutated afterward:
                # the tail GrowBuf is nulled below (appends allocate a fresh
                # one) and batch pair arrays are write-once. The chunk's
                # parent stays pinned, but sibling postings' chunks cover the
                # rest of it, so nothing is wasted while the index lives.
                self._h = np.ascontiguousarray(hs[0], dtype=np.int64)
                self._t = np.ascontiguousarray(ts[0], dtype=np.float64)
            else:
                self._h = np.concatenate(hs).astype(np.int64, copy=False)
                self._t = np.concatenate(ts).astype(np.float64, copy=False)
            # collapse: future views are O(1)
            self.chunks_h = [self._h]
            self.chunks_t = [self._t]
            self.tail_h = self.tail_t = None
        return self._h, self._t

    def replace(self, h_arr: np.ndarray, t_arr: np.ndarray) -> None:
        """Swap in rewritten (compacted) postings."""
        self.chunks_h = [h_arr]
        self.chunks_t = [t_arr]
        self.tail_h = self.tail_t = None
        self.n = len(h_arr)
        self._h = self._t = None


class SparseIndex:
    """Inverted index with BM25 search (sparse.rs:71-199)."""

    def __init__(
        self,
        bm25: Optional[Bm25Config] = None,
        config: Optional[SparseVectorConfig] = None,
        tokenizer: Optional[SimpleTokenizer] = None,
    ):
        self.bm25 = bm25 or Bm25Config()
        self.config = config or SparseVectorConfig()
        self.tokenizer = tokenizer or SimpleTokenizer()
        self._lock = threading.RLock()
        self._vocab: Dict[str, int] = {}
        self._postings: Dict[int, _Posting] = {}
        self._doc_handle: Dict[str, int] = {}
        self._handle_doc: List[Optional[str]] = []
        self._doc_len = _GrowBuf(np.float64)
        # bool twin of "self._handle_doc[h] is not None": keeps liveness a
        # vector op on the query path (mask, df) instead of an O(N) listcomp
        self._live = _GrowBuf(np.bool_)
        self._total_len = 0.0
        self._live_docs = 0
        self._tombstones = 0

    # -- vocabulary -------------------------------------------------------------

    def _term_id(self, term: str, create: bool) -> Optional[int]:
        tid = self._vocab.get(term)
        if tid is None and create and len(self._vocab) < self.config.max_vocabulary_size:
            tid = len(self._vocab)
            self._vocab[term] = tid
            self._postings[tid] = _Posting()
        return tid

    def vocabulary_size(self) -> int:
        return len(self._vocab)

    def build_vocabulary(self, texts: Sequence[str]) -> None:
        """Pre-seed the vocabulary (sparse.rs build_vocabulary)."""
        with self._lock:
            for t in texts:
                for term in self.tokenizer.tokenize(t):
                    self._term_id(term, create=True)

    def document_to_sparse_vector(self, text: str) -> SparseVector:
        """Relative-term-frequency sparse vector (sparse.rs document_to_sparse_vector)."""
        tf, total = self.tokenizer.term_frequencies(text)
        if total == 0:
            return SparseVector()
        idx_vals = []
        for term, c in tf.items():
            tid = self._vocab.get(term)
            if tid is not None:
                idx_vals.append((tid, c / total))
        idx_vals.sort()
        return SparseVector([i for i, _ in idx_vals], [v for _, v in idx_vals])

    # -- mutation ------------------------------------------------------------------

    def add_document(self, doc_id: str, text: str) -> None:
        with self._lock:
            if doc_id in self._doc_handle:
                self._remove_locked(doc_id)
            tf, total = self.tokenizer.term_frequencies(text)
            handle = len(self._handle_doc)
            self._handle_doc.append(doc_id)
            self._doc_len.append(float(total))
            self._live.append(True)
            self._doc_handle[doc_id] = handle
            self._total_len += total
            self._live_docs += 1
            for term, count in tf.items():
                tid = self._term_id(term, create=True)
                if tid is None:
                    continue
                p = self._postings[tid]
                p.append(handle, float(count))

    def add_documents(self, doc_ids: Sequence[str], texts: Sequence[str]) -> None:
        """Batch ingest: ONE native tokenizer call for the whole batch
        (native/gvdb_text.cpp::gvdb_tokenize_batch) + postings extended in
        per-term groups instead of per-(doc, term) appends. The reference
        adds per document (sparse.rs:95-134); this is the write-path hot
        loop, so the batch form is the product path."""
        if len(doc_ids) != len(texts):
            raise ValueError("doc_ids/texts length mismatch")
        lib = _native_text_lib() if self.tokenizer._native_ok else None
        if lib is None or len(doc_ids) < 8:
            for d, t in zip(doc_ids, texts):
                self.add_document(d, t)
            return
        last = {d: i for i, d in enumerate(doc_ids)}
        if len(last) != len(doc_ids):  # intra-batch upsert: keep last
            keep = sorted(last.values())
            doc_ids = [doc_ids[i] for i in keep]
            texts = [texts[i] for i in keep]
        with self._lock:
            # upsert removals defer compaction to the end of the batch: the
            # re-adds below immediately lower the tombstone ratio, so
            # compacting mid-loop would do a full postings rewrite that the
            # very next statement invalidates the need for
            for d in self._doc_handle.keys() & set(doc_ids):
                self._remove_locked(d, compact=False)
            ascii_ix = [i for i, t in enumerate(texts) if t.isascii()]
            out = (_native_batch_counts(lib, [texts[i] for i in ascii_ix])
                   if ascii_ix else ([], np.zeros(0, np.int32),
                                     np.zeros(0, np.int32),
                                     np.zeros(0, np.int32), np.zeros(0, np.int32)))
            if out is None:  # pathological token — per-doc fallback
                for d, t in zip(doc_ids, texts):
                    self.add_document(d, t)
                return
            terms, pair_doc, pair_term, pair_count, doc_tot = out
            # Handles assigned in INPUT order for every doc (ascii or not) so
            # tie-breaking matches the per-doc path exactly.
            base = len(self._handle_doc)
            if len(ascii_ix) == len(doc_ids):
                # all-ascii fast path: bulk container updates, no per-doc loop
                n_docs = len(doc_ids)
                handle_of_ascii = np.arange(base, base + n_docs, dtype=np.int64)
                self._handle_doc.extend(doc_ids)
                self._doc_handle.update(
                    zip(doc_ids, range(base, base + n_docs)))
                self._doc_len.extend(doc_tot)
                self._live.extend(np.ones(n_docs, np.bool_))
                self._total_len += float(doc_tot.sum())
            else:
                handle_of_ascii = np.empty(len(ascii_ix), dtype=np.int64)
                ascii_pos = {i: j for j, i in enumerate(ascii_ix)}
                for i, d in enumerate(zip(doc_ids, texts)):
                    did, text = d
                    handle = base + i
                    self._handle_doc.append(did)
                    self._live.append(True)
                    self._doc_handle[did] = handle
                    j = ascii_pos.get(i)
                    if j is not None:
                        total = float(doc_tot[j])
                        handle_of_ascii[j] = handle
                        self._doc_len.append(total)
                        self._total_len += total
                    else:
                        # Unicode stays single-sourced on the Python tokenizer
                        tf, total = self.tokenizer.term_frequencies(text)
                        self._doc_len.append(float(total))
                        self._total_len += total
                        for term, count in tf.items():
                            tid = self._term_id(term, create=True)
                            if tid is None:
                                continue
                            post = self._postings[tid]
                            post.append(handle, float(count))
            self._live_docs += len(doc_ids)
            if len(pair_term) == 0:
                self._maybe_compact_locked()
                return
            # batch-local term id -> global vocab id (-1: vocabulary full).
            # Inlined _term_id with locals: this loop runs once per unique
            # term per batch, and the naive form pays attribute and
            # np-scalar overhead on every pass.
            vocab = self._vocab
            postings = self._postings
            vocab_get = vocab.get
            cap = self.config.max_vocabulary_size
            tid_list: List[int] = []
            for term in terms:
                tid = vocab_get(term)
                if tid is None:
                    if len(vocab) < cap:
                        tid = len(vocab)
                        vocab[term] = tid
                        postings[tid] = _Posting()
                    else:
                        tid = -1
                tid_list.append(tid)
            tid_map = np.asarray(tid_list, dtype=np.int64)
            # group pairs by term and extend each posting list once
            order = np.argsort(pair_term, kind="stable")
            pt_s = pair_term[order]
            handles = handle_of_ascii[pair_doc[order]]
            tfs = pair_count[order].astype(np.float64)
            uniq, starts = np.unique(pt_s, return_index=True)
            ends = np.append(starts[1:], len(pt_s))
            gtids = tid_map[uniq].tolist()
            for tid, s, e in zip(gtids, starts.tolist(), ends.tolist()):
                if tid < 0:
                    continue
                postings[tid].extend(handles[s:e], tfs[s:e])
            self._maybe_compact_locked()

    def remove_document(self, doc_id: str) -> bool:
        with self._lock:
            return self._remove_locked(doc_id)

    def _remove_locked(self, doc_id: str, compact: bool = True) -> bool:
        handle = self._doc_handle.pop(doc_id, None)
        if handle is None:
            return False
        self._handle_doc[handle] = None
        self._live.buf[handle] = False
        self._total_len -= float(self._doc_len.buf[handle])
        self._live_docs -= 1
        self._tombstones += 1
        if compact:
            self._maybe_compact_locked()
        return True

    def _maybe_compact_locked(self) -> bool:
        if (self._live_docs > 0 and self._tombstones
                > 0.25 * (self._live_docs + self._tombstones)):
            self._compact_locked()
            return True
        return False

    def _compact_locked(self) -> None:
        """Rewrite postings dropping tombstoned handles (vectorized: an
        old->new remap array replaces the per-pair dict walk)."""
        alive = self._live.view()
        n_new = int(alive.sum())
        remap_arr = np.full(alive.shape[0], -1, dtype=np.int64)
        remap_arr[alive] = np.arange(n_new, dtype=np.int64)
        for p in self._postings.values():
            h, t = p.view()
            nh = remap_arr[h]
            keep = nh >= 0
            p.replace(nh[keep], t[keep])
        new_handle_doc = [d for d in self._handle_doc if d is not None]
        self._doc_len = _GrowBuf.from_array(self._doc_len.view()[alive])
        self._live = _GrowBuf.from_array(np.ones(n_new, np.bool_))
        self._handle_doc = new_handle_doc
        self._doc_handle = {d: h for h, d in enumerate(new_handle_doc)}
        self._tombstones = 0

    def clear(self) -> None:
        with self._lock:
            # Reset fields in place — calling __init__ would replace self._lock
            # and break threads still synchronizing on the old one.
            self._vocab = {}
            self._postings = {}
            self._doc_handle = {}
            self._handle_doc = []
            self._doc_len = _GrowBuf(np.float64)
            self._live = _GrowBuf(np.bool_)
            self._total_len = 0.0
            self._live_docs = 0
            self._tombstones = 0

    def __len__(self) -> int:
        return self._live_docs

    @property
    def avg_doc_len(self) -> float:
        return self._total_len / self._live_docs if self._live_docs else 0.0

    # -- search -------------------------------------------------------------------

    def idf(self, term: str) -> float:
        """ln((N-df+0.5)/(df+0.5)) (sparse.rs:202-204)."""
        tid = self._vocab.get(term)
        if tid is None:
            return 0.0
        df = self._df(tid)
        n = self._live_docs
        return math.log((n - df + 0.5) / (df + 0.5)) if n else 0.0

    def _df(self, tid: int) -> int:
        p = self._postings.get(tid)
        if p is None or p.n == 0:
            return 0
        if self._tombstones == 0:  # no dead handles anywhere -> df = |posting|
            return p.n
        return int(np.count_nonzero(self._live.view()[p.view()[0]]))

    def search_bm25(self, query: str, limit: int) -> List[Tuple[str, float]]:
        """Vectorized BM25 accumulation (sparse.rs:152-199)."""
        with self._lock:
            if self._live_docs == 0:
                return []
            terms = self.tokenizer.tokenize(query)
            if not terms:
                return []
            n_handles = len(self._handle_doc)
            scores = np.zeros(n_handles, dtype=np.float64)
            doc_len = self._doc_len.view()
            avgdl = max(self.avg_doc_len, 1e-9)
            k1, b = self.bm25.k1, self.bm25.b
            seen_any = False
            for term in set(terms):
                tid = self._vocab.get(term)
                if tid is None:
                    continue
                p = self._postings[tid]
                if p.n == 0:
                    continue
                handles, tfs = p.view()
                idf = self.idf(term)
                dl = doc_len[handles]
                contrib = idf * (tfs * (k1 + 1.0)) / (tfs + k1 * (1.0 - b + b * dl / avgdl))
                # handles are unique within one posting (class invariant), so
                # fancy += is exact and much faster than np.add.at
                scores[handles] += contrib
                seen_any = True
            if not seen_any:
                return []
            live_mask = self._live.view()
            scores = np.where(live_mask, scores, -np.inf)
            k = min(limit, n_handles)
            top = np.argpartition(-scores, k - 1)[:k]
            top = top[np.argsort(-scores[top])]
            out: List[Tuple[str, float]] = []
            for h in top:
                if scores[h] == -np.inf or scores[h] == 0.0:
                    continue
                doc = self._handle_doc[h]
                if doc is not None:
                    out.append((doc, float(scores[h])))
            return out

    def get_stats(self) -> Dict[str, float]:
        return {
            "documents": float(self._live_docs),
            "vocabulary": float(len(self._vocab)),
            "avg_doc_len": self.avg_doc_len,
            "tombstones": float(self._tombstones),
        }
