"""FileDocumentStore — durable WAL + snapshot store with checksummed backups.

Rebuilds the reference's sled persistence semantics without sled:
- write path: append-only WAL (storage/codec.py frames) + periodic snapshot
  compaction
  (sled's LSM tree becomes WAL+snapshot; flush interval semantics of
  advanced_storage.rs:36-47).
- backup/restore: single-file, SHA-256-checksummed, written via tmp + atomic
  rename, with a pre-restore auto-backup (storage.rs:500-712 BackupData flow).
- generic KV namespace used by Raft state persistence
  (advanced_storage.rs:627-651).

Embeddings are serialized as raw little-endian f32 bytes (a quarter of the
size of JSON number lists, zero-copy numpy decode). Only the standard library
is used: struct-framed records, JSON headers, zlib-compressed snapshots.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from grape_vector_db_tpu.errors import BackupError, SerializationError, StorageError
from grape_vector_db_tpu.storage import codec
from grape_vector_db_tpu.storage.store import DocumentStore, StorageStats
from grape_vector_db_tpu.types import DocumentRecord, now_ms

__all__ = ["FileDocumentStore"]

_MAGIC = b"GVDBZ001"
# Every WAL starts with this; one written in another format is refused on
# open, never truncated.
_WAL_MAGIC = b"GVDBW001"
_FRAME_HDR = struct.Struct("<I")


def _enc_record(rec: DocumentRecord) -> Dict[str, Any]:
    d = rec.to_dict()
    emb = d.pop("embedding", None)
    if emb is not None:
        d["embedding_f32"] = np.asarray(emb, dtype="<f4").tobytes()
    return d


def _dec_record(d: Dict[str, Any]) -> DocumentRecord:
    d = dict(d)
    raw = d.pop("embedding_f32", None)
    if raw is not None:
        d["embedding"] = np.frombuffer(raw, dtype="<f4").tolist()
    return DocumentRecord.from_dict(d)


def write_backup_file(blob: bytes, backup_path: str, count: int) -> Dict[str, Any]:
    """Checksummed single-file backup, written atomically (storage.rs:500-576)."""
    checksum = hashlib.sha256(blob).hexdigest()
    header = json.dumps(
        {"version": 2, "created_at": now_ms(), "count": count,
         "checksum": checksum}).encode()
    tmp = backup_path + ".tmp"
    os.makedirs(os.path.dirname(backup_path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(_FRAME_HDR.pack(len(header)))
        f.write(header)
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, backup_path)
    return {"path": backup_path, "checksum": checksum, "count": count}


def read_backup_file(backup_path: str) -> Tuple[Dict[str, Any], bytes]:
    """Read + checksum-verify a backup file; returns (header, blob)."""
    if not os.path.exists(backup_path):
        raise BackupError(f"backup not found: {backup_path}")
    with open(backup_path, "rb") as f:
        data = f.read()
    (hlen,) = _FRAME_HDR.unpack_from(data, 0)
    header = json.loads(data[_FRAME_HDR.size:_FRAME_HDR.size + hlen])
    blob = data[_FRAME_HDR.size + hlen:]
    if hashlib.sha256(blob).hexdigest() != header.get("checksum"):
        raise BackupError("backup checksum mismatch — refusing to restore")
    return header, blob


def encode_store_payload(docs, kv, level: int = 3) -> bytes:
    """Shared snapshot/backup payload format — all backends must produce and
    consume the same bytes so their backups stay interchangeable."""
    payload = {
        "docs": [_enc_record(r) for r in docs],
        "kv": dict(kv),
        "created_at": now_ms(),
    }
    return _MAGIC + codec.pack_compressed(payload, level)


def decode_store_payload(blob: bytes):
    """Returns (docs dict, kv dict) from an encode_store_payload blob."""
    if blob[:8] != _MAGIC:
        raise SerializationError("bad snapshot magic")
    payload = codec.unpack_compressed(blob[8:])
    docs = {d["id"]: _dec_record(d) for d in payload["docs"]}
    return docs, dict(payload["kv"])


class FileDocumentStore(DocumentStore):
    """In-memory map + durable WAL/snapshot on disk."""

    def __init__(
        self,
        data_dir: str,
        compact_wal_bytes: int = 64 * 1024 * 1024,
        sync_writes: bool = False,
        compression_level: int = 3,
        flush_interval_ms: int = 1000,
    ):
        self.data_dir = data_dir
        self.compact_wal_bytes = compact_wal_bytes
        self.sync_writes = sync_writes
        self._level = compression_level
        self._lock = threading.RLock()
        self._docs: Dict[str, DocumentRecord] = {}
        self._kv: Dict[str, bytes] = {}
        self._last_backup: Optional[int] = None
        self._last_flush: Optional[int] = None
        os.makedirs(data_dir, exist_ok=True)
        self._snapshot_path = os.path.join(data_dir, "snapshot.gvdb")
        self._wal_path = os.path.join(data_dir, "wal.gvdb")
        self._load()
        self._wal = self._open_wal("ab")
        # Background flusher (the reference's sled 1s flush interval,
        # advanced_storage.rs:36-47). sync_writes=True fsyncs inline instead.
        self._stop_flusher = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        if flush_interval_ms > 0 and not sync_writes:
            def _flush_loop() -> None:
                while not self._stop_flusher.wait(flush_interval_ms / 1e3):
                    try:
                        self.flush()
                    except ValueError:
                        return  # file closed underneath us
                    except OSError:
                        continue  # transient I/O error: keep trying
            self._flusher = threading.Thread(target=_flush_loop, daemon=True,
                                             name="gvdb-flusher")
            self._flusher.start()

    # -- load / replay -----------------------------------------------------------

    def _load(self) -> None:
        if os.path.exists(self._snapshot_path):
            with open(self._snapshot_path, "rb") as f:
                blob = f.read()
            self._apply_snapshot_blob(blob)
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                data = f.read()
            if len(data) < len(_WAL_MAGIC) and _WAL_MAGIC.startswith(data):
                pos = 0  # empty, or torn while writing the magic
            elif data[:len(_WAL_MAGIC)] != _WAL_MAGIC:
                # Another format (or another file): refuse, and leave it as
                # it is — truncating it would drop acknowledged writes.
                raise StorageError(
                    f"{self._wal_path}: not a write-ahead log of this format")
            else:
                pos = self._replay(data)
            if pos < len(data):
                # Truncate the torn tail: appending after unparseable bytes
                # would make every later write unreadable on the next replay.
                with open(self._wal_path, "r+b") as f:
                    f.truncate(pos)

    def _replay(self, data: bytes) -> int:
        """Apply the WAL's frames; returns where the complete frames end."""
        pos = len(_WAL_MAGIC)
        while pos + _FRAME_HDR.size <= len(data):
            (ln,) = _FRAME_HDR.unpack_from(data, pos)
            start = pos + _FRAME_HDR.size
            if start + ln > len(data):
                break  # torn tail write — ignore (crash recovery)
            try:
                op = codec.unpack(data[start:start + ln])
            except Exception as e:
                if not data[pos:].strip(b"\0"):
                    break  # zero-filled tail left by a crash
                raise StorageError(
                    f"{self._wal_path}: undecodable record at byte {pos}"
                ) from e
            self._apply_op(op)
            pos = start + ln
        return pos

    def _apply_snapshot_blob(self, blob: bytes) -> None:
        self._docs, self._kv = decode_store_payload(blob)

    def _apply_op(self, op: List[Any]) -> None:
        kind = op[0]
        if kind == "ins":
            for d in op[1]:
                rec = _dec_record(d)
                self._docs[rec.id] = rec
        elif kind == "del":
            for i in op[1]:
                self._docs.pop(i, None)
        elif kind == "kv":
            self._kv[op[1]] = op[2]
        elif kind == "kvdel":
            self._kv.pop(op[1], None)
        elif kind == "clear":
            self._docs.clear()
            self._kv.clear()

    # -- WAL write -----------------------------------------------------------------

    def _open_wal(self, mode: str):
        f = open(self._wal_path, mode)
        if f.tell() == 0:
            f.write(_WAL_MAGIC)
            f.flush()
        return f

    def _append(self, op: List[Any]) -> None:
        buf = codec.pack(op)
        self._wal.write(_FRAME_HDR.pack(len(buf)))
        self._wal.write(buf)
        if self.sync_writes:
            self._wal.flush()
            os.fsync(self._wal.fileno())
        if self._wal.tell() > self.compact_wal_bytes:
            self._compact_locked()

    # -- CRUD -----------------------------------------------------------------------

    def batch_insert(self, records: Sequence[DocumentRecord]) -> None:
        with self._lock:
            for r in records:
                self._docs[r.id] = r
            self._append(["ins", [_enc_record(r) for r in records]])

    def get(self, id_: str) -> Optional[DocumentRecord]:
        return self._docs.get(id_)

    def batch_delete(self, ids: Sequence[str]) -> int:
        with self._lock:
            hit = [i for i in ids if i in self._docs]
            for i in hit:
                del self._docs[i]
            if hit:
                self._append(["del", hit])
            return len(hit)

    def count(self) -> int:
        return len(self._docs)

    def iter_ids(self) -> Iterable[str]:
        return list(self._docs.keys())

    def clear(self) -> None:
        with self._lock:
            self._docs.clear()
            self._kv.clear()
            self._append(["clear"])

    # -- KV ---------------------------------------------------------------------------

    def put_kv(self, key: str, value: bytes) -> None:
        with self._lock:
            self._kv[key] = bytes(value)
            self._append(["kv", key, bytes(value)])

    def get_kv(self, key: str) -> Optional[bytes]:
        return self._kv.get(key)

    def delete_kv(self, key: str) -> bool:
        with self._lock:
            existed = self._kv.pop(key, None) is not None
            if existed:
                self._append(["kvdel", key])
            return existed

    def iter_kv_prefix(self, prefix: str) -> Iterable[Tuple[str, bytes]]:
        with self._lock:
            return [(k, v) for k, v in self._kv.items() if k.startswith(prefix)]

    # -- durability ----------------------------------------------------------------------

    def _snapshot_blob(self) -> bytes:
        return encode_store_payload(self._docs.values(), self._kv,
                                    self._level)

    def _compact_locked(self) -> None:
        blob = self._snapshot_blob()
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path)
        self._wal.close()
        self._wal = self._open_wal("wb")  # truncate

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    def flush(self) -> None:
        with self._lock:
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._last_flush = now_ms()

    def close(self) -> None:
        self._stop_flusher.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
        with self._lock:
            if not self._wal.closed:
                self._compact_locked()
                self._wal.flush()
                self._wal.close()

    # -- backup / restore -------------------------------------------------------------------

    def create_backup(self, backup_path: str) -> Dict[str, Any]:
        """Single-file checksummed backup written atomically (storage.rs:500-576)."""
        with self._lock:
            blob = self._snapshot_blob()
            count = len(self._docs)
        info = write_backup_file(blob, backup_path, count)
        self._last_backup = now_ms()
        return info

    def restore_backup(self, backup_path: str) -> Dict[str, Any]:
        """Checksum-verified restore with pre-restore auto-backup (storage.rs:578-712)."""
        header, blob = read_backup_file(backup_path)
        pre = backup_path + f".pre-restore-{int(time.time())}"
        self.create_backup(pre)
        with self._lock:
            self._apply_snapshot_blob(blob)
            self._compact_locked()
        return {"restored": header.get("count", len(self._docs)), "pre_restore_backup": pre}

    # -- stats --------------------------------------------------------------------------------

    def get_stats(self) -> StorageStats:
        raw = sum(
            len(r.content or "")
            + 4 * (len(r.embedding) if r.embedding is not None else 0)
            + len(str(r.metadata))
            for r in self._docs.values()
        )
        disk = 0
        for p in (self._snapshot_path, self._wal_path):
            if os.path.exists(p):
                disk += os.path.getsize(p)
        return StorageStats(
            document_count=len(self._docs),
            estimated_size_bytes=disk,
            compression_ratio=(disk / raw) if raw else 1.0,
            last_backup_time=self._last_backup,
            last_flush_time=self._last_flush,
        )

    def health_check(self) -> bool:
        try:
            return not self._wal.closed and os.path.isdir(self.data_dir)
        except Exception:
            return False
