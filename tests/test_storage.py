"""Storage-layer tests: WAL replay, compaction, checksummed backup/restore
(mirrors the reference's real-filesystem test philosophy,
tests/complete_enterprise_tests.rs:1-4)."""

import os

import numpy as np
import pytest

from grape_vector_db_tpu.errors import BackupError, StorageError
from grape_vector_db_tpu.storage import FileDocumentStore, MemoryDocumentStore
from grape_vector_db_tpu.types import DocumentRecord


def mkrec(i, dim=8):
    return DocumentRecord(
        id=f"doc-{i}",
        content=f"content number {i}",
        title=f"title {i}",
        embedding=list(np.arange(dim, dtype=np.float32) + i),
        metadata={"category": "a" if i % 2 == 0 else "b", "rank": i},
    )


def test_memory_store_crud():
    s = MemoryDocumentStore()
    s.batch_insert([mkrec(i) for i in range(10)])
    assert s.count() == 10
    assert s.get("doc-3").title == "title 3"
    assert s.batch_delete(["doc-3", "doc-404"]) == 1
    assert s.count() == 9
    assert s.get("doc-3") is None


def test_store_search_parity():
    s = MemoryDocumentStore()
    s.batch_insert([mkrec(i) for i in range(20)])
    hits = s.vector_search(mkrec(5).embedding, limit=3)
    assert hits[0].id == "doc-5"
    text = s.text_search("number 7", limit=5)
    assert text and text[0].id == "doc-7"
    hybrid = s.hybrid_search(mkrec(5).embedding, "number 5", limit=3)
    assert hybrid[0].id == "doc-5"


def test_file_store_wal_replay(tmp_path):
    d = str(tmp_path / "db")
    s = FileDocumentStore(d)
    s.batch_insert([mkrec(i) for i in range(50)])
    s.batch_delete(["doc-0", "doc-1"])
    s.put_kv("raft_state_term", b"\x07")
    s.flush()
    # re-open without compaction: WAL replay restores state
    s2 = FileDocumentStore(d)
    assert s2.count() == 48
    assert s2.get("doc-10").content == "content number 10"
    assert s2.get_kv("raft_state_term") == b"\x07"
    np.testing.assert_allclose(s2.get("doc-10").embedding, mkrec(10).embedding)
    s.close()
    s2.close()


def test_file_store_compaction_and_reopen(tmp_path):
    d = str(tmp_path / "db")
    s = FileDocumentStore(d)
    s.batch_insert([mkrec(i) for i in range(30)])
    s.compact()
    with open(os.path.join(d, "wal.gvdb"), "rb") as f:
        assert f.read() == b"GVDBW001"  # only the format header is left
    s.close()
    s3 = FileDocumentStore(d)
    assert s3.count() == 30
    s3.close()


def test_backup_restore_roundtrip(tmp_path):
    d = str(tmp_path / "db")
    bak = str(tmp_path / "backups" / "b1.gvdb")
    s = FileDocumentStore(d)
    s.batch_insert([mkrec(i) for i in range(25)])
    info = s.create_backup(bak)
    assert info["count"] == 25 and os.path.exists(bak)

    s.batch_delete([f"doc-{i}" for i in range(20)])
    assert s.count() == 5
    out = s.restore_backup(bak)
    assert s.count() == 25
    assert os.path.exists(out["pre_restore_backup"])
    s.close()


def test_backup_checksum_verification(tmp_path):
    d = str(tmp_path / "db")
    bak = str(tmp_path / "b.gvdb")
    s = FileDocumentStore(d)
    s.batch_insert([mkrec(1)])
    s.create_backup(bak)
    # corrupt the payload tail
    with open(bak, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x00")
    with pytest.raises(BackupError):
        s.restore_backup(bak)
    s.close()


def test_torn_wal_tail_recovery(tmp_path):
    d = str(tmp_path / "db")
    s = FileDocumentStore(d)
    s.batch_insert([mkrec(i) for i in range(5)])
    s.flush()
    s.close()
    # simulate crash mid-append: write garbage partial frame
    with open(os.path.join(d, "wal.gvdb"), "ab") as f:
        f.write(b"\xff\xff\xff\x7f partial")
    s2 = FileDocumentStore(d)
    assert s2.count() == 5  # torn tail ignored
    s2.close()


def test_foreign_format_wal_is_refused_and_kept(tmp_path):
    # A WAL from another format (here a msgpack-framed ["ins", []] record, as
    # older versions wrote) must not be read as a torn tail and truncated.
    d = tmp_path / "db"
    d.mkdir()
    body = b"\x92\xa3ins\x90"
    old = len(body).to_bytes(4, "little") + body
    (d / "wal.gvdb").write_bytes(old)
    with pytest.raises(StorageError):
        FileDocumentStore(str(d))
    assert (d / "wal.gvdb").read_bytes() == old


def test_corrupt_complete_wal_frame_is_refused(tmp_path):
    d = str(tmp_path / "db")
    s = FileDocumentStore(d)
    s.batch_insert([mkrec(i) for i in range(3)])
    s.flush()
    s._wal.close()  # simulate a crash: no compaction on close
    wal = os.path.join(d, "wal.gvdb")
    with open(wal, "ab") as f:
        f.write((6).to_bytes(4, "little") + b"garbag")
    before = open(wal, "rb").read()
    with pytest.raises(StorageError):
        FileDocumentStore(d)
    assert open(wal, "rb").read() == before


def test_wal_replays_without_compaction(tmp_path):
    d = str(tmp_path / "db")
    s = FileDocumentStore(d)
    s.batch_insert([mkrec(i) for i in range(4)])
    s.put_kv("raft/term", b"\x07")
    s.flush()
    s._wal.close()  # killed before close(): only the WAL holds the writes
    with open(os.path.join(d, "wal.gvdb"), "ab") as f:
        f.write(b"\0" * 16)  # zero-filled tail a crash can leave
    s2 = FileDocumentStore(d)
    assert s2.count() == 4 and s2.get_kv("raft/term") == b"\x07"
    s2.batch_insert([mkrec(9)])
    s2.close()
    assert FileDocumentStore(d).count() == 5
