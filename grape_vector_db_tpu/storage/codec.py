"""Standard-library record codec for the stores, snapshots and backups.

A value is JSON (dicts with string keys, lists, strings, numbers, booleans,
None, and non-finite floats) whose ``bytes`` leaves travel beside it as raw
binary blobs, so embeddings stay raw little-endian float32 bytes instead of
number lists:

    frame = <u32 json length> <u32 blob count> json (utf-8)
            <u64 blob length> * count   blobs, back to back

Inside the JSON a blob is the one-key object ``{"\\u0000b": index}``.
Snapshot payloads are additionally deflated with ``zlib``.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, List

__all__ = ["pack", "unpack", "pack_compressed", "unpack_compressed"]

_HDR = struct.Struct("<II")
_BLOB_KEY = "\x00b"


def _strip(obj: Any, blobs: List[bytes]) -> Any:
    if isinstance(obj, (bytes, bytearray, memoryview)):
        blobs.append(bytes(obj))
        return {_BLOB_KEY: len(blobs) - 1}
    if isinstance(obj, dict):
        return {str(k): _strip(v, blobs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_strip(v, blobs) for v in obj]
    return obj


def pack(obj: Any) -> bytes:
    """Encode ``obj`` into one self-delimiting frame."""
    blobs: List[bytes] = []
    text = json.dumps(_strip(obj, blobs), separators=(",", ":"),
                      ensure_ascii=False).encode()
    lens = struct.pack(f"<{len(blobs)}Q", *(len(b) for b in blobs))
    return b"".join([_HDR.pack(len(text), len(blobs)), text, lens, *blobs])


def unpack(buf: bytes) -> Any:
    """Decode a frame written by :func:`pack`."""
    view = memoryview(buf)
    tlen, nblobs = _HDR.unpack_from(view, 0)
    pos = _HDR.size
    text = bytes(view[pos:pos + tlen])
    pos += tlen
    lens = struct.unpack_from(f"<{nblobs}Q", view, pos)
    pos += 8 * nblobs
    blobs = []
    for ln in lens:
        if pos + ln > len(view):
            raise ValueError("truncated frame")
        blobs.append(bytes(view[pos:pos + ln]))
        pos += ln

    def hook(d):
        if len(d) == 1 and _BLOB_KEY in d:
            return blobs[d[_BLOB_KEY]]
        return d

    return json.loads(text, object_hook=hook)


def pack_compressed(obj: Any, level: int = 3) -> bytes:
    return zlib.compress(pack(obj), level)


def unpack_compressed(buf: bytes) -> Any:
    return unpack(zlib.decompress(buf))
