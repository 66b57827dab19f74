"""Shared pickle-5 message framing for the serializing transports.

FileMPI and SocketComm both move Python objects with the same contract —
pickle protocol 5 with *out-of-band* buffers, so ndarray payloads travel
as their raw bytes and are never re-encoded into the pickle stream — and
both chunk oversize payloads at ``PPYTHON_MAX_MSG_BYTES``.  This module
is the one copy of that machinery.

Flat frame layout (``encode_frame``/``decode_frame``): the pickle bytes
first, then the raw out-of-band buffers, then a fixed-size trailer of
per-buffer lengths + counts + a flag byte + magic.  Putting the pickle
stream first keeps the paper's debugging affordance: a buffer-free
message sitting on disk can still be inspected with a naive
``pickle.load`` (the loader stops at the STOP opcode and never sees the
trailer).  Decoding over a copy-on-write mmap (FileMPI) or a reassembled
``bytearray`` (SocketComm chunks) reconstructs arrays directly over that
memory — zero re-copy on receive.

The port's own copy of ``repro.comm.frame`` (NumPy only), for the checkpoint's
``Dmat`` paths; it differs from the original in its docstrings alone.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import struct
from pathlib import Path
from typing import Any

__all__ = [
    "FLAG_CHUNKED",
    "FOOT",
    "MAGIC",
    "ChunkHeader",
    "chunk_windows",
    "decode_frame",
    "encode_frame",
    "max_msg_bytes",
    "oob_buffers",
    "read_footer",
    "read_trailer",
    "tag_token",
]

MAGIC = b"PPK5"
FOOT = struct.Struct("<QIB4s")  # head_len, nbuf, flags, magic — at frame end
FLAG_CHUNKED = 1


def max_msg_bytes() -> int:
    """Chunking threshold; 0 (default) disables chunking."""
    return int(os.environ.get("PPYTHON_MAX_MSG_BYTES", "0") or 0)


class ChunkHeader:
    """First message of a chunked payload: how many raw pieces follow."""

    def __init__(self, nchunks: int, total: int):
        self.nchunks = nchunks
        self.total = total


def oob_buffers(obj: Any) -> tuple[bytes, list]:
    """Pickle ``obj`` with out-of-band buffers: returns the pickle head
    and the raw byte views the head references (contiguous exporters are
    zero-copy; non-contiguous ones fall back to a copy)."""
    buffers: list[pickle.PickleBuffer] = []
    head = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    raws = []
    for b in buffers:
        try:
            raws.append(b.raw())
        except BufferError:  # non-contiguous exporter: fall back to a copy
            raws.append(bytes(b))
    return head, raws


def encode_frame(obj: Any, flags: int = 0) -> list:
    """Serialize ``obj`` into a list of bytes-like pieces (no joining —
    the caller streams them straight to the file/socket)."""
    head, raws = oob_buffers(obj)
    parts: list = [head]
    parts.extend(raws)
    parts.append(struct.pack(f"<{len(raws)}Q", *[len(r) for r in raws]))
    parts.append(FOOT.pack(len(head), len(raws), flags, MAGIC))
    return parts


def chunk_windows(parts, limit: int):
    """Split a flat frame (``encode_frame`` pieces) into ``<= limit``-byte
    windows of memoryview slices, yielding ``(offset, slices)`` per
    window.  No join: the sender streams slices straight off the frame
    pieces and never holds payload + a wire copy (SocketComm and ShmComm
    both chunk oversize payloads through this one walk)."""
    views = [memoryview(p) for p in parts]
    off = 0
    while views:
        slices, room = [], limit
        while views and room:
            take = min(len(views[0]), room)
            slices.append(views[0][:take])
            if take == len(views[0]):
                views.pop(0)
            else:
                views[0] = views[0][take:]
            room -= take
        yield off, slices
        off += limit - room


def read_footer(path: Path) -> tuple[int, int, int] | None:
    """(head_len, nbuf, flags) from a published frame file's trailing
    bytes, or None if the file vanished or is not a valid frame."""
    try:
        with open(path, "rb") as f:
            f.seek(-FOOT.size, os.SEEK_END)
            head_len, nbuf, flags, magic = FOOT.unpack(f.read(FOOT.size))
    except (FileNotFoundError, OSError, struct.error):
        return None
    if magic != MAGIC:
        return None
    return head_len, nbuf, flags


def read_trailer(path: Path) -> tuple[int, tuple[int, ...], int] | None:
    """(head_len, per-buffer byte lengths, flags) from a published frame
    file's trailing bytes, or None if the file vanished or is not a
    valid frame.

    This is the receive-into planning read: knowing every out-of-band
    buffer's length (not just the count the footer carries) lets a
    receiver decide — before touching the payload — whether the raw
    bytes can be streamed straight into a caller-owned buffer.
    """
    try:
        with open(path, "rb") as f:
            f.seek(-FOOT.size, os.SEEK_END)
            head_len, nbuf, flags, magic = FOOT.unpack(f.read(FOOT.size))
            if magic != MAGIC:
                return None
            f.seek(-(FOOT.size + 8 * nbuf), os.SEEK_END)
            lens = struct.unpack(f"<{nbuf}Q", f.read(8 * nbuf))
    except (FileNotFoundError, OSError, struct.error):
        return None
    return head_len, lens, flags


def decode_frame(buf) -> Any:
    """Rebuild an object from a frame held in a bytes-like ``buf``.

    When ``buf`` is a copy-on-write mmap of the message file (or a
    reassembled chunk buffer), array payloads are reconstructed directly
    over that memory — the raw bytes are never copied into userspace a
    second time.
    """
    mv = memoryview(buf)
    head_len, nbuf, _flags, magic = FOOT.unpack_from(mv, len(mv) - FOOT.size)
    if magic != MAGIC:
        raise ValueError(f"bad message frame magic {magic!r}")
    lens = struct.unpack_from(
        f"<{nbuf}Q", mv, len(mv) - FOOT.size - 8 * nbuf
    )
    head = mv[:head_len]
    bufs = []
    off = head_len
    for n in lens:
        bufs.append(mv[off : off + n])
        off += n
    return pickle.loads(head, buffers=bufs)


def tag_token(tag: Any) -> str:
    """Filesystem- and wire-safe token for an arbitrary hashable tag."""
    s = repr(tag)
    if len(s) <= 40 and all(c.isalnum() or c in "._-" for c in s):
        return s
    return hashlib.sha1(s.encode()).hexdigest()[:16]
