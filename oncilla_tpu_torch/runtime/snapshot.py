"""Daemon checkpoint/resume.

The reference persists nothing: killing the daemon unlinks its mqueues and
every allocation is gone (reference src/main.c:170-184, SURVEY.md
§5.4). Here a daemon can snapshot its registry — and, for the REMOTE_HOST
arm, the actual bytes — to a file, and a restarting daemon restores it:
alloc ids, extents, and data survive, so clients holding handles keep
working across a daemon restart.

Binary format (little-endian), written identically by the Python and C++
daemons so snapshots are interchangeable:

  magic "OCMS" | version u8 | rank i64 | id_counter u64 | nentries u32
  per entry: alloc_id u64 | kind u8 | device_index u32 | offset u64 |
             nbytes u64 | origin_rank i64 | origin_pid i64 | data_len u64 |
             data (host-kind entries carry their live bytes; device-kind
             entries carry none — HBM contents belong to the app processes)
  v2 trailer: crc32 u32 over every preceding byte (header + entries)

Version 2 adds the CRC trailer so a torn or bit-flipped snapshot is
refused WHOLE at load time (magic/version alone only catch header damage;
a flipped byte inside an entry previously restored garbage silently).
Version-1 files (no trailer) still load — they predate the guard.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

from oncilla_tpu_torch.core.errors import OcmProtocolError

MAGIC = b"OCMS"
VERSION = 2  # v2: trailing CRC32 integrity guard
_HDR = struct.Struct("<4sBqQI")
_ENTRY = struct.Struct("<QBIQQqqQ")
_CRC = struct.Struct("<I")


@dataclass
class SnapEntry:
    alloc_id: int
    kind: int  # wire kind tag
    device_index: int
    offset: int
    nbytes: int
    origin_rank: int
    origin_pid: int
    data: bytes = b""


@dataclass
class Snapshot:
    rank: int
    id_counter: int
    entries: list[SnapEntry]


def dump(snap: Snapshot) -> bytes:
    out = bytearray()
    out += _HDR.pack(MAGIC, VERSION, snap.rank, snap.id_counter,
                     len(snap.entries))
    for e in snap.entries:
        out += _ENTRY.pack(
            e.alloc_id, e.kind, e.device_index, e.offset, e.nbytes,
            e.origin_rank, e.origin_pid, len(e.data),
        )
        out += e.data
    out += _CRC.pack(zlib.crc32(out))
    return bytes(out)


def load(raw: bytes) -> Snapshot:
    if len(raw) < _HDR.size:
        raise OcmProtocolError("truncated snapshot")
    magic, version, rank, counter, n = _HDR.unpack_from(raw, 0)
    if magic != MAGIC:
        raise OcmProtocolError("bad snapshot magic")
    if version not in (1, VERSION):
        raise OcmProtocolError(f"unsupported snapshot version {version}")
    if version >= 2:
        # Integrity gate BEFORE any entry parsing: a corrupt snapshot must
        # be refused whole (never half-loaded into a live registry).
        if len(raw) < _HDR.size + _CRC.size:
            raise OcmProtocolError("truncated snapshot (missing CRC)")
        (want,) = _CRC.unpack_from(raw, len(raw) - _CRC.size)
        got = zlib.crc32(raw[: len(raw) - _CRC.size])
        if got != want:
            raise OcmProtocolError(
                f"snapshot CRC mismatch (stored {want:#010x}, computed "
                f"{got:#010x}): truncated or corrupt — refusing to restore"
            )
        raw = raw[: len(raw) - _CRC.size]
    off = _HDR.size
    entries = []
    for _ in range(n):
        if len(raw) - off < _ENTRY.size:
            raise OcmProtocolError("truncated snapshot")
        (alloc_id, kind, dev, offset, nbytes, orank, opid, dlen) = (
            _ENTRY.unpack_from(raw, off)
        )
        off += _ENTRY.size
        data = raw[off : off + dlen]
        if len(data) != dlen:
            raise OcmProtocolError("truncated snapshot")
        off += dlen
        entries.append(
            SnapEntry(alloc_id, kind, dev, offset, nbytes, orank, opid, data)
        )
    return Snapshot(rank=rank, id_counter=counter, entries=entries)


def write_file(path: str, snap: Snapshot) -> None:
    write_file_iter(path, snap.rank, snap.id_counter,
                    len(snap.entries), iter(snap.entries))


def write_file_iter(path, rank: int, id_counter: int, nentries: int, entries):
    """Stream entries to disk one at a time, so peak memory overhead is one
    entry's bytes rather than the whole live arena (entries may be a lazy
    generator that reads arena bytes on demand)."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            # CRC accumulates incrementally over exactly the bytes written,
            # so streaming keeps its one-entry memory bound.
            head = _HDR.pack(MAGIC, VERSION, rank, id_counter, nentries)
            crc = zlib.crc32(head)
            f.write(head)
            for e in entries:
                rec = _ENTRY.pack(
                    e.alloc_id, e.kind, e.device_index, e.offset, e.nbytes,
                    e.origin_rank, e.origin_pid, len(e.data),
                )
                crc = zlib.crc32(rec, crc)
                f.write(rec)
                crc = zlib.crc32(e.data, crc)
                f.write(e.data)
            f.write(_CRC.pack(crc))
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        # Never leave a half-written .tmp behind (and never rename it in).
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)  # atomic


def read_file(path: str) -> Snapshot:
    with open(path, "rb") as f:
        return load(f.read())
