"""Disk-backed :class:`FrozenStore` — one file per frozen extent.

On-disk format (``<name>.ocmf``), the snapshot-v2 discipline applied to
a single extent::

    magic "OCMF" | version u8 | meta_len u32 | meta (JSON, utf-8)
    | payload bytes | CRC32 u32          (over everything before it)

Writes are atomic (tmp file + fsync + ``os.replace``): a crash mid-write
leaves either the previous complete file or a ``.tmp`` orphan that the
next open removes — never a half-written ``.ocmf``. Torn or corrupt
entries are refused WHOLE: the open-time scan CRC-verifies every file,
quarantines failures by renaming them ``.corrupt`` (evidence kept, never
re-adopted), and reports them on :attr:`FrozenStore.lost` so a daemon
can count them as ``ocm_frozen_lost_total`` — a corrupt extent is a
*reported loss*, never silently skipped and never served as garbage.

Reads re-verify the trailer (bit rot between open and read is a loss,
not a payload). The store is thread-safe: the daemon's reaper demotes
while serve threads thaw.

Stdlib-only (json/struct/zlib/os): this module must be importable from
the daemon process without the model stack.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass

from oncilla_tpu_torch.core.errors import OcmError, OcmInvalidHandle, OcmOutOfMemory

MAGIC = b"OCMF"
VERSION = 1
_HDR = struct.Struct("<4sBI")  # magic | version | meta_len
_CRC = struct.Struct("<I")
SUFFIX = ".ocmf"
_QUARANTINE = ".corrupt"


class OcmFrozenCorrupt(OcmError):
    """A frozen extent failed its CRC/format check — refused whole."""


@dataclass(frozen=True)
class LostExtent:
    """One refused frozen entry: where it was and why it was refused."""

    key: str
    path: str
    detail: str


def _fname(key: str) -> str:
    """Filesystem name for a store key. Keys are daemon-minted
    (``alloc-<id>``, ``page-<n>``, ``prefix-<hex>``) so the charset is
    already safe; anything else is refused early rather than mangled."""
    if not key or not all(c.isalnum() or c in "._-" for c in key):
        raise ValueError(f"frozen key {key!r} is not filesystem-safe")
    return key + SUFFIX


class FrozenStore:
    """One directory of CRC-trailed extent files plus an in-memory index.

    ``max_bytes`` (0 = unbounded) caps the payload bytes stored; a write
    past the budget raises :class:`OcmOutOfMemory` so the demotion path
    falls back to destroying the victim exactly as it did before the
    FROZEN tier existed.
    """

    def __init__(self, root: str, max_bytes: int = 0) -> None:
        self.root = root
        self.max_bytes = int(max_bytes)
        self._mu = threading.Lock()
        # key -> (path, payload_nbytes, meta)
        self._index: dict[str, tuple[str, int, dict]] = {}
        self.lost: list[LostExtent] = []
        os.makedirs(root, exist_ok=True)
        self._scan()

    # -- open-time adoption ----------------------------------------------

    def _scan(self) -> None:
        for name in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, name)
            if name.endswith(".tmp"):
                # Crash mid-write: the replace never happened, the old
                # complete file (if any) is still the truth.
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if not name.endswith(SUFFIX):
                continue
            key = name[: -len(SUFFIX)]
            try:
                nbytes, meta = self._verify(path)
            except (OcmFrozenCorrupt, OSError) as exc:
                self._quarantine(key, path, str(exc))
                continue
            self._index[key] = (path, nbytes, meta)

    def _quarantine(self, key: str, path: str, detail: str) -> None:
        qpath = path + _QUARANTINE
        try:
            os.replace(path, qpath)
        except OSError:
            qpath = path
        self.lost.append(LostExtent(key=key, path=qpath, detail=detail))

    @staticmethod
    def _verify(path: str) -> tuple[int, dict]:
        """Full-file CRC + format check; returns (payload_nbytes, meta)
        or raises :class:`OcmFrozenCorrupt`. The WHOLE file is verified —
        a torn tail refuses the entry even if the header parses."""
        with open(path, "rb") as fh:
            blob = fh.read()
        if len(blob) < _HDR.size + _CRC.size:
            raise OcmFrozenCorrupt(f"{path}: truncated ({len(blob)} bytes)")
        magic, version, meta_len = _HDR.unpack_from(blob, 0)
        if magic != MAGIC:
            raise OcmFrozenCorrupt(f"{path}: bad magic {magic!r}")
        if version != VERSION:
            raise OcmFrozenCorrupt(f"{path}: unsupported version {version}")
        body, trailer = blob[: -_CRC.size], blob[-_CRC.size :]
        if zlib.crc32(body) & 0xFFFFFFFF != _CRC.unpack(trailer)[0]:
            raise OcmFrozenCorrupt(f"{path}: CRC mismatch")
        meta_end = _HDR.size + meta_len
        if meta_end > len(body):
            raise OcmFrozenCorrupt(f"{path}: meta overruns file")
        try:
            meta = json.loads(body[_HDR.size : meta_end].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise OcmFrozenCorrupt(f"{path}: meta undecodable: {exc}") from None
        return len(body) - meta_end, meta

    # -- introspection ----------------------------------------------------

    def keys(self) -> list[str]:
        with self._mu:
            return sorted(self._index)

    def has(self, key: str) -> bool:
        with self._mu:
            return key in self._index

    def meta(self, key: str) -> dict:
        with self._mu:
            try:
                return dict(self._index[key][2])
            except KeyError:
                raise OcmInvalidHandle(f"no frozen entry {key!r}") from None

    def payload_nbytes(self, key: str) -> int:
        with self._mu:
            try:
                return self._index[key][1]
            except KeyError:
                raise OcmInvalidHandle(f"no frozen entry {key!r}") from None

    @property
    def bytes_stored(self) -> int:
        with self._mu:
            return sum(n for _, n, _ in self._index.values())

    def has_room(self, nbytes: int) -> bool:
        if self.max_bytes <= 0:
            return True
        return self.bytes_stored + int(nbytes) <= self.max_bytes

    # -- mutation ---------------------------------------------------------

    def write(self, key: str, data: bytes, meta: dict | None = None) -> None:
        """Atomically persist ``key``. Raises :class:`OcmOutOfMemory`
        past the byte budget (the caller's cue to destroy instead)."""
        data = bytes(data)
        path = os.path.join(self.root, _fname(key))
        with self._mu:
            stored = sum(n for _, n, _ in self._index.values())
            prev = self._index.get(key)
            if prev is not None:
                stored -= prev[1]
            if self.max_bytes > 0 and stored + len(data) > self.max_bytes:
                raise OcmOutOfMemory(
                    f"frozen store {self.root}: {stored + len(data)} "
                    f"> budget {self.max_bytes}"
                )
            meta = dict(meta or {})
            mblob = json.dumps(
                meta, separators=(",", ":"), sort_keys=True
            ).encode("utf-8")
            body = _HDR.pack(MAGIC, VERSION, len(mblob)) + mblob + data
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(body)
                fh.write(_CRC.pack(zlib.crc32(body) & 0xFFFFFFFF))
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            self._index[key] = (path, len(data), meta)

    def read(self, key: str) -> tuple[bytes, dict]:
        """Payload + meta, CRC re-verified at read. A failure here is a
        loss event: the entry quarantines, joins :attr:`lost`, and the
        caller gets the typed :class:`OcmFrozenCorrupt` — garbage is
        never returned."""
        with self._mu:
            try:
                path, _, _ = self._index[key]
            except KeyError:
                raise OcmInvalidHandle(f"no frozen entry {key!r}") from None
            try:
                nbytes, meta = self._verify(path)
            except (OcmFrozenCorrupt, OSError) as exc:
                del self._index[key]
                self._quarantine(key, path, str(exc))
                raise OcmFrozenCorrupt(str(exc)) from None
            with open(path, "rb") as fh:
                blob = fh.read()
            start = len(blob) - _CRC.size - nbytes
            return blob[start : start + nbytes], meta

    def read_bytes(self, key: str) -> bytes:
        return self.read(key)[0]

    def delete(self, key: str) -> None:
        """Idempotent removal (promotion / free of a frozen entry)."""
        with self._mu:
            rec = self._index.pop(key, None)
        if rec is not None:
            try:
                os.unlink(rec[0])
            except OSError:
                pass

    def clear(self) -> None:
        for key in self.keys():
            self.delete(key)
