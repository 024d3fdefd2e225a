"""The port's copy of ``oncilla_tpu/obs/flightrec.py``, line for line: the
durable flight recorder, a crash-safe journal spill (``OCM_FLIGHTREC``).

The segments are the JAX package's byte for byte (the same header, frames
and names), so either package's reader reads the other's, and the native
daemon's (``runtime/native/obs.cc``). Each package's journal has its own
``jid``, so both can spill into one directory without a collision.

The in-memory journal ring (:mod:`~oncilla_tpu_torch.obs.journal`) dies with
its process — ``Daemon.kill()`` used to discard exactly the evidence the
chaos scenarios exist to produce. With ``OCM_FLIGHTREC=<dir>`` set (or
:func:`set_dir` called), every journal event is ALSO streamed append-only
into bounded, CRC-framed segment files in that directory, so a killed or
crashed daemon leaves its black box on disk for the post-mortem auditor
(:mod:`~oncilla_tpu_torch.obs.audit`).

Segment format (little-endian), one file per ``OCM_FLIGHTREC_SEG_BYTES``
of stream (the PR-5 snapshot CRC discipline, framed per record so an
append-only writer never rewrites a trailer):

  magic ``OCMJ`` | version u8
  per frame: payload_len u32 | crc32(payload) u32 | payload (JSON event)

A frame whose CRC does not match is CORRUPTION and the reader reports it
(kind ``crc``) instead of silently skipping — the auditor turns it into
a typed finding. A frame cut short at end-of-file is a torn tail (kind
``truncated``): what a SIGKILL mid-write legitimately leaves behind, so
it is surfaced in the read stats but is not a correctness finding.

Writers are per-process (every event carries its journal ``jid``; one
process may host many in-process daemons, whose events are told apart by
their ``track`` field). Multiple processes share a directory safely —
segment names embed the jid. Ring dumps (:func:`dump_events`, used by
``Daemon.kill()`` and the chaos controller at kill time) write the same
format into their own segment; the (jid, seq) identity dedups them
against the streamed copies at merge time.

Stdlib-only by the obs-package contract (``utils.debug`` imports the
journal — and through it this module — possibly mid-package-import).
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import threading
import zlib
from contextlib import contextmanager

ENV_DIR = "OCM_FLIGHTREC"
ENV_SEG_BYTES = "OCM_FLIGHTREC_SEG_BYTES"
ENV_MAX_SEGS = "OCM_FLIGHTREC_MAX_SEGS"

MAGIC = b"OCMJ"
VERSION = 1
_HDR = MAGIC + bytes([VERSION])
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
# Sanity bound while reading: no journal event is remotely this large, so
# a length field past it means the stream is garbage (corruption), not a
# big event.
_MAX_FRAME = 16 << 20

_lock = threading.Lock()
_dir: str | None = os.environ.get(ENV_DIR) or None
# Tolerant parse (watchdog.reload_threshold stance): a typo'd size knob
# falls back to the default instead of crashing every obs importer.
try:
    _seg_bytes = int(os.environ.get(ENV_SEG_BYTES, "") or (4 << 20))
except ValueError:
    _seg_bytes = 4 << 20
# 0 = unbounded. With a cap, this WRITER's oldest segment is deleted
# once the cap is exceeded (a long soak used to grow the directory
# without bound); other processes' segments are never touched — their
# names embed a different jid, and deleting someone else's evidence
# would be tampering, not rotation.
try:
    _max_segs = int(os.environ.get(ENV_MAX_SEGS, "") or 0)
except ValueError:
    _max_segs = 0
_own_segs: list[str] = []  # this writer's segments, creation order
_fh = None
_fh_path: str | None = None
_written = 0
_seg_seq = 0  # monotone across set_dir calls: names never collide
_failures = 0
# After this many consecutive write failures the spill disarms itself:
# a full disk must degrade observability, never wedge the data plane.
_MAX_FAILURES = 8


def configured() -> bool:
    return _dir is not None


def segment_dir() -> str | None:
    return _dir


def set_dir(path: str | None) -> None:
    """Point the spill at ``path`` (created if missing); ``None`` turns
    the recorder off. Programmatic twin of ``OCM_FLIGHTREC`` (which is
    read once at import)."""
    global _dir, _fh, _fh_path, _written, _failures
    with _lock:
        if _fh is not None:
            try:
                _fh.close()
            except OSError:
                pass
            _fh = None
            _fh_path = None
        _written = 0
        _failures = 0
        # The rotation cap is scoped per directory: pointing the spill
        # elsewhere must never reach back and delete segments of a
        # finished recording.
        _own_segs.clear()
        if path is not None:
            os.makedirs(path, exist_ok=True)
        _dir = path


def set_seg_bytes(n: int) -> None:
    """Test hook: segment rotation threshold (env twin of
    ``OCM_FLIGHTREC_SEG_BYTES``)."""
    global _seg_bytes
    _seg_bytes = int(n)


def set_max_segs(n: int) -> None:
    """Test hook / programmatic twin of ``OCM_FLIGHTREC_MAX_SEGS``:
    this writer keeps at most ``n`` segments on disk (0 = unbounded),
    deleting its own oldest past the cap."""
    global _max_segs
    _max_segs = int(n)


def _open_segment_locked(jid: str, label: str | None = None):
    global _fh, _fh_path, _written, _seg_seq
    _seg_seq += 1
    name = (
        f"fr-{jid}-{_seg_seq:05d}.seg" if label is None
        else f"fr-{jid}-{label}-{_seg_seq:05d}.seg"
    )
    # The env-var path never goes through set_dir(), so the directory
    # may not exist yet; create it at first segment open.
    os.makedirs(_dir or ".", exist_ok=True)
    path = os.path.join(_dir or ".", name)
    fh = open(path, "wb")
    fh.write(_HDR)
    _own_segs.append(path)
    while _max_segs and len(_own_segs) > _max_segs:
        try:
            os.unlink(_own_segs.pop(0))
        except OSError:
            pass  # already gone (shared tmpdir cleanup): nothing to cap
    if label is None:
        _fh, _fh_path, _written = fh, path, len(_HDR)
    return fh


def _frame(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"), default=str).encode()
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def append(rec: dict) -> None:
    """Stream one journal event into the current segment (rotating past
    the size bound). Never raises: a failing spill counts failures and
    disarms after a few — the flight recorder must not take down the
    plane it observes."""
    global _fh, _fh_path, _written, _failures
    if _dir is None:
        return
    buf = _frame(rec)
    with _lock:
        if _dir is None or _failures >= _MAX_FAILURES:
            return
        try:
            if _fh is None:
                _open_segment_locked(str(rec.get("jid", "nojid")))
            assert _fh is not None
            _fh.write(buf)
            # Flush to the OS per record: a SIGKILL'd process loses at
            # most the frame being written (a torn tail the reader
            # tolerates), and the kernel holds the rest.
            _fh.flush()
            _written += len(buf)
            _failures = 0
            if _written >= _seg_bytes:
                _fh.close()
                _fh = None
                _fh_path = None
        except OSError:
            _failures += 1
            try:
                if _fh is not None:
                    _fh.close()
            except OSError:
                pass
            _fh = None
            _fh_path = None


def dump_events(evts: list[dict], label: str = "ringdump") -> str | None:
    """Write ``evts`` whole into a fresh labelled segment (the kill-time
    ring flush). Returns the path, or None when unconfigured/failed."""
    if _dir is None or not evts:
        return None
    jid = str(evts[0].get("jid", "nojid"))
    with _lock:
        if _dir is None:
            return None
        try:
            fh = _open_segment_locked(jid, label=label)
        except OSError:
            return None
    path = fh.name
    try:
        with fh:
            for rec in evts:
                fh.write(_frame(rec))
            fh.flush()
            os.fsync(fh.fileno())
    except OSError:
        return None
    return path


def flush() -> None:
    """fsync the open segment (graceful-shutdown courtesy)."""
    with _lock:
        if _fh is not None:
            try:
                _fh.flush()
                os.fsync(_fh.fileno())
            except OSError:
                pass


# -- reading ------------------------------------------------------------


def read_segment(path: str) -> tuple[list[dict], list[dict]]:
    """Parse one segment file. Returns ``(events, problems)`` where each
    problem is ``{"path", "offset", "kind", "detail"}`` with kind one of
    ``crc`` (checksum mismatch: corruption — the rest of the file is
    untrusted and skipped), ``decode`` (CRC-valid frame that is not
    JSON), ``header`` (bad magic/version), ``truncated`` (torn tail:
    tolerated crash evidence). Corruption is REPORTED, never silently
    skipped — the auditor escalates crc/decode/header to findings."""
    out: list[dict] = []
    problems: list[dict] = []
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[: len(_HDR)] != _HDR:
        problems.append({
            "path": path, "offset": 0, "kind": "header",
            "detail": f"bad segment magic/version {raw[:5]!r}",
        })
        return out, problems
    off = len(_HDR)
    n = len(raw)
    while off < n:
        if n - off < _FRAME.size:
            problems.append({
                "path": path, "offset": off, "kind": "truncated",
                "detail": f"{n - off} trailing byte(s), short of a frame "
                          "header (torn tail)",
            })
            break
        length, want = _FRAME.unpack_from(raw, off)
        if length > _MAX_FRAME:
            problems.append({
                "path": path, "offset": off, "kind": "crc",
                "detail": f"frame length {length} exceeds the "
                          f"{_MAX_FRAME}-byte bound: corrupt framing",
            })
            break
        body = raw[off + _FRAME.size : off + _FRAME.size + length]
        if len(body) < length:
            problems.append({
                "path": path, "offset": off, "kind": "truncated",
                "detail": f"frame payload cut short ({len(body)}/{length} "
                          "bytes: torn tail)",
            })
            break
        got = zlib.crc32(body)
        if got != want:
            problems.append({
                "path": path, "offset": off, "kind": "crc",
                "detail": f"frame CRC mismatch (stored {want:#010x}, "
                          f"computed {got:#010x}); remainder of the "
                          "segment is untrusted",
            })
            break
        try:
            out.append(json.loads(body))
        except ValueError as e:
            problems.append({
                "path": path, "offset": off, "kind": "decode",
                "detail": f"CRC-valid frame is not JSON: {e}",
            })
            break
        off += _FRAME.size + length
    return out, problems


def read_dir(path: str) -> tuple[list[dict], list[dict]]:
    """Every ``*.seg`` directly in ``path`` (not recursive), merged with
    (jid, seq) dedup — a kill-time ring dump overlaps the stream by
    design. Events keep no particular order; the auditor sorts."""
    events: list[dict] = []
    problems: list[dict] = []
    seen: set[tuple] = set()
    for name in sorted(os.listdir(path)):
        if not name.endswith(".seg"):
            continue
        evts, probs = read_segment(os.path.join(path, name))
        problems.extend(probs)
        for e in evts:
            jid = e.get("jid")
            if jid is not None:
                key = (jid, e.get("seq"))
                if key in seen:
                    continue
                seen.add(key)
            events.append(e)
    return events, problems


def timeline_dirs(path: str) -> list[str]:
    """Every directory under ``path`` (itself included) that holds
    segment files — each is one audit timeline. Separate recordings
    (e.g. a smoke's run 1 and its replay) live in sibling subdirectories
    so their alloc-id/epoch spaces are never conflated."""
    out = []
    for root, _dirs, files in os.walk(path):
        if any(f.endswith(".seg") for f in files):
            out.append(root)
    return sorted(out)


@contextmanager
def recording(path: str | None = None):
    """Enable journaling + spill for a block::

        with flightrec.recording("/tmp/fr/run1") as d:
            ... chaos scenario ...
        findings, stats = audit.audit_dir(d)

    ``path=None`` spills under ``$OCM_FLIGHTREC`` (subdir ``rec-<n>``)
    or a fresh temp dir. The journal RING is cleared on entry (so
    kill-time ring dumps cannot leak a previous recording's events into
    this timeline) and the prior spill/enable state is restored on exit.
    The directory is always left on disk — it is the black box.
    """
    from oncilla_tpu_torch.obs import journal  # late: journal imports us

    global _seg_seq
    if path is None:
        base = os.environ.get(ENV_DIR)
        if base:
            with _lock:
                _seg_seq += 1
                n = _seg_seq
            path = os.path.join(base, f"rec-{n:05d}")
        else:
            path = tempfile.mkdtemp(prefix="ocm-flightrec-")
    prev_dir = segment_dir()
    prev_enabled = journal.enabled()
    journal.clear()
    journal.set_enabled(True)
    set_dir(path)
    try:
        yield path
    finally:
        flush()
        set_dir(prev_dir)
        journal.set_enabled(prev_enabled)
