"""The port's copy of ``oncilla_tpu/obs/export.py``, line for line, with the
imports renamed to the port's modules.

Merge event journals into one Perfetto/Chrome-trace JSON.

Input: event dicts from any number of :mod:`~oncilla_tpu_torch.obs.journal`
sources — the local process ring, ``STATUS_EVENTS`` pulls from daemons,
JSONL files on disk. Output: the Chrome trace-event format (a dict with
``traceEvents``), loadable in Perfetto / ``chrome://tracing``:

- every distinct ``track`` (client process, ``daemon-r<N>``) becomes one
  pid track with a ``process_name`` metadata record, threads within it
  keep their names;
- ``span`` events become complete (``ph: X``) slices;
- journal point events (lease renew/reclaim, stripe retry, tuner change,
  slow op) become instants (``ph: i``);
- spans sharing a ``trace_id`` across DIFFERENT tracks are stitched with
  flow events (``ph: s``/``t``/``f``) — the visible arrow from the
  client's op to the daemon hop(s) it caused.

Merging dedupes on (jid, seq): the in-process test cluster serves every
daemon's STATUS_EVENTS from the one ring the client also reads, so the
same physical event can arrive via several sources.
"""

from __future__ import annotations

import json


def merge(*event_lists: list[dict]) -> list[dict]:
    """Concatenate event streams, dropping (jid, seq) duplicates, ordered
    by wall clock (the only clock shared across processes) with a
    (jid, seq) tiebreak: two events one process recorded in the same
    wall-clock millisecond keep their true program order instead of the
    arbitrary interleaving a ts-only sort gave them. Events from
    pre-journal sources (no jid) sort on bare ts as before."""
    seen: set[tuple] = set()
    out: list[dict] = []
    for evts in event_lists:
        for e in evts:
            jid = e.get("jid")
            if jid is not None:
                key = (jid, e.get("seq"))
                if key in seen:
                    continue
                seen.add(key)
            out.append(e)
    out.sort(key=lambda e: (
        e.get("ts", 0.0), str(e.get("jid", "")), e.get("seq", 0)
    ))
    return out


def _track_of(e: dict) -> str:
    return str(e.get("track") or f"pid{e.get('pid', 0)}")


def chrome_trace(events: list[dict]) -> dict:
    """Build the Chrome trace-event dict (pure; write_chrome_trace adds
    the file)."""
    tracks: dict[str, int] = {}
    tids: dict[tuple[str, int], int] = {}
    out: list[dict] = []

    def pid_of(e: dict) -> int:
        track = _track_of(e)
        p = tracks.get(track)
        if p is None:
            p = tracks[track] = len(tracks) + 1
            out.append({
                "name": "process_name", "ph": "M", "pid": p, "tid": 0,
                "args": {"name": track},
            })
        return p

    def tid_of(e: dict, p: int) -> int:
        key = (_track_of(e), int(e.get("tid", 0)))
        t = tids.get(key)
        if t is None:
            t = tids[key] = len([k for k in tids if k[0] == key[0]]) + 1
            out.append({
                "name": "thread_name", "ph": "M", "pid": p, "tid": t,
                "args": {"name": str(e.get("thread", f"tid{key[1]}"))},
            })
        return t

    # Spans grouped per trace for the cross-track flow pass.
    by_trace: dict[int, list[tuple[float, int, int, str]]] = {}
    # Lifecycle instants for the hedge/cancel stitching pass:
    # key -> [(ts_us, pid, tid, ev_name)] in merge order.
    hedges: dict[object, list[tuple[float, int, int, str]]] = {}
    cancels: dict[object, list[tuple[float, int, int, str]]] = {}
    for e in events:
        p = pid_of(e)
        t = tid_of(e, p)
        ev = e.get("ev")
        if ev in ("hedge_fired", "hedge_won", "hedge_lost"):
            hedges.setdefault(e.get("alloc_id"), []).append(
                (float(e.get("ts", 0.0)) * 1e6, p, t, str(ev))
            )
        elif ev in ("cancel_sent", "cancel_ack"):
            cancels.setdefault(e.get("tag"), []).append(
                (float(e.get("ts", 0.0)) * 1e6, p, t, str(ev))
            )
        if e.get("ev") == "span":
            ts_us = float(e.get("t_wall") or e.get("ts", 0.0)) * 1e6
            dur_us = float(e.get("dur_us", 0.0))
            args = {
                "nbytes": e.get("nbytes", 0),
                "trace_id": f"{e.get('trace_id', 0):016x}",
                "span_id": f"{e.get('span_id', 0):016x}",
                "parent_span_id": f"{e.get('parent_span_id', 0):016x}",
            }
            out.append({
                "name": str(e.get("op", "?")), "cat": "ocm", "ph": "X",
                "ts": ts_us, "dur": max(dur_us, 0.001), "pid": p, "tid": t,
                "args": args,
            })
            tr = int(e.get("trace_id", 0))
            if tr:
                by_trace.setdefault(tr, []).append(
                    (ts_us, p, t, str(e.get("op", "?")))
                )
        else:
            out.append({
                "name": str(e.get("ev", "event")), "cat": "ocm", "ph": "i",
                "s": "t", "ts": float(e.get("ts", 0.0)) * 1e6,
                "pid": p, "tid": t,
                "args": {
                    k: v for k, v in e.items()
                    if k not in ("ev", "ts", "mono", "pid", "tid", "thread",
                                 "jid", "seq", "track")
                },
            })

    # Flow stitching: one arrow chain per trace_id that touches >1 track.
    for tr, spans in sorted(by_trace.items()):
        pids = {p for _, p, _, _ in spans}
        if len(pids) < 2:
            continue
        spans.sort()
        flow_id = f"{tr:016x}"
        for i, (ts_us, p, t, _op) in enumerate(spans):
            ph = "s" if i == 0 else ("f" if i == len(spans) - 1 else "t")
            ev = {
                "name": "trace", "cat": "ocm.flow", "ph": ph,
                "id": flow_id, "ts": ts_us + 0.001, "pid": p, "tid": t,
            }
            if ph == "f":
                ev["bp"] = "e"  # bind to the enclosing slice
            out.append(ev)

    # Lifecycle stitching: hedged reads and cancels used to render as
    # unconnected instants, leaving the reader to eyeball which
    # hedge_won answered which hedge_fired. Pair each opener with the
    # NEAREST SUBSEQUENT closer sharing its key (alloc_id for hedges,
    # tag for cancels) and draw a dedicated flow arrow per pair.
    def stitch(groups: dict, openers: tuple, prefix: str) -> None:
        n = 0
        for key, evts in sorted(groups.items(), key=lambda kv: str(kv[0])):
            evts.sort(key=lambda r: r[0])
            pending: list[tuple[float, int, int, str]] = []
            for rec in evts:
                if rec[3] in openers:
                    pending.append(rec)
                elif pending:
                    src = pending.pop(0)
                    fid = f"{prefix}-{key}-{n}"
                    n += 1
                    out.append({
                        "name": prefix, "cat": "ocm.lifecycle", "ph": "s",
                        "id": fid, "ts": src[0] + 0.001,
                        "pid": src[1], "tid": src[2],
                    })
                    out.append({
                        "name": prefix, "cat": "ocm.lifecycle", "ph": "f",
                        "bp": "e", "id": fid, "ts": rec[0] + 0.001,
                        "pid": rec[1], "tid": rec[2],
                    })

    stitch(hedges, ("hedge_fired",), "hedge")
    stitch(cancels, ("cancel_sent",), "cancel")
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def cross_track_flows(trace: dict) -> int:
    """How many distinct flow ids the trace stitches across >1 pid —
    the smoke test's "did client and daemon actually connect" figure.
    Lifecycle pairs (hedge/cancel, usually same-process) are counted by
    :func:`lifecycle_flows` instead."""
    by_id: dict[str, set[int]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") in ("s", "t", "f") and e.get("cat") != "ocm.lifecycle":
            by_id.setdefault(str(e.get("id")), set()).add(int(e["pid"]))
    return sum(1 for pids in by_id.values() if len(pids) > 1)


def lifecycle_flows(trace: dict) -> int:
    """How many hedge/cancel lifecycle pairs the trace stitched (one
    arrow = one opener matched to its closer)."""
    ids = {
        str(e.get("id"))
        for e in trace.get("traceEvents", [])
        if e.get("cat") == "ocm.lifecycle"
    }
    return len(ids)


def write_chrome_trace(events: list[dict], path: str) -> dict:
    """Merge-ordered events -> Chrome trace JSON at ``path``; returns a
    small summary ({events, spans, tracks, flows})."""
    trace = chrome_trace(events)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(trace, fh, separators=(",", ":"))
    tev = trace["traceEvents"]
    return {
        "events": len(events),
        "spans": sum(1 for e in tev if e.get("ph") == "X"),
        "tracks": sum(
            1 for e in tev
            if e.get("ph") == "M" and e.get("name") == "process_name"
        ),
        "flows": cross_track_flows(trace),
        "lifecycle_flows": lifecycle_flows(trace),
    }
