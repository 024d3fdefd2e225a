"""The program's own ranges on the device trace: each device operation of
a profiled stretch put down to the ``ocm:`` ranges (the program's
``Tracer`` spans) open on the host thread that launched it.

A device operation names its launch twice over: its correlation id is the
CUDA API call that launched it, and its linked correlation
id is the host operation (an aten op) open at that call. The launch point
is the API call where the trace has it, else the start of the linked
host operation; an API call's thread is the host operations' own thread
id, read from the host operations that its thread's calls link to. The
ranges enclosing the launch point on that thread own the device operation.

For each range name, totals inclusive of nested ranges:

- ``count``: the ranges of that name;
- ``host_s``: their summed durations;
- ``device_s``: the summed duration of the device operations launched
  inside one of them;
- ``launches``: the CUDA launch calls inside one of them (kernel and
  graph launches, async copies and fills).

``unattributed_device_s`` is the device time launched under no range (or
whose launch is not in the trace); with the device time of the outermost
ranges it sums to all of the device time.

Over a stretch profiled with CPU and CUDA activity::

    ranges.attribute(ranges.from_kineto(prof.profiler.kineto_results.events()))
"""

from __future__ import annotations

import re
from typing import NamedTuple

PREFIX = "ocm:"
RUNTIME = re.compile(r"^cu(da)?[A-Z]")     # the CUDA APIs' calls: cuda*, cu*
LAUNCH = re.compile(
    r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy\w*Async|Memset\w*Async)")


class Event(NamedTuple):
    name: str
    start: int          # ns
    dur: int            # ns
    thread: int
    corr: int           # correlation id
    linked: int         # linked correlation id, 0 when none
    device: bool        # on the device (a kernel, a copy, a fill)
    runtime: bool       # a CUDA API call on the host


def from_kineto(events) -> list[Event]:
    """The raw kineto events of a ``torch.profiler`` session
    (``prof.profiler.kineto_results.events()``) as :class:`Event`; the
    device's images of host ranges (user annotations) are left out. A host
    event is a CUDA API call by its name: not every torch gives an event's
    activity type."""
    from torch.autograd import DeviceType

    from e2ebench.devtrace import _ns

    out = []
    for ev in events:
        device = ev.device_type() == DeviceType.CUDA
        name = ev.name()
        user = getattr(ev, "is_user_annotation", None)
        if device and ((user is not None and user())
                       or name.startswith((PREFIX, "e2e."))):
            continue
        out.append(Event(name, _ns(ev, "start"), _ns(ev, "duration"),
                         ev.start_thread_id(), ev.correlation_id(),
                         ev.linked_correlation_id(), device,
                         not device and bool(RUNTIME.match(name))))
    return out


def attribute(events: list[Event]) -> dict:
    """{range name: {"count", "host_s", "device_s", "launches"}} and
    ``unattributed_device_s`` (module docstring)."""
    runtime = {e.corr: e for e in events if e.runtime and e.corr}
    ops = {e.corr: e for e in events
           if not e.device and not e.runtime and e.corr}
    thread_of = {}
    for e in runtime.values():
        op = ops.get(e.linked)
        if op is not None:
            thread_of.setdefault(e.thread, op.thread)

    def launch_point(e: Event):
        call = runtime.get(e.corr) if e.corr else None
        if call is not None:
            return thread_of.get(call.thread, call.thread), call.start
        op = ops.get(e.linked) if e.linked else None
        return None if op is None else (op.thread, op.start)

    out: dict = {}
    by_thread: dict = {}
    for e in events:
        if not e.device and not e.runtime and e.name.startswith(PREFIX):
            r = out.setdefault(e.name, {"count": 0, "host_s": 0.0,
                                        "device_s": 0.0, "launches": 0})
            r["count"] += 1
            r["host_s"] += e.dur * 1e-9
            by_thread.setdefault(e.thread, []).append(
                (e.start, 0, -e.dur, e.name))
            by_thread[e.thread].append((e.start + e.dur, 2, 0, e.name))
    unattributed = 0
    for e in events:
        if e.device or (e.runtime and LAUNCH.match(e.name)):
            point = launch_point(e) if e.device else (
                thread_of.get(e.thread, e.thread), e.start)
            if point is None or point[0] not in by_thread:
                unattributed += e.dur if e.device else 0
                continue
            by_thread[point[0]].append((point[1], 1, 0, e))
    for marks in by_thread.values():
        marks.sort(key=lambda m: m[:3])
        open_: list = []
        for _, kind, _, what in marks:
            if kind == 0:
                open_.append(what)
            elif kind == 2:
                del open_[len(open_) - 1 - open_[::-1].index(what)]
            elif not open_:
                unattributed += what.dur if what.device else 0
            else:
                for name in set(open_):
                    if what.device:
                        out[name]["device_s"] += what.dur * 1e-9
                    else:
                        out[name]["launches"] += 1
    out["unattributed_device_s"] = unattributed * 1e-9
    return out
