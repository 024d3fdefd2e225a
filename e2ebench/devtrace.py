"""The device trace of a traced run: ``torch.profiler`` over a steady
stretch of the window, read from the profiler's raw events.

- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  fill ran on the device.
- ``window_s``: the host clock from the profiler's start to its stop, each
  after a synchronise. The stop processes the stretch's events inside the
  measured window; ``Stretch.overhead_s`` is that time, which the window's
  own rates leave out.
- ``kernels``: {name: (count, seconds)} of the device operations.
- ``idle``: {what the host was doing: seconds} of the gaps between device
  intervals, named by the innermost range of the benchmark's own
  (``e2e.*``) and the innermost host operation open at the gap's middle.
"""

from __future__ import annotations

import bisect
import heapq
import time

import torch


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


class Stretch:
    """Profiles from ``start_s`` into the window for ``seconds``; called by
    the adapter between its calls into the system with the window's
    elapsed seconds."""

    def __init__(self, device, start_s: float, seconds: float):
        self.device, self.start_s, self.seconds = device, start_s, seconds
        self.prof = None
        self.t0 = self.t1 = None
        self.overhead_s = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, elapsed: float) -> None:
        if self.t1 is not None:
            return
        if self.prof is None:
            if elapsed < self.start_s:
                return
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self._sync()
            self.prof.__enter__()
            self.t0 = time.perf_counter()
            return
        if time.perf_counter() - self.t0 >= self.seconds:
            self.finish()

    def finish(self) -> None:
        if self.prof is None or self.t1 is not None:
            return
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.overhead_s = time.perf_counter() - self.t1

    def read(self) -> dict | None:
        """The stretch's summary, or None when it never ran."""
        if self.prof is None:
            return None
        self.finish()
        events = self.prof.profiler.kineto_results.events()
        dev, host = [], []
        for ev in events:
            user = getattr(ev, "is_user_annotation", None)
            if (user is not None and user()) or ev.name().startswith("e2e."):
                if ev.device_type() == torch.autograd.DeviceType.CUDA:
                    continue  # a range's image on the device timeline
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((start, end, ev.name()))
            else:
                host.append((start, end, ev.name()))
        return summarize(dev, host, self.t1 - self.t0)


def summarize(dev: list, host: list, window_s: float) -> dict:
    """Busy time, device operations and named idle gaps from (start ns,
    end ns, name) of the device and host events."""
    kernels: dict[str, list] = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    lo = min((s for s, _, _ in host), default=None)
    hi = max((e for _, e, _ in host), default=None)
    gaps = []
    if merged and lo is not None:
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
    return {"busy_s": busy, "window_s": window_s,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "idle": name_gaps(gaps, host)}


def name_gaps(gaps: list, host: list) -> dict:
    """{name: seconds}: each gap named by what was open on the host at its
    middle (a sweep over the host events in start order)."""
    out: dict[str, float] = {}
    if not gaps:
        return out
    host = sorted(host)
    starts = [s for s, _, _ in host]
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    active: list = []   # heap of (end, -start, name)
    i = 0
    for mid, length in mids:
        j = bisect.bisect_right(starts, mid)
        for s, e, name in host[i:j]:
            heapq.heappush(active, (e, -s, name))
        i = max(i, j)
        while active and active[0][0] <= mid:
            heapq.heappop(active)
        ours = [(-ns, n) for _, ns, n in active if n.startswith("e2e.")]
        rest = [(-ns, n) for _, ns, n in active if not n.startswith("e2e.")]
        label = " / ".join(
            max(group)[1] for group in (ours, rest) if group) or "none"
        out[label] = out.get(label, 0.0) + length * 1e-9
    return out


def top(d: dict, n: int = 10, width: int = 160) -> list:
    """The ``n`` largest entries of {name: seconds} as [[name, seconds]]."""
    items = sorted(d.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:width], v] for k, v in items]
