"""Times of the copy kernels the way their callers meet them.

A kernel's time at one KV page depends on where its bytes are. Decode
fetches a page 128 tokens after storing it, long after the page has left
the card's 50 MB L2, so a page is timed cold: the calls rotate over
:func:`rotation` disjoint extents on each side, 8 at one 16 MiB page
(source plus destination 256 MiB, above twice the L2), one at 1 GiB. Three
numbers come from the same calls:

- :func:`cold_ms`: CUDA events around back-to-back calls, host issue
  included where the host is slower than the card: the median of 20
  windows (:func:`cold_windows`, which also give the host's issue time a
  call), so one stall of the host inside a window, which a caller would
  meet, is left out;
- :func:`device_ms`: the device's own time a call, from ``torch.profiler``
  (or, where the profiler miscounts, from CUDA events with the host held
  out);
- :func:`host_us`: a wrapper's issue time a call on the host clock (at
  4 KiB, with no synchronise inside the loop).
"""

from __future__ import annotations

import statistics
import time

import torch

L2_BYTES = 50_000_000  # an H100's L2 (datasheet)
WINDOWS = 20  # windows of back-to-back calls a cold_ms reading takes


def rotation(nbytes: int) -> int:
    """Disjoint extents a side to rotate over, so that a call finds neither
    its source nor its destination in L2: one once the source alone is
    twice the L2, else 8."""
    return 1 if nbytes >= 2 * L2_BYTES else 8


def cold_windows(calls, rounds: int = 4) -> list[tuple]:
    """Per window of ``rounds`` passes over ``calls`` (zero-argument
    callables, one an extent), ``WINDOWS`` windows after one warm-up pass:
    (ms a call by CUDA events around the window, µs a call the host took to
    issue it). The windows follow each other with no synchronise between
    them."""
    for c in calls:
        c()
    n = rounds * len(calls)
    marks, issue = [], []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(rounds):
            for c in calls:
                c()
        end.record()
        issue.append((time.perf_counter() - t0) / n * 1e6)
        marks.append((start, end))
    torch.cuda.synchronize()
    return [(s.elapsed_time(e) / n, us) for (s, e), us in zip(marks, issue)]


def cold_ms(calls, rounds: int = 4) -> float:
    """Time a call (ms): the median over the windows of
    :func:`cold_windows`. One window at a page lasts about half a
    millisecond, so one stall of the host inside it shows as microseconds
    a call; the median keeps such a window out."""
    return statistics.median(ms for ms, _ in cold_windows(calls, rounds))


def device_ms(calls, names: tuple, rounds: int = 4, tries: int = 3) -> tuple:
    """Mean device time (ms) of one kernel run over ``rounds`` passes of
    ``calls``, each call launching one kernel whose name holds a string of
    ``names``, and how it was measured.

    From ``torch.profiler``: the self device time of those events over
    their count. On an H100 a session sometimes misses a record of its own
    or reports one of an earlier session (most often after a long session,
    such as a profiled decode window), so each session is preceded by an
    empty one that takes what an earlier one left behind, ends with a small
    kernel and a pause so that the last timed kernel's record is not the
    session's last, and counts only if it saw one record a call; it is run
    up to ``tries`` times. If none counts right: CUDA events around the
    same calls queued behind a spin that holds the stream until all are
    queued, so no host time enters (the inter-kernel gaps of back-to-back
    launches do). Returns (ms, "profiler" or "held events")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    n = rounds * len(calls)
    for c in calls:
        c()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=acts):
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(rounds):
                for c in calls:
                    c()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.01)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and any(k in e.key for k in names)]
        if sum(e.count for e in events) == n:
            return sum(e.self_device_time_total for e in events) * 1e-3 / n, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clock: time to queue
    start.record()
    for _ in range(rounds):
        for c in calls:
            c()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, "held events"


# The device events of the bulk copy (K1-K3, K4 within a row), of K4's
# send and of ``Tensor.copy_`` (a memcpy).
BULK, SEND_BULK, MEMCPY = ("bulk_copy_kernel",), ("send_bulk_kernel",), ("Memcpy",)


def host_us(fn, iters: int = 500) -> float:
    """Mean host time of one call of ``fn`` (µs), over ``iters`` calls with
    no synchronise inside the loop (one before it and one after). Few
    enough calls that the card's launch queue does not fill: a full queue
    would hold the host to the card's pace."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6

