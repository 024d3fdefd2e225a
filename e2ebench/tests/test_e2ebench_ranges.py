"""The range reader (``ranges.py``): synthetic event lists (nesting,
inclusive totals, launches a range, device work launched under no range or
with no launch in the trace), the conservation of device time, the real
profiler's events from a tiny decode on the CPU, and an older torch's event
API."""

import pytest
import torch

from e2ebench import devtrace, ranges
from e2ebench.ranges import Event
from e2ebench.tests.tiny import DECODE, run_tiny

CELL = "mixtral8x7b.decode_long"
T1, SYS1, T2, SYS2 = 1, 1001, 2, 2002   # the ops' thread ids and the calls'


def host(name, start, dur, corr, thread=T1):
    return Event(name, start, dur, thread, corr, 0, False, False)


def call(name, start, corr, linked, thread=SYS1):
    return Event(name, start, 1, thread, corr, linked, False, True)


def dev(name, dur, corr, linked=0):
    return Event(name, 10_000, dur, 7, corr, linked, True, False)


EVENTS = [
    # a token step: attention, then the MoE FFN, then a launch in neither
    host("ocm:decode_token_step", 0, 100, 90),
    host("ocm:attention", 10, 30, 91),
    host("aten::cat", 12, 8, 1),
    call("cudaLaunchKernel", 13, 501, 1),
    dev("cat_kernel", 30, 501, 1),
    dev("fill_kernel", 3, 0, 1),              # no call in the trace: its op
    host("ocm:moe_ffn", 50, 40, 92),
    host("aten::einsum", 55, 5, 2),
    call("cudaLaunchKernel", 56, 502, 2),
    dev("gemm", 20, 502, 2),
    call("cudaMemsetAsync", 57, 503, 2),
    dev("Memset (Device)", 5, 503, 2),
    call("cudaStreamSynchronize", 60, 510, 2),  # a call, not a launch
    call("cudaLaunchKernel", 95, 504, 0),     # outside any aten op
    dev("ext_kernel", 7, 504),
    # launched under no range, and a device op whose launch is not traced
    host("aten::add", 150, 10, 3),
    call("cudaLaunchKernel", 151, 505, 3),
    dev("add_kernel", 11, 505, 3),
    dev("lost_kernel", 13, 999, 777),
    # a second step: one op, and a graph replay of two kernels
    host("ocm:decode_token_step", 200, 100, 93),
    host("aten::mm", 210, 10, 4),
    call("cudaLaunchKernel", 211, 506, 4),
    dev("mm_kernel", 17, 506, 4),
    call("cudaGraphLaunch", 250, 507, 0),
    dev("graph_kernel_a", 2, 507),
    dev("graph_kernel_b", 2, 507),
    # a page fetch with its get nested inside
    host("ocm:kv_fetch_pages", 400, 100, 94),
    host("ocm:get", 410, 40, 95),
    call("cudaMemcpyAsync", 420, 508, 0),
    dev("Memcpy DtoD (Device -> Device)", 9, 508),
    # another thread: its range holds none of the first thread's launches
    host("ocm:put", 0, 1000, 96, thread=T2),
    host("aten::copy_", 600, 10, 5, thread=T2),
    call("cudaLaunchKernel", 601, 509, 5, thread=SYS2),
    dev("copy_kernel", 4, 509, 5),
]

S = 1e-9


def test_ranges_nest_and_count_inclusively():
    got = ranges.attribute(EVENTS)
    want = {
        "ocm:decode_token_step": (2, 200, 30 + 3 + 20 + 5 + 7 + 17 + 4, 6),
        "ocm:attention": (1, 30, 33, 1),
        "ocm:moe_ffn": (1, 40, 25, 2),
        "ocm:kv_fetch_pages": (1, 100, 9, 1),
        "ocm:get": (1, 40, 9, 1),
        "ocm:put": (1, 1000, 4, 1),
    }
    assert set(got) == set(want) | {"unattributed_device_s"}
    for name, (count, host_ns, dev_ns, launches) in want.items():
        r = got[name]
        assert r["count"] == count, name
        assert r["host_s"] == pytest.approx(host_ns * S), name
        assert r["device_s"] == pytest.approx(dev_ns * S), name
        assert r["launches"] == launches, name
    assert got["unattributed_device_s"] == pytest.approx((11 + 13) * S)


def test_device_time_is_conserved():
    got = ranges.attribute(EVENTS)
    top = ("ocm:decode_token_step", "ocm:kv_fetch_pages", "ocm:put")
    total = sum(e.dur for e in EVENTS if e.device) * S
    assert (sum(got[n]["device_s"] for n in top) + got["unattributed_device_s"]
            == pytest.approx(total))


def test_order_of_the_events_does_not_matter():
    a, b = ranges.attribute(EVENTS[::-1]), ranges.attribute(EVENTS)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k]), k


def test_no_range_no_attribution():
    plain = [e for e in EVENTS if not e.name.startswith("ocm:")]
    got = ranges.attribute(plain)
    assert set(got) == {"unattributed_device_s"}
    assert got["unattributed_device_s"] == pytest.approx(
        sum(e.dur for e in plain if e.device) * S)


@pytest.fixture(scope="module")
def traced():
    """The raw events of the profiled stretch of a traced rehearsal of the
    decode cell on the CPU, as :class:`Event`."""
    mp = pytest.MonkeyPatch()
    seen = {}
    read = devtrace.Stretch.read

    def read_and_keep(self):
        out = read(self)
        if out is not None:
            seen["events"] = ranges.from_kineto(
                self.prof.profiler.kineto_results.events())
        return out

    mp.setattr(devtrace.Stretch, "read", read_and_keep)
    try:
        out = run_tiny(CELL, trace=True, seconds=1.0)
    finally:
        mp.undo()
    assert out["correct"] is True
    return seen["events"]


def test_the_real_profiler_events_read_as_ranges(traced):
    """The installed torch's kineto fields, through a tiny decode: every
    span of the stretch is a range, nested as the decoder nests them."""
    got = ranges.attribute(traced)
    steps = got["ocm:decode_token_step"]["count"]
    assert steps > 0
    layers = 2  # tiny.TINY
    assert got["ocm:attention"]["count"] == layers * steps
    assert got["ocm:moe_ffn"]["count"] == layers * steps
    pages = got["ocm:kv_fetch_pages"]["count"]
    assert got["ocm:kv_store_page"]["count"] == pages
    assert abs(steps - pages * DECODE["page_tokens"]) <= DECODE["page_tokens"]
    assert got["ocm:attention"]["host_s"] < got["ocm:decode_token_step"]["host_s"]
    assert all(v["device_s"] == 0 and v["launches"] == 0
               for k, v in got.items() if k.startswith("ocm:"))
    assert got["unattributed_device_s"] == 0
    assert not any(e.runtime or e.device for e in traced)


def test_real_host_events_take_their_device_work(traced):
    """Device work linked to the real aten ops of the tiny decode lands in
    the ranges around those ops, and conserves its time."""
    evs = traced
    by_name = {}
    for e in evs:
        if e.name.startswith("ocm:"):
            by_name.setdefault(e.name, []).append(e)
    att = by_name["ocm:attention"][0]
    inside = next(e for e in evs if not e.name.startswith("ocm:")
                  and e.thread == att.thread and e.corr
                  and att.start <= e.start and e.start + e.dur <= att.start + att.dur)
    fake = [dev("k", 1000, 0, inside.corr), dev("lost", 500, 0, 10**9)]
    got = ranges.attribute(evs + fake)
    assert got["ocm:attention"]["device_s"] == pytest.approx(1000 * S)
    assert got["ocm:decode_token_step"]["device_s"] == pytest.approx(1000 * S)
    assert got["ocm:moe_ffn"]["device_s"] == 0
    assert got["unattributed_device_s"] == pytest.approx(500 * S)


def test_a_real_profile_has_the_fields_the_reader_takes():
    with torch.profiler.profile() as prof:
        with torch.profiler.record_function("ocm:x"):
            torch.ones(3).sum()
    evs = ranges.from_kineto(prof.profiler.kineto_results.events())
    assert evs[0].name == "ocm:x" and evs[0].dur > 0 and evs[0].corr > 0
    assert ranges.attribute(evs)["ocm:x"]["count"] == 1


class OlderEvent:
    """A kineto event as an older torch gives it: no ``activity_type``, no
    ``is_user_annotation``, times in microseconds only."""

    def __init__(self, name, start_us, dur_us, thread, corr, linked, device):
        self._v = (name, start_us, dur_us, thread, corr, linked, device)

    def name(self):
        return self._v[0]

    def start_us(self):
        return self._v[1]

    def duration_us(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[6] else DeviceType.CPU


def test_an_older_torch_reads_alike():
    evs = [OlderEvent("ocm:decode_token_step", 0, 100, T1, 90, 0, False),
           OlderEvent("aten::mm", 10, 10, T1, 1, 0, False),
           OlderEvent("cudaLaunchKernel", 11, 1, SYS1, 501, 1, False),
           OlderEvent("cuLaunchKernelEx", 50, 1, SYS1, 502, 0, False),
           OlderEvent("mm_kernel", 200, 30, 7, 501, 1, True),
           OlderEvent("triton_kernel", 300, 5, 7, 502, 0, True),
           OlderEvent("ocm:decode_token_step", 200, 30, 7, 0, 0, True)]
    read = ranges.from_kineto(evs)
    assert [e.runtime for e in read] == [False, False, True, True, False, False]
    assert read[0].start == 0 and read[0].dur == 100_000
    got = ranges.attribute(read)["ocm:decode_token_step"]
    assert got["launches"] == 2
    assert got["device_s"] == pytest.approx(35e-6)
