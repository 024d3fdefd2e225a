"""The port's op tracer and ``capture_trace`` (``oncilla_tpu_torch/utils/
debug.py``) on ``torch.profiler``.

- ``capture_trace(dir)`` on the CPU writes a Chrome trace into ``dir``
  that holds an ``ocm:<op>`` range for each span opened inside it, on the
  calling thread and on others.
- Outside a capture a span enters no ``record_function`` at all (the
  span sits on every put and get).
- The JAX package's own tests of the tracer's concurrency
  (``tests/test_tracer.py``): imported and collected here as cases, with
  the port's ``Tracer``, and the port's trace context where the source
  imports the JAX one inside the test. Nothing in ``oncilla_tpu/`` or the
  JAX tests changes.
"""

import glob
import json
import os
import threading

import pytest
import torch.profiler

import oncilla_tpu.obs as jobs_pkg
import test_tracer as src
from oncilla_tpu_torch.obs import trace as ttrace
from oncilla_tpu_torch.utils import debug
from test_torch_daemon import export_ref

RUN = [
    "test_tracer_concurrent_span_snapshot_note_transfer",
    "test_tracer_spans_nest_trace_ids_across_threads",
]

export_ref(globals(), src, RUN)


@pytest.fixture(autouse=True)
def _port_tracer(request, monkeypatch):
    if request.function.__module__ != src.__name__:
        return
    monkeypatch.setattr(src, "Tracer", debug.Tracer)
    monkeypatch.setattr(src, "debug", debug)
    monkeypatch.setattr(jobs_pkg, "trace", ttrace)


def _ocm_ranges(log_dir) -> list[str]:
    (path,) = glob.glob(os.path.join(str(log_dir), "*.trace.json"))
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    return [e["name"] for e in events
            if str(e.get("name", "")).startswith("ocm:")]


def test_capture_trace_writes_ocm_ranges(tmp_path):
    tr = debug.Tracer(track="capture")
    log_dir = tmp_path / "trace"
    with debug.capture_trace(str(log_dir)):
        with tr.span("traced_op", nbytes=8):
            torch.ones(4).sum()
        th = threading.Thread(target=lambda: tr.span("thread_op").__enter__()
                              .__exit__(None, None, None))
        th.start()
        th.join()
    names = _ocm_ranges(log_dir)
    assert "ocm:traced_op" in names
    assert "ocm:thread_op" in names
    assert tr.stats("traced_op").count == 1  # the span still counts
    # A second capture into the same directory writes a second file.
    with debug.capture_trace(str(log_dir)):
        pass
    assert len(glob.glob(str(log_dir / "*.trace.json"))) == 2


def test_no_record_function_outside_a_capture(tmp_path, monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    tr = debug.Tracer()
    for _ in range(50):
        with tr.span("put", nbytes=4096):
            pass
    assert entered == [] and debug._ANNOTATION_CLS is None
    with debug.capture_trace(str(tmp_path)):
        with tr.span("get"):
            pass
    assert entered == ["ocm:get"]
    with tr.span("put"):
        pass
    assert entered == ["ocm:get"] and debug._ANNOTATION_CLS is None


def test_capture_ends_cleanly_when_the_block_raises(tmp_path):
    tr = debug.Tracer()
    with pytest.raises(RuntimeError):
        with debug.capture_trace(str(tmp_path)):
            with tr.span("failing"):
                raise RuntimeError("boom")
    assert debug._ANNOTATION_CLS is None
    assert "ocm:failing" in _ocm_ranges(tmp_path)
