"""The port's async-safety lint (``oncilla_tpu_torch.analysis.asyncsafety``),
the JAX package's tests/test_asyncsafety.py on the port: every seeded
fixture (the JAX fixtures, read in place) fires exactly its rule,
documented non-findings stay silent, the port's tree and its tests are
clean, and the port mux's cancel-collect tasks are strongly
referenced."""

import asyncio
from pathlib import Path

import pytest

from oncilla_tpu_torch.analysis.asyncsafety import lint_async_source, scan_async
from oncilla_tpu_torch.runtime import mux as mux_rt
from oncilla_tpu_torch.runtime import protocol as P

FIXTURES = Path(__file__).parent / "fixtures" / "analysis"


def _rules(findings):
    return [f.rule for f in findings]


# -- seeded fixtures -----------------------------------------------------


def test_blocking_fixture_fires():
    fs = scan_async([str(FIXTURES / "seeded_async_blocking.py")])
    assert _rules(fs) == ["async-blocking-call"] * 6, fs
    assert {f.symbol for f in fs} == {
        "sleep_on_loop", "dial_on_loop", "wire_roundtrip_on_loop",
        "sync_pool_on_loop", "file_on_loop",
    }


def test_lock_fixture_fires():
    fs = scan_async([str(FIXTURES / "seeded_async_lock.py")])
    assert _rules(fs) == ["async-lock-held-across-await"] * 2, fs
    assert {f.symbol for f in fs} == {
        "asyncio_lock_across_await", "thread_lock_across_await",
    }
    # The sync-with variant names the deadlock hazard.
    msgs = {f.symbol: f.message for f in fs}
    assert "deadlock" in msgs["thread_lock_across_await"]


def test_tls_fixture_fires():
    fs = scan_async([str(FIXTURES / "seeded_async_tls.py")])
    assert _rules(fs) == ["async-tls-install-across-await"] * 2, fs
    assert {f.symbol for f in fs} == {
        "install_in_coroutine", "installed_cm_across_await",
    }


def test_task_fixture_fires():
    fs = scan_async([str(FIXTURES / "seeded_async_task.py")])
    assert _rules(fs) == ["async-untracked-task"] * 3, fs
    assert {f.symbol for f in fs} == {
        "fire_and_forget", "ensure_and_forget", "sync_spawn",
    }


def test_suppression_is_per_rule():
    src = (
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)  # ocm-lint: allow[async-untracked-task]\n"
    )
    # Wrong rule name in the comment: the finding still fires.
    assert _rules(lint_async_source(src, "x.py")) == ["async-blocking-call"]


def test_nested_sync_def_not_reported_as_coroutine():
    src = (
        "import time\n"
        "async def outer():\n"
        "    def helper():\n"
        "        time.sleep(1)\n"  # sync helper: lint's jurisdiction
        "    return helper\n"
    )
    assert lint_async_source(src, "x.py") == []


def test_syntax_error_defers_to_lint():
    assert lint_async_source("def broken(:\n", "bad.py") == []


# -- the live tree -------------------------------------------------------


def test_async_clean_on_tree():
    from oncilla_tpu_torch.analysis.__main__ import default_paths

    fs = scan_async(default_paths())
    assert fs == [], [f.render() for f in fs]


# -- regression: the cancel-collect task is strongly referenced ----------


def test_mux_cancel_tasks_strongly_referenced(monkeypatch):
    """The async-untracked-task finding this family shipped with: the
    fire-and-collect CANCEL task in MuxChannel was a bare create_task —
    GC could drop the revocation mid-flight. It must now be held in
    ch._cancel_tasks until done, then discarded."""
    monkeypatch.setattr(mux_rt, "ORPHAN_CAP", 16)
    from oncilla_tpu_torch.utils.config import OcmConfig

    cfg = OcmConfig()

    class MuteTransport:
        def writelines(self, parts):
            pass

        def close(self):
            pass

    async def drive():
        loop = asyncio.get_running_loop()
        ch = mux_rt.MuxChannel(loop, ("mute", 1), cfg)
        ch.caps = P.FLAG_CAP_MUX
        ch._transport = MuteTransport()
        for _ in range(3):
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(
                    ch.request(P.Message(P.MsgType.STATUS, {})),
                    timeout=0.001,
                )
        await asyncio.sleep(0)  # let the collect() tasks start
        assert ch._cancel_tasks, "cancel-collect tasks not tracked"
        assert all(isinstance(t, asyncio.Task) for t in ch._cancel_tasks)
        # The done callback drains the set — no leak after completion.
        pending = list(ch._cancel_tasks)
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
        assert not ch._cancel_tasks
        ch.close()

    asyncio.run(drive())
