"""bench.py's copy loops in the port, and its copy-leg harness, on the CPU.

- (e) The plain versions of the copy loops K9 (``copy_loop``) and K10
  (``remote_loop``): at one stream against bench.py's ``_xla_copy_loop`` on
  the same bytes; at 2 and 4 streams against a closed-form model of
  bench.py's schedule. bench.py's Pallas loops have no interpret mode, so
  the kernels themselves are held against these plain loops on the card by
  ``chip_smoke.py``.
- (f) ``benchmarks/copy_bench.run`` and ``chip_smoke.phase_fabric``
  rehearsed on the CPU at tiny sizes with timing off; a loop whose segment
  check fails zeroes its numbers and the line ends ``"ok": false``.
- (g) Without CUDA, ``copy_bench.main()`` raises and ``chip_smoke.main()``
  exits nonzero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
import oncilla_tpu_torch as tocm
from oncilla_tpu_torch.benchmarks import copy_bench
from oncilla_tpu_torch.ops import copy_loops, dma

BLOCK = dma.BLOCK


def _model(buf: np.ndarray, nbytes: int, iters: int, streams: int) -> np.ndarray:
    """bench.py's ping-pong after any iters >= 1: stream s's pair
    [s*2q, s*2q+q) <-> [s*2q+q, s*2q+2q) both hold the pair's first half
    (bench.py:514-519), and the bytes past 2*nbytes are untouched."""
    out = buf.copy()
    q = nbytes // streams
    for s in range(streams):
        lo = s * 2 * q
        out[lo + q:lo + 2 * q] = buf[lo:lo + q]
    return out


@pytest.mark.parametrize("iters", [1, 2, 3, 6])
def test_one_stream_plain_loop_matches_xla_copy_loop(rng, iters):
    nbytes, total = 8 * BLOCK, 20 * BLOCK
    buf = rng.integers(0, 256, total, dtype=np.uint8)
    want = np.asarray(bench._xla_copy_loop(jax.device_put(jnp.asarray(buf)),
                                           nbytes, iters))
    got = copy_loops.copy_loop_plain(torch.from_numpy(buf.copy()), nbytes,
                                     iters, streams=1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _model(buf, nbytes, iters, 1))


@pytest.mark.parametrize("iters", [1, 3, 4])
@pytest.mark.parametrize("streams", [2, 4])
def test_copy_loop_matches_the_schedule(rng, streams, iters):
    nbytes, total = 16 * BLOCK, 40 * BLOCK
    buf = rng.integers(0, 256, total, dtype=np.uint8)
    dma.reset_launches()
    got = copy_loops.copy_loop(torch.from_numpy(buf.copy()), nbytes, iters, streams)
    np.testing.assert_array_equal(got.numpy(), _model(buf, nbytes, iters, streams))
    assert dma.launches()["copy_loop"] == 0  # a CPU buffer: the plain version


@pytest.mark.parametrize("iters", [1, 3, 4])
def test_remote_loop_matches_the_schedule(rng, iters):
    nbytes, total = 6 * BLOCK, 16 * BLOCK  # 3 blocks a stream, as K10 allows
    buf = rng.integers(0, 256, total, dtype=np.uint8)
    dma.reset_launches()
    got = copy_loops.remote_loop(torch.from_numpy(buf.copy()), nbytes, iters)
    np.testing.assert_array_equal(got.numpy(), _model(buf, nbytes, iters, 2))
    assert dma.launches()["remote_loop"] == 0


def test_loop_contracts_match_bench():
    buf = torch.zeros(32 * BLOCK, dtype=torch.uint8)
    # nbytes must split into 2*streams whole blocks (bench.py:119-120) ...
    with pytest.raises(AssertionError, match="split across streams"):
        bench._pallas_copy_loop(32 * BLOCK, 6 * BLOCK, 4, streams=4)
    with pytest.raises(AssertionError, match="split across streams"):
        copy_loops.copy_loop(buf, 6 * BLOCK, 4, streams=4)
    # ... and the remote loop's into 2 (bench.py:182-183).
    with pytest.raises(AssertionError):
        bench._pallas_remote_loop(32 * BLOCK, 3 * BLOCK, 4)
    with pytest.raises(AssertionError, match="split across 2 streams"):
        copy_loops.remote_loop(buf, 3 * BLOCK, 4)
    with pytest.raises(AssertionError, match="exceed the buffer"):
        copy_loops.copy_loop(buf, 20 * BLOCK, 4, streams=2)


def test_copy_bench_sizes_are_bench_py_sizes():
    assert (copy_bench.ARENA, copy_bench.NBYTES, copy_bench.ITERS) == (
        bench.ARENA, bench.NBYTES, bench.ITERS)


TINY = {"arena_bytes": 1 << 20, "nbytes": 32 << 10, "iters": 4, "alloc_iters": 10}


def test_copy_bench_rehearsal_on_the_cpu():
    out = copy_bench.run("cpu", timing=False, **TINY)
    d = out["detail"]
    assert out["ok"] is True and list(out)[-1] == "ok"
    assert out["value"] is None and out["vs_hbm"] is None  # no CPU rate
    for key in ("copy_loop_gbps_s2", "copy_loop_gbps_s4", "remote_loop_gbps",
                "plain_loop_gbps"):
        assert d[key] is None
    assert d["onesided_verified"] and d["dma_rows_verified"]
    assert "errors" not in d


def test_copy_bench_failed_check_zeroes_the_loop(monkeypatch):
    real = copy_loops.copy_loop

    def corrupt(buf, nbytes, iters, streams=2):
        real(buf, nbytes, iters, streams)
        buf.view(-1)[nbytes // streams] ^= 1  # a byte of stream 0's odd segment
        return buf

    monkeypatch.setattr(copy_loops, "copy_loop", corrupt)
    out = copy_bench.run("cpu", timing=False, **TINY)
    d = out["detail"]
    assert out["ok"] is False and list(out)[-1] == "ok"
    assert "mismatch at segment 1" in d["errors"]["copy_loop_s2_correctness"]
    assert d["copy_loop_gbps_s2"] == d["copy_loop_gbps_s4"] == 0.0
    assert d["remote_loop_gbps"] is None and "remote_loop_correctness" not in d["errors"]


def test_chip_smoke_fabric_phase_rehearsal_on_the_cpu():
    r = chip_smoke.phase_fabric(
        torch.device("cpu"), row_bytes=1 << 20,
        sizes=(BLOCK, 64 << 10, 256 << 10, 768 << 10), rate=3.35e12,
        handle_sizes=(BLOCK, 64 << 10), ring_bytes=64 << 10,
        bench_kw=TINY, timing=False, check_launches=False,
    )
    cases = {(x["case"], x["nbytes"]) for x in r["rows"]["onesided_copy"]}
    assert ("cross_row", 768 << 10) in cases and ("loopback", 256 << 10) in cases
    assert ("same_row", 768 << 10) not in cases  # does not fit twice in a row
    assert all(x["max_abs_err"] == 0.0 for rows in r["rows"].values() for x in rows)
    assert r["bench"]["ok"]


def test_without_cuda_the_benchmarks_refuse(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tocm.OcmDeviceError):
        copy_bench.main()
    with pytest.raises(tocm.OcmDeviceError):
        copy_bench.run(None, **TINY)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_arguments(monkeypatch, capsys):
    """No argument drives one card; ``--across-cards`` needs two or more;
    anything else is refused before a card is touched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert chip_smoke.main(["--cards"]) == 2
    assert chip_smoke.main(["--across-cards"]) == 1
    assert '"ok"' not in capsys.readouterr().out
