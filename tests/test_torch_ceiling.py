"""The ceiling probes' kernels in the port held against the JAX package's.

On the CPU each wrapper of ``oncilla_tpu_torch.ops.ceiling_loops`` runs its
plain PyTorch version; these tests hold it, byte for byte (tolerance 0),
against the Pallas kernels of ``oncilla_tpu/benchmarks/ceiling.py`` run in
the interpret machine, as tests/test_benchmarks.py runs them, on the same
seeded numpy bytes:

- K6 ``read_stream``: both leave the buffer untouched; the port's sum of
  the bytes equals numpy's.
- K7 ``copy_stream_loop`` against ``_copy_stream_loop`` at 1/2/4/8 streams.
- K8 ``vmem_roundtrip`` against ``_vmem_roundtrip_loop(256 KiB, 64 KiB,
  iters, 32 KiB)``, the untouched tail included.
- The same bad shapes raise in both; ``ceiling_probe`` keeps the JAX keys
  and its -1 for legs past the deadline.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` (phase 7).
"""

import inspect
import time

import jax
import numpy as np
import pytest
import torch

import oncilla_tpu_torch as tocm
from oncilla_tpu.benchmarks import ceiling as jceiling
from oncilla_tpu_torch.benchmarks import ceiling
from oncilla_tpu_torch.ops import ceiling_loops as cl
from oncilla_tpu_torch.ops import dma

KiB = 1 << 10
TINY = {
    "read_kw": {"total_bytes": 256 * KiB, "chunk_bytes": 64 * KiB, "iters": 2},
    "copy_kw": {"total_bytes": 256 * KiB, "nbytes": 64 * KiB, "iters": 3},
    "roundtrip_kw": {"total_bytes": 256 * KiB, "nbytes": 64 * KiB, "iters": 3,
                     "chunk_bytes": 32 * KiB},
}


def _bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8)


def _jax_run(loop, buf: np.ndarray) -> np.ndarray:
    return np.asarray(loop(jax.device_put(buf.copy()))).reshape(-1)


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("chunk", [32 * KiB, 64 * KiB])
def test_read_stream_matches_pallas(rng, chunk, iters):
    total = 256 * KiB
    buf = _bytes(rng, total)
    want = _jax_run(jceiling._read_stream_loop(total, chunk, iters), buf)
    np.testing.assert_array_equal(want, buf)  # the TPU kernel writes nothing
    t = torch.from_numpy(buf.copy())
    dma.reset_launches()
    got = cl.read_stream(t, chunk, iters)
    assert got.dtype == torch.int64 and got.shape == ()
    assert int(got) == int(buf.sum(dtype=np.int64))
    np.testing.assert_array_equal(t.numpy(), want)
    assert dma.launches()["read_stream"] == 0  # a CPU buffer: the plain version


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("streams", [1, 2, 4, 8])
def test_copy_stream_loop_matches_pallas(rng, streams, iters):
    total, nbytes = 160 * KiB, 64 * KiB  # 32 KiB past the segment pairs
    buf = _bytes(rng, total)
    want = _jax_run(jceiling._copy_stream_loop(total, nbytes, iters, streams), buf)
    dma.reset_launches()
    got = cl.copy_stream_loop(torch.from_numpy(buf.copy()), nbytes, iters, streams)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[2 * nbytes:], buf[2 * nbytes:])
    assert dma.launches()["copy_stream_loop"] == 0


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_vmem_roundtrip_matches_pallas(rng, iters):
    total, nbytes, chunk = 256 * KiB, 64 * KiB, 32 * KiB
    buf = _bytes(rng, total)
    want = _jax_run(jceiling._vmem_roundtrip_loop(total, nbytes, iters, chunk), buf)
    got = cl.vmem_roundtrip(torch.from_numpy(buf.copy()), nbytes, iters, chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[2 * nbytes:], buf[2 * nbytes:])  # the tail
    # After any count the pair holds the first half's bytes twice.
    np.testing.assert_array_equal(want[:nbytes], buf[:nbytes])
    np.testing.assert_array_equal(want[nbytes:2 * nbytes], buf[:nbytes])


# (name, JAX constructor, port call on a zeroed buffer of `total` bytes)
BAD_SHAPES = {
    "read_chunk_not_dividing": (
        lambda: jceiling._read_stream_loop(256 * KiB, 48 * KiB, 2),
        lambda b: cl.read_stream(b, 48 * KiB, 2), 256 * KiB),
    "read_chunk_not_block": (
        lambda: jceiling._read_stream_loop(256 * KiB, 2 * KiB, 2),
        lambda b: cl.read_stream(b, 2 * KiB, 2), 256 * KiB),
    "copy_streams_not_splitting": (
        lambda: jceiling._copy_stream_loop(256 * KiB, 24 * KiB, 2, 2),
        lambda b: cl.copy_stream_loop(b, 24 * KiB, 2, 2), 256 * KiB),
    "copy_pairs_past_buffer": (
        lambda: jceiling._copy_stream_loop(96 * KiB, 64 * KiB, 2, 2),
        lambda b: cl.copy_stream_loop(b, 64 * KiB, 2, 2), 96 * KiB),
    "roundtrip_chunks_not_splitting": (
        lambda: jceiling._vmem_roundtrip_loop(256 * KiB, 48 * KiB, 2, 32 * KiB),
        lambda b: cl.vmem_roundtrip(b, 48 * KiB, 2, 32 * KiB), 256 * KiB),
    "roundtrip_past_buffer": (
        lambda: jceiling._vmem_roundtrip_loop(96 * KiB, 64 * KiB, 2, 32 * KiB),
        lambda b: cl.vmem_roundtrip(b, 64 * KiB, 2, 32 * KiB), 96 * KiB),
}


@pytest.mark.parametrize("case", list(BAD_SHAPES))
def test_bad_shapes_raise_in_both(case):
    make_jax, port, total = BAD_SHAPES[case]
    with pytest.raises(AssertionError):
        make_jax()
    with pytest.raises(AssertionError):
        port(torch.zeros(total, dtype=torch.uint8))


def _stub_jax_probes(monkeypatch):
    monkeypatch.setattr(jceiling, "hbm_read_gbps", lambda: 1.0)
    monkeypatch.setattr(jceiling, "copy_gbps", lambda s: 2.0)
    monkeypatch.setattr(jceiling, "vmem_roundtrip_gbps", lambda: 3.0)


def _shape(d):
    return {k: _shape(v) if isinstance(v, dict) else type(v).__name__
            for k, v in d.items()}


def test_ceiling_probe_keeps_the_jax_keys(monkeypatch):
    _stub_jax_probes(monkeypatch)
    want = jceiling.ceiling_probe()
    got = ceiling.ceiling_probe(device="cpu", timing=False, **TINY)
    assert list(got) == list(want)
    assert list(got["copy_streams_gbps"]) == list(want["copy_streams_gbps"])
    # No timing on the CPU: every leg ran and reports no rate.
    assert got == {"read_only_gbps": None,
                   "copy_streams_gbps": dict.fromkeys(("1", "2", "4", "8")),
                   "vmem_roundtrip_gbps": None}


def test_ceiling_probe_past_the_deadline_marks_minus_one(monkeypatch):
    _stub_jax_probes(monkeypatch)
    want = jceiling.ceiling_probe(deadline=time.monotonic())
    got = ceiling.ceiling_probe(deadline=time.monotonic(), device="cpu",
                                timing=False, **TINY)
    assert want["copy_streams_gbps"] == got["copy_streams_gbps"] == dict.fromkeys(
        ("1", "2", "4", "8"), -1.0)
    assert want["vmem_roundtrip_gbps"] == got["vmem_roundtrip_gbps"] == -1.0
    # The read-only leg runs whatever the deadline, as in the JAX probe.
    assert want["read_only_gbps"] == 1.0 and got["read_only_gbps"] is None


@pytest.mark.parametrize("name", ["hbm_read_gbps", "copy_gbps", "vmem_roundtrip_gbps"])
def test_probe_defaults_are_the_jax_defaults(name):
    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty
                and k not in ("device", "timing")}

    assert defaults(getattr(ceiling, name)) == defaults(getattr(jceiling, name))


def test_without_cuda_the_probes_refuse(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tocm.OcmDeviceError):
        ceiling.main()
    with pytest.raises(tocm.OcmDeviceError):
        ceiling.hbm_read_gbps(**TINY["read_kw"])
    assert capsys.readouterr().out == ""
