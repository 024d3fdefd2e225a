"""The port's copy kernels (oncilla_tpu_torch.ops.dma) held against the JAX
package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold that
version byte for byte against ``pallas_write_rows`` / ``pallas_read_rows`` /
``pallas_local_copy`` run in the Pallas interpret machine, on the same
seeded bytes (every ref <= 96 KiB: the interpret machine wedges at 128 KiB,
pallas_ici.py:22-32). The CUDA kernels themselves are held against the
plain versions on the card by ``chip_smoke.py``.
"""

import jax
import numpy as np
import pytest
import torch

from oncilla_tpu.ops import pallas_ici as pi
from oncilla_tpu_torch.ops import dma

BLOCK = dma.BLOCK
ARENA = 16 * BLOCK  # 64 KiB


def _bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8)


def test_block_matches_jax():
    assert dma.BLOCK == pi.BLOCK


@pytest.mark.parametrize("r0,nrows", [(0, 1), (5, 4), (8, 8)])
def test_write_rows_matches_pallas(rng, r0, nrows):
    buf, raw = _bytes(rng, ARENA), _bytes(rng, nrows * BLOCK)
    want = np.asarray(pi.pallas_write_rows(
        jax.device_put(buf.copy()), jax.device_put(raw), r0 * BLOCK))
    got = dma.write_rows(torch.from_numpy(buf.copy()), torch.from_numpy(raw),
                         r0 * BLOCK)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = dma.write_rows_plain(torch.from_numpy(buf.copy()),
                                 torch.from_numpy(raw), r0 * BLOCK)
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("r0,nrows", [(0, 1), (3, 5), (0, 16)])
def test_read_rows_matches_pallas(rng, r0, nrows):
    buf = _bytes(rng, ARENA)
    want = np.asarray(pi.pallas_read_rows(jax.device_put(buf), r0 * BLOCK,
                                          nrows * BLOCK))
    got = dma.read_rows(torch.from_numpy(buf), r0 * BLOCK, nrows * BLOCK)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (nrows * BLOCK,) and got.dtype == torch.uint8


@pytest.mark.parametrize("src,dst,nrows", [(0, 8, 4), (12, 2, 4), (15, 0, 1)])
def test_local_copy_matches_pallas(rng, src, dst, nrows):
    buf = _bytes(rng, ARENA)
    want = np.asarray(pi.pallas_local_copy(
        jax.device_put(buf.copy()), src * BLOCK, dst * BLOCK, nrows * BLOCK))
    got = dma.local_copy(torch.from_numpy(buf.copy()), src * BLOCK,
                         dst * BLOCK, nrows * BLOCK)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_calls_are_not_counted_as_launches(rng):
    dma.reset_launches()
    buf = torch.from_numpy(_bytes(rng, ARENA))
    dma.write_rows(buf, torch.from_numpy(_bytes(rng, BLOCK)), 0)
    dma.read_rows(buf, 0, BLOCK)
    dma.local_copy(buf, 0, BLOCK, BLOCK)
    assert dma.launches() == {"write_rows": 0, "read_rows": 0, "local_copy": 0,
                              "onesided_copy": 0, "read_stream": 0,
                              "copy_stream_loop": 0, "vmem_roundtrip": 0,
                              "copy_loop": 0, "remote_loop": 0}


def test_contract_asserts(rng):
    buf = torch.zeros(ARENA, dtype=torch.uint8)
    with pytest.raises(AssertionError):
        dma.write_rows(buf, torch.zeros(BLOCK, dtype=torch.uint8), 17)
    with pytest.raises(AssertionError):
        dma.read_rows(buf, 0, BLOCK - 1)
    with pytest.raises(AssertionError, match="past the arena"):
        dma.read_rows(buf, 15 * BLOCK, 2 * BLOCK)
    with pytest.raises(AssertionError, match="overlapping"):
        dma.local_copy(buf, 0, BLOCK, 2 * BLOCK)
    # Same contract as the Pallas kernel.
    with pytest.raises(AssertionError, match="overlapping"):
        pi.pallas_local_copy(jax.device_put(buf.numpy()), 0, BLOCK, 2 * BLOCK)
    with pytest.raises(ValueError):
        dma.write_rows(buf, torch.zeros(BLOCK, dtype=torch.int32), 0)


@pytest.mark.parametrize("a,b,n", [(0, 0, BLOCK), (BLOCK, 2 * BLOCK, BLOCK),
                                   (1, 0, BLOCK), (0, 0, BLOCK - 1),
                                   (0, 0, 0), (8 * BLOCK, 0, 3 * BLOCK)])
def test_pallas_supported_matches_jax(a, b, n):
    assert dma.pallas_supported(a, b, n) == pi.pallas_supported(a, b, n)


def test_no_plain_fallback_off_the_cpu():
    """A tensor that lies neither on the CPU nor on a CUDA card is refused,
    never served by the plain version."""
    buf = torch.empty(ARENA, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no copy kernel"):
        dma.read_rows(buf, 0, BLOCK)


def test_failed_build_raises(tmp_path, monkeypatch):
    """Without nvcc the build raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(dma, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        dma.build()


def test_build_targets_hopper():
    flags = " ".join(dma._NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    target = dma._target(dma._CSRC / "dma.cu")
    assert target.parent == dma._BUILD_DIR and target.suffix == ".so"
    assert dma._BUILD_DIR.parts[-2:] == ("build", "oncilla_tpu_torch")


def test_build_covers_every_source(monkeypatch):
    """One library per source under csrc/, each named by a hash that also
    covers the shared header, so editing copy.cuh rebuilds them all."""
    assert dma._SOURCES == ("ceiling.cu", "copy_loops.cu", "dma.cu", "fabric.cu")
    assert dma._HEADERS == ("copy.cuh",)
    targets = {dma._target(dma._CSRC / s) for s in dma._SOURCES}
    assert len(targets) == 4
    monkeypatch.setattr(dma, "_HEADERS", ())
    assert dma._target(dma._CSRC / "dma.cu") not in targets
