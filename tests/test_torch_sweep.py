"""The port's size sweep and its k-fold get held against the JAX package's.

- ``ops.dma.read_rows_loop`` (K2 launched k times into one output) against
  ``pallas_read_rows_loop`` in the interpret machine, byte for byte.
- ``benchmarks.sweep.size_sweep`` visits, drops and orders sizes as the JAX
  ``size_sweep`` does on the same arguments: both modules' clocks are
  replaced by one tick-per-call counter, so the budget runs out at the same
  call in both.
- ``spmd_ring_sweep`` on a CPU mesh of 4 rows.

On the CPU every rate is None (no device rate from a CPU run); the legs
and the budget run all the same.
"""

import types

import jax
import numpy as np
import pytest
import torch

import oncilla_tpu as jocm
import oncilla_tpu_torch as tocm
from oncilla_tpu.benchmarks import sweep as jsweep
from oncilla_tpu.ops import pallas_ici as pi
from oncilla_tpu_torch.benchmarks import sweep
from oncilla_tpu_torch.ops import dma

BLOCK = dma.BLOCK
KiB = 1 << 10


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("r0,nrows", [(0, 4), (3, 5), (0, 16)])
def test_read_rows_loop_matches_pallas(rng, r0, nrows, k):
    buf = rng.integers(0, 256, 16 * BLOCK, dtype=np.uint8)
    want = np.asarray(pi.pallas_read_rows_loop(jax.device_put(buf), r0 * BLOCK,
                                               nrows * BLOCK, k))
    dma.reset_launches()
    got = dma.read_rows_loop(torch.from_numpy(buf), r0 * BLOCK, nrows * BLOCK, k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (nrows * BLOCK,) and got.dtype == torch.uint8
    assert dma.launches()["read_rows"] == 0  # a CPU buffer: the plain version


def test_read_rows_into_out(rng):
    buf = torch.from_numpy(rng.integers(0, 256, 16 * BLOCK, dtype=np.uint8))
    out = torch.empty(2 * BLOCK, dtype=torch.uint8)
    assert dma.read_rows(buf, 4 * BLOCK, 2 * BLOCK, out=out) is out
    assert torch.equal(out, buf[4 * BLOCK:6 * BLOCK])
    with pytest.raises(ValueError, match="out must be"):
        dma.read_rows(buf, 0, BLOCK, out=out)


def _ticks(monkeypatch):
    """One tick-per-call clock for both sweep modules."""
    tick = [0.0]

    def perf_counter():
        tick[0] += 1.0
        return tick[0]

    clock = types.SimpleNamespace(perf_counter=perf_counter)
    for mod in (jsweep, sweep):
        monkeypatch.setattr(mod, "time", clock)
    return tick


SWEEPS = {
    "budget_zero": {"budget_s": 0.0},
    "descending_budget": {"budget_s": 4.5, "descending": True},
    "ascending_budget": {"budget_s": 8.5},
    "write_cap_descending": {"write_max_bytes": 32 * KiB, "descending": True},
    "write_cap_budget": {"write_max_bytes": 16 * KiB, "budget_s": 10.5},
}


@pytest.mark.parametrize("kind", ["LOCAL_DEVICE", "LOCAL_HOST"])
@pytest.mark.parametrize("case", list(SWEEPS))
def test_size_sweep_visits_drops_and_orders_as_jax(monkeypatch, case, kind):
    kw = dict(min_bytes=16 * KiB, max_bytes=64 * KiB, iters=2, **SWEEPS[case])
    tick = _ticks(monkeypatch)
    jctx = jocm.ocm_init(jocm.OcmConfig(host_arena_bytes=1 << 20,
                                        device_arena_bytes=1 << 20))
    try:
        want = jsweep.size_sweep(jctx, jocm.OcmKind[kind], **kw)
    finally:
        jocm.ocm_tini(jctx)
    jax_ticks, tick[0] = tick[0], 0.0
    tctx = tocm.ocm_init(tocm.OcmConfig(host_arena_bytes=1 << 20,
                                        device_arena_bytes=1 << 20), device="cpu")
    try:
        got = sweep.size_sweep(tctx, tocm.OcmKind[kind], **kw)
    finally:
        tctx.tini()
    assert tick[0] == jax_ticks  # the same clock calls, in the same order
    assert got.label == want.label
    assert [p.nbytes for p in got.points] == [p.nbytes for p in want.points]
    assert [p.iters for p in got.points] == [p.iters for p in want.points]
    assert got.dropped == want.dropped and got.errors == want.errors
    # Which legs ran: the JAX write leg is None exactly where it was capped.
    cap = kw.get("write_max_bytes")
    for p in want.points:
        assert (p.write_gbps is None) == (cap is not None and p.nbytes > cap)
    # No device rate from a CPU run.
    assert all(p.write_gbps is None and p.read_gbps is None
               and p.read_amortized_gbps is None for p in got.points)
    assert list(got.as_dict()) == list(want.as_dict())


def test_size_sweep_amortized_leg_is_none_on_a_cpu_arena():
    ctx = tocm.ocm_init(tocm.OcmConfig(host_arena_bytes=1 << 20,
                                       device_arena_bytes=4 << 20), device="cpu")
    try:
        res = sweep.size_sweep(ctx, tocm.OcmKind.LOCAL_DEVICE, min_bytes=1 << 20,
                               max_bytes=2 << 20, iters=1, amortize_k=2,
                               amortize_min_bytes=1 << 20)
    finally:
        ctx.tini()
    assert [p.nbytes for p in res.points] == [1 << 20, 2 << 20]
    assert all(p.read_amortized_gbps is None for p in res.points) and not res.errors


def test_spmd_ring_sweep_on_a_cpu_mesh_of_4_rows():
    res = sweep.spmd_ring_sweep(["cpu"] * 4, min_bytes=1 * KiB, max_bytes=16 * KiB,
                                iters=2)
    assert res.label == "spmd_ring_sweep:4dev"
    assert [p.nbytes for p in res.points] == [KiB << i for i in range(5)]
    assert all(p.read_gbps is None and p.write_gbps is None for p in res.points)
    with pytest.raises(ValueError, match="must hold the largest chunk"):
        sweep.spmd_ring_sweep(["cpu"] * 4, max_bytes=16 * KiB, arena_bytes=8 * KiB)


def test_doubling_sizes_match():
    for lo, hi in ((64, 1 << 20), (1 << 10, 64 << 20), (3, 100)):
        assert sweep._doubling_sizes(lo, hi) == jsweep._doubling_sizes(lo, hi)


def test_without_cuda_the_sweeps_refuse(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tocm.OcmDeviceError):
        sweep.main(["--max-bytes", "65536"])
    with pytest.raises(tocm.OcmDeviceError):
        sweep.spmd_ring_sweep(max_bytes=16 * KiB)
