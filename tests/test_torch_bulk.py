"""The TMA bulk copy behind every one-shot copy of the port (K1's put, K2's
get, K3's same-device copy, K4's send and its local fast path), on the CPU.

The kernel (``csrc/copy.cuh`` bulk_copy) runs only on the card, where
``chip_smoke.py`` holds it byte for byte against the plain versions. Here:

- the plan the wrappers pass it (``dma.bulk_plan``) and the kernel's per-CTA
  slice formula (``dma.bulk_tiles``): the tiles cover [0, n) exactly once,
  each a multiple of 16 bytes and at most 32 KiB, over sizes that end on a
  short tile and over 1, 7 and 132 SMs;
- what the wrappers hand the C entry points, through a recording stand-in
  for the library: K1, K2 and K3 pass the plan; K4's send and its local
  fast path pass it too, and the send launches no recv wait on one device
  and one on the destination's card across cards;
- ``chip_smoke`` phase 3 and the cold-L2 rotation of the timings,
  rehearsed at tiny sizes.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

import chip_smoke
from oncilla_tpu_torch.benchmarks import kernel_times
from oncilla_tpu_torch.ops import dma, fabric

BLOCK = dma.BLOCK
KiB, MiB, GiB = 1 << 10, 1 << 20, 1 << 30


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("nbytes", [4 * KiB, 36 * KiB, MiB + 4 * KiB, 16 * MiB,
                                    GiB + 4 * KiB])
def test_bulk_plan_tiles_cover_the_copy_once(nbytes, sms):
    plan = dma.bulk_plan(nbytes, sms)
    assert 1 <= plan.grid <= dma.BULK_CTAS_PER_SM * sms
    assert 2 <= plan.slots <= 16 and plan.slots * plan.tile <= 227 * 1000
    tiles = list(dma.bulk_tiles(nbytes, plan))
    ctas, ends = set(), 0
    for cta, off, size in sorted(tiles, key=lambda t: t[1]):
        assert off == ends, "tiles must follow each other with no gap or overlap"
        assert 0 < size <= 32 * KiB and size % 16 == 0 and off % 16 == 0
        ctas.add(cta)
        ends = off + size
    assert ends == nbytes
    assert ctas == set(range(plan.grid)), "every CTA has at least one tile"
    # dealt round robin: CTA b copies tiles b, b+G, b+2G, ... in that order,
    # so the grid's k-th tiles are one window of G neighbouring tiles
    for cta in ctas:
        mine = [off // plan.tile for c, off, _ in tiles if c == cta]
        assert mine == list(range(cta, -(-nbytes // plan.tile), plan.grid))


class _Lib:
    """Stands in for a kernel library: records every entry point called and
    its arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors routed as if they lay on a card of 132 SMs, every launch
    recorded instead of run."""
    lib = _Lib()
    monkeypatch.setattr(dma, "route", lambda t: True)
    monkeypatch.setattr(dma, "library", lambda source, signatures: lib)
    monkeypatch.setattr(dma, "stream_of", lambda t: 7)
    monkeypatch.setattr(dma, "sm_count", lambda t: 132)
    dma.reset_launches()
    yield lib
    dma.reset_launches()


def test_get_passes_the_bulk_plan(fake_card):
    buf = torch.zeros(64 * BLOCK, dtype=torch.uint8)
    out = torch.empty(36 * KiB, dtype=torch.uint8)
    dma.read_rows(buf, 3 * BLOCK, 36 * KiB, out=out)
    (name, args), = fake_card.calls
    assert name == "ocm_read_rows"
    assert args[1:5] == (buf.data_ptr(), out.data_ptr(), 3 * BLOCK, 36 * KiB)
    assert args[5:8] == tuple(dma.bulk_plan(36 * KiB, 132)) and args[8] == 7
    assert dma.launches()["read_rows"] == 1


@pytest.mark.parametrize("nbytes", [BLOCK, 36 * KiB, MiB + BLOCK])
def test_put_passes_the_bulk_plan(fake_card, nbytes):
    buf = torch.zeros(2 * MiB, dtype=torch.uint8)
    raw = torch.ones(nbytes, dtype=torch.uint8)
    dma.write_rows(buf, raw, 3 * BLOCK)
    (name, args), = fake_card.calls
    assert name == "ocm_write_rows"
    assert args[1:5] == (buf.data_ptr(), raw.data_ptr(), 3 * BLOCK, nbytes)
    assert args[5:8] == tuple(dma.bulk_plan(nbytes, 132)) and args[8] == 7
    assert dma.launches()["write_rows"] == 1


@pytest.mark.parametrize("nbytes", [BLOCK, 36 * KiB, MiB + BLOCK])
def test_local_copy_passes_the_bulk_plan(fake_card, nbytes):
    buf = torch.zeros(4 * MiB, dtype=torch.uint8)
    dma.local_copy(buf, 3 * BLOCK, 2 * MiB, nbytes)
    (name, args), = fake_card.calls
    assert name == "ocm_local_copy"
    assert args[1:5] == (buf.data_ptr(), 3 * BLOCK, 2 * MiB, nbytes)
    assert args[5:8] == tuple(dma.bulk_plan(nbytes, 132)) and args[8] == 7
    assert dma.launches()["local_copy"] == 1


@pytest.mark.parametrize("src,dst,force,want", [
    (0, 1, False, ["ocm_onesided_send"]),
    (1, 1, True, ["ocm_onesided_send"]),
    (1, 1, False, ["ocm_onesided_local"]),
], ids=["cross_row", "loopback", "same_row"])
def test_one_card_send_is_one_bulk_launch(fake_card, src, dst, force, want):
    """On one device the send is the only launch (stream order is the recv
    wait) and takes the bulk plan; a copy within a row takes the local fast
    path, the bulk copy alone on the same plan."""
    arena = fabric.FabricRows([torch.zeros(16 * BLOCK, dtype=torch.uint8)
                               for _ in range(2)])
    fabric.onesided_copy(arena, src, dst, 0, 8 * BLOCK, 4 * BLOCK,
                         force_remote=force)
    assert [c[0] for c in fake_card.calls] == want
    args = fake_card.calls[0][1]
    if want == ["ocm_onesided_send"]:
        assert args[2] == arena.rows[dst].data_ptr() + 8 * BLOCK
        assert args[4:7] == tuple(dma.bulk_plan(4 * BLOCK, 132))
        assert args[9] == arena.seq[dst] == 1  # the flag rises on every send
        assert args[10] == 0  # one device: completion at device scope
    else:
        assert args[1:5] == (arena.rows[src].data_ptr(), 0, 8 * BLOCK, 4 * BLOCK)
        assert args[5:8] == tuple(dma.bulk_plan(4 * BLOCK, 132)) and args[8] == 7
    assert dma.launches()["onesided_copy"] == 1


class _Row:
    """A CPU row that reports itself on card ``index``, so that two rows
    stand for rows on two cards."""

    def __init__(self, nbytes: int, index: int):
        self.t = torch.zeros(nbytes, dtype=torch.uint8)
        self.device, self.index = self.t.device, index

    def get_device(self) -> int:
        return self.index

    def numel(self) -> int:
        return self.t.numel()

    def data_ptr(self) -> int:
        return self.t.data_ptr()


def test_cross_card_send_waits_on_the_destination(fake_card, monkeypatch):
    """A row on another card: the send releases at system scope, then the
    recv wait is launched on the destination's card for the same number,
    after the source's stream was ordered behind the destination's."""
    waits = []

    class _Stream:
        def __init__(self, device):
            self.device = device

        def wait_stream(self, other):
            waits.append((self.device, other.device))

    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    arena = fabric.FabricRows([_Row(16 * BLOCK, 0), _Row(16 * BLOCK, 1)])
    fabric.onesided_copy(arena, 0, 1, 0, 8 * BLOCK, 4 * BLOCK)
    (send, sargs), (wait, wargs) = fake_card.calls
    assert (send, wait) == ("ocm_onesided_send", "ocm_onesided_wait")
    assert sargs[0] == 0 and sargs[10] is True  # system-scope completion
    assert sargs[9] == arena.seq[1] == 1
    assert wargs[0] == 1 and wargs[1:3] == (sargs[8], 1)  # flag, number
    assert len(waits) == 1 and dma.launches()["onesided_copy"] == 1


def test_rotation_keeps_the_l2_cold():
    """At one page the source and destination extents a timing rotates over
    hold more than twice the L2; at 1 GiB one extent already does."""
    page = chip_smoke.PAGE
    k = kernel_times.rotation(page)
    assert k == 8 and 2 * k * page > 2 * kernel_times.L2_BYTES
    assert kernel_times.rotation(GiB) == 1


@pytest.mark.parametrize("case", ["cross_row", "same_row", "loopback"])
def test_rotated_fabric_extents_are_disjoint_and_in_the_row(case):
    row, n = 2 * GiB - BLOCK, chip_smoke.PAGE
    (c, _, a, b, so, do, _), = [x for x in chip_smoke._fabric_cases(row, [n])
                                if x[0] == case]
    spans = chip_smoke._rotated(so, n, row, 8), chip_smoke._rotated(do, n, row, 8)
    for offs in spans:
        assert all(0 <= o and o + n <= row and o % BLOCK == 0 for o in offs)
    if a == b:
        ext = sorted(o for offs in spans for o in offs)
        assert all(x + n <= y for x, y in zip(ext, ext[1:]))
    # at least one side of the case is off the 32 KiB tile grid
    assert so % (32 * KiB) or do % (32 * KiB)


def test_chip_smoke_kernels_phase_rehearsal_on_the_cpu():
    rows = chip_smoke.phase_kernels(
        torch.device("cpu"), 4 * MiB, (BLOCK, 36 * KiB, MiB + BLOCK),
        base=12 * KiB, copy_gap=2 * MiB + BLOCK, rate=3.35e12, timing=False)
    assert set(rows) == set(chip_smoke._DMA_KERNELS)
    for recs in rows.values():
        assert [r["nbytes"] for r in recs] == [BLOCK, 36 * KiB, MiB + BLOCK]
        assert all(r["max_abs_err"] == 0.0 for r in recs)


def test_tuning_refuses_the_cpu():
    path = Path(__file__).resolve().parents[1] / "scripts" / "tune_bulk_plan.py"
    spec = importlib.util.spec_from_file_location("tune_bulk_plan", path)
    tune = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tune)
    assert all(2 <= k and k * t <= 227 * 1000 for t, k, _ in tune.CANDIDATES)
    with pytest.raises(ValueError, match="CUDA card"):
        tune.tune("cpu")
