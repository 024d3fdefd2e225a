"""The port's device fabric held against the JAX package on the CPU.

- (a) The plain version of the one-sided copy K4
  (``oncilla_tpu_torch.ops.fabric.onesided_copy`` on CPU rows) against the
  JAX ``pallas_ici_copy`` run in the Pallas interpret machine on the 8
  virtual devices: the cases of tests/test_pallas_ici.py, whole rows
  compared after every copy.
- (b) ``parallel.spmd_arena`` against the JAX module, op for op.
- (c) ``SpmdIciPlane`` and ``IciDataPlane`` with handles booked by hand: the
  cases of tests/test_ici.py:138-221, bounds and range errors, the 2 GiB row
  error, a chunked ``IciDataPlane.copy``.
- (d) ``Ocm(remote=backend).copy`` between REMOTE_DEVICE handles rides the
  backend's ``ici_plane`` with no get (``BookingBackend``, a stand-in that
  books extents itself; the daemon-placed handles are
  tests/test_torch_client.py's and test_torch_native_daemon.py's).
- (g) Without CUDA the fabric's entry points raise unless the CPU is named.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` (phase 6).
"""

import itertools
import sys
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import oncilla_tpu as jocm
import oncilla_tpu_torch as tocm
from oncilla_tpu.core.arena import Extent as JExtent
from oncilla_tpu.core.handle import OcmAlloc as JAlloc
from oncilla_tpu.ops import ici as jici
from oncilla_tpu.ops import pallas_ici as pi
from oncilla_tpu.parallel import mesh as jmesh_mod
from oncilla_tpu.parallel import spmd_arena as jsa
from oncilla_tpu_torch.ops import dma, fabric
from oncilla_tpu_torch.ops import ici as tici
from oncilla_tpu_torch.parallel import mesh as tmesh_mod
from oncilla_tpu_torch.parallel import spmd_arena as tsa

BLOCK = pi.BLOCK
ARENA = 64 << 10  # 16 blocks a row
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_mod.node_mesh()


def _rows(t_arena) -> np.ndarray:
    return np.stack([r.numpy() for r in t_arena.rows])


def _same(j_arena, t_arena, what=""):
    np.testing.assert_array_equal(np.asarray(j_arena), _rows(t_arena), err_msg=what)


def _stamped(jmesh, rng, row_bytes):
    """Both arenas with the same distinct random bytes in every row."""
    stamps = rng.integers(0, 256, (8, row_bytes), dtype=np.uint8)
    j = jsa.make_arena(jmesh, row_bytes)
    t = tsa.make_arena(tmesh_mod.node_mesh(CPU8), row_bytes)
    for d in range(8):
        j = jsa.host_put(j, d, stamps[d], 0, mesh=jmesh)
        tsa.host_put(t, d, stamps[d], 0)
    _same(j, t)
    return j, t


# -- (a) K4's plain version against pallas_ici_copy in interpret mode ---------

K4_CASES = {
    # name: (row bytes, src dev, dst dev, src off, dst off, nbytes, force_remote)
    "cross_device": (ARENA, 1, 6, 0, 4 * BLOCK, 2 * BLOCK, False),
    "same_device": (ARENA, 4, 4, 0, 8 * BLOCK, 3 * BLOCK, False),
    "loopback": (ARENA, 3, 3, BLOCK, 10 * BLOCK, 2 * BLOCK, True),
    "edge_blocks": (ARENA, 0, 7, 0, 15 * BLOCK, BLOCK, False),
    "whole_row": (ARENA, 2, 5, 0, 0, ARENA, False),
    "window_chunk_boundary": (64 * BLOCK, 1, 6, 0, 8 * BLOCK,
                              (pi.INTERP_WINDOW_BLOCKS + 6) * BLOCK, False),
    "mib_scale": (4 << 20, 2, 5, 0, 2 << 20, 1 << 20, False),
}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_onesided_copy_matches_pallas_ici_copy(jmesh, rng, case):
    row, s, d, so, do, n, force = K4_CASES[case]
    j, t = _stamped(jmesh, rng, row)
    j = pi.pallas_ici_copy(j, s, d, so, do, n, mesh=jmesh, force_remote=force)
    out = fabric.onesided_copy(t, s, d, so, do, n, force_remote=force)
    assert out is t  # in place
    _same(j, t, case)


def test_onesided_copy_fuzz_chain_matches_pallas(jmesh, rng):
    """The seeded chain of tests/test_pallas_ici.py:167-220 with its forced
    cases (multi-window, same-device, loopback), through both packages,
    every row compared after every copy."""
    row, nblk_row = 48 * BLOCK, 48
    j, t = _stamped(jmesh, rng, row)
    win = pi.INTERP_WINDOW_BLOCKS
    cases = [(1, 6, 2, 10, win + 5, False), (3, 3, 0, 30, 12, False),
             (5, 5, 20, 4, 9, True)]
    while len(cases) < 11:
        s_dev, d_dev = int(rng.integers(8)), int(rng.integers(8))
        nblk = int(rng.integers(1, 31))
        s_blk = int(rng.integers(0, nblk_row - nblk + 1))
        d_blk = int(rng.integers(0, nblk_row - nblk + 1))
        if s_dev == d_dev and not (s_blk + nblk <= d_blk or d_blk + nblk <= s_blk):
            continue
        cases.append((s_dev, d_dev, s_blk, d_blk, nblk, False))
    for k, (s_dev, d_dev, s_blk, d_blk, nblk, force) in enumerate(cases):
        args = (s_dev, d_dev, s_blk * BLOCK, d_blk * BLOCK, nblk * BLOCK)
        j = pi.pallas_ici_copy(j, *args, mesh=jmesh, force_remote=force)
        fabric.onesided_copy(t, *args, force_remote=force)
        _same(j, t, f"copy {k}: {args} force_remote={force}")


def test_onesided_copy_contract_matches_pallas(jmesh):
    j = jsa.make_arena(jmesh, ARENA)
    t = tsa.make_arena(tmesh_mod.node_mesh(CPU8), ARENA)
    for mod_call in (lambda *a: pi.pallas_ici_copy(j, *a, mesh=jmesh),
                     lambda *a: fabric.onesided_copy(t, *a)):
        with pytest.raises(AssertionError, match="BLOCK-aligned"):
            mod_call(0, 1, 17, 0, BLOCK)
        with pytest.raises(AssertionError, match="overlapping"):
            mod_call(2, 2, 0, BLOCK, 2 * BLOCK)


def test_cpu_rows_take_the_plain_version_and_count_no_launch(rng):
    t = tsa.make_arena(tmesh_mod.node_mesh(["cpu"] * 2), ARENA)
    dma.reset_launches()
    fabric.onesided_copy(t, 0, 1, 0, 0, BLOCK)
    fabric.onesided_copy(t, 1, 1, 0, BLOCK, BLOCK, force_remote=True)
    assert dma.launches()["onesided_copy"] == 0
    assert t.seq == [0, 0]  # the protocol's sequence numbers: kernel only
    assert all(w.tolist() == [0, 0] for w in t.sync)


def test_no_plain_fallback_off_the_cpu():
    rows = fabric.FabricRows([torch.empty(ARENA, dtype=torch.uint8, device="meta")] * 2)
    with pytest.raises(ValueError, match="no copy kernel"):
        fabric.onesided_copy(rows, 0, 1, 0, 0, BLOCK)


# -- (b) spmd_arena, op for op -------------------------------------------------


def test_spmd_arena_ops_match_jax(jmesh, rng):
    j, t = _stamped(jmesh, rng, ARENA)
    data = rng.integers(0, 256, 4096, dtype=np.uint8)
    j = jsa.host_put(j, 3, data, 8192, mesh=jmesh)
    assert tsa.host_put(t, 3, data, 8192) is t
    _same(j, t, "host_put")
    np.testing.assert_array_equal(
        np.asarray(jsa.host_get(j, 3, 4096, 8192, mesh=jmesh)),
        tsa.host_get(t, 3, 4096, 8192).numpy())
    j = jsa.fill_zero(j, 5, 4096, 3 * 4096 + 100, mesh=jmesh)
    tsa.fill_zero(t, 5, 4096, 3 * 4096 + 100)
    _same(j, t, "fill_zero")
    x = rng.standard_normal((32, 16)).astype(np.float32)
    j = jsa.host_put(j, 4, x, 4096, mesh=jmesh)
    tsa.host_put(t, 4, torch.from_numpy(x), 4096)
    _same(j, t, "host_put f32")
    np.testing.assert_array_equal(
        np.asarray(jsa.read_typed(j, 4, (32, 16), jax.numpy.float32, 4096,
                                  mesh=jmesh)),
        tsa.read_typed(t, 4, (32, 16), torch.float32, 4096).numpy())


ICI_COPY_CASES = {
    # name: (src dev, dst dev, src off, dst off, nbytes)
    "cross_device": (1, 6, 0, 4096, 4096),
    "same_device_disjoint": (2, 2, 0, 8 * BLOCK, 4 * BLOCK),
    "same_device_overlap": (2, 2, 0, BLOCK, 4 * BLOCK),
    "unaligned": (0, 7, 100, 5000, 3000),
}


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("case", list(ICI_COPY_CASES))
def test_ici_copy_matches_jax(jmesh, rng, case, use_kernel):
    j, t = _stamped(jmesh, rng, ARENA)
    args = ICI_COPY_CASES[case]
    j = jsa.ici_copy(j, *args, mesh=jmesh, use_pallas=use_kernel)
    dma.reset_launches()
    assert tsa.ici_copy(t, *args, use_kernel=use_kernel) is t
    _same(j, t, case)
    assert dma.launches()["onesided_copy"] == 0  # CPU rows


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_ring_shift_matches_jax(jmesh, rng, reverse):
    j, t = _stamped(jmesh, rng, 8 << 10)
    j = jsa.ring_shift(j, 512, 1024, mesh=jmesh, reverse=reverse)
    assert tsa.ring_shift(t, 512, 1024, reverse=reverse) is t
    _same(j, t)
    j = jsa.ring_shift(j, 512, 1024, mesh=jmesh, reverse=not reverse)
    tsa.ring_shift(t, 512, 1024, reverse=not reverse)
    _same(j, t, "shift and back")


def test_mesh_helpers_match_jax():
    assert tmesh_mod.NODE_AXIS == jmesh_mod.NODE_AXIS
    for args in ((0, 3, 4), (1, 2, 4), (3, 0, 2)):
        assert tmesh_mod.global_index(*args) == jmesh_mod.global_index(*args)
    mesh = tmesh_mod.node_mesh(["cpu", torch.device("cpu")])
    assert mesh == [torch.device("cpu")] * 2


def test_config_chunking_matches_jax():
    j, t = jocm.OcmConfig(), tocm.OcmConfig()
    assert (t.chunk_bytes, t.inflight_ops) == (j.chunk_bytes, j.inflight_ops)
    for field in ("chunk_bytes", "inflight_ops"):
        for mod in (jocm, tocm):
            with pytest.raises(ValueError, match=f"{field} must be"):
                mod.OcmConfig(**{field: 0})


# -- (c) the planes, with handles booked by hand ------------------------------

PLANE_ROW = 64 << 10


def _handle(pkg, aid, g, off, n, dpr=4):
    """A REMOTE_DEVICE handle on mesh entry g, for either package."""
    if pkg == "jax":
        return JAlloc(alloc_id=aid, kind=jocm.OcmKind.REMOTE_DEVICE,
                      fabric=jocm.Fabric.ICI, nbytes=n, rank=g // dpr,
                      device_index=g % dpr, extent=JExtent(off, n),
                      origin_rank=0)
    return tocm.OcmAlloc(alloc_id=aid, kind=tocm.OcmKind.REMOTE_DEVICE,
                         fabric=tocm.Fabric.ICI, nbytes=n, rank=g // dpr,
                         device_index=g % dpr, extent=tocm.Extent(off, n),
                         origin_rank=0)


@pytest.fixture
def planes():
    jc = jocm.OcmConfig(host_arena_bytes=1 << 20, device_arena_bytes=PLANE_ROW)
    tc = tocm.OcmConfig(host_arena_bytes=1 << 20, device_arena_bytes=PLANE_ROW)
    return {"jax": jici.SpmdIciPlane(config=jc, devices_per_rank=4),
            "torch": tici.SpmdIciPlane(config=tc, mesh=CPU8, devices_per_rank=4)}


def _plane_rows(pkg, plane):
    return np.asarray(plane.arena) if pkg == "jax" else _rows(plane.arena)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_spmd_plane_put_copy_get_match_jax(planes, rng, use_kernel):
    """put on rank 0's device 1, one-sided copy to rank 1's device 2, get:
    same bytes, same rows, one ici_copy in both packages."""
    data = rng.integers(0, 256, 16 << 10, dtype=np.uint8)
    out = {}
    for pkg, plane in planes.items():
        src = _handle(pkg, 3, 1, 8192, 16 << 10)
        dst = _handle(pkg, 5, 6, 32768, 16 << 10)
        plane.put(src, data)
        kw = {"use_pallas" if pkg == "jax" else "use_kernel": use_kernel}
        plane.copy(dst, src, 16 << 10, **kw)
        out[pkg] = (_np(plane.get(dst, 16 << 10)), _plane_rows(pkg, plane),
                    dict(plane.stats))
    np.testing.assert_array_equal(out["torch"][0], data)
    np.testing.assert_array_equal(out["jax"][1], out["torch"][1])
    assert out["jax"][2] == out["torch"][2] == {"ici_copies": 1, "puts": 1, "gets": 1}


def test_spmd_plane_typed_scrub_and_bounds_match_jax(planes):
    x = np.arange(2048, dtype=np.float32)
    errors = {}
    for pkg, plane in planes.items():
        m = jocm if pkg == "jax" else tocm
        h = _handle(pkg, 7, 4, 4096, 8 << 10)
        plane.put(h, x)
        f32 = jax.numpy.float32 if pkg == "jax" else torch.float32
        np.testing.assert_array_equal(_np(plane.get_as(h, (2048,), f32)), x)
        errs = []
        for fn in (lambda: plane.get(h, (8 << 10) + 1, 0),
                   lambda: plane.put(h, np.zeros(16, np.uint8), (8 << 10) - 8),
                   lambda: plane.get(_handle(pkg, 9, 0, PLANE_ROW - 4096, 8192), 16)):
            with pytest.raises(m.OcmBoundsError) as e:
                fn()
            errs.append(str(e.value))
        errors[pkg] = errs
        plane.scrub(h)
        assert not _np(plane.get(h, 8 << 10)).any()
    assert errors["jax"] == errors["torch"]
    np.testing.assert_array_equal(_plane_rows("jax", planes["jax"]),
                                  _plane_rows("torch", planes["torch"]))


def test_resolve_global_device_matches_jax():
    for dpr, nd, (rank, di) in ((4, 8, (0, 4)), (4, 8, (2, 0)), (2, 8, (0, 2)),
                                (4, 8, (1, 3))):
        msgs = []
        for pkg, fn, m in (("jax", jici.resolve_global_device, jocm),
                           ("torch", tici.resolve_global_device, tocm)):
            h = _handle(pkg, 1, 0, 0, 4096, dpr)
            h.rank, h.device_index = rank, di
            try:
                msgs.append(("ok", fn(h, dpr, nd)))
            except m.OcmInvalidHandle as e:
                msgs.append(("err", str(e)))
        assert msgs[0] == msgs[1]


def test_spmd_plane_rows_of_2_gib_raise_like_jax():
    with pytest.raises(jocm.OcmError, match="2 GiB"):
        jici.SpmdIciPlane(config=jocm.OcmConfig(device_arena_bytes=2**31))
    with pytest.raises(tocm.OcmError, match="2 GiB"):
        tici.SpmdIciPlane(config=tocm.OcmConfig(device_arena_bytes=2**31), mesh=CPU8)


def test_spmd_plane_concurrent_ops(rng):
    """Racing puts, gets and copies through the plane's lock: no lost
    update, every handle reads back its own bytes."""
    plane = tici.SpmdIciPlane(tocm.OcmConfig(device_arena_bytes=PLANE_ROW),
                              mesh=["cpu"] * 4, devices_per_rank=4)
    n = 4 << 10
    handles = [(_handle("torch", 2 * i, i, 0, n), _handle("torch", 2 * i + 1, i, 8 * n, n))
               for i in range(4)]
    datas = [rng.integers(0, 256, n, dtype=np.uint8) for _ in range(4)]
    errs = []

    def worker(i):
        try:
            for _ in range(20):
                plane.put(handles[i][0], datas[i])
                plane.copy(handles[i][1], handles[i][0], n)
                np.testing.assert_array_equal(plane.get(handles[i][1], n).numpy(), datas[i])
        except Exception as e:
            errs.append(f"t{i}: {type(e).__name__}: {e}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errs, errs
    assert plane.stats == {"ici_copies": 80, "puts": 80, "gets": 80}


def test_ici_data_plane_chunked_copy_matches_jax(rng, monkeypatch):
    """A 96 KiB copy between two arenas in 16 KiB chunks: every chunk is
    sent and written, at most ``inflight_ops`` are staged at once, and the
    arenas end as the JAX plane's do."""
    n = 96 << 10
    data = rng.integers(0, 256, n, dtype=np.uint8)
    jc = jocm.OcmConfig(host_arena_bytes=1 << 20, device_arena_bytes=256 << 10,
                        chunk_bytes=16 << 10)
    tc = tocm.OcmConfig(host_arena_bytes=1 << 20, device_arena_bytes=256 << 10,
                        chunk_bytes=16 << 10)
    jp = jici.IciDataPlane(config=jc, devices=jax.devices(), devices_per_rank=4)
    tp = tici.IciDataPlane(config=tc, devices=CPU8, devices_per_rank=4)
    staged, peak, sent = [0], [0], []
    a_src, a_dst = tp.arenas[1], tp.arenas[6]
    real_read, real_write = a_src.read, a_dst.write

    def read(ext, nbytes, offset=0):
        staged[0] += 1
        peak[0] = max(peak[0], staged[0])
        return real_read(ext, nbytes, offset)

    def write(ext, data_, offset=0):
        staged[0] -= 1
        sent.append((offset, as_len(data_)))
        return real_write(ext, data_, offset)

    def as_len(x):
        return x.numel() if isinstance(x, torch.Tensor) else len(x)

    for pkg, plane in (("jax", jp), ("torch", tp)):
        src = _handle(pkg, 1, 1, 8192, n)
        dst = _handle(pkg, 3, 6, 4096, n + 8192)
        plane.put(src, data)
        if pkg == "torch":
            monkeypatch.setattr(a_src, "read", read)
            monkeypatch.setattr(a_dst, "write", write)
        plane.copy(dst, src, n, dst_offset=4096)
        got = _np(plane.get(dst, n, 4096))
        np.testing.assert_array_equal(got, data)
    assert sent == [(4096 + k * (16 << 10), 16 << 10) for k in range(6)]
    assert peak[0] == tc.inflight_ops
    for g in range(8):
        np.testing.assert_array_equal(np.asarray(jp.arenas[g].buffer).reshape(-1),
                                      tp.arenas[g].buffer.numpy(), err_msg=f"arena {g}")
    with pytest.raises(tocm.OcmBoundsError):
        tp.copy(_handle("torch", 5, 2, 0, 4096), _handle("torch", 7, 3, 0, 4096), 8192)


# -- (d) Ocm(remote=...) ------------------------------------------------------


class BookingBackend:
    """Stands in for the daemon behind ``Ocm(remote=...)``: books
    REMOTE_DEVICE extents on the rows of an ``SpmdIciPlane`` (one
    ``ArenaAllocator`` a row, rows taken in turn, so no two live extents
    overlap), scrubs each at alloc as the daemon client does, serves
    put/get from the plane, and carries it as ``ici_plane`` so that
    ``Ocm.copy`` between two of its handles rides the one-sided fabric."""

    def __init__(self, plane, alignment: int = 4096):
        from oncilla_tpu_torch.core.arena import ArenaAllocator

        self.ici_plane = plane
        self._books = [ArenaAllocator(plane.config.device_arena_bytes, alignment)
                       for _ in plane.mesh]
        self._rows = itertools.cycle(range(len(self._books)))
        self._ids = itertools.count(2, 2)  # even ids, as the daemon's

    def _row(self, handle) -> int:
        return handle.rank * self.ici_plane.devices_per_rank + handle.device_index

    def alloc(self, nbytes: int, kind):
        if kind != tocm.OcmKind.REMOTE_DEVICE:
            raise tocm.OcmConnectError(
                f"this backend books REMOTE_DEVICE only, not {kind}")
        g = next(self._rows)
        dpr = self.ici_plane.devices_per_rank
        h = tocm.OcmAlloc(
            alloc_id=next(self._ids), kind=kind, fabric=tocm.Fabric.ICI,
            nbytes=nbytes, rank=g // dpr, device_index=g % dpr,
            extent=self._books[g].alloc(nbytes), origin_rank=0,
        )
        self.ici_plane.scrub(h)
        return h

    def free(self, handle) -> None:
        self._books[self._row(handle)].free(handle.extent)

    def put(self, handle, data, offset: int) -> None:
        self.ici_plane.put(handle, data, offset)

    def get(self, handle, nbytes: int, offset: int):
        return self.ici_plane.get(handle, nbytes, offset)


class _JaxBooking(BookingBackend):
    """The same booking for the JAX context: JAX handles on the JAX plane."""

    def __init__(self, plane):
        super().__init__(SimpleNamespace(config=plane.config,
                                         mesh=range(plane.mesh.devices.size)))
        self.ici_plane = plane

    def alloc(self, nbytes, kind):
        h = super().alloc(nbytes, tocm.OcmKind.REMOTE_DEVICE)
        return _handle("jax", h.alloc_id, self._row(h), h.extent.offset, nbytes,
                       self.ici_plane.devices_per_rank)


def test_ocm_copy_between_remote_device_handles_rides_the_plane(planes, rng):
    data = rng.integers(0, 256, 16 << 10, dtype=np.uint8)
    rows = {}
    for pkg, plane in planes.items():
        if pkg == "jax":
            ctx = jocm.Ocm(jocm.OcmConfig(host_arena_bytes=1 << 20,
                                          device_arena_bytes=1 << 20),
                           remote=_JaxBooking(plane))
        else:
            ctx = tocm.Ocm(tocm.OcmConfig(host_arena_bytes=1 << 20,
                                          device_arena_bytes=1 << 20),
                           remote=BookingBackend(plane), device="cpu")
        k = (jocm if pkg == "jax" else tocm).OcmKind.REMOTE_DEVICE
        src, dst, same_row = ctx.alloc(16 << 10, k), ctx.alloc(16 << 10, k), None
        for _ in range(8):  # walk the booking round to src's row again
            h = ctx.alloc(4096, k)
            if (h.rank, h.device_index) == (src.rank, src.device_index):
                same_row = h
                break
        ctx.put(src, data)
        gets = plane.stats["gets"]
        dma.reset_launches()
        ctx.copy(dst, src)
        ctx.copy(same_row, src, nbytes=4096, src_offset=8192)
        assert plane.stats["gets"] == gets  # no host round trip
        assert plane.stats["ici_copies"] == 2
        np.testing.assert_array_equal(_np(ctx.get(dst)), data)
        np.testing.assert_array_equal(_np(ctx.get(same_row)), data[8192:12288])
        ctx.free(dst)
        ctx.tini()
        rows[pkg] = _plane_rows(pkg, plane)
    np.testing.assert_array_equal(rows["jax"], rows["torch"])


@pytest.mark.parametrize("dst_kind", ["LOCAL_HOST", "LOCAL_DEVICE", "REMOTE_DEVICE"])
@pytest.mark.parametrize("src_kind", ["LOCAL_HOST", "LOCAL_DEVICE", "REMOTE_DEVICE"])
def test_copy_matrix_with_a_remote_backend_matches_jax(planes, rng, src_kind, dst_kind):
    data = rng.integers(0, 256, 8 << 10, dtype=np.uint8)
    got = {}
    for pkg, plane in planes.items():
        if pkg == "jax":
            m = jocm
            ctx = jocm.Ocm(jocm.OcmConfig(host_arena_bytes=1 << 20,
                                          device_arena_bytes=1 << 20),
                           remote=_JaxBooking(plane))
        else:
            m = tocm
            ctx = tocm.Ocm(tocm.OcmConfig(host_arena_bytes=1 << 20,
                                          device_arena_bytes=1 << 20),
                           remote=BookingBackend(plane), device="cpu")
        src, dst = ctx.alloc(8 << 10, m.OcmKind[src_kind]), ctx.alloc(8 << 10, m.OcmKind[dst_kind])
        ctx.put(src, data)
        ctx.copy(dst, src)
        got[pkg] = (_np(ctx.get(dst)), _np(ctx.get(src)))
        ctx.free(src)
        ctx.free(dst)
        ctx.tini()
    for a, b in zip(got["jax"], got["torch"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["torch"][0], data)


def test_remote_kinds_without_a_backend_still_raise():
    ctx = tocm.Ocm(tocm.OcmConfig(host_arena_bytes=1 << 20, device_arena_bytes=1 << 20),
                   device="cpu")
    with pytest.raises(tocm.OcmConnectError):
        ctx.alloc(4096, tocm.OcmKind.REMOTE_DEVICE)
    h = _handle("torch", 2, 0, 0, 4096)
    for fn in (lambda: ctx.put(h, np.zeros(16, np.uint8)), lambda: ctx.get(h),
               lambda: ctx.localbuf(h)):
        with pytest.raises(tocm.OcmConnectError):
            fn()
    with pytest.raises(tocm.OcmConnectError):
        tocm.ocm_init(tocm.OcmConfig(host_arena_bytes=1 << 20,
                                     device_arena_bytes=1 << 20, rank=1), device="cpu")


# -- (g) no CUDA, no CPU named: raise -----------------------------------------


def test_fabric_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tocm.OcmConfig(host_arena_bytes=1 << 20, device_arena_bytes=1 << 20)
    for fn in (tmesh_mod.node_mesh, lambda: tmesh_mod.node_mesh(["cuda:0"]),
               lambda: tici.SpmdIciPlane(cfg), lambda: tici.IciDataPlane(cfg)):
        with pytest.raises(tocm.OcmDeviceError):
            fn()
    assert tici.SpmdIciPlane(cfg, mesh=["cpu"]).arena.rows[0].device.type == "cpu"
