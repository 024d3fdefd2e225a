"""The port's C client library, ``libocm_tpu.so`` (built from
``oncilla_tpu_torch/runtime/native/`` by ``runtime/cluster.build_lib``),
driven through ctypes against the port's daemons: its native copy run by
``cluster.spawn`` and its Python ``Daemon`` in this process.

- The JAX package's ``tests/test_libocm.py``, case for case, on both
  daemon kinds: round trips, typed errors, a failed init, the pure-C demo
  app, eight threads at once, garbage on the control port, the localbuf
  and copy surface, the sized staging window.
- Parity: one seeded sequence of alloc, put, get, ``ocmc_copy``, localbuf
  and free through the JAX package's library and through the port's, each
  on a fresh cluster of port daemons, gives the same handles and bytes.
- The device leg (the JAX package's ``test_plane_relay.py``
  ``test_libocm_c_abi_device_roundtrip``): REMOTE_DEVICE put and get from
  C, and the demo app on REMOTE_DEVICE, relayed by the owner daemon to a
  controller's ``_PlaneServer`` on CPU rows.

A failed build fails these tests; nothing is skipped.
"""

import ctypes
import os
import socket
import subprocess
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import oncilla_tpu_torch as tocm
from oncilla_tpu_torch.core.arena import Extent
from oncilla_tpu_torch.core.errors import OcmError
from oncilla_tpu_torch.runtime import cluster
from oncilla_tpu_torch.runtime.cluster import OcmcHandle, load_lib
from oncilla_tpu_torch.runtime.membership import NodeEntry, parse_nodefile
from oncilla_tpu_torch.runtime.protocol import Message, MsgType, request

KIND_REMOTE_DEVICE, KIND_REMOTE_HOST = 2, 3


def ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.fixture(scope="module")
def lib():
    return load_lib(cluster.build_lib())


def wait_nnodes(entry: NodeEntry, n: int, deadline_s: float = 30.0) -> None:
    """Until the daemon at ``entry`` counts ``n`` nodes: an open listen
    socket does not mean the ADD_NODE join has landed."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        try:
            if cluster.daemon_status(entry, timeout=1.0)["nnodes"] >= n:
                return
        except (OSError, OcmError):
            pass  # still starting
        time.sleep(0.05)
    pytest.fail(f"daemons did not form a cluster of {n}")


@contextmanager
def port_daemons(kind: str, tmp_path, n: int = 2, *,
                 host_arena_bytes: int = 8 << 20,
                 device_arena_bytes: int = 8 << 20):
    """``n`` port daemons of ``kind`` ("native": processes of the port's
    copy, through ``cluster.spawn``; "python": the port's ``Daemon`` in
    this process) on loopback; yields (nodefile, entries)."""
    entries = [NodeEntry(r, "127.0.0.1", p)
               for r, p in enumerate(cluster.free_ports(n))]
    nodefile = tmp_path / "nodefile"
    nodefile.write_text("".join(f"{e.rank} {e.host} {e.port}\n" for e in entries))
    if kind == "native":
        binary = cluster.build_daemon()
        procs = [cluster.spawn(str(nodefile), r, host_arena_bytes=host_arena_bytes,
                               device_arena_bytes=device_arena_bytes,
                               log_path=str(tmp_path / f"daemon{r}.log"),
                               binary=binary)
                 for r in range(n)]
        try:
            wait_nnodes(entries[0], n)
            yield str(nodefile), entries
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.wait(timeout=10)
    else:
        from oncilla_tpu_torch.runtime.daemon import Daemon

        cfg = tocm.OcmConfig(host_arena_bytes=host_arena_bytes,
                             device_arena_bytes=device_arena_bytes)
        daemons = [Daemon(r, entries, config=cfg) for r in range(n)]
        for d in daemons:
            d.start()
        try:
            wait_nnodes(entries[0], n)
            yield str(nodefile), entries
        finally:
            for d in daemons:
                d.stop()


@pytest.fixture(params=["native", "python"])
def nodefile(request, tmp_path):
    """Two port daemons of each kind; the nodefile's path."""
    with port_daemons(request.param, tmp_path) as (nf, _):
        yield nf


def test_c_client_roundtrip(lib, nodefile):
    ctx = lib.ocmc_init(nodefile.encode(), 0, 0.0)
    assert ctx, lib.ocmc_last_error(None)
    try:
        assert lib.ocmc_nnodes(ctx) == 2
        h = OcmcHandle()
        assert lib.ocmc_alloc(ctx, 1 << 20, KIND_REMOTE_HOST, ctypes.byref(h)) == 0
        assert h.rank == 1 and lib.ocmc_is_remote(ctypes.byref(h)) == 1
        assert lib.ocmc_remote_sz(ctypes.byref(h)) == 1 << 20

        data = np.random.default_rng(0).integers(0, 256, 1 << 20, dtype=np.uint8)
        assert lib.ocmc_put(ctx, ctypes.byref(h), ptr(data), data.nbytes, 0) == 0
        out = np.zeros_like(data)
        assert lib.ocmc_get(ctx, ctypes.byref(h), ptr(out), out.nbytes, 0) == 0
        np.testing.assert_array_equal(out, data)

        # An offset round trip.
        assert lib.ocmc_put(ctx, ctypes.byref(h), ptr(data), 1024, 4096) == 0
        out2 = np.zeros(1024, dtype=np.uint8)
        assert lib.ocmc_get(ctx, ctypes.byref(h), ptr(out2), 1024, 4096) == 0
        np.testing.assert_array_equal(out2, data[:1024])

        assert lib.ocmc_free(ctx, ctypes.byref(h)) == 0
    finally:
        lib.ocmc_tini(ctx)


def test_c_client_errors(lib, nodefile):
    ctx = lib.ocmc_init(nodefile.encode(), 0, 0.0)
    assert ctx, lib.ocmc_last_error(None)
    try:
        h = OcmcHandle()
        assert lib.ocmc_alloc(ctx, 4096, KIND_REMOTE_HOST, ctypes.byref(h)) == 0

        # A put past the end: the daemon's ERR comes back as -1 with a message.
        buf = np.zeros(8192, dtype=np.uint8)
        assert lib.ocmc_put(ctx, ctypes.byref(h), ptr(buf), 8192, 0) == -1
        assert b"daemon error" in lib.ocmc_last_error(ctx)

        # The connection survives the error: a valid op still works.
        assert lib.ocmc_put(ctx, ctypes.byref(h), ptr(buf), 4096, 0) == 0
        assert lib.ocmc_free(ctx, ctypes.byref(h)) == 0
        assert lib.ocmc_free(ctx, ctypes.byref(h)) == -1  # double free

        # Device-kind data with no plane registered anywhere: the owner
        # daemon refuses the relayed op with a typed error naming the fix
        # (with a controller serving a plane the same call succeeds:
        # test_c_client_device_leg_through_the_plane_server).
        hd = OcmcHandle()
        assert lib.ocmc_alloc(ctx, 4096, KIND_REMOTE_DEVICE, ctypes.byref(hd)) == 0
        assert lib.ocmc_put(ctx, ctypes.byref(hd), ptr(buf), 4096, 0) == -1
        assert b"registered plane" in lib.ocmc_last_error(ctx)
        assert lib.ocmc_free(ctx, ctypes.byref(hd)) == 0
    finally:
        lib.ocmc_tini(ctx)


def test_c_client_init_failure(lib, tmp_path):
    bad = tmp_path / "nf"
    bad.write_text("0 127.0.0.1 1\n")  # port 1: nothing listens
    assert not lib.ocmc_init(str(bad).encode(), 0, 0.0)
    assert b"connect failed" in lib.ocmc_last_error(None)


def test_c_demo_program(lib, nodefile):
    """The pure-C demo app (the reference's ocm_test.c test-2 shape)
    against live daemons: put/get, localbuf, copy."""
    demo = cluster.BUILD_DIR / "ocm_c_demo"
    r = subprocess.run([str(demo), nodefile, "0", str(1 << 20)],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("pass:") == 3, r.stdout


def test_c_client_multithreaded(lib, nodefile):
    """Eight threads drive one context at once (ctypes releases the GIL
    for each C call): the library's ctrl and data locks, its owners map
    and its thread-local last_error under concurrency, with heartbeats
    on. A lost update, cross-talk or an error bleeding between threads
    fails the assertions."""
    ctx = lib.ocmc_init(nodefile.encode(), 0, 0.05)
    assert ctx, lib.ocmc_last_error(None)
    errs = []

    def worker(tid):
        try:
            rng = np.random.default_rng(tid)
            for it in range(6):
                h = OcmcHandle()
                nbytes = int(rng.integers(1, 64)) << 10
                assert lib.ocmc_alloc(ctx, nbytes, KIND_REMOTE_HOST,
                                      ctypes.byref(h)) == 0, lib.ocmc_last_error(ctx)
                data = rng.integers(0, 256, nbytes, dtype=np.uint8)
                assert lib.ocmc_put(ctx, ctypes.byref(h), ptr(data), nbytes, 0) == 0, \
                    lib.ocmc_last_error(ctx)
                out = np.zeros_like(data)
                assert lib.ocmc_get(ctx, ctypes.byref(h), ptr(out), nbytes, 0) == 0, \
                    lib.ocmc_last_error(ctx)
                np.testing.assert_array_equal(out, data)
                # Every other iteration an error, for the thread-local
                # last_error under concurrency.
                if it % 2 == 0:
                    bad = np.zeros(nbytes + 4096, dtype=np.uint8)
                    assert lib.ocmc_put(ctx, ctypes.byref(h), ptr(bad),
                                        nbytes + 4096, 0) == -1
                    assert b"daemon error" in lib.ocmc_last_error(ctx)
                assert lib.ocmc_free(ctx, ctypes.byref(h)) == 0, \
                    lib.ocmc_last_error(ctx)
        except Exception as e:  # noqa: BLE001
            errs.append(f"thread {tid}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "worker wedged"
    lib.ocmc_tini(ctx)
    assert not errs, errs


def test_daemon_survives_garbage_bytes(nodefile):
    """Random bytes on the control port do not take the daemon down: the
    connection may drop, but a well-formed request on a fresh connection
    still works."""
    e = parse_nodefile(nodefile)[0]
    rng = np.random.default_rng(99)
    for _ in range(20):
        s = socket.create_connection((e.connect_host, e.port), timeout=2.0)
        try:
            s.sendall(bytes(rng.integers(0, 256, int(rng.integers(1, 200)),
                                         dtype=np.uint8)))
        finally:
            s.close()
    # A whole frame whose payload is short for its schema (CONNECT needs 16
    # bytes of fields): the decoder's malformed-payload path, not the
    # short-read path.
    s = socket.create_connection((e.connect_host, e.port), timeout=2.0)
    try:
        s.sendall(b"OCM1" + bytes([2, 1, 0, 0]) + (3).to_bytes(4, "little") + b"abc")
    finally:
        s.close()
    s = socket.create_connection((e.connect_host, e.port), timeout=5.0)
    try:
        assert request(s, Message(MsgType.STATUS, {})).type == MsgType.STATUS_OK
    finally:
        s.close()


def test_c_client_localbuf_copy_surface(lib, nodefile, rng):
    """The rest of the header's surface from C: localbuf staging with
    copy_onesided (the op_flag convention), handle-to-handle ocmc_copy,
    and the copy_out/copy_in pair the reference left as -1 stubs."""
    ctx = lib.ocmc_init(nodefile.encode(), 0, 0.0)
    assert ctx, lib.ocmc_last_error(None)
    try:
        n = 256 << 10
        h1, h2 = OcmcHandle(), OcmcHandle()
        assert lib.ocmc_alloc(ctx, n, KIND_REMOTE_HOST, ctypes.byref(h1)) == 0
        assert lib.ocmc_alloc(ctx, n, KIND_REMOTE_HOST, ctypes.byref(h2)) == 0

        # localbuf: a stable staging window; write through it with
        # copy_onesided(op_flag=1), read back with op_flag=0.
        p = lib.ocmc_localbuf(ctx, ctypes.byref(h1))
        assert p and p == lib.ocmc_localbuf(ctx, ctypes.byref(h1))
        stage = (ctypes.c_uint8 * n).from_address(p)
        data = rng.integers(0, 256, n, dtype=np.uint8)
        stage[:] = data.tolist()
        assert lib.ocmc_copy_onesided(ctx, ctypes.byref(h1), 1) == 0
        ctypes.memset(p, 0, n)
        assert lib.ocmc_copy_onesided(ctx, ctypes.byref(h1), 0) == 0
        np.testing.assert_array_equal(np.ctypeslib.as_array(stage), data)

        # Handle-to-handle copy, then the destination read out.
        assert lib.ocmc_copy(ctx, ctypes.byref(h2), ctypes.byref(h1), 0) == 0
        out = np.zeros(n, dtype=np.uint8)
        assert lib.ocmc_copy_out(ctx, ptr(out), ctypes.byref(h2), n, 0) == 0
        np.testing.assert_array_equal(out, data)

        # copy_in at an offset.
        patch = rng.integers(0, 256, 1024, dtype=np.uint8)
        assert lib.ocmc_copy_in(ctx, ctypes.byref(h2), ptr(patch), 1024, 4096) == 0
        out2 = np.zeros(1024, dtype=np.uint8)
        assert lib.ocmc_copy_out(ctx, ptr(out2), ctypes.byref(h2), 1024, 4096) == 0
        np.testing.assert_array_equal(out2, patch)

        # An oversized copy is refused with a message, not clamped.
        small = OcmcHandle()
        assert lib.ocmc_alloc(ctx, 4096, KIND_REMOTE_HOST, ctypes.byref(small)) == 0
        assert lib.ocmc_copy(ctx, ctypes.byref(small), ctypes.byref(h1), n) == -1
        assert b"exceeds" in lib.ocmc_last_error(ctx)

        for h in (h1, h2, small):
            assert lib.ocmc_free(ctx, ctypes.byref(h)) == 0
    finally:
        lib.ocmc_tini(ctx)


def test_c_client_sized_window(lib, nodefile, rng):
    """An asymmetric staging window from C (ocmc_localbuf_sized): a 4 KiB
    window slides over a 64 KiB remote region through put/get offsets (the
    reference's local_alloc_bytes idiom, ocm_test.c:35-47)."""
    ctx = lib.ocmc_init(nodefile.encode(), 0, 0.0)
    assert ctx, lib.ocmc_last_error(None)
    try:
        h = OcmcHandle()
        assert lib.ocmc_alloc(ctx, 64 << 10, KIND_REMOTE_HOST, ctypes.byref(h)) == 0
        p = lib.ocmc_localbuf_sized(ctx, ctypes.byref(h), 4 << 10)
        assert p
        # The same pointer again; a resize is refused.
        assert lib.ocmc_localbuf(ctx, ctypes.byref(h)) == p
        assert not lib.ocmc_localbuf_sized(ctx, ctypes.byref(h), 8 << 10)
        assert b"different size" in lib.ocmc_last_error(ctx)

        stage = (ctypes.c_uint8 * (4 << 10)).from_address(p)
        data = rng.integers(0, 256, 4 << 10, dtype=np.uint8)
        stage[:] = data.tolist()
        assert lib.ocmc_put(ctx, ctypes.byref(h), p, 4 << 10, 32 << 10) == 0
        out = np.zeros(4 << 10, dtype=np.uint8)
        assert lib.ocmc_get(ctx, ctypes.byref(h), ptr(out), 4 << 10, 32 << 10) == 0
        np.testing.assert_array_equal(out, data)

        # copy_onesided moves only the window (from remote offset 0).
        assert lib.ocmc_copy_onesided(ctx, ctypes.byref(h), 1) == 0
        assert lib.ocmc_get(ctx, ctypes.byref(h), ptr(out), 4 << 10, 0) == 0
        np.testing.assert_array_equal(out, data)
        assert lib.ocmc_free(ctx, ctypes.byref(h)) == 0
    finally:
        lib.ocmc_tini(ctx)


def c_sequence(L, nodefile: str, seed: int) -> tuple[list, list]:
    """A seeded sequence of alloc, put, get, ocmc_copy, localbuf and free
    through library ``L`` at rank 0: the handles' (alloc_id, kind, rank,
    offset) and every byte read back."""
    rng = np.random.default_rng(seed)
    ctx = L.ocmc_init(nodefile.encode(), 0, 0.0)
    assert ctx, L.ocmc_last_error(None)
    handles, reads, hs = [], [], []
    try:
        for n in (4096, 300_000, (1 << 20) + 4096):
            h = OcmcHandle()
            assert L.ocmc_alloc(ctx, n, KIND_REMOTE_HOST, ctypes.byref(h)) == 0
            hs.append(h)
            handles.append((h.alloc_id, h.kind, h.rank, h.offset))
            data = rng.integers(0, 256, n, dtype=np.uint8)
            assert L.ocmc_put(ctx, ctypes.byref(h), ptr(data), n, 0) == 0
            out = np.zeros(n - 10, dtype=np.uint8)
            assert L.ocmc_get(ctx, ctypes.byref(h), ptr(out), n - 10, 10) == 0
            reads.append(out)
        assert L.ocmc_copy(ctx, ctypes.byref(hs[1]), ctypes.byref(hs[2]), 0) == 0
        out = np.zeros(300_000, dtype=np.uint8)
        assert L.ocmc_get(ctx, ctypes.byref(hs[1]), ptr(out), 300_000, 0) == 0
        reads.append(out)
        p = L.ocmc_localbuf(ctx, ctypes.byref(hs[0]))
        stage = np.ctypeslib.as_array((ctypes.c_uint8 * 4096).from_address(p))
        stage[:] = rng.integers(0, 256, 4096, dtype=np.uint8)
        assert L.ocmc_copy_onesided(ctx, ctypes.byref(hs[0]), 1) == 0
        stage[:] = 0
        assert L.ocmc_copy_onesided(ctx, ctypes.byref(hs[0]), 0) == 0
        reads.append(stage.copy())
        for h in hs:
            assert L.ocmc_free(ctx, ctypes.byref(h)) == 0
    finally:
        L.ocmc_tini(ctx)
    return handles, reads


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's own library, built by its own ``native.build_lib``
    (into its gitignored build directory) and only read."""
    from oncilla_tpu.runtime.native import native

    return load_lib(native.build_lib())


@pytest.mark.parametrize("daemon", ["native", "python"])
def test_both_libraries_give_the_same_handles_and_bytes(lib, jax_lib, daemon,
                                                        tmp_path):
    got = {}
    for name, L in (("jax", jax_lib), ("port", lib)):
        (tmp_path / name).mkdir()
        with port_daemons(daemon, tmp_path / name) as (nf, _):
            got[name] = c_sequence(L, nf, seed=5)
    assert got["port"][0] == got["jax"][0]
    assert len(got["port"][1]) == len(got["jax"][1]) == 5
    for a, b in zip(got["port"][1], got["jax"][1]):
        np.testing.assert_array_equal(a, b)
    assert got["port"][1][3].any() and got["port"][1][4].any()


def make_plane(kind: str, row: int):
    """A two-row plane on the CPU, one row a rank."""
    from oncilla_tpu_torch.ops.ici import IciDataPlane, SpmdIciPlane

    cfg = tocm.OcmConfig(device_arena_bytes=row)
    if kind == "spmd":
        return SpmdIciPlane(cfg, mesh=["cpu"] * 2, devices_per_rank=1)
    return IciDataPlane(cfg, devices=[torch.device("cpu")] * 2, devices_per_rank=1)


@pytest.mark.parametrize("plane_kind", ["spmd", "controller"])
@pytest.mark.parametrize("daemon", ["native", "python"])
def test_c_client_device_leg_through_the_plane_server(lib, daemon, plane_kind,
                                                      tmp_path, rng):
    """REMOTE_DEVICE from C: put and get through the owner daemon, which
    relays them to the controller's plane server; the controller reads the
    same bytes on its row. Then the demo app's whole journey on
    REMOTE_DEVICE."""
    from oncilla_tpu_torch.runtime.client import ControlPlaneClient

    row = 4 << 20
    with port_daemons(daemon, tmp_path, device_arena_bytes=row) as (nf, entries):
        plane = make_plane(plane_kind, row)
        controller = ControlPlaneClient(entries, 0, config=tocm.OcmConfig(
            device_arena_bytes=row, heartbeat_s=0.2), ici_plane=plane)
        try:
            ctx = lib.ocmc_init(nf.encode(), 1, 0.5)
            assert ctx, lib.ocmc_last_error(None)
            h = OcmcHandle()
            n = 64 << 10
            assert lib.ocmc_alloc(ctx, n, KIND_REMOTE_DEVICE, ctypes.byref(h)) == 0, \
                lib.ocmc_last_error(ctx)
            assert h.kind == KIND_REMOTE_DEVICE
            data = rng.integers(0, 256, n, dtype=np.uint8)
            assert lib.ocmc_put(ctx, ctypes.byref(h), ptr(data), n, 0) == 0, \
                lib.ocmc_last_error(ctx)
            out = np.zeros(n, np.uint8)
            assert lib.ocmc_get(ctx, ctypes.byref(h), ptr(out), n, 0) == 0, \
                lib.ocmc_last_error(ctx)
            np.testing.assert_array_equal(out, data)
            view = tocm.OcmAlloc(alloc_id=h.alloc_id, kind=tocm.OcmKind.REMOTE_DEVICE,
                                 fabric=tocm.Fabric.ICI, nbytes=n, rank=h.rank,
                                 device_index=h.device_index,
                                 extent=Extent(h.offset, n), origin_rank=1)
            np.testing.assert_array_equal(plane.get(view, n, 0).numpy(), data)
            served = controller._plane_server.served
            assert served["PLANE_PUT"] >= 1 and served["PLANE_GET"] >= 1, served
            assert lib.ocmc_free(ctx, ctypes.byref(h)) == 0
            lib.ocmc_tini(ctx)

            r = subprocess.run([str(cluster.BUILD_DIR / "ocm_c_demo"), nf, "1",
                                str(1 << 20), "2", "device"],
                               capture_output=True, text=True, timeout=60)
            assert r.returncode == 0, r.stdout + r.stderr
            assert r.stdout.count("pass:") == 3, r.stdout
        finally:
            controller.close()


def test_phase_8f_on_the_cpu():
    """chip_smoke's check (f) on CPU rows of two native daemons: the demo
    app on REMOTE_DEVICE, the library's bytes read by the controller and by
    ``ocmc_get``, rates beside a plane-less Python client's. Its launch
    check holds K1/K2 to the relayed ops, so on CPU rows, where no kernel
    runs, it must fail."""
    import chip_smoke

    row, cpu = 1 << 20, torch.device("cpu")
    with cluster.local_cluster(2, ndevices=2, device_arena_bytes=row) as cl:
        got = chip_smoke.wire_libocm(cl, cpu, row, (64 << 10, 256 << 10), reps=1,
                                     check_launches=False)
        assert got["demo"]["passes"] == 3 and got["rows"][0] == 0
        # Two puts and two gets of the library, each one chunk, and the
        # demo's own: its put, its staging write and its copy's write;
        # its get, its staging read, its copy's read and its copy_out.
        assert got["relayed"]["PLANE_PUT"] == 2 + 3
        assert got["relayed"]["PLANE_GET"] == 2 + 4
        assert not any(got["launches"].values())
        assert all(r[k] > 0 for r in got["rates"] for k in (
            "c_put_gbps", "c_get_gbps", "py_put_gbps", "py_get_gbps"))
        with pytest.raises(AssertionError, match="relayed ops .* but launches"):
            chip_smoke.wire_libocm(cl, cpu, row, (64 << 10, 256 << 10), reps=1)


# The child imports nothing of the packages: it starts in well under a second.
_CHUNK_CHILD = """
import ctypes, sys
import numpy as np
L = ctypes.CDLL(sys.argv[1])
vp, u64 = ctypes.c_void_p, ctypes.c_uint64
class H(ctypes.Structure):
    _fields_ = [("alloc_id", u64), ("rank", ctypes.c_int64),
                ("device_index", ctypes.c_uint32), ("kind", ctypes.c_uint8),
                ("nbytes", u64), ("offset", u64),
                ("owner_host", ctypes.c_char * 256), ("owner_port", ctypes.c_uint32)]
L.ocmc_init.restype = vp
L.ocmc_init.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_double]
L.ocmc_alloc.argtypes = [vp, u64, ctypes.c_uint8, ctypes.POINTER(H)]
L.ocmc_put.argtypes = L.ocmc_get.argtypes = [vp, ctypes.POINTER(H), vp, u64, u64]
L.ocmc_free.argtypes = [vp, ctypes.POINTER(H)]
L.ocmc_tini.argtypes = [vp]
ctx = L.ocmc_init(sys.argv[2].encode(), 0, 0.0)
h = H()
assert L.ocmc_alloc(ctx, 4096, 3, ctypes.byref(h)) == 0
data = (np.arange(4096) % 251).astype(np.uint8)
out = np.zeros(4096, np.uint8)
assert L.ocmc_put(ctx, ctypes.byref(h), data.ctypes.data, 4096, 0) == 0
assert L.ocmc_get(ctx, ctypes.byref(h), out.ctypes.data, 4096, 0) == 0
assert (out == data).all()
assert L.ocmc_free(ctx, ctypes.byref(h)) == 0
L.ocmc_tini(ctx)
"""


def chunked_ops(L_path, value) -> tuple[str, dict]:
    """A 4 KiB put and get from a process whose ``OCM_CHUNK_BYTES`` is
    ``value``: what the library said on stderr, and the data ops the owner
    daemon served (each chunk is one)."""
    with cluster.local_cluster(2, env={"OCM_EVENTS": "1"}) as cl:
        env = {k: v for k, v in os.environ.items() if k != "OCM_CHUNK_BYTES"}
        if value is not None:
            env["OCM_CHUNK_BYTES"] = value
        r = subprocess.run([sys.executable, "-c", _CHUNK_CHILD, str(L_path),
                            cl.nodefile],
                           capture_output=True, text=True, env=env, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        e = cl.entries[1]
        with socket.create_connection((e.host, e.port), timeout=5) as s:
            text = bytes(request(s, Message(MsgType.STATUS_PROM, {})).data).decode()
    ops = {line.split('op="')[1].split('"')[0]: float(line.split()[-1])
           for line in text.splitlines() if line.startswith("ocm_op_total")}
    return r.stderr.strip(), ops


@pytest.mark.parametrize("value,chunks", [
    (None, 1), ("-18446744073709551615", 1), (" -1", 1),
    # The reference's fault (libocm.cc:80, ROADMAP Queue C): the minus-sign
    # guard reads only the first byte, so a leading blank lets strtoull
    # wrap this to 1, and every byte goes as a chunk of its own.
    (" -18446744073709551615", 4096)])
def test_chunk_bytes_parsing_is_the_jax_librarys(lib, jax_lib, value, chunks):
    """``OCM_CHUNK_BYTES`` as each library reads it: the same warning (or
    none) and the same chunks on the wire for every value, the reference's
    fault included."""
    got = {name: chunked_ops(L._name, value)
           for name, L in (("jax", jax_lib), ("port", lib))}
    assert got["port"] == got["jax"]
    err, ops = got["port"]
    assert ops["dcn_put_srv"] == ops["dcn_get_srv"] == chunks
    assert ("ignoring invalid OCM_CHUNK_BYTES" in err) == (
        value is not None and chunks == 1)
