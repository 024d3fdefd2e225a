"""The port's daemon client held against the JAX package's, on the JAX
package's in-process cluster (``oncilla_tpu.runtime.cluster.local_cluster``,
Python daemons on loopback ports). The test imports both packages; the
port's client speaks to the JAX daemons over the wire only.

- REMOTE_HOST alloc / put / get / free: the same handles (id, kind, rank,
  device, offset) as a JAX client's on a fresh cluster, the same bytes,
  striped and chunked transfers, ``get_into`` a caller's buffer.
- Typed errors: the same class names and wire codes as the JAX client's.
- Leases: heartbeats keep allocations alive under a short lease, a client
  that never beats is reaped, DISCONNECT reclaims at once.
- ``ocm_init`` through a nodefile; single-node demotion with
  ``daemon_owned`` routing; REMOTE_DEVICE handles on a CPU ``SpmdIciPlane``
  (copies ride the plane, no get) and the plane relay serving a plane-less
  client.
- A seeded differential fuzz of the port's ``Ocm`` against the JAX ``Ocm``
  over two clusters: bytes, handles and exception types equal (the shape of
  tests/test_cluster.py:542).
- A thread stress of one client shared by more workers than cores.

Tolerance 0 throughout: bytes, handles and error types must be equal.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import oncilla_tpu as jocm
import oncilla_tpu_torch as tocm
from oncilla_tpu.ops.ici import SpmdIciPlane as JPlane
from oncilla_tpu.runtime.cluster import local_cluster as jax_cluster
from oncilla_tpu_torch.ops.ici import SpmdIciPlane as TPlane
from oncilla_tpu_torch.runtime.client import ControlPlaneClient as TClient
from oncilla_tpu_torch.runtime.membership import NodeEntry as TEntry
from oncilla_tpu_torch.runtime.protocol import ErrCode

J, T = jocm.OcmKind, tocm.OcmKind
KINDS = ["LOCAL_HOST", "LOCAL_DEVICE", "REMOTE_HOST", "REMOTE_DEVICE"]


def jcfg(**kw):
    d = dict(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
             chunk_bytes=64 << 10, heartbeat_s=0.2, lease_s=30.0)
    d.update(kw)
    return jocm.OcmConfig(**d)


def tcfg(**kw):
    d = dict(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
             chunk_bytes=64 << 10, heartbeat_s=0.2, lease_s=30.0,
             dcn_stripe_min_bytes=256 << 10)
    d.update(kw)
    return tocm.OcmConfig(**d)


def entries(cl):
    return [TEntry(r, "127.0.0.1", d.port) for r, d in enumerate(cl.daemons)]


class Clients:
    """Port clients of one JAX cluster, closed at the end of the test."""

    def __init__(self):
        self.open = []

    def __call__(self, cl, rank, config=None, **kw):
        c = TClient(entries(cl), rank, config=config or tcfg(), **kw)
        self.open.append(c)
        return c


@pytest.fixture
def tclient():
    c = Clients()
    yield c
    for client in c.open:
        client.close()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _key(h):
    return (h.alloc_id, h.kind.value, h.rank, h.device_index, h.extent.offset,
            h.nbytes)


def live(cl):
    return sum(d.registry.live_count() for d in cl.daemons)


def wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


# -- REMOTE_HOST --------------------------------------------------------------

SIZES = (4096, (1 << 20) + 4096, 100_000, 3 << 20)


def _host_sequence(client, kind, rng, out_cls):
    """alloc every size, put at an offset, get whole / at offsets / into a
    buffer, free; returns (handles, bytes read)."""
    hs, reads = [], []
    for n in SIZES:
        h = client.alloc(n, kind)
        data = rng.integers(0, 256, n - 100, dtype=np.uint8)
        client.put(h, data, 100)
        reads.append(_np(client.get(h, n - 100, 100)))
        reads.append(_np(client.get(h, 777, n // 3)))
        out = np.zeros(n, dtype=np.uint8)
        client.get_into(h, out_cls(out), 0)
        reads.append(out.copy())
        hs.append(h)
    keys = [_key(h) for h in hs]
    for h in hs:
        client.free(h)
    return keys, reads


def test_remote_host_handles_and_bytes_match_jax(tclient):
    with jax_cluster(2, config=jcfg()) as cl:
        want = _host_sequence(cl.client(0), J.REMOTE_HOST,
                              np.random.default_rng(5), lambda a: a)
        assert live(cl) == 0
    with jax_cluster(2, config=jcfg()) as cl:
        c = tclient(cl, 0)
        got = _host_sequence(c, T.REMOTE_HOST, np.random.default_rng(5),
                             torch.from_numpy)
        assert live(cl) == 0
        # 3 MiB is striped (256 KiB minimum per stripe) and chunked.
        assert c.transfers["put"] == len(SIZES)
        assert c.transfers["get"] == 3 * len(SIZES)
    assert got[0] == want[0]
    assert all(h[1] == "remote_host" and h[2] == 1 for h in got[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


def test_put_from_a_tensor_and_status(tclient):
    with jax_cluster(2, config=jcfg()) as cl:
        c = tclient(cl, 0)
        h = c.alloc(1 << 20, T.REMOTE_HOST)
        data = torch.arange(1 << 18, dtype=torch.int32)  # any dtype, as bytes
        c.put(h, data, 0)
        assert torch.equal(c.get(h, 1 << 20, 0).view(torch.int32), data)
        st = c.status(1)
        assert st["live_allocs"] == 1 and st["host_bytes_live"] >= 1 << 20
        assert c.status()["nnodes"] == 2 and c.nnodes == 2
        c.free(h)
        assert c.status(1)["live_allocs"] == 0


# -- typed errors -------------------------------------------------------------


def _error_cases(client, kind):
    """(what, exception class name, wire code) of each failing call."""
    h = client.alloc(16 << 10, kind)
    cases = {
        "put_past_end": lambda: client.put(h, np.zeros(8 << 10, np.uint8), 12 << 10),
        "get_past_end": lambda: client.get(h, 100, (16 << 10) - 50),
        "alloc_too_big": lambda: client.alloc(1 << 40, kind),
        "free_unknown": lambda: client.free(type(h)(**{
            **{f: getattr(h, f) for f in ("kind", "fabric", "nbytes", "rank",
                                          "device_index", "extent",
                                          "origin_rank")},
            "alloc_id": h.alloc_id + 1000})),
    }
    out = {}
    for what, fn in cases.items():
        try:
            fn()
            out[what] = None
        except Exception as e:  # noqa: BLE001 — compared by class name
            out[what] = (type(e).__name__, getattr(e, "code", None))
    # The connection survived the pipelined error: a clean round trip.
    data = np.arange(16 << 10, dtype=np.uint8)
    client.put(h, data, 0)
    np.testing.assert_array_equal(_np(client.get(h, 16 << 10, 0)), data)
    client.free(h)
    return out


def test_typed_errors_match_jax(tclient):
    with jax_cluster(2, config=jcfg(chunk_bytes=1024)) as cl:
        want = _error_cases(cl.client(0), J.REMOTE_HOST)
    with jax_cluster(2, config=jcfg(chunk_bytes=1024)) as cl:
        got = _error_cases(tclient(cl, 0, tcfg(chunk_bytes=1024)), T.REMOTE_HOST)
        assert live(cl) == 0
    assert got == want
    assert got["put_past_end"] == ("OcmRemoteError", int(ErrCode.BOUNDS))
    assert got["free_unknown"] == ("OcmRemoteError", int(ErrCode.BAD_ALLOC_ID))
    assert all(v is not None for v in got.values())


def test_unreachable_seed_ladder_raises_connect_error():
    from oncilla_tpu_torch.runtime.cluster import free_ports

    dead = [TEntry(r, "127.0.0.1", p) for r, p in enumerate(free_ports(2))]
    t0 = time.monotonic()
    with pytest.raises(tocm.OcmConnectError, match="no seed daemon"):
        TClient(dead, 0, config=tcfg(connect_retries=2, connect_backoff_s=0.01))
    assert time.monotonic() - t0 < 10


def test_connect_ladder_falls_over_to_a_live_seed(tclient):
    from oncilla_tpu_torch.runtime.cluster import free_ports

    with jax_cluster(2, config=jcfg()) as cl:
        ents = entries(cl)
        ents[0] = TEntry(0, "127.0.0.1", free_ports(1)[0])  # own seed down
        c = TClient(ents, 0, config=tcfg(connect_retries=1,
                                         connect_backoff_s=0.01))
        tclient.open.append(c)
        assert c.rank == 1  # adopted the live daemon's rank


# -- leases -------------------------------------------------------------------


def test_heartbeats_keep_leases_and_silence_is_reaped(tclient):
    # Ten beats a lease, so a loaded test host cannot starve one out.
    with jax_cluster(2, config=jcfg(lease_s=1.0, heartbeat_s=0.1)) as cl:
        beating = tclient(cl, 0, tcfg(lease_s=1.0, heartbeat_s=0.1))
        h = beating.alloc(4096, T.REMOTE_HOST)
        time.sleep(2.5)  # more than two lease periods
        assert cl.daemons[1].registry.live_count() == 1
        beating.put(h, np.full(4096, 7, np.uint8), 0)
        # An app that never beats, at rank 1 (app identity is (pid, rank)).
        silent = tclient(cl, 1, tcfg(lease_s=1.0), heartbeat=False)
        h2 = silent.alloc(4096, T.REMOTE_HOST)
        owner = cl.daemons[h2.rank]
        assert wait_until(lambda: owner.registry.live_count() == (
            1 if h2.rank == 1 else 0), timeout=5.0)
        with pytest.raises(tocm.OcmRemoteError):
            silent.get(h2, 16, 0)  # reaped
        beating.free(h)


def test_disconnect_reclaims_at_once(tclient):
    with jax_cluster(3, config=jcfg(lease_s=300.0)) as cl:
        c = TClient(entries(cl), 0, config=tcfg(lease_s=300.0), heartbeat=False)
        hs = [c.alloc(4096, T.REMOTE_HOST) for _ in range(3)]
        assert live(cl) == 3 and any(h.rank != 0 for h in hs)
        c.close()
        assert wait_until(lambda: live(cl) == 0)


# -- ocm_init through a nodefile ----------------------------------------------


def test_ocm_init_attaches_via_nodefile(tmp_path, rng):
    with jax_cluster(2, config=jcfg()) as cl:
        nf = tmp_path / "nodefile"
        nf.write_text("".join(f"{r} 127.0.0.1 {d.port}\n"
                              for r, d in enumerate(cl.daemons)))
        cfg = tcfg(nodefile=str(nf), rank=0)
        ctx = tocm.ocm_init(cfg, device="cpu")
        h = ctx.alloc(32 << 10, T.REMOTE_HOST)
        assert h.rank == 1 and h.daemon_owned and h.is_remote
        data = rng.integers(0, 256, 32 << 10, dtype=np.uint8)
        ctx.put(h, data)
        np.testing.assert_array_equal(_np(ctx.get(h)), data)
        out = torch.zeros(1000, dtype=torch.uint8)
        assert ctx.get(h, offset=5, out=out) is out
        np.testing.assert_array_equal(out.numpy(), data[5:1005])
        assert ctx.status(1)["live_allocs"] == 1
        tocm.ocm_tini(ctx)  # frees the handle and detaches
        assert live(cl) == 0
        with pytest.raises(tocm.OcmInvalidHandle):
            ctx.get(h)  # use after tini


def test_nodefile_layouts_and_errors(tmp_path):
    from oncilla_tpu.runtime.membership import parse_nodefile as jparse
    from oncilla_tpu_torch.runtime.membership import parse_nodefile as tparse

    good = tmp_path / "good"
    good.write_text("# comment\n1 hostb 10.0.0.2 17981 67981\n"
                    "0 hosta 17980   # trailing\n2 hostc 10.0.0.3 17982\n")
    assert [(e.rank, e.host, e.port, e.addr, e.connect_host) for e in tparse(str(good))] \
        == [(e.rank, e.host, e.port, e.addr, e.connect_host) for e in jparse(str(good))]
    for bad in ("0 a\n", "0 a b c d e\n", "0 a 1\n2 b 2\n", "x a 1\n"):
        p = tmp_path / "bad"
        p.write_text(bad)
        errs = []
        for parse in (jparse, tparse):
            with pytest.raises(Exception) as ei:
                parse(str(p))
            errs.append((type(ei.value).__name__, str(ei.value)))
        assert errs[0] == errs[1]


# -- single-node demotion -----------------------------------------------------


def _demotion(ctx, kinds, rng):
    out = []
    for kind in kinds:
        h = ctx.alloc(8192, kind)
        data = rng.integers(0, 256, 8192, dtype=np.uint8)
        ctx.put(h, data)
        out.append((h.kind.value, h.daemon_owned, h.rank, h.device_index,
                    h.extent.offset, _np(ctx.get(h, 4000, 100))))
        ctx.free(h)
    return out


def test_single_node_demotion_routes_daemon_owned(tclient):
    cfg = dict(device_arena_bytes=256 << 10)
    with jax_cluster(1, config=jcfg(**cfg)) as cl:
        jplane = JPlane(config=jcfg(**cfg), devices_per_rank=8)
        jctx = jocm.Ocm(config=jcfg(**cfg), remote=cl.client(0, ici_plane=jplane))
        want = _demotion(jctx, [J.REMOTE_HOST, J.REMOTE_DEVICE],
                         np.random.default_rng(9))
    with jax_cluster(1, config=jcfg(**cfg)) as cl:
        tplane = TPlane(tcfg(**cfg), mesh=["cpu"] * 8, devices_per_rank=8)
        ctx = tocm.Ocm(tcfg(**cfg), remote=tclient(cl, 0, tcfg(**cfg),
                                                   ici_plane=tplane), device="cpu")
        got = _demotion(ctx, [T.REMOTE_HOST, T.REMOTE_DEVICE],
                        np.random.default_rng(9))
        # The context's own arenas were never touched.
        assert ctx.host_arena.allocator.bytes_live == 0
        assert ctx.device_arenas[0].allocator.bytes_live == 0
        assert int(ctx.host_arena.buffer.count_nonzero()) == 0
        assert live(cl) == 0
    assert [g[0] for g in got] == ["local_host", "local_device"]
    assert all(g[1] for g in got)
    for a, b in zip(got, want):
        assert a[:5] == b[:5]
        np.testing.assert_array_equal(a[5], b[5])


# -- REMOTE_DEVICE on a plane, and the relay ----------------------------------


def test_remote_device_copy_rides_the_plane_and_relay_serves_planeless(tclient, rng):
    row = 1 << 20
    with jax_cluster(2, config=jcfg(device_arena_bytes=row), ndevices=2) as cl:
        plane = TPlane(tcfg(device_arena_bytes=row), mesh=["cpu"] * 4,
                       devices_per_rank=2)
        ctx = tocm.Ocm(tcfg(), remote=tclient(cl, 0, ici_plane=plane), device="cpu")
        a = ctx.alloc(64 << 10, T.REMOTE_DEVICE)
        b = ctx.alloc(64 << 10, T.REMOTE_DEVICE)
        assert a.rank == b.rank == 1 and a.daemon_owned
        assert not _np(ctx.get(a)).any()  # scrubbed
        data = rng.integers(0, 256, 64 << 10, dtype=np.uint8)
        ctx.put(a, data)
        gets = plane.stats["gets"]
        ctx.copy(b, a)
        assert plane.stats["gets"] == gets and plane.stats["ici_copies"] == 1
        np.testing.assert_array_equal(_np(ctx.get(b)), data)
        # A plane-less client (its own app id) reaches b through the relay.
        other = tclient(cl, 1, app_id=123456)
        piece = rng.integers(0, 256, 5000, dtype=np.uint8)
        other.put(b, piece, 1000)
        np.testing.assert_array_equal(_np(other.get(b, 5000, 1000)), piece)
        want = data.copy()
        want[1000:6000] = piece
        np.testing.assert_array_equal(_np(ctx.get(b)), want)  # controller view
        assert ctx._remote._plane_server.served["PLANE_PUT"] == 1
        with pytest.raises(tocm.OcmRemoteError):
            other.get(b, 100, (64 << 10) - 10)  # bounds, relayed back typed
        ctx.free(a)
        ctx.free(b)
        assert live(cl) == 0


# -- differential fuzz --------------------------------------------------------


def _fuzz(m, ctx, seed: int, steps: int = 90) -> list:
    """A seeded op stream over every kind; returns the trace of results
    (bytes, handle keys, exception class names)."""
    rng = np.random.default_rng(seed)
    kinds = [m.OcmKind[k] for k in KINDS]
    live_h: list = []
    trace = []

    def do(fn):
        try:
            r = fn()
            return ("ok", None if r is None else _np(r).tobytes())
        except m.OcmError as e:
            return ("err", type(e).__name__)

    for _ in range(steps):
        op = rng.choice(["alloc", "free", "put", "get", "copy", "bad"])
        if op == "alloc" or not live_h:
            if len(live_h) >= 10:
                continue
            nb = int(rng.integers(1, 17)) * 4096 - int(rng.integers(0, 2)) * 100
            kind = kinds[int(rng.integers(len(kinds)))]
            h = ctx.alloc(nb, kind)
            live_h.append(h)
            trace.append(("alloc", _key(h)))
        elif op == "free":
            h = live_h.pop(int(rng.integers(len(live_h))))
            ctx.free(h)
            trace.append(("free", do(lambda: ctx.free(h))))  # double free
        elif op == "put":
            h = live_h[int(rng.integers(len(live_h)))]
            off = int(rng.integers(0, h.nbytes))
            n = int(rng.integers(1, h.nbytes - off + 1))
            data = rng.integers(0, 256, n, dtype=np.uint8)
            trace.append(("put", do(lambda: ctx.put(h, data, offset=off))))
        elif op == "get":
            h = live_h[int(rng.integers(len(live_h)))]
            off = int(rng.integers(0, h.nbytes))
            n = int(rng.integers(1, h.nbytes - off + 1))
            trace.append(("get", do(lambda: ctx.get(h, n, offset=off))))
        elif op == "copy":
            hs = live_h[int(rng.integers(len(live_h)))]
            hd = live_h[int(rng.integers(len(live_h)))]
            if hd is hs:
                continue
            n = int(rng.integers(1, min(hs.nbytes, hd.nbytes) + 1))
            trace.append(("copy", do(lambda: ctx.copy(hd, hs, nbytes=n))))
        else:  # an op wholly out of bounds: refused everywhere, nothing lands
            h = live_h[int(rng.integers(len(live_h)))]
            which = int(rng.integers(2))
            trace.append(("bad", do(
                (lambda: ctx.put(h, np.ones(8, np.uint8), offset=h.nbytes))
                if which else (lambda: ctx.get(h, 8, offset=h.nbytes + 4)))))
    for h in live_h:
        trace.append(("final", do(lambda: ctx.get(h))))
        ctx.free(h)
    return trace


@pytest.mark.parametrize("seed", [0, 1])
def test_differential_fuzz_against_the_jax_ocm(tclient, seed):
    c = dict(device_arena_bytes=1 << 20)
    with jax_cluster(2, config=jcfg(**c), ndevices=2) as cl:
        jplane = JPlane(config=jcfg(**c), devices_per_rank=2)
        jctx = jocm.Ocm(config=jcfg(**c), remote=cl.client(0, ici_plane=jplane))
        want = _fuzz(jocm, jctx, seed)
        jctx.tini()
    with jax_cluster(2, config=jcfg(**c), ndevices=2) as cl:
        tplane = TPlane(tcfg(**c), mesh=["cpu"] * 8, devices_per_rank=2)
        ctx = tocm.Ocm(tcfg(**c), remote=tclient(cl, 0, tcfg(**c),
                                                  ici_plane=tplane), device="cpu")
        got = _fuzz(tocm, ctx, seed)
        ctx.tini()
        assert live(cl) == 0
    assert len(got) == len(want)
    kinds_seen = {k[1][1] for k in got if k[0] == "alloc"}
    assert kinds_seen == {k.lower() for k in KINDS}
    assert any(k[0] == "bad" for k in got)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"step {i}: port {a[:1]} {str(a[1])[:120]} vs jax {str(b[1])[:120]}"


# -- threads ------------------------------------------------------------------


def test_one_client_shared_by_many_threads(tclient):
    """More workers than cores on one client, with a short switch
    interval: every transfer's bytes are right and none is lost from the
    client's counts."""
    workers, rounds = 12, 6
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with jax_cluster(2, config=jcfg(host_arena_bytes=32 << 20)) as cl:
            c = tclient(cl, 0, tcfg(chunk_bytes=16 << 10))
            errors = []

            def work(i):
                try:
                    rng = np.random.default_rng(i)
                    h = c.alloc(96 << 10, T.REMOTE_HOST)
                    for _ in range(rounds):
                        data = rng.integers(0, 256, 96 << 10, dtype=np.uint8)
                        c.put(h, data, 0)
                        out = np.empty(96 << 10, np.uint8)
                        c.get_into(h, out, 0)
                        assert np.array_equal(out, data)
                    c.free(h)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            ts = [threading.Thread(target=work, args=(i,)) for i in range(workers)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
            assert not errors, errors
            assert c.transfers["put"] == c.transfers["get"] == workers * rounds
            assert live(cl) == 0
    finally:
        sys.setswitchinterval(old)


# -- staging windows ----------------------------------------------------------


def _windows(m, ctx, rng) -> list:
    """The staging-window cases of tests/test_cluster.py:333-540 as one
    trace: localbuf / push / pull, asymmetric windows at offsets, and
    ``ocm_copy_onesided`` with ``local=None``."""
    out = []

    def do(fn):
        try:
            r = fn()
            return ("ok", None if r is None else _np(r).tobytes())
        except m.OcmError as e:
            return ("err", type(e).__name__)

    h = ctx.alloc(64 << 10, m.OcmKind.REMOTE_HOST)
    buf = ctx.localbuf(h)
    out.append(("same_window", ctx.localbuf(h) is buf, int(_np(buf).size)))
    data = rng.integers(0, 256, 64 << 10, dtype=np.uint8)
    buf[:] = torch.from_numpy(data) if m is tocm else data
    ctx.push(h)
    out.append(("pushed", _np(ctx.get(h)).tobytes()))
    ctx.put(h, rng.integers(0, 256, 64 << 10, dtype=np.uint8))
    ctx.pull(h)
    out.append(("pulled", _np(buf).tobytes()))
    buf[:1024] = 7
    m.ocm_copy_onesided(ctx, h, op="write")
    out.append(("onesided", _np(m.ocm_copy_onesided(ctx, h, op="read")).tobytes()))
    out.append(("onesided_at", _np(m.ocm_copy_onesided(ctx, h, op="read",
                                                       offset=4096)).tobytes()))
    for fn in (lambda: ctx.push(h, nbytes=1 << 17), lambda: ctx.push(h, offset=70000),
               lambda: ctx.pull(h, nbytes=100, offset=(64 << 10) - 90),
               lambda: ctx.localbuf(h, nbytes=1 << 10)):
        out.append(("bounds", do(fn)))
    ctx.free(h)
    out.append(("freed", do(lambda: ctx.localbuf(h))))

    w = ctx.alloc(64 << 10, m.OcmKind.REMOTE_HOST, local_nbytes=4 << 10)
    win = ctx.localbuf(w)
    out.append(("window", int(_np(win).size), m.ocm_remote_sz(w)))
    for off in (0, 4 << 10, 60 << 10, (63 << 10) + 100):
        win[:] = 17 + off % 200
        ctx.push(w, offset=off)
    out.append(("slid", _np(ctx.get(w)).tobytes()))
    win[:] = 0
    ctx.pull(w, nbytes=1 << 10, offset=60 << 10, local_offset=2 << 10)
    out.append(("pulled_at", _np(win).tobytes()))
    out.append(("window_read", _np(m.ocm_copy_onesided(ctx, w, op="read",
                                                       offset=8 << 10)).tobytes()))
    for fn in (lambda: ctx.push(w, nbytes=8 << 10),
               lambda: ctx.push(w, nbytes=4 << 10, offset=(63 << 10) + 100),
               lambda: ctx.pull(w, nbytes=1 << 10, local_offset=3584),
               lambda: ctx.alloc(4096, m.OcmKind.LOCAL_HOST, local_nbytes=1024),
               lambda: ctx.alloc(4096, m.OcmKind.REMOTE_HOST, local_nbytes=8192)):
        out.append(("refused", do(fn)))
    ctx.free(w)
    v = ctx.alloc(16 << 10, m.OcmKind.REMOTE_HOST)
    out.append(("sized", int(_np(ctx.localbuf(v, nbytes=2 << 10)).size)))
    out.append(("resize", do(lambda: ctx.localbuf(v, nbytes=4 << 10))))
    lh = ctx.alloc(4096, m.OcmKind.LOCAL_HOST)
    out.append(("local", do(lambda: ctx.push(lh)), do(lambda: ctx.localbuf(lh, nbytes=1024))))
    ctx.free(v)
    ctx.free(lh)
    return out


def test_staging_windows_match_jax(tclient):
    with jax_cluster(2, config=jcfg()) as cl:
        want = _windows(jocm, cl.context(0), np.random.default_rng(4))
    with jax_cluster(2, config=jcfg()) as cl:
        ctx = tocm.Ocm(tcfg(), remote=tclient(cl, 0), device="cpu")
        got = _windows(tocm, ctx, np.random.default_rng(4))
        assert live(cl) == 0
    assert [g[0] for g in got] == [w[0] for w in want]
    for a, b in zip(got, want):
        assert a == b, a[0]


# -- the connection pool ------------------------------------------------------


def test_peer_pool_leases_reuses_discards_and_closes():
    from oncilla_tpu_torch.runtime.pool import PeerPool
    from oncilla_tpu_torch.runtime.protocol import Message, MsgType

    with jax_cluster(1, config=jcfg()) as cl:
        host, port = "127.0.0.1", cl.daemons[0].port
        pool = PeerPool(per_peer=2)
        a = pool.lease(host, port)
        b = pool.lease(host, port)
        assert a is not b  # leased exclusively: a second lease dials anew
        pool.release(host, port, a)
        again = pool.lease(host, port)
        assert again is a  # an idle cached one comes back
        pool.release(host, port, again)
        pool.discard(host, port, b)  # broken: closed, never leased again
        stripes = pool.lease_set(host, port, 2)
        assert b.dead and b not in stripes and len(stripes) == 2
        for e in stripes:
            pool.release(host, port, e)
        # A typed ERROR reply keeps the connection; it is still in sync.
        with pytest.raises(tocm.OcmRemoteError):
            pool.request(host, port, Message(MsgType.REQ_FREE,
                                             {"alloc_id": 12345, "rank": 0}))
        assert pool.request(host, port, Message(MsgType.STATUS, {})).fields["rank"] == 0
        assert pool.evict(host, port) == 2
        assert pool.request(host, port, Message(MsgType.STATUS, {})).type == MsgType.STATUS_OK
        pool.close()
        with pytest.raises(tocm.OcmConnectError, match="shut down"):
            pool.lease(host, port)
