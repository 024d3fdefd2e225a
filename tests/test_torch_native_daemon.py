"""The port's own copy of the native daemon (``oncilla_tpu_torch/runtime/
native/``), built by ``runtime/cluster.build_daemon`` and run as processes
by ``runtime/cluster.local_cluster``, serving the port's client and the JAX
package's client alike: one wire, one daemon, equal bytes.

- The copy is the JAX package's sources, code line for line (only
  comments may differ); the build is cached
  on their hash and refuses to run without a compiler.
- The JAX client and the port's client get the same handles for the same
  sequence on fresh clusters, and read each other's writes.
- ``ocm_init`` through the cluster's nodefile, the typed errors the daemon
  sends, lease reaping and heartbeats, REMOTE_DEVICE handles on a CPU plane
  with the daemon's relay serving a plane-less client in a second process.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import oncilla_tpu as jocm
import oncilla_tpu_torch as tocm
from oncilla_tpu.core.arena import Extent as JExtent
from oncilla_tpu.core.handle import OcmAlloc as JAlloc
from oncilla_tpu.runtime.client import ControlPlaneClient as JClient
from oncilla_tpu.runtime.membership import NodeEntry as JEntry
from oncilla_tpu_torch.ops.ici import SpmdIciPlane as TPlane
from oncilla_tpu_torch.runtime import cluster
from oncilla_tpu_torch.runtime.protocol import ErrCode

ROOT = Path(__file__).resolve().parents[1]
T = tocm.OcmKind


def cfg(**kw):
    d = dict(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
             chunk_bytes=64 << 10, heartbeat_s=0.2, lease_s=30.0,
             dcn_stripe_min_bytes=256 << 10)
    d.update(kw)
    return tocm.OcmConfig(**d)


def jclient(cl, rank, **kw):
    c = JClient([JEntry(e.rank, e.host, e.port) for e in cl.entries], rank,
                config=jocm.OcmConfig(chunk_bytes=64 << 10, heartbeat_s=0.2), **kw)
    cl.clients.append(c)  # closed with the cluster
    return c


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _comment_lines(lines: list) -> set:
    """Indices of the lines that hold only comment: a ``//`` line, or a
    line of a ``/* ... */`` block that begins its line, where nothing but
    blanks follows the ``*/`` that closes the block. A line with code
    after its ``*/`` (``/*alloc=*/true);``, ``*/ x = 1;``) is code."""
    out, block = set(), False
    for i, line in enumerate(lines):
        s = line.strip()
        if not block and s.startswith(b"//"):
            out.add(i)
            continue
        if not (block or s.startswith(b"/*")):
            continue
        body = s if block else s[2:]
        end = body.find(b"*/")
        block = end < 0
        if block or not body[end + 2:].strip():
            out.add(i)
    return out


def test_sources_are_the_jax_packages_line_for_line():
    """The copy is the JAX package's daemon and C client library: the same
    files and lines, the code byte for byte; a line may differ only where
    both are comments (the copy's do not name the reference's own
    paths)."""
    jax_dir = ROOT / "oncilla_tpu" / "runtime" / "native"
    names = sorted(p.name for p in cluster.NATIVE_DIR.iterdir() if p.is_file())
    assert names == sorted({*cluster._UNITS, *cluster._HEADERS,
                            *cluster._LIB_UNITS, cluster._DEMO, "ocm_client.h"})
    assert {"libocm.cc", "ocm_client.h", "ocm_c_demo.c"} <= set(names)
    for name in names:
        ours = (cluster.NATIVE_DIR / name).read_bytes().splitlines()
        theirs = (jax_dir / name).read_bytes().splitlines()
        assert len(ours) == len(theirs), name
        comments = _comment_lines(ours) & _comment_lines(theirs)
        for i, (a, b) in enumerate(zip(ours, theirs)):
            if a != b:
                assert i in comments, f"{name}:{i + 1}"


def test_comment_lines_are_told_from_code():
    lines = [b"// a", b"int x; /* b */", b"  /* c", b"   * d", b"   */", b"x = *p;",
             b"/* e */", b"y = 1;", b"/** f **/", b"z = 2;",
             b"    /*alloc=*/true);", b"  /* g", b"  */ x = 1;", b"w = 3;"]
    assert _comment_lines(lines) == {0, 2, 3, 4, 6, 8, 11}


def test_build_is_cached_and_needs_a_compiler(monkeypatch):
    binary = cluster.build_daemon()
    assert binary == ROOT / "build" / "oncilla_tpu_torch" / "oncillamemd"
    mtime = binary.stat().st_mtime_ns
    t0 = time.perf_counter()
    assert cluster.build_daemon() == binary
    assert time.perf_counter() - t0 < 1.0 and binary.stat().st_mtime_ns == mtime
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(cluster.shutil, "which", lambda name: None)
    with pytest.raises(tocm.OcmError, match="no C\\+\\+ compiler"):
        cluster.build_daemon()


def _sequence(client, kind_cls, rng):
    hs, reads = [], []
    for n in (4096, 300_000, (2 << 20) + 4096):
        h = client.alloc(n, kind_cls.REMOTE_HOST)
        data = rng.integers(0, 256, n, dtype=np.uint8)
        client.put(h, data, 0)
        reads.append(_np(client.get(h, n - 10, 10)))
        hs.append((h.alloc_id, h.kind.value, h.rank, h.device_index,
                   h.extent.offset))
        client.free(h)
    return hs, reads


def test_both_clients_get_the_same_handles_and_bytes():
    with cluster.local_cluster(2) as cl:
        want = _sequence(jclient(cl, 0), jocm.OcmKind, np.random.default_rng(1))
    with cluster.local_cluster(2, config=cfg()) as cl:
        got = _sequence(cl.client(0), T, np.random.default_rng(1))
        assert cl.status(1)["live_allocs"] == 0
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


def test_each_client_reads_the_others_writes(rng):
    with cluster.local_cluster(2, config=cfg()) as cl:
        t = cl.client(0)
        j = jclient(cl, 1, app_id=999)
        h = t.alloc(1 << 20, T.REMOTE_HOST)
        jh = JAlloc(alloc_id=h.alloc_id, kind=jocm.OcmKind.REMOTE_HOST,
                    fabric=jocm.Fabric.DCN, nbytes=h.nbytes, rank=h.rank,
                    device_index=0, extent=JExtent(h.extent.offset, h.nbytes),
                    origin_rank=0)
        jh.owner_addr = h.owner_addr
        data = rng.integers(0, 256, 1 << 20, dtype=np.uint8)
        t.put(h, data, 0)
        np.testing.assert_array_equal(np.asarray(j.get(jh, 1 << 20, 0)), data)
        back = rng.integers(0, 256, 5000, dtype=np.uint8)
        j.put(jh, back, 12345)
        np.testing.assert_array_equal(_np(t.get(h, 5000, 12345)), back)
        t.free(h)


def test_ocm_init_through_the_cluster_nodefile_and_typed_errors(rng):
    with cluster.local_cluster(2, host_arena_bytes=[4 << 20, 16 << 20]) as cl:
        ctx = tocm.ocm_init(cfg(nodefile=cl.nodefile, rank=0), device="cpu")
        h = ctx.alloc((1 << 20) + 4096, T.REMOTE_HOST)
        assert h.rank == 1 and h.daemon_owned
        data = torch.from_numpy(rng.integers(0, 256, 1 << 20, dtype=np.uint8))
        ctx.put(h, data, offset=4096)
        out = torch.empty(1 << 20, dtype=torch.uint8)
        assert torch.equal(ctx.get(h, offset=4096, out=out), data)
        assert ctx.status(1)["live_allocs"] == 1
        errs = {}
        for what, fn in {
            "bounds": lambda: ctx.put(h, data, offset=8192),
            "too_big": lambda: ctx.alloc(32 << 20, T.REMOTE_HOST),
        }.items():
            with pytest.raises(tocm.OcmRemoteError) as ei:
                fn()
            errs[what] = ei.value.code
        assert errs == {"bounds": int(ErrCode.BOUNDS),
                        "too_big": int(ErrCode.PLACEMENT)}
        ctx.free(h)
        with pytest.raises(tocm.OcmInvalidHandle):
            ctx.free(h)
        assert cl.status(1)["live_allocs"] == 0
        left = ctx.alloc(4096, T.REMOTE_HOST)
        tocm.ocm_tini(ctx)  # frees what is live and sends DISCONNECT
        assert left.freed and cl.status(1)["live_allocs"] == 0


def test_daemon_reaps_silent_apps_and_keeps_beating_ones():
    # Ten beats a lease, so a loaded test host cannot starve one out.
    c = cfg(lease_s=1.0, heartbeat_s=0.1)
    with cluster.local_cluster(2, lease_s=1.0, heartbeat_s=0.1, config=c) as cl:
        beating = cl.client(0)
        h = beating.alloc(4096, T.REMOTE_HOST)
        silent = cl.client(0, heartbeat=False, app_id=4242)
        silent.alloc(4096, T.REMOTE_HOST)
        assert cl.status(1)["live_allocs"] == 2
        deadline = time.monotonic() + 6.0
        while cl.status(1)["live_allocs"] != 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(1.5)  # more lease periods: the beating app's stays
        assert cl.status(1)["live_allocs"] == 1
        beating.put(h, np.ones(4096, np.uint8), 0)
        beating.free(h)


PLANELESS = """
import sys
import numpy as np
import oncilla_tpu_torch as ocm
from oncilla_tpu_torch.core.arena import Extent
from oncilla_tpu_torch.runtime.client import ControlPlaneClient
from oncilla_tpu_torch.runtime.membership import parse_nodefile
nodefile, alloc_id, rank, dev, off, n = sys.argv[1], *map(int, sys.argv[2:])
c = ControlPlaneClient(parse_nodefile(nodefile), 1,
                       config=ocm.OcmConfig(chunk_bytes=64 << 10))
h = ocm.OcmAlloc(alloc_id=alloc_id, kind=ocm.OcmKind.REMOTE_DEVICE,
                 fabric=ocm.Fabric.ICI, nbytes=n, rank=rank, device_index=dev,
                 extent=Extent(off, n), origin_rank=1)
data = (np.arange(n) % 251).astype(np.uint8)
c.put(h, data, 0)
assert np.array_equal(c.get(h, n, 0).numpy(), data)
c.close()
print("relay-ok")
"""


def test_remote_device_on_a_plane_with_a_planeless_second_process(rng):
    row = 1 << 20
    with cluster.local_cluster(2, ndevices=2, device_arena_bytes=row) as cl:
        plane = TPlane(cfg(device_arena_bytes=row), mesh=["cpu"] * 4,
                       devices_per_rank=2)
        ctx = tocm.ocm_init(cfg(nodefile=cl.nodefile, rank=0,
                                device_arena_bytes=row),
                            device="cpu", ici_plane=plane)
        a, b = (ctx.alloc(256 << 10, T.REMOTE_DEVICE) for _ in range(2))
        assert a.rank == b.rank == 1 and not _np(ctx.get(a)).any()
        data = rng.integers(0, 256, 256 << 10, dtype=np.uint8)
        ctx.put(a, data)
        ctx.copy(b, a)
        assert plane.stats["ici_copies"] == 1
        np.testing.assert_array_equal(_np(ctx.get(b)), data)
        out = subprocess.run(
            [sys.executable, "-c", PLANELESS, cl.nodefile, str(b.alloc_id),
             str(b.rank), str(b.device_index), str(b.extent.offset), str(b.nbytes)],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert out.returncode == 0 and "relay-ok" in out.stdout, out.stderr[-2000:]
        want = (np.arange(256 << 10) % 251).astype(np.uint8)
        np.testing.assert_array_equal(_np(ctx.get(b)), want)  # controller view
        ctx.free(a)
        ctx.free(b)
        # The daemon's free-time scrub went through the plane relay.
        assert ctx._remote._plane_server.served["PLANE_SCRUB"] >= 1
        ctx.tini()
        assert all(cl.status(r)["live_allocs"] == 0 for r in range(2))
