"""ThreadSanitizer over the port's copy of the native daemon: the JAX
package's ``tests/test_native_tsan.py`` workload, unchanged, against the
port's ``oncillamemd_tsan`` (``runtime/cluster.build_daemon(tsan=True)``,
started by ``cluster.spawn``) with the port's client, context and flight
recorder. Two daemons, tracing and the flight recorder armed, serve
parallel clients' alloc/put/get/free, two striped ACK-coalesced putters,
two leavers whose allocations DISCONNECT reclaims and a STATUS poller.
Any ThreadSanitizer report in either daemon's log, or its exit code,
fails the test; so does any failed assertion of the workload."""

import socket
import threading
import time

import numpy as np
import pytest

import oncilla_tpu_torch as ocm
from oncilla_tpu_torch import OcmKind
from oncilla_tpu_torch.core.context import Ocm
from oncilla_tpu_torch.runtime import cluster
from oncilla_tpu_torch.runtime.client import ControlPlaneClient
from oncilla_tpu_torch.runtime.membership import NodeEntry
from oncilla_tpu_torch.runtime.protocol import Message, MsgType, request
from oncilla_tpu_torch.utils.config import OcmConfig

TSAN_EXIT = 66


@pytest.fixture(scope="module")
def tsan_binary():
    """Built once for the module and handed to every spawn; a failed build
    fails the test with the compiler's output."""
    return cluster.build_daemon(tsan=True)


def test_native_daemon_race_free_under_load(tsan_binary, tmp_path, rng):
    ports = cluster.free_ports(2)
    nodefile = tmp_path / "nodefile"
    nodefile.write_text("".join(f"{r} 127.0.0.1 {p}\n" for r, p in enumerate(ports)))
    snap_path = str(tmp_path / "r1.ocms")
    # Tracing and the flight recorder armed: the journal ring is appended
    # from the worker pool, the epoll loop and control threads while
    # striped traced puts are in flight. Clients trace by default, so
    # every request carries a 16-byte prefix through the frame reader's
    # trace phase.
    frdir = str(tmp_path / "fr")
    env = {
        "TSAN_OPTIONS": f"halt_on_error=0 exitcode={TSAN_EXIT}",
        "OCM_EVENTS": "1",
        "OCM_FLIGHTREC": frdir,
    }
    logs = [str(tmp_path / f"daemon{r}.log") for r in range(2)]
    procs = [
        cluster.spawn(
            str(nodefile), r, ndevices=2, tsan=True,
            host_arena_bytes=16 << 20, device_arena_bytes=8 << 20,
            heartbeat_s=0.2, lease_s=30.0, env=env,
            snapshot=snap_path if r == 1 else None,
            log_path=logs[r], binary=tsan_binary,
        )
        for r in range(2)
    ]
    entries = [NodeEntry(r, "127.0.0.1", p) for r, p in enumerate(ports)]
    cfg = OcmConfig(
        host_arena_bytes=16 << 20, device_arena_bytes=8 << 20,
        chunk_bytes=64 << 10, heartbeat_s=0.2,
    )
    try:
        # TSan slows start-up about tenfold: wait generously for both
        # accept loops and for rank 1 to join the master.
        deadline = time.time() + 60
        for e in entries:
            while time.time() < deadline:
                try:
                    socket.create_connection((e.host, e.port), timeout=0.5).close()
                    break
                except OSError:
                    time.sleep(0.1)
            else:
                pytest.fail("TSan daemon did not come up")
        while time.time() < deadline:
            try:
                s = socket.create_connection((entries[0].host, entries[0].port), 2.0)
                try:
                    if request(s, Message(MsgType.STATUS, {})).fields["nnodes"] >= 2:
                        break
                finally:
                    s.close()
            except (OSError, ocm.OcmProtocolError):
                pass
            time.sleep(0.1)
        else:
            pytest.fail("rank 1 never joined under TSan")

        # The concurrent workload: parallel clients on alloc/put/get/free
        # (where the daemon serves a connection a thread), with status
        # polls from another thread.
        errors = []

        def worker(seed):
            try:
                client = ControlPlaneClient(entries, 0, config=cfg)
                ctx = Ocm(config=cfg, remote=client, device="cpu")
                r = np.random.default_rng(seed)
                for i in range(8):
                    h = ctx.alloc(256 << 10, OcmKind.REMOTE_HOST)
                    data = r.integers(0, 256, 64 << 10, dtype=np.uint8)
                    ctx.put(h, data, offset=(i % 4) * (64 << 10))
                    out = ctx.get(h, 64 << 10, offset=(i % 4) * (64 << 10))
                    np.testing.assert_array_equal(np.asarray(out), data)
                    ctx.free(h)
                client.close()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        def striped_putter(seed):
            # Two of these at once: striped, ACK-coalesced puts are the
            # epoll core's hot path, with per-connection bulk-reply buffers
            # and burst state under concurrent stripe sets (each transfer
            # fans out over 2 leased sockets, every chunk but the stripe's
            # last carries FLAG_MORE, and the payloads land zero-copy in
            # the arena from the event loop).
            try:
                scfg = OcmConfig(
                    host_arena_bytes=16 << 20, device_arena_bytes=8 << 20,
                    chunk_bytes=64 << 10, heartbeat_s=0.2,
                    dcn_stripes=2, dcn_stripe_min_bytes=64 << 10,
                    # Off, so every put stays multi-chunk (the tuner would
                    # grow the chunk past the transfer and collapse the
                    # burst to one ACK).
                    dcn_adaptive=False,
                )
                client = ControlPlaneClient(entries, 0, config=scfg)
                ctx = Ocm(config=scfg, remote=client, device="cpu")
                r = np.random.default_rng(seed)
                # A size of this putter's own: the tracer's ring is
                # process-global, so the size tells this putter's
                # transfers from its sibling's and earlier tests'.
                nbytes = (1 << 20) + seed * 8192
                h = ctx.alloc(nbytes, OcmKind.REMOTE_HOST)
                data = r.integers(0, 256, nbytes, dtype=np.uint8)
                for _ in range(4):
                    ctx.put(h, data)
                    np.testing.assert_array_equal(np.asarray(ctx.get(h, nbytes)), data)
                recs = [t for t in client.tracer.transfers()
                        if t["op"] == "put" and t["bytes"] == nbytes]
                # Every put coalesced; at least one rode the full 2-way
                # stripe set (a lease set may degrade to fewer stripes
                # under pool contention rather than deadlock).
                assert recs and all(t["coalesced"] for t in recs), recs
                assert any(t["stripes"] == 2 for t in recs), recs
                ctx.free(h)
                client.close()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        def poller():
            try:
                client = ControlPlaneClient(entries, 0, config=cfg)
                for _ in range(20):
                    client.status()
                    client.status(rank=1)
                    time.sleep(0.02)
                client.close()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        def leaver():
            # Allocates, beats a few owner-bearing heartbeats, then
            # disconnects without freeing: the RECLAIM_APP fan-out racing
            # the other clients' traffic. At rank 1: the app identity is
            # (pid, rank) and every client here shares this process's pid,
            # so a rank-0 leaver would reclaim the rank-0 workers' live
            # allocations mid-flight.
            try:
                client = ControlPlaneClient(entries, 1, config=cfg)
                for _ in range(4):
                    # Left for DISCONNECT to reclaim: that is under test.
                    client.alloc(128 << 10, OcmKind.REMOTE_HOST)  # ocm-lint: allow[handle-leak-on-path]
                time.sleep(0.3)
                client.close()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
        threads += [threading.Thread(target=striped_putter, args=(100 + s,))
                    for s in range(2)]
        threads += [threading.Thread(target=leaver) for _ in range(2)]
        threads.append(threading.Thread(target=poller))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        hung = [t.name for t in threads if t.is_alive()]
        assert not hung, f"workers hung (daemon deadlock?): {hung}"
        assert not errors, errors

        # Every allocation freed or reclaimed at DISCONNECT: quiescent.
        probe = ControlPlaneClient(entries, 0, config=cfg, heartbeat=False)
        deadline = time.time() + 30
        while time.time() < deadline:
            if (probe.status()["live_allocs"] == 0
                    and probe.status(rank=1)["live_allocs"] == 0):
                break
            time.sleep(0.2)
        else:
            pytest.fail("daemons not quiescent after disconnect reclamation")
        probe.close()
    finally:
        for p in procs:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=30)
        except Exception:  # noqa: BLE001
            p.kill()
            p.wait()
    report = "\n".join(open(lp, "rb").read().decode(errors="replace") for lp in logs)
    assert "WARNING: ThreadSanitizer" not in report, report
    for p in procs:
        assert p.returncode != TSAN_EXIT, report
    # The armed flight recorder wrote parseable segments from both ranks
    # under the load (no CRC corruption, no holes).
    from oncilla_tpu_torch.obs import flightrec

    events, problems = flightrec.read_dir(frdir)
    assert events, "no flight-recorder evidence under TSan load"
    assert not [p for p in problems if p["kind"] != "truncated"], problems
    assert any(e.get("ev") == "span" and e.get("op") == "dcn_put_srv"
               for e in events)
