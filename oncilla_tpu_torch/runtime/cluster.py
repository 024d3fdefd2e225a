"""The port's cluster launchers: daemons on loopback, in two forms.

- :class:`LocalCluster` / :func:`local_cluster` run daemons as
  subprocesses, the subprocess form of ``oncilla_tpu/runtime/cluster.py``.
  ``daemon="native"`` (the default) builds and runs the port's copy of the
  native daemon (``runtime/native/``, the ``oncillamemd`` of the JAX
  package: its code line for line, only comments that named the
  reference's own paths reworded); ``daemon="python"`` runs the port's
  Python daemon, ``python -m oncilla_tpu_torch.runtime.daemon <nodefile>
  --rank r``, which also serves replicas, failover, leader election, hash
  placement, QoS, mux, the shm fabric, elastic membership, snapshots and
  the FROZEN tier; its ``OCM_*`` knobs ride ``env``.
- :class:`InProcessCluster` / :func:`inprocess_cluster` hold N
  :class:`~.daemon.Daemon` objects in this process, the form of the JAX
  package's ``LocalCluster``, with ``kill(rank)`` and ``restart(rank)``.

Apps reach every daemon over the wire, so one daemon and one wire serve
both packages.

    with local_cluster(2, ndevices=2, device_arena_bytes=row) as cl:
        ctx = cl.context(0, ici_plane=plane)   # or ocm_init(OcmConfig(
        ...                                    #   nodefile=cl.nodefile, rank=0))
    with local_cluster(3, daemon="python",
                       env={"OCM_REPLICAS": "2"}) as cl: ...

:func:`build_daemon` needs a C++ compiler (``g++``, ``c++`` or
``clang++``); without one it raises, and nothing falls back.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

from oncilla_tpu_torch.core.errors import OcmConnectError, OcmError
from oncilla_tpu_torch.runtime.membership import NodeEntry
from oncilla_tpu_torch.runtime.protocol import Message, MsgType, request

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "oncilla_tpu_torch"
BINARY = BUILD_DIR / "oncillamemd"
_UNITS = ("daemon.cc", "protocol.cc", "obs.cc")
_HEADERS = ("protocol.hh", "obs.hh", "arena.hh", "net.hh", "membership.hh")
# The flag set of the JAX package's direct build (native.py:114-119).
_CXXFLAGS = ("-std=c++17", "-Wall", "-Wextra", "-pthread", "-O2")
# Rank 0's placement policy, and how long the daemons get to join.
_POLICY = "capacity"
_START_TIMEOUT_S = 30.0
# A Python daemon imports the package (and so torch) before it listens:
# a few seconds each, all ranks at once.
_PY_START_TIMEOUT_S = 90.0
_REPO = Path(__file__).resolve().parents[2]


def _fingerprint(cxx: str) -> str:
    """A hash of the sources, the headers, the compiler and the flags."""
    h = hashlib.sha256()
    for name in (*_UNITS, *_HEADERS):
        h.update(name.encode() + b"\0" + (NATIVE_DIR / name).read_bytes() + b"\0")
    h.update(" ".join((cxx, *_CXXFLAGS)).encode())
    return h.hexdigest()


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise OcmError("cannot build the daemon: no C++ compiler (g++, c++ or "
                   "clang++) on PATH")


def build_daemon() -> Path:
    """Compile ``runtime/native/`` into ``build/oncilla_tpu_torch/
    oncillamemd`` unless the binary there was built from these exact
    sources (its ``.srchash`` stamp). The three units compile at once;
    concurrent callers (test workers) take turns on a lock file, so one
    compiles and the rest find its binary, and binary and stamp are
    installed by ``os.replace`` of temporary files, so no reader sees a
    partial file.
    Raises with the compiler's output when the build fails."""
    cxx = _compiler()
    fp = _fingerprint(cxx)
    stamp = BINARY.with_name(BINARY.name + ".srchash")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # One builder at a time: the others wait here, then find the binary.
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if BINARY.exists() and stamp.read_text().strip() == fp:
                return BINARY
        except OSError:
            pass
        _compile(cxx, fp, stamp)
    return BINARY


def _compile(cxx: str, fp: str, stamp: Path) -> None:
    """Compile and link in a work directory, then install the binary and
    its stamp."""
    work = Path(tempfile.mkdtemp(prefix="oncillamemd-", dir=BUILD_DIR))
    try:
        procs = []
        for unit in _UNITS:
            obj = work / (unit + ".o")
            procs.append((unit, obj, subprocess.Popen(
                [cxx, *_CXXFLAGS, "-c", str(NATIVE_DIR / unit), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for unit, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{unit}: exit {proc.returncode}\n{log[-4000:]}")
        if failed:
            raise OcmError("daemon build failed:\n" + "\n".join(failed))
        out = work / "oncillamemd"
        link = subprocess.run(
            [cxx, *_CXXFLAGS, *(str(o) for _, o, _ in procs), "-o", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise OcmError(f"daemon link failed:\n{link.stdout[-4000:]}")
        os.replace(out, BINARY)
        (work / "stamp").write_text(fp + "\n")
        os.replace(work / "stamp", stamp)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def free_ports(n: int) -> list[int]:
    """``n`` distinct loopback ports that were free a moment ago."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def daemon_status(entry: NodeEntry, timeout: float = 5.0) -> dict:
    """One STATUS exchange with a daemon, on a connection of its own."""
    with socket.create_connection((entry.connect_host, entry.port),
                                  timeout=timeout) as s:
        return dict(request(s, Message(MsgType.STATUS, {})).fields)


def _per_rank(value, n: int) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


class LocalCluster:
    """``n`` daemons on loopback ports as subprocesses, with per-rank client
    and context factories. ``daemon`` picks the native daemon's copy
    (default) or the port's Python daemon. ``host_arena_bytes`` may be one
    size or one per rank; the daemons' lease is ``lease_s``, by default
    the config's, and their reaper ticks every ``heartbeat_s`` (the
    daemon's 5 s default). ``env`` adds ``OCM_*`` knobs to the daemons'
    environment. Daemon output goes to ``<workdir>/daemon<rank>.log``."""

    def __init__(self, n: int, *, ndevices: int = 1,
                 host_arena_bytes=64 << 20, device_arena_bytes: int = 64 << 20,
                 lease_s: float | None = None, heartbeat_s: float | None = None,
                 config=None, daemon: str = "native",
                 env: dict | None = None):
        from oncilla_tpu_torch.utils.config import OcmConfig

        if daemon not in ("native", "python"):
            raise ValueError(f"daemon must be 'native' or 'python' (got {daemon!r})")
        if daemon == "native":
            prog = [str(build_daemon())]
            start_timeout = _START_TIMEOUT_S
        else:
            prog = [sys.executable, "-m", "oncilla_tpu_torch.runtime.daemon"]
            start_timeout = _PY_START_TIMEOUT_S
        self.config = config or OcmConfig()
        if lease_s is None:
            lease_s = self.config.lease_s
        self.workdir = Path(tempfile.mkdtemp(prefix="ocm-cluster-"))
        self.entries = [NodeEntry(r, "127.0.0.1", p)
                        for r, p in enumerate(free_ports(n))]
        self.nodefile = str(self.workdir / "nodefile")
        Path(self.nodefile).write_text("".join(
            f"{e.rank} {e.host} {e.port}\n" for e in self.entries))
        self.procs: list[subprocess.Popen] = []
        self.clients: list = []
        host_bytes = _per_rank(host_arena_bytes, n)
        proc_env = dict(os.environ)
        proc_env.update(env or {})
        if daemon == "python":
            proc_env["PYTHONPATH"] = os.pathsep.join(
                p for p in (str(_REPO), proc_env.get("PYTHONPATH")) if p)
        try:
            # Rank 0 first: the others join it with ADD_NODE.
            for r in range(n):
                if daemon == "native":
                    args = ["--nodefile", self.nodefile, "--rank", str(r)]
                else:
                    args = [self.nodefile, "--rank", str(r)]
                cmd = [*prog, *args,
                       "--policy", _POLICY, "--ndevices", str(ndevices),
                       "--host-arena-bytes", str(host_bytes[r]),
                       "--device-arena-bytes", str(device_arena_bytes),
                       "--lease-s", str(lease_s)]
                if heartbeat_s is not None:
                    cmd += ["--heartbeat-s", str(heartbeat_s)]
                with open(self.workdir / f"daemon{r}.log", "wb") as log:
                    self.procs.append(subprocess.Popen(
                        cmd, stdout=log, stderr=subprocess.STDOUT,
                        stdin=subprocess.DEVNULL, env=proc_env))
            self._wait_joined(start_timeout)
        except BaseException:
            self.stop()
            raise

    def _wait_joined(self, timeout_s: float) -> None:
        """Until rank 0's STATUS counts every node: an open listen socket
        does not mean the ADD_NODE joins have landed."""
        deadline = time.monotonic() + timeout_s
        want = len(self.entries)
        while True:
            for r, p in enumerate(self.procs):
                if p.poll() is not None:
                    raise OcmConnectError(
                        f"daemon rank {r} exited with {p.returncode}: "
                        f"{self.log(r)[-2000:]}")
            try:
                if daemon_status(self.entries[0], timeout=1.0)["nnodes"] == want:
                    return
            except (OSError, OcmError):
                pass  # still starting
            if time.monotonic() > deadline:
                raise OcmConnectError(
                    f"cluster of {want} did not join in {timeout_s} s")
            time.sleep(0.02)

    def log(self, rank: int) -> str:
        try:
            return (self.workdir / f"daemon{rank}.log").read_text(errors="replace")
        except OSError:
            return ""

    def status(self, rank: int) -> dict:
        return daemon_status(self.entries[rank])

    def client(self, rank: int, ici_plane=None, heartbeat: bool = True,
               config=None, app_id: int | None = None):
        """A daemon client of ``rank``, closed with the cluster."""
        from oncilla_tpu_torch.runtime.client import ControlPlaneClient

        c = ControlPlaneClient(self.entries, rank, config=config or self.config,
                               ici_plane=ici_plane, heartbeat=heartbeat,
                               app_id=app_id)
        self.clients.append(c)
        return c

    def context(self, rank: int, ici_plane=None, device=None, **kw):
        """An ``Ocm`` whose remote arms ride this cluster (``config=`` in
        ``kw`` configures both the client and the context: a mux, fabric
        or replica app)."""
        from oncilla_tpu_torch.core.context import Ocm

        return Ocm(config=kw.get("config") or self.config,
                   remote=self.client(rank, ici_plane=ici_plane, **kw),
                   device=device)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def kill(self, rank: int) -> None:
        """SIGKILL one daemon: the crashed-owner case (no snapshot, no
        drain)."""
        p = self.procs[rank]
        if p.poll() is None:
            p.kill()
            p.wait()

    def pids(self) -> list[int]:
        return [p.pid for p in self.procs]

    def stop(self) -> None:
        """Close the clients, then stop every daemon (SIGTERM, then SIGKILL
        after 5 s) and remove the work directory."""
        clients, self.clients = self.clients, []
        for c in clients:
            c.close()
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(self.workdir, ignore_errors=True)


@contextmanager
def local_cluster(n: int, **kw):
    c = LocalCluster(n, **kw)
    try:
        yield c
    finally:
        c.stop()


class InProcessCluster:
    """N port :class:`~.daemon.Daemon` objects on ephemeral loopback ports
    in this process, with per-rank client and context factories: the form
    of the JAX package's ``oncilla_tpu.runtime.cluster.LocalCluster``."""

    def __init__(self, nnodes: int, config=None, policy: str = "capacity",
                 ndevices: int = 1):
        from oncilla_tpu_torch.analysis.lockwatch import make_lock
        from oncilla_tpu_torch.runtime.daemon import Daemon
        from oncilla_tpu_torch.utils.config import OcmConfig

        self.config = config or OcmConfig()
        self._policy = policy
        self._ndevices = ndevices
        self.entries = [NodeEntry(r, "127.0.0.1", 0) for r in range(nnodes)]
        self.daemons: list = []
        # Rank 0 first, so ADD_NODE from the others lands.
        for r in range(nnodes):
            d = Daemon(r, self.entries, config=self.config, policy=policy,
                       ndevices=ndevices)
            d.start()
            self.daemons.append(d)
        self.clients: list = []
        self._lock = make_lock("cluster._lock")

    def client(self, rank: int, ici_plane=None, heartbeat: bool = True,
               config=None, app_id: int | None = None):
        from oncilla_tpu_torch.runtime.client import ControlPlaneClient

        c = ControlPlaneClient(self.entries, rank, config=config or self.config,
                               ici_plane=ici_plane, heartbeat=heartbeat,
                               app_id=app_id)
        with self._lock:
            self.clients.append(c)
        return c

    def context(self, rank: int, ici_plane=None, device=None, **kw):
        """An ``Ocm`` whose remote arms ride this cluster (``config=`` in
        ``kw`` configures both the client and the context: a mux, fabric
        or replica app)."""
        from oncilla_tpu_torch.core.context import Ocm

        return Ocm(config=kw.get("config") or self.config,
                   remote=self.client(rank, ici_plane=ici_plane, **kw),
                   device=device)

    def kill(self, rank: int) -> None:
        """Hard-kill one daemon (no snapshot, no drain). The object stays
        in ``daemons`` so :meth:`stop` (idempotent) still runs."""
        self.daemons[rank].kill()

    def restart(self, rank: int):
        """Hard-kill one daemon and start a fresh incarnation on the same
        address; only what the FROZEN tier put on disk survives."""
        from oncilla_tpu_torch.analysis import alloctrace
        from oncilla_tpu_torch.runtime.daemon import Daemon

        old = self.daemons[rank]
        old.kill()
        alloctrace.drop_scope(old._trace_scope)
        alloctrace.drop_scope(old.host_arena.allocator._trace_scope)
        d = Daemon(rank, self.entries, config=self.config,
                   policy=self._policy, ndevices=self._ndevices)
        d.start()
        self.daemons[rank] = d
        return d

    def stop(self) -> None:
        with self._lock:
            clients, self.clients = self.clients, []
        for c in clients:
            c.close()
        for d in self.daemons:
            d.stop()


@contextmanager
def inprocess_cluster(nnodes: int, **kw):
    c = InProcessCluster(nnodes, **kw)
    try:
        yield c
    finally:
        c.stop()
