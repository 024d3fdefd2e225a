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

The builds, each cached on a stamp of its own in ``build/oncilla_tpu_torch/``:
:func:`build_daemon` (``oncillamemd``; ``tsan=True``, ``oncillamemd_tsan``)
and :func:`build_lib` (the C client library ``libocm_tpu.so`` and its demo
app ``ocm_c_demo``, the JAX package's ``native.py`` ``build_lib``;
:func:`load_lib` binds it through ctypes, its handle :class:`OcmcHandle`). They
need a C++ compiler (``g++``, ``c++`` or ``clang++``), the library a C one
too (``gcc`` or ``cc``); without one they raise, and nothing falls back.
:func:`spawn` starts one native daemon process, its output in a file.
"""

from __future__ import annotations

import ctypes
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
_UNITS = ("daemon.cc", "protocol.cc", "obs.cc")
_HEADERS = ("protocol.hh", "obs.hh", "arena.hh", "net.hh", "membership.hh")
# The C client library (CMake targets ``ocm_tpu`` and ``ocm_c_demo``).
_LIB_UNITS = ("libocm.cc", "protocol.cc")
_DEMO = "ocm_c_demo.c"
# The flag sets of the JAX package's build (CMakeLists.txt, native.py:114-119):
# the daemon at -O2, or with ThreadSanitizer at -O1 in its place.
_CXXFLAGS = ("-std=c++17", "-Wall", "-Wextra", "-pthread")
_OPT = ("-O2",)
_TSAN = ("-fsanitize=thread", "-g", "-O1")
_LIB_FLAGS = (*_CXXFLAGS, *_OPT, "-fPIC")
_CFLAGS = ("-Wall", "-Wextra", "-O2")
# Rank 0's placement policy, and how long the daemons get to join.
_POLICY = "capacity"
_START_TIMEOUT_S = 30.0
# A Python daemon imports the package (and so torch) before it listens:
# a few seconds each, all ranks at once.
_PY_START_TIMEOUT_S = 90.0
_REPO = Path(__file__).resolve().parents[2]


def _fingerprint(names, tools) -> str:
    """A hash of the named sources and of every header beside them (a new
    header counts), with the compilers and flags in ``tools``."""
    h = hashlib.sha256()
    headers = {p.name for pat in ("*.hh", "*.h") for p in NATIVE_DIR.glob(pat)}
    for name in sorted({*names, *headers}):
        h.update(name.encode() + b"\0" + (NATIVE_DIR / name).read_bytes() + b"\0")
    h.update(" ".join(tools).encode())
    return h.hexdigest()


def _tool(what: str, env: str, names: tuple, kind: str) -> str:
    for cand in (os.environ.get(env), *names):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise OcmError(f"cannot build the {what}: no {kind} compiler "
                   f"({', '.join(names)}) on PATH")


def _compiler(what: str = "daemon") -> str:
    return _tool(what, "CXX", ("g++", "c++", "clang++"), "C++")


def _c_compiler(what: str = "library") -> str:
    return _tool(what, "CC", ("gcc", "cc"), "C")


def _stamp(target: Path) -> Path:
    return target.with_name(target.name + ".srchash")


def _cached_build(targets: tuple, fp: str, make) -> Path:
    """Return ``targets[0]`` once every target was built from exactly the
    inputs ``fp`` hashes (the first target's ``.srchash`` stamp), else
    build them with ``make(work_dir)``, which leaves each target's file
    under its name in ``work_dir``. Concurrent callers (test workers) take
    turns on a lock file, so one compiles and the rest find its files, and
    files and stamp are installed by ``os.replace`` of temporary files, so
    no reader sees a partial file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stamp = _stamp(targets[0])
    # One build at a time: the other callers wait here, then find the files.
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if (all(t.exists() for t in targets)
                    and stamp.read_text().strip() == fp):
                return targets[0]
        except OSError:
            pass
        work = Path(tempfile.mkdtemp(prefix=targets[0].name + "-", dir=BUILD_DIR))
        try:
            make(work)
            for t in targets:
                os.replace(work / t.name, t)
            (work / "stamp").write_text(fp + "\n")
            os.replace(work / "stamp", stamp)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return targets[0]


def _run(cmds: list, what: str) -> None:
    """Run the commands at once; raise with the output of each that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}: exit {proc.returncode}\n"
                          f"{log[-4000:]}")
    if failed:
        raise OcmError(f"{what} failed:\n" + "\n".join(failed))


def _compile_daemon(cxx: str, flags: tuple, work: Path, name: str) -> None:
    """The daemon's three units compiled at once, then linked."""
    objs = [work / (unit + ".o") for unit in _UNITS]
    _run([[cxx, *flags, "-c", str(NATIVE_DIR / unit), "-o", str(obj)]
          for unit, obj in zip(_UNITS, objs)], "daemon build")
    _run([[cxx, *flags, *map(str, objs), "-o", str(work / name)]],
         "daemon link")


def _compile_lib(cxx: str, cc: str, work: Path) -> None:
    """The library's units and the demo app compiled at once; then
    ``libocm_tpu.so``, and ``ocm_c_demo`` linked to it, finding it beside
    itself at run time."""
    objs = [work / (unit + ".o") for unit in _LIB_UNITS]
    demo = work / (_DEMO + ".o")
    _run([*([cxx, *_LIB_FLAGS, "-c", str(NATIVE_DIR / unit), "-o", str(obj)]
            for unit, obj in zip(_LIB_UNITS, objs)),
          [cc, *_CFLAGS, "-c", str(NATIVE_DIR / _DEMO), "-o", str(demo)]],
         "library build")
    _run([[cxx, *_LIB_FLAGS, "-shared", "-Wl,-soname,libocm_tpu.so",
           *map(str, objs), "-o", str(work / "libocm_tpu.so")]], "library link")
    _run([[cc, *_CFLAGS, str(demo), "-L", str(work), "-l:libocm_tpu.so",
           "-Wl,-rpath,$ORIGIN", "-o", str(work / "ocm_c_demo")]], "demo link")


def build_daemon(tsan: bool = False) -> Path:
    """Compile ``runtime/native/`` into ``build/oncilla_tpu_torch/
    oncillamemd`` (with ``tsan``, ``oncillamemd_tsan``: ThreadSanitizer at
    ``-g -O1``) unless the binary there was built from these exact sources,
    compiler and flags (its own ``.srchash`` stamp, so neither variant
    makes the other stale). Raises with the compiler's output when the
    build fails."""
    cxx = _compiler()
    flags = (*_CXXFLAGS, *(_TSAN if tsan else _OPT))
    name = "oncillamemd_tsan" if tsan else "oncillamemd"
    return _cached_build((BUILD_DIR / name,),
                         _fingerprint(_UNITS, (cxx, *flags)),
                         lambda work: _compile_daemon(cxx, flags, work, name))


def build_lib() -> Path:
    """Compile the C client library into ``build/oncilla_tpu_torch/
    libocm_tpu.so`` and its demo app into ``ocm_c_demo`` beside it, unless
    both were built from these exact sources, compilers and flags (the
    library's own ``.srchash`` stamp). Raises with the compiler's output
    when a compiler is missing or the build fails."""
    cxx, cc = _compiler("library"), _c_compiler()
    fp = _fingerprint((*_LIB_UNITS, _DEMO), (cxx, *_LIB_FLAGS, cc, *_CFLAGS))
    return _cached_build((BUILD_DIR / "libocm_tpu.so", BUILD_DIR / "ocm_c_demo"),
                         fp, lambda work: _compile_lib(cxx, cc, work))


class OcmcHandle(ctypes.Structure):
    """``ocm_client.h``'s ``ocmc_handle``, the library's handle."""
    _fields_ = [("alloc_id", ctypes.c_uint64), ("rank", ctypes.c_int64),
                ("device_index", ctypes.c_uint32), ("kind", ctypes.c_uint8),
                ("nbytes", ctypes.c_uint64), ("offset", ctypes.c_uint64),
                ("owner_host", ctypes.c_char * 256),
                ("owner_port", ctypes.c_uint32)]


def load_lib(path) -> ctypes.CDLL:
    """The C client library at ``path`` (:func:`build_lib`'s, or any build
    of ``ocm_client.h``) through ctypes, with the argument and result
    types of its calls; handles are :class:`OcmcHandle`."""
    lib = ctypes.CDLL(str(path))
    vp, u64, h = ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(OcmcHandle)
    i = ctypes.c_int
    for name, res, args in (
            ("ocmc_init", vp, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_double]),
            ("ocmc_tini", None, [vp]),
            ("ocmc_alloc", i, [vp, u64, ctypes.c_uint8, h]),
            ("ocmc_free", i, [vp, h]),
            ("ocmc_put", i, [vp, h, vp, u64, u64]),
            ("ocmc_get", i, [vp, h, vp, u64, u64]),
            ("ocmc_is_remote", i, [h]),
            ("ocmc_remote_sz", u64, [h]),
            ("ocmc_nnodes", ctypes.c_int64, [vp]),
            ("ocmc_last_error", ctypes.c_char_p, [vp]),
            ("ocmc_localbuf", vp, [vp, h]),
            ("ocmc_localbuf_sized", vp, [vp, h, u64]),
            ("ocmc_copy_onesided", i, [vp, h, i]),
            ("ocmc_copy", i, [vp, h, h, u64]),
            ("ocmc_copy_out", i, [vp, vp, h, u64, u64]),
            ("ocmc_copy_in", i, [vp, h, vp, u64, u64])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _flags(*, policy: str, ndevices: int, host_arena_bytes=None,
           device_arena_bytes=None, lease_s=None, heartbeat_s=None,
           snapshot=None) -> list:
    """The options both daemons take after their nodefile and rank."""
    args = ["--policy", policy, "--ndevices", str(ndevices)]
    for flag, value in (("--host-arena-bytes", host_arena_bytes),
                        ("--device-arena-bytes", device_arena_bytes),
                        ("--lease-s", lease_s), ("--heartbeat-s", heartbeat_s),
                        ("--snapshot", snapshot)):
        if value is not None:
            args += [flag, str(value)]
    return args


def _launch(cmd: list, env: dict | None, log_path: str | None) -> subprocess.Popen:
    """``cmd`` as a process with ``env`` over this one's environment, its
    output spooled to ``log_path`` when given: a pipe nobody drains fills
    at ~64 KiB and a chatty daemon (a ThreadSanitizer report) would block
    writing to it."""
    out = open(log_path, "wb") if log_path is not None else subprocess.PIPE
    try:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL,
                                env={**os.environ, **(env or {})})
    finally:
        if log_path is not None:
            out.close()  # the child keeps its own descriptor


def spawn(nodefile: str, rank: int, *, policy: str = _POLICY, ndevices: int = 1,
          host_arena_bytes: int | None = None,
          device_arena_bytes: int | None = None, lease_s: float | None = None,
          heartbeat_s: float | None = None, tsan: bool = False,
          snapshot: str | None = None, env: dict | None = None,
          log_path: str | None = None, binary: Path | None = None
          ) -> subprocess.Popen:
    """One process of the port's native daemon (``tsan``: its
    ThreadSanitizer build) at ``rank`` of ``nodefile``; ``binary`` (a
    build already made) skips the build's stamp check. Its output goes to
    ``log_path``, else to a pipe."""
    if binary is None:
        binary = build_daemon(tsan=tsan)
    return _launch([str(binary), "--nodefile", nodefile, "--rank", str(rank),
                    *_flags(policy=policy, ndevices=ndevices,
                            host_arena_bytes=host_arena_bytes,
                            device_arena_bytes=device_arena_bytes, lease_s=lease_s,
                            heartbeat_s=heartbeat_s, snapshot=snapshot)],
                   env, log_path)


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
            binary = build_daemon()
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
        proc_env = dict(env or {})
        if daemon == "python":
            proc_env["PYTHONPATH"] = os.pathsep.join(p for p in (
                str(_REPO), proc_env.get("PYTHONPATH", os.environ.get("PYTHONPATH")))
                if p)
        try:
            # Rank 0 first: the others join it with ADD_NODE.
            for r in range(n):
                log = str(self.workdir / f"daemon{r}.log")
                kw = dict(policy=_POLICY, ndevices=ndevices,
                          host_arena_bytes=host_bytes[r],
                          device_arena_bytes=device_arena_bytes,
                          lease_s=lease_s, heartbeat_s=heartbeat_s)
                if daemon == "native":
                    proc = spawn(self.nodefile, r, binary=binary, env=proc_env,
                                 log_path=log, **kw)
                else:
                    proc = _launch([*prog, self.nodefile, "--rank", str(r),
                                    *_flags(**kw)], proc_env, log)
                self.procs.append(proc)
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
