"""The port's Python daemon (``oncilla_tpu_torch/runtime/daemon.py`` and the
modules it carries) held against the JAX package's, on the same seeded
inputs. Tolerance 0 throughout: bytes, handles, reply fields and error
types must be equal.

- Hash ring placements, the election rule, ``MASTER_STATE`` bytes and CRC
  refusal, placement and rebalance plans.
- Snapshot bytes: a snapshot the port's daemon wrote restores on the JAX
  daemon and on the native copy, and one the JAX daemon wrote restores on
  the port's.
- The FROZEN store's files.
- A scripted raw-frame sequence against a JAX in-process cluster and a port
  in-process cluster, with replies equal once ports, pids and times are
  normalised.
- ``python -m oncilla_tpu_torch.runtime.daemon`` as a process.
- Phases 8b and 8c of ``chip_smoke.py`` at a tiny size on the CPU (their
  daemons are processes; here they run one after the other).

:class:`PortDaemon` is the shim the ``test_torch_daemon_ref_*`` files and
``test_torch_client.py`` put in place of the JAX ``Daemon``: it converts the
JAX ``OcmConfig`` and ``NodeEntry`` rows it is handed into the port's own
types, so the port never accepts a JAX type.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

import oncilla_tpu.core.errors as jerrors
import oncilla_tpu.runtime.cluster as jcluster_mod
import oncilla_tpu.runtime.daemon as jdaemon_mod
import oncilla_tpu.resilience.chaos as jchaos_mod
from oncilla_tpu.runtime import membership as jmem
from oncilla_tpu.utils.config import OcmConfig as JConfig
import oncilla_tpu_torch.core.errors as terrors
import oncilla_tpu_torch.resilience.chaos as tchaos_mod
import oncilla_tpu_torch.runtime.pool as tpool_mod
from oncilla_tpu_torch.runtime import daemon as tdaemon_mod
from oncilla_tpu_torch.runtime import membership as tmem
from oncilla_tpu_torch.utils.config import OcmConfig as TConfig

REPO = Path(__file__).resolve().parents[1]


# -- the shim -----------------------------------------------------------------


def port_config(cfg) -> TConfig | None:
    """A JAX ``OcmConfig`` as the port's, field for field."""
    if cfg is None or isinstance(cfg, TConfig):
        return cfg
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(TConfig)})


def _t_entry(e):
    if e is None or isinstance(e, tmem.NodeEntry):
        return e
    return tmem.NodeEntry(e.rank, e.host, e.port, e.addr)


def _j_entry(e):
    if e is None or isinstance(e, jmem.NodeEntry):
        return e
    return jmem.NodeEntry(e.rank, e.host, e.port, e.addr)


class MirrorRows(list):
    """The port's view of a JAX row list: reads convert JAX rows to the
    port's ``NodeEntry``, writes convert back and land in the JAX list, so
    every daemon and client sharing that list still shares one table (the
    in-process cluster's idiom, where rank 0's ephemeral port and JOIN
    appends are seen by all)."""

    def __init__(self, rows: list):
        super().__init__()
        self._rows = rows

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, i):
        return _t_entry(self._rows[i])

    def __setitem__(self, i, e):
        self._rows[i] = _j_entry(e)

    def __iter__(self):
        return iter([_t_entry(e) for e in self._rows])

    def append(self, e):
        self._rows.append(_j_entry(e))


def port_entries(entries):
    """JAX rows (a list or a JAX ``ClusterView``) as the port's."""
    if isinstance(entries, tmem.ClusterView):
        return entries
    if isinstance(entries, jmem.ClusterView):
        view = tmem.ClusterView(MirrorRows(entries._entries),
                                epoch=entries.epoch)
        view._left = set(entries._left)
        return view
    if isinstance(entries, list) and entries and all(
            isinstance(e, tmem.NodeEntry) for e in entries):
        return entries
    return MirrorRows(entries if isinstance(entries, list) else list(entries))


def jax_error(e: BaseException) -> BaseException:
    """A port error as the JAX package's class of the same name, with the
    same message and attributes (a wire code, a retry hint, a rank)."""
    cls = getattr(jerrors, type(e).__name__, None)
    if cls is None or not isinstance(e, terrors.OcmError):
        return e
    je = cls.__new__(cls)
    je.args = e.args
    je.__dict__.update(e.__dict__)
    return je


def _direct(name: str):
    """``Daemon.<name>`` raising the JAX package's error classes when a
    test calls it directly; the port's own callers get the port's."""
    impl = getattr(tdaemon_mod.Daemon, name)

    def call(self, *args, **kw):
        try:
            return impl(self, *args, **kw)
        except terrors.OcmError as e:
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith("oncilla_tpu_torch"):
                raise
            raise jax_error(e) from e

    call.__name__ = name
    return call


class PortDaemon(tdaemon_mod.Daemon):
    """The port's ``Daemon`` with the JAX constructor's signature."""

    def __init__(self, rank, entries, config=None, *args, **kw):
        super().__init__(rank, port_entries(entries), port_config(config),
                         *args, **kw)

    # The methods the JAX tests call on a daemon directly.
    start = _direct("start")
    _lookup_serving = _direct("_lookup_serving")
    _on_migrate = _direct("_on_migrate")


PORT_CHAOS = {"ChaosController": tchaos_mod.ChaosController,
              "ChaosSchedule": tchaos_mod.ChaosSchedule,
              "Fault": tchaos_mod.Fault, "corrupt_file": tchaos_mod.corrupt_file}


def use_port_chaos(monkeypatch, *modules) -> None:
    """Point a JAX test's fault injection at the port's chaos harness,
    which hooks the port's connection pool (the one the port's daemons
    and client dial through): the JAX chaos module's classes (for a test
    that imports them inside its body), the names each module given bound
    and its ``pool_mod``. A JAX client's own legs go through the JAX pool,
    which no port hook reaches, so a test that counts client legs also
    needs the port's client (``test_torch_mux.use_port_client``)."""
    for name, value in PORT_CHAOS.items():
        monkeypatch.setattr(jchaos_mod, name, value)
    monkeypatch.setattr(tpool_mod, "_chaos_hook", None)
    for m in modules:
        for name, value in PORT_CHAOS.items():
            if hasattr(m, name):
                monkeypatch.setattr(m, name, value)
        if hasattr(m, "pool_mod"):
            monkeypatch.setattr(m, "pool_mod", tpool_mod)


def use_port_daemon(monkeypatch, *modules) -> None:
    """Put :class:`PortDaemon` in place of the JAX ``Daemon`` in the JAX
    cluster, the JAX daemon module (which ``elastic.join`` imports it
    from) and each module given that bound the name, and the port's chaos
    harness in place of the JAX one (:func:`use_port_chaos`)."""
    monkeypatch.setattr(jcluster_mod, "Daemon", PortDaemon)
    monkeypatch.setattr(jdaemon_mod, "Daemon", PortDaemon)
    use_port_chaos(monkeypatch, *modules)
    for m in modules:
        if hasattr(m, "Daemon"):
            monkeypatch.setattr(m, "Daemon", PortDaemon)


class _PortDaemonModule(types.ModuleType):
    """The port's daemon module standing where a JAX test bound the JAX
    one (``from oncilla_tpu.runtime import daemon as D``): its tables
    (``_HANDLERS``, ``_FLAGS_HANDLED``, ``_FENCED_REJECT``) are the port's,
    its ``Daemon`` is :class:`PortDaemon`, and attributes set on it land
    on the port's module."""

    def __getattr__(self, name):
        return getattr(tdaemon_mod, name)

    def __setattr__(self, name, value):
        setattr(tdaemon_mod, name, value)

    def __delattr__(self, name):
        delattr(tdaemon_mod, name)


PORT_DAEMON_MODULE = _PortDaemonModule("oncilla_tpu_torch.runtime.daemon")
object.__setattr__(PORT_DAEMON_MODULE, "Daemon", PortDaemon)


def _is_fixture(obj) -> bool:
    return (type(obj).__name__ == "FixtureFunctionDefinition"
            or hasattr(obj, "_pytestfixturefunction"))


def export_ref(ns: dict, src, run: list[str]) -> None:
    """Put the tests named in ``run`` and every fixture of the JAX test
    module ``src`` into the namespace of a ``test_torch_daemon_ref_*``
    module, so pytest collects each as a case there."""
    for name, obj in vars(src).items():
        if _is_fixture(obj):
            ns[name] = obj
    for name in run:
        if name in ns:
            raise AssertionError(f"{src.__name__}.{name} clashes in {ns['__name__']}")
        ns[name] = getattr(src, name)


def patch_ref(monkeypatch, src, **names) -> None:
    """Point a JAX test module at the port's daemon: the ``Daemon`` and
    ``D`` names it bound, plus ``names`` (its journal or ledger, say)."""
    use_port_daemon(monkeypatch, src)
    if hasattr(src, "D"):
        monkeypatch.setattr(src, "D", PORT_DAEMON_MODULE)
    for name, value in names.items():
        monkeypatch.setattr(src, name, value)


# -- pure units: the port's copies against the JAX modules ---------------------

from oncilla_tpu.control import hashring as jring  # noqa: E402
from oncilla_tpu.control import leader as jleader  # noqa: E402
from oncilla_tpu.core.kinds import OcmKind as JKind  # noqa: E402
from oncilla_tpu.elastic.rebalance import Rebalancer as JRebalancer  # noqa: E402
from oncilla_tpu.persist.store import FrozenStore as JStore  # noqa: E402
from oncilla_tpu.runtime import placement as jplace  # noqa: E402
from oncilla_tpu.runtime import protocol as JP  # noqa: E402
from oncilla_tpu.runtime import snapshot as jsnap  # noqa: E402
from oncilla_tpu_torch.control import hashring as tring  # noqa: E402
from oncilla_tpu_torch.control import leader as tleader  # noqa: E402
from oncilla_tpu_torch.core.kinds import OcmKind as TKind  # noqa: E402
from oncilla_tpu_torch.elastic.rebalance import Rebalancer as TRebalancer  # noqa: E402
from oncilla_tpu_torch.persist.store import FrozenStore as TStore  # noqa: E402
from oncilla_tpu_torch.runtime import placement as tplace  # noqa: E402
from oncilla_tpu_torch.runtime import protocol as TP  # noqa: E402
from oncilla_tpu_torch.runtime import snapshot as tsnap  # noqa: E402


def _outcome(fn):
    """A call's result, or its error's class name and message."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hashring_placements_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        key = int(rng.integers(0, 2**63))
        ranks = sorted(set(int(r) for r in rng.integers(0, 9, rng.integers(0, 7))))
        k = int(rng.integers(1, 4))
        assert tring.plan(key, ranks, k) == jring.plan(key, ranks, k)
        for r in ranks:
            assert tring.score(key, r) == jring.score(key, r)


@pytest.mark.parametrize("seed", [0, 1])
def test_election_rule_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 7))
        jv = jmem.ClusterView([jmem.NodeEntry(r, "h", 1000 + r) for r in range(n)])
        tv = tmem.ClusterView([tmem.NodeEntry(r, "h", 1000 + r) for r in range(n)])
        for r in range(n):
            if rng.random() < 0.2:
                jv.mark_left(r)
                tv.mark_left(r)
        dead = {int(r) for r in rng.integers(0, n, rng.integers(0, n + 1))}
        me = int(rng.integers(0, n))
        assert tleader.elect(tv, dead, me) == jleader.elect(jv, dead, me)
        assert tv.to_wire() == jv.to_wire()


def test_master_state_bytes_and_crc_refusal_equal():
    doc = {
        "seq": 7, "epoch": 3, "leader": 1, "inc": 42,
        "view": {"epoch": 3, "members": [], "left": []},
        "placement": [{"rank": 0, "ndevices": 1, "device_arena_bytes": 1,
                       "host_arena_bytes": 2, "device_used": [0],
                       "host_used": 1}],
        "dead": [2],
    }
    raw = tleader.pack_state(doc)
    assert raw == jleader.pack_state(doc)
    assert tleader.unpack_state(raw) == jleader.unpack_state(raw) == {**doc, "v": 1}
    for off in (0, len(raw) // 3, len(raw) // 2, len(raw) - 1):
        bad = bytearray(raw)
        bad[off] ^= 0xFF
        t = _outcome(lambda: tleader.unpack_state(bytes(bad)))
        j = _outcome(lambda: jleader.unpack_state(bytes(bad)))
        assert t == j and t[:2] == ("err", "OcmProtocolError")
    for cut in (0, 3, len(raw) - 4):
        assert (_outcome(lambda: tleader.unpack_state(raw[:cut]))
                == _outcome(lambda: jleader.unpack_state(raw[:cut])))


def _placement_key(p):
    return (p.rank, p.device_index, p.kind.name, p.replica_ranks)


@pytest.mark.parametrize("policy", ["capacity", "neighbor", "loadaware"])
@pytest.mark.parametrize("seed", [0, 1])
def test_placement_plans_equal(policy, seed):
    """The same node table and request stream through each package's
    policy: the same placements, the same refusals."""
    rng = np.random.default_rng(seed)
    jp, tp = jplace.POLICIES[policy](), tplace.POLICIES[policy]()
    for r in range(4):
        nd, dev, host = int(rng.integers(1, 3)), 1 << 20, int(rng.integers(1, 5)) << 20
        jp.add_node(jplace.NodeResources(r, nd, dev, host))
        tp.add_node(tplace.NodeResources(r, nd, dev, host))
    kinds = ["REMOTE_HOST", "REMOTE_DEVICE", "LOCAL_HOST"]
    for step in range(200):
        kind = kinds[int(rng.integers(len(kinds)))]
        nbytes = int(rng.integers(1, 3 << 20))
        orig = int(rng.integers(0, 4))
        reps = int(rng.integers(1, 4))
        excl = tuple(int(x) for x in rng.integers(0, 4, rng.integers(0, 2)))
        if step == 60:
            jp.mark_dead(2)
            tp.mark_dead(2)
        if step == 120:
            jp.mark_alive(2)
            tp.mark_alive(2)
        j = _outcome(lambda: jp.place(orig, JKind[kind], nbytes, reps, excl))
        t = _outcome(lambda: tp.place(orig, TKind[kind], nbytes, reps, excl))
        if j[0] == "ok":
            assert t[0] == "ok", (t, j)
            assert _placement_key(t[1]) == _placement_key(j[1])
            if rng.random() < 0.7:
                jp.note_alloc(j[1], nbytes)
                tp.note_alloc(t[1], nbytes)
        else:
            assert t == j
    assert tp.export_rows() == jp.export_rows()
    assert tp.host_free() == jp.host_free()


def _rows(rank, sizes, rng):
    return [{"id": rank * 100 + i, "kind": 3, "nbytes": s,
             "chain": [int(c) for c in rng.integers(0, 4, rng.integers(0, 2))],
             "primary": bool(rng.random() < 0.9), "prio": 1,
             "origin_rank": 0, "origin_pid": 1,
             "migrating": bool(rng.random() < 0.1)}
            for i, s in enumerate(sizes)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rebalance_plans_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(1, 5))
        inv = {r: _rows(r, [int(s) << 18 for s in rng.integers(1, 16, rng.integers(0, 8))], rng)
               for r in range(n)}
        caps = {r: int(rng.integers(4, 32)) << 20 for r in range(n)}
        assert (TRebalancer(daemon=None).plan(inv, caps)
                == JRebalancer(daemon=None).plan(inv, caps))


def _snapshot(mod, rng):
    ents = [mod.SnapEntry(int(i) | (1 << 32), int(k), int(d), int(o) << 12,
                          int(n), 1, 4242, bytes(rng.integers(0, 256, int(n), dtype=np.uint8)))
            for i, k, d, o, n in zip(range(2, 7), rng.integers(0, 4, 5),
                                     rng.integers(0, 2, 5), range(0, 50, 10),
                                     rng.integers(1, 9000, 5))]
    return mod.Snapshot(rank=1, id_counter=9, entries=ents)


def test_snapshot_bytes_equal_and_cross_load():
    tb = tsnap.dump(_snapshot(tsnap, np.random.default_rng(5)))
    jb = jsnap.dump(_snapshot(jsnap, np.random.default_rng(5)))
    assert tb == jb
    back = tsnap.load(jb)
    assert [dataclasses.astuple(e) for e in back.entries] == [
        dataclasses.astuple(e) for e in jsnap.load(tb).entries]
    for cut in (3, len(tb) // 2, len(tb) - 2):
        assert (_outcome(lambda: tsnap.load(tb[:cut]))[:2]
                == _outcome(lambda: jsnap.load(tb[:cut]))[:2]
                == ("err", "OcmProtocolError"))


def test_frozen_store_files_equal(tmp_path):
    """The same writes through each package's FROZEN store leave the same
    files, and each store reads the other's."""
    rng = np.random.default_rng(9)
    items = [(f"alloc-{i}", bytes(rng.integers(0, 256, int(n), dtype=np.uint8)),
              {"alloc_id": i, "nbytes": int(n), "priority": 0})
             for i, n in enumerate(rng.integers(1, 20000, 6))]
    dirs = {}
    for name, cls in (("t", TStore), ("j", JStore)):
        st = cls(str(tmp_path / name))
        for key, data, meta in items:
            st.write(key, data, meta=meta)
        st.delete(items[2][0])
        dirs[name] = {p.name: p.read_bytes() for p in (tmp_path / name).iterdir()}
    assert dirs["t"] == dirs["j"] and dirs["t"]
    for reader, src in ((TStore, "j"), (JStore, "t")):
        st = reader(str(tmp_path / src))
        assert not st.lost
        assert sorted(st.keys()) == sorted(k for k, _, _ in items if k != items[2][0])
        for key, data, meta in items:
            if key != items[2][0]:
                assert st.read(key) == (data, meta)


# -- snapshots across the three daemons ------------------------------------

from oncilla_tpu.runtime.client import ControlPlaneClient as JClient  # noqa: E402
from oncilla_tpu_torch.runtime.cluster import (  # noqa: E402
    InProcessCluster,
    build_daemon,
    free_ports,
    inprocess_cluster,
)

SNAP_SIZES = (4096, 100_000, 512 << 10)


def _wait_listening(port: int, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
            return
        except OSError:
            time.sleep(0.02)
    raise AssertionError(f"nothing listens on {port}")


def _snap_cfg(mod):
    return mod(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
               detect=False)


def _fill_and_snapshot(daemon_cls, cfg_cls, entry_cls, path, datas):
    """One daemon, three REMOTE_HOST allocations with data put by the JAX
    client, which detaches so the allocations outlive it; stop writes
    the snapshot. Returns the handles."""
    d = daemon_cls(0, [entry_cls(0, "127.0.0.1", 0)], config=_snap_cfg(cfg_cls),
                   snapshot_path=str(path))
    d.start()
    c = JClient([jmem.NodeEntry(0, "127.0.0.1", d.port)], 0, heartbeat=False)
    hs = []
    for data in datas:
        h = c.alloc(data.nbytes, JKind.REMOTE_HOST)
        c.put(h, data, 0)
        hs.append(h)
    c.free(c.alloc(8192, JKind.REMOTE_HOST))  # a freed id is not snapshotted
    c.close(detach=True)
    d.stop()
    return hs


def _read_back(port, hs, datas):
    c = JClient([jmem.NodeEntry(0, "127.0.0.1", port)], 0, heartbeat=False)
    try:
        assert c.status()["live_allocs"] == len(hs)
        for h, data in zip(hs, datas):
            np.testing.assert_array_equal(np.asarray(c.get(h, data.nbytes, 0)), data)
    finally:
        c.close(detach=True)


def test_snapshots_cross_restore_between_daemons(tmp_path):
    """Snapshot bytes are an on-disk format shared by the three daemons:
    the same allocations snapshot to the same bytes on the port's daemon
    and the JAX daemon; the port's snapshot restores on the JAX daemon and
    on the native copy, and the JAX daemon's on the port's."""
    rng = np.random.default_rng(17)
    datas = [rng.integers(0, 256, n, dtype=np.uint8) for n in SNAP_SIZES]
    tpath, jpath = tmp_path / "port.ocms", tmp_path / "jax.ocms"
    hs = _fill_and_snapshot(tdaemon_mod.Daemon, TConfig, tmem.NodeEntry, tpath, datas)
    _fill_and_snapshot(jdaemon_mod.Daemon, JConfig, jmem.NodeEntry, jpath, datas)
    assert tpath.read_bytes() == jpath.read_bytes()
    assert len(jsnap.read_file(str(tpath)).entries) == len(datas)

    # The JAX daemon restores the port's snapshot ...
    jd = jdaemon_mod.Daemon(0, [jmem.NodeEntry(0, "127.0.0.1", 0)],
                            config=_snap_cfg(JConfig), snapshot_path=str(tpath))
    jd.start()
    try:
        _read_back(jd.port, hs, datas)
    finally:
        jd.kill()
    # ... the port's daemon restores the JAX daemon's ...
    td = tdaemon_mod.Daemon(0, [tmem.NodeEntry(0, "127.0.0.1", 0)],
                            config=_snap_cfg(TConfig), snapshot_path=str(jpath))
    td.start()
    try:
        _read_back(td.port, hs, datas)
    finally:
        td.kill()
    # ... and the native copy restores the port's.
    (port,) = free_ports(1)
    nodefile = tmp_path / "nodefile"
    nodefile.write_text(f"0 127.0.0.1 {port}\n")
    p = subprocess.Popen(
        [str(build_daemon()), "--nodefile", str(nodefile), "--rank", "0",
         "--snapshot", str(tpath), "--host-arena-bytes", str(8 << 20),
         "--device-arena-bytes", str(1 << 20)],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    try:
        _wait_listening(port)
        _read_back(port, hs, datas)
    finally:
        p.kill()
        p.wait()


# -- the scripted raw-frame sequence -----------------------------------------

from oncilla_tpu.qos.policy import pack_profile  # noqa: E402
from oncilla_tpu.runtime.cluster import LocalCluster as JCluster  # noqa: E402

ALL_CAPS = (JP.FLAG_CAP_COALESCE | JP.FLAG_CAP_TRACE | JP.FLAG_CAP_REPLICA
            | JP.FLAG_CAP_QOS | JP.FLAG_QOS_TAIL | JP.FLAG_CAP_FABRIC
            | JP.FLAG_CAP_MUX | JP.FLAG_CAP_DEADLINE)
PID = 777  # the scripted app's id (the pid field of its frames)
# Values that differ between two runs of one sequence, by key.
_VOLATILE = {"ts", "mono", "t_wall", "inc", "incarnation", "uptime_s",
             "trace_id", "span_id", "exemplars", "age_s", "last_seen_s",
             "idle_s", "seconds", "gbps", "value", "sum_s", "p50_us",
             "p99_us", "counts"}


def _norm(x, ports):
    """A reply value with daemon ports named by rank and run-to-run
    values (times, incarnations, trace ids) masked."""
    if isinstance(x, dict):
        return {k: "<v>" if k in _VOLATILE else _norm(v, ports)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v, ports) for v in x]
    if isinstance(x, float):
        return "<f>"
    if isinstance(x, int) and not isinstance(x, bool) and x in ports:
        return f"<port{ports[x]}>"
    if isinstance(x, str):
        for p, r in ports.items():
            x = x.replace(str(p), f"<port{r}>")
        return x
    return x


def _norm_reply(m, ports):
    data = bytes(m.data) if m.data is not None else b""
    try:
        data = _norm(json.loads(data), ports)
    except (ValueError, UnicodeDecodeError):
        pass
    fields = dict(m.fields)
    if m.type.name == "HEARTBEAT_OK":
        fields["lease_s"] = float(fields["lease_s"])
    return (m.type.name, m.flags, _norm(fields, ports), data)


class _Conn:
    def __init__(self, port):
        self.s = socket.create_connection(("127.0.0.1", port), timeout=10)

    def ask(self, mtype, fields=None, data=b"", flags=0):
        msg = JP.Message(JP.MsgType[mtype], fields or {}, data, flags)
        tmsg = TP.Message(TP.MsgType[mtype], fields or {}, data, flags)
        assert JP.pack(msg) == TP.pack(tmsg)  # one wire
        JP.send_msg(self.s, msg)
        return JP.recv_msg(self.s)

    def close(self):
        self.s.close()


def _script(cl, entries, ports):
    """CONNECT with every capability, allocs of each kind and of refused
    sizes, put/get with bounds errors, free and double free, heartbeat,
    status, a migration and its locate, a join and a leave."""
    out = []

    def rec(m):
        out.append(_norm_reply(m, ports))
        return m

    c = _Conn(entries[1].port)
    rec(c.ask("CONNECT", {"pid": PID, "rank": 1}, pack_profile(0, 0, 0), ALL_CAPS))
    c.close()
    c = _Conn(entries[1].port)
    rec(c.ask("CONNECT", {"pid": PID, "rank": 1}))
    host = JP.WIRE_KIND["remote_host"]
    dev = JP.WIRE_KIND["remote_device"]
    allocs = []
    for kind, n in ((host, 40960), (host, 100_000), (dev, 8192), (host, 1 << 20),
                    (host, 0), (host, 1 << 40), (dev, 1 << 30)):
        m = rec(c.ask("REQ_ALLOC", {"orig_rank": 1, "pid": PID, "kind": kind,
                                    "nbytes": n}))
        if m.type.name == "ALLOC_RESULT":
            allocs.append(dict(m.fields))
    owners = sorted({a["rank"] for a in allocs})
    rng = np.random.default_rng(3)
    hosts = [a for a in allocs if a["kind"] == host]
    for a in hosts:
        o = _Conn(entries[a["rank"]].port)
        data = rng.integers(0, 256, a["nbytes"] - 100, dtype=np.uint8).tobytes()
        rec(o.ask("DATA_PUT", {"alloc_id": a["alloc_id"], "offset": 100,
                               "nbytes": len(data)}, data))
        rec(o.ask("DATA_GET", {"alloc_id": a["alloc_id"], "offset": 50,
                               "nbytes": 4096}))
        rec(o.ask("DATA_GET", {"alloc_id": a["alloc_id"], "offset": a["nbytes"] - 8,
                               "nbytes": 16}))  # out of bounds
        rec(o.ask("DATA_PUT", {"alloc_id": a["alloc_id"], "offset": a["nbytes"],
                               "nbytes": 1}, b"x"))  # out of bounds
        rec(o.ask("DATA_GET", {"alloc_id": 12345, "offset": 0, "nbytes": 1}))
        o.close()
    rec(c.ask("HEARTBEAT", {"rank": 1, "pid": PID,
                            "owners": ",".join(map(str, owners))}))
    # A migration off the first host allocation's owner, then where is it.
    a = hosts[0]
    target = next(r for r in range(3) if r != a["rank"])
    o = _Conn(entries[a["rank"]].port)
    rec(o.ask("MIGRATE", {"alloc_id": a["alloc_id"], "target_rank": target,
                          "epoch": 0}))
    rec(o.ask("MIGRATE", {"alloc_id": a["alloc_id"], "target_rank": 99,
                          "epoch": 0}))
    o.close()
    lead = _Conn(entries[0].port)
    rec(lead.ask("REQ_LOCATE", {"alloc_id": a["alloc_id"]}))
    rec(lead.ask("REQ_LOCATE", {"alloc_id": 999}))
    a["rank"] = target
    # Rank 2 leaves and is drained (its allocation moves); a second leave
    # finds it gone.
    inc = cl.daemons[2].incarnation
    rec(lead.ask("REQ_LEAVE", {"rank": 2, "inc": inc}))
    rec(lead.ask("REQ_LEAVE", {"rank": 2, "inc": inc}))
    for a in allocs:
        rec(c.ask("REQ_FREE", {"alloc_id": a["alloc_id"], "rank": a["rank"]}))
    rec(c.ask("REQ_FREE", {"alloc_id": allocs[0]["alloc_id"],
                           "rank": allocs[0]["rank"]}))  # double free
    # A member joins (nothing listens at its address; detection is off);
    # a second join from one address dedups; a non-leader refuses.
    (fake,) = free_ports(1)
    ports[fake] = 3
    join = {"host": "127.0.0.1", "port": fake, "ndevices": 1,
            "device_arena_bytes": 1 << 20, "host_arena_bytes": 4 << 20,
            "inc": 99}
    rec(lead.ask("REQ_JOIN", join))
    rec(lead.ask("REQ_JOIN", join))
    rec(c.ask("REQ_JOIN", join))
    rec(c.ask("STATUS"))
    rec(c.ask("DISCONNECT", {"pid": PID, "owners": ",".join(map(str, owners))}))
    c.close()
    lead.close()
    return out


@pytest.mark.parametrize("policy", ["capacity", "neighbor", "loadaware"])
def test_scripted_frames_get_equal_replies(policy):
    # No detector, no lease expiry, no reaper tick and no load poll inside
    # the script: the replies depend on the frames alone.
    kw = dict(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
              detect=False, lease_s=300.0, heartbeat_s=60.0,
              loadaware_poll_s=3600.0)
    runs = {}
    for name, make in (("jax", lambda: JCluster(3, config=JConfig(**kw),
                                                 policy=policy, ndevices=2)),
                       ("port", lambda: InProcessCluster(3, config=TConfig(**kw),
                                                         policy=policy,
                                                         ndevices=2))):
        cl = make()
        try:
            entries = list(cl.entries)
            ports = {e.port: r for r, e in enumerate(entries)}
            runs[name] = _script(cl, entries, ports)
        finally:
            cl.stop()
    assert len(runs["port"]) == len(runs["jax"])
    for t, j in zip(runs["port"], runs["jax"]):
        assert t == j
    kinds = [r[0] for r in runs["port"]]
    for want in ("CONNECT_CONFIRM", "ALLOC_RESULT", "DATA_PUT_OK",
                 "DATA_GET_OK", "ERROR", "MIGRATE_OK", "LOCATE_OK", "FREE_OK",
                 "JOIN_OK", "LEAVE_OK", "STATUS_OK", "HEARTBEAT_OK"):
        assert want in kinds, want


# -- the daemon as a process, and chip_smoke.py's phase 8b on the CPU ---------


def test_daemon_module_serves_both_clients_and_stops_on_sigterm(tmp_path):
    """``python -m oncilla_tpu_torch.runtime.daemon``: two ranks serve the
    JAX client and the port's alike, stop on SIGTERM with status 0, and
    import neither ``jax`` nor ``oncilla_tpu`` (``-X importtime`` lists
    every module a process imports, lazily imported ones included)."""
    import signal

    import torch

    from oncilla_tpu_torch.core.kinds import OcmKind as TK
    from oncilla_tpu_torch.runtime.client import ControlPlaneClient as TClient

    ports = free_ports(2)
    nodefile = tmp_path / "nodefile"
    nodefile.write_text("".join(f"{r} 127.0.0.1 {p}\n" for r, p in enumerate(ports)))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    logs = [(tmp_path / f"out{r}", tmp_path / f"err{r}") for r in range(2)]
    procs = []
    for r, (o, e) in enumerate(logs):
        with open(o, "w") as fo, open(e, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-X", "importtime", "-m",
                 "oncilla_tpu_torch.runtime.daemon", str(nodefile), "--rank", str(r),
                 "--host-arena-bytes", str(8 << 20),
                 "--snapshot", str(tmp_path / f"r{r}.ocms")],
                stdout=fo, stderr=fe, env=env))
    try:
        for p in ports:
            _wait_listening(p, 60.0)
        rng = np.random.default_rng(2)
        data = rng.integers(0, 256, 300_000, dtype=np.uint8)
        jc = JClient([jmem.NodeEntry(r, "127.0.0.1", p) for r, p in enumerate(ports)], 0)
        h = jc.alloc(data.nbytes, JKind.REMOTE_HOST)
        jc.put(h, data, 0)
        assert bytes(jc.get(h, data.nbytes, 0)) == data.tobytes()
        tc = TClient([tmem.NodeEntry(r, "127.0.0.1", p) for r, p in enumerate(ports)], 1)
        th = tc.alloc(data.nbytes, TK.REMOTE_HOST)
        tc.put(th, torch.from_numpy(data), 0)
        assert torch.equal(tc.get(th, data.nbytes, 0), torch.from_numpy(data))
        assert tc.status(0)["nnodes"] == 2
        tc.free(th)
        tc.close()
        jc.free(h)
        jc.close()
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=60)
    outs = [(o.read_text(), e.read_text()) for o, e in logs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    for out, err in outs:
        assert "listening on 127.0.0.1" in out
        mods = [line.rsplit("|", 1)[-1].strip() for line in err.splitlines()
                if line.startswith("import time:")]
        assert "oncilla_tpu_torch.control.leader" in mods  # the daemon's imports
        assert "oncilla_tpu_torch.runtime.snapshot" in mods  # written at stop
        bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "oncilla_tpu")]
        assert not bad, bad


def test_phase_8b_on_the_cpu():
    """chip_smoke.py's phase 8b at a tiny size on the CPU: the Python
    daemons as processes, REMOTE_HOST byte for byte, the relayed
    REMOTE_DEVICE page and the copy between two such handles, KV pages of
    both remote kinds bit for bit against the unpaged decode, the leader
    SIGKILLed and its successor agreed, every handle's bytes back (those of
    the dead primary through the promoted replica), QoS granted where the
    native daemon declines, no daemon holding a card device node. Kernel
    launches are not counted: on the CPU the wrappers run their plain
    versions."""
    import torch

    import chip_smoke
    from oncilla_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu = torch.device("cpu")
    rep = chip_smoke.phase_daemons_py(
        cpu, engine={"cfg": cfg, "params": params, "page_tokens": 8},
        row_bytes=1 << 20, host_bytes=(1 << 20, 8 << 20),
        sizes=(4096, 64 << 10, 1 << 20), timed=(64 << 10,), reps=2,
        alloc_iters=10, kv=(16, 8), handles=(6, 64 << 10),
        check_launches=False)
    assert set(rep["kv"]) == {"REMOTE_DEVICE", "REMOTE_HOST"}
    assert rep["kv"]["REMOTE_DEVICE"]["page_stores"] == 3
    assert rep["kv"]["REMOTE_DEVICE"]["page_fetches"] == 6
    assert rep["resilient"]["leader"] in (1, 2)
    assert rep["resilient"]["election_s"] < rep["resilient"]["budget_s"]
    assert rep["resilient"]["located"] and 0 not in rep["resilient"]["located"]
    assert rep["placed"]["relayed"]["PLANE_PUT"] >= 1
    assert len(rep["no_card"]["pids"]) == 5


def test_phase_8c_on_the_cpu():
    """``chip_smoke.phase_client`` at a tiny size on the CPU: the Python
    daemons as processes, the mux app, 8 tenants on one channel a peer,
    AsyncOcm's concurrent gets, lockstep against the native pair, the shm
    fabric selected, runs H and I over a mux cold client against runs E
    and C (H's prefetcher async, every COLD page of both legs checked), a
    stopped primary hedged around and a budgeted put expired, a killed one
    failed over through the client. Kernel launches are not counted: on the
    CPU the wrappers run their plain versions."""
    import torch

    import chip_smoke
    from oncilla_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu = torch.device("cpu")
    # A 40-token shared prefix: long enough that pages reach COLD while
    # their sessions run, so H's AsyncOcm leg has pages to prefetch.
    kw = dict(shared=40, suffix=4, new_tokens=8, warm=2)
    ref = chip_smoke.phase_engine(
        cpu, cfg, params, page_tokens=8,
        runs=(("C", True, 0, True, 2), ("E", True, 2, None, 2)), **kw)["runs"]
    rep = chip_smoke.phase_client(
        cpu, engine={"cfg": cfg, "params": params, "page_tokens": 8,
                     "runs": ref, "kw": kw},
        host_bytes=(4 << 20, 16 << 20), sizes=(4096, 64 << 10, 1 << 20),
        timed=(64 << 10,), reps=2, alloc_iters=10, tenants=8,
        async_gets=(4, 64 << 10), fabric_bytes=1 << 20, handles=(6, 64 << 10),
        check_launches=False)
    assert rep["mux"]["tenants"]["fds"] == 2
    assert rep["mux"]["native"]["muxed"] is False
    assert rep["fabric"]["selected"] == "shm"
    assert rep["fabric"]["tcp"]["coalesce_granted"]
    s = rep["serving"]
    assert s["mode"] == "async" and s["i_vs_c_tokens_equal"] == s["tokens"] > 0
    assert s["cold_pages_checked_async"] > 0 and s["cold_pages_mismatched"] == 0
    assert rep["hedge"]["repointed"] is False
    assert rep["deadline"]["raised_after_s"] < 0.4 + 1.6
    assert rep["replicas"]["promoted"] != rep["replicas"]["killed"]


def test_inprocess_cluster_restart_keeps_the_address():
    """``inprocess_cluster``'s ``restart``: a fresh incarnation on the same
    address joins and serves; the killed one's allocations are gone (no
    snapshot, no FROZEN tier configured)."""
    import torch

    from oncilla_tpu_torch.core.kinds import OcmKind as TK

    cfg = TConfig(host_arena_bytes=4 << 20, device_arena_bytes=1 << 20,
                  detect=False)
    with inprocess_cluster(2, config=cfg) as cl:
        old = cl.daemons[1]
        c = cl.client(1, heartbeat=False)
        c.alloc(8192, TK.REMOTE_HOST)
        assert sum(d.registry.live_count() for d in cl.daemons) == 1
        new = cl.restart(1)
        assert new is cl.daemons[1] and new is not old
        assert new.port == old.port and new.incarnation != old.incarnation
        c2 = cl.client(1, heartbeat=False, app_id=os.getpid() + 1)
        h = c2.alloc(8192, TK.REMOTE_HOST)
        data = torch.arange(8192, dtype=torch.int32).to(torch.uint8)
        c2.put(h, data, 0)
        assert torch.equal(c2.get(h, 8192, 0), data)
