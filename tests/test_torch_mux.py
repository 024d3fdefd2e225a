"""The port's client halves (``oncilla_tpu_torch/runtime/mux.py``, the
grown ``runtime/client.py``, ``fabric/``) held against the JAX package's,
on the same inputs. Tolerance 0 throughout: bytes, handles, frames and
error types must be equal.

- Module units: the same ``Message`` through both packages'
  ``_frame_parts`` gives the same bytes; the same ``observe()`` sequence
  gives the same ``PeerTuner.plan()``; ``attach_peer`` decides the same on
  the same descriptor tails; ``handle_from_alloc_result`` builds the same
  handle from the same reply; the same tensors and arrays become the same
  wire bytes through ``AsyncOcm.put``'s coercion.
- Replication through the client: with ``replicas=2`` the port's client
  gives the handles the JAX client gives on twin clusters, ``replica_ranks``
  included, and a SIGKILLed primary's bytes come back through ``ctx.get``
  (subprocess daemons: the kill is a real one).
- A seeded differential fuzz of the port's mux ``Ocm`` against the JAX mux
  ``Ocm`` over two clusters: bytes, handles and exception types equal.

Every cluster here is in process (the port's ``inprocess_cluster``, the JAX
package's ``local_cluster``). Phase 8c of ``chip_smoke.py``, which starts
daemon processes, is rehearsed in ``test_torch_daemon.py`` beside phase
8b's rehearsal, so the two run one after the other on one test worker.

The shim that re-runs the JAX package's own client tests with the port's
client is here too (:func:`use_port_client`): :class:`PortClient`,
:class:`PortOcm` and :class:`PortAsyncOcm` take the JAX constructors'
arguments and the JAX package's handles, kinds, configs and rows, hand the
port the port's own types, and give back numpy arrays, JAX handles and
errors of the JAX package's class of the same name (:func:`dual_error`: the
class derives from both packages' classes). A handle's mutable fields
(owner, replica chain, freed) are carried across at every call, so a
failover the port's client makes shows on the JAX handle the test holds.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

import oncilla_tpu as jocm
import oncilla_tpu.analysis as janalysis_pkg
import oncilla_tpu.runtime.cluster as jcluster_mod
import oncilla_tpu.runtime.mux as jmux
from oncilla_tpu.core.arena import Extent as JExtent
from oncilla_tpu.core.handle import OcmAlloc as JAlloc
from oncilla_tpu.core.kinds import Fabric as JFabric
from oncilla_tpu.core.kinds import OcmKind as JKind
import oncilla_tpu_torch as tocm
import oncilla_tpu_torch.core.errors as terrors
from oncilla_tpu_torch.analysis import alloctrace as talloctrace
from oncilla_tpu_torch.core.arena import Extent as TExtent
from oncilla_tpu_torch.core.context import Ocm as TOcm
from oncilla_tpu_torch.core.handle import OcmAlloc as TAlloc
from oncilla_tpu_torch.core.kinds import Fabric as TFabric
from oncilla_tpu_torch.core.kinds import OcmKind as TKind
from oncilla_tpu_torch.obs import journal as tjournal
from oncilla_tpu_torch.resilience import timebudget as ttimebudget
from oncilla_tpu_torch.runtime import client as tclient_mod
from oncilla_tpu_torch.runtime import mux as tmux
from oncilla_tpu_torch.runtime import protocol as TP
from oncilla_tpu_torch.runtime.client import ControlPlaneClient as TClient
import oncilla_tpu.core.errors as jerrors
from test_torch_daemon import port_config, port_entries, patch_ref

# -- the shim -----------------------------------------------------------------

_SYNC = ("rank", "owner_addr", "replica_ranks", "freed", "local_nbytes",
         "daemon_owned")


class HandleMap:
    """JAX handles and the port's handles they stand for. Fields a client
    may change (the owner after a failover, the replica chain, freed) are
    copied to the port's handle before each call and back after it."""

    def __init__(self):
        self._pairs: dict[int, tuple] = {}

    def port(self, jh):
        if jh is None or isinstance(jh, TAlloc):
            return jh
        pair = self._pairs.get(id(jh))
        if pair is None or pair[0] is not jh:
            th = TAlloc(
                alloc_id=jh.alloc_id, kind=TKind(jh.kind.value),
                fabric=TFabric(jh.fabric.value), nbytes=jh.nbytes,
                rank=jh.rank, device_index=jh.device_index,
                extent=TExtent(jh.extent.offset, jh.extent.nbytes),
                origin_rank=jh.origin_rank)
            self._pairs[id(jh)] = (jh, th)
        else:
            th = pair[1]
        for f in _SYNC:
            setattr(th, f, getattr(jh, f))
        if getattr(jh, "_hedge_probe", False):
            th._hedge_probe = True
        return th

    def jax(self, th):
        if th is None or isinstance(th, JAlloc):
            return th
        for jh, t in self._pairs.values():
            if t is th:
                self.back(jh)
                return jh
        jh = JAlloc(
            alloc_id=th.alloc_id, kind=JKind(th.kind.value),
            fabric=JFabric(th.fabric.value), nbytes=th.nbytes, rank=th.rank,
            device_index=th.device_index,
            extent=JExtent(th.extent.offset, th.extent.nbytes),
            origin_rank=th.origin_rank)
        self._pairs[id(jh)] = (jh, th)
        self.back(jh)
        return jh

    def back(self, jh) -> None:
        pair = self._pairs.get(id(jh))
        if pair is not None and pair[0] is jh:
            for f in _SYNC:
                setattr(jh, f, getattr(pair[1], f))


def _kind(k):
    return TKind(k.value) if isinstance(k, JKind) else k


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return x


def _host(data):
    """JAX-side data (numpy, a jax array, bytes) as the port takes it."""
    if isinstance(data, (bytes, bytearray, memoryview, torch.Tensor)):
        return data
    return np.asarray(data)


_DUAL: dict[type, type] = {}


def dual_error(e: BaseException) -> BaseException:
    """A port error as a class deriving from both the JAX package's class
    of the same name and the port's, with the same message and attributes
    (a wire code, a retry hint, a rank): ``pytest.raises`` of either
    package's class catches it."""
    jcls = getattr(jerrors, type(e).__name__, None)
    if jcls is None or not isinstance(e, terrors.OcmError):
        return e
    cls = _DUAL.get(type(e))
    if cls is None:
        cls = _DUAL[type(e)] = type(type(e).__name__, (jcls, type(e)), {})
    de = cls.__new__(cls)
    de.args = e.args
    de.__dict__.update(e.__dict__)
    return de


def either_error(name: str) -> tuple:
    """Both packages' error classes ``name``, as a tuple: what a JAX
    test's ``pytest.raises`` and ``except`` name here, since the port's
    modules raise the port's classes directly (the shims' errors derive
    from both, :func:`dual_error`)."""
    return (getattr(jerrors, name), getattr(terrors, name))


class _PortErrorsNamespace(types.ModuleType):
    """``oncilla_tpu`` as a JAX test bound it (``import oncilla_tpu as
    ocm``), its error classes :func:`either_error` pairs."""

    def __getattr__(self, name):
        if hasattr(terrors, name) and hasattr(jerrors, name):
            return either_error(name)
        return getattr(jocm, name)


PORT_ERRORS_NS = _PortErrorsNamespace("oncilla_tpu")


def _call(hm: HandleMap, fn, *args, handles=(), **kw):
    """``fn`` with JAX handles in ``args`` as the port's, errors as the JAX
    classes, and the handles' fields carried back."""
    try:
        return fn(*args, **kw)
    except terrors.OcmError as e:
        raise dual_error(e) from e
    finally:
        for jh in handles:
            hm.back(jh)


class PortClient:
    """The port's ``ControlPlaneClient`` with the JAX constructor's
    signature, taking and giving the JAX package's types."""

    def __init__(self, entries, rank, config=None, ici_plane=None,
                 heartbeat=True, serve_plane=True, app_id=None):
        if ici_plane is not None:
            raise NotImplementedError("the shim carries no JAX plane")
        hm = HandleMap()
        object.__setattr__(self, "_hm", hm)
        object.__setattr__(self, "_c", _call(
            hm, TClient, port_entries(entries), rank,
            config=port_config(config), heartbeat=heartbeat,
            serve_plane=serve_plane, app_id=app_id))

    def __getattr__(self, name):
        return getattr(self._c, name)

    def __setattr__(self, name, value):
        setattr(self._c, name, value)

    def alloc(self, nbytes, kind, deadline_ms=None):
        kw = {} if deadline_ms is None else {"deadline_ms": deadline_ms}
        return self._hm.jax(_call(self._hm, self._c.alloc, nbytes,
                                  _kind(kind), **kw))

    def free(self, handle, deadline_ms=None):
        kw = {} if deadline_ms is None else {"deadline_ms": deadline_ms}
        _call(self._hm, self._c.free, self._hm.port(handle), handles=(handle,),
              **kw)

    def put(self, handle, data, offset=0, deadline_ms=None):
        kw = {} if deadline_ms is None else {"deadline_ms": deadline_ms}
        _call(self._hm, self._c.put, self._hm.port(handle), _host(data),
              offset, handles=(handle,), **kw)

    def get(self, handle, nbytes, offset=0, deadline_ms=None):
        kw = {} if deadline_ms is None else {"deadline_ms": deadline_ms}
        return _np(_call(self._hm, self._c.get, self._hm.port(handle), nbytes,
                         offset, handles=(handle,), **kw))

    def get_into(self, handle, out, offset=0, deadline_ms=None):
        kw = {} if deadline_ms is None else {"deadline_ms": deadline_ms}
        return _call(self._hm, self._c.get_into, self._hm.port(handle), out,
                     offset, handles=(handle,), **kw)

    def status(self, rank=None):
        return _call(self._hm, self._c.status, rank)

    def close(self, detach=False):
        _call(self._hm, self._c.close, detach)


class PortOcm:
    """The port's ``Ocm`` (on the CPU) with the JAX constructor's
    signature. Its remote backend is a :class:`PortClient`'s port
    client."""

    def __init__(self, config=None, remote=None, devices=None):
        hm = remote._hm if isinstance(remote, PortClient) else HandleMap()
        self._hm = hm
        self._client = remote
        self._o = TOcm(config=port_config(config),
                       remote=remote._c if remote is not None else None,
                       device="cpu")

    def __getattr__(self, name):
        return getattr(self._o, name)

    def alloc(self, nbytes, kind=JKind.LOCAL_HOST, device_index=0,
              local_nbytes=None, deadline_ms=None):
        return self._hm.jax(_call(
            self._hm, self._o.alloc, nbytes, _kind(kind),
            device_index=device_index, local_nbytes=local_nbytes,
            deadline_ms=deadline_ms))

    def free(self, handle):
        _call(self._hm, self._o.free, self._hm.port(handle), handles=(handle,))

    def put(self, handle, data, offset=0, deadline_ms=None):
        _call(self._hm, self._o.put, self._hm.port(handle), _host(data),
              offset, deadline_ms=deadline_ms, handles=(handle,))

    def get(self, handle, nbytes=None, offset=0, out=None, deadline_ms=None):
        return _np(_call(self._hm, self._o.get, self._hm.port(handle), nbytes,
                         offset, out=out, deadline_ms=deadline_ms,
                         handles=(handle,)))

    def status(self, rank=None):
        return _call(self._hm, self._o.status, rank)

    def fetch_prom(self, rank=None):
        return _call(self._hm, self._o.fetch_prom, rank)

    def tini(self):
        _call(self._hm, self._o.tini)


async def _acall(hm: HandleMap, coro, handles=()):
    try:
        return await coro
    except terrors.OcmError as e:
        raise dual_error(e) from e
    finally:
        for jh in handles:
            hm.back(jh)


class PortAsyncOcm:
    """The port's ``AsyncOcm`` behind the JAX one's ``open`` signature."""

    def __init__(self, o):
        self._o = o
        self._hm = HandleMap()

    @classmethod
    async def open(cls, entries, rank, config=None, app_id=None,
                   channels=None, heartbeat=True):
        o = await _acall(HandleMap(), tmux.AsyncOcm.open(
            port_entries(entries), rank, config=port_config(config),
            app_id=app_id, channels=channels, heartbeat=heartbeat))
        return cls(o)

    def __getattr__(self, name):
        return getattr(self._o, name)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.aclose()

    async def aclose(self, detach=False):
        await _acall(self._hm, self._o.aclose(detach))

    async def alloc(self, nbytes, kind=JKind.REMOTE_HOST, deadline_ms=None):
        return self._hm.jax(await _acall(self._hm, self._o.alloc(
            nbytes, _kind(kind), deadline_ms=deadline_ms)))

    async def free(self, handle, deadline_ms=None):
        await _acall(self._hm, self._o.free(self._hm.port(handle),
                                            deadline_ms=deadline_ms),
                     (handle,))

    async def put(self, handle, data, offset=0, deadline_ms=None):
        await _acall(self._hm, self._o.put(self._hm.port(handle), _host(data),
                                           offset, deadline_ms=deadline_ms),
                     (handle,))

    async def get(self, handle, nbytes=None, offset=0, out=None,
                  deadline_ms=None):
        return _np(await _acall(self._hm, self._o.get(
            self._hm.port(handle), nbytes, offset, out=out,
            deadline_ms=deadline_ms), (handle,)))

    async def status(self, rank=None):
        return await _acall(self._hm, self._o.status(rank))


def _port_channel_map(loop, config, pid=None):
    return tmux.ChannelMap(loop, port_config(config), pid)


class _PortMuxChannel(tmux.MuxChannel):
    def __init__(self, loop, addr, config):
        super().__init__(loop, addr, port_config(config))


class _PortMuxModule(types.ModuleType):
    """The port's mux module standing where a JAX test bound the JAX one:
    ``AsyncOcm``, ``ChannelMap`` and ``MuxChannel`` take JAX configs, and
    attributes set on it (``ORPHAN_CAP``) land on the port's module."""

    _OWN = {"AsyncOcm": PortAsyncOcm, "ChannelMap": _port_channel_map,
            "MuxChannel": _PortMuxChannel}

    def __getattr__(self, name):
        own = _PortMuxModule._OWN.get(name)
        return own if own is not None else getattr(tmux, name)

    def __setattr__(self, name, value):
        setattr(tmux, name, value)

    def __delattr__(self, name):
        delattr(tmux, name)


PORT_MUX_MODULE = _PortMuxModule("oncilla_tpu_torch.runtime.mux")


def port_ocm_init(config=None, remote=None, devices=None, **kw):
    """``oncilla_tpu.ocm_init`` for a JAX test: the port's ``ocm_init`` on
    the CPU, behind :class:`PortOcm`."""
    if remote is not None or kw:
        raise NotImplementedError("the shim's ocm_init takes a config only")
    o = _call(HandleMap(), tocm.ocm_init, port_config(config), device="cpu")
    shim = PortOcm.__new__(PortOcm)
    shim._hm, shim._client, shim._o = HandleMap(), None, o
    return shim


def use_port_client(monkeypatch, src, **names) -> None:
    """Point a JAX client test module at the port: the port's daemons
    (:func:`test_torch_daemon.patch_ref`), the port's client, context and
    AsyncOcm behind the shims above (in the JAX cluster, where
    ``client()`` and ``context()`` build them, and under the names the
    source bound), and ``names``."""
    patch_ref(monkeypatch, src, **names)
    monkeypatch.setattr(jcluster_mod, "ControlPlaneClient", PortClient)
    monkeypatch.setattr(jcluster_mod, "Ocm", PortOcm)
    monkeypatch.setattr(jocm, "ocm_init", port_ocm_init)
    monkeypatch.setattr(janalysis_pkg, "alloctrace", talloctrace)
    monkeypatch.setattr(jmux, "AsyncOcm", PortAsyncOcm)
    own = {"ControlPlaneClient": PortClient, "mux_rt": PORT_MUX_MODULE,
           "ocm": PORT_ERRORS_NS, "OcmConfig": tocm.OcmConfig,
           "P": TP, "timebudget": ttimebudget, "obs_journal": tjournal,
           "backoff_sleep": tclient_mod.backoff_sleep}
    for name, value in own.items():
        if hasattr(src, name) and name not in names:
            monkeypatch.setattr(src, name, value)
    for name in dir(src):
        if name.startswith("Ocm") and hasattr(terrors, name) \
                and hasattr(jerrors, name):
            monkeypatch.setattr(src, name, getattr(terrors, name))


# -- module units: the port's copies against the JAX modules -------------------

from oncilla_tpu import fabric as jfabric  # noqa: E402
from oncilla_tpu.fabric import tcp as jtcp  # noqa: E402
from oncilla_tpu.runtime import protocol as JP  # noqa: E402
from oncilla_tpu.runtime.cluster import local_cluster as jax_cluster  # noqa: E402
from oncilla_tpu_torch import fabric as tfabric  # noqa: E402
from oncilla_tpu_torch.fabric import tcp as ttcp  # noqa: E402
from oncilla_tpu_torch.runtime.cluster import inprocess_cluster  # noqa: E402
from oncilla_tpu_torch.runtime.membership import NodeEntry as TEntry  # noqa: E402


def _joined(parts) -> bytes:
    return b"".join(bytes(p) for p in parts)


def _messages(P, rng):
    """The same frames in either package's types: control ops with and
    without tails, tagged, traced, budgeted and bulk data."""
    big = rng.integers(0, 256, 300_000, dtype=np.uint8)
    out = [
        P.Message(P.MsgType.STATUS, {}),
        P.Message(P.MsgType.CONNECT, {"pid": 7, "rank": 1},
                  flags=P.FLAG_CAP_MUX | P.FLAG_CAP_TRACE),
        P.Message(P.MsgType.REQ_ALLOC, {"orig_rank": 0, "pid": 9, "kind": 3,
                                        "nbytes": 1 << 20},
                  b"\x02", flags=P.FLAG_REPLICAS),
        P.Message(P.MsgType.DATA_PUT, {"alloc_id": 4, "offset": 128,
                                       "nbytes": big.size},
                  memoryview(big)),
        P.Message(P.MsgType.DATA_GET, {"alloc_id": 4, "offset": 0,
                                       "nbytes": 4096}),
        P.Message(P.MsgType.HEARTBEAT, {"rank": 0, "pid": 9,
                                        "owners": "1,2"}),
    ]
    P.attach_tag(out[3], 0xABCDEF)
    P.attach_tag(out[4], 17)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_parts_bytes_equal(seed):
    jm = _messages(JP, np.random.default_rng(seed))
    tm = _messages(TP, np.random.default_rng(seed))
    for a, b in zip(jm, tm):
        got = _joined(tmux._frame_parts(b))
        assert got == _joined(jmux._frame_parts(a))
        assert got == TP.pack(b)


def _tuner_trace(rng, n=40):
    return [(float(rng.choice([1e-4, 5e-3, 0.03, 0.3, 0.6])),
             float(rng.choice([0.0, 1e7, 3e8, 2e9]))) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("adaptive", [True, False])
def test_peer_tuner_plans_equal(seed, adaptive):
    kw = dict(dcn_adaptive=adaptive, chunk_bytes=1 << 20, inflight_ops=2)
    jt = jtcp.PeerTuner(jocm.OcmConfig(**kw))
    tt = ttcp.PeerTuner(tocm.OcmConfig(**kw))
    for rtt, bps in _tuner_trace(np.random.default_rng(seed)):
        jt.observe(rtt, bps)
        tt.observe(rtt, bps)
        assert tt.plan() == jt.plan()


@pytest.mark.parametrize("total", [0, 100_000, 1 << 20, 9 << 20, 1 << 30])
@pytest.mark.parametrize("mux", [False, True])
def test_plan_stripes_equal(total, mux):
    kw = dict(mux=mux, dcn_stripes=4, dcn_stripe_min_bytes=1 << 20)
    assert ttcp.plan_stripes(tocm.OcmConfig(**kw), total) == \
        jtcp.plan_stripes(jocm.OcmConfig(**kw), total)


def _tails(seg_ok: str, size: int):
    return [
        b"", b"not json", b"[1, 2]", json.dumps({"tcp": {}}).encode(),
        json.dumps({"shm": "x"}).encode(),
        json.dumps({"shm": {"seg": "elsewhere", "size": 4096}}).encode(),
        json.dumps({"shm": {"seg": seg_ok, "size": 0}}).encode(),
        json.dumps({"shm": {"seg": seg_ok + "-gone", "size": 4096}}).encode(),
        json.dumps({"shm": {"seg": seg_ok, "size": size * 2}}).encode(),
        json.dumps({"shm": {"seg": seg_ok, "size": size}}).encode(),
    ]


def test_attach_peer_decides_equal():
    srv = tfabric.ShmServerFabric(1 << 20)
    try:
        seg = srv.descriptor()["seg"]
        for tail in _tails(seg, 1 << 20):
            j = jfabric.attach_peer(tail, None)
            t = tfabric.attach_peer(tail, None)
            assert (type(t).__name__ if t else None) == \
                (type(j).__name__ if j else None), tail
            for f in (j, t):
                if f is not None:
                    f.close()
    finally:
        srv.teardown()


def _alloc_reply(P, rng, tail):
    f = {"alloc_id": int(rng.integers(2, 1 << 40)) * 2,
         "kind": int(rng.integers(0, 4)), "rank": int(rng.integers(0, 4)),
         "device_index": int(rng.integers(0, 8)),
         "offset": int(rng.integers(0, 1 << 30)),
         "owner_host": "127.0.0.1", "owner_port": int(rng.integers(1, 65535))}
    return P.Message(P.MsgType.ALLOC_RESULT, f, tail)


@pytest.mark.parametrize("tail", [b"", b'{"replicas": [2, 1]}',
                                  b'{"replicas": [3, 0, 3]}', b"garbage",
                                  b'{"other": 1}'])
@pytest.mark.parametrize("seed", [0, 1])
def test_handle_from_alloc_result_equal(tail, seed):
    j = jmux.handle_from_alloc_result(
        _alloc_reply(JP, np.random.default_rng(seed), tail), 5000, 1)
    t = tmux.handle_from_alloc_result(
        _alloc_reply(TP, np.random.default_rng(seed), tail), 5000, 1)
    assert (t.alloc_id, t.kind.value, t.fabric.value, t.nbytes, t.rank,
            t.device_index, t.extent.offset, t.extent.nbytes, t.origin_rank,
            t.owner_addr, t.daemon_owned, t.replica_ranks) == \
        (j.alloc_id, j.kind.value, j.fabric.value, j.nbytes, j.rank,
         j.device_index, j.extent.offset, j.extent.nbytes, j.origin_rank,
         j.owner_addr, j.daemon_owned, j.replica_ranks)


def test_async_put_coercion_bytes_equal():
    """What ``AsyncOcm.put`` sends for an array, a tensor of any dtype and
    a bytes-like: the JAX package's bytes for the same values; a card
    tensor is refused, not moved on the loop."""
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((7, 13)).astype(np.float32)
    for j, t in ((arr, torch.from_numpy(arr)), (arr, arr),
                 (arr[:, ::2], torch.from_numpy(np.ascontiguousarray(arr[:, ::2]))),
                 (b"abc", b"abc")):
        want = np.ascontiguousarray(np.asarray(j)).view(np.uint8).reshape(-1)
        np.testing.assert_array_equal(tmux._host_array(t), want)

    class FakeCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    with pytest.raises(terrors.OcmError, match="host bytes"):
        tmux._host_array(torch.zeros(4).as_subclass(FakeCard))


def test_two_runtimes_in_one_process_stay_apart():
    """Both packages' process-shared mux runtimes at once: each client is
    on its own package's loop and channels, and releasing one leaves the
    other serving."""
    kw = dict(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
              chunk_bytes=64 << 10, heartbeat_s=0.5, mux=True)
    with jax_cluster(2, config=jocm.OcmConfig(**kw)) as jc, \
            inprocess_cluster(2, config=tocm.OcmConfig(**kw)) as tc:
        j = jc.client(0, heartbeat=False)
        t = tc.client(0, heartbeat=False)
        assert j._mux is not t._mux
        assert jmux.runtime_stats()["fds"] == 1
        assert tmux.runtime_stats()["fds"] == 1
        hj = j.alloc(256 << 10, jocm.OcmKind.REMOTE_HOST)
        ht = t.alloc(256 << 10, tocm.OcmKind.REMOTE_HOST)
        data = np.random.default_rng(1).integers(0, 256, 256 << 10,
                                                 dtype=np.uint8)
        j.put(hj, data)
        t.put(ht, data)
        assert jmux.runtime_stats()["fds"] == 2
        assert tmux.runtime_stats()["fds"] == 2
        j.free(hj)
        j.close()
        assert jmux.runtime_stats() is None
        np.testing.assert_array_equal(t.get(ht, 256 << 10).numpy(), data)
        t.free(ht)
        t.close()
        assert tmux.runtime_stats() is None


# -- replication through the client (the fault) --------------------------------

REP = dict(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
           chunk_bytes=64 << 10, heartbeat_s=0.2, lease_s=30.0, replicas=2,
           detect_interval_s=0.1, suspect_after=1, dead_after=2,
           failover_wait_s=10.0)


def _rep_sequence(client, kind, n=6):
    hs = [client.alloc(64 << 10, kind) for _ in range(n)]
    keys = [(h.alloc_id, h.kind.value, h.rank, h.extent.offset,
             tuple(h.replica_ranks)) for h in hs]
    for h in hs:
        client.free(h)
    return keys


@pytest.mark.parametrize("mux", [False, True])
def test_replicas_equal_to_the_jax_client(mux):
    """``OcmConfig(replicas=2)``: the port's client asks for replicated
    placements as the JAX client does, and its handles carry the same
    ``replica_ranks`` on twin clusters."""
    with jax_cluster(3, config=jocm.OcmConfig(**REP, mux=mux)) as cl:
        want = _rep_sequence(cl.client(0, heartbeat=False),
                             jocm.OcmKind.REMOTE_HOST)
    with jax_cluster(3, config=jocm.OcmConfig(**REP, mux=mux)) as cl:
        c = TClient([TEntry(r, "127.0.0.1", d.port)
                     for r, d in enumerate(cl.daemons)], 0,
                    config=tocm.OcmConfig(**REP, mux=mux), heartbeat=False)
        try:
            got = _rep_sequence(c, tocm.OcmKind.REMOTE_HOST)
        finally:
            c.close()
    assert got == want
    assert all(k[4] for k in got), "every handle is replicated"


def test_killed_primary_read_back_through_ctx_get():
    """Three port daemons with standby masters and hash placement, the app
    with ``replicas=2``: kill the primary of the handles (no snapshot, no
    drain), and every acknowledged write comes back byte for byte through
    ``ctx.get``; a further put lands on the promoted replica, which the
    handle now names. (Phase 8c's rehearsal does the same with a SIGKILL
    of a daemon process.)"""
    cfg = tocm.OcmConfig(**REP, standby_masters=2, placement="hash")
    rng = np.random.default_rng(11)
    with inprocess_cluster(3, config=cfg) as cl:
        ctx = cl.context(0, device="cpu")
        hs = [ctx.alloc(64 << 10, tocm.OcmKind.REMOTE_HOST) for _ in range(8)]
        assert all(h.replica_ranks for h in hs)
        data = [rng.integers(0, 256, 64 << 10, dtype=np.uint8) for _ in hs]
        for h, d in zip(hs, data):
            ctx.put(h, d)
        victim = next(h for h in hs if h.rank != 0)
        dead = victim.rank
        cl.kill(dead)
        for h, d in zip(hs, data):
            np.testing.assert_array_equal(ctx.get(h).numpy(), d)
        again = rng.integers(0, 256, 64 << 10, dtype=np.uint8)
        ctx.put(victim, again)
        np.testing.assert_array_equal(ctx.get(victim).numpy(), again)
        assert victim.rank != dead


# -- differential fuzz of the mux Ocm ------------------------------------------

FUZZ = dict(host_arena_bytes=4 << 20, device_arena_bytes=1 << 20,
            chunk_bytes=32 << 10, heartbeat_s=0.5, lease_s=30.0, mux=True)


def _fuzz(ctx, Kind, rng, steps=120):
    """A seeded op sequence; returns every outcome (handle fields, bytes,
    or the error's class name)."""
    live, out = [], []
    for _ in range(steps):
        op = rng.integers(0, 6)
        try:
            if op == 0 or not live:
                n = int(rng.choice([4096, 100_000, 300_000, 1 << 20, 8 << 20]))
                h = ctx.alloc(n, Kind.REMOTE_HOST)
                live.append(h)
                out.append(("alloc", h.alloc_id, h.rank, h.extent.offset))
            elif op == 1:
                h = live[int(rng.integers(len(live)))]
                off = int(rng.integers(0, h.nbytes + 50))
                n = int(rng.integers(1, 200_000))
                ctx.put(h, rng.integers(0, 256, n, dtype=np.uint8), off)
                out.append(("put", h.alloc_id))
            elif op in (2, 3):
                h = live[int(rng.integers(len(live)))]
                off = int(rng.integers(0, h.nbytes))
                n = int(rng.integers(1, h.nbytes + 50))
                got = ctx.get(h, n, off)
                out.append(("get", np.asarray(got).tobytes()))
            elif op == 4:
                h = live.pop(int(rng.integers(len(live))))
                ctx.free(h)
                out.append(("free", h.alloc_id))
            else:
                h = live[int(rng.integers(len(live)))]
                ctx.free(h)
                live.remove(h)
                ctx.free(h)  # the double free
        except Exception as e:  # noqa: BLE001 - the class name is the result
            out.append(("err", type(e).__name__))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_mux_ocm_against_jax(seed):
    with jax_cluster(2, config=jocm.OcmConfig(**FUZZ)) as cl:
        want = _fuzz(cl.context(0, heartbeat=False), jocm.OcmKind,
                     np.random.default_rng(seed))
    with inprocess_cluster(2, config=tocm.OcmConfig(**FUZZ)) as cl:
        got = _fuzz(cl.context(0, heartbeat=False, device="cpu"),
                    tocm.OcmKind, np.random.default_rng(seed))
    assert [g[0] for g in got] == [w[0] for w in want]
    assert got == want
    assert any(g[0] == "err" for g in got) and any(g[0] == "get" for g in got)
