"""The port's wire protocol held against the JAX package's, byte for byte.

- For every message type the port's codec has a schema for, ``pack`` of the
  same seeded fields (and data tail, and flags) gives the JAX package's
  frame exactly; ``unpack`` of a JAX frame gives the same fields and data.
- ``send_msg``/``recv_msg`` interoperate across the two packages over a
  socket pair, the landing of a payload in a caller's buffer included.
- ``remote_error`` maps every ``ErrCode`` to the same exception class name,
  code, detail and tail attributes.
- The constants (frame header, flag bits, message and error codes, wire
  kind tags, the QoS profile tail) are the JAX package's.
"""

import socket
import struct
import threading

import numpy as np
import pytest

from oncilla_tpu.qos import policy as jpolicy
from oncilla_tpu.runtime import protocol as jp
from oncilla_tpu_torch.qos import policy as tpolicy
from oncilla_tpu_torch.runtime import protocol as tp

PORT_TYPES = sorted(tp._SCHEMAS, key=int)
FLAG_NAMES = [n for n in dir(jp) if n.startswith("FLAG_")]


def _fields(mtype, rng) -> dict:
    """Seeded values for every field of ``mtype``'s schema, in range."""
    out = {}
    for name, fmt in tp._SCHEMAS[mtype]:
        if fmt == "s":
            out[name] = "".join(chr(int(c)) for c in rng.integers(97, 123, 9))
        elif fmt == "q":
            out[name] = int(rng.integers(-(1 << 40), 1 << 40))
        elif fmt == "Q":
            out[name] = int(rng.integers(0, 1 << 62))
        elif fmt == "I":
            out[name] = int(rng.integers(0, 1 << 32))
        elif fmt == "B":
            out[name] = int(rng.integers(0, 256))
        else:  # "d"
            out[name] = float(rng.random())
    return out


def _pair(mtype, fields, data=b"", flags=0):
    return (tp.Message(tp.MsgType(int(mtype)), dict(fields), data, flags),
            jp.Message(jp.MsgType(int(mtype)), dict(fields), data, flags))


def test_constants_are_the_jax_packages():
    assert (tp.MAGIC, tp.VERSION, tp.HEADER.format, tp.MAX_PAYLOAD) == (
        jp.MAGIC, jp.VERSION, jp.HEADER.format, jp.MAX_PAYLOAD)
    assert {n: getattr(tp, n) for n in FLAG_NAMES} == {
        n: getattr(jp, n) for n in FLAG_NAMES}
    assert {m.name: int(m) for m in tp.MsgType} == {m.name: int(m) for m in jp.MsgType}
    assert {e.name: int(e) for e in tp.ErrCode} == {e.name: int(e) for e in jp.ErrCode}
    assert tp.WIRE_KIND == jp.WIRE_KIND and tp.WIRE_KIND_INV == jp.WIRE_KIND_INV
    for t in PORT_TYPES:
        assert tp._SCHEMAS[t] == jp._SCHEMAS[jp.MsgType(int(t))], t.name
        assert tp.VALID_FLAGS.get(t, 0) == jp.VALID_FLAGS.get(jp.MsgType(int(t)), 0)
    assert tpolicy.PROFILE_TAIL.format == jpolicy.PROFILE_TAIL.format
    assert tpolicy.pack_profile(0, 5 << 30, 77) == jpolicy.pack_profile(0, 5 << 30, 77)


@pytest.mark.parametrize("mtype", PORT_TYPES, ids=lambda t: t.name)
def test_pack_is_byte_equal(mtype):
    rng = np.random.default_rng(int(mtype))
    fields = _fields(mtype, rng)
    for data in (b"", rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()):
        t, j = _pair(mtype, fields, data)
        assert tp.pack(t) == jp.pack(j)
    # Every flag bit the type may carry, at once.
    flags = tp.VALID_FLAGS.get(mtype, 0)
    t, j = _pair(mtype, fields, b"\x01\x02", flags)
    assert tp.pack(t) == jp.pack(j)


@pytest.mark.parametrize("mtype", PORT_TYPES, ids=lambda t: t.name)
def test_unpack_of_jax_frames(mtype):
    rng = np.random.default_rng(100 + int(mtype))
    fields = _fields(mtype, rng)
    for data in (b"", b"tail", rng.integers(0, 256, 1 << 17, dtype=np.uint8).tobytes()):
        frame = jp.pack(jp.Message(jp.MsgType(int(mtype)), fields, data,
                                   jp.VALID_FLAGS.get(jp.MsgType(int(mtype)), 0)))
        got = tp.unpack(frame[:tp.HEADER.size], frame[tp.HEADER.size:])
        want = jp.unpack(frame[:jp.HEADER.size], frame[jp.HEADER.size:])
        assert int(got.type) == int(want.type)
        assert got.fields == want.fields
        assert bytes(got.data) == bytes(want.data) == data
        assert got.flags == want.flags


def test_connect_with_a_qos_profile_tail():
    """The frame the serving harness's cold client sends (PRIO_LOW)."""
    fields = {"pid": 4242, "rank": 0}
    flags = tp.FLAG_CAP_QOS | tp.FLAG_QOS_TAIL
    t, j = _pair(tp.MsgType.CONNECT, fields,
                 tpolicy.pack_profile(tpolicy.PRIO_LOW, 0, 0), flags)
    assert tp.pack(t) == jp.pack(j)


@pytest.mark.parametrize("case", ["bad_flag", "oversize", "missing_field",
                                  "no_schema", "bad_magic", "truncated"])
def test_codec_errors_match(case):
    """The same malformed input raises the same error class in both."""
    def run(m):
        if case == "bad_flag":
            m.pack(m.Message(m.MsgType.STATUS, {}, b"", m.FLAG_MORE))
        elif case == "oversize":
            m.pack(m.Message(m.MsgType.DATA_PUT, {"alloc_id": 1, "offset": 0,
                                                  "nbytes": 1},
                             b"\0" * (m.MAX_PAYLOAD + 1)))
        elif case == "missing_field":
            m.pack(m.Message(m.MsgType.REQ_FREE, {"alloc_id": 1}))
        elif case == "no_schema":
            # The port's codec is the JAX package's whole table since the
            # daemon came over: both refuse the one type with no schema.
            m.pack(m.Message(m.MsgType.ADD_NODE_OK, {"x": 1}))
        elif case == "bad_magic":
            m.unpack(b"XXXX" + bytes(8), b"")
        else:
            frame = jp.pack(jp.Message(jp.MsgType.ERROR, {"code": 1, "detail": "abc"}))
            m.unpack(frame[:12][:8] + struct.pack("<I", 5), frame[12:17])
    errs = []
    for m in (jp, tp):
        with pytest.raises(Exception) as ei:
            run(m)
        errs.append(type(ei.value).__name__)
    assert errs[0] == errs[1] == "OcmProtocolError"


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_send_recv_interoperate(direction, rng):
    a, b = socket.socketpair()
    src, dst = (jp, tp) if direction == "jax_to_port" else (tp, jp)
    payload = rng.integers(0, 256, 300000, dtype=np.uint8)

    def send():  # the frames outgrow the socket buffer: send from a thread
        src.send_msg(a, src.Message(src.MsgType.DATA_GET_OK, {"nbytes": 300000},
                                    [payload[:100000], payload[100000:]]))
        src.send_msg(a, src.Message(src.MsgType.HEARTBEAT,
                                    {"rank": 1, "pid": 7, "owners": "1,2"}))

    sender = threading.Thread(target=send)
    sender.start()
    try:
        into = bytearray(300000)
        got = dst.recv_msg(b, data_into=memoryview(into))
        assert got.fields == {"nbytes": 300000}
        assert bytes(into) == payload.tobytes()
        assert dst.recv_msg(b).fields == {"rank": 1, "pid": 7, "owners": "1,2"}
    finally:
        sender.join(timeout=30)
        assert not sender.is_alive()
        a.close()
        b.close()


def test_request_raises_the_typed_error_and_stays_in_sync():
    a, b = socket.socketpair()
    try:
        jp.send_msg(b, jp.Message(jp.MsgType.ERROR,
                                  {"code": int(jp.ErrCode.BOUNDS), "detail": "x"}))
        jp.send_msg(b, jp.Message(jp.MsgType.STATUS_OK, {
            "rank": 0, "nnodes": 2, "live_allocs": 3, "host_bytes_live": 4,
            "device_bytes_live": 5}))
        with pytest.raises(tp.OcmRemoteError) as ei:
            tp.request(a, tp.Message(tp.MsgType.STATUS, {}))
        assert ei.value.code == int(tp.ErrCode.BOUNDS)
        jp.recv_msg(b)
        assert tp.request(a, tp.Message(tp.MsgType.STATUS, {})).fields["live_allocs"] == 3
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("code", list(jp.ErrCode), ids=lambda c: c.name)
def test_remote_error_maps_every_code(code):
    tails = {
        jp.ErrCode.BUSY: struct.pack("<I", 250),
        jp.ErrCode.MOVED: struct.pack("<q", 3),
        jp.ErrCode.STALE_EPOCH: struct.pack("<QQ", 5, 9),
        jp.ErrCode.NOT_MASTER: jp.pack_leader_tail(2, "10.0.0.2", 17980),
    }
    fields = {"code": int(code), "detail": f"detail of {code.name}"}
    data = tails.get(code, b"")
    errs = []
    for m in (jp, tp):
        frame = jp.pack(jp.Message(jp.MsgType.ERROR, fields, data))
        errs.append(m.remote_error(m.unpack(frame[:12], frame[12:])))
    je, te = errs
    assert type(je).__name__ == type(te).__name__ == "OcmRemoteError"
    assert (je.code, je.detail, str(je)) == (te.code, te.detail, str(te))
    for attr in ("retry_after_ms", "moved_to_rank", "verdict_leader_epoch",
                 "verdict_epoch", "leader_rank", "leader_addr"):
        assert getattr(je, attr, None) == getattr(te, attr, None), attr
