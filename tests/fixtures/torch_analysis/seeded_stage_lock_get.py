"""Seeded violation: a client's staging lock held across a wire get
(rpcgraph ``lock-across-rpc``), the lock shape of the port's get into a
card tensor before its staging pool (``runtime/client.py`` ``get_into``:
one pinned buffer under ``_stage_lock`` for the whole transfer).

Scanned explicitly by tests/test_torch_rpcgraph.py — excluded from
default ``python -m oncilla_tpu_torch.analysis`` walks. Exactly ONE
``lock-across-rpc`` finding, at the call that dials while the lock is
held; the pooled shape (``ok_get_into_pooled_stage``, the repair) takes
a buffer under the lock and receives with no lock held.
"""

import contextlib
import threading


class MsgType:
    DATA_GET = 32


def Message(msgtype, fields, data=b"", flags=0):
    return (msgtype, fields, data, flags)


class Client:
    def __init__(self, peers):
        self.peers = peers
        self._stage = bytearray(1 << 20)
        self._stage_free = []
        self._stage_lock = threading.Lock()

    def _dcn_get_into(self, handle, out, nbytes, offset):
        fields = {"alloc_id": handle.alloc_id, "offset": offset,
                  "nbytes": nbytes}
        reply = self.peers.request(handle.host, handle.port,
                                   Message(MsgType.DATA_GET, fields))
        out[:nbytes] = reply[2]

    def get_into(self, handle, out, offset=0):
        with self._stage_lock:
            stage = self._stage
            self._dcn_get_into(handle, stage, len(out), offset)  # FINDING
            out[:] = stage[:len(out)]

    @contextlib.contextmanager
    def _staged(self, n):
        with self._stage_lock:
            buf = self._stage_free.pop() if self._stage_free else None
        if buf is None or len(buf) < n:
            buf = bytearray(n)
        try:
            yield buf
        finally:
            with self._stage_lock:
                self._stage_free.append(buf)

    def ok_get_into_pooled_stage(self, handle, out, offset=0):
        with self._staged(len(out)) as stage:
            self._dcn_get_into(handle, stage, len(out), offset)  # NOT a finding
            out[:] = stage[:len(out)]
