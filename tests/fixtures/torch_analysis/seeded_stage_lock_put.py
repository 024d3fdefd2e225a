"""Seeded violation: a client's staging lock held across a wire put
(rpcgraph ``lock-across-rpc``), the lock shape of the port's card-tensor
REMOTE put before its staging pool (``runtime/client.py`` ``put``: one
pinned buffer under ``_stage_lock`` for the whole transfer).

Scanned explicitly by tests/test_torch_rpcgraph.py — excluded from
default ``python -m oncilla_tpu_torch.analysis`` walks. Exactly ONE
``lock-across-rpc`` finding, at the call that dials while the lock is
held; the pooled shape (``ok_put_from_pooled_stage``, the repair) takes a
buffer under the lock and sends with no lock held.
"""

import contextlib
import threading


class MsgType:
    DATA_PUT = 30


def Message(msgtype, fields, data=b"", flags=0):
    return (msgtype, fields, data, flags)


class Client:
    def __init__(self, peers):
        self.peers = peers
        self._stage = bytearray(1 << 20)
        self._stage_free = []
        self._stage_lock = threading.Lock()

    def _dcn_put(self, handle, raw, offset):
        fields = {"alloc_id": handle.alloc_id, "offset": offset,
                  "nbytes": len(raw)}
        return self.peers.request(handle.host, handle.port,
                                  Message(MsgType.DATA_PUT, fields, raw))

    def put(self, handle, data, offset=0):
        with self._stage_lock:
            stage = self._stage
            stage[:len(data)] = data
            self._dcn_put(handle, stage[:len(data)], offset)  # FINDING

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

    def ok_put_from_pooled_stage(self, handle, data, offset=0):
        with self._staged(len(data)) as stage:
            stage[:len(data)] = data
            self._dcn_put(handle, stage[:len(data)], offset)  # NOT a finding
