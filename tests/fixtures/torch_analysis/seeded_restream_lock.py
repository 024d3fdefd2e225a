"""Seeded violation: a per-allocation re-replication stream lock held
across the DATA_PUT to the new replica (rpcgraph ``lock-across-rpc``),
the lock shape of the port daemon's ``_on_re_replicate``.

Scanned explicitly by tests/test_torch_rpcgraph.py — excluded from
default ``python -m oncilla_tpu_torch.analysis`` walks. A suppression
counts only on the line the finding names, the dialling call: the
comment on the ``with`` line (``seeded_suppressed_on_with_line``) covers
nothing, so exactly ONE ``lock-across-rpc`` finding fires;
``ok_suppressed_on_call_line`` carries it where the finding lands.
"""

from oncilla_tpu_torch.analysis.lockwatch import make_lock

FLAG_FANOUT = 0x0100


class MsgType:
    DATA_PUT = 30


def Message(msgtype, fields, data=b"", flags=0):
    return (msgtype, fields, data, flags)


class Daemon:
    def __init__(self, peers):
        self.peers = peers

    def seeded_suppressed_on_with_line(self, host, port, alloc_id, chunk):
        restream = make_lock("fixture.daemon._restream_lock")
        with restream:  # ocm-lint: allow[lock-across-rpc]
            self.peers.request(  # FINDING
                host, port,
                Message(MsgType.DATA_PUT,
                        {"alloc_id": alloc_id, "offset": 0,
                         "nbytes": len(chunk)},
                        chunk, flags=FLAG_FANOUT),
            )

    def ok_suppressed_on_call_line(self, host, port, alloc_id, chunk):
        restream = make_lock("fixture.daemon._restream_lock")
        with restream:
            self.peers.request(  # ocm-lint: allow[lock-across-rpc]
                host, port,
                Message(MsgType.DATA_PUT,
                        {"alloc_id": alloc_id, "offset": 0,
                         "nbytes": len(chunk)},
                        chunk, flags=FLAG_FANOUT),
            )
