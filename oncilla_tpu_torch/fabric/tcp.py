"""The framed-TCP data plane: the port's copy of the striping and the
pipelined window of ``oncilla_tpu/fabric/tcp.py`` (``plan_stripes`` :107,
``stripe_windowed`` :164).

A transfer of ``total`` bytes splits into up to ``dcn_stripes`` contiguous
stripes, each on its own pooled connection; within a stripe, chunks of
``chunk_bytes`` go out with at most ``inflight_ops`` requests in flight and
one reply consumed per chunk in FIFO order (the reference's 2-posted-
commands scheme, extoll.c:47-173). The plan is fixed by the config: the
JAX package's per-peer window tuner and ACK coalescing are not ported, so
every chunk is answered (the lockstep-compatible protocol every daemon
serves).
"""

from __future__ import annotations

import numpy as np

from oncilla_tpu_torch.core.errors import OcmProtocolError, OcmRemoteError
from oncilla_tpu_torch.runtime.protocol import (
    Message,
    MsgType,
    RecvScratch,
    recv_msg,
    remote_error,
    send_msg,
)
from oncilla_tpu_torch.utils.config import OcmConfig


def plan_stripes(config: OcmConfig, total: int) -> int:
    """How many stripes a ``total``-byte transfer is worth: at most
    ``dcn_stripes``, and few enough that each moves at least
    ``dcn_stripe_min_bytes``."""
    per = max(1, config.dcn_stripe_min_bytes)
    return max(1, min(config.dcn_stripes, total // per))


def stripe_windowed(s, handle, start: int, length: int, offset: int,
                    put_mv, get_arr, chunk: int, window: int) -> None:
    """The pipelined window over one stripe's range ``[start, start +
    length)`` of the transfer: ``put_mv`` (a byte memoryview of the source)
    for a put, ``get_arr`` (the flat uint8 destination) for a get. Offsets
    on the wire are absolute, so a failed stripe can be re-run whole.

    On an ERROR reply the replies of the chunks already in flight are
    drained before the typed error is raised, so the connection stays in
    sync and can go back to the pool."""
    window = max(1, window)
    is_put = put_mv is not None
    get_mv = memoryview(get_arr) if get_arr is not None else None
    end = start + length
    inflight: list[tuple[int, int]] = []  # (pos, nbytes)
    pos = start
    failure: OcmRemoteError | None = None
    # Each reply is consumed before the next recv: the RecvScratch contract.
    scratch = RecvScratch()
    while pos < end or inflight:
        while pos < end and len(inflight) < window and failure is None:
            n = min(chunk, end - pos)
            fields = {"alloc_id": handle.alloc_id, "offset": offset + pos,
                      "nbytes": n}
            if is_put:
                req = Message(MsgType.DATA_PUT, fields, put_mv[pos:pos + n])
            else:
                req = Message(MsgType.DATA_GET, fields)
            send_msg(s, req)
            inflight.append((pos, n))
            pos += n
        if not inflight:
            break
        # Replies are FIFO, so the expected chunk's destination is known
        # before the recv: a matching DATA_GET_OK lands in place.
        c_pos, n = inflight[0]
        sink = (get_mv[c_pos:c_pos + n]
                if get_mv is not None and failure is None else None)
        r = recv_msg(s, scratch, data_into=sink)
        inflight.pop(0)
        if r.type == MsgType.ERROR:
            # Remember the first failure; keep draining the replies of
            # chunks already on the wire.
            if failure is None:
                failure = remote_error(r)
        elif failure is None:
            want = MsgType.DATA_PUT_OK if is_put else MsgType.DATA_GET_OK
            if r.type != want or r.fields.get("nbytes") != n:
                raise OcmProtocolError(
                    f"unexpected {r.type.name} {r.fields} for a {n} B chunk")
            if sink is not None and r.data is sink:
                continue  # payload already landed in place
            if not is_put:
                got = np.frombuffer(r.data, dtype=np.uint8)
                if got.size != n:
                    raise OcmProtocolError(
                        f"DATA_GET_OK carried {got.size} B for a {n} B chunk")
                get_arr[c_pos:c_pos + n] = got
    if failure is not None:
        raise failure
