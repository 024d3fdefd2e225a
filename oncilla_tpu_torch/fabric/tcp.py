"""The framed-TCP data plane as a fabric backend — the zeroth fabric.

The port's copy of ``oncilla_tpu/fabric/tcp.py``, line for line, with one
check more: a windowed reply of the wrong type or length is a protocol
error (the stream is out of step), never bytes landed.

This is the striped / ACK-coalesced / adaptively windowed engine the
client grew, re-homed out of ``runtime/client.py``: the stripe
loops and the per-peer tuner live here; the client keeps only the
policy that is fabric-independent (stripe thread fan-out, the failover
ladder, handle repointing). Every peer pair can always run this backend
— it IS the wire protocol — so fabric negotiation treats it as the
universal fallback, selected by silence.

Contracts preserved from the client-resident engine:

- :func:`stripe_windowed` is the lockstep-compatible pipelined window —
  the pre-capability protocol unchanged, valid against ANY v2 daemon,
  and the only get path (get replies carry the data; nothing coalesces).
- :func:`stripe_put_coalesced` requires the peer to have granted
  FLAG_CAP_COALESCE: every chunk but the last carries FLAG_MORE and the
  daemon answers ONCE per burst. Both serving implementations grant it —
  the Python daemon and the native C++ daemon since its epoll
  data plane landed — so the lockstep fallback is for OLD v2 peers only.
- Both carry absolute offsets, so a retryable failure mid-stripe gets a
  full idempotent re-run of that stripe by the caller's ladder.
"""

from __future__ import annotations

import time

import numpy as np

from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.errors import OcmProtocolError, OcmRemoteError
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.obs import trace as obs_trace
from oncilla_tpu_torch.runtime.protocol import (
    FLAG_MORE,
    FLAG_TRACE_CTX,
    Message,
    MsgType,
    RecvScratch,
    recv_msg,
    remote_error,
    send_msg,
)
from oncilla_tpu_torch.utils.config import MAX_CHUNK_BYTES, OcmConfig


class PeerTuner:
    """Adaptive windowing for one owner daemon: autotunes the pipelined
    window depth and chunk size from observed per-chunk RTT instead of
    pinning the hardcoded ``inflight_ops`` × ``chunk_bytes``.

    Two rules, both damped to one step per completed transfer so a single
    noisy measurement cannot swing the plan:

    - **window** targets pipe-fill: enough chunks in flight to cover one
      observed RTT at the achieved rate (+1 for the send leg), clamped to
      [2, 8] — beyond that the extra requests only queue at the daemon.
    - **chunk** amortizes per-op overhead: p50 RTT under ~20 ms means the
      frame overhead is a visible fraction (double the chunk, up to the
      wire cap); over ~250 ms means one chunk monopolizes the stream and
      retry/error latency balloons (halve, floor 1 MiB).

    Shared across concurrent stripes to the same peer; all state moves
    under one leaf lock.
    """

    MIN_WINDOW, MAX_WINDOW = 2, 8
    MIN_CHUNK = 1 << 20

    def __init__(self, config: OcmConfig):
        self.adaptive = config.dcn_adaptive
        self._window = max(1, config.inflight_ops)
        self._chunk = config.chunk_bytes
        self._lock = make_lock("client._tuner_lock")

    def plan(self) -> tuple[int, int]:
        """Current (chunk_bytes, window) to run a stripe with."""
        with self._lock:
            return self._chunk, self._window

    def observe(self, rtt_p50_s: float, achieved_bps: float) -> None:
        """Feed one completed stripe's p50 chunk RTT + achieved bytes/s."""
        if not self.adaptive or rtt_p50_s <= 0:
            return
        with self._lock:
            prev = (self._window, self._chunk)
            if achieved_bps > 0:
                per_chunk_s = self._chunk / achieved_bps
                want = round(rtt_p50_s / per_chunk_s) + 1
                want = min(self.MAX_WINDOW, max(self.MIN_WINDOW, want))
                self._window += (want > self._window) - (want < self._window)
            if rtt_p50_s < 0.02 and self._chunk * 2 <= MAX_CHUNK_BYTES:
                self._chunk *= 2
            elif rtt_p50_s > 0.25 and self._chunk // 2 >= self.MIN_CHUNK:
                self._chunk //= 2
            cur = (self._window, self._chunk)
        if cur != prev:
            obs_journal.record(
                "tuner_window",
                window=cur[0], chunk_bytes=cur[1],
                prev_window=prev[0], prev_chunk_bytes=prev[1],
                rtt_p50_us=round(rtt_p50_s * 1e6, 1),
            )


def plan_stripes(config: OcmConfig, total: int) -> int:
    """How many stripes a ``total``-byte transfer is worth: capped by
    config, and shrunk so each stripe moves at least
    ``dcn_stripe_min_bytes`` (a thread + socket per few hundred KiB
    would cost more than the parallelism buys). Under the mux runtime
    (OCM_MUX) striped transfers ride the peer's ONE shared channel —
    pipelining inside the connection replaces parallel sockets, so the
    plan is always a single stripe."""
    if config.mux:
        return 1
    per = max(1, config.dcn_stripe_min_bytes)
    return max(1, min(config.dcn_stripes, total // per))


def stripe_put_coalesced(
    s, handle, start, length, offset, put_mv, chunk, tctx=None,
) -> None:
    """ACK-coalesced put burst: every chunk but the last carries
    FLAG_MORE, the daemon applies them silently and answers ONCE at
    the final chunk — the stripe streams at TCP speed instead of
    lockstepping a reply per chunk. One reply per burst also means
    the error path stays in sync: a burst ERROR arrives exactly where
    the single ACK would.

    Trace context (``tctx``) rides the burst-CLOSING chunk only: a
    prefix on every chunk would disqualify each one from the daemon's
    zero-copy recv-into-arena landing, and one stitched hop per burst
    is all the exported trace needs."""
    end = start + length
    pos = start
    while pos < end:
        n = min(chunk, end - pos)
        last = pos + n >= end
        req = Message(
            MsgType.DATA_PUT,
            {
                "alloc_id": handle.alloc_id,
                "offset": offset + pos,
                "nbytes": n,
            },
            put_mv[pos:pos + n],
            flags=0 if last else FLAG_MORE,
        )
        if last and tctx is not None:
            obs_trace.attach(req, tctx, FLAG_TRACE_CTX)
        send_msg(s, req)
        pos += n
    r = recv_msg(s)
    if r.type == MsgType.ERROR:
        raise remote_error(r)
    if r.type != MsgType.DATA_PUT_OK or r.fields["nbytes"] != length:
        raise OcmProtocolError(
            f"coalesced burst ack mismatch: {r.type.name} "
            f"{r.fields.get('nbytes')} != {length}"
        )


def stripe_windowed(
    s, handle, start, length, offset, put_mv, get_arr,
    chunk, window, rtts: list, tctx=None,
) -> None:
    """The lockstep-compatible pipelined window over one stripe's
    range [start, start+length): up to ``window`` requests in flight,
    one reply consumed per chunk in FIFO order. Runs against ANY v2
    daemon (it is the pre-capability protocol unchanged) and doubles
    as the get path everywhere — get replies carry the data, so there
    is nothing to coalesce.

    Trace context: every DATA_GET carries it (the request has no
    payload, so the 16-byte prefix costs nothing); DATA_PUT carries
    it on the stripe's FINAL chunk only, preserving the body chunks'
    zero-copy recv-into-arena eligibility at the daemon."""
    window = max(1, window)
    is_put = put_mv is not None
    get_mv = memoryview(get_arr) if get_arr is not None else None
    end = start + length
    inflight: list[tuple[int, int, float]] = []  # (pos, nbytes, t_send)
    pos = start
    failure: OcmRemoteError | None = None
    # Reusable reply buffer: each DATA_GET_OK chunk is consumed
    # before the next recv, the RecvScratch contract (per stripe,
    # because the scratch is per socket).
    scratch = RecvScratch()
    while pos < end or inflight:
        while pos < end and len(inflight) < window and failure is None:
            n = min(chunk, end - pos)
            if is_put:
                req = Message(
                    MsgType.DATA_PUT,
                    {
                        "alloc_id": handle.alloc_id,
                        "offset": offset + pos,
                        "nbytes": n,
                    },
                    put_mv[pos:pos + n],
                )
                if tctx is not None and pos + n >= end:
                    obs_trace.attach(req, tctx, FLAG_TRACE_CTX)
            else:
                req = Message(
                    MsgType.DATA_GET,
                    {
                        "alloc_id": handle.alloc_id,
                        "offset": offset + pos,
                        "nbytes": n,
                    },
                )
                if tctx is not None:
                    obs_trace.attach(req, tctx, FLAG_TRACE_CTX)
            send_msg(s, req)
            inflight.append((pos, n, time.perf_counter()))
            pos += n
        if not inflight:
            break
        # Replies are FIFO, so the expected chunk's destination is
        # known BEFORE the recv: a matching fixed-field reply
        # (DATA_GET_OK) lands its payload straight in the disjoint
        # destination view — no scratch hop, no copy. An ERROR reply
        # (strings) or a length mismatch ignores the sink and takes
        # the normal path below.
        sink = (
            get_mv[inflight[0][0]:inflight[0][0] + inflight[0][1]]
            if get_mv is not None and failure is None else None
        )
        r = recv_msg(s, scratch, data_into=sink)
        c_pos, n, t_send = inflight.pop(0)
        rtts.append(time.perf_counter() - t_send)
        if r.type == MsgType.ERROR:
            # Remember the first failure; keep draining replies
            # for chunks already on the wire.
            if failure is None:
                # remote_error, not a bare code+detail: a MOVED reply's
                # rank tail is the redirect the failover ladder follows.
                failure = remote_error(r)
        elif failure is None:
            want = MsgType.DATA_PUT_OK if is_put else MsgType.DATA_GET_OK
            if r.type != want or r.fields.get("nbytes") != n:
                raise OcmProtocolError(
                    f"unexpected {r.type.name} {r.fields} for a {n} B chunk")
            if sink is not None and r.data is sink:
                continue  # payload already landed in place
            if not is_put and get_arr is not None:
                try:
                    get_arr[c_pos:c_pos + n] = np.frombuffer(
                        r.data, dtype=np.uint8
                    )
                except (OSError, OcmProtocolError):
                    raise
                except Exception as exc:
                    # A reply that parses as a frame but whose payload
                    # doesn't decode (wrong length for np.frombuffer,
                    # bad field types) means the stream is desynced:
                    # a transport failure, not an application error.
                    raise OcmProtocolError(
                        f"malformed {r.type.name} reply payload: {exc}"
                    ) from exc
    if failure is not None:
        raise failure
