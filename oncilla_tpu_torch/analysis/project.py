"""Whole-project checks that need the real modules, not just their ASTs.

Protocol exhaustiveness: the wire protocol (runtime/protocol.py) and the
daemon dispatch table (runtime/daemon.py) evolve in different PRs; a
request type added to one but not the other turns into a runtime
``BAD_MSG`` error under load — exactly the class of drift a static gate
should catch at commit time. The roundtrip check packs a synthetic message
of every schema and decodes it back, so a schema whose field formats
disagree with the codec fails here rather than on the wire.
"""

from __future__ import annotations

from oncilla_tpu_torch.analysis.lint import Finding

# Reply/notification suffixes: types a daemon SENDS but never dispatches.
_REPLY_SUFFIXES = ("_OK", "_CONFIRM", "_RESULT", "_PLACED")

_DUMMY = {"q": -3, "Q": 7, "I": 5, "B": 2, "H": 4, "d": 1.5, "s": "héllo"}


def _is_request(name: str) -> bool:
    return not name.endswith(_REPLY_SUFFIXES) and name != "ERROR"


def check_protocol() -> list[Finding]:
    from oncilla_tpu_torch.runtime import daemon, protocol

    findings: list[Finding] = []
    path = "oncilla_tpu_torch/runtime/protocol.py"

    def flag(symbol: str, message: str, where: str = path) -> None:
        findings.append(Finding(
            rule="protocol-exhaustiveness", path=where, line=0,
            symbol=symbol, message=message,
        ))

    schemas = protocol._SCHEMAS
    for t in protocol.MsgType:
        if t not in schemas:
            flag(t.name, f"MsgType.{t.name} has no payload schema")
    handled = set(daemon._HANDLERS)
    for t in protocol.MsgType:
        if _is_request(t.name) and t not in handled:
            flag(
                t.name,
                f"request MsgType.{t.name} has no daemon handler "
                "(_HANDLERS in runtime/daemon.py)",
                where="oncilla_tpu_torch/runtime/daemon.py",
            )

    # Flag exhaustiveness: every header-flag bit the protocol declares
    # valid on a REQUEST type must be claimed as handled by the daemon
    # (_FLAGS_HANDLED) — an unhandled combination would silently degrade
    # (or desync the reply stream) under load instead of failing here.
    # Declared flags must also survive a pack/unpack roundtrip, and
    # undeclared bits must be REJECTED at pack time.
    flags_handled = getattr(daemon, "_FLAGS_HANDLED", {})
    for t, mask in protocol.VALID_FLAGS.items():
        if t not in schemas:
            continue  # already flagged above
        if _is_request(t.name):
            unhandled = mask & ~flags_handled.get(t, 0)
            if unhandled:
                flag(
                    t.name,
                    f"MsgType.{t.name} declares flag bits {unhandled:#x} in "
                    "VALID_FLAGS with no daemon handling "
                    "(_FLAGS_HANDLED in runtime/daemon.py)",
                    where="oncilla_tpu_torch/runtime/daemon.py",
                )
        fields = {name: _DUMMY[fmt] for name, fmt in schemas[t]}
        msg = protocol.Message(t, dict(fields), b"", flags=mask)
        try:
            buf = protocol.pack(msg)
            out = protocol.unpack(
                bytes(buf[: protocol.HEADER.size]),
                bytes(buf[protocol.HEADER.size:]),
            )
        except Exception as e:  # noqa: BLE001 — any codec blowup is a finding
            flag(t.name, f"MsgType.{t.name} flags={mask:#x} roundtrip "
                         f"raised {type(e).__name__}: {e}")
        else:
            if out.flags != mask:
                flag(t.name, f"MsgType.{t.name} flags {mask:#x} not "
                             f"preserved by the codec (got {out.flags:#x})")
        bad_bit = 0x8000  # no capability uses the top bit
        try:
            protocol.pack(protocol.Message(t, dict(fields), b"",
                                           flags=mask | bad_bit))
        except protocol.OcmProtocolError:
            pass
        else:
            flag(t.name, f"MsgType.{t.name} accepted undeclared flag bit "
                         f"{bad_bit:#x} at pack time")
    for t, mask in flags_handled.items():
        extra = mask & ~protocol.VALID_FLAGS.get(t, 0)
        if extra:
            flag(
                t.name,
                f"daemon claims to handle flag bits {extra:#x} on "
                f"MsgType.{t.name} that VALID_FLAGS never declares",
                where="oncilla_tpu_torch/runtime/daemon.py",
            )

    # Encode/decode roundtrip for every schema, with and without a bulk
    # data tail (the codec must keep fields and data separable).
    for t, schema in schemas.items():
        fields = {name: _DUMMY[fmt] for name, fmt in schema}
        for data in (b"", b"\x01\x02\x03"):
            msg = protocol.Message(t, dict(fields), data)
            try:
                buf = protocol.pack(msg)
                out = protocol.unpack(
                    bytes(buf[: protocol.HEADER.size]),
                    bytes(buf[protocol.HEADER.size:]),
                )
            except Exception as e:  # noqa: BLE001 — any codec blowup is a finding
                flag(t.name, f"MsgType.{t.name} roundtrip raised "
                             f"{type(e).__name__}: {e}")
                break
            if out.fields != fields or bytes(out.data) != data:
                flag(t.name, f"MsgType.{t.name} roundtrip mismatch: "
                             f"sent {fields!r}+{data!r}, "
                             f"got {out.fields!r}+{bytes(out.data)!r}")
                break
    return findings
