"""Cross-language wire-conformance analysis.

The wire protocol is spoken by two independent implementations — the
Python daemon (``runtime/protocol.py`` + ``runtime/daemon.py``) and the
C++ native daemon (``runtime/native/protocol.hh/.cc`` + ``daemon.cc``).
The native side "declines by silence" (typed ``BAD_MSG`` for whole
message families), so drift between the two surfaces never fails loudly
at runtime: a missed dispatch case, a stale enum value, or a capability
granted-but-not-implemented all look like a peer politely declining.
This module makes the protocol surface itself a statically checked
artifact:

====================  ==================================================
rule                  violated when
====================  ==================================================
``native-enum-drift``   a C++ ``MsgType``/``ErrCode`` member's value (or
                        name) disagrees with the Python enum, or a
                        schema entry / dispatch case references an enum
                        member that does not exist
``native-schema-drift`` a shared type's C++ field schema (names, struct
                        formats, order) disagrees with ``_SCHEMAS``, or
                        an enum member has no native schema at all
``native-dispatch-gap`` a C++ enum request type with a schema never
                        appears as a ``case`` in ``daemon.cc``'s
                        dispatch switch (half-added: decodes, then
                        answers ``BAD_MSG``)
``native-caps-overgrant`` a ``caps_mask_`` assignment grants a bit
                        outside ``kCapsImplemented`` — the CONNECT echo
                        would promise a capability the daemon cannot
                        serve
``flag-parity``         a ``kFlag*`` constant's value disagrees with its
                        ``FLAG_*`` twin
``fenced-reject-gap``   a state-mutating request type is missing from
                        the daemon's ``_FENCED_REJECT`` set (or a new
                        request type is not classified at all)
``flag-sites``          a declared flag bit has no daemon-side handle
                        site, a data-tail flag has no strip site, or a
                        capability offered in ``VALID_FLAGS`` has no
                        grant site in ``_on_connect``
``strip-order``         a function strips (or attaches) the data-tail
                        prefixes out of order — receive order is tag,
                        then trace, then deadline; attach is the exact
                        reverse (deadline innermost first)
``audit-event-unemitted`` an ``obs/audit.py`` invariant consumes a
                        journal event name with no emission site in the
                        Python package or the native daemon
``journal-event-unchecked`` (info) an event is emitted but no audit
                        invariant ever consumes it — dead telemetry,
                        reported but never fatal
``matrix-drift``        the generated capability/parity matrix block in
                        ``oncilla_tpu_torch/docs/ARCHITECTURE.md`` differs
                        from the one derived from the two surfaces
                        (regenerate:
                        ``python -m oncilla_tpu_torch.analysis
                        --write-matrix``)
====================  ==================================================

The C++ side is parsed lexically (regex + brace matching — the files are
our own, formatted by clang-format, and a parse miss fails loudly as a
finding, never silently). The Python side uses the live modules for the
enums/tables (authoritative) and the AST for grant/strip/reference
sites. Runs only on default (whole-tree) scans, like
:func:`~oncilla_tpu_torch.analysis.project.check_protocol`.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from oncilla_tpu_torch.analysis.lint import Finding

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG_DIR)

CONFORMANCE_RULES = frozenset({
    "native-enum-drift", "native-schema-drift", "native-dispatch-gap",
    "native-caps-overgrant", "flag-parity", "fenced-reject-gap",
    "flag-sites", "strip-order", "audit-event-unemitted",
    "journal-event-unchecked", "matrix-drift", "relay-class-gap",
})

#: Rules reported for visibility but never fatal (exit code unaffected).
INFO_RULES = frozenset({"journal-event-unchecked"})

# C++ -> Python name aliases (the single deliberate divergence).
_MSG_ALIAS = {"ERR": "ERROR"}

_HH = "oncilla_tpu_torch/runtime/native/protocol.hh"
_CC = "oncilla_tpu_torch/runtime/native/protocol.cc"
_DC = "oncilla_tpu_torch/runtime/native/daemon.cc"
_DAEMON_PY = "oncilla_tpu_torch/runtime/daemon.py"
_AUDIT_PY = "oncilla_tpu_torch/obs/audit.py"
_ARCH_MD = "oncilla_tpu_torch/docs/ARCHITECTURE.md"

MATRIX_BEGIN = ("<!-- BEGIN capability-matrix — generated by "
                "`python -m oncilla_tpu_torch.analysis --write-matrix`; "
                "the conformance analysis fails on drift -->")
MATRIX_END = "<!-- END capability-matrix -->"


def _line_of(src: str, idx: int) -> int:
    return src.count("\n", 0, idx) + 1


# -- the native (C++) surface -------------------------------------------


@dataclass
class NativeSurface:
    """Everything the C++ implementation says about the wire."""

    msg_values: dict[str, int] = field(default_factory=dict)
    msg_lines: dict[str, int] = field(default_factory=dict)
    err_values: dict[str, int] = field(default_factory=dict)
    flag_values: dict[str, int] = field(default_factory=dict)
    caps_implemented: int = 0
    #: every bit any ``caps_mask_ = ...`` assignment can grant
    caps_granted: int = 0
    #: kFlagCapTrace grant is conditional on ``obs_enabled_``
    trace_gated: bool = False
    schemas: dict[str, list[tuple[str, str]]] = field(default_factory=dict)
    schema_lines: dict[str, int] = field(default_factory=dict)
    dispatch: dict[str, int] = field(default_factory=dict)  # name -> line
    problems: list[str] = field(default_factory=list)


def _parse_enum_block(src: str, name: str) -> tuple[dict[str, int],
                                                    dict[str, int]]:
    m = re.search(rf"enum class {name}\s*:\s*\w+\s*\{{", src)
    if m is None:
        return {}, {}
    body = src[m.end(): src.index("};", m.end())]
    values: dict[str, int] = {}
    lines: dict[str, int] = {}
    for em in re.finditer(r"^\s*(\w+)\s*=\s*(\d+)\s*,?", body, re.M):
        values[em.group(1)] = int(em.group(2))
        lines[em.group(1)] = _line_of(src, m.end() + em.start(1))
    return values, lines


def _resolve_flag_expr(expr: str, flags: dict[str, int]) -> int:
    """OR together every flag token in a C++ constant expression (both
    ternary branches count — we want the set of grantable bits)."""
    mask = 0
    for tok in re.findall(r"kFlag\w+|kCapsImplemented|0x[0-9a-fA-F]+|\b\d+\b",
                          expr):
        if tok.startswith("0x"):
            mask |= int(tok, 16)
        elif tok.isdigit():
            mask |= int(tok)
        elif tok in flags:
            mask |= flags[tok]
    return mask


def _function_body(src: str, signature: str) -> tuple[str, int]:
    """The brace-matched body of the function whose definition contains
    ``signature``; ('', 0) when absent."""
    idx = src.find(signature)
    if idx < 0:
        return "", 0
    open_idx = src.index("{", idx)
    depth = 0
    for i in range(open_idx, len(src)):
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
            if depth == 0:
                return src[open_idx:i + 1], open_idx
    return src[open_idx:], open_idx


def extract_native(native_dir: str | None = None) -> NativeSurface:
    """Parse the C++ wire surface out of protocol.hh/.cc + daemon.cc."""
    nd = native_dir or os.path.join(_ROOT, "oncilla_tpu_torch", "runtime", "native")
    nat = NativeSurface()

    def read(name: str) -> str:
        p = os.path.join(nd, name)
        try:
            with open(p, encoding="utf-8") as fh:
                return fh.read()
        except OSError as e:
            nat.problems.append(f"{name}: unreadable ({e})")
            return ""

    hh = read("protocol.hh")
    nat.msg_values, nat.msg_lines = _parse_enum_block(hh, "MsgType")
    nat.err_values, _ = _parse_enum_block(hh, "ErrCode")
    if hh and not nat.msg_values:
        nat.problems.append("protocol.hh: MsgType enum not found")
    for fm in re.finditer(
        r"constexpr uint16_t (kFlag\w+|kCapsImplemented)\s*=\s*([^;]+);", hh
    ):
        name, expr = fm.group(1), fm.group(2)
        if name == "kCapsImplemented":
            nat.caps_implemented = _resolve_flag_expr(expr, nat.flag_values)
        else:
            nat.flag_values[name] = _resolve_flag_expr(expr, nat.flag_values)

    cc = read("protocol.cc")
    sm = re.search(r"kSchemas\s*=\s*\{", cc)
    if sm is not None:
        body = cc[sm.end(): cc.index("};", sm.end())]
        for chunk in re.finditer(
            r"\{MsgType::(\w+),((?:(?!\{MsgType::).)*)", body, re.S
        ):
            name = chunk.group(1)
            nat.schemas[name] = re.findall(
                r"\{\"(\w+)\",\s*'(.)'\}", chunk.group(2)
            )
            nat.schema_lines[name] = _line_of(cc, sm.end() + chunk.start(1))
    elif cc:
        nat.problems.append("protocol.cc: kSchemas map not found")

    dc = read("daemon.cc")
    body, off = _function_body(dc, "Message dispatch(")
    if dc and not body:
        nat.problems.append("daemon.cc: dispatch() switch not found")
    for cm in re.finditer(r"case MsgType::(\w+)\s*:", body):
        nat.dispatch.setdefault(
            cm.group(1), _line_of(dc, off + cm.start(1))
        )
    for am in re.finditer(r"caps_mask_\s*=\s*([^;]+);", dc):
        nat.caps_granted |= _resolve_flag_expr(am.group(1), nat.flag_values)
        if "obs_enabled_" in am.group(1) and "kFlagCapTrace" in am.group(1):
            nat.trace_gated = True
    return nat


# -- the Python surface --------------------------------------------------


@dataclass
class PySurface:
    """Everything the Python implementation says about the wire."""

    msg_values: dict[str, int] = field(default_factory=dict)
    err_values: dict[str, int] = field(default_factory=dict)
    flag_values: dict[str, int] = field(default_factory=dict)   # FLAG_* -> bit
    schemas: dict[str, list[tuple[str, str]]] = field(default_factory=dict)
    valid_flags: dict[str, int] = field(default_factory=dict)
    flags_handled: dict[str, int] = field(default_factory=dict)
    handlers: set[str] = field(default_factory=set)
    fenced: set[str] = field(default_factory=set)
    #: FLAG_CAP_* -> gate condition source ('' = unconditional grant)
    granted: dict[str, str] = field(default_factory=dict)


def _is_request(name: str) -> bool:
    return not name.endswith(("_OK", "_CONFIRM", "_RESULT", "_PLACED")) \
        and name != "ERROR"


def _grant_sites(daemon_tree: ast.Module) -> dict[str, str]:
    """FLAG_CAP_* grant sites in ``Daemon._on_connect``: the
    CONNECT_CONFIRM reply's flags mask (IfExp branches are conditional
    grants) plus any later ``reply.flags |= FLAG_CAP_*``."""
    fn = None
    for node in ast.walk(daemon_tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_on_connect":
            fn = node
            break
    if fn is None:
        return {}
    granted: dict[str, str] = {}
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "Message"
            and node.args
            and ast.unparse(node.args[0]).endswith("CONNECT_CONFIRM")
        ):
            for kw in node.keywords:
                if kw.arg != "flags":
                    continue
                conditional: set[str] = set()
                for sub in ast.walk(kw.value):
                    if isinstance(sub, ast.IfExp):
                        gate = ast.unparse(sub.test)
                        for leaf in list(ast.walk(sub.body)) + list(
                            ast.walk(sub.orelse)
                        ):
                            if isinstance(leaf, ast.Name) and \
                                    leaf.id.startswith("FLAG_CAP_"):
                                granted[leaf.id] = gate
                                conditional.add(leaf.id)
                for sub in ast.walk(kw.value):
                    if isinstance(sub, ast.Name) and \
                            sub.id.startswith("FLAG_CAP_") and \
                            sub.id not in conditional:
                        granted[sub.id] = ""
        if (
            isinstance(node, ast.AugAssign)
            and isinstance(node.op, ast.BitOr)
            and isinstance(node.target, ast.Attribute)
            and node.target.attr == "flags"
        ):
            for leaf in ast.walk(node.value):
                if isinstance(leaf, ast.Name) and \
                        leaf.id.startswith("FLAG_CAP_"):
                    granted.setdefault(leaf.id, "conditional grant")
    return granted


def extract_python(root: str | None = None) -> PySurface:
    from oncilla_tpu_torch.runtime import daemon, protocol

    root = root or _ROOT
    py = PySurface()
    py.msg_values = {t.name: int(t) for t in protocol.MsgType}
    py.err_values = {e.name: int(e) for e in protocol.ErrCode}
    py.flag_values = {
        n: v for n, v in vars(protocol).items()
        if n.startswith("FLAG_") and isinstance(v, int)
    }
    py.schemas = {
        t.name: [(n, f) for n, f in sch]
        for t, sch in protocol._SCHEMAS.items()
    }
    py.valid_flags = {t.name: m for t, m in protocol.VALID_FLAGS.items()}
    py.flags_handled = {t.name: m for t, m in daemon._FLAGS_HANDLED.items()}
    py.handlers = {t.name for t in daemon._HANDLERS}
    py.fenced = {t.name for t in daemon._FENCED_REJECT}

    with open(os.path.join(root, _DAEMON_PY), encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=_DAEMON_PY)
    py.granted = _grant_sites(tree)
    return py


# -- cross-language parity checks ---------------------------------------


def _cpp_flag_to_py(name: str) -> str:
    """kFlagCapCoalesce -> FLAG_CAP_COALESCE."""
    camel = name[len("kFlag"):]
    return "FLAG_" + re.sub(r"(?<!^)(?=[A-Z])", "_", camel).upper()


def check_native_parity(py: PySurface, nat: NativeSurface) -> list[Finding]:
    out: list[Finding] = []

    def flag(rule: str, path: str, line: int, symbol: str, msg: str) -> None:
        out.append(Finding(rule=rule, path=path, line=line,
                           symbol=symbol, message=msg))

    for p in nat.problems:
        flag("native-enum-drift", _HH, 0, "<parse>",
             f"native surface unparseable: {p}")

    # MsgType enum: every native member maps onto the Python enum with
    # the same wire value. (The native enum being a SUBSET is the
    # decline-by-silence design, so the reverse direction is not drift.)
    for name, value in nat.msg_values.items():
        pyname = _MSG_ALIAS.get(name, name)
        if pyname not in py.msg_values:
            flag("native-enum-drift", _HH, nat.msg_lines.get(name, 0), name,
                 f"native MsgType::{name} has no Python MsgType twin")
        elif py.msg_values[pyname] != value:
            flag("native-enum-drift", _HH, nat.msg_lines.get(name, 0), name,
                 f"MsgType::{name} = {value} but Python MsgType.{pyname} = "
                 f"{py.msg_values[pyname]} — same name, different wire byte")
    for name, value in nat.err_values.items():
        if name in py.err_values and py.err_values[name] != value:
            flag("native-enum-drift", _HH, 0, name,
                 f"ErrCode::{name} = {value} but Python ErrCode.{name} = "
                 f"{py.err_values[name]}")
        elif name not in py.err_values:
            flag("native-enum-drift", _HH, 0, name,
                 f"native ErrCode::{name} has no Python ErrCode twin")

    # Schemas: every native schema keys an enum member; shared types'
    # field lists are identical (name, struct format, order); every enum
    # member has a schema (a memberwithout one is half-added — it
    # decodes as UnknownMsgError instead of by its fields).
    for name, sch in nat.schemas.items():
        line = nat.schema_lines.get(name, 0)
        if name not in nat.msg_values:
            flag("native-enum-drift", _CC, line, name,
                 f"protocol.cc has a schema for MsgType::{name} which the "
                 "protocol.hh enum does not define")
            continue
        pyname = _MSG_ALIAS.get(name, name)
        pysch = py.schemas.get(pyname)
        if pysch is not None and sch != pysch:
            flag("native-schema-drift", _CC, line, name,
                 f"MsgType::{name} schema {sch} != Python "
                 f"_SCHEMAS[{pyname}] {pysch}")
    for name in nat.msg_values:
        if name not in nat.schemas:
            flag("native-schema-drift", _CC, 0, name,
                 f"MsgType::{name} is in the enum but has no schema in "
                 "protocol.cc (decodes as UnknownMsgError, not by fields)")

    # Dispatch: every case labels a real enum member; every native
    # request type with a schema is dispatched (else it decodes cleanly
    # and then falls to the default BAD_MSG — a half-ported handler).
    for name, line in nat.dispatch.items():
        if name not in nat.msg_values:
            flag("native-enum-drift", _DC, line, name,
                 f"daemon.cc dispatches MsgType::{name} which the enum "
                 "does not define")
    for name in nat.msg_values:
        pyname = _MSG_ALIAS.get(name, name)
        if (
            _is_request(pyname)
            and name in nat.schemas
            and name not in nat.dispatch
        ):
            flag("native-dispatch-gap", _DC, 0, name,
                 f"request MsgType::{name} has an enum member and a schema "
                 "but no case in daemon.cc's dispatch switch — it decodes, "
                 "then answers BAD_MSG")

    # Capability grants: what CONNECT_CONFIRM can echo must be a subset
    # of what the build implements.
    over = nat.caps_granted & ~nat.caps_implemented
    if over:
        flag("native-caps-overgrant", _DC, 0, "caps_mask_",
             f"caps_mask_ can grant bits {over:#06x} outside "
             f"kCapsImplemented ({nat.caps_implemented:#06x}) — the CONNECT "
             "echo would promise a capability this daemon cannot serve")

    # Flag constants: same bit on both sides of the wire.
    for cname, value in nat.flag_values.items():
        pyname = _cpp_flag_to_py(cname)
        if pyname not in py.flag_values:
            flag("flag-parity", _HH, 0, cname,
                 f"{cname} has no Python {pyname} twin")
        elif py.flag_values[pyname] != value:
            flag("flag-parity", _HH, 0, cname,
                 f"{cname} = {value:#06x} but Python {pyname} = "
                 f"{py.flag_values[pyname]:#06x}")
    return out


# -- fencing classification ---------------------------------------------

# Every request MsgType, classified for the fencing contract
# (daemon.py _FENCED_REJECT: "anything that grants extents or moves
# data" must bounce STALE_EPOCH on a fenced daemon). A request type
# added to the protocol without a row here fails the gate until someone
# decides — which is the point.
#
#   mutating       grants extents, moves bytes, or drives membership/
#                  leadership: MUST be in _FENCED_REJECT
#   cleanup        releases resources; a fenced daemon may still reclaim
#                  (frees, disconnects, cancellation)
#   epoch-control  carries the epoch/membership truth a fenced daemon
#                  needs to learn it was superseded: MUST NOT be fenced
#   read-only      liveness probes and status scrapes
_FENCE_CLASS = {
    "CONNECT": "read-only",
    "DISCONNECT": "cleanup",
    "ADD_NODE": "mutating",
    "REQ_ALLOC": "mutating",
    "DO_ALLOC": "mutating",
    "REQ_FREE": "cleanup",
    "DO_FREE": "cleanup",
    "NOTE_FREE": "cleanup",
    "NOTE_ALLOC": "cleanup",
    "RECLAIM_APP": "cleanup",
    "DATA_PUT": "mutating",
    "DATA_GET": "mutating",
    "HEARTBEAT": "read-only",
    "STATUS": "read-only",
    "STATUS_PROM": "read-only",
    "STATUS_EVENTS": "read-only",
    # The device plane rides the same fencing contract as DATA_*: a
    # fenced owner relaying PLANE_PUT/GET would read or write extents
    # whose ownership a newer epoch already moved, and a fenced master
    # must not accept plane-endpoint registrations (the ADD_NODE rule).
    "PLANE_SERVE": "mutating",
    "PLANE_PUT": "mutating",
    "PLANE_GET": "mutating",
    "PLANE_SCRUB": "mutating",
    "PING": "read-only",
    "SUSPECT_NODE": "mutating",
    "EPOCH_UPDATE": "epoch-control",
    "DO_REPLICA": "mutating",
    "PROMOTE": "epoch-control",
    "RE_REPLICATE": "mutating",
    "SHM_MAP": "mutating",
    "SHM_PUT": "mutating",
    "SHM_GET": "mutating",
    "REQ_JOIN": "mutating",
    "REQ_LEAVE": "mutating",
    "MEMBER_UPDATE": "epoch-control",
    "MIGRATE": "mutating",
    "MIGRATE_BEGIN": "mutating",
    "REQ_LOCATE": "read-only",
    "REQ_EXTENTS": "read-only",
    "MASTER_STATE": "mutating",
    "LEADER_UPDATE": "epoch-control",
    "LEADER_HANDOFF": "mutating",
    "CANCEL": "cleanup",
}


def check_fenced(py: PySurface) -> list[Finding]:
    out: list[Finding] = []
    for name in sorted(py.msg_values):
        if not _is_request(name):
            continue
        cls = _FENCE_CLASS.get(name)
        if cls is None:
            out.append(Finding(
                rule="fenced-reject-gap", path=_DAEMON_PY, line=0,
                symbol=name,
                message=f"request MsgType.{name} is not classified in the "
                        "fencing table (analysis/conformance.py "
                        "_FENCE_CLASS) — decide whether a fenced daemon "
                        "may serve it",
            ))
        elif cls == "mutating" and name not in py.fenced:
            out.append(Finding(
                rule="fenced-reject-gap", path=_DAEMON_PY, line=0,
                symbol=name,
                message=f"state-mutating MsgType.{name} is missing from "
                        "_FENCED_REJECT — a fenced daemon would serve it "
                        "(split-brain write/read)",
            ))
        elif cls in ("epoch-control",) and name in py.fenced:
            out.append(Finding(
                rule="fenced-reject-gap", path=_DAEMON_PY, line=0,
                symbol=name,
                message=f"epoch-control MsgType.{name} is in "
                        "_FENCED_REJECT — a fenced daemon could never "
                        "learn the epoch that supersedes it",
            ))
    for name in sorted(py.fenced):
        if _FENCE_CLASS.get(name, "mutating") != "mutating":
            out.append(Finding(
                rule="fenced-reject-gap", path=_DAEMON_PY, line=0,
                symbol=name,
                message=f"MsgType.{name} is in _FENCED_REJECT but "
                        f"classified {_FENCE_CLASS.get(name)!r} — fencing "
                        "and the classification disagree",
            ))
    return out


# -- flag declare/strip/handle sites ------------------------------------

#: Data-tail flags whose prefix a generic strip site must remove, and
#: the strip call shape that removes it.
_TAIL_STRIP = {
    "FLAG_MUX_TAG": "tag",
    "FLAG_TRACE_CTX": "trace",
    "FLAG_DEADLINE": "deadline",
}

# Strip/attach call shapes: kind -> recv-order rank (strip order is tag,
# trace, deadline; attach order is the exact reverse).
_STRIP_RANK = {"tag": 0, "trace": 1, "deadline": 2}


def _call_kind(node: ast.Call) -> tuple[str, str] | None:
    """('strip'|'attach', kind) for a data-tail helper call, else None."""
    f = node.func
    if isinstance(f, ast.Name):
        if f.id == "split_tag":
            return ("strip", "tag")
        if f.id == "attach_tag":
            return ("attach", "tag")
        return None
    if not isinstance(f, ast.Attribute) or not isinstance(f.value, ast.Name):
        return None
    head = f.value.id
    if f.attr == "split":
        if "trace" in head:
            return ("strip", "trace")
        if "budget" in head or head == "timebudget":
            return ("strip", "deadline")
    if f.attr == "attach":
        if "trace" in head:
            return ("attach", "trace")
        if "budget" in head or head == "timebudget":
            return ("attach", "deadline")
    return None


def _flag_refs_outside_tables(tree: ast.Module) -> set[str]:
    """FLAG_* names referenced outside the _FLAGS_HANDLED table literal
    (a flag that only appears in the claims table is claimed, not
    handled)."""
    excluded: list[tuple[int, int]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "_FLAGS_HANDLED":
                    excluded.append((node.lineno, node.end_lineno or 0))
    refs: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id.startswith("FLAG_"):
            if not any(a <= node.lineno <= b for a, b in excluded):
                refs.add(node.id)
    return refs


def check_flag_sites(py: PySurface, root: str | None = None) -> list[Finding]:
    root = root or _ROOT
    out: list[Finding] = []
    with open(os.path.join(root, _DAEMON_PY), encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=_DAEMON_PY)
    daemon_refs = _flag_refs_outside_tables(tree)
    strip_kinds = {
        kind for node in ast.walk(tree)
        if isinstance(node, ast.Call)
        and (ka := _call_kind(node)) is not None and ka[0] == "strip"
        for kind in (ka[1],)
    }

    declared_anywhere = 0
    for mask in py.valid_flags.values():
        declared_anywhere |= mask
    for name, value in sorted(py.flag_values.items(),
                              key=lambda kv: kv[1]):
        if not value & declared_anywhere:
            out.append(Finding(
                rule="flag-sites", path="oncilla_tpu_torch/runtime/protocol.py",
                line=0, symbol=name,
                message=f"{name} ({value:#06x}) is defined but valid on no "
                        "MsgType (VALID_FLAGS) — dead flag bit",
            ))
            continue
        if name not in daemon_refs:
            out.append(Finding(
                rule="flag-sites", path=_DAEMON_PY, line=0, symbol=name,
                message=f"{name} is declared in VALID_FLAGS but never "
                        "referenced in runtime/daemon.py outside the "
                        "_FLAGS_HANDLED claims table — no handle site",
            ))
        want_strip = _TAIL_STRIP.get(name)
        if want_strip is not None and want_strip not in strip_kinds:
            out.append(Finding(
                rule="flag-sites", path=_DAEMON_PY, line=0, symbol=name,
                message=f"data-tail flag {name} has no {want_strip!r} strip "
                        "site in runtime/daemon.py — its prefix would reach "
                        "handlers as payload bytes",
            ))

    # Every capability offered on CONNECT must have a grant site in
    # _on_connect (an offer nobody can ever echo is a dead capability).
    connect_mask = py.valid_flags.get("CONNECT", 0)
    for name, value in sorted(py.flag_values.items(),
                              key=lambda kv: kv[1]):
        if name.startswith("FLAG_CAP_") and value & connect_mask \
                and name not in py.granted:
            out.append(Finding(
                rule="flag-sites", path=_DAEMON_PY, line=0, symbol=name,
                message=f"{name} is offerable on CONNECT (VALID_FLAGS) but "
                        "_on_connect has no grant site for it — the offer "
                        "can never be echoed",
            ))
    return out


def check_strip_order(root: str | None = None,
                      extra_files: tuple[str, ...] = ()) -> list[Finding]:
    """Every function that touches >= 2 data-tail prefixes must strip
    them tag -> trace -> deadline (and attach in the exact reverse)."""
    root = root or _ROOT
    files = [
        _DAEMON_PY,
        "oncilla_tpu_torch/runtime/mux.py",
        "oncilla_tpu_torch/runtime/client.py",
        *extra_files,
    ]
    out: list[Finding] = []
    for rel in files:
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            continue
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=rel)
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            sites: dict[str, list[tuple[str, int]]] = {
                "strip": [], "attach": []
            }
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    ka = _call_kind(node)
                    if ka is not None:
                        sites[ka[0]].append((ka[1], node.lineno))
            for action, seq in sites.items():
                kinds_seen = {k for k, _ in seq}
                if len(kinds_seen) < 2:
                    continue
                ranked = [
                    _STRIP_RANK[k] if action == "strip"
                    else 2 - _STRIP_RANK[k]
                    for k, _ in sorted(seq, key=lambda s: s[1])
                ]
                if ranked != sorted(ranked):
                    order = " -> ".join(
                        k for k, _ in sorted(seq, key=lambda s: s[1])
                    )
                    want = ("tag -> trace -> deadline" if action == "strip"
                            else "deadline -> trace -> tag")
                    out.append(Finding(
                        rule="strip-order", path=rel, line=seq[0][1],
                        symbol=fn.name,
                        message=f"data-tail {action} order {order} in "
                                f"{fn.name}() — the wire contract is "
                                f"{want}",
                    ))
    return out


# -- audit invariants <-> journal emissions -----------------------------


def _consumed_events(audit_src: str) -> set[str]:
    """Event names any obs/audit.py invariant compares against."""
    tree = ast.parse(audit_src)
    setmap: dict[str, set[str]] = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Name)
            and node.value.func.id == "frozenset"
            and node.value.args
        ):
            strs = {
                e.value for e in ast.walk(node.value.args[0])
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            }
            if strs:
                setmap[node.targets[0].id] = strs

    def is_event_access(e: ast.expr) -> bool:
        if isinstance(e, ast.Name) and e.id == "ev":
            return True
        return (
            isinstance(e, ast.Call)
            and isinstance(e.func, ast.Attribute)
            and e.func.attr == "get"
            and e.args
            and isinstance(e.args[0], ast.Constant)
            and e.args[0].value == "ev"
        )

    consumed: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        if not any(is_event_access(s) for s in sides):
            continue
        for s in sides:
            if isinstance(s, ast.Constant) and isinstance(s.value, str):
                consumed.add(s.value)
            elif isinstance(s, (ast.Tuple, ast.Set, ast.List)):
                consumed.update(
                    e.value for e in s.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                )
            elif isinstance(s, ast.Name) and s.id in setmap:
                consumed.update(setmap[s.id])
    return consumed


def _emitted_events(root: str) -> dict[str, tuple[str, int]]:
    """Event name -> first (path, line) emission site: Python
    ``*journal*.record("name", ...)`` calls plus the native daemon's
    ``journal_.record("name", ...)``."""
    emitted: dict[str, tuple[str, int]] = {}
    pkg = os.path.join(root, "oncilla_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build", ".git",
                                    "fixtures")]
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            fp = os.path.join(dirpath, f)
            with open(fp, encoding="utf-8") as fh:
                src = fh.read()
            if ".record(" not in src:
                continue
            try:
                tree = ast.parse(src)
            except SyntaxError:
                continue
            rel = os.path.relpath(fp, root)
            for node in ast.walk(tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "record"
                    and isinstance(node.func.value, ast.Name)
                    and "journal" in node.func.value.id
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    emitted.setdefault(node.args[0].value,
                                       (rel, node.lineno))
    dc = os.path.join(root, _DC)
    if os.path.isfile(dc):
        with open(dc, encoding="utf-8") as fh:
            src = fh.read()
        for m in re.finditer(r"journal_\.record\(\"(\w+)\"", src):
            emitted.setdefault(m.group(1), (_DC, _line_of(src, m.start())))
    return emitted


def cross_reference_events(
    consumed: set[str], emitted: dict[str, tuple[str, int]]
) -> list[Finding]:
    out: list[Finding] = []
    for name in sorted(consumed - set(emitted)):
        out.append(Finding(
            rule="audit-event-unemitted", path=_AUDIT_PY, line=0,
            symbol=name,
            message=f"audit invariant consumes journal event {name!r} but "
                    "nothing in the package (or the native daemon) ever "
                    "emits it — the invariant can never fire",
        ))
    for name in sorted(set(emitted) - consumed):
        path, line = emitted[name]
        out.append(Finding(
            rule="journal-event-unchecked", path=path, line=line,
            symbol=name,
            message=f"journal event {name!r} is emitted but no audit "
                    "invariant consumes it (dead telemetry — info only)",
        ))
    return out


def check_audit_events(root: str | None = None) -> list[Finding]:
    root = root or _ROOT
    with open(os.path.join(root, _AUDIT_PY), encoding="utf-8") as fh:
        consumed = _consumed_events(fh.read())
    return cross_reference_events(consumed, _emitted_events(root))


# -- the capability / parity matrix -------------------------------------

# Cosmetic gate labels for the matrix (the granted/declined FACTS are
# derived; these only phrase the conditions).
_PY_GATE_LABELS = {
    "FLAG_CAP_MUX": "declined with `OCM_MUX_SERVE=0`",
    "FLAG_CAP_FABRIC": "only with a registered fabric",
}
_NATIVE_TRACE_GATE = "declined with `OCM_NATIVE_OBS=0`"


def matrix_data(py: PySurface, nat: NativeSurface) -> dict:
    caps: dict[str, dict] = {}
    for name, value in sorted(py.flag_values.items(), key=lambda kv: kv[1]):
        if not name.startswith("FLAG_CAP_"):
            continue
        if name in py.granted:
            gate = _PY_GATE_LABELS.get(name)
            pystat = f"granted ({gate})" if gate and py.granted[name] \
                else "granted"
        else:
            pystat = "declined"
        if value & nat.caps_granted:
            if name == "FLAG_CAP_TRACE" and nat.trace_gated:
                nstat = f"granted ({_NATIVE_TRACE_GATE})"
            else:
                nstat = "granted"
        else:
            nstat = "declined"
        caps[name] = {"value": value, "python": pystat, "native": nstat}

    nat_dispatch_py = {_MSG_ALIAS.get(n, n) for n in nat.dispatch}
    reqs: dict[str, dict] = {}
    for name, value in sorted(py.msg_values.items(), key=lambda kv: kv[1]):
        if not _is_request(name):
            continue
        reqs[name] = {
            "value": value,
            "python": "served" if name in py.handlers else "unhandled",
            "native": "served" if name in nat_dispatch_py
            else "typed `BAD_MSG`",
        }
    return {"capabilities": caps, "requests": reqs}


def render_matrix(data: dict) -> str:
    lines = [
        MATRIX_BEGIN,
        "",
        "| capability | Python daemon | native daemon |",
        "|---|---|---|",
    ]
    for name, row in data["capabilities"].items():
        lines.append(f"| `{name}` ({row['value']:#06x}) | {row['python']} "
                     f"| {row['native']} |")
    lines += [
        "",
        "Request-type parity (a type the native daemon does not dispatch",
        "is declined with a typed `BAD_MSG`, stream in sync — the",
        "machine-checked TODO list for ROADMAP item 2):",
        "",
        "| request `MsgType` | Python daemon | native daemon |",
        "|---|---|---|",
    ]
    for name, row in data["requests"].items():
        lines.append(f"| `{name}` ({row['value']}) | {row['python']} "
                     f"| {row['native']} |")
    lines += ["", MATRIX_END]
    return "\n".join(lines)


def _checked_in_block(arch_src: str) -> str | None:
    b = arch_src.find(MATRIX_BEGIN)
    if b < 0:
        return None
    e = arch_src.find(MATRIX_END, b)
    if e < 0:
        return None
    return arch_src[b:e + len(MATRIX_END)]


def check_matrix(py: PySurface, nat: NativeSurface,
                 root: str | None = None) -> list[Finding]:
    root = root or _ROOT
    path = os.path.join(root, _ARCH_MD)
    try:
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
    except OSError:
        return [Finding(
            rule="matrix-drift", path=_ARCH_MD, line=0, symbol="<matrix>",
            message=f"{_ARCH_MD} is missing — cannot check the "
                    "capability matrix",
        )]
    checked_in = _checked_in_block(src)
    if checked_in is None:
        return [Finding(
            rule="matrix-drift", path=_ARCH_MD, line=0, symbol="<matrix>",
            message=f"{_ARCH_MD} has no generated capability-"
                    "matrix block — regenerate with `python -m "
                    "oncilla_tpu_torch.analysis --write-matrix`",
        )]
    derived = render_matrix(matrix_data(py, nat))
    if checked_in != derived:
        return [Finding(
            rule="matrix-drift", path=_ARCH_MD,
            line=_line_of(src, src.find(MATRIX_BEGIN)), symbol="<matrix>",
            message="the checked-in capability matrix differs from the one "
                    "derived from the two wire surfaces — regenerate with "
                    "`python -m oncilla_tpu_torch.analysis --write-matrix`",
        )]
    return []


def write_matrix(root: str | None = None) -> bool:
    """Regenerate the ARCHITECTURE.md block in place; True on change."""
    root = root or _ROOT
    path = os.path.join(root, _ARCH_MD)
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    old = _checked_in_block(src)
    if old is None:
        raise RuntimeError(
            f"{_ARCH_MD} has no '{MATRIX_BEGIN[:40]}...' block to replace"
        )
    new = render_matrix(matrix_data(extract_python(root), extract_native()))
    if old == new:
        return False
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(src.replace(old, new, 1))
    return True


# -- entry point ---------------------------------------------------------


_RPCGRAPH_PY = "oncilla_tpu_torch/analysis/rpcgraph.py"


def check_relay_classes(py: PySurface,
                        root: str | None = None) -> list[Finding]:
    """Drive-by twin of rpcgraph's relay-class validation: every request
    type the Python daemon dispatches must have a row in
    ``rpcgraph._RELAY_CLASS``, so a new MsgType added without
    classifying its relay behavior fails BOTH gates — and both errors
    point at the one table to edit, keeping the two extractors from
    drifting apart."""
    from oncilla_tpu_torch.analysis import rpcgraph

    root = root or _ROOT
    line = 1
    try:
        with open(os.path.join(root, _RPCGRAPH_PY),
                  encoding="utf-8") as fh:
            src = fh.read()
        idx = src.find("\n_RELAY_CLASS")
        idx = idx + 1 if idx >= 0 else -1
        if idx >= 0:
            line = _line_of(src, idx)
    except OSError:
        pass
    out: list[Finding] = []
    for name in sorted(py.handlers):
        if _is_request(name) and name not in rpcgraph._RELAY_CLASS:
            out.append(Finding(
                rule="relay-class-gap", path=_RPCGRAPH_PY, line=line,
                symbol=name,
                message=f"request type {name} is dispatched by the "
                        "Python daemon but has no row in "
                        "rpcgraph._RELAY_CLASS — classify its relay "
                        "behavior there (leaf / forward / terminal-flag "
                        "/ state-bounded)",
            ))
    return out


def check_conformance(root: str | None = None) -> list[Finding]:
    """The whole family. Needs the real modules + tree; default-scan
    only (the :func:`check_protocol` precedent)."""
    root = root or _ROOT
    py = extract_python(root)
    nat = extract_native()
    findings = check_native_parity(py, nat)
    findings += check_fenced(py)
    findings += check_flag_sites(py, root)
    findings += check_strip_order(root)
    findings += check_audit_events(root)
    findings += check_matrix(py, nat, root)
    findings += check_relay_classes(py, root)
    return findings
