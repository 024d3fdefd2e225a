"""Distributed wait-graph analysis (family: ``rpcgraph``).

Every distributed-correctness bug this codebase actually shipped lived in
the *cross-process* topology, which no other analysis family models: the
heartbeat amplification loop (a tombstone forward re-triggering the
origin's relay branch), the bounded-worker-pool deadlock avoided
only by a comment, and the forever-blocked recv against a
SIGSTOPped peer. This pass extracts — per daemon handler in
``daemon._HANDLERS`` and per client ladder in ``runtime/client.py`` /
``runtime/mux.py`` — the set of outbound RPCs (``_peer_request``,
``PeerPool.lease``/``lease_set``/``request``, mux ``transfer_sync``, raw
``protocol.request``/``recv_msg`` legs) together with the resources held
at each call site (``make_lock`` locks via the lockwatch name registry,
bounded worker-pool slots, pool leases) into a typed message/resource
wait-graph, and checks four rule families over it:

``relay-cycle``
    A request :class:`MsgType` reachable from itself across daemon relay
    edges where the handler has neither a terminal-flag guard (the
    ``FLAG_HB_FWD`` shape: ``if msg.flags & FLAG_X: return``) nor an
    explicit hop decrement. Findings anchor at the back-edge send site,
    so a genuinely state-bounded re-send (the DO_FREE migration/replica
    fan-out, bounded by registry state) carries a per-line
    ``ocm-lint: allow[relay-cycle]`` with its justification.

``pool-stratification``
    Code running on a bounded pool's worker slot that can block on a
    pool reachable from the first (``submit().result()`` on itself, or a
    lease/admission wait forming a cycle) — the worker-pool deadlock class.
    The native daemon's ``OCM_NATIVE_WORKERS`` pool joins the graph via
    a conformance-style lexical C++ parse of ``worker_loop``.

``lock-across-rpc``
    A ``make_lock`` lock held (lexically or through a local call chain)
    across a peer dial. The edge is the static twin of the
    ``rpc:daemon`` pseudo-node the runtime waitwatch feeds into the
    lockwatch order graph: lock -> rpc:daemon -> handler locks closes a
    cross-process deadlock cycle no single-process watchdog can see.

``unbounded-blocking``
    A network wait on a *budgeted* path (the function reads the ambient
    ``timebudget.current()`` or takes a ``budget`` parameter) that is not
    clamped by a ``timeout=`` or a ``settimeout`` — the frozen-peer bug class:
    every recv/connect on a budgeted path must thread the remainder.

Two modes share one engine. Explicit-path scans (fixtures, pre-commit)
are hermetic pure-graph analyses of exactly the files given. The default
tree scan additionally validates the :data:`_RELAY_CLASS` table — every
live request type must be classified ``leaf`` / ``forward`` /
``terminal-flag`` / ``state-bounded`` and the classification must match
the extracted topology (``relay-unclassified`` on drift), the native
pool invariant, and the generated "RPC topology" appendix in
oncilla_tpu_torch/docs/ARCHITECTURE.md (``rpc-topology-drift``,
regenerate with ``python -m oncilla_tpu_torch.analysis
--write-topology``).

Runtime twin: :mod:`~oncilla_tpu_torch.analysis.waitwatch`
(``OCM_WAITWATCH=1``) extends the lockwatch graph with pool-slot and
RPC pseudo-nodes so the same cycles are asserted absent dynamically
under stress.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from oncilla_tpu_torch.analysis.lint import (
    Finding,
    _dotted,
    _suppressed,
    iter_py_files,
)

__all__ = [
    "RPCGRAPH_RULES", "scan_rpcgraph", "check_rpcgraph", "extract_module",
    "topology_data", "render_topology", "check_topology", "write_topology",
]

RPCGRAPH_RULES = frozenset({
    "relay-cycle", "pool-stratification", "lock-across-rpc",
    "unbounded-blocking", "relay-unclassified", "rpc-topology-drift",
    "native-pool-parse",
})

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_ARCH_MD = os.path.join("oncilla_tpu_torch", "docs", "ARCHITECTURE.md")

# The modules whose joint graph IS the control plane. Order matters only
# for deterministic output.
_RUNTIME_FILES = (
    os.path.join("oncilla_tpu_torch", "runtime", "daemon.py"),
    os.path.join("oncilla_tpu_torch", "runtime", "client.py"),
    os.path.join("oncilla_tpu_torch", "runtime", "mux.py"),
    os.path.join("oncilla_tpu_torch", "runtime", "pool.py"),
)

# MsgType -> relay class. THE one table to edit when adding a request
# type (conformance.py cross-checks it, so an unclassified type fails
# both gates):
#   leaf          handler performs no outbound peer RPC
#   forward       handler relays to OTHER types only (cycle-checked)
#   terminal-flag handler re-sends its own type but carries a terminal
#                 flag guard (``if msg.flags & FLAG_X: return``)
#   state-bounded handler re-sends its own type bounded by registry
#                 state, not syntax; the back-edge send sites carry a
#                 justified ``ocm-lint: allow[relay-cycle]``
_RELAY_CLASS: dict[str, str] = {
    "ADD_NODE": "leaf",
    "CANCEL": "leaf",
    "CONNECT": "leaf",
    "DATA_GET": "forward",        # device ops relay to the plane
    "DATA_PUT": "terminal-flag",  # FLAG_FANOUT replica legs; receivers
                                  # never re-fan-out a flagged copy
    "DISCONNECT": "forward",      # app teardown -> DO_FREE/RECLAIM_APP
    "DO_ALLOC": "leaf",
    "DO_FREE": "state-bounded",   # migration tombstone pop + replica
                                  # fan-out; both re-sends drain state
                                  # (allow[relay-cycle] at the sites)
    "DO_REPLICA": "leaf",
    "EPOCH_UPDATE": "leaf",
    "HEARTBEAT": "terminal-flag",  # FLAG_HB_FWD tombstone forward
    "LEADER_HANDOFF": "forward",   # -> LEADER_UPDATE broadcast
    "LEADER_UPDATE": "leaf",
    "MASTER_STATE": "leaf",
    "MEMBER_UPDATE": "leaf",
    "MIGRATE": "forward",          # source-side stream legs
    "MIGRATE_BEGIN": "leaf",
    "NOTE_ALLOC": "leaf",
    "NOTE_FREE": "leaf",           # leader accounting sink
    "PING": "leaf",
    "PLANE_GET": "forward",        # -> the registered device plane
    "PLANE_PUT": "forward",
    "PLANE_SCRUB": "forward",
    "PLANE_SERVE": "state-bounded",  # relay:1 gossip legs are terminal
                                     # (_on_plane_serve only re-arms on
                                     # relay:0 client registrations)
    "PROMOTE": "leaf",
    "RECLAIM_APP": "forward",      # -> DO_FREE/NOTE_FREE drain
    "REQ_ALLOC": "forward",        # placement -> DO_ALLOC/DO_REPLICA
    "REQ_EXTENTS": "leaf",
    "REQ_FREE": "forward",         # -> DO_FREE at the owner
    "REQ_JOIN": "forward",         # -> MEMBER_UPDATE broadcast
    "REQ_LEAVE": "forward",
    "REQ_LOCATE": "leaf",
    "RE_REPLICATE": "forward",     # repair -> DO_REPLICA/DATA_PUT
    "SHM_GET": "forward",          # thaw-on-fault -> evictor free legs
    "SHM_MAP": "forward",
    "SHM_PUT": "forward",          # -> FLAG_FANOUT replica legs
    "STATUS": "leaf",
    "STATUS_EVENTS": "leaf",
    "STATUS_PROM": "leaf",
    "SUSPECT_NODE": "leaf",
}

# Call-site kinds. "dial" kinds cross a process boundary (lock-across-rpc
# applies); "wait" kinds block on the network (unbounded-blocking
# applies); pool kinds additionally enter a bounded-pool admission wait.
_DIAL_KINDS = frozenset({
    "peer_request", "pool_request", "pool_lease", "transfer_sync",
    "wire_request", "dial",
})
_WAIT_KINDS = frozenset({"pool_request", "wire_request", "wire_recv",
                         "dial"})

_POOLISH = re.compile(r"(pool|peers|executor)s?$", re.IGNORECASE)
_HANDLERISH = re.compile(r"handlers?$", re.IGNORECASE)
_HOPISH = re.compile(r"hop|ttl", re.IGNORECASE)


# -- extracted facts ----------------------------------------------------


@dataclass
class Send:
    """One message leaving the process: ``Message(MsgType.X, ...)`` fed
    into an RPC primitive, or a verbatim relay of the incoming ``msg``."""

    msgtype: str            # "HEARTBEAT" | "<verbatim>"
    flags: tuple[str, ...]  # FLAG_* names attached at construction
    line: int


@dataclass
class RpcCall:
    kind: str
    line: int
    bounded: bool                 # timeout threaded at the call site
    held: tuple[str, ...]         # lock sites held at the call site
    sends: list[Send] = field(default_factory=list)
    detail: str = ""              # rendered callee for messages


@dataclass
class FuncInfo:
    qualname: str
    name: str                     # terminal name (method name)
    line: int
    rpcs: list[RpcCall] = field(default_factory=list)
    # (callee terminal name, held sites, line) — local call edges
    calls: list[tuple[str, tuple[str, ...], int]] = field(
        default_factory=list)
    guards: set[str] = field(default_factory=set)   # terminal FLAG_*
    hop_bound: bool = False
    reads_budget: bool = False
    has_budget_param: bool = False
    bounds_socket: bool = False   # calls settimeout somewhere
    # (pool raw receiver, line, via) — blocking admission/result waits
    pool_blocks: list[tuple[str, int, str]] = field(default_factory=list)
    # (pool raw receiver, entry fn terminal, line)
    submits: list[tuple[str, str, int]] = field(default_factory=list)
    uses_dispatch: bool = False   # reads a *_HANDLERS-style dict


@dataclass
class ModuleInfo:
    path: str                     # as shown in findings
    lines: list[str]
    funcs: dict[str, FuncInfo] = field(default_factory=dict)
    locks: dict[str, str] = field(default_factory=dict)   # var -> site
    pools: dict[str, str] = field(default_factory=dict)   # var -> kind
    handlers: dict[str, str] = field(default_factory=dict)  # type -> fn
    handler_dicts: set[str] = field(default_factory=set)
    # fn terminal name -> pool var it returns (``return self._mux_pool``)
    returns_pool: dict[str, str] = field(default_factory=dict)


# -- small AST helpers --------------------------------------------------


def _terminal(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _receiver(func: ast.expr) -> str | None:
    """Terminal name of a call's receiver: ``self.peers.request`` ->
    ``peers``; ``pool.submit`` -> ``pool``."""
    if not isinstance(func, ast.Attribute):
        return None
    v = func.value
    if isinstance(v, ast.Call):
        return _terminal(v.func)
    return _terminal(v)


def _flag_names(node: ast.expr) -> tuple[str, ...]:
    out = []
    for n in ast.walk(node):
        t = _terminal(n) if isinstance(n, (ast.Name, ast.Attribute)) else None
        if t and t.startswith("FLAG_") and t not in out:
            out.append(t)
    return tuple(out)


def _message_send(node: ast.expr) -> Send | None:
    """``Message(MsgType.X, ..., flags=F)`` -> Send; else None."""
    if not (isinstance(node, ast.Call) and _terminal(node.func) == "Message"
            and node.args):
        return None
    d = _dotted(node.args[0])
    if not d or "MsgType" not in d:
        return None
    msgtype = d.rsplit(".", 1)[-1]
    flags: tuple[str, ...] = ()
    for kw in node.keywords:
        if kw.arg == "flags":
            flags = _flag_names(kw.value)
    return Send(msgtype=msgtype, flags=flags, line=node.lineno)


def _returns_terminally(body: list[ast.stmt]) -> bool:
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, (ast.Return, ast.Raise, ast.Continue)):
                return True
    return False


# -- per-module extraction ----------------------------------------------


class _ModuleExtractor:
    """Two-phase extraction: module-level registries (locks, pools,
    handler dicts), then a held-lock-aware walk of every function."""

    def __init__(self, tree: ast.Module, path: str, source: str):
        self.tree = tree
        self.mod = ModuleInfo(path=path, lines=source.splitlines())

    def run(self) -> ModuleInfo:
        self._collect_registries()
        self._collect_pool_returns()
        stack: list[str] = []

        def walk(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    stack.append(child.name)
                    walk(child)
                    stack.pop()
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = ".".join(stack + [child.name])
                    self._extract_func(child, qual)
                    stack.append(child.name)
                    walk(child)
                    stack.pop()
                else:
                    walk(child)

        walk(self.tree)
        return self.mod

    # -- phase 1: registries -------------------------------------------

    def _collect_registries(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and node.targets:
                tgt = _terminal(node.targets[0])
                val = node.value
                if tgt and isinstance(val, ast.Call):
                    fn = _terminal(val.func) or ""
                    if fn in ("make_lock", "make_rlock") and val.args and \
                            isinstance(val.args[0], ast.Constant):
                        self.mod.locks[tgt] = str(val.args[0].value)
                    elif fn in ("ThreadPoolExecutor", "PeerPool") or \
                            fn.endswith(("PoolExecutor", "WorkerPool")):
                        self.mod.pools[tgt] = fn
                if tgt and isinstance(val, ast.Dict):
                    entries = {}
                    for k, v in zip(val.keys, val.values):
                        kd = _dotted(k) if k is not None else None
                        if kd and "MsgType" in kd:
                            vt = _terminal(v)
                            if vt:
                                entries[kd.rsplit(".", 1)[-1]] = vt
                    if entries:
                        self.mod.handlers.update(entries)
                        self.mod.handler_dicts.add(tgt)
        for name in list(self.mod.handler_dicts):
            # "_HANDLERS" is the idiom; accept any name but prefer ones
            # that look the part for dispatcher detection.
            if not _HANDLERISH.search(name):
                self.mod.handler_dicts.add(name)

    def _collect_pool_returns(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Return) and stmt.value is not None:
                    t = _terminal(stmt.value)
                    if t and t in self.mod.pools:
                        self.mod.returns_pool[node.name] = t

    # -- phase 2: function bodies --------------------------------------

    def _extract_func(self, fn: ast.FunctionDef | ast.AsyncFunctionDef,
                      qual: str) -> None:
        info = FuncInfo(qualname=qual, name=fn.name, line=fn.lineno)
        args = fn.args
        params = [a.arg for a in (args.posonlyargs + args.args
                                  + args.kwonlyargs)]
        info.has_budget_param = any(p in ("budget", "bud") for p in params)
        msg_param = "msg" if "msg" in params else None
        local_msgs: dict[str, Send] = {}
        pool_alias: dict[str, str] = {}    # local var -> pool var
        futures: dict[str, str] = {}       # local var -> pool raw recv
        held: list[str] = []

        def lock_site(expr: ast.expr) -> str | None:
            t = _terminal(expr)
            if t is None:
                return None
            if t in self.mod.locks:
                return self.mod.locks[t]
            n = t.lower()
            if n.endswith(("lock", "mutex", "_mu", "_cond", "wlock")) or \
                    n in ("mu", "cond", "lck"):
                return t
            return None

        def resolve_pool(raw: str | None) -> str | None:
            if raw is None:
                return None
            if raw in self.mod.pools:
                return raw
            if raw in pool_alias:
                return pool_alias[raw]
            if raw in self.mod.returns_pool:
                return self.mod.returns_pool[raw]
            return None

        def classify(call: ast.Call) -> None:
            func = call.func
            term = _terminal(func)
            recv = _receiver(func)
            line = call.lineno
            has_timeout = any(kw.arg == "timeout" for kw in call.keywords)

            def sends_of(callargs: list[ast.expr]) -> list[Send]:
                out: list[Send] = []
                for a in callargs:
                    s = _message_send(a)
                    if s is not None:
                        out.append(s)
                        continue
                    t = _terminal(a)
                    if t is None:
                        continue
                    if t in local_msgs:
                        m = local_msgs[t]
                        out.append(Send(m.msgtype, m.flags, line))
                    elif t == msg_param:
                        out.append(Send("<verbatim>", (), line))
                return out

            kind = None
            bounded = has_timeout
            if term == "_peer_request":
                kind, bounded = "peer_request", True  # threads the budget
            elif term == "request" and recv is None:
                kind = "wire_request"   # protocol.request(sock, msg)
            elif term == "request" and (
                    resolve_pool(recv) or (recv and _POOLISH.search(recv))):
                kind = "pool_request"
            elif term in ("lease", "lease_set") and (
                    resolve_pool(recv) or (recv and _POOLISH.search(recv))):
                kind, bounded = "pool_lease", True  # admission, not wire
            elif term == "transfer_sync":
                kind, bounded = "transfer_sync", True  # mux deadline-aware
            elif term == "recv_msg":
                kind = "wire_recv"
            elif term == "create_connection":
                kind = "dial"
            elif term == "settimeout":
                info.bounds_socket = True

            if kind is not None:
                info.rpcs.append(RpcCall(
                    kind=kind, line=line, bounded=bounded,
                    held=tuple(held), sends=sends_of(list(call.args)),
                    detail=(_dotted(func) or term or "?"),
                ))

            # Pool admission / submit / blocking-result facts.
            praw = recv if (recv and (recv in self.mod.pools
                                      or _POOLISH.search(recv)
                                      or recv in pool_alias
                                      or recv in self.mod.returns_pool)) \
                else None
            if term in ("lease", "lease_set", "request") and praw:
                info.pool_blocks.append((praw, line, term))
            if term == "submit" and praw and call.args:
                entry = _terminal(call.args[0])
                if entry:
                    info.submits.append((praw, entry, line))
            if term == "result" and isinstance(func, ast.Attribute):
                v = func.value
                if isinstance(v, ast.Call) and \
                        _terminal(v.func) == "submit":
                    r = _receiver(v.func)
                    if r:
                        info.pool_blocks.append((r, line, "submit-result"))
                else:
                    t = _terminal(v)
                    if t and t in futures:
                        info.pool_blocks.append(
                            (futures[t], line, "submit-result"))

            # Budget reads + local call edges.
            d = _dotted(func) or ""
            if d.endswith("timebudget.current"):
                info.reads_budget = True
            if term and recv in (None, "self", "cls") and \
                    kind is None and term != "settimeout":
                info.calls.append((term, tuple(held), line))

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return  # nested defs run later; held locks don't apply
            if isinstance(node, (ast.With, ast.AsyncWith)):
                pushed = []
                for item in node.items:
                    visit(item.context_expr)
                    s = lock_site(item.context_expr)
                    if s:
                        pushed.append(s)
                held.extend(pushed)
                for b in node.body:
                    visit(b)
                if pushed:
                    del held[-len(pushed):]
                return
            if isinstance(node, ast.If):
                test_flags = _flag_names(node.test)
                touches_flags = any(
                    isinstance(n, ast.Attribute) and n.attr == "flags"
                    for n in ast.walk(node.test))
                # Two terminal shapes bound a relay: the early return
                # (``if msg.flags & FLAG_X: return`` — the amplification fix) and
                # the inverted gate (``if not msg.flags & FLAG_X:
                # <relay legs flagged FLAG_X>`` — the fan-out shape):
                # either way the flagged copy cannot re-relay.
                inverted = (isinstance(node.test, ast.UnaryOp)
                            and isinstance(node.test.op, ast.Not))
                if test_flags and touches_flags and \
                        (inverted or _returns_terminally(node.body)):
                    info.guards.update(test_flags)
            if isinstance(node, ast.Assign) and node.targets:
                tgt = _terminal(node.targets[0])
                val = node.value
                if tgt:
                    s = _message_send(val)
                    if s is not None:
                        local_msgs[tgt] = s
                    if isinstance(val, ast.Call):
                        vt = _terminal(val.func)
                        if vt in self.mod.returns_pool:
                            pool_alias[tgt] = self.mod.returns_pool[vt]
                        if vt == "submit":
                            r = _receiver(val.func)
                            if r:
                                futures[tgt] = r
            if isinstance(node, (ast.BinOp, ast.AugAssign)):
                op = node.op if isinstance(node, ast.BinOp) else node.op
                if isinstance(op, ast.Sub):
                    try:
                        txt = ast.unparse(node)
                    except Exception:  # pragma: no cover - defensive
                        txt = ""
                    if _HOPISH.search(txt):
                        info.hop_bound = True
            if isinstance(node, (ast.Name, ast.Attribute)):
                t = _terminal(node)
                if t in self.mod.handler_dicts:
                    info.uses_dispatch = True
            if isinstance(node, ast.Call):
                classify(node)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in fn.body:
            visit(stmt)
        self.mod.funcs[fn.name] = info
        self.mod.funcs.setdefault(qual, info)


def extract_module(source: str, path: str) -> ModuleInfo | None:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None
    return _ModuleExtractor(tree, path, source).run()


# -- the joint wait-graph ----------------------------------------------


class _Graph:
    """All extracted modules fused: one function table, one handler map,
    one pool registry — the cross-module control-plane graph."""

    def __init__(self, mods: list[ModuleInfo]):
        self.mods = mods
        self.funcs: dict[str, tuple[ModuleInfo, FuncInfo]] = {}
        self.handlers: dict[str, str] = {}
        self.pools: dict[str, tuple[ModuleInfo, str]] = {}
        for m in mods:
            for name, fi in m.funcs.items():
                self.funcs.setdefault(name, (m, fi))
            self.handlers.update(m.handlers)
            for p, kind in m.pools.items():
                self.pools.setdefault(p, (m, kind))

    def reachable(self, roots: list[str], limit: int = 400) -> list[str]:
        """Function terminal names reachable through local call edges;
        reading a handlers dict fans out to every handler."""
        seen: list[str] = []
        work = list(roots)
        while work and len(seen) < limit:
            name = work.pop()
            if name in seen or name not in self.funcs:
                continue
            seen.append(name)
            _, fi = self.funcs[name]
            for callee, _, _ in fi.calls:
                if callee in self.funcs and callee not in seen:
                    work.append(callee)
            if fi.uses_dispatch:
                for h in self.handlers.values():
                    if h not in seen:
                        work.append(h)
        return seen

    def unique_funcs(self) -> list[tuple[ModuleInfo, FuncInfo]]:
        """Every FuncInfo once, deterministically ordered — functions
        are registered under both terminal name and qualname, so plain
        iteration would double-report."""
        seen: set[int] = set()
        out: list[tuple[ModuleInfo, FuncInfo]] = []
        for _, (mod, fi) in sorted(self.funcs.items()):
            if id(fi) in seen:
                continue
            seen.add(id(fi))
            out.append((mod, fi))
        return out

    def rpc_reachers(self) -> set[str]:
        """Functions from which a peer dial is reachable."""
        out: set[str] = set()
        for name, (_, fi) in self.funcs.items():
            if any(c.kind in _DIAL_KINDS for c in fi.rpcs):
                out.add(name)
        changed = True
        while changed:
            changed = False
            for name, (_, fi) in self.funcs.items():
                if name in out:
                    continue
                if any(callee in out for callee, _, _ in fi.calls):
                    out.add(name)
                    changed = True
        return out


def _finding(mod: ModuleInfo, rule: str, line: int, symbol: str,
             message: str) -> Finding | None:
    if _suppressed(mod.lines, line, rule):
        return None
    return Finding(rule=rule, path=mod.path, line=line, symbol=symbol,
                   message=message)


# -- rule 1: relay-cycle ------------------------------------------------


def _type_edges(g: _Graph) -> dict[str, list[tuple[str, Send,
                                                   ModuleInfo, str]]]:
    """MsgType -> [(next type, send, module, handler qualname)]. A
    handler's effective sends are every typed send reachable through
    local calls; a verbatim relay resolves to the handler's own type
    only when it sits directly in the handler body (a helper's ``msg``
    is its caller's business, not a relay edge)."""
    edges: dict[str, list] = {}
    for msgtype, hname in sorted(g.handlers.items()):
        if hname not in g.funcs:
            continue
        hmod, hfi = g.funcs[hname]
        for s in (x for c in hfi.rpcs for x in c.sends):
            t = msgtype if s.msgtype == "<verbatim>" else s.msgtype
            edges.setdefault(msgtype, []).append((t, s, hmod,
                                                  hfi.qualname))
        for fname in g.reachable([hname]):
            if fname == hname:
                continue
            fmod, ffi = g.funcs[fname]
            if ffi.uses_dispatch:
                continue  # the dispatcher serves, it does not relay
            for s in (x for c in ffi.rpcs for x in c.sends):
                if s.msgtype == "<verbatim>":
                    continue
                edges.setdefault(msgtype, []).append(
                    (s.msgtype, s, fmod, ffi.qualname))
    return edges


def _handler_bounded(g: _Graph, msgtype: str) -> bool:
    hname = g.handlers.get(msgtype)
    if hname is None or hname not in g.funcs:
        return False
    _, hfi = g.funcs[hname]
    if hfi.guards:
        return True
    return any(g.funcs[f][1].hop_bound for f in g.reachable([hname])
               if f in g.funcs)


def _relay_cycles(g: _Graph) -> list[Finding]:
    """Message-type cycles whose handlers have neither a terminal-flag
    guard nor a hop decrement. One finding per back-edge send site (so
    a state-bounded re-send is suppressible exactly where it happens)."""
    edges = _type_edges(g)
    findings: list[Finding] = []
    seen: set[tuple[str, int]] = set()

    def dfs(start: str) -> None:
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt, send, mod, qual in edges.get(node, []):
                if nxt == start:
                    cyc = path + [start]
                    if any(_handler_bounded(g, t) for t in path):
                        continue
                    key = (mod.path, send.line)
                    if key in seen:
                        continue
                    seen.add(key)
                    roles = " -> ".join(
                        f"{t}({g.handlers.get(t, '?')})" for t in cyc)
                    f = _finding(
                        mod, "relay-cycle", send.line, qual,
                        f"relay cycle: {roles} — handler {qual} (origin "
                        f"daemon role) re-sends {nxt} back into the "
                        f"relay peer daemon role with no terminal flag "
                        f"guard and no hop decrement; an amplification "
                        f"loop (heartbeat-amplification class). Bound it with a FLAG-"
                        f"guarded early return, a hop counter, or "
                        f"justify state-boundedness with "
                        f"ocm-lint: allow[relay-cycle]")
                    if f:
                        findings.append(f)
                elif nxt not in path and len(path) < 8 and \
                        nxt in edges:
                    stack.append((nxt, path + [nxt]))

    for t in sorted(edges):
        dfs(t)
    return findings


# -- rule 2: pool-stratification ---------------------------------------


def _pool_findings(g: _Graph) -> list[Finding]:
    """Edges P -> Q: code running on P's worker slot (submitted entry
    functions and everything they reach) blocks on Q's bounded
    admission. A cycle (including P -> P) deadlocks once both pools
    fill — the worker-pool deadlock class. A lease held while blocking on another pool
    adds the holder's edge too."""
    # pool var -> entry function names
    entries: dict[str, list[str]] = {}
    for _, fi in g.unique_funcs():
        for praw, entry, _ in fi.submits:
            entries.setdefault(praw, []).append(entry)
    edges: dict[str, dict[str, tuple[ModuleInfo, str, int, str]]] = {}
    for pool, ents in sorted(entries.items()):
        for fname in g.reachable(sorted(set(ents))):
            mod, fi = g.funcs[fname]
            for qraw, line, via in fi.pool_blocks:
                if qraw == pool and via != "submit-result":
                    continue  # an entry leasing its own pool var is
                              # aliasing noise; submit+wait is real
                edges.setdefault(pool, {}).setdefault(
                    qraw, (mod, fi.qualname, line, via))
    # lease-then-block ordering inside one function: holding a slot of
    # P while waiting on Q.
    for mod, fi in g.unique_funcs():
        leases = [(p, ln) for p, ln, via in fi.pool_blocks
                  if via in ("lease", "lease_set")]
        for p, pln in leases:
            for q, qln, via in fi.pool_blocks:
                if qln > pln and q != p:
                    edges.setdefault(p, {}).setdefault(
                        q, (mod, fi.qualname, qln, via))
    findings: list[Finding] = []
    seen: set[tuple[str, ...]] = set()
    for start in sorted(edges):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt, (mod, qual, line, via) in sorted(
                    edges.get(node, {}).items()):
                if nxt == start:
                    cyc = path + [start]
                    i = cyc.index(min(cyc[:-1]))
                    key = tuple(cyc[:-1][i:] + cyc[:-1][:i])
                    if key in seen:
                        continue
                    seen.add(key)
                    f = _finding(
                        mod, "pool-stratification", line, qual,
                        f"bounded-pool wait cycle: "
                        f"{' -> '.join(cyc)} — {qual} runs on a slot "
                        f"of '{node}' and blocks on '{nxt}' ({via}); "
                        f"when both pools fill this deadlocks (worker-pool "
                        f"deadlock class). Stratify: a pool may only wait on "
                        f"pools it cannot be reached from")
                    if f:
                        findings.append(f)
                elif nxt not in path and len(path) < 6:
                    stack.append((nxt, path + [nxt]))
    return findings


# -- rule 3: lock-across-rpc -------------------------------------------


def _lock_findings(g: _Graph) -> list[Finding]:
    reachers = g.rpc_reachers()
    findings: list[Finding] = []
    seen: set[tuple[str, int]] = set()
    for mod, fi in g.unique_funcs():
        for c in fi.rpcs:
            if c.kind in _DIAL_KINDS and c.held:
                key = (mod.path, c.line)
                if key in seen:
                    continue
                seen.add(key)
                f = _finding(
                    mod, "lock-across-rpc", c.line, fi.qualname,
                    f"lock(s) {', '.join(c.held)} held across peer "
                    f"dial {c.detail} — the lock-order edge "
                    f"{c.held[-1]} -> rpc:daemon closes a cross-"
                    f"process deadlock cycle with any handler that "
                    f"takes the same lock; move the dial outside the "
                    f"lock or justify with ocm-lint: "
                    f"allow[lock-across-rpc]")
                if f:
                    findings.append(f)
        for callee, held, line in fi.calls:
            if held and callee in reachers and callee != fi.name:
                key = (mod.path, line)
                if key in seen:
                    continue
                seen.add(key)
                f = _finding(
                    mod, "lock-across-rpc", line, fi.qualname,
                    f"lock(s) {', '.join(held)} held across call to "
                    f"{callee}() which performs a peer dial — same "
                    f"rpc:daemon order edge one level down; move the "
                    f"call outside the lock or justify with "
                    f"ocm-lint: allow[lock-across-rpc]")
                if f:
                    findings.append(f)
    return findings


# -- rule 4: unbounded-blocking ----------------------------------------


def _budget_findings(g: _Graph) -> list[Finding]:
    findings: list[Finding] = []
    for mod, fi in g.unique_funcs():
        if not (fi.reads_budget or fi.has_budget_param):
            continue
        if fi.bounds_socket:
            continue
        for c in fi.rpcs:
            if c.kind in _WAIT_KINDS and not c.bounded:
                f = _finding(
                    mod, "unbounded-blocking", c.line, fi.qualname,
                    f"{fi.qualname} is on a budgeted path (reads the "
                    f"ambient timebudget or takes a budget param) but "
                    f"waits on the network via {c.detail} with no "
                    f"timeout — against a stalled peer this blocks "
                    f"past the deadline (frozen-peer class); thread "
                    f"budget.remaining_s() into the wait or justify "
                    f"with ocm-lint: allow[unbounded-blocking]")
                if f:
                    findings.append(f)
    return findings


# -- the native pool (conformance-style C++ parse) ----------------------


def _native_pool_findings(root: str) -> list[Finding]:
    """The worker-pool invariant lives in daemon.cc as a comment: control
    messages never queue on the OCM_NATIVE_WORKERS pool, so a worker
    can never wait on its own bounded queue. Check the syntactic half:
    ``worker_loop`` (and everything it calls, one hop) must not call
    ``enqueue_work`` — a worker re-enqueueing into the queue it drains
    is the self-edge the Python side's pool-stratification rule bans."""
    cc = os.path.join(root, "oncilla_tpu_torch", "runtime", "native",
                      "daemon.cc")
    shown = os.path.relpath(cc, root)
    try:
        with open(cc, encoding="utf-8") as fh:
            src = fh.read()
    except OSError:
        return []
    mod = ModuleInfo(path=shown, lines=src.splitlines())
    if "OCM_NATIVE_WORKERS" not in src:
        return []  # no bounded native pool in this tree
    m = re.search(r"\bvoid\s+worker_loop\s*\(", src)
    if not m or "queue_cv_" not in src:
        f = _finding(mod, "native-pool-parse", 1, "worker_loop",
                     "daemon.cc advertises OCM_NATIVE_WORKERS but the "
                     "worker_loop/queue_cv_ shape the pool-"
                     "stratification check keys on is gone — update "
                     "analysis/rpcgraph.py's native parse")
        return [f] if f else []
    # Brace-match the worker_loop body.
    i = src.find("{", m.end())
    depth, j = 1, i + 1
    while j < len(src) and depth:
        depth += src[j] == "{"
        depth -= src[j] == "}"
        j += 1
    body = src[i:j]
    callees = set(re.findall(r"\b(\w+)\s*\(", body))
    bodies = [("worker_loop", body, src.count("\n", 0, m.start()) + 1)]
    for name in sorted(callees):
        cm = re.search(r"\b\w[\w:<>*&\s]*\b" + re.escape(name)
                       + r"\s*\([^;{]*\)\s*(?:const\s*)?\{", src)
        if cm:
            ci = src.find("{", cm.start())
            d, k = 1, ci + 1
            while k < len(src) and d:
                d += src[k] == "{"
                d -= src[k] == "}"
                k += 1
            bodies.append((name, src[ci:k],
                           src.count("\n", 0, cm.start()) + 1))
    out: list[Finding] = []
    for name, b, line in bodies:
        if name != "enqueue_work" and "enqueue_work(" in b:
            f = _finding(
                mod, "pool-stratification", line, name,
                f"{name} runs on (or is called from) the "
                f"OCM_NATIVE_WORKERS worker pool and re-enqueues onto "
                f"its own bounded queue via enqueue_work — the native "
                f"self-edge of the pool-stratification rule; route "
                f"control work off-pool (daemon.cc's stated invariant)")
            if f:
                out.append(f)
    return out


# -- entry points -------------------------------------------------------


def _sort(findings: list[Finding]) -> list[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule,
                                           f.symbol, f.message))


def scan_rpcgraph(paths: list[str],
                  rel_to: str | None = None) -> list[Finding]:
    """Pure-graph mode: joint analysis of exactly the files given (the
    fixture/pre-commit/mutation-test path — hermetic, no class table)."""
    mods: list[ModuleInfo] = []
    for fp in iter_py_files(paths):
        with open(fp, encoding="utf-8") as fh:
            src = fh.read()
        shown = os.path.relpath(fp, rel_to) if rel_to else fp
        m = extract_module(src, shown)
        if m is not None:
            mods.append(m)
    if not mods:
        return []
    g = _Graph(mods)
    return _sort(_relay_cycles(g) + _pool_findings(g)
                 + _lock_findings(g) + _budget_findings(g))


def _runtime_graph(root: str) -> _Graph:
    mods: list[ModuleInfo] = []
    for rel in _RUNTIME_FILES:
        fp = os.path.join(root, rel)
        try:
            with open(fp, encoding="utf-8") as fh:
                src = fh.read()
        except OSError:
            continue
        m = extract_module(src, rel.replace(os.sep, "/"))
        if m is not None:
            mods.append(m)
    return _Graph(mods)


def _class_findings(g: _Graph, root: str) -> list[Finding]:
    """The default-scan extras: every live request type classified in
    :data:`_RELAY_CLASS`, and the classification matching the extracted
    topology — the drift gate conformance.py cross-checks."""
    findings: list[Finding] = []
    daemon_mod = next((m for m in g.mods if m.path.endswith("daemon.py")),
                      None)
    if daemon_mod is None:
        return []
    edges = _type_edges(g)

    def emit(line: int, symbol: str, message: str) -> None:
        f = _finding(daemon_mod, "relay-unclassified", line, symbol,
                     message)
        if f:
            findings.append(f)

    for msgtype, hname in sorted(g.handlers.items()):
        cls = _RELAY_CLASS.get(msgtype)
        hline = g.funcs[hname][1].line if hname in g.funcs else 1
        if cls is None:
            emit(hline, hname,
                 f"request type {msgtype} (handler {hname}) has no row "
                 f"in analysis/rpcgraph.py:_RELAY_CLASS — classify it "
                 f"leaf/forward/terminal-flag/state-bounded (the "
                 f"conformance gate checks the same table)")
            continue
        sends = edges.get(msgtype, [])
        self_sends = [s for t, s, _, _ in sends if t == msgtype]
        if cls == "leaf" and sends:
            out = sorted({t for t, _, _, _ in sends})
            emit(hline, hname,
                 f"{msgtype} is classified 'leaf' but its handler "
                 f"reaches outbound sends of {', '.join(out)} — "
                 f"reclassify in _RELAY_CLASS or remove the relay")
        elif cls == "forward" and self_sends:
            emit(hline, hname,
                 f"{msgtype} is classified 'forward' but re-sends its "
                 f"own type — reclassify (terminal-flag/state-bounded) "
                 f"or break the self-relay")
        elif cls == "terminal-flag":
            bounded = hname in g.funcs and bool(g.funcs[hname][1].guards)
            if not bounded:
                emit(hline, hname,
                     f"{msgtype} is classified 'terminal-flag' but "
                     f"handler {hname} has no terminal flag guard "
                     f"(``if msg.flags & FLAG_X: return``) — the "
                     f"amplification-loop bound is gone "
                     f"(heartbeat-amplification class)")
    for msgtype in sorted(_RELAY_CLASS):
        if msgtype not in g.handlers:
            emit(1, "<module>",
                 f"_RELAY_CLASS row {msgtype} matches no handled "
                 f"request type — stale row, delete it")
    return findings


def check_rpcgraph(root: str | None = None) -> list[Finding]:
    """Default-scan extras: relay-class table validation, the native
    worker pool, and the ARCHITECTURE.md topology drift check. The four
    core rules run through :func:`scan_rpcgraph` over the whole tree."""
    root = root or _ROOT
    g = _runtime_graph(root)
    findings = _class_findings(g, root)
    findings += _native_pool_findings(root)
    findings += check_topology(root, g)
    return _sort(findings)


# -- the generated RPC-topology appendix --------------------------------


TOPOLOGY_BEGIN = ("<!-- BEGIN rpc-topology — generated by "
                  "`python -m oncilla_tpu_torch.analysis --write-topology`; "
                  "the rpcgraph analysis fails on drift -->")
TOPOLOGY_END = "<!-- END rpc-topology -->"


def topology_data(root: str | None = None,
                  g: _Graph | None = None) -> dict:
    g = g or _runtime_graph(root or _ROOT)
    edges = _type_edges(g)
    types: dict[str, dict] = {}
    for msgtype, hname in sorted(g.handlers.items()):
        sends = sorted({
            (t, ",".join(s.flags)) for t, s, _, _ in
            edges.get(msgtype, [])
        })
        guards = sorted(g.funcs[hname][1].guards) \
            if hname in g.funcs else []
        types[msgtype] = {
            "handler": hname,
            "class": _RELAY_CLASS.get(msgtype, "UNCLASSIFIED"),
            "sends": [{"type": t, "flags": fl} for t, fl in sends],
            "guards": guards,
        }
    return {"types": types}


def render_topology(data: dict) -> str:
    lines = [
        TOPOLOGY_BEGIN,
        "",
        "Derived by `oncilla_tpu_torch/analysis/rpcgraph.py` from the live",
        "handler table: per request type, its daemon handler, its relay",
        "class in `_RELAY_CLASS`, and every outbound request the",
        "handler can reach. A `terminal-flag` class names the guard",
        "that bounds the self-relay; `state-bounded` re-sends carry",
        "per-line `ocm-lint: allow[relay-cycle]` justifications at the",
        "send sites.",
        "",
        "| request | handler | class | outbound sends | terminal guard |",
        "|---|---|---|---|---|",
    ]
    for t, row in data["types"].items():
        sends = ", ".join(
            f"{s['type']}" + (f" [+{s['flags']}]" if s["flags"] else "")
            for s in row["sends"]) or "—"
        guards = ", ".join(f"`{x}`" for x in row["guards"]) or "—"
        lines.append(f"| `{t}` | `{row['handler']}` | {row['class']} "
                     f"| {sends} | {guards} |")
    lines += ["", "```mermaid", "graph LR"]
    emitted: set[str] = set()
    for t, row in data["types"].items():
        for s in row["sends"]:
            label = f" -- {s['flags']} --> " if s["flags"] else " --> "
            edge = f"    {t}{label}{s['type']}"
            if edge not in emitted:
                emitted.add(edge)
                lines.append(edge)
    lines += ["```", "", TOPOLOGY_END]
    return "\n".join(lines)


def _checked_in_topology(arch_src: str) -> str | None:
    b = arch_src.find(TOPOLOGY_BEGIN)
    if b < 0:
        return None
    e = arch_src.find(TOPOLOGY_END, b)
    if e < 0:
        return None
    return arch_src[b:e + len(TOPOLOGY_END)]


def check_topology(root: str | None = None,
                   g: _Graph | None = None) -> list[Finding]:
    root = root or _ROOT
    path = os.path.join(root, _ARCH_MD)
    try:
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
    except OSError:
        return []
    shown = _ARCH_MD.replace(os.sep, "/")
    checked_in = _checked_in_topology(src)
    derived = render_topology(topology_data(root, g))
    if checked_in is None:
        return [Finding(
            rule="rpc-topology-drift", path=shown, line=1,
            symbol="<topology>",
            message=f"{shown} has no generated RPC-topology "
                    "appendix — add one with `python -m "
                    "oncilla_tpu_torch.analysis --write-topology`",
        )]
    if checked_in != derived:
        return [Finding(
            rule="rpc-topology-drift", path=shown,
            line=src.count("\n", 0, src.find(TOPOLOGY_BEGIN)) + 1,
            symbol="<topology>",
            message="the checked-in RPC topology differs from the one "
                    "derived from the live handler graph — regenerate "
                    "with `python -m oncilla_tpu_torch.analysis "
                    "--write-topology`",
        )]
    return []


def write_topology(root: str | None = None) -> bool:
    """Regenerate the ARCHITECTURE.md appendix in place; True on
    change. Appends the block if the markers are missing."""
    root = root or _ROOT
    path = os.path.join(root, _ARCH_MD)
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    new = render_topology(topology_data(root))
    old = _checked_in_topology(src)
    if old == new:
        return False
    if old is None:
        src = src.rstrip("\n") + "\n\n## RPC topology\n\n" + new + "\n"
    else:
        src = src.replace(old, new, 1)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(src)
    return True
