"""Handle-lifecycle dataflow analysis (the second analysis family).

The alloc/free/put/get handle protocol is the whole value proposition of
this system, and its failure modes are silent: a leaked handle pins arena
bytes until the lease reaper guesses, and a use of a freed handle — once
the id is recycled into daemon bookkeeping — reads or writes unrelated
memory (core/handle.py's ``daemon_owned`` warning). :mod:`~.lint` catches
lexical concurrency shapes; this module is a **CFG-based intraprocedural
dataflow pass** over every function (and module body) that tracks names
bound to ``OcmAlloc``-producing calls and reports:

``handle-leak-on-path``
    An allocation that on *some* path to a function exit — including
    exception edges from explicit ``raise`` statements, which leave the
    function directly when the body is ``try``-less — is neither freed,
    returned, stored, yielded, nor otherwise escaped.  To stay high-confidence the rule
    only fires when **another path does free the same name** (the
    inconsistent-release shape): a function that never frees a handle is
    presumed to transfer ownership to its caller or a fixture, while one
    that frees on the happy path but not on the early ``return``/``raise``
    path is near-certainly a bug.  A bare ``ctx.alloc(...)`` expression
    statement whose result is discarded is flagged unconditionally (the
    handle is unreachable the moment the statement ends).

``use-after-free``
    A data op (``put``/``get``/``localbuf``/``push``/``pull``/``copy``/…)
    on a name after ``free``/``ocm_free`` on some path with no
    intervening reassignment.

``double-free``
    A second ``free`` of a name already freed on some path.

What counts as an allocation: bare ``ocm_alloc(...)``, any
``<recv>.alloc(...)`` / ``<recv>.lease(...)`` where the receiver is a
plain name/attribute chain (``ctx.alloc``, ``client.alloc``,
``arena.alloc``, ``pool.lease`` — extents and pool leases obey the same
discipline).  What counts as a release: ``<recv>.free(x)``,
``<recv>.release(.., x)`` / ``<recv>.discard(.., x)``, ``ocm_free(ctx,
x)``; and ``.tini()`` / ``.stop()`` / ``.close()`` / ``.reset()`` /
``ocm_tini(...)`` release *everything* (they reclaim all live handles),
as does leaving a ``with ocm_init(...)`` / ``with local_cluster(...)``
block.  What counts as an escape (tracking stops, no finding): returning
or yielding the name, raising with it, storing it into an attribute,
subscript, or container literal, passing it to any unrecognized call, or
referencing it from a nested ``def``/``lambda``.

Deliberate-error tests are exempt: statements inside a ``with
pytest.raises(...)`` block never produce findings (the suite's
double-free/UAF regression tests *prove* the runtime rejects them).
``assert`` statements do not create exception edges (a test-failure path
is not a production leak path).  Per-line suppression uses the shared
``# ocm-lint: allow[<rule>]`` comment.

Like the lint, the pass prefers a small number of high-confidence
findings over whole-program precision: it is intraprocedural, does not
track aliases, and unions states at joins (so "on some path" is literal).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from oncilla_tpu_torch.analysis.lint import (
    Finding,
    _dotted,
    _suppressed,
    _terminal_name,
    iter_py_files,
)

RULE_LEAK = "handle-leak-on-path"
RULE_UAF = "use-after-free"
RULE_DOUBLE_FREE = "double-free"
LIFECYCLE_RULES = frozenset({RULE_LEAK, RULE_UAF, RULE_DOUBLE_FREE})

# Bare functions of the module-level API (core/context.py): index of the
# first handle-ish positional argument.
_BARE_ALLOC = {"ocm_alloc"}
_BARE_FREE = {"ocm_free": 1}
_BARE_RELEASE_ALL = {"ocm_tini"}
_BARE_DATA = {  # name -> first handle arg index
    "ocm_copy": 1, "ocm_copy_onesided": 1, "ocm_copy_out": 1,
    "ocm_copy_in": 1, "ocm_localbuf": 1,
}
# Methods. Receiver must be a pure Name/Attribute chain for alloc (so
# ``self._remote_or_raise(kind).alloc(...)`` inside the façade itself is
# not double-tracked); free/data ops accept any receiver.
_METHOD_ALLOC = {"alloc", "lease", "reserve"}
_METHOD_FREE = {"free", "release", "discard"}
_METHOD_RELEASE_ALL = {"tini", "stop", "close", "reset"}
_METHOD_DATA = {
    "put", "get", "get_as", "localbuf", "push", "pull", "copy",
    "write", "read", "view", "move",
}
# Receivers whose discarded .alloc() result is flagged as an immediate
# leak (context-like objects; a discarded *arena* alloc is an accepted
# arena-filling idiom in capacity tests).
_CTX_RECEIVERS = ("ctx", "ocm", "context", "client")
# Context managers whose exit reclaims every live handle.
_SCOPE_MANAGERS = {"ocm_init", "local_cluster"}

_LIVE = "live"
_FREED = "freed"


def _is_ctxish(name: str | None) -> bool:
    if name is None:
        return False
    n = name.lower()
    return n in _CTX_RECEIVERS or n.endswith(("ctx", "context", "client"))


# ---------------------------------------------------------------------------
# CFG
# ---------------------------------------------------------------------------


class _Node:
    __slots__ = ("payload", "succ", "exempt", "kind")

    def __init__(self, payload=None, exempt: bool = False, kind: str = ""):
        self.payload = payload
        self.succ: list[_Node] = []
        self.exempt = exempt
        self.kind = kind  # "", "exit", "raise-exit"


@dataclass
class _Loop:
    brk: _Node
    cont: _Node


class _Cfg:
    """One CFG per analyzed scope. Every statement is its own node (the
    scopes are function-sized; precision beats block fusion here), with
    extra synthetic nodes for joins, finally copies, and scope exits."""

    def __init__(self) -> None:
        self.nodes: list[_Node] = []
        self.exit = self.new(kind="exit")
        self.raise_exit = self.new(kind="raise-exit")

    def new(self, payload=None, exempt: bool = False, kind: str = "") -> _Node:
        n = _Node(payload, exempt, kind)
        self.nodes.append(n)
        return n


def _is_pytest_raises(expr: ast.expr) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    d = _dotted(expr.func) or ""
    return d in ("pytest.raises", "raises", "pytest.warns", "warns",
                 "pytest.deprecated_call")


def _scope_manager_release(expr: ast.expr) -> bool:
    """Does leaving this with-item's manager reclaim all live handles?"""
    if not isinstance(expr, ast.Call):
        return False
    name = _terminal_name(expr.func)
    return name in _SCOPE_MANAGERS


class _Builder:
    """Lowers one function (or module) body to a CFG."""

    def __init__(self, cfg: _Cfg):
        self.cfg = cfg

    def build(self, stmts: list[ast.stmt]) -> _Node:
        entry = self.cfg.new()
        end = self._seq(stmts, entry, exc=None, loop=None, exempt=False)
        if end is not None:
            end.succ.append(self.cfg.exit)
        return entry

    # -- helpers --------------------------------------------------------

    def _step(self, cur: _Node, payload, exc: _Node | None,
              exempt: bool) -> _Node:
        # Note: only explicit `raise` statements create exception edges
        # (see module docstring) — implicit can-raise edges from every call
        # would make any alloc-then-free pair a leak-on-exception finding
        # and drown the signal. `exc` is threaded through so nested raises
        # find their enclosing handler / finally.
        n = self.cfg.new(payload, exempt)
        cur.succ.append(n)
        return n

    def _seq(self, stmts, cur: _Node, exc: _Node | None,
             loop: _Loop | None, exempt: bool) -> _Node | None:
        """Lower a statement list; returns the fall-through node, or None
        when control cannot fall out the bottom."""
        for stmt in stmts:
            if cur is None:
                return None  # unreachable code after return/raise/break
            cur = self._stmt(stmt, cur, exc, loop, exempt)
        return cur

    # -- statement lowering ---------------------------------------------

    def _stmt(self, stmt, cur, exc, loop, exempt) -> _Node | None:
        cfg = self.cfg
        if isinstance(stmt, ast.Return):
            n = self._step(cur, ("return", stmt), exc, exempt)
            n.succ.append(cfg.exit)
            return None
        if isinstance(stmt, ast.Raise):
            n = self._step(cur, ("raise", stmt), None, exempt)
            n.succ.append(exc if exc is not None else cfg.raise_exit)
            return None
        if isinstance(stmt, ast.Break):
            if loop is not None:
                cur.succ.append(loop.brk)
            return None
        if isinstance(stmt, ast.Continue):
            if loop is not None:
                cur.succ.append(loop.cont)
            return None
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            # The nested scope runs later (it gets its own analysis); any
            # name it captures escapes the current one.
            refs = sorted({
                x.id for x in ast.walk(stmt)
                if isinstance(x, ast.Name) and isinstance(x.ctx, ast.Load)
            })
            return self._step(cur, ("escape", refs), exc, exempt)
        if isinstance(stmt, ast.If):
            t = self._step(cur, ("expr", stmt.test), exc, exempt)
            then_end = self._seq(stmt.body, t, exc, loop, exempt)
            else_end = (self._seq(stmt.orelse, t, exc, loop, exempt)
                        if stmt.orelse else t)
            ends = [e for e in (then_end, else_end) if e is not None]
            if not ends:
                return None
            join = cfg.new()
            for e in ends:
                e.succ.append(join)
            return join
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            if isinstance(stmt, ast.While):
                header = self._step(cur, ("expr", stmt.test), exc, exempt)
            else:
                header = self._step(cur, ("for", stmt), exc, exempt)
            after = cfg.new()
            body_end = self._seq(
                stmt.body, header, exc, _Loop(after, header), exempt
            )
            if body_end is not None:
                body_end.succ.append(header)
            if stmt.orelse:
                else_end = self._seq(stmt.orelse, header, exc, loop, exempt)
                if else_end is not None:
                    else_end.succ.append(after)
            else:
                header.succ.append(after)
            return after
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            body_exempt = exempt
            releases = False
            for item in stmt.items:
                cur = self._step(cur, ("with_item", item), exc, exempt)
                if _is_pytest_raises(item.context_expr):
                    body_exempt = True
                if _scope_manager_release(item.context_expr):
                    releases = True
            end = self._seq(stmt.body, cur, exc, loop, body_exempt)
            if end is None:
                return None
            if releases:
                end = self._step(end, ("release_all",), exc, exempt)
            return end
        if isinstance(stmt, ast.Try) or (
            hasattr(ast, "TryStar") and isinstance(stmt, ast.TryStar)
        ):
            return self._try(stmt, cur, exc, loop, exempt)
        if isinstance(stmt, ast.Match):
            subj = self._step(cur, ("expr", stmt.subject), exc, exempt)
            join = cfg.new()
            fell = False
            for case in stmt.cases:
                binds = sorted({
                    x.name for x in ast.walk(case.pattern)
                    if isinstance(x, (ast.MatchAs, ast.MatchStar))
                    and x.name
                })
                centry = self._step(subj, ("kill", binds), exc, exempt)
                cend = self._seq(case.body, centry, exc, loop, exempt)
                if cend is not None:
                    cend.succ.append(join)
                    fell = True
            subj.succ.append(join)  # no case matched
            return join if (fell or True) else None
        # Simple statement (Expr, Assign, AugAssign, AnnAssign, Assert,
        # Delete, Pass, Import, Global, Nonlocal, ...).
        return self._step(cur, ("stmt", stmt), exc, exempt)

    def _try(self, stmt, cur, exc, loop, exempt) -> _Node | None:
        cfg = self.cfg
        outer = exc if exc is not None else cfg.raise_exit

        # Exceptional finally copy: runs on the unwind path, then
        # propagates outward. Built separately from the normal copy so a
        # free() in the finally covers both paths without merging them.
        fexc_entry = fexc_end = None
        if stmt.finalbody:
            fexc_entry = cfg.new()
            fexc_end = self._seq(stmt.finalbody, fexc_entry, exc, loop, exempt)
            if fexc_end is not None:
                fexc_end.succ.append(outer)

        if stmt.handlers:
            dispatch = cfg.new()
            body_exc = dispatch
        elif fexc_entry is not None:
            body_exc = fexc_entry
        else:
            body_exc = outer

        body_end = self._seq(stmt.body, cur, body_exc, loop, exempt)

        if stmt.orelse and body_end is not None:
            body_end = self._seq(stmt.orelse, body_end, body_exc, loop, exempt)

        after = cfg.new()
        handler_exc = fexc_entry if fexc_entry is not None else outer
        norm_ends = [body_end] if body_end is not None else []
        if stmt.handlers:
            for h in stmt.handlers:
                kills = [h.name] if h.name else []
                hentry = cfg.new(("kill", kills), exempt)
                dispatch.succ.append(hentry)
                hend = self._seq(h.body, hentry, handler_exc, loop, exempt)
                if hend is not None:
                    norm_ends.append(hend)
        if not norm_ends:
            return None
        if stmt.finalbody:
            fnorm_entry = cfg.new()
            for e in norm_ends:
                e.succ.append(fnorm_entry)
            fnorm_end = self._seq(stmt.finalbody, fnorm_entry, exc, loop, exempt)
            if fnorm_end is None:
                return None
            fnorm_end.succ.append(after)
        else:
            for e in norm_ends:
                e.succ.append(after)
        return after


# ---------------------------------------------------------------------------
# Dataflow
# ---------------------------------------------------------------------------

# State: name -> frozenset of items; item = (_LIVE, alloc_lineno) | (_FREED,)


def _merge_into(dst: dict, src: dict) -> bool:
    changed = False
    for k, items in src.items():
        have = dst.get(k)
        if have is None:
            dst[k] = items
            changed = True
        elif not items <= have:
            dst[k] = have | items
            changed = True
    return changed


def _iter_calls(expr: ast.AST):
    """Call nodes in (approximate) evaluation order, not descending into
    nested lambdas (they run later, not now)."""
    if isinstance(expr, ast.Lambda):
        return
    for child in ast.iter_child_nodes(expr):
        yield from _iter_calls(child)
    if isinstance(expr, ast.Call):
        yield expr


def _bare_names(exprs) -> list[str]:
    out = []
    for e in exprs:
        if isinstance(e, ast.Starred):
            e = e.value
        if isinstance(e, ast.Name):
            out.append(e.id)
    return out


def _call_args(call: ast.Call, start: int = 0) -> list[str]:
    return _bare_names(call.args[start:]) + _bare_names(
        kw.value for kw in call.keywords
    )


def _load_names(expr: ast.AST) -> set[str]:
    return {
        n.id for n in ast.walk(expr)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }


@dataclass
class _Analysis:
    path: str
    lines: list[str]
    symbol: str
    findings: set = field(default_factory=set)
    freed_names: set = field(default_factory=set)

    # -- finding emission ------------------------------------------------

    def _flag(self, rule: str, line: int, message: str,
              exempt: bool) -> None:
        if exempt or _suppressed(self.lines, line, rule):
            return
        self.findings.add(Finding(
            rule=rule, path=self.path, line=line,
            symbol=self.symbol, message=message,
        ))

    # -- call classification --------------------------------------------

    def _classify(self, call: ast.Call):
        """Returns (kind, handle_arg_names) where kind in
        {alloc, free, release_all, data, other}."""
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in _BARE_ALLOC:
                return "alloc", []
            if f.id in _BARE_FREE:
                return "free", _call_args(call, _BARE_FREE[f.id])
            if f.id in _BARE_RELEASE_ALL:
                return "release_all", []
            if f.id in _BARE_DATA:
                return "data", _call_args(call, _BARE_DATA[f.id])
            return "other", _call_args(call)
        if isinstance(f, ast.Attribute):
            recv = _terminal_name(f.value)
            if f.attr in _METHOD_ALLOC and recv is not None:
                return "alloc", []
            if f.attr in _METHOD_FREE:
                return "free", _call_args(call)
            if f.attr in _METHOD_RELEASE_ALL:
                return "release_all", []
            if f.attr in _METHOD_DATA:
                return "data", _call_args(call)
        return "other", _call_args(call)

    def _is_alloc_call(self, expr: ast.AST) -> bool:
        return (isinstance(expr, ast.Call)
                and self._classify(expr)[0] == "alloc")

    # -- transfer --------------------------------------------------------

    def _apply_call(self, call: ast.Call, st: dict, exempt: bool) -> None:
        kind, names = self._classify(call)
        if kind == "alloc":
            return  # binding handled by the enclosing Assign
        if kind == "release_all":
            for k in [k for k, v in st.items() if any(i[0] == _LIVE for i in v)]:
                del st[k]
            return
        for name in names:
            items = st.get(name)
            if items is None:
                continue
            if kind == "free":
                if any(i[0] == _FREED for i in items):
                    self._flag(
                        RULE_DOUBLE_FREE, call.lineno,
                        f"free of {name!r} already freed on some path",
                        exempt,
                    )
                st[name] = frozenset({(_FREED,)})
                self.freed_names.add(name)
            elif kind == "data":
                if any(i[0] == _FREED for i in items):
                    self._flag(
                        RULE_UAF, call.lineno,
                        f"use of {name!r} after free on some path "
                        "(no reassignment in between)",
                        exempt,
                    )
            else:  # escape into an unrecognized call
                del st[name]

    def _escape_names(self, names, st: dict) -> None:
        for n in names:
            st.pop(n, None)

    def _apply_expr(self, expr, st: dict, exempt: bool) -> None:
        if expr is None:
            return
        for call in _iter_calls(expr):
            self._apply_call(call, st, exempt)
        # Tracked names placed into container literals escape (ownership
        # moved into the container); so do yielded values.
        for node in ast.walk(expr):
            if isinstance(node, (ast.Tuple, ast.List, ast.Set)) and isinstance(
                getattr(node, "ctx", ast.Load()), ast.Load
            ):
                self._escape_names(_bare_names(node.elts), st)
            elif isinstance(node, ast.Dict):
                self._escape_names(_bare_names(node.values), st)
            elif isinstance(node, (ast.Yield, ast.YieldFrom)) and node.value:
                self._escape_names(_load_names(node.value), st)

    def _targets_names(self, target) -> list[str]:
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            out = []
            for e in target.elts:
                out.extend(self._targets_names(e))
            return out
        if isinstance(target, ast.Starred):
            return self._targets_names(target.value)
        return []

    def _apply_stmt(self, stmt, st: dict, exempt: bool) -> None:
        if isinstance(stmt, ast.Assign):
            self._apply_expr(stmt.value, st, exempt)
            stored = any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in stmt.targets
            )
            if stored:
                # self.h = h / container[k] = h: the handle escapes.
                self._escape_names(_load_names(stmt.value), st)
            for t in stmt.targets:
                for name in self._targets_names(t):
                    st.pop(name, None)
            if (
                not stored
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and self._is_alloc_call(stmt.value)
                and not exempt
            ):
                st[stmt.targets[0].id] = frozenset(
                    {(_LIVE, stmt.value.lineno)}
                )
            return
        if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            self._apply_expr(stmt.value, st, exempt)
            if isinstance(stmt.target, (ast.Attribute, ast.Subscript)):
                if stmt.value is not None:
                    self._escape_names(_load_names(stmt.value), st)
            for name in self._targets_names(stmt.target):
                st.pop(name, None)
            if (
                isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
                and stmt.value is not None
                and self._is_alloc_call(stmt.value)
                and not exempt
            ):
                st[stmt.target.id] = frozenset({(_LIVE, stmt.value.lineno)})
            return
        if isinstance(stmt, ast.Expr):
            v = stmt.value
            if isinstance(v, ast.NamedExpr):
                self._apply_expr(v.value, st, exempt)
                st.pop(v.target.id, None)
                if self._is_alloc_call(v.value) and not exempt:
                    st[v.target.id] = frozenset({(_LIVE, v.value.lineno)})
                return
            if self._is_alloc_call(v):
                recv = (_terminal_name(v.func.value)
                        if isinstance(v.func, ast.Attribute) else None)
                if (isinstance(v.func, ast.Name)
                        or _is_ctxish(recv)
                        or getattr(v.func, "attr", "") == "lease"):
                    self._flag(
                        RULE_LEAK, v.lineno,
                        "allocation result discarded (never bound, freed, "
                        "or stored)",
                        exempt,
                    )
                return
            self._apply_expr(v, st, exempt)
            return
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                for name in self._targets_names(t):
                    st.pop(name, None)
            return
        if isinstance(stmt, ast.Assert):
            self._apply_expr(stmt.test, st, exempt)
            return
        # Import / Global / Nonlocal / Pass: no lifecycle effect; still
        # walk any embedded expressions defensively.
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._apply_expr(child, st, exempt)

    def transfer(self, node: _Node, state: dict) -> dict:
        st = dict(state)
        p = node.payload
        if p is None:
            return st
        tag = p[0]
        if tag == "stmt":
            self._apply_stmt(p[1], st, node.exempt)
        elif tag == "expr":
            self._apply_expr(p[1], st, node.exempt)
        elif tag == "for":
            stmt = p[1]
            self._apply_expr(stmt.iter, st, node.exempt)
            for name in self._targets_names(stmt.target):
                st.pop(name, None)
        elif tag == "with_item":
            item = p[1]
            self._apply_expr(item.context_expr, st, node.exempt)
            if item.optional_vars is not None:
                for name in self._targets_names(item.optional_vars):
                    st.pop(name, None)
        elif tag == "return":
            stmt = p[1]
            self._apply_expr(stmt.value, st, node.exempt)
            if stmt.value is not None:
                self._escape_names(_load_names(stmt.value), st)
        elif tag == "raise":
            stmt = p[1]
            self._apply_expr(stmt.exc, st, node.exempt)
            if stmt.exc is not None:
                self._escape_names(_load_names(stmt.exc), st)
        elif tag == "escape":
            self._escape_names(p[1], st)
        elif tag == "kill":
            for name in p[1]:
                st.pop(name, None)
        elif tag == "release_all":
            for k in [k for k, v in st.items()
                      if any(i[0] == _LIVE for i in v)]:
                del st[k]
        return st


def _analyze_scope(body, symbol: str, path: str, lines: list[str]) -> set:
    cfg = _Cfg()
    entry = _Builder(cfg).build(body)
    ana = _Analysis(path=path, lines=lines, symbol=symbol)
    return _run_fixpoint(cfg, entry, ana)


def _run_fixpoint(cfg: _Cfg, entry: _Node, ana: _Analysis) -> set:
    ins: dict[int, dict] = {id(entry): {}}
    pending: list[_Node] = [entry]
    in_queue = {id(entry)}
    seen: set[int] = set()
    iters = 0
    limit = 50 * len(cfg.nodes) + 200
    while pending and iters < limit:
        iters += 1
        node = pending.pop(0)
        in_queue.discard(id(node))
        seen.add(id(node))
        out = ana.transfer(node, ins.get(id(node), {}))
        for succ in node.succ:
            dst = ins.setdefault(id(succ), {})
            changed = _merge_into(dst, out)
            if (changed or id(succ) not in seen) and id(succ) not in in_queue:
                pending.append(succ)
                in_queue.add(id(succ))
    # Leak checks at the two exits.
    for exit_node, how in ((cfg.exit, "function exit"),
                           (cfg.raise_exit, "an exception path")):
        st = ins.get(id(exit_node))
        if not st:
            continue
        for name, items in sorted(st.items()):
            if name not in ana.freed_names:
                continue  # never freed anywhere: ownership presumed to move
            for item in sorted(items):
                if item[0] != _LIVE:
                    continue
                ana._flag(
                    RULE_LEAK, item[1],
                    f"{name!r} allocated here is freed on some paths but "
                    f"reaches {how} still live on another "
                    "(leak-on-path)",
                    exempt=False,
                )
    return ana.findings


class _ScopeWalker(ast.NodeVisitor):
    """Finds every function scope (and the module body) to analyze."""

    def __init__(self, path: str, lines: list[str]):
        self.path = path
        self.lines = lines
        self.findings: set = set()
        self._stack: list[str] = []

    def _symbol(self) -> str:
        return ".".join(self._stack) or "<module>"

    def visit_Module(self, node: ast.Module) -> None:
        self.findings |= _analyze_scope(
            node.body, "<module>", self.path, self.lines
        )
        self.generic_visit(node)

    def _visit_func(self, node) -> None:
        self._stack.append(node.name)
        self.findings |= _analyze_scope(
            node.body, self._symbol(), self.path, self.lines
        )
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()


def analyze_source(source: str, path: str) -> list[Finding]:
    """Run the lifecycle dataflow pass over one module's source."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []  # the lint already reports syntax errors
    walker = _ScopeWalker(path, source.splitlines())
    walker.visit(tree)
    return sorted(
        walker.findings, key=lambda f: (f.path, f.line, f.rule, f.message)
    )


def scan_lifecycle(paths: list[str], rel_to: str | None = None) -> list[Finding]:
    """Lifecycle-analyze every ``.py`` under ``paths`` (mirrors
    ``lint.scan_paths``; same path-relativization for baseline keys)."""
    findings: list[Finding] = []
    for fp in iter_py_files(paths):
        with open(fp, encoding="utf-8") as fh:
            src = fh.read()
        shown = os.path.relpath(fp, rel_to) if rel_to else fp
        findings.extend(analyze_source(src, shown))
    return findings
