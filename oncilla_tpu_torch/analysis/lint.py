"""AST lint rules tuned to this codebase's failure modes.

Rules (each suppressible per-line with ``# ocm-lint: allow[<rule>]``):

``blocking-call-under-lock``
    A blocking call — socket send/recv/accept/dial, ``time.sleep``,
    ``subprocess.*``, thread ``.join``/``.wait``, or the project's blocking
    wire helpers (``request``/``send_msg``/``recv_msg``) — lexically inside
    a ``with <lock>:`` body. Holding a mutex across a network round-trip is
    exactly the shape that wedged the reference's control plane (one
    connection per peer + a mutex across the round trip couples the
    waits-for graph, see runtime/pool.py's module docstring).

``swallowed-exception``
    ``except Exception:`` / bare ``except:`` whose body is only ``pass`` or
    ``continue``. Broad-and-silent hides protocol desyncs and lost
    shutdowns; narrow the type or log via ``utils.debug.printd``.

``graph-host-call``
    A host-side call inside a CUDA-graph capture: the body of a ``with
    torch.cuda.graph(...):`` block, a function handed to the capture
    helper (``CapturedStep(fn, ...)`` or ``<...>graphs.run(fn, ...)``,
    :mod:`oncilla_tpu_torch.models.graphs`), or a function such a body
    calls. The callable handed over is followed to the function behind it
    across the scanned modules (:class:`_CaptureResolver`): through local
    bindings, binders (``hooked_step``, ``partial``) with the hooks they
    bind, the calling function's parameters and imports.
    ``.item()`` / ``.cpu()`` / ``.numpy()`` / ``.tolist()``, ``np.asarray``
    (and the other host numpy calls) and ``synchronize()`` read a device
    value on the host, which breaks the capture or bakes the value read at
    capture into every replay; ``print``/``time.*`` run once at capture,
    never at replay. This is the port's counterpart of the JAX package's
    ``jit-host-call``, whose target (``jax.jit``) the port never uses;
    the JAX rule's in-place-store check has none (tensors are updated in
    place, in graphs too).

``printd-eager-format``
    An f-string, ``%``-formatted string, or ``.format()`` call passed to
    ``printd``: the formatting runs EVERY call, even with ``OCM_VERBOSE``
    unset — on hot paths that is work (repr of arrays, string building)
    done purely to be thrown away. Pass lazy logging args instead:
    ``printd("x=%d", x)``.

The scanner is deliberately lexical: it prefers a small number of
high-confidence findings plus an explicit suppression comment over a
whole-program points-to analysis (the capture resolution follows names,
never values at run time, and lists in ``GRAPH_HOOKS`` what only a value
carries).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass

BLOCKING_NAME_CALLS = {
    # (module alias, attr) pairs flagged as blocking when called.
    ("time", "sleep"),
    ("socket", "create_connection"),
    ("subprocess", "run"),
    ("subprocess", "Popen"),
    ("subprocess", "call"),
    ("subprocess", "check_call"),
    ("subprocess", "check_output"),
    ("select", "select"),
}
# Bare-name calls that are blocking wire round-trips in this project.
BLOCKING_BARE_CALLS = {"request", "send_msg", "recv_msg"}
# Blocking methods on sockets / threads / processes / events.
BLOCKING_METHODS = {
    "recv", "recv_into", "send", "sendall", "sendmsg", "accept",
    "connect", "join", "wait",
}
# Host-side numpy functions that must not run inside a graph capture.
GRAPH_HOST_NP_CALLS = {
    "asarray", "ascontiguousarray", "array", "frombuffer", "copyto",
    "fromfile", "save", "load", "loadtxt", "genfromtxt", "tobytes",
}
GRAPH_HOST_TIME_CALLS = {"sleep", "time", "perf_counter", "monotonic"}
# Tensor/stream methods that read a device value on the host.
GRAPH_HOST_METHODS = {"item", "cpu", "numpy", "tolist", "synchronize"}
# Calls that bind a step to arguments and hand back one callable: every
# function among their arguments runs wherever that callable runs.
GRAPH_BINDERS = {"hooked_step", "partial"}
# Functions that reach a capture only through the paged decoders' family
# hooks, which travel in ``**hooks`` dicts (``moe.paged_hooks``) that the
# resolution does not follow: the MoE family's hooks run inside every
# captured step of that family.
GRAPH_HOOKS = {
    "oncilla_tpu_torch.models.moe": ("moe_layer_params", "mlp_of"),
}

SUPPRESS_TAG = "ocm-lint: allow[{rule}]"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    symbol: str
    message: str

    def key(self) -> str:
        """Stable baseline key: no line numbers (they churn on every
        edit); rule + file + enclosing symbol."""
        return f"{self.rule}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _is_lockish(name: str) -> bool:
    n = name.lower()
    return (
        n.endswith(("lock", "mutex", "_mu", "_cond"))
        or n in ("mu", "cond", "lck")
    )


def _terminal_name(node: ast.expr) -> str | None:
    """The rightmost identifier of a Name/Attribute chain, else None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dotted(node: ast.expr) -> str | None:
    """'a.b.c' for a pure Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _suppressed(lines: list[str], lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(lines):
        return SUPPRESS_TAG.format(rule=rule) in lines[lineno - 1]
    return False


class _FuncStack(ast.NodeVisitor):
    """Base visitor tracking the enclosing function qualname."""

    def __init__(self) -> None:
        self._stack: list[str] = []

    @property
    def symbol(self) -> str:
        return ".".join(self._stack) or "<module>"

    def _visit_scope(self, node) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope
    visit_ClassDef = _visit_scope


class _LockScopeChecker(_FuncStack):
    """blocking-call-under-lock."""

    def __init__(self, path: str, lines: list[str]):
        super().__init__()
        self.path = path
        self.lines = lines
        self.findings: list[Finding] = []
        # Names of lock objects whose `with` bodies we are inside.
        self._held: list[str] = []

    def visit_With(self, node: ast.With) -> None:
        held_here = []
        for item in node.items:
            name = _terminal_name(item.context_expr)
            if name is not None and _is_lockish(name):
                held_here.append(name)
        self._held.extend(held_here)
        self.generic_visit(node)
        if held_here:
            del self._held[-len(held_here):]

    def _visit_scope(self, node) -> None:
        # A def nested inside a `with lock:` body runs later, not under
        # the lock — analyze it with a clean held-set.
        saved, self._held = self._held, []
        _FuncStack._visit_scope(self, node)
        self._held = saved

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope

    def visit_Call(self, node: ast.Call) -> None:
        if self._held:
            desc = self._blocking_desc(node)
            if desc is not None and not _suppressed(
                self.lines, node.lineno, "blocking-call-under-lock"
            ):
                self.findings.append(Finding(
                    rule="blocking-call-under-lock",
                    path=self.path,
                    line=node.lineno,
                    symbol=self.symbol,
                    message=(
                        f"blocking call {desc} while holding "
                        f"{'/'.join(self._held)}"
                    ),
                ))
        self.generic_visit(node)

    def _blocking_desc(self, node: ast.Call) -> str | None:
        f = node.func
        if isinstance(f, ast.Name):
            if f.id in BLOCKING_BARE_CALLS:
                return f"{f.id}()"
            return None
        if not isinstance(f, ast.Attribute):
            return None
        dotted = _dotted(f)
        if dotted is not None:
            head = dotted.split(".", 1)[0]
            if (head, f.attr) in BLOCKING_NAME_CALLS:
                return f"{dotted}()"
        if f.attr in BLOCKING_METHODS:
            recv = _terminal_name(f.value)
            if recv is None:
                # `",".join(...)`, chained-call receivers: not a socket.
                return None
            if f.attr in ("wait", "join") and _is_lockish(recv):
                # Condition.wait RELEASES the lock — the sanctioned wait
                # pattern, not a hold-across-block.
                return None
            if f.attr == "join" and not (
                "thread" in recv.lower() or recv in ("t", "r", "proc", "p")
            ):
                return None  # list/str joins etc.
            # `lock.acquire` ordering is lockwatch's job, not lint's.
            return f"{recv}.{f.attr}()"
        if f.attr in ("request", "_request"):
            recv = _terminal_name(f.value)
            if recv is not None:
                return f"{recv}.{f.attr}()"
        return None


class _SwallowChecker(_FuncStack):
    """swallowed-exception."""

    BROAD = {"Exception", "BaseException"}

    def __init__(self, path: str, lines: list[str]):
        super().__init__()
        self.path = path
        self.lines = lines
        self.findings: list[Finding] = []

    def _is_broad(self, t: ast.expr | None) -> bool:
        if t is None:
            return True  # bare except
        if isinstance(t, ast.Tuple):
            return any(self._is_broad(e) for e in t.elts)
        return _terminal_name(t) in self.BROAD

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        silent = all(isinstance(s, (ast.Pass, ast.Continue)) for s in node.body)
        if (
            silent
            and self._is_broad(node.type)
            and not _suppressed(self.lines, node.lineno, "swallowed-exception")
        ):
            caught = "bare except" if node.type is None else (
                _dotted(node.type) or "Exception"
            )
            self.findings.append(Finding(
                rule="swallowed-exception",
                path=self.path,
                line=node.lineno,
                symbol=self.symbol,
                message=(
                    f"{caught} silently swallowed — narrow the type or "
                    "log via utils.debug.printd"
                ),
            ))
        self.generic_visit(node)


class _PrintdFormatChecker(_FuncStack):
    """printd-eager-format."""

    def __init__(self, path: str, lines: list[str]):
        super().__init__()
        self.path = path
        self.lines = lines
        self.findings: list[Finding] = []

    def _eager_desc(self, arg: ast.expr) -> str | None:
        if isinstance(arg, ast.JoinedStr):
            return "an f-string"
        if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Mod):
            # "..." % x (or an f-string on the left — doubly eager).
            if isinstance(arg.left, (ast.Constant, ast.JoinedStr)) and (
                not isinstance(arg.left, ast.Constant)
                or isinstance(arg.left.value, str)
            ):
                return "a %-formatted string"
            return None
        if (
            isinstance(arg, ast.Call)
            and isinstance(arg.func, ast.Attribute)
            and arg.func.attr == "format"
        ):
            return "a .format() call"
        return None

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None
        )
        if name == "printd" and node.args:
            desc = self._eager_desc(node.args[0])
            if desc is not None and not _suppressed(
                self.lines, node.lineno, "printd-eager-format"
            ):
                self.findings.append(Finding(
                    rule="printd-eager-format",
                    path=self.path,
                    line=node.lineno,
                    symbol=self.symbol,
                    message=(
                        f"{desc} passed to printd formats even when "
                        "OCM_VERBOSE is unset — use lazy logging args "
                        '(printd("x=%d", x))'
                    ),
                ))
        self.generic_visit(node)


def _is_capture(expr: ast.expr) -> bool:
    """``torch.cuda.graph(...)`` as a ``with`` item."""
    return isinstance(expr, ast.Call) and (_dotted(expr.func) or "") in (
        "torch.cuda.graph", "cuda.graph",
    )


def _hands_to_capture(call: ast.Call) -> bool:
    """Does this call hand its first argument to a graph capture?"""
    f = call.func
    name = _terminal_name(f)
    if name == "CapturedStep":
        return True
    return (
        name == "run"
        and isinstance(f, ast.Attribute)
        and (_terminal_name(f.value) or "").endswith("graphs")
    )


_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _params(fn: ast.AST) -> list[str]:
    a = fn.args
    return [p.arg for p in (
        a.posonlyargs + a.args + a.kwonlyargs
        + ([a.vararg] if a.vararg else []) + ([a.kwarg] if a.kwarg else [])
    )]


class _Module:
    """One module as the capture resolution sees it: its parent links,
    its imports and, for each scope (the module, each function), the
    names that scope binds: ``def`` nodes and assigned values."""

    def __init__(self, name: str, tree: ast.Module, is_pkg: bool):
        self.name = name
        self.tree = tree
        self.parent: dict[ast.AST, ast.AST] = {}
        # alias -> (module, attribute or None when the alias is a module)
        self.imports: dict[str, tuple[str, str | None]] = {}
        self.binds: dict[ast.AST, dict[str, list[ast.AST]]] = {}
        pkg = name if is_pkg else name.rpartition(".")[0]
        for node in ast.walk(tree):
            for ch in ast.iter_child_nodes(node):
                self.parent[ch] = node
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports[a.asname] = (a.name, None)
                    else:
                        top = a.name.partition(".")[0]
                        self.imports[top] = (top, None)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:  # level 1 is ``pkg`` itself
                    parts = pkg.split(".")
                    up = parts[:max(0, len(parts) + 1 - node.level)]
                    base = ".".join([*up, *([base] if base else [])])
                for a in node.names:
                    self.imports[a.asname or a.name] = (base, a.name)
            # breadth first: the links up from ``node`` are all in place
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._bind(self.scope_of(node), node.name, node)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self._bind(self.scope_of(node), t.id, node.value)

    def _bind(self, scope, name: str, value: ast.AST) -> None:
        self.binds.setdefault(scope, {}).setdefault(name, []).append(value)

    def scope_of(self, node: ast.AST) -> ast.AST:
        """The nearest function (or lambda) around ``node``, else the
        module; a class body is not a scope of its methods."""
        p = self.parent.get(node)
        while p is not None and not isinstance(p, _FUNCS):
            p = self.parent.get(p)
        return self.tree if p is None else p

    def qualname(self, fn: ast.AST) -> str:
        parts, n = [], fn
        while n is not None and n is not self.tree:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                parts.append(n.name)
            elif isinstance(n, ast.Lambda):
                parts.append("<lambda>")
            n = self.parent.get(n)
        return ".".join(reversed(parts))


class _CaptureResolver:
    """Which functions run inside a CUDA-graph capture, over the modules
    of one scan. The roots are the callables handed to the capture
    helper (``CapturedStep(fn, ...)``, ``<...>graphs.run(fn, ...)``),
    followed to the function behind them: a local assignment, a binder
    (``hooked_step``/``partial``: the step and the hooks it binds), a
    parameter of the calling function (through that function's call
    sites in its module), an import from another scanned module. From
    the roots, every function a captured body calls by a name that
    resolves the same way (parameters aside) is captured too; method
    calls are not followed. ``GRAPH_HOOKS`` adds the functions that only
    the hook dicts carry there."""

    def __init__(self, modules: dict[str, _Module]):
        self.modules = modules
        self._param_seen: set[tuple[int, str]] = set()

    def _module_attr(self, mod: str, name: str, seen: set) -> set:
        m = self.modules.get(mod)
        if m is None or (mod, name) in seen:
            return set()
        seen.add((mod, name))
        out = set()
        for v in m.binds.get(m.tree, {}).get(name, []):
            out |= self._value(m, v, m.tree, False, seen)
        if not out and name in m.imports:
            out = self._import(*m.imports[name], seen)
        return out

    def _import(self, mod: str, attr: str | None, seen: set) -> set:
        if attr is None or f"{mod}.{attr}" in self.modules:
            return set()  # a module, not a callable
        return self._module_attr(mod, attr, seen)

    def _module_of(self, m: _Module, alias: str) -> str | None:
        mod, attr = m.imports.get(alias, (None, None))
        if mod is None:
            return None
        return mod if attr is None else f"{mod}.{attr}"

    def _value(self, m: _Module, v: ast.AST, scope, params: bool, seen) -> set:
        """The captured functions a bound value stands for."""
        if isinstance(v, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return {(m.name, v)}
        return self.resolve(m, v, scope, params, seen)

    def resolve(self, m: _Module, e: ast.AST, scope, params: bool,
                seen: set | None = None) -> set:
        """The (module, function node) pairs ``e`` names in ``scope``;
        ``params``: follow a parameter to its call sites."""
        seen = set() if seen is None else seen
        if isinstance(e, ast.Lambda):
            return {(m.name, e)}
        if isinstance(e, ast.BoolOp):
            return set().union(*(self.resolve(m, x, scope, params, seen)
                                 for x in e.values))
        if isinstance(e, ast.IfExp):
            return (self.resolve(m, e.body, scope, params, seen)
                    | self.resolve(m, e.orelse, scope, params, seen))
        if isinstance(e, ast.Call):
            if _terminal_name(e.func) not in GRAPH_BINDERS:
                return set()
            args = [*e.args, *(k.value for k in e.keywords)]
            return set().union(*(self.resolve(m, a, scope, params, seen)
                                 for a in args))
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name):
            mod = self._module_of(m, e.value.id)
            return set() if mod is None else self._module_attr(mod, e.attr, seen)
        if not isinstance(e, ast.Name):
            return set()
        s = scope
        while True:
            bound = m.binds.get(s, {}).get(e.id)
            if bound:
                return set().union(*(self._value(m, v, s, params, seen)
                                     for v in bound))
            if s is m.tree:
                break
            if e.id in _params(s):
                return self._param(m, s, e.id, seen) if params else set()
            s = m.scope_of(s)
        if e.id in m.imports:
            return self._import(*m.imports[e.id], seen)
        return set()

    def _param(self, m: _Module, fn: ast.AST, name: str, seen: set) -> set:
        """What the call sites of ``fn`` in its module pass as ``name``."""
        if isinstance(fn, ast.Lambda) or (id(fn), name) in self._param_seen:
            return set()
        self._param_seen.add((id(fn), name))
        positional = [p.arg for p in fn.args.posonlyargs + fn.args.args]
        method = isinstance(m.parent.get(fn), ast.ClassDef)
        if method and positional and positional[0] in ("self", "cls"):
            positional = positional[1:]
        out = set()
        for c in ast.walk(m.tree):
            if not (isinstance(c, ast.Call) and _terminal_name(c.func) == fn.name
                    and isinstance(c.func, ast.Attribute) == method):
                continue
            arg = next((k.value for k in c.keywords if k.arg == name), None)
            if arg is None and name in positional:
                i = positional.index(name)
                if i < len(c.args) and not any(
                        isinstance(a, ast.Starred) for a in c.args[:i + 1]):
                    arg = c.args[i]
            if arg is not None:
                out |= self.resolve(m, arg, m.scope_of(c), True, seen)
        return out

    def captured(self) -> dict[str, set[ast.AST]]:
        """module name -> the function nodes that run inside a capture."""
        todo = set()
        for m in self.modules.values():
            for c in ast.walk(m.tree):
                if isinstance(c, ast.Call) and c.args and _hands_to_capture(c):
                    todo |= self.resolve(m, c.args[0], m.scope_of(c), True)
            for name in GRAPH_HOOKS.get(m.name, ()):
                todo |= self._module_attr(m.name, name, set())
        done: set = set()
        while todo:
            mod, fn = todo.pop()
            if (mod, fn) in done:
                continue
            done.add((mod, fn))
            m = self.modules[mod]
            for c in ast.walk(fn):
                if isinstance(c, ast.Call):
                    todo |= self.resolve(m, c.func, m.scope_of(c), False) - done
        out: dict[str, set[ast.AST]] = {}
        for mod, fn in done:
            out.setdefault(mod, set()).add(fn)
        return out


def _module_name(path: str) -> tuple[str, bool]:
    """The dotted name of the module at ``path`` (its package found by
    the ``__init__.py`` files above it) and whether it is a package."""
    full = os.path.abspath(path)
    d, base = os.path.split(full)
    stem = os.path.splitext(base)[0]
    is_pkg = stem == "__init__"
    parts = [] if is_pkg else [stem]
    while os.path.isfile(os.path.join(d, "__init__.py")):
        d, pkg = os.path.split(d)
        parts.insert(0, pkg)
    return ".".join(parts) or stem, is_pkg


def _captured_in(trees: dict[str, ast.Module]) -> dict[str, tuple]:
    """path -> (its :class:`_Module`, the captured function nodes of its
    tree)."""
    modules, by_path = {}, {}
    for path, tree in trees.items():
        name, is_pkg = _module_name(path)
        modules[name] = by_path[path] = _Module(name, tree, is_pkg)
    got = _CaptureResolver(modules).captured()
    return {path: (m, got.get(m.name, set())) for path, m in by_path.items()}


def _parse_all(paths: list[str]) -> tuple[dict, dict]:
    """The sources of every ``.py`` under ``paths`` and the trees of
    those that parse, by path."""
    sources, trees = {}, {}
    for fp in iter_py_files(paths):
        with open(fp, encoding="utf-8") as fh:
            sources[fp] = fh.read()
        try:
            trees[fp] = ast.parse(sources[fp], filename=fp)
        except SyntaxError:
            pass
    return sources, trees


def captured_functions(paths: list[str]) -> set[str]:
    """``module:qualname`` of every function that runs inside a CUDA-graph
    capture, over the ``.py`` files under ``paths``."""
    return {f"{m.name}:{m.qualname(fn)}"
            for m, fns in _captured_in(_parse_all(paths)[1]).values()
            for fn in fns}


class _GraphCaptureChecker(_FuncStack):
    """graph-host-call over the ``captured`` function nodes of one tree
    (:class:`_CaptureResolver`) and the ``with torch.cuda.graph(...)``
    bodies."""

    def __init__(self, path: str, lines: list[str], tree: ast.Module,
                 captured: set[ast.AST]):
        super().__init__()
        self.path = path
        self.lines = lines
        self.findings: list[Finding] = []
        self.np_alias = "np"
        for stmt in ast.walk(tree):
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    if a.name == "numpy":
                        self.np_alias = a.asname or "numpy"
        self.captured = captured
        self._depth = 0

    def _visit_scope(self, node) -> None:
        entering = node in self.captured
        self._depth += entering
        _FuncStack._visit_scope(self, node)
        self._depth -= entering

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope

    def visit_Lambda(self, node: ast.Lambda) -> None:
        entering = node in self.captured
        self._depth += entering
        self.generic_visit(node)
        self._depth -= entering

    def visit_With(self, node: ast.With) -> None:
        capture = any(_is_capture(item.context_expr) for item in node.items)
        self._depth += capture
        self.generic_visit(node)
        self._depth -= capture

    def _flag(self, node: ast.AST, what: str) -> None:
        if not _suppressed(self.lines, node.lineno, "graph-host-call"):
            self.findings.append(Finding(
                rule="graph-host-call",
                path=self.path,
                line=node.lineno,
                symbol=self.symbol,
                message=f"{what} inside a CUDA-graph capture",
            ))

    def visit_Call(self, node: ast.Call) -> None:
        if self._depth:
            f = node.func
            dotted = _dotted(f) or ""
            parts = dotted.split(".")
            if parts[0] == self.np_alias and len(parts) >= 2:
                if parts[1] == "random":
                    self._flag(node, f"host RNG call {dotted}()")
                elif parts[-1] in GRAPH_HOST_NP_CALLS:
                    self._flag(node, f"host numpy call {dotted}()")
            elif dotted == "print":
                self._flag(node, "print() (runs once at capture time)")
            elif parts[0] == "time" and len(parts) == 2 and (
                parts[1] in GRAPH_HOST_TIME_CALLS
            ):
                self._flag(node, f"host clock call {dotted}()")
            elif isinstance(f, ast.Attribute) and f.attr in GRAPH_HOST_METHODS:
                self._flag(node, f"host read .{f.attr}()")
        self.generic_visit(node)


def lint_source(source: str, path: str,
                captured: set[ast.AST] | None = None,
                tree: ast.Module | None = None) -> list[Finding]:
    """Run every AST rule over one module's source; ``captured`` (with
    the ``tree`` its nodes belong to) comes from a scan of several
    modules, else the module's own captures are resolved alone."""
    if tree is None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            return [Finding(
                rule="syntax-error", path=path, line=e.lineno or 0,
                symbol="<module>", message=str(e),
            )]
    if captured is None:
        captured = _captured_in({path: tree})[path][1]
    lines = source.splitlines()
    checkers = [
        _LockScopeChecker(path, lines),
        _SwallowChecker(path, lines),
        _GraphCaptureChecker(path, lines, tree, captured),
        _PrintdFormatChecker(path, lines),
    ]
    findings: list[Finding] = []
    for c in checkers:
        c.visit(tree)
        findings.extend(c.findings)
    return findings


def iter_py_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                # "fixtures" holds seeded-violation modules for the
                # analyzer's own tests — scanned explicitly, never by walk.
                dirnames[:] = [
                    d for d in dirnames
                    if d not in ("__pycache__", "build", ".git", "native",
                                 "fixtures")
                ]
                out.extend(
                    os.path.join(dirpath, f)
                    for f in filenames if f.endswith(".py")
                )
    return sorted(out)


def scan_paths(paths: list[str], rel_to: str | None = None) -> list[Finding]:
    """Lint every ``.py`` under ``paths``; paths in findings are relative
    to ``rel_to`` (for stable baseline keys across checkouts). The
    graph-capture rule resolves captures across these modules."""
    sources, trees = _parse_all(paths)
    captured = _captured_in(trees)
    findings: list[Finding] = []
    for fp, src in sources.items():
        shown = os.path.relpath(fp, rel_to) if rel_to else fp
        fns = captured[fp][1] if fp in captured else set()
        findings.extend(lint_source(src, shown, fns, trees.get(fp)))
    return findings
