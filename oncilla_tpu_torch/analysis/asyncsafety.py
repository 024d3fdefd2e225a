"""Asyncio-safety lint for the mux runtime and everything riding it.

The async surface (``runtime/mux.py``, ``AsyncOcm``, the serving
prefetch path) multiplexes thousands of tenants over one event loop per
process — one blocked coroutine stalls every tenant on that loop, and
the failure is invisible in tests that run a single tenant. These rules
target the exact bug shapes this codebase has shipped or reviewed out:

``async-blocking-call``
    A synchronous blocking call inside a coroutine: ``time.sleep``,
    socket dial/send/recv, ``select``/``subprocess``, ``open``, thread
    joins, or the project's blocking wire helpers (``request`` /
    ``send_msg`` / ``recv_msg`` / sync ``PeerPool.lease``). Every one of
    these freezes the whole event loop for its duration; use the
    ``asyncio`` equivalent or ``run_in_executor``.

``async-lock-held-across-await``
    A ``with``/``async with`` on a lock-ish object whose body awaits.
    For a ``threading`` lock this can deadlock the loop outright (the
    task that would release it can never be scheduled); for an
    ``asyncio.Lock`` it serializes every tenant behind the slowest
    awaited round trip. The two deliberate lockstep-mode sites in
    ``runtime/mux.py`` carry ``# ocm-lint:
    allow[async-lock-held-across-await]`` with their justification.

``async-tls-install-across-await``
    Thread-local state installed inside a coroutine: a call to a
    ``*.install(...)`` helper (the ``obs/trace.py`` /
    ``resilience/timebudget.py`` ambient-context API), or a ``with
    ...installed(...)`` block whose body awaits. Thread-locals do not
    follow tasks across ``await`` — the ``Tracer`` bug once shipped
    exactly this shape, stamping one tenant's trace context onto
    another tenant's frames. Coroutines must thread context explicitly
    (see the ``runtime/mux.py`` module docstring).

``async-untracked-task``
    A bare ``create_task(...)`` / ``ensure_future(...)`` expression
    whose task object is never stored, awaited, or returned. The event
    loop holds only a weak reference to running tasks: an unreferenced
    task can be garbage-collected mid-flight, silently cancelling the
    work. Keep a strong reference (``self._tasks.add(t)`` +
    ``add_done_callback(discard)``).

Same mechanics as :mod:`oncilla_tpu_torch.analysis.lint`: lexical, per-line
``# ocm-lint: allow[<rule>]`` suppression, findings feed the shared
baseline/CLI machinery.
"""

from __future__ import annotations

import ast
import os

from oncilla_tpu_torch.analysis.lint import (
    BLOCKING_BARE_CALLS,
    BLOCKING_METHODS,
    BLOCKING_NAME_CALLS,
    Finding,
    _dotted,
    _FuncStack,
    _is_lockish,
    _suppressed,
    _terminal_name,
    iter_py_files,
)

ASYNC_RULES = frozenset({
    "async-blocking-call",
    "async-lock-held-across-await",
    "async-tls-install-across-await",
    "async-untracked-task",
})

_TASK_SPAWNERS = {"create_task", "ensure_future"}

# APIs whose call arguments are coroutine objects being constructed, not
# sync calls executing inline: ``wait_for(ch.request(...))`` drives the
# coroutine, it does not block the loop.
_CORO_WRAPPERS = _TASK_SPAWNERS | {
    "wait_for", "gather", "shield", "wait", "run_coroutine_threadsafe",
    "run_until_complete", "run", "submit",
}


def _has_await(stmts: list[ast.stmt]) -> bool:
    """Any Await in these statements, NOT counting nested function
    bodies (those run later, outside this scope's critical section)."""
    work: list[ast.AST] = list(stmts)
    while work:
        node = work.pop()
        if isinstance(node, (ast.Await,)):
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        work.extend(ast.iter_child_nodes(node))
    return False


class _AsyncChecker(_FuncStack):
    """All four async rules in one pass."""

    def __init__(self, path: str, lines: list[str]):
        super().__init__()
        self.path = path
        self.lines = lines
        self.findings: list[Finding] = []
        self._async_depth = 0
        # Call nodes that are the direct operand of an ``await`` — those
        # are coroutines being driven, not sync calls blocking the loop.
        self._awaited: set[int] = set()

    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        if not _suppressed(self.lines, node.lineno, rule):
            self.findings.append(Finding(
                rule=rule, path=self.path, line=node.lineno,
                symbol=self.symbol, message=msg,
            ))

    # -- scope tracking --------------------------------------------------

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._async_depth += 1
        _FuncStack._visit_scope(self, node)
        self._async_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # A sync def nested in a coroutine is analyzed as sync code (it
        # can still block the loop when called, but flagging its body as
        # "inside a coroutine" would double-report through helpers).
        saved, self._async_depth = self._async_depth, 0
        _FuncStack._visit_scope(self, node)
        self._async_depth = saved

    def visit_Await(self, node: ast.Await) -> None:
        if isinstance(node.value, ast.Call):
            self._awaited.add(id(node.value))
        self.generic_visit(node)

    # -- async-untracked-task (applies in sync code too: the mux runtime
    # spawns from sync entry points) ------------------------------------

    def visit_Expr(self, node: ast.Expr) -> None:
        v = node.value
        call = v.value if isinstance(v, ast.Await) else v
        if (
            isinstance(call, ast.Call)
            and not isinstance(v, ast.Await)
            and _terminal_name(call.func) in _TASK_SPAWNERS
        ):
            self._flag(
                "async-untracked-task", node,
                f"{_terminal_name(call.func)}(...) result discarded — the "
                "loop keeps only a weak reference, so the task can be "
                "garbage-collected mid-flight; store it and discard on "
                "done",
            )
        self.generic_visit(node)

    # -- lock / thread-local held across await ---------------------------

    def _check_with(self, node: ast.With | ast.AsyncWith) -> None:
        if not self._async_depth or not _has_await(node.body):
            self.generic_visit(node)
            return
        for item in node.items:
            ctx = item.context_expr
            name = _terminal_name(
                ctx.func if isinstance(ctx, ast.Call) else ctx
            )
            if name is None:
                continue
            if _is_lockish(name):
                kind = ("asyncio lock" if isinstance(node, ast.AsyncWith)
                        else "thread lock")
                self._flag(
                    "async-lock-held-across-await", node,
                    f"{kind} {name!r} held across an await — every other "
                    "task on this loop queues behind the awaited round "
                    "trip" + (
                        "" if isinstance(node, ast.AsyncWith)
                        else " (and a sync lock can deadlock the loop)"
                    ),
                )
            elif name == "installed" and isinstance(ctx, ast.Call):
                self._flag(
                    "async-tls-install-across-await", node,
                    f"`with {_dotted(ctx.func) or name}(...)` spans an "
                    "await — thread-local context does not follow the "
                    "task across suspension points; thread it explicitly "
                    "(the Tracer bug shape)",
                )
        self.generic_visit(node)

    visit_With = _check_with
    visit_AsyncWith = _check_with

    # -- blocking calls + bare install() ---------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        if _terminal_name(node.func) in _CORO_WRAPPERS:
            for a in node.args:
                if isinstance(a, ast.Call):
                    self._awaited.add(id(a))
        if self._async_depth and id(node) not in self._awaited:
            if _terminal_name(node.func) == "install":
                dotted = _dotted(node.func) or "install"
                self._flag(
                    "async-tls-install-across-await", node,
                    f"{dotted}(...) installs thread-local context inside "
                    "a coroutine — it will not follow the task across the "
                    "next await; thread the context explicitly",
                )
            else:
                desc = self._blocking_desc(node)
                if desc is not None:
                    self._flag(
                        "async-blocking-call", node,
                        f"blocking call {desc} inside a coroutine stalls "
                        "the whole event loop — use the asyncio "
                        "equivalent or run_in_executor",
                    )
        self.generic_visit(node)

    def _blocking_desc(self, node: ast.Call) -> str | None:
        f = node.func
        if isinstance(f, ast.Name):
            if f.id in BLOCKING_BARE_CALLS or f.id == "open":
                return f"{f.id}()"
            return None
        if not isinstance(f, ast.Attribute):
            return None
        dotted = _dotted(f)
        if dotted is not None:
            head = dotted.split(".", 1)[0]
            if head == "asyncio":
                return None
            if (head, f.attr) in BLOCKING_NAME_CALLS:
                return f"{dotted}()"
        if f.attr in BLOCKING_METHODS:
            recv = _terminal_name(f.value)
            if recv is None:
                return None
            if "loop" in recv.lower():
                return None  # loop.sock_* / loop.connect_* are async APIs
            if f.attr in ("wait", "join") and _is_lockish(recv):
                return None
            if f.attr == "join" and not (
                "thread" in recv.lower() or recv in ("t", "r", "proc", "p")
            ):
                return None
            return f"{recv}.{f.attr}()"
        if f.attr in ("request", "_request"):
            recv = _terminal_name(f.value)
            if recv is not None:
                return f"{recv}.{f.attr}()"
        if f.attr == "lease":
            recv = _terminal_name(f.value)
            if recv is not None and "pool" in recv.lower():
                return f"{recv}.lease()"  # sync PeerPool on the loop
        return None


def lint_async_source(source: str, path: str) -> list[Finding]:
    """Run the async rules over one module's source."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []  # lint.py already reports syntax-error
    checker = _AsyncChecker(path, source.splitlines())
    checker.visit(tree)
    return checker.findings


def scan_async(paths: list[str], rel_to: str | None = None) -> list[Finding]:
    """Async-lint every ``.py`` under ``paths`` (same walk/pruning and
    relative-path conventions as :func:`lint.scan_paths`)."""
    findings: list[Finding] = []
    for fp in iter_py_files(paths):
        with open(fp, encoding="utf-8") as fh:
            src = fh.read()
        shown = os.path.relpath(fp, rel_to) if rel_to else fp
        findings.extend(lint_async_source(src, shown))
    return findings
