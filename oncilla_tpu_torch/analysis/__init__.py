"""Project-native analysis of the port's own sources: the JAX package's
``oncilla_tpu/analysis`` over ``oncilla_tpu_torch``.

Static passes (the gate, ``python -m oncilla_tpu_torch.analysis``, which
exits nonzero on findings not covered by
``oncilla_tpu_torch/analysis/baseline.json``):

- :mod:`~.lint` — AST checks: blocking calls inside ``with <lock>:``
  scopes, silently swallowed broad exceptions, host calls inside a
  CUDA-graph capture (``graph-host-call``, in place of the JAX package's
  ``jit-host-call``), eagerly formatted ``printd`` arguments.
- :mod:`~.lifecycle` — CFG-based intraprocedural dataflow over alloc
  handles: ``handle-leak-on-path``, ``use-after-free``, ``double-free``.
- :mod:`~.asyncsafety` — asyncio lint over the mux runtime and everything
  on its loop.
- :mod:`~.project` — every request ``MsgType`` of the port's
  ``runtime/protocol.py`` has a handler in its ``runtime/daemon.py``, a
  schema, and an encode/decode roundtrip.
- :mod:`~.conformance` — the port's Python wire against its copy of the
  native daemon (``runtime/native/``); generates the capability matrix in
  ``oncilla_tpu_torch/docs/ARCHITECTURE.md`` with a drift check.
- :mod:`~.rpcgraph` — the distributed wait-graph pass over the port's
  ``runtime/{daemon,client,mux,pool}.py``; generates the RPC topology in
  the same document with a drift check.

Runtime hooks the daemon carries: the lock-order watchdog
(:mod:`.lockwatch`, ``OCM_LOCKWATCH=1``), the unified wait-for graph
(:mod:`.waitwatch`, ``OCM_WAITWATCH=1``) and the allocation ledger
(:mod:`.alloctrace`, ``OCM_ALLOCTRACE=1``).
"""

from oncilla_tpu_torch.analysis.asyncsafety import scan_async
from oncilla_tpu_torch.analysis.conformance import check_conformance
from oncilla_tpu_torch.analysis.lifecycle import analyze_source, scan_lifecycle
from oncilla_tpu_torch.analysis.lint import Finding, scan_paths
from oncilla_tpu_torch.analysis.project import check_protocol
from oncilla_tpu_torch.analysis.rpcgraph import check_rpcgraph, scan_rpcgraph

__all__ = [
    "Finding", "scan_paths", "check_protocol", "scan_lifecycle",
    "analyze_source", "scan_async", "check_conformance",
    "scan_rpcgraph", "check_rpcgraph",
]
