"""Cluster observability, the port's copies of ``oncilla_tpu/obs``:
distributed tracing, the event journal, the exporters and the CLI.

- :mod:`~.trace` — (trace_id, span_id) context minted per logical op,
  carried on the wire as a capability-negotiated 16-byte prefix so one
  trace_id stitches client span → local daemon span → peer daemon span.
- :mod:`~.journal` — bounded per-process JSONL event ring
  (``OCM_EVENTS=1``): spans, lease renewals/reclaims, stripe retries,
  tuner window changes, slow-op flags.
- :mod:`~.flightrec` — the ring's crash-safe twin
  (``OCM_FLIGHTREC=dir``): every event also streams into bounded
  CRC-framed segment files, and kill paths flush the ring, so a dead
  daemon leaves its black box on disk.
- :mod:`~.audit` — the post-mortem correctness oracle: merges segments
  cluster-wide and runs cross-rank invariant checks with typed findings
  and a nonzero CLI exit (``python -m oncilla_tpu_torch.obs audit <dir>``,
  or ``python -m oncilla_tpu_torch.obs.audit <dir>``).
- :mod:`~.export` — merge client + daemon journals into one
  Perfetto/Chrome-trace JSON (pid track per process/daemon, trace_id
  stitched as flow events across tracks).
- :mod:`~.critpath` — cross-rank op trees from recorded spans and the
  per-phase critical-path latency attribution.
- :mod:`~.scrape` / :mod:`~.slo` — the in-process metrics history fed by
  STATUS_PROM scrapes, and the burn-rate SLO engine over it
  (``Ocm.start_slo``, ``status()["slo"]``).
- :mod:`~.prom` — Prometheus text exposition of the Tracer counters,
  arena occupancy, and lease health, served in-band through the
  STATUS_PROM protocol request (no extra listening port).
- :mod:`~.watchdog` — ``OCM_SLOWOP_US``: a thread that flags spans
  exceeding the threshold into the journal with their trace context.
- ``python -m oncilla_tpu_torch.obs`` — the cluster CLI (status table,
  ``--prom``, ``--trace``, ``--watch``, ``--smoke``, ``audit``,
  ``critpath``, ``slo``; see :mod:`~.__main__`).

This module must stay import-light: :mod:`oncilla_tpu_torch.utils.debug`
imports :mod:`~.trace` / :mod:`~.journal` at module level, which runs
while ``oncilla_tpu_torch/__init__`` may still be mid-import — submodules
here therefore depend on the stdlib only (and never on the package root).
"""
