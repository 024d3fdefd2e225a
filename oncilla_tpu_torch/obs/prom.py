"""Prometheus text exposition of one daemon's metrics.

Renders the dict ``Daemon._metrics_meta()`` builds — Tracer op counters,
the DCN transfer ring, arena occupancy, live-alloc and lease health —
in the text format (version 0.0.4) standard scrapers parse: one
``# HELP``/``# TYPE`` pair per family, then its samples, no duplicate
series. Served in-band through the STATUS_PROM protocol request (no
extra listening port on the daemon); ``python -m oncilla_tpu.obs
--prom <rank>`` is the scrape-side shim.

Every series carries a ``rank`` label so a scraper federating several
daemons through one relabeling path keeps them apart.
"""

from __future__ import annotations

import re

_ESC = str.maketrans({"\\": r"\\", '"': r'\"', "\n": r"\n"})

_SAMPLE_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+$")
_EXEMPLAR_RE = re.compile(r" # \{[^{}]*\} [^ ]+( [^ ]+)?$")


def validate(text: str) -> dict[str, list[str]]:
    """Format-check a text exposition (version 0.0.4): HELP/TYPE pairs
    precede their family's samples, families are contiguous (never
    interleaved), histogram samples use their family's
    ``_bucket``/``_sum``/``_count`` names, no duplicate series, every
    value parses as a float. Returns ``{family: [sample lines...]}``;
    raises :class:`ValueError` on the first violation.

    This is the library twin of the test suite's checker — the thing
    CI scrapes a NATIVE daemon's STATUS_PROM through, so the C++
    renderer is held to the same format bar as this module."""
    families: dict[str, list[str]] = {}
    typed: dict[str, str] = {}
    cur: str | None = None
    seen: set[str] = set()
    closed: set[str] = set()

    def bad(msg: str):
        raise ValueError(f"prom format: {msg}")

    for line in text.splitlines():
        if line.strip() != line or not line:
            bad(f"stray whitespace or blank line: {line!r}")
        if line.startswith("# HELP "):
            fam = line.split()[2]
            if fam in families:
                bad(f"duplicate HELP for {fam}")
            if cur is not None:
                closed.add(cur)
            families[fam] = []
            cur = fam
        elif line.startswith("# TYPE "):
            _, _, fam, kind = line.split(None, 3)
            if fam != cur:
                bad(f"TYPE {fam} outside its family block")
            if kind not in ("counter", "gauge", "histogram", "summary"):
                bad(f"unknown TYPE {kind}")
            typed[fam] = kind
        else:
            if cur is None:
                bad(f"sample before any family: {line!r}")
            raw = line
            ex = _EXEMPLAR_RE.search(line)
            if ex is not None:
                if typed.get(cur) != "histogram":
                    bad(f"exemplar outside a histogram family: {line!r}")
                line = line[: ex.start()]
            if not _SAMPLE_RE.match(line):
                bad(f"malformed sample: {line!r}")
            series, value = line.rsplit(" ", 1)
            fam = series.split("{", 1)[0]
            if typed.get(cur) == "histogram":
                if fam not in (cur, f"{cur}_bucket", f"{cur}_sum",
                               f"{cur}_count"):
                    bad(f"sample {fam} interleaved into histogram {cur}")
            elif fam != cur:
                bad(f"sample {fam} interleaved into {cur}")
            if fam in closed:
                bad(f"family {fam} reopened")
            if series in seen:
                bad(f"duplicate series {series}")
            seen.add(series)
            try:
                float(value)
            except ValueError:
                bad(f"non-numeric value in {raw!r}")
            families[cur].append(raw)
    if not families:
        bad("no families rendered")
    if set(families) != set(typed):
        bad("family missing a TYPE line")
    return families


def _label(**labels: object) -> str:
    inner = ",".join(
        f'{k}="{str(v).translate(_ESC)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


def _num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Doc:
    """Accumulates samples per family; :meth:`text` renders each family
    as one HELP line, one TYPE line, then ALL its samples consecutively —
    the format forbids interleaving a family's samples with another's,
    so grouping is deferred to render time."""

    def __init__(self) -> None:
        # family -> (kind, help, [sample lines]); insertion-ordered.
        self._fams: dict[str, tuple[str, str, list[str]]] = {}

    def sample(self, family: str, kind: str, help_: str,
               value: float, *, name: str | None = None,
               exemplar: str = "", **labels: object) -> None:
        """``name`` overrides the sample's metric name while keeping it
        grouped (and HELP/TYPE'd) under ``family`` — how a histogram's
        ``_bucket``/``_sum``/``_count`` samples ride their base family.
        ``exemplar`` is an OpenMetrics-style ``# {...} value ts`` tail
        appended verbatim (scrapers that predate exemplars ignore
        everything after the ``#``)."""
        fam = self._fams.get(family)
        if fam is None:
            fam = self._fams[family] = (kind, help_, [])
        fam[2].append(
            f"{name or family}{_label(**labels)} {_num(value)}{exemplar}"
        )

    def text(self) -> str:
        lines: list[str] = []
        for family, (kind, help_, samples) in self._fams.items():
            lines.append(f"# HELP {family} {help_}")
            lines.append(f"# TYPE {family} {kind}")
            lines.extend(samples)
        return "\n".join(lines) + "\n"


def _serving_samples(doc: "_Doc", srv: dict, rank) -> None:
    """The ``ocm_serving_*`` / ``ocm_kv_*`` / ``ocm_prefix_*`` families
    from one or more co-located serving engines' meta blocks
    (``serving/metrics.py`` snapshot shape)."""
    for eng in srv.get("engines", []):
        name = eng.get("engine", "engine")
        toks = eng.get("tokens", {})
        for phase in ("prefill", "decode"):
            doc.sample("ocm_serving_tokens_total", "counter",
                       "Tokens processed by a co-located serving engine, "
                       "by phase.",
                       toks.get(phase, 0), rank=rank, engine=name,
                       phase=phase)
        doc.sample("ocm_kv_hit_ratio", "gauge",
                   "Fraction of scheduled KV page lookups served from "
                   "the fast (HBM) tier.",
                   eng.get("hit_ratio", 0.0), rank=rank, engine=name)
        for tier, nbytes in sorted(eng.get("tier_bytes", {}).items()):
            doc.sample("ocm_kv_tier_bytes", "gauge",
                       "Live KV page bytes per storage tier.",
                       nbytes, rank=rank, engine=name, tier=tier)
        pref = eng.get("prefix", {})
        doc.sample("ocm_prefix_shared_bytes", "gauge",
                   "KV bytes currently referenced through shared "
                   "prefix-cache extents.",
                   pref.get("shared_bytes", 0), rank=rank, engine=name)
        doc.sample("ocm_prefix_hits_total", "counter",
                   "Prefix-cache extent acquisitions (prompt pages NOT "
                   "recomputed or re-stored).",
                   pref.get("hits", 0), rank=rank, engine=name)
        doc.sample("ocm_prefix_cow_total", "counter",
                   "Copy-on-write page copies taken at prefix "
                   "divergence points.",
                   pref.get("cow", 0), rank=rank, engine=name)
        doc.sample("ocm_prefetch_stall_seconds_total", "counter",
                   "Decode time spent waiting on KV page fetches "
                   "(prefetch lost the race, or a plain page fault).",
                   eng.get("stall_s", 0.0), rank=rank, engine=name)
        moves = eng.get("moves", {})
        for direction in ("promote", "demote"):
            doc.sample("ocm_kv_page_moves_total", "counter",
                       "KV page tier relocations by direction.",
                       moves.get(direction, 0), rank=rank, engine=name,
                       dir=direction)
        batch = eng.get("batch")
        if batch:
            # size_hist/step_s_hist arrive already cumulative
            # (serving/metrics.py counts every bucket >= the observation)
            # so they render directly as prom histograms.
            steps = batch.get("steps", 0)
            fam = "ocm_serving_batch_size"
            help_ = ("Sessions fused per batched decode step "
                     "(cumulative histogram; _count = fused steps).")
            for le, n in sorted(batch.get("size_hist", {}).items()):
                doc.sample(fam, "histogram", help_, n,
                           name=fam + "_bucket", rank=rank, engine=name,
                           le=_num(le))
            doc.sample(fam, "histogram", help_, steps,
                       name=fam + "_bucket", rank=rank, engine=name,
                       le="+Inf")
            doc.sample(fam, "histogram", help_,
                       batch.get("size_sum", 0), name=fam + "_sum",
                       rank=rank, engine=name)
            doc.sample(fam, "histogram", help_, steps,
                       name=fam + "_count", rank=rank, engine=name)
            fam = "ocm_serving_step_seconds"
            help_ = ("Wall time of one fused batched decode step "
                     "(cumulative histogram).")
            for le, n in sorted(batch.get("step_s_hist", {}).items()):
                doc.sample(fam, "histogram", help_, n,
                           name=fam + "_bucket", rank=rank, engine=name,
                           le=_num(le))
            doc.sample(fam, "histogram", help_, steps,
                       name=fam + "_bucket", rank=rank, engine=name,
                       le="+Inf")
            doc.sample(fam, "histogram", help_, batch.get("step_s", 0.0),
                       name=fam + "_sum", rank=rank, engine=name)
            doc.sample(fam, "histogram", help_, steps,
                       name=fam + "_count", rank=rank, engine=name)
            doc.sample("ocm_serving_prefill_chunks_total", "counter",
                       "Page-sized chunked-prefill slices dispatched "
                       "between batched decode steps.",
                       batch.get("prefill_chunks", 0), rank=rank,
                       engine=name)
        ttft = eng.get("ttft")
        if ttft and ttft.get("count"):
            # Cumulative-by-construction like the batch histograms.
            n = ttft.get("count", 0)
            fam = "ocm_serving_ttft_seconds"
            help_ = ("Time from request submit to first emitted token "
                     "(cumulative histogram).")
            for le, cnt in sorted(ttft.get("hist", {}).items()):
                doc.sample(fam, "histogram", help_, cnt,
                           name=fam + "_bucket", rank=rank, engine=name,
                           le=_num(le))
            doc.sample(fam, "histogram", help_, n,
                       name=fam + "_bucket", rank=rank, engine=name,
                       le="+Inf")
            doc.sample(fam, "histogram", help_, ttft.get("sum_s", 0.0),
                       name=fam + "_sum", rank=rank, engine=name)
            doc.sample(fam, "histogram", help_, n,
                       name=fam + "_count", rank=rank, engine=name)
        for reason, n in sorted(eng.get("preempts", {}).items()):
            doc.sample("ocm_serving_preempts_total", "counter",
                       "Batch-slot preemptions by reason (slot = lost "
                       "priority contention; cold_page = yielded while "
                       "pages prefetch).",
                       n, rank=rank, engine=name, reason=reason)


def render_serving(srv: dict, rank: int = 0) -> str:
    """Standalone exposition of serving metrics (what ``python -m
    oncilla_tpu.serving --prom``-style tooling and the tests scrape
    without a daemon in the process)."""
    doc = _Doc()
    _serving_samples(doc, srv, rank)
    return doc.text()


def render(meta: dict) -> str:
    rank = meta.get("rank", 0)
    doc = _Doc()
    doc.sample("ocm_nnodes", "gauge", "Cluster size as this daemon sees it.",
               meta.get("nnodes", 0), rank=rank)
    doc.sample("ocm_live_allocs", "gauge",
               "Live allocations registered on this daemon.",
               meta.get("live_allocs", 0), rank=rank)

    for op, st in sorted(meta.get("ops", {}).items()):
        doc.sample("ocm_op_total", "counter",
                   "Completed Tracer spans per op.",
                   st.get("count", 0), rank=rank, op=op)
        doc.sample("ocm_op_bytes_total", "counter",
                   "Bytes moved by completed spans per op.",
                   st.get("total_bytes", 0), rank=rank, op=op)
        doc.sample("ocm_op_p50_seconds", "gauge",
                   "p50 span latency over the sample ring.",
                   st.get("p50_us", 0.0) / 1e6, rank=rank, op=op)
        doc.sample("ocm_op_p99_seconds", "gauge",
                   "p99 span latency over the sample ring.",
                   st.get("p99_us", 0.0) / 1e6, rank=rank, op=op)
        doc.sample("ocm_op_gigabits_per_second", "gauge",
                   "Lifetime mean throughput per op (gigabits/s).",
                   st.get("gbps", 0.0), rank=rank, op=op)
        hist = st.get("hist")
        if hist:
            # Real cumulative histogram (lifetime counters, unlike the
            # ring-windowed p50/p99 gauges) with trace-id exemplars in
            # the OpenMetrics style on the bucket that holds the most
            # recent traced span.
            fam = "ocm_op_latency_seconds"
            help_ = ("Span latency histogram per op (cumulative "
                     "lifetime counts; exemplars carry trace ids).")
            cum = 0
            exemplars = hist.get("exemplars") or {}
            for i, le in enumerate(hist.get("le", [])):
                cum += hist["counts"][i]
                ex = exemplars.get(str(i))
                tail = (
                    f' # {{trace_id="{ex["trace_id"]}"}} '
                    f'{_num(ex["value"])} {_num(ex["ts"])}'
                    if ex else ""
                )
                doc.sample(fam, "histogram", help_, cum,
                           name=fam + "_bucket", exemplar=tail,
                           rank=rank, op=op, le=_num(le))
            cum += hist["counts"][-1] if hist.get("counts") else 0
            doc.sample(fam, "histogram", help_, cum,
                       name=fam + "_bucket", rank=rank, op=op, le="+Inf")
            doc.sample(fam, "histogram", help_, hist.get("sum_s", 0.0),
                       name=fam + "_sum", rank=rank, op=op)
            doc.sample(fam, "histogram", help_, cum,
                       name=fam + "_count", rank=rank, op=op)

    arena = meta.get("host_arena", {})
    doc.sample("ocm_arena_live_bytes", "gauge",
               "Bytes currently reserved in an arena.",
               arena.get("live_bytes", 0), rank=rank, arena="host")
    doc.sample("ocm_arena_capacity_bytes", "gauge",
               "Arena capacity in bytes.",
               arena.get("capacity_bytes", 0), rank=rank, arena="host")
    for i, book in enumerate(meta.get("device_books", [])):
        doc.sample("ocm_arena_live_bytes", "gauge",
                   "Bytes currently reserved in an arena.",
                   book.get("live_bytes", 0), rank=rank, arena=f"device{i}")
        doc.sample("ocm_arena_capacity_bytes", "gauge",
                   "Arena capacity in bytes.",
                   book.get("capacity_bytes", 0),
                   rank=rank, arena=f"device{i}")

    leases = meta.get("leases", {})
    doc.sample("ocm_lease_renewals_total", "counter",
               "Heartbeat-driven lease renewals processed.",
               leases.get("renewals", 0), rank=rank)
    doc.sample("ocm_lease_reclaims_total", "counter",
               "Allocations the lease reaper took back.",
               leases.get("reclaims", 0), rank=rank)
    doc.sample("ocm_leases_expired", "gauge",
               "Live allocations currently past their lease.",
               leases.get("expired", 0), rank=rank)
    for app, age_s in sorted(leases.get("apps", {}).items()):
        doc.sample("ocm_app_heartbeat_age_seconds", "gauge",
                   "Seconds since an app's last heartbeat.",
                   age_s, rank=rank, app=app)

    res = meta.get("resilience", {})
    if res:
        doc.sample("ocm_cluster_epoch", "gauge",
                   "Cluster epoch as this daemon knows it (bumped per "
                   "DEAD verdict).",
                   res.get("epoch", 0), rank=rank)
        doc.sample("ocm_fenced", "gauge",
                   "1 when this daemon is fenced by a newer epoch "
                   "(refusing writes).",
                   int(bool(res.get("fenced", False))), rank=rank)
        for peer, st in sorted(res.get("peers", {}).items()):
            doc.sample("ocm_peer_state", "gauge",
                       "Failure-detector verdict per peer "
                       "(0 ALIVE, 1 SUSPECT, 2 DEAD).",
                       {"ALIVE": 0, "SUSPECT": 1, "DEAD": 2}.get(st, 0),
                       rank=rank, peer=peer)
        fo = res.get("failover", {})
        doc.sample("ocm_failover_deaths_total", "counter",
                   "DEAD verdicts issued by this daemon (rank 0 only).",
                   fo.get("deaths", 0), rank=rank)
        doc.sample("ocm_failover_promotions_total", "counter",
                   "Replica entries promoted to primary on this daemon.",
                   fo.get("promotions", 0), rank=rank)
        doc.sample("ocm_rereplications_total", "counter",
                   "Repair copies driven to restore k (rank 0 only).",
                   fo.get("rereplications", 0), rank=rank)
        doc.sample("ocm_replica_put_errors_total", "counter",
                   "Put fan-out legs that failed (put rejected, "
                   "retryable).",
                   fo.get("repl_put_errors", 0), rank=rank)
        doc.sample("ocm_replica_put_skips_total", "counter",
                   "Put fan-out legs skipped because the replica is "
                   "DEAD (degraded until re-replication).",
                   fo.get("repl_put_skips", 0), rank=rank)
        # Leadership (control/): who coordinates, under which epoch,
        # and how often the role moved.
        doc.sample("ocm_leader_rank", "gauge",
                   "Rank this daemon believes currently leads the "
                   "cluster (the master role as an epoch-fenced lease).",
                   res.get("leader", 0), rank=rank)
        doc.sample("ocm_leader_epoch", "gauge",
                   "Cluster epoch at which leadership last changed, as "
                   "this daemon adopted it.",
                   res.get("leader_epoch", 0), rank=rank)
        lc = res.get("leadership", {})
        for outcome, key in (("won", "elections_won"),
                             ("observed", "elections_observed"),
                             ("handoff", "handoffs")):
            doc.sample("ocm_elections_total", "counter",
                       "Leadership changes seen by this daemon, by how "
                       "it was involved.",
                       lc.get(key, 0), rank=rank, outcome=outcome)
        doc.sample("ocm_master_state_pushes_total", "counter",
                   "MASTER_STATE replication pushes sent as leader.",
                   lc.get("state_pushes", 0), rank=rank)
        doc.sample("ocm_master_state_resyncs_total", "counter",
                   "Whole re-syncs at promotion (replicated copy "
                   "missing, stale, or CRC-refused).",
                   lc.get("state_resyncs", 0), rank=rank)
        doc.sample("ocm_hash_placements_total", "counter",
                   "REQ_ALLOCs placed locally by rendezvous hashing "
                   "(zero leader round trips).",
                   lc.get("hash_placements", 0), rank=rank)

    qos = meta.get("qos", {})
    if qos:
        qc = qos.get("counters", {})
        doc.sample("ocm_admission_denied_total", "counter",
                   "REQ_ALLOC rejections by admission control, "
                   "by reason.",
                   qc.get("quota_exceeded", 0),
                   rank=rank, reason="quota_exceeded")
        doc.sample("ocm_admission_denied_total", "counter",
                   "REQ_ALLOC rejections by admission control, "
                   "by reason.",
                   qc.get("admission_denied", 0),
                   rank=rank, reason="max_apps")
        doc.sample("ocm_backpressure_busy_total", "counter",
                   "REQ_ALLOC answered retryable BUSY past the "
                   "high watermark.",
                   qc.get("busy", 0), rank=rank)
        for prio, rec in sorted(
            (qos.get("evictions_by_priority") or {}).items()
        ):
            doc.sample("ocm_evictions_by_priority", "counter",
                       "Pressure evictions by priority class and lease "
                       "state.",
                       rec.get("expired", 0),
                       rank=rank, priority=prio, lease="expired")
            doc.sample("ocm_evictions_by_priority", "counter",
                       "Pressure evictions by priority class and lease "
                       "state.",
                       rec.get("active", 0),
                       rank=rank, priority=prio, lease="active")
        for prio, rec in sorted(
            (qos.get("demotions_by_priority") or {}).items()
        ):
            doc.sample("ocm_demotions_by_priority", "counter",
                       "Pressure victims demoted to the frozen tier "
                       "(bytes survive on disk) by priority class and "
                       "lease state.",
                       rec.get("expired", 0),
                       rank=rank, priority=prio, lease="expired")
            doc.sample("ocm_demotions_by_priority", "counter",
                       "Pressure victims demoted to the frozen tier "
                       "(bytes survive on disk) by priority class and "
                       "lease state.",
                       rec.get("active", 0),
                       rank=rank, priority=prio, lease="active")
        for app, rec in sorted((qos.get("apps") or {}).items()):
            doc.sample("ocm_quota_bytes_used", "gauge",
                       "Live admitted bytes per app (origin-daemon "
                       "view).",
                       rec.get("used_bytes", 0),
                       rank=rank, app=app,
                       priority=rec.get("priority", 1))
            doc.sample("ocm_quota_handles_used", "gauge",
                       "Live admitted handles per app.",
                       rec.get("handles", 0), rank=rank, app=app)
        for peer, score in sorted((qos.get("load_scores") or {}).items()):
            doc.sample("ocm_placement_load_score", "gauge",
                       "Load-aware placement score per rank "
                       "(0 cold .. ~0.9 hot).",
                       score, rank=rank, peer=peer)

    fab = meta.get("fabric", {})
    if fab:
        for name in fab.get("served", []):
            doc.sample("ocm_fabric_served", "gauge",
                       "1 for each one-sided fabric this daemon "
                       "registered and advertises at CONNECT.",
                       1, rank=rank, fabric=name)
        fc = fab.get("counters", {})
        doc.sample("ocm_fabric_selected_total", "counter",
                   "CONNECT fabric negotiations by outcome (shm = "
                   "descriptor granted; tcp = declined, framed-TCP "
                   "fallback).",
                   fc.get("selected_shm", 0), rank=rank, fabric="shm")
        doc.sample("ocm_fabric_selected_total", "counter",
                   "CONNECT fabric negotiations by outcome (shm = "
                   "descriptor granted; tcp = declined, framed-TCP "
                   "fallback).",
                   fc.get("selected_tcp", 0), rank=rank, fabric="tcp")
        for op in ("put", "get"):
            doc.sample("ocm_fabric_ops_total", "counter",
                       "One-sided ops validated per fabric and "
                       "direction.",
                       fc.get(f"shm_{op}s", 0),
                       rank=rank, fabric="shm", op=op)
            doc.sample("ocm_fabric_bytes_total", "counter",
                       "Bytes moved through one-sided fabric ops per "
                       "direction.",
                       fc.get(f"shm_{op}_bytes", 0),
                       rank=rank, fabric="shm", op=op)

    ela = meta.get("elastic", {})
    if ela:
        doc.sample("ocm_cluster_members", "gauge",
                   "Members of the cluster view not marked left "
                   "(elastic membership).",
                   ela.get("members", 0), rank=rank)
        ec = ela.get("counters", {})
        doc.sample("ocm_member_joins_total", "counter",
                   "REQ_JOIN admissions granted (rank 0 only).",
                   ec.get("joins", 0), rank=rank)
        doc.sample("ocm_member_leaves_total", "counter",
                   "Graceful REQ_LEAVE departures (rank 0 only).",
                   ec.get("leaves", 0), rank=rank)
        for outcome in ("completed", "aborted"):
            doc.sample("ocm_migrations_total", "counter",
                       "Live extent migrations by outcome, counted at "
                       "the migration source (aborts are also counted "
                       "at a target dropping a quarantined copy).",
                       ec.get(f"migrations_{outcome}", 0),
                       rank=rank, outcome=outcome)
        doc.sample("ocm_migration_bytes_total", "counter",
                   "Bytes whose ownership flipped through completed "
                   "live migrations.",
                   ec.get("migration_bytes", 0), rank=rank)
        doc.sample("ocm_migration_tombstones", "gauge",
                   "Forwarding tombstones held for live-migrated "
                   "allocations (pruned once the owning app goes "
                   "stale).",
                   ela.get("tombstones", 0), rank=rank)

    tb = meta.get("timebudget", {})
    if tb:
        doc.sample("ocm_deadline_exceeded_total", "counter",
                   "Requests refused (or abandoned mid-dispatch) typed "
                   "DEADLINE_EXCEEDED because their propagated time "
                   "budget ran out.",
                   tb.get("deadline_exceeded", 0), rank=rank)
        doc.sample("ocm_cancels_total", "counter",
                   "CANCEL requests served, by whether a queued/"
                   "completed op was actually revoked.",
                   tb.get("cancels_revoked", 0),
                   rank=rank, outcome="revoked")
        doc.sample("ocm_cancels_total", "counter",
                   "CANCEL requests served, by whether a queued/"
                   "completed op was actually revoked.",
                   max(tb.get("cancels", 0)
                       - tb.get("cancels_revoked", 0), 0),
                   rank=rank, outcome="noop")
        doc.sample("ocm_cancel_drops_total", "counter",
                   "Replies suppressed after a binding cancel (queued "
                   "ops skipped + completed ops dropped; completed "
                   "REQ_ALLOCs additionally unwound via the free "
                   "path).",
                   tb.get("cancel_drops", 0), rank=rank)

    frz = meta.get("frozen")
    if frz:
        doc.sample("ocm_frozen_demotes_total", "counter",
                   "Arena extents demoted (spilled) to the disk-backed "
                   "frozen tier under pressure.",
                   frz.get("demotes", 0), rank=rank)
        doc.sample("ocm_frozen_promotes_total", "counter",
                   "Frozen extents thawed back into the host arena on "
                   "client access.",
                   frz.get("promotes", 0), rank=rank)
        doc.sample("ocm_frozen_lost_total", "counter",
                   "Frozen entries refused at open or read (CRC/format "
                   "failure) and quarantined — reported lost, never "
                   "served as garbage.",
                   frz.get("lost", 0), rank=rank)
        doc.sample("ocm_warm_boot_extents_total", "counter",
                   "Frozen extents re-adopted by a restarted daemon "
                   "incarnation at start.",
                   frz.get("warm_boot_extents", 0), rank=rank)
        doc.sample("ocm_frozen_bytes", "gauge",
                   "Payload bytes currently stored in this daemon's "
                   "frozen tier.",
                   frz.get("bytes", 0), rank=rank)
        doc.sample("ocm_frozen_extents", "gauge",
                   "Entries currently stored in this daemon's frozen "
                   "tier.",
                   frz.get("extents", 0), rank=rank)

    srv = meta.get("serving")
    if srv:
        _serving_samples(doc, srv, rank)

    # The transfer ring is bounded, so ring-derived figures are gauges
    # over the recent window, never counters.
    transfers = meta.get("transfers", [])
    by_op: dict[str, list[dict]] = {}
    for t in transfers:
        by_op.setdefault(str(t.get("op", "?")), []).append(t)
    for op, recs in sorted(by_op.items()):
        doc.sample("ocm_transfer_recent_gigabits_per_second", "gauge",
                   "Throughput of the most recent transfer (gigabits/s).",
                   recs[-1].get("gbps", 0.0), rank=rank, op=op)
        doc.sample("ocm_transfer_recent_retries", "gauge",
                   "Stripe retries across the recent-transfer ring.",
                   sum(r.get("retries", 0) for r in recs), rank=rank, op=op)
        doc.sample("ocm_transfer_recent_bytes", "gauge",
                   "Bytes moved across the recent-transfer ring.",
                   sum(r.get("bytes", 0) for r in recs), rank=rank, op=op)
    return doc.text()
