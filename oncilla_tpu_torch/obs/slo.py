"""The port's copy of ``oncilla_tpu/obs/slo.py``, line for line, with the
imports renamed to the port's modules.

SLO engine: declarative objectives + multi-window burn-rate alerts.

The prom families say what happened; this module says whether that was
GOOD ENOUGH. Objectives are declarative records (:class:`Objective`)
evaluated over the in-process metrics history
(:mod:`~oncilla_tpu_torch.obs.scrape`), in three shapes:

* ``latency`` — the fraction of windowed histogram observations under a
  threshold must meet a target. The default ladder expresses each QoS
  priority class's bound as a *fraction of the deadline budget*
  (``OCM_DEADLINE_MS``): high priority gets half the budget, normal the
  budget, low twice it — so tightening the budget tightens every
  objective with no spec edit. Serving TTFT rides the same shape over
  ``ocm_serving_ttft_seconds``.
* ``availability`` — typed error counters (``BUSY`` backpressure,
  ``DEADLINE_EXCEEDED``, client breaker opens) as a fraction of
  ``ocm_op_total`` must stay under ``1 - target``.
* ``throughput`` — a counter's windowed rate (serving decode
  tokens/sec) must clear a floor while the stream is active.

Alerting is the SRE-workbook multi-window burn rate: per objective the
error ratio is turned into ``burn = error_ratio / (1 - target)`` over a
fast and a slow window, and the objective only trips when BOTH exceed
the threshold — the fast window for reaction time, the slow one so a
single bad scrape can't page. Verdicts publish three ways: ``ocm_slo_*``
prom families (:func:`SloEngine.render_prom`), ``slo_burn``/``slo_ok``
journal events, and the ``obs slo`` CLI table.

``OCM_SLO`` selects the spec: unset/empty = defaults, ``0``/``off`` =
disabled, inline JSON or a path to a JSON file = custom objectives.
Parsing is tolerant — a malformed spec degrades to the defaults rather
than crashing the host process.

Stdlib-only by the obs-package contract.
"""

from __future__ import annotations

import json
import os
import threading
import time

from oncilla_tpu_torch.obs import journal, prom, scrape

ENV_SLO = "OCM_SLO"

# Default windows/threshold are sized for an in-process watcher, not a
# paging pipeline: minutes, not hours. Spec files can override all three.
DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 300.0
DEFAULT_BURN_THRESHOLD = 2.0
# When OCM_DEADLINE_MS is unset (0 = no deadline discipline) the latency
# ladder still needs an anchor; one second is the repo's chaos-smoke
# scale.
DEFAULT_BUDGET_S = 1.0


class Objective:
    """One declarative objective. ``match`` pins exposition labels
    (subset match); ``kind`` picks the evaluation shape."""

    def __init__(
        self,
        name: str,
        kind: str,
        *,
        family: str = "",
        target: float = 0.99,
        threshold_s: float = 0.0,
        min_rate: float = 0.0,
        errors: list[tuple[str, dict]] | None = None,
        total_family: str = "",
        match: dict | None = None,
        priority: str = "",
    ) -> None:
        if kind not in ("latency", "availability", "throughput"):
            raise ValueError(f"unknown objective kind {kind!r}")
        self.name = name
        self.kind = kind
        self.family = family
        self.target = float(target)
        self.threshold_s = float(threshold_s)
        self.min_rate = float(min_rate)
        self.errors = errors or []
        self.total_family = total_family
        self.match = dict(match or {})
        self.priority = priority

    @classmethod
    def from_dict(cls, d: dict) -> "Objective":
        errs = [
            (e["family"], dict(e.get("match", {})))
            for e in d.get("errors", [])
        ]
        return cls(
            d["name"],
            d["kind"],
            family=d.get("family", ""),
            target=d.get("target", 0.99),
            threshold_s=d.get("threshold_s", 0.0),
            min_rate=d.get("min_rate", 0.0),
            errors=errs,
            total_family=d.get("total_family", ""),
            match=d.get("match"),
            priority=str(d.get("priority", "")),
        )


def default_objectives(budget_s: float | None = None) -> list[Objective]:
    """The built-in objective set. The latency ladder is the QoS
    priority classes (utils/config.py: 0 low, 1 normal, 2 high), each
    bounded by a fraction of the deadline budget."""
    if budget_s is None:
        try:
            ms = int(os.environ.get("OCM_DEADLINE_MS", "") or 0)
        except ValueError:
            ms = 0
        budget_s = (ms / 1000.0) if ms > 0 else DEFAULT_BUDGET_S
    out = [
        Objective(
            f"latency_{cls}", "latency",
            family="ocm_op_latency_seconds",
            threshold_s=frac * budget_s, target=target, priority=cls,
        )
        for cls, frac, target in (
            ("high", 0.5, 0.99),
            ("normal", 1.0, 0.99),
            ("low", 2.0, 0.95),
        )
    ]
    out.append(Objective(
        "availability", "availability",
        errors=[
            ("ocm_backpressure_busy_total", {}),
            ("ocm_deadline_exceeded_total", {}),
            ("ocm_client_breaker_opens_total", {}),
        ],
        total_family="ocm_op_total",
        target=0.999,
    ))
    out.append(Objective(
        "serving_ttft", "latency",
        family="ocm_serving_ttft_seconds",
        threshold_s=budget_s, target=0.95, priority="serving",
    ))
    out.append(Objective(
        "serving_tokens", "throughput",
        family="ocm_serving_tokens_total",
        match={"phase": "decode"},
        min_rate=1.0, target=0.99,
    ))
    return out


def load_spec(
    budget_s: float | None = None,
) -> tuple[list[Objective], float, float, float] | None:
    """Resolve ``OCM_SLO`` into ``(objectives, fast_s, slow_s,
    burn_threshold)``; ``None`` means the engine is disabled."""
    raw = (os.environ.get(ENV_SLO, "") or "").strip()
    if raw.lower() in ("0", "off", "false"):
        return None
    fast, slow, thr = DEFAULT_FAST_S, DEFAULT_SLOW_S, DEFAULT_BURN_THRESHOLD
    if raw in ("", "1", "on", "true"):
        return default_objectives(budget_s), fast, slow, thr
    text = raw
    if raw.startswith("@") or os.path.exists(raw):
        try:
            with open(raw.lstrip("@"), encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            return default_objectives(budget_s), fast, slow, thr
    try:
        spec = json.loads(text)
        objectives = [
            Objective.from_dict(d) for d in spec.get("objectives", [])
        ] or default_objectives(budget_s)
        fast = float(spec.get("fast_s", fast))
        slow = float(spec.get("slow_s", slow))
        thr = float(spec.get("burn_threshold", thr))
    except (ValueError, KeyError, TypeError, AttributeError):
        # Malformed spec: degrade to the defaults (the same stance as
        # the env-knob parsers) — a typo'd SLO file must not take down
        # the process it was meant to watch.
        return default_objectives(budget_s), fast, slow, thr
    return objectives, fast, slow, thr


def _latency_error_ratio(
    hist: scrape.MetricsHistory,
    obj: Objective,
    window_s: float,
    now: float,
) -> tuple[float, float]:
    """(fraction of windowed observations OVER the threshold, count)."""
    by_le = hist.hist_deltas(obj.family, window_s, now=now, **obj.match)
    if not by_le:
        return 0.0, 0.0
    total = by_le.get(float("inf"), max(by_le.values()))
    if total <= 0:
        return 0.0, 0.0
    # Cumulative count at the threshold, linearly interpolated inside
    # the straddling bucket (same estimator as hist_quantile, inverted).
    prev_le, prev_cum = 0.0, 0.0
    good = total
    for le in sorted(by_le):
        cum = by_le[le]
        if le >= obj.threshold_s:
            if le == float("inf") or le == prev_le:
                good = prev_cum if obj.threshold_s > prev_le else cum
            else:
                frac = (obj.threshold_s - prev_le) / (le - prev_le)
                good = prev_cum + frac * (cum - prev_cum)
            break
        prev_le, prev_cum = le, cum
    return max(0.0, min(1.0, 1.0 - good / total)), total


class SloEngine:
    """Evaluates objectives over a :class:`MetricsHistory` and carries
    the verdict state (for burn/ok transition events and the prom
    rendering)."""

    def __init__(
        self,
        history: scrape.MetricsHistory,
        objectives: list[Objective] | None = None,
        *,
        fast_s: float = DEFAULT_FAST_S,
        slow_s: float = DEFAULT_SLOW_S,
        burn_threshold: float = DEFAULT_BURN_THRESHOLD,
    ) -> None:
        self.history = history
        self.objectives = (
            objectives if objectives is not None else default_objectives()
        )
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.burn_threshold = float(burn_threshold)
        self._mu = threading.Lock()
        self._burning: set[str] = set()
        self._last: dict | None = None
        self.evaluations = 0

    # -- evaluation -----------------------------------------------------

    def _error_ratio(
        self, obj: Objective, window_s: float, now: float
    ) -> tuple[float, float]:
        """(error ratio in [0,1], activity count) for one window."""
        if obj.kind == "latency":
            return _latency_error_ratio(self.history, obj, window_s, now)
        if obj.kind == "availability":
            total = self.history.delta(
                obj.total_family, window_s, now=now, **obj.match
            )
            if total <= 0:
                return 0.0, 0.0
            errs = sum(
                self.history.delta(fam, window_s, now=now, **m)
                for fam, m in obj.errors
            )
            return max(0.0, min(1.0, errs / total)), total
        # throughput: binary violation while the stream is active. An
        # idle stream is "no activity", not a breach — a serving engine
        # that was never started must not page.
        rate = self.history.rate(obj.family, window_s, now=now, **obj.match)
        delta = self.history.delta(obj.family, window_s, now=now, **obj.match)
        if delta <= 0 and rate <= 0:
            return 0.0, 0.0
        return (1.0 if rate < obj.min_rate else 0.0), max(delta, 1.0)

    def evaluate(self, now: float | None = None) -> dict:
        """One evaluation sweep. Returns (and retains, for
        :meth:`meta`/:meth:`render_prom`) the verdict dict; records
        ``slo_burn`` events while an objective burns and one ``slo_ok``
        on each recovery transition."""
        now = time.time() if now is None else now
        verdicts = []
        for obj in self.objectives:
            fast_err, fast_n = self._error_ratio(obj, self.fast_s, now)
            slow_err, slow_n = self._error_ratio(obj, self.slow_s, now)
            denom = max(1.0 - obj.target, 1e-9)
            burn_fast = fast_err / denom
            burn_slow = slow_err / denom
            active = fast_n > 0 or slow_n > 0
            burning = (
                active
                and burn_fast > self.burn_threshold
                and burn_slow > self.burn_threshold
            )
            verdicts.append({
                "objective": obj.name,
                "kind": obj.kind,
                "priority": obj.priority,
                "target": obj.target,
                "threshold_s": obj.threshold_s,
                "min_rate": obj.min_rate,
                "ok": not burning,
                "active": active,
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "error_fast": round(fast_err, 6),
                "error_slow": round(slow_err, 6),
                "n_fast": fast_n,
            })
        result = {
            "ok": all(v["ok"] for v in verdicts),
            "ts": now,
            "fast_s": self.fast_s,
            "slow_s": self.slow_s,
            "burn_threshold": self.burn_threshold,
            "objectives": verdicts,
        }
        with self._mu:
            self.evaluations += 1
            was_burning = set(self._burning)
            self._burning = {
                v["objective"] for v in verdicts if not v["ok"]
            }
            self._last = result
        for v in verdicts:
            if not v["ok"]:
                journal.record(
                    "slo_burn", objective=v["objective"],
                    burn_fast=v["burn_fast"], burn_slow=v["burn_slow"],
                    target=v["target"],
                )
            elif v["objective"] in was_burning:
                journal.record(
                    "slo_ok", objective=v["objective"],
                    burn_fast=v["burn_fast"], burn_slow=v["burn_slow"],
                )
        return result

    def meta(self) -> dict:
        """Last verdict + history stats — the ``status()["slo"]`` block."""
        with self._mu:
            last = self._last
        out = {
            "history": self.history.meta(),
            "evaluations": self.evaluations,
        }
        if last is not None:
            out.update(last)
        return out

    # -- exposition -----------------------------------------------------

    def render_prom(self, rank: int = 0) -> str:
        """The ``ocm_slo_*`` families for the last evaluation (runs one
        if none has happened yet); validates against
        :func:`prom.validate` like every other renderer."""
        with self._mu:
            last = self._last
        if last is None:
            last = self.evaluate()
        doc = prom._Doc()
        for v in last["objectives"]:
            doc.sample("ocm_slo_ok", "gauge",
                       "1 while an objective meets its SLO (multi-window "
                       "burn-rate verdict), 0 while it burns.",
                       int(v["ok"]), rank=rank, objective=v["objective"])
            doc.sample("ocm_slo_target", "gauge",
                       "Declared objective target (good fraction).",
                       v["target"], rank=rank, objective=v["objective"])
            for window, burn, err in (
                ("fast", v["burn_fast"], v["error_fast"]),
                ("slow", v["burn_slow"], v["error_slow"]),
            ):
                doc.sample("ocm_slo_burn_rate", "gauge",
                           "Error-budget burn rate per evaluation window "
                           "(error_ratio / (1 - target)); the alert "
                           "requires BOTH windows over the threshold.",
                           burn, rank=rank, objective=v["objective"],
                           window=window)
                doc.sample("ocm_slo_error_ratio", "gauge",
                           "Raw windowed error ratio per objective.",
                           err, rank=rank, objective=v["objective"],
                           window=window)
        doc.sample("ocm_slo_evaluations_total", "counter",
                   "SLO evaluation sweeps run by this engine.",
                   self.evaluations, rank=rank)
        return doc.text()


class SloRunner:
    """The deployable unit: a scraper feeding a history feeding an
    engine, ticked by one background thread. ``extra_samples`` lets the
    host inject client-local counters the daemons cannot see (the
    circuit breaker lives client-side) as synthetic families on every
    tick."""

    def __init__(
        self,
        fetch,
        ranks,
        *,
        objectives: list[Objective] | None = None,
        interval_s: float | None = None,
        fast_s: float = DEFAULT_FAST_S,
        slow_s: float = DEFAULT_SLOW_S,
        burn_threshold: float = DEFAULT_BURN_THRESHOLD,
        extra_samples=None,
        history: scrape.MetricsHistory | None = None,
    ) -> None:
        self.history = history if history is not None else scrape.MetricsHistory()
        self.scraper = scrape.Scraper(
            fetch, ranks, history=self.history, interval_s=interval_s
        )
        self.engine = SloEngine(
            self.history, objectives,
            fast_s=fast_s, slow_s=slow_s, burn_threshold=burn_threshold,
        )
        self.extra_samples = extra_samples
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @classmethod
    def from_env(cls, fetch, ranks, *, interval_s=None,
                 budget_s: float | None = None, extra_samples=None):
        """Build from ``OCM_SLO``; ``None`` when the knob disables it."""
        spec = load_spec(budget_s)
        if spec is None:
            return None
        objectives, fast_s, slow_s, thr = spec
        return cls(
            fetch, ranks, objectives=objectives, interval_s=interval_s,
            fast_s=fast_s, slow_s=slow_s, burn_threshold=thr,
            extra_samples=extra_samples,
        )

    def tick(self, ts: float | None = None) -> dict:
        self.scraper.poll_once(ts=ts)
        if self.extra_samples is not None:
            try:
                extra = self.extra_samples()
            except Exception:
                extra = None
            if extra:
                self.history.observe_samples(extra, ts=ts)
        return self.engine.evaluate(now=ts)

    def start(self) -> "SloRunner":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(self.scraper.interval_s):
                try:
                    self.tick()
                except Exception:
                    self.history.note_error()

        self._thread = threading.Thread(
            target=_loop, name="ocm-slo", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def meta(self) -> dict:
        return self.engine.meta()
