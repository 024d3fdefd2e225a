"""The port's copy of ``oncilla_tpu/obs/scrape.py``, line for line, with the
imports renamed to the port's modules.

Cluster metrics history: in-process STATUS_PROM time series.

The prom families (:mod:`~oncilla_tpu_torch.obs.prom`) are cumulative-only —
fine for an external Prometheus, useless on their own for "is the
cluster healthy RIGHT NOW". This module closes that gap without any
external scraper: a :class:`Scraper` polls every rank's STATUS_PROM
exposition (through whatever fetch callable the caller supplies —
``Ocm.fetch_prom`` in practice, so the poll rides the existing in-band
protocol and no new listener appears) and parses each sample into
fixed-size per-series rings held by a :class:`MetricsHistory`.

Over those rings the history can answer windowed questions locally:
counter deltas and rates (reset-aware, the ``increase()``/``rate()``
semantics), latest gauge values, and quantiles of the cumulative
histogram families via bucket-delta interpolation — everything the SLO
engine (:mod:`~oncilla_tpu_torch.obs.slo`) needs to evaluate burn rates
in-process.

Stdlib-only by the obs-package contract.
"""

from __future__ import annotations

import os
import re
import threading
import time

from oncilla_tpu_torch.obs import prom

# One scrape knob for the whole SLO stack: how often the background
# scraper polls each rank. Tolerant parse (watchdog.reload_threshold
# stance): a typo'd value degrades to the default, never crashes.
ENV_SCRAPE_S = "OCM_SLO_SCRAPE_S"
DEFAULT_SCRAPE_S = 2.0


def scrape_interval_s() -> float:
    try:
        return float(os.environ.get(ENV_SCRAPE_S, "") or DEFAULT_SCRAPE_S)
    except ValueError:
        return DEFAULT_SCRAPE_S


_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESC = {r"\\": "\\", r"\"": '"', r"\n": "\n"}


def _unescape(v: str) -> str:
    out = v
    for esc, raw in _UNESC.items():
        out = out.replace(esc, raw)
    return out


def parse_samples(text: str) -> list[tuple[str, str, dict[str, str], float]]:
    """Parse one exposition into ``(family, sample_name, labels, value)``
    tuples. Runs :func:`prom.validate` first, so a malformed exposition
    raises instead of silently feeding garbage into the history — the
    same bar CI holds renderers to."""
    out: list[tuple[str, str, dict[str, str], float]] = []
    for family, lines in prom.validate(text).items():
        for line in lines:
            ex = prom._EXEMPLAR_RE.search(line)
            if ex is not None:
                line = line[: ex.start()]
            series, value = line.rsplit(" ", 1)
            name, _, rest = series.partition("{")
            labels = {
                k: _unescape(v)
                for k, v in _LABEL_RE.findall(rest.rstrip("}"))
            }
            out.append((family, name, labels, float(value)))
    return out


def _matches(labels: dict[str, str], want: dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in want.items())


class MetricsHistory:
    """Fixed-size time-series rings keyed by (sample name, label set).

    ``observe(rank, text)`` appends one scrape; the query side offers
    ``latest`` / ``delta`` / ``rate`` over matching series and
    ``hist_quantile`` over cumulative-histogram bucket deltas. All label
    matching is subset matching (match on the labels you name, ignore
    the rest), so one query naturally aggregates across ranks, ops, or
    engines unless the caller pins those labels."""

    def __init__(self, cap: int = 512) -> None:
        self.cap = int(cap)
        self._mu = threading.Lock()
        # (name, ((k,v)...)) -> list[(ts, value)] ring (newest last)
        self._series: dict[tuple, list[tuple[float, float]]] = {}
        self._family_of: dict[str, str] = {}  # sample name -> family
        self.scrapes = 0
        self.errors = 0

    # -- ingest ---------------------------------------------------------

    def observe_samples(
        self,
        samples: list[tuple[str, str, dict[str, str], float]],
        ts: float | None = None,
    ) -> None:
        ts = time.time() if ts is None else ts
        with self._mu:
            self.scrapes += 1
            for family, name, labels, value in samples:
                self._family_of[name] = family
                key = (name, tuple(sorted(labels.items())))
                ring = self._series.setdefault(key, [])
                ring.append((ts, value))
                if len(ring) > self.cap:
                    del ring[: len(ring) - self.cap]

    def observe(self, rank: int, text: str, ts: float | None = None) -> None:
        """Parse one rank's exposition into the rings. The ``rank``
        argument is advisory (every series already carries a ``rank``
        label); it exists so a fetch-failure path can still be counted
        against the right rank by the caller."""
        del rank
        self.observe_samples(parse_samples(text), ts=ts)

    def note_error(self) -> None:
        with self._mu:
            self.errors += 1

    # -- queries --------------------------------------------------------

    def series(
        self, name: str, **match: str
    ) -> dict[tuple, list[tuple[float, float]]]:
        """Matching rings, keyed by their full label tuple (a copy)."""
        want = {k: str(v) for k, v in match.items()}
        with self._mu:
            return {
                key: list(ring)
                for key, ring in self._series.items()
                if key[0] == name and _matches(dict(key[1]), want)
            }

    def latest(self, name: str, **match: str) -> float | None:
        """Sum of the newest value of every matching series (``None``
        when nothing matches — distinct from a genuine 0)."""
        rings = self.series(name, **match)
        if not rings:
            return None
        return sum(ring[-1][1] for ring in rings.values() if ring)

    @staticmethod
    def _ring_delta(ring: list[tuple[float, float]], since: float) -> float:
        """Counter increase across one ring's window, reset-aware: a
        sample below its predecessor restarts accumulation from zero
        (the restarted process's counter began at 0)."""
        win = [(t, v) for t, v in ring if t >= since]
        if len(win) < 2:
            return 0.0
        total = 0.0
        prev = win[0][1]
        for _, v in win[1:]:
            total += v - prev if v >= prev else v
            prev = v
        return total

    def delta(self, name: str, window_s: float,
              now: float | None = None, **match: str) -> float:
        """Summed counter increase over the trailing window across all
        matching series."""
        now = time.time() if now is None else now
        since = now - float(window_s)
        return sum(
            self._ring_delta(ring, since)
            for ring in self.series(name, **match).values()
        )

    def rate(self, name: str, window_s: float,
             now: float | None = None, **match: str) -> float:
        return self.delta(name, window_s, now=now, **match) / max(
            float(window_s), 1e-9
        )

    def hist_deltas(
        self,
        family: str,
        window_s: float,
        now: float | None = None,
        **match: str,
    ) -> dict[float, float]:
        """Per-``le`` cumulative bucket increases of a histogram family
        over the trailing window, aggregated across matching series.
        Keys are bucket bounds (``+Inf`` as ``float('inf')``); values
        stay cumulative, so ``by_le[inf]`` is the window's observation
        count."""
        now = time.time() if now is None else now
        since = now - float(window_s)
        by_le: dict[float, float] = {}
        for key, ring in self.series(family + "_bucket", **match).items():
            labels = dict(key[1])
            le_raw = labels.get("le")
            if le_raw is None:
                continue
            le = float("inf") if le_raw == "+Inf" else float(le_raw)
            by_le[le] = by_le.get(le, 0.0) + self._ring_delta(ring, since)
        return by_le

    def hist_quantile(
        self,
        family: str,
        q: float,
        window_s: float,
        now: float | None = None,
        **match: str,
    ) -> float | None:
        """Windowed quantile of a cumulative-histogram family: per-``le``
        bucket increases over the trailing window, aggregated across all
        matching series, then the classic linear interpolation inside
        the bucket holding the ``q``-th observation. ``None`` when no
        observations landed in the window."""
        by_le = self.hist_deltas(family, window_s, now=now, **match)
        if not by_le:
            return None
        les = sorted(by_le)
        total = by_le.get(float("inf"), max(by_le.values()))
        if total <= 0:
            return None
        target = max(0.0, min(1.0, q)) * total
        prev_le, prev_cum = 0.0, 0.0
        for le in les:
            cum = by_le[le]
            if cum >= target:
                if le == float("inf"):
                    return prev_le  # open-ended tail: best lower bound
                frac = (
                    (target - prev_cum) / (cum - prev_cum)
                    if cum > prev_cum else 1.0
                )
                return prev_le + frac * (le - prev_le)
            prev_le, prev_cum = le, cum
        return les[-2] if len(les) > 1 else None

    def families(self) -> dict[str, list[str]]:
        """Family -> sorted sample names seen (the live view's index)."""
        with self._mu:
            out: dict[str, list[str]] = {}
            for name, family in self._family_of.items():
                out.setdefault(family, []).append(name)
        return {fam: sorted(names) for fam, names in sorted(out.items())}

    def meta(self) -> dict:
        with self._mu:
            return {
                "series": len(self._series),
                "scrapes": self.scrapes,
                "errors": self.errors,
                "cap": self.cap,
            }


class Scraper:
    """Background poller: every ``interval_s`` it fetches each rank's
    STATUS_PROM text through ``fetch(rank)`` and feeds the history. A
    rank whose fetch raises is counted (``history.errors``) and skipped
    — a dead daemon must degrade the history, never kill the scraper
    (the SLO engine is often exactly what is watching for that death).
    """

    def __init__(
        self,
        fetch,
        ranks: list[int] | range,
        history: MetricsHistory | None = None,
        interval_s: float | None = None,
    ) -> None:
        self.fetch = fetch
        self.ranks = list(ranks)
        self.history = history if history is not None else MetricsHistory()
        self.interval_s = (
            scrape_interval_s() if interval_s is None else float(interval_s)
        )
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def poll_once(self, ts: float | None = None) -> int:
        """One synchronous sweep across all ranks; returns how many
        ranks scraped cleanly. The deterministic entry the SLO tests
        and one-shot CLI paths use instead of the thread."""
        ok = 0
        for rank in self.ranks:
            try:
                text = self.fetch(rank)
            except Exception:
                self.history.note_error()
                continue
            try:
                self.history.observe(rank, text, ts=ts)
                ok += 1
            except ValueError:
                self.history.note_error()
        return ok

    def start(self) -> "Scraper":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.poll_once()

        self._thread = threading.Thread(
            target=_loop, name="ocm-slo-scraper", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
