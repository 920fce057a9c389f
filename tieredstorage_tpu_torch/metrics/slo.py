"""Declarative SLOs with multi-window burn-rate alerting over live metrics.

Counterpart of tieredstorage_tpu/metrics/slo.py. The SRE-workbook model
(Beyer et al., "The Site Reliability Workbook", ch. 5): an SLO is an
OBJECTIVE fraction of good events (p99 fetch latency within the deadline
budget, error rate, shed rate, cache-tier hit floor); the error BUDGET is
the tolerated bad fraction ``1 - objective``; the BURN RATE over a window is
the observed bad fraction divided by the budget (burn 1.0 = spending the
budget exactly as fast as it accrues; burn 14.4 over an hour = a 30-day
budget gone in two days). Alerting on TWO windows — a long one for
significance, a short one so a recovered incident stops paging — is the
workbook's multiwindow multi-burn-rate recipe.

All of it is computed from the metrics that already exist:

- ``HistogramLatencySource`` counts good events straight off a ``<base>-ms``
  ``Histogram``'s cumulative buckets (metrics/core.py) — good = observations
  at or below the threshold, bucket-interpolated exactly like
  ``latency_quantile``; the same histogram's bucket EXEMPLARS (trace ids
  captured by the flight recorder) become the breach evidence;
- ``RatioSource`` wraps any pair of cumulative counters (admission
  admitted/shed, cache hits/gets, corruption + deadline tallies);
- ``SloEngine`` snapshots each source's cumulative (good, total) on every
  ``tick``/``evaluate`` (scrape-driven, like Prometheus — no daemon
  thread), keeps a bounded history, and differences it over the short and
  long windows for the burn rates.

Degenerate-case contract (shared with ``Histogram.quantile`` /
``latency_quantile`` / ``Tracer.summary``): zero events means compliance,
burn rates, and budget are ``None`` — never a fabricated 0.0 or 1.0 — and
a spec with no data is reported ``ok`` with ``samples: 0`` so consumers can
gate on "real data AND healthy" explicitly.

``RemoteStorageManager.slo_status`` serves ``SloEngine.evaluate`` and the
``slo-metrics`` gauge group exports the same numbers per spec (tagged
``slo=<name>``) for scrapes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional, Sequence

from tieredstorage_tpu_torch.metrics.core import MetricName, MetricsRegistry
from tieredstorage_tpu_torch.metrics.rsm_metrics import Metrics
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation

SLO_METRIC_GROUP = "slo-metrics"

#: Snapshots retained per spec; at one scrape/second this covers well past
#: any sane long window, and the window lookup degrades gracefully (the
#: oldest retained snapshot bounds the delta) when scrapes are sparser.
_MAX_SNAPSHOTS = 512


class SloSource:
    """Cumulative (good_count, total_count) supplier for one SLO."""

    def counts(self) -> tuple[float, float]:
        raise NotImplementedError

    def evidence(self) -> dict:
        """Optional breach evidence (exemplar trace ids etc.); empty by
        default."""
        return {}


class RatioSource(SloSource):
    """Good/total from two cumulative counter suppliers.

    ``total`` must be monotone and ``good(t) <= total(t)``; the engine
    differences snapshots, so windowed deltas stay exact for any pair of
    process-lifetime counters."""

    def __init__(
        self, good: Callable[[], float], total: Callable[[], float]
    ) -> None:
        self._good = good
        self._total = total

    def counts(self) -> tuple[float, float]:
        return float(self._good()), float(self._total())


class HistogramLatencySource(SloSource):
    """Good = observations at or below ``threshold_ms`` of a ``<base>-ms``
    latency histogram (fetch p99 vs the deadline budget, rendered as "at
    least `objective` of observations within threshold").

    Counting is bucket-exact when the threshold lands on a bucket bound and
    linearly interpolated inside a bucket otherwise — the same resolution
    contract as ``Histogram.quantile``, so a threshold chosen off the
    ladder cannot over-claim precision. Bucket exemplars ABOVE the
    threshold (trace ids the flight recorder attached) are the breach
    evidence."""

    def __init__(self, metrics: Metrics, base: str, threshold_ms: float) -> None:
        if threshold_ms <= 0:
            raise ValueError(f"threshold_ms must be > 0, got {threshold_ms}")
        self._metrics = metrics
        self.base = base
        self.threshold_ms = float(threshold_ms)

    def counts(self) -> tuple[float, float]:
        stat = self._metrics.histogram(self.base)
        if stat is None:
            return 0.0, 0.0
        cumulative = stat.buckets()
        total = float(cumulative[-1][1])
        return self._count_at_or_below(cumulative), total

    def _count_at_or_below(self, cumulative) -> float:
        prev_bound, prev_count = 0.0, 0
        for bound, count in cumulative:
            if self.threshold_ms >= bound:
                prev_bound, prev_count = bound, count
                continue
            if bound == float("inf"):
                # Threshold beyond the last finite bound: everything below
                # +Inf except the overflow bucket counts as good only up to
                # the last finite bound (conservative: overflow observations
                # are NOT assumed good).
                return float(prev_count)
            span = bound - prev_bound
            frac = (self.threshold_ms - prev_bound) / span if span > 0 else 1.0
            return float(prev_count) + (count - prev_count) * frac
        return float(prev_count)

    def evidence(self) -> dict:
        stat = self._metrics.histogram(self.base)
        if stat is None:
            return {}
        over = [
            {"le": "+Inf" if bound == float("inf") else bound,
             "trace_id": trace_id, "value_ms": value}
            for bound, trace_id, value in stat.exemplars()
            if value > self.threshold_ms
        ]
        return {"exemplars_over_threshold": over} if over else {}


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative objective: at least ``objective`` of events good."""

    name: str
    description: str
    objective: float
    source: SloSource

    def __post_init__(self) -> None:
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective} "
                f"for {self.name!r} (1.0 leaves a zero error budget: no "
                "burn rate is finite against it)"
            )

    @property
    def budget_fraction(self) -> float:
        return 1.0 - self.objective


@dataclasses.dataclass(frozen=True)
class _Snapshot:
    at: float
    good: float
    total: float


class SloEngine:
    """Evaluates SloSpecs: cumulative compliance + error budget + two-window
    burn rates, scrape-driven (every ``evaluate``/gauge read ticks a
    snapshot; no background thread)."""

    def __init__(
        self,
        specs: Sequence[SloSpec],
        *,
        short_window_s: float = 60.0,
        long_window_s: float = 600.0,
        time_source: Callable[[], float] = time.monotonic,
    ) -> None:
        if not specs:
            raise ValueError("SloEngine needs at least one SloSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO spec names: {sorted(names)}")
        if not 0 < short_window_s < long_window_s:
            raise ValueError(
                f"windows must satisfy 0 < short ({short_window_s}) < "
                f"long ({long_window_s})"
            )
        self.specs = tuple(specs)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self._now = time_source
        self._lock = new_lock("slo.SloEngine._lock")
        self._history: dict[str, deque[_Snapshot]] = {
            s.name: deque(maxlen=_MAX_SNAPSHOTS) for s in specs
        }
        self.evaluations = 0
        self._last: dict = {}
        self._last_at: Optional[float] = None

    # ------------------------------------------------------------- sampling
    def tick(self, now: Optional[float] = None) -> None:
        """Record one cumulative snapshot per spec. Sources are read
        OUTSIDE the lock (they may take other subsystems' locks)."""
        at = self._now() if now is None else now
        sampled = [(s.name, s.source.counts()) for s in self.specs]
        with self._lock:
            for name, (good, total) in sampled:
                self._history[name].append(_Snapshot(at, good, total))

    @staticmethod
    def _window_base(
        history: Sequence[_Snapshot], at: float, window_s: float
    ) -> Optional[_Snapshot]:
        """The newest snapshot at or before ``at - window_s`` (so the delta
        spans AT LEAST the window), else the oldest retained one when the
        history is younger than the window but spans more than half of it
        (a shorter base would overstate the rate); None otherwise."""
        cutoff = at - window_s
        base: Optional[_Snapshot] = None
        for snap in history:
            if snap.at <= cutoff:
                base = snap
            else:
                break
        if base is not None:
            return base
        if history and at - history[0].at >= window_s / 2.0:
            return history[0]
        return None

    # ------------------------------------------------------------ verdicts
    def _burn_rate(
        self,
        spec: SloSpec,
        history: Sequence[_Snapshot],
        current: _Snapshot,
        window_s: float,
    ) -> Optional[float]:
        base = self._window_base(history, current.at, window_s)
        if base is None:
            return None
        total_delta = current.total - base.total
        if total_delta <= 0:
            return None  # no events in the window: no burn, not burn 0.0
        bad_delta = total_delta - (current.good - base.good)
        return (bad_delta / total_delta) / spec.budget_fraction

    def evaluate(self, now: Optional[float] = None) -> dict:
        """Tick, then verdict every spec. ``ok`` per spec means the
        CUMULATIVE error budget is not exhausted (bad fraction within
        ``1 - objective``); ``burning`` flags the multiwindow alert (both
        burn rates computable and above 1.0). Specs with zero events are
        ``ok`` with ``samples: 0`` — the caller decides whether "no data"
        passes its gate."""
        self.tick(now)
        with self._lock:
            self.evaluations += 1
            note_mutation("slo.SloEngine.evaluations")
            histories = {
                name: list(snaps) for name, snaps in self._history.items()
            }
        verdicts: dict[str, dict] = {}
        for spec in self.specs:
            history = histories[spec.name]
            current = history[-1]
            total, good = current.total, current.good
            bad = total - good
            if total > 0:
                compliance = good / total
                budget_remaining = 1.0 - (bad / total) / spec.budget_fraction
            else:
                compliance = None
                budget_remaining = None
            burn_short = self._burn_rate(
                spec, history, current, self.short_window_s
            )
            burn_long = self._burn_rate(
                spec, history, current, self.long_window_s
            )
            burning = (
                burn_short is not None and burn_long is not None
                and burn_short > 1.0 and burn_long > 1.0
            )
            ok = budget_remaining is None or budget_remaining > 0.0
            verdict = {
                "description": spec.description,
                "objective": spec.objective,
                "samples": total,
                "good": good,
                "compliance": compliance,
                "error_budget_remaining": budget_remaining,
                "burn_rate_short": burn_short,
                "burn_rate_long": burn_long,
                "burning": burning,
                "ok": ok,
            }
            if not ok or burning:
                evidence = spec.source.evidence()
                if evidence:
                    verdict["evidence"] = evidence
            verdicts[spec.name] = verdict
        result = {
            "ok": all(v["ok"] for v in verdicts.values()),
            "burning": any(v["burning"] for v in verdicts.values()),
            "windows": {
                "short_s": self.short_window_s,
                "long_s": self.long_window_s,
            },
            "specs": verdicts,
        }
        with self._lock:
            self._last = result
            self._last_at = self._now() if now is None else now
        return result

    def last_evaluation(self) -> dict:
        with self._lock:
            return self._last

    def evaluate_cached(self, max_age_s: float = 1.0) -> dict:
        """The last evaluation if it is at most ``max_age_s`` old, else a
        fresh one — one Prometheus scrape reads five gauges per spec, and
        each must not re-tick the whole engine."""
        now = self._now()
        with self._lock:
            if self._last and self._last_at is not None \
                    and now - self._last_at <= max_age_s:
                return self._last
        return self.evaluate()

    # -------------------------------------------------------------- gauges
    def register_gauges(self, registry: MetricsRegistry) -> None:
        """Per-spec gauges (group ``slo-metrics``, tagged ``slo=<name>``).

        Each read evaluates (scrape-driven ticking); None verdict values
        export as the conventional impossible sentinels so dashboards can
        tell "no data" apart: budget/compliance/burn -1.0."""

        def gauge(name: str, spec_name: str, key: str, description: str = "") -> None:
            def supplier(spec_name=spec_name, key=key) -> float:
                verdict = self.evaluate_cached()["specs"][spec_name]
                value = verdict[key]
                if isinstance(value, bool):
                    return 1.0 if value else 0.0
                return -1.0 if value is None else float(value)

            registry.add_gauge(
                MetricName.of(
                    name, SLO_METRIC_GROUP, description,
                    tags={"slo": spec_name},
                ),
                supplier,
            )

        for spec in self.specs:
            gauge(
                "slo-error-budget-remaining", spec.name, "error_budget_remaining",
                "Fraction of the SLO error budget left (1 = untouched, "
                "<= 0 = exhausted, -1 = no events yet)",
            )
            gauge(
                "slo-burn-rate-short", spec.name, "burn_rate_short",
                "Error-budget burn rate over the short window "
                "(1.0 = burning exactly at budget; -1 = no data)",
            )
            gauge(
                "slo-burn-rate-long", spec.name, "burn_rate_long",
                "Error-budget burn rate over the long window "
                "(1.0 = burning exactly at budget; -1 = no data)",
            )
            gauge(
                "slo-compliance", spec.name, "compliance",
                "Cumulative good-event fraction vs the objective "
                "(-1 = no events yet)",
            )
            gauge(
                "slo-ok", spec.name, "ok",
                "1 while the cumulative error budget is not exhausted",
            )
