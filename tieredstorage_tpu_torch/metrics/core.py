"""Kafka-Metrics-shaped sensor/stat core.

Counterpart of tieredstorage_tpu/metrics/core.py; the same stats, buckets
and time source (`time.monotonic`).

The reference records every operation through Kafka's metrics library:
sensors hold sampled stats (rate/avg/max over `metrics.num.samples` windows of
`metrics.sample.window.ms`) plus cumulative totals, published to JMX under
hierarchical contexts (core/.../metrics/Metrics.java:79-270,
commons/.../metrics/SensorProvider.java:29-80). This module re-implements
those semantics natively: MetricName (name/group/tags), windowed SampledStat
(Rate/Avg/Max), cumulative (Total/Count), supplier gauges (MeasurableValue ≈
core/.../metrics/MeasurableValue.java), Sensor fan-out, and a registry with a
point-in-time snapshot in place of JMX.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence
from tieredstorage_tpu_torch.utils import flightrecorder
from tieredstorage_tpu_torch.utils.locks import new_lock


@dataclass(frozen=True)
class MetricName:
    name: str
    group: str
    description: str = ""
    tags: tuple[tuple[str, str], ...] = ()

    @classmethod
    def of(cls, name: str, group: str, description: str = "",
           tags: Optional[Mapping[str, str]] = None) -> "MetricName":
        return cls(name, group, description, tuple(sorted((tags or {}).items())))

    def __str__(self) -> str:
        tag_str = ",".join(f"{k}={v}" for k, v in self.tags)
        return f"{self.group}:{self.name}" + (f"{{{tag_str}}}" if tag_str else "")


class MetricConfig:
    def __init__(self, num_samples: int = 2, sample_window_ms: int = 30_000,
                 recording_level: str = "INFO") -> None:
        self.num_samples = num_samples
        self.sample_window_s = sample_window_ms / 1000.0
        self.recording_level = recording_level


# ------------------------------------------------------------------- stats
class Stat:
    def record(self, value: float, now: float) -> None:
        raise NotImplementedError

    def measure(self, config: MetricConfig, now: float) -> float:
        raise NotImplementedError


class Total(Stat):
    """Cumulative sum of recorded values."""

    def __init__(self) -> None:
        self._total = 0.0

    def record(self, value: float, now: float) -> None:
        self._total += value

    def measure(self, config: MetricConfig, now: float) -> float:
        return self._total


class Count(Stat):
    """Cumulative number of recordings (value ignored)."""

    def __init__(self) -> None:
        self._count = 0

    def record(self, value: float, now: float) -> None:
        self._count += 1

    def measure(self, config: MetricConfig, now: float) -> float:
        return float(self._count)


class Histogram(Stat):
    """Fixed-bucket cumulative latency histogram (Prometheus histogram shape).

    Buckets are inclusive upper bounds (`le` semantics); the default ladder is
    log-scale — 0.25·2^i for i in 0..19, i.e. 0.25 ms to ~131 s when recording
    milliseconds — so one fixed layout covers cache hits through cold
    multi-GiB segment copies at ~2x relative error. Unlike the windowed
    SampledStats, a histogram is cumulative for the process lifetime (the
    Prometheus model: the scraper differentiates)."""

    DEFAULT_BUCKETS: tuple[float, ...] = tuple(0.25 * 2**i for i in range(20))

    def __init__(self, buckets: Optional[Sequence[float]] = None) -> None:
        self._bounds: tuple[float, ...] = tuple(
            sorted(self.DEFAULT_BUCKETS if buckets is None else buckets)
        )
        # One overflow slot past the last bound (the +Inf bucket).
        self._counts = [0] * (len(self._bounds) + 1)
        self._sum = 0.0
        self._count = 0
        #: bucket index -> (trace_id, value): the LATEST observation per
        #: bucket that was recorded while a flight-recorder request was
        #: ambient (utils/flightrecorder.py). An exemplar ties a bucket to
        #: one concrete request whose full per-tier evidence the recorder
        #: retained — the bridge from "the p99 bucket is filling" to "THIS
        #: request filled it".
        self._exemplars: dict[int, tuple[str, float]] = {}
        self._lock = new_lock("core.Histogram._lock")

    def record(self, value: float, now: float = 0.0,
               trace_id: Optional[str] = None) -> None:
        """Record one observation. ``trace_id`` overrides the ambient
        flight-recorder trace id as the bucket's exemplar — for recording
        threads that act on ANOTHER request's behalf (the batcher's flusher
        delivering per-window added-wait values captured at enqueue)."""
        idx = bisect.bisect_left(self._bounds, value)
        if trace_id is None:
            trace_id = flightrecorder.current_trace_id()
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if trace_id is not None:
                self._exemplars[idx] = (trace_id, value)

    def measure(self, config: MetricConfig, now: float) -> float:
        """Snapshot value: total observation count (the `_count` series)."""
        return float(self._count)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def buckets(self) -> list[tuple[float, int]]:
        """Cumulative (upper_bound, count) pairs, ending with (+Inf, count)."""
        with self._lock:
            counts = list(self._counts)
        out: list[tuple[float, int]] = []
        running = 0
        for bound, n in zip(self._bounds, counts):
            running += n
            out.append((bound, running))
        out.append((float("inf"), running + counts[-1]))
        return out

    def exemplars(self) -> list[tuple[float, str, float]]:
        """(bucket upper bound, trace_id, observed value) triples for every
        bucket holding an exemplar, ascending by bound. The trace ids key
        into the flight recorder's retained records, so a hot bucket
        resolves to a concrete request's tier breakdown."""
        bounds = (*self._bounds, float("inf"))
        with self._lock:
            items = sorted(self._exemplars.items())
        return [(bounds[idx], tid, value) for idx, (tid, value) in items]

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate, exact only up to bucket
        resolution — the same contract as a `histogram_quantile` over the
        exported series.

        Degenerate-case contract: an EMPTY histogram returns
        ``None``, never 0.0 — "no observations yet" must stay
        distinguishable from "the p99 is genuinely zero milliseconds" so
        no consumer treats a phantom sample count as evidence.
        A single-observation histogram returns that observation's bucket
        position for every q (one sample IS every quantile of itself)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        cumulative = self.buckets()
        total = cumulative[-1][1]
        if total == 0:
            return None
        rank = q * total
        prev_bound, prev_count = 0.0, 0
        for bound, count in cumulative:
            if count >= rank:
                if bound == float("inf"):
                    return prev_bound
                if count == prev_count:
                    return bound
                frac = (rank - prev_count) / (count - prev_count)
                return prev_bound + (bound - prev_bound) * frac
            prev_bound, prev_count = bound, count
        return prev_bound


@dataclass
class _Sample:
    start: float
    value: float = 0.0
    count: int = 0


class SampledStat(Stat):
    """Ring of `num_samples` time windows; obsolete windows are purged at
    measurement (Kafka SampledStat semantics)."""

    def __init__(self, initial: float) -> None:
        self._initial = initial
        self._samples: list[_Sample] = []
        self._current = 0
        # record() runs under the owning sensor's lock, but measure() is
        # driven by snapshot readers on other threads; both mutate the sample
        # ring (window advance / purge), so the stat needs its own lock.
        self._stat_lock = new_lock("core.SampledStat._stat_lock")

    def record(self, value: float, now: float) -> None:
        with self._stat_lock:
            sample = self._current_sample(now)
            self.update(sample, value)

    def _current_sample(self, now: float) -> _Sample:
        if not self._samples:
            self._samples.append(_Sample(now, self._initial))
        sample = self._samples[self._current]
        if now - sample.start >= self._window_s:
            self._current = (self._current + 1) % max(self._num_samples, 1)
            if self._current < len(self._samples):
                sample = self._samples[self._current]
                sample.start, sample.value, sample.count = now, self._initial, 0
            else:
                sample = _Sample(now, self._initial)
                self._samples.append(sample)
        return sample

    # Window geometry comes from the registry config at bind time.
    _window_s: float = 30.0
    _num_samples: int = 2

    def configure(self, config: MetricConfig) -> None:
        self._window_s = config.sample_window_s
        self._num_samples = config.num_samples

    def _purge(self, now: float) -> None:
        expire_age = self._num_samples * self._window_s
        for s in self._samples:
            if now - s.start >= expire_age:
                s.start, s.value, s.count = now, self._initial, 0

    def update(self, sample: _Sample, value: float) -> None:
        raise NotImplementedError

    def combine(self, now: float) -> float:
        raise NotImplementedError

    def measure(self, config: MetricConfig, now: float) -> float:
        with self._stat_lock:
            self.configure(config)
            self._purge(now)
            return self.combine(now)


class Rate(SampledStat):
    """Recorded sum / elapsed window time (per second)."""

    def __init__(self) -> None:
        super().__init__(0.0)

    def update(self, sample: _Sample, value: float) -> None:
        sample.value += value
        sample.count += 1

    def combine(self, now: float) -> float:
        if not self._samples:
            return 0.0
        total = sum(s.value for s in self._samples)
        oldest = min(s.start for s in self._samples)
        # Kafka floors elapsed at (numSamples-1) full windows to avoid
        # early-lifetime over-estimation.
        elapsed = max(now - oldest, (self._num_samples - 1) * self._window_s)
        return total / elapsed if elapsed > 0 else 0.0


class Avg(SampledStat):
    def __init__(self) -> None:
        super().__init__(0.0)

    def update(self, sample: _Sample, value: float) -> None:
        sample.value += value
        sample.count += 1

    def combine(self, now: float) -> float:
        total = sum(s.value for s in self._samples)
        count = sum(s.count for s in self._samples)
        return total / count if count else 0.0


class Max(SampledStat):
    def __init__(self) -> None:
        super().__init__(float("-inf"))

    def update(self, sample: _Sample, value: float) -> None:
        sample.value = max(sample.value, value)
        sample.count += 1

    def combine(self, now: float) -> float:
        best = max((s.value for s in self._samples if s.count), default=float("-inf"))
        return best if best != float("-inf") else 0.0


# ------------------------------------------------------------------ sensors
class Sensor:
    """Fan-out recording point: one record() updates every bound stat.

    `recording_level` gates recording like Kafka's Sensor.RecordingLevel: a
    DEBUG sensor only records when the registry config's recording level is
    DEBUG (`metrics.recording.level`)."""

    def __init__(self, name: str, registry: "MetricsRegistry",
                 recording_level: str = "INFO") -> None:
        self.name = name
        self.recording_level = recording_level
        self._registry = registry
        self._stats: list[tuple[MetricName, Stat]] = []
        self._lock = new_lock("core.Sensor._lock")

    def _bind(self, metric_name: MetricName, stat: Stat) -> None:
        if isinstance(stat, SampledStat):
            # Window geometry must be set before the first record(), not just
            # at measure() time, or events are bucketed with default windows.
            stat.configure(self._registry.config)
        self._stats.append((metric_name, stat))
        self._registry.register(metric_name, stat)

    def add(self, metric_name: MetricName, stat: Stat) -> "Sensor":
        with self._lock:
            self._bind(metric_name, stat)
        return self

    def ensure_stats(
        self, factory: Callable[[], list[tuple[MetricName, Stat]]]
    ) -> "Sensor":
        """Bind the factory's stats only if the sensor has none yet — atomic,
        so concurrent first recordings can't double-register or orphan stats."""
        with self._lock:
            if not self._stats:
                for metric_name, stat in factory():
                    self._bind(metric_name, stat)
        return self

    def record(self, value: float = 1.0, now: Optional[float] = None) -> None:
        if not self._registry.should_record(self.recording_level):
            return
        now = self._registry.time() if now is None else now
        with self._lock:
            for _, stat in self._stats:
                stat.record(value, now)


class MetricsRegistry:
    """Sensor + metric registry with snapshot export (the JMX stand-in)."""

    def __init__(self, config: Optional[MetricConfig] = None,
                 time_source: Callable[[], float] = time.monotonic) -> None:
        self.config = config or MetricConfig()
        self.time = time_source
        self._sensors: dict[str, Sensor] = {}
        self._metrics: dict[MetricName, Stat | Callable[[], float]] = {}
        self._lock = new_lock("core.MetricsRegistry._lock")

    def sensor(self, name: str, recording_level: str = "INFO") -> Sensor:
        """Create-or-get, idempotent (commons SensorProvider semantics)."""
        with self._lock:
            if name not in self._sensors:
                self._sensors[name] = Sensor(name, self, recording_level)
            return self._sensors[name]

    def should_record(self, sensor_level: str) -> bool:
        """INFO sensors always record; DEBUG sensors only when the configured
        recording level is DEBUG (`metrics.recording.level`)."""
        return sensor_level != "DEBUG" or self.config.recording_level == "DEBUG"

    def register(self, metric_name: MetricName, stat: Stat) -> None:
        with self._lock:
            self._metrics[metric_name] = stat

    def add_gauge(self, metric_name: MetricName, supplier: Callable[[], float]) -> None:
        """Supplier-backed gauge (MeasurableValue)."""
        with self._lock:
            self._metrics[metric_name] = supplier

    def value(self, metric_name: MetricName) -> float:
        m = self._metrics[metric_name]
        if isinstance(m, Stat):
            return m.measure(self.config, self.time())
        return float(m())

    def stat(self, metric_name: MetricName):
        """The registered Stat (or gauge supplier) behind a metric — exporters
        that need more than a scalar (histogram buckets) read through this."""
        with self._lock:
            return self._metrics[metric_name]

    def find(self, name: str, tags: Optional[Mapping[str, str]] = None) -> list[MetricName]:
        want = tuple(sorted((tags or {}).items()))
        return [
            mn for mn in self._metrics
            if mn.name == name and (tags is None or mn.tags == want)
        ]

    def snapshot(self) -> dict[str, float]:
        """Point-in-time view of every metric, stringly keyed."""
        with self._lock:
            names = list(self._metrics)
        return {str(mn): self.value(mn) for mn in names}

    @property
    def metric_names(self) -> list[MetricName]:
        with self._lock:
            return list(self._metrics)
