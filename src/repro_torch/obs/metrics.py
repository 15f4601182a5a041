"""Typed metrics registry: counters, gauges and histograms with labels
(DESIGN.md §15).

The registry is the *aggregated* view of a run's telemetry — the trace
(``repro_torch.obs.trace``) is the raw per-round record stream, the registry is
what you ask "how many ARQ retransmissions total" or "what did
``consensus_k`` look like".  Metrics are typed at registration: asking for
an existing name with a different type raises, so ``arq_retransmits`` can
never silently flip from counter to gauge between subsystems.

Everything here is host-side Python over plain floats — nothing is traced,
nothing touches a tensor, so feeding a registry can never perturb a
round (the §15 no-perturbation rule).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "METRIC_KINDS", "metric_kind"]

# Histogram bucket upper bounds: log-spaced, wide enough for both byte
# counts and (simulated or host) second durations.
DEFAULT_BUCKETS = tuple(10.0 ** e for e in range(-6, 10))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


@dataclass
class Counter:
    """Monotonically increasing sum per label set (e.g. retransmissions)."""

    name: str
    help: str = ""
    series: dict = field(default_factory=dict)   # label tuple -> float

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative increment "
                             f"{value}")
        k = _label_key(labels)
        self.series[k] = self.series.get(k, 0.0) + float(value)

    def value(self, **labels) -> float:
        return self.series.get(_label_key(labels), 0.0)


@dataclass
class Gauge:
    """Last-observed value per label set (e.g. ``consensus_k``)."""

    name: str
    help: str = ""
    series: dict = field(default_factory=dict)

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self.series.get(_label_key(labels), math.nan)


@dataclass
class Histogram:
    """Bucketed distribution per label set (e.g. per-round phase seconds).

    ``buckets`` are inclusive upper bounds; observations above the last
    bound land in the implicit +inf bucket.  Tracks count/sum/min/max per
    label set alongside the bucket counts.
    """

    name: str
    help: str = ""
    buckets: tuple = DEFAULT_BUCKETS
    series: dict = field(default_factory=dict)

    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        k = _label_key(labels)
        st = self.series.get(k)
        if st is None:
            st = {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf,
                  "bucket_counts": [0] * (len(self.buckets) + 1)}
            self.series[k] = st
        st["count"] += 1
        st["sum"] += v
        st["min"] = min(st["min"], v)
        st["max"] = max(st["max"], v)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                st["bucket_counts"][i] += 1
                break
        else:
            st["bucket_counts"][-1] += 1

    def stats(self, **labels) -> dict | None:
        return self.series.get(_label_key(labels))


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create store of typed metrics.

    One registry per recorded run (a :class:`repro_torch.obs.probe.RecordingProbe`
    owns one); ``snapshot()`` is the JSON-serializable dump the probe
    appends to the trace as the final ``summary`` record.
    """

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name=name, help=help, **kwargs)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self):
        return len(self._metrics)

    def get(self, name: str):
        return self._metrics.get(name)

    def record(self, name: str, value: float, *, kind: str | None = None,
               **labels) -> None:
        """Route one observation by kind (defaults to :func:`metric_kind`)."""
        kind = kind or metric_kind(name)
        if kind == "counter":
            self.counter(name).inc(value, **labels)
        elif kind == "histogram":
            self.histogram(name).observe(value, **labels)
        else:
            self.gauge(name).set(value, **labels)

    def snapshot(self) -> dict:
        """JSON-serializable dump: {name: {kind, series: [{labels, ...}]}}."""
        out = {}
        for m in self:
            series = []
            for k, v in m.series.items():
                entry = {"labels": dict(k)}
                if m.kind == "histogram":
                    entry.update({kk: (vv if kk != "bucket_counts"
                                       else list(vv))
                                  for kk, vv in v.items()})
                else:
                    entry["value"] = v
                series.append(entry)
            out[m.name] = {"kind": m.kind, "help": m.help, "series": series}
        return out


# ---------------------------------------------------------------------------
# the metric taxonomy (DESIGN.md §15): what kind each known quantity is.
# Additive event counts are counters; per-round levels are gauges;
# durations and byte volumes additionally feed histograms so the report
# can show distributions.  Unknown names default to gauge.
# ---------------------------------------------------------------------------

METRIC_KINDS = {
    # round health (gauges: per-round levels)
    "acc": "gauge", "loss": "gauge",
    "consensus_k": "gauge", "vote_agreement_frac": "gauge",
    "residual_norm": "gauge", "delta_norm": "gauge",
    "register_occupancy": "gauge",
    "n_active": "gauge", "n_part": "gauge", "n_up": "gauge",
    "vote_threshold_a": "gauge",
    # wire volumes and times (histograms: distributions over rounds)
    "upload_bytes": "histogram", "broadcast_bytes": "histogram",
    "phase1_bytes": "histogram", "phase2_bytes": "histogram",
    "wall_clock_s": "histogram", "phase1_s": "histogram",
    "phase2_s": "histogram", "mean_wait_s": "histogram",
    # cumulative event counts (counters)
    "arq_retransmits": "counter", "retransmissions": "counter",
    "straggler_drops": "counter", "stragglers": "counter",
    "votes_lost": "counter", "overflow_slots": "counter",
    "passes": "counter", "aggregation_ops": "counter",
    "crashed": "counter", "duplicates": "counter", "resets": "counter",
    "aborted": "counter", "attempts": "counter",
    # async quorum-or-deadline close (DESIGN.md §17)
    "late_folded": "counter", "late_bounced": "counter",
    "late_folds": "counter", "late_bounces": "counter",
    "folded_in": "counter", "quorum_met": "counter",
    "staleness_s_sum": "histogram",
    "buffer_occupancy": "gauge", "carry_weight": "gauge",
    # Byzantine attacks, defenses and reputation (DESIGN.md §18):
    # injected/filtered ballot and value events are counters; the cohort
    # sizes (who is Byzantine / quarantined this round) are levels.
    "stuffed_votes": "counter", "budget_rejected": "counter",
    "clipped_values": "counter", "trimmed_values": "counter",
    "rep_flagged": "counter",
    "byzantine": "gauge", "quarantined": "gauge",
}


def metric_kind(name: str) -> str:
    return METRIC_KINDS.get(name, "gauge")
