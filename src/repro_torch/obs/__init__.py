"""Round telemetry: metrics registry, span tracer, round probes, entry
profiling and the round-report renderer (DESIGN.md §15).

Quickstart::

    from repro_torch.obs import RecordingProbe, load_trace, render_report

    with RecordingProbe("run.jsonl", profiler=True) as probe:
        hist = run_federated(clients, test, flcfg, probe=probe)
    print(render_report(load_trace("run.jsonl")))

The trace's records follow the reference's schema (``SCHEMA_VERSION``), so
either package's ``validate_records`` reads the other's traces.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      METRIC_KINDS, metric_kind)
from .trace import (SCHEMA_VERSION, Tracer, chrome_trace, load_trace,
                    validate_records, validate_trace, write_chrome_trace)
from .probe import (NULL_PROBE, NullProbe, RecordingProbe, RoundProbe,
                    as_probe)
from .torchprof import ProfileEntry, TorchProfiler, profiler_trace
from .report import render_markdown, render_report, round_rows

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "METRIC_KINDS",
    "metric_kind",
    "SCHEMA_VERSION", "Tracer", "chrome_trace", "load_trace",
    "validate_records", "validate_trace", "write_chrome_trace",
    "NULL_PROBE", "NullProbe", "RecordingProbe", "RoundProbe", "as_probe",
    "ProfileEntry", "TorchProfiler", "profiler_trace",
    "render_markdown", "render_report", "round_rows",
]
