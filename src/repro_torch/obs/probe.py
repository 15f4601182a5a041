"""Engine probes: the ``RoundProbe`` protocol the FL loop, the packet
transport and ``aggregate_round`` are instrumented with (DESIGN.md §15).

Two rules make probes safe to thread through the hot paths:

* **No perturbation.**  A probe is fed only from (a) values a round
  already returns (the packet core's accounting scalars, the transports'
  stats dicts) and (b) host-side wrappers around entry points.  A probe
  never changes what a round computes, so with any probe every output is
  bit-identical to the run without one (pinned across all vote x compact
  pairs and a chaos cell in ``tests/test_torch_obs.py``).  An enabled
  probe may read values back from the card and synchronize it; the path
  without a probe adds no synchronization and no read-back.
* **Null is free.**  :class:`NullProbe` (the default everywhere) has
  ``enabled = False`` and no-op methods; instrumentation sites guard any
  payload construction with ``if probe.enabled``, so the un-probed hot
  path pays one attribute read per site.

:class:`RecordingProbe` is the real implementation: it owns a
:class:`~repro_torch.obs.trace.Tracer` (JSONL spans) and a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (typed aggregates), and
optionally a :class:`~repro_torch.obs.torchprof.TorchProfiler` for the
first-call / steady split and the device time of the entries it wraps.
``wrap_jit`` keeps the reference's name; here it wraps an eager callable.
"""

from __future__ import annotations

import contextlib
import time
from typing import Protocol, runtime_checkable

from .metrics import MetricsRegistry, metric_kind
from .trace import SCHEMA_VERSION, Tracer

__all__ = ["RoundProbe", "NullProbe", "RecordingProbe", "NULL_PROBE",
           "as_probe"]


@runtime_checkable
class RoundProbe(Protocol):
    """What the instrumented engines call.  See :class:`RecordingProbe`
    for semantics; :class:`NullProbe` for the no-op contract."""

    enabled: bool

    def run_start(self, **attrs) -> None: ...
    def span(self, name: str, *, round: int | None = None, **attrs): ...
    def sim_phase(self, name: str, t0: float, t1: float, *,
                  round: int | None = None, **attrs) -> None: ...
    def metrics(self, payload: dict, *, round: int | None = None,
                labels: dict | None = None) -> None: ...
    def wrap_jit(self, fn, name: str): ...
    def close(self) -> None: ...


class NullProbe:
    """The default probe: every method is a no-op, ``enabled`` is False.

    Instrumented code guards payload construction on ``probe.enabled``, so
    running with this probe is behaviourally and numerically identical to
    the un-instrumented code: same operations, same values, no I/O.
    """

    enabled = False

    def run_start(self, **attrs) -> None:
        pass

    def span(self, name: str, *, round: int | None = None, **attrs):
        return contextlib.nullcontext()

    def sim_phase(self, name: str, t0, t1, *, round: int | None = None,
                  **attrs) -> None:
        pass

    def metrics(self, payload: dict, *, round: int | None = None,
                labels: dict | None = None) -> None:
        pass

    def wrap_jit(self, fn, name: str):
        return fn

    def close(self) -> None:
        pass


NULL_PROBE = NullProbe()


def as_probe(probe) -> RoundProbe:
    """``None`` -> the shared :data:`NULL_PROBE`; anything else passes
    through (ducks as a :class:`RoundProbe`)."""
    return NULL_PROBE if probe is None else probe


class RecordingProbe:
    """Record spans to a JSONL trace and observations to a typed registry.

    Parameters
    ----------
    trace_path:
        JSONL file to append to (``None`` = in-memory only, see
        ``self.tracer.records``).  Append mode + per-record flush is what
        makes a kill-at-round-k trace merge seamlessly with the resumed
        process's records (DESIGN.md §15).
    registry:
        A shared :class:`MetricsRegistry`; a fresh one by default.
    profiler:
        A :class:`repro_torch.obs.torchprof.TorchProfiler` (or ``True`` for
        a fresh one) — entries passed through :meth:`wrap_jit` then report
        their calls, first-call / steady split and device time into the
        trace summary.
    """

    enabled = True

    def __init__(self, trace_path: str | None = None, *,
                 registry: MetricsRegistry | None = None,
                 profiler=None, run_attrs: dict | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        if profiler is True:
            from .torchprof import TorchProfiler
            profiler = TorchProfiler()
        self.profiler = profiler
        self.tracer = Tracer(trace_path, run_attrs=run_attrs)
        self._closed = False

    # ------------------------------------------------------------------
    def run_start(self, **attrs) -> None:
        # each run (including a resumed process appending to the same
        # trace) announces its own context as a fresh meta record
        self.tracer.write({"type": "meta", "schema": SCHEMA_VERSION,
                           "unix_time": time.time(),
                           "run": {k: _jsonable(v) for k, v in attrs.items()}})

    def span(self, name: str, *, round: int | None = None, **attrs):
        return self.tracer.span(name, round=round, **attrs)

    def sim_phase(self, name: str, t0, t1, *, round: int | None = None,
                  **attrs) -> None:
        self.tracer.sim_span(name, float(t0), float(t1), round=round,
                             **attrs)

    def metrics(self, payload: dict, *, round: int | None = None,
                labels: dict | None = None) -> None:
        labels = labels or {}
        for name, value in payload.items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            kind = metric_kind(name)
            self.registry.record(name, v, kind=kind, **labels)
            self.tracer.metric(name, v, kind=kind, round=round,
                               labels=labels)

    def wrap_jit(self, fn, name: str):
        if self.profiler is None:
            return fn
        return self.profiler.wrap(fn, name)

    def close(self) -> None:
        if self._closed:
            return
        snapshot = self.registry.snapshot()
        if self.profiler is not None:
            snapshot["__profile__"] = self.profiler.snapshot()
        self.tracer.summary(snapshot)
        self.tracer.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
