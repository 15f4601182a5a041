"""Profiling hooks for the port's entry points: call counts, the first
call's wall time apart from the steady calls', device time from CUDA
events, and an optional ``torch.profiler`` trace.

``TorchProfiler.wrap`` turns a callable into a counted one:

* every call is wall-clock timed on the host;
* an entry's first call is kept apart from the rest: it builds the CUDA
  kernels it launches and warms the allocator, where the reference's first
  call compiles its program, so the split tells set-up from steady work;
* when a call's tensor arguments are on the card, a pair of CUDA events
  brackets it on the current stream; the events are read when the
  snapshot is taken, never per call, so wrapping adds no synchronization.

The wrapper calls the wrapped function unchanged (same arguments, same
outputs), so wrapping is value-transparent; ``NullProbe.wrap_jit`` skips
even that.  The reference's jit profiler also counts compile-cache entries
and donation warnings; eager PyTorch has neither.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["ProfileEntry", "TorchProfiler", "profiler_trace"]


@dataclass
class ProfileEntry:
    """Per-wrapped-function counters."""

    name: str
    calls: int = 0
    first_call_s: float = 0.0      # wall time of the first call
    steady_s: float = 0.0          # wall time of every later call
    _events: list = field(default_factory=list, repr=False)
    _device_s: float = 0.0
    _on_card: bool = False

    def device_s(self) -> float | None:
        """Seconds between the CUDA events of every call that ran on the
        card (None if none did); waits for the pending events."""
        for start, end in self._events:
            end.synchronize()
            self._device_s += start.elapsed_time(end) / 1e3
        self._events.clear()
        return self._device_s if self._on_card else None

    def to_dict(self) -> dict:
        return {"name": self.name, "calls": self.calls,
                "first_call_s": round(self.first_call_s, 6),
                "steady_s": round(self.steady_s, 6),
                "steady_calls": max(self.calls - 1, 0),
                "device_s": self.device_s()}


def _on_card(args, kwargs) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda
               for a in (*args, *kwargs.values()))


class TorchProfiler:
    """Collects :class:`ProfileEntry` stats for every wrapped entry."""

    def __init__(self):
        self.entries: dict = {}

    def entry(self, name: str) -> ProfileEntry:
        e = self.entries.get(name)
        if e is None:
            e = self.entries[name] = ProfileEntry(name)
        return e

    def wrap(self, fn, name: str):
        """Wrap ``fn`` with call counting, the first-call / steady split and
        (on the card) CUDA-event device time."""
        e = self.entry(name)

        def wrapped(*args, **kwargs):
            events = None
            if _on_card(args, kwargs):
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            if events is not None:
                events[1].record()
                e._events.append(events)
                e._on_card = True
            if e.calls == 0:
                e.first_call_s += dt
            else:
                e.steady_s += dt
            e.calls += 1
            return out

        wrapped.__name__ = f"profiled[{name}]"
        wrapped.__wrapped__ = fn
        return wrapped

    def snapshot(self) -> dict:
        """JSON-serializable {entry name: counters}."""
        return {n: e.to_dict() for n, e in sorted(self.entries.items())}


class profiler_trace:
    """Optional ``torch.profiler`` trace: a context manager that profiles
    the host and, when there is one, the card, and writes the chrome trace
    to ``trace_dir/trace.json`` on exit; a no-op when ``trace_dir`` is
    None or the profiler cannot start.  Open the file in Perfetto or
    chrome://tracing."""

    def __init__(self, trace_dir: str | None):
        self.trace_dir = trace_dir
        self.path = None
        self._prof = None

    def __enter__(self):
        if self.trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.__enter__()
            except Exception:
                self._prof = None
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            try:
                self._prof.__exit__(None, None, None)
                os.makedirs(self.trace_dir, exist_ok=True)
                path = os.path.join(self.trace_dir, "trace.json")
                self._prof.export_chrome_trace(path)
                self.path = path
            except Exception:
                self.path = None
            self._prof = None
        return False
