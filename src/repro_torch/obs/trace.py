"""Span-based tracing: nested spans emitted as JSONL, plus a Perfetto /
chrome-trace export (DESIGN.md §15).

One trace file = one JSONL record per line, schema-versioned and
append-only.  Append-only is what makes traces crash-safe: every record is
written and flushed as soon as its span closes, so a run killed at round k
leaves rounds 1..k intact on disk, and the resumed process (same path,
append mode) continues the stream — the merged file reads as one seamless
run (pinned in ``tests/test_torch_obs.py``).

Record types (see :data:`SCHEMA_VERSION` / :func:`validate_records`):

* ``meta``    — one per process attach: schema version, wall time, run
  attributes (config summary, ``resumed_from`` round).
* ``span``    — a closed interval on one of two clocks: ``host``
  (``time.perf_counter`` seconds since the tracer attached) or ``sim``
  (the dataplane's simulated seconds).  Spans nest through ``parent``.
* ``metric``  — one observation: name, float value, kind, optional round
  and labels.
* ``summary`` — the final registry snapshot a recording probe appends on
  close.

The tracer is deliberately plain host-side Python (json + file I/O): it
never touches a tensor, so instrumented runs stay bit-identical (§15
no-perturbation rule).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

__all__ = ["SCHEMA_VERSION", "Span", "Tracer", "load_trace",
           "validate_records", "validate_trace", "chrome_trace",
           "write_chrome_trace"]

SCHEMA_VERSION = 1

_CLOCKS = ("host", "sim")


@dataclass
class Span:
    """An open span; closed (and written) by the tracer."""

    name: str
    id: int
    parent: int | None
    t0: float
    clock: str = "host"
    round: int | None = None
    attrs: dict = field(default_factory=dict)


class Tracer:
    """Writes one JSONL trace stream; tracks the open-span stack.

    ``path=None`` keeps records in memory only (``tracer.records``) —
    handy for tests and for the report renderer.  With a path, records
    are appended and flushed line-by-line.
    """

    def __init__(self, path: str | None = None, run_attrs: dict | None = None):
        self.path = path
        self.records: list = []
        self._fh = open(path, "a", buffering=1) if path else None
        self._t0 = time.perf_counter()
        self._next_id = 0
        self._stack: list = []          # open host-span ids
        self.write({"type": "meta", "schema": SCHEMA_VERSION,
                    "unix_time": time.time(), "run": dict(run_attrs or {})})

    # ------------------------------------------------------------------
    def now(self) -> float:
        """Host seconds since this tracer attached."""
        return time.perf_counter() - self._t0

    def write(self, record: dict) -> None:
        self.records.append(record)
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")

    # ------------------------------------------------------------------
    def span(self, name: str, *, round: int | None = None, **attrs):
        """Context manager: a host-clock span around a ``with`` body."""
        return _SpanCM(self, name, round, attrs)

    def begin(self, name: str, *, round: int | None = None, **attrs) -> Span:
        sp = Span(name=name, id=self._next_id,
                  parent=self._stack[-1] if self._stack else None,
                  t0=self.now(), round=round, attrs=attrs)
        self._next_id += 1
        self._stack.append(sp.id)
        return sp

    def end(self, sp: Span) -> None:
        t1 = self.now()
        if self._stack and self._stack[-1] == sp.id:
            self._stack.pop()
        self._write_span(sp.name, sp.id, sp.parent, sp.t0, t1, "host",
                         sp.round, sp.attrs)

    def sim_span(self, name: str, t0: float, t1: float, *,
                 round: int | None = None, **attrs) -> None:
        """A span on the *simulated* clock (already-traced aux seconds —
        e.g. the dataplane's phase1/phase2 completion times).  Parentage
        follows the currently open host span so the report can group
        simulated phases under their round."""
        sp_id = self._next_id
        self._next_id += 1
        self._write_span(name, sp_id, self._stack[-1] if self._stack
                         else None, float(t0), float(t1), "sim", round, attrs)

    def _write_span(self, name, sp_id, parent, t0, t1, clock, round_, attrs):
        self.write({"type": "span", "name": name, "id": sp_id,
                    "parent": parent, "t0": t0, "t1": t1,
                    "dur_s": max(t1 - t0, 0.0), "clock": clock,
                    "round": round_, "attrs": dict(attrs)})

    def metric(self, name: str, value: float, *, kind: str = "gauge",
               round: int | None = None, labels: dict | None = None) -> None:
        self.write({"type": "metric", "name": name, "value": float(value),
                    "kind": kind, "round": round,
                    "labels": dict(labels or {})})

    def summary(self, snapshot: dict) -> None:
        self.write({"type": "summary", "metrics": snapshot})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class _SpanCM:
    __slots__ = ("_tr", "_name", "_round", "_attrs", "_sp")

    def __init__(self, tr, name, round_, attrs):
        self._tr, self._name, self._round, self._attrs = \
            tr, name, round_, attrs

    def __enter__(self):
        self._sp = self._tr.begin(self._name, round=self._round,
                                  **self._attrs)
        return self._sp

    def __exit__(self, *exc):
        self._tr.end(self._sp)
        return False


# ---------------------------------------------------------------------------
# loading + schema validation
# ---------------------------------------------------------------------------

def load_trace(path: str) -> list:
    """Parse a JSONL trace file into a list of record dicts."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_span(i: int, r: dict, errors: list, seen_ids: set) -> None:
    for k in ("name", "id", "t0", "t1", "dur_s", "clock"):
        if k not in r:
            errors.append(f"record {i}: span missing {k!r}")
            return
    if not isinstance(r["name"], str) or not r["name"]:
        errors.append(f"record {i}: span name must be a non-empty string")
    if not isinstance(r["id"], int):
        errors.append(f"record {i}: span id must be int")
    if r["clock"] not in _CLOCKS:
        errors.append(f"record {i}: span clock {r['clock']!r} not in "
                      f"{_CLOCKS}")
    if not (_is_num(r["t0"]) and _is_num(r["t1"]) and _is_num(r["dur_s"])):
        errors.append(f"record {i}: span times must be numbers")
    elif r["dur_s"] < 0 or r["t1"] < r["t0"]:
        errors.append(f"record {i}: span {r['name']!r} has negative "
                      "duration")
    parent = r.get("parent")
    if parent is not None and not isinstance(parent, int):
        errors.append(f"record {i}: span parent must be int or null")
    rnd = r.get("round")
    if rnd is not None and not isinstance(rnd, int):
        errors.append(f"record {i}: span round must be int or null")
    if not isinstance(r.get("attrs", {}), dict):
        errors.append(f"record {i}: span attrs must be a dict")
    if isinstance(r.get("id"), int):
        seen_ids.add(r["id"])


def _check_metric(i: int, r: dict, errors: list) -> None:
    if not isinstance(r.get("name"), str) or not r.get("name"):
        errors.append(f"record {i}: metric name must be a non-empty string")
    if not _is_num(r.get("value")):
        errors.append(f"record {i}: metric {r.get('name')!r} value must be "
                      "a finite number")
    if r.get("kind") not in ("counter", "gauge", "histogram"):
        errors.append(f"record {i}: metric kind {r.get('kind')!r} invalid")
    rnd = r.get("round")
    if rnd is not None and not isinstance(rnd, int):
        errors.append(f"record {i}: metric round must be int or null")
    if not isinstance(r.get("labels", {}), dict):
        errors.append(f"record {i}: metric labels must be a dict")


def validate_records(records: list) -> list:
    """Schema-validate every record; returns a list of error strings
    (empty = valid).  Tolerates multiple ``meta`` records (one per attach
    — that is exactly what a kill + resume produces) but requires the
    first record of the stream to be a ``meta`` with a known schema."""
    errors: list = []
    if not records:
        return ["empty trace"]
    if records[0].get("type") != "meta":
        errors.append("record 0: trace must open with a meta record")
    seen_ids: set = set()
    for i, r in enumerate(records):
        t = r.get("type")
        if t == "meta":
            if r.get("schema") != SCHEMA_VERSION:
                errors.append(f"record {i}: unknown schema "
                              f"{r.get('schema')!r} (expected "
                              f"{SCHEMA_VERSION})")
            if not isinstance(r.get("run", {}), dict):
                errors.append(f"record {i}: meta run must be a dict")
        elif t == "span":
            _check_span(i, r, errors, seen_ids)
        elif t == "metric":
            _check_metric(i, r, errors)
        elif t == "summary":
            if not isinstance(r.get("metrics"), dict):
                errors.append(f"record {i}: summary metrics must be a dict")
        else:
            errors.append(f"record {i}: unknown record type {t!r}")
    return errors


def validate_trace(path: str) -> list:
    """Load + validate; returns error strings (empty = valid)."""
    try:
        records = load_trace(path)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable trace {path}: {e}"]
    return validate_records(records)


# ---------------------------------------------------------------------------
# Perfetto / chrome-trace export (chrome://tracing 'X' complete events)
# ---------------------------------------------------------------------------

def chrome_trace(records: list) -> dict:
    """Convert trace records to the chrome-trace JSON object format.

    Host-clock spans land on pid 0 ("host"), simulated-clock spans on
    pid 1 ("sim") — open the file in Perfetto / chrome://tracing to see
    the round -> phase hierarchy on both clocks side by side.
    """
    events = [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "host clock"}},
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "simulated clock"}},
    ]
    for r in records:
        if r.get("type") != "span":
            continue
        pid = 0 if r["clock"] == "host" else 1
        args = dict(r.get("attrs", {}))
        if r.get("round") is not None:
            args["round"] = r["round"]
        events.append({"ph": "X", "pid": pid, "tid": 0, "name": r["name"],
                       "ts": r["t0"] * 1e6, "dur": r["dur_s"] * 1e6,
                       "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(records: list, out_path: str) -> int:
    """Write the chrome-trace export; returns the number of events."""
    trace = chrome_trace(records)
    with open(out_path, "w") as fh:
        json.dump(trace, fh)
    return len(trace["traceEvents"])
