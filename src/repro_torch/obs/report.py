"""Round-report rendering: turn a JSONL trace into a per-round table of
phases, bytes and faults, as terminal text or markdown (DESIGN.md §15).

The renderer is pure record-munging — it groups ``span`` records by round
(host and sim clocks separately), folds ``metric`` records into per-round
rows, and appends whatever the ``summary`` record says about totals and
the profiled entries (:mod:`.torchprof`: calls, the first call's wall
time beside the steady calls', and device time where an entry ran on the
card).
"""

from __future__ import annotations

from collections import defaultdict

__all__ = ["round_rows", "render_report", "render_markdown"]

# metric -> (column header, scale); bytes render as MB
_ROUND_COLS = (
    ("acc", "acc", 1.0),
    ("loss", "loss", 1.0),
    ("consensus_k", "k", 1.0),
    ("vote_agreement_frac", "agree", 1.0),
    ("upload_bytes", "up_MB", 1.0 / 2**20),
    ("broadcast_bytes", "bcast_MB", 1.0 / 2**20),
    ("retransmissions", "retx", 1.0),
    ("stragglers", "strag", 1.0),
    ("votes_lost", "v_lost", 1.0),
    ("overflow_slots", "ovfl", 1.0),
    ("crashed", "crash", 1.0),
)

_FAULT_NAMES = ("votes_lost", "stragglers", "retransmissions",
                "overflow_slots", "crashed", "duplicates", "resets",
                "aborted")


def round_rows(records: list) -> list:
    """Fold trace records into one dict per round.

    Each row carries ``round``, ``host_s`` (the round span's host
    duration), ``sim_s`` (total simulated phase seconds), ``phases``
    ({span name: seconds} on the sim clock), and every per-round metric
    observed for that round.
    """
    rows: dict = {}

    def row(rnd):
        r = rows.get(rnd)
        if r is None:
            r = rows[rnd] = {"round": rnd, "host_s": 0.0, "sim_s": 0.0,
                             "phases": defaultdict(float), "metrics": {}}
        return r

    for rec in records:
        rnd = rec.get("round")
        if rnd is None:
            continue
        t = rec.get("type")
        if t == "span":
            r = row(rnd)
            if rec["clock"] == "sim":
                r["phases"][rec["name"]] += rec["dur_s"]
                r["sim_s"] += rec["dur_s"]
            elif rec["name"] == "round":
                r["host_s"] += rec["dur_s"]
            else:
                r["phases"][rec["name"]] += rec["dur_s"]
        elif t == "metric":
            row(rnd)["metrics"][rec["name"]] = rec["value"]
    out = []
    for rnd in sorted(rows):
        r = rows[rnd]
        r["phases"] = dict(r["phases"])
        out.append(r)
    return out


def _fmt(v: float) -> str:
    if v != v:                       # NaN
        return "-"
    if v == int(v) and abs(v) < 1e6:
        return str(int(v))
    return f"{v:.4g}"


def _table(headers: list, body: list, markdown: bool) -> list:
    widths = [max(len(h), *(len(row[i]) for row in body)) if body
              else len(h) for i, h in enumerate(headers)]
    lines = []
    if markdown:
        lines.append("| " + " | ".join(h.ljust(w) for h, w
                                       in zip(headers, widths)) + " |")
        lines.append("|" + "|".join("-" * (w + 2) for w in widths) + "|")
        for row in body:
            lines.append("| " + " | ".join(c.ljust(w) for c, w
                                           in zip(row, widths)) + " |")
    else:
        lines.append("  ".join(h.rjust(w) for h, w in zip(headers, widths)))
        lines.append("  ".join("-" * w for w in widths))
        for row in body:
            lines.append("  ".join(c.rjust(w) for c, w
                                   in zip(row, widths)))
    return lines


def _meta_lines(records: list) -> list:
    lines = []
    # only metas announcing run context count as attaches (the Tracer
    # constructor writes a bare meta too)
    runs = [r["run"] for r in records
            if r.get("type") == "meta" and r.get("run")]
    for i, run in enumerate(runs):
        attrs = ", ".join(f"{k}={v}" for k, v in sorted(run.items()))
        tag = "run" if len(runs) == 1 else f"run (attach {i + 1})"
        lines.append(f"{tag}: {attrs}")
    return lines


def _fault_lines(rows: list) -> list:
    totals = defaultdict(float)
    for r in rows:
        for name in _FAULT_NAMES:
            if name in r["metrics"]:
                totals[name] += r["metrics"][name]
    nonzero = {k: v for k, v in totals.items() if v}
    if not nonzero:
        return ["faults: none recorded"]
    return ["faults: " + ", ".join(f"{k}={_fmt(v)}"
                                   for k, v in sorted(nonzero.items()))]


def _profile_lines(records: list, markdown: bool) -> list:
    summaries = [r for r in records if r.get("type") == "summary"]
    if not summaries:
        return []
    prof = summaries[-1].get("metrics", {}).get("__profile__")
    if not prof:
        return []
    headers = ["entry", "calls", "first_s", "steady_s", "device_s"]
    body = [[name, _fmt(e["calls"]), f"{e['first_call_s']:.3f}",
             f"{e['steady_s']:.3f}",
             "-" if e["device_s"] is None else f"{e['device_s']:.3f}"]
            for name, e in sorted(prof.items())]
    return [""] + _table(headers, body, markdown)


def render_report(records: list, *, markdown: bool = False) -> str:
    """Render the per-round phase/bytes/faults report from trace records."""
    rows = round_rows(records)
    lines = _meta_lines(records)
    if not rows:
        lines.append("no per-round records in trace")
        return "\n".join(lines)

    headers = ["round", "host_s", "sim_s"]
    cols = [(m, h, s) for m, h, s in _ROUND_COLS
            if any(m in r["metrics"] for r in rows)]
    headers += [h for _, h, _ in cols]
    phase_names = sorted({p for r in rows for p in r["phases"]})
    headers += [f"{p}_s" for p in phase_names]

    body = []
    for r in rows:
        cells = [str(r["round"]), f"{r['host_s']:.3f}", f"{r['sim_s']:.3f}"]
        for m, _, scale in cols:
            v = r["metrics"].get(m)
            cells.append("-" if v is None else _fmt(v * scale))
        for p in phase_names:
            cells.append(f"{r['phases'].get(p, 0.0):.3f}")
        body.append(cells)

    if lines:
        lines.append("")
    lines += _table(headers, body, markdown)
    lines.append("")
    lines += _fault_lines(rows)
    lines += _profile_lines(records, markdown)
    return "\n".join(lines)


def render_markdown(records: list) -> str:
    return render_report(records, markdown=True)
