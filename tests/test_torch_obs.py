"""The port's telemetry layer (``obs/``) against the reference's.

A counterpart of each test of ``tests/test_obs.py`` that reaches the
registry, the tracer, the probes or the stat carriers (its fleet test
waits for the sweep): probes leave every output bitwise (all four vote x
compact pairs, a chaos cell, the async FL run), a trace the port writes
passes the reference's ``validate_records`` and the reference's passes the
port's, kill-and-resume merges one trace, the stat fields reach the
transport, and ``torchprof`` splits the first call from the steady ones.
Last, the slice as a whole: the async packet FL run with a recording
probe in both packages, traffic, clock and the async statistics exact,
accuracy and loss within the FL loop's band, the traces alike.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.fediac import FediACConfig as JCfg
from repro.data import classification as j_classification
from repro.data import partition_dirichlet as j_partition
from repro.netsim import AsyncConfig as JAsync
from repro.obs import RecordingProbe as JRecordingProbe
from repro.obs import validate_records as j_validate_records
from repro.training import FLConfig as JFLConfig
from repro.training import run_federated as j_run_federated
from repro_torch.checkpoint import load_run_state, save_run_state
from repro_torch.core import prng
from repro_torch.core.fediac import (FediACConfig, aggregate_round,
                                     aggregate_stack)
from repro_torch.data import classification, partition_dirichlet
from repro_torch.netsim import (ASYNC_STAT_FIELDS, AsyncConfig,
                                FaultConfig, NetConfig, PacketTransport)
from repro_torch.netsim.dataplane import DataplaneStats
from repro_torch.netsim.faults import CHAOS_STAT_FIELDS
from repro_torch.obs import (NULL_PROBE, SCHEMA_VERSION, MetricsRegistry,
                             NullProbe, RecordingProbe, TorchProfiler,
                             Tracer, as_probe, chrome_trace, load_trace,
                             metric_kind, profiler_trace, render_report,
                             round_rows, validate_records)
from repro_torch.robust import ROBUST_STAT_FIELDS, AdversaryConfig
from repro_torch.testing import key_to_torch
from repro_torch.training.fl_loop import (FLConfig, FLHistory, RoundRecord,
                                          run_federated)

MODES = [("topk", "topk"), ("topk", "block"),
         ("threshold", "topk"), ("threshold", "block")]
HIDDEN = (32,)


@pytest.fixture(scope="module")
def u_stack():
    u = jax.random.normal(jax.random.PRNGKey(1), (8, 2048)) ** 3
    return torch.from_numpy(np.array(u))


@pytest.fixture(scope="module")
def small_fl():
    data = classification(n=900, dim=16, n_classes=10, seed=0)
    train, test = data.test_split(0.25)
    return partition_dirichlet(train, 6, beta=0.5, seed=0), test


def _flcfg(rounds=3, **kw):
    base = dict(n_clients=6, rounds=rounds, local_steps=2,
                aggregator="fediac",
                agg_kwargs={"cfg": FediACConfig(a=2, bits=12)}, seed=0)
    base.update(kw)
    return FLConfig(**base)


def _fl(small_fl, cfg, **kw):
    clients, test = small_fl
    return run_federated(clients, test, cfg, hidden=HIDDEN, device="cpu",
                         **kw)


def _hist_equal(a: FLHistory, b: FLHistory) -> bool:
    return (a.acc == b.acc and a.wall_clock == b.wall_clock
            and a.traffic_mb == b.traffic_mb and a.loss == b.loss)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_registry_types_and_routing():
    reg = MetricsRegistry()
    reg.record("retransmissions", 2)          # counter by taxonomy
    reg.record("retransmissions", 3)
    reg.record("consensus_k", 41)             # gauge: last value wins
    reg.record("consensus_k", 17)
    reg.record("phase1_s", 0.5)               # histogram
    reg.record("phase1_s", 1.5)
    assert reg.get("retransmissions").value() == 5.0
    assert reg.get("consensus_k").value() == 17.0
    h = reg.get("phase1_s").stats()
    assert h["count"] == 2 and h["sum"] == 2.0
    assert h["min"] == 0.5 and h["max"] == 1.5


def test_registry_kind_conflict_and_negative_counter_raise():
    reg = MetricsRegistry()
    reg.counter("x").inc(1)
    with pytest.raises(TypeError):
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.counter("n").inc(-1)


def test_registry_labels_and_snapshot_json():
    reg = MetricsRegistry()
    reg.record("acc", 0.5, cell="a", seed="0")
    reg.record("acc", 0.7, cell="b", seed="0")
    reg.record("votes_lost", 4, cell="a")
    snap = reg.snapshot()
    json.dumps(snap)
    series = {tuple(sorted(s["labels"].items())): s["value"]
              for s in snap["acc"]["series"]}
    assert series[(("cell", "a"), ("seed", "0"))] == 0.5
    assert series[(("cell", "b"), ("seed", "0"))] == 0.7


@pytest.mark.parametrize("name,kind", [
    ("arq_retransmits", "counter"), ("overflow_slots", "counter"),
    ("late_folded", "counter"), ("consensus_k", "gauge"),
    ("register_occupancy", "gauge"), ("carry_weight", "gauge"),
    ("upload_bytes", "histogram"), ("never-heard-of-it", "gauge")])
def test_taxonomy_kinds(name, kind):
    from repro.obs import metric_kind as j_metric_kind
    assert metric_kind(name) == kind == j_metric_kind(name)


# ---------------------------------------------------------------------------
# tracer and schema validation, in both packages
# ---------------------------------------------------------------------------

def test_tracer_schema_valid_and_nested(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tr = Tracer(path, run_attrs={"demo": 1})
    with tr.span("round", round=1):
        with tr.span("eval", round=1):
            pass
        tr.sim_span("phase1-vote", 0.0, 0.25, round=1)
    tr.metric("acc", 0.5, kind="gauge", round=1)
    tr.summary({"acc": {"kind": "gauge"}})
    tr.close()
    recs = load_trace(path)
    assert validate_records(recs) == [] == j_validate_records(recs)
    assert recs[0]["type"] == "meta" and recs[0]["schema"] == SCHEMA_VERSION
    spans = {r["name"]: r for r in recs if r["type"] == "span"}
    assert spans["eval"]["parent"] == spans["round"]["id"]
    assert spans["phase1-vote"]["clock"] == "sim"
    assert spans["round"]["clock"] == "host"


META = {"type": "meta", "schema": SCHEMA_VERSION, "run": {}}
SPAN = {"type": "span", "name": "x", "id": 0, "parent": None, "t0": 0.0,
        "t1": 1.0, "dur_s": 1.0, "clock": "host", "round": 1, "attrs": {}}


@pytest.mark.parametrize("records", [
    [], [SPAN], [{**META, "schema": 999}], [META, {**SPAN, "clock": "moon"}],
    [META, {**SPAN, "t1": -2.0, "dur_s": -2.0}],
    [META, {"type": "metric", "name": "a", "value": "NaNish",
            "kind": "gauge", "labels": {}}],
    [META, {"type": "wat"}]],
    ids=["empty", "no-meta", "schema", "clock", "negative", "value", "type"])
def test_validation_catches_drift(records):
    """Both packages' validators refuse the same drifted records, and pass
    the same good ones."""
    assert validate_records([META, SPAN]) == [] == j_validate_records(
        [META, SPAN])
    assert validate_records(records) == j_validate_records(records) != []


def test_chrome_trace_export(tmp_path):
    tr = Tracer()
    with tr.span("round", round=1):
        tr.sim_span("phase1-vote", 0.0, 0.5, round=1)
    ct = chrome_trace(tr.records)
    xs = [e for e in ct["traceEvents"] if e.get("ph") == "X"]
    assert {e["pid"] for e in xs} == {0, 1}           # host + sim tracks
    sim = next(e for e in xs if e["pid"] == 1)
    assert sim["dur"] == pytest.approx(0.5e6)         # microseconds
    json.dumps(ct)


# ---------------------------------------------------------------------------
# no perturbation: bitwise with and without recording
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_probe_bit_identity_all_mode_pairs(u_stack, vote_mode, compact_mode):
    """The packet round with a RecordingProbe attached (the maximal
    observer) is bitwise the unprobed round, and both are
    ``aggregate_stack``'s."""
    cfg = FediACConfig(vote_mode=vote_mode, compact_mode=compact_mode, a=2)
    key = key_to_torch(jax.random.PRNGKey(42))
    delta0, res0, _, _ = aggregate_stack(u_stack, cfg, key)
    r0 = PacketTransport("fediac", {"cfg": cfg}, net=NetConfig()).round(
        u_stack, None, key, 0)
    probed = PacketTransport("fediac", {"cfg": cfg}, net=NetConfig())
    with RecordingProbe(profiler=True) as probe:
        probed.attach_probe(probe)
        r1 = probed.round(u_stack, None, key, 0)
        m = r1.to_metrics()
    for a, b in ((delta0, r0.delta), (delta0, r1.delta), (res0, r0.residuals),
                 (res0, r1.residuals)):
        assert torch.equal(a, b)
    assert r0.stats.keys() == r1.stats.keys()
    assert m["consensus_k"] > 0 and 0.0 < m["vote_agreement_frac"] <= 1.0
    assert m["residual_norm"] >= 0.0 and m["n_up"] == 8.0
    assert probe.profiler.entries["packet_core[n=8]"].calls == 1


def test_probes_chaos_cell_bit_identical(small_fl):
    """A chaos cell: the default probe, an explicit NullProbe and a
    RecordingProbe all land on one history."""
    net = FaultConfig(loss=0.05, crash_rate=0.15, dup_rate=0.2,
                      ge_p_gb=0.05, participation=0.9, seed=4)
    cfg = _flcfg(transport="packet", net=net)
    h0 = _fl(small_fl, cfg)
    h_null = _fl(small_fl, cfg, probe=NullProbe())
    with RecordingProbe() as probe:
        h_rec = _fl(small_fl, cfg, probe=probe)
        n_metrics = sum(r["type"] == "metric" for r in probe.tracer.records)
    assert _hist_equal(h0, h_null) and _hist_equal(h0, h_rec)
    assert n_metrics > 0
    assert as_probe(None) is NULL_PROBE and not NULL_PROBE.enabled


def test_recorded_fl_trace_validates_and_reports(small_fl, tmp_path):
    """A recorded packet FL run: the reference's validator and the port's
    accept its trace, every round has its spans and metrics, the report
    renders, and the profiler's split reached the summary."""
    path = str(tmp_path / "run.jsonl")
    with RecordingProbe(path, profiler=True) as probe:
        _fl(small_fl, _flcfg(transport="packet", net=NetConfig()),
            probe=probe)
    recs = load_trace(path)
    assert validate_records(recs) == [] == j_validate_records(recs)
    rows = round_rows(recs)
    assert [r["round"] for r in rows] == [1, 2, 3]
    for r in rows:
        assert r["sim_s"] > 0 and "phase1-vote" in r["phases"]
        assert {"local-train", "aggregate", "eval"} <= set(r["phases"])
        assert r["metrics"]["upload_bytes"] > 0
        assert r["metrics"]["consensus_k"] > 0
    report = render_report(recs)
    assert "round" in report and "phase1-vote_s" in report
    assert "local_round" in report
    summary = recs[-1]
    prof = summary["metrics"]["__profile__"]
    assert summary["type"] == "summary"
    assert prof["local_round"]["calls"] == 3
    assert prof["packet_core[n=6]"]["calls"] == 3
    assert prof["local_round"]["device_s"] is None      # ran on the CPU


def test_kill_and_resume_trace_merges_seamlessly(small_fl, tmp_path):
    ck = str(tmp_path / "run.npz")
    trace = str(tmp_path / "run.jsonl")
    with RecordingProbe(trace) as probe:               # the "killed" run
        h_part = _fl(small_fl, _flcfg(rounds=2, ckpt_path=ck), probe=probe)
    with RecordingProbe(trace) as probe:               # resumed process
        h_res = _fl(small_fl, _flcfg(rounds=4, ckpt_path=ck, resume=True),
                    probe=probe)
    h_full = _fl(small_fl, _flcfg(rounds=4))
    assert _hist_equal(h_res, h_full)
    recs = load_trace(trace)
    assert validate_records(recs) == [] == j_validate_records(recs)
    metas = [r for r in recs if r["type"] == "meta"]
    assert len(metas) == 4                             # 2 attaches x 2 recs
    resumed = [m for m in metas
               if m.get("run", {}).get("resumed_from") is not None]
    assert resumed and resumed[0]["run"]["resumed_from"] == 2
    assert sorted(r["round"] for r in recs
                  if r["type"] == "span" and r["name"] == "round") \
        == [1, 2, 3, 4]
    ckpt_spans = [r for r in recs if r.get("name") == "ckpt"]
    assert len(ckpt_spans) == 4
    assert h_part.acc == h_full.acc[:2]


# ---------------------------------------------------------------------------
# stat carriers
# ---------------------------------------------------------------------------

def test_dataplane_merge_field_complete():
    flds = [f.name for f in dataclasses.fields(DataplaneStats)]
    a = DataplaneStats(**{f: 2 + i for i, f in enumerate(flds)})
    b = DataplaneStats(**{f: 30 + i for i, f in enumerate(flds)})
    m = a.merge(b)
    for f in flds:
        va, vb, vm = getattr(a, f), getattr(b, f), getattr(m, f)
        if f in DataplaneStats._MAX_FIELDS:
            assert vm == max(va, vb), f
        else:
            assert vm == va + vb, f
    assert DataplaneStats._MAX_FIELDS <= set(flds)


def test_dataplane_to_metrics_covers_every_field():
    names = [f.name for f in dataclasses.fields(DataplaneStats)]
    assert {"late_folds", "late_bounces", "stuffed_votes", "budget_rejected",
            "clipped_values", "trimmed_values"} <= set(names)
    st = DataplaneStats(**{name: i + 1 for i, name in enumerate(names)})
    m = st.to_metrics()
    assert m == {name: float(i + 1) for i, name in enumerate(names)}
    for name in names:
        if name != "peak_live_slots":
            assert metric_kind(name) == "counter", name


@pytest.mark.parametrize("net,fields,gauges", [
    (FaultConfig(loss=0.0), CHAOS_STAT_FIELDS, ()),
    (AsyncConfig(loss=0.0), ASYNC_STAT_FIELDS,
     ("buffer_occupancy", "carry_weight")),
    (AdversaryConfig(loss=0.0), ROBUST_STAT_FIELDS,
     ("byzantine", "quarantined"))], ids=["chaos", "async", "robust"])
def test_stat_fields_reach_transport_stats(u_stack, net, fields, gauges):
    r = PacketTransport("fediac", {"cfg": FediACConfig(a=2)}, net=net).round(
        u_stack, None, key_to_torch(jax.random.PRNGKey(0)), 0)
    m = r.to_metrics()
    for f in fields:
        assert f in r.stats and f in m, f
        assert metric_kind(f) != "gauge" or f in gauges, f


def test_flhistory_records_and_ckpt_roundtrip(tmp_path):
    h = FLHistory()
    h.append_round(acc=0.125, wall_clock=1.5, traffic_mb=0.5, loss=2.0)
    h.append_round(acc=0.25, wall_clock=3.25, traffic_mb=1.0, loss=1.0)
    assert h.records == [RoundRecord(0.125, 1.5, 0.5, 2.0),
                         RoundRecord(0.25, 3.25, 1.0, 1.0)]
    assert h.records[0].to_metrics()["acc"] == 0.125
    p = str(tmp_path / "h.npz")
    save_run_state(p, flat=torch.zeros(3), e_stack=torch.zeros(2, 3),
                   key=prng.PRNGKey(0, device="cpu"), agg_state=None,
                   round_idx=2, t_cum=3.25, mb_cum=1.0, history=h)
    assert FLHistory(**load_run_state(p)["history"]) == h


# ---------------------------------------------------------------------------
# profiling hooks
# ---------------------------------------------------------------------------

def test_torchprof_first_call_vs_steady_split():
    prof = TorchProfiler()
    calls = []

    def double(x):
        calls.append(1)
        return x * 2

    fn = prof.wrap(double, "double")
    x = torch.arange(4.0)
    assert torch.equal(fn(x), x * 2)
    fn(x + 1)
    fn(x + 2)
    e = prof.entries["double"]
    assert e.calls == 3 == len(calls)
    assert e.first_call_s > 0 and e.steady_s > 0
    snap = prof.snapshot()
    json.dumps(snap)
    assert snap["double"]["steady_calls"] == 2
    assert snap["double"]["device_s"] is None          # never on the card
    assert fn.__wrapped__ is double
    assert NullProbe().wrap_jit(double, "x") is double


def test_profiler_trace_writes_chrome_trace(tmp_path):
    with profiler_trace(str(tmp_path / "prof")) as pt:
        torch.ones(64).cumsum(0)
    assert pt.path is not None and os.path.exists(pt.path)
    with open(pt.path) as fh:
        assert "traceEvents" in json.load(fh)
    with profiler_trace(None) as off:
        pass
    assert off.path is None


def test_aggregate_round_probe_spans(u_stack):
    cfg = FediACConfig(a=2)
    key = key_to_torch(jax.random.PRNGKey(7))
    d0, r0, _, _ = aggregate_round(u_stack, cfg, key)
    for engine in ("monolithic", "async"):
        with RecordingProbe() as probe:
            d1, r1, _, _ = aggregate_round(
                u_stack, dataclasses.replace(cfg, engine=engine), key,
                probe=probe)
        names = [r["name"] for r in probe.tracer.records
                 if r["type"] == "span"]
        assert torch.equal(d0, d1) and torch.equal(r0, r1)
        assert f"engine-{engine}" in names


# ---------------------------------------------------------------------------
# the slice as a whole: the async packet FL run, probed, in both packages
# ---------------------------------------------------------------------------

#: async_throughput.py's high-straggler throughput cell at this file's size
ASYNC_NET = dict(seed=2, straggler_frac=0.5, straggler_slowdown=16.0,
                 quorum_frac=0.5, staleness_mode="poly", staleness_gamma=1.0)
HEAVY_CFG = dict(a=2, bits=32, capacity_frac=0.5)
SLICE = dict(n_clients=6, rounds=4, local_steps=2, batch=16,
             aggregator="fediac", local_train_s=0.01, transport="packet",
             seed=0)
#: metrics each round reports identically in both packages
EXACT_METRICS = ("upload_bytes", "broadcast_bytes", "wall_clock_s",
                 "n_active", "n_part", "phase1_bytes", "phase2_bytes",
                 "retransmissions", "stragglers", "passes",
                 "aggregation_ops", "phase1_s", "phase2_s") \
    + ASYNC_STAT_FIELDS[:3] + ("buffer_occupancy", "quorum_met")


@pytest.fixture(scope="module")
def async_slice(tmp_path_factory):
    """The async FL run in each package with a recording probe, and the
    port's without one."""
    tmp = tmp_path_factory.mktemp("slice")
    jdata = j_classification(n=1200, dim=16, n_classes=10, seed=0)
    jtrain, jtest = jdata.test_split(0.25)
    jclients = j_partition(jtrain, 6, beta=0.5, seed=0)
    jpath = str(tmp / "ref.jsonl")
    with JRecordingProbe(jpath) as probe:
        ref = j_run_federated(jclients, jtest, JFLConfig(
            **SLICE, agg_kwargs={"cfg": JCfg(**HEAVY_CFG)},
            net=JAsync(**ASYNC_NET)), hidden=HIDDEN, probe=probe)
    data = classification(n=1200, dim=16, n_classes=10, seed=0)
    train, test = data.test_split(0.25)
    clients = partition_dirichlet(train, 6, beta=0.5, seed=0)
    cfg = FLConfig(**SLICE, agg_kwargs={"cfg": FediACConfig(**HEAVY_CFG)},
                   net=AsyncConfig(**ASYNC_NET))
    path = str(tmp / "port.jsonl")
    with RecordingProbe(path, profiler=True) as probe:
        port = run_federated(clients, test, cfg, hidden=HIDDEN,
                             device="cpu", probe=probe)
    bare = run_federated(clients, test, cfg, hidden=HIDDEN, device="cpu")
    return (ref, load_trace(jpath)), (port, load_trace(path)), bare, \
        len(test.y)


def test_async_fl_slice_matches_reference(async_slice):
    """Traffic and the simulated clock exact, accuracy and loss within the
    FL loop's band (the local-SGD products differ by float32 rounding);
    the probe moved nothing; late updates were folded."""
    (ref, _), (port, precs), bare, n_test = async_slice
    assert _hist_equal(port, bare)
    assert port.traffic_mb == ref.traffic_mb
    assert port.wall_clock == ref.wall_clock
    np.testing.assert_allclose(port.acc, ref.acc, atol=2 / n_test)
    np.testing.assert_allclose(port.loss, ref.loss, rtol=1e-4)
    folded = [r["value"] for r in precs
              if r["type"] == "metric" and r["name"] == "late_folded"]
    assert len(folded) == 4 and sum(folded) > 0


def test_async_fl_traces_alike(async_slice):
    """Each package's validator accepts both traces; the two carry the
    same spans per round and the same metrics, the exact ones equal."""
    (_, jrecs), (_, precs), _, _ = async_slice
    for recs in (jrecs, precs):
        assert validate_records(recs) == [] == j_validate_records(recs)

    def per_round(recs):
        spans, metrics = {}, {}
        for r in recs:
            if r["type"] == "span":
                spans.setdefault(r["round"], []).append(r["name"])
            elif r["type"] == "metric":
                metrics.setdefault(r["round"], {})[r["name"]] = r["value"]
        return spans, metrics

    jspans, jmetrics = per_round(jrecs)
    pspans, pmetrics = per_round(precs)
    assert {t: sorted(s) for t, s in pspans.items()} \
        == {t: sorted(s) for t, s in jspans.items()}
    for t in range(1, 5):
        assert pmetrics[t].keys() == jmetrics[t].keys(), t
        for name in EXACT_METRICS:
            assert pmetrics[t][name] == jmetrics[t][name], (t, name)
