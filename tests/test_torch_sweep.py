"""The port's scenario sweep (``repro_torch.sweep``) against the
reference's ``repro.sweep``, and its fleet against its own sequential
``run_federated`` runs, on the CPU.

The fleet's contract is bitwise: every cell's history equals that cell's
sequential run in the port.  Against the reference the spec layer is exact
(cell keys, batch signatures, batchability, labels, validation) and the
histories hold the FL loop's band: traffic and simulated clock exact,
accuracy within two test samples, loss within 1e-4 (the local-SGD
matmuls differ by float32 rounding).
"""

from __future__ import annotations

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import repro.sweep as jsweep
import repro_torch.testing  # noqa: F401  (one torch thread per xdist worker)
from repro.sweep import grids as jgrids
from repro_torch.core import prng
from repro_torch.obs import RecordingProbe
from repro_torch.sweep import (GRIDS, ScenarioSpec, cell_key, get_grid,
                               run_cell_sequential, run_sweep, smoke_grid)
from repro_torch.sweep import fleet
from repro_torch.testing import key_to_torch
from repro_torch.training import fl_loop

CPU = "cpu"
TINY = dict(n_clients=4, rounds=3, local_steps=2, batch=8, hidden=(16,),
            data_n=500, data_dim=12, data_classes=5)


def _assert_same(h_seq, h_fleet, ctx=""):
    assert h_seq.acc == h_fleet.acc, f"{ctx}: acc"
    assert h_seq.loss == h_fleet.loss, f"{ctx}: loss"
    assert h_seq.wall_clock == h_fleet.wall_clock, f"{ctx}: wall_clock"
    assert h_seq.traffic_mb == h_fleet.traffic_mb, f"{ctx}: traffic_mb"


def _fleet_equals_sequential(specs, seeds=(0,), **kw):
    result = run_sweep(specs, seeds, device=CPU, **kw)
    assert len(result) == len(specs) * len(seeds)
    for cr in result:
        _assert_same(run_cell_sequential(cr.spec, cr.seed, device=CPU),
                     cr.history, cr.key)
    return result


# ---------------------------------------------------------------------------
# the per-cell bound: prng.randint and make_client_round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("minval", [0, -3])
def test_randint_tensor_bound_matches_traced_reference(minval):
    """A tensor ``maxval`` draws what ``jax.random.randint`` draws under
    ``jit(vmap)`` with a traced bound, and what the int path draws with
    each bound alone; a bound of rank 1 covers the key axes below it."""
    keys = jax.random.split(jax.random.PRNGKey(3), 12).reshape(6, 2, 2)
    bounds = np.array([1, 7, 100, 2**31 - 1, 0, -5], np.int32)
    want = jax.jit(jax.vmap(lambda kk, m: jax.vmap(
        lambda k: jax.random.randint(k, (257,), minval, m))(kk)))(keys,
                                                                 bounds)
    got = prng.randint(key_to_torch(keys), (257,), minval,
                       torch.from_numpy(bounds))
    assert got.dtype == torch.int32 and got.shape == (6, 2, 257)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(6):
        one = prng.randint(key_to_torch(keys[i]), (257,), minval,
                           int(bounds[i]))
        assert torch.equal(one, got[i])
    with pytest.raises(TypeError):
        prng.randint(key_to_torch(keys), (3,), 0, torch.ones(6))


def test_client_round_with_size_on_padded_stack_equals_unpadded():
    """Zero-padded rows with the client's own bound, per-client models,
    keys and float32 rates: the same bits as the plain call."""
    spec = ScenarioSpec(algorithm="fediac", a=2, **TINY)
    clients, _ = spec.make_task(0)
    cx, cy = fl_loop._stack_clients(clients, spec.batch,
                                    np.random.default_rng(0), CPU)
    n, size = cy.shape
    dims = (cx.shape[-1], *spec.hidden, clients[0].n_classes)
    flat = fl_loop.ravel(fl_loop.init_mlp(prng.PRNGKey(1, device=CPU), dims))
    key = prng.PRNGKey(5, device=CPU)
    lr = 0.0731
    client_round = fl_loop.make_client_round(dims, spec.batch,
                                             spec.local_steps)
    u, loss = client_round(flat, key, lr, cx, cy)
    pad = 9
    cx_p = torch.cat([cx, torch.zeros(n, pad, cx.shape[-1])], dim=1)
    cy_p = torch.cat([cy, torch.zeros(n, pad, dtype=cy.dtype)], dim=1)
    for got in (client_round(flat, key, lr, cx_p, cy_p, size=size),
                client_round(flat.expand(n, -1).clone(), prng.split(key, n),
                             torch.full((n,), lr, dtype=torch.float32),
                             cx_p, cy_p,
                             size=torch.full((n,), size, dtype=torch.int32))):
        assert torch.equal(got[0], u) and torch.equal(got[1], loss)


# ---------------------------------------------------------------------------
# the spec layer against the reference's, cell for cell
# ---------------------------------------------------------------------------

def test_grid_registry_matches_reference():
    assert sorted(GRIDS) == sorted(jgrids.GRIDS)
    assert set(jsweep.__all__) == set(__import__(
        "repro_torch.sweep", fromlist=["__all__"]).__all__)
    assert jgrids.BASELINE_OVERRIDES == __import__(
        "repro_torch.sweep.grids", fromlist=["x"]).BASELINE_OVERRIDES
    with pytest.raises(KeyError):
        get_grid("nope")


@pytest.mark.parametrize("name", sorted(jgrids.GRIDS))
def test_grid_cells_key_and_group_as_reference(name):
    """Every cell of every grid: the same fields, cell key (seeds 0 and 1),
    label, batchability, batch signature, and so the same fleet groups."""
    mine, ref = get_grid(name), jgrids.get_grid(name)
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        assert repr(sorted(m.__dict__.items())) == repr(
            sorted(r.__dict__.items()))
        for seed in (0, 1):
            assert cell_key(m, seed) == jsweep.cell_key(r, seed)
        assert m.label() == r.label()
        assert m.batchable() == r.batchable()
        assert repr(m.batch_signature()) == repr(r.batch_signature())
        assert m.dyn_scalars() == r.dyn_scalars()
        if m.algorithm == "fediac":
            mine_cfg = dataclasses.asdict(m.core_kwargs()["cfg"])
            ref_cfg = dataclasses.asdict(r.core_kwargs()["cfg"])
            assert mine_cfg == {k: ref_cfg[k] for k in mine_cfg}
        else:
            assert m.core_kwargs() == r.core_kwargs()
    groups = lambda cells: [[i for i, c in enumerate(cells)
                             if c.batch_signature() == s.batch_signature()]
                            for s in cells]
    assert groups(mine) == groups(ref)


_INVALID = [
    dict(k_frac=0.0), dict(capacity_frac=1.5), dict(a_frac=0.0), dict(a=0),
    dict(bits=0), dict(vote_mode="vote"), dict(compact_mode="x"),
    dict(n_clients=0), dict(rounds=0), dict(lr0=-0.1), dict(lr_tau=0.0),
    dict(beta=0.0), dict(test_frac=1.0), dict(dist="skew"),
    dict(switch="mid"), dict(local_train_s=-1.0), dict(transport="rdma"),
    dict(loss=1.0), dict(participation=0.0), dict(straggler_frac=1.5),
    dict(crash_rate=2.0), dict(reorder_jitter_s=-1.0), dict(backoff_s=-1.0),
    dict(quorum_floor=-1), dict(round_retries=-1), dict(consensus_floor=-1),
    dict(async_agg=True, chaos=True), dict(async_agg=True, adversary=True),
    dict(byzantine_frac=1.0), dict(byzantine_frac=0.1, collusion_frac=0.2),
    dict(vote_stuff_frac=1.5), dict(poison_scale=float("inf")),
    dict(vote_budget=-1), dict(clip_ticks=-1), dict(robust_agg="mean"),
    dict(trim_frac=0.5), dict(rep_decay=1.5), dict(rep_threshold=0.0),
    dict(rep_z_thresh=-1.0), dict(quarantine_rounds=-1),
    dict(staleness_mode="exp"), dict(late_policy="drop"),
    dict(quorum_frac=0.0), dict(round_deadline_s=0.0),
    dict(staleness_weight=0.0), dict(staleness_gamma=-1.0),
    dict(staleness_cap=float("nan")), dict(engine="nope"),
]


@pytest.mark.parametrize("kw", _INVALID, ids=lambda kw: ",".join(kw))
def test_invalid_specs_raise_as_reference(kw):
    with pytest.raises(Exception) as ref:
        jsweep.ScenarioSpec(**kw)
    with pytest.raises(type(ref.value)) as mine:
        ScenarioSpec(**kw)
    if "engine" not in kw:   # the registries list different engines
        assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the fleet against the sequential loop, bitwise
# ---------------------------------------------------------------------------

def test_fleet_bit_identical_fediac_dynamic_threshold():
    """Cells differing in vote threshold, data skew, learning rate and seed
    share one fleet; every cell equals its sequential run exactly."""
    specs = [ScenarioSpec(name="a2", algorithm="fediac", a=2, **TINY),
             ScenarioSpec(name="a3b5", algorithm="fediac", a=3, beta=5.0,
                          lr0=0.05, **TINY)]
    assert specs[0].batch_signature() == specs[1].batch_signature()
    _fleet_equals_sequential(specs, (0, 1))


@pytest.mark.parametrize("algo,overrides", [
    ("libra", (("k_frac", 0.02), ("hot_frac", 0.02))),
    ("omnireduce", (("k_frac", 0.05),)),
    ("topk", (("k_frac", 0.02),)),
])
def test_fleet_bit_identical_baselines(algo, overrides):
    """Stateful (libra's heat) and data-dependent-wire (omnireduce's
    blocks) baselines on the fleet, two lanes each."""
    spec = ScenarioSpec(name=algo, algorithm=algo, agg_overrides=overrides,
                        **TINY)
    _fleet_equals_sequential([spec], (0, 1))


def test_fleet_chunking_invariant():
    """max_fleet=1 (one-cell fleets) and one fleet of three agree
    exactly."""
    specs = [ScenarioSpec(name="a2", algorithm="fediac", a=2, **TINY)]
    big = run_sweep(specs, (0, 1, 2), max_fleet=8, device=CPU)
    small = run_sweep(specs, (0, 1, 2), max_fleet=1, device=CPU)
    for b, s in zip(big, small):
        assert b.key == s.key
        _assert_same(b.history, s.history, b.key)


def test_fleet_rejects_mixed_signatures():
    with pytest.raises(ValueError, match="batch signature"):
        fleet.run_fleet_cells(
            [(ScenarioSpec(algorithm="fediac", **TINY), 0),
             (ScenarioSpec(algorithm="switchml", **TINY), 0)], device=CPU)


def test_packet_fleet_bit_identical_mixed_network_conditions():
    """Lossless, lossy+partial and straggler packet cells — different vote
    thresholds and net seeds — ride one fleet, each equal to its
    sequential PacketTransport run."""
    specs = [ScenarioSpec(name="pk-clean", algorithm="fediac", a=2,
                          transport="packet", **TINY),
             ScenarioSpec(name="pk-lossy", algorithm="fediac", a=2,
                          transport="packet", loss=0.05, participation=0.5,
                          net_seed=3, **TINY),
             ScenarioSpec(name="pk-strag", algorithm="fediac", a=3,
                          transport="packet", straggler_frac=0.5,
                          net_seed=1, **TINY)]
    assert len({s.batch_signature() for s in specs}) == 1
    _fleet_equals_sequential(specs)


def test_packet_fleet_matches_memory_when_lossless():
    pkt = ScenarioSpec(name="pk", algorithm="fediac", a=2,
                       transport="packet", **TINY)
    mem = ScenarioSpec(name="mem", algorithm="fediac", a=2, **TINY)
    res = run_sweep([pkt, mem], (0,), device=CPU)
    h = {c.spec.name: c.history for c in res}
    assert h["pk"].acc == h["mem"].acc
    assert h["pk"].traffic_mb == h["mem"].traffic_mb


def test_async_fleet_bit_identical_quorum_grid():
    """Async cells of one structure (quorum, staleness and network knobs
    per cell) on one fleet, each with its own late-update carry."""
    base = dict(algorithm="fediac", transport="packet", async_agg=True,
                staleness_mode="poly", **TINY)
    specs = [ScenarioSpec(name="aq-half", a=2, quorum_frac=0.5,
                          straggler_frac=0.5, net_seed=3, **base),
             ScenarioSpec(name="aq-most", a=3, quorum_frac=0.75,
                          staleness_gamma=2.0, loss=0.05,
                          participation=0.75, net_seed=1, **base)]
    assert len({s.batch_signature() for s in specs}) == 1
    assert all(s.batchable() for s in specs)
    _fleet_equals_sequential(specs)


def test_chaos_fleet_bit_identical_with_probe():
    """A clean and a storm chaos cell on one fleet; a RecordingProbe sees
    the fleet's rounds and each cell's metrics and moves no bit."""
    base = dict(algorithm="fediac", a=2, transport="packet", chaos=True,
                **TINY)
    specs = [ScenarioSpec(name="chaos-clean", **base),
             ScenarioSpec(name="chaos-storm", ge_p_gb=0.05, ge_p_bg=0.4,
                          ge_loss_bad=0.8, crash_rate=0.1, dup_rate=0.1,
                          reorder_jitter_s=0.002, **base)]
    bare = _fleet_equals_sequential(specs)
    probe = RecordingProbe()
    probed = run_sweep(specs, (0,), device=CPU, probe=probe)
    for a, b in zip(bare, probed):
        _assert_same(a.history, b.history, a.key)
    recs = probe.tracer.records
    assert [r["round"] for r in recs if r.get("name") == "fleet-round"] \
        == [1, 2, 3]
    cells = {r["labels"]["cell"] for r in recs
             if r.get("type") == "metric" and r.get("labels")}
    assert cells == {"chaos-clean", "chaos-storm"}


def test_resume_skips_finished_cells(tmp_path):
    progress = str(tmp_path / "sweep_progress.npz")
    a2 = ScenarioSpec(name="a2", algorithm="fediac", a=2, **TINY)
    a3 = ScenarioSpec(name="a3", algorithm="fediac", a=3, **TINY)
    first = run_sweep([a2], (0,), progress_path=progress, device=CPU)
    assert not first.cells[0].resumed
    again = run_sweep([a2], (0,), progress_path=progress, device=CPU)
    assert again.cells[0].resumed
    _assert_same(first.cells[0].history, again.cells[0].history, "resume")
    grown = run_sweep([a2, a3], (0,), progress_path=progress, device=CPU)
    by_key = grown.by_key()
    assert by_key[cell_key(a2, 0)].resumed
    assert not by_key[cell_key(a3, 0)].resumed
    _assert_same(run_cell_sequential(a3, 0, device=CPU),
                 by_key[cell_key(a3, 0)].history, "grown")


def test_forced_sequential_and_fallback_cells():
    """``sequential=True`` runs packet cells through run_federated and the
    fleet reproduces it; a packet baseline and a stream-engine packet
    cell take the sequential path by themselves."""
    spec = ScenarioSpec(name="pkt", algorithm="fediac", a=2,
                        transport="packet", loss=0.02, **TINY)
    res = run_sweep([spec], (0,), device=CPU)
    seq = run_sweep([spec], (0,), device=CPU, sequential=True)
    _assert_same(seq.cells[0].history, res.cells[0].history, "packet")
    fallback = [ScenarioSpec(name="pk-sw", algorithm="switchml",
                             transport="packet", **TINY),
                ScenarioSpec(name="pk-stream", algorithm="fediac", a=2,
                             transport="packet", engine="stream", **TINY)]
    assert not any(s.batchable() for s in fallback)
    _fleet_equals_sequential(fallback)


def test_smoke_grid_fleet_equals_sequential():
    """The smoke grid (two fleet groups) cut to 2 rounds."""
    grid = [dataclasses.replace(s, rounds=2) for s in smoke_grid()]
    assert all(s.batchable() for s in grid)
    assert len({s.batch_signature() for s in grid}) == 2
    fleet_res = run_sweep(grid, (0,), device=CPU)
    seq = run_sweep(grid, (0,), device=CPU, sequential=True)
    for a, b in zip(fleet_res, seq):
        _assert_same(b.history, a.history, a.key)


# ---------------------------------------------------------------------------
# the port's sweep against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def against_reference():
    """One memory pair (one fleet) and one lossy packet cell through both
    packages' ``run_sweep``; the test set's size."""
    specs = [dict(name="a2", algorithm="fediac", a=2, **TINY),
             dict(name="a3", algorithm="fediac", a=3, beta=5.0, **TINY),
             dict(name="pk", algorithm="fediac", a=2, transport="packet",
                  loss=0.05, participation=0.5, net_seed=3, **TINY)]
    ref = jsweep.run_sweep([jsweep.ScenarioSpec(**s) for s in specs], (0,))
    mine = run_sweep([ScenarioSpec(**s) for s in specs], (0,), device=CPU)
    _, test = mine.cells[0].spec.make_task(0)
    return list(zip(ref, mine)), len(test.y)


@pytest.mark.parametrize("i", [0, 1, 2], ids=["a2", "a3", "packet"])
def test_sweep_matches_reference(against_reference, i):
    pairs, n_test = against_reference
    r, m = pairs[i]
    assert r.key == m.key
    assert m.history.traffic_mb == r.history.traffic_mb
    assert m.history.wall_clock == r.history.wall_clock
    np.testing.assert_allclose(m.history.acc, r.history.acc,
                               atol=2 / n_test)
    np.testing.assert_allclose(m.history.loss, r.history.loss, rtol=1e-4)


def test_sweep_keys_flat_and_cells_ordered():
    spec = ScenarioSpec(name="x/y", algorithm="fediac", a=2, **TINY)
    k = cell_key(spec, 7)
    assert k == cell_key(spec, 7) and "/" not in k
    assert k != cell_key(spec, 8)
    assert re.fullmatch(r"x_y\.s7\.[0-9a-f]{10}", k)
