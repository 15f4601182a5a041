"""The port's chaos dataplane (``netsim/faults.py``) against the reference.

Every fault family's packet round through ``PacketTransport`` is held
bitwise against the reference's (which runs the core under ``jax.jit``):
delta, residuals, vote counts, masks, every integer statistic, the clock
and the upload bytes, the mean wait within 1e-6 relative.  Then a
counterpart of each test of ``tests/test_faults.py`` that reaches the chaos
core, the transport or the FL loop (its fleet test waits for the sweep;
the register-bank and run-state tests have theirs in
``test_torch_switch.py`` and ``test_torch_ckpt.py``), the dedup contract
over fixed examples, the rescale close's ``exp2`` pin, and the chaos core
on the stream and sharded engines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import round_plan as jplan
from repro.core.fediac import FediACConfig as JCfg
from repro.core.fediac import aggregate_stack as j_aggregate_stack
from repro.netsim import FaultConfig as JFault
from repro.netsim import PacketTransport as JPT
from repro.netsim import chaos_packet_dyn as j_chaos_dyn
from repro.netsim import make_chaos_packet_core as j_chaos_core
from repro.netsim import policies as jpol
from repro.netsim.faults import _ge_loss_probability as j_ge
from repro_torch.core import prng
from repro_torch.core.engines import EngineSpec
from repro_torch.core.fediac import FediACConfig, aggregate_stack
from repro_torch.core.round_plan import consensus_floor_threshold
from repro_torch.data import classification, partition_dirichlet
from repro_torch.netsim import (FaultConfig, NetConfig, PacketTransport,
                                chaos_packet_dyn, gilbert_elliott_stationary,
                                make_chaos_packet_core, register_accumulate)
from repro_torch.netsim.batched import make_fediac_packet_core, packet_dyn
from repro_torch.netsim.faults import _ge_loss_probability, _rescale_to_float
from repro_torch.testing import key_to_torch
from repro_torch.training import fl_loop

#: the mean wait sums float32 waits in another order than XLA's reduce
WAIT_RTOL = 1e-6
N, D = 8, 600


def _bits(x):
    a = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref):
    np.testing.assert_array_equal(_bits(port), _bits(ref))


def _same_round(port, ref):
    """A port round against the reference's: every output bitwise but the
    mean wait."""
    _same(port.delta, ref.delta)
    _same(port.residuals, ref.residuals)
    assert port.stats.keys() == ref.stats.keys()
    for k, v in ref.stats.items():
        if k == "mean_wait_s":
            np.testing.assert_allclose(port.stats[k], v, rtol=WAIT_RTOL)
        else:
            np.testing.assert_array_equal(port.stats[k], v, err_msg=k)
    assert port.wall_clock_s == ref.wall_clock_s
    assert port.upload_bytes == ref.upload_bytes
    assert port.n_active == ref.n_active
    assert vars(port.traffic) == vars(ref.traffic)
    assert vars(port.load) == vars(ref.load)


@pytest.fixture(scope="module")
def u_stack():
    u = jax.random.normal(jax.random.PRNGKey(1), (8, 2048)) ** 3
    return u, torch.from_numpy(np.array(u))


def _transports(net_kw, *, cfg_kw=None, kernels=False):
    """The reference's and the port's FediAC packet transports under the
    same FaultConfig."""
    cfg_kw = dict(a=2, **(cfg_kw or {}))
    ref = JPT("fediac", {"cfg": JCfg(use_pallas=kernels, **cfg_kw)},
              net=JFault(**net_kw))
    port = PacketTransport(
        "fediac", {"cfg": FediACConfig(engine=EngineSpec(use_pallas=kernels),
                                       **cfg_kw)}, net=FaultConfig(**net_kw))
    return port, ref


def _rounds(u_stack, net_kw, *, key=0, rnd=0, **kw):
    """One packet round of each package on the same inputs."""
    port, ref = _transports(net_kw, **kw)
    k = jax.random.PRNGKey(key)
    return (port.round(u_stack[1], None, key_to_torch(k), rnd),
            ref.round(u_stack[0], None, k, rnd))


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"straggler_slowdown": 0.5}, {"straggler_slowdown": float("inf")},
    {"straggler_slowdown": float("nan")},
    {"vote_deadline_s": 0.0}, {"vote_deadline_s": -1.0},
    {"vote_deadline_s": float("inf")},
    {"rto_s": 0.0}, {"rto_s": -0.05}, {"rto_s": float("nan")},
    {"max_retries": 0}, {"max_retries": -3},
])
def test_netconfig_rejects_bad_timing(kw):
    for cls in (NetConfig, FaultConfig):
        with pytest.raises(ValueError):
            cls(**kw)


def test_netconfig_accepts_boundary_values():
    NetConfig(straggler_slowdown=1.0, vote_deadline_s=1e-6, max_retries=1)
    NetConfig(vote_deadline_s=None)
    FaultConfig(crash_rate=1.0, dup_rate=1.0, ge_p_gb=1.0, ge_p_bg=1.0)


@pytest.mark.parametrize("kw", [
    {"crash_rate": 1.5}, {"dup_rate": -0.1}, {"ge_loss_bad": 2.0},
    {"ge_p_gb": 0.1, "ge_p_bg": 0.0},
    {"reorder_jitter_s": -1.0}, {"reorder_jitter_s": float("inf")},
    {"register_policy": "clamp"}, {"quorum_floor": -1},
    {"round_retries": -1}, {"backoff_s": float("nan")},
    {"rto_s": 0.0},
])
def test_faultconfig_rejects_bad_knobs(kw):
    with pytest.raises(ValueError):
        JFault(**kw)            # the reference refuses it too
    with pytest.raises(ValueError):
        FaultConfig(**kw)


def test_retry_policy_delays_bitwise():
    net = FaultConfig(backoff_s=0.3, round_retries=4)
    got = net.retry_policy().delays(5, device="cpu")
    want = JFault(backoff_s=0.3, round_retries=4).retry_policy().delays(5)
    _same(got, want)


# ---------------------------------------------------------------------------
# consensus floor: the dense-mask fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a,floor,want", [(3, 4, 1), (2, 3, 2), (3, 1, 3)])
def test_consensus_floor_threshold_values(a, floor, want):
    counts = np.asarray([5, 2, 2, 1, 0], np.int32)
    got = int(consensus_floor_threshold(torch.from_numpy(counts), a, floor))
    assert got == want == int(jplan.consensus_floor_threshold(
        jnp.asarray(counts), a, floor))


def test_consensus_floor_dense_fallback_in_aggregate():
    u = jax.random.normal(jax.random.PRNGKey(0), (6, 512)) ** 3
    key = jax.random.PRNGKey(1)
    ut, kt = torch.from_numpy(np.array(u)), key_to_torch(key)
    outs = {}
    for floor in (None, 0, 256):
        kw = {} if floor is None else {"consensus_floor": floor}
        got = aggregate_stack(ut, FediACConfig(a=6, **kw), kt)
        want = j_aggregate_stack(u, JCfg(a=6, **kw), key)
        for g, w in zip(got[:3], want[:3]):
            _same(g, w)
        outs[floor] = got[0]
    _same(outs[None], outs[0])
    assert int((outs[256] != 0).sum()) > int((outs[None] != 0).sum())


# ---------------------------------------------------------------------------
# each fault family against the reference
# ---------------------------------------------------------------------------

STORM = dict(ge_p_gb=0.05, ge_p_bg=0.4, ge_loss_bad=0.8, crash_rate=0.1,
             dup_rate=0.1, reorder_jitter_s=0.002)
FAULTS = {
    "ge": dict(loss=0.05, ge_p_gb=0.05, ge_p_bg=0.4, ge_loss_bad=0.8,
               seed=3),
    "crash": dict(crash_rate=0.3, crash_p2_frac=0.5, seed=4),
    "dup": dict(dup_rate=0.5, seed=5, n_leaves=2),
    "jitter": dict(reorder_jitter_s=0.002, loss=0.1, seed=6),
    "reset": dict(reg_reset_rate=0.5, memory_slots=16, seed=7),
    "no-dedup": dict(dup_rate=0.9, dedup=False, seed=6),
    # the chip check's storm: the chaos grid's burst-crash rates, a quorum
    # floor and the rescale close, on two leaves and a small bank
    "storm": dict(STORM, quorum_floor=6, register_policy="rescale",
                  loss=0.05, participation=0.9, n_leaves=2, memory_slots=64,
                  seed=9),
    "saturate": dict(STORM, register_policy="saturate", seed=2),
    # a floor no attempt can reach: every retry spent, the round aborted
    "abort": dict(quorum_floor=9, round_retries=2, backoff_s=0.2, seed=1),
    # a floor the first attempt misses and a retry reaches (attempt 2)
    "retry": dict(quorum_floor=6, round_retries=3, crash_rate=0.3,
                  crash_p2_frac=0.0, seed=2),
}


@pytest.mark.parametrize("name,kernels,vote_chunk", [
    (name, False, 1) for name in FAULTS] + [
    ("storm", True, 1), ("storm", True, 4)])
def test_fault_round_bitwise(u_stack, name, kernels, vote_chunk):
    """Each fault family's round is the reference's, bit for bit, with the
    kernels off and on (their plain versions here: B1 at vote_chunk 1, B2
    at 4)."""
    tp_port, tp_ref = _transports(FAULTS[name], kernels=kernels,
                                  cfg_kw={"vote_chunk": vote_chunk})
    for rnd in (0, 3):
        k = jax.random.PRNGKey(rnd + 11)
        port = tp_port.round(u_stack[1], None, key_to_torch(k), rnd)
        _same_round(port, tp_ref.round(u_stack[0], None, k, rnd))
    if name == "retry":
        assert port.stats["attempts"] == 2 and port.stats["aborted"] == 0
    if name in ("dup", "reset", "no-dedup"):
        assert port.stats["duplicates"] > 0
    if name == "crash":
        assert port.stats["crashed"] > 0


# ---------------------------------------------------------------------------
# the zero-fault invariant: chaos core == plain core, bitwise
# ---------------------------------------------------------------------------

def _probe_inputs():
    rng = np.random.default_rng(1)
    u = rng.standard_normal((N, D)).astype(np.float32)
    return torch.from_numpy(u), torch.full((N,), 12.5e6)


@pytest.mark.parametrize("policy", ["wrap", "saturate", "rescale"])
def test_chaos_core_faultfree_bit_identical_to_plain(policy):
    """With every fault knob at zero the chaos core returns the plain
    core's delta, residuals and every aux entry bitwise — under loss,
    partial participation, stragglers and a deadline — for all three
    register policies."""
    cfg = FediACConfig(bits=12, a=3, alpha=0.1)
    netkw = dict(loss=0.15, participation=0.8, straggler_frac=0.25,
                 vote_deadline_s=1.5, seed=3)
    plain_net = NetConfig(**netkw)
    fault_net = FaultConfig(**netkw, register_policy=policy)
    pcore = make_fediac_packet_core(cfg, plain_net, N)
    ccore = make_chaos_packet_core(cfg, fault_net, N)
    pd = packet_dyn(cfg, plain_net, N, 1.0, 1e-5, device="cpu")
    cd = chaos_packet_dyn(cfg, fault_net, N, 1.0, 1e-5, device="cpu")
    u, rates = _probe_inputs()
    nk = prng.PRNGKey(plain_net.seed, device="cpu")
    for t in range(2):
        key = prng.fold_in(prng.PRNGKey(9, device="cpu"), t)
        d1, r1, a1 = pcore(u, key, nk, t, rates, pd)
        d2, r2, a2 = ccore(u, key, nk, t, rates, cd)
        _same(d1, d2)
        _same(r1, r2)
        for k in a1:
            np.testing.assert_array_equal(_bits(torch.as_tensor(a1[k])),
                                          _bits(torch.as_tensor(a2[k])),
                                          err_msg=k)
        u = u * 0.9 + d1[None, :] + r1


def test_chaos_transport_faultfree_matches_plain(u_stack):
    """A zero-rate FaultConfig rides the chaos core yet reproduces the
    plain round, and reports the chaos stats (all zero) as the
    reference's transport does."""
    cfg = FediACConfig(a=2)
    key = key_to_torch(jax.random.PRNGKey(0))
    netkw = dict(loss=0.1, participation=0.75, seed=2)
    rp = PacketTransport("fediac", {"cfg": cfg}, net=NetConfig(**netkw)
                         ).round(u_stack[1], None, key, 1)
    port, ref = _rounds(u_stack, netkw, key=0, rnd=1)
    _same_round(port, ref)
    _same(rp.delta, port.delta)
    _same(rp.residuals, port.residuals)
    assert rp.wall_clock_s == port.wall_clock_s
    assert rp.upload_bytes == port.upload_bytes
    for k in ("crashed", "duplicates", "resets", "overflow_slots", "aborted"):
        assert port.stats[k] == 0, k
    assert port.stats["attempts"] == 1


# ---------------------------------------------------------------------------
# fault models and degradation policies
# ---------------------------------------------------------------------------

#: the reference property test's examples (rate, round): its failing one,
#: the ends of its ranges and points between
DUP_EXAMPLES = [(0.25, 9), (0.1, 0), (0.9, 40), (0.5, 17), (0.33, 3),
                (0.75, 28)]


@pytest.fixture(scope="module")
def dup_harness():
    """The reference's duplicate-delivery harness in both packages: one
    jitted reference core (dup_rate is a dyn scalar, so every example
    reuses it) and the port's core on the same inputs."""
    netkw = dict(loss=0.05, participation=0.9, seed=5)
    jcore = jax.jit(j_chaos_core(JCfg(a=3), JFault(**netkw), N))
    jdyn = j_chaos_dyn(JCfg(a=3), JFault(**netkw), N, 1.0, 1e-5)
    cfg, net = FediACConfig(a=3), FaultConfig(**netkw)
    tcore = make_chaos_packet_core(cfg, net, N)
    tdyn = chaos_packet_dyn(cfg, net, N, 1.0, 1e-5, device="cpu")
    u, rates = _probe_inputs()
    return jcore, jdyn, tcore, tdyn, u, rates


@pytest.mark.parametrize("rate,round_idx", DUP_EXAMPLES)
def test_duplicate_delivery_idempotent(dup_harness, rate, round_idx):
    """ACK-loss dedup: under sequence-number suppression the committed
    aggregate, residuals and vote counts are bitwise invariant to the
    duplication rate; only the time and byte accounting moves.  The
    duplicate count is the reference's (which may be 0 for one example)."""
    jcore, jdyn, tcore, tdyn, u, rates = dup_harness
    key, nk = prng.PRNGKey(7, device="cpu"), prng.PRNGKey(5, device="cpu")
    d0, r0, a0 = tcore(u, key, nk, round_idx, rates, tdyn)
    dyn = dict(tdyn, dup_rate=torch.tensor(rate, dtype=torch.float32))
    d1, r1, a1 = tcore(u, key, nk, round_idx, rates, dyn)
    _same(d0, d1)
    _same(r0, r1)
    _same(a0["counts"], a1["counts"])
    assert int(a1["retransmissions"]) >= int(a0["retransmissions"])
    _, _, ref = jcore(jnp.asarray(u.numpy()), jax.random.PRNGKey(7),
                      jax.random.PRNGKey(5), round_idx,
                      jnp.asarray(rates.numpy()),
                      dict(jdyn, dup_rate=jnp.float32(rate)))
    assert int(a1["duplicates"]) == int(ref["duplicates"])
    assert int(a1["retransmissions"]) == int(ref["retransmissions"])


def test_duplicates_over_the_examples(dup_harness):
    """Taken together the examples do duplicate packets (the reference's
    per-example ``duplicates > 0`` is chance: at rate 0.25, round 9, its
    six single-packet uploaders draw none)."""
    _, _, tcore, tdyn, u, rates = dup_harness
    key, nk = prng.PRNGKey(7, device="cpu"), prng.PRNGKey(5, device="cpu")
    dups = []
    for rate, round_idx in DUP_EXAMPLES:
        dyn = dict(tdyn, dup_rate=torch.tensor(rate, dtype=torch.float32))
        dups.append(int(tcore(u, key, nk, round_idx, rates, dyn)[2]
                        ["duplicates"]))
    assert dups[0] == 0 and sum(dups) > 0


def test_no_dedup_admits_double_counts(u_stack):
    """Without duplicate suppression a duplicated packet's slots deposit
    twice — the corruption the sequence-number policy exists to stop."""
    netkw = dict(dup_rate=0.9, seed=6)
    r_dd = PacketTransport("fediac", {"cfg": FediACConfig(a=2)},
                           net=FaultConfig(dedup=True, **netkw)).round(
        u_stack[1], None, key_to_torch(jax.random.PRNGKey(0)), 0)
    r_nd, ref = _rounds(u_stack, dict(netkw, dedup=False))
    _same_round(r_nd, ref)
    assert r_nd.stats["duplicates"] > 0
    assert not torch.equal(r_dd.delta, r_nd.delta)


@pytest.mark.parametrize("p_gb,p_bg", [(0.02, 0.1), (0.15, 0.35),
                                       (0.3, 0.6)])
def test_ge_marginal_matches_stationary(p_gb, p_bg):
    """The chain's states are the reference's scan's, bit for bit, and
    past burn-in the bad-state occupancy matches the stationary
    p_gb / (p_gb + p_bg)."""
    n_pkts = 4000
    key = jax.random.PRNGKey(11)
    got = _ge_loss_probability(key_to_torch(key), (16, n_pkts), 0.05, p_gb,
                               p_bg, 0.9).numpy()
    want = np.asarray(jax.jit(j_ge, static_argnums=1)(
        key, (16, n_pkts), 0.05, p_gb, p_bg, 0.9))
    _same(got, want)
    bad = got == np.float32(0.9)
    pi = gilbert_elliott_stationary(p_gb, p_bg)
    assert abs(bad[:, n_pkts // 4:].mean() - pi) < 0.04


def test_ge_zero_rate_is_iid_loss():
    probs = _ge_loss_probability(prng.PRNGKey(2, device="cpu"), (8, 100),
                                 0.07, 0.0, 0.5, 1.0).numpy()
    assert np.all(probs == np.float32(0.07))
    assert gilbert_elliott_stationary(0.0, 0.5) == 0.0
    assert gilbert_elliott_stationary(0.1, 0.3) == pytest.approx(0.25)


def test_crash_all_phase2_commits_nothing(u_stack):
    """All-or-nothing commit: every client crashing mid-upload leaves a
    zero delta and full residual carry-over; the wall clock is phase 2's
    start."""
    port, ref = _rounds(u_stack, dict(crash_rate=1.0, crash_p2_frac=1.0,
                                      seed=0))
    _same_round(port, ref)
    assert port.n_active == 0
    assert bool((port.delta == 0.0).all())
    _same(port.residuals, u_stack[1])
    assert port.stats["crashed"] == 8


def test_quorum_abort_and_retry_backoff(u_stack):
    """Quorum-or-abort: an unreachable floor exhausts every retry and
    aborts (zero delta, time still spent, more attempts burn more
    clock); a reachable floor closes on the first attempt."""
    r, ref = _rounds(u_stack, dict(quorum_floor=9, round_retries=2,
                                   backoff_s=0.2, seed=1))
    _same_round(r, ref)
    assert r.stats["aborted"] == 1 and r.stats["attempts"] == 3
    assert bool((r.delta == 0.0).all())
    _same(r.residuals, u_stack[1])
    r0, ref0 = _rounds(u_stack, dict(quorum_floor=9, round_retries=0,
                                     backoff_s=0.2, seed=1))
    _same_round(r0, ref0)
    assert r0.stats["attempts"] == 1
    assert r.wall_clock_s > r0.wall_clock_s
    ok = PacketTransport("fediac", {"cfg": FediACConfig(a=2)},
                         net=FaultConfig(seed=1, quorum_floor=1)).round(
        u_stack[1], None, key_to_torch(jax.random.PRNGKey(0)), 0)
    assert ok.stats["aborted"] == 0 and ok.stats["attempts"] == 1
    assert ok.n_active >= 1


def test_rescale_exp2_pin():
    """The rescale close's float decode at window shifts 0..12 is the
    reference's ``summed * exp2(shift)`` under jit, bit for bit: 4,096
    rows (shift bound 13), one window per slot, slot s built to need
    exactly shift s."""
    n, shifts = 4096, np.arange(13)
    rng = np.random.default_rng(3)
    base = np.where(shifts == 0, 1, 2.0 ** (shifts + 18)).astype(np.int64)
    rows = (base[None, :] + rng.integers(0, 64, (n, shifts.size))
            ).astype(np.int32)
    win = np.arange(shifts.size, dtype=np.int32)

    def ref(r):
        s, _, sh = jpol.register_accumulate(r, policy="rescale",
                                            slot_window=win,
                                            n_windows=shifts.size)
        return s.astype(jnp.float32) * jnp.exp2(sh.astype(jnp.float32)), sh

    want, want_sh = jax.jit(ref)(jnp.asarray(rows))
    s, _, sh = register_accumulate(torch.from_numpy(rows), policy="rescale",
                                   slot_window=win, n_windows=shifts.size)
    np.testing.assert_array_equal(sh.numpy(), shifts)
    np.testing.assert_array_equal(np.asarray(want_sh), shifts)
    _same(_rescale_to_float(s, sh), want)


# ---------------------------------------------------------------------------
# the chaos core on the stream and sharded engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vote_mode,compact_mode", [("topk", "topk"),
                                                    ("threshold", "block")])
@pytest.mark.parametrize("spec", [EngineSpec("stream", chunk=300),
                                  EngineSpec("stream", chunk=1024,
                                             use_pallas=True),
                                  EngineSpec("sharded", devices=3)],
                         ids=["stream", "stream-kernels", "sharded"])
def test_chaos_engines_bitwise(u_stack, vote_mode, compact_mode, spec):
    """The storm round on the stream and sharded phase 2 is bitwise the
    monolithic chaos round (same kernels setting)."""
    cfg_kw = dict(vote_mode=vote_mode, compact_mode=compact_mode, a=2)
    net = FaultConfig(**FAULTS["storm"])
    key = key_to_torch(jax.random.PRNGKey(3))
    got, want = (PacketTransport(
        "fediac", {"cfg": FediACConfig(engine=s, **cfg_kw)}, net=net).round(
        u_stack[1], None, key, 4)
        for s in (spec, EngineSpec(use_pallas=spec.use_pallas)))
    _same(got.delta, want.delta)
    _same(got.residuals, want.residuals)
    assert got.stats.keys() == want.stats.keys()
    for k, v in got.stats.items():
        np.testing.assert_array_equal(v, want.stats[k])
    assert got.wall_clock_s == want.wall_clock_s


# ---------------------------------------------------------------------------
# the FL loop on the chaos transport
# ---------------------------------------------------------------------------

HIDDEN = (32, 16)


@pytest.fixture(scope="module")
def small_fl():
    data = classification(n=1500, dim=16, n_classes=10, seed=0)
    train, test = data.test_split(0.25)
    return partition_dirichlet(train, 6, beta=0.5, seed=0), test


def _fl(small_fl, rounds, net, **kw):
    clients, test = small_fl
    cfg = fl_loop.FLConfig(n_clients=6, rounds=rounds, local_steps=2,
                           aggregator="fediac",
                           agg_kwargs={"cfg": FediACConfig(a=2, bits=12)},
                           seed=0, transport="packet", net=net, **kw)
    return fl_loop.run_federated(clients, test, cfg, hidden=HIDDEN,
                                 device="cpu")


def test_fl_chaos_faultfree_matches_plain_packet(small_fl):
    """A fault-free chaos run's history is the plain packet run's."""
    h_plain = _fl(small_fl, 3, NetConfig(loss=0.02, seed=1))
    h_chaos = _fl(small_fl, 3, FaultConfig(loss=0.02, seed=1))
    assert h_plain == h_chaos
    assert h_plain.wall_clock == h_chaos.wall_clock
    assert h_plain.traffic_mb == h_chaos.traffic_mb


def test_resume_under_chaos_bit_identical(small_fl, tmp_path):
    """Fault draws are a pure function of (seed, round), so a chaotic run
    killed after round 2 and resumed replays the same faults and lands on
    the uninterrupted history exactly."""
    net = FaultConfig(loss=0.05, crash_rate=0.15, dup_rate=0.2, ge_p_gb=0.05,
                      participation=0.9, seed=4)
    full = _fl(small_fl, 4, net)
    ck = str(tmp_path / "chaos.npz")
    _fl(small_fl, 2, net, ckpt_path=ck)
    resumed = _fl(small_fl, 4, net, ckpt_path=ck, resume=True)
    assert resumed == full
    assert resumed.wall_clock == full.wall_clock
    assert resumed.traffic_mb == full.traffic_mb
