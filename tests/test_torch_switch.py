"""The switch side of the port's packet dataplane against the reference:
the programmable-switch simulator (``switch/psim.py``), the register bank
(``netsim/dataplane.py``), the register-bank overflow policies, the
retry/backoff policy and ``NetConfig``'s validation."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim import dataplane as jdp
from repro.netsim import policies as jpol
from repro.switch import psim as jpsim
from repro_torch.netsim import (DataplaneStats, NetConfig, SwitchDataplane,
                                register_accumulate)
from repro_torch.netsim.policies import INT32_MAX, INT32_MIN, BackoffPolicy
from repro_torch.netsim.timeline import retransmit_delays
from repro_torch.switch import ProgrammableSwitch, PSStats
from repro_torch.testing import key_to_torch

NAN = float("nan")


def _bits(x):
    a = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# psim: aligned and sparse aggregation, as the reference counts them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots,shape", [(8, (4, 20)), (64, (2, 64)),
                                         (7, (5, 3))])
def test_aligned_matches_reference(slots, shape):
    streams = np.arange(np.prod(shape), dtype=np.int64).reshape(shape) - 9
    out, stats = ProgrammableSwitch(slots).aggregate_aligned(streams)
    want, wstats = jpsim.ProgrammableSwitch(slots).aggregate_aligned(streams)
    np.testing.assert_array_equal(out, want)
    assert vars(stats) == vars(wstats)
    assert stats.aggregation_ops == (shape[0] - 1) * shape[1]
    assert stats.passes == -(-shape[1] // slots)


def test_integer_only_enforced():
    ps = ProgrammableSwitch()
    with pytest.raises(TypeError):
        ps.aggregate_aligned(np.ones((2, 8), np.float32))
    with pytest.raises(TypeError):
        ps.aggregate_sparse([np.array([0, 1])], [np.array([0.5, 1.5])], d=4)


def _sparse_sequential(indices, values, d, memory_slots):
    """The per-value slot-map loop, the accounting oracle."""
    out = np.zeros(d, np.int64)
    slot_map, ops, redirects = {}, 0, 0
    for idx, val in zip(indices, values):
        for i, v in zip(idx.tolist(), val.tolist()):
            if i in slot_map:
                ops += 1
            elif len(slot_map) < memory_slots:
                slot_map[i] = len(slot_map)
                ops += 1
            else:
                redirects += 1
            out[i] += v
    return out, ops, redirects


@pytest.mark.parametrize("memory_slots", [1, 3, 16, 1000])
def test_sparse_matches_reference_and_sequential(memory_slots):
    rng = np.random.default_rng(memory_slots)
    d = 64
    indices = [rng.choice(d, size=rng.integers(1, 20), replace=False)
               for _ in range(5)]
    values = [rng.integers(-50, 50, size=len(i)) for i in indices]
    out, stats = ProgrammableSwitch(memory_slots).aggregate_sparse(
        indices, values, d)
    want, wstats = jpsim.ProgrammableSwitch(memory_slots).aggregate_sparse(
        indices, values, d)
    np.testing.assert_array_equal(out, want)
    assert vars(stats) == vars(wstats)
    seq_out, seq_ops, seq_red = _sparse_sequential(indices, values, d,
                                                   memory_slots)
    np.testing.assert_array_equal(out, seq_out)
    assert (stats.aggregation_ops, stats.server_redirects) == (seq_ops,
                                                               seq_red)


def test_sparse_edges():
    ps = ProgrammableSwitch(memory_slots=1)
    out, stats = ps.aggregate_sparse([np.array([2, 2, 3])],
                                     [np.array([1, 1, 5])], d=4)
    np.testing.assert_array_equal(out, [0, 0, 2, 5])
    assert (stats.aggregation_ops, stats.server_redirects) == (2, 1)
    out, stats = ProgrammableSwitch().aggregate_sparse([], [], d=8)
    np.testing.assert_array_equal(out, np.zeros(8))
    assert stats == PSStats(0, 1, 0)
    # the paper's Sec. III-B motivation example costs 4
    u1, u2 = np.array([5, 4, 3, 2, 1]), np.array([1, 3, 4, 5, 2])
    _, stats = ProgrammableSwitch(2).aggregate_sparse(
        [np.array([0, 1]), np.array([3, 2])], [u1[[0, 1]], u2[[3, 2]]], d=5)
    assert (stats.aggregation_ops, stats.server_redirects) == (2, 2)


# ---------------------------------------------------------------------------
# the register bank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [8, 64, 1000])
def test_switch_dataplane_matches_reference(slots):
    rng = np.random.default_rng(slots)
    bufs = rng.integers(-2**31, 2**31, size=(5, 300),
                        dtype=np.int64).astype(np.int32)
    dp, jd = SwitchDataplane(slots), jdp.SwitchDataplane(slots)
    np.testing.assert_array_equal(dp.aggregate_windowed(bufs),
                                  jd.aggregate_windowed(bufs))
    votes = rng.integers(0, 2, size=(5, 300)).astype(np.uint8)
    deliv = rng.random((5, 300)) < 0.8
    np.testing.assert_array_equal(dp.count_votes(votes, deliv),
                                  jd.count_votes(votes, deliv))
    assert vars(dp.stats) == vars(jd.stats)
    assert dp.stats.overflow_slots > 0


def test_switch_dataplane_overflow_audit():
    dp = SwitchDataplane(memory_slots=8)
    bufs = np.zeros((2, 8), np.int32)
    bufs[0, 3], bufs[1, 3] = 2**31 - 1, 1     # slot 3 wraps
    bufs[0, 5], bufs[1, 5] = 2**31 - 2, 1     # slot 5 lands on the rail
    out = dp.aggregate_windowed(bufs)
    assert dp.stats.overflow_slots == 1
    assert out[5] == 2**31 - 1 and out[3] == -2**31
    assert dp.stats.merge(DataplaneStats(overflow_slots=2)).overflow_slots == 3


# ---------------------------------------------------------------------------
# register-bank overflow policies, bitwise the reference
# ---------------------------------------------------------------------------

def _same_policy(rows, **kw):
    got = register_accumulate(torch.from_numpy(rows), **kw)
    want = jpol.register_accumulate(jnp.asarray(rows), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("policy", ["wrap", "saturate", "rescale"])
@pytest.mark.parametrize("case", ["random", "hot", "small", "windows"])
def test_register_accumulate_bitwise(policy, case):
    rng = np.random.default_rng(len(case))
    if case == "random":
        rows = rng.integers(-2**31, 2**31, size=(13, 257), dtype=np.int64)
    elif case == "hot":
        rows = rng.integers(2**28, 2**30, size=(24, 96), dtype=np.int64)
    elif case == "small":
        rows = rng.integers(-2**20, 2**20, size=(6, 50), dtype=np.int64)
    else:
        rows = np.concatenate([np.full((8, 4), 2**29), np.ones((8, 4))],
                              axis=1)
    rows = rows.astype(np.int32)
    kw = {}
    if case == "windows":
        kw = dict(slot_window=np.array([0] * 4 + [1] * 4, np.int32),
                  n_windows=2)
    summed, ovf, shift = _same_policy(rows, policy=policy, **kw)
    exact = rows.astype(np.int64).sum(0)
    if policy == "wrap":
        np.testing.assert_array_equal(
            summed.numpy(), torch.from_numpy(rows).sum(0, dtype=torch.int32))
    if case == "small":
        assert not bool(ovf.any()) and not bool(shift.any())
        np.testing.assert_array_equal(summed.numpy(), exact)
    if policy == "rescale" and case == "hot":
        val = summed.numpy() * np.exp2(shift.numpy().astype(np.float64))
        assert np.all(np.abs(val - exact) <= 24 * np.exp2(shift.numpy()))
    if policy == "rescale" and case == "windows":
        sh = shift.numpy()
        assert len(set(sh[:4].tolist())) == 1 and sh[0] >= 1
        assert np.all(sh[4:] == 0) and np.all(summed.numpy()[4:] == 8)


def test_register_boundary_value_pins():
    s, o, sh = register_accumulate(torch.tensor([[INT32_MAX - 1], [1]],
                                                dtype=torch.int32))
    assert int(s[0]) == 2**31 - 1 and not bool(o[0]) and int(sh[0]) == 0
    over = np.array([[INT32_MAX], [1]], np.int32)
    s, o, _ = _same_policy(over, policy="wrap")
    assert int(s[0]) == -2**31 and bool(o[0])
    s, o, _ = _same_policy(over, policy="saturate")
    assert int(s[0]) == 2**31 - 1 and bool(o[0])
    s, o, sh = _same_policy(over, policy="rescale")
    assert bool(o[0]) and int(sh[0]) >= 1
    s, o, _ = _same_policy(np.array([[INT32_MIN], [-1]], np.int32),
                           policy="saturate")
    assert int(s[0]) == -2**31 and bool(o[0])
    with pytest.raises(ValueError, match="register policy"):
        register_accumulate(torch.zeros((2, 2), dtype=torch.int32),
                            policy="drop")


# ---------------------------------------------------------------------------
# the retry/backoff policy and NetConfig's validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,field", [
    (dict(base_s=-0.1), "base_s"), (dict(base_s=math.nan), "base_s"),
    (dict(base_s=math.inf), "base_s"),
    (dict(base_s=0.1, factor=0.5), "factor"),
    (dict(base_s=0.1, factor=math.nan), "factor"),
    (dict(base_s=0.1, cap_s=0.0), "cap_s"),
    (dict(base_s=0.1, cap_s=-1.0), "cap_s"),
    (dict(base_s=0.1, cap_s=math.nan), "cap_s"),
    (dict(base_s=0.1, max_retries=-1), "max_retries"),
    (dict(base_s=0.1, jitter_frac=-0.01), "jitter_frac"),
    (dict(base_s=0.1, jitter_frac=1.0), "jitter_frac"),
])
def test_invalid_policies_raise_with_field_name(kw, field):
    with pytest.raises(ValueError, match=field):
        BackoffPolicy(**kw)


@pytest.mark.parametrize("kw", [
    {"loss": 1.0}, {"loss": -0.01}, {"participation": 0.0},
    {"participation": 1.5}, {"straggler_frac": -0.1},
    {"straggler_slowdown": 0.5}, {"straggler_slowdown": float("inf")},
    {"vote_deadline_s": 0.0}, {"vote_deadline_s": -1.0},
    {"vote_deadline_s": float("inf")},
    {"rto_s": 0.0}, {"rto_s": NAN},
    {"max_retries": 0}, {"n_leaves": 0}, {"memory_slots": 0}, {"mtu": 0},
])
def test_net_config_rejects(kw):
    with pytest.raises(ValueError, match=next(iter(kw))):
        NetConfig(**kw)


@pytest.mark.parametrize("kw", [dict(base_s=0.1, factor=2.0, cap_s=0.5,
                                     max_retries=8),
                                dict(base_s=0.1, factor=2.0, max_retries=6),
                                dict(base_s=0.05, factor=1.0, max_retries=16),
                                dict(base_s=0.25, factor=2.0, cap_s=1.0,
                                     max_retries=3)])
def test_delays_and_total_delay_bitwise(kw):
    got, want = BackoffPolicy(**kw), jpol.BackoffPolicy(**kw)
    np.testing.assert_array_equal(_bits(got.delays(5, device="cpu")),
                                  _bits(want.delays(5)))
    k = np.array([0, 1, 3, 6, 16, 99], np.int32)
    np.testing.assert_array_equal(_bits(got.total_delay(torch.from_numpy(k))),
                                  _bits(want.total_delay(jnp.asarray(k))))
    base = torch.tensor(0.5)
    np.testing.assert_array_equal(_bits(got.delays(3, base=base)),
                                  _bits(want.delays(3, base=jnp.float32(0.5))))


def test_arq_policy_is_bitwise_retx_times_rto():
    p = NetConfig(rto_s=0.05, max_retries=16).arq_policy()
    assert p.factor == 1.0
    k = torch.tensor([0, 1, 3, 16], dtype=torch.int32)
    want = k.numpy().astype(np.float32) * np.float32(0.05)
    assert p.total_delay(k).numpy().tobytes() == want.tobytes()
    delay, retx = retransmit_delays(torch.tensor([0, 0]), (6, 9), 0.3, 0.05,
                                    16)
    want = retx.numpy().astype(np.float32) * np.float32(0.05)
    assert delay.numpy().tobytes() == want.tobytes()


def test_jitter_bitwise_bounded_and_deterministic():
    kw = dict(base_s=0.1, factor=2.0, max_retries=4, jitter_frac=0.5)
    p, jp = BackoffPolicy(**kw), jpol.BackoffPolicy(**kw)
    key = jax.random.PRNGKey(7)
    d = p.delays(5, device="cpu")
    j1 = p.jittered(d, key_to_torch(key))
    np.testing.assert_array_equal(_bits(j1), _bits(jp.jittered(jp.delays(5),
                                                               key)))
    assert torch.equal(j1, p.jittered(d, key_to_torch(key)))
    assert bool(((j1 >= d * 0.5) & (j1 <= d * 1.5)).all())
    assert not torch.equal(j1, d)
    p0 = BackoffPolicy(base_s=0.1, factor=2.0)
    assert torch.equal(p0.jittered(d, key_to_torch(key)), d)
