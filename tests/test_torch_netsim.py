"""The port's packet dataplane round against the reference's
``PacketTransport`` round: bitwise in delta, residuals, vote counts,
masks, the integer statistics, the simulated clock and the upload bytes
(the mean wait within 1e-6 relative), lossless and lossy; the lossless
round bitwise ``aggregate_stack`` on every engine; and the reference's
dataplane tests, each against the port."""

import jax
import numpy as np
import pytest
import torch

from repro.core.fediac import FediACConfig as JCfg
from repro.netsim import NetConfig as JNet, PacketTransport as JPT
from repro.netsim import policies as jpol
from repro_torch.core import prng
from repro_torch.core.engines import EngineSpec
from repro_torch.core.fediac import (FediACConfig, aggregate_stack,
                                     round_traffic)
from repro_torch.kernels import gather_quant, stoch_quant
from repro_torch.netsim import (NetConfig, PacketTransport, SwitchDataplane,
                                aggregate_hierarchy, leaf_assignment,
                                net_round_key, sample_participants,
                                sample_stragglers)
from repro_torch.netsim.timeline import poisson_arrivals
from repro_torch.switch import (SwitchProfile, client_rates, n_packets,
                                packet_sizes, round_wall_clock)
from repro_torch.testing import key_to_torch

MODES = [("topk", "topk"), ("topk", "block"),
         ("threshold", "topk"), ("threshold", "block")]
#: the mean wait sums float32 waits in another order than XLA's reduce
WAIT_RTOL = 1e-6
#: exact statistics of a FediAC packet round (the clock is exact too: the
#: one float reduction on it, the mean of 8 client rates, is replayed)
EXACT_STATS = ("phase1_s", "phase2_s", "votes_lost", "stragglers",
               "retransmissions", "passes", "peak_live_slots",
               "aggregation_ops", "vote_threshold_a", "register_occupancy")


@pytest.fixture(scope="module")
def u_stack():
    u = jax.random.normal(jax.random.PRNGKey(1), (8, 2048)) ** 3
    return u, torch.from_numpy(np.array(u))


def _bits(x):
    a = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref):
    np.testing.assert_array_equal(_bits(port), _bits(ref))


def _cfgs(kernels=False, **kw):
    """The same FediAC config in both packages (the reference's fused path
    is its ``use_pallas`` field, the port's the engine spec)."""
    return (JCfg(use_pallas=kernels, **kw),
            FediACConfig(engine=EngineSpec(use_pallas=kernels), **kw))


def _rounds(u_stack, cfg_kw, net_kw, *, key=42, rnd=0, lts=0.1,
            kernels=False):
    """One packet round of each package on the same inputs."""
    u_j, u_t = u_stack
    jc, tc = _cfgs(kernels, **cfg_kw)
    k = jax.random.PRNGKey(key)
    ref = JPT("fediac", {"cfg": jc}, net=JNet(**net_kw),
              local_train_s=lts).round(u_j, None, k, rnd)
    port = PacketTransport("fediac", {"cfg": tc}, net=NetConfig(**net_kw),
                           local_train_s=lts).round(u_t, None,
                                                    key_to_torch(k), rnd)
    return port, ref


def _same_round(port, ref):
    _same(port.delta, ref.delta)
    _same(port.residuals, ref.residuals)
    for k in ("vote_counts", "participants", "uploaders"):
        np.testing.assert_array_equal(port.stats[k], ref.stats[k])
    for k in EXACT_STATS:
        assert port.stats[k] == ref.stats[k], k
    np.testing.assert_allclose(port.stats["mean_wait_s"],
                               ref.stats["mean_wait_s"], rtol=WAIT_RTOL)
    assert port.wall_clock_s == ref.wall_clock_s
    assert port.upload_bytes == ref.upload_bytes
    assert port.n_active == ref.n_active
    assert vars(port.traffic) == vars(ref.traffic)
    assert vars(port.load) == vars(ref.load)


def _vote_median(net_kw, u_shape, rnd, lts=0.1):
    """The median arrival of the lossless round's vote packets (the
    deadline that cuts about half of them)."""
    n, d = u_shape
    p1 = n_packets(round_traffic(FediACConfig(), d).phase1_bytes)
    k_arr1 = prng.split(net_round_key(net_kw["seed"], rnd, device="cpu"),
                        6)[2]
    arr = poisson_arrivals(k_arr1, client_rates(n, net_kw["seed"]), p1, lts)
    return float(arr.reshape(-1).sort().values[arr.numel() // 2])


# ---------------------------------------------------------------------------
# the core guarantee: lossless full participation == aggregate_stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_packet_round_bit_identical(u_stack, vote_mode, compact_mode):
    cfg_kw = dict(vote_mode=vote_mode, compact_mode=compact_mode, a=2)
    port, ref = _rounds(u_stack, cfg_kw, {})
    _same_round(port, ref)
    delta, res, counts, traffic = aggregate_stack(
        u_stack[1], FediACConfig(**cfg_kw), key_to_torch(jax.random.PRNGKey(42)))
    _same(port.delta, delta)
    _same(port.residuals, res)
    np.testing.assert_array_equal(port.stats["vote_counts"], counts.numpy())
    assert port.traffic == traffic
    assert port.wall_clock_s > 0


LOSSY = {
    # the chip check's lossy round at the CPU size, its deadline the
    # lossless round's median vote arrival
    "chip": dict(loss=0.05, participation=0.5, straggler_frac=0.25,
                 n_leaves=2, memory_slots=64, seed=9),
    # three leaves, a 16-slot bank, a deadline, stragglers slowed 3x (an
    # inexact product feeding the arrival clock)
    "tree": dict(loss=0.05, participation=0.75, straggler_frac=0.25,
                 straggler_slowdown=3.0, n_leaves=3, memory_slots=16,
                 seed=5),
    # heavy loss, no deadline: many retransmissions
    "retx": dict(loss=0.3, straggler_frac=0.5, straggler_slowdown=3.0,
                 n_leaves=3, memory_slots=16, rto_s=0.033, seed=5),
}


@pytest.mark.parametrize("name,kernels,vote_chunk", [
    ("chip", False, 1), ("chip", True, 1), ("chip", True, 4),
    ("tree", False, 1), ("tree", True, 1), ("retx", False, 1)])
def test_lossy_round_bitwise(u_stack, name, kernels, vote_chunk):
    """Loss, partial participation, stragglers, a vote deadline that cuts
    votes, several leaves and a small bank: every output of the round is
    the reference's.  With the kernels on (their plain versions here) the
    round takes the fused phase 2 (vote_chunk 1) or Eq. 1's kernel
    (vote_chunk 4)."""
    net_kw = dict(LOSSY[name])
    if name != "retx":
        net_kw["vote_deadline_s"] = _vote_median(net_kw, (8, 2048), 4)
    before = (gather_quant.gather_quant.launches,
              stoch_quant.stoch_quant.launches)
    port, ref = _rounds(u_stack, dict(a=2, vote_chunk=vote_chunk), net_kw,
                        key=3, rnd=4, kernels=kernels)
    # on the CPU the kernels' wrappers run their plain versions
    assert (gather_quant.gather_quant.launches,
            stoch_quant.stoch_quant.launches) == before
    _same_round(port, ref)
    assert 0 < port.n_active < 8
    assert port.stats["passes"] > 1
    if name == "retx":
        assert port.stats["retransmissions"] > 0
        return
    # the deadline cut votes that loss alone would have delivered
    free = PacketTransport(
        "fediac", {"cfg": _cfgs(kernels, a=2, vote_chunk=vote_chunk)[1]},
        net=NetConfig(**LOSSY[name])).round(
        u_stack[1], None, key_to_torch(jax.random.PRNGKey(3)), 4)
    assert port.stats["votes_lost"] > free.stats["votes_lost"]


@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
@pytest.mark.parametrize("spec", [EngineSpec("stream", chunk=300),
                                  EngineSpec("stream", chunk=1024,
                                             use_pallas=True),
                                  EngineSpec("sharded", devices=3)],
                         ids=["stream", "stream-kernels", "sharded"])
def test_packet_engines_bitwise(u_stack, vote_mode, compact_mode, spec):
    """The stream and sharded phase 2 under the packet core: the lossless
    round is bitwise ``aggregate_stack`` and the lossy round bitwise the
    monolithic packet round (same kernels setting)."""
    u = u_stack[1]
    key = key_to_torch(jax.random.PRNGKey(3))
    cfg_kw = dict(vote_mode=vote_mode, compact_mode=compact_mode, a=2)
    cfg = FediACConfig(engine=spec, **cfg_kw)
    mono = FediACConfig(engine=EngineSpec(use_pallas=spec.use_pallas),
                        **cfg_kw)
    lossless = PacketTransport("fediac", {"cfg": cfg}).round(u, None, key)
    delta, res, counts, _ = aggregate_stack(u, mono, key)
    _same(lossless.delta, delta)
    _same(lossless.residuals, res)
    np.testing.assert_array_equal(lossless.stats["vote_counts"],
                                  counts.numpy())
    net = NetConfig(**LOSSY["tree"], vote_deadline_s=0.12)
    got = PacketTransport("fediac", {"cfg": cfg}, net=net).round(u, None,
                                                                 key, 4)
    want = PacketTransport("fediac", {"cfg": mono}, net=net).round(u, None,
                                                                   key, 4)
    _same(got.delta, want.delta)
    _same(got.residuals, want.residuals)
    assert got.stats.keys() == want.stats.keys()
    for k, v in got.stats.items():
        np.testing.assert_array_equal(v, want.stats[k])
    assert got.wall_clock_s == want.wall_clock_s


# ---------------------------------------------------------------------------
# the reference's dataplane tests, each against the port
# ---------------------------------------------------------------------------

def test_hierarchy_changes_time_never_values(u_stack):
    u = u_stack[1]
    cfg = FediACConfig(a=2)
    key = torch.tensor([0, 0])
    flat = PacketTransport("fediac", {"cfg": cfg},
                           net=NetConfig(n_leaves=1)).round(u, None, key)
    tree = PacketTransport("fediac", {"cfg": cfg},
                           net=NetConfig(n_leaves=3)).round(u, None, key)
    _same(flat.delta, tree.delta)
    _same(flat.residuals, tree.residuals)
    assert tree.wall_clock_s >= flat.wall_clock_s  # root hop only adds time


def test_register_windows_multipass_exact(u_stack):
    u = u_stack[1]
    cfg = FediACConfig(a=2)
    key = torch.tensor([0, 0])
    r_big = PacketTransport("fediac", {"cfg": cfg},
                            net=NetConfig()).round(u, None, key)
    r_tiny = PacketTransport("fediac", {"cfg": cfg},
                             net=NetConfig(memory_slots=16)).round(u, None, key)
    assert r_tiny.stats["passes"] > 1 and r_big.stats["passes"] == 1
    _same(r_big.delta, r_tiny.delta)
    assert r_tiny.stats["peak_live_slots"] <= 16


def test_dataplane_rejects_floats():
    with pytest.raises(TypeError):
        SwitchDataplane(8).aggregate_windowed(np.ones((2, 4), np.float32))


def test_masked_sum_matches_register_bank_walk():
    """The round core's masked int32 column sum equals the register-bank
    walk, single switch and hierarchy, with windows."""
    rng = np.random.default_rng(0)
    bufs = rng.integers(-2**31, 2**31 - 1, size=(7, 300), dtype=np.int64
                        ).astype(np.int32)
    leaf_of = leaf_assignment(7, 3)
    col_sum = torch.from_numpy(bufs).sum(dim=0, dtype=torch.int32).numpy()
    for n_leaves, slots in [(1, 64), (3, 64), (3, 1024)]:
        walk, _ = aggregate_hierarchy(bufs, leaf_of, n_leaves, slots)
        np.testing.assert_array_equal(walk, col_sum)


def test_round_deterministic(u_stack):
    u = u_stack[1]
    net = NetConfig(loss=0.05, participation=0.5, straggler_frac=0.25, seed=9)
    key = torch.tensor([0, 3])
    cfg = FediACConfig(a=2)
    r1 = PacketTransport("fediac", {"cfg": cfg}, net=net).round(u, None, key, 4)
    r2 = PacketTransport("fediac", {"cfg": cfg}, net=net).round(u, None, key, 4)
    assert r1.wall_clock_s == r2.wall_clock_s
    _same(r1.delta, r2.delta)
    np.testing.assert_array_equal(r1.stats["uploaders"], r2.stats["uploaders"])


def test_fediac_round_wall_clock_agrees_with_analytic(u_stack):
    """The packetized round against the analytic model the FL loop used:
    the reference's documented 35% tolerance (few packets per phase)."""
    u = u_stack[1]
    r = PacketTransport("fediac", {"cfg": FediACConfig(a=2)}).round(
        u, None, torch.tensor([0, 0]))
    ana = round_wall_clock(packets_per_client=r.load.packets_per_client,
                           download_packets=r.load.packets_per_client,
                           rates=client_rates(8, 0),
                           profile=SwitchProfile.high(), local_train_s=0.1)
    assert abs(r.wall_clock_s - ana) / ana < 0.35


def test_loss_retransmission_costs_time_and_bytes(u_stack):
    u = u_stack[1]
    cfg = FediACConfig(a=2)
    key = torch.tensor([0, 0])
    clean = PacketTransport("fediac", {"cfg": cfg}).round(u, None, key)
    lossy = PacketTransport("fediac", {"cfg": cfg},
                            net=NetConfig(loss=0.4, seed=11)).round(u, None, key)
    assert lossy.stats["retransmissions"] > 0
    assert lossy.upload_bytes > clean.upload_bytes


def test_packet_sizes_final_partial_packet():
    np.testing.assert_array_equal(packet_sizes(3001, 1500), [1500, 1500, 1])
    np.testing.assert_array_equal(packet_sizes(3000, 1500), [1500, 1500])
    np.testing.assert_array_equal(packet_sizes(10, 1500), [10])
    np.testing.assert_array_equal(packet_sizes(0, 1500), [1])


def test_partial_participation_semantics(u_stack):
    u = u_stack[1]
    r = PacketTransport("fediac", {"cfg": FediACConfig(a=2)},
                        net=NetConfig(participation=0.5, seed=7)).round(
        u, None, torch.tensor([0, 0]))
    up = r.stats["uploaders"]
    assert 0 < len(up) < 8 and r.n_active == len(up)
    out = np.setdiff1d(np.arange(8), up)
    # non-participants carry their whole update as residual
    _same(r.residuals[out], u[out])
    assert not torch.equal(r.residuals[up], u[up])


@pytest.mark.parametrize("seed,round_idx,n,p", [(1, 0, 20, 0.25),
                                                (0, 0, 8, 0.01),
                                                (3, 7, 32, 0.5)])
def test_participation_sampling_exact_count(seed, round_idx, n, p):
    jkey = jax.random.fold_in(jpol.net_round_key(seed, round_idx), 1)
    mask = sample_participants(key_to_torch(jkey), n, p)
    assert int(mask.sum()) == max(1, round(p * n))
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jpol.sample_participants(jkey, n, p)))
    # a tensor participation draws the same participants
    np.testing.assert_array_equal(
        sample_participants(key_to_torch(jkey), n, torch.tensor(p)).numpy(),
        mask.numpy())


def test_straggler_sampling_subset_of_participants():
    jk1, jk2 = jax.random.split(jpol.net_round_key(0, 7))
    part = sample_participants(key_to_torch(jk1), 20, 0.5)
    strag = sample_stragglers(key_to_torch(jk2), part, 0.4)
    assert int(strag.sum()) == round(0.4 * int(part.sum()))
    assert bool((~strag | part).all())
    want = jpol.sample_stragglers(jk2, jpol.sample_participants(jk1, 20, 0.5),
                                  0.4)
    np.testing.assert_array_equal(strag.numpy(), np.asarray(want))


def test_participation_floor_one_client(u_stack):
    r = PacketTransport("fediac", {"cfg": FediACConfig(a=2)},
                        net=NetConfig(participation=0.01, seed=2)).round(
        u_stack[1], None, torch.tensor([0, 0]))
    assert r.n_active == 1 and len(r.stats["uploaders"]) == 1
    assert bool(torch.isfinite(r.delta).all())


def test_all_stragglers_round_still_closes(u_stack):
    """Every participant straggling and no deadline: the round waits for
    the slow clients and still uploads — the reference's round."""
    port, ref = _rounds(u_stack, dict(a=2),
                        dict(straggler_frac=1.0, straggler_slowdown=10.0,
                             seed=4), key=0)
    _same_round(port, ref)
    assert port.stats["stragglers"] == 8 and port.n_active == 8
    assert port.wall_clock_s > 1.0


def test_zero_uploaders_round_is_exact(u_stack):
    """A deadline before any vote packet arrives: no uploaders, delta
    exactly zero, every update carried over, only phase-1 bytes billed —
    the reference's round."""
    port, ref = _rounds(u_stack, dict(a=2),
                        dict(vote_deadline_s=1e-4, seed=3, n_leaves=2),
                        key=0)
    _same_round(port, ref)
    assert port.n_active == 0
    assert bool((port.delta == 0.0).all())
    _same(port.residuals, u_stack[1])
    assert port.upload_bytes == port.traffic.phase1_bytes * 8
    assert port.wall_clock_s > 0


def test_vote_deadline_drops_stragglers(u_stack):
    u = u_stack[1]
    net = NetConfig(straggler_frac=0.5, straggler_slowdown=100.0,
                    vote_deadline_s=0.3, seed=1)
    r = PacketTransport("fediac", {"cfg": FediACConfig(a=2)}, net=net,
                        local_train_s=0.1).round(u, None, torch.tensor([0, 0]))
    assert r.stats["stragglers"] == 4
    assert len(r.stats["uploaders"]) == 4       # only punctual clients
    out = np.setdiff1d(np.arange(8), r.stats["uploaders"])
    _same(r.residuals[out], u[out])
    assert r.wall_clock_s < 5.0


def test_vote_loss_shrinks_consensus_not_correctness(u_stack):
    u = u_stack[1]
    cfg = FediACConfig(a=2)
    key = torch.tensor([0, 0])
    clean = PacketTransport("fediac", {"cfg": cfg}).round(u, None, key)
    lossy = PacketTransport("fediac", {"cfg": cfg},
                            net=NetConfig(loss=0.3, seed=5)).round(u, None, key)
    assert lossy.stats["votes_lost"] > 0
    assert np.all(lossy.stats["vote_counts"] <= clean.stats["vote_counts"])
    assert bool(torch.isfinite(lossy.delta).all())


def test_leaf_assignment_round_robin():
    np.testing.assert_array_equal(leaf_assignment(7, 3), [0, 1, 2, 0, 1, 2, 0])
    assert leaf_assignment(5, 1).max() == 0
    assert leaf_assignment(7, 3) is leaf_assignment(7, 3)


def test_unaligned_baseline_pays_alignment_penalty(u_stack):
    u = u_stack[1]
    key = torch.tensor([0, 0])
    t_topk = PacketTransport("topk", {"k_frac": 0.05}).round(
        u, None, key).wall_clock_s
    t_sml = PacketTransport("switchml", {"bits": 12}).round(
        u, None, key).wall_clock_s
    assert t_topk > 0 and t_sml > 0
