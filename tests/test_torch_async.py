"""The port's asynchronous quorum-or-deadline close
(``netsim/async_engine.py``) against the reference.

The async packet round is held bitwise against the reference's core under
``jax.jit`` (as its ``PacketTransport`` runs it) over the three staleness
modes, both late policies, with and without a deadline, two rounds each so
that the second folds the first's carry: delta, residuals, the carry,
every ``aux`` field, ``t_done`` and ``t_close`` (the mean wait within
1e-6).  Then the identities at full quorum (the synchronous core, and
``aggregate_stack`` through the transport), the in-memory ``"async"``
engine, the host oracle ``AsyncServer``, the carry's checkpoint and a
killed-and-resumed FL run, and one test for each floating-point form the
reference's compiled round fixes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fediac import FediACConfig as JCfg
from repro.netsim import AsyncConfig as JAsync
from repro.netsim import AsyncServer as JServer
from repro.netsim import aggregate_async_stack as j_async_stack
from repro.netsim import async_packet_dyn as j_async_dyn
from repro.netsim import init_async_carry as j_init_carry
from repro.netsim import make_async_packet_core as j_async_core
from repro.netsim import net_round_key as j_net_round_key
from repro.netsim.async_engine import \
    _per_packet_departures as j_departures
from repro_torch.checkpoint import load_run_state, save_run_state
from repro_torch.core import engines, prng, xla_math
from repro_torch.core.engines import EngineSpec
from repro_torch.core.fediac import (FediACConfig, aggregate_round,
                                     aggregate_stack)
from repro_torch.data import classification, partition_dirichlet
from repro_torch.netsim import (ASYNC_STAT_FIELDS, LATE_POLICIES,
                                STALENESS_MODES, AsyncConfig, AsyncServer,
                                NetConfig, PacketTransport,
                                aggregate_async_stack, async_packet_dyn,
                                init_async_carry, make_async_packet_core,
                                make_fediac_packet_core, net_round_key,
                                packet_dyn)
from repro_torch.netsim.async_engine import (_KEY_ARRIVAL,
                                             _per_packet_departures,
                                             _quorum_count,
                                             _weighted_client_sum)
from repro_torch.netsim.faults import _rescale_to_float
from repro_torch.testing import key_to_torch
from repro_torch.training import fl_loop

MODES = [("topk", "topk"), ("topk", "block"),
         ("threshold", "topk"), ("threshold", "block")]
N, D = 6, 288
#: the harness's clients: 800 packets/s, 10 ms of local training, a
#: 32-byte MTU (9 vote packets, 3 value packets per client), so stragglers
#: land well after the quorum
RATES, TRAIN_S, SVC, MTU = 800.0, 0.01, 1e-4, 32
NET_SEED, KEY_SEED = 11, 3
#: the mean wait sums float32 waits in another order than XLA's reduce
WAIT_RTOL = 1e-6
#: lossy, partial, half straggling 8x slower; the quorum is half the
#: announced uploaders
STRESS = dict(loss=0.05, participation=0.9, straggler_frac=0.5,
              straggler_slowdown=8.0, quorum_frac=0.5, mtu=MTU)
#: a deadline that closes round 1 short of its quorum (3 ms into phase 2)
DEADLINE_S = 0.003
#: the knobs of each staleness mode: a constant weight below 1, a poly
#: decay off gamma 1, and a cap between the harness's staleness values
MODE_KW = {"constant": dict(staleness_weight=0.6),
           "poly": dict(staleness_gamma=1.7),
           "cap": dict(staleness_weight=0.8, staleness_cap=0.05)}


def _bits(x):
    a = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref, msg=""):
    np.testing.assert_array_equal(_bits(port), _bits(ref), err_msg=msg)


def _cfg_kw(vote_mode="topk", compact_mode="topk", **kw):
    return {**dict(k_frac=0.2, capacity_frac=0.25, bits=5,
                   vote_mode=vote_mode, compact_mode=compact_mode,
                   block_size=16), **kw}


def _u(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def _port_rounds(cfg_kw, net_kw, u, rounds=2):
    """The port's async core for ``rounds`` rounds on the same stack, the
    carry threaded; returns ``[(delta, residuals, aux, carry_out)]``."""
    cfg, net = FediACConfig(**cfg_kw), AsyncConfig(**net_kw)
    core = make_async_packet_core(cfg, net, u.shape[0])
    dyn = async_packet_dyn(cfg, net, u.shape[0], TRAIN_S, SVC, device="cpu")
    rates = torch.full((u.shape[0],), RATES)
    carry = init_async_carry(u.shape[1], device="cpu")
    nk = net_round_key(NET_SEED, 0, device="cpu")
    key = prng.PRNGKey(KEY_SEED, device="cpu")
    out = []
    for r in range(rounds):
        res = core(torch.from_numpy(u), carry, key, nk, r, rates, dyn)
        out.append(res)
        carry = res[3]
    return out


def _ref_rounds(cfg_kw, net_kw, u, rounds=2):
    """The reference's async core under ``jax.jit``, as ``_port_rounds``."""
    cfg, net = JCfg(**cfg_kw), JAsync(**net_kw)
    core = jax.jit(j_async_core(cfg, net, u.shape[0]))
    dyn = j_async_dyn(cfg, net, u.shape[0], TRAIN_S, SVC)
    rates = jnp.full((u.shape[0],), RATES, jnp.float32)
    carry = j_init_carry(u.shape[1])
    nk = j_net_round_key(NET_SEED, 0)
    out = []
    for r in range(rounds):
        res = core(jnp.asarray(u), carry, jax.random.PRNGKey(KEY_SEED), nk,
                   r, rates, dyn)
        out.append(res)
        carry = res[3]
    return out


def _same_async_round(port, ref):
    (d, r, aux, carry), (jd, jr, jaux, jcarry) = port, ref
    _same(d, jd, "delta")
    _same(r, jr, "residuals")
    for k in ("pending", "pending_w", "pending_n"):
        _same(carry[k], jcarry[k], k)
        assert carry[k].dtype == torch.from_numpy(
            np.array(jcarry[k])).dtype, k
    assert aux.keys() == jaux.keys()
    for k, v in jaux.items():
        if k == "mean_wait_s":
            np.testing.assert_allclose(float(aux[k]), float(v),
                                       rtol=WAIT_RTOL)
        else:
            _same(torch.as_tensor(aux[k]), v, k)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"quorum_frac": 0.0}, {"quorum_frac": 1.5}, {"quorum_frac": -0.1},
    {"round_deadline_s": 0.0}, {"round_deadline_s": -2.0},
    {"round_deadline_s": float("inf")},
    {"staleness_mode": "linear"}, {"staleness_weight": 0.0},
    {"staleness_weight": 1.0001}, {"staleness_gamma": -1.0},
    {"staleness_gamma": float("nan")}, {"staleness_cap": -0.5},
    {"late_policy": "drop"}, {"register_policy": "clamp"},
    {"n_leaves": 4},                       # single-switch close only
    {"rto_s": 0.0},                        # inherited validation still runs
])
def test_asyncconfig_rejects_bad_knobs(kw):
    with pytest.raises(ValueError):
        JAsync(**kw)            # the reference refuses it too
    with pytest.raises(ValueError):
        AsyncConfig(**kw)


def test_asyncconfig_accepts_boundary_values():
    AsyncConfig(quorum_frac=1e-6, round_deadline_s=1e-6,
                staleness_weight=1.0, staleness_gamma=0.0, staleness_cap=0.0)
    AsyncConfig(round_deadline_s=None)
    assert STALENESS_MODES == ("constant", "poly", "cap")
    assert LATE_POLICIES == ("fold", "bounce")


def test_async_engine_registered():
    spec = engines.get("async")
    assert spec == EngineSpec(name="async")
    FediACConfig(engine="async")
    fl_loop.FLConfig(engine="async")
    with pytest.raises(ValueError):
        engines.get("no-such-engine")


# ---------------------------------------------------------------------------
# the in-memory "async" engine: event-ordered fold == aggregate_stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_event_ordered_fold_bitwise_aggregate_stack(vote_mode, compact_mode):
    """The port's async engine against the reference's (jitted) and against
    ``aggregate_stack``, through ``aggregate_round`` too."""
    kw = _cfg_kw(vote_mode, compact_mode)
    u, key = _u(1), jax.random.PRNGKey(13)
    ut, kt = torch.from_numpy(u), key_to_torch(key)
    ref = jax.jit(lambda uu, kk: j_async_stack(uu, JCfg(**kw), kk)[:3])(
        jnp.asarray(u), key)
    got = aggregate_async_stack(ut, FediACConfig(**kw), kt)
    stack = aggregate_stack(ut, FediACConfig(**kw), kt)
    routed = aggregate_round(ut, FediACConfig(**kw, engine="async"), kt)
    for g, r, s, e in zip(got[:3], ref, stack[:3], routed[:3]):
        _same(g, r)
        _same(g, s)
        _same(e, s)
    assert got[3] == stack[3]


@pytest.mark.parametrize("close", [dict(robust_agg="trim", trim_frac=0.2),
                                   dict(robust_agg="median")])
def test_event_order_and_robust_close(close):
    """The event order is the stable argsort of ``uniform(fold_in(key,
    7300))``, as the reference draws it; a robust close buffers every
    client and closes over the unpermuted stack, so the engine is the
    reference's and ``aggregate_stack``'s bit for bit."""
    key = jax.random.PRNGKey(21)
    want = np.asarray(jnp.argsort(jax.random.uniform(
        jax.random.fold_in(key, _KEY_ARRIVAL), (N,))))
    got = torch.sort(prng.uniform(prng.fold_in(key_to_torch(key),
                                               _KEY_ARRIVAL), (N,)),
                     stable=True).indices
    np.testing.assert_array_equal(got.numpy(), want)
    kw = _cfg_kw(**close)
    u = _u(2)
    ref = jax.jit(lambda uu, kk: j_async_stack(uu, JCfg(**kw), kk)[:3])(
        jnp.asarray(u), key)
    got = aggregate_async_stack(torch.from_numpy(u), FediACConfig(**kw),
                                key_to_torch(key))
    stack = aggregate_stack(torch.from_numpy(u), FediACConfig(**kw),
                            key_to_torch(key))
    for g, r, s in zip(got[:3], ref, stack[:3]):
        _same(g, r)
        _same(g, s)


# ---------------------------------------------------------------------------
# full quorum, no deadline, empty carry: the synchronous round
# ---------------------------------------------------------------------------

_SYNC_AUX = ("wall_clock_s", "phase1_s", "phase2_s", "mean_wait_s", "n_part",
             "n_up", "votes_lost", "retransmissions", "retx_last", "counts",
             "aggregation_ops", "peak_live_slots", "passes", "participants",
             "stragglers", "uploaders", "n_strag")


@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
@pytest.mark.parametrize("netkw", [
    {}, {"loss": 0.08, "participation": 0.8, "straggler_frac": 0.3}])
def test_full_quorum_bitwise_sync_core(vote_mode, compact_mode, netkw):
    """At its defaults the async core is the plain packet core, every aux
    entry of the plain core included (the mean wait too: both drains add
    in the same order)."""
    cfg = FediACConfig(**_cfg_kw(vote_mode, compact_mode))
    u = torch.from_numpy(_u(0))
    key = prng.PRNGKey(KEY_SEED, device="cpu")
    nk = net_round_key(NET_SEED, 0, device="cpu")
    rates = torch.full((N,), RATES)
    plain = make_fediac_packet_core(cfg, NetConfig(**netkw), N)
    dyn = packet_dyn(cfg, NetConfig(**netkw), N, TRAIN_S, SVC, device="cpu")
    ds, rs, auxs = plain(u, key, nk, 0, rates, dyn)
    (da, ra, auxa, carry), = _port_rounds(_cfg_kw(vote_mode, compact_mode),
                                          netkw, _u(0), rounds=1)
    _same(ds, da)
    _same(rs, ra)
    for k in _SYNC_AUX:
        _same(torch.as_tensor(auxs[k]), torch.as_tensor(auxa[k]), k)
    assert int(auxa["late_folded"]) == int(auxa["late_bounced"]) == 0
    assert int(carry["pending_n"]) == 0 and float(carry["pending_w"]) == 0.0


@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_lossless_async_transport_bitwise_aggregate_stack(vote_mode,
                                                          compact_mode):
    """Through the transport, lossless and at full participation, the
    async round is ``aggregate_stack`` bit for bit, the carry empty."""
    cfg = FediACConfig(**_cfg_kw(vote_mode, compact_mode))
    u = torch.from_numpy(_u(2, n=5, d=160))
    key = key_to_torch(jax.random.PRNGKey(7))
    ref = aggregate_stack(u, cfg, key)
    r = PacketTransport("fediac", {"cfg": cfg}, net=AsyncConfig()).round(
        u, None, key, 0)
    _same(r.delta, ref[0])
    _same(r.residuals, ref[1])
    assert int(r.state["pending_n"]) == 0
    assert r.stats["quorum_met"] == 1 and r.stats["late_folded"] == 0


# ---------------------------------------------------------------------------
# the stressed close against the reference
# ---------------------------------------------------------------------------

GRID = [(mode, policy, deadline) for mode in STALENESS_MODES
        for policy in LATE_POLICIES for deadline in (None, DEADLINE_S)]


def _grid_net(mode, policy, deadline):
    return dict(STRESS, staleness_mode=mode, late_policy=policy,
                round_deadline_s=deadline, **MODE_KW[mode])


@pytest.mark.parametrize("mode,policy,deadline", GRID)
def test_async_round_bitwise(mode, policy, deadline):
    """Two rounds under impairments, the second folding the first's carry:
    every output of the port's core is the jitted reference's."""
    net_kw = _grid_net(mode, policy, deadline)
    u = _u(0)
    port = _port_rounds(_cfg_kw(), net_kw, u)
    ref = _ref_rounds(_cfg_kw(), net_kw, u)
    for p, r in zip(port, ref):
        _same_async_round(p, r)
    aux0, aux1 = port[0][2], port[1][2]
    assert int(aux0["late_folded"]) + int(aux0["late_bounced"]) > 0
    if policy == "fold":
        assert int(aux1["folded_in"]) == int(port[0][3]["pending_n"]) > 0
    if policy == "bounce":
        assert int(aux0["late_folded"]) == 0
    if mode == "cap" and policy == "fold":
        assert int(aux0["late_folded"]) > 0 and int(aux0["late_bounced"]) > 0
    if deadline is not None:
        assert int(aux1["quorum_met"]) == 0


def test_late_updates_never_dropped():
    """Every announced uploader is committed, folded or bounced, and a
    bounced client's residual is its whole update."""
    u = _u(0)
    (_, _, aux, carry), = _port_rounds(_cfg_kw(), _grid_net(
        "constant", "fold", None), u, rounds=1)
    n_fold, n_bounce = int(aux["late_folded"]), int(aux["late_bounced"])
    assert n_fold > 0
    assert int(aux["n_up"]) + n_fold + n_bounce == int(aux["n_up_wire"])
    assert int(carry["pending_n"]) == n_fold
    (_, rb, auxb, carryb), = _port_rounds(_cfg_kw(), _grid_net(
        "constant", "bounce", None), u, rounds=1)
    assert int(auxb["late_bounced"]) == n_fold + n_bounce
    assert int(carryb["pending_n"]) == 0
    bounced = (np.isfinite(auxb["t_done"].numpy())
               & ~auxb["uploaders"].numpy())
    assert bounced.any()
    _same(rb[torch.from_numpy(bounced)], torch.from_numpy(u)[bounced])


def test_async_transport_stats_and_state():
    """Through ``PacketTransport``: the stats carry the async fields (two
    of them floats), the carry rides ``state`` into the next round, and
    the wire bytes count the announced uploaders."""
    net = AsyncConfig(**_grid_net("poly", "fold", None))
    tp = PacketTransport("fediac", {"cfg": FediACConfig(**_cfg_kw())},
                         net=net, rates=np.full(N, RATES),
                         local_train_s=TRAIN_S)
    u = torch.from_numpy(_u(0))
    key = prng.PRNGKey(KEY_SEED, device="cpu")
    r1 = tp.round(u, None, key, 0)
    r2 = tp.round(u, r1.state, key, 1)
    for k in ASYNC_STAT_FIELDS:
        assert k in r1.stats, k
        want = float if k in ("staleness_s_sum", "carry_weight") else int
        assert type(r1.stats[k]) is want, k
    assert r1.stats["late_folded"] > 0
    assert r2.stats["folded_in"] == r1.stats["late_folded"]
    tr = r1.traffic
    n_wire = r1.n_active + r1.stats["late_folded"] + r1.stats["late_bounced"]
    assert r1.upload_bytes >= tr.phase2_bytes * n_wire > tr.phase2_bytes \
        * r1.n_active


# ---------------------------------------------------------------------------
# the floating-point forms the reference's compiled round fixes
# ---------------------------------------------------------------------------

def test_drain_tie_order_bitwise():
    """Each window's arrivals are clamped to its open time, so after the
    first window many tie there, and masked packets tie at +inf: the
    per-packet departures follow the stable order among ties, as
    ``jnp.argsort`` gives it."""
    rng = np.random.default_rng(4)
    arr = np.round(rng.random((5, 12)) * 40).astype(np.float32) / 1000
    arr[:, 6:] = np.minimum(arr[:, 6:], 0.01)   # ties at window 1's open
    arr[1] = np.inf                              # a masked client
    arr[3, ::3] = np.inf
    pkt_window = np.repeat(np.arange(3), 4)
    svc = np.float32(1e-3)
    want = jax.jit(lambda a: j_departures(a, pkt_window, 3, svc, 0.002))(
        jnp.asarray(arr))
    got = _per_packet_departures(torch.from_numpy(arr), pkt_window, 3,
                                 torch.tensor(svc), 0.002)
    for g, w in zip(got[:2], want[:2]):
        _same(g, w)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=WAIT_RTOL)
    assert int(got[3]) == int(want[3])


def test_late_buffer_sum_is_fused():
    """``sum(q * w[:, None], axis=0)`` under jit is an in-order chain of
    fused multiply-adds from +0.0; the plain product-then-sum misses it."""
    rng = np.random.default_rng(5)
    q = rng.integers(-2000, 2000, size=(N, 4000)).astype(np.int32)
    w = rng.random(N).astype(np.float32)
    w[[1, 4]] = 0.0
    want = jax.jit(lambda a, b: jnp.sum(a.astype(jnp.float32) * b[:, None],
                                        axis=0))(q, w)
    qt, wt = torch.from_numpy(q), torch.from_numpy(w)
    _same(_weighted_client_sum(qt, wt), want)
    plain = (qt.to(torch.float32) * wt[:, None]).sum(0)
    assert not np.array_equal(_bits(plain), _bits(want))


@pytest.mark.parametrize("gamma", [0.0, 0.5, 1.0, 1.7, 3.7, 8.0, 40.0])
def test_poly_weight_pow_bitwise(gamma):
    """``(1 + max(s, 0)) ** -gamma`` is XLA's float32 ``pow`` (the C
    library's ``powf``), replayed in float64 by ``xla_math.pow``; torch's
    ``pow`` misses it by an ulp on some inputs, and XLA flushes subnormal
    results to zero."""
    rng = np.random.default_rng(6)
    s = np.concatenate([rng.random(4000) * 20, rng.random(4000) * 1e-3,
                        rng.random(1000) * 1e5, [-1.0, 0.0, np.inf]]
                       ).astype(np.float32)
    want = jax.jit(lambda a, g: (1.0 + jnp.maximum(a, 0.0)) ** (-g))(
        jnp.asarray(s), jnp.float32(gamma))
    x = 1.0 + torch.clamp_min(torch.from_numpy(s), 0.0)
    _same(xla_math.pow(x, -torch.tensor(gamma, dtype=torch.float32)), want)


def test_rescale_close_bitwise():
    """The rescale register close: the async round under it is the
    reference's bit for bit (its on-time rows cannot overflow: f is scaled
    for every announced uploader), and a window that did overflow comes
    back as mantissa x 2^shift, 2^shift built from its bits, equal to the
    reference's ``summed * exp2(shift)`` under jit at every shift the
    bank can need (0..12 for N <= 2,048)."""
    net_kw = dict(_grid_net("constant", "fold", None),
                  register_policy="rescale")
    kw = _cfg_kw(bits=31)
    u = _u(3)
    port = _port_rounds(kw, net_kw, u)
    for p, r in zip(port, _ref_rounds(kw, net_kw, u)):
        _same_async_round(p, r)
    rng = np.random.default_rng(7)
    summed = rng.integers(-2 ** 31, 2 ** 31, 13 * 64).astype(np.int32)
    shift = np.repeat(np.arange(13, dtype=np.int32), 64)
    want = jax.jit(lambda a, b: a.astype(jnp.float32)
                   * jnp.exp2(b.astype(jnp.float32)))(summed, shift)
    _same(_rescale_to_float(torch.from_numpy(summed),
                            torch.from_numpy(shift)), want)


def test_quorum_count_float32_half_even():
    """``round(float32(quorum_frac) * n_up)`` in float32, half to even: at
    (0.59, 50) and (0.7, 45) it differs from Python's float64 rounding."""
    qs = np.arange(1, 101, dtype=np.float64) / 100
    ns = np.arange(0, 65, dtype=np.int32)
    qg, ng = np.meshgrid(qs.astype(np.float32), ns, indexing="ij")

    def ref(q, n):
        return jnp.clip(jnp.round(q * n.astype(jnp.float32)).astype(
            jnp.int32), 1, jnp.maximum(n, 1))

    want = np.asarray(jax.jit(ref)(qg, ng))
    got = _quorum_count(torch.from_numpy(qg), torch.from_numpy(ng))
    np.testing.assert_array_equal(got.numpy(), want)
    for q, n in ((0.59, 50), (0.7, 45)):
        i, j = int(round(q * 100)) - 1, n
        assert int(got[i, j]) != round(q * n)


def test_carry_fold_divisions_bitwise():
    """``s``, ``base`` and ``folded`` divide tensor by tensor: a round
    closed by the deadline with nobody on time applies the carry alone
    (``folded`` over the carried weight), and a round with both folds the
    carry into the on-time sum; each bitwise the reference."""
    net_kw = _grid_net("poly", "fold", DEADLINE_S)
    u = _u(0)
    port = _port_rounds(_cfg_kw(), net_kw, u, rounds=3)
    ref = _ref_rounds(_cfg_kw(), net_kw, u, rounds=3)
    for p, r in zip(port, ref):
        _same_async_round(p, r)
    n_on = [int(p[2]["n_up"]) for p in port]
    folded_in = [int(p[2]["folded_in"]) for p in port]
    assert 0 in n_on[1:] and folded_in[1] > 0
    assert any(n > 0 and f > 0 for n, f in zip(n_on, folded_in))


# ---------------------------------------------------------------------------
# AsyncServer: the eager host oracle
# ---------------------------------------------------------------------------

def test_async_server_matches_tensor_close_and_reference():
    net_kw = _grid_net("cap", "fold", None)
    (_, _, aux, _), = _port_rounds(_cfg_kw(), net_kw, _u(0), rounds=1)
    t_done = aux["t_done"].numpy()
    start = float(aux["phase1_s"])
    out = AsyncServer(AsyncConfig(**net_kw)).run_round(t_done, start)
    jout = JServer(JAsync(**net_kw)).run_round(t_done, start)
    assert np.float32(out["t_close"]) == aux["t_close"].numpy()
    np.testing.assert_array_equal(out["on_time"], aux["uploaders"].numpy())
    assert int(out["late_fold"].sum()) == int(aux["late_folded"])
    assert int(out["late_bounce"].sum()) == int(aux["late_bounced"])
    for k in ("t_close", "folded_in", "occupancy"):
        assert out[k] == jout[k], k
    for k in ("on_time", "late_fold", "late_bounce"):
        np.testing.assert_array_equal(out[k], jout[k])


def test_async_server_carries_folds_across_rounds():
    t = np.array([1.0, 1.1, 5.0, np.inf], np.float32)
    srv = AsyncServer(AsyncConfig(quorum_frac=0.5), n_slots=8)
    out1 = srv.run_round(t)
    assert out1["t_close"] == np.float32(1.1)         # quorum: 2 of 3
    assert out1["folded_in"] == 0 and out1["occupancy"] == 1
    out2 = srv.run_round(np.array([2.0, 2.0, 2.0, 2.0], np.float32))
    assert out2["folded_in"] == 1 and out2["occupancy"] == 0
    assert srv.stats.late_folds == 1 and srv.stats.late_bounces == 0
    srv_b = AsyncServer(AsyncConfig(quorum_frac=0.5, late_policy="bounce"))
    srv_b.run_round(t)
    assert srv_b.stats.late_bounces == 1 and srv_b.stats.late_folds == 0


# ---------------------------------------------------------------------------
# the carry through the FL loop's checkpoint
# ---------------------------------------------------------------------------

def test_carry_checkpoint_roundtrip(tmp_path):
    (*_, carry), = _port_rounds(_cfg_kw(), _grid_net("poly", "fold", None),
                                _u(0), rounds=1)
    assert int(carry["pending_n"]) > 0
    path = str(tmp_path / "carry.npz")
    save_run_state(path, flat=torch.zeros(3), e_stack=torch.zeros(2, 3),
                   key=prng.PRNGKey(0, device="cpu"), agg_state=carry,
                   round_idx=1, t_cum=0.0, mb_cum=0.0,
                   history=fl_loop.FLHistory())
    st = load_run_state(path)
    for k in ("pending", "pending_w", "pending_n"):
        _same(st["agg_state"][k], carry[k], k)


#: the reference's resume harness: quorum 0.5, poly staleness, half the
#: clients straggling 6x, 95% participation
RESUME_NET = AsyncConfig(quorum_frac=0.5, straggler_frac=0.5,
                         straggler_slowdown=6.0, participation=0.95, seed=4,
                         staleness_mode="poly")


@pytest.fixture(scope="module")
def resume_task():
    data = classification(n=600, dim=16, n_classes=8, seed=0)
    train, test = data.test_split(0.25)
    clients = partition_dirichlet(train, 6, beta=0.5, seed=0)
    return clients, test, _async_fl(clients, test, 4)


def _async_fl(clients, test, rounds, ckpt=None, resume=False):
    return fl_loop.run_federated(clients, test, fl_loop.FLConfig(
        n_clients=6, rounds=rounds, local_steps=2, aggregator="fediac",
        agg_kwargs={"cfg": FediACConfig(a=2, bits=12)}, seed=0,
        transport="packet", net=RESUME_NET, ckpt_path=ckpt, resume=resume),
        hidden=(32,), device="cpu")


@pytest.mark.parametrize("kill_at", [1, 2, 3])
def test_kill_and_resume_bit_identical(resume_task, tmp_path, kill_at):
    """Kill the async run after any round and resume: the history is the
    uninterrupted run's bit for bit, and some kill point checkpoints a
    partly filled carry."""
    clients, test, full = resume_task
    ck = str(tmp_path / f"kill{kill_at}.npz")
    _async_fl(clients, test, kill_at, ckpt=ck)
    saved = load_run_state(ck)["agg_state"]
    resumed = _async_fl(clients, test, 4, ckpt=ck, resume=True)
    assert saved is not None and saved["pending_n"].dtype == np.int32
    assert resumed == full
    assert resumed.wall_clock == full.wall_clock
    assert resumed.traffic_mb == full.traffic_mb
    if kill_at == 1:
        assert int(saved["pending_n"]) > 0
