"""The port's baselines against the reference's, bitwise.

Each of the six aggregators of ``core/baselines.py`` gets the same numpy
update stack and the same key on both sides.  The stack holds exact zeros
and repeated magnitudes, so the tie order of every top-k (per client, and
libra's hot set) is exercised, and d = 4,099 is ragged against
omnireduce's block of 256.  N = 8 is the size the paper's figures use;
N = 6 is not a power of two, so a mean that divided by N instead of
multiplying by its float32 reciprocal (as ``jnp.mean`` does) would show.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core.fediac import FediACConfig as JConfig
from repro.data import classification, partition_dirichlet
from repro.training import fl_loop as jfl
from repro_torch.core import baselines as tb
from repro_torch.core.fediac import FediACConfig
from repro_torch.testing import key_to_torch
from repro_torch.training import fl_loop

NAMES = ("fedavg", "switchml", "topk", "omnireduce", "libra", "fediac")
D = 4099


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _updates(n, d, seed):
    """Heavy-tailed updates with exact zeros and repeated magnitudes."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((n, d)) ** 3).astype(np.float32)
    u[:, ::5] = 0.0
    u[:, 1::7] = np.round(u[:, 1::7] * 4) / 4
    u[::2, 2::11] = -u[::2, 2::11]
    return u


def _kwargs(name, ref):
    if name == "fediac":
        cls = JConfig if ref else FediACConfig
        return {"cfg": cls(a=2, bits=12)}
    return {"switchml": {"bits": 12}, "topk": {"k_frac": 0.01},
            "omnireduce": {"k_frac": 0.05, "block": 256},
            "libra": {"k_frac": 0.01, "hot_frac": 0.01}}.get(name, {})


def _assert_same(got, want):
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("n", [8, 6])
@pytest.mark.parametrize("name", NAMES)
def test_aggregator_bitwise(name, n):
    u = _updates(n, D, seed=n)
    ja = jb.make_aggregator(name, **_kwargs(name, True))
    ta = tb.make_aggregator(name, **_kwargs(name, False))
    js = ts = None
    for r in range(2):       # libra carries its heat state into round 2
        key = jax.random.PRNGKey(10 + r)
        dj, rj, js, tj, lj = ja(jnp.asarray(u), js, key)
        dt, rt, ts, tt, lt = ta(torch.from_numpy(u), ts, key_to_torch(key))
        _assert_same(dt, dj)
        _assert_same(rt, rj)
        assert dt.dtype == rt.dtype == torch.float32
        if js is None:
            assert ts is None
        else:
            _assert_same(ts, js)
        assert dataclasses.asdict(tt) == dataclasses.asdict(tj)
        assert dataclasses.asdict(lt) == dataclasses.asdict(lj)
        u = u - 0.5 * np.asarray(dj)[None]


@pytest.mark.parametrize("name", NAMES)
def test_aggregator_core_and_account_bitwise(name):
    n = 8
    u = _updates(n, D, seed=21)
    key = jax.random.PRNGKey(4)
    jcore, jacc = jb.make_aggregator_core(name, **_kwargs(name, True))
    tcore, tacc = tb.make_aggregator_core(name, **_kwargs(name, False))
    assert tcore.__name__ == f"{name}_core"
    assert tacc.__name__ == f"{name}_account"
    dj, rj, sj, aux_j = jcore(jnp.asarray(u), None, key, {})
    dt, rt, st, aux_t = tcore(torch.from_numpy(u), None, key_to_torch(key), {})
    _assert_same(dt, dj)
    _assert_same(rt, rj)
    if sj is not None:
        _assert_same(st, sj)
    assert sorted(aux_t) == sorted(aux_j)
    for k in aux_j:
        assert aux_t[k].dtype == torch.int32
        assert int(aux_t[k]) == int(aux_j[k])
    ints_j = {k: int(v) for k, v in aux_j.items()}
    ints_t = {k: int(v) for k, v in aux_t.items()}
    for got, want in zip(tacc(n, D, ints_t), jacc(n, D, ints_j)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_fediac_core_takes_the_threshold_override():
    n = 8
    u = _updates(n, D, seed=3)
    key = jax.random.PRNGKey(9)
    jcore, _ = jb.make_aggregator_core("fediac", cfg=JConfig())
    tcore, _ = tb.make_aggregator_core("fediac", cfg=FediACConfig())
    dj = jcore(jnp.asarray(u), None, key, {"a": jnp.int32(3)})[0]
    dt = tcore(torch.from_numpy(u), None, key_to_torch(key),
               {"a": torch.tensor(3, dtype=torch.int32)})[0]
    _assert_same(dt, dj)
    d_default = tcore(torch.from_numpy(u), None, key_to_torch(key), {})[0]
    assert not torch.equal(dt, d_default)


@pytest.mark.parametrize("k", [1, 2, 40])
def test_topk_mask_tie_order(k):
    """Among equal magnitudes the lower index is taken first, as
    ``lax.top_k`` takes it; torch.topk promises no such order."""
    u = np.zeros((3, 64), np.float32)
    u[0, [5, 9, 40]] = [2.0, -2.0, 2.0]
    u[1, ::3] = -1.0
    got = tb._topk_mask(torch.from_numpy(u), k).numpy()
    want = np.stack([np.asarray(jb._topk_mask(jnp.asarray(row), k))
                     for row in u])
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=1) == k).all()


def test_unknown_aggregator_and_transport():
    with pytest.raises(KeyError):
        tb.make_aggregator("no-such-aggregator")
    from repro_torch.netsim import PacketTransport
    assert isinstance(tb.make_transport("fedavg", transport="packet"),
                      PacketTransport)
    with pytest.raises(ValueError):
        tb.make_transport("fedavg", transport="pigeon")


# ---------------------------------------------------------------------------
# the paper's comparison through the FL loop
# ---------------------------------------------------------------------------

FL_DIMS = (24, 32, 16, 10)   # classification(dim=16) has 16 + 8 features


@pytest.fixture(scope="module")
def task():
    data = classification(n=1200, dim=16, n_classes=10, seed=0)
    train, test = data.test_split(0.2)
    return partition_dirichlet(train, 4, beta=0.5, seed=0), test


@pytest.mark.parametrize("name", NAMES)
def test_run_federated_each_aggregator_matches_reference(task, name):
    clients, test = task
    kw = dict(n_clients=4, rounds=3, local_steps=2, batch=16, aggregator=name)
    h_j = jfl.run_federated(clients, test, jfl.FLConfig(
        **kw, agg_kwargs=_kwargs(name, True)), hidden=FL_DIMS[1:-1])
    h_t = fl_loop.run_federated(clients, test, fl_loop.FLConfig(
        **kw, agg_kwargs=_kwargs(name, False)), hidden=FL_DIMS[1:-1],
        device="cpu")
    assert len(h_t) == 3
    assert h_t.traffic_mb == h_j.traffic_mb
    assert h_t.wall_clock == h_j.wall_clock
    # band: one test sample is 1/240 of the accuracy; the local-SGD
    # matmuls differ by float32 rounding only
    np.testing.assert_allclose(h_t.acc, h_j.acc, atol=2 / 240)
    np.testing.assert_allclose(h_t.loss, h_j.loss, rtol=1e-4)


def test_fl_traffic_order_of_the_paper(task):
    """The paper's headline, as the reference's
    ``test_fediac_traffic_beats_baselines`` asserts it: FediAC sends less
    than SwitchML, which sends less than FedAvg."""
    clients, test = task
    mb = {}
    for name, agg_kwargs in (("fediac", {"cfg": FediACConfig(a=2, bits=12)}),
                             ("switchml", {"bits": 12}), ("fedavg", {})):
        h = fl_loop.run_federated(clients, test, fl_loop.FLConfig(
            n_clients=4, rounds=2, local_steps=2, batch=16, aggregator=name,
            agg_kwargs=agg_kwargs), hidden=FL_DIMS[1:-1], device="cpu")
        mb[name] = h.traffic_mb[-1]
    assert mb["fediac"] < mb["switchml"] < mb["fedavg"]

