"""The packet transport of the port behind ``make_transport`` and the FL
loop, against the reference: every aggregator through
``PacketTransport`` (the five baselines on the priced generic path,
FediAC on the round core), the FL loop on packets (simulated wall-clock
and upload bytes exact, accuracy and loss within the FL loop's band), and
kill-and-resume on the packet transport bit for bit."""

import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core.fediac import FediACConfig as JCfg
from repro.data import classification, partition_dirichlet
from repro.netsim import NetConfig as JNet
from repro.training import fl_loop as jfl
from repro_torch.core import baselines as tb
from repro_torch.core.fediac import FediACConfig
from repro_torch.netsim import NetConfig, PacketTransport
from repro_torch.testing import key_to_torch
from repro_torch.training import fl_loop

AGGREGATORS = [("fediac", {}), ("fedavg", {}), ("switchml", {"bits": 12}),
               ("topk", {"k_frac": 0.01}), ("omnireduce", {}), ("libra", {})]
LOSSY = dict(loss=0.1, participation=0.5, straggler_frac=0.5,
             straggler_slowdown=3.0, n_leaves=3, memory_slots=64, seed=5)
HIDDEN = (32, 16)
N = 6


def _bits(x):
    a = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _kwargs(name, kw, ref):
    if name != "fediac":
        return dict(kw)
    return {"cfg": (JCfg if ref else FediACConfig)(a=2)}


@pytest.mark.parametrize("name,kw", AGGREGATORS, ids=[a for a, _ in
                                                       AGGREGATORS])
def test_make_transport_packet_every_aggregator(name, kw):
    """``make_transport(name, transport="packet", net=...)``: the same
    round as the reference's, lossy, with stragglers and a hierarchy."""
    u = jax.random.normal(jax.random.PRNGKey(1), (8, 2048)) ** 3
    key = jax.random.PRNGKey(7)
    rates = np.linspace(300.0, 2500.0, 8)
    ref = jb.make_transport(name, transport="packet", net=JNet(**LOSSY),
                            rates=rates, local_train_s=0.2,
                            **_kwargs(name, kw, True)).round(u, None, key, 3)
    tp = tb.make_transport(name, transport="packet", net=NetConfig(**LOSSY),
                           rates=rates, local_train_s=0.2,
                           **_kwargs(name, kw, False))
    assert isinstance(tp, PacketTransport)
    got = tp.round(torch.from_numpy(np.array(u)), None, key_to_torch(key), 3)
    np.testing.assert_array_equal(_bits(got.delta), _bits(ref.delta))
    np.testing.assert_array_equal(_bits(got.residuals), _bits(ref.residuals))
    assert got.wall_clock_s == ref.wall_clock_s
    assert got.upload_bytes == ref.upload_bytes
    assert got.n_active == ref.n_active
    assert got.stats.keys() == ref.stats.keys()
    for k, v in ref.stats.items():
        if k == "mean_wait_s":
            np.testing.assert_allclose(got.stats[k], v, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got.stats[k], v)
    assert 0 < got.n_active < 8


def test_round_result_to_metrics_matches_reference():
    """The round's metric emission: every scalar stat and the derived
    gauges of the reference's; the two norms are float sums in another
    order."""
    u = jax.random.normal(jax.random.PRNGKey(2), (8, 2048)) ** 3
    key = jax.random.PRNGKey(4)
    want = jb.make_transport("fediac", transport="packet", net=JNet(**LOSSY),
                             cfg=JCfg(a=2)).round(u, None, key, 1).to_metrics()
    got = tb.make_transport("fediac", transport="packet",
                            net=NetConfig(**LOSSY), cfg=FediACConfig(a=2)
                            ).round(torch.from_numpy(np.array(u)), None,
                                    key_to_torch(key), 1).to_metrics()
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def small_fl():
    data = classification(n=1500, dim=16, n_classes=10, seed=0)
    train, test = data.test_split(0.25)
    return partition_dirichlet(train, N, beta=0.5, seed=0), test


def _flcfg(mod, cfg_cls, **kw):
    base = dict(n_clients=N, rounds=3, local_steps=2, batch=16,
                aggregator="fediac", agg_kwargs={"cfg": cfg_cls(a=2)}, seed=0)
    base.update(kw)
    return mod.FLConfig(**base)


def _port_run(small_fl, **kw):
    clients, test = small_fl
    return fl_loop.run_federated(clients, test,
                                 _flcfg(fl_loop, FediACConfig, **kw),
                                 hidden=HIDDEN, device="cpu")


@pytest.mark.parametrize("net_kw", [{}, dict(loss=0.05, participation=0.5,
                                              seed=3)],
                         ids=["lossless", "lossy"])
def test_fl_packet_matches_reference(small_fl, net_kw):
    """The FL loop on packets against the reference's: the simulated
    wall-clock and the traffic (exact upload bytes) are the reference's
    to the bit; accuracy and loss within the FL loop's band (the local-SGD
    matmuls differ by float32 rounding)."""
    clients, test = small_fl
    h_j = jfl.run_federated(clients, test, _flcfg(
        jfl, JCfg, transport="packet", net=JNet(**net_kw)), hidden=HIDDEN)
    h_t = _port_run(small_fl, transport="packet", net=NetConfig(**net_kw))
    assert h_t.wall_clock == h_j.wall_clock
    assert h_t.traffic_mb == h_j.traffic_mb
    np.testing.assert_allclose(h_t.acc, h_j.acc, atol=2 / len(test.y))
    np.testing.assert_allclose(h_t.loss, h_j.loss, rtol=1e-4)


def test_fl_packet_transport_matches_memory(small_fl):
    """Lossless full-participation FL through packets: the memory run's
    learning trajectory and traffic, a wall-clock near the analytic one."""
    h_mem = _port_run(small_fl)
    h_pkt = _port_run(small_fl, transport="packet", net=NetConfig())
    assert h_mem.acc == h_pkt.acc and h_mem.loss == h_pkt.loss
    assert h_mem.traffic_mb == h_pkt.traffic_mb
    ratio = h_pkt.wall_clock[-1] / h_mem.wall_clock[-1]
    assert 0.65 < ratio < 1.55          # the reference's FL-level band


def test_per_round_traffic_mb_regression(small_fl):
    """Upload from the active clients plus the broadcast to all N — not
    the same term added twice."""
    h = _port_run(small_fl, rounds=2, local_steps=1, aggregator="fedavg",
                  agg_kwargs={})
    d = 24 * HIDDEN[0] + HIDDEN[0] + HIDDEN[0] * HIDDEN[1] + HIDDEN[1] \
        + HIDDEN[1] * 10 + 10
    per_round = (4 * d * N + 4 * d * N) / 1e6
    assert h.traffic_mb[0] == pytest.approx(per_round)
    assert h.traffic_mb[1] == pytest.approx(2 * per_round)


def test_fl_lossy_partial_still_learns_and_resumes(small_fl, tmp_path):
    """A lossy, partial-participation packet run learns, its clock always
    advances, and a run killed after round 3 and resumed from its
    checkpoint is the uninterrupted run bit for bit."""
    kw = dict(rounds=8, transport="packet",
              net=NetConfig(loss=0.05, participation=0.5, seed=3))
    h = _port_run(small_fl, **kw)
    assert h.loss[-1] < h.loss[0]
    assert all(np.diff(h.wall_clock) > 0)
    path = str(tmp_path / "run.ckpt")
    killed = _port_run(small_fl, **{**kw, "rounds": 3}, ckpt_path=path)
    assert len(killed) == 3
    resumed = _port_run(small_fl, **kw, ckpt_path=path, resume=True)
    assert resumed == h
    assert resumed.wall_clock == h.wall_clock
    assert resumed.traffic_mb == h.traffic_mb
