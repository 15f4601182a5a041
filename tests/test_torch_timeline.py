"""The packet dataplane's timeline in the port against the reference's:
XLA's float32 prefix-sum order, the exponential draw, Poisson arrivals,
ARQ delays, the FIFO drains and the leaf -> root hierarchy — bitwise on
the CPU, except the mean wait, a float sum whose order differs (within
1e-6 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim import hierarchy as jh
from repro.netsim import timeline as jt
from repro.switch import SwitchProfile, client_rates, round_wall_clock
from repro_torch.core import prng, xla_math
from repro_torch.netsim import hierarchy as th
from repro_torch.netsim import timeline as tt
from repro_torch.testing import key_to_torch


def _bits(x):
    a = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref):
    np.testing.assert_array_equal(_bits(port), _bits(ref))


#: the mean wait sums float32 waits in another order than XLA's reduce
WAIT_RTOL = 1e-6


def _same_stats(port, ref):
    for field in ("completion_s", "n_packets"):
        _same(torch.as_tensor(getattr(port, field)),
              np.asarray(getattr(ref, field)))
    np.testing.assert_allclose(float(port.mean_wait_s),
                               float(ref.mean_wait_s), rtol=WAIT_RTOL)


# ---------------------------------------------------------------------------
# the two draws: XLA's prefix-sum order and the exponential
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [1, 15, 16, 17, 256, 257, 4097, 70_001])
def test_cumsum_bitwise_jnp_along_axis_1(length):
    rng = np.random.default_rng(length)
    x = rng.exponential(size=(3, length)).astype(np.float32)
    x[1] = rng.standard_normal(length).astype(np.float32)
    _same(xla_math.cumsum(torch.from_numpy(x), 1), jnp.cumsum(x, axis=1))


@pytest.mark.parametrize("length", [33, 100_003])
def test_cumsum_bitwise_jnp_flat_and_axis_0(length):
    rng = np.random.default_rng(length)
    x = rng.standard_normal(length).astype(np.float32)
    _same(xla_math.cumsum(torch.from_numpy(x), 0), jnp.cumsum(x))
    x2 = x[: length - length % 3].reshape(-1, 3)
    _same(xla_math.cumsum(torch.from_numpy(x2), 0), jnp.cumsum(x2, axis=0))


def test_cumsum_naive_orders_differ_from_jnp():
    """Why the port replays the order: neither a sequential float32 sum nor
    ``torch.cumsum`` gives ``jnp.cumsum``'s bits on a Poisson gap array."""
    x = np.random.default_rng(0).exponential(size=(4, 1000)).astype(
        np.float32)
    want = _bits(jnp.cumsum(x, axis=1))
    seq = _bits(np.cumsum(x, axis=1, dtype=np.float32))
    tor = _bits(torch.cumsum(torch.from_numpy(x), 1))
    n_seq, n_torch = int((seq != want).sum()), int((tor != want).sum())
    print(f"of {x.size}: {n_seq} differ from a sequential sum, "
          f"{n_torch} from torch.cumsum")
    assert n_seq > 0 and n_torch > 0


@pytest.mark.parametrize("shape", [(8, 517), (32, 3001)])
def test_exponential_bitwise(shape):
    key = jax.random.PRNGKey(sum(shape))
    _same(prng.exponential(key_to_torch(key), shape),
          jax.random.exponential(key, shape, jnp.float32))


# ---------------------------------------------------------------------------
# arrivals, loss, ARQ, the deadline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", ["scalar", "rows"])
def test_poisson_arrivals_bitwise(start):
    key = jax.random.PRNGKey(4)
    rates = client_rates(6, 1)
    st = (0.1 if start == "scalar"
          else np.float32(0.1) * np.array([1, 3, 1, 3, 2.7, 1], np.float32))
    want = jt.poisson_arrivals(key, rates, 700, st)
    got = tt.poisson_arrivals(key_to_torch(key), rates, 700,
                              torch.as_tensor(st))
    _same(got, want)


def test_lose_packets_bitwise():
    key = jax.random.PRNGKey(9)
    _same(tt.lose_packets(key_to_torch(key), (5, 300), 0.3),
          jt.lose_packets(key, (5, 300), 0.3))


@pytest.mark.parametrize("loss", ["concrete", "traced", "zero"])
def test_retransmit_delays_bitwise(loss):
    key = jax.random.PRNGKey(5)
    if loss == "traced":
        want = jax.jit(lambda p: jt.retransmit_delays(key, (16, 50), p, 0.05,
                                                      16))(jnp.float32(0.25))
    else:
        p = 0.25 if loss == "concrete" else 0.0
        want = jt.retransmit_delays(key, (16, 50), p, 0.05, 16)
    p = 0.0 if loss == "zero" else 0.25
    got = tt.retransmit_delays(key_to_torch(key), (16, 50), p, 0.05, 16)
    for g, w in zip(got, want):
        _same(g, w)
    if loss == "zero":
        assert int(got[1].sum()) == 0 and float(got[0].max()) == 0.0
    else:
        assert int(got[1].sum()) > 0


def test_vote_deadline_boundary_is_inclusive():
    arr = torch.tensor([[0.1, 0.2, 0.30000001]], dtype=torch.float32)
    assert tt.deadline_mask(arr, 0.2).tolist() == [[True, True, False]]
    assert bool(tt.deadline_mask(torch.tensor(0.30000001), 0.30000001))


# ---------------------------------------------------------------------------
# the FIFO drains
# ---------------------------------------------------------------------------

def test_mg1_departures_bitwise_with_masks():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, 300).astype(np.float32)
    a[rng.random(300) < 0.2] = np.inf
    for svc in (0.003, rng.uniform(0.001, 0.01, 300).astype(np.float32)):
        _same(tt.mg1_departures(torch.from_numpy(a), torch.as_tensor(svc)),
              jt.mg1_departures(a, svc))


def test_mg1_recursion_matches_sequential():
    """The max-plus closed form equals the textbook FIFO recursion."""
    rng = np.random.default_rng(0)
    a = np.sort(rng.uniform(0, 1, 200))
    s = rng.uniform(0.001, 0.01, 200)
    d_vec = tt.mg1_departures(torch.from_numpy(a), torch.from_numpy(s)).numpy()
    d_seq = np.empty_like(d_vec)
    prev = 0.0
    for k in range(a.size):
        prev = max(np.float32(a[k]), prev) + np.float32(s[k])
        d_seq[k] = prev
    np.testing.assert_allclose(d_vec, d_seq, rtol=1e-4)


def test_mg1_masked_packets_never_disturb_finite_prefix():
    a = np.sort(np.random.default_rng(1).uniform(0, 1, 50))
    d_live = tt.mg1_departures(torch.from_numpy(a), 0.01)
    padded = np.concatenate([a, np.full(20, np.inf)])
    d_pad = tt.mg1_departures(torch.from_numpy(padded), 0.01)
    _same(d_pad[:50], d_live)
    assert bool(torch.isinf(d_pad[50:]).all())


@pytest.mark.parametrize("case", ["empty", "all_masked", "live"])
def test_drain_fifo(case):
    arr = {"empty": np.zeros((0,), np.float32),
           "all_masked": np.full((3, 4), np.inf, np.float32),
           "live": np.random.default_rng(3).uniform(0, 1, (3, 40)).astype(
               np.float32)}[case]
    got = tt.drain_fifo(torch.from_numpy(arr), 1e-3)
    want = jt.drain_fifo(arr, 1e-3)
    _same_stats(got, want)
    if case != "live":
        assert float(got.completion_s) == 0.0


def test_windowed_drain_bitwise_and_serializes_windows():
    key = jax.random.PRNGKey(0)
    arr = jt.poisson_arrivals(key, np.full(4, 1000.0), 100, 0.0)
    arr = arr.at[1].set(jnp.inf)                   # a masked client row
    arr_t = torch.from_numpy(np.array(arr))
    pkt_window = (np.arange(100) >= 50).astype(np.int32)
    comp, st = tt.windowed_drain(arr_t, pkt_window, 2, 1e-4, not_before=0.01)
    comp_j, st_j = jt.windowed_drain(arr, pkt_window, 2, 1e-4,
                                     not_before=0.01)
    _same(comp, comp_j)
    _same_stats(st, st_j)
    assert comp[1] >= comp[0]
    one, _ = tt.windowed_drain(arr_t, np.zeros(100, np.int32), 1, 1e-4)
    assert float(st.completion_s) >= float(one[-1]) * (1 - 1e-6)


@pytest.mark.parametrize("n_leaves", [1, 3])
@pytest.mark.parametrize("masked", [(), (1,), (0, 3, 6)])
def test_drain_hierarchy_bitwise(n_leaves, masked):
    """Per-leaf windowed drains and the root queue; a leaf whose rows are
    all masked forwards nothing."""
    key = jax.random.PRNGKey(11)
    arr = np.array(jt.poisson_arrivals(key, client_rates(7, 2), 60, 0.05))
    arr[list(masked)] = np.inf
    leaf_of = jh.leaf_assignment(7, n_leaves)
    pkt_window = np.minimum(np.arange(60) // 25, 2)
    args = (leaf_of, pkt_window, 3, n_leaves, 2e-4, 4)
    got = th.drain_hierarchy(torch.from_numpy(arr), *args, not_before=0.02)
    want = jh.drain_hierarchy(arr, *args, not_before=0.02)
    _same_stats(got, want)


def test_download_time_bitwise():
    for n in (6, 8, 20, 32):
        rates = client_rates(n, n).astype(np.float32)
        _same(tt.download_time(23, torch.from_numpy(rates)),
              jt.download_time(23, rates))


def test_simulated_wall_clock_matches_reference_and_analytic():
    """Bitwise the reference's sampled round; within 15% of the analytic
    model at 500 packets per client (its documented tolerance)."""
    rates = client_rates(20, 0)
    kw = dict(packets_per_client=500, download_packets=500, rates=rates,
              profile=SwitchProfile.high(), local_train_s=0.1)
    sims = []
    for i in range(5):
        key = jax.random.PRNGKey(i)
        sim = tt.simulate_round_time(key=key_to_torch(key), **kw)
        assert sim == jt.simulate_round_time(key=key, **kw)
        sims.append(sim)
    ana = round_wall_clock(**kw)
    assert abs(np.mean(sims) - ana) / ana < 0.15
