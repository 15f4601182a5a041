"""The port's trimmed-mean / median close and its seed-revision oracle
against the reference, bitwise.

``trim_count`` and ``trimmed_sum`` get random int32 slot values with dead
rows; the reference's pinned cases are mirrored; the whole
``aggregate_stack`` runs under ``robust_agg="trim"`` and ``"median"`` in
all four vote x compact mode pairs, the fused kernels off and on (their
plain versions on the CPU; the reference's Pallas kernels in interpret
mode).  ``aggregate_stack_seed``, the slow per-client oracle, is held to
the reference's and to the port's own ``aggregate_stack``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fediac as jfediac
from repro.core import robust_agg as jrobust
from repro.core import seed_ref as jseed
from repro_torch.core import engines, fediac, robust_agg, seed_ref
from repro_torch.testing import key_to_torch

MODES = [("topk", "topk"), ("topk", "block"),
         ("threshold", "topk"), ("threshold", "block")]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _updates(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d))
            * rng.exponential(1.0, d)).astype(np.float32)


def _cfgs(kernels=False, **kw):
    return (jfediac.FediACConfig(use_pallas=kernels, **kw),
            fediac.FediACConfig(engine=engines.EngineSpec(use_pallas=kernels),
                                **kw))


# ---------------------------------------------------------------------------
# trim_count / trimmed_sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["trim", "median"])
def test_trim_count_bitwise(mode):
    for frac in (0.0, 0.1, 0.2, 0.25, 0.3333, 0.49):
        for n_live in range(0, 34):
            got = robust_agg.trim_count(mode, frac, n_live)
            want = jrobust.trim_count(mode, frac, n_live)
            assert got.dtype == torch.int32 and got.shape == ()
            assert int(got) == int(want), (mode, frac, n_live)


@pytest.mark.parametrize("seed", range(4))
def test_trimmed_sum_bitwise(seed):
    rng = np.random.default_rng(seed)
    n, c = 9, 257
    v = rng.integers(-2**20, 2**20, size=(n, c)).astype(np.int32)
    v[:, ::3] = v[0, ::3]                 # equal values: client-order ties
    v[2, 5] = np.iinfo(np.int32).max      # a live value at the sentinel
    live = rng.random(n) < 0.7
    live[1] = True
    for t in range(0, int(live.sum()) // 2 + 1):
        got, kept = robust_agg.trimmed_sum(torch.from_numpy(v),
                                           torch.from_numpy(live), t)
        want, kept_j = jrobust.trimmed_sum(jnp.asarray(v), jnp.asarray(live),
                                           t)
        assert got.dtype == torch.int32 and kept.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(kept) == int(kept_j)


def test_trim_zero_is_masked_sum():
    rng = np.random.default_rng(7)
    v = rng.integers(-2**20, 2**20, size=(8, 33)).astype(np.int32)
    for n_live in range(1, 9):
        live = rng.permutation(np.arange(8)) < n_live
        s, kept = robust_agg.trimmed_sum(torch.from_numpy(v),
                                         torch.from_numpy(live), 0)
        np.testing.assert_array_equal(s.numpy(),
                                      np.where(live[:, None], v, 0).sum(0))
        assert int(kept) == n_live


def test_median_close_exact_values():
    live5 = torch.ones(5, dtype=torch.bool)
    v5 = torch.tensor([[5], [1], [9], [3], [7]], dtype=torch.int32)
    t5 = robust_agg.trim_count("median", 0.0, 5)
    assert int(t5) == 2
    s, kept = robust_agg.trimmed_sum(v5, live5, t5)
    assert int(s[0]) == 5 and int(kept) == 1
    v4 = torch.tensor([[4], [1], [10], [7]], dtype=torch.int32)
    t4 = robust_agg.trim_count("median", 0.0, 4)
    assert int(t4) == 1
    s, kept = robust_agg.trimmed_sum(v4, torch.ones(4, dtype=torch.bool), t4)
    assert int(s[0]) == 11 and int(kept) == 2


def test_trim_dead_rows_and_tie_break():
    v = torch.tensor([[2**31 - 1], [3], [5]], dtype=torch.int32)
    live = torch.tensor([False, True, True])
    s, kept = robust_agg.trimmed_sum(v, live, 0)
    assert int(s[0]) == 8 and int(kept) == 2
    veq = torch.full((4, 1), 7, dtype=torch.int32)
    s, kept = robust_agg.trimmed_sum(veq, torch.ones(4, dtype=torch.bool), 1)
    assert int(s[0]) == 14 and int(kept) == 2
    assert int(robust_agg.trim_count("trim", 0.49, 2)) == 0
    assert int(robust_agg.trim_count("trim", 0.9, 9)) == 4
    assert int(robust_agg.trim_count("median", 0.0, 1)) == 0


def test_trimmed_mean_bounded_by_honest_range():
    n, c, f = 10, 17, 3
    rng = np.random.default_rng(5)
    honest = rng.integers(-1000, 1000, size=(n, c))
    v = honest.copy()
    bad = rng.choice(n, size=f, replace=False)
    v[bad] = rng.choice([-2**28, 2**28 - 1], size=(f, c))
    s, kept = robust_agg.trimmed_sum(torch.from_numpy(v.astype(np.int32)),
                                     torch.ones(n, dtype=torch.bool), f)
    mean = s.numpy().astype(np.float64) / int(kept)
    good = np.ones(n, bool)
    good[bad] = False
    assert np.all(mean >= honest[good].min(0))
    assert np.all(mean <= honest[good].max(0))


def test_client_sum_and_kept_count():
    q = torch.from_numpy(np.arange(40, dtype=np.int32).reshape(8, 5))
    s, kept = robust_agg.client_sum(q, fediac.FediACConfig())
    assert kept == 8 and s.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), q.numpy().sum(0))
    cfg = fediac.FediACConfig(robust_agg="trim", trim_frac=0.25)
    s, kept = robust_agg.client_sum(q, cfg)
    assert int(kept) == 4 and kept.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), q.numpy()[2:6].sum(0))
    assert int(robust_agg.kept_count(cfg, 8)) == 4
    assert robust_agg.kept_count(fediac.FediACConfig(), 8) == 8
    assert int(robust_agg.kept_count(
        fediac.FediACConfig(robust_agg="median"), 8)) == 2


@pytest.mark.parametrize("frac", [-0.1, 0.5, 0.7])
def test_trim_frac_validated(frac):
    with pytest.raises(ValueError, match="trim_frac"):
        fediac.FediACConfig(robust_agg="trim", trim_frac=frac)


# ---------------------------------------------------------------------------
# the whole round under the robust closes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("modes", MODES, ids=["-".join(m) for m in MODES])
@pytest.mark.parametrize("close", [("trim", 0.2), ("median", 0.0)],
                         ids=["trim", "median"])
def test_aggregate_stack_robust_bitwise(close, modes, kernels):
    n, d = 7, 4096
    u = _updates(n, d, seed=len(modes[0]) + 3 * kernels)
    key = jax.random.PRNGKey(17)
    jc, tc = _cfgs(kernels, vote_mode=modes[0], compact_mode=modes[1], a=2,
                   block_size=512, robust_agg=close[0], trim_frac=close[1])
    dj, rj, cj, tj = jfediac.aggregate_stack(jnp.asarray(u), jc, key)
    dt, rt, ct, tt = fediac.aggregate_stack(torch.from_numpy(u), tc,
                                            key_to_torch(key))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(_bits(dt.numpy()), _bits(dj))
    np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))
    assert tt == fediac.TrafficStats(**vars(tj))
    # the card's check: phase 2 and the close from given counts
    d2, r2 = fediac.aggregate_from_counts(torch.from_numpy(u), tc,
                                          key_to_torch(key), ct)
    assert torch.equal(d2, dt) and torch.equal(r2, rt)


@pytest.mark.parametrize("vote_chunk", [1, 4])
def test_aggregate_stack_trim_chunked_bitwise(vote_chunk):
    n, d = 6, 8192
    u = _updates(n, d, seed=vote_chunk)
    key = jax.random.PRNGKey(2)
    jc, tc = _cfgs(True, vote_chunk=vote_chunk, robust_agg="trim",
                   trim_frac=0.2)
    dj, rj, _, _ = jfediac.aggregate_stack(jnp.asarray(u), jc, key)
    dt, rt, _, _ = fediac.aggregate_stack(torch.from_numpy(u), tc,
                                          key_to_torch(key))
    np.testing.assert_array_equal(_bits(dt.numpy()), _bits(dj))
    np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))


@pytest.mark.parametrize("kernels", [False, True])
def test_aggregate_stack_trim_zero_identical_to_sum(kernels):
    u = torch.from_numpy(_updates(8, 3000, seed=11))
    key = torch.tensor([0, 7])
    spec = engines.EngineSpec(use_pallas=kernels)
    for vm, cm in MODES:
        base = dict(vote_mode=vm, compact_mode=cm, a=2, bits=12, engine=spec)
        ref = fediac.aggregate_stack(u, fediac.FediACConfig(**base), key)
        got = fediac.aggregate_stack(
            u, fediac.FediACConfig(robust_agg="trim", trim_frac=0.0, **base),
            key)
        for r, g in zip(ref[:3], got[:3]):
            assert torch.equal(r, g)
        assert ref[3] == got[3]


def test_allreduce_keeps_the_sum_close():
    """A sum on the wire cannot compute order statistics: the allreduce
    refuses the robust closes before touching the process group."""
    for mode in ("trim", "median"):
        cfg = fediac.FediACConfig(robust_agg=mode)
        with pytest.raises(ValueError, match="robust_agg"):
            fediac.fediac_allreduce(torch.zeros(64), torch.zeros(64),
                                    torch.tensor([0, 0]), cfg)


# ---------------------------------------------------------------------------
# the seed-revision oracle
# ---------------------------------------------------------------------------

SEED_CFGS = {
    "default": {},
    "tight": dict(a=2, bits=14, k_frac=0.1, capacity_frac=0.1),
    "chunked": dict(vote_chunk=4),
    "threshold-topk": dict(vote_mode="threshold"),
    "threshold-block": dict(vote_mode="threshold", compact_mode="block",
                            block_size=512),
    "topk-block": dict(compact_mode="block", block_size=256),
}


@pytest.mark.parametrize("name", list(SEED_CFGS))
def test_seed_oracle_bitwise(name):
    jc, tc = _cfgs(False, **SEED_CFGS[name])
    u = np.array(jax.random.normal(jax.random.PRNGKey(1), (6, 8192)) ** 3)
    key = jax.random.PRNGKey(7)
    ds, rs, cs = jseed.aggregate_stack_seed(jnp.asarray(u), jc, key)
    ts = seed_ref.aggregate_stack_seed(torch.from_numpy(u), tc,
                                       key_to_torch(key))
    for got, want in zip(ts, (ds, rs, cs)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert ts[2].dtype == torch.int32
    # the port's engine against the port's oracle
    de, re_, ce, _ = fediac.aggregate_stack(torch.from_numpy(u), tc,
                                            key_to_torch(key))
    for got, want in zip((de, re_, ce), ts):
        assert torch.equal(got, want)


def test_seed_oracle_matches_engine_with_ties():
    tc = fediac.FediACConfig()
    u = np.round(_updates(4, 20_000, seed=3) * 4) / 4
    key = torch.tensor([0, 7])
    ts = seed_ref.aggregate_stack_seed(torch.from_numpy(u), tc, key)
    te = fediac.aggregate_stack(torch.from_numpy(u), tc, key)
    for got, want in zip(te[:3], ts):
        assert torch.equal(got, want)
