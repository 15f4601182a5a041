"""The port's coordinate-sharded round engine (``core/shard_engine.py``)
against the reference, bitwise.

The reference's own tests pin its ``aggregate_shard`` bitwise equal to its
``aggregate_stack`` on every mesh size (``tests/test_shard_engine.py``), so
holding the port's sharded round at any shard count against the
reference's ``aggregate_stack`` is that contract, in-process: every vote x
compact mode, 1, 3 and 8 shards, ragged widths and fewer coordinates than
shards, a tensor threshold ``a`` with the consensus floor off and armed,
shards wider than ``_PHASE2_CHUNK``, heavy vote ties across shard
boundaries, the int32 sort keys against the reference's uint32 ones, the
per-client compact buffers of ``shard_compress_stack``, and the engine
reached through ``EngineSpec("sharded", devices=...)`` from
``aggregate_round`` and from the FL loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fediac as jfediac
from repro.core import round_plan as jplan
from repro.core import shard_engine as jshard
from repro.data import classification, partition_dirichlet
from repro_torch.core import (engines, fediac, prng, selection, shard_engine,
                              voting)
from repro_torch.core.engines import EngineSpec
from repro_torch.core.quantize import scale_factor
from repro_torch.testing import key_to_torch
from repro_torch.training import fl_loop

KEY = jax.random.PRNGKey(7)
MODES = [("topk", "topk"), ("topk", "block"),
         ("threshold", "topk"), ("threshold", "block")]
#: the reference's 8-device test's config (tests/test_shard_engine.py)
SMALL = dict(k_frac=0.25, capacity_frac=0.3, bits=4, block_size=16)


def _u(n, d, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) ** 3).astype(np.float32)


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_rounds_equal(got, want):
    """(delta, residuals, counts) bitwise, and the traffic accounting."""
    for name, x, y in zip(("delta", "residuals", "counts"), got[:3], want[:3]):
        assert x.shape == tuple(y.shape), name
        np.testing.assert_array_equal(_np(x), _np(y), err_msg=name)
    want_traffic = want[3]
    if not isinstance(want_traffic, fediac.TrafficStats):
        want_traffic = fediac.TrafficStats(**vars(want_traffic))
    assert got[3] == want_traffic, "traffic stats"


def _shard_and_ref(u, devices, a=None, key=KEY, **kw):
    """The port's sharded round and the reference's ``aggregate_stack`` on
    the same inputs."""
    got = shard_engine.aggregate_shard(
        torch.from_numpy(u), fediac.FediACConfig(**kw), key_to_torch(key),
        a=None if a is None else torch.tensor(a, dtype=torch.int32),
        devices=devices)
    ref = jfediac.aggregate_stack(
        jnp.asarray(u), jfediac.FediACConfig(**kw), key,
        a=None if a is None else jnp.asarray(a, jnp.int32))
    return got, ref


# ---------------------------------------------------------------------------
# the round against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1001, 5])      # ragged; fewer than 8 shards
@pytest.mark.parametrize("devices", [1, 3, 8])
@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_shard_matches_reference_stack(vote_mode, compact_mode, devices, d):
    got, ref = _shard_and_ref(_u(5, d), devices, vote_mode=vote_mode,
                              compact_mode=compact_mode, **SMALL)
    _assert_rounds_equal(got, ref)


@pytest.mark.parametrize("devices", [1, 8])
@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_single_device_case_of_the_reference(vote_mode, compact_mode,
                                             devices):
    """The reference's ``test_single_device_bit_identical`` inputs."""
    u = np.random.default_rng(0).normal(size=(5, 120)).astype(np.float32)
    got, ref = _shard_and_ref(u, devices, key=jax.random.PRNGKey(4),
                              vote_mode=vote_mode, compact_mode=compact_mode,
                              k_frac=0.2, capacity_frac=0.25, bits=6,
                              block_size=16)
    _assert_rounds_equal(got, ref)


@pytest.mark.parametrize("devices", [1, 3])
@pytest.mark.parametrize("floor", [0, 10 ** 9])
def test_tensor_threshold_and_floor(floor, devices):
    """The reference's ``test_single_device_traced_threshold_and_floor``:
    ``a`` as an int32 0-dim tensor, the floor off and armed."""
    u = np.random.default_rng(1).normal(size=(5, 90)).astype(np.float32)
    got, ref = _shard_and_ref(u, devices, a=4, key=jax.random.PRNGKey(2),
                              k_frac=0.1, capacity_frac=0.2, bits=4,
                              consensus_floor=floor)
    _assert_rounds_equal(got, ref)


@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_shards_wider_than_the_phase2_chunk(monkeypatch, vote_mode,
                                            compact_mode):
    """The reference's ``test_chunked_inner_phase2_bit_identical``: one
    shard of 2 chunks and a tail, and two shards of a chunk and a tail;
    the top-k scores drawn in pieces of 2**20 elements, several a shard."""
    monkeypatch.setattr(voting, "SCORE_PIECE", 1 << 20)
    d, n = 2 * shard_engine._PHASE2_CHUNK + 70_000, 4
    u = np.random.default_rng(6).normal(size=(n, d)).astype(np.float32)
    kw = dict(k_frac=0.01, capacity_frac=0.02, bits=4, vote_mode=vote_mode,
              compact_mode=compact_mode)
    ref = jfediac.aggregate_stack(jnp.asarray(u), jfediac.FediACConfig(**kw),
                                  jax.random.PRNGKey(5))
    for devices in (1, 2):
        got = shard_engine.aggregate_shard(
            torch.from_numpy(u), fediac.FediACConfig(**kw),
            key_to_torch(jax.random.PRNGKey(5)), devices=devices)
        _assert_rounds_equal(got, ref)


@pytest.mark.parametrize("devices", [2, 3, 8])
def test_vote_ties_across_shards_fill_by_global_index(monkeypatch, devices):
    """Scores with heavy ties (a few distinct values), so the k-th score's
    tie class straddles shards: the sharded counts equal the stable top-k
    counts of the whole score matrix (``lax.top_k``'s rule), in the port
    and in the reference."""
    n, d, k_frac = 6, 997, 0.3
    rng = np.random.default_rng(3)
    scores = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    scores[:, ::5] = -np.inf          # the least key: never outranks a score
    whole = torch.from_numpy(scores)

    def tied(u, keys, start, total, *, piece=None):
        return whole[:, start:start + u.shape[1]].clone()

    monkeypatch.setattr(voting, "vote_scores", tied)
    cfg = fediac.FediACConfig(k_frac=k_frac)
    k = cfg.k(d)
    counts = shard_engine.aggregate_shard(
        torch.from_numpy(_u(n, d)), cfg, key_to_torch(KEY),
        devices=devices)[2]
    want = selection.topk_counts_stack(whole, k)
    np.testing.assert_array_equal(counts.numpy(), want.numpy())
    from repro.core import selection as jsel
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jsel.topk_counts_stack(jnp.asarray(scores),
                                                          k)))


def test_sort_keys_are_the_references_shifted():
    """The int32 keys are the reference's uint32 keys minus 2**31, so they
    order every float (signs, zero, subnormals, infinities, ties) as the
    reference's do."""
    x = np.array([-np.inf, -3.5, -1e-45, 0.0, 1e-45, 1e-38, 2.0, 2.0, np.inf,
                  -2.0, -2.0, 7.25, -np.finfo(np.float32).max,
                  np.finfo(np.float32).max], np.float32)
    x = np.concatenate([x, np.random.default_rng(0).standard_normal(
        4000).astype(np.float32) ** 3])
    got = shard_engine._f32_sort_keys_(torch.from_numpy(x.copy())).numpy()
    want = np.asarray(jshard._f32_sort_keys(jnp.asarray(x)))
    np.testing.assert_array_equal(got.astype(np.int64) + 2 ** 31,
                                  want.astype(np.int64))
    np.testing.assert_array_equal(np.argsort(got, kind="stable"),
                                  np.argsort(want, kind="stable"))


@pytest.mark.parametrize("piece", [3000, 12_288, 21])
def test_vote_scores_in_pieces_are_the_whole_draw(piece):
    """Scores drawn in pieces of any size, of the whole vector or of a
    column range of it, for a client stack and for one client: the
    whole draw's scores, which are the reference's."""
    u = _u(3, 10_007, seed=4)
    ut = torch.from_numpy(u)
    keys = prng.split(key_to_torch(KEY), 3)
    whole = voting.vote_scores(ut, keys)
    np.testing.assert_array_equal(
        _np(voting.vote_scores(ut, keys, piece=piece)), _np(whole))
    np.testing.assert_array_equal(
        _np(voting.vote_scores(ut[1], keys[1], piece=piece)), _np(whole[1]))
    for start, width in ((0, 10_007), (4093, 3001), (9000, 1007)):
        for p in (piece, None):
            got = voting.vote_scores(ut[:, start:start + width], keys, start,
                                     10_007, piece=p)
            np.testing.assert_array_equal(_np(got),
                                          _np(whole[:, start:start + width]))
    from repro.core import voting as jvoting
    jkeys = jax.random.split(KEY, 3)
    ref = jax.vmap(jvoting.vote_scores)(jnp.asarray(u), jkeys)
    np.testing.assert_array_equal(_np(whole), _np(ref))


# ---------------------------------------------------------------------------
# geometry, and what the engine refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,n_dev,block_size", [
    (100, 8, 16), (100, 8, 0), (1001, 3, 64), (5, 8, 16), (4096, 4, 1024)])
def test_shard_geometry_matches_reference(d, n_dev, block_size):
    kw = dict(compact_mode="block", block_size=block_size) if block_size \
        else {}
    got = shard_engine.shard_geometry(d, n_dev, fediac.FediACConfig(**kw))
    assert got == jshard.shard_geometry(d, n_dev, jfediac.FediACConfig(**kw))
    s, width = got
    assert width == n_dev * s and width >= d
    if block_size:
        assert s % block_size == 0     # blocks never straddle shards


@pytest.mark.parametrize("cfg", [
    fediac.FediACConfig(vote_chunk=4),
    fediac.FediACConfig(engine=EngineSpec(name="sharded", use_pallas=True))])
def test_sharded_rejects_unshardable_configs(cfg):
    with pytest.raises(NotImplementedError):
        shard_engine.aggregate_shard(torch.zeros(2, 16), cfg,
                                     key_to_torch(KEY), devices=1)
    with pytest.raises(NotImplementedError):
        shard_engine.shard_compress_stack(
            torch.zeros(2, 16), cfg, torch.ones(()), torch.zeros(2, 2),
            fediac.RoundPlan(), devices=1)


# ---------------------------------------------------------------------------
# the compress half (per-client buffers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", [1, 3])
@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_shard_compress_stack_matches_reference(vote_mode, compact_mode,
                                                devices):
    """Against the port's stacked phase-2 compress and the reference's
    ``phase2_compress`` (per client), on one plan."""
    n, d = 5, 1001
    kw = dict(SMALL, vote_mode=vote_mode, compact_mode=compact_mode)
    cfg = fediac.FediACConfig(**kw)
    u, tk = _u(n, d, seed=11), key_to_torch(KEY)
    ut = torch.from_numpy(u)
    keys = prng.split(tk, 2 * n)
    counts = fediac._vote_counts_stack(ut, cfg, keys[:n])
    f = (torch.tensor(scale_factor(cfg.bits, n, 1.0), dtype=torch.float32)
         / torch.clamp_min(ut.abs().max(), 1e-12))
    topk = compact_mode != "block"
    plan = fediac.build_round_plan(counts, cfg, n, with_dense_mask=topk,
                                   with_slot_map=topk)
    qb, res = shard_engine.shard_compress_stack(ut, cfg, f, keys[n:], plan,
                                                devices=devices)
    qb_stack, res_stack = fediac.phase2_compress(cfg)(ut, cfg, f, keys[n:],
                                                      plan)
    np.testing.assert_array_equal(_np(qb), _np(qb_stack))
    np.testing.assert_array_equal(_np(res), _np(res_stack))

    jc = jfediac.FediACConfig(**kw)
    jkeys = jax.random.split(KEY, 2 * n)
    jp = jplan.build_round_plan(jnp.asarray(counts.numpy()), jc, n,
                                with_dense_mask=True, with_slot_map=topk)
    jqb, jres = jax.vmap(jfediac.phase2_compress(jc),
                         in_axes=(0, None, None, 0, None))(
        jnp.asarray(u), jc, jnp.asarray(f.numpy()), jkeys[n:], jp)
    np.testing.assert_array_equal(_np(qb), _np(jqb))
    np.testing.assert_array_equal(_np(res), _np(jres))


# ---------------------------------------------------------------------------
# the engine registry and the FL loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_aggregate_round_dispatches_sharded(monkeypatch, vote_mode,
                                            compact_mode):
    u = _u(4, 3000, seed=2)
    calls = []
    real = shard_engine.aggregate_shard

    def spy(*args, **kw):
        calls.append(kw["devices"])
        return real(*args, **kw)

    monkeypatch.setattr(shard_engine, "aggregate_shard", spy)
    kw = dict(vote_mode=vote_mode, compact_mode=compact_mode, block_size=256)
    got = fediac.aggregate_round(
        torch.from_numpy(u), fediac.FediACConfig(
            **kw, engine=EngineSpec(name="sharded", devices=3)),
        key_to_torch(KEY))
    default = fediac.aggregate_round(
        torch.from_numpy(u), fediac.FediACConfig(**kw, engine="sharded"),
        key_to_torch(KEY))
    assert calls == [3, None]
    ref = jfediac.aggregate_stack(jnp.asarray(u), jfediac.FediACConfig(**kw),
                                  KEY)
    _assert_rounds_equal(got, ref)
    _assert_rounds_equal(default, ref)


@pytest.mark.parametrize("devices", [-1, 1.5, True, "3", None])
def test_engine_spec_rejects_bad_devices(devices):
    with pytest.raises(ValueError, match="devices"):
        EngineSpec(name="sharded", devices=devices)


def test_engine_registry_names():
    assert engines.get("sharded") == EngineSpec(name="sharded")
    assert EngineSpec(name="sharded", devices=8).devices == 8
    assert engines.get("async") == EngineSpec(name="async")


def test_run_federated_sharded_bit_identical():
    """The FL loop on ``EngineSpec("sharded", devices=3)``: the same
    history, bit for bit, as on the monolithic engine."""
    data = classification(n=1200, dim=16, n_classes=10, seed=0)
    train, test = data.test_split(0.2)
    clients = partition_dirichlet(train, 4, beta=0.5, seed=0)

    def port(engine):
        return fl_loop.run_federated(clients, test, fl_loop.FLConfig(
            n_clients=4, rounds=3, local_steps=2, batch=16, engine=engine),
            hidden=(32, 16), device="cpu")

    h_shard = port(EngineSpec(name="sharded", devices=3))
    assert len(h_shard) == 3 and h_shard == port("monolithic")
