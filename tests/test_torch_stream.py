"""The port's streaming round engine (``core/stream_engine.py``) against
the reference's ``aggregate_stream`` and the port's own monolithic
``aggregate_stack``, bitwise: every vote x compact mode pair, N in {1, 8},
chunk sizes that do and do not divide d, the fused kernel path (the
reference's Pallas kernel in interpret mode, the port's plain version of
B1 on the CPU), the sum, trim and median closes, the ``a=`` override, the
in-place residual buffer, dispatch through the engine registry, and the
FL loop on the stream engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fediac as jfediac
from repro.core import round_plan as jplan
from repro.core import stream_engine as jstream
from repro.core.engines import EngineSpec as JSpec
from repro.data import classification, partition_dirichlet
from repro.training import fl_loop as jfl
from repro_torch.core import engines, fediac, prng, round_plan, stream_engine
from repro_torch.core.engines import EngineSpec
from repro_torch.core.quantize import scale_factor
from repro_torch.kernels import gather_quant
from repro_torch.testing import key_to_torch
from repro_torch.training import fl_loop

KEY = jax.random.PRNGKey(7)
MODES = [("topk", "topk"), ("topk", "block"),
         ("threshold", "topk"), ("threshold", "block")]
CLOSES = [("sum", 0.0), ("trim", 0.1), ("median", 0.0)]


def _u(n, d, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) ** 3).astype(np.float32)


def _cfg(mod, vote_mode="topk", compact_mode="topk", kernels=False,
         engine="monolithic", chunk=0, **kw):
    """A FediACConfig of the port (``mod=fediac``) or of the reference
    (``mod=jfediac``), both spelled with an engine spec."""
    spec = (EngineSpec if mod is fediac else JSpec)(
        name=engine, chunk=chunk, use_pallas=kernels)
    return mod.FediACConfig(vote_mode=vote_mode, compact_mode=compact_mode,
                            block_size=256, engine=spec, **kw)


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_rounds_equal(got, want):
    """(delta, residuals, counts) bitwise, and the traffic accounting."""
    for name, x, y in zip(("delta", "residuals", "counts"), got[:3], want[:3]):
        np.testing.assert_array_equal(_np(x), _np(y), err_msg=name)
    want_traffic = want[3]
    if not isinstance(want_traffic, fediac.TrafficStats):
        want_traffic = fediac.TrafficStats(**vars(want_traffic))
    assert got[3] == want_traffic, "traffic stats"


def _port_and_ref(u, chunk, a=None, **kw):
    """The port's stream round, the port's monolithic round and the
    reference's stream round on the same inputs."""
    tc = _cfg(fediac, **kw)
    ut, tk = torch.from_numpy(u), key_to_torch(KEY)
    got = stream_engine.aggregate_stream(ut, tc, tk, a=a, chunk=chunk)
    mono = fediac.aggregate_stack(ut, tc, tk, a=a)
    jc = _cfg(jfediac, engine="stream", chunk=chunk or 0, **kw)
    ref = jfediac.aggregate_round(jnp.asarray(u), jc, KEY, a=a)
    return got, mono, ref


# ---------------------------------------------------------------------------
# the slot map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("floor", [0, 10_000])
@pytest.mark.parametrize("dense", [False, True])
def test_round_plan_slot_map_bitwise(floor, dense):
    n, d = 10, 40_000
    counts = np.random.default_rng(2).binomial(n, 0.08, d).astype(np.int32)
    want = jplan.build_round_plan(
        jnp.asarray(counts), jfediac.FediACConfig(consensus_floor=floor), n,
        with_dense_mask=dense, with_slot_map=True)
    got = round_plan.build_round_plan(
        torch.from_numpy(counts), fediac.FediACConfig(consensus_floor=floor),
        n, with_dense_mask=dense, with_slot_map=True)
    assert got.slot.dtype == torch.int32
    for name in ("slot", "idx", "keep") + (("sel",) if dense else ()):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(want, name)), err_msg=name)
    assert round_plan.build_round_plan(
        torch.from_numpy(counts), fediac.FediACConfig(), n).slot is None


# ---------------------------------------------------------------------------
# stream == the port's monolithic round (the whole matrix, port only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("close,trim_frac", CLOSES)
@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_stream_equals_stack(vote_mode, compact_mode, n, kernels, close,
                             trim_frac):
    cfg = _cfg(fediac, vote_mode, compact_mode, kernels, robust_agg=close,
               trim_frac=trim_frac)
    u, key = torch.from_numpy(_u(n, 10_000)), key_to_torch(KEY)
    _assert_rounds_equal(
        stream_engine.aggregate_stream(u, cfg, key, chunk=1536),
        fediac.aggregate_stack(u, cfg, key))


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("chunk", [512, 1536, 4096, 9999, 12_345])
def test_stream_chunk_sizes_equal_stack(chunk, kernels):
    """Chunks smaller than d, dividing it or not, equal to it, larger."""
    cfg = _cfg(fediac, kernels=kernels)
    d = 12_345
    u, key = torch.from_numpy(_u(6, d, seed=3)), key_to_torch(KEY)
    before = gather_quant.gather_quant.launches
    _assert_rounds_equal(
        stream_engine.aggregate_stream(u, cfg, key, chunk=chunk),
        fediac.aggregate_stack(u, cfg, key))
    assert gather_quant.gather_quant.launches == before   # CPU: plain B1


# ---------------------------------------------------------------------------
# stream == the reference's stream round (the cases of the reference's
# tests/test_stream_engine.py, and each axis of the matrix)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("vote_mode,compact_mode", MODES)
def test_stream_matches_reference(vote_mode, compact_mode, n):
    got, mono, ref = _port_and_ref(_u(n, 10_000), 1536, vote_mode=vote_mode,
                                   compact_mode=compact_mode)
    _assert_rounds_equal(got, ref)
    _assert_rounds_equal(got, mono)


@pytest.mark.parametrize("chunk", [512, 4096, 9999, 100_000])
def test_stream_chunk_sizes_match_reference(chunk):
    got, _, ref = _port_and_ref(_u(6, 9999), chunk)
    _assert_rounds_equal(got, ref)


@pytest.mark.parametrize("vote_mode", ["topk", "threshold"])
def test_stream_fused_matches_reference(vote_mode):
    """Kernels on: one B1 call per chunk on the slice of the d-sized
    uniform stream (the reference's Pallas kernel in interpret mode)."""
    got, mono, ref = _port_and_ref(_u(6, 10_000), 1536, vote_mode=vote_mode,
                                   kernels=True)
    _assert_rounds_equal(got, ref)
    _assert_rounds_equal(got, mono)


@pytest.mark.parametrize("compact_mode,kernels", [("topk", False),
                                                  ("topk", True),
                                                  ("block", False)])
@pytest.mark.parametrize("close,trim_frac", CLOSES[1:])
def test_stream_closes_match_reference(close, trim_frac, compact_mode,
                                       kernels):
    got, mono, ref = _port_and_ref(_u(8, 6000, seed=4), 1000,
                                   compact_mode=compact_mode, kernels=kernels,
                                   robust_agg=close, trim_frac=trim_frac)
    _assert_rounds_equal(got, ref)
    _assert_rounds_equal(got, mono)


@pytest.mark.parametrize("compact_mode", ["topk", "block"])
def test_stream_threshold_override(compact_mode):
    """``a=`` as a Python int and as an int32 tensor (the reference's
    traced scalar) give the reference's round."""
    u = _u(5, 4096, seed=5)
    got, mono, ref = _port_and_ref(u, 1000, a=2, compact_mode=compact_mode)
    _assert_rounds_equal(got, ref)
    _assert_rounds_equal(got, mono)
    as_tensor = stream_engine.aggregate_stream(
        torch.from_numpy(u), _cfg(fediac, compact_mode=compact_mode),
        key_to_torch(KEY), a=torch.tensor(2, dtype=torch.int32), chunk=1000)
    _assert_rounds_equal(as_tensor, ref)


def test_stream_boundary_ties_match_reference():
    """Above the reference's sample-certified selection gate (its top-k
    votes take another algorithm there), with ties at the boundary, and
    the default chunk (one full chunk and a tail)."""
    u = np.round(_u(4, 300_000, seed=6) * 4) / 4
    got, mono, ref = _port_and_ref(u.astype(np.float32), None)
    _assert_rounds_equal(got, ref)
    _assert_rounds_equal(got, mono)


def test_phase1_topk_draws_rows_in_pieces(monkeypatch):
    """Top-k phase 1 at a chunk much smaller than d: one row a step
    (8 · 4,096 < 70,001), each row's scores drawn in pieces of 4,096
    (the piece size set down to the chunk); the counts and the whole
    round bitwise the reference's stream round and the port's monolithic
    round."""
    from repro_torch.core import streams, voting
    monkeypatch.setattr(voting, "SCORE_PIECE", 4096)
    pieces = []
    real = streams.gumbel_block

    def spy(keys, start, size, total, **kw):
        pieces.append((keys.shape[0], start, size))
        return real(keys, start, size, total, **kw)

    u = _u(8, 70_001, seed=9)
    with monkeypatch.context() as m:
        m.setattr(streams, "gumbel_block", spy)
        got = stream_engine.aggregate_stream(
            torch.from_numpy(u), _cfg(fediac), key_to_torch(KEY), chunk=4096)
    row = [(1, s, min(4096, 70_001 - s)) for s in range(0, 70_001, 4096)]
    assert pieces == row * 8
    _, mono, ref = _port_and_ref(u, 4096)
    _assert_rounds_equal(got, ref)
    _assert_rounds_equal(got, mono)


def test_stream_rejects_chunked_votes():
    with pytest.raises(NotImplementedError, match="vote_chunk"):
        stream_engine.aggregate_stream(torch.from_numpy(_u(2, 64)),
                                       fediac.FediACConfig(vote_chunk=4),
                                       key_to_torch(KEY))


# ---------------------------------------------------------------------------
# the compress half (per-client buffers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vote_mode,compact_mode,kernels",
                         [("topk", "topk", False), ("topk", "block", False),
                          ("threshold", "topk", False),
                          ("threshold", "block", False),
                          ("topk", "topk", True)])
def test_stream_compress_stack(vote_mode, compact_mode, kernels):
    """Against the port's stacked phase-2 compress and the reference's
    ``stream_compress_stack``, on one plan."""
    u = _u(6, 10_000)
    n = u.shape[0]
    cfg = _cfg(fediac, vote_mode, compact_mode, kernels)
    ut, tk = torch.from_numpy(u), key_to_torch(KEY)
    keys = prng.split(tk, 2 * n)
    counts = fediac._vote_counts_stack(ut, cfg, keys[:n])
    f = (torch.tensor(scale_factor(cfg.bits, n, 1.0), dtype=torch.float32)
         / torch.clamp_min(ut.abs().max(), 1e-12))
    topk = compact_mode != "block"
    plan = fediac.build_round_plan(counts, cfg, n, with_dense_mask=topk,
                                   with_slot_map=topk)
    qb, res = stream_engine.stream_compress_stack(ut, cfg, f, keys[n:], plan,
                                                  chunk=1536)
    qb_stack, res_stack = fediac.phase2_compress(cfg)(ut, cfg, f, keys[n:],
                                                      plan)
    np.testing.assert_array_equal(_np(qb), _np(qb_stack))
    np.testing.assert_array_equal(_np(res), _np(res_stack))

    jc = jfediac.FediACConfig(vote_mode=vote_mode, compact_mode=compact_mode,
                              block_size=256, use_pallas=kernels)
    jkeys = jax.random.split(KEY, 2 * n)
    jplan_ = jplan.build_round_plan(jnp.asarray(counts.numpy()), jc, n,
                                    with_dense_mask=topk, with_slot_map=topk)
    jqb, jres = jstream.stream_compress_stack(
        jnp.asarray(u), jc, jnp.asarray(f.numpy()), jkeys[n:], jplan_,
        chunk=1536)
    np.testing.assert_array_equal(_np(qb), _np(jqb))
    np.testing.assert_array_equal(_np(res), _np(jres))


# ---------------------------------------------------------------------------
# the residual buffer: out of place, into a buffer, in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vote_mode,compact_mode,kernels,d", [
    pytest.param("topk", "topk", False, 7000, id="topk-topk-False"),
    pytest.param("topk", "topk", True, 7000, id="topk-topk-True"),
    pytest.param("threshold", "block", False, 7000,
                 id="threshold-block-False"),
    # an odd d: B1's chunks start off 16-byte boundaries, ragged last chunk
    pytest.param("topk", "topk", True, 7001, id="topk-topk-True-odd-d")])
def test_out_in_place_equals_out_of_place(vote_mode, compact_mode, kernels,
                                          d):
    cfg = _cfg(fediac, vote_mode, compact_mode, kernels)
    u, key = torch.from_numpy(_u(5, d, seed=8)), key_to_torch(KEY)
    want = stream_engine.aggregate_stream(u, cfg, key, chunk=1024)
    if kernels:
        _assert_rounds_equal(want, fediac.aggregate_stack(u, cfg, key))
    buf = torch.full_like(u, float("nan"))
    into = stream_engine.aggregate_stream(u, cfg, key, chunk=1024, out=buf)
    assert into[1] is buf
    _assert_rounds_equal(into, want)
    u_in = u.clone()
    ptr = u_in.data_ptr()
    inplace = stream_engine.aggregate_stream(u_in, cfg, key, chunk=1024,
                                             out=u_in)
    assert inplace[1].data_ptr() == ptr and u_in.data_ptr() == ptr
    _assert_rounds_equal(inplace, want)


@pytest.mark.parametrize("in_place", [False, True])
def test_fused_chunks_write_residual_views(monkeypatch, in_place):
    """With the kernels on, a float32 stack's chunks go to B1 as the
    stack's own column views, the residual written into the residual
    stack's columns (``out=``): no copy in, no copy out."""
    from repro_torch.kernels import ops as kops
    n, d, chunk = 4, 5003, 1024
    u, key = torch.from_numpy(_u(n, d, seed=9)), key_to_torch(KEY)
    cfg = _cfg(fediac, kernels=True)
    want = fediac.aggregate_stack(u, cfg, key)
    u_in = u.clone()
    residuals = u_in if in_place else torch.empty_like(u)
    calls, real = [], kops.gather_quant_flat

    def spy(u_c, uni, sel, f, *, out=None):
        calls.append((u_c.data_ptr(), u_c.stride(), out))
        return real(u_c, uni, sel, f, out=out)

    monkeypatch.setattr(kops, "gather_quant_flat", spy)
    got = stream_engine.aggregate_stream(u_in, cfg, key, chunk=chunk,
                                         out=residuals)
    starts = range(0, d, chunk)
    assert len(calls) == len(starts)
    for (ptr, stride, out), start in zip(calls, starts):
        assert ptr == u_in[:, start:].data_ptr() and stride == (d, 1)
        assert out.data_ptr() == residuals[:, start:].data_ptr()
        assert out.stride() == (d, 1)
    assert got[1] is residuals
    _assert_rounds_equal(got, want)


def test_out_must_match_the_stack():
    u = torch.from_numpy(_u(3, 500))
    for bad in (torch.empty(3, 499), torch.empty(3, 500, dtype=torch.float64)):
        with pytest.raises(ValueError, match="out"):
            stream_engine.aggregate_stream(u, fediac.FediACConfig(),
                                           key_to_torch(KEY), out=bad)


# ---------------------------------------------------------------------------
# the engine registry
# ---------------------------------------------------------------------------

def test_aggregate_round_dispatches_stream(monkeypatch):
    u, key = torch.from_numpy(_u(4, 4096)), key_to_torch(KEY)
    calls = []
    real = stream_engine.aggregate_stream

    def spy(*args, **kw):
        calls.append(kw["chunk"])
        return real(*args, **kw)

    monkeypatch.setattr(stream_engine, "aggregate_stream", spy)
    for kernels in (False, True):
        mono = fediac.aggregate_round(u, _cfg(fediac, kernels=kernels), key)
        stream = fediac.aggregate_round(
            u, _cfg(fediac, kernels=kernels, engine="stream", chunk=1000), key)
        _assert_rounds_equal(stream, mono)
    default = fediac.aggregate_round(u, _cfg(fediac, engine="stream"), key)
    assert calls == [1000, 1000, None]
    _assert_rounds_equal(default, fediac.aggregate_stack(
        u, fediac.FediACConfig(), key))
    assert engines.get("stream") == EngineSpec(name="stream")


@pytest.mark.parametrize("chunk", [-1, 1.5, True, "4096", None])
def test_engine_spec_rejects_bad_chunk(chunk):
    with pytest.raises(ValueError, match="chunk"):
        EngineSpec(name="stream", chunk=chunk)


@pytest.mark.parametrize("chunk", [0, 1, 4096])
def test_engine_spec_takes_chunk(chunk):
    assert EngineSpec(name="stream", chunk=chunk).chunk == chunk


# ---------------------------------------------------------------------------
# the FL loop on the stream engine, and the history readouts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def task():
    data = classification(n=1200, dim=16, n_classes=10, seed=0)
    train, test = data.test_split(0.2)
    return partition_dirichlet(train, 4, beta=0.5, seed=0), test


FL_KW = dict(n_clients=4, rounds=3, local_steps=2, batch=16)
HIDDEN = (32, 16)


@pytest.mark.parametrize("kernels", [False, True])
def test_run_federated_stream_bit_identical(task, kernels):
    """The stream engine changes no bit of the port's FL history; against
    the reference's stream-engine run it holds test_torch_fl_loop's band
    (the local-SGD matmuls differ by float32 rounding)."""
    clients, test = task

    def port(engine):
        return fl_loop.run_federated(clients, test, fl_loop.FLConfig(
            **FL_KW, engine=EngineSpec(name=engine, chunk=1000,
                                       use_pallas=kernels)),
            hidden=HIDDEN, device="cpu")

    h_mono, h_stream = port("monolithic"), port("stream")
    assert len(h_stream) == 3 and h_stream == h_mono
    h_ref = jfl.run_federated(clients, test, jfl.FLConfig(
        **FL_KW, engine=JSpec(name="stream", chunk=1000,
                              use_pallas=kernels)), hidden=HIDDEN)
    assert h_stream.traffic_mb == h_ref.traffic_mb
    assert h_stream.wall_clock == h_ref.wall_clock
    np.testing.assert_allclose(h_stream.acc, h_ref.acc, atol=2 / 240)
    np.testing.assert_allclose(h_stream.loss, h_ref.loss, rtol=1e-4)


def test_history_readouts_match_reference():
    rng = np.random.default_rng(0)
    acc = [float(x) for x in np.round(rng.uniform(0.1, 0.9, 12), 3)]
    acc[5] = acc[9]                                  # a tie
    cols = dict(acc=acc,
                wall_clock=[float(x) for x in np.cumsum(rng.uniform(0.5, 2, 12))],
                traffic_mb=[float(x) for x in np.cumsum(rng.uniform(1, 3, 12))],
                loss=[float(x) for x in rng.uniform(0.2, 2, 12)])
    got, want = fl_loop.FLHistory(**cols), jfl.FLHistory(**cols)
    assert [r.to_metrics() for r in got.records] == [
        r.to_metrics() for r in want.records]
    for t in [-1.0, 0.0, *cols["wall_clock"], 7.5, 1e9]:
        assert got.acc_at_time(t) == want.acc_at_time(t)
    for target in [0.0, 0.3, *acc, 0.95]:
        assert got.traffic_to_accuracy(target) == want.traffic_to_accuracy(
            target)
    assert fl_loop.FLHistory().acc_at_time(1.0) == 0.0
    assert fl_loop.FLHistory().traffic_to_accuracy(0.5) is None
