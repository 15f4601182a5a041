"""The port on the card: each CUDA kernel against its plain version, and
a round, the packet round (plain, chaos, Byzantine-robust and async) and
the FL loop against the same on the CPU, a probe leaving the FL run
bitwise, B6's backward against autograd through its plain version (and
under both remat policies), and a train step against the CPU's.
Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor the reference package, so it also runs
on a GPU host that has no JAX, without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.core import EngineSpec, FediACConfig, aggregate_round, prng
from repro_torch.data import classification, partition_dirichlet
from repro_torch.kernels import (bitpack, flash_attention, gather_quant, ref,
                                 stoch_quant, vote_pack, vote_popcount)
from repro_torch.testing import cuda_device, requires_cuda  # noqa: F401
from repro_torch.training import fl_loop

pytestmark = requires_cuda


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("f", [1.0, 117.5, 4000.0])
@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
def test_kernels_match_plain_on_card(cuda_device, f, density):
    rng = np.random.default_rng(int(f) + int(100 * density))
    d = 123_457
    u = torch.from_numpy((rng.standard_normal((3, d)) * 3).astype(np.float32))
    uni = torch.from_numpy(rng.random((3, d), dtype=np.float32))
    sel = torch.from_numpy((rng.random(d) < density).astype(np.uint8))
    u, uni, sel = u.to(cuda_device), uni.to(cuda_device), sel.to(cuda_device)
    ft = torch.tensor(f, device=cuda_device)
    before = (gather_quant.gather_quant.launches,
              stoch_quant.stoch_quant.launches)
    qk, rk = gather_quant.gather_quant(u, uni, sel, ft)
    sk = stoch_quant.stoch_quant(u, uni, ft)
    torch.cuda.synchronize()
    assert (gather_quant.gather_quant.launches,
            stoch_quant.stoch_quant.launches) == (before[0] + 1, before[1] + 1)
    qp, rp = gather_quant.gather_quant_plain(u, uni, sel, ft)
    assert _same(qk, qp) and _same(rk, rp)
    assert _same(sk, stoch_quant.stoch_quant_plain(u, uni, ft))


@pytest.mark.parametrize("d", [1, 70_001, 262_144, 300_000])
def test_wire_kernels_match_plain_on_card(cuda_device, d):
    rng = np.random.default_rng(d)
    mask = torch.from_numpy((rng.random(d) < 0.05).astype(np.uint8))
    s = (rng.standard_normal(d) ** 3).astype(np.float32)
    s[3::997] = np.nan
    scores = torch.from_numpy(np.abs(s))
    mask, scores = mask.to(cuda_device), scores.to(cuda_device)
    kernels = (bitpack.pack, bitpack.unpack, vote_pack.vote_pack,
               vote_popcount.popcount_accum)
    before = [k.launches for k in kernels]
    words = bitpack.pack(mask)
    back = bitpack.unpack(words, d)
    taus = [torch.tensor(t, device=cuda_device)
            for t in (0.0, 0.5, float("inf"), float("-inf"))]
    packed = [vote_pack.vote_pack(scores, t) for t in taus]
    stack = torch.from_numpy(rng.integers(
        -2**31, 2**31, (8, ref.wire_groups(d), ref.LANES), dtype=np.int64)
        .astype(np.int32)).to(cuda_device)
    counts = vote_popcount.popcount_accum(stack, d)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [before[0] + 1, before[1] + 1,
                                             before[2] + 4, before[3] + 1]
    assert _same(words, bitpack.pack_plain(mask))
    assert _same(back, mask)
    assert _same(back, bitpack.unpack_plain(words, d))
    for t, p in zip(taus, packed):
        assert _same(p, vote_pack.vote_pack_plain(scores, t))
    assert _same(counts, vote_popcount.popcount_accum_plain(stack, d))


@pytest.mark.parametrize("vote_chunk", [1, 4])
def test_round_on_card_equals_cpu(cuda_device, vote_chunk):
    rng = np.random.default_rng(vote_chunk)
    u = torch.from_numpy((rng.standard_normal((8, 40_000))
                          * rng.exponential(1.0, 40_000)).astype(np.float32))
    cfg = FediACConfig(vote_chunk=vote_chunk,
                       engine=EngineSpec(use_pallas=True))
    on_card = aggregate_round(u.to(cuda_device), cfg,
                              prng.PRNGKey(4, device=cuda_device))
    on_cpu = aggregate_round(u, cfg, prng.PRNGKey(4, device="cpu"))
    for a, b in zip(on_card[:3], on_cpu[:3]):
        assert _same(a, b)


def test_gather_quant_strided_chunk_on_card(cuda_device):
    """B1 at the stream engine's launch shape [8, 262,144], on a strided
    column slice of a [8, d] stack as the chunk loop hands it over."""
    rng = np.random.default_rng(11)
    n, d, start, size = 8, 600_000, 262_144, 262_144
    u = torch.from_numpy((rng.standard_normal((n, d)) ** 3)
                         .astype(np.float32)).to(cuda_device)
    uni = torch.from_numpy(rng.random((n, size), dtype=np.float32))
    sel = torch.from_numpy((rng.random(size) < 0.05).astype(np.uint8))
    uni, sel = uni.to(cuda_device), sel.to(cuda_device)
    f = torch.tensor(3.7, device=cuda_device)
    chunk = u[:, start:start + size]
    assert not chunk.is_contiguous()
    before = gather_quant.gather_quant.launches
    qk, rk = gather_quant.gather_quant(chunk, uni, sel, f)
    torch.cuda.synchronize()
    assert gather_quant.gather_quant.launches == before + 1
    qp, rp = gather_quant.gather_quant_plain(chunk, uni, sel, f)
    assert _same(qk, qp) and _same(rk, rp)


def _view_case(case: str, device):
    """B1's operands for one layout: ``(u, uniforms, sel, out)``."""
    rng = np.random.default_rng(sum(map(ord, case)))

    def arr(shape, uniform=False):
        a = (rng.random(shape, dtype=np.float32) if uniform else
             (rng.standard_normal(shape) ** 3).astype(np.float32))
        return torch.from_numpy(a).to(device)

    def mask(cols):
        return torch.from_numpy((rng.random(cols) < 0.05).astype(np.uint8)
                                ).to(device)

    if case == "one_row":            # the train path's leaves: [1, L]
        cols = (1 << 24) + 3
        return arr((1, cols)), arr((1, cols), True), mask(cols), None
    if case == "fl_stack":           # rows 8 bytes apart from a boundary
        return arr((20, 21_322)), arr((20, 21_322), True), mask(21_322), None
    # column views of an [8, 300,000] stack, 1-3 columns off a 16-byte
    # boundary, an odd width; sel a view at the same start or its own
    start, cols = int(case[-1]) if case[-1].isdigit() else 2, 100_001
    u = arr((8, 300_000))[:, start:start + cols]
    uni = arr((8, 300_000), True)[:, start:start + cols]
    sel = mask(cols) if "own_sel" in case else mask(300_000)[start:start + cols]
    return u, uni, sel, (u if case == "in_place" else None)


@pytest.mark.parametrize("case", ["start_1", "start_2", "start_3",
                                  "own_sel_start_1", "own_sel_start_3",
                                  "in_place", "one_row", "fl_stack"])
def test_gather_quant_views_on_card(cuda_device, case):
    """B1 on the layouts its paths and callers give it, one launch each,
    bitwise its plain version: column views off a 16-byte boundary with an
    odd width (rows of u, the uniforms and q at different offsets, so some
    rows take the vector path and some the scalar one), the residual
    written into u itself, one row of 2^24 + 3, and the FL loop's
    [20, 21,322] stack."""
    u, uni, sel, out = _view_case(case, cuda_device)
    f = torch.tensor(37.0, device=cuda_device) / u.abs().max()
    qp, rp = gather_quant.gather_quant_plain(u.clone(), uni, sel, f)
    before = gather_quant.gather_quant.launches
    qk, rk = gather_quant.gather_quant(u, uni, sel, f, out=out)
    torch.cuda.synchronize()
    assert gather_quant.gather_quant.launches == before + 1
    assert out is None or rk is out
    assert _same(qk, qp) and _same(rk, rp)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("vote_mode,compact_mode", [("topk", "topk"),
                                                    ("threshold", "block")])
def test_stream_round_on_card_equals_stack(cuda_device, kernels, vote_mode,
                                           compact_mode):
    """The stream engine on the card: bitwise its monolithic round, one B1
    launch per chunk on the fused path and none otherwise."""
    from repro_torch.core.stream_engine import aggregate_stream
    rng = np.random.default_rng(5)
    u = torch.from_numpy((rng.standard_normal((8, 40_000)) ** 3)
                         .astype(np.float32)).to(cuda_device)
    cfg = FediACConfig(vote_mode=vote_mode, compact_mode=compact_mode,
                       block_size=1024, engine=EngineSpec(use_pallas=kernels))
    key = prng.PRNGKey(4, device=cuda_device)
    before = gather_quant.gather_quant.launches
    stream = aggregate_stream(u, cfg, key, chunk=9_999)
    torch.cuda.synchronize()
    fused = kernels and compact_mode == "topk"
    assert gather_quant.gather_quant.launches - before == (
        -(-40_000 // 9_999) if fused else 0)
    mono = aggregate_round(u, cfg, key)
    for a, b in zip(stream[:3], mono[:3]):
        assert _same(a, b)


@pytest.mark.parametrize("devices", [3, 8])
@pytest.mark.parametrize("vote_mode,compact_mode", [
    ("topk", "topk"), ("topk", "block"), ("threshold", "topk"),
    ("threshold", "block")])
def test_shard_round_on_card_equals_stack(cuda_device, vote_mode,
                                          compact_mode, devices):
    """The sharded engine on the card (every shard on the one card):
    bitwise its monolithic round, at a width that leaves ragged shards
    and shards wider than the phase-2 chunk."""
    rng = np.random.default_rng(6)
    u = torch.from_numpy((rng.standard_normal((8, 900_001)) ** 3)
                         .astype(np.float32)).to(cuda_device)
    cfg = FediACConfig(vote_mode=vote_mode, compact_mode=compact_mode,
                       block_size=1024)
    key = prng.PRNGKey(4, device=cuda_device)
    shard = aggregate_round(u, FediACConfig(
        vote_mode=vote_mode, compact_mode=compact_mode, block_size=1024,
        engine=EngineSpec(name="sharded", devices=devices)), key)
    mono = aggregate_round(u, cfg, key)
    for a, b in zip(shard[:3], mono[:3]):
        assert a.device == b.device and _same(a, b)


def test_fl_loop_on_card_matches_cpu(cuda_device):
    data = classification(n=1200, dim=16, seed=0)
    train, test = data.test_split(0.2)
    clients = partition_dirichlet(train, 4, beta=0.5, seed=0)
    cfg = fl_loop.FLConfig(n_clients=4, rounds=2, local_steps=2, batch=16,
                           engine=EngineSpec(use_pallas=True))
    before = gather_quant.gather_quant.launches
    h_card = fl_loop.run_federated(clients, test, cfg, hidden=(32, 16))
    assert gather_quant.gather_quant.launches == before + 2
    h_cpu = fl_loop.run_federated(clients, test, cfg, hidden=(32, 16),
                                  device="cpu")
    assert h_card.traffic_mb == h_cpu.traffic_mb
    assert h_card.wall_clock == h_cpu.wall_clock
    np.testing.assert_allclose(h_card.loss, h_cpu.loss, rtol=1e-4)


@pytest.mark.parametrize("name", ["fedavg", "switchml", "topk",
                                  "omnireduce", "libra"])
def test_baseline_on_card_equals_cpu(cuda_device, name):
    from repro_torch.core.baselines import make_aggregator
    rng = np.random.default_rng(3)
    u = (rng.standard_normal((8, 40_000)) ** 3).astype(np.float32)
    u[:, ::5] = 0.0                          # exact zeros: top-k ties
    u = torch.from_numpy(u)
    agg = make_aggregator(name)
    sc = sp = None
    for r in range(2):                       # libra carries its state
        on_card = agg(u.to(cuda_device), sc, prng.PRNGKey(r, cuda_device))
        on_cpu = agg(u, sp, prng.PRNGKey(r, "cpu"))
        sc, sp = on_card[2], on_cpu[2]
        assert _same(on_card[0], on_cpu[0]) and _same(on_card[1], on_cpu[1])
        assert (sc is None and sp is None) or _same(sc, sp)
        assert on_card[3:] == on_cpu[3:]


@pytest.mark.parametrize("close", ["trim", "median"])
@pytest.mark.parametrize("vote_chunk", [1, 4])
def test_robust_round_on_card_equals_cpu(cuda_device, close, vote_chunk):
    rng = np.random.default_rng(vote_chunk)
    u = torch.from_numpy((rng.standard_normal((8, 40_000))
                          * rng.exponential(1.0, 40_000)).astype(np.float32))
    cfg = FediACConfig(vote_chunk=vote_chunk, robust_agg=close,
                       trim_frac=0.2, engine=EngineSpec(use_pallas=True))
    on_card = aggregate_round(u.to(cuda_device), cfg,
                              prng.PRNGKey(4, device=cuda_device))
    on_cpu = aggregate_round(u, cfg, prng.PRNGKey(4, device="cpu"))
    for a, b in zip(on_card[:3], on_cpu[:3]):
        assert _same(a, b)


def test_fl_resume_on_card_bit_identical(cuda_device, tmp_path):
    data = classification(n=1200, dim=16, seed=0)
    train, test = data.test_split(0.2)
    clients = partition_dirichlet(train, 4, beta=0.5, seed=0)
    kw = dict(n_clients=4, local_steps=2, batch=16, aggregator="libra")
    full = fl_loop.run_federated(clients, test, fl_loop.FLConfig(
        rounds=3, **kw), hidden=(32, 16))
    path = str(tmp_path / "run.npz")
    fl_loop.run_federated(clients, test, fl_loop.FLConfig(
        rounds=1, ckpt_path=path, **kw), hidden=(32, 16))
    resumed = fl_loop.run_federated(clients, test, fl_loop.FLConfig(
        rounds=3, ckpt_path=path, resume=True, **kw), hidden=(32, 16))
    assert resumed == full


def _packet_net():
    from repro_torch.netsim import NetConfig
    return NetConfig(loss=0.05, participation=0.5, straggler_frac=0.25,
                     straggler_slowdown=3.0, n_leaves=2, memory_slots=1024,
                     vote_deadline_s=0.105, seed=9)


def _packet_same(a, b, rtol=1e-6):
    assert _same(a.delta, b.delta) and _same(a.residuals, b.residuals)
    for k, v in a.stats.items():
        if k == "mean_wait_s":      # a float sum, in another order
            np.testing.assert_allclose(v, b.stats[k], rtol=rtol)
        else:
            np.testing.assert_array_equal(v, b.stats[k])
    np.testing.assert_allclose(a.wall_clock_s, b.wall_clock_s, rtol=rtol)
    assert a.upload_bytes == b.upload_bytes and a.n_active == b.n_active


@pytest.mark.parametrize("vote_chunk,kernels", [(1, True), (4, True),
                                                (1, False)])
def test_packet_round_on_card_equals_cpu(cuda_device, vote_chunk, kernels):
    """The lossy packet round (loss, sampling, stragglers, a deadline, two
    leaves, a small bank) on the card against the CPU."""
    from repro_torch.netsim import PacketTransport
    rng = np.random.default_rng(8)
    u = torch.from_numpy((rng.standard_normal((8, 40_000)) ** 3).astype(
        np.float32))
    cfg = FediACConfig(vote_chunk=vote_chunk,
                       engine=EngineSpec(use_pallas=kernels))
    tp = PacketTransport("fediac", {"cfg": cfg}, net=_packet_net())
    before = (gather_quant.gather_quant.launches,
              stoch_quant.stoch_quant.launches)
    on_card = tp.round(u.to(cuda_device), None,
                       prng.PRNGKey(2, device=cuda_device), 1)
    rose = (gather_quant.gather_quant.launches - before[0],
            stoch_quant.stoch_quant.launches - before[1])
    assert rose == ((int(vote_chunk == 1), int(vote_chunk > 1)) if kernels
                    else (0, 0))
    on_cpu = tp.round(u, None, prng.PRNGKey(2, device="cpu"), 1)
    _packet_same(on_card, on_cpu)
    assert on_card.stats["passes"] > 1 and 0 < on_card.n_active < 8


@pytest.mark.parametrize("spec", [EngineSpec("stream", chunk=5000,
                                             use_pallas=True),
                                  EngineSpec("sharded", devices=3)])
def test_packet_engines_on_card(cuda_device, spec):
    from repro_torch.netsim import PacketTransport
    rng = np.random.default_rng(9)
    u = torch.from_numpy((rng.standard_normal((8, 40_000)) ** 3).astype(
        np.float32)).to(cuda_device)
    key = prng.PRNGKey(3, device=cuda_device)
    mono = FediACConfig(engine=EngineSpec(use_pallas=spec.use_pallas))
    got = PacketTransport("fediac", {"cfg": FediACConfig(engine=spec)},
                          net=_packet_net()).round(u, None, key, 2)
    want = PacketTransport("fediac", {"cfg": mono},
                           net=_packet_net()).round(u, None, key, 2)
    _packet_same(got, want, rtol=0.0)


def test_fl_packet_resume_on_card_bit_identical(cuda_device, tmp_path):
    from repro_torch.netsim import NetConfig
    data = classification(n=1200, dim=16, seed=0)
    train, test = data.test_split(0.2)
    clients = partition_dirichlet(train, 4, beta=0.5, seed=0)
    kw = dict(n_clients=4, local_steps=2, batch=16, transport="packet",
              net=NetConfig(loss=0.05, participation=0.5, seed=3),
              engine=EngineSpec(use_pallas=True))
    full = fl_loop.run_federated(clients, test, fl_loop.FLConfig(
        rounds=3, **kw), hidden=(32, 16))
    path = str(tmp_path / "run.npz")
    fl_loop.run_federated(clients, test, fl_loop.FLConfig(
        rounds=1, ckpt_path=path, **kw), hidden=(32, 16))
    resumed = fl_loop.run_federated(clients, test, fl_loop.FLConfig(
        rounds=3, ckpt_path=path, resume=True, **kw), hidden=(32, 16))
    assert resumed == full
    h_cpu = fl_loop.run_federated(clients, test, fl_loop.FLConfig(
        rounds=3, **kw), hidden=(32, 16), device="cpu")
    assert h_cpu.traffic_mb == full.traffic_mb
    np.testing.assert_allclose(h_cpu.wall_clock, full.wall_clock, rtol=1e-6)
    np.testing.assert_allclose(h_cpu.loss, full.loss, rtol=1e-4)


#: the chaos grid's burst-crash rates with a quorum floor and the rescale
#: close, and the attack grid's defended cell (its budget cut to the width)
_STORM = dict(ge_p_gb=0.05, ge_p_bg=0.4, ge_loss_bad=0.8, crash_rate=0.1,
              dup_rate=0.1, reorder_jitter_s=0.002, quorum_floor=5,
              register_policy="rescale", loss=0.05, n_leaves=2,
              memory_slots=4096, seed=9)
_DEFENDED = dict(byzantine_frac=0.25, collusion_frac=0.2,
                 vote_stuff_frac=0.3, poison_scale=-8.0, vote_budget=2500,
                 clip_ticks=1024, rep_threshold=2.0, rep_z_thresh=2.0,
                 quarantine_rounds=3, seed=3)


@pytest.mark.parametrize("name,vote_chunk", [("storm", 1), ("storm", 4),
                                             ("defended", 1)])
def test_fault_and_robust_rounds_on_card_equal_cpu(cuda_device, name,
                                                   vote_chunk):
    """The chaos storm and the defended attack on the card against the
    CPU, kernels on (B1 at vote_chunk 1, B2 at 4), two rounds threading
    the reputation state."""
    from repro_torch.netsim import FaultConfig, PacketTransport
    from repro_torch.robust import AdversaryConfig
    rng = np.random.default_rng(10)
    u = torch.from_numpy((rng.standard_normal((8, 40_000)) ** 3).astype(
        np.float32))
    if name == "storm":
        cfg_kw, net = {}, FaultConfig(**_STORM)
    else:
        cfg_kw, net = dict(robust_agg="trim", trim_frac=0.2), \
            AdversaryConfig(**_DEFENDED)
    cfg = FediACConfig(vote_chunk=vote_chunk,
                       engine=EngineSpec(use_pallas=True), **cfg_kw)
    tp = PacketTransport("fediac", {"cfg": cfg}, net=net)
    s_card = s_cpu = None
    for rnd in range(2):
        before = (gather_quant.gather_quant.launches,
                  stoch_quant.stoch_quant.launches)
        on_card = tp.round(u.to(cuda_device), s_card,
                           prng.PRNGKey(rnd, device=cuda_device), rnd)
        assert (gather_quant.gather_quant.launches - before[0],
                stoch_quant.stoch_quant.launches - before[1]) == (
            int(vote_chunk == 1), int(vote_chunk > 1))
        on_cpu = tp.round(u, s_cpu, prng.PRNGKey(rnd, device="cpu"), rnd)
        _packet_same(on_card, on_cpu)
        if name == "defended":
            for k in ("rep", "quarantine"):
                assert _same(on_card.state[k], on_cpu.state[k])
            s_card, s_cpu = on_card.state, on_cpu.state
        u = on_cpu.residuals


def test_chaos_engines_on_card(cuda_device):
    """The storm on the stream engine (B1 per chunk) and the sharded
    engine, each bitwise the monolithic chaos round on the card."""
    from repro_torch.netsim import FaultConfig, PacketTransport
    rng = np.random.default_rng(11)
    u = torch.from_numpy((rng.standard_normal((8, 40_000)) ** 3).astype(
        np.float32)).to(cuda_device)
    key = prng.PRNGKey(3, device=cuda_device)
    net = FaultConfig(**_STORM)
    for spec in (EngineSpec("stream", chunk=5000, use_pallas=True),
                 EngineSpec("sharded", devices=3)):
        mono = FediACConfig(engine=EngineSpec(use_pallas=spec.use_pallas))
        got = PacketTransport("fediac", {"cfg": FediACConfig(engine=spec)},
                              net=net).round(u, None, key, 2)
        want = PacketTransport("fediac", {"cfg": mono},
                               net=net).round(u, None, key, 2)
        _packet_same(got, want, rtol=0.0)


#: the async close under PACKET_NET-like impairments: half the clients
#: straggling 16x, a quorum of half, poly staleness, then the same with a
#: deadline and the bounce policy
_ASYNC = dict(loss=0.05, participation=0.9, straggler_frac=0.5,
              straggler_slowdown=16.0, quorum_frac=0.5, staleness_mode="poly",
              staleness_gamma=1.0, seed=2)


@pytest.mark.parametrize("extra,vote_chunk", [
    ({}, 1), ({}, 4), (dict(round_deadline_s=0.02, late_policy="bounce"), 1)])
def test_async_round_on_card_equals_cpu(cuda_device, extra, vote_chunk):
    """Two async packet rounds on the card against the CPU, kernels on (B1
    at vote_chunk 1, B2 at 4), the second folding the first's carry: the
    carry, delta, residuals, the async statistics and the clock bitwise
    (the mean wait within 1e-6)."""
    from repro_torch.netsim import AsyncConfig, PacketTransport
    rng = np.random.default_rng(12)
    u = torch.from_numpy((rng.standard_normal((8, 40_000)) ** 3).astype(
        np.float32))
    cfg = FediACConfig(vote_chunk=vote_chunk,
                       engine=EngineSpec(use_pallas=True))
    tp = PacketTransport("fediac", {"cfg": cfg},
                         net=AsyncConfig(**_ASYNC, **extra),
                         local_train_s=0.01)
    s_card = s_cpu = None
    late = 0
    for rnd in range(2):
        before = (gather_quant.gather_quant.launches,
                  stoch_quant.stoch_quant.launches)
        on_card = tp.round(u.to(cuda_device), s_card,
                           prng.PRNGKey(rnd, device=cuda_device), rnd)
        assert (gather_quant.gather_quant.launches - before[0],
                stoch_quant.stoch_quant.launches - before[1]) == (
            int(vote_chunk == 1), int(vote_chunk > 1))
        on_cpu = tp.round(u, s_cpu, prng.PRNGKey(rnd, device="cpu"), rnd)
        _packet_same(on_card, on_cpu)
        for k in ("pending", "pending_w", "pending_n"):
            assert _same(on_card.state[k], on_cpu.state[k])
        s_card, s_cpu = on_card.state, on_cpu.state
        late += on_cpu.stats["late_folded"] + on_cpu.stats["late_bounced"]
    assert late > 0


def test_probe_bitwise_on_card(cuda_device, tmp_path):
    """The async FL run on the card with a recording probe is bitwise the
    run without one; the trace validates and the profiler read device time
    for the round cores."""
    from repro_torch.netsim import AsyncConfig
    from repro_torch.obs import RecordingProbe, load_trace, validate_records
    data = classification(n=1200, dim=16, seed=0)
    train, test = data.test_split(0.2)
    clients = partition_dirichlet(train, 4, beta=0.5, seed=0)
    cfg = fl_loop.FLConfig(n_clients=4, rounds=3, local_steps=2, batch=16,
                           transport="packet", net=AsyncConfig(**_ASYNC),
                           local_train_s=0.01,
                           engine=EngineSpec(use_pallas=True))
    bare = fl_loop.run_federated(clients, test, cfg, hidden=(32, 16))
    path = str(tmp_path / "run.jsonl")
    with RecordingProbe(path, profiler=True) as probe:
        probed = fl_loop.run_federated(clients, test, cfg, hidden=(32, 16),
                                       probe=probe)
    assert probed == bare
    assert probed.wall_clock == bare.wall_clock
    recs = load_trace(path)
    assert validate_records(recs) == []
    prof = recs[-1]["metrics"]["__profile__"]
    assert prof["packet_core[n=4]"]["calls"] == 3
    assert prof["packet_core[n=4]"]["device_s"] > 0


def _close(got, want, dtype):
    # f32: the reference test's 3e-5; bf16: 2e-2 (both round the output to
    # bf16, so a last-bit difference is within it), on f32-converted values
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,hk,d,dv,causal,window", [
    (1, 1024, 1024, 4, 2, 64, 64, True, 0),
    (1, 1024, 1024, 4, 2, 64, 64, True, 256),
    (2, 512, 512, 8, 8, 32, 32, True, 0),
    (2, 512, 512, 8, 8, 32, 32, True, 256),
    (1, 512, 512, 4, 1, 128, 128, True, 0),
    (1, 512, 512, 4, 1, 128, 128, True, 256),
    (1, 1000, 1000, 4, 2, 64, 64, True, 0),       # ragged S = T
    (1, 1000, 1000, 4, 2, 64, 64, True, 100),
    (1, 384, 384, 4, 4, 192, 128, True, 0),       # Dv != D (MLA's 192/128)
    (1, 300, 700, 4, 2, 64, 64, False, 0),        # causal off, T != S
    (1, 300, 700, 4, 2, 256, 256, False, 64),     # Gemma's head_dim
    (1, 700, 300, 4, 2, 64, 64, False, 64),       # rows 363.. see no key
    (1, 333, 333, 4, 2, 256, 256, True, 0),       # T ragged in 64-key tiles
    (1, 129, 191, 4, 2, 128, 128, True, 0),       # S, T ragged in every tile
    (1, 191, 129, 4, 4, 96, 96, False, 0),        # D = Dv = 96, T < S
    (2, 4097, 4097, 8, 1, 128, 128, True, 0),     # GQA 8, one row past 4,096
    (1, 640, 640, 4, 2, 128, 128, True, 37),      # window ends inside a tile
    (1, 1100, 300, 4, 2, 128, 128, False, 100),   # rows 399.. see no key
    (1, 4096, 4096, 25, 5, 64, 64, True, 2048),   # hymba: GQA 5, window 2048
    (1, 2304, 2304, 128, 128, 192, 128, True, 0),  # MLA at DeepSeek's 128 heads
    (1, 4096, 1500, 6, 6, 64, 64, False, 0),      # whisper's cross-attention
])
def test_flash_attention_matches_plain_on_card(cuda_device, dtype, b, s, t, h,
                                               hk, d, dv, causal, window):
    gen = torch.Generator(device=cuda_device).manual_seed(s + t + d + window)
    q = torch.randn(b, s, h, d, device=cuda_device, generator=gen).to(dtype)
    k = torch.randn(b, t, hk, d, device=cuda_device, generator=gen).to(dtype)
    v = torch.randn(b, t, hk, dv, device=cuda_device, generator=gen).to(dtype)
    fa = flash_attention.flash_attention
    before = fa.launches
    got = fa(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, s, h, dv)
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
    _close(got, want, dtype)


def test_flash_attention_reads_strides_on_card(cuda_device):
    # q, k, v as views of fused projections (no copies): the kernel reads
    # them through their strides
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(2, 600, 8, 3 * 64, device=cuda_device, generator=gen)
    q, k, v = qkv[..., :64], qkv[:, :, :4, 64:128], qkv[:, :, 4:, 128:]
    got = flash_attention.flash_attention(q, k, v, window=128)
    want = flash_attention.flash_attention_plain(q.contiguous(), k.contiguous(),
                                                 v.contiguous(), window=128)
    _close(got, want, torch.float32)


@pytest.mark.parametrize("operand", ["q", "k", "v"])
@pytest.mark.parametrize("layout", ["last_stride", "offset_base"])
def test_flash_attention_f32_layouts_on_card(cuda_device, layout, operand):
    # float32 operands that cannot be read 16 bytes at a time (a last stride
    # other than 1, or a base one float past a 16-byte boundary) are copied
    # element by element into the same tiles
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    shapes = {"q": (1, 300, 4, 128), "k": (1, 300, 2, 128),
              "v": (1, 300, 2, 128)}
    ops = {n: torch.randn(sh, device=cuda_device, generator=gen)
           for n, sh in shapes.items()}
    sh = shapes[operand]
    if layout == "last_stride":
        x = torch.randn(*sh[:2], sh[3], sh[2], device=cuda_device,
                        generator=gen).transpose(2, 3)
        assert x.stride(3) != 1
    else:
        flat = torch.randn(int(np.prod(sh)) + 1, device=cuda_device,
                           generator=gen)
        x = flat[1:].view(sh)
        assert x.data_ptr() % 16 != 0
    ops[operand] = x
    got = flash_attention.flash_attention(ops["q"], ops["k"], ops["v"])
    want = flash_attention.flash_attention_plain(
        *(ops[n].contiguous() for n in "qkv"))
    _close(got, want, torch.float32)


def test_flash_attention_reads_strides_on_card_bf16(cuda_device):
    # the bf16 kernel's TMA reads the same views: strides and base
    # addresses 16-byte aligned
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, 600, 8, 3 * 64, device=cuda_device,
                      generator=gen).bfloat16()
    q, k, v = qkv[..., :64], qkv[:, :, :4, 64:128], qkv[:, :, 4:, 128:]
    assert all(flash_attention.tma_layout_ok(x) for x in (q, k, v))
    got = flash_attention.flash_attention(q, k, v, window=128)
    want = flash_attention.flash_attention_plain(q.contiguous(), k.contiguous(),
                                                 v.contiguous(), window=128)
    _close(got, want, torch.bfloat16)


def test_flash_attention_bf16_misaligned_stride_raises(cuda_device):
    # 68 bf16 columns: 136-byte rows, which TMA cannot address; the wrapper
    # raises rather than copying or taking another path
    q = torch.zeros(1, 256, 4, 68, dtype=torch.bfloat16,
                    device=cuda_device)[..., :64]
    k = torch.zeros(1, 256, 2, 64, dtype=torch.bfloat16, device=cuda_device)
    fa = flash_attention.flash_attention
    before = fa.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa(q, k, k)
    assert fa.launches == before
    fa(q.float(), k.float(), k.float())      # float32 takes any strides
    torch.cuda.synchronize()
    assert fa.launches == before + 1


@requires_cuda
def test_flash_dispatch_needs_declared_positions_on_card(cuda_device,
                                                         monkeypatch):
    """Above DENSE_MAX_SEQ the card runs B6, which masks by arange(S) /
    arange(T): undeclared positions raise (offset ones included, which B6
    would mask wrongly), while ``forward`` declares its arange and keeps
    the logits of the same layers run with that declaration spelt out."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tr
    cfg = get_smoke("qwen3_0p6b")
    monkeypatch.setattr(A, "DENSE_MAX_SEQ", 128)
    params = M.init_params(cfg, prng.PRNGKey(0, device=cuda_device),
                           device=cuda_device)
    mix = M.cast_params(params, cfg)["group0"][0]["mix"]
    s = 256
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, s, cfg.d_model, device=cuda_device, generator=gen)
    pos = torch.arange(s, device=cuda_device)
    fa = flash_attention.flash_attention
    with torch.no_grad():
        for positions in (pos, pos + 7):
            with pytest.raises(NotImplementedError, match="A11"):
                A.multihead_attention(mix, x, cfg, positions=positions)
        before = fa.launches
        A.multihead_attention(mix, x, cfg, positions=pos,
                              arange_positions=True)
        assert fa.launches == before + 1
        tokens = torch.randint(0, cfg.vocab, (2, s), device=cuda_device,
                               generator=gen)
        before = fa.launches
        got, _ = M.forward(params, cfg, {"tokens": tokens})
        assert fa.launches == before + cfg.n_layers
        cast = M.cast_params(params, cfg)
        h = M._embed(cast, cfg, tokens)
        for i, spec in enumerate(tr.group_plan(cfg)):
            h, _ = tr.apply_group(cast[f"group{i}"], h, cfg, spec,
                                  positions=pos, arange_positions=True)
        want = M._head(cast, cfg, h)
    assert torch.equal(got, want)


@requires_cuda
@pytest.mark.parametrize("arch,launches", [
    ("granite_moe_1b", 2), ("deepseek_v2_236b", 2), ("hymba_1p5b", 2),
    ("mamba2_130m", 0), ("whisper_tiny", 6)])
def test_zoo_forward_and_decode_card_match_cpu(cuda_device, monkeypatch, arch,
                                               launches):
    """Each family's smoke model on the card against the CPU, float32: the
    prefill above a patched DENSE_MAX_SEQ (B6 once per attention layer;
    whisper's encoder and its decoder's cross-attention over 192 frames,
    keys padded to 256 on the CPU, go through B6 too) within 1e-4, and 8
    decode steps within 1e-4."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import attention as A
    from repro_torch.models import frontends as F
    from repro_torch.models import model as M
    cfg = get_smoke(arch).with_(attn_q_block=64, attn_kv_block=128)
    monkeypatch.setattr(A, "DENSE_MAX_SEQ", 128)
    params = M.init_params(cfg, prng.PRNGKey(0, device=cuda_device),
                           device=cuda_device)
    cpu = copy.deepcopy(params).cpu()
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 256), device=cuda_device,
                                     generator=gen)}
    if cfg.is_enc_dec:
        batch["frames"] = F.synth_audio_frames(prng.PRNGKey(2, device=cuda_device),
                                               2, 192, cfg.d_model)
    fa = flash_attention.flash_attention
    with torch.no_grad():
        before = fa.launches
        got, aux = M.forward(params, cfg, batch)
        torch.cuda.synchronize()
        assert fa.launches == before + launches
        want, want_aux = M.forward(cpu, cfg, {k: v.cpu() for k, v in batch.items()})
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-5)
        caches = M.init_caches(cfg, 2, 8, device=cuda_device)
        caches_cpu = M.init_caches(cfg, 2, 8, device="cpu")
        for t in range(8):
            tok = batch["tokens"][:, t:t + 1]
            g, caches = M.decode_step(params, cfg, tok, caches, t)
            w, caches_cpu = M.decode_step(cpu, cfg, tok.cpu(), caches_cpu, t)
            torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


@requires_cuda
def test_flash_attention_autograd_on_card(cuda_device, monkeypatch):
    """B6 under autograd on the card (it refused it until it had a
    backward): the forward launches once, the backward once, each counted,
    and the gradients of q, k and v are autograd's through the plain
    version; a gradient only of v leaves dq's kernel out.  A model's loss
    above DENSE_MAX_SEQ is differentiated through B6 and matches the
    CPU's blockwise scan."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(1, 256, 4, 64, device=cuda_device, generator=gen)
    k = torch.randn(1, 256, 2, 64, device=cuda_device, generator=gen)
    fa = flash_attention.flash_attention
    for grad_of in ("q", "k", "v"):
        args = {"q": q, "k": k, "v": k.clone()}
        args[grad_of] = args[grad_of].clone().requires_grad_(True)
        before, before_b = fa.launches, fa.backward_launches
        out = fa(args["q"], args["k"], args["v"])
        (g,) = torch.autograd.grad(out.square().sum(), args[grad_of])
        torch.cuda.synchronize()
        assert (fa.launches, fa.backward_launches) == (before + 1,
                                                       before_b + 1)
        x = args[grad_of].detach().requires_grad_(True)
        ref = {**args, grad_of: x}
        (want,) = torch.autograd.grad(flash_attention.flash_attention_plain(
            ref["q"], ref["k"], ref["v"]).square().sum(), x)
        assert float((g - want).abs().max()) <= 1e-4 * float(want.abs().max())
    cfg = get_smoke("qwen3_0p6b")
    monkeypatch.setattr(A, "DENSE_MAX_SEQ", 128)
    params = M.init_params(cfg, prng.PRNGKey(0, device=cuda_device),
                           device=cuda_device)
    cpu = copy.deepcopy(params).cpu()
    tokens = torch.randint(0, cfg.vocab, (1, 256), device=cuda_device,
                           generator=gen)
    before, before_b = fa.launches, fa.backward_launches
    loss = M.loss_fn(params, cfg, {"tokens": tokens, "targets": tokens})
    grads = torch.autograd.grad(loss, list(params.parameters()))
    torch.cuda.synchronize()
    assert fa.launches - before == 2 * cfg.n_layers        # remat recomputes
    assert fa.backward_launches - before_b == cfg.n_layers
    t = tokens.cpu()
    loss_c = M.loss_fn(cpu, cfg, {"tokens": t, "targets": t})
    want = torch.autograd.grad(loss_c, list(cpu.parameters()))
    assert abs(float(loss) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for g, w in zip(grads, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


#: the backward's instances: chip_smoke.py's (Qwen3-0.6B's train layer,
#: granite's head size, MLA's 192 / 128, hymba's window, whisper's cross
#: shape) and edge cases: odd S and T, S and T off every tile (Qwen's and
#: MLA's head sizes, and a causal window), D = 256, a window over a
#: shorter T in which the last row sees one key
BWD_CASES = [
    (1, 4096, 4096, 16, 8, 128, 128, True, 0),
    (1, 2048, 2048, 16, 8, 64, 64, True, 0),
    (1, 1024, 1024, 16, 16, 192, 128, True, 0),
    (1, 4096, 4096, 25, 5, 64, 64, True, 2048),
    (2, 448, 1500, 6, 6, 64, 64, False, 0),
    (1, 333, 517, 4, 2, 96, 96, True, 0),
    (1, 517, 333, 4, 2, 40, 72, False, 0),
    (1, 4097, 4097, 8, 4, 128, 128, True, 0),
    (1, 1057, 1057, 4, 4, 192, 128, True, 0),
    (1, 1000, 1000, 4, 2, 64, 64, True, 100),
    (1, 300, 300, 4, 2, 256, 256, True, 37),
    (1, 700, 300, 4, 2, 64, 64, False, 401),     # row 699 sees key 299 only
]


def _bwd_inputs(dtype, b, s, t, h, hk, d, dv, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, s, h, d, device=device, generator=gen).to(dtype)
    k = torch.randn(b, t, hk, d, device=device, generator=gen).to(dtype)
    v = torch.randn(b, t, hk, dv, device=device, generator=gen).to(dtype)
    g = torch.randn(b, s, h, dv, device=device, generator=gen).to(dtype)
    return q, k, v, g


def _grads_close(got, want, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        err = float((a.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,hk,d,dv,causal,window", BWD_CASES)
def test_flash_attention_bwd_matches_plain_on_card(cuda_device, dtype, b, s,
                                                   t, h, hk, d, dv, causal,
                                                   window):
    """The backward kernels against autograd through the plain forward
    (1e-4 / 2e-2 of each gradient's largest |g|) and against the plain
    backward from the same out and lse, bitwise across two runs, with a
    non-contiguous dout read as it lies."""
    q, k, v, g = _bwd_inputs(dtype, b, s, t, h, hk, d, dv, cuda_device,
                             s + t + d)
    kw = dict(causal=causal, window=window)
    fa = flash_attention
    out, lse = fa._launch_forward(q, k, v, causal, window, True)
    # dout as the transpose of a (B, S, Dv, H) tensor: no stride is 1 where
    # the kernels read along Dv
    g_nc = g.transpose(2, 3).contiguous().transpose(2, 3)
    assert not g_nc.is_contiguous() and torch.equal(g_nc, g)
    before = fa.flash_attention.backward_launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, g_nc, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.backward_launches == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_plain(*xs, **kw), xs, g)
    _grads_close(got, want, dtype)
    plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)
    _grads_close(got, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_refuses_rows_without_keys_on_card(cuda_device,
                                                           dtype):
    """A call with rows that see no key (window 64 over 300 keys: rows
    363.. see none) raises under autograd before anything launches, and so
    does the backward on its own; without autograd the forward answers."""
    q, k, v, g = _bwd_inputs(dtype, 1, 700, 300, 4, 2, 64, 64, cuda_device, 9)
    fa = flash_attention
    kw = dict(causal=False, window=64)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (fa.flash_attention.launches,
              fa.flash_attention.backward_launches)
    with pytest.raises(ValueError, match="rows 363..699 see no key"):
        fa.flash_attention(*xs, **kw)
    out, lse = fa._launch_forward(q, k, v, False, 64, True)
    with pytest.raises(ValueError, match="see no key"):
        fa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches,
            fa.flash_attention.backward_launches) == (before[0] + 1,
                                                      before[1])
    with torch.no_grad():
        got = fa.flash_attention(*xs, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-5 if
                               dtype == torch.float32 else 2e-2, rtol=0)
    torch.testing.assert_close(got[0, 363:].float(), v.float().mean(
        1).repeat_interleave(2, dim=1).expand(337, 4, 64), atol=3e-5 if
        dtype == torch.float32 else 2e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_leaves_output_bitwise_on_card(cuda_device, dtype):
    """The forward with the row statistic written gives the same output
    bits as without it, and its lse is the plain version's."""
    for (b, s, t, h, hk, d, dv, causal, window) in BWD_CASES:
        q, k, v, _ = _bwd_inputs(dtype, b, s, t, h, hk, d, dv, cuda_device, 5)
        bare, none = flash_attention._launch_forward(q, k, v, causal, window,
                                                     False)
        out, lse = flash_attention._launch_forward(q, k, v, causal, window,
                                                   True)
        assert none is None and torch.equal(bare, out)
        _, want = flash_attention.flash_attention_plain(
            q, k, v, causal=causal, window=window, return_lse=True)
        live = want > -1e29
        torch.testing.assert_close(lse[live], want[live], atol=1e-4,
                                   rtol=1e-5)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_through_b6_on_card(cuda_device, monkeypatch, policy):
    """A 2-layer step above DENSE_MAX_SEQ under each remat policy: B6's
    forward launches again in each layer's recompute (never a stale
    buffer), and the gradients equal those of the same step without
    remat."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    monkeypatch.setattr(A, "DENSE_MAX_SEQ", 128)
    cfg = get_smoke("qwen3_0p6b").with_(remat_policy=policy)
    params = M.init_params(cfg, prng.PRNGKey(0, device=cuda_device),
                           device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (2, 384), device=cuda_device,
                           generator=gen)
    batch = {"tokens": tokens, "targets": tokens.roll(1, dims=1)}
    fa = flash_attention.flash_attention
    grads = {}
    for remat in (True, False):
        before, before_b = fa.launches, fa.backward_launches
        loss = M.loss_fn(params, cfg.with_(remat=remat), batch)
        grads[remat] = torch.autograd.grad(loss, list(params.parameters()))
        torch.cuda.synchronize()
        assert fa.launches - before == cfg.n_layers * (2 if remat else 1)
        assert fa.backward_launches - before_b == cfg.n_layers
    for a, w in zip(grads[True], grads[False]):
        assert torch.equal(a, w)


@requires_cuda
def test_train_step_on_card_matches_cpu(cuda_device, tmp_path):
    """One client (a gloo group of one) of smoke qwen3's train step, kernels
    on: the card's local update against the CPU's (loss within 1e-5
    relative, each leaf within 1e-4 of its largest |u|), the card's
    aggregate replayed on the CPU from the card's update bitwise (B1 once
    on the card), and the whole step on the card, finite."""
    import torch.distributed as dist
    from repro_torch.configs import get_smoke
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_params
    from repro_torch.testing import train_cfg
    from repro_torch.training import dist_step
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        cfg = train_cfg("qwen3_0p6b", {"kernels": True})
        card = init_params(cfg, prng.PRNGKey(0, device=cuda_device),
                           device=cuda_device)
        cpu = copy.deepcopy(card).cpu()
        batch = next(lm_batches(np.random.default_rng(0), cfg.vocab, 8, 64, 1))
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        lay_c, lay_p = dist_step.FlatLayout(card), dist_step.FlatLayout(cpu)
        u_c, loss_c, _ = dist_step._local_update(
            cfg, card, {k: v.to(cuda_device) for k, v in batch.items()}, 0.2,
            lay_c, 1)
        u_p, loss_p, _ = dist_step._local_update(cfg, cpu, batch, 0.2, lay_p, 1)
        assert abs(float(loss_c) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
        for o, n in lay_p.spans:
            want = u_p[o:o + n]
            err = float((u_c[o:o + n].cpu() - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max())
        key = prng.PRNGKey(1, device=cuda_device)
        res = torch.zeros_like(u_c)
        before = gather_quant.gather_quant.launches
        got = dist_step._aggregate(cfg, u_c, res, key, lay_c, None)
        torch.cuda.synchronize()
        assert gather_quant.gather_quant.launches == before + 1
        want = dist_step._aggregate(cfg, u_c.cpu(), res.cpu(), key.cpu(),
                                    lay_p, None)
        assert all(_same(a, b) for a, b in zip(got, want))
        fresh = init_params(cfg, prng.PRNGKey(0, device=cuda_device),
                            device=cuda_device)
        bundle = dist_step.make_train_step(cfg, make_test_mesh(), lr=0.2)
        fresh, res, metrics = bundle.step(
            fresh, torch.zeros(lay_c.size, device=cuda_device),
            {k: v.to(cuda_device) for k, v in batch.items()}, key)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(res).all()
        assert all(torch.isfinite(p).all() for p in fresh.parameters())
    finally:
        dist.destroy_process_group()
