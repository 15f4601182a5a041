"""The port on the card: each CUDA kernel against its plain version, and
a round and the FL loop against the same on the CPU.  Every test needs an
NVIDIA GPU and skips without one.

This file imports neither JAX nor the reference package, so it also runs
on a GPU host that has no JAX, without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

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
