"""The port's Mamba-2 SSD and Hymba hybrid models (mamba2-130m,
hymba-1.5b) against the JAX reference on the CPU, at each config's
``smoke()`` size.

Tolerances as in tests/test_torch_zoo_moe.py: weights within 1 ulp of the
reference's from the same key, float32 logits and decode steps within
1e-4, caches within 1e-5 (the SSM state is float32), bf16 logits within
2e-2 (see test_forward_bf16_matches_reference).  The chunk's prefix sum is ``torch.cumsum``, not
XLA's blocked order: a float32 ulp inside the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.testing  # noqa: F401  (one torch thread per xdist worker)
from repro.configs import get_smoke as ref_get_smoke
from repro.models import attention as RA
from repro.models import model as RM
from repro.models import ssm as RSSM
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import get_smoke
from repro_torch.core import prng
from repro_torch.core.pytree import tree_leaves
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.serving import Request, ServingEngine

CPU = "cpu"
ARCHS = ["mamba2_130m", "hymba_1p5b"]


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    """(cfg, reference cfg, reference params, the port's own init)."""
    arch = request.param
    cfg, rcfg = get_smoke(arch), ref_get_smoke(arch)
    ref_params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.init_params(cfg, prng.PRNGKey(0, device=CPU), device=CPU)
    return cfg, rcfg, ref_params, params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_init_params_matches_reference(zoo):
    cfg, _, ref_params, params = zoo
    ref = _np(ref_params)
    assert M.param_count(params) == sum(x.size for x in jax.tree_util.tree_leaves(ref))
    for name, p in params.named_parameters():
        np.testing.assert_array_max_ulp(p.detach().numpy(), M.jax_leaf(ref, name),
                                        1)


def test_params_from_jax_round_trip(zoo):
    cfg, _, ref_params, _ = zoo
    ref = _np(ref_params)
    ported = M.params_from_jax(ref, cfg, device=CPU)
    got = dict(ported.named_parameters())
    for name, p in got.items():
        np.testing.assert_array_equal(p.detach().numpy(), M.jax_leaf(ref, name))
    ssm = "group0.0.mix.ssm" if cfg.arch_type == "hybrid" else "group0.0.mix"
    leaves = ("w_x", "w_z", "w_B", "w_C", "w_dt", "conv", "A_log", "D",
              "dt_bias", "norm", "out_proj")
    assert {f"{ssm}.{n}" for n in leaves} <= set(got)
    if cfg.arch_type == "hybrid":
        assert got["group0.0.mix.beta1"].shape == ()
        assert {f"group0.0.mix.{n}" for n in ("attn.wq", "attn_out_norm",
                                               "ssm_out_norm", "beta2")} <= set(got)


def _forward_pair(zoo, s, **overrides):
    cfg, rcfg, ref_params, _ = zoo
    cfg, rcfg = cfg.with_(**overrides), rcfg.with_(**overrides)
    ported = M.params_from_jax(_np(ref_params), cfg, device=CPU)
    tokens = _tokens(cfg, 2, s, seed=s)
    want, _ = RM.forward(ref_params, rcfg, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = M.forward(ported, cfg, {"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("branch", ["dense", "blockwise"])
def test_forward_matches_reference(zoo, monkeypatch, branch):
    # dense: S = 32 (4 SSD chunks of 8); blockwise: S = 256 (32 chunks)
    # with DENSE_MAX_SEQ 128 and 64/32 attention blocks, hymba's window of
    # 32 on the banded branch
    s, kw = 32, {}
    if branch == "blockwise":
        for mod in (RA, A):
            monkeypatch.setattr(mod, "DENSE_MAX_SEQ", 128)
        s, kw = 256, dict(attn_q_block=64, attn_kv_block=32)
    got, want = _forward_pair(zoo, s, **kw)
    assert got.shape == want.shape == (2, s, zoo[0].vocab)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_forward_bf16_matches_reference(zoo):
    # bf16: the reference and the port each round every op to bf16 in
    # their own order, and through the SSD's chains the two drift apart
    # by up to ~2.8% of the largest logit (mamba2), with the port no
    # further from the float32 logits than the reference (5.1% against
    # 5.3% at the worst position, 0.40% against 0.43% RMS).  So: the RMS
    # gap within 2e-2 of the largest logit, and the port's distance from
    # float32 within 1.25x the reference's, at the worst position and RMS
    got, want = _forward_pair(zoo, 32, compute_dtype="bfloat16")
    exact, _ = _forward_pair(zoo, 32)
    top = np.abs(exact).max()

    def rms(a):
        return float(np.sqrt(np.mean(a * a)))

    assert rms(got - want) <= 2e-2 * np.abs(want).max()
    assert np.abs(got - exact).max() <= 1.25 * np.abs(want - exact).max()
    assert rms(got - exact) <= 1.25 * rms(want - exact)
    assert np.abs(got - exact).max() <= 0.1 * top


def test_decode_stepping_matches_reference(zoo):
    # 16 steps against the reference's jitted decode step: logits within
    # 1e-4, every cache leaf (attention K/V, SSM state and conv history)
    # within 1e-5
    cfg, rcfg, ref_params, params = zoo
    s = 16
    tokens = _tokens(cfg, 2, s, seed=1)
    ref_step = jax.jit(lambda p, tok, c, pos: RM.decode_step(p, rcfg, tok, c, pos))
    rc = RM.init_caches(rcfg, 2, s)
    pc = M.init_caches(cfg, 2, s, device=CPU)
    for t in range(s):
        want, rc = ref_step(ref_params, jnp.asarray(tokens[:, t:t + 1]), rc,
                            jnp.int32(t))
        with torch.no_grad():
            got, pc = M.decode_step(params, cfg, torch.from_numpy(tokens[:, t:t + 1]),
                                    pc, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
    mix = pc["group0"]["mix"]
    assert set(mix) == ({"state", "conv"} if cfg.arch_type == "ssm"
                        else {"attn", "ssm"})
    for a, b in zip(tree_leaves(pc), jax.tree_util.tree_leaves(rc), strict=True):
        assert a.dtype == getattr(torch, str(b.dtype))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_decode_matches_forward(zoo):
    # the reference's own oracle (tests/test_models.py) on the port: hymba
    # with its window off, as there (the windowed path needs S > window)
    cfg, _, _, params = zoo
    if cfg.arch_type == "hybrid":
        cfg = cfg.with_(sliding_window=0)
    s = 16
    tokens = torch.from_numpy(_tokens(cfg, 2, s, seed=2))
    with torch.no_grad():
        full, _ = M.forward(params, cfg, {"tokens": tokens})
        caches = M.init_caches(cfg, 2, s, device=CPU)
        steps = [M.decode_step(params, cfg, tokens[:, t:t + 1], caches, t)[0]
                 for t in range(s)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=2e-3)


def test_engine_tokens_equal_reference_engine(zoo):
    # the continuous-batching engine against the reference's: greedy tokens
    # exactly; a recycled slot's SSM state is zeroed
    cfg, rcfg, ref_params, params = zoo
    spec = [(5, 4), (9, 3), (3, 5)]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n, _ in spec]
    want = [RefRequest(uid=i, prompt=p, max_new=m)
            for i, (p, (_, m)) in enumerate(zip(prompts, spec))]
    RefEngine(rcfg, ref_params, max_batch=2, cache_len=32).run(want)
    got = [Request(uid=i, prompt=p, max_new=m)
           for i, (p, (_, m)) in enumerate(zip(prompts, spec))]
    ServingEngine(cfg, params, max_batch=2, cache_len=32, device=CPU).run(got)
    assert [r.out for r in got] == [r.out for r in want]


# ---------------------------------------------------------------------------
# hymba's ring cache, and the SSD pieces on their own
# ---------------------------------------------------------------------------

def test_hymba_ring_decode_matches_reference_and_windowed_forward():
    # a window of 8 over a ring cache of 8 slots, 24 steps: against the
    # reference's ring decode (1e-4, caches 1e-5), and the port's ring
    # decode against its own windowed forward (the reference's oracle, 2e-3)
    cfg = get_smoke("hymba_1p5b").with_(sliding_window=8)
    rcfg = ref_get_smoke("hymba_1p5b").with_(sliding_window=8)
    ref_params = RM.init_params(rcfg, jax.random.PRNGKey(2))
    params = M.params_from_jax(_np(ref_params), cfg, device=CPU)
    s = 24
    tokens = _tokens(cfg, 2, s, seed=3)
    ref_step = jax.jit(lambda p, tok, c, pos: RM.decode_step(p, rcfg, tok, c, pos,
                                                              ring=True))
    rc = RM.init_caches(rcfg, 2, 8)
    pc = M.init_caches(cfg, 2, 8, device=CPU)
    steps = []
    for t in range(s):
        want, rc = ref_step(ref_params, jnp.asarray(tokens[:, t:t + 1]), rc,
                            jnp.int32(t))
        with torch.no_grad():
            got, pc = M.decode_step(params, cfg, torch.from_numpy(tokens[:, t:t + 1]),
                                    pc, t, ring=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
        steps.append(got)
    for a, b in zip(tree_leaves(pc), jax.tree_util.tree_leaves(rc), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    with torch.no_grad():
        full, _ = M.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_forward_matches_reference(dtype):
    # the chunked SSD alone, groups shared by several heads (hymba's
    # G = H / 5 pattern at 10 heads over 2 groups), 6 chunks: float32
    # within 1e-5, bf16 within 2e-2 of the largest output
    cfg = get_smoke("hymba_1p5b").with_(ssm_heads=10, ssm_groups=2,
                                        compute_dtype=dtype)
    rcfg = ref_get_smoke("hymba_1p5b").with_(ssm_heads=10, ssm_groups=2,
                                             compute_dtype=dtype)
    ref_p = RSSM.init_ssm(jax.random.PRNGKey(4), rcfg)
    p = M._tree(SSM.init_ssm(prng.PRNGKey(4, device=CPU), cfg),
                getattr(torch, dtype))
    x = np.random.default_rng(6).standard_normal((2, 48, cfg.d_model)).astype(
        np.float32)
    jt = getattr(jnp, dtype)
    want = RSSM.ssd_forward(jax.tree_util.tree_map(lambda a: a.astype(jt), ref_p),
                            jnp.asarray(x, jt), rcfg)
    with torch.no_grad():
        got = SSM.ssd_forward(p, torch.from_numpy(x).to(getattr(torch, dtype)),
                              cfg)
    want = np.asarray(want, np.float32)
    tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=1e-5 if dtype == "float32" else 0)
    with pytest.raises(ValueError, match="ssm_chunk"):
        SSM.ssd_forward(p, torch.zeros((1, 12, cfg.d_model),
                                       dtype=getattr(torch, dtype)), cfg)


def test_softplus_is_jax_logaddexp():
    # jax.nn.softplus (logaddexp(x, 0)) has no linear threshold; torch's
    # F.softplus switches to x above 20.  (Below about -87 the value is
    # subnormal, which XLA's CPU backend flushes to zero.)
    x = np.concatenate([np.linspace(-80, 80, 2001, dtype=np.float32),
                        np.array([0.0, -0.0, 88.0], np.float32)])
    got = SSM.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)), rtol=2e-7,
                               atol=0)
