"""The port's MoE and MLA models (granite-moe-1b, DeepSeek-V2) against the
JAX reference on the CPU, at each config's ``smoke()`` size.

Weights from the same key are held within 1 ulp (``prng.normal``'s bound,
XLA's ``erf_inv`` replayed), float32 logits and decode steps within 1e-4,
caches within 1e-5: layer ops are not bitwise between the packages
(tests/test_torch_models.py).  The blockwise branch is reached by patching
``DENSE_MAX_SEQ`` down in both packages (the reference's ``mla`` module
holds its own copy of the name).  Routing ties follow ``lax.top_k``: the
lower expert index first.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.testing  # noqa: F401  (one torch thread per xdist worker)
from repro.configs import get_smoke as ref_get_smoke
from repro.models import attention as RA
from repro.models import mla as RMLA
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import get_smoke
from repro_torch.core import prng
from repro_torch.core.pytree import tree_leaves
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serving import Request, ServingEngine

CPU = "cpu"
ARCHS = ["granite_moe_1b", "deepseek_v2_236b"]


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
    g = f"group{int(cfg.first_dense_layers > 0)}.0.ffn"   # the MoE group
    names = {n for n, _ in params.named_parameters()}
    assert {f"{g}.router", f"{g}.we_g", f"{g}.we_u", f"{g}.we_d"} <= names


def test_params_from_jax_round_trip(zoo):
    cfg, _, ref_params, _ = zoo
    ref = _np(ref_params)
    ported = M.params_from_jax(ref, cfg, device=CPU)
    for name, p in ported.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), M.jax_leaf(ref, name))
    if cfg.attn_kind == "mla":
        mix = dict(ported.named_parameters())
        assert {f"group0.0.mix.{n}" for n in ("wdkv", "wkr", "wuk", "wuv", "wo",
                                               "kv_norm", "wdq", "wuq",
                                               "q_norm")} <= set(mix)
        assert "group1.0.ffn.shared.wg" in mix


def _forward_pair(zoo, s, **overrides):
    cfg, rcfg, ref_params, _ = zoo
    cfg, rcfg = cfg.with_(**overrides), rcfg.with_(**overrides)
    ported = M.params_from_jax(_np(ref_params), cfg, device=CPU)
    tokens = _tokens(cfg, 2, s, seed=s)
    want, want_aux = RM.forward(ref_params, rcfg, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = M.forward(ported, cfg, {"tokens": torch.from_numpy(tokens)})
    return (got.float().numpy(), np.asarray(want, np.float32), float(aux),
            float(want_aux))


@pytest.mark.parametrize("branch", ["dense", "blockwise"])
def test_forward_matches_reference(zoo, monkeypatch, branch):
    # dense: S = 32; blockwise: S = 256 with DENSE_MAX_SEQ 128 and 64/32
    # blocks, 512 tokens, so the MoE takes its factor-based capacity and
    # drops tokens.  The MoE aux loss summed over layers alike.
    kw = {}
    s = 32
    if branch == "blockwise":
        for mod in (RA, RMLA, A):
            monkeypatch.setattr(mod, "DENSE_MAX_SEQ", 128)
        s, kw = 256, dict(attn_q_block=64, attn_kv_block=32)
    got, want, aux, want_aux = _forward_pair(zoo, s, **kw)
    assert got.shape == want.shape == (2, s, zoo[0].vocab)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert aux > 0
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)


def _record_routes(monkeypatch):
    """Watch every MoE dispatch of both packages: each call's top-k expert
    sets (sorted), recomputed from its router as the call computes them."""
    routes = {"ref": [], "port": []}
    real_ref, real_port = RMOE._moe_core, MOE._moe_core

    def ref_core(p, xt, cfg):
        # traced inside the reference's layer scan: read back by callback
        probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
        top = jax.lax.top_k(probs, cfg.moe_top_k)[1]
        jax.debug.callback(lambda t: routes["ref"].append(np.sort(t, -1)), top,
                           ordered=True)
        return real_ref(p, xt, cfg)

    def port_core(p, xt, cfg):
        probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
        routes["port"].append(np.sort(top[:, :cfg.moe_top_k].numpy(), -1))
        return real_port(p, xt, cfg)

    monkeypatch.setattr(RMOE, "_moe_core", ref_core)
    monkeypatch.setattr(MOE, "_moe_core", port_core)
    return routes


def test_forward_bf16_matches_reference(zoo, monkeypatch):
    # bf16: the router's logits are bf16 products, so two experts often tie
    # to the ulp, and a one-ulp difference between the packages' matmuls
    # flips one.  A position's logits depend on the routing of that position
    # and the ones before it, so every position before a row's first
    # flipped token (in any layer) is held within 2e-2 of the largest
    # logit; the flipped share is what the bf16 gate cannot cover
    # (chip_smoke.py reports it on the card, where it is not gated either)
    routes = _record_routes(monkeypatch)
    got, want, _, _ = _forward_pair(zoo, 32, compute_dtype="bfloat16")
    b, s = got.shape[:2]
    flipped = np.zeros((b, s), bool)
    for ref, port in zip(routes["ref"], routes["port"], strict=True):
        flipped |= (ref != port).any(-1).reshape(b, s)
    clean = np.cumsum(flipped, axis=1) == 0          # no flip at or before t
    assert len(routes["ref"]) == len(routes["port"]) == zoo[0].n_layers - \
        zoo[0].first_dense_layers
    assert clean.sum() >= s // 2, f"routing flips at {np.argwhere(flipped)}"
    err = np.abs(got - want).max(-1)[clean]
    assert err.max() <= 2e-2 * np.abs(want).max(), err.max()


def _decode_pair(cfg, rcfg, ref_params, params):
    # 16 steps against the reference's jitted decode step: logits within
    # 1e-4, every cache leaf within 1e-5
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
    for a, b in zip(tree_leaves(pc), jax.tree_util.tree_leaves(rc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_decode_stepping_matches_reference(zoo):
    # DeepSeek's config decodes MLA absorbed
    _decode_pair(*zoo)


def test_mla_naive_decode_matches_reference():
    # MLA's naive decode (K/V rebuilt from the latent cache every step)
    cfg = get_smoke("deepseek_v2_236b").with_(mla_absorbed=False)
    rcfg = ref_get_smoke("deepseek_v2_236b").with_(mla_absorbed=False)
    ref_params = RM.init_params(rcfg, jax.random.PRNGKey(1))
    _decode_pair(cfg, rcfg, ref_params,
                 M.params_from_jax(_np(ref_params), cfg, device=CPU))


def test_decode_matches_forward(zoo):
    # the reference's own oracle (tests/test_models.py) on the port
    cfg, _, _, params = zoo
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
    # the continuous-batching engine (ragged prompts on 2 slots) against
    # the reference's: greedy tokens exactly
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
# the MoE FFN and MLA on their own
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    cfg, rcfg = get_smoke("granite_moe_1b"), ref_get_smoke("granite_moe_1b")
    ref_p = RMOE.init_moe(jax.random.PRNGKey(3), rcfg)
    p = MOE.init_moe(prng.PRNGKey(3, device=CPU), cfg)
    return cfg, rcfg, ref_p, p


def _moe_pair(cfg, rcfg, ref_p, p, x):
    want, want_aux = RMOE.apply_moe(ref_p, jnp.asarray(x), rcfg)
    cast = M._tree(p, torch.float32)
    with torch.no_grad():
        got, aux = MOE.apply_moe(cast, torch.from_numpy(x), cfg)
    return got.numpy(), np.asarray(want), float(aux), float(want_aux)


@pytest.mark.parametrize("case", ["dropless", "capacity", "chunked"])
def test_apply_moe_matches_reference(granite, monkeypatch, case):
    # dropless: 32 tokens (capacity = T); capacity: 512 tokens at factor
    # 0.5 (many dropped); chunked: MOE_TOKEN_CHUNK patched to 256 in both
    # packages, 1024 tokens in 4 chunks of factor capacity, aux averaged
    cfg, rcfg, ref_p, p = granite
    shape = {"dropless": (2, 16), "capacity": (2, 256), "chunked": (4, 256)}[case]
    if case == "capacity":
        cfg, rcfg = cfg.with_(capacity_factor=0.5), rcfg.with_(capacity_factor=0.5)
    if case == "chunked":
        for mod in (RMOE, MOE):
            monkeypatch.setattr(mod, "MOE_TOKEN_CHUNK", 256)
    x = np.random.default_rng(len(case)).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    got, want, aux, want_aux = _moe_pair(cfg, rcfg, ref_p, p, x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)


@pytest.mark.parametrize("router", ["zero", "duplicate_columns"])
def test_apply_moe_tied_router_probabilities(granite, router):
    # exact ties among the router probabilities: lax.top_k takes the lower
    # expert index first, and so must the port (all experts tied, or
    # experts 1 and 2 tied for every token)
    cfg, rcfg, ref_p, p = granite
    p = copy.deepcopy(p)
    w = np.asarray(ref_p["router"]).copy()
    if router == "zero":
        w[:] = 0.0
    else:
        w[:, 2] = w[:, 1]
    ref_p = {**ref_p, "router": jnp.asarray(w)}
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(w))
    x = np.random.default_rng(5).standard_normal((2, 64, cfg.d_model)).astype(
        np.float32)
    got, want, aux, want_aux = _moe_pair(cfg, rcfg, ref_p, p, x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)


def test_mla_absorbed_equals_naive():
    # the reference's own oracle on the port: the absorbed decode against
    # the naive one, several steps into the cache
    cfg = get_smoke("deepseek_v2_236b")
    params = M.init_params(cfg, prng.PRNGKey(0, device=CPU), device=CPU)
    tokens = torch.from_numpy(_tokens(cfg, 2, 6, seed=3))
    outs = {}
    for absorbed in (False, True):
        c = cfg.with_(mla_absorbed=absorbed)
        caches = M.init_caches(c, 2, 8, device=CPU)
        with torch.no_grad():
            outs[absorbed] = [M.decode_step(params, c, tokens[:, t:t + 1],
                                            caches, t)[0] for t in range(6)]
    np.testing.assert_allclose(torch.cat(outs[True], 1).numpy(),
                               torch.cat(outs[False], 1).numpy(), atol=1e-4,
                               rtol=1e-4)
