"""The port's serving path (``training/serve.py``, ``serving/engine.py``)
against the JAX reference, on the CPU, at Qwen3-0.6B's smoke config.

Tokens are greedy argmaxes, so they are compared exactly; logits carry a
tolerance (float32 layer ops differ by ulps between the packages, see
tests/test_torch_models.py).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import model as RM
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro.training import serve as ref_serve
from repro_torch.configs import PREFILL_32K, InputShape, get_smoke
from repro_torch.models import model as M
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import serve

CPU = "cpu"


@pytest.fixture(scope="module")
def smoke():
    cfg, rcfg = get_smoke("qwen3_0p6b"), ref_get_smoke("qwen3_0p6b")
    ref_params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                               cfg, device=CPU)
    return cfg, rcfg, ref_params, params


def _requests(cls, vocab, spec, seed):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=n).tolist(),
                max_new=m) for i, (n, m) in enumerate(spec)]


@pytest.mark.parametrize("spec,max_batch,cache_len,seed", [
    # test_serving.py's requests: ragged prompts and generation lengths
    ([(5, 6), (9, 4), (3, 8)], 2, 64, 0),
    # its slot-recycling case: five requests queued through two slots
    ([(4, 3)] * 5, 2, 32, 1),
], ids=["ragged", "recycling"])
def test_engine_tokens_equal_reference_engine(smoke, spec, max_batch,
                                              cache_len, seed):
    cfg, rcfg, ref_params, params = smoke
    want = _requests(RefRequest, cfg.vocab, spec, seed)
    RefEngine(rcfg, ref_params, max_batch=max_batch,
              cache_len=cache_len).run(want)
    got = _requests(Request, cfg.vocab, spec, seed)
    ServingEngine(cfg, params, max_batch=max_batch, cache_len=cache_len,
                  device=CPU).run(got)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(len(r.out) == m for r, (_, m) in zip(got, spec))


def test_engine_matches_independent_greedy_decode(smoke):
    # the continuous-batching contract of test_serving.py, on the port
    cfg, _, _, params = smoke
    reqs = _requests(Request, cfg.vocab, [(5, 6), (9, 4), (3, 8)], 0)
    ServingEngine(cfg, params, max_batch=2, cache_len=64, device=CPU).run(reqs)
    bundle = serve.make_serve_step(cfg, InputShape("d", 64, 1, "decode"),
                                   device=CPU)
    for r in reqs:
        caches = M.init_caches(cfg, 1, bundle.cache_len, device=CPU)
        out, pos, logits = [], 0, None
        for tok in r.prompt + [None] * r.max_new:
            if tok is None:
                tok = int(np.argmax(logits[0, -1].numpy()))
                out.append(tok)
                if len(out) == r.max_new:
                    break
            logits, caches = bundle.step(params, caches, [[tok]], pos)
            pos += 1
        assert r.out == out, r.uid


def test_prefill_step_matches_reference(smoke):
    # the prefill bundle's step: the last position's logits (B, V), float32
    # within 1e-4 of the reference's step run under jit
    cfg, rcfg, ref_params, params = smoke
    shape = InputShape("prefill_small", 48, 2, "prefill")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 48)).astype(np.int32)
    bundle = serve.make_serve_step(cfg, shape, device=CPU)
    got = bundle.step(params, {"tokens": tokens})
    want, _ = jax.jit(lambda p, t: RM.forward(p, rcfg, {"tokens": t},
                                              last_only=True))(ref_params, tokens)
    assert got.shape == (2, cfg.vocab) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, -1], atol=1e-4,
                               rtol=1e-4)
    assert (bundle.ring, bundle.cache_len) == (False, 48)


def test_cache_len_for_matches_reference():
    for arch in ("qwen3_0p6b", "gemma_2b", "hymba_1p5b"):
        cfg = get_smoke(arch)
        for shape in (PREFILL_32K, InputShape("decode_32k", 32768, 8, "decode"),
                      InputShape("long_500k", 524288, 1, "decode"),
                      InputShape("short", 64, 1, "decode")):
            assert serve.cache_len_for(cfg, shape) == \
                ref_serve.cache_len_for(ref_get_smoke(arch), shape)


def test_decode_step_is_in_place(smoke):
    # the decode step writes the caches in place and returns the same tensors
    cfg, _, _, params = smoke
    caches = M.init_caches(cfg, 2, 8, device=CPU)
    k = caches["group0"]["mix"]["k"]
    with torch.no_grad():
        _, out = M.decode_step(params, cfg, torch.tensor([[1], [2]]), caches,
                               torch.tensor([0, 3]))
    assert out["group0"]["mix"]["k"] is k
    assert k[:, 0, 0].abs().sum() > 0 and k[:, 1, 3].abs().sum() > 0
    assert k[:, 0, 1:].abs().sum() == 0 and k[:, 1, :3].abs().sum() == 0
