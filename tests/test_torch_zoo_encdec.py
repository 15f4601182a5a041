"""The port's encoder-decoder (whisper-tiny) and its frontend stub against
the JAX reference on the CPU, at the config's ``smoke()`` size.

Tolerances as in tests/test_torch_zoo_moe.py.  The reference never fills
the decoder's ``cross_k``/``cross_v`` caches (``init_caches`` zeroes them
and ``decode_step`` takes no frames), so its decode attends to zeros;
the port replays that, and these tests hold it to the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.testing  # noqa: F401  (one torch thread per xdist worker)
from repro.configs import get_smoke as ref_get_smoke
from repro.models import attention as RA
from repro.models import frontends as RF
from repro.models import model as RM
from repro.models.layers import sinusoidal_positions as ref_sinusoidal
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import InputShape, get_smoke
from repro_torch.core import prng
from repro_torch.core.pytree import tree_leaves
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as A
from repro_torch.models import frontends as F
from repro_torch.models import model as M
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import serve

CPU = "cpu"
ARCH = "whisper_tiny"


@pytest.fixture(scope="module")
def zoo():
    """(cfg, reference cfg, reference params, the port's own init)."""
    cfg, rcfg = get_smoke(ARCH), ref_get_smoke(ARCH)
    ref_params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.init_params(cfg, prng.PRNGKey(0, device=CPU), device=CPU)
    return cfg, rcfg, ref_params, params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _frames(b, t, d, seed):
    return np.array(RF.synth_audio_frames(jax.random.PRNGKey(seed), b, t, d))


def test_init_params_matches_reference(zoo):
    cfg, _, ref_params, params = zoo
    ref = _np(ref_params)
    assert M.param_count(params) == sum(x.size for x in jax.tree_util.tree_leaves(ref))
    for name, p in params.named_parameters():
        np.testing.assert_array_max_ulp(p.detach().numpy(), M.jax_leaf(ref, name),
                                        1)
    names = {n for n, _ in params.named_parameters()}
    assert {"enc_group0.1.mix.wq", "enc_norm", "group0.0.cross.wk",
            "group0.1.ln_cross"} <= names


def test_params_from_jax_round_trip(zoo):
    cfg, _, ref_params, _ = zoo
    ref = _np(ref_params)
    ported = M.params_from_jax(ref, cfg, device=CPU)
    for name, p in ported.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), M.jax_leaf(ref, name))


def _forward_pair(zoo, s, t, **overrides):
    cfg, rcfg, ref_params, _ = zoo
    cfg, rcfg = cfg.with_(**overrides), rcfg.with_(**overrides)
    ported = M.params_from_jax(_np(ref_params), cfg, device=CPU)
    tokens = _tokens(cfg, 2, s, seed=s)
    frames = _frames(2, t, cfg.d_model, seed=t)
    want, _ = RM.forward(ref_params, rcfg, {"tokens": jnp.asarray(tokens),
                                            "frames": jnp.asarray(frames)})
    with torch.no_grad():
        got, aux = M.forward(ported, cfg, {"tokens": torch.from_numpy(tokens),
                                           "frames": torch.from_numpy(frames)})
    assert float(aux) == 0.0
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("branch", ["dense", "blockwise"])
def test_forward_matches_reference(zoo, monkeypatch, branch):
    # dense: 32 decoder tokens over the config's 64 frames.  blockwise:
    # DENSE_MAX_SEQ 32, 64 decoder tokens over 48 frames with 16-query and
    # 32-key blocks, so the encoder's non-causal self-attention and the
    # decoder's cross-attention pad the keys to 64 (kpos = -1) and the
    # decoder's self-attention takes the blockwise causal branch
    if branch == "dense":
        got, want = _forward_pair(zoo, 32, zoo[0].source_len)
    else:
        for mod in (RA, A):
            monkeypatch.setattr(mod, "DENSE_MAX_SEQ", 32)
        got, want = _forward_pair(zoo, 64, 48, attn_q_block=16, attn_kv_block=32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_forward_bf16_matches_reference(zoo):
    got, want = _forward_pair(zoo, 32, zoo[0].source_len,
                              compute_dtype="bfloat16")
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_decode_stepping_matches_reference(zoo):
    # 16 steps against the reference's jitted decode step, the cross K/V
    # caches left at zero by both: logits within 1e-4, caches within 1e-5
    cfg, rcfg, ref_params, params = zoo
    s = 16
    tokens = _tokens(cfg, 2, s, seed=1)
    ref_step = jax.jit(lambda p, tok, c, pos: RM.decode_step(p, rcfg, tok, c, pos))
    rc = RM.init_caches(rcfg, 2, s)
    pc = M.init_caches(cfg, 2, s, device=CPU)
    assert pc["group0"]["cross_k"].shape == (cfg.n_layers, 2, cfg.source_len,
                                             cfg.n_kv_heads, cfg.head_dim)
    for t in range(s):
        want, rc = ref_step(ref_params, jnp.asarray(tokens[:, t:t + 1]), rc,
                            jnp.int32(t))
        with torch.no_grad():
            got, pc = M.decode_step(params, cfg, torch.from_numpy(tokens[:, t:t + 1]),
                                    pc, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
    for a, b in zip(tree_leaves(pc), jax.tree_util.tree_leaves(rc), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert not pc["group0"]["cross_k"].any() and not pc["group0"]["cross_v"].any()


def test_prefill_step_with_frames_matches_reference(zoo):
    # the prefill bundle takes frames beside the tokens (host numpy in,
    # moved to the bundle's device): the last position's logits within 1e-4
    # of the reference's forward under jit
    cfg, rcfg, ref_params, params = zoo
    tokens = _tokens(cfg, 2, 24, seed=2)
    frames = _frames(2, cfg.source_len, cfg.d_model, seed=3)
    bundle = serve.make_serve_step(cfg, InputShape("prefill_small", 24, 2,
                                                   "prefill"), device=CPU)
    got = bundle.step(params, {"tokens": tokens, "frames": frames})
    want, _ = jax.jit(lambda p, t, f: RM.forward(p, rcfg, {"tokens": t, "frames": f},
                                                 last_only=True))(ref_params, tokens,
                                                                  frames)
    assert got.shape == (2, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, -1], atol=1e-4,
                               rtol=1e-4)


def test_engine_tokens_equal_reference_engine(zoo):
    # the continuous-batching engine against the reference's: greedy tokens
    # exactly
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
# the frontend stub, the positions, and cross-attention's kernel path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(1500, 384), (64, 128), (7, 32)])
def test_sinusoidal_positions_match_reference(seq, d):
    # the inverse frequencies bitwise (XLA's pow replayed), so the angles
    # are the reference's; sin/cos within 1 ulp-ish of |x| <= 1
    got = sinusoidal_positions(seq, d).numpy()
    want = np.asarray(ref_sinusoidal(seq, d))
    assert got.shape == want.shape == (seq, d)
    np.testing.assert_allclose(got, want, atol=2e-7, rtol=0)


def test_synth_audio_frames_bitwise_and_spec():
    key = jax.random.PRNGKey(7)
    want = np.asarray(RF.synth_audio_frames(key, 2, 100, 48))
    got = F.synth_audio_frames(torch.from_numpy(np.asarray(key).astype(np.int64)),
                               2, 100, 48)
    assert np.array_equal(got.numpy(), want)
    spec = F.audio_frames_spec(2, 1500, 384)
    ref = RF.audio_frames_spec(2, 1500, 384)
    assert spec.device.type == "meta"
    assert tuple(spec.shape) == ref.shape and spec.dtype == torch.float32


def test_cross_attention_kernel_path_matches_padded_blockwise():
    # Non-causal, unwindowed attention masks nothing but key validity, so
    # B6 (here its plain version, which the card's dispatch runs it
    # against) at a ragged T equals the reference's blockwise path, which
    # pads the keys with kpos = -1: whisper's cross-attention at 1500
    # frames, cut to 100 keys over 48-key blocks
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 128, 4, 32)).astype(np.float32)
    k = rng.standard_normal((1, 100, 4, 32)).astype(np.float32)
    v = rng.standard_normal((1, 100, 4, 32)).astype(np.float32)
    want = RA._blockwise_attention(q, k, v, jnp.arange(128), jnp.arange(100),
                                   False, 0, 1.0 / 32 ** 0.5, 64, 48)
    got = A._flash_or_raise(*(torch.from_numpy(a) for a in (q, k, v)), False, 0,
                            False, cross=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(
        got.numpy(), FA.flash_attention_plain(*(torch.from_numpy(a)
                                                for a in (q, k, v)),
                                              causal=False).numpy(), atol=0)
    # a cross call with a window (or causal) reads positions: it raises,
    # and so does a causal self-attention call not declared arange
    t = torch.from_numpy(q)
    with pytest.raises(NotImplementedError, match="window"):
        A._flash_or_raise(t, t, t, False, 16, False, cross=True)
    with pytest.raises(NotImplementedError, match="window"):
        A._flash_or_raise(t, t, t, True, 0, True, cross=True)
    with pytest.raises(NotImplementedError, match="A11"):
        A._flash_or_raise(t, t, t, True, 0, False, cross=False)
