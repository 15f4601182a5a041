"""The port's dense decoder and flash-attention kernel (plain version)
against the JAX reference, on the CPU.

Layer ops are not bitwise between the two packages, so every comparison
but the initializer's carries a tolerance: torch's ``rsqrt`` differs from
``jax.lax.rsqrt`` on ~47% of inputs, ``silu`` on ~23%, ``cos`` on ~5% (by
<= 1 ulp), and float32 matmuls and softmax sums run in other orders.
Inputs are made with numpy from a seed; the reference's Pallas
``flash_attention`` runs in interpret mode, as its own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import attention as RA
from repro.models import model as RM
from repro.models.layers import rope_freqs as ref_rope_freqs
from repro_torch.configs import get_smoke
from repro_torch.core import prng
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M

CPU = "cpu"
FLASH_SHAPES = [(1, 1024, 4, 2, 64), (2, 512, 8, 8, 32), (1, 512, 4, 1, 128)]


def _qkv(b, s, h, hk, dh, seed, t=None, dv=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    dv = dh if dv is None else dv
    return (rng.standard_normal((b, s, h, dh)).astype(np.float32),
            rng.standard_normal((b, t, hk, dh)).astype(np.float32),
            rng.standard_normal((b, t, hk, dv)).astype(np.float32))


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


# ---------------------------------------------------------------------------
# B6: the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("window", [0, 256])
def test_flash_plain_matches_reference_oracle(shape, window):
    # The reference's flash kernel is held to its blockwise oracle at 3e-5
    # (tests/test_flash_attention.py); the port's plain version is held to
    # the same oracle at the same tolerance.
    b, s, h, hk, dh = shape
    q, k, v = _qkv(b, s, h, hk, dh, seed=s + h + window)
    pos = jnp.arange(s)
    want = RA._blockwise_attention(q, k, v, pos, pos, True, window,
                                   1.0 / dh ** 0.5)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("shape,window,dtype", [
    (FLASH_SHAPES[0], 0, "float32"),
    (FLASH_SHAPES[2], 256, "float32"),
    (FLASH_SHAPES[0], 0, "bfloat16"),
], ids=str)
def test_flash_plain_matches_reference_kernel(shape, window, dtype):
    # the reference's Pallas kernel itself, in interpret mode: f32 within
    # 3e-5 and bf16 within 2e-2 (its own tests' tolerances); in bf16 both
    # round the output to bf16
    b, s, h, hk, dh = shape
    q, k, v = _qkv(b, s, h, hk, dh, seed=7)
    jt = getattr(jnp, dtype)
    want = ref_flash(jnp.asarray(q, jt), jnp.asarray(k, jt),
                     jnp.asarray(v, jt), causal=True, window=window)
    tt = getattr(torch, dtype)
    got = FA.flash_attention(*(torch.from_numpy(a).to(tt) for a in (q, k, v)),
                             causal=True, window=window)
    assert got.dtype == tt
    tol = 3e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_flash_plain_ragged_and_uneven_heads():
    # S, T not multiples of the plain version's tiles, Dv != D, T != S,
    # causal off: against the reference's dense attention (f32 3e-5)
    b, s, h, hk, dh, dv, t = 1, 700, 4, 2, 48, 32, 600
    q, k, v = _qkv(b, s, h, hk, dh, seed=3, t=t, dv=dv)
    for causal, window in ((False, 0), (True, 0), (True, 100), (False, 100)):
        want = RA._dense_attention(q, k, v, jnp.arange(s), jnp.arange(t),
                                   causal, window, 1.0 / dh ** 0.5)
        got = FA.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                       causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                                   rtol=3e-5)


def test_flash_wrapper_on_cpu_launches_nothing_and_checks_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 4, 2, 16, seed=0))
    before = FA.flash_attention.launches
    FA.flash_attention(q, k, v)
    assert FA.flash_attention.launches == before
    with pytest.raises(TypeError):
        FA.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        FA.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        FA.flash_attention(q[:, :, :3], k, v)          # H % Hk != 0
    with pytest.raises(ValueError):
        FA.flash_attention(q, k[:, :, :, :8], v)       # D mismatch
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, v, window=-1)
    wide = torch.zeros(1, 8, 2, FA.MAX_HEAD_DIM + 4)
    with pytest.raises(ValueError):
        FA.flash_attention(wide, wide, wide)


def test_flash_tma_layout_rule():
    # The bf16 kernel reads q, k, v with TMA: last stride 1, other strides
    # and the base address 16-byte aligned.  On the CPU the wrapper takes
    # the plain version whatever the layout.
    qkv = torch.zeros(2, 40, 4, 3 * 64, dtype=torch.bfloat16)
    assert FA.tma_layout_ok(qkv)
    assert FA.tma_layout_ok(qkv[..., 64:128]) and FA.tma_layout_ok(qkv[:, :, :2])
    assert FA.tma_layout_ok(torch.zeros(1, 8, 2, 36))         # f32: 144 B rows
    odd = torch.zeros(2, 40, 4, 68, dtype=torch.bfloat16)[..., :64]
    assert not FA.tma_layout_ok(odd)                          # 136-byte rows
    assert not FA.tma_layout_ok(qkv[..., 1:65])               # base + 2 bytes
    assert not FA.tma_layout_ok(qkv.transpose(2, 3))          # last stride 4
    assert not FA.tma_layout_ok(qkv[:, :1].expand(2, 40, 4, 192))   # stride 0
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(1, 64, 4, 2, 64, 0))
    view = torch.zeros(1, 64, 4, 68, dtype=torch.bfloat16)[..., :64]
    view.copy_(q)
    got = FA.flash_attention(view, k, v)
    torch.testing.assert_close(got, FA.flash_attention_plain(q, k, v),
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,theta", [(128, 1e6), (32, 1e6), (256, 1e4)])
def test_rope_freqs_bitwise(dim, theta):
    # the reference evaluated eagerly (as its forward runs in these tests)
    assert np.array_equal(L.rope_freqs(dim, theta).numpy(),
                          np.asarray(ref_rope_freqs(dim, theta)))


@pytest.mark.parametrize("window", [0, 64])
def test_blockwise_and_dense_attention_match_reference(window, monkeypatch):
    # small blocks (64/32) exercise the block loops, as test_models.py
    # patches them; tolerance 2e-5 (float32 sums in other orders)
    b, s, h, hk, dh = 2, 256, 4, 2, 16
    q, k, v = _qkv(b, s, h, hk, dh, seed=window)
    pos = np.arange(s)
    for mod in (RA, A):
        monkeypatch.setattr(mod, "Q_BLOCK", 64)
        monkeypatch.setattr(mod, "KV_BLOCK", 32)
    tq, tk, tv, tp = (torch.from_numpy(a) for a in (q, k, v, pos))
    for fn in ("_dense_attention", "_blockwise_attention"):
        want = getattr(RA, fn)(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                               True, window, 0.25)
        got = getattr(A, fn)(tq, tk, tv, tp, tp, True, window, 0.25)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5, err_msg=fn)


def test_blockwise_attention_pads_ragged_kv():
    # cross-attention over a ragged source (T % kv_block != 0): the padded
    # KV slots carry kpos = -1 and are masked; 2e-5 as above
    b, s, h, hk, dh, t = 1, 128, 4, 2, 16, 100
    q, k, v = _qkv(b, s, h, hk, dh, seed=5, t=t)
    qpos, kpos = np.arange(s), np.arange(t)
    want = RA._blockwise_attention(q, k, v, jnp.asarray(qpos), jnp.asarray(kpos),
                                   False, 0, 0.25, 64, 32)
    got = A._blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v, qpos,
                                                                  kpos)),
                                 False, 0, 0.25, 64, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(L.activation("gelu")(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(x)), atol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """Qwen3-0.6B's smoke config, the reference's weights and the port's
    (the port's own init, checked below to be the same weights)."""
    cfg, rcfg = get_smoke("qwen3_0p6b"), ref_get_smoke("qwen3_0p6b")
    ref_params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = M.init_params(cfg, prng.PRNGKey(0, device=CPU), device=CPU)
    return cfg, rcfg, ref_params, params


def test_init_params_matches_reference(smoke):
    # every leaf within 1 ulp: prng.normal's established bound (XLA's
    # erf_inv replayed)
    cfg, _, ref_params, params = smoke
    ref = _np_params(ref_params)
    got = dict(params.named_parameters())
    assert M.param_count(params) == sum(
        x.size for x in jax.tree_util.tree_leaves(ref))
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        names = [p.key for p in path]
        if names[0].startswith("group"):
            for i in range(leaf.shape[0]):
                mine = got[".".join([names[0], str(i), *names[1:]])]
                np.testing.assert_array_max_ulp(mine.detach().numpy(), leaf[i], 1)
        else:
            np.testing.assert_array_max_ulp(got[names[0]].detach().numpy(), leaf, 1)


def test_params_from_jax_round_trip(smoke):
    cfg, _, ref_params, _ = smoke
    ported = M.params_from_jax(_np_params(ref_params), cfg, device=CPU)
    got = dict(ported.named_parameters())
    np.testing.assert_array_equal(got["group0.1.mix.wq"].detach().numpy(),
                                  np.asarray(ref_params["group0"]["mix"]["wq"][1]))
    np.testing.assert_array_equal(got["embed"].detach().numpy(),
                                  np.asarray(ref_params["embed"]))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _forward_pair(smoke, monkeypatch, s, last_only, **overrides):
    cfg, rcfg, ref_params, _ = smoke
    cfg, rcfg = cfg.with_(**overrides), rcfg.with_(**overrides)
    ported = M.params_from_jax(_np_params(ref_params), cfg, device=CPU)
    tokens = _tokens(cfg, 2, s, seed=s)
    want, _ = RM.forward(ref_params, rcfg, {"tokens": jnp.asarray(tokens)},
                         last_only=last_only)
    with torch.no_grad():
        got, _ = M.forward(ported, cfg, {"tokens": torch.from_numpy(tokens)},
                           last_only=last_only)
    return got.float().numpy(), np.asarray(want, np.float32)


def test_forward_dense_matches_reference(smoke, monkeypatch):
    # S = 32 takes the dense branch; float32 logits within 1e-4
    got, want = _forward_pair(smoke, monkeypatch, 32, False)
    assert got.shape == want.shape == (2, 32, smoke[0].vocab)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("overrides,tol", [
    ({}, 1e-4),
    ({"sliding_window": 48}, 1e-4),                  # the banded branch
    ({"compute_dtype": "bfloat16"}, 2e-2),           # bf16 rounding
], ids=["f32", "window48", "bf16"])
def test_forward_last_only_blockwise_matches_reference(smoke, monkeypatch,
                                                       overrides, tol):
    # DENSE_MAX_SEQ patched down in both packages so S = 256 takes the
    # blockwise branch with 64/32 blocks
    for mod in (RA, A):
        monkeypatch.setattr(mod, "DENSE_MAX_SEQ", 128)
    got, want = _forward_pair(smoke, monkeypatch, 256, True,
                              attn_q_block=64, attn_kv_block=32, **overrides)
    assert got.shape == want.shape == (2, 1, smoke[0].vocab)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_stepping_matches_reference(smoke, ring):
    # step-by-step decode, as test_models.py steps it, against the
    # reference's own decode_step: float32 logits within 1e-4.  ring: a
    # sliding window of 8 over a ring cache of 8 slots.
    cfg, rcfg, ref_params, params = smoke
    if ring:
        cfg, rcfg = cfg.with_(sliding_window=8), rcfg.with_(sliding_window=8)
    s, clen = 16, 8 if ring else 16
    tokens = _tokens(cfg, 2, s, seed=1)
    rc = RM.init_caches(rcfg, 2, clen)
    pc = M.init_caches(cfg, 2, clen, device=CPU)
    for t in range(s):
        want, rc = RM.decode_step(ref_params, rcfg, jnp.asarray(tokens[:, t:t + 1]),
                                  rc, jnp.int32(t), ring=ring)
        with torch.no_grad():
            got, pc = M.decode_step(params, cfg, torch.from_numpy(tokens[:, t:t + 1]),
                                    pc, t, ring=ring)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
    np.testing.assert_allclose(pc["group0"]["mix"]["k"].numpy(),
                               np.asarray(rc["group0"]["mix"]["k"]), atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma_2b", "yi_6b", "command_r_plus_104b",
                                  "chameleon_34b"])
def test_other_dense_architectures_match_reference(arch):
    # the other dense decoders of the registry (Gemma: GeGLU, scaled
    # embeddings, head_dim 256 at full size), each from its own init with
    # the same key; float32 logits of the dense branch within 1e-4
    cfg, rcfg = get_smoke(arch), ref_get_smoke(arch)
    params = M.init_params(cfg, prng.PRNGKey(0, device=CPU), device=CPU)
    tokens = _tokens(cfg, 2, 32, seed=4)
    want, _ = RM.forward(RM.init_params(rcfg, jax.random.PRNGKey(0)), rcfg,
                         {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, _ = M.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_declared_arange_path_agrees_with_blockwise(smoke, monkeypatch):
    """The branch the card takes above DENSE_MAX_SEQ for positions declared
    ``arange`` (B6, here its plain version) against the blockwise branch on
    those positions, at the smoke model's layer 0 (B6's float32 gate, 3e-5;
    sums in other orders).  On the CPU the declaration changes nothing,
    and undeclared offset positions run the blockwise branch on them."""
    cfg, _, _, params = smoke
    monkeypatch.setattr(A, "DENSE_MAX_SEQ", 128)
    mix = M.cast_params(params, cfg)["group0"][0]["mix"]
    s = 256
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32))
    pos = torch.arange(s)
    with torch.no_grad():
        blockwise = A.multihead_attention(mix, x, cfg, positions=pos)
        declared = A.multihead_attention(mix, x, cfg, positions=pos,
                                         arange_positions=True)
        assert torch.equal(blockwise, declared)
        shifted = A.multihead_attention(mix, x, cfg, positions=pos + 7)
        assert not torch.allclose(shifted, blockwise)
        # the card's declared branch: flash_attention on the same q, k, v
        monkeypatch.setattr(
            A, "_blockwise_attention",
            lambda q, k, v, qpos, kpos, causal, window, *_: FA.flash_attention(
                q, k, v, causal=causal, window=window))
        kernel = A.multihead_attention(mix, x, cfg, positions=pos,
                                       arange_positions=True)
    np.testing.assert_allclose(kernel.numpy(), blockwise.numpy(), atol=3e-5,
                               rtol=3e-5)
