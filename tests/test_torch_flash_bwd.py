"""B6's gradient: the port's ``flash_attention`` under autograd against
autograd through its plain version and against the reference.

Inputs come from numpy seeds.  Port side: ``flash_attention_bwd_plain``
(the algorithm the card's backward kernels run: probabilities recomputed
from the forward's row statistic, tile by tile), the autograd.Function
``flash_attention`` becomes under autograd (on the CPU it runs the plain
versions), and ``loss_fn`` with its gradients at 1 x 2,304 tokens, above
``DENSE_MAX_SEQ`` (the blockwise branch).  Reference side, one subprocess
run beside the port: ``jax.vjp`` of ``_blockwise_attention`` at positions
``arange(S)`` / ``arange(T)``, and ``jax.value_and_grad`` of the
reference's ``loss_fn`` for Qwen3-0.6B, hymba-1.5b (a window) and
DeepSeek-V2 (MLA) at their smoke widths.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import testing  # noqa: F401  (one torch thread per worker)
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import loss_fn
from repro_torch.models.model import jax_leaf, params_from_jax
from test_torch_train import GRAD_TOL, LOSS_RTOL, _lm_batch, _np_params, _put

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (name, B, S, T, H, Hk, D, Dv, causal, window, the reference's q / kv
#: blocks); S a multiple of the q block, as the reference asserts
CASES = [
    ("gqa2-causal", 1, 640, 640, 4, 2, 32, 32, True, 0, 128, 128),
    ("gqa5-window", 1, 512, 512, 10, 2, 32, 32, True, 100, 128, 128),
    ("cross-ragged", 2, 256, 300, 4, 2, 32, 32, False, 0, 128, 128),
    ("dv-ne-d", 1, 384, 384, 4, 2, 48, 32, True, 0, 128, 128),
    ("no-key-rows", 1, 512, 200, 4, 2, 32, 32, False, 64, 128, 128),
]
DTYPES = ("float32", "bfloat16")
PLAIN_TOL = 1e-5                   # of each gradient's largest |g|
REF_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_SEQ, LOSS_Q_BLOCK = 2304, 1152
LOSS_ARCHS = ("qwen3_0p6b", "hymba_1p5b", "deepseek_v2_236b")

_REFERENCE = r"""
import json, math, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke
from repro.models.attention import _blockwise_attention
from repro.models.model import loss_fn

tmp = sys.argv[1]
spec = json.load(open(f"{tmp}/job.json"))
data = np.load(f"{tmp}/inputs.npz")
out = {}
for name, b, s, t, h, hk, d, dv, causal, window, qb, kb in spec["cases"]:
    for dt in ("float32", "bfloat16"):
        q, k, v, g = (jnp.asarray(data[f"att/{name}/{x}"]).astype(dt)
                      for x in "qkvg")
        fn = lambda q, k, v: _blockwise_attention(
            q, k, v, jnp.arange(s), jnp.arange(t), causal, window,
            1.0 / math.sqrt(d), qb, kb)
        o, vjp = jax.vjp(jax.jit(fn), q, k, v)
        for x, grad in zip("qkv", vjp(g)):
            out[f"att/{name}/{dt}/d{x}"] = np.asarray(grad.astype(jnp.float32))


def tree(prefix):
    res = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            node, parts = res, key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(data[key])
    return res


for arch in spec["loss"]:
    cfg = get_smoke(arch).with_(attn_q_block=spec["q_block"])
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, cfg, b)))(
        tree(f"fam/{arch}/params"), tree(f"fam/{arch}/batch"))
    out[f"fam/{arch}/loss"] = loss
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"fam/{arch}/grad/" + "/".join(k.key for k in path)] = g
np.savez(f"{tmp}/reference.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


def _dead(case) -> np.ndarray:
    """Rows that see no key (window > 0 and row >= T - 1 + window)."""
    _, _, s, t, *_, window, _, _ = case
    rows = np.arange(s)
    return (rows >= t - 1 + window) if window > 0 else np.zeros(s, bool)


def _attention_inputs(case) -> dict:
    name, b, s, t, h, hk, d, dv, *_ = case
    rng = np.random.default_rng(s * 7 + t + d)
    x = {"q": rng.standard_normal((b, s, h, d)),
         "k": rng.standard_normal((b, t, hk, d)),
         "v": rng.standard_normal((b, t, hk, dv)),
         "g": rng.standard_normal((b, s, h, dv))}
    return {k: a.astype(np.float32) for k, a in x.items()}


def _as(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flash_bwd")
    data, inputs, fams = {}, {}, {}
    for case in CASES:
        x = _attention_inputs(case)
        # the reference's own cotangent leaves out the rows that see no key,
        # whose masked scores it differentiates through its additive mask
        x_ref = dict(x, g=np.where(_dead(case)[None, :, None, None], 0.0,
                                   x["g"]).astype(np.float32))
        inputs[case[0]] = x, x_ref
        for k, a in x_ref.items():
            data[f"att/{case[0]}/{k}"] = a
    for arch in LOSS_ARCHS:
        cfg = get_smoke(arch).with_(attn_q_block=LOSS_Q_BLOCK)
        fams[arch] = (_np_params(cfg, 3), _lm_batch(cfg, 1, LOSS_SEQ, 4))
        _put(data, f"fam/{arch}/params", fams[arch][0])
        _put(data, f"fam/{arch}/batch", fams[arch][1])
    np.savez(tmp / "inputs.npz", **data)
    (tmp / "job.json").write_text(json.dumps(
        {"cases": CASES, "loss": list(LOSS_ARCHS), "q_block": LOSS_Q_BLOCK}))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(tmp)],
                           env=env, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True)
    try:
        port = {}
        for case in CASES:
            port[case[0]] = {dt: _port_case(case, *inputs[case[0]], dt)
                             for dt in DTYPES}
        losses = {}
        for arch, (p, b) in fams.items():
            cfg = get_smoke(arch).with_(attn_q_block=LOSS_Q_BLOCK)
            model = params_from_jax(p, cfg, device="cpu")
            loss = loss_fn(model, cfg, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
            grads = torch.autograd.grad(loss, list(model.parameters()))
            losses[arch] = (float(loss.detach()), dict(zip(
                (n for n, _ in model.named_parameters()), grads)))
        err = ref.communicate(timeout=600)[1]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    return {"port": port, "losses": losses,
            "reference": dict(np.load(tmp / "reference.npz"))}


def _port_case(case, x, x_ref, dtype: str) -> dict:
    """The port's gradients of one case: the plain backward from the plain
    forward's out and lse, autograd through the plain forward, the
    Function, the Function on the reference's cotangent, and (for bf16)
    the plain backward and autograd on the float32 widening of the same
    bf16 values."""
    _, _, s, t, h, hk, d, dv, causal, window, _, _ = case
    kw = dict(causal=causal, window=window)
    q, k, v, g = (_as(x[n], dtype) for n in "qkvg")
    out = {}
    for tag, cast in (("", lambda a: a), ("f32", lambda a: a.float())):
        qq, kk, vv, gg = (cast(a) for a in (q, k, v, g))
        o, lse = fa.flash_attention_plain(qq, kk, vv, return_lse=True, **kw)
        out[tag + "bwd_plain"] = fa.flash_attention_bwd_plain(
            qq, kk, vv, o, lse, gg, **kw)
        xs = [a.clone().requires_grad_(True) for a in (qq, kk, vv)]
        out[tag + "autograd"] = torch.autograd.grad(
            fa.flash_attention_plain(*xs, **kw), xs, gg)
    xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
    out["function"] = torch.autograd.grad(fa.flash_attention(*xs, **kw), xs, g)
    xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
    out["function_ref"] = torch.autograd.grad(
        fa.flash_attention(*xs, **kw), xs, _as(x_ref["g"], dtype))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_plain_backward_is_autograd_of_plain_forward(results, case, dtype):
    """In float32 (bf16 inputs widened): the recompute-from-lse backward
    equals autograd through the plain forward within 1e-5 of each
    gradient's largest |g|, rows that see no key included."""
    got = results["port"][case][dtype]
    for a, w in zip(got["f32bwd_plain"], got["f32autograd"]):
        assert _rel(a, w) <= PLAIN_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_function_on_cpu_is_the_plain_backward(results, case, dtype):
    """The autograd.Function on the CPU: the same gradients as the plain
    backward (bitwise), in the inputs' dtype, and within one bf16 rounding
    of autograd through the plain forward."""
    got = results["port"][case][dtype]
    for f, p, a in zip(got["function"], got["bwd_plain"], got["autograd"]):
        assert f.dtype == getattr(torch, dtype) and torch.equal(f, p)
        assert _rel(f.float(), a.float()) <= (PLAIN_TOL if dtype == "float32"
                                              else 2 ** -7)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_function_matches_reference_vjp(results, case, dtype):
    """The Function's gradients against ``jax.vjp`` of the reference's
    ``_blockwise_attention`` (1e-4 in float32, 2e-2 in bfloat16, of each
    gradient's largest |g|); the cotangent is zero on rows that see no
    key, so neither side's handling of fully masked rows enters."""
    got = results["port"][case][dtype]["function_ref"]
    ref = results["reference"]
    for x, a in zip("qkv", got):
        want = ref[f"att/{case}/{dtype}/d{x}"]
        assert _rel(a.float().numpy(), want) <= REF_TOL[dtype], x


def test_rows_without_keys_weigh_every_key():
    """A row that sees no key gives dq 0 and dv = dout / T on every key,
    from both the plain backward and the Function."""
    case = CASES[-1]
    _, _, s, t, h, hk, d, dv, causal, window, _, _ = case
    x = _attention_inputs(case)
    dead = _dead(case)
    g = np.where(dead[None, :, None, None], x["g"], 0.0).astype(np.float32)
    q, k, v, gt = (torch.from_numpy(a) for a in (x["q"], x["k"], x["v"], g))
    xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
    dq, dk, dvv = torch.autograd.grad(
        fa.flash_attention(*xs, causal=causal, window=window), xs, gt)
    assert dead.any() and not dq.any() and not dk.any()
    want = gt.reshape(1, s, hk, h // hk, dv).sum((1, 3)) / t   # (1, hk, dv)
    torch.testing.assert_close(dvv, want[:, None].expand_as(dvv), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_above_dense_max_seq_match_reference(results, arch):
    """``loss_fn`` and every gradient leaf at 1 x 2,304 tokens (the
    blockwise branch, q blocks of 1,152) against ``jax.value_and_grad`` of
    the reference's, under ``LOSS_RTOL`` / ``GRAD_TOL``."""
    loss, grads = results["losses"][arch]
    ref = results["reference"]
    want = float(ref[f"fam/{arch}/loss"])
    assert np.isfinite(loss)
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
    tree = {}
    for k, v in ref.items():
        if k.startswith(f"fam/{arch}/grad/"):
            node, parts = tree, k.split("/")[3:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    for name, g in grads.items():
        want_g = jax_leaf(tree, name)
        err = np.abs(g.numpy() - want_g).max()
        assert err <= GRAD_TOL * np.abs(want_g).max(), (name, err)
