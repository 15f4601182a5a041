"""The port's partition rules (``models/shardings.py``) against the
reference's, and its residual-stream cotangent cast.

``param_specs`` runs on the reference's ``jax.eval_shape`` of its
parameter tree and on the port's model laid out on the ``meta`` device,
``cache_specs`` on both packages' decode caches made the same ways, so
nothing is drawn or allocated; every spec is compared entry for entry
(the reference's ``PartitionSpec`` as a tuple).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import shardings as ref_shardings
from repro.models.model import init_caches as ref_init_caches
from repro.models.model import init_params as ref_init_params
from repro_torch import testing  # noqa: F401  (one torch thread per worker)
from repro_torch.configs import ARCH_IDS, DECODE_32K, get
from repro_torch.core import prng
from repro_torch.models import batch_spec, cache_specs, param_specs
from repro_torch.models.model import init_caches, init_params
from repro_torch.models.shardings import (_ct_cast, clear_activation_sharding,
                                          constrain_residual,
                                          set_activation_sharding)

MODEL, DATA = 16, 16
CACHE_BATCH = 4            # divides the data axis once the batch is sharded


def _as_tuples(tree):
    """The reference's spec tree with each PartitionSpec as a tuple."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _ref_params(arch):
    return jax.eval_shape(lambda k: ref_init_params(ref_get(arch), k),
                          jax.random.PRNGKey(0))


def _port_meta(cfg):
    return init_params(cfg, prng.PRNGKey(0, device="meta"), device="meta")


@pytest.mark.parametrize("flip", [False, True], ids=["fsdp-as-configured",
                                                     "fsdp-flipped"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, flip):
    cfg = get(arch)
    ref_cfg = ref_get(arch)
    if flip:
        cfg, ref_cfg = (cfg.with_(fsdp=not cfg.fsdp),
                        ref_cfg.with_(fsdp=not ref_cfg.fsdp))
    want = _as_tuples(ref_shardings.param_specs(
        _ref_params(arch), ref_cfg, model_size=MODEL, data_size=DATA))
    got = param_specs(_port_meta(cfg), cfg, model_size=MODEL, data_size=DATA)
    assert got == want


@pytest.mark.parametrize("divisible", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, divisible):
    cfg, ref_cfg = get(arch), ref_get(arch)
    length = DECODE_32K.seq_len
    ref_caches = jax.eval_shape(
        lambda: ref_init_caches(ref_cfg, CACHE_BATCH, length))
    want = _as_tuples(ref_shardings.cache_specs(
        ref_caches, batch_divisible=divisible, data_axes=("data",),
        model_size=MODEL))
    got = cache_specs(init_caches(cfg, CACHE_BATCH, length, device="meta"),
                      batch_divisible=divisible, data_axes=("data",),
                      model_size=MODEL)
    assert got == want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("divisible", [True, False])
@pytest.mark.parametrize("axes", [("data",), ("pod", "data")])
def test_batch_spec_equal_reference(kind, divisible, axes):
    want = _as_tuples(ref_shardings.batch_spec(
        kind, batch_divisible=divisible, data_axes=axes))
    assert batch_spec(kind, batch_divisible=divisible, data_axes=axes) == want


def test_param_specs_draw_nothing():
    """The rules read a meta model's shapes: no parameter is allocated."""
    meta = _port_meta(get("deepseek_v2_236b"))
    assert all(p.device.type == "meta" for p in meta.parameters())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_ct_cast_casts_the_cotangent_and_nothing_else(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 3, 8)).astype(np.float32))
    x.requires_grad_(True)
    y = _ct_cast(dtype)(x)
    assert y.dtype == x.dtype and torch.equal(y, x.detach())
    y.backward(g)
    # the cotangent went through `dtype`; autograd hands x its own dtype
    assert torch.equal(x.grad, g.to(getattr(torch, dtype)).float())
    assert not torch.equal(x.grad, g)


def test_constrain_residual_only_under_a_context():
    x = torch.ones((2, 3, 4), requires_grad=True)
    clear_activation_sharding()
    assert constrain_residual(x) is x
    set_activation_sharding(object(), None, "model")
    try:
        y = constrain_residual(x)
        assert y is not x and torch.equal(y, x)
        row = x[0]                      # not a (B, S, D) residual stream
        assert constrain_residual(row) is row
    finally:
        clear_activation_sharding()
