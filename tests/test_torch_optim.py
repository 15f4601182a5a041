"""The port's optimizers and residual helpers against the reference's.

On the reference test's quadratic (``tests/test_substrate.py``), SGD and
momentum take the same float32 steps on both sides and agree bitwise;
Adam's bias corrections take a float32 ``pow``, whose last bit may differ
between XLA and torch, so its trajectory is held to rtol 1e-6.  Each
optimizer also converges on its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import residual as jresidual
from repro_torch import optim
from repro_torch.core import residual

TARGET = [3.0, -2.0, 0.5]
OPTS = {"sgd": dict(lr=0.1), "momentum": dict(lr=0.05),
        "adam": dict(lr=0.1)}
#: (rtol) per optimizer: bitwise where the steps are mul/add only
RTOL = {"sgd": 0, "momentum": 0, "adam": 1e-6}


def _quadratic_ref(opt, steps):
    target = jnp.array(TARGET)
    params = jnp.zeros(3)
    state = opt.init(params)
    path = []
    for _ in range(steps):
        g = 2 * (params - target)
        upd, state = opt.update(g, state, params)
        params = joptim.apply_updates(params, upd)
        path.append(np.asarray(params))
    return np.stack(path)


def _quadratic(opt, steps):
    target = torch.tensor(TARGET)
    params = {"w": [torch.zeros(3)]}      # a pytree: dict of a list
    state = opt.init(params)
    path = []
    for _ in range(steps):
        g = {"w": [2 * (params["w"][0] - target)]}
        upd, state = opt.update(g, state, params)
        params = optim.apply_updates(params, upd)
        path.append(params["w"][0].numpy().copy())
    return np.stack(path)


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_reference(name):
    got = _quadratic(getattr(optim, name)(**OPTS[name]), 50)
    want = _quadratic_ref(getattr(joptim, name)(**OPTS[name]), 50)
    if RTOL[name] == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[name], atol=1e-7)


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_converges(name):
    path = _quadratic(getattr(optim, name)(**OPTS[name]), 200)
    assert np.abs(path[-1] - np.array(TARGET)).max() < 1e-2


def test_apply_updates_keeps_dtype_and_adam_state():
    params = [torch.ones(4, dtype=torch.bfloat16), (torch.zeros(2),)]
    opt = optim.adam(0.1)
    state = opt.init(params)
    assert state["t"].dtype == torch.int32 and int(state["t"]) == 0
    grads = [torch.ones(4, dtype=torch.bfloat16), (torch.ones(2),)]
    upd, state = opt.update(grads, state, params)
    new = optim.apply_updates(params, upd)
    assert new[0].dtype == torch.bfloat16 and isinstance(new[1], tuple)
    assert int(state["t"]) == 1 and state["m"][0].dtype == torch.float32


def test_residual_helpers_match_reference():
    rng = np.random.default_rng(0)
    u = rng.standard_normal(257).astype(np.float32)
    up = np.where(rng.random(257) < 0.1, u * 0.75, 0).astype(np.float32)
    got = residual.residual_after_upload(torch.from_numpy(u),
                                         torch.from_numpy(up))
    want = jresidual.residual_after_upload(jnp.asarray(u), jnp.asarray(up))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z = residual.init_residual(9, device="cpu")
    assert z.shape == (9,) and z.dtype == torch.float32 and not z.any()
