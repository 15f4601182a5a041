"""The port's FL loop against the reference's.

Minibatch draws and the initial model are bitwise (same threefry stream).
Local SGD runs the same float32 arithmetic through other matrix-product
kernels, so the update stack agrees to rtol 1e-5; over three rounds the
accuracy and loss stay within a stated band, while traffic and simulated
wall-clock are host-analytic and exact.
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core.engines import EngineSpec as JSpec
from repro.data import classification, partition_dirichlet
from repro.training import fl_loop as jfl
from repro_torch.core.engines import EngineSpec
from repro_torch.kernels import gather_quant
from repro_torch.testing import key_to_torch
from repro_torch.training import fl_loop

DIMS = (24, 32, 16, 10)   # classification(dim=16) has 16 + 8 features


@pytest.fixture(scope="module")
def task():
    data = classification(n=1200, dim=16, n_classes=10, seed=0)
    train, test = data.test_split(0.2)
    return partition_dirichlet(train, 4, beta=0.5, seed=0), test


def test_init_and_flat_order_match_reference():
    key = jax.random.PRNGKey(3)
    jp = jfl.init_mlp(key, DIMS)
    tp = fl_loop.init_mlp(key_to_torch(key), DIMS)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b["w"].numpy(), np.asarray(a["w"]))
        np.testing.assert_array_equal(b["b"].numpy(), np.asarray(a["b"]))
    flat, _ = ravel_pytree(jp)
    np.testing.assert_array_equal(fl_loop.ravel(tp).numpy(), np.asarray(flat))
    carried = fl_loop.params_from_jax([{k: np.asarray(v) for k, v in lyr.items()}
                                       for lyr in jp], device="cpu")
    np.testing.assert_array_equal(fl_loop.ravel(carried).numpy(),
                                  np.asarray(flat))
    back = fl_loop.unravel(fl_loop.ravel(tp), DIMS)
    assert all(torch.equal(x["w"], y["w"]) and torch.equal(x["b"], y["b"])
               for x, y in zip(back, tp))


def test_local_round_from_carried_weights(task):
    clients, _ = task
    batch, steps, lr = 16, 3, 0.1
    rng = np.random.default_rng(0)
    cx, cy = jfl._stack_clients(clients, batch, rng)
    n, size = cy.shape
    params = jfl.init_mlp(jax.random.PRNGKey(1), DIMS)
    flat, unravel = ravel_pytree(params)
    key = jax.random.PRNGKey(5)
    u_j, loss_j = jax.jit(lambda f, k: jfl.make_client_round(
        unravel, batch, steps)(f, k, lr, cx, cy, size))(flat, key)

    def ref_indices(k):
        ks = jax.random.split(k, steps)
        return jax.vmap(lambda kk: jax.random.randint(kk, (batch,), 0, size))(ks)
    idx_j = jax.vmap(ref_indices)(jax.random.split(key, n))
    idx_t = fl_loop.minibatch_indices(key_to_torch(key), n, steps, batch, size)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))

    flat_t = fl_loop.ravel(fl_loop.params_from_jax(
        [{k: np.asarray(v) for k, v in lyr.items()} for lyr in params],
        device="cpu"))
    u_t, loss_t = fl_loop.make_client_round(DIMS, batch, steps)(
        flat_t, key_to_torch(key), lr, torch.from_numpy(np.array(cx)),
        torch.from_numpy(np.array(cy)).long())
    assert u_t.shape == (n, flat_t.numel())
    # float32 matmuls and autograd differ from XLA's in the last bits
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-5)


def test_run_federated_three_rounds_matches_reference(task):
    clients, test = task
    kw = dict(n_clients=4, rounds=3, local_steps=2, batch=16)
    h_j = jfl.run_federated(clients, test, jfl.FLConfig(
        **kw, engine=JSpec(use_pallas=True)), hidden=DIMS[1:-1])
    before = gather_quant.gather_quant.launches
    h_t = fl_loop.run_federated(clients, test, fl_loop.FLConfig(
        **kw, engine=EngineSpec(use_pallas=True)), hidden=DIMS[1:-1],
        device="cpu")
    assert gather_quant.gather_quant.launches == before   # CPU: plain version
    assert len(h_t) == 3
    assert h_t.traffic_mb == h_j.traffic_mb
    assert h_t.wall_clock == h_j.wall_clock
    # band: one test sample is 1/240 of the accuracy; the local-SGD
    # matmuls differ by float32 rounding only
    np.testing.assert_allclose(h_t.acc, h_j.acc, atol=2 / 240)
    np.testing.assert_allclose(h_t.loss, h_j.loss, rtol=1e-4)


def test_unported_options_raise(task):
    clients, test = task
    cfg = fl_loop.FLConfig(n_clients=4, rounds=1, ckpt_path="x.ckpt")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fl_loop.run_federated(clients, test, cfg, device="cpu")
    cfg = fl_loop.FLConfig(n_clients=4, rounds=1, transport="packet")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fl_loop.run_federated(clients, test, cfg, device="cpu")
    cfg = fl_loop.FLConfig(n_clients=4, rounds=1, aggregator="fedavg")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fl_loop.run_federated(clients, test, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fl_loop.run_federated(clients, test, fl_loop.FLConfig(n_clients=4),
                              device="cpu", probe=object())
