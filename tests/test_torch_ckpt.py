"""The port's checkpointing: the flat-key npz format, the FL loop's run
state against the reference's, and bit-exact kill-and-resume.

A run killed after round k and resumed from its checkpoint must give the
uninterrupted run's history bit for bit (fediac, and libra, whose heat
state rides the checkpoint), and writing checkpoints must not perturb the
run.  The run state the port writes holds the same keys, shapes and
dtypes as the reference's for the same run.
"""

import os

import numpy as np
import pytest
import torch

from repro.core.fediac import FediACConfig as JConfig
from repro.data import classification, partition_dirichlet
from repro.training import fl_loop as jfl
from repro_torch.checkpoint import (load_checkpoint, load_run_state,
                                    save_checkpoint, save_run_state)
from repro_torch.core.fediac import FediACConfig
from repro_torch.training import fl_loop

HIDDEN = (32, 16)
TOTAL = 4


@pytest.fixture(scope="module")
def task():
    data = classification(n=1200, dim=16, n_classes=10, seed=0)
    train, test = data.test_split(0.2)
    return partition_dirichlet(train, 4, beta=0.5, seed=0), test


def _kw(name, ref=False):
    kw = dict(n_clients=4, local_steps=2, batch=16, aggregator=name, seed=0)
    if name == "fediac":
        kw["agg_kwargs"] = {"cfg": (JConfig if ref else FediACConfig)(
            a=2, bits=12)}
    return kw


def _run(task, name, rounds, **extra):
    clients, test = task
    cfg = fl_loop.FLConfig(rounds=rounds, **_kw(name), **extra)
    return fl_loop.run_federated(clients, test, cfg, hidden=HIDDEN,
                                 device="cpu")


@pytest.fixture(scope="module")
def full_runs(task):
    return {name: _run(task, name, TOTAL) for name in ("fediac", "libra")}


def test_checkpoint_round_trip_nested(tmp_path):
    tree = {"layers": [{"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                        "b": torch.zeros(3)},
                       {"w": torch.ones(3, 1, dtype=torch.float64),
                        "b": torch.tensor([7], dtype=torch.int32)}],
            "opt": ({"t": torch.tensor(3, dtype=torch.int32)}, np.arange(4)),
            "skip": None}
    path = str(tmp_path / "sub" / "ck.npz")
    save_checkpoint(path, tree, step=12)
    assert not os.path.exists(path + ".tmp")
    flat, step = load_checkpoint(path)
    assert step == 12
    assert sorted(flat) == ["layers/0/b", "layers/0/w", "layers/1/b",
                            "layers/1/w", "opt/0/t", "opt/1"]
    back, step = load_checkpoint(path, like=tree)
    assert step == 12 and back["skip"] is None
    assert isinstance(back["layers"], list) and isinstance(back["opt"], tuple)
    for got, want in ((back["layers"][0]["w"], tree["layers"][0]["w"]),
                      (back["layers"][1]["w"], tree["layers"][1]["w"]),
                      (back["layers"][1]["b"], tree["layers"][1]["b"]),
                      (back["opt"][0]["t"], tree["opt"][0]["t"])):
        assert got.dtype == want.numpy().dtype
        np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(back["opt"][1], np.arange(4))


def test_run_state_round_trip(tmp_path):
    hist = fl_loop.FLHistory([0.5, 0.625], [1.25, 2.5], [0.1, 0.2],
                             [2.0, 1.5])
    path = str(tmp_path / "run.npz")
    key = torch.tensor([0, 4294967295], dtype=torch.int64)
    save_run_state(path, flat=torch.ones(5), e_stack=torch.zeros(2, 5),
                   key=key, agg_state={"heat": torch.full((5,), 0.5)},
                   round_idx=2, t_cum=2.5, mb_cum=0.2, history=hist)
    st = load_run_state(path)
    assert st["round"] == 2 and st["t_cum"] == 2.5 and st["mb_cum"] == 0.2
    assert st["key"].dtype == np.uint32
    np.testing.assert_array_equal(st["key"].astype(np.int64), key.numpy())
    assert st["agg_state"]["heat"].dtype == np.float32
    assert fl_loop.FLHistory(**st["history"]) == hist


@pytest.mark.parametrize("name", ["fediac", "libra"])
def test_run_state_matches_reference_layout(task, tmp_path, name):
    clients, test = task
    jpath, tpath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jfl.run_federated(clients, test, jfl.FLConfig(
        rounds=2, ckpt_path=jpath, **_kw(name, ref=True)), hidden=HIDDEN)
    _run(task, name, 2, ckpt_path=tpath)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert (zt[k].shape, zt[k].dtype) == (zj[k].shape, zj[k].dtype), k
        # the threefry key stream and the host-analytic pricing are exact
        for k in ("key", "t_cum", "mb_cum", "__step__", "hist/traffic_mb",
                  "hist/wall_clock"):
            np.testing.assert_array_equal(zt[k], zj[k])
    assert ("agg_state" in zt.files) == (name == "libra")


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", ["fediac", "libra"])
def test_kill_and_resume_bit_identical(task, full_runs, tmp_path, name, k):
    path = str(tmp_path / f"kill{k}.npz")
    killed = _run(task, name, k, ckpt_path=path)
    assert len(killed) == k and load_run_state(path)["round"] == k
    resumed = _run(task, name, TOTAL, ckpt_path=path, resume=True)
    assert resumed == full_runs[name]
    assert resumed.acc == full_runs[name].acc
    assert resumed.loss == full_runs[name].loss
    assert resumed.wall_clock == full_runs[name].wall_clock
    assert resumed.traffic_mb == full_runs[name].traffic_mb


@pytest.mark.parametrize("every", [1, 3])
def test_checkpointing_never_perturbs_the_run(task, full_runs, tmp_path,
                                              every):
    path = str(tmp_path / "observer.npz")
    h = _run(task, "fediac", TOTAL, ckpt_path=path, ckpt_every=every)
    assert h == full_runs["fediac"]
    st = load_run_state(path)
    assert st["round"] == TOTAL          # the last round is always saved
    assert st["history"]["acc"] == full_runs["fediac"].acc


def test_ckpt_path_runs_and_resume_without_file(task, tmp_path):
    """A checkpoint path is no longer refused; ``resume`` with no file yet
    starts from round 1."""
    path = str(tmp_path / "x.ckpt")
    h = _run(task, "fediac", 1, ckpt_path=path)
    assert len(h) == 1 and os.path.exists(path)
    fresh = str(tmp_path / "none.npz")
    h2 = _run(task, "fediac", 1, ckpt_path=fresh, resume=True)
    assert h2 == h


def test_ckpt_every_validated():
    with pytest.raises(ValueError, match="ckpt_every"):
        fl_loop.FLConfig(ckpt_every=0)
