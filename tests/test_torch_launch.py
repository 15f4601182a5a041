"""The port's launchers (``launch/train.py``, ``launch/serve.py``) and
mesh descriptions (``launch/mesh.py``) on the CPU.

The launchers run as the README shows them, in subprocesses with
``--device cpu``: alone (a process group of one), and the train launcher
also under ``torchrun`` with two ranks (``--standalone``: a rendezvous on
a free local port).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import testing  # noqa: F401  (one torch thread per worker)
from repro_torch.configs import get, get_smoke
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.shardings import clear_activation_sharding
from repro_torch.training.dist_step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-4000:]}"
    return r.stdout


def _losses(out: str) -> list:
    return [float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if line.startswith("step ")]


def test_train_launcher_alone(tmp_path):
    ckpt = tmp_path / "ckpt.npz"
    out = _run(["-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b",
                "--smoke", "--steps", "3", "--device", "cpu",
                "--ckpt", str(ckpt)])
    losses = _losses(out)
    assert len(losses) == 3 and all(np.isfinite(losses))
    saved = np.load(ckpt)
    assert int(saved["__step__"]) == 3
    assert saved["group0/mix/wq"].shape == (2, 128, 128)   # stacked layers


def test_train_launcher_under_torchrun():
    out = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
                "--arch", "qwen3-0.6b", "--smoke", "--steps", "2",
                "--device", "cpu"])
    losses = _losses(out)
    assert len(losses) == 2 and all(np.isfinite(losses))   # rank 0 prints


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_serve_launcher(arch):
    out = _run(["-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
                "--batch", "2", "--prompt-len", "8", "--gen", "4",
                "--device", "cpu"])
    assert "generated (2, 4)" in out


def test_meshes():
    prod = mesh_mod.make_production_mesh()
    assert prod.axis_names == ("data", "model") and prod.size == 256
    pods = mesh_mod.make_production_mesh(multi_pod=True)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    one = mesh_mod.make_test_mesh()              # no process group: one rank
    assert one.shape == {"data": 1, "model": 1} and one.group is None
    assert mesh_mod.make_test_mesh(multi_pod=True).shape == {
        "pod": 1, "data": 1, "model": 1}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_step_refuses_the_production_mesh(multi_pod):
    with pytest.raises(ValueError, match="model=16"):
        make_train_step(get("qwen3_0p6b"),
                        mesh_mod.make_production_mesh(multi_pod=multi_pod))


def test_train_step_refuses_more_clients_than_ranks():
    mesh = mesh_mod.Mesh(("data", "model"), {"data": 4, "model": 1})
    with pytest.raises(ValueError, match="one client"):
        make_train_step(get_smoke("qwen3_0p6b"), mesh)


def test_train_step_specs_for_one_rank():
    """The bundle's specs follow the reference's rules on the mesh."""
    bundle = make_train_step(get_smoke("qwen3_0p6b"),
                             mesh_mod.make_test_mesh())
    assert bundle.mode == "replica" and bundle.n_clients == 1
    assert bundle.batch_spec == {"tokens": ("data", None),
                                 "targets": ("data", None)}
    assert bundle.params_spec["group0"]["mix"]["wq"] == (None, None, None)
    assert bundle.residual_spec["embed"] == ("data", None, None)
    try:
        plain = make_train_step(get_smoke("qwen3_0p6b").with_(fsdp=True),
                                mesh_mod.make_test_mesh())
    finally:
        clear_activation_sharding()      # plain mode sets the FSDP context
    assert plain.mode == "plain" and plain.residual_spec == ()
