"""The port stands alone: it imports no JAX and nothing of the reference
package, and its entry points refuse to run on the host unasked."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import models
from repro_torch.configs import PREFILL_32K, get_smoke
from repro_torch.core import prng
from repro_torch.serving import ServingEngine
from repro_torch.data import classification, partition_iid
from repro_torch.training import fl_loop, serve

SRC = Path(repro_torch.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(SRC)],
                                                         prefix="repro_torch."))


def test_import_loads_no_jax():
    # a fresh interpreter: this one has JAX loaded by tests/conftest.py
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(_modules())


def test_serving_path_imports_load_no_jax():
    # the serving slice's entry modules alone, in a fresh interpreter
    code = ("import sys\n"
            "import repro_torch.models, repro_torch.serving\n"
            "import repro_torch.training.serve, repro_torch.configs\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_IMPORT = re.compile(r"^\s*(?:from|import)\s+([\w.]+)")


@pytest.mark.parametrize("path", sorted(SRC.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(SRC)))
def test_source_imports_neither_jax_nor_reference(path):
    for line in path.read_text().splitlines():
        m = _IMPORT.match(line)
        if not m:
            continue
        top = m.group(1).split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, line)


#: port modules whose reference counterpart has another name: the
#: profiler of eager torch entry points stands where the jit profiler
#: stood, and the op-level cost of an eager call where the HLO cost stood
RENAMED = {Path("obs/torchprof.py"): Path("obs/jaxprof.py"),
           Path("launch/op_cost.py"): Path("launch/hlo_cost.py")}


def test_module_layout_mirrors_reference():
    ref = SRC.parent / "repro"
    for path in SRC.rglob("*.py"):
        rel = path.relative_to(SRC)
        if rel.name in ("testing.py", "xla_math.py", "prng.py", "build.py",
                        "collectives.py", "pytree.py") \
                or rel == Path("__init__.py"):
            continue   # the port's own helpers and package root
        assert (ref / RENAMED.get(rel, rel)).exists(), \
            f"{rel} has no reference counterpart"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device("cuda")
    data = classification(n=200, dim=8, seed=0)
    train, test = data.test_split(0.2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fl_loop.run_federated(partition_iid(train, 2), test,
                              fl_loop.FLConfig(n_clients=2, rounds=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        fl_loop.params_from_jax([{"w": np.zeros((2, 2)), "b": np.zeros(2)}])
    with pytest.raises(RuntimeError, match="CUDA"):
        prng.PRNGKey(0)
    cfg = get_smoke("qwen3_0p6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init_params(cfg, prng.PRNGKey(0, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.make_serve_step(cfg, PREFILL_32K)
    params = models.init_params(cfg, prng.PRNGKey(0, device="cpu"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
