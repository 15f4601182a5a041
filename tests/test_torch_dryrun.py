"""The port's dry-run (``launch/dryrun.py``) and op-level cost
(``launch/op_cost.py``) against the reference's ``launch/dryrun.py`` and
``launch/hlo_cost.py``.

The reference side runs in one subprocess beside the port's side:
parameter counts from ``jax.eval_shape`` of the reference's
``init_params`` (with the reference's ``active_params`` rule), the
reference's ``input_specs`` (its source read out of ``dryrun.py``, since
importing that module sets ``XLA_FLAGS`` for 512 placeholder devices),
and ``hlo_cost.analyze`` over the reference's prefill, decode and train
steps compiled on one CPU device at smoke widths.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import testing  # noqa: F401  (one torch thread per worker)
from repro_torch.configs import SHAPES_BY_NAME, get, get_smoke
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core import prng
from repro_torch.launch import dryrun, op_cost
from repro_torch.models.model import (decode_step, forward, init_caches,
                                      init_params)
from repro_torch.training import dist_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3_0p6b"
#: smoke-width steps costed on both sides: (kind, rows, seq or cache length)
STEPS = {"prefill": (2, 64), "decode": (2, 64), "train": (2, 32)}

_REFERENCE = r"""
import ast, json, sys
import jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import SHAPES_BY_NAME, get, get_smoke
from repro.configs.base import InputShape
from repro.configs.registry import ARCH_IDS
from repro.launch import hlo_cost
from repro.models.model import init_params
from repro.training.dist_step import make_train_step
from repro.training.serve import make_serve_step

out_path, arch, steps = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
out = {"params": {}, "specs": {}, "flops": {}}
# the reference's active_params (launch/dryrun.py), by eval_shape
for a in ARCH_IDS:
    cfg = get(a)
    shapes = jax.eval_shape(lambda k: init_params(cfg, k), jax.random.PRNGKey(0))
    total = active = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [getattr(k, "key", "") for k in path]
        n = leaf.size
        total += n
        if cfg.n_experts > 0 and any(k in ("we_g", "we_u", "we_d") for k in keys):
            active += n * cfg.moe_top_k // cfg.n_experts
        else:
            active += n
    out["params"][a] = [int(total), int(active)]
# the reference's input_specs, its source taken from dryrun.py
src = open("src/repro/launch/dryrun.py").read()
fn = next(n for n in ast.parse(src).body
          if isinstance(n, ast.FunctionDef) and n.name == "input_specs")
ns = {"jax": jax, "jnp": jnp}
exec(compile(ast.Module([fn], []), "dryrun.py", "exec"), ns)
for a in ARCH_IDS:
    cfg = get(a)
    for name, shape in SHAPES_BY_NAME.items():
        specs = ns["input_specs"](cfg, shape, None)
        out["specs"][f"{a}/{name}"] = {
            k: [list(v.shape), str(v.dtype)] for k, v in specs.items()}
# hlo_cost over the smoke steps compiled on one CPU device
cfg = get_smoke(arch)
mesh = make_mesh((1, 1), ("data", "model"))
pshape = jax.eval_shape(lambda k: init_params(cfg, k), jax.random.PRNGKey(0))
i32 = jnp.int32
with mesh:
    b, s = steps["prefill"]
    bundle = make_serve_step(cfg, mesh, InputShape("p", s, b, "prefill"))
    hlo = jax.jit(bundle.step).lower(
        pshape, {"tokens": jax.ShapeDtypeStruct((b, s), i32)}).compile()
    out["flops"]["prefill"] = hlo_cost.analyze(hlo.as_text())["flops"]
    b, s = steps["decode"]
    bundle = make_serve_step(cfg, mesh, InputShape("d", s, b, "decode"))
    hlo = jax.jit(bundle.step).lower(
        pshape, bundle.cache_shape, jax.ShapeDtypeStruct((b, 1), i32),
        jax.ShapeDtypeStruct((), i32)).compile()
    out["flops"]["decode"] = hlo_cost.analyze(hlo.as_text())["flops"]
    b, s = steps["train"]
    bundle = make_train_step(cfg, mesh)
    res = jax.tree_util.tree_map(
        lambda l: jax.ShapeDtypeStruct((bundle.n_clients, *l.shape),
                                       jnp.dtype(cfg.residual_dtype)), pshape)
    batch = {k: jax.ShapeDtypeStruct((b, s), i32) for k in ("tokens", "targets")}
    key = jax.eval_shape(lambda: jax.random.PRNGKey(0))
    hlo = jax.jit(bundle.step).lower(pshape, res, batch, key).compile()
    out["flops"]["train"] = hlo_cost.analyze(hlo.as_text())["flops"]
json.dump(out, open(out_path, "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "reference.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(path), ARCH,
                        json.dumps(STEPS)], env=env, cwd=REPO, timeout=600,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(path.read_text())


def _port_flops(kind: str) -> float:
    """op_cost's FLOPs of the port's smoke step ``kind`` on meta tensors."""
    cfg = get_smoke(ARCH)
    params = init_params(cfg, prng.PRNGKey(0, device="meta"), device="meta")
    rows, s = STEPS[kind]
    tok = torch.empty((rows, s if kind != "decode" else 1), dtype=torch.int32,
                      device="meta")
    if kind == "prefill":
        with torch.no_grad():
            return op_cost.analyze(forward, params, cfg, {"tokens": tok},
                                   last_only=True)["flops"]
    if kind == "decode":
        caches = init_caches(cfg, rows, s, device="meta")
        with torch.no_grad():
            return op_cost.analyze(decode_step, params, cfg, tok, caches,
                                   s - 1)["flops"]
    layout = dist_step.FlatLayout(params)
    batch = {"tokens": tok, "targets": tok}
    n_micro = max(1, min(cfg.microbatch, rows))
    return op_cost.analyze(dist_step._local_update, cfg, params, batch, 1e-2,
                           layout, n_micro)["flops"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_match_reference(reference, arch):
    """Total and active parameter counts, exact integers, for every full
    config (the experts a token is not routed to discounted)."""
    assert list(dryrun.active_params(get(arch))) == reference["params"][arch]


@pytest.mark.parametrize("shape", list(SHAPES_BY_NAME))
def test_input_specs_match_reference(reference, shape):
    """The inputs' shapes and dtypes, every full config at every shape."""
    for arch in ARCH_IDS:
        got = dryrun.input_specs(get(arch), SHAPES_BY_NAME[shape])
        assert all(t.device.type == "meta" for t in got.values())
        got = {k: [list(t.shape), str(t.dtype).removeprefix("torch.")]
               for k, t in got.items()}
        assert got == reference["specs"][f"{arch}/{shape}"], arch


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_flops_equal_hlo_cost(reference, kind):
    """op_cost's FLOPs of the smoke Qwen3-0.6B prefill and decode step equal
    hlo_cost's over the reference's step compiled on one CPU device."""
    assert _port_flops(kind) == reference["flops"][kind]


def test_train_flops_equal_hlo_cost(reference):
    """The smoke train step (E = 4 local steps, each layer checkpointed):
    the eager step recomputes each layer's forward in the backward, and
    XLA's compiled step keeps the same recomputed products (its ``while``
    bodies counted by their trip counts), so the counts are equal; the
    aggregation has no product on either side."""
    assert _port_flops("train") == reference["flops"]["train"]


def test_op_cost_counts_products_bytes_and_collectives(tmp_path):
    """op_cost's rules on a hand-counted call: products' FLOPs, twice the
    output bytes of a product, a reduction, a copy and a concatenation (an
    elementwise op left out), an in-place scatter's source, and a
    collective's payload on a one-rank gloo group."""
    import torch.distributed as dist
    a = torch.ones(4, 8)
    b = torch.ones(8, 3)
    x = torch.ones(2, 4, 8)

    def fn():
        y = a @ b                                  # mm: 2*4*3*8 FLOPs
        z = torch.bmm(x, x.transpose(1, 2))        # bmm: 2*2*4*4*8
        w = (y * 2).sum(0)                         # mul left out; sum
        c = torch.cat([y, y])                      # cat
        t = torch.zeros(10).index_add_(0, torch.tensor([1, 2]),
                                       torch.ones(2))
        dist.all_reduce(t)
        return z, w, c, t

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        cost = op_cost.analyze(fn)
    finally:
        dist.destroy_process_group()
    assert cost["flops"] == 2 * 4 * 3 * 8 + 2 * 2 * 4 * 4 * 8
    # mm 48 B, bmm 128 B, sum 12 B, cat 96 B, index_add_'s source 8 B
    assert cost["bytes"] == 2 * (48 + 128 + 12 + 96 + 8)
    assert cost["collectives"] == {"all-reduce": 40.0}
    assert cost["collective_bytes"] == 40.0


def test_run_one_records_h100_terms_and_nulls():
    """A record's roofline terms are the H100's (launch/mesh.py), its model
    FLOPs 6 x active x tokens, and what does not map is null with a
    reason; whisper at long_500k is skipped as in the reference."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    rec = dryrun.run_one("qwen3-0.6b", "train_4k", smoke=True)
    _, active = dryrun.active_params(get_smoke(ARCH))
    assert rec["model_flops"] == 6.0 * active * 256 * 4096
    assert rec["roofline_s"]["compute"] == rec["flops_per_device"] / PEAK_FLOPS_BF16
    assert rec["roofline_s"]["memory"] == rec["hbm_bytes_per_device"] / HBM_BW
    assert rec["roofline_s"]["collective"] is None
    for key in ("collectives", "memory_analysis", "hlo_text"):
        assert rec[key] is None
    assert set(rec["not_mapped"]) >= {"collectives", "memory_analysis",
                                      "hlo_text", "ici_term"}
    assert rec["per_device"]["rows_per_device"] == 256 // 16
    assert "aggregation" in rec["per_device"]["costing"]
    assert np.isfinite(rec["useful_flops_ratio"])
    skip = dryrun.run_one("whisper-tiny", "long_500k", smoke=True)
    assert "skipped" in skip


def test_dryrun_cli_smoke_single_combo(tmp_path):
    """The module's CLI, as the reference's is run, on a reduced config."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--smoke", "--out",
         str(tmp_path)], env=env, timeout=300, capture_output=True,
        text=True, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "FAIL" not in r.stdout
    (rec,) = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert rec["arch"] == "mamba2_130m" and rec["model_flops"] > 0
