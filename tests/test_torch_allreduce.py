"""The port's ``fediac_allreduce`` and ``dense_allreduce`` against the
reference's, bitwise, on every client.

Port side: 4 gloo ranks on the CPU, spawned by ``repro_torch.testing``
(they import only the port), meeting through a FileStore in ``tmp_path``.
Reference side: subprocesses with 4 host devices each, running the
reference under ``shard_map(..., check_vma=False)`` — the reference's own
``test_fediac_allreduce_on_mesh`` fails on this jax when the check is on
(``jax.make_mesh`` builds Explicit axes), while the math runs as written
with it off.  Both sides run every case once, concurrently (the
reference in two subprocesses, each compiling half the cases), in a
module fixture; each case is then compared on its own.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.core import fediac

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
SHARDS = 2                                 # reference subprocesses
KEY = np.array([0, 7], np.uint32)          # jax.random.PRNGKey(7)

_PAIRS = {"tt": dict(vote_mode="topk", compact_mode="topk"),
          "tb": dict(vote_mode="threshold", compact_mode="block")}


def _case(wire, pair, kernels, d=70_001, **extra):
    return ("fediac_allreduce", d,
            dict(vote_wire=wire, kernels=kernels, **_PAIRS[pair], **extra))


CASES = {
    # d = 70,001 is ragged: the packed wire is padded
    "count-tt": _case("count", "tt", False),
    "count-tt-kernels": _case("count", "tt", True),
    "count-tb": _case("count", "tb", False),
    "packed-tt": _case("packed", "tt", False),
    "packed-tt-kernels": _case("packed", "tt", True),
    "packed-tb": _case("packed", "tb", False),
    "packed-tb-kernels": _case("packed", "tb", True),
    # d = 262,144 fills whole 256-row tiles
    "packed-tt-kernels-d262144": _case("packed", "tt", True, d=262_144),
    "packed-tb-kernels-d262144": _case("packed", "tb", True, d=262_144),
    # vote_chunk 64 pads u to 70,016 and runs stoch_quant
    "packed-tt-kernels-chunk64": _case("packed", "tt", True, vote_chunk=64),
    "count-tt-bf16": _case("count", "tt", False, work_dtype="bfloat16"),
    "packed-tb-kernels-bf16": _case("packed", "tb", True,
                                    work_dtype="bfloat16"),
    "dense": ("dense_allreduce", 70_001, {}),
}

_REFERENCE = r"""
import json, sys
from functools import partial
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core import fediac

tmp, shard, shards = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cases = json.load(open(f"{tmp}/cases.json"))
cases = {k: v for i, (k, v) in enumerate(cases.items()) if i % shards == shard}
data = np.load(f"{tmp}/inputs.npz")
mesh = make_mesh((4,), ("data",))
out = {}
for name, (fn_name, d, kw) in cases.items():
    kw = dict(kw)
    cfg = fediac.FediACConfig(use_pallas=kw.pop("kernels", False), **kw)
    fn = getattr(fediac, fn_name)

    @partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data"), P()),
             out_specs=(P("data"), P("data")), check_vma=False)
    def step(u_l, r_l, key):
        m, r = fn(u_l[0], r_l[0], key, cfg, client_axes="data")
        return m[None], r[None]

    mean, res = step(jnp.asarray(data[f"u{d}"]), jnp.asarray(data[f"r{d}"]),
                     jnp.asarray(data["key"]))
    out[f"{name}/mean"] = np.asarray(mean.astype(jnp.float32))
    out[f"{name}/res"] = np.asarray(res.astype(jnp.float32))
np.savez(f"{tmp}/reference{shard}.npz", **out)
"""


def _inputs(d):
    rng = np.random.default_rng(d)
    u = (rng.standard_normal((N, d)) ** 3).astype(np.float32)
    r = (0.1 * rng.standard_normal((N, d))).astype(np.float32)
    return u, r


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("allreduce")
    data = {"key": KEY}
    for d in sorted({c[1] for c in CASES.values()}):
        data[f"u{d}"], data[f"r{d}"] = _inputs(d)
    np.savez(tmp / "inputs.npz", **data)
    (tmp / "cases.json").write_text(json.dumps(CASES))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               PYTHONPATH=os.path.join(REPO, "src"))
    refs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(tmp),
                              str(i), str(SHARDS)],
                             env=env, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True)
            for i in range(SHARDS)]
    try:
        cases = [(fn, kw, data[f"u{d}"], data[f"r{d}"], KEY)
                 for fn, d, kw in CASES.values()]
        port = testing.run_ranks(testing.allreduce_worker, N,
                                 f"file://{tmp / 'store'}", cases,
                                 timeout=400)
        errs = [ref.communicate(timeout=600)[1] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err[-4000:]
    reference = {}
    for i in range(SHARDS):
        reference.update(np.load(tmp / f"reference{i}.npz"))
    return {name: ([p[i] for p in port], reference[f"{name}/mean"],
                   reference[f"{name}/res"])
            for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_allreduce_bitwise_on_every_rank(results, name):
    port, ref_mean, ref_res = results[name]
    for rank, (mean, res) in enumerate(port):
        assert mean.dtype == np.float32 and mean.shape == ref_mean[rank].shape
        np.testing.assert_array_equal(mean.view(np.int32),
                                      ref_mean[rank].view(np.int32),
                                      err_msg=f"{name}: mean of rank {rank}")
        np.testing.assert_array_equal(res.view(np.int32),
                                      ref_res[rank].view(np.int32),
                                      err_msg=f"{name}: residual of rank {rank}")


@pytest.mark.parametrize("name", [n for n in CASES if n != "dense"])
def test_allreduce_conserves_what_left_the_clients(results, name):
    fn, d, kw = CASES[name]
    u, r = _inputs(d)
    port, _, _ = results[name]
    left = (u + r - np.stack([res for _, res in port])).mean(0)
    # bf16 working tensors round u + r and the residual to 8 bits
    atol = 0.1 if kw.get("work_dtype") == "bfloat16" else 1e-5
    np.testing.assert_allclose(port[0][0], left, rtol=0, atol=atol)


def test_allreduce_rejects_robust_closes():
    cfg = fediac.FediACConfig(robust_agg="trim")
    with pytest.raises(ValueError, match="robust_agg"):
        fediac.fediac_allreduce(torch.zeros(8), torch.zeros(8),
                                torch.tensor([0, 0]), cfg)
