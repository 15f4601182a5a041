"""Training on the zoo: the port's ``loss_fn``, remat and train step
(``training/dist_step.py``) against the reference's.

Inputs are made from numpy seeds: each family's parameters (the
reference's tree, group leaves stacked over layers) and batches, an
update stack, residuals and a key.  The port takes the parameters through
``params_from_jax``.  Port side: ``loss_fn`` in this process, the train
step on 4 gloo ranks on the CPU (``repro_torch.testing.train_worker``).
Reference side: three subprocesses run concurrently with the port (4 host
devices each): the aggregation of ``make_train_step``'s step (its ``agg``
closure, a ``shard_map`` with ``check_vma=False``) on the same update
stack, residuals and key, split over two of them, the reference's
``_local_update`` and plain step in one of those, and
``jax.value_and_grad(loss_fn)`` for six families in the third.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.configs import get_smoke
from repro_torch.core import prng
from repro_torch.models import loss_fn
from repro_torch.models.model import init_params, params_from_jax, reference_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
ARCH = "qwen3_0p6b"
KEY = np.array([0, 11], np.uint32)            # jax.random.PRNGKey(11)
LR = 0.2
FAMILIES = ("qwen3_0p6b", "granite_moe_1b", "deepseek_v2_236b",
            "mamba2_130m", "hymba_1p5b", "whisper_tiny")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # of the leaf's largest |g|

_TT = dict(vote_mode="topk", compact_mode="topk", vote_wire="count")
_TB = dict(vote_mode="threshold", compact_mode="block", vote_wire="packed")


def _agg_cases() -> dict:
    cases = {}
    for gran in ("model", "tensor"):
        for pair, fed in (("tt-count", _TT), ("tb-packed", _TB)):
            for kernels in (False, True):
                name = f"fediac-{pair}-{gran}" + ("-kernels" if kernels else "")
                cases[name] = dict(kernels=kernels,
                                   fediac=dict(fed, granularity=gran))
        for agg in ("dense", "switchml", "topk"):
            cases[f"{agg}-{gran}"] = dict(aggregator=agg,
                                          fediac=dict(granularity=gran))
    return cases


AGG_CASES = _agg_cases()

_REFERENCE = r"""
import json, sys
from dataclasses import replace
import numpy as np
import jax, jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from repro.compat import make_mesh
from repro.configs import get_smoke
from repro.models.model import loss_fn
from repro.training import dist_step

tmp, job = sys.argv[1], sys.argv[2]
spec = json.load(open(f"{tmp}/job{job}.json"))
data = np.load(f"{tmp}/inputs.npz")


def tree(prefix):
    out = {}
    for k in data.files:
        if k.startswith(prefix + "/"):
            node, parts = out, k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(data[k])
    return out


def cfg_of(arch, kw):
    kw = dict(kw)
    fed, kernels = kw.pop("fediac", {}), kw.pop("kernels", False)
    cfg = get_smoke(arch)
    return cfg.with_(fediac=replace(cfg.fediac, **fed), **kw), kernels


def flat(t):
    return np.asarray(ravel_pytree(t)[0].astype(jnp.float32))


out = {}
mesh = make_mesh((4, 1), ("data", "model"))
key = jnp.asarray(data["key"])
for name, arch, kw in spec.get("agg", []):
    cfg, kernels = cfg_of(arch, kw)
    bundle = dist_step.make_train_step(cfg, mesh, lr=0.2, use_pallas=kernels)
    cells = dict(zip(bundle.step.__code__.co_freevars, bundle.step.__closure__))
    with mesh:
        mean, res = jax.jit(cells["agg"].cell_contents)(tree("u"), tree("r"), key)
    out[f"agg/{name}/mean"] = flat(mean)
    out[f"agg/{name}/res"] = np.stack([
        flat(jax.tree_util.tree_map(lambda x: x[i], res)) for i in range(4)])
if "local" in spec:
    arch, lr = spec["local"]
    cfg, _ = cfg_of(arch, {})
    batch = tree("batch")
    rows = batch["tokens"].shape[0] // 4
    n_micro = max(1, min(cfg.microbatch, rows))
    fn = jax.jit(lambda p, b: dist_step._local_update(cfg, p, b, lr, None,
                                                      n_micro))
    for r in range(4):
        update, loss = fn(tree("params"), {k: v[r * rows:(r + 1) * rows]
                                           for k, v in batch.items()})
        out[f"local/{r}/update"], out[f"local/{r}/loss"] = flat(update), loss
    cfg, _ = cfg_of(arch, {"fsdp": True})
    new, _, m = jax.jit(dist_step._make_plain_step(cfg, lr))(
        tree("params"), jnp.zeros(()), batch, key)
    out["plain/params"], out["plain/loss"] = flat(new), m["loss"]
for arch in spec.get("loss", []):
    cfg, _ = cfg_of(arch, {})
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, cfg, b)))(
        tree(f"fam/{arch}/params"), tree(f"fam/{arch}/batch"))
    out[f"fam/{arch}/loss"] = loss
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"fam/{arch}/grad/" + "/".join(k.key for k in path)] = g
np.savez(f"{tmp}/reference{job}.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _leaves(cfg) -> list:
    """``[(path, stacked shape)]`` of the reference's parameter tree, in
    its flatten order (from the port's model on the meta device)."""
    meta = init_params(cfg, prng.PRNGKey(0, device="meta"), device="meta")
    return [(path, ((len(ps), *ps[0].shape)
                    if path[0].startswith(("group", "enc_group"))
                    else tuple(ps[0].shape)))
            for path, ps in reference_leaves(meta)]


def _np_params(cfg, seed: int) -> dict:
    """A parameter tree from a numpy seed: scalars and vectors (norm
    scales, A_log, D, dt_bias, betas) around 1, matrices normal /
    sqrt(fan-in), the embedding 0.02 x normal."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, shape in _leaves(cfg):
        stacked = path[0].startswith(("group", "enc_group"))
        one = shape[1:] if stacked else shape
        if path[-1] == "embed":
            a = 0.02 * rng.standard_normal(shape)
        elif len(one) <= 1:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(one[-2])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.astype(np.float32)
    return tree


def _flat_tree(flat: np.ndarray, leaves) -> dict:
    """A ``[..., d]`` array in ravel order as the reference's tree, leading
    dims kept."""
    tree, off = {}, 0
    lead = flat.shape[:-1]
    for path, shape in leaves:
        n = int(np.prod(shape))
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[..., off:off + n].reshape(*lead, *shape)
        off += n
    return tree


def _put(data: dict, prefix: str, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _put(data, f"{prefix}/{k}", v)
        else:
            data[f"{prefix}/{k}"] = v


def _lm_batch(cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.is_enc_dec:
        batch["frames"] = (0.5 * rng.standard_normal(
            (b, cfg.source_len, cfg.d_model))).astype(np.float32)
    return batch


def _train_batches(cfg, n: int) -> list:
    from repro_torch.data.synthetic import lm_batches
    return list(lm_batches(np.random.default_rng(0), cfg.vocab, 8, 64, n))


def _inputs():
    cfg = get_smoke(ARCH)
    leaves = _leaves(cfg)
    d = sum(int(np.prod(s)) for _, s in leaves)
    rng = np.random.default_rng(d)
    u = (rng.standard_normal((N, d)) ** 3 * 1e-2).astype(np.float32)
    r = (1e-3 * rng.standard_normal((N, d))).astype(np.float32)
    data = {"key": KEY}
    _put(data, "u", _flat_tree(u, leaves))
    _put(data, "r", _flat_tree(r, leaves))
    params = _np_params(cfg, 1)
    _put(data, "params", params)
    batch = _lm_batch(cfg, 8, 32, 2)
    _put(data, "batch", batch)
    fams = {}
    for arch in FAMILIES:
        fcfg = get_smoke(arch)
        fams[arch] = (_np_params(fcfg, 3), _lm_batch(fcfg, 2, 16, 4))
        _put(data, f"fam/{arch}/params", fams[arch][0])
        _put(data, f"fam/{arch}/batch", fams[arch][1])
    return data, u, r, params, batch, fams


# ---------------------------------------------------------------------------
# the module fixture: every reference case once, concurrently with the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    data, u, r, params, batch, fams = _inputs()
    np.savez(tmp / "inputs.npz", **data)
    names = list(AGG_CASES)
    agg = [(n, ARCH, AGG_CASES[n]) for n in names]
    jobs = [{"agg": agg[0::2], "local": (ARCH, LR)}, {"agg": agg[1::2]},
            {"loss": list(FAMILIES)}]
    for i, job in enumerate(jobs):
        (tmp / f"job{i}.json").write_text(json.dumps(job))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               PYTHONPATH=os.path.join(REPO, "src"))
    refs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(tmp),
                              str(i)], env=env, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True)
            for i in range(len(jobs))]
    try:
        cfg = get_smoke(ARCH)
        job = {"agg": (agg, u, r, KEY),
               "local": (ARCH, params, batch, LR),
               "train": (ARCH, _train_batches(cfg, 8), LR,
                         np.array([0, 1], np.uint32)),
               "plain": (ARCH, params, batch, LR, KEY),
               "pod": ("chameleon_34b",
                       {"tokens": np.zeros((8, 32), np.int32),
                        "targets": np.zeros((8, 32), np.int32)},
                       np.array([0, 1], np.uint32))}
        port = testing.run_ranks(testing.train_worker, N,
                                 f"file://{tmp / 'store'}", job, timeout=500)
        losses = {}
        for arch, (p, b) in fams.items():
            fcfg = get_smoke(arch)
            model = params_from_jax(p, fcfg, device="cpu")
            loss = loss_fn(model, fcfg, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
            grads = torch.autograd.grad(loss, list(model.parameters()))
            losses[arch] = (float(loss.detach()), dict(zip(
                (n for n, _ in model.named_parameters()), grads)))
        errs = [ref.communicate(timeout=600)[1] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err[-4000:]
    reference = {}
    for i in range(len(jobs)):
        reference.update(np.load(tmp / f"reference{i}.npz"))
    return {"port": port, "losses": losses, "reference": reference}


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(results, arch):
    from repro_torch.models.model import jax_leaf
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
        scale = np.abs(want_g).max()
        err = np.abs(g.numpy() - want_g).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_value(arch, policy):
    cfg = get_smoke(arch)
    model = params_from_jax(_np_params(cfg, 3), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _lm_batch(cfg, 2, 16, 4).items()}
    outs = []
    for c in (cfg.with_(remat=False), cfg.with_(remat=True, remat_policy=policy)):
        loss = loss_fn(model, c, batch)
        outs.append((loss.detach(), torch.autograd.grad(loss,
                                                        list(model.parameters()))))
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(AGG_CASES))
def test_aggregation_bitwise_on_every_rank(results, name):
    ref = results["reference"]
    want_mean, want_res = ref[f"agg/{name}/mean"], ref[f"agg/{name}/res"]
    for rank, out in enumerate(results["port"]):
        mean, res = out["agg"][name]
        np.testing.assert_array_equal(mean.view(np.int32),
                                      want_mean.view(np.int32),
                                      err_msg=f"{name}: mean of rank {rank}")
        np.testing.assert_array_equal(res.view(np.int32),
                                      want_res[rank].view(np.int32),
                                      err_msg=f"{name}: residual of rank {rank}")


@pytest.mark.parametrize("rank", range(N))
def test_local_update_matches_reference(results, rank):
    update, loss = results["port"][rank]["local"]
    ref = results["reference"]
    want = float(ref[f"local/{rank}/loss"])
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
    want_u = ref[f"local/{rank}/update"]
    for path, (o, n) in _spans(get_smoke(ARCH)):
        scale = np.abs(want_u[o:o + n]).max()
        err = np.abs(update[o:o + n] - want_u[o:o + n]).max()
        assert err <= GRAD_TOL * scale, (path, err, scale)


def _spans(cfg) -> list:
    spans, off = [], 0
    for path, shape in _leaves(cfg):
        n = int(np.prod(shape))
        spans.append((path, (off, n)))
        off += n
    return spans


def test_loss_falls_over_eight_steps(results):
    """The reference's ``test_train_step_loss_decreases_on_mesh``: smoke
    qwen3, 8 steps at lr 0.2 on 8 x 64-token Markov batches, 4 clients."""
    losses, params = results["port"][0]["train"]
    assert losses[-1] < losses[0] - 0.5, losses
    for out in results["port"][1:]:
        assert out["train"][0] == losses
        np.testing.assert_array_equal(out["train"][1].view(np.int32),
                                      params.view(np.int32))


def test_plain_mode_matches_reference(results):
    ref = results["reference"]
    for out in results["port"]:
        mode, params, loss = out["plain"]
        assert mode == "plain"
        want = float(ref["plain/loss"])
        assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
        before = np.concatenate([
            v.reshape(-1) for v in _leaf_arrays(_np_params(get_smoke(ARCH), 1))])
        for path, (o, n) in _spans(get_smoke(ARCH)):
            want = ref["plain/params"][o:o + n]
            step = np.abs(want - before[o:o + n]).max()
            # within the gradient's tolerance, plus the rounding of w - lr*g
            ulp = np.spacing(np.abs(before[o:o + n]).max())
            err = np.abs(params[o:o + n] - want).max()
            assert err <= GRAD_TOL * step + 2 * ulp, (path, err, step)


def _leaf_arrays(tree: dict) -> list:
    return [v for k in sorted(tree) for v in
            (_leaf_arrays(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def test_pod_mode_runs_and_moves_params(results):
    """The reference's ``test_multipod_pod_mode_train_step_runs``: smoke
    chameleon with ``fsdp=True``, two pods (ranks 0 and 1)."""
    for out in results["port"][:2]:
        mode, n_clients, loss, moved = out["pod"]
        assert mode == "pod" and n_clients == 2
        assert np.isfinite(loss) and moved > 0
    assert "pod" not in results["port"][2]
