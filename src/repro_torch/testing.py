"""Helpers for holding the port against the JAX reference in tests.

Arrays cross between the two frameworks as numpy arrays.  torch has no
usable uint32 tensors (no shifts on the CPU), so uint32 data — threefry
keys and packed vote words — travels as int64 values (keys) or int32
bit-views (words).

:func:`run_ranks` runs a function on N spawned processes joined into one
gloo group, the port's stand-in for the reference's N-device mesh;
:func:`allreduce_worker` is the client side of the allreduce tests and
:func:`train_worker` of the train-step tests.  The
spawned processes import only this package.  Under pytest-xdist,
importing this module limits torch to one intra-op thread per worker.
"""

from __future__ import annotations

import os
import queue as queue_mod
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import prng

__all__ = ["to_torch", "to_numpy", "key_to_torch", "requires_cuda",
           "cuda_device", "run_ranks", "allreduce_worker", "train_cfg",
           "train_worker"]


def _share_cores() -> None:
    """One torch intra-op thread in each pytest-xdist worker.  The workers
    share the host's cores, and torch's default (a thread per core in every
    worker) oversubscribes them: six concurrent runs of a round test on 8
    cores took 67 s of wall time, 26 s with one thread each.  Every worker
    imports every test module while collecting, so this covers them all."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


_share_cores()


def to_torch(x, device="cpu") -> torch.Tensor:
    """numpy/JAX array -> torch tensor; uint32 becomes its int32 bit-view."""
    a = np.array(x)   # a writable host copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor, dtype=None) -> np.ndarray:
    """torch tensor -> numpy; ``dtype=np.uint32`` reinterprets int32 bits."""
    a = t.detach().cpu().numpy()
    if dtype is not None and np.dtype(dtype) == np.uint32:
        return a.view(np.uint32)
    return a if dtype is None else a.astype(dtype)


def key_to_torch(key, device="cpu") -> torch.Tensor:
    """A JAX uint32 key (or stack of keys) -> the port's int64 key."""
    return torch.from_numpy(np.asarray(key).astype(np.int64)).to(device)


#: marker for tests that need the card (registered in tests/conftest.py);
#: such a test also takes the ``cuda_device`` fixture, which skips it on a
#: host without one.  The check runs inside the fixture, never at import,
#: so every pytest worker collects the same tests.
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture
def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (none on this host)")
    return torch.device("cuda")


def _rank_main(fn, rank, world_size, init_method, backend, args, results):
    try:
        torch.set_num_threads(1)   # the ranks share the host's cores
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, init_method: str, *args,
              timeout: float = 600.0, backend: str = "gloo") -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes
    (``spawn`` start method) joined into one process group (``backend``,
    gloo unless told otherwise) at ``init_method``, a ``file://<path>``
    store in a fresh directory (no port to collide with another run).

    ``fn`` must be importable by the children and return something
    picklable.  Returns the results in rank order.  If a rank raises, or
    the ranks outlast ``timeout`` seconds, every process is stopped and a
    ``RuntimeError`` carries the failure.  Each rank runs torch's CPU
    work on one thread, as the ranks share the host's cores.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, init_method, backend, args,
                               results),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out = [None] * world_size
    deadline = time.monotonic() + timeout
    try:
        for _ in range(world_size):
            try:
                rank, ok, value = results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue_mod.Empty:
                raise RuntimeError(f"ranks did not finish in {timeout} s") \
                    from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A result tensor as numpy (bfloat16 widened exactly to float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def allreduce_worker(rank: int, world_size: int, cases) -> list:
    """One client of an allreduce on the CPU: ``fediac_allreduce`` /
    ``dense_allreduce`` (:mod:`repro_torch.core.fediac`) or a mesh baseline
    (:mod:`repro_torch.core.mesh_baselines`).

    ``cases`` is a list of ``(fn_name, cfg_kwargs, u[N, d], residual[N, d],
    key[2])`` with numpy arrays; ``cfg_kwargs`` may hold ``kernels`` (the
    engine's ``use_pallas``), and an empty one passes no config.  Returns
    ``(mean, new_residual)`` of this rank per case, as numpy.
    """
    from repro_torch.core import engines, fediac, mesh_baselines
    out = []
    for fn_name, kw, u, res, key in cases:
        cfg = None
        if kw:
            kw = dict(kw)
            spec = engines.EngineSpec(use_pallas=kw.pop("kernels", False))
            cfg = fediac.FediACConfig(**kw, engine=spec)
        fn = getattr(fediac, fn_name, None) or getattr(mesh_baselines, fn_name)
        mean, new_res = fn(
            torch.from_numpy(u[rank]), torch.from_numpy(res[rank]),
            key_to_torch(key), cfg)
        out.append((_host(mean), _host(new_res)))
    return out


def train_cfg(arch: str, kw: dict):
    """A smoke config with ``kw``'s changes: ArchConfig fields, FediAC
    fields under ``"fediac"``, and ``kernels`` for the engine's
    ``use_pallas`` (as ``make_train_step(..., use_pallas=)`` sets it)."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.core import engines
    kw = dict(kw)
    cfg = get_smoke(arch)
    fed = dict(kw.pop("fediac", {}))
    if "kernels" in kw:
        fed["engine"] = dataclasses.replace(engines.resolve(cfg.fediac),
                                            use_pallas=kw.pop("kernels"))
    return cfg.with_(fediac=dataclasses.replace(cfg.fediac, **fed), **kw)


def train_worker(rank: int, world_size: int, job: dict) -> dict:
    """One rank of the train-step tests on the CPU (``make_train_step`` on
    ``launch.mesh.make_test_mesh()``); each entry of ``job`` is optional:

    * ``agg``: ``(cases, u[N, d], residual[N, d], key[2])``, ``cases`` a
      list of ``(name, arch, cfg_kw)``: this client's aggregation of its
      raveled update and residual -> ``{name: (mean, new_residual)}``;
    * ``local``: ``(arch, params, batch, lr)``, the reference's parameter
      tree and global batch as numpy: this client's local update on its
      rows -> ``(update, loss)``;
    * ``train``: ``(arch, batches, lr, key)``: ``len(batches)`` steps from
      ``init_params(cfg, PRNGKey(0))`` -> the losses and the raveled
      parameters after them;
    * ``plain``: ``(arch, params, batch, lr, key)``: one step of ``arch``
      with ``fsdp=True`` (plain mode) -> ``(raveled parameters, loss)``;
    * ``pod``: ``(arch, batch, key)``: ranks 0 and 1 as two pods, one step
      of ``arch`` with ``fsdp=True`` from ``init_params`` -> ``(mode,
      n_clients, loss, sum of |parameter change|)``.
    """
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_params, params_from_jax
    from repro_torch.training import dist_step
    out = {}

    def tensors(batch):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}

    if "agg" in job:
        cases, u, res, key = job["agg"]
        out["agg"] = {}
        for name, arch, kw in cases:
            cfg = train_cfg(arch, kw)
            layout = dist_step.FlatLayout(init_params(
                cfg, torch.zeros(2, dtype=torch.int64, device="meta"),
                device="meta"))
            mean, new_res = dist_step._aggregate(
                cfg, torch.from_numpy(u[rank]), torch.from_numpy(res[rank]),
                key_to_torch(key), layout, None)
            out["agg"][name] = (_host(mean), _host(new_res))
    if "local" in job:
        arch, params, batch, lr = job["local"]
        cfg = train_cfg(arch, {})
        model = params_from_jax(params, cfg, device="cpu")
        rows = batch["tokens"].shape[0] // world_size
        update, loss, _ = dist_step._local_update(
            cfg, model, dist_step._rows(tensors(batch), rank, rows, "cpu"),
            lr, dist_step.FlatLayout(model),
            max(1, min(cfg.microbatch, rows)))
        out["local"] = (_host(update), float(loss))
    if "train" in job:
        arch, batches, lr, key = job["train"]
        cfg = train_cfg(arch, {})
        model = init_params(cfg, prng.PRNGKey(0, device="cpu"), device="cpu")
        bundle = dist_step.make_train_step(cfg, make_test_mesh(), lr=lr)
        residual = torch.zeros(dist_step.FlatLayout(model).size)
        key, losses = key_to_torch(key), []
        for batch in batches:
            key, sk = prng.split(key)
            model, residual, metrics = bundle.step(model, residual,
                                                   tensors(batch), sk)
            losses.append(float(metrics["loss"]))
        out["train"] = (losses, _host(dist_step.FlatLayout(model).gather()))
    if "plain" in job:
        arch, params, batch, lr, key = job["plain"]
        cfg = train_cfg(arch, {"fsdp": True})
        model = params_from_jax(params, cfg, device="cpu")
        bundle = dist_step.make_train_step(cfg, make_test_mesh(), lr=lr)
        model, _, metrics = bundle.step(model, torch.zeros(()),
                                        tensors(batch), key_to_torch(key))
        out["plain"] = (bundle.mode,
                        _host(dist_step.FlatLayout(model).gather()),
                        float(metrics["loss"]))
    if "pod" in job:
        arch, batch, key = job["pod"]
        pods = dist.new_group([0, 1])
        if rank < 2:
            cfg = train_cfg(arch, {"fsdp": True})
            bundle = dist_step.make_train_step(
                cfg, make_test_mesh(multi_pod=True, group=pods), lr=0.1)
            model = init_params(cfg, prng.PRNGKey(0, device="cpu"),
                                device="cpu")
            before = dist_step.FlatLayout(model).gather()
            residual = torch.zeros(before.numel(),
                                   dtype=getattr(torch, cfg.residual_dtype))
            model, residual, metrics = bundle.step(
                model, residual, tensors(batch), key_to_torch(key))
            moved = (dist_step.FlatLayout(model).gather() - before).abs().sum()
            out["pod"] = (bundle.mode, bundle.n_clients,
                          float(metrics["loss"]), float(moved))
    return out
