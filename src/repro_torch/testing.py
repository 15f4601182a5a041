"""Helpers for holding the port against the JAX reference in tests.

Arrays cross between the two frameworks as numpy arrays.  torch has no
usable uint32 tensors (no shifts on the CPU), so uint32 data — threefry
keys and packed vote words — travels as int64 values (keys) or int32
bit-views (words).

:func:`run_ranks` runs a function on N spawned processes joined into one
gloo group, the port's stand-in for the reference's N-device mesh;
:func:`allreduce_worker` is the client side of the allreduce tests.  The
spawned processes import only this package.
"""

from __future__ import annotations

import queue as queue_mod
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

__all__ = ["to_torch", "to_numpy", "key_to_torch", "requires_cuda",
           "cuda_device", "run_ranks", "allreduce_worker"]


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


def _rank_main(fn, rank, world_size, init_method, args, results):
    try:
        torch.set_num_threads(1)   # the ranks share the host's cores
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
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
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes
    (``spawn`` start method) joined into one gloo process group at
    ``init_method``, a ``file://<path>`` store in a fresh directory (no
    port to collide with another run).

    ``fn`` must be importable by the children and return something
    picklable.  Returns the results in rank order.  If a rank raises, or
    the ranks outlast ``timeout`` seconds, every process is stopped and a
    ``RuntimeError`` carries the failure.  Each rank runs torch's CPU
    work on one thread, as the ranks share the host's cores.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, init_method, args, results),
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
    """One client of ``fediac_allreduce`` / ``dense_allreduce`` on the CPU.

    ``cases`` is a list of ``(fn_name, cfg_kwargs, u[N, d], residual[N, d],
    key[2])`` with numpy arrays; ``cfg_kwargs`` may hold ``kernels`` (the
    engine's ``use_pallas``).  Returns ``(mean, new_residual)`` of this
    rank per case, as numpy.
    """
    from repro_torch.core import engines, fediac
    out = []
    for fn_name, kw, u, res, key in cases:
        cfg = None
        if fn_name == "fediac_allreduce":
            kw = dict(kw)
            spec = engines.EngineSpec(use_pallas=kw.pop("kernels", False))
            cfg = fediac.FediACConfig(**kw, engine=spec)
        mean, new_res = getattr(fediac, fn_name)(
            torch.from_numpy(u[rank]), torch.from_numpy(res[rank]),
            key_to_torch(key), cfg)
        out.append((_host(mean), _host(new_res)))
    return out
