"""Training launcher: the distributed train step on a reduced (``--smoke``)
or published config, one client per rank.

Alone it runs as one client (a process group of one); under ``torchrun``
every rank is one client of the group it joins from torchrun's
environment.  The ranks meet over gloo, which lets several ranks share
one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 20 --batch 8 --seq 128
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen3-0.6b --smoke --steps 20
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get, get_smoke
from repro_torch.core import prng
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models.model import init_params, param_tree
from repro_torch.training.dist_step import FlatLayout, make_train_step


def _join_group() -> str | None:
    """Join torchrun's group (``env://``), or make a group of one over a
    file store in a fresh directory (returned, to be removed)."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group("gloo", init_method="env://")
        return None
    store = tempfile.mkdtemp(prefix="repro_torch_train_")
    dist.init_process_group("gloo", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    return store


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 (refused on one card)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--aggregator", default=None, choices=[None, "fediac", "dense"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if args.aggregator:
        cfg = cfg.with_(aggregator=args.aggregator)
    store = _join_group()
    try:
        rank = dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)
        mesh = (make_production_mesh(multi_pod=args.multi_pod)
                if args.production_mesh
                else make_test_mesh(multi_pod=args.multi_pod))
        bundle = make_train_step(cfg, mesh, lr=args.lr)
        key = prng.PRNGKey(0, device=device)
        params = init_params(cfg, key, device=device)
        if bundle.mode == "plain":
            residual = torch.zeros((), dtype=torch.float32, device=device)
        else:
            residual = torch.zeros(FlatLayout(params).size, device=device,
                                   dtype=getattr(torch, cfg.residual_dtype))

        rng = np.random.default_rng(0)
        t0 = time.time()
        for i, b in enumerate(lm_batches(rng, cfg.vocab, args.batch, args.seq,
                                         args.steps)):
            if cfg.is_enc_dec:
                b["frames"] = np.asarray(
                    rng.normal(size=(args.batch, cfg.source_len, cfg.d_model)),
                    np.float32) * 0.02
            batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
            key, sk = prng.split(key)
            params, residual, metrics = bundle.step(params, residual, batch, sk)
            if rank == 0:
                print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                      f"|u|={float(metrics['update_norm']):.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt and rank == 0:
            save_checkpoint(args.ckpt, param_tree(params), step=args.steps)
            print(f"saved checkpoint to {args.ckpt}")
    finally:
        dist.destroy_process_group()
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
