"""Serving launcher: a step-by-step decode loop on a reduced (``--smoke``)
or published config, prompt tokens fed one at a time, then greedy tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --smoke --batch 4 --prompt-len 32 --gen 16
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get, get_smoke
from repro_torch.core import prng
from repro_torch.models.model import decode_step, init_caches, init_params


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    params = init_params(cfg, prng.PRNGKey(0, device=device), device=device)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=device)

    caches = init_caches(cfg, args.batch, args.cache_len, device=device)

    def dstep(tok, caches, pos: int):
        return decode_step(params, cfg, tok, caches,
                           torch.tensor(pos, dtype=torch.int32, device=device))

    # prefill by stepping (the reference's simple serving loop)
    t0 = time.time()
    for i in range(args.prompt_len):
        logits, caches = dstep(prompt[:, i:i + 1], caches, i)
    generated = []
    for i in range(args.gen):
        nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        generated.append(nxt)
        logits, caches = dstep(nxt, caches, args.prompt_len + i)
    out = torch.cat(generated, dim=1)
    dt = time.time() - t0
    toks = args.batch * (args.prompt_len + args.gen)
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    print(out.cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
