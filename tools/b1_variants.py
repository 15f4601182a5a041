#!/usr/bin/env python3
"""Time variants of B1 (``gather_quant``) on one NVIDIA GPU.

Each variant is a copy of ``src/repro_torch/kernels/csrc/quant.cu`` with
two of its design constants changed: the 16-byte vectors each thread
loads before it uses the first (``kUnroll``) and a minimum of resident
blocks per SM given to ``__launch_bounds__`` (0: none).  All are built
with the port's nvcc flags into ``build/b1_variants/`` and launched as
the wrapper launches the kernel, on the same operands, at B1's shapes on
the port's paths; each prints its registers, then per shape its device
ms per launch (the lower of two passes, in opposite orders, of a
replayed CUDA graph) and its share of the bytes bound.  Run from the
repository root:

    python3 tools/b1_variants.py
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
UNROLLS = (1, 2, 4, 8)
MIN_BLOCKS = (0, 4)
#: B1's shapes on the paths: the stacked round, the allreduce, the stream
#: chunk, the FL loops' stacks, the train path's largest leaf
SHAPES = ((32, 1_000_000), (1, 12_500_992), (8, 262_144), (20, 21_322),
          (10, 15_178), (1, 155_582_464))


def _variant_source(src: str, unroll: int, min_blocks: int) -> str:
    src, n = re.subn(r"constexpr int kUnroll = \d+;",
                     f"constexpr int kUnroll = {unroll};", src)
    bounds = "__global__ void __launch_bounds__(kThreads)"
    if n != 1 or bounds not in src:
        raise RuntimeError("quant.cu no longer declares kUnroll and the "
                           "kernel's launch bounds as this tool expects")
    if min_blocks:
        src = src.replace(bounds, bounds[:-1] + f", {min_blocks})")
    return src


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.gather_quant import gather_quant_plain
    out_dir = ROOT / "build" / "b1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "quant.cu").read_text()
    procs = {}
    for unroll in UNROLLS:
        for minb in MIN_BLOCKS:
            name = f"unroll{unroll}_minblocks{minb}"
            cu = out_dir / f"{name}.cu"
            cu.write_text(_variant_source(src, unroll, minb))
            procs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o",
                 str(out_dir / f"{name}.so"), str(cu)])
    argtypes = dict(build.SOURCES["quant"])["repro_gather_quant"]
    fns = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {name}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).repro_gather_quant
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
        usage = subprocess.run(
            [str(Path(build._nvcc()).parent / "cuobjdump"), "-res-usage",
             str(out_dir / f"{name}.so")], capture_output=True, text=True,
            check=True).stdout.split("gather_quant_kernel")[1]
        print(name, usage.splitlines()[1].strip(), flush=True)
    print(cs.phase_card())
    for n, d in SHAPES:
        u, uni, sel, f = cs._stack_gather_inputs(n, d, seed=2)
        q = torch.empty(u.shape, dtype=torch.int32, device="cuda")
        r = torch.empty_like(u)
        want = gather_quant_plain(u, uni, sel, f)
        times = {}
        for order in (list(fns), list(reversed(fns))):
            for name in order:
                def call(fn=fns[name]):
                    err = fn(u.data_ptr(), d, uni.data_ptr(), d,
                             sel.data_ptr(), f.data_ptr(), q.data_ptr(),
                             r.data_ptr(), d, n, d,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                call()
                torch.cuda.synchronize()
                if not (cs.same_bits(q, want[0]) and cs.same_bits(r, want[1])):
                    raise RuntimeError(f"{name} at {[n, d]} != plain")
                times.setdefault(name, []).append(cs.graph_ms(
                    call, launches=20 if n * d > 5e7 else 50))
        bound = cs.bound(16 * n * d + d + 4, 8 * n * d)[0]
        print(json.dumps({"shape": [n, d], "bound_ms": bound, "device_ms": {
            k: min(v) for k, v in times.items()}, "share_of_bound": {
            k: bound / min(v) for k, v in times.items()}}), flush=True)
        del u, uni, sel, f, q, r, want
        cs._free_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
