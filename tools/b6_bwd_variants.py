#!/usr/bin/env python3
"""Time variants of B6's bf16 backward (``flash_bwd_dkdv_wgmma``,
``flash_bwd_dq_wgmma``) on one NVIDIA GPU.

Each variant is a copy of ``src/repro_torch/kernels/csrc/attention_bwd.cu``
whose (128, 128) instance takes another query-tile width in the dk/dv
kernel (``NQ``: the width of s^T and dp^T beside the dk and dv
accumulators).  All are built with the port's nvcc flags into
``build/b6_bwd_variants/``; each prints the registers and spilled bytes
of its tensor-core instances.  Then, at every bf16 shape of
``chip_smoke.B6_BWD_CASES``, each variant that differs there runs the
backward as the wrapper does, is held to autograd through
``flash_attention_plain`` (``chip_smoke.B6_BWD_TOL``) and bitwise across
two runs, and is timed whole, dk/dv alone and dq alone (each with the
delta kernel; device ms per call of a replayed CUDA graph, the lower of
two passes in opposite orders).  Run from the repository root:

    python3 tools/b6_bwd_variants.py
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: query rows per dk/dv tile at the (128, 128) instance
NQS = (32, 48, 64)
#: (q, k, v) gradients wanted: the whole backward, dk/dv alone, dq alone
PARTS = {"whole": (True, True, True), "dkdv": (False, True, True),
         "dq": (True, False, False)}


def _variant_source(src: str, nq: int) -> str:
    src, n = re.subn(r"launch_tc<128, 128, \d+>", f"launch_tc<128, 128, {nq}>",
                     src)
    if n != 1:
        raise RuntimeError("attention_bwd.cu no longer launches one "
                           "launch_tc<128, 128, NQ> as this tool expects")
    return src


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    out_dir = ROOT / "build" / "b6_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "attention_bwd.cu").read_text()
    built = int(re.search(r"launch_tc<128, 128, (\d+)>", src).group(1))
    procs = {}
    for nq in NQS:
        cu = out_dir / f"nq{nq}.cu"
        cu.write_text(_variant_source(src, nq))
        procs[nq] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(out_dir / f"nq{nq}.so"), str(cu)])
    build.finish(("attention",))
    argtypes = dict(build.SOURCES["attention_bwd"])
    libs = {}
    for nq, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on NQ = {nq}")
        lib = ctypes.CDLL(str(out_dir / f"nq{nq}.so"))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs[nq] = lib
        print(json.dumps({"nq_at_128": nq, "as_built": nq == built, **{
            k: v for k, v in cs.bwd_res_usage(out_dir / f"nq{nq}.so").items()
            if "wgmma" in k}}), flush=True)
    print(cs.phase_card())
    for name, (b, s, h, d), hk, dv, causal, window, t, _ in cs.B6_BWD_CASES:
        gen = torch.Generator(device="cuda").manual_seed(s + t + d)
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                      .to(torch.bfloat16)
                      for shape in ((b, s, h, d), (b, t, hk, d),
                                    (b, t, hk, dv), (b, s, h, dv)))
        kw = dict(causal=causal, window=window)
        o, lse = fa._launch_forward(q, k, v, causal, window, True)
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        want = torch.autograd.grad(fa.flash_attention_plain(*xs, **kw), xs, g)
        nqs = NQS if (d, dv) == (128, 128) else (built,)
        times = {}
        for order in (nqs, tuple(reversed(nqs))):
            for nq in order:
                build._loaded["attention_bwd"] = libs[nq]
                got = fa.flash_attention_bwd(q, k, v, o, lse, g, **kw)
                again = fa.flash_attention_bwd(q, k, v, o, lse, g, **kw)
                torch.cuda.synchronize()
                errs = [float((x.float() - w.float()).abs().max()
                              / w.float().abs().max())
                        for x, w in zip(got, want)]
                if max(errs) > cs.B6_BWD_TOL["bfloat16"] or not all(
                        cs.same_bits(x, y) for x, y in zip(got, again)):
                    raise RuntimeError(f"NQ = {nq} at {name}: {errs}")
                for part, need in PARTS.items():
                    times.setdefault(f"nq{nq}", {}).setdefault(part, []).append(
                        cs.graph_ms(lambda: fa.flash_attention_bwd(  # noqa
                            q, k, v, o, lse, g, need=need, **kw),
                            launches=3, replays=2))
        print(json.dumps({"shape": name, "device_ms": {
            var: {part: min(ts) for part, ts in parts.items()}
            for var, parts in times.items()}}), flush=True)
        del q, k, v, g, o, lse, xs, want
        cs._free_card()
    build._loaded.pop("attention_bwd", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
