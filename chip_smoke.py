#!/usr/bin/env python3
"""Drive the PyTorch port of FediAC on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. card: name and power limit, as ``nvidia-smi`` reports them;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernel parity: each kernel against its plain-torch version on the card,
   bitwise, at the main path's shapes and at ragged / edge cases;
4. main path: two FediAC rounds at d = 1,000,000 and N = 32 (the largest
   monolithic cell of ``benchmarks/aggregation_round.py``), vote_chunk 1
   and 4, with the fused kernels on, then 3 rounds of the FL loop at its
   default configuration; the kernel launch counts are zeroed just before
   and read just after;
5. checks: the rounds' outputs against the same computation on the CPU
   (plain versions) from the card's vote counts, bitwise, and the vote
   counts of a whole CPU round against the card's; the FL loop against
   its CPU run;
6. timing: each kernel, its plain version and its memory bound at the main
   path's shapes, and whole rounds.  A kernel's ``ms`` is CUDA-event time
   per wrapper call (it includes the host's launch work whenever that is
   slower than the kernel); ``device_ms`` is the kernel alone, from
   ``torch.profiler``.

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside the repository, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
N_CLIENTS, D = 32, 1_000_000
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def same_bits(a, b) -> bool:
    """Bitwise equality of two tensors of one dtype (float via int32 view)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(pairs) -> float:
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in pairs)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def wall_ms(fn, iters: int = 3) -> float:
    """Mean host milliseconds of ``fn()`` ending in a device synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_profile(fn, iters: int = 3) -> list:
    """Device milliseconds per call of ``fn()``, by CUDA kernel name, from
    ``torch.profiler`` (CUPTI): [(kernel, ms per call, launches per call)],
    longest first.  Empty when the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / iters, e.count / iters)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def kernel_device_ms(fn, kernel: str, iters: int = 20):
    """Device ms of one launch of ``kernel`` inside ``fn()``, or None when
    the profiler reports no device time for it."""
    rows = [r for r in device_profile(fn, iters) if kernel in r[0]]
    return rows[0][1] / rows[0][2] if rows else None


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = out.splitlines()[0].strip()
    log(f"[card] {card}")
    return card


def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    seconds = build.build_all()
    total = time.perf_counter() - t0
    log(f"[build] {seconds} ({total:.1f} s in all)")
    return total


def _inputs(n, d, density, seed):
    """u (heavy-tailed, like client updates), uniforms, sel, on the card."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(seed)
    scale = torch.empty(d, device=DEV).exponential_(generator=gen)
    u = torch.randn(n, d, device=DEV, generator=gen) * scale
    uni = torch.rand(n, d, device=DEV, generator=gen)
    sel = (torch.rand(d, device=DEV, generator=gen) < density).to(torch.uint8)
    return u, uni, sel


def phase_parity() -> dict:
    """Kernel vs plain version on the card, bitwise."""
    import torch
    from repro_torch.core.quantize import scale_factor
    from repro_torch.kernels.gather_quant import gather_quant, gather_quant_plain
    from repro_torch.kernels.stoch_quant import stoch_quant, stoch_quant_plain
    errs = {"gather_quant": [], "stoch_quant": []}
    u, uni, sel = _inputs(N_CLIENTS, D, 0.05, seed=1)
    f = torch.tensor(scale_factor(12, N_CLIENTS, 1.0), device=DEV) / u.abs().max()
    cases = [(u, uni, sel, f)]
    cap_g = 4 * round(0.05 * D / 4)           # C * g of the vote_chunk=4 round
    for fv in (1.0, 117.5, 4000.0):
        for dens in (0.0, 0.1, 1.0):
            u2, uni2, sel2 = _inputs(3, 123_457, dens, seed=int(fv) + int(10 * dens))
            cases.append((u2, uni2, sel2, torch.tensor(fv, device=DEV)))
    for u_, uni_, sel_, f_ in cases:
        qk, rk = gather_quant(u_, uni_, sel_, f_)
        qp, rp = gather_quant_plain(u_, uni_, sel_, f_)
        torch.cuda.synchronize()
        check(same_bits(qk, qp) and same_bits(rk, rp),
              f"gather_quant != plain at {tuple(u_.shape)}, f={float(f_)}")
        errs["gather_quant"].append(max_abs_err([(qk, qp), (rk, rp)]))
        for cols in ({u_.shape[1]} | ({cap_g} if u_.shape[1] == D else set())):
            a, b = u_[:, :cols].contiguous(), uni_[:, :cols].contiguous()
            sk, sp = stoch_quant(a, b, f_), stoch_quant_plain(a, b, f_)
            torch.cuda.synchronize()
            check(same_bits(sk, sp),
                  f"stoch_quant != plain at {tuple(a.shape)}, f={float(f_)}")
            errs["stoch_quant"].append(max_abs_err([(sk, sp)]))
    log(f"[parity] {len(cases)} cases bitwise for both kernels")
    return {k: max(v) for k, v in errs.items()}


def _fl_setup():
    from repro_torch.core.engines import EngineSpec
    from repro_torch.data import classification, partition_dirichlet
    from repro_torch.training.fl_loop import FLConfig
    data = classification(seed=0)
    train, test = data.test_split(0.2)
    clients = partition_dirichlet(train, 20, beta=0.5, seed=0)
    cfg = FLConfig(rounds=3, engine=EngineSpec(use_pallas=True))
    return clients, test, cfg


def _round_cfg(g):
    from repro_torch.core.engines import EngineSpec
    from repro_torch.core.fediac import FediACConfig
    return FediACConfig(vote_chunk=g, engine=EngineSpec(use_pallas=True))


def phase_main_path(u_stack, key) -> dict:
    """The port's main path with the launch counts zeroed just before."""
    import torch
    from repro_torch.core.fediac import aggregate_round
    from repro_torch.kernels.gather_quant import gather_quant
    from repro_torch.kernels.stoch_quant import stoch_quant
    from repro_torch.training.fl_loop import run_federated
    clients, test, flcfg = _fl_setup()
    gather_quant.launches = 0
    stoch_quant.launches = 0
    rounds = {}
    for g in (1, 4):
        out = aggregate_round(u_stack, _round_cfg(g), key)
        torch.cuda.synchronize()
        rounds[g] = out
    after_rounds = (gather_quant.launches, stoch_quant.launches)
    hist = run_federated(clients, test, flcfg, device=DEV)
    launches = {"gather_quant": gather_quant.launches,
                "stoch_quant": stoch_quant.launches}
    log(f"[main path] launches {launches} (after the two rounds: "
        f"{after_rounds}); FL acc {hist.acc} loss {hist.loss}")
    check(after_rounds == (1, 1), f"round launches {after_rounds} != (1, 1)")
    check(launches["gather_quant"] - after_rounds[0] == flcfg.rounds,
          f"FL loop launched gather_quant "
          f"{launches['gather_quant'] - after_rounds[0]} times, "
          f"not {flcfg.rounds}")
    return {"rounds": rounds, "hist": hist, "launches": launches}


def phase_checks(u_stack, key, main) -> dict:
    """Outputs against the CPU (plain versions) and the FL run's sanity."""
    import torch
    from repro_torch.core.fediac import aggregate_from_counts, aggregate_stack
    from repro_torch.training.fl_loop import run_federated
    report = {}
    u_cpu, key_cpu = u_stack.cpu(), key.cpu()
    for g, (delta, residuals, counts, traffic) in main["rounds"].items():
        cfg = _round_cfg(g)
        k = cfg.k(D // g)
        check(delta.shape == (D,) and residuals.shape == (N_CLIENTS, D)
              and counts.shape == (D // g,), f"g={g}: output shapes")
        check(bool(torch.isfinite(delta).all() and torch.isfinite(residuals).all()),
              f"g={g}: non-finite outputs")
        check(int(counts.sum()) == N_CLIENTS * k,
              f"g={g}: counts sum {int(counts.sum())} != N*k {N_CLIENTS * k}")
        t0 = time.perf_counter()
        d_cpu, r_cpu = aggregate_from_counts(u_cpu, cfg, key_cpu, counts.cpu())
        check(same_bits(delta, d_cpu) and same_bits(residuals, r_cpu),
              f"g={g}: card phase 2 + aggregate != CPU from the card's counts")
        _, _, c_cpu, _ = aggregate_stack(u_cpu, cfg, key_cpu)
        n_diff = int((c_cpu != counts.cpu()).sum())
        # the vote scores replay XLA's log on both devices, so the counts
        # are expected equal; the gate leaves room for a libm ulp in log.
        check(n_diff <= 1e-4 * (D // g),
              f"g={g}: {n_diff} vote counts differ card vs CPU")
        log(f"[checks] g={g}: phase 2 + aggregate bitwise card == CPU; "
            f"{n_diff} of {D // g} vote counts differ card vs CPU whole round "
            f"({time.perf_counter() - t0:.1f} s on the CPU)")
        report[f"counts_differ_g{g}"] = n_diff
    hist = main["hist"]
    clients, test, flcfg = _fl_setup()
    chance = 1.0 / clients[0].n_classes
    check(all(math.isfinite(x) for x in hist.loss), "FL loss not finite")
    check(hist.acc[-1] > chance, f"FL accuracy {hist.acc[-1]} not above "
          f"chance {chance}")
    h_cpu = run_federated(clients, test, flcfg, device="cpu")
    check(hist.traffic_mb == h_cpu.traffic_mb
          and hist.wall_clock == h_cpu.wall_clock,
          "FL traffic / wall-clock differ card vs CPU")
    acc_gap = max(abs(a - b) for a, b in zip(hist.acc, h_cpu.acc))
    loss_gap = max(abs(a - b) for a, b in zip(hist.loss, h_cpu.loss))
    # the same float32 arithmetic through other matmul kernels: gaps of
    # ~1e-7 are rounding, a wrong phase-2 step moves the model further
    check(acc_gap <= 1e-5 and loss_gap <= 1e-5,
          f"FL card vs CPU: acc gap {acc_gap}, loss gap {loss_gap}")
    log(f"[checks] FL card vs CPU: traffic and wall-clock equal; acc gap "
        f"{acc_gap:.3g}, loss gap {loss_gap:.3g}")
    report.update(fl_acc=hist.acc, fl_acc_gap=acc_gap, fl_loss_gap=loss_gap)
    return report


def phase_timing(u_stack, key) -> dict:
    import torch
    from repro_torch.core import fediac, prng, selection, voting
    from repro_torch.core.quantize import scale_factor
    from repro_torch.kernels.gather_quant import gather_quant, gather_quant_plain
    from repro_torch.kernels.stoch_quant import stoch_quant, stoch_quant_plain
    from repro_torch.training.fl_loop import run_federated
    out = {}
    n, d = N_CLIENTS, D
    u, uni, sel = _inputs(n, d, 0.05, seed=2)
    f = torch.tensor(scale_factor(12, n, 1.0), device=DEV) / u.abs().max()
    b_bytes = 16 * n * d + d + 4          # u, uni in; q, res out; sel; f
    b_ops = 8 * n * d                      # mul floor sub cmp add div sub select
    t_b, by_b = bound(b_bytes, b_ops)
    out["gather_quant"] = dict(
        ms=cuda_ms(lambda: gather_quant(u, uni, sel, f)),
        device_ms=kernel_device_ms(lambda: gather_quant(u, uni, sel, f),
                                   "gather_quant_kernel"),
        plain_ms=cuda_ms(lambda: gather_quant_plain(u, uni, sel, f), iters=5),
        bound_ms=t_b, bound_by=by_b, shape=[n, d])
    cols = 4 * round(0.05 * d / 4)
    a, b = u[:, :cols].contiguous(), uni[:, :cols].contiguous()
    s_bytes, s_ops = 12 * n * cols + 4, 5 * n * cols
    t_s, by_s = bound(s_bytes, s_ops)
    out["stoch_quant"] = dict(
        ms=cuda_ms(lambda: stoch_quant(a, b, f)),
        device_ms=kernel_device_ms(lambda: stoch_quant(a, b, f),
                                   "stoch_quant_kernel"),
        plain_ms=cuda_ms(lambda: stoch_quant_plain(a, b, f), iters=5),
        bound_ms=t_s, bound_by=by_s, shape=[n, cols])
    for g in (1, 4):
        cfg = _round_cfg(g)
        out[f"round_g{g}_ms"] = wall_ms(
            lambda: fediac.aggregate_round(u_stack, cfg, key))
        out[f"phase1_g{g}_ms"] = wall_ms(
            lambda: fediac._vote_counts_stack(
                u_stack, cfg, prng.split(key, 2 * n)[:n]))
    # where a round's device time goes, and how much of the round the
    # device sits idle (host-side launch and Python work)
    rows = device_profile(lambda: fediac.aggregate_round(u_stack,
                                                         _round_cfg(1), key))
    busy = sum(r[1] for r in rows)
    out["round_g1_device_ms"] = busy
    out["round_g1_idle_share"] = (1.0 - busy / out["round_g1_ms"]
                                  if rows else None)
    # the round's big components at g=1: the Gumbel draw (threefry + the
    # XLA-log replay), the uniform draw of the fused phase 2 (threefry),
    # the per-row vote sort
    keys = prng.split(key, n)
    out["gumbel_ms"] = wall_ms(lambda: prng.gumbel(keys, (d,)))
    out["uniform_ms"] = wall_ms(lambda: prng.uniform(keys, (d,)))
    scores = voting.vote_scores(u_stack, keys)
    k = _round_cfg(1).k(d)
    out["topk_counts_ms"] = wall_ms(
        lambda: selection.topk_counts_stack(scores, k))
    clients, test, flcfg = _fl_setup()
    t0 = time.perf_counter()
    run_federated(clients, test, flcfg, device=DEV)
    torch.cuda.synchronize()
    out["fl_round_ms"] = (time.perf_counter() - t0) * 1e3 / flcfg.rounds
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("[timing] " + json.dumps(out))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        log("error: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("error: no CUDA device; chip_smoke.py runs only on a GPU")
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"error: {ROOT} is not a checkout of the repository "
            "(src/repro_torch is missing)")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets the float32 matmul flags)
    from repro_torch.core import prng

    t_start = time.perf_counter()
    card = phase_card()
    build_s = phase_build()
    parity_err = phase_parity()
    gen = torch.Generator(device=DEV).manual_seed(0)
    scale = torch.empty(D, device=DEV).exponential_(generator=gen)
    u_stack = torch.randn(N_CLIENTS, D, device=DEV, generator=gen) * scale
    key = prng.PRNGKey(0, device=DEV)
    main_path = phase_main_path(u_stack, key)
    report = phase_checks(u_stack, key, main_path)
    timing = phase_timing(u_stack, key)

    src = "src/repro_torch/kernels/csrc/quant.cu"
    kernels = []
    for name, replaces in (("gather_quant", "src/repro/kernels/gather_quant.py:37"),
                           ("stoch_quant", "src/repro/kernels/stoch_quant.py:26")):
        t = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": main_path["launches"][name],
                        "max_abs_err": parity_err[name], "bitwise": True,
                        "ms": t["ms"], "device_ms": t["device_ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": None, "shape": t["shape"]})
    summary = {"build_s": build_s, "total_s": time.perf_counter() - t_start,
               **report, **{k: v for k, v in timing.items()
                            if k not in ("gather_quant", "stoch_quant")}}
    log("[summary] " + json.dumps(summary))
    print(json.dumps({"summary": summary}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
