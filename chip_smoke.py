#!/usr/bin/env python3
"""Drive the PyTorch port of FediAC on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. card: name and power limit, as ``nvidia-smi`` reports them;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``quant.cu`` and ``votes.cu``, one ``nvcc`` each, in parallel);
3. kernel parity: each kernel against its plain-torch version on the card,
   bitwise, at the main paths' shapes and at ragged / edge cases;
4. main path: two FediAC rounds at d = 1,000,000 and N = 32 (the largest
   monolithic cell of ``benchmarks/aggregation_round.py``), vote_chunk 1
   and 4, with the fused kernels on, then 3 rounds of the FL loop at its
   default configuration; the kernel launch counts are zeroed just before
   and read just after;
5. checks: the rounds' outputs against the same computation on the CPU
   (plain versions) from the card's vote counts, bitwise, and the vote
   counts of a whole CPU round against the card's; the FL loop against
   its CPU run;
6. allreduce path: 8 ranks on the one card over gloo (spawned once), each
   one client of ``fediac_allreduce`` at d = 12,500,992 (one device's
   slice of the reference's d ~ 1e8 sort-free scale cell) on the packed
   wire, threshold/block (``vote_pack`` + ``popcount``) and topk/topk
   (``pack`` + ``popcount`` + ``gather_quant``), two rounds each carrying
   residuals, with each rank's launch counts zeroed just before and read
   just after; gates on every rank; then both configs at d = 1,000,000 on
   the card and on the CPU, bitwise; then round and collective times;
7. timing: each kernel, its plain version and its memory bound at the main
   paths' shapes (``gather_quant`` at both of its shapes), and whole
   rounds.  A kernel's ``ms`` is CUDA-event time per wrapper call (it
   includes the host's launch work whenever that is slower than the
   kernel); ``device_ms`` is the kernel alone, per launch of a replayed
   CUDA graph of back-to-back calls.

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside the repository, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
N_CLIENTS, D = 32, 1_000_000
FL_SHAPE = (20, 21_322)          # the FL loop's update stack: 20 clients x
                                 # the MLP 96-128-64-10's parameters
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores;
                                 # also the bound used for integer ALU work
AR_RANKS = 8                     # clients of the allreduce, one rank each
AR_D = 8 * 4096 * 3052 // 8      # 12,500,992: SHARD_D / SHARD_DEVICES of
                                 # benchmarks/aggregation_round.py
AR_CHECK_D = 1_000_000           # card vs CPU allreduce width
AR_ROUNDS = 2
AR_TIME_ITERS = 3
WIRE_D = AR_D


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


def graph_ms(fn, launches: int = 50, replays: int = 5) -> float:
    """Device ms per call of ``fn()`` replayed from a CUDA graph of
    ``launches`` back-to-back calls: the host's launch work drops out,
    which a short kernel's per-call time cannot show.  Raises when the
    capture is refused."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(stop) / (replays * launches)


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernel(fn, plain, nbytes: int, ops: int, shape: list) -> dict:
    """A kernel wrapper's call ms (CUDA events per call), its device ms (a
    CUDA graph's replay), its plain version's ms and its bound."""
    t_b, by_b = bound(nbytes, ops)
    return dict(ms=cuda_ms(fn), device_ms=graph_ms(fn),
                plain_ms=cuda_ms(plain, iters=5), bound_ms=t_b, bound_by=by_b,
                bytes=nbytes, shape=shape)


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


def _stack_gather_inputs(n, d, seed):
    """gather_quant's operands as the stacked round gives them to it: u,
    uniforms, a 5% consensus mask and f from the stack's max."""
    import torch
    from repro_torch.core.quantize import scale_factor
    u, uni, sel = _inputs(n, d, 0.05, seed)
    return u, uni, sel, torch.tensor(scale_factor(12, n, 1.0),
                                     device=DEV) / u.abs().max()


def _ar_gather_inputs():
    """gather_quant's operands as the allreduce's topk config (B) gives
    them to it: one rank's update as a [1, AR_D] stack, its uniforms, a 5%
    consensus mask and f from the update's max."""
    import torch
    from repro_torch.core.quantize import scale_factor
    u = _rank_update(0, AR_D)[None]
    _, uni, sel = _inputs(1, AR_D, 0.05, seed=3)
    sf = scale_factor(_ar_configs()["B"].bits, AR_RANKS, 1.0)
    return u, uni, sel, torch.tensor(sf, device=DEV) / u.abs().max()


def phase_parity() -> dict:
    """Kernel vs plain version on the card, bitwise."""
    import torch
    from repro_torch.kernels.gather_quant import gather_quant, gather_quant_plain
    from repro_torch.kernels.stoch_quant import stoch_quant, stoch_quant_plain
    errs = {"gather_quant": [], "stoch_quant": []}
    cases = [_stack_gather_inputs(N_CLIENTS, D, seed=1), _ar_gather_inputs(),
             _stack_gather_inputs(*FL_SHAPE, seed=4)]
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


def _wire_inputs(d, seed):
    """A 5% 0/1 mask and |normal|**3 scores with NaNs, on the card."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(seed)
    mask = (torch.rand(d, device=DEV, generator=gen) < 0.05).to(torch.uint8)
    scores = torch.randn(d, device=DEV, generator=gen).abs() ** 3
    scores[3::997] = math.nan
    return mask, scores


def _words(n, d, seed):
    """Random int32 packed words of n clients for a d-vector, on the card."""
    import torch
    from repro_torch.kernels.ref import LANES, wire_groups
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randint(-2**31, 2**31, (n, wire_groups(d), LANES),
                         dtype=torch.int32, device=DEV, generator=gen)


def phase_wire_parity() -> dict:
    """The packed wire's kernels vs their plain versions on the card,
    bitwise: at d = WIRE_D, ragged d, tau in {0, the 5% quantile, inf,
    -inf} with NaN scores, and popcount over N in {1, 8, 64} clients."""
    import torch
    from repro_torch.kernels import bitpack, vote_pack, vote_popcount
    errs = {k: [] for k in ("vote_pack", "pack", "unpack", "popcount_accum")}
    n_cases = 0
    for d in (WIRE_D, 1, 70_001, 300_000):
        mask, scores = _wire_inputs(d, seed=d)
        words = bitpack.pack(mask)
        plain = bitpack.pack_plain(mask)
        torch.cuda.synchronize()
        check(same_bits(words, plain), f"pack != plain at d={d}")
        errs["pack"].append(max_abs_err([(words, plain)]))
        back = bitpack.unpack(words, d)
        torch.cuda.synchronize()
        check(same_bits(back, bitpack.unpack_plain(words, d))
              and same_bits(back, mask), f"unpack != plain at d={d}")
        errs["unpack"].append(max_abs_err([(back, mask)]))
        finite = scores[torch.isfinite(scores)]
        q95 = torch.quantile(finite[:1 << 24].float(), 0.95) if d > 1 \
            else finite.max()
        for tau in (torch.zeros((), device=DEV), q95.reshape(()),
                    torch.tensor(math.inf, device=DEV),
                    torch.tensor(-math.inf, device=DEV)):
            got = vote_pack.vote_pack(scores, tau)
            want = vote_pack.vote_pack_plain(scores, tau)
            torch.cuda.synchronize()
            check(same_bits(got, want),
                  f"vote_pack != plain at d={d}, tau={float(tau)}")
            errs["vote_pack"].append(max_abs_err([(got, want)]))
        for n in ((1, 8, 64) if d in (WIRE_D, 70_001) else (8,)):
            stack = _words(n, d, seed=n + d)
            got = vote_popcount.popcount_accum(stack, d)
            want = vote_popcount.popcount_accum_plain(stack, d)
            torch.cuda.synchronize()
            check(same_bits(got, want), f"popcount != plain at N={n}, d={d}")
            errs["popcount_accum"].append(max_abs_err([(got, want)]))
            del stack
        n_cases += 1
    log(f"[wire parity] {n_cases} widths bitwise for the four wire kernels")
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
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    rounds = {}
    for g in (1, 4):
        out = aggregate_round(u_stack, _round_cfg(g), key)
        torch.cuda.synchronize()
        rounds[g] = out
    after_rounds = (gather_quant.launches, stoch_quant.launches)
    hist = run_federated(clients, test, flcfg, device=DEV)
    launches = {k: c.launches for k, c in counters.items()}
    log(f"[main path] launches {launches} (after the two rounds: "
        f"{after_rounds}); FL acc {hist.acc} loss {hist.loss}")
    check(after_rounds == (1, 1), f"round launches {after_rounds} != (1, 1)")
    check(launches["gather_quant"] - after_rounds[0] == flcfg.rounds,
          f"FL loop launched gather_quant "
          f"{launches['gather_quant'] - after_rounds[0]} times, "
          f"not {flcfg.rounds}")
    return {"rounds": rounds, "hist": hist, "launches": launches,
            "round_launches": after_rounds[0]}


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


# ---------------------------------------------------------------------------
# The allreduce path: AR_RANKS clients, one rank each, on the one card
# ---------------------------------------------------------------------------

#: the port's kernels of the allreduce path, by config, and their wrappers
AR_PATH_KERNELS = {"A": ("vote_pack", "popcount_accum"),
                   "B": ("pack", "popcount_accum", "gather_quant")}


def _ar_configs():
    from repro_torch.core.engines import EngineSpec
    from repro_torch.core.fediac import FediACConfig
    spec = EngineSpec(use_pallas=True)
    return {"A": FediACConfig(vote_mode="threshold", compact_mode="block",
                              vote_wire="packed", engine=spec),
            "B": FediACConfig(vote_wire="packed", engine=spec)}


def _counters() -> dict:
    from repro_torch.kernels import (bitpack, gather_quant, stoch_quant,
                                     vote_pack, vote_popcount)
    return {"gather_quant": gather_quant.gather_quant,
            "stoch_quant": stoch_quant.stoch_quant,
            "vote_pack": vote_pack.vote_pack, "pack": bitpack.pack,
            "unpack": bitpack.unpack,
            "popcount_accum": vote_popcount.popcount_accum}


def _rank_update(rank: int, d: int):
    """This rank's row of a seeded [AR_RANKS, d] normal**3 update."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(d)
    return torch.randn(AR_RANKS, d, device=DEV, generator=gen)[rank] ** 3


def _ar_round_gates(cfg, u, res, out, n, group_max):
    """Gates of one allreduce round on this rank; returns the measured
    numbers (the parent checks them across ranks)."""
    import torch
    import torch.distributed as dist
    mean, new_res, counts = out
    d = u.shape[0]
    rank0 = mean.clone()
    dist.broadcast(rank0, 0)
    left = (u + res - new_res).to(torch.float32)
    dist.all_reduce(left)
    err = float((left / n - mean).abs().max())
    k = cfg.k(d)
    return {"finite": bool(torch.isfinite(mean).all()
                           and torch.isfinite(new_res).all()),
            "shapes": [list(mean.shape), list(new_res.shape),
                       list(counts.shape)],
            "same_mean_as_rank0": same_bits(mean, rank0),
            "conservation_err": err,
            # each rank's u + res - new_res carries its own rounding of
            # q/f at up to |u + res|; eight ulps of the largest covers it
            "conservation_tol": 8 * 2.0**-23 * group_max,
            "counts_sum": int(counts.sum()), "n_k": n * k}


def allreduce_rank(rank: int, world: int) -> dict:
    """One client of the allreduce path (runs in a spawned rank)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import collectives, fediac, prng
    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    cfgs = _ar_configs()
    u = _rank_update(rank, AR_D)
    key0 = prng.PRNGKey(0, device=DEV)
    report = {"rank": rank, "launches": {}, "round_deltas": {}, "gates": {}}

    # -- main path: AR_ROUNDS rounds per config, residuals carried, the
    # launch counts zeroed just before and read just after
    for name, cfg in cfgs.items():
        for c in counters.values():
            c.launches = 0
        res = torch.zeros_like(u)
        deltas, gates = [], []
        for t in range(AR_ROUNDS):
            before = {k: c.launches for k, c in counters.items()}
            out = fediac.fediac_allreduce(u, res, prng.fold_in(key0, t), cfg,
                                          return_counts=True)
            torch.cuda.synchronize()
            deltas.append({k: c.launches - before[k]
                           for k, c in counters.items()})
            gmax = collectives.pmax_((u + res).abs().max())
            gates.append(_ar_round_gates(cfg, u, res, out, world,
                                         float(gmax)))
            res = out[1]
        report["launches"][name] = {k: c.launches for k, c in counters.items()}
        report["round_deltas"][name] = deltas
        report["gates"][name] = gates
        del res, out
    report["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # -- card vs CPU at AR_CHECK_D, both configs, two rounds each
    uc = _rank_update(rank, AR_CHECK_D)
    cpu = {}
    for name, cfg in cfgs.items():
        rg, rc = torch.zeros_like(uc), torch.zeros_like(uc).cpu()
        rounds = []
        for t in range(AR_ROUNDS):
            key = prng.fold_in(key0, t)
            mg, rg2, cg = fediac.fediac_allreduce(uc, rg, key, cfg,
                                                  return_counts=True)
            mc, rc2, cc = fediac.fediac_allreduce(uc.cpu(), rc, key.cpu(), cfg,
                                                  return_counts=True)
            rounds.append({"same_mean": same_bits(mg, mc),
                           "same_res": same_bits(rg2, rc2),
                           "counts_differ": int((cg.cpu() != cc).sum())})
            rg, rc = rg2, rc2
        cpu[name] = rounds
    report["card_vs_cpu"] = cpu

    # -- timing: each round as the slowest rank between two barriers, and
    # the wire's collectives on their own
    times = {}
    zero = torch.zeros_like(u)
    for name, cfg in cfgs.items():
        times[name] = []
        for t in range(AR_TIME_ITERS):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fediac.fediac_allreduce(u, zero, prng.fold_in(key0, t), cfg)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            dist.barrier()
    from repro_torch.kernels.ref import LANES, wire_groups
    words = torch.zeros(wire_groups(AR_D) * LANES, dtype=torch.int32,
                        device=DEV)
    buf = torch.zeros(cfgs["B"].capacity(AR_D), dtype=torch.int32, device=DEV)
    scalar = torch.zeros((), device=DEV)
    for what, fn in (("all_gather_words", lambda: collectives.all_gather(words)),
                     ("psum_phase2", lambda: collectives.psum_(buf)),
                     ("pmax_scalar", lambda: collectives.pmax_(scalar))):
        times[what] = []
        for _ in range(AR_TIME_ITERS):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[what].append((time.perf_counter() - t0) * 1e3)
    report["times_ms"] = times
    return report


def phase_allreduce() -> dict:
    """Spawn the AR_RANKS ranks once, run the allreduce path in them, and
    hold every rank to the gates."""
    from repro_torch import testing
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        reports = testing.run_ranks(allreduce_rank, AR_RANKS,
                                    f"file://{store}/store", timeout=900)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    wall = time.perf_counter() - t0
    cfgs = _ar_configs()
    launches = {k: 0 for k in _counters()}
    for rep in reports:
        r = rep["rank"]
        for name, cfg in cfgs.items():
            on_path = AR_PATH_KERNELS[name]
            for t, delta in enumerate(rep["round_deltas"][name]):
                want = {k: (1 if k in on_path else 0) for k in delta}
                check(delta == want, f"rank {r} config {name} round {t}: "
                      f"launches rose by {delta}, not {want}")
            for k, v in rep["launches"][name].items():
                launches[k] += v
            for t, g in enumerate(rep["gates"][name]):
                where = f"rank {r} config {name} round {t}"
                check(g["finite"], f"{where}: non-finite mean or residual")
                check(g["shapes"] == [[AR_D], [AR_D], [AR_D]],
                      f"{where}: shapes {g['shapes']}")
                check(g["same_mean_as_rank0"], f"{where}: mean differs from "
                      "rank 0's")
                check(g["conservation_err"] <= g["conservation_tol"],
                      f"{where}: mean vs averaged u + res - new_res differ by "
                      f"{g['conservation_err']} > {g['conservation_tol']}")
                if name == "B":
                    check(g["counts_sum"] == g["n_k"], f"{where}: counts sum "
                          f"{g['counts_sum']} != N*k {g['n_k']}")
            for t, c in enumerate(rep["card_vs_cpu"][name]):
                where = f"rank {r} config {name} round {t} at d={AR_CHECK_D}"
                check(c["same_mean"] and c["same_res"],
                      f"{where}: card and CPU means/residuals differ")
                check(c["counts_differ"] <= 1e-4 * AR_CHECK_D,
                      f"{where}: {c['counts_differ']} vote counts differ")
    slowest = {what: [max(rep["times_ms"][what][i] for rep in reports)
                      for i in range(AR_TIME_ITERS)]
               for what in reports[0]["times_ms"]}
    out = {"ranks": AR_RANKS, "d": AR_D, "wall_s": wall, "launches": launches,
           "round_ms": {f"config_{k}": sorted(slowest[k])[AR_TIME_ITERS // 2]
                        for k in cfgs},
           "round_ms_all": {k: slowest[k] for k in cfgs},
           "gloo_ms": {k: sorted(v)[AR_TIME_ITERS // 2]
                       for k, v in slowest.items() if k not in cfgs},
           "peak_mem_gib_per_rank": max(rep["peak_mem_gib"] for rep in reports),
           "counts_differ_card_vs_cpu": max(
               c["counts_differ"] for rep in reports
               for rounds in rep["card_vs_cpu"].values() for c in rounds),
           "conservation_err_max": max(
               g["conservation_err"] for rep in reports
               for gs in rep["gates"].values() for g in gs)}
    log(f"[allreduce] {AR_RANKS} ranks, d={AR_D}: every gate held; "
        f"launches {launches}; round ms {out['round_ms']}; peak "
        f"{out['peak_mem_gib_per_rank']:.2f} GiB per rank; card == CPU "
        f"bitwise at d={AR_CHECK_D} ({wall:.1f} s)")
    # gloo stages CUDA tensors through host memory: these are times of the
    # host path, not of the card
    log(f"[gloo] slowest rank, median of {AR_TIME_ITERS}, ms: "
        f"{out['gloo_ms']}")
    return out


def phase_wire_timing() -> dict:
    """Each wire kernel, its plain version and its bound at the allreduce
    path's shapes (d = AR_D, N = AR_RANKS)."""
    import torch
    from repro_torch.kernels import bitpack, vote_pack, vote_popcount
    from repro_torch.kernels.ref import LANES, wire_groups
    d, n = AR_D, AR_RANKS
    w = wire_groups(d) * LANES
    mask, scores = _wire_inputs(d, seed=5)
    scores = torch.nan_to_num(scores)
    tau = torch.quantile(scores[:1 << 24], 0.95).reshape(())
    words = bitpack.pack(mask)
    stack = _words(n, d, seed=6)
    cases = {
        # name: (kernel call, plain call, bytes, operations)
        "vote_pack": (lambda: vote_pack.vote_pack(scores, tau),
                      lambda: vote_pack.vote_pack_plain(scores, tau),
                      4 * d + 4 * w + 4, 2 * d),
        "pack": (lambda: bitpack.pack(mask), lambda: bitpack.pack_plain(mask),
                 d + 4 * w, 2 * d),
        "unpack": (lambda: bitpack.unpack(words, d),
                   lambda: bitpack.unpack_plain(words, d), 4 * w + d, 2 * d),
        "popcount_accum": (
            lambda: vote_popcount.popcount_accum(stack, d),
            lambda: vote_popcount.popcount_accum_plain(stack, d),
            4 * n * w + 4 * d, 64 * n * w),
    }
    out = {name: time_kernel(fn, plain, nbytes, ops,
                             [n, d] if name == "popcount_accum" else [d])
           for name, (fn, plain, nbytes, ops) in cases.items()}
    log("[wire timing] " + json.dumps(out))
    return out


def phase_timing(u_stack, key) -> dict:
    import torch
    from repro_torch.core import fediac, prng, selection, voting
    from repro_torch.kernels.gather_quant import gather_quant, gather_quant_plain
    from repro_torch.kernels.stoch_quant import stoch_quant, stoch_quant_plain
    from repro_torch.training.fl_loop import run_federated
    out = {}
    n, d = N_CLIENTS, D
    u, uni, sel, f = _stack_gather_inputs(n, d, seed=2)
    # gather_quant at each path's shape: u, uni in; q, res out (16 B per
    # element); sel; f.  Operations: mul floor sub cmp add div sub select
    for name, (gu, guni, gsel, gf) in (
            ("gather_quant", (u, uni, sel, f)),
            ("gather_quant_allreduce", _ar_gather_inputs()),
            ("gather_quant_fl", _stack_gather_inputs(*FL_SHAPE, seed=5))):
        rows, cols = gu.shape
        out[name] = time_kernel(
            lambda: gather_quant(gu, guni, gsel, gf),
            lambda: gather_quant_plain(gu, guni, gsel, gf),
            16 * rows * cols + cols + 4, 8 * rows * cols, [rows, cols])
    cols = 4 * round(0.05 * d / 4)
    a, b = u[:, :cols].contiguous(), uni[:, :cols].contiguous()
    out["stoch_quant"] = time_kernel(
        lambda: stoch_quant(a, b, f), lambda: stoch_quant_plain(a, b, f),
        12 * n * cols + 4, 5 * n * cols, [n, cols])
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
    parity_err.update(phase_wire_parity())
    gen = torch.Generator(device=DEV).manual_seed(0)
    scale = torch.empty(D, device=DEV).exponential_(generator=gen)
    u_stack = torch.randn(N_CLIENTS, D, device=DEV, generator=gen) * scale
    key = prng.PRNGKey(0, device=DEV)
    main_path = phase_main_path(u_stack, key)
    report = phase_checks(u_stack, key, main_path)
    allreduce = phase_allreduce()
    timing = phase_timing(u_stack, key)
    timing.update(phase_wire_timing())

    quant_src = "src/repro_torch/kernels/csrc/quant.cu"
    votes_src = "src/repro_torch/kernels/csrc/votes.cu"
    kernels = []
    for name, src, replaces in (
            ("gather_quant", quant_src, "src/repro/kernels/gather_quant.py:37"),
            ("stoch_quant", quant_src, "src/repro/kernels/stoch_quant.py:26"),
            ("vote_pack", votes_src, "src/repro/kernels/vote_pack.py:30"),
            ("pack", votes_src, "src/repro/kernels/bitpack.py:29"),
            ("unpack", votes_src, "src/repro/kernels/bitpack.py:36"),
            ("popcount_accum", votes_src,
             "src/repro/kernels/vote_popcount.py:34")):
        t = timing[name]
        # launches on the paths this script drives: the stacked round and
        # FL loop (counted in this process) plus the allreduce (summed over
        # its ranks); unpack is on no path (no round calls it)
        launches = (main_path["launches"].get(name, 0)
                    + allreduce["launches"][name])
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches,
                 "on_path": name != "unpack",
                 "max_abs_err": parity_err[name], "bitwise": True,
                 **{k: t[k] for k in ("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by")},
                 "library_ms": None, "shape": t["shape"]}
        if name == "gather_quant":
            # the stacked rounds launch it at [N_CLIENTS, D]; the FL loop
            # and the allreduce's topk config at shapes of their own
            fl = launches - main_path["round_launches"] \
                - allreduce["launches"][name]
            entry["launches_at_shape"] = main_path["round_launches"]
            entry["also_at"] = [
                {"launches": n_at, **{k: timing[key][k] for k in (
                    "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by")}}
                for key, n_at in (("gather_quant_allreduce",
                                   allreduce["launches"][name]),
                                  ("gather_quant_fl", fl))]
        kernels.append(entry)
    timed = ("gather_quant", "gather_quant_allreduce", "gather_quant_fl",
             "stoch_quant", "vote_pack", "pack", "unpack", "popcount_accum")
    summary = {"build_s": build_s, "total_s": time.perf_counter() - t_start,
               **report, "allreduce": allreduce,
               **{k: v for k, v in timing.items() if k not in timed}}
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
