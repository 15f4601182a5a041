#!/usr/bin/env python3
"""Drive the PyTorch port of FediAC on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. card: name and power limit, as ``nvidia-smi`` reports them;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``quant.cu``, ``votes.cu`` and ``attention.cu``, one ``nvcc`` each, in
   parallel);
3. kernel parity: each kernel against its plain-torch version on the card,
   at the main paths' shapes and at ragged / edge cases: bitwise for the
   six FediAC kernels; for B6 ``flash_attention`` within a tolerance
   (float32 3e-5, bfloat16 2e-2), since its sums run in another order;
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
   CUDA graph of back-to-back calls;
8. serve path: Qwen3-0.6B at full width and depth (28 layers, random
   weights from ``PRNGKey(0)``) prefills 2 requests of 32,768 tokens
   through ``make_serve_step`` (the counts zeroed just before; B6 must
   launch once per layer), its logits finite; B6 against its plain version
   (within one bfloat16 ulp of the output plus 2e-3) and against the
   model's plain ``_blockwise_attention`` (2e-2) at layer 0's q, k, v;
   the 2-layer model at S = 4,096 on the card against the CPU;
   ``ServingEngine`` answering 4 requests on 2 slots, each request's
   tokens equal to its own greedy decode (float32); a bfloat16 engine of
   16 slots with a 32,768-token cache (``DECODE_32K``'s cache, its batch
   cut) answering 16 requests, timed and profiled; then the prefill and B6
   (with SDPA as the library yardstick) timed.

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
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores (data sheet)
QWEN = "qwen3_0p6b"
QWEN_PARAMS = 596_049_920
PREFILL_SEQ = 32_768             # PREFILL_32K (configs/base.py)
PREFILL_BATCH = 2                # of PREFILL_32K's 32 (PERF.md section 4)
CHECK_LAYERS, CHECK_SEQ = 2, 4_096   # card vs CPU prefill
DECODE_REQUESTS = ((16, 8), (48, 8), (32, 8), (24, 8))   # (prompt, max_new)
DECODE_SLOTS, DECODE_CACHE = 2, 128      # the float32 token check
#: the timed bfloat16 engine: DECODE_32K (configs/base.py: cache 32,768,
#: batch 128) with its batch cut to 16 slots, 56 GiB of KV cache, so that
#: it fits the card (PERF.md section 4); one request per slot
TIMED_SLOTS, TIMED_CACHE = 16, 32_768
PROFILE_TICKS = 6                # engine ticks per profiled window
#: B6 parity shapes: (b, s, t, h, hk, d, dv, causal, window), as the card
#: tests of tests/test_torch_cuda.py
FLASH_CASES = ((1, 1024, 1024, 4, 2, 64, 64, True, 0),
               (1, 1024, 1024, 4, 2, 64, 64, True, 256),
               (2, 512, 512, 8, 8, 32, 32, True, 0),
               (1, 512, 512, 4, 1, 128, 128, True, 256),
               (1, 1000, 1000, 4, 2, 64, 64, True, 100),
               (1, 384, 384, 4, 4, 192, 128, True, 0),
               (1, 300, 700, 4, 2, 256, 256, False, 64))
#: B6 is held to a tolerance, not bitwise: float32 3e-5 (the reference
#: test's), bfloat16 2e-2 (test_flash_bf16's), as |a - b| <= tol + tol |b|
FLASH_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
#: B6 against its plain version at the 32k layer, as |a - b| <= abs + rel |b|:
#: both sum in float32 and round the output to bfloat16 once, so they may
#: differ by one bfloat16 ulp of the output (at most 2^-7 |b|) plus float32
#: noise; the absolute 2e-3 is twice the largest error read on this layer
#: (9.8e-4), and far below a typical output there (PERF.md section 6)
LAYER_TOL = (2e-3, 2.0 ** -7)
#: card (B6) vs CPU (plain) prefill at 2 layers, float32, relative to the
#: largest logit: about 3x the reading of every run so far (3.0e-6)
CHECK_TOL = 1e-5


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
    from repro_torch.kernels import (bitpack, flash_attention, gather_quant,
                                     stoch_quant, vote_pack, vote_popcount)
    return {"gather_quant": gather_quant.gather_quant,
            "stoch_quant": stoch_quant.stoch_quant,
            "vote_pack": vote_pack.vote_pack, "pack": bitpack.pack,
            "unpack": bitpack.unpack,
            "popcount_accum": vote_popcount.popcount_accum,
            "flash_attention": flash_attention.flash_attention}


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


# ---------------------------------------------------------------------------
# The serve path: Qwen3-0.6B prefill at 32k (B6) and the decode engine
# ---------------------------------------------------------------------------

def flash_close(got, want, tol=None) -> tuple[bool, float]:
    """|got - want| <= abs + rel |want| on f32-converted values, ``tol`` an
    (abs, rel) pair (B6's tolerance for the dtype unless given), and the max
    abs error."""
    if tol is None:
        tol = (FLASH_TOL[str(want.dtype).removeprefix("torch.")],) * 2
    a, b = got.float(), want.float()
    err = (a - b).abs()
    return bool((err <= tol[0] + tol[1] * b.abs()).all()), float(err.max())


def phase_flash_parity() -> dict:
    """B6 against its plain version on the card at the card tests' shapes,
    float32 and bfloat16."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    errs = {}
    for b, s, t, h, hk, d, dv, causal, window in FLASH_CASES:
        gen = torch.Generator(device=DEV).manual_seed(s + t + d + window)
        q32 = torch.randn(b, s, h, d, device=DEV, generator=gen)
        k32 = torch.randn(b, t, hk, d, device=DEV, generator=gen)
        v32 = torch.randn(b, t, hk, dv, device=DEV, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ok, err = flash_close(got, want)
            check(ok and got.dtype == dt, f"flash_attention != plain at "
                  f"{(b, s, t, h, hk, d, dv, causal, window)} {dt}: {err}")
            key = str(dt).removeprefix("torch.")
            errs[key] = max(errs.get(key, 0.0), err)
    log(f"[flash parity] {len(FLASH_CASES)} shapes x 2 dtypes within "
        f"{FLASH_TOL}; max errors {errs}")
    return errs


def _prompts(vocab: int, n: int = len(DECODE_REQUESTS)) -> list:
    """``n`` random prompts, their lengths and max_new from DECODE_REQUESTS
    in turn."""
    import numpy as np
    rng = np.random.default_rng(0)
    reqs = [DECODE_REQUESTS[i % len(DECODE_REQUESTS)] for i in range(n)]
    return [(rng.integers(0, vocab, p).tolist(), m) for p, m in reqs]


def _engine_run(eng, prompts) -> tuple[list, int, float]:
    """``eng`` serving ``prompts`` until every one is answered: (requests,
    ticks, seconds)."""
    import torch
    from repro_torch.serving import Request
    reqs = [Request(uid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks, logits = 0, None
    while any(sl is not None for sl in eng.slots) or eng.queue:
        logits = eng.step(logits)
        ticks += 1
    torch.cuda.synchronize()
    return reqs, ticks, time.perf_counter() - t0


def _greedy(cfg, params, prompt, max_new) -> list:
    """One request's own greedy decode at batch 1 on the card."""
    import numpy as np
    from repro_torch.configs import InputShape
    from repro_torch.models import init_caches
    from repro_torch.training.serve import make_serve_step
    bundle = make_serve_step(cfg, InputShape("decode", DECODE_CACHE, 1,
                                             "decode"))
    caches = init_caches(cfg, 1, bundle.cache_len)
    out, logits = [], None
    for pos, tok in enumerate(prompt + [None] * max_new):
        if tok is None:
            out.append(int(np.argmax(logits[0, -1].float().cpu().numpy())))
            if len(out) == max_new:
                break
            tok = out[-1]
        logits, caches = bundle.step(params, caches, [[tok]], pos)
    return out


def phase_serve() -> dict:
    """The serve path's main run (the 32k prefill through B6), its checks,
    the card-vs-CPU prefill, the decode engine, and their times."""
    import copy
    import gc

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import InputShape, get
    from repro_torch.core import prng
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn, init_params, param_count
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.training.serve import make_serve_step
    out = {}
    cfg = get(QWEN)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, prng.PRNGKey(0, device=DEV))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    check(param_count(params) == QWEN_PARAMS,
          f"{QWEN} has {param_count(params)} parameters, not {QWEN_PARAMS}")
    shape = InputShape("prefill_32k", PREFILL_SEQ, PREFILL_BATCH, "prefill")
    bundle = make_serve_step(cfg, shape)
    gen = torch.Generator(device=DEV).manual_seed(13)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ),
                           device=DEV, generator=gen)

    # -- main path: one prefill, counts zeroed just before and read just
    # after; layer 0's q, k, v are kept as the kernel receives them
    captured = []
    real = attn.flash_attention

    def capture(q, k, v, **kw):
        if not captured:
            captured.append((q, k, v, kw))
        return real(q, k, v, **kw)

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    attn.flash_attention = capture
    try:
        t0 = time.perf_counter()
        logits = bundle.step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        out["prefill_first_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        attn.flash_attention = real
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: (cfg.n_layers if k == "flash_attention" else 0)
            for k in launches}
    check(launches == want, f"prefill launches {launches}, not {want}")
    check(logits.shape == (PREFILL_BATCH, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"prefill logits {tuple(logits.shape)} not finite / shaped")
    out["launches"] = launches["flash_attention"]
    out["prefill_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["next_tokens"] = logits.float().argmax(-1).tolist()
    log(f"[serve] {QWEN} prefill {PREFILL_BATCH} x {PREFILL_SEQ}: B6 launched "
        f"{out['launches']} times; next tokens {out['next_tokens']} "
        f"({out['prefill_first_ms']:.0f} ms)")

    # -- B6 at layer 0's operands: against its plain version and against
    # the model's own plain path (which casts p to bf16 before p.v)
    q, k, v, kw = captured[0]
    check(q.shape == (PREFILL_BATCH, PREFILL_SEQ, cfg.n_heads, cfg.head_dim)
          and k.shape == (PREFILL_BATCH, PREFILL_SEQ, cfg.n_kv_heads,
                          cfg.head_dim) and q.dtype == torch.bfloat16,
          f"layer 0 operands {tuple(q.shape)} {tuple(k.shape)} {q.dtype}")
    got = fa.flash_attention(q, k, v, **kw)
    plain = fa.flash_attention_plain(q, k, v, **kw).float()
    ok, out["layer_err_vs_plain"] = flash_close(got, plain, LAYER_TOL)
    out["layer_rms_plain"] = float(plain.square().mean().sqrt())
    out["layer_rms_err_vs_plain"] = float(
        (got.float() - plain).square().mean().sqrt())
    del plain
    check(ok, f"B6 != plain at layer 0: {out['layer_err_vs_plain']} "
          f"(tolerance {LAYER_TOL})")
    pos = torch.arange(PREFILL_SEQ, device=DEV)
    model_plain = attn._blockwise_attention(
        q, k, v, pos, pos, True, 0, 1.0 / math.sqrt(cfg.head_dim),
        cfg.attn_q_block, cfg.attn_kv_block)
    ok, out["layer_err_vs_blockwise"] = flash_close(got, model_plain)
    check(ok, f"B6 != the model's plain blockwise path at layer 0: "
          f"{out['layer_err_vs_blockwise']}")
    del got, model_plain
    log(f"[serve] B6 at layer 0 vs plain {out['layer_err_vs_plain']:.3g} "
        f"(rms {out['layer_rms_err_vs_plain']:.3g}; the plain output's rms "
        f"{out['layer_rms_plain']:.3g}), vs the model's blockwise path "
        f"{out['layer_err_vs_blockwise']:.3g}")

    # -- card vs CPU at full width: 2 layers, S = CHECK_SEQ, float32
    cfg2 = cfg.with_(n_layers=CHECK_LAYERS, compute_dtype="float32")
    p2 = init_params(cfg2, prng.PRNGKey(0, device=DEV))
    p2_cpu = copy.deepcopy(p2).cpu()
    shape2 = InputShape("prefill_check", CHECK_SEQ, 1, "prefill")
    toks2 = tokens[:1, :CHECK_SEQ]
    before = fa.flash_attention.launches
    lg = make_serve_step(cfg2, shape2).step(p2, {"tokens": toks2})
    torch.cuda.synchronize()
    check(fa.flash_attention.launches - before == CHECK_LAYERS,
          "the card check prefill did not launch B6 once per layer")
    t0 = time.perf_counter()
    lc = make_serve_step(cfg2, shape2, device="cpu").step(
        p2_cpu, {"tokens": toks2.cpu()})
    out["check_cpu_s"] = time.perf_counter() - t0
    rel = float((lg.cpu() - lc).abs().max() / lc.abs().max())
    same_argmax = bool(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)))
    out["check_rel_err"], out["check_same_argmax"] = rel, same_argmax
    # RoPE's cos/sin and the matmuls differ by ulps between the devices;
    # a wrong kernel moves the logits by far more
    check(rel <= CHECK_TOL and same_argmax,
          f"card vs CPU prefill: rel err {rel}, same argmax {same_argmax}")
    log(f"[serve] card vs CPU, {CHECK_LAYERS} layers, S={CHECK_SEQ}, f32: rel "
        f"err {rel:.3g}, same argmax ({out['check_cpu_s']:.1f} s on the CPU)")
    del p2, p2_cpu

    # -- decode engine at full width, float32: every request answered and
    # equal to its own greedy decode
    cfg32 = cfg.with_(compute_dtype="float32")
    prompts = _prompts(cfg.vocab)
    eng = ServingEngine(cfg32, params, max_batch=DECODE_SLOTS,
                        cache_len=DECODE_CACHE)
    reqs, ticks, secs = _engine_run(eng, prompts)
    for r, (p, m) in zip(reqs, prompts):
        check(len(r.out) == m, f"request {r.uid} got {len(r.out)} of {m}")
        alone = _greedy(cfg32, params, p, m)
        check(r.out == alone, f"request {r.uid}: engine {r.out} != its own "
              f"greedy decode {alone}")
    out["decode_f32_tick_ms"] = secs * 1e3 / ticks
    log(f"[serve] engine f32: {len(reqs)} requests on {DECODE_SLOTS} slots, "
        f"{ticks} ticks, tokens equal to independent decode")

    # -- the bf16 engine timed at DECODE_32K's cache length on TIMED_SLOTS
    # slots, one request each.  decode_attention reads every cache row,
    # filled or not, so a tick costs what it costs on a full cache; a
    # decode step with every slot at the cache's last position shows it.
    # An engine is freed by the cycle collector (its admission queue holds
    # its bound ``_reset_slot``)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prompts = _prompts(cfg.vocab, TIMED_SLOTS)
    eng = ServingEngine(cfg, params, max_batch=TIMED_SLOTS,
                        cache_len=TIMED_CACHE)
    reqs, ticks, secs = _engine_run(eng, prompts)
    check(all(len(r.out) == m for r, (_, m) in zip(reqs, prompts)),
          "bf16 engine left a request unanswered")
    out["decode_ticks"] = ticks
    out["decode_bf16_tick_ms"] = secs * 1e3 / ticks
    # where a tick's device time goes, and how long the device sits idle:
    # PROFILE_TICKS ticks of the same engine serving the prompts again,
    # past their first ticks
    for i, (p, m) in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new=m))
    last = [None]

    def some_ticks():
        for _ in range(PROFILE_TICKS):
            last[0] = eng.step(last[0])

    some_ticks()
    rows = device_profile(some_ticks, iters=1)
    busy = sum(r[1] for r in rows) / PROFILE_TICKS
    out["decode_bf16_device_ms_per_tick"] = busy
    out["decode_bf16_launches_per_tick"] = sum(r[2] for r in rows) / PROFILE_TICKS
    out["decode_bf16_idle_share"] = 1.0 - busy / out["decode_bf16_tick_ms"]
    out["decode_bf16_top_kernels"] = [(n[:60], ms / PROFILE_TICKS,
                                       c / PROFILE_TICKS)
                                      for n, ms, c in rows[:5]]
    full_step = make_serve_step(cfg, InputShape(
        "decode_32k", TIMED_CACHE, TIMED_SLOTS, "decode")).step
    toks = torch.zeros(TIMED_SLOTS, 1, dtype=torch.int64, device=DEV)
    full = torch.full((TIMED_SLOTS,), TIMED_CACHE - 1, device=DEV)
    out["decode_bf16_full_cache_step_ms"] = cuda_ms(
        lambda: full_step(params, eng.caches, toks, full), iters=3, warmup=1)
    out["decode_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] engine bf16: {len(reqs)} requests on {TIMED_SLOTS} slots, "
        f"cache {TIMED_CACHE}: {out['decode_bf16_tick_ms']:.1f} ms per tick, "
        f"{out['decode_bf16_full_cache_step_ms']:.1f} ms per step on a full "
        f"cache")
    del eng, last
    gc.collect()
    torch.cuda.empty_cache()

    # -- times: the prefill, B6 at layer 0's shape, SDPA as the yardstick
    t0 = time.perf_counter()
    bundle.step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["prefill_tokens_per_s"] = PREFILL_BATCH * PREFILL_SEQ / out["prefill_ms"] * 1e3
    rows = device_profile(lambda: bundle.step(params, {"tokens": tokens}),
                          iters=1)
    busy = sum(r[1] for r in rows)
    out["prefill_device_ms"] = busy
    out["prefill_launches"] = sum(r[2] for r in rows)
    out["prefill_idle_share"] = 1.0 - busy / out["prefill_ms"]
    out["prefill_top_kernels"] = [(n[:60], ms, c) for n, ms, c in rows[:5]]
    # causal, S = T, no window: S (S + 1) / 2 visible (q, k) pairs per
    # (batch, head), 2 D + 2 Dv FLOPs each
    fl = PREFILL_BATCH * cfg.n_heads * PREFILL_SEQ * (PREFILL_SEQ + 1) // 2 \
        * 2 * (q.shape[-1] + v.shape[-1])
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = fl / BF16_OPS_PER_S * 1e3
    b6 = dict(ms=cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), iters=3,
                         warmup=1),
              device_ms=graph_ms(lambda: fa.flash_attention(q, k, v, **kw),
                                 launches=3, replays=1),
              plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                               iters=1, warmup=1),
              bound_ms=max(t_bytes, t_ops),
              bound_by="operations" if t_ops >= t_bytes else "bytes",
              bound_f32_simt_ms=fl / FP32_OPS_PER_S * 1e3, flops=fl,
              bytes=nbytes, shape=[PREFILL_BATCH, PREFILL_SEQ, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim,
                                   cfg.head_dim])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b6["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=10)
    out["b6"] = b6
    out["b6_share_of_prefill"] = b6["device_ms"] * cfg.n_layers / out["prefill_ms"]
    log("[serve timing] " + json.dumps(out))
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
    flash_err = phase_flash_parity()
    gen = torch.Generator(device=DEV).manual_seed(0)
    scale = torch.empty(D, device=DEV).exponential_(generator=gen)
    u_stack = torch.randn(N_CLIENTS, D, device=DEV, generator=gen) * scale
    key = prng.PRNGKey(0, device=DEV)
    main_path = phase_main_path(u_stack, key)
    report = phase_checks(u_stack, key, main_path)
    allreduce = phase_allreduce()
    timing = phase_timing(u_stack, key)
    timing.update(phase_wire_timing())
    serve = phase_serve()

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
    b6 = serve["b6"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        # the 32k prefill's launches, one per layer
        "launches": serve["launches"], "on_path": True,
        "max_abs_err": serve["layer_err_vs_plain"], "bitwise": False,
        "tolerance": {"abs": LAYER_TOL[0], "rel": LAYER_TOL[1]},
        "max_abs_err_small_shapes": flash_err,
        "tolerance_small_shapes": FLASH_TOL,
        **{k: b6[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                              "bound_by", "bound_f32_simt_ms", "library_ms",
                              "shape")}})
    serve = {k: v for k, v in serve.items() if k != "b6"}
    timed = ("gather_quant", "gather_quant_allreduce", "gather_quant_fl",
             "stoch_quant", "vote_pack", "pack", "unpack", "popcount_accum")
    summary = {"build_s": build_s, "total_s": time.perf_counter() - t_start,
               **report, "allreduce": allreduce, "serve": serve,
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
