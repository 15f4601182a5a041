#!/usr/bin/env python3
"""Drive the PyTorch port of FediAC on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. card: name and power limit, as ``nvidia-smi`` reports them;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``quant.cu``, ``votes.cu``, ``attention.cu`` and ``attention_bwd.cu``,
   one ``nvcc`` each, all started together); the FediAC phases wait for
   the first two only, and the attention libraries go on compiling beside
   them until the stream path has run; then count the HGMMA (tensor-core)
   instructions in B6's SASS (``cuobjdump``), which must be more than 0,
   and read the registers and spills of B6's float32 instances and of its
   backward's (none may spill);
3. kernel parity: each kernel against its plain-torch version on the card,
   at the main paths' shapes and at ragged / edge cases: bitwise for the
   six FediAC kernels; for B6 ``flash_attention`` (after the stream
   path, once its library is built) within a tolerance (float32 3e-5,
   bfloat16 2e-2), since its sums run in another order;
4. main path: two FediAC rounds at d = 1,000,000 and N = 32 (the largest
   monolithic cell of ``benchmarks/aggregation_round.py``), vote_chunk 1
   and 4, with the fused kernels on, then 3 rounds of the FL loop at its
   default configuration; the kernel launch counts are zeroed just before
   and read just after;
5. checks: the rounds' outputs against the same computation on the CPU
   (plain versions) from the card's vote counts, bitwise, and the vote
   counts of a whole CPU round against the card's; the FL loop against
   its CPU run (the rounds' CPU side beside the card's later phases);
6. comparison path (the paper's Sec. V): the five baselines through
   ``make_aggregator`` at N = 32, d = 1,000,000 (libra two rounds), FediAC
   with the trim and median closes at vote_chunk 1 and 4, the FL loop for
   each of the six aggregators, and fediac and libra killed at round 2
   and resumed, with the launch counts zeroed just before and read just
   after; then each against the CPU: the baselines and the closes
   bitwise, every FL round's aggregate replayed bitwise, the FL runs
   within their gates and in the paper's traffic order, the resumed runs
   bit-identical; then each round's time;
7. stream path (``core/stream_engine.py``, B1 once per chunk): the stream
   engine at N = 32, d = 1,000,000 with the default chunk and a chunk of
   100,003, for top-k with the sum, trim and median closes and for
   threshold/block, each bitwise against the monolithic round; the FL
   loop on ``EngineSpec("stream", chunk=4096)``, its history bitwise the
   monolithic run's; stream against monolithic at N = 8, d = 10,000,000
   (bitwise, both peaks printed, the monolithic one reckoned at 1e8); the
   scale cell, N = 8, d = 100,007,936 (the reference's d ~ 1e8), timed
   (median of 3), profiled, its peak memory with and without ``out=``,
   its counts, finiteness and conservation checked, ``out=u_stack`` in
   place and bitwise; the B1 count zeroed just before each run and read
   just after, and tallied by operand shape (one launch per chunk); B1 on
   the strided column views of each stack at every chunk and tail shape
   these runs launch it at, and at views 1-3 columns off a 16-byte
   boundary with an odd width, one row, and with the residual written into
   the view itself (``out=``), bitwise against its plain version; then B1
   at the chunk shape [8, 262,144], contiguous and on the strided chunk as
   the engine hands it over, the residual returned fresh and written into
   the residual stack (``out=``);
8. shard path (``core/shard_engine.py``, every shard on the one card,
   kernels off, as the engine refuses them): at N = 8, d = 983,040 every
   vote x compact mode on 8 shards (and top-k/top-k on 3, ragged) bitwise
   against the monolithic round, ``shard_compress_stack`` in top-k and
   block mode bitwise against the stacked phase-2 compress; the
   reference's sharded cell, N = 8, d = 100,007,936 on 8 shards,
   threshold/block and top-k/top-k (the latter bitwise against the
   stream engine), each gated as the stream scale cell, timed (median of
   3), its phase 1 timed (not profiled: the top-k cell is bitwise the
   stream scale cell, profiled there), its peak above its inputs and
   outputs
   and one shard's working set; then the shard, stream and monolithic
   rounds timed at d = 9,994,240;
9. packet path (``netsim/``, the FediAC round as packet streams through
   the switches): the lossless packet round at N = 32, d = 1,000,000,
   kernels on, in the four vote x compact modes and at vote_chunk 4,
   each bitwise its ``aggregate_stack``; the lossy round (5% loss, half
   the clients, a quarter straggling, two leaves, a 32,768-slot bank, a
   deadline at the median lossless vote arrival) against the same round
   on the CPU, bitwise but the mean wait (1e-6); the stream engine
   (kernels on) and the sharded engine (8 shards) under that dataplane
   at N = 8, d = 9,994,240, bitwise the monolithic packet round; the
   reference's dataplane FL task (N = 10, 12 rounds) on packets:
   lossless equal to the memory transport, lossy card against CPU,
   killed at round 6 and resumed, the five baselines one round each;
   the B1 and B2 counts zeroed just before each packet run and read just
   after, tallied by shape; then the packet round beside
   ``aggregate_stack``, the timeline alone, the idle share and the
   launches per round;
10. faults path (``netsim/faults.py``, ``robust/``: the packet round
   under faults and under Byzantine attack): at N = 32, d = 1,000,000,
   kernels on, under the lossy dataplane, a zero-knob ``FaultConfig``
   bitwise the plain packet round with each register policy and a
   zero-knob ``AdversaryConfig`` bitwise that chaos round (top-k/top-k,
   threshold/block, and at vote_chunk 4); the storm (the chaos grid's
   burst-crash rates, a quorum floor, the rescale close) and the
   defended attack (the attack grid's full attack and defenses) at
   full width, their delta, residuals and counts unmoved by duplicate
   rates 0 and 0.9, then both card against CPU at d = 131,072; the storm
   on the stream (kernels on) and sharded engines at N = 8,
   d = 9,994,240, bitwise the monolithic round; the chaos and attack
   grids as FL tasks (N = 10, 10 rounds): clean cells bitwise the plain
   packet run, the reference benchmark's defense gates, two cells card
   against CPU, the defended cell killed at round 5 and resumed; the
   rounds timed beside the plain packet round, the Gilbert–Elliott
   chain's share, the idle share and launches per round; the B1 and B2
   counts zeroed just before each run and read just after, tallied by
   shape;
11. async path (``netsim/async_engine.py``: the quorum-or-deadline close,
   and ``obs/``): at N = 32, d = 1,000,000, kernels on, under the lossy
   dataplane on one switch, ``AsyncConfig`` at its defaults bitwise the
   synchronous packet round in the four vote x compact modes and at
   vote_chunk 4, and the in-memory ``"async"`` engine bitwise
   ``aggregate_stack``; the async round (quorum 0.5, poly staleness, half
   the clients straggling 16x) two rounds running, the second folding the
   first's carry, card against CPU at d = 131,072, on the stream and
   sharded engines at N = 8, d = 9,994,240 bitwise the monolithic one, and
   timed beside the synchronous round; ``benchmarks/async_throughput.py``'s
   throughput cells as FL tasks (6 clients, hidden (128, 64), 12 rounds),
   its speedup (>= 1.5) and accuracy-gap (<= 0.05) gates, the async run
   card against CPU, and a kill and resume with a partly filled carry;
   that run with a ``RecordingProbe`` bitwise the run without one, its
   trace validated and its report rendered, the probe's overhead on
   ``benchmarks/obs.py``'s smoke cell gated at 1.10, a ``profiler_trace``
   chrome trace; the B1 and B2 counts zeroed just before each run and
   read just after, tallied by shape;
12. sweep path (``sweep/``: the scenario grids through ``run_sweep``'s
   fleets, local training batched across cells, kernels on): the smoke
   grid (4 cells, 2 fleet groups) and the chaos grid (5 packet cells under
   faults) against ``sequential=True``, every history bitwise; the
   paper's Fig. 2 grid at full width (8 cells, N = 20, 40 rounds) through
   the fleets, one high-profile cell of each of its 4 fleet groups bitwise
   its own sequential run, cells per second of both paths, the fleet's idle
   share and B1 launches; one smoke-grid FediAC cell card against CPU;
   the B1 and B2 counts zeroed just before each run and read just after,
   tallied by shape;
13. allreduce path: 8 ranks on the one card over gloo (spawned once), each
   one client of ``fediac_allreduce`` at d = 12,500,992 (one device's
   slice of the reference's d ~ 1e8 sort-free scale cell) on the packed
   wire, threshold/block (``vote_pack`` + ``popcount``) and topk/topk
   (``pack`` + ``popcount`` + ``gather_quant``), two rounds each carrying
   residuals, with each rank's launch counts zeroed just before and read
   just after; gates on every rank; then both configs at d = 1,000,000 on
   the card and on the CPU, bitwise; the mesh baselines
   (``switchml_allreduce`` at 14 bits, ``topk_allreduce`` at 5%) on the
   same ranks, held to the reference's contracts and card == CPU at
   d = 1,000,000; then round and collective times; then one NCCL rank
   (world size 1) running the packed top-k allreduce and both mesh
   baselines, each bitwise against the same call on a one-rank gloo group;
14. timing: each kernel, its plain version and its memory bound at the main
   paths' shapes (``gather_quant`` at each of its shapes, the train
   path's two largest leaves included; ``vote_pack`` and ``popcount`` also
   at the train path's largest leaf), and whole rounds.  A kernel's ``ms`` is CUDA-event time per wrapper call (it
   includes the host's launch work whenever that is slower than the
   kernel); ``device_ms`` is the kernel alone, per launch of a replayed
   CUDA graph of back-to-back calls;
15. serve path: Qwen3-0.6B at full width and depth (28 layers, random
   weights from ``PRNGKey(0)``) prefills 2 requests of 32,768 tokens
   through ``make_serve_step`` (the counts zeroed just before; B6's bf16
   tensor-core instance must launch once per layer), its logits finite;
   B6 against its plain version (within one bfloat16 ulp of the output
   plus 2e-3) and against the model's plain ``_blockwise_attention``
   (2e-2) at layer 0's q, k, v; the 2-layer model at S = 4,096 in float32
   on the card (B6's float32 FFMA instance, once per layer, held to its
   plain version at layer 0) against the CPU, and the same in bfloat16
   (B6's bf16 instance) within 2e-2 of the largest logit;
   ``ServingEngine`` answering 4 requests on 2 slots, each request's
   tokens equal to its own greedy decode (float32); a bfloat16 engine of
   16 slots with a 32,768-token cache (``DECODE_32K``'s cache, its batch
   cut) answering 16 requests, timed and profiled; then the prefill and
   both B6 instances at their layers (with SDPA as the library yardstick)
   timed, the bf16 one also in TFLOP/s on the reference FLOPs;
16. zoo path (the rest of the model zoo, ``phase_zoo``): granite-moe-1b
   whole (24 layers, random weights from ``PRNGKey(0)``, its parameter
   count the reference's) prefilling 2 x 32,768 tokens through
   ``make_serve_step`` (two chunks of MoE dispatch per layer; B6's bf16
   instance once per layer), then a bf16 engine of 16 slots answering 16
   requests; DeepSeek-V2 at full width cut to 2 layers (the dense layer
   and one MoE layer of 160 routed top-6 experts and 2 shared; weights
   from a seeded generator) prefilling 32,768 tokens (B6 at D = 192,
   Dv = 128, 128 heads, once per MLA layer), then absorbed decode ticks;
   hymba-1.5b whole (B6 windowed, 25 over 5 heads, beside the SSD) and
   its ring-cache decode; mamba2-130m whole (no kernel); whisper-tiny
   whole over 2 x 1,500 synthetic frames and its engine.  For each: the
   counts zeroed just before the prefill and read just after, B6 against
   its plain version at each kind of layer it meets (``LAYER_TOL``),
   finite logits, the prefill's time, peak memory, B6 share and top
   kernels, B6 timed beside SDPA.  Then each family at 2 layers,
   S = 4,096 (DeepSeek-V2's routed experts cut to 16 for the CPU), card
   against CPU: float32 within ``CHECK_TOL`` (B6's float32 instance held
   to plain; whisper's cross-attention over 1,500 frames through it),
   bf16 within ``CHECK_TOL_BF16`` without a router, and with one the share
   of tokens whose expert set differs reported (DeepSeek-V2's bf16 check
   on the card alone); and a float32 engine whose every request's tokens
   equal its own greedy decode;
17. train path (``phase_train``, after the NCCL rank): 2 gloo ranks on the
   card, one client each, run Qwen3-0.6B's FediAC train step at full
   width and depth (random weights from ``PRNGKey(0)``; 4 x 4,096 tokens
   per client, ``TRAIN_4K``'s length, above ``DENSE_MAX_SEQ``, so every
   attention layer runs B6 forward and, through its autograd.Function,
   B6's backward (``flash_bwd_dot``, then in bf16 ``flash_bwd_dkdv_wgmma``
   and ``flash_bwd_dq_wgmma`` of ``attention_bwd.cu``); E = 4,
   ``microbatch`` 4, bf16 compute) through
   ``training.dist_step.make_train_step`` with ``granularity="tensor"``
   and the kernels on: 3 steps of the default FediACConfig (B1 once per
   leaf), then one each of the allreduce path's configs A (B3 + B5) and B
   (B4a + B5 + B1).  Gates: a finite loss; the parameters and the mean
   equal on both ranks after every step (64-bit digests of their bits);
   on the first step of each config, every leaf's mean within eight
   float32 ulps of the averaged ``u + res - new_res``; the counts zeroed
   before each step and read after rise by exactly one per leaf (13) for
   each FediAC kernel on that config's path and by 0 for the others, and
   B6's by 896 forward (28 layers x 4 microbatches x 4 local steps, twice
   under remat) and 448 backward launches per rank; every FediAC launch
   followed by its plain version on the same operands on the card,
   bitwise (left out of the times, the idle share and the peak).  Step
   time (slowest rank, median of the 3 default steps; the third profiled
   for the card's idle share) split into local update and aggregation,
   client tokens/s, peak memory per rank and the step's share of the
   bf16 peak (the dry-run's model FLOPs of the tokens it trains) are
   printed.  Before those steps the same ranks run two check steps (2
   layers, float32, E = 1; 1 x 256 tokens, the dense branch, and 1 x
   2,304 tokens with q blocks of 1,152, B6 forward and backward; their
   FediAC launches held to plain as above, the embedding's included):
   each one's loss against 2 CPU ranks' (the CPU's blockwise scan above
   ``DENSE_MAX_SEQ``) within 1e-5 relative, every update leaf within 1e-4
   of its largest |u|, and the card's aggregate replayed on the CPU
   (beside the card's steps) bitwise for every leaf but the
   155.6M-coordinate embedding.  Last, B6's backward held to autograd
   through ``flash_attention_plain`` on the card at Qwen3-0.6B's train
   layer (bf16 and float32), granite's D = 64, MLA's 192 / 128, hymba's
   window of 2,048 and whisper's 448 x 1,500 cross shape: dq, dk and dv
   within 1e-4 (f32) / 2e-2 (bf16) of each one's largest |g|, two runs
   bitwise equal, each timed beside its bound, its plain version and
   SDPA's backward.

The CPU references of the checks, the comparison (baselines and robust
closes) and the lossy packet round run in a spawned process on half the
host's cores, beside the card's phases, and their gates when it is
settled, before the train path; first of all there, Qwen3-0.6B's dry-run
(``repro_torch.launch.dryrun.run_one`` on meta tensors at
``train_4k``, ``prefill_32k`` and ``decode_32k``), whose model FLOPs give
the train and serve phases' share of the bf16 peak; so do the zoo's CPU
prefills (each
family's but DeepSeek-V2's, whose 7.3 GiB model runs them in place),
once every family's timed model has run, their gates at the zoo's end.
Each gate is the one the phase ran before, and raises as it did.

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside the repository, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
AR_RANKS = 8                     # clients of the allreduce, one rank each
AR_D = 8 * 4096 * 3052 // 8      # 12,500,992: SHARD_D / SHARD_DEVICES of
                                 # benchmarks/aggregation_round.py
AR_CHECK_D = 1_000_000           # card vs CPU allreduce width
AR_ROUNDS = 2
AR_TIME_ITERS = 3
WIRE_D = AR_D
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
               (1, 300, 700, 4, 2, 256, 256, False, 64),
               (1, 700, 300, 4, 2, 64, 64, False, 64),
               (1, 333, 333, 4, 2, 256, 256, True, 0),
               (1, 129, 191, 4, 2, 128, 128, True, 0),
               (1, 191, 129, 4, 4, 96, 96, False, 0),
               (1, 4097, 4097, 8, 1, 128, 128, True, 0),
               (1, 640, 640, 4, 2, 128, 128, True, 37),
               (1, 1100, 300, 4, 2, 128, 128, False, 100),
               # the zoo's layers: hymba (GQA 5, window 2048), MLA at
               # DeepSeek-V2's 128 heads, whisper's cross-attention
               (1, 4096, 4096, 25, 5, 64, 64, True, 2048),
               (1, 2304, 2304, 128, 128, 192, 128, True, 0),
               (1, 4096, 1500, 6, 6, 64, 64, False, 0))
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
#: the same check in bfloat16 (B6's bf16 instance): the CPU tests' bf16
#: tolerance (tests/test_torch_models.py), relative to the largest logit
CHECK_TOL_BF16 = 2e-2
#: the rest of the model zoo (phase_zoo), each at full width: DeepSeek-V2's
#: depth cut to its leading dense layer and one MoE layer, the others whole
ZOO = ("granite_moe_1b", "deepseek_v2_236b", "hymba_1p5b", "mamba2_130m",
       "whisper_tiny")
ZOO_DEEPSEEK, ZOO_DEEPSEEK_LAYERS = "deepseek_v2_236b", 2
#: the reference's parameter counts (jax.eval_shape of its init_params),
#: DeepSeek-V2's at 2 layers
ZOO_PARAMS = {"granite_moe_1b": 1_334_628_352, "deepseek_v2_236b": 5_358_679_040,
              "hymba_1p5b": 1_594_957_344, "mamba2_130m": 128_940_480,
              "whisper_tiny": 41_158_272}
#: (batch, sequence) of each timed prefill: PREFILL_32K's sequence at
#: batch 2 for granite (65,536 tokens: two MoE chunks), batch 1 for the
#: larger layers; whisper's decoder at its 448-token bound over 1,500 frames
ZOO_PREFILL = {"granite_moe_1b": (2, PREFILL_SEQ),
               "deepseek_v2_236b": (1, PREFILL_SEQ),
               "hymba_1p5b": (1, PREFILL_SEQ), "mamba2_130m": (1, PREFILL_SEQ),
               "whisper_tiny": (2, 448)}
#: B6 launches per timed prefill: one per attention layer above
#: DENSE_MAX_SEQ (whisper's 448 decoder tokens and 1,500 frames stay dense)
ZOO_B6_LAUNCHES = {"granite_moe_1b": 24, "deepseek_v2_236b": 2,
                   "hymba_1p5b": 32, "mamba2_130m": 0, "whisper_tiny": 0}
#: (slots, cache) of the timed engine where a family's decode runs through
#: one; the others step the decode at DECODE_32K's cache ZOO_DECODE_TICKS
#: times (DeepSeek absorbed, hymba on its ring, mamba2's state)
ZOO_ENGINE = {"granite_moe_1b": (16, 4096), "whisper_tiny": (2, 448)}
ZOO_DECODE_TICKS = 8
#: the card-vs-CPU check's cuts beyond its depth, for the CPU's time and
#: memory (DeepSeek-V2: 16 of 160 routed experts, top-6 and 2 shared kept)
ZOO_CHECK_CUTS = {"deepseek_v2_236b": {"n_experts": 16}}
#: DeepSeek-V2's check at a shorter sequence, still over DENSE_MAX_SEQ (so
#: B6 runs), its CPU path's query block halved to divide it: at 4,096 the
#: CPU took 38-51 s in float32 and 80 s in bfloat16 (PERF.md section 6)
ZOO_CHECK_SEQ = {"deepseek_v2_236b": (2_304, dict(attn_q_block=1_152))}
#: checks run on the card alone (their B6 launches and B6 against its plain
#: version, no CPU prefill): DeepSeek-V2's bfloat16 one, whose CPU side
#: gated nothing (a router: its routing flips were reported) and took 43 s
ZOO_CHECK_CARD_ONLY = {("deepseek_v2_236b", "bfloat16")}
#: B6 launches of the check prefill (2 layers, S = CHECK_SEQ): whisper's
#: decoder runs self- and cross-attention (T = 1,500) through it
ZOO_CHECK_B6 = {"granite_moe_1b": 2, "deepseek_v2_236b": 2, "hymba_1p5b": 2,
                "mamba2_130m": 0, "whisper_tiny": 4}
#: float32 routing, card vs CPU: a one-ulp difference in a router logit
#: flips an expert only at a near-tie, so a flip is rare (reported); a
#: wrong dispatch flips a large share.  With no flip the logits are held to
#: CHECK_TOL, with one (a token's expert set changed) to CHECK_TOL_BF16
ZOO_FLIP_MAX_F32 = 1e-3
#: a check model of up to this many bytes of parameters goes to the CPU
#: side (through a file) for its CPU prefills; DeepSeek-V2's (7.3 GiB) runs
#: them here
ZOO_SIDE_MAX_BYTES = 2 << 30


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def same_bits(a, b) -> bool:
    """Bitwise equality of two tensors of one dtype (float via int32 view),
    on their device when they share one, else on the host; of two dicts of
    tensors (a round's reputation state) key by key."""
    import torch
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_bits(a[k], b[k]) for k in a))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.detach(), b.detach()
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
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


def device_profile(fn, iters: int = 3, warm: bool = True) -> list:
    """Device milliseconds per call of ``fn()``, by CUDA kernel name, from
    ``torch.profiler`` (CUPTI): [(kernel, ms per call, launches per call)],
    longest first.  Empty when the profiler sees no device activity.
    ``warm=False`` skips the unprofiled call before, for a ``fn`` that
    has just run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
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
    """The larger of the bytes over the card's memory rate and the
    operations over its float32 rate (also the bound used for integer ALU
    work): the H100's figures of ``repro_torch.launch.mesh``."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_FP32
    t_bytes = bytes_moved / HBM_BW * 1e3
    t_ops = ops / PEAK_FLOPS_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernel(fn, plain, nbytes: int, ops: int, shape: list,
                graph: dict | None = None) -> dict:
    """A kernel wrapper's call ms (CUDA events per call), its device ms (a
    CUDA graph's replay, ``graph`` its :func:`graph_ms` arguments), its
    plain version's ms and its bound."""
    t_b, by_b = bound(nbytes, ops)
    return dict(ms=cuda_ms(fn), device_ms=graph_ms(fn, **(graph or {})),
                plain_ms=cuda_ms(plain, iters=5), bound_ms=t_b, bound_by=by_b,
                bytes=nbytes, shape=shape)


def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = out.splitlines()[0].strip()
    log(f"[card] {card}")
    return card


def phase_build() -> dict:
    """Start one ``nvcc`` for each source, all together, and wait for the
    FediAC kernels' two (``quant``, ``votes``); the attention library goes
    on compiling beside the FediAC phases (:func:`phase_build_attention`)."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.start()
    out = {"seconds": build.finish(("quant", "votes")), "t0": t0}
    out["wait_s"] = time.perf_counter() - t0
    log(f"[build] {out['seconds']} ({out['wait_s']:.1f} s waited); "
        "attention compiling")
    return out


def phase_build_attention(b: dict) -> None:
    """Wait for the attention libraries (B6's forward and its backward)
    that :func:`phase_build` started."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    b["seconds"].update(build.finish(("attention", "attention_bwd")))
    b["wait_s"] += time.perf_counter() - t0
    b["wall_s"] = time.perf_counter() - b.pop("t0")
    log(f"[build] {b['seconds']} ({b['wait_s']:.1f} s waited of "
        f"{b['wall_s']:.1f} s from the first nvcc to the last library)")


def hgmma_count(name: str = "attention") -> int:
    """The number of HGMMA (wgmma) instructions in the SASS of a built
    attention library (B6's forward, or ``attention_bwd``, its backward):
    more than 0 shows that its bf16 instances run on the tensor cores."""
    import os
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build._lib_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    log(f"[build] HGMMA instructions in lib{name}'s SASS: {n}")
    check(n > 0, f"the {name} library has no HGMMA instruction")
    return n


def simt_resources() -> dict:
    """Registers, stack and local (spilled) bytes a thread of each float32
    instance of B6 (``flash_fwd_simt<rows, value columns / 64, ring
    slots>``) uses, from ``cuobjdump -res-usage`` of the built library."""
    import os
    import re
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-res-usage",
                           str(build._lib_path("attention"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        fn = re.search(
            r"Function\s+\S*flash_fwd_simtILi(\d+)ELi(\d+)ELi(\d+)E\S*:", line)
        if fn:
            name = "<{}, {}, {}>".format(*fn.groups())
            continue
        use = re.search(
            r"REG:(\d+)\s+STACK:(\d+)\s+SHARED:\d+\s+LOCAL:(\d+)", line)
        if name and use:
            out[name] = dict(zip(("registers", "stack", "local"),
                                 map(int, use.groups())))
            name = None
    log(f"[build] flash_fwd_simt resources per thread: {out}")
    check(len(out) == 6, f"expected 6 float32 B6 instances, read {out}")
    return out


def bwd_res_usage(lib) -> dict:
    """Registers and spilled (local) bytes a thread of each instance of
    B6's backward kernels uses in the library at ``lib`` (``cuobjdump
    -res-usage``), by name, dtype and head sizes."""
    import os
    import re
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-res-usage", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        fn = re.search(r"Function\s+\S*?(flash_bwd_(?:dkdv|dq)(?:_wgmma)?)I"
                       r"(f|\d+__nv_bfloat16)?Li(\d+)ELi(\d+)E\S*:", line)
        if fn:
            name = "{}<{}, {}, {}>".format(
                fn.group(1), "f32" if fn.group(2) == "f" else "bf16",
                fn.group(3), fn.group(4))
            continue
        use = re.search(r"REG:(\d+)\s+STACK:\d+\s+SHARED:\d+\s+LOCAL:(\d+)",
                        line)
        if name and use:
            out[name] = dict(zip(("registers", "local"),
                                 map(int, use.groups())))
            name = None
    return out


def bwd_resources() -> dict:
    """:func:`bwd_res_usage` of the built ``attention_bwd`` library:
    ``flash_bwd_dkdv`` and ``flash_bwd_dq`` (FFMA: float32 at four head
    sizes, bf16 at 256 / 256) and ``flash_bwd_dkdv_wgmma`` and
    ``flash_bwd_dq_wgmma`` (bf16 at 64 / 64, 128 / 128, 192 / 128); none
    may spill."""
    from repro_torch.kernels import build
    out = bwd_res_usage(build._lib_path("attention_bwd"))
    log(f"[build] B6 backward resources per thread: {out}")
    wgmma = sum(name.startswith(("flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"))
                for name in out)
    check(len(out) == 16 and wgmma == 6
          and all(v["local"] == 0 for v in out.values()),
          f"B6 backward instances missing or spilling: {out}")
    return out


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


# ---------------------------------------------------------------------------
# The CPU side: CPU references computed in a spawned process while the
# card's phases go on
# ---------------------------------------------------------------------------

#: the run's :class:`_CpuSide`, made by :func:`main`
SIDE = None
#: Qwen3-0.6B's dry-run records (``repro_torch.launch.dryrun.run_one``) by
#: shape, computed on the CPU side (meta tensors) and filled in when it is
#: settled; their model FLOPs give the train and serve phases' share of
#: the bf16 peak
DRYRUN: dict = {}
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _side_init(src: str, threads: int) -> None:
    """The side process's start: no card (it computes on the CPU only),
    ``threads`` of the host's cores, the repository's sources on the
    path."""
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    torch.set_num_threads(threads)
    import repro_torch  # noqa: F401


class _Saved(str):
    """The path of an input :meth:`_CpuSide.put` saved: the side process
    loads it in its place."""


def _side_run(fn, out: str, args: tuple) -> float:
    """``fn(*args)``, each :class:`_Saved` argument loaded, saved to
    ``out``; returns its seconds."""
    import torch
    t0 = time.perf_counter()
    args = [torch.load(a, weights_only=False) if isinstance(a, _Saved) else a
            for a in args]
    torch.save(fn(*args), out)
    return time.perf_counter() - t0


class _CpuSide:
    """One spawned process that computes CPU references while the card's
    phases go on.  A phase saves a job's tensors with :meth:`put` (so that
    no tensor crosses the process boundary in a pickle), submits a
    function that computes the reference from them with the gate to hold
    it to (:meth:`submit`), and goes on; :meth:`settle` waits
    for each job in turn, loads its result and runs its gate, which raises
    as the phase's own check would.  Nothing is checked in the process.
    It has no card and half the host's cores, so the card's phases keep
    theirs."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing
        import os
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_side_")
        self.threads = max(1, (os.cpu_count() or 2) // 2)
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_side_init, initargs=(str(ROOT / "src"), self.threads))
        self.pool.submit(int)            # start it (and torch) now
        self.jobs, self.named, self.n, self.seconds = [], {}, 0, {}

    def put(self, obj, name: str | None = None) -> _Saved:
        """``obj`` saved for a job, which gets it in the returned path's
        place; once per ``name``."""
        import torch
        if name in self.named:
            return self.named[name]
        self.n += 1
        path = _Saved(f"{self.dir}/in{self.n}.pt")
        torch.save(obj, path)
        if name is not None:
            self.named[name] = path
        return path

    def submit(self, label: str, gate, fn, *args) -> None:
        """``fn(*args)`` in the process; at :meth:`settle`,
        ``gate(result, seconds)``."""
        self.n += 1
        out = f"{self.dir}/out{self.n}.pt"
        self.jobs.append((label, out, gate,
                          self.pool.submit(_side_run, fn, out, args)))

    def settle(self) -> None:
        import os

        import torch
        while self.jobs:
            label, out, gate, job = self.jobs.pop(0)
            t0 = time.perf_counter()
            self.seconds[label] = job.result()
            waited = time.perf_counter() - t0
            res = torch.load(out, weights_only=False)
            os.remove(out)
            log(f"[cpu side] {label}: {self.seconds[label]:.1f} s on "
                f"{self.threads} threads ({waited:.1f} s waited)")
            gate(res, self.seconds[label])

    def close(self) -> None:
        """Stop the process, a job running or not, and remove the files."""
        for proc in list(getattr(self.pool, "_processes", {}).values()):
            proc.terminate()
        self.pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(self.dir, ignore_errors=True)


def _dryrun_records(shapes) -> dict:
    """Qwen3-0.6B's dry-run record at each of ``shapes`` (run in the side
    process)."""
    from repro_torch.launch import dryrun
    return {shape: dryrun.run_one(QWEN, shape) for shape in shapes}


def _dryrun_gate(res: dict, seconds: float) -> None:
    for shape, rec in res.items():
        check("error" not in rec and rec["model_flops"] > 0
              and rec["params_total"] == QWEN_PARAMS,
              f"dry-run of {QWEN} at {shape}: {rec}")
    DRYRUN.update(res)
    log(f"[dryrun] {QWEN}: " + "; ".join(
        f"{k} model FLOPs {r['model_flops']:.4g}, {r['flops_per_device']:.4g}"
        f" FLOPs and {r['hbm_bytes_per_device']:.4g} bytes per device, "
        f"{r['dominant']}-bound" for k, r in res.items())
        + f" ({seconds:.1f} s on the CPU side)")


def _to_host(x):
    """``x`` with every tensor in it (in tuples, lists and dicts) copied to
    the host."""
    import torch
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _cpu_round(u, cfg, key, counts):
    """The CPU's side of a stacked round: phase 2 and the aggregate from
    the card's vote counts, and the vote counts of a whole CPU round
    (``aggregate_stack``)."""
    from repro_torch.core.fediac import aggregate_from_counts, aggregate_stack
    return (*aggregate_from_counts(u, cfg, key, counts),
            aggregate_stack(u, cfg, key)[2])


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
    """Outputs against the CPU (plain versions) and the FL run's sanity.
    The rounds' CPU side goes to :data:`SIDE`: its gates run (and fill
    ``counts_differ_g*``) when it settles."""
    import torch
    from repro_torch.training.fl_loop import run_federated
    report = {}
    u_cpu = SIDE.put(u_stack.cpu(), "u_stack")
    key_cpu = SIDE.put(key.cpu(), "key")
    for g, (delta, residuals, counts, traffic) in main["rounds"].items():
        cfg = _round_cfg(g)
        k = cfg.k(D // g)
        check(delta.shape == (D,) and residuals.shape == (N_CLIENTS, D)
              and counts.shape == (D // g,), f"g={g}: output shapes")
        check(bool(torch.isfinite(delta).all() and torch.isfinite(residuals).all()),
              f"g={g}: non-finite outputs")
        check(int(counts.sum()) == N_CLIENTS * k,
              f"g={g}: counts sum {int(counts.sum())} != N*k {N_CLIENTS * k}")

        def gate(cpu, seconds, g=g, delta=delta.cpu(),
                 residuals=residuals.cpu(), counts=counts.cpu()):
            d_cpu, r_cpu, c_cpu = cpu
            check(same_bits(delta, d_cpu) and same_bits(residuals, r_cpu),
                  f"g={g}: card phase 2 + aggregate != CPU from the card's "
                  "counts")
            n_diff = int((c_cpu != counts).sum())
            # the vote scores replay XLA's log on both devices, so the
            # counts are expected equal; the gate leaves room for a libm
            # ulp in log.
            check(n_diff <= 1e-4 * (D // g),
                  f"g={g}: {n_diff} vote counts differ card vs CPU")
            log(f"[checks] g={g}: phase 2 + aggregate bitwise card == CPU; "
                f"{n_diff} of {D // g} vote counts differ card vs CPU whole "
                f"round ({seconds:.1f} s on the CPU side)")
            report[f"counts_differ_g{g}"] = n_diff

        SIDE.submit(f"checks g={g}", gate, _cpu_round, u_cpu, cfg, key_cpu,
                    SIDE.put(counts.cpu()))
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
# The comparison path: the paper's baselines, the robust closes, the FL
# loop per aggregator, and kill-and-resume
# ---------------------------------------------------------------------------

#: the five baselines of paper Sec. V-A3 at the stacked round's scale
BASELINES = ("fedavg", "switchml", "topk", "omnireduce", "libra")
#: the robust closes of the FediAC round (robust_agg, trim_frac)
ROBUST_CLOSES = (("trim", 0.1), ("median", 0.0))
#: the aggregators of the FL comparison with the arguments the reference's
#: tests/test_fl_system.py::test_fediac_traffic_beats_baselines gives them
FL_AGGREGATORS = ("fediac", "switchml", "fedavg", "topk", "omnireduce",
                  "libra")
RESUME_AGGREGATORS, RESUME_KILL_ROUND = ("fediac", "libra"), 2
#: the FL loop, card vs CPU: acc and loss within FL_TOL (the FL check's
#: gate of phase_checks) of a CPU run that aggregates the card run's own
#: per-round inputs (each round's key, state and result held bitwise on
#: the way), so that the two devices' local SGD starts every round from
#: the same model; and of an independent CPU run, but for SwitchML's loss
#: there, which is printed: its stochastic rounding of all d coordinates
#: turns the devices' float32 differences in local SGD into whole
#: quantization steps on a few coordinates (PERF.md section 6).
FL_TOL = 1e-5


def _fl_agg_kwargs(name):
    from repro_torch.core.fediac import FediACConfig
    if name == "fediac":
        return {"cfg": FediACConfig(a=2, bits=12)}
    return {"bits": 12} if name == "switchml" else {}


def _fl_compare_cfg(name, **extra):
    """The default FL setup (kernels on, so fediac launches B1) with
    aggregator ``name``."""
    _, _, flcfg = _fl_setup()
    return dataclasses.replace(flcfg, aggregator=name,
                               agg_kwargs=_fl_agg_kwargs(name), **extra)


def _robust_cfg(close, frac, g):
    return dataclasses.replace(_round_cfg(g), robust_agg=close,
                               trim_frac=frac)


def _baseline_keys(key):
    from repro_torch.core import prng
    return [prng.fold_in(key, 100 + r) for r in range(2)]


def _run_baseline(name, u, keys):
    """One baseline through ``make_aggregator``: one round, or two for
    libra so that its heat state is carried.  Returns the rounds' outputs."""
    from repro_torch.core.baselines import make_aggregator
    agg = make_aggregator(name)
    state, outs = None, []
    for r in range(2 if name == "libra" else 1):
        out = agg(u, state, keys[r].to(u.device))
        state = out[2]
        outs.append(out)
    return outs


class _Recorder:
    """The FL loop's round transport (``run_federated``'s
    ``wrap_transport``), recording what it is given each round and what it
    returns."""

    def __init__(self):
        self.inner, self.rounds = None, []

    def wrap(self, inner):
        self.inner = inner
        return self

    def round(self, u, state, key, t=0):
        res = self.inner.round(u, state, key, t)
        self.rounds.append((u, state, key, res))
        return res


class _CardInputs:
    """A CPU run's round transport that aggregates the card run's recorded
    update stack of each round in place of its own, and holds the round's
    key, state and result bitwise against the card's."""

    def __init__(self, inner, name, rounds):
        self.inner, self.name, self.rounds = inner, name, rounds

    def round(self, u, state, key, t=0):
        card_u, card_state, card_key, card = self.rounds[t - 1]
        where = f"FL {self.name} round {t}"
        check(same_bits(key, card_key) and (
            (state is None and card_state is None)
            or same_bits(state, card_state)),
              f"{where}: the CPU's key / state != the card's")
        res = self.inner.round(card_u.cpu(), state, key, t)
        check(same_bits(res.delta, card.delta)
              and same_bits(res.residuals, card.residuals)
              and (res.state is None or same_bits(res.state, card.state))
              and res.traffic == card.traffic and res.load == card.load
              and res.n_active == card.n_active,
              f"{where}: the card's aggregate != the CPU's on the same "
              "inputs")
        return res


def _same_history(a, b) -> bool:
    return (a.acc == b.acc and a.loss == b.loss and a.wall_clock == b.wall_clock
            and a.traffic_mb == b.traffic_mb)


def phase_compare(u_stack, key) -> dict:
    """The paper's comparison on the card: the five baselines and the trim
    and median rounds at the stacked round's scale, the FL loop for each
    of the six aggregators, and kill-and-resume, with the launch counts
    zeroed just before and read just after; then each against the CPU,
    and their times."""
    import torch
    from repro_torch.core import fediac
    from repro_torch.core.baselines import make_aggregator
    from repro_torch.kernels.gather_quant import gather_quant
    from repro_torch.kernels.stoch_quant import stoch_quant
    from repro_torch.training.fl_loop import run_federated
    clients, test, _ = _fl_setup()
    keys = _baseline_keys(key)
    out = {}

    # -- the comparison path on the card
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    base = {}
    for name in BASELINES:
        base[name] = _run_baseline(name, u_stack, keys)
        torch.cuda.synchronize()
    robust = {}
    for close, frac in ROBUST_CLOSES:
        for g in (1, 4):
            before = (gather_quant.launches, stoch_quant.launches)
            robust[close, g] = fediac.aggregate_round(
                u_stack, _robust_cfg(close, frac, g), key)
            torch.cuda.synchronize()
            rose = (gather_quant.launches - before[0],
                    stoch_quant.launches - before[1])
            check(rose == ((1, 0) if g == 1 else (0, 1)),
                  f"{close} round g={g} launched (gather_quant, stoch_quant) "
                  f"{rose}")
    hists, fl_ms, recorded = {}, {}, {}
    for name in FL_AGGREGATORS:
        flcfg = _fl_compare_cfg(name)
        t0 = time.perf_counter()
        hists[name] = run_federated(clients, test, flcfg, device=DEV)
        torch.cuda.synchronize()
        fl_ms[name] = (time.perf_counter() - t0) * 1e3 / flcfg.rounds
        rec = _Recorder()
        again = run_federated(clients, test, flcfg, device=DEV,
                              wrap_transport=rec.wrap)
        check(_same_history(again, hists[name]),
              f"FL {name}: the recorded card run != the timed one")
        recorded[name] = rec.rounds
    resumed = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as td:
        for name in RESUME_AGGREGATORS:
            path = str(Path(td) / f"{name}.npz")
            killed = run_federated(clients, test, _fl_compare_cfg(
                name, rounds=RESUME_KILL_ROUND, ckpt_path=path), device=DEV)
            check(len(killed) == RESUME_KILL_ROUND, f"{name}: killed run has "
                  f"{len(killed)} rounds")
            resumed[name] = run_federated(clients, test, _fl_compare_cfg(
                name, ckpt_path=path, resume=True), device=DEV)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    fl_rounds = _fl_setup()[2].rounds
    # the timed run, the recorded run, then kill + resume
    n_fediac_fl = 3 * fl_rounds
    want = {k: 0 for k in launches}
    want["gather_quant"] = len(ROBUST_CLOSES) + n_fediac_fl
    want["stoch_quant"] = len(ROBUST_CLOSES)
    check(launches == want, f"comparison path launches {launches}, not {want}")
    out["launches"] = launches
    out["robust_round_launches"] = len(ROBUST_CLOSES)
    log(f"[compare] launches {launches}")

    # -- the baselines, card vs CPU: everything bitwise (both devices add
    # the client axis in client order); the CPU's rounds on the CPU side,
    # the gates when it settles
    u_cpu = SIDE.put(u_stack.cpu(), "u_stack")
    keys_cpu = SIDE.put([k.cpu() for k in keys])
    out["baselines"] = {}
    for name in BASELINES:
        for r, (delta, res, *_) in enumerate(base[name]):
            check(delta.shape == (D,) and res.shape == (N_CLIENTS, D)
                  and bool(torch.isfinite(delta).all()),
                  f"{name} round {r}: delta {tuple(delta.shape)} not finite "
                  "/ shaped")
        _, res, _, traffic, load = base[name][-1]
        # the uploaded coordinates (u != residual) of every client
        uploaded = int((res != u_stack).sum())
        info = out["baselines"][name] = {
            "rounds": len(base[name]), "uploaded": uploaded,
            "mb_per_client": traffic.total_bytes / 1e6,
            "slot_adds": load.slot_adds, "aligned": load.aligned}

        def gate(cpu, seconds, name=name, info=info,
                 card=_to_host(base[name])):
            check(len(cpu) == len(card), f"{name}: {len(cpu)} CPU rounds")
            for r, (card_r, cpu_r) in enumerate(zip(card, cpu)):
                delta, res, state, traffic, load = card_r
                where = f"{name} round {r}"
                check(same_bits(delta, cpu_r[0]) and same_bits(res, cpu_r[1]),
                      f"{where}: card delta / residuals != CPU")
                check((state is None and cpu_r[2] is None)
                      or same_bits(state, cpu_r[2]),
                      f"{where}: card state != CPU")
                check(traffic == cpu_r[3] and load == cpu_r[4],
                      f"{where}: traffic {traffic} / load {load} != CPU "
                      f"{cpu_r[3]} / {cpu_r[4]}")
            info["cpu_s"] = seconds
            log(f"[compare] {name}: card == CPU bitwise (delta, residuals, "
                f"state, traffic, load) over {len(cpu)} round(s); "
                f"{info['uploaded']} coordinates uploaded ({seconds:.1f} s "
                "on the CPU side)")

        SIDE.submit(f"compare {name}", gate, _run_baseline, name, u_cpu,
                    keys_cpu)
    del base

    # -- the robust closes: phase 2 and the close on the CPU side from the
    # card's vote counts, bitwise
    for (close, g), (delta, res, counts, _) in robust.items():
        cfg = _robust_cfg(close, dict(ROBUST_CLOSES)[close], g)
        check(delta.shape == (D,) and bool(torch.isfinite(delta).all()
                                           and torch.isfinite(res).all()),
              f"{close} g={g}: outputs not finite / shaped")
        check(int(counts.sum()) == N_CLIENTS * cfg.k(D // g),
              f"{close} g={g}: counts sum {int(counts.sum())}")

        def gate(cpu, seconds, close=close, g=g, delta=delta.cpu(),
                 res=res.cpu()):
            d_cpu, r_cpu = cpu
            check(same_bits(delta, d_cpu) and same_bits(res, r_cpu),
                  f"{close} g={g}: card phase 2 + close != CPU from the "
                  "card's counts")
            log(f"[compare] {close} g={g}: phase 2 + close bitwise card == "
                f"CPU ({seconds:.1f} s on the CPU side)")

        SIDE.submit(f"compare {close} g={g}", gate,
                    fediac.aggregate_from_counts, u_cpu, cfg,
                    SIDE.put(key.cpu(), "key"), SIDE.put(counts.cpu()))
    del robust

    # -- the FL loop per aggregator, card vs CPU, and the paper's order
    out["fl"] = {}
    for name in FL_AGGREGATORS:
        h, rounds = hists[name], recorded.pop(name)
        check(len(rounds) == len(h), f"FL {name}: {len(rounds)} rounds "
              "recorded")
        check(all(math.isfinite(x) for x in h.loss), f"FL {name}: loss")
        cfg = _fl_compare_cfg(name)
        h_pin = run_federated(
            clients, test, cfg, device="cpu",
            wrap_transport=lambda tr: _CardInputs(tr, name, rounds))
        h_cpu = run_federated(clients, test, cfg, device="cpu")
        gaps = {}
        for run, hc in (("pinned", h_pin), ("independent", h_cpu)):
            check(h.traffic_mb == hc.traffic_mb
                  and h.wall_clock == hc.wall_clock,
                  f"FL {name}: traffic / wall-clock differ card vs CPU "
                  f"({run} run)")
            gaps[run] = (max(abs(a - b) for a, b in zip(h.acc, hc.acc)),
                         max(abs(a - b) for a, b in zip(h.loss, hc.loss)))
        gated = [gaps["pinned"][0], gaps["pinned"][1], gaps["independent"][0]]
        if name != "switchml":
            gated.append(gaps["independent"][1])
        check(max(gated) <= FL_TOL,
              f"FL {name} card vs CPU: (acc, loss) gaps {gaps}, "
              f"tolerance {FL_TOL}")
        out["fl"][name] = {"acc": h.acc[-1], "traffic_mb": h.traffic_mb[-1],
                           "wall_clock_s": h.wall_clock[-1],
                           "acc_gap": gaps["independent"][0],
                           "loss_gap": gaps["independent"][1],
                           "acc_gap_pinned": gaps["pinned"][0],
                           "loss_gap_pinned": gaps["pinned"][1],
                           "replayed_rounds": len(rounds),
                           "round_ms": fl_ms[name]}
    mb = {k: v["traffic_mb"] for k, v in out["fl"].items()}
    check(mb["fediac"] < mb["switchml"] < mb["fedavg"],
          f"FL traffic order fediac < switchml < fedavg broken: {mb}")
    line = ("[compare] FL, " + f"{fl_rounds} rounds; CPU run on the card's "
            "per-round inputs: every aggregate bitwise, acc and loss within "
            f"{FL_TOL}; independent CPU run: acc within {FL_TOL}, loss within "
            f"{FL_TOL} (switchml's loss gap "
            f"{out['fl']['switchml']['loss_gap']:.3g}, printed); both: "
            "traffic, wall-clock exact; final acc / "
            "cumulative MB / simulated wall-clock s: " + "; ".join(
                f"{k} {v['acc']:.4f} / {v['traffic_mb']:.3f} / "
                f"{v['wall_clock_s']:.3f}" for k, v in out["fl"].items()))
    log(line)
    print(line, flush=True)

    # -- kill and resume on the card: bit-identical histories
    for name, h in resumed.items():
        check(_same_history(h, hists[name]),
              f"{name}: resumed history != the uninterrupted card run")
    out["resume_bit_identical"] = list(resumed)
    log(f"[compare] kill at round {RESUME_KILL_ROUND} and resume: "
        f"{list(resumed)} bit-identical to the uninterrupted card runs")

    # -- times at N_CLIENTS x D: each baseline's round, and the robust
    # closes beside the sum round
    times = {}
    for name in BASELINES:
        agg = make_aggregator(name)
        state = None
        if name == "libra":     # a carried-state round, as round 2 runs
            state = agg(u_stack, None, keys[0])[2]
        times[name] = wall_ms(lambda: agg(u_stack, state, keys[1]))
    for g in (1, 4):
        for close, frac in (("sum", 0.0),) + ROBUST_CLOSES:
            cfg = _robust_cfg(close, frac, g)
            times[f"fediac_{close}_g{g}"] = wall_ms(
                lambda: fediac.aggregate_round(u_stack, cfg, key))
    slowest = max(BASELINES, key=times.get)
    agg = make_aggregator(slowest)
    rows = device_profile(lambda: agg(u_stack, None, keys[0]))
    busy = sum(r[1] for r in rows)
    out["round_ms"] = times
    out["slowest_baseline"] = {
        "name": slowest, "round_ms": times[slowest], "device_ms": busy,
        "idle_share": 1.0 - busy / times[slowest] if rows else None,
        "top_kernels": [(n[:60], ms, c) for n, ms, c in rows[:5]]}
    log("[compare timing] " + json.dumps({"round_ms": times,
                                          "fl_round_ms": fl_ms,
                                          "slowest": out["slowest_baseline"]}))
    return out


# ---------------------------------------------------------------------------
# The stream path: the chunked round engine, bitwise against the
# monolithic one, and its d ~ 1e8 scale cell
# ---------------------------------------------------------------------------

#: chunk sizes of the bit-identity runs at N_CLIENTS x D: the default
#: (3 full chunks and a ragged tail) and one that is not a power of two
STREAM_CHUNKS = (None, 100_003)
#: the scale cell: SHARD_D of benchmarks/aggregation_round.py:62 (the
#: reference's d ~ 1e8) at the N = 8 of its stream cells (:46-48)
STREAM_SCALE_N, STREAM_SCALE_D = 8, 8 * 4096 * 3052
STREAM_SCALE_ITERS = 3           # timed rounds (median) of the scale cell
#: stream against monolithic at the reference's stream scale cell
#: (STREAM_GRID, aggregation_round.py:46-48), a size both engines hold
STREAM_CHECK_D = 10_000_000
STREAM_FL_CHUNK = 4096


def _stream_cfgs() -> dict:
    """The stream phase's round configs, kernels on: top-k with the sum,
    trim and median closes, and threshold/block with the sum."""
    from repro_torch.core.engines import EngineSpec
    from repro_torch.core.fediac import FediACConfig
    spec = EngineSpec(use_pallas=True)
    return {"topk_sum": FediACConfig(engine=spec),
            "topk_trim": FediACConfig(robust_agg="trim", trim_frac=0.1,
                                      engine=spec),
            "topk_median": FediACConfig(robust_agg="median", engine=spec),
            "block_sum": FediACConfig(vote_mode="threshold",
                                      compact_mode="block", engine=spec)}


def _same_round(a, b) -> bool:
    return (all(same_bits(x, y) for x, y in zip(a[:3], b[:3]))
            and a[3] == b[3])


def _peak_gib(fn):
    """``fn()``'s result, and the device memory peak while it ran: in all,
    and above what was allocated when it started (GiB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return res, peak / 2**30, (peak - base) / 2**30


def _free_card() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _b1_tally(by_shape: dict):
    """Tally B1's launches by operand shape while the block runs: each call
    the engines make through ``kernels.ops`` adds what the wrapper's own
    count rose by, under the shape it was given."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_quant import gather_quant

    def tallied(u, *args, **kw):
        before = gather_quant.launches
        res = gather_quant(u, *args, **kw)
        k = str(list(u.shape))
        by_shape[k] = by_shape.get(k, 0) + gather_quant.launches - before
        return res

    ops.gather_quant = tallied
    try:
        yield
    finally:
        ops.gather_quant = gather_quant


def _chunk_shapes(n: int, d: int, c: int) -> dict:
    """The B1 launch shapes of one fused stream round, with their counts."""
    shapes = {str([n, c]): d // c}
    if d % c:
        shapes[str([n, d % c])] = 1
    return shapes


def _b1_strided_parity(u, c: int, q_keys, seed: int) -> list:
    """B1 on the strided column views of ``u`` the stream engine hands it
    (a full chunk, and the ragged tail where there is one), with that
    chunk's uniform_block draw, a 5% consensus mask and f from the stack's
    max, against its plain version on the same operands: q and the residual
    bitwise.  Then on views no chunk size of these paths gives: starts 1, 2
    and 3 columns past the full chunk's (off a 16-byte boundary) with an
    odd width, one row, and the residual written into the view itself
    (``out=``, on a copy of the columns around it).  Returns the views
    checked."""
    import torch
    from repro_torch.core import streams
    from repro_torch.core.quantize import scale_factor
    from repro_torch.kernels.gather_quant import gather_quant, gather_quant_plain
    n, d = u.shape
    f = torch.tensor(scale_factor(12, n, 1.0), device=DEV) / u.abs().max()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    s0 = c if d // c > 1 else 0
    odd = min(c, d - s0) - 3
    odd -= 1 - odd % 2
    # (what, rows, start, columns, residual written into the view)
    cases = [("chunk", n, s0, c, False)]
    if d % c:
        cases.append(("tail", n, d - d % c, d % c, False))
    if odd > 0:
        cases += [(f"start+{k}", n, s0 + k, odd, False) for k in (1, 2, 3)]
        cases += [("one row", 1, s0 + 1, odd, False),
                  ("in place", n, s0 + 2, odd, True)]
    checked = []
    for what, rows, start, cols, in_place in cases:
        uni = streams.uniform_block(q_keys[:rows], start, cols, d)
        sel = (torch.rand(cols, device=DEV, generator=gen) < 0.05).to(
            torch.uint8)
        if in_place:
            # a copy of the view's columns, 3 columns into a buffer 6
            # wider, so the view keeps a row stride and a misaligned start
            view = torch.nn.functional.pad(
                u[:rows, start:start + cols], (3, 3))[:, 3:3 + cols]
            want = gather_quant_plain(view.clone(), uni, sel, f)
            got = gather_quant(view, uni, sel, f, out=view)
            ok = got[1] is view and same_bits(view, want[1])
        else:
            view = u[:rows, start:start + cols]
            want = gather_quant_plain(view, uni, sel, f)
            got = gather_quant(view, uni, sel, f)
            ok = same_bits(got[1], want[1])
        label = (f"{what} u[:{rows}, {start}:{start + cols}] of "
                 f"{list(u.shape)}")
        check(ok and same_bits(got[0], want[0]),
              f"B1 on the strided view {label} != its plain version")
        checked.append(label)
    return checked


def phase_stream(u_stack, key) -> dict:
    """The stream engine on the card.  Its runs are the stream path: the
    B1 count is zeroed just before each and read just after.  Bitwise
    against the monolithic engine at N_CLIENTS x D (two chunk sizes, four
    configs) and at 8 x STREAM_CHECK_D, the FL loop's history on it equal
    to the monolithic run's, then the 8 x STREAM_SCALE_D cell: timed,
    profiled, its peak memory with and without ``out=``, checked; then B1
    at the cell's chunk shape, contiguous and on the strided chunk with
    and without ``out=``."""

    import torch
    from repro_torch.core import fediac, prng, stream_engine, streams
    from repro_torch.core.engines import EngineSpec
    from repro_torch.kernels.gather_quant import gather_quant, gather_quant_plain
    from repro_torch.training.fl_loop import run_federated
    out = {"launches": 0, "launches_by_shape": {}, "b1_strided_bitwise": []}
    by_shape = out["launches_by_shape"]

    def counted(fn, cfg, n, d, chunk):
        """``fn()`` with the B1 count zeroed just before and read just
        after, and tallied by shape: one launch per chunk on the fused
        path, none otherwise."""
        c = stream_engine._chunk_size(cfg, d, chunk)
        fused = fediac.plan_wants_dense_mask(cfg)
        tally = {}
        gather_quant.launches = 0
        with _b1_tally(tally):
            res = fn()
        torch.cuda.synchronize()
        got = gather_quant.launches
        want = _chunk_shapes(n, d, c) if fused else {}
        check(got == sum(want.values()) and tally == {
            k: v for k, v in want.items() if v},
              f"stream N={n} d={d} chunk={c}: B1 launched {got} times, by "
              f"shape {tally}, not {want}")
        out["launches"] += got
        for k, v in tally.items():
            by_shape[k] = by_shape.get(k, 0) + v
        return res

    def strided_parity(u, chunk, seed):
        c = stream_engine._chunk_size(cfg, u.shape[1], chunk)
        q_keys = prng.split(key, 2 * u.shape[0])[u.shape[0]:]
        out["b1_strided_bitwise"] += _b1_strided_parity(u, c, q_keys, seed)

    # -- bitwise against the monolithic engine at N_CLIENTS x D
    n, d = u_stack.shape
    for name, cfg in _stream_cfgs().items():
        mono = fediac.aggregate_stack(u_stack, cfg, key)
        for chunk in STREAM_CHUNKS:
            got = counted(lambda: stream_engine.aggregate_stream(
                u_stack, cfg, key, chunk=chunk), cfg, n, d, chunk)
            check(_same_round(got, mono), f"stream {name} chunk={chunk} != "
                  f"monolithic at N={n}, d={d}")
        del mono, got
    out["bitwise_at_main"] = [f"{k} chunk={c or 'default'}"
                              for k in _stream_cfgs() for c in STREAM_CHUNKS]
    log(f"[stream] N={n} d={d}: {len(out['bitwise_at_main'])} stream rounds "
        f"bitwise equal to the monolithic ones; B1 launches {by_shape}")
    cfg = _stream_cfgs()["topk_sum"]
    for i, chunk in enumerate(STREAM_CHUNKS):
        strided_parity(u_stack, chunk, seed=20 + i)
    out["round_ms_at_main"] = {
        "stream": wall_ms(lambda: stream_engine.aggregate_stream(u_stack, cfg,
                                                                 key)),
        "monolithic": wall_ms(lambda: fediac.aggregate_stack(u_stack, cfg,
                                                             key)),
        # phase 1 goes over the clients, a block of rows at a time
        "stream_phase1": wall_ms(lambda: stream_engine._phase1_topk(
            u_stack, cfg, prng.split(key, 2 * n)[:n],
            stream_engine.DEFAULT_CHUNK))}
    rows = device_profile(lambda: stream_engine.aggregate_stream(u_stack, cfg,
                                                                 key))
    busy = sum(r[1] for r in rows)
    out["round_ms_at_main"]["stream_device"] = busy
    out["round_ms_at_main"]["stream_idle_share"] = (
        1.0 - busy / out["round_ms_at_main"]["stream"] if rows else None)

    # -- the FL loop on the stream engine, against its monolithic run
    clients, test, flcfg = _fl_setup()
    fl_stream = dataclasses.replace(flcfg, engine=EngineSpec(
        name="stream", chunk=STREAM_FL_CHUNK, use_pallas=True))
    fl_n, fl_d = FL_SHAPE
    want = {k: flcfg.rounds * v for k, v in _chunk_shapes(
        fl_n, fl_d, STREAM_FL_CHUNK).items()}
    tally = {}
    gather_quant.launches = 0
    with _b1_tally(tally):
        h_stream = run_federated(clients, test, fl_stream, device=DEV)
    torch.cuda.synchronize()
    check(gather_quant.launches == sum(want.values()) and tally == want,
          f"FL on the stream engine launched B1 {gather_quant.launches} times"
          f", by shape {tally}, not {want}")
    out["launches"] += gather_quant.launches
    for k, v in tally.items():
        by_shape[k] = by_shape.get(k, 0) + v
    h_mono = run_federated(clients, test, flcfg, device=DEV)
    check(_same_history(h_stream, h_mono),
          "FL history on the stream engine != the monolithic run's")
    out["fl_acc"] = h_stream.acc
    gen = torch.Generator(device=DEV).manual_seed(2)
    strided_parity(torch.randn(fl_n, fl_d, device=DEV, generator=gen) ** 3,
                   STREAM_FL_CHUNK, seed=22)
    log(f"[stream] FL {flcfg.rounds} rounds on EngineSpec('stream', "
        f"chunk={STREAM_FL_CHUNK}): history bit-identical to the monolithic "
        f"run; acc {h_stream.acc}")
    _free_card()

    # -- stream against monolithic at 8 x STREAM_CHECK_D, and their peaks
    gen = torch.Generator(device=DEV).manual_seed(1)
    u8 = torch.randn(STREAM_SCALE_N, STREAM_CHECK_D, device=DEV,
                     generator=gen) ** 3
    mono, mono_peak, mono_extra = _peak_gib(
        lambda: fediac.aggregate_stack(u8, cfg, key))
    got, st_peak, st_extra = _peak_gib(lambda: counted(
        lambda: stream_engine.aggregate_stream(u8, cfg, key), cfg,
        STREAM_SCALE_N, STREAM_CHECK_D, None))
    check(_same_round(got, mono), f"stream != monolithic at N="
          f"{STREAM_SCALE_N}, d={STREAM_CHECK_D}")
    del mono, got
    strided_parity(u8, None, seed=23)
    out["check_d"] = {
        "n": STREAM_SCALE_N, "d": STREAM_CHECK_D, "bitwise": True,
        "round_ms": {
            "stream": wall_ms(lambda: stream_engine.aggregate_stream(
                u8, cfg, key), iters=1),
            "monolithic": wall_ms(lambda: fediac.aggregate_stack(
                u8, cfg, key), iters=1)},
        "peak_gib": {"stream": st_peak, "monolithic": mono_peak},
        "peak_above_inputs_gib": {"stream": st_extra, "monolithic": mono_extra},
        # every temporary of the monolithic round is [N, d]-sized: its
        # peak above the inputs scales with d, the input stack too
        "monolithic_peak_gib_reckoned_at_scale": (
            (mono_extra + STREAM_SCALE_N * STREAM_CHECK_D * 4 / 2**30)
            * STREAM_SCALE_D / STREAM_CHECK_D)}
    log(f"[stream] N={STREAM_SCALE_N} d={STREAM_CHECK_D}: stream == "
        f"monolithic bitwise; " + json.dumps(out["check_d"]))
    del u8
    _free_card()

    # -- the scale cell: N = 8, d = 100,007,936, the default chunk
    n, d = STREAM_SCALE_N, STREAM_SCALE_D
    gen = torch.Generator(device=DEV).manual_seed(0)
    u = torch.randn(n, d, device=DEV, generator=gen) ** 3
    (delta, res, counts, _), peak, extra = _peak_gib(lambda: counted(
        lambda: stream_engine.aggregate_stream(u, cfg, key), cfg, n, d, None))
    k = cfg.k(d)
    check(delta.shape == (d,) and res.shape == (n, d) and counts.shape == (d,),
          "scale cell: output shapes")
    check(int(counts.sum()) == n * k,
          f"scale cell: counts sum {int(counts.sum())} != N*k {n * k}")
    check(bool(torch.isfinite(delta).all() and torch.isfinite(res).all()),
          "scale cell: non-finite delta or residuals")
    # what left the clients is what the mean applies: the CPU tests'
    # conservation check (tests/test_torch_round.py), at its tolerance
    left = (u - res).mean(0)
    cons_ok = bool(((left - delta).abs()
                    <= 1e-6 + 1e-5 * delta.abs()).all())
    cons_err = float((left - delta).abs().max())
    del left
    check(cons_ok, f"scale cell: (u - res).mean(0) vs delta off by {cons_err}")
    times = []
    for _ in range(STREAM_SCALE_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream_engine.aggregate_stream(u, cfg, key)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    round_ms = sorted(times)[STREAM_SCALE_ITERS // 2]
    u_in = u.clone()
    ptr = u_in.data_ptr()
    inplace, peak_in, extra_in = _peak_gib(
        lambda: stream_engine.aggregate_stream(u_in, cfg, key, out=u_in))
    check(inplace[1].data_ptr() == ptr and _same_round(
        inplace, (delta, res, counts, inplace[3])),
          "scale cell: out=u_stack != the out-of-place round, or not in place")
    del inplace, u_in
    _free_card()
    rows = device_profile(lambda: stream_engine.aggregate_stream(u, cfg, key),
                          iters=1)
    busy = sum(r[1] for r in rows)
    keys = prng.split(key, 2 * n)
    phase1_ms = wall_ms(lambda: stream_engine._phase1_topk(
        u, cfg, keys[:n], stream_engine.DEFAULT_CHUNK), iters=1)
    out["scale"] = {
        "n": n, "d": d, "chunk": stream_engine.DEFAULT_CHUNK,
        "chunks": -(-d // stream_engine.DEFAULT_CHUNK),
        "round_ms": round_ms, "round_ms_all": times, "phase1_ms": phase1_ms,
        "device_ms": busy,
        "idle_share": 1.0 - busy / round_ms if rows else None,
        "device_launches": sum(r[2] for r in rows),
        "top_kernels": [(nm[:60], ms, c) for nm, ms, c in rows[:6]],
        "peak_gib": peak, "peak_above_inputs_gib": extra,
        "peak_gib_out_in_place": peak_in,
        "peak_above_inputs_gib_out_in_place": extra_in,
        "input_gib": u.numel() * 4 / 2**30,
        "counts_sum": int(counts.sum()), "conservation_err": cons_err}
    log("[stream] scale cell " + json.dumps(out["scale"]))

    # -- B1 at the cell's chunk shape, and on the strided chunk as the
    # chunk loop hands it over: its column view of the stack, with the
    # residual returned fresh or written into the residual stack (out=)
    chunk = stream_engine.DEFAULT_CHUNK
    start = chunk
    gu, guni, gsel, gf = _stack_gather_inputs(n, chunk, seed=6)
    strided = u[:, start:start + chunk]
    q_keys = keys[n:]
    b1 = time_kernel(lambda: gather_quant(gu, guni, gsel, gf),
                     lambda: gather_quant_plain(gu, guni, gsel, gf),
                     16 * n * chunk + chunk + 4, 8 * n * chunk, [n, chunk])
    strided_parity(u, None, seed=24)
    log(f"[stream] B1 on strided chunks bitwise equal to its plain version "
        f"at {out['b1_strided_bitwise']}")
    res_c = res[:, start:start + chunk]

    def strided_call(**kw):
        return lambda: gather_quant(strided, guni, gsel, gf, **kw)

    for tag, call in (("strided", strided_call()),
                      ("strided_out", strided_call(out=res_c))):
        b1[f"{tag}_call_ms"] = cuda_ms(call)
        b1[f"{tag}_device_ms"] = graph_ms(call)
    b1["uniform_block_ms"] = cuda_ms(
        lambda: streams.uniform_block(q_keys, start, chunk, d))
    out["b1_chunk"] = b1
    log("[stream] B1 at the chunk shape " + json.dumps(b1))
    del u, res, delta, counts, strided, res_c, gu, guni, gsel
    _free_card()
    return out


# ---------------------------------------------------------------------------
# The shard path: the coordinate-sharded round engine, bitwise against the
# monolithic and stream engines, at the reference's sharded cell
# ---------------------------------------------------------------------------

#: the reference's sharded cell (benchmarks/aggregation_round.py:61-64),
#: N = 8 clients of normal**3 updates (:85, :103)
SHARD_N, SHARD_DEVICES = 8, 8
SHARD_D = 8 * 4096 * 3052          # 100,007,936: its d ~ 1e8
SHARD_TIMING_D = 8 * 4096 * 305    # 9,994,240: its timing width
SHARD_BITIDENT_D = 8 * 4096 * 30   # 983,040: its bit-identity width
SHARD_ITERS = 3                    # timed rounds (median) per cell
SHARD_MODES = (("topk", "topk"), ("topk", "block"), ("threshold", "topk"),
               ("threshold", "block"))


def _shard_cfg(vote_mode, compact_mode, engine="monolithic", devices=0):
    """A plain (kernels off) config on one engine: the sharded engine
    refuses the fused kernels, so every engine it is held against runs
    the same plain round."""
    from repro_torch.core.engines import EngineSpec
    from repro_torch.core.fediac import FediACConfig
    return FediACConfig(vote_mode=vote_mode, compact_mode=compact_mode,
                        engine=EngineSpec(name=engine, devices=devices))


def _shard_stack(d: int, seed: int):
    import torch
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(SHARD_N, d, device=DEV, generator=gen) ** 3


def _round_gates(where, u, out, cfg) -> float:
    """Shapes, finiteness, the top-k counts' sum and the conservation of
    what left the clients (the stream scale cell's gates); returns the
    conservation error."""
    import torch
    delta, res, counts, _ = out
    n, d = u.shape
    check(delta.shape == (d,) and res.shape == (n, d)
          and counts.shape == (d,), f"{where}: output shapes")
    check(bool(torch.isfinite(delta).all() and torch.isfinite(res).all()),
          f"{where}: non-finite delta or residuals")
    if cfg.vote_mode == "topk":
        check(int(counts.sum()) == n * cfg.k(d),
              f"{where}: counts sum {int(counts.sum())} != N*k")
    left = (u - res).mean(0)
    err = float((left - delta).abs().max())
    ok = bool(((left - delta).abs() <= 1e-6 + 1e-5 * delta.abs()).all())
    check(ok, f"{where}: (u - res).mean(0) vs delta off by {err}")
    return err


def phase_shard(card: str) -> dict:
    """The sharded engine on the card, every shard on it: (a) bitwise
    against the monolithic round at SHARD_BITIDENT_D in all four modes (8
    shards; 3, ragged, for top-k/top-k) and ``shard_compress_stack``
    against the stacked phase-2 compress; (b) the reference's cell at
    SHARD_D on 8 shards, threshold/block and top-k/top-k (the latter
    bitwise against the stream engine), timed, phase 1 timed, its peak
    above inputs and outputs and one shard's working set; (c) the
    shard round beside the stream and monolithic rounds at
    SHARD_TIMING_D."""
    import torch
    from repro_torch.core import fediac, prng, shard_engine, stream_engine
    from repro_torch.core.quantize import scale_factor
    out = {"card": card}
    key = prng.PRNGKey(0, device=DEV)
    n = SHARD_N

    # -- (a) bitwise against the monolithic round
    t0 = time.perf_counter()
    u = _shard_stack(SHARD_BITIDENT_D, seed=1)
    checked = []
    for vm, cm in SHARD_MODES:
        mono = fediac.aggregate_stack(u, _shard_cfg(vm, cm), key)
        for devs in ((SHARD_DEVICES, 3) if (vm, cm) == ("topk", "topk")
                     else (SHARD_DEVICES,)):
            got = fediac.aggregate_round(
                u, _shard_cfg(vm, cm, "sharded", devs), key)
            check(_same_round(got, mono), f"sharded {vm}/{cm} on {devs} "
                  f"shards != monolithic at N={n}, d={SHARD_BITIDENT_D}")
            checked.append(f"{vm}/{cm} devices={devs}")
        del mono, got
    keys = prng.split(key, 2 * n)
    sf = torch.tensor(scale_factor(12, n, 1.0), device=DEV)
    f = sf / torch.clamp_min(u.abs().max(), 1e-12)
    for vm, cm in (("topk", "topk"), ("threshold", "block")):
        cfg = _shard_cfg(vm, cm)
        topk = cm == "topk"
        plan = fediac.build_round_plan(
            fediac._vote_counts_stack(u, cfg, keys[:n]), cfg, n,
            with_dense_mask=topk, with_slot_map=topk)
        got = shard_engine.shard_compress_stack(u, cfg, f, keys[n:], plan,
                                                devices=SHARD_DEVICES)
        want = fediac.phase2_compress(cfg)(u, cfg, f, keys[n:], plan)
        check(same_bits(got[0], want[0]) and same_bits(got[1], want[1]),
              f"shard_compress_stack {cm} != phase2_compress")
        checked.append(f"shard_compress_stack {cm}")
    out["bitwise_at"] = {"n": n, "d": SHARD_BITIDENT_D, "checked": checked,
                         "seconds": time.perf_counter() - t0}
    log(f"[shard] {card}: N={n} d={SHARD_BITIDENT_D}: bitwise {checked}")
    del u, got, want, plan
    _free_card()

    # -- (b) the scale cell: N = 8, d = SHARD_D, 8 shards on the one card
    u = _shard_stack(SHARD_D, seed=0)
    s = shard_engine.shard_geometry(SHARD_D, SHARD_DEVICES,
                                    _shard_cfg("topk", "topk"))[0]
    # the round's outputs: residuals [N, d], delta and counts [d]
    out_gib = (u.numel() * 4 + SHARD_D * 8) / 2**30
    out["scale"] = {}
    for vm, cm in (("threshold", "block"), ("topk", "topk")):
        cfg = _shard_cfg(vm, cm, "sharded", SHARD_DEVICES)
        name = f"{vm}_{cm}"
        t_cell = time.perf_counter()
        got, peak, extra = _peak_gib(
            lambda: fediac.aggregate_round(u, cfg, key))
        # the gated run is the first timed round
        times = [(time.perf_counter() - t_cell) * 1e3]
        cons = _round_gates(f"shard {name} d={SHARD_D}", u, got, cfg)
        cell = {"n": n, "d": SHARD_D, "devices": SHARD_DEVICES,
                "shard_width": s, "conservation_err": cons,
                "counts_sum": int(got[2].sum())}
        if vm == "topk":
            plain = _shard_cfg(vm, cm)
            want = stream_engine.aggregate_stream(u, plain, key)
            check(_same_round(got, want), f"sharded {name} != the stream "
                  f"engine at N={n}, d={SHARD_D}")
            cell["bitwise_vs_stream"] = True
            del want
        del got
        _free_card()
        for _ in range(SHARD_ITERS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fediac.aggregate_round(u, cfg, key)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        round_ms = sorted(times)[SHARD_ITERS // 2]
        shards = shard_engine._shards(u, SHARD_DEVICES, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if vm == "topk":
            shard_engine._phase1_topk(shards, keys[:n], cfg.k(SHARD_D),
                                      SHARD_D)
        else:
            shard_engine._phase1_threshold(shards, cfg, cfg.k(SHARD_D))
        torch.cuda.synchronize()
        cell["phase1_ms"] = (time.perf_counter() - t0) * 1e3
        del shards
        # not profiled: profiling a 1e8 round costs 35-75 s of the
        # script's time limit (PERF.md section 5 keeps the last readings:
        # threshold/block idle 30.7%), and the top-k cell is held bitwise
        # to the stream scale cell, which the stream phase profiles

        # one shard's working set: the same round on one shard of width S
        # (what one device of an 8-device mesh holds), above its own
        # inputs and outputs
        one = u[:, :s]
        _, _, one_extra = _peak_gib(lambda: shard_engine.aggregate_shard(
            one, cfg, key, devices=1))
        one_io = (one.numel() * 4 + s * 8) / 2**30
        cell.update({
            "round_ms": round_ms, "round_ms_all": times,
            "peak_gib": peak, "peak_above_inputs_gib": extra,
            "peak_above_inputs_and_outputs_gib": extra - out_gib,
            "one_shard_working_set_gib": one_extra - one_io,
            "input_gib": u.numel() * 4 / 2**30,
            "seconds": time.perf_counter() - t_cell})
        out["scale"][name] = cell
        log(f"[shard] {card}: scale cell {name} " + json.dumps(cell))
        _free_card()
    del u
    _free_card()

    # -- (c) the shard round beside the stream and monolithic rounds
    t0 = time.perf_counter()
    u = _shard_stack(SHARD_TIMING_D, seed=2)
    out["timing"] = {"n": n, "d": SHARD_TIMING_D}
    for vm, cm in (("topk", "topk"), ("threshold", "block")):
        out["timing"][f"{vm}_{cm}"] = {
            eng: wall_ms(lambda: fediac.aggregate_round(
                u, _shard_cfg(vm, cm, eng, SHARD_DEVICES if eng == "sharded"
                              else 0), key))
            for eng in ("sharded", "stream", "monolithic")}
    out["timing"]["seconds"] = time.perf_counter() - t0
    log(f"[shard] {card}: round ms at N={n} d={SHARD_TIMING_D}, kernels "
        f"off: " + json.dumps(out["timing"]))
    del u
    _free_card()
    return out


# ---------------------------------------------------------------------------
# The packet path: FediAC rounds as packet streams through the switches
# (netsim/batched.py's round core behind PacketTransport), on every engine
# and in the FL loop
# ---------------------------------------------------------------------------

#: the lossy dataplane of the packet phase's checks: 5% loss, half the
#: clients sampled, a quarter of them straggling, two leaf switches and a
#: register bank smaller than the round's 50,000-slot consensus buffer (two
#: passes); the vote deadline is set per shape (_vote_median)
PACKET_NET = dict(loss=0.05, participation=0.5, straggler_frac=0.25,
                  n_leaves=2, memory_slots=32_768, seed=9)
#: the card's packet round against the CPU's: the mean wait sums float32
#: waits in another order on each device, within 1e-6 relative; every other
#: output, the clock included, is held bitwise
PACKET_TIME_RTOL = 1e-6
#: the reference's dataplane FL task (src/repro/sweep/grids.py:84-93): fediac
#: a = 2, 12 bits, 10 clients, 3 local steps, Dirichlet beta 0.5, 3,000
#: samples of dimension 32, a quarter held out, 12 rounds
PACKET_FL_ROUNDS, PACKET_FL_KILL = 12, 6
PACKET_FL_LOSSY = dict(loss=0.05, participation=0.5)
PACKET_TIME_ITERS = 3


def _packet_cfg(vote_mode="topk", compact_mode="topk", vote_chunk=1,
                engine="monolithic", kernels=True, devices=0):
    from repro_torch.core.engines import EngineSpec
    from repro_torch.core.fediac import FediACConfig
    return FediACConfig(vote_mode=vote_mode, compact_mode=compact_mode,
                        vote_chunk=vote_chunk,
                        engine=EngineSpec(name=engine, devices=devices,
                                          use_pallas=kernels))


def _vote_median(n: int, d: int, seed: int, round_idx: int = 0,
                 local_train_s: float = 0.1) -> float:
    """The median arrival of the vote packets of the lossless round (every
    client sampled, none straggling) under net seed ``seed``: a deadline
    there cuts about half of them."""
    from repro_torch.core import prng
    from repro_torch.core.fediac import FediACConfig, round_traffic
    from repro_torch.netsim.policies import net_round_key
    from repro_torch.netsim.timeline import poisson_arrivals
    from repro_torch.switch import client_rates, n_packets
    p1 = n_packets(round_traffic(FediACConfig(), d).phase1_bytes)
    k_arr1 = prng.split(net_round_key(seed, round_idx, device=DEV), 6)[2]
    arr = poisson_arrivals(k_arr1, client_rates(n, seed), p1, local_train_s)
    return float(arr.reshape(-1).sort().values[arr.numel() // 2])


@contextlib.contextmanager
def _quant_tally(by_kernel: dict,
                 names: tuple = ("gather_quant", "stoch_quant")):
    """Tally the launches of the kernels ``names`` calls through
    ``kernels.ops`` (by default B1, ``gather_quant``, and B2,
    ``stoch_quant``) by operand shape while the block runs, as
    :func:`_b1_tally` does B1's."""
    from repro_torch.kernels import ops
    real = {name: getattr(ops, name) for name in names}

    def tallied(name, fn):
        def call(u, *args, **kw):
            before = fn.launches
            res = fn(u, *args, **kw)
            rose = fn.launches - before
            if rose:
                shapes = by_kernel.setdefault(name, {})
                k = str(list(u.shape))
                shapes[k] = shapes.get(k, 0) + rose
            return res
        return call

    for name, fn in real.items():
        setattr(ops, name, tallied(name, fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


class _QuantCounter:
    """Runs ``fn()`` with the B1 (``gather_quant``) and B2
    (``stoch_quant``) counts zeroed just before and read just after,
    returning ``(fn(), launches, launches by shape)``, and adds both to
    its phase's tallies (``launches``, ``tally``)."""

    def __init__(self):
        self.counters = _counters()
        self.launches = {"gather_quant": 0, "stoch_quant": 0}
        self.tally = {}

    def __call__(self, fn):
        import torch
        for name in self.launches:
            self.counters[name].launches = 0
        by_shape = {}
        with _quant_tally(by_shape):
            res = fn()
        torch.cuda.synchronize()
        rose = {name: self.counters[name].launches for name in self.launches}
        for name, shapes in by_shape.items():
            check(sum(shapes.values()) == rose[name],
                  f"{name}: {rose[name]} launches, by shape {shapes}")
            for k, v in shapes.items():
                self.tally.setdefault(name, {})
                self.tally[name][k] = self.tally[name].get(k, 0) + v
        for name, v in rose.items():
            self.launches[name] += v
        return res, rose, by_shape


def _packet_round(cfg, net, u, key, round_idx=0):
    from repro_torch.netsim import PacketTransport
    return PacketTransport("fediac", {"cfg": cfg}, net=net).round(
        u, None, key, round_idx)


def _packet_gates(where, got, want, *, times_exact=True) -> dict:
    """``got``'s packet round against ``want``'s: delta, residuals, vote
    counts, masks, the integer statistics, phase 1's clock and the upload
    bytes bitwise; the wall-clock and phase 2's clock bitwise when
    ``times_exact`` (else within PACKET_TIME_RTOL), the mean wait within
    PACKET_TIME_RTOL.  Returns the relative gaps of the float times."""
    import numpy as np
    check(same_bits(got.delta, want.delta)
          and same_bits(got.residuals, want.residuals),
          f"{where}: delta / residuals differ")
    for k in ("vote_counts", "participants", "uploaders"):
        a, b = got.stats[k], want.stats[k]
        check(a.shape == b.shape and bool(np.array_equal(a, b)),
              f"{where}: {k} differ")
    for k in ("votes_lost", "stragglers", "retransmissions", "passes",
              "peak_live_slots", "aggregation_ops", "phase1_s"):
        check(got.stats[k] == want.stats[k],
              f"{where}: {k} {got.stats[k]} != {want.stats[k]}")
    check(got.upload_bytes == want.upload_bytes
          and got.n_active == want.n_active and got.traffic == want.traffic
          and got.load == want.load, f"{where}: bytes / uploaders differ")
    gaps = {}
    for k, a, b in (("wall_clock_s", got.wall_clock_s, want.wall_clock_s),
                    ("phase2_s", got.stats["phase2_s"],
                     want.stats["phase2_s"]),
                    ("mean_wait_s", got.stats["mean_wait_s"],
                     want.stats["mean_wait_s"])):
        gaps[k] = abs(a - b) / max(abs(b), 1e-30)
        exact = times_exact and k != "mean_wait_s"
        check(a == b if exact else gaps[k] <= PACKET_TIME_RTOL,
              f"{where}: {k} {a!r} vs {b!r}")
    return gaps


def _close_clock(a, b) -> bool:
    """Two FL runs' cumulative simulated clocks within PACKET_TIME_RTOL."""
    return len(a) == len(b) and all(
        abs(x - y) <= PACKET_TIME_RTOL * abs(y) for x, y in zip(a, b))


def _packet_fl_task():
    from repro_torch.data import classification, partition_dirichlet
    data = classification(n=3000, dim=32, n_classes=10, seed=0)
    train, test = data.test_split(0.25)
    return partition_dirichlet(train, 10, beta=0.5, seed=0), test


def _packet_fl_cfg(transport="packet", aggregator="fediac", rounds=None,
                   **net_kw):
    from repro_torch.core.engines import EngineSpec
    from repro_torch.core.fediac import FediACConfig
    from repro_torch.netsim import NetConfig
    from repro_torch.training.fl_loop import FLConfig
    agg = ({"cfg": FediACConfig(a=2, bits=12)} if aggregator == "fediac"
           else {"bits": 12} if aggregator == "switchml" else {})
    return FLConfig(n_clients=10, rounds=rounds or PACKET_FL_ROUNDS,
                    local_steps=3, aggregator=aggregator, agg_kwargs=agg,
                    engine=(EngineSpec(use_pallas=True)
                            if aggregator == "fediac" else None),
                    transport=transport,
                    net=NetConfig(**net_kw) if transport == "packet" else None)


def _timeline_only(net, n, d, key, rates):
    """The packet round's timeline alone at the round's shapes: phase 1's
    vote arrivals, loss, deadline and drain, phase 2's reliable upload
    through the windows and leaves (every client an uploader)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.fediac import round_traffic
    from repro_torch.netsim.batched import reliable_upload
    from repro_torch.netsim.hierarchy import leaf_assignment
    from repro_torch.netsim.timeline import (_masked_drain, deadline_mask,
                                             lose_packets, poisson_arrivals,
                                             service_time)
    from repro_torch.switch import SwitchProfile, n_packets
    tr = round_traffic(_packet_cfg(), d)
    p1 = n_packets(tr.phase1_bytes, net.mtu)
    ks = prng.split(prng.fold_in(key, 0), 6)
    svc = torch.tensor(service_time(SwitchProfile.high()), device=DEV)
    start = torch.full((n,), 0.1, device=DEV)
    arr1 = poisson_arrivals(ks[2], rates, p1, start)
    deliv = lose_packets(ks[3], arr1.shape, net.loss)
    if net.vote_deadline_s is not None:
        deliv = deliv & deadline_mask(arr1, net.vote_deadline_s)
    st1 = _masked_drain(torch.where(deliv, arr1, float("inf")), svc)
    return reliable_upload(
        ks[4], ks[5], rates, st1.completion_s, tr.selected, tr.phase2_bytes,
        leaf_assignment(n, net.n_leaves), svc, loss=net.loss,
        rto_s=net.rto_s, max_retries=net.max_retries,
        memory_slots=net.memory_slots, n_leaves=net.n_leaves, mtu=net.mtu,
        not_before=st1.completion_s)


def phase_packet(card: str) -> dict:
    """The packet dataplane on the card: (a) the lossless packet round at
    N_CLIENTS x D in all four vote x compact modes with the kernels on, and
    at vote_chunk 4 (B2), each bitwise its ``aggregate_stack``; (b) the
    lossy round (PACKET_NET, a deadline at the median vote arrival) card
    against CPU; (c) the stream engine (kernels on) and the sharded engine
    (8 shards, kernels off) under the lossy dataplane at 8 x
    SHARD_TIMING_D, bitwise the monolithic packet round; (d) the FL loop on
    the packet transport: lossless equal to the memory transport, lossy
    card against CPU, killed at round PACKET_FL_KILL and resumed, and the
    five baselines one round each; (e) round times, the timeline's share,
    the idle share and launches per round.  The B1 and B2 counts are zeroed
    just before each packet run and read just after, tallied by shape."""
    import torch
    from repro_torch.core import fediac, prng, stream_engine
    from repro_torch.netsim import NetConfig
    from repro_torch.switch import client_rates
    from repro_torch.training.fl_loop import run_federated
    out = {"card": card}
    counted = _QuantCounter()
    launches, tally = counted.launches, counted.tally

    # -- (a) lossless, full width: bitwise aggregate_stack
    t0 = time.perf_counter()
    key = prng.PRNGKey(0, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    u = torch.randn(N_CLIENTS, D, device=DEV, generator=gen) ** 3
    lossless = NetConfig()
    cases = [(vm, cm, 1) for vm, cm in SHARD_MODES] + [("topk", "topk", 4)]
    checked = []
    for vm, cm, g in cases:
        cfg = _packet_cfg(vm, cm, g)
        got, rose, _ = counted(lambda: _packet_round(cfg, lossless, u, key))
        want_b1 = int(g == 1 and cm == "topk")
        want_b2 = int(g > 1)
        check(rose == {"gather_quant": want_b1, "stoch_quant": want_b2},
              f"packet {vm}/{cm} g={g}: launches {rose}")
        delta, res, counts, traffic = fediac.aggregate_stack(u, cfg, key)
        check(same_bits(got.delta, delta) and same_bits(got.residuals, res)
              and bool((torch.from_numpy(got.stats["vote_counts"])
                        == counts.cpu()).all()) and got.traffic == traffic,
              f"packet {vm}/{cm} g={g} lossless != aggregate_stack at "
              f"N={N_CLIENTS}, d={D}")
        checked.append(f"{vm}/{cm} g={g}")
        del got, delta, res, counts
    out["lossless"] = {"n": N_CLIENTS, "d": D, "bitwise_vs_stack": checked,
                       "seconds": time.perf_counter() - t0}
    log(f"[packet] {card}: lossless packet rounds bitwise aggregate_stack "
        f"at N={N_CLIENTS} d={D}: {checked}")

    # -- (b) lossy: the card's round against the CPU's
    t0 = time.perf_counter()
    cfg = _packet_cfg()
    deadline = _vote_median(N_CLIENTS, D, PACKET_NET["seed"], round_idx=1)
    lossy = NetConfig(**PACKET_NET, vote_deadline_s=deadline)
    card_r, _, _ = counted(lambda: _packet_round(cfg, lossy, u, key, 1))
    free, _, _ = counted(lambda: _packet_round(
        cfg, NetConfig(**PACKET_NET), u, key, 1))
    missed = card_r.stats["votes_lost"] - free.stats["votes_lost"]
    check(missed > 0, f"the deadline {deadline} s cut no vote packets")
    check(card_r.stats["passes"] > 1 and 0 < card_r.n_active < N_CLIENTS,
          f"lossy round: passes {card_r.stats['passes']}, "
          f"{card_r.n_active} uploaders")
    lossy_out = out["lossy"] = {
        "n": N_CLIENTS, "d": D, "net": PACKET_NET, "vote_deadline_s": deadline,
        "votes_missed_deadline": missed,
        "votes_lost": card_r.stats["votes_lost"],
        "uploaders": card_r.n_active, "passes": card_r.stats["passes"],
        "retransmissions": card_r.stats["retransmissions"],
        "wall_clock_s": card_r.wall_clock_s,
        "seconds": time.perf_counter() - t0}

    # the same round on the CPU side, the gates when it settles
    def gate(cpu_r, seconds, card_r=dataclasses.replace(
            card_r, delta=card_r.delta.cpu(),
            residuals=card_r.residuals.cpu())):
        lossy_out["time_rel_gaps"] = _packet_gates(
            "lossy packet round card vs CPU", card_r, cpu_r,
            times_exact=False)
        lossy_out["cpu_round_s"] = seconds
        log(f"[packet] {card}: lossy round card == CPU "
            + json.dumps(lossy_out))

    SIDE.submit("packet lossy", gate, _packet_round, cfg, lossy,
                SIDE.put(u.cpu()), SIDE.put(key.cpu()), 1)
    del free

    # -- (e, first half) times at N_CLIENTS x D
    rates = torch.as_tensor(client_rates(N_CLIENTS, PACKET_NET["seed"]),
                            dtype=torch.float32, device=DEV)
    timing = {}
    for name, net in (("lossless", lossless), ("lossy", lossy)):
        pkt_ms = wall_ms(lambda: _packet_round(cfg, net, u, key, 1),
                         iters=PACKET_TIME_ITERS)
        rows = device_profile(lambda: _packet_round(cfg, net, u, key, 1),
                              iters=1)
        busy = sum(r[1] for r in rows)
        timing[name] = {
            "packet_round_ms": pkt_ms,
            "timeline_ms": wall_ms(lambda: _timeline_only(net, N_CLIENTS, D,
                                                          key, rates),
                                   iters=PACKET_TIME_ITERS),
            "device_ms": busy,
            "idle_share": 1.0 - busy / pkt_ms if rows else None,
            "device_launches": sum(r[2] for r in rows),
            "top_kernels": [(nm[:60], ms, c) for nm, ms, c in rows[:6]]}
        timing[name]["timeline_share"] = (timing[name]["timeline_ms"]
                                          / pkt_ms)
    timing["aggregate_stack_ms"] = wall_ms(
        lambda: fediac.aggregate_stack(u, cfg, key), iters=PACKET_TIME_ITERS)
    out["timing"] = timing
    log(f"[packet] {card}: times at N={N_CLIENTS} d={D} "
        + json.dumps(timing))
    del u, card_r
    _free_card()

    # -- (c) the stream and sharded engines under the lossy dataplane
    t0 = time.perf_counter()
    n, d = SHARD_N, SHARD_TIMING_D
    u8 = _shard_stack(d, seed=3)
    net8 = NetConfig(**PACKET_NET, vote_deadline_s=_vote_median(
        n, d, PACKET_NET["seed"], round_idx=2))
    engines_checked = []
    for engine, kernels, devs in (("stream", True, 0),
                                  ("sharded", False, SHARD_DEVICES)):
        mono = _packet_round(_packet_cfg(kernels=kernels), net8, u8, key, 2)
        got, rose, by_shape = counted(lambda: _packet_round(
            _packet_cfg(engine=engine, kernels=kernels, devices=devs), net8,
            u8, key, 2))
        _packet_gates(f"packet {engine} engine vs monolithic N={n} d={d}",
                      got, mono)
        want = (_chunk_shapes(n, d, stream_engine.DEFAULT_CHUNK) if kernels
                else {})
        check(by_shape.get("gather_quant", {}) == want
              and rose["stoch_quant"] == 0,
              f"packet {engine}: B1 launched by shape {by_shape}, not {want}")
        engines_checked.append(f"{engine} (kernels {'on' if kernels else 'off'}"
                               f", uploaders {got.n_active})")
        del mono, got
    out["engines"] = {"n": n, "d": d, "bitwise_vs_monolithic": engines_checked,
                      "seconds": time.perf_counter() - t0}
    log(f"[packet] {card}: N={n} d={d}: {engines_checked} bitwise the "
        "monolithic packet round")
    del u8
    _free_card()

    # -- (d) the FL loop on the packet transport
    t0 = time.perf_counter()
    clients, test = _packet_fl_task()

    def run(cfg, dev=DEV, **kw):
        return run_federated(clients, test, cfg, device=dev, **kw)

    h_pkt, rose, _ = counted(lambda: run(_packet_fl_cfg()))
    check(rose["gather_quant"] == PACKET_FL_ROUNDS,
          f"FL on packets launched B1 {rose['gather_quant']} times")
    h_mem = run(_packet_fl_cfg(transport="memory"))
    check(h_pkt.acc == h_mem.acc and h_pkt.loss == h_mem.loss
          and h_pkt.traffic_mb == h_mem.traffic_mb,
          "FL on the lossless packet transport != the memory transport")
    rec = _Recorder()
    h_lossy, _, _ = counted(lambda: run(_packet_fl_cfg(**PACKET_FL_LOSSY),
                                        wrap_transport=rec.wrap))
    h_cpu = run(_packet_fl_cfg(**PACKET_FL_LOSSY), dev="cpu")
    h_fed = run(_packet_fl_cfg(**PACKET_FL_LOSSY), dev="cpu",
                wrap_transport=lambda inner: _CardInputs(inner, "packet",
                                                         rec.rounds))
    for where, h in (("independent", h_cpu), ("fed the card's inputs",
                                              h_fed)):
        check(_close_clock(h.wall_clock, h_lossy.wall_clock)
              and h.traffic_mb == h_lossy.traffic_mb,
              f"lossy packet FL card vs CPU ({where}): clock / traffic")
        gap = max(max(abs(a - b) for a, b in zip(h.acc, h_lossy.acc)),
                  max(abs(a - b) for a, b in zip(h.loss, h_lossy.loss)))
        check(gap <= FL_TOL, f"lossy packet FL card vs CPU ({where}): "
              f"acc/loss gap {gap}")
        out.setdefault("fl_gaps", {})[where] = gap
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "packet.ckpt")
        killed, _, _ = counted(lambda: run(dataclasses.replace(
            _packet_fl_cfg(rounds=PACKET_FL_KILL, **PACKET_FL_LOSSY),
            ckpt_path=path)))
        resumed, _, _ = counted(lambda: run(dataclasses.replace(
            _packet_fl_cfg(**PACKET_FL_LOSSY), ckpt_path=path, resume=True)))
    check(len(killed) == PACKET_FL_KILL and _same_history(resumed, h_lossy),
          "lossy packet FL killed and resumed != the uninterrupted run")
    baselines = {}
    for name in BASELINES:
        cfg_b = _packet_fl_cfg(aggregator=name, rounds=1, **PACKET_FL_LOSSY)
        h_b = run(cfg_b)
        h_bc = run(cfg_b, dev="cpu")
        check(_close_clock(h_b.wall_clock, h_bc.wall_clock)
              and h_b.traffic_mb == h_bc.traffic_mb
              and abs(h_b.acc[0] - h_bc.acc[0]) <= FL_TOL
              and all(math.isfinite(x) for x in h_b.loss),
              f"packet FL {name}: card vs CPU")
        baselines[name] = {"wall_clock_s": h_b.wall_clock[0],
                           "traffic_mb": h_b.traffic_mb[0]}
    out["fl"] = {"rounds": PACKET_FL_ROUNDS, "lossless_acc": h_pkt.acc,
                 "lossless_wall_clock": h_pkt.wall_clock,
                 "memory_wall_clock": h_mem.wall_clock,
                 "lossy_acc": h_lossy.acc, "lossy_wall_clock":
                 h_lossy.wall_clock, "lossy_traffic_mb": h_lossy.traffic_mb,
                 "resumed_at": PACKET_FL_KILL, "baselines_one_round":
                 baselines, "seconds": time.perf_counter() - t0}
    log(f"[packet] {card}: FL on packets " + json.dumps(out["fl"]))

    out["launches"] = launches
    out["launches_by_shape"] = tally
    out["launches_per_round"] = {
        k: v["device_launches"] for k, v in timing.items()
        if isinstance(v, dict)}
    log(f"[packet] {card}: B1/B2 launches {launches} by shape {tally}")
    return out


# ---------------------------------------------------------------------------
# The chaos and robust paths: the packet round under faults
# (netsim/faults.py) and under Byzantine attack answered by the switch-side
# defenses (robust/), behind PacketTransport and the FL loop
# ---------------------------------------------------------------------------

#: the chaos grid's chaos-burst-crash fault rates (src/repro/sweep/grids.py)
STORM_RATES = dict(ge_p_gb=0.05, ge_p_bg=0.4, ge_loss_bad=0.8,
                   crash_rate=0.1, dup_rate=0.1, reorder_jitter_s=0.002)
#: the attack grid's full attack and its defenses (attack-full-defended);
#: the defended close trims TRIM_FRAC per side.  The grid's vote budget,
#: 1,000 at its 13,130 coordinates whose honest top-k is 657 votes, is
#: scaled by that ratio to the round's honest top-k (GRID_BUDGET)
ATTACK = dict(byzantine_frac=0.25, collusion_frac=0.2, vote_stuff_frac=0.3,
              poison_scale=-8.0)
DEFENSE = dict(clip_ticks=1024, rep_threshold=2.0, rep_z_thresh=2.0,
               quarantine_rounds=3)
TRIM_FRAC = 0.2
GRID_BUDGET = (1000, 657)
#: the card-vs-CPU width of the storm and the defended attack
FAULTS_CHECK_D = 131_072
#: the dedup contract's duplicate rates
DUP_RATES = (0.0, 0.9)
#: the FL cells: the chaos grid and the attack grid (grids.py), 10 rounds,
#: the defended cell killed after round FAULTS_FL_KILL and resumed
CHAOS_CELLS = {"chaos-clean": {},
               "chaos-ge": dict(ge_p_gb=0.05, ge_p_bg=0.4, ge_loss_bad=0.8),
               "chaos-crash": dict(crash_rate=0.1, crash_p2_frac=0.5),
               "chaos-dup": dict(dup_rate=0.15),
               "chaos-burst-crash": STORM_RATES}
ATTACK_CELLS = {"attack-clean": {},
                "attack-stuff": dict(byzantine_frac=0.25, collusion_frac=0.2,
                                     vote_stuff_frac=0.3),
                "attack-poison": dict(byzantine_frac=0.25, poison_scale=-8.0),
                "attack-full": ATTACK,
                "attack-full-defended": dict(ATTACK, **DEFENSE,
                                             vote_budget=GRID_BUDGET[0],
                                             trim_frac=TRIM_FRAC)}
FAULTS_FL_ROUNDS, FAULTS_FL_KILL = 10, 5
#: the grids' network seed.  Byzantine membership is one uniform per client
#: off the run key; at the grids' seed 0 no one of the 10 clients draws
#: below byzantine_frac (0.25) under jax's partitionable threefry, which the
#: port replays, so the attack cells would carry no attack.  Seed 8 is the
#: smallest whose cohort has the shape of the reference's recorded run
#: (BENCH_robust.json, drawn before partitionable threefry): one Byzantine
#: client of ten, not colluding.  FAULTS_FL_SEED_2 (seed 1, two colluding
#: clients) is run beside it and gated at SEED_2_FLOOR
FAULTS_FL_NET_SEED, FAULTS_FL_SEED_2 = 8, 1
#: the reference benchmark's defense gates (benchmarks/robust.py): the
#: defended run's final accuracy at least DEFENSE_FLOOR of the clean run's,
#: the undefended attack's at most ATTACK_CEILING of it
DEFENSE_FLOOR, ATTACK_CEILING = 0.9, 0.5
#: at FAULTS_FL_SEED_2 the reference's own defense reaches 0.8924 of clean
#: on the CPU, below DEFENSE_FLOOR; the floor there is that ratio less about
#: six test samples of 750 (tests/test_torch_adversary.py, SEED_1_FLOOR)
SEED_2_FLOOR = 0.88


def _storm_net(n: int, **kw):
    """The storm: PACKET_NET's lossy dataplane with the burst-crash rates,
    a quorum floor of a quarter of the clients (8 of 32) and the rescale
    register close."""
    from repro_torch.netsim import FaultConfig
    return FaultConfig(**{**PACKET_NET, **STORM_RATES, "quorum_floor": n // 4,
                          "register_policy": "rescale", **kw})


def _attack_net(cfg, d: int, **kw):
    """The defended attack under the storm's faults: the attack grid's
    full attack and defenses, the vote budget scaled to the round's honest
    top-k (GRID_BUDGET)."""
    from repro_torch.robust import AdversaryConfig
    budget = math.ceil(GRID_BUDGET[0] * cfg.k(d // cfg.vote_chunk)
                       / GRID_BUDGET[1])
    return AdversaryConfig(**{**PACKET_NET, **STORM_RATES, **ATTACK,
                              **DEFENSE, "vote_budget": budget, **kw})


def _defended_cfg(cfg):
    return dataclasses.replace(cfg, robust_agg="trim", trim_frac=TRIM_FRAC)


def _extra_stats(r) -> dict:
    from repro_torch.netsim.faults import CHAOS_STAT_FIELDS
    from repro_torch.robust import ROBUST_STAT_FIELDS
    return {k: r.stats[k] for k in CHAOS_STAT_FIELDS + ROBUST_STAT_FIELDS
            if k in r.stats}


def _fault_gates(where, got, want, *, times_exact=True) -> dict:
    """:func:`_packet_gates` plus the chaos and robust statistics both
    rounds report and the reputation state, bitwise."""
    gaps = _packet_gates(where, got, want, times_exact=times_exact)
    a, b = _extra_stats(got), _extra_stats(want)
    common = a.keys() & b.keys()
    check(all(a[k] == b[k] for k in common),
          f"{where}: chaos / robust stats {a} != {b}")
    check(got.state is None or want.state is None
          or same_bits(got.state, want.state),
          f"{where}: reputation state differs")
    return gaps


def _zero_extras(where, r) -> None:
    extras = _extra_stats(r)
    check(all(v == (1 if k == "attempts" else 0) for k, v in extras.items()),
          f"{where}: a zero-knob round reports {extras}")


def _grid_fl_cfg(name: str, rounds=FAULTS_FL_ROUNDS, plain=False,
                 seed=FAULTS_FL_NET_SEED):
    """One cell of the chaos or attack grid as the FL task the reference's
    sweep runs (``ScenarioSpec.to_flconfig``): PACKET_FL's task and
    FediAC a = 2, 12 bits, on a FaultConfig (the chaos grid) or an
    AdversaryConfig with the trim close (the attack grid); ``plain`` gives
    the same task on a plain NetConfig and the sum close; ``seed`` the
    network seed.  The kernels on."""
    from repro_torch.core.engines import EngineSpec
    from repro_torch.core.fediac import FediACConfig
    from repro_torch.netsim import FaultConfig, NetConfig
    from repro_torch.robust import AdversaryConfig
    from repro_torch.training.fl_loop import FLConfig
    knobs = dict(CHAOS_CELLS.get(name, ATTACK_CELLS.get(name, {})))
    trim = knobs.pop("trim_frac", 0.0)
    cfg = FediACConfig(a=2, bits=12)
    if plain:
        net = NetConfig(seed=seed)
    elif name in CHAOS_CELLS:
        net = FaultConfig(seed=seed, **knobs)
    else:
        net = AdversaryConfig(seed=seed, **knobs)
        cfg = dataclasses.replace(cfg, robust_agg="trim", trim_frac=trim)
    return FLConfig(n_clients=10, rounds=rounds, local_steps=3,
                    aggregator="fediac", agg_kwargs={"cfg": cfg},
                    engine=EngineSpec(use_pallas=True), transport="packet",
                    net=net)


def phase_faults(card: str) -> dict:
    """The chaos and robust cores on the card: (a) at N_CLIENTS x D with
    the kernels on, under PACKET_NET and a deadline at the median vote
    arrival, a zero-knob FaultConfig bitwise the plain packet round with
    each register policy, a zero-knob AdversaryConfig bitwise that chaos
    round in top-k/top-k and threshold/block, and all three at vote_chunk
    4 (B2); (b) the storm and the defended attack at N_CLIENTS x D, each
    at its duplicate rate and at DUP_RATES (delta, residuals and counts
    unmoved by duplicates), then both at FAULTS_CHECK_D card against CPU;
    (c) the storm on the stream engine (kernels on) and the sharded engine
    (8 shards) at 8 x SHARD_TIMING_D, bitwise the monolithic chaos round;
    (d) the chaos and attack grids as FL tasks: the clean cells bitwise
    the plain packet run, the defense gates, two cells card against CPU,
    the defended cell killed and resumed; (e) round times against the
    plain packet round, the Gilbert–Elliott chain's share, the idle share
    and the launches per round.  The B1 and B2 counts are zeroed just
    before each run and read just after, tallied by shape."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import load_run_state
    from repro_torch.core import prng, stream_engine
    from repro_torch.core.fediac import round_traffic
    from repro_torch.netsim import FaultConfig, NetConfig
    from repro_torch.netsim.faults import _ge_loss_probability
    from repro_torch.robust import AdversaryConfig
    from repro_torch.switch import n_packets
    from repro_torch.training.fl_loop import run_federated
    out = {"card": card}
    counted = _QuantCounter()

    # -- (a) zero knobs at full width: chaos == plain, robust == chaos
    t0 = time.perf_counter()
    key = prng.PRNGKey(0, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    u = torch.randn(N_CLIENTS, D, device=DEV, generator=gen) ** 3
    deadline = _vote_median(N_CLIENTS, D, PACKET_NET["seed"], round_idx=1)
    base = dict(PACKET_NET, vote_deadline_s=deadline)
    checked = []
    rounds = {}
    for vm, cm, g in (("topk", "topk", 1), ("threshold", "block", 1),
                      ("topk", "topk", 4)):
        cfg = _packet_cfg(vm, cm, g)
        want = {"gather_quant": int(g == 1 and cm == "topk"),
                "stoch_quant": int(g > 1)}
        where = f"{vm}/{cm} g={g}"

        def run(net):
            res, rose, _ = counted(lambda: _packet_round(cfg, net, u, key, 1))
            check(rose == want, f"faults {where}: launches {rose}")
            return res

        plain = run(NetConfig(**base))
        policies = (("wrap", "saturate", "rescale") if (vm, g) == ("topk", 1)
                    else ("wrap",))
        for policy in policies:
            chaos = run(FaultConfig(**base, register_policy=policy))
            _fault_gates(f"zero-fault chaos {where} {policy} vs plain",
                         chaos, plain)
            _zero_extras(f"chaos {where} {policy}", chaos)
            if policy == "wrap":
                chaos_wrap = chaos
            checked.append(f"chaos {where} {policy} == plain")
        robust = run(AdversaryConfig(**base))
        _fault_gates(f"zero-adversary robust {where} vs chaos", robust,
                     chaos_wrap)
        _zero_extras(f"robust {where}", robust)
        checked.append(f"robust {where} == chaos")
        if (vm, cm, g) == ("topk", "topk", 1):
            rounds = {"plain": plain, "chaos": chaos_wrap, "robust": robust}
        del plain, chaos, chaos_wrap, robust
    out["zero_knobs"] = {"n": N_CLIENTS, "d": D, "vote_deadline_s": deadline,
                         "bitwise": checked,
                         "uploaders": rounds["plain"].n_active,
                         "seconds": time.perf_counter() - t0}
    log(f"[faults] {card}: zero knobs at N={N_CLIENTS} d={D}: {checked}")

    # -- (b) the storm and the defended attack at full width, then card
    # against CPU at FAULTS_CHECK_D
    t0 = time.perf_counter()
    cfg = _packet_cfg()
    att_cfg = _defended_cfg(cfg)
    storm = _storm_net(N_CLIENTS)
    attack = _attack_net(cfg, D)
    faulty = {}
    for name, c, net in (("storm", cfg, storm), ("attack", att_cfg, attack)):
        runs = {}
        for rate in (net.dup_rate,) + DUP_RATES:
            runs[rate], rose, _ = counted(lambda: _packet_round(
                c, dataclasses.replace(net, dup_rate=rate), u, key, 1))
            check(rose == {"gather_quant": 1, "stoch_quant": 0},
                  f"{name} dup_rate={rate}: launches {rose}")
        r0 = runs[net.dup_rate]
        for rate, r in runs.items():
            check(same_bits(r.delta, r0.delta)
                  and same_bits(r.residuals, r0.residuals)
                  and bool(np.array_equal(r.stats["vote_counts"],
                                          r0.stats["vote_counts"])),
                  f"{name}: dup_rate {rate} moved the aggregate (dedup)")
        stats = _extra_stats(r0)
        check(runs[DUP_RATES[1]].stats["duplicates"] > 0
              and stats["duplicates"] > 0 and stats["crashed"] > 0,
              f"{name}: no duplicates / crashes: {stats}")
        if name == "attack":
            check(stats["stuffed_votes"] > 0 and stats["byzantine"] > 0,
                  f"attack: no stuffing / Byzantine clients: {stats}")
        faulty[name] = {
            "uploaders": r0.n_active, "stats": stats,
            "duplicates_at": {str(k): r.stats["duplicates"]
                              for k, r in runs.items()},
            "wall_clock_s": r0.wall_clock_s,
            "upload_bytes": r0.upload_bytes}
        rounds[name] = r0
        del runs
    # card against CPU at FAULTS_CHECK_D
    gen = torch.Generator(device=DEV).manual_seed(1)
    u_small = torch.randn(N_CLIENTS, FAULTS_CHECK_D, device=DEV,
                          generator=gen) ** 3
    for name, c, net in (("storm", cfg, storm),
                         ("attack", att_cfg,
                          _attack_net(cfg, FAULTS_CHECK_D))):
        card_r, _, _ = counted(lambda: _packet_round(c, net, u_small, key, 1))
        t_cpu = time.perf_counter()
        cpu_r = _packet_round(c, net, u_small.cpu(), key.cpu(), 1)
        t_cpu = time.perf_counter() - t_cpu
        gaps = _fault_gates(f"{name} card vs CPU at d={FAULTS_CHECK_D}",
                            card_r, cpu_r, times_exact=False)
        faulty[name]["card_vs_cpu"] = {
            "d": FAULTS_CHECK_D, "time_rel_gaps": gaps, "cpu_round_s": t_cpu,
            "stats": _extra_stats(card_r)}
    faulty["seconds"] = time.perf_counter() - t0
    out["faulty"] = faulty
    log(f"[faults] {card}: storm and defended attack "
        + json.dumps(faulty))
    del u_small

    # -- (e) times at N_CLIENTS x D
    p1 = n_packets(round_traffic(cfg, D).phase1_bytes, storm.mtu)
    ge_ms = wall_ms(lambda: _ge_loss_probability(
        key, (N_CLIENTS, p1), 0.05, 0.05, 0.4, 0.8), iters=10)
    timing = {}
    nets = {"plain": (cfg, NetConfig(**base)),
            "chaos": (cfg, FaultConfig(**base)),
            "robust": (cfg, AdversaryConfig(**base)),
            "storm": (cfg, storm), "attack": (att_cfg, attack)}
    for name, (c, net) in nets.items():
        ms = wall_ms(lambda: _packet_round(c, net, u, key, 1),
                     iters=PACKET_TIME_ITERS)
        rows = device_profile(lambda: _packet_round(c, net, u, key, 1),
                              iters=1)
        busy = sum(r[1] for r in rows)
        timing[name] = {
            "round_ms": ms, "device_ms": busy,
            "idle_share": 1.0 - busy / ms if rows else None,
            "device_launches": sum(r[2] for r in rows),
            "top_kernels": [(nm[:60], t, n_) for nm, t, n_ in rows[:6]]}
    attempts = storm.round_retries + 1
    timing["ge_chain"] = {
        "shape": [N_CLIENTS, p1], "ms": ge_ms,
        "calls_per_storm_round": attempts,
        "share_of_storm_round": ge_ms * attempts / timing["storm"]["round_ms"],
        "share_of_chaos_round": ge_ms / timing["chaos"]["round_ms"]}
    out["timing"] = timing
    log(f"[faults] {card}: times at N={N_CLIENTS} d={D} "
        + json.dumps(timing))
    del u, rounds
    _free_card()

    # -- (c) the storm on the stream and sharded engines
    t0 = time.perf_counter()
    n, d = SHARD_N, SHARD_TIMING_D
    u8 = _shard_stack(d, seed=3)
    storm8 = _storm_net(n)
    engines_checked = []
    for engine, kernels, devs in (("stream", True, 0),
                                  ("sharded", False, SHARD_DEVICES)):
        mono = _packet_round(_packet_cfg(kernels=kernels), storm8, u8, key, 2)
        got, rose, by_shape = counted(lambda: _packet_round(
            _packet_cfg(engine=engine, kernels=kernels, devices=devs),
            storm8, u8, key, 2))
        _fault_gates(f"storm {engine} engine vs monolithic N={n} d={d}",
                     got, mono)
        want = (_chunk_shapes(n, d, stream_engine.DEFAULT_CHUNK) if kernels
                else {})
        check(by_shape.get("gather_quant", {}) == want
              and rose["stoch_quant"] == 0,
              f"storm {engine}: B1 launched by shape {by_shape}, not {want}")
        engines_checked.append(
            f"{engine} (kernels {'on' if kernels else 'off'}, uploaders "
            f"{got.n_active}, attempts {got.stats['attempts']})")
        del mono, got
    out["engines"] = {"n": n, "d": d, "bitwise_vs_monolithic": engines_checked,
                      "seconds": time.perf_counter() - t0}
    log(f"[faults] {card}: storm at N={n} d={d}: {engines_checked} bitwise "
        "the monolithic chaos round")
    del u8
    _free_card()

    # -- (d) the chaos and attack grids as FL tasks
    t0 = time.perf_counter()
    clients, test = _packet_fl_task()

    def fl(cfg, dev=DEV, **kw):
        return run_federated(clients, test, cfg, device=dev, **kw)

    hist, recorders = {}, {}
    for name in list(CHAOS_CELLS) + list(ATTACK_CELLS):
        rec = _Recorder()
        hist[name], rose, _ = counted(lambda: fl(_grid_fl_cfg(name),
                                                 wrap_transport=rec.wrap))
        check(rose["gather_quant"] == FAULTS_FL_ROUNDS,
              f"FL {name} launched B1 {rose['gather_quant']} times")
        check(all(math.isfinite(x) for x in hist[name].loss),
              f"FL {name}: loss not finite")
        recorders[name] = rec
    plain, _, _ = counted(lambda: fl(_grid_fl_cfg("chaos-clean",
                                                  plain=True)))
    for name in ("chaos-clean", "attack-clean"):
        check(_same_history(hist[name], plain),
              f"FL {name} != the plain packet run")
    clean = hist["attack-clean"].acc[-1]
    defended = hist["attack-full-defended"].acc[-1]
    undefended = hist["attack-full"].acc[-1]
    defense = {"clean_acc": clean, "defended_acc": defended,
               "undefended_acc": undefended,
               "defended_ratio": defended / max(clean, 1e-9),
               "undefended_ratio": undefended / max(clean, 1e-9)}
    check(defended >= DEFENSE_FLOOR * clean,
          f"the defense does not hold: {defense}")
    check(undefended <= ATTACK_CEILING * clean,
          f"the undefended attack does not collapse: {defense}")
    at2 = {}
    for name in ("attack-clean", "attack-full", "attack-full-defended"):
        h2, _, _ = counted(lambda: fl(_grid_fl_cfg(name,
                                                   seed=FAULTS_FL_SEED_2)))
        at2[name] = h2.acc[-1]
    clean2 = max(at2["attack-clean"], 1e-9)
    seed2 = {"clean_acc": at2["attack-clean"],
             "defended_ratio": at2["attack-full-defended"] / clean2,
             "undefended_ratio": at2["attack-full"] / clean2}
    defense[f"at net seed {FAULTS_FL_SEED_2}"] = seed2
    check(seed2["defended_ratio"] >= SEED_2_FLOOR
          and seed2["undefended_ratio"] <= ATTACK_CEILING,
          f"the defense at net seed {FAULTS_FL_SEED_2} falls below "
          f"{SEED_2_FLOOR} of clean or the attack holds: {seed2}")
    gaps = {}
    for name in ("chaos-burst-crash", "attack-full-defended"):
        h = hist[name]
        for where, kw in (
                ("independent", {}),
                ("fed the card's inputs", {"wrap_transport": (
                    lambda inner, name=name: _CardInputs(
                        inner, name, recorders[name].rounds))})):
            h_cpu = fl(_grid_fl_cfg(name), dev="cpu", **kw)
            gap = max(max(abs(a - b) for a, b in zip(h.acc, h_cpu.acc)),
                      max(abs(a - b) for a, b in zip(h.loss, h_cpu.loss)))
            check(gap <= FL_TOL, f"FL {name} card vs CPU ({where}): "
                  f"acc/loss gap {gap}")
            gaps[f"{name} ({where})"] = gap
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "defended.ckpt")
        killed, _, _ = counted(lambda: fl(dataclasses.replace(
            _grid_fl_cfg("attack-full-defended", rounds=FAULTS_FL_KILL),
            ckpt_path=path)))
        saved = load_run_state(path)["agg_state"]
        resumed, _, _ = counted(lambda: fl(dataclasses.replace(
            _grid_fl_cfg("attack-full-defended"), ckpt_path=path,
            resume=True)))
    check(saved is not None and saved["quarantine"].dtype == np.int32
          and saved["rep"].dtype == np.float32
          and bool((saved["rep"] > 0).any()),
          "the killed defended run's checkpoint holds no reputation state")
    check(len(killed) == FAULTS_FL_KILL
          and _same_history(resumed, hist["attack-full-defended"]),
          "the defended FL run killed and resumed != the uninterrupted run")
    out["fl"] = {
        "rounds": FAULTS_FL_ROUNDS,
        "final_acc": {k: h.acc[-1] for k, h in hist.items()},
        "wall_clock_s": {k: h.wall_clock[-1] for k, h in hist.items()},
        "traffic_mb": {k: h.traffic_mb[-1] for k, h in hist.items()},
        "defense": defense, "card_vs_cpu_gaps": gaps,
        "resumed_at": FAULTS_FL_KILL,
        "quarantined_at_kill": int((saved["quarantine"] > 0).sum()),
        "seconds": time.perf_counter() - t0}
    log(f"[faults] {card}: FL grids " + json.dumps(out["fl"]))

    out["launches"] = counted.launches
    out["launches_by_shape"] = counted.tally
    log(f"[faults] {card}: B1/B2 launches {counted.launches} by shape "
        f"{counted.tally}")
    return out


# ---------------------------------------------------------------------------
# The async path: the quorum-or-deadline close (netsim/async_engine.py)
# behind PacketTransport and the FL loop, and the telemetry layer (obs/)
# ---------------------------------------------------------------------------

#: the async close of benchmarks/async_throughput.py: a quorum of half the
#: announced uploaders, poly staleness weights off gamma 1
ASYNC_KW = dict(quorum_frac=0.5, staleness_mode="poly", staleness_gamma=1.0)
#: its straggler-variance cells; the high-straggler one is the round's
ASYNC_CELLS = {"low-variance": dict(straggler_frac=0.3,
                                    straggler_slowdown=2.0),
               "high-straggler": dict(straggler_frac=0.5,
                                      straggler_slowdown=16.0)}
#: PACKET_NET on one switch (the async close runs at a single switch)
ASYNC_BASE = dict(PACKET_NET, n_leaves=1)
#: the card-vs-CPU width of the async round
ASYNC_CHECK_D = 131_072
#: the throughput cells' FL task (async_throughput.py): 6 clients, hidden
#: (128, 64), 12 rounds, 2 local steps of batch 16, 10 ms of local
#: training, the phase-2-heavy compression point (HEAVY_CFG), net seed 2;
#: the resume cell: 8x stragglers, 5% loss, 12 bits, killed at round 6
ASYNC_FL_ROUNDS, ASYNC_FL_KILL = 12, 6
ASYNC_HEAVY_CFG = dict(a=2, bits=32, capacity_frac=0.5)
ASYNC_RESUME_NET = dict(straggler_frac=0.5, straggler_slowdown=8.0,
                        loss=0.05, seed=2)
#: the reference benchmark's gates: async at least SPEEDUP_FLOOR x the
#: synchronous round throughput at the high-straggler cell, and the final
#: accuracy at most ACC_GAP_MAX below the synchronous run's in each cell
SPEEDUP_FLOOR, ACC_GAP_MAX = 1.5, 0.05
#: benchmarks/obs.py's smoke cell and gate: one warmed packet round on 8
#: clients x 16,384 traced against untraced, interleaved reps, the median
#: of the per-rep ratios at most OVERHEAD_MAX
OBS_N, OBS_D, OBS_REPS, OVERHEAD_MAX = 8, 16_384, 40, 1.10


def _async_fl_task():
    from repro_torch.data import classification, partition_dirichlet
    data = classification(n=1200, dim=16, n_classes=10, seed=0)
    train, test = data.test_split(0.25)
    return partition_dirichlet(train, 6, beta=0.5, seed=0), test


def _async_fl_cfg(net, rounds=ASYNC_FL_ROUNDS, cfg_kw=None):
    from repro_torch.core.engines import EngineSpec
    from repro_torch.core.fediac import FediACConfig
    from repro_torch.training.fl_loop import FLConfig
    return FLConfig(n_clients=6, rounds=rounds, local_steps=2, batch=16,
                    aggregator="fediac",
                    agg_kwargs={"cfg": FediACConfig(**(cfg_kw
                                                       or ASYNC_HEAVY_CFG))},
                    engine=EngineSpec(use_pallas=True), local_train_s=0.01,
                    transport="packet", net=net, seed=0)


def _async_stats(r) -> dict:
    from repro_torch.netsim import ASYNC_STAT_FIELDS
    return {k: r.stats[k] for k in ASYNC_STAT_FIELDS}


def _async_rounds(cfg, net, u, key, rounds=(1, 2)):
    """Consecutive async packet rounds on one transport, the carry of each
    threaded into the next."""
    from repro_torch.netsim import PacketTransport
    tp = PacketTransport("fediac", {"cfg": cfg}, net=net)
    state, out = None, []
    for t in rounds:
        r = tp.round(u, state, key, t)
        state = r.state
        out.append(r)
    return out


def _async_gates(where, got, want, *, times_exact=True):
    """:func:`_packet_gates` plus the async statistics, the announced
    uploaders and the carry, bitwise."""
    gaps = _packet_gates(where, got, want, times_exact=times_exact)
    check(_async_stats(got) == _async_stats(want),
          f"{where}: async stats {_async_stats(got)} != "
          f"{_async_stats(want)}")
    check(same_bits(got.state, want.state), f"{where}: the carry differs")
    return gaps


def phase_async(card: str) -> dict:
    """The async close on the card: (a) at N_CLIENTS x D with the kernels
    on, under PACKET_NET on one switch and a deadline at the median vote
    arrival, AsyncConfig at its defaults bitwise the synchronous packet
    round in the four vote x compact modes and at vote_chunk 4, and the
    in-memory "async" engine (through aggregate_round with a probe, its
    engine span recorded) bitwise aggregate_stack; (b) the async round
    (ASYNC_KW, the high-straggler cell) two rounds running, the second
    folding the first's carry, card against CPU at ASYNC_CHECK_D, the
    stream (kernels on) and sharded (8 shards) engines bitwise the
    monolithic one at 8 x SHARD_TIMING_D, and its times beside the
    synchronous round's; (c) async_throughput.py's throughput cells as FL
    tasks, sync against async, its speedup and accuracy gates, the async
    high-straggler run card against CPU, and a kill and resume with a
    partly filled carry; (d) that async run with a RecordingProbe bitwise
    the run without one, its trace validated and its report rendered, the
    probe's overhead on benchmarks/obs.py's smoke cell gated, and a
    profiler_trace bracket's chrome trace.  The B1 and B2 counts are
    zeroed just before each run and read just after, tallied by shape."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import load_run_state
    from repro_torch.core import fediac, prng, stream_engine
    from repro_torch.core.engines import EngineSpec
    from repro_torch.netsim import AsyncConfig, NetConfig, PacketTransport
    from repro_torch.obs import (RecordingProbe, load_trace, profiler_trace,
                                 render_report, validate_records)
    from repro_torch.training.fl_loop import run_federated
    out = {"card": card}
    counted = _QuantCounter()

    # -- (a) the identity anchor at full width
    t0 = time.perf_counter()
    key = prng.PRNGKey(0, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    u = torch.randn(N_CLIENTS, D, device=DEV, generator=gen) ** 3
    deadline = _vote_median(N_CLIENTS, D, PACKET_NET["seed"], round_idx=1)
    base = dict(ASYNC_BASE, vote_deadline_s=deadline)
    checked = []
    for vm, cm, g in [(vm, cm, 1) for vm, cm in SHARD_MODES] + [
            ("topk", "topk", 4)]:
        cfg = _packet_cfg(vm, cm, g)
        where = f"{vm}/{cm} g={g}"
        want = {"gather_quant": int(g == 1 and cm == "topk"),
                "stoch_quant": int(g > 1)}
        sync, rose, _ = counted(lambda: _packet_round(
            cfg, NetConfig(**base), u, key, 1))
        check(rose == want, f"async anchor {where}: sync launches {rose}")
        asy, rose, _ = counted(lambda: _packet_round(
            cfg, AsyncConfig(**base), u, key, 1))
        check(rose == want, f"async anchor {where}: async launches {rose}")
        _packet_gates(f"full-quorum async {where} vs sync", asy, sync)
        check(asy.stats["late_folded"] == asy.stats["late_bounced"] == 0
              and asy.stats["quorum_met"] == 1
              and int(asy.state["pending_n"]) == 0,
              f"full-quorum async {where}: {_async_stats(asy)}")
        eng_cfg = dataclasses.replace(cfg, engine=EngineSpec(
            name="async", use_pallas=True))
        eng_probe = RecordingProbe()
        (d_a, r_a, c_a, _), rose, _ = counted(
            lambda: fediac.aggregate_round(u, eng_cfg, key, probe=eng_probe))
        check(rose == want, f"async engine {where}: launches {rose}")
        check(any(r.get("name") == "engine-async"
                  for r in eng_probe.tracer.records),
              f"async engine {where}: no engine span recorded")
        d_s, r_s, c_s, _ = fediac.aggregate_stack(u, cfg, key)
        check(same_bits(d_a, d_s) and same_bits(r_a, r_s)
              and same_bits(c_a, c_s),
              f"the async engine {where} != aggregate_stack")
        checked.append(where)
        del sync, asy, d_a, r_a, d_s, r_s
    out["anchor"] = {"n": N_CLIENTS, "d": D, "vote_deadline_s": deadline,
                     "bitwise": checked, "seconds": time.perf_counter() - t0}
    log(f"[async] {card}: full-quorum async == sync packet round and the "
        f"async engine == aggregate_stack at N={N_CLIENTS} d={D}: {checked}")

    # -- (b) the async round: two rounds, card against CPU, engines, times
    t0 = time.perf_counter()
    cfg = _packet_cfg()
    net = AsyncConfig(**{**base, **ASYNC_CELLS["high-straggler"],
                         **ASYNC_KW})
    rounds, rose, _ = counted(lambda: _async_rounds(cfg, net, u, key))
    check(rose == {"gather_quant": 2, "stoch_quant": 0},
          f"async rounds: launches {rose}")
    r1, r2 = rounds
    check(r1.stats["late_folded"] > 0 and r2.stats["folded_in"]
          == r1.stats["late_folded"],
          f"async rounds fold no carry: {_async_stats(r1)} then "
          f"{_async_stats(r2)}")
    stats = [_async_stats(r) for r in rounds]
    gen = torch.Generator(device=DEV).manual_seed(1)
    u_small = torch.randn(N_CLIENTS, ASYNC_CHECK_D, device=DEV,
                          generator=gen) ** 3
    card_rs, _, _ = counted(lambda: _async_rounds(cfg, net, u_small, key))
    t_cpu = time.perf_counter()
    cpu_rs = _async_rounds(cfg, net, u_small.cpu(), key.cpu())
    t_cpu = time.perf_counter() - t_cpu
    gaps = [_async_gates(f"async round {t} card vs CPU at "
                         f"d={ASYNC_CHECK_D}", a, b, times_exact=False)
            for t, a, b in zip((1, 2), card_rs, cpu_rs)]
    check(cpu_rs[1].stats["folded_in"] > 0,
          f"the check rounds fold no carry: {_async_stats(cpu_rs[1])}")
    out["round"] = {
        "n": N_CLIENTS, "d": D, "net": {**ASYNC_CELLS["high-straggler"],
                                        **ASYNC_KW},
        "stats": stats, "uploaders": [r.n_active for r in rounds],
        "wall_clock_s": [r.wall_clock_s for r in rounds],
        "card_vs_cpu": {"d": ASYNC_CHECK_D, "time_rel_gaps": gaps,
                        "cpu_rounds_s": t_cpu,
                        "stats": [_async_stats(r) for r in card_rs]},
        "seconds": time.perf_counter() - t0}
    log(f"[async] {card}: async rounds " + json.dumps(out["round"]))
    del rounds, r1, r2, card_rs, cpu_rs, u_small

    timing = {}
    sync_net = NetConfig(**{**base, **ASYNC_CELLS["high-straggler"]})
    for name, n_ in (("sync", sync_net), ("async", net)):
        ms = wall_ms(lambda: _packet_round(cfg, n_, u, key, 1),
                     iters=PACKET_TIME_ITERS)
        rows = device_profile(lambda: _packet_round(cfg, n_, u, key, 1),
                              iters=1)
        busy = sum(r[1] for r in rows)
        timing[name] = {
            "round_ms": ms, "device_ms": busy,
            "idle_share": 1.0 - busy / ms if rows else None,
            "device_launches": sum(r[2] for r in rows),
            "top_kernels": [(nm[:60], t, n) for nm, t, n in rows[:6]]}
    out["timing"] = timing
    log(f"[async] {card}: times at N={N_CLIENTS} d={D} " + json.dumps(timing))
    del u
    _free_card()

    t0 = time.perf_counter()
    n, d = SHARD_N, SHARD_TIMING_D
    u8 = _shard_stack(d, seed=3)
    net8 = AsyncConfig(**{**ASYNC_BASE, **ASYNC_CELLS["high-straggler"],
                          **ASYNC_KW, "vote_deadline_s": _vote_median(
                              n, d, PACKET_NET["seed"], round_idx=1)})
    engines_checked = []
    for engine, kernels, devs in (("stream", True, 0),
                                  ("sharded", False, SHARD_DEVICES)):
        mono = _async_rounds(_packet_cfg(kernels=kernels), net8, u8, key)
        got, rose, by_shape = counted(lambda: _async_rounds(
            _packet_cfg(engine=engine, kernels=kernels, devices=devs), net8,
            u8, key))
        for t, a, b in zip((1, 2), got, mono):
            _async_gates(f"async round {t} {engine} engine vs monolithic "
                         f"N={n} d={d}", a, b)
        want = ({k: 2 * v for k, v in _chunk_shapes(
            n, d, stream_engine.DEFAULT_CHUNK).items()} if kernels else {})
        check(by_shape.get("gather_quant", {}) == want
              and rose["stoch_quant"] == 0,
              f"async {engine}: B1 launched by shape {by_shape}, not {want}")
        engines_checked.append(
            f"{engine} (kernels {'on' if kernels else 'off'}, late "
            f"{got[0].stats['late_folded']}, folded in "
            f"{got[1].stats['folded_in']})")
        del mono, got
    out["engines"] = {"n": n, "d": d, "bitwise_vs_monolithic": engines_checked,
                      "seconds": time.perf_counter() - t0}
    log(f"[async] {card}: N={n} d={d}: {engines_checked} bitwise the "
        "monolithic async rounds")
    del u8
    _free_card()

    # -- (c) the throughput cells as FL tasks
    t0 = time.perf_counter()
    clients, test = _async_fl_task()

    def fl(cfg, dev=DEV, **kw):
        return run_federated(clients, test, cfg, device=dev, **kw)

    cells, hist = {}, {}
    rec = _Recorder()
    for name, strag in ASYNC_CELLS.items():
        sync_h, rose, _ = counted(lambda: fl(_async_fl_cfg(
            NetConfig(seed=2, **strag))))
        check(rose["gather_quant"] == ASYNC_FL_ROUNDS,
              f"FL sync {name} launched B1 {rose['gather_quant']} times")
        wrap = rec.wrap if name == "high-straggler" else None
        async_h, rose, _ = counted(lambda: fl(_async_fl_cfg(
            AsyncConfig(seed=2, **strag, **ASYNC_KW)), wrap_transport=wrap))
        check(rose["gather_quant"] == ASYNC_FL_ROUNDS,
              f"FL async {name} launched B1 {rose['gather_quant']} times")
        hist[name] = async_h
        cells[name] = {
            "sync_wall_s": sync_h.wall_clock[-1],
            "async_wall_s": async_h.wall_clock[-1],
            "speedup": sync_h.wall_clock[-1] / async_h.wall_clock[-1],
            "sync_final_acc": sync_h.acc[-1],
            "async_final_acc": async_h.acc[-1],
            "acc_gap": sync_h.acc[-1] - async_h.acc[-1]}
    check(cells["high-straggler"]["speedup"] >= SPEEDUP_FLOOR,
          f"async speedup below {SPEEDUP_FLOOR}: {cells}")
    check(all(c["acc_gap"] <= ACC_GAP_MAX for c in cells.values()),
          f"async accuracy gap above {ACC_GAP_MAX}: {cells}")
    high_cfg = _async_fl_cfg(AsyncConfig(
        seed=2, **ASYNC_CELLS["high-straggler"], **ASYNC_KW))
    fl_gaps = {}
    for where, kw in (("independent", {}),
                      ("fed the card's inputs", {"wrap_transport": (
                          lambda inner: _CardInputs(inner, "async",
                                                    rec.rounds))})):
        h_cpu = fl(high_cfg, dev="cpu", **kw)
        h = hist["high-straggler"]
        check(_close_clock(h_cpu.wall_clock, h.wall_clock)
              and h_cpu.traffic_mb == h.traffic_mb,
              f"async FL card vs CPU ({where}): clock / traffic")
        gap = max(max(abs(a - b) for a, b in zip(h.acc, h_cpu.acc)),
                  max(abs(a - b) for a, b in zip(h.loss, h_cpu.loss)))
        check(gap <= FL_TOL, f"async FL card vs CPU ({where}): acc/loss gap "
              f"{gap}")
        fl_gaps[where] = gap
    resume_net = AsyncConfig(**ASYNC_RESUME_NET, **ASYNC_KW)
    full, _, _ = counted(lambda: fl(_async_fl_cfg(
        resume_net, cfg_kw=dict(a=2, bits=12))))
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "async.ckpt")
        killed, _, _ = counted(lambda: fl(dataclasses.replace(_async_fl_cfg(
            resume_net, rounds=ASYNC_FL_KILL, cfg_kw=dict(a=2, bits=12)),
            ckpt_path=path)))
        saved = load_run_state(path)["agg_state"]
        resumed, _, _ = counted(lambda: fl(dataclasses.replace(_async_fl_cfg(
            resume_net, cfg_kw=dict(a=2, bits=12)), ckpt_path=path,
            resume=True)))
    check(saved is not None and int(saved["pending_n"]) > 0
          and saved["pending"].dtype == np.float32,
          "the killed async run's checkpoint holds no pending carry")
    check(len(killed) == ASYNC_FL_KILL and _same_history(resumed, full),
          "the async FL run killed and resumed != the uninterrupted run")
    out["fl"] = {"rounds": ASYNC_FL_ROUNDS, "cells": cells,
                 "speedup_floor": SPEEDUP_FLOOR, "acc_gap_max": ACC_GAP_MAX,
                 "card_vs_cpu_gaps": fl_gaps, "resumed_at": ASYNC_FL_KILL,
                 "pending_at_kill": int(saved["pending_n"]),
                 "seconds": time.perf_counter() - t0}
    log(f"[async] {card}: FL " + json.dumps(out["fl"]))

    # -- (d) telemetry
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "async.jsonl")
        # checkpointed every round, so the trace's ckpt spans time the
        # save (the history is the same with or without it)
        ckpt_cfg = dataclasses.replace(high_cfg,
                                       ckpt_path=str(Path(tmp) / "a.ckpt"))
        with RecordingProbe(path, profiler=True) as probe:
            probed, _, _ = counted(lambda: fl(ckpt_cfg, probe=probe))
        records = load_trace(path)
    spans = {}
    for r in records:
        if r["type"] == "span" and r["clock"] == "host":
            spans.setdefault(r["name"], []).append(r["dur_s"])
    span_ms = {k: 1e3 * sum(v) / len(v) for k, v in spans.items()}
    check(_same_history(probed, hist["high-straggler"]),
          "the probed async FL run != the run without a probe")
    errors = validate_records(records)
    check(errors == [], f"the async FL trace fails validation: {errors[:3]}")
    report = render_report(records)
    check("round" in report and "phase1-vote_s" in report,
          "the async FL report did not render")
    prof = records[-1]["metrics"]["__profile__"]
    check(prof["packet_core[n=6]"]["calls"] == ASYNC_FL_ROUNDS
          and prof["packet_core[n=6]"]["device_s"] > 0,
          f"the profiler missed the round cores: {prof}")

    obs_cfg = dataclasses.replace(_packet_cfg(), a=2, bits=12)
    gen = torch.Generator(device=DEV).manual_seed(1)
    u_obs = torch.randn(OBS_N, OBS_D, device=DEV, generator=gen) ** 3
    plain_tp = PacketTransport("fediac", {"cfg": obs_cfg}, net=NetConfig())
    probed_tp = PacketTransport("fediac", {"cfg": obs_cfg}, net=NetConfig())
    obs_probe = RecordingProbe(None, profiler=True)
    probed_tp.attach_probe(obs_probe)

    def untraced():
        plain_tp.round(u_obs, None, key, 1)
        torch.cuda.synchronize()

    def traced():
        with obs_probe.span("round", round=1):
            r = probed_tp.round(u_obs, None, key, 1)
            torch.cuda.synchronize()
            obs_probe.metrics(r.to_metrics(), round=1)
            st = r.stats
            obs_probe.sim_phase("phase1-vote", 0.0, st["phase1_s"], round=1)
            obs_probe.sim_phase("phase2-aggregate", st["phase1_s"],
                                st["phase1_s"] + st["phase2_s"], round=1)

    untraced()                   # warm both paths
    traced()
    times = {"traced": [], "untraced": []}
    for _ in range(OBS_REPS):
        for name, fn in (("traced", traced), ("untraced", untraced)):
            t1 = time.perf_counter()
            fn()
            times[name].append(time.perf_counter() - t1)
    obs_probe.close()
    ratios = sorted(a / max(b, 1e-12) for a, b in zip(times["traced"],
                                                       times["untraced"]))
    ratio = (ratios[OBS_REPS // 2 - 1] + ratios[OBS_REPS // 2]) / 2
    check(ratio <= OVERHEAD_MAX, f"probe overhead {ratio} > {OVERHEAD_MAX}")
    with tempfile.TemporaryDirectory() as tmp:
        with profiler_trace(str(Path(tmp) / "prof")) as pt:
            _async_rounds(cfg, net, u_obs, key, rounds=(1,))
            torch.cuda.synchronize()
        check(pt.path is not None, "profiler_trace wrote no chrome trace")
        with open(pt.path) as fh:
            n_events = len(json.load(fh)["traceEvents"])
    check(n_events > 0, "the chrome trace holds no events")
    out["telemetry"] = {
        "trace_records": len(records), "profile": prof,
        "span_ms_mean": span_ms,
        "overhead": {"n": OBS_N, "d": OBS_D, "reps": OBS_REPS,
                     "ratio": ratio, "max": OVERHEAD_MAX,
                     "traced_ms_mean": 1e3 * sum(times["traced"]) / OBS_REPS,
                     "untraced_ms_mean": 1e3 * sum(times["untraced"])
                     / OBS_REPS},
        "chrome_trace_events": n_events,
        "seconds": time.perf_counter() - t0}
    log(f"[async] {card}: telemetry " + json.dumps(out["telemetry"]))

    out["launches"] = counted.launches
    out["launches_by_shape"] = counted.tally
    log(f"[async] {card}: B1/B2 launches {counted.launches} by shape "
        f"{counted.tally}")
    return out


# ---------------------------------------------------------------------------
# The sweep path: repro_torch.sweep's fleets against its sequential runs
# ---------------------------------------------------------------------------

#: fig2_grid's cells held against their own sequential runs: one lane of
#: each fleet group, the high switch profile's
FIG2_GATED = ("high/fediac", "high/switchml", "high/libra",
              "high/omnireduce")
SWEEP_CHECK_ROUNDS = 3      # rounds of the smoke-grid cell, card vs CPU
SWEEP_CHECK_CELL = "fediac-a3"
SWEEP_PROFILE_ROUNDS = 3    # fig2's fleet cut to these rounds, profiled


def _kernels_on(grid) -> list:
    """A grid's cells with the fused kernels on, so that FediAC's rounds
    launch B1."""
    from repro_torch.core.engines import EngineSpec
    return [dataclasses.replace(s, engine=EngineSpec(use_pallas=True))
            for s in grid]


def phase_sweep(card: str) -> dict:
    """The scenario sweep on the card, kernels on: (a) smoke_grid (4 cells,
    2 fleet groups) and chaos_grid (5 packet cells under faults, one
    group) through ``run_sweep``'s fleets against ``sequential=True``,
    every history bitwise; (b) fig2_grid at full width (8 cells, N = 20,
    40 rounds) through the fleets, FIG2_GATED's cells (one per group)
    bitwise their own sequential runs, the fleet's cells per second beside the sequential
    path's, its device idle share (profiled, cut to SWEEP_PROFILE_ROUNDS
    rounds) and its B1 launches; (c) one smoke-grid FediAC cell,
    SWEEP_CHECK_ROUNDS rounds, card against CPU: traffic and clock equal,
    accuracy and loss within FL_TOL.  The B1 and B2 counts are zeroed just
    before each run and read just after, tallied by shape."""
    import torch
    from repro_torch.sweep import run_cell_sequential, run_sweep
    from repro_torch.sweep.grids import chaos_grid, fig2_grid, smoke_grid
    out = {"card": card}
    counted = _QuantCounter()

    def run(fn):
        t0 = time.perf_counter()
        res, rose, by_shape = counted(fn)
        return res, rose, by_shape, time.perf_counter() - t0

    # -- (a) the smoke and chaos grids, fleet against sequential
    for name, factory in (("smoke", smoke_grid), ("chaos", chaos_grid)):
        grid = _kernels_on(factory())
        fleet, rose_f, shapes_f, s_f = run(lambda: run_sweep(grid, device=DEV))
        seq, rose_s, _, s_s = run(lambda: run_sweep(grid, device=DEV,
                                                    sequential=True))
        bad = [a.key for a, b in zip(fleet, seq)
               if not _same_history(a.history, b.history)]
        check(not bad, f"sweep {name}: fleet != sequential for {bad}")
        check(rose_f == rose_s and rose_f["gather_quant"] > 0,
              f"sweep {name}: launches fleet {rose_f}, sequential {rose_s}")
        out[name] = {
            "cells": len(grid),
            "fleet_groups": len({c.batch_signature() for c in grid}),
            "bitwise": [a.key for a in fleet],
            "fleet_s": s_f, "sequential_s": s_s,
            "fleet_cells_per_s": len(grid) / s_f,
            "sequential_cells_per_s": len(grid) / s_s,
            "fleet_launches": rose_f, "fleet_launches_by_shape": shapes_f}
        log(f"[sweep] {card}: {name}_grid fleet == sequential bitwise "
            f"({len(grid)} cells): fleet {s_f:.2f} s, sequential "
            f"{s_s:.2f} s; B1/B2 under the fleet {rose_f}")

    # -- (b) fig2_grid at full width: the fleets, gated cells, idle share
    grid = _kernels_on(fig2_grid())
    fleet, rose_f, shapes_f, s_f = run(lambda: run_sweep(grid, device=DEV))
    by_name = {c.spec.name: c for c in fleet}
    gated, s_seq = [], 0.0
    for name in FIG2_GATED:
        cell = by_name[name]
        h, _, _, s = run(lambda: run_cell_sequential(cell.spec, cell.seed,
                                                     device=DEV))
        check(_same_history(h, cell.history),
              f"sweep fig2: fleet != sequential for {name}")
        gated.append(name)
        s_seq += s
    check(all(math.isfinite(x) for c in fleet for x in c.history.loss),
          "sweep fig2: a loss is not finite")
    cut = [dataclasses.replace(c, rounds=SWEEP_PROFILE_ROUNDS) for c in grid]
    cut_s = wall_ms(lambda: run_sweep(cut, device=DEV), iters=1) / 1e3
    rows = device_profile(lambda: run_sweep(cut, device=DEV), iters=1,
                          warm=False)
    busy = sum(ms for _, ms, _ in rows) / 1e3
    out["fig2"] = {
        "cells": len(grid), "rounds": grid[0].rounds,
        "n_clients": grid[0].n_clients,
        "fleet_groups": len({c.batch_signature() for c in grid}),
        "bitwise_vs_sequential": gated, "fleet_s": s_f,
        "fleet_cells_per_s": len(grid) / s_f,
        "sequential_s": s_seq,
        "sequential_cells_per_s": len(gated) / s_seq,
        "fleet_launches": rose_f, "fleet_launches_by_shape": shapes_f,
        "final_acc": {c.spec.name: c.history.acc[-1] for c in fleet},
        "profiled_rounds": SWEEP_PROFILE_ROUNDS, "profiled_wall_s": cut_s,
        "profiled_device_s": busy,
        "idle_share": 1.0 - busy / cut_s if rows else None,
        "top_kernels": [[k, ms, n] for k, ms, n in rows[:6]]}
    log(f"[sweep] {card}: fig2_grid fleet {s_f:.2f} s for {len(grid)} cells "
        f"x {grid[0].rounds} rounds ({len(grid) / s_f:.3f} cells/s), "
        f"sequential {len(gated) / s_seq:.3f} cells/s; {gated} bitwise; "
        f"idle share {out['fig2']['idle_share']}; B1 under the fleet "
        f"{rose_f['gather_quant']}")

    # -- (c) one smoke-grid FediAC cell, card against CPU
    cell = next(dataclasses.replace(c, rounds=SWEEP_CHECK_ROUNDS)
                for c in _kernels_on(smoke_grid())
                if c.name == SWEEP_CHECK_CELL)
    (card_res,), _, _, _ = run(lambda: run_sweep([cell], device=DEV))
    cpu_h = run_sweep([cell], device="cpu").cells[0].history
    h = card_res.history
    check(h.traffic_mb == cpu_h.traffic_mb and h.wall_clock == cpu_h.wall_clock,
          "sweep card vs CPU: traffic / clock differ")
    gap = max(max(abs(a - b) for a, b in zip(h.acc, cpu_h.acc)),
              max(abs(a - b) for a, b in zip(h.loss, cpu_h.loss)))
    check(gap <= FL_TOL, f"sweep card vs CPU: acc/loss gap {gap}")
    out["card_vs_cpu"] = {"cell": cell.name, "rounds": cell.rounds,
                          "acc_loss_gap": gap, "tolerance": FL_TOL}
    log(f"[sweep] {card}: {cell.name} card vs CPU: traffic and clock equal, "
        f"acc/loss gap {gap:.3g}")
    torch.cuda.synchronize()

    out["launches"] = counted.launches
    out["launches_by_shape"] = counted.tally
    log(f"[sweep] {card}: B1/B2 launches {counted.launches} by shape "
        f"{counted.tally}")
    return out


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


#: the mesh baselines on the allreduce's ranks (core/mesh_baselines.py),
#: at the reference's test arguments (tests/test_distributed.py:142-153)
MESH_BASELINES = {"switchml": ("switchml_allreduce", {"bits": 14}),
                  "topk": ("topk_allreduce", {"k_frac": 0.05})}
#: their contracts there: Top-k's error feedback conserves what left the
#: clients within 2e-2; SwitchML's mean is the dense mean within
#: max|u| / 2**10
MESH_EF_TOL = 2e-2
MESH_SWITCHML_STEP = 2.0 ** -10


def _mesh_fns() -> dict:
    from repro_torch.core import mesh_baselines
    from repro_torch.core.fediac import FediACConfig
    return {name: (getattr(mesh_baselines, fn), FediACConfig(**kw))
            for name, (fn, kw) in MESH_BASELINES.items()}


def _mesh_rank(rank: int, world: int, u, key) -> dict:
    """The mesh baselines on this rank: one gated call each at ``u``'s
    width, the same call on the card and on the CPU at AR_CHECK_D, then
    AR_TIME_ITERS timed calls between barriers."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import collectives
    res = torch.zeros_like(u)
    dense = u.clone()
    dist.all_reduce(dense)
    dense /= world
    umax = float(collectives.pmax_(u.abs().max()))
    uc = _rank_update(rank, AR_CHECK_D)
    out = {}
    for name, (fn, cfg) in _mesh_fns().items():
        mean, new_res = fn(u, res, key, cfg)
        torch.cuda.synchronize()
        rank0 = mean.clone()
        dist.broadcast(rank0, 0)
        gate = {"finite": bool(torch.isfinite(mean).all()
                               and torch.isfinite(new_res).all()),
                "same_mean_as_rank0": same_bits(mean, rank0)}
        if name == "topk":
            left = (u + res - new_res).to(torch.float32)
            dist.all_reduce(left)
            gate["err"] = float((left / world - mean).abs().max())
            gate["tol"] = MESH_EF_TOL
        else:
            gate["err"] = float((mean - dense).abs().max())
            gate["tol"] = umax * MESH_SWITCHML_STEP
            gate["residual_zero"] = not bool(new_res.any())
        del mean, new_res, rank0
        zc = torch.zeros_like(uc)
        card = fn(uc, zc, key, cfg)
        cpu = fn(uc.cpu(), zc.cpu(), key.cpu(), cfg)
        gate["card_vs_cpu_bitwise"] = all(same_bits(a, b)
                                          for a, b in zip(card, cpu))
        times = []
        for _ in range(AR_TIME_ITERS):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(u, res, key, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            dist.barrier()
        out[name] = {"gates": gate, "times_ms": times}
    return out


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
    report["mesh"] = _mesh_rank(rank, world, u, key0)

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


def phase_allreduce(card: str) -> dict:
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
    for rep in reports:
        for name, m in rep["mesh"].items():
            g, where = m["gates"], f"rank {rep['rank']} {name}_allreduce"
            check(g["finite"] and g["same_mean_as_rank0"],
                  f"{where}: non-finite, or its mean differs from rank 0's")
            check(g["err"] < g["tol"], f"{where}: off the reference's "
                  f"contract by {g['err']} (bound {g['tol']})")
            check(g.get("residual_zero", True),
                  f"{where}: SwitchML left a residual")
            check(g["card_vs_cpu_bitwise"], f"{where}: card and CPU differ "
                  f"at d={AR_CHECK_D}")
    mesh = {name: {
        "round_ms": sorted(max(rep["mesh"][name]["times_ms"][i]
                               for rep in reports)
                           for i in range(AR_TIME_ITERS))[AR_TIME_ITERS // 2],
        "err_max": max(rep["mesh"][name]["gates"]["err"] for rep in reports),
        "tol": min(rep["mesh"][name]["gates"]["tol"] for rep in reports)}
        for name in MESH_BASELINES}
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
               for gs in rep["gates"].values() for g in gs),
           "mesh_baselines": mesh}
    log(f"[allreduce] {AR_RANKS} ranks, d={AR_D}: every gate held; "
        f"launches {launches}; round ms {out['round_ms']}; peak "
        f"{out['peak_mem_gib_per_rank']:.2f} GiB per rank; card == CPU "
        f"bitwise at d={AR_CHECK_D} ({wall:.1f} s)")
    # gloo stages CUDA tensors through host memory: these are times of the
    # host path, not of the card
    log(f"[gloo] slowest rank, median of {AR_TIME_ITERS}, ms: "
        f"{out['gloo_ms']}")
    log(f"[mesh baselines] {card}: {AR_RANKS} ranks, d={AR_D}: the "
        f"reference's contracts held, card == CPU bitwise at d={AR_CHECK_D}; "
        f"slowest rank, median of {AR_TIME_ITERS}: " + json.dumps(mesh))
    return out


def nccl_rank(rank: int, world: int) -> dict:
    """The one rank of an NCCL group of one on the card: the packed top-k
    ``fediac_allreduce`` (config B) and the two mesh baselines at AR_D,
    each against the same call on a one-rank gloo group, bitwise, then
    each timed on both groups."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import fediac, prng
    torch.cuda.set_device(0)
    gloo = dist.new_group(backend="gloo")
    u = _rank_update(rank, AR_D)
    res = torch.zeros_like(u)
    key = prng.PRNGKey(0, device=DEV)
    calls = {"fediac_packed_topk": (fediac.fediac_allreduce,
                                    _ar_configs()["B"]), **_mesh_fns()}
    report = {"backend": dist.get_backend(), "world": world}
    for name, (fn, cfg) in calls.items():
        nccl = fn(u, res, key, cfg)
        via_gloo = fn(u, res, key, cfg, group=gloo)
        torch.cuda.synchronize()
        report[name] = {
            "bitwise": all(same_bits(a, b) for a, b in zip(nccl, via_gloo)),
            "nccl_ms": wall_ms(lambda: fn(u, res, key, cfg)),
            "gloo_ms": wall_ms(lambda: fn(u, res, key, cfg, group=gloo))}
    return report


def phase_nccl(card: str) -> dict:
    """The port's first NCCL run: :func:`nccl_rank` in one spawned rank."""
    from repro_torch import testing
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        rep = testing.run_ranks(nccl_rank, 1, f"file://{store}/store",
                                timeout=600, backend="nccl")[0]
    finally:
        shutil.rmtree(store, ignore_errors=True)
    check(rep["backend"] == "nccl", f"the group ran on {rep['backend']}")
    for name in ("fediac_packed_topk", *MESH_BASELINES):
        check(rep[name]["bitwise"], f"{name} on NCCL (world size 1) != the "
              "same call on gloo")
    log(f"[nccl] {card}: world size 1, d={AR_D}: NCCL == gloo bitwise; "
        + json.dumps(rep))
    return rep


def phase_wire_timing() -> dict:
    """Each wire kernel, its plain version and its bound at the allreduce
    path's shapes (d = AR_D, N = AR_RANKS), and B3 and B5 at the train
    path's largest leaf."""
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
    # the train path's largest leaf: B3 over its scores, B5 over its
    # ranks' words (shaped as the train path's tally keys them)
    del mask, scores, words, stack
    d, n = TRAIN_TIMED_LEAVES[0], TRAIN_RANKS
    w = wire_groups(d) * LANES
    _, scores = _wire_inputs(d, seed=7)
    scores = torch.nan_to_num(scores)
    tau = torch.quantile(scores[:1 << 24], 0.95).reshape(())
    stack = _words(n, d, seed=8)
    out["train_vote_pack"] = [time_kernel(
        lambda: vote_pack.vote_pack(scores, tau),
        lambda: vote_pack.vote_pack_plain(scores, tau),
        4 * d + 4 * w + 4, 2 * d, [d], TRAIN_TIMED_GRAPH)]
    out["train_popcount_accum"] = [time_kernel(
        lambda: vote_popcount.popcount_accum(stack, d),
        lambda: vote_popcount.popcount_accum_plain(stack, d),
        4 * n * w + 4 * d, 64 * n * w, list(stack.shape), TRAIN_TIMED_GRAPH)]
    del scores, stack
    _free_card()
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
    # the train path's one-row launches at its two largest leaves
    out["train_gather_quant"] = []
    for i, cols in enumerate(TRAIN_TIMED_LEAVES):
        g = _stack_gather_inputs(1, cols, seed=7 + i)
        out["train_gather_quant"].append(time_kernel(
            lambda g=g: gather_quant(*g), lambda g=g: gather_quant_plain(*g),
            16 * cols + cols + 4, 8 * cols, [1, cols], TRAIN_TIMED_GRAPH))
        del g
        _free_card()
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


def _capture_b6(step, keep=lambda calls, q, k, v, kw: not calls):
    """``step()`` with the models' B6 calls watched: its result, the
    (q, k, v, kw) of the calls ``keep`` picks as the kernel receives them
    (by default the first, layer 0's), and the dtype (the kernel instance)
    of every call."""
    from repro_torch.models import attention as attn
    calls, dtypes = [], []
    real = attn.flash_attention

    def capture(q, k, v, **kw):
        if keep(calls, q, k, v, kw):
            calls.append((q, k, v, kw))
        dtypes.append(str(q.dtype).removeprefix("torch."))
        return real(q, k, v, **kw)

    attn.flash_attention = capture
    try:
        result = step()
    finally:
        attn.flash_attention = real
    return result, calls, dtypes


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

    def capture_layer0(step):
        result, calls, dtypes = _capture_b6(step)
        return result, calls[0], dtypes

    # -- main path: one prefill, counts zeroed just before and read just
    # after; every B6 launch is the bf16 (tensor-core) instance
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    logits, (q, k, v, kw), dtypes = capture_layer0(
        lambda: bundle.step(params, {"tokens": tokens}))
    torch.cuda.synchronize()
    out["prefill_first_ms"] = (time.perf_counter() - t0) * 1e3
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: (cfg.n_layers if k == "flash_attention" else 0)
            for k in launches}
    check(launches == want, f"prefill launches {launches}, not {want}")
    check(dtypes == ["bfloat16"] * cfg.n_layers,
          f"prefill B6 calls by dtype {dtypes}, not bf16 once per layer")
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
    lg, (q32, k32, v32, kw32), dtypes = capture_layer0(
        lambda: make_serve_step(cfg2, shape2).step(p2, {"tokens": toks2}))
    torch.cuda.synchronize()
    out["check_launches"] = fa.flash_attention.launches - before
    check(out["check_launches"] == CHECK_LAYERS
          and dtypes == ["float32"] * CHECK_LAYERS,
          "the card check prefill did not launch B6's float32 instance once "
          f"per layer ({dtypes})")
    # B6's float32 (FFMA) instance at its layer 0 against its plain version
    ok, out["check_layer_err_vs_plain"] = flash_close(
        fa.flash_attention(q32, k32, v32, **kw32),
        fa.flash_attention_plain(q32, k32, v32, **kw32))
    check(ok, f"B6 float32 != plain at the check prefill's layer 0: "
          f"{out['check_layer_err_vs_plain']}")
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

    # -- the same check in bfloat16: B6's bf16 instance on the card against
    # the CPU's plain path, the same (float32) parameters
    cfg2b = cfg.with_(n_layers=CHECK_LAYERS)
    before = fa.flash_attention.launches
    lgb, _, dtypes = capture_layer0(
        lambda: make_serve_step(cfg2b, shape2).step(p2, {"tokens": toks2}))
    torch.cuda.synchronize()
    out["check_bf16_launches"] = fa.flash_attention.launches - before
    check(out["check_bf16_launches"] == CHECK_LAYERS
          and dtypes == ["bfloat16"] * CHECK_LAYERS,
          "the bf16 card check prefill did not launch B6's bf16 instance "
          f"once per layer ({dtypes})")
    t0 = time.perf_counter()
    lcb = make_serve_step(cfg2b, shape2, device="cpu").step(
        p2_cpu, {"tokens": toks2.cpu()})
    out["check_bf16_cpu_s"] = time.perf_counter() - t0
    a, b = lgb.float().cpu(), lcb.float()
    rel = float((a - b).abs().max() / b.abs().max())
    out["check_bf16_rel_err"] = rel
    out["check_bf16_same_argmax"] = bool(torch.equal(a.argmax(-1),
                                                     b.argmax(-1)))
    check(rel <= CHECK_TOL_BF16, f"card vs CPU bf16 prefill: rel err {rel} > "
          f"{CHECK_TOL_BF16}")
    log(f"[serve] card vs CPU, {CHECK_LAYERS} layers, S={CHECK_SEQ}, bf16: "
        f"rel err {rel:.3g} (tolerance {CHECK_TOL_BF16}), same argmax "
        f"{out['check_bf16_same_argmax']} ({out['check_bf16_cpu_s']:.1f} s "
        "on the CPU)")
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
    # B6's instances: bf16 (tensor cores) at the 32k layer, the main path;
    # float32 (FFMA over a TMA ring) at the check prefill's layer
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, PEAK_FLOPS_FP32
    # the dry-run's model FLOPs (2 x active parameters a token) of this
    # prefill's tokens and of one tick of the 16-slot engine, over their
    # times, as shares of the bf16 peak
    pf, dc = DRYRUN["prefill_32k"], DRYRUN["decode_32k"]
    out["prefill_model_flops"] = (pf["model_flops"] / pf["tokens"]
                                  * PREFILL_BATCH * PREFILL_SEQ)
    out["prefill_bf16_peak_share"] = (out["prefill_model_flops"]
                                      / (out["prefill_ms"] / 1e3)
                                      / PEAK_FLOPS_BF16)
    out["decode_bf16_tick_model_flops"] = (dc["model_flops"] / dc["tokens"]
                                           * TIMED_SLOTS)
    out["decode_bf16_peak_share"] = (out["decode_bf16_tick_model_flops"]
                                     / (out["decode_bf16_tick_ms"] / 1e3)
                                     / PEAK_FLOPS_BF16)
    out["b6"] = {
        "bfloat16": time_b6(q, k, v, kw, PEAK_FLOPS_BF16, out["launches"],
                            graph=dict(launches=5, replays=2)),
        "float32": time_b6(q32, k32, v32, kw32, PEAK_FLOPS_FP32,
                           out["check_launches"], iters=10,
                           graph=dict(launches=10, replays=3))}
    out["b6_share_of_prefill"] = (out["b6"]["bfloat16"]["device_ms"]
                                  * cfg.n_layers / out["prefill_ms"])
    log(f"[serve timing] prefill {out['prefill_ms']:.1f} ms, "
        f"{out['prefill_bf16_peak_share']:.4f} of the bf16 peak; decode "
        f"tick {out['decode_bf16_peak_share']:.6f}; B6 bf16 at the 32k "
        f"layer: {out['b6']['bfloat16']['device_ms']:.3f} ms on the device, "
        f"{out['b6']['bfloat16']['tflops']:.1f} TFLOP/s on the reference "
        f"FLOPs ({out['b6']['bfloat16']['library_ms']:.3f} ms SDPA)")
    log("[serve timing] " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The zoo: MoE, MLA, Mamba-2 SSD, the Hymba hybrid, the Whisper encoder-decoder
# ---------------------------------------------------------------------------

def _zoo_cfg(arch: str):
    """The timed model of ``arch``: its full config, DeepSeek-V2's depth cut
    to ``ZOO_DEEPSEEK_LAYERS``."""
    from repro_torch.configs import get
    cfg = get(arch)
    return cfg.with_(n_layers=ZOO_DEEPSEEK_LAYERS) if arch == ZOO_DEEPSEEK else cfg


def _zoo_params(cfg):
    """The timed model's parameters: ``init_params`` from ``PRNGKey(0)``,
    except DeepSeek-V2's, laid out on the ``meta`` device and filled from
    a seeded ``torch.Generator`` at the reference's scales (norms 1, the
    embedding and head 0.02, every other matrix 1/sqrt(fan-in)): its
    [160, 5120, 1536] expert leaves would need int64 threefry temporaries
    of ~10 GB each.  The values do not change the work."""
    import torch
    from repro_torch.core import prng
    from repro_torch.models import init_params
    if cfg.name != ZOO_DEEPSEEK:
        return init_params(cfg, prng.PRNGKey(0, device=DEV)), "init_params"
    model = init_params(cfg, prng.PRNGKey(0, device="meta"),
                        device="meta").to_empty(device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() <= 1:
                p.fill_(1.0)
            elif name in ("embed", "lm_head"):
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.normal_(0.0, p.shape[-2] ** -0.5, generator=gen)
    return model, "seeded torch.Generator fill (see _zoo_params)"


def _zoo_batch(cfg, b: int, s: int, seed: int) -> dict:
    """A prefill batch: random tokens, and for the encoder-decoder
    ``synth_audio_frames`` (B, source_len, d_model)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.models.frontends import synth_audio_frames
    gen = torch.Generator(device=DEV).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), device=DEV,
                                     generator=gen)}
    if cfg.is_enc_dec:
        batch["frames"] = synth_audio_frames(prng.PRNGKey(seed, device=DEV), b,
                                             cfg.source_len, cfg.d_model)
    return batch


def _keep_kinds(calls, q, k, v, kw) -> bool:
    """Keep the first B6 call of each (causal, window, T == S) kind: a
    self-attention layer's and a cross-attention layer's."""
    kind = (kw.get("causal", True), kw.get("window", 0), k.shape[1] == q.shape[1])
    return all((c[3].get("causal", True), c[3].get("window", 0),
                c[1].shape[1] == c[0].shape[1]) != kind for c in calls)


def _b6_vs_plain(calls, tol) -> tuple[float, float]:
    """Each captured B6 call against its plain version within ``tol``: the
    largest error, and the plain version's ms (CUDA events) summed."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    err, plain_ms = 0.0, 0.0
    for q, k, v, kw in calls:
        got = fa.flash_attention(q, k, v, **kw)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = fa.flash_attention_plain(q, k, v, **kw)
        stop.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(stop)
        ok, e = flash_close(got, want, tol)
        check(ok, f"B6 != plain at q {tuple(q.shape)} k {tuple(k.shape)} "
              f"v {tuple(v.shape)} {kw} {q.dtype}: {e} (tolerance {tol})")
        err = max(err, e)
        del got, want
    return err, plain_ms


@contextlib.contextmanager
def _moe_routes():
    """For the block, each MoE dispatch's top-k expert sets recorded in the
    list yielded (sorted, on the host), recomputed from its router as the
    dispatch computes them."""
    import torch
    from repro_torch.models import moe
    routes, real = [], moe._moe_core

    def watched(p, xt, cfg):
        probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
        routes.append(torch.sort(top[:, :cfg.moe_top_k], dim=-1)[0].cpu())
        return real(p, xt, cfg)

    moe._moe_core = watched
    try:
        yield routes
    finally:
        moe._moe_core = real


def _zoo_prefill(arch: str) -> dict:
    """One family's timed model: its prefill (the main path, counts zeroed
    just before and read just after), B6 against plain at each kind of
    layer it meets, the prefill's time, peak memory, B6 share and top
    kernels, then its decode."""
    import gc

    import torch
    from repro_torch.configs import InputShape
    from repro_torch.models import init_caches, param_count
    from repro_torch.serving import ServingEngine
    from repro_torch.training.serve import make_serve_step
    out = {}
    cfg = _zoo_cfg(arch)
    b, s = ZOO_PREFILL[arch]
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, out["weights"] = _zoo_params(cfg)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = param_count(params)
    check(out["params"] == ZOO_PARAMS[arch],
          f"{arch} has {out['params']} parameters, not {ZOO_PARAMS[arch]}")
    bundle = make_serve_step(cfg, InputShape("prefill", s, b, "prefill"))
    batch = _zoo_batch(cfg, b, s, seed=13)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, calls, dtypes = _capture_b6(lambda: bundle.step(params, batch),
                                        keep=_keep_kinds)
    torch.cuda.synchronize()
    out["prefill_first_ms"] = (time.perf_counter() - t0) * 1e3
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: (ZOO_B6_LAUNCHES[arch] if k == "flash_attention" else 0)
            for k in launches}
    check(launches == want, f"{arch} prefill launches {launches}, not {want}")
    dt = str(getattr(torch, cfg.compute_dtype)).removeprefix("torch.")
    check(dtypes == [dt] * ZOO_B6_LAUNCHES[arch],
          f"{arch} prefill B6 calls by dtype {dtypes}")
    check(logits.shape == (b, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{arch} prefill logits {tuple(logits.shape)} not finite / shaped")
    out["launches"] = launches["flash_attention"]
    out["prefill_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["next_tokens"] = logits.float().argmax(-1).tolist()
    out["b6_calls"] = [dict(q=list(q.shape), k=list(k.shape), v=list(v.shape),
                            **kw) for q, k, v, kw in calls]
    if calls:
        out["layer_err_vs_plain"], out["plain_ms"] = _b6_vs_plain(calls,
                                                                  LAYER_TOL)
    else:
        why = ("no attention layer; its SSD runs as torch operations"
               if cfg.arch_type == "ssm" else "its attention stays dense at "
               "these lengths (DENSE_MAX_SEQ)")
        log(f"[zoo] {arch}: prefill {b} x {s} launches no kernel ({why})")
    # times: the prefill again, then under the profiler
    t0 = time.perf_counter()
    bundle.step(params, batch)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["prefill_tokens_per_s"] = b * s / out["prefill_ms"] * 1e3
    rows = device_profile(lambda: bundle.step(params, batch), iters=1,
                          warm=False)
    busy = sum(r[1] for r in rows)
    out["prefill_device_ms"] = busy
    out["prefill_idle_share"] = 1.0 - busy / out["prefill_ms"]
    out["b6_device_ms"] = sum(r[1] for r in rows if "flash_fwd" in r[0])
    out["b6_share_of_prefill"] = out["b6_device_ms"] / out["prefill_ms"]
    out["prefill_top_kernels"] = [(n[:60], ms, c) for n, ms, c in rows[:5]]
    if calls:
        from repro_torch.launch.mesh import PEAK_FLOPS_BF16, PEAK_FLOPS_FP32
        q, k, v, kw = calls[0]
        ops = (PEAK_FLOPS_BF16 if q.dtype == torch.bfloat16
               else PEAK_FLOPS_FP32)
        out["b6"] = time_b6(q, k, v, kw, ops, out["launches"],
                            plain_ms=out["plain_ms"])
    del calls, logits
    log(f"[zoo] {arch} prefill {b} x {s} ({out['weights']}, "
        f"{out['params']} parameters, init {out['init_s']:.1f} s): "
        f"{out['prefill_ms']:.1f} ms, {out['prefill_tokens_per_s']:.0f} tok/s, "
        f"peak {out['prefill_peak_mem_gib']:.2f} GiB, B6 {out['launches']} "
        f"launches, {100 * out['b6_share_of_prefill']:.1f}% of the prefill, "
        f"idle {100 * out['prefill_idle_share']:.1f}%; top kernels "
        f"{[(n[:40], round(ms, 2)) for n, ms, _ in out['prefill_top_kernels']]}")

    # decode on the timed model
    _free_card()
    if arch in ZOO_ENGINE:
        slots, cache = ZOO_ENGINE[arch]
        prompts = _prompts(cfg.vocab, slots)
        eng = ServingEngine(cfg, params, max_batch=slots, cache_len=cache)
        reqs, ticks, secs = _engine_run(eng, prompts)
        check(all(len(r.out) == m for r, (_, m) in zip(reqs, prompts)),
              f"{arch} engine left a request unanswered")
        out["decode"] = dict(engine_slots=slots, cache=cache, ticks=ticks,
                             tick_ms=secs * 1e3 / ticks)
        del eng
        gc.collect()
    else:
        # a few ticks of the decode step at DECODE_32K's cache, batch 1
        # (DeepSeek: absorbed MLA over the latent cache; hymba: its ring
        # cache of the window beside the SSM state; mamba2: the state only)
        shape = InputShape("decode_32k", PREFILL_SEQ, 1, "decode")
        step = make_serve_step(cfg, shape)
        caches = init_caches(cfg, 1, step.cache_len)
        # (the position a device tensor, as the engine passes it: a host
        # int would be copied to the card once per layer)
        tok = torch.zeros(1, 1, dtype=torch.int64, device=DEV)
        pos = torch.arange(PREFILL_SEQ, PREFILL_SEQ + ZOO_DECODE_TICKS, device=DEV)
        lg = None
        for t in range(ZOO_DECODE_TICKS):
            lg, caches = step.step(params, caches, tok, pos[t])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lg.float()).all()), f"{arch} decode not finite")
        out["decode"] = dict(
            ring=step.ring, cache=step.cache_len,
            absorbed=bool(cfg.mla_absorbed) if cfg.attn_kind == "mla" else None,
            tick_ms=cuda_ms(lambda: step.step(params, caches, tok, pos[0]),
                            iters=ZOO_DECODE_TICKS, warmup=0))
        del caches
    log(f"[zoo] {arch} decode: {out['decode']}")
    del params, bundle, batch
    _free_card()
    return out


def _zoo_check_cpu(cfg, cpu, seq, dts, batch_cpu) -> dict:
    """The CPU's side of :func:`_zoo_check`: the prefill of each dtype of
    ``dts``, with its MoE routes, and its seconds."""
    from repro_torch.configs import InputShape
    from repro_torch.training.serve import make_serve_step
    shape = InputShape("prefill_check", seq, 1, "prefill")
    out = {}
    for dt in dts:
        c = cfg.with_(compute_dtype=dt)
        t0 = time.perf_counter()
        with _moe_routes() as routes:
            lc = make_serve_step(c, shape, device="cpu").step(cpu, batch_cpu)
        out[dt] = (lc.float(), routes if c.n_experts else None,
                   time.perf_counter() - t0)
    return out


def _zoo_check(arch: str) -> dict:
    """One family at ``CHECK_LAYERS`` layers, full width (DeepSeek's
    experts and sequence cut for the CPU's sake), S = CHECK_SEQ: the card's
    prefill in float32 (B6's float32 instance held to plain at each kind of
    layer) and in bfloat16, then a float32 ``ServingEngine``'s tokens
    against each request's own greedy decode.  The same prefills on the
    CPU (:func:`_zoo_check_cpu`) go to :data:`SIDE` for a model of up to
    ZOO_SIDE_MAX_BYTES of parameters, beside the card's work (the gates
    when it settles), and run here for a larger one: the card against the
    CPU in float32 and in bfloat16 (gated without a router; with one, the
    share of tokens routed to another expert set is reported)."""
    import copy

    import torch
    from repro_torch.configs import InputShape
    from repro_torch.core import prng
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    from repro_torch.training.serve import make_serve_step
    out = {}
    cut = dict(n_layers=CHECK_LAYERS, **ZOO_CHECK_CUTS.get(arch, {}))
    if arch == "whisper_tiny":
        cut["encoder_layers"] = CHECK_LAYERS
    cfg = _zoo_cfg(arch).with_(compute_dtype="float32", param_dtype="float32",
                               **cut)
    out["cuts"] = cut
    _free_card()
    params = init_params(cfg, prng.PRNGKey(0, device=DEV))
    cpu = copy.deepcopy(params).cpu()
    seq, blocks = ZOO_CHECK_SEQ.get(arch, (CHECK_SEQ, {}))
    cfg = cfg.with_(**blocks)
    if seq != CHECK_SEQ:
        out["cuts"]["seq"] = seq
    shape = InputShape("prefill_check", seq, 1, "prefill")
    batch = _zoo_batch(cfg, 1, seq, seed=17)
    card, on_cpu = {}, []
    for dt in ("float32", "bfloat16"):
        c = cfg.with_(compute_dtype=dt)
        t0 = time.perf_counter()
        with _moe_routes() as routes:
            lg, calls, dtypes = _capture_b6(
                lambda: make_serve_step(c, shape).step(params, batch),
                keep=_keep_kinds)
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        check(dtypes == [dt] * len(dtypes)
              and len(dtypes) == ZOO_CHECK_B6[arch],
              f"{arch} check prefill {dt}: B6 calls {dtypes}, want "
              f"{ZOO_CHECK_B6[arch]}")
        err = None
        if calls:
            err, _ = _b6_vs_plain(calls, None)
        res = dict(seq=seq, b6_launches=len(dtypes), b6_err_vs_plain=err,
                   b6_shapes=[[list(q.shape), list(k.shape), list(v.shape),
                               kw] for q, k, v, kw in calls],
                   card_s=card_s, on_cpu=(arch, dt) not in ZOO_CHECK_CARD_ONLY)
        out[dt] = res
        if res["on_cpu"]:
            on_cpu.append(dt)
            card[dt] = (lg.float().cpu(), routes if c.n_experts else None)
        else:
            check(bool(torch.isfinite(lg).all()),
                  f"{arch} check prefill {dt}: non-finite logits")
            log(f"[zoo check] {arch} {CHECK_LAYERS} layers S={seq} {dt}: "
                f"card only, B6 {len(dtypes)} launches (err vs plain {err})")
        del lg, calls

    def gate(cpu_out, seconds) -> None:
        for dt in on_cpu:
            res = out[dt]
            (a, card_r), (b, cpu_r, res["cpu_s"]) = card[dt], cpu_out[dt]
            rel = float((a - b).abs().max() / b.abs().max())
            res.update(rel_err=rel, same_argmax=bool(torch.equal(
                a.argmax(-1), b.argmax(-1))))
            if card_r is not None:
                check(len(card_r) == len(cpu_r) > 0,
                      f"{arch}: routes not recorded")
                res["routing_flip_share_by_layer"] = [
                    float((x != y).any(-1).float().mean())
                    for x, y in zip(card_r, cpu_r)]
            if dt == "float32":
                flips = max(res.get("routing_flip_share_by_layer", [0.0]))
                check(flips <= ZOO_FLIP_MAX_F32, f"{arch} f32 routing differs "
                      f"card vs CPU: {res.get('routing_flip_share_by_layer')}")
                tol = CHECK_TOL if flips == 0.0 else CHECK_TOL_BF16
                check(rel <= tol and (res["same_argmax"] or flips > 0.0),
                      f"{arch} card vs CPU f32 prefill: rel err {rel} "
                      f"(tolerance {tol}), same argmax {res['same_argmax']}")
            elif not cfg.n_experts:
                check(rel <= CHECK_TOL_BF16,
                      f"{arch} card vs CPU bf16 prefill: rel err {rel} > "
                      f"{CHECK_TOL_BF16}")
            log(f"[zoo check] {arch} {CHECK_LAYERS} layers S={seq} {dt}: "
                f"rel err {rel:.3g}, B6 {res['b6_launches']} launches (err "
                f"vs plain {res['b6_err_vs_plain']}), routing flips "
                f"{res.get('routing_flip_share_by_layer')} (card "
                f"{res['card_s']:.1f} s, CPU {res['cpu_s']:.1f} s"
                f"{' on the CPU side' if out['cpu_side'] else ''})")

    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    nbytes = sum(t.numel() * t.element_size() for t in cpu.parameters())
    out["cpu_side"] = nbytes <= ZOO_SIDE_MAX_BYTES
    if out["cpu_side"]:
        SIDE.submit(f"zoo {arch}", gate, _zoo_check_cpu, cfg, SIDE.put(cpu),
                    seq, on_cpu, SIDE.put(batch_cpu))
    else:
        gate(_zoo_check_cpu(cfg, cpu, seq, on_cpu, batch_cpu), None)
    del cpu

    # the float32 engine on the card: each request's tokens its own greedy
    # decode
    prompts = _prompts(cfg.vocab)
    eng = ServingEngine(cfg, params, max_batch=DECODE_SLOTS,
                        cache_len=DECODE_CACHE)
    reqs, ticks, secs = _engine_run(eng, prompts)
    for r, (p, m) in zip(reqs, prompts):
        check(len(r.out) == m, f"{arch} request {r.uid} got {len(r.out)} of {m}")
        alone = _greedy(cfg, params, p, m)
        check(r.out == alone, f"{arch} request {r.uid}: engine {r.out} != its "
              f"own greedy decode {alone}")
    out["engine_f32"] = dict(requests=len(reqs), ticks=ticks,
                             tick_ms=secs * 1e3 / ticks)
    log(f"[zoo check] {arch} engine f32: {len(reqs)} requests on "
        f"{DECODE_SLOTS} slots, {ticks} ticks, tokens equal to independent "
        "decode")
    del eng, params
    _free_card()
    return out


def phase_zoo() -> dict:
    """The rest of the model zoo on the card: each family's timed model
    (its prefill the main path of this phase), then each family's
    card-vs-CPU check and float32 engine.  The timed models all run
    first, while the CPU side is idle: the checks' CPU prefills go to it
    (:func:`_zoo_check`), and the host-bound prefills and ticks are not
    timed beside them."""
    out = {"prefill": {}, "check": {}, "phase_s": {}}
    for arch in ZOO:
        t0 = time.perf_counter()
        out["prefill"][arch] = _zoo_prefill(arch)
        out["phase_s"][f"{arch} prefill"] = time.perf_counter() - t0
    for arch in ZOO:
        t0 = time.perf_counter()
        out["check"][arch] = _zoo_check(arch)
        out["phase_s"][f"{arch} check"] = time.perf_counter() - t0
    # the CPU's prefills that ran on the CPU side, and their gates
    t0 = time.perf_counter()
    SIDE.settle()
    out["phase_s"]["cpu_side_waited"] = time.perf_counter() - t0
    out["launches"] = sum(p["launches"] for p in out["prefill"].values())
    log("[zoo] " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# train path: Qwen3-0.6B's FediAC train step (training/dist_step.py)
# ---------------------------------------------------------------------------

TRAIN_RANKS = 2                   # clients, one gloo rank each, on the card
#: per-client batch: 4 rows of TRAIN_4K's 4,096 tokens (configs/base.py),
#: above DENSE_MAX_SEQ, so every attention layer runs B6 forward and back
TRAIN_ROWS, TRAIN_SEQ = 4, 4096
TRAIN_LR = 1e-2                   # make_train_step's default
TRAIN_SCHEDULE = ("default", "default", "default", "A", "B")
#: the steps whose every leaf is held to the conservation bound: the first
#: of each config
TRAIN_CONSERVED = (0, 3, 4)
TRAIN_PROFILE_TOP = 8             # kernels listed from the profiled step
TRAIN_LEAVES = 13                 # Qwen3-0.6B's reference tree (gated)
#: the kernels each config's aggregation launches, once per leaf
TRAIN_PATH_KERNELS = {"default": ("gather_quant",), **AR_PATH_KERNELS}
TRAIN_KERNELS = ("gather_quant", "vote_pack", "pack", "popcount_accum")
TRAIN_CHECK_LAYERS = 2            # the card-vs-CPU steps: 2 layers, float32,
TRAIN_CHECK_ROWS = 1              # 1 row per client, E = 1, at each of
#: these sequence lengths (and config changes): the dense branch, and the
#: blockwise one above DENSE_MAX_SEQ (B6 forward and backward on the card
#: against the CPU's blockwise scan, q blocks of 1,152 as ZOO_CHECK_SEQ)
TRAIN_CHECKS = {"256": (256, {}), "2304": (2_304, dict(attn_q_block=1_152))}
TRAIN_CHECK_RTOL = 1e-5           # their loss against the CPU's
TRAIN_CHECK_GRAD_TOL = 1e-4       # each update leaf, of its largest |u|
#: B6's backward held to autograd through its plain forward on the card:
#: (name, q shape, KV heads, Dv, causal, window, T, dtypes): Qwen3-0.6B's
#: train layer, granite's head size, MLA's 192 / 128, hymba's window,
#: whisper's cross shape (448 queries over 1,500 frames)
B6_BWD_CASES = (
    ("qwen3", (1, 4096, 16, 128), 8, 128, True, 0, 4096,
     ("bfloat16", "float32")),
    ("granite", (1, 4096, 16, 64), 8, 64, True, 0, 4096, ("bfloat16",)),
    ("mla", (1, 4096, 16, 192), 16, 128, True, 0, 4096, ("bfloat16",)),
    ("hymba", (1, 4096, 25, 64), 5, 64, True, 2048, 4096, ("bfloat16",)),
    ("cross", (2, 448, 6, 64), 6, 64, False, 0, 1500, ("bfloat16",)),
)
B6_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of each gradient's max
#: the check step's leaves the CPU aggregates again, by size: not the
#: embedding, whose 155.6M coordinates of threefry took the host's CPU
#: 200 s of a 243 s replay (PERF.md section 6)
TRAIN_REPLAY_MAX = 1 << 26
#: the train path's two largest leaves, one row each: Qwen3-0.6B's
#: embedding (151,936 x 1,024) and a stack of 28 MLP projections
#: (28 x 3,072 x 1,024); the timing phase times B1 at both, B3 and B5 at
#: the first
TRAIN_TIMED_LEAVES = (155_582_464, 88_080_384)
#: a replayed graph of that many launches (and replays) for the kernels at
#: those shapes: each launch of B1 there allocates 1.2 GB of outputs
TRAIN_TIMED_GRAPH = dict(launches=5, replays=4)
DIGEST_CHUNK = 1 << 24


def _train_cfgs(**kw) -> dict:
    """Qwen3-0.6B as published (with ``kw``'s changes) under each
    aggregation config: its default FediACConfig (top-k / top-k, count
    wire) and the allreduce path's A and B, each at ``granularity="tensor"``
    with the kernels on."""
    from repro_torch.configs import get
    from repro_torch.core.engines import EngineSpec
    cfg = get(QWEN).with_(**kw)
    fed = dict(default=dataclasses.replace(
        cfg.fediac, engine=EngineSpec(use_pallas=True)), **_ar_configs())
    return {name: cfg.with_(fediac=dataclasses.replace(f, granularity="tensor"))
            for name, f in fed.items()}


def _digest(t) -> int:
    """A 64-bit digest of a float32 tensor's bits: the sum of each element's
    bits times an odd weight from its index, in wrapping int64.  Any one
    element that differs changes it."""
    import torch
    flat = t.detach().reshape(-1).view(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    for s in range(0, flat.numel(), DIGEST_CHUNK):
        bits = flat[s:s + DIGEST_CHUNK].to(torch.int64)
        idx = torch.arange(s, s + bits.numel(), device=flat.device)
        total += (bits * (idx * -7046029254386353131 + 1442695040888963407
                          | 1)).sum()
    return int(total)


class _HeldToPlain:
    """While active, every launch of the kernels ``names`` through
    ``kernels.ops`` is followed by its plain version on the same operands,
    on the card, the two held bitwise: ``launches`` counts the launches so
    held, ``bad`` lists those that differed.  The plain calls are timed
    apart, synchronized before and after: ``ms`` in all, and their
    wall-clock windows ``windows_ns``, which a step's times and idle share
    leave out.  Their memory is left out of the peak: ``peak`` is the
    largest allocation seen outside them (the peak counter is reset after
    each)."""

    def __init__(self, names: tuple):
        self.names, self.launches = names, {n: 0 for n in names}
        self.bad, self.ms, self.windows_ns, self.peak = [], 0.0, [], 0

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.bitpack import pack_plain
        from repro_torch.kernels.gather_quant import gather_quant_plain
        from repro_torch.kernels.vote_pack import vote_pack_plain
        from repro_torch.kernels.vote_popcount import popcount_accum_plain
        plain = {"gather_quant": gather_quant_plain, "pack": pack_plain,
                 "vote_pack": vote_pack_plain,
                 "popcount_accum": popcount_accum_plain}
        counters = _counters()
        self.real = {n: getattr(ops, n) for n in self.names}
        for n in self.names:
            setattr(ops, n, self._held(n, self.real[n], plain[n], counters[n]))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for n, fn in self.real.items():
            setattr(ops, n, fn)

    def _held(self, name, fn, plain, kernel):
        import torch

        def call(*args, **kw):
            # the plain version computes a fresh residual: an ``out=``
            # that is not u itself is compared with it as it stands
            before = kernel.launches
            got = fn(*args, **kw)
            if kernel.launches == before:
                return got
            torch.cuda.synchronize()
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
            w0, t0 = time.time_ns(), time.perf_counter()
            want = plain(*args)
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            if not all(same_bits(a, b) for a, b in pairs):
                self.bad.append(f"{name} {list(args[0].shape)}")
            del want
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1e3
            self.windows_ns.append((w0, time.time_ns()))
            self.launches[name] += 1
            torch.cuda.reset_peak_memory_stats()
            return got
        return call


class _AggRecorder:
    """``dist_step._aggregate`` watched while a train step runs: each call's
    operands and results kept for the gates, and its time (synchronized)."""

    def __init__(self):
        from repro_torch.training import dist_step
        self.mod, self.real, self.calls = dist_step, dist_step._aggregate, []

    def __enter__(self):
        self.mod._aggregate = self
        return self

    def __exit__(self, *exc):
        self.mod._aggregate = self.real

    def __call__(self, cfg, update, residual, key, layout, group):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, new_res = self.real(cfg, update, residual, key, layout, group)
        torch.cuda.synchronize()
        self.calls.append(dict(update=update, residual=residual, mean=mean,
                               new_res=new_res, layout=layout,
                               ms=(time.perf_counter() - t0) * 1e3))
        return mean, new_res


def _train_gates(call, world: int, conservation: bool) -> dict:
    """This rank's gates of one train step: digests of its parameters and
    of the mean (the parent compares them across ranks), and with
    ``conservation`` for every leaf the mean against the averaged
    ``u + res - new_res`` within the allreduce path's bound (eight float32
    ulps of the group's max |u + res|), which sums 2.4 GB over gloo."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import collectives
    lay = call["layout"]
    u, res, new_res, mean = (call[k] for k in ("update", "residual",
                                               "new_res", "mean"))
    errs, tols = [], []
    for o, n in (lay.spans if conservation else ()):
        left = (u[o:o + n] + res[o:o + n] - new_res[o:o + n]).to(torch.float32)
        dist.all_reduce(left)
        gmax = collectives.pmax_((u[o:o + n] + res[o:o + n]).abs().max())
        errs.append(float((left / world - mean[o:o + n]).abs().max()))
        tols.append(8 * 2.0**-23 * float(gmax))
        del left
    return {"finite": bool(torch.isfinite(mean).all()
                           and torch.isfinite(new_res).all()
                           and all(torch.isfinite(p).all()
                                   for p in lay.params)),
            "leaves": len(lay.spans),
            "mean_digest": _digest(mean),
            "params_digest": [_digest(p) for p in lay.params],
            "conservation_err": errs, "conservation_tol": tols}


def _merge_spans(spans) -> list:
    """Intervals ``(start, end)`` merged into disjoint ones, in order."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _train_batches(vocab: int, rows: int, seq: int, n: int, seed: int) -> list:
    """``n`` global batches of ``lm_batches`` (the reference launcher's
    Markov token streams); every rank makes the same ones."""
    import numpy as np
    from repro_torch.data.synthetic import lm_batches
    return list(lm_batches(np.random.default_rng(seed), vocab, rows, seq, n))


def _check_cfg(tag: str):
    """Qwen3-0.6B at full width cut to TRAIN_CHECK_LAYERS layers, float32,
    E = 1, with check ``tag``'s changes: (cfg, sequence length)."""
    seq, kw = TRAIN_CHECKS[tag]
    return _train_cfgs(n_layers=TRAIN_CHECK_LAYERS, compute_dtype="float32",
                       fl_local_steps=1, **kw)["default"], seq


def _train_check_step(rank: int, world: int, tmp: str, mesh, tag: str) -> dict:
    """The card's side of check step ``tag`` (:func:`_check_cfg`): one
    step, every FediAC kernel launch held to its plain version on the card
    (:class:`_HeldToPlain`), the embedding's included; its weights (rank
    0) and each rank's update, mean and new residual go to ``tmp`` for the
    CPU's replay.  Returns the step's loss, the launches held to plain and
    those that differed, and B6's forward and backward launches."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params
    from repro_torch.training import dist_step
    cfg, seq = _check_cfg(tag)
    params = init_params(cfg, prng.PRNGKey(0, device=DEV), device=DEV)
    layout = dist_step.FlatLayout(params)
    if rank == 0:
        torch.save(layout.gather().cpu(), f"{tmp}/check{tag}_params.pt")
    batch = _train_batches(cfg.vocab, world * TRAIN_CHECK_ROWS, seq, 1, 1)[0]
    bundle = dist_step.make_train_step(cfg, mesh, lr=TRAIN_LR, use_pallas=True)
    b6 = (fa.flash_attention.launches, fa.flash_attention.backward_launches)
    with _AggRecorder() as rec, _HeldToPlain(TRAIN_KERNELS) as held:
        _, _, metrics = bundle.step(params, torch.zeros(layout.size,
                                                        device=DEV),
                                    batch, prng.PRNGKey(2, device=DEV))
    b6 = [fa.flash_attention.launches - b6[0],
          fa.flash_attention.backward_launches - b6[1]]
    (call,) = rec.calls
    replayed = [(o, n) for o, n in layout.spans if n <= TRAIN_REPLAY_MAX]
    torch.save({"update": call["update"].cpu(),
                **{k: [call[k][o:o + n].cpu() for o, n in replayed]
                   for k in ("mean", "new_res")}},
               f"{tmp}/check{tag}_{rank}.pt")
    return {"loss": float(metrics["loss"]), "plain_launches": held.launches,
            "plain_bad": held.bad, "b6_launches": b6}


def train_rank(rank: int, world: int, tmp: str) -> dict:
    """One client of the train path (runs in a spawned rank).  First the
    check step (:func:`_train_check_step`), after which rank 0 marks
    ``tmp`` so the CPU's replay can start beside the rest; then Qwen3-0.6B's
    train step at full width through ``make_train_step``, the steps of
    ``TRAIN_SCHEDULE`` each gated and timed, the last default one also
    profiled (device activity only)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import prng
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params
    from repro_torch.training import dist_step
    torch.cuda.set_device(0)
    mesh = make_test_mesh()
    t0 = time.perf_counter()
    report = {"rank": rank, "steps": []}
    report["checks"] = {}
    for tag in TRAIN_CHECKS:
        report["checks"][tag] = _train_check_step(rank, world, tmp, mesh, tag)
        _free_card()
    dist.barrier()
    if rank == 0:
        Path(f"{tmp}/check_ready").touch()
    report["check_s"] = time.perf_counter() - t0

    counters = _counters()
    cfgs = _train_cfgs()
    bundles = {name: dist_step.make_train_step(cfg, mesh, lr=TRAIN_LR,
                                               use_pallas=True)
               for name, cfg in cfgs.items()}
    t0 = time.perf_counter()
    params = init_params(cfgs["default"], prng.PRNGKey(0, device=DEV),
                         device=DEV)
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    layout = dist_step.FlatLayout(params)
    residual = torch.zeros(layout.size, device=DEV)
    batches = _train_batches(cfgs["default"].vocab, world * TRAIN_ROWS,
                             TRAIN_SEQ, len(TRAIN_SCHEDULE), 0)
    profiled = max(t for t, n in enumerate(TRAIN_SCHEDULE) if n == "default")
    key = prng.PRNGKey(1, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    report["launches_by_shape"], peak = {}, 0
    for t, name in enumerate(TRAIN_SCHEDULE):
        for c in counters.values():
            c.launches = 0
        fa.flash_attention.backward_launches = 0
        key, sk = prng.split(key)
        dist.barrier()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wall_ns = [time.time_ns()]
        with contextlib.ExitStack() as stack:
            rec = stack.enter_context(_AggRecorder())
            stack.enter_context(_quant_tally(report["launches_by_shape"],
                                             TRAIN_KERNELS))
            held = stack.enter_context(_HeldToPlain(TRAIN_KERNELS))
            if t == profiled:
                prof = stack.enter_context(profile(
                    activities=[ProfilerActivity.CUDA]))
            params, residual, metrics = bundles[name].step(
                params, residual, batches[t], sk)
            torch.cuda.synchronize()
            # the plain versions' checks (all inside the aggregation) are
            # left out of the step's times
            step_ms = (time.perf_counter() - t1) * 1e3 - held.ms
            wall_ns.append(time.time_ns())
        peak = max(peak, held.peak)
        launches = {k: c.launches for k, c in counters.items()}
        launches["flash_attention_backward"] = \
            fa.flash_attention.backward_launches
        (call,) = rec.calls
        t1 = time.perf_counter()
        step = {"config": name, "loss": float(metrics["loss"]),
                "update_norm": float(metrics["update_norm"]),
                "step_ms": step_ms, "aggregate_ms": call["ms"] - held.ms,
                "local_ms": step_ms - call["ms"] + held.ms,
                "launches": launches, "plain_launches": held.launches,
                "plain_bad": held.bad, "plain_check_ms": held.ms,
                "plain_windows_ns": held.windows_ns,
                "profiled": t == profiled, "wall_ns": wall_ns,
                **_train_gates(call, world, t in TRAIN_CONSERVED)}
        step["gates_ms"] = (time.perf_counter() - t1) * 1e3
        report["steps"].append(step)
        del call, rec
    # the trace's device activity read raw (its 174k events take the
    # profiler's own summaries ~40 s): ms and launches by kernel name, and
    # the busy intervals in wall-clock ns, merged, for the card's idle
    # share across ranks
    t0 = time.perf_counter()
    spans, by_name = [], {}
    # this rank's plain-version checks are left out: they run inside its
    # own windows, which are synchronized at both ends
    own = next(s for s in report["steps"] if s["profiled"])["plain_windows_ns"]
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            a, b = e.start_ns(), e.end_ns()
            if any(w0 <= a < w1 for w0, w1 in own):
                continue
            spans.append((a, b))
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + (b - a) / 1e6, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    report["profile"] = {"busy_ms": sum(r[1] for r in rows),
                         "launches": len(spans),
                         "top": rows[:TRAIN_PROFILE_TOP],
                         "b6_backward": [r for r in rows
                                         if "flash_bwd_" in r[0]],
                         "busy_ns": _merge_spans(spans)}
    report["profile_s"] = time.perf_counter() - t0
    report["peak_gib"] = max(peak, torch.cuda.max_memory_allocated()) / 2**30
    report["leaves"] = len(layout.spans)
    return report


def train_check_rank(rank: int, world: int, tmp: str) -> dict:
    """One client of each check step on the CPU (:func:`_check_one`)."""
    return {tag: _check_one(rank, world, tmp, tag) for tag in TRAIN_CHECKS}


def _check_one(rank: int, world: int, tmp: str, tag: str) -> dict:
    """One client of check step ``tag`` on the CPU, from the card's
    weights: its own local update (loss and update against the card's; the
    blockwise branch runs the plain scan here), then the card's update
    aggregated again here leaf by leaf, as ``_aggregate`` does it (each
    leaf with its key of ``split(key, leaves)``), against the card's mean
    and residual bitwise; leaves above TRAIN_REPLAY_MAX coordinates are
    left out and listed."""
    import os
    import torch
    from repro_torch.core import prng
    from repro_torch.models import init_params
    from repro_torch.training import dist_step
    # the host's cores less two for each of the card's ranks (its own and
    # its gloo work), running beside
    torch.set_num_threads(max(1, ((os.cpu_count() or 4) - 2 * world)
                              // world))
    cfg, seq = _check_cfg(tag)
    params = init_params(cfg, prng.PRNGKey(0, device="meta"),
                         device="meta").to_empty(device="cpu")
    layout = dist_step.FlatLayout(params)
    with torch.no_grad():
        for p, w in zip(layout.params, layout.views(
                torch.load(f"{tmp}/check{tag}_params.pt"))):
            p.copy_(w)
    batch = _train_batches(cfg.vocab, world * TRAIN_CHECK_ROWS, seq, 1, 1)[0]
    t0 = time.perf_counter()
    update, loss, _ = dist_step._local_update(
        cfg, params, dist_step._rows(batch, rank, TRAIN_CHECK_ROWS, "cpu"),
        TRAIN_LR, layout, 1)
    local_s = time.perf_counter() - t0
    card = torch.load(f"{tmp}/check{tag}_{rank}.pt")
    err = max(float((card["update"][o:o + n] - update[o:o + n]).abs().max()
                    / update[o:o + n].abs().max())
              for o, n in layout.spans)
    t0 = time.perf_counter()
    keys = prng.split(prng.PRNGKey(2, device="cpu"), len(layout.spans))
    same, skipped, replayed = True, [], 0
    card_out = zip(card["mean"], card["new_res"])
    for (o, n), k in zip(layout.spans, keys):
        if n > TRAIN_REPLAY_MAX:
            skipped.append(n)
            continue
        m, nr = dist_step._aggregate_flat(cfg, card["update"][o:o + n],
                                          torch.zeros(n), k, None)
        card_m, card_nr = next(card_out)
        same &= (same_bits(m.to(torch.float32), card_m)
                 and same_bits(nr.to(torch.float32), card_nr))
        replayed += n
    return {"loss": float(loss), "update_rel_err": err, "local_s": local_s,
            "replay_s": time.perf_counter() - t0, "same": same,
            "replayed": replayed, "skipped": skipped}


def _visible_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """The (query, key) pairs B6's mask leaves visible in one head."""
    import torch
    i = torch.arange(s, dtype=torch.int64)
    hi = torch.clamp(i + 1, max=t) if causal else torch.full_like(i, t)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    return int((hi - lo).clamp(min=0).sum())


def _sdpa_operands(q, k, v, causal: bool, window: int,
                   grad: bool = False) -> tuple:
    """SDPA's operands and keywords for B6's, and the (B, H, S, D) views of
    q, k and v they come from: a boolean mask with the KV heads repeated
    for a window (the masked kernel takes no grouped heads), else
    ``is_causal`` and ``enable_gqa``; with ``grad`` the views are leaves
    that require a gradient."""
    import torch
    h, hk = q.shape[2], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if grad:
        qt, kt, vt = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    if not window:
        return ((qt, kt, vt), dict(is_causal=causal, enable_gqa=hk != h),
                (qt, kt, vt))
    kr, vr = (x.repeat_interleave(h // hk, dim=1) for x in (kt, vt))
    j = torch.arange(k.shape[1], device=q.device)
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    mask = (j[None, :] > i - window) & ((j[None, :] <= i) if causal else True)
    return (qt, kr, vr), dict(attn_mask=mask), (qt, kt, vt)


def _sdpa_backward(q, k, v, g, causal: bool, window: int):
    """SDPA's backward through autograd on B6's operands
    (:func:`_sdpa_operands`): a function that runs it once, or None with
    the reason where SDPA refuses the shapes.  Timed only."""
    import torch
    import torch.nn.functional as F
    try:
        args, kw, leaves = _sdpa_operands(q, k, v, causal, window, grad=True)
        y = F.scaled_dot_product_attention(*args, **kw)
        gt = g.transpose(1, 2)
        run = lambda: torch.autograd.grad(  # noqa: E731
            y, leaves, gt, retain_graph=True)
        run()
        return run, None
    except (RuntimeError, torch.OutOfMemoryError) as e:
        _free_card()
        return None, str(e).splitlines()[0][:200]


def phase_b6_backward() -> dict:
    """B6's backward (``flash_attention_bwd``: ``csrc/attention_bwd.cu``)
    held to autograd through ``flash_attention_plain`` on the card at each
    instance of B6_BWD_CASES: dq, dk and dv within B6_BWD_TOL of each
    one's largest |g|, two runs bitwise equal, then timed: call ms (CUDA
    events), device ms (a replayed CUDA graph), the plain backward's ms,
    its bound (6 D + 4 Dv FLOPs per visible pair at the peak of the
    operands' type, or each input read and each gradient written once), the
    bound of the FLOPs its route issues (``wgmma``: 12 D + 8 Dv at the bf16
    peak, p and ds split in two; ``ffma``: 8 D + 6 Dv at the float32 rate)
    and SDPA's backward through autograd (timed only)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                         PEAK_FLOPS_FP32)
    out = []
    for name, (b, s, h, d), hk, dv, causal, window, t, dtypes in B6_BWD_CASES:
        for dt in dtypes:
            dtype = getattr(torch, dt)
            gen = torch.Generator(device=DEV).manual_seed(s + t + d)
            q, k, v, g = (torch.randn(shape, device=DEV, generator=gen).to(dtype)
                          for shape in ((b, s, h, d), (b, t, hk, d),
                                        (b, t, hk, dv), (b, s, h, dv)))
            kw = dict(causal=causal, window=window)
            o, lse = fa._launch_forward(q, k, v, causal, window, True)
            before = fa.flash_attention.backward_launches
            got = fa.flash_attention_bwd(q, k, v, o, lse, g, **kw)
            again = fa.flash_attention_bwd(q, k, v, o, lse, g, **kw)
            torch.cuda.synchronize()
            where = f"B6 backward {name} {dt}"
            check(fa.flash_attention.backward_launches == before + 2,
                  f"{where}: backward launches not counted")
            check(all(same_bits(x, y) for x, y in zip(got, again)),
                  f"{where}: two runs differ")
            xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
            want = torch.autograd.grad(fa.flash_attention_plain(*xs, **kw),
                                       xs, g)
            abs_errs = [float((x.float() - w.float()).abs().max())
                        for x, w in zip(got, want)]
            errs = [e / float(w.float().abs().max())
                    for e, w in zip(abs_errs, want)]
            check(all(e <= B6_BWD_TOL[dt] for e in errs),
                  f"{where}: dq, dk, dv off autograd through the plain "
                  f"version by {errs} of their largest |g| > "
                  f"{B6_BWD_TOL[dt]}")
            del want, xs, again
            _free_card()
            pairs = _visible_pairs(s, t, causal, window)
            flops = b * h * pairs * (6 * d + 4 * dv)
            esz = q.element_size()
            nbytes = esz * (2 * (q.numel() + k.numel() + v.numel())
                            + 2 * o.numel() + g.numel()) + 4 * lse.numel()
            t_bytes = nbytes / HBM_BW * 1e3
            t_ops = flops / (PEAK_FLOPS_BF16 if dt == "bfloat16"
                             else PEAK_FLOPS_FP32) * 1e3
            route = fa.backward_route(dtype, d, dv)
            issued = b * h * pairs * ((12 * d + 8 * dv) if route == "wgmma"
                                      else (8 * d + 6 * dv))
            run = lambda: fa.flash_attention_bwd(  # noqa: E731
                q, k, v, o, lse, g, **kw)
            rec = dict(instance=name, dtype=dt, shape=[b, s, t, h, hk, d, dv],
                       route=route,
                       causal=causal, window=window, max_rel_err=errs,
                       max_abs_err=max(abs_errs),
                       ms=cuda_ms(run, iters=3, warmup=1),
                       device_ms=graph_ms(run, launches=3, replays=2),
                       plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_plain(
                           q, k, v, o, lse, g, **kw), iters=1, warmup=1),
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       issued_bound_ms=issued / (
                           PEAK_FLOPS_BF16 if route == "wgmma"
                           else PEAK_FLOPS_FP32) * 1e3,
                       flops=flops, issued_flops=issued, bytes=nbytes,
                       visible_pairs_per_head=pairs)
            rec["tflops"] = flops / rec["device_ms"] / 1e9
            lib, refused = _sdpa_backward(q, k, v, g, causal, window)
            rec["library_ms"] = None if lib is None else cuda_ms(
                lib, iters=3, warmup=0)
            if refused:
                rec["library_refused"] = refused
            del lib
            out.append(rec)
            _free_card()
            log(f"[b6 backward] {where} ({rec['route']}): within "
                f"{max(errs):.3g} of autograd "
                f"through plain, bitwise twice; {rec['device_ms']:.3f} ms dev "
                f"({rec['ms']:.3f} call), bound {rec['bound_ms']:.4f} "
                f"({rec['bound_by']}; {rec['issued_bound_ms']:.4f} as "
                f"issued), plain {rec['plain_ms']:.2f}, SDPA "
                f"{rec['library_ms']}")
    return out


def _cut_spans(spans, holes) -> list:
    """Disjoint sorted intervals ``spans`` less the disjoint sorted
    intervals ``holes``."""
    out = []
    for a, b in spans:
        for h0, h1 in holes:
            if h1 <= a or h0 >= b:
                continue
            if h0 > a:
                out.append([a, h0])
            a = max(a, h1)
        if a < b:
            out.append([a, b])
    return out


def _train_idle(reports) -> dict:
    """The card's idle share over the profiled step: 1 - the union of both
    ranks' device activity over the step's wall-clock window (from the
    first rank's start to the last rank's end), both less the windows in
    which either rank held its launches to their plain versions.  Each
    rank's own busy share is its device time (its plain checks left out)
    over that window; the two sum to more than the union where the ranks'
    kernels overlapped on the card."""
    steps = [next(s for s in rep["steps"] if s["profiled"]) for rep in reports]
    t0 = min(s["wall_ns"][0] for s in steps)
    t1 = max(s["wall_ns"][1] for s in steps)
    holes = _merge_spans(tuple(w) for s in steps for w in s["plain_windows_ns"])
    window = _cut_spans([[t0, t1]], holes)
    union = _cut_spans(_merge_spans(tuple(span) for rep in reports
                                    for span in rep["profile"]["busy_ns"]),
                       holes)
    span_ns = sum(b - a for a, b in window)
    busy = sum(min(b, t1) - max(a, t0) for a, b in union if b > t0 and a < t1)
    return {"idle_share": 1.0 - busy / span_ns,
            "profiled_step_ms": span_ns / 1e6,
            "busy_share_by_rank": [rep["profile"]["busy_ms"] * 1e6 / span_ns
                                   for rep in reports],
            "device_launches_by_rank": [rep["profile"]["launches"]
                                        for rep in reports]}


def phase_train(card: str) -> dict:
    """The train path: :func:`train_rank` on TRAIN_RANKS spawned ranks on
    the card, every rank held to the gates; the check steps replayed on
    the CPU (:func:`train_check_rank`, as many ranks) while the card's
    ranks go on with the full-width steps; then B6's backward held to
    autograd through its plain version (:func:`phase_b6_backward`)."""
    import concurrent.futures
    from repro_torch import testing
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            card_ranks = pool.submit(testing.run_ranks, train_rank,
                                     TRAIN_RANKS, f"file://{tmp}/store", tmp,
                                     timeout=900)
            while not Path(f"{tmp}/check_ready").exists():
                if card_ranks.done():
                    card_ranks.result()      # raises the ranks' failure
                    raise RuntimeError("the train ranks ended before the "
                                       "check step was ready")
                time.sleep(0.5)
            t1 = time.perf_counter()
            cpu = testing.run_ranks(train_check_rank, TRAIN_RANKS,
                                    f"file://{tmp}/store_cpu", tmp,
                                    timeout=900)
            cpu_s = time.perf_counter() - t1
            reports = card_ranks.result()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card_s = time.perf_counter() - t0
    cfg = _train_cfgs()["default"]
    # B6 per step and rank: once per attention layer, microbatch and local
    # step, forward twice under remat (the forward and the recompute)
    b6_bwd = cfg.n_layers * min(cfg.microbatch, TRAIN_ROWS) \
        * cfg.fl_local_steps
    b6_fwd = b6_bwd * (2 if cfg.remat else 1)
    launches = {k: 0 for k in (*_counters(), "flash_attention_backward")}
    for rep in reports:
        r = rep["rank"]
        check(rep["leaves"] == TRAIN_LEAVES,
              f"rank {r}: {rep['leaves']} leaves, not {TRAIN_LEAVES}")
        for t, s in enumerate(rep["steps"]):
            where = f"rank {r} step {t} ({s['config']})"
            check(s["finite"] and math.isfinite(s["loss"]),
                  f"{where}: non-finite loss {s['loss']}, mean or params")
            on_path = TRAIN_PATH_KERNELS[s["config"]]
            want = {k: (TRAIN_LEAVES if k in on_path else 0)
                    for k in s["launches"]}
            want["flash_attention"] = b6_fwd
            want["flash_attention_backward"] = b6_bwd
            check(s["launches"] == want, f"{where}: launches rose by "
                  f"{s['launches']}, not {want}")
            check(s["plain_launches"] == {k: want[k] for k in TRAIN_KERNELS}
                  and not s["plain_bad"], f"{where}: launches held to their "
                  f"plain versions {s['plain_launches']}, differing "
                  f"{s['plain_bad']}")
            for k, v in s["launches"].items():
                launches[k] += v
            bad = [i for i, (e, tol) in enumerate(zip(s["conservation_err"],
                                                      s["conservation_tol"]))
                   if not e <= tol]
            check(not bad, f"{where}: leaves {bad}: mean vs averaged u + res "
                  f"- new_res off by {[s['conservation_err'][i] for i in bad]}"
                  f" > {[s['conservation_tol'][i] for i in bad]}")
    for t in range(len(TRAIN_SCHEDULE)):
        steps = [rep["steps"][t] for rep in reports]
        check(all(s["mean_digest"] == steps[0]["mean_digest"]
                  and s["params_digest"] == steps[0]["params_digest"]
                  for s in steps), f"step {t}: the ranks' means or "
              "parameters differ")
        check(all(s["loss"] == steps[0]["loss"] for s in steps),
              f"step {t}: the ranks report different losses")
    checks = {}
    for tag in TRAIN_CHECKS:
        c_cfg, seq = _check_cfg(tag)
        card_loss = reports[0]["checks"][tag]["loss"]
        cpu_loss = sum(c[tag]["loss"] for c in cpu) / len(cpu)
        check(abs(card_loss - cpu_loss) <= TRAIN_CHECK_RTOL * abs(cpu_loss),
              f"check step {tag}: card loss {card_loss} vs CPU {cpu_loss}")
        for r, c in enumerate(cpu):
            check(c[tag]["same"], f"check step {tag} rank {r}: the card's "
                  "aggregate replayed on the CPU differs")
            check(c[tag]["update_rel_err"] <= TRAIN_CHECK_GRAD_TOL,
                  f"check step {tag} rank {r}: an update leaf off by "
                  f"{c[tag]['update_rel_err']} of its largest |u| > "
                  f"{TRAIN_CHECK_GRAD_TOL}")
        # B6 per attention layer and microbatch above DENSE_MAX_SEQ (E = 1)
        n_b6 = (c_cfg.n_layers * min(c_cfg.microbatch, TRAIN_CHECK_ROWS)
                if seq > 2048 else 0)
        for rep in reports:
            got = rep["checks"][tag]
            held = got["plain_launches"]
            check(held == {k: (TRAIN_LEAVES if k == "gather_quant" else 0)
                           for k in TRAIN_KERNELS} and not got["plain_bad"],
                  f"check step {tag} rank {rep['rank']}: launches held to "
                  f"their plain versions {held}, differing {got['plain_bad']}")
            check(got["b6_launches"] == [2 * n_b6, n_b6],
                  f"check step {tag} rank {rep['rank']}: B6 forward and "
                  f"backward launched {got['b6_launches']}, not "
                  f"{[2 * n_b6, n_b6]}")
        checks[tag] = {
            "seq": seq, "card_loss": card_loss, "cpu_loss": cpu_loss,
            "update_rel_err": max(c[tag]["update_rel_err"] for c in cpu),
            "cpu_local_s": max(c[tag]["local_s"] for c in cpu),
            "cpu_replay_s": max(c[tag]["replay_s"] for c in cpu),
            "replayed_coordinates": cpu[0][tag]["replayed"],
            "skipped_leaves": cpu[0][tag]["skipped"],
            "b6_launches_per_rank": reports[0]["checks"][tag]["b6_launches"],
            "aggregate_bitwise": True}
    b6 = phase_b6_backward()

    def slowest(key, steps):
        return sorted(max(rep["steps"][t][key] for rep in reports)
                      for t in steps)[len(steps) // 2]

    default = [t for t, n in enumerate(TRAIN_SCHEDULE) if n == "default"]
    step_ms = slowest("step_ms", default)
    tokens = TRAIN_ROWS * TRAIN_SEQ
    e = cfg.fl_local_steps
    # the dry-run's model FLOPs (6 x active parameters per trained token)
    # for the tokens this step trains on the card: every rank's E passes
    flops = DRYRUN["train_4k"]["model_flops"] / DRYRUN["train_4k"]["tokens"] \
        * TRAIN_RANKS * e * tokens
    by_shape = {}
    for rep in reports:
        for name, shapes in rep["launches_by_shape"].items():
            for k, v in shapes.items():
                by_shape.setdefault(name, {})
                by_shape[name][k] = by_shape[name].get(k, 0) + v
    for name, shapes in by_shape.items():
        check(sum(shapes.values()) == launches[name],
              f"{name}: {launches[name]} launches, by shape {shapes}")
    out = {"ranks": TRAIN_RANKS, "rows": TRAIN_ROWS, "seq": TRAIN_SEQ,
           "local_steps": e, "leaves": TRAIN_LEAVES, "launches": launches,
           "launches_by_shape": by_shape,
           "step_ms": step_ms,
           "local_ms": slowest("local_ms", default),
           "aggregate_ms": slowest("aggregate_ms", default),
           "step_ms_by_config": {n: max(rep["steps"][t]["step_ms"]
                                        for rep in reports)
                                 for t, n in enumerate(TRAIN_SCHEDULE)
                                 if n != "default"},
           "step_ms_all": [max(rep["steps"][t]["step_ms"] for rep in reports)
                           for t in range(len(TRAIN_SCHEDULE))],
           "aggregate_ms_all": [max(rep["steps"][t]["aggregate_ms"]
                                    for rep in reports)
                                for t in range(len(TRAIN_SCHEDULE))],
           "gates_ms_all": [max(rep["steps"][t]["gates_ms"]
                                for rep in reports)
                            for t in range(len(TRAIN_SCHEDULE))],
           **_train_idle(reports),
           "profile_top_by_rank": [rep["profile"]["top"] for rep in reports],
           # B6's backward kernels in the profiled step (ms, launches)
           "profile_b6_backward_by_rank": [rep["profile"]["b6_backward"]
                                           for rep in reports],
           "profile_s": max(rep["profile_s"] for rep in reports),
           "check_s": max(rep["check_s"] for rep in reports),
           "b6_launches_per_rank_step": {"forward": b6_fwd,
                                         "backward": b6_bwd},
           "model_flops": flops,
           "bf16_peak_share": flops / (step_ms / 1e3) / PEAK_FLOPS_BF16,
           "client_tokens_per_s": tokens / step_ms * 1e3,
           "client_trained_tokens_per_s": e * tokens / step_ms * 1e3,
           "peak_gib_per_rank": max(rep["peak_gib"] for rep in reports),
           "losses": [rep0["loss"] for rep0 in reports[0]["steps"]],
           "conservation_err_max": max(
               e for rep in reports for s in rep["steps"]
               for e in s["conservation_err"]),
           "conservation_steps": [t for t, s in enumerate(reports[0]["steps"])
                                  if s["conservation_err"]],
           "plain_launches": sum(v for rep in reports for s in rep["steps"]
                                 for v in s["plain_launches"].values()),
           "plain_check_ms_all": [max(rep["steps"][t]["plain_check_ms"]
                                      for rep in reports)
                                  for t in range(len(TRAIN_SCHEDULE))],
           "init_s": max(rep["init_s"] for rep in reports),
           "checks": checks, "b6_backward": b6, "card_s": card_s,
           "cpu_s": cpu_s, "card": card}
    log(f"[train] {card}: {QWEN} full width, {TRAIN_RANKS} clients x "
        f"{TRAIN_ROWS} x {TRAIN_SEQ} tokens, E={e}, granularity tensor, "
        f"kernels on: every gate held; step {step_ms:.1f} ms (local "
        f"{out['local_ms']:.1f}, aggregation {out['aggregate_ms']:.1f}), "
        f"{out['client_tokens_per_s']:.0f} client tokens/s, peak "
        f"{out['peak_gib_per_rank']:.2f} GiB per rank, idle share "
        f"{out['idle_share']:.3f}, {out['bf16_peak_share']:.4f} of the bf16 "
        f"peak ({flops:.4g} model FLOPs); losses "
        f"{out['losses']}; launches {launches} (B6 {b6_fwd} forward, "
        f"{b6_bwd} backward per rank and step), the FediAC ones each "
        f"bitwise its plain version ({out['plain_launches']} held, the "
        f"check steps' too); conservation on steps "
        f"{out['conservation_steps']}; check steps card == CPU "
        + "; ".join(f"{t}: loss {c['card_loss']} vs {c['cpu_loss']}, leaves "
                    f"within {c['update_rel_err']:.3g}"
                    for t, c in checks.items())
        + f" ({card_s:.1f} s, the CPU replay {cpu_s:.1f} s of it)")
    return out


def time_b6(q, k, v, kw, ops_per_s: float, launches: int, *, iters: int = 3,
            graph: dict | None = None, plain_ms: float | None = None) -> dict:
    """B6 at one layer's operands, any mask: call ms (CUDA events over
    ``iters`` calls) and device ms (a replayed CUDA graph), its plain
    version's ms (measured here unless the caller measured it), its bound
    (operations at ``ops_per_s``, the peak for the operands' type, from
    this call's visible (q, k) pairs, causal and window counted; or
    bytes), its achieved TFLOP/s on the reference FLOPs, and SDPA's ms
    where one call computes the same function (a boolean mask for a
    window, with the KV heads repeated there, as the masked kernel takes
    no grouped heads; null, with the reason, where SDPA refuses the
    shapes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, s, h, d = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    causal, window = kw.get("causal", True), kw.get("window", 0)
    pairs = _visible_pairs(s, t, causal, window)
    # 2 D + 2 Dv FLOPs per visible pair
    fl = b * h * pairs * 2 * (d + dv)
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v)) \
        + b * s * h * dv * q.element_size()
    from repro_torch.launch.mesh import HBM_BW
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = fl / ops_per_s * 1e3
    run = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    if plain_ms is None:
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                           iters=1, warmup=1)
    out = dict(launches=launches, dtype=str(q.dtype).removeprefix("torch."),
               ms=cuda_ms(run, iters=iters, warmup=1),
               device_ms=graph_ms(run, **(graph or dict(launches=3, replays=2))),
               plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=fl, bytes=nbytes, visible_pairs_per_head=pairs,
               causal=causal, window=window, shape=[b, s, t, h, hk, d, dv])
    out["tflops"] = fl / out["device_ms"] / 1e9
    try:
        args, sdpa_kw, _ = _sdpa_operands(q, k, v, causal, window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            *args, **sdpa_kw)
        out["library_ms"] = cuda_ms(lib, iters=iters, warmup=1)
    except (RuntimeError, torch.OutOfMemoryError) as e:
        out["library_ms"] = None
        out["library_refused"] = str(e).splitlines()[0][:200]
        _free_card()
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
    global SIDE
    t_start = time.perf_counter()
    SIDE = _CpuSide()
    SIDE.submit("dryrun", _dryrun_gate, _dryrun_records, DRYRUN_SHAPES)
    try:
        return run(t_start)
    finally:
        SIDE.close()


def run(t_start: float) -> int:
    """Every phase, in order, then the records and the result line."""
    import torch
    from repro_torch.core import prng
    card = phase_card()
    build = phase_build()
    parity_err = phase_parity()
    parity_err.update(phase_wire_parity())
    gen = torch.Generator(device=DEV).manual_seed(0)
    scale = torch.empty(D, device=DEV).exponential_(generator=gen)
    u_stack = torch.randn(N_CLIENTS, D, device=DEV, generator=gen) * scale
    key = prng.PRNGKey(0, device=DEV)
    phase_s = {"to_main_path": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return res

    main_path = timed("main_path", phase_main_path, u_stack, key)
    report = timed("checks", phase_checks, u_stack, key, main_path)
    compare = timed("compare", phase_compare, u_stack, key)
    stream = timed("stream", phase_stream, u_stack, key)
    # B6's build, compiled beside the phases so far, and its parity
    phase_build_attention(build)
    hgmma = hgmma_count()
    hgmma_bwd = hgmma_count("attention_bwd")
    simt_res = simt_resources()
    bwd_res = bwd_resources()
    flash_err = timed("flash_parity", phase_flash_parity)
    shard = timed("shard", phase_shard, card)
    packet = timed("packet", phase_packet, card)
    faults = timed("faults", phase_faults, card)
    asyn = timed("async", phase_async, card)
    sweep = timed("sweep", phase_sweep, card)
    allreduce = timed("allreduce", phase_allreduce, card)
    nccl = timed("nccl", phase_nccl, card)
    # the CPU side's references of the phases so far, and their gates
    timed("cpu_side", SIDE.settle)
    _free_card()
    train = timed("train", phase_train, card)
    timing = timed("timing", phase_timing, u_stack, key)
    timing.update(timed("wire_timing", phase_wire_timing))
    serve = timed("serve", phase_serve)
    zoo = timed("zoo", phase_zoo)

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
        # FL loop, the comparison path and the stream path (counted in
        # this process), plus the allreduce (summed over its ranks);
        # unpack is on no path (no round calls it)
        on_stream = stream["launches"] if name == "gather_quant" else 0
        on_packet = packet["launches"].get(name, 0)
        on_faults = faults["launches"].get(name, 0)
        on_async = asyn["launches"].get(name, 0)
        on_sweep = sweep["launches"].get(name, 0)
        on_train = train["launches"][name]
        launches = (main_path["launches"].get(name, 0)
                    + compare["launches"][name] + on_stream + on_packet
                    + on_faults + on_async + on_sweep
                    + allreduce["launches"][name] + on_train)
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches,
                 "on_path": name != "unpack",
                 "max_abs_err": parity_err[name], "bitwise": True,
                 **{k: t[k] for k in ("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by")},
                 "library_ms": None, "shape": t["shape"]}
        if name == "gather_quant":
            # the stacked rounds (the sum close, then the trim and median
            # closes) launch it at [N_CLIENTS, D]; the FL loops, the
            # allreduce's topk config and the stream engine's chunks at
            # shapes of their own
            at_shape = (main_path["round_launches"]
                        + compare["robust_round_launches"])
            fl = (launches - at_shape - allreduce["launches"][name]
                  - on_stream - on_packet - on_faults - on_async - on_sweep
                  - on_train)
            cell = stream["b1_chunk"]
            entry["launches_at_shape"] = at_shape
            entry["also_at"] = [
                {"launches": n_at, **{k: timing[key][k] for k in (
                    "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by")}}
                for key, n_at in (("gather_quant_allreduce",
                                   allreduce["launches"][name]),
                                  ("gather_quant_fl", fl))]
            # the stream engine's chunk at the scale cell (its launches at
            # that shape, tallied per shape; the stream path's other chunk
            # shapes are listed with theirs), and on the strided chunk as
            # the engine hands it over, with and without out=; B1 on the
            # strided views was held bitwise against its plain version at
            # every stream shape and at misaligned, one-row and in-place
            # views
            entry["also_at"].append({
                "launches": stream["launches_by_shape"][str(cell["shape"])],
                **{k: cell[k] for k in (
                    "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by", "strided_call_ms", "strided_device_ms",
                    "strided_out_call_ms", "strided_out_device_ms")}})
            entry["stream_launches_by_shape"] = stream["launches_by_shape"]
            entry["bitwise_on_strided_chunks"] = stream["b1_strided_bitwise"]
        if name in packet["launches"]:
            # the packet path's launches (its rounds at [N_CLIENTS, D], the
            # stream engine's chunks under it, its FL loops), by shape
            entry["packet_launches"] = on_packet
            entry["packet_launches_by_shape"] = packet[
                "launches_by_shape"].get(name, {})
        if name in faults["launches"]:
            # the chaos and robust paths' launches (their rounds at
            # [N_CLIENTS, D] and the check width, the stream engine's chunks
            # under the storm, the grids' FL loops), by shape
            entry["faults_launches"] = on_faults
            entry["faults_launches_by_shape"] = faults[
                "launches_by_shape"].get(name, {})
        if name in asyn["launches"]:
            # the async path's launches (its rounds at [N_CLIENTS, D] and
            # the check width, the stream engine's chunks under it, the
            # throughput cells' and the resume cell's FL loops), by shape
            entry["async_launches"] = on_async
            entry["async_launches_by_shape"] = asyn[
                "launches_by_shape"].get(name, {})
        if on_train:
            # the train path's launches (Qwen3-0.6B's train step, one per
            # leaf of its aggregation on each rank), by shape, and the
            # times at its largest leaves
            entry["train_launches"] = on_train
            by_shape = train["launches_by_shape"].get(name, {})
            entry["train_launches_by_shape"] = by_shape
            entry.setdefault("also_at", []).extend(
                {"launches": by_shape.get(str(t_at["shape"]), 0),
                 **{k: t_at[k] for k in ("shape", "ms", "device_ms",
                                         "plain_ms", "bound_ms", "bound_by")}}
                for t_at in timing.get(f"train_{name}", []))
        if name in sweep["launches"]:
            # the sweep path's launches (the smoke, chaos and fig2 grids'
            # fleets and sequential runs, the card-vs-CPU cell), by shape
            entry["sweep_launches"] = on_sweep
            entry["sweep_launches_by_shape"] = sweep[
                "launches_by_shape"].get(name, {})
        kernels.append(entry)
    b6 = serve["b6"]
    instance_keys = ("launches", "ms", "device_ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms", "tflops", "shape")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        # the main path is the bf16 instance: the 32k prefills' launches,
        # one per attention layer (Qwen3-0.6B's, then the zoo's), the train
        # path's (twice per layer, microbatch and local step: the forward
        # and its recompute; with the row statistic), and its times at
        # Qwen3-0.6B's layer 0
        "launches": (serve["launches"] + zoo["launches"]
                     + train["launches"]["flash_attention"]),
        "train_launches": train["launches"]["flash_attention"],
        "writes_row_statistic_under_autograd": True, "on_path": True,
        "max_abs_err": serve["layer_err_vs_plain"], "bitwise": False,
        "tolerance": {"abs": LAYER_TOL[0], "rel": LAYER_TOL[1]},
        "max_abs_err_small_shapes": flash_err,
        "tolerance_small_shapes": FLASH_TOL,
        "hgmma_in_sass": hgmma,
        "float32_resources": simt_res,
        **{k: b6["bfloat16"][k] for k in instance_keys if k != "launches"},
        "instances": [
            {"instance": "bfloat16, wgmma + TMA (tensor cores)",
             "on": "the 32k prefill", **{k: b6["bfloat16"][k]
                                         for k in instance_keys}},
            {"instance": "float32, FFMA (SIMT) over a TMA ring",
             "on": "the check prefill",
             "max_abs_err": serve["check_layer_err_vs_plain"],
             **{k: b6["float32"][k] for k in instance_keys}}],
        # the zoo's prefills: launches and times at each model's layer 0
        # (held to plain within LAYER_TOL there), and the check prefills'
        # launches by shape (held to plain within FLASH_TOL)
        "zoo_at": [
            {"model": arch, "launches": z["launches"],
             "max_abs_err": z["layer_err_vs_plain"],
             **{k: z["b6"][k] for k in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms",
                                        "tflops", "shape", "causal", "window",
                                        "dtype")}}
            for arch, z in zoo["prefill"].items() if "b6" in z],
        "zoo_check_launches": {
            f"{arch} {dt}": [c[dt]["b6_launches"], c[dt]["b6_shapes"]]
            for arch, c in zoo["check"].items()
            for dt in ("float32", "bfloat16") if c[dt]["b6_launches"]}})
    # B6's backward: the train path's launches (each one wrapper call:
    # flash_bwd_dot, then dk/dv's kernel and dq's), its headline numbers
    # at Qwen3-0.6B's bf16 train layer, each instance held to autograd
    # through the plain version
    bwd = train["b6_backward"]
    head = bwd[0]
    kernels.append({
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:74",
        "replaces_note": "no TPU kernel: the reference differentiates its "
                         "plain blockwise scan (_blockwise_attention)",
        # bf16 up to (192, 128) on the tensor cores, float32 and (256, 256)
        # on FFMA (flash_attention.backward_route)
        "kernels": ["flash_bwd_dot", "flash_bwd_dkdv_wgmma",
                    "flash_bwd_dq_wgmma", "flash_bwd_dkdv", "flash_bwd_dq"],
        "hgmma_in_sass": hgmma_bwd,
        "launches": train["launches"]["flash_attention_backward"],
        "on_path": True, "max_abs_err": head["max_abs_err"],
        "max_rel_err": max(head["max_rel_err"]),
        "max_rel_err_is": "of each gradient's largest |g|",
        "bitwise": False, "tolerance_rel": B6_BWD_TOL,
        **{k: head[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "tflops", "shape",
                                "dtype")},
        "instances": bwd, "resources": bwd_res,
        "check_step_launches_per_rank": train["checks"]["2304"][
            "b6_launches_per_rank"][1]})
    for z in zoo["prefill"].values():
        z.pop("b6", None)
    serve = {k: v for k, v in serve.items() if k != "b6"}
    timed = ("gather_quant", "gather_quant_allreduce", "gather_quant_fl",
             "stoch_quant", "vote_pack", "pack", "unpack", "popcount_accum",
             "train_gather_quant", "train_vote_pack", "train_popcount_accum")
    from repro_torch.launch.mesh import DEVICE
    summary = {"build": build, "cpu_side_s": SIDE.seconds,
               "bounds_use_figures_of": DEVICE,
               "total_s": time.perf_counter() - t_start,
               "phase_s": phase_s,
               **report, "compare": compare,
               "stream": {k: v for k, v in stream.items() if k != "b1_chunk"},
               "shard": shard, "packet": packet, "faults": faults,
               "async": asyn,
               "sweep": sweep,
               "allreduce": allreduce,
               "nccl": nccl,
               "train": train,
               "serve": serve,
               "zoo": zoo,
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
