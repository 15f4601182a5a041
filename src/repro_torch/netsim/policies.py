"""Round policies of the packet dataplane.

Everything stochastic about a network round is decided here, up front and
deterministically: which clients are sampled into the round, which of them
are stragglers this round, which packets the links drop, and how the
vote-quorum deadline treats late voters.  All draws derive from a threefry
key seeded by ``(NetConfig.seed, round_idx)`` (:func:`net_round_key`), so a
round is a pure function of its config and replays bit for bit; every draw
equals the reference's (:mod:`repro_torch.core.prng`).

The sampling policies are fixed-shape: they return boolean ``[N]`` masks
(never index arrays), with the sampled-count arithmetic done on device
scalars, so ``participation`` and ``straggler_frac`` may be tensors.

Phase 1 closes at a deadline and simply does not count late or lost vote
packets (the vote threshold ``a`` tolerates missing voters); phase 2 is
reliable (persistent retransmission), since losing quantized value packets
would bias the aggregate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng, xla_math
from repro_torch.switch.packets import MTU
from repro_torch.validate import (check_at_least, check_finite_at_least,
                                  check_interval, check_positive_finite,
                                  require)

__all__ = ["NetConfig", "BackoffPolicy", "net_round_key",
           "sample_participants", "sample_stragglers", "INT32_MAX",
           "INT32_MIN", "register_accumulate", "REGISTER_POLICIES"]

INT32_MAX = np.int32(2**31 - 1)
INT32_MIN = np.int32(-2**31)

#: Register-bank overflow policies: how the switch closes an int32
#: aggregation window whose true sum exceeds the register width.
REGISTER_POLICIES = ("wrap", "saturate", "rescale")


@dataclass(frozen=True)
class NetConfig:
    """Knobs of the packet-level network simulation (one FL deployment).

    ``__post_init__`` validates every timing/retry knob up front: the
    quorum deadline and the ARQ timeout must be positive finite seconds,
    ``max_retries`` must allow at least the first transmission attempt,
    and ``straggler_slowdown`` must be a finite factor >= 1.
    """

    loss: float = 0.0              # i.i.d. per-packet loss probability
    participation: float = 1.0     # fraction of clients sampled per round
    straggler_frac: float = 0.0    # fraction of sampled clients straggling
    straggler_slowdown: float = 4.0  # multiplies train time, divides rate
    vote_deadline_s: float | None = None  # phase-1 quorum deadline (s from
                                   # round start); None = wait for everyone
    drop_late_voters: bool = True  # a client with zero vote packets in by
                                   # the deadline sits phase 2 out entirely
    rto_s: float = 0.05            # retransmission timeout (phase 2 ARQ)
    max_retries: int = 16          # bound on ARQ attempts counted for time
    memory_slots: int = 262_144    # int32 registers in each switch
    n_leaves: int = 1              # leaf switches (1 = single-PS, no root)
    mtu: int = MTU
    seed: int = 0

    def __post_init__(self):
        check_interval("loss", self.loss, 0.0, 1.0, hi_open=True)
        check_interval("participation", self.participation, 0.0, 1.0,
                       lo_open=True)
        check_interval("straggler_frac", self.straggler_frac, 0.0, 1.0)
        check_finite_at_least("straggler_slowdown", self.straggler_slowdown,
                              1.0)
        if self.vote_deadline_s is not None:
            check_positive_finite("vote_deadline_s", self.vote_deadline_s)
        check_positive_finite("rto_s", self.rto_s)
        require(self.max_retries >= 1, "max_retries",
                ">= 1 (the first attempt counts)", self.max_retries)
        check_at_least("n_leaves", self.n_leaves, 1)
        check_at_least("memory_slots", self.memory_slots, 1)
        check_at_least("mtu", self.mtu, 1)

    def arq_policy(self) -> "BackoffPolicy":
        """The phase-2 ARQ retry clock as a :class:`BackoffPolicy`:
        constant ``rto_s`` spacing (factor 1), ``max_retries`` bounded."""
        return BackoffPolicy(base_s=self.rto_s, factor=1.0,
                             max_retries=self.max_retries)


def _f32(x, device) -> torch.Tensor:
    """``x`` (a number or a tensor) as a float32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclass(frozen=True)
class BackoffPolicy:
    """One validated timeout/retry/backoff policy.

    Serves the phase-2 ARQ retransmission timeout (constant spacing,
    ``factor == 1``) and a bounded exponential quorum-retry backoff
    (``factor == 2``): delays ``base_s * factor**i`` clipped at ``cap_s``,
    with optional deterministic threefry jitter (:meth:`jittered`).
    ``factor == 1`` produces ``k * float32(base)``, bitwise the ARQ
    expression.  ``base_s`` may be overridden per call with a tensor.
    """

    base_s: float                 # first-retry delay (seconds)
    factor: float = 2.0           # geometric growth per attempt (1 = ARQ)
    cap_s: float = math.inf       # per-delay ceiling (inf = unbounded)
    max_retries: int = 16         # bound on retries the clock accounts for
    jitter_frac: float = 0.0      # +- relative jitter applied by jittered()

    def __post_init__(self):
        check_finite_at_least("base_s", self.base_s, 0.0)
        check_finite_at_least("factor", self.factor, 1.0)
        require(self.cap_s > 0.0, "cap_s", "> 0 (inf allowed)", self.cap_s)
        check_at_least("max_retries", self.max_retries, 0)
        check_interval("jitter_frac", self.jitter_frac, 0.0, 1.0,
                       hi_open=True)

    def _cap(self, d: torch.Tensor) -> torch.Tensor:
        if math.isfinite(self.cap_s):
            return torch.minimum(d, _f32(self.cap_s, d.device))
        return d

    def delays(self, n_attempts: int, base=None, device=None) -> torch.Tensor:
        """f32[n_attempts] — the delay preceding re-attempt ``i``:
        ``min(base * factor**i, cap_s)``, on ``base``'s device when it is a
        tensor, else on ``device`` (the card unless told otherwise)."""
        b = self.base_s if base is None else base
        dev = (b.device if isinstance(b, torch.Tensor)
               else resolve_device(device))
        idx = torch.arange(int(n_attempts), dtype=torch.int32, device=dev)
        return self._cap(_f32(b, dev) * (_f32(self.factor, dev)
                                         ** idx.to(torch.float32)))

    def total_delay(self, k, base=None) -> torch.Tensor:
        """Summed delay after ``k`` retries (an int tensor, clipped to
        ``max_retries``).  For ``factor == 1`` this is exactly
        ``k * float32(base)``, bitwise the ARQ expression."""
        b = self.base_s if base is None else base
        k = torch.as_tensor(k)
        if self.factor == 1.0:
            return k.to(torch.float32) * self._cap(_f32(b, k.device))
        cum = torch.cat([
            torch.zeros((1,), dtype=torch.float32, device=k.device),
            xla_math.cumsum(self.delays(self.max_retries + 1, base,
                                        device=k.device), 0)])
        return cum[torch.clamp(k, 0, self.max_retries + 1).long()]

    def jittered(self, delays, key: torch.Tensor) -> torch.Tensor:
        """Deterministic threefry jitter: each delay scaled by a uniform
        factor in ``[1 - jitter_frac, 1 + jitter_frac)``.  A zero
        ``jitter_frac`` returns the delays untouched."""
        d = _f32(delays, key.device)
        if self.jitter_frac == 0.0:
            return d
        u = prng.uniform(key, tuple(d.shape))
        return d * (1.0 + float(np.float32(self.jitter_frac)) * (2.0 * u - 1.0))


def net_round_key(seed, round_idx, device=None) -> torch.Tensor:
    """The one key of a round's network randomness — derived from
    (config seed, round index), on ``device`` (the card unless told
    otherwise)."""
    return prng.fold_in(prng.PRNGKey(seed, device=device), int(round_idx))


def _ranks(u: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of u[i] in ascending sort order (stable)."""
    order = torch.argsort(u, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.shape[0], device=u.device)
    return ranks.to(torch.int32)


def sample_participants(key: torch.Tensor, n_clients: int,
                        participation) -> torch.Tensor:
    """bool[n_clients] — exactly max(1, round(p*N)) clients, sampled
    uniformly without replacement (a uniform random ranking truncated at
    the sampled count).  ``participation`` may be a tensor."""
    p = _f32(participation, key.device)
    n_p = torch.clamp_min(torch.round(p * n_clients).to(torch.int32), 1)
    return _ranks(prng.uniform(key, (n_clients,))) < n_p


def sample_stragglers(key: torch.Tensor, participants: torch.Tensor,
                      frac) -> torch.Tensor:
    """bool mask (same shape) — a ``frac`` subset of participants straggle.

    Non-participants are pushed past every participant in the random
    ranking, so exactly round(frac * n_participants) participants are
    marked; ``frac`` may be a tensor."""
    n_part = participants.to(torch.int32).sum(dtype=torch.int32)
    n_s = torch.round(_f32(frac, key.device) * n_part).to(torch.int32)
    u = torch.where(participants,
                    prng.uniform(key, tuple(participants.shape)), 2.0)
    return participants & (_ranks(u) < n_s)


# ---------------------------------------------------------------------------
# Register-bank overflow policies
# ---------------------------------------------------------------------------
#
# The switch registers are int32; a window whose true sum exceeds 2^31 - 1
# wraps silently in hardware.  The bank is walked client by client and each
# int32 add runs the two's-complement sign test (same-sign operands whose
# sum flips sign overflowed).  int32 addition is associative modulo 2^32,
# so the walk's wrap-mode value is bitwise the plain int32 column sum.

def _overflow_scan(rows: torch.Tensor, *, clamp: bool):
    """Accumulate int32 ``rows [N, C]`` slot-wise with overflow detection.

    Returns ``(acc int32[C], overflow bool[C])`` where ``overflow`` is the
    sticky per-slot flag.  ``clamp=True`` saturates each add at the int32
    rails (the "saturate" register policy); ``clamp=False`` wraps (exact
    mod-2^32 value, bitwise the int32 sum).
    """
    rows = rows.to(torch.int32)
    acc = torch.zeros(rows.shape[1:], dtype=torch.int32, device=rows.device)
    ovf = torch.zeros(rows.shape[1:], dtype=torch.bool, device=rows.device)
    for row in rows:
        s = acc + row
        pos = (acc > 0) & (row > 0) & (s < 0)
        neg = (acc < 0) & (row < 0) & (s >= 0)
        if clamp:
            s = torch.where(pos, torch.full_like(s, INT32_MAX), s)
            s = torch.where(neg, torch.full_like(s, INT32_MIN), s)
        acc, ovf = s, ovf | pos | neg
    return acc, ovf


def _rescale_shift_bound(n_rows: int) -> int:
    """Smallest s with n_rows * 2^31 / 2^s <= 2^30 — a shift at which any
    n_rows int32 addends fit with a factor-2 margin (so the shift-back
    cannot overflow either)."""
    return max(1, math.ceil(math.log2(max(n_rows, 2))) + 1)


def register_accumulate(rows: torch.Tensor, *, policy: str = "wrap",
                        slot_window=None, n_windows: int = 1):
    """Close one register-bank aggregation over ``rows`` int32[N, C].

    Returns ``(summed int32[C], overflow bool[C], shift int32[C])``.
    ``overflow`` always reports which slots would have wrapped under plain
    int32 accumulation (sticky, per slot); what lands in ``summed`` — a
    mantissa at scale ``2^shift`` (``shift`` is all-zero except under
    rescale) — depends on the policy:

    * ``"wrap"``      — hardware default: exact value mod 2^32, overflow
      silently wrapped but flagged.
    * ``"saturate"``  — every add clamps at the int32 rails.
    * ``"rescale"``   — per-window degradation: if any slot of a register
      window overflowed, the whole window is re-accumulated from inputs
      pre-shifted right by the smallest power of two that fits, and the
      window's exponent is returned in ``shift``.  Windows with no
      overflow keep the exact sum at ``shift == 0``.

    ``slot_window`` (int[C], host) maps slots to register windows for the
    rescale policy; ``None`` treats the bank as one window.
    """
    if policy not in REGISTER_POLICIES:
        raise ValueError(
            f"register policy must be one of {REGISTER_POLICIES}, got "
            f"{policy!r}")
    rows = torch.as_tensor(rows).to(torch.int32)
    if policy == "saturate":
        acc, ovf = _overflow_scan(rows, clamp=True)
        return acc, ovf, torch.zeros_like(acc)
    summed, ovf = _overflow_scan(rows, clamp=False)
    if policy == "wrap":
        return summed, ovf, torch.zeros_like(summed)
    # rescale: candidate shifts 0..s_max; per slot the smallest shift whose
    # accumulation stays in range, widened to the per-window max so every
    # slot of a window degrades together (one exponent per window).
    s_max = _rescale_shift_bound(rows.shape[0])
    sums = [summed]
    flags = [ovf]
    for s in range(1, s_max + 1):
        acc_s, ovf_s = _overflow_scan(rows >> s, clamp=False)
        sums.append(acc_s)
        flags.append(ovf_s)
    sums = torch.stack(sums)          # [S+1, C]
    flags = torch.stack(flags)        # [S+1, C] (all-False at s = s_max)
    # the first fitting shift (argmax returns the first maximal index)
    fit = torch.argmax((~flags).to(torch.int32), dim=0).to(torch.int32)
    if slot_window is None:
        shift = fit.max().expand(fit.shape)
    else:
        win = torch.as_tensor(np.asarray(slot_window),
                              device=rows.device).long()
        per_win = torch.full((int(n_windows),), INT32_MIN, dtype=torch.int32,
                             device=rows.device)
        per_win = per_win.scatter_reduce(0, win, fit, "amax")
        shift = per_win[win]
    picked = torch.gather(sums, 0, shift[None, :].long())[0]
    return picked, ovf, shift
