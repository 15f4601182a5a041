"""Reputation and quarantine: cross-round suspicion state.

The switch cannot prove a client Byzantine from one round; what it can do
online, with the counters it already keeps, is accumulate per-client
suspicion across rounds and exclude repeat offenders from participant
sampling for a while.  The round's signal (:mod:`.core`) adds three
switch-observable terms: the excess of a client's vote-overlap miss rate
over its cohort's, the excess of its peak |quantized value| over the
committed cohort's (both in standard deviations past ``rep_z_thresh``),
and its votes rejected by the budget, normalized by the cap.

``rep`` decays by ``rep_decay`` per round and grows by the signal;
crossing ``rep_threshold`` quarantines the client for
``quarantine_rounds`` rounds, after which it is re-admitted on probation
at half the threshold.

The state is a flat dict of one float32 ``[N]`` and one int32 ``[N]``
tensor, threaded through ``RoundResult.state``, so the FL loop's npz run
state checkpoints and resumes it bit for bit with no new machinery.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import xla_math

__all__ = ["init_reputation_state", "reputation_update"]


def init_reputation_state(n_clients: int, device=None) -> dict:
    """The clean-slate state on ``device`` (the card unless told
    otherwise): zero suspicion, nobody quarantined."""
    dev = resolve_device(device)
    n = int(n_clients)
    return {"rep": torch.zeros((n,), dtype=torch.float32, device=dev),
            "quarantine": torch.zeros((n,), dtype=torch.int32, device=dev)}


def reputation_update(state: dict, *, part, signal, dyn) -> tuple[dict, dict]:
    """One round of the reputation state machine.

    ``part``: bool[N] — who participated (only they earn suspicion);
    ``signal``: float32[N] — the round's per-client signal; ``dyn``
    supplies ``rep_decay`` / ``rep_threshold`` / ``quarantine_rounds``
    (numbers or 0-d tensors).  Returns ``(new_state, stats)`` with
    ``stats = {"quarantined", "rep_flagged"}`` int32 0-d tensors.  At the
    default ``rep_threshold = +inf`` the trigger never fires and the
    quarantine counters stay zero.
    """
    rep = state["rep"].to(torch.float32)
    quar = state["quarantine"].to(torch.int32)
    dev = rep.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    active = quar <= 0
    # rep * decay + signal is one fused multiply-add in the reference's
    # round (XLA contracts it under jit)
    rep_new = xla_math.fma(rep, f32(dyn["rep_decay"]),
                           torch.where(part, signal, 0.0))
    threshold = f32(dyn["rep_threshold"])
    trigger = (rep_new > threshold) & active
    quar_next = torch.where(
        trigger, torch.as_tensor(dyn["quarantine_rounds"], dtype=torch.int32,
                                 device=dev),
        torch.clamp_min(quar - 1, 0))
    # probation: a released client restarts at half the threshold
    rep_next = torch.where(trigger, threshold * 0.5, rep_new)
    stats = {"quarantined": (quar_next > 0).sum(dtype=torch.int32),
             "rep_flagged": trigger.sum(dtype=torch.int32)}
    return {"rep": rep_next, "quarantine": quar_next}, stats
