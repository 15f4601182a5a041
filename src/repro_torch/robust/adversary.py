"""Adversary model and defense knobs for the packet round.

:class:`AdversaryConfig` extends the chaos dataplane's
:class:`~repro_torch.netsim.faults.FaultConfig` — Byzantine cells compose
with crash and omission faults — with the attack rates and the
switch-side defense knobs.  Every scalar knob reaches the core as a 0-d
tensor of ``dyn`` (:data:`ADVERSARY_DYN_FIELDS`); only
``FediACConfig.robust_agg`` (the slot-close mode) shapes the round.

All adversary draws use fold constants disjoint from the plain core's
6-way split and from the fault keys (7001–7300), so switching an attack
on never perturbs the benign or the fault draws.  Byzantine membership
folds off the *run* key (a persistent property of a client: a per-round
cohort would launder poisoned error-feedback residuals through
ex-Byzantine "honest" clients); the stuffing masks and the colluders'
target set fold off the round key.

Membership and collusion share one uniform per client:
``byz_i = u_i < byzantine_frac`` and ``coll_i = u_i < collusion_frac``
with ``collusion_frac <= byzantine_frac``, so the colluding cohort is a
subset of the Byzantine set by construction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.netsim.faults import (FAULT_DYN_FIELDS, FaultConfig,
                                       chaos_packet_dyn)
from repro_torch.validate import (check_at_least, check_finite_at_least,
                                  check_interval, require)

__all__ = ["AdversaryConfig", "ADVERSARY_DYN_FIELDS", "ROBUST_STAT_FIELDS",
           "adversary_packet_dyn", "KEY_BYZ", "KEY_STUFF", "KEY_TARGET"]

#: the robust-only aux scalars the core returns on top of the chaos ones
#: (``PacketTransport`` folds exactly these into its stats dict)
ROBUST_STAT_FIELDS = ("byzantine", "stuffed_votes", "budget_rejected",
                      "clipped_values", "trimmed_values", "quarantined",
                      "rep_flagged")

#: the adversary and defense knobs of one scenario, appended to
#: FAULT_DYN_FIELDS; ``trim_frac`` is read off the FediACConfig
ADVERSARY_DYN_FIELDS = FAULT_DYN_FIELDS + (
    "byzantine_frac", "collusion_frac", "vote_stuff_frac", "poison_scale",
    "vote_budget", "clip_ticks", "trim_frac", "rep_decay", "rep_threshold",
    "rep_z_thresh", "quarantine_rounds")

#: integer knobs (int32 in ``dyn``); the rest are float32
_INT_FIELDS = ("vote_budget", "clip_ticks", "quarantine_rounds")

# fold_in constants of the adversary keys.  KEY_BYZ folds off the run key
# (persistent membership); KEY_STUFF / KEY_TARGET off the round key.
KEY_BYZ = 8001        # who is Byzantine / colludes (one uniform per client)
KEY_STUFF = 8002      # per-client independent vote-stuffing chunk masks
KEY_TARGET = 8003     # the colluding cohort's shared target chunk set


@dataclass(frozen=True)
class AdversaryConfig(FaultConfig):
    """A :class:`FaultConfig` plus Byzantine attack injection and the
    switch-side defenses that answer it.

    All attack rates default to zero and all defenses to off, at which
    point the robust core is bitwise the chaos core.
    """

    # --- attack: who is Byzantine (byzantine_frac) and which of them
    # collude (collusion_frac <= byzantine_frac)
    byzantine_frac: float = 0.0
    collusion_frac: float = 0.0

    # --- attack: phase-1 vote stuffing.  A Byzantine client votes for an
    # extra vote_stuff_frac of the chunk space beyond its honest top-k —
    # independent chunks per stuffer, except colluders, which all stuff
    # the same per-round target set.
    vote_stuff_frac: float = 0.0

    # --- attack: phase-2 value poisoning.  A Byzantine client transmits
    # ``poison_scale * u``: -1 is the sign flip, large |scale| the scaled
    # update (which also inflates the shared scale f through max |u|).
    poison_scale: float = 1.0

    # --- defense: per-client vote budget (an int counter per client at
    # the switch; votes past the cap never reach the GIA counts).  0
    # disables.
    vote_budget: int = 0

    # --- defense: per-slot magnitude clipping in quantized int space,
    # +-clip_ticks.  0 disables.
    clip_ticks: int = 0

    # --- reputation/quarantine (reputation.py).  The +inf default
    # threshold disables quarantine (suspicion still accumulates).
    rep_decay: float = 0.9
    rep_threshold: float = math.inf
    rep_z_thresh: float = 3.0
    quarantine_rounds: int = 0

    def __post_init__(self):
        super().__post_init__()
        check_interval("byzantine_frac", self.byzantine_frac, 0.0, 1.0,
                       hi_open=True)
        check_interval("collusion_frac", self.collusion_frac, 0.0, 1.0,
                       hi_open=True)
        require(self.collusion_frac <= self.byzantine_frac,
                "collusion_frac", "<= byzantine_frac (the colluding cohort "
                "is a subset of the Byzantine set)", self.collusion_frac)
        check_interval("vote_stuff_frac", self.vote_stuff_frac, 0.0, 1.0)
        require(math.isfinite(self.poison_scale), "poison_scale", "finite",
                self.poison_scale)
        check_at_least("vote_budget", self.vote_budget, 0)
        check_at_least("clip_ticks", self.clip_ticks, 0)
        check_interval("rep_decay", self.rep_decay, 0.0, 1.0)
        require(self.rep_threshold > 0.0, "rep_threshold",
                "> 0 (+inf disables quarantine)", self.rep_threshold)
        check_finite_at_least("rep_z_thresh", self.rep_z_thresh, 0.0)
        check_at_least("quarantine_rounds", self.quarantine_rounds, 0)


def adversary_packet_dyn(cfg, net: AdversaryConfig, n_clients: int,
                         local_train_s: float, svc: float,
                         device=None) -> dict:
    """The ``dyn`` dict of one robust scenario: the chaos
    :func:`~repro_torch.netsim.faults.chaos_packet_dyn` scalars plus the
    adversary and defense knobs, on ``device`` (the card unless told
    otherwise).  ``trim_frac`` comes off ``cfg``."""
    dev = resolve_device(device)
    dyn = chaos_packet_dyn(cfg, net, n_clients, local_train_s, svc,
                           device=dev)
    for name in ADVERSARY_DYN_FIELDS[len(FAULT_DYN_FIELDS):]:
        value = (getattr(cfg, "trim_frac", 0.0) if name == "trim_frac"
                 else getattr(net, name))
        dtype = torch.int32 if name in _INT_FIELDS else torch.float32
        dyn[name] = torch.tensor(value, dtype=dtype, device=dev)
    return dyn
