"""Byzantine-robust voting and aggregation over the packet dataplane.

* **attack injection** — :class:`AdversaryConfig` extends the chaos
  dataplane's :class:`~repro_torch.netsim.faults.FaultConfig` with
  deterministic threefry-keyed Byzantine clients: vote stuffing (with
  colluding cohorts on one target set), sign-flip / scaled-update
  poisoning of phase-2 values;
* **switch-side defenses** — the per-client vote budget, int-domain
  per-slot clipping, and the trimmed-mean / median slot close
  (``FediACConfig.robust_agg``, :mod:`repro_torch.core.robust_agg`);
* **reputation / quarantine** — per-client suspicion with exponential
  decay and probationary quarantine, carried in ``RoundResult.state`` so
  the FL loop checkpoints it with the round.

With every adversary and defense knob at its zero default (and
``robust_agg="sum"``) the robust core is bitwise the chaos core, and in
the lossless full-participation configuration bitwise ``aggregate_stack``.
"""

from .adversary import (ADVERSARY_DYN_FIELDS, ROBUST_STAT_FIELDS,
                        AdversaryConfig, adversary_packet_dyn)
from .core import make_robust_packet_core
from .reputation import init_reputation_state, reputation_update

__all__ = ["AdversaryConfig", "ADVERSARY_DYN_FIELDS", "ROBUST_STAT_FIELDS",
           "adversary_packet_dyn", "make_robust_packet_core",
           "init_reputation_state", "reputation_update"]
