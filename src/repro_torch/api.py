"""The stable public surface of the port, name for name the reference's
(``repro.api``).

Import supported entry points from here::

    from repro_torch.api import FediACConfig, EngineSpec, run_federated

Everything re-exported below is pinned by ``tests/test_torch_api.py``
against ``repro.api.__all__``: adding to or removing from this surface is
a deliberate act on both packages.  Module paths inside ``repro_torch.*``
may move; ``repro_torch.api`` names do not.

The surface, by layer:

* **round engines** — :class:`FediACConfig` + :class:`EngineSpec` select
  and tune an engine; :func:`aggregate_round` runs one stacked round on
  it (``aggregate_stack`` is the monolithic oracle every engine is
  bit-identical to); :func:`build_round_plan` exposes the shared
  phase-1 → phase-2 consensus plan.
* **training** — :func:`run_federated` drives the FL loop from an
  :class:`FLConfig` (transport, network model, engine overrides),
  returning an :class:`FLHistory`.
* **sweeps** — :func:`run_sweep` executes a grid of
  :class:`ScenarioSpec` cells through the fleet runner.
* **network + fault models** — :class:`NetConfig` / :class:`FaultConfig`
  configure the packet dataplane and its chaos extensions.
* **observability** — :class:`RoundProbe` is the probe interface;
  :class:`RecordingProbe` writes the JSONL trace, :data:`NULL_PROBE`
  is the zero-overhead default.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from repro_torch.core.engines import EngineSpec
from repro_torch.core.fediac import (FediACConfig, TrafficStats,
                                     aggregate_round, aggregate_stack)
from repro_torch.core.round_plan import RoundPlan, build_round_plan
from repro_torch.netsim.faults import FaultConfig
from repro_torch.netsim.policies import NetConfig
from repro_torch.obs.probe import (NULL_PROBE, NullProbe, RecordingProbe,
                                   RoundProbe)
from repro_torch.sweep.runner import run_sweep
from repro_torch.sweep.spec import ScenarioSpec
from repro_torch.training.fl_loop import FLConfig, FLHistory, run_federated

__all__ = [
    # round engines
    "EngineSpec", "FediACConfig", "RoundPlan", "TrafficStats",
    "aggregate_round", "aggregate_stack", "build_round_plan",
    # training
    "FLConfig", "FLHistory", "run_federated",
    # sweeps
    "ScenarioSpec", "run_sweep",
    # network + fault models
    "NetConfig", "FaultConfig",
    # observability
    "NULL_PROBE", "NullProbe", "RecordingProbe", "RoundProbe",
]
