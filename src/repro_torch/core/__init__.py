"""Core FediAC algorithm of the port: voting, consensus plan, quantization
and the stacked round (:func:`repro_torch.core.fediac.aggregate_stack`)."""

from . import engines
from .engines import EngineSpec
from .fediac import (FediACConfig, TrafficStats, aggregate_round,
                     aggregate_stack, round_traffic)
from .round_plan import RoundPlan, build_round_plan

__all__ = ["EngineSpec", "FediACConfig", "RoundPlan", "TrafficStats",
           "aggregate_round", "aggregate_stack", "build_round_plan",
           "engines", "round_traffic"]
