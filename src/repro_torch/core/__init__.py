"""Core FediAC algorithm of the port: voting, consensus plan, quantization,
the stacked round on its three engines (monolithic
:func:`repro_torch.core.fediac.aggregate_stack`, chunked
:func:`repro_torch.core.stream_engine.aggregate_stream`, coordinate-sharded
:func:`repro_torch.core.shard_engine.aggregate_shard`) and the slice draws
the last two read (:mod:`.streams`), the allreduce and its mesh baselines
(:mod:`.mesh_baselines`), the baselines the paper compares, and the
seed-revision oracle."""

from . import engines
from .baselines import make_aggregator
from .engines import EngineSpec
from .fediac import (FediACConfig, RoundPlan, TrafficStats, aggregate_round,
                     aggregate_stack, build_round_plan, dense_allreduce,
                     fediac_allreduce, round_traffic)
from .mesh_baselines import switchml_allreduce, topk_allreduce
from .powerlaw import (PowerLawFit, expected_uploaded, fit_power_law,
                       gamma_compression_error, min_bits, scale_factor)
from .quantize import dequantize, quantize, stochastic_round
from .seed_ref import aggregate_stack_seed
from .shard_engine import aggregate_shard, shard_compress_stack
from .stream_engine import aggregate_stream, stream_compress_stack
from .streams import gumbel_block, uniform_at, uniform_block
from .voting import gia_from_counts, vote_mask

__all__ = [
    "EngineSpec", "FediACConfig", "TrafficStats", "aggregate_round",
    "aggregate_stack", "aggregate_shard", "shard_compress_stack",
    "fediac_allreduce", "dense_allreduce", "switchml_allreduce",
    "topk_allreduce", "RoundPlan",
    "build_round_plan", "aggregate_stack_seed", "PowerLawFit",
    "fit_power_law", "gamma_compression_error", "expected_uploaded",
    "min_bits", "scale_factor", "quantize", "dequantize", "stochastic_round",
    "vote_mask", "gia_from_counts", "make_aggregator", "engines",
    "round_traffic", "aggregate_stream", "stream_compress_stack",
    "uniform_block", "uniform_at", "gumbel_block",
]
