"""The engine registry: one dispatch surface for the stacked FediAC round.

A frozen :class:`EngineSpec` names an engine and carries its knobs;
:func:`run` dispatches a round to the engine a config selects.  Three
engines are ported, each bitwise equal to the others on the same inputs:
``"monolithic"`` (:func:`repro_torch.core.fediac.aggregate_stack`, which
holds several ``[N, d]`` temporaries), ``"stream"``
(:func:`repro_torch.core.stream_engine.aggregate_stream`, the same round
in coordinate chunks with ``O(N·chunk)`` temporaries) and ``"sharded"``
(:func:`repro_torch.core.shard_engine.aggregate_shard`, the round over
coordinate shards, one per device).  The reference's ``"async"`` engine is
a known name that raises ``NotImplementedError`` naming its ROADMAP item.
The reference's ``axis`` knob names a jax mesh axis and has no
counterpart here.
"""

from __future__ import annotations

import dataclasses

from repro_torch.validate import require

__all__ = ["EngineSpec", "get", "resolve", "run"]


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One engine choice plus its knobs, as a single hashable value.
    ``use_pallas`` (the reference's name) routes phase 2 of either engine
    through the fused CUDA kernel; it is the only switch for them.
    ``chunk`` is the stream engine's coordinates per chunk (0: its
    ``DEFAULT_CHUNK``); ``devices`` the sharded engine's number of
    coordinate shards (0: one per visible CUDA device, or 1 on the CPU)."""

    name: str = "monolithic"
    chunk: int = 0
    devices: int = 0
    use_pallas: bool = False

    def __post_init__(self):
        for field in ("chunk", "devices"):
            v = getattr(self, field)
            require(isinstance(v, int) and not isinstance(v, bool) and v >= 0,
                    field, "a non-negative int", v)


def _run_monolithic(spec, u_stack, cfg, key, a):
    from .fediac import aggregate_stack
    return aggregate_stack(u_stack, cfg, key, a=a)


def _run_stream(spec, u_stack, cfg, key, a):
    from .stream_engine import aggregate_stream
    return aggregate_stream(u_stack, cfg, key, a=a, chunk=spec.chunk or None)


def _run_sharded(spec, u_stack, cfg, key, a):
    from .shard_engine import aggregate_shard
    return aggregate_shard(u_stack, cfg, key, a=a,
                           devices=spec.devices or None)


_RUNNERS = {"monolithic": _run_monolithic, "stream": _run_stream,
            "sharded": _run_sharded}
#: the reference's other engines, with the ROADMAP item that ports each
_NOT_PORTED = {"async": "A9: netsim/async_engine.py"}


def _check_name(name: str) -> None:
    if name in _RUNNERS:
        return
    if name in _NOT_PORTED:
        raise NotImplementedError(f"engine {name!r} is not ported yet "
                                  f"(ROADMAP {_NOT_PORTED[name]})")
    raise ValueError(f"unknown FediAC engine {name!r} "
                     f"(expected one of {', '.join(map(repr, _RUNNERS))})")


def get(engine: "str | EngineSpec") -> EngineSpec:
    """Normalize a name or spec to a validated :class:`EngineSpec`."""
    if isinstance(engine, EngineSpec):
        _check_name(engine.name)
        return engine
    if isinstance(engine, str):
        _check_name(engine)
        return EngineSpec(name=engine)
    raise TypeError("engine must be an EngineSpec or a registered name, "
                    f"got {type(engine).__name__}")


def resolve(cfg) -> EngineSpec:
    """The engine spec a config selects."""
    return get(cfg.engine)


def run(u_stack, cfg, key, *, a=None):
    """Run one stacked round on the engine ``cfg`` selects; the
    ``aggregate_stack`` return contract ``(delta, residuals, counts,
    TrafficStats)``."""
    spec = resolve(cfg)
    return _RUNNERS[spec.name](spec, u_stack, cfg, key, a)
