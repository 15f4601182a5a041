"""The engine registry: one dispatch surface for the stacked FediAC round.

A frozen :class:`EngineSpec` names an engine and carries its knobs;
:func:`run` dispatches a round to the engine a config selects.  Two
engines are ported, each bitwise equal to the other on the same inputs:
``"monolithic"`` (:func:`repro_torch.core.fediac.aggregate_stack`, which
holds several ``[N, d]`` temporaries) and ``"stream"``
(:func:`repro_torch.core.stream_engine.aggregate_stream`, the same round
in coordinate chunks with ``O(N·chunk)`` temporaries).  The reference's
other engines are known names that raise ``NotImplementedError`` naming
their ROADMAP item; their knobs (``devices``, ``axis``) come with them.
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
    ``DEFAULT_CHUNK``)."""

    name: str = "monolithic"
    chunk: int = 0
    use_pallas: bool = False

    def __post_init__(self):
        require(isinstance(self.chunk, int) and not isinstance(self.chunk, bool)
                and self.chunk >= 0, "chunk", "a non-negative int", self.chunk)


def _run_monolithic(spec, u_stack, cfg, key, a):
    from .fediac import aggregate_stack
    return aggregate_stack(u_stack, cfg, key, a=a)


def _run_stream(spec, u_stack, cfg, key, a):
    from .stream_engine import aggregate_stream
    return aggregate_stream(u_stack, cfg, key, a=a, chunk=spec.chunk or None)


_RUNNERS = {"monolithic": _run_monolithic, "stream": _run_stream}
#: the reference's other engines, with the ROADMAP item that ports each
_NOT_PORTED = {"sharded": "A8: distributed",
               "async": "A9: packet dataplane"}


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
