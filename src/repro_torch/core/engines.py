"""The engine registry: one dispatch surface for the stacked FediAC round.

A frozen :class:`EngineSpec` names an engine and carries its knobs;
:func:`run` dispatches a round to the engine a config selects.  Only
``"monolithic"`` (:func:`repro_torch.core.fediac.aggregate_stack`) is
ported; the reference's other engines are known names that raise
``NotImplementedError`` naming their ROADMAP item, and their knobs
(``chunk``, ``devices``, ``axis``) come with them.
"""

from __future__ import annotations

import dataclasses

__all__ = ["EngineSpec", "get", "resolve", "run"]


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One engine choice plus its knobs, as a single hashable value.
    ``use_pallas`` (the reference's name) routes phase 2 of the
    monolithic engine through the fused CUDA kernels; it is the only
    switch for them."""

    name: str = "monolithic"
    use_pallas: bool = False


def _run_monolithic(u_stack, cfg, key, a):
    from .fediac import aggregate_stack
    return aggregate_stack(u_stack, cfg, key, a=a)


_RUNNERS = {"monolithic": _run_monolithic}
#: the reference's other engines, with the ROADMAP item that ports each
_NOT_PORTED = {"stream": "A7: stream engine",
               "sharded": "A8: distributed",
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
    return _RUNNERS[resolve(cfg).name](u_stack, cfg, key, a)
