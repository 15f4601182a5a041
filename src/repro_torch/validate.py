"""Shared config-field validation (one vocabulary for every config).

``NetConfig`` grew ad-hoc ``__post_init__`` checks; this module is those
checks factored into reusable primitives so ``FediACConfig`` /
``FLConfig`` / ``NetConfig`` / ``FaultConfig`` / ``ScenarioSpec`` all
validate the same way and say it the same way: every failure is a
``ValueError`` reading ``"<field> must be <requirement>, got <value>"``
(``tests/test_config_validation.py`` sweeps the bounds of every field).

Validation runs once at construction, on host Python scalars — configs
are static almost everywhere (jit closure / sweep cache keys), so a bad
value fails loudly at build time instead of silently distorting a traced
round.
"""

from __future__ import annotations

import math

__all__ = ["require", "check_interval", "check_at_least",
           "check_finite_at_least", "check_positive_finite", "check_choice"]


def require(cond: bool, name: str, requirement: str, value) -> None:
    """The one failure shape every config check reduces to."""
    if not cond:
        raise ValueError(f"{name} must be {requirement}, got {value!r}")


def check_interval(name: str, value, lo, hi, *, lo_open: bool = False,
                   hi_open: bool = False) -> None:
    """``value`` in the real interval from ``lo`` to ``hi`` (NaN fails)."""
    ok = ((value > lo if lo_open else value >= lo)
          and (value < hi if hi_open else value <= hi))
    iv = f"{'(' if lo_open else '['}{lo}, {hi}{')' if hi_open else ']'}"
    require(bool(ok), name, f"in {iv}", value)


def check_at_least(name: str, value, lo) -> None:
    require(value >= lo, name, f">= {lo}", value)


def check_finite_at_least(name: str, value, lo) -> None:
    require(math.isfinite(value) and value >= lo, name,
            f"finite and >= {lo}", value)


def check_positive_finite(name: str, value) -> None:
    require(math.isfinite(value) and value > 0, name,
            "positive and finite", value)


def check_choice(name: str, value, choices) -> None:
    require(value in choices, name,
            f"one of {', '.join(map(repr, choices))}", value)
