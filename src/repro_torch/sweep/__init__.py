"""Scenario-grid sweeps: declarative FL scenarios, a fleet runner that
runs S seeds x K same-signature scenarios round by round with their local
training batched, and the named grids of the paper's figures — the port
of :mod:`repro.sweep`, with its names."""

from .grids import GRIDS, get_grid, smoke_grid
from .runner import (CellResult, SweepResult, run_cell_sequential, run_sweep)
from .spec import ScenarioSpec, cell_key

__all__ = ["ScenarioSpec", "cell_key", "run_sweep", "run_cell_sequential",
           "SweepResult", "CellResult", "GRIDS", "get_grid", "smoke_grid"]
