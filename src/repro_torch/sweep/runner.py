"""The sweep runner: grid x seeds -> grouped fleets.

``run_sweep`` expands a scenario grid over a seed axis, groups the cells by
batch signature, and runs each group as fleets
(:func:`repro_torch.sweep.fleet.run_fleet_cells`) of at most ``max_fleet``
cells.  Cells that cannot ride a fleet (packet baselines, packet cells on
the stream engine; :meth:`ScenarioSpec.batchable`) take the sequential
``run_federated`` path — same results, one process.

Grids larger than memory (or longer than a preemption window) resume from
an on-disk progress file: after every chunk the finished cells' histories
are checkpointed (:mod:`repro_torch.checkpoint` flat-npz, the reference's
format and keys), and a restarted sweep skips them.  Histories are
deterministic, so a resumed sweep is indistinguishable from an
uninterrupted one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.fl_loop import FLHistory, run_federated

from .fleet import run_fleet_cells
from .spec import ScenarioSpec, cell_key

__all__ = ["CellResult", "SweepResult", "run_sweep", "run_cell_sequential"]


@dataclass
class CellResult:
    spec: ScenarioSpec
    seed: int
    key: str
    history: FLHistory
    resumed: bool = False   # loaded from the progress file, not re-run


@dataclass
class SweepResult:
    cells: list

    def __iter__(self):
        return iter(self.cells)

    def __len__(self):
        return len(self.cells)

    def by_key(self) -> dict:
        return {c.key: c for c in self.cells}

    def history(self, spec: ScenarioSpec, seed: int) -> FLHistory:
        return self.by_key()[cell_key(spec, seed)].history


def run_cell_sequential(spec: ScenarioSpec, seed: int, *, probe=None,
                        device=None) -> FLHistory:
    """One cell through the per-cell ``run_federated`` loop on ``device``
    (the card unless told otherwise)."""
    clients, test = spec.make_task(seed)
    return run_federated(list(clients), test, spec.to_flconfig(seed),
                         hidden=spec.hidden, device=device, probe=probe)


# ---------------------------------------------------------------------------
# progress file: {cell_key: {acc, wall_clock, traffic_mb, loss}} flat npz
# ---------------------------------------------------------------------------

_FIELDS = ("acc", "wall_clock", "traffic_mb", "loss")


def _load_progress(path: str) -> dict:
    if not path or not os.path.exists(path):
        return {}
    arrays, _ = load_checkpoint(path)
    done: dict = {}
    for flat_key, arr in arrays.items():
        key, _, fld = flat_key.rpartition("/")
        if fld in _FIELDS and key:
            done.setdefault(key, {})[fld] = np.asarray(arr)
    return {k: v for k, v in done.items() if set(v) == set(_FIELDS)}


def _save_progress(path: str, done: dict) -> None:
    if path:
        save_checkpoint(path, done)


def _to_history(rec: dict) -> FLHistory:
    return FLHistory(acc=[float(v) for v in rec["acc"]],
                     wall_clock=[float(v) for v in rec["wall_clock"]],
                     traffic_mb=[float(v) for v in rec["traffic_mb"]],
                     loss=[float(v) for v in rec["loss"]])


def _to_record(h: FLHistory) -> dict:
    return {"acc": np.asarray(h.acc, np.float64),
            "wall_clock": np.asarray(h.wall_clock, np.float64),
            "traffic_mb": np.asarray(h.traffic_mb, np.float64),
            "loss": np.asarray(h.loss, np.float64)}


# ---------------------------------------------------------------------------

def run_sweep(specs, seeds=(0,), *, max_fleet: int = 16,
              progress_path: str | None = None, sequential: bool = False,
              probe=None, device=None) -> SweepResult:
    """Run every (scenario, seed) cell of ``specs`` x ``seeds`` on
    ``device`` (the card unless told otherwise).

    ``max_fleet`` bounds a fleet's cells (chunking keeps device memory flat
    for grids larger than memory); ``sequential=True`` forces the per-cell
    ``run_federated`` path (the fleet's bit-identity oracle).
    ``progress_path`` enables chunk-level resume.  ``probe`` (a
    :mod:`repro_torch.obs` probe) is threaded through both paths; cell
    histories do not depend on it.
    """
    device = resolve_device(device)
    cells = [(spec, seed) for spec in specs for seed in seeds]
    keys = [cell_key(spec, seed) for spec, seed in cells]
    done = _load_progress(progress_path) if progress_path else {}
    results: dict = {k: CellResult(spec, seed, k, _to_history(done[k]),
                                   resumed=True)
                     for (spec, seed), k in zip(cells, keys) if k in done}

    # ---- group the pending cells: one fleet per batch signature.
    fleet_groups: dict = {}
    seq_cells = []
    for (spec, seed), k in zip(cells, keys):
        if k in results:
            continue
        if not sequential and spec.batchable():
            fleet_groups.setdefault(spec.batch_signature(), []).append(
                (spec, seed, k))
        else:
            seq_cells.append((spec, seed, k))

    def _record(spec, seed, k, hist):
        results[k] = CellResult(spec, seed, k, hist)
        done[k] = _to_record(hist)

    for group in fleet_groups.values():
        for lo in range(0, len(group), max_fleet):
            chunk = group[lo:lo + max_fleet]
            hists = run_fleet_cells([(s, seed) for s, seed, _ in chunk],
                                    probe=probe, device=device)
            for (spec, seed, k), hist in zip(chunk, hists):
                _record(spec, seed, k, hist)
            _save_progress(progress_path, done)

    for spec, seed, k in seq_cells:
        _record(spec, seed, k, run_cell_sequential(spec, seed, probe=probe,
                                                   device=device))
        _save_progress(progress_path, done)

    return SweepResult([results[k] for k in keys])
