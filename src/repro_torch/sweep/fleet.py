"""The fleet: K same-signature (scenario, seed) cells run round by round
together, their local training batched along a leading fleet axis.

``run_fleet_cells`` keeps one :class:`~repro_torch.training.fl_loop.FLRun`
per cell — the state ``run_federated`` keeps for one run: its data, model,
error-feedback stack, PRNG key, round transport, aggregator state and
pricing — and each round runs

* **local training** for all K·N clients as one batched call of the
  shared ``make_client_round``: per-client models ``[K·N, d]``, the client keys
  each cell's ``run_federated`` would split (``split(k1, N)``), each
  cell's own sampling bound over rows zero-padded to the fleet's largest
  client dataset, and each cell's learning rate as float32;
* **the aggregator half** per cell through the object ``run_federated``
  itself uses, ``transport.round(u, state, k2, t)`` — the memory cores,
  the packet, chaos and robust cores and the async core with their state;
* **evaluation**: each cell's test logits, as ``run_federated``'s, then
  one argmax over the K models;
* **pricing** per cell by ``FLRun.apply``, ``run_federated``'s own
  accumulation order.

The contract: each cell's :class:`FLHistory` equals its sequential
``run_federated`` run bit for bit.  Everything but local training is that
run's own code on that cell's tensors, and local training is elementwise
across clients except for its batched matrix products, whose bits must
not depend on how many clients share a call.  They do not on the CPU nor
on an NVIDIA H100 (every cell of the paper's Fig. 2 grid, N = 20, with
the whole fleet in one call, against one cell per call), so all K·N
clients share one call.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.obs import as_probe
from repro_torch.training.fl_loop import FLRun, _carry_in, make_client_round

__all__ = ["run_fleet_cells"]


def _pad_rows(x: torch.Tensor, size: int) -> torch.Tensor:
    """Pad axis 1 (per-client dataset rows) with zeros up to ``size``."""
    if x.shape[1] == size:
        return x
    pad = x.new_zeros((x.shape[0], size - x.shape[1], *x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def _stack_clients(runs) -> tuple:
    """Every cell's client data, zero-padded to the largest cell's rows and
    flattened to ``K·N`` clients, with each client's own sampling bound."""
    size = max(r.cy.shape[1] for r in runs)
    cx = torch.cat([_pad_rows(r.cx, size) for r in runs])
    cy = torch.cat([_pad_rows(r.cy, size) for r in runs])
    bound = torch.tensor([r.cy.shape[1] for r in runs for _ in range(r.n)],
                         dtype=torch.int32, device=cy.device)
    return cx, cy, bound


def _emit_cell(probe, spec, seed, hist, extras=None) -> None:
    """Per-cell summary metrics, labelled by scenario name and seed (only
    called when ``probe.enabled``)."""
    last = hist.records[-1]
    payload = {"acc": last.acc, "loss": last.loss,
               "wall_clock_cum_s": last.wall_clock,
               "traffic_cum_mb": last.traffic_mb}
    if extras:
        payload.update(extras)
    probe.metrics(payload, labels={"cell": spec.name, "seed": str(seed)})


def _packet_extras(retx: int, last: dict) -> dict:
    """A packet cell's retransmissions over the run and its last round's
    participants and uploaders."""
    return {"retransmissions": retx,
            "n_part": int(np.asarray(last["participants"]).sum()),
            "n_up": int(np.asarray(last["uploaders"]).size)}


def run_fleet_cells(cells, *, probe=None, device=None):
    """Run same-signature cells as one fleet on ``device`` (the card
    unless told otherwise).

    ``cells``: list of ``(ScenarioSpec, seed)`` sharing one
    ``batch_signature()``.  Returns one :class:`FLHistory` per cell, each
    bit-identical to that cell's sequential ``run_federated`` run.

    ``probe`` (a :mod:`repro_torch.obs` probe) observes the fleet from the
    host: ``fleet-round`` spans, per-cell metrics labelled ``cell`` and
    ``seed``, and the wrapped local-training call.  It reads only values
    the fleet computes anyway, so any probe leaves every history
    bit-identical.
    """
    probe = as_probe(probe)
    device = resolve_device(device)
    spec0 = cells[0][0]
    sig0 = spec0.batch_signature()
    if any(s.batch_signature() != sig0 for s, _ in cells):
        raise ValueError("fleet cells must share one batch signature")
    runs = []
    for spec, seed in cells:
        clients, test = spec.make_task(seed)
        runs.append(FLRun(list(clients), test, spec.to_flconfig(seed),
                          hidden=spec.hidden, device=device))
    k, n = len(runs), spec0.n_clients
    cx, cy, bound = _stack_clients(runs)
    client_round = probe.wrap_jit(
        make_client_round(runs[0].dims, spec0.batch, spec0.local_steps),
        f"fleet_local_round[{k}x{n}]")
    # a probed packet cell's retransmissions so far and last round stats
    watch = probe.enabled and spec0.transport == "packet"
    retx, last = [0] * k, [None] * k

    for t in range(1, spec0.rounds + 1):
        with probe.span("fleet-round", round=t, cells=k):
            lr = torch.tensor(np.array([r.lr(t) for r in runs], np.float32),
                              device=device).repeat_interleave(n)
            keys = [r.next_keys() for r in runs]
            client_keys = prng.split(torch.stack([k1 for k1, _ in keys]),
                                     n).reshape(k * n, 2)
            flat = torch.stack([r.flat for r in runs]).repeat_interleave(
                n, dim=0)
            u, losses = client_round(flat, client_keys, lr, cx, cy, bound)
            u, losses = u.reshape(k, n, -1), losses.reshape(k, n)
            for b, run in enumerate(runs):
                res = run.transport.round(
                    _carry_in(u[b], run.e_stack), run.agg_state,
                    keys[b][1], t)
                run.apply(res)
                if watch:
                    retx[b] += int(res.stats.get("retransmissions", 0))
                    last[b] = res.stats
            pred = torch.argmax(torch.stack([r.logits() for r in runs]),
                                dim=-1)
            for b, run in enumerate(runs):
                acc = float((pred[b] == run.yt).to(torch.float32).mean())
                # a fresh [N] tensor, as the sequential loss vector is
                run.record(acc, losses[b].clone())

    hists = [r.hist for r in runs]
    if probe.enabled:
        for b, (spec, seed) in enumerate(cells):
            _emit_cell(probe, spec, seed, hists[b],
                       _packet_extras(retx[b], last[b]) if watch else None)
    return hists
