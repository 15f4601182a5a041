"""Production distributed train step: one client per rank of a
``torch.distributed`` group.

Mirrors the reference's ``training/dist_step.py``.  Its client topology:

* **replica mode** (``cfg.fsdp=False``): the clients are the ``data`` axis
  (x ``pod``).  Each client runs E >= 1 local SGD steps on its slice of the
  global batch and uploads ``w_0 - w_E``.
* **pod mode** (``cfg.fsdp=True`` on a mesh with a ``pod`` axis): a client
  is a whole pod, E = 1.
* **plain mode** (``cfg.fsdp=True`` on one pod): there is no client axis,
  and the step is plain data-parallel SGD with no aggregation.

The reference materializes every client's update with a leading client
dimension and aggregates them in a ``shard_map`` over the mesh.  Here each
rank of the mesh's process group is one client (or one pod): it computes
its own update from rows ``[r·b/N, (r+1)·b/N)`` of the global batch, as
the reference's reshape gives them, and aggregates it through the port's
allreduces (``fediac_allreduce``, ``dense_allreduce`` and the mesh
baselines), which fold the round key with the rank as the reference folds
it with ``axis_index``.  The ``model`` axis is 1: a mesh with ``model > 1``
(tensor parallelism) is refused.

The update is raveled as the reference ravels its tree
(:class:`FlatLayout`): leaves in sorted key order, each group leaf stacked
over its layers, so the same update gives the same flat vector, the same
per-leaf keys (``granularity="tensor"``: one aggregation per leaf, a
stacked leaf being one aggregation of all its layers) and the same
result.  The error-feedback residual is carried flat in that order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.core import collectives, engines, mesh_baselines, prng
from repro_torch.core.fediac import dense_allreduce, fediac_allreduce
from repro_torch.models import loss_fn, param_specs
from repro_torch.models.model import init_params, reference_leaves
from repro_torch.models.shardings import (partition_spec,
                                          set_activation_sharding)

__all__ = ["client_axes_for", "n_clients_for", "data_axes_for", "FlatLayout",
           "TrainStepBundle", "make_train_step"]


# ---------------------------------------------------------------------------
# topology helpers
# ---------------------------------------------------------------------------

def client_axes_for(cfg, mesh) -> tuple[str, ...]:
    multi_pod = "pod" in mesh.axis_names
    if cfg.fsdp:
        return ("pod",) if multi_pod else ()
    return ("pod", "data") if multi_pod else ("data",)


def n_clients_for(cfg, mesh) -> int:
    n = 1
    for ax in client_axes_for(cfg, mesh):
        n *= mesh.shape[ax]
    return n


def data_axes_for(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# ---------------------------------------------------------------------------
# the reference's ravel order over the port's parameters
# ---------------------------------------------------------------------------

class FlatLayout:
    """Where each parameter of a model sits in the reference's
    ``ravel_pytree`` of its parameter tree.

    ``params`` lists the parameters in ravel order (leaves in sorted key
    order, a group leaf's layers in layer order); ``spans`` gives each
    leaf's ``(offset, size)`` in the flat vector of ``size`` elements."""

    def __init__(self, params):
        self.params, self.spans, self._offsets = [], [], []
        off = 0
        for _, ps in reference_leaves(params):
            start = off
            for p in ps:
                self.params.append(p)
                self._offsets.append(off)
                off += p.numel()
            self.spans.append((start, off - start))
        self.size = off

    def views(self, flat: torch.Tensor) -> list:
        """Each parameter's piece of ``flat``, shaped like the parameter."""
        return [flat[o:o + p.numel()].view(p.shape)
                for o, p in zip(self._offsets, self.params)]

    def gather(self) -> torch.Tensor:
        """The parameters raveled into one new vector."""
        return torch.cat([p.detach().reshape(-1) for p in self.params])


# ---------------------------------------------------------------------------
# microbatched per-client local update
# ---------------------------------------------------------------------------

def _microbatched_grad(cfg, params, batch: dict, n_micro: int,
                       layout: FlatLayout):
    """Mean loss gradient over a client batch, over ``n_micro`` microbatches
    of consecutive rows: ``(loss, g)``, ``g`` raveled in ``grad_dtype``,
    accumulated from zeros and scaled by ``1 / n_micro``."""
    b = batch["tokens"].shape[0]
    n_micro = min(n_micro, b)
    if b % n_micro:
        raise ValueError(f"a batch of {b} rows does not split into "
                         f"{n_micro} microbatches")
    mb = b // n_micro
    device = layout.params[0].device
    g = torch.zeros(layout.size, dtype=getattr(torch, cfg.grad_dtype),
                    device=device)
    acc = layout.views(g)
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(n_micro):
        loss = loss_fn(params, cfg, {k: v[i * mb:(i + 1) * mb]
                                     for k, v in batch.items()})
        grads = torch.autograd.grad(loss, layout.params, allow_unused=True)
        for a, gi in zip(acc, grads):
            if gi is not None:
                a += gi.to(a.dtype)
        loss_sum = loss_sum + loss.detach()
        del loss, grads
    scale = 1.0 / n_micro
    return loss_sum * scale, g.mul_(scale)


def _local_update(cfg, params, client_batch: dict, lr: float,
                  layout: FlatLayout, n_micro: int | None = None):
    """One client's upload U = w_0 - w_E after E local SGD steps (Algo. 1
    lines 3-4); E = 1 reduces to lr * grad.

    Returns ``(update, loss, w0)``: the raveled update, the mean loss over
    the E steps, and for E > 1 the raveled start point ``w0`` (the model
    then holds ``w_E``; ``None`` for E = 1, which leaves the model as it
    was)."""
    e = max(1, cfg.fl_local_steps)
    n_micro = cfg.microbatch if n_micro is None else n_micro
    if e == 1:
        loss, g = _microbatched_grad(cfg, params, client_batch, n_micro,
                                     layout)
        return g.mul_(lr), loss, None

    w0 = layout.gather()
    losses = []
    for _ in range(e):
        loss, g = _microbatched_grad(cfg, params, client_batch, n_micro,
                                     layout)
        with torch.no_grad():
            for p, gv in zip(layout.params, layout.views(g)):
                p.copy_((p.float() - lr * gv).to(p.dtype))
        losses.append(loss)
        del g
    update = torch.empty(layout.size, dtype=torch.float32, device=w0.device)
    with torch.no_grad():
        for u, a, p in zip(layout.views(update), layout.views(w0),
                           layout.params):
            torch.sub(a.float(), p.float(), out=u)
    return update, torch.stack(losses).mean(), w0


def _apply(layout: FlatLayout, w0, delta: torch.Tensor) -> None:
    """Each parameter becomes ``(w0 - delta)`` in float32, cast to its
    dtype (``w0``: the model's own parameters when ``None``)."""
    bases = layout.params if w0 is None else layout.views(w0)
    with torch.no_grad():
        for p, base, dv in zip(layout.params, bases, layout.views(delta)):
            p.copy_((base.float() - dv.float()).to(p.dtype))


def _aggregate_flat(cfg, flat_u, flat_res, key, group):
    if cfg.aggregator == "dense":
        return dense_allreduce(flat_u, flat_res, key, group=group)
    if cfg.aggregator == "switchml":
        return mesh_baselines.switchml_allreduce(flat_u, flat_res, key,
                                                 cfg.fediac, group)
    if cfg.aggregator == "topk":
        return mesh_baselines.topk_allreduce(flat_u, flat_res, key,
                                             cfg.fediac, group)
    return fediac_allreduce(flat_u, flat_res, key, cfg.fediac, group)


def _aggregate(cfg, update: torch.Tensor, residual: torch.Tensor, key,
               layout: FlatLayout, group):
    """This client's side of the round: ``(mean update, new residual)``,
    raveled.  At ``granularity="tensor"`` (any aggregator but dense) one
    aggregation per leaf of the reference's tree, with the leaf's key from
    ``split(key, number of leaves)``; otherwise one over the whole vector
    with ``key``."""
    rdt = getattr(torch, cfg.residual_dtype)
    if cfg.fediac.granularity == "tensor" and cfg.aggregator != "dense":
        keys = prng.split(key, len(layout.spans))
        mean = torch.empty_like(update)
        new_res = torch.empty(update.shape, dtype=rdt, device=update.device)
        for (o, n), k in zip(layout.spans, keys):
            m, nr = _aggregate_flat(cfg, update[o:o + n], residual[o:o + n],
                                    k, group)
            mean[o:o + n] = m.to(update.dtype)
            new_res[o:o + n] = nr.to(rdt)
        return mean, new_res
    mean, new_res = _aggregate_flat(cfg, update, residual, key, group)
    # the reference unravels both into the update's leaf dtypes
    return mean.to(update.dtype), new_res.to(update.dtype).to(rdt)


def _tree_norm(flat: torch.Tensor, layout: FlatLayout) -> torch.Tensor:
    total = 0
    for o, n in layout.spans:
        total = total + torch.sum(torch.square(flat[o:o + n].float()))
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# step factory
# ---------------------------------------------------------------------------

@dataclass
class TrainStepBundle:
    step: callable        # (params, residual, batch, key) -> (params, residual, metrics)
    params_spec: object   # the reference's partition specs, per leaf
    residual_spec: object
    batch_spec: dict
    n_clients: int
    mode: str             # replica | pod | plain


def _spec_map(fn, specs):
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v) for k, v in specs.items()}
    return fn(specs)


def _check_one_card(mesh, mode: str) -> None:
    """Refuse what one card cannot run: tensor parallelism, and a mesh
    whose ranks are not its clients (one rank each)."""
    world = dist.get_world_size(mesh.group) if dist.is_initialized() else 1
    if mesh.shape["model"] > 1:
        raise ValueError(
            f"make_train_step runs one client per rank with the model axis "
            f"1; this mesh has model={mesh.shape['model']} (tensor "
            f"parallelism is not ported: ROADMAP H3)")
    if mesh.size != world or (mode == "pod" and mesh.shape["data"] > 1):
        raise ValueError(
            f"make_train_step runs one client (or pod) per rank: the mesh "
            f"{dict(mesh.shape)} needs {mesh.size} ranks with data=1 in pod "
            f"mode, and the process group has {world} (use "
            f"launch.mesh.make_test_mesh)")


def make_train_step(cfg, mesh, *, lr: float = 1e-2,
                    use_pallas: bool | None = None) -> TrainStepBundle:
    """The train step of ``cfg`` on ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`), for the rank that calls it.

    ``step(params, residual, batch, key) -> (params, residual, metrics)``:
    ``params`` is the model (updated in place and returned), ``residual``
    this client's raveled error-feedback state (:class:`FlatLayout`; a
    0-d placeholder in plain mode), ``batch`` the global batch (every rank
    passes the same), ``key`` the round key.  ``use_pallas`` switches the
    fused CUDA kernels of the aggregation (``EngineSpec(use_pallas=)``).
    """
    if use_pallas is not None:
        spec = dataclasses.replace(engines.resolve(cfg.fediac),
                                   use_pallas=use_pallas)
        cfg = cfg.with_(fediac=dataclasses.replace(cfg.fediac, engine=spec))
    model_size = mesh.shape["model"]
    data_size = mesh.shape["data"]
    axes = client_axes_for(cfg, mesh)
    n_clients = n_clients_for(cfg, mesh)
    dax = data_axes_for(mesh)
    mode = ("pod" if axes == ("pod",) else "replica") if axes else "plain"
    _check_one_card(mesh, mode)

    meta = init_params(cfg, prng.PRNGKey(0, device="meta"), device="meta")
    pspec = param_specs(meta, cfg, model_size=model_size, data_size=data_size)
    # residual: per-client error feedback, with the client axes leading
    res_spec = (_spec_map(lambda s: partition_spec(axes, *s), pspec)
                if axes else ())
    bspec = {"tokens": partition_spec(dax, None),
             "targets": partition_spec(dax, None)}
    if cfg.is_enc_dec:
        bspec["frames"] = partition_spec(dax, None, None)

    if cfg.fsdp:
        act_batch = tuple(a for a in dax if a not in axes) or None
        feat = "model" if cfg.act_shard == "feature" else None
        seq = "model" if cfg.act_shard == "sequence" else None
        set_activation_sharding(mesh, act_batch, feat, seq)
    else:
        set_activation_sharding(None, None, None)

    if not axes:
        step = _make_plain_step(cfg, lr, mesh)
    else:
        step = _make_fl_step(cfg, mesh, n_clients, lr)
    return TrainStepBundle(step, pspec, res_spec, bspec, n_clients, mode)


def _rows(batch: dict, r: int, rows: int, device) -> dict:
    return {k: torch.as_tensor(v)[r * rows:(r + 1) * rows].to(device)
            for k, v in batch.items()}


def _split(batch: dict, parts: int) -> int:
    gb = batch["tokens"].shape[0]
    if gb % parts:
        raise ValueError(f"a global batch of {gb} rows does not split over "
                         f"{parts} ranks")
    return gb // parts


def _make_plain_step(cfg, lr, mesh=None):
    """One pod, no client axis: data-parallel SGD over the mesh's ranks.
    Each rank takes its rows of the global batch; the ranks' gradients
    (and losses) are averaged, summed in rank order, so every rank
    applies the same step.  The mean over equal shares is the
    reference's gradient of the whole batch."""
    group = mesh.group if mesh is not None else None

    def step(params, residual, batch, key):
        layout = FlatLayout(params)
        world = dist.get_world_size(group) if dist.is_initialized() else 1
        rows = _split(batch, world)
        r = dist.get_rank(group) if dist.is_initialized() else 0
        n_micro = max(1, min(cfg.microbatch, rows))
        loss, g = _microbatched_grad(
            cfg, params, _rows(batch, r, rows, layout.params[0].device),
            n_micro, layout)
        if world > 1:
            n = torch.tensor(float(world), device=g.device)
            g = collectives.psum_in_order(g, group) / n.to(g.dtype)
            loss = collectives.psum_in_order(loss, group) / n
        _apply(layout, None, lr * g)
        return params, residual, {"loss": loss,
                                  "update_norm": _tree_norm(g, layout)}

    return step


def _make_fl_step(cfg, mesh, n_clients: int, lr):
    group = mesh.group

    def step(params, residual, batch, key):
        layout = FlatLayout(params)
        device = layout.params[0].device
        per_client_b = _split(batch, n_clients)
        n_micro = max(1, min(cfg.microbatch, per_client_b))
        r = collectives.rank(group)
        update, loss, w0 = _local_update(
            cfg, params, _rows(batch, r, per_client_b, device), lr, layout,
            n_micro)
        mean_u, new_res = _aggregate(cfg, update, residual, key.to(device),
                                     layout, group)
        del update
        _apply(layout, w0, mean_u)
        losses = collectives.all_gather(loss.reshape(1), group)
        metrics = {"loss": losses.mean(), "update_norm": _tree_norm(mean_u,
                                                                     layout)}
        return params, new_res, metrics

    return step
