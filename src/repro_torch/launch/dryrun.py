"""Dry-run: cost every (arch x input shape) step without running it on a
device, and record its roofline terms on the H100.

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each step for the 512-chip TPU mesh out of host placeholder
devices and reads XLA's memory and cost analyses.  The port has no
compiler to ask: it runs the step eagerly on ``meta`` tensors (shapes and
dtypes, no memory, no arithmetic) under :func:`repro_torch.launch.op_cost.
analyze`, which counts FLOPs, bytes and collective payloads per executed
op.  It imports no ``jax`` and sets no ``XLA_FLAGS``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--smoke] [--out DIR]

One JSON record per combination goes into ``--out`` (``build/dryrun`` by
default), with the reference's keys where they map:

* ``params_total`` / ``params_active`` (:func:`active_params`: experts a
  token is not routed to discounted), ``model_flops`` (6 · active · tokens
  for a train step, 2 · active · tokens to serve) and ``tokens``;
* ``flops_per_device`` and ``hbm_bytes_per_device``, the roofline terms
  ``roofline_s`` (compute at ``PEAK_FLOPS_BF16``, memory at ``HBM_BW``: the
  H100's figures of ``launch/mesh.py``), ``dominant`` and
  ``useful_flops_ratio`` (model FLOPs over the FLOPs all devices run);
* ``argument_bytes_per_device``: the step's arguments (parameters, the
  residual, the batch or the decode caches) placed by
  ``models/shardings.py``'s partition specs on the named mesh.

**The port costs the step as it runs it.**  A device is one client with
the whole model (``make_train_step`` refuses a ``model`` axis above 1:
``dist_step._check_one_card``), so "per device" is one client's batch, the
global batch over the mesh's data (and pod) axes (one row at least), and
the model's E local steps over its microbatches in replica mode (one pass
in plain mode).  The parts:

* the local update (``loss_fn`` and its gradients over the microbatches,
  remat recomputes included), the prefill and the decode step run on
  ``meta`` at full size;
* the aggregation reads values back (the consensus plan's sizes), so it is
  costed on real CPU tensors of ``AGG_COSTED`` coordinates, in a one-rank
  gloo group the dry-run opens when none is open, and scaled by the
  update's size (``costing`` in the record says which part was costed
  which way).

What does not map is recorded as ``null`` with its reason
(``not_mapped``), never as a TPU figure: the HLO text; XLA's fusion-aware
bytes and its temp and peak memory analysis (eager PyTorch fuses nothing;
the bytes here are the op-level proxy of ``op_cost``); the 512-chip
mesh's collectives and the ICI term (the port's step aggregates over one
rank per client, not over the TPU mesh).  The reference's skip of whisper
at ``long_500k`` is kept.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import tempfile
import time
import traceback
from dataclasses import replace

import torch

from repro_torch.configs import SHAPES_BY_NAME, get, get_smoke
from repro_torch.configs.registry import ALIASES, ARCH_IDS
from repro_torch.core import prng
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.models import param_specs
from repro_torch.models.model import (decode_step, forward, init_caches,
                                      init_params, param_tree,
                                      reference_leaves)
from repro_torch.models.shardings import set_activation_sharding
from repro_torch.training import dist_step
from repro_torch.training.serve import cache_len_for

__all__ = ["active_params", "input_specs", "run_one", "main", "AGG_COSTED"]

#: coordinates of the real update the aggregation is costed on
AGG_COSTED = 1 << 16
DEFAULT_OUT = os.path.join("build", "dryrun")
NOT_MAPPED = {
    "hlo_text": "eager PyTorch: no compiled program text",
    "memory_analysis": "XLA's temp and peak memory have no eager "
                       "counterpart; argument_bytes_per_device is computed "
                       "from the shapes and partition specs",
    "xla_cost_analysis_raw": "XLA's fusion-aware cost analysis: the bytes "
                             "here are op_cost's op-level proxy",
    "collectives": "the 512-chip mesh's collectives do not map: the port's "
                   "step aggregates over one torch.distributed rank per "
                   "client",
    "ici_term": "no TPU interconnect; the collective roofline term is not "
                "computed",
}


def _is_expert(path) -> bool:
    return any(k in ("we_g", "we_u", "we_d") for k in path)


def active_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts of the reference's tree, exact
    integers; active discounts the experts a token is not routed to, per
    stacked leaf, as the reference does (``n · top_k // n_experts``)."""
    meta = init_params(cfg, prng.PRNGKey(0, device="meta"), device="meta")
    total = active = 0
    for path, ps in reference_leaves(meta):
        n = sum(p.numel() for p in ps)
        total += n
        if cfg.n_experts > 0 and _is_expert(path):
            active += n * cfg.moe_top_k // cfg.n_experts
        else:
            active += n
    return total, active


def input_specs(cfg, shape, rows: int | None = None) -> dict:
    """``meta`` stand-ins for every model input (no allocation), the
    reference's shapes and dtypes: ``rows`` rows (default: the global
    batch)."""
    b = shape.global_batch if rows is None else rows
    s = shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": spec((b, s), torch.int32)}
        if shape.kind == "train":
            specs["targets"] = spec((b, s), torch.int32)
        if cfg.is_enc_dec:
            specs["frames"] = spec((b, cfg.source_len, cfg.d_model),
                                   torch.float32)
        return specs
    return {"token": spec((b, 1), torch.int32)}


def _apply_overrides(cfg, overrides):
    if not overrides:
        return cfg
    fediac_over = {k.split(".", 1)[1]: v for k, v in overrides.items()
                   if k.startswith("fediac.")}
    plain = {k: v for k, v in overrides.items() if not k.startswith("fediac.")}
    if fediac_over:
        plain["fediac"] = replace(cfg.fediac, **fediac_over)
    return replace(cfg, **plain)


def _split(spec_entry, mesh) -> int:
    """How many ways a spec entry (None, an axis name, or a tuple of
    names) splits its dimension on ``mesh``."""
    if spec_entry is None:
        return 1
    names = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    return math.prod(mesh.shape.get(n, 1) for n in names)


def _sharded_bytes(tree, specs, mesh, dtype=None) -> int:
    """Bytes per device of a tree of (meta) tensors under its specs."""
    if isinstance(tree, dict):
        return sum(_sharded_bytes(tree[k], specs[k], mesh, dtype)
                   for k in tree)
    size = torch.empty((), dtype=dtype).element_size() if dtype \
        else tree.element_size()
    return tree.numel() * size // math.prod(_split(e, mesh) for e in specs)


@contextlib.contextmanager
def _one_rank_group():
    """A one-rank gloo group (FileStore in a temporary directory) when no
    process group is open, for costing the aggregation on real tensors."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


class _Span:
    """A one-leaf layout over ``n`` coordinates (``_aggregate`` reads only
    its spans)."""

    def __init__(self, n: int):
        self.spans = [(0, n)]


def _aggregation_cost(cfg, mode: str, size: int) -> dict:
    """The aggregation of an update of ``size`` coordinates: run on real
    CPU tensors of AGG_COSTED coordinates (a one-rank group) under
    op_cost, scaled by ``size / AGG_COSTED``."""
    n = AGG_COSTED
    rng = torch.Generator().manual_seed(0)
    u = torch.randn(n, generator=rng) * 1e-2
    res = torch.zeros(n, dtype=getattr(torch, cfg.residual_dtype))
    key = prng.PRNGKey(0, device="cpu")
    from repro_torch.core import collectives
    with _one_rank_group():
        if mode == "plain":
            cost = op_cost.analyze(collectives.psum_in_order, u, None)
        else:
            cost = op_cost.analyze(dist_step._aggregate, cfg, u, res, key,
                                   _Span(n), None)
    scale = size / n
    return {"flops": cost["flops"] * scale, "bytes": cost["bytes"] * scale,
            "collectives_one_rank": {k: v * scale for k, v in
                                     cost["collectives"].items()}}


def _train_cost(cfg, shape, mesh, rows: int) -> tuple[dict, dict, int]:
    """One client's train step at ``rows`` rows: (cost, details,
    argument bytes per device)."""
    axes = dist_step.client_axes_for(cfg, mesh)
    mode = ("pod" if axes == ("pod",) else "replica") if axes else "plain"
    params = init_params(cfg, prng.PRNGKey(0, device="meta"), device="meta")
    layout = dist_step.FlatLayout(params)
    batch = input_specs(cfg, shape, rows)
    n_micro = max(1, min(cfg.microbatch, rows))
    set_activation_sharding(None, None, None)
    if mode == "plain":
        local = op_cost.analyze(dist_step._microbatched_grad, cfg, params,
                                batch, n_micro, layout)
        local_steps = 1
    else:
        local = op_cost.analyze(dist_step._local_update, cfg, params, batch,
                                1e-2, layout, n_micro)
        local_steps = max(1, cfg.fl_local_steps)
    agg = _aggregation_cost(cfg, mode, layout.size)
    cost = {"flops": local["flops"] + agg["flops"],
            "bytes": local["bytes"] + agg["bytes"]}
    # arguments: parameters and the per-client residual under their
    # specs, the batch over the data axes
    specs = param_specs(params, cfg, model_size=mesh.shape["model"],
                        data_size=mesh.shape["data"])
    tree = param_tree(params)
    args = _sharded_bytes(tree, specs, mesh)
    args += (_sharded_bytes(tree, specs, mesh,
                            getattr(torch, cfg.residual_dtype))
             if axes else 4)
    args += sum(x.numel() * x.element_size() for x in batch.values())
    details = {"mode": mode, "rows_per_device": rows, "microbatches": n_micro,
               "local_steps": local_steps, "update_coordinates": layout.size,
               "local_update": {k: local[k] for k in ("flops", "bytes")},
               "aggregation": agg,
               "costing": {
                   "local_update": "meta tensors at full size, op_cost",
                   "aggregation": f"real CPU tensors of {AGG_COSTED} "
                                  "coordinates in a one-rank gloo group, "
                                  "op_cost, scaled by the update's "
                                  f"{layout.size} coordinates"}}
    return cost, details, args


def _serve_cost(cfg, shape, mesh, rows: int) -> tuple[dict, dict, int]:
    """One device's prefill or decode step at ``rows`` rows."""
    from repro_torch.models.shardings import cache_specs
    params = init_params(cfg, prng.PRNGKey(0, device="meta"), device="meta")
    inputs = input_specs(cfg, shape, rows)
    set_activation_sharding(None, None, None)
    specs = param_specs(params, cfg, model_size=mesh.shape["model"],
                        data_size=mesh.shape["data"])
    args = _sharded_bytes(param_tree(params), specs, mesh)
    args += sum(x.numel() * x.element_size() for x in inputs.values())
    with torch.no_grad():
        if shape.kind == "prefill":
            cost = op_cost.analyze(forward, params, cfg, inputs,
                                   last_only=True)
            details = {"mode": "serve", "rows_per_device": rows}
        else:
            clen, ring = cache_len_for(cfg, shape)
            caches = init_caches(cfg, rows, clen, device="meta")
            cost = op_cost.analyze(decode_step, params, cfg, inputs["token"],
                                   caches, clen - 1, ring=ring)
            # the caches hold this device's rows; their length splits over
            # the model axis where it divides (cache_specs)
            cspecs = cache_specs(caches, batch_divisible=False,
                                 data_axes=None,
                                 model_size=mesh.shape["model"])
            args += _sharded_bytes(caches, cspecs, mesh)
            details = {"mode": "serve", "rows_per_device": rows,
                       "cache_len": clen, "ring": ring}
    details["costing"] = {"step": "meta tensors at full size, op_cost"}
    return cost, details, args


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            smoke: bool = False, overrides: dict | None = None) -> dict:
    """The record of one (arch, shape) on the production mesh (16 x 16, or
    2 x 16 x 16 with ``multi_pod``)."""
    arch = ALIASES.get(arch, arch)
    cfg = _apply_overrides(get_smoke(arch) if smoke else get(arch), overrides)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    if arch == "whisper_tiny" and shape_name == "long_500k":
        return {"arch": cfg.name, "shape": shape_name, "skipped":
                "enc-dec audio model: no 524k-token decode (DESIGN.md §7)"}
    clients = math.prod(mesh.shape[a] for a in dist_step.data_axes_for(mesh))
    rows = max(1, shape.global_batch // clients)
    t0 = time.time()
    if shape.kind == "train":
        cost, details, arg_bytes = _train_cost(cfg, shape, mesh, rows)
    else:
        cost, details, arg_bytes = _serve_cost(cfg, shape, mesh, rows)
    cost_s = time.time() - t0
    total, active = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * active * tokens
    flops_dev, bytes_dev = float(cost["flops"]), float(cost["bytes"])
    terms = {"compute": flops_dev / PEAK_FLOPS_BF16,
             "memory": bytes_dev / HBM_BW, "collective": None}
    dominant = max((k for k in terms if terms[k] is not None),
                   key=terms.get)
    return {
        "arch": cfg.name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": mesh.size,
        "devices": clients,
        "mode": details.pop("mode"),
        "aggregator": cfg.aggregator if shape.kind == "train" else None,
        "params_total": total, "params_active": active,
        "cost_s": round(cost_s, 1),
        "flops_per_device": flops_dev, "hbm_bytes_per_device": bytes_dev,
        "collective_bytes_per_device": None, "collectives": None,
        "roofline_s": terms, "dominant": dominant,
        "model_flops": model_flops, "tokens": tokens,
        "useful_flops_ratio": model_flops / max(flops_dev * clients, 1.0),
        "argument_bytes_per_device": arg_bytes,
        "memory_analysis": None, "xla_cost_analysis_raw": None,
        "hlo_text": None, "not_mapped": NOT_MAPPED,
        "per_device": details,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (see configs.registry)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES_BY_NAME))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="all (arch x shape)")
    ap.add_argument("--smoke", action="store_true", help="reduced configs")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--set", nargs="*", default=[],
                    help="ArchConfig overrides, e.g. microbatch=8 aggregator=dense")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    archs = ARCH_IDS if args.all or not args.arch \
        else [ALIASES.get(args.arch, args.arch)]
    shapes = list(SHAPES_BY_NAME) if args.all or not args.shape \
        else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for a in archs:
        for s in shapes:
            tag = f"{a}_{s}_{'2x16x16' if args.multi_pod else '16x16'}"
            try:
                rec = run_one(a, s, multi_pod=args.multi_pod,
                              smoke=args.smoke, overrides=overrides)
                status = rec.get("skipped") and "SKIP" or rec["dominant"]
                print(f"[dryrun] {tag:55s} {status:10s} "
                      f"cost={rec.get('cost_s', 0):6.1f}s "
                      f"roofline={rec.get('roofline_s')}", flush=True)
            except Exception as e:   # a record of the failure, and go on
                failures += 1
                rec = {"arch": a, "shape": s,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()}
                print(f"[dryrun] {tag:55s} FAIL {type(e).__name__}: {e}",
                      flush=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=2, default=str)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
