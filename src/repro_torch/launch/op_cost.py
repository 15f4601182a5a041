"""Operation-level cost of one eager call: FLOPs, bytes and collective
payloads per executed aten op.

The port's counterpart of the reference's ``launch/hlo_cost.py``, which
parses XLA's optimized HLO, multiplies each computation by the trip
counts of the loops around it and sums FLOPs, HBM bytes and collective
payloads per device.  Here the program is eager PyTorch, so
:func:`analyze` runs the call itself under a ``TorchDispatchMode`` and
counts every aten op as it executes.  Eager execution runs every
iteration of every loop (layers, microbatches, local steps, KV tiles), so
there is no trip count to correct: each op is counted as many times as it
runs.  Run the call on ``meta`` tensors (``init_params(...,
device="meta")`` and meta inputs) and it allocates and computes nothing:
the counts come from shapes and dtypes alone, at any size.

Per executed op (the keys and rules of ``hlo_cost.analyze``):

* ``flops``: ``2 · ∏(output dims) · ∏(contracted dims)`` for every matrix
  product (``mm``, ``addmm``, ``bmm``, ``baddbmm``) and convolution (its
  backward counted once per gradient it computes).  PyTorch decomposes
  ``matmul``, ``einsum`` and ``linear`` into these before they dispatch.
* ``bytes``: twice the output bytes (a read-and-write proxy) of the op
  kinds that mirror the reference's ``_BYTES_OPS``: products, gathers,
  scatters, index ops, copies, concatenations, sorts and reductions; an
  in-place scatter or copy counts its source, as the reference counts a
  ``dynamic-update-slice``'s update.  Eager elementwise ops are left out,
  as the reference leaves out the elementwise chains a TPU would fuse;
  views move nothing.
* ``collectives``: payload bytes per kind (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``broadcast``) from the ``c10d`` ops
  that dispatch (``torch.distributed`` on a process group): the largest
  tensor among the op's operands, as the reference takes the largest
  shape on the line; ``collective_bytes`` is their sum.

A call that reads a value back (``.item()``, ``nonzero``, a size that
depends on the data) cannot run on ``meta``; cost it on small real tensors
and scale it by its shapes (``launch/dryrun.py`` does so for the
aggregation).
"""

from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["analyze"]

_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "convolution",
             "convolution_backward", "_convolution"}
_GATHERS = {"gather", "index_select", "embedding", "take", "index",
            "take_along_dim", "embedding_dense_backward"}
_SCATTERS = {"scatter", "scatter_add", "scatter_reduce", "index_add",
             "index_copy", "index_put", "index_fill", "masked_scatter",
             "_index_put_impl"}
_COPIES = {"copy", "_to_copy", "clone", "contiguous", "_copy_from",
           "slice_backward", "select_backward", "as_strided_scatter",
           "slice_scatter", "select_scatter", "constant_pad_nd", "flip",
           "roll", "repeat", "repeat_interleave"}
_CONCATS = {"cat", "stack", "_cat"}
_SORTS = {"sort", "topk", "argsort", "msort", "kthvalue", "median",
          "unique", "_unique2"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "norm", "linalg_vector_norm", "cumsum",
               "cumprod", "var", "std", "var_mean", "argmax", "argmin",
               "any", "all", "_log_softmax", "_softmax",
               "_log_softmax_backward_data", "_softmax_backward_data",
               "nll_loss_forward", "nll_loss_backward", "bincount",
               "histc"}
_BYTES = _PRODUCTS | _GATHERS | _SCATTERS | _COPIES | _CONCATS | _SORTS \
    | _REDUCTIONS
#: c10d op name -> the reference's collective kind
_COLLECTIVES = {"allreduce_": "all-reduce",
                "allreduce_coalesced_": "all-reduce",
                "allgather_": "all-gather", "_allgather_base_": "all-gather",
                "allgather_into_tensor_coalesced_": "all-gather",
                "allgather_coalesced_": "all-gather",
                "reduce_scatter_": "reduce-scatter",
                "_reduce_scatter_base_": "reduce-scatter",
                "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
                "broadcast_": "broadcast", "reduce_": "all-reduce",
                "gather_": "all-gather", "scatter_": "broadcast"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> int:
    # 2 · ∏(output dims) · (input channels per group · ∏ kernel dims); a
    # transposed convolution contracts over its output channels instead
    per_out = math.prod(w_shape[1:])
    if transposed:
        return 2 * math.prod(x_shape) * per_out
    return 2 * math.prod(out_shape) * per_out


def _flops(name: str, args, out) -> int:
    if name == "mm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2 * m * n * k
    if name == "addmm":
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2 * m * n * k
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]
    if name in ("convolution", "_convolution"):
        return _conv_flops(args[0].shape, args[1].shape, out.shape,
                           bool(args[6]))
    if name == "convolution_backward":
        # (grad_out, input, weight, bias sizes, stride, padding, dilation,
        # transposed, output_padding, groups, output_mask)
        grad_out, x, w = args[0], args[1], args[2]
        one = _conv_flops(x.shape, w.shape, grad_out.shape, bool(args[7]))
        return one * sum(bool(m) for m in args[10][:2])
    return 0


def _out_bytes(name: str, inplace: bool, args, out) -> int:
    if inplace and name in (_SCATTERS | {"copy", "_copy_from"}):
        src = list(_tensors(args[1:]))
        return _nbytes(src[-1]) if src else 0
    return sum(_nbytes(t) for t in _tensors(out))


class _OpCounter(TorchDispatchMode):
    """The dispatch mode :func:`analyze` runs a call under; its totals are
    ``flops``, ``bytes`` and ``collectives`` (kind -> bytes)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns == "c10d":
            kind = _COLLECTIVES.get(name)
            sizes = [_nbytes(t) for t in _tensors(args)]
            if kind and sizes:
                self.collectives[kind] += max(sizes)
            return out
        if ns != "aten":
            return out
        inplace = name.endswith("_")
        base = name[:-1] if inplace else name
        self.flops += _flops(base, args, out)
        if base in _BYTES:
            self.bytes += 2 * _out_bytes(base, inplace, args, out)
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and count its executed ops:
    ``{"flops", "bytes", "collectives", "collective_bytes", "result"}``
    (``hlo_cost.analyze``'s keys, plus the call's return value)."""
    with _OpCounter() as counter:
        result = fn(*args, **kwargs)
    coll = {k: float(v) for k, v in counter.collectives.items()}
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "collectives": coll, "collective_bytes": float(sum(coll.values())),
            "result": result}
