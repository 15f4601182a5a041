"""The port's meshes: a description of the reference's device mesh.

The reference builds jax meshes of TPU v5e chips: one pod = 16 x 16 =
256 chips ``(data, model)``, two pods = 2 x 16 x 16 = 512 chips ``(pod,
data, model)``.  Here a mesh is a small description: its axis names, its
shape, and the ``torch.distributed`` group whose ranks are its clients
(``None``: the default group).  Each rank is one client (replica mode) or
one pod (pod mode), so on one card the ``model`` axis is 1 and the client
axes together count the group's ranks.

:func:`make_production_mesh` gives the reference's production shapes for
the partition rules (:mod:`repro_torch.models.shardings`) only;
``make_train_step`` refuses them on one card.

The hardware figures are the NVIDIA H100 SXM's (its data sheet), the
figures PERF.md's bounds use; the reference's v5e figures are a TPU's and
are not carried over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist

__all__ = ["Mesh", "make_production_mesh", "make_test_mesh", "DEVICE",
           "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32", "HBM_BW"]


@dataclass(frozen=True)
class Mesh:
    """``axis_names`` and ``shape`` (axis name -> size, in axis order), as
    on a jax mesh, and ``group``, the process group of the client axes."""

    axis_names: tuple
    shape: dict
    group: object = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def _mesh(shape: tuple, axes: tuple, group=None) -> Mesh:
    return Mesh(tuple(axes), dict(zip(axes, shape)), group)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shape: (16, 16) ``(data, model)``, or
    (2, 16, 16) ``(pod, data, model)``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False, group=None) -> Mesh:
    """The one-card mesh over the ranks of ``group`` (the default group;
    one rank when ``torch.distributed`` is not initialized): ``data`` =
    the world size and ``model`` = 1, or with ``multi_pod`` one pod per
    rank, ``(pod, data, model)`` = (world size, 1, 1)."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if multi_pod:
        return _mesh((world, 1, 1), ("pod", "data", "model"), group)
    return _mesh((world, 1), ("data", "model"), group)


# NVIDIA H100 SXM (80 GB HBM3) figures, per card
DEVICE = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # B/s
