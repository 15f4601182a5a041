"""Fused consensus select + stochastic quantize + residual: the FediAC
phase-2 client round for all N clients in one pass.

Replaces the reference's Pallas kernel ``kernels/gather_quant.py::
_gather_quant_kernel`` (launched by ``gather_quant``), which the fused
``use_pallas`` round calls once per client through ``vmap``.  Here one
launch of ``csrc/quant.cu::gather_quant_kernel`` covers the whole
``[N, L]`` stack.

Per coordinate, with ``sel`` the round plan's shared 0/1 mask::

    q   = sel ? floor(f*u) + [uni < frac(f*u)] : 0      (int32, Eq. 1)
    res = u - (sel ? q/f : 0)                          (float32)

Bound: device-memory bytes.  Each element reads u and its uniform and
writes q and the residual, 16 B, and ``sel`` is read once: 16·N·L + L
bytes, ~0.15 ms at N=32, L=1e6 on an H100 (3.35 TB/s).  The design reads
the flat row-major stack directly (no TPU (R, 1024) tiling, no padding),
takes ``f`` as a device pointer so no host sync precedes the launch, and
masks the ragged tail in the grid-stride loop.
"""

from __future__ import annotations

import torch

from . import build
from .ref import gather_quant_ref

__all__ = ["gather_quant", "gather_quant_plain"]


def gather_quant_plain(u: torch.Tensor, uniforms: torch.Tensor,
                       sel: torch.Tensor, f: torch.Tensor):
    """The plain-torch version of the kernel (``ref.gather_quant_ref``
    with ``sel`` broadcast over the client rows)."""
    return gather_quant_ref(u, uniforms, sel, f)


def _check(u, uniforms, sel, f):
    if u.dtype != torch.float32 or uniforms.dtype != torch.float32:
        raise TypeError("gather_quant takes float32 u and uniforms")
    if sel.dtype != torch.uint8 or f.dtype != torch.float32:
        raise TypeError("gather_quant takes a uint8 sel and a float32 f")
    if u.shape != uniforms.shape or u.dim() not in (1, 2) \
            or sel.shape != u.shape[-1:] or f.numel() != 1:
        raise ValueError(f"gather_quant shapes: u {tuple(u.shape)}, uniforms "
                         f"{tuple(uniforms.shape)}, sel {tuple(sel.shape)}, "
                         f"f {tuple(f.shape)}")
    if len({t.device for t in (u, uniforms, sel, f)}) != 1:
        raise ValueError("gather_quant operands must share one device")


def gather_quant(u: torch.Tensor, uniforms: torch.Tensor, sel: torch.Tensor,
                 f: torch.Tensor):
    """``(u [N, L] or [L] float32, uniforms like u, sel uint8 [L], f float32
    scalar tensor) -> (q int32, residual float32)``, both shaped like u.

    CPU tensors take :func:`gather_quant_plain`; CUDA tensors launch the
    kernel (and count it in ``gather_quant.launches``) or raise.
    """
    _check(u, uniforms, sel, f)
    if u.device.type == "cpu":
        return gather_quant_plain(u, uniforms, sel, f)
    if u.device.type != "cuda":
        raise ValueError(f"gather_quant has no kernel for {u.device}")
    u, uniforms, sel, f = (t.contiguous() for t in (u, uniforms, sel, f))
    q = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    res = torch.empty_like(u)
    rows = u.shape[0] if u.dim() == 2 else 1
    lib = build.library("quant")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        build.check(lib.repro_gather_quant(
            u.data_ptr(), uniforms.data_ptr(), sel.data_ptr(), f.data_ptr(),
            q.data_ptr(), res.data_ptr(), rows, u.shape[-1], stream),
            "gather_quant")
    gather_quant.launches += 1
    return q, res


gather_quant.launches = 0
