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
the row-major operands where they lie (no TPU (R, 1024) tiling, no
padding): ``u``, ``uniforms`` and the residual may be views with any row
stride and unit column stride, and the residual may be written into a
caller's view (``out=``), ``u`` itself included, so the stream engine's
column chunks go in and out with no copy.  It streams 16-byte vectors
over a grid sized to the card (the source's note), takes ``f`` as a
device pointer so no host sync precedes the launch, and masks ragged
heads and tails itself.
"""

from __future__ import annotations

import torch

from . import build
from .ref import gather_quant_ref

__all__ = ["gather_quant", "gather_quant_plain"]


def gather_quant_plain(u: torch.Tensor, uniforms: torch.Tensor,
                       sel: torch.Tensor, f: torch.Tensor, *,
                       out: torch.Tensor | None = None):
    """The plain-torch version of the kernel (``ref.gather_quant_ref``
    with ``sel`` broadcast over the client rows).  With ``out`` the
    residual is written into it and ``out`` is returned in its place, as
    the kernel does."""
    q, res = gather_quant_ref(u, uniforms, sel, f)
    if out is None:
        return q, res
    return q, out.copy_(res)


def _check(u, uniforms, sel, f, out):
    """Raise on operands the kernel does not take.  It runs before every
    launch, so it reads each tensor's attributes once (the stream engine
    launches once per chunk)."""
    if u.dtype != torch.float32 or uniforms.dtype != torch.float32:
        raise TypeError("gather_quant takes float32 u and uniforms")
    if sel.dtype != torch.uint8 or f.dtype != torch.float32:
        raise TypeError("gather_quant takes a uint8 sel and a float32 f")
    shape = u.shape
    if uniforms.shape != shape or len(shape) not in (1, 2) \
            or sel.shape != shape[-1:] or f.numel() != 1:
        raise ValueError(f"gather_quant shapes: u {tuple(shape)}, uniforms "
                         f"{tuple(uniforms.shape)}, sel {tuple(sel.shape)}, "
                         f"f {tuple(f.shape)}")
    dev = u.device
    if not dev == uniforms.device == sel.device == f.device:
        raise ValueError("gather_quant operands must share one device")
    cols, rows = shape[-1], shape[0] if len(shape) == 2 else 1
    su, sn = u.stride(), uniforms.stride()
    if cols > 1 and not su[-1] == sn[-1] == sel.stride()[0] == 1:
        raise ValueError("gather_quant takes u, uniforms and sel with unit "
                         "column stride")
    if out is None:
        return
    if out.dtype != torch.float32 or out.shape != shape or out.device != dev:
        raise ValueError(f"gather_quant out: float32 shaped {tuple(shape)} on "
                         f"{dev}, not {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    so = out.stride()
    if cols > 1 and so[-1] != 1:
        raise ValueError("gather_quant takes out with unit column stride")
    if rows > 1 and so[0] < cols:
        raise ValueError("gather_quant out: its rows overlap")
    # out is u itself, or lies outside the byte range of u and uniforms
    lo = out.data_ptr()
    hi = lo + 4 * (cols + (rows - 1) * so[0])
    for t, st in ((u, su), (uniforms, sn)):
        a, st = t.data_ptr(), st[0] if rows > 1 else 0
        if t is u and a == lo and st == (so[0] if rows > 1 else 0):
            continue
        if a < hi and lo < a + 4 * (cols + (rows - 1) * st) and cols:
            raise ValueError("gather_quant out: shares memory with u or the "
                             "uniforms other than as u itself")


def gather_quant(u: torch.Tensor, uniforms: torch.Tensor, sel: torch.Tensor,
                 f: torch.Tensor, *, out: torch.Tensor | None = None):
    """``(u [N, L] or [L] float32, uniforms like u, sel uint8 [L], f float32
    scalar tensor) -> (q int32, residual float32)``, both shaped like u; q
    is a fresh contiguous tensor.

    ``u``, ``uniforms``, ``sel`` and ``out`` take any row stride and must
    have unit column stride.  ``out`` (float32, shaped like u) receives the
    residual and is returned in its place; it may be ``u`` itself (same
    pointer and strides), and must otherwise lie outside the byte ranges
    of u and the uniforms (a view between the rows of u is refused too).

    CPU tensors take :func:`gather_quant_plain`; CUDA tensors launch the
    kernel (and count it in ``gather_quant.launches``) or raise.
    """
    _check(u, uniforms, sel, f, out)
    if u.device.type == "cpu":
        return gather_quant_plain(u, uniforms, sel, f, out=out)
    if u.device.type != "cuda":
        raise ValueError(f"gather_quant has no kernel for {u.device}")
    q = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    res = (torch.empty(u.shape, dtype=torch.float32, device=u.device)
           if out is None else out)
    rows, cols = u.shape if u.dim() == 2 else (1, u.shape[0])

    def row_stride(t):
        return t.stride()[0] if t.dim() == 2 else cols

    lib = build.library("quant")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        build.check(lib.repro_gather_quant(
            u.data_ptr(), row_stride(u), uniforms.data_ptr(),
            row_stride(uniforms), sel.data_ptr(), f.data_ptr(), q.data_ptr(),
            res.data_ptr(), row_stride(res), rows, cols, stream),
            "gather_quant")
    gather_quant.launches += 1
    return q, res


gather_quant.launches = 0
