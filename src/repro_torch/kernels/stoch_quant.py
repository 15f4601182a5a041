"""Unbiased stochastic rounding of ``f*u`` to int32 (paper Eq. 1).

Replaces the reference's Pallas kernel ``kernels/stoch_quant.py::
_quant_kernel`` (launched by ``stoch_quant``), which the fused
``use_pallas`` round reaches at ``vote_chunk > 1`` through
``ops.quantize_flat``, once per client.  Here one launch of
``csrc/quant.cu::stoch_quant_kernel`` quantizes the whole ``[N, C·g]``
stack of gathered consensus chunks.

Bound: device-memory bytes, 12 B per element (u and the uniform in, q
out).  Flat row-major operands, ``f`` read from device memory, a
grid-stride loop that masks the ragged tail.
"""

from __future__ import annotations

import torch

from . import build
from .ref import stoch_quant_ref

__all__ = ["stoch_quant", "stoch_quant_plain"]


def stoch_quant_plain(u: torch.Tensor, uniforms: torch.Tensor,
                      f: torch.Tensor) -> torch.Tensor:
    """The plain-torch version of the kernel (``ref.stoch_quant_ref``)."""
    return stoch_quant_ref(u, uniforms, f)


def stoch_quant(u: torch.Tensor, uniforms: torch.Tensor,
                f: torch.Tensor) -> torch.Tensor:
    """``(u float32, uniforms like u, f float32 scalar tensor) -> q int32``
    shaped like u.

    CPU tensors take :func:`stoch_quant_plain`; CUDA tensors launch the
    kernel (and count it in ``stoch_quant.launches``) or raise.
    """
    if u.dtype != torch.float32 or uniforms.dtype != torch.float32 \
            or f.dtype != torch.float32:
        raise TypeError("stoch_quant takes float32 u, uniforms and f")
    if u.shape != uniforms.shape or f.numel() != 1:
        raise ValueError(f"stoch_quant shapes: u {tuple(u.shape)}, uniforms "
                         f"{tuple(uniforms.shape)}, f {tuple(f.shape)}")
    if len({t.device for t in (u, uniforms, f)}) != 1:
        raise ValueError("stoch_quant operands must share one device")
    if u.device.type == "cpu":
        return stoch_quant_plain(u, uniforms, f)
    if u.device.type != "cuda":
        raise ValueError(f"stoch_quant has no kernel for {u.device}")
    u, uniforms, f = (t.contiguous() for t in (u, uniforms, f))
    q = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    lib = build.library("quant")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        build.check(lib.repro_stoch_quant(
            u.data_ptr(), uniforms.data_ptr(), f.data_ptr(), q.data_ptr(),
            u.numel(), stream), "stoch_quant")
    stoch_quant.launches += 1
    return q


stoch_quant.launches = 0
