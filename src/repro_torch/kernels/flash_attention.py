"""Flash attention forward: causal / sliding-window grouped-query attention
with an online softmax, scores never stored in device memory.

Replaces the reference's Pallas kernel ``kernels/flash_attention.py::
_flash_kernel`` (launched by ``flash_attention``) with two kernels of
``csrc/attention.cu``, chosen by dtype: ``flash_fwd_wgmma`` for bfloat16
(the model's path) and ``flash_fwd_simt`` for float32.  The model's
blockwise attention branch (``models/attention.py``, sequences over
``DENSE_MAX_SEQ``) launches it for CUDA tensors, once per attention layer
of a long prefill.

It computes what the TPU kernel computes: scores ``(q·k)·scale`` in
float32 with ``scale = 1/sqrt(D)``, the mask ``kpos <= qpos`` (causal) and
``kpos > qpos - window`` (window > 0) with the reference's -1e30
sentinel, a running (max, sum, acc) in float32, ``p·v`` with p kept to
float32 precision (the TPU kernel casts v to float32) and
``acc / max(l, 1e-30)`` in q's dtype.  Query and key positions are the row
indices, both starting at 0.  KV heads are never repeated: query head h
reads KV head ``h // (H / Hk)``.

Bound: operations, ``(2·D + 2·Dv)`` FLOPs per visible (q, k) pair; 8.8e12
at the Qwen3-0.6B 32k prefill layer, 8.9 ms at the bf16 tensor-core rate.

The bfloat16 kernel runs on the tensor cores (``wgmma``): one block per
(query head, 128-row query tile, batch), two warpgroups of 64 rows, K/V
tiles copied by TMA into a two-stage ring of shared memory under mbarriers
while the products of earlier tiles run.  bf16 q·k products are exact in
float32; p·v is ``p_hi·v + p_lo·v`` with ``p_hi = bf16(p)``, ``p_lo =
bf16(p - p_hi)``, which keeps about 16 bits of p for 1.5× the reference's
FLOPs.  TMA reads the reference's ``(B, S, H, D)`` layout through the
strides (no copies), so each bf16 operand needs its last stride 1 and its
other strides and base address 16-byte aligned (:func:`tma_layout_ok`);
the wrapper raises otherwise.  The float32 kernel stays exact float32:
every product is one FFMA on the SIMT units, from register tiles of 8 rows
by 8 keys (q·k, over half the depth each) and 8 rows by 8 value columns
(p·v), with K/V tiles brought into a ring of shared memory by TMA while
earlier tiles compute.  It takes any strides: an operand TMA cannot read is
copied element by element into the same tiles.  S and T need not be
multiples of any tile.  The design is described in the source.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build

__all__ = ["flash_attention", "flash_attention_plain", "tma_layout_ok",
           "MAX_HEAD_DIM"]

NEG_INF = -1e30
BLOCK = 512            # the plain version's tiles (the TPU kernel's QB = KB)
MAX_HEAD_DIM = 256     # Gemma's head_dim; MLA's qk 192 / v 128 fit too


def _scale(d: int) -> float:
    # the reference multiplies by the weakly typed 1/sqrt(D): a float32
    return float(np.float32(1.0 / math.sqrt(d)))


def _check(q, k, v, window) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[0] != q.shape[0] or v.shape[:3] != k.shape[:3] \
            or k.shape[3] != q.shape[3] or k.shape[2] < 1 \
            or q.shape[2] % k.shape[2] or k.shape[1] < 1 \
            or not 1 <= q.shape[3] <= MAX_HEAD_DIM \
            or not 1 <= v.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want q "
                         f"(B, S, H, D), k (B, T, Hk, D), v (B, T, Hk, Dv) with "
                         f"T >= 1, H % Hk == 0 and D, Dv <= {MAX_HEAD_DIM}")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention operands must share one device")


def tma_layout_ok(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's TMA can read ``t``: its last stride 1, its
    other strides and its base address multiples of 16 bytes."""
    *outer, last = t.stride()
    size = t.element_size()
    return last == 1 and t.data_ptr() % 16 == 0 \
        and all(st > 0 and st * size % 16 == 0 for st in outer)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """The plain-torch version: the TPU kernel's arithmetic in float32,
    query and KV tiles of ``BLOCK`` rows walked in a Python loop (every KV
    tile, as on the TPU; the last tiles may be short)."""
    _check(q, k, v, window)
    b, s, h, d = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hk
    scale = _scale(d)
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, s, BLOCK):
        qblk = q[:, q0:q0 + BLOCK].float()
        qb = qblk.shape[1]
        qblk = qblk.reshape(b, qb, hk, g, d)
        qpos = torch.arange(q0, q0 + qb, device=q.device)
        m = torch.full((b, hk, g, qb), NEG_INF, device=q.device)
        l = torch.zeros((b, hk, g, qb), device=q.device)
        acc = torch.zeros((b, hk, g, qb, dv), device=q.device)
        for k0 in range(0, t, BLOCK):
            kblk = k[:, k0:k0 + BLOCK].float()
            vblk = v[:, k0:k0 + BLOCK].float()
            kpos = torch.arange(k0, k0 + kblk.shape[1], device=q.device)
            sc = torch.einsum("bqkgd,bckd->bkgqc", qblk, kblk) * scale
            ok = torch.ones((qb, kpos.numel()), dtype=torch.bool,
                            device=q.device)
            if causal:
                ok &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                ok &= kpos[None, :] > qpos[:, None] - window
            sc = torch.where(ok, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd",
                                                       p, vblk)
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)       # (b, hk, g, qb, dv)
        out[:, q0:q0 + qb] = o.permute(0, 3, 1, 2, 4).reshape(
            b, qb, h, dv).to(q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q (B, S, H, D), k (B, T, Hk, D), v (B, T, Hk, Dv) -> (B, S, H, Dv)``
    in q's dtype (float32 or bfloat16), positions ``arange(S)`` and
    ``arange(T)``.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (and count it in ``flash_attention.launches``) or raise.

    The kernel has no backward, as the reference's Pallas kernel has none
    (the reference differentiates its plain blockwise scan instead).  So on
    the card it refuses a call that autograd would record, rather than
    return an output whose gradient leaves out q, k and v; training runs
    the model's dense branch, up to ``models.attention.DENSE_MAX_SEQ``
    tokens.
    """
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward (nor has the reference's "
            "Pallas kernel), so it cannot run under autograd: call it under "
            "torch.no_grad(), or train at sequences up to DENSE_MAX_SEQ, "
            "where the model's dense attention branch runs")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and not all(tma_layout_ok(x) for x in (q, k, v)):
        raise ValueError(
            "flash_attention on bfloat16 reads q, k, v with TMA: each needs "
            "its last stride 1 and its other strides and base address "
            "16-byte aligned; got strides "
            f"{q.stride()}, {k.stride()}, {v.stride()}")
    b, s, h, d = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    dims = (ctypes.c_int64 * 7)(b, s, t, h, hk, d, dv)
    strides = (ctypes.c_int64 * 12)(*q.stride(), *k.stride(), *v.stride())
    lib = build.library("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(bf16), dims, strides, int(causal),
            int(window), _scale(d), stream), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

