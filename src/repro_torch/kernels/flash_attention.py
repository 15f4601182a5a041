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

Gradient.  The reference's Pallas kernel has no backward: the reference
differentiates its plain blockwise scan (``models/attention.py::
_blockwise_attention``).  Here, under autograd, :func:`flash_attention` is
a ``torch.autograd.Function``: its forward launches B6 with a second
output, the natural-log row statistic ``lse = m + log(l)`` (float32,
``(B, H, S)``), and its backward launches the three kernels of
``csrc/attention_bwd.cu`` (:func:`flash_attention_bwd`), which recompute
``p = exp(scale·q·k - lse)`` tile by tile (no score is stored) and write
dq, dk and dv in q's dtype.  They replace no TPU kernel.  On the CPU the
same Function runs the plain versions, :func:`flash_attention_plain` with
``return_lse=True`` and :func:`flash_attention_bwd_plain`.  The gradient is
that of :func:`flash_attention_plain` under autograd: masked scores carry
none, so a row that sees no key (``window > 0`` and row ``>= T - 1 +
window``), whose output is the mean of v, gives dv ``dout / T`` on every
key and nothing to q or k.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "tma_layout_ok", "MAX_HEAD_DIM"]

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


def _visible(qpos, kpos, causal: bool, window: int) -> torch.Tensor:
    ok = torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """The plain-torch version: the TPU kernel's arithmetic in float32,
    query and KV tiles of ``BLOCK`` rows walked in a Python loop (every KV
    tile, as on the TPU; the last tiles may be short).  With
    ``return_lse``, also each row's ``m + log(l)``, float32 ``(B, H, S)``."""
    _check(q, k, v, window)
    b, s, h, d = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hk
    scale = _scale(d)
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hk, g, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
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
            sc = torch.where(_visible(qpos, kpos, causal, window), sc, NEG_INF)
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
        if lse is not None:
            lse[..., q0:q0 + qb] = m + torch.log(l)
    return (out, lse.reshape(b, h, s)) if return_lse else out


def _dead_rows(qpos, t: int, window: int) -> torch.Tensor:
    """Rows that see no key: ``window > 0`` and ``qpos >= T - 1 + window``
    (every score masked, so p = 1 on each of the T keys and out = mean v)."""
    if window <= 0:
        return torch.zeros_like(qpos, dtype=torch.bool)
    return qpos >= t - 1 + window


def _check_bwd(q, k, v, out, lse, dout) -> None:
    b, s, h, _ = q.shape
    want = (b, s, h, v.shape[3])
    if tuple(out.shape) != want or tuple(dout.shape) != want \
            or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"flash_attention backward shapes: out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)}; want out and dout {want}, lse "
                         f"{(b, h, s)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention backward dtypes: out {out.dtype}, "
                        f"dout {dout.dtype} (want {q.dtype}), lse {lse.dtype} "
                        "(want float32)")
    if len({q.device, out.device, lse.device, dout.device}) != 1:
        raise ValueError("flash_attention backward operands must share one "
                         "device")


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: int = 0):
    """The plain-torch backward: ``(dq, dk, dv)`` in q's dtype from the
    forward's ``out`` and ``lse``, in float32 over tiles of ``BLOCK`` rows
    as the kernels walk theirs: ``Δ = rowsum(dout·out)``, then per tile pair
    ``p = exp(scale·q·k - lse)`` on visible pairs (``1 / T`` on every key of
    a row that sees none, 0 elsewhere), ``dp = dout·vᵀ``, ``ds = p·(dp - Δ)``
    on visible pairs, ``dv += pᵀ·dout``, ``dk += scale·dsᵀ·q`` and
    ``dq += scale·ds·k``, summed over each KV head's query heads."""
    _check(q, k, v, window)
    _check_bwd(q, k, v, out, lse, dout)
    b, s, h, d = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hk
    scale = _scale(d)
    dev = q.device
    qf = q.float().reshape(b, s, hk, g, d)
    dof = dout.float().reshape(b, s, hk, g, dv)
    delta = (dout.float() * out.float()).sum(-1)          # (b, s, h)
    lse_g = lse.reshape(b, hk, g, s)
    dq = torch.zeros((b, s, hk, g, d), device=dev)
    dk = torch.zeros((b, t, hk, d), device=dev)
    dvv = torch.zeros((b, t, hk, dv), device=dev)
    for q0 in range(0, s, BLOCK):
        qblk, doblk = qf[:, q0:q0 + BLOCK], dof[:, q0:q0 + BLOCK]
        qb = qblk.shape[1]
        qpos = torch.arange(q0, q0 + qb, device=dev)
        dead = _dead_rows(qpos, t, window)
        row_l = lse_g[..., q0:q0 + qb, None]               # (b, hk, g, qb, 1)
        row_d = delta[:, q0:q0 + qb].reshape(b, qb, hk, g).permute(
            0, 2, 3, 1)[..., None]
        for k0 in range(0, t, BLOCK):
            kblk = k[:, k0:k0 + BLOCK].float()
            vblk = v[:, k0:k0 + BLOCK].float()
            kpos = torch.arange(k0, k0 + kblk.shape[1], device=dev)
            ok = _visible(qpos, kpos, causal, window)
            sc = torch.einsum("bqkgd,bckd->bkgqc", qblk, kblk) * scale
            p = torch.where(ok, torch.exp(torch.where(ok, sc, 0.0) - row_l),
                            torch.where(dead[:, None], 1.0 / t, 0.0))
            dp = torch.einsum("bqkgd,bckd->bkgqc", doblk, vblk)
            ds = torch.where(ok, p * (dp - row_d), 0.0)
            dvv[:, k0:k0 + BLOCK] += torch.einsum("bkgqc,bqkgd->bckd", p, doblk)
            dk[:, k0:k0 + BLOCK] += torch.einsum("bkgqc,bqkgd->bckd", ds,
                                                 qblk) * scale
            dq[:, q0:q0 + qb] += torch.einsum("bkgqc,bckd->bqkgd", ds,
                                              kblk) * scale
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


def _launch_forward(q, k, v, causal: bool, window: int, want_lse: bool):
    """B6's forward on the card: ``out`` and, with ``want_lse``, the row
    statistic (float32 ``(B, H, S)``; else a null pointer, and the kernel
    writes nothing more than it did without one)."""
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
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if want_lse else None
    if out.numel() == 0:
        return out, lse
    dims = (ctypes.c_int64 * 7)(b, s, t, h, hk, d, dv)
    strides = (ctypes.c_int64 * 12)(*q.stride(), *k.stride(), *v.stride())
    lib = build.library("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), int(bf16), dims,
            strides, int(causal), int(window), _scale(d), stream),
            "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, need=(True, True, True)):
    """``(dq, dk, dv)`` in q's dtype from the forward's ``out`` and ``lse``
    and the output's gradient ``dout`` (any strides).  CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch the kernels of
    ``csrc/attention_bwd.cu`` (``Δ = rowsum(dout·out)``, then dk and dv,
    then dq; each reads q, k, v, out and dout through their strides, so
    nothing is copied) and count one in
    ``flash_attention.backward_launches``, or raise.  ``need`` names the
    gradients wanted (q, k, v): dq's kernel is left out when q's is not,
    dk and dv's when neither is; a gradient left out is None."""
    _check(q, k, v, window)
    _check_bwd(q, k, v, out, lse, dout)
    if q.device.type == "cpu":
        grads = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                          causal=causal, window=window)
        return tuple(g if n else None for g, n in zip(grads, need))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    b, s, h, d = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    want_q, want_kv = bool(need[0]), bool(need[1] or need[2])
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) \
        if want_q else None
    dk = torch.empty((b, t, hk, d), dtype=q.dtype, device=q.device) \
        if want_kv else None
    dvv = torch.empty((b, t, hk, dv), dtype=q.dtype, device=q.device) \
        if want_kv else None
    if q.numel() == 0 or k.numel() == 0 or not (want_q or want_kv):
        for x in (dq, dk, dvv):
            if x is not None:
                x.zero_()
        return dq, (dk if need[1] else None), (dvv if need[2] else None)
    if not lse.is_contiguous():
        raise ValueError("flash_attention backward reads lse contiguous, as "
                         "the forward writes it")
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dims = (ctypes.c_int64 * 7)(b, s, t, h, hk, d, dv)
    strides = (ctypes.c_int64 * 20)(*q.stride(), *k.stride(), *v.stride(),
                                    *out.stride(), *dout.stride())
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = build.library("attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), ptr(dq),
            ptr(dk), ptr(dvv), int(q.dtype == torch.bfloat16), dims, strides,
            int(causal), int(window), _scale(d), stream),
            "flash_attention backward")
    flash_attention.backward_launches += 1
    return dq, (dk if need[1] else None), (dvv if need[2] else None)


class _FlashFunction(torch.autograd.Function):
    """B6 under autograd: the forward keeps q, k, v, out and the row
    statistic; the backward recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             window=window, return_lse=True)
        else:
            out, lse = _launch_forward(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window,
            need=ctx.needs_input_grad[:3])
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q (B, S, H, D), k (B, T, Hk, D), v (B, T, Hk, Dv) -> (B, S, H, Dv)``
    in q's dtype (float32 or bfloat16), positions ``arange(S)`` and
    ``arange(T)``.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (and count it in ``flash_attention.launches``) or raise.  When
    autograd records (grad mode on and q, k or v requiring a gradient) the
    call goes through :class:`_FlashFunction`: the forward also writes the
    row statistic, and the backward runs :func:`flash_attention_bwd` (on
    the card its kernels, counted in ``flash_attention.backward_launches``;
    on the CPU the plain versions).
    """
    _check(q, k, v, window)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashFunction.apply(q, k, v, bool(causal), int(window))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _launch_forward(q, k, v, causal, window, False)[0]


flash_attention.launches = 0
flash_attention.backward_launches = 0
