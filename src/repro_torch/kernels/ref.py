"""Plain PyTorch versions of the kernels on the main path.

Each computes exactly what its kernel claims (the same dequantization,
bf16 rounding and f32 accumulation), mirroring ``repro.kernels.ref``.
They are the CPU path of :mod:`repro_torch.kernels.ops` and the oracle
the CUDA kernels are held to on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.quant import (QK8_0, Q3K_SUB, Q3KTensor, Q4_0Tensor,
                                    Q8_0Tensor)


def _bf16_product(x: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation: an f32 product of bf16 values
    (exact products, f32 sums)."""
    return torch.matmul(x.to(torch.bfloat16).float(), wd.float().t())


def q8_matmul_ref(x: torch.Tensor, w: Q8_0Tensor) -> torch.Tensor:
    """y = x @ dequant(w).T with the weight rounded to bf16; f32 out."""
    return _bf16_product(x, quant.dequantize_q8_0(w, torch.bfloat16))


def q8_matmul_w8a8_ref(xq: torch.Tensor, xs: torch.Tensor,
                       w: Q8_0Tensor) -> torch.Tensor:
    """Integer-path matmul (the paper's OP_SML8/OP_AD24 analogue).

    xq: (M, K) int8; xs: (M, K/32) f32 block scales; w: Q8_0 (N, K).
    y[m, n] = sum_b (xq[m, b, :] . wq[n, b, :]) * xs[m, b] * ws[n, b],
    each block dot an exact integer (|dot| <= 32 * 128^2 < 2^24, so an f32
    product of the int8 values computes it exactly, on the CPU and on the
    card alike), scaled as ``(dot * xs) * ws`` and summed over the blocks
    in f32."""
    m, k = xq.shape
    n = w.qs.shape[0]
    nb = k // QK8_0
    a = xq.reshape(m, nb, QK8_0).float().transpose(0, 1)     # (nb, M, 32)
    b = w.qs.reshape(n, nb, QK8_0).float().transpose(0, 1)   # (nb, N, 32)
    ints = torch.bmm(a, b.transpose(1, 2))                   # (nb, M, N)
    scaled = ints * xs.float().t()[:, :, None] * w.d.float().t()[:, None, :]
    return scaled.sum(dim=0)


def q4_matmul_ref(x: torch.Tensor, w: Q4_0Tensor) -> torch.Tensor:
    """y = x @ dequant(w).T with the weight rounded to bf16; f32 out."""
    return _bf16_product(x, quant.dequantize_q4_0(w, torch.bfloat16))


def q3k_matmul_ref(x: torch.Tensor, w: Q3KTensor) -> torch.Tensor:
    return _bf16_product(x, quant.dequantize_q3_k(w, torch.bfloat16))


def q3k_matmul_w8a8_ref(xq: torch.Tensor, xs: torch.Tensor,
                        w: Q3KTensor) -> torch.Tensor:
    """Integer-path Q3_K x Q8-activation matmul (no kernel, no model path,
    as in the reference).

    xq: (M, K) int8; xs: (M, K/16) f32 per-sub-block activation scales
    (Q8_K activations, scales broadcast to 16-granularity); w: Q3_K (N, K).
    Each sub-block dot is an exact integer (|dot| <= 16 * 127 * 4), so an
    f32 product of the int8 values computes it exactly; it is scaled as
    ``(dot * xs) * eff`` and summed over the sub-blocks in f32."""
    m, k = xq.shape
    qw = quant.unpack_q3(w.ql, w.qh)                          # (N, K) in [-4, 3]
    n = qw.shape[0]
    eff = quant.q3k_effective_scales(w)                       # (N, K/16)
    nsb = k // Q3K_SUB
    a = xq.reshape(m, nsb, Q3K_SUB).float().transpose(0, 1)   # (nsb, M, 16)
    b = qw.reshape(n, nsb, Q3K_SUB).float().transpose(0, 1)   # (nsb, N, 16)
    ints = torch.bmm(a, b.transpose(1, 2))                    # (nsb, M, N)
    scaled = ints * xs.float().t()[:, :, None] * eff.t()[:, None, :]
    return scaled.sum(dim=0)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Softmax attention in f32. q: (B,H,Sq,D); k, v: (B,H,Sk,D).

    Causal mask bottom-right aligned (``kpos <= qpos + Sk - Sq``);
    ``window`` keeps keys in ``(qpos - window, qpos]``; rows with no
    unmasked key give 0.  Output in q's dtype."""
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
