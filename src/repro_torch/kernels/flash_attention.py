"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.flash_attention`` on the card.
Its plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset
MAX_HEAD_DIM = 192   # the largest padded head dim the kernel is built for

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B,H,Sq,D), k/v: (B,H,Sk,D) bf16 CUDA tensors -> (B,H,Sq,D) bf16."""
    global launches
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be a bf16 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in [1, {MAX_HEAD_DIM}]")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    q, k, v = (build.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if scale is None:
        scale = d ** -0.5
    build.launch("flash_attention", "flash_attention_bf16", _ARGS, q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, sq, sk, d, float(scale), int(causal),
                 -1 if window is None else int(window))
    launches += 1
    return out
