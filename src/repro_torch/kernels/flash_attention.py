"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.flash_attention`` on the card.
Its plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`.

The kernel writes its output over ``ctypes``, so the output has no
autograd history.  :class:`FlashAttention` gives it one: its forward
launches the kernel (the plain version on a CPU tensor), and its
backward recomputes the plain version on the saved q, k and v and takes
its gradient, the gradient the reference gets from XLA's autodiff of the
same math (the JAX package has no backward kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

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


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: ``FlashAttention.apply(q, k, v, causal,
    window, scale)``.  The forward is one :func:`flash_attention` launch on
    a CUDA tensor (:func:`~repro_torch.kernels.ref.flash_attention_ref` on
    a CPU tensor); the backward runs ``flash_attention_ref`` again under
    autograd on the saved inputs and returns its gradients.  Under
    ``torch.utils.checkpoint`` the recomputed forward launches the kernel
    a second time."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        if q.is_cuda:
            return flash_attention(q, k, v, **ctx.opts)
        return ref.flash_attention_ref(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = ref.flash_attention_ref(*leaves, **ctx.opts)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if n else None for n in need), None, None, None)
