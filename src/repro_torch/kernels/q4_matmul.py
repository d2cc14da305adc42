"""Wrapper of the Hopper fused-unpack Q4_0 matmul (``csrc/q4_matmul.cu``).

Replaces ``repro.kernels.q4_matmul.q4_matmul`` on the card.  Its plain
version is :func:`repro_torch.kernels.ref.q4_matmul_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QK8_0
from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def q4_matmul(x: torch.Tensor, qs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(w).T.  x: (M,K); qs: (N,K/2) uint8 packed codes
    (even element in the low nibble); d: (N,K/32) fp16 scales
    (``Q4_0Tensor.d``).  Returns (M, N) f32.  K % 32 == 0."""
    global launches
    m, kdim = x.shape
    n = qs.shape[0]
    if not (x.is_cuda and qs.is_cuda and d.is_cuda):
        raise ValueError("q4_matmul: all operands must be CUDA tensors")
    if qs.dtype != torch.uint8 or qs.shape != (n, kdim // 2) or kdim % QK8_0:
        raise ValueError(f"q4_matmul: qs {qs.dtype}{tuple(qs.shape)} does not "
                         f"match x{tuple(x.shape)} (K % 32 == 0 required)")
    if d.shape != (n, kdim // QK8_0) or d.dtype != torch.float16:
        raise ValueError(f"q4_matmul: d {d.dtype}{tuple(d.shape)}, "
                         f"expected float16{(n, kdim // QK8_0)}")
    x = build.aligned16(x.to(torch.bfloat16))
    qs = build.aligned16(qs)
    d = build.aligned16(d)        # the tile path copies aligned scale words
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    build.launch("q4_matmul", "q4_matmul_bf16", _ARGS, x.device, x.data_ptr(),
                 qs.data_ptr(), d.data_ptr(), y.data_ptr(), m, n, kdim)
    launches += 1
    return y
