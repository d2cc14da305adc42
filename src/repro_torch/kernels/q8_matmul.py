"""Wrapper of the Hopper fused-dequant Q8_0 matmul (``csrc/q8_matmul.cu``).

Replaces ``repro.kernels.q8_matmul.q8_matmul`` on the card.  Its plain
version is :func:`repro_torch.kernels.ref.q8_matmul_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QK8_0
from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def q8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(w).T.  x: (M,K); wq: (N,K) int8; ws: (N,K/32) fp16
    scales (``Q8_0Tensor.d``).  Returns (M, N) f32.  K % 32 == 0."""
    global launches
    m, kdim = x.shape
    n = wq.shape[0]
    if not (x.is_cuda and wq.is_cuda and ws.is_cuda):
        raise ValueError("q8_matmul: all operands must be CUDA tensors")
    if wq.dtype != torch.int8 or wq.shape != (n, kdim) or kdim % QK8_0:
        raise ValueError(f"q8_matmul: wq {wq.dtype}{tuple(wq.shape)} does not "
                         f"match x{tuple(x.shape)} (K % 32 == 0 required)")
    if ws.shape != (n, kdim // QK8_0) or ws.dtype != torch.float16:
        raise ValueError(f"q8_matmul: ws {ws.dtype}{tuple(ws.shape)}, "
                         f"expected float16{(n, kdim // QK8_0)}")
    x = build.aligned16(x.to(torch.bfloat16))
    wq = build.aligned16(wq)
    ws = ws.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    lib, fn = build.entry("q8_matmul", "q8_matmul_bf16", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), wq.data_ptr(), ws.data_ptr(), y.data_ptr(),
                  m, n, kdim, stream)
    build.check(lib, "q8_matmul", code)
    launches += 1
    return y
