"""Wrappers of the Hopper Q8_0 matmuls: the fused-dequant weight-only
kernel (``csrc/q8_matmul.cu``) and the integer w8a8 kernel
(``csrc/q8_matmul_w8a8.cu``).

Replace ``repro.kernels.q8_matmul.q8_matmul`` and ``q8_matmul_w8a8`` on
the card; :func:`q8_matmul_experts` is one launch of the first over the
experts of an MoE layer (the reference's ``vmap`` of it).  Their plain
versions are :func:`repro_torch.kernels.ref.q8_matmul_ref` and
:func:`~repro_torch.kernels.ref.q8_matmul_w8a8_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QK8_0
from repro_torch.kernels import build

launches = 0          # q8_matmul launches since the last reset
launches_w8a8 = 0     # q8_matmul_w8a8 launches since the last reset

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGS_EXPERTS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
_ARGS_W8A8 = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    ws = build.aligned16(ws)      # the tile path copies aligned scale words
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    build.launch("q8_matmul", "q8_matmul_bf16", _ARGS, x.device, x.data_ptr(),
                 wq.data_ptr(), ws.data_ptr(), y.data_ptr(), m, n, kdim)
    launches += 1
    return y


def q8_matmul_experts(x: torch.Tensor, wq: torch.Tensor,
                      ws: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ dequant(w[e]).T for every expert e in one launch.
    x: (E,M,K); wq: (E,N,K) int8; ws: (E,N,K/32) fp16.  Returns (E, M, N)
    f32.  K % 32 == 0.  Each expert's scales start 16-byte aligned, as the
    two-dimensional entry's do (copied into a padded buffer when N * K / 32
    is not a multiple of 8)."""
    global launches
    e, m, kdim = x.shape
    n = wq.shape[1]
    if not (x.is_cuda and wq.is_cuda and ws.is_cuda):
        raise ValueError("q8_matmul_experts: all operands must be CUDA tensors")
    if wq.dtype != torch.int8 or wq.shape != (e, n, kdim) or kdim % QK8_0:
        raise ValueError(f"q8_matmul_experts: wq {wq.dtype}{tuple(wq.shape)} does not "
                         f"match x{tuple(x.shape)} (K % 32 == 0 required)")
    if ws.shape != (e, n, kdim // QK8_0) or ws.dtype != torch.float16:
        raise ValueError(f"q8_matmul_experts: ws {ws.dtype}{tuple(ws.shape)}, "
                         f"expected float16{(e, n, kdim // QK8_0)}")
    x = build.aligned16(x.to(torch.bfloat16))
    wq = build.aligned16(wq)
    ws, sd = build.expert_rows(ws, 8)
    y = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if e == 0 or m == 0 or n == 0:
        return y
    build.launch("q8_matmul", "q8_matmul_bf16_experts", _ARGS_EXPERTS, x.device,
                 x.data_ptr(), wq.data_ptr(), ws.data_ptr(), y.data_ptr(), e, m, n, kdim,
                 m * kdim, n * kdim, sd, m * n)
    launches += 1
    return y


def q8_matmul_w8a8(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                   ws: torch.Tensor) -> torch.Tensor:
    """Integer-path matmul.  xq: (M,K) int8 and xs: (M,K/32) f32, the Q8_0
    activations; wq: (N,K) int8 and ws: (N,K/32) fp16 (``Q8_0Tensor``'s
    fields).  Returns (M, N) f32.  K % 32 == 0."""
    global launches_w8a8
    m, kdim = xq.shape
    n = wq.shape[0]
    nb = kdim // QK8_0
    if not all(t.is_cuda for t in (xq, xs, wq, ws)):
        raise ValueError("q8_matmul_w8a8: all operands must be CUDA tensors")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 \
            or wq.shape != (n, kdim) or kdim % QK8_0:
        raise ValueError(f"q8_matmul_w8a8: xq {xq.dtype}{tuple(xq.shape)} and wq "
                         f"{wq.dtype}{tuple(wq.shape)} must be int8 with one K, "
                         "K % 32 == 0")
    if xs.shape != (m, nb) or xs.dtype != torch.float32 \
            or ws.shape != (n, nb) or ws.dtype != torch.float16:
        raise ValueError(f"q8_matmul_w8a8: scales xs {xs.dtype}{tuple(xs.shape)}, "
                         f"ws {ws.dtype}{tuple(ws.shape)}; expected float32"
                         f"{(m, nb)} and float16{(n, nb)}")
    xq, wq = build.aligned16(xq), build.aligned16(wq)
    xs, ws = xs.contiguous(), ws.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m == 0 or n == 0:
        return y
    build.launch("q8_matmul_w8a8", "q8_matmul_w8a8_s8", _ARGS_W8A8, xq.device,
                 xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                 y.data_ptr(), m, n, kdim)
    launches_w8a8 += 1
    return y
