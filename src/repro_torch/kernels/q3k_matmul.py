"""Wrapper of the Hopper fused-unpack Q3_K matmul (``csrc/q3k_matmul.cu``).

Replaces ``repro.kernels.q3k_matmul.q3k_matmul`` on the card.  Its
plain version is :func:`repro_torch.kernels.ref.q3k_matmul_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QK_K
from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def q3k_matmul(x: torch.Tensor, ql: torch.Tensor, qh: torch.Tensor,
               scales: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(w).T with the fields of a ``Q3KTensor``.  x: (M,K);
    ql: (N,K/4) u8; qh: (N,K/8) u8; scales: (N,K/256,12) u8 packed 6-bit
    codes (unpacked inside the kernel); d: (N,K/256) fp16.  Returns (M,N)
    f32.  K % 256 == 0."""
    global launches
    m, kdim = x.shape
    n = ql.shape[0]
    ops = (x, ql, qh, scales, d)
    if not all(t.is_cuda for t in ops):
        raise ValueError("q3k_matmul: all operands must be CUDA tensors")
    if kdim % QK_K:
        raise ValueError(f"q3k_matmul: K={kdim} is not a multiple of {QK_K}")
    want = {"ql": (n, kdim // 4), "qh": (n, kdim // 8),
            "scales": (n, kdim // QK_K, 12), "d": (n, kdim // QK_K)}
    for name, t in zip(want, (ql, qh, scales, d)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"q3k_matmul: {name} shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    for name, t, dt in (("ql", ql, torch.uint8), ("qh", qh, torch.uint8),
                        ("scales", scales, torch.uint8), ("d", d, torch.float16)):
        if t.dtype != dt:
            raise ValueError(f"q3k_matmul: {name} must be {dt}, got {t.dtype}")
    x = build.aligned16(x.to(torch.bfloat16))
    ql, qh, scales, d = (build.aligned16(t) for t in (ql, qh, scales, d))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    build.launch("q3k_matmul", "q3k_matmul_bf16", _ARGS, x.device,
                 x.data_ptr(), ql.data_ptr(), qh.data_ptr(), scales.data_ptr(),
                 d.data_ptr(), y.data_ptr(), m, n, kdim)
    launches += 1
    return y
