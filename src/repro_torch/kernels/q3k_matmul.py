"""Wrapper of the Hopper fused-unpack Q3_K matmul (``csrc/q3k_matmul.cu``).

Replaces ``repro.kernels.q3k_matmul.q3k_matmul`` on the card;
:func:`q3k_matmul_experts` is one launch of it over the experts of an MoE
layer (the reference's ``vmap`` of it).  Its
plain version is :func:`repro_torch.kernels.ref.q3k_matmul_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QK_K
from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGS_EXPERTS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])


def _check_fields(name: str, lead: tuple, n: int, kdim: int, ql, qh, scales, d) -> None:
    want = {"ql": (*lead, n, kdim // 4), "qh": (*lead, n, kdim // 8),
            "scales": (*lead, n, kdim // QK_K, 12), "d": (*lead, n, kdim // QK_K)}
    for field, t in zip(want, (ql, qh, scales, d)):
        if tuple(t.shape) != want[field]:
            raise ValueError(f"{name}: {field} shape {tuple(t.shape)}, "
                             f"expected {want[field]}")
    for field, t, dt in (("ql", ql, torch.uint8), ("qh", qh, torch.uint8),
                         ("scales", scales, torch.uint8), ("d", d, torch.float16)):
        if t.dtype != dt:
            raise ValueError(f"{name}: {field} must be {dt}, got {t.dtype}")


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
    _check_fields("q3k_matmul", (), n, kdim, ql, qh, scales, d)
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


def q3k_matmul_experts(x: torch.Tensor, ql: torch.Tensor, qh: torch.Tensor,
                       scales: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ dequant(w[e]).T for every expert e in one launch, with
    the fields of a ``Q3KTensor`` whose leading axis is the expert.  x:
    (E,M,K); ql: (E,N,K/4); qh: (E,N,K/8); scales: (E,N,K/256,12); d:
    (E,N,K/256).  Returns (E, M, N) f32.  K % 256 == 0.  Each expert's
    scale bytes and d start 16-byte aligned, as the two-dimensional entry's
    do (copied into padded buffers where their sizes would not keep that)."""
    global launches
    e, m, kdim = x.shape
    n = ql.shape[1]
    if not all(t.is_cuda for t in (x, ql, qh, scales, d)):
        raise ValueError("q3k_matmul_experts: all operands must be CUDA tensors")
    if kdim % QK_K:
        raise ValueError(f"q3k_matmul_experts: K={kdim} is not a multiple of {QK_K}")
    _check_fields("q3k_matmul_experts", (e,), n, kdim, ql, qh, scales, d)
    x = build.aligned16(x.to(torch.bfloat16))
    ql, qh = build.aligned16(ql), build.aligned16(qh)
    scales, ssc = build.expert_rows(scales, 16)
    d, sd = build.expert_rows(d, 8)
    y = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if e == 0 or m == 0 or n == 0:
        return y
    build.launch("q3k_matmul", "q3k_matmul_bf16_experts", _ARGS_EXPERTS, x.device,
                 x.data_ptr(), ql.data_ptr(), qh.data_ptr(), scales.data_ptr(),
                 d.data_ptr(), y.data_ptr(), e, m, n, kdim, m * kdim, n * kdim // 4,
                 n * kdim // 8, ssc, sd, m * n)
    launches += 1
    return y
