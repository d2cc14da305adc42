"""Quantized linear layers: init, post-training quantization, apply.

A :class:`Linear` holds a weight stored output-major ``(N, K)`` (a dense
tensor or a ``Q8_0Tensor``/``Q4_0Tensor``/``Q3KTensor`` after
quantization), an optional bias, and the tensor *role* the offload
policy keys on — the counterpart of ``repro.core.qlinear.Linear``.

The matmul recorder is the reference's too: a callback installed with
:func:`set_recorder` sees every dot-product site ``(name, role, m, n,
k, count, act_act)`` that ``apply_linear`` and the attention sites
report (the basis of the paper's Table I accounting,
:mod:`repro_torch.core.accounting`); with none installed it costs one
``is None`` test per call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import quant
from repro_torch.core.policy import OffloadPolicy
from repro_torch.core.quant import QTYPES
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops

_RECORDER = None


def set_recorder(fn) -> None:
    """Install ``fn(**site)`` as the matmul recorder (``None`` removes it)."""
    global _RECORDER
    _RECORDER = fn


def record_matmul(name: str, role: str, m: int, n: int, k: int,
                  count: int = 1, act_act: bool = False) -> None:
    if _RECORDER is not None:
        _RECORDER(name=name, role=role, m=m, n=n, k=k, count=count,
                  act_act=act_act)


@dataclasses.dataclass
class Linear:
    w: Any                      # (N, K) tensor | Q8_0Tensor | Q3KTensor
    b: Any = None               # (N,) tensor | None
    role: str = "proj_misc"


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, *,
                role: str, bias: bool = False, dtype=torch.bfloat16,
                scale: float | None = None) -> Linear:
    """Normal(0, std) weight drawn in f32 on ``gen``'s device, then cast."""
    std = scale if scale is not None else in_dim ** -0.5
    w = (torch.randn((out_dim, in_dim), generator=gen, device=gen.device,
                     dtype=torch.float32).mul_(std)).to(dtype)
    b = torch.zeros((out_dim,), dtype=dtype, device=gen.device) if bias else None
    return Linear(w=w, b=b, role=role)


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x.astype(w.dtype) @ w.T`` accumulated in f32 and cast once to
    ``x``'s dtype, as the reference's ``dot_general`` with
    ``preferred_element_type=f32`` does.

    On the card a bf16 x bf16 product goes to cuBLAS, which accumulates
    in f32 and rounds once.  An f16 weight (the convs under the q8_0/q3_k
    presets) takes cuBLAS with an f32 output (``out_dtype``): a plain f16
    product would round to f16 before the cast to bf16 (twice) and turn
    anything above 65504 into inf.  f32 weights (``time_embed``) and
    everything on the CPU run as an f32 product of the cast operands."""
    if x.is_cuda and x.dtype == w.dtype:
        return torch.matmul(x, w.t())
    if x.is_cuda and w.dtype in (torch.float16, torch.bfloat16):
        x2 = x.reshape(-1, x.shape[-1]).to(w.dtype)
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0]).to(x.dtype)
    return f32_product(x, w).to(x.dtype)


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x.to(w.dtype)`` times ``w`` transposed, both cast to f32, in f32:
    w (N, K) against x (..., K), or an expert stack (E, N, K) against x
    (E, R, K).  Where autograd takes ``w``'s gradient it goes through
    :class:`_F32Product`, which keeps ``w`` itself for the backward and
    not its f32 copy."""
    if torch.is_grad_enabled() and w.requires_grad:
        return _F32Product.apply(x, w)
    xf, wf = x.to(w.dtype).float(), w.float()
    if w.dim() == 3:
        return torch.bmm(xf, wf.transpose(1, 2))
    return torch.matmul(xf, wf.t())


class _F32Product(torch.autograd.Function):
    """:func:`f32_product` saving ``x`` and ``w`` as they are and casting
    them again in the backward: autograd through the casts would keep
    ``w``'s f32 copy alive until the backward (in the sharded train step
    a gathered weight, twice its bytes, where the step's saved-tensor
    hooks see only the gathered storage).  Forward and gradients are the
    ops autograd runs: x folded to 2-D and one mm, as ``torch.matmul``
    folds when the weight requires grad (bmm for an expert stack), mm's
    and bmm's backward formulas, then each cast's."""

    @staticmethod
    def forward(fctx, x, w):
        fctx.save_for_backward(x, w)
        xf, wf = x.to(w.dtype).float(), w.float()
        if w.dim() == 3:
            return torch.bmm(xf, wf.transpose(1, 2))
        return xf.reshape(-1, xf.shape[-1]).mm(wf.t()).reshape(*xf.shape[:-1], wf.shape[0])

    @staticmethod
    def backward(fctx, gy):
        x, w = fctx.saved_tensors
        xf, wf = x.to(w.dtype).float(), w.float()
        gx = gw = None
        if w.dim() == 3:
            if fctx.needs_input_grad[0]:
                gx = gy.bmm(wf)
            if fctx.needs_input_grad[1]:
                gw = xf.transpose(1, 2).bmm(gy).transpose(1, 2)
        else:
            g2 = gy.reshape(-1, gy.shape[-1])
            if fctx.needs_input_grad[0]:
                gx = g2.mm(wf).reshape(xf.shape)
            if fctx.needs_input_grad[1]:
                gw = g2.t().mm(xf.reshape(-1, xf.shape[-1]))
        if gx is not None:
            gx = gx.to(w.dtype).to(x.dtype)
        if gw is not None:
            gw = gw.to(w.dtype)
        return gx, gw


def apply_linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    w = p.w
    if _RECORDER is not None:
        m = 1
        for d in x.shape[:-1]:
            m *= int(d)
        record_matmul("linear", p.role, m, int(w.shape[-2]), int(w.shape[-1]))
    if isinstance(w, QTYPES):
        y = ops.quantized_matmul(x, w)
    else:
        y = dense_matmul(x, w)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


def quantize_linear(p: Linear, policy: OffloadPolicy) -> Linear:
    """Post-training quantization of one linear layer.  Roles whose K is
    not a multiple of the format's block stay dense (GGML keeps such
    tensors in F16 as well).  A weight with a leading expert axis is
    quantized one expert at a time (the same bytes: blocks run along K),
    so that the f32 temporaries are one expert's; so is a weight of more
    than ``_CHUNK`` elements, ``_CHUNK // K`` rows at a time (a 152064-row
    head or embedding)."""
    fmt = policy.format_for(p.role)
    w = p.w
    if isinstance(w, QTYPES):
        return p
    if not fmt.startswith("q"):
        return Linear(quant.quantize(w, fmt), p.b, p.role)
    kw = {"scale_bits": policy.scale_bits} if fmt == "q3_k" else {}
    block = 256 if fmt == "q3_k" else 32
    if w.shape[-1] % block:
        return p
    if w.dim() >= 3:
        parts, join = [quant.quantize(e, fmt, **kw) for e in w], torch.stack
    elif w.numel() > _CHUNK:
        rows = max(1, _CHUNK // w.shape[-1])
        parts = [quant.quantize(w[i:i + rows], fmt, **kw)
                 for i in range(0, w.shape[0], rows)]
        join = torch.cat
    else:
        return Linear(quant.quantize(w, fmt, **kw), p.b, p.role)
    first = parts[0]
    fields = {f.name: getattr(first, f.name) for f in dataclasses.fields(first)}
    for name, val in fields.items():
        if isinstance(val, torch.Tensor):
            fields[name] = join([getattr(q, name) for q in parts])
    return Linear(type(first)(**fields), p.b, p.role)


_CHUNK = 1 << 28   # elements quantized at once (1 GiB of f32 temporaries)


def _is_linear(x) -> bool:
    return isinstance(x, Linear)


def quantize_params(params: Any, policy: OffloadPolicy) -> Any:
    """Quantize every Linear of a parameter tree per the policy."""
    return tree_map(lambda node: (quantize_linear(node, policy)
                                  if isinstance(node, Linear) else node),
                    params, is_leaf=_is_linear)


def _is_qtensor(x) -> bool:
    return isinstance(x, QTYPES)


def param_bytes(params: Any) -> int:
    """Total parameter storage bytes (quantized tensors count packed)."""
    total = 0
    for leaf in tree_leaves(params, is_leaf=_is_qtensor):
        if isinstance(leaf, QTYPES):
            total += leaf.nbytes()
        else:
            total += leaf.numel() * leaf.element_size()
    return total


def param_count(params: Any) -> int:
    """Logical parameter count (quantized tensors count their logical
    size)."""
    total = 0
    for leaf in tree_leaves(params, is_leaf=_is_qtensor):
        if isinstance(leaf, QTYPES):
            total += math.prod(leaf.shape)
        else:
            total += leaf.numel()
    return total
