"""Tensor-parallel collectives over the mesh's ``model`` group.

The reference partitions its compute with GSPMD: its layers pin the
shardings of intermediates at ``ctx``'s cut points (``heads``,
``heads_q``, ``ffn``, ``vocab``, ``expert_buf``) and the compiler
inserts the collectives those layouts need.  The port has no such
compiler.  These autograd ``Function``s are its counterpart of what
GSPMD inserts there, placed by hand in the layers:

* :func:`copy` — identity forward, all-reduce backward.  It goes where a
  replicated activation enters rank-local compute (in front of a
  column-parallel linear): each rank's input gradient is a part of the
  whole.
* :func:`reduce` — all-reduce forward, identity backward.  It goes after
  a row-parallel linear, whose ranks each hold a partial product over
  their slice of K.  The partial products are summed in f32 and rounded
  once to the activation's dtype (:func:`row_parallel`), so that only the
  order of the partial sums differs from the whole-K matmul.
* :func:`gather` — all-gather forward, the rank's own slice backward.
  Its output is replicated along ``model`` and feeds replicated compute,
  so every rank's cotangent is the same (where a rank-local consumer
  follows, a :func:`copy` after it sums the ranks' cotangents first).

Each takes the env's group (``ctx.tp_group()``); without one it is the
identity.  Transport: NCCL groups take device tensors directly.  Per
PyTorch's backend table gloo takes CUDA tensors only for ``broadcast``
and ``all_reduce``, so for a gloo group :func:`all_gather` and
:func:`reduce_scatter` (the per-layer gathers of the sharded train step
and their way back, ``distributed.fsdp``) stage a CUDA tensor through
pinned host memory (copied to the CPU, gathered or reduced there, copied
back to its device); the compute stays on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.qlinear import Linear, f32_product, record_matmul
from repro_torch.core.quant import QTYPES
from repro_torch.distributed import ctx
from repro_torch.kernels import ops
from repro_torch.launch.mesh import AxisGroup


def all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """A copy of ``x`` summed (or ``op``-reduced) over ``group``'s ranks."""
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


def _staged(x: torch.Tensor, g: AxisGroup) -> bool:
    """Whether a collective of ``x`` on ``g`` goes through host memory (a
    CUDA tensor on a gloo group)."""
    import torch.distributed as dist
    return x.is_cuda and dist.get_backend(g.group) == "gloo"


def _host(shape, dtype) -> torch.Tensor:
    """An empty host buffer in pinned memory: a copy to or from the card
    runs at the link's rate, about ten times the rate from pageable
    memory (``tools/gloo_transport.py`` measures both), and torch's
    caching host allocator keeps the buffer for the next call."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def all_gather(x: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in the order of their
    coordinates along the axis.  A CUDA tensor on a gloo group is staged
    through pinned host memory (gloo gathers only CPU tensors): copied
    out, gathered there, each part copied back to the card."""
    import torch.distributed as dist
    staged = _staged(x, g)
    if staged:
        src = _host(x.shape, x.dtype)
        src.copy_(x)
        parts = [_host(x.shape, x.dtype) for _ in range(g.size)]
    else:
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(g.size)]
    dist.all_gather(parts, src, group=g.group)
    ordered = [parts[g.order.index(c)] for c in range(g.size)]
    if staged:
        ordered = [t.to(x.device, non_blocking=True) for t in ordered]
    return torch.cat(ordered, dim)


def reduce_scatter(x: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    """Every rank's ``x`` summed over the group, and of the sum this
    rank's slice along ``dim`` (``x.shape[dim] / g.size`` of it, the
    slices in the order of the coordinates along the axis): the way back
    of :func:`all_gather`.  A CUDA tensor on a gloo group is staged
    through pinned host memory (gloo reduce-scatters only CPU tensors)."""
    import torch.distributed as dist
    if x.shape[dim] % g.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {g.size} ranks")
    staged = _staged(x, g)
    src = x
    if staged:
        src = _host(x.shape, x.dtype)
        src.copy_(x)
    chunks = src.chunk(g.size, dim)
    parts = [chunks[c].contiguous() for c in g.order]
    out = _host(parts[0].shape, x.dtype) if staged else torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=g.group)
    return out.to(x.device, non_blocking=True) if staged else out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, g):
        fctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(fctx, gy):
        return all_reduce(gy.float(), fctx.g.group).to(gy.dtype), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, g, dtype):
        fctx.in_dtype = x.dtype
        return all_reduce(x.float(), g.group).to(dtype)

    @staticmethod
    def backward(fctx, gy):
        return gy.to(fctx.in_dtype), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, g, dim):
        fctx.g, fctx.dim, fctx.n = g, dim, x.shape[dim]
        return all_gather(x, g, dim)

    @staticmethod
    def backward(fctx, gy):
        g, n = fctx.g, fctx.n
        return gy.narrow(fctx.dim, g.rank * n, n).contiguous(), None, None


def copy(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``model``."""
    g = ctx.tp_group()
    return x if g is None else _Copy.apply(x, g)


def reduce(x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` summed over ``model`` in f32, rounded once to ``dtype``
    (``x``'s own by default); the gradient passes unchanged."""
    g = ctx.tp_group()
    dtype = dtype or x.dtype
    return x.to(dtype) if g is None else _Reduce.apply(x, g, dtype)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's slice of ``x`` along ``dim``, whole; the gradient is
    this rank's slice of the (replicated) cotangent."""
    g = ctx.tp_group()
    return x if g is None else _Gather.apply(x, g, dim)


def row_parallel(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """``apply_linear`` of a row-parallel linear, whose rank holds the
    slice of K that ``x`` (B, ..., K/tp) covers: this rank's partial
    product in f32 (a dense weight's f32 sums; a quantized weight's kernel
    output), summed over ``model`` by :func:`reduce` and rounded once to
    ``x``'s dtype, then the bias.  Its backward keeps the weight, not an
    f32 copy of it (``qlinear.f32_product``)."""
    w = lin.w
    m = 1
    for d in x.shape[:-1]:
        m *= int(d)
    record_matmul("linear", lin.role, m, int(w.shape[-2]), int(w.shape[-1]))
    if isinstance(w, QTYPES):
        y = ops.quantized_matmul(x, w, out_dtype=torch.float32)
    else:
        y = f32_product(x, w)
    y = reduce(y, x.dtype)
    if lin.b is not None:
        y = y + lin.b.to(y.dtype)
    return y
