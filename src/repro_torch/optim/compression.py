"""Int8 error-feedback gradient compression (``repro.optim.compression``).

Gradients are quantized to Q8_0-style int8 blocks before the (cross-pod)
exchange and the quantization residual is kept locally and added back
into the next step's gradient (error feedback).  Here, as in the
reference, the exchange is a compress -> decompress sandwich applied to
each gradient leaf inside the train step, with the residual carried in
a :class:`CompressionState`; ``compression_ratio`` is the byte saving
on the wire.

Each leaf is flattened and padded to a multiple of 32 before its blocks
are formed, as in the reference.  The port's leaves are per layer where
the reference's are stacked over layers, so the blocks coincide when a
layer's leaf size is a multiple of 32 (every leaf of the configs here).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.tree import tree_leaves, tree_map


class CompressionState(NamedTuple):
    residual: Any  # the gradients' structure, f32


def init_compression(grads_like: Any) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def compress_decompress(g: torch.Tensor, r: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize (g + residual) to int8 blocks -> (the dequantized value
    that crosses the wire, in g's dtype; the new f32 residual)."""
    x = g.float() + r
    flat = x.reshape(-1)
    pad = -flat.numel() % 32
    if pad:
        flat = F.pad(flat, (0, pad))
    deq = quant.dequantize_q8_0(quant.quantize_q8_0(flat))
    deq = deq[:x.numel()].reshape(x.shape)
    return deq.to(g.dtype), x - deq


@torch.no_grad()
def apply_compression(grads: Any, state: CompressionState
                      ) -> tuple[Any, CompressionState]:
    pairs = [compress_decompress(g, r) for g, r in
             zip(tree_leaves(grads), tree_leaves(state.residual))]
    outs, res = iter(p[0] for p in pairs), iter(p[1] for p in pairs)
    return (tree_map(lambda _: next(outs), grads),
            CompressionState(residual=tree_map(lambda _: next(res),
                                               state.residual)))


def compression_ratio() -> float:
    """bf16 (16 bit) -> Q8_0 (8.5 bit) on the wire."""
    return 16.0 / 8.5
