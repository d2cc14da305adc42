"""Convert the JAX package's parameter trees into the port's.

:func:`from_reference` walks dicts and lists and recognises the
reference's containers by their attribute names — ``Linear(w, b, role)``,
``Conv(lin, k)``, ``Q8_0Tensor(qs, d, logical)``, ``Q4_0Tensor`` (same
fields, uint8 quants) and ``Q3KTensor(ql, qh, scales, d, scale_bits)`` —
so it needs neither ``jax`` nor ``repro``: every array leaf goes through
``np.asarray``.  bf16/f16/f32/int8/uint8/int32 values are kept exactly
(bf16 crosses as its uint16 bit pattern, since ``torch.from_numpy``
does not take ``ml_dtypes.bfloat16``).

The reference stacks an LM's layer parameters over a leading period
axis (``params["layers"]`` is a list of ``period`` dicts whose leaves
carry that axis); the port keeps one dict per layer, so a ``"layers"``
list is unstacked into ``num_layers`` dicts in layer order.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.qlinear import Linear
from repro_torch.core.quant import Q3KTensor, Q4_0Tensor, Q8_0Tensor
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models.unet import Conv


def to_tensor(a: Any, device=None) -> torch.Tensor:
    """One array leaf -> tensor of the same dtype and bits."""
    arr = np.array(a)                      # a writable host copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


def _has(node: Any, *names: str) -> bool:
    return all(hasattr(node, n) for n in names)


def _convert(node: Any, device) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        out = {}
        for key, val in node.items():
            if key == "layers" and isinstance(val, (list, tuple)):
                out[key] = _unstack([_convert(p, device) for p in val])
            else:
                out[key] = _convert(val, device)
        return out
    if isinstance(node, (list, tuple)):
        return [_convert(v, device) for v in node]
    if _has(node, "lin", "k"):
        return Conv(_convert(node.lin, device), int(node.k))
    if _has(node, "w", "b", "role"):
        return Linear(_convert(node.w, device), _convert(node.b, device),
                      str(node.role))
    if _has(node, "ql", "qh", "scales", "d", "scale_bits"):
        return Q3KTensor(*(to_tensor(getattr(node, f), device)
                           for f in ("ql", "qh", "scales", "d")),
                         scale_bits=int(node.scale_bits))
    if _has(node, "qs", "d", "logical"):
        qs = to_tensor(node.qs, device)
        cls = Q8_0Tensor if qs.dtype == torch.int8 else Q4_0Tensor
        logical = None if node.logical is None else int(node.logical)
        return cls(qs, to_tensor(node.d, device), logical)
    return to_tensor(node, device)


def _unstack(periods: list) -> list:
    """[period dict with leading axis P] * plen -> P * plen layer dicts."""
    if not periods:
        return []
    first = tree_leaves(periods[0])
    n_periods = first[0].shape[0] if first else 0
    return [tree_map(lambda t, i=i: t[i], periods[j])
            for i in range(n_periods) for j in range(len(periods))]


def from_reference(tree: Any, device="cuda") -> Any:
    """The JAX package's parameter tree as the port's, on ``device``."""
    return _convert(tree, resolve_device(device))
