"""Public entry points of the kernels, dispatched by the tensor's device.

The counterpart of ``repro.kernels.ops``.  A CPU tensor takes the plain
PyTorch version (``kernels.ref``) under the reference's routing; a CUDA
tensor always launches the Hopper kernel, or raises where this slice has
no kernel (Q4_0).  Nothing here falls back from the card to the plain
version:

* a tail-padded Q8_0 weight (``logical`` set) takes the plain version
  on the CPU, as in the reference; on the card ``x`` is zero-padded to
  the stored K and the kernel runs (the padded weight columns are 0);
* a Q3_K weight goes to its kernel as stored: the kernel unpacks the
  6-bit scale codes itself (the reference unpacks them in ``ops``);
* attention launches its kernel for every Sq on the card (the
  reference's ``Sq >= 8`` rule comes from the TPU's tiles; the CUDA
  kernel masks rows past Sq), and GQA is folded outside the kernel by
  repeating KV heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.quant import Q3KTensor, Q4_0Tensor, Q8_0Tensor
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import q3k_matmul as _q3k
from repro_torch.kernels import q8_matmul as _q8
from repro_torch.kernels import ref

KERNEL_MODULES = {"flash_attention": _fa, "q8_matmul": _q8,
                  "q3k_matmul": _q3k}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


def quantized_matmul(x: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """y[..., n] = x[..., k] @ dequant(w)[n, k] for quantized weights."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    on_card = xf.is_cuda
    if isinstance(w, Q8_0Tensor):
        n = w.qs.shape[0]
        if on_card:
            if w.logical is not None:
                xf = F.pad(xf, (0, w.qs.shape[-1] - w.logical))
            y = _q8.q8_matmul(xf, w.qs, w.d)
        else:
            y = ref.q8_matmul_ref(xf, w)
    elif isinstance(w, Q4_0Tensor):
        raise quant.q4_0_not_ported()
    elif isinstance(w, Q3KTensor):
        n = w.ql.shape[0]
        if on_card:
            y = _q3k.q3k_matmul(xf, w.ql, w.qh, w.scales, w.d)
        else:
            y = ref.q3k_matmul_ref(xf, w)
    else:
        raise TypeError(f"quantized_matmul: unsupported weight {type(w).__name__}")
    return y.reshape(*lead, n).to(out_dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Attention with GQA folding. q: (B,Hq,Sq,D), k/v: (B,Hkv,Sk,D)."""
    hq = q.shape[1]
    hkv = k.shape[1]
    if hq != hkv:
        assert hq % hkv == 0, (hq, hkv)
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
