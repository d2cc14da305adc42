"""Public entry points of the kernels, dispatched by the tensor's device.

The counterpart of ``repro.kernels.ops``.  A CPU tensor takes the plain
PyTorch version (``kernels.ref``) under the reference's routing; a CUDA
tensor always launches the Hopper kernel, or raises where the kernel
cannot take it.  Nothing here falls back from the card to the plain
version:

* a tail-padded Q8_0 or Q4_0 weight (``logical`` set) takes the plain
  version on the CPU, as in the reference; on the card ``x`` is
  zero-padded to the stored K and the kernel runs (the padded weight
  columns are 0);
* ``quantized_matmul_w8a8`` quantizes x to Q8_0 blocks as the reference
  does and launches the integer kernel on the card;
* a Q3_K weight goes to its kernel as stored: the kernel unpacks the
  6-bit scale codes itself (the reference unpacks them in ``ops``);
* a Q8_0 or Q3_K weight with a leading expert axis (an MoE layer's
  stacked experts) takes x of shape (E, M, K) through one launch of the
  kernel's batched entry, the counterpart of the reference's ``vmap`` of
  the kernel over experts;
* attention launches its kernel for every Sq on the card (the
  reference's ``Sq >= 8`` rule comes from the TPU's tiles; the CUDA
  kernel masks rows past Sq), and GQA is folded outside the kernel by
  repeating KV heads;
* paged prefill launches ``flash_prefill_paged`` (bf16 pools) or
  ``flash_prefill_paged_q8`` (Q8_0 pools), and paged decode of a bf16
  pool launches ``flash_decode_paged``; both update or read the pools
  the caller passes, in place;
* contiguous decode of a bf16 cache launches ``flash_decode``, which
  reads ``kv_len`` on the card.

Gradients: on a CUDA tensor that requires grad (under grad mode)
``attention`` goes through ``flash_attention.FlashAttention``, whose
forward is the kernel and whose backward is autograd of the plain
version.  Every other kernel has no backward, so its entry raises a
``RuntimeError`` naming the kernel there rather than return an output
that silently drops the gradient.  On the CPU each plain version is
differentiable as it stands.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.quant import Q3KTensor, Q4_0Tensor, Q8_0Tensor
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import q3k_matmul as _q3k
from repro_torch.kernels import q4_matmul as _q4
from repro_torch.kernels import q8_matmul as _q8
from repro_torch.kernels import ref

KERNEL_MODULES = {"flash_attention": _fa, "q8_matmul": _q8,
                  "q3k_matmul": _q3k, "flash_prefill_paged": _fp,
                  "flash_prefill_paged_q8": _fp, "flash_decode_paged": _fd,
                  "q4_matmul": _q4, "q8_matmul_w8a8": _q8, "flash_decode": _fd}
# The module attribute holding each kernel's count ("launches" if absent).
_COUNTERS = {"flash_prefill_paged_q8": "launches_q8",
             "q8_matmul_w8a8": "launches_w8a8",
             "flash_decode": "launches_contiguous"}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: getattr(mod, _COUNTERS.get(name, "launches"))
            for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in KERNEL_MODULES.items():
        setattr(mod, _COUNTERS.get(name, "launches"), 0)


def _on_card(t: torch.Tensor) -> bool:
    """Whether a call dispatches to the kernel: its input is on the card."""
    return t.is_cuda


def _no_grad(kernel: str, *tensors) -> None:
    """Raise when a kernel without a backward would drop a gradient."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward, and an input requires "
            "grad; run it under torch.no_grad(), or train with dense "
            "weights (only flash_attention has a gradient)")


def _expert_axis(w) -> bool:
    """True for a quantized weight with a leading expert axis (E, N, K)."""
    return isinstance(w, (Q8_0Tensor, Q4_0Tensor)) and w.qs.dim() == 3 \
        or isinstance(w, Q3KTensor) and w.ql.dim() == 3


def _experts_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (E, M, K) against a Q8_0 or Q3_K weight (E, N, K) -> (E, M, N)
    f32: one launch of the kernel's batched entry on the card (the
    reference's ``vmap`` of the kernel over experts), the plain version
    expert by expert on the CPU."""
    e = w.qs.shape[0] if isinstance(w, (Q8_0Tensor, Q4_0Tensor)) else w.ql.shape[0]
    if x.dim() != 3 or x.shape[0] != e:
        raise ValueError(f"quantized_matmul: x{tuple(x.shape)} against a weight of "
                         f"{e} experts needs x of shape (E, M, K)")
    if not _on_card(x):
        return _experts_plain(x, w)
    if isinstance(w, Q8_0Tensor):
        _no_grad("q8_matmul", x)
        if w.logical is not None:
            x = F.pad(x, (0, w.qs.shape[-1] - w.logical))
        return _q8.q8_matmul_experts(x, w.qs, w.d)
    if isinstance(w, Q3KTensor):
        _no_grad("q3k_matmul", x)
        return _q3k.q3k_matmul_experts(x, w.ql, w.qh, w.scales, w.d)
    raise TypeError(f"quantized_matmul: no expert-batched kernel for {type(w).__name__}")


def _experts_plain(x: torch.Tensor, w) -> torch.Tensor:
    """The batched entries' plain version: the 2-D plain version expert
    by expert, stacked, (E, M, N) f32."""
    if isinstance(w, Q8_0Tensor):
        return torch.stack([ref.q8_matmul_ref(x[i], Q8_0Tensor(w.qs[i], w.d[i], w.logical))
                            for i in range(x.shape[0])])
    if isinstance(w, Q3KTensor):
        return torch.stack([ref.q3k_matmul_ref(x[i], Q3KTensor(
            w.ql[i], w.qh[i], w.scales[i], w.d[i], w.scale_bits)) for i in range(x.shape[0])])
    raise TypeError(f"quantized_matmul: no expert-batched kernel for {type(w).__name__}")


def quantized_matmul(x: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """y[..., n] = x[..., k] @ dequant(w)[n, k] for quantized weights.  A
    weight with a leading expert axis (E, N, K) takes x (E, M, K) and
    gives (E, M, N): one batched launch on the card."""
    out_dtype = out_dtype or x.dtype
    if _expert_axis(w):
        return _experts_matmul(x, w).to(out_dtype)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    on_card = _on_card(xf)
    if isinstance(w, Q8_0Tensor):
        n = w.qs.shape[0]
        if on_card:
            _no_grad("q8_matmul", xf)
            if w.logical is not None:
                xf = F.pad(xf, (0, w.qs.shape[-1] - w.logical))
            y = _q8.q8_matmul(xf, w.qs, w.d)
        else:
            y = ref.q8_matmul_ref(xf, w)
    elif isinstance(w, Q4_0Tensor):
        n = w.qs.shape[0]
        if on_card:
            _no_grad("q4_matmul", xf)
            if w.logical is not None:
                xf = F.pad(xf, (0, 2 * w.qs.shape[-1] - w.logical))
            y = _q4.q4_matmul(xf, w.qs, w.d)
        else:
            y = ref.q4_matmul_ref(xf, w)
    elif isinstance(w, Q3KTensor):
        n = w.ql.shape[0]
        if on_card:
            _no_grad("q3k_matmul", xf)
            y = _q3k.q3k_matmul(xf, w.ql, w.qh, w.scales, w.d)
        else:
            y = ref.q3k_matmul_ref(xf, w)
    else:
        raise TypeError(f"quantized_matmul: unsupported weight {type(w).__name__}")
    return y.reshape(*lead, n).to(out_dtype)


def quantized_matmul_w8a8(x: torch.Tensor, w: Q8_0Tensor, *,
                          out_dtype=None) -> torch.Tensor:
    """Integer-path (OP_SML8) matmul: x quantized to Q8_0 blocks (K
    zero-padded to the weight's stored K, as ``quantize_q8_0`` pads),
    then int8 x int8 block dots scaled by both block scales."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    on_card = _on_card(x)
    if on_card:
        _no_grad("q8_matmul_w8a8", x)
    xa = quant.quantize_q8_0(x.reshape(-1, x.shape[-1]))
    xs = xa.d.float()
    if on_card:
        y = _q8.q8_matmul_w8a8(xa.qs, xs, w.qs, w.d)
    else:
        y = ref.q8_matmul_w8a8_ref(xa.qs, xs, w)
    return y.reshape(*lead, w.qs.shape[0]).to(out_dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Attention with GQA folding. q: (B,Hq,Sq,D), k/v: (B,Hkv,Sk,D).
    Reports its score and P.V products to the matmul recorder."""
    from repro_torch.core import qlinear as _ql
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    _ql.record_matmul("attn_scores", "activation", sq, k.shape[2], d,
                      count=b * hq, act_act=True)
    _ql.record_matmul("attn_pv", "activation", sq, d, k.shape[2],
                      count=b * hq, act_act=True)
    if hq != hkv:
        assert hq % hkv == 0, (hq, hkv)
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if _on_card(q):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _fa.FlashAttention.apply(q, k, v, causal, window, scale)
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)


def paged_prefill_attention(q, k_new, v_new, k_pool, v_pool, block_table,
                            pos0, *, window: int | None = None,
                            scale: float | None = None,
                            k_scale_pool=None, v_scale_pool=None):
    """Fused paged prefill of one chunk for one slot: writes the chunk's
    KV into its blocks (in place) and attends all T queries.

    q: (T, Hkv, G, hd); k_new/v_new: (T, Hkv, hd) unquantized; pools:
    (NB, Hkv, bs, hd); block_table: (MB,) int32; pos0: int.  Returns
    ``(out, k_pool, v_pool)``, or with ``k_scale_pool``/``v_scale_pool``
    (Q8_0 pools: int8 quants + f16 per-32 scales, the chunk requantized)
    ``(out, kq, vq, ks, vs)``."""
    on_card = _on_card(q)
    if k_scale_pool is not None:
        if on_card:
            _no_grad("flash_prefill_paged_q8", q, k_new, v_new)
        fn = _fp.flash_prefill_paged_q8 if on_card \
            else _fp.flash_prefill_paged_q8_ref
        return fn(q, k_new, v_new, k_pool, v_pool, k_scale_pool, v_scale_pool,
                  block_table, pos0, scale=scale, window=window)
    if on_card:
        _no_grad("flash_prefill_paged", q, k_new, v_new)
    fn = _fp.flash_prefill_paged if on_card else _fp.flash_prefill_paged_ref
    return fn(q, k_new, v_new, k_pool, v_pool, block_table, pos0,
              scale=scale, window=window)


def paged_decode_attention(q, k_pool, v_pool, block_tables, positions, *,
                           scale: float | None = None,
                           window: int | None = None) -> torch.Tensor:
    """One-token GQA decode through per-row block tables of a bf16 pool.
    q: (B, Hkv, G, hd); pools: (NB, Hkv, bs, hd); block_tables: (B, MB)
    int32; positions: (B,) int32, last valid index per row."""
    on_card = _on_card(q)
    if on_card:
        _no_grad("flash_decode_paged", q, k_pool, v_pool)
    fn = _fd.flash_decode_paged if on_card else _fd.flash_decode_paged_ref
    return fn(q, k_pool, v_pool, block_tables, positions, scale=scale,
              window=window)


def decode_attention(q, k, v, kv_len, *, scale: float | None = None
                     ) -> torch.Tensor:
    """One-token GQA decode against a contiguous cache: q (B, Hkv, G, hd),
    k/v (B, Hkv, C, hd), kv_len (1,) int32 valid slots of every row."""
    on_card = _on_card(q)
    if on_card:
        _no_grad("flash_decode", q, k, v)
    fn = _fd.flash_decode if on_card else _fd.flash_decode_ref
    return fn(q, k, v, kv_len, scale=scale)
