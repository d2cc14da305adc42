"""Fused paged flash-prefill of one prompt chunk (``csrc/flash_prefill.cu``)
and its plain PyTorch versions.

Replaces ``repro.kernels.flash_prefill.flash_prefill_paged`` and
``flash_prefill_paged_q8`` on the card.  Both write the chunk's K/V into
its blocks of the paged pools **in place** (the reference returns new
pools; here the returned pools are the tensors passed in) and attend all
T*G queries of the chunk to history + chunk.

Layouts: q ``(T, Hkv, G, hd)``; k_new/v_new ``(T, Hkv, hd)``; pools
``(NB, Hkv, bs, hd)`` (Q8_0: int8 quants + f16 scales
``(NB, Hkv, bs, hd // 32)``); block_table ``(MB,)`` int32; ``pos0`` an
int, the tokens already cached (the chunk sits at ``pos0 .. pos0+T-1``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quant
from repro_torch.kernels import build

launches = 0          # flash_prefill_paged launches since the last reset
launches_q8 = 0       # flash_prefill_paged_q8 launches since the last reset
MAX_HEAD_DIM = 192    # shared memory of the double-buffered tiles
QK = quant.QK8_0

_BF16_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_Q8_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


# ------------------------------------------------------- plain versions

def _chunk_index(block_table: torch.Tensor, pos0: int, t: int, bs: int):
    chunk_pos = torch.arange(pos0, pos0 + t, device=block_table.device)
    return chunk_pos, block_table[chunk_pos // bs].long(), chunk_pos % bs


def _attend(q, keys, vals, pos0: int, scale: float, window):
    """Chunk queries (T,Hkv,G,hd) against gathered f32 keys/values
    (Hkv, C, hd): causal + position mask, f32 softmax, values past the
    chunk's last token selected to 0 (stale bytes may be NaN)."""
    t = q.shape[0]
    logits = torch.einsum("thgd,hcd->thgc", q.float(), keys) * scale
    qpos = torch.arange(pos0, pos0 + t, device=q.device)[:, None]
    kpos = torch.arange(keys.shape[1], device=q.device)[None, :]
    mask = kpos <= qpos                                      # (T, C)
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    vals = torch.where((kpos[0] < pos0 + t)[None, :, None], vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    p = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    return torch.einsum("thgc,hcd->thgd", p, vals).to(q.dtype)


def flash_prefill_paged_ref(q, k_new, v_new, k_pool, v_pool, block_table,
                            pos0, *, scale=None, window=None):
    """Scatter the chunk into the pools (in place), gather the table,
    causal + position-masked softmax in f32.  The CPU path of
    ``ops.paged_prefill_attention`` and the oracle on the card."""
    t, h, g, d = q.shape
    bs = k_pool.shape[2]
    mb = block_table.shape[0]
    scale = d ** -0.5 if scale is None else scale
    pos0 = int(pos0)
    _, bids, offs = _chunk_index(block_table, pos0, t, bs)
    k_pool[bids, :, offs] = k_new.to(k_pool.dtype)
    v_pool[bids, :, offs] = v_new.to(v_pool.dtype)
    tbl = block_table.long()

    def gather(pool):
        return pool[tbl].transpose(0, 1).reshape(h, mb * bs, d).float()

    out = _attend(q, gather(k_pool), gather(v_pool), pos0, scale, window)
    return out, k_pool, v_pool


def flash_prefill_paged_q8_ref(q, k_new, v_new, kq_pool, vq_pool, ks_pool,
                               vs_pool, block_table, pos0, *, scale=None,
                               window=None):
    """Q8_0 pools: requantize the chunk with ``quant.quantize_q8_0``,
    scatter quants and scales (in place), gather the table, dequantize
    through bf16, then as :func:`flash_prefill_paged_ref`."""
    t, h, g, d = q.shape
    bs = kq_pool.shape[2]
    mb = block_table.shape[0]
    ds = d // QK
    scale = d ** -0.5 if scale is None else scale
    pos0 = int(pos0)
    _, bids, offs = _chunk_index(block_table, pos0, t, bs)
    k8 = quant.quantize_q8_0(k_new.float())
    v8 = quant.quantize_q8_0(v_new.float())
    kq_pool[bids, :, offs] = k8.qs
    vq_pool[bids, :, offs] = v8.qs
    ks_pool[bids, :, offs] = k8.d.to(ks_pool.dtype)
    vs_pool[bids, :, offs] = v8.d.to(vs_pool.dtype)
    tbl = block_table.long()

    def gather_deq(qpool, spool):
        gq = qpool[tbl].float()                      # (MB, Hkv, bs, d)
        gs = spool[tbl].float()                      # (MB, Hkv, bs, ds)
        deq = (gq.reshape(mb, h, bs, ds, QK) * gs[..., None]).reshape(
            mb, h, bs, d)
        return (deq.transpose(0, 1).reshape(h, mb * bs, d)
                .to(torch.bfloat16).float())

    out = _attend(q, gather_deq(kq_pool, ks_pool), gather_deq(vq_pool, vs_pool),
                  pos0, scale, window)
    return out, kq_pool, vq_pool, ks_pool, vs_pool


# ------------------------------------------------------------- kernels

def _check(name, q, k_new, v_new, pools, block_table, pos0, *, hd_mult):
    t, h, g, d = q.shape
    for label, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if not x.is_cuda or x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {label} must be a bf16 CUDA tensor, "
                             f"got {x.dtype} on {x.device}")
    if k_new.shape != (t, h, d) or v_new.shape != (t, h, d):
        raise ValueError(f"{name}: k_new{tuple(k_new.shape)} / "
                         f"v_new{tuple(v_new.shape)} do not match q{tuple(q.shape)}")
    if d % hd_mult or d > MAX_HEAD_DIM or t < 1:
        raise ValueError(f"{name}: head dim {d} must be a multiple of "
                         f"{hd_mult} and <= {MAX_HEAD_DIM}; T = {t} >= 1")
    for label, x in pools:
        if not x.is_cuda or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: pool {label} must be a contiguous, "
                             "16-byte aligned CUDA tensor (written in place)")
        if x.shape[1] != h or x.device != q.device:
            raise ValueError(f"{name}: pool {label}{tuple(x.shape)} does not "
                             f"match q{tuple(q.shape)} on {q.device}")
    bs = pools[0][1].shape[2]
    mb = block_table.shape[0]
    if not (block_table.is_cuda and block_table.dtype == torch.int32
            and block_table.dim() == 1):
        raise ValueError(f"{name}: block_table must be an int32 CUDA vector")
    if not 0 <= pos0 or pos0 + t > mb * bs:
        raise ValueError(f"{name}: chunk {pos0}..{pos0 + t - 1} outside the "
                         f"table's {mb * bs} positions")
    return t, h, g, d, bs


def flash_prefill_paged(q, k_new, v_new, k_pool, v_pool, block_table, pos0,
                        *, scale=None, window=None):
    """Kernel of :func:`flash_prefill_paged_ref` for bf16 pools: returns
    ``(out (T,Hkv,G,hd) bf16, k_pool, v_pool)`` with the chunk written
    into the pools in place."""
    global launches
    pos0 = int(pos0)
    t, h, g, d, bs = _check("flash_prefill_paged", q, k_new, v_new,
                            (("k", k_pool), ("v", v_pool)), block_table,
                            pos0, hd_mult=8)
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16 \
            or k_pool.shape != v_pool.shape or k_pool.shape[3] != d:
        raise ValueError("flash_prefill_paged: pools must be bf16 "
                         f"(NB,{h},bs,{d}), got {k_pool.dtype}{tuple(k_pool.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_prefill_paged: window must be >= 1, got {window}")
    q, k_new, v_new = (build.aligned16(x) for x in (q, k_new, v_new))
    table = block_table.contiguous()
    out = torch.empty_like(q)
    scale = d ** -0.5 if scale is None else scale
    build.launch("flash_prefill", "flash_prefill_paged_bf16", _BF16_ARGS, q.device,
                 q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
                 out.data_ptr(), t, h, g, d, bs, pos0, float(scale),
                 -1 if window is None else int(window))
    launches += 1
    return out, k_pool, v_pool


def flash_prefill_paged_q8(q, k_new, v_new, kq_pool, vq_pool, ks_pool,
                           vs_pool, block_table, pos0, *, scale=None,
                           window=None):
    """Kernel of :func:`flash_prefill_paged_q8_ref`: k_new/v_new bf16
    (requantized in the kernel), int8 quant and f16 scale pools updated
    in place.  Returns ``(out, kq_pool, vq_pool, ks_pool, vs_pool)``."""
    global launches_q8
    pos0 = int(pos0)
    t, h, g, d, bs = _check("flash_prefill_paged_q8", q, k_new, v_new,
                            (("kq", kq_pool), ("vq", vq_pool), ("ks", ks_pool),
                             ("vs", vs_pool)), block_table, pos0, hd_mult=QK)
    qshape = kq_pool.shape
    if (kq_pool.dtype != torch.int8 or vq_pool.dtype != torch.int8
            or ks_pool.dtype != torch.float16 or vs_pool.dtype != torch.float16
            or vq_pool.shape != qshape or qshape[3] != d
            or ks_pool.shape != (*qshape[:3], d // QK)
            or vs_pool.shape != ks_pool.shape):
        raise ValueError("flash_prefill_paged_q8: pools must be int8 "
                         f"(NB,{h},bs,{d}) and float16 (NB,{h},bs,{d // QK})")
    if window is not None and window < 1:
        raise ValueError(f"flash_prefill_paged_q8: window must be >= 1, got {window}")
    q, k_new, v_new = (build.aligned16(x) for x in (q, k_new, v_new))
    table = block_table.contiguous()
    out = torch.empty_like(q)
    scale = d ** -0.5 if scale is None else scale
    build.launch("flash_prefill", "flash_prefill_paged_q8", _Q8_ARGS, q.device,
                 q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 kq_pool.data_ptr(), vq_pool.data_ptr(), ks_pool.data_ptr(),
                 vs_pool.data_ptr(), table.data_ptr(), out.data_ptr(), t, h, g,
                 d, bs, pos0, float(scale),
                 -1 if window is None else int(window))
    launches_q8 += 1
    return out, kq_pool, vq_pool, ks_pool, vs_pool
