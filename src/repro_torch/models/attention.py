"""GQA attention (``repro.models.attention``): full-sequence attention
with RoPE, and the KV-cache paths of LM decoding — the paged pools of
the serving runtime (fused chunk prefill ``attention_prefill_paged`` and
one-token decode with ``block_tables``) and the contiguous per-row
caches of the reference's generation loop (``attention_decode`` without
``block_tables``: one shared scalar ``pos``, or per-row positions; a
ring buffer of ``sliding_window`` slots for windowed configs).

Every cache is updated in place (the reference returns new arrays): the
fused prefill kernel writes the chunk's rows, and decode writes the new
token's K/V with plain tensor indexing.  A bf16 cache is then read by a
kernel — ``flash_decode_paged`` for a pool, ``flash_decode`` for a
contiguous cache at a scalar ``pos``.  A Q8_0 cache, and a contiguous
cache at per-row positions, keep the reference's (dequantize ->) einsum
read in plain PyTorch: the reference has no kernel for those reads, and
``flash_decode``, like its Pallas kernel, reads bf16 and takes one
``kv_len`` for all rows.  Cross attention of an encoder-decoder decoder
(``cross_attention_decode`` on contiguous encoder rows,
``cross_attention_paged`` through the paged cross pool) is the
reference's einsum read in plain PyTorch too: the reference computes it
in XLA, not in a Pallas kernel.  A config with ``mrope`` rotates q and k
by M-RoPE (``layers.apply_mrope``) on every one of these paths; with the
stub frontend its three position streams are the text positions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.qlinear import apply_linear, init_linear
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import attend_decode
from repro_torch.models import layers


class KVCache(NamedTuple):
    """KV cache of one layer: a contiguous cache, k/v (B, Hkv, C, hd), or
    a paged pool, k/v (NB, Hkv, bs, hd); int8 when quantized, with f16
    scales (..., hd // 32) only for the quantized variant."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def _zeros_cache(shape, quantized: bool, device) -> KVCache:
    if quantized:
        sshape = (*shape[:-1], shape[-1] // 32)
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(sshape, dtype=torch.float16, device=device),
                       torch.zeros(sshape, dtype=torch.float16, device=device))
    return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   None, None)


def init_kv_cache(batch: int, cfg: ModelConfig, max_len: int,
                  quantized: bool = False, device="cuda") -> KVCache:
    """Contiguous cache of ``min(max_len, sliding_window)`` slots per row
    (a ring buffer for windowed configs)."""
    cap = max_len
    if cfg.sliding_window is not None:
        cap = min(cap, cfg.sliding_window)
    return _zeros_cache((batch, cfg.num_kv_heads, cap, cfg.hd), quantized,
                        resolve_device(device))


def init_paged_kv_cache(num_blocks: int, cfg: ModelConfig, block_size: int,
                        quantized: bool = False, device="cuda") -> KVCache:
    """Physical block pool for the paged serving runtime; block 0 is the
    null block idle slots point at (see ``serving.kvcache``)."""
    return _zeros_cache((num_blocks, cfg.num_kv_heads, block_size, cfg.hd),
                        quantized, resolve_device(device))


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-32-block int8 quantization along head_dim."""
    t = quant.quantize_q8_0(x)
    return t.qs, t.d


def _dequantize_kv(qs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return quant.dequantize_q8_0(quant.Q8_0Tensor(qs, d), torch.bfloat16)


# ------------------------------------------------------------- params

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    hd, hq, hkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": init_linear(gen, cfg.d_model, hq * hd, role="attn_qkv",
                          bias=cfg.qkv_bias),
        "wk": init_linear(gen, cfg.d_model, hkv * hd, role="attn_qkv",
                          bias=cfg.qkv_bias),
        "wv": init_linear(gen, cfg.d_model, hkv * hd, role="attn_qkv",
                          bias=cfg.qkv_bias),
        "wo": init_linear(gen, hq * hd, cfg.d_model, role="attn_out"),
    }


def _split_heads(x: torch.Tensor, nheads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, nheads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _positions_mrope(positions: torch.Tensor) -> torch.Tensor:
    """(B, S) -> (B, 3, S) text-position triplet (stub frontend)."""
    return positions[:, None, :].expand(positions.shape[0], 3,
                                        positions.shape[1])


def _rope(cfg: ModelConfig, x: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    if cfg.mrope:
        return layers.apply_mrope(x, _positions_mrope(positions),
                                  tuple(cfg.mrope_sections), cfg.rope_theta)
    return layers.apply_rope(x, positions, cfg.rope_theta)


# -------------------------------------------------------- full-seq fwd

def attention_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor | None = None, *,
                  causal: bool = True, kv_x: torch.Tensor | None = None,
                  rope: bool = False) -> torch.Tensor:
    """Attention over a full sequence.  ``rope`` rotates q and k by
    ``positions`` (B, S); ``kv_x`` switches to cross-attention (keys and
    values from ``kv_x``, non-causal, no RoPE)."""
    src = kv_x if kv_x is not None else x
    q = _split_heads(apply_linear(p["wq"], x), cfg.num_heads)
    k = _split_heads(apply_linear(p["wk"], src), cfg.num_kv_heads)
    v = _split_heads(apply_linear(p["wv"], src), cfg.num_kv_heads)
    if rope and kv_x is None:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    window = cfg.sliding_window if kv_x is None else None
    out = ops.attention(q, k, v, causal=causal and kv_x is None,
                        window=window)
    return apply_linear(p["wo"], _merge_heads(out))


# ----------------------------------------------------- paged prefill

def _as_int(pos) -> int:
    """A host int from an int or a one-element tensor (a CUDA tensor
    costs a sync; the scheduler passes host values)."""
    return int(pos.reshape(-1)[0]) if isinstance(pos, torch.Tensor) else int(pos)


def attention_prefill_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                            pos0, cache: KVCache, block_tables: torch.Tensor,
                            *, rope: bool = True
                            ) -> tuple[torch.Tensor, KVCache]:
    """Fused prefill of one chunk against the paged pool.

    x: (1, T, d), the chunk being admitted; pos0: tokens already cached
    for the slot (int or (1,) tensor); block_tables: (1, MB) int32, the
    slot's table row.  One ``ops.paged_prefill_attention`` call per layer
    writes the chunk's KV into its blocks (Q8_0 pools: requantized) and
    attends every chunk query to history + chunk.  Returns
    (out (1, T, d), cache) with the pools updated in place."""
    b, t, _ = x.shape
    assert b == 1, "admission prefill is batch-1 (one slot)"
    pos0 = _as_int(pos0)
    positions = torch.arange(pos0, pos0 + t, device=x.device)[None, :]
    q = _split_heads(apply_linear(p["wq"], x), cfg.num_heads)
    k = _split_heads(apply_linear(p["wk"], x), cfg.num_kv_heads)
    v = _split_heads(apply_linear(p["wv"], x), cfg.num_kv_heads)
    if rope:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    g = cfg.num_heads // cfg.num_kv_heads
    # (1, Hq, T, hd) -> (T, Hkv, G, hd); query head kv*G + g as in decode.
    qt = q[0].reshape(cfg.num_kv_heads, g, t, cfg.hd).permute(2, 0, 1, 3)
    kn = k[0].transpose(0, 1)                    # (T, Hkv, hd)
    vn = v[0].transpose(0, 1)
    if cache.k_scale is not None:
        # The raw chunk KV: the kernel requantizes it per 32 along hd.
        out = ops.paged_prefill_attention(
            qt, kn, vn, cache.k, cache.v, block_tables[0], pos0,
            window=cfg.sliding_window, scale=cfg.hd ** -0.5,
            k_scale_pool=cache.k_scale, v_scale_pool=cache.v_scale)[0]
    else:
        out = ops.paged_prefill_attention(
            qt, kn.to(cache.k.dtype), vn.to(cache.v.dtype), cache.k, cache.v,
            block_tables[0], pos0, window=cfg.sliding_window,
            scale=cfg.hd ** -0.5)[0]
    out = out.permute(1, 2, 0, 3).reshape(1, cfg.num_heads, t, cfg.hd)
    return apply_linear(p["wo"], _merge_heads(out).to(x.dtype)), cache


# ------------------------------------------------------------- decode

def _write(cache: KVCache, index, k, v) -> None:
    """Write the new token's K/V (B, Hkv, 1, hd) at ``cache.k[index]``, in
    place; a Q8_0 cache stores its quants and scales."""
    if cache.k_scale is None:
        cache.k[index] = k[:, :, 0].to(cache.k.dtype)
        cache.v[index] = v[:, :, 0].to(cache.v.dtype)
        return
    kq, kd = _quantize_kv(k)
    vq, vd = _quantize_kv(v)
    for buf, upd in ((cache.k, kq), (cache.v, vq), (cache.k_scale, kd),
                     (cache.v_scale, vd)):
        buf[index] = upd[:, :, 0]


def _read(cache: KVCache) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole contiguous cache as bf16 (keys, vals)."""
    if cache.k_scale is None:
        return cache.k, cache.v
    return (_dequantize_kv(cache.k, cache.k_scale),
            _dequantize_kv(cache.v, cache.v_scale))


def _contiguous_slot(cfg: ModelConfig, cap: int, pos: int) -> tuple[int, int]:
    """(slot, kv_len) of a contiguous cache of ``cap`` slots at a shared
    scalar ``pos``: the token goes to slot ``pos % cap`` (ring buffer,
    windowed configs) or ``min(pos, cap-1)``, and slots ``c < kv_len``
    hold tokens, with ``kv_len = min(pos, cap-1) + 1``, or
    ``min(pos+1, cap)`` in the ring (all of its filled slots are valid)."""
    if cfg.sliding_window is not None:
        return pos % cap, min(pos + 1, cap)
    return min(pos, cap - 1), min(pos, cap - 1) + 1


def scalar_pos_tensors(cfg: ModelConfig, pos: int, batch: int, cap: int,
                       device) -> tuple[torch.Tensor, torch.Tensor]:
    """The device tensors of a decode step at a shared scalar ``pos`` on
    contiguous caches of ``cap`` slots: (pos_vec (B,) int32 for RoPE,
    kv_len (1,) int32 for ``flash_decode``).  ``lm_decode_step`` builds
    them once per step for all its layers."""
    kv_len = _contiguous_slot(cfg, cap, pos)[1]
    return (torch.full((batch,), pos, dtype=torch.int32, device=device),
            torch.full((1,), kv_len, dtype=torch.int32, device=device))


def _update_read_contiguous(cfg: ModelConfig, cache: KVCache, k, v,
                            pos: int):
    """Contiguous rows, one shared scalar ``pos``: write the token at its
    slot (:func:`_contiguous_slot`).  Returns (keys, vals, kv_len)."""
    slot, kv_len = _contiguous_slot(cfg, cache.capacity, pos)
    _write(cache, (slice(None), slice(None), slot), k, v)
    return (*_read(cache), kv_len)


def _update_read_rowwise(cfg: ModelConfig, cache: KVCache, k, v,
                         pos_vec: torch.Tensor):
    """Contiguous rows with *per-row* positions ((B,) int32): row r
    writes at its own slot.  Returns (keys, vals, valid (B, C))."""
    cap = cache.capacity
    b = k.shape[0]
    rows = torch.arange(b, device=k.device)
    pos_l = pos_vec.long()
    if cfg.sliding_window is not None:
        slot = pos_l % cap
    else:
        slot = pos_l.clamp(max=cap - 1)
    _write(cache, (rows, slice(None), slot), k, v)
    keys, vals = _read(cache)
    idx = torch.arange(cap, device=k.device)[None, :]
    if cfg.sliding_window is None:
        valid = idx <= pos_l.clamp(max=cap - 1)[:, None]
    else:
        valid = idx < (pos_l + 1).clamp(max=cap)[:, None]
    return keys, vals, valid


def _paged_index(block_tables, pos_l, bs):
    """Index of each row's position ``pos_l`` in a paged pool: block
    ``tables[r, pos // bs]``, offset ``pos % bs``."""
    rows = torch.arange(block_tables.shape[0], device=block_tables.device)
    return block_tables[rows, pos_l // bs].long(), slice(None), pos_l % bs


def _update_read_paged(cfg: ModelConfig, cache: KVCache, k, v, pos_vec,
                       block_tables):
    """Q8_0 paged pool: scatter the new token's quantized K/V at block
    ``tables[r, pos // bs]`` offset ``pos % bs`` (in place), gather and
    dequantize the logical window, and mask ``idx <= pos`` (and the
    sliding window).  Returns (keys, vals, valid (B, MB*bs)); recycled
    blocks may hold NaN, which the read selects away."""
    b = k.shape[0]
    bs = cache.k.shape[2]
    mb = block_tables.shape[1]
    pos_l = pos_vec.long()
    _write(cache, _paged_index(block_tables, pos_l, bs), k, v)
    tbl = block_tables.long()

    def gather(pool):
        # (B, MB, Hkv, bs, d*) -> (B, Hkv, MB*bs, d*)
        g = pool[tbl].transpose(1, 2)
        return g.reshape(b, g.shape[1], mb * bs, g.shape[-1])

    keys = _dequantize_kv(gather(cache.k), gather(cache.k_scale))
    vals = _dequantize_kv(gather(cache.v), gather(cache.v_scale))
    idx = torch.arange(mb * bs, device=k.device)[None, :]
    valid = idx <= pos_l[:, None]
    if cfg.sliding_window is not None:
        valid &= idx > (pos_l[:, None] - cfg.sliding_window)
    return keys, vals, valid


def attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, pos,
                     cache: KVCache, *, rope: bool = True,
                     block_tables: torch.Tensor | None = None,
                     pos_tensors: tuple | None = None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode.  x: (B, 1, d); pos: the position each row writes,
    a scalar shared by all rows (an int, or a 0-d tensor) or (B,) int32
    per-row positions.  ``pos_tensors``: :func:`scalar_pos_tensors` of a
    scalar ``pos``, built here when not given.

    ``block_tables`` (B, MB) int32 selects the paged pool (per-row
    positions required): a bf16 pool is read by ``flash_decode_paged``.
    Without it the cache is contiguous: at a scalar ``pos`` a bf16 cache
    is read by ``flash_decode`` with ``kv_len`` valid slots; a Q8_0 cache,
    or per-row positions, take the reference's einsum read
    (:func:`attend_decode`).  Returns (out (B, 1, d), cache updated in
    place)."""
    b = x.shape[0]
    per_row = isinstance(pos, torch.Tensor) and pos.dim() > 0
    if per_row:
        pos_vec = pos.to(device=x.device, dtype=torch.int32)
    else:
        pos = _as_int(pos)
        pos_vec, kv_len_t = pos_tensors or scalar_pos_tensors(
            cfg, pos, b, cache.capacity, x.device)
    q = _split_heads(apply_linear(p["wq"], x), cfg.num_heads)
    k = _split_heads(apply_linear(p["wk"], x), cfg.num_kv_heads)
    v = _split_heads(apply_linear(p["wv"], x), cfg.num_kv_heads)
    if rope:
        q = _rope(cfg, q, pos_vec[:, None])
        k = _rope(cfg, k, pos_vec[:, None])
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, cfg.num_kv_heads, g, cfg.hd)
    scale = cfg.hd ** -0.5
    quantized = cache.k_scale is not None
    if block_tables is not None:
        assert per_row, "paged decode requires per-slot positions"
        if not quantized:
            _write(cache, _paged_index(block_tables, pos_vec.long(),
                                       cache.k.shape[2]), k, v)
            out = ops.paged_decode_attention(
                qg.to(cache.k.dtype), cache.k, cache.v, block_tables, pos_vec,
                scale=scale, window=cfg.sliding_window)
        else:
            # No kernel reads a Q8_0 pool in the reference's decode either:
            # gather, dequantize to bf16, einsum with f32 accumulation.
            out = attend_decode(qg, *_update_read_paged(
                cfg, cache, k, v, pos_vec, block_tables), scale)
    elif per_row:
        out = attend_decode(qg, *_update_read_rowwise(cfg, cache, k, v,
                                                      pos_vec), scale)
    else:
        keys, vals, kv_len = _update_read_contiguous(cfg, cache, k, v, pos)
        if not quantized:
            out = ops.decode_attention(qg.to(keys.dtype), keys, vals,
                                       kv_len_t, scale=scale)
        else:
            valid = torch.arange(cache.capacity, device=x.device) < kv_len
            out = attend_decode(qg, keys, vals, valid[None, :], scale)
    out = out.reshape(b, 1, cfg.num_heads * cfg.hd).to(x.dtype)
    return apply_linear(p["wo"], out), cache


# ------------------------------------------------------ cross attention

def _cross_attend(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  keys: torch.Tensor, vals: torch.Tensor,
                  valid: torch.Tensor | None) -> torch.Tensor:
    """(B, T, d) queries against fixed encoder keys/vals (B, Hkv, C, hd),
    optional validity mask (B, C).  Non-causal over a fixed KV set, so
    every query position is independent (chunk-at-once equals per-token).
    As the reference: q rounded to the keys' dtype, f32 logits and
    softmax, P rounded to the values' dtype, f32 P.V; masked logits are
    -inf and masked values an explicit 0 (recycled blocks may hold NaN,
    and 0 * NaN = NaN)."""
    b, t, _ = x.shape
    g = cfg.num_heads // cfg.num_kv_heads
    q = _split_heads(apply_linear(p["wq"], x), cfg.num_heads)
    # (B, Hq, T, hd) -> (B, Hkv, G, T, hd): head kv*G + g, as in decode.
    qg = q.reshape(b, cfg.num_kv_heads, g, t, cfg.hd)
    logits = torch.einsum("bhgtd,bhcd->bhgtc", qg.to(keys.dtype).float(),
                          keys.float()) * (cfg.hd ** -0.5)
    if valid is not None:
        vals = torch.where(valid[:, None, :, None], vals,
                           torch.zeros((), dtype=vals.dtype, device=vals.device))
        logits = logits.masked_fill(~valid[:, None, None, None, :],
                                    float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgtc,bhcd->bhgtd", probs.to(vals.dtype).float(),
                       vals.float())
    out = out.reshape(b, cfg.num_heads, t, cfg.hd)
    return apply_linear(p["wo"], _merge_heads(out).to(x.dtype))


def cross_attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                           enc_k: torch.Tensor, enc_v: torch.Tensor,
                           enc_valid: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Cross attention against precomputed contiguous encoder KV.  x: (B,
    T, d), T = 1 in decode and the chunk in a fused prefill; enc_k/enc_v:
    (B, Hkv, S_enc, hd); ``enc_valid`` (B, S_enc) masks a ragged tail."""
    return _cross_attend(p, cfg, x, enc_k, enc_v, enc_valid)


def cross_attention_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                          cross_tables: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, *, enc_len: int
                          ) -> torch.Tensor:
    """Cross attention reading encoder KV from the paged cross pool.  x:
    (B, T, d); cross_tables: (B, MBc) int32 rows into the bf16 pools
    (NBc, Hkv, cbs, hd) that ``write_cross_kv`` filled.  Positions at or
    past ``enc_len`` in the gathered window (the tail block's padding) are
    masked."""
    b = x.shape[0]
    cbs = k_pool.shape[2]
    mb = cross_tables.shape[1]
    tbl = cross_tables.long()

    def gather(pool):
        g = pool[tbl].transpose(1, 2)             # (B, Hkv, MBc, cbs, hd)
        return g.reshape(b, g.shape[1], mb * cbs, g.shape[-1])

    valid = (torch.arange(mb * cbs, device=x.device) < enc_len)[None, :]
    return _cross_attend(p, cfg, x, gather(k_pool), gather(v_pool),
                         valid.expand(b, mb * cbs))
