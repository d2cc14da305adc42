"""GQA attention (``repro.models.attention``): full-sequence attention
with RoPE, and the paged KV-cache paths of LM serving — fused chunk
prefill (``attention_prefill_paged``) and one-token decode
(``attention_decode`` with ``block_tables``).

The paged pools are updated in place (the reference returns new arrays):
the fused prefill kernel writes the chunk's rows, and decode scatters
the new token's K/V with plain tensor indexing.  A bf16 pool is then read
by the ``flash_decode_paged`` kernel; a Q8_0 pool keeps the reference's
gather -> dequantize -> einsum in plain PyTorch, because the reference
has no kernel for that read.  The contiguous and row-wise decode caches
(``_update_read_contiguous`` / ``_update_read_rowwise``) and M-RoPE are
not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.qlinear import apply_linear, init_linear
from repro_torch.kernels import ops
from repro_torch.models import layers


class KVCache(NamedTuple):
    """Paged KV pool of one layer.  k/v: (NB, Hkv, bs, hd) (int8 when
    quantized); scales only for the quantized variant:
    (NB, Hkv, bs, hd // 32) float16."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None


def init_paged_kv_cache(num_blocks: int, cfg: ModelConfig, block_size: int,
                        quantized: bool = False, device="cuda") -> KVCache:
    """Physical block pool for the paged serving runtime; block 0 is the
    null block idle slots point at (see ``serving.kvcache``)."""
    device = resolve_device(device)
    shape = (num_blocks, cfg.num_kv_heads, block_size, cfg.hd)
    if quantized:
        sshape = (num_blocks, cfg.num_kv_heads, block_size, cfg.hd // 32)
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(sshape, dtype=torch.float16, device=device),
                       torch.zeros(sshape, dtype=torch.float16, device=device))
    return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   None, None)


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


def _rope(cfg: ModelConfig, x: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    if cfg.mrope:
        raise NotImplementedError(f"{cfg.name}: M-RoPE is not ported")
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

def _update_read_paged(cfg: ModelConfig, cache: KVCache, k, v, pos_vec,
                       block_tables):
    """Q8_0 paged pool: scatter the new token's quantized K/V at block
    ``tables[r, pos // bs]`` offset ``pos % bs`` (in place), gather and
    dequantize the logical window, and mask ``idx <= pos`` (and the
    sliding window).  Returns (keys, vals, valid (B, MB*bs)), masked
    values selected to 0 (recycled blocks may hold NaN)."""
    b = k.shape[0]
    bs = cache.k.shape[2]
    mb = block_tables.shape[1]
    rows = torch.arange(b, device=k.device)
    pos_l = pos_vec.long()
    bid = block_tables[rows, pos_l // bs].long()
    off = pos_l % bs
    tbl = block_tables.long()
    kq, kd = _quantize_kv(k)
    vq, vd = _quantize_kv(v)
    for pool, upd in ((cache.k, kq), (cache.v, vq), (cache.k_scale, kd),
                      (cache.v_scale, vd)):
        pool[bid, :, off] = upd[:, :, 0]

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
    vals = torch.where(valid[:, None, :, None], vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    return keys, vals, valid


def attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     pos: torch.Tensor, cache: KVCache, *, rope: bool = True,
                     block_tables: torch.Tensor
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode on the paged pool.  x: (B, 1, d); pos: (B,) int32
    per-slot positions (the position each row writes); block_tables:
    (B, MB) int32.  Returns (out (B, 1, d), cache updated in place)."""
    if block_tables is None:
        raise NotImplementedError("only the paged decode cache is ported")
    b = x.shape[0]
    pos_vec = pos.to(device=x.device, dtype=torch.int32)
    q = _split_heads(apply_linear(p["wq"], x), cfg.num_heads)
    k = _split_heads(apply_linear(p["wk"], x), cfg.num_kv_heads)
    v = _split_heads(apply_linear(p["wv"], x), cfg.num_kv_heads)
    if rope:
        q = _rope(cfg, q, pos_vec[:, None])
        k = _rope(cfg, k, pos_vec[:, None])
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, cfg.num_kv_heads, g, cfg.hd)
    scale = cfg.hd ** -0.5
    if cache.k_scale is None:
        bs = cache.k.shape[2]
        rows = torch.arange(b, device=x.device)
        pos_l = pos_vec.long()
        bid = block_tables[rows, pos_l // bs].long()
        off = pos_l % bs
        cache.k[bid, :, off] = k[:, :, 0].to(cache.k.dtype)
        cache.v[bid, :, off] = v[:, :, 0].to(cache.v.dtype)
        out = ops.paged_decode_attention(
            qg.to(cache.k.dtype), cache.k, cache.v, block_tables, pos_vec,
            scale=scale, window=cfg.sliding_window)
    else:
        # No kernel reads a Q8_0 pool in the reference's decode either:
        # gather, dequantize to bf16, einsum with f32 accumulation.
        keys, vals, valid = _update_read_paged(cfg, cache, k, v, pos_vec,
                                               block_tables)
        logits = torch.einsum("bhgd,bhcd->bhgc", qg.to(keys.dtype).float(),
                              keys.float()) * scale
        logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgc,bhcd->bhgd", probs.to(vals.dtype).float(),
                           vals.float())
    out = out.reshape(b, 1, cfg.num_heads * cfg.hd).to(x.dtype)
    return apply_linear(p["wo"], out), cache
