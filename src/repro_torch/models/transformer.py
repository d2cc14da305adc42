"""The attention-only LM stack (``repro.models.transformer``), dense or
MoE: parameters, the full-sequence forward, one-token decode on a
contiguous or a paged cache, and the paged serving paths (fused chunk
prefill and its decode-step scan).

The reference stacks layer parameters over a leading period axis for
``lax.scan``; here ``params["layers"]`` is a plain list with one dict
per layer, walked by a Python loop (``weights.from_reference`` unstacks
the reference's layout).  Likewise the cache is a list with one
:class:`~repro_torch.models.attention.KVCache` per layer (contiguous
rows, or a paged pool), with no recurrent or cross-attention fields,
updated in place.  SSM, hybrid and enc-dec stacks come with later
slices.

Each layer's FFN tail is an MLP or an MoE layer (``_ffn_kind``, the
reference's rule with ``moe_every``).  The MoE layer's capacity is per
group (batch row), so its routing depends on how tokens are grouped:
``lm_forward`` groups a row's S tokens, the fused chunk prefill the
chunk's T tokens, and a decode step (and so the scan prefill and the
scan verify) one token per row, which never drops.  Each path matches
the same path of the reference, not another path.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import Linear, init_linear
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod


def _check_supported(cfg: ModelConfig) -> None:
    if set(cfg.block_pattern) != {"attn"} or cfg.is_enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: only attention-only stacks (dense or MoE) are ported")


def _ffn_kind(cfg: ModelConfig, j: int) -> str:
    """FFN flavour of position j within a period of the block pattern."""
    if cfg.moe is not None and j % cfg.moe_every == 0:
        return "moe"
    if cfg.d_ff > 0:
        return "mlp"
    return "none"


def _norm(cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return L.init_layernorm, L.layernorm
    return L.init_rmsnorm, L.rmsnorm


def _apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    _, f = _norm(cfg)
    return f(p, x, cfg.norm_eps)


def _init_layer(gen: torch.Generator, cfg: ModelConfig, i: int) -> dict:
    init_n, _ = _norm(cfg)
    p: dict[str, Any] = {"norm1": init_n(cfg.d_model, gen.device),
                         "attn": attn_mod.init_attention(gen, cfg)}
    fk = _ffn_kind(cfg, i % len(cfg.block_pattern))
    if fk != "none":
        p["norm2"] = init_n(cfg.d_model, gen.device)
    if fk == "mlp":
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation)
    elif fk == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg)
    return p


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Full LM parameter tree on ``gen``'s device, drawn from ``gen``."""
    _check_supported(cfg)
    init_n, _ = _norm(cfg)
    p: dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model),
        "layers": [_init_layer(gen, cfg, i) for i in range(cfg.num_layers)],
        "final_norm": init_n(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                   role="lm_head")
    return p


def _head(params: dict) -> Linear:
    return params.get("lm_head") or Linear(params["embed"].w, role="lm_head")


# ------------------------------------------------------------- forward

def _block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, positions, *,
               causal: bool) -> torch.Tensor:
    h = _apply_norm(cfg, p["norm1"], x)
    return x + attn_mod.attention_fwd(p["attn"], cfg, h, positions,
                                      causal=causal,
                                      rope=cfg.pos_embed == "rope")


def _apply_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor | float]:
    """norm2 + MLP or MoE residual tail of one layer -> (x, MoE aux loss,
    0.0 for an MLP).  An MLP is position-wise; an MoE layer routes each
    batch row of x as one group (see the module docstring)."""
    if "moe" in p:
        h = _apply_norm(cfg, p["norm2"], x)
        y, aux = moe_mod.apply_moe(p["moe"], cfg, h)
        return x + y, aux
    if "mlp" in p:
        h = _apply_norm(cfg, p["norm2"], x)
        x = x + L.apply_mlp(p["mlp"], h, cfg.activation)
    return x, 0.0


def _layer_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, positions=None,
               *, causal: bool) -> tuple[torch.Tensor, torch.Tensor | float]:
    return _apply_ffn(p, cfg, _block_fwd(p, cfg, x, positions, causal=causal))


def _sinusoidal(seq: int, d: int, offset: int = 0,
                device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    inv = 1.0 / (10_000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                           device=device) / d))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(torch.bfloat16)


def _stack_fwd(layers: list, cfg: ModelConfig, x: torch.Tensor,
               positions=None, *, causal: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The layers in order -> (x, the MoE aux losses summed over layers,
    f32)."""
    _check_supported(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layers:
        x, a = _layer_fwd(p, cfg, x, positions, causal=causal)
        if isinstance(a, torch.Tensor):
            aux = aux + a
    return x, aux


def lm_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
               last_only: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V) f32, MoE aux loss summed over
    layers, 0.0 for a dense stack).  Attention goes through
    ``ops.attention`` (the flash-attention kernel on the card).
    ``last_only`` unembeds only the final position."""
    b, s = tokens.shape
    x = L.apply_embedding(params["embed"], tokens)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(s, cfg.d_model, device=x.device)[None]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x, aux = _stack_fwd(params["layers"], cfg, x, positions, causal=True)
    x = _apply_norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    return L.apply_unembed(_head(params), x), aux


# -------------------------------------------------------------- decode

def init_cache(params: dict, cfg: ModelConfig, batch: int, max_len: int, *,
               quantized_kv: bool = False, block_size: int | None = None,
               num_blocks: int | None = None, device="cuda") -> list:
    """One KV cache per layer: with ``block_size``/``num_blocks`` a paged
    pool (num_blocks, Hkv, block_size, hd), whose slot -> block mapping
    lives host-side in ``serving.kvcache``; otherwise contiguous rows
    (batch, Hkv, min(max_len, sliding_window), hd)."""
    del params
    _check_supported(cfg)
    if (block_size is None) != (num_blocks is None):
        raise ValueError("paged cache needs both block_size and num_blocks")
    if block_size is not None:
        return [attn_mod.init_paged_kv_cache(num_blocks, cfg, block_size,
                                             quantized=quantized_kv,
                                             device=device)
                for _ in range(cfg.num_layers)]
    return [attn_mod.init_kv_cache(batch, cfg, max_len, quantized=quantized_kv,
                                   device=device)
            for _ in range(cfg.num_layers)]


def _is_quantized(cache: list) -> bool:
    return any(c.k_scale is not None for c in cache)


def lm_decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                   pos, cache: list, *,
                   block_tables: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, list]:
    """token: (B, 1); pos: a scalar shared by all rows (an int, or a 0-d
    tensor) or (B,) int32 per-slot positions; ``block_tables`` (B, MB)
    int32 selects the paged cache (per-slot positions required), else
    the cache is contiguous.  -> (logits (B, 1, V) f32, cache updated in
    place)."""
    _check_supported(cfg)
    x = L.apply_embedding(params["embed"], token)
    per_row = isinstance(pos, torch.Tensor) and pos.dim() > 0
    pos_tensors = None
    if not per_row:
        pos = attn_mod._as_int(pos)
        if block_tables is None:       # shared by every layer's cache
            pos_tensors = attn_mod.scalar_pos_tensors(
                cfg, pos, token.shape[0], cache[0].capacity, x.device)
    if cfg.pos_embed == "sinusoidal":
        if per_row:
            x = x + torch.stack([_sinusoidal(1, cfg.d_model, offset=int(o),
                                             device=x.device) for o in pos])
        else:
            x = x + _sinusoidal(1, cfg.d_model, offset=pos,
                                device=x.device)[None]
    rope = cfg.pos_embed == "rope"
    new = []
    for p, c in zip(params["layers"], cache):
        h = _apply_norm(cfg, p["norm1"], x)
        y, c = attn_mod.attention_decode(p["attn"], cfg, h, pos, c, rope=rope,
                                         block_tables=block_tables,
                                         pos_tensors=pos_tensors)
        new.append(c)
        x, _ = _apply_ffn(p, cfg, x + y)
    x = _apply_norm(cfg, params["final_norm"], x)
    return L.apply_unembed(_head(params), x), new


def prefill_fused_eligible(cfg: ModelConfig, *,
                           quantized_kv: bool = False) -> bool:
    """True when a prompt chunk can take the fused paged prefill kernels:
    every layer is plain self-attention (bf16 and Q8_0 pools alike)."""
    del quantized_kv
    return set(cfg.block_pattern) == {"attn"}


def prefill_path(cfg: ModelConfig, *, quantized_kv: bool = False,
                 batch: int = 1, fused: bool = True) -> str:
    """Which prefill path a chunk runs: ``"fused"`` (one kernel launch per
    layer per chunk) or ``"scan"`` (one decode step per token).  The
    scheduler's launch accounting derives from the same call."""
    if (fused and batch == 1
            and prefill_fused_eligible(cfg, quantized_kv=quantized_kv)):
        return "fused"
    return "scan"


def _lm_prefill_chunk_fused(params: dict, cfg: ModelConfig,
                            tokens: torch.Tensor, pos0, cache: list,
                            block_tables: torch.Tensor, *,
                            last_only: bool = True
                            ) -> tuple[torch.Tensor, list]:
    """The whole chunk as one forward over the paged pool per layer
    (``attention_prefill_paged``); an MoE layer routes the chunk as one
    group of T tokens.  Returns the
    last position's logits (1, 1, V), or every position's (1, C, V) with
    ``last_only=False`` (verification needs the target's choice after
    each proposed token)."""
    t = tokens.shape[1]
    pos0 = attn_mod._as_int(pos0)
    x = L.apply_embedding(params["embed"], tokens)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(t, cfg.d_model, offset=pos0, device=x.device)[None]
    rope = cfg.pos_embed == "rope"
    new = []
    for p, c in zip(params["layers"], cache):
        h = _apply_norm(cfg, p["norm1"], x)
        y, c = attn_mod.attention_prefill_paged(p["attn"], cfg, h, pos0, c,
                                                block_tables, rope=rope)
        new.append(c)
        x, _ = _apply_ffn(p, cfg, x + y)
    x = _apply_norm(cfg, params["final_norm"], x[:, -1:] if last_only else x)
    return L.apply_unembed(_head(params), x), new


def _chunk_positions(pos0, b: int, device) -> torch.Tensor:
    """(B,) int32 first positions of a chunk on ``device``."""
    if isinstance(pos0, torch.Tensor):
        return pos0.to(device=device, dtype=torch.int32)
    return torch.full((b,), int(pos0), dtype=torch.int32, device=device)


def lm_prefill_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                     pos0, cache: list, *, block_tables: torch.Tensor,
                     fused: bool = True) -> tuple[torch.Tensor, list]:
    """Prefill of one chunk: tokens (B, C) at positions pos0 .. pos0+C-1
    (pos0: (B,) int tensor, or an int for B = 1); returns the last
    position's logits (B, 1, V) and the cache.

    * **fused** (default when eligible, batch 1): one fused paged-prefill
      kernel per layer, causal within the chunk, KV written in place.
    * **decode-step scan**: :func:`lm_decode_step` once per token, the
      reference oracle and the ``fused=False`` path."""
    _check_supported(cfg)
    b, c = tokens.shape
    if prefill_path(cfg, quantized_kv=_is_quantized(cache), batch=b,
                    fused=fused) == "fused":
        return _lm_prefill_chunk_fused(params, cfg, tokens, pos0, cache,
                                       block_tables)
    pos = _chunk_positions(pos0, b, tokens.device)
    logits = None
    for i in range(c):
        logits, cache = lm_decode_step(params, cfg, tokens[:, i:i + 1],
                                       pos + i, cache,
                                       block_tables=block_tables)
    return logits, cache


def lm_verify_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    pos0, cache: list, *, block_tables: torch.Tensor,
                    fused: bool = True) -> tuple[torch.Tensor, list]:
    """Verification launch for speculative decoding: tokens (B, C) at
    positions pos0 .. pos0+C-1 -> (logits (B, C, V), cache).

    The same math as :func:`lm_prefill_chunk` (the fused chunk when
    eligible, the decode-step scan otherwise), but every chunk position
    is unembedded.  On the scan path position ``j``'s logits are exactly
    those of feeding the chunk token by token through
    :func:`lm_decode_step`, so scan-verified speculation gives the plain
    decode's tokens bit for bit."""
    _check_supported(cfg)
    b, c = tokens.shape
    if prefill_path(cfg, quantized_kv=_is_quantized(cache), batch=b,
                    fused=fused) == "fused":
        return _lm_prefill_chunk_fused(params, cfg, tokens, pos0, cache,
                                       block_tables, last_only=False)
    pos = _chunk_positions(pos0, b, tokens.device)
    logits = []
    for i in range(c):
        lg, cache = lm_decode_step(params, cfg, tokens[:, i:i + 1], pos + i,
                                   cache, block_tables=block_tables)
        logits.append(lg[:, 0])
    return torch.stack(logits, dim=1), cache


# ---------------------------------------------------- slot cache surgery
# The reference carves a batch-1 view of recurrent and cross rows out of
# the slot-batched cache for chunked prefill.  A pure-attention paged
# cache has no per-slot rows (the block table isolates the slot), so
# these are the identity.

def cache_slot_view(cache: list, slot) -> list:
    del slot
    return cache


def cache_slot_merge(cache: list, local: list, slot) -> list:
    del cache, slot
    return local


def cache_slot_reset(cache: list, slot) -> list:
    del slot
    return cache
