"""The LM stack (``repro.models.transformer``): dense, MoE,
encoder-decoder (whisper), recurrent (xLSTM) and hybrid (jamba)
decoders — parameters, the full-sequence forward, one-token decode on a
contiguous or a paged cache, and the paged serving paths (fused chunk
prefill and its decode-step scan).

Each layer's mixer is the block kind at its position in the repeating
``block_pattern`` (``attn``, ``mamba``, ``mlstm`` or ``slstm``, from
``models.ssm``); its parameters sit under that key of the layer's dict.
The reference stacks layer parameters over a leading period axis for
``lax.scan``; here ``params["layers"]`` (and an encoder's
``params["encoder"]["layers"]``) is a plain list with one dict per
layer, walked by a Python loop (``weights.from_reference`` unstacks the
reference's layout).  Likewise the cache is a list with one entry per
layer, updated in place: for an attention layer a
:class:`~repro_torch.models.attention.KVCache` (contiguous rows, or a
paged pool), or for an encoder-decoder stack a :class:`LayerCache` that
adds the layer's cross-attention keys and values, as contiguous rows
precomputed from ``enc_embeds`` or as a paged bf16 cross pool that
:func:`write_cross_kv` fills; for a recurrent layer its decode state
(``ssm.MambaState``, ``MLSTMState`` or ``SLSTMState``), one row per
batch row or serving slot whichever the KV layout.  A recurrent stack
prefills by the decode-step scan (``prefill_path``).

Each layer's FFN tail is an MLP or an MoE layer (``_ffn_kind``, the
reference's rule with ``moe_every``).  The MoE layer's capacity is per
group (batch row), so its routing depends on how tokens are grouped:
``lm_forward`` groups a row's S tokens, the fused chunk prefill the
chunk's T tokens, and a decode step (and so the scan prefill and the
scan verify) one token per row, which never drops.  Each path matches
the same path of the reference, not another path.

A vision-language config (qwen2-vl) rotates by M-RoPE on every path, and
``lm_forward(prefix_embeds=...)`` prepends its stub frontend's patch
embeddings to the text.  For training, ``lm_forward(remat=...)``
recomputes each period of layers in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
does.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import OffloadPolicy
from repro_torch.core.qlinear import (Linear, apply_linear, init_linear,
                                      quantize_params)
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod


class _Recurrent(NamedTuple):
    """A recurrent block kind's functions (``models.ssm``)."""
    init: Any      # (gen, cfg) -> params
    fwd: Any       # (params, cfg, x (B, S, d)) -> (B, S, d)
    decode: Any    # (params, cfg, x (B, 1, d), state) -> (y, state)
    state: Any     # (batch, cfg, device) -> a fresh state


_RECURRENT = {
    "mamba": _Recurrent(ssm_mod.init_mamba, ssm_mod.mamba_fwd,
                        ssm_mod.mamba_decode, ssm_mod.init_mamba_state),
    "mlstm": _Recurrent(ssm_mod.init_mlstm, ssm_mod.mlstm_fwd,
                        ssm_mod.mlstm_decode, ssm_mod.init_mlstm_state),
    "slstm": _Recurrent(ssm_mod.init_slstm, ssm_mod.slstm_fwd,
                        ssm_mod.slstm_decode, ssm_mod.init_slstm_state),
}
_STATES = (ssm_mod.MambaState, ssm_mod.MLSTMState, ssm_mod.SLSTMState)


def _check_supported(cfg: ModelConfig) -> None:
    unknown = set(cfg.block_pattern) - {"attn", *_RECURRENT}
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {sorted(unknown)}")


def _block_kind(cfg: ModelConfig, i: int) -> str:
    """The block kind of layer ``i``: its position in the period."""
    return cfg.block_pattern[i % len(cfg.block_pattern)]


def _mixer(p: dict) -> str:
    """The block kind of a layer's parameters."""
    return next(k for k in ("attn", *_RECURRENT) if k in p)


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


def _init_layer(gen: torch.Generator, cfg: ModelConfig, i: int, *,
                cross: bool = False) -> dict:
    init_n, _ = _norm(cfg)
    kind = _block_kind(cfg, i)
    p: dict[str, Any] = {"norm1": init_n(cfg.d_model, gen.device)}
    if kind == "attn":
        p["attn"] = attn_mod.init_attention(gen, cfg)
    else:
        p[kind] = _RECURRENT[kind].init(gen, cfg)
    if cross:
        p["norm_x"] = init_n(cfg.d_model, gen.device)
        p["cross"] = attn_mod.init_attention(gen, cfg)
    fk = _ffn_kind(cfg, i % len(cfg.block_pattern))
    if fk != "none":
        p["norm2"] = init_n(cfg.d_model, gen.device)
    if fk == "mlp":
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation)
    elif fk == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg)
    return p


def init_lm(gen: torch.Generator, cfg: ModelConfig, *,
            policy: OffloadPolicy | None = None) -> dict:
    """Full LM parameter tree on ``gen``'s device, drawn from ``gen``.
    With ``policy`` each tensor is quantized as soon as it is drawn (the
    embedding, each layer, the head), so that at most one layer is ever
    held in bf16: the same tree as ``quantize_params(init_lm(gen, cfg),
    policy)``."""
    _check_supported(cfg)
    init_n, _ = _norm(cfg)

    def q(tree):
        return tree if policy is None else quantize_params(tree, policy)
    p: dict[str, Any] = {
        "embed": q(L.init_embedding(gen, cfg.vocab_size, cfg.d_model)),
        "layers": [q(_init_layer(gen, cfg, i, cross=cfg.is_enc_dec))
                   for i in range(cfg.num_layers)],
        "final_norm": init_n(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = q(init_linear(gen, cfg.d_model, cfg.vocab_size,
                                     role="lm_head"))
    if cfg.is_enc_dec:
        # The encoder's blocks are plain attention + MLP at the same width.
        p["encoder"] = {
            "layers": [q(_init_layer(gen, cfg, 0))
                       for _ in range(cfg.encoder_layers)],
            "final_norm": init_n(cfg.d_model, gen.device),
        }
    return p


def _head(params: dict) -> Linear:
    return params.get("lm_head") or Linear(params["embed"].w, role="lm_head")


# ------------------------------------------------------------- forward

def _block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, positions, *,
               causal: bool, enc_out: torch.Tensor | None = None
               ) -> torch.Tensor:
    h = _apply_norm(cfg, p["norm1"], x)
    kind = _mixer(p)
    if kind == "attn":
        x = x + attn_mod.attention_fwd(p["attn"], cfg, h, positions,
                                       causal=causal,
                                       rope=cfg.pos_embed == "rope")
    else:
        x = x + _RECURRENT[kind].fwd(p[kind], cfg, h)
    if enc_out is not None and "cross" in p:
        h = _apply_norm(cfg, p["norm_x"], x)
        x = x + attn_mod.attention_fwd(p["cross"], cfg, h, positions,
                                       causal=False, kv_x=enc_out)
    return x


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
               *, causal: bool, enc_out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor | float]:
    return _apply_ffn(p, cfg, _block_fwd(p, cfg, x, positions, causal=causal,
                                         enc_out=enc_out))


def _sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings (..., d) bf16 of the positions ``pos`` (any
    shape, any number type), computed in f32 as the reference does.  The
    frequencies' power is taken in f64 and rounded once to f32, as XLA's
    correctly rounded f32 power gives it (torch's f32 power is an ulp off
    at a few exponents, which moves an embedding's bf16 bits at large
    positions)."""
    e = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device) / d
    inv = 1.0 / (10_000.0 ** e.double()).float()
    ang = pos.to(torch.float32)[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(torch.bfloat16)


def _sinusoidal(seq: int, d: int, offset: int = 0,
                device=None) -> torch.Tensor:
    """(seq, d) embeddings of positions ``offset .. offset + seq - 1``."""
    return _sinusoidal_at(torch.arange(seq, dtype=torch.float32,
                                       device=device) + offset, d)


# The products that ``remat="block"`` keeps, as the reference's
# ``dots_with_no_batch_dims_saveable`` keeps its dots without batch
# dimensions: the linears' 2-D matmuls.  Everything else of a period
# (attention included) is recomputed in the backward pass.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op in _SAVED_DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT = ("none", "block", "full")


def _stack_fwd(layers: list, cfg: ModelConfig, x: torch.Tensor,
               positions=None, *, causal: bool,
               enc_out: torch.Tensor | None = None, remat: str = "none"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The layers in order -> (x, the MoE aux losses summed over layers,
    f32).  ``remat`` ``"block"`` or ``"full"`` wraps each period of
    ``len(block_pattern)`` layers in ``torch.utils.checkpoint``: "block"
    saves the linears' matmul outputs and recomputes the rest, "full"
    saves nothing but the period's input; "none" recomputes nothing."""
    _check_supported(cfg)
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")

    def period(x, aux, group):
        for p in group:
            x, a = _layer_fwd(p, cfg, x, positions, causal=causal,
                              enc_out=enc_out)
            if isinstance(a, torch.Tensor):
                aux = aux + a
        return x, aux

    plen = len(cfg.block_pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, len(layers), plen):
        group = layers[i:i + plen]
        if remat == "none" or not torch.is_grad_enabled():
            x, aux = period(x, aux, group)
        else:
            kw = {}
            if remat == "block":
                kw["context_fn"] = functools.partial(
                    _ckpt.create_selective_checkpoint_contexts, _save_dots)
            x, aux = _ckpt.checkpoint(period, x, aux, group,
                                      use_reentrant=False, **kw)
    return x, aux


def encoder_forward(params: dict, cfg: ModelConfig,
                    enc_embeds: torch.Tensor, *,
                    remat: str = "none") -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings (B, S_enc,
    d) bf16 (the stub frontend's output): sinusoidal positions, non-causal
    self-attention, the encoder's final norm."""
    b, s, _ = enc_embeds.shape
    x = enc_embeds + _sinusoidal(s, cfg.d_model, device=enc_embeds.device)[None]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x, _ = _stack_fwd(params["encoder"]["layers"], cfg, x, positions,
                      causal=False, remat=remat)
    return _apply_norm(cfg, params["encoder"]["final_norm"], x)


def lm_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
               enc_embeds: torch.Tensor | None = None,
               prefix_embeds: torch.Tensor | None = None,
               remat: str = "none",
               last_only: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V) f32, MoE aux loss summed over
    layers, 0.0 for a dense stack).  Attention goes through
    ``ops.attention`` (the flash-attention kernel on the card).  An
    encoder-decoder stack needs ``enc_embeds`` (B, S_enc, d): each decoder
    layer attends to the encoder's output after its self-attention.
    ``prefix_embeds`` (B, P, d), a vision config's patch embeddings, is
    prepended to the token embeddings: positions run over prefix and
    text, and the prefix is sliced off before the head, so the logits
    are the text's.  ``remat`` is the backward's recomputation
    (:func:`_stack_fwd`).  ``last_only`` unembeds only the final
    position."""
    b, s = tokens.shape
    x = L.apply_embedding(params["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        s = x.shape[1]
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(s, cfg.d_model, device=x.device)[None]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    enc_out = None
    if cfg.is_enc_dec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             "enc_embeds")
        enc_out = encoder_forward(params, cfg, enc_embeds, remat=remat)
    x, aux = _stack_fwd(params["layers"], cfg, x, positions, causal=True,
                        enc_out=enc_out, remat=remat)
    x = _apply_norm(cfg, params["final_norm"], x)
    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    if last_only:
        x = x[:, -1:]
    return L.apply_unembed(_head(params), x), aux


# -------------------------------------------------------------- decode

class LayerCache(NamedTuple):
    """One decoder layer's cache of an encoder-decoder stack: the
    self-attention ``kv`` and the cross-attention keys and values,
    contiguous rows (B, Hkv, S_enc, hd) or a paged bf16 pool (NBc, Hkv,
    cbs, hd).  The cross fields are read-only in decode and prefill."""
    kv: attn_mod.KVCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def _kv(c) -> attn_mod.KVCache | None:
    """The self-attention KV cache of one layer's entry (None for a
    recurrent layer's state)."""
    if isinstance(c, LayerCache):
        return c.kv
    return c if isinstance(c, attn_mod.KVCache) else None


def _kv_caches(cache: list) -> list:
    return [kv for kv in map(_kv, cache) if kv is not None]


def init_cache(params: dict, cfg: ModelConfig, batch: int, max_len: int, *,
               quantized_kv: bool = False,
               enc_embeds: torch.Tensor | None = None,
               block_size: int | None = None,
               num_blocks: int | None = None,
               cross_block_size: int | None = None,
               cross_num_blocks: int | None = None, device="cuda") -> list:
    """One cache per layer.  An attention layer gets, with
    ``block_size``/``num_blocks``, a paged KV pool (num_blocks, Hkv,
    block_size, hd), whose slot -> block mapping lives host-side in
    ``serving.kvcache``; otherwise contiguous rows (batch, Hkv,
    min(max_len, sliding_window), hd).  A recurrent layer gets its fresh
    decode state of ``batch`` rows either way (one per serving slot).

    An encoder-decoder stack gets a :class:`LayerCache` per layer.  Its
    cross KV is by default computed here from ``enc_embeds`` (B_enc,
    S_enc, d): the encoder runs once and each layer's K/V projections
    become contiguous rows.  With ``cross_block_size`` /
    ``cross_num_blocks`` it is instead an empty paged bf16 pool
    (cross_num_blocks, Hkv, cross_block_size, hd) per layer, which
    :func:`write_cross_kv` fills (the ASR engine encodes incrementally)."""
    _check_supported(cfg)
    if (block_size is None) != (num_blocks is None):
        raise ValueError("paged cache needs both block_size and num_blocks")
    if (cross_block_size is None) != (cross_num_blocks is None):
        raise ValueError("paged cross cache needs both cross_block_size "
                         "and cross_num_blocks")
    paged_cross = cross_block_size is not None
    if paged_cross and not cfg.is_enc_dec:
        raise ValueError("cross pool requested for a non-enc-dec config")
    device = resolve_device(device)

    def layer(i: int):
        kind = _block_kind(cfg, i)
        if kind != "attn":
            return _RECURRENT[kind].state(batch, cfg, device)
        if block_size is not None:
            return attn_mod.init_paged_kv_cache(num_blocks, cfg, block_size,
                                                quantized=quantized_kv,
                                                device=device)
        return attn_mod.init_kv_cache(batch, cfg, max_len,
                                      quantized=quantized_kv, device=device)
    kvs = [layer(i) for i in range(cfg.num_layers)]
    if not cfg.is_enc_dec:
        return kvs
    if paged_cross:
        shape = (cross_num_blocks, cfg.num_kv_heads, cross_block_size, cfg.hd)
        return [LayerCache(kv, torch.zeros(shape, dtype=torch.bfloat16,
                                           device=device),
                           torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device))
                for kv in kvs]
    if enc_embeds is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder cache needs "
                         "enc_embeds (or a paged cross pool)")
    enc_out = encoder_forward(params, cfg, torch.as_tensor(enc_embeds,
                                                           device=device))

    def rows(lin):
        return _split(apply_linear(lin, enc_out), cfg)

    return [LayerCache(kv, rows(p["cross"]["wk"]), rows(p["cross"]["wv"]))
            for kv, p in zip(kvs, params["layers"])]


def _split(y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, Hkv*hd) -> (B, Hkv, S, hd)."""
    b, s, _ = y.shape
    return y.reshape(b, s, cfg.num_kv_heads, cfg.hd).transpose(1, 2)


def write_cross_kv(params: dict, cfg: ModelConfig, enc_out: torch.Tensor,
                   cross_table: torch.Tensor, cache: list) -> list:
    """Project one request's encoder output (1, S_enc, d) into its cross
    blocks: for every decoder layer the K/V projections are scattered, in
    place, into the blocks ``cross_table`` (MBc,) int32 lists of that
    layer's paged cross pool; the tail block's padding is zero (readers
    mask positions >= ``enc_len``)."""
    se = enc_out.shape[1]
    cbs = cache[0].cross_k.shape[2]
    mb = cross_table.shape[0]
    idx = cross_table.long()

    def to_blocks(y, pool):
        t = _split(y, cfg)[0]                              # (Hkv, S_enc, hd)
        t = F.pad(t, (0, 0, 0, mb * cbs - se))
        t = t.reshape(cfg.num_kv_heads, mb, cbs, cfg.hd).transpose(0, 1)
        return t.to(pool.dtype)

    for p, c in zip(params["layers"], cache):
        c.cross_k[idx] = to_blocks(apply_linear(p["cross"]["wk"], enc_out),
                                   c.cross_k)
        c.cross_v[idx] = to_blocks(apply_linear(p["cross"]["wv"], enc_out),
                                   c.cross_v)
    return cache


def _block_cross(p: dict, cfg: ModelConfig, x: torch.Tensor, c: LayerCache,
                 cross_tables: torch.Tensor | None) -> torch.Tensor:
    """Cross-attention residual of decode and the fused prefill: through
    the paged cross pool when ``cross_tables`` is given, else the
    contiguous rows."""
    h = _apply_norm(cfg, p["norm_x"], x)
    if cross_tables is not None:
        return x + attn_mod.cross_attention_paged(
            p["cross"], cfg, h, cross_tables, c.cross_k, c.cross_v,
            enc_len=cfg.encoder_seq)
    return x + attn_mod.cross_attention_decode(p["cross"], cfg, h,
                                               c.cross_k, c.cross_v)


def _is_quantized(cache: list) -> bool:
    return any(kv.k_scale is not None for kv in _kv_caches(cache))


def lm_decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                   pos, cache: list, *,
                   block_tables: torch.Tensor | None = None,
                   cross_tables: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, list]:
    """token: (B, 1); pos: a scalar shared by all rows (an int, or a 0-d
    tensor) or (B,) int32 per-slot positions; ``block_tables`` (B, MB)
    int32 selects the paged cache (per-slot positions required), else
    the cache is contiguous.  ``cross_tables`` (B, MBc) int32 selects an
    encoder-decoder stack's paged cross pool, else its contiguous cross
    rows are read.  A recurrent layer steps its state, whatever the
    position.  -> (logits (B, 1, V) f32, cache updated in place)."""
    _check_supported(cfg)
    x = L.apply_embedding(params["embed"], token)
    per_row = isinstance(pos, torch.Tensor) and pos.dim() > 0
    pos_tensors = None
    kvs = _kv_caches(cache)
    if not per_row:
        pos = attn_mod._as_int(pos)
        if block_tables is None and kvs:   # shared by every layer's cache
            pos_tensors = attn_mod.scalar_pos_tensors(
                cfg, pos, token.shape[0], kvs[0].capacity, x.device)
    if cfg.pos_embed == "sinusoidal":
        if per_row:                    # one computation over the rows
            x = x + _sinusoidal_at(pos.to(x.device), cfg.d_model)[:, None]
        else:
            x = x + _sinusoidal(1, cfg.d_model, offset=pos,
                                device=x.device)[None]
    rope = cfg.pos_embed == "rope"
    new = []
    for p, c in zip(params["layers"], cache):
        h = _apply_norm(cfg, p["norm1"], x)
        kind = _mixer(p)
        if kind == "attn":
            y, _ = attn_mod.attention_decode(p["attn"], cfg, h, pos, _kv(c),
                                             rope=rope,
                                             block_tables=block_tables,
                                             pos_tensors=pos_tensors)
        else:
            y, _ = _RECURRENT[kind].decode(p[kind], cfg, h, c)
        new.append(c)
        x = x + y
        if "cross" in p:
            x = _block_cross(p, cfg, x, c, cross_tables)
        x, _ = _apply_ffn(p, cfg, x)
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
                            block_tables: torch.Tensor,
                            cross_tables: torch.Tensor | None = None, *,
                            last_only: bool = True
                            ) -> tuple[torch.Tensor, list]:
    """The whole chunk as one forward over the paged pool per layer
    (``attention_prefill_paged``); an MoE layer routes the chunk as one
    group of T tokens, and an encoder-decoder layer adds one
    chunk-at-once cross-attention read.  Returns the
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
        y, _ = attn_mod.attention_prefill_paged(p["attn"], cfg, h, pos0,
                                                _kv(c), block_tables,
                                                rope=rope)
        new.append(c)
        x = x + y
        if "cross" in p:
            x = _block_cross(p, cfg, x, c, cross_tables)
        x, _ = _apply_ffn(p, cfg, x)
    x = _apply_norm(cfg, params["final_norm"], x[:, -1:] if last_only else x)
    return L.apply_unembed(_head(params), x), new


def _chunk_positions(pos0, b: int, device) -> torch.Tensor:
    """(B,) int32 first positions of a chunk on ``device``."""
    if isinstance(pos0, torch.Tensor):
        return pos0.to(device=device, dtype=torch.int32)
    return torch.full((b,), int(pos0), dtype=torch.int32, device=device)


def lm_prefill_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                     pos0, cache: list, *, block_tables: torch.Tensor,
                     cross_tables: torch.Tensor | None = None,
                     fused: bool = True) -> tuple[torch.Tensor, list]:
    """Prefill of one chunk: tokens (B, C) at positions pos0 .. pos0+C-1
    (pos0: (B,) int tensor, or an int for B = 1); returns the last
    position's logits (B, 1, V) and the cache.

    * **fused** (default when eligible, batch 1): one fused paged-prefill
      kernel per layer, causal within the chunk, KV written in place.
    * **decode-step scan**: :func:`lm_decode_step` once per token, the
      reference oracle and the ``fused=False`` path.

    ``cross_tables`` (1, MBc) selects an encoder-decoder stack's paged
    cross pool, as in :func:`lm_decode_step`."""
    _check_supported(cfg)
    b, c = tokens.shape
    if prefill_path(cfg, quantized_kv=_is_quantized(cache), batch=b,
                    fused=fused) == "fused":
        return _lm_prefill_chunk_fused(params, cfg, tokens, pos0, cache,
                                       block_tables, cross_tables)
    pos = _chunk_positions(pos0, b, tokens.device)
    logits = None
    for i in range(c):
        logits, cache = lm_decode_step(params, cfg, tokens[:, i:i + 1],
                                       pos + i, cache,
                                       block_tables=block_tables,
                                       cross_tables=cross_tables)
    return logits, cache


def lm_verify_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    pos0, cache: list, *, block_tables: torch.Tensor,
                    cross_tables: torch.Tensor | None = None,
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
                                       block_tables, cross_tables,
                                       last_only=False)
    pos = _chunk_positions(pos0, b, tokens.device)
    logits = []
    for i in range(c):
        lg, cache = lm_decode_step(params, cfg, tokens[:, i:i + 1], pos + i,
                                   cache, block_tables=block_tables,
                                   cross_tables=cross_tables)
        logits.append(lg[:, 0])
    return torch.stack(logits, dim=1), cache


# ---------------------------------------------------- slot cache surgery
# Chunked prefill runs at batch 1 for the slot being admitted.  Paged KV
# pools need no carving (the block table isolates the slot); contiguous
# cross rows and recurrent states are sliced to the slot's row, as views
# that the prefill updates in place.

def cache_slot_view(cache: list, slot: int, *,
                    paged_cross: bool = False) -> list:
    """Batch-1 view of ``slot``'s rows.  ``paged_cross`` passes a paged
    cross pool through (the slot's cross-table row isolates it)."""
    def view(c):
        if isinstance(c, _STATES):
            return type(c)(*(t[slot:slot + 1] for t in c))
        if isinstance(c, LayerCache) and not paged_cross:
            return c._replace(cross_k=c.cross_k[slot:slot + 1],
                              cross_v=c.cross_v[slot:slot + 1])
        return c
    return [view(c) for c in cache]


def cache_slot_merge(cache: list, local: list, slot: int) -> list:
    """Fold a batch-1 view back: the KV pools and the recurrent rows were
    updated in place and cross KV is read-only, so the full cache is the
    result."""
    del local, slot
    return cache


def cache_slot_reset(cache: list, slot: int) -> list:
    """A freshly admitted slot inherits nothing from its previous
    occupant: paged KV is masked by position, and every field of the
    slot's recurrent states is set to zero, in place.  Zero, as the
    reference writes, and not the fresh state: an mLSTM or sLSTM
    stabiliser ``m`` starts at -1e30 in ``init_cache`` but at 0 after a
    reset.  mLSTM's outputs do not depend on it; sLSTM's do (``h = o * c
    / max(n, 1)``), so a served xLSTM request differs from the same
    prompt through ``greedy_generate``, in both packages alike."""
    for c in cache:
        if isinstance(c, _STATES):
            for t in c:
                t[slot].zero_()
    return cache
