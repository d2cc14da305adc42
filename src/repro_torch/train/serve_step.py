"""Serving-step factories: prefill, single-token decode and the greedy
generation loop (``repro.train.serve_step``).

The reference's plain generation path on a contiguous KV cache: the
prompt is fed one token at a time through :func:`make_decode`'s step,
then greedy tokens follow.  An encoder-decoder model takes
``enc_embeds`` (the stub frontend's frame embeddings): ``make_prefill``
reads them from its batch, ``make_cache`` runs the encoder once into
contiguous cross rows.  A vision config's ``make_prefill`` batch may
carry ``prefix_embeds``, the patch embeddings prepended to the text.  On the card each step's bf16-cache attention
is the ``flash_decode`` kernel and a quantized linear its matmul kernel;
the step position is a host int and the next token stays on the card, so
the loop never waits on the device.  Every factory runs on the card
(``device="cuda"``) unless the caller asks for the CPU; the parameters
must already live on that device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import init_cache, lm_decode_step, lm_forward


def make_prefill(cfg: ModelConfig, *, device="cuda"):
    """``prefill(params, {"tokens": (B, S)[, "enc_embeds": (B, S_enc, d)]
    [, "prefix_embeds": (B, P, d)]}) -> (B, V)`` f32 logits of the last
    position (the head runs on that position only)."""
    device = resolve_device(device)

    def prefill(params, batch: dict[str, Any]) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=device)
        enc, prefix = (batch.get(name) for name in ("enc_embeds",
                                                    "prefix_embeds"))
        if enc is not None:
            enc = torch.as_tensor(enc, device=device)
        if prefix is not None:
            prefix = torch.as_tensor(prefix, device=device)
        logits, _ = lm_forward(params, cfg, tokens, enc_embeds=enc,
                               prefix_embeds=prefix, last_only=True)
        return logits[:, -1]
    return prefill


def make_decode(cfg: ModelConfig, *, device="cuda"):
    """``decode(params, token (B, 1), pos, cache) -> (next (B, 1) int32,
    logits (B, 1, V) f32, cache)``; ``pos`` is a scalar shared by all rows
    or (B,) per-row positions, and the cache is updated in place."""
    device = resolve_device(device)

    def decode(params, token, pos, cache):
        token = torch.as_tensor(token, device=device)
        logits, cache = lm_decode_step(params, cfg, token, pos, cache)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token[:, None], logits, cache
    return decode


def make_cache(params, cfg: ModelConfig, batch: int, max_len: int, *,
               quantized_kv: bool = False, enc_embeds=None,
               device="cuda") -> list:
    """One contiguous (bf16, or Q8_0 with ``quantized_kv``) KV cache per
    layer, ``min(max_len, sliding_window)`` slots per row; with
    ``enc_embeds`` each layer also holds its cross rows."""
    return init_cache(params, cfg, batch, max_len, quantized_kv=quantized_kv,
                      enc_embeds=enc_embeds, device=device)


def greedy_generate(params, cfg: ModelConfig, prompt, steps: int, *,
                    max_len: int = 0, enc_embeds=None,
                    device="cuda") -> torch.Tensor:
    """Reference generation loop (prefill via repeated decode): returns
    (B, S + steps) int32 tokens, the prompt followed by ``steps`` greedy
    tokens.  An encoder-decoder model needs ``enc_embeds``."""
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device).to(torch.int32)
    b, s = prompt.shape
    max_len = max_len or (s + steps)
    cache = make_cache(params, cfg, b, max_len, enc_embeds=enc_embeds,
                       device=device)
    decode = make_decode(cfg, device=device)
    tok = prompt[:, :1]
    out = [tok]
    with torch.no_grad():
        for t in range(s + steps - 1):
            nxt, _, cache = decode(params, tok, t, cache)
            tok = prompt[:, t + 1:t + 2] if t + 1 < s else nxt
            out.append(tok)
    return torch.cat(out, dim=1)
