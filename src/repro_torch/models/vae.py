"""SD VAE decoder (latent -> image), im2col convs (``repro.models.vae``).

Its single-head bottleneck attention is a plain f32 product, as in the
reference (no kernel).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import SD15_VAE, TINY_VAE, VAEConfig  # noqa: F401
from repro_torch.core.qlinear import apply_linear, init_linear, record_matmul
from repro_torch.models import layers as L
from repro_torch.models.unet import (apply_conv, groupnorm, init_conv,
                                     init_groupnorm, upsample2x)


def _init_res(gen: torch.Generator, in_ch: int, out_ch: int) -> dict:
    p = {"norm1": init_groupnorm(in_ch, gen.device),
         "conv1": init_conv(gen, in_ch, out_ch),
         "norm2": init_groupnorm(out_ch, gen.device),
         "conv2": init_conv(gen, out_ch, out_ch)}
    if in_ch != out_ch:
        p["skip"] = init_conv(gen, in_ch, out_ch, k=1)
    return p


def _apply_res(p: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    h = apply_conv(p["conv1"], L.silu(groupnorm(p["norm1"], x, groups)))
    h = apply_conv(p["conv2"], L.silu(groupnorm(p["norm2"], h, groups)))
    return (apply_conv(p["skip"], x) if "skip" in p else x) + h


def init_vae_decoder(gen: torch.Generator, cfg: VAEConfig) -> dict:
    top = cfg.base * cfg.channel_mult[-1]
    p: dict[str, Any] = {
        "conv_in": init_conv(gen, cfg.z_channels, top),
        "mid_res1": _init_res(gen, top, top),
        "mid_qkv": init_linear(gen, top, 3 * top, role="attn_qkv"),
        "mid_proj": init_linear(gen, top, top, role="attn_out"),
        "mid_norm": init_groupnorm(top, gen.device),
        "mid_res2": _init_res(gen, top, top),
    }
    ups = []
    cur = top
    for lvl, mult in reversed(list(enumerate(cfg.channel_mult))):
        out_ch = cfg.base * mult
        blks = [_init_res(gen, cur if i == 0 else out_ch, out_ch)
                for i in range(cfg.num_res_blocks + 1)]
        cur = out_ch
        up = init_conv(gen, cur, cur) if lvl != 0 else None
        ups.append({"res": blks, "up": up})
    p["ups"] = ups
    p["norm_out"] = init_groupnorm(cur, gen.device)
    p["conv_out"] = init_conv(gen, cur, cfg.out_channels)
    return p


def apply_vae_decoder(p: dict, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """z: (B, h, w, 4) latent -> (B, 8h, 8w, 3) image in [-1, 1]."""
    h = apply_conv(p["conv_in"], z / L._const(cfg.scale_factor, z))
    h = _apply_res(p["mid_res1"], h, cfg.groups)
    b, hh, ww, c = h.shape
    xn = groupnorm(p["mid_norm"], h, cfg.groups).reshape(b, hh * ww, c)
    q, k, v = apply_linear(p["mid_qkv"], xn).chunk(3, dim=-1)
    record_matmul("vae_attn_scores", "activation", hh * ww, hh * ww, c,
                  count=b, act_act=True)
    record_matmul("vae_attn_pv", "activation", hh * ww, c, hh * ww,
                  count=b, act_act=True)
    att = torch.softmax(
        torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * c ** -0.5, -1)
    xn = torch.einsum("bqk,bkc->bqc", att, v.float())
    h = h + apply_linear(p["mid_proj"], xn.to(h.dtype)).reshape(b, hh, ww, c)
    h = _apply_res(p["mid_res2"], h, cfg.groups)
    for blk in p["ups"]:
        for r in blk["res"]:
            h = _apply_res(r, h, cfg.groups)
        if blk["up"] is not None:
            h = apply_conv(blk["up"], upsample2x(h))
    h = L.silu(groupnorm(p["norm_out"], h, cfg.groups))
    return torch.tanh(apply_conv(p["conv_out"], h))


class VAEDecoder(nn.Module):
    """``apply_vae_decoder`` over a parameter tree, as a module."""

    def __init__(self, params: dict, cfg: VAEConfig):
        super().__init__()
        self.params, self.cfg = params, cfg

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return apply_vae_decoder(self.params, self.cfg, z)
