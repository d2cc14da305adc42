"""SD v1.5 / SD-Turbo U-Net (``repro.models.unet``).

Convolutions are im2col + mul_mat, as stable-diffusion.cpp lowers them,
so every conv is a role-tagged linear.  Latents are NHWC, as in the
reference; ``F.unfold`` on the NCHW view orders patch features
channel-major (C, kh, kw), the order of
``jax.lax.conv_general_dilated_patches``, so converted weights line up.
Attention blocks are spatial transformers with cross-attention to the
CLIP states.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SD15_UNET, TINY_UNET, UNetConfig  # noqa: F401
from repro_torch.core.qlinear import Linear, apply_linear, init_linear
from repro_torch.kernels import ops
from repro_torch.models import layers as L


# ---------------------------------------------------------------- conv

@dataclasses.dataclass
class Conv:
    """im2col conv: a Linear over (C, kh, kw)-ordered patches."""
    lin: Linear
    k: int = 3


def init_conv(gen: torch.Generator, in_ch: int, out_ch: int, k: int = 3, *,
              role: str = "conv") -> Conv:
    fan_in = in_ch * k * k
    w = (torch.randn((out_ch, fan_in), generator=gen, device=gen.device,
                     dtype=torch.float32) * fan_in ** -0.5).to(torch.bfloat16)
    b = torch.zeros((out_ch,), dtype=torch.bfloat16, device=gen.device)
    return Conv(Linear(w, b, role), k)


def im2col(x: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """(B, H, W, C) -> (B, H', W', C*k*k) patches, features (C, kh, kw),
    zero padding (k-1)//2."""
    if k == 1 and stride == 1:
        return x
    b, h, w, _ = x.shape
    pad = (k - 1) // 2
    cols = F.unfold(x.permute(0, 3, 1, 2), k, padding=pad, stride=stride)
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    return cols.transpose(1, 2).reshape(b, ho, wo, -1)


def apply_conv(p: Conv, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H', W', out_ch) via im2col + mul_mat."""
    return apply_linear(p.lin, im2col(x, p.k, stride))


# ------------------------------------------------------------ groupnorm

def init_groupnorm(ch: int, device=None) -> dict:
    return {"g": torch.ones((ch,), dtype=torch.float32, device=device),
            "b": torch.zeros((ch,), dtype=torch.float32, device=device)}


def groupnorm(p: dict, x: torch.Tensor, groups: int,
              eps: float = 1e-5) -> torch.Tensor:
    """Group norm over NHWC with f32 statistics, output in x's dtype."""
    b, h, w, c = x.shape
    g = min(groups, c)
    xf = x.float().reshape(b, h, w, g, c // g)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xn * p["g"] + p["b"]).to(x.dtype)


# ------------------------------------------------------------ res block

def init_resblock(gen: torch.Generator, in_ch: int, out_ch: int,
                  time_dim: int, groups: int) -> dict:
    p = {
        "norm1": init_groupnorm(in_ch, gen.device),
        "conv1": init_conv(gen, in_ch, out_ch),
        "time": init_linear(gen, time_dim, out_ch, role="time_embed",
                            bias=True),
        "norm2": init_groupnorm(out_ch, gen.device),
        "conv2": init_conv(gen, out_ch, out_ch),
    }
    if in_ch != out_ch:
        p["skip"] = init_conv(gen, in_ch, out_ch, k=1)
    return p


def apply_resblock(p: dict, x: torch.Tensor, temb: torch.Tensor,
                   groups: int) -> torch.Tensor:
    h = apply_conv(p["conv1"], L.silu(groupnorm(p["norm1"], x, groups)))
    h = h + apply_linear(p["time"], L.silu(temb))[:, None, None, :]
    h = apply_conv(p["conv2"], L.silu(groupnorm(p["norm2"], h, groups)))
    skip = apply_conv(p["skip"], x) if "skip" in p else x
    return skip + h


# ------------------------------------------- spatial transformer block

def init_spatial_transformer(gen: torch.Generator, ch: int,
                             cfg: UNetConfig) -> dict:
    inner = ch
    dev = gen.device
    return {
        "norm": init_groupnorm(ch, dev),
        "proj_in": init_conv(gen, ch, inner, k=1),
        "ln1": L.init_layernorm(inner, dev),
        "q1": init_linear(gen, inner, inner, role="attn_qkv"),
        "k1": init_linear(gen, inner, inner, role="attn_qkv"),
        "v1": init_linear(gen, inner, inner, role="attn_qkv"),
        "o1": init_linear(gen, inner, inner, role="attn_out"),
        "ln2": L.init_layernorm(inner, dev),
        "q2": init_linear(gen, inner, inner, role="attn_qkv"),
        "k2": init_linear(gen, cfg.context_dim, inner, role="attn_qkv"),
        "v2": init_linear(gen, cfg.context_dim, inner, role="attn_qkv"),
        "o2": init_linear(gen, inner, inner, role="attn_out"),
        "ln3": L.init_layernorm(inner, dev),
        "ff1": init_linear(gen, inner, inner * 8, role="mlp_up"),
        "ff2": init_linear(gen, inner * 4, inner, role="mlp_down"),
        "proj_out": init_conv(gen, inner, ch, k=1),
    }


def _mha(q_p, k_p, v_p, o_p, x, ctx, heads: int) -> torch.Tensor:
    b, n, c = x.shape
    hd = c // heads

    def split(t):
        return t.reshape(b, -1, heads, hd).transpose(1, 2)
    q = split(apply_linear(q_p, x))
    k = split(apply_linear(k_p, ctx))
    v = split(apply_linear(v_p, ctx))
    out = ops.attention(q, k, v, causal=False)
    return apply_linear(o_p, out.transpose(1, 2).reshape(b, n, c))


def apply_spatial_transformer(p: dict, x: torch.Tensor, ctx: torch.Tensor,
                              cfg: UNetConfig) -> torch.Tensor:
    b, h, w, c = x.shape
    res = x
    xn = groupnorm(p["norm"], x, cfg.groups)
    xn = apply_conv(p["proj_in"], xn).reshape(b, h * w, c)
    hn = L.layernorm(p["ln1"], xn)
    xn = xn + _mha(p["q1"], p["k1"], p["v1"], p["o1"], hn, hn, cfg.num_heads)
    xn = xn + _mha(p["q2"], p["k2"], p["v2"], p["o2"],
                   L.layernorm(p["ln2"], xn), ctx, cfg.num_heads)
    hgl = apply_linear(p["ff1"], L.layernorm(p["ln3"], xn))
    hh, gate = hgl.chunk(2, dim=-1)
    xn = xn + apply_linear(p["ff2"], hh * L.gelu(gate))     # GEGLU
    xn = apply_conv(p["proj_out"], xn.reshape(b, h, w, c))
    return res + xn


# ---------------------------------------------------------------- UNet

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 of NHWC (``jax.image.resize`` "nearest")."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def init_unet(gen: torch.Generator, cfg: UNetConfig) -> dict:
    ch = cfg.model_channels
    p: dict[str, Any] = {
        "time1": init_linear(gen, ch, cfg.time_dim, role="time_embed",
                             bias=True),
        "time2": init_linear(gen, cfg.time_dim, cfg.time_dim,
                             role="time_embed", bias=True),
        "conv_in": init_conv(gen, cfg.in_channels, ch),
    }
    downs = []
    ch_stack = [ch]
    cur = ch
    for lvl, mult in enumerate(cfg.channel_mult):
        out_ch = ch * mult
        for _ in range(cfg.num_res_blocks):
            blk = {"res": init_resblock(gen, cur, out_ch, cfg.time_dim,
                                        cfg.groups)}
            if lvl in cfg.attention_levels:
                blk["attn"] = init_spatial_transformer(gen, out_ch, cfg)
            downs.append(blk)
            cur = out_ch
            ch_stack.append(cur)
        if lvl != len(cfg.channel_mult) - 1:
            downs.append({"down": init_conv(gen, cur, cur)})
            ch_stack.append(cur)
    p["downs"] = downs
    p["mid"] = {
        "res1": init_resblock(gen, cur, cur, cfg.time_dim, cfg.groups),
        "attn": init_spatial_transformer(gen, cur, cfg),
        "res2": init_resblock(gen, cur, cur, cfg.time_dim, cfg.groups),
    }
    ups = []
    for lvl, mult in reversed(list(enumerate(cfg.channel_mult))):
        out_ch = ch * mult
        for i in range(cfg.num_res_blocks + 1):
            skip = ch_stack.pop()
            blk = {"res": init_resblock(gen, cur + skip, out_ch,
                                        cfg.time_dim, cfg.groups)}
            if lvl in cfg.attention_levels:
                blk["attn"] = init_spatial_transformer(gen, out_ch, cfg)
            if i == cfg.num_res_blocks and lvl != 0:
                blk["up"] = init_conv(gen, out_ch, out_ch)
            ups.append(blk)
            cur = out_ch
    p["ups"] = ups
    p["norm_out"] = init_groupnorm(cur, gen.device)
    p["conv_out"] = init_conv(gen, cur, cfg.out_channels)
    return p


def apply_unet(p: dict, cfg: UNetConfig, x: torch.Tensor, t: torch.Tensor,
               ctx: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 4) latent; t: (B,) timestep; ctx: (B, 77, ctx_dim)."""
    temb = timestep_embedding(t, cfg.model_channels).to(x.dtype)
    temb = apply_linear(p["time2"], L.silu(apply_linear(p["time1"], temb)))
    h = apply_conv(p["conv_in"], x)
    skips = [h]
    for blk in p["downs"]:
        if "down" in blk:
            h = apply_conv(blk["down"], h, stride=2)
        else:
            h = apply_resblock(blk["res"], h, temb, cfg.groups)
            if "attn" in blk:
                h = apply_spatial_transformer(blk["attn"], h, ctx, cfg)
        skips.append(h)
    h = apply_resblock(p["mid"]["res1"], h, temb, cfg.groups)
    h = apply_spatial_transformer(p["mid"]["attn"], h, ctx, cfg)
    h = apply_resblock(p["mid"]["res2"], h, temb, cfg.groups)
    for blk in p["ups"]:
        h = torch.cat([h, skips.pop()], dim=-1)
        h = apply_resblock(blk["res"], h, temb, cfg.groups)
        if "attn" in blk:
            h = apply_spatial_transformer(blk["attn"], h, ctx, cfg)
        if "up" in blk:
            h = apply_conv(blk["up"], upsample2x(h))
    h = L.silu(groupnorm(p["norm_out"], h, cfg.groups))
    return apply_conv(p["conv_out"], h)


class UNet(nn.Module):
    """``apply_unet`` over a parameter tree, as a module."""

    def __init__(self, params: dict, cfg: UNetConfig):
        super().__init__()
        self.params, self.cfg = params, cfg

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                ctx: torch.Tensor) -> torch.Tensor:
        return apply_unet(self.params, self.cfg, x, t, ctx)
