"""Config dataclasses: the LM ``ModelConfig`` and the SD pipeline configs.

``ModelConfig`` and ``TrainConfig`` are copies of
``repro.configs.base``'s, and :func:`reduced` of
``repro.configs.base.reduced``.
``UNetConfig``/``VAEConfig`` (``repro.models.unet``/``vae``),
``clip_config`` (``repro.models.clip``) and ``SDConfig`` with
``SD_TURBO``/``TINY_SD`` (``repro.engine.diffusion_engine``) live here
and are re-exported from the modules that use them.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    expert_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    block_pattern: Sequence[str] = ("attn",)
    moe: MoEConfig | None = None
    moe_every: int = 1
    sliding_window: int | None = None
    qkv_bias: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500
    rope_theta: float = 10_000.0
    mrope: bool = False
    mrope_sections: Sequence[int] = (16, 24, 24)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    norm: str = "rmsnorm"        # "rmsnorm" | "layernorm"
    pos_embed: str = "rope"      # "rope" | "sinusoidal" | "none"
    activation: str = "silu"     # "silu" (swiglu) | "gelu"
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    default_policy: str = "q8_0"
    scan_unroll: bool = False
    mamba_chunk: int = 0
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return "attn" not in tuple(self.block_pattern)

    def pattern_for_layers(self) -> list[str]:
        pat = list(self.block_pattern)
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0          # 0 -> no accumulation
    remat: str = "block"         # "none" | "block" | "full"
    quantized_moments: bool = False  # Q8_0 Adam moments (beyond-paper)
    grad_compression: bool = False   # int8 error-feedback gradient exchange
    seed: int = 0
    steps: int = 100
    ckpt_every: int = 50
    # The reference's /tmp/repro_ckpt, under this process's temp directory.
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's
    ``reduced``: 2 layers, d_model 128, 4 heads, head_dim 32)."""
    pat = tuple(cfg.block_pattern)
    small = dict(
        num_layers=max(2, len(pat)),
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, 4 * cfg.num_kv_heads // max(cfg.num_heads, 1)),
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=64 if cfg.encoder_layers else cfg.encoder_seq,
        sliding_window=32 if cfg.sliding_window else None,
        ssm_state=8,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(num_experts=4, top_k=2,
                                 num_shared=min(1, cfg.moe.num_shared),
                                 expert_ff=128,
                                 capacity_factor=cfg.moe.capacity_factor)
    if cfg.mrope:
        half = small["head_dim"] // 2
        t = half // 4
        small["mrope_sections"] = (half - 2 * (half - t) // 2,
                                   (half - t) // 2, (half - t) // 2)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


# ------------------------------------------------------------ SD parts

def clip_config(*, d_model: int = 768, layers: int = 12, heads: int = 12,
                vocab: int = 49408, max_len: int = 77) -> ModelConfig:
    """CLIP text encoder of SD v1.5 (768 wide, 12 layers, 12 heads)."""
    return ModelConfig(
        name="clip_text", family="dense", num_layers=layers,
        d_model=d_model, num_heads=heads, num_kv_heads=heads,
        d_ff=4 * d_model, vocab_size=vocab, norm="layernorm",
        activation="gelu", pos_embed="sinusoidal")


TINY_CLIP = clip_config(d_model=64, layers=2, heads=2, vocab=512)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_levels: tuple = (0, 1, 2)
    num_heads: int = 8
    context_dim: int = 768
    time_dim_mult: int = 4
    groups: int = 32

    @property
    def time_dim(self) -> int:
        return self.model_channels * self.time_dim_mult


SD15_UNET = UNetConfig()
TINY_UNET = UNetConfig(model_channels=32, channel_mult=(1, 2),
                       num_res_blocks=1, attention_levels=(0, 1),
                       num_heads=2, context_dim=64, groups=8)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    z_channels: int = 4
    out_channels: int = 3
    base: int = 128
    channel_mult: tuple = (1, 2, 4, 4)   # decoder runs reversed
    num_res_blocks: int = 2
    groups: int = 32
    scale_factor: float = 0.18215


SD15_VAE = VAEConfig()
TINY_VAE = VAEConfig(base=32, channel_mult=(1, 2), num_res_blocks=1,
                     groups=8)


@dataclasses.dataclass(frozen=True)
class SDConfig:
    name: str = "sd-turbo"
    unet: UNetConfig = SD15_UNET
    vae: VAEConfig = SD15_VAE
    clip: Any = None             # ModelConfig; None -> clip_config()
    latent_hw: int = 64          # 512x512 image -> 64x64 latent
    text_len: int = 77
    steps: int = 1               # SD-Turbo single step

    def clip_cfg(self) -> ModelConfig:
        return self.clip or clip_config()


SD_TURBO = SDConfig()
TINY_SD = SDConfig(name="tiny-sd", unet=TINY_UNET, vae=TINY_VAE,
                   clip=TINY_CLIP, latent_hw=8, steps=1)
