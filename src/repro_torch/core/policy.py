"""Offload policy: which tensors run through quantized kernels.

Mirrors GGML model-file conventions (the thing the paper profiles in
Table I): a model is stored with per-tensor quantization types, the
accelerator executes the quantized dot products, and everything else
(F32/F16 ops — norms, softmax, attention score/PV, small tensors) stays
on the "host" path — on TPU, plain bf16/f32 XLA ops.

A policy maps tensor *roles* to formats.  Presets reproduce the paper's
two evaluated models (Q8_0 and Q3_K quantizations of SD-Turbo / generic
transformer weights).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

# Roles a weight tensor can play.  Any matmul weight in the framework is
# tagged with one of these when created.
ROLES = (
    "attn_qkv", "attn_out", "mlp_up", "mlp_gate", "mlp_down",
    "expert_up", "expert_gate", "expert_down", "router",
    "ssm_in", "ssm_out", "ssm_x",
    "embed", "lm_head", "conv", "time_embed", "proj_misc",
)

# Formats understood by repro_torch.core.quant.quantize().
FORMATS = ("f32", "bf16", "f16", "q8_0", "q4_0", "q3_k")


@dataclasses.dataclass(frozen=True)
class OffloadPolicy:
    """Per-role weight-format assignment."""
    name: str
    default: str = "bf16"
    overrides: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # Paper's OP_CVT53 approximation (Q3_K only).
    scale_bits: int = 6
    # Quantize the KV cache to Q8_0 blocks (beyond-paper extension).
    quantize_kv: bool = False

    def format_for(self, role: str) -> str:
        if role not in ROLES:
            raise KeyError(f"unknown tensor role {role!r}")
        return self.overrides.get(role, self.default)

    def is_quantized(self, role: str) -> bool:
        return self.format_for(role).startswith("q")


# GGML-like conventions: routers, norms and small glue stay high
# precision; big projection matrices take the model's quantization type.
_COMMON_HP = {
    "router": "f32",
    "time_embed": "f32",
    "proj_misc": "bf16",
}

NONE_POLICY = OffloadPolicy(name="none", default="bf16")

# stable-diffusion.cpp executes convs as im2col + F16 mul_mat and does
# NOT quantize conv weights; attention act-act mul_mats run in F32.
# This is what produces Table I's large F16/F32 residue.
Q8_0_POLICY = OffloadPolicy(
    name="q8_0",
    default="q8_0",
    overrides={**_COMMON_HP, "embed": "q8_0", "conv": "f16"},
)

Q3_K_POLICY = OffloadPolicy(
    name="q3_k",
    default="q3_k",
    # GGML's Q3_K_M keeps embeddings / output at higher precision.
    overrides={**_COMMON_HP, "embed": "q8_0", "lm_head": "q8_0",
               "conv": "f16"},
)

Q3_K_IMAX_POLICY = dataclasses.replace(
    Q3_K_POLICY, name="q3_k_imax", scale_bits=5)  # paper's 5-bit scales

# Beyond the paper's two formats: llama.cpp's default deployment point.
Q4_0_POLICY = OffloadPolicy(
    name="q4_0",
    default="q4_0",
    overrides={**_COMMON_HP, "embed": "q8_0", "lm_head": "q8_0",
               "conv": "f16"},
)

PRESETS = {p.name: p for p in
           (NONE_POLICY, Q8_0_POLICY, Q4_0_POLICY, Q3_K_POLICY,
            Q3_K_IMAX_POLICY)}


def get_policy(name: str) -> OffloadPolicy:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; have {list(PRESETS)}")
