"""Shared layers: norms, RoPE and M-RoPE, MLPs, embeddings and the
unembedding (``repro.models.layers``).

Plain functions over parameter dicts and :class:`Linear`s; weight
matmuls go through :mod:`repro_torch.core.qlinear` so the offload policy
can quantize them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import quant
from repro_torch.core.qlinear import Linear, apply_linear, init_linear
from repro_torch.core.quant import Q3KTensor, Q4_0Tensor, Q8_0Tensor


# ------------------------------------------------------------- norms

def init_rmsnorm(dim: int, device=None) -> dict:
    return {"g": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["g"]).to(x.dtype)


def init_layernorm(dim: int, device=None) -> dict:
    return {"g": torch.ones((dim,), dtype=torch.float32, device=device),
            "b": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]).to(x.dtype)


# -------------------------------------------------------------- RoPE

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) int.  Rotates the two halves
    of the head dim in f32 and casts back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    ang = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)                 # (B,1,S,D/2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...],
                theta: float = 10_000.0) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head_dim/2 frequency slots are split into
    (temporal, height, width) sections, each rotated by its own position
    stream.  x: (B, H, S, D); positions: (B, 3, S) int.  In f32 and cast
    back to x's dtype, as :func:`apply_rope`."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim/2 = {d // 2}")
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(list(sections), device=x.device))        # (D/2,)
    pos_slot = positions.float()[:, sec_id, :]                # (B, D/2, S)
    ang = pos_slot.transpose(1, 2) * freqs                    # (B, S, D/2)
    cos = torch.cos(ang)[:, None]                             # (B,1,S,D/2)
    sin = torch.sin(ang)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- MLP

def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant in ``like``'s dtype, as JAX casts weak-typed
    constants (in bf16, sqrt(2/pi) becomes 0.796875).  A 0-d CPU tensor
    works as a scalar operand on any device without a copy."""
    return torch.tensor(value, dtype=like.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (``lax.logistic``) op by op: ``1 / (1 + exp(-x))``
    in x's dtype."""
    one = _const(1.0, x)
    return one / (one + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``jnp.logaddexp(x, 0)``, op by op:
    ``max(x, 0) + log1p(exp(-|x|))``, and ``x + 0`` where x is NaN.
    (``F.softplus`` computes ``log1p(exp(x))`` below a threshold and x
    above it, which rounds otherwise.)"""
    zero = _const(0.0, x)
    return torch.where(torch.isnan(x), x + zero,
                       torch.maximum(x, zero) + torch.log1p(torch.exp(-x.abs())))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` op by op: ``x * (1 / (1 + exp(-x)))``, each op
    rounded to x's dtype as the reference's bf16 program does."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default tanh approximation, op by op in x's dtype
    with its constants cast to that dtype, as the reference computes it."""
    c = _const(math.sqrt(2.0 / math.pi), x)
    a = _const(0.044715, x)
    half, one = _const(0.5, x), _const(1.0, x)
    return x * (half * (one + torch.tanh(c * (x + a * (x * x * x)))))


def init_mlp(gen: torch.Generator, d: int, ff: int, activation: str,
             role_prefix: str = "mlp") -> dict:
    p = {"up": init_linear(gen, d, ff, role=f"{role_prefix}_up"),
         "down": init_linear(gen, ff, d, role=f"{role_prefix}_down")}
    if activation == "silu":
        p["gate"] = init_linear(gen, d, ff, role=f"{role_prefix}_gate")
    return p


def apply_mlp(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    up = apply_linear(p["up"], x)
    if activation == "silu":
        h = silu(apply_linear(p["gate"], x)) * up
    elif activation == "gelu":
        h = gelu(up)
    else:
        raise ValueError(activation)
    return apply_linear(p["down"], h)


# -------------------------------------------------------- embeddings

def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16) -> Linear:
    w = (torch.randn((vocab, d), generator=gen, device=gen.device,
                     dtype=torch.float32).mul_(0.02)).to(dtype)
    return Linear(w=w, b=None, role="embed")


def apply_embedding(emb: Linear, tokens: torch.Tensor) -> torch.Tensor:
    """Row lookup that understands quantized storage: only the gathered
    rows are dequantized."""
    w = emb.w
    if isinstance(w, Q8_0Tensor):
        sub = Q8_0Tensor(w.qs[tokens], w.d[tokens])
        return quant.dequantize_q8_0(sub, torch.bfloat16)
    if isinstance(w, Q4_0Tensor):
        return quant.dequantize_q4_0(Q4_0Tensor(w.qs[tokens], w.d[tokens]),
                                     torch.bfloat16)
    if isinstance(w, Q3KTensor):
        sub = Q3KTensor(w.ql[tokens], w.qh[tokens], w.scales[tokens],
                        w.d[tokens], scale_bits=w.scale_bits)
        return quant.dequantize_q3_k(sub, torch.bfloat16)
    return w[tokens]


def apply_unembed(head: Linear, x: torch.Tensor) -> torch.Tensor:
    """Logits = x @ W_vocab^T in f32 (through ``apply_linear``, so a
    quantized head takes its kernel)."""
    return apply_linear(head, x).float()
