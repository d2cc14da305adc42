"""Mixture-of-Experts FFN on one device (``repro.models.moe``): group-local
top-k routing with capacity drops, dense capacity buffers and the
shared experts.

Groups are batch rows.  Each group sorts its (token, slot) expert ids
(a stable sort), keeps the first ``cap`` entries of each expert and
sends the rest to a trash slot, and gathers its tokens into a ``(G, E,
C, d)`` buffer.  Every expert then runs on all of its ``G * C`` rows,
empty or not (the reference's dense capacity buffers), through one
matmul per projection over all experts: a ``torch.bmm`` for bf16
weights, one launch of the quantized kernel's batched entry for Q8_0 and
Q3_K weights.  Shared experts run densely on every token.

Capacity is per group, so whether a token drops depends on the grouping:
``lm_forward`` (one group per row of S tokens), a fused prefill chunk
(one group of T tokens) and a decode step (one token per group, ``cap =
1``, never a drop) can route the same token differently.

Ties: ``jax.lax.top_k`` takes the lower expert index first among exactly
equal probabilities.  ``torch.topk`` makes no such promise (on the CPU,
four equal probabilities gave experts 2 and 3 as the top two), so the
top k here are the first k of a stable descending sort, which keeps the
index order among equals.  The dispatch sort is stable, as
``jnp.argsort`` is.

Under an axis env (``distributed.ctx.axis_env``) the reference's
expert-parallel pieces act as they do there: with ``moe_mode == "ep"``
and ``d % 32 == 0`` the combine gathers the expert outputs through Q8_0
blocks (:class:`QuantizedCombine`, a straight-through backward), also at
one rank; the aux loss's two means are averaged over the ranks that
split the batch (``ctx.batch_mean``), so that it is the product of means
over all tokens of the global batch, as in the reference.

Under tensor-parallel compute (``ctx.tp_group``) and "ep", each rank
runs the experts of its ``ctx.expert_buf`` range.  The batch is split
only over the data axes, so every rank along ``model`` routes the same
rows the same way: the dispatch needs no collective, and each rank takes
its experts' slots of the buffer (behind ``tp.copy``).  The combine's
gather crosses the EP cut by an all-gather of the expert outputs over
``model``: of their Q8_0 bytes (int8 quants, f16 scales) through
:class:`QuantizedCombine`, whose backward is the gather-transpose
restricted to this rank's slots.  The router stays replicated; the
shared experts follow ``layers.apply_mlp``.  Under "dp" the experts are
replicated in compute, as in the reference's DP-MoE.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.qlinear import Linear, apply_linear, f32_product
from repro_torch.core.quant import Q3KTensor, Q8_0Tensor, QTYPES
from repro_torch.distributed import ctx, tp
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def _q8_across_ep(x: torch.Tensor) -> torch.Tensor:
    """Quantize a (G, E, C, d) buffer to Q8_0 blocks before the EP cut and
    dequantize after it, so that the expert all-to-all would move int8 +
    fp16 scales instead of bf16.  Without an env, under ``moe_mode ==
    "dp"`` or with ``d % 32 != 0``, the buffer itself.  The reference
    defines it but never calls it (its ``apply_moe`` crosses the cut in
    the combine); neither does the port."""
    env = ctx.current()
    if env is None or env.moe_mode != "ep" or x.shape[-1] % 32:
        return x
    return quant.dequantize_q8_0(quant.quantize_q8_0(x), torch.bfloat16).to(x.dtype)


class QuantizedCombine(torch.autograd.Function):
    """``out_flat`` (G, n, d) gathered at ``dst`` (G, T) through Q8_0
    blocks: each row is quantized (int8 quants, fp16 scales per 32), a
    zero row is appended at index n (dropped entries point there), the
    quants and scales are gathered and dequantized to ``out_flat``'s
    dtype -> (G, T, d).  The backward is the exact transpose of the
    gather (straight through the quantizer, whose round would pass no
    gradient): ``dst`` is injective on kept entries, so the rank scatters
    only int32 inverse indices and gathers the cotangents.

    With ``group`` (the tp axis's ``launch.mesh.AxisGroup``) ``out_flat``
    is this rank's slots, the slots of every rank in coordinate order make
    the whole ``n``, and the quants and scales cross the EP cut by an
    all-gather along the slots (``tp.all_gather``); the backward returns
    this rank's slots of the transpose (the cotangent is the same on every
    rank)."""

    @staticmethod
    def forward(ctx_, out_flat, dst, group=None):
        g, n, d = out_flat.shape
        oq = quant.quantize_q8_0(out_flat)
        qs, dsc = oq.qs, oq.d
        if group is not None:
            qs, dsc = tp.all_gather(qs, group, 1), tp.all_gather(dsc, group, 1)
        qs = torch.cat([qs, qs.new_zeros((g, 1, d))], 1)
        dsc = torch.cat([dsc, dsc.new_zeros((g, 1, d // 32))], 1)
        qs_g = qs.gather(1, dst[..., None].expand(-1, -1, d))
        dsc_g = dsc.gather(1, dst[..., None].expand(-1, -1, d // 32))
        ctx_.save_for_backward(dst)
        ctx_.n, ctx_.group = n, group
        return quant.dequantize_q8_0(Q8_0Tensor(qs_g, dsc_g), out_flat.dtype)

    @staticmethod
    def backward(ctx_, gy):
        (dst,) = ctx_.saved_tensors
        g, sk, d = gy.shape
        n, group = ctx_.n, ctx_.group
        whole = n * (group.size if group is not None else 1)
        inv = torch.full((g, whole + 1), sk, dtype=torch.int32, device=gy.device)
        inv.scatter_(1, dst, torch.arange(sk, dtype=torch.int32,
                                          device=gy.device).expand(g, sk).contiguous())
        first = group.rank * n if group is not None else 0
        inv = inv[:, first:first + n].long()
        gypad = torch.cat([gy, gy.new_zeros((g, 1, d))], 1)
        return gypad.gather(1, inv[..., None].expand(-1, -1, d)), None, None


def _quantized_combine(out_flat: torch.Tensor, dst: torch.Tensor,
                       group=None) -> torch.Tensor:
    return QuantizedCombine.apply(out_flat, dst, group)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Router (f32), stacked expert weights (E, ff, d) / (E, d, ff)
    output-major in bf16, and the shared MLP, drawn from ``gen``."""
    moe = cfg.moe
    d, ff, e = cfg.d_model, moe.expert_ff, moe.num_experts
    std = d ** -0.5

    def ew(shape):
        return (torch.randn(shape, generator=gen, device=gen.device,
                            dtype=torch.float32) * std).to(torch.bfloat16)

    p = {
        "router": Linear(ew((e, d)).float(), role="router"),
        "w_up": Linear(ew((e, ff, d)), role="expert_up"),
        "w_gate": Linear(ew((e, ff, d)), role="expert_gate"),
        "w_down": Linear(ew((e, d, ff)), role="expert_down"),
    }
    if moe.num_shared:
        p["shared"] = L.init_mlp(gen, d, moe.expert_ff * moe.num_shared, "silu",
                                 role_prefix="mlp")
    return p


def _expert_matmul(w: Linear, x: torch.Tensor) -> torch.Tensor:
    """x: (E, R, K) rows of each expert; w.w: (E, N, K) -> (E, R, N) in
    x's dtype.  Not reported to the matmul recorder (the reference's
    expert matmul bypasses ``apply_linear``)."""
    ww = w.w
    if isinstance(ww, (Q8_0Tensor, Q3KTensor)):
        return ops.quantized_matmul(x, ww)
    if isinstance(ww, QTYPES):
        raise TypeError(f"apply_moe: the {w.role} weight is {type(ww).__name__}; "
                        "the expert matmul takes bf16, Q8_0 or Q3_K weights "
                        "(the reference fails on it too)")
    if x.is_cuda and ww.dtype == torch.bfloat16:
        # cuBLAS: bf16 operands, f32 sums, one rounding to bf16.
        return torch.bmm(x.to(ww.dtype), ww.transpose(1, 2)).to(x.dtype)
    return f32_product(x, ww).to(x.dtype)


def route(p: dict, cfg: ModelConfig, x: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The f32 router: x (B, S, d) -> (probabilities (B, S, E), gates
    (B, S, k) renormalised over the top k, expert ids (B, S, k) in
    descending order of probability, ties to the lower id)."""
    k = cfg.moe.top_k
    logits = apply_linear(p["router"], x.float())                # (G,S,E) f32
    probs = torch.softmax(logits, dim=-1)
    ranked, order_e = probs.sort(dim=-1, descending=True, stable=True)
    gate, expert_idx = ranked[..., :k], order_e[..., :k]
    return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), expert_idx


def apply_moe(p: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss f32).  Groups = batch rows."""
    moe = cfg.moe
    g, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    dev = x.device

    probs, gate, expert_idx = route(p, cfg, x)

    # Load-balancing aux loss (Switch-style), over all tokens.
    me = ctx.batch_mean(probs.reshape(-1, e).mean(0))
    ce = ctx.batch_mean(
        torch.nn.functional.one_hot(expert_idx.reshape(-1, k), e).sum(1).float().mean(0) / k)
    aux = e * (me * ce).sum() * moe.router_aux_coef

    cap = max(int(moe.capacity_factor * s * k / e), 1)

    # Group-local sorted dispatch.
    flat_e = expert_idx.reshape(g, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)           # (G,S*k)
    se = flat_e.gather(-1, order)
    stok = order // k                                            # token index
    start = torch.searchsorted(se, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos_in_e = torch.arange(s * k, device=dev)[None, :] - start.gather(-1, se)
    keep = pos_in_e < cap
    # Dropped entries go to a trash slot (e * cap), never over an occupant.
    dst = torch.where(keep, se * cap + pos_in_e, e * cap)        # (G,S*k)

    # Slot -> token indices (sentinel s: the zero row), then one gather of
    # this rank's experts' slots (all of them without expert parallelism).
    es = ctx.expert_buf((g, e, cap, d))
    ep = ctx.is_part(es, e)
    el = es.stop - es.start
    if ep:
        for name in ("w_up", "w_gate", "w_down"):
            L.local_rows(p[name], es, 0)
    islot = torch.full((g, e * cap + 1), s, dtype=torch.int64, device=dev)
    islot.scatter_(1, dst, stok)
    xpad = torch.cat([tp.copy(x) if ep else x, x.new_zeros((g, 1, d))], dim=1)
    slots = islot[:, es.start * cap:es.stop * cap]
    buf = xpad.gather(1, slots[..., None].expand(-1, -1, d))     # (G,El*C,d)
    xe = buf.reshape(g, el, cap, d).transpose(0, 1).reshape(el, g * cap, d)

    up = _expert_matmul(p["w_up"], xe)
    h = L.silu(_expert_matmul(p["w_gate"], xe)) * up
    out_e = _expert_matmul(p["w_down"], h)                        # (El,G*C,d)
    out_e = out_e.reshape(el, g, cap, d).transpose(0, 1).reshape(g, el * cap, d)

    # Combine: each (token, slot) entry's expert output (the zero row when
    # dropped) times its gate, added up per token in ascending expert
    # order from zero, rounding to x's dtype after each add: the
    # reference's scatter-add over the expert-sorted entries.
    # Under an "ep" env the gather crosses the EP wire as Q8_0 blocks
    # (gathered over model from the ranks' experts).
    inv = torch.argsort(order, dim=-1)                           # entry -> sorted position
    dst_tok = dst.gather(-1, inv)
    w_tok = (gate.reshape(g, s * k) * keep.gather(-1, inv)).to(x.dtype)
    env = ctx.current()
    if env is not None and env.moe_mode == "ep" and d % 32 == 0:
        rows = _quantized_combine(out_e, dst_tok, ctx.tp_group() if ep else None)
    else:
        if ep:
            out_e = tp.gather(out_e, 1)
        out_flat = torch.cat([out_e, out_e.new_zeros((g, 1, d))], dim=1)
        rows = out_flat.gather(1, dst_tok[..., None].expand(-1, -1, d))
    contrib = rows * w_tok[..., None]
    by_expert = expert_idx.argsort(dim=-1)                       # (G,S,k)
    contrib = contrib.reshape(g, s, k, d).gather(
        2, by_expert[..., None].expand(-1, -1, -1, d))
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]

    if "shared" in p:
        y = y + L.apply_mlp(p["shared"], x, "silu", moe.expert_ff * moe.num_shared)
    return y, aux
