"""AdamW with global-norm clipping and optional Q8_0-quantized moments
(``repro.optim.adamw``).

Quantized moments apply the paper's technique to the optimizer state:
both Adam moments are stored as Q8_0 blocks (int8 + fp16 scale per 32
values along each leaf's last axis), about 2.1 bytes per parameter
instead of 8.  They are dequantized, updated and requantized each step.
Two guards keep this stable, as in the reference: the second moment is
stored in the sqrt domain, and the per-element update is clipped to
±10.

Trees are the port's parameter trees (one dict per layer, where the
reference stacks layers over a period axis): blocks run along the last
axis either way, so a layer's Q8_0 moments hold the same bytes as its
slice of the reference's stacked moment.  :func:`global_norm` sums the
squares in f64 (exact squares of the f32 or bf16 values), rounded once
to f32: so the sum does not depend on how the leaves are cut over ranks
(a rank's slices give the whole leaf's bits), and its last bits may
differ from the reference's f32 squares summed in f32 over stacked
leaves.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import quant
from repro_torch.core.quant import Q8_0Tensor
from repro_torch.core.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any                  # per parameter: f32 tensor or Q8_0Tensor
    v: Any                  # the same; a Q8_0 v holds sqrt(v)


def _quantizable(p: torch.Tensor) -> bool:
    """Quantize a moment in the weight's own shape (blocks along the last
    axis)."""
    return p.dim() >= 1 and p.shape[-1] % 32 == 0


def _q(x: torch.Tensor) -> Q8_0Tensor:
    return quant.quantize_q8_0(x.float())


def _zeros_like_moment(p: torch.Tensor, quantized: bool):
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return _q(z) if quantized and _quantizable(p) else z


def init_adam(params: Any, cfg: TrainConfig) -> AdamState:
    def mk(p):
        return _zeros_like_moment(p, cfg.quantized_moments)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamState(step=step, m=tree_map(mk, params),
                     v=tree_map(mk, params))


_NORM_CHUNK = 1 << 26       # elements widened to f64 at a time (512 MiB)


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """The f64 sum of ``x``'s squares (a 0-d f64 tensor): each chunk of
    the flat leaf widened to f64, where the square of an f32 or bf16
    value is exact, and dotted with itself (two launches a chunk, and
    the bytes of an f32 square and sum)."""
    chunks = x.reshape(-1).split(_NORM_CHUNK)
    parts = [torch.dot(d, d) for d in map(torch.Tensor.double, chunks)]
    return parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts))


def global_norm(tree: Any, *, split: list[tuple] | None = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares (summed in f64, rounded once
    to f32).  ``split`` (one tuple of mesh axes per leaf, with
    ``group``, a function of an axis that gives its process group): the
    axes that cut each leaf into the slices that the ranks hold (the
    sharded train step's FSDP and tensor-parallel slices).  Each leaf's
    squares are summed over every axis that cuts it, one all-reduce per
    axis over the sums of the leaves it cuts, and a leaf that no axis
    cuts (replicated) is counted once.  As the sums are f64, a leaf cut
    over ranks gives (but for a tie at the f32 rounding) the bits of the
    whole leaf."""
    sums = [_square_sum(x) for x in tree_leaves(tree)]
    if not split or not any(split):
        return torch.sqrt(torch.sum(torch.stack(sums)).float())
    import torch.distributed as dist
    sets = sorted({tuple(s) for s in split if s})
    part = [torch.sum(torch.stack([x for x, s in zip(sums, split) if tuple(s) == c]))
            for c in sets]
    for axis in dict.fromkeys(a for c in sets for a in c):
        at = [i for i, c in enumerate(sets) if axis in c]
        buf = torch.stack([part[i] for i in at])
        dist.all_reduce(buf, group=group(axis))
        for i, v in zip(at, buf):
            part[i] = v
    part += [x for x, s in zip(sums, split) if not s]
    return torch.sqrt(torch.sum(torch.stack(part)).float())


def _bias_correction(beta: float, step: torch.Tensor) -> torch.Tensor:
    """``1 - beta ** step`` in f32, the power correctly rounded (taken in
    f64 from the f32 operands and rounded once), as XLA's f32 power
    gives it."""
    b = torch.tensor(beta, dtype=torch.float32, device=step.device).double()
    return 1 - (b ** step.double()).float()


def _is_q(x) -> bool:
    return isinstance(x, Q8_0Tensor)


@torch.no_grad()
def adam_update(grads: Any, state: AdamState, params: Any,
                cfg: TrainConfig, *, grad_norm: torch.Tensor
                ) -> tuple[Any, AdamState]:
    """One AdamW step -> (params, state).  ``grads`` has the parameters'
    structure (any float dtype).  The parameters and the moments are
    updated in place, leaf by leaf, and the same trees are returned with
    the new step count: the reference returns new arrays, but a second
    copy of an 8 B-parameter model does not fit beside it on one card.

    ``grad_norm`` is the whole gradient's ``global_norm``, which the
    caller has for its metrics: the clip scales by it, as in the
    reference, also where the trees are one rank's slices (the sharded
    train step)."""
    step = state.step + 1
    clip = torch.clamp(cfg.grad_clip / (grad_norm + 1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = _bias_correction(b1, step)
    bc2 = _bias_correction(b2, step)
    qz = cfg.quantized_moments

    def upd(p, g, m, v):
        g = g.float() * clip
        tq = qz and _quantizable(p)
        if tq:
            m = quant.dequantize_q8_0(m)
            v = torch.square(quant.dequantize_q8_0(v))   # sqrt-domain storage
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        u = torch.clamp(u, -10.0, 10.0)
        pf = p.float()
        new_p = (pf - cfg.lr * (u + cfg.weight_decay * pf)).to(p.dtype)
        if tq:
            m, v = _q(m), _q(torch.sqrt(v))
        return new_p, m, v

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m, is_leaf=_is_q),
                          tree_leaves(state.v, is_leaf=_is_q)):
        new_p, new_m, new_v = upd(p, g, m, v)
        p.copy_(new_p)
        for old, new in ((m, new_m), (v, new_v)):
            if _is_q(old):
                old.qs.copy_(new.qs)
                old.d.copy_(new.d)
            else:
                old.copy_(new)
    return params, AdamState(step=step, m=state.m, v=state.v)
