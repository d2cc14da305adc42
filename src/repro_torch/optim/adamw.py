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
leaves' squares in f32 leaf by leaf, so its last bits may differ from
the reference's sum over stacked leaves.
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


def global_norm(tree: Any, *, split: list[bool] | None = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares.  ``split`` (one
    flag per leaf, with ``group``): the leaves of which this rank holds a
    slice along ``group`` (tensor-parallel compute); their squares are
    summed over the group's ranks by one all-reduce, and every other leaf,
    replicated along ``group``, is counted once."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if not split or not any(split):
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    import torch.distributed as dist
    total = torch.sum(torch.stack([x for x, cut in zip(leaves, split) if cut]))
    dist.all_reduce(total, group=group)
    rest = [x for x, cut in zip(leaves, split) if not cut]
    if rest:
        total = total + torch.sum(torch.stack(rest))
    return torch.sqrt(total)


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
