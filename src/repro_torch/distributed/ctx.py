"""Logical-axis sharding context (``repro.distributed.ctx``).

The reference pins the shardings of intermediates with
``with_sharding_constraint`` at canonical cut points, under an ambient
:func:`axis_env`.  A GSPMD constraint never changes a value, and the
port has no compiler to pass one to, so here:

* :func:`pinned_spec` is ``constrain``'s rule: the ``PartitionSpec``
  the reference would pin for an array of a given shape;
* the one cut point this slice uses (:func:`expert_buf`) returns ``x``
  unchanged;
* the env's ``moe_mode`` is read by ``sharding._weight_spec`` and by the
  MoE layer (the Q8_0 combine under ``"ep"``).

The env also carries what the reference's compiler knew and the port
must state: ``batch_axes``, the mesh axes the rows of the running batch
are split over.  :func:`batch_mean` averages a per-rank statistic over
them (the MoE aux loss's means, which the reference takes over all
tokens of the global batch).  Without an env, or with no such axes,
everything here is a no-op.

The remaining cut points (heads, FFN hidden, logits, caches) come with
tensor-parallel compute, when something consumes them.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence

import torch

from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import Mesh

_ENV = contextvars.ContextVar("repro_torch_axis_env", default=None)


class AxisEnv:
    def __init__(self, mesh: Mesh, dp: Sequence[str] = ("data",),
                 tp: str = "model", moe_mode: str = "ep",
                 batch_axes: Sequence[str] = ()):
        self.mesh = mesh
        self.dp = tuple(a for a in dp if a in mesh.shape)
        self.tp = tp if tp in mesh.shape else None
        self.moe_mode = moe_mode  # "ep": experts on tp | "dp": FSDP
        self.batch_axes = tuple(a for a in batch_axes if mesh.shape[a] > 1)


@contextlib.contextmanager
def axis_env(mesh: Mesh, dp: Sequence[str] = ("pod", "data"),
             tp: str = "model", moe_mode: str = "ep",
             batch_axes: Sequence[str] = ()):
    env = AxisEnv(mesh, dp, tp, moe_mode, batch_axes)
    token = _ENV.set(env)
    try:
        yield env
    finally:
        _ENV.reset(token)


def current() -> AxisEnv | None:
    return _ENV.get()


def pinned_spec(shape: Sequence[int], spec_map: dict[int, str]) -> P | None:
    """The spec the reference's ``constrain`` pins for an array of
    ``shape`` (None without an env).  spec_map: dim -> 'dp' | 'tp'; a dp
    dim takes the largest prefix of the dp axes that divides it, a tp
    dim the tp axis if it divides."""
    env = current()
    if env is None:
        return None
    axes: list = [None] * len(shape)
    for dim, kind in spec_map.items():
        if dim >= len(shape):
            continue
        name = env.dp if kind == "dp" else env.tp
        if not name:
            continue
        if kind == "dp":
            use = []
            prod = 1
            for a in name:
                if shape[dim] % (prod * env.mesh.shape[a]) == 0:
                    use.append(a)
                    prod *= env.mesh.shape[a]
            if use:
                axes[dim] = tuple(use) if len(use) > 1 else use[0]
        elif shape[dim] % env.mesh.shape[name] == 0:
            axes[dim] = name
    return P(*axes)


def expert_buf(x):
    """The (G, E, C, d) expert-buffer cut point (the reference pins E on
    tp under "ep", G on dp under "dp"): ``x`` unchanged."""
    return x


class _BatchMean(torch.autograd.Function):
    """Forward: the mean over the env's batch axes (one all-reduce per
    axis).  Backward: the cotangent unchanged.  Every rank computes the
    same function of the global mean, and the train step averages the
    ranks' gradients, so each rank passes back its own tokens' share at
    full weight; the mean over ranks then weights each token 1 / (all
    tokens), as the single-process gradient does."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        import torch.distributed as dist
        out = x.clone()
        n = 1
        for a in axes:
            dist.all_reduce(out, group=mesh.group(a))
            n *= mesh.shape[a]
        return out / n

    @staticmethod
    def backward(ctx, gy):
        return gy, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a per-rank mean over this rank's rows) averaged over the
    ranks that split the batch; ``x`` itself without an env or when the
    batch is not split."""
    env = current()
    if env is None or not env.batch_axes:
        return x
    return _BatchMean.apply(x, env.mesh, env.batch_axes)
