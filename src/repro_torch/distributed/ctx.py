"""Logical-axis sharding context (``repro.distributed.ctx``).

The reference pins the shardings of intermediates with
``with_sharding_constraint`` at canonical cut points, under an ambient
:func:`axis_env`, and GSPMD partitions the compute to match.  The port
has no compiler to pass a constraint to, so here:

* :func:`pinned_spec` is ``constrain``'s rule: the ``PartitionSpec``
  the reference would pin for an array of a given shape;
* the cut points (:func:`heads`, :func:`heads_q`, :func:`ffn`,
  :func:`vocab`, :func:`expert_buf`) take the whole shape of the array
  the reference pins there and return this rank's range of its tp dim,
  by that rule: a dim that does not divide the ``model`` axis is whole on
  every rank, as the reference leaves it unsharded.  The layers compute
  on that range and place the collectives of ``distributed.tp``;
* the env's ``moe_mode`` is read by ``sharding._weight_spec`` and by the
  MoE layer (the Q8_0 combine and the local experts under ``"ep"``).

The env also carries what the reference's compiler knew and the port
must state: ``batch_axes``, the mesh axes the rows of the running batch
are split over (:func:`batch_mean` averages a per-rank statistic over
them: the MoE aux loss's means, which the reference takes over all
tokens of the global batch), and ``tp_compute``, whether the layers
compute on their ``model`` slices (:func:`tp_group`).  The sharded train
step turns it on for the dense, VLM and MoE families.  Without it (and
without an env) every cut point is the whole dim, and everything here is
a no-op.  The step also sets ``fsdp``, its ``distributed.fsdp.Gathers``:
the slices that the model gathers at each use, their specs and the
gradient accumulator, keyed by leaf (None: the model's parameters are
whole).

Not ported: ``heads_q``'s query-position split (whisper's 20 heads on a
16-way axis) and the cache cut points, which serving under a mesh
needs.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence

import torch

from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import AxisGroup, Mesh

_ENV = contextvars.ContextVar("repro_torch_axis_env", default=None)


class AxisEnv:
    def __init__(self, mesh: Mesh, dp: Sequence[str] = ("data",),
                 tp: str = "model", moe_mode: str = "ep",
                 batch_axes: Sequence[str] = (), tp_compute: bool = False,
                 fsdp=None):
        self.mesh = mesh
        self.dp = tuple(a for a in dp if a in mesh.shape)
        self.tp = tp if tp in mesh.shape else None
        self.moe_mode = moe_mode  # "ep": experts on tp | "dp": FSDP
        self.batch_axes = tuple(a for a in batch_axes if mesh.shape[a] > 1)
        self.tp_compute = tp_compute
        self.fsdp = fsdp          # a distributed.fsdp.Gathers, or None


@contextlib.contextmanager
def axis_env(mesh: Mesh, dp: Sequence[str] = ("pod", "data"),
             tp: str = "model", moe_mode: str = "ep",
             batch_axes: Sequence[str] = (), tp_compute: bool = False, fsdp=None):
    env = AxisEnv(mesh, dp, tp, moe_mode, batch_axes, tp_compute, fsdp)
    token = _ENV.set(env)
    try:
        yield env
    finally:
        _ENV.reset(token)


@contextlib.contextmanager
def entered(env: AxisEnv | None):
    """``env`` (None: no env) active for the block, for code that runs
    again where the caller's context is not seen: a checkpointed period
    recomputed in the backward pass runs on autograd's device thread, and
    a context variable does not reach another thread.  The env carries
    the step's ``fsdp`` gathers there too, so the recomputation gathers
    its period again."""
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


def tp_group() -> AxisGroup | None:
    """The tp axis's group when the env computes on ``model`` slices
    (``tp_compute``) and that axis has more than one rank; else None."""
    env = current()
    if env is None or not env.tp_compute or not env.tp or env.mesh.shape[env.tp] == 1:
        return None
    return env.mesh.axis_group(env.tp)


def _local(shape: Sequence[int], dim: int) -> slice:
    """This rank's range of dim ``dim`` of an array of the whole
    ``shape``: its slice where ``pinned_spec`` puts the tp axis on that
    dim under tensor-parallel compute, else the whole dim."""
    n = shape[dim]
    g = tp_group()
    if g is None or pinned_spec(shape, {dim: "tp"})[dim] is None:
        return slice(0, n)
    size = n // g.size
    return slice(g.rank * size, (g.rank + 1) * size)


def is_part(sl: slice, n: int) -> bool:
    """Whether a cut point's range ``sl`` is less than the whole dim."""
    return sl.stop - sl.start != n


def cols(n: int) -> slice:
    """This rank's rows of a ``Linear`` weight's tp-sharded dim of size
    ``n`` (its N for ``attn_qkv``, ``mlp_up`` or ``lm_head``, its K for
    ``attn_out`` or ``mlp_down``): ``sharding``'s rule, the same
    divisibility as the cut points'."""
    return _local((n,), 0)


def heads(shape: Sequence[int]) -> slice:
    """(B, H, S, hd) key/value heads: H on tp."""
    return _local(shape, 1)


def heads_q(shape: Sequence[int]) -> slice:
    """(B, H, Sq, hd) query heads: H on tp.  (The reference's split of the
    query positions where H does not divide tp is not ported: such heads
    are whole on every rank.)"""
    return _local(shape, 1)


def ffn(shape: Sequence[int]) -> slice:
    """(B, S, ff) MLP hidden: ff on tp."""
    return _local(shape, 2)


def vocab(shape: Sequence[int]) -> slice:
    """(B, S, V) logits: V on tp."""
    return _local(shape, 2)


def expert_buf(shape: Sequence[int]) -> slice:
    """(G, E, C, d) expert buffers: E on tp under "ep"; under "dp" the
    experts are replicated in compute (the whole range)."""
    env = current()
    if env is None or env.moe_mode == "dp":
        return slice(0, shape[1])
    return _local(shape, 1)


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
