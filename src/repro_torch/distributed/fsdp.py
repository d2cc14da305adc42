"""Per-layer parameter gathers of the sharded train step (ZeRO-3).

The reference shards every weight's K dim over ``data`` and lets GSPMD
gather each period's slices inside the scanned stack, where it also
reduce-scatters each period's gradient.  The reference has no module for
this; the port places those collectives by hand:

* :func:`gather`, called by the model at each use of its parameters (a
  period of layers in ``transformer._stack_fwd``; the embedding, the
  head and the final norms in ``lm_forward`` / ``encoder_forward``),
  all-gathers the slices of the leaves it is given over the step's FSDP
  axes, one packed collective per (round, axis)
  (``sharding._gather_arrays``).  It does so through :class:`_Gather`, an
  autograd ``Function``, whose backward reduce-scatters the whole
  gradient of those leaves over the axes that split the batch, in f32
  (``sharding._scatter_arrays``), as soon as autograd produces it, and
  adds this rank's slices, divided by the microbatch count, into the
  step's f32 accumulator (:attr:`Gathers.acc`).  It hands autograd no
  gradient for the slices: autograd would round a ``Function``'s
  gradient to its input's dtype (bf16).  Its outputs hang on a zero-size
  anchor that requires grad, so that autograd runs the backward.  A tied
  head gathers ``embed`` a second time; both uses add into one
  accumulator.
* :func:`saving` (the step's forward runs in it): saved-tensor hooks that
  keep autograd from saving a gathered array, or a view of one, for the
  backward.  They save where its storage came from instead, and the
  backward gathers that call's leaves again at the first use (once per
  call; freed when the call's backward has run).  Under remat "block" /
  "full" a period is recomputed in the backward, which gathers it again:
  ``torch.utils.checkpoint``'s own hooks hold the period's saved tensors
  there.

So no rank holds more parameters whole than the period (or the embedding
or head) it is working on.  Without a :class:`Gathers` in the axis env
(one process, every serving path, a mesh whose FSDP axes have one rank)
:func:`gather` is the identity and :func:`saving` does nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed import ctx, sharding, tp
from repro_torch.distributed.sharding import P


@dataclasses.dataclass
class Stats:
    """What one step's gathers did: the packed all-gathers and
    reduce-scatters (and all-reduces over batch axes that cut no leaf)
    issued, the bytes of the whole arrays gathered and of the f32 whole
    gradients reduced, their host ms (where the transport is staged, a
    gloo collective of CUDA tensors, timed from a card that has finished
    the work before it, the staging through host memory included), and
    the bytes of gathered arrays alive now and at their high-water mark
    (by their storages)."""
    gathers: int = 0
    scatters: int = 0
    gather_bytes: int = 0
    scatter_bytes: int = 0
    gather_ms: float = 0.0
    scatter_ms: float = 0.0
    live: int = 0
    peak: int = 0


class _Saved(NamedTuple):
    """A saved tensor that aliases a gathered array: the gather call, the
    array's index in it and the view's geometry."""
    call: int
    j: int
    size: torch.Size
    stride: tuple
    offset: int


class Gathers:
    """One sharded step's per-layer gathers: ``leaves``, this rank's slices
    of the parameter leaves that the FSDP axes cut, and ``specs``, their
    specs over those axes; ``acc`` their f32 gradient slices, summed over
    the ranks that split the batch; ``microbatches`` the divisor of each
    contribution; ``anchor`` the zero-size tensor the gathers hang on."""

    def __init__(self, mesh, leaves: list[torch.Tensor], specs: list[P], device,
                 microbatches: int = 1):
        self.mesh, self.leaves, self.specs = mesh, leaves, specs
        self.slot = {id(t): i for i, t in enumerate(leaves)}
        self.acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
        self.microbatches = microbatches
        self.anchor = torch.empty(0, device=device, requires_grad=True)
        self.stats = Stats()
        self._calls: dict[int, tuple] = {}
        self._owners: dict[int, tuple] = {}
        self._again: dict[int, list] = {}

    # ------------------------------------------------------ gathers
    def _freed(self, ptr: int, nbytes: int) -> None:
        self.stats.live -= nbytes
        self._owners.pop(ptr, None)

    def _staged(self, t: torch.Tensor, specs: list[P]) -> bool:
        """Whether a collective of ``t`` over an axis that cuts ``specs``
        goes through host memory (``tp._staged``); the caller then waits
        for the card before its timer starts, which the staging's copy
        does anyway."""
        axes = {a for sp in specs for _, a in sharding._steps(sp, self.mesh)}
        return any(tp._staged(t, self.mesh.axis_group(a)) for a in axes)

    def _gather(self, slots: tuple, call: int | None = None) -> list[torch.Tensor]:
        """The whole arrays of ``slots`` (one packed gather); ``call``:
        record their storages for the saved-tensor hooks."""
        specs = [self.specs[s] for s in slots]
        if self._staged(self.leaves[slots[0]], specs):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = sharding._gather_arrays([self.leaves[s] for s in slots], specs, self.mesh)
        st = self.stats
        st.gather_ms += 1e3 * (time.perf_counter() - t0)
        st.gathers += sharding.collectives(specs, self.mesh)
        for j, w in enumerate(whole):
            n = w.numel() * w.element_size()
            st.gather_bytes += n
            st.live += n
            storage = w.untyped_storage()
            if call is not None and n:
                self._owners[storage.data_ptr()] = (call, j, w.dtype)
            weakref.finalize(storage, self._freed, storage.data_ptr(), n)
        st.peak = max(st.peak, st.live)
        return whole

    def _scatter(self, slots: tuple, grads: tuple, batch_axes: tuple) -> None:
        """Each whole gradient of ``slots`` summed over ``batch_axes`` in
        f32; this rank's slices added into ``acc``."""
        specs = [self.specs[s] for s in slots]
        if self._staged(grads[0], specs):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums = sharding._scatter_arrays(list(grads), specs, self.mesh, batch_axes)
        st = self.stats
        st.scatter_ms += 1e3 * (time.perf_counter() - t0)
        st.scatters += sharding.collectives(specs, self.mesh, batch_axes)
        st.scatter_bytes += sum(4 * g.numel() for g in grads)
        nm = self.microbatches
        for s, x in zip(slots, sums):
            self.acc[s].add_(x / nm if nm > 1 else x)

    # ------------------------------------------------ saved tensors
    def _pack(self, t: torch.Tensor):
        owner = self._owners.get(t.untyped_storage().data_ptr())
        if owner is None or owner[2] != t.dtype:
            return t
        return _Saved(owner[0], owner[1], t.size(), t.stride(), t.storage_offset())

    def _unpack(self, saved):
        if not isinstance(saved, _Saved):
            return saved
        whole = self._again.get(saved.call)
        if whole is None:
            whole = self._again[saved.call] = self._gather(self._calls[saved.call])
        return whole[saved.j].as_strided(saved.size, saved.stride, saved.offset)


class _Gather(torch.autograd.Function):
    """Forward: the whole arrays of the slices (one packed gather).
    Backward: their gradients reduce-scattered into the accumulator; no
    gradient is returned."""

    @staticmethod
    def forward(fctx, anchor, g: Gathers, batch_axes: tuple, slots: tuple, *slices):
        del anchor, slices
        fctx.g, fctx.batch_axes, fctx.slots = g, batch_axes, slots
        fctx.call = len(g._calls)
        g._calls[fctx.call] = slots
        return tuple(g._gather(slots, fctx.call))

    @staticmethod
    def backward(fctx, *grads):
        g = fctx.g
        g._again.pop(fctx.call, None)
        g._scatter(fctx.slots, grads, fctx.batch_axes)
        return (None,) * (4 + len(grads))


def gather(tree: Any) -> Any:
    """``tree`` with each leaf that the active :class:`Gathers` holds
    (this rank's slice) replaced by the whole array over the FSDP axes,
    all in one :class:`_Gather`; ``tree`` itself without one, or when it
    holds no such leaf."""
    env = ctx.current()
    g = None if env is None else env.fsdp
    if g is None:
        return tree
    leaves = tree_leaves(tree)
    at = [i for i, t in enumerate(leaves) if id(t) in g.slot]
    if not at:
        return tree
    whole = _Gather.apply(g.anchor, g, env.batch_axes, tuple(g.slot[id(leaves[i])] for i in at),
                          *(leaves[i] for i in at))
    for i, w in zip(at, whole):
        leaves[i] = w
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@contextlib.contextmanager
def saving(g: Gathers | None):
    """The block's saved tensors that alias a gathered array are saved as
    where they came from (``g``'s hooks); nothing without ``g``."""
    if g is None:
        yield
        return
    with torch.autograd.graph.saved_tensors_hooks(g._pack, g._unpack):
        yield
