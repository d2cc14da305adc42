"""Sharding rules: logical roles -> partition specs on a mesh
(``repro.distributed.sharding``).

Mesh axes:
  * ``pod``   — pure data parallelism across pods.
  * ``data``  — data parallelism + FSDP (every weight also shards its K
    dim over ``data``).
  * ``model`` — tensor parallelism (heads / ffn / vocab / experts).

The rules are the reference's, applied to the port's trees: every
``Linear`` follows ``ROLE_RULES`` (its quantized side tensors inherit the
weight's spec, dropping a shard that does not divide), bare quantized
tensors (quantized optimizer moments of non-``Linear`` leaves) shard dim
0, everything else is replicated.  A spec is :class:`P`, a tuple of axis
entries (a name, a tuple of names, or None), normalised as JAX's
``PartitionSpec`` is (a one-name tuple is the name); ``P()`` and
``P(None, None)`` stay distinct.  The port's LM trees hold one dict per
layer where the reference stacks layers over a period axis; the rules
read the trailing logical dims, so a layer's spec is the reference's
stacked spec without its leading None.

In the place of the reference's ``to_named``: :func:`local_shard` cuts a
rank's slice of a leaf and :func:`gather` all-gathers a whole leaf from
the ranks' slices, for tensors and for ``Q8_0Tensor`` / ``Q4_0Tensor`` /
``Q3KTensor`` leaves (each array by its own spec).  A dim sharded over
several axes is split major to minor in the order the spec names them.
:func:`over` keeps a spec's entries on a subset of the axes, so that a
tree can be gathered or cut over those axes only: the sharded train step
gathers over ``pod`` / ``data`` and keeps the ``model`` slices for
tensor-parallel compute.  :func:`_scatter_arrays` is the way back of
:func:`_gather_arrays`: whole arrays (each rank's gradients) summed in
f32 over the axes that split the batch, each rank left its slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.qlinear import Linear
from repro_torch.core.quant import QTYPES, Q3KTensor, Q4_0Tensor, Q8_0Tensor
from repro_torch.core.tree import tree_leaves, tree_map


class P(tuple):
    """A partition spec: one entry per leading dim (trailing dims past
    the spec are replicated)."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (list, tuple)):
                p = tuple(p)
                return p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def _is_spec_leaf(x) -> bool:
    return isinstance(x, (P,) + QTYPES)


# role -> (N_axis, K_axis) for the logical (N, K) weight.
ROLE_RULES: dict[str, tuple] = {
    "attn_qkv":   ("model", "data"),
    "attn_out":   ("data", "model"),
    "mlp_up":     ("model", "data"),
    "mlp_gate":   ("model", "data"),
    "mlp_down":   ("data", "model"),
    "expert_up":  ("model", "data"),   # expert dim handled separately
    "expert_gate": ("model", "data"),
    "expert_down": ("model", "data"),
    "router":     (None, None),
    "ssm_in":     ("model", "data"),
    "ssm_x":      (None, None),
    "ssm_out":    ("data", "model"),
    "embed":      ("model", "data"),
    "lm_head":    ("model", "data"),
    "conv":       (None, None),
    "time_embed": (None, None),
    "proj_misc":  (None, None),
}


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _divides(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    return dim % math.prod(mesh.shape[a] for a in _axes(axis)) == 0


def _weight_spec(shape: tuple, role: str, mesh) -> P:
    n_ax, k_ax = ROLE_RULES.get(role, (None, None))
    if len(shape) == 3:  # stacked experts (E, N, K)
        from repro_torch.distributed import ctx as _ctx
        env = _ctx.current()
        if env is not None and getattr(env, "moe_mode", "ep") == "dp":
            # DP-MoE: experts replicated in compute, weights FSDP'd on data.
            k_ax2 = "data" if _divides(shape[2], mesh, "data") else None
            return P(None, None, k_ax2)
        e_ax = "model" if _divides(shape[0], mesh, "model") else None
        k_ax2 = "data" if (e_ax != "data"
                           and _divides(shape[2], mesh, "data")) else None
        return P(e_ax, None, k_ax2)
    n_ax = n_ax if _divides(shape[0], mesh, n_ax) else None
    k_ax = k_ax if len(shape) > 1 and _divides(shape[1], mesh, k_ax) else None
    if len(shape) == 1:
        return P(n_ax)
    return P(n_ax, k_ax)


def _qside_spec(wspec: P, shape: tuple, mesh) -> P:
    """Spec for a quantized side tensor: the weight's leading layout,
    each axis kept only where it divides."""
    axes = list(wspec) + [None] * (len(shape) - len(wspec))
    axes = axes[: len(shape)]
    for i, ax in enumerate(axes):
        if not _divides(shape[i], mesh, ax):
            axes[i] = None
    return P(*axes)


def _qspec(w, ws: P, mesh):
    """A quantized tensor's spec tree: ``ws`` for its quants, the side
    tensors by :func:`_qside_spec`."""
    if isinstance(w, Q3KTensor):
        return Q3KTensor(ql=ws, qh=_qside_spec(ws, w.qh.shape, mesh),
                         scales=_qside_spec(ws, w.scales.shape, mesh),
                         d=_qside_spec(ws, w.d.shape, mesh), scale_bits=w.scale_bits)
    return type(w)(qs=ws, d=_qside_spec(ws, w.d.shape, mesh), logical=w.logical)


def _quants(w) -> torch.Tensor:
    return w.ql if isinstance(w, Q3KTensor) else w.qs


def linear_specs(lin: Linear, mesh) -> Linear:
    """A ``Linear``-shaped tree of specs."""
    w = lin.w
    if isinstance(w, QTYPES):
        spec_w = _qspec(w, _weight_spec(tuple(_quants(w).shape), lin.role, mesh), mesh)
    else:
        spec_w = _weight_spec(tuple(w.shape), lin.role, mesh)
    spec_b = None
    if lin.b is not None:
        n_ax = _weight_spec((lin.b.shape[0], 1), lin.role, mesh)[0]
        spec_b = P(n_ax)
        if isinstance(lin.b, QTYPES):   # a quantized moment of the bias
            spec_b = _qspec(lin.b, spec_b, mesh)
    return Linear(w=spec_w, b=spec_b, role=lin.role)


def heuristic_spec(shape: tuple, mesh, *, skip_dims: tuple = ()) -> P:
    """Greedy fallback for stacked caches / states: assign each mesh
    axis (largest first) to the largest unassigned divisible dim."""
    axes: list = [None] * len(shape)
    order = sorted(mesh.shape.items(), key=lambda kv: -kv[1])
    taken = set(skip_dims)
    for name, size in order:
        cands = [(d, shape[d]) for d in range(len(shape))
                 if d not in taken and axes[d] is None
                 and shape[d] % size == 0 and shape[d] >= size]
        if not cands:
            continue
        d = max(cands, key=lambda c: c[1])[0]
        axes[d] = name
        taken.add(d)
    return P(*axes)


def _stacked(spec: P, leaf_ndim: int, base_ndim: int) -> P:
    """Prepend None axes for leading stacking dims."""
    extra = leaf_ndim - base_ndim
    return P(*([None] * extra), *spec)


def _map_specs(fn, tree):
    return tree_map(fn, tree, is_leaf=is_spec)


def _arrays(node) -> list[str]:
    """The tensor fields of a quantized tensor."""
    return [f.name for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)]


def param_specs(params: Any, mesh, *, fsdp: bool = True) -> Any:
    """Spec tree matching a parameter (or optimizer-moment) tree.

    ``Linear`` leaves follow ROLE_RULES (leading stacked dims
    replicated); bare quantized tensors (quantized moments of
    non-``Linear`` leaves) shard dim 0 over every axis of (data, model,
    pod) that divides it; every other tensor is replicated (``P()``).
    ``fsdp=False`` (serving) drops the ``data`` entries of the Linear
    specs.

    A bare quantized tensor of a layer (under a ``layers`` list) is
    replicated: the reference's dim 0 there is the stacked period axis,
    whose trailing dims it leaves unsharded; where the period count
    divides a mesh axis the reference spreads whole periods over it,
    which a per-layer leaf cannot express."""
    def linear(node):
        base = linear_specs(_unstack_linear(node), mesh)
        if not fsdp:
            base = _map_specs(lambda sp: P(*[None if ax == "data" else ax
                                             for ax in sp]), base)

        def fix(spec, arr):
            if spec is None or arr is None:
                return None
            if isinstance(arr, QTYPES):
                return dataclasses.replace(spec, **{
                    f: _stacked(getattr(spec, f), getattr(arr, f).dim(),
                                len(getattr(spec, f))) for f in _arrays(arr)})
            return _stacked(spec, arr.dim(), len(spec))
        return Linear(w=fix(base.w, node.w), b=fix(base.b, node.b), role=node.role)

    def flat_spec(a, in_layer: bool):
        ax = []
        prod = 1
        for name in ("data", "model", "pod"):
            if in_layer:
                break
            if name in mesh.shape and a.shape[0] % (prod * mesh.shape[name]) == 0:
                ax.append(name)
                prod *= mesh.shape[name]
        lead = tuple(ax) if len(ax) > 1 else (ax[0] if ax else None)
        return P(lead, *([None] * (a.dim() - 1)))

    def walk(node, in_layer: bool):
        if isinstance(node, Linear):
            return linear(node)
        if isinstance(node, QTYPES):
            return dataclasses.replace(node, **{f: flat_spec(getattr(node, f), in_layer)
                                                for f in _arrays(node)})
        if isinstance(node, torch.Tensor):
            return P()
        if isinstance(node, dict):
            return {k: walk(v, in_layer or (k == "layers" and isinstance(v, list)))
                    for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, in_layer) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, in_layer) for v in node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{f.name: walk(getattr(node, f.name), in_layer)
                                                for f in dataclasses.fields(node)})
        return node
    return walk(params, False)


def _sds(t: torch.Tensor, nd: int) -> torch.Tensor:
    """A meta tensor of ``t``'s trailing ``nd`` dims (a shape stand-in)."""
    nd = min(nd, t.dim())
    return torch.empty(tuple(t.shape[t.dim() - nd:]), dtype=t.dtype, device="meta")


def _unstack_linear(lin: Linear) -> Linear:
    """View of a (possibly stacked) Linear with the logical trailing dims
    only: the rules are written against logical (N, K), or (E, N, K) for
    experts."""
    nd = 3 if lin.role.startswith("expert") else 2
    w = lin.w
    if isinstance(w, (Q8_0Tensor, Q4_0Tensor)):
        w = type(w)(_sds(w.qs, nd), _sds(w.d, nd), w.logical)
    elif isinstance(w, Q3KTensor):
        w = Q3KTensor(_sds(w.ql, nd), _sds(w.qh, nd), _sds(w.scales, nd + 1),
                      _sds(w.d, nd), w.scale_bits)
    else:
        w = _sds(w, nd)
    b = lin.b
    if isinstance(b, QTYPES):
        b = type(b)(_sds(b.qs, 1), _sds(b.d, 1), b.logical)
    elif b is not None:
        b = _sds(b, 1)
    return Linear(w=w, b=b, role=lin.role)


def _is_array(x) -> bool:
    """A tensor or a numpy array (a batch may hold either)."""
    return hasattr(x, "shape") and not isinstance(x, QTYPES)


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def cache_specs(cache: Any, mesh) -> Any:
    """Decode-cache specs for period-stacked states (the reference's
    layout: dim 0 = period, replicated; dim 1 = batch).  Batch shards
    over (pod, data) when divisible; the largest trailing dim (a KV
    cache's capacity) shards over ``model``, and also over the data axes
    when the batch cannot use them (batch-1 long-context decode).  The
    port's per-layer caches take a leading period axis of 1 first."""
    data_axes = _data_axes(mesh)
    data_sz = math.prod(mesh.shape[a] for a in data_axes) if data_axes else 1

    def leaf_spec(a):
        if len(a.shape) < 2:
            return P()
        shape = a.shape
        axes: list = [None] * len(shape)
        b = shape[1]
        batch_on_data = bool(data_axes) and b % data_sz == 0
        if batch_on_data:
            axes[1] = data_axes if len(data_axes) > 1 else data_axes[0]
        cands = list(range(2, len(shape)))
        if not cands:
            return P(*axes)
        big = max(cands, key=lambda d: shape[d])
        want = ["model"] if batch_on_data else ["model", *data_axes]
        sz = 1
        got = []
        for ax in want:
            if shape[big] % (sz * mesh.shape[ax]) == 0:
                got.append(ax)
                sz *= mesh.shape[ax]
        if got:
            axes[big] = tuple(got) if len(got) > 1 else got[0]
        return P(*axes)
    return tree_map(leaf_spec, cache, is_leaf=_is_array)


def batch_specs(tree: Any, mesh) -> Any:
    """Input batch: dim 0 (the global batch) over every data-ish axis
    that divides it, in (pod, data) order; everything else replicated."""
    data_axes = [a for a in ("pod", "data") if a in mesh.shape]

    def leaf_spec(a):
        if len(a.shape) == 0:
            return P()
        b = a.shape[0]
        use = []
        prod = 1
        for ax in data_axes:
            if b % (prod * mesh.shape[ax]) == 0:
                use.append(ax)
                prod *= mesh.shape[ax]
        return P(tuple(use) if use else None, *([None] * (len(a.shape) - 1)))
    return tree_map(leaf_spec, tree, is_leaf=_is_array)


# ------------------------------------------------- rank slices and gathers

def over(spec, axes) -> Any:
    """``spec`` (a ``P``, a quantized tensor's spec tree, or a tree of
    them) with only its entries on ``axes``: the cut that sharding over
    those axes alone makes.  A dim sharded over an axis of ``axes`` minor
    to one outside them is refused (its slices over ``axes`` alone are not
    contiguous)."""
    if not _is_spec_leaf(spec):
        return tree_map(lambda s: over(s, axes), spec, is_leaf=_is_spec_leaf)
    if isinstance(spec, QTYPES):
        return dataclasses.replace(spec, **{f: over(getattr(spec, f), axes)
                                            for f in _arrays(spec)})
    parts = []
    for entry in spec:
        names = _axes(entry)
        kept = tuple(a for a in names if a in axes)
        if kept != names[:len(kept)] and kept:
            raise ValueError(f"{spec}: {entry} mixes axes in and out of {tuple(axes)}")
        parts.append(kept or None)
    return P(*parts)


def _dim_slot(entry, mesh, coords: dict) -> tuple[int, int]:
    """(index, count) of a rank's slice along a dim sharded over
    ``entry``'s axes, major to minor."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def _cut(x: torch.Tensor, spec: P, mesh, coords: dict) -> torch.Tensor:
    out = x
    for dim, entry in enumerate(spec):
        idx, n = _dim_slot(entry, mesh, coords)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {entry}")
        size = x.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out if out is x else out.clone()


def local_shard(x, spec, mesh, coords: dict):
    """The slice of leaf ``x`` that the rank at ``coords`` holds under
    ``spec`` (a copy; ``x`` itself when the spec cuts nothing)."""
    if isinstance(x, QTYPES):
        return dataclasses.replace(x, **{f: _cut(getattr(x, f), getattr(spec, f), mesh, coords)
                                         for f in _arrays(x)})
    return _cut(x, spec, mesh, coords)


def _steps(spec: P, mesh) -> list[tuple[int, str]]:
    """The all-gathers that rebuild an array: (dim, axis), a dim's minor
    axis first."""
    return [(dim, a) for dim, entry in enumerate(spec) for a in reversed(_axes(entry))
            if mesh.shape[a] > 1]


def _gather_packed(xs: list[torch.Tensor], axis: str, mesh) -> list[torch.Tensor]:
    """All-gather each of ``xs`` along its dim 0 over ``axis``, in one
    collective: the arrays travel as one byte buffer (``tp.all_gather``'s
    transport: through host memory for CUDA tensors on a gloo group)."""
    from repro_torch.distributed import tp
    n = mesh.shape[axis]
    flats = [x.contiguous().reshape(-1).view(torch.uint8) for x in xs]
    buf = torch.cat(flats)
    whole = tp.all_gather(buf[None], mesh.axis_group(axis), 0)
    sizes = [f.numel() for f in flats]
    pieces = [whole[c].split(sizes) for c in range(n)]
    return [torch.cat([pieces[c][j].view(x.dtype).reshape(x.shape) for c in range(n)], 0)
            for j, x in enumerate(xs)]


def _gather_arrays(arrays: list[torch.Tensor], specs: list[P], mesh) -> list[torch.Tensor]:
    """Whole arrays from every rank's slices, contiguous as the whole
    leaves were: in round k each array takes its k-th (dim, axis) gather,
    one packed collective per axis."""
    out = list(arrays)
    plans = [_steps(sp, mesh) for sp in specs]
    for k in range(max((len(pl) for pl in plans), default=0)):
        by_axis: dict[str, list[int]] = {}
        for i, pl in enumerate(plans):
            if k < len(pl):
                by_axis.setdefault(pl[k][1], []).append(i)
        for axis, idx in by_axis.items():
            moved = [out[i].movedim(plans[i][k][0], 0) for i in idx]
            for i, g in zip(idx, _gather_packed(moved, axis, mesh)):
                out[i] = g.movedim(0, plans[i][k][0])
    return [a.contiguous() for a in out]


def _scatter_packed(xs: list[torch.Tensor], axis: str, mesh) -> list[torch.Tensor]:
    """Sum each of ``xs`` over ``axis`` in f32 and keep this rank's slice
    of its dim 0, in one collective: the arrays are packed as the rows of
    one (n, total) f32 buffer, row c the slices that go to coordinate c
    (``tp.reduce_scatter``'s transport: through host memory for CUDA
    tensors on a gloo group)."""
    from repro_torch.distributed import tp
    g = mesh.axis_group(axis)
    n = g.size
    runs = [x.numel() // n for x in xs]
    buf = torch.empty((n, sum(runs)), dtype=torch.float32, device=xs[0].device)
    at = 0
    for x, run in zip(xs, runs):
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over {axis}")
        rows = (n, x.shape[0] // n, *x.shape[1:])
        buf[:, at:at + run].unflatten(1, rows[1:]).copy_(x.unflatten(0, rows[:2]))
        at += run
    mine = tp.reduce_scatter(buf, g, 0)[0]
    return [part.reshape(x.shape[0] // n, *x.shape[1:])
            for part, x in zip(mine.split(runs), xs)]


def _sum_packed(xs: list[torch.Tensor], axis: str, mesh) -> list[torch.Tensor]:
    """Each of ``xs`` (f32) summed over ``axis``, in one all-reduce."""
    import torch.distributed as dist
    buf = torch.cat([x.float().reshape(-1) for x in xs])
    dist.all_reduce(buf, group=mesh.group(axis))
    return [part.reshape(x.shape) for part, x in zip(buf.split([x.numel() for x in xs]), xs)]


def _back_steps(spec: P, mesh, batch_axes: tuple) -> list[tuple]:
    """The steps that take an array of ``spec`` from whole to this rank's
    slice, summed over ``batch_axes``: (kind, dim, axis), the gathers of
    :func:`_steps` in reverse as a "scatter" (a reduce-scatter) over a
    batch axis or a "cut" over another, then a "sum" (an all-reduce) over
    each batch axis that does not cut the array."""
    steps = list(reversed(_steps(spec, mesh)))
    cut = {a for _, a in steps}
    return ([("scatter" if a in batch_axes else "cut", dim, a) for dim, a in steps]
            + [("sum", None, a) for a in batch_axes if a not in cut])


def collectives(specs: list[P], mesh, batch_axes: tuple | None = None) -> int:
    """The packed collectives that :func:`_gather_arrays` (``batch_axes``
    None) or :func:`_scatter_arrays` issues for arrays of ``specs``: one
    per (round, kind, axis)."""
    if batch_axes is None:
        return len({(k, a) for sp in specs for k, (_, a) in enumerate(_steps(sp, mesh))})
    return len({(k, kind, a) for sp in specs
                for k, (kind, _, a) in enumerate(_back_steps(sp, mesh, batch_axes))
                if kind != "cut"})


def _scatter_arrays(arrays: list[torch.Tensor], specs: list[P], mesh,
                    batch_axes: tuple) -> list[torch.Tensor]:
    """The way back of :func:`_gather_arrays`: whole arrays, one per rank
    (each rank's own values), summed in f32 over ``batch_axes`` -> this
    rank's slices under ``specs``.  Each array takes its gathers in
    reverse (a dim's major axis first): over an axis that splits the batch
    a reduce-scatter, over another a cut of the rank's own slice (the
    batch is the same there: no sum); then an all-reduce over each axis of
    ``batch_axes`` that does not cut it.  In round k each array takes its
    k-th step, one packed collective per (round, kind, axis)."""
    out = list(arrays)
    coords = mesh.own_coords()
    plans = [_back_steps(sp, mesh, batch_axes) for sp in specs]
    for k in range(max((len(pl) for pl in plans), default=0)):
        by_step: dict[tuple, list[int]] = {}
        for i, pl in enumerate(plans):
            if k >= len(pl):
                continue
            kind, dim, a = pl[k]
            if kind == "cut":
                size = out[i].shape[dim] // mesh.shape[a]
                out[i] = out[i].narrow(dim, coords[a] * size, size)
            else:
                by_step.setdefault((kind, a), []).append(i)
        for (kind, a), idx in by_step.items():
            if kind == "sum":
                for i, s in zip(idx, _sum_packed([out[i] for i in idx], a, mesh)):
                    out[i] = s
                continue
            dims = [plans[i][k][1] for i in idx]
            moved = [out[i].movedim(d, 0) for i, d in zip(idx, dims)]
            for i, d, s in zip(idx, dims, _scatter_packed(moved, a, mesh)):
                out[i] = s.movedim(0, d)
    return [a.float().contiguous() for a in out]


def _fields(x, spec) -> tuple[list, list]:
    """A leaf's arrays and their specs."""
    if isinstance(x, QTYPES):
        names = _arrays(x)
        return [getattr(x, f) for f in names], [getattr(spec, f) for f in names]
    return [x], [spec]


def _rebuild(x, arrays: list):
    if isinstance(x, QTYPES):
        return dataclasses.replace(x, **dict(zip(_arrays(x), arrays)))
    return arrays[0]


def gather(x_local, spec, mesh):
    """The whole leaf from every rank's ``local_shard`` (all-gathers over
    the spec's axes; ``x_local`` itself when the spec cuts nothing).
    Every rank of the mesh calls it."""
    return gather_tree([x_local], [spec], mesh)[0]


def spec_leaves(specs: Any) -> list:
    """The spec of each leaf (tensor or quantized tensor) of the matching
    tree, in ``tree_leaves`` order."""
    return tree_leaves(specs, is_leaf=_is_spec_leaf)


def _is_qleaf(x) -> bool:
    return isinstance(x, QTYPES)


def _paired(tree: Any, specs: Any) -> tuple[list, list]:
    """The leaves (tensors and quantized tensors) of ``tree`` and their
    specs, in traversal order."""
    leaves, sl = tree_leaves(tree, is_leaf=_is_qleaf), spec_leaves(specs)
    if len(leaves) != len(sl):
        raise ValueError(f"a tree of {len(leaves)} leaves and {len(sl)} specs")
    return leaves, sl


def _replaced(tree: Any, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree, is_leaf=_is_qleaf)


def shard_tree(tree: Any, specs: Any, mesh, coords: dict) -> Any:
    """:func:`local_shard` of every leaf of ``tree``."""
    leaves, sl = _paired(tree, specs)
    return _replaced(tree, [local_shard(x, s, mesh, coords) for x, s in zip(leaves, sl)])


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """:func:`gather` of every leaf of ``tree``, the leaves' arrays packed
    into one collective per (round, axis)."""
    leaves, sl = _paired(tree, specs)
    arrays, aspecs, counts = [], [], []
    for x, sp in zip(leaves, sl):
        a, s = _fields(x, sp)
        arrays += a
        aspecs += s
        counts.append(len(a))
    whole = iter(_gather_arrays(arrays, aspecs, mesh))
    return _replaced(tree, [_rebuild(x, [next(whole) for _ in range(c)])
                            for x, c in zip(leaves, counts)])
