"""Training step: loss, remat, microbatch accumulation, gradient
compression and the AdamW update (``repro.train.train_step``).

``jax.value_and_grad(has_aux=True)`` becomes ``torch.autograd.grad`` of
the loss over every parameter leaf: the gradients come in each
parameter's dtype, as JAX's do.  Training runs on dense weights (the
reference's ``init_lm`` draws bf16 ``Linear``s, and JAX cannot take a
gradient with respect to an int8 leaf); on the card its one kernel is
``flash_attention``, whose gradient ``kernels.flash_attention.
FlashAttention`` provides.  Every other kernel raises when an input
requires grad (``kernels.ops``).

The parameters and the optimizer state are updated in place
(``optim.adamw.adam_update``); ``train_step`` returns them all the same,
with the reference's signature.

With a mesh (:class:`ShardedTrainStep`) the step places the collectives
that GSPMD places in the reference, so that it computes the reference's
numbers:

* each rank holds its ``sharding.param_specs`` slice of the parameters
  and of the AdamW moments, and never more of them whole than the period
  it is working on (ZeRO-3, ``distributed.fsdp``): each period's slices
  are all-gathered over the FSDP axes just before its forward, and again
  before its backward (by the recomputation under remat "block" /
  "full", by the saved-tensor hooks under "none"), and freed after each;
  the embedding, the head and the final norms likewise at their uses.
  The FSDP axes are ``pod`` / ``data``, and for the families that do not
  compute tensor-parallel (SSM, hybrid, audio) also ``model``, whose
  ranks then compute the same rows.  The dense, VLM and MoE families
  (``TP_FAMILIES``) on a ``model`` axis of more than one rank keep their
  ``model`` slices and compute on them (tensor and expert parallelism:
  the axis env's ``tp_compute``, the layers' ``distributed.tp``
  collectives);
* each rank feeds its rows of the global batch (``batch_specs``; a batch
  that does not divide the data axes is replicated), ``tcfg.microbatch``
  counting global rows; the loss is vocab-parallel (``cross_entropy``);
* each gathered period's gradient is reduce-scattered as soon as autograd
  produces it: summed in f32 over the axes that split the batch, and its
  slices added (divided by the microbatch count) into an f32 accumulator
  of the rank's slices; divided by the ranks that split the batch it is
  the mean.  A leaf that no FSDP axis cuts (a norm) takes its gradient
  from autograd, and it and the loss are averaged by one all-reduce per
  axis (``_mean``); the MoE aux loss takes its means over the whole batch
  (``ctx.batch_mean``);
* compression takes the flat 32-blocks of each whole leaf: a slice that
  keeps whole blocks along every dim its spec cuts is compressed alone,
  another leaf is gathered over the axes that cut it, compressed and cut
  again (``compression.keeps_blocks``; the residual has the gradients'
  layout, the parameters': :meth:`ShardedTrainStep.shard_residual`); the
  clip's global norm sums each leaf's squares over every axis that cuts
  it and counts each replicated leaf once (``adamw.global_norm(split=)``,
  f64 sums: a cut leaf gives the whole leaf's bits);
* each rank updates only its slices.  A quantized moment whose slice
  would cut a Q8_0 block (or that is sliced where its parameter is not)
  is updated whole from its gathered leaf, and cut again.

At one rank it is the unsharded step, bit for bit.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.quant import QTYPES, Q8_0Tensor
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed import ctx, fsdp, sharding, tp
from repro_torch.distributed.sharding import P
from repro_torch.models.transformer import lm_forward
from repro_torch.optim import adamw, compression


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int | None = None) -> torch.Tensor:
    """Mean next-token CE. logits: (B, S, V) f32; labels: (B, S).  With
    ``vocab`` (the whole V) under tensor-parallel compute, ``logits`` is
    this rank's ``ctx.vocab`` range (B, S, V/tp) and the loss is
    vocab-parallel: the max and the sum of exp are all-reduced over
    ``model`` in f32, and the target logit is taken by its owner and
    all-reduced."""
    sl = ctx.vocab((1, 1, vocab)) if vocab else None
    if sl is None or not ctx.is_part(sl, vocab):
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
        return -torch.mean(ll)
    import torch.distributed as dist
    top = tp.all_reduce(logits.detach().amax(-1, keepdim=True), ctx.tp_group().group,
                        dist.ReduceOp.MAX)
    z = logits - top
    lse = torch.log(tp.reduce(torch.exp(z).sum(-1)))
    labels = labels.long()
    own = (labels >= sl.start) & (labels < sl.stop)
    zt = torch.gather(z, -1, torch.where(own, labels - sl.start, 0)[..., None])[..., 0]
    zt = tp.reduce(torch.where(own, zt, zt.new_zeros(())))
    return -torch.mean(zt - lse)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """``loss_fn(params, batch) -> (ce + aux, {"loss": ce, "aux": aux})``."""
    def loss_fn(params, batch):
        logits, aux = lm_forward(
            params, cfg, batch["tokens"],
            enc_embeds=batch.get("enc_embeds"),
            prefix_embeds=batch.get("prefix_embeds"),
            remat=tcfg.remat)
        ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        return ce + aux, {"loss": ce, "aux": aux}
    return loss_fn


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over a parameter
    tree: ``grad_fn(params, batch) -> ((value, aux), grads)``, the
    gradients a tree of the parameters' structure and dtypes (zeros for a
    leaf the loss does not reach), the values detached."""
    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            if not t.is_floating_point():
                raise TypeError(f"train step: a parameter leaf is {t.dtype}; "
                                "training needs dense (float) weights")
        live = [t.detach().requires_grad_(True) for t in leaves]
        it = iter(live)
        tree = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            value, aux = loss_fn(tree, batch)
            grads = torch.autograd.grad(value, live, allow_unused=True)
        grads = iter([torch.zeros_like(t) if g is None else g
                      for t, g in zip(leaves, grads)])
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}
        return (value.detach(), aux), tree_map(lambda _: next(grads), params)
    return grad_fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, device="cuda",
                    mesh=None):
    """``train_step(params, opt_state, comp_state, batch) -> (params,
    opt_state, comp_state, metrics)`` with ``metrics`` ``loss``, ``aux``
    and ``grad_norm`` (0-d tensors).  ``batch`` holds ``tokens`` and
    ``labels`` (B, S) (numpy or tensors, moved to ``device``) and, where
    the config needs them, ``enc_embeds`` or ``prefix_embeds``.  With
    ``tcfg.microbatch`` below B the gradient is the f32 mean over
    B / microbatch microbatches, each added as ``g / nm`` in order.

    With ``mesh`` (a ``launch.mesh.Mesh`` of the default process group,
    or of one rank without one) it is a :class:`ShardedTrainStep`, which
    takes this rank's slices of the parameters and the AdamW state
    (``ShardedTrainStep.shard``) and the whole global batch."""
    if mesh is not None:
        return ShardedTrainStep(cfg, tcfg, device=device, mesh=mesh)
    device = resolve_device(device)
    grad_fn = value_and_grad(make_loss_fn(cfg, tcfg))

    def train_step(params, opt_state: adamw.AdamState, comp_state,
                   batch: dict[str, Any]):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        metrics, grads = _accumulate(grad_fn, params, batch, tcfg)

        if tcfg.grad_compression:
            grads, comp_state = compression.apply_compression(grads, comp_state)

        gn = adamw.global_norm(grads)
        params, opt_state = adamw.adam_update(grads, opt_state, params, tcfg, grad_norm=gn)
        return params, opt_state, comp_state, dict(metrics, grad_norm=gn)

    return train_step


def _accumulate(grad_fn, params, batch: dict[str, torch.Tensor], tcfg: TrainConfig):
    """``(metrics, grads)`` of ``grad_fn(params, batch)``; with
    ``tcfg.microbatch`` below B, over B / microbatch microbatches in
    order: the gradient their f32 mean, each added as ``g / nm``, the
    loss their mean and the aux 0, as in the reference's scan.  (The
    sharded step's ``grad_fn`` returns the gradients of the leaves it
    does not gather; it adds the others into its own accumulator.)"""
    b = batch["tokens"].shape[0]
    if not (tcfg.microbatch and tcfg.microbatch < b):
        (_, metrics), grads = grad_fn(params, batch)
        return metrics, grads
    mb = tcfg.microbatch
    nm = b // mb
    split = {k: v.reshape(nm, mb, *v.shape[1:]) for k, v in batch.items()}
    gacc = None
    device = batch["tokens"].device
    loss = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(nm):
        (_, metrics), grads = grad_fn(params, {k: v[i] for k, v in split.items()})
        if gacc is None:
            gacc = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                  device=g.device), grads)
        acc = iter([a + g.float() / nm for a, g in
                    zip(tree_leaves(gacc), tree_leaves(grads))])
        del grads
        gacc = tree_map(lambda _: next(acc), gacc)
        loss = loss + metrics["loss"] / nm
    return {"loss": loss, "aux": torch.zeros((), dtype=torch.float32, device=device)}, gacc


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tcfg: TrainConfig, init_fn) -> tuple[Any, adamw.AdamState, Any]:
    """``init_fn(gen, cfg)`` -> params, their AdamW state and, with
    ``tcfg.grad_compression``, the compression residuals (else None), on
    ``gen``'s device."""
    params = init_fn(gen, cfg)
    opt_state = adamw.init_adam(params, tcfg)
    comp_state = None
    if tcfg.grad_compression:
        comp_state = compression.init_compression(params)
    return params, opt_state, comp_state


# ------------------------------------------------------------ sharded step

def _padded(spec: P, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _aligned(pspec: P, mspec, ndim: int) -> bool:
    """Whether a moment sliced by ``mspec`` covers exactly the parameter's
    slice under ``pspec`` in whole Q8_0 blocks (an f32 moment: the same
    spec)."""
    if isinstance(mspec, Q8_0Tensor):
        qs, d = _padded(mspec.qs, ndim), _padded(mspec.d, ndim)
        return qs == _padded(pspec, ndim) and d == qs
    return _padded(mspec, ndim) == _padded(pspec, ndim)


TP_FAMILIES = ("dense", "vlm", "moe")     # families that compute on model slices
TP_AXIS = "model"


class ShardedTrainStep:
    """The train step on a mesh (see the module docstring).  :meth:`shard`
    cuts this rank's slices of a whole state (and sets ``specs``, the
    parameter specs and the ``AdamState`` specs); :meth:`gather` rebuilds
    the whole state from every rank's slices; :meth:`shard_residual` and
    :meth:`gather_residual` do so for the compression residual, which
    each rank keeps in its gradients' layout (its parameters' slices).
    ``stats`` is the last step's ``fsdp.Stats`` (None where nothing is
    gathered: no FSDP axis of more than one rank cuts a leaf)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *, device, mesh):
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.device = resolve_device(device)
        self.coords = mesh.own_coords()
        self.specs = None
        self.stats = None
        self.loss_fn = make_loss_fn(cfg, tcfg)
        self.tp = cfg.family in TP_FAMILIES and mesh.shape.get(TP_AXIS, 1) > 1
        self.tp_axes = (TP_AXIS,) if self.tp else ()
        self.fsdp_axes = tuple(a for a in mesh.axis_names if a not in self.tp_axes)

    def shard(self, params, opt_state: adamw.AdamState):
        """This rank's slices of whole ``params`` and ``opt_state``; their
        shapes set :attr:`specs` (the reference's ``param_specs`` of the
        parameters and of each moment tree) under the active axis env."""
        pspec, ospec = self.specs = (
            sharding.param_specs(params, self.mesh),
            adamw.AdamState(step=P(), m=sharding.param_specs(opt_state.m, self.mesh),
                            v=sharding.param_specs(opt_state.v, self.mesh)))
        leaves = sharding.spec_leaves(pspec)
        # Each parameter's spec over the FSDP axes (the gathers at its
        # uses), whether they cut it, and every axis that cuts its slice.
        self._fsdp = [sharding.over(sp, self.fsdp_axes) for sp in leaves]
        self._gathered = [bool(sharding._steps(sp, self.mesh)) for sp in self._fsdp]
        self._cut = [tuple(a for a in self.mesh.axis_names
                           if a in {x for _, x in sharding._steps(sp, self.mesh)})
                     for sp in leaves]
        return (sharding.shard_tree(params, pspec, self.mesh, self.coords),
                sharding.shard_tree(opt_state, ospec, self.mesh, self.coords))

    def gather(self, params, opt_state: adamw.AdamState):
        """The whole ``params`` and ``opt_state`` (every rank calls it)."""
        pspec, ospec = self.specs
        return (sharding.gather_tree(params, pspec, self.mesh),
                sharding.gather_tree(opt_state, ospec, self.mesh))

    def shard_residual(self, comp_state):
        """A whole compression state in this rank's layout (None: None)."""
        if comp_state is None:
            return None
        return compression.CompressionState(residual=sharding.shard_tree(
            comp_state.residual, self.specs[0], self.mesh, self.coords))

    def gather_residual(self, comp_state):
        """The whole compression state (every rank calls it)."""
        if comp_state is None:
            return None
        return compression.CompressionState(residual=sharding.gather_tree(
            comp_state.residual, self.specs[0], self.mesh))

    def _rows(self, batch: dict) -> tuple[dict, tuple]:
        """This rank's rows of a global batch and the axes they split."""
        specs = sharding.batch_specs(batch, self.mesh)
        local = {k: sharding.local_shard(v, specs[k], self.mesh, self.coords)
                 for k, v in batch.items()}
        axes = sharding._axes(specs["tokens"][0])
        return local, tuple(a for a in axes if self.mesh.shape[a] > 1)

    def _mean(self, tree, axes: tuple):
        """Every tensor of ``tree`` averaged over ``axes`` (f32 sums, one
        all-reduce per axis over the leaves packed together), in its own
        dtype; ``tree`` itself when ``axes`` is empty."""
        if not axes:
            return tree
        import torch.distributed as dist
        leaves = tree_leaves(tree)
        buf = torch.cat([t.float().reshape(-1) for t in leaves])
        n = 1
        for a in axes:
            dist.all_reduce(buf, group=self.mesh.group(a))
            n *= self.mesh.shape[a]
        buf = buf / n
        parts = iter(buf.split([t.numel() for t in leaves]))
        return tree_map(lambda t: next(parts).reshape(t.shape).to(t.dtype), tree)

    def _grad_fn(self, params, batch, gathers):
        """``value_and_grad`` on this rank's slices: the gathered leaves
        reach the loss through ``gathers`` (their gradients go into its
        accumulator), the others are differentiated here -> ((value, aux),
        [the others' gradients])."""
        leaves = tree_leaves(params)
        for t in leaves:
            if not t.is_floating_point():
                raise TypeError(f"train step: a parameter leaf is {t.dtype}; "
                                "training needs dense (float) weights")
        live = [t if cut else t.detach().requires_grad_(True)
                for t, cut in zip(leaves, self._gathered)]
        rest = [t for t, cut in zip(live, self._gathered) if not cut]
        it = iter(live)
        tree = tree_map(lambda _: next(it), params)
        wrt = ([gathers.anchor] if gathers is not None else []) + rest
        with torch.enable_grad():
            with fsdp.saving(gathers):
                value, aux = self.loss_fn(tree, batch)
            grads = torch.autograd.grad(value, wrt, allow_unused=True)[len(wrt) - len(rest):]
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(rest, grads)]
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
        return (value.detach(), aux), grads

    def _grads(self, params, batch: dict[str, torch.Tensor]):
        """(metrics, gradients of this rank's slices): the gathered leaves'
        from the per-layer reduce-scatters, the others' (and the loss)
        averaged by :meth:`_mean`."""
        env = ctx.current()
        kw = dict(moe_mode=env.moe_mode if env else "ep", tp_compute=self.tp)
        if env is not None:
            kw.update(dp=env.dp, tp=env.tp or "model")
        leaves = tree_leaves(params)
        b, mb = batch["tokens"].shape[0], self.tcfg.microbatch
        micro = bool(mb and mb < b)
        gathers = None
        if any(self._gathered):
            gathers = fsdp.Gathers(
                self.mesh, [t for t, cut in zip(leaves, self._gathered) if cut],
                [sp for sp, cut in zip(self._fsdp, self._gathered) if cut], self.device,
                microbatches=b // mb if micro else 1)
        axes = ()

        def rows_grad(params, rows):
            """``_grad_fn`` on this rank's part of ``rows``, under an env
            whose MoE aux loss takes its means over the split axes."""
            nonlocal axes
            local, axes = self._rows(rows)
            with ctx.axis_env(self.mesh, batch_axes=axes, fsdp=gathers, **kw):
                return self._grad_fn(params, local, gathers)

        metrics, rest = _accumulate(rows_grad, params, batch, self.tcfg)
        loss, rest = self._mean((metrics["loss"], rest), axes)
        n = math.prod(self.mesh.shape[a] for a in axes)
        acc = iter(gathers.acc if gathers is not None else ())
        rest = iter(rest)
        grads = []
        for t, cut in zip(leaves, self._gathered):
            if not cut:
                grads.append(next(rest))
                continue
            g = next(acc)
            if n > 1:
                g.div_(n)
            grads.append(g if micro else g.to(t.dtype))
        if gathers is not None:
            gathers.acc = None
            self.stats = gathers.stats
        it = iter(grads)
        return dict(metrics, loss=loss), tree_map(lambda _: next(it), params)

    @torch.no_grad()
    def _compress(self, grads, comp_state: compression.CompressionState):
        """Each leaf's compression as the whole leaf's: a slice that keeps
        whole blocks alone, the other leaves (and their residuals)
        gathered over the axes that cut them in one packed collective,
        compressed whole and cut again."""
        mesh, coords = self.mesh, self.coords
        specs = sharding.spec_leaves(self.specs[0])
        gl, rl = tree_leaves(grads), tree_leaves(comp_state.residual)
        if any(g.shape != r.shape for g, r in zip(gl, rl)):
            raise ValueError("ShardedTrainStep: a compression residual is not in the "
                             "gradients' layout: shard_residual() it first")
        out = [None] * len(gl)
        res = [None] * len(gl)
        redo = []
        for i, (g, r, sp) in enumerate(zip(gl, rl, specs)):
            if _keeps_blocks(g.shape, sp, mesh):
                out[i], res[i] = compression.compress_decompress(g, r)
            else:
                redo.append(i)
        if redo:
            whole = sharding.gather_tree([(gl[i], rl[i]) for i in redo],
                                         [(specs[i], specs[i]) for i in redo], mesh)
            for i, (g, r) in zip(redo, whole):
                c, nr = compression.compress_decompress(g, r)
                out[i] = sharding.local_shard(c, specs[i], mesh, coords)
                res[i] = sharding.local_shard(nr, specs[i], mesh, coords)
        outs, ress = iter(out), iter(res)
        return (tree_map(lambda _: next(outs), grads),
                compression.CompressionState(residual=tree_map(lambda _: next(ress),
                                                               comp_state.residual)))

    @torch.no_grad()
    def _update(self, grads, opt_state: adamw.AdamState, params, gn):
        """AdamW on this rank's slices; a leaf whose moment slices do not
        match its parameter's in whole Q8_0 blocks is gathered (its
        parameter, gradient and moments), updated whole and cut again."""
        pspec, ospec = self.specs
        mesh, coords = self.mesh, self.coords
        is_q = lambda x: isinstance(x, QTYPES)   # noqa: E731
        leaves = tree_leaves(params)
        m_leaves = tree_leaves(opt_state.m, is_leaf=is_q)
        v_leaves = tree_leaves(opt_state.v, is_leaf=is_q)
        work_p, work_g, work_m, work_v = (list(leaves), tree_leaves(grads), list(m_leaves),
                                          list(v_leaves))
        specs = list(zip(sharding.spec_leaves(pspec), sharding.spec_leaves(ospec.m),
                         sharding.spec_leaves(ospec.v)))
        redo = [i for i, (p, (ps, ms, vs)) in enumerate(zip(leaves, specs))
                if not (_aligned(ps, ms, p.dim()) and _aligned(ps, vs, p.dim()))]
        if redo:     # their moments, parameters and gradients, whole: one packed gather
            full = sharding.gather_tree(
                [(work_m[i], work_v[i], work_p[i], work_g[i]) for i in redo],
                [(specs[i][1], specs[i][2], specs[i][0], specs[i][0]) for i in redo], mesh)
            for i, (m, v, pw, g) in zip(redo, full):
                work_m[i], work_v[i], work_p[i], work_g[i] = m, v, pw, g
        step = opt_state.step
        _, new = adamw.adam_update(work_g, adamw.AdamState(step, work_m, work_v), work_p,
                                   self.tcfg, grad_norm=gn)
        for i in redo:
            ps, ms, vs = specs[i]
            if work_p[i] is not leaves[i]:
                leaves[i].copy_(sharding.local_shard(work_p[i], ps, mesh, coords))
            for old, full, spec in ((m_leaves[i], work_m[i], ms), (v_leaves[i], work_v[i], vs)):
                cut = sharding.local_shard(full, spec, mesh, coords)
                if is_q(old):
                    old.qs.copy_(cut.qs)
                    old.d.copy_(cut.d)
                else:
                    old.copy_(cut)
        return params, adamw.AdamState(step=new.step, m=opt_state.m, v=opt_state.v)

    def __call__(self, params, opt_state: adamw.AdamState, comp_state,
                 batch: dict[str, Any]):
        if self.specs is None:
            raise RuntimeError("ShardedTrainStep: shard() the whole state first")
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        metrics, grads = self._grads(params, batch)
        if self.tcfg.grad_compression:
            grads, comp_state = self._compress(grads, comp_state)
        gn = adamw.global_norm(grads, split=self._cut, group=self.mesh.group)
        params, opt_state = self._update(grads, opt_state, params, gn)
        return params, opt_state, comp_state, dict(metrics, grad_norm=gn)


def _keeps_blocks(shape: tuple, spec: P, mesh) -> bool:
    """Whether a leaf's slice of ``shape`` under ``spec`` holds whole
    blocks of the whole leaf's compression along every dim the spec
    cuts."""
    parts = [math.prod(mesh.shape[a] for a in sharding._axes(e))
             for e in _padded(spec, len(shape))]
    whole = tuple(n * k for n, k in zip(shape, parts))
    return all(compression.keeps_blocks(whole, dim, k) for dim, k in enumerate(parts) if k > 1)
