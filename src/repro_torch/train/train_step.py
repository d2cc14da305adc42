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
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models.transformer import lm_forward
from repro_torch.optim import adamw, compression


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE. logits: (B, S, V) f32; labels: (B, S)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -torch.mean(ll)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """``loss_fn(params, batch) -> (ce + aux, {"loss": ce, "aux": aux})``."""
    def loss_fn(params, batch):
        logits, aux = lm_forward(
            params, cfg, batch["tokens"],
            enc_embeds=batch.get("enc_embeds"),
            prefix_embeds=batch.get("prefix_embeds"),
            remat=tcfg.remat)
        ce = cross_entropy(logits, batch["labels"])
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, device="cuda"):
    """``train_step(params, opt_state, comp_state, batch) -> (params,
    opt_state, comp_state, metrics)`` with ``metrics`` ``loss``, ``aux``
    and ``grad_norm`` (0-d tensors).  ``batch`` holds ``tokens`` and
    ``labels`` (B, S) (numpy or tensors, moved to ``device``) and, where
    the config needs them, ``enc_embeds`` or ``prefix_embeds``.  With
    ``tcfg.microbatch`` below B the gradient is the f32 mean over
    B / microbatch microbatches, each added as ``g / nm`` in order."""
    device = resolve_device(device)
    grad_fn = value_and_grad(make_loss_fn(cfg, tcfg))

    def train_step(params, opt_state: adamw.AdamState, comp_state,
                   batch: dict[str, Any]):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        b = batch["tokens"].shape[0]
        if tcfg.microbatch and tcfg.microbatch < b:
            mb = tcfg.microbatch
            nm = b // mb
            split = {k: v.reshape(nm, mb, *v.shape[1:]) for k, v in batch.items()}
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(nm):
                (_, metrics), grads = grad_fn(params, {k: v[i] for k, v in split.items()})
                acc = iter([a + g.float() / nm for a, g in
                            zip(tree_leaves(gacc), tree_leaves(grads))])
                del grads
                gacc = tree_map(lambda _: next(acc), gacc)
                loss = loss + metrics["loss"] / nm
            grads = gacc
            metrics = {"loss": loss,
                       "aux": torch.zeros((), dtype=torch.float32, device=device)}
        else:
            (_, metrics), grads = grad_fn(params, batch)

        if tcfg.grad_compression:
            grads, comp_state = compression.apply_compression(grads, comp_state)

        params, opt_state = adamw.adam_update(grads, opt_state, params, tcfg)
        metrics = dict(metrics, grad_norm=adamw.global_norm(grads))
        return params, opt_state, comp_state, metrics

    return train_step


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
