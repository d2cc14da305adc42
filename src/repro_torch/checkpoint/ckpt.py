"""Atomic, resumable checkpointing (``repro.checkpoint.ckpt``).

The reference's contract, kept:

* **Atomicity** — a checkpoint is written to ``step_XXXXXXXX.tmp/`` and
  renamed only after every array file and the manifest are fsynced; a
  crash mid-write never corrupts the latest valid checkpoint, and
  ``.tmp`` directories are ignored.
* **Provenance** — ``manifest.json`` records the step and the caller's
  metadata (seed, the data pipeline's cursor); the pipeline is
  deterministic in (seed, step), so a resumed run replays no batch twice
  and skips none.
* **Layout** — one ``{name}.npz`` per named tree, keyed
  ``{i}.{part}[~bf16]`` for leaf ``i``: ``a`` for a tensor, ``q8.qs`` /
  ``q8.d``, ``q4.qs`` / ``q4.d``, ``q3k.ql`` / ``q3k.qh`` /
  ``q3k.scales`` / ``q3k.d`` / ``q3k.sb`` for the quantized tensors;
  bf16 is stored as its uint16 bits and decoded through torch.

Leaves are numbered in ``core.tree``'s traversal of the port's trees
(tensors, ``Q8_0Tensor``, ``Q4_0Tensor``, ``Q3KTensor``, and the
``AdamState`` of ``optim.adamw`` as a tuple of its fields).  The port's
LM trees hold one dict per layer, where the reference's stack layers
over a period axis, so a checkpoint written by one package need not
load in the other; :func:`restore` reads one written by this one, on
the templates' devices.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.core.quant import Q3KTensor, Q4_0Tensor, Q8_0Tensor
from repro_torch.core.tree import tree_leaves, tree_map

_QTYPES = (Q8_0Tensor, Q4_0Tensor, Q3KTensor)


def _is_qleaf(x) -> bool:
    return isinstance(x, _QTYPES)


def _enc(t) -> tuple[np.ndarray, str]:
    """npz-safe encoding: (array, suffix). bfloat16 -> uint16 bits."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "~bf16"
        return t.numpy(), ""
    return np.asarray(t), ""


def _dec(key: str, a: np.ndarray, device) -> torch.Tensor:
    if key.endswith("~bf16"):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf_arrays(i: int, leaf) -> dict[str, np.ndarray]:
    if isinstance(leaf, Q8_0Tensor):
        parts = {"q8.qs": leaf.qs, "q8.d": leaf.d}
    elif isinstance(leaf, Q4_0Tensor):
        parts = {"q4.qs": leaf.qs, "q4.d": leaf.d}
    elif isinstance(leaf, Q3KTensor):
        parts = {"q3k.ql": leaf.ql, "q3k.qh": leaf.qh,
                 "q3k.scales": leaf.scales, "q3k.d": leaf.d,
                 "q3k.sb": np.asarray(leaf.scale_bits)}
    else:
        parts = {"a": leaf}
    out = {}
    for name, arr in parts.items():
        enc, suffix = _enc(arr)
        out[f"{i}.{name}{suffix}"] = enc
    return out


def _find(data, i: int, name: str, device) -> torch.Tensor:
    for suffix in ("", "~bf16"):
        key = f"{i}.{name}{suffix}"
        if key in data:
            return _dec(key, data[key], device)
    raise KeyError(f"{i}.{name}")


def _fsync_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save(path: str, step: int, trees: dict[str, Any],
         meta: dict | None = None) -> str:
    """Save named trees atomically. Returns the final directory."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for name, tree in trees.items():
        arrs: dict[str, np.ndarray] = {}
        for i, leaf in enumerate(tree_leaves(tree, is_leaf=_is_qleaf)):
            arrs.update(_leaf_arrays(i, leaf))
        _fsync_write(os.path.join(tmp, f"{name}.npz"),
                     lambda f: np.savez(f, **arrs))
    manifest = {"step": step, **(meta or {})}
    _fsync_write(os.path.join(tmp, "manifest.json"),
                 lambda f: f.write(json.dumps(manifest).encode()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(path: str) -> int | None:
    steps = _steps(path)
    return steps[-1] if steps else None


def restore(path: str, step: int, templates: dict[str, Any]
            ) -> tuple[dict[str, Any], dict]:
    """Restore named trees using same-structure templates: each leaf
    comes back with the template leaf's structure, on its device."""
    final = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, template in templates.items():
        data = np.load(os.path.join(final, f"{name}.npz"))
        counter = iter(range(len(tree_leaves(template, is_leaf=_is_qleaf))))

        def load(leaf, data=data, counter=counter):
            i = next(counter)
            if isinstance(leaf, Q3KTensor):
                dev = leaf.ql.device
                return Q3KTensor(*(_find(data, i, f"q3k.{f}", dev)
                                   for f in ("ql", "qh", "scales", "d")),
                                 scale_bits=int(_find(data, i, "q3k.sb", "cpu")))
            if isinstance(leaf, (Q8_0Tensor, Q4_0Tensor)):
                tag = "q8" if isinstance(leaf, Q8_0Tensor) else "q4"
                dev = leaf.qs.device
                return type(leaf)(_find(data, i, f"{tag}.qs", dev),
                                  _find(data, i, f"{tag}.d", dev), leaf.logical)
            return _find(data, i, "a", leaf.device)
        out[name] = tree_map(load, template, is_leaf=_is_qleaf)
    return out, manifest


def gc_old(path: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints (bounded disk on long runs)."""
    for s in _steps(path)[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"),
                      ignore_errors=True)
