"""Time the clip norm of the single-process train step on the card, before
and after its f64 sum.

    python3 tools/norm_cost.py [--layers 36] [--steps 2]

``optim.adamw.global_norm`` sums each gradient leaf's squares in f64
(rounded once to f32), so that a leaf cut over ranks gives the whole
leaf's norm.  Before that it summed f32 squares in f32 (kept here as
``f32_norm``).  On granite-8b at full width (``--layers``
of its 36, 1 x 512 tokens, Q8_0 moments, remat "block": ``chip_smoke.py``
full_train's configuration) this prints, for each of the two:

* the norm alone on one step's bf16 gradient tree: device ms (CUDA
  events around 5 calls, averaged), host ms and kernel launches of one
  call, device-busy ms (torch.profiler's kernel time);
* the train step (``make_train_step`` with ``adamw.global_norm``
  replaced): wall ms of each timed step (synchronised) and the
  device-busy ms of one profiled step,

the two alternated as f32, f64, f64, f32 so that a drift of the card
shows; and the card's name and power limit.  It needs one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def f32_norm(tree, **_):
    """The clip norm before the f64 sum: each leaf's f32 sum of squares,
    summed in f32."""
    from repro_torch.core.tree import tree_leaves
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def busy_ms(fn) -> tuple[float, int]:
    """(device-busy ms, kernel launches) of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return sum(us) / 1e3, len(us)


def event_ms(fn, iters: int = 5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=36)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("norm_cost: no card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (init_train_state, make_loss_fn,
                                              make_train_step, value_and_grad)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=args.layers)
    tc = TrainConfig(quantized_moments=True, remat="block", lr=1e-5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (1, 512), generator=gen, device="cuda")
             for k in ("tokens", "labels")}
    variants = {"f32": f32_norm, "f64": adamw.global_norm}
    order = ("f32", "f64", "f64", "f32")

    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    _, grads = value_and_grad(make_loss_fn(cfg, tc))(params, batch)
    del params
    norms = {}
    for name in order:
        fn = variants[name]
        dev = event_ms(lambda: fn(grads))
        host = host_ms(lambda: fn(grads))
        busy, launches = busy_ms(lambda: fn(grads))
        norms[name] = float(fn(grads))
        print(f"global_norm {name}: {norms[name]!r}; device {dev:.3f} ms (events, mean of 5), "
              f"host {host:.3f} ms, busy {busy:.3f} ms, {launches} kernels; "
              f"{args.layers} layers; {card}")
    del grads
    torch.cuda.empty_cache()

    params, opt, comp = init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg,
                                         tc, init_lm)
    step = make_train_step(cfg, tc, device="cuda")
    inner = adamw.global_norm
    try:
        params, opt, comp, _ = step(params, opt, comp, batch)      # warm-up
        for name in order:
            adamw.global_norm = variants[name]
            walls = []
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, comp, m = step(params, opt, comp, batch)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))

            def one():
                nonlocal params, opt, comp
                params, opt, comp, _ = step(params, opt, comp, batch)
            busy, launches = busy_ms(one)
            print(f"train step {name}: wall {[round(w, 1) for w in walls]} ms synchronised, "
                  f"device busy {busy:.1f} ms, {launches} kernels; loss {float(m['loss']):.4f}; "
                  f"granite-8b {args.layers} layers, 1 x 512, Q8_0 moments, remat block; {card}")
    finally:
        adamw.global_norm = inner
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
