"""Training launcher of the port (the twin of ``repro.launch.train``),
single-process on one device.

  python -m repro_torch.launch.train --arch granite-8b [--reduced] \
      [--steps N] [--batch 8] [--seq 128] [--microbatch 0] \
      [--quantized-moments] [--grad-compression] [--resume auto] \
      [--ckpt-dir DIR] [--ckpt-every 25] [--device cuda]

It draws the parameters with ``init_lm`` (seed ``TrainConfig.seed``),
resumes from the newest checkpoint in ``--ckpt-dir`` unless ``--resume
none``, feeds ``TokenPipeline`` batches (started at the resumed step, so
a resumed run sees the batches the interrupted one would have) through
``make_train_step`` (``remat="block"``), times each step into a
``Watchdog``, and saves the parameters and the AdamW state every
``--ckpt-every`` steps and at the last one, keeping the newest three.
The compression residual is not saved, as in the reference.

``--reduced`` (the default with ``--device cpu``) trains the config's
CPU-scale twin.  The reference also builds an elastic device mesh and
shards the parameters over it; that belongs to the distribution slice
and is not here: this launcher runs one process on one device.  The
batches carry tokens and labels only, so an encoder-decoder arch (which
needs ``enc_embeds``) is refused, as the reference's loss refuses it.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device, sync_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs import TrainConfig, get_config, reduced as reduce_cfg
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.fault_tolerance import StepTimer, Watchdog
from repro_torch.models.transformer import init_lm
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale config (default on the cpu device)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--quantized-moments", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--ckpt-dir", default=TrainConfig.ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced or device.type == "cpu":
        cfg = reduce_cfg(cfg)
    if cfg.is_enc_dec:
        raise SystemExit(f"{cfg.name}: an encoder-decoder arch needs "
                         "enc_embeds, which the token pipeline does not make")
    tcfg = TrainConfig(microbatch=args.microbatch,
                       quantized_moments=args.quantized_moments,
                       grad_compression=args.grad_compression,
                       remat="block", ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, steps=args.steps)
    print(f"train {cfg.name} on {device}: {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, batch {args.batch} x {args.seq}")

    params, opt, comp = init_train_state(
        torch.Generator(device=device).manual_seed(tcfg.seed), cfg, tcfg,
        init_lm)
    step = make_train_step(cfg, tcfg, device=device)

    start = 0
    if args.resume == "auto":
        last = ckpt.latest_step(tcfg.ckpt_dir)
        if last is not None:
            restored, man = ckpt.restore(tcfg.ckpt_dir, last,
                                         {"params": params, "opt": opt})
            params, opt, start = (restored["params"], restored["opt"],
                                  man["step"])
            print(f"resumed at step {start}")

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch=args.batch, seed=tcfg.seed, start_step=start)
    watchdog = Watchdog()
    timer = StepTimer(watchdog)
    try:
        for i in range(start, tcfg.steps):
            batch = next(pipe)
            with timer:
                params, opt, comp, m = step(params, opt, comp, batch)
                sync_device(device)
            if i % 10 == 0:
                print(f"step {i} loss {float(m['loss']):.4f}")
            if (i + 1) % tcfg.ckpt_every == 0 or i == tcfg.steps - 1:
                ckpt.save(tcfg.ckpt_dir, i + 1,
                          {"params": params, "opt": opt},
                          meta={"seed": tcfg.seed, **pipe.state()})
                ckpt.gc_old(tcfg.ckpt_dir)
    finally:
        pipe.close()
    if watchdog.suspects:
        print(f"straggler-suspect steps: {watchdog.suspects}")


if __name__ == "__main__":
    main()
