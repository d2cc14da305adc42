"""Training launcher of the port (the twin of ``repro.launch.train``).

  python -m repro_torch.launch.train --arch granite-8b [--reduced] \
      [--steps N] [--batch 8] [--seq 128] [--microbatch 0] \
      [--quantized-moments] [--grad-compression] [--resume auto] \
      [--ckpt-dir DIR] [--ckpt-every 25] [--device cuda]

  python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.train --arch granite-8b --device cpu --reduced

One process per rank.  Rank, world size and the rendezvous come from
the standard ``torchrun`` variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): ``nccl`` with
``--device cuda`` (each rank on card ``LOCAL_RANK``), ``gloo`` with
``--device cpu``.  Without them the same code runs at one rank through a
one-rank group; a caller that has set up the default group already
(a test, on a file store) keeps it.

As in the reference, it builds the elastic mesh over the live ranks
(``elastic_mesh``, ``pod_size=256``) and prints it, and trains under
that mesh's axis env with the parameters and the AdamW state sharded by
``sharding.param_specs`` (``train_step.ShardedTrainStep``).  Ranks that
the mesh leaves out (``elastic_mesh`` keeps whole pods of equal size)
take part in building its groups and then idle, as the reference leaves
such devices idle.  The model axis follows the reference's rule where
that rule can build a mesh (:func:`model_parallel`): 16 from 16 ranks on
(tensor- and expert-parallel compute for the dense, VLM and MoE
families), 1 at one rank.  At 2-15 ranks the reference's rule (16 on any
world above one device) raises, since ``elastic_mesh`` cannot build a
mesh of fewer ranks than its model axis; there the port keeps a model
axis of 1 (data parallelism and FSDP only).

It draws the parameters with ``init_lm`` (seed ``TrainConfig.seed``) on
every rank and keeps the rank's slices, resumes from the newest
checkpoint in ``--ckpt-dir`` unless ``--resume none`` (every rank reads
the whole state and keeps its slices, whatever world size wrote it),
feeds the global ``TokenPipeline`` batches (started at the resumed step,
so a resumed run sees the batches the interrupted one would have)
through the step (``remat="block"``), times each step into a
``Watchdog``, and saves the parameters and the AdamW state every
``--ckpt-every`` steps and at the last one (gathered, written by rank
0), keeping the newest three.  The compression residual is not saved,
as in the reference.  Rank 0 prints.

``--reduced`` (the default with ``--device cpu``) trains the config's
CPU-scale twin.  The batches carry tokens and labels only, so an
encoder-decoder arch (which needs ``enc_embeds``) is refused, as the
reference's loss refuses it.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device, sync_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs import TrainConfig, get_config, reduced as reduce_cfg
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import ctx as axctx
from repro_torch.distributed.fault_tolerance import (StepTimer, Watchdog,
                                                     elastic_mesh)
from repro_torch.models.transformer import init_lm
from repro_torch.train.train_step import init_train_state, make_train_step


def model_parallel(world: int) -> int:
    """The launcher's model axis at ``world`` ranks: the reference's 16
    from 16 ranks on, else 1 (the reference raises at 2-15 ranks)."""
    return 16 if world >= 16 else 1


def _init_group(device: torch.device) -> bool:
    """Join the default process group (torchrun's variables, else a
    one-rank group); -> whether this call made it."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


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
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
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
    own = _init_group(device)
    try:
        _train(args, cfg, tcfg, device)
    finally:
        if own:
            dist.destroy_process_group()


def _train(args, cfg, tcfg: TrainConfig, device: torch.device) -> None:
    rank, world = dist.get_rank(), dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"train {cfg.name} on {device}: {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, batch {args.batch} x {args.seq}")
    mesh = elastic_mesh(model_parallel=model_parallel(world), pod_size=256)
    say(f"mesh: {dict(mesh.shape)} on {world} devices ({dist.get_backend()})")
    if world > mesh.size:
        mesh.device_mesh()          # every rank takes part in making its groups
        if not mesh.owns():
            print(f"rank {rank}: outside the {mesh.size}-rank mesh, idle")
            return

    with axctx.axis_env(mesh):
        params, opt, comp = init_train_state(
            torch.Generator(device=device).manual_seed(tcfg.seed), cfg, tcfg,
            init_lm)
        step = make_train_step(cfg, tcfg, device=device, mesh=mesh)
        params, opt = step.shard(params, opt)
        comp = step.shard_residual(comp)
        specs = {"params": step.specs[0], "opt": step.specs[1]}

        start = 0
        if args.resume == "auto":
            last = ckpt.latest_step(tcfg.ckpt_dir)
            if last is not None:
                restored, man = ckpt.restore_sharded(
                    tcfg.ckpt_dir, last, {"params": params, "opt": opt}, specs, mesh)
                params, opt, start = (restored["params"], restored["opt"],
                                      man["step"])
                say(f"resumed at step {start}")

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
                    say(f"step {i} loss {float(m['loss']):.4f}")
                if (i + 1) % tcfg.ckpt_every == 0 or i == tcfg.steps - 1:
                    ckpt.save_sharded(tcfg.ckpt_dir, i + 1,
                                      {"params": params, "opt": opt}, specs, mesh,
                                      meta={"seed": tcfg.seed, **pipe.state()})
                    if rank == 0:
                        ckpt.gc_old(tcfg.ckpt_dir)
        finally:
            pipe.close()
    if watchdog.suspects:
        say(f"straggler-suspect steps: {watchdog.suspects}")


if __name__ == "__main__":
    main()
