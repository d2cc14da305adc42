"""Time the transport of the sharded train step's per-layer collectives
between two gloo ranks on one card.

    python3 tools/gloo_transport.py

NCCL refuses two ranks on one device, so ``chip_smoke.py``'s ``full_tp``
runs its ranks on gloo, which gathers and reduce-scatters only CPU
tensors: ``distributed.tp.all_gather`` and ``tp.reduce_scatter`` stage a
CUDA tensor through pinned host memory.  At the sizes of one granite-8b
layer at data 2 (0.218 GB of bf16 slices a rank, a 0.872 GB f32
gradient) this prints the host ms (the best of 3, each between two
``torch.cuda.synchronize()``) of those two, of the same collectives on
CPU tensors (gloo alone), of gloo's own all-reduce of a CUDA tensor (it
stages internally), and of the copies between the card and pageable or
pinned host memory; and the card's name and power limit.  Two processes
on ``cuda:0``, a ``FileStore`` in a temporary directory; it needs one
card.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HALF = 218_103_808          # bytes of half a bf16 granite-8b layer


def _best(fn, dist, torch) -> float:
    fn()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return min(times)


def rank_main(rank: int, store: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import tp
    from repro_torch.launch.mesh import Mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    g = Mesh(np.arange(2).reshape(2, 1), ("data", "model")).axis_group("data")
    x8 = torch.ones(HALF, dtype=torch.uint8, device="cuda")
    grad = torch.ones(HALF // 2, dtype=torch.float32, device="cuda")
    host8, host = x8.cpu(), grad.cpu()
    pinned = torch.empty(grad.shape, dtype=grad.dtype, pin_memory=True)

    def cpu_gather():
        dist.all_gather([torch.empty_like(host8) for _ in range(2)], host8, group=g.group)

    def cpu_scatter():
        dist.reduce_scatter(torch.empty_like(host.chunk(2)[0]), list(host.chunk(2)),
                            group=g.group)

    def cuda_all_reduce():
        dist.all_reduce(grad.clone(), group=g.group)

    cases = [
        ("tp.all_gather, 0.218 GB a rank (staged)", lambda: tp.all_gather(x8[None], g, 0)),
        ("tp.reduce_scatter, 0.872 GB f32 (staged)", lambda: tp.reduce_scatter(grad, g, 0)),
        ("gloo all_gather of CPU tensors, 0.218 GB a rank", cpu_gather),
        ("gloo reduce_scatter of CPU tensors, 0.872 GB f32", cpu_scatter),
        ("gloo all_reduce of a CUDA tensor, 0.872 GB f32", cuda_all_reduce),
        ("card to pageable host, 0.872 GB", lambda: grad.cpu()),
        ("card to pinned host, 0.872 GB", lambda: pinned.copy_(grad)),
        ("pageable host to card, 0.872 GB", lambda: host.cuda()),
        ("pinned host to card, 0.872 GB", lambda: pinned.cuda()),
    ]
    for name, fn in cases:
        ms = _best(fn, dist, torch)
        if rank == 0:
            print(f"{name}: {ms:.1f} ms", flush=True)
    dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) == 3:
        rank_main(int(sys.argv[1]), sys.argv[2])
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen([sys.executable, __file__, str(r), os.path.join(d, "store")])
                 for r in range(2)]
        return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())
