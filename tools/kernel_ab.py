"""Time the port's decode kernels from two builds on one card, in turns.

    python3 tools/kernel_ab.py --base DIR           # another checkout against this one
    python3 tools/kernel_ab.py --set FILE:NAME=V    # this checkout with a constant changed

Side A is the checkout at DIR (for example the parent commit, unpacked
with ``git archive`` under the gitignored ``build/``) or, with ``--set``,
this checkout with ``constexpr int NAME = ...;`` in ``csrc/FILE`` set to
V (the copy is built under ``build/``).  Side B is this checkout.  Each
side runs in its own process, importing that side's ``repro_torch`` and
building its kernels, in the order A, B, B, A, so drift of the card shows
as a difference between the two A runs.  Per case it prints the CUDA-event
time of 20 back-to-back calls (``ms``, which includes the Python wrapper's
host time) and the profiler's device time (``device_ms``), and the card's
name and power limit.  The cases are the decode shapes of
``flash_decode`` and ``flash_decode_paged``; the paged prefill of one
Granite-8B chunk (Hkv 8, G 4, hd 128, bs 16) through
``flash_prefill_paged`` and ``flash_prefill_paged_q8`` at (T, pos0) =
(256, 0), (256, 1792) and (208, 1792); and those of the quantized matmuls
``q4_matmul``, ``q8_matmul`` and ``q3k_matmul``: M = 1..16 on their decode
paths, and the tile paths' shapes above (M = 32, Granite-8B's 256-token
chunk linears, SD-Turbo's), and ``q8_matmul_w8a8`` at ``chip_smoke.py``'s
``W8A8_SHAPES`` (x quantized to Q8_0 once), where each case is also timed
over copies of its weight, each call on the next, that together pass the
L2 cache at the LM shapes (``cold device ms``).  ``--kinds`` limits a run to some of
these kernels (``q4_matmul,flash_decode_paged``).  It needs one card.
"""
from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLASH_DECODE = [(4, 8, 4, 128, 2048, 2000), (4, 8, 4, 128, 2048, 160),
                (1, 8, 4, 128, 2048, 2000), (4, 8, 4, 128, 4096, 4000)]
DECODE_MN = [(m, n, k) for m in (1, 4, 8, 16) for n, k in ((14336, 4096), (4096, 14336))]
# Granite-8B's 256-token chunk linears (and a ragged last chunk) after
# gate/up, on the tile paths.
CHUNK = [(256, 4096, 14336), (256, 4096, 4096), (256, 1024, 4096), (200, 4096, 4096)]
# Granite-8B's generation prefill (make_prefill of 4 prompts of 128
# tokens), on q4_matmul's tile path under q4_0.
GEN_PREFILL = [(512, 14336, 4096), (512, 4096, 14336), (512, 4096, 4096), (512, 1024, 4096)]
Q4 = DECODE_MN + [(32, 14336, 4096), (256, 14336, 4096), (4096, 320, 320),
                  (154, 768, 768), (4096, 2560, 320)] + GEN_PREFILL + CHUNK
Q8 = DECODE_MN + [(4, 4096, 4096), (4, 1024, 4096), (4, 49152, 4096), (32, 14336, 4096),
                  (32, 4096, 14336), (256, 14336, 4096), (4096, 320, 320),
                  (154, 768, 768), (4096, 2560, 320)] + CHUNK
Q3K = DECODE_MN + [(4, 4096, 4096), (4, 1024, 4096), (32, 14336, 4096),
                   (32, 4096, 14336), (256, 14336, 4096), (4096, 320, 1280),
                   (256, 1280, 1280), (154, 768, 768), (64, 1280, 5120)] + CHUNK
PAGED = [(2000, 1990, 2011, 1500)]      # positions; MB 132, Hkv 8, G 4, hd 128, bs 16
PREFILL = [(256, 0), (256, 1792), (208, 1792)]   # (T, pos0); MB 128, Hkv 8, G 4, hd 128


def _w8a8_shapes() -> list[tuple[int, int, int]]:
    """q8_matmul_w8a8's cases: this checkout's ``chip_smoke.W8A8_SHAPES``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.W8A8_SHAPES


def _cuda_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 20) -> float:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return sum(us) / 1e3 / iters if us else float("nan")


def _with_constants(src_root: Path, sets: list[str]) -> Path:
    """A copy of ``src_root``'s csrc under build/ with the constants set."""
    csrc = src_root / "src" / "repro_torch" / "csrc"
    dst = ROOT / "build" / ("ab_csrc_" + re.sub(r"\W", "_", "_".join(sets)))
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(csrc, dst)
    for item in sets:
        fname, assign = item.split(":")
        name, value = assign.split("=")
        path = dst / fname
        text, count = re.subn(rf"constexpr int {name} = -?\d+;",
                              f"constexpr int {name} = {int(value)};", path.read_text())
        if count != 1:
            raise SystemExit(f"kernel_ab: no single 'constexpr int {name}' in {fname}")
        path.write_text(text)
    return dst


def child(src_root: Path, sets: list[str], kinds: set[str] | None) -> None:
    sys.path.insert(0, str(src_root / "src"))
    import torch

    from repro_torch.core import quant
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import q3k_matmul as q3k
    from repro_torch.kernels import q4_matmul as q4
    from repro_torch.kernels import q8_matmul as q8
    if sets:
        build.CSRC = _with_constants(src_root, sets)

    def wanted(kind):
        return kinds is None or kind in kinds
    libs = {"flash_decode": "flash_decode", "flash_decode_paged": "flash_decode",
            "flash_prefill_paged": "flash_prefill", "flash_prefill_paged_q8": "flash_prefill",
            "q4_matmul": "q4_matmul", "q8_matmul": "q8_matmul", "q3k_matmul": "q3k_matmul",
            "q8_matmul_w8a8": "q8_matmul_w8a8"}
    build.build_all(tuple({lib for kind, lib in libs.items() if wanted(kind)}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def record(kind, case, fn):
        fn()
        torch.cuda.synchronize()
        rows.append({"kind": kind, "case": list(case), "ms": _cuda_ms(fn),
                     "device_ms": _device_ms(fn)})

    for case in FLASH_DECODE if wanted("flash_decode") else []:
        b, hkv, g, hd, c, n = case
        q, k, v = bf16(b, hkv, g, hd), bf16(b, hkv, c, hd), bf16(b, hkv, c, hd)
        kv = torch.tensor([n], dtype=torch.int32, device="cuda")
        record("flash_decode", case, lambda: fd.flash_decode(q, k, v, kv))
    for positions in PAGED if wanted("flash_decode_paged") else []:
        b, mb = len(positions), 132
        tables = (torch.randperm(b * mb, generator=gen, device="cuda") + 1).to(
            torch.int32).reshape(b, mb)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        q = bf16(b, 8, 4, 128)
        kpool, vpool = bf16(b * mb + 1, 8, 16, 128), bf16(b * mb + 1, 8, 16, 128)
        record("flash_decode_paged", positions,
               lambda: fd.flash_decode_paged(q, kpool, vpool, tables, pos))
    for on_q8 in (False, True):
        fn = fp.flash_prefill_paged_q8 if on_q8 else fp.flash_prefill_paged
        for t, pos0 in PREFILL if wanted(fn.__name__) else []:
            mb, nb = 128, 168
            table = (torch.randperm(nb - 1, generator=gen, device="cuda")[:mb] + 1).to(
                torch.int32)
            q, kn, vn = bf16(t, 8, 4, 128), bf16(t, 8, 128), bf16(t, 8, 128)
            pools = [bf16(nb, 8, 16, 128), bf16(nb, 8, 16, 128)]
            if on_q8:
                pq = [quant.quantize_q8_0(x.float()) for x in pools]
                pools = [pq[0].qs, pq[1].qs, pq[0].d, pq[1].d]
            record(fn.__name__, (t, pos0), lambda: fn(q, kn, vn, *pools, table, pos0))
    # Each matmul case also runs over copies of its weight (up to 64, as far
    # as 100 MB: past the 50 MB L2 for the LM shapes), each call on the next
    # (``cold_device_ms``), as a serving step finds its weights.  w8a8's x is
    # quantized to Q8_0 once, outside the timed calls.
    def q8_0_pair(x):
        xa = quant.quantize_q8_0(x)
        return xa.qs, xa.d.float()
    for kind, cases, quantize, fn, prep in (
            ("q4_matmul", Q4, quant.quantize_q4_0, lambda x, w: q4.q4_matmul(x, w.qs, w.d),
             None),
            ("q8_matmul", Q8, quant.quantize_q8_0, lambda x, w: q8.q8_matmul(x, w.qs, w.d),
             None),
            ("q3k_matmul", Q3K, quant.quantize_q3_k,
             lambda x, w: q3k.q3k_matmul(x, w.ql, w.qh, w.scales, w.d), None),
            ("q8_matmul_w8a8", _w8a8_shapes(), quant.quantize_q8_0,
             lambda x, w: q8.q8_matmul_w8a8(x[0], x[1], w.qs, w.d), q8_0_pair)):
        for m, n, kdim in cases if wanted(kind) else []:
            x = bf16(m, kdim) if prep is None else prep(bf16(m, kdim))
            ws = [quantize(torch.randn((n, kdim), generator=gen, device="cuda"))]
            while len(ws) * ws[0].nbytes() < 100e6 and len(ws) < 64:
                ws.append(quantize(torch.randn((n, kdim), generator=gen, device="cuda")))
            turn = itertools.count()
            record(kind, (m, n, kdim), lambda: fn(x, ws[0]))
            rows[-1]["cold_device_ms"] = _device_ms(lambda: fn(x, ws[next(turn) % len(ws)]))
            del ws
    print(json.dumps(rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="checkout of side A")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    metavar="FILE:NAME=VALUE", help="side A: this checkout, constant set")
    ap.add_argument("--kinds", help="comma-separated kernels to time (default: all)")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    kinds = set(args.kinds.split(",")) if args.kinds else None
    if args.child:
        child(args.child, args.sets, kinds)
        return 0
    if (args.base is None) == (not args.sets):
        ap.error("give --base DIR or --set FILE:NAME=VALUE")
    side_a = [sys.executable, __file__, "--child", str((args.base or ROOT).resolve())]
    side_a += [arg for s in args.sets for arg in ("--set", s)]
    side_b = [sys.executable, __file__, "--child", str(ROOT)]
    if args.kinds:
        side_a += ["--kinds", args.kinds]
        side_b += ["--kinds", args.kinds]
    runs = []
    for label, cmd in (("A", side_a), ("B", side_b), ("B", side_b), ("A", side_a)):
        run = subprocess.run(cmd, capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"kernel_ab: side {label} failed ({run.returncode}):\n"
                             f"{run.stderr[-4000:]}")
        out = run.stdout
        runs.append((label, json.loads(out.strip().splitlines()[-1])))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"A = {args.base or 'this checkout with ' + ', '.join(args.sets)}; "
          f"B = this checkout; {smi}")
    print("kernel case: device ms A1 B1 B2 A2 | event ms A1 B1 B2 A2"
          " [| cold device ms A1 B1 B2 A2]")
    for i, row in enumerate(runs[0][1]):
        cols = [" ".join(f"{r[i][key]:.4f}" for _, r in runs)
                for key in ("device_ms", "ms", "cold_device_ms") if key in row]
        print(f"{row['kind']} {tuple(row['case'])}: " + " | ".join(cols))
    return 0


if __name__ == "__main__":
    sys.exit(main())
