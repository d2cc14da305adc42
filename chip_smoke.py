"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py              # one card, every phase

Phases, all run every time (any failure exits non-zero; nothing is
caught and passed over):

1. card    — ``nvidia-smi`` name and power limit; fails without CUDA.
2. build   — ``nvcc`` builds every kernel under ``src/repro_torch/csrc``
             (one process per source, all at once) and prints the seconds
             and the ptxas register/shared-memory report.
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes and at edge shapes (Sq < 8, ragged
             tiles, a tail-padded Q8_0 weight through ``ops``), with the
             tolerance stated beside it;
             per shape the kernel's, the plain version's and a yardstick
             PyTorch call's time (CUDA events) and the roofline bound.
4. tiny    — TINY_SD with the same seeded weights and noise on the CPU
             (plain versions) and on the card (kernels); images must agree.
5. full    — SD-Turbo at 512x512 (CLIP 768x12, SD v1.5 UNet, VAE) with
             seeded synthetic weights, turbo sampler, through
             ``DiffusionEngine(device="cuda", max_batch=2)`` under the
             none, q8_0 and q3_k presets: 3 requests each, checked images
             and exact launch counts, per-phase times, peak memory, and a
             torch.profiler breakdown of one UNet step and one VAE pass.

Progress goes to stderr.  Standard output gets three lines at the end of
a run that passed: the card's name and power limit as ``nvidia-smi``
gives them, a JSON object ``{"kernels": [...]}`` (per kernel: launches
on the main path, worst error, and the headline shape's times and
bound), and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
SEED = 0

KERNEL_META = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:72"),
    "q8_matmul": ("src/repro_torch/csrc/q8_matmul.cu",
                  "src/repro/kernels/q8_matmul.py:56"),
    "q3k_matmul": ("src/repro_torch/csrc/q3k_matmul.cu",
                   "src/repro/kernels/q3k_matmul.py:74"),
}

# Main-path shapes.  The first shape of each kernel is its headline row
# in the final JSON line.
ATTN_SHAPES = [  # (B, H, Sq, Sk, D, causal, window)
    (2, 8, 4096, 4096, 40, False, None),   # UNet level-0 self-attention
    (2, 8, 4096, 77, 40, False, None),     # UNet level-0 cross-attention
    (2, 8, 1024, 1024, 80, False, None),   # UNet level-1 self-attention
    (2, 8, 256, 256, 160, False, None),    # UNet level-2 self-attention
    (2, 12, 77, 77, 64, True, None),       # CLIP causal self-attention
    (2, 8, 1024, 1000, 64, False, None),   # ragged last key tile
]
ATTN_EDGE = [
    (1, 2, 100, 300, 48, True, 50),        # Sq < Sk, causal + window
    (1, 2, 130, 70, 16, True, None),       # Sq > Sk: rows with no key -> 0
    (1, 12, 1, 77, 64, False, None),       # one query row (decode)
    (2, 4, 5, 5, 32, True, None),          # Sq < 8, causal
]
Q8_SHAPES = [(4096, 320, 320), (154, 768, 768), (4096, 2560, 320),
             (1, 768, 3072)]
Q8_EDGE = [(3, 70, 96), (3, 70, 100)]      # K = 100: tail-padded weight
Q3K_SHAPES = [(4096, 320, 1280), (256, 1280, 1280), (154, 768, 768),
              (64, 1280, 5120)]
Q3K_EDGE = [(5, 100, 512)]

# Launches per batch (one CLIP pass, one UNet eval, one VAE pass), worked
# out from the code: CLIP 12 layers x (1 attention, 6 linears); UNet 16
# spatial transformers x (2 attentions, 10 linears), of which 3/3/10/10
# at levels 0/1/2/mid have K % 256 == 0 for Q3_K; VAE 2 linears.
LAUNCHES_PER_BATCH = {
    "none": {"flash_attention": 44, "q8_matmul": 0, "q3k_matmul": 0},
    "q8_0": {"flash_attention": 44, "q8_matmul": 234, "q3k_matmul": 0},
    "q3_k": {"flash_attention": 44, "q8_matmul": 0, "q3k_matmul": 164},
}

# |err| <= ATTN_ABS + ATTN_REL*|ref|: both outputs are rounded to bf16, so
# they may sit one bf16 ulp apart (at most 2^-7 relative); ATTN_ABS covers
# the bf16 rounding of P for outputs near 0 (measured <= 1e-3 at Sk = 4096,
# where outputs have an RMS of about 0.03).
ATTN_ABS, ATTN_REL = 2e-3, 1e-2
MATMUL_RTOL = 2e-3     # same bf16 operands, f32 sums in another order
TINY_CORR, TINY_MAXABS = 0.999, 5e-2


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------- phases

def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"devices {torch.cuda.device_count()}")
    return smi.splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s total; per kernel "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")


def _attn_case(shape, gen, timed: bool) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, h, sq, sk, d, causal, window = shape
    q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(torch.bfloat16)

    def kern():
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    def plain():
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

    out, want = kern(), plain()
    torch.cuda.synchronize()
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    excess = (diff - ATTN_ABS - ATTN_REL * want.float().abs()).max().item()
    if not excess <= 0:
        raise AssertionError(f"flash_attention {shape}: max|err| {err}; some "
                             f"|err| exceeds {ATTN_ABS} + {ATTN_REL}*|ref| "
                             f"by {excess}")
    row = {"shape": shape, "max_abs_err": err}
    if timed:
        qpos = torch.arange(sq)[:, None] + (sk - sq)
        kpos = torch.arange(sk)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        pairs = int(mask.sum())
        flops = 4.0 * b * h * pairs * d
        nbytes = 2.0 * (2 * b * h * sq * d + 2 * b * h * sk * d)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=5),
                   library_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=causal)
                                      if window is None else
                                      sdpa(q, k, v, attn_mask=mask.cuda())))
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
    return row


def _matmul_case(kind: str, shape, gen, timed: bool) -> dict:
    from repro_torch.core import quant
    from repro_torch.kernels import ops
    from repro_torch.kernels import q3k_matmul as q3k
    from repro_torch.kernels import q8_matmul as q8
    from repro_torch.kernels import ref
    m, n, kdim = shape
    x = torch.randn((m, kdim), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((n, kdim), generator=gen, device="cuda") * kdim ** -0.5
    if kind == "q8_matmul":
        wt = quant.quantize_q8_0(w)

        def kern():
            if wt.logical is not None:     # ops pads x to the stored K
                return ops.quantized_matmul(x, wt, out_dtype=torch.float32)
            return q8.q8_matmul(x, wt.qs, wt.d)

        def plain():
            return ref.q8_matmul_ref(x, wt)

        def library():
            return torch.matmul(x, quant.dequantize_q8_0(wt, torch.bfloat16).t())
        wbytes = n * kdim + 2 * n * kdim // 32
    else:
        wt = quant.quantize_q3_k(w)

        def kern():
            return q3k.q3k_matmul(x, wt.ql, wt.qh, wt.scales, wt.d)

        def plain():
            return ref.q3k_matmul_ref(x, wt)

        def library():
            return torch.matmul(x, quant.dequantize_q3_k(wt, torch.bfloat16).t())
        wbytes = n * kdim // 4 + n * kdim // 8 + 14 * n * kdim // 256
    out, want = kern(), plain()
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    tol = MATMUL_RTOL * max(1.0, want.abs().max().item())
    if not err <= tol:
        raise AssertionError(f"{kind} {shape}: max|err| {err} > {tol}")
    row = {"shape": shape, "max_abs_err": err}
    if timed:
        row.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
                   library_ms=cuda_ms(library))
        row["bound_ms"], row["bound_by"] = bound(
            2.0 * m * n * kdim, 2 * m * kdim + wbytes + 4 * m * n)
    return row


def phase_kernels() -> dict[str, list[dict]]:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"flash_attention": [], "q8_matmul": [], "q3k_matmul": []}
    for shape in ATTN_SHAPES + ATTN_EDGE:
        rows["flash_attention"].append(
            _attn_case(shape, gen, timed=shape in ATTN_SHAPES))
    for kind, shapes, edges in (("q8_matmul", Q8_SHAPES, Q8_EDGE),
                                ("q3k_matmul", Q3K_SHAPES, Q3K_EDGE)):
        for shape in shapes + edges:
            rows[kind].append(_matmul_case(kind, shape, gen,
                                           timed=shape in shapes))
    for name, rs in rows.items():
        for r in rs:
            timing = ("" if "ms" not in r else
                      f" ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
                      f"library {r['library_ms']:.4f} bound {r['bound_ms']:.4f}"
                      f" ({r['bound_by']})")
            log(f"[kernels] {name} {r['shape']} max|err| "
                f"{r['max_abs_err']:.3e}{timing}")
    return rows


def _images(engine, reqs) -> dict:
    for r in reqs:
        engine.submit(r)
    engine.run()
    return {res.rid: res.image for res in engine.finished}


def phase_tiny() -> None:
    from repro_torch.configs import TINY_SD
    from repro_torch.core.tree import to_device
    from repro_torch.engine import DiffusionEngine, GenerateRequest, init_pipeline
    params = init_pipeline(SEED, TINY_SD, device="cpu")
    tl = TINY_SD.text_len
    vocab = TINY_SD.clip_cfg().vocab_size
    tokens = [[(7 * i + 3 * j) % vocab for j in range(tl)] for i in range(2)]
    for preset in ("none", "q8_0", "q3_k"):
        imgs = {}
        for dev in ("cpu", "cuda"):
            eng = DiffusionEngine(to_device(params, dev), TINY_SD, device=dev,
                                  max_batch=2, weight_quant=preset)
            reqs = [GenerateRequest(rid=i, tokens=tokens[i], seed=10 + i)
                    for i in range(2)]
            imgs[dev] = _images(eng, reqs)
        for rid in imgs["cpu"]:
            a = imgs["cpu"][rid].float().flatten()
            b = imgs["cuda"][rid].float().cpu().flatten()
            corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
            dmax = (a - b).abs().max().item()
            log(f"[tiny] {preset} rid {rid}: corr {corr:.6f} max|d| {dmax:.3e}")
            if not (corr > TINY_CORR and dmax <= TINY_MAXABS):
                raise AssertionError(f"tiny {preset} rid {rid}: CPU and CUDA "
                                     f"images disagree (corr {corr}, max {dmax})")


OURS = ("flash_attention_kernel", "q8_matmul_kernel", "q3k_matmul_kernel")


def _kind(name: str) -> str:
    low = name.lower()
    if any(k in name for k in OURS):
        return "ported kernels"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet", "sm90_")):
        return "cuBLAS GEMM"
    if "im2col" in low:
        return "im2col"
    return "other (elementwise, norms, copies)"


def _profile(label: str, fn) -> None:
    """One warm call of ``fn`` under torch.profiler: device time by kind
    and by kernel, against the call's wall time (CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    if not by_name:
        log(f"[profile] {label}: the profiler saw no device kernels "
            f"(device time not measured); wall {wall:.2f} ms")
        return
    busy = sum(ms for ms, _ in by_name.values())
    kinds: dict[str, list] = {}
    for name, (ms, n) in by_name.items():
        row = kinds.setdefault(_kind(name), [0.0, 0])
        row[0] += ms
        row[1] += n
    log(f"[profile] {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%), {sum(n for _, n in by_name.values())} kernels; "
        + "; ".join(f"{k} {ms:.2f} ms/{n}" for k, (ms, n) in
                    sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"[profile]   {ms:8.3f} ms {n:5d}x {name[:90]}")


def _phase_times(engine, gen, label: str) -> dict:
    from repro_torch.models import clip as clip_mod
    from repro_torch.models import unet as unet_mod
    from repro_torch.models import vae as vae_mod
    cfg = engine.cfg
    p = engine.params
    b, hw = engine.max_batch, cfg.latent_hw
    tokens = torch.randint(0, cfg.clip_cfg().vocab_size, (b, cfg.text_len),
                           generator=gen, device="cuda")
    ctx = clip_mod.clip_encode(p["clip"], cfg.clip_cfg(), tokens)
    x = torch.randn((b, hw, hw, 4), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.full((b,), 999, dtype=torch.int32, device="cuda")
    def clip():
        return clip_mod.clip_encode(p["clip"], cfg.clip_cfg(), tokens)

    def unet():
        return unet_mod.apply_unet(p["unet"], cfg.unet, x, t, ctx)

    def vae():
        return vae_mod.apply_vae_decoder(p["vae"], cfg.vae, x)

    with torch.no_grad():
        times = {"clip_ms": cuda_ms(clip, iters=5),
                 "unet_step_ms": cuda_ms(unet, iters=5),
                 "vae_ms": cuda_ms(vae, iters=3, warmup=1)}
        _profile(f"{label} unet_step", unet)
        _profile(f"{label} vae", vae)
    return times


def phase_full() -> dict[str, int]:
    from repro_torch.configs import SD_TURBO
    from repro_torch.core.qlinear import param_bytes
    from repro_torch.engine import (DiffusionEngine, GenerateRequest,
                                    init_pipeline)
    from repro_torch.engine import events as ev
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    base = init_pipeline(SEED, SD_TURBO, device="cuda")
    torch.cuda.synchronize()
    log(f"[full] init SD-Turbo weights {time.perf_counter() - t0:.1f} s, "
        f"{param_bytes(base) / 2**20:.0f} MiB")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    vocab = SD_TURBO.clip_cfg().vocab_size
    totals = {name: 0 for name in ops.KERNEL_MODULES}
    for preset in ("none", "q8_0", "q3_k"):
        eng = DiffusionEngine(base, SD_TURBO, device="cuda", max_batch=2,
                              weight_quant=preset)
        reqs = [GenerateRequest(
            rid=i, seed=100 + i,
            tokens=torch.randint(0, vocab, (SD_TURBO.text_len,), generator=gen,
                                 device="cuda").tolist()) for i in range(3)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        imgs = _images(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name, c in counts.items():
            totals[name] += c
        finished = [e for e in eng.bus.log if isinstance(e, ev.Finished)]
        if len(finished) != 3 or sorted(imgs) != [0, 1, 2]:
            raise AssertionError(f"{preset}: {len(finished)} Finished events")
        for rid, img in imgs.items():
            if tuple(img.shape) != (512, 512, 3):
                raise AssertionError(f"{preset} rid {rid}: shape {tuple(img.shape)}")
            f = img.float()
            if not (torch.isfinite(f).all() and f.abs().max() <= 1.0):
                raise AssertionError(f"{preset} rid {rid}: not finite in [-1, 1]")
        batches = 2                      # 3 requests at max_batch 2
        want = {k: batches * v for k, v in LAUNCHES_PER_BATCH[preset].items()}
        if counts != want:
            raise AssertionError(f"{preset}: launches {counts}, expected {want}")
        times = _phase_times(eng, gen, preset)
        log(f"[full] {preset}: 3 images in {wall:.2f} s wall; launches {counts}; "
            f"peak {peak:.2f} GiB; weights {param_bytes(eng.params) / 2**20:.0f} MiB; "
            + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
            + " (batch 2)")
        del eng, imgs
        torch.cuda.empty_cache()
    return totals


def main() -> int:
    if len(sys.argv) > 1:
        log(f"chip_smoke: takes no arguments, got {sys.argv[1:]}")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}")
        return 1
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    card = phase_card()
    phase_build()
    rows = phase_kernels()
    phase_tiny()
    launches = phase_full()
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        rs = rows[name]
        head = rs[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
