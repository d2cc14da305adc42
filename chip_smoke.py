"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py              # one card, every phase

Phases, all run every time (any failure exits non-zero; nothing is
caught and passed over):

1. card    — ``nvidia-smi`` name and power limit; fails without CUDA.
2. build   — ``nvcc`` builds every kernel under ``src/repro_torch/csrc``
             (one process per source, all at once) and prints the seconds
             and the ptxas report (registers and spills) of each kernel
             function, each template instantiation under its own name.
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (the quantized matmuls' decode and tile
             paths at Granite-8B's and SD-Turbo's linears) and at edge
             shapes (Sq < 8, ragged tiles, tail-padded Q8_0 and Q4_0
             weights through ``ops``, a K
             that ends inside the w8a8 kernel's K stage, the q8, q3k and q4
             decode paths with two token groups, kv_len = 1 and C, kv_len off the
             16-key range step, hd = 120 and 256, G = 1 and 16, logits
             recomputed), with the tolerance stated beside it (contiguous
             decode cases of at most FEW_KEYS keys add ATTN_P_ROUND * max|v|
             and are held one-sided to an f64 softmax), and every matmul and
             flash_decode shape called twice for the same bits;
             per shape the kernel's, the plain version's and a yardstick
             PyTorch call's time (CUDA events), the roofline bound, and for
             attention, flash_decode and the matmuls the kernel's and the
             yardstick's device time under torch.profiler.
             ``q8_matmul_w8a8`` has no model path (as in the reference): its
             launches are counted through ``ops.quantized_matmul_w8a8``, its
             only entry point, at its shapes (Granite-8B's decode linears at
             M = 4, 5, 8, 16, its 256-token chunk, the UNet's level-0
             linears); each of its shapes also gives the block-order sum of
             the reference's terms bit for bit (``w8a8_block_order``), and
             its timed rows log the f32 epilogue floor beside the bound.
             The paged prefill (bf16 and Q8_0 pools) and decode kernels at
             Granite-8B's widths: outputs within the attention limit, pools
             and Q8_0 bytes bit-identical to the plain version's, including
             NaN-poisoned recycled blocks and NULL_BLOCK-padded tables; each
             prefill and decode case called twice for the same bits, with
             the attend launch's plan (clusters that fit, key splits)
             logged, and at the timed prefill shapes a second yardstick:
             SDPA on K/V already gathered to contiguous bf16 (GQA,
             lower-right causal); device times beside the event times.
             The verify cases (5 rows at depth 1029 and 2011, both pools)
             first write a chunk 3 rows longer at the same position, whose
             stale tail the verify must mask.
4. tiny    — TINY_SD with the same seeded weights and noise on the CPU
             (plain versions) and on the card (kernels); images must agree,
             on the fused path and on the segmented preview path (euler,
             3 steps), whose images have the fused path's bits on each device.
             tiny_lm: reduced(granite-8b) served by ``ContinuousBatcher`` on
             the CPU and on the card (bf16 and Q8_0 KV, prefix sharing), and
             with speculation (draft = target, k = 4): identical tokens,
             exact launch counts.
             tiny_gen: ``greedy_generate`` of reduced(granite-8b) (bf16 KV,
             Q8_0 KV, q4_0 weights) and of reduced(h2o-danube-3-4b) past its
             ring buffer's wrap, on the CPU and on the card: identical
             tokens, exact flash_decode / q4_matmul / q8_matmul launches.
5. full    — SD-Turbo at 512x512 (CLIP 768x12, SD v1.5 UNet, VAE) with
             seeded synthetic weights, turbo sampler, through
             ``DiffusionEngine(device="cuda", max_batch=2)`` under the
             none, q8_0, q3_k and q4_0 presets: 3 requests each, checked images
             and exact launch counts, per-phase times, peak memory, and a
             torch.profiler breakdown of one UNet step and one VAE pass;
             the UNet's attention per eval (each UNet shape's kernel time
             times its launches per eval) beside the profiler's
             ``flash_attention_kernel`` total in that step.  Then the
             segmented preview path: euler 4 steps, batch 2, decoded
             previews every 2 steps, one request cancelled after step 1;
             the survivor's image has the fused run's bits, exact events
             and launches, each step's synchronised time, one denoise
             step's device time and a decoded preview's VAE time.
6. full_lm — Granite-8B at full width (36 layers, d 4096, GQA 32/8, hd
             128) with seeded synthetic weights made on the card, served by
             ``ContinuousBatcher(slots=4, block_size=16, prefill_chunk=256)``:
             6 requests of 1024-2000 prompt tokens (the last two repeat the
             first one's 512 leading tokens), 32 new tokens each, under
             (weights, KV, prefix share) = (none, bf16, on), (none, Q8_0,
             off), (q8_0, bf16, off), (q3_k, bf16, off).  Per run: event
             invariants, a consistent runtime with every block returned,
             exact launch counts, ms per 256-token prefill chunk and per
             4-slot decode quantum, tokens/s, peak memory; the first run's
             tokens against ``lm_forward`` on the card, and in every run a
             profile of one decode quantum and one prefill chunk.  Then two
             runs with speculation (k = 4, the same 6 requests): draft =
             target on a bf16 pool, and a draft of the target's first 4
             layers with both under q8_0 weights, the target on a Q8_0
             pool.  Per run: tokens against ``lm_forward`` above
             GEN_TIE_MARGIN, events, both runtimes consistent, exact
             target and draft launches, acceptance, a synchronised spec
             quantum, and a profile of one verify launch (5 rows at depth)
             and one draft step.
7. full_gen — the same Granite-8B through the reference's generation loop
             ``greedy_generate(max_len=2048)`` on a contiguous bf16 cache:
             4 prompts of 128 tokens, 32 new tokens (159 decode steps),
             under weights none and q4_0.  Per run: exact launch counts
             (``make_prefill``'s too); the tokens replayed through
             ``make_cache`` + ``make_decode`` one synchronised step at a
             time (ms per step) reproduce them; the same replay with
             ``flash_decode``'s plain version in place of the kernel, the
             kernel held to it at every call, gives every logit within
             0.25 and the same argmax where its margin exceeds 0.125; every
             replayed logit within 0.25 of ``lm_forward``'s, and each token
             whose ``lm_forward`` margin exceeds 0.125 (``make_prefill``'s
             first token likewise) equal to its argmax; tokens/s, peak
             memory and a profile of one decode step.
8. full_router — SD-Turbo (bf16, 512x512, turbo, batch 2) and Granite-8B
             (bf16 pool, 4 slots, block 16, chunk 256) at full width and depth
             behind one ``EngineRouter`` on one bus, one ``CostModel`` shared
             through ``EngineConfig`` and ``Telemetry`` attached.  The cost
             model is calibrated on a micro-run (two images in two batches,
             two 1024-token prompts with 8 new; each key's ms logged), then a
             mixed run: 4 images (two with a 2 s deadline), full_lm's 6 LM
             requests (60 s) and an image and an LM request with a 1 ms
             budget.  Gates: the two 1 ms requests end Rejected at submit and
             nothing else; every other rid one Admitted and one Finished; the
             images equal a bare DiffusionEngine run's bits and the tokens a
             bare ContinuousBatcher run's (and pass the lm_forward check above
             0.125); launches equal the two bare runs' sum; the phase
             histograms reconcile with the quanta and the trace has one root
             span per rid.  Logged: the router's wall against the bare runs',
             and the time blocked in the cost model's and telemetry's syncs.
9. full_fleet — a ``FleetManager`` of two replicas, each an ``EngineRouter``
             over the same SD-Turbo and Granite-8B weight tensors, serving two
             segmented images (euler 4, a latent preview every step) and two
             1024-token LM requests (32 new), uninterrupted and with replica0
             killed while it holds an image mid-denoise and an LM request
             mid-prefill.  Gates: one terminal per rid; the migrated ones
             Preempted and resumed; images the uninterrupted run's bits (one
             batch bucket); tokens pass the lm_forward check above 0.125;
             building replica1 costs its KV pool, not the weights, and the
             run's peak stays under two pools plus full_router's activations.

Progress goes to stderr.  Standard output gets three lines at the end of
a run that passed: the card's name and power limit as ``nvidia-smi``
gives them, a JSON object ``{"kernels": [...]}`` (per kernel: launches
on the main paths, phases full, full_lm, full_gen, full_router and
full_fleet, and for
``q8_matmul_w8a8`` through its entry point; worst error; the headline
shape's times and bound), and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12       # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
SEED = 0

KERNEL_META = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:72"),
    "q8_matmul": ("src/repro_torch/csrc/q8_matmul.cu",
                  "src/repro/kernels/q8_matmul.py:56"),
    "q3k_matmul": ("src/repro_torch/csrc/q3k_matmul.cu",
                   "src/repro/kernels/q3k_matmul.py:74"),
    "flash_prefill_paged": ("src/repro_torch/csrc/flash_prefill.cu",
                            "src/repro/kernels/flash_prefill.py:121"),
    "flash_prefill_paged_q8": ("src/repro_torch/csrc/flash_prefill.cu",
                               "src/repro/kernels/flash_prefill.py:332"),
    "flash_decode_paged": ("src/repro_torch/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_decode.py:142"),
    "q4_matmul": ("src/repro_torch/csrc/q4_matmul.cu",
                  "src/repro/kernels/q4_matmul.py:49"),
    "q8_matmul_w8a8": ("src/repro_torch/csrc/q8_matmul_w8a8.cu",
                       "src/repro/kernels/q8_matmul.py:111"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:62"),
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
    (2, 8, 1024, 77, 80, False, None),     # UNet level-1 cross-attention
    (2, 8, 256, 77, 160, False, None),     # UNet level-2 cross-attention
    (2, 8, 64, 64, 160, False, None),      # UNet mid self-attention
    (2, 8, 64, 77, 160, False, None),      # UNet mid cross-attention
]
# Launches of each UNet shape (head dims 40/80/160) per UNet eval: levels
# 0/1/2 have 5 spatial transformers each (2 down, 3 up), the mid block
# (Sq = 64) 1; each transformer runs one self- and one cross-attention.
UNET_ATTN_PER_EVAL = {shape: 1 if shape[2] == 64 else 5 for shape in ATTN_SHAPES
                      if shape[4] in (40, 80, 160)}
# Granite-8B through lm_forward (KV heads repeated to 32): full_gen's
# make_prefill on 128-token prompts, and its check over 159 tokens.
ATTN_LM_SHAPES = [(4, 32, 128, 128, 128, True, None),
                  (4, 32, 159, 159, 128, True, None)]
ATTN_EDGE = [
    (1, 2, 100, 300, 48, True, 50),        # Sq < Sk, causal + window
    (1, 2, 130, 70, 16, True, None),       # Sq > Sk: rows with no key -> 0
    (1, 12, 1, 77, 64, False, None),       # one query row (decode)
    (2, 4, 5, 5, 32, True, None),          # Sq < 8, causal
]
# Granite-8B's linears at 4 decode slots (K = 4096 and 14336) and in a
# 256-token prefill chunk follow the SD-Turbo shapes.
LM_MATMUL_SHAPES = [(4, 14336, 4096), (4, 4096, 14336), (256, 14336, 4096)]
# The quantized matmuls take their decode paths up to M_GEMV = 16 rows
# (csrc/q8_matmul.cu, q3k_matmul.cu, q4_matmul.cu): Granite-8B's other
# decode linears (q and o, k and v) and M = 8 and 16 put the choice on record.
LM_DECODE_SHAPES = [(4, 4096, 4096), (4, 1024, 4096), (8, 14336, 4096),
                    (16, 14336, 4096)]
# Granite-8B's other linears in a 256-token chunk (down; q and o; k and
# v) and a ragged last chunk, on the tile paths (csrc/common.cuh's CTA
# rule takes another tile for each).
LM_CHUNK_SHAPES = [(256, 4096, 14336), (256, 4096, 4096), (256, 1024, 4096),
                   (200, 4096, 4096)]
# full_gen's make_prefill linears (4 prompts of 128 tokens: gate and up,
# down, q and o, k and v), on q4_matmul's tile path under q4_0.
GEN_PREFILL_SHAPES = [(512, 14336, 4096), (512, 4096, 14336), (512, 4096, 4096),
                      (512, 1024, 4096)]
SPEC_K = 4                     # draft tokens proposed per slot and round
# A speculative verify runs the q8_0 target's linears and its Q8_0 head
# at M = SPEC_K + 1 rows (the decode path): gate and up, down, q and o,
# k and v, the head.
VERIFY_MATMUL = [(SPEC_K + 1, n, k) for n, k in
                 ((14336, 4096), (4096, 14336), (4096, 4096), (1024, 4096),
                  (49152, 4096))]
Q8_SHAPES = [(4096, 320, 320), (154, 768, 768), (4096, 2560, 320),
             (1, 768, 3072)] + LM_MATMUL_SHAPES + LM_DECODE_SHAPES + [
             (4, 49152, 4096)  # the LM head, Q8_0 under q8_0 and q3_k
             ] + LM_CHUNK_SHAPES + VERIFY_MATMUL
Q8_EDGE = [(3, 70, 96), (3, 70, 100),            # K = 100: tail-padded weight
           (9, 70, 96), (16, 70, 100),           # decode path, two token groups
           (17, 70, 96), (129, 100, 100),        # tile path: a half K step; tail-padded
           (255, 70, 1152)]                      # ragged M and N, 18 K steps
Q3K_SHAPES = [(4096, 320, 1280), (256, 1280, 1280), (154, 768, 768),
              (64, 1280, 5120)] + LM_MATMUL_SHAPES + LM_DECODE_SHAPES + LM_CHUNK_SHAPES
Q3K_EDGE = [(5, 100, 512), (3, 70, 256),         # one super-block, one warp
            (9, 70, 256), (16, 70, 512),         # decode path, two token groups
            (17, 70, 256), (129, 100, 512)]      # tile path: ragged M and N
Q4_SHAPES = (LM_MATMUL_SHAPES + Q8_SHAPES[:4] + LM_DECODE_SHAPES[2:]
             + GEN_PREFILL_SHAPES + LM_CHUNK_SHAPES)
Q4_EDGE = [(77, 320, 768), (1, 70, 96), (3, 70, 100),   # K = 100: tail-padded
           (16, 70, 96), (9, 70, 100),                  # decode path, two token groups
           (17, 70, 96), (129, 100, 100),               # tile path: a half K step; tail-padded
           (255, 70, 1152)]                             # ragged M and N, 18 K steps
# q8_matmul_w8a8 (decode path up to M_GEMV = 16 rows, csrc/q8_matmul_w8a8.cu):
# Granite-8B's linears, M = 8 and 16 at the path's top, the verify's M = 5,
# and the UNet's level-0 linears as q8_matmul has them (tile path).
W8A8_SHAPES = LM_MATMUL_SHAPES + [(8, 14336, 4096), (16, 14336, 4096),
                                  (SPEC_K + 1, 14336, 4096), (4096, 320, 320),
                                  (4096, 2560, 320)]
W8A8_EDGE = [(4, 1000, 4128), (5, 70, 96),   # K/32 = 129 and 3: a partial K stage
             (16, 70, 96), (17, 70, 96),     # the path cut
             (129, 100, 4128)]               # ragged tiles and a partial K stage
# Contiguous decode at Granite-8B's widths: (B, Hkv, G, hd, C, kv_len).
# The second is full_gen's own: a 2048-slot cache at position 159.
FLASH_DECODE_SHAPES = [(4, 8, 4, 128, 2048, 2000), (4, 8, 4, 128, 2048, 160)]
FLASH_DECODE_EDGE = [(4, 8, 4, 128, 2048, 1), (4, 8, 4, 128, 2048, 2048),
                     (4, 8, 4, 128, 2080, 2071),      # kv_len off the 16-key step
                     (4, 8, 4, 120, 2048, 1500),      # h2o-danube-3-4b's hd
                     (2, 2, 1, 256, 300, 7),          # G = 1, hd 256, kv_len < 8 CTAs
                     (1, 2, 16, 128, 9000, 8999)]     # G = 16: logits recomputed

# Paged attention at Granite-8B's widths (Hkv 8, G 4, hd 128, bs 16).
# Prefill: (T, pos0, MB, window, poison); the first two are the main path's
# 256-token chunks at the start and the end of a 2k-token prompt.
PREFILL_SHAPES = [(256, 0, 128, None, False), (256, 1792, 128, None, False)]
PREFILL_EDGE = [
    (1, 0, 128, None, True),       # one token, NaN in the stale tail + unlisted blocks
    (3, 15, 128, None, True),      # straddles a block boundary
    (64, 37, 128, None, True),     # pos0 % bs != 0
    (64, 200, 128, 100, False),    # sliding window
    (5, 20, 8, None, True),        # short table padded with NULL_BLOCK
    (208, 1792, 128, None, False), # a 2000-token prompt's ragged last chunk
    (256, 1000, 128, None, True),  # key splits off the 64-key step
    (256, 1792, 128, 700, False),  # a window across a key split
    (256, 3840, 256, None, True),  # a long history
    (8, 1792, 128, None, True),    # full_lm's 1800-token prompt's last chunk: 8-CTA clusters
    (16, 2000, 128, None, False),  # a short chunk at depth: 8-CTA clusters
]
# Verification chunks of speculative decoding (k + 1 = 5 rows at depth).
# An earlier chunk, VERIFY_STALE rows longer, is written at the same pos0
# first: its tail past pos0 + T stays in the pool, stale, and the attend
# launch must mask it by position.
VERIFY_EDGE = [(5, 1029, 128, None, True), (5, 2011, 128, None, False)]
VERIFY_STALE = 3
PREFILL_EDGE += VERIFY_EDGE
# Decode: (positions, MB, window, poison).  In the last edge case row 3 is
# an idle row (position 0, its table all NULL_BLOCK).
DECODE_SHAPES = [((2000, 1990, 2011, 1500), 132, None, False)]
DECODE_EDGE = [((5, 17, 130, 2100), 132, None, True),
               ((2000, 700, 40, 1), 132, 300, True),
               ((15, 16, 31, 0), 4, None, True)]
PAGED_HKV, PAGED_G, PAGED_HD, PAGED_BS = 8, 4, 128, 16

# Launches per batch (one CLIP pass, one UNet eval, one VAE pass), worked
# out from the code: CLIP 12 layers x (1 attention, 6 linears); UNet 16
# spatial transformers x (2 attentions, 10 linears), of which 3/3/10/10
# at levels 0/1/2/mid have K % 256 == 0 for Q3_K; VAE 2 linears.
LAUNCHES_PER_BATCH = {
    "none": {"flash_attention": 44, "q8_matmul": 0, "q3k_matmul": 0},
    "q8_0": {"flash_attention": 44, "q8_matmul": 234, "q3k_matmul": 0},
    "q3_k": {"flash_attention": 44, "q8_matmul": 0, "q3k_matmul": 164},
    # q4_0 stores as Q4_0 exactly the linears q8_0 stores as Q8_0 (both
    # need K % 32 == 0; embed stays q8_0 and is a gather, not a matmul).
    "q4_0": {"flash_attention": 44, "q4_matmul": 234},
}

# |err| <= ATTN_ABS + ATTN_REL*|ref|: both outputs are rounded to bf16, so
# they may sit one bf16 ulp apart (at most 2^-7 relative); ATTN_ABS covers
# the bf16 rounding of P for outputs near 0 (measured <= 1e-3 at Sk = 4096,
# where outputs have an RMS of about 0.03).
ATTN_ABS, ATTN_REL = 2e-3, 1e-2
# ATTN_LM_SHAPES add ATTN_P_ROUND * max|v| to that limit.  Their first
# causal rows see a handful of keys, so an output is close to one value
# row: the kernel rounds the unnormalised P (<= 1) to bf16 for P.V, as
# the Pallas kernel does, while the plain version keeps P in f32, which
# moves an output by up to 2^-9 * max|v| before its bf16 rounding (2 ulps
# at |out| in [1, 2); the same rounding emulated in f32 gives the same).
ATTN_P_ROUND = 2.0 ** -9
# Contiguous flash_decode cases with at most FEW_KEYS keys carry the same
# allowance, for the same reason: both versions round the normalised P to
# bf16, from f32 p that differ in the last bits, and with a handful of keys
# one p rounding the other way moves an output by up to 2^-9 * max|v|.
# Those cases are also held one-sided to an f64 softmax of the same bf16
# inputs: the kernel's largest distance from it may exceed the plain
# version's by at most ATTN_ABS.
FEW_KEYS = 64
MATMUL_RTOL = 2e-3     # same bf16 operands, f32 sums in another order
# The w8a8 epilogue: per (m, n, block) a multiply, a multiply and an add in
# f32 on the CUDA cores (the reference's rounding), at 128 lanes x 132 SMs
# x 1.98 GHz (67 TFLOP/s counting an FMA as two).
FP32_INSTR_PER_S = 128 * 132 * 1.98e9
W8A8_EPILOGUE_INSTR = 3
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


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of ``fn`` (the sum of its kernels) under
    torch.profiler, which leaves out the host time between launches that
    ``cuda_ms`` includes for small shapes; nan when the profiler saw no
    device kernels."""
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


def bound(flops: float, nbytes: float,
          peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
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
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
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
    atol = ATTN_ABS + (ATTN_P_ROUND * v.float().abs().max().item()
                       if shape in ATTN_LM_SHAPES else 0.0)
    excess = (diff - atol - ATTN_REL * want.float().abs()).max().item()
    if not excess <= 0:
        raise AssertionError(f"flash_attention {shape}: max|err| {err}; some "
                             f"|err| exceeds {atol} + {ATTN_REL}*|ref| "
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
        mask = mask.cuda()

        def library():
            if window is None:
                return sdpa(q, k, v, is_causal=causal)
            return sdpa(q, k, v, attn_mask=mask)
        row.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=5),
                   library_ms=cuda_ms(library), device_ms=device_ms(kern),
                   library_device_ms=device_ms(library))
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
    return row


def _matmul_case(kind: str, shape, gen, timed: bool) -> dict:
    from repro_torch.core import quant
    from repro_torch.kernels import ops
    from repro_torch.kernels import q3k_matmul as q3k
    from repro_torch.kernels import q4_matmul as q4
    from repro_torch.kernels import q8_matmul as q8
    from repro_torch.kernels import ref
    m, n, kdim = shape
    x = torch.randn((m, kdim), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((n, kdim), generator=gen, device="cuda") * kdim ** -0.5
    ops_flops, xbytes = PEAK_BF16_FLOPS, 2 * m * kdim
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
    elif kind == "q4_matmul":
        # Lopsided blocks (mostly positive, every 7th column a large
        # negative): a swapped nibble order or offset would not cancel out.
        w = w.abs()
        w[:, ::7] *= -3.0
        wt = quant.quantize_q4_0(w)

        def kern():
            if wt.logical is not None:     # ops pads x to the stored K
                return ops.quantized_matmul(x, wt, out_dtype=torch.float32)
            return q4.q4_matmul(x, wt.qs, wt.d)

        def plain():
            return ref.q4_matmul_ref(x, wt)

        def library():
            return torch.matmul(x, quant.dequantize_q4_0(wt, torch.bfloat16).t())
        wbytes = n * kdim // 2 + 2 * n * kdim // 32
    elif kind == "q8_matmul_w8a8":
        wt = quant.quantize_q8_0(w)
        xa = quant.quantize_q8_0(x)
        xs = xa.d.float()

        def kern():
            return q8.q8_matmul_w8a8(xa.qs, xs, wt.qs, wt.d)

        def plain():
            return ref.q8_matmul_w8a8_ref(xa.qs, xs, wt)

        def library():
            xd = quant.dequantize_q8_0(xa, torch.bfloat16)
            return torch.matmul(xd, quant.dequantize_q8_0(wt, torch.bfloat16).t())
        wbytes = n * kdim + 2 * n * kdim // 32
        ops_flops, xbytes = PEAK_INT8_OPS, m * kdim + 4 * m * kdim // 32
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
    if not (torch.isfinite(out).all() and err <= tol):
        raise AssertionError(f"{kind} {shape}: max|err| {err} > {tol}")
    if not torch.equal(kern(), out):
        raise AssertionError(f"{kind} {shape}: a second call gave other bits")
    if kind == "q8_matmul_w8a8":
        if not torch.equal(out, w8a8_block_order(xa.qs, xs, wt)):
            raise AssertionError(f"{kind} {shape}: not the block-order sum bit for bit")
        if not timed:
            # Both scale tensors one element into their storage (ws 2 bytes
            # off a 4-byte word): the kernel copies the words around them.
            def shifted(t):
                buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
                buf[1:] = t.flatten()
                return buf[1:].view(t.shape)
            if not torch.equal(q8.q8_matmul_w8a8(xa.qs, shifted(xs), wt.qs, shifted(wt.d)), out):
                raise AssertionError(f"{kind} {shape}: offset scale tensors gave other bits")
    row = {"shape": shape, "max_abs_err": err}
    if timed:
        # cuBLAS on the weight already dequantized to bf16 (what the
        # `none` preset runs), beside dequantize + matmul.
        wd = quant.dequantize(wt, torch.bfloat16)
        xd = quant.dequantize_q8_0(xa, torch.bfloat16) if kind == "q8_matmul_w8a8" else x

        def dense():
            return torch.matmul(xd, wd.t())
        row.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
                   library_ms=cuda_ms(library), device_ms=device_ms(kern),
                   library_device_ms=device_ms(library), cublas_ms=cuda_ms(dense),
                   cublas_device_ms=device_ms(dense))
        del wd, xd
        # bytes: x (bf16, or int8 + f32 scales for w8a8), the weight, y f32.
        row["bound_ms"], row["bound_by"] = bound(
            2.0 * m * n * kdim, xbytes + wbytes + 4 * m * n, ops_flops)
        if kind == "q8_matmul_w8a8":
            row["epilogue_floor_ms"] = (m * n * (kdim // 32) * W8A8_EPILOGUE_INSTR
                                        / FP32_INSTR_PER_S * 1e3)
    return row


def w8a8_block_order(xq: torch.Tensor, xs: torch.Tensor, w) -> torch.Tensor:
    """The reference's w8a8 terms, ``(dot * xs) * ws`` with each block dot
    exact, added in block order from 0 in f32: what
    ``csrc/q8_matmul_w8a8.cu`` computes, bit for bit (the plain version
    adds the same terms in torch's order)."""
    acc = torch.zeros((xq.shape[0], w.qs.shape[0]), dtype=torch.float32, device=xq.device)
    ws = w.d.float()
    for b in range(xq.shape[1] // 32):
        cols = slice(32 * b, 32 * b + 32)
        dot = xq[:, cols].float() @ w.qs[:, cols].float().t()   # exact: |dot| <= 2^19
        acc = acc + (dot * xs[:, b:b + 1]) * ws[:, b]
    return acc


def flash_decode_inputs(case, gen):
    """A contiguous decode case's q, k, v, kv_len and scale, drawn from gen."""
    b, hkv, g, hd, c, n = case
    q = torch.randn((b, hkv, g, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, hkv, c, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, hkv, c, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k[:, :, n:] = float("nan")             # never loaded: slots past kv_len
    v[:, :, n:] = float("nan")
    kv_len = torch.tensor([n], dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, hd ** -0.5     # the scale passed, as the model passes it


def flash_decode_f64(q, k, v, n: int, scale: float) -> torch.Tensor:
    """Attention of one contiguous decode case in f64 over the first ``n``
    keys of the same bf16 q, k, v: the yardstick of the few-key check."""
    lg = torch.einsum("bhgd,bhcd->bhgc", q.double(), k[:, :, :n].double()) * scale
    return torch.einsum("bhgc,bhcd->bhgd", torch.softmax(lg, -1), v[:, :, :n].double())


def flash_decode_p_round(case, v) -> float:
    """The ATTN_P_ROUND allowance of a contiguous decode case: 2^-9 *
    max|v| over its keys when it has at most FEW_KEYS of them, else 0."""
    n = case[-1]
    return ATTN_P_ROUND * v[:, :, :n].float().abs().max().item() if n <= FEW_KEYS else 0.0


def _flash_decode_case(case, gen, timed: bool) -> dict:
    from repro_torch.kernels import flash_decode as fd
    b, hkv, g, hd, c, n = case
    q, k, v, kv_len, scale = flash_decode_inputs(case, gen)

    def kern():
        return fd.flash_decode(q, k, v, kv_len, scale=scale)

    def plain():
        return fd.flash_decode_ref(q, k, v, kv_len, scale=scale)
    out, want = kern(), plain()
    torch.cuda.synchronize()
    p_round = flash_decode_p_round(case, v)
    row = {"shape": case,
           "max_abs_err": _check_attn("flash_decode", case, out, want, p_round)}
    if n <= FEW_KEYS:
        exact = flash_decode_f64(q, k, v, n, scale)
        kern_f64 = (out.double() - exact).abs().max().item()
        plain_f64 = (want.double() - exact).abs().max().item()
        log(f"[kernels] flash_decode {case}: {n} keys, limit + {p_round:.3e} "
            f"(ATTN_P_ROUND * max|v|); from an f64 softmax: kernel {kern_f64:.3e}, "
            f"plain {plain_f64:.3e}")
        if not kern_f64 <= plain_f64 + ATTN_ABS:
            raise AssertionError(f"flash_decode {case}: the kernel is {kern_f64} from an "
                                 f"f64 softmax, the plain version {plain_f64}: more "
                                 f"than {ATTN_ABS} further")
    if not torch.equal(kern(), out):
        raise AssertionError(f"flash_decode {case}: a second call gave other bits")
    if timed:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        kl, vl = k[:, :, :n], v[:, :, :n]

        def library():
            return sdpa(q, kl, vl, scale=scale)
        row.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=5),
                   library_ms=cuda_ms(library), device_ms=device_ms(kern),
                   library_device_ms=device_ms(library))
        nbytes = 2 * 2 * b * hkv * g * hd + 2 * 2 * b * hkv * n * hd
        row["bound_ms"], row["bound_by"] = bound(4.0 * b * hkv * g * hd * n, nbytes)
    return row


# phase_kernels: each kernel draws its inputs from a generator of its own,
# seeded SEED plus the kernel's offset here, so the cases of one kernel
# decide nothing of another's inputs.
KERNEL_SEED_OFFSET = {"flash_attention": 0, "q8_matmul": 11, "q3k_matmul": 12,
                      "q4_matmul": 13, "q8_matmul_w8a8": 14, "flash_decode": 15}


def phase_kernels() -> dict[str, list[dict]]:
    gens = {kind: torch.Generator(device="cuda").manual_seed(SEED + off)
            for kind, off in KERNEL_SEED_OFFSET.items()}
    rows = {kind: [] for kind in KERNEL_SEED_OFFSET}
    for shape in ATTN_SHAPES + ATTN_LM_SHAPES + ATTN_EDGE:
        rows["flash_attention"].append(
            _attn_case(shape, gens["flash_attention"], timed=shape not in ATTN_EDGE))
    for kind, shapes, edges in (("q8_matmul", Q8_SHAPES, Q8_EDGE),
                                ("q3k_matmul", Q3K_SHAPES, Q3K_EDGE),
                                ("q4_matmul", Q4_SHAPES, Q4_EDGE),
                                ("q8_matmul_w8a8", W8A8_SHAPES, W8A8_EDGE)):
        for shape in shapes + edges:
            rows[kind].append(_matmul_case(kind, shape, gens[kind], timed=shape in shapes))
    for case in FLASH_DECODE_SHAPES + FLASH_DECODE_EDGE:
        rows["flash_decode"].append(_flash_decode_case(
            case, gens["flash_decode"], timed=case in FLASH_DECODE_SHAPES))
    _log_rows(rows)
    return rows


def phase_w8a8_entry() -> int:
    """``q8_matmul_w8a8``'s only entry point, as in the reference:
    ``ops.quantized_matmul_w8a8`` (x quantized to Q8_0 on the card) at the
    LM shapes, against the plain version; returns the launches counted."""
    from repro_torch.core import quant
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = []
    for m, n, kdim in W8A8_SHAPES:
        x = torch.randn((m, kdim), generator=gen, device="cuda").to(torch.bfloat16)
        w = quant.quantize_q8_0(torch.randn((n, kdim), generator=gen, device="cuda")
                                * kdim ** -0.5)
        cases.append((x, w))
    ops.reset_launch_counts()
    outs = [ops.quantized_matmul_w8a8(x, w, out_dtype=torch.float32) for x, w in cases]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {name: 0 for name in ops.KERNEL_MODULES}
    want["q8_matmul_w8a8"] = len(cases)
    if launches != want:
        raise AssertionError(f"w8a8 entry: launches {launches}, expected {want}")
    for (x, w), y in zip(cases, outs):
        xa = quant.quantize_q8_0(x)
        plain = ref.q8_matmul_w8a8_ref(xa.qs, xa.d.float(), w)
        err = (y - plain).abs().max().item()
        if not err <= MATMUL_RTOL * max(1.0, plain.abs().max().item()):
            raise AssertionError(f"w8a8 entry {tuple(x.shape)}: max|err| {err}")
    log(f"[w8a8] ops.quantized_matmul_w8a8 at {W8A8_SHAPES}: "
        f"{launches['q8_matmul_w8a8']} launches")
    return launches["q8_matmul_w8a8"]


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Bit pattern of a pool, so that NaN bytes compare equal to themselves."""
    return x.view({1: torch.uint8, 2: torch.int16}[x.element_size()])


def _check_attn(name: str, case, out, want, p_round: float = 0.0) -> float:
    """``out`` within ATTN_ABS (plus ``p_round``) + ATTN_REL * |want|."""
    atol = ATTN_ABS + p_round
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    excess = (diff - atol - ATTN_REL * want.float().abs()).max().item()
    if not (torch.isfinite(out.float()).all() and excess <= 0):
        raise AssertionError(f"{name} {case}: max|err| {err}; some |err| "
                             f"exceeds {atol} + {ATTN_REL}*|ref| by {excess}")
    return err


def _paged_pools(gen, nb: int, q8: bool) -> list:
    shape = (nb, PAGED_HKV, PAGED_BS, PAGED_HD)
    kv = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(2)]
    if not q8:
        return kv
    from repro_torch.core import quant
    t8 = [quant.quantize_q8_0(x.float()) for x in kv]
    return [t8[0].qs, t8[1].qs, t8[0].d, t8[1].d]


def _poison(pools, blocks, tail) -> None:
    """NaN (127 in int8 quants) into whole ``blocks`` and into the stale
    tail ``(block, first offset)`` of a recycled block."""
    for p in pools:
        bad = float("nan") if p.is_floating_point() else 127
        if blocks:
            p[blocks] = bad
        if tail is not None:
            p[tail[0], :, tail[1]:] = bad


def prefill_split_rule(blocks: int, nt: int, fit) -> int:
    """``csrc/flash_prefill.cu``'s ``split_rule``: the CTAs per cluster (key
    splits of a row block), of 1, 2, 4, 8 the one whose waves of clusters,
    at ceil(nt / S) tiles per CTA, take the fewest tile steps; ties go to
    the smaller.  ``fit[i]``: clusters of 2^i CTAs that run at once."""
    best, best_cost = 1, None
    for i, f in enumerate(fit):
        if f < 1:
            continue
        cost = -(-blocks // f) * -(-nt // (1 << i))
        if best_cost is None or cost < best_cost:
            best, best_cost = 1 << i, cost
    return best


def prefill_plan(t: int, hkv: int, g: int, pos0: int, window, fit) -> tuple[int, int]:
    """(row blocks, CTAs per cluster) of the attend launch, as its host
    code works them out: 128 flattened query rows (t*G + g) per block, the
    heaviest block's 64-key tiles, then ``prefill_split_rule``."""
    nrows = t * g
    nrb = -(-nrows // 128)
    nt = 0
    for rb in range(nrb):
        kend = pos0 + (min((rb + 1) * 128, nrows) - 1) // g + 1
        kstart = max(0, pos0 + rb * 128 // g - window + 1) if window else 0
        nt = max(nt, -(-(kend - kstart) // 64))
    return nrb, prefill_split_rule(nrb * hkv, nt, fit)


def _prefill_plan(t: int, pos0: int, window, q8: bool) -> dict:
    """The attend launch's plan on this card at Granite-8B's widths: the
    clusters of 1, 2, 4 and 8 CTAs that run at once (the kernel's own
    query, ``flash_prefill_fit``), and the CTAs per cluster they give."""
    import ctypes

    from repro_torch.kernels import build
    lib, fn = build.entry("flash_prefill", "flash_prefill_fit",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fit = (ctypes.c_int * 4)()
    build.check(lib, "flash_prefill_fit", fn(PAGED_HD, int(q8), ctypes.addressof(fit)))
    split = prefill_plan(t, PAGED_HKV, PAGED_G, pos0, window, list(fit))[1]
    return {"fit": list(fit), "split": split}


def _prefill_case(q8: bool, case, gen, timed: bool) -> dict:
    from repro_torch.core import quant
    from repro_torch.kernels import flash_prefill as fp
    t, pos0, mb, window, poison = case
    hkv, g, hd, bs = PAGED_HKV, PAGED_G, PAGED_HD, PAGED_BS
    nb = mb + 40
    stale = VERIFY_STALE if case in VERIFY_EDGE else 0
    used = -(-(pos0 + t + stale) // bs)
    table = (torch.randperm(nb - 1, generator=gen, device="cuda")[:mb] + 1).to(torch.int32)
    table[used:] = 0                                   # NULL_BLOCK padding
    q = torch.randn((t, hkv, g, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kn = torch.randn((t, hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    vn = torch.randn((t, hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    pools = _paged_pools(gen, nb, q8)
    if poison:
        listed = set(table.tolist())
        unlisted = [b for b in range(1, nb) if b not in listed][:4]
        off = (pos0 + t) % bs
        last = int(table[(pos0 + t - 1) // bs])
        _poison(pools, unlisted, (last, off) if off else None)
    kern_fn = fp.flash_prefill_paged_q8 if q8 else fp.flash_prefill_paged
    plain_fn = fp.flash_prefill_paged_q8_ref if q8 else fp.flash_prefill_paged_ref
    kp = [p.clone() for p in pools]
    pp = [p.clone() for p in pools]
    name = "flash_prefill_paged" + ("_q8" if q8 else "")
    if stale:
        # The earlier, longer chunk: the verify below rewrites its first T
        # rows and leaves the last VERIFY_STALE in the pool.
        qs, ks, vs = (torch.randn((t + stale, hkv) + x.shape[2:], generator=gen,
                                  device="cuda").to(torch.bfloat16) for x in (q, kn, vn))
        kern_fn(qs, ks, vs, *kp, table, pos0, window=window)
        plain_fn(qs, ks, vs, *pp, table, pos0, window=window)
        torch.cuda.synchronize()
        if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(kp, pp)):
            raise AssertionError(f"{name} {case}: the stale chunk's pools differ "
                                 "from the plain version's")

    def kern():
        return kern_fn(q, kn, vn, *kp, table, pos0, window=window)

    def plain():
        return plain_fn(q, kn, vn, *pp, table, pos0, window=window)
    out, want = kern()[0], plain()[0]
    again = kern()[0]
    torch.cuda.synchronize()
    err = _check_attn(name, case, out, want)
    if not torch.equal(_bits(out), _bits(again)):
        raise AssertionError(f"{name} {case}: two calls gave different bits")
    for a, b in zip(kp, pp):               # every block, in and out of the table
        if not torch.equal(_bits(a), _bits(b)):
            raise AssertionError(f"{name} {case}: pools differ from the plain "
                                 "version's, bit for bit")
    row = {"shape": case, "max_abs_err": err, "plan": _prefill_plan(t, pos0, window, q8)}
    if timed:
        tbl = table.long()
        qpos = torch.arange(pos0, pos0 + t, device="cuda")[:, None]
        kpos = torch.arange(mb * bs, device="cuda")[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        mask_rows = mask.repeat_interleave(g, dim=0)          # (T*G, C)
        qh = q.permute(1, 0, 2, 3).reshape(hkv, t * g, hd)

        def gathered():
            if q8:
                keys = quant.dequantize_q8_0(quant.Q8_0Tensor(kp[0][tbl], kp[2][tbl]),
                                             torch.bfloat16)
                vals = quant.dequantize_q8_0(quant.Q8_0Tensor(kp[1][tbl], kp[3][tbl]),
                                             torch.bfloat16)
            else:
                keys, vals = kp[0][tbl], kp[1][tbl]
            return (keys.transpose(0, 1).reshape(hkv, mb * bs, hd),
                    vals.transpose(0, 1).reshape(hkv, mb * bs, hd))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, *gathered(), attn_mask=mask_rows)

        # The second yardstick: SDPA on the valid keys, gathered to
        # contiguous bf16 before the timed calls, with GQA and the diagonal
        # aligned to the last key (no window: the timed shapes have none).
        from torch.nn.attention.bias import causal_lower_right
        assert window is None
        sk = pos0 + t
        kc, vc = (x[:, :sk].unsqueeze(0).contiguous() for x in gathered())
        qc = q.permute(1, 2, 0, 3).reshape(1, hkv * g, t, hd)
        bias = causal_lower_right(t, sk)

        def contiguous():
            return torch.nn.functional.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=bias, enable_gqa=True)
        yard = contiguous().reshape(hkv, g, t, hd).permute(2, 0, 1, 3)
        row["sdpa_max_abs_diff"] = (yard.float() - want.float()).abs().max().item()
        pairs = int(mask.sum())
        row_bytes = hd * 2 if not q8 else hd + 2 * hd // 32
        nbytes = (2 * 2 * t * hkv * g * hd          # q in, out
                  + 2 * 2 * t * hkv * hd            # k_new, v_new
                  + 2 * t * hkv * row_bytes         # the chunk written to the pools
                  + 2 * pos0 * hkv * row_bytes)     # history read
        row.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=3),
                   library_ms=cuda_ms(library, iters=5), device_ms=device_ms(kern),
                   library_device_ms=device_ms(library), sdpa_ms=cuda_ms(contiguous),
                   sdpa_device_ms=device_ms(contiguous))
        row["bound_ms"], row["bound_by"] = bound(4.0 * hkv * g * hd * pairs, nbytes)
    return row


def _decode_case(case, gen, timed: bool) -> dict:
    from repro_torch.kernels import flash_decode as fd
    positions, mb, window, poison = case
    b = len(positions)
    hkv, g, hd, bs = PAGED_HKV, PAGED_G, PAGED_HD, PAGED_BS
    nb = b * mb + 8
    perm = torch.randperm(nb - 1, generator=gen, device="cuda")[:b * mb] + 1
    tables = perm.to(torch.int32).reshape(b, mb)
    for r, p in enumerate(positions):
        tables[r, -(-(p + 1) // bs):] = 0              # NULL_BLOCK past the row
    if positions[-1] == 0:
        tables[-1] = 0                                 # an idle row
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    q = torch.randn((b, hkv, g, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kpool, vpool = _paged_pools(gen, nb, False)
    if poison:
        listed = set(tables.flatten().tolist())
        unlisted = [x for x in range(1, nb) if x not in listed][:4]
        _poison((kpool, vpool), unlisted, None)
        for r, p in enumerate(positions):
            blk = int(tables[r, p // bs])
            if blk and (p + 1) % bs:
                _poison((kpool, vpool), [], (blk, (p + 1) % bs))
        _poison((kpool, vpool), [], (0, 1))            # the null block past 0

    def kern():
        return fd.flash_decode_paged(q, kpool, vpool, tables, pos, window=window)

    def plain():
        return fd.flash_decode_paged_ref(q, kpool, vpool, tables, pos, window=window)
    out, want = kern(), plain()
    torch.cuda.synchronize()
    row = {"shape": case, "max_abs_err": _check_attn("flash_decode_paged", case,
                                                     out, want)}
    if not torch.equal(_bits(kern()), _bits(out)):
        raise AssertionError(f"flash_decode_paged {case}: a second call gave other bits")
    if timed:
        tbl = tables.long()
        idx = torch.arange(mb * bs, device="cuda")[None, :]
        valid = idx <= pos.long()[:, None]
        if window is not None:
            valid &= idx > pos.long()[:, None] - window

        def library():
            keys = kpool[tbl].transpose(1, 2).reshape(b, hkv, mb * bs, hd)
            vals = vpool[tbl].transpose(1, 2).reshape(b, hkv, mb * bs, hd)
            return torch.nn.functional.scaled_dot_product_attention(
                q, keys, vals, attn_mask=valid[:, None, None, :])
        keys_read = int(valid.sum())
        nbytes = 2 * 2 * b * hkv * g * hd + 2 * 2 * keys_read * hkv * hd
        row.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=5),
                   library_ms=cuda_ms(library, iters=5), device_ms=device_ms(kern),
                   library_device_ms=device_ms(library))
        row["bound_ms"], row["bound_by"] = bound(4.0 * hkv * g * hd * keys_read,
                                                 nbytes)
    return row


def phase_paged_kernels() -> dict[str, list[dict]]:
    """The paged attention kernels against their plain versions at
    Granite-8B's main-path shapes and at edge shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = {"flash_prefill_paged": [], "flash_prefill_paged_q8": [],
            "flash_decode_paged": []}
    for q8 in (False, True):
        name = "flash_prefill_paged" + ("_q8" if q8 else "")
        for case in PREFILL_SHAPES + PREFILL_EDGE:
            rows[name].append(_prefill_case(q8, case, gen, timed=case in PREFILL_SHAPES
                                            or case == VERIFY_EDGE[1]))
    for case in DECODE_SHAPES + DECODE_EDGE:
        rows["flash_decode_paged"].append(
            _decode_case(case, gen, timed=case in DECODE_SHAPES))
    _log_rows(rows)
    return rows


def _log_rows(rows: dict) -> None:
    for name, rs in rows.items():
        for r in rs:
            timing = ("" if "ms" not in r else
                      f" ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
                      f"library {r['library_ms']:.4f} bound {r['bound_ms']:.4f}"
                      f" ({r['bound_by']})")
            if "device_ms" in r:
                timing += (f"; device ms {r['device_ms']:.4f} library "
                           f"{r['library_device_ms']:.4f}")
            if "epilogue_floor_ms" in r:
                timing += f"; epilogue floor {r['epilogue_floor_ms']:.4f}"
            if "cublas_ms" in r:
                timing += (f"; cuBLAS on bf16 ms {r['cublas_ms']:.4f} device "
                           f"{r['cublas_device_ms']:.4f}")
            if "plan" in r:
                timing += f"; clusters that fit {r['plan']['fit']}, split {r['plan']['split']}"
            if "sdpa_ms" in r:
                timing += (f"; contiguous SDPA ms {r['sdpa_ms']:.4f} device "
                           f"{r['sdpa_device_ms']:.4f} (max|diff| "
                           f"{r['sdpa_max_abs_diff']:.3e})")
            log(f"[kernels] {name} {r['shape']} max|err| "
                f"{r['max_abs_err']:.3e}{timing}")


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
    for preset in ("none", "q8_0", "q3_k", "q4_0"):
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
    _tiny_segmented(params, tokens)


def _tiny_segmented(params, tokens) -> None:
    """The segmented preview path (euler, 3 steps, previews every 2) on the
    CPU and on the card: images within TINY_CORR / TINY_MAXABS of each
    other, and on each device the same bits as the fused path's."""
    from repro_torch.configs import TINY_SD
    from repro_torch.core.tree import to_device
    from repro_torch.engine import DiffusionEngine, GenerateRequest
    seg = {}
    for dev in ("cpu", "cuda"):
        imgs = {}
        for every in (0, 2):
            eng = DiffusionEngine(to_device(params, dev), TINY_SD, device=dev,
                                  max_batch=2)
            reqs = [GenerateRequest(rid=i, tokens=tokens[i], seed=10 + i,
                                    sampler="euler", steps=3, preview_every=every)
                    for i in range(2)]
            imgs[every] = _images(eng, reqs)
        for rid in imgs[0]:
            if not torch.equal(imgs[0][rid], imgs[2][rid]):
                raise AssertionError(f"tiny segmented {dev} rid {rid}: not the "
                                     "fused path's bits")
        seg[dev] = imgs[2]
    for rid in seg["cpu"]:
        a = seg["cpu"][rid].float().flatten()
        b = seg["cuda"][rid].float().cpu().flatten()
        corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
        dmax = (a - b).abs().max().item()
        log(f"[tiny] segmented rid {rid}: corr {corr:.6f} max|d| {dmax:.3e}; "
            "the fused path's bits on both devices")
        if not (corr > TINY_CORR and dmax <= TINY_MAXABS):
            raise AssertionError(f"tiny segmented rid {rid}: CPU and CUDA images "
                                 f"disagree (corr {corr}, max {dmax})")


OURS = ("flash_attention_kernel", "tile_kernel", "q8_gemv_kernel",
        "q3k_gemv_kernel", "attend_kernel", "write_bf16_kernel",
        "write_q8_kernel", "decode_cluster_kernel", "q4_gemv_kernel",
        "w8a8_gemv_kernel")


def _kind(name: str) -> str:
    low = name.lower()
    if any(k in name for k in OURS):
        return "ported kernels"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet", "sm90_")):
        return "cuBLAS GEMM"
    if "im2col" in low:
        return "im2col"
    return "other (elementwise, norms, copies)"


def _profile(label: str, fn) -> dict[str, list]:
    """One warm call of ``fn`` under torch.profiler: device time by kind
    and by kernel, against the call's wall time (CUDA events).  Returns
    ``{kernel name: [ms, launches]}`` (empty when the profiler saw no
    device kernels)."""
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
        return by_name
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
        log(f"[profile]   {ms:8.3f} ms {n:5d}x {name[:150]}")
    return by_name


def _log_unet_attention(attn_rows: list[dict], unet_profile: dict) -> None:
    """The UNet's attention per eval from the kernels phase (each UNet
    shape's time times its launches per eval) beside the profiler's
    ``flash_attention_kernel`` total in one UNet eval."""
    timed = {r["shape"]: r for r in attn_rows if "ms" in r}
    n = sum(UNET_ATTN_PER_EVAL.values())
    est = {key: sum(w * timed[shape][key] for shape, w in UNET_ATTN_PER_EVAL.items())
           for key in ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms")}
    prof = [row for name, row in unet_profile.items() if "flash_attention_kernel" in name]
    seen = (f"{sum(ms for ms, _ in prof):.4f} ms over {sum(c for _, c in prof)} launches"
            if prof else "not measured (no device kernels in the profile)")
    log(f"[attention] UNet eval, {n} launches weighted by shape: kernel "
        f"{est['ms']:.4f} ms (device {est['device_ms']:.4f}), SDPA "
        f"{est['library_ms']:.4f} ms (device {est['library_device_ms']:.4f}), "
        f"bound {est['bound_ms']:.4f} ms; profiler flash_attention_kernel in "
        f"the none unet_step: {seen}")


def _phase_times(engine, gen, label: str) -> tuple[dict, dict]:
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
        unet_profile = _profile(f"{label} unet_step", unet)
        _profile(f"{label} vae", vae)
    return times, unet_profile


def phase_full(attn_rows: list[dict]) -> dict[str, int]:
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
    for preset in ("none", "q8_0", "q3_k", "q4_0"):
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
        want = {name: 0 for name in ops.KERNEL_MODULES}
        want.update({k: batches * v for k, v in LAUNCHES_PER_BATCH[preset].items()})
        if counts != want:
            raise AssertionError(f"{preset}: launches {counts}, expected {want}")
        times, unet_profile = _phase_times(eng, gen, preset)
        if preset == "none":
            _log_unet_attention(attn_rows, unet_profile)
        log(f"[full] {preset}: 3 images in {wall:.2f} s wall; launches {counts}; "
            f"peak {peak:.2f} GiB; weights {param_bytes(eng.params) / 2**20:.0f} MiB; "
            + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
            + " (batch 2)")
        del eng, imgs
        torch.cuda.empty_cache()
        if preset == "none":
            for name, c in _full_preview(base, vocab, gen, times).items():
                totals[name] += c
    return totals


PREVIEW_STEPS, PREVIEW_EVERY = 4, 2      # euler; one request cancelled after step 1


def _full_preview(base, vocab: int, gen, fused_times: dict) -> dict:
    """SD-Turbo 512x512 on the segmented path: euler, 4 steps, batch 2,
    decoded previews every 2 steps, rid 1 cancelled after its first step.
    The survivor's image has the bits of a fused run of the same two
    requests; the events and the launches are exactly as worked out; each
    step is timed (synchronised) and one denoise step profiled, beside the
    fused path's ``unet_step_ms``."""
    from repro_torch.configs import SD_TURBO
    from repro_torch.engine import DiffusionEngine, GenerateRequest
    from repro_torch.kernels import ops
    tokens = [torch.randint(0, vocab, (SD_TURBO.text_len,), generator=gen,
                            device="cuda").tolist() for _ in range(2)]

    def reqs(every):
        return [GenerateRequest(rid=i, tokens=tokens[i], seed=200 + i, sampler="euler",
                                steps=PREVIEW_STEPS, preview_every=every,
                                preview_decode=bool(every)) for i in range(2)]
    fused = DiffusionEngine(base, SD_TURBO, device="cuda", max_batch=2)
    want = _images(fused, reqs(0))
    eng = DiffusionEngine(base, SD_TURBO, device="cuda", max_batch=2)
    for r in reqs(PREVIEW_EVERY):
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    walls = []
    while eng.has_work():
        s0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - s0))
        if len(walls) == 1:
            if not eng.cancel(1):
                raise AssertionError("preview: rid 1 could not be cancelled")
            st = eng._inflight
            probe = (st["ctx"], st["ctx_u"], st["g"], st["x"],
                     {k: v[1] for k, v in st["plan"].items()}, st["step_fn"],
                     st["decode_fn"])
    counts = ops.launch_counts()
    expect = {name: 0 for name in ops.KERNEL_MODULES}
    # One CLIP pass (12 attention launches) and 4 UNet evals (32 each).
    expect["flash_attention"] = 12 + PREVIEW_STEPS * 32
    if counts != expect:
        raise AssertionError(f"preview: launches {counts}, expected {expect}")
    got = [(type(e).__name__, e.rid, getattr(e, "step", None), getattr(e, "decoded", None))
           for e in eng.bus.log]
    steps = range(1, PREVIEW_STEPS + 1)
    events = ([("Admitted", 0, None, None), ("Admitted", 1, None, None),
               ("Progress", 0, 1, None), ("Progress", 1, 1, None), ("Cancelled", 1, None, None)]
              + [e for i in steps[1:] for e in [("Progress", 0, i, None)]
                 + ([("PreviewLatent", 0, i, True)] if i % PREVIEW_EVERY == 0 else [])]
              + [("Finished", 0, None, None)])
    if got != events:
        raise AssertionError(f"preview: events {got}, expected {events}")
    for e in eng.bus.log:
        if type(e).__name__ == "PreviewLatent" and (
                tuple(e.latent.shape) != (512, 512, 3) or not torch.isfinite(e.latent.float()).all()):
            raise AssertionError(f"preview step {e.step}: a bad decoded preview")
    (res,) = eng.finished
    if not torch.equal(res.image, want[0]):
        raise AssertionError("preview: the survivor's image is not the fused run's bits")
    ctx, ctx_u, g, x, step, step_fn, decode_fn = probe
    with torch.no_grad():
        prof = _profile("preview denoise step", lambda: step_fn(eng.params, ctx, ctx_u, g, x, step))
        vae_ms = cuda_ms(lambda: decode_fn(eng.params, x), iters=3, warmup=1)
        vae_dev = device_ms(lambda: decode_fn(eng.params, x), iters=2)
    step_dev = sum(ms for ms, _ in prof.values()) if prof else float("nan")
    log(f"[full] preview: euler {PREVIEW_STEPS} steps, batch 2, decoded previews every "
        f"{PREVIEW_EVERY}, rid 1 cancelled after step 1; synchronised ms per step "
        + ", ".join(f"{w:.2f}" for w in walls)
        + f" (step 1: CLIP + UNet; 2: UNet + preview VAE; 3: UNet; 4: UNet + one VAE "
        f"pass for the last preview and the image); one denoise step {step_dev:.2f} ms of device time, the "
        f"fused path's unet_step_ms {fused_times['unet_step_ms']:.2f}; a decoded "
        f"preview's VAE {vae_ms:.2f} ms ({vae_dev:.2f} ms of device time); launches "
        f"{counts}; the survivor has the fused run's bits")
    del eng, fused, want, probe
    torch.cuda.empty_cache()
    return counts


LM_LAYERS = 36                 # Granite-8B
LM_PROMPTS = (2000, 1536, 1024, 1800, 1700, 1280)
LM_SHARED = 512                # requests 4 and 5 repeat request 0's first tokens
LM_MAX_NEW = 32
LM_RUNS = (  # (weights, quantized KV, prefix share)
    ("none", False, True), ("none", True, False), ("q8_0", False, False),
    ("q3_k", False, False))
TIE_MARGIN = 0.05              # top-2 logit gap below which lm_forward may differ
TINY_LM_SEED = 37              # a tie-stable prompt draw for phase tiny_lm


def _lm_requests(cls, prompts, vocab: int, max_new: int, shared: int, gen):
    """Random prompts; the last two repeat the first one's ``shared``
    leading tokens."""
    reqs = []
    for rid, n in enumerate(prompts):
        toks = torch.randint(1, vocab, (n,), generator=gen, device=gen.device).tolist()
        if rid >= len(prompts) - 2 and shared:
            toks[:shared] = reqs[0].prompt[:shared]
        reqs.append(cls(rid=rid, prompt=toks, max_new=max_new))
    return reqs


def _check_events(label: str, cb, n: int) -> None:
    """One Admitted, TokenDelta.pos strictly increasing from 0, one
    terminal Finished per request; the runtime consistent and every block
    back in the pool (or in the prefix cache)."""
    from repro_torch.engine import events as ev
    by_rid: dict[int, list] = {}
    for e in cb.bus.log:
        by_rid.setdefault(e.rid, []).append(e)
    finished = [e for e in cb.bus.log if isinstance(e, ev.Finished)]
    if len(finished) != n or sorted(by_rid) != list(range(n)):
        raise AssertionError(f"{label}: {len(finished)} Finished events for {n}")
    for rid, evs in by_rid.items():
        kinds = [type(e).__name__ for e in evs]
        pos = [e.pos for e in evs if isinstance(e, ev.TokenDelta)]
        if kinds.count("Admitted") != 1 or kinds[-1] != "Finished" \
                or sum(k in ("Finished", "Cancelled", "Rejected") for k in kinds) != 1 \
                or pos != list(range(len(pos))):
            raise AssertionError(f"{label} rid {rid}: events {kinds}")
    cb.runtime.check_consistency()
    left = cb.runtime.allocated_blocks - (len(cb.runtime.prefix)
                                          if cb.runtime.prefix else 0)
    if left:
        raise AssertionError(f"{label}: {left} blocks still allocated")


def _lm_want(cb, preset: str, layers: int, draft_steps: int = 0,
             draft_preset: str = "none") -> dict:
    """Launches worked out from the code: per fused prefill chunk, per
    fused verify and per decode quantum one paged-attention kernel per
    layer (a verify is a prefill chunk of k + 1 tokens); per forward 7
    linears per layer plus the head through the weight format's kernel.
    With speculation the draft (its own bf16 pool) adds one fused prefill
    per draft chunk and ``draft_steps`` batched decode steps."""
    from repro_torch.kernels import ops
    fwd = cb.prefill_launches + cb.decode_launches
    want = {name: 0 for name in ops.KERNEL_MODULES}
    want["flash_prefill_paged_q8" if cb.quantized_kv else
         "flash_prefill_paged"] = layers * (cb.prefill_launches + cb.spec_verifies)
    if not cb.quantized_kv:
        want["flash_decode_paged"] = layers * (cb.decode_launches - cb.spec_verifies)
    if preset == "q8_0":
        want["q8_matmul"] = (7 * layers + 1) * fwd
    elif preset == "q3_k":
        want["q3k_matmul"] = 7 * layers * fwd
        want["q8_matmul"] = fwd                          # the q8_0 head
    if cb.spec is not None:
        dl = cb.spec.draft_cfg.num_layers
        want["flash_prefill_paged"] += dl * (cb.draft_launches - draft_steps)
        want["flash_decode_paged"] += dl * draft_steps
        if draft_preset == "q8_0":
            want["q8_matmul"] += (7 * dl + 1) * cb.draft_launches
    return want


def _count_draft_steps(cb) -> list:
    """Wrap the batcher's draft decode step; the list gets one entry per
    batched draft step (launch accounting splits draft prefill chunks from
    draft steps)."""
    calls, inner = [], cb._draft_step

    def step(*args):
        calls.append(1)
        return inner(*args)
    cb._draft_step = step
    return calls


def phase_tiny_lm() -> None:
    """reduced(granite-8b) with the same seeded weights on the CPU (plain
    versions) and on the card (kernels): identical tokens, exact launches."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import to_device
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving import ContinuousBatcher, Request
    cfg = reduced(get_config("granite-8b"))
    params = init_lm(torch.Generator().manual_seed(SEED), cfg)
    for quantized in (False, True):
        outs = {}
        for dev in ("cpu", "cuda"):
            cb = ContinuousBatcher(to_device(params, dev), cfg, device=dev,
                                   slots=2, max_len=48, block_size=16,
                                   prefill_chunk=16, quantized_kv=quantized,
                                   prefix_share=True)
            # Prompts whose every generated token has a top-2 logit margin
            # of at least 0.14 on the CPU, so rounding cannot flip a token.
            reqs = _lm_requests(Request, (40, 23, 33, 37), cfg.vocab_size, 4,
                                16, torch.Generator().manual_seed(TINY_LM_SEED))
            ops.reset_launch_counts()
            for r in reqs:
                cb.submit(r)
            cb.run()
            counts = ops.launch_counts()
            _check_events(f"tiny_lm {dev}", cb, len(reqs))
            want = (_lm_want(cb, "none", cfg.num_layers) if dev == "cuda"
                    else {k: 0 for k in counts})
            if counts != want:
                raise AssertionError(f"tiny_lm {dev} quantized_kv={quantized}: "
                                     f"launches {counts}, expected {want}")
            outs[dev] = {r.rid: r.out for r in cb.finished}
            if not cb.runtime.prefix.hits:
                raise AssertionError("tiny_lm: no prefix hit")
        log(f"[tiny_lm] quantized_kv={quantized}: cpu {outs['cpu']} "
            f"cuda {outs['cuda']}")
        if outs["cpu"] != outs["cuda"]:
            raise AssertionError(f"tiny_lm quantized_kv={quantized}: tokens "
                                 "differ between the CPU and the card")
    _tiny_lm_spec(params, cfg)


def _tiny_lm_spec(params, cfg) -> None:
    """Speculation with draft = target (k = 4) on the CPU and on the card:
    the same tokens as each other and as the plain batcher, exact launches."""
    from repro_torch.core.tree import to_device
    from repro_torch.engine import EngineConfig, LMEngineConfig, SpecDecodeConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import ContinuousBatcher, Request
    outs = {}
    for dev in ("cpu", "cuda"):
        p = to_device(params, dev)
        for spec in (None, SpecDecodeConfig(draft_params=p, draft_cfg=cfg, k=SPEC_K)):
            cb = ContinuousBatcher(p, cfg, device=dev, config=EngineConfig(
                lm=LMEngineConfig(slots=2, max_len=48, block_size=16, prefill_chunk=16,
                                  spec_decode=spec)))
            reqs = _lm_requests(Request, (40, 23, 33, 37), cfg.vocab_size, 4, 16,
                                torch.Generator().manual_seed(TINY_LM_SEED))
            steps = _count_draft_steps(cb) if spec else []
            ops.reset_launch_counts()
            for r in reqs:
                cb.submit(r)
            cb.run()
            counts = ops.launch_counts()
            _check_events(f"tiny_lm spec {dev}", cb, len(reqs))
            want = (_lm_want(cb, "none", cfg.num_layers, len(steps)) if dev == "cuda"
                    else {k: 0 for k in counts})
            if counts != want:
                raise AssertionError(f"tiny_lm spec={spec is not None} {dev}: launches "
                                     f"{counts}, expected {want}")
            outs[dev, spec is not None] = {r.rid: r.out for r in cb.finished}
        if not cb.spec_rounds or cb.spec_accepted != cb.spec_proposed:
            raise AssertionError(f"tiny_lm spec {dev}: {cb.spec_rounds} rounds, "
                                 f"{cb.spec_accepted} of {cb.spec_proposed} accepted")
    log(f"[tiny_lm] spec (draft = target, k = {SPEC_K}): cpu {outs['cpu', True]} "
        f"cuda {outs['cuda', True]}")
    if len(set(map(str, outs.values()))) != 1:
        raise AssertionError(f"tiny_lm spec: tokens differ {outs}")


# Prompt draws of phase tiny_gen (prompt 24, 16 steps, batch 2) whose every
# generated token has a top-2 logit margin of at least 0.047 (three bf16
# ulps at |logit| in [2, 4)) on the CPU, so rounding cannot flip a token.
TINY_GEN_RUNS = (  # (arch, weights, quantized KV, prompt seed)
    ("granite-8b", "none", False, 175), ("granite-8b", "none", True, 175),
    ("granite-8b", "q4_0", False, 183), ("h2o-danube-3-4b", "none", False, 23))
TINY_GEN_PROMPT, TINY_GEN_STEPS = 24, 16


def _gen_want(layers: int, steps: int, preset: str, quantized: bool) -> dict:
    """Launches of ``steps`` contiguous decode steps, worked out from the
    code: one flash_decode per layer for a bf16 cache; under q4_0 the 7
    linears of each layer through q4_matmul and the q8_0 head through
    q8_matmul (the q8_0 embedding is a gather)."""
    from repro_torch.kernels import ops
    want = {name: 0 for name in ops.KERNEL_MODULES}
    if not quantized:
        want["flash_decode"] = layers * steps
    if preset == "q4_0":
        want["q4_matmul"] = 7 * layers * steps
        want["q8_matmul"] = steps
    return want


def _generate_q8_kv(params, cfg, prompt, steps: int, device) -> torch.Tensor:
    """``greedy_generate``'s loop on a Q8_0 cache: ``make_cache(quantized_kv
    =True)`` + ``make_decode``, the prompt fed one token at a time."""
    from repro_torch.train.serve_step import make_cache, make_decode
    prompt = prompt.to(device=device, dtype=torch.int32)
    b, s = prompt.shape
    cache = make_cache(params, cfg, b, s + steps, quantized_kv=True, device=device)
    decode = make_decode(cfg, device=device)
    tok, out = prompt[:, :1], [prompt[:, :1]]
    with torch.no_grad():
        for t in range(s + steps - 1):
            nxt, _, cache = decode(params, tok, t, cache)
            tok = prompt[:, t + 1:t + 2] if t + 1 < s else nxt
            out.append(tok)
    return torch.cat(out, dim=1)


def phase_tiny_gen() -> None:
    """``greedy_generate`` of reduced configs (its loop on a Q8_0 cache for
    the Q8_0-KV run) on the CPU (plain versions) and on the card
    (kernels): identical tokens, exact launch counts."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import quantize_params
    from repro_torch.core.tree import to_device
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.serve_step import greedy_generate
    for arch, preset, quantized, seed in TINY_GEN_RUNS:
        cfg = reduced(get_config(arch))
        params = init_lm(torch.Generator().manual_seed(SEED), cfg)
        if preset != "none":
            params = quantize_params(params, get_policy(preset))
        prompt = torch.randint(1, cfg.vocab_size, (2, TINY_GEN_PROMPT),
                               generator=torch.Generator().manual_seed(seed))
        outs = {}
        for dev in ("cpu", "cuda"):
            ops.reset_launch_counts()
            run = _generate_q8_kv if quantized else greedy_generate
            outs[dev] = run(to_device(params, dev), cfg, prompt, TINY_GEN_STEPS,
                            device=dev).cpu()
            counts = ops.launch_counts()
            want = (_gen_want(cfg.num_layers, TINY_GEN_PROMPT + TINY_GEN_STEPS - 1,
                              preset, quantized) if dev == "cuda"
                    else {k: 0 for k in counts})
            if counts != want:
                raise AssertionError(f"tiny_gen {arch} {preset} kv_q8={quantized} "
                                     f"{dev}: launches {counts}, expected {want}")
        label = (f"{arch} weights={preset} kv={'q8_0' if quantized else 'bf16'} "
                 f"window={cfg.sliding_window}")
        log(f"[tiny_gen] {label}: cpu {outs['cpu'][:, TINY_GEN_PROMPT:].tolist()} "
            f"cuda {outs['cuda'][:, TINY_GEN_PROMPT:].tolist()}")
        if not torch.equal(outs["cpu"], outs["cuda"]):
            raise AssertionError(f"tiny_gen {label}: tokens differ between the "
                                 "CPU and the card")


def _trace_step(cb) -> tuple[float, list]:
    """One ``cb.step()`` under torch.profiler (device activity only): its
    synchronised wall ms and its device events as (start us, end us,
    name), in start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        cb.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - s0)
    return wall, sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events() if e.device_type == DeviceType.CUDA)


def _device_gaps(wall: float, evs: list, reads: int) -> dict:
    """Device busy ms (the union of the events) and idle ms (wall less
    busy) of one traced quantum, and the device's idle ms right after
    each device-to-host copy: from the copy's end to the next event's
    start, the host's turn-around that a synchronising read forces."""
    busy, end = 0.0, float("-inf")
    for s, e, _ in evs:
        if e > end:
            busy += e - max(s, end)
            end = e
    copies = [j for j, (_, _, name) in enumerate(evs) if "DtoH" in name]
    after = [evs[j + 1][0] - evs[j][1] for j in copies if j + 1 < len(evs)]
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "idle_ms": wall - busy / 1e3,
            "host_reads": reads, "dtoh_copies": len(copies),
            "after_reads_ms": sum(max(g, 0.0) for g in after) / 1e3,
            "after_read_max_ms": max(after, default=float("nan")) / 1e3}


def _timed_run(cb, reqs, trace_spec: bool = False) -> dict:
    """Serve ``reqs``, timing each quantum (synchronised): full prefill
    chunks, and decode and speculative quanta at the full slot batch.
    With ``trace_spec`` the first full-batch speculative quantum after
    two timed ones runs under the profiler instead (``_device_gaps``,
    left out of the timings)."""
    t_pre, t_dec, t_spec, n_pre, sizes = [], [], [], 0, []
    trace = None
    raw = cb._prefill_raw

    def prefill(params, tokens, *args):
        sizes.append(tokens.shape[1])
        return raw(params, tokens, *args)
    cb._prefill_raw = prefill
    for r in reqs:
        cb.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while cb.has_work():
        # All slots busy and fed: the next quantum decodes (speculates).
        traced = (trace_spec and trace is None and len(t_spec) >= 2
                  and None not in cb.slots and not any(cb._pending)
                  and not any(cb._draft_pending))
        if traced:
            reads = cb.host_reads
            wall, evs = _trace_step(cb)
        else:
            s0 = time.perf_counter()
            cb.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - s0
        kind, batch = cb.last_quantum
        if kind == "prefill":
            chunk = sizes[-1]
            n_pre += chunk
            if chunk == cb.prefill_chunk and not traced:
                t_pre.append(dt)
        elif batch == len(cb.slots) and not traced:
            {"decode": t_dec, "decode-spec": t_spec}[kind].append(dt)
        elif traced and kind == "decode-spec":
            trace = _device_gaps(wall, evs, cb.host_reads - reads)
    wall = time.perf_counter() - t0
    cb._prefill_raw = raw
    gen_tokens = sum(len(r.out) for r in cb.finished)

    def mean_ms(ts):
        return 1e3 * sum(ts) / len(ts) if ts else float("nan")
    return {"wall_s": wall, "prefill_chunk_ms": mean_ms(t_pre),
            "decode_quantum_ms": mean_ms(t_dec), "spec_quantum_ms": mean_ms(t_spec),
            "spec_quanta_timed": len(t_spec), "spec_trace": trace,
            "prompt_tokens": n_pre, "generated_tokens": gen_tokens,
            "tokens_per_s": (n_pre + gen_tokens) / wall}


def _check_against_forward(finished, params, cfg, margin_limit: float = TIE_MARGIN,
                           label: str = "full_lm") -> None:
    """Every token generated for the ``finished`` requests whose top-2
    margin in ``lm_forward``'s logits (over prompt + generated tokens)
    exceeds ``margin_limit`` is its argmax."""
    from repro_torch.models.transformer import lm_forward
    checked = ties = 0
    with torch.no_grad():
        for r in finished:
            seq = torch.tensor([r.prompt + r.out[:-1]], device="cuda")
            logits = lm_forward(params, cfg, seq)[0][0, len(r.prompt) - 1:]
            top = logits.topk(2, dim=-1)
            margin = (top.values[:, 0] - top.values[:, 1]).tolist()
            best = top.indices[:, 0].tolist()
            for i, tok in enumerate(r.out):
                if margin[i] <= margin_limit:
                    ties += 1
                    continue
                checked += 1
                if best[i] != tok:
                    raise AssertionError(
                        f"{label} rid {r.rid} token {i}: served {tok}, lm_forward "
                        f"argmax {best[i]} with margin {margin[i]:.4f}")
            del logits
    log(f"[{label}] lm_forward agrees on {checked} generated tokens; "
        f"{ties} near-ties (margin <= {margin_limit}) not compared")


def _profile_lm(cb, label: str) -> None:
    """torch.profiler over one decode quantum at 4 slots (positions 32
    short of the table's end: 2000 at full size) and one 256-token prefill
    chunk ending at the table's last position, on scratch blocks."""
    slots, mb = len(cb.slots), cb.runtime.blocks_per_slot
    tables = (torch.arange(slots * mb, device="cuda", dtype=torch.int32)
              % (cb.runtime.num_blocks - 1) + 1).reshape(slots, mb)
    toks = torch.ones((slots, 1), dtype=torch.int64, device="cuda")
    bs = cb.runtime.block_size
    pos = torch.full((slots,), mb * bs - 32, dtype=torch.int32, device="cuda")
    chunk = torch.ones((1, cb.prefill_chunk), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        _profile(f"{label} decode quantum", lambda: cb.step_fn(
            cb.params, toks, pos, tables, cb.cache))
        _profile(f"{label} prefill chunk", lambda: cb._prefill_raw(
            cb.params, chunk, torch.full((1,), mb * bs - cb.prefill_chunk,
                                         dtype=torch.int32), 0,
            tables[:1], cb.cache))


def phase_full_lm(card: str) -> dict[str, int]:
    """Granite-8B at full width with seeded synthetic weights made on the
    card, served by ContinuousBatcher under four weight/KV settings."""
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import param_bytes
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving import ContinuousBatcher, Request
    cfg = get_config("granite-8b")
    assert cfg.num_layers == LM_LAYERS
    t0 = time.perf_counter()
    base = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    log(f"[full_lm] init Granite-8B weights {time.perf_counter() - t0:.1f} s, "
        f"{param_bytes(base) / 2**30:.2f} GiB")
    max_len = ContinuousBatcher.required_len(len(LM_PROMPTS), 4, max(LM_PROMPTS),
                                             LM_MAX_NEW)
    totals = {name: 0 for name in ops.KERNEL_MODULES}
    for preset, quantized, share in LM_RUNS:
        label = f"weights={preset} kv={'q8_0' if quantized else 'bf16'} share={share}"
        cb = ContinuousBatcher(base, cfg, slots=4, max_len=max_len, block_size=16,
                               prefill_chunk=256, quantized_kv=quantized,
                               weight_quant=None if preset == "none" else preset,
                               prefix_share=share)
        reqs = _lm_requests(Request, LM_PROMPTS, cfg.vocab_size, LM_MAX_NEW,
                            LM_SHARED, torch.Generator(device="cuda").manual_seed(SEED + 5))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        stats = _timed_run(cb, reqs)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        _check_events(f"full_lm {label}", cb, len(reqs))
        want = _lm_want(cb, preset, cfg.num_layers)
        if counts != want:
            raise AssertionError(f"full_lm {label}: launches {counts}, expected {want}")
        for name, c in counts.items():
            totals[name] += c
        hits = cb.runtime.prefix.hits if cb.runtime.prefix else 0
        if share and not hits:
            raise AssertionError(f"full_lm {label}: no prefix hit")
        log(f"[full_lm] {label}: {stats['generated_tokens']} tokens for "
            f"{len(reqs)} requests in {stats['wall_s']:.2f} s; prefill chunk "
            f"(T=256) {stats['prefill_chunk_ms']:.2f} ms, decode quantum (4 slots) "
            f"{stats['decode_quantum_ms']:.2f} ms, {stats['tokens_per_s']:.0f} tokens/s "
            f"(prompt + generated); quanta {cb.prefill_quanta} prefill / "
            f"{cb.decode_quanta} decode; prefix hits {hits}; peak {peak:.2f} GiB; "
            f"weights {param_bytes(cb.params) / 2**30:.2f} GiB; launches {counts}; {card}")
        if preset == "none" and not quantized:
            _check_against_forward(cb.finished, base, cfg)
        _profile_lm(cb, label)     # every run: bf16 and Q8_0 pools
        if preset == "none" and not quantized:
            plain_quantum_ms = stats["decode_quantum_ms"]
        del cb
        torch.cuda.empty_cache()
    for name, c in _full_lm_spec(base, cfg, max_len, plain_quantum_ms, card).items():
        totals[name] += c
    return totals


# Speculation on Granite-8B: (label, draft layers (None: draft = target),
# weights of target and draft, quantized target KV).
SPEC_RUNS = (("draft=target", None, "none", False),
             ("draft=4 layers", 4, "q8_0", True))


def _full_lm_spec(base, cfg, max_len: int, plain_quantum_ms: float, card: str) -> dict:
    """Granite-8B at full width with speculation (slots 4, k 4, the six
    requests of the plain runs): the draft = target on a bf16 pool, then a
    4-layer draft made of the target's first four layers, both under q8_0
    weights, the target on a Q8_0 pool.  Per run: tokens against
    ``lm_forward`` above GEN_TIE_MARGIN, events, both runtimes consistent
    and empty, exact target and draft launches, acceptance, and a verify
    launch's and a draft step's device time beside a synchronised spec
    quantum and the plain quantum; one traced spec quantum gives the
    device's busy and idle time and its idle right after the host reads."""
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import quantize_params
    from repro_torch.engine import EngineConfig, LMEngineConfig, SpecDecodeConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import ContinuousBatcher, Request
    totals = {name: 0 for name in ops.KERNEL_MODULES}
    for label, draft_layers, preset, quantized in SPEC_RUNS:
        target = base if preset == "none" else quantize_params(base, get_policy(preset))
        if draft_layers is None:
            dparams, dcfg = target, cfg
        else:
            dcfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft{draft_layers}",
                                       num_layers=draft_layers)
            dparams = dict(target, layers=target["layers"][:draft_layers])
        spec = SpecDecodeConfig(draft_params=dparams, draft_cfg=dcfg, k=SPEC_K)
        cb = ContinuousBatcher(target, cfg, device="cuda", config=EngineConfig(
            lm=LMEngineConfig(slots=4, max_len=max_len, block_size=16, prefill_chunk=256,
                              quantized_kv=quantized, spec_decode=spec)))
        reqs = _lm_requests(Request, LM_PROMPTS, cfg.vocab_size, LM_MAX_NEW,
                            LM_SHARED, torch.Generator(device="cuda").manual_seed(SEED + 5))
        steps = _count_draft_steps(cb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        stats = _timed_run(cb, reqs, trace_spec=True)
        counts = ops.launch_counts()
        n_steps = len(steps)          # before the profile below adds its calls
        peak = torch.cuda.max_memory_allocated() / 2**30
        _check_events(f"full_lm spec {label}", cb, len(reqs))
        cb.draft_runtime.check_consistency()
        if cb.draft_runtime.allocated_blocks:
            raise AssertionError(f"full_lm spec {label}: draft blocks still allocated")
        want = _lm_want(cb, preset, cfg.num_layers, n_steps, preset)
        if counts != want:
            raise AssertionError(f"full_lm spec {label}: launches {counts}, expected {want}")
        if not cb.spec_rounds:
            raise AssertionError(f"full_lm spec {label}: no speculative round")
        for name, c in counts.items():
            totals[name] += c
        _check_against_forward(cb.finished, target, cfg, GEN_TIE_MARGIN)
        emitted = stats["generated_tokens"] - len(reqs)   # the first tokens come from prefill
        acc = cb.spec_accepted / max(cb.spec_proposed, 1)
        verify_ms, draft_ms = _profile_spec(cb, label)
        log(f"[full_lm] spec {label} (k = {SPEC_K}, weights={preset}, "
            f"kv={'q8_0' if quantized else 'bf16'}): {stats['generated_tokens']} tokens "
            f"in {stats['wall_s']:.2f} s; acceptance {cb.spec_accepted}/{cb.spec_proposed} "
            f"= {acc:.4f}; {cb.spec_tokens_per_round():.4f} tokens per verify; "
            f"{cb.spec_rounds} spec rounds, {cb.spec_verifies} verifies, "
            f"{cb.decode_quanta - cb.spec_rounds} plain quanta; target launches per "
            f"emitted token {cb.decode_launches / emitted:.4f} ({cb.decode_launches} / "
            f"{emitted}); draft launches {cb.draft_launches} ({n_steps} batched steps); "
            f"host reads {cb.host_reads}; synchronised spec quantum (4 slots) "
            f"{stats['spec_quantum_ms']:.2f} ms over {stats['spec_quanta_timed']} quanta, "
            f"beside the plain decode quantum {plain_quantum_ms:.2f} ms (weights none, "
            f"bf16 pool); one verify launch (T = {SPEC_K + 1} at depth) {verify_ms:.2f} ms "
            f"of device time, one draft step {draft_ms:.2f} ms; prefill chunk "
            f"{stats['prefill_chunk_ms']:.2f} ms; peak {peak:.2f} GiB; launches {counts}; {card}")
        tr = stats["spec_trace"]
        if tr is None:
            log(f"[full_lm] spec {label}: no full-batch spec quantum was traced "
                "(host-read cost not measured)")
        else:
            log(f"[full_lm] spec {label}: one traced spec quantum (4 slots): wall "
                f"{tr['wall_ms']:.2f} ms, device busy {tr['busy_ms']:.2f} ms, idle "
                f"{tr['idle_ms']:.2f} ms ({100 * tr['idle_ms'] / tr['wall_ms']:.1f}%); "
                f"{tr['host_reads']} host reads, {tr['dtoh_copies']} device-to-host "
                f"copies; device idle right after them {tr['after_reads_ms']:.3f} ms in "
                f"all (largest {tr['after_read_max_ms']:.3f} ms); the untraced spec "
                f"quantum's wall less this busy time {stats['spec_quantum_ms'] - tr['busy_ms']:.2f} "
                f"ms; {card}")
        del cb, target, dparams, spec
        torch.cuda.empty_cache()
    return totals


def _profile_spec(cb, label: str) -> tuple[float, float]:
    """torch.profiler over one verify launch of k + 1 tokens ending 32
    positions short of the table's end (depth about 2000 at full size)
    and one batched draft step at 4 slots, on scratch blocks; returns
    their device ms (nan when the profiler saw no device kernels)."""
    mb, bs = cb.runtime.blocks_per_slot, cb.runtime.block_size
    tables = (torch.arange(mb, device="cuda", dtype=torch.int32)
              % (cb.runtime.num_blocks - 1) + 1)[None]
    chunk = torch.ones((1, SPEC_K + 1), dtype=torch.int64, device="cuda")
    pos = torch.full((1,), mb * bs - 32, dtype=torch.int32)
    slots, dmb = len(cb.slots), cb.draft_runtime.blocks_per_slot
    dtables = (torch.arange(slots * dmb, device="cuda", dtype=torch.int32)
               % (cb.draft_runtime.num_blocks - 1) + 1).reshape(slots, dmb)
    dtoks = torch.ones((slots, 1), dtype=torch.int64, device="cuda")
    dpos = torch.full((slots,), dmb * bs - 32, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        verify = _profile(f"spec {label} verify launch", lambda: cb._verify_raw(
            cb.params, chunk, pos, 0, tables, cb.cache))
        draft = _profile(f"spec {label} draft step", lambda: cb._draft_step(
            cb.draft_params, dtoks, dpos, dtables, cb.draft_cache))
    return tuple(sum(ms for ms, _ in p.values()) if p else float("nan")
                 for p in (verify, draft))


# ------------------------------------------- generation on the contiguous cache

GEN_BATCH, GEN_PROMPT, GEN_STEPS, GEN_MAX_LEN = 4, 128, 32, 2048
GEN_PRESETS = ("none", "q4_0")
# |decode-path logit - lm_forward logit| limit over every position and the
# whole vocabulary: the two paths round attention at other points
# (flash_attention keeps P in f32, flash_decode rounds the normalised P to
# bf16 as the reference's decode step does), which moves bf16 logits of
# magnitude 4-6 by up to 0.12 (4 ulps), measured under none and q4_0.
GEN_LOGIT_TOL = 0.25
# Top-2 margin in lm_forward at or below which the decode path's argmax
# may differ from lm_forward's: 4 bf16 ulps at |logit| in [4, 8), twice
# the largest top-two difference between the two paths measured on this
# workload (0.0625 under none and q4_0); runs A and B flipped a token at
# a margin of 0.078.
GEN_TIE_MARGIN = 0.125


def _replay(params, cfg, out, steps: int):
    """Feed ``out``'s tokens through ``make_cache`` + ``make_decode`` one
    synchronised step at a time: (logits (B, steps, V), seconds per step,
    the cache)."""
    from repro_torch.train.serve_step import make_cache, make_decode
    cache = make_cache(params, cfg, GEN_BATCH, GEN_MAX_LEN)
    decode = make_decode(cfg)
    logits, times = [], []
    with torch.no_grad():
        for i in range(steps):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            _, lg, cache = decode(params, out[:, i:i + 1], i, cache)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            logits.append(lg[:, 0])
    return torch.stack(logits, dim=1), times, cache


class _PlainDecodeAttention:
    """Route ``ops.decode_attention`` on the card to ``flash_decode_ref``,
    and hold ``flash_decode`` on each call's inputs against it within the
    attention limit: every main-path position of every layer."""

    def __enter__(self):
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.kernels import ops
        self.kernel_path = ops.decode_attention
        self.calls, self.err, self.excess = 0, None, None

        def plain_and_check(q, k, v, kv_len, *, scale=None):
            want = fd.flash_decode_ref(q, k, v, kv_len, scale=scale)
            diff = (fd.flash_decode(q, k, v, kv_len, scale=scale).float()
                    - want.float()).abs()
            excess = (diff - ATTN_ABS - ATTN_REL * want.float().abs()).amax()
            self.err = diff.amax() if self.err is None else torch.maximum(
                self.err, diff.amax())
            self.excess = excess if self.excess is None else torch.maximum(
                self.excess, excess)
            self.calls += 1
            return want
        ops.decode_attention = plain_and_check
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.decode_attention = self.kernel_path


def _check_gen_against_plain(preset: str, dec, plain, oracle) -> None:
    """``flash_decode`` within the attention limit of its plain version at
    every call of the plain replay (``oracle``), and the kernel replay
    ``dec`` against the plain replay ``plain`` on the same tokens: every
    logit within GEN_LOGIT_TOL, and the same argmax at every position
    where the plain replay's top-2 margin exceeds GEN_TIE_MARGIN."""
    err, excess = oracle.err.item(), oracle.excess.item()
    if not excess <= 0:
        raise AssertionError(f"full_gen {preset}: flash_decode exceeds {ATTN_ABS} + "
                             f"{ATTN_REL}*|ref| by {excess} on the main path")
    diff = (dec - plain).abs()
    worst = diff.max().item()
    same = (diff == 0).float().mean().item()
    top = plain.topk(2, dim=-1)
    margin = (top.values[..., 0] - top.values[..., 1]).cpu()
    flips = (dec.argmax(-1) != plain.argmax(-1)).cpu()
    log(f"[full_gen] weights={preset}: flash_decode at {oracle.calls} calls of the "
        f"plain replay: max|err| {err:.3e} against its plain version; replays' "
        f"logits within {worst:.4f} ({100 * same:.3f}% bit-equal), "
        f"{int(flips.sum())} of {flips.numel()} argmax differ"
        + "".join(f"; row {r} position {i} (margin {float(margin[r, i]):.4f})"
                  for r, i in flips.nonzero().tolist()))
    if not worst <= GEN_LOGIT_TOL or (flips & (margin > GEN_TIE_MARGIN)).any():
        raise AssertionError(f"full_gen {preset}: the flash_decode replay's logits "
                             f"differ from the plain replay's by {worst} (limit "
                             f"{GEN_LOGIT_TOL}), or its argmax where the margin "
                             f"exceeds {GEN_TIE_MARGIN}")


def _check_gen_against_forward(params, cfg, out, dec, first) -> None:
    """``dec`` (B, S+steps-1, V): the decode path's logits at every
    position.  Every logit is within GEN_LOGIT_TOL of ``lm_forward``'s, and
    every generated token whose top-2 margin in ``lm_forward`` exceeds
    GEN_TIE_MARGIN is its argmax (``first``, ``make_prefill``'s argmax,
    likewise for the first generated token)."""
    from repro_torch.models.transformer import lm_forward
    with torch.no_grad():
        fwd = lm_forward(params, cfg, out[:, :-1])[0]
        diff = (dec - fwd).abs()
        worst = diff.max().item()
        top = fwd[:, GEN_PROMPT - 1:].topk(2, dim=-1)
        at_top = diff[:, GEN_PROMPT - 1:].gather(-1, top.indices).max().item()
        margin = (top.values[..., 0] - top.values[..., 1]).cpu()
        best = top.indices[..., 0].cpu()
    del fwd, diff
    if not worst <= GEN_LOGIT_TOL:
        raise AssertionError(f"full_gen: decode-path logits differ from lm_forward's "
                             f"by {worst} > {GEN_LOGIT_TOL}")
    gen = out[:, GEN_PROMPT:].cpu()
    near = margin <= GEN_TIE_MARGIN
    bad = (~near) & (best != gen)
    if bad.any():
        r, i = (int(t) for t in bad.nonzero()[0])
        raise AssertionError(f"full_gen row {r} token {i}: generated {int(gen[r, i])}, "
                             f"lm_forward argmax {int(best[r, i])} margin "
                             f"{float(margin[r, i]):.4f} > {GEN_TIE_MARGIN}")
    wrong_first = (margin[:, 0] > GEN_TIE_MARGIN) & (first != gen[:, 0])
    if wrong_first.any():
        raise AssertionError(f"full_gen: make_prefill's first tokens {first.tolist()} "
                             f"differ from the generated {gen[:, 0].tolist()}")
    log(f"[full_gen] logits within {worst:.4f} of lm_forward's ({at_top:.4f} at its "
        f"top two); {int((~near).sum())} generated tokens equal its argmax, "
        f"{int(near.sum())} near-ties (margin <= {GEN_TIE_MARGIN}) not compared")


def _prefill_want(layers: int, preset: str) -> dict:
    """Launches of one ``make_prefill`` call (``lm_forward``, head on the
    last position): one flash_attention per layer; under q4_0 the 7
    linears of each layer through q4_matmul and the q8_0 head through
    q8_matmul."""
    from repro_torch.kernels import ops
    want = {name: 0 for name in ops.KERNEL_MODULES}
    want["flash_attention"] = layers
    if preset == "q4_0":
        want["q4_matmul"] = 7 * layers
        want["q8_matmul"] = 1
    return want


def phase_full_gen(card: str) -> dict[str, int]:
    """Granite-8B at full width through ``greedy_generate`` on a contiguous
    2048-slot bf16 cache per layer, under weights none and q4_0; then the
    same tokens replayed through ``make_cache`` + ``make_decode`` one
    synchronised step at a time (timed, logits kept for the checks), once
    with ``flash_decode`` and once with its plain version, and
    ``make_prefill`` on the same prompts."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import param_bytes, quantize_params
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.serve_step import greedy_generate, make_decode, make_prefill
    cfg = get_config("granite-8b")
    assert cfg.num_layers == LM_LAYERS
    gc.collect()                 # the earlier phases' batchers hold cycles
    torch.cuda.empty_cache()
    base = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    prompts = torch.randint(1, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 9),
                            device="cuda")
    steps = GEN_PROMPT + GEN_STEPS - 1
    totals = {name: 0 for name in ops.KERNEL_MODULES}
    for preset in GEN_PRESETS:
        params = base if preset == "none" else quantize_params(base, get_policy(preset))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = greedy_generate(params, cfg, prompts, GEN_STEPS, max_len=GEN_MAX_LEN,
                              device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = _gen_want(cfg.num_layers, steps, preset, False)
        if counts != want:
            raise AssertionError(f"full_gen {preset}: launches {counts}, expected {want}")
        if out.shape != (GEN_BATCH, GEN_PROMPT + GEN_STEPS) \
                or not torch.equal(out[:, :GEN_PROMPT], prompts.to(out.dtype)) \
                or not ((out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"full_gen {preset}: output {tuple(out.shape)} is "
                                 "not the prompts followed by vocabulary tokens")
        ops.reset_launch_counts()
        with torch.no_grad():
            first = make_prefill(cfg)(params, {"tokens": prompts}).argmax(-1).cpu()
        pre = ops.launch_counts()
        if pre != _prefill_want(cfg.num_layers, preset):
            raise AssertionError(f"full_gen {preset}: make_prefill launches {pre}, "
                                 f"expected {_prefill_want(cfg.num_layers, preset)}")
        for name in totals:
            totals[name] += counts[name] + pre[name]
        dec, times, cache = _replay(params, cfg, out, steps)
        if not torch.equal(dec[:, GEN_PROMPT - 1:].argmax(-1).to(out.dtype),
                           out[:, GEN_PROMPT:]):
            raise AssertionError(f"full_gen {preset}: the make_decode replay does "
                                 "not reproduce greedy_generate's tokens")
        with _PlainDecodeAttention() as oracle:
            plain = _replay(params, cfg, out, steps)[0]
        if oracle.calls != cfg.num_layers * steps:
            raise AssertionError(f"full_gen {preset}: {oracle.calls} plain decode "
                                 f"reads, expected {cfg.num_layers * steps}")
        _check_gen_against_plain(preset, dec, plain, oracle)
        del plain
        _check_gen_against_forward(params, cfg, out, dec, first)
        step_ms = 1e3 * sum(times[2:]) / (steps - 2)
        log(f"[full_gen] weights={preset} kv=bf16: {steps} decode steps of "
            f"{GEN_BATCH} rows in {wall:.2f} s ({1e3 * wall / steps:.2f} ms per step "
            f"unsynchronised); {step_ms:.2f} ms per synchronised decode step; "
            f"{GEN_BATCH * (steps + 1) / wall:.0f} tokens/s (prompt + generated); "
            f"peak {peak:.2f} GiB; weights {param_bytes(params) / 2**30:.2f} GiB; "
            f"launches {counts}; make_prefill {pre}; {card}")
        decode = make_decode(cfg)
        with torch.no_grad():
            tok = out[:, -1:]
            _profile(f"weights={preset} decode step",
                     lambda: decode(params, tok, steps, cache))
        del params, cache, out, dec
        torch.cuda.empty_cache()
    return totals


# ------------------------------------------------- the serving surface
# phase full_router: images (rids 0-3; 0 and 1 with a SERVE_IMAGE_DEADLINE_MS
# budget), full_lm's six LM requests (rids 4-9, SERVE_LM_DEADLINE_MS), then
# one image (10) and one LM request (11) that no engine can serve in 1 ms.
SERVE_IMAGES = 4
SERVE_IMAGE_DEADLINE_MS = 2000.0
SERVE_LM_DEADLINE_MS = 60000.0
SERVE_HOPELESS_MS = 1.0
CALIB_PROMPT, CALIB_NEW = 1024, 8
# phase full_fleet: two images on the segmented path (euler, FLEET_STEPS
# steps, a latent preview every step) and two LM requests of FLEET_PROMPT
# tokens; replica0 holds rids 0 and 2 and dies at its quantum FLEET_KILL_AT,
# with rid 0 two denoise steps in and rid 2 two prefill chunks in.
FLEET_STEPS, FLEET_PROMPT, FLEET_KILL_AT = 4, 1024, 4


def _pool_bytes(cb) -> int:
    return sum(t.numel() * t.element_size() for c in cb.cache for t in c
               if t is not None)


class _SyncTimer:
    """Count and time the engines' observation syncs (``sync_device``, which
    they call only with a cost model or metrics attached) over one run."""
    MODULES = ("repro_torch.engine.diffusion_engine", "repro_torch.serving.scheduler")

    def __enter__(self):
        import importlib
        self.mods = [importlib.import_module(m) for m in self.MODULES]
        self.inner = [m.sync_device for m in self.mods]
        self.calls, self.seconds = 0, 0.0

        def timed(device, _inner=self.inner[0]):
            s0 = time.perf_counter()
            _inner(device)
            self.seconds += time.perf_counter() - s0
            self.calls += 1
        for m in self.mods:
            m.sync_device = timed
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self.mods, self.inner):
            m.sync_device = fn


def _serving_bases():
    """SD-Turbo and Granite-8B bf16 weights on the card, seeded as phases
    full and full_lm seed them: one tree each, which every engine of the
    two serving phases shares."""
    from repro_torch.configs import SD_TURBO, get_config
    from repro_torch.engine import init_pipeline
    from repro_torch.models.transformer import init_lm
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("granite-8b")
    assert cfg.num_layers == LM_LAYERS
    sd = init_pipeline(SEED, SD_TURBO, device="cuda")
    lm = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    return sd, lm, cfg


def _serve_max_len() -> int:
    from repro_torch.serving import ContinuousBatcher
    return ContinuousBatcher.required_len(len(LM_PROMPTS), 4, max(LM_PROMPTS), LM_MAX_NEW)


def _router_requests(vocab_sd: int, vocab_lm: int):
    """New request objects for one run (a request carries its serving
    state), with the same tokens at every call: (images, LM requests, the
    two hopeless ones)."""
    from repro_torch.configs import SD_TURBO
    from repro_torch.engine import GenerateRequest
    from repro_torch.serving import Request
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    toks = [torch.randint(0, vocab_sd, (SD_TURBO.text_len,), generator=gen,
                          device="cuda").tolist() for _ in range(SERVE_IMAGES + 1)]
    lm = _lm_requests(Request, LM_PROMPTS, vocab_lm, LM_MAX_NEW, LM_SHARED,
                      torch.Generator(device="cuda").manual_seed(SEED + 5))
    images = [GenerateRequest(rid=i, tokens=toks[i], seed=300 + i,
                              deadline_ms=SERVE_IMAGE_DEADLINE_MS if i < 2 else None)
              for i in range(SERVE_IMAGES)]
    texts = [Request(rid=SERVE_IMAGES + r.rid, prompt=r.prompt, max_new=r.max_new,
                     deadline_ms=SERVE_LM_DEADLINE_MS) for r in lm]
    n = SERVE_IMAGES + len(lm)
    hopeless = [GenerateRequest(rid=n, tokens=toks[-1], seed=300 + n,
                                deadline_ms=SERVE_HOPELESS_MS),
                Request(rid=n + 1, prompt=list(lm[0].prompt), max_new=LM_MAX_NEW,
                        deadline_ms=SERVE_HOPELESS_MS)]
    return images, texts, hopeless


def _timed_drain(engine) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_full_router(card: str, sd, lm, cfg) -> tuple[dict, int]:
    """SD-Turbo (bf16, 512x512, turbo, batch 2) and Granite-8B (bf16 pool,
    4 slots, block 16, chunk 256) behind one ``EngineRouter`` on one bus,
    one ``CostModel`` shared through ``EngineConfig`` and ``Telemetry``
    attached.  The cost model is calibrated on a micro-run, then the mixed
    run is held to bare runs of the same requests: images bit for bit,
    tokens equal, launches the sum of the bare runs'.  Returns the launches
    and the activation high-water of the mixed run (bytes above its start)."""
    from repro_torch.configs import SD_TURBO
    from repro_torch.engine import (CostModel, DiffusionEngine, DiffusionEngineConfig,
                                    EngineConfig, EngineRouter, GenerateRequest,
                                    LMEngineConfig, calibrate)
    from repro_torch.kernels import ops
    from repro_torch.obs import Telemetry, TraceRecorder
    from repro_torch.serving import ContinuousBatcher, Request
    max_len = _serve_max_len()
    lm_kw = dict(slots=4, max_len=max_len, block_size=16, prefill_chunk=256)
    vocab_sd = SD_TURBO.clip_cfg().vocab_size
    totals = {name: 0 for name in ops.KERNEL_MODULES}

    def add(counts):
        for name, c in counts.items():
            totals[name] += c

    cm = CostModel()
    tele = Telemetry(tracer=TraceRecorder())
    conf = EngineConfig(cost_model=cm, metrics=tele,
                        lm=LMEngineConfig(**lm_kw),
                        diffusion=DiffusionEngineConfig(max_batch=2))
    deng = DiffusionEngine(sd, SD_TURBO, config=conf, device="cuda")
    leng = ContinuousBatcher(lm, cfg, config=conf, device="cuda")
    router = EngineRouter(diffusion=deng, lm=leng, metrics=tele)
    tele.attach(router.bus)
    # Calibration: two images in two batches (each engine leaves the first
    # call of a program key unobserved), two 1024-token prompts, 8 new.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    calib_img = [GenerateRequest(rid=-1 - i, seed=500 + i, tokens=torch.randint(
        0, vocab_sd, (SD_TURBO.text_len,), generator=gen, device="cuda").tolist())
        for i in range(2)]
    calib_lm = [Request(rid=-3 - i, max_new=CALIB_NEW, prompt=torch.randint(
        1, cfg.vocab_size, (CALIB_PROMPT,), generator=gen, device="cuda").tolist())
        for i in range(2)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    calibrate(router, [calib_img[0]] + calib_lm)
    calibrate(router, calib_img[1:])
    torch.cuda.synchronize()
    add(ops.launch_counts())
    log(f"[full_router] calibration: 2 images (2 batches), 2 prompts of {CALIB_PROMPT} "
        f"tokens with {CALIB_NEW} new, {time.perf_counter() - t0:.2f} s; diffusion "
        f"first calls (traces) {deng.traces}; {card}")
    for key, (cost, n) in sorted(cm.snapshot().items(), key=lambda kv: repr(kv[0])):
        log(f"[full_router] cost model {key}: {1e3 * cost:.2f} ms ({n} observations)")
    # The bare runs (after the calibration, so that both they and the mixed
    # run find the process warm): the same requests, no cost model, no
    # metrics.
    bare_d = DiffusionEngine(sd, SD_TURBO, device="cuda", max_batch=2)
    for r in _router_requests(vocab_sd, cfg.vocab_size)[0]:
        bare_d.submit(r)
    ops.reset_launch_counts()
    wall_d = _timed_drain(bare_d)
    counts_d = ops.launch_counts()
    want_img = {res.rid: res.image for res in bare_d.finished}
    bare_l = ContinuousBatcher(lm, cfg, device="cuda", **lm_kw)
    for r in _router_requests(vocab_sd, cfg.vocab_size)[1]:
        bare_l.submit(r)
    ops.reset_launch_counts()
    wall_l = _timed_drain(bare_l)
    counts_l = ops.launch_counts()
    want_tok = {r.rid: list(r.out) for r in bare_l.finished}
    add(counts_d)
    add(counts_l)
    del bare_d, bare_l
    torch.cuda.empty_cache()

    images, texts, hopeless = _router_requests(vocab_sd, cfg.vocab_size)
    for key in (cm._diff_keys(deng, images[0])["fused"],) + cm.lm_keys(leng):
        if cm.cost(key) is None:
            raise AssertionError(f"full_router: calibration left {key} unpriced")

    # The mixed run.
    q0 = deng.quanta + leng.prefill_quanta + leng.decode_quanta
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _SyncTimer() as syncs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in images + texts:
            router.submit(r)
        for r in hopeless:
            router.submit(r)
            if router.bus.terminal(r.rid) is None:
                raise AssertionError(f"full_router: rid {r.rid} ({SERVE_HOPELESS_MS} ms) "
                                     "was not rejected at submit")
        router.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    act = torch.cuda.max_memory_allocated() - base_mem
    add(counts)
    quanta = deng.quanta + leng.prefill_quanta + leng.decode_quanta - q0

    by_rid: dict[int, list] = {}
    for e in router.bus.log:
        by_rid.setdefault(e.rid, []).append(type(e).__name__)
    for r in hopeless:
        if by_rid[r.rid] != ["Rejected"]:
            raise AssertionError(f"full_router rid {r.rid}: events {by_rid[r.rid]}")
    for r in images + texts + calib_img + calib_lm:
        kinds = by_rid.get(r.rid, [])
        if kinds.count("Admitted") != 1 or kinds[-1] != "Finished" or sum(
                k in ("Finished", "Cancelled", "Rejected") for k in kinds) != 1:
            raise AssertionError(f"full_router rid {r.rid}: events {kinds}")
    got_img = {res.rid: res.image for res in deng.finished if res.rid >= 0}
    if sorted(got_img) != sorted(want_img) or not all(
            torch.equal(got_img[rid], want_img[rid]) for rid in want_img):
        raise AssertionError("full_router: the router's images are not the bare run's bits")
    for rid, img in got_img.items():
        if tuple(img.shape) != (512, 512, 3) or not torch.isfinite(img.float()).all():
            raise AssertionError(f"full_router rid {rid}: a bad image")
    got = [r for r in leng.finished if r.rid >= 0]
    if {r.rid: list(r.out) for r in got} != want_tok:
        raise AssertionError("full_router: the router's tokens differ from the bare run's")
    want = {name: counts_d[name] + counts_l[name] for name in counts}
    if counts != want:
        raise AssertionError(f"full_router: launches {counts}, the bare runs' sum {want}")
    for name in ("flash_attention", "flash_prefill_paged", "flash_decode_paged"):
        if not counts[name]:
            raise AssertionError(f"full_router: {name} was never launched")
    ph = tele.registry.get("phase_seconds")
    seen = {(e, p): ph.count(engine=e, phase=p) for e, p in (
        ("lm", "prefill"), ("lm", "decode"), ("diffusion", "fused"), ("diffusion", "unet_step"))}
    if (seen["lm", "prefill"], seen["lm", "decode"],
            seen["diffusion", "fused"] + seen["diffusion", "unet_step"]) != (
            leng.prefill_quanta, leng.decode_quanta, deng.quanta):
        raise AssertionError(f"full_router: phase counts {seen} against quanta "
                             f"{leng.prefill_quanta} prefill, {leng.decode_quanta} decode, "
                             f"{deng.quanta} diffusion")
    tracer = tele.tracer
    rids = sorted(by_rid)
    roots = {rid: sum(1 for s in tracer.spans if s.rid == rid and s.name == "request")
             for rid in rids}
    if tracer.rids() != rids or set(roots.values()) != {1}:
        raise AssertionError(f"full_router: root spans per rid {roots}")
    _check_against_forward(got, lm, cfg, GEN_TIE_MARGIN, label="full_router")
    steps = tele.registry.get("router_steps_total")
    log(f"[full_router] mixed run: {len(images)} images + {len(texts)} LM requests, "
        f"rids {[r.rid for r in hopeless]} rejected at submit; {wall:.2f} s wall against "
        f"{wall_d + wall_l:.2f} s for the bare runs ({wall_d:.2f} diffusion + {wall_l:.2f} "
        f"LM), {quanta} quanta ({steps.value(engine='diffusion'):.0f} diffusion / "
        f"{steps.value(engine='lm'):.0f} LM router steps over the whole phase), "
        f"{1e3 * (wall - wall_d - wall_l) / quanta:.2f} ms per quantum above the bare "
        f"runs; cost-model and telemetry syncs: {syncs.calls} calls, "
        f"{1e3 * syncs.seconds:.1f} ms blocked ({1e3 * syncs.seconds / quanta:.2f} ms per "
        f"quantum); launches {counts} = the bare runs' sum; activations "
        f"{act / 2**30:.2f} GiB above the start; KV pool {_pool_bytes(leng) / 2**30:.2f} GiB; "
        f"phase counts {seen}; one root span for each of {len(rids)} rids; {card}")
    del router, deng, leng
    torch.cuda.empty_cache()
    return totals, act


def _fleet_requests(vocab_sd: int, vocab_lm: int):
    from repro_torch.configs import SD_TURBO
    from repro_torch.engine import GenerateRequest
    from repro_torch.serving import Request
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    imgs = [GenerateRequest(rid=i, seed=600 + i, sampler="euler", steps=FLEET_STEPS,
                            preview_every=1, tokens=torch.randint(
                                0, vocab_sd, (SD_TURBO.text_len,), generator=gen,
                                device="cuda").tolist()) for i in range(2)]
    texts = [Request(rid=2 + i, max_new=LM_MAX_NEW, prompt=torch.randint(
        1, vocab_lm, (FLEET_PROMPT,), generator=gen, device="cuda").tolist())
        for i in range(2)]
    return imgs + texts


def phase_full_fleet(card: str, sd, lm, cfg, act: int) -> dict:
    """A ``FleetManager`` of two replicas, each an ``EngineRouter`` over
    SD-Turbo and Granite-8B built on the same weight tensors, serving two
    segmented images and two LM requests; once uninterrupted, once with
    replica0 killed while it holds an image mid-denoise and an LM request
    mid-prefill.  Every rid ends once, the migrated ones resume, images keep
    their bits, tokens pass the ``lm_forward`` check, and the second
    replica costs its KV pool, not a second copy of the weights."""
    from repro_torch.configs import SD_TURBO
    from repro_torch.engine import (DiffusionEngine, EngineRouter, FaultInjector,
                                    FleetManager, ReplicaSpec)
    from repro_torch.engine import events as ev
    from repro_torch.kernels import ops
    from repro_torch.serving import ContinuousBatcher
    max_len = _serve_max_len()
    totals = {name: 0 for name in ops.KERNEL_MODULES}
    built: dict[str, tuple[int, int]] = {}

    def spec(name):
        def build():
            m0 = torch.cuda.memory_allocated()
            rep = EngineRouter(
                diffusion=DiffusionEngine(sd, SD_TURBO, device="cuda", max_batch=2),
                lm=ContinuousBatcher(lm, cfg, device="cuda", slots=4, max_len=max_len,
                                     block_size=16, prefill_chunk=256))
            torch.cuda.synchronize()
            built[name] = (torch.cuda.memory_allocated() - m0, _pool_bytes(rep.lm))
            return rep
        return ReplicaSpec(name, build=build)

    def serve(injector):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fleet = FleetManager([spec("replica0"), spec("replica1")], injector=injector,
                             watchdog_threshold=1e9)
        for r in _fleet_requests(SD_TURBO.clip_cfg().vocab_size, cfg.vocab_size):
            fleet.submit(r)
        fleet.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for name, c in counts.items():
            totals[name] += c
        out = (fleet.bus.log, fleet.stats(), wall, counts,
               torch.cuda.max_memory_allocated() - m0)
        del fleet
        return out

    def results(log_):
        imgs = {e.rid: e.result.image for e in log_
                if isinstance(e, ev.Finished) and hasattr(e.result, "image")}
        reqs = [e.result for e in log_ if isinstance(e, ev.Finished)
                and hasattr(e.result, "out")]
        return imgs, reqs

    log0, stats0, wall0, _, _ = serve(None)
    if stats0["migrations"] or stats0["evictions"]:
        raise AssertionError(f"full_fleet: the uninterrupted run migrated: {stats0}")
    want_img, want_lm = results(log0)
    log1, stats1, wall1, counts, peak = serve(FaultInjector().kill("replica0", FLEET_KILL_AT))
    got_img, got_lm = results(log1)

    kill = next(j for j, e in enumerate(log1) if isinstance(e, ev.Preempted))
    before = [e for e in log1[:kill] if isinstance(e, ev.Progress)]
    denoise = [e.step for e in before if e.rid == 0 and e.phase == "denoise"]
    prefill = [e.step for e in before if e.rid == 2 and e.phase == "prefill"]
    if not (denoise and 0 < denoise[-1] < FLEET_STEPS and prefill
            and 0 < prefill[-1] < FLEET_PROMPT):
        raise AssertionError(f"full_fleet: the kill found rid 0 at denoise steps "
                             f"{denoise} and rid 2 at prefill {prefill}")
    if stats1["evictions"] != [("replica0", f"injected kill of replica0 at step "
                                            f"{FLEET_KILL_AT}")] \
            or stats1["migrations"] != 2 or stats1["lost"]:
        raise AssertionError(f"full_fleet: {stats1}")
    by_rid: dict[int, list] = {}
    for e in log1:
        by_rid.setdefault(e.rid, []).append(e)
    for rid, evs in sorted(by_rid.items()):
        kinds = [type(e).__name__ for e in evs]
        if kinds.count("Admitted") != 1 or kinds[-1] != "Finished" or sum(
                k in ("Finished", "Cancelled", "Rejected") for k in kinds) != 1:
            raise AssertionError(f"full_fleet rid {rid}: events {kinds}")
        resumed = any(isinstance(e, ev.Progress) and e.phase == "resume" for e in evs)
        if (rid in (0, 2)) != ("Preempted" in kinds) or (rid in (0, 2)) != resumed:
            raise AssertionError(f"full_fleet rid {rid}: events {kinds}")
    if sorted(by_rid) != [0, 1, 2, 3]:
        raise AssertionError(f"full_fleet: rids {sorted(by_rid)}")
    # Every batch has the bucket max_batch = 2, so the restarted image keeps
    # the uninterrupted run's bits.
    if sorted(got_img) != [0, 1] or not all(torch.equal(got_img[r], want_img[r])
                                            for r in got_img):
        raise AssertionError("full_fleet: the images are not the uninterrupted run's bits")
    _check_against_forward(got_lm, lm, cfg, GEN_TIE_MARGIN, label="full_fleet")
    same = {r.rid: r.out == next(w.out for w in want_lm if w.rid == r.rid) for r in got_lm}
    rise, pool = built["replica1"]
    if not rise <= pool + 64 * 2**20:
        raise AssertionError(f"full_fleet: building replica1 took {rise / 2**30:.2f} GiB, "
                             f"its KV pool {pool / 2**30:.2f} GiB")
    limit = 2 * pool + act + 512 * 2**20
    if not peak <= limit:
        raise AssertionError(f"full_fleet: peak {peak / 2**30:.2f} GiB above the start, "
                             f"limit {limit / 2**30:.2f} (two KV pools + activations)")
    for name in ("flash_attention", "flash_prefill_paged", "flash_decode_paged"):
        if not counts[name]:
            raise AssertionError(f"full_fleet: {name} was never launched")
    log(f"[full_fleet] 2 replicas on one weight tree; replica0 killed at its quantum "
        f"{FLEET_KILL_AT} (rid 0 at denoise step {denoise[-1]}/{FLEET_STEPS}, rid 2 at "
        f"prefill {prefill[-1]}/{FLEET_PROMPT}); {stats1['migrations']} migrated; wall "
        f"{wall1:.2f} s (uninterrupted {wall0:.2f} s); images = the uninterrupted run's "
        f"bits; LM tokens equal to the uninterrupted run's: {same}; building replica1 "
        f"took {rise / 2**30:.3f} GiB for a {pool / 2**30:.3f} GiB KV pool; peak "
        f"{peak / 2**30:.2f} GiB above the start (limit {limit / 2**30:.2f}); launches "
        f"{counts}; {card}")
    return totals


def phase_full_serving(card: str) -> dict[str, int]:
    """Phases full_router and full_fleet on one pair of weight trees."""
    sd, lm, cfg = _serving_bases()
    totals, act = phase_full_router(card, sd, lm, cfg)
    for name, n in phase_full_fleet(card, sd, lm, cfg, act).items():
        totals[name] += n
    del sd, lm
    gc.collect()
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
    rows.update(phase_paged_kernels())
    launches = {"q8_matmul_w8a8": phase_w8a8_entry()}
    phase_tiny()
    phase_tiny_lm()
    phase_tiny_gen()
    for phase in (lambda: phase_full(rows["flash_attention"]),
                  lambda: phase_full_lm(card), lambda: phase_full_gen(card),
                  lambda: phase_full_serving(card)):
        for name, n in phase().items():
            launches[name] = launches.get(name, 0) + n
    for name in KERNEL_META:
        if not launches[name]:
            where = ("through ops.quantized_matmul_w8a8, its only entry point"
                     if name == "q8_matmul_w8a8" else "on the main paths")
            raise AssertionError(f"{name} was never launched {where}")
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
