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
             The batched (expert) entries of q8_matmul and q3k_matmul, one
             launch over E experts, at deepseek-moe-16b's expert shapes
             (E = 64; 4 decode rows and a fused chunk's 30 rows per
             expert) and at edges (E = 4, M = 1 and 17, N = 70, scales
             padded per expert): within the matmul limit of the plain
             version (the 2-D plain version expert by expert), the same
             bits twice, and every expert the 2-D entry's bits on its
             operands; cuBLAS bmm on the dequantized weights beside.
             whisper-large-v3's shapes follow each kernel's earlier cases:
             flash_attention at (1, 20, 1500, 1500, 64) and (2, 20, 4, 1500,
             64), non-causal, and (2, 20, 4, 4, 64) causal; flash_decode at
             (2, 20, 1, 64) on a 20-slot cache at 1, 4 and 19 keys (the
             few-key rule); q8_matmul at its encoder and cross-KV linears
             (M = 1500), its 4-slot decode linears and untied head (N =
             51866) and the head on the tile path; the bf16 pool's paged
             prefill and the paged decode at Hkv 20, G 1, hd 64 (every row
             of at most FEW_KEYS keys: the contiguous decode's few-key rule,
             row by row).
             full_ssm's shapes follow those: flash_attention at jamba's (2,
             64, 39, 39, 128) and (1, 64, 55, 55, 128), causal; q8_matmul at
             xlstm-1.3b's linears, (2048, 2048), the gates' N = 4 and the
             head N = 50304, at M = 4 and 1 (decode path) and 188 (tile
             path); q3k_matmul at jamba's Mamba, attention and MLP linears
             (x_proj's N = 544, dt_proj's K = 512) at M = 2, 4 and 1 and 78;
             the batched q3k entry at jamba's 16 experts of 24576 (M = 2, 4,
             1 and 12 per expert); flash_decode at Hkv 8, G 8, hd 128 on a
             40-slot cache and flash_decode_paged at the same widths, block
             16 (every case of at most FEW_KEYS keys).
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

10. full_moe — deepseek-moe-16b at full width (28 layers, d 2048, 64
             routed experts of 1408, top-6, 2 shared, vocab 102400) with
             seeded synthetic weights made on the card, after tiny_moe
             (its reduced config at d 256 on the CPU and the card: one MoE
             layer routes alike, lm_forward on the card's routing, exact
             launches).  Under q8_0 and q3_k (each quantized copy freed
             before the next): greedy_generate of 8 tokens after 16 at 4
             rows, exact launches (each expert projection one batched
             launch); its make_decode replay, and a plain replay pinned to
             the replay's expert sets with every batched launch held to
             its plain version: logits within GEN_LOGIT_TOL, argmax above
             GEN_TIE_MARGIN, and where the plain replay's own router would
             have routed otherwise reported; then ContinuousBatcher over 5
             prompts of 280-600 tokens (fused chunks: 30 rows per expert,
             the tile path) with every batched launch held to its plain
             version on its own inputs, events, exact launches, and a
             profile of one decode quantum and one prefill chunk.
11. full_asr — whisper-large-v3 at full width and depth (32 + 32 layers,
             d 1280, 20 heads of 64, 1500 encoder frames, vocab 51866) with
             seeded synthetic weights and audio made on the card, after
             full_moe's weights are freed.  Under q8_0 and none, the
             streaming ``AsrEngine(slots=4, block 16, cross block 16,
             audio_chunk=500, prefill_chunk=4)`` over 5 requests of a
             4-token prompt and 32 new tokens, the fifth with the first
             one's audio and prompt.  Gates: request 0's cross blocks after
             its third encode quantum hold a one-shot encode's bits; one
             audio hit, 12 encode quanta, the fifth transcript the first's;
             one Admitted and Finished per rid, Progress per encode quantum,
             a TokenDelta per token; a consistent runtime holding only the
             published audio chains; exact launches; tokens against
             ``lm_forward(enc_embeds=...)`` and a replay of the engine's
             path (logits within GEN_LOGIT_TOL, argmax above
             GEN_TIE_MARGIN), the replay against a plain one with every
             flash_decode_paged call held to its plain version.  Logged: ms
             per synchronised encode quantum, prompt chunk and 4-slot
             decode step, a profile of each, peak memory.  Under q8_0 also
             ``greedy_generate(enc_embeds=...)`` at 2 rows, 16 new tokens
             (exact launches, make_prefill, tokens against lm_forward, every
             flash_decode call of a plain replay held to its plain version) and
             an ``EngineRouter`` with only ``asr=`` and a calibrated
             ``CostModel``: a 1 ms request Rejected at submit, another with
             the bare engine's transcript.

12. full_ssm — after tiny_ssm (reduced(xlstm-1.3b) under q8_0 and
             reduced(jamba-1.5-large) under q3_k on the CPU and the card:
             greedy_generate and a 2-slot ContinuousBatcher give identical
             tokens, with exact launches), xlstm-1.3b at full size (48 layers:
             42 mLSTM + 6 sLSTM, d 2048, 4 heads of 512, vocab 50304) under
             q8_0 and none: greedy_generate of 16 tokens after 32 at 4 rows
             (exact launches: 325 q8_matmul per step under q8_0), its
             synchronised make_decode replay (the same tokens, ms per step),
             under q8_0 a plain replay with every q8_matmul routed to its
             plain version and the kernel held to it on the last step's 325
             calls, and an f32 replay (the same weights widened or
             dequantized, f32 activations: the witness, itself within
             GEN_LOGIT_TOL of lm_forward in f32); the kernel replay
             against the plain one and the replay against lm_forward (the
             parallel mLSTM form) are each held one-sided to the witness,
             as the few-key rule is: the first no more than GEN_LOGIT_TOL
             further from it in a logit than the second, and flipping no
             argmax at a witness margin more than GEN_TIE_MARGIN wider than
             the widest the second flips (at 48 layers two bf16 roundings
             of one path differ by about 1 in a logit); every recurrent
             layer's two forms on lm_forward's own inputs within
             SSM_LAYER_REL of its largest output; then
             ContinuousBatcher(4 slots, block 16, chunk 16) over 6 requests
             of 24-64 prompt tokens and 16 new
             (two in recycled slots): events, exact launches (the scan
             prefill: one forward per prompt token), each request's tokens
             and logits the bits of the same request alone in a fresh
             batcher (the reset at full width), and each request against a
             replay of it alone from a zeroed state (GEN_LOGIT_TOL,
             GEN_TIE_MARGIN; the reference's reset: an sLSTM served this
             way differs from greedy_generate by design).  Then
             jamba-1.5-large at full width (d 8192, 64/8 heads of 128, 16
             experts of 24576 top-2, vocab 65536) and one period of its 72
             layers (attention + 7 Mamba, MoE on positions 0/2/4/6), weights
             drawn and quantized to q3_k layer by layer on the card:
             greedy_generate of 8 tokens after 32 at 2 rows (exact launches:
             56 q3k_matmul, 1 q8_matmul and 1 flash_decode per step), the
             replay with every batched expert launch of its last step held
             to its plain version, tokens against lm_forward with a capacity
             that drops nothing (``_no_drops``: lm_forward drops tokens by
             design at 1.25) within JAMBA_LOGIT_TOL / GEN_TIE_MARGIN, and
             the control, lm_forward at 1.25, beyond JAMBA_LOGIT_TOL; each
             Mamba layer's two forms within SSM_LAYER_REL; then
             ContinuousBatcher(4 slots) over 5
             requests of 24-48 tokens and 8 new (events, exact launches,
             tokens against lm_forward likewise).  Logged: ms per
             synchronised decode step and decode quantum, ms per
             scan-prefill token, a profile of one decode step and one decode
             quantum, peak memory, the phase's seconds.
13. full_vlm — qwen2-vl-72b at full width and depth (80 layers, d 8192,
             64/8 heads of 128, M-RoPE, d_ff 29568, vocab 152064) under q3_k,
             drawn and quantized layer by layer on the card (every down
             projection dense bf16: K = 29568 is no multiple of 256; peak
             logged against the 63 GB reckoning).  make_prefill on 2 rows of
             a 256-patch vision prefix and 16 tokens: the bits of
             lm_forward(prefix_embeds=..., last_only=True), differing from the
             same text without the prefix; every layer's kernel path against
             its plain path (every kernel routed to its plain version) on the
             same input within VLM_LAYER_REL; greedy_generate of 2 prompts x
             16 new with exact launches per decode step (480 q3k_matmul, 1
             q8_matmul, 80 flash_decode, 80 cuBLAS down projections) and its
             replay; a 4-request ContinuousBatcher (bf16 KV, fused prefill)
             with exact launches.  Then an 8-layer cut at full width under
             q3_k and q8_0: greedy_generate's replay and each served
             request's logits against lm_forward under GEN_LOGIT_TOL /
             GEN_TIE_MARGIN, or where that does not hold one-sided to an f32
             lm_forward of the same weights (``_check_witness``).
14. full_train — tiny_train (reduced(granite-8b), one step on the CPU and
             the card: losses within the attention limit, flash_attention
             twice per layer under remat="block"); granite-8b at full width:
             36 layers with Q8_0 moments and remat="block", 1 x 512 tokens,
             3 steps on one batch (the loss falls at every step, the
             parameters change, 72 flash_attention launches a step; step
             time, a profiled step, peak against the 51 GB reckoning); a
             4-layer cut, 2 x 512: loss and every gradient leaf of the kernel
             path (flash_attention's forward, the plain backward) against the
             all-plain path within TRAIN_GRAD_REL (else one-sided to the f32
             gradient), exact launches under remat "none" and "block", one
             step each with microbatch=1, gradient compression and f32
             moments; then ``python -m repro_torch.launch.train --reduced
             --device cuda`` with checkpoints every 2 steps: a run stopped
             after step 2 and resumed has the uninterrupted run's step-4
             parameters and optimizer state bit for bit, and a rerun resumes
             at step 4.

Progress goes to stderr.  Standard output gets three lines at the end of
a run that passed: the card's name and power limit as ``nvidia-smi``
gives them, a JSON object ``{"kernels": [...]}`` (per kernel: launches
on the main paths, phases full, full_lm, full_gen, full_router,
full_fleet, full_moe, full_asr, full_ssm, full_vlm and full_train, and for
``q8_matmul_w8a8`` through its entry point; worst error; the headline
shape's times and bound), and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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
# whisper-large-v3 (phase full_asr): the encoder's non-causal
# self-attention over 1500 frames (a ragged last key tile), and
# make_prefill's cross-attention and causal decoder self-attention of a
# 4-token prompt at 2 rows (the latter with the LM shapes' allowance).
ATTN_ASR_SHAPES = [(1, 20, 1500, 1500, 64, False, None),
                   (2, 20, 4, 1500, 64, False, None),
                   (2, 20, 4, 4, 64, True, None)]
# jamba-1.5-large (phase full_ssm): its one attention layer (64 heads of
# 128, KV heads repeated from 8) through lm_forward over greedy_generate's
# 2 rows of 39 tokens, and over one served request of 55 (the LM shapes'
# allowance: the first causal rows see a handful of keys).
ATTN_SSM_SHAPES = [(2, 64, 39, 39, 128, True, None), (1, 64, 55, 55, 128, True, None)]
# qwen2-vl-72b (phase full_vlm; its shapes are listed there) and
# granite-8b's training (phase full_train): the full-depth step's 1 x 512
# tokens and the 4-layer cut's 2 x 512, causal, KV heads repeated to 32
# (the LM shapes' allowance).
ATTN_TRAIN_SHAPES = [(1, 32, 512, 512, 128, True, None), (2, 32, 512, 512, 128, True, None)]
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
# whisper-large-v3's linears under q8_0 (phase full_asr): one slot's
# encoder pass and write_cross_kv at M = 1500 (q, k, v, o and the cross
# k and v; up; down), the 4-slot decode step and 4-token prompt chunk
# (the same, and the untied 51866-row head, no multiple of any tile); an
# edge: the head on the tile path (lm_forward over one request's 35
# positions).
ASR_Q8_SHAPES = [(1500, 1280, 1280), (1500, 5120, 1280), (1500, 1280, 5120),
                 (4, 1280, 1280), (4, 5120, 1280), (4, 1280, 5120),
                 (4, 51866, 1280)]
ASR_Q8_EDGE = [(35, 51866, 1280)]
# xlstm-1.3b's linears under q8_0 (phase full_ssm): every linear of its
# mLSTM and sLSTM blocks is (2048, 2048) but mLSTM's input and forget
# gates, N = 4 (one row per head: the N tail's extreme); the untied head
# N = 50304.  At 4 decode rows (greedy_generate, the 4-slot batcher), at 1
# (the batcher's scan prefill), and on the tile path at lm_forward's 4 x 47
# rows.
SSM_Q8_SHAPES = [(4, 2048, 2048), (4, 4, 2048), (4, 50304, 2048)]
SSM_Q8_EDGE = [(1, 2048, 2048), (1, 4, 2048), (188, 2048, 2048), (188, 4, 2048),
               (188, 50304, 2048)]
# jamba-1.5-large's linears under q3_k (phase full_ssm): Mamba's in_proj,
# x_proj (N = dt_rank 512 + 2 x 16 = 544), dt_proj (K = 512) and out_proj;
# attention's q/o and k/v; the MLP's up/gate and down.  At greedy_generate's
# 2 decode rows, the batcher's 4 slots and its batch-1 scan prefill, and on
# the tile path at lm_forward's 2 x 39 rows.
JAMBA_NK = [(32768, 8192), (544, 16384), (16384, 512), (8192, 16384),
            (8192, 8192), (1024, 8192), (24576, 8192), (8192, 24576)]
SSM_Q3K_SHAPES = [(2, n, k) for n, k in JAMBA_NK]
SSM_Q3K_EDGE = ([(4, n, k) for n, k in JAMBA_NK[:2]] + [(1, 544, 16384)]
                + [(78, n, k) for n, k in JAMBA_NK])
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
# The batched entries (one launch over an MoE layer's experts): (E, M, N,
# K) at deepseek-moe-16b's expert projections, up/gate (N 1408, K 2048)
# and down (N 2048, K 1408), at 4 decode rows per expert (decode path) and
# at a 256-token fused chunk's capacity, int(1.25 * 256 * 6 / 64) = 30 rows
# (tile path).  Under q3_k only up and gate are Q3_K (1408 % 256 != 0).
# Edges: 4 experts of one row and of 17 rows, N = 70 off every tile, K =
# 96 (Q8_0) or 256 (Q3_K): per-expert scale and d sizes that are no
# multiple of 16 bytes, so the wrapper pads them.
MOE_CHUNK_CAP = int(1.25 * 256 * 6 / 64)
Q8_EXPERT_SHAPES = [(64, 4, 1408, 2048), (64, 4, 2048, 1408),
                    (64, MOE_CHUNK_CAP, 1408, 2048), (64, MOE_CHUNK_CAP, 2048, 1408)]
Q8_EXPERT_EDGE = [(4, 1, 70, 96), (4, 17, 70, 96)]
Q3K_EXPERT_SHAPES = [(64, 4, 1408, 2048), (64, MOE_CHUNK_CAP, 1408, 2048)]
Q3K_EXPERT_EDGE = [(4, 1, 70, 256), (4, 17, 70, 256)]
# jamba-1.5-large's MoE layers (16 experts of 24576, top-2) under q3_k: up
# and gate (N 24576, K 8192) and down (N 8192, K 24576) at greedy_generate's
# 2 decode rows per expert, the batcher's 4 and 1, and lm_forward's capacity
# of 2 groups x int(1.25 * 39 * 2 / 16) = 12 rows.
JAMBA_EXPERT_SHAPES = [(16, 2, 24576, 8192), (16, 2, 8192, 24576)]
JAMBA_EXPERT_EDGE = [(16, 4, 24576, 8192), (16, 1, 8192, 24576), (16, 12, 24576, 8192),
                     (16, 12, 8192, 24576)]
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
# whisper-large-v3's greedy_generate (phase full_asr): 2 rows, 20 KV heads
# of 64, G = 1, a 20-slot cache (4-token prompt + 16 new) read at 1, 4 and
# 19 keys; every case of at most FEW_KEYS keys.
ASR_FLASH_DECODE = [(2, 20, 1, 64, 20, n) for n in (19, 1, 4)]
# jamba-1.5-large's greedy_generate (phase full_ssm): 2 rows, 8 KV heads of
# 128, G = 8, a 40-slot cache (32-token prompt + 8 new) read at 39, 1 and
# 32 keys; every case of at most FEW_KEYS keys.
SSM_FLASH_DECODE = [(2, 8, 8, 128, 40, n) for n in (39, 1, 32)]

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
PAGED_WIDTHS = (PAGED_HKV, PAGED_G, PAGED_HD, PAGED_BS)
# whisper-large-v3's decoder (phase full_asr): 20 KV heads of 64, G = 1,
# block 16, 35 positions per slot (3 blocks).  Prefill: its 4-token prompt
# chunk, and a chunk in the last block; decode: 4 slots with an idle row,
# and positions at both ends of a block.
ASR_WIDTHS = (20, 1, 64, 16)
ASR_PREFILL = [(4, 0, 3, None, True), (4, 30, 3, None, True)]
ASR_DECODE = [((34, 20, 5, 0), 3, None, True), ((3, 15, 16, 33), 3, None, True)]
# jamba-1.5-large's attention layer in the batcher (phase full_ssm): 8 KV
# heads of 128, G = 8, block 16, 55 positions per slot (4 blocks), 4 slots
# with an idle row, positions at both ends of a block; at most FEW_KEYS keys.
SSM_WIDTHS = (8, 8, 128, 16)
SSM_DECODE = [((54, 30, 5, 0), 4, None, True), ((15, 16, 47, 31), 4, None, True)]

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
    lm_rows = (shape in ATTN_LM_SHAPES + ATTN_SSM_SHAPES + ATTN_VLM_SHAPES + ATTN_TRAIN_SHAPES
               or (causal and shape in ATTN_ASR_SHAPES))
    atol = ATTN_ABS + (ATTN_P_ROUND * v.float().abs().max().item() if lm_rows else 0.0)
    excess = (diff - atol - ATTN_REL * want.float().abs()).max().item()
    if not excess <= 0:
        raise AssertionError(f"flash_attention {shape}: max|err| {err}; some "
                             f"|err| exceeds {atol} + {ATTN_REL}*|ref| "
                             f"by {excess}")
    if not torch.equal(kern(), out):
        raise AssertionError(f"flash_attention {shape}: a second call gave other bits")
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


def few_key_rule(q, k, v, n, scale=None):
    """The few-key rule of a decode call on contiguous rows: q (B, Hkv, G,
    hd), k and v (B, Hkv, C, hd), n (B,) keys of each row.  Returns per row
    (B,) the ATTN_P_ROUND * max|v| allowance over its keys when they are at
    most FEW_KEYS (else 0), and the attention of the same bf16 inputs in
    f64 over those keys (B, Hkv, G, hd): the yardstick of the one-sided
    check (``few_key_excess``)."""
    n = n.long().to(q.device)
    valid = torch.arange(k.shape[2], device=q.device)[None, :] < n[:, None]
    zero = torch.zeros((), dtype=torch.float64, device=q.device)
    vals = torch.where(valid[:, None, :, None], v.double(), zero)
    lg = torch.einsum("bhgd,bhcd->bhgc", q.double(), k.double()) * (scale or q.shape[-1] ** -0.5)
    lg = lg.masked_fill(~valid[:, None, None, :], float("-inf"))
    exact = torch.einsum("bhgc,bhcd->bhgd", torch.softmax(lg, -1), vals)
    p_round = ATTN_P_ROUND * vals.abs().amax(dim=(1, 2, 3)).float() * (n <= FEW_KEYS)
    return p_round, exact


def few_key_excess(got, want, exact) -> tuple:
    """The one-sided few-key check: the kernel's output ``got`` may be no
    more than ATTN_ABS further from the f64 attention ``exact`` than the
    plain version's ``want``.  -> (excess, kernel distance, plain distance)
    as 0-dim tensors; the check holds when excess <= 0."""
    kern = (got.double() - exact).abs().amax()
    plain = (want.double() - exact).abs().amax()
    return (kern - plain - ATTN_ABS).float(), kern, plain


def _check_few_keys(name: str, case, out, want, p_round, exact) -> None:
    """Log a few-key case's allowance per row and its f64 distances, and
    raise if the one-sided check fails."""
    excess, kern, plain = few_key_excess(out, want, exact)
    log(f"[kernels] {name} {case}: limit + {p_round.tolist()} per row (ATTN_P_ROUND * "
        f"max|v|); from an f64 softmax: kernel {kern.item():.3e}, plain {plain.item():.3e}")
    if not excess.item() <= 0:
        raise AssertionError(f"{name} {case}: the kernel is {kern.item()} from an f64 "
                             f"softmax, the plain version {plain.item()}: more than "
                             f"{ATTN_ABS} further")


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
    p_round = 0.0
    if n <= FEW_KEYS:
        p_round, exact = few_key_rule(q, k, v, kv_len.expand(b), scale)
        _check_few_keys("flash_decode", case, out, want, p_round, exact)
        p_round = p_round[:, None, None, None]
    row = {"shape": case,
           "max_abs_err": _check_attn("flash_decode", case, out, want, p_round)}
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
# The batched entries' cases draw from generators of their own too (their
# rows follow the kernel's own in its list).
EXPERT_SEED_OFFSET = {"q8_matmul": 16, "q3k_matmul": 17}


def phase_kernels() -> dict[str, list[dict]]:
    gens = {kind: torch.Generator(device="cuda").manual_seed(SEED + off)
            for kind, off in KERNEL_SEED_OFFSET.items()}
    rows = {kind: [] for kind in KERNEL_SEED_OFFSET}
    # Each kernel's later slices' cases follow its earlier ones, so that
    # they change none of the earlier cases' inputs.
    for shape in (ATTN_SHAPES + ATTN_LM_SHAPES + ATTN_EDGE + ATTN_ASR_SHAPES
                  + ATTN_SSM_SHAPES + ATTN_VLM_SHAPES + ATTN_TRAIN_SHAPES):
        rows["flash_attention"].append(
            _attn_case(shape, gens["flash_attention"], timed=shape not in ATTN_EDGE))
    timed_later = (ASR_Q8_SHAPES + SSM_Q8_SHAPES + SSM_Q3K_SHAPES + VLM_Q8_SHAPES
                   + VLM_Q3K_SHAPES)
    for kind, shapes, edges, later in (
            ("q8_matmul", Q8_SHAPES, Q8_EDGE,
             ASR_Q8_SHAPES + ASR_Q8_EDGE + SSM_Q8_SHAPES + SSM_Q8_EDGE + VLM_Q8_SHAPES
             + VLM_Q8_EDGE),
            ("q3k_matmul", Q3K_SHAPES, Q3K_EDGE,
             SSM_Q3K_SHAPES + SSM_Q3K_EDGE + VLM_Q3K_SHAPES + VLM_Q3K_EDGE),
            ("q4_matmul", Q4_SHAPES, Q4_EDGE, []),
            ("q8_matmul_w8a8", W8A8_SHAPES, W8A8_EDGE, [])):
        for shape in shapes + edges + later:
            timed = shape in shapes or shape in timed_later
            rows[kind].append(_matmul_case(kind, shape, gens[kind], timed=timed))
    for case in (FLASH_DECODE_SHAPES + FLASH_DECODE_EDGE + ASR_FLASH_DECODE + SSM_FLASH_DECODE
                 + VLM_FLASH_DECODE):
        rows["flash_decode"].append(_flash_decode_case(
            case, gens["flash_decode"],
            timed=case in FLASH_DECODE_SHAPES or case in (ASR_FLASH_DECODE[0],
                                                          SSM_FLASH_DECODE[0],
                                                          VLM_FLASH_DECODE[0])))
    for kind, shapes, edges, later in (
            ("q8_matmul", Q8_EXPERT_SHAPES, Q8_EXPERT_EDGE, []),
            ("q3k_matmul", Q3K_EXPERT_SHAPES, Q3K_EXPERT_EDGE,
             JAMBA_EXPERT_SHAPES + JAMBA_EXPERT_EDGE)):
        gen = torch.Generator(device="cuda").manual_seed(SEED + EXPERT_SEED_OFFSET[kind])
        for shape in shapes + edges + later:
            rows[kind].append(_experts_case(
                kind, shape, gen, timed=shape in shapes + JAMBA_EXPERT_SHAPES))
    _log_rows(rows)
    return rows


def _experts_weight(kind: str, w: torch.Tensor):
    """The experts' weight quantized expert by expert (the same bytes as
    one call: blocks run along K), with one expert's temporaries."""
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import Linear, quantize_linear
    pol = get_policy("q8_0" if kind == "q8_matmul" else "q3_k")
    return quantize_linear(Linear(w, role="expert_up"), pol).w


def _experts_case(kind: str, shape, gen, timed: bool) -> dict:
    """One launch of the batched entry of ``kind`` over E experts against
    its plain version, a second call for the same bits, and every expert
    against the two-dimensional entry on that expert's operands (the same
    bits: one CTA computes the same sums in either)."""
    from repro_torch.core import quant
    from repro_torch.kernels import ops
    from repro_torch.kernels import q3k_matmul as q3k
    from repro_torch.kernels import q8_matmul as q8
    e, m, n, kdim = shape
    x = torch.randn((e, m, kdim), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((e, n, kdim), generator=gen, device="cuda") * kdim ** -0.5
    wt = _experts_weight(kind, w)
    del w
    if kind == "q8_matmul":
        def kern():
            return q8.q8_matmul_experts(x, wt.qs, wt.d)

        def one(i):
            return q8.q8_matmul(x[i], wt.qs[i], wt.d[i])
        wbytes = e * (n * kdim + 2 * n * kdim // 32)
    else:
        def kern():
            return q3k.q3k_matmul_experts(x, wt.ql, wt.qh, wt.scales, wt.d)

        def one(i):
            return q3k.q3k_matmul(x[i], wt.ql[i], wt.qh[i], wt.scales[i], wt.d[i])
        wbytes = e * (n * kdim // 4 + n * kdim // 8 + 14 * n * kdim // 256)

    def plain():        # ops' CPU route: the 2-D plain version expert by expert
        return ops._experts_plain(x, wt)

    def library():
        return torch.bmm(x, quant.dequantize(wt, torch.bfloat16).transpose(1, 2))
    out, want = kern(), plain()
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    tol = MATMUL_RTOL * max(1.0, want.abs().max().item())
    label = f"{kind} experts {shape}"
    if not (torch.isfinite(out).all() and err <= tol):
        raise AssertionError(f"{label}: max|err| {err} > {tol}")
    if not torch.equal(kern(), out):
        raise AssertionError(f"{label}: a second call gave other bits")
    for i in range(e):
        if not torch.equal(one(i), out[i]):
            raise AssertionError(f"{label}: expert {i} differs from the "
                                 "two-dimensional entry's bits")
    row = {"shape": shape, "max_abs_err": err}
    if timed:
        wd = quant.dequantize(wt, torch.bfloat16)

        def dense():
            return torch.bmm(x, wd.transpose(1, 2))
        row.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=3),
                   library_ms=cuda_ms(library), device_ms=device_ms(kern),
                   library_device_ms=device_ms(library), cublas_ms=cuda_ms(dense),
                   cublas_device_ms=device_ms(dense))
        del wd
        row["bound_ms"], row["bound_by"] = bound(
            2.0 * e * m * n * kdim, 2 * e * m * kdim + wbytes + 4 * e * m * n)
    return row


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


def _paged_pools(gen, nb: int, q8: bool, widths=PAGED_WIDTHS) -> list:
    hkv, _, hd, bs = widths
    shape = (nb, hkv, bs, hd)
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


def _prefill_plan(t: int, pos0: int, window, q8: bool, widths=PAGED_WIDTHS) -> dict:
    """The attend launch's plan on this card at ``widths`` (Hkv, G, hd,
    bs; Granite-8B's by default): the clusters of 1, 2, 4 and 8 CTAs that
    run at once (the kernel's own query, ``flash_prefill_fit``), and the
    CTAs per cluster they give."""
    import ctypes

    from repro_torch.kernels import build
    lib, fn = build.entry("flash_prefill", "flash_prefill_fit",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fit = (ctypes.c_int * 4)()
    hkv, g, hd, _ = widths
    build.check(lib, "flash_prefill_fit", fn(hd, int(q8), ctypes.addressof(fit)))
    split = prefill_plan(t, hkv, g, pos0, window, list(fit))[1]
    return {"fit": list(fit), "split": split}


def _prefill_case(q8: bool, case, gen, timed: bool, widths=PAGED_WIDTHS) -> dict:
    from repro_torch.core import quant
    from repro_torch.kernels import flash_prefill as fp
    t, pos0, mb, window, poison = case
    hkv, g, hd, bs = widths
    nb = mb + 40
    stale = VERIFY_STALE if case in VERIFY_EDGE else 0
    used = -(-(pos0 + t + stale) // bs)
    table = (torch.randperm(nb - 1, generator=gen, device="cuda")[:mb] + 1).to(torch.int32)
    table[used:] = 0                                   # NULL_BLOCK padding
    q = torch.randn((t, hkv, g, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kn = torch.randn((t, hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    vn = torch.randn((t, hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    pools = _paged_pools(gen, nb, q8, widths)
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
    row = {"shape": case, "max_abs_err": err,
           "plan": _prefill_plan(t, pos0, window, q8, widths)}
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


def paged_few_keys(q, kpool, vpool, tables, pos, scale=None):
    """``few_key_rule`` of a paged decode call without a window: each row's
    blocks gathered to contiguous (B, Hkv, MB * bs, hd), pos + 1 keys."""
    def rows(pool):
        g = pool[tables.long()].transpose(1, 2)        # (B, Hkv, MB, bs, hd)
        return g.reshape(*g.shape[:2], -1, g.shape[-1])
    return few_key_rule(q, rows(kpool), rows(vpool), pos.long() + 1, scale)


def _decode_case(case, gen, timed: bool, widths=PAGED_WIDTHS,
                 few_keys: bool = False) -> dict:
    from repro_torch.kernels import flash_decode as fd
    positions, mb, window, poison = case
    b = len(positions)
    hkv, g, hd, bs = widths
    nb = b * mb + 8
    perm = torch.randperm(nb - 1, generator=gen, device="cuda")[:b * mb] + 1
    tables = perm.to(torch.int32).reshape(b, mb)
    for r, p in enumerate(positions):
        tables[r, -(-(p + 1) // bs):] = 0              # NULL_BLOCK past the row
    if positions[-1] == 0:
        tables[-1] = 0                                 # an idle row
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    q = torch.randn((b, hkv, g, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kpool, vpool = _paged_pools(gen, nb, False, widths)
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
    p_round = 0.0
    if few_keys:
        # Every row of whisper's decoder has at most FEW_KEYS keys: the
        # contiguous decode's few-key rule, row by row.
        assert window is None
        p_round, exact = paged_few_keys(q, kpool, vpool, tables, pos)
        _check_few_keys("flash_decode_paged", case, out, want, p_round, exact)
        p_round = p_round[:, None, None, None]
    row = {"shape": case, "max_abs_err": _check_attn("flash_decode_paged", case,
                                                     out, want, p_round)}
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
    Granite-8B's main-path shapes and at edge shapes, then the bf16 pool's
    prefill and the decode at whisper-large-v3's widths (Hkv 20, G 1, hd
    64)."""
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
    for case in ASR_PREFILL:
        rows["flash_prefill_paged"].append(_prefill_case(
            False, case, gen, timed=case == ASR_PREFILL[0], widths=ASR_WIDTHS))
    for case in ASR_DECODE:
        rows["flash_decode_paged"].append(_decode_case(
            case, gen, timed=case == ASR_DECODE[0], widths=ASR_WIDTHS, few_keys=True))
    for case in SSM_DECODE:
        rows["flash_decode_paged"].append(_decode_case(
            case, gen, timed=case == SSM_DECODE[0], widths=SSM_WIDTHS, few_keys=True))
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


def _replay(params, cfg, out, steps: int, max_len: int = GEN_MAX_LEN,
            enc_embeds=None, zeroed: bool = False, check=None):
    """Feed ``out``'s tokens through ``make_cache`` + ``make_decode`` one
    synchronised step at a time: (logits (B, steps, V), seconds per step,
    the cache).  An encoder-decoder model takes ``enc_embeds``; ``zeroed``
    first zeroes every recurrent row (the batcher's reset); ``check`` (a
    ``_PlainQ8`` or ``_CheckedExperts``) is active on the last step only."""
    from repro_torch.models.transformer import cache_slot_reset
    from repro_torch.train.serve_step import make_cache, make_decode
    cache = make_cache(params, cfg, out.shape[0], max_len, enc_embeds=enc_embeds,
                       device="cuda")
    if zeroed:
        for row in range(out.shape[0]):
            cache_slot_reset(cache, row)
    decode = make_decode(cfg, device="cuda")
    logits, times = [], []
    with torch.no_grad():
        for i in range(steps):
            if check is not None:
                check.active = i == steps - 1
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            _, lg, cache = decode(params, out[:, i:i + 1], i, cache)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            logits.append(lg[:, 0])
    return torch.stack(logits, dim=1), times, cache


class _PlainDecodeAttention:
    """Route ``ops.decode_attention`` on the card to ``flash_decode_ref``
    (``paged=True``: ``ops.paged_decode_attention`` to
    ``flash_decode_paged_ref``), and hold the kernel on each call's inputs
    against it within the attention limit: every main-path position of
    every layer.  ``few_keys`` applies the few-key rule (``few_key_rule``,
    paged: ``paged_few_keys``) to rows of at most FEW_KEYS keys."""

    def __init__(self, paged: bool = False, few_keys: bool = False):
        self.paged, self.few_keys = paged, few_keys

    def __enter__(self):
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.kernels import ops
        self.name = "paged_decode_attention" if self.paged else "decode_attention"
        kern, ref = ((fd.flash_decode_paged, fd.flash_decode_paged_ref) if self.paged
                     else (fd.flash_decode, fd.flash_decode_ref))
        self.kernel_path = getattr(ops, self.name)
        self.calls, self.err, self.excess, self.bare = 0, None, None, None

        def plain_and_check(*args, **kw):
            want = ref(*args, **kw)
            got = kern(*args, **kw)
            diff = (got.float() - want.float()).abs()
            atol = ATTN_ABS
            # The excess over the limit without the few-key allowance: how
            # much of the limit that allowance carries (logged only).
            bare = (diff - ATTN_ABS - ATTN_REL * want.float().abs()).amax()
            self.bare = bare if self.bare is None else torch.maximum(self.bare, bare)
            if self.few_keys:
                if self.paged:
                    p_round, exact = paged_few_keys(*args, scale=kw.get("scale"))
                else:
                    q, k, v, kv_len = args
                    p_round, exact = few_key_rule(q, k, v, kv_len.expand(q.shape[0]),
                                                  kw.get("scale"))
                atol = atol + p_round[:, None, None, None]
                # One-sided, folded into the same excess.
                far = few_key_excess(got, want, exact)[0]
                self.excess = far if self.excess is None else torch.maximum(
                    self.excess, far)
            excess = (diff - atol - ATTN_REL * want.float().abs()).amax()
            self.err = diff.amax() if self.err is None else torch.maximum(
                self.err, diff.amax())
            self.excess = excess if self.excess is None else torch.maximum(
                self.excess, excess)
            self.calls += 1
            return want
        setattr(ops, self.name, plain_and_check)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        setattr(ops, self.name, self.kernel_path)


def _check_gen_against_plain(preset: str, dec, plain, oracle,
                             label: str = "full_gen") -> None:
    """The decode kernel within the attention limit of its plain version
    at every call of the plain replay (``oracle``), and the kernel replay
    ``dec`` against the plain replay ``plain`` on the same tokens: every
    logit within GEN_LOGIT_TOL, and the same argmax at every position
    where the plain replay's top-2 margin exceeds GEN_TIE_MARGIN."""
    err, excess = oracle.err.item(), oracle.excess.item()
    kernel = "flash_decode_paged" if oracle.paged else "flash_decode"
    if not excess <= 0:
        raise AssertionError(f"{label} {preset}: {kernel} exceeds {ATTN_ABS} + "
                             f"{ATTN_REL}*|ref| by {excess} on the main path")
    diff = (dec - plain).abs()
    worst = diff.max().item()
    same = (diff == 0).float().mean().item()
    top = plain.topk(2, dim=-1)
    margin = (top.values[..., 0] - top.values[..., 1]).cpu()
    flips = (dec.argmax(-1) != plain.argmax(-1)).cpu()
    bare = (f" (excess over {ATTN_ABS} + {ATTN_REL}*|ref| without the few-key "
            f"allowance {oracle.bare.item():.3e})" if oracle.few_keys else "")
    log(f"[{label}] weights={preset}: {kernel} at {oracle.calls} calls of the "
        f"plain replay: max|err| {err:.3e} against its plain version{bare}; replays' "
        f"logits within {worst:.4f} ({100 * same:.3f}% bit-equal), "
        f"{int(flips.sum())} of {flips.numel()} argmax differ"
        + "".join(f"; row {r} position {i} (margin {float(margin[r, i]):.4f})"
                  for r, i in flips.nonzero().tolist()))
    if not worst <= GEN_LOGIT_TOL or (flips & (margin > GEN_TIE_MARGIN)).any():
        raise AssertionError(f"{label} {preset}: the {kernel} replay's logits "
                             f"differ from the plain replay's by {worst} (limit "
                             f"{GEN_LOGIT_TOL}), or its argmax where the margin "
                             f"exceeds {GEN_TIE_MARGIN}")


def _f32_params(params):
    """An f32 copy of a weight tree: every quantized weight dequantized (its
    exact values), every bf16 leaf widened.  The model then runs with f32
    activations: the witness of a whole-model comparison."""
    from repro_torch.core.qlinear import QTYPES
    from repro_torch.core.quant import dequantize
    from repro_torch.core.tree import tree_map

    def widen(t):
        if isinstance(t, QTYPES):
            return dequantize(t, torch.float32)
        return t.float() if t.is_floating_point() else t
    return tree_map(widen, params, is_leaf=lambda t: isinstance(t, QTYPES))


def witness_far(x, exact) -> tuple:
    """How far the logits ``x`` are from the witness ``exact`` (the same
    positions): (max|x - exact|, the widest top-2 margin of ``exact`` at
    which x's argmax differs from exact's (0 if none), how many differ)."""
    top = exact.topk(2, dim=-1)
    margin = top.values[..., 0] - top.values[..., 1]
    flips = x.argmax(-1) != top.indices[..., 0]
    widest = margin[flips].max().item() if flips.any() else 0.0
    return (x - exact).abs().max().item(), widest, int(flips.sum())


def _check_witness(label: str, dec, ref, exact, names: tuple) -> float:
    """The one-sided whole-model check of ``dec`` against ``ref`` (logits of
    the same tokens; ``names`` theirs) through the witness ``exact`` (an f32
    replay): ``dec`` no more than GEN_LOGIT_TOL further from it in a logit
    than ``ref``, and ``dec``'s argmax that of ``exact`` wherever exact's
    top-2 margin exceeds the widest at which ``ref``'s argmax differs from
    it plus GEN_TIE_MARGIN.  Returns that margin."""
    d_dec, w_dec, n_dec = witness_far(dec, exact)
    d_ref, w_ref, n_ref = witness_far(ref, exact)
    bare = (dec - ref).abs().max().item()
    held = w_ref + GEN_TIE_MARGIN
    top = exact.topk(2, dim=-1)
    compared = int((top.values[..., 0] - top.values[..., 1] > held).sum())
    log(f"[{label}] {names[0]} vs {names[1]}: logits within {bare:.4f} of each "
        f"other; from the f32 witness {d_dec:.4f} and {d_ref:.4f} (limit "
        f"{names[1]} + {GEN_LOGIT_TOL}); argmax differs from the witness's at "
        f"{n_dec} and {n_ref} of {top.indices[..., 0].numel()} positions, at "
        f"margins up to {w_dec:.4f} and {w_ref:.4f}; {compared} positions with "
        f"a witness margin above {held:.4f} compared")
    if not (d_dec <= d_ref + GEN_LOGIT_TOL and w_dec <= held):
        raise AssertionError(f"{label}: the {names[0]} is {d_dec} from the f32 witness, "
                             f"the {names[1]} {d_ref} (allowance {GEN_LOGIT_TOL}); or "
                             f"its argmax differs from the witness's at a margin of "
                             f"{w_dec} > {held}")
    return held


def _check_gen_against_forward(params, cfg, out, dec, first, prompt: int = GEN_PROMPT,
                               enc_embeds=None, label: str = "full_gen",
                               tol: float = GEN_LOGIT_TOL, exact=None) -> None:
    """``dec`` (B, S+steps-1, V): the decode path's logits at every
    position.  Every logit is within ``tol`` (GEN_LOGIT_TOL) of
    ``lm_forward``'s, and every generated token whose top-2 margin in
    ``lm_forward`` exceeds GEN_TIE_MARGIN is its argmax (``first``,
    ``make_prefill``'s argmax, likewise for the first generated token).
    ``prompt``: the prompt's length; an encoder-decoder model takes
    ``enc_embeds``.  With ``exact`` (an f32 replay of the same tokens) both
    are held one-sided to that witness instead (``_check_witness``; the
    generated tokens are ``dec``'s argmax), and ``first`` to its argmax
    where its margin exceeds the widest at which lm_forward's flips plus
    GEN_TIE_MARGIN."""
    from repro_torch.models.transformer import lm_forward
    with torch.no_grad():
        fwd = lm_forward(params, cfg, out[:, :-1], enc_embeds=enc_embeds)[0]
    if exact is not None:
        held = _check_witness(label, dec, fwd, exact, ("replay", "lm_forward"))
        top = exact[:, prompt - 1].topk(2, dim=-1)
        margin = (top.values[:, 0] - top.values[:, 1]).cpu()
        if ((margin > held) & (first != top.indices[:, 0].cpu())).any():
            raise AssertionError(f"{label}: make_prefill's first tokens {first.tolist()} "
                                 f"differ from the witness's {top.indices[:, 0].tolist()} "
                                 f"at margins {margin.tolist()} > {held}")
        return
    with torch.no_grad():
        diff = (dec - fwd).abs()
        worst = diff.max().item()
        top = fwd[:, prompt - 1:].topk(2, dim=-1)
        at_top = diff[:, prompt - 1:].gather(-1, top.indices).max().item()
        margin = (top.values[..., 0] - top.values[..., 1]).cpu()
        best = top.indices[..., 0].cpu()
    del fwd, diff
    if not worst <= tol:
        raise AssertionError(f"{label}: decode-path logits differ from lm_forward's "
                             f"by {worst} > {tol}")
    gen = out[:, prompt:].cpu()
    near = margin <= GEN_TIE_MARGIN
    bad = (~near) & (best != gen)
    if bad.any():
        r, i = (int(t) for t in bad.nonzero()[0])
        raise AssertionError(f"{label} row {r} token {i}: generated {int(gen[r, i])}, "
                             f"lm_forward argmax {int(best[r, i])} margin "
                             f"{float(margin[r, i]):.4f} > {GEN_TIE_MARGIN}")
    wrong_first = (margin[:, 0] > GEN_TIE_MARGIN) & (first != gen[:, 0])
    if wrong_first.any():
        raise AssertionError(f"{label}: make_prefill's first tokens {first.tolist()} "
                             f"differ from the generated {gen[:, 0].tolist()}")
    log(f"[{label}] logits within {worst:.4f} of lm_forward's ({at_top:.4f} at its "
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


# ------------------------------------------------------- the MoE family
# deepseek-moe-16b at full width (28 layers, d 2048, 16 heads of 128, 64
# routed experts of 1408 top-6 and 2 shared, vocab 102400): greedy_generate
# of MOE_GEN_STEPS tokens after MOE_GEN_PROMPT at 4 rows, then
# ContinuousBatcher(slots=4, block 16, chunk 256) over MOE_PROMPTS (each
# longer than a chunk, so the fused chunk's expert matmuls take the tile
# path at MOE_CHUNK_CAP rows per expert), under q8_0 and q3_k weights.
MOE_LAYERS = 28
MOE_PRESETS = ("q8_0", "q3_k")
MOE_GEN_BATCH, MOE_GEN_PROMPT, MOE_GEN_STEPS = 4, 16, 8
MOE_PROMPTS = (600, 300, 520, 280, 350)
MOE_MAX_NEW = 8
# Kernel launches per forward of one MoE layer: under q8_0 every linear
# but the f32 router is Q8_0 (q, k, v, o; the three expert projections,
# one batched launch each; the shared MLP's up, gate and down); under q3_k
# the same but the expert down projection (K = 1408, 1408 % 256 != 0: a
# bf16 bmm); the head is Q8_0 under both.
MOE_LAYER_LAUNCHES = {"q8_0": {"q8_matmul": 10}, "q3_k": {"q3k_matmul": 9}}
MOE_EXPERT_LAUNCHES = {"q8_0": 3, "q3_k": 2}     # of those, batched expert launches


def _matmul_launches(tree) -> dict:
    """Kernel launches of one pass through ``tree``'s Linears: one per
    Linear whose weight is quantized (the expert projections' stacked
    weights included: one batched launch each), by kernel."""
    from repro_torch.core.qlinear import Linear
    from repro_torch.core.quant import Q3KTensor, Q4_0Tensor, Q8_0Tensor
    from repro_torch.core.tree import tree_leaves
    kernel = {Q8_0Tensor: "q8_matmul", Q3KTensor: "q3k_matmul", Q4_0Tensor: "q4_matmul"}
    out: dict[str, int] = {}
    for lin in tree_leaves(tree, is_leaf=lambda t: isinstance(t, Linear)):
        name = kernel.get(type(lin.w)) if isinstance(lin, Linear) else None
        if name:
            out[name] = out.get(name, 0) + 1
    return out


def _moe_want(params, layers: int, forwards: int, attention: dict) -> dict:
    """Launches of ``forwards`` forwards of an MoE stack, worked out from
    its weights: each layer's quantized linears (``_matmul_launches`` of
    layer 0) and the quantized head, plus ``attention`` (kernel name ->
    launches)."""
    from repro_torch.kernels import ops
    want = {name: 0 for name in ops.KERNEL_MODULES}
    head = params.get("lm_head") or params["embed"]
    for tree, n in ((params["layers"][0], layers * forwards), (head, forwards)):
        for name, k in _matmul_launches(tree).items():
            want[name] += k * n
    for name, n in attention.items():
        want[name] += n
    return want


def experts_plain_batched(x: torch.Tensor, w) -> torch.Tensor:
    """The batched entries' plain version in one batched product: every
    expert's weight dequantized to bf16 at once, an f32 product of the
    bf16 operands (the plain version's math, its f32 sums in another
    order), (E, M, N) f32."""
    from repro_torch.core import quant
    wd = quant.dequantize(w, torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16).float(), wd.float().transpose(1, 2))


class _CheckedExperts:
    """Hold every launch of a batched expert entry (``ops._experts_matmul``
    on the card) against its plain version on that call's own inputs,
    within MATMUL_RTOL of its largest magnitude.  The model goes on with
    the kernel's result, or with ``plain=True`` the plain version's (a
    plain replay).  The comparisons launch no kernel.  While ``active`` is
    unset, launches pass through unchecked and uncounted.  ``per_expert``
    takes the plain version expert by expert (``ops._experts_plain``: one
    expert's dequantized weight at a time, for experts too large to
    dequantize at once)."""

    def __init__(self, plain: bool = False, per_expert: bool = False):
        self.plain, self.per_expert = plain, per_expert

    def __enter__(self):
        from repro_torch.kernels import ops
        self.inner = ops._experts_matmul
        self.calls, self.err, self.excess, self.active = 0, None, None, True

        def checked(x, w):
            out = self.inner(x, w)
            if not self.active:
                return out
            want = (ops._experts_plain(x, w) if self.per_expert
                    else experts_plain_batched(x, w))
            diff = (out - want).abs().amax()
            excess = diff - MATMUL_RTOL * want.abs().amax().clamp_min(1.0)
            self.err = diff if self.err is None else torch.maximum(self.err, diff)
            self.excess = excess if self.excess is None else torch.maximum(
                self.excess, excess)
            self.calls += 1
            return want if self.plain else out
        ops._experts_matmul = checked
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops._experts_matmul = self.inner

    def check(self, label: str, calls: int) -> None:
        if self.calls != calls:
            raise AssertionError(f"{label}: {self.calls} batched expert calls, expected {calls}")
        if not self.excess.item() <= 0:
            raise AssertionError(f"{label}: a batched expert launch is {self.err.item()} "
                                 f"from its plain version, over MATMUL_RTOL by "
                                 f"{self.excess.item()}")
        log(f"[full_moe] {label}: {self.calls} batched expert launches held to their "
            f"plain version, max|err| {self.err.item():.3e}")


class _Routing:
    """Record each MoE layer's top-k expert ids per token in call order
    ((B, S, k), as ``moe.route`` gives them).  With ``pinned`` (such a
    record of another run) each call routes to the recorded experts
    instead, its gates its own probabilities of them renormalised: a
    replay that differs from the recorded one only in its numerics."""

    def __init__(self, pinned: list | None = None):
        self.pinned = pinned

    def __enter__(self):
        from repro_torch.models import moe
        self.inner, self.sets, self.own = moe.route, [], []

        def routed(p, cfg, x):
            probs, gate, idx = self.inner(p, cfg, x)
            self.own.append(idx)
            if self.pinned is not None:
                idx = self.pinned[len(self.sets)]
                gate = probs.gather(-1, idx)
                gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
            self.sets.append(idx)
            return probs, gate, idx
        moe.route = routed
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.inner


def _moe_routing_differs(a: list, b: list, layers: int) -> torch.Tensor:
    """(B, steps, layers) bool: where a step-by-step replay's expert set
    differs between routings ``a`` and ``b`` (``layers`` calls per step)."""
    diff = [(x.sort(-1).values != y.sort(-1).values).any(-1).any(-1)
            for x, y in zip(a, b)]                                       # (B,) per call
    return torch.stack(diff).reshape(-1, layers, diff[0].shape[0]).permute(2, 0, 1).cpu()


def _check_moe_against_plain(label: str, out, dec, plain, routed) -> None:
    """The kernel replay ``dec`` against the plain replay ``plain`` that
    was pinned to its routing: every logit within GEN_LOGIT_TOL and the
    same argmax wherever the plain replay's top-2 margin exceeds
    GEN_TIE_MARGIN, at every position.  ``routed`` (B, steps, layers)
    marks where the plain replay's own router would have picked another
    expert set (reported: left to itself, one swapped expert moves the
    logits by more than any rounding)."""
    diff = (dec - plain).abs()
    worst = diff.max().item()
    top = plain.topk(2, dim=-1)
    margin = (top.values[..., 0] - top.values[..., 1]).cpu()
    flips = (dec.argmax(-1) != plain.argmax(-1)).cpu()
    same = dec.argmax(-1)[:, MOE_GEN_PROMPT - 1:].to(out.dtype) == out[:, MOE_GEN_PROMPT:]
    moved = routed.any(-1)
    log(f"[full_moe] {label}: kernel replay vs the plain replay on its routing: logits "
        f"within {worst:.4f} ({100 * (diff == 0).float().mean().item():.3f}% bit-equal); "
        f"{int(flips.sum())} of {flips.numel()} argmax differ (margins "
        f"{[round(float(m), 4) for m in margin[flips]]}); left to itself the plain "
        f"replay's router would pick another expert set in {int(routed.sum())} of "
        f"{routed.numel()} (row, position, layer) triples, at {int(moved.sum())} of "
        f"{moved.numel()} positions; {int((margin <= GEN_TIE_MARGIN).sum())} near-ties "
        f"(margin <= {GEN_TIE_MARGIN}) not compared")
    if not worst <= GEN_LOGIT_TOL or (flips & (margin > GEN_TIE_MARGIN)).any():
        raise AssertionError(f"{label}: the kernel replay's logits differ from the plain "
                             f"replay's by {worst} (limit {GEN_LOGIT_TOL}), or its argmax "
                             f"where the margin exceeds {GEN_TIE_MARGIN}")
    if not same.all():
        raise AssertionError(f"{label}: the make_decode replay does not reproduce "
                             "greedy_generate's tokens")


def _tiny_moe() -> None:
    """reduced(deepseek-moe-16b) at d_model 256 (so Q3_K takes the expert
    up and gate) with the same seeded weights on the card (kernels) and
    on the CPU (plain versions): one MoE layer on the same bf16 input
    routes every token alike and gives outputs within 0.01 + 1% (about
    two bf16 ulps); ``lm_forward`` launches exactly what its weights say,
    and with the CPU run pinned to the card's routing its logits are
    within 0.05 + 2% of the CPU's at every position (where the CPU's own
    router would have picked another expert set is counted)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import quantize_params
    from repro_torch.core.tree import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_lm, lm_forward
    cfg = reduced(get_config("deepseek-moe-16b"), d_model=256)
    base = init_lm(torch.Generator().manual_seed(SEED), cfg)
    gen = torch.Generator().manual_seed(SEED + 31)
    toks = torch.randint(1, cfg.vocab_size, (2, 40), generator=gen)
    x = torch.randn((2, 40, cfg.d_model), generator=gen).to(torch.bfloat16)
    for preset in MOE_PRESETS:
        params = quantize_params(base, get_policy(preset))
        ys = {}
        for dev in ("cuda", "cpu"):
            with _Routing() as routing, torch.no_grad():
                y, _ = moe.apply_moe(to_device(params["layers"][0]["moe"], dev), cfg, x.to(dev))
            ys[dev] = (y.float().cpu(), routing.sets[0].cpu().sort(-1).values)
        if not torch.equal(ys["cpu"][1], ys["cuda"][1]):
            raise AssertionError(f"tiny_moe {preset}: one MoE layer routes the same input "
                                 "differently on the CPU and the card")
        ydiff = (ys["cuda"][0] - ys["cpu"][0]).abs()
        if not (ydiff <= 0.01 + 0.01 * ys["cpu"][0].abs()).all():
            raise AssertionError(f"tiny_moe {preset}: MoE layer outputs differ by "
                                 f"{ydiff.max().item()}")
        ops.reset_launch_counts()
        with _Routing() as card, torch.no_grad():
            logits, aux = lm_forward(to_device(params, "cuda"), cfg, toks.cuda())
        counts = ops.launch_counts()
        with _Routing(pinned=[t.cpu() for t in card.sets]) as cpu, torch.no_grad():
            want, want_aux = lm_forward(params, cfg, toks)
        expect = _moe_want(params, cfg.num_layers, 1, {"flash_attention": cfg.num_layers})
        if counts != expect:
            raise AssertionError(f"tiny_moe {preset}: launches {counts}, expected {expect}")
        diff = (logits.cpu() - want).abs()
        if not ((diff <= 0.05 + 0.02 * want.abs()).all() and torch.isfinite(logits).all()):
            raise AssertionError(f"tiny_moe {preset}: lm_forward logits differ from the "
                                 f"CPU's by {diff.max().item()}")
        moved = sum(int((a.cpu().sort(-1).values != b.sort(-1).values).any(-1).sum())
                    for a, b in zip(card.sets, cpu.own))
        log(f"[tiny_moe] weights={preset}: one MoE layer within {ydiff.max().item():.4f} "
            f"of the CPU's, same routing; lm_forward logits within {diff.max().item():.4f} "
            f"of the CPU's on the card's routing (the CPU's own router differs at {moved} "
            f"of {2 * 40 * cfg.num_layers} (row, position, layer) triples); aux "
            f"{aux.item():.6f} (CPU {want_aux.item():.6f}); launches {counts}")


def _moe_gen(card: str, cfg, params, preset: str) -> dict:
    """``greedy_generate`` at full width (counted), its replay through
    ``make_decode`` with the kernels and with the plain batched expert
    version (held to each other per call), and ``make_prefill``."""
    from repro_torch.kernels import ops
    from repro_torch.train.serve_step import greedy_generate
    prompts = torch.randint(1, cfg.vocab_size, (MOE_GEN_BATCH, MOE_GEN_PROMPT),
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 33),
                            device="cuda")
    steps = MOE_GEN_PROMPT + MOE_GEN_STEPS - 1
    max_len = MOE_GEN_PROMPT + MOE_GEN_STEPS
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompts, MOE_GEN_STEPS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = _moe_want(params, cfg.num_layers, steps, {"flash_decode": cfg.num_layers * steps})
    if counts != want:
        raise AssertionError(f"full_moe {preset} greedy_generate: launches {counts}, "
                             f"expected {want}")
    if out.shape != (MOE_GEN_BATCH, max_len) \
            or not torch.equal(out[:, :MOE_GEN_PROMPT], prompts.to(out.dtype)) \
            or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"full_moe {preset}: output {tuple(out.shape)} is not the "
                             "prompts followed by vocabulary tokens")
    with _Routing() as kroute:
        dec, times, _ = _replay(params, cfg, out, steps, max_len)
    with _Routing(pinned=kroute.sets) as proute, _CheckedExperts(plain=True) as oracle:
        plain = _replay(params, cfg, out, steps, max_len)[0]
    oracle.check(f"weights={preset} plain replay",
                 MOE_EXPERT_LAUNCHES[preset] * cfg.num_layers * steps)
    if not torch.isfinite(dec).all():
        raise AssertionError(f"full_moe {preset}: non-finite logits")
    routed = _moe_routing_differs(kroute.sets, proute.own, cfg.num_layers)
    _check_moe_against_plain(f"weights={preset}", out, dec, plain, routed)
    step_ms = 1e3 * sum(times[2:]) / (steps - 2)
    log(f"[full_moe] weights={preset} greedy_generate: {steps} decode steps of "
        f"{MOE_GEN_BATCH} rows in {wall:.2f} s ({1e3 * wall / steps:.2f} ms per step "
        f"unsynchronised); {step_ms:.2f} ms per synchronised decode step; launches "
        f"{counts}; {card}")
    del dec, plain
    return counts


def _moe_serve(card: str, cfg, params, preset: str) -> dict:
    """``ContinuousBatcher`` over MOE_PROMPTS, every batched expert launch
    held to its plain version on its own inputs; events, exact launches,
    then a profile of one decode quantum and one prefill chunk."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ContinuousBatcher, Request
    max_len = ContinuousBatcher.required_len(len(MOE_PROMPTS), 4, max(MOE_PROMPTS),
                                             MOE_MAX_NEW)
    cb = ContinuousBatcher(params, cfg, slots=4, max_len=max_len, block_size=16,
                           prefill_chunk=256)
    reqs = _lm_requests(Request, MOE_PROMPTS, cfg.vocab_size, MOE_MAX_NEW, 0,
                        torch.Generator(device="cuda").manual_seed(SEED + 35))
    for r in reqs:
        cb.submit(r)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with _CheckedExperts() as oracle:
        cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    label = f"full_moe weights={preset} serve"
    _check_events(label, cb, len(reqs))
    fwd = cb.prefill_launches + cb.decode_launches
    oracle.check(f"weights={preset} serve", MOE_EXPERT_LAUNCHES[preset] * cfg.num_layers * fwd)
    want = _moe_want(params, cfg.num_layers, fwd, {
        "flash_prefill_paged": cfg.num_layers * cb.prefill_launches,
        "flash_decode_paged": cfg.num_layers * cb.decode_launches})
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    outs = [t for r in cb.finished for t in r.out]
    if len(outs) != len(reqs) * MOE_MAX_NEW or not all(0 <= t < cfg.vocab_size for t in outs):
        raise AssertionError(f"{label}: {len(outs)} tokens, not {MOE_MAX_NEW} vocabulary "
                             "tokens per request")
    log(f"[full_moe] weights={preset} serve: {len(outs)} tokens for {len(reqs)} requests "
        f"in {wall:.2f} s with every expert launch checked; quanta {cb.prefill_quanta} "
        f"prefill / {cb.decode_quanta} decode; launches {counts}; {card}")
    _profile_lm(cb, f"deepseek-moe-16b weights={preset}")
    del cb
    return counts


def phase_full_moe(card: str) -> dict[str, int]:
    """deepseek-moe-16b at full width with seeded synthetic weights made on
    the card, under q8_0 and q3_k: greedy_generate with its replays, then
    ContinuousBatcher; each quantized copy is freed before the next."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import param_bytes, param_count, quantize_params
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    _tiny_moe()
    cfg = get_config("deepseek-moe-16b")
    assert cfg.num_layers == MOE_LAYERS and cfg.moe.num_experts == 64
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    log(f"[full_moe] init deepseek-moe-16b {time.perf_counter() - t0:.1f} s, "
        f"{param_count(base) / 1e9:.2f} B parameters, {param_bytes(base) / 2**30:.2f} GiB")
    totals = {name: 0 for name in ops.KERNEL_MODULES}
    for preset in MOE_PRESETS:
        t0 = time.perf_counter()
        params = quantize_params(base, get_policy(preset))
        torch.cuda.synchronize()
        layer = params["layers"][0]["moe"]
        if (_matmul_launches(params["layers"][0]) != MOE_LAYER_LAUNCHES[preset]
                or sum(_matmul_launches([layer[k] for k in ("w_up", "w_gate", "w_down")])
                       .values()) != MOE_EXPERT_LAUNCHES[preset]):
            raise AssertionError(f"full_moe {preset}: layer 0 takes kernels "
                                 f"{_matmul_launches(params['layers'][0])}, expected "
                                 f"{MOE_LAYER_LAUNCHES[preset]}")
        log(f"[full_moe] weights={preset}: quantized in {time.perf_counter() - t0:.1f} s, "
            f"{param_bytes(params) / 2**30:.2f} GiB; expert weights "
            + ", ".join(f"{k} {type(layer[k].w).__name__}" for k in ("w_up", "w_gate", "w_down")))
        torch.cuda.reset_peak_memory_stats()
        for counts in (_moe_gen(card, cfg, params, preset), _moe_serve(card, cfg, params, preset)):
            for name, n in counts.items():
                totals[name] += n
        log(f"[full_moe] weights={preset}: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del params, layer
        gc.collect()
        torch.cuda.empty_cache()
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ----------------------------------------------------- whisper-large-v3
# phase full_asr: whisper-large-v3 at full width and depth through the
# streaming AsrEngine: 5 requests of ASR_PROMPT prompt tokens and ASR_NEW
# new ones, the fifth with the first one's audio; audio_chunk 500 is this
# traffic's choice (3 encode quanta per request; the engine's default is
# 16, 94 quanta of a whole encoder pass each).
ASR_LAYERS = 32
ASR_PRESETS = ("q8_0", "none")
ASR_PROMPT, ASR_NEW, ASR_REQUESTS = 4, 32, 5
ASR_KW = dict(slots=4, max_len=ASR_PROMPT + ASR_NEW - 1, block_size=16,
              cross_block_size=16, audio_chunk=500, prefill_chunk=ASR_PROMPT)
ASR_GEN_BATCH, ASR_GEN_NEW = 2, 16
ASR_CALIB_NEW = 4


def _asr_inputs(cfg) -> tuple[list, list]:
    """ASR_REQUESTS audios of (encoder_seq, d_model) bf16 made on the card
    from seeds and a prompt of ASR_PROMPT tokens per request; the last
    request repeats the first one's audio (the same tensor) and prompt."""
    from repro_torch.models.frontend import synthetic_audio
    audios = [synthetic_audio(torch.Generator(device="cuda").manual_seed(SEED + 40 + i), cfg)
              for i in range(ASR_REQUESTS - 1)]
    prompts = torch.randint(1, cfg.vocab_size, (ASR_REQUESTS - 1, ASR_PROMPT),
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 45),
                            device="cuda").tolist()
    return audios + audios[:1], prompts + prompts[:1]


def _asr_requests(audios, prompts, max_new: int = ASR_NEW, rid0: int = 0, **kw) -> list:
    from repro_torch.engine import TranscribeRequest
    return [TranscribeRequest(rid=rid0 + i, audio=a, prompt=p, max_new=max_new, **kw)
            for i, (a, p) in enumerate(zip(audios, prompts))]


def _asr_want(params, cfg, encodes: int, chunks: int, steps: int,
              contiguous: bool = False) -> dict:
    """Launches of an encoder-decoder path, worked out from the code and
    the weights.  Per encode (an encode quantum, or ``make_cache``'s
    encoder pass): one flash_attention and the quantized linears of each
    encoder layer, and each decoder layer's cross wk and wv (its cross
    K/V).  Per fused prompt chunk and per decode step: one paged prefill
    or decode launch per decoder layer (``contiguous``: flash_decode), the
    quantized linears of each decoder layer but its cross wk and wv (cross
    attention itself is plain PyTorch, as the reference's einsums), and
    the head."""
    from repro_torch.kernels import ops
    want = {name: 0 for name in ops.KERNEL_MODULES}
    layer = params["layers"][0]
    kv = _matmul_launches([layer["cross"]["wk"], layer["cross"]["wv"]])
    dec = _matmul_launches(layer)
    enc = _matmul_launches(params["encoder"]["layers"][0])
    head = _matmul_launches(params["lm_head"])
    nl, ne = cfg.num_layers, cfg.encoder_layers
    for name in set(dec) | set(enc) | set(head):
        want[name] += (enc.get(name, 0) * ne + kv.get(name, 0) * nl) * encodes
        want[name] += ((dec.get(name, 0) - kv.get(name, 0)) * nl
                       + head.get(name, 0)) * (chunks + steps)
    want["flash_attention"] += ne * encodes
    want["flash_prefill_paged"] += nl * chunks
    want["flash_decode" if contiguous else "flash_decode_paged"] += nl * steps
    return want


def _asr_prefill_want(params, cfg) -> dict:
    """Launches of one ``make_prefill`` call (``lm_forward``, head on the
    last position): the encoder as in ``_asr_want``, then per decoder
    layer two flash_attention (self and cross) and all its quantized
    linears, and the head."""
    from repro_torch.kernels import ops
    want = {name: 0 for name in ops.KERNEL_MODULES}
    nl, ne = cfg.num_layers, cfg.encoder_layers
    for tree, n in ((params["encoder"]["layers"][0], ne), (params["layers"][0], nl),
                    (params["lm_head"], 1)):
        for name, k in _matmul_launches(tree).items():
            want[name] += k * n
    want["flash_attention"] = ne + 2 * nl
    return want


def _asr_replay(params, cfg, reqs, audios):
    """The engine's model path for every request at once, with its logits:
    a one-shot encode of each request's audio into a paged cross pool (a
    slot per request), its prompt as one fused chunk, then paged decode
    steps of all rows fed its transcript.  -> logits (R, ASR_NEW, V) f32 at
    the positions that chose each transcript token."""
    from repro_torch.models.transformer import (encoder_forward, init_cache,
                                                lm_decode_step, lm_prefill_chunk,
                                                write_cross_kv)
    r, bs = len(reqs), ASR_KW["block_size"]
    mb, cmb = -(-ASR_KW["max_len"] // bs), -(-cfg.encoder_seq // bs)
    cache = init_cache(params, cfg, r, ASR_KW["max_len"], block_size=bs,
                       num_blocks=r * mb + 1, cross_block_size=bs,
                       cross_num_blocks=r * cmb + 1, device="cuda")
    tables = (torch.arange(r * mb, dtype=torch.int32, device="cuda") + 1).reshape(r, mb)
    ctables = (torch.arange(r * cmb, dtype=torch.int32, device="cuda") + 1).reshape(r, cmb)
    out = []
    with torch.no_grad():
        for i, a in enumerate(audios):
            write_cross_kv(params, cfg, encoder_forward(params, cfg, a[None]), ctables[i],
                           cache)
        first = [lm_prefill_chunk(params, cfg, torch.tensor([q.prompt], device="cuda"), 0,
                                  cache, block_tables=tables[i:i + 1],
                                  cross_tables=ctables[i:i + 1])[0][0, -1]
                 for i, q in enumerate(reqs)]
        out.append(torch.stack(first))
        toks = torch.tensor([q.out for q in reqs], device="cuda")
        for t in range(ASR_NEW - 1):
            pos = torch.full((r,), ASR_PROMPT + t, dtype=torch.int32, device="cuda")
            lg, _ = lm_decode_step(params, cfg, toks[:, t:t + 1], pos, cache,
                                   block_tables=tables, cross_tables=ctables)
            out.append(lg[:, 0])
    del cache
    return torch.stack(out, dim=1)


def _check_asr_tokens(label: str, params, cfg, reqs, audios, dec) -> None:
    """The served transcripts against ``lm_forward(enc_embeds=...)`` on the
    card and against the replay ``dec`` (R, ASR_NEW, V): every replay logit
    within GEN_LOGIT_TOL of lm_forward's; every served token whose top-2
    margin exceeds GEN_TIE_MARGIN, in lm_forward and in the replay, is
    their argmax."""
    from repro_torch.models.transformer import lm_forward
    served = torch.tensor([r.out for r in reqs])
    with torch.no_grad():
        seq = torch.tensor([r.prompt + r.out[:-1] for r in reqs], device="cuda")
        fwd = lm_forward(params, cfg, seq, enc_embeds=torch.stack(audios))[0][:, ASR_PROMPT - 1:]
    worst = (dec - fwd).abs().max().item()
    if not (worst <= GEN_LOGIT_TOL and torch.isfinite(dec).all()):
        raise AssertionError(f"{label}: replay logits differ from lm_forward's by {worst} "
                             f"> {GEN_LOGIT_TOL}")
    near = {}
    for name, lg in (("lm_forward", fwd), ("replay", dec)):
        top = lg.topk(2, dim=-1)
        margin = (top.values[..., 0] - top.values[..., 1]).cpu()
        bad = (margin > GEN_TIE_MARGIN) & (top.indices[..., 0].cpu() != served)
        if bad.any():
            r, i = (int(t) for t in bad.nonzero()[0])
            raise AssertionError(f"{label} rid {reqs[r].rid} token {i}: served "
                                 f"{int(served[r, i])}, {name} argmax "
                                 f"{int(top.indices[r, i, 0])} margin {float(margin[r, i]):.4f}")
        near[name] = int((margin <= GEN_TIE_MARGIN).sum())
    log(f"[full_asr] {label}: replay logits within {worst:.4f} of lm_forward's; "
        f"{served.numel()} served tokens equal both argmaxes above {GEN_TIE_MARGIN} "
        f"(near-ties not compared: lm_forward {near['lm_forward']}, replay {near['replay']})")


def _cross_bits(cache, blocks) -> list:
    return [(_bits(c.cross_k[blocks]).clone(), _bits(c.cross_v[blocks]).clone())
            for c in cache]


def _asr_profile(eng, label: str, audio) -> None:
    """torch.profiler over one encode quantum (the last 500 frames of a
    slot's row, written to free cross blocks), one 4-token prompt chunk and
    one 4-slot decode step at the table's end, on scratch blocks."""
    rt = eng.runtime
    cmb, mb, bs = rt.cross_blocks_per_slot, rt.blocks_per_slot, rt.block_size
    free = torch.tensor(rt.free_cross_block_ids()[:4 * cmb], dtype=torch.int32,
                        device="cuda").reshape(4, cmb)
    tables = (torch.arange(4 * mb, dtype=torch.int32, device="cuda")
              % (rt.num_blocks - 1) + 1).reshape(4, mb)
    frames = audio[None, -ASR_KW["audio_chunk"]:]
    f0 = audio.shape[0] - frames.shape[1]
    toks = torch.ones((4, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((4,), ASR_KW["max_len"] - 1, dtype=torch.int32, device="cuda")
    chunk = torch.ones((1, ASR_PROMPT), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        _profile(f"{label} encode quantum", lambda: eng._encode_fn(
            eng.params, frames, f0, 0, free[0], eng._frame_buf, eng.cache))
        _profile(f"{label} prefill chunk", lambda: eng._prefill_raw(
            eng.params, chunk, torch.full((1,), 0, dtype=torch.int32), 0, tables[:1],
            free[:1], eng.cache))
        _profile(f"{label} decode step", lambda: eng.step_fn(
            eng.params, toks, pos, tables, free, eng.cache))


def _asr_serve(card: str, cfg, params, preset: str, audios, prompts) -> tuple[dict, dict]:
    """The AsrEngine over the 5 requests, each quantum synchronised and
    timed; its gates (chunked = one-shot, audio sharing, events, pools,
    launches, tokens against lm_forward and against a plain replay).
    Returns (launches, transcripts)."""
    from repro_torch.engine import AsrEngine
    from repro_torch.engine import events as ev
    from repro_torch.kernels import ops
    label = f"weights={preset}"
    eng = AsrEngine(params, cfg, device="cuda", **ASR_KW)
    reqs = _asr_requests(audios, prompts)
    for r in reqs:
        eng.submit(r)
    encodes_per_request = -(-cfg.encoder_seq // ASR_KW["audio_chunk"])
    times: dict[str, list] = {"encode": [], "prefill": [], "decode": []}
    snap = None
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        while eng.has_work():
            s0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            times[eng.last_quantum[0]].append(time.perf_counter() - s0)
            if snap is None and eng.encode_quanta == encodes_per_request:
                snap = _cross_bits(eng.cache, eng.runtime.cross_tables[0])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = _asr_want(params, cfg, eng.encode_quanta, eng.prefill_launches, eng.decode_quanta)
    if counts != want:
        raise AssertionError(f"full_asr {label}: launches {counts}, expected {want}")
    # Events, pools, audio sharing.
    _check_events(f"full_asr {label}", eng, ASR_REQUESTS)
    outs = {r.rid: list(r.out) for r in eng.finished}
    for r in reqs:
        evs = [e for e in eng.bus.log if e.rid == r.rid]
        steps = [e.step for e in evs if isinstance(e, ev.Progress) and e.phase == "encode"]
        chunk = ASR_KW["audio_chunk"]
        want_steps = ([] if r.rid == ASR_REQUESTS - 1 else
                      [min(f, cfg.encoder_seq) for f in range(chunk, cfg.encoder_seq + chunk,
                                                              chunk)])
        toks = [e.token for e in evs if isinstance(e, ev.TokenDelta)]
        if steps != want_steps or toks != outs[r.rid] or len(toks) != ASR_NEW \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"full_asr {label} rid {r.rid}: encode progress {steps}, "
                                 f"{len(toks)} tokens {toks}")
    rt = eng.runtime
    chains = (ASR_REQUESTS - 1) * rt.cross_blocks_per_slot
    if rt.allocated_cross_blocks != len(rt.cross_prefix) or len(rt.cross_prefix) != chains:
        raise AssertionError(f"full_asr {label}: {rt.allocated_cross_blocks} cross blocks "
                             f"held, {len(rt.cross_prefix)} in the audio cache, expected "
                             f"{chains} (the published chains)")
    if (eng.audio_hits, eng.encode_quanta) != (1, (ASR_REQUESTS - 1) * encodes_per_request) \
            or reqs[-1].encode_steps or outs[ASR_REQUESTS - 1] != outs[0]:
        raise AssertionError(f"full_asr {label}: audio hits {eng.audio_hits}, encode quanta "
                             f"{eng.encode_quanta}; rid 4 {outs[ASR_REQUESTS - 1]} vs rid 0 "
                             f"{outs[0]}")
    # Chunked = one-shot: request 0's cross blocks after its last quantum
    # against one encode quantum of all 1500 frames.
    one = AsrEngine(params, cfg, device="cuda", **dict(
        ASR_KW, slots=1, audio_chunk=cfg.encoder_seq, audio_share=False))
    one.submit(_asr_requests(audios[:1], prompts[:1])[0])
    with torch.no_grad():
        one.step()
    torch.cuda.synchronize()
    whole = _cross_bits(one.cache, one.runtime.cross_tables[0])
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(snap, whole))
    del one, whole, snap
    if not same:
        raise AssertionError(f"full_asr {label}: request 0's cross blocks after its "
                             f"{encodes_per_request} encode quanta differ from a one-shot "
                             "encode's bits")
    mean = {k: 1e3 * sum(v[1:]) / max(1, len(v) - 1) for k, v in times.items()}
    log(f"[full_asr] {label}: {ASR_REQUESTS} requests, {sum(map(len, outs.values()))} "
        f"tokens in {wall:.2f} s synchronised per quantum; quanta {eng.encode_quanta} "
        f"encode / {eng.prefill_quanta} prefill / {eng.decode_quanta} decode; ms per "
        f"encode quantum {mean['encode']:.2f}, prefill chunk {mean['prefill']:.2f}, "
        f"4-slot decode step {mean['decode']:.2f} (first of each left out); audio hits "
        f"{eng.audio_hits}; chunked = one-shot cross bits; launches {counts}; {card}")
    _asr_profile(eng, f"whisper-large-v3 {label}", audios[0])
    # Tokens: a replay with its logits, against lm_forward and the plain
    # paged decode (held to the kernel at every call).
    done = sorted(eng.finished, key=lambda r: r.rid)
    dec = _asr_replay(params, cfg, done, audios)
    _check_asr_tokens(label, params, cfg, done, audios, dec)
    with _PlainDecodeAttention(paged=True, few_keys=True) as oracle:
        plain = _asr_replay(params, cfg, done, audios)
    if oracle.calls != cfg.num_layers * (ASR_NEW - 1):
        raise AssertionError(f"full_asr {label}: {oracle.calls} plain decode reads, "
                             f"expected {cfg.num_layers * (ASR_NEW - 1)}")
    _check_gen_against_plain(preset, dec, plain, oracle, label="full_asr")
    del eng, dec, plain
    return counts, outs


def _asr_gen(card: str, cfg, params, audios, prompts) -> dict:
    """``greedy_generate(enc_embeds=...)`` of ASR_GEN_NEW tokens at 2 rows
    on contiguous self and cross rows (exact launches), ``make_prefill``,
    and the replay's logits against lm_forward and against a plain replay
    whose every flash_decode call is held to its plain version."""
    from repro_torch.kernels import ops
    from repro_torch.train.serve_step import greedy_generate, make_prefill
    enc = torch.stack(audios[:ASR_GEN_BATCH])
    prompt = torch.tensor(prompts[:ASR_GEN_BATCH], device="cuda")
    steps = ASR_PROMPT + ASR_GEN_NEW - 1
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, ASR_GEN_NEW, enc_embeds=enc, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = _asr_want(params, cfg, 1, 0, steps, contiguous=True)
    if counts != want:
        raise AssertionError(f"full_asr greedy_generate: launches {counts}, expected {want}")
    ops.reset_launch_counts()
    with torch.no_grad():
        first = make_prefill(cfg)(params, {"tokens": prompt, "enc_embeds": enc}).argmax(-1).cpu()
    pre = ops.launch_counts()
    if pre != _asr_prefill_want(params, cfg):
        raise AssertionError(f"full_asr make_prefill: launches {pre}, expected "
                             f"{_asr_prefill_want(params, cfg)}")
    dec, times, _ = _replay(params, cfg, out, steps, ASR_PROMPT + ASR_GEN_NEW, enc_embeds=enc)
    if not torch.equal(dec[:, ASR_PROMPT - 1:].argmax(-1).to(out.dtype), out[:, ASR_PROMPT:]):
        raise AssertionError("full_asr greedy_generate: the make_decode replay does not "
                             "reproduce its tokens")
    _check_gen_against_forward(params, cfg, out, dec, first, prompt=ASR_PROMPT,
                               enc_embeds=enc, label="full_asr greedy_generate")
    # Every flash_decode call of a plain replay held to its plain version
    # (every row of at most FEW_KEYS keys), and the replays' logits.
    with _PlainDecodeAttention(few_keys=True) as oracle:
        plain = _replay(params, cfg, out, steps, ASR_PROMPT + ASR_GEN_NEW,
                        enc_embeds=enc)[0]
    if oracle.calls != cfg.num_layers * steps:
        raise AssertionError(f"full_asr greedy_generate: {oracle.calls} plain decode "
                             f"reads, expected {cfg.num_layers * steps}")
    _check_gen_against_plain("q8_0", dec, plain, oracle, label="full_asr greedy_generate")
    del plain
    log(f"[full_asr] greedy_generate: {steps} decode steps of {ASR_GEN_BATCH} rows in "
        f"{wall:.2f} s; {1e3 * sum(times[2:]) / (steps - 2):.2f} ms per synchronised "
        f"decode step; launches {counts}; make_prefill {pre}; {card}")
    return {name: counts[name] + pre[name] for name in counts}


def _asr_router(card: str, cfg, params, audios, prompts, bare: dict) -> dict:
    """An ``EngineRouter`` with only ``asr=`` and a calibrated
    ``CostModel``: a request with a SERVE_HOPELESS_MS budget ends Rejected
    at submit, one without a deadline finishes with the bare engine's
    transcript of the same audio and prompt."""
    from repro_torch.engine import (AsrEngine, AsrEngineConfig, CostModel, EngineConfig,
                                    EngineRouter, calibrate)
    from repro_torch.engine import events as ev
    from repro_torch.kernels import ops
    cm = CostModel()
    asr = AsrEngine(params, cfg, device="cuda", config=EngineConfig(
        cost_model=cm, asr=AsrEngineConfig(**ASR_KW)))
    router = EngineRouter(asr=asr)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    calibrate(router, _asr_requests(audios[1:3], prompts[1:3], ASR_CALIB_NEW, rid0=-10))
    calib_s = time.perf_counter() - t0
    costs = [cm.cost(key) for key in cm.asr_keys(asr)]
    if None in costs:
        raise AssertionError(f"full_asr router: calibration left a key unpriced: {costs}")
    hopeless, served = _asr_requests(audios[:1] * 2, prompts[:1] * 2, rid0=100)
    hopeless.deadline_ms = SERVE_HOPELESS_MS
    router.submit(hopeless)
    if not isinstance(router.bus.terminal(100), ev.Rejected):
        raise AssertionError("full_asr router: the 1 ms request was not rejected at submit")
    router.submit(served)
    router.run()
    counts = ops.launch_counts()
    want = _asr_want(params, cfg, asr.encode_quanta, asr.prefill_launches, asr.decode_quanta)
    kinds = [type(e).__name__ for e in router.bus.log if e.rid == 101]
    if counts != want or served.out != bare[0] or kinds.count("Finished") != 1 \
            or kinds.count("Admitted") != 1:
        raise AssertionError(f"full_asr router: launches {counts} (expected {want}); "
                             f"transcript {served.out} vs the bare run's {bare[0]}; {kinds}")
    log(f"[full_asr] router: calibration of 2 requests ({ASR_CALIB_NEW} new) {calib_s:.2f} s; "
        f"cost model encode {1e3 * costs[0]:.2f} ms, prefill {1e3 * costs[1]:.2f} ms, decode "
        f"{1e3 * costs[2]:.2f} ms; rid 100 ({SERVE_HOPELESS_MS} ms) rejected at submit, "
        f"estimated {router.bus.terminal(100).estimated_s * 1e3:.1f} ms; rid 101 has the bare "
        f"run's transcript; launches {counts}; {card}")
    del asr, router
    return counts


def phase_full_asr(card: str) -> dict[str, int]:
    """whisper-large-v3 at full width and depth with seeded weights made on
    the card, under q8_0 and none (the quantized copy freed before the
    next): the AsrEngine run with its gates; under q8_0 also
    greedy_generate and the router."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import param_bytes, param_count, quantize_params
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    cfg = get_config("whisper-large-v3")
    assert cfg.num_layers == cfg.encoder_layers == ASR_LAYERS
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    base = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    audios, prompts = _asr_inputs(cfg)
    torch.cuda.synchronize()
    log(f"[full_asr] init whisper-large-v3 {time.perf_counter() - t_phase:.1f} s, "
        f"{param_count(base) / 1e9:.3f} B parameters, {param_bytes(base) / 2**30:.2f} GiB")
    totals = {name: 0 for name in ops.KERNEL_MODULES}

    def add(counts):
        for name, n in counts.items():
            totals[name] += n

    for preset in ASR_PRESETS:
        params = base if preset == "none" else quantize_params(base, get_policy(preset))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts, outs = _asr_serve(card, cfg, params, preset, audios, prompts)
        add(counts)
        if preset == "q8_0":
            add(_asr_gen(card, cfg, params, audios, prompts))
            add(_asr_router(card, cfg, params, audios, prompts, outs))
        log(f"[full_asr] weights={preset}: {param_bytes(params) / 2**30:.2f} GiB of weights; "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    del base
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[full_asr] phase {time.perf_counter() - t_phase:.1f} s; {card}")
    return totals


# ------------------------------------------------- recurrent and hybrid
# phase tiny_ssm: reduced(xlstm-1.3b) under q8_0 and reduced(jamba-1.5-
# large) under q3_k (each arch's default) on the CPU and the card:
# greedy_generate of TINY_SSM_STEPS tokens after TINY_SSM_PROMPT at 2 rows,
# and 4 served requests of TINY_SSM_NEW tokens.  Prompt draws (seeds
# 0-59) whose every generated token has a top-2 logit margin of at least
# 0.078 on the CPU (ten bf16 ulps at |logit| in [1, 2)), so rounding cannot
# flip a token.
TINY_SSM_RUNS = (  # (arch, greedy_generate's prompt seed, the served prompts' seed)
    ("xlstm-1.3b", 46, 21), ("jamba-1.5-large-398b", 9, 46))
TINY_SSM_PROMPT, TINY_SSM_STEPS = 16, 6
TINY_SSM_PROMPTS, TINY_SSM_NEW = (21, 9, 14, 17), 4
# phase full_ssm: xlstm-1.3b at full size under q8_0 and none, then
# jamba-1.5-large at full width and one period of its 72 layers under
# q3_k (the depth cut: 44.2 B parameters in the period, about 19 GB in
# Q3_K; nine periods would need about 171 GB).
XLSTM_PRESETS = ("q8_0", "none")
XLSTM_GEN_BATCH, XLSTM_GEN_PROMPT, XLSTM_GEN_STEPS = 4, 32, 16
XLSTM_PROMPTS, XLSTM_NEW = (24, 64, 40, 31, 52, 45), 16
XLSTM_KW = dict(slots=4, block_size=16, prefill_chunk=16)
JAMBA_PERIODS = 1
JAMBA_GEN_BATCH, JAMBA_GEN_PROMPT, JAMBA_GEN_STEPS = 2, 32, 8
JAMBA_PROMPTS, JAMBA_NEW = (24, 48, 37, 30, 41), 8
# Whole-model comparisons of two paths of a recurrent stack at full width
# with random weights: two roundings of the same xLSTM decode path
# (q8_matmul's kernel and its plain version) differ by up to 1.075 in a
# logit and flip its argmax at top-2 margins up to 0.344, because a bf16
# ulp of each of 48 layers' outputs adds up in the residual stream and in
# 47 steps of state (the replay against lm_forward: 0.914 under none,
# 1.334 under q8_0, flips at margins up to 0.4375; NVIDIA H100 80GB HBM3,
# 700 W).  GEN_LOGIT_TOL / GEN_TIE_MARGIN cannot hold between them, so
# each such comparison of xlstm-1.3b is held one-sided to a witness, as
# the few-key rule holds a decode row: an f32 replay of the same weights
# (``_f32_params``), against which the path under test may be no more
# than GEN_LOGIT_TOL further in a logit than the path it is compared with
# (``_check_witness``).  What the rounding cannot excuse is held layer
# by layer: every recurrent layer's full-sequence form against its
# decode step on the same inputs within SSM_LAYER_REL of the layer's
# largest output (measured at most 0.0082: about two bf16 ulps).
# jamba-1.5-large's one period (45 B parameters) has no f32 copy on the
# card: its replay against lm_forward without drops is held to
# JAMBA_LOGIT_TOL (measured 0.352, argmax flips at margins up to 0.0156,
# so GEN_TIE_MARGIN holds), and the same comparison against lm_forward at
# its own capacity factor, which drops tokens (measured 7.05), must
# exceed it: the control that the limit can see a routing change.
JAMBA_LOGIT_TOL = 0.5
SSM_LAYER_REL = 2.0 ** -6


def _stack_want(params, forwards: int, attention: dict) -> dict:
    """Launches of ``forwards`` one-token (or lm_forward) passes through a
    stack, worked out from its weights: every layer's quantized linears
    (an MoE projection one batched launch) and the quantized head, plus
    ``attention`` (kernel name -> launches)."""
    from repro_torch.kernels import ops
    want = {name: 0 for name in ops.KERNEL_MODULES}
    head = params.get("lm_head") or params["embed"]
    for tree in (params["layers"], head):
        for name, k in _matmul_launches(tree).items():
            want[name] += k * forwards
    for name, n in attention.items():
        want[name] += n
    return want


def _attn_layers(cfg) -> int:
    return sum(k == "attn" for k in cfg.pattern_for_layers())


def _no_drops(cfg):
    """``cfg`` with an MoE capacity of every token of a group (capacity
    factor E / top_k): lm_forward then routes as the decode path does (one
    token per group never drops), so the two can be compared; at jamba's
    capacity factor 1.25 lm_forward drops tokens by design."""
    if cfg.moe is None:
        return cfg
    factor = cfg.moe.num_experts / cfg.moe.top_k
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


class _Tap:
    """Record, per request, the logits behind each token a batcher emits:
    its last prompt chunk's (through ``lm_prefill_chunk``) and its row of
    every decode quantum (through ``lm_decode_step``), both called by the
    batcher's own programs.  Launches nothing."""

    def __init__(self, cb):
        self.cb, self.slot, self.logits = cb, None, {}

    def __enter__(self):
        from repro_torch.serving import scheduler
        self.mod = scheduler
        self.inner = (scheduler.lm_decode_step, scheduler.lm_prefill_chunk,
                      self.cb._prefill_quantum)
        dec, pre, quantum = self.inner
        cb = self.cb

        def prefill_quantum(i):
            self.slot = i
            return quantum(i)

        def decode_step(*args, **kw):
            logits, cache = dec(*args, **kw)
            for i, r in enumerate(cb.slots):
                if r is not None:
                    self.logits.setdefault(r.rid, []).append(logits[i, -1])
            return logits, cache

        def prefill_chunk(*args, **kw):
            logits, cache = pre(*args, **kw)
            if not cb._pending[self.slot]:
                self.logits[cb.slots[self.slot].rid] = [logits[0, -1]]
            return logits, cache
        scheduler.lm_decode_step, scheduler.lm_prefill_chunk = decode_step, prefill_chunk
        cb._prefill_quantum = prefill_quantum
        return self

    def __exit__(self, *exc):
        self.mod.lm_decode_step, self.mod.lm_prefill_chunk = self.inner[:2]
        del self.cb._prefill_quantum

    def stacked(self) -> dict:
        return {rid: torch.stack(v) for rid, v in self.logits.items()}


def _ssm_serve(cfg, params, reqs, label: str, device, max_len: int, **kw):
    """A ContinuousBatcher run over the requests ``reqs`` with its logits
    tapped: (batcher, launches, logits per rid, seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ContinuousBatcher
    cb = ContinuousBatcher(params, cfg, max_len=max_len, device=device, **kw)
    for r in reqs:
        cb.submit(r)
    if device == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with _Tap(cb) as tap, torch.no_grad():
        cb.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    _check_events(label, cb, len(reqs))
    return cb, counts, tap.stacked(), wall


def _ssm_requests(prompts, vocab: int, new: int, gen) -> tuple[list, int]:
    """Random prompts of the given lengths (``_lm_requests``) and the
    batcher's ``max_len`` for them."""
    from repro_torch.serving import ContinuousBatcher, Request
    return (_lm_requests(Request, prompts, vocab, new, 0, gen),
            ContinuousBatcher.required_len(len(prompts), 4, max(prompts), new))


def _serve_want(cb, cfg, params) -> dict:
    """A recurrent stack prefills by the decode-step scan: one forward per
    prompt token and per decode quantum, each with one paged decode per
    attention layer."""
    fwd = cb.prefill_launches + cb.decode_launches
    return _stack_want(params, fwd, {"flash_decode_paged": _attn_layers(cfg) * fwd})


def phase_tiny_ssm() -> None:
    """reduced(xlstm-1.3b) under q8_0 and reduced(jamba-1.5-large) under
    q3_k with the same seeded weights on the CPU (plain versions) and on
    the card (kernels): greedy_generate and ContinuousBatcher give
    identical tokens, with exact launches."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.policy import get_policy
    from repro_torch.core.tree import to_device
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.serve_step import greedy_generate
    for arch, seed, serve_seed in TINY_SSM_RUNS:
        cfg = reduced(get_config(arch))
        params = init_lm(torch.Generator().manual_seed(SEED), cfg,
                         policy=get_policy(cfg.default_policy))
        prompt = torch.randint(1, cfg.vocab_size, (2, TINY_SSM_PROMPT),
                               generator=torch.Generator().manual_seed(seed))
        steps = TINY_SSM_PROMPT + TINY_SSM_STEPS - 1
        gens, served = {}, {}
        for dev in ("cpu", "cuda"):
            p = to_device(params, dev)
            ops.reset_launch_counts()
            with torch.no_grad():
                gens[dev] = greedy_generate(p, cfg, prompt, TINY_SSM_STEPS, device=dev).cpu()
            counts = ops.launch_counts()
            want = (_stack_want(p, steps, {"flash_decode": _attn_layers(cfg) * steps})
                    if dev == "cuda" else {k: 0 for k in counts})
            if counts != want:
                raise AssertionError(f"tiny_ssm {arch} greedy_generate {dev}: launches "
                                     f"{counts}, expected {want}")
            reqs, max_len = _ssm_requests(TINY_SSM_PROMPTS, cfg.vocab_size, TINY_SSM_NEW,
                                          torch.Generator().manual_seed(serve_seed))
            cb, counts, _, _ = _ssm_serve(cfg, p, reqs, f"tiny_ssm {arch} {dev}", dev,
                                          max_len, slots=2, block_size=16,
                                          prefill_chunk=16)
            want = (_serve_want(cb, cfg, p) if dev == "cuda" else {k: 0 for k in counts})
            if counts != want or cb.prefill_launches != sum(TINY_SSM_PROMPTS):
                raise AssertionError(f"tiny_ssm {arch} serve {dev}: launches {counts}, "
                                     f"expected {want}; {cb.prefill_launches} prefill "
                                     f"launches for {sum(TINY_SSM_PROMPTS)} prompt tokens")
            served[dev] = {r.rid: r.out for r in cb.finished}
        log(f"[tiny_ssm] {arch} weights={cfg.default_policy}: greedy_generate cpu "
            f"{gens['cpu'][:, TINY_SSM_PROMPT:].tolist()} cuda "
            f"{gens['cuda'][:, TINY_SSM_PROMPT:].tolist()}; served cpu {served['cpu']} "
            f"cuda {served['cuda']}")
        if not torch.equal(gens["cpu"], gens["cuda"]) or served["cpu"] != served["cuda"]:
            raise AssertionError(f"tiny_ssm {arch}: tokens differ between the CPU and "
                                 "the card")


class _PlainQ8:
    """Route ``q8_matmul`` (as ``ops.quantized_matmul`` calls it) to its
    plain version, and while ``check`` is set also launch the kernel on
    the call's inputs and hold it to the plain result within MATMUL_RTOL
    of its largest magnitude (a plain replay with one step checked)."""
    active = False

    def __enter__(self):
        from repro_torch.core.quant import Q8_0Tensor
        from repro_torch.kernels import q8_matmul, ref
        self.mod, self.inner = q8_matmul, q8_matmul.q8_matmul
        self.calls, self.checked, self.excess = 0, 0, None

        def plain(x, wq, ws):
            want = ref.q8_matmul_ref(x, Q8_0Tensor(wq, ws))
            self.calls += 1
            if self.active:
                got = self.inner(x, wq, ws)
                excess = ((got - want).abs().amax()
                          - MATMUL_RTOL * want.abs().amax().clamp_min(1.0))
                self.excess = excess if self.excess is None else torch.maximum(
                    self.excess, excess)
                self.checked += 1
            return want
        q8_matmul.q8_matmul = plain
        return self

    def __exit__(self, *exc):
        self.mod.q8_matmul = self.inner


def _check_replay(label: str, dec, plain) -> None:
    """``dec`` against ``plain`` (two runs of the same tokens): every logit
    within GEN_LOGIT_TOL and the same argmax where ``plain``'s top-2 margin
    exceeds GEN_TIE_MARGIN."""
    diff = (dec - plain).abs()
    worst = diff.max().item()
    top = plain.topk(2, dim=-1)
    margin = (top.values[..., 0] - top.values[..., 1]).cpu()
    flips = (dec.argmax(-1) != plain.argmax(-1)).cpu()
    log(f"[full_ssm] {label}: logits within {worst:.4f} "
        f"({100 * (diff == 0).float().mean().item():.3f}% bit-equal), "
        f"{int(flips.sum())} of {flips.numel()} argmax differ (margins "
        f"{[round(float(m), 4) for m in margin[flips]]}); "
        f"{int((margin > GEN_TIE_MARGIN).sum())} compared")
    if not worst <= GEN_LOGIT_TOL or (flips & (margin > GEN_TIE_MARGIN)).any():
        raise AssertionError(f"full_ssm {label}: logits differ by {worst} (limit "
                             f"{GEN_LOGIT_TOL}), or the argmax where the margin "
                             f"exceeds {GEN_TIE_MARGIN}")


def _layers_parallel_vs_recurrent(params, cfg, tokens) -> list:
    """Every recurrent layer's full-sequence form (what lm_forward runs:
    Mamba's chunked scan, mLSTM's decay matrix, sLSTM's loop) against its
    decode step fed the same bf16 input token by token from a fresh state,
    on lm_forward's own layer inputs over ``tokens``.  Returns per
    recurrent layer (max |difference| / max |output|, the share of
    bit-equal outputs)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    b, s = tokens.shape
    x = L.apply_embedding(params["embed"], tokens)
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    rows = []
    with torch.no_grad():
        for p in params["layers"]:
            kind = T._mixer(p)
            if kind != "attn":
                _, fwd, step, state = T._RECURRENT[kind]
                h = T._apply_norm(cfg, p["norm1"], x)
                y = fwd(p[kind], cfg, h)
                st = state(b, cfg, x.device)
                rec = torch.cat([step(p[kind], cfg, h[:, t:t + 1], st)[0] for t in range(s)], 1)
                rows.append((((y.float() - rec.float()).abs().max()
                              / y.float().abs().max()).item(),
                             (y == rec).float().mean().item()))
            x, _ = T._layer_fwd(p, cfg, x, pos, causal=True)
    return rows


def _ssm_gen(card: str, cfg, params, preset: str, batch: int, prompt_len: int,
             steps_new: int, seed: int, witness: bool = False) -> dict:
    """greedy_generate (counted), its synchronised replay (ms per step, the
    tokens reproduced), a plain replay (q8_0: every q8_matmul routed to its
    plain version, the kernel held to it on the last step's calls; an MoE
    stack: every batched expert launch of the last step held to its plain
    version), tokens against lm_forward (without MoE drops, ``_no_drops``),
    and a profile of one decode step.  ``witness``: an f32 replay holds the
    replays' comparisons one-sided (``_check_witness``); else they hold
    JAMBA_LOGIT_TOL, and an MoE stack's lm_forward with drops must exceed
    it (the control)."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import lm_forward
    from repro_torch.train.serve_step import greedy_generate, make_decode, make_prefill
    prompts = torch.randint(1, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator(device="cuda").manual_seed(seed),
                            device="cuda")
    steps, max_len = prompt_len + steps_new - 1, prompt_len + steps_new
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = greedy_generate(params, cfg, prompts, steps_new, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    label = f"{cfg.name} weights={preset} greedy_generate"
    want = _stack_want(params, steps, {"flash_decode": _attn_layers(cfg) * steps})
    if counts != want:
        raise AssertionError(f"full_ssm {label}: launches {counts}, expected {want}")
    if out.shape != (batch, max_len) or not torch.equal(out[:, :prompt_len], prompts.to(out.dtype)) \
            or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"full_ssm {label}: output {tuple(out.shape)} is not the "
                             "prompts followed by vocabulary tokens")
    if cfg.moe is not None:
        with _CheckedExperts(per_expert=True) as oracle:
            dec, times, cache = _replay(params, cfg, out, steps, max_len, check=oracle)
    else:
        dec, times, cache = _replay(params, cfg, out, steps, max_len)
    if not torch.isfinite(dec).all() or not torch.equal(
            dec[:, prompt_len - 1:].argmax(-1).to(out.dtype), out[:, prompt_len:]):
        raise AssertionError(f"full_ssm {label}: the make_decode replay does not "
                             "reproduce greedy_generate's tokens")
    exact = None
    if witness:
        wide = _f32_params(params)
        exact = _replay(wide, cfg, out, steps, max_len)[0]
        with torch.no_grad():
            forms = (lm_forward(wide, cfg, out[:, :-1])[0] - exact).abs().max().item()
        del wide
        log(f"[full_ssm] {label}: the f32 witness: its replay within {forms:.3e} of its "
            f"lm_forward")
        if not forms <= GEN_LOGIT_TOL:
            raise AssertionError(f"full_ssm {label}: the f32 replay is {forms} from the f32 "
                                 f"lm_forward (limit {GEN_LOGIT_TOL})")
    if preset == "q8_0":
        with _PlainQ8() as plain_q8:
            plain = _replay(params, cfg, out, steps, max_len, check=plain_q8)[0]
        per_step = _stack_want(params, 1, {})["q8_matmul"]
        if plain_q8.calls != per_step * steps or plain_q8.checked != per_step \
                or not plain_q8.excess.item() <= 0:
            raise AssertionError(f"full_ssm {label}: {plain_q8.calls} plain q8_matmul calls "
                                 f"({plain_q8.checked} checked), expected {per_step} per "
                                 f"step; excess over MATMUL_RTOL {plain_q8.excess}")
        log(f"[full_ssm] {label}: {plain_q8.checked} q8_matmul launches of the last step "
            f"held to their plain version (excess over MATMUL_RTOL "
            f"{plain_q8.excess.item():.3e})")
        _check_witness(f"full_ssm {label}", dec, plain, exact,
                       ("kernel replay", "plain replay"))
        del plain
    if cfg.moe is not None:
        per_step = sum(_matmul_launches([lp["moe"] for lp in params["layers"]
                                         if "moe" in lp]).values())
        oracle.check(f"{label} last step", per_step)
    with torch.no_grad():
        first = make_prefill(_no_drops(cfg), device="cuda")(
            params, {"tokens": prompts}).argmax(-1).cpu()
    _check_gen_against_forward(params, _no_drops(cfg), out, dec, first, prompt=prompt_len,
                               label=f"full_ssm {label}",
                               **(dict(exact=exact) if witness else dict(tol=JAMBA_LOGIT_TOL)))
    if cfg.moe is not None:
        with torch.no_grad():
            drop = (lm_forward(params, cfg, out[:, :-1])[0] - dec).abs().max().item()
        log(f"[full_ssm] {label}: the control, lm_forward at capacity factor "
            f"{cfg.moe.capacity_factor} (drops tokens), {drop:.4f} from the replay "
            f"(limit {JAMBA_LOGIT_TOL} without drops)")
        if not drop > JAMBA_LOGIT_TOL:
            raise AssertionError(f"full_ssm {label}: lm_forward with drops is within "
                                 f"{JAMBA_LOGIT_TOL} of the replay: the limit cannot see "
                                 "a routing change")
    del exact
    layers = _layers_parallel_vs_recurrent(params, _no_drops(cfg), out[:, :-1])
    worst = max(rel for rel, _ in layers)
    log(f"[full_ssm] {label}: each recurrent layer's full-sequence form against its "
        f"decode step on lm_forward's inputs: max|diff| / max|out| "
        f"{[round(rel, 5) for rel, _ in layers]} (bit-equal "
        f"{min(eq for _, eq in layers):.3f}-{max(eq for _, eq in layers):.3f})")
    if not worst <= SSM_LAYER_REL:
        raise AssertionError(f"full_ssm {label}: a recurrent layer's two forms differ by "
                             f"{worst} of its largest output > {SSM_LAYER_REL}")
    step_ms = 1e3 * sum(times[2:]) / (steps - 2)
    log(f"[full_ssm] {label}: {steps} decode steps of {batch} rows in {wall:.2f} s "
        f"({1e3 * wall / steps:.2f} ms per step unsynchronised); {step_ms:.2f} ms per "
        f"synchronised decode step; launches {counts}; {card}")
    decode = make_decode(cfg, device="cuda")
    with torch.no_grad():
        tok = out[:, -1:]
        _profile(f"{label} decode step", lambda: decode(params, tok, steps, cache))
    del dec, cache
    return counts


def _xlstm_serve(card: str, cfg, params, preset: str) -> dict:
    """ContinuousBatcher(4 slots, block 16, chunk 16) over XLSTM_PROMPTS (6
    requests: the fifth and sixth land in recycled slots).  Gates: events,
    exact launches (the scan prefill: one forward per prompt token); every
    request's tokens and logits the bits of the same request alone in a
    fresh batcher of 4 slots (the reset at full width); and each request's
    logits against a replay of it alone from a zeroed state (the reset
    writes zeros: not lm_forward's, nor greedy_generate's, fresh state)."""
    label = f"xlstm-1.3b weights={preset} serve"
    reqs, max_len = _ssm_requests(XLSTM_PROMPTS, cfg.vocab_size, XLSTM_NEW,
                                  torch.Generator(device="cuda").manual_seed(SEED + 41))
    cb, counts, logits, wall = _ssm_serve(cfg, params, reqs, f"full_ssm {label}", "cuda",
                                          max_len, **XLSTM_KW)
    want = _serve_want(cb, cfg, params)
    if counts != want or cb.prefill_launches != sum(XLSTM_PROMPTS):
        raise AssertionError(f"full_ssm {label}: launches {counts}, expected {want}; "
                             f"{cb.prefill_launches} prefill launches for "
                             f"{sum(XLSTM_PROMPTS)} prompt tokens")
    outs = {r.rid: r.out for r in cb.finished}
    recycled = sum(1 for e in cb.bus.log if type(e).__name__ == "Admitted") - XLSTM_KW["slots"]
    for r in reqs:
        alone = type(r)(rid=0, prompt=list(r.prompt), max_new=r.max_new)
        solo, _, solo_logits, _ = _ssm_serve(cfg, params, [alone], f"full_ssm {label} alone",
                                             "cuda", max_len, **XLSTM_KW)
        if solo.finished[0].out != outs[r.rid] \
                or not torch.equal(solo_logits[0], logits[r.rid]):
            raise AssertionError(f"full_ssm {label} rid {r.rid}: tokens or logits differ "
                                 "from the same request alone in a fresh batcher")
        del solo
    for r in sorted(cb.finished, key=lambda r: r.rid):
        seq = r.prompt + r.out[:-1]
        dec = _replay(params, cfg, torch.tensor([seq], device="cuda"), len(seq), len(seq),
                      zeroed=True)[0]
        _check_replay(f"{label} rid {r.rid}: the batcher vs a replay of it alone from a "
                      "zeroed state", logits[r.rid][None], dec[:, len(r.prompt) - 1:])
    log(f"[full_ssm] {label}: {len(reqs) * XLSTM_NEW} tokens for {len(reqs)} requests "
        f"({recycled} in recycled slots) in {wall:.2f} s; quanta {cb.prefill_quanta} "
        f"prefill / {cb.decode_quanta} decode; each request's tokens and logits the bits "
        f"of the same request alone; launches {counts}; {card}")
    _profile_ssm(cb, label, card)
    return counts


def _profile_ssm(cb, label: str, card: str) -> None:
    """ms per synchronised decode quantum at all slots and per scan-prefill
    token (a prefill chunk of ``cb.prefill_chunk`` tokens at batch 1), then
    a profile of one decode quantum (on the batcher's recycled state)."""
    slots, mb = len(cb.slots), cb.runtime.blocks_per_slot
    tables = (torch.arange(slots * mb, device="cuda", dtype=torch.int32)
              % (cb.runtime.num_blocks - 1) + 1).reshape(slots, mb)
    toks = torch.ones((slots, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((slots,), 8, dtype=torch.int32, device="cuda")
    chunk = torch.ones((1, cb.prefill_chunk), dtype=torch.int64, device="cuda")

    def decode():
        return cb.step_fn(cb.params, toks, pos, tables, cb.cache)

    def prefill():
        return cb._prefill_raw(cb.params, chunk, torch.zeros((1,), dtype=torch.int32), 0,
                               tables[:1], cb.cache)
    with torch.no_grad():
        dec_ms, pre_ms = cuda_ms(decode, iters=5, warmup=1), cuda_ms(prefill, iters=2, warmup=1)
        log(f"[full_ssm] {label}: {dec_ms:.2f} ms per decode quantum at {slots} slots, "
            f"{pre_ms / cb.prefill_chunk:.2f} ms per scan-prefill token (event time); {card}")
        _profile(f"{label} decode quantum", decode)


def _jamba_serve(card: str, cfg, params) -> dict:
    """ContinuousBatcher(4 slots) over JAMBA_PROMPTS: events, exact
    launches, each request's tokens against lm_forward without MoE drops
    (``_no_drops``; Mamba's zero reset is its fresh state)."""
    label = "jamba-1.5-large weights=q3_k serve"
    reqs, max_len = _ssm_requests(JAMBA_PROMPTS, cfg.vocab_size, JAMBA_NEW,
                                  torch.Generator(device="cuda").manual_seed(SEED + 43))
    cb, counts, _, wall = _ssm_serve(cfg, params, reqs, f"full_ssm {label}", "cuda",
                                     max_len, **XLSTM_KW)
    want = _serve_want(cb, cfg, params)
    if counts != want or cb.prefill_launches != sum(JAMBA_PROMPTS):
        raise AssertionError(f"full_ssm {label}: launches {counts}, expected {want}")
    _check_against_forward(cb.finished, params, _no_drops(cfg), GEN_TIE_MARGIN,
                           label=f"full_ssm {label}")
    log(f"[full_ssm] {label}: {len(reqs) * JAMBA_NEW} tokens for {len(reqs)} requests in "
        f"{wall:.2f} s; quanta {cb.prefill_quanta} prefill / {cb.decode_quanta} decode; "
        f"launches {counts}; {card}")
    _profile_ssm(cb, label, card)
    return counts


def phase_full_ssm(card: str) -> dict[str, int]:
    """xlstm-1.3b at full size under q8_0 and none, then jamba-1.5-large at
    full width and one period under q3_k, with seeded weights made on the
    card (jamba's layer by layer, each quantized as it is drawn)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import param_bytes, param_count, quantize_params
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    phase_tiny_ssm()
    totals = {name: 0 for name in ops.KERNEL_MODULES}

    def add(counts):
        for name, n in counts.items():
            totals[name] += n

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config("xlstm-1.3b")
    base = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    log(f"[full_ssm] init xlstm-1.3b {time.perf_counter() - t_phase:.1f} s, "
        f"{param_count(base) / 1e9:.3f} B parameters, {param_bytes(base) / 2**30:.2f} GiB")
    for preset in XLSTM_PRESETS:
        params = base if preset == "none" else quantize_params(base, get_policy(preset))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        add(_ssm_gen(card, cfg, params, preset, XLSTM_GEN_BATCH, XLSTM_GEN_PROMPT,
                     XLSTM_GEN_STEPS, SEED + 39, witness=True))
        add(_xlstm_serve(card, cfg, params, preset))
        log(f"[full_ssm] xlstm-1.3b weights={preset}: {param_bytes(params) / 2**30:.2f} GiB "
            f"of weights; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
        del params
    del base
    gc.collect()
    torch.cuda.empty_cache()
    t_jamba = time.perf_counter()
    full = get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(full, num_layers=JAMBA_PERIODS * len(full.block_pattern))
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                     policy=get_policy(cfg.default_policy))
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()                  # the init's bf16 layers, freed
    log(f"[full_ssm] init jamba-1.5-large, {cfg.num_layers} of {full.num_layers} layers, "
        f"quantized layer by layer to {cfg.default_policy}: "
        f"{time.perf_counter() - t_jamba:.1f} s, {param_count(params) / 1e9:.2f} B "
        f"parameters, {param_bytes(params) / 2**30:.2f} GiB; peak {init_peak:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    add(_ssm_gen(card, cfg, params, cfg.default_policy, JAMBA_GEN_BATCH, JAMBA_GEN_PROMPT,
                 JAMBA_GEN_STEPS, SEED + 45))
    add(_jamba_serve(card, cfg, params))
    log(f"[full_ssm] jamba-1.5-large: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB after init; {card}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[full_ssm] phase {time.perf_counter() - t_phase:.1f} s; {card}")
    return totals


# ------------------------------------------------------------- full_vlm
# qwen2-vl-72b at full width (80 layers, d 8192, 64/8 heads of 128, d_ff
# 29568, vocab 152064) under q3_k, drawn layer by layer: q, k, v, o, gate
# and up as Q3_K (21.8 GB), every down projection dense bf16 (K = 29568 is
# no multiple of 256: 38.8 GB), the embedding and the head Q8_0 (2.65 GB).
VLM_RECKON_GB = 63.2
VLM_ROWS, VLM_TEXT = 2, 16               # make_prefill: 2 rows, 256 patches + 16 tokens
VLM_GEN_PROMPT, VLM_GEN_NEW = 16, 16     # greedy_generate: 2 prompts x 16 new
VLM_PROMPTS, VLM_NEW = (40, 72, 56, 90), 8
VLM_KW = dict(slots=4, block_size=16, prefill_chunk=64)
VLM_CUT = 8                              # the whole-model comparisons' depth
VLM_CUT_PRESETS = ("q3_k", "q8_0")
# Each layer's kernel path against its plain path (every kernel routed to
# its plain version) on the same input: max|diff| / max|out|, two bf16
# ulps of the layer's largest output, as SSM_LAYER_REL.
VLM_LAYER_REL = 2.0 ** -6
BF16_ULP = 2.0 ** -7       # one bf16 ulp, relative: at most 2^-7 of |x|
# Per decode step of the 80-layer stack under q3_k: q, k, v, o, gate and
# up of each layer through q3k_matmul, the q8_0 head through q8_matmul,
# one flash_decode per layer, and each layer's dense down projection on
# cuBLAS (counted at qlinear.dense_matmul).
VLM_STEP_WANT = {"q3k_matmul": 480, "q8_matmul": 1, "flash_decode": 80, "dense": 80}
# The kernel rows at qwen2-vl's shapes.  flash_attention: make_prefill's
# causal self-attention over 256 patches + 16 tokens (KV heads repeated to
# 64), and lm_forward at the 8-layer cut over 2 x 31 tokens.  q3k_matmul:
# the decode linears at greedy_generate's 2 rows (q/o, k/v, gate/up) and
# the batcher's 4; make_prefill's 544 rows and the batcher's 64-token
# chunk (tile path).  q8_matmul: the head (N = 152064) at 2 rows and the
# q8_0 cut's linears (down: K = 29568); lm_forward's 62 rows (tile path).
# flash_decode: 2 rows, Hkv 8, G 8, hd 128 on a 32-slot cache read at 31,
# 1 and 16 keys (the few-key rule).
ATTN_VLM_SHAPES = [(2, 64, 272, 272, 128, True, None), (2, 64, 31, 31, 128, True, None)]
VLM_NK = [(8192, 8192), (1024, 8192), (29568, 8192)]
VLM_Q3K_SHAPES = [(2, n, k) for n, k in VLM_NK]
VLM_Q3K_EDGE = ([(4, 29568, 8192)] + [(544, n, k) for n, k in VLM_NK]
                + [(64, 29568, 8192)])
VLM_Q8_SHAPES = [(2, 152064, 8192)] + [(2, n, k) for n, k in VLM_NK] + [(2, 8192, 29568)]
VLM_Q8_EDGE = [(4, 152064, 8192), (32, 152064, 8192), (62, 29568, 8192),
               (62, 8192, 29568)]
VLM_FLASH_DECODE = [(2, 8, 8, 128, 32, n) for n in (31, 1, 16)]


class _DenseCount:
    """Count ``qlinear.dense_matmul`` calls: the dense linears (cuBLAS on
    the card)."""

    def __enter__(self):
        from repro_torch.core import qlinear
        self.mod, self.inner, self.calls = qlinear, qlinear.dense_matmul, 0

        def counted(x, w):
            self.calls += 1
            return self.inner(x, w)
        qlinear.dense_matmul = counted
        return self

    def __exit__(self, *exc):
        self.mod.dense_matmul = self.inner


class _PlainOps:
    """Route every kernel entry of ``ops`` to its plain version on the card
    (the dispatch takes the CUDA tensors for the CPU's): the all-plain path
    a kernel path is held to."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.inner = ops, ops._on_card
        ops._on_card = lambda t: False
        return self

    def __exit__(self, *exc):
        self.ops._on_card = self.inner


def _vlm_inputs(cfg, rows: int, text: int, seed: int):
    from repro_torch.models.frontend import synthetic_frontend, vision_frontend_shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(1, cfg.vocab_size, (rows, text), generator=gen, device="cuda")
    return tokens, synthetic_frontend(gen, vision_frontend_shape(cfg, rows))


def _vlm_prefill(card: str, cfg, params) -> dict:
    """make_prefill on 2 rows of a 256-patch prefix and 16 tokens: the bits
    of lm_forward(prefix_embeds=..., last_only=True); lm_forward's last row
    with the head over every position (tile path) within MATMUL_RTOL; the
    same text without the prefix differs; exact launches; each layer's
    kernel path against its plain path."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import lm_forward
    from repro_torch.train.serve_step import make_prefill
    tokens, prefix = _vlm_inputs(cfg, VLM_ROWS, VLM_TEXT, SEED + 51)
    prefill = make_prefill(cfg, device="cuda")
    batch = {"tokens": tokens, "prefix_embeds": prefix}
    layers = cfg.num_layers
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with _DenseCount() as dense:
            logits = prefill(params, batch)
        counts = ops.launch_counts()
        want = _stack_want(params, 1, {"flash_attention": layers})
        if counts != want or dense.calls != layers:
            raise AssertionError(f"full_vlm make_prefill: launches {counts} and {dense.calls} "
                                 f"dense, expected {want} and {layers}")
        same = lm_forward(params, cfg, tokens, prefix_embeds=prefix, last_only=True)[0][:, -1]
        full = lm_forward(params, cfg, tokens, prefix_embeds=prefix)[0][:, -1]
        bare = prefill(params, {"tokens": tokens})
    # The head's f32 sums (decode path at 2 rows, tile path at 32) are
    # rounded to bf16 logits: the two may sit one bf16 ulp apart.
    head_err = (full - logits).abs().max().item()
    head_excess = ((full - logits).abs() - BF16_ULP * full.abs()).max().item()
    moved = (bare - logits).abs().max().item()
    tol = MATMUL_RTOL * max(1.0, full.abs().max().item())
    log(f"[full_vlm] make_prefill {tuple(tokens.shape)} + prefix {tuple(prefix.shape)}: "
        f"logits {tuple(logits.shape)} finite {bool(torch.isfinite(logits).all())}; the bits "
        f"of lm_forward(last_only) {torch.equal(same, logits)}; lm_forward's head over every "
        f"position within {head_err:.3e} (limit {tol:.3e} + one bf16 ulp); without the prefix {moved:.4f} "
        f"away; launches {counts}, {dense.calls} dense")
    if not (torch.isfinite(logits).all() and torch.equal(same, logits)
            and head_excess <= tol and moved > GEN_LOGIT_TOL):
        raise AssertionError("full_vlm make_prefill: not the bits of lm_forward(last_only), "
                             f"or the full head {head_err} > {tol}, or the prefix moved the "
                             f"logits only {moved}")
    ms = cuda_ms(lambda: prefill(params, batch), iters=3, warmup=1)
    log(f"[full_vlm] make_prefill: {ms:.2f} ms per call ({VLM_ROWS} x "
        f"{prefix.shape[1] + VLM_TEXT} tokens, event time); {card}")
    with torch.no_grad():
        _profile("qwen2-vl-72b q3_k make_prefill", lambda: prefill(params, batch))
        rels = _layers_kernel_vs_plain(params, cfg, tokens, prefix)
    worst = max(rels)
    log(f"[full_vlm] each of {len(rels)} layers, kernel path vs plain path on the same "
        f"input: max|diff| / max|out| {min(rels):.5f}-{worst:.5f} (limit "
        f"{VLM_LAYER_REL:.5f}); layers 0-7 {[round(r, 5) for r in rels[:8]]}")
    if not worst <= VLM_LAYER_REL:
        raise AssertionError(f"full_vlm: layer {rels.index(worst)}'s kernel path is {worst} of "
                             f"its largest output from its plain path > {VLM_LAYER_REL}")
    return counts


def _layers_kernel_vs_plain(params, cfg, tokens, prefix) -> list:
    """Every layer run twice on the kernel path's own input (make_prefill's
    prefix and text): with the kernels and with every kernel routed to its
    plain version.  -> per layer max|diff| / max|plain output|."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    x = torch.cat([prefix, L.apply_embedding(params["embed"], tokens)], 1)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    rels = []
    for p in params["layers"]:
        y, _ = T._layer_fwd(p, cfg, x, pos, causal=True)
        with _PlainOps():
            want, _ = T._layer_fwd(p, cfg, x, pos, causal=True)
        rels.append(((y.float() - want.float()).abs().max()
                     / want.float().abs().max()).item())
        x = y
    return rels


def _vlm_gen(card: str, cfg, params, preset: str, whole: bool) -> dict:
    """greedy_generate of 2 prompts x 16 new tokens (counted per step), the
    make_decode replay reproducing its tokens, and a profile of one decode
    step.  ``whole``: also hold the replay to lm_forward (at the cut)."""
    from repro_torch.core.quant import QTYPES
    from repro_torch.kernels import ops
    from repro_torch.train.serve_step import greedy_generate, make_decode, make_prefill
    prompts = torch.randint(1, cfg.vocab_size, (VLM_ROWS, VLM_GEN_PROMPT),
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 53),
                            device="cuda")
    steps, max_len = VLM_GEN_PROMPT + VLM_GEN_NEW - 1, VLM_GEN_PROMPT + VLM_GEN_NEW
    label = f"{cfg.name} {cfg.num_layers} layers weights={preset} greedy_generate"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), _DenseCount() as dense:
        out = greedy_generate(params, cfg, prompts, VLM_GEN_NEW, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = _stack_want(params, steps, {"flash_decode": cfg.num_layers * steps})
    dense_want = sum(not isinstance(lp["mlp"]["down"].w, QTYPES) for lp in params["layers"])
    if counts != want or dense.calls != dense_want * steps:
        raise AssertionError(f"full_vlm {label}: launches {counts} and {dense.calls} dense, "
                             f"expected {want} and {dense_want * steps}")
    per_step = {k: v // steps for k, v in counts.items() if v}
    per_step["dense"] = dense.calls // steps
    if cfg.num_layers == 80 and preset == "q3_k" and per_step != VLM_STEP_WANT:
        raise AssertionError(f"full_vlm {label}: per step {per_step}, expected {VLM_STEP_WANT}")
    dec, times, cache = _replay(params, cfg, out, steps, max_len)
    if not torch.isfinite(dec).all() or not torch.equal(
            dec[:, VLM_GEN_PROMPT - 1:].argmax(-1).to(out.dtype), out[:, VLM_GEN_PROMPT:]):
        raise AssertionError(f"full_vlm {label}: the make_decode replay does not reproduce "
                             "greedy_generate's tokens")
    if whole:
        with torch.no_grad():
            first = make_prefill(cfg, device="cuda")(params, {"tokens": prompts}).argmax(-1).cpu()
        _vlm_whole(label, params, cfg, out, dec, first)
    step_ms = 1e3 * sum(times[2:]) / (steps - 2)
    log(f"[full_vlm] {label}: {steps} decode steps of {VLM_ROWS} rows in {wall:.2f} s; "
        f"{step_ms:.2f} ms per synchronised decode step; per step {per_step}; {card}")
    decode = make_decode(cfg, device="cuda")
    with torch.no_grad():
        tok = out[:, -1:]
        _profile(f"{label} decode step", lambda: decode(params, tok, steps, cache))
    del dec, cache
    return counts


def _vlm_whole(label: str, params, cfg, out, dec, first) -> None:
    """The decode replay against lm_forward under GEN_LOGIT_TOL /
    GEN_TIE_MARGIN; where that does not hold, one-sided to an f32 replay
    of the same weights (``_check_witness``)."""
    from repro_torch.models.transformer import lm_forward
    with torch.no_grad():
        fwd = lm_forward(params, cfg, out[:, :-1])[0]
    worst = (dec - fwd).abs().max().item()
    top = fwd[:, VLM_GEN_PROMPT - 1:].topk(2, dim=-1)
    margin = top.values[..., 0] - top.values[..., 1]
    flips = (top.indices[..., 0] != out[:, VLM_GEN_PROMPT:]) & (margin > GEN_TIE_MARGIN)
    del fwd, top
    if worst <= GEN_LOGIT_TOL and not flips.any():
        _check_gen_against_forward(params, cfg, out, dec, first, prompt=VLM_GEN_PROMPT,
                                   label=f"full_vlm {label}")
        return
    log(f"[full_vlm] {label}: the replay is {worst:.4f} from lm_forward (limit "
        f"{GEN_LOGIT_TOL}), {int(flips.sum())} tokens off its argmax above "
        f"{GEN_TIE_MARGIN}: held to the f32 witness")
    exact = _f32_forward(params, cfg, out[:, :-1])
    _check_gen_against_forward(params, cfg, out, dec, first, prompt=VLM_GEN_PROMPT,
                               label=f"full_vlm {label}", exact=exact)


def _f32_forward(params, cfg, tokens) -> torch.Tensor:
    """The witness of a whole-model comparison of an attention stack:
    lm_forward of an f32 copy of the weights (``_f32_params``) with every
    kernel routed to its plain version, f32 activations throughout."""
    from repro_torch.models.transformer import lm_forward
    wide = _f32_params(params)
    with torch.no_grad(), _PlainOps():
        exact = lm_forward(wide, cfg, tokens)[0]
    del wide
    return exact


def _vlm_serve(card: str, cfg, params, preset: str, whole: bool) -> dict:
    """ContinuousBatcher (4 slots, bf16 KV, fused 64-token chunks) over
    VLM_PROMPTS: events, exact launches (per chunk and quantum one paged
    kernel per layer, the quantized linears per forward), finite logits;
    ``whole``: each request's tapped logits against lm_forward under
    GEN_LOGIT_TOL / GEN_TIE_MARGIN, else one-sided to an f32 replay of the
    request alone."""
    from repro_torch.models.transformer import lm_forward
    label = f"{cfg.name} {cfg.num_layers} layers weights={preset} serve"
    reqs, max_len = _ssm_requests(VLM_PROMPTS, cfg.vocab_size, VLM_NEW,
                                  torch.Generator(device="cuda").manual_seed(SEED + 55))
    cb, counts, logits, wall = _ssm_serve(cfg, params, reqs, f"full_vlm {label}", "cuda",
                                          max_len, **VLM_KW)
    fwd_n = cb.prefill_launches + cb.decode_launches
    want = _stack_want(params, fwd_n, {
        "flash_prefill_paged": cfg.num_layers * cb.prefill_launches,
        "flash_decode_paged": cfg.num_layers * cb.decode_launches})
    if counts != want:
        raise AssertionError(f"full_vlm {label}: launches {counts}, expected {want}")
    if not all(torch.isfinite(v).all() for v in logits.values()):
        raise AssertionError(f"full_vlm {label}: non-finite logits")
    if whole:
        for r in sorted(cb.finished, key=lambda r: r.rid):
            seq = torch.tensor([r.prompt + r.out[:-1]], device="cuda")
            with torch.no_grad():
                fwd = lm_forward(params, cfg, seq)[0][:, len(r.prompt) - 1:]
            got = logits[r.rid][None]
            worst = (got - fwd).abs().max().item()
            top = fwd.topk(2, dim=-1)
            margin = top.values[..., 0] - top.values[..., 1]
            flips = (got.argmax(-1) != top.indices[..., 0]) & (margin > GEN_TIE_MARGIN)
            if worst <= GEN_LOGIT_TOL and not flips.any():
                log(f"[full_vlm] {label} rid {r.rid}: served logits within {worst:.4f} of "
                    f"lm_forward's; {int((margin > GEN_TIE_MARGIN).sum())} tokens compared")
                continue
            exact = _f32_forward(params, cfg, seq)[:, len(r.prompt) - 1:]
            _check_witness(f"full_vlm {label} rid {r.rid}", got, fwd, exact,
                           ("batcher", "lm_forward"))
    log(f"[full_vlm] {label}: {len(reqs) * VLM_NEW} tokens for {len(reqs)} requests in "
        f"{wall:.2f} s; quanta {cb.prefill_quanta} prefill / {cb.decode_quanta} decode; "
        f"launches {counts}; {card}")
    _profile_lm(cb, label)
    return counts


def phase_full_vlm(card: str) -> dict[str, int]:
    """qwen2-vl-72b at full width and depth under q3_k (weights drawn and
    quantized layer by layer on the card): make_prefill with the vision
    prefix, every layer's kernel path against its plain path,
    greedy_generate and the batcher with exact launches; then an 8-layer
    cut at full width under q3_k and q8_0 whose decode replay and served
    requests are held to lm_forward."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import param_bytes, param_count
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    totals = {name: 0 for name in ops.KERNEL_MODULES}

    def add(counts):
        for name, n in counts.items():
            totals[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-vl-72b")
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                     policy=get_policy("q3_k"))
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[full_vlm] init qwen2-vl-72b, {cfg.num_layers} layers quantized layer by layer "
        f"to q3_k: {time.perf_counter() - t_phase:.1f} s, {param_count(params) / 1e9:.2f} B "
        f"parameters, {param_bytes(params) / 1e9:.2f} GB of weights (reckoned "
        f"{VLM_RECKON_GB} GB); peak {init_peak:.2f} GB while drawing")
    torch.cuda.reset_peak_memory_stats()
    add(_vlm_prefill(card, cfg, params))
    add(_vlm_gen(card, cfg, params, "q3_k", whole=False))
    add(_vlm_serve(card, cfg, params, "q3_k", whole=False))
    log(f"[full_vlm] 80 layers: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB after "
        f"init; {card}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=VLM_CUT)
    for preset in VLM_CUT_PRESETS:
        params = init_lm(torch.Generator(device="cuda").manual_seed(SEED + 1), cut,
                         policy=get_policy(preset))
        add(_vlm_gen(card, cut, params, preset, whole=True))
        add(_vlm_serve(card, cut, params, preset, whole=True))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[full_vlm] phase {time.perf_counter() - t_phase:.1f} s; {card}")
    return totals


# ----------------------------------------------------------- full_train
# granite-8b trained at full width.  Full depth (36 layers, 8.25 B
# parameters): bf16 parameters and gradients 16.5 GB each, Q8_0 moments
# 17.5 GB, about 51 GB before temporaries; f32 moments (66 GB), the f32
# microbatch accumulator and the f32 compression residual (33 GB each) do
# not fit beside them, so those options run at a cut of 4 layers.
TRAIN_RECKON_GB = 51.0
TRAIN_SEQ, TRAIN_STEPS = 512, 3
# The full-depth steps' learning rate: the first steps of a warmup.  At
# TrainConfig's 3e-4 the first Adam step (a sign step of 3e-4 on every one
# of 8.25 B random weights) overshoots on the fixed batch: the loss rose
# from 11.31 to 12.38 (NVIDIA H100 80GB HBM3, 700.00 W).
TRAIN_LR = 1e-5
TRAIN_CUT, TRAIN_CUT_BATCH = 4, 2
# Per-leaf gradients of the kernel path (flash_attention's forward) and
# of the all-plain path on the same weights and batch: max|diff| /
# max|plain|.  The two round the attention output to bf16 at other
# points, and the bf16 backward carries that on (the CPU port against the
# reference measures up to 2.0e-2 per leaf in bf16).  Where a leaf fails,
# it is held one-sided to the f32 gradient of the same weights: the
# kernel path no more than TRAIN_GRAD_REL further from it than the plain.
TRAIN_GRAD_REL = 4e-2
TRAIN_LOSS_RTOL = 1e-3     # the loss of the two paths (bf16 forward)
TINY_TRAIN_SEQ = 16


def _train_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq, batch=batch, seed=seed)
    try:
        return {k: torch.as_tensor(v, device="cuda") for k, v in pipe.make_batch(0).items()}
    finally:
        pipe.close()


def _tiny_train() -> int:
    """reduced(granite-8b) with the same weights and batch on the CPU (plain
    versions) and on the card (flash_attention's forward, twice per layer
    under remat="block"): the loss and every gradient leaf of one
    value_and_grad (``_hold_grads``), then one train step's loss, within
    TRAIN_LOSS_RTOL; exact launches.  -> the card's launches."""
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_loss_fn, make_train_step, value_and_grad
    cfg = reduced(get_config("granite-8b"))
    tc = TrainConfig(remat="block")
    params = init_lm(torch.Generator().manual_seed(SEED), cfg)
    batch = {k: v.cpu() for k, v in _train_batch(cfg, 2, TINY_TRAIN_SEQ, SEED).items()}
    out, grads, launches = {}, {}, 0
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, copy=True), params)   # the step updates in place
        ops.reset_launch_counts()
        (loss, _), grads[dev] = value_and_grad(make_loss_fn(cfg, tc))(
            p, {k: v.to(dev) for k, v in batch.items()})
        _, _, _, m = make_train_step(cfg, tc, device=dev)(p, adamw.init_adam(p, tc), None, batch)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        want = {"flash_attention": 2 * 2 * cfg.num_layers} if dev == "cuda" else {}
        if counts != want:
            raise AssertionError(f"tiny_train {dev}: launches {counts}, expected {want}")
        launches += sum(counts.values())
        out[dev] = {"value_and_grad loss": float(loss), **{k: float(v) for k, v in m.items()}}
    rels = {k: abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
            for k in ("value_and_grad loss", "loss")}
    log(f"[tiny_train] reduced(granite-8b): cpu {out['cpu']}, cuda {out['cuda']}; losses "
        f"{rels} apart (limit {TRAIN_LOSS_RTOL})")
    if not max(rels.values()) <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"tiny_train: the card's losses are {rels} off the CPU's")

    def witness():
        return value_and_grad(make_loss_fn(cfg, tc))(_f32_params(params), batch)[1]
    _hold_grads("tiny_train card vs cpu", grads["cuda"], grads["cpu"], witness)
    return launches


def _train_full(card: str) -> int:
    """(a) 36 layers, Q8_0 moments, remat="block", 1 x 512 tokens, 3 steps
    on one batch: the loss falls at every step, the parameters change, 72
    flash_attention launches a step; step time, device time, peak."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.qlinear import param_count
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = get_config("granite-8b")
    tc = TrainConfig(quantized_moments=True, remat="block", lr=TRAIN_LR)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, comp = init_train_state(torch.Generator(device="cuda").manual_seed(SEED),
                                         cfg, tc, init_lm)
    torch.cuda.synchronize()
    log(f"[full_train] granite-8b {cfg.num_layers} layers: {param_count(params) / 1e9:.2f} B "
        f"parameters, init with Q8_0 moments {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    batch = _train_batch(cfg, 1, TRAIN_SEQ, SEED + 61)
    step = make_train_step(cfg, tc, device="cuda")
    watch = {"layer 0 wq": params["layers"][0]["attn"]["wq"].w,
             "layer 35 down": params["layers"][-1]["mlp"]["down"].w,
             "final norm": params["final_norm"]["g"], "head": params["lm_head"].w}
    before = {k: v[:64].clone() for k, v in watch.items()}
    losses, times, launches, total = [], [], 2 * cfg.num_layers, 0
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        params, opt, comp, m = step(params, opt, comp, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        if counts != {"flash_attention": launches}:
            raise AssertionError(f"full_train step {i}: launches {counts}, expected "
                                 f"{launches} flash_attention")
        total += counts["flash_attention"]
        losses.append(float(m["loss"]))
        log(f"[full_train] step {i}: loss {losses[-1]:.4f}, grad_norm "
            f"{float(m['grad_norm']):.4f}, {times[-1]:.2f} s")
    changed = {k: not torch.equal(watch[k][:64], before[k]) for k in watch}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[full_train] granite-8b 36 layers, 1 x {TRAIN_SEQ}, Q8_0 moments, remat=block, "
        f"lr {TRAIN_LR}: "
        f"losses {losses}; parameters changed {changed}; {launches} flash_attention launches "
        f"a step; step {1e3 * min(times[1:]):.1f} ms synchronised; peak {peak:.2f} GB "
        f"(reckoned {TRAIN_RECKON_GB} GB + temporaries); {card}")
    if not (all(b < a for a, b in zip(losses, losses[1:])) and all(changed.values())
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"full_train: the loss did not fall at every step {losses}, or "
                             f"a parameter did not change {changed}")
    _profile("granite-8b train step (36 layers, 1 x 512)",
             lambda: step(params, opt, comp, batch))
    del params, opt, comp, step
    gc.collect()
    torch.cuda.empty_cache()
    return total


def _leaf_rel(got, want) -> list:
    """Per leaf: max|got - want| / max|want| (``want`` moved to ``got``'s
    device)."""
    from repro_torch.core.tree import tree_leaves
    out = []
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        b = b.to(a.device).float()
        out.append(((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item())
    return out


def _hold_grads(label: str, got, plain, witness) -> float:
    """Every gradient leaf of the kernel path ``got`` against the plain
    path's ``plain`` within TRAIN_GRAD_REL of the leaf's largest |value|;
    where a leaf is not, both are held to the f32 gradients ``witness()``
    and ``got`` may be no more than TRAIN_GRAD_REL further from them than
    ``plain``.  -> the worst leaf's relative difference."""
    rels = _leaf_rel(got, plain)
    worst = max(rels)
    log(f"[full_train] {label}: {len(rels)} gradient leaves, max|diff| / max|plain| up to "
        f"{worst:.3e} (limit {TRAIN_GRAD_REL})")
    if worst <= TRAIN_GRAD_REL:
        return worst
    wide = witness()
    k_far, p_far = _leaf_rel(got, wide), _leaf_rel(plain, wide)
    del wide
    bad = [i for i, (a, b) in enumerate(zip(k_far, p_far)) if a > b + TRAIN_GRAD_REL]
    log(f"[full_train] {label} f32 witness: kernel path up to {max(k_far):.3e}, plain up to "
        f"{max(p_far):.3e} from its gradients")
    if bad:
        raise AssertionError(f"{label}: gradient leaves {bad} of the kernel path are more "
                             f"than {TRAIN_GRAD_REL} further from the f32 gradient than the "
                             "plain path's")
    return worst


def _train_cut(card: str) -> int:
    """(b) 4 layers at full width, 2 x 512: the kernel path's loss and
    every gradient leaf against the all-plain path's; launches exact under
    remat "none" and "block"; one step each with microbatch=1, gradient
    compression and f32 moments, all finite."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import adamw, compression
    from repro_torch.train.train_step import make_loss_fn, make_train_step, value_and_grad
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=TRAIN_CUT)
    params = init_lm(torch.Generator(device="cuda").manual_seed(SEED + 2), cfg)
    batch = _train_batch(cfg, TRAIN_CUT_BATCH, TRAIN_SEQ, SEED + 63)
    total = 0
    grads = {}
    for remat in ("none", "block"):
        fn = value_and_grad(make_loss_fn(cfg, TrainConfig(remat=remat)))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        (loss, _), g = fn(params, batch)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        want = TRAIN_CUT * (1 if remat == "none" else 2)
        if counts != {"flash_attention": want}:
            raise AssertionError(f"full_train cut remat={remat}: launches {counts}, expected "
                                 f"{want} flash_attention")
        total += counts["flash_attention"]
        grads[remat] = (loss, g)
    same = sum(torch.equal(a, b) for a, b in zip(tree_leaves(grads["none"][1]),
                                                 tree_leaves(grads["block"][1])))
    n_leaves = len(tree_leaves(params))
    ops.reset_launch_counts()
    with _PlainOps():
        (p_loss, _), p_grads = value_and_grad(make_loss_fn(cfg, TrainConfig(remat="none")))(
            params, batch)
    if any(ops.launch_counts().values()):
        raise AssertionError("full_train cut: the plain path launched flash_attention")
    k_loss, k_grads = grads["none"]
    loss_rel = abs(k_loss.item() - p_loss.item()) / abs(p_loss.item())
    log(f"[full_train] 4 layers, 2 x {TRAIN_SEQ}: loss kernel {k_loss.item():.5f} plain "
        f"{p_loss.item():.5f} ({loss_rel:.2e}, limit {TRAIN_LOSS_RTOL}); remat block vs "
        f"none: {same} of {n_leaves} gradient leaves bit-equal")
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"full_train cut: loss {k_loss.item()} vs plain {p_loss.item()}")

    def witness():
        with _PlainOps():
            return value_and_grad(make_loss_fn(cfg, TrainConfig(remat="none")))(
                _f32_params(params), batch)[1]
    _hold_grads(f"4 layers, 2 x {TRAIN_SEQ}", k_grads, p_grads, witness)
    del grads, p_grads, k_grads
    for opts in (dict(microbatch=1), dict(grad_compression=True), dict()):
        tc = TrainConfig(remat="block", **opts)
        p = init_lm(torch.Generator(device="cuda").manual_seed(SEED + 2), cfg)
        opt = adamw.init_adam(p, tc)
        comp = compression.init_compression(p) if tc.grad_compression else None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        p, opt, comp, m = make_train_step(cfg, tc, device="cuda")(p, opt, comp, batch)
        torch.cuda.synchronize()
        nm = TRAIN_CUT_BATCH // tc.microbatch if tc.microbatch else 1
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        if counts != {"flash_attention": 2 * TRAIN_CUT * nm}:
            raise AssertionError(f"full_train cut {opts}: launches {counts}")
        total += counts["flash_attention"]
        finite = all(math.isfinite(float(m[k])) for k in ("loss", "grad_norm")) and all(
            torch.isfinite(t).all() for t in tree_leaves(p))
        log(f"[full_train] 4 layers {opts or 'f32 moments'}: loss {float(m['loss']):.4f} "
            f"grad_norm {float(m['grad_norm']):.4f}, {time.perf_counter() - t0:.2f} s, finite "
            f"{finite}; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if not finite:
            raise AssertionError(f"full_train cut {opts}: not finite")
        del p, opt, comp
        gc.collect()
        torch.cuda.empty_cache()
    return total


def _train_launcher(card: str) -> None:
    """(c) ``python -m repro_torch.launch.train --arch granite-8b --reduced
    --device cuda --steps 4 --ckpt-every 2`` into a temporary directory; a
    run stopped after step 2 and resumed reaches the same step-4
    parameters and optimizer state bit for bit; a rerun resumes at 4."""
    import tempfile
    common = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-8b",
              "--reduced", "--device", "cuda", "--batch", "4", "--seq", "64",
              "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(*args) -> str:
        t0 = time.perf_counter()
        res = subprocess.run(common + list(args), cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"full_train launch.train {args}: exit {res.returncode}\n"
                                 f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        log(f"[full_train] launch.train {' '.join(args[:2])}: "
            f"{time.perf_counter() - t0:.1f} s; {res.stdout.strip().splitlines()[-1]}")
        return res.stdout
    with tempfile.TemporaryDirectory() as tmp:
        whole, cut = os.path.join(tmp, "whole"), os.path.join(tmp, "cut")
        run("--steps", "4", "--ckpt-dir", whole)
        run("--steps", "2", "--ckpt-dir", cut)
        out = run("--steps", "4", "--ckpt-dir", cut)
        again = run("--steps", "4", "--ckpt-dir", whole)
        if "resumed at step 2" not in out or "resumed at step 4" not in again \
                or "step " in again.split("resumed at step 4")[1]:
            raise AssertionError("full_train launch.train: did not resume at steps 2 and 4")
        import numpy as np
        differ = []
        for name in ("params", "opt"):
            a = np.load(os.path.join(whole, "step_00000004", f"{name}.npz"))
            b = np.load(os.path.join(cut, "step_00000004", f"{name}.npz"))
            if a.files != b.files:
                raise AssertionError(f"full_train launch.train: {name} keys differ")
            differ += [f"{name}:{k}" for k in a.files if not np.array_equal(a[k], b[k])]
        log(f"[full_train] launch.train: stopped after step 2 and resumed, step 4 against the "
            f"uninterrupted run: {len(differ)} arrays differ {differ[:8]}; {card}")
        if differ:
            raise AssertionError(f"full_train launch.train: the resumed run's step 4 differs "
                                 f"from the uninterrupted run's in {differ[:8]}")


def phase_full_train(card: str) -> dict[str, int]:
    """tiny_train, then granite-8b's training at full width: (a) full depth
    with Q8_0 moments, (b) a 4-layer cut held to the all-plain path, (c)
    the launcher's checkpoint and resume on the card."""
    from repro_torch.kernels import ops
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    totals = {name: 0 for name in ops.KERNEL_MODULES}
    totals["flash_attention"] += _tiny_train()
    totals["flash_attention"] += _train_full(card)
    totals["flash_attention"] += _train_cut(card)
    _train_launcher(card)
    log(f"[full_train] phase {time.perf_counter() - t0:.1f} s; {card}")
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
                  lambda: phase_full_serving(card), lambda: phase_full_moe(card),
                  lambda: phase_full_asr(card), lambda: phase_full_ssm(card),
                  lambda: phase_full_vlm(card), lambda: phase_full_train(card)):
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
