"""Hold ``flash_decode`` to its plain version over many inputs, under
``chip_smoke.py``'s contiguous decode limit.

    python3 tools/decode_limit_sweep.py [--seeds 0-39] [--shared]

For each seed, a generator seeded with it draws ``chip_smoke``'s
``FLASH_DECODE_SHAPES + FLASH_DECODE_EDGE + ASR_FLASH_DECODE`` in order, as ``phase_kernels``
draws them from its ``flash_decode`` generator (whose seed is always among
the seeds).  ``--shared`` also draws them from one generator seeded
``SEED`` after the inputs of the ``flash_attention`` and quantized-matmul
cases, in ``phase_kernels``' order: the inputs of a run where all kernels
shared one generator.  Each case is held as ``chip_smoke`` holds it: within
ATTN_ABS + ATTN_REL * |plain|, plus ``ATTN_P_ROUND * max|v|`` of each row
for a case of at most ``FEW_KEYS`` keys, which must also be no more than
ATTN_ABS further than the plain version from an f64 softmax of the same
bf16 q, k, v (``chip_smoke.few_key_rule`` and ``few_key_excess``).  For every case that fails either check it prints by how much, both
versions' distances from the f64 softmax, and the excess the limit would
have without the few-key allowance.  The last line is a JSON object with
the cases checked and those that failed.  It needs one card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0-39", help="seeds, as 0-39,100")
    ap.add_argument("--shared", action="store_true",
                    help="also the inputs of one generator shared by all kernels")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import flash_decode as fd
    cs = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("decode_limit_sweep: no card")
    own = cs.SEED + cs.KERNEL_SEED_OFFSET["flash_decode"]
    runs = [(f"seed {s}", torch.Generator(device="cuda").manual_seed(s))
            for s in sorted(set(_seeds(args.seeds)) | {own})]
    if args.shared:
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        for b, h, sq, sk, d, _causal, _window in (cs.ATTN_SHAPES + cs.ATTN_LM_SHAPES
                                                  + cs.ATTN_EDGE):
            for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)):
                torch.randn(shape, generator=gen, device="cuda")
        for shapes, edges in ((cs.Q8_SHAPES, cs.Q8_EDGE), (cs.Q3K_SHAPES, cs.Q3K_EDGE),
                              (cs.Q4_SHAPES, cs.Q4_EDGE), (cs.W8A8_SHAPES, cs.W8A8_EDGE)):
            for m, n, k in shapes + edges:
                torch.randn((m, k), generator=gen, device="cuda")
                torch.randn((n, k), generator=gen, device="cuda")
        runs.append((f"shared seed {cs.SEED}", gen))
    checked, over, few = 0, [], 0
    for label, gen in runs:
        for case in cs.FLASH_DECODE_SHAPES + cs.FLASH_DECODE_EDGE + cs.ASR_FLASH_DECODE:
            q, k, v, kv_len, scale = cs.flash_decode_inputs(case, gen)
            out = fd.flash_decode(q, k, v, kv_len, scale=scale).float()
            ref = fd.flash_decode_ref(q, k, v, kv_len, scale=scale).float()
            checked += 1
            p_round, exact = cs.few_key_rule(q, k, v, kv_len.expand(q.shape[0]), scale)
            diff = (out - ref).abs()
            slack = diff - cs.ATTN_ABS - cs.ATTN_REL * ref.abs()
            excess_plain = slack.max().item()
            excess = (slack - p_round[:, None, None, None]).max().item()
            f64_excess, kern_f64, plain_f64 = (
                t.item() for t in cs.few_key_excess(out, ref, exact))
            if case[-1] <= cs.FEW_KEYS:
                few += 1
            else:
                f64_excess = float("-inf")
            if excess <= 0 and f64_excess <= 0:
                continue
            row = {"inputs": label, "case": case, "excess": excess,
                   "excess_without_p_round": excess_plain,
                   "f64_excess": f64_excess, "max_abs_err": diff.max().item(),
                   "kernel_from_f64": kern_f64, "plain_from_f64": plain_f64}
            over.append(row)
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    print(json.dumps({"checked": checked, "few_key_cases": few, "input_sets": len(runs),
                      "failed": len(over)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
