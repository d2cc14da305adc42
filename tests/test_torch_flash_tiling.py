"""The tile arithmetic of ``csrc/flash_attention.cu``, emulated on the CPU.

The CUDA kernel runs only on the card, so its arithmetic is pinned here
by a plain emulation of what each warp of it computes: the host's BQ
rule, the CTA's key range (``kstart``/``kend``), 64-key tiles, tiles
skipped per warp when wholly outside the mask and masks applied only on
tiles that cross Sk, the causal diagonal or the window's edge, the
running max, ``p = 2^(s * scale*log2(e) - m * scale*log2(e))``, the
unnormalised p rounded to bf16 before P.V, f32 accumulation and
``out = acc / l`` (0 where l = 0).  The emulation is held to the port's
plain version and to the JAX reference with the limits ``chip_smoke.py``
applies on the card.  A second check parses the kernel's head-dim
instantiations and holds them to the wrapper's ``MAX_HEAD_DIM`` and to
the head dims of the port's configs.
"""
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


ROOT = Path(__file__).resolve().parents[1]
KERNEL_SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BKV = 64             # keys per tile
NUM_SMS = 132        # H100 SXM
LOG2E = 1.4426950408889634


def _bq(bh: int, sq: int, sms: int) -> int:
    """The kernel's BQ rule: 128 rows when BH * ceil(Sq/128) CTAs cover
    every SM, else 64."""
    return 128 if bh * math.ceil(sq / 128) >= sms else 64


def emulate(q, k, v, *, causal, window=None, sms=NUM_SMS):
    """What the kernel computes, tile by tile.  q: (B,H,Sq,D), k/v:
    (B,H,Sk,D) bf16 -> (B,H,Sq,D) bf16."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    c = torch.tensor(abs(d ** -0.5) * LOG2E, dtype=torch.float32)
    qf = q.reshape(b * h, sq, d).float()
    kf = torch.nn.functional.pad(k.reshape(b * h, sk, d).float(), (0, 0, 0, BKV))
    vf = torch.nn.functional.pad(v.reshape(b * h, sk, d).float(), (0, 0, 0, BKV))
    out = torch.zeros((b * h, sq, d))
    bq = _bq(b * h, sq, sms)
    off = sk - sq
    w = window if window is not None else 0
    for q0 in range(0, sq, bq):
        kend = min(sk, min(q0 + bq, sq) + off) if causal else sk
        kstart = max(0, q0 + off - w + 1) if w > 0 else 0
        ntiles = -(-(kend - kstart) // BKV) if kend > kstart else 0
        for qw0 in range(q0, min(q0 + bq, sq), 16):      # the live warps
            rows = min(16, sq - qw0)
            qlo, qhi = qw0 + off, qw0 + rows - 1 + off
            qd = torch.arange(qw0, qw0 + rows)[:, None] + off
            m = torch.full((b * h, rows, 1), -math.inf)
            l = torch.zeros((b * h, rows, 1))
            acc = torch.zeros((b * h, rows, d))
            for it in range(ntiles):
                k0 = kstart + it * BKV
                if (causal and k0 > qhi) or (w > 0 and k0 + BKV - 1 <= qlo - w):
                    continue
                edge = (k0 + BKV > sk or (causal and k0 + BKV - 1 > qlo)
                        or (w > 0 and k0 <= qhi - w))
                s = qf[:, qw0:qw0 + rows] @ kf[:, k0:k0 + BKV].transpose(1, 2)
                if edge:
                    kp = torch.arange(k0, k0 + BKV)[None, :]
                    ok = kp < sk
                    if causal:
                        ok = ok & (kp <= qd)
                    if w > 0:
                        ok = ok & (kp > qd - w)
                    s = s.masked_fill(~ok, -math.inf)
                mx = torch.maximum(m, s.amax(-1, keepdim=True))
                mc = torch.where(mx == -math.inf, 0.0, mx * c)
                alpha = torch.exp2(m * c - mc)
                p = torch.exp2(s * c - mc)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, k0:k0 + BKV]
                m = mx
            out[:, qw0:qw0 + rows] = torch.where(l > 0, acc / l, 0.0)
    return out.reshape(b, h, sq, d).to(torch.bfloat16)


MASKS = {
    # name: (Sq, Sk, causal, window)
    "full_ragged": (100, 100, False, None),
    "causal": (129, 129, True, None),       # kend = 129: one key in tile 2
    "causal_window": (150, 150, True, 40),
    "window_only": (130, 130, False, 50),
    "sq_lt_sk": (40, 89, True, None),       # warp 0 sees key 64 alone
    "sq_gt_sk": (150, 70, True, None),      # rows with no key give 0
    "decode": (1, 77, False, None),
}


def _check(got, want) -> None:
    """chip_smoke's limit for the SD shapes, ATTN_ABS + ATTN_REL*|ref|
    (without the LM shapes' ATTN_P_ROUND term)."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - chip_smoke.ATTN_ABS
              - chip_smoke.ATTN_REL * want.float().abs()).max().item()
    assert excess <= 0, f"max|err| {diff.max().item()}; limit exceeded by {excess}"


def _inputs(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d))]


def _run(b, h, sq, sk, d, causal, window, sms=NUM_SMS):
    qn, kn, vn = _inputs(b, h, sq, sk, d, seed=d + sq + sk)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (qn, kn, vn))
    got = emulate(q, k, v, causal=causal, window=window, sms=sms)
    _check(got, tref.flash_attention_ref(q, k, v, causal=causal, window=window))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (qn, kn, vn))
    jwant = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    _check(got, torch.from_numpy(np.asarray(jwant, np.float32)))
    return got


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("d", [16, 40, 64, 80, 128, 160])
def test_tiling_matches_reference(d, mask):
    sq, sk, causal, window = MASKS[mask]
    got = _run(1, 2, sq, sk, d, causal, window)
    if mask == "sq_gt_sk":
        assert not got[:, :, :sq - sk].float().any()     # no key: 0


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_tiling_bq128_matches_reference(mask):
    """The 8-warp tile (BQ = 128), which the rule picks once the CTAs
    cover the SMs; here forced with one SM."""
    sq, sk, causal, window = MASKS[mask]
    _run(1, 2, sq, sk, 40, causal, window, sms=1)


def test_bq_rule_at_the_main_path_shapes():
    """64-row tiles where 128-row ones would leave SMs idle (UNet levels
    1/2/mid, CLIP, make_prefill), 128 at the UNet's level 0 and the
    lm_forward check."""
    want = {(16, 4096): 128, (16, 1024): 64, (16, 256): 64, (16, 64): 64,
            (24, 77): 64, (128, 128): 64, (128, 159): 128, (12, 1): 64}
    assert {key: _bq(*key, NUM_SMS) for key in want} == want


def _instantiated() -> set[int]:
    src = KERNEL_SRC.read_text()
    cases = re.findall(r"case (\d+): return launch<(\d+)>", src)
    assert cases and all(a == b for a, b in cases), cases
    return {int(a) for a, _ in cases}


def test_instantiations_cover_the_wrapper():
    """Every head dim the wrapper accepts pads to a DP the kernel is
    built for, and every DP is a multiple of 16 within MAX_HEAD_DIM."""
    dps = _instantiated()
    need = {(d + 15) // 16 * 16 for d in range(1, tfa.MAX_HEAD_DIM + 1)}
    assert need <= dps, sorted(need - dps)
    assert all(dp % 16 == 0 and dp <= tfa.MAX_HEAD_DIM for dp in dps), sorted(dps)


def test_config_head_dims_fit_the_kernel():
    """SD15 UNet 40/80/160, CLIP 64, Granite-8B 128, h2o-danube 120, the
    other LMs with attention layers and the TINY configs: each at most
    MAX_HEAD_DIM, padded to an instantiated DP.  (xlstm-1.3b's head_dim
    512 is an mLSTM head: no attention layer, so no flash_attention.)"""
    unet_hds = {cfg.model_channels * mult // cfg.num_heads
                for cfg in (configs.SD15_UNET, configs.TINY_UNET)
                for mult in cfg.channel_mult}
    lms = [cfg for cfg in map(configs.get_config, configs.ARCHS)
           if not cfg.attention_free]
    assert len(lms) == len(configs.ARCHS) - 1
    hds = (unet_hds | {configs.SD_TURBO.clip_cfg().hd, configs.TINY_CLIP.hd}
           | {cfg.hd for cfg in lms} | {configs.reduced(cfg).hd for cfg in lms})
    assert {40, 80, 160, 64, 128, 120} <= hds
    assert max(hds) <= tfa.MAX_HEAD_DIM, sorted(hds)
    assert {(hd + 15) // 16 * 16 for hd in hds} <= _instantiated()
