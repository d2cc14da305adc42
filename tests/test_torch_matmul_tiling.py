"""CPU emulation of the quantized matmuls' tile paths (M > 16).

``csrc/common.cuh``'s ``tile_kernel`` with ``csrc/q8_matmul.cu``'s
``Q8Tile``, ``csrc/q3k_matmul.cu``'s ``Q3KTile`` and ``csrc/q4_matmul.cu``'s
``Q4Tile`` runs only on the card.  Its arithmetic is pinned here:

* the weight unpacks, emulated bit by bit in numpy from the bytes the
  kernel copies (Q8_0's and Q4_0's codes and aligned scale words; Q3_K's
  ql and qh with its super-block's scale group and aligned d word, in
  bf16x2 pairs of neighbouring elements), over every finite fp16 scale,
  every 6-bit code and every code value, against the port's and the
  reference's dequantized bf16;
* the sums: the host's CTA rule, each CTA's 64-weight K steps and their
  four k16 products in order, rows past M and N and K past the end
  zero-filled as cp.async fills them, stores masked; held to the port's
  plain versions and to the JAX references with ``chip_smoke``'s limit;
* the swizzled tiles read through the wgmma descriptors as the 128-byte
  swizzle reads them, and the epilogue's accumulator layout, through an
  emulated wgmma m64nNk16;
* the slot hand-over between the producer and mma warps (named barriers
  FULL, EMPTY and PROD): no deadlock and no slot refilled before use.

Guards parse the tile constants, the instantiations, the CTA rule's order
and the formats' slot sizes from the sources, and hold the shared memory
of every instantiation to the H100's 227 KB.
"""
import importlib.util
import math
import random
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

NUM_SMS = 132                  # H100 SXM
SMEM_MAX = 232448              # bytes of shared memory a block may use (227 KB)
# The CTA rule's tiles: (BM, BN, producer threads), the least M each
# takes and its measured rate (TILE_RATE_*, GFLOP/s per SM).
TILES = [(256, 128, 256), (128, 128, 256), (128, 64, 256), (64, 64, 256)]
MIN_M = [129, 65, 65, 1]
RATES = {"TILE_RATE_256x128": 3530, "TILE_RATE_128x128": 2580, "TILE_RATE_128x64": 1720,
         "TILE_RATE_64x64": 970}
TILE = {"TILE_BK": 64, "TILE_MMA_WARPS": 8, "TILE_STAGES": 4, "TILE_LEAD": 2,
        "TILE_SMEM_MAX": SMEM_MAX, **RATES}
BK = TILE["TILE_BK"]

D16 = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
D16 = D16[np.isfinite(D16)]       # every finite fp16 scale


def _constants(path: Path) -> dict[str, int]:
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (\w+) = (\d+);", path.read_text())}


def cta_tile(m: int, n: int, sms: int = NUM_SMS) -> tuple[int, ...]:
    """tile_launch's rule: the tile (that M reaches) whose waves of one CTA
    per SM take the least time, a wave's time BM * BN over its rate; ties
    go to the larger tile."""
    best, tile = None, None
    for t, least, rate in zip(TILES, MIN_M, RATES.values()):
        if m < least:
            continue
        ctas = math.ceil(m / t[0]) * math.ceil(n / t[1])
        cost = -(-ctas // sms) * (t[0] * t[1] * 100000 // rate)
        if best is None or cost < best:
            best, tile = cost, t
    return tile


def ring(bm: int, bn: int, raw: int, extra: int) -> tuple[int, int, int]:
    """Tile's SLOT (rounded up to 1024 bytes), STAGES and AHEAD."""
    slot = -(-(bm * BK * 2 + bn * BK * 2 + raw) // 1024) * 1024
    stages = TILE["TILE_STAGES"] if TILE["TILE_STAGES"] * slot + extra <= SMEM_MAX else 3
    return slot, stages, stages - TILE["TILE_LEAD"]


# ------------------------------------------------------ bit-level arithmetic

def _bf16(v) -> np.ndarray:
    """bf16 bits of ``v`` rounded once, half to even, from its exact value."""
    m, e = np.frexp(np.asarray(v, np.float64))
    r = np.ldexp(np.rint(np.ldexp(m, 8)), e - 8)
    return (r.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _f(bits) -> np.ndarray:
    """float64 value of bf16 bits."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(np.float64)


def _magic(code, minus: float) -> np.ndarray:
    """f32 (0x4B000000 | code) - minus."""
    v = (np.uint32(0x4B000000) | code.astype(np.uint32)).view(np.float32)
    return v - np.float32(minus)


def _scale_words(d: np.ndarray) -> np.ndarray:
    """d (fp16, any shape) as the aligned 32-bit words the kernel copies."""
    flat = d.astype(np.float16).view(np.uint16).ravel()
    return np.concatenate([flat, np.zeros(flat.size % 2, np.uint16)]).view(np.uint32)


def _half(words: np.ndarray, e: np.ndarray) -> np.ndarray:
    """f32 value of fp16 element e, the half of its aligned word that e's
    parity names."""
    h = (words[e >> 1] >> (np.uint32(16) * (e & 1).astype(np.uint32))) & np.uint32(0xFFFF)
    return h.astype(np.uint16).view(np.float16).astype(np.float32)


def q8_tile_route(qs: np.ndarray, d: np.ndarray) -> np.ndarray:
    """bf16 bits (N, K) that Q8Tile::unpack writes: per code word xor
    0x80808080, each byte under 0x4B, minus 2^23 + 128, times the scale
    taken from its aligned word, in f32; cvt.rn to bf16."""
    n, k = qs.shape
    nblk = k // 32
    e = np.arange(n)[:, None] * nblk + np.arange(nblk)[None, :]
    dw = np.repeat(_half(_scale_words(d), e), 8, axis=1)                 # per word
    u = np.ascontiguousarray(qs).view(np.uint32) ^ np.uint32(0x80808080)
    out = np.empty((n, k // 4, 4), np.uint16)
    for b in range(4):
        q = _magic((u >> np.uint32(8 * b)) & np.uint32(0xFF), 8388736.0)
        out[:, :, b] = _bf16(q * dw)
    return out.reshape(n, k)


def q4_tile_route(qs: np.ndarray, d: np.ndarray) -> np.ndarray:
    """bf16 bits (N, K) that Q4Tile::unpack writes: per code word lo and hi
    = lo >> 4, pair p (elements 2p, 2p + 1 of the word) the byte permute of
    lo's byte p and hi's byte p to bits 0 and 16, masked 0x000F000F, under
    0x4300 and minus 136 in bf16; d from its aligned word, dh = d cut to
    bf16 toward zero, dl = d - dh with d's sign; fma.rn(q, dh, q * dl)."""
    n, kh = qs.shape
    nblk = kh // 16
    e = np.arange(n)[:, None] * nblk + np.arange(nblk)[None, :]
    d32 = np.repeat(_half(_scale_words(d), e), 4, axis=1)             # per word
    dh = (d32.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    dl = np.copysign(d32 - dh, d32)                                    # exact in f32
    dhb, dlb = _f(_bf16(dh)), _f(_bf16(dl))
    assert np.array_equal(dhb, dh) and np.array_equal(dlb, dl)         # exact in bf16
    lo = np.ascontiguousarray(qs).view(np.uint32)
    hi = lo >> np.uint32(4)
    out = np.empty((n, kh // 4, 8), np.uint16)
    for p in range(4):
        sh = np.uint32(8 * p)
        perm = ((lo >> sh) & np.uint32(0xFF)) | (((hi >> sh) & np.uint32(0xFF)) << np.uint32(16))
        bits = (perm & np.uint32(0x000F000F)) | np.uint32(0x43004300)
        for h in range(2):
            q = _f(_bf16(_f((bits >> np.uint32(16 * h)) & np.uint32(0xFFFF)) - 136.0))
            out[:, :, 2 * p + h] = _bf16(q * dhb + _f(_bf16(q * dlb)))
    return out.reshape(n, 2 * kh)


def _pair(bits, c, eh, el) -> list[np.ndarray]:
    """Q3KTile::pair per half: q = bits - c, bf16(q * eh + bf16(q * el))."""
    out = []
    for h in range(2):
        v = (bits >> np.uint32(16 * h)) & np.uint32(0xFFFF)
        q = _f(_bf16(_f(v) - c[h]))
        out.append(_bf16(q * eh[h] + _f(_bf16(q * el[h]))))
    return out


def q3k_tile_route(ql, qh, scales, d) -> np.ndarray:
    """bf16 bits (N, K) that Q3KTile::unpack writes, from the bytes a slot
    holds: step k's ql word j and qh half-word j (sub-block 4(k%4) + j),
    scale group k%4 funnel-shifted out of the super-block's three words,
    d from its aligned word; per chunk h2 and ql byte b, X = the byte in
    both halves, Y = hb | hb << 17 shifted by 2 - 4b, pairs (0, 1) at P =
    (0, 2) and (2, 3) at P = (2, 4) of X >> 2."""
    n, kq = ql.shape
    k = 4 * kq
    nsb, nst = k // 256, k // BK
    qlw = np.ascontiguousarray(ql).view(np.uint32).reshape(n, nst, 4)
    qhh = np.ascontiguousarray(qh).view(np.uint16).reshape(n, nst, 4).astype(np.uint32)
    scw = np.ascontiguousarray(scales).reshape(n, nsb, 12).view(np.uint32)
    st = np.arange(nst)
    q4, sb = st & 3, st >> 2
    sw = (3 * q4) >> 2
    lo = scw[:, sb, sw].astype(np.uint64)
    hi = scw[:, sb, np.where(sw < 2, sw + 1, sw)].astype(np.uint64)
    grp = (((hi << np.uint64(32)) | lo) >> (8 * ((3 * q4) & 3)).astype(np.uint64)).astype(np.uint32)
    code = (grp[..., None] >> (6 * np.arange(4, dtype=np.uint32))) & np.uint32(63)
    e = np.arange(n)[:, None] * nsb + sb[None, :]
    eff = _magic(code, 8388640.0) * _half(_scale_words(d), e)[..., None]   # (n, nst, 4)
    eh = _f(_bf16(eff))
    el = _f(_bf16(eff - eh.astype(np.float32)))
    pairs = {0: ((132.0, 144.0), (1.0, 0.25)), 1: ((144.0, 192.0), (0.25, 0.0625))}
    out = np.empty((n, nst, 4, 2, 4, 2), np.uint16)       # step, unit, chunk, word, half
    for h2 in range(2):
        y = ((qhh >> np.uint32(8 * h2)) & np.uint32(0xFF)) * np.uint32(0x20001)
        for b in range(2):
            byte = (qlw >> np.uint32(8 * (2 * h2 + b))) & np.uint32(0xFF)
            x = byte | (byte << np.uint32(16))
            ys = y << np.uint32(2) if b == 0 else y >> np.uint32(2)
            words = [(x & np.uint32(0x000C0003)) | (ys & np.uint32(0x00100004)),
                     ((x >> np.uint32(2)) & np.uint32(0x0030000C)) | (ys & np.uint32(0x00400010))]
            for p, bits in enumerate(words):
                c, sc = pairs[p]
                v = _pair(bits | np.uint32(0x43004300), c,
                          [eh * s for s in sc], [el * s for s in sc])
                for h in range(2):
                    out[:, :, :, h2, 2 * b + p, h] = v[h]
    return out.reshape(n, k)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _assert_same(got, want, exact: bool) -> int:
    """The same bf16 bits, or (``exact`` False) both zeros: a zero weight's
    sign may differ, which moves no sum."""
    diff = got != want
    if not exact:
        diff &= ((got & 0x7FFF) != 0) | ((want & 0x7FFF) != 0)
    assert not diff.any(), (f"{int(diff.sum())} weights differ, e.g. "
                            f"{got[diff][:4]} vs {want[diff][:4]}")
    return got.size


# ------------------------------------------------- exhaustive unpack checks

def test_q8_tile_unpack_is_exact_for_every_scale():
    """Every finite fp16 d x every q in [-128, 127], with the scale taken
    from the aligned word by parity (an odd block count, 9, puts a row's
    scales in both halves and words across rows): bf16(q * d) bit for
    bit."""
    checked = 0
    codes = np.arange(-128, 128, dtype=np.int8)
    for d in np.split(D16, 4):
        qs = np.tile(np.concatenate([codes, codes[:32]]), (len(d), 1))    # 9 blocks
        ds = np.repeat(d[:, None], 9, axis=1)
        ds[:, 1::2] = -ds[:, 1::2]
        got = q8_tile_route(qs, ds)
        want = tq.dequantize_q8_0(tq.Q8_0Tensor(torch.from_numpy(qs), torch.from_numpy(ds)),
                                  torch.bfloat16)
        jwant = jq.dequantize_q8_0(jq.Q8_0Tensor(jnp.asarray(qs), jnp.asarray(ds)), jnp.bfloat16)
        _assert_same(got, _bits(want), exact=True)
        checked += _assert_same(got, _bits(jwant), exact=True)
    assert checked == len(D16) * 288


def test_q4_tile_unpack_is_exact_for_every_scale():
    """Every finite fp16 d x every code 0..15 at both nibbles of a byte,
    with the scale taken from the aligned word by parity (an odd block
    count, 9, puts a row's scales in both halves and words across rows)
    and d's sign flipped on odd blocks: bf16((q - 8) * d) bit for bit,
    signed zeros included."""
    checked = 0
    codes = torch.arange(16, dtype=torch.uint8)
    row = torch.cat([codes, codes.flip(0)]).repeat(9)                  # 9 blocks, each code twice
    for d in np.split(D16, 4):
        qs = tq.pack_q4(row.repeat(len(d), 1)).numpy()
        ds = np.repeat(d[:, None], 9, axis=1)
        ds[:, 1::2] = -ds[:, 1::2]
        got = q4_tile_route(qs, ds)
        want = tq.dequantize_q4_0(tq.Q4_0Tensor(torch.from_numpy(qs), torch.from_numpy(ds)),
                                  torch.bfloat16)
        jwant = jq.dequantize_q4_0(jq.Q4_0Tensor(jnp.asarray(qs), jnp.asarray(ds)), jnp.bfloat16)
        _assert_same(got, _bits(want), exact=True)
        checked += _assert_same(got, _bits(jwant), exact=True)
    assert checked == len(D16) * 288


def test_q3k_tile_unpack_is_exact_for_every_scale():
    """Every finite fp16 d x every 6-bit code x every q in [-4, 3] at every
    position of a ql byte and a chunk: bf16(q * d * (sc - 32)) bit for bit
    but for the sign of a zero."""
    checked = 0
    codes = torch.arange(64, dtype=torch.uint8).reshape(4, 16)        # 4 super-blocks
    e = torch.arange(1024)
    qu = ((e + 3 * (e // 16)) % 8).to(torch.uint8)                    # each position, each q
    for d in np.split(D16, 8):
        n = len(d)
        ql, qh = tq.pack_q3(qu.repeat(n, 1))
        sc = tq.pack_scales6(codes.expand(n, 4, 16))
        ds = np.repeat(d[:, None], 4, axis=1)
        got = q3k_tile_route(ql.numpy(), qh.numpy(), sc.numpy(), ds)
        want = tq.dequantize_q3_k(tq.Q3KTensor(ql, qh, sc, torch.from_numpy(ds)), torch.bfloat16)
        jwant = jq.dequantize_q3_k(jq.Q3KTensor(*(jnp.asarray(a) for a in (
            ql.numpy(), qh.numpy(), sc.numpy(), ds))), jnp.bfloat16)
        _assert_same(got, _bits(want), exact=False)
        checked += _assert_same(got, _bits(jwant), exact=False)
    assert checked == len(D16) * 1024


# ------------------------------------------------------------ tile sums

def _tile_sums(x: torch.Tensor, w: np.ndarray, m: int, n: int, sms: int) -> torch.Tensor:
    """tile_kernel's sums: x (M, Kx) bf16 and w (Npad, nsteps * 64) f32 the
    unpacked tiles (rows past N from zero bytes).  Each CTA of the rule's
    tile sums its K steps' four k16 products in order; stores are masked."""
    bm, bn = cta_tile(m, n, sms)[:2]
    nsteps = w.shape[1] // BK
    grid_m, grid_n = math.ceil(m / bm), math.ceil(n / bn)
    xf = torch.zeros((grid_m * bm, nsteps * BK))
    xf[:m, :x.shape[1]] = x.float()                   # cp.async zero-fills rows and K past the end
    wf = torch.zeros((grid_n * bn, nsteps * BK))
    wf[:w.shape[0]] = torch.from_numpy(w.astype(np.float32))
    y = torch.full((m, n), float("nan"))
    for by in range(grid_m):
        for bx in range(grid_n):
            xs, ws = xf[by * bm:(by + 1) * bm], wf[bx * bn:(bx + 1) * bn]
            acc = torch.zeros((bm, bn))
            for ks in range(0, nsteps * BK, 16):
                acc = acc + xs[:, ks:ks + 16] @ ws[:, ks:ks + 16].t()
            rows, cols = min(bm, m - by * bm), min(bn, n - bx * bn)
            y[by * bm:by * bm + rows, bx * bn:bx * bn + cols] = acc[:rows, :cols]
    assert not torch.isnan(y).any()
    return y


def emulate_q8(x: torch.Tensor, w: tq.Q8_0Tensor, sms: int = NUM_SMS) -> torch.Tensor:
    """What the Q8_0 tile path computes for x (M, K stored) bf16."""
    m, kdim = x.shape
    n = w.qs.shape[0]
    nsteps = -(-kdim // BK)
    qs = np.zeros((n, nsteps * BK), np.int8)           # blocks past K / 32: zero bytes
    qs[:, :kdim] = w.qs.numpy()
    d = np.zeros((n, nsteps * 2), np.float16)
    d[:, :kdim // 32] = w.d.numpy()
    # The kernel takes each scale from the aligned word of the unpadded
    # (N, K/32) array; past K/32 the copy is zero-filled.
    bits = q8_tile_route(qs, d)
    ref_bits = q8_tile_route(w.qs.numpy(), w.d.numpy())
    assert np.array_equal(bits[:, :kdim], ref_bits)
    return _tile_sums(x, _f(bits), m, n, sms)


def emulate_q4(x: torch.Tensor, w: tq.Q4_0Tensor, sms: int = NUM_SMS) -> torch.Tensor:
    """What the Q4_0 tile path computes for x (M, K stored) bf16: codes
    past K / 32 are zero bytes with scale 0 (weight -8 * 0)."""
    m, kdim = x.shape
    n = w.qs.shape[0]
    nsteps = -(-kdim // BK)
    qs = np.zeros((n, nsteps * BK // 2), np.uint8)
    qs[:, :kdim // 2] = w.qs.numpy()
    d = np.zeros((n, nsteps * 2), np.float16)
    d[:, :kdim // 32] = w.d.numpy()
    bits = q4_tile_route(qs, d)
    assert np.array_equal(bits[:, :kdim], q4_tile_route(w.qs.numpy(), w.d.numpy()))
    assert not (_f(bits[:, kdim:]) != 0).any()
    return _tile_sums(x, _f(bits), m, n, sms)


def emulate_q3k(x: torch.Tensor, w: tq.Q3KTensor, sms: int = NUM_SMS) -> torch.Tensor:
    """What the Q3_K tile path computes for x (M, K) bf16."""
    m = x.shape[0]
    n = w.ql.shape[0]
    bits = q3k_tile_route(w.ql.numpy(), w.qh.numpy(), w.scales.numpy(), w.d.numpy())
    # Rows past N are copied as zero bytes: q = -4 times eff = 0.
    pad = q3k_tile_route(*(np.zeros((2, *a.shape[1:]), a.dtype) for a in (
        w.ql.numpy(), w.qh.numpy(), w.scales.numpy())), np.zeros((2, w.d.shape[1]), np.float16))
    assert not (_f(pad) != 0).any()
    return _tile_sums(x, _f(bits), m, n, sms)


def _weights(n, k, seed):
    rng = np.random.default_rng(seed)
    w = np.abs(rng.standard_normal((n, k))) * k ** -0.5     # lopsided blocks
    w[:, ::7] *= -3.0
    return w.astype(np.float32)


def _x(m, k):
    return torch.from_numpy(np.random.default_rng(m * 7 + k).standard_normal((m, k))
                            .astype(np.float32)).to(torch.bfloat16)


def _check(got, wants) -> None:
    for want in wants:
        want = torch.from_numpy(np.array(want, np.float32))
        err = (got - want).abs().max().item()
        assert err <= chip_smoke.MATMUL_RTOL * max(1.0, want.abs().max().item()), err


# (M, N, SMs) -> the rule's tile: each tile at these small sizes.
RULE_CASES = {(256, 70, 1): (256, 128), (129, 70, 1): (256, 128), (128, 70, 1): (128, 128),
              (256, 100, 2): (128, 128), (256, 100, 4): (128, 64), (129, 100, 4): (128, 64),
              (256, 100, 132): (64, 64)}
Q8_CASES = [(m, n, k, NUM_SMS) for m in (17, 64, 129, 256)
            for n, k in ((70, 96), (100, 128), (70, 1152), (100, 100))] + [
    (m, n, 96, sms) for (m, n, sms) in RULE_CASES]
Q3K_CASES = [(m, n, k, NUM_SMS) for m in (17, 64, 129, 256)
             for n, k in ((70, 256), (100, 512), (70, 2560))] + [
    (m, n, 512, sms) for (m, n, sms) in RULE_CASES]


def test_rule_cases_take_each_tile():
    assert {(m, n, sms): cta_tile(m, n, sms)[:2] for m, n, sms in RULE_CASES} == RULE_CASES
    assert set(RULE_CASES.values()) == {t[:2] for t in TILES}


@pytest.mark.parametrize("m,n,k,sms", Q8_CASES)
def test_q8_tile_path_matches_references(m, n, k, sms):
    """K = 96: a half last step; K = 100: a tail-padded weight, x
    zero-padded to the stored K as ``ops`` does; K = 1152: 18 steps."""
    w = _weights(n, k, m * 1000 + n + k)
    x = _x(m, k)
    tw = tq.quantize_q8_0(torch.from_numpy(w))
    jw = jq.quantize_q8_0(jnp.asarray(w))
    got = emulate_q8(F.pad(x, (0, tw.qs.shape[1] - k)), tw, sms)
    _check(got, [tref.q8_matmul_ref(x, tw),
                 jref.q8_matmul_ref(jnp.asarray(x.float().numpy(), jnp.bfloat16), jw)])


@pytest.mark.parametrize("m,n,k,sms", Q8_CASES)
def test_q4_tile_path_matches_references(m, n, k, sms):
    """Q8_0's cases: each tile of the CTA rule, ragged M and N, K = 96 (a
    half last step), K = 100 (a tail-padded weight, x zero-padded to the
    stored K as ``ops`` does), K = 1152 (18 steps)."""
    w = _weights(n, k, m * 1000 + n + k + 1)
    x = _x(m, k)
    tw = tq.quantize_q4_0(torch.from_numpy(w))
    jw = jq.quantize_q4_0(jnp.asarray(w))
    got = emulate_q4(F.pad(x, (0, tw.qs.shape[1] * 2 - k)), tw, sms)
    _check(got, [tref.q4_matmul_ref(x, tw),
                 jref.q4_matmul_ref(jnp.asarray(x.float().numpy(), jnp.bfloat16), jw)])


@pytest.mark.parametrize("m,n,k,sms", Q3K_CASES)
def test_q3k_tile_path_matches_references(m, n, k, sms):
    """K = 256: four steps of one super-block; K = 2560: 40 steps."""
    w = _weights(n, k, m * 1000 + n + k)
    x = _x(m, k)
    tw = tq.quantize_q3_k(torch.from_numpy(w))
    jw = jq.quantize_q3_k(jnp.asarray(w))
    got = emulate_q3k(x, tw, sms)
    _check(got, [tref.q3k_matmul_ref(x, tw),
                 jref.q3k_matmul_ref(jnp.asarray(x.float().numpy(), jnp.bfloat16), jw)])


# ------------------------------------------------------ wgmma and epilogue

def _swz(r, c):
    return r * BK + ((c ^ (r & 7)) << 3)


def _sw128_read(tile: np.ndarray, start: int, rows: int) -> np.ndarray:
    """The (rows x 16) bf16 operand a K-major 128-byte-swizzle descriptor
    with start byte ``start`` (in a 1024-aligned tile) reads: row r, element
    k at start + 128 r + 2 k (8-row groups 1024 bytes apart), address bits
    4..6 xor-ed with bits 7..9."""
    out = np.empty((rows, 16))
    for r in range(rows):
        for k in range(16):
            addr = start + 128 * r + 2 * k
            addr ^= ((addr >> 7) & 7) << 4
            out[r, k] = tile[addr // 2]
    return out


@pytest.mark.parametrize("bm,bn,np_", TILES)
def test_wgmma_operands_and_epilogue_follow_the_layout(bm, bn, np_):
    """The slot's x and weight tiles, stored by tile_swz, read back through
    the kernel's descriptors (start + 64-row blocks + 32 bytes per k16 step)
    as wgmma's swizzled K-major operands, multiplied per warpgroup, and
    placed by the epilogue's (row, col) mapping of the wgmma accumulator
    layout, give the tile's product."""
    rng = np.random.default_rng(bm + bn)
    xt = rng.integers(-4, 5, (bm, BK)).astype(np.float64)
    wtile = rng.integers(-4, 5, (bn, BK)).astype(np.float64)
    xs, ws = np.zeros(bm * BK), np.zeros(bn * BK)
    for r in range(bm):
        for c in range(8):
            xs[_swz(r, c):_swz(r, c) + 8] = xt[r, 8 * c:8 * c + 8]
    for r in range(bn):
        for c in range(8):
            ws[_swz(r, c):_swz(r, c) + 8] = wtile[r, 8 * c:8 * c + 8]
    split_m = bm >= 128
    wgm, wgn = (bm // 128, bn) if split_m else (1, bn // 2)
    y = np.full((bm, bn), np.nan)
    for wg in range(2):
        row0, col0 = (wg * wgm * 64, 0) if split_m else (0, wg * wgn)
        for i in range(wgm):
            d = sum(_sw128_read(xs, 128 * (row0 + 64 * i) + 32 * kk, 64)
                    @ _sw128_read(ws, 128 * col0 + 32 * kk, wgn).T for kk in range(BK // 16))
            for lane in range(128):                  # the warpgroup's threads
                w, gid, tig = lane // 32, (lane % 32) >> 2, lane & 3
                # PTX's m64nNk16 accumulator: register 4j + q holds row 16w + gid
                # + 8 (q // 2), column 8j + 2 tig + q % 2.
                acc = [d[16 * w + gid + 8 * (q % 4 // 2), 8 * (q // 4) + 2 * tig + q % 2]
                       for q in range(wgn // 2)]
                for h in range(2):                   # the kernel's epilogue
                    r = row0 + 64 * i + 16 * w + gid + 8 * h
                    for j in range(wgn // 8):
                        c = col0 + 8 * j + 2 * tig
                        assert np.isnan(y[r, c:c + 2]).all()
                        y[r, c:c + 2] = acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]
    np.testing.assert_array_equal(y, xt @ wtile.T)


def test_swizzle_spreads_the_unpack_stores_over_the_banks():
    """The unpack's 16-byte stores of a quarter-warp (two rows, chunks 2j
    (+1) for j = 0..3) hit 8 distinct 16-byte bank groups."""
    for r0 in range(0, 128, 2):
        for h in range(2):
            groups = {(_swz(r0 + (i >> 2), 2 * (i & 3) + h) * 2 // 16) % 8 for i in range(8)}
            assert len(groups) == 8


# ------------------------------------------------------- slot hand-over

def _simulate_ring(nsteps: int, stages: int, ahead: int, seed: int) -> None:
    """The producers (one agent: PROD keeps them in step) and the mma warps
    run in a random interleaving over the named barriers; every slot must
    hold the step its reader expects, and both sides must finish."""
    rnd = random.Random(seed)
    slot = [None] * stages                      # step whose x/raw/weights are in each slot
    full = [0] * stages                         # FULL generations the producers arrived at
    empty = [0] * stages                        # EMPTY generations the mma warps arrived at

    def producer():
        def load(k):
            if k < nsteps:
                if k >= stages:
                    while empty[k % stages] < (k - stages) // stages + 1:
                        yield
                    assert slot[k % stages] == ("read", k - stages)
                slot[k % stages] = ("copied", k)
            yield
        for k in range(ahead):
            yield from load(k)
        for k in range(nsteps):
            yield from load(k + ahead)
            assert slot[k % stages] == ("copied", k)
            slot[k % stages] = ("full", k)
            full[k % stages] += 1
            yield

    def consumer():
        for k in range(nsteps):
            while full[k % stages] < k // stages + 1:
                yield
            assert slot[k % stages] == ("full", k)
            slot[k % stages] = ("read", k)
            if k + stages < nsteps:
                empty[k % stages] += 1
            yield

    agents = [producer(), consumer()]
    for _ in range(100000):
        if not agents:
            return
        a = rnd.choice(agents)
        try:
            next(a)
        except StopIteration:
            agents.remove(a)
    raise AssertionError(f"deadlock at nsteps={nsteps}")


@pytest.mark.parametrize("stages", [3, 4])
def test_ring_hand_over_has_no_deadlock_or_early_refill(stages):
    """Both ring depths the tiles take (AHEAD = STAGES - TILE_LEAD)."""
    for nsteps in range(1, 13):
        for seed in range(5):
            _simulate_ring(nsteps, stages, stages - TILE["TILE_LEAD"], seed)


# ------------------------------------------------------------ guards

# Granite-8B's 256-token chunk: (M, N) -> (tile, CTAs); and SD-Turbo's
# linears at batch 2 (UNet levels 0-2 and mid, CLIP and cross-attention).
CHUNK_CTAS = {(256, 14336): ((256, 128), 112), (256, 4096): ((128, 64), 128),
              (256, 1024): ((64, 64), 64), (200, 4096): ((128, 64), 128)}
SD_CTAS = {(8192, 320): ((256, 128), 96), (8192, 2560): ((256, 128), 640),
           (4096, 320): ((128, 128), 96), (4096, 2560): ((256, 128), 320),
           (2048, 640): ((128, 128), 80), (2048, 5120): ((256, 128), 320),
           (512, 1280): ((128, 64), 80), (512, 10240): ((256, 128), 160),
           (128, 1280): ((64, 64), 40), (154, 320): ((64, 64), 15),
           (154, 768): ((64, 64), 36), (154, 3072): ((128, 64), 96),
           (64, 1280): ((64, 64), 20)}


def test_cta_rule_at_the_chunk_and_sd_shapes():
    for (m, n), (tile, ctas) in {**CHUNK_CTAS, **SD_CTAS}.items():
        bm, bn = cta_tile(m, n)[:2]
        assert ((bm, bn), math.ceil(m / bm) * math.ceil(n / bn)) == (tile, ctas), (m, n)
    for shapes in (chip_smoke.Q8_SHAPES, chip_smoke.Q3K_SHAPES, chip_smoke.Q4_SHAPES):
        assert {(m, n) for m, n, _ in shapes if m in (200, 256)} >= set(CHUNK_CTAS)   # on the card


def test_sources_match_the_emulation():
    text = (CSRC / "common.cuh").read_text()
    c = _constants(CSRC / "common.cuh")
    assert {k: c[k] for k in TILE} == TILE
    tiles = dict(re.findall(r"using (T\w+) = Tile<Fmt, (\d+, \d+, \d+)[,>]", text))
    assert [tuple(map(int, v.split(", "))) for v in tiles.values()] == TILES
    # The 256 x 128 tile's mma warps take setmaxnreg's 176 registers; the
    # producers keep what is left of 65536, at least 24.
    regs = re.search(r"using T256 = Tile<Fmt, [\d, ]+, (\d+)>;", text).group(1)
    assert int(regs) == 176 and (65536 - 256 * 176) // 256 // 8 * 8 == 80
    setups = re.findall(r"tile_setup<Fmt, (T\w+)>\(\)", text)
    assert sorted(setups) == sorted(tiles)
    # The rule: each tile's cost with its rate and least M, in TILES order.
    costs = re.findall(r"const long long c\w+ = (?:M > (\d+) \? )?"
                       r"cost\((\d+), (\d+), (TILE_RATE_\w+)\)", text)
    assert [(int(lo or 0) + 1, (int(bm), int(bn)), r) for lo, bm, bn, r in costs] == \
        [(least, t[:2], r) for least, t, r in zip(MIN_M, TILES, RATES)]
    runs = re.findall(r"tile_run<Fmt, (T\w+)>\(x", text)
    assert [tuple(map(int, tiles[r].split(", "))) for r in runs] == TILES
    for src in ("q8_matmul.cu", "q3k_matmul.cu", "q4_matmul.cu"):
        assert "return tile_launch(" in (CSRC / src).read_text()
        assert _constants(CSRC / src)["M_GEMV"] == 16
    # Q8_0 and Q4_0 take their scale words through one loader.
    for src in ("q8_matmul.cu", "q4_matmul.cu"):
        assert "TileScales<BN, NP> sc;" in (CSRC / src).read_text()


def _bytes(src: str, fn: str, bn: int) -> int:
    """The format's raw_bytes or extra_bytes for BN, by its own formula."""
    text = (CSRC / src).read_text()
    expr = re.search(rf"{fn}\(int(?: BN)?\) {{ return ([^;]+); }}", text).group(1)
    return eval(expr, {"__builtins__": {}, "BN": bn, "TILE_BK": BK})   # noqa: S307 - its formula


@pytest.mark.parametrize("src,raw128,extra128", [("q8_matmul.cu", 128 * 72, 0),
                                                 ("q3k_matmul.cu", 128 * 24, 2 * 128 * 16),
                                                 ("q4_matmul.cu", 128 * 40, 0)])
def test_shared_memory_fits_every_instantiation(src, raw128, extra128):
    """Per slot: x (BM x 64 bf16), the bf16 weight tile and the format's raw
    bytes (Q8_0: 64 code bytes and two scale words per row; Q4_0: 32 code
    bytes and two scale words; Q3_K: 16 ql and 8 qh bytes per row), rounded
    up to 1024 bytes; past the ring Q3_K's two
    scale buffers (12 scale bytes and the d word per row); four slots where
    they fit in 227 KB, else three, and the named barriers FULL, EMPTY and
    PROD in 16."""
    assert (_bytes(src, "raw_bytes", 128), _bytes(src, "extra_bytes", 128)) == (raw128, extra128)
    for bm, bn, np_ in TILES:
        extra = _bytes(src, "extra_bytes", bn)
        slot, stages, ahead = ring(bm, bn, _bytes(src, "raw_bytes", bn), extra)
        assert stages * slot + extra <= SMEM_MAX and ahead >= 1 and 2 + 2 * stages <= 16
        assert np_ % 128 == 0 and bm * 8 % np_ == 0 and bn * 4 % np_ == 0
    # The 256 x 128 tile takes three slots under Q8_0, four under Q3_K and Q4_0.
    assert ring(256, 128, raw128, extra128)[1] == (3 if src == "q8_matmul.cu" else 4)


def test_tile_kernel_is_filed_as_ported():
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(",
                       (CSRC / "common.cuh").read_text())
    assert names == ["tile_kernel"]
    assert chip_smoke._kind("void repro::tile_kernel<Q8Tile, repro::Tile<Q8Tile, 256, 128, 256, "
                            "176> >") == "ported kernels"
    for src in ("q8_matmul.cu", "q3k_matmul.cu", "q4_matmul.cu"):
        assert "wmma::" not in (CSRC / src).read_text()


def test_no_wmma_left_in_csrc():
    """Every tile path is on tile_kernel: no WMMA code or header remains
    (the name may stay in comments that tell the history)."""
    for src in sorted(CSRC.iterdir()):
        text = src.read_text()
        assert "wmma" not in text and "<mma.h>" not in text, src.name
