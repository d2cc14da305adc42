"""CPU emulations of the Q8_0 and Q3_K matmuls' decode paths.

``csrc/q8_matmul.cu``'s ``q8_gemv_kernel`` and ``csrc/q3k_matmul.cu``'s
``q3k_gemv_kernel`` run only on the card.  Their arithmetic is pinned here:

* the weight unpacks, emulated bit by bit in numpy with bf16
  round-half-even (each bf16x2 operation rounds its exact result once,
  as the hardware does), from the packed bytes as the kernels read them:
  Q8_0's f32 route, Q3_K's bf16x2 route and ``csrc/q4_matmul.cu``'s,
  over every finite fp16 scale and every code, against the port's and the
  reference's dequantized bf16;
* the decode paths' sums: 16 weight rows per CTA, the warps interleaved
  over K steps (4 Q8_0 blocks, or one Q3_K super-block), each tensor-core
  product taking the elements the kernel pairs, every block taken once,
  the warps' partials added in warp order; held to the port's plain
  versions and to the JAX references with ``chip_smoke``'s limit.

Guards parse the kernels' constants from the sources.
"""
import importlib.util
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


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")

# (M_GEMV, GEMV_ROWS, GEMV_WARPS, GEMV_UNROLL) of csrc/q8_matmul.cu and
# csrc/q3k_matmul.cu
GEMV = {"q8_matmul.cu": (16, 16, 8, 2), "q3k_matmul.cu": (16, 16, 8, 1)}
M_GEMV, GEMV_ROWS, GEMV_WARPS = 16, 16, 8

# Every finite fp16 scale, zeros and negatives included.
D16 = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
D16 = D16[np.isfinite(D16)]


# ------------------------------------------------------ bit-level arithmetic

def _bf16(v) -> np.ndarray:
    """bf16 bits of ``v`` rounded once, half to even, from its exact value
    (float32 or float64 operands whose result float64 holds exactly)."""
    m, e = np.frexp(np.asarray(v, np.float64))
    r = np.ldexp(np.rint(np.ldexp(m, 8)), e - 8)       # 8 significant bits
    return (r.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _f(bits) -> np.ndarray:
    """float64 value of bf16 bits."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(np.float64)


def _magic(code, minus: float) -> np.ndarray:
    """f32 (0x4B000000 | code) - minus: the exact integer code + 2^23 - minus."""
    v = (np.uint32(0x4B000000) | code.astype(np.uint32)).view(np.float32)
    return v - np.float32(minus)


def q8_route(qs: np.ndarray, d: np.ndarray) -> np.ndarray:
    """bf16 bits of q8_gemv_kernel's weights: qs (N, K) int8, d (N, K/32)
    fp16 -> (N, K).  Per code word: xor 0x80808080, each byte under 0x4B,
    minus 2^23 + 128, times d, all in f32; cvt.rn to bf16."""
    n, k = qs.shape
    u = np.ascontiguousarray(qs).view(np.uint32) ^ np.uint32(0x80808080)   # (N, K/4)
    dw = np.repeat(d.astype(np.float32), 8, axis=1)                       # per word
    out = np.empty((n, k // 4, 4), np.uint16)
    for e in range(4):
        q = _magic((u >> np.uint32(8 * e)) & np.uint32(0xFF), 8388736.0)   # 2^23 + 128
        out[:, :, e] = _bf16(q * dw)
    return out.reshape(n, k)


def _prmt(a, b, sel: int) -> np.ndarray:
    """__byte_perm(a, b, sel): byte n of the result is byte sel[4n:4n+3] of
    the 8 bytes a (0..3), b (4..7)."""
    src = [(x >> np.uint32(8 * k)) & np.uint32(0xFF) for x in (a, b) for k in range(4)]
    out = np.zeros(np.broadcast(a, b).shape, np.uint32)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def q3k_route(ql, qh, scales, d) -> np.ndarray:
    """bf16 bits of q3k_gemv_kernel's weights from the packed Q3_K fields
    -> (N, K), read as the kernel reads them: lane tig's ql words (one per
    sub-block), qh words (two sub-blocks each, 16 bits apart), the two
    scale words funnel-shifted to its group's 24 bits; per byte group b of
    sub-blocks s and s + 1 one byte permute of the codes and of the h bits,
    each element's 3-bit field at mantissa bits P = 0, 2, 4, 4, and the
    scales eh, el taken by 2^-P."""
    n, nsb = d.shape
    qlw = np.ascontiguousarray(ql).view(np.uint32).reshape(n, nsb, 4, 4)
    qhw = np.ascontiguousarray(qh).view(np.uint32).reshape(n, nsb, 4, 2)
    scw = np.ascontiguousarray(scales).reshape(n, nsb, 12).view(np.uint32)
    tig = np.arange(4)
    sw = (3 * tig) >> 2
    sw1 = np.minimum(sw + 1, 2)
    ssh = (8 * ((3 * tig) & 3)).astype(np.uint64)
    sc = ((scw[:, :, sw1].astype(np.uint64) << np.uint64(32)
           | scw[:, :, sw].astype(np.uint64)) >> ssh).astype(np.uint32)   # (N, nsb, 4)
    d32 = d.astype(np.float32)[:, :, None]
    zero = np.uint32(0)
    out = np.empty((n, nsb, 4, 4, 16), np.uint16)                         # tig, sub, j
    for p in range(2):
        eh, el = [], []                           # low half: s, high half: s + 1
        for h in range(2):
            eff = _magic((sc >> np.uint32(12 * p + 6 * h)) & np.uint32(63), 8388640.0) * d32
            eh.append(_f(_bf16(eff)))
            el.append(_f(_bf16(eff - eh[-1].astype(np.float32))))
        for b in range(4):
            cb = _prmt(qlw[..., 2 * p], qlw[..., 2 * p + 1], b | (4 + b) << 8)
            hb = _prmt(qhw[..., p], zero, (b >> 1) | 4 << 4 | (2 + (b >> 1)) << 8 | 4 << 12)
            for i in range(4):
                P = 2 * i if i < 3 else 4
                cs = cb if i < 3 else cb >> np.uint32(2)
                hsrc, hdst = 4 * (b & 1) + i, P + 2
                hs = hb << np.uint32(hdst - hsrc) if hdst >= hsrc \
                    else hb >> np.uint32(hsrc - hdst)
                bits = (cs & np.uint32(0x00030003 << P)) | (hs & np.uint32(0x00040004 << P)) \
                    | np.uint32(0x43004300)
                for h in range(2):
                    v = (bits >> np.uint32(16 * h)) & np.uint32(0xFFFF)
                    q = _f(_bf16(_f(v) - (128 + 4 * 2 ** P)))          # q * 2^P
                    ehp, elp = (_f(_bf16(e * 2.0 ** -P)) for e in (eh[h], el[h]))
                    t = _f(_bf16(q * elp))
                    out[:, :, :, 2 * p + h, 4 * b + i] = _bf16(q * ehp + t)
    return out.reshape(n, nsb * 256)


def q4_route(qs: np.ndarray, d: np.ndarray) -> np.ndarray:
    """bf16 bits of q4_gemv_kernel's weights: qs (N, K/2) uint8, d (N, K/32)
    fp16 -> (N, K).  Nibbles j and j + 4 of a word as one bf16 pair,
    fma.rn(q - 8, dh, (q - 8) * dl) with d = dh + dl."""
    n, kh = qs.shape
    w = np.ascontiguousarray(qs).view(np.uint32)                          # (N, K/8)
    d32 = np.repeat(d.astype(np.float32), 4, axis=1)
    dh = _bf16(d32)
    dl = _f(_bf16(d32 - _f(dh).astype(np.float32)))
    out = np.empty((n, kh // 4, 8), np.uint16)
    for j in range(4):
        bits = ((w >> np.uint32(4 * j)) & np.uint32(0x000F000F)) | np.uint32(0x43004300)
        for h in range(2):                        # elements j and j + 4
            q = _f(_bf16(_f((bits >> np.uint32(16 * h)) & np.uint32(0xFFFF)) - 136.0))
            out[:, :, j + 4 * h] = _bf16(q * _f(dh) + _f(_bf16(q * dl)))
    return out.reshape(n, 2 * kh)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _assert_same(got: np.ndarray, want: np.ndarray, exact: bool) -> int:
    """The same bf16 bits, or (``exact`` False) both zeros: a zero weight's
    sign may differ (fma(q, eh, q * el) adds two zeros of opposite sign
    where the reference multiplies q by eff), which moves no sum."""
    diff = got != want
    if not exact:
        diff &= ((got & 0x7FFF) != 0) | ((want & 0x7FFF) != 0)
    assert not diff.any(), (f"{int(diff.sum())} weights differ, e.g. "
                            f"{got[diff][:4]} vs {want[diff][:4]}")
    return got.size


# ------------------------------------------------- exhaustive unpack checks

def _chunks(n_chunks: int):
    return np.split(D16, n_chunks)               # equal chunks: one JAX trace each


def test_q8_unpack_is_exact_for_every_scale():
    """Every finite fp16 d x every q in [-128, 127]: the f32 route gives the
    reference's bf16(q * d) bit for bit (signed zeros included)."""
    checked = 0
    for d in _chunks(4):
        qs = np.tile(np.arange(-128, 128, dtype=np.int8), (len(d), 1))    # 8 blocks
        ds = np.repeat(d[:, None], 8, axis=1)
        got = q8_route(qs, ds)
        want = tq.dequantize_q8_0(tq.Q8_0Tensor(torch.from_numpy(qs),
                                                torch.from_numpy(ds)), torch.bfloat16)
        jwant = jq.dequantize_q8_0(jq.Q8_0Tensor(jnp.asarray(qs), jnp.asarray(ds)),
                                   jnp.bfloat16)
        _assert_same(got, _bits(want), exact=True)
        checked += _assert_same(got, _bits(jwant), exact=True)
    assert checked == len(D16) * 256


def test_q3k_unpack_is_exact_for_every_scale():
    """Every finite fp16 d x every 6-bit code x every q in [-4, 3]: the
    bf16x2 route gives the reference's bf16(q * d * (sc - 32)); bit for bit
    but for the sign of a zero."""
    checked = 0
    codes = torch.arange(64, dtype=torch.uint8).reshape(4, 16)   # 4 super-blocks
    for d in _chunks(8):
        n = len(d)
        qu = torch.arange(8, dtype=torch.uint8).repeat(n, 128)  # element e: q = e % 8 - 4
        ql, qh = tq.pack_q3(qu)
        sc = tq.pack_scales6(codes.expand(n, 4, 16))
        ds = np.repeat(d[:, None], 4, axis=1)
        got = q3k_route(ql.numpy(), qh.numpy(), sc.numpy(), ds)
        want = tq.dequantize_q3_k(tq.Q3KTensor(ql, qh, sc, torch.from_numpy(ds)),
                                  torch.bfloat16)
        jwant = jq.dequantize_q3_k(jq.Q3KTensor(*(jnp.asarray(a) for a in (
            ql.numpy(), qh.numpy(), sc.numpy(), ds))), jnp.bfloat16)
        _assert_same(got, _bits(want), exact=False)
        checked += _assert_same(got, _bits(jwant), exact=False)
    assert checked == len(D16) * 64 * 16


def test_q4_unpack_is_exact_for_every_scale():
    """Every finite fp16 d x every q in [-8, 7]: q4_gemv_kernel's route gives
    the reference's bf16((q - 8) * d); bit for bit but for the sign of a
    zero."""
    qs = tq.pack_q4(torch.arange(16, dtype=torch.uint8).repeat(len(D16), 2))   # one block
    ds = D16[:, None]
    got = q4_route(qs.numpy(), ds)
    want = tq.dequantize_q4_0(tq.Q4_0Tensor(qs, torch.from_numpy(ds)), torch.bfloat16)
    jwant = jq.dequantize_q4_0(jq.Q4_0Tensor(jnp.asarray(qs.numpy()), jnp.asarray(ds)),
                               jnp.bfloat16)
    _assert_same(got, _bits(want), exact=False)
    assert _assert_same(got, _bits(jwant), exact=False) == len(D16) * 32


# ------------------------------------------------------ decode-path sums

def _warp_sums(wb, xf, nstep: int, unroll: int, step_products):
    """The decode path's sum: warps interleaved over the K steps, each
    accumulating its steps in order, one tensor-core product at a time
    (``step_products(st)`` lists the element indices of each), the warps'
    partials added in warp order.  Returns (y (M, N), elements seen)."""
    nwarp = min(GEMV_WARPS, max(1, nstep))
    seen = torch.zeros(wb.shape[1], dtype=torch.int64)
    parts = []
    for warp in range(nwarp):
        acc = torch.zeros((wb.shape[0], xf.shape[0]))
        for st0 in range(warp, nstep, nwarp * unroll):
            for u in range(unroll):
                st = st0 + u * nwarp
                if st >= nstep:
                    continue
                for ks in step_products(st):
                    seen[ks] += 1
                    acc = acc + wb[:, ks] @ xf[:, ks].t()
        parts.append(acc)
    y = torch.zeros_like(parts[0])
    for p in parts:                              # warp order
        y = y + p
    return y.t().contiguous(), seen


def emulate_q8(x, w: tq.Q8_0Tensor):
    """What q8_gemv_kernel computes for x (M, K stored) bf16: y (M, N) f32."""
    kdim = x.shape[1]
    nblk = kdim // 32
    wb = torch.from_numpy(_f(q8_route(w.qs.numpy(), w.d.numpy())).astype(np.float32))

    def products(st):                            # code word i of the 4 blocks
        blocks = [4 * st + tig for tig in range(4) if 4 * st + tig < nblk]
        return [[32 * b + 4 * i + e for b in blocks for e in range(4)] for i in range(8)]
    y, seen = _warp_sums(wb, x.float(), -(-nblk // 4), GEMV["q8_matmul.cu"][3], products)
    assert torch.equal(seen, torch.ones(kdim, dtype=torch.int64)), seen
    return y


def emulate_q3k(x, w: tq.Q3KTensor):
    """What q3k_gemv_kernel computes for x (M, K) bf16: y (M, N) f32."""
    kdim = x.shape[1]
    wb = torch.from_numpy(_f(q3k_route(w.ql.numpy(), w.qh.numpy(), w.scales.numpy(),
                                       w.d.numpy())).astype(np.float32))

    def products(st):         # lane tig: element j, j + 1 of sub-blocks s, s + 1
        out = []
        for p in range(2):
            for j in range(0, 16, 2):
                out.append([256 * st + 16 * (4 * tig + 2 * p + h) + j + e
                            for tig in range(4) for e in range(2) for h in range(2)])
        return out
    y, seen = _warp_sums(wb, x.float(), kdim // 256, GEMV["q3k_matmul.cu"][3], products)
    assert torch.equal(seen, torch.ones(kdim, dtype=torch.int64)), seen
    return y


def _weights(n, k, seed):
    rng = np.random.default_rng(seed)
    w = np.abs(rng.standard_normal((n, k))) * k ** -0.5     # lopsided blocks
    w[:, ::7] *= -3.0
    return w.astype(np.float32)


def _check(got, wants) -> None:
    for want in wants:
        want = torch.from_numpy(np.array(want, np.float32))
        err = (got - want).abs().max().item()
        assert err <= chip_smoke.MATMUL_RTOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("m", [1, 4, 8, 16])
@pytest.mark.parametrize("n,k", [(70, 96), (70, 100), (40, 128), (16, 1152)])
def test_q8_decode_path_matches_references(m, n, k):
    """K = 96: one step with three blocks; K = 100: a tail-padded weight,
    x zero-padded to the stored K as ``ops`` does; K = 1152: 9 steps over
    8 warps."""
    w = _weights(n, k, m * 1000 + n + k)
    x = torch.from_numpy(np.random.default_rng(k).standard_normal((m, k))
                         .astype(np.float32)).to(torch.bfloat16)
    tw = tq.quantize_q8_0(torch.from_numpy(w))
    jw = jq.quantize_q8_0(jnp.asarray(w))
    got = emulate_q8(F.pad(x, (0, tw.qs.shape[1] - k)), tw)
    _check(got, [tref.q8_matmul_ref(x, tw),
                 jref.q8_matmul_ref(jnp.asarray(x.float().numpy(), jnp.bfloat16), jw)])


@pytest.mark.parametrize("m", [1, 4, 8, 16])
@pytest.mark.parametrize("n,k", [(70, 256), (70, 512), (16, 2560)])
def test_q3k_decode_path_matches_references(m, n, k):
    """K = 256: one super-block, one warp; K = 2560: 10 steps over 8 warps."""
    w = _weights(n, k, m * 1000 + n + k)
    x = torch.from_numpy(np.random.default_rng(k).standard_normal((m, k))
                         .astype(np.float32)).to(torch.bfloat16)
    tw = tq.quantize_q3_k(torch.from_numpy(w))
    jw = jq.quantize_q3_k(jnp.asarray(w))
    got = emulate_q3k(x, tw)
    _check(got, [tref.q3k_matmul_ref(x, tw),
                 jref.q3k_matmul_ref(jnp.asarray(x.float().numpy(), jnp.bfloat16), jw)])


# Granite-8B's decode linears: (N, K) -> CTAs.
DECODE_LINEARS = {(14336, 4096): 896, (4096, 14336): 256, (4096, 4096): 256,
                  (1024, 4096): 64}


def test_cta_rule_at_the_decode_shapes():
    """16 rows per CTA and 8 warps at every Granite-8B decode linear, the
    Q8_0 head (49152 rows) included, each held on the card by chip_smoke
    at 4 tokens."""
    q8 = {**DECODE_LINEARS, (49152, 4096): 3072}
    for shapes, want in ((chip_smoke.Q8_SHAPES, q8), (chip_smoke.Q3K_SHAPES, DECODE_LINEARS)):
        assert {(n, k) for m, n, k in shapes if m == 4} >= set(want)
    for (n, k), ctas in q8.items():
        assert -(-n // GEMV_ROWS) == ctas
        for step in (128, 256):                  # Q8_0: 4 blocks; Q3_K: a super-block
            assert k // step >= GEMV_WARPS


def test_verify_linears_are_held_on_the_card():
    """A speculative verify runs the q8_0 target's linears and its Q8_0
    head at M = k + 1 rows, on the decode path; chip_smoke holds each of
    them at that M."""
    m = chip_smoke.SPEC_K + 1
    assert m <= M_GEMV
    want = {**DECODE_LINEARS, (49152, 4096): 3072}
    assert {(n, k) for mm, n, k in chip_smoke.Q8_SHAPES if mm == m} >= set(want)


def _constants(path: Path) -> dict[str, int]:
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (\w+) = (\d+);", path.read_text())}


@pytest.mark.parametrize("src", sorted(GEMV))
def test_sources_match_the_emulations(src):
    c = _constants(CSRC / src)
    assert (c["M_GEMV"], c["GEMV_ROWS"], c["GEMV_WARPS"], c["GEMV_UNROLL"]) == GEMV[src]
    text = (CSRC / src).read_text()
    assert "M <= M_GEMV" in text and ("q8_gemv_kernel" in text or "q3k_gemv_kernel" in text)
