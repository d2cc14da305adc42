"""CPU emulation of ``csrc/q8_matmul_w8a8.cu``, the integer w8a8 matmul.

Its two kernels run only on the card.  Their arithmetic is pinned here:

* the mma.sync m16n8k32 s8 fragments as the kernels' ldmatrix addresses
  deliver them from the padded shared-memory rows (tokens as A and weights
  as B on the tile path, weights as A and tokens as B on the decode path),
  multiplied as the PTX layout says, against the exact int32 block dots;
  and that no ldmatrix phase has a bank conflict;
* the int-to-float route: the mma adds W8A8_MAGIC, one f32 subtraction
  gives float(dot), exactly, for every |dot| <= 2^19;
* the scale words: each slot's 4-byte copies of the fp16 scales (any
  2-byte alignment of the tensor, odd and even K/32, partial slots, the
  array's last word) and the half each block reads back;
* both paths' sums, tile by tile and slot by slot with their edges (rows
  past M and N, blocks past K/32, a partial last slot), the decode path's
  terms folded in block order through shared memory, the grids of both
  CTA rules: every output stored once, equal bit for bit to the
  block-order sum of the reference's terms (``chip_smoke.w8a8_block_order``)
  and within ``chip_smoke``'s limit of the port's plain version, the JAX
  reference and the Pallas kernel (interpret).

The plain versions add the same terms in their libraries' orders (torch's
CPU sum adds a reduced dimension of five or more in a cascade, JAX its own
way), so they agree with the kernels to within rounding, not bit for bit.
Guards parse the kernels' constants, instantiations and address formulas
from the source.
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

from repro.core import quant as jq  # noqa: E402
from repro.kernels import q8_matmul as jq8  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "src" / "repro_torch" / "csrc" / "q8_matmul_w8a8.cu").read_text()


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")


def _const(name: str) -> int:
    (v,) = re.findall(rf"constexpr int {name} = (0x[0-9A-Fa-f]+|-?\d+);", SRC)
    return int(v, 0)


M_GEMV, MAGIC = _const("M_GEMV"), _const("W8A8_MAGIC")
GEMV_WARPS, GEMV_KB = _const("GEMV_WARPS"), _const("GEMV_KB")
SMEM_SM, RESERVED, SMS = 233472, 1024, 132          # H100: per SM, per block, SMs


def _tiles() -> dict[str, tuple]:
    """``using T... = W8Tile<MT, NT, WM, WN, KB, STAGES, OCC>`` -> (BM, BN,
    KB, THREADS, OCC, rate)."""
    out = {}
    for name, args in re.findall(r"using (T\w+) = W8Tile<([^>]*)>;", SRC):
        mt, nt, wm, wn, kb, _stages, occ = (int(a) for a in args.split(","))
        rate = _const("W8A8_RATE_" + name[1:])
        out[name] = (16 * mt * wm, 8 * nt * wn, kb, 32 * wm * wn, occ, rate)
    return out


def _gemv_stages() -> dict[int, tuple[int, ...]]:
    """Token groups -> the rings' slots (``using Gemv.. = W8Gemv<NG, S>``)."""
    out: dict[int, list] = {}
    for ng, st in re.findall(r"using Gemv\w+ = W8Gemv<(\d+), ([^>]+)>;", SRC):
        name, _, plus = st.partition("+")
        out.setdefault(int(ng), []).append(_const(name.strip()) + int(plus or 0))
    return {ng: tuple(sorted(v)) for ng, v in out.items()}


TILES = _tiles()
GEMV_STAGES = _gemv_stages()


# ------------------------------------------------------------ the rules

def tile_rule(m: int, n: int) -> tuple[int, int, int]:
    """The tile path's CTA rule, as q8_matmul_w8a8_s8 takes it: (BM, BN, KB)."""
    best, choice = None, None
    for bm, bn, kb, _threads, occ, rate in TILES.values():  # in source order
        if rate <= 0:
            continue
        ctas = math.ceil(m / bm) * math.ceil(n / bn)
        cost = math.ceil(ctas / (occ * SMS)) * (occ * bm * bn * 1000 // rate)
        if best is None or cost < best:
            best, choice = cost, (bm, bn, kb)
    return choice


def gemv_smem(ng: int, stages: int, m: int) -> int:
    """W8Gemv<ng, stages>::smem(m): the terms, the ring, the guard."""
    tok, kb = 8 * ng, GEMV_KB
    rs, wpr = kb * 32 + 16, kb // 2 + 1
    xq = 16 * rs + 4 * wpr * 16 + 4 * kb * tok
    return 4 * kb * 16 * tok + stages * (xq + m * rs) + (tok - m) * rs


def gemv_rule(m: int, n: int) -> tuple[int, int, int, int]:
    """The decode path's launch: (ng, stages, ctas, row groups per CTA).
    One token group has two rings and takes the one with more slots in
    flight per SM; two token groups have one."""
    ng = 1 if m <= 8 else 2
    occ = {st: 0 if gemv_smem(ng, st, m) > 232448 else
           min(2, SMEM_SM // (gemv_smem(ng, st, m) + RESERVED)) for st in GEMV_STAGES[ng]}
    if ng == 1:
        lo, hi = GEMV_STAGES[ng]
        deep = (occ[hi] * (hi - 1) > occ[lo] * (lo - 1)
                or (occ[hi] * (hi - 1) == occ[lo] * (lo - 1) and occ[hi] >= occ[lo]))
        st = hi if deep else lo
    else:
        (st,) = GEMV_STAGES[ng]
    groups = math.ceil(n / 16)
    per = math.ceil(groups / (occ[st] * SMS))
    return ng, st, math.ceil(groups / per), per


# ------------------------------------------------- arithmetic of one block

def exact_float(d: np.ndarray) -> np.ndarray:
    """float(dot) from the mma's dot + MAGIC, as the kernels convert it."""
    v = (d.astype(np.int64) + MAGIC).astype(np.int32).view(np.float32)
    return (v - np.float32(12582912.0)).astype(np.float32)


def term(dot: np.ndarray, xs: np.ndarray, ws: np.ndarray) -> np.ndarray:
    """(float(dot) * xs) * ws in f32, each product rounded once."""
    return (exact_float(dot) * xs.astype(np.float32)) * ws.astype(np.float32)


def block_dots(xq: np.ndarray, wq: np.ndarray) -> np.ndarray:
    """(nblk, M, N) exact int32 block dots."""
    m, k = xq.shape
    a = xq.reshape(m, k // 32, 32).astype(np.int64).transpose(1, 0, 2)
    b = wq.reshape(wq.shape[0], k // 32, 32).astype(np.int64).transpose(1, 2, 0)
    return np.matmul(a, b)


def block_order(xq, xs, wq, ws) -> np.ndarray:
    """The reference's terms added in block order from 0 in f32."""
    dots = block_dots(xq, wq)
    acc = np.zeros(dots.shape[1:], np.float32)
    for b in range(dots.shape[0]):
        acc = acc + term(dots[b], xs[:, b:b + 1], ws[None, :, b])
    return acc


def test_exact_float_route_over_every_dot():
    """dot + 0x4B400000 read as f32, minus 1.5 * 2^23, is float(dot) for
    every dot an s8 mma over one block can give (|dot| <= 2^19)."""
    dots = np.arange(-(1 << 19), (1 << 19) + 1, dtype=np.int64)
    assert MAGIC == 0x4B400000
    np.testing.assert_array_equal(exact_float(dots), dots.astype(np.float32))
    assert 32 * 128 * 128 == 1 << 19


# ------------------------------------------ fragments as ldmatrix gives them

def _smem_rows(rows: np.ndarray, rs: int) -> np.ndarray:
    """Code rows (R, bytes) at rs bytes apart, as the ring holds them."""
    out = np.zeros(rows.shape[0] * rs + 64, np.uint8)
    for r in range(rows.shape[0]):
        out[r * rs:r * rs + rows.shape[1]] = rows[r]
    return out


def ldmatrix(smem: np.ndarray, addr: np.ndarray, nmat: int) -> np.ndarray:
    """ldmatrix .x{nmat}: matrix q's rows at the addresses of lanes 8q ..
    8q + 7; lane l gets 4 bytes of row l / 4 at byte 4 (l % 4) -> (32, nmat)."""
    lane = np.arange(32)
    out = np.zeros((32, nmat), np.uint32)
    for q in range(nmat):
        base = addr[8 * q + lane // 4] + 4 * (lane % 4)
        for e in range(4):
            out[:, q] |= smem[base + e].astype(np.uint32) << np.uint32(8 * e)
    return out


def _bytes(reg: np.ndarray, e: int) -> np.ndarray:
    return ((reg >> np.uint32(8 * e)) & np.uint32(0xFF)).astype(np.uint8).view(np.int8)


def mma_s8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.m16n8k32.row.col.s32.s8.s8 per the PTX fragment layout: a (32, 4)
    and b (32, 2) registers -> D (16, 8)."""
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for e in range(4):
        A[gid, 4 * tig + e] = _bytes(a[:, 0], e)
        A[gid + 8, 4 * tig + e] = _bytes(a[:, 1], e)
        A[gid, 16 + 4 * tig + e] = _bytes(a[:, 2], e)
        A[gid + 8, 16 + 4 * tig + e] = _bytes(a[:, 3], e)
        B[4 * tig + e, gid] = _bytes(b[:, 0], e)
        B[16 + 4 * tig + e, gid] = _bytes(b[:, 1], e)
    return A @ B


def c_layout(d: np.ndarray) -> np.ndarray:
    """The four s32 a lane holds of D (16, 8): rows gid, gid + 8, columns
    2 tig, 2 tig + 1 -> (32, 4)."""
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    return np.stack([d[gid, 2 * tig], d[gid, 2 * tig + 1],
                     d[gid + 8, 2 * tig], d[gid + 8, 2 * tig + 1]], axis=1)


def _a_rows(lane):   # A: x4 of 16 rows, bytes 0-15 then 16-31
    return lane & 15, 16 * (lane >> 4)


def _b_rows(lane):   # B: x4 of two n8 tiles (x2: the first), each 32 bytes
    return (lane & 7) + ((lane >> 4) << 3), 16 * ((lane >> 3) & 1)


def test_address_formulas_are_the_sources():
    """The ldmatrix row formulas emulated here are the kernels'."""
    assert "(mw + (lane & 15)) * T::RS + 16 * (lane >> 4)" in SRC            # tile A
    assert "(nw + (lane & 7) + ((lane >> 4) << 3)) * T::RS + 16 * ((lane >> 3) & 1)" in SRC
    assert "(lane & 15) * T::RS + 16 * (lane >> 4) + 32 * warp" in SRC       # decode A
    assert "((lane & 7) + ((lane >> 4) << 3)) * T::RS + 16 * ((lane >> 3) & 1) +" in SRC
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in \
        (ROOT / "src" / "repro_torch" / "csrc" / "common.cuh").read_text()
    assert "__dp4a(" not in SRC and "mma_s8_16832(" in SRC


@pytest.mark.parametrize("kb", sorted({GEMV_KB} | {t[2] for t in TILES.values()}))
def test_fragments_give_the_block_dots(kb):
    """Both orientations, every block of a slot of kb blocks, int8 -128
    included: the fragments that ldmatrix loads from rows kb * 32 + 16
    bytes apart give D = A B^T of the block exactly, and each 8-lane phase
    of every ldmatrix reads 8 distinct 16-byte bank groups."""
    rng = np.random.default_rng(kb)
    rs = kb * 32 + 16
    toks = rng.integers(-128, 128, (16, kb * 32)).astype(np.int8)
    wts = rng.integers(-128, 128, (16, kb * 32)).astype(np.int8)
    toks[0, :5] = wts[3, :7] = -128
    lane = np.arange(32)
    for rows_a, rows_b in ((toks, wts), (wts, toks)):     # tile, decode
        sa, sb = _smem_rows(rows_a.view(np.uint8), rs), _smem_rows(rows_b.view(np.uint8), rs)
        for j in range(kb):
            ra, ca = _a_rows(lane)
            rb, cb = _b_rows(lane)
            addr_a, addr_b = ra * rs + ca + 32 * j, rb * rs + cb + 32 * j
            for addr in (addr_a, addr_b):
                for ph in range(4):
                    groups = (addr[8 * ph:8 * ph + 8] // 16) % 8
                    assert len(set(groups.tolist())) == 8, (kb, j, ph)
            a = ldmatrix(sa, addr_a, 4)
            bb = ldmatrix(sb, addr_b, 4)
            blk = slice(32 * j, 32 * j + 32)
            for t in range(2):                             # the two n8 tiles of B
                d = mma_s8(a, bb[:, 2 * t:2 * t + 2])
                want = rows_a[:, blk].astype(np.int64) @ rows_b[8 * t:8 * t + 8, blk].T
                np.testing.assert_array_equal(d, want)
                np.testing.assert_array_equal(c_layout(d)[:, 0], want[lane // 4, 2 * (lane % 4)])
            b2 = ldmatrix(sb, addr_b, 2)                   # x2: the first tile
            np.testing.assert_array_equal(b2, bb[:, :2])


# ------------------------------------------------------------ scale words

def scale_words(ws: np.ndarray, off: int, rows, kb0: int, kb: int):
    """One slot's scale copies for weight rows ``rows``, as
    ``w8a8_copy_scales`` makes them on both paths: the tensor's fp16
    bytes at byte offset ``off`` (0 or 2 mod 4) of a buffer; returns the
    words per row and slot word (dict) and every byte range read."""
    n, nblk = ws.shape
    mem = np.zeros(off + 2 * ws.size + 16, np.uint8)
    mem[off:off + 2 * ws.size] = ws.astype(np.float16).view(np.uint8).ravel()
    end = off + 2 * ws.size
    nb = min(kb, nblk - kb0)
    words, reads = {}, []
    for r in rows:
        a = off + 2 * (r * nblk + kb0)
        par = (a >> 1) & 1
        for w in range(kb // 2 + 1):
            wa = (a & ~3) + 4 * w
            if 2 * w - par < nb:
                nbytes = min(4, end - wa)
                word = np.zeros(4, np.uint8)
                word[:nbytes] = mem[wa:wa + nbytes]
                words[(r, w)] = word
                reads.append((wa, wa + nbytes))
    return words, reads, end


@pytest.mark.parametrize("nblk", [3, 5, 10, 129, 128])
@pytest.mark.parametrize("off", [0, 2])
def test_scale_words_read_back_every_scale(nblk, off):
    """Every slot of every row: the half that block j reads (relative index
    j + par of the row's words, par the parity of its first scale's address
    / 2, the same for every slot and equal to the tile conversion's parity)
    is the row's scale; no copy reads past the array's end, and none before
    its start by more than the 2 bytes of a word it shares."""
    rng = np.random.default_rng(nblk + off)
    n = 37
    ws = (rng.standard_normal((n, nblk)) * 0.01).astype(np.float16)
    ws[0, 0], ws[-1, -1] = np.float16(-2.0), np.float16(65504.0)
    for kb in sorted({GEMV_KB} | {t[2] for t in TILES.values()}):
        for s in range(math.ceil(nblk / kb)):
            kb0 = s * kb
            words, reads, end = scale_words(ws, off, range(n), kb0, kb)
            assert all(lo >= off - 2 and hi <= end for lo, hi in reads)
            for r in range(n):
                par = ((off >> 1) + r * nblk + kb0) & 1
                assert par == (((off >> 1) + r * nblk) & 1)   # kb0 is even
                for j in range(min(kb, nblk - kb0)):
                    h = j + par
                    got = words[(r, h >> 1)][2 * (h & 1):2 * (h & 1) + 2].view(np.float16)[0]
                    assert got == ws[r, kb0 + j] and np.signbit(got) == np.signbit(ws[r, kb0 + j])


# ------------------------------------------------------------- both paths

def tile_path(xq, xs, wq, ws) -> np.ndarray:
    """w8a8_tile_kernel tile by tile and slot by slot: each CTA's outputs
    one f32 sum per (token, weight row) over the slots' blocks in order,
    blocks past K/32 zero (codes, xs and scale), rows past M or N never
    stored; every output stored once."""
    m, k = xq.shape
    n, nblk = ws.shape
    bm, bn, kb = tile_rule(m, n)
    dots = block_dots(xq, wq)
    y = np.full((m, n), np.nan, np.float32)
    stored = np.zeros((m, n), np.int64)
    for m0 in range(0, m, bm):
        for n0 in range(0, n, bn):
            rm, rn = slice(m0, min(m0 + bm, m)), slice(n0, min(n0 + bn, n))
            acc = np.zeros((rm.stop - m0, rn.stop - n0), np.float32)
            for s in range(math.ceil(nblk / kb)):
                for j in range(kb):
                    b = s * kb + j
                    if b < nblk:
                        t = term(dots[b, rm, rn], xs[rm, b:b + 1], ws[None, rn, b])
                    else:                                  # zero codes, xs and scale
                        t = term(np.zeros_like(acc, np.int64), np.zeros((acc.shape[0], 1)),
                                 np.zeros((1, acc.shape[1])))
                    acc = acc + t
            y[rm, rn] = acc
            stored[rm, rn] += 1
    assert (stored == 1).all()
    return y


def gemv_path(xq, xs, wq, ws) -> np.ndarray:
    """w8a8_gemv_kernel: CTAs of ``per`` row groups of 16 weight rows, slots
    of GEMV_KB blocks, warp w's terms of blocks w, w + GEMV_WARPS, ...
    written to shared memory and folded in block order after each slot; a
    group's sums stored after its last slot; every output stored once."""
    m, k = xq.shape
    n, nblk = ws.shape
    assert m <= M_GEMV
    _ng, _st, ctas, per = gemv_rule(m, n)
    groups = math.ceil(n / 16)
    dots = block_dots(xq, wq)
    y = np.full((m, n), np.nan, np.float32)
    stored = np.zeros((m, n), np.int64)
    for cta in range(ctas):
        for g in range(cta * per, min(cta * per + per, groups)):
            rows = 16 * g + np.arange(16)
            live = rows < n
            acc = np.zeros((16, m), np.float32)
            for s in range(math.ceil(nblk / GEMV_KB)):
                kb0, nb = s * GEMV_KB, min(GEMV_KB, nblk - s * GEMV_KB)
                terms = {}
                for warp in range(GEMV_WARPS):
                    for q in range(GEMV_KB // GEMV_WARPS):
                        j = warp + GEMV_WARPS * q
                        if j < nb:
                            b = kb0 + j
                            terms[j] = term(dots[b][:, rows[live]].T, xs[None, :, b],
                                            ws[rows[live], b][:, None])
                for j in range(nb):                       # the fold
                    acc[live] = acc[live] + terms[j]
            y[:, rows[live]] = acc[live].T
            stored[:, rows[live]] += 1
    assert (stored == 1).all()
    return y


def _inputs(m: int, n: int, nblk: int, seed: int):
    rng = np.random.default_rng(seed)
    k = 32 * nblk
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    xq[0, :3] = -128
    xs = (rng.random((m, nblk)) * 0.02 + 1e-4).astype(np.float32)
    if (m + n // 10 + nblk) % 2:  # Q8_0 activation scales are fp16 values
        xs = xs.astype(np.float16).astype(np.float32)
    w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
    w[:, ::9] *= -4.0
    return xq, xs, w


@pytest.fixture(scope="module")
def pallas():
    """The Pallas kernel in interpret mode, one K step per call."""
    def run(xq, xs, jw):
        k = xq.shape[1]
        return np.asarray(jq8.q8_matmul_w8a8(jnp.asarray(xq), jnp.asarray(xs), jw.qs,
                                             jw.d.astype(jnp.float32), bn=128, bk=k,
                                             interpret=True))
    return run


@pytest.mark.parametrize("n", [70, 100, 256])
@pytest.mark.parametrize("nblk", [3, 5, 129])
@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 129])
def test_paths_match_block_order_and_references(m, n, nblk, pallas):
    """The path the kernel takes at (m, n, 32 nblk): bit for bit the
    block-order sum (numpy and ``chip_smoke.w8a8_block_order`` in torch),
    and within ``chip_smoke.MATMUL_RTOL`` of the port's plain version, the
    JAX reference and the Pallas kernel."""
    xq, xs, w = _inputs(m, n, nblk, seed=1000 * m + 10 * n + nblk)
    tw = tq.quantize_q8_0(torch.from_numpy(w))
    wq, ws = tw.qs.numpy(), tw.d.numpy()
    got = (gemv_path if m <= M_GEMV else tile_path)(xq, xs, wq, ws)
    np.testing.assert_array_equal(got, block_order(xq, xs, wq, ws))
    txq, txs = torch.from_numpy(xq), torch.from_numpy(xs)
    np.testing.assert_array_equal(got, chip_smoke.w8a8_block_order(txq, txs, tw).numpy())
    jw = jq.quantize_q8_0(jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(jw.qs), wq)
    plain = tref.q8_matmul_w8a8_ref(txq, txs, tw).numpy()
    for want in (plain, np.asarray(jref.q8_matmul_w8a8_ref(jnp.asarray(xq), jnp.asarray(xs), jw)),
                 pallas(xq, xs, jw)):
        tol = chip_smoke.MATMUL_RTOL * max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= tol


def test_tile_path_edges():
    """Ragged tiles on every side and a partial last slot: M past a tile,
    N past a tile and odd, K/32 odd (a slot of one block)."""
    for m, n, nblk in ((17, 70, 3), (129, 100, 129), (300, 117, 7)):
        xq, xs, w = _inputs(m, n, nblk, seed=m + n)
        tw = tq.quantize_q8_0(torch.from_numpy(w))
        got = tile_path(xq, xs, tw.qs.numpy(), tw.d.numpy())
        np.testing.assert_array_equal(got, block_order(xq, xs, tw.qs.numpy(), tw.d.numpy()))


def test_decode_path_edges():
    """A partial last slot and row group, several row groups per CTA (275
    groups at N = 4400 take two per CTA), M = 8 and 9 (one and two token
    groups)."""
    assert gemv_rule(4, 4400)[3] == 2
    for m, n, nblk in ((8, 70, 33), (9, 100, 31), (4, 4400, 3)):
        xq, xs, w = _inputs(m, n, nblk, seed=m + n)
        tw = tq.quantize_q8_0(torch.from_numpy(w))
        got = gemv_path(xq, xs, tw.qs.numpy(), tw.d.numpy())
        np.testing.assert_array_equal(got, block_order(xq, xs, tw.qs.numpy(), tw.d.numpy()))


# ------------------------------------------------------------- the rules

def test_rules_at_the_chip_shapes():
    """The tile rule fills the SMs at Granite-8B's 256-token chunk and the
    UNet's (4096, 320, 320); the decode rule gives every CTA the same
    number of row groups of 16 rows, and fits two CTAs on an SM at M = 4
    and 5; shared memory within the limit everywhere."""
    bm, bn, _kb = tile_rule(256, 14336)
    assert math.ceil(256 / bm) * math.ceil(14336 / bn) >= 120
    bm, bn, _kb = tile_rule(4096, 320)
    assert math.ceil(4096 / bm) * math.ceil(320 / bn) >= 120
    for m, n, _k in chip_smoke.W8A8_SHAPES + chip_smoke.W8A8_EDGE:
        if m > M_GEMV:
            continue
        ng, st, ctas, per = gemv_rule(m, n)
        assert ctas * per >= math.ceil(n / 16) > (ctas - 1) * per
        assert gemv_smem(ng, st, m) <= 232448
        if m in (4, 5):
            assert SMEM_SM // (gemv_smem(ng, st, m) + RESERVED) >= 2
    for ng, stages in GEMV_STAGES.items():
        assert gemv_smem(ng, max(stages), 8 * ng) <= 232448


def test_every_decode_ring_is_taken():
    """Each ring of the decode path is the rule's choice at some M on the
    H100: one token group takes the deeper ring at M <= 5 and the shallower
    at M = 6..8; two token groups have one ring, of which two CTAs fit on
    an SM at every M = 9..16."""
    taken = {(ng, st) for ng, st, _c, _p in (gemv_rule(m, 14336) for m in range(1, M_GEMV + 1))}
    assert taken == {(ng, st) for ng, stages in GEMV_STAGES.items() for st in stages}
    assert [gemv_rule(m, 14336)[1] for m in range(1, 9)] == [4] * 5 + [3] * 3
    (st2,) = GEMV_STAGES[2]
    for m in range(9, M_GEMV + 1):
        assert SMEM_SM // (gemv_smem(2, st2, m) + RESERVED) >= 2


def test_chip_smoke_holds_the_shapes():
    """chip_smoke holds the kernel at the decode shapes (M = 4, 5, 8, 16),
    Granite-8B's chunk, the UNet's level-0 linears, the path cut (16 and
    17 rows) and a ragged tile with a partial slot; and files both kernels
    as ported."""
    shapes = set(chip_smoke.W8A8_SHAPES)
    assert {(4, 14336, 4096), (4, 4096, 14336), (256, 14336, 4096), (8, 14336, 4096),
            (16, 14336, 4096), (5, 14336, 4096), (4096, 320, 320),
            (4096, 2560, 320)} <= shapes
    assert {(16, 70, 96), (17, 70, 96), (129, 100, 4128)} <= set(chip_smoke.W8A8_EDGE)
    for name in ("w8a8_gemv_kernel", "w8a8_tile_kernel"):
        assert name in SRC and chip_smoke._kind(name) == "ported kernels"
