"""CPU emulations of the two decode kernels' designs.

``csrc/flash_decode.cu``'s cluster decode (contiguous and paged entries)
and ``csrc/q4_matmul.cu``'s decode path run only on the card.  Their
arithmetic is pinned here by plain emulations, held to the port's plain
versions and to the JAX references with the limits ``chip_smoke.py``
applies on the card:

* the cluster decode: CLUSTER CTAs per (row, KV head), each taking
  Kc = ceil(n / CLUSTER) rounded up to 16 keys of the row's range
  [kbase, kend) (contiguous: [0, kv_len); paged: kend = position + 1,
  under a window kmin = kend - window and kbase = kmin rounded down to 16,
  keys before kmin masked); paged rows found through the table once per
  16 keys, keys outside the range never read; 64-key tiles, each
  updating the CTA's (m, l) online; the peers' (m, l) merged in rank
  order; the normalised p rounded to bf16; per-CTA f32 partials summed
  tile by tile; the CTAs' partials added in rank order.
  The logits are recomputed from K where keeping them would pass
  LOGITS_MAX_BYTES;
* the Q4_0 decode path: 16 weight rows per CTA, the warps interleaved
  over 128-element K steps (one Q4_0 block per lane of a row quad), each
  tensor-core product taking elements (j, j+4, j+1, j+5) of one 8-element
  word of each of the 4 blocks, bf16-rounded weights, the warps' partials
  added in warp order.

Guards parse the sources: the constants the emulations use, and every
``__global__`` kernel of ``csrc`` filed under "ported kernels" by
``chip_smoke``'s profiler breakdown.
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
from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
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
DECODE_CASES = _load("torch_generate_cases",
                     ROOT / "tests" / "test_torch_generate.py").DECODE_CASES

# csrc/flash_decode.cu
CLUSTER, KT, LOGITS_MAX_BYTES = 8, 64, 32768
# csrc/q4_matmul.cu
M_GEMV, GEMV_ROWS, GEMV_WARPS, GEMV_UNROLL = 16, 16, 8, 2


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _keeps_logits(g: int, c: int) -> bool:
    tiles = -(-_round16(-(-c // CLUSTER)) // KT)
    return g * tiles * KT * 4 <= LOGITS_MAX_BYTES


def _cluster(qf, fetch, kbase: int, kmin: int, kend: int, scale: float):
    """What one cluster computes for one row: qf (Hkv, G, hd) f32;
    fetch(a, e) -> the K and V rows (Hkv, e - a, hd) of keys [a, e), the
    only keys read; keys [kbase, kend) split over CLUSTER CTAs, those
    before kmin masked.  Returns (Hkv, G, hd) f32 before the bf16 store."""
    h, g, hd = qf.shape
    n = max(kend - kbase, 0)
    kc = _round16(-(-n // CLUSTER))
    ranges, stats = [], []
    for rank in range(CLUSTER):                  # phase 1: each CTA's (m, l)
        lo = kbase + min(rank * kc, n)
        hi = kbase + min(rank * kc + kc, n)
        m = torch.full((h, g), -math.inf)
        l = torch.zeros((h, g))
        tiles = []
        for t0 in range(lo, hi, KT):
            a, e = max(t0, kmin), min(t0 + KT, hi)
            if a >= e:                           # every key masked: (m, l) unchanged
                continue
            kt, vt = fetch(a, e)
            s = torch.einsum("hgd,hcd->hgc", qf, kt.float()) * scale
            mn = torch.maximum(m, s.amax(-1))
            l = torch.where(l > 0, l * torch.exp(m - mn), 0.0) \
                + torch.exp(s - mn[..., None]).sum(-1)
            m = mn
            tiles.append((s, vt))
        ranges.append(tiles)
        stats.append((m, l))
    big_m = torch.full((h, g), -math.inf)        # the merge, in rank order
    for m, l in stats:
        big_m = torch.where(l > 0, torch.maximum(big_m, m), big_m)
    big_l = torch.zeros((h, g))
    for m, l in stats:
        big_l = big_l + torch.where(l > 0, l * torch.exp(m - big_m), 0.0)
    out = torch.zeros((h, g, hd))
    for tiles in ranges:                         # phase 2, tile by tile
        part = torch.zeros((h, g, hd))
        for s, vt in tiles:
            p = (torch.exp(s - big_m[..., None]) / big_l[..., None]).to(torch.bfloat16)
            part = part + torch.einsum("hgc,hcd->hgd", p.float(), vt.float())
        out = out + part                         # the owners' sums, rank order
    return out


def emulate_decode(q, k, v, kv_len: int, scale: float):
    """What the cluster kernel computes.  q (B,Hkv,G,hd), k/v (B,Hkv,C,hd)
    bf16 -> (B,Hkv,G,hd) bf16; slots at or past kv_len are never read."""
    n = min(max(kv_len, 0), k.shape[2])
    qf = q.float()
    return torch.stack([
        _cluster(qf[r], lambda a, e, r=r: (k[r, :, a:e], v[r, :, a:e]), 0, 0, n, scale)
        for r in range(q.shape[0])]).to(torch.bfloat16)


def emulate_decode_paged(q, k_pool, v_pool, tables, positions, scale: float, window=None):
    """What the paged entry computes.  q (B,Hkv,G,hd); pools (NB,Hkv,bs,hd)
    bf16, bs % 16 == 0; tables (B,MB), positions (B,).  Row b's keys
    [kbase, position + 1), kmin = position + 1 - window under a window;
    each 16-key group from a multiple of 16 is one table entry and one
    run of 16 rows of one block; keys outside [kmin, kend) are never
    read."""
    bs, mb = k_pool.shape[2], tables.shape[1]
    assert bs % 16 == 0
    qf = q.float()
    outs = []
    for r in range(q.shape[0]):
        pos = int(positions[r])
        kend = max(0, min(pos + 1, mb * bs))
        kmin = max(0, pos - window + 1) if window else 0
        kbase = kmin & ~15

        def fetch(a, e, r=r):
            ks, vs = [], []
            for g0 in range(a & ~15, e, 16):     # one entry per 16 keys
                blk, off = int(tables[r, g0 // bs]), g0 % bs
                assert off + 16 <= bs
                lo, hi = max(a - g0, 0), min(e - g0, 16)
                ks.append(k_pool[blk, :, off + lo:off + hi])
                vs.append(v_pool[blk, :, off + lo:off + hi])
            return torch.cat(ks, 1), torch.cat(vs, 1)
        outs.append(_cluster(qf[r], fetch, kbase, kmin, kend, scale))
    return torch.stack(outs).to(torch.bfloat16)


def _check_attn(got, want) -> None:
    diff = (got.float() - want.float()).abs()
    excess = (diff - chip_smoke.ATTN_ABS
              - chip_smoke.ATTN_REL * want.float().abs()).max().item()
    assert excess <= 0, f"max|err| {diff.max().item()}; limit exceeded by {excess}"


EXTRA_DECODE = {       # (B, Hkv, G, hd, C, kv_len)
    "kv_len_lt_cluster": (2, 2, 4, 32, 128, 5),
    "kv_len_C_long": (1, 2, 4, 64, 1100, 1100),   # 2 tiles per CTA
    "group_1": (2, 2, 1, 64, 300, 211),
    "group_16": (1, 2, 16, 32, 200, 150),
    "hd_120_two_tiles": (1, 1, 4, 120, 2048, 1500),
    "recompute": (1, 1, 16, 32, 8300, 8200),
}
ALL_DECODE = {**DECODE_CASES, **EXTRA_DECODE}


@pytest.mark.parametrize("case", sorted(ALL_DECODE))
def test_cluster_decode_matches_references(case):
    b, h, g, hd, c, n = ALL_DECODE[case]
    rng = np.random.default_rng(c + n + g)
    qn, kn, vn = (rng.standard_normal(s).astype(np.float32)
                  for s in ((b, h, g, hd), (b, h, c, hd), (b, h, c, hd)))
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn))
    kv = torch.tensor([n], dtype=torch.int32)
    scale = hd ** -0.5
    want = tfd.flash_decode_ref(q, k, v, kv, scale=scale)
    jwant = jfd.flash_decode_ref(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                   for x in (q, k, v)), jnp.asarray([n], jnp.int32),
                                 scale=scale)
    k[:, :, n:], v[:, :, n:] = float("nan"), float("nan")   # never read
    got = emulate_decode(q, k, v, n, scale)
    assert torch.isfinite(got.float()).all()
    _check_attn(got, want)
    _check_attn(got, torch.from_numpy(np.asarray(jwant, np.float32)))


PAGED_HKV, PAGED_G, PAGED_HD = 2, 4, 32     # reduced from chip_smoke's 8, 4, 128
PAGED_CASES = chip_smoke.DECODE_SHAPES + chip_smoke.DECODE_EDGE


def _paged_case(case, seed):
    """chip_smoke._decode_case's inputs at reduced widths, with numpy: a
    random table per row, NULL_BLOCK past each row's position (an idle
    row's table all NULL_BLOCK), and with poison NaN in unlisted blocks,
    in the stale tail of each row's last block and in the null block past
    its first row."""
    positions, mb, window, poison = case
    b, bs = len(positions), chip_smoke.PAGED_BS
    rng = np.random.default_rng(seed)
    nb = b * mb + 8
    tables = (rng.permutation(nb - 1)[:b * mb] + 1).astype(np.int32).reshape(b, mb)
    for r, p in enumerate(positions):
        tables[r, -(-(p + 1) // bs):] = 0
    if positions[-1] == 0:
        tables[-1] = 0
    q = rng.standard_normal((b, PAGED_HKV, PAGED_G, PAGED_HD)).astype(np.float32)
    kp, vp = (rng.standard_normal((nb, PAGED_HKV, bs, PAGED_HD)).astype(np.float32)
              for _ in range(2))
    if poison:
        unlisted = sorted(set(range(1, nb)) - set(tables.ravel().tolist()))[:4]
        for pool in (kp, vp):
            pool[unlisted] = np.nan
            for r, p in enumerate(positions):
                blk = tables[r, p // bs]
                if blk and (p + 1) % bs:
                    pool[blk, :, (p + 1) % bs:] = np.nan
            pool[0, :, 1:] = np.nan
    q, kp, vp = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp))
    return q, kp, vp, torch.from_numpy(tables), torch.tensor(positions, dtype=torch.int32)


@pytest.mark.parametrize("case", PAGED_CASES, ids=[str(c[0]) for c in PAGED_CASES])
def test_paged_cluster_decode_matches_references(case):
    """chip_smoke's paged decode cases (depths to 2100 keys, a window of
    300, NaN-poisoned unlisted blocks and stale tails, an idle row) at
    two KV heads: the emulation is finite and within the attention limit
    of the port's plain version and, without a window, of the JAX
    reference (which has none)."""
    positions, mb, window, _ = case
    q, kp, vp, tables, pos = _paged_case(case, sum(positions) + mb)
    scale = PAGED_HD ** -0.5
    got = emulate_decode_paged(q, kp, vp, tables, pos, scale, window)
    assert torch.isfinite(got.float()).all()
    _check_attn(got, tfd.flash_decode_paged_ref(q, kp, vp, tables, pos, scale=scale,
                                                window=window))
    if window is None:
        jwant = jfd.flash_decode_paged_ref(
            jnp.asarray(q.float().numpy(), jnp.bfloat16),
            *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (kp, vp)),
            jnp.asarray(tables.numpy()), jnp.asarray(pos.numpy()), scale=scale)
        _check_attn(got, torch.from_numpy(np.asarray(jwant, np.float32)))


def test_paged_split_follows_each_row():
    """Per row: the 8 CTAs cover [kbase, kend) on 16-key boundaries, and
    only rank 0 sees masked keys before kmin: DECODE_SHAPES[0]'s row at
    2011 gives 7 CTAs of 256 keys and one of 220; the windowed row at 2000
    (window 300) keys 1696..2000 with 1696..1700 masked."""
    for pos, window, want in ((2011, None, [256] * 7 + [220]),
                              (2000, 300, [48] * 6 + [17, 0]), (0, None, [1] + [0] * 7)):
        kend = pos + 1
        kmin = max(0, kend - window) if window else 0
        kbase = kmin & ~15
        n = kend - kbase
        kc = _round16(-(-n // CLUSTER))
        got = [min(kc, max(0, n - r * kc)) for r in range(CLUSTER)]
        assert got == want and sum(got) == n
        assert all((kbase + r * kc) % 16 == 0 for r in range(CLUSTER))
        assert kmin - kbase < min(kc, 16)


def test_logit_store_threshold():
    """The logits stay in shared memory at every main-path shape and are
    recomputed only past the threshold (C > 16384 at G = 4)."""
    assert all(_keeps_logits(g, c) for _, _, g, _, c, _ in
               chip_smoke.FLASH_DECODE_SHAPES + list(DECODE_CASES.values()))
    assert _keeps_logits(4, 16384) and not _keeps_logits(4, 16385)
    assert _keeps_logits(16, 4096) and not _keeps_logits(16, 4097)
    assert not _keeps_logits(*EXTRA_DECODE["recompute"][2:5:2])
    assert not _keeps_logits(16, 9000)            # chip_smoke's recompute edge


def test_generation_path_split_follows_kv_len():
    """At position 159 of a 2048-slot cache five CTAs take 32 keys each;
    at 2000 seven take 256 and the last 208."""
    for n, want in ((160, [32] * 5 + [0] * 3), (2000, [256] * 7 + [208])):
        kc = _round16(-(-n // CLUSTER))
        got = [min(kc, max(0, n - r * kc)) for r in range(CLUSTER)]
        assert got == want and sum(got) == n


def emulate_q4(x, w: tq.Q4_0Tensor):
    """What the decode path computes: y (M, N) f32."""
    m, kdim = x.shape
    nblk = kdim // 32
    nstep = -(-nblk // 4)
    nwarp = min(GEMV_WARPS, max(1, nstep))
    wb = tq.dequantize_q4_0(w, torch.bfloat16).float()      # bf16-rounded weights
    xf = x.to(torch.bfloat16).float()
    seen = torch.zeros(nblk, dtype=torch.int64)
    parts = []
    for warp in range(nwarp):
        acc = torch.zeros((wb.shape[0], m))
        for st0 in range(warp, nstep, nwarp * GEMV_UNROLL):
            for u in range(GEMV_UNROLL):
                st = st0 + u * nwarp
                blocks = [4 * st + tig for tig in range(4) if st < nstep and 4 * st + tig < nblk]
                seen[blocks] += 1
                for i in range(4):              # word i: elements 8i..8i+7
                    for h in range(2):          # one m16n8k16: pairs (2h, 2h+4), (2h+1, 2h+5)
                        ks = [32 * blk + 8 * i + e for blk in blocks
                              for e in (2 * h, 2 * h + 4, 2 * h + 1, 2 * h + 5)]
                        acc = acc + wb[:, ks] @ xf[:, ks].t()
        parts.append(acc)
    assert torch.equal(seen, torch.ones(nblk, dtype=torch.int64)), seen
    y = torch.zeros_like(parts[0])
    for p in parts:                              # warp order
        y = y + p
    return y.t().contiguous()


@pytest.mark.parametrize("m", [1, 4, 8, 16])
@pytest.mark.parametrize("n,k", [(70, 96), (40, 128), (24, 512), (16, 1152)])
def test_q4_decode_path_matches_references(m, n, k):
    rng = np.random.default_rng(m * 1000 + n + k)
    w = np.abs(rng.standard_normal((n, k))) * k ** -0.5     # lopsided blocks
    w[:, ::7] *= -3.0
    xn = rng.standard_normal((m, k)).astype(np.float32)
    tw = tq.quantize_q4_0(torch.from_numpy(w.astype(np.float32)))
    jw = jq.quantize_q4_0(jnp.asarray(w.astype(np.float32)))
    x = torch.from_numpy(xn).to(torch.bfloat16)
    got = emulate_q4(x, tw)
    for want in (tref.q4_matmul_ref(x, tw),
                 torch.from_numpy(np.asarray(jref.q4_matmul_ref(
                     jnp.asarray(x.float().numpy(), jnp.bfloat16), jw), np.float32))):
        err = (got - want).abs().max().item()
        assert err <= chip_smoke.MATMUL_RTOL * max(1.0, want.abs().max().item()), err


def test_q4_cta_rule_at_the_decode_shapes():
    """Granite-8B's decode linears: 16 rows per CTA, 8 warps, every K
    step taken once; at least 256 CTAs."""
    for n, k in ((14336, 4096), (4096, 14336), (6144, 4096), (4096, 4096)):
        nstep = -(-(k // 32) // 4)
        assert min(GEMV_WARPS, nstep) == GEMV_WARPS
        assert -(-n // GEMV_ROWS) >= 256


def _constants(path: Path) -> dict[str, int]:
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (\w+) = (\d+);", path.read_text())}


def test_sources_match_the_emulations():
    fd = _constants(CSRC / "flash_decode.cu")
    assert (fd["CLUSTER"], fd["KT"], fd["LOGITS_MAX_BYTES"]) == \
        (CLUSTER, KT, LOGITS_MAX_BYTES)
    text = (CSRC / "flash_decode.cu").read_text()
    # The paged range and its 16-key groups, as emulate_decode_paged takes them.
    assert "kbase = kmin & ~15;" in text and "bs % 16 == 0 ? 4 : 0" in text
    assert "kmin = window > 0 ? max(0, pos - window + 1) : 0;" in text
    q4 = _constants(CSRC / "q4_matmul.cu")
    assert (q4["M_GEMV"], q4["GEMV_ROWS"], q4["GEMV_WARPS"], q4["GEMV_UNROLL"]) == \
        (M_GEMV, GEMV_ROWS, GEMV_WARPS, GEMV_UNROLL)


def test_paged_entry_is_one_cluster_launch_without_scratch():
    """flash_decode.cu launches only through cudaLaunchKernelEx (one call
    site, shared by both entries: no <<< >>> launch is left), and the
    paged wrapper allocates nothing but its output."""
    import inspect
    text = (CSRC / "flash_decode.cu").read_text()
    assert "<<<" not in text and text.count("cudaLaunchKernelEx(") == 1
    assert re.findall(r"return launch_cluster\(", text) == ["return launch_cluster("] * 2
    src = inspect.getsource(tfd.flash_decode_paged)
    assert re.findall(r"torch\.\w*empty\w*", src) == ["torch.empty_like"]
    assert not hasattr(tfd, "KEYS_PER_SPLIT") and not hasattr(tfd, "_scratch")


def test_every_kernel_is_filed_as_ported():
    names = set()
    for src in CSRC.glob("*.cu"):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(",
            src.read_text()))
    assert {"decode_cluster_kernel", "q4_gemv_kernel", "flash_attention_kernel"} <= names
    assert not names & {"decode_logits_kernel", "decode_pv_kernel", "decode_sum_kernel",
                        "q4_matmul_kernel"}
    assert all(chip_smoke._kind(name) == "ported kernels" for name in names), \
        sorted(n for n in names if chip_smoke._kind(n) != "ported kernels")
