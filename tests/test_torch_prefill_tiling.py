"""The tile arithmetic of ``csrc/flash_prefill.cu``'s attend launch,
emulated on the CPU.

The CUDA kernel runs only on the card, so what it computes is pinned here
by a plain emulation, held to the port's plain versions and to the JAX
reference with the limit ``chip_smoke.py`` applies on the card
(``ATTN_ABS + ATTN_REL * |ref|``):

* the host's plan: 128 flattened query rows (t*G + g) per CTA, the
  block's key range [kstart, kend), 64-key tiles, and ``split_rule``'s
  CTAs per cluster from the clusters that fit on the card; each CTA's
  contiguous run of the block's tiles;
* per warp of 16 rows and tile: tiles wholly masked for the warp skipped,
  masks applied only on tiles that cross its causal diagonal, its
  window's edge or kend; keys at or past kend zero-filled (never read);
  the online softmax in base 2 with ``c = scale * log2(e)``; P entering
  P.V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi);
* each CTA's partial (m*c, l, O) and their merge in rank order,
  ``out = sum w_j O_j / sum w_j l_j`` with ``w_j = 2^(m_j - M)``.

The Q8_0 pool is read as the kernel's tiles hold it: bf16(float(q) *
float(d)).  A second check parses the kernel's head-dim instantiations
against the wrapper's ``MAX_HEAD_DIM`` and the head dims of the port's
configs, and the constants against the emulation's.
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

from repro.kernels import flash_prefill as jfp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import flash_prefill as tfp  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


ROOT = Path(__file__).resolve().parents[1]
KERNEL_SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_prefill.cu"
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BQ, NT, BKV, STAGES = 128, 256, 64, 3
LOG2E = 1.4426950408889634
# Clusters of 1, 2, 4 and 8 CTAs of the DP = 128 attend kernels (both
# pools) that run at once on an NVIDIA H100 80GB HBM3, one CTA per SM:
# cudaOccupancyMaxActiveClusters as chip_smoke.py logs it (a cluster
# stays within one GPC, so 4- and 8-CTA clusters leave SMs over).
FIT_H100 = (132, 66, 30, 15)
HKV_CARD = 8                  # Granite-8B's KV heads, which the card's rule sees
HKV, G, BS = 2, 4, 16         # the emulation's reduced widths


# ------------------------------------------------------------ the plan

split_rule = chip_smoke.prefill_split_rule


def block_keys(q0: int, nrows: int, g: int, pos0: int, window):
    """(kstart, kend, tiles) of the row block starting at flattened row q0."""
    kend = pos0 + (min(q0 + BQ, nrows) - 1) // g + 1
    kstart = max(0, pos0 + q0 // g - window + 1) if window else 0
    return kstart, kend, -(-(kend - kstart) // BKV) if kend > kstart else 0


def plan(t: int, hkv: int, g: int, pos0: int, window, fit=FIT_H100):
    """(row blocks, CTAs per cluster) as the host computes them, and as
    ``chip_smoke.py`` logs them."""
    nrows = t * g
    nrb = -(-nrows // BQ)
    nt = max(block_keys(rb * BQ, nrows, g, pos0, window)[2] for rb in range(nrb))
    got = nrb, split_rule(nrb * hkv, nt, fit)
    assert chip_smoke.prefill_plan(t, hkv, g, pos0, window, fit) == got
    return got


def runs(nt: int, split: int) -> list[tuple[int, int]]:
    """(first tile, tiles) of each CTA rank."""
    per = -(-nt // split)
    out = []
    for r in range(split):
        t0 = min(r * per, nt)
        out.append((t0, min(t0 + per, nt) - t0))
    return out


# ----------------------------------------------------------- emulation

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate(q, keys, vals, pos0: int, window, split: int, stats=None):
    """What the attend launch computes.  q (T,Hkv,G,hd) bf16; keys/vals
    (Hkv, C, hd) f32, the values its tiles hold (gathered through the
    table; nothing at or past pos0 + T is read).  ``stats`` collects per
    warp and tile whether it was skipped or masked."""
    t, hkv, g, hd = q.shape
    nrows = t * g
    c = abs(hd ** -0.5) * LOG2E
    qf = q.permute(1, 0, 2, 3).reshape(hkv, nrows, hd).float()
    out = torch.zeros((hkv, nrows, hd))
    for q0 in range(0, nrows, BQ):
        kstart, kend, nt = block_keys(q0, nrows, g, pos0, window)
        rows = torch.arange(q0, q0 + BQ)
        qd = pos0 + rows // g                                 # per row
        qrows = torch.nn.functional.pad(qf[:, q0:q0 + BQ], (0, 0, 0, q0 + BQ - min(q0 + BQ, nrows)))
        parts = []
        for t0, ntl in runs(nt, split):
            m = torch.full((hkv, BQ, 1), -math.inf)
            l = torch.zeros((hkv, BQ, 1))
            acc = torch.zeros((hkv, BQ, hd))
            for it in range(ntl):
                k0 = kstart + (t0 + it) * BKV
                kp = torch.arange(k0, k0 + BKV)
                inside = kp < kend                            # zero-filled past kend
                kt = torch.zeros((hkv, BKV, hd))
                vt = torch.zeros((hkv, BKV, hd))
                n_in = int(inside.sum())
                kt[:, :n_in] = keys[:, k0:k0 + n_in]
                vt[:, :n_in] = vals[:, k0:k0 + n_in]
                s = qrows @ kt.transpose(1, 2)                # (Hkv, BQ, 64)
                ok_rows = torch.ones((BQ, 1), dtype=torch.bool)
                for w in range(BQ // 16):
                    qw0 = q0 + 16 * w
                    sl = slice(16 * w, 16 * w + 16)
                    live = qw0 < nrows
                    qlo, qhi = pos0 + qw0 // g, pos0 + min(qw0 + 15, nrows - 1) // g
                    skip = (not live or k0 > qhi
                            or (window and k0 + BKV - 1 <= qlo - window))
                    edge = (k0 + BKV - 1 > qlo or k0 + BKV > kend
                            or (window and k0 <= qhi - window))
                    if stats is not None and live:
                        stats.append((q0, t0 + it, w, "skip" if skip else
                                      "edge" if edge else "full"))
                    if skip:
                        ok_rows[sl] = False
                        continue
                    if edge:
                        ok = inside[None, :] & (kp[None, :] <= qd[sl, None])
                        if window:
                            ok = ok & (kp[None, :] > qd[sl, None] - window)
                        s[:, sl] = s[:, sl].masked_fill(~ok, -math.inf)
                mx = torch.maximum(m, s.amax(-1, keepdim=True))
                mc = torch.where(mx == -math.inf, 0.0, mx * c)
                alpha = torch.exp2(m * c - mc)
                p = torch.exp2(s * c - mc)
                hi = _bf16(p)
                lo = _bf16(p - hi)
                upd = ok_rows[None]                           # skipped warps keep their state
                l = torch.where(upd, l * alpha + p.sum(-1, keepdim=True), l)
                acc = torch.where(upd, acc * alpha + hi @ vt + lo @ vt, acc)
                m = torch.where(upd, mx, m)
            parts.append((torch.where(m == -math.inf, 0.0, m * c), l, acc))
        big = torch.full((hkv, BQ, 1), -math.inf)
        for mj, lj, _ in parts:
            big = torch.where(lj > 0, torch.maximum(big, mj), big)
        total = torch.zeros((hkv, BQ, 1))
        o = torch.zeros((hkv, BQ, hd))
        for mj, lj, aj in parts:                              # rank order
            w = torch.where(lj > 0, torch.exp2(mj - big), 0.0)
            total = total + lj * w
            o = o + aj * w
        res = torch.where(total > 0, o / total, 0.0)
        n = min(q0 + BQ, nrows) - q0
        out[:, q0:q0 + n] = res[:, :n]
    return _bf16(out).reshape(hkv, t, g, hd).permute(1, 0, 2, 3).to(torch.bfloat16)


# --------------------------------------------------------------- inputs

def _case(t, pos0, mb, window, poison, q8, hd, seed):
    """Seeded numpy inputs as chip_smoke builds them (a random table padded
    with NULL_BLOCK, NaN / 127 in unlisted blocks and the stale tail)."""
    rng = np.random.default_rng(seed)
    nb = mb + 6
    used = -(-(pos0 + t) // BS)
    table = (rng.permutation(nb - 1)[:mb] + 1).astype(np.int32)
    table[used:] = 0
    q = rng.standard_normal((t, HKV, G, hd)).astype(np.float32)
    kn = rng.standard_normal((t, HKV, hd)).astype(np.float32)
    vn = rng.standard_normal((t, HKV, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, HKV, BS, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, HKV, BS, hd)).astype(np.float32)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, kn, vn, kp, vp)]
    pools = bf[3:]
    if q8:
        t8 = [tq.quantize_q8_0(x.float()) for x in pools]
        pools = [t8[0].qs, t8[1].qs, t8[0].d, t8[1].d]
    if poison:
        listed = set(table.tolist())
        unlisted = [b for b in range(1, nb) if b not in listed][:4]
        off = (pos0 + t) % BS
        last = int(table[(pos0 + t - 1) // BS])
        for p in pools:
            bad = float("nan") if p.is_floating_point() else 127
            p[unlisted] = bad
            if off:
                p[last, :, off:] = bad
    return bf[0], bf[1], bf[2], pools, torch.from_numpy(table)


def _gathered(pools, table, q8, hd):
    """(Hkv, MB*bs, hd) f32 keys and values as the kernel's tiles hold them."""
    tbl = table.long()
    if q8:
        kq, vq, ks, vs = pools

        def deq(qp, sp):
            x = qp[tbl].float().reshape(*qp[tbl].shape[:3], hd // 32, 32) * sp[tbl].float()[..., None]
            return _bf16(x.reshape(qp[tbl].shape))
        k, v = deq(kq, ks), deq(vq, vs)
    else:
        k, v = pools[0][tbl].float(), pools[1][tbl].float()
    mb = tbl.shape[0]
    return (k.transpose(0, 1).reshape(HKV, mb * BS, hd),
            v.transpose(0, 1).reshape(HKV, mb * BS, hd))


def _check(got, want) -> None:
    diff = (got.float() - want.float()).abs()
    excess = (diff - chip_smoke.ATTN_ABS
              - chip_smoke.ATTN_REL * want.float().abs()).max().item()
    assert torch.isfinite(got.float()).all()
    assert excess <= 0, f"max|err| {diff.max().item()}; limit exceeded by {excess}"


def _run(case, q8, hd, split=None, stats=None):
    t, pos0, mb, window, poison = case
    q, kn, vn, pools, table = _case(t, pos0, mb, window, poison, q8, hd,
                                    seed=t + pos0 + hd + 7 * q8)
    jpools = [jnp.asarray(p.float().numpy() if p.dtype == torch.bfloat16 else p.numpy())
              for p in pools]
    jin = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, kn, vn)]
    if q8:
        jwant = jfp.flash_prefill_paged_q8_ref(*jin, *jpools, jnp.asarray(table.numpy()),
                                               pos0, window=window)[0]
        want = tfp.flash_prefill_paged_q8_ref(q, kn, vn, *pools, table, pos0,
                                              window=window)[0]
    else:
        jwant = jfp.flash_prefill_paged_ref(*jin, *(x.astype(jnp.bfloat16) for x in jpools),
                                            jnp.asarray(table.numpy()), pos0,
                                            window=window)[0]
        want = tfp.flash_prefill_paged_ref(q, kn, vn, *pools, table, pos0, window=window)[0]
    # The plain version wrote the chunk into `pools` in place, as the
    # write launch does before the attend launch reads them.
    keys, vals = _gathered(pools, table, q8, hd)
    if split is None:
        split = plan(t, HKV_CARD, G, pos0, window)[1]
    got = emulate(q, keys, vals, pos0, window, split, stats)
    _check(got, want)
    _check(got, torch.from_numpy(np.asarray(jwant, np.float32)))
    return got


CASES = chip_smoke.PREFILL_SHAPES + chip_smoke.PREFILL_EDGE


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("case", CASES, ids=[str(c[:4]) for c in CASES])
def test_tiling_matches_references(case, q8):
    """chip_smoke's prefill shapes and edge cases at two KV heads."""
    _run(case, q8, hd=32)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("case", [(256, 1000, 128, None, True), (256, 1792, 128, 700, False),
                                  (5, 20, 8, None, True)], ids=["ragged", "window", "short"])
def test_every_split_merges_to_the_reference(case, split):
    """The rank-order merge at every cluster size the rule may pick,
    including ranks with no tile."""
    _run(case, False, hd=64, split=split)


def test_head_dim_128_and_q8_0():
    """Granite-8B's head dim on the main chunk, both pools."""
    for q8 in (False, True):
        _run((256, 1792, 128, None, False), q8, hd=128)


def test_masks_only_on_crossing_tiles():
    """At (256, 1792) a warp masks only the tiles that cross its diagonal
    or kend (at most two) and skips those past its last row; every
    history tile is taken whole."""
    stats = []
    _run((256, 1792, 128, None, False), False, hd=32, stats=stats)
    per_warp = {}
    for q0, tile, w, kind in stats:
        per_warp.setdefault((q0, w), []).append((tile, kind))
    for (q0, w), tiles in per_warp.items():
        kinds = [k for _, k in sorted(tiles)]
        assert set(kinds[:28]) == {"full"}, (q0, w)           # 1792 history keys
        assert 1 <= kinds.count("edge") <= 2, (q0, w, kinds)
        first_skip = kinds.index("skip") if "skip" in kinds else len(kinds)
        assert "full" not in kinds[first_skip:] and "edge" not in kinds[first_skip:]


def test_window_masks_and_skips():
    stats = []
    _run((256, 1792, 128, 700, False), False, hd=32, stats=stats)
    kinds = [k for *_, k in stats]
    assert kinds.count("skip") and kinds.count("edge") and kinds.count("full")


def test_split_rule_at_granite_shapes():
    """Granite-8B's chunks (Hkv 8, G 4): 64 row blocks of 128 rows; two
    CTAs per cluster at 256 tokens, eight for a short chunk at depth."""
    want = {(256, 0): (8, 2), (256, 1792): (8, 2), (208, 1792): (7, 2),
            (256, 3840): (8, 2), (16, 2000): (1, 8), (8, 1792): (1, 8), (1, 0): (1, 1)}
    got = {key: plan(*key[:1], HKV_CARD, G, key[1], None) for key in want}
    assert got == want
    # The key runs of the heaviest block at (256, 1792): 32 tiles, 16 each.
    assert runs(32, 2) == [(0, 16), (16, 16)]
    assert runs(3, 4) == [(0, 1), (1, 1), (2, 1), (3, 0)]   # a rank with no tile
    # A cluster size that cannot run is never picked.
    assert split_rule(64, 32, (132, 0, 32, 0)) == 4


def _constants(path: Path = KERNEL_SRC) -> dict[str, int]:
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (\w+) = (\d+);", path.read_text())}


def test_sources_match_the_emulation():
    c = _constants()
    assert (c["BQ"], c["NT"], c["STAGES"]) == (BQ, NT, STAGES)
    assert _constants(KERNEL_SRC.parent / "common.cuh")["FLASH_BKV"] == BKV
    text = KERNEL_SRC.read_text()
    assert "constexpr int BKV = FLASH_BKV;" in text
    assert "if (fit[i] < 1) continue;" in text
    assert re.search(r"cost = \(blocks \+ fit\[i\] - 1\) / fit\[i\] \* "
                     r"\(\(nt \+ \(1 << i\) - 1\) >> i\);", text)
    assert "if (cost < best_cost)" in text                    # ties: the smaller S


def scale_copy(si: int) -> tuple[int, int]:
    """(first f16, f16s read) of the attend kernel's copy of Q8_0 scale si:
    the aligned 4-byte word that holds it, only its low half when si is
    even, so that no copy reads past the pool's last scale."""
    return si & ~1, 2 if si & 1 else 1


@pytest.mark.parametrize("nb,hkv,bs,hd", [(3, 1, 5, 32), (5, 3, 7, 96), (4, 8, 16, 128)],
                         ids=["odd-count", "odd-bs", "granite"])
def test_scale_copies_stay_inside_the_pool(nb, hkv, bs, hd):
    """Every scale copy lies inside (NB, Hkv, bs, hd/32), also when that
    count is odd, and the half the dequantization picks (the row's parity
    byte) is the scale itself."""
    nsc = hd // 32
    total = nb * hkv * bs * nsc
    for prow in range(nb * hkv * bs):
        for cc in range(nsc):
            si = prow * nsc + cc
            first, n = scale_copy(si)
            assert first + n <= total and first <= si < first + n
            assert first + (((prow & 1) * nsc + cc) & 1) == si
    text = KERNEL_SRC.read_text()
    assert "const size_t si = prow * C::NSC + cc, s = si & ~(size_t)1;" in text
    assert "const int n = in ? (si & 1 ? 4 : 2) : 0;" in text
    assert "(slot[2 * C::CODES + 2 * C::SCALES + r] * C::NSC + j) & 1" in text


def _instantiated() -> dict[bool, set[int]]:
    cases = re.findall(r"case (\d+): return op\.template run<(\d+), (false|true)>",
                       KERNEL_SRC.read_text())
    assert cases
    out = {False: set(), True: set()}
    for a, b, q8 in cases:
        out[q8 == "true"].add(int(b))
        assert int(a) == int(b)
    return out


def test_instantiations_cover_the_wrappers():
    """Every head dim the wrappers accept (bf16: hd % 8 == 0; Q8_0: hd %
    32 == 0; hd <= MAX_HEAD_DIM) has its DP built."""
    dps = _instantiated()
    bf16 = {(d + 15) // 16 * 16 for d in range(8, tfp.MAX_HEAD_DIM + 1, 8)}
    q8 = set(range(32, tfp.MAX_HEAD_DIM + 1, 32))
    assert dps[False] == bf16 and dps[True] == q8, dps


def test_config_head_dims_fit_the_kernel():
    """Granite-8B 128, h2o-danube-3-4b 120, the reduced configs' 32, the
    other LMs: each pads to a bf16 instantiation, and to a Q8_0 one when
    a multiple of 32."""
    lms = [configs.get_config(name) for name in configs.ARCHS]
    hds = {cfg.hd for cfg in lms} | {configs.reduced(cfg).hd for cfg in lms}
    assert {128, 120, 32} <= hds
    dps = _instantiated()
    for hd in hds:
        if hd % 8 == 0 and hd <= tfp.MAX_HEAD_DIM:
            assert (hd + 15) // 16 * 16 in dps[False], hd
            assert hd % 32 or hd in dps[True], hd
