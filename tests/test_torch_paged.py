"""Port parity: the paged KV path of LM serving at TINY sizes.

* The plain versions of the three paged kernels (``flash_prefill_paged``,
  ``flash_prefill_paged_q8``, ``flash_decode_paged``) against the
  reference's XLA oracles on the same seeded f32 inputs: outputs within
  ``rtol = atol = 1e-5`` (f32 sums in another order), pools and Q8_0
  bytes exact, with NaN-poisoned recycled blocks, prefix-shared
  read-only history blocks and windows.
* The model functions of the paged path (``attention_prefill_paged``,
  ``attention_decode``, ``lm_prefill_chunk`` fused and scanned,
  ``lm_decode_step``, ``lm_forward``) against the JAX functions with the
  same weights (``weights.from_reference``).  Run op by op, the reference
  rounds where the port does, so one layer agrees exactly (its pools bit
  for bit) or to a bf16 ulp on a few elements; the compiled stack
  (``lax.scan``) keeps some bf16 intermediates in f32, so logits agree to
  ``LOGIT_TOL`` and deeper layers' pools to a few ulps.
* The host-side ``kvcache`` runtime of both packages, driven by the same
  operations, ends in the same state.
* The CUDA wrappers refuse CPU tensors instead of computing.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.kernels import flash_prefill as jfp  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import flash_prefill as tfp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serving import kvcache as tkv  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


pytestmark = pytest.mark.serving

TOL = dict(rtol=1e-5, atol=1e-5)
# Logits are the bf16 head output cast to f32; after two bf16 layers an ulp
# flip in an activation moves a logit by a few bf16 ulps (measured <= 0.025
# at |logit| < 2).
LOGIT_TOL = dict(rtol=2e-2, atol=5e-2)
CFG_KW = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=96,
              head_dim=32)
JCFG, TCFG = jbase.ModelConfig(**CFG_KW), tbase.ModelConfig(**CFG_KW)
JGRAN = jbase.reduced(jget_config("granite-8b"))
TGRAN = tbase.reduced(tget_config("granite-8b"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "V" or "bfloat16" in str(a.dtype) else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------- kernel plain versions
H, G, D, BS, NB = 2, 2, 32, 8, 8
TABLE = np.array([3, 1, 4, 2], np.int32)            # non-monotonic on purpose


def _prefill_inputs(t, seed):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (t, H, G, D), 0.5), _rand(rng, (t, H, D), 0.5),
            _rand(rng, (t, H, D)), _rand(rng, (NB, H, BS, D), 0.5),
            _rand(rng, (NB, H, BS, D)))


def _poison(pool, t, pos0):
    """NaN into unlisted blocks and the stale tail past the chunk."""
    pool = pool.copy()
    pool[[0, 5, 6, 7]] = np.nan
    blk, off = TABLE[(pos0 + t) // BS], (pos0 + t) % BS
    pool[blk, :, off:] = np.nan
    return pool


PREFILL_CASES = [(1, 0, None), (1, 7, None), (3, 5, None), (3, 8, None),
                 (8, 0, None), (8, 5, None), (8, 13, None), (3, 5, 6),
                 (8, 13, 6)]


@pytest.mark.parametrize("t,pos0,window", PREFILL_CASES)
@pytest.mark.parametrize("poison", [False, True])
def test_prefill_plain_matches_reference(t, pos0, window, poison):
    q, kn, vn, kp, vp = _prefill_inputs(t, 31 * t + pos0)
    if poison:
        kp, vp = _poison(kp, t, pos0), _poison(vp, t, pos0)
    want, wk, wv = jfp.flash_prefill_paged_ref(
        *(jnp.asarray(a) for a in (q, kn, vn, kp, vp, TABLE)), pos0,
        window=window)
    got, gk, gv = tfp.flash_prefill_paged_ref(
        *(_t(a) for a in (q, kn, vn, kp, vp, TABLE)), pos0, window=window)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_array_equal(_np(gk), _np(wk))
    np.testing.assert_array_equal(_np(gv), _np(wv))


def _q8_pools(kp, vp):
    from repro.core import quant as jq
    k8, v8 = jq.quantize_q8_0(jnp.asarray(kp)), jq.quantize_q8_0(jnp.asarray(vp))
    return [np.asarray(a) for a in (k8.qs, v8.qs, k8.d, v8.d)]


@pytest.mark.parametrize("t,pos0,window", PREFILL_CASES)
@pytest.mark.parametrize("poison", [False, True])
def test_prefill_q8_plain_matches_reference(t, pos0, window, poison):
    q, kn, vn, kp, vp = _prefill_inputs(t, 7 * t + pos0)
    pools = _q8_pools(kp, vp)
    if poison:                     # stale int8 quants, NaN scales
        pools = [_poison(p.astype(np.float32), t, pos0).astype(p.dtype)
                 if p.dtype == np.float16 else p for p in pools]
    want = jfp.flash_prefill_paged_q8_ref(
        *(jnp.asarray(a) for a in (q, kn, vn, *pools, TABLE)), pos0,
        window=window)
    got = tfp.flash_prefill_paged_q8_ref(
        *(_t(a) for a in (q, kn, vn, *pools, TABLE)), pos0, window=window)
    assert np.isfinite(_np(got[0])).all()
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **TOL)
    for g_, w_ in zip(got[1:], want[1:]):          # quants and scales
        np.testing.assert_array_equal(_np(g_), np.asarray(w_))


@pytest.mark.parametrize("q8", [False, True])
def test_prefill_leaves_history_and_unlisted_blocks_bit_identical(q8):
    """History below pos0 (prefix-shared, read-only) and every block
    outside the table come back unchanged: only the chunk's rows move."""
    t, pos0 = 4, 8                                   # history fills TABLE[0]
    q, kn, vn, kp, vp = _prefill_inputs(t, 4)
    pools = [_t(a) for a in (_q8_pools(kp, vp) if q8 else (kp, vp))]
    before = [p.clone() for p in pools]
    fn = tfp.flash_prefill_paged_q8_ref if q8 else tfp.flash_prefill_paged_ref
    fn(_t(q), _t(kn), _t(vn), *pools, _t(TABLE), pos0)
    written = {int(TABLE[p // BS]) for p in range(pos0, pos0 + t)}
    for p, b in zip(pools, before):
        for blk in range(NB):
            if blk not in written:
                assert torch.equal(p[blk], b[blk]), blk


DECODE_CASES = [([0, 5], None), ([17, 9], None), ([23, 23], None),
                ([20, 3], 6)]


@pytest.mark.parametrize("positions,window", DECODE_CASES)
@pytest.mark.parametrize("poison", [False, True])
def test_decode_plain_matches_reference(positions, window, poison):
    rng = np.random.default_rng(sum(positions))
    b, g, nb = 2, 4, 9
    q = _rand(rng, (b, H, g, D), 0.4)
    kp, vp = _rand(rng, (nb, H, BS, D), 0.4), _rand(rng, (nb, H, BS, D))
    tbl = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    if poison:
        for pool in (kp, vp):
            pool[[7, 8]] = np.nan                    # unlisted blocks
            for r, p in enumerate(positions):
                pool[tbl[r, p // BS], :, p % BS + 1:] = np.nan
    pos = np.asarray(positions, np.int32)
    got = tfd.flash_decode_paged_ref(*(_t(a) for a in (q, kp, vp, tbl, pos)),
                                     window=window)
    assert np.isfinite(_np(got)).all()
    if window is None:
        want = jfd.flash_decode_paged_ref(
            *(jnp.asarray(a) for a in (q, kp, vp, tbl, pos)))
    else:      # the reference kernel has no window: numpy, as its decode masks
        want = _windowed_decode(q, kp, vp, tbl, pos, window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _windowed_decode(q, kp, vp, tbl, pos, window):
    b, h, g, d = q.shape
    keys = np.nan_to_num(kp[tbl]).transpose(0, 2, 1, 3, 4).reshape(b, h, -1, d)
    vals = np.nan_to_num(vp[tbl]).transpose(0, 2, 1, 3, 4).reshape(b, h, -1, d)
    logits = np.einsum("bhgd,bhcd->bhgc", q, keys) * d ** -0.5
    idx = np.arange(keys.shape[2])[None, :]
    valid = (idx <= pos[:, None]) & (idx > pos[:, None] - window)
    logits = np.where(valid[:, None, None, :], logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhgc,bhcd->bhgd", p, vals)


def test_decode_plain_rounds_p_like_the_reference_decode_step():
    """With a bf16 pool the plain version is the reference's decode read
    (``attention_decode``'s einsums: bf16 P times bf16 V, f32 sums)."""
    rng = np.random.default_rng(3)
    q = jnp.asarray(_rand(rng, (2, H, 4, D), 0.4), jnp.bfloat16)
    kp = jnp.asarray(_rand(rng, (9, H, BS, D), 0.4), jnp.bfloat16)
    vp = jnp.asarray(_rand(rng, (9, H, BS, D)), jnp.bfloat16)
    tbl = jnp.array([[1, 2, 3], [4, 5, 6]], jnp.int32)
    pos = jnp.array([17, 9], jnp.int32)
    keys = kp[tbl].transpose(0, 2, 1, 3, 4).reshape(2, H, 24, D)
    vals = vp[tbl].transpose(0, 2, 1, 3, 4).reshape(2, H, 24, D)
    valid = jnp.arange(24)[None, :] <= pos[:, None]
    logits = jnp.einsum("bhgd,bhcd->bhgc", q, keys,
                        preferred_element_type=jnp.float32) * D ** -0.5
    probs = jax.nn.softmax(jnp.where(valid[:, None, None, :], logits, -jnp.inf), -1)
    want = jnp.einsum("bhgc,bhcd->bhgd", probs.astype(jnp.bfloat16),
                      jnp.where(valid[:, None, :, None], vals, 0),
                      preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    got = tfd.flash_decode_paged_ref(
        *(from_reference(a, "cpu") for a in (q, kp, vp, tbl, pos)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)
    assert (np.abs(_np(got) - _np(want)) > 0).mean() < 0.05


def test_wrappers_refuse_cpu_tensors():
    """On the CPU only ``ops`` computes (through the plain versions); the
    kernels' wrappers launch or raise."""
    q, kn, vn, kp, vp = (_t(a).to(torch.bfloat16) for a in _prefill_inputs(3, 0))
    tbl = _t(TABLE)
    with pytest.raises(ValueError):
        tfp.flash_prefill_paged(q, kn, vn, kp, vp, tbl, 0)
    kq, vq, ks, vs = (_t(a) for a in _q8_pools(_np(kp), _np(vp)))
    with pytest.raises(ValueError):
        tfp.flash_prefill_paged_q8(q, kn, vn, kq, vq, ks, vs, tbl, 0)
    with pytest.raises(ValueError):
        tfd.flash_decode_paged(q[:1].expand(1, H, G, D), kp, vp,
                               tbl[None, :3], torch.tensor([5], dtype=torch.int32))
    tops.reset_launch_counts()
    tops.paged_prefill_attention(q, kn, vn, kp, vp, tbl, 0)
    tops.paged_decode_attention(q[:1], kp, vp, tbl[None, :3],
                                torch.tensor([5], dtype=torch.int32))
    assert not any(tops.launch_counts().values())


# ------------------------------------------------------------ model level

@pytest.fixture(scope="module")
def tiny():
    jp = jT.init_lm(jax.random.PRNGKey(0), JCFG)
    return jp, from_reference(jp, "cpu")


@pytest.fixture(scope="module")
def granite():
    jp = jT.init_lm(jax.random.PRNGKey(1), JGRAN)
    return jp, from_reference(jp, "cpu")


def _caches(jcfg, tcfg, jparams, tparams, quantized, nb=12, bs=4):
    jc = jT.init_cache(jparams, jcfg, 2, 16, quantized_kv=quantized,
                       block_size=bs, num_blocks=nb)
    tc = tT.init_cache(tparams, tcfg, 2, 16, quantized_kv=quantized,
                       block_size=bs, num_blocks=nb, device="cpu")
    return jc, tc


def _pools_match(jc, tc, *, exact=True):
    for layer, c in enumerate(tc):
        for name, pool in zip(("k", "v", "k_scale", "v_scale"), c):
            if pool is None:
                continue
            want = np.asarray(getattr(jc[0].kv, name)[layer])
            got = _np(pool)
            want = _np(want)
            if exact or layer == 0:
                np.testing.assert_array_equal(got, want, err_msg=name)
                continue
            # Deeper layers see the compiled reference's activations, which
            # keep some bf16 intermediates in f32: K/V move by a few bf16
            # ulps on a few percent of elements, Q8_0 quants by a step or two.
            diff = np.abs(got.astype(np.float32) - want)
            assert (got != want).mean() < 0.15, name
            if want.dtype.kind in "iu":
                assert diff.max() <= 2, name
            else:
                assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999, name


def _tokens(seed, n, vocab):
    return np.random.default_rng(seed).integers(1, vocab - 1, (1, n)).astype(np.int32)


@pytest.mark.parametrize("quantized", [False, True])
def test_attention_prefill_paged_matches(tiny, quantized):
    jp, tp = tiny
    jl = jax.tree.map(lambda a: a[0], jp["layers"][0]["attn"])
    tl = tp["layers"][0]["attn"]
    jc, tc = _caches(JCFG, TCFG, jp, tp, quantized)
    jkvc = jax.tree.map(lambda a: a[0], jc[0].kv)
    table = np.array([[5, 2, 9, 7]], np.int32)
    x = jnp.asarray(_rand(np.random.default_rng(0), (1, 11, 64)), jnp.bfloat16)
    tx = from_reference(x, "cpu")
    for lo, hi in ((0, 6), (6, 11)):             # two chunks, history then chunk
        jout, jkvc = jattn.attention_prefill_paged(
            jl, JCFG, x[:, lo:hi], jnp.array([lo], jnp.int32), jkvc,
            jnp.asarray(table))
        tout, tkvc = tattn.attention_prefill_paged(
            tl, TCFG, tx[:, lo:hi], lo, tc[0], _t(table))
        np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-2, atol=1e-2)
        assert (_np(tout) != _np(jout)).mean() < 0.05
    for name, pool in zip(("k", "v", "k_scale", "v_scale"), tkvc):
        if pool is not None:
            np.testing.assert_array_equal(_np(pool), _np(getattr(jkvc, name)))


@pytest.mark.parametrize("quantized", [False, True])
def test_attention_decode_paged_matches(tiny, quantized):
    jp, tp = tiny
    jl = jax.tree.map(lambda a: a[0], jp["layers"][0]["attn"])
    tl = tp["layers"][0]["attn"]
    jc, tc = _caches(JCFG, TCFG, jp, tp, quantized)
    jkvc = jax.tree.map(lambda a: a[0], jc[0].kv)
    tkvc = tc[0]
    tables = np.array([[3, 4, 0, 0], [6, 1, 8, 0]], np.int32)
    rng = np.random.default_rng(1)
    for step, pos in enumerate(([0, 0], [1, 1], [2, 9], [3, 10])):
        x = jnp.asarray(_rand(rng, (2, 1, 64)), jnp.bfloat16)
        p = np.asarray(pos, np.int32)
        jout, jkvc = jattn.attention_decode(jl, JCFG, x, jnp.asarray(p), jkvc,
                                            block_tables=jnp.asarray(tables))
        tout, tkvc = tattn.attention_decode(tl, TCFG, from_reference(x, "cpu"),
                                            _t(p), tkvc, block_tables=_t(tables))
        np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-2, atol=1e-2)
    for name, pool in zip(("k", "v", "k_scale", "v_scale"), tkvc):
        if pool is not None:
            np.testing.assert_array_equal(_np(pool), _np(getattr(jkvc, name)))


@pytest.mark.parametrize("model,quantized,fused", [
    ("tiny", False, True), ("tiny", True, True), ("tiny", False, False),
    ("tiny", True, False), ("granite", False, True), ("granite", True, True)])
def test_prefill_chunks_then_decode_match(request, model, quantized, fused):
    """Two prefill chunks (the second straddling a block) then two decode
    steps: logits and pools against the JAX functions."""
    jcfg, tcfg = (JCFG, TCFG) if model == "tiny" else (JGRAN, TGRAN)
    jp, tp = request.getfixturevalue(model)
    jc, tc = _caches(jcfg, tcfg, jp, tp, quantized)
    row = np.array([[7, 2, 10, 4]], np.int32)
    toks = _tokens(5, 9, jcfg.vocab_size)
    for lo, hi in ((0, 5), (5, 9)):
        jl, jc = jT.lm_prefill_chunk(jp, jcfg, jnp.asarray(toks[:, lo:hi]),
                                     jnp.array([lo], jnp.int32), jc,
                                     block_tables=jnp.asarray(row), fused=fused)
        tl, tc = tT.lm_prefill_chunk(tp, tcfg, _t(toks[:, lo:hi]), lo, tc,
                                     block_tables=_t(row), fused=fused)
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (1, 1, jcfg.vocab_size)
    _pools_match(jc, tc, exact=False)
    tables = np.array([[7, 2, 10, 4], [0, 0, 0, 0]], np.int32)
    tok = np.array([[int(np.argmax(_np(tl)))], [0]], np.int32)
    for pos in (9, 10):
        p = np.array([pos, 0], np.int32)
        jl, jc = jT.lm_decode_step(jp, jcfg, jnp.asarray(tok), jnp.asarray(p), jc,
                                   block_tables=jnp.asarray(tables))
        tl, tc = tT.lm_decode_step(tp, tcfg, _t(tok), _t(p), tc,
                                   block_tables=_t(tables))
        np.testing.assert_allclose(_np(tl[0]), _np(jl[0]), **LOGIT_TOL)
        tok = np.array([[int(np.argmax(_np(tl[0])))], [0]], np.int32)


def test_fused_prefill_equals_scan(granite):
    """The port's fused chunk prefill against its own decode-step scan."""
    _, tp = granite
    row = _t(np.array([[3, 1, 6, 2]], np.int32))
    toks = _t(_tokens(8, 11, TGRAN.vocab_size))
    out = {}
    for fused in (True, False):
        cache = tT.init_cache(tp, TGRAN, 1, 16, block_size=4, num_blocks=8,
                              device="cpu")
        out[fused], cache = tT.lm_prefill_chunk(tp, TGRAN, toks, 0, cache,
                                                block_tables=row, fused=fused)
    np.testing.assert_allclose(_np(out[True]), _np(out[False]), **LOGIT_TOL)


def test_lm_forward_matches(granite):
    jp, tp = granite
    toks = _tokens(2, 12, JGRAN.vocab_size)
    jl, _ = jT.lm_forward(jp, JGRAN, jnp.asarray(toks))
    tl, aux = tT.lm_forward(tp, TGRAN, _t(toks))
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    last, _ = tT.lm_forward(tp, TGRAN, _t(toks), last_only=True)
    np.testing.assert_array_equal(_np(last[:, 0]), _np(tl[:, -1]))


def test_unported_stacks_raise():
    """Nothing of the reference's stacks is refused any more: qwen2-vl-72b
    and M-RoPE configs build (since the VLM slice), as xLSTM and hybrid
    stacks do (since models.ssm); an unknown block kind still raises."""
    assert tget_config("qwen2-vl-72b").mrope
    mrope = tbase.reduced(tbase.ModelConfig(
        name="v", family="vlm", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=96, mrope=True))
    cache = tT.init_cache({}, mrope, 1, 8, block_size=4, num_blocks=4, device="cpu")
    assert type(cache[0]).__name__ == "KVCache"
    with pytest.raises(ValueError, match="unknown block kinds"):
        tT.init_cache({}, dataclasses.replace(mrope, block_pattern=("conv",)), 1, 8,
                      device="cpu")
    hybrid = tbase.reduced(tbase.ModelConfig(
        name="h", family="hybrid", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=96, block_pattern=("attn", "mamba")))
    cache = tT.init_cache({}, hybrid, 1, 8, block_size=4, num_blocks=4, device="cpu")
    assert type(cache[1]).__name__ == "MambaState"


@pytest.mark.parametrize("arch", ["granite-8b", "llama3-405b", "h2o-danube-3-4b",
                                  "qwen1.5-110b", "deepseek-moe-16b",
                                  "moonshot-v1-16b-a3b", "xlstm-1.3b",
                                  "jamba-1.5-large-398b", "qwen2-vl-72b"])
def test_configs_copied(arch):
    import dataclasses
    assert dataclasses.asdict(tget_config(arch)) == {
        k: v for k, v in dataclasses.asdict(jget_config(arch)).items()
        if k in {f.name for f in dataclasses.fields(tbase.ModelConfig)}}
    assert dataclasses.asdict(tbase.reduced(tget_config(arch))) == {
        k: v for k, v in dataclasses.asdict(jbase.reduced(jget_config(arch))).items()
        if k in {f.name for f in dataclasses.fields(tbase.ModelConfig)}}


# ----------------------------------------------------------- kvcache host

def _drive(mod, seed):
    """A seeded sequence of admits, CoW writes and releases with prefix
    sharing; returns the runtime's observable state after each op."""
    rng = np.random.default_rng(seed)
    copies = []
    rt = mod.PagedKVRuntime(slots=3, max_len=24, block_size=4,
                            prefix_share=True, extra_blocks=6,
                            copy_block=lambda s, d: copies.append((s, d)))
    base = [int(t) for t in rng.integers(1, 50, 12)]
    trace = []
    for _ in range(40):
        slot = int(rng.integers(0, 3))
        if rt._owned[slot] == 0:
            n = int(rng.integers(3, 14))
            prompt = base[:n] if rng.random() < 0.6 else \
                [int(t) for t in rng.integers(1, 50, n)]
            got = rt.admit(slot, prompt, int(rng.integers(1, 8)))
            trace.append(("admit", slot, got))
            if got is not None:
                rt.pos[slot] = min(len(prompt), rt.max_len - 1)
        elif rng.random() < 0.3:
            trace.append(("cow", slot, rt.ensure_writable(slot, 0)))
        else:
            rt.release(slot, base[:8] if rng.random() < 0.5 else None)
            trace.append(("release", slot))
        trace.append((tuple(map(tuple, rt.tables)), tuple(rt.pos),
                      rt.alloc.num_free, rt.allocated_blocks,
                      len(rt.prefix), rt.prefix.hits, rt.cow_copies,
                      tuple(rt.free_block_ids())))
    return trace, copies


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kvcache_runtime_matches_reference(seed):
    assert tkv.NULL_BLOCK == jkv.NULL_BLOCK == 0
    assert _drive(tkv, seed) == _drive(jkv, seed)


@pytest.mark.parametrize("mod", [jkv, tkv], ids=["jax", "torch"])
def test_kvcache_allocator_and_guards(mod):
    a = mod.BlockAllocator(8)
    got = a.alloc(3)
    assert 0 not in got and a.num_free == 4 and a.alloc(5) is None
    a.share(got[0])
    assert not a.release(got[0]) and a.release(got[0])
    with pytest.raises(ValueError):
        a.release(got[0])
    rt = mod.PagedKVRuntime(slots=2, max_len=32, block_size=8)
    assert rt.admit(0, list(range(10)), 6) == 0 and rt.allocated_blocks == 2
    rt.alloc.release(rt.tables[0][0])
    with pytest.raises(AssertionError, match="AND free"):
        rt.check_consistency()


@pytest.mark.parametrize("preset", ["q8_0", "q3_k"])
def test_from_reference_carries_a_quantized_lm(granite, preset):
    """A reference LM tree quantized by the reference converts to the same
    bytes as the port quantizing the converted bf16 tree: period-stacked
    layers, lm_head and every quantized Linear."""
    from repro.core import policy as jpolicy
    from repro.core import qlinear as jql
    from repro_torch.core import policy as tpolicy
    from repro_torch.core import qlinear as tql
    jp, tp = granite
    got = from_reference(jql.quantize_params(jp, jpolicy.get_policy(preset)), "cpu")
    want = tql.quantize_params(tp, tpolicy.get_policy(preset))
    assert len(got["layers"]) == TGRAN.num_layers
    assert type(got["lm_head"].w) is type(want["lm_head"].w)
    a, b = _flat(got), _flat(want)
    assert sorted(a) == sorted(b)
    for path, x in a.items():
        if isinstance(x, torch.Tensor):
            assert x.dtype == b[path].dtype and torch.equal(x, b[path]), path
        else:                                  # roles, logical, scale_bits
            assert x == b[path], path


def _flat(tree, path=""):
    """{path: tensor} of a parameter tree (dict order aside)."""
    import dataclasses
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        return {path: tree} if tree is not None else {}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}/{k}"))
    return out
