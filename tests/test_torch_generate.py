"""Port parity: generation on the contiguous KV cache at TINY sizes.

* ``flash_decode``'s plain version against the reference's oracle
  (``flash_decode_ref``) and its Pallas kernel in interpret mode, on the
  same seeded f32 inputs, within ``rtol = atol = 1e-5`` (f32 sums in
  another order): kv_len = 1, kv_len = C, a C that is not a multiple of
  the key block, and hd = 120.
* ``attention_decode`` on a contiguous cache (bf16 and Q8_0, one scalar
  ``pos`` and per-row positions, a sliding window past its ring buffer's
  wrap) and ``lm_decode_step`` against the JAX functions with the same
  weights (``weights.from_reference``).
* The serve-step factories (``greedy_generate``, ``make_decode`` over
  ``make_cache``, ``make_prefill``) against ``repro.train.serve_step``
  under none, q8_0 and q4_0 weights: identical token streams.

The reference runs op by op here (``jax.disable_jit()``): then it rounds
where the port does, so logits agree to the bit on almost every step and
greedy tokens do not hang on near-ties of bf16 logits.  Its compiled
decode (``lax.scan``) keeps some bf16 intermediates in f32 and moves a
logit by a few bf16 ulps; ``lm_decode_step`` is also held to that one at
``LOGIT_TOL``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.train import serve_step as jss  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.train import serve_step as tss  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


pytestmark = pytest.mark.serving

TOL = dict(rtol=1e-5, atol=1e-5)
# Logits against the compiled reference: a bf16 head output that moves by
# a few bf16 ulps (measured <= 0.05 at |logit| < 4), as in test_torch_paged.
LOGIT_TOL = dict(rtol=2e-2, atol=5e-2)
CFG_KW = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=96,
              head_dim=32)
GRAN = (jbase.reduced(jget_config("granite-8b")),
        tbase.reduced(tget_config("granite-8b")))
DANUBE = (jbase.reduced(jget_config("h2o-danube-3-4b")),
          tbase.reduced(tget_config("h2o-danube-3-4b")))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if "bfloat16" in str(a.dtype) else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _prompt(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(1, vocab - 1, (b, s)).astype(np.int32)


# ------------------------------------------------------ kernel plain version

DECODE_CASES = {       # (B, Hkv, G, hd, C, kv_len)
    "kv_len_1": (2, 2, 4, 32, 128, 1),
    "kv_len_C": (2, 2, 4, 32, 128, 128),
    "middle": (1, 3, 2, 32, 192, 150),
    "ragged_C": (2, 2, 4, 32, 100, 77),     # C not a multiple of the key block
    "hd_120": (1, 2, 4, 120, 64, 50),       # h2o-danube-3-4b's head dim
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_flash_decode_plain_matches_reference(case):
    b, h, g, d, c, n = DECODE_CASES[case]
    rng = np.random.default_rng(c + n)
    q, k, v = _rand(rng, (b, h, g, d), 0.4), _rand(rng, (b, h, c, d), 0.4), \
        _rand(rng, (b, h, c, d))
    kv_len = np.array([n], np.int32)
    scale = d ** -0.5
    got = tfd.flash_decode_ref(*(_t(a) for a in (q, k, v, kv_len)), scale=scale)
    jargs = [jnp.asarray(a) for a in (q, k, v, kv_len)]
    np.testing.assert_allclose(_np(got), _np(jfd.flash_decode_ref(*jargs, scale=scale)),
                               **TOL)
    if c % 64 == 0:
        pallas = jfd.flash_decode(*jargs, scale=scale, bk=64, interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), **TOL)
    assert np.isfinite(_np(got)).all()
    # Past kv_len nothing is read: poisoned slots change nothing.
    k[:, :, n:], v[:, :, n:] = np.nan, np.nan
    again = tfd.flash_decode_ref(*(_t(a) for a in (q, k, v, kv_len)), scale=scale)
    np.testing.assert_array_equal(_np(again), _np(got))
    assert torch.equal(tops.decode_attention(*(_t(a) for a in (q, k, v, kv_len)),
                                             scale=scale), again)


# --------------------------------------------------------- attention level

@pytest.fixture(scope="module")
def tiny():
    out = {}
    for window in (None, 6):
        kw = dict(CFG_KW, sliding_window=window)
        jcfg, tcfg = jbase.ModelConfig(**kw), tbase.ModelConfig(**kw)
        jp = jT.init_lm(jax.random.PRNGKey(0), jcfg)
        out[window] = (jcfg, tcfg, jp, from_reference(jp, "cpu"))
    return out


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_attention_decode_contiguous_matches(tiny, quantized, per_row, window):
    """One layer, ten steps on an 8-slot cache (a 6-slot ring buffer under
    the window, so positions 6..9 wrap): outputs within a bf16 ulp on a
    few elements, and the cache bytes equal after every step."""
    jcfg, tcfg, jp, tp = tiny[window]
    jl = jax.tree.map(lambda a: a[0], jp["layers"][0]["attn"])
    tl = tp["layers"][0]["attn"]
    jc = jattn.init_kv_cache(2, jcfg, 8, quantized=quantized)
    tc = tattn.init_kv_cache(2, tcfg, 8, quantized=quantized, device="cpu")
    assert tc.capacity == jc.capacity == (6 if window else 8)
    rng = np.random.default_rng(2)
    with jax.disable_jit():
        for step in range(10):
            x = jnp.asarray(_rand(rng, (2, 1, 64)), jnp.bfloat16)
            if per_row:
                pos = np.array([step, min(step + 3, 9)], np.int32)
                jpos, tpos = jnp.asarray(pos), _t(pos)
            else:
                jpos, tpos = jnp.int32(step), step
            jout, jc = jattn.attention_decode(jl, jcfg, x, jpos, jc)
            tout, tc = tattn.attention_decode(tl, tcfg, from_reference(x, "cpu"),
                                              tpos, tc)
            np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-2, atol=1e-2)
            assert (_np(tout) != _np(jout)).mean() < 0.05
            for name, buf in zip(("k", "v", "k_scale", "v_scale"), tc):
                if buf is not None:
                    np.testing.assert_array_equal(_np(buf), _np(getattr(jc, name)))


def test_contiguous_bf16_decode_takes_the_kernel_path(tiny):
    """A scalar ``pos`` on a bf16 cache reads through ``ops.decode_attention``
    with kv_len = min(pos+1, cap) in the ring (min(pos, cap-1)+1 without a
    window); the other reads do not."""
    seen = []
    real = tops.decode_attention

    def spy(q, k, v, kv_len, *, scale=None):
        seen.append(int(kv_len[0]))
        return real(q, k, v, kv_len, scale=scale)
    tops.decode_attention = spy
    try:
        for window, want in ((None, [1, 2, 8, 8]), (6, [1, 2, 6, 6])):
            jcfg, tcfg, jp, tp = tiny[window]
            tl = tp["layers"][0]["attn"]
            x = torch.zeros((2, 1, 64), dtype=torch.bfloat16)
            seen.clear()
            for quantized in (False, True):
                c = tattn.init_kv_cache(2, tcfg, 8, quantized=quantized, device="cpu")
                for pos in (0, 1, 7, 9):
                    tattn.attention_decode(tl, tcfg, x, pos, c)
                tattn.attention_decode(tl, tcfg, x, torch.tensor([3, 4]), c)
            assert seen == want
    finally:
        tops.decode_attention = real


@pytest.mark.parametrize("pos_embed", ["rope", "sinusoidal"])
@pytest.mark.parametrize("per_row", [False, True])
def test_lm_decode_step_contiguous_matches(per_row, pos_embed):
    """Whole decode steps on the contiguous cache against the compiled
    reference (``LOGIT_TOL``) and the op-by-op one (exact on most logits)."""
    kw = dict(CFG_KW, pos_embed=pos_embed)
    jcfg, tcfg = jbase.ModelConfig(**kw), tbase.ModelConfig(**kw)
    jp = jT.init_lm(jax.random.PRNGKey(3), jcfg)
    tp = from_reference(jp, "cpu")
    toks = _prompt(4, 2, 5, jcfg.vocab_size)
    jc = jT.init_cache(jp, jcfg, 2, 8)
    jc_eager = jT.init_cache(jp, jcfg, 2, 8)
    tc = tT.init_cache(tp, tcfg, 2, 8, device="cpu")
    step = jax.jit(lambda p, t, pos, c: jT.lm_decode_step(p, jcfg, t, pos, c))
    for i in range(5):
        pos = np.array([i, i + 2], np.int32) if per_row else np.int32(i)
        tok = toks[:, i:i + 1]
        jl, jc = step(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        with jax.disable_jit():
            el, jc_eager = jT.lm_decode_step(jp, jcfg, jnp.asarray(tok),
                                             jnp.asarray(pos), jc_eager)
        tl, tc = tT.lm_decode_step(tp, tcfg, _t(tok), _t(pos) if per_row else i, tc)
        assert tl.shape == (2, 1, jcfg.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
        np.testing.assert_allclose(_np(tl), _np(el), rtol=1e-2, atol=1e-2)
        assert (_np(tl) != _np(el)).mean() < 0.1


def test_init_cache_layouts():
    jcfg, tcfg = DANUBE
    c = tT.init_cache({}, tcfg, 3, 100, device="cpu")
    assert len(c) == tcfg.num_layers
    assert c[0].k.shape == (3, tcfg.num_kv_heads, 32, tcfg.hd)      # the window
    assert c[0].k.dtype == torch.bfloat16 and c[0].k_scale is None
    c = tss.make_cache({}, GRAN[1], 2, 40, quantized_kv=True, device="cpu")
    assert c[0].k.shape == (2, GRAN[1].num_kv_heads, 40, 32)
    assert c[0].k.dtype == torch.int8 and c[0].k_scale.shape[-1] == 1
    paged = tT.init_cache({}, tcfg, 3, 100, block_size=4, num_blocks=5, device="cpu")
    assert paged[0].k.shape == (5, tcfg.num_kv_heads, 4, tcfg.hd)
    with pytest.raises(ValueError):
        tT.init_cache({}, tcfg, 3, 100, block_size=4, device="cpu")


# ------------------------------------------------------------- serve steps

@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = GRAN
    jp = jT.init_lm(jax.random.PRNGKey(1), jcfg)
    out = {}
    for preset in ("none", "q8_0", "q4_0"):
        jq = jp if preset == "none" else jql.quantize_params(
            jp, jpolicy.get_policy(preset))
        out[preset] = (jq, from_reference(jq, "cpu"))
    return out


@pytest.mark.parametrize("preset", ["none", "q8_0", "q4_0"])
def test_greedy_generate_matches(granite, preset):
    """reduced(granite-8b), prompt 8, 8 greedy steps, bf16 KV: the same
    tokens as ``repro.train.serve_step.greedy_generate``."""
    jcfg, tcfg = GRAN
    jp, tp = granite[preset]
    prompt = _prompt(0, 2, 8, jcfg.vocab_size)
    with jax.disable_jit():
        want = np.asarray(jss.greedy_generate(jp, jcfg, jnp.asarray(prompt), 8))
    got = tss.greedy_generate(tp, tcfg, prompt, 8, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :8].numpy(), prompt)


def test_greedy_generate_window_wraps():
    """reduced(h2o-danube-3-4b): a 32-slot ring buffer, prompt 24 and 16
    steps, so the last 8 positions overwrite the oldest slots."""
    jcfg, tcfg = DANUBE
    jp = jT.init_lm(jax.random.PRNGKey(5), jcfg)
    prompt = _prompt(1, 2, 24, jcfg.vocab_size)
    with jax.disable_jit():
        want = np.asarray(jss.greedy_generate(jp, jcfg, jnp.asarray(prompt), 16))
    got = tss.greedy_generate(from_reference(jp, "cpu"), tcfg, prompt, 16,
                              device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_q8_kv_decode_loop_matches(granite):
    """``make_cache(quantized_kv=True)`` + ``make_decode`` in both packages,
    the greedy loop written out: the same tokens and cache bytes."""
    jcfg, tcfg = GRAN
    jp, tp = granite["none"]
    prompt = _prompt(2, 2, 8, jcfg.vocab_size)
    jdec, tdec = jss.make_decode(jcfg), tss.make_decode(tcfg, device="cpu")
    jc = jss.make_cache(jp, jcfg, 2, 16, quantized_kv=True)
    tc = tss.make_cache(tp, tcfg, 2, 16, quantized_kv=True, device="cpu")
    jtok, ttok = jnp.asarray(prompt[:, :1]), _t(prompt[:, :1])
    with jax.disable_jit():
        for t in range(15):
            jtok, jl, jc = jdec(jp, jtok, jnp.int32(t), jc)
            ttok, tl, tc = tdec(tp, ttok, t, tc)
            assert tl.shape == (2, 1, jcfg.vocab_size)
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
            if t + 1 < 8:
                jtok, ttok = jnp.asarray(prompt[:, t + 1:t + 2]), _t(prompt[:, t + 1:t + 2])
    for layer, c in enumerate(tc):
        for name, buf in zip(("k", "v", "k_scale", "v_scale"), c):
            np.testing.assert_array_equal(_np(buf), _np(getattr(jc[0].kv, name)[layer]))


@pytest.mark.parametrize("preset", ["none", "q4_0"])
def test_make_prefill_matches(granite, preset):
    jcfg, tcfg = GRAN
    jp, tp = granite[preset]
    toks = _prompt(3, 2, 12, jcfg.vocab_size)
    want = jss.make_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got = tss.make_prefill(tcfg, device="cpu")(tp, {"tokens": toks})
    assert got.shape == (2, jcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    # The prefill's last logits are the decode loop's at the same position.
    cache = tss.make_cache(tp, tcfg, 2, 12, device="cpu")
    dec = tss.make_decode(tcfg, device="cpu")
    for t in range(12):
        _, logits, cache = dec(tp, _t(toks[:, t:t + 1]), t, cache)
    np.testing.assert_allclose(_np(logits[:, -1]), _np(got), **LOGIT_TOL)


def test_entry_points_default_to_the_card(granite):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card error")
    _, tcfg = GRAN
    _, tp = granite["none"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tss.greedy_generate(tp, tcfg, _prompt(0, 1, 4, 90), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tss.make_cache(tp, tcfg, 1, 8)
    for factory in (tss.make_prefill, tss.make_decode):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            factory(tcfg)

