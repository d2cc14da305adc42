"""Port parity: whisper's encoder-decoder path at a reduced size.

The reduced whisper-large-v3 of the reference's ASR tests (d_model 64,
head_dim 16, 4 heads = 4 KV heads, d_ff 128, vocab 96, 2 + 2 layers,
32 encoder frames, layernorm, GELU, sinusoidal positions, an untied
head) with the same weights in both packages (``weights.from_reference``):

* ``encoder_forward``, ``lm_forward(enc_embeds=...)``, ``make_prefill``;
* ``init_cache``'s contiguous cross rows (precomputed from ``enc_embeds``)
  and its empty paged cross pool, ``write_cross_kv`` into a
  NaN-poisoned pool;
* ``cross_attention_decode`` / ``cross_attention_paged``, recycled cross
  blocks and the tail block's padding poisoned with NaN;
* ``lm_decode_step`` with ``cross_tables``, and the chunk prefill with
  ``cross_tables``, fused against fused and scan against scan;
* ``greedy_generate(enc_embeds=...)``, ``from_reference`` under ``none``
  and ``q8_0``, the per-row sinusoidal embeddings (one computation over
  the positions, the reference's ``vmap`` bits), and the batcher's
  contiguous cross rows with its refusals.

The reference runs op by op (``jax.disable_jit()``) where the port is
compared at one layer or one step: it then rounds where the port does.
Tolerances: ``OUT_TOL`` (about two bf16 ulps) for bf16 activations,
``LOGIT_TOL`` for logits (a flipped activation ulp moves a logit by a few
bf16 ulps), exact for tokens and for pool bytes written from the same
inputs.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.whisper_large_v3 import config as JWHISPER  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models.frontend import synthetic_frontend  # noqa: E402
from repro.serving import ContinuousBatcher as JCB  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.train import serve_step as jss  # noqa: E402
from repro_torch.configs import get_config, reduced, smoke_inputs  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.qlinear import quantize_params  # noqa: E402
from repro_torch.core.quant import Q8_0Tensor  # noqa: E402
from repro_torch.engine import EngineConfig, LMEngineConfig  # noqa: E402
from repro_torch.engine import SpecDecodeConfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import frontend as tfront  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.train import serve_step as tss  # noqa: E402
from repro_torch.weights import from_reference, to_tensor  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


pytestmark = pytest.mark.serving

SIZE = dict(d_model=64, head_dim=16, d_ff=128, vocab_size=96, encoder_seq=32)
JCFG = jreduced(JWHISPER, **SIZE)
TCFG = reduced(get_config("whisper-large-v3"), **SIZE)
OUT_TOL = dict(rtol=1e-2, atol=1e-2)       # about two bf16 ulps
LOGIT_TOL = dict(rtol=2e-2, atol=5e-2)
SE, D, H, HD = 32, 64, 4, 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if "bfloat16" in str(a.dtype) else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(1, 95, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, JAX frame embeddings (2, 32, 64) bf16,
    the same as a tensor)."""
    jp = jT.init_lm(jax.random.PRNGKey(0), JCFG)
    enc = synthetic_frontend(jax.random.PRNGKey(1), (2, SE, D))
    return jp, from_reference(jp, "cpu"), enc, to_tensor(enc)


@pytest.fixture(scope="module")
def q8(model):
    jp = model[0]
    jq = jql.quantize_params(jp, jpolicy.get_policy("q8_0"))
    return jq, from_reference(jq, "cpu")


def test_config_and_frontend():
    assert TCFG.is_enc_dec and TCFG.num_kv_heads == TCFG.num_heads == H
    assert (TCFG.num_layers, TCFG.encoder_layers) == (2, 2)
    full = get_config("whisper-large-v3")
    assert (full.d_model, full.hd, full.vocab_size, full.encoder_seq,
            full.default_policy) == (1280, 64, 51866, 1500, "q8_0")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "encoder_layers", "encoder_seq",
              "norm", "activation", "pos_embed", "default_policy", "family"):
        assert getattr(full, f) == getattr(JWHISPER, f), f
    gen = torch.Generator().manual_seed(3)
    a = tfront.synthetic_audio(gen, TCFG)
    assert a.shape == (SE, D) and a.dtype == torch.bfloat16
    assert 0.01 < float(a.float().std()) < 0.03
    inp = smoke_inputs(0, TCFG, batch=3, seq=5)
    assert inp["enc_embeds"].shape == tfront.audio_frontend_shape(TCFG, 3)


def test_params_tree_matches(model):
    jp, tp, _, _ = model
    tq = tT.init_lm(torch.Generator().manual_seed(0), TCFG)
    for tree in (tp, tq):
        assert len(tree["layers"]) == 2 and len(tree["encoder"]["layers"]) == 2
        assert sorted(tree["layers"][0]) == ["attn", "cross", "mlp", "norm1",
                                             "norm2", "norm_x"]
        assert sorted(tree["encoder"]["layers"][0]) == ["attn", "mlp", "norm1",
                                                        "norm2"]
        assert "lm_head" in tree and "final_norm" in tree["encoder"]
    np.testing.assert_array_equal(
        _np(tp["encoder"]["layers"][1]["attn"]["wq"].w),
        _np(jp["encoder"]["layers"][0]["attn"]["wq"].w[1]))
    np.testing.assert_array_equal(_np(tp["layers"][1]["cross"]["wv"].w),
                                  _np(jp["layers"][0]["cross"]["wv"].w[1]))


def test_encoder_forward_matches(model):
    jp, tp, enc, tenc = model
    with jax.disable_jit():
        want = jT.encoder_forward(jp, JCFG, enc)
    got = tT.encoder_forward(tp, TCFG, tenc)
    assert got.shape == (2, SE, D) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **OUT_TOL)
    assert (_np(got) != _np(want)).mean() < 0.05


@pytest.mark.parametrize("preset", ["none", "q8_0"])
def test_lm_forward_matches(model, q8, preset):
    jp, tp = model[:2] if preset == "none" else q8
    enc, tenc = model[2:]
    toks = _tokens(0, 2, 9)
    jl, _ = jT.lm_forward(jp, JCFG, jnp.asarray(toks), enc_embeds=enc)
    tl, aux = tT.lm_forward(tp, TCFG, _t(toks), enc_embeds=tenc)
    assert float(aux) == 0.0 and tl.shape == (2, 9, 96)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    last, _ = tT.lm_forward(tp, TCFG, _t(toks), enc_embeds=tenc, last_only=True)
    np.testing.assert_array_equal(_np(last[:, 0]), _np(tl[:, -1]))
    with pytest.raises(ValueError, match="enc_embeds"):
        tT.lm_forward(tp, TCFG, _t(toks))
    want = jss.make_prefill(JCFG)(jp, {"tokens": jnp.asarray(toks), "enc_embeds": enc})
    got = tss.make_prefill(TCFG, device="cpu")(tp, {"tokens": toks, "enc_embeds": tenc})
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)


def test_from_reference_carries_q8_0(model, q8):
    """The reference's q8_0 tree converts to Q8_0 cross, encoder, head
    and embedding weights with the port's own quantization's bits."""
    tq = q8[1]
    mine = quantize_params(model[1], get_policy("q8_0"))
    for path in (("layers", 1, "cross", "wk"), ("encoder", "layers", 0, "mlp", "up"),
                 ("lm_head",), ("embed",)):
        a, b = tq, mine
        for k in path:
            a, b = a[k], b[k]
        assert isinstance(a.w, Q8_0Tensor) and isinstance(b.w, Q8_0Tensor), path
        assert torch.equal(a.w.qs, b.w.qs) and torch.equal(a.w.d, b.w.d), path


def test_contiguous_cross_cache_matches(model):
    jp, tp, enc, tenc = model
    with jax.disable_jit():
        jc = jT.init_cache(jp, JCFG, 2, 12, enc_embeds=enc)
    tc = tT.init_cache(tp, TCFG, 2, 12, enc_embeds=tenc, device="cpu")
    assert len(tc) == 2 and all(isinstance(c, tT.LayerCache) for c in tc)
    for layer, c in enumerate(tc):
        assert c.cross_k.shape == (2, H, SE, HD) and c.kv.k.shape == (2, H, 12, HD)
        np.testing.assert_allclose(_np(c.cross_k), _np(jc[0].cross_k[layer]), **OUT_TOL)
        np.testing.assert_allclose(_np(c.cross_v), _np(jc[0].cross_v[layer]), **OUT_TOL)
    with pytest.raises(ValueError, match="enc_embeds"):
        tT.init_cache(tp, TCFG, 2, 12, device="cpu")


def test_paged_cross_cache_layout(model):
    tp = model[1]
    c = tT.init_cache(tp, TCFG, 2, 12, block_size=4, num_blocks=9,
                      cross_block_size=8, cross_num_blocks=11, device="cpu")
    assert c[0].kv.k.shape == (9, H, 4, HD)
    assert c[0].cross_k.shape == (11, H, 8, HD) and c[0].cross_k.dtype == torch.bfloat16
    assert not c[1].cross_v.any()
    with pytest.raises(ValueError, match="cross_block_size"):
        tT.init_cache(tp, TCFG, 2, 12, block_size=4, num_blocks=9,
                      cross_block_size=8, device="cpu")
    dense = reduced(get_config("granite-8b"))
    with pytest.raises(ValueError, match="non-enc-dec"):
        tT.init_cache({}, dense, 2, 12, block_size=4, num_blocks=9,
                      cross_block_size=8, cross_num_blocks=11, device="cpu")


CROSS_TABLE = np.array([6, 2, 9, 4, 1], np.int32)     # 5 blocks of 7 > 32 frames
CBS, NBC = 7, 12


def _written_pools(model, poison: bool):
    """Both packages' paged cross pools after ``write_cross_kv`` of the
    same encoder output (the reference's, op by op) into CROSS_TABLE's
    blocks of pools that hold NaN beforehand when ``poison``."""
    jp, tp, enc, _ = model
    with jax.disable_jit():
        enc_out = jT.encoder_forward(jp, JCFG, enc[:1])
        jc = jT.init_cache(jp, JCFG, 1, 8, block_size=4, num_blocks=4,
                           cross_block_size=CBS, cross_num_blocks=NBC)
        if poison:
            jc = [c._replace(cross_k=jnp.full_like(c.cross_k, jnp.nan),
                             cross_v=jnp.full_like(c.cross_v, jnp.nan)) for c in jc]
        jc = jT.write_cross_kv(jp, JCFG, enc_out, jnp.asarray(CROSS_TABLE), jc)
    tc = tT.init_cache(tp, TCFG, 1, 8, block_size=4, num_blocks=4,
                       cross_block_size=CBS, cross_num_blocks=NBC, device="cpu")
    if poison:
        for c in tc:
            c.cross_k.fill_(float("nan"))
            c.cross_v.fill_(float("nan"))
    tc = tT.write_cross_kv(tp, TCFG, to_tensor(enc_out), _t(CROSS_TABLE), tc)
    return jc, tc, enc_out


@pytest.mark.parametrize("poison", [False, True])
def test_write_cross_kv_matches(model, poison):
    """Listed blocks hold the projections bit for bit (the tail block's
    padding zero), unlisted ones stay as they were."""
    jc, tc, _ = _written_pools(model, poison)
    unlisted = [b for b in range(NBC) if b not in CROSS_TABLE]
    for layer, c in enumerate(tc):
        for name in ("cross_k", "cross_v"):
            got, want = _np(getattr(c, name)), _np(getattr(jc[0], name)[layer])
            np.testing.assert_array_equal(got[CROSS_TABLE], want[CROSS_TABLE])
            assert not got[CROSS_TABLE[-1], :, SE - 4 * CBS:].any()   # padding 0
            assert np.isnan(got[unlisted]).all() == poison
            assert not np.isnan(got[CROSS_TABLE]).any()


def test_cross_attention_decode_and_paged_match(model):
    """One layer's cross attention from contiguous rows and from the
    paged pool (NaN in every other block) against the reference's, and
    the two layouts against each other."""
    jp, tp, _, _ = model
    jc, tc, enc_out = _written_pools(model, poison=True)
    jl = jax.tree.map(lambda a: a[1], jp["layers"][0]["cross"])
    tl = tp["layers"][1]["cross"]
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((1, 3, D)), jnp.bfloat16)
    tx = to_tensor(x)
    with jax.disable_jit():
        jpaged = jattn.cross_attention_paged(
            jl, JCFG, x, jnp.asarray(CROSS_TABLE[None]), jc[0].cross_k[1],
            jc[0].cross_v[1], enc_len=SE)
        ck = jT.apply_linear(jl["wk"], enc_out).reshape(1, SE, H, HD).transpose(0, 2, 1, 3)
        cv = jT.apply_linear(jl["wv"], enc_out).reshape(1, SE, H, HD).transpose(0, 2, 1, 3)
        jcont = jattn.cross_attention_decode(jl, JCFG, x, ck, cv)
    tpaged = tattn.cross_attention_paged(tl, TCFG, tx, _t(CROSS_TABLE[None]),
                                         tc[1].cross_k, tc[1].cross_v, enc_len=SE)
    tcont = tattn.cross_attention_decode(tl, TCFG, tx, to_tensor(ck), to_tensor(cv))
    assert tpaged.shape == (1, 3, D) and np.isfinite(_np(tpaged)).all()
    np.testing.assert_allclose(_np(tpaged), _np(jpaged), **OUT_TOL)
    np.testing.assert_allclose(_np(tcont), _np(jcont), **OUT_TOL)
    np.testing.assert_array_equal(_np(tpaged), _np(tcont))
    # Per position as one chunk: non-causal over fixed KV.
    for i in range(3):
        one = tattn.cross_attention_decode(tl, TCFG, tx[:, i:i + 1], to_tensor(ck),
                                           to_tensor(cv))
        np.testing.assert_array_equal(_np(one[:, 0]), _np(tcont[:, i]))
    # A ragged tail masked through enc_valid.
    valid = np.arange(SE)[None] < 20
    want = jattn.cross_attention_decode(jl, JCFG, x, ck, cv, jnp.asarray(valid))
    got = tattn.cross_attention_decode(tl, TCFG, tx, to_tensor(ck), to_tensor(cv),
                                       _t(valid))
    np.testing.assert_allclose(_np(got), _np(want), **OUT_TOL)


def _paged_caches(model, jparams, tparams):
    """(jc, tc): a paged self pool (blocks of 4) and a paged cross pool
    written from row 0's encoder output at CROSS_TABLE, in both packages."""
    _, _, enc, _ = model
    with jax.disable_jit():
        enc_out = jT.encoder_forward(jparams, JCFG, enc[:1])
        jc = jT.init_cache(jparams, JCFG, 2, 16, block_size=4, num_blocks=12,
                           cross_block_size=CBS, cross_num_blocks=NBC)
        jc = jT.write_cross_kv(jparams, JCFG, enc_out, jnp.asarray(CROSS_TABLE), jc)
    tc = tT.init_cache(tparams, TCFG, 2, 16, block_size=4, num_blocks=12,
                       cross_block_size=CBS, cross_num_blocks=NBC, device="cpu")
    tc = tT.write_cross_kv(tparams, TCFG, to_tensor(enc_out), _t(CROSS_TABLE), tc)
    return jc, tc


@pytest.mark.parametrize("fused", [True, False])
def test_prefill_chunks_then_decode_match(model, fused):
    """Two prompt chunks (fused against fused, scan against scan) then
    two decode steps of two rows (the second row idle), all through the
    paged cross pool."""
    jp, tp = model[:2]
    jc, tc = _paged_caches(model, jp, tp)
    row = np.array([[7, 2, 10, 4]], np.int32)
    crow = CROSS_TABLE[None]
    toks = _tokens(5, 1, 9)
    with jax.disable_jit():
        for lo, hi in ((0, 5), (5, 9)):
            jl, jc = jT.lm_prefill_chunk(jp, JCFG, jnp.asarray(toks[:, lo:hi]),
                                         jnp.array([lo], jnp.int32), jc,
                                         block_tables=jnp.asarray(row),
                                         cross_tables=jnp.asarray(crow), fused=fused)
            tl, tc = tT.lm_prefill_chunk(tp, TCFG, _t(toks[:, lo:hi]), lo, tc,
                                         block_tables=_t(row),
                                         cross_tables=_t(crow), fused=fused)
            np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
        tables = np.array([[7, 2, 10, 4], [0, 0, 0, 0]], np.int32)
        ctables = np.stack([CROSS_TABLE, CROSS_TABLE])
        tok = np.array([[int(np.argmax(_np(tl)))], [0]], np.int32)
        for pos in (9, 10):
            p = np.array([pos, 0], np.int32)
            jl, jc = jT.lm_decode_step(jp, JCFG, jnp.asarray(tok), jnp.asarray(p), jc,
                                       block_tables=jnp.asarray(tables),
                                       cross_tables=jnp.asarray(ctables))
            tl, tc = tT.lm_decode_step(tp, TCFG, _t(tok), _t(p), tc,
                                       block_tables=_t(tables), cross_tables=_t(ctables))
            np.testing.assert_allclose(_np(tl[0]), _np(jl[0]), **LOGIT_TOL)
            assert int(np.argmax(_np(tl[0]))) == int(np.argmax(_np(jl[0])))
            tok = np.array([[int(np.argmax(_np(tl[0])))], [0]], np.int32)
    for layer, c in enumerate(tc):
        np.testing.assert_allclose(_np(c.kv.k[[7, 2, 10]]),
                                   _np(jc[0].kv.k[layer][np.array([7, 2, 10])]), **OUT_TOL)


def test_verify_chunk_with_cross_tables(model):
    """``lm_verify_chunk`` through the paged cross pool: each path's logits
    against the reference's same path (run op by op) at LOGIT_TOL; the
    fused path's last row is ``lm_prefill_chunk``'s."""
    jp, tp = model[:2]
    rows = np.array([[3, 1, 6, 2]], np.int32)
    row, crow = _t(rows), _t(CROSS_TABLE[None])
    ntoks = _tokens(8, 1, 6)
    toks = _t(ntoks)
    out = {}
    for fused in (True, False):
        jc, tc = _paged_caches(model, jp, tp)
        out[fused], _ = tT.lm_verify_chunk(tp, TCFG, toks, 0, tc, block_tables=row,
                                           cross_tables=crow, fused=fused)
        with jax.disable_jit():
            want, _ = jT.lm_verify_chunk(jp, JCFG, jnp.asarray(ntoks),
                                         jnp.array([0], jnp.int32), jc,
                                         block_tables=jnp.asarray(rows),
                                         cross_tables=jnp.asarray(CROSS_TABLE[None]),
                                         fused=fused)
        assert out[fused].shape == want.shape
        np.testing.assert_allclose(_np(out[fused]), _np(want), **LOGIT_TOL)
        _, tc = _paged_caches(model, jp, tp)
        last, _ = tT.lm_prefill_chunk(tp, TCFG, toks, 0, tc, block_tables=row,
                                      cross_tables=crow, fused=fused)
        np.testing.assert_array_equal(_np(out[fused][:, -1]), _np(last[:, 0]))
    np.testing.assert_allclose(_np(out[True]), _np(out[False]), **LOGIT_TOL)


@pytest.mark.parametrize("preset", ["none", "q8_0"])
def test_greedy_generate_matches(model, q8, preset):
    """Prompt 5, 8 greedy steps on contiguous self and cross rows: the
    reference's tokens (run op by op)."""
    jp, tp = model[:2] if preset == "none" else q8
    enc, tenc = model[2:]
    prompt = _tokens(0, 2, 5)
    with jax.disable_jit():
        want = np.asarray(jss.greedy_generate(jp, JCFG, jnp.asarray(prompt), 8,
                                              enc_embeds=enc))
    got = tss.greedy_generate(tp, TCFG, prompt, 8, enc_embeds=tenc, device="cpu")
    assert got.shape == (2, 13) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sinusoidal_rows_are_the_reference_bits():
    """Per-row positions take one computation over the position vector;
    its bf16 bits equal the reference's ``vmap`` of one-position
    embeddings at whisper's width and the reduced one."""
    pos = np.concatenate([np.arange(40), np.random.default_rng(0).integers(
        40, 3000, 60)]).astype(np.int32)
    for d in (1280, 64):
        want = jax.vmap(lambda o: jT._sinusoidal(1, d, offset=o))(jnp.asarray(pos))
        got = tT._sinusoidal_at(_t(pos), d)
        assert got.dtype == torch.bfloat16 and got.shape == (len(pos), d)
        np.testing.assert_array_equal(_np(got), _np(want[:, 0]))
        # The same bits as the shared-position path, row by row.
        for i in (0, 7, 55):
            np.testing.assert_array_equal(
                _np(got[i]), _np(tT._sinusoidal(1, d, offset=int(pos[i]))[0]))


def _serve(cb, reqs):
    for r in reqs:
        cb.submit(r)
    cb.run()
    return {r.rid: list(r.out) for r in cb.finished}


@pytest.mark.parametrize("fused", [True, False])
def test_batcher_with_enc_embeds_matches(model, fused):
    """``ContinuousBatcher(enc_embeds=...)``: one contiguous cross row per
    slot, the reference batcher's tokens and counters (the reference run
    op by op: this model's top-2 logit margins are a few bf16 ulps, so
    only the same rounding gives the same tokens)."""
    jp, tp, enc, tenc = model
    kw = dict(slots=2, max_len=16, prefill_chunk=3, fused_prefill=fused)
    tcb = ContinuousBatcher(tp, TCFG, enc_embeds=tenc, device="cpu", **kw)
    prompts = [_tokens(s, 1, 5)[0].tolist() for s in (1, 2, 3)]
    with jax.disable_jit():
        jcb = JCB(jp, JCFG, enc_embeds=enc, **kw)
        want = _serve(jcb, [JReq(rid=i, prompt=p, max_new=5)
                            for i, p in enumerate(prompts)])
    got = _serve(tcb, [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
    assert got == want
    assert (tcb.prefill_launches, tcb.decode_quanta) == (jcb.prefill_launches,
                                                         jcb.decode_quanta)
    by_config = ContinuousBatcher(tp, TCFG, device="cpu", config=EngineConfig(
        lm=LMEngineConfig(enc_embeds=tenc, **kw)))
    assert _serve(by_config, [Request(rid=i, prompt=p, max_new=5)
                              for i, p in enumerate(prompts)]) == want


def test_batcher_refuses_what_the_reference_refuses(model):
    jp, tp, enc, tenc = model
    with pytest.raises(ValueError, match="prefix_share"):
        JCB(jp, JCFG, slots=2, max_len=16, enc_embeds=enc, prefix_share=True)
    with pytest.raises(ValueError, match="prefix_share"):
        ContinuousBatcher(tp, TCFG, slots=2, max_len=16, enc_embeds=tenc,
                          prefix_share=True, device="cpu")
    dense = reduced(get_config("granite-8b"))
    for target, draft in ((TCFG, dense), (dense, TCFG)):
        sp = SpecDecodeConfig(draft_params={}, draft_cfg=draft, k=2)
        with pytest.raises(ValueError, match="spec_decode"):
            ContinuousBatcher(tp if target is TCFG else {}, target, max_len=16,
                              device="cpu",
                              config=EngineConfig(lm=LMEngineConfig(spec_decode=sp)))
