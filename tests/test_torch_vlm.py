"""Port parity: qwen2-vl-72b's M-RoPE and vision prefix at reduced size.

* ``layers.apply_mrope`` against the JAX function with three distinct
  position streams (with the stub frontend's three equal streams M-RoPE
  is plain RoPE, bit for bit, so a model-level test cannot see the
  sections): bf16 bit for bit, f32 within ``MROPE_F32_TOL`` (XLA's and
  torch's f32 cos/sin differ in the last ulp).
* reduced(qwen2-vl-72b) (2 layers, d_model 128, head_dim 32, sections
  (4, 6, 6)): ``lm_forward`` with an 8-patch ``prefix_embeds`` and
  ``make_prefill`` against the reference within ``LOGIT_TOL``, the
  prefix moving the logits; ``greedy_generate`` (reference op by op) and
  ``ContinuousBatcher`` token streams and events equal to the reference's
  on tie-stable prompt seeds.
* ``get_config("qwen2-vl-72b")`` and its reduced twin equal the
  reference's fields.
"""
import dataclasses
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_inputs as jsmoke  # noqa: E402
from repro.models import frontend as jfrontend  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serving import ContinuousBatcher as JCB  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.train import serve_step as jss  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import smoke_inputs as tsmoke  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import frontend as tfrontend  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serving import ContinuousBatcher as TCB  # noqa: E402
from repro_torch.serving import Request as TReq  # noqa: E402
from repro_torch.train import serve_step as tss  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


# f32 M-RoPE: XLA's and torch's f32 cos/sin part in the last ulp.
MROPE_F32_TOL = dict(rtol=1e-6, atol=1e-6)
# Logits against the compiled reference: bf16 head outputs that move by a
# few bf16 ulps, as in test_torch_generate.
LOGIT_TOL = dict(rtol=2e-2, atol=5e-2)
VLM = (jbase.reduced(jget_config("qwen2-vl-72b")),
       tbase.reduced(tget_config("qwen2-vl-72b")))
PATCHES = 8          # smoke_inputs' prefix length


@pytest.fixture(scope="module")
def weights():
    jp = jT.init_lm(jax.random.PRNGKey(3), VLM[0])
    return jp, from_reference(jp, "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _prompt(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(1, vocab - 1, (b, s)).astype(np.int32)


def _prefix(seed, b, d):
    """bf16-valued patch embeddings (normal * 0.02), as both packages'."""
    x = np.random.default_rng(seed).standard_normal((b, PATCHES, d)) * 0.02
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


# ------------------------------------------------------------- M-RoPE

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_distinct_streams(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 37, 32)).astype(np.float32)
    pos = np.stack([rng.integers(0, 4096, (2, 37)) for _ in range(3)], 1).astype(np.int32)
    assert not (pos[:, 0] == pos[:, 1]).all()
    sections = (4, 6, 6)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jL.apply_mrope(jx, jnp.asarray(pos), sections)
    got = tL.apply_mrope(torch.from_numpy(np.array(jx.astype(jnp.float32)))
                         .to(getattr(torch, dtype)), torch.from_numpy(pos), sections)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), **MROPE_F32_TOL)
    # The sections are real: one stream's positions move only its slots.
    moved = pos.copy()
    moved[:, 2] += 7
    other = tL.apply_mrope(torch.from_numpy(x), torch.from_numpy(moved), sections)
    base = tL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections)
    diff = (other != base).any(dim=(0, 1, 2))
    width = (diff[:16] | diff[16:]).nonzero().flatten().tolist()
    assert width == list(range(10, 16))


def test_equal_streams_are_rope_and_sections_checked():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 4, 9, 32)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 300, (2, 9)).astype(np.int64))
    got = tL.apply_mrope(x.to(torch.bfloat16), tattn._positions_mrope(pos), (4, 6, 6))
    want = tL.apply_rope(x.to(torch.bfloat16), pos)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        tL.apply_mrope(x, tattn._positions_mrope(pos), (4, 6, 4))


# ------------------------------------------------------- forward paths

def test_lm_forward_and_prefill_with_prefix(weights):
    jcfg, tcfg = VLM
    jp, tp = weights
    toks = _prompt(4, 2, 12, jcfg.vocab_size)
    pre = _prefix(5, 2, jcfg.d_model)
    want, _ = jT.lm_forward(jp, jcfg, jnp.asarray(toks), prefix_embeds=jnp.asarray(pre))
    tpre = from_reference(pre, "cpu")
    got, aux = tT.lm_forward(tp, tcfg, torch.from_numpy(toks), prefix_embeds=tpre)
    assert got.shape == (2, 12, jcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    bare, _ = tT.lm_forward(tp, tcfg, torch.from_numpy(toks))
    assert (bare - got).abs().max() > 0.1                 # the prefix matters
    prefill = tss.make_prefill(tcfg, device="cpu")(
        tp, {"tokens": toks, "prefix_embeds": tpre})
    assert torch.equal(prefill, got[:, -1])
    jpre = jss.make_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks),
                                       "prefix_embeds": jnp.asarray(pre)})
    np.testing.assert_allclose(_np(prefill), _np(jpre), **LOGIT_TOL)


def test_greedy_generate_matches(weights):
    jcfg, tcfg = VLM
    jp, tp = weights
    prompt = _prompt(11, 2, 8, jcfg.vocab_size)
    with jax.disable_jit():
        want = np.asarray(jss.greedy_generate(jp, jcfg, jnp.asarray(prompt), 8))
    got = tss.greedy_generate(tp, tcfg, prompt, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _state(cb):
    return ({r.rid: list(r.out) for r in cb.finished},
            [(type(e).__name__, e.rid, getattr(e, "pos", None)) for e in cb.bus.log],
            (cb.prefill_quanta, cb.decode_quanta, cb.prefill_launches,
             cb.decode_launches))


def test_batcher_matches(weights):
    """Three requests on two slots (bf16 KV, fused chunk prefill, a second
    admission wave): the reference's token streams, events and counters."""
    jcfg, tcfg = VLM
    jp, tp = weights
    kw = dict(slots=2, max_len=24, block_size=4, prefill_chunk=4)
    out = []
    for cls, cb in ((JReq, JCB(jp, jcfg, clock=_clock(), **kw)),
                    (TReq, TCB(tp, tcfg, clock=_clock(), device="cpu", **kw))):
        for i, n in enumerate((7, 9, 5)):
            cb.submit(cls(rid=i, prompt=[int(t) for t in _prompt(60 + i, 1, n,
                                                                  jcfg.vocab_size)[0]],
                          max_new=5))
        cb.run()
        cb.runtime.check_consistency()
        out.append(_state(cb))
    assert out[1] == out[0]
    assert len(out[1][0]) == 3


# ------------------------------------------------------------ configs

def test_config_copied():
    fields = {f.name for f in dataclasses.fields(tbase.ModelConfig)}
    for j, t in ((jget_config("qwen2-vl-72b"), tget_config("qwen2-vl-72b")),
                 VLM):
        assert dataclasses.asdict(t) == {k: v for k, v in dataclasses.asdict(j).items()
                                         if k in fields}
    assert tuple(VLM[1].mrope_sections) == (4, 6, 6)
    assert tfrontend.VLM_PATCHES == jfrontend.VLM_PATCHES
    assert (tfrontend.vision_frontend_shape(VLM[1], 3)
            == jfrontend.vision_frontend_shape(VLM[0], 3))
    got = tsmoke(0, VLM[1], batch=2, seq=16)
    want = jsmoke(jax.random.PRNGKey(0), VLM[0], batch=2, seq=16)
    assert sorted(got) == sorted(want)
    assert got["prefix_embeds"].shape == want["prefix_embeds"].shape
    assert got["prefix_embeds"].dtype == torch.bfloat16


@pytest.mark.parametrize("preset", ["q8_0", "q3_k", "q4_0"])
def test_row_chunked_quantization_gives_the_same_bytes(monkeypatch, preset):
    """A weight too large to quantize at once (qwen2-vl's 152064-row head
    and embedding) is quantized a block of rows at a time: the one-call
    bytes, so ``init_lm(policy=)`` still equals ``quantize_params``."""
    from repro_torch.core import qlinear
    from repro_torch.core.policy import get_policy
    w = torch.randn((37, 512), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    lin = qlinear.Linear(w, role="lm_head")
    whole = qlinear.quantize_linear(lin, get_policy(preset)).w
    monkeypatch.setattr(qlinear, "_CHUNK", 5 * 512)
    parts = qlinear.quantize_linear(lin, get_policy(preset)).w
    assert type(parts) is type(whole)
    for f in dataclasses.fields(whole):
        a, b = getattr(whole, f.name), getattr(parts, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
