"""Port parity: the MoE family (deepseek-moe-16b, moonshot-v1-16b-a3b).

The port's ``models.moe`` and the MoE paths of its LM stack against the
JAX package on the same weights (``weights.from_reference``) and the
same numpy-seeded inputs, on reduced configs (2 layers, 4 experts
top-2 of 128, 1 shared) at d_model 256, so that under q3_k the expert up
and gate projections are Q3_K while the down projection (K = 128) stays
bf16.  Capacity is per group, so each path is held to the same path of
the reference: ``lm_forward`` to ``lm_forward``, the fused chunk prefill
to the fused one, the scan to the scan.

Tolerances: MoE outputs are bf16; both packages compute the same
operations, but f32 sums of the matmuls may run in another order, which
moves a bf16 output by an ulp now and then, so outputs are held within
``OUT_TOL`` and logits within ``LOGIT_TOL`` (the dense stack's); aux
losses (f32 means over the tokens, summed in another order) within
``AUX_RTOL``; tokens exactly, on prompt seeds whose every greedy step has
a top-2 margin of at least ``MARGIN`` (checked in the test).  Where the
reference's compiled program would round elsewhere than its op-by-op
one (``lm_forward``'s scan over layers, ``greedy_generate``), it runs op
by op (``jax.disable_jit()``), as the port does: compiled, one ulp of a
hidden state can swap a near-tie in the router and move a token's
logits by far more than a rounding.
"""
import dataclasses
import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core.qlinear import quantize_params as jquantize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serving import ContinuousBatcher as JCB  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.train import serve_step as jss  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import reduced as treduced  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.core.qlinear import quantize_params as tquantize  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import q3k_matmul as tq3k  # noqa: E402
from repro_torch.kernels import q8_matmul as tq8  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serving import ContinuousBatcher as TCB  # noqa: E402
from repro_torch.serving import Request as TReq  # noqa: E402
from repro_torch.train import serve_step as tss  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek-moe-16b"
OUT_TOL = dict(rtol=1e-2, atol=1e-2)        # about two bf16 ulps
LOGIT_TOL = dict(rtol=2e-2, atol=5e-2)
AUX_RTOL = 1e-4
MARGIN = 0.05
KEY = jax.random.PRNGKey(0)
D_MODEL = 256          # q3_k needs K % 256 == 0; one width keeps the JAX compiles few
PRESETS = ("none", "q8_0", "q3_k")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if "bfloat16" in str(a.dtype) else a


def _cfgs(**moe_kw):
    jcfg = jreduced(jget_config(ARCH), d_model=D_MODEL)
    tcfg = treduced(tget_config(ARCH), d_model=D_MODEL)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """preset -> (jcfg, tcfg, reference params, port params)."""
    out = {}
    jcfg, tcfg = _cfgs()
    base = jT.init_lm(KEY, jcfg)
    for preset in PRESETS:
        jp = base
        if preset != "none":
            jp = jquantize(jp, jpolicy.get_policy(preset))
        out[preset] = (jcfg, tcfg, jp, from_reference(jp, "cpu"))
    return out


@pytest.fixture(scope="module")
def layer():
    """One MoE layer's reference params and the port's (the capacity
    factor is no parameter, so every variant of the config shares them)."""
    jp = jmoe.init_moe(KEY, _cfgs()[0])
    return jp, from_reference(jp, "cpu")


def _layer0(jp):
    """The reference's first layer's MoE params (period axis taken off)."""
    return jax.tree.map(lambda a: a[0], jp["layers"][0]["moe"])


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _moe_pair(jp_moe, tp_moe, jcfg, tcfg, x):
    jy, jaux = jmoe.apply_moe(jp_moe, jcfg, jnp.asarray(x, jnp.bfloat16))
    ty, taux = tmoe.apply_moe(tp_moe, tcfg, torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == x.shape
    return (_np(jy), float(jaux)), (_np(ty), float(taux))


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "moonshot-v1-16b-a3b"])
def test_moe_configs_match(arch):
    want = dataclasses.asdict(jget_config(arch))
    got = dataclasses.asdict(tget_config(arch))
    assert got == {k: v for k, v in want.items() if k in got}
    assert got["moe"]["num_experts"] == 64 and got["moe"]["top_k"] == 6
    assert arch in ARCHS


# ------------------------------------------------------------- apply_moe

@pytest.mark.parametrize("preset", PRESETS)
def test_apply_moe_matches(models, preset):
    jcfg, tcfg, jp, tp = models[preset]
    layer = tp["layers"][0]["moe"]
    want_types = {"none": ("Tensor",) * 3, "q8_0": ("Q8_0Tensor",) * 3,
                  "q3_k": ("Q3KTensor", "Q3KTensor", "Tensor")}[preset]
    assert tuple(type(layer[k].w).__name__ for k in ("w_up", "w_gate", "w_down")) == want_types
    assert layer["router"].w.dtype == torch.float32
    (jy, jaux), (ty, taux) = _moe_pair(_layer0(jp), layer, jcfg, tcfg,
                                       _x(1, (3, 16, jcfg.d_model)))
    np.testing.assert_allclose(ty, jy, **OUT_TOL)
    assert (ty == jy).mean() > 0.99
    np.testing.assert_allclose(taux, jaux, rtol=AUX_RTOL)


def test_apply_moe_with_drops_matches(layer):
    """capacity_factor 0.5: cap = int(0.5 * 16 * 2 / 4) = 4 of the 8
    entries an expert gets on average, so entries drop to the trash slot."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    jp, tp = layer
    x = _x(2, (2, 16, jcfg.d_model))
    probs = torch.softmax(torch.from_numpy(x).to(torch.bfloat16).float() @ tp["router"].w.t(), -1)
    top = probs.sort(dim=-1, descending=True, stable=True).indices[..., :2]
    counts = torch.nn.functional.one_hot(top.reshape(2, -1), 4).sum(1)
    assert (counts > 4).any()
    (jy, jaux), (ty, taux) = _moe_pair(jp, tp, jcfg, tcfg, x)
    np.testing.assert_allclose(ty, jy, **OUT_TOL)
    np.testing.assert_allclose(taux, jaux, rtol=AUX_RTOL)


def test_identical_tokens_identical_outputs(layer):
    """Capacity 4.0 (no drops): identical token vectors give identical
    outputs, as in the reference's test."""
    jcfg, tcfg = _cfgs(capacity_factor=4.0)
    x = np.tile(_x(3, (1, 1, jcfg.d_model)), (1, 6, 1))
    (jy, _), (ty, _) = _moe_pair(*layer, jcfg, tcfg, x)
    np.testing.assert_array_equal(ty[0, 1:], np.tile(ty[0, :1], (5, 1)))
    np.testing.assert_allclose(ty, jy, **OUT_TOL)


def test_exact_ties_take_the_lower_expert(layer):
    """Router rows 1-3 zero: every token ties experts 1, 2 and 3 exactly.
    ``jax.lax.top_k`` takes the lower index first; so does the port."""
    jcfg, tcfg = _cfgs()
    jp = dict(layer[0])
    r = jp["router"]
    jp["router"] = type(r)(r.w.at[1:].set(0.0), r.b, r.role)
    x = _x(4, (2, 8, jcfg.d_model))
    (jy, jaux), (ty, taux) = _moe_pair(jp, from_reference(jp, "cpu"), jcfg, tcfg, x)
    np.testing.assert_allclose(ty, jy, **OUT_TOL)
    np.testing.assert_allclose(taux, jaux, rtol=AUX_RTOL)


def test_q4_0_experts_raise_in_both(layer):
    jcfg, tcfg = _cfgs()
    jp = jquantize(layer[0], jpolicy.get_policy("q4_0"))
    tp = tquantize(layer[1], tget_policy("q4_0"))
    x = _x(5, (1, 4, jcfg.d_model))
    with pytest.raises(AttributeError):
        jmoe.apply_moe(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    with pytest.raises(TypeError, match="expert_up weight is Q4_0Tensor"):
        tmoe.apply_moe(tp, tcfg, torch.from_numpy(x).to(torch.bfloat16))


def test_init_moe_layout():
    _, tcfg = _cfgs()
    p = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
    e, ff, d = tcfg.moe.num_experts, tcfg.moe.expert_ff, tcfg.d_model
    assert p["router"].w.shape == (e, d) and p["router"].w.dtype == torch.float32
    assert p["w_up"].w.shape == p["w_gate"].w.shape == (e, ff, d)
    assert p["w_down"].w.shape == (e, d, ff) and p["w_down"].w.dtype == torch.bfloat16
    assert {k: v.role for k, v in p.items() if k != "shared"} == {
        "router": "router", "w_up": "expert_up", "w_gate": "expert_gate",
        "w_down": "expert_down"}
    assert p["shared"]["up"].w.shape == (ff * tcfg.moe.num_shared, d)


# ------------------------------------------------------ the batched route

@pytest.mark.parametrize("fmt,k", [("q8_0", 96), ("q8_0", 100), ("q3_k", 512)])
def test_batched_route_plain_equals_per_expert_loop(fmt, k):
    """``ops.quantized_matmul`` of x (E, M, K) against a weight with a
    leading expert axis: on the CPU, the 2-D plain version expert by
    expert, bit for bit (a ragged K = 100 Q8_0 weight included); and the
    reference's vmap over experts within one bf16 rounding."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((4, 5, k)).astype(np.float32)
    w = (rng.standard_normal((4, 70, k)) * k ** -0.5).astype(np.float32)
    tw = tquant.quantize(torch.from_numpy(w), fmt)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.quantized_matmul(tx, tw, out_dtype=torch.float32)
    one = ref.q8_matmul_ref if fmt == "q8_0" else ref.q3k_matmul_ref
    sub = ((lambda i: tquant.Q8_0Tensor(tw.qs[i], tw.d[i], tw.logical)) if fmt == "q8_0"
           else (lambda i: tquant.Q3KTensor(tw.ql[i], tw.qh[i], tw.scales[i], tw.d[i])))
    want = torch.stack([one(tx[i], sub(i)) for i in range(4)])
    assert torch.equal(got, want) and tuple(got.shape) == (4, 5, 70)
    from repro.core import quant as jquant
    jw = jquant.quantize(jnp.asarray(w), fmt)
    jy = jax.vmap(lambda xg, we: jops.quantized_matmul(xg, we))(
        jnp.asarray(x, jnp.bfloat16), jw)
    np.testing.assert_allclose(_np(got.to(torch.bfloat16)), _np(jy), rtol=1e-2, atol=1e-2)


def test_batched_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 3, 256), dtype=torch.bfloat16)
    w8 = tquant.quantize_q8_0(torch.zeros((2, 16, 256)))
    w3 = tquant.quantize_q3_k(torch.zeros((2, 16, 256)))
    with pytest.raises(ValueError, match="CUDA"):
        tq8.q8_matmul_experts(x, w8.qs, w8.d)
    with pytest.raises(ValueError, match="CUDA"):
        tq3k.q3k_matmul_experts(x, w3.ql, w3.qh, w3.scales, w3.d)
    with pytest.raises(ValueError, match=r"\(E, M, K\)"):
        ops.quantized_matmul(x[0], w8)


@pytest.mark.parametrize("shape,align,stride", [((4, 70, 3), 8, 216), ((4, 16, 8), 8, 128),
                                                ((2, 70, 1, 12), 16, 848)])
def test_expert_rows_align_each_expert(shape, align, stride):
    """The batched wrappers' scale buffers: each expert's elements start a
    multiple of ``align`` elements (16 bytes) apart, padded only when
    needed, and keep their values."""
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    buf, got = build.expert_rows(t, align)
    per = int(np.prod(shape[1:]))
    assert got == stride and got % align == 0 and buf.data_ptr() % 16 == 0
    assert torch.equal(buf.reshape(shape[0], -1)[:, :per].reshape(shape), t)
    assert (buf is t) == (per % align == 0)


# ------------------------------------------------------------- LM paths

@pytest.mark.parametrize("preset", PRESETS)
def test_lm_forward_matches(models, preset):
    jcfg, tcfg, jp, tp = models[preset]
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 24))
    with jax.disable_jit():
        jl, jaux = jT.lm_forward(jp, jcfg, jnp.asarray(toks))
    tl, taux = tT.lm_forward(tp, tcfg, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and taux.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    assert float(taux) > 0


def _margins(logits) -> float:
    top = np.sort(_np(logits), -1)[..., -2:]
    return float((top[..., 1] - top[..., 0]).min())


@pytest.mark.parametrize("preset,seed", [("none", 25), ("q8_0", 25), ("q3_k", 16)])
def test_greedy_generate_matches(models, preset, seed):
    """Prompt 8, 4 greedy steps at 2 rows: the reference's tokens (its
    loop run op by op), on a prompt whose greedy steps keep a top-2
    margin of at least MARGIN."""
    jcfg, tcfg, jp, tp = models[preset]
    prompt = np.random.default_rng(seed).integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    with jax.disable_jit():
        want = np.asarray(jss.greedy_generate(jp, jcfg, jnp.asarray(prompt), 4))
    got = tss.greedy_generate(tp, tcfg, prompt, 4, device="cpu")
    cache = tss.make_cache(tp, tcfg, 2, 12, device="cpu")
    decode = tss.make_decode(tcfg, device="cpu")
    margin = 9.0
    with torch.no_grad():
        for i in range(11):
            _, lg, cache = decode(tp, got[:, i:i + 1], i, cache)
            if i >= 7:
                margin = min(margin, _margins(lg[:, 0]))
    assert margin >= MARGIN
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def _paged(jcfg, tcfg, jp, tp):
    jc = jT.init_cache(jp, jcfg, 1, 32, block_size=8, num_blocks=8)
    tc = tT.init_cache(tp, tcfg, 1, 32, block_size=8, num_blocks=8, device="cpu")
    return jc, tc


@pytest.mark.parametrize("preset,fused", [("none", True), ("none", False),
                                          ("q8_0", True), ("q3_k", True)])
def test_chunk_prefill_and_verify_match_the_same_path(models, preset, fused):
    """A 12-token chunk (cap = int(1.25 * 12 * 2 / 4) = 7 per expert on the
    fused path, one token per group on the scan), a second chunk, then a
    3-token verify and a decode step, each against the same reference path."""
    jcfg, tcfg, jp, tp = models[preset]
    assert tT.prefill_path(tcfg, fused=fused) == ("fused" if fused else "scan")
    jc, tc = _paged(jcfg, tcfg, jp, tp)
    row = np.array([[3, 1, 6, 2]], np.int32)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (1, 20)).astype(np.int32)
    for lo, hi in ((0, 12), (12, 17)):
        jl, jc = jT.lm_prefill_chunk(jp, jcfg, jnp.asarray(toks[:, lo:hi]),
                                     jnp.array([lo], jnp.int32), jc,
                                     block_tables=jnp.asarray(row), fused=fused)
        tl, tc = tT.lm_prefill_chunk(tp, tcfg, torch.from_numpy(toks[:, lo:hi]), lo, tc,
                                     block_tables=torch.from_numpy(row), fused=fused)
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    jl, jc = jT.lm_verify_chunk(jp, jcfg, jnp.asarray(toks[:, 17:20]),
                                jnp.array([17], jnp.int32), jc,
                                block_tables=jnp.asarray(row), fused=fused)
    tl, tc = tT.lm_verify_chunk(tp, tcfg, torch.from_numpy(toks[:, 17:20]), 17, tc,
                                block_tables=torch.from_numpy(row), fused=fused)
    assert tuple(tl.shape) == (1, 3, jcfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    p = np.array([20], np.int32)
    tok = np.argmax(_np(tl)[:, -1:], -1).astype(np.int32)
    jl, _ = jT.lm_decode_step(jp, jcfg, jnp.asarray(tok), jnp.asarray(p), jc,
                              block_tables=jnp.asarray(row))
    tl, _ = tT.lm_decode_step(tp, tcfg, torch.from_numpy(tok), torch.from_numpy(p), tc,
                              block_tables=torch.from_numpy(row))
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)


def test_grouping_decides_drops():
    """With capacity binding (capacity_factor 0.5), the fused chunk (one
    group of 12) and the decode-step scan (one token per group, never a
    drop) give other logits for the same tokens, in both packages alike."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    jp = jT.init_lm(KEY, jcfg)
    tp = from_reference(jp, "cpu")
    row = np.array([[3, 1, 6, 2]], np.int32)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (1, 12)).astype(np.int32)
    out = {}
    for fused in (True, False):
        jc, tc = _paged(jcfg, tcfg, jp, tp)
        jl, _ = jT.lm_prefill_chunk(jp, jcfg, jnp.asarray(toks), jnp.array([0], jnp.int32),
                                    jc, block_tables=jnp.asarray(row), fused=fused)
        tl, _ = tT.lm_prefill_chunk(tp, tcfg, torch.from_numpy(toks), 0, tc,
                                    block_tables=torch.from_numpy(row), fused=fused)
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
        out[fused] = _np(tl)
    assert np.abs(out[True] - out[False]).max() > 0.1


# ----------------------------------------------------------- the batcher

def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _events(cb):
    return [(type(e).__name__, e.rid, getattr(e, "pos", None)) for e in cb.bus.log]


@pytest.mark.parametrize("preset", ["none", "q8_0"])
def test_continuous_batcher_matches(models, preset):
    """reduced(deepseek-moe-16b) served with 2 slots, 8-token fused chunks
    (prompts of 9-13 tokens: two chunks each) and two admission waves:
    the reference batcher's tokens, events and counters.  The reference's
    batcher runs compiled, so the prompts are a draw (seeds 46-48) on
    which no router near-tie or top-2 near-tie splits the two."""
    jcfg, tcfg, jp, tp = models[preset]
    kw = dict(slots=2, max_len=20, block_size=4, prefill_chunk=8)
    lens = (11, 9, 13)
    prompts = [[int(t) for t in np.random.default_rng(46 + i).integers(1, 500, n)]
               for i, n in enumerate(lens)]
    state = []
    for cls, req, extra in ((JCB, JReq, {}), (TCB, TReq, {"device": "cpu"})):
        params = jp if cls is JCB else tp
        cb = cls(params, jcfg if cls is JCB else tcfg, clock=_clock(), **kw, **extra)
        for i, p in enumerate(prompts):
            cb.submit(req(rid=i, prompt=p, max_new=5))
        cb.run()
        state.append(({r.rid: list(r.out) for r in cb.finished}, _events(cb),
                      (cb.prefill_quanta, cb.decode_quanta, cb.prefill_launches,
                       cb.decode_launches)))
    assert state[1] == state[0]
    assert all(len(v) == 5 for v in state[1][0].values())


# ------------------------------------------------------------ stand-alone

def test_moe_path_leaves_jax_unloaded():
    code = (
        "import sys, torch\n"
        "from repro_torch.configs import get_config, reduced\n"
        "from repro_torch.core import accounting, qlinear\n"
        "from repro_torch.core.policy import get_policy\n"
        "from repro_torch.models import moe, transformer as T\n"
        "from repro_torch.serving import ContinuousBatcher, Request\n"
        "from repro_torch.train.serve_step import greedy_generate\n"
        "cfg = reduced(get_config('moonshot-v1-16b-a3b'))\n"
        "p = qlinear.quantize_params(T.init_lm(torch.Generator().manual_seed(0), cfg),\n"
        "                            get_policy('q8_0'))\n"
        "sites = []\n"
        "qlinear.set_recorder(lambda **kw: sites.append(accounting.MatmulOp(**kw)))\n"
        "logits, aux = T.lm_forward(p, cfg, torch.ones((1, 6), dtype=torch.long))\n"
        "qlinear.set_recorder(None)\n"
        "assert float(aux) > 0 and sites and qlinear.param_count(p) > 0\n"
        "cb = ContinuousBatcher(p, cfg, max_len=12, device='cpu')\n"
        "cb.submit(Request(rid=0, prompt=[3] * 9, max_new=3))\n"
        "assert len(cb.run()[0].out) == 3\n"
        "assert greedy_generate(p, cfg, [[3] * 4], 2, device='cpu').shape == (1, 6)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
