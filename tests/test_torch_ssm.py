"""Port parity: the recurrent blocks (Mamba, mLSTM, sLSTM), hybrid
periods and recurrent slot state (xlstm-1.3b, jamba-1.5-large).

The port's ``models.ssm`` and the recurrent paths of its LM stack against
the JAX package on the same weights (``weights.from_reference``) and the
same numpy-seeded inputs.  The JAX side runs op by op
(``jax.disable_jit()``), as the port does.

Tolerances.  Both packages take the same operations in the same order
where an order can be chosen: the activations op by op as JAX defines
them, ``jnp.cumsum`` in XLA's CPU order (blocks of 16), Mamba's
associative scan by JAX's odd/even recursion.  What still differs: XLA's
and torch's ``exp``/``log``/``log1p`` round an f32 result an ulp apart
now and then; the conv's 4 taps, the mLSTM score and output products and
Mamba's C-contraction are sums whose order neither package fixes (XLA's
dot against torch's matmul and sum); and XLA's CPU backend flushes
subnormal products to zero where torch keeps them.  So block outputs
(bf16) are held within ``OUT_TOL`` (about two bf16 ulps), f32 states
within ``STATE_REL`` of each field's largest magnitude.  Logits are held within ``LOGIT_TOL``: the dense
stack's relative part, and an absolute part of 0.1 where the dense
stack's is 0.05, because one bf16 ulp of a block output (the f32 sums of
a projection in another order) is carried through eight residual layers
of reduced(xlstm-1.3b) and its normalisers: the largest difference
measured was 0.079 at |logit| 2.1 (6 prompt seeds, none and q8_0), 0.025
above the dense stack's limit.  Tokens are compared exactly on prompt
seeds whose every greedy step keeps a top-2 margin of at least
``MARGIN`` (checked in the test), and the batcher's token streams and
events exactly.  The JAX side runs op by op: compiled, its own logits
of reduced(xlstm-1.3b) move by 0.42 (the parallel mLSTM form fused) and
its decode step's beyond LOGIT_TOL.  The hybrid's decode step runs
compiled (``test_torch_hybrid``: its logits stay within LOGIT_TOL, and op
by op it costs most of a minute of compiles), and so do both batchers
(their tokens and events are compared, no logit).
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
from repro.configs.base import ModelConfig as JCfg  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core.qlinear import param_count as jparam_count  # noqa: E402
from repro.core.qlinear import quantize_params as jquantize  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serving import ContinuousBatcher as JCB  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.train import serve_step as jss  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import reduced as treduced  # noqa: E402
from repro_torch.configs.base import ModelConfig as TCfg  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.core.qlinear import Linear  # noqa: E402
from repro_torch.core.qlinear import param_count as tparam_count  # noqa: E402
from repro_torch.core.qlinear import quantize_params as tquantize  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serving import ContinuousBatcher as TCB  # noqa: E402
from repro_torch.serving import Request as TReq  # noqa: E402
from repro_torch.train import serve_step as tss  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


ROOT = Path(__file__).resolve().parents[1]
OUT_TOL = dict(rtol=1e-2, atol=1e-2)        # about two bf16 ulps
STATE_REL = 2.0 ** -8     # of a state field's largest magnitude
LOGIT_TOL = dict(rtol=2e-2, atol=0.1)
MARGIN = 0.05
KEY = jax.random.PRNGKey(0)
# A hybrid of 2 periods (attention + Mamba), MoE on every second layer
# (each period's attention layer), an MLP on the Mamba layers; Mamba
# chunks of 4, so that a 12-token forward chains three chunks.
HYB_KW = dict(name="hyb", family="hybrid", num_layers=4, d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=96, head_dim=16,
              block_pattern=("attn", "mamba"), moe_every=2, ssm_state=8,
              mamba_chunk=4)
# Every JAX call of the tests runs on these shapes (2 rows, 12 tokens or
# one), so that its op-by-op programs compile once.
ROWS, SEQ = 2, 12
KINDS = ("mamba", "mlstm", "slstm")
PRESETS = ("none", "q8_0")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if "bfloat16" in str(a.dtype) else a


def _bf16(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, torch.from_numpy(_np(jx)).to(torch.bfloat16)


def _cfgs(which):
    if which == "hybrid":
        return (JCfg(**HYB_KW, moe=JMoE(num_experts=4, top_k=2, expert_ff=64)),
                TCfg(**HYB_KW, moe=TMoE(num_experts=4, top_k=2, expert_ff=64)))
    return jreduced(jget_config(which)), treduced(tget_config(which))


class _Models(dict):
    """(stack, preset) -> (jcfg, tcfg, reference params, port params),
    each made on first use."""

    def __missing__(self, key):
        stack, preset = key
        jcfg, tcfg = _cfgs(stack)
        if preset == "none":
            jp = _jinit(jcfg)
        else:
            pol = jpolicy.get_policy(preset)
            jp = jax.jit(lambda p: jquantize(p, pol))(self[stack, "none"][2])
        self[key] = (jcfg, tcfg, jp, from_reference(jp, "cpu"))
        return self[key]


@pytest.fixture(scope="module")
def models():
    return _Models()


def _jinit(jcfg):
    """The reference's weights, drawn by one compiled ``init_lm`` (its
    values are the test's data, whatever their last bits)."""
    return jax.jit(jT.init_lm, static_argnums=1)(KEY, jcfg)


def _state_np(st):
    return [_np(t) for t in st]


def _check_state(tst, jst):
    """Each f32 field within STATE_REL of its largest magnitude (a
    projection input one bf16 ulp apart moves a state term by that much
    of its size)."""
    for t, j in zip(_state_np(tst), _state_np(jst)):
        np.testing.assert_allclose(t, j, rtol=0, atol=STATE_REL * max(np.abs(j).max(), 1e-30))


# ------------------------------------------------------------ op by op

@pytest.mark.parametrize("name", ["softplus", "log_sigmoid", "sigmoid"])
def test_activations_follow_jax(name):
    """The activations as JAX defines them, within an f32 ulp, over a
    range wide enough for every branch; F.softplus rounds otherwise."""
    x = np.concatenate([np.linspace(-100, 100, 4001, dtype=np.float32),
                        np.array([np.nan, np.inf, -np.inf], np.float32)])
    with jax.disable_jit():
        want = np.asarray(getattr(jax.nn, name)(jnp.asarray(x)))
    got = getattr(tL, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-30)


@pytest.mark.parametrize("n", [1, 16, 17, 40, 300])
def test_cumsum_in_xla_order(n):
    """``_cumsum`` adds the terms in the order of the reference's
    ``jnp.cumsum`` on the CPU: the same bits (torch's cumsum differs)."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((4, 3, n))
         * 10.0 ** rng.integers(-4, 4, (4, 3, n))).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jnp.cumsum(jnp.asarray(x), -1))
    np.testing.assert_array_equal(tssm._cumsum(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 13, 24])
def test_associative_scan_follows_jax(n):
    """Mamba's within-chunk scan combines the same pairs in the same order
    as ``jax.lax.associative_scan``: the same bits on inputs with no
    subnormal products."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)

    def combine(left, right):
        (al, bl), (ar, br) = left, right
        return al * ar, ar * bl + br
    with jax.disable_jit():
        want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = tssm.associative_scan(tssm._combine, (torch.from_numpy(a), torch.from_numpy(b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------- blocks

def _block(models, kind):
    """(jcfg, tcfg, reference params, port params) of one block: the
    hybrid's first Mamba layer, reduced(xlstm-1.3b)'s first mLSTM layer
    and its sLSTM layer."""
    stack, i = {"mamba": ("hybrid", 1), "mlstm": ("xlstm-1.3b", 0),
                "slstm": ("xlstm-1.3b", 7)}[kind]
    jcfg, tcfg, jp, tp = models[stack, "none"]
    plen = len(jcfg.block_pattern)
    jb = jax.tree.map(lambda a: a[i // plen], jp["layers"][i % plen][kind])
    return jcfg, tcfg, jb, tp["layers"][i][kind]


@pytest.mark.parametrize("kind", KINDS)
def test_block_forward_matches(models, kind):
    """``*_fwd`` over 12 tokens (Mamba: three chunks of 4)."""
    jcfg, tcfg, jp, tp = _block(models, kind)
    jx, tx = _bf16(1, (ROWS, SEQ, jcfg.d_model))
    with jax.disable_jit():
        want = getattr(jssm, f"{kind}_fwd")(jp, jcfg, jx)
    got = getattr(tssm, f"{kind}_fwd")(tp, tcfg, tx)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(jx.shape)
    np.testing.assert_allclose(_np(got), _np(want), **OUT_TOL)
    assert (_np(got) == _np(want)).mean() > 0.99


@pytest.mark.parametrize("kind", KINDS)
def test_block_decode_matches(models, kind):
    """``*_decode`` token by token from a fresh state: every output and
    the state after every step; the port's state is updated in place."""
    jcfg, tcfg, jp, tp = _block(models, kind)
    jx, tx = _bf16(2, (ROWS, SEQ, jcfg.d_model))
    jst = getattr(jssm, f"init_{kind}_state")(ROWS, jcfg)
    tst = getattr(tssm, f"init_{kind}_state")(ROWS, tcfg)
    _check_state(tst, jst)
    ptrs = [t.data_ptr() for t in tst]
    with jax.disable_jit():
        for t in range(SEQ):
            jy, jst = getattr(jssm, f"{kind}_decode")(jp, jcfg, jx[:, t:t + 1], jst)
            ty, tst2 = getattr(tssm, f"{kind}_decode")(tp, tcfg, tx[:, t:t + 1], tst)
            assert tst2 is tst and [s.data_ptr() for s in tst] == ptrs
            np.testing.assert_allclose(_np(ty), _np(jy), **OUT_TOL)
            _check_state(tst, jst)


def test_mamba_fwd_needs_whole_chunks(models):
    """S > chunk and S % chunk != 0 fails in both packages (the reference
    when it traces its forward)."""
    jcfg, tcfg, jp, tp = _block(models, "mamba")
    jx, tx = _bf16(3, (1, 6, jcfg.d_model))
    with pytest.raises(AssertionError):
        jax.jit(lambda x: jssm.mamba_fwd(jp, jcfg, x))(jx)
    with pytest.raises(AssertionError):
        tssm.mamba_fwd(tp, tcfg, tx)


# --------------------------------------------------------- parameters

def _layout(tree):
    """Every leaf's (path, shape, dtype, role) of a port tree."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif isinstance(node, Linear):
            out.append((path, tuple(node.w.shape), str(node.w.dtype), node.role,
                        None if node.b is None else tuple(node.b.shape)))
        else:
            out.append((path, tuple(node.shape), str(node.dtype)))
    walk(tree, "")
    return out


@pytest.mark.parametrize("stack", ["hybrid", "xlstm-1.3b"])
def test_init_lm_layout_and_unstack(models, stack):
    """The port's ``init_lm`` has the reference's layout, layer by layer
    (kind by period position, FFN by ``moe_every``), and
    ``from_reference`` unstacks a period of 2 (hybrid) or 8 (xLSTM's 7
    mLSTM + sLSTM, as jamba's attention + 7 Mamba) positions in layer
    order, the f32 leaves (``A_log``, ``D``, sLSTM's ``r`` (4, d)) kept."""
    jcfg, tcfg, jp, tp = models[stack, "none"]
    mine = tT.init_lm(torch.Generator().manual_seed(0), tcfg)
    assert _layout(mine) == _layout(tp)
    plen = len(jcfg.block_pattern)
    for i, layer in enumerate(tp["layers"]):
        kind = jcfg.block_pattern[i % plen]
        assert kind in layer
        ref = jp["layers"][i % plen][kind]
        for name in ("A_log", "D", "r"):
            if name in layer[kind]:
                assert layer[kind][name].dtype == torch.float32
                np.testing.assert_array_equal(_np(layer[kind][name]),
                                              np.asarray(ref[name][i // plen]))


def test_init_lm_quantizes_layer_by_layer():
    """``init_lm(policy=...)`` gives ``quantize_params(init_lm(...))``, and
    a stacked expert weight, quantized one expert at a time, has the bytes
    of one quantization of the whole stack."""
    _, tcfg = _cfgs("hybrid")
    pol = tget_policy("q8_0")
    one = tT.init_lm(torch.Generator().manual_seed(5), tcfg, policy=pol)
    bf16 = tT.init_lm(torch.Generator().manual_seed(5), tcfg)
    two = tquantize(bf16, pol)
    a, b = tree_leaves(one), tree_leaves(two)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    whole = tquant.quantize(bf16["layers"][0]["moe"]["w_up"].w, "q8_0")
    got = one["layers"][0]["moe"]["w_up"].w
    assert torch.equal(got.qs, whole.qs) and torch.equal(got.d, whole.d)


def _meta(tree):
    """A reference tree of ``ShapeDtypeStruct`` leaves as the port's tree
    of empty ``meta`` tensors."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    real = weights.to_tensor
    weights.to_tensor = lambda a, device=None: torch.empty(
        a.shape, dtype=dtypes[str(a.dtype)], device="meta")
    try:
        return weights.from_reference(tree, device="meta")
    finally:
        weights.to_tensor = real


@pytest.mark.parametrize("arch,count", [("xlstm-1.3b", 1_213_565_264),
                                        ("jamba-1.5-large-398b", 398_555_111_424)])
def test_param_count_full_size(arch, count):
    """Both configs at full size on ``meta``: the port's count of the
    reference's shapes is the reference's count (1.21 B and 398.56 B)."""
    shapes = jax.eval_shape(lambda k: jT.init_lm(k, jget_config(arch)), KEY)
    assert jparam_count(shapes) == count
    assert tparam_count(_meta(shapes)) == count


# ----------------------------------------------------------- LM paths

# Prompt seeds whose greedy steps keep a top-2 margin of at least MARGIN
# under none and q8_0 (the largest such margin among seeds 0-59).
GEN_SEED = {"hybrid": 13, "xlstm-1.3b": 34}


def _margin(logits) -> float:
    top = np.sort(_np(logits), -1)[..., -2:]
    return float((top[..., 1] - top[..., 0]).min())


@pytest.mark.parametrize("preset", PRESETS)
def test_lm_paths_match(models, preset):
    _check_lm_paths(models, "xlstm-1.3b", preset)


def _check_lm_paths(models, stack, preset, compiled_decode=False):
    """Greedy decoding of 4 tokens after a prompt of 8 at 2 rows through
    ``make_cache`` + ``make_decode`` in both packages (the reference's
    ``greedy_generate`` loop), every step's logits compared on the
    reference's tokens, on a prompt whose greedy steps keep a top-2 margin
    of at least MARGIN; the port's ``greedy_generate`` gives the
    reference's tokens (op by op, its ``greedy_generate`` too); then
    ``lm_forward`` over the 12 tokens (the MoE aux loss too), op by op.
    ``compiled_decode`` compiles the reference's decode step (one program:
    the hybrid's logits stay within LOGIT_TOL of it, xLSTM's do not)."""
    jcfg, tcfg, jp, tp = models[stack, preset]
    prompt = np.random.default_rng(GEN_SEED[stack]).integers(
        1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    with jax.disable_jit(not compiled_decode):
        jdec = jss.make_decode(jcfg)
        if compiled_decode:
            jdec = jax.jit(jdec)
        jc = jss.make_cache(jp, jcfg, 2, 12)
        tc = tss.make_cache(tp, tcfg, 2, 12, device="cpu")
        tdec = tss.make_decode(tcfg, device="cpu")
        tok, toks, margin = prompt[:, :1], [prompt[:, :1]], 9.0
        for i in range(11):
            nxt, jl, jc = jdec(jp, jnp.asarray(tok), jnp.int32(i), jc)
            _, tl, tc = tdec(tp, torch.from_numpy(tok), i, tc)
            np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
            if i >= 7:
                margin = min(margin, _margin(tl[:, 0]))
            tok = prompt[:, i + 1:i + 2] if i + 1 < 8 else np.asarray(nxt)
            toks.append(tok)
        want = np.concatenate(toks, axis=1)
        if not compiled_decode:
            np.testing.assert_array_equal(
                np.asarray(jss.greedy_generate(jp, jcfg, jnp.asarray(prompt), 4)), want)
    assert margin >= MARGIN
    got = tss.greedy_generate(tp, tcfg, prompt, 4, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with jax.disable_jit():
        jl, jaux = jT.lm_forward(jp, jcfg, jnp.asarray(want))
    tl, taux = tT.lm_forward(tp, tcfg, torch.from_numpy(want))
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)
    assert (float(taux) > 0) == (stack == "hybrid")


# ------------------------------------------------------- slot surgery

def _fill(jc, tc, seed):
    """The same random values in every recurrent field of both caches
    (reference leaves (P, B, ...), port entries one per layer)."""
    rng = np.random.default_rng(seed)
    jout = []
    for j, lc in enumerate(jc):
        fields = {}
        for kind in ("mamba", "mlstm", "slstm"):
            st = getattr(lc, kind)
            if st == ():
                continue
            vals = [rng.standard_normal(a.shape).astype(np.float32) for a in st]
            fields[kind] = type(st)(*(jnp.asarray(v, a.dtype) for v, a in zip(vals, st)))
            for p in range(vals[0].shape[0]):
                entry = tc[p * len(jc) + j]
                for t, v, a in zip(entry, vals, st):
                    t.copy_(torch.from_numpy(_np(jnp.asarray(v[p], a.dtype))))
        jout.append(lc._replace(**fields))
    return jout


def _recurrent_rows(jc, tc, plen):
    """[(port tensor, reference array)] over every recurrent field, the
    reference's period axis taken off."""
    out = []
    for i, entry in enumerate(tc):
        if isinstance(entry, tuple) and not hasattr(entry, "k"):
            lc = jc[i % plen]
            kind = next(k for k in ("mamba", "mlstm", "slstm") if getattr(lc, k) != ())
            out += [(t, a[i // plen]) for t, a in zip(entry, getattr(lc, kind))]
    return out


@pytest.mark.parametrize("stack", ["hybrid", "xlstm-1.3b"])
def test_slot_view_merge_reset_match(models, stack):
    """3 slots with random recurrent rows.  Slot 1's view: the reference
    view's rows, as views of the port's cache (KV pools pass through).
    New values written into both views, then merged: the reference's
    merged cache, bit for bit, the other slots untouched.  A scan prefill
    through the view updates slot 1's rows in place and no other.  A reset
    zeroes slot 2's every field, the stabilisers ``m`` included, as the
    reference's does."""
    jcfg, tcfg, jp, tp = models[stack, "none"]
    plen = len(jcfg.block_pattern)
    jc = jT.init_cache(jp, jcfg, 3, 16, block_size=4, num_blocks=16)
    tc = tT.init_cache(tp, tcfg, 3, 16, block_size=4, num_blocks=16, device="cpu")
    jc = _fill(jc, tc, 7)
    jlocal = jT.cache_slot_view(jc, 1)
    tlocal = tT.cache_slot_view(tc, 1)
    for entry, full in zip(tlocal, tc):
        if isinstance(entry, tT._STATES):
            assert all(t.shape[0] == 1 and t.data_ptr() == f[1].data_ptr()
                       for t, f in zip(entry, full))
        else:
            assert entry is full
    for t, a in _recurrent_rows(jlocal, tlocal, plen):
        np.testing.assert_array_equal(_np(t), np.asarray(a, np.float32))
    before = [_np(t).copy() for t, _ in _recurrent_rows(jc, tc, plen)]
    jlocal = _fill(jlocal, tlocal, 8)
    jc = jT.cache_slot_merge(jc, jlocal, 1)
    assert tT.cache_slot_merge(tc, tlocal, 1) is tc
    for (t, a), t0 in zip(_recurrent_rows(jc, tc, plen), before):
        np.testing.assert_array_equal(_np(t), np.asarray(a, np.float32))
        np.testing.assert_array_equal(_np(t)[[0, 2]], t0[[0, 2]])
        assert not np.array_equal(_np(t)[1], t0[1])
    before = [_np(t).copy() for t, _ in _recurrent_rows(jc, tc, plen)]
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, jcfg.vocab_size, (1, 3)))
    tT.lm_prefill_chunk(tp, tcfg, toks, 0, tT.cache_slot_view(tc, 1),
                        block_tables=torch.tensor([[3, 1, 6, 2]], dtype=torch.int32))
    for (t, _), t0 in zip(_recurrent_rows(jc, tc, plen), before):
        np.testing.assert_array_equal(_np(t)[[0, 2]], t0[[0, 2]])
        assert not np.array_equal(_np(t)[1], t0[1])
    jc = jT.cache_slot_reset(jc, 2)
    assert tT.cache_slot_reset(tc, 2) is tc
    for (t, a), t0 in zip(_recurrent_rows(jc, tc, plen), before):
        assert not _np(t)[2].any() and not np.asarray(a, np.float32)[2].any()
        np.testing.assert_array_equal(_np(t)[0], t0[0])


def test_slstm_reset_differs_from_fresh_in_both(models):
    """The reference's reset writes zeros, so a stabiliser ``m`` that
    starts at -1e30 in a fresh state is 0 after it.  mLSTM's output does
    not depend on it; sLSTM's does (``h = o * c / max(n, 1)``).  Both
    packages alike: the same outputs from either state, and sLSTM's two
    first outputs differ by far more than a rounding."""
    jx, tx = _bf16(9, (ROWS, 1, 128))
    gaps = {}
    for kind in ("mlstm", "slstm"):
        jcfg, tcfg, jp, tp = _block(models, kind)
        outs = []
        for zero in (False, True):
            jst = getattr(jssm, f"init_{kind}_state")(ROWS, jcfg)
            tst = getattr(tssm, f"init_{kind}_state")(ROWS, tcfg)
            if zero:
                jst = jax.tree.map(jnp.zeros_like, jst)
                for row in range(ROWS):
                    tT.cache_slot_reset([tst], row)
            assert not zero or not any(t.any() for t in tst)
            with jax.disable_jit():
                jy, _ = getattr(jssm, f"{kind}_decode")(jp, jcfg, jx, jst)
            ty, _ = getattr(tssm, f"{kind}_decode")(tp, tcfg, tx, tst)
            np.testing.assert_allclose(_np(ty), _np(jy), **OUT_TOL)
            outs.append((_np(ty), _np(jy)))
        gaps[kind] = [np.abs(outs[0][i] - outs[1][i]).max() for i in (0, 1)]
    assert gaps["mlstm"] == [0.0, 0.0]
    assert min(gaps["slstm"]) > 0.05


# ----------------------------------------------------------- the batcher

def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _events(cb):
    return [(type(e).__name__, e.rid, getattr(e, "pos", None)) for e in cb.bus.log]


def test_continuous_batcher_matches(models):
    _check_batcher(models, "xlstm-1.3b")


def _check_batcher(models, stack):
    """Two slots, 4-token chunks (the scan: one launch per token), three
    requests, so that the third lands in a recycled slot: the reference
    batcher's tokens, events and counters.  The reference runs its own
    compiled programs (no logit is compared; op by op costs twice the
    time for the same tokens on these prompts)."""
    jcfg, tcfg, jp, tp = models[stack, "none"]
    kw = dict(slots=2, max_len=14, block_size=4, prefill_chunk=4)
    lens = (7, 5, 6)
    prompts = [[int(t) for t in np.random.default_rng(60 + i).integers(1, 90, n)]
               for i, n in enumerate(lens)]
    state = []
    for cls, req, extra in ((JCB, JReq, {}), (TCB, TReq, {"device": "cpu"})):
        cb = cls(jp if cls is JCB else tp, jcfg if cls is JCB else tcfg,
                 clock=_clock(), **kw, **extra)
        for i, p in enumerate(prompts):
            cb.submit(req(rid=i, prompt=p, max_new=4))
        cb.run()
        state.append(({r.rid: list(r.out) for r in cb.finished}, _events(cb),
                      (cb.prefill_quanta, cb.decode_quanta, cb.prefill_launches,
                       cb.decode_launches)))
    assert state[1] == state[0]
    assert state[1][2][2] == sum(lens)            # one launch per prompt token
    admitted = [e for e in state[1][1] if e[0] == "Admitted"]
    assert len(admitted) == 3


def test_prefix_share_and_spec_decode_refuse_recurrent(models):
    _, tcfg, _, tp = models["hybrid", "none"]
    with pytest.raises(ValueError, match="prefix_share needs a pure-attention"):
        TCB(tp, tcfg, slots=1, max_len=8, prefix_share=True, device="cpu")
    assert tT.prefill_path(tcfg) == "scan"


def test_mrope_still_refused():
    """M-RoPE is ported (it was refused before qwen2-vl's slice): with the
    stub frontend's three equal position streams it is plain RoPE, so an
    M-RoPE granite gives the RoPE granite's logits bit for bit."""
    base = treduced(tget_config("granite-8b"))
    cfg = dataclasses.replace(base, mrope=True, mrope_sections=(4, 6, 6))
    params = tT.init_lm(torch.Generator().manual_seed(0), cfg)
    toks = torch.tensor([[3, 7, 11, 5, 2]])
    assert torch.equal(tT.lm_forward(params, cfg, toks)[0],
                       tT.lm_forward(params, base, toks)[0])


# ------------------------------------------------------------ stand-alone

def test_ssm_path_leaves_jax_unloaded():
    code = (
        "import sys, torch\n"
        "from repro_torch.configs import get_config, reduced\n"
        "from repro_torch.models import ssm, transformer as T\n"
        "from repro_torch.serving import ContinuousBatcher, Request\n"
        "from repro_torch.train.serve_step import greedy_generate\n"
        "cfg = reduced(get_config('xlstm-1.3b'))\n"
        "p = T.init_lm(torch.Generator().manual_seed(0), cfg)\n"
        "out = greedy_generate(p, cfg, torch.ones((1, 3), dtype=torch.int32), 2, device='cpu')\n"
        "assert out.shape == (1, 5)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro'\n"
        "               for m in sys.modules), 'jax or repro imported'\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
