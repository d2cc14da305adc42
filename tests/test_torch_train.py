"""Port parity: the single-process training path at reduced size.

* Loss and gradients of ``train_step.make_loss_fn`` (through
  ``value_and_grad``: ``torch.autograd.grad`` over every parameter leaf)
  against ``jax.value_and_grad`` of the reference's, for
  reduced(granite-8b) and reduced(qwen2-vl-72b) with an 8-patch prefix:
  f32 parameters within ``GRAD_F32_REL`` of each leaf's largest gradient
  (the same math in f32, sums in another order), bf16 within
  ``GRAD_BF16_REL`` (the two packages round the bf16 forward and
  backward at different points; measured up to 2.0e-2).
* ``remat`` ``"none"``, ``"block"`` and ``"full"`` give the port the
  same gradient bits.
* One ``make_train_step`` against the reference's, f32, under each of:
  plain, ``microbatch``, ``quantized_moments`` and ``grad_compression``;
  moments and residuals within ``MOMENT_ATOL``, but for a few elements a
  Q8_0 code apart under the two quantizing options (``_check_state``).
* The reference's ``test_optim.py`` cases run through both packages,
  AdamW's decay at a large rate on nonzero parameters, and
  ``compress_decompress`` bit for bit (a leaf padded to 32).
* ``kernels.flash_attention.FlashAttention`` with the plain version as
  its forward (a CPU tensor): the gradient bits of autograd through
  ``flash_attention_ref``; ``ops.attention`` on a tensor the dispatch
  takes for the card goes through it, and every other kernel entry
  raises there when an input requires grad.
* A finite-loss train step for every ported architecture (port only).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import ARCHS, smoke_inputs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


GRAD_F32_REL = 2e-5      # measured <= 1.8e-6 of a leaf's largest gradient
GRAD_BF16_REL = 4e-2     # measured <= 2.0e-2 (bf16 rounding points differ)
LOSS_F32 = dict(rtol=1e-6, atol=0)
LOSS_BF16 = dict(rtol=1e-3, atol=0)   # measured 3.4e-4
# The global norm sums per-layer leaves where the reference sums stacked
# ones, and a compressed gradient may round an element to the next Q8_0
# code (measured <= 1.8e-6).
GRAD_NORM_RTOL = 1e-5
# f32 parameters after one AdamW step: the update is lr * u with u =
# m / (sqrt(v) + eps) ~ +-1; where a gradient entry is near eps, its
# last-ulp differences move u by a few percent: 3e-5 is a tenth of one
# step at lr 3e-4 (measured <= 1.04e-5).
PARAM_F32_ATOL = 3e-5
MOMENT_ATOL = 2e-5       # moments of f32 gradients (measured <= 7.1e-6 but at a flip)
# The decay's share of one AdamW step, (step without decay) - (step with
# it) = lr * wd * p, at |p| <= 3.4: two roundings of p, a few f32 ulps
# (measured 1.9e-7; the decay itself is up to 5.0e-4).
DECAY_ATOL = 1e-6
QUANT_FLIPS = 1e-3       # share of Q8_0 elements allowed one code apart
ARCHS_CMP = ("granite-8b", "qwen2-vl-72b")


@pytest.fixture(scope="module")
def models():
    out = {}
    for seed, arch in enumerate(ARCHS_CMP):
        jcfg = jbase.reduced(jget_config(arch))
        out[arch] = (jcfg, tbase.reduced(tget_config(arch)),
                     jT.init_lm(jax.random.PRNGKey(seed), jcfg))
    return out


def _batch(cfg, seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        pre = rng.standard_normal((b, 8, cfg.d_model)) * 0.02
        out["prefix_embeds"] = np.asarray(jnp.asarray(pre, jnp.bfloat16))
    return out


def _cast(tree, dtype):
    return jax.tree.map(lambda a: a.astype(dtype), tree)


def _paths(tree, pre="", quantized=False):
    """{path: tensor} of a port tree (dict keys sorted, as JAX's are);
    Q8_0 leaves dequantized, or kept with ``quantized``."""
    if isinstance(tree, torch.Tensor):
        return {pre: tree}
    if isinstance(tree, tquant.Q8_0Tensor):
        return {pre: tree if quantized else tquant.dequantize_q8_0(tree)}
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_paths(tree[k], f"{pre}/{k}", quantized))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            out.update(_paths(x, f"{pre}/{i}", quantized))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(_paths(getattr(tree, f.name), f"{pre}.{f.name}", quantized))
    return out


def _ref_tree(jtree):
    return from_reference(jtree, "cpu")


def _leaf_errors(got, want):
    """Per path: max|got - want| / max|want| (f32)."""
    a, b = _paths(got), _paths(want)
    assert a.keys() == b.keys()
    return {k: float((a[k].float() - b[k].float()).abs().max()
                     / max(float(b[k].float().abs().max()), 1e-30)) for k in a}


# ----------------------------------------------------- loss and grads

@pytest.mark.parametrize("arch", ARCHS_CMP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(models, arch, dtype):
    jcfg, tcfg, jp = models[arch]
    jp = _cast(jp, getattr(jnp, dtype))
    batch = _batch(jcfg, 7)
    fn = jax.jit(jax.value_and_grad(jts.make_loss_fn(jcfg, jbase.TrainConfig(remat="none")),
                                    has_aux=True))
    (jv, jm), jg = fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _ref_tree(jp)
    grad_fn = tts.value_and_grad(tts.make_loss_fn(tcfg, tbase.TrainConfig(remat="none")))
    (tv, tm), tg = grad_fn(tp, {k: from_reference(v, "cpu") for k, v in batch.items()})
    tol = LOSS_F32 if dtype == "float32" else LOSS_BF16
    np.testing.assert_allclose(float(tv), float(jv), **tol)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **tol)
    for a, b in zip(tree_leaves(tg), tree_leaves(tp)):
        assert a.dtype == b.dtype and a.shape == b.shape
    errs = _leaf_errors(tg, _ref_tree(jg))
    limit = GRAD_F32_REL if dtype == "float32" else GRAD_BF16_REL
    worst = max(errs, key=errs.get)
    assert errs[worst] <= limit, (worst, errs[worst])


def test_remat_modes_give_the_same_gradient_bits(models):
    jcfg, tcfg, jp = models["qwen2-vl-72b"]
    tp = _ref_tree(jp)
    batch = {k: from_reference(v, "cpu") for k, v in _batch(jcfg, 8).items()}
    grads = {}
    for remat in tT.REMAT:
        fn = tts.value_and_grad(tts.make_loss_fn(tcfg, tbase.TrainConfig(remat=remat)))
        (v, _), g = fn(tp, batch)
        grads[remat] = (v, tree_leaves(g))
    for remat in ("block", "full"):
        assert torch.equal(grads[remat][0], grads["none"][0])
        for a, b in zip(grads[remat][1], grads["none"][1]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        tT.lm_forward(tp, tcfg, batch["tokens"], remat="layer")


# ---------------------------------------------------------- train step

STEP_OPTS = {"plain": dict(), "microbatch": dict(microbatch=2),
             "quantized_moments": dict(quantized_moments=True),
             "grad_compression": dict(grad_compression=True)}


@pytest.mark.parametrize("name", sorted(STEP_OPTS))
def test_train_step_matches_jax(models, name):
    arch = "qwen2-vl-72b" if name == "microbatch" else "granite-8b"
    jcfg, tcfg, jp = models[arch]
    jp = _cast(jp, jnp.float32)
    batch = _batch(jcfg, 9, b=4)
    jtc = jbase.TrainConfig(remat="none", **STEP_OPTS[name])
    ttc = tbase.TrainConfig(remat="none", **STEP_OPTS[name])
    jstate = (jp, jadam.init_adam(jp, jtc),
              jcomp.init_compression(jp) if jtc.grad_compression else None)
    jn, jo, jc, jm = jax.jit(jts.make_train_step(jcfg, jtc))(
        *jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _ref_tree(jp)
    tstate = (tp, tadam.init_adam(tp, ttc),
              tcomp.init_compression(tp) if ttc.grad_compression else None)
    tn, to, tc, tm = tts.make_train_step(tcfg, ttc, device="cpu")(
        *tstate, {k: from_reference(v, "cpu") for k, v in batch.items()})
    assert tn is tp                                    # updated in place
    assert int(to.step) == int(jo.step) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_F32)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_NORM_RTOL)
    a, b = _paths(tn), _paths(_ref_tree(jn))
    assert max(float((a[k] - b[k]).abs().max()) for k in a) <= PARAM_F32_ATOL
    om, ov = _ref_tree(jo.m), _ref_tree(jo.v)
    trees = [(to.m, om, None), (to.v, ov, None)]
    if ttc.quantized_moments:
        # One code of a Q8_0 moment: its block's largest |value| / 127.
        trees = [(to.m, om, _code_steps(om)), (to.v, ov, _code_steps(ov))]
    if ttc.grad_compression:
        # One code of the compressed gradient g_c (blocks of 32 over the
        # flattened leaf) moves m = (1 - b1) * clip * g_c by m's block max
        # / 127, v = (1 - b2) * (clip * g_c)^2 by at most 255 / 127^2 of
        # v's block max, and the residual g - g_c by one whole step.
        clip = min(1.0, ttc.grad_clip / (float(jm["grad_norm"]) + 1e-9))
        m_max = {k: _block_max(t) for k, t in _paths(om).items()}
        v_max = {k: _block_max(t) for k, t in _paths(ov).items()}
        trees = [(to.m, om, {k: t / 127 for k, t in m_max.items()}),
                 (to.v, ov, {k: t * 255 / 127 ** 2 for k, t in v_max.items()}),
                 (tc.residual, _ref_tree(jc.residual),
                  {k: t / (127 * (1 - ttc.beta1) * clip) for k, t in m_max.items()})]
    for mine, theirs, steps in trees:
        _check_state(mine, theirs, steps)
    if ttc.quantized_moments:
        assert isinstance(to.m["embed"].w, tquant.Q8_0Tensor)


def _block_max(x):
    """Per element of tensor ``x``: max |x| over its Q8_0 block (32
    elements of the flattened tensor, zero padded), in ``x``'s shape."""
    flat = x.float().reshape(-1)
    blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % 32)).abs().reshape(-1, 32)
    return blocks.amax(-1, keepdim=True).expand(-1, 32).reshape(-1)[:flat.numel()].reshape(
        x.shape)


def _code_steps(tree):
    """{path: one Q8_0 code step per element} of a moment tree: its
    block's largest |value| / 127 for a Q8_0 leaf (the largest element is
    coded +-127), 0 for an f32 one."""
    out = {}
    for k, t in _paths(tree, quantized=True).items():
        q = isinstance(t, tquant.Q8_0Tensor)
        deq = tquant.dequantize_q8_0(t) if q else t
        out[k] = _block_max(deq) / 127 if q else torch.zeros_like(deq)
    return out


def _check_state(mine, theirs, steps=None):
    """Moments and residuals within MOMENT_ATOL.  With ``steps`` ({path:
    one Q8_0 code step per element}), a few elements may differ by up to
    one step more: where a gradient entry is an ulp off, a Q8_0 value (a
    quantized moment, or the compressed gradient that sets the residual)
    may round to the next code.  At most QUANT_FLIPS of the elements may
    do so; without ``steps`` none may."""
    a, b = _paths(mine), _paths(theirs)
    assert a.keys() == b.keys()
    far = sum(int(((a[k] - b[k]).abs() > MOMENT_ATOL).sum()) for k in a)
    total = sum(t.numel() for t in a.values())
    if steps is None:
        assert far == 0, (far, total)
        return
    assert far <= QUANT_FLIPS * total, (far, total)
    for k in a:
        over = (a[k] - b[k]).abs() - (steps[k] * (1 + 1e-3) + MOMENT_ATOL)
        assert float(over.max()) <= 0, (k, float(over.max()))


# ------------------------------------------------- the optim cases, both

def _quad():
    w_star = np.array([1.5, -2.0, 0.5] * 21 + [0.25], np.float32)
    return w_star


def _run_quadratic(pkg, steps, quantized):
    """Adam on sum((w - w*)^2) from 0 -> the parameter trajectory's end."""
    w_star = _quad()
    if pkg == "jax":
        tc = jbase.TrainConfig(lr=5e-2, weight_decay=0.0, quantized_moments=quantized)
        params = {"w": jnp.zeros_like(jnp.asarray(w_star))}
        state = jadam.init_adam(params, tc)
        upd = jax.jit(lambda g, s, p: jadam.adam_update(g, s, p, tc))
        for _ in range(steps):
            g = {"w": 2 * (params["w"] - w_star)}
            params, state = upd(g, state, params)
        return np.asarray(params["w"])
    tc = tbase.TrainConfig(lr=5e-2, weight_decay=0.0, quantized_moments=quantized)
    params = {"w": torch.zeros(64)}
    state = tadam.init_adam(params, tc)
    target = torch.from_numpy(w_star)
    for _ in range(steps):
        g = {"w": 2 * (params["w"] - target)}
        params, state = tadam.adam_update(g, state, params, tc)
    return params["w"].numpy()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_adam_converges_quadratic(pkg):
    w = _run_quadratic(pkg, 300, False)
    assert float(np.sum((w - _quad()) ** 2)) < 1e-2


def test_quantized_moments_track_exact_in_both():
    ends = {(pkg, qz): _run_quadratic(pkg, 150, qz)
            for pkg in ("jax", "torch") for qz in (False, True)}
    for pkg in ("jax", "torch"):
        assert float(np.max(np.abs(ends[pkg, True] - ends[pkg, False]))) < 0.15
    # The two packages' trajectories: f32 elementwise math in the same
    # order (the sqrt-domain Q8_0 moments included).
    for qz in (False, True):
        np.testing.assert_allclose(ends["torch", qz], ends["jax", qz], rtol=0, atol=1e-5)


def test_grad_clip_and_moment_memory_in_both():
    g = np.full((8,), 1e6, np.float32)
    jn, _ = jadam.adam_update({"w": jnp.asarray(g)}, jadam.init_adam(
        {"w": jnp.zeros((8,))}, jbase.TrainConfig(lr=1e-3)),
        {"w": jnp.zeros((8,))}, jbase.TrainConfig(lr=1e-3))
    tc = tbase.TrainConfig(lr=1e-3)
    tp = {"w": torch.zeros(8)}
    tn, st = tadam.adam_update({"w": torch.from_numpy(g)}, tadam.init_adam(tp, tc), tp, tc)
    assert float(tn["w"].abs().max()) < 1.0
    np.testing.assert_array_equal(tn["w"].numpy(), np.asarray(jn["w"]))
    assert int(st.step) == 1 and st.step.dtype == torch.int32
    big = {"w": torch.zeros((1024, 256), dtype=torch.bfloat16)}
    m = tadam.init_adam(big, tbase.TrainConfig(quantized_moments=True)).m["w"]
    assert isinstance(m, tquant.Q8_0Tensor) and m.nbytes() < 1024 * 256 * 4 * 0.6
    odd = tadam.init_adam({"b": torch.zeros(20)}, tbase.TrainConfig(quantized_moments=True))
    assert odd.m["b"].dtype == torch.float32          # last axis % 32 != 0


@pytest.mark.parametrize("quantized", [False, True])
def test_weight_decay_in_both(quantized):
    """AdamW's decoupled decay on nonzero parameters, which the train-step
    comparison cannot resolve (lr * wd * |p| is near PARAM_F32_ATOL
    there): one step at a large decay gives the reference's bits, and its
    difference from the same step without decay is lr * wd * p."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((4, 64)).astype(np.float32),
          "b": rng.standard_normal((20,)).astype(np.float32)}
    g = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32) for k, v in p0.items()}
    ends = {}
    for wd in (0.0, 0.5):
        jtc = jbase.TrainConfig(weight_decay=wd, quantized_moments=quantized)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        jn, _ = jadam.adam_update({k: jnp.asarray(v) for k, v in g.items()},
                                  jadam.init_adam(jp, jtc), jp, jtc)
        ttc = tbase.TrainConfig(weight_decay=wd, quantized_moments=quantized)
        tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        tn, _ = tadam.adam_update({k: torch.from_numpy(v) for k, v in g.items()},
                                  tadam.init_adam(tp, ttc), tp, ttc)
        for k in p0:
            np.testing.assert_array_equal(tn[k].numpy(), np.asarray(jn[k]))
        ends[wd] = {k: tn[k].numpy() for k in p0}
    lr = tbase.TrainConfig().lr
    for k in p0:
        np.testing.assert_allclose(ends[0.0][k] - ends[0.5][k], lr * 0.5 * p0[k],
                                   rtol=0, atol=DECAY_ATOL)


def test_compression_error_feedback_in_both():
    g = (np.random.default_rng(0).standard_normal((4, 64)) * 0.1).astype(np.float32)
    jst = jcomp.init_compression({"g": jnp.asarray(g)})
    tst = tcomp.init_compression({"g": torch.from_numpy(g)})
    acc = torch.zeros(4, 64)
    for _ in range(50):
        jo, jst = jcomp.apply_compression({"g": jnp.asarray(g)}, jst)
        to, tst = tcomp.apply_compression({"g": torch.from_numpy(g)}, tst)
        np.testing.assert_array_equal(to["g"].numpy(), np.asarray(jo["g"]))
        acc = acc + to["g"]
    assert float((acc / 50 - torch.from_numpy(g)).abs().max()) < 5e-3
    assert float(tst.residual["g"].abs().max()) < 0.05
    np.testing.assert_array_equal(tst.residual["g"].numpy(), np.asarray(jst.residual["g"]))
    # A leaf whose size is not a multiple of 32 is padded before blocking.
    odd = np.random.default_rng(1).standard_normal((3, 7)).astype(np.float32)
    r = np.full((3, 7), 0.01, np.float32)
    jd, jr = jcomp.compress_decompress(jnp.asarray(odd, jnp.bfloat16), jnp.asarray(r))
    td, tr = tcomp.compress_decompress(torch.from_numpy(odd).to(torch.bfloat16),
                                       torch.from_numpy(r))
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(td.float().numpy(), np.asarray(jd.astype(jnp.float32)))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tcomp.compression_ratio() == jcomp.compression_ratio() > 1.8


# ------------------------------------------------ the kernels' gradients

@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 5)])
def test_flash_attention_function_gradient_bits(causal, window):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 4, n, 32), generator=gen) for n in (9, 13, 13))
    dout = torch.randn((2, 4, 9, 32), generator=gen)
    outs = []
    for fn in (lambda *t: tfa.FlashAttention.apply(*t, causal, window, None),
               lambda *t: tref.flash_attention_ref(*t, causal=causal, window=window)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        outs.append((out, torch.autograd.grad(out, leaves, dout)))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_card_dispatch_under_grad(monkeypatch):
    """With the dispatch taking every tensor for the card: attention under
    grad goes through the autograd Function (its forward is the plain
    version here, on a CPU tensor) with GQA folded outside it; every other
    kernel entry raises, naming its kernel, when an input requires grad."""
    monkeypatch.setattr(tops, "_on_card", lambda t: True)
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 4, 6, 32), generator=gen, requires_grad=True)
    k, v = (torch.randn((1, 2, 6, 32), generator=gen, requires_grad=True) for _ in range(2))
    out = tops.attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out.sum(), (q, k, v))
    rep = [t.repeat_interleave(2, dim=1) for t in (k, v)]
    want = torch.autograd.grad(tref.flash_attention_ref(q, *rep, causal=True).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    x = torch.randn((3, 256), generator=gen, requires_grad=True)
    w = torch.randn((64, 256), generator=gen)
    weights = {"q8_matmul": tquant.quantize_q8_0(w), "q4_matmul": tquant.quantize_q4_0(w),
               "q3k_matmul": tquant.quantize_q3_k(w)}
    for name, qw in weights.items():
        with pytest.raises(RuntimeError, match=name):
            tops.quantized_matmul(x, qw)
    experts = tquant.quantize_q8_0(torch.randn((2, 64, 256), generator=gen))
    with pytest.raises(RuntimeError, match="q8_matmul"):
        tops.quantized_matmul(torch.randn((2, 3, 256), requires_grad=True), experts)
    with pytest.raises(RuntimeError, match="q8_matmul_w8a8"):
        tops.quantized_matmul_w8a8(x, weights["q8_matmul"])
    qd = torch.randn((2, 2, 2, 32), requires_grad=True)
    pool = torch.zeros((4, 2, 4, 32))
    table = torch.zeros((2, 2), dtype=torch.int32)
    pos = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="flash_decode_paged"):
        tops.paged_decode_attention(qd, pool, pool, table, pos)
    with pytest.raises(RuntimeError, match="flash_decode:"):
        tops.decode_attention(qd, pool[:2], pool[:2], torch.ones(1, dtype=torch.int32))
    kn = torch.randn((3, 2, 32), requires_grad=True)
    qp = torch.randn((3, 2, 2, 32))
    with pytest.raises(RuntimeError, match="flash_prefill_paged:"):
        tops.paged_prefill_attention(qp, kn, kn, pool, pool, table[0], 0)
    scales = torch.zeros((4, 2, 4, 1), dtype=torch.float16)
    with pytest.raises(RuntimeError, match="flash_prefill_paged_q8"):
        tops.paged_prefill_attention(qp, kn, kn, pool.to(torch.int8), pool.to(torch.int8),
                                     table[0], 0, k_scale_pool=scales, v_scale_pool=scales)


# ---------------------------------------------------- every arch, port

@pytest.mark.parametrize("arch", ARCHS)
def test_port_train_step_is_finite(arch):
    cfg = tbase.reduced(tget_config(arch))
    tc = tbase.TrainConfig(remat="none")
    params, opt, comp = tts.init_train_state(torch.Generator().manual_seed(0), cfg, tc,
                                             tT.init_lm)
    before = [t.clone() for t in tree_leaves(params)]
    params, opt, comp, m = tts.make_train_step(cfg, tc, device="cpu")(
        params, opt, comp, smoke_inputs(0, cfg, batch=2, seq=8))
    assert all(np.isfinite(float(m[k])) for k in ("loss", "aux", "grad_norm"))
    assert float(m["loss"]) > 0 and float(m["grad_norm"]) > 0
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(params), before))
