"""Port parity: the matmul recorder and the dot-product accounting.

The port's recorder (``repro_torch.core.qlinear.set_recorder``) sees the
sites the reference's sees, in the same order: every ``apply_linear``,
the attention score and P.V products of ``ops.attention`` and the VAE's
bottleneck attention; the MoE expert matmuls are not reported in either
package.  The reference's sites come from ``jax.eval_shape`` under its
recorder, as its benchmarks take them, but with ``jax.disable_jit()``:
traced, a ``lax.scan`` over a stack's layers runs its body once, so the
benchmarks' lists hold one layer of CLIP's twelve (393 sites of SD-Turbo
against 481); op by op every layer reports.  The port's from a run on the CPU
at TINY sizes and on the ``meta`` device at full size (parameters built
as empty meta tensors of the reference's shapes).  Then
``accounting``'s format assignment and FLOP sums, ``param_count``, Q8_K
and ``q3k_matmul_w8a8_ref`` against the reference's.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import accounting as jacc  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.diffusion import pipeline as jpipe  # noqa: E402
from repro.engine.diffusion_engine import TINY_SD as JTINY_SD  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models import unet as junet  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import accounting as tacc  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.diffusion import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models import unet as tunet  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


PRESETS = ("none", "q8_0", "q4_0", "q3_k", "q3_k_imax")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "int8": torch.int8, "uint8": torch.uint8,
           "int32": torch.int32}


def _jsites(fn, *args):
    """The reference's recorded sites of ``jax.eval_shape(fn, *args)``,
    every layer of a scanned stack included."""
    sites = []
    jql.set_recorder(lambda **kw: sites.append(jacc.MatmulOp(**kw)))
    try:
        with jax.disable_jit():
            jax.eval_shape(fn, *args)
    finally:
        jql.set_recorder(None)
    return sites


def _tsites(fn, *args, **kw):
    """The port's recorded sites of one call ``fn(*args, **kw)``."""
    sites = []
    tql.set_recorder(lambda **site: sites.append(tacc.MatmulOp(**site)))
    try:
        with torch.no_grad():
            fn(*args, **kw)
    finally:
        tql.set_recorder(None)
    return sites


def _as_tuples(sites):
    return [(s.name, s.role, s.m, s.n, s.k, s.count, s.act_act) for s in sites]


def _meta(tree):
    """A reference parameter tree of ``ShapeDtypeStruct`` leaves as the
    port's tree of empty ``meta`` tensors (``from_reference``'s walk)."""
    real = weights.to_tensor
    weights.to_tensor = lambda a, device=None: torch.empty(
        a.shape, dtype=_DTYPES[str(a.dtype)], device="meta")
    try:
        return weights.from_reference(tree, device="meta")
    finally:
        weights.to_tensor = real


KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def tiny_sd():
    jp = jpipe.init_pipeline(KEY, JTINY_SD)
    return jp, weights.from_reference(jp, "cpu")


@pytest.fixture(scope="module")
def full_sites():
    """(reference sites, port sites) of the full SD-Turbo pipeline and of
    one SD v1.5 UNet call at batch 1, the port's run on ``meta``."""
    out = {}
    jp = jax.eval_shape(lambda k: jpipe.init_pipeline(k, jpipe.SD_TURBO), KEY)
    want = _jsites(lambda p, t, k: jpipe.generate(p, jpipe.SD_TURBO, t, k), jp,
                   jax.ShapeDtypeStruct((1, 77), jnp.int32), KEY)
    got = _tsites(tpipe.generate, _meta(jp), tbase.SD_TURBO,
                  torch.zeros((1, 77), dtype=torch.long, device="meta"), 0, device="meta")
    out["sd_turbo"] = (want, got)
    ju = jax.eval_shape(lambda k: junet.init_unet(k, junet.SD15_UNET), KEY)
    want = _jsites(lambda p, x, t, c: junet.apply_unet(p, junet.SD15_UNET, x, t, c), ju,
                   jax.ShapeDtypeStruct((1, 64, 64, 4), jnp.bfloat16),
                   jax.ShapeDtypeStruct((1,), jnp.int32),
                   jax.ShapeDtypeStruct((1, 77, 768), jnp.bfloat16))
    meta = {"device": "meta"}
    got = _tsites(tunet.apply_unet, _meta(ju), tbase.SD15_UNET,
                  torch.empty((1, 64, 64, 4), dtype=torch.bfloat16, **meta),
                  torch.empty((1,), dtype=torch.int32, **meta),
                  torch.empty((1, 77, 768), dtype=torch.bfloat16, **meta))
    out["sd15_unet"] = (want, got)
    return out


def test_tiny_sd_pipeline_sites_match(tiny_sd):
    """TINY_SD's whole pipeline (CLIP, one turbo UNet eval, VAE) on the CPU."""
    jp, tp = tiny_sd
    want = _jsites(lambda p, t, k: jpipe.generate(p, JTINY_SD, t, k), jp,
                   jax.ShapeDtypeStruct((2, 77), jnp.int32), KEY)
    got = _tsites(tpipe.generate, tp, tbase.TINY_SD, torch.ones((2, 77), dtype=torch.long),
                  0, device="cpu")
    assert len(got) > 20 and any(s.name == "vae_attn_pv" for s in got)
    assert _as_tuples(got) == _as_tuples(want)


def test_tiny_unet_call_sites_match(tiny_sd):
    jp, tp = tiny_sd
    cfg = JTINY_SD.unet
    want = _jsites(lambda p, x, t, c: junet.apply_unet(p, cfg, x, t, c), jp["unet"],
                   jax.ShapeDtypeStruct((2, 8, 8, 4), jnp.bfloat16),
                   jax.ShapeDtypeStruct((2,), jnp.int32),
                   jax.ShapeDtypeStruct((2, 77, cfg.context_dim), jnp.bfloat16))
    got = _tsites(tunet.apply_unet, tp["unet"], tbase.TINY_SD.unet,
                  torch.zeros((2, 8, 8, 4), dtype=torch.bfloat16),
                  torch.ones((2,), dtype=torch.int32),
                  torch.zeros((2, 77, cfg.context_dim), dtype=torch.bfloat16))
    assert {s.name for s in got} == {"linear", "attn_scores", "attn_pv"}
    assert _as_tuples(got) == _as_tuples(want)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "granite-8b"])
def test_lm_forward_sites_match(arch):
    """reduced LM ``lm_forward``: the router, attention and shared-expert
    linears and the head are recorded; the MoE expert matmuls are not,
    in either package."""
    jcfg, tcfg = jreduced(jget_config(arch)), tbase.reduced(tget_config(arch))
    jp = jT.init_lm(KEY, jcfg)
    toks = np.arange(24, dtype=np.int32).reshape(2, 12) % jcfg.vocab_size
    want = _jsites(lambda p, t: jT.lm_forward(p, jcfg, t), jp, jnp.asarray(toks))
    got = _tsites(tT.lm_forward, weights.from_reference(jp, "cpu"), tcfg,
                  torch.from_numpy(toks).long())
    assert _as_tuples(got) == _as_tuples(want)
    roles = {s.role for s in got}
    assert not roles & {"expert_up", "expert_gate", "expert_down"}
    assert ("router" in roles) == (jcfg.moe is not None)


@pytest.mark.parametrize("which", ["sd_turbo", "sd15_unet"])
def test_full_size_sites_match_on_meta(full_sites, which):
    want, got = full_sites[which]
    assert len(got) > 100
    assert _as_tuples(got) == _as_tuples(want)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("which", ["sd_turbo", "sd15_unet"])
def test_assign_formats_and_flops_match(full_sites, which, preset):
    want, got = full_sites[which]
    ja = jacc.assign_formats(want, jpolicy.get_policy(preset))
    ta = tacc.assign_formats(got, tpolicy.get_policy(preset))
    assert [f for _, f in ta] == [f for _, f in ja]
    assert tacc.flops_by_format(ta) == jacc.flops_by_format(ja)
    assert [op.weight_bytes(f) for op, f in ta] == [op.weight_bytes(f) for op, f in ja]
    assert [op.act_bytes() for op, _ in ta] == [op.act_bytes() for op, _ in ja]

    class Device:     # a device model: seconds = bytes / rate + flops / peak
        def matmul_time(self, op, fmt):
            return op.weight_bytes(fmt) / 1e11 + op.flops / 1e13
    tt, jt = tacc.time_by_format(ta, Device()), jacc.time_by_format(ja, Device())
    assert tt == jt
    assert tacc.fractions(tt) == jacc.fractions(jt)


@pytest.mark.parametrize("preset", ["none", "q8_0", "q3_k"])
def test_param_count_matches(preset):
    jcfg = jreduced(jget_config("deepseek-moe-16b"), d_model=256)
    jp = jT.init_lm(KEY, jcfg)
    if preset != "none":
        jp = jql.quantize_params(jp, jpolicy.get_policy(preset))
    tp = weights.from_reference(jp, "cpu")
    assert tql.param_count(tp) == int(jql.param_count(jp))
    assert tql.param_bytes(tp) == int(jql.param_bytes(jp))


def test_recorder_off_records_nothing():
    tql.set_recorder(None)
    tql.record_matmul("linear", "mlp_up", 1, 2, 3)         # a no-op
    sites = []
    tql.set_recorder(lambda **kw: sites.append(kw))
    try:
        tql.record_matmul("linear", "mlp_up", 1, 2, 3)
    finally:
        tql.set_recorder(None)
    assert sites == [dict(name="linear", role="mlp_up", m=1, n=2, k=3, count=1,
                          act_act=False)]


@pytest.mark.parametrize("shape,scale", [((3, 512), 1.0), ((2, 4, 256), 40.0),
                                         ((1, 256), 0.0)])
def test_q8_k_round_trip_matches(shape, scale):
    x = (np.random.default_rng(0).standard_normal(shape) * scale).astype(np.float32)
    j = jquant.quantize_q8_k(jnp.asarray(x))
    t = tquant.quantize_q8_k(torch.from_numpy(x))
    np.testing.assert_array_equal(t.qs.numpy(), np.asarray(j.qs))
    np.testing.assert_array_equal(t.d.numpy(), np.asarray(j.d))
    assert t.nbytes() == j.nbytes() and t.shape == tuple(j.shape)
    np.testing.assert_array_equal(tquant.dequantize_q8_k(t).numpy(),
                                  np.asarray(jquant.dequantize_q8_k(j)))
    assert tquant.BPW["q8_k"] == jquant.BPW["q8_k"]


def test_q3k_matmul_w8a8_ref_matches():
    """Q8_K activations (scales broadcast to the 16-element sub-blocks)
    against a Q3_K weight: the same f32 result within one rounding of
    the f32 sum order."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 512)).astype(np.float32)
    w = (rng.standard_normal((70, 512)) * 0.05).astype(np.float32)
    jw = jquant.quantize_q3_k(jnp.asarray(w))
    tw = tquant.quantize_q3_k(torch.from_numpy(w))
    jx, tx = jquant.quantize_q8_k(jnp.asarray(x)), tquant.quantize_q8_k(torch.from_numpy(x))
    jxs = jnp.repeat(jx.d, 16, axis=-1)
    txs = tx.d.repeat_interleave(16, dim=-1)
    want = np.asarray(jref.q3k_matmul_w8a8_ref(jx.qs, jxs, jw))
    got = tref.q3k_matmul_w8a8_ref(tx.qs, txs, tw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 70)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
