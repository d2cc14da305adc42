"""Port parity: shared layers (conv, norms, activations, linears,
embeddings) at TINY sizes.

Same weights (the reference's ``init_*`` converted by
``weights.from_reference``) and the same numpy inputs go through the
JAX function and the port's.  The reference is run op by op (eager),
where it rounds every bf16 intermediate; the port rounds at the same
places, so layers agree exactly or to one bf16 ulp of a few elements
(f32 sums in another order).  Whole models carry such flips through
many bf16 roundings, and are held at the looser bound stated with each.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import policy as jpolicy  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.engine import diffusion_engine as jde  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import unet as junet  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import unet as tunet  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


JCFG = jde.TINY_SD


def _pair(shape, seed, scale=1.0):
    j = jnp.asarray(np.random.default_rng(seed).standard_normal(shape) * scale,
                    jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _exact(want, got):
    np.testing.assert_array_equal(_np(got), _np(want))


def _close(want, got, *, corr, max_abs, max_frac=1.0):
    a, b = _np(want).ravel(), _np(got).ravel()
    assert a.shape == b.shape
    c = np.corrcoef(a, b)[0, 1]
    d = np.abs(a - b)
    assert c > corr, c
    assert d.max() <= max_abs, d.max()
    assert (d > 0).mean() <= max_frac, (d > 0).mean()


# -------------------------------------------------------------- layers

@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2), (1, 2)])
def test_apply_conv_matches(k, stride):
    jx, tx = _pair((2, 8, 8, 12), 0)
    conv = junet.init_conv(jax.random.PRNGKey(k + stride), 12, 16, k=k)
    _exact(junet.apply_conv(conv, jx, stride=stride),
           tunet.apply_conv(from_reference(conv, "cpu"), tx, stride=stride))


def test_im2col_feature_order_is_channel_major():
    x = torch.arange(2 * 5 * 5 * 3, dtype=torch.float32).reshape(2, 5, 5, 3)
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x.numpy()), (3, 3), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(tunet.im2col(x, 3).numpy(), np.asarray(want))


@pytest.mark.parametrize("groups", [8, 32])
def test_groupnorm_matches(groups):
    jx, tx = _pair((2, 4, 4, 32), 1, scale=3.0)
    jp = {"g": jnp.asarray(np.linspace(0.5, 1.5, 32), jnp.float32),
          "b": jnp.asarray(np.linspace(-1, 1, 32), jnp.float32)}
    _exact(junet.groupnorm(jp, jx, groups),
           tunet.groupnorm(from_reference(jp, "cpu"), tx, groups))


def test_norms_and_activations_match():
    jx, tx = _pair((3, 7, 64), 2, scale=3.0)
    jp = {"g": jnp.asarray(np.linspace(0.5, 1.5, 64), jnp.float32),
          "b": jnp.asarray(np.linspace(-1, 1, 64), jnp.float32)}
    tp = from_reference(jp, "cpu")
    _exact(jL.layernorm(jp, jx), tL.layernorm(tp, tx))
    _exact(jL.rmsnorm(jp, jx), tL.rmsnorm(tp, tx))
    _exact(jax.nn.silu(jx), tL.silu(tx))
    _exact(jax.nn.gelu(jx), tL.gelu(tx))


def test_timestep_embedding_and_upsample_match():
    t = np.array([999, 500, 1, 0], np.int32)
    np.testing.assert_allclose(
        tunet.timestep_embedding(torch.from_numpy(t), 64).numpy(),
        np.asarray(junet.timestep_embedding(jnp.asarray(t), 64)),
        rtol=1e-5, atol=1e-5)
    jx, tx = _pair((2, 3, 5, 4), 3)
    _exact(jax.image.resize(jx, (2, 6, 10, 4), "nearest"), tunet.upsample2x(tx))


@pytest.mark.parametrize("wdtype", [jnp.bfloat16, jnp.float16, jnp.float32])
def test_dense_linear_casts_match(wdtype):
    """x is cast to the weight's dtype, accumulated in f32 and cast once
    to x's dtype (f16 conv weights under q8_0/q3_k, f32 time_embed)."""
    jx, tx = _pair((2, 5, 48), 4, scale=30.0)
    w = jnp.asarray(np.random.default_rng(5).standard_normal((24, 48)), wdtype)
    lin = jql.Linear(w, jnp.asarray(np.arange(24) * 0.1, jnp.bfloat16),
                     "proj_misc")
    _exact(jql.apply_linear(lin, jx),
           tql.apply_linear(from_reference(lin, "cpu"), tx))


@pytest.mark.parametrize("preset", ["none", "q8_0", "q3_k"])
def test_mlp_and_embedding_match(preset):
    pol = jpolicy.get_policy(preset)
    mlp = jql.quantize_params(jL.init_mlp(jax.random.PRNGKey(6), 256, 512,
                                          "gelu"), pol)
    jx, tx = _pair((2, 9, 256), 6)
    _exact(jL.apply_mlp(mlp, jx, "gelu"),
           tL.apply_mlp(from_reference(mlp, "cpu"), tx, "gelu"))
    emb = jql.quantize_linear(jL.init_embedding(jax.random.PRNGKey(7), 50, 64),
                              pol)
    toks = np.array([[0, 3, 49], [7, 7, 1]])
    _exact(jL.apply_embedding(emb, jnp.asarray(toks)),
           tL.apply_embedding(from_reference(emb, "cpu"), torch.from_numpy(toks)))
