"""Port parity: the SD UNet at TINY size.

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
from repro.models import unet as junet  # noqa: E402
from repro_torch.configs import TINY_SD  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
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


@pytest.fixture(scope="module")
def unet_params():
    jp = junet.init_unet(jax.random.PRNGKey(1), JCFG.unet)
    return jp, from_reference(jp, "cpu")


def test_unet_blocks_match(unet_params):
    jp, tp = unet_params
    cfg = JCFG.unet
    jx, tx = _pair((2, 8, 8, 32), 10)
    jc, tc = _pair((2, 77, 64), 11)
    jt, tt = _pair((2, 128), 12)
    blk_j, blk_t = jp["downs"][0], tp["downs"][0]
    _exact(junet.apply_resblock(blk_j["res"], jx, jt, cfg.groups),
           tunet.apply_resblock(blk_t["res"], tx, tt, cfg.groups))
    _exact(junet.apply_spatial_transformer(blk_j["attn"], jx, jc, cfg),
           tunet.apply_spatial_transformer(blk_t["attn"], tx, tc, cfg))


@pytest.mark.parametrize("preset", [None, "q8_0", "q3_k"])
def test_apply_unet_matches(unet_params, preset):
    """Full UNet, reference eager.  The f32 timestep embedding differs in
    the last bits (exp/sin/cos implementations), which flips some bf16
    roundings downstream: corr > 0.9999 and max|d| <= 3e-2."""
    jp, tp = unet_params
    if preset is not None:
        jp = jql.quantize_params(jp, jpolicy.get_policy(preset))
        tp = tql.quantize_params(tp, tpolicy.get_policy(preset))
    jx, tx = _pair((2, 8, 8, 4), 13)
    jc, tc = _pair((2, 77, 64), 14)
    t = np.array([999, 10], np.int32)
    want = junet.apply_unet(jp, JCFG.unet, jx, jnp.asarray(t), jc)
    got = tunet.apply_unet(tp, TINY_SD.unet, tx, torch.from_numpy(t), tc)
    _close(want, got, corr=0.9999, max_abs=3e-2)
