"""Port parity: the CLIP text encoder and the VAE decoder at TINY sizes.

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
from repro.models import clip as jclip  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models import vae as jvae  # noqa: E402
from repro_torch.configs import TINY_SD, clip_config  # noqa: E402
from repro_torch.models import clip as tclip  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models import vae as tvae  # noqa: E402
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


# ---------------------------------------------------------------- CLIP

def _clip_pair(cfg_kw: dict, preset: str | None):
    jcfg = jclip.clip_config(**cfg_kw)
    jp = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    if preset is not None:
        jp = jql.quantize_params(jp, jpolicy.get_policy(preset))
    return jcfg, clip_config(**cfg_kw), jp, from_reference(jp, "cpu")


TINY_CLIP_KW = dict(d_model=64, layers=2, heads=2, vocab=512)
Q3K_CLIP_KW = dict(d_model=256, layers=2, heads=4, vocab=512)


def test_from_reference_unstacks_layers():
    jcfg, tcfg, jp, tp = _clip_pair(TINY_CLIP_KW, "q8_0")
    assert len(tp["layers"]) == tcfg.num_layers
    for i, layer in enumerate(tp["layers"]):
        want = np.asarray(jp["layers"][0]["attn"]["wq"].w.qs[i])
        np.testing.assert_array_equal(layer["attn"]["wq"].w.qs.numpy(), want)


@pytest.mark.parametrize("preset", [None, "q8_0"])
def test_clip_layer_matches(preset):
    """One CLIP layer, reference eager: equal but for a few one-ulp flips
    from f32 attention sums taken in another order."""
    jcfg, tcfg, jp, tp = _clip_pair(TINY_CLIP_KW, preset)
    jx, tx = _pair((2, 77, 64), 8)
    pos = jnp.broadcast_to(jnp.arange(77)[None], (2, 77))
    layer = jax.tree.map(lambda a: a[0], jp["layers"][0])
    want, _ = jT._layer_fwd(layer, jcfg, 0, jx, pos, causal=True)
    got, _ = tT._layer_fwd(tp["layers"][0], tcfg, tx, causal=True)
    _close(want, got, corr=0.99999, max_abs=1e-2, max_frac=0.01)


@pytest.mark.parametrize("cfg_kw,preset", [
    (TINY_CLIP_KW, None), (TINY_CLIP_KW, "q8_0"),
    # at d_model=64 only the MLP down projection is Q3_K; at 256 every
    # linear is
    (Q3K_CLIP_KW, "q3_k")])
def test_clip_encode_matches(cfg_kw, preset):
    """Whole encoder against the reference's compiled layer scan, which
    keeps some bf16 intermediates in f32 (XLA excess precision) where the
    eager reference and the port round: bf16-ulp flips compound over the
    layers, hence corr > 0.9995 and max|d| <= 0.08 of values up to ~4."""
    jcfg, tcfg, jp, tp = _clip_pair(cfg_kw, preset)
    toks = np.random.default_rng(9).integers(0, 512, (2, 77))
    if preset == "q3_k":
        assert type(tp["layers"][0]["attn"]["wq"].w).__name__ == "Q3KTensor"
    want = jclip.clip_encode(jp, jcfg, jnp.asarray(toks))
    got = tclip.clip_encode(tp, tcfg, torch.from_numpy(toks))
    _close(want, got, corr=0.9995, max_abs=0.08)


# ----------------------------------------------------------------- VAE

@pytest.mark.parametrize("preset", [None, "q8_0", "q3_k"])
def test_apply_vae_decoder_matches(preset):
    """VAE decoder, reference eager: one-ulp flips from its f32 attention
    sums only, max|d| <= 1e-2 on images in [-1, 1]."""
    jp = jvae.init_vae_decoder(jax.random.PRNGKey(2), JCFG.vae)
    if preset is not None:
        jp = jql.quantize_params(jp, jpolicy.get_policy(preset))
    tp = from_reference(jp, "cpu")
    jz, tz = _pair((2, 8, 8, 4), 15)
    want = jvae.apply_vae_decoder(jp, JCFG.vae, jz)
    got = tvae.apply_vae_decoder(tp, TINY_SD.vae, tz)
    assert tuple(got.shape) == (2, 16, 16, 3)
    _close(want, got, corr=0.9999, max_abs=1e-2)
