"""Port parity: the plain versions of the ported kernels and the dispatch.

On the CPU the port's ``kernels.ref`` functions are the path every
kernel call takes; here they are held to ``repro.kernels.ref`` (the Q4_0
and w8a8 ones also to their Pallas kernels in interpret mode, and all to
``repro.kernels.ops`` for dispatch with GQA, tail padding and the w8a8
activation quantization) at f32 inputs within ``rtol = atol = 1e-5``.
The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds them to these plain versions there); here we check that their
wrappers refuse CPU tensors instead of computing.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import q4_matmul as jq4  # noqa: E402
from repro.kernels import q8_matmul as jq8  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import q3k_matmul as tq3k  # noqa: E402
from repro_torch.kernels import q4_matmul as tq4  # noqa: E402
from repro_torch.kernels import q8_matmul as tq8  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(shape, seed, dtype=np.float32, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("m,n,k", [(1, 8, 32), (5, 70, 96), (77, 64, 768)])
def test_q8_matmul_ref_matches(m, n, k):
    jx, tx = _pair((m, k), 0)
    jw, tw = _pair((n, k), 1, scale=k ** -0.5)
    want = jref.q8_matmul_ref(jx, jq.quantize_q8_0(jw))
    got = tref.q8_matmul_ref(tx, tq.quantize_q8_0(tw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,n,k", [(1, 8, 256), (5, 70, 512), (64, 40, 1280)])
@pytest.mark.parametrize("scale_bits", [5, 6])
def test_q3k_matmul_ref_matches(m, n, k, scale_bits):
    jx, tx = _pair((m, k), 2)
    jw, tw = _pair((n, k), 3, scale=k ** -0.5)
    want = jref.q3k_matmul_ref(jx, jq.quantize_q3_k(jw, scale_bits))
    got = tref.q3k_matmul_ref(tx, tq.quantize_q3_k(tw, scale_bits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _asym_weight(shape, seed, scale):
    """A weight whose blocks are lopsided (mostly positive, a few large
    negatives), so that a swapped nibble order or a wrong offset cannot
    hide behind symmetric random data."""
    rng = np.random.default_rng(seed)
    w = np.abs(rng.standard_normal(shape)) * scale
    w[:, ::7] *= -3.0
    return w.astype(np.float32)


@pytest.mark.parametrize("m,n,k", [(1, 8, 32), (5, 70, 96), (77, 64, 768),
                                   (3, 24, 100)])
def test_q4_matmul_ref_matches(m, n, k):
    """The plain version against the reference's oracle (K = 100: a
    tail-padded weight) and, where K % 32 == 0, its Pallas kernel run in
    interpret mode, at f32 inputs."""
    jx, tx = _pair((m, k), 20)
    w = _asym_weight((n, k), 21, k ** -0.5)
    jw, tw = jq.quantize_q4_0(jnp.asarray(w)), tq.quantize_q4_0(torch.from_numpy(w))
    got = tref.q4_matmul_ref(tx, tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.q4_matmul_ref(jx, jw)), **TOL)
    if k % 32 == 0:
        pallas = jq4.q4_matmul(jx, jw.qs, jw.d.astype(jnp.float32), bm=8, bn=8,
                               bk=32, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_q4_0_weight_matmul_and_embedding_match():
    """A converted reference Q4_0 weight (tail-padded too) multiplies and
    gathers as the reference's does, through ``ops`` and the embedding."""
    from repro.core.qlinear import Linear as JLinear
    from repro.models.layers import apply_embedding as japply_embedding
    from repro_torch.core.qlinear import Linear
    from repro_torch.models.layers import apply_embedding
    for k in (96, 100):
        jw = jq.quantize_q4_0(jnp.asarray(_asym_weight((10, k), 5, 0.1)))
        w = from_reference(jw, "cpu")
        jx, tx = _pair((2, 3, k), 6)
        want = jops.quantized_matmul(jx.astype(jnp.bfloat16), jw)
        got = tops.quantized_matmul(tx.to(torch.bfloat16), w)
        assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 10)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        toks = np.array([[0, 3, 9], [9, 9, 1]], np.int32)
        want = japply_embedding(JLinear(jw, None, "embed"), jnp.asarray(toks))
        got = apply_embedding(Linear(w, None, "embed"), torch.from_numpy(toks).long())
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("m,n,k", [(1, 8, 32), (5, 70, 96), (77, 64, 768),
                                   (4, 40, 288)])
def test_q8_matmul_w8a8_ref_matches(m, n, k):
    """The integer path's plain version against the reference's oracle
    and its Pallas kernel (interpret), at f32 1e-5: the int32 block dots
    are exact and each scaled term is rounded as the reference's; only
    the f32 sum over the K/32 blocks runs in another order."""
    xq = np.random.default_rng(22).integers(-127, 128, (m, k)).astype(np.int8)
    xs = (np.random.default_rng(23).random((m, k // 32)) * 0.02).astype(np.float32)
    w = _asym_weight((n, k), 24, k ** -0.5)
    jw, tw = jq.quantize_q8_0(jnp.asarray(w)), tq.quantize_q8_0(torch.from_numpy(w))
    got = tref.q8_matmul_w8a8_ref(torch.from_numpy(xq), torch.from_numpy(xs), tw)
    want = jref.q8_matmul_w8a8_ref(jnp.asarray(xq), jnp.asarray(xs), jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = jq8.q8_matmul_w8a8(jnp.asarray(xq), jnp.asarray(xs), jw.qs,
                                jw.d.astype(jnp.float32), bm=8, bn=8, bk=32,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("k", [64, 100])
def test_ops_quantized_matmul_w8a8_matches(k):
    """``ops.quantized_matmul_w8a8`` quantizes x to Q8_0 as the reference
    does (bytes exact) and matches its ``force="xla"`` path."""
    jx, tx = _pair((2, 3, k), 25)
    jw, tw = _pair((24, k), 26, scale=k ** -0.5)
    want = jops.quantized_matmul_w8a8(jx, jq.quantize_q8_0(jw), force="xla")
    got = tops.quantized_matmul_w8a8(tx, tq.quantize_q8_0(tw))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


ATTN = {
    # name: (B, H, Sq, Sk, D, causal, window)
    "self": (2, 2, 64, 64, 16, False, None),
    "causal": (2, 3, 77, 77, 32, True, None),
    "window": (1, 2, 100, 100, 16, True, 17),
    "cross_sq_ne_sk": (2, 2, 64, 77, 40, False, None),
    "causal_sq_lt_sk": (1, 2, 48, 130, 16, True, None),
    "causal_sq_gt_sk": (1, 2, 130, 48, 16, True, None),   # rows with no key
    "ragged_sk": (1, 2, 32, 1000, 16, False, None),
}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_flash_attention_ref_matches(case):
    b, h, sq, sk, d, causal, window = ATTN[case]
    jq_, tq_ = _pair((b, h, sq, d), 6)
    jk, tk = _pair((b, h, sk, d), 7)
    jv, tv = _pair((b, h, sk, d), 8)
    want = jref.flash_attention_ref(jq_, jk, jv, causal=causal, window=window)
    got = tref.flash_attention_ref(tq_, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hq,hkv,sq", [(4, 4, 16), (4, 2, 16), (6, 1, 9),
                                       (4, 2, 4)])
@pytest.mark.parametrize("causal", [False, True])
def test_ops_attention_gqa_matches(hq, hkv, sq, causal):
    jq_, tq_ = _pair((2, hq, sq, 16), 9)
    jk, tk = _pair((2, hkv, 20, 16), 10)
    jv, tv = _pair((2, hkv, 20, 16), 11)
    want = jops.attention(jq_, jk, jv, causal=causal)
    got = tops.attention(tq_, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fmt,k", [("q8_0", 64), ("q8_0", 40), ("q3_k", 512),
                                   ("q8_0", 100)])
def test_ops_quantized_matmul_matches(fmt, k):
    """Leading dims, a tail-padded Q8_0 (``logical``) and the output cast
    follow the reference's dispatch."""
    jx, tx = _pair((2, 3, k), 12)
    jw, tw = _pair((24, k), 13, scale=k ** -0.5)
    want = jops.quantized_matmul(jx.astype(jnp.bfloat16), jq.quantize(jw, fmt))
    got = tops.quantized_matmul(tx.to(torch.bfloat16), tq.quantize(tw, fmt))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 24)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes a CPU
    tensor itself."""
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    w = tq.quantize_q8_0(torch.zeros((8, 64)))
    with pytest.raises(ValueError):
        tq8.q8_matmul(x, w.qs, w.d)
    w3 = tq.quantize_q3_k(torch.zeros((8, 256)))
    with pytest.raises(ValueError):
        tq3k.q3k_matmul(torch.zeros((4, 256)), w3.ql, w3.qh, w3.scales, w3.d)
    q = torch.zeros((1, 1, 16, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    w4 = tq.quantize_q4_0(torch.zeros((8, 64)))
    with pytest.raises(ValueError):
        tq4.q4_matmul(x, w4.qs, w4.d)
    with pytest.raises(ValueError):
        tq8.q8_matmul_w8a8(w.qs[:4], torch.zeros((4, 2)), w.qs, w.d)
    kv_len = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError):
        tfd.flash_decode(q, q, q, kv_len)


def test_cpu_dispatch_launches_nothing():
    tops.reset_launch_counts()
    tops.attention(*(torch.randn(1, 2, 16, 16) for _ in range(3)))
    tops.quantized_matmul(torch.randn(3, 64), tq.quantize_q8_0(torch.randn(8, 64)))
    tops.quantized_matmul(torch.randn(3, 64), tq.quantize_q4_0(torch.randn(8, 64)))
    tops.quantized_matmul_w8a8(torch.randn(3, 64), tq.quantize_q8_0(torch.randn(8, 64)))
    kv = torch.randn(1, 2, 8, 16)
    tops.decode_attention(torch.randn(1, 2, 2, 16), kv, kv,
                          torch.tensor([5], dtype=torch.int32))
    assert tops.launch_counts() == {"flash_attention": 0, "q8_matmul": 0,
                                    "q3k_matmul": 0, "flash_prefill_paged": 0,
                                    "flash_prefill_paged_q8": 0,
                                    "flash_decode_paged": 0, "q4_matmul": 0,
                                    "q8_matmul_w8a8": 0, "flash_decode": 0}
