"""Port parity: quantized storage formats and quantized linears.

The port's ``repro_torch.core.quant`` must give the reference's bytes
exactly (``qs``/``d`` for Q8_0 and Q4_0, ``ql``/``qh``/``scales``/``d``
for Q3_K) on the edge cases of ``tests/test_quant.py`` and on random
data, for both Q3_K scale widths; a converted Q4_0 weight keeps its
bytes and dequantizes as the reference's does.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import policy as jpolicy  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.weights import from_reference, to_tensor  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _eq(jarr, tten):
    np.testing.assert_array_equal(np.asarray(jarr), tten.numpy())


EDGE = {
    "zeros": np.zeros((2, 64), np.float32),
    "equal": np.full((2, 32), 3.25, np.float32),
    "huge": np.array([[1e9, -5e8] + [0.0] * 30], np.float32),
    "tiny": np.full((1, 32), 2.0 ** -24, np.float32),
    "max_negative": -np.abs(_rand((8, 256), seed=5, scale=100.0)),
    "random": _rand((4, 256), seed=1),
    "mixed_scale": _rand((3, 512), seed=2) * np.geomspace(
        1e-6, 1e4, 512, dtype=np.float32),
    "tail1": _rand((3, 1), seed=1),
    "tail31": _rand((3, 31), seed=31),
    "tail33": _rand((3, 33), seed=33),
    "tail63": _rand((3, 63), seed=63),
}


@pytest.mark.parametrize("case", sorted(EDGE))
@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_block32_bytes_match(fmt, case):
    x = EDGE[case]
    jt = jq.quantize(jnp.asarray(x), fmt)
    tt = tq.quantize(torch.from_numpy(x), fmt)
    _eq(jt.qs, tt.qs)
    _eq(jt.d, tt.d)
    assert jt.logical == tt.logical and tuple(jt.shape) == tt.shape
    np.testing.assert_array_equal(np.asarray(jq.dequantize(jt)),
                                  tq.dequantize(tt).numpy())


@pytest.mark.parametrize("case", sorted(EDGE))
def test_q4_0_converter_keeps_bytes(case):
    """A reference Q4_0 weight crosses into the port's storage type with
    its bytes, ``logical`` and shape, and dequantizes to the same values."""
    jt = jq.quantize_q4_0(jnp.asarray(EDGE[case]))
    tt = from_reference(jt, "cpu")
    assert isinstance(tt, tq.Q4_0Tensor)
    _eq(jt.qs, tt.qs)
    _eq(jt.d, tt.d)
    assert jt.logical == tt.logical and tuple(jt.shape) == tt.shape
    assert tt.nbytes() == np.asarray(jt.qs).nbytes + np.asarray(jt.d).nbytes
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            tq.dequantize(tt, dtype).float().numpy(),
            np.asarray(jq.dequantize(jt, jdtype), np.float32))


Q3K_EDGE = ["zeros_256", "equal_256", "max_negative", "random",
            "mixed_scale", "huge_256"]


def _q3k_input(case):
    if case == "zeros_256":
        return np.zeros((2, 256), np.float32)
    if case == "equal_256":
        return np.full((2, 256), 3.25, np.float32)
    if case == "huge_256":
        x = np.zeros((1, 256), np.float32)
        x[0, :2] = [1e9, -5e8]
        return x
    return EDGE[case]


@pytest.mark.parametrize("scale_bits", [5, 6])
@pytest.mark.parametrize("case", Q3K_EDGE)
def test_q3k_bytes_match(case, scale_bits):
    x = _q3k_input(case)
    jt = jq.quantize_q3_k(jnp.asarray(x), scale_bits=scale_bits)
    tt = tq.quantize_q3_k(torch.from_numpy(x), scale_bits=scale_bits)
    for f in ("ql", "qh", "scales", "d"):
        _eq(getattr(jt, f), getattr(tt, f))
    np.testing.assert_array_equal(np.asarray(jq.q3k_effective_scales(jt)),
                                  tq.q3k_effective_scales(tt).numpy())
    np.testing.assert_array_equal(np.asarray(jq.dequantize_q3_k(jt)),
                                  tq.dequantize_q3_k(tt).numpy())


def test_q3k_rejects_ragged_k():
    with pytest.raises(ValueError):
        tq.quantize_q3_k(torch.zeros(2, 100))


def test_pack_unpack_helpers_match():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 8, (5, 512)).astype(np.uint8)
    jl, jh = jq.pack_q3(jnp.asarray(q))
    tl, th = tq.pack_q3(torch.from_numpy(q))
    _eq(jl, tl)
    _eq(jh, th)
    _eq(jq.unpack_q3(jl, jh), tq.unpack_q3(tl, th))
    q4 = rng.integers(0, 16, (5, 96)).astype(np.uint8)
    q4[0, :2] = [1, 14]          # asymmetric: a swapped nibble order differs
    jp4 = jq.pack_q4(jnp.asarray(q4))
    tp4 = tq.pack_q4(torch.from_numpy(q4))
    _eq(jp4, tp4)
    assert int(tp4[0, 0]) == 1 | (14 << 4)
    _eq(jq.unpack_q4(jp4), tq.unpack_q4(tp4))
    np.testing.assert_array_equal(tq.unpack_q4(tp4).numpy(), q4.astype(np.int8) - 8)
    sc = rng.integers(0, 64, (3, 4, 16)).astype(np.uint8)
    _eq(jq.pack_scales6(jnp.asarray(sc)), tq.pack_scales6(torch.from_numpy(sc)))
    packed = tq.pack_scales6(torch.from_numpy(sc))
    np.testing.assert_array_equal(tq.unpack_scales6(packed).numpy(), sc)
    for bits in (5, 6):
        _eq(jq.approx_scale_codes(jnp.asarray(sc), bits),
            tq.approx_scale_codes(torch.from_numpy(sc), bits))


def test_policy_copy_matches_reference():
    assert tpolicy.ROLES == jpolicy.ROLES
    assert tpolicy.FORMATS == jpolicy.FORMATS
    for name, jp in jpolicy.PRESETS.items():
        assert dataclasses.asdict(tpolicy.get_policy(name)) == \
            dataclasses.asdict(jp)


LINEAR_CASES = [("attn_qkv", 256), ("attn_qkv", 320), ("conv", 288),
                ("time_embed", 64), ("mlp_down", 40)]


@pytest.mark.parametrize("preset", ["none", "q8_0", "q4_0", "q3_k",
                                    "q3_k_imax"])
@pytest.mark.parametrize("role,k", LINEAR_CASES)
def test_quantize_linear_matches(preset, role, k):
    """Same storage choice (dense when K is not a block multiple) and the
    same bytes; ``param_bytes`` agrees."""
    w = jnp.asarray(_rand((8, k), seed=k), jnp.bfloat16)
    jlin = jql.quantize_linear(jql.Linear(w, None, role),
                               jpolicy.get_policy(preset))
    tlin = tql.quantize_linear(from_reference(jql.Linear(w, None, role), "cpu"),
                               tpolicy.get_policy(preset))
    conv = from_reference(jlin, "cpu")
    assert type(conv.w) is type(tlin.w)
    if isinstance(tlin.w, torch.Tensor):
        assert tlin.w.dtype == conv.w.dtype
        assert torch.equal(tlin.w, conv.w)
    else:
        for f in dataclasses.fields(tlin.w):
            a, b = getattr(tlin.w, f.name), getattr(conv.w, f.name)
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert tql.param_bytes(tlin) == jql.param_bytes(jlin)


def test_to_tensor_keeps_dtypes_and_bits():
    rng = np.random.default_rng(0)
    for dt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16),
                    (jnp.float32, torch.float32)):
        a = jnp.asarray(rng.standard_normal((3, 5)), dt)
        t = to_tensor(a)
        assert t.dtype == tdt
        np.testing.assert_array_equal(np.asarray(a, np.float32), t.float().numpy())
    for dt, tdt in ((jnp.int8, torch.int8), (jnp.uint8, torch.uint8)):
        a = jnp.asarray(rng.integers(0, 100, (4,)), dt)
        t = to_tensor(a)
        assert t.dtype == tdt
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
