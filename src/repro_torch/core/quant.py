"""GGML-semantic blocked quantization: Q8_0, Q4_0, Q8_K and Q3_K in PyTorch.

A port of ``repro.core.quant`` that
gives the same bytes for the same input: every step keeps the
reference's float32 arithmetic and order, and ``torch.round`` rounds
half to even like ``jnp.round``.

* **Q8_0** — blocks of 32; fp16 scale ``d``; int8 quants; ``w = d*q``.
* **Q4_0** — blocks of 32; fp16 scale ``d = amax/7``; 4-bit codes
  ``q`` in [0, 15] (clipped before packing), two per byte with the even
  element in the low nibble; ``w = d*(q-8)``.
* **Q8_K** — activation blocks of 256; f32 scale ``d = amax/127``; int8
  quants (the activation side of the Q3_K integer path; no model path).
* **Q3_K** — super-blocks of 256 = 16 sub-blocks of 16; 3-bit quants in
  [-4, 3] as 2-bit ``ql`` plus 1-bit ``qh``; 6-bit sub-block codes with
  offset 32 packed 4 per 3 bytes; fp16 super-scale; ``w = d*(sc-32)*q``.

fp16 block scales saturate into ``[2^-24, 65504]`` for non-zero blocks,
codes are clipped before the narrowing cast, and Q8_0 and Q4_0 accept a
ragged last dimension (zero-padded, ``logical`` keeps the true length)
while Q3_K requires K % 256 == 0 — all as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

QK8_0 = 32
QK_K = 256
Q3K_SUB = 16
N_SUB = QK_K // Q3K_SUB

BPW = {
    "f32": 32.0, "f16": 16.0, "bf16": 16.0,
    "q8_0": (32 * 8 + 16) / 32,
    "q4_0": (16 * 8 + 16) / 32,
    "q3_k": (64 * 8 + 32 * 8 + 12 * 8 + 16) / 256,
    "q8_k": (256 * 8 + 32) / 256,
}

F16_MAX = 65504.0
F16_TINY = 2.0 ** -24


def _check_last_divisible(x: torch.Tensor, block: int) -> None:
    if x.shape[-1] % block:
        raise ValueError(
            f"quantized axis {x.shape[-1]} not divisible by block {block}")


def _f16_scale(amax: torch.Tensor, q_max: float) -> torch.Tensor:
    """``amax / q_max`` saturated into fp16's positive range (zero blocks
    keep a scale of exactly 0)."""
    d = amax / q_max
    d = torch.where(amax > 0, d.clamp(F16_TINY, F16_MAX),
                    torch.zeros_like(d))
    return d.to(torch.float16)


def _pad_tail(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int | None]:
    """Zero-pad the last axis to a block multiple -> (padded, logical)."""
    pad = -x.shape[-1] % block
    if not pad:
        return x, None
    return torch.nn.functional.pad(x, (0, pad)), x.shape[-1]


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], -1, block)


@dataclasses.dataclass
class Q8_0Tensor:
    """int8 quants + fp16 per-32 scales; ``shape`` is the logical shape."""
    qs: torch.Tensor       # int8 (..., Kp)
    d: torch.Tensor        # f16  (..., Kp // 32)
    logical: int | None = None

    @property
    def shape(self):
        k = self.logical if self.logical is not None else self.qs.shape[-1]
        return tuple(self.qs.shape[:-1]) + (k,)

    def nbytes(self) -> int:
        return self.qs.numel() + 2 * self.d.numel()


@dataclasses.dataclass
class Q4_0Tensor:
    """4-bit codes (offset 8), two per byte, fp16 per-32 scales."""
    qs: torch.Tensor       # uint8 (..., Kp // 2)
    d: torch.Tensor        # f16   (..., Kp // 32)
    logical: int | None = None

    @property
    def shape(self):
        k = self.logical if self.logical is not None else self.qs.shape[-1] * 2
        return tuple(self.qs.shape[:-1]) + (k,)

    def nbytes(self) -> int:
        return self.qs.numel() + 2 * self.d.numel()


@dataclasses.dataclass
class Q3KTensor:
    """Packed 3-bit quants, 6-bit sub-scales, fp16 super-scale."""
    ql: torch.Tensor       # uint8 (..., K // 4)
    qh: torch.Tensor       # uint8 (..., K // 8)
    scales: torch.Tensor   # uint8 (..., K // 256, 12)
    d: torch.Tensor        # f16   (..., K // 256)
    scale_bits: int = 6

    @property
    def shape(self):
        return tuple(self.ql.shape[:-1]) + (self.ql.shape[-1] * 4,)

    def nbytes(self) -> int:
        return (self.ql.numel() + self.qh.numel() + self.scales.numel()
                + 2 * self.d.numel())


@dataclasses.dataclass
class Q8KTensor:
    """Q8_K activation blocks: int8 quants + f32 per-256 scales."""
    qs: torch.Tensor       # int8 (..., K)
    d: torch.Tensor        # f32  (..., K // 256)

    @property
    def shape(self):
        return tuple(self.qs.shape)

    def nbytes(self) -> int:
        return self.qs.numel() + 4 * self.d.numel()


QTYPES = (Q8_0Tensor, Q4_0Tensor, Q3KTensor)


# ---------------------------------------------------------------- Q8_0

def quantize_q8_0(x: torch.Tensor) -> Q8_0Tensor:
    xp, logical = _pad_tail(x, QK8_0)
    xb = _blocks(xp.float(), QK8_0)
    amax = xb.abs().amax(dim=-1)
    d = _f16_scale(amax, 127.0)
    df = d.float()
    inv = torch.where(df > 0, 1.0 / df, torch.zeros_like(df))
    q = torch.round(xb * inv[..., None]).clamp(-127, 127).to(torch.int8)
    return Q8_0Tensor(qs=q.reshape(xp.shape), d=d, logical=logical)


def dequantize_q8_0(t: Q8_0Tensor, dtype=torch.float32) -> torch.Tensor:
    w = _blocks(t.qs, QK8_0).float() * t.d.float()[..., None]
    w = w.reshape(t.qs.shape)
    if t.logical is not None:
        w = w[..., :t.logical]
    return w.to(dtype)


# ---------------------------------------------------------------- Q4_0

def pack_q4(q_unsigned: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit values (0..15), last axis K -> K/2 bytes, the even
    element in the low nibble."""
    q = q_unsigned.to(torch.uint8).reshape(*q_unsigned.shape[:-1], -1, 2)
    return q[..., 0] | (q[..., 1] << 4)


def unpack_q4(qs: torch.Tensor) -> torch.Tensor:
    """(..., K/2) bytes -> (..., K) int8 values in [-8, 7] (offset 8);
    column 2j is the low nibble of byte j."""
    q = qs.to(torch.int32)
    out = torch.stack([(q & 0x0F) - 8, ((q >> 4) & 0x0F) - 8], dim=-1)
    return out.reshape(*qs.shape[:-1], qs.shape[-1] * 2).to(torch.int8)


def quantize_q4_0(x: torch.Tensor) -> Q4_0Tensor:
    xp, logical = _pad_tail(x, QK8_0)
    xb = _blocks(xp.float(), QK8_0)
    amax = xb.abs().amax(dim=-1)
    d = _f16_scale(amax, 7.0)
    df = d.float()
    inv = torch.where(df > 0, 1.0 / df, torch.zeros_like(df))
    # The clip keeps each code in [0, 15]: the f16 rounding of d can push
    # round(x * inv) to +8, whose code 16 would spill into the next nibble.
    q = (torch.round(xb * inv[..., None]) + 8).clamp(0, 15)
    qs = pack_q4(q.reshape(xp.shape).to(torch.uint8))
    return Q4_0Tensor(qs=qs, d=d, logical=logical)


def dequantize_q4_0(t: Q4_0Tensor, dtype=torch.float32) -> torch.Tensor:
    q = unpack_q4(t.qs)
    w = _blocks(q, QK8_0).float() * t.d.float()[..., None]
    w = w.reshape(q.shape)
    if t.logical is not None:
        w = w[..., :t.logical]
    return w.to(dtype)


# ---------------------------------------------------------------- Q8_K

def quantize_q8_k(x: torch.Tensor) -> Q8KTensor:
    _check_last_divisible(x, QK_K)
    xb = _blocks(x.float(), QK_K)
    d = xb.abs().amax(dim=-1) / 127.0
    inv = torch.where(d > 0, 1.0 / d, torch.zeros_like(d))
    q = torch.round(xb * inv[..., None]).clamp(-127, 127).to(torch.int8)
    return Q8KTensor(qs=q.reshape(x.shape), d=d)


def dequantize_q8_k(t: Q8KTensor, dtype=torch.float32) -> torch.Tensor:
    w = _blocks(t.qs, QK_K).float() * t.d[..., None]
    return w.reshape(t.qs.shape).to(dtype)


# ---------------------------------------------------------------- Q3_K

_Q3_SHIFTS = (0, 2, 4, 6)


def pack_q3(q_unsigned: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unsigned 3-bit values (0..7), last axis K -> (ql K/4, qh K/8)."""
    q = q_unsigned.to(torch.int32)
    lead = q.shape[:-1]
    low = (q & 3).reshape(*lead, -1, 4)
    shifts = torch.tensor(_Q3_SHIFTS, dtype=torch.int32, device=q.device)
    ql = (low << shifts).sum(dim=-1)
    hi = ((q >> 2) & 1).reshape(*lead, -1, 8)
    hshifts = torch.arange(8, dtype=torch.int32, device=q.device)
    qh = (hi << hshifts).sum(dim=-1)
    return ql.to(torch.uint8), qh.to(torch.uint8)


def unpack_q3(ql: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_q3``: signed int8 values in [-4, 3], (..., K)."""
    shifts = torch.tensor(_Q3_SHIFTS, dtype=torch.int32, device=ql.device)
    low = (ql.to(torch.int32)[..., None] >> shifts) & 3
    low = low.reshape(*ql.shape[:-1], ql.shape[-1] * 4)
    hshifts = torch.arange(8, dtype=torch.int32, device=qh.device)
    hi = (qh.to(torch.int32)[..., None] >> hshifts) & 1
    hi = hi.reshape(*qh.shape[:-1], qh.shape[-1] * 8)
    return ((low | (hi << 2)) - 4).to(torch.int8)


def pack_scales6(sc: torch.Tensor) -> torch.Tensor:
    """Unsigned 6-bit codes (..., nsb, 16) -> (..., nsb, 12) bytes, four
    codes to three bytes, little-endian within each group."""
    s = sc.to(torch.int32).reshape(*sc.shape[:-1], 4, 4)
    word = s[..., 0] | (s[..., 1] << 6) | (s[..., 2] << 12) | (s[..., 3] << 18)
    packed = torch.stack([word & 0xFF, (word >> 8) & 0xFF,
                          (word >> 16) & 0xFF], dim=-1)
    return packed.reshape(*sc.shape[:-1], 12).to(torch.uint8)


def unpack_scales6(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_scales6``: (..., nsb, 12) -> (..., nsb, 16)."""
    p = packed.to(torch.int32).reshape(*packed.shape[:-1], 4, 3)
    word = p[..., 0] | (p[..., 1] << 8) | (p[..., 2] << 16)
    s = torch.stack([(word >> (6 * j)) & 0x3F for j in range(4)], dim=-1)
    return s.reshape(*packed.shape[:-1], 16).to(torch.uint8)


def approx_scale_codes(sc: torch.Tensor, scale_bits: int) -> torch.Tensor:
    """The paper's OP_CVT53 approximation: 6-bit codes -> ``scale_bits``
    (5 drops the LSB of the effective value ``sc - 32``)."""
    if scale_bits == 6:
        return sc
    if scale_bits == 5:
        eff = sc.to(torch.int32) - 32
        return (((eff >> 1) << 1) + 32).to(torch.uint8)
    raise ValueError(f"unsupported scale_bits={scale_bits}")


def quantize_q3_k(x: torch.Tensor, scale_bits: int = 6) -> Q3KTensor:
    _check_last_divisible(x, QK_K)
    lead = x.shape[:-1]
    xs = x.float().reshape(*lead, -1, N_SUB, Q3K_SUB)
    amax = xs.abs().amax(dim=-1)                             # (..., nsb, 16)
    d_sub = amax / 4.0
    d = d_sub.amax(dim=-1) / 31.0                            # (..., nsb)
    inv_d = torch.where(d > 0, 1.0 / d, torch.zeros_like(d))
    code = torch.round(d_sub * inv_d[..., None]).clamp(0, 31) + 32
    code = approx_scale_codes(code.to(torch.uint8), scale_bits)
    eff = d[..., None] * (code.float() - 32.0)
    inv_eff = torch.where(eff != 0, 1.0 / eff, torch.zeros_like(eff))
    q = torch.round(xs * inv_eff[..., None]).clamp(-4, 3)
    qu = (q + 4).to(torch.uint8).reshape(*lead, -1)
    ql, qh = pack_q3(qu)
    return Q3KTensor(ql=ql, qh=qh, scales=pack_scales6(code),
                     d=d.to(torch.float16), scale_bits=scale_bits)


def q3k_effective_scales(t: Q3KTensor) -> torch.Tensor:
    """Effective per-sub-block multiplier d*(sc-32): (..., K // 16)."""
    code = unpack_scales6(t.scales).float()
    eff = t.d.float()[..., None] * (code - 32.0)
    return eff.reshape(*t.d.shape[:-1], -1)


def dequantize_q3_k(t: Q3KTensor, dtype=torch.float32) -> torch.Tensor:
    q = unpack_q3(t.ql, t.qh).float()
    eff = q3k_effective_scales(t)
    w = _blocks(q, Q3K_SUB) * eff[..., None]
    return w.reshape(q.shape).to(dtype)


# ------------------------------------------------------------- helpers

_DENSE = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}


def quantize(x: torch.Tensor, fmt: str, **kw: Any):
    if fmt == "q8_0":
        return quantize_q8_0(x)
    if fmt == "q4_0":
        return quantize_q4_0(x)
    if fmt == "q3_k":
        return quantize_q3_k(x, **kw)
    if fmt in _DENSE:
        return x.to(_DENSE[fmt])
    raise ValueError(f"unknown format {fmt!r}")


def dequantize(t, dtype=torch.float32) -> torch.Tensor:
    if isinstance(t, Q8_0Tensor):
        return dequantize_q8_0(t, dtype)
    if isinstance(t, Q4_0Tensor):
        return dequantize_q4_0(t, dtype)
    if isinstance(t, Q3KTensor):
        return dequantize_q3_k(t, dtype)
    return t.to(dtype)
