"""Analytic per-dtype dot-product accounting (the paper's Table I).

The paper profiles stable-diffusion.cpp and splits dot-product execution
time by data type (F32 / F16 / Q3_K / Q8_0).  This reproduces it by
enumerating every matmul of a model graph with its role (the sites
:func:`repro_torch.core.qlinear.set_recorder` sees), applying an
:class:`~repro_torch.core.policy.OffloadPolicy` to assign formats as
GGML model files do, and costing each op on a device model.  A copy of
``repro.core.accounting`` over the port's policy and ``quant.BPW``.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable

from repro_torch.core.policy import OffloadPolicy
from repro_torch.core.quant import BPW


@dataclasses.dataclass(frozen=True)
class MatmulOp:
    """One dot-product site: y[m,n] += x[m,k] * w[n,k], executed `count` times."""
    name: str
    role: str          # policy role, or "activation" for act-act matmuls
    m: int
    n: int
    k: int
    count: int = 1
    # activation-activation matmuls (attention score/PV) have no weight
    # tensor; GGML runs them in F16 — they are never offloaded.
    act_act: bool = False

    @property
    def flops(self) -> int:
        return 2 * self.m * self.n * self.k * self.count

    def weight_bytes(self, fmt: str) -> float:
        if self.act_act:
            return 0.0
        return self.n * self.k * BPW[fmt] / 8.0 * self.count

    def act_bytes(self, act_bits: int = 16) -> float:
        return (self.m * self.k + self.m * self.n) * act_bits / 8.0 * self.count


def assign_formats(ops: Iterable[MatmulOp], policy: OffloadPolicy,
                   act_fmt: str = "f32") -> list[tuple[MatmulOp, str]]:
    """GGML-style dtype assignment.

    Activation-activation matmuls take ``act_fmt`` (GGML's act-act
    mul_mat runs in F32).  Weight matmuls take the policy's format; a K
    not divisible by the format's block falls back to F16, and f32-pinned
    roles stay F32: this is what produces the paper's F32/F16 residue.
    """
    out = []
    for op in ops:
        if op.act_act:
            out.append((op, act_fmt))
            continue
        fmt = policy.format_for(op.role)
        block = {"q3_k": 256, "q8_0": 32, "q4_0": 32}.get(fmt, 1)
        if op.k % block:
            fmt = "f16" if fmt.startswith("q") else fmt
        out.append((op, fmt))
    return out


def time_by_format(assigned: list[tuple[MatmulOp, str]],
                   device) -> dict[str, float]:
    """Sum modeled execution seconds per format on a device model (any
    object with ``matmul_time(op, fmt)``)."""
    acc: dict[str, float] = defaultdict(float)
    for op, fmt in assigned:
        acc[fmt] += device.matmul_time(op, fmt)
    return dict(acc)


def fractions(times: dict[str, float]) -> dict[str, float]:
    tot = sum(times.values()) or 1.0
    return {k: v / tot for k, v in times.items()}


def flops_by_format(assigned: list[tuple[MatmulOp, str]]) -> dict[str, float]:
    acc: dict[str, float] = defaultdict(float)
    for op, fmt in assigned:
        acc[fmt] += op.flops
    return dict(acc)
