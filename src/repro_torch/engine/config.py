"""Unified engine configuration (the port's copy of ``repro.engine.config``).

Every engine takes the same two groups of knobs:

* **shared** knobs that mean the same thing everywhere: ``bus``, ``clock``,
  ``cost_model``, ``metrics``, ``edf``, ``weight_quant``;
* **per-engine** knobs (block sizes, prefill chunking, speculation, ...).

``EngineConfig`` packages both: the shared knobs live at the top level and
each engine reads its own section (``lm`` / ``asr`` / ``diffusion``).
Explicit constructor kwargs win over the matching config field, so

    ContinuousBatcher(params, cfg, slots=4, max_len=128, device="cpu")
    ContinuousBatcher(params, cfg, config=EngineConfig(
        lm=LMEngineConfig(slots=4, max_len=128)), device="cpu")

build the same engine.  New knobs (``spec_decode``) exist only on the
config.  ``device`` and ``noise_fn`` are constructor kwargs of the port's
engines, not config fields: the reference has no such fields.

This module imports nothing but the standard library; ``build_engine``
imports the engines at call time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional


class _Unset:
    """Sentinel distinguishing 'kwarg not passed' from 'passed None'."""

    _instance: Optional["_Unset"] = None

    def __new__(cls) -> "_Unset":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "<unset>"

    def __bool__(self) -> bool:
        return False


UNSET: Any = _Unset()


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    """Draft-model speculative decoding (LM engine only).

    A small draft model proposes ``k`` tokens per slot per decode quantum;
    the target verifies the whole proposal in one paged-prefill launch and
    the rejected tail rolls back as a block-table/position truncation.
    Greedy acceptance gives the plain decode's tokens.

    ``draft_params``/``draft_cfg`` must share the target's vocabulary and
    the draft must be a pure-attention decoder.  ``draft_step_fn``
    optionally replaces the draft's batched decode step (with
    ``make_paged_decode``'s signature), e.g. an adversarial draft;
    ``draft_fused_prefill=False`` ingests the draft's prompt by its
    decode-step scan.
    """

    draft_params: Any
    draft_cfg: Any
    k: int = 4
    draft_step_fn: Optional[Callable] = None
    draft_fused_prefill: bool = True


@dataclasses.dataclass(frozen=True)
class LMEngineConfig:
    """Section consumed by ``serving.scheduler.ContinuousBatcher``.  The
    reference's ``enc_embeds`` is left out until encoder inputs are
    ported (ROADMAP section 1, the enc-dec item)."""

    slots: int = 4
    max_len: Optional[int] = None
    decode_fn: Optional[Callable] = None
    quantized_kv: bool = False
    block_size: int = 16
    prefill_chunk: int = 8
    prefix_share: bool = False
    extra_blocks: int = 0
    fused_prefill: bool = True
    preempt_over_budget: bool = False
    spec_decode: Optional[SpecDecodeConfig] = None


@dataclasses.dataclass(frozen=True)
class AsrEngineConfig:
    """Section of the ASR engine (not ported yet; kept so one config
    describes every engine, as in the reference)."""

    slots: int = 4
    max_len: Optional[int] = None
    decode_fn: Optional[Callable] = None
    quantized_kv: bool = False
    block_size: int = 16
    cross_block_size: Optional[int] = None
    audio_chunk: int = 16
    prefill_chunk: int = 8
    audio_share: bool = True
    extra_blocks: int = 0
    fused_prefill: bool = True


@dataclasses.dataclass(frozen=True)
class DiffusionEngineConfig:
    """Section consumed by ``engine.diffusion_engine.DiffusionEngine``."""

    max_batch: int = 1


_SHARED_FIELDS = ("bus", "clock", "cost_model", "metrics", "edf",
                  "weight_quant")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """One object describing how to run any engine."""

    bus: Any = None
    clock: Callable[[], float] = time.monotonic
    cost_model: Any = None
    metrics: Any = None
    edf: bool = True
    weight_quant: Optional[str] = None
    lm: LMEngineConfig = dataclasses.field(default_factory=LMEngineConfig)
    asr: AsrEngineConfig = dataclasses.field(default_factory=AsrEngineConfig)
    diffusion: DiffusionEngineConfig = dataclasses.field(
        default_factory=DiffusionEngineConfig)


def resolve(config: Optional[EngineConfig], section: str,
            overrides: dict) -> tuple:
    """Merge constructor kwargs onto an ``EngineConfig``.

    ``overrides`` maps kwarg name -> value, where ``UNSET`` marks kwargs the
    caller did not pass.  Passed kwargs win over config fields.  Returns
    the merged ``(EngineConfig, section_config)`` pair; neither input is
    mutated.
    """
    cfg = config if config is not None else EngineConfig()
    shared = {k: v for k, v in overrides.items()
              if k in _SHARED_FIELDS and v is not UNSET}
    sec = getattr(cfg, section)
    sec_names = {f.name for f in dataclasses.fields(type(sec))}
    local = {k: v for k, v in overrides.items()
             if k in sec_names and v is not UNSET}
    unknown = [k for k, v in overrides.items()
               if v is not UNSET and k not in _SHARED_FIELDS
               and k not in sec_names]
    if unknown:
        raise TypeError(f"unknown engine kwargs for section {section!r}: "
                        f"{sorted(unknown)}")
    sec = dataclasses.replace(sec, **local)
    cfg = dataclasses.replace(cfg, **shared, **{section: sec})
    return cfg, sec


def build_engine(kind: str, params: Any, model_cfg: Any,
                 config: Optional[EngineConfig] = None, **kwargs):
    """Construct an engine of ``kind`` ("lm" | "asr" | "diffusion").
    ``kwargs`` go to the constructor as they are (``device``,
    ``noise_fn``)."""
    config = config if config is not None else EngineConfig()
    if kind == "lm":
        from repro_torch.serving.scheduler import ContinuousBatcher
        return ContinuousBatcher(params, model_cfg, config=config, **kwargs)
    if kind == "asr":
        raise NotImplementedError(
            "the ASR engine is not ported yet (ROADMAP section 1)")
    if kind == "diffusion":
        from repro_torch.engine.diffusion_engine import DiffusionEngine
        return DiffusionEngine(params, model_cfg, config=config, **kwargs)
    raise ValueError(f"unknown engine kind {kind!r} "
                     "(expected 'lm', 'asr' or 'diffusion')")
