"""Request-based generation API (``repro.engine.api``): the typed
text-to-image and transcription requests, the image result, and the
structural ``Engine`` protocol that ``DiffusionEngine``,
``ContinuousBatcher``, ``AsrEngine`` and ``EngineRouter`` satisfy without
a common base.  The LM request lives in ``serving.scheduler``."""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, Sequence, runtime_checkable

import torch


def default_sampler(steps: int) -> str:
    """Paper default: SD-Turbo for single-step, DDIM otherwise."""
    return "turbo" if steps == 1 else "ddim"


def uses_cfg(neg_tokens, guidance_scale: float) -> bool:
    """Whether classifier-free guidance changes the output."""
    return neg_tokens is not None or guidance_scale != 1.0


def is_transcribe(request: Any) -> bool:
    """Whether ``request`` is an ASR :class:`TranscribeRequest`: routers
    and fleets send it to their ASR engine, and raise when they have
    none."""
    return isinstance(request, TranscribeRequest)


@dataclasses.dataclass
class GenerateRequest:
    """One text-to-image request.  ``tokens``/``neg_tokens`` are prompt ids
    of length ``cfg.text_len``; ``guidance_scale`` weights CFG
    (``eps_u + scale * (eps_c - eps_u)``; 1.0 with no negative prompt
    disables the unconditional branch); ``seed`` alone determines the
    initial noise.  ``deadline_ms``/``priority`` feed EDF admission.
    ``preview_every`` > 0 streams a ``PreviewLatent`` every N steps (and at
    the last) through the segmented path; ``preview_decode`` makes those
    previews VAE-decoded pixels."""
    rid: int
    tokens: Sequence[int] | torch.Tensor
    neg_tokens: Sequence[int] | torch.Tensor | None = None
    guidance_scale: float = 1.0
    sampler: str = "turbo"
    steps: int = 1
    seed: int = 0
    latent_hw: int | None = None
    preview_every: int = 0
    preview_decode: bool = False
    deadline_ms: float | None = None
    priority: int = 0
    _deadline: float = dataclasses.field(default=float("inf"), repr=False)


@dataclasses.dataclass
class TranscribeRequest:
    """One streaming speech-transcription request.  ``audio`` is the
    frame-embedding tensor ``(cfg.encoder_seq, cfg.d_model)`` that the
    stub frontend would produce (``models.frontend``); the engine ingests
    it in ``audio_chunk``-frame quanta.  ``prompt`` is the decoder's token
    prefix (Whisper's language/task tags); the transcript accumulates in
    ``out`` and the request is its own ``Finished`` result, like the LM
    path's ``serving.scheduler.Request``.  ``group`` co-schedules
    round-robin; ``deadline_ms``/``priority`` feed EDF and cost-model
    admission; ``encode_steps``/``prefill_steps``/``decode_steps`` count
    the quanta the request consumed, per phase."""
    rid: int
    audio: Any                       # (encoder_seq, d_model) tensor
    prompt: Sequence[int] = ()
    max_new: int = 16
    eos: int | None = None
    group: int = 0
    deadline_ms: float | None = None
    priority: int = 0
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    encode_steps: int = 0
    prefill_steps: int = 0
    decode_steps: int = 0
    _seq: int = dataclasses.field(default=0, repr=False)
    _deadline: float = dataclasses.field(default=float("inf"), repr=False)
    # Tokens still to ingest: the prompt at first admission, prompt + out
    # after a preemption (as ``serving.Request._feed``).
    _feed: list = dataclasses.field(default_factory=list, repr=False)
    # Per-frame content fingerprints of ``audio`` (computed once, at
    # submit): the cross pool's prefix-cache key chain.
    _audio_key: list = dataclasses.field(default_factory=list, repr=False)


@dataclasses.dataclass
class GenerateResult:
    """Finished request: decoded image plus the settings that made it."""
    rid: int
    image: torch.Tensor             # (H, W, 3) in [-1, 1]
    sampler: str
    steps: int
    seed: int
    prefill_steps: int = 0
    decode_steps: int = 0


@runtime_checkable
class Engine(Protocol):
    """Structural protocol every serving engine implements."""

    def submit(self, request: Any) -> Any:
        """Enqueue a request (admission happens inside ``step``);
        returns a :class:`repro_torch.engine.events.RequestHandle`."""
        ...

    def step(self) -> int:
        """Advance one scheduling quantum; return #requests progressed."""
        ...

    def stream(self, max_steps: int = 100_000) -> Any:
        """Generator: step the engine, yielding typed lifecycle events
        in emission order, until it idles."""
        ...

    def cancel(self, rid: int) -> bool:
        """Abort a request (queued or running) and free its state;
        True if the rid was live."""
        ...

    def has_work(self) -> bool:
        """Whether any request is queued or in flight."""
        ...

    def run(self, max_steps: int = 10_000) -> list:
        """Drive ``step`` until the queue drains; return finished items
        (drain-the-stream compatibility wrapper)."""
        ...
