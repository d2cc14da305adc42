"""Typed terminal results for :meth:`RequestHandle.result` (a copy of
``repro.engine.results``).

Before PR 10, ``handle.result()`` returned the raw ``Finished`` payload for
successful requests and ``None`` for everything else — callers had to know
that ``None`` could mean "cancelled", "rejected" *or* "bus already
evicted the terminal", and had to duck-type the payload per modality.

Now every terminal maps to a :class:`TerminalResult` with a common
``outcome``/``stats`` shape, specialised per modality:

* LM generate      -> :class:`LMResult` (``prompt``/``tokens``)
* ASR transcribe   -> :class:`TranscriptResult` (``prompt``/``transcript``)
* diffusion        -> :class:`ImageResult` (``image`` + the full
  ``GenerateResult`` under ``generate``)
* cancelled/rejected -> plain :class:`TerminalResult` with the outcome set
  (and the scheduler's reason string for rejections).

``result()`` only returns ``None`` when no terminal event is observable at
all.  Like ``events.py``, this module is pure host Python — importing it
must never pull in a tensor library, so it stays safe for control planes that only
route events.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

OUTCOME_FINISHED = "finished"
OUTCOME_CANCELLED = "cancelled"
OUTCOME_REJECTED = "rejected"


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """Per-request work accounting, uniform across modalities.

    ``proposed``/``accepted`` are speculative-decoding counters (0 unless
    the LM engine ran with ``SpecDecodeConfig``): draft tokens offered to
    the verifier vs. draft tokens the target model accepted.
    """

    prefill_steps: int = 0
    decode_steps: int = 0
    encode_steps: int = 0
    proposed: int = 0
    accepted: int = 0


@dataclasses.dataclass(frozen=True)
class TerminalResult:
    """Common shape of every terminal: what happened and how much work."""

    rid: int
    outcome: str
    stats: RequestStats = dataclasses.field(default_factory=RequestStats)
    reason: str = ""

    @property
    def finished(self) -> bool:
        return self.outcome == OUTCOME_FINISHED


@dataclasses.dataclass(frozen=True)
class LMResult(TerminalResult):
    """LM completion: the prompt and the generated token ids."""

    prompt: Tuple[int, ...] = ()
    tokens: Tuple[int, ...] = ()
    request: Any = None


@dataclasses.dataclass(frozen=True)
class TranscriptResult(TerminalResult):
    """ASR completion: decoder prompt and emitted transcript token ids."""

    prompt: Tuple[int, ...] = ()
    transcript: Tuple[int, ...] = ()
    request: Any = None


@dataclasses.dataclass(frozen=True)
class ImageResult(TerminalResult):
    """Diffusion completion: the decoded image plus the full payload."""

    image: Any = None
    generate: Any = None


def _stats_of(payload: Any) -> RequestStats:
    return RequestStats(
        prefill_steps=int(getattr(payload, "prefill_steps", 0) or 0),
        decode_steps=int(getattr(payload, "decode_steps", 0) or 0),
        encode_steps=int(getattr(payload, "encode_steps", 0) or 0),
        proposed=int(getattr(payload, "proposed", 0) or 0),
        accepted=int(getattr(payload, "accepted", 0) or 0),
    )


def from_terminal(rid: int, outcome: str, payload: Any = None,
                  reason: str = "") -> TerminalResult:
    """Build the typed result for a terminal event.

    ``payload`` is the ``Finished.result`` object (a scheduler ``Request``,
    ASR request, or diffusion ``GenerateResult``); modality is duck-typed
    the same way the event bus does it: images have ``.image``, transcribe
    requests have ``.audio``, everything else with a token stream is LM.
    """
    if payload is None:
        return TerminalResult(rid=rid, outcome=outcome, reason=reason)
    stats = _stats_of(payload)
    if hasattr(payload, "image"):
        return ImageResult(rid=rid, outcome=outcome, stats=stats,
                           reason=reason, image=payload.image,
                           generate=payload)
    prompt = tuple(getattr(payload, "prompt", ()) or ())
    out = tuple(getattr(payload, "out", ()) or ())
    if hasattr(payload, "audio"):
        return TranscriptResult(rid=rid, outcome=outcome, stats=stats,
                                reason=reason, prompt=prompt,
                                transcript=out, request=payload)
    return LMResult(rid=rid, outcome=outcome, stats=stats, reason=reason,
                    prompt=prompt, tokens=out, request=payload)
