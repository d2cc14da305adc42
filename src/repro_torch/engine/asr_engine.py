"""Streaming ASR engine over two paged pools (``repro.engine.asr_engine``).

The third modality behind :class:`repro_torch.engine.router.EngineRouter`:
an ``Engine``-protocol scheduler for Whisper-style transcription, built
like the LM ``serving.ContinuousBatcher`` with one more phase and one
more pool:

* **Streaming audio ingestion** — a
  :class:`~repro_torch.engine.api.TranscribeRequest` carries frame
  embeddings ``(encoder_seq, d_model)``; admission feeds them in
  ``audio_chunk``-frame *encode quanta*.  Each quantum writes the chunk
  into the slot's row of a persistent frame buffer on the device, re-runs
  the whole non-causal encoder over that row, and writes every decoder
  layer's cross K/V into the slot's cross blocks, so the last quantum
  leaves exactly the one-shot encoder KV (chunked = one-shot).
* **Paged cross-attention pool** — encoder KV lives in a second
  refcounted block pool of :class:`repro_torch.serving.kvcache.
  PagedKVRuntime` (``cross_len=encoder_seq``).  With ``audio_share=True``
  a finished encode publishes its chain under per-frame content
  fingerprints; a later request with the same audio adopts every block
  read-only and skips its encode (all or nothing: the encoder is
  non-causal, so a partial frame prefix has no reusable KV).
* **Decoder prefill** — decoder self-attention rides the ordinary paged
  pool; whisper's pure-attention decoder takes the fused chunk prefill
  (one paged flash-prefill launch plus one chunk-at-once cross read per
  layer per chunk) unless ``fused_prefill=False`` asks for the
  decode-step scan (``prefill_launches`` counts the difference).
* **No decoder prefix sharing** — decoder KV depends on the audio
  through the cross-attention residuals; audio sharing is the sound
  analogue.
* **Lifecycle and SLOs as the other engines** — EDF within fairness
  groups, cost-model rejection at submit and the queue sweep
  (``encode-chunk`` / ``prefill`` / ``decode-token`` keys), ``metrics=``,
  ``TokenDelta`` streaming, cancel and preempt releasing both pools,
  ``evacuate`` / ``adopt`` (re-admission re-adopts a published audio
  chain).  With ``cost_model=None, metrics=None`` a quantum never waits
  for the device; the engine reads it only for the next tokens.

``step()`` runs one quantum, encode first: a pending audio chunk, else a
pending prompt chunk, else one batched decode step.  The model programs
are plain functions over the cache, which they update in place.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Callable

import torch

from repro_torch import resolve_device, sync_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.core.tree import to_device
from repro_torch.engine import events as ev
from repro_torch.engine.api import TranscribeRequest
from repro_torch.engine.config import UNSET, EngineConfig, resolve
from repro_torch.models.transformer import (cache_slot_merge, cache_slot_reset,
                                            cache_slot_view, encoder_forward,
                                            init_cache, lm_decode_step,
                                            lm_prefill_chunk, prefill_path,
                                            write_cross_kv)
from repro_torch.serving.kvcache import PagedKVRuntime, cdiv


def audio_fingerprint(audio: Any) -> list[int]:
    """Per-frame content fingerprints of an audio embedding tensor: the
    cross pool's prefix-cache key chain (each frame's bytes hashed on the
    host; stable within a process, the cache's lifetime).  A bf16 tensor
    is hashed through its int16 bits; a CUDA tensor is copied to the host
    once."""
    t = torch.as_tensor(audio).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    a = t.numpy()
    return [hash(a[f].tobytes()) for f in range(a.shape[0])]


def make_asr_encode(cfg: ModelConfig):
    """One streaming encode quantum: write the frame chunk (1, n, d) into
    the slot's row of the frame buffer at frame ``f0``, re-run the whole
    non-causal encoder over that row, and write every layer's cross K/V
    into the slot's cross blocks ``cross_row`` (MBc,).  The last chunk
    leaves exactly the one-shot encoder KV; earlier chunks' writes are
    overwritten by the next quantum."""
    def encode(params, frames, f0: int, slot: int, cross_row, frame_buf,
               cache):
        n = frames.shape[1]
        frame_buf[slot, f0:f0 + n] = frames[0].to(frame_buf.dtype)
        enc_out = encoder_forward(params, cfg, frame_buf[slot:slot + 1])
        cache = write_cross_kv(params, cfg, enc_out, cross_row, cache)
        return frame_buf, cache
    return encode


def make_asr_prefill(cfg: ModelConfig, *, fused: bool = True):
    """Batch-1 chunked decoder prefill for one slot: self-attention KV
    through the slot's block-table row, cross attention through its
    cross-table row (the cross pools pass through the slot view).  Fused
    (one paged flash-prefill launch and one paged cross read per layer per
    chunk) or the decode-step scan."""
    def prefill(params, tokens, pos0, slot: int, block_row, cross_row, cache):
        local = cache_slot_view(cache, slot, paged_cross=True)
        logits, local = lm_prefill_chunk(params, cfg, tokens, pos0, local,
                                         block_tables=block_row,
                                         cross_tables=cross_row, fused=fused)
        cache = cache_slot_merge(cache, local, slot)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
    return prefill


def make_asr_decode(cfg: ModelConfig):
    """Greedy decode step at the fixed slot-batch shape: paged
    self-attention KV plus a paged cross-attention read per layer."""
    def step(params, tokens, positions, block_tables, cross_tables, cache):
        logits, cache = lm_decode_step(params, cfg, tokens, positions, cache,
                                       block_tables=block_tables,
                                       cross_tables=cross_tables)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
    return step


class AsrEngine(ev.EventStreamMixin):
    """Whisper-style encoder-decoder transcription engine.

    ``max_len`` is the per-request *decoder* capacity (prompt + max_new -
    1, size it with :meth:`required_len`); the encoder span is
    ``cfg.encoder_seq`` frames per request.  ``audio_share=True`` (the
    default) turns on the audio prefix cache.  ``decode_fn`` follows
    :func:`make_asr_decode`'s signature.  ``device`` holds the
    parameters, both pools and the frame buffer (the card unless the
    caller asks for the CPU); the scheduler's state stays on the host.
    ``clock`` is the SLO/event timebase.  Construction takes
    ``config=EngineConfig(asr=AsrEngineConfig(...))`` or the loose
    kwargs; explicit kwargs win over the config."""

    def __init__(self, params: Any, cfg: ModelConfig, *,
                 config: EngineConfig | None = None,
                 slots: int = UNSET, max_len: int = UNSET,
                 decode_fn: Callable | None = UNSET,
                 quantized_kv: bool = UNSET,
                 weight_quant: str | None = UNSET,
                 block_size: int = UNSET,
                 cross_block_size: int | None = UNSET,
                 audio_chunk: int = UNSET,
                 prefill_chunk: int = UNSET,
                 audio_share: bool = UNSET,
                 extra_blocks: int = UNSET,
                 fused_prefill: bool = UNSET,
                 bus: ev.EventBus | None = UNSET,
                 clock: Callable[[], float] = UNSET,
                 edf: bool = UNSET,
                 cost_model=UNSET, metrics=UNSET,
                 device="cuda"):
        self.config, asrc = resolve(config, "asr", dict(
            slots=slots, max_len=max_len, decode_fn=decode_fn,
            quantized_kv=quantized_kv, weight_quant=weight_quant,
            block_size=block_size, cross_block_size=cross_block_size,
            audio_chunk=audio_chunk, prefill_chunk=prefill_chunk,
            audio_share=audio_share, extra_blocks=extra_blocks,
            fused_prefill=fused_prefill, bus=bus, clock=clock, edf=edf,
            cost_model=cost_model, metrics=metrics))
        if asrc.max_len is None:
            raise ValueError("max_len is required (pass max_len= or "
                             "config.asr.max_len)")
        if not cfg.is_enc_dec:
            raise ValueError(
                f"AsrEngine needs an encoder-decoder config, got "
                f"{cfg.name} (is_enc_dec=False)")
        slots, block_size = asrc.slots, asrc.block_size
        weight_quant = self.config.weight_quant
        self.device = resolve_device(device)
        params = to_device(params, self.device)
        if weight_quant is not None:
            params = quantize_params(params, get_policy(weight_quant))
        self.weight_quant = weight_quant
        self.params = params
        self.cfg = cfg
        self.max_len = asrc.max_len
        self.prefill_chunk = max(1, asrc.prefill_chunk)
        self.audio_chunk = max(1, asrc.audio_chunk)
        self.audio_share = asrc.audio_share
        self.metrics = self.config.metrics     # None: no instrumentation
        cbs = asrc.cross_block_size or block_size
        cross_bps = cdiv(cfg.encoder_seq, cbs)
        self.runtime = PagedKVRuntime(
            slots, self.max_len, block_size, extra_blocks=asrc.extra_blocks,
            cross_len=cfg.encoder_seq, cross_block_size=cbs,
            # Headroom so published audio chains survive slot turnover
            # without blocking fresh admissions.
            cross_extra_blocks=(slots * cross_bps if self.audio_share else 0),
            cross_prefix_share=self.audio_share, metrics=self.metrics)
        self.cache = init_cache(
            params, cfg, slots, self.max_len, quantized_kv=asrc.quantized_kv,
            block_size=block_size, num_blocks=self.runtime.num_blocks,
            cross_block_size=cbs,
            cross_num_blocks=self.runtime.cross_num_blocks,
            device=self.device)
        # Per-slot streaming frame buffer: every encode quantum sees all
        # the frames ingested so far.
        self._frame_buf = torch.zeros((slots, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.bfloat16, device=self.device)
        # One source of truth with lm_prefill_chunk's dispatch: launch
        # accounting and cost-model keys describe the executed path.
        self.fused_prefill = prefill_path(
            cfg, quantized_kv=asrc.quantized_kv,
            fused=asrc.fused_prefill) == "fused"
        self.step_fn = asrc.decode_fn or make_asr_decode(cfg)
        self._prefill_raw = make_asr_prefill(cfg, fused=self.fused_prefill)
        self._encode_fn = make_asr_encode(cfg)
        self.slots: list[TranscribeRequest | None] = [None] * slots
        self._pending: list[list[int]] = [[] for _ in range(slots)]
        self._audio_left = [0] * slots     # frames still to ingest
        self._next_tok = [0] * slots
        self.finished: list[TranscribeRequest] = []
        self._groups: "OrderedDict[int, list]" = OrderedDict()
        self._rr: deque[int] = deque()
        self.bus = (self.config.bus if self.config.bus is not None
                    else ev.EventBus(self.config.clock))
        self.edf = self.config.edf
        self.quantized_kv = asrc.quantized_kv
        self.cost_model = self.config.cost_model  # None: no admission control
        self.rejections = 0
        self._cm_warm: set = set()
        self.preemptions = 0
        self._subseq = 0
        self.encode_quanta = 0
        self.prefill_quanta = 0
        self.decode_quanta = 0
        self.audio_hits = 0                # requests that skipped encode
        # Admission cost in model launches (one per fused chunk, one per
        # scanned token), as the LM batcher counts it.
        self.prefill_launches = 0
        self.last_quantum: tuple[str, int] | None = None

    # ------------------------------------------------------------ sizing
    @staticmethod
    def required_len(prompt_len: int, max_new: int) -> int:
        """Per-request decoder capacity: positions ``0 .. prompt_len +
        max_new - 2`` (the final token is emitted, never cached)."""
        return prompt_len + max_new - 1

    # --------------------------------------------------------------- API
    def submit(self, req: TranscribeRequest) -> ev.RequestHandle:
        if not req.prompt:
            raise ValueError(
                "TranscribeRequest needs a non-empty decoder prompt "
                "(Whisper task/language tags)")
        need = len(req.prompt) + req.max_new - 1
        if need > self.max_len:
            raise ValueError(
                f"prompt {len(req.prompt)} + max_new {req.max_new} needs "
                f"capacity {need} > per-request max_len={self.max_len}")
        shape = tuple(req.audio.shape)
        want = (self.cfg.encoder_seq, self.cfg.d_model)
        if shape != want:
            raise ValueError(f"audio shape {shape} != {want} "
                             f"(encoder_seq, d_model)")
        if (self.bus.terminal(req.rid) is not None
                or self.bus.admitted(req.rid)
                or any(r.rid == req.rid
                       for q in self._groups.values() for r in q)):
            raise ValueError(f"duplicate rid {req.rid}")
        req._seq = self._subseq
        self._subseq += 1
        req._deadline = (float("inf") if req.deadline_ms is None
                         else self.bus.clock() + req.deadline_ms / 1e3)
        if not req._feed:
            req._feed = list(req.prompt)
        if not req._audio_key:
            req._audio_key = audio_fingerprint(req.audio)
        if self.metrics is not None:
            self.metrics.request_submitted(req.rid, "asr", self.bus.clock())
        if self.cost_model is not None and req.deadline_ms is not None:
            est = self.cost_model.estimate_asr(self, req)
            if est is not None:
                # Charge the expected wait behind already-queued work.
                est += self.cost_model.queue_wait(self)
            budget = req.deadline_ms / 1e3
            if est is not None and est > budget:
                self.rejections += 1
                self.bus.emit(ev.Rejected, req.rid, estimated_s=est,
                              budget_s=budget, reason="infeasible")
                return self.handle(req.rid)
        self._enqueue(req)
        return self.handle(req.rid)

    def _enqueue(self, req: TranscribeRequest) -> None:
        if req.group not in self._groups:
            self._groups[req.group] = []
            self._rr.append(req.group)
        self._groups[req.group].append(req)

    @property
    def queue_len(self) -> int:
        return sum(len(q) for q in self._groups.values())

    def has_work(self) -> bool:
        return bool(self.queue_len) or any(s is not None for s in self.slots)

    def next_deadline(self) -> float:
        """Earliest deadline over queued and running requests (+inf if
        none declares one): the router's multiplex key."""
        cands = [r._deadline for q in self._groups.values() for r in q]
        cands += [r._deadline for r in self.slots if r is not None]
        return min(cands, default=float("inf"))

    def next_slack(self) -> float:
        """Least estimated slack (deadline - now - estimated remaining
        service) over queued and running requests; +inf when none
        declares a deadline."""
        cm = self.cost_model
        now = self.bus.clock()
        best = float("inf")
        for q in self._groups.values():
            for r in q:
                if r._deadline == float("inf"):
                    continue
                est = cm.estimate_asr(self, r) if cm else None
                best = min(best, r._deadline - now - (est or 0.0))
        for i, r in enumerate(self.slots):
            if r is None or r._deadline == float("inf"):
                continue
            est = cm.remaining_asr(self, i) if cm else None
            best = min(best, r._deadline - now - (est or 0.0))
        return best

    # ------------------------------------------- feasibility admission
    def _infeasible(self, req: TranscribeRequest,
                    now: float) -> tuple[bool, Any]:
        if req._deadline == float("inf"):
            return False, None
        est = self.cost_model.estimate_asr(self, req)
        if req._deadline < now:
            return True, est
        return (est is not None and now + est > req._deadline), est

    def _reject(self, req: TranscribeRequest, est, now: float) -> None:
        self.rejections += 1
        self.bus.emit(ev.Rejected, req.rid, estimated_s=est or 0.0,
                      budget_s=req._deadline - now,
                      reason="expired" if req._deadline < now
                      else "infeasible")

    def _sweep_infeasible(self) -> None:
        now = self.bus.clock()
        for q in self._groups.values():
            keep = []
            for r in q:
                hopeless, est = self._infeasible(r, now)
                if hopeless:
                    self._reject(r, est, now)
                else:
                    keep.append(r)
            q[:] = keep

    def _edf_key(self, req: TranscribeRequest) -> tuple:
        if not self.edf:
            return (req._seq,)
        expired = req._deadline < self.bus.clock()
        return (expired, req._deadline, -req.priority, req._seq)

    def _pop_round_robin(self) -> TranscribeRequest | None:
        while self._rr:
            gid = self._rr[0]
            if not self._groups[gid]:
                self._rr.popleft()
                del self._groups[gid]
                continue
            self._rr.rotate(-1)
            q = self._groups[gid]
            best = min(range(len(q)), key=lambda i: self._edf_key(q[i]))
            return q.pop(best)
        return None

    def _requeue_front(self, req: TranscribeRequest) -> None:
        self._groups[req.group].insert(0, req)
        self._rr.rotate(1)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue_len:
                continue
            while True:
                req = self._pop_round_robin()
                if req is None or self.cost_model is None:
                    break
                now = self.bus.clock()
                hopeless, est = self._infeasible(req, now)
                if not hopeless:
                    break
                self._reject(req, est, now)
            if req is None:
                break
            remaining = req.max_new - len(req.out)
            reused = self.runtime.admit(i, req._feed, remaining)
            if reused is None:           # decoder pool pressure
                self._requeue_front(req)
                break
            adopted = self.runtime.admit_cross(i, req._audio_key)
            if adopted is None:          # cross pool full: roll back
                self.runtime.release(i)
                self._requeue_front(req)
                break
            self.slots[i] = req
            self._pending[i] = list(req._feed[reused:])
            if adopted:
                self._audio_left[i] = 0  # the whole chain is shared
                self.audio_hits += 1
            else:
                self._audio_left[i] = self.cfg.encoder_seq
            self.cache = cache_slot_reset(self.cache, i)
            if self.bus.admitted(req.rid):   # back from preemption
                self.bus.emit(ev.Progress, req.rid, phase="resume",
                              step=len(req.out), total=req.max_new)
            else:
                self.bus.emit(ev.Admitted, req.rid, slot=i)

    def _free_slot(self, i: int) -> None:
        """Return both pools' blocks of slot ``i`` and empty it."""
        self.runtime.release(i)
        self.runtime.release_cross(i)
        self.slots[i] = None
        self._pending[i] = []
        self._audio_left[i] = 0

    def _preempt_slot(self, i: int, reason: str) -> None:
        req = self.slots[i]
        self._free_slot(i)
        # Resume re-ingests prompt + generated-so-far; a published audio
        # chain is re-adopted at re-admission (encode skipped).
        req._feed = list(req.prompt) + list(req.out)
        self.preemptions += 1
        self.bus.emit(ev.Preempted, req.rid, reason=reason)
        self._enqueue(req)

    def preempt(self, rid: int, reason: str = "explicit") -> bool:
        """Evict a running request back to the wait queue (both pools
        released); True if ``rid`` held a slot."""
        for i, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                self._preempt_slot(i, reason)
                return True
        return False

    # ------------------------------------------- fleet migration hooks
    def evacuate(self, reason: str = "evacuate") -> list:
        """Preempt every running request and pop every queued one;
        returns them in arrival order with no terminal events, for an
        engine on the same bus to ``adopt()``."""
        for i, r in enumerate(self.slots):
            if r is not None:
                self._preempt_slot(i, reason)
        out = [r for q in self._groups.values() for r in q]
        self._groups.clear()
        self._rr.clear()
        out.sort(key=lambda r: r._seq)
        return out

    def adopt(self, req: TranscribeRequest) -> ev.RequestHandle:
        """Admit a request evacuated from another engine on the same bus:
        no duplicate-rid guard, no submit-time rejection, the original
        absolute deadline.  This engine re-encodes the audio (its cross
        pool has no chain for it), which gives the same KV: the encode is
        a pure function of the audio."""
        need = len(req.prompt) + req.max_new - 1
        if need > self.max_len:
            raise ValueError(
                f"adopted rid {req.rid} needs capacity {need} > "
                f"per-request max_len={self.max_len}")
        req._feed = list(req.prompt) + list(req.out)
        if not req._audio_key:
            req._audio_key = audio_fingerprint(req.audio)
        req._seq = self._subseq
        self._subseq += 1
        self._enqueue(req)
        return self.handle(req.rid)

    def cancel(self, rid: int) -> bool:
        """Abort a request wherever it is; a running one frees its slot and
        both pools' blocks at once; emits ``Cancelled``."""
        for q in self._groups.values():
            for r in q:
                if r.rid == rid:
                    q.remove(r)
                    self.bus.emit(ev.Cancelled, rid)
                    return True
        for i, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                self._free_slot(i)
                self.runtime.check_consistency()
                self.bus.emit(ev.Cancelled, rid)
                return True
        return False

    # ------------------------------------------------------- scheduling
    def step(self) -> int:
        """One scheduling quantum, encode first: a pending audio chunk,
        else a pending prompt chunk, else one batched decode step; returns
        the number of requests progressed."""
        if self.cost_model is not None and self.queue_len:
            self._sweep_infeasible()
        self._admit()
        self._obs_sched()
        for i, req in enumerate(self.slots):
            if req is not None and self._audio_left[i]:
                return self._encode_quantum(i)
        for i, req in enumerate(self.slots):
            if req is not None and self._pending[i]:
                return self._prefill_quantum(i)
        return self._decode_quantum()

    def _obs_quantum(self, kind: str, t0: float, rids: list,
                     args: dict | None = None) -> None:
        """Phase telemetry (histogram and span), every quantum."""
        if self.metrics is None:
            return
        sync_device(self.device)
        self.metrics.phase("asr", kind, t0, self.bus.clock(),
                           rids=rids, args=args)

    def _obs_sched(self) -> None:
        if self.metrics is None:
            return
        self.metrics.gauge(
            "engine_queue_depth", "queued requests by engine",
            labels=("engine",)).set(self.queue_len, engine="asr")
        self.metrics.gauge(
            "asr_slots_active", "occupied transcription slots").set(
            sum(1 for s in self.slots if s is not None))

    def _observe_quantum(self, key: tuple, shape: tuple, t0: float) -> None:
        """Feed one quantum's duration to the cost model, skipping the
        first quantum of each ``shape``; waits for the device first."""
        if self.cost_model is None:
            return
        if shape not in self._cm_warm:
            self._cm_warm.add(shape)
            return
        sync_device(self.device)
        self.cost_model.observe(key, self.bus.clock() - t0)

    def _encode_quantum(self, i: int) -> int:
        t0 = self.bus.clock()
        req = self.slots[i]
        se = self.cfg.encoder_seq
        cursor = se - self._audio_left[i]
        n = min(self.audio_chunk, self._audio_left[i])
        frames = torch.as_tensor(req.audio)[None, cursor:cursor + n]
        dev = self.device
        self._frame_buf, self.cache = self._encode_fn(
            self.params, frames.to(dev), cursor, i,
            torch.tensor(self.runtime.cross_tables[i], dtype=torch.int32,
                         device=dev),
            self._frame_buf, self.cache)
        self._audio_left[i] -= n
        req.encode_steps += 1
        self.encode_quanta += 1
        self.last_quantum = ("encode", 1)
        if self.cost_model is not None:
            self._observe_quantum(self.cost_model.asr_keys(self)[0],
                                  ("encode", n), t0)
        self._obs_quantum("encode", t0, [req.rid],
                          args={"frames": n, "slot": i,
                                "weight_quant": self.weight_quant})
        self.bus.emit(ev.Progress, req.rid, phase="encode",
                      step=cursor + n, total=se)
        if self._audio_left[i] == 0 and self.audio_share:
            # Publish at encode completion, not at retirement: concurrent
            # requests with the same audio share at once.
            self.runtime.publish_cross(i, req._audio_key)
        return 1

    def _prefill_quantum(self, i: int) -> int:
        t0 = self.bus.clock()
        req = self.slots[i]
        chunk = self._pending[i][:self.prefill_chunk]
        del self._pending[i][:len(chunk)]
        pos = self.runtime.pos[i]
        bs = self.runtime.block_size
        for bi in range(pos // bs, cdiv(pos + len(chunk), bs)):
            self.runtime.ensure_writable(i, bi * bs)
        dev = self.device
        nxt, self.cache = self._prefill_raw(
            self.params,
            torch.tensor([chunk], dtype=torch.int64, device=dev),
            torch.full((1,), pos, dtype=torch.int32),
            i,
            torch.tensor([self.runtime.tables[i]], dtype=torch.int32,
                         device=dev),
            torch.tensor([self.runtime.cross_tables[i]], dtype=torch.int32,
                         device=dev),
            self.cache)
        self.runtime.pos[i] = pos + len(chunk)
        req.prefill_steps += 1
        self.prefill_quanta += 1
        self.prefill_launches += 1 if self.fused_prefill else len(chunk)
        self.last_quantum = ("prefill", 1)
        if self.cost_model is not None:
            self._observe_quantum(self.cost_model.asr_keys(self)[1],
                                  ("prefill", len(chunk)), t0)
        self._obs_quantum("prefill", t0, [req.rid],
                          args={"tokens": len(chunk), "slot": i,
                                "fused": self.fused_prefill,
                                "quantized_kv": self.quantized_kv,
                                "weight_quant": self.weight_quant})
        self.bus.emit(ev.Progress, req.rid, phase="prefill",
                      step=len(req._feed) - len(self._pending[i]),
                      total=len(req._feed))
        if not self._pending[i]:        # feed done: next token is out
            tok = int(nxt[0])
            req.out.append(tok)
            self.bus.emit(ev.TokenDelta, req.rid, token=tok,
                          pos=len(req.out) - 1)
            self._next_tok[i] = tok
            self._maybe_retire(i)
        return 1

    def _decode_quantum(self) -> int:
        t0 = self.bus.clock()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            self.last_quantum = None
            return 0
        for i in active:
            self.runtime.ensure_writable(i, self.runtime.pos[i])
        dev = self.device
        nxt, self.cache = self.step_fn(
            self.params,
            torch.tensor(self._next_tok, dtype=torch.int64, device=dev)[:, None],
            torch.tensor(self.runtime.pos, dtype=torch.int32, device=dev),
            torch.tensor(self.runtime.tables, dtype=torch.int32, device=dev),
            torch.tensor(self.runtime.cross_tables, dtype=torch.int32,
                         device=dev),
            self.cache)
        self.decode_quanta += 1
        self.last_quantum = ("decode", len(active))
        nxt_host = nxt.tolist()
        if self.cost_model is not None:
            self._observe_quantum(self.cost_model.asr_keys(self)[2],
                                  ("decode",), t0)
        self._obs_quantum("decode", t0,
                          [self.slots[i].rid for i in active],
                          args={"batch": len(active),
                                "quantized_kv": self.quantized_kv,
                                "weight_quant": self.weight_quant})
        for i in active:
            req = self.slots[i]
            self.runtime.pos[i] += 1    # the fed token is now cached
            tok = int(nxt_host[i])
            req.out.append(tok)
            req.decode_steps += 1
            self.bus.emit(ev.TokenDelta, req.rid, token=tok,
                          pos=len(req.out) - 1)
            self._next_tok[i] = tok
            self._maybe_retire(i)
        return len(active)

    def _maybe_retire(self, i: int) -> None:
        req = self.slots[i]
        over = len(req.out) >= req.max_new
        hit_eos = req.eos is not None and req.out and req.out[-1] == req.eos
        trunc = self.runtime.pos[i] >= self.max_len
        if over or hit_eos or trunc:
            req.done = True
            self.finished.append(req)
            # No decoder-prompt donation (its KV depends on the audio); a
            # shared audio chain already lives in the cross prefix cache.
            self.runtime.release(i)
            self.runtime.release_cross(i)
            self.slots[i] = None
            self._pending[i] = []
            self.bus.emit(ev.Finished, req.rid, result=req)

    def run(self, max_steps: int = 10_000) -> list[TranscribeRequest]:
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return list(self.finished)   # snapshot: later runs keep appending
