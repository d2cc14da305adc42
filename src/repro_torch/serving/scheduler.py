"""Continuous-batching LM serving scheduler over the paged KV runtime
(``repro.serving.scheduler``).

Python request plumbing around the model programs, with the cache
bookkeeping in :class:`repro_torch.serving.kvcache.PagedKVRuntime`:

* **Chunked prefill** — admission feeds the prompt in chunks at batch 1
  (``models.transformer.lm_prefill_chunk``).  By default each chunk is
  one fused paged flash-prefill kernel per layer (bf16 or Q8_0 pools);
  ``fused_prefill=False`` runs the decode-step scan instead.  The last
  chunk's logits emit the first generated token.
* **Decode quanta** — one greedy step at the fixed slot-batch shape
  (``decode_fn`` replaces it); idle rows point their table at the null
  block and are never emitted.
* **Speculative decoding** (``config.lm.spec_decode``) — a draft model
  with its own paged pool proposes up to ``k`` tokens per slot in
  batched decode steps; the target verifies each slot's pending token
  plus proposal in one chunk launch (``make_verify_chunk``), keeps the
  longest greedy-agreeing prefix plus one bonus token, and rolls the
  rejected tail back with ``PagedKVRuntime.truncate``.  Each draft step's
  tokens and each verify's greedy row come to the host with one
  ``.cpu()`` each (``host_reads``).
* **Prefix reuse** (``prefix_share=True``) — retiring requests donate
  their full prompt blocks; a later request with the same prefix adopts
  them read-only and skips their chunks.  The copy-on-write hook copies
  a block in place on the device.
* **Fairness** — round-robin across request ``group`` ids, earliest
  deadline first within a group (``edf=False``: arrival order).
* **Streaming lifecycle** — ``Admitted``, ``Progress(prefill)`` per
  chunk, ``TokenDelta`` per token, ``Finished``; ``cancel()`` and
  ``preempt()`` (re-ingest prompt + generated tokens on resume).
* **Feasibility admission (``cost_model=``)** — ``submit()`` rejects a
  request whose estimated service time (prefill chunks + decode tokens,
  plus the wait behind queued work) exceeds its budget, each ``step()``
  sweeps queued requests that expired or became infeasible, the pop in
  ``_admit`` re-checks, and every quantum but the first of each shape
  refines the EWMA.  ``preempt_over_budget`` evicts the decode most
  over its deadline while a feasible request waits: after the fact
  without a cost model, predicted with one.
* **Migration** — ``evacuate()`` preempts every running request and
  returns them with the queue; ``adopt()`` on another batcher on the
  same bus re-ingests prompt + generated tokens and resumes with
  ``Progress(phase="resume")``.  ``next_deadline``/``next_slack`` are
  the router's multiplex keys.
* **Telemetry (``metrics=``)** — a phase histogram and span per quantum,
  queue and slot gauges, the KV pool's gauges, speculation counters.
  With a cost model or metrics attached an observed quantum waits for
  the device (``torch.cuda.synchronize`` on a card) before it reads the
  clock; with neither, ``step()`` adds no host sync.

``step()`` runs one quantum — pending prompt chunks first (the draft's
chunks ride the same quantum), otherwise one batched decode step or one
speculative round — and counts it in ``prefill_quanta`` /
``decode_quanta``; ``prefill_launches`` / ``decode_launches`` count the
target's model programs (one per fused chunk or verify, one per scanned
token, one per decode quantum) and ``draft_launches`` the draft's.

Construction takes ``config=EngineConfig(lm=LMEngineConfig(...))`` or
the loose kwargs; explicit kwargs win over the config.  An
encoder-decoder model takes ``enc_embeds`` (slots, S_enc, d): the encoder
runs once at construction into contiguous cross rows, one per slot (the
streaming path with a paged cross pool is ``engine.asr_engine``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Callable

import torch

from repro_torch import resolve_device, sync_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.core.tree import to_device
from repro_torch.engine import events as ev
from repro_torch.engine.config import UNSET, EngineConfig, resolve
from repro_torch.models.transformer import (cache_slot_merge, cache_slot_reset,
                                            cache_slot_view, init_cache,
                                            lm_decode_step, lm_prefill_chunk,
                                            lm_verify_chunk, prefill_path)
from repro_torch.serving.kvcache import NULL_BLOCK, PagedKVRuntime, cdiv

DEFAULT_BLOCK = 16


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    eos: int | None = None
    group: int = 0                # fairness class (tenant / priority bin)
    deadline_ms: float | None = None  # SLO budget from submission (EDF)
    priority: int = 0             # higher wins EDF ties within a group
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    prefill_steps: int = 0        # prefill quanta this request consumed
    decode_steps: int = 0         # decode quanta that emitted for it
    # Speculative decoding: draft tokens offered to the verifier and
    # draft tokens the target accepted (0 without spec_decode).
    proposed: int = 0
    accepted: int = 0
    _cursor: int = dataclasses.field(default=0, repr=False)
    _seq: int = dataclasses.field(default=0, repr=False)    # arrival
    _deadline: float = dataclasses.field(default=float("inf"), repr=False)
    # Tokens to (re-)ingest at admission: the prompt, or prompt +
    # generated-so-far after a preemption.
    _feed: list[int] = dataclasses.field(default_factory=list, repr=False)


def make_paged_decode(cfg: ModelConfig):
    """Greedy decode step at the fixed slot-batch shape: per-slot
    positions + block tables over the paged pools."""
    def step(params, tokens, positions, block_tables, cache):
        logits, cache = lm_decode_step(params, cfg, tokens, positions, cache,
                                       block_tables=block_tables)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
    return step


def make_prefill_chunk(cfg: ModelConfig, *, fused: bool = True):
    """Batch-1 chunked prefill for one slot: the slot view carves the
    slot's recurrent rows (a pure-attention paged cache passes through)
    and the prefill updates them in place."""
    def prefill(params, tokens, pos0, slot, block_row, cache):
        local = cache_slot_view(cache, slot)
        logits, local = lm_prefill_chunk(params, cfg, tokens, pos0, local,
                                         block_tables=block_row, fused=fused)
        cache = cache_slot_merge(cache, local, slot)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
    return prefill


def make_verify_chunk(cfg: ModelConfig, *, fused: bool = True):
    """Batch-1 verification launch for speculative decoding: the whole
    ``[pending token, proposal...]`` chunk through one prefill-path
    program (the same dispatch as :func:`make_prefill_chunk`), returning
    the target's greedy token at every chunk position (1, C) and the
    cache.  A rejected tail is rolled back afterwards by
    ``PagedKVRuntime.truncate``."""
    def verify(params, tokens, pos0, slot, block_row, cache):
        local = cache_slot_view(cache, slot)
        logits, local = lm_verify_chunk(params, cfg, tokens, pos0, local,
                                        block_tables=block_row, fused=fused)
        cache = cache_slot_merge(cache, local, slot)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return verify


def _check_spec(sp, cfg: ModelConfig) -> None:
    """Refuse a speculation set-up whose rollback or proposals cannot be
    honoured: a recurrent or enc-dec target or draft (rollback is a
    position truncation), another vocabulary, or k < 1."""
    dcfg = sp.draft_cfg
    if set(cfg.block_pattern) != {"attn"} or cfg.is_enc_dec:
        raise ValueError(
            "spec_decode needs a pure-attention decoder-only target:"
            " rollback is a position truncation, which recurrent or"
            " encoder-fed state cannot honour")
    if set(dcfg.block_pattern) != {"attn"} or dcfg.is_enc_dec:
        raise ValueError(
            "spec_decode draft must be a pure-attention decoder-only"
            " model (draft KV rolls back by position truncation too)")
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft vocab {dcfg.vocab_size} != target vocab "
            f"{cfg.vocab_size}: proposals would not be token-compatible")
    if sp.k < 1:
        raise ValueError(f"spec_decode.k must be >= 1, got {sp.k}")


def copy_block(cache: list, src: int, dst: int) -> list:
    """Copy-on-write on the device: block ``src`` of every pool (quants
    and scales alike) into block ``dst``, in place."""
    for c in cache:
        for pool in c:
            if pool is not None:
                pool[dst].copy_(pool[src])
    return cache


class ContinuousBatcher(ev.EventStreamMixin):
    """``max_len`` is the per-request logical capacity (size it with
    :meth:`required_len`).  ``device`` holds the parameters and the
    pools (the card unless the caller asks for the CPU); the scheduler's
    own state stays on the host.  ``decode_fn`` replaces the decode
    quantum and follows :func:`make_paged_decode`'s signature,
    ``(params, tokens (S, 1), positions (S,), block_tables (S, MB),
    cache) -> (next_tokens (S,), cache)``.  ``extra_blocks`` adds blocks
    to the pool.  ``edf=False`` pops each group in arrival order.
    ``preempt_over_budget=True`` lets admission evict a decoding request
    that is over its deadline (or, with a cost model, predicted to be)
    while a feasible request waits.  ``clock`` is the SLO/event
    timebase."""

    def __init__(self, params: Any, cfg: ModelConfig, *,
                 config: EngineConfig | None = None,
                 slots: int = UNSET, max_len: int = UNSET,
                 enc_embeds=UNSET,
                 decode_fn: Callable | None = UNSET,
                 quantized_kv: bool = UNSET,
                 weight_quant: str | None = UNSET,
                 block_size: int = UNSET,
                 prefill_chunk: int = UNSET,
                 prefix_share: bool = UNSET,
                 extra_blocks: int = UNSET,
                 fused_prefill: bool = UNSET,
                 bus: ev.EventBus | None = UNSET,
                 clock: Callable[[], float] = UNSET,
                 edf: bool = UNSET,
                 preempt_over_budget: bool = UNSET,
                 cost_model=UNSET, metrics=UNSET,
                 device="cuda"):
        self.config, lmc = resolve(config, "lm", dict(
            slots=slots, max_len=max_len, enc_embeds=enc_embeds,
            decode_fn=decode_fn, quantized_kv=quantized_kv,
            weight_quant=weight_quant, block_size=block_size,
            prefill_chunk=prefill_chunk, prefix_share=prefix_share,
            extra_blocks=extra_blocks, fused_prefill=fused_prefill,
            bus=bus, clock=clock, edf=edf,
            preempt_over_budget=preempt_over_budget,
            cost_model=cost_model, metrics=metrics))
        if lmc.max_len is None:
            raise ValueError("max_len is required (pass max_len= or "
                             "config.lm.max_len; size it with "
                             "required_len())")
        slots, max_len, block_size = lmc.slots, lmc.max_len, lmc.block_size
        quantized_kv, prefix_share = lmc.quantized_kv, lmc.prefix_share
        weight_quant = self.config.weight_quant
        if prefix_share and (set(cfg.block_pattern) != {"attn"}
                             or cfg.is_enc_dec):
            raise ValueError(
                "prefix_share needs a pure-attention decoder: recurrent "
                "states and encoder KV cannot be adopted from a cache")
        self.spec = lmc.spec_decode
        if self.spec is not None:
            _check_spec(self.spec, cfg)
        self.device = resolve_device(device)
        params = to_device(params, self.device)
        if weight_quant is not None:
            params = quantize_params(params, get_policy(weight_quant))
        self.weight_quant = weight_quant
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.prefill_chunk = max(1, lmc.prefill_chunk)
        self.metrics = self.config.metrics     # None: no instrumentation
        # With prefix sharing the pool holds a second span per slot for
        # retained prompt blocks.
        self.runtime = PagedKVRuntime(
            slots, max_len, block_size, prefix_share=prefix_share,
            extra_blocks=lmc.extra_blocks
            + (slots * cdiv(max_len, block_size) if prefix_share else 0),
            metrics=self.metrics)
        self.runtime.copy_block = self._copy_block
        self.cache = init_cache(params, cfg, slots, max_len,
                                quantized_kv=quantized_kv,
                                enc_embeds=lmc.enc_embeds,
                                block_size=block_size,
                                num_blocks=self.runtime.num_blocks,
                                device=self.device)
        self.step_fn = lmc.decode_fn or make_paged_decode(cfg)
        self.fused_prefill = prefill_path(
            cfg, quantized_kv=quantized_kv,
            fused=lmc.fused_prefill) == "fused"
        self._prefill_raw = make_prefill_chunk(cfg, fused=self.fused_prefill)
        self.slots: list[Request | None] = [None] * slots
        self._pending: list[list[int]] = [[] for _ in range(slots)]
        self._next_tok = [0] * slots
        self.finished: list[Request] = []
        # Wait queue: one list per fairness group, admitted round-robin
        # across groups, EDF-popped within a group.
        self._groups: "OrderedDict[int, list[Request]]" = OrderedDict()
        self._rr: deque[int] = deque()
        self.bus = (self.config.bus if self.config.bus is not None
                    else ev.EventBus(self.config.clock))
        self.edf = self.config.edf
        self.preempt_over_budget = lmc.preempt_over_budget
        self.quantized_kv = quantized_kv
        self.cost_model = self.config.cost_model  # None: no admission control
        self.rejections = 0
        # Shapes whose first quantum already ran: the cost model skips
        # each shape's first quantum (its one-off costs).
        self._cm_warm: set = set()
        self.preemptions = 0
        self._subseq = 0
        self.prefill_quanta = 0
        self.decode_quanta = 0
        self.prefill_launches = 0
        # Target-model launches of decoding: one per decode quantum, one
        # per fused verify (the chunk's length on the scan path).
        self.decode_launches = 0
        self.draft_launches = 0
        self.spec_rounds = 0        # speculative quanta run
        self.spec_verifies = 0      # per-slot verification launches
        self.spec_proposed = 0      # draft tokens offered to the target
        self.spec_accepted = 0      # draft tokens the target accepted
        self.host_reads = 0         # .cpu() reads of speculative quanta
        self.last_quantum: tuple[str, int] | None = None
        self._draft_pending: list[list[int]] = [[] for _ in range(slots)]
        if self.spec is not None:
            self._init_spec(slots, max_len, block_size)

    def _init_spec(self, slots: int, max_len: int, block_size: int) -> None:
        """The draft's own serving state: a paged runtime and pool that
        no other model shares (so a rollback never dirties a CoW-shared
        prefix block), and its decode and prefill programs."""
        sp = self.spec
        dcfg = sp.draft_cfg
        self.draft_params = to_device(sp.draft_params, self.device)
        self.draft_runtime = PagedKVRuntime(slots, max_len, block_size)
        self.draft_cache = init_cache(self.draft_params, dcfg, slots,
                                      max_len, block_size=block_size,
                                      num_blocks=self.draft_runtime.num_blocks,
                                      device=self.device)
        self._draft_step = sp.draft_step_fn or make_paged_decode(dcfg)
        self._draft_fused = prefill_path(
            dcfg, fused=sp.draft_fused_prefill) == "fused"
        self._draft_prefill_raw = make_prefill_chunk(dcfg,
                                                     fused=self._draft_fused)
        self._verify_raw = make_verify_chunk(self.cfg,
                                             fused=self.fused_prefill)

    # ------------------------------------------------------------ sizing
    @staticmethod
    def required_len(n_requests: int, slots: int, prompt_len: int,
                     max_new: int) -> int:
        """Exact per-request logical capacity: a request writes positions
        ``0 .. prompt_len + max_new - 2`` (the final token is emitted,
        never cached); ``n_requests``/``slots`` do not matter."""
        del n_requests, slots
        return prompt_len + max_new - 1

    # --------------------------------------------------------------- API
    def submit(self, req: Request) -> ev.RequestHandle:
        need = len(req.prompt) + req.max_new - 1
        if need > self.max_len:
            raise ValueError(
                f"prompt {len(req.prompt)} + max_new {req.max_new} needs "
                f"capacity {need} > per-request max_len={self.max_len}")
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
        if self.metrics is not None:
            # Before admission control, so requests rejected here are
            # visible to telemetry too (submission is not a bus event).
            self.metrics.request_submitted(req.rid, "lm", self.bus.clock())
        if self.cost_model is not None and req.deadline_ms is not None:
            est = self.cost_model.estimate_lm(self, req)
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

    def _enqueue(self, req: Request) -> None:
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
        declares a deadline.  A request the cost model cannot price yet
        (or every request, without one) counts 0 service."""
        cm = self.cost_model
        now = self.bus.clock()
        best = float("inf")
        for q in self._groups.values():
            for r in q:
                if r._deadline == float("inf"):
                    continue
                est = cm.estimate_lm(self, r) if cm else None
                best = min(best, r._deadline - now - (est or 0.0))
        for i, r in enumerate(self.slots):
            if r is None or r._deadline == float("inf"):
                continue
            est = cm.remaining_lm(self, i) if cm else None
            best = min(best, r._deadline - now - (est or 0.0))
        return best

    # ------------------------------------------- feasibility admission
    def _infeasible(self, req: Request, now: float) -> tuple[bool, Any]:
        """(hopeless, estimate): the deadline expired, or the cost model
        predicts the request cannot finish in time even if served now.
        Called only with a cost model attached."""
        if req._deadline == float("inf"):
            return False, None
        est = self.cost_model.estimate_lm(self, req)
        if req._deadline < now:
            return True, est
        return (est is not None and now + est > req._deadline), est

    def _reject(self, req: Request, est, now: float) -> None:
        self.rejections += 1
        self.bus.emit(ev.Rejected, req.rid, estimated_s=est or 0.0,
                      budget_s=req._deadline - now,
                      reason="expired" if req._deadline < now
                      else "infeasible")

    def _sweep_infeasible(self) -> None:
        """Once per ``step()`` with a cost model: queued requests that
        expired or can no longer meet their deadline end ``Rejected``."""
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

    def _edf_key(self, req: Request) -> tuple:
        """EDF pop order within a group: expired requests last, then
        deadline, priority (higher first), arrival; with ``edf=False``
        arrival only."""
        if not self.edf:
            return (req._seq,)
        expired = req._deadline < self.bus.clock()
        return (expired, req._deadline, -req.priority, req._seq)

    def _pop_round_robin(self) -> Request | None:
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

    def _requeue_front(self, req: Request) -> None:
        self._groups[req.group].insert(0, req)
        self._rr.rotate(1)           # the group keeps its turn

    def _copy_block(self, src: int, dst: int) -> None:
        self.cache = copy_block(self.cache, src, dst)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue_len:
                continue
            while True:
                req = self._pop_round_robin()
                if req is None or self.cost_model is None:
                    break
                # Pop-time guard: a request that became hopeless after
                # the step's sweep (a preempted over-budget decode
                # requeued this quantum) must not take the slot.
                now = self.bus.clock()
                hopeless, est = self._infeasible(req, now)
                if not hopeless:
                    break
                self._reject(req, est, now)
            if req is None:
                break
            remaining = req.max_new - len(req.out)
            reused = self.runtime.admit(i, req._feed, remaining)
            if reused is None:          # pool pressure: try again later
                self._requeue_front(req)
                break
            self.slots[i] = req
            req._cursor = reused
            self._pending[i] = list(req._feed[reused:])
            # Zero the slot's recurrent rows (the reference's reset).
            self.cache = cache_slot_reset(self.cache, i)
            if self.spec is not None:
                # The draft pool covers every slot fully and has no
                # prefix cache, so its admission cannot fail.
                dre = self.draft_runtime.admit(i, req._feed, remaining)
                assert dre == 0, "draft pool has no prefix cache"
                self._draft_pending[i] = list(req._feed)
            if self.bus.admitted(req.rid):   # back from preemption
                self.bus.emit(ev.Progress, req.rid, phase="resume",
                              step=len(req.out), total=req.max_new)
            else:
                self.bus.emit(ev.Admitted, req.rid, slot=i)

    def _maybe_preempt(self) -> None:
        """With ``preempt_over_budget`` (and EDF): when feasible requests
        wait and no slot is free, evict the decoding request furthest
        past its deadline back to the queue, at most one per quantum.
        Without a cost model the test is after the fact (the deadline
        expired); with one it is predicted (now + remaining service past
        the deadline), and the victim is rejected at its next pop."""
        if not self.preempt_over_budget or not self.edf \
                or not self.queue_len:
            return
        if any(s is None for s in self.slots):
            return
        now = self.bus.clock()
        if self.cost_model is None:
            feasible_waiter = any(r._deadline >= now
                                  for q in self._groups.values()
                                  for r in q)
        else:
            feasible_waiter = any(not self._infeasible(r, now)[0]
                                  for q in self._groups.values()
                                  for r in q)
        if not feasible_waiter:
            return
        victims = []
        for i, r in enumerate(self.slots):
            if r is None or self._pending[i] or self._draft_pending[i] \
                    or r._deadline == float("inf"):
                continue
            est = (self.cost_model.remaining_lm(self, i)
                   if self.cost_model is not None else None)
            # Predicted miss; the overrun itself when the model cannot
            # price the decode yet.
            miss = now + (est or 0.0) - r._deadline
            if miss > 0:
                victims.append((miss, i))
        if victims:
            _, i = max(victims)
            self._preempt_slot(i, "deadline-overrun")

    def _preempt_slot(self, i: int, reason: str) -> None:
        req = self.slots[i]
        cached = req._feed[:self.runtime.pos[i]]
        self.runtime.release(
            i, cached if self.runtime.prefix is not None else None)
        self.slots[i] = None
        self._pending[i] = []
        self._release_draft(i)
        req._feed = list(req.prompt) + list(req.out)
        self.preemptions += 1
        self.bus.emit(ev.Preempted, req.rid, reason=reason)
        self._enqueue(req)

    def preempt(self, rid: int, reason: str = "explicit") -> bool:
        """Evict a running request back to the wait queue (blocks
        released, resume via prefill); True if ``rid`` held a slot."""
        for i, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                self._preempt_slot(i, reason)
                return True
        return False

    # ------------------------------------------- fleet migration hooks
    def evacuate(self, reason: str = "evacuate") -> list[Request]:
        """Preempt every running request (blocks released, ``Preempted``
        emitted, feed reset to prompt + generated tokens) and pop every
        queued one; returns them in arrival order with no terminal
        events, for a batcher on the same bus to ``adopt()``."""
        for i, r in enumerate(self.slots):
            if r is not None:
                self._preempt_slot(i, reason)
        out = [r for q in self._groups.values() for r in q]
        self._groups.clear()
        self._rr.clear()
        out.sort(key=lambda r: r._seq)
        return out

    def adopt(self, req: Request) -> ev.RequestHandle:
        """Admit a request evacuated from another batcher on the same
        bus: no duplicate-rid guard (its admission lives on the bus), no
        submit-time rejection (the per-step sweep still applies), and its
        original absolute deadline.  Admission re-ingests prompt +
        generated tokens and resumes with ``Progress(phase="resume")``,
        never a second ``Admitted``."""
        need = len(req.prompt) + req.max_new - 1
        if need > self.max_len:
            raise ValueError(
                f"adopted rid {req.rid} needs capacity {need} > "
                f"per-request max_len={self.max_len}")
        req._feed = list(req.prompt) + list(req.out)
        req._seq = self._subseq
        self._subseq += 1
        self._enqueue(req)
        return self.handle(req.rid)

    def cancel(self, rid: int) -> bool:
        """Abort a request wherever it is (queue, mid-prefill or
        mid-decode); its blocks return to the pool; emits ``Cancelled``."""
        for q in self._groups.values():
            for r in q:
                if r.rid == rid:
                    q.remove(r)
                    self.bus.emit(ev.Cancelled, rid)
                    return True
        for i, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                self.runtime.release(i)   # no prefix donation: blocks
                self.slots[i] = None      # may be half-written
                self._pending[i] = []
                self._release_draft(i)
                self.runtime.check_consistency()
                self.bus.emit(ev.Cancelled, rid)
                return True
        return False

    def _release_draft(self, i: int) -> None:
        """Return the slot's draft-pool blocks (speculation only)."""
        if self.spec is not None:
            self.draft_runtime.release(i)
            self._draft_pending[i] = []

    # ------------------------------------------------------- scheduling
    def step(self) -> int:
        """One scheduling quantum (prefill first); returns the number of
        requests progressed."""
        if self.cost_model is not None and self.queue_len:
            self._sweep_infeasible()
        self._maybe_preempt()
        self._admit()
        self._obs_sched()
        for i, req in enumerate(self.slots):
            if req is not None and (self._pending[i]
                                    or self._draft_pending[i]):
                return self._prefill_quantum(i)
        if self.spec is not None:
            return self._spec_quantum()
        return self._decode_quantum()

    def _obs_quantum(self, kind: str, t0: float, rids: list,
                     args: dict | None = None) -> None:
        """Phase telemetry (histogram and span).  Unlike
        ``_observe_quantum`` it keeps each shape's first quantum, so
        phase counts reconcile with ``prefill_quanta``/``decode_quanta``."""
        if self.metrics is None:
            return
        sync_device(self.device)
        self.metrics.phase("lm", kind, t0, self.bus.clock(),
                           rids=rids, args=args)

    def _obs_sched(self) -> None:
        if self.metrics is None:
            return
        self.metrics.gauge(
            "engine_queue_depth", "queued requests by engine",
            labels=("engine",)).set(self.queue_len, engine="lm")
        self.metrics.gauge(
            "lm_slots_active", "occupied decode slots").set(
            sum(1 for s in self.slots if s is not None))

    def _observe_quantum(self, key: tuple, shape: tuple, t0: float) -> None:
        """Feed one quantum's duration to the cost model, skipping the
        first quantum of each ``shape`` (its one-off costs would poison
        the steady-state EWMA); waits for the device first."""
        if self.cost_model is None:
            return
        if shape not in self._cm_warm:
            self._cm_warm.add(shape)
            return
        sync_device(self.device)
        self.cost_model.observe(key, self.bus.clock() - t0)

    def _draft_ingest(self, i: int) -> torch.Tensor:
        """One draft prefill chunk.  The draft keeps a full private copy
        of the slot's feed (its pool has no prefix cache), so it rides
        the slot's prefill quanta until it has caught up."""
        chunk = self._draft_pending[i][:self.prefill_chunk]
        del self._draft_pending[i][:len(chunk)]
        dpos = self.draft_runtime.pos[i]
        dev = self.device
        nxt, self.draft_cache = self._draft_prefill_raw(
            self.draft_params,
            torch.tensor([chunk], dtype=torch.int64, device=dev),
            torch.full((1,), dpos, dtype=torch.int32),
            i,
            torch.tensor([self.draft_runtime.tables[i]], dtype=torch.int32,
                         device=dev),
            self.draft_cache)
        self.draft_runtime.pos[i] = dpos + len(chunk)
        self.draft_launches += 1 if self._draft_fused else len(chunk)
        return nxt

    def _prefill_quantum(self, i: int) -> int:
        req = self.slots[i]
        if not self._pending[i]:
            # The target's feed is in, the draft's is not (a prefix hit
            # skipped target chunks the draft must still ingest).
            t0 = self.bus.clock()
            self._draft_ingest(i)
            self.prefill_quanta += 1
            self.last_quantum = ("draft-prefill", 1)
            self._obs_quantum("draft-prefill", t0, [req.rid],
                              args={"slot": i})
            return 1
        t0 = self.bus.clock()
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
            self.cache)
        self.runtime.pos[i] = pos + len(chunk)
        req._cursor += len(chunk)
        req.prefill_steps += 1
        self.prefill_quanta += 1
        self.prefill_launches += 1 if self.fused_prefill else len(chunk)
        self.last_quantum = ("prefill", 1)
        if self.cost_model is not None:
            self._observe_quantum(self.cost_model.lm_keys(self)[0],
                                  ("prefill", len(chunk)), t0)
        self._obs_quantum("prefill", t0, [req.rid],
                          args={"tokens": len(chunk), "slot": i,
                                "fused": self.fused_prefill,
                                "quantized_kv": self.quantized_kv,
                                "weight_quant": self.weight_quant})
        self.bus.emit(ev.Progress, req.rid, phase="prefill",
                      step=req._cursor, total=len(req._feed))
        if self.spec is not None and self._draft_pending[i]:
            self._draft_ingest(i)       # rides the same quantum
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
            self.cache)
        self.decode_quanta += 1
        self.decode_launches += 1
        self.last_quantum = ("decode", len(active))
        nxt_host = nxt.tolist()
        if self.cost_model is not None:
            self._observe_quantum(self.cost_model.lm_keys(self)[1],
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

    # ------------------------------------------- speculative decoding
    def _slot_cap(self, req: Request) -> int:
        """Cacheable positions of this request (the admit-time block
        reservation): the final token is emitted, never cached."""
        return min(len(req.prompt) + req.max_new - 1, self.max_len)

    def spec_tokens_per_round(self) -> float:
        """Tokens emitted per verification launch (accepted draft tokens
        plus the bonus token); 1.0 before any speculation has run."""
        if not self.spec_verifies:
            return 1.0
        return self.spec_accepted / self.spec_verifies + 1.0

    def _spec_quantum(self) -> int:
        """One speculative decode quantum, in three phases:

        1. **Draft proposal** — batched draft decode steps at the slot
           shape propose up to ``k`` tokens per slot greedily.  A slot
           whose proposal is done (or that has no request) runs as an
           idle row: position 0, its table all ``NULL_BLOCK``.
        2. **Verification** — per slot, the pending token plus the
           proposal in one chunk launch; the target's greedy token at
           every position decides the longest accepted prefix, and the
           position after it gives a bonus token.
        3. **Commit / rollback** — the rejected tail rolls back with
           ``PagedKVRuntime.truncate`` (the write window went through
           ``ensure_writable`` first); the draft pool rolls back the same
           way and re-feeds any gap next round.

        Near a request's horizon the proposal shrinks to what still
        fits; when no slot can propose, the quantum is one plain decode
        step."""
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            self.last_quantum = None
            return 0
        k: dict[int, int] = {}
        for i in active:
            r = self.slots[i]
            k[i] = max(0, min(self.spec.k, r.max_new - len(r.out) - 1,
                              self._slot_cap(r) - 1 - self.runtime.pos[i]))
        if all(k[i] == 0 for i in active):
            return self._decode_quantum()
        t0 = self.bus.clock()
        n_slots = len(self.slots)
        mb = self.draft_runtime.blocks_per_slot
        dev = self.device
        # ---- phase 1: draft proposals (batched across slots) --------
        base, feeds, steps, props = {}, {}, {}, {}
        for i in active:
            r = self.slots[i]
            stream = list(r.prompt) + list(r.out)
            base[i] = self.draft_runtime.pos[i]
            # The catch-up gap (tokens committed since the draft last saw
            # this slot) and the pending token, whose output is the
            # first proposal.
            feeds[i] = stream[base[i]:self.runtime.pos[i] + 1]
            steps[i] = len(feeds[i]) + max(k[i] - 1, 0)
            props[i] = []
        for t in range(max(steps.values())):
            toks = [0] * n_slots
            poss = [0] * n_slots
            tab = [[NULL_BLOCK] * mb for _ in range(n_slots)]
            for i in active:
                if t >= steps[i]:
                    continue            # idle row: writes land in NULL_BLOCK
                tab[i] = self.draft_runtime.tables[i]
                poss[i] = base[i] + t
                toks[i] = feeds[i][t] if t < len(feeds[i]) else props[i][-1]
            nxt, self.draft_cache = self._draft_step(
                self.draft_params,
                torch.tensor(toks, dtype=torch.int64, device=dev)[:, None],
                torch.tensor(poss, dtype=torch.int32, device=dev),
                torch.tensor(tab, dtype=torch.int32, device=dev),
                self.draft_cache)
            self.draft_launches += 1
            nxt_host = nxt.cpu().tolist()
            self.host_reads += 1
            for i in active:
                if (t < steps[i] and t >= len(feeds[i]) - 1
                        and len(props[i]) < k[i]):
                    props[i].append(int(nxt_host[i]))
        # ---- phases 2 and 3: verify, commit, roll back (per slot) ----
        bs = self.runtime.block_size
        total_prop = total_acc = 0
        rids = [self.slots[i].rid for i in active]
        for i in active:
            req = self.slots[i]
            pos = self.runtime.pos[i]
            chunk = [int(self._next_tok[i])] + props[i]
            length = len(chunk)
            for bi in range(pos // bs, cdiv(pos + length, bs)):
                self.runtime.ensure_writable(i, bi * bs)
            g, self.cache = self._verify_raw(
                self.params,
                torch.tensor([chunk], dtype=torch.int64, device=dev),
                torch.full((1,), pos, dtype=torch.int32),
                i,
                torch.tensor([self.runtime.tables[i]], dtype=torch.int32,
                             device=dev),
                self.cache)
            greedy = g.cpu()[0].tolist()
            self.host_reads += 1
            self.decode_launches += 1 if self.fused_prefill else length
            self.spec_verifies += 1
            m = 0
            while m < k[i] and props[i][m] == greedy[m]:
                m += 1
            emitted = props[i][:m] + [greedy[m]]
            req.proposed += k[i]
            req.accepted += m
            total_prop += k[i]
            total_acc += m
            if req.eos is not None and req.eos in emitted:
                emitted = emitted[:emitted.index(req.eos) + 1]
            # The verify cached all `length` fed positions: keep the
            # pending token and the accepted prefix, rewind the rest.
            self.runtime.pos[i] = pos + length
            self.runtime.truncate(i, pos + len(emitted))
            # The draft was fed the pending token and props[:k-1]; past
            # the accepted prefix they describe a stream that is gone.
            self.draft_runtime.pos[i] = min(pos + 1 + m, pos + max(k[i], 1))
            for tok in emitted:
                req.out.append(tok)
                self.bus.emit(ev.TokenDelta, req.rid, token=tok,
                              pos=len(req.out) - 1)
            req.decode_steps += 1
            self._next_tok[i] = emitted[-1]
            self._maybe_retire(i)
        self.decode_quanta += 1
        self.spec_rounds += 1
        self.spec_proposed += total_prop
        self.spec_accepted += total_acc
        self.last_quantum = ("decode-spec", len(active))
        if self.cost_model is not None:
            self._observe_quantum(self.cost_model.lm_spec_key(self),
                                  ("decode-spec",), t0)
        self._obs_quantum("decode-spec", t0, rids,
                          args={"batch": len(active),
                                "proposed": total_prop,
                                "accepted": total_acc})
        if self.metrics is not None:
            self.metrics.counter(
                "lm_spec_proposed_total",
                "draft tokens offered to the verifier").inc(total_prop)
            self.metrics.counter(
                "lm_spec_accepted_total",
                "draft tokens the target accepted").inc(total_acc)
            if total_prop:
                self.metrics.histogram(
                    "lm_spec_acceptance", "per-quantum draft "
                    "acceptance rate (accepted / proposed)",
                    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                             0.875, 1.0)).observe(total_acc / total_prop)
        return len(active)

    def _maybe_retire(self, i: int) -> None:
        req = self.slots[i]
        over = len(req.out) >= req.max_new
        hit_eos = req.eos is not None and req.out and req.out[-1] == req.eos
        trunc = self.runtime.pos[i] >= self.max_len
        if over or hit_eos or trunc:
            req.done = True
            self.finished.append(req)
            # The feed starts with the prompt, so the table's leading full
            # blocks hold exactly the prompt's KV, resumed or not.
            self.runtime.release(i, req.prompt)
            self.slots[i] = None
            self._pending[i] = []
            self._release_draft(i)
            self.bus.emit(ev.Finished, req.rid, result=req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return list(self.finished)    # snapshot: later runs keep appending
