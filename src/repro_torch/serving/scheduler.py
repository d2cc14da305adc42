"""Continuous-batching LM serving scheduler over the paged KV runtime
(``repro.serving.scheduler``).

Python request plumbing around two programs, with the cache bookkeeping
in :class:`repro_torch.serving.kvcache.PagedKVRuntime`:

* **Chunked prefill** — admission feeds the prompt in chunks at batch 1
  (``models.transformer.lm_prefill_chunk``).  By default each chunk is
  one fused paged flash-prefill kernel per layer (bf16 or Q8_0 pools);
  ``fused_prefill=False`` runs the decode-step scan instead.  The last
  chunk's logits emit the first generated token.
* **Decode quanta** — one greedy step at the fixed slot-batch shape;
  idle rows point their table at the null block and are never emitted.
* **Prefix reuse** (``prefix_share=True``) — retiring requests donate
  their full prompt blocks; a later request with the same prefix adopts
  them read-only and skips their chunks.  The copy-on-write hook copies
  a block in place on the device.
* **Fairness** — round-robin across request ``group`` ids, earliest
  deadline first within a group.
* **Streaming lifecycle** — ``Admitted``, ``Progress(prefill)`` per
  chunk, ``TokenDelta`` per token, ``Finished``; ``cancel()`` and
  ``preempt()`` (re-ingest prompt + generated tokens on resume).

``step()`` runs one quantum — pending prompt chunks first, otherwise one
batched decode step — and counts it in ``prefill_quanta`` /
``decode_quanta``; ``prefill_launches`` / ``decode_launches`` count the
model programs run (one per fused chunk or one per scanned token, one
per decode quantum).

Not ported yet: speculative decoding, the cost model and metrics,
``evacuate``/``adopt``, ``EngineConfig``, encoder inputs,
``preempt_over_budget`` and the reference's ``decode_fn``,
``extra_blocks`` and ``edf`` switches (the port always pops EDF within
a group).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.core.tree import to_device
from repro_torch.engine import events as ev
from repro_torch.models.transformer import (cache_slot_merge, cache_slot_reset,
                                            cache_slot_view, init_cache,
                                            lm_decode_step, lm_prefill_chunk,
                                            prefill_path)
from repro_torch.serving.kvcache import PagedKVRuntime, cdiv

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
    """Batch-1 chunked prefill for one slot (the slot view/merge are the
    identity for a pure-attention paged cache)."""
    def prefill(params, tokens, pos0, slot, block_row, cache):
        local = cache_slot_view(cache, slot)
        logits, local = lm_prefill_chunk(params, cfg, tokens, pos0, local,
                                         block_tables=block_row, fused=fused)
        cache = cache_slot_merge(cache, local, slot)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
    return prefill


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
    own state stays on the host.  ``clock`` is the SLO/event timebase."""

    def __init__(self, params: Any, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int | None = None,
                 quantized_kv: bool = False,
                 weight_quant: str | None = None,
                 block_size: int = DEFAULT_BLOCK,
                 prefill_chunk: int = 8,
                 prefix_share: bool = False,
                 fused_prefill: bool = True,
                 bus: ev.EventBus | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda"):
        if max_len is None:
            raise ValueError("max_len is required (size it with "
                             "required_len())")
        if prefix_share and (set(cfg.block_pattern) != {"attn"}
                             or cfg.is_enc_dec):
            raise ValueError(
                "prefix_share needs a pure-attention decoder: recurrent "
                "states and encoder KV cannot be adopted from a cache")
        self.device = resolve_device(device)
        params = to_device(params, self.device)
        if weight_quant is not None:
            params = quantize_params(params, get_policy(weight_quant))
        self.weight_quant = weight_quant
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.prefill_chunk = max(1, prefill_chunk)
        # With prefix sharing the pool holds a second span per slot for
        # retained prompt blocks.
        self.runtime = PagedKVRuntime(
            slots, max_len, block_size, prefix_share=prefix_share,
            extra_blocks=slots * cdiv(max_len, block_size) if prefix_share else 0)
        self.runtime.copy_block = self._copy_block
        self.cache = init_cache(params, cfg, slots, max_len,
                                quantized_kv=quantized_kv,
                                block_size=block_size,
                                num_blocks=self.runtime.num_blocks,
                                device=self.device)
        self.step_fn = make_paged_decode(cfg)
        self.fused_prefill = prefill_path(
            cfg, quantized_kv=quantized_kv, fused=fused_prefill) == "fused"
        self._prefill_raw = make_prefill_chunk(cfg, fused=self.fused_prefill)
        self.slots: list[Request | None] = [None] * slots
        self._pending: list[list[int]] = [[] for _ in range(slots)]
        self._next_tok = [0] * slots
        self.finished: list[Request] = []
        # Wait queue: one list per fairness group, admitted round-robin
        # across groups, EDF-popped within a group.
        self._groups: "OrderedDict[int, list[Request]]" = OrderedDict()
        self._rr: deque[int] = deque()
        self.bus = bus if bus is not None else ev.EventBus(clock)
        self.quantized_kv = quantized_kv
        self.preemptions = 0
        self._subseq = 0
        self.prefill_quanta = 0
        self.decode_quanta = 0
        self.prefill_launches = 0
        self.decode_launches = 0
        self.last_quantum: tuple[str, int] | None = None

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

    def _edf_key(self, req: Request) -> tuple:
        """EDF pop order within a group: expired requests last, then
        deadline, priority (higher first), arrival."""
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
            req = self._pop_round_robin()
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
            self.cache = cache_slot_reset(self.cache, i)
            if self.bus.admitted(req.rid):   # back from preemption
                self.bus.emit(ev.Progress, req.rid, phase="resume",
                              step=len(req.out), total=req.max_new)
            else:
                self.bus.emit(ev.Admitted, req.rid, slot=i)

    def _preempt_slot(self, i: int, reason: str) -> None:
        req = self.slots[i]
        cached = req._feed[:self.runtime.pos[i]]
        self.runtime.release(
            i, cached if self.runtime.prefix is not None else None)
        self.slots[i] = None
        self._pending[i] = []
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
                self.runtime.check_consistency()
                self.bus.emit(ev.Cancelled, rid)
                return True
        return False

    # ------------------------------------------------------- scheduling
    def step(self) -> int:
        """One scheduling quantum (prefill first); returns the number of
        requests progressed."""
        self._admit()
        for i, req in enumerate(self.slots):
            if req is not None and self._pending[i]:
                return self._prefill_quantum(i)
        return self._decode_quantum()

    def _prefill_quantum(self, i: int) -> int:
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
            self.cache)
        self.runtime.pos[i] = pos + len(chunk)
        req._cursor += len(chunk)
        req.prefill_steps += 1
        self.prefill_quanta += 1
        self.prefill_launches += 1 if self.fused_prefill else len(chunk)
        self.last_quantum = ("prefill", 1)
        self.bus.emit(ev.Progress, req.rid, phase="prefill",
                      step=req._cursor, total=len(req._feed))
        if not self._pending[i]:        # feed done: next token is out
            tok = int(nxt[0])
            req.out.append(tok)
            self.bus.emit(ev.TokenDelta, req.rid, token=tok,
                          pos=len(req.out) - 1)
            self._next_tok[i] = tok
            self._maybe_retire(i)
        return 1

    def _decode_quantum(self) -> int:
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
            # The feed starts with the prompt, so the table's leading full
            # blocks hold exactly the prompt's KV, resumed or not.
            self.runtime.release(i, req.prompt)
            self.slots[i] = None
            self._pending[i] = []
            self.bus.emit(ev.Finished, req.rid, result=req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return list(self.finished)    # snapshot: later runs keep appending
