"""Block-paged KV-cache runtime for continuous-batching LM serving.

A copy of ``repro.serving.kvcache`` (the port keeps its own, so that it
imports nothing of the reference).  The module is pure host Python over
integer state; device tensors only appear through the ``copy_block``
callback a scheduler installs for copy-on-write.

* **Physical pool** — every self-attention layer owns a
  ``(num_blocks, Hkv, block_size, hd)`` pool (see
  ``models.attention.init_paged_kv_cache``).  Block 0 is the reserved
  *null block*: idle batch rows point their table at it so the fixed-
  shape decode step can scatter harmlessly.
* **:class:`BlockAllocator`** — a free-list with per-block refcounts;
  refcount > 1 means the block is shared read-only between slots
  and/or the prefix cache.
* **:class:`PrefixCache`** — hash-chained full prompt blocks retained
  at retirement; a later request with the same prompt prefix adopts
  the blocks (refcount bump) and skips recomputing their KV.  Entries
  are LRU-evicted under pool pressure, so retention never blocks
  admission.
* **:class:`PagedKVRuntime`** — per-slot position vectors and block
  tables, admission (``admit``), retirement (``release``), and a
  copy-on-write guard (``ensure_writable``) so a slot never mutates a
  block another holder can still read.  The cross-attention pool
  methods (``admit_cross`` and the rest) are kept for the enc-dec slice;
  nothing in this port calls them yet.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Sequence

NULL_BLOCK = 0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BlockAllocator:
    """Free-list allocator with refcounts over ``num_blocks`` physical
    blocks.  Block 0 (the null block) is never handed out."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block")
        self.num_blocks = num_blocks
        self._free: deque[int] = deque(range(1, num_blocks))
        # Mirror of _free for O(1) membership: the free list and the
        # refcounted live set must stay disjoint (is_free / the
        # runtime's check_consistency assert on it).
        self._free_set: set[int] = set(self._free)
        self._refs: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def refcount(self, bid: int) -> int:
        return self._refs.get(bid, 0)

    def is_free(self, bid: int) -> bool:
        """True iff ``bid`` currently sits in the free list."""
        return bid in self._free_set

    def alloc(self, n: int) -> list[int] | None:
        """Atomically allocate ``n`` blocks (refcount 1), or None."""
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        for bid in out:
            assert bid not in self._refs, \
                f"block {bid} was simultaneously free and refcounted"
            self._free_set.discard(bid)
            self._refs[bid] = 1
        return out

    def share(self, bid: int) -> None:
        """Add a reader to an allocated block."""
        if bid == NULL_BLOCK:
            return
        if bid not in self._refs:
            raise ValueError(f"share of unallocated block {bid}")
        assert not self.is_free(bid), \
            f"share of block {bid} that is on the free list"
        self._refs[bid] += 1

    def release(self, bid: int) -> bool:
        """Drop one reference; True when the block returned to the
        free list."""
        if bid == NULL_BLOCK:
            return False
        n = self._refs.get(bid)
        if n is None:
            raise ValueError(f"release of unallocated block {bid}")
        if n > 1:
            self._refs[bid] = n - 1
            return False
        del self._refs[bid]
        assert bid not in self._free_set, f"double-free of block {bid}"
        self._free.append(bid)
        self._free_set.add(bid)
        return True


class PrefixCache:
    """Hash-chained prompt prefix -> physical block index.

    Keys chain the parent hash with the block's token tuple, so a hit
    for block *i* implies blocks ``0..i-1`` matched too.  The cache
    holds one reference per entry; ``evict_lru`` drops the
    least-recently-used entry to relieve pool pressure."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.alloc = allocator
        self.block_size = block_size
        self._entries: OrderedDict[int, int] = OrderedDict()  # key -> bid
        self.hits = 0          # blocks adopted by admissions
        self.insertions = 0

    @staticmethod
    def _chain(parent: int, toks: tuple) -> int:
        return hash((parent, toks))

    def _keys(self, prompt: Sequence[int], n_blocks: int) -> list[int]:
        keys, parent = [], 0
        for i in range(n_blocks):
            toks = tuple(prompt[i * self.block_size:
                                (i + 1) * self.block_size])
            parent = self._chain(parent, toks)
            keys.append(parent)
        return keys

    def match(self, prompt: Sequence[int], max_blocks: int) -> list[int]:
        """Longest chain of cached full blocks (<= max_blocks); bumps
        each matched block's refcount (caller owns the references)."""
        out = []
        for key in self._keys(prompt, max_blocks):
            bid = self._entries.get(key)
            if bid is None:
                break
            self._entries.move_to_end(key)
            self.alloc.share(bid)
            out.append(bid)
        self.hits += len(out)
        return out

    def insert(self, prompt: Sequence[int], table: Sequence[int]) -> None:
        """Retain the prompt's *full* blocks (immutable after prefill:
        decode writes land strictly beyond them)."""
        n_full = len(prompt) // self.block_size
        for key, bid in zip(self._keys(prompt, n_full), table):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            self.alloc.share(bid)
            self._entries[key] = bid
            self.insertions += 1

    def evict_lru(self) -> bool:
        if not self._entries:
            return False
        _, bid = self._entries.popitem(last=False)
        self.alloc.release(bid)
        return True

    def __len__(self) -> int:
        return len(self._entries)


class PagedKVRuntime:
    """Per-slot positions + block tables over a shared physical pool.

    ``max_len`` is the *per-request* logical capacity (positions
    ``0..max_len-1``); the pool defaults to exactly one block span per
    slot plus the null block, with ``extra_blocks`` headroom for
    prefix retention.  All state is host-side; the device cache pytree
    is built separately with matching ``(num_blocks, block_size)``.
    """

    def __init__(self, slots: int, max_len: int, block_size: int = 16, *,
                 num_blocks: int | None = None, extra_blocks: int = 0,
                 prefix_share: bool = False,
                 cross_len: int = 0, cross_block_size: int | None = None,
                 cross_extra_blocks: int = 0,
                 cross_prefix_share: bool = False,
                 copy_block: Callable[[int, int], None] | None = None,
                 metrics=None):
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_slot = cdiv(max_len, block_size)
        self.num_blocks = (num_blocks if num_blocks is not None
                           else slots * self.blocks_per_slot + 1
                           + extra_blocks)
        self.alloc = BlockAllocator(self.num_blocks)
        self.prefix: PrefixCache | None = (
            PrefixCache(self.alloc, block_size) if prefix_share else None)
        self.copy_block = copy_block      # device CoW hook (src, dst)
        self.pos = [0] * slots            # tokens cached per slot
        self.tables = [[NULL_BLOCK] * self.blocks_per_slot
                       for _ in range(slots)]
        self._owned = [0] * slots         # blocks in use (incl. shared)
        self.cow_copies = 0
        # Optional cross-attention pool: one fixed-length span of
        # encoder KV per slot, refcounted + prefix-shareable like the
        # self-attention pool but adopted all-or-nothing.
        self.cross_len = cross_len
        self.cross_block_size = cross_block_size or block_size
        self.cross_blocks_per_slot = (
            cdiv(cross_len, self.cross_block_size) if cross_len else 0)
        self.cross_num_blocks = (
            slots * self.cross_blocks_per_slot + 1 + cross_extra_blocks
            if cross_len else 0)
        self.cross_alloc: BlockAllocator | None = (
            BlockAllocator(self.cross_num_blocks) if cross_len else None)
        self.cross_prefix: PrefixCache | None = (
            PrefixCache(self.cross_alloc, self.cross_block_size)
            if cross_len and cross_prefix_share else None)
        self.cross_tables = [[NULL_BLOCK] * self.cross_blocks_per_slot
                             for _ in range(slots)]
        self._cross_owned = [0] * slots
        # True while the slot's cross blocks were adopted from the
        # prefix cache (read-only: the engine must not encode into
        # them).
        self.cross_adopted = [False] * slots
        self.metrics = metrics            # None -> no instrumentation
        self._obs_pool()

    # ---------------------------------------------------- observability
    def _obs_pool(self) -> None:
        """Refresh pool gauges (allocated/free blocks, CoW copies,
        prefix-cache size and hits) after any state change; the gauges
        mirror the host-side counters exactly, so snapshot values and
        ``stats()``-style asserts never diverge."""
        m = self.metrics
        if m is None:
            return
        g = m.gauge("kv_pool_blocks", "physical KV blocks by state "
                    "(null block excluded)", labels=("state",))
        g.set(self.allocated_blocks, state="allocated")
        g.set(self.alloc.num_free, state="free")
        m.gauge("kv_cow_copies",
                "cumulative copy-on-write block copies").set(
            self.cow_copies)
        if self.prefix is not None:
            m.gauge("kv_prefix_entries",
                    "retained prefix-cache blocks").set(len(self.prefix))
            m.gauge("kv_prefix_hits",
                    "cumulative prefix blocks adopted").set(
                self.prefix.hits)
        if self.cross_alloc is not None:
            gc = m.gauge("kv_cross_pool_blocks",
                         "cross-attention (encoder KV) blocks by state "
                         "(null block excluded)", labels=("state",))
            gc.set(self.allocated_cross_blocks, state="allocated")
            gc.set(self.cross_alloc.num_free, state="free")
            if self.cross_prefix is not None:
                m.gauge("kv_cross_prefix_entries",
                        "retained audio-prefix blocks").set(
                    len(self.cross_prefix))
                m.gauge("kv_cross_prefix_hits",
                        "cumulative audio blocks adopted").set(
                    self.cross_prefix.hits)

    # ------------------------------------------------------- invariants
    def check_consistency(self) -> None:
        """Assert the free list and the live block tables are disjoint:
        a block must never be simultaneously free and reachable from a
        slot's table (the refcount/free ordering bug class).  Checking
        every live table entry against ``is_free`` proves the
        disjointness in one direction, which is the whole property.
        Called after every admit/CoW/release; cheap at serving scale
        (O(slots * blocks_per_slot))."""
        for slot in range(self.slots):
            for bid in self.tables[slot][:self._owned[slot]]:
                assert bid != NULL_BLOCK, \
                    f"slot {slot} owns the null block"
                assert not self.alloc.is_free(bid), \
                    f"block {bid} is in slot {slot}'s table AND free"
                assert self.alloc.refcount(bid) >= 1, \
                    f"block {bid} is in slot {slot}'s table unrefcounted"
            for bid in self.cross_tables[slot][:self._cross_owned[slot]]:
                assert bid != NULL_BLOCK, \
                    f"slot {slot} owns the null cross block"
                assert not self.cross_alloc.is_free(bid), \
                    f"cross block {bid} is in slot {slot}'s table AND free"
                assert self.cross_alloc.refcount(bid) >= 1, \
                    f"cross block {bid} in slot {slot}'s table unrefcounted"

    # -------------------------------------------------------- admission
    def _alloc_with_eviction(self, n: int) -> list[int] | None:
        while self.alloc.num_free < n:
            if self.prefix is None or not self.prefix.evict_lru():
                return None
        return self.alloc.alloc(n)

    def admit(self, slot: int, prompt: Sequence[int],
              max_new: int) -> int | None:
        """Reserve blocks for ``prompt`` + ``max_new`` generated tokens
        and return the number of prompt tokens whose KV was adopted
        from the prefix cache (0 without a hit).  None if the pool
        cannot cover the request right now (caller requeues)."""
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} already admitted")
        total = min(len(prompt) + max_new - 1, self.max_len)
        need = cdiv(total, self.block_size)
        shared: list[int] = []
        if self.prefix is not None:
            # Full blocks only, and never the whole prompt: the last
            # prompt token must be recomputed to produce first logits.
            max_shared = min(need, (len(prompt) - 1) // self.block_size)
            shared = self.prefix.match(prompt, max_shared)
        fresh = self._alloc_with_eviction(need - len(shared))
        if fresh is None:
            for bid in shared:
                self.alloc.release(bid)
            if self.prefix is not None:  # adoption didn't happen: keep
                self.prefix.hits -= len(shared)   # the stat honest
            return None
        table = shared + fresh
        self.tables[slot] = (table
                             + [NULL_BLOCK] * (self.blocks_per_slot
                                               - len(table)))
        self._owned[slot] = len(table)
        n_reused = len(shared) * self.block_size
        self.pos[slot] = n_reused
        self.check_consistency()
        self._obs_pool()
        return n_reused

    # ------------------------------------------------------ write guard
    def ensure_writable(self, slot: int, pos: int) -> int:
        """Copy-on-write guard: the block holding ``pos`` must have
        refcount 1 before the device step scatters into it.  Under
        full-block-only sharing this never triggers (shared blocks sit
        strictly below every write position) but the runtime stays
        correct under any future sharing policy.  Returns the physical
        block id the write will land in."""
        bi = pos // self.block_size
        bid = self.tables[slot][bi]
        if self.alloc.refcount(bid) <= 1:
            return bid
        fresh = self._alloc_with_eviction(1)
        if fresh is None:
            raise RuntimeError("pool exhausted during copy-on-write")
        if self.copy_block is not None:
            self.copy_block(bid, fresh[0])
        self.alloc.release(bid)
        self.tables[slot][bi] = fresh[0]
        self.cow_copies += 1
        self.check_consistency()
        self._obs_pool()
        return fresh[0]

    # --------------------------------------------------------- rollback
    def truncate(self, slot: int, new_pos: int) -> None:
        """Roll the slot back to ``new_pos`` cached positions.

        This is the whole of speculative-decoding rollback: a rejected
        proposal tail is discarded by rewinding the position watermark —
        no block frees, no device copies.  Blocks were reserved for the
        request's full horizon at :meth:`admit`, positions at or beyond
        ``pos`` are unreachable (attention masks against the per-slot
        position), and the next accepted token simply overwrites the
        stale rows.  The one safety property worth asserting is that the
        discarded positions only ever lived in exclusively-owned blocks:
        the verify launch's write window must have gone through
        :meth:`ensure_writable` first, so a CoW-shared prefix block can
        never have been dirtied by a speculation that then failed."""
        pos = self.pos[slot]
        if not 0 <= new_pos <= pos:
            raise ValueError(
                f"truncate(slot={slot}) to {new_pos} outside [0, {pos}]")
        if new_pos < pos:
            for bi in range(new_pos // self.block_size,
                            cdiv(pos, self.block_size)):
                bid = self.tables[slot][bi]
                assert self.alloc.refcount(bid) == 1, \
                    (f"slot {slot} rolling back positions in shared "
                     f"block {bid} (refcount "
                     f"{self.alloc.refcount(bid)}) — a speculative "
                     "write skipped ensure_writable")
        self.pos[slot] = new_pos
        self.check_consistency()

    # ------------------------------------------------------- retirement
    def release(self, slot: int, prompt: Sequence[int] | None = None
                ) -> None:
        """Free the slot's blocks.  With prefix sharing on and the
        retiring request's ``prompt`` given, its full prompt blocks are
        retained in the prefix cache before the slot drops them."""
        n = self._owned[slot]
        table = self.tables[slot][:n]
        if self.prefix is not None and prompt is not None:
            self.prefix.insert(prompt, table)
        for bid in table:
            self.alloc.release(bid)
        self.tables[slot] = [NULL_BLOCK] * self.blocks_per_slot
        self._owned[slot] = 0
        self.pos[slot] = 0
        self.check_consistency()
        self._obs_pool()

    # ---------------------------------------------- cross-attention pool
    def _require_cross(self) -> BlockAllocator:
        if self.cross_alloc is None:
            raise RuntimeError("runtime built without a cross pool "
                               "(pass cross_len > 0)")
        return self.cross_alloc

    def _cross_padded(self, keys: Sequence[int]) -> list[int]:
        """Pad the per-frame fingerprint chain to whole blocks with a
        fixed sentinel, so match/insert/publish all hash identical
        chains even when ``cross_len % cross_block_size != 0``."""
        want = self.cross_blocks_per_slot * self.cross_block_size
        return list(keys) + [0] * (want - len(keys))

    def _alloc_cross_with_eviction(self, n: int) -> list[int] | None:
        alloc = self._require_cross()
        while alloc.num_free < n:
            if self.cross_prefix is None or not self.cross_prefix.evict_lru():
                return None
        return alloc.alloc(n)

    def admit_cross(self, slot: int, keys: Sequence[int]) -> bool | None:
        """Reserve the slot's encoder-KV span.  ``keys`` are per-frame
        content fingerprints (len == ``cross_len``).  Adoption is
        all-or-nothing — the encoder is non-causal, so a partial frame
        prefix has no reusable KV:

        * ``True`` — the *whole* chain was in the audio prefix cache;
          every block adopted read-only, the caller skips the encode.
        * ``False`` — fresh blocks allocated; the caller must encode.
        * ``None`` — pool pressure (caller requeues; nothing held).
        """
        alloc = self._require_cross()
        if self._cross_owned[slot]:
            raise RuntimeError(f"slot {slot} already holds cross blocks")
        if len(keys) != self.cross_len:
            raise ValueError(f"need {self.cross_len} frame keys, "
                             f"got {len(keys)}")
        need = self.cross_blocks_per_slot
        padded = self._cross_padded(keys)
        if self.cross_prefix is not None:
            shared = self.cross_prefix.match(padded, need)
            if len(shared) == need:          # full chain: adopt as-is
                self.cross_tables[slot] = list(shared)
                self._cross_owned[slot] = need
                self.cross_adopted[slot] = True
                self.check_consistency()
                self._obs_pool()
                return True
            for bid in shared:               # partial: useless, roll back
                alloc.release(bid)
            self.cross_prefix.hits -= len(shared)
        fresh = self._alloc_cross_with_eviction(need)
        if fresh is None:
            return None
        self.cross_tables[slot] = list(fresh)
        self._cross_owned[slot] = need
        self.cross_adopted[slot] = False
        self.check_consistency()
        self._obs_pool()
        return False

    def publish_cross(self, slot: int, keys: Sequence[int]) -> None:
        """Donate the slot's (fully encoded) cross chain to the audio
        prefix cache so later requests with the same audio adopt it.
        No-op without sharing or for an adopted (already published)
        chain; blocks stay read-only from here on."""
        if self.cross_prefix is None or self.cross_adopted[slot]:
            return
        table = self.cross_tables[slot][:self._cross_owned[slot]]
        self.cross_prefix.insert(self._cross_padded(keys), table)
        self._obs_pool()

    def release_cross(self, slot: int) -> None:
        """Drop the slot's cross-block references (published chains
        survive in the prefix cache, which holds its own reference)."""
        alloc = self._require_cross()
        for bid in self.cross_tables[slot][:self._cross_owned[slot]]:
            alloc.release(bid)
        self.cross_tables[slot] = [NULL_BLOCK] * self.cross_blocks_per_slot
        self._cross_owned[slot] = 0
        self.cross_adopted[slot] = False
        self.check_consistency()
        self._obs_pool()

    # ------------------------------------------------------------ stats
    @property
    def allocated_blocks(self) -> int:
        return self.num_blocks - 1 - self.alloc.num_free

    @property
    def allocated_cross_blocks(self) -> int:
        if self.cross_alloc is None:
            return 0
        return self.cross_num_blocks - 1 - self.cross_alloc.num_free

    def free_block_ids(self) -> list[int]:
        """Snapshot of currently free physical blocks (tests poison
        these to prove no stale reads)."""
        return list(self.alloc._free)

    def free_cross_block_ids(self) -> list[int]:
        """Free cross-pool blocks (same poisoning contract as
        :meth:`free_block_ids`, for the encoder-KV pool)."""
        return list(self._require_cross()._free)
