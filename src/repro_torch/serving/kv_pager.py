"""Paged KV cache: fixed-size pages, per-request page tables, alloc/free,
refcounted prefix sharing.

A numpy copy of the reference package's `serving/kv_pager.py` (the port
imports nothing of that package); the device pools live in
`repro_torch.models.attention`.

The dense decode cache sizes every request at ``max_seq`` — a 16-slot
engine at 32k context holds 512k tokens of KV even when serving 16
eight-token chats. Paging (vLLM-style, adapted to jit-stable JAX shapes)
splits KV into fixed ``page_size``-token pages drawn from a shared pool:

  * device side — per-layer pools ``[num_pages, P, Hkv, hd]`` (see
    `models.attention.init_paged_kv_cache`); decode scatters the new
    token's K/V into ``pool[table[slot, pos // P], pos % P]`` and reads by
    gathering ``pool[table[slot]]`` back into logical order. All shapes are
    fixed, so the jit'd decode step never re-specializes as requests come
    and go. Quantized pools (``kv_quant="int8"``) store int8 codes plus
    per-(position, head) float32 scale strips ``ks``/``vs``.
  * host side — `KVPager` owns the free list, the ``[num_slots,
    pages_per_slot]`` page tables, and a per-page **refcount**. Pages are
    normally owned by one slot; prefix sharing lets several slots alias
    the same read-only full pages (see below). **Page 0 is a reserved
    scratch page** that inactive slots keep writing into, which is what
    lets finished rows ride along in the fixed batch.

Prefix sharing (refcount + content-hash index):

  * requests submitted with a ``prefix_id`` participate in sharing. The
    pager keeps a chain-hash index: the key of logical page ``i`` is
    ``sha1(key(i-1) || tokens[i*P:(i+1)*P])``, seeded with the prefix_id —
    a hit means the exact same token prefix, so the page's committed KV is
    identical and can be aliased read-only (refcount += 1).
  * only **full** pages are ever shared. The partial tail page (prefix
    tokens + the request's own tokens) is always freshly allocated and
    privately rewritten by the aliasing request — copy-on-write resolved
    at admission time, since the token ranges that could ever be written
    later (decode positions ≥ prompt_len) never land in a shared page.
  * `free_slot` decrements refcounts and returns a page to the free list
    exactly once, when its last owner releases it; the index entry dies
    with the page.

Chunked prefill (incremental commit):

  * the chunked execution path writes a prompt's KV into the pool one
    fixed-size chunk at a time (quantize-on-commit per chunk inside the
    dispatch — same per-(position, head) codec as one-shot commit, so the
    pages are bit-identical). The pager tracks a per-slot **commit
    watermark** (`commit_chunk`): chunks must extend it contiguously,
    rewrites at or below it are allowed (the fully-aliased page-aligned
    prompt re-runs its final token through identical bytes), and aliased
    shared-prefix pages seed the watermark at admission — those tokens
    are **never recomputed**, which is what turns prefix sharing from a
    memory saving into a prefill-FLOPs saving.
  * reservation accounting is unchanged: `alloc_slot` still draws the
    prompt's pages up front and reserves the decode tail, so `extend`
    during decode cannot fail regardless of how the prompt is chunked.
  * `register_prefix` runs on the final chunk, once the whole prompt is
    resident.

Speculative-decode rollback (`truncate`):

  * a verify run writes k + 1 tokens of KV ahead of the sampled stream;
    when the target model rejects a draft suffix, `truncate(slot,
    new_len)` rewinds the slot's KV watermark, returns now-empty pages to
    the free list, and re-credits them to the slot's decode reservation
    (so a rolled-back slot can always re-extend to its admitted worst
    case). Aliased, pinned, or prefix-indexed pages are never rolled
    back — rollback targets sit at decode positions past the prompt, and
    the guards make that an invariant. Rejected-draft KV left between the
    new watermark and the old one is dead by construction: reads are
    causally masked to positions ≤ the query position, and the next
    accepted token rewrites its position before anything reads it.

Cross-engine page handoff (`export_slot` / `adopt` — disaggregated
prefill/decode, see `serving.disagg`):

  * `export_slot(slot)` is a **read-only** snapshot of an active slot for
    shipping to a *different* engine's pool: the physical page ids in
    logical order (every page ships — the target pool holds none of this
    pool's bytes) plus a `HandoffRecord` carrying the slot length, the
    commit watermark, and each page's prefix-index chain key (if any).
    The source engine gathers the ids' bytes (same jit'd gather as
    `peek_spill`), then frees the slot normally — functional arrays make
    the gathered strips immune to the release.
  * `adopt(record, max_new_tokens=...)` re-places the request in THIS
    pool: fresh physical pages are drawn for the shipped strips and the
    slot enters fully committed (decode resumes with **zero prefill
    recompute**). Pages whose chain key is already in this pool's prefix
    index are **aliased instead of transferred** (refcount += 1, zero
    wire bytes — the content hash guarantees identical bytes), and
    freshly transferred indexed pages re-register here exactly once, so
    a hot prefix is never duplicated no matter how many handoffs carry
    it; the sticky-pin semantics of `register_prefix` apply. Raises
    `PageAllocationError` without mutating anything when capacity is
    short — the caller retries later.

Cross-burst prefix pinning: `pin_prefix(prefix_id)` takes a refcount on
every page indexed under that namespace (and on pages registered under
it later), so a hot prefix survives its last owning request and the next
burst aliases it without recomputing — `unpin_prefix` releases the pin,
returning pages to the free list exactly once when no request holds them
either.

Admission control is conservative by default: a request is admitted only
if its worst-case footprint (prompt + max_new − 1 tokens, minus aliased
pages) can be covered by free plus already-reserved pages, so `extend`
during decode can never fail. With ``PagerConfig.optimistic`` the
reservation is dropped: admission only requires the prompt's pages (plus
one page of headroom) and `extend` draws straight from the free pool —
steady-state occupancy rises, and the scheduler's preemption + spill
machinery is the safety valve when the pool runs dry.

Preemption spill/restore (`spill` / `restore`):

  * `spill(slot)` evicts an active slot to a **host-memory tier**: pages
    the slot owns exclusively (refcount 1, not prefix-indexed) are
    released to the free list — the engine gathers their bytes to host
    first via `peek_spill` — while aliased/pinned/prefix-indexed pages
    are **never spilled**: they stay resident and shareable, with the
    returned `SpillRecord` holding the slot's refcount on them. The
    record also carries the slot's commit watermark, length and decode
    reservation, so a restore is a re-admission that skips prefill
    entirely.
  * `restore(record)` re-places the request in a (possibly different)
    free slot: fresh physical pages are drawn for the spilled logical
    pages (the engine scatters the host bytes back), kept pages reattach
    with their refcount transferred back, and the watermark/reservation
    come back exactly as spilled. Raises `PageAllocationError` without
    mutating anything when capacity is short — the caller retries later.
  * spill/truncate/free are mutually safe: a spilled slot is inactive,
    so `truncate`/`free_slot`/`commit_chunk`/`extend` on it raise before
    mutating (same hardening as the refcount-underflow guards), a
    double `spill` raises, and a `restore` of an already-restored or
    dropped record raises.

Device-side commit (the one-shot prefill path): `commit_prefill` writes
one request's dense prefill cache into the page pools, quantizing on
commit for int8 pools with the chunk step's codec (a windowed attention
layer has a pool too: the paged read masks what slid out of the window).
Per-slot state is written whole at the slot's row: MLA's latents
(``mla``), a windowed hymba layer's dense ring (``kv``, zero-padded past a
prompt shorter than the window) and an SSM layer's conv caches and state
(``ssm``), so nothing of the slot's previous occupant survives.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.models.attention import _kv_dequant, _kv_quantize


class PageAllocationError(RuntimeError):
    """Request cannot be placed: not enough free pages or slot capacity."""


@dataclasses.dataclass
class PagerConfig:
    num_pages: int        # total physical pages incl. the scratch page 0
    page_size: int        # tokens per page
    num_slots: int        # concurrent requests (decode batch size)
    pages_per_slot: int   # logical blocks per slot (slot capacity / P)
    # optimistic admission: admit on the prompt's pages alone (no decode
    # reservation); `extend` draws from the free pool and the scheduler's
    # preemption + spill machinery relieves pressure when it runs dry
    optimistic: bool = False


@dataclasses.dataclass(frozen=True)
class PagerStats:
    """Point-in-time occupancy snapshot of the page accounting.

    Page IDs are device-agnostic, so this is also the whole truth for a
    mesh-sharded engine — a physical page is striped across devices, but
    it is still ONE page here.
    """
    pages_total: int      # physical pages incl. the scratch page 0
    pages_free: int
    pages_used: int       # drawn from the pool (aliased pages count once)
    pages_aliased: int    # physical pages with more than one owner
    pages_pinned: int     # pages held resident by a pin_prefix namespace
    pages_reserved: int   # promised to active slots, not yet drawn
    logical_pages: int    # per-slot mappings (aliased count per owner)
    slots_active: int
    slots_free: int
    pages_spilled: int = 0   # logical pages parked in the host tier
    spill_records: int = 0   # preempted requests awaiting restore


@dataclasses.dataclass
class SpillRecord:
    """Host-tier image of one preempted slot's page accounting.

    ``layout`` preserves the slot's logical page order: ``("spilled", i)``
    entries point into the host-tier byte strips (``i`` is the gather
    order the engine used for `peek_spill`), ``("kept", pg)`` entries are
    aliased/pinned/prefix-indexed physical pages that never left the
    device — the record holds the slot's refcount on them, so they stay
    resident and shareable while the request is parked.
    """
    spill_id: int
    layout: list[tuple[str, int]]
    spilled_pages: list[int]   # original physical ids, gather order (dead
                               # after spill — bytes live in the host tier)
    slot_len: int              # tokens of valid KV at spill time
    committed: int             # chunked-prefill commit watermark
    reserved: int              # decode-tail reservation to re-take on restore
    restored: bool = False

    @property
    def n_spilled(self) -> int:
        return len(self.spilled_pages)


@dataclasses.dataclass
class HandoffRecord:
    """Pool-independent image of one slot for a cross-engine KV handoff
    (disaggregated prefill → decode, see `serving.disagg`).

    Unlike `SpillRecord` this carries no physical page ids — those are
    meaningless in the adopting pool. Per logical page it ships the
    prefix-index chain key + namespace (or None for unindexed pages) so
    the adopter can alias pages it already holds and re-register the
    rest, plus the slot length / commit watermark that make re-admission
    a pure decode resume (zero prefill recompute).
    """
    n_pages: int                                  # logical pages shipped
    page_meta: list[tuple[bytes, bytes] | None]   # (chain key, ns) per page
    slot_len: int                                 # tokens of valid KV
    committed: int                                # chunked-prefill watermark


def _chain_key(prev: bytes, chunk: np.ndarray) -> bytes:
    h = hashlib.sha1(prev)
    h.update(np.ascontiguousarray(chunk, np.int32).tobytes())
    return h.digest()


class KVPager:
    """Host-side page-table + free-list + refcount accounting (no device
    arrays)."""

    def __init__(self, cfg: PagerConfig):
        if cfg.num_pages < 2:
            raise ValueError("need ≥2 pages (page 0 is scratch)")
        self.cfg = cfg
        # LIFO free list: newly freed pages are reused first (cache-warm).
        self.free_pages: list[int] = list(range(cfg.num_pages - 1, 0, -1))
        self.free_slots: list[int] = list(range(cfg.num_slots - 1, -1, -1))
        self.page_tables = np.zeros((cfg.num_slots, cfg.pages_per_slot),
                                    np.int32)
        self.slot_pages: dict[int, list[int]] = {}
        self.slot_reserved: dict[int, int] = {}
        self.slot_len = np.zeros(cfg.num_slots, np.int64)
        self._reserved = 0   # pages promised to active slots, not yet drawn
        # per-page owner count: 0 = free, 1 = exclusive, >1 = prefix-shared
        self.page_ref = np.zeros(cfg.num_pages, np.int32)
        # chain-hash → physical page holding that exact token prefix chunk
        self.prefix_index: dict[bytes, int] = {}
        self._page_key: dict[int, bytes] = {}
        # chunked prefill: per-slot count of prompt tokens whose KV is
        # resident (aliased prefix tokens count — they were committed by
        # the request that registered them)
        self.slot_committed: dict[int, int] = {}
        # cross-burst pinning: namespace key → pages the pin refcounts
        self._page_ns: dict[int, bytes] = {}
        self._pinned_ns: set[bytes] = set()
        self._pin_pages: dict[bytes, set[int]] = {}
        # preemption: spill_id → SpillRecord for requests parked in the
        # host tier (spilled, not yet restored or dropped)
        self.spill_records: dict[int, SpillRecord] = {}
        self._next_spill_id = 0
        # bumped on every page-table mutation; lets the engine cache the
        # device copy of the tables instead of re-uploading each step
        self.version = 0

    # ------------------------------------------------------------- metrics
    @property
    def num_free_pages(self) -> int:
        return len(self.free_pages)

    @property
    def pages_in_use(self) -> int:
        """Physical pages drawn from the pool (aliased pages count once)."""
        return self.cfg.num_pages - 1 - len(self.free_pages)

    @property
    def logical_pages_in_use(self) -> int:
        """Sum of per-slot mapped pages (aliased pages count per owner)."""
        return sum(len(p) for p in self.slot_pages.values())

    @property
    def shared_pages(self) -> int:
        """Physical pages currently aliased by more than one slot."""
        return int((self.page_ref > 1).sum())

    @property
    def num_free_slots(self) -> int:
        return len(self.free_slots)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.cfg.page_size)

    def stats(self) -> PagerStats:
        """Structured occupancy snapshot (the engine folds this into its
        `GenerationEngine.stats()` surface — read that, not the raw
        counters)."""
        pinned: set[int] = set()
        for pages in self._pin_pages.values():
            pinned |= pages
        return PagerStats(
            pages_total=self.cfg.num_pages,
            pages_free=len(self.free_pages),
            pages_used=self.pages_in_use,
            pages_aliased=self.shared_pages,
            pages_pinned=len(pinned),
            pages_reserved=self._reserved,
            logical_pages=self.logical_pages_in_use,
            slots_active=len(self.slot_pages),
            slots_free=len(self.free_slots),
            pages_spilled=sum(r.n_spilled
                              for r in self.spill_records.values()),
            spill_records=len(self.spill_records))

    # ----------------------------------------------------------- lifecycle
    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Static check: could this request EVER be placed on an idle engine?

        Shared by `can_admit` and the scheduler's submit-time rejection so
        the two capacity rules cannot drift apart.
        """
        total = prompt_len + max_new_tokens - 1   # last token is never cached
        need = self.pages_for(total)
        return (need <= self.cfg.pages_per_slot
                and need <= self.cfg.num_pages - 1)

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  n_shared: int = 0) -> bool:
        if not (self.free_slots and self.fits(prompt_len, max_new_tokens)):
            return False
        if self.cfg.optimistic:
            # prompt pages now + one page of decode headroom; the decode
            # tail is NOT reserved — extend draws from the free pool and
            # preemption spills a victim when it runs dry
            need = self.pages_for(prompt_len) - n_shared
            if max_new_tokens > 1:
                need += 1
        else:
            total = prompt_len + max_new_tokens - 1
            need = self.pages_for(total) - n_shared
        return len(self.free_pages) - self._reserved >= need

    # ------------------------------------------------------- prefix sharing
    def match_prefix(self, tokens, prefix_id) -> list[int]:
        """Longest chain of already-committed full pages holding ``tokens``.

        Returns the physical pages (logical order) whose content-hash chain
        matches the prompt's full-page prefix under ``prefix_id``'s
        namespace. Only full pages match — the partial tail is never shared.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        p = self.cfg.page_size
        key = repr(prefix_id).encode()
        pages: list[int] = []
        for i in range(len(tokens) // p):
            key = _chain_key(key, tokens[i * p:(i + 1) * p])
            page = self.prefix_index.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def register_prefix(self, slot: int, tokens, prefix_id) -> int:
        """Index ``slot``'s committed full-prompt pages for future sharing.

        Idempotent per chunk: pages already indexed (including ones this
        slot aliased) are left alone. Returns the number of newly indexed
        pages.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        p = self.cfg.page_size
        ns = repr(prefix_id).encode()
        key = ns
        pages = self.slot_pages[slot]
        added = 0
        for i in range(len(tokens) // p):
            key = _chain_key(key, tokens[i * p:(i + 1) * p])
            if key not in self.prefix_index:
                self.prefix_index[key] = pages[i]
                self._page_key[pages[i]] = key
                self._page_ns[pages[i]] = ns
                added += 1
                if ns in self._pinned_ns:     # sticky pin: new pages join
                    self.page_ref[pages[i]] += 1
                    self._pin_pages[ns].add(pages[i])
        return added

    def pin_prefix(self, prefix_id) -> int:
        """Keep ``prefix_id``'s indexed pages resident across bursts.

        Takes one refcount on every page currently indexed under the
        namespace — and, stickily, on pages registered under it later —
        so the prefix-index entries survive their last owning request and
        the next burst aliases them without recomputing their KV.
        Returns the number of pages pinned now. Pinned pages count as in
        use: over-pinning shrinks the admission budget, so unpin cold
        prefixes.
        """
        ns = repr(prefix_id).encode()
        self._pinned_ns.add(ns)
        held = self._pin_pages.setdefault(ns, set())
        added = 0
        for pg, page_ns in self._page_ns.items():
            if page_ns == ns and pg not in held:
                self.page_ref[pg] += 1
                held.add(pg)
                added += 1
        return added

    def unpin_prefix(self, prefix_id) -> int:
        """Release a `pin_prefix` hold; pages with no owning request left
        return to the free list (exactly once — the pin was one owner).
        Returns the number of pages whose pin was released."""
        ns = repr(prefix_id).encode()
        self._pinned_ns.discard(ns)
        pages = self._pin_pages.pop(ns, set())
        for pg in pages:
            self._release_page(pg)
        if pages:
            self.version += 1
        return len(pages)

    def _release_page(self, pg: int) -> None:
        """Drop one refcount; free the page (and its index entry) at 0.

        The underflow check runs BEFORE any mutation: a double-free (or a
        release of a never-allocated page) raises without pushing the page
        onto the free list a second time, so the free list can never hold
        duplicates that would later alias two slots to one physical page.
        """
        if self.page_ref[pg] <= 0:
            raise RuntimeError(
                f"page {pg} refcount underflow (double free?): "
                f"ref={int(self.page_ref[pg])}")
        self.page_ref[pg] -= 1
        if self.page_ref[pg] == 0:
            self.free_pages.append(pg)
            key = self._page_key.pop(pg, None)
            if key is not None:
                self.prefix_index.pop(key, None)
            self._page_ns.pop(pg, None)

    def alloc_slot(self, prompt_len: int, max_new_tokens: int,
                   shared_pages: list[int] | None = None
                   ) -> tuple[int, list[int]]:
        """Place a request: returns (slot, physical pages for the prompt).

        ``shared_pages`` (from `match_prefix`) are aliased read-only
        (refcount += 1) instead of drawn from the free list; the remainder
        is freshly allocated. Reserves (but does not draw) the pages decode
        will need, so later `extend` calls cannot fail.
        """
        shared = list(shared_pages or [])
        if not self.can_admit(prompt_len, max_new_tokens,
                              n_shared=len(shared)):
            raise PageAllocationError(
                f"cannot admit prompt_len={prompt_len} "
                f"max_new={max_new_tokens}: free_slots={len(self.free_slots)}"
                f" free_pages={len(self.free_pages)} reserved={self._reserved}")
        total = self.pages_for(prompt_len + max_new_tokens - 1)
        now = self.pages_for(prompt_len)
        # validate the alias list BEFORE mutating any state: callers catch
        # PageAllocationError for capacity rejection, so an error path must
        # not leak the popped slot or partial refcount increments
        if len(shared) > now:
            raise PageAllocationError(
                f"{len(shared)} shared pages exceed the {now}-page prompt")
        for pg in shared:
            if self.page_ref[pg] < 1:
                raise PageAllocationError(f"aliasing unowned page {pg}")
        slot = self.free_slots.pop()
        for pg in shared:
            self.page_ref[pg] += 1
        fresh = [self.free_pages.pop() for _ in range(now - len(shared))]
        for pg in fresh:
            self.page_ref[pg] = 1
        pages = shared + fresh
        self.slot_pages[slot] = pages
        self.page_tables[slot, :now] = pages
        self.version += 1
        reserve = 0 if self.cfg.optimistic else total - now
        self.slot_reserved[slot] = reserve
        self._reserved += reserve
        self.slot_len[slot] = prompt_len
        # aliased prefix pages are already-committed content: chunked
        # prefill starts past them (their tokens are never recomputed)
        self.slot_committed[slot] = len(shared) * self.cfg.page_size
        return slot, pages

    def commit_chunk(self, slot: int, start: int, end: int) -> None:
        """Record that prompt tokens ``[start, end)`` of ``slot`` are now
        resident (the chunked dispatch scatters their K/V directly into
        the slot's pages).

        Chunks must extend the commit watermark contiguously; rewriting
        at or below it is allowed (a fully-aliased page-aligned prompt
        re-runs its final token, writing identical bytes). Pages were
        drawn at admission, so a chunk can never land on an unmapped
        page — reservation accounting is untouched.
        """
        if slot not in self.slot_pages:
            raise PageAllocationError(
                f"commit_chunk on inactive slot {slot} (spilled or freed?)")
        done = self.slot_committed[slot]
        if start > done:
            raise PageAllocationError(
                f"slot {slot}: chunk [{start}, {end}) leaves a gap past "
                f"the commit watermark {done}")
        if end > len(self.slot_pages[slot]) * self.cfg.page_size:
            raise PageAllocationError(
                f"slot {slot}: chunk end {end} beyond its mapped pages")
        self.slot_committed[slot] = max(done, end)

    def extend(self, slot: int, new_len: int) -> None:
        """Grow a slot's mapping to cover ``new_len`` tokens.

        Pages come from the slot's decode reservation (conservative
        admission — cannot fail) or, under ``optimistic`` admission,
        straight from the free pool — raising `PageAllocationError` on an
        empty pool, which the scheduler's pre-dispatch pressure relief is
        there to prevent.
        """
        if slot not in self.slot_pages:
            raise PageAllocationError(
                f"extend of inactive slot {slot} (spilled or freed?)")
        pages = self.slot_pages[slot]
        need = self.pages_for(new_len)
        if need > self.cfg.pages_per_slot:
            raise PageAllocationError(f"slot {slot} over capacity: {new_len}")
        while len(pages) < need:
            from_reserve = self.slot_reserved[slot] > 0
            if not from_reserve and not (self.cfg.optimistic
                                         and self.free_pages):
                raise PageAllocationError(
                    f"slot {slot} grew past its reservation ({new_len})"
                    if not self.cfg.optimistic else
                    f"slot {slot}: free pool exhausted at {new_len} tokens "
                    f"(optimistic admission needs preemption pressure relief)")
            page = self.free_pages.pop()
            self.page_ref[page] = 1
            self.page_tables[slot, len(pages)] = page
            pages.append(page)
            self.version += 1
            if from_reserve:
                self.slot_reserved[slot] -= 1
                self._reserved -= 1
        self.slot_len[slot] = max(int(self.slot_len[slot]), new_len)

    def truncate(self, slot: int, new_len: int) -> int:
        """Rewind ``slot``'s KV watermark to ``new_len`` tokens (KV
        rollback for rejected speculative drafts).

        Pages that become wholly empty return to the free list and rejoin
        the slot's decode reservation (the pages were drawn from it by
        `extend`, so admission accounting stays exact: a rolled-back slot
        can always re-extend to its admitted worst case). Returns the
        number of pages released.

        Guards — each raises `PageAllocationError` without mutating
        anything, because a partial rollback would corrupt the free list
        or shared state:

          * the slot must be active and ``new_len`` must not grow it;
          * rollback below the committed prompt is refused (speculative
            tokens only ever live at decode positions ≥ prompt length);
          * aliased/pinned shared-prefix pages are never rolled back: a
            page with other owners (refcount > 1) or a live prefix-index
            entry stays put (free-exactly-once is preserved — in practice
            such pages sit below the prompt watermark and are unreachable
            here; the guard makes that an invariant, not an accident).
        """
        if slot not in self.slot_pages:
            raise PageAllocationError(f"truncate of inactive slot {slot}")
        cur = int(self.slot_len[slot])
        if new_len > cur:
            raise PageAllocationError(
                f"slot {slot}: truncate to {new_len} > current {cur}")
        if new_len < max(self.slot_committed.get(slot, 0), 1):
            raise PageAllocationError(
                f"slot {slot}: truncate to {new_len} below the committed "
                f"prompt watermark {self.slot_committed.get(slot, 0)}")
        pages = self.slot_pages[slot]
        keep = self.pages_for(new_len)
        for pg in pages[keep:]:      # validate BEFORE mutating any state
            if self.page_ref[pg] != 1:
                raise PageAllocationError(
                    f"slot {slot}: page {pg} has {int(self.page_ref[pg])} "
                    f"owners — aliased/pinned pages are never rolled back")
            if pg in self._page_key:
                raise PageAllocationError(
                    f"slot {slot}: page {pg} is prefix-indexed — "
                    f"registered pages are never rolled back")
        released = 0
        while len(pages) > keep:
            pg = pages.pop()
            self._release_page(pg)
            self.page_tables[slot, len(pages)] = 0
            if not self.cfg.optimistic:   # optimistic extend drew from the
                self.slot_reserved[slot] += 1   # free pool, not a reserve
                self._reserved += 1
            released += 1
        if released:
            self.version += 1
        self.slot_len[slot] = new_len
        return released

    def free_slot(self, slot: int) -> None:
        """Release a finished request: refcount-- on every mapped page; a
        page returns to the free list exactly once, when its last owner
        (request or pin) lets go (its prefix-index entry dies with it).
        Freeing a slot that is not active (double free) raises."""
        if slot not in self.slot_pages:
            raise PageAllocationError(
                f"free of inactive slot {slot} (double free?)")
        for pg in self.slot_pages.pop(slot):
            self._release_page(pg)
        self._reserved -= self.slot_reserved.pop(slot, 0)
        self.slot_committed.pop(slot, None)
        self.page_tables[slot, :] = 0
        self.slot_len[slot] = 0
        self.free_slots.append(slot)
        self.version += 1

    # ------------------------------------------------- preemption spill tier
    def _spillable(self, pg: int) -> bool:
        """A page leaves the device only if this slot is its sole owner and
        no prefix-index entry could hand it to a future request."""
        return int(self.page_ref[pg]) == 1 and pg not in self._page_key

    def peek_spill(self, slot: int) -> list[int]:
        """Physical pages `spill(slot)` WOULD move to the host tier, in
        logical order — the engine gathers their bytes off the device
        before the accounting releases them for reuse."""
        if slot not in self.slot_pages:
            raise PageAllocationError(f"spill of inactive slot {slot}")
        return [pg for pg in self.slot_pages[slot] if self._spillable(pg)]

    def spill(self, slot: int) -> SpillRecord:
        """Evict an active slot to the host tier; the slot itself frees.

        Exclusive unindexed pages return to the free list (their bytes
        must already be gathered — see `peek_spill`); aliased, pinned and
        prefix-indexed pages stay resident, with the returned record
        inheriting the slot's refcount on them so sharing keeps working
        while the request is parked. The record snapshots slot length,
        commit watermark and decode reservation for an exact restore.
        Spilling an inactive (already spilled/freed) slot raises before
        mutating anything.
        """
        if slot not in self.slot_pages:
            raise PageAllocationError(f"spill of inactive slot {slot}")
        pages = self.slot_pages.pop(slot)
        layout: list[tuple[str, int]] = []
        spilled: list[int] = []
        for pg in pages:
            if self._spillable(pg):
                layout.append(("spilled", len(spilled)))
                spilled.append(pg)
                self._release_page(pg)
            else:                       # record inherits the slot's refcount
                layout.append(("kept", pg))
        rec = SpillRecord(
            spill_id=self._next_spill_id, layout=layout,
            spilled_pages=spilled, slot_len=int(self.slot_len[slot]),
            committed=self.slot_committed.pop(slot, 0),
            reserved=self.slot_reserved.pop(slot, 0))
        self._next_spill_id += 1
        self._reserved -= rec.reserved
        self.page_tables[slot, :] = 0
        self.slot_len[slot] = 0
        self.free_slots.append(slot)
        self.spill_records[rec.spill_id] = rec
        self.version += 1
        return rec

    def can_restore(self, rec: SpillRecord) -> bool:
        """Could `restore(rec)` succeed right now? Needs a free slot,
        fresh pages for every spilled strip, the record's reservation
        back, and (optimistic mode) one page of decode headroom."""
        if rec.restored or rec.spill_id not in self.spill_records:
            return False
        need = rec.n_spilled + rec.reserved
        if self.cfg.optimistic:
            need += 1
        return (bool(self.free_slots)
                and len(self.free_pages) - self._reserved >= need)

    def restore(self, rec: SpillRecord) -> tuple[int, list[int]]:
        """Re-admit a spilled request into a (possibly different) slot.

        Returns ``(slot, fresh_pages)`` where ``fresh_pages`` are the new
        physical pages for the spilled strips in gather order — the engine
        scatters the host-tier bytes into them. Kept pages reattach with
        the record's refcount transferred back to the slot. Raises
        `PageAllocationError` without mutating anything when capacity is
        short or the record was already restored/dropped.
        """
        if rec.restored or rec.spill_id not in self.spill_records:
            raise PageAllocationError(
                f"restore of dead spill record {rec.spill_id} "
                f"(already restored or dropped)")
        if not self.can_restore(rec):
            raise PageAllocationError(
                f"cannot restore spill {rec.spill_id}: needs "
                f"{rec.n_spilled}+{rec.reserved} pages, "
                f"free={len(self.free_pages)} reserved={self._reserved} "
                f"free_slots={len(self.free_slots)}")
        slot = self.free_slots.pop()
        fresh = [self.free_pages.pop() for _ in range(rec.n_spilled)]
        for pg in fresh:
            self.page_ref[pg] = 1
        pages = [fresh[ref] if tag == "spilled" else ref
                 for tag, ref in rec.layout]
        self.slot_pages[slot] = pages
        self.page_tables[slot, :len(pages)] = pages
        self.slot_len[slot] = rec.slot_len
        self.slot_committed[slot] = rec.committed
        self.slot_reserved[slot] = rec.reserved
        self._reserved += rec.reserved
        rec.restored = True
        del self.spill_records[rec.spill_id]
        self.version += 1
        return slot, fresh

    def drop_spill(self, rec: SpillRecord) -> None:
        """Abandon a parked request (cancelled while spilled): release the
        record's refcount on kept pages; host-tier bytes just die. Raises
        on a record already restored or dropped."""
        if rec.restored or rec.spill_id not in self.spill_records:
            raise PageAllocationError(
                f"drop of dead spill record {rec.spill_id}")
        for tag, ref in rec.layout:
            if tag == "kept":
                self._release_page(ref)
        rec.restored = True
        del self.spill_records[rec.spill_id]
        self.version += 1

    # -------------------------------------- cross-engine page handoff tier
    def export_slot(self, slot: int) -> tuple[HandoffRecord, list[int]]:
        """Read-only snapshot of an active slot for shipping to ANOTHER
        engine's pool (disaggregated prefill → decode handoff).

        Returns ``(record, phys_ids)`` with the physical pages in logical
        order. Every mapped page ships — unlike `peek_spill`, aliasing
        status in THIS pool is irrelevant because the target pool holds
        none of these bytes (the adopter dedups against its own prefix
        index instead, via the chain keys in the record). Nothing is
        mutated: the caller gathers the ids' bytes off the device and
        then releases the slot with the ordinary `free_slot` — the
        functional gathered arrays are immune to the release.
        """
        if slot not in self.slot_pages:
            raise PageAllocationError(f"export of inactive slot {slot}")
        pages = list(self.slot_pages[slot])
        meta: list[tuple[bytes, bytes] | None] = [
            (self._page_key[pg], self._page_ns[pg])
            if pg in self._page_key else None
            for pg in pages]
        return HandoffRecord(
            n_pages=len(pages), page_meta=meta,
            slot_len=int(self.slot_len[slot]),
            committed=self.slot_committed.get(slot, 0)), pages

    def _adopt_plan(self, rec: HandoffRecord
                    ) -> list[tuple[str, int]]:
        """Per logical page: ("alias", phys) when this pool's prefix index
        already holds the chain key, else ("fresh", strip_index)."""
        plan: list[tuple[str, int]] = []
        for i, m in enumerate(rec.page_meta):
            if m is not None and m[0] in self.prefix_index:
                plan.append(("alias", self.prefix_index[m[0]]))
            else:
                plan.append(("fresh", i))
        return plan

    def can_adopt(self, rec: HandoffRecord, max_new_tokens: int) -> bool:
        """Could `adopt(rec, ...)` succeed right now? Needs a free slot,
        fresh pages for every non-aliased strip, the decode-tail
        reservation (or optimistic headroom), and slot capacity."""
        total = max(rec.n_pages,
                    self.pages_for(rec.slot_len + max_new_tokens - 1))
        if not self.free_slots or total > self.cfg.pages_per_slot:
            return False
        n_fresh = sum(1 for tag, _ in self._adopt_plan(rec)
                      if tag == "fresh")
        if self.cfg.optimistic:
            need = n_fresh + (1 if max_new_tokens > 1 else 0)
        else:
            need = n_fresh + (total - rec.n_pages)
        return len(self.free_pages) - self._reserved >= need

    def adopt(self, rec: HandoffRecord, max_new_tokens: int
              ) -> tuple[int, list[tuple[int, int]]]:
        """Place an exported slot into THIS pool (the decode half of the
        disaggregated handoff).

        Returns ``(slot, scatter)`` where ``scatter`` is a list of
        ``(strip_index, fresh_page)`` pairs — the engine scatters those
        wire strips into the freshly drawn pages. Pages whose chain key
        is already in this pool's prefix index are **aliased** instead
        (refcount += 1, nothing scattered — the content hash guarantees
        identical bytes), and freshly scattered indexed pages re-register
        here with `register_prefix`'s sticky-pin semantics, so a hot
        prefix exists exactly once no matter how many handoffs carry it.
        The slot re-admits fully committed at the shipped watermark with
        the decode tail reserved as `alloc_slot` would — decode resumes
        with zero prefill recompute. Raises `PageAllocationError` without
        mutating anything when capacity is short (callers retry later).
        """
        if not self.can_adopt(rec, max_new_tokens):
            raise PageAllocationError(
                f"cannot adopt handoff ({rec.n_pages} pages, "
                f"slot_len={rec.slot_len}, max_new={max_new_tokens}): "
                f"free_slots={len(self.free_slots)} "
                f"free_pages={len(self.free_pages)} "
                f"reserved={self._reserved}")
        plan = self._adopt_plan(rec)
        total = max(rec.n_pages,
                    self.pages_for(rec.slot_len + max_new_tokens - 1))
        slot = self.free_slots.pop()
        pages: list[int] = []
        scatter: list[tuple[int, int]] = []
        for i, (tag, ref) in enumerate(plan):
            if tag == "alias":
                self.page_ref[ref] += 1
                pages.append(ref)
                continue
            pg = self.free_pages.pop()
            self.page_ref[pg] = 1
            pages.append(pg)
            scatter.append((i, pg))
            m = rec.page_meta[i]
            if m is not None:
                key, ns = m
                # first carrier of this prefix chunk registers it here;
                # later handoffs (and match_prefix admissions) alias it
                self.prefix_index[key] = pg
                self._page_key[pg] = key
                self._page_ns[pg] = ns
                if ns in self._pinned_ns:   # sticky pin: new pages join
                    self.page_ref[pg] += 1
                    self._pin_pages.setdefault(ns, set()).add(pg)
        self.slot_pages[slot] = pages
        self.page_tables[slot, :len(pages)] = pages
        self.slot_len[slot] = rec.slot_len
        self.slot_committed[slot] = rec.committed
        reserve = 0 if self.cfg.optimistic else total - rec.n_pages
        self.slot_reserved[slot] = reserve
        self._reserved += reserve
        self.version += 1
        return slot, scatter

    # ---------------------------------------------------------- invariants
    def verify_invariants(self) -> None:
        """Assert the global accounting invariants (test/debug hook; the
        property-based harness calls this after every rule).

        Checks: free-exactly-once (no duplicate free-list entries, free ⟺
        refcount 0), refcount conservation (every page's refcount equals
        its owner count across slots + pins + spill records' kept pages),
        reservation consistency, page-table mirrors, and watermark/length
        bounds per slot.
        """
        cfg = self.cfg
        free = set(self.free_pages)
        assert len(free) == len(self.free_pages), "free list holds duplicates"
        assert 0 not in free, "scratch page 0 on the free list"
        expected = np.zeros(cfg.num_pages, np.int64)
        for pages in self.slot_pages.values():
            for pg in pages:
                expected[pg] += 1
        for held in self._pin_pages.values():
            for pg in held:
                expected[pg] += 1
        for rec in self.spill_records.values():
            for tag, ref in rec.layout:
                if tag == "kept":
                    expected[ref] += 1
        for pg in range(1, cfg.num_pages):
            ref = int(self.page_ref[pg])
            assert ref == expected[pg], (
                f"page {pg}: refcount {ref} != owner count {expected[pg]}")
            assert (pg in free) == (ref == 0), (
                f"page {pg}: free-list membership disagrees with ref {ref}")
        assert self.pages_in_use == cfg.num_pages - 1 - len(free)
        assert self._reserved == sum(self.slot_reserved.values()) >= 0
        if not cfg.optimistic:
            assert len(free) >= self._reserved, "reservation not backed"
        active = set(self.slot_pages)
        assert active.isdisjoint(self.free_slots)
        assert len(self.free_slots) == len(set(self.free_slots))
        assert sorted(active | set(self.free_slots)) == \
            list(range(cfg.num_slots))
        for slot, pages in self.slot_pages.items():
            n = len(pages)
            assert n <= cfg.pages_per_slot
            cover = max(int(self.slot_len[slot]),
                        self.slot_committed.get(slot, 0))
            assert self.pages_for(cover) <= n, (
                f"slot {slot}: {cover} tokens not covered by {n} pages")
            assert list(self.page_tables[slot, :n]) == pages
            assert not self.page_tables[slot, n:].any()
        for slot in self.free_slots:
            assert not self.page_tables[slot].any()
            assert int(self.slot_len[slot]) == 0


# ---------------------------------------------------------------------------
# Device-side commit: dense per-request prefill cache → page pools
# ---------------------------------------------------------------------------

def _commit_paged_leaf(pool: torch.Tensor, pre: torch.Tensor,
                       phys_pages: torch.Tensor, page_size: int,
                       start_page: int = 0) -> None:
    """pre [1, S, ...] → scatter into pool [num_pages, P, ...] in place.

    ``start_page`` skips the leading aliased prefix pages: their content is
    already in the pool (committed by the request that registered the
    prefix) and they may be shared read-only with other slots.
    """
    s = pre.shape[1]
    skip = start_page * page_size
    if skip >= s:
        return
    pre = pre[0, skip:].to(pool.dtype)                    # [S - skip, ...]
    n = s - skip
    pages = phys_pages[start_page:]
    full, rem = divmod(n, page_size)
    if full:
        pool[pages[:full]] = pre[:full * page_size].reshape(
            (full, page_size) + tuple(pre.shape[1:]))
    if rem:
        pool[pages[full], :rem] = pre[full * page_size:]


def _adapt_kv_quant(pre_kv: dict, pool: dict) -> dict:
    """Bridge storage regimes between the dense prefill cache and the pool:
    int8 pool, float prefill → quantize on commit (the chunk step's
    per-(position, head) codec); float pool, int8 prefill → dequantize;
    matching regimes pass through."""
    pool_q, pre_q = "ks" in pool, "ks" in pre_kv
    if pool_q and not pre_q:
        k, ks = _kv_quantize(pre_kv["k"])
        v, vs = _kv_quantize(pre_kv["v"])
        return {"k": k, "v": v, "ks": ks, "vs": vs}
    if pre_q and not pool_q:
        return {"k": _kv_dequant(pre_kv["k"], pre_kv["ks"], pool["k"].dtype),
                "v": _kv_dequant(pre_kv["v"], pre_kv["vs"], pool["v"].dtype)}
    return pre_kv


def commit_prefill(cache, prefill_cache, slot, phys_pages, *,
                   page_size: int, start_page: int = 0):
    """Merge one request's prefill cache into the shared paged cache.

    ``cache``: `Model.init_paged_cache` ({seg: [per-layer entry]});
    ``prefill_cache``: the populated `Model.init_cache(1, prompt_len)`;
    ``phys_pages``: the slot's first ``pages_for(prompt_len)`` pages (a
    list or an int tensor); the first ``start_page`` of them are aliased
    prefix pages and are not rewritten. The pools update in place; the
    cache is returned, as the reference returns its new one. ``slot``
    addresses per-slot state, written in place as the reference writes it:
    an MLA layer's dense latents (``mla``), whose row ``slot`` takes the
    prompt's latents at positions 0..S-1; a windowed hymba layer's ring
    (``kv``), whose whole row takes the prefill's ring, zero-padded past
    a prompt shorter than the ring (`_commit_ring_leaf`); an SSM layer's
    conv caches and state (``ssm``), every leaf at ``slot``. Any other
    entry raises.

    A windowed layer's prefill cache is a ring of ``min(window, S)``
    slots (`attention.init_kv_cache`), and it is committed as the
    reference commits it: its slots go to the first ``min(window, S)``
    positions of the pages. For a prompt no longer than the window that
    is the prompt's KV in order; for a longer one the reference writes
    the ring's slot order and leaves the later positions unwritten, and
    the port does the same (held equal to the reference in
    `tests/test_torch_ring_cache.py`).
    """
    pages = None                      # one host→device copy per commit
    for seg, layers in cache.items():
        for i, entry in enumerate(layers):
            pre_entry = prefill_cache[seg][i]
            for kind_key, leaves in entry.items():
                if kind_key == "mla":     # dense per-slot latent cache
                    for k, leaf in leaves.items():
                        _commit_dense_leaf(leaf, pre_entry["mla"][k], slot)
                    continue
                if kind_key == "kv":      # sliding-window ring, per slot
                    for k, leaf in leaves.items():
                        _commit_ring_leaf(leaf, pre_entry["kv"][k], slot)
                    continue
                if kind_key == "ssm":     # per-slot recurrent state
                    for k, leaf in leaves.items():
                        leaf[slot] = pre_entry["ssm"][k][0].to(leaf.dtype)
                    continue
                if kind_key != "kv_pool":
                    raise ValueError(f"unknown cache entry {kind_key!r}")
                pre_kv = _adapt_kv_quant(pre_entry["kv"], leaves)
                if pages is None:
                    pages = torch.as_tensor(phys_pages, dtype=torch.long,
                                            device=leaves["k"].device)
                for k, pool in leaves.items():
                    _commit_paged_leaf(pool, pre_kv[k], pages, page_size,
                                       start_page=start_page)
    return cache


def _commit_dense_leaf(slot_cache: torch.Tensor, pre: torch.Tensor,
                       slot: int) -> None:
    """pre [1, S, ...] → slot row prefix of ``slot_cache [num_slots,
    S_max, ...]``, in place (MLA latents; a draft model's dense cache)."""
    s = pre.shape[1]
    slot_cache[slot, :s] = pre[0].to(slot_cache.dtype)


def _commit_ring_leaf(slot_cache: torch.Tensor, pre: torch.Tensor,
                      slot: int) -> None:
    """pre [1, S <= W, ...] (a prefill's ring) -> the whole row ``slot`` of
    ``slot_cache [num_slots, W, ...]``, in place. For S < W the prefill's
    ring holds position p at ring slot p; the rest of the row is zeroed,
    so the slot's previous occupant leaves nothing behind."""
    s = pre.shape[1]
    slot_cache[slot, :s] = pre[0].to(slot_cache.dtype)
    slot_cache[slot, s:] = 0
