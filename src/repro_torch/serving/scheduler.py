"""Continuous-batching request scheduler.

A numpy copy of the reference package's `serving/scheduler.py`, cut to
the paths the port runs so far. Two execution models over the same
admission/eviction machinery:

  * chunked (token-budget) scheduling — every `step()` issues ONE
    fixed-shape dispatch of ``num_slots × c`` token positions, where each
    row is one slot's **token run**: a single decode token or a prefill
    chunk (a lone long prompt drains the whole idle budget across several
    rows). Rows declare their true run length and ``c`` is the smallest
    width bucket covering the longest run this step, so steps with only
    decode rows narrow to ``c = 1``. The first token is sampled in the
    same dispatch whose chunk commits the last prompt token. The width
    family stays bounded at O(log chunk) buckets.
  * one-shot scheduling — per-request prefill fused with page commit and
    first-token sampling at admission, then single-token decode over all
    slots.

Admission is FIFO within priority when a slot is free and the pager can
cover the request's worst-case KV footprint; EOS/budget eviction
backfills from the queue in the same `step()`.

Prefix sharing: a request with a ``prefix_id`` aliases the already
resident full pages whose content-hash chain matches its prompt (they
do not count against free capacity), and its chunking starts past them,
so aliased tokens are never recomputed. The prompt registers under its
namespace when its final chunk lands; while a slot with the same
namespace is still prefilling, the queue head waits, so it admits
against the full registered match.

SLO-aware preemption (``preemption=True``, chunked mode only):

  * `Request.priority` classes order the queue (higher first, FIFO within
    a class). When admission of a higher class would otherwise stall, the
    scheduler picks a **victim** among strictly-lower-priority active
    slots — lowest priority, then most pages held, then least progress —
    and spills it through `KVPager.spill` to the host tier (the engine's
    ``spill_fn`` gathers the evicted pages' bytes off the device first).
  * Preempted requests park in ``self.preempted`` with their full slot
    state (generated tokens, prefill progress). Re-admission prefers
    parked requests over the queue at equal-or-higher priority, and
    `restore` re-enters the chunk dispatch at the pager's commit
    watermark with **zero recompute**.
  * Under ``PagerConfig.optimistic`` admission the scheduler also runs a
    pre-dispatch **pressure check**: if this step's decode extends would
    drain the free pool, victims are spilled (same score) before packing,
    which keeps `extend` infallible at dispatch time.

Disaggregated serving (`serving.disagg`): a rid in ``handoff_rids``
parks its slot in ``ready_handoffs`` when its first token is sampled,
instead of decoding here, and `admit_handoff` adopts a shipped slot as an
already-decoding one.

Speculative decoding (linear and tree) is not ported yet; its
`SchedulerStats` counters are declared all the same (the reference's
full set, in its order) and stay 0.

The scheduler is device-agnostic: it talks to the engine through the
``run_batch`` (chunked) or ``prefill_commit`` + ``decode`` (one-shot)
callables and keeps only host-side state.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.serving.kv_pager import KVPager, SpillRecord


def width_family(chunk_size: int) -> list[int]:
    """Column-width buckets the token-budget packer may dispatch: powers
    of two up to ``chunk_size`` plus ``chunk_size`` itself, so rows are
    padded only to the smallest bucket covering the step's longest
    declared run."""
    widths = {1, chunk_size}
    w = 2
    while w < chunk_size:
        widths.add(w)
        w *= 2
    return sorted(widths)


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    tokens: np.ndarray            # [S] int32 prompt
    max_new_tokens: int
    temperature: float = 0.0      # 0 ⇒ greedy
    top_k: int = 0                # 0 ⇒ full softmax
    eos_id: int = -1              # -1 ⇒ never stops early
    prefix_id: str | None = None  # opt into prefix sharing (namespace key)
    priority: int = 0             # SLO class: higher admits/preempts lower


@dataclasses.dataclass
class _SlotState:
    request: Request
    generated: list[int]          # sampled tokens (empty while prefilling)
    committed: int = 0            # prompt tokens already run through

    @property
    def prefilling(self) -> bool:
        return self.committed < len(self.request.tokens)

    @property
    def next_pos(self) -> int:
        """Cache position where the next decode input token is written."""
        return len(self.request.tokens) + len(self.generated) - 1

    @property
    def done(self) -> bool:
        r = self.request
        return (len(self.generated) >= r.max_new_tokens
                or (r.eos_id >= 0 and bool(self.generated)
                    and self.generated[-1] == r.eos_id))


@dataclasses.dataclass
class _Preempted:
    """A spilled request parked off-device: scheduler state + the pager's
    spill record + the engine's opaque handle onto the host-tier bytes."""
    state: _SlotState
    record: SpillRecord
    handle: object
    seq: int                      # spill order (FIFO restore within class)


@dataclasses.dataclass
class SchedulerStats:
    admitted: int = 0
    finished: int = 0
    decode_steps: int = 0         # unified dispatches in chunked mode
    slot_tokens: int = 0          # useful tokens produced by decode rows
    slot_steps: int = 0           # total rows dispatched (incl. idle)
    prefix_shared_pages: int = 0  # pages aliased instead of allocated
    prefill_chunks: int = 0       # prompt chunks dispatched (chunked mode)
    prefill_tokens: int = 0       # prompt tokens run through the model
    #                               (counted on the chunked path only)
    prefill_tokens_skipped: int = 0   # aliased prompt tokens never re-run
    # --- speculative decoding (not ported: stay 0) -----------------------
    spec_rows: int = 0            # draft/verify runs dispatched
    draft_tokens: int = 0         # draft tokens proposed and verified
    accepted_tokens: int = 0      # draft tokens the target accepted
    rollbacks: int = 0            # verify runs that truncated the KV
    rollback_pages: int = 0       # pages returned to the free list by them
    # --- token-budget packing accounting --------------------------------
    dispatched_positions: int = 0     # num_slots × c summed over steps
    padded_positions: int = 0         # dispatched positions holding padding
    padded_positions_fixed: int = 0   # what padding the pre-run-length
    #                                   policy (c = chunk_size whenever
    #                                   anything prefills) would have paid
    # --- preemption / spill ---------------------------------------------
    preemptions: int = 0          # slots spilled to the host tier
    pressure_spills: int = 0      # of those, spills by the page-pressure
    #                               check (optimistic admission), not SLO
    restores: int = 0             # parked requests re-admitted
    spilled_pages: int = 0        # page strips gathered to the host tier
    restored_pages: int = 0       # page strips scattered back
    restore_time_s: float = 0.0   # wall time inside restore (pager +
    #                               device scatter), for restore latency

    def zero(self) -> None:
        """Reset every declared counter to its default, in place: the
        object keeps its identity (held references see the live
        counters), and fields without a default are left untouched."""
        for f in dataclasses.fields(self):
            if f.default is not dataclasses.MISSING:
                setattr(self, f.name, f.default)
            elif f.default_factory is not dataclasses.MISSING:
                setattr(self, f.name, f.default_factory())

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_tokens / max(self.draft_tokens, 1)

    @property
    def spec_tokens_per_row(self) -> float:
        """Mean tokens emitted per draft/verify run (accepted + the
        corrected/bonus token); 0 while nothing speculated."""
        return (self.accepted_tokens + self.spec_rows) / max(self.spec_rows,
                                                             1)

    @property
    def padding_waste(self) -> float:
        return self.padded_positions / max(self.dispatched_positions, 1)


class Scheduler:
    """Queue + slot bookkeeping over the engine's step functions.

    Pass ``run_batch`` for chunked (token-budget) scheduling, or both
    ``prefill_commit`` and ``decode`` for one-shot scheduling:

      * run_batch(tokens [B, C], pos [B, C], row_slots [B],
        sample_idx [B], temps [B], topks [B]) → sampled [B] — one
        fixed-shape dispatch that scatters every valid token's KV into
        the paged cache (row b reads/writes slot ``row_slots[b]``'s
        pages) and returns, per row, the token sampled at ``sample_idx``
        (consumed only for rows that finished their prompt or decoded).
      * prefill_commit(request, slot, pages, n_shared) → first token;
        decode(page_tables, token, pos, temps, topks) → next tokens.

    ``preemption=True`` (chunked only) enables victim spill to the host
    tier; ``spill_fn(phys_ids) → handle`` gathers the pages' bytes BEFORE
    the pager releases them and ``restore_fn(handle, fresh_ids)`` scatters
    them back (both None ⇒ host accounting only).
    """

    def __init__(self, pager: KVPager, *,
                 prefill_commit: Callable | None = None,
                 decode: Callable | None = None,
                 run_batch: Callable | None = None,
                 chunk_size: int = 16,
                 preemption: bool = False,
                 spill_fn: Callable | None = None,
                 restore_fn: Callable | None = None):
        self.pager = pager
        self.num_slots = pager.cfg.num_slots
        self.chunked = run_batch is not None
        if self.chunked:
            if chunk_size < 1:
                raise ValueError("chunk_size must be ≥ 1")
        elif prefill_commit is None or decode is None:
            raise ValueError("need run_batch (chunked) or "
                             "prefill_commit + decode (one-shot)")
        self._run_batch = run_batch
        self._prefill_commit = prefill_commit
        self._decode = decode
        self.chunk_size = chunk_size
        self.width_buckets = width_family(chunk_size)
        if preemption and not self.chunked:
            raise ValueError("preemption requires the chunked "
                             "(token-budget) execution path")
        if pager.cfg.optimistic and not preemption:
            raise ValueError("optimistic admission needs preemption as "
                             "its safety valve (extend can fail)")
        self.preemption = preemption
        self._spill_fn = spill_fn
        self._restore_fn = restore_fn
        self.queue: deque[Request] = deque()
        self.slots: dict[int, _SlotState] = {}
        self.preempted: list[_Preempted] = []
        self._preempt_seq = 0
        self.finished: dict[int, np.ndarray] = {}
        self.stats = SchedulerStats()
        # disaggregated serving: rids whose first sampled token PARKS the
        # slot for a cross-engine KV handoff instead of decoding here.
        # Parked slots leave `self.slots` but keep their pager pages until
        # the controller exports + frees them; they surface in
        # `ready_handoffs` as (state, slot).
        self.handoff_rids: set[int] = set()
        self.ready_handoffs: list[tuple[_SlotState, int]] = []

    # ------------------------------------------------------------------ api
    def submit(self, request: Request) -> None:
        if len(request.tokens) < 1:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be ≥ 1")
        # reject requests that could never be placed even on an idle engine —
        # otherwise they sit at the queue head forever and stall everything
        if not self.pager.fits(len(request.tokens), request.max_new_tokens):
            pc = self.pager.cfg
            raise ValueError(
                f"request rid={request.rid} exceeds engine capacity: "
                f"{len(request.tokens) + request.max_new_tokens - 1} KV "
                f"tokens vs slot capacity "
                f"{pc.pages_per_slot * pc.page_size} "
                f"({pc.num_pages - 1} usable pages)")
        # priority-ordered queue: insert before the first strictly-lower
        # class; equal priorities keep FIFO order (plain append)
        i = len(self.queue)
        while i > 0 and self.queue[i - 1].priority < request.priority:
            i -= 1
        self.queue.insert(i, request)

    def admit_handoff(self, request: Request, generated: list[int],
                      record) -> tuple[int, list[int], list[int]]:
        """Adopt a cross-engine KV handoff as an already-decoding slot.

        The pager re-places the shipped pages in this pool (aliasing any
        the prefix index already holds — see `KVPager.adopt`) and the
        slot enters with the prompt fully committed and ``generated``
        already sampled by the prefill side, so no prefill chunk is ever
        scheduled for it. Returns ``(slot, strip_indices, fresh_pages)``;
        the engine scatters wire strip ``strip_indices[j]`` into
        ``fresh_pages[j]``. Raises `PageAllocationError` (no mutation)
        when the pool is full — the caller retries on a later step.
        """
        if not self.chunked:
            raise ValueError("handoff adoption requires the chunked "
                             "(token-budget) execution path")
        generated = [int(t) for t in generated]
        if not generated:
            raise ValueError("a handoff must carry the first sampled token")
        slot, scatter = self.pager.adopt(
            record, max_new_tokens=request.max_new_tokens)
        st = _SlotState(request=request, generated=generated,
                        committed=len(request.tokens))
        if st.done:
            # nothing left to decode: undo the placement and refuse
            self.pager.free_slot(slot)
            raise ValueError("handoff request is already complete — "
                             "collect it on the prefill side")
        self.slots[slot] = st
        self.stats.admitted += 1
        self.stats.prefill_tokens_skipped += len(request.tokens)
        return slot, [i for i, _ in scatter], [pg for _, pg in scatter]

    @property
    def num_active(self) -> int:
        return len(self.slots)

    @property
    def idle(self) -> bool:
        return (not self.queue and not self.slots and not self.preempted
                and not self.ready_handoffs)

    def step(self) -> list[tuple[int, int]]:
        """Admit → one dispatch over all slots → evict + backfill.

        Returns ``(rid, token)`` stream events in emission order.
        """
        events: list[tuple[int, int]] = []
        self._admit(events)
        if self.slots:
            if self.chunked:
                self._step_chunked(events)
            else:
                self._decode_once(events)
            self._admit(events)          # backfill slots freed by EOS now
        return events

    def run(self) -> dict[int, np.ndarray]:
        """Drain queue + slots + parked requests; returns {rid: tokens}."""
        while not self.idle:
            before = (len(self.slots), len(self.preempted), len(self.queue))
            events = self.step()
            if not self.slots and not events and before == (
                    len(self.slots), len(self.preempted), len(self.queue)):
                raise RuntimeError(
                    "scheduler wedged: parked/queued requests cannot be "
                    "placed (pool exhausted by pins or kept shared pages)")
        out, self.finished = self.finished, {}
        return out

    # ------------------------------------------------------------ admission
    def _admit(self, events: list[tuple[int, int]]) -> None:
        """Place work on free slots, strictly by priority.

        Parked (preempted) requests take precedence over the queue within
        a priority class — they hold committed KV. When the next
        candidate cannot be placed and preemption is on, a
        strictly-lower-priority victim is spilled and placement retried;
        candidates of lower priority never leapfrog a stalled higher one.
        """
        while True:
            cand = min(self.preempted,
                       key=lambda p: (-p.state.request.priority, p.seq)) \
                if self.preempted else None
            head = self.queue[0] if self.queue else None
            if cand is not None and (
                    head is None
                    or cand.state.request.priority >= head.priority):
                if self._try_restore(cand):
                    continue
                if self.preemption and self._preempt_one(
                        below=cand.state.request.priority):
                    continue
                return
            if head is None:
                return
            req = head
            # chunked mode registers a prefix on its final chunk; while a
            # slot with the same namespace is still prefilling, hold the
            # queue head so it admits against the full registered match
            # instead of racing it to zero sharing
            if self.chunked and req.prefix_id is not None and any(
                    st.prefilling and st.request.prefix_id == req.prefix_id
                    for st in self.slots.values()):
                return
            # aliased resident pages don't count against free capacity
            shared = (self.pager.match_prefix(req.tokens, req.prefix_id)
                      if req.prefix_id is not None else [])
            if not self.pager.can_admit(len(req.tokens), req.max_new_tokens,
                                        n_shared=len(shared)):
                if self.preemption and self._preempt_one(below=req.priority):
                    continue
                return
            self._admit_head(req, shared, events)

    def _admit_head(self, req: Request, shared: list[int],
                    events: list[tuple[int, int]]) -> None:
        self.queue.popleft()                  # the head is ``req``
        slot, pages = self.pager.alloc_slot(len(req.tokens),
                                            req.max_new_tokens,
                                            shared_pages=shared)
        self.stats.prefix_shared_pages += len(shared)
        self.stats.admitted += 1
        if self.chunked:
            # aliased tokens are already resident: chunking starts past
            # them (at least the final prompt token always runs, so the
            # first-token logits exist even for a fully aliased prompt)
            skip = min(len(shared) * self.pager.cfg.page_size,
                       len(req.tokens) - 1)
            self.slots[slot] = _SlotState(request=req, generated=[],
                                          committed=skip)
            self.stats.prefill_tokens_skipped += skip
            return
        # one-shot: fused prefill + commit + first-token sample now
        tok = int(self._prefill_commit(req, slot, pages, len(shared)))
        if req.prefix_id is not None:
            self.pager.register_prefix(slot, req.tokens, req.prefix_id)
        st = _SlotState(request=req, generated=[tok],
                        committed=len(req.tokens))
        self.slots[slot] = st
        events.append((req.rid, tok))
        if st.done:
            self._finish(slot)

    # ------------------------------------------------- preemption machinery
    def _spill_slot(self, slot: int, *, pressure: bool = False) -> None:
        """Evict an active slot to the host tier, parking its state.

        Order matters: the engine's ``spill_fn`` enqueues the gather of
        the evicted pages' bytes BEFORE `KVPager.spill` releases those
        pages for reuse. The port's pools are updated in place, so the
        gather must be on the device's stream ahead of any later write
        into the released pages; the engine's stream order gives that.
        """
        st = self.slots.pop(slot)
        ids = self.pager.peek_spill(slot)
        handle = self._spill_fn(ids) \
            if (self._spill_fn is not None and ids) else None
        rec = self.pager.spill(slot)
        assert len(rec.spilled_pages) == len(ids)
        self.preempted.append(_Preempted(state=st, record=rec,
                                         handle=handle,
                                         seq=self._preempt_seq))
        self._preempt_seq += 1
        self.stats.preemptions += 1
        self.stats.spilled_pages += len(ids)
        if pressure:
            self.stats.pressure_spills += 1

    def _pick_victim(self, *, below: int | None,
                     keep_one: bool = False) -> int | None:
        """Victim choice: lowest priority, then most pages held (frees the
        most pool), then least progress. ``below`` restricts to strictly
        lower classes; ``keep_one`` never empties the active set
        (pressure relief must leave a slot to make progress)."""
        cand = [
            (st.request.priority, -len(self.pager.slot_pages[slot]),
             len(st.generated) / st.request.max_new_tokens, slot)
            for slot, st in self.slots.items()
            if below is None or st.request.priority < below]
        if not cand or (keep_one and len(self.slots) <= 1):
            return None
        return min(cand)[-1]

    def _preempt_one(self, *, below: int) -> bool:
        victim = self._pick_victim(below=below)
        if victim is None:
            return False
        self._spill_slot(victim)
        return True

    def _try_restore(self, p: _Preempted) -> bool:
        """Re-admit a parked request if capacity allows: pager restore,
        then the engine scatters the host-tier bytes into the fresh
        pages. The slot resumes exactly where it was spilled — the commit
        watermark came back with the record, so nothing re-prefills."""
        if not self.pager.can_restore(p.record):
            return False
        t0 = time.perf_counter()
        slot, fresh = self.pager.restore(p.record)
        if self._restore_fn is not None and p.handle is not None:
            self._restore_fn(p.handle, fresh)
        self.stats.restore_time_s += time.perf_counter() - t0
        self.stats.restores += 1
        self.stats.restored_pages += len(fresh)
        self.slots[slot] = p.state
        self.preempted.remove(p)
        return True

    def _relieve_pressure(self, drafts: dict[int, list[int]]) -> None:
        """Optimistic admission's safety valve, run before packing a
        chunked step: if the decode extends this step will draw more
        pages than the free pool holds, spill victims (any class — pool
        pressure outranks SLO) until the step fits. ``drafts`` is the
        reference's per-slot draft proposals, empty until speculation is
        ported."""
        if not self.pager.cfg.optimistic:
            return
        pager = self.pager
        while True:
            need = 0
            for slot, st in self.slots.items():
                if st.prefilling:
                    continue
                n = 1 + len(drafts.get(slot, ()))
                short = (pager.pages_for(st.next_pos + n)
                         - len(pager.slot_pages[slot]))
                if short > 0:
                    need += max(0, short - pager.slot_reserved.get(slot, 0))
            if need <= len(pager.free_pages) - pager._reserved:
                return
            victim = self._pick_victim(below=None, keep_one=True)
            if victim is None:
                return      # last slot: fits() guarantees the pool covers it
            drafts.pop(victim, None)
            self._spill_slot(victim, pressure=True)

    def preempt_request(self, rid: int) -> bool:
        """Spill the active slot serving ``rid`` (test/ops hook; organic
        preemption is priority-driven). Returns False when ``rid`` is not
        currently on a slot (queued, parked, finished, or unknown)."""
        if not self.preemption:
            raise ValueError("preemption is not enabled on this scheduler")
        for slot, st in self.slots.items():
            if st.request.rid == rid:
                self._spill_slot(slot)
                return True
        return False

    # ------------------------------------------- chunked (token-budget) step
    def _step_chunked(self, events: list[tuple[int, int]]) -> None:
        """One fixed-shape dispatch packing prefill chunks + decode rows.

        The dispatch is a ``[num_slots, c]`` token block — the step's
        token budget. Each decoding slot takes one row holding its single
        decode token; the remaining rows are handed to prefilling slots
        in admission order as consecutive chunks, so a lone long prompt
        drains the whole idle budget instead of one chunk per step. Rows
        carry their slot in ``row_slots`` (the executor gathers that
        slot's page-table row per dispatch row).
        """
        b = self.num_slots
        if self.preemption:
            # optimistic admission: make sure this step's extends fit the
            # free pool BEFORE packing rows (victims lose their row)
            self._relieve_pressure({})
            if not self.slots:
                return
        prefilling = [s for s, st in self.slots.items() if st.prefilling]
        want = 1
        if prefilling:
            want = max(min(self.chunk_size,
                           len(self.slots[s].request.tokens)
                           - self.slots[s].committed) for s in prefilling)
        c = next(w for w in self.width_buckets if w >= want)
        tokens = np.zeros((b, c), np.int32)
        pos = np.full((b, c), -1, np.int32)
        row_slots = np.zeros(b, np.int32)
        temps = np.zeros(b, np.float32)
        topks = np.zeros(b, np.int32)
        sample_idx = np.zeros(b, np.int32)
        sample_row: dict[int, int] = {}       # slot → row holding its sample
        chunk_tok: dict[int, int] = {}        # slot → prompt tokens this step
        row = 0
        for slot, st in self.slots.items():   # decode rows first
            if st.prefilling:
                continue
            r = st.request
            q = st.next_pos
            tokens[row, 0] = st.generated[-1]
            pos[row, 0] = q
            row_slots[row] = slot
            self.pager.extend(slot, q + 1)
            sample_row[slot] = row
            temps[row] = r.temperature
            topks[row] = r.top_k
            row += 1
        for slot in prefilling:               # pack chunks into free rows
            if row >= b:
                break
            st = self.slots[slot]
            r = st.request
            start = st.committed
            take = min(len(r.tokens) - start, (b - row) * c)
            done = 0
            while done < take:
                n = min(c, take - done)
                tokens[row, :n] = r.tokens[start + done:start + done + n]
                pos[row, :n] = np.arange(start + done, start + done + n)
                row_slots[row] = slot
                self.stats.prefill_chunks += 1
                done += n
                if start + done == len(r.tokens):
                    sample_row[slot] = row    # last chunk lands this step
                    sample_idx[row] = n - 1
                    temps[row] = r.temperature
                    topks[row] = r.top_k
                row += 1
            self.pager.commit_chunk(slot, start, start + take)
            chunk_tok[slot] = take
        valid = int((pos >= 0).sum())
        c_fixed = max(c, self.chunk_size) if prefilling else c
        self.stats.dispatched_positions += b * c
        self.stats.padded_positions += b * c - valid
        self.stats.padded_positions_fixed += b * c_fixed - valid
        sampled = self._run_batch(tokens, pos, row_slots, sample_idx,
                                  temps, topks)
        self.stats.decode_steps += 1
        self.stats.slot_steps += b
        for slot in list(self.slots):
            st = self.slots[slot]
            if slot in chunk_tok:
                st.committed += chunk_tok[slot]
                self.stats.prefill_tokens += chunk_tok[slot]
            row = sample_row.get(slot)
            if row is None or st.prefilling:
                continue                      # mid-prefill: nothing sampled
            if slot in chunk_tok and st.request.prefix_id is not None:
                # register on the final chunk: the whole prompt is resident
                self.pager.register_prefix(slot, st.request.tokens,
                                           st.request.prefix_id)
            first = slot in chunk_tok         # prompt completed this step
            tok = int(sampled[row])
            st.generated.append(tok)
            events.append((st.request.rid, tok))
            if not first:                     # a decode row, not a first token
                self.stats.slot_tokens += 1
            if st.done:
                self._finish(slot)
            elif first and st.request.rid in self.handoff_rids:
                # disagg handoff point: the prompt's KV is fully committed
                # and the first token is sampled — park the slot for
                # export instead of decoding here. The pager slot stays
                # live (pages intact) until the controller gathers its
                # bytes and frees it.
                self.slots.pop(slot)
                self.ready_handoffs.append((st, slot))

    # ------------------------------------------------- one-shot decode step
    def _decode_once(self, events: list[tuple[int, int]]) -> None:
        b = self.num_slots
        token = np.zeros(b, np.int32)
        pos = np.zeros(b, np.int32)
        temps = np.zeros(b, np.float32)
        topks = np.zeros(b, np.int32)
        for slot, st in self.slots.items():
            token[slot] = st.generated[-1]
            pos[slot] = st.next_pos
            temps[slot] = st.request.temperature
            topks[slot] = st.request.top_k
            self.pager.extend(slot, st.next_pos + 1)
        next_tokens = self._decode(self.pager.page_tables, token, pos,
                                   temps, topks)
        self.stats.decode_steps += 1
        self.stats.slot_steps += b
        for slot in list(self.slots):
            st = self.slots[slot]
            tok = int(next_tokens[slot])
            st.generated.append(tok)
            self.stats.slot_tokens += 1
            events.append((st.request.rid, tok))
            if st.done:
                self._finish(slot)

    def _finish(self, slot: int) -> None:
        st = self.slots.pop(slot)
        self.pager.free_slot(slot)
        self.finished[st.request.rid] = np.asarray(st.generated, np.int32)
        self.stats.finished += 1
