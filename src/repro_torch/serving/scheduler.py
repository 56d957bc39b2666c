"""Continuous-batching request scheduler.

A numpy copy of the reference package's `serving/scheduler.py`. Two
execution models over the same admission/eviction machinery:

  * chunked (token-budget) scheduling — every `step()` issues ONE
    fixed-shape dispatch of ``num_slots × c`` token positions, where each
    row is one slot's **token run**: a single decode token, a speculative
    draft/verify run of up to ``spec_k + 1`` tokens, or a prefill chunk
    (a lone long prompt drains the whole idle budget across several
    rows). Rows declare their true run length and ``c`` is the smallest
    width bucket covering the longest run this step, so steps with only
    plain decode rows narrow to ``c = 1``. The first token is sampled in
    the same dispatch whose chunk commits the last prompt token. The
    width family stays bounded at O(log chunk + log spec_k) buckets.
  * one-shot scheduling — per-request prefill fused with page commit and
    first-token sampling at admission, then single-token decode over all
    slots.

Speculative decoding (chunked mode only) rides the token-run
generalization: a drafter proposes up to ``spec_k`` tokens per decoding
slot — the built-in **n-gram prompt-lookup self-drafter** (the slot's
own context predicts its continuation) or an engine-supplied
``draft_fn`` (a draft model) — and the slot's row becomes
``[last_token, d_1, …, d_k]`` at consecutive positions. One dispatch
verifies every draft in one weight pass; the executor returns how many
leading drafts the target accepted plus one corrected/bonus token, and
rejected suffixes roll the KV watermark back via `KVPager.truncate`.
Under ``spec_tree`` the drafts are token trees (a primary chain plus
alternate first tokens): each node sits at its own KV slot, its logical
position is its depth, and the row's ancestor closure is the attention
mask of its span; the executor walks the tree on the device and returns
the accepted branch. ``adaptive_spec_k`` walks the draft length (and
the tree's root fanout, the other way) from an EMA of the acceptance.

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
    pre-dispatch **pressure check**: if this step's decode/verify
    extends would drain the free pool, victims are spilled (same score)
    before packing, which keeps `extend` infallible at dispatch time.

Disaggregated serving (`serving.disagg`): a rid in ``handoff_rids``
parks its slot in ``ready_handoffs`` when its first token is sampled,
instead of decoding here, and `admit_handoff` adopts a shipped slot as an
already-decoding one.

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


def ngram_propose(ctx: np.ndarray, k: int, max_n: int = 3,
                  min_n: int = 1, window: int = 512) -> list[int]:
    """Prompt-lookup drafting: continue ``ctx`` by matching its suffix.

    Finds the longest suffix n-gram (``max_n`` down to ``min_n``) that
    occurred earlier in ``ctx`` and proposes up to ``k`` tokens that
    followed its most recent earlier occurrence. Returns ``[]`` when
    nothing matches — the slot falls back to plain single-token decode.
    This is the self-drafting mode: repetitive text (code, templated
    chat, lists) drafts itself with no second model.

    The match scans only the trailing ``window`` tokens, so per-step
    drafting cost is O(window), not O(context) — long streams don't turn
    the host-side drafter into a quadratic scan (recent context is also
    where the predictive repetition lives).
    """
    ctx = np.asarray(ctx)
    if window and len(ctx) > window:
        ctx = ctx[-window:]
    ln = len(ctx)
    for n in range(min(max_n, ln - 1), min_n - 1, -1):
        tail = ctx[ln - n:]
        # windows over ctx[:-1]: every match has at least one continuation
        # token, and the suffix itself (start ln - n) is never a candidate
        win = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
        hits = np.nonzero((win == tail).all(axis=1))[0]
        if len(hits):
            start = int(hits[-1]) + n          # most recent occurrence
            cont = ctx[start:start + k]
            if cont.size:
                return [int(t) for t in cont]
    return []


def ngram_propose_tree(ctx: np.ndarray, budget: int, fanout: int,
                       max_n: int = 3, min_n: int = 1,
                       window: int = 512) -> list[tuple[int, int]]:
    """Prompt-lookup drafting, tree-shaped: ``[(token, parent), …]``.

    Like `ngram_propose`, but instead of a single chain the proposal is a
    token TREE of at most ``budget`` nodes: a primary chain continued
    from the suffix's most recent earlier occurrence, plus up to
    ``fanout - 1`` depth-1 **alternate** first tokens taken from older
    occurrence sites whose continuations start differently. Each node is
    ``(token, parent)`` with ``parent`` the node index of its parent
    (``-1`` = the root, i.e. the slot's last sampled token); parents
    always precede children (topological order), which the device-side
    acceptance walk and the KV-slot layout both rely on. Alternates hedge
    the chain: when the target rejects the primary first token, a
    matching alternate still salvages one accepted token from the same
    weight pass. Returns ``[]`` when nothing matches.
    """
    ctx = np.asarray(ctx)
    if window and len(ctx) > window:
        ctx = ctx[-window:]
    ln = len(ctx)
    for n in range(min(max_n, ln - 1), min_n - 1, -1):
        tail = ctx[ln - n:]
        win = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
        hits = np.nonzero((win == tail).all(axis=1))[0]
        if not len(hits):
            continue
        start = int(hits[-1]) + n              # most recent occurrence
        first = int(ctx[start])
        # depth-1 alternates: older sites with DISTINCT first tokens
        alts: list[int] = []
        seen = {first}
        for h in hits[-2::-1]:
            if len(alts) >= fanout - 1:
                break
            t2 = int(ctx[int(h) + n])
            if t2 not in seen:
                seen.add(t2)
                alts.append(t2)
        chain_len = max(1, budget - len(alts))
        alts = alts[:budget - chain_len]
        chain = [int(t) for t in ctx[start:start + chain_len]]
        if not chain:
            continue
        nodes = [(chain[0], -1)]
        for i, t in enumerate(chain[1:]):
            nodes.append((t, i))               # chain: parent = predecessor
        nodes.extend((t, -1) for t in alts)    # alternates branch the root
        return nodes
    return []


def spec_k_buckets(spec_k_max: int) -> list[int]:
    """Draft-length buckets adaptive speculation moves through: powers of
    two up to ``spec_k_max``, plus ``spec_k_max`` itself. Bounded at
    O(log k), so the verify-width family stays bounded too."""
    ks = {1, spec_k_max}
    k = 2
    while k < spec_k_max:
        ks.add(k)
        k *= 2
    return sorted(ks)


def width_family(chunk_size: int, spec_k: int = 0) -> list[int]:
    """Column-width buckets the token-budget packer may dispatch.

    Powers of two up to ``chunk_size`` (plus ``chunk_size`` itself and,
    under speculative decoding, the verify-run width ``kb + 1`` for every
    draft-length bucket adaptive ``spec_k`` may visit), so the
    step-width family stays O(log chunk + log k) wide while rows are
    padded only to the smallest bucket covering the step's longest
    declared run — not unconditionally to the prefill chunk width.
    """
    widths = {1, chunk_size}
    w = 2
    while w < chunk_size:
        widths.add(w)
        w *= 2
    if spec_k:
        widths.update(kb + 1 for kb in spec_k_buckets(spec_k))
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
    # --- speculative decoding -------------------------------------------
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
        corrected/bonus token); 1.0 means drafting never helped."""
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
        Under speculative decoding the call carries an extra keyword
        ``n_draft [B]`` (draft tokens per row — the run is
        ``tokens[b, sample_idx[b] : sample_idx[b] + 1 + n_draft[b]]``)
        and must return ``(fix_tok [B], n_acc [B])``: the leading-accept
        count against the target distribution and the corrected (on
        rejection) or bonus (on full acceptance) token sampled at index
        ``n_acc``. Rows with ``n_draft == 0`` degenerate to the plain
        contract (``n_acc = 0``, ``fix_tok`` = the sampled token).
        Under ``spec_tree`` steps carrying at least one tree row add a
        keyword ``tree={"rpos", "amask", "parents"}`` (logical
        positions, per-row ancestor-closure visibility blocks, in-row
        parent indices) and must return ``(fix_tok, n_acc, path)`` with
        ``path [B, spec_k]`` the accepted branch's in-row node indices —
        the executor walks the tree on the device and compacts the
        winning branch's KV into contiguous slots before returning.
      * prefill_commit(request, slot, pages, n_shared) → first token;
        decode(page_tables, token, pos, temps, topks) → next tokens.

    ``spec_decode``: ``None`` (off), ``"ngram"`` (built-in prompt-lookup
    self-drafter), or ``"draft_fn"`` with a ``draft_fn`` callable
    ``[(slot, rid, ctx, next_pos, k_eff)] → {slot: [tokens]}`` (the
    engine's draft-model hook, or a custom drafter in tests). Draft
    length is capped per slot at ``min(spec_k, budget_left - 1)`` so a
    verify run can never write KV past the slot's admitted reservation.

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
                 spec_decode: str | None = None,
                 spec_k: int = 4,
                 adaptive_spec_k: bool = False,
                 spec_tree: bool = False,
                 spec_tree_fanout: int = 2,
                 draft_fn: Callable | None = None,
                 ngram_max: int = 3,
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
        if spec_decode not in (None, "ngram", "draft_fn"):
            raise ValueError(f"unknown spec_decode {spec_decode!r}")
        if spec_decode is not None:
            if not self.chunked:
                raise ValueError("speculative decoding requires the "
                                 "chunked (token-budget) execution path")
            if spec_k < 1:
                raise ValueError("spec_k must be ≥ 1")
            if spec_decode == "draft_fn" and draft_fn is None:
                raise ValueError("spec_decode='draft_fn' needs a draft_fn")
        if spec_tree:
            if spec_decode is None:
                raise ValueError("spec_tree needs a drafter "
                                 "(spec_decode='ngram' or 'draft_fn')")
            if spec_tree_fanout < 1:
                raise ValueError("spec_tree_fanout must be ≥ 1")
        self._run_batch = run_batch
        self._prefill_commit = prefill_commit
        self._decode = decode
        self.chunk_size = chunk_size
        self.spec_decode = spec_decode
        self.spec_k = spec_k              # max draft length (static cap)
        self._draft_fn = draft_fn
        self.ngram_max = ngram_max
        # adaptive draft length: walk spec_k_cur through the bucket family
        # {1, 2, 4, …, spec_k} from an EMA of the measured per-step
        # acceptance fraction. The verify dispatch always gathers
        # spec_k + 1 logits a row, so adapting k only changes the packed
        # row widths.
        self.adaptive_spec_k = adaptive_spec_k
        self.spec_k_cur = spec_k
        self._k_buckets = spec_k_buckets(spec_k)
        self._accept_ema: float | None = None
        # tree speculation: drafts become (token, parent) node lists and
        # the executor's device-side walk returns the deepest accepted
        # path. ``fanout_cur`` GROWS when acceptance is low (alternates
        # hedge a missing primary chain) and shrinks back toward 1 when
        # the chain keeps hitting.
        self.spec_tree = spec_tree
        self.spec_tree_fanout = spec_tree_fanout
        self.fanout_cur = min(spec_tree_fanout, 2) if spec_tree else 1
        self.width_buckets = width_family(
            chunk_size, spec_k if spec_decode is not None else 0)
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
        chunked step: if the decode/verify extends this step will draw
        more pages than the free pool holds, spill victims (any class —
        pool pressure outranks SLO) until the step fits. Victims lose
        their draft proposals along with their row."""
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

    # ---------------------------------------------------- speculative drafts
    def _propose_drafts(self) -> dict:
        """Per decoding slot, up to ``spec_k`` draft tokens for this step.

        Draft length is capped at the slot's remaining budget minus one
        (the corrected/bonus token), so a verify run never writes KV past
        position ``prompt + max_new − 2`` — inside the reservation
        `alloc_slot` already holds, which is what keeps `extend` for
        verify runs infallible. Empty proposals fall back to plain
        decode rows.

        Under ``spec_tree`` proposals are ``[(token, parent), …]`` node
        lists (parent = node index, ``-1`` = root) with the same total
        node cap — a tree occupies one KV slot per node, so the budget
        argument is identical. A ``draft_fn`` drafter receives an extra
        trailing ``fanout`` element per request and must return node
        lists in topological order (parents before children).
        """
        tree = self.spec_tree
        out: dict = {}
        reqs: list[tuple] = []
        caps: dict[int, int] = {}
        for slot, st in self.slots.items():
            if st.prefilling:
                continue
            r = st.request
            k_eff = min(self.spec_k_cur,
                        r.max_new_tokens - len(st.generated) - 1)
            if k_eff <= 0:
                continue
            ctx = np.concatenate([r.tokens,
                                  np.asarray(st.generated, np.int32)])
            if self.spec_decode == "ngram":
                prop = (ngram_propose_tree(ctx, k_eff, self.fanout_cur,
                                           self.ngram_max) if tree
                        else ngram_propose(ctx, k_eff, self.ngram_max))
                if prop:
                    out[slot] = prop
            else:
                reqs.append((slot, r.rid, ctx, st.next_pos, k_eff,
                             self.fanout_cur) if tree
                            else (slot, r.rid, ctx, st.next_pos, k_eff))
                caps[slot] = k_eff
        if reqs:
            for slot, prop in (self._draft_fn(reqs) or {}).items():
                cap = caps.get(slot, 0)
                if tree:
                    prop = [(int(t), int(par)) for t, par in prop][:cap]
                    if any(par >= i for i, (_, par) in enumerate(prop)):
                        raise ValueError(
                            f"draft_fn returned a non-topological tree "
                            f"for slot {slot}: every parent index must "
                            f"precede its child")
                else:
                    prop = [int(t) for t in prop][:cap]
                if prop:
                    out[slot] = prop
        return out

    # ------------------------------------------- chunked (token-budget) step
    def _step_chunked(self, events: list[tuple[int, int]]) -> None:
        """One fixed-shape dispatch packing prefill chunks + token runs.

        The dispatch is a ``[num_slots, c]`` token block — the step's
        token budget. Each decoding slot takes one row holding its token
        run (the single decode token, or ``[last, d_1 … d_k]`` for a
        speculative verify run at consecutive positions); the remaining
        rows are handed to prefilling slots in admission order as
        consecutive chunks, so a lone long prompt drains the whole idle
        budget instead of one chunk per step. Rows carry their slot in
        ``row_slots`` (the executor gathers that slot's page-table row
        per dispatch row).

        Every row declares its true run length and ``c`` is the smallest
        width bucket covering the longest one (a prefilling slot wants
        ``min(chunk_size, remaining)``) — decode rows are no longer
        padded to the prefill chunk width when only a short tail chunk
        is in flight, and pure-decode steps narrow to ``c = 1`` (or the
        verify-run bucket). The widths stay within `width_family`.
        """
        b = self.num_slots
        drafts = self._propose_drafts() if self.spec_decode is not None \
            else {}
        if self.preemption:
            # optimistic admission: make sure this step's extends fit the
            # free pool BEFORE packing rows (victims lose their row)
            self._relieve_pressure(drafts)
            if not self.slots:
                return
        prefilling = [s for s, st in self.slots.items() if st.prefilling]
        want = 1
        for slot, st in self.slots.items():
            if not st.prefilling:
                want = max(want, 1 + len(drafts.get(slot, ())))
        if prefilling:
            want = max(want, max(
                min(self.chunk_size,
                    len(self.slots[s].request.tokens)
                    - self.slots[s].committed) for s in prefilling))
        c = next(w for w in self.width_buckets if w >= want)
        tokens = np.zeros((b, c), np.int32)
        pos = np.full((b, c), -1, np.int32)
        row_slots = np.zeros(b, np.int32)
        temps = np.zeros(b, np.float32)
        topks = np.zeros(b, np.int32)
        sample_idx = np.zeros(b, np.int32)
        n_draft = np.zeros(b, np.int32)
        sample_row: dict[int, int] = {}       # slot → row holding its sample
        chunk_tok: dict[int, int] = {}        # slot → prompt tokens this step
        run_q: dict[int, int] = {}            # slot → base pos of its run
        row_draft: dict[int, list] = {}       # slot → drafts in its run
        tree_rows: dict[int, tuple] = {}      # row → packed tree metadata
        row = 0
        for slot, st in self.slots.items():   # decode/verify rows first
            if st.prefilling:
                continue
            r = st.request
            d = drafts.get(slot, [])
            n = 1 + len(d)
            q = st.next_pos
            tokens[row, 0] = st.generated[-1]
            if d and self.spec_tree:
                # tree verify row: node i sits at KV slot q + 1 + i (the
                # pager's extend/truncate stay contiguous), its LOGICAL
                # position is q + depth(i) (siblings share a depth, not a
                # slot), and the ancestor closure becomes the row's
                # intra-chunk visibility block
                tokens[row, 1:n] = [t for t, _ in d]
                dep = np.zeros(n, np.int32)
                anc = np.zeros((n, n), bool)
                anc[0, 0] = True
                par_inrow = np.full(n, -1, np.int32)
                for i, (_t, par) in enumerate(d):
                    j = 1 + i
                    pj = 1 + par if par >= 0 else 0
                    par_inrow[j] = pj
                    dep[j] = dep[pj] + 1
                    anc[j] = anc[pj]
                    anc[j, j] = True
                tree_rows[row] = (n, q, dep, anc, par_inrow)
            elif d:
                tokens[row, 1:n] = d
            pos[row, :n] = np.arange(q, q + n)
            row_slots[row] = slot
            self.pager.extend(slot, q + n)
            sample_row[slot] = row
            run_q[slot] = q
            row_draft[slot] = d
            n_draft[row] = len(d)
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
        path_arr = None
        if self.spec_decode is None:
            sampled = self._run_batch(tokens, pos, row_slots, sample_idx,
                                      temps, topks)
            fix_tok, n_acc = sampled, np.zeros(b, np.int32)
        elif tree_rows:
            # tree verify: rpos carries logical (depth) positions, amask
            # the per-row ancestor closure (plain causality elsewhere),
            # parents the in-row walk topology. The executor returns the
            # deepest accepted path as in-row node indices.
            rpos = pos.copy()
            amask = np.broadcast_to(np.tril(np.ones((c, c), bool)),
                                    (b, c, c)).copy()
            parents = np.full((b, c), -1, np.int32)
            for trow, (n, q, dep, anc, par_inrow) in tree_rows.items():
                rpos[trow, :n] = q + dep
                amask[trow] = False
                amask[trow, :n, :n] = anc
                parents[trow, :n] = par_inrow
            fix_tok, n_acc, path_arr = self._run_batch(
                tokens, pos, row_slots, sample_idx, temps, topks,
                n_draft=n_draft,
                tree={"rpos": rpos, "amask": amask, "parents": parents})
        else:
            fix_tok, n_acc = self._run_batch(tokens, pos, row_slots,
                                             sample_idx, temps, topks,
                                             n_draft=n_draft)
        self.stats.decode_steps += 1
        self.stats.slot_steps += b
        step_drafted = step_accepted = 0
        for slot in list(self.slots):
            st = self.slots[slot]
            if slot in chunk_tok:
                st.committed += chunk_tok[slot]
                self.stats.prefill_tokens += chunk_tok[slot]
            row = sample_row.get(slot)
            if row is None or st.prefilling:
                continue                      # mid-prefill: nothing sampled
            first = slot in chunk_tok         # prompt completed this step
            if first and st.request.prefix_id is not None:
                # register on the final chunk: the whole prompt is resident
                self.pager.register_prefix(slot, st.request.tokens,
                                           st.request.prefix_id)
            if first:
                tok = int(fix_tok[row])
                st.generated.append(tok)
                events.append((st.request.rid, tok))
                if st.done:
                    self._finish(slot)
                elif st.request.rid in self.handoff_rids:
                    # disagg handoff point: the prompt's KV is fully
                    # committed and the first token is sampled — park the
                    # slot for export instead of decoding here. The pager
                    # slot stays live (pages intact) until the controller
                    # gathers its bytes and frees it.
                    self.slots.pop(slot)
                    self.ready_handoffs.append((st, slot))
                continue
            # decode / verify row: emit the accepted draft prefix plus the
            # corrected (rejection) or bonus (full-acceptance) token,
            # stopping at EOS / budget mid-run. Tree rows read the
            # accepted tokens off the returned path (in-row node indices,
            # deepest accepted branch); linear rows off the draft prefix.
            d = row_draft.get(slot, [])
            na = min(int(n_acc[row]), len(d))
            if self.spec_tree and d:
                emit = [d[int(path_arr[row, t]) - 1][0] for t in range(na)]
            else:
                emit = d[:na]
            for tok in emit + [int(fix_tok[row])]:
                st.generated.append(tok)
                events.append((st.request.rid, tok))
                self.stats.slot_tokens += 1
                if st.done:
                    break
            if d:
                self.stats.spec_rows += 1
                self.stats.draft_tokens += len(d)
                self.stats.accepted_tokens += na
                step_drafted += len(d)
                step_accepted += na
            if st.done:
                self._finish(slot)
            elif na < len(d):
                # rejected suffix: roll the KV watermark (and any pages
                # drawn for it) back so the cache matches the stream
                self.stats.rollbacks += 1
                self.stats.rollback_pages += self.pager.truncate(
                    slot, run_q[slot] + na + 1)
        if self.adaptive_spec_k and step_drafted:
            self._adapt_spec_k(step_accepted / step_drafted)

    # EMA half-life of one drafting step; hysteresis band so k doesn't
    # flap on a borderline drafter (one bucket move per step, at most)
    _EMA_ALPHA = 0.5
    _SHRINK_BELOW = 0.35
    _GROW_ABOVE = 0.65

    def _adapt_spec_k(self, frac: float) -> None:
        """Fold one step's acceptance fraction into the EMA and move
        ``spec_k_cur`` one bucket within {1, 2, 4, …, spec_k}."""
        a = self._EMA_ALPHA
        self._accept_ema = frac if self._accept_ema is None \
            else (1 - a) * self._accept_ema + a * frac
        i = self._k_buckets.index(self.spec_k_cur)
        if self._accept_ema < self._SHRINK_BELOW and i > 0:
            self.spec_k_cur = self._k_buckets[i - 1]
        elif self._accept_ema > self._GROW_ABOVE \
                and i + 1 < len(self._k_buckets):
            self.spec_k_cur = self._k_buckets[i + 1]
        if self.spec_tree:
            # tree shape rides the same EMA in the opposite direction:
            # a missing drafter earns more hedging (wider root fanout), a
            # hitting one hands the node budget back to chain depth
            if self._accept_ema < self._SHRINK_BELOW:
                self.fanout_cur = min(self.fanout_cur + 1,
                                      self.spec_tree_fanout)
            elif self._accept_ema > self._GROW_ABOVE:
                self.fanout_cur = max(self.fanout_cur - 1, 1)

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
