"""Disaggregated prefill/decode serving.

A copy of the reference package's `serving/disagg.py`. The source
paper's second idea (after AWQ) is hybrid execution: route compute-bound
work to the FPGA, keep light work on the CPU. The serving-fleet analog
splits the two phases of generation the same way — prefill is
compute-bound (S×ctx score work per admitted token), decode is
bandwidth-bound (full weight stream + whole cache line per emitted
token) — and runs them as SEPARATE engines with different batch shapes:

  * `PrefillEngine` — a `GenerationEngine` configured for pure chunked
    prefill (prefix sharing and AWQ weights work; speculation is off —
    it never decodes). When a marked request samples its first token,
    the scheduler PARKS the slot instead of decoding, and the engine
    exports the slot's committed pages + watermark + first token as a
    `KVHandoff`: the pager snapshot (`KVPager.export_slot`) plus a
    page-strip gather (the preemption tier's movers — int8 pools ship
    codes + scale strips, ~2× fewer wire bytes than bf16).
  * `DecodeEngine` — a `GenerationEngine` that ADOPTS handoffs into its
    own pool: fresh physical pages, scatter restore, and a re-admission
    that skips prefill entirely — the decode-side TTFT is pure transfer
    cost. Pages whose content-hash chain key is already in its prefix
    index are aliased instead of transferred. It keeps every engine
    knob, speculation included: adopted slots decode with n-gram,
    draft-model or tree verify rows like any other.
  * `DisaggController` — owns both engines behind the ordinary
    `submit()/step()/collect()/drain()` API. Placement follows the
    roofline split policy (`roofline.costmodel.disagg_report`): prompts
    past the predicted convoy crossover go through the prefill engine,
    short interactive traffic is served unified-style by the decode
    engine.

On one card both engines share the weights and the device's stream;
each holds its own page pools. Each side may run its own ``model`` mesh
(``prefill_mesh`` / ``decode_mesh``, tensor parallelism as in
`GenerationEngine(mesh=...)`): a handoff's strips leave the prefill mesh
whole (KV heads joined) and re-stripe over the decode mesh on adopt, so
the wire image carries no trace of either mesh and its bytes are the
unsharded pair's. Greedy streams through the controller are
token-identical to the unified engine's.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serving.engine import GenerationEngine, SamplerConfig
from repro_torch.serving.kv_pager import HandoffRecord, PageAllocationError
from repro_torch.serving.scheduler import Request

# constructor kwargs stripped from the prefill side: it parks at the
# first sampled token, so drafting/verification machinery would only
# widen its dispatches for nothing
_SPEC_KWARGS = ("spec_decode", "spec_k", "spec_ngram_max", "spec_adaptive",
                "spec_tree", "spec_tree_fanout", "draft_model",
                "draft_params", "draft_fn")


@dataclasses.dataclass
class KVHandoff:
    """One request's KV image in flight between engines.

    ``handle`` is the source engine's gather (its device→host copy may
    still be running); `PrefillEngine.wire` (or the controller)
    materializes ``strips`` — host numpy trimmed to the real page count —
    and the decode side scatters the non-aliased subset into its own pool.
    """
    request: Request             # prefill-side request (rid = source rid)
    generated: list[int]         # tokens already sampled (the first token)
    record: HandoffRecord        # pager metadata: page keys + watermark
    handle: dict | None          # gathered strips (source engine)
    strips: dict | None = None   # host wire image, set by wire()
    wire_bytes: int = 0


@dataclasses.dataclass
class DisaggStats:
    handoffs: int = 0            # requests adopted by the decode engine
    handoff_pages: int = 0       # logical pages shipped
    aliased_pages: int = 0       # shipped pages the decode pool already
                                 # held (prefix index hit — zero wire cost)
    wire_bytes: int = 0          # host-side bytes actually transferred
    adopt_time_s: float = 0.0    # wire + scatter + re-admission wall time
                                 # (the decode-side TTFT-as-transfer cost)
    direct: int = 0              # requests served whole by the decode side
    prefill_step_time_s: float = 0.0   # wall inside prefill dispatches
    decode_step_time_s: float = 0.0    # wall inside decode dispatches


class PrefillEngine:
    """The prefill half of a disaggregated pair.

    Wraps a `GenerationEngine` forced onto the chunked path with
    speculation stripped. `submit` marks every request for handoff:
    the first sampled token parks the slot, and `collect_handoffs`
    exports parked slots as `KVHandoff`s (the device→host copy runs
    without blocking — call `wire` to materialize, ideally after
    dispatching decode-side work). ``mesh`` shards it as the engine's
    does.
    """

    def __init__(self, model, params, *, mesh=None, **kw):
        for k in _SPEC_KWARGS:
            kw.pop(k, None)
        kw.pop("chunked_prefill", None)
        self.engine = GenerationEngine(model, params, mesh=mesh,
                                       chunked_prefill=True, **kw)

    def submit(self, tokens, max_new_tokens: int,
               sampler: SamplerConfig | None = None,
               eos_id: int | None = None, prefix_id: str | None = None,
               priority: int = 0) -> int:
        """Queue one request for prefill-then-handoff; returns its rid.

        The request carries its TRUE ``max_new_tokens`` (the decode side
        needs it, and the prefill pager reserves against it so the
        handoff can never strand an unplaceable slot) — but at most one
        token is ever decoded here: EOS-on-first-token finishes locally
        (collect it from `collect`), everything else parks for export.
        """
        rid = self.engine.submit(tokens, max_new_tokens, sampler=sampler,
                                 eos_id=eos_id, prefix_id=prefix_id,
                                 priority=priority)
        self.engine._scheduler.handoff_rids.add(rid)
        return rid

    def step(self) -> list[tuple[int, int]]:
        return self.engine.step()

    def collect(self):
        """Requests that finished HERE (EOS or budget at first token)."""
        return self.engine.collect()

    def collect_handoffs(self) -> list[KVHandoff]:
        """Export every slot parked since the last call.

        Per slot: pager snapshot, page-strip gather, then the slot frees —
        the gather is on the device's stream ahead of any later write into
        the released pages, so the release can't corrupt it. The returned
        handoffs are NOT yet wired; `wire` blocks on the device→host copy.
        """
        sched = self.engine._scheduler
        if sched is None or not sched.ready_handoffs:
            return []
        out = []
        while sched.ready_handoffs:
            st, slot = sched.ready_handoffs.pop(0)
            rec, phys = sched.pager.export_slot(slot)
            handle = self.engine.handoff_gather(phys)
            sched.pager.free_slot(slot)
            sched.handoff_rids.discard(st.request.rid)
            out.append(KVHandoff(request=st.request,
                                 generated=list(st.generated),
                                 record=rec, handle=handle))
        return out

    def wire(self, h: KVHandoff) -> KVHandoff:
        """Materialize the host wire image (blocks on the gather's copy)."""
        if h.strips is None:
            h.strips, h.wire_bytes = self.engine.handoff_wire(h.handle)
            h.handle = None
        return h

    @property
    def idle(self) -> bool:
        return self.engine.idle

    def stats(self):
        return self.engine.stats()


class DecodeEngine:
    """The decode half: a `GenerationEngine` that adopts wired handoffs
    into its own pool and also serves ordinary requests (the controller
    routes short prompts here whole); with ``spec_decode`` set it
    speculates on both."""

    def __init__(self, model, params, *, mesh=None, **kw):
        self.engine = GenerationEngine(model, params, mesh=mesh, **kw)

    def adopt(self, h: KVHandoff) -> tuple[int, int]:
        """Re-admit a wired handoff; returns ``(decode rid, n_fresh)``
        where ``n_fresh`` counts freshly scattered pages (the rest were
        aliased against this pool's prefix index — zero wire cost).

        The pager places the shipped pages, the engine scatters the
        non-aliased strips, and the slot resumes decoding at the shipped
        watermark — no prefill chunk is ever scheduled. Raises
        `PageAllocationError` (nothing mutated) when the pool is full;
        retry on a later step.
        """
        if h.strips is None:
            raise ValueError("handoff not wired — call PrefillEngine.wire")
        eng = self.engine
        if eng._scheduler is None:
            eng._scheduler = eng._serving_init()
        rid = eng._next_rid
        req = dataclasses.replace(h.request, rid=rid)
        slot, strip_idx, fresh = eng._scheduler.admit_handoff(
            req, h.generated, h.record)
        eng._next_rid += 1
        eng.handoff_scatter(h.strips, strip_idx, fresh)
        return rid, len(fresh)

    def submit(self, *a, **kw):
        return self.engine.submit(*a, **kw)

    def step(self) -> list[tuple[int, int]]:
        return self.engine.step()

    def collect(self):
        return self.engine.collect()

    @property
    def idle(self) -> bool:
        return self.engine.idle

    def stats(self):
        return self.engine.stats()


class DisaggController:
    """Both engines behind the ordinary engine API.

    ``handoff_min_tokens`` routes: prompts at or past it flow prefill →
    handoff → decode; shorter ones are served whole by the decode engine
    (unified-style — a transfer would cost more than it saves). The
    default ``"auto"`` takes the roofline crossover
    (`roofline.costmodel.disagg_report` at this deployment's decode
    batch and context); pass an int to pin it, ``0`` to disaggregate
    everything (tests do), or a large value to disable handoffs.

    Per-engine shape/feature kwargs come from ``**engine_kwargs`` (both
    sides) with `_SPEC_KWARGS` stripped for the prefill side. Both
    engines share ``params`` and each holds its own page pools.
    ``prefill_mesh`` / ``decode_mesh`` shard each side over its own
    ``model`` mesh (or none); the two may differ.
    """

    def __init__(self, model, params, *, prefill_mesh=None, decode_mesh=None,
                 handoff_min_tokens: int | str = "auto", **engine_kwargs):
        self.prefill = PrefillEngine(model, params, mesh=prefill_mesh,
                                     **dict(engine_kwargs))
        self.decode = DecodeEngine(model, params, mesh=decode_mesh,
                                   **dict(engine_kwargs))
        max_seq = self.decode.engine.max_seq
        self.split_report = None
        if handoff_min_tokens == "auto":
            from repro_torch.roofline.costmodel import disagg_report
            rep = disagg_report(
                model.cfg,
                decode_batch=self.decode.engine.num_slots,
                context=max_seq,
                quant=self.decode.engine.kv_quant == "int8")
            self.split_report = rep
            cross = rep["crossover_prompt_tokens"]
            if rep["disaggregate"] and cross is not None:
                handoff_min_tokens = cross
            else:       # unified-style: no prompt pays for the transfer
                handoff_min_tokens = max_seq + 1
        self.handoff_min_tokens = int(handoff_min_tokens)
        self.stats_ = DisaggStats()
        self._next_crid = 0
        self._of_prefill: dict[int, int] = {}   # prefill rid → controller rid
        self._of_decode: dict[int, int] = {}    # decode rid → controller rid
        self._pending: list[KVHandoff] = []     # exported, not yet adopted

    # ------------------------------------------------------------------ api
    def submit(self, tokens, max_new_tokens: int,
               sampler: SamplerConfig | None = None,
               eos_id: int | None = None, prefix_id: str | None = None,
               priority: int = 0, n: int = 1) -> int | list[int]:
        """Queue a request; same contract as `GenerationEngine.submit`.

        Routing: ``n > 1`` (parallel sampling shares prompt pages, which
        only exist within one pool) and ``max_new_tokens == 1`` always go
        to the decode engine whole; otherwise prompts of at least
        ``handoff_min_tokens`` tokens take the disaggregated path.
        """
        ntok = len(np.asarray(tokens).reshape(-1))
        disagg = (n == 1 and max_new_tokens > 1
                  and ntok >= self.handoff_min_tokens)
        if disagg:
            prid = self.prefill.submit(
                tokens, max_new_tokens, sampler=sampler, eos_id=eos_id,
                prefix_id=prefix_id, priority=priority)
            crid = self._next_crid
            self._next_crid += 1
            self._of_prefill[prid] = crid
            return crid
        rids = self.decode.submit(tokens, max_new_tokens, sampler=sampler,
                                  eos_id=eos_id, prefix_id=prefix_id,
                                  priority=priority, n=n)
        self.stats_.direct += n
        out = []
        for drid in rids if n > 1 else [rids]:
            crid = self._next_crid
            self._next_crid += 1
            self._of_decode[drid] = crid
            out.append(crid)
        return out if n > 1 else out[0]

    def step(self) -> list[tuple[int, int]]:
        """One controller step → (rid, token) events, controller rids.

        Order is the transfer/compute overlap: prefill dispatch → export
        parked slots (the gather starts the device→host copy) → decode
        dispatch (enqueued while the copy drains) → wire + adopt (the only
        blocking touch of the strips).
        """
        events: list[tuple[int, int]] = []
        t0 = time.perf_counter()
        for prid, tok in self.prefill.step():
            crid = self._of_prefill.get(prid)
            if crid is not None:
                events.append((crid, tok))
        self.stats_.prefill_step_time_s += time.perf_counter() - t0
        self._pending.extend(self.prefill.collect_handoffs())
        t0 = time.perf_counter()
        for drid, tok in self.decode.step():
            crid = self._of_decode.get(drid)
            if crid is not None:
                events.append((crid, tok))
        self.stats_.decode_step_time_s += time.perf_counter() - t0
        self._adopt_pending()
        return events

    def _adopt_pending(self) -> None:
        still: list[KVHandoff] = []
        for h in self._pending:
            self.prefill.wire(h)
            t0 = time.perf_counter()
            try:
                drid, n_fresh = self.decode.adopt(h)
            except PageAllocationError:
                still.append(h)     # decode pool full — retry next step
                continue
            st = self.stats_
            st.handoffs += 1
            st.handoff_pages += h.record.n_pages
            st.aliased_pages += h.record.n_pages - n_fresh
            st.wire_bytes += h.wire_bytes
            st.adopt_time_s += time.perf_counter() - t0
            self._of_decode[drid] = self._of_prefill[h.request.rid]
        self._pending = still

    def collect(self) -> dict[int, np.ndarray]:
        """Finished streams, keyed by controller rid. Streams are complete
        regardless of where the request finished: adopted slots carry the
        prefill-side first token in their generated list."""
        out: dict[int, np.ndarray] = {}
        for prid, toks in self.prefill.collect().items():
            crid = self._of_prefill.pop(prid, None)
            if crid is not None:
                out[crid] = toks
        for drid, toks in self.decode.collect().items():
            crid = self._of_decode.pop(drid, None)
            if crid is not None:
                out[crid] = toks
        return out

    def drain(self) -> dict[int, np.ndarray]:
        """Step until both engines and the handoff queue are empty."""
        out = self.collect()
        wedged = 0
        while not self.idle:
            before = (len(self._pending), self.prefill.idle,
                      self.decode.idle)
            events = self.step()
            got = self.collect()
            out.update(got)
            after = (len(self._pending), self.prefill.idle,
                     self.decode.idle)
            wedged = 0 if (events or got or before != after) else wedged + 1
            if wedged > 1000:
                raise RuntimeError(
                    "disagg controller wedged: pending handoffs cannot "
                    "be adopted (decode pool exhausted by pins?)")
        out.update(self.collect())
        return out

    @property
    def idle(self) -> bool:
        return self.prefill.idle and self.decode.idle and not self._pending

    @property
    def num_active(self) -> int:
        return (self.prefill.engine.num_active
                + self.decode.engine.num_active + len(self._pending))

    def warmup(self) -> int:
        """Run both engines' dispatch widths once
        (`GenerationEngine.warmup`)."""
        return self.prefill.engine.warmup() + self.decode.engine.warmup()

    def pin_prefix(self, prefix_id: str) -> int:
        """Pin on BOTH sides: the prefill pool skips recomputing the
        prefix, the decode pool keeps its adopted copy resident so later
        handoffs alias it instead of re-shipping the bytes."""
        return (self.prefill.engine.pin_prefix(prefix_id)
                + self.decode.engine.pin_prefix(prefix_id))

    def unpin_prefix(self, prefix_id: str) -> int:
        return (self.prefill.engine.unpin_prefix(prefix_id)
                + self.decode.engine.unpin_prefix(prefix_id))

    def prefix_reuse_pages(self, tokens, prefix_id) -> int:
        """Router affinity signal: the best prefix reuse either side
        offers (a handoff aliases decode-resident pages; a direct-routed
        request aliases whichever pool it lands in)."""
        return max(
            self.prefill.engine.prefix_reuse_pages(tokens, prefix_id),
            self.decode.engine.prefix_reuse_pages(tokens, prefix_id))

    def stats(self) -> DisaggStats:
        return self.stats_

    def reset_stats(self) -> None:
        self.stats_ = DisaggStats()
        for side in (self.prefill.engine, self.decode.engine):
            if side._scheduler is not None:
                side.reset_stats()
