"""Serving facade: static-batch generation + continuous-batching streaming.

  * `GenerationEngine(model, params)` — params may be float or AWQ-packed
    (`core.pipeline.quantize_params` output); every linear dispatches
    through `qlinear_apply`. The engine runs on the device its params
    live on.
  * static batch — `generate` (host loop over the dense cache, EOS early
    exit): the in-port oracle for greedy streams; `generate_scan`
    (fixed length, tokens kept on the device until the end: the
    throughput path).
  * streaming — `submit()` / `step()` / `collect()` / `drain()` on top of
    `serving.scheduler` (continuous batching) and `serving.kv_pager`
    (paged KV). On the chunked path (the default) every step is ONE
    token-budget dispatch of ``num_slots × c`` positions that packs
    prefill chunks and decode tokens of mixed requests
    (`Model.chunk_step`). ``chunked_prefill=False`` selects the one-shot
    path: each admission runs a dense `Model.prefill` of the whole prompt
    (kernel K4 on the card), commits its KV into the pages
    (`kv_pager.commit_prefill`) and samples the first token; every step
    then decodes one token for all slots (`Model.decode_step` over the
    pools). ``kv_quant="int8"`` stores the pools as int8 codes + f32
    scale strips, read by kernel K2 on the card.
    ``submit(..., prefix_id=...)`` aliases a shared prompt prefix's full
    pages across requests (refcounted, copy-on-write tail; on the
    chunked path the aliased tokens are never recomputed), `pin_prefix`
    keeps a hot prefix resident across bursts, and ``submit(..., n=k)``
    samples k continuations of one prompt over one prefix namespace.
    `warmup`, `prefix_reuse_pages` and `stats()` are what a fleet
    `Router` reads; `stats()` is the reference's full `EngineStats`.
  * SLO preemption — ``preemption=True`` (chunked path only) spills a
    lower-priority slot's pages to a host-memory tier when a higher class
    cannot be admitted, and restores them later at the commit watermark
    with zero recompute; ``preempt(rid)`` spills one by hand.
    ``admission="optimistic"`` admits on the prompt's pages alone and
    spills under page pressure. The movers gather every pool leaf's pages
    (int8 codes and their scale strips as stored) into pinned host
    memory and scatter them back into fresh pages.
  * disaggregated serving — `handoff_gather` / `handoff_wire` /
    `handoff_scatter` move a slot's pages between two engines' pools
    (`serving.disagg`).

Not ported yet (each raises `NotImplementedError`): speculative decoding,
tree speculation, draft models and meshes; their `EngineStats` counters
stay 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.packing import PackedLinear
from repro_torch.serving.kv_pager import (KVPager, PagerConfig, PagerStats,
                                          commit_prefill)
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerStats


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0    # 0 ⇒ greedy
    top_k: int = 0              # 0 ⇒ full softmax


# the reference's default draft length, which its `stats()` reports as
# ``spec_k_now`` while nothing speculates (speculation is not ported)
_SPEC_K = 4


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """One structured serving snapshot: the reference's fields, in its
    order. Pager occupancy, dispatch / packing accounting, speculative
    acceptance (0 until speculation is ported), preemption and the host
    KV tier, and the memory footprint of the page pools and weights (one
    device: ``model_axis`` 1)."""
    pager: PagerStats
    # dispatch / packing
    dispatches: int               # steps issued
    prefill_tokens: int           # prompt tokens run through chunk steps
    prefill_tokens_skipped: int   # aliased prompt tokens never re-run
    prefix_shared_pages: int      # pages aliased instead of allocated
    padding_waste: float          # padding / dispatched positions
    padding_waste_fixed: float    # same steps under pad-to-chunk-width
    # speculative decoding
    acceptance_rate: float
    spec_tokens_per_row: float
    draft_tokens: int
    accepted_tokens: int
    rollbacks: int
    spec_k_now: int               # current draft length
    spec_fanout_now: int          # current tree root fanout (1 = linear)
    # SLO preemption / host KV tier
    preemptions: int
    pressure_spills: int
    restores: int
    spilled_pages: int
    restored_pages: int
    pages_spilled_now: int
    restore_ms_mean: float
    # sharding + memory
    model_axis: int               # |model| mesh axis (1 = unsharded)
    kv_pool_bytes: int            # page-pool footprint, all layers
    kv_pool_bytes_per_device: int
    kv_bytes_per_token: float
    # weight stream: resident bytes of the served params and the bytes
    # streamed per emitted token (one weight pass per decode step)
    weight_bytes: int
    weight_bytes_per_token: float
    # load snapshot a fleet router scores: requests waiting for a slot
    # (queued + parked), and free pages an admission can still draw
    # (free minus reservations)
    queue_depth: int = 0
    admission_headroom: int = 0


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, bf16 as its raw 16-bit words."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy()


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


def _categorical(logits: torch.Tensor, gen: torch.Generator | None
                 ) -> torch.Tensor:
    """One draw per row from softmax(logits) (Gumbel-max, like
    ``jax.random.categorical``; the random bits differ from JAX's)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample(logits: torch.Tensor, cfg: SamplerConfig,
           gen: torch.Generator | None = None) -> torch.Tensor:
    """logits [B, V] → token [B] int32."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / cfg.temperature
    if cfg.top_k:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    return _categorical(logits, gen).to(torch.int32)


def sample_batched(logits: torch.Tensor, temps: torch.Tensor,
                   topks: torch.Tensor,
                   gen: torch.Generator | None = None) -> torch.Tensor:
    """Per-row sampling params: logits [B, V], temps [B], topks [B] → [B].

    Rows with ``temps == 0`` are greedy — plain argmax, bit-identical to
    `sample` with temperature 0; ``topks == 0`` disables the top-k filter.
    """
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.where(temps > 0, temps,
                                  torch.ones_like(temps))[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, torch.clip(topks.long() - 1, 0, v - 1)[:, None])
    filtered = torch.where(scaled < kth, torch.full_like(scaled, -1e30),
                           scaled)
    scaled = torch.where((topks > 0)[:, None], filtered, scaled)
    sampled = _categorical(scaled, gen).to(torch.int32)
    return torch.where(temps == 0.0, greedy, sampled)


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, PackedLinear):
        return sum(_tensor_bytes(getattr(tree, f)) for f in
                   ("qweight", "scales", "zeros", "input_scale", "bias"))
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


class GenerationEngine:
    def __init__(self, model, params, *, max_seq: int | None = None,
                 sampler: SamplerConfig = SamplerConfig(),
                 eos_id: int = -1, num_slots: int = 4, page_size: int = 16,
                 num_pages: int | None = None, seed: int = 0,
                 kv_quant: str | None = None, prefill_chunk: int = 16,
                 chunked_prefill: bool | None = None,
                 spec_decode: str | None = None, spec_tree: bool = False,
                 draft_model=None, draft_params=None, draft_fn=None,
                 mesh=None, preemption: bool = False,
                 admission: str = "reserved"):
        asked = {"speculative decoding (spec_decode)": spec_decode is not None,
                 "tree speculation (spec_tree)": spec_tree,
                 "draft models (draft_model / draft_params / draft_fn)":
                     (draft_model, draft_params, draft_fn) != (None,) * 3,
                 "mesh-sharded serving (mesh)": mesh is not None}
        for what, requested in asked.items():
            if requested:
                raise _not_ported(what)
        # SLO-aware preemption: priority classes on submit(), victim spill
        # to a host-memory page tier, zero-recompute restore.
        # admission="optimistic" drops the worst-case decode reservation
        # (preemption becomes the safety valve when the pool runs dry).
        if admission not in ("reserved", "optimistic"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if admission == "optimistic" and not preemption:
            raise ValueError("admission='optimistic' requires "
                             "preemption=True — without spill as a safety "
                             "valve a drained pool would fail extend()")
        self.preemption = preemption
        self.admission = admission
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.device = params["embed"]["table"].device
        self.max_seq = max_seq or model.cfg.max_seq_len
        self.sampler = sampler
        self.eos_id = eos_id
        self.num_slots = num_slots
        self.page_size = page_size
        self._num_pages = num_pages
        self._seed = seed
        if kv_quant not in (None, "none", "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        self.kv_quant = model.cfg.kv_quant if kv_quant is None else kv_quant
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be ≥ 1")
        self.prefill_chunk = prefill_chunk
        # None = auto (chunked whenever the paged cache is pure kv_pool),
        # True = require the chunked path, False = one-shot
        self.chunked_prefill = chunked_prefill
        self._next_rid = 0
        self._scheduler: Scheduler | None = None
        self._paged_cache = None

    # -------------------------------------------------------- static batch
    @torch.no_grad()
    def generate(self, batch: dict, max_new_tokens: int,
                 gen: torch.Generator | None = None) -> np.ndarray:
        """Host-loop generation with EOS early-exit. Returns [B, max_new]."""
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 dtype=torch.int32, device=self.device)
        b = tokens.shape[0]
        cache = self.model.init_cache(b, self.max_seq, device=self.device)
        cache, logits, pos = self.model.prefill(self.params,
                                                {"tokens": tokens}, cache)
        token = sample(logits, self.sampler, gen)
        out = [token.cpu().numpy()]
        finished = np.zeros(b, bool)
        for _ in range(max_new_tokens - 1):
            logits, cache = self.model.decode_step(self.params, cache, token,
                                                   pos)
            token = sample(logits, self.sampler, gen)
            pos = pos + 1
            tok_np = np.where(finished, self.eos_id, token.cpu().numpy())
            finished |= tok_np == self.eos_id
            out.append(tok_np)
            if self.eos_id >= 0 and finished.all():
                break
        return np.stack(out, axis=1)

    @torch.no_grad()
    def generate_scan(self, batch: dict, max_new_tokens: int,
                      gen: torch.Generator | None = None) -> np.ndarray:
        """Fixed-length generation (the throughput path): no EOS early
        exit, and the tokens stay on the device until one copy at the end,
        the counterpart of the reference's ``lax.scan``. Returns
        [B, max_new]; equal to `generate` when no stream meets EOS."""
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 dtype=torch.int32, device=self.device)
        b = tokens.shape[0]
        cache = self.model.init_cache(b, self.max_seq, device=self.device)
        cache, logits, pos = self.model.prefill(self.params,
                                                {"tokens": tokens}, cache)
        out = torch.empty((b, max_new_tokens), dtype=torch.int32,
                          device=self.device)
        token = sample(logits, self.sampler, gen)
        out[:, 0] = token
        for t in range(1, max_new_tokens):
            logits, cache = self.model.decode_step(self.params, cache, token,
                                                   pos)
            token = sample(logits, self.sampler, gen)
            pos = pos + 1
            out[:, t] = token
        return out.cpu().numpy()

    # ------------------------------------------------------------ streaming
    def _pager_config(self) -> PagerConfig:
        if self.max_seq % self.page_size:
            raise ValueError("max_seq must be a multiple of page_size")
        pages_per_slot = self.max_seq // self.page_size
        num_pages = self._num_pages
        if num_pages is None:   # full capacity: every slot can hit max_seq
            num_pages = self.num_slots * pages_per_slot + 1
        return PagerConfig(num_pages=num_pages, page_size=self.page_size,
                           num_slots=self.num_slots,
                           pages_per_slot=pages_per_slot,
                           optimistic=self.admission == "optimistic")

    def _serving_init(self) -> Scheduler:
        pager = KVPager(self._pager_config())
        self._paged_cache = self.model.init_paged_cache(
            pager.cfg.num_pages, self.page_size, kv_quant=self.kv_quant,
            device=self.device)
        chunkable = self._cache_chunkable(self._paged_cache)
        chunked = chunkable if self.chunked_prefill is None \
            else self.chunked_prefill
        if chunked and not chunkable:
            raise ValueError(
                "chunked_prefill=True but the arch keeps bounded per-slot "
                "sequential state (ring/SSM/MLA): only pure paged-attention "
                "caches support the chunked path")
        if self.preemption and not chunked:
            raise ValueError(
                "preemption requires the chunked serving path: restore "
                "re-enters the unified chunk dispatch at the commit "
                "watermark, which one-shot prefill does not track")
        self._gen = torch.Generator(device=self.device).manual_seed(self._seed)
        self._tables_version = -1
        self._tables_dev = None
        if chunked:
            return Scheduler(pager, run_batch=self._exec_run_batch,
                             chunk_size=self.prefill_chunk,
                             preemption=self.preemption,
                             spill_fn=(self._exec_spill
                                       if self.preemption else None),
                             restore_fn=(self._exec_restore
                                         if self.preemption else None))
        return Scheduler(pager, prefill_commit=self._exec_prefill_commit,
                         decode=self._exec_decode)

    @staticmethod
    def _cache_chunkable(cache) -> bool:
        """True when every layer's cache entry is a page pool (no per-slot
        sequential state), i.e. the arch can run the chunked path."""
        return all(set(entry) == {"kv_pool"}
                   for layers in cache.values() for entry in layers)

    def _device_tables(self, n_blocks: int) -> torch.Tensor:
        """Device copy of the pager's page tables (uploaded only when the
        pager mutated them), sliced to the first ``n_blocks`` columns."""
        pager = self._scheduler.pager
        if self._tables_version != pager.version:
            self._tables_dev = torch.as_tensor(pager.page_tables,
                                               device=self.device)
            self._tables_version = pager.version
        return self._tables_dev[:, :n_blocks]

    def _context_bucket(self, max_pos: int) -> int:
        """Pages the unified step must read to cover ``max_pos``, rounded
        up to a geometric bucket (8, 16, 32, … pages, capped at slot
        capacity): bounds the pages K2 reads per step by the committed
        context instead of ``max_seq``."""
        pps = self.max_seq // self.page_size
        need = max_pos // self.page_size + 1
        b = 8
        while b < need:
            b *= 2
        return min(b, pps)

    @torch.no_grad()
    def _exec_run_batch(self, tokens, pos, row_slots, sample_idx, temps,
                        topks):
        """One unified chunk step (the Scheduler's ``run_batch``)."""
        dev = self.device
        tables = self._device_tables(self._context_bucket(int(pos.max())))
        page_table = tables[torch.as_tensor(row_slots, device=dev).long()]
        logits, self._paged_cache = self.model.chunk_step(
            self.params, self._paged_cache,
            torch.as_tensor(tokens, dtype=torch.int32, device=dev),
            torch.as_tensor(pos, dtype=torch.int32, device=dev),
            torch.as_tensor(sample_idx, dtype=torch.int32, device=dev),
            page_table=page_table)
        return self._sample_rows(logits, temps, topks).cpu().numpy()

    def _sample_rows(self, logits, temps, topks) -> torch.Tensor:
        """Per-row sampling; all-greedy steps take a plain argmax."""
        if not np.any(temps) and not np.any(topks):
            return torch.argmax(logits, dim=-1).to(torch.int32)
        dev = self.device
        return sample_batched(
            logits, torch.as_tensor(temps, dtype=torch.float32, device=dev),
            torch.as_tensor(topks, dtype=torch.int32, device=dev), self._gen)

    @torch.no_grad()
    def _exec_prefill_commit(self, req: Request, slot: int,
                             pages: list[int], n_shared: int = 0) -> int:
        """One-shot admission (the Scheduler's ``prefill_commit``): a dense
        prefill of the whole prompt, its KV committed into the slot's
        pages past the ``n_shared`` aliased ones, the first token sampled
        from its last logits."""
        toks = torch.as_tensor(req.tokens, dtype=torch.int32,
                               device=self.device)[None]
        pre = self.model.init_cache(1, toks.shape[1], device=self.device)
        pre, logits, _ = self.model.prefill(self.params, {"tokens": toks},
                                            pre)
        commit_prefill(self._paged_cache, pre, slot, pages,
                       page_size=self.page_size, start_page=n_shared)
        tok = self._sample_rows(logits, np.float32([req.temperature]),
                                np.int32([req.top_k]))
        return int(tok[0])

    @torch.no_grad()
    def _exec_decode(self, page_tables, token, pos, temps, topks
                     ) -> np.ndarray:
        """One-shot decode step (the Scheduler's ``decode``): one token for
        every slot. ``page_tables`` is the pager's own array, which
        `_device_tables` keeps on the device; like the chunk step, the
        read covers the context bucket of the longest slot, not the whole
        table (the pages past it are masked out either way)."""
        dev = self.device
        tables = self._device_tables(self._context_bucket(int(pos.max())))
        logits, self._paged_cache = self.model.decode_step(
            self.params, self._paged_cache,
            torch.as_tensor(token, dtype=torch.int32, device=dev),
            torch.as_tensor(pos, dtype=torch.int32, device=dev),
            page_table=tables)
        return self._sample_rows(logits, temps, topks).cpu().numpy()

    # --- host-memory page tier (preemption spill/restore) -----------------
    def _pool_leaves(self):
        """(seg, leaf name, [per-layer pool tensors]) for every pool leaf
        of the paged cache: codes and, for int8 pools, scale strips."""
        for seg, layers in self._paged_cache.items():
            for leaf in layers[0]["kv_pool"]:
                yield seg, leaf, [e["kv_pool"][leaf] for e in layers]

    def _exec_spill(self, phys_ids: list[int]) -> dict:
        """Scheduler spill hook: gather ``phys_ids``'s pool bytes BEFORE the
        pager releases those pages. The gather is enqueued on the device's
        stream ahead of any later write into the pages (the pools update
        in place), and each leaf's ``[L, n, P, ...]`` strip is copied into
        pinned host memory without blocking; ``event`` marks the copies'
        completion for a host reader (`handoff_wire`). Int8 pools leave
        as stored: codes plus scale strips, never re-inflated."""
        dev = self.device
        ids = torch.as_tensor(phys_ids, dtype=torch.long, device=dev)
        strips: dict = {}
        for seg, leaf, pools in self._pool_leaves():
            g = torch.stack([pool.index_select(0, ids) for pool in pools])
            if dev.type == "cuda":
                host = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                host.copy_(g, non_blocking=True)
                g = host
            strips.setdefault(seg, {})[leaf] = g
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return {"n": len(phys_ids), "strips": strips, "event": event}

    def _scatter(self, strips: dict, fresh_ids: list[int]) -> None:
        """Write host strips ``{seg: {leaf: [L, n, ...]}}`` (tensors, or a
        wire image's numpy arrays) into pages ``fresh_ids`` of every pool
        leaf, one host→device copy each."""
        dev = self.device
        ids = torch.as_tensor(fresh_ids, dtype=torch.long, device=dev)
        for seg, leaf, pools in self._pool_leaves():
            src = torch.as_tensor(strips[seg][leaf]).view(pools[0].dtype)
            src = src.to(dev, non_blocking=True)
            for layer, pool in enumerate(pools):
                pool.index_copy_(0, ids, src[layer])

    def _exec_restore(self, handle: dict, fresh_ids: list[int]) -> None:
        """Scheduler restore hook: scatter the parked strips into the
        freshly drawn pages (the pager already rebuilt the page table).
        The host→device copies follow the spill's device→host copies on
        the same stream, so nothing waits on the host."""
        assert len(fresh_ids) == handle["n"]
        self._scatter(handle["strips"], fresh_ids)

    # --- cross-engine KV page handoff (disaggregated prefill/decode) ------
    def handoff_gather(self, phys_ids: list[int]) -> dict:
        """Gather ``phys_ids``'s pool bytes for a cross-engine handoff: the
        spill tier's gather, for engines with or without preemption. The
        device→host copy runs without blocking; `handoff_wire` waits for
        it and materializes the wire image."""
        if self._scheduler is None:
            self._scheduler = self._serving_init()
        return self._exec_spill(phys_ids)

    def handoff_wire(self, handle: dict) -> tuple[dict, int]:
        """Block on a `handoff_gather` and return ``(strips, wire_bytes)``.

        Strips are host numpy ``{seg: {leaf: [L, n, P, ...]}}``, the
        reference's wire image in layout and size: int8 pools ship codes +
        per-position scale strips (~2× fewer bytes than bf16). numpy has
        no bfloat16, so bf16 leaves travel as their raw 16-bit words
        (int16).
        """
        if handle["event"] is not None:
            handle["event"].synchronize()
        strips = {seg: {k: _host_numpy(t) for k, t in leaves.items()}
                  for seg, leaves in handle["strips"].items()}
        wire = sum(a.nbytes for leaves in strips.values()
                   for a in leaves.values())
        return strips, wire

    def handoff_scatter(self, strips: dict, strip_idx: list[int],
                        fresh_ids: list[int]) -> None:
        """Scatter wire strips ``strip_idx`` into this engine's freshly
        drawn pages (the pager's `adopt` already rebuilt the page table;
        pages it aliased against the local prefix index ship nothing and
        are absent here)."""
        if self._scheduler is None:
            self._scheduler = self._serving_init()
        if not fresh_ids:
            return
        assert len(strip_idx) == len(fresh_ids)
        self._scatter({seg: {k: a[:, strip_idx] for k, a in leaves.items()}
                       for seg, leaves in strips.items()}, fresh_ids)

    def warmup(self) -> int:
        """Run one all-padding dispatch of every width the scheduler may
        pick (`scheduler.width_family`), so the first request pays no
        first-launch cost (kernel loads, allocator growth). Padding only
        touches the scratch page and no counter of `stats()`. Returns the
        number of dispatches run: 0 on the one-shot path, whose prefill
        runs at each prompt's own length."""
        if self._scheduler is None:
            self._scheduler = self._serving_init()
        if not self._scheduler.chunked:
            return 0
        b = self.num_slots
        zeros_i = np.zeros(b, np.int32)
        for c in self._scheduler.width_buckets:
            self._exec_run_batch(np.zeros((b, c), np.int32),
                                 np.full((b, c), -1, np.int32), zeros_i,
                                 zeros_i, np.zeros(b, np.float32), zeros_i)
        return len(self._scheduler.width_buckets)

    def submit(self, tokens, max_new_tokens: int,
               sampler: SamplerConfig | None = None,
               eos_id: int | None = None, prefix_id: str | None = None,
               priority: int = 0, n: int = 1) -> int | list[int]:
        """Queue one request; returns its request id (or ``n`` ids).

        ``prefix_id`` opts the request into prefix sharing: requests
        carrying the same id alias any already-resident full KV pages
        whose token content matches their prompt's page-aligned prefix,
        copy-on-write on the partial tail page. Greedy streams are
        token-identical with or without it. ``priority`` orders
        admission (higher first, FIFO within a class).

        ``n > 1`` requests parallel sampling: ``n`` continuations of the
        same prompt, returned as a list of request ids. The siblings
        share one prefix namespace (``__par{rid}`` of the first sibling
        when ``prefix_id`` is None), so the prompt's full pages are
        written once and aliased by the other ``n - 1`` slots. Greedy
        siblings emit identical streams; sampled siblings draw
        independently.
        """
        if self._scheduler is None:
            self._scheduler = self._serving_init()
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        s = sampler or self.sampler
        pid = prefix_id
        if n > 1 and pid is None:
            pid = f"__par{self._next_rid}"
        rids = []
        for _ in range(n):
            rid = self._next_rid
            self._next_rid += 1
            self._scheduler.submit(Request(
                rid=rid, tokens=np.asarray(tokens, np.int32).reshape(-1),
                max_new_tokens=max_new_tokens, temperature=s.temperature,
                top_k=s.top_k,
                eos_id=self.eos_id if eos_id is None else eos_id,
                prefix_id=pid, priority=priority))
            rids.append(rid)
        return rids if n > 1 else rids[0]

    def preempt(self, rid: int) -> bool:
        """Spill ``rid``'s slot to the host tier now (ops/test hook —
        organic preemption is priority-driven). False when ``rid`` holds
        no slot. Requires ``preemption=True``."""
        if self._scheduler is None:
            return False
        return self._scheduler.preempt_request(rid)

    def pin_prefix(self, prefix_id: str) -> int:
        """Keep ``prefix_id``'s indexed KV pages resident across bursts.

        The pin refcounts every page indexed under the namespace now, and
        any registered under it later (sticky), so the next burst aliases
        the prefix without recomputing it. Returns the pages pinned now;
        pinned pages count against admission until `unpin_prefix`.
        """
        if self._scheduler is None:
            self._scheduler = self._serving_init()
        return self._scheduler.pager.pin_prefix(prefix_id)

    def unpin_prefix(self, prefix_id: str) -> int:
        """Release a `pin_prefix` hold; unowned pages free exactly once."""
        if self._scheduler is None:
            return 0
        return self._scheduler.pager.unpin_prefix(prefix_id)

    def step(self) -> list[tuple[int, int]]:
        """One scheduler step → list of (rid, token) stream events."""
        if self._scheduler is None:
            return []
        return self._scheduler.step()

    def collect(self) -> dict[int, np.ndarray]:
        """Drain finished requests accumulated so far: {rid: tokens}."""
        if self._scheduler is None:
            return {}
        out = dict(self._scheduler.finished)
        self._scheduler.finished.clear()
        return out

    def drain(self) -> dict[int, np.ndarray]:
        """Step until queue + slots are empty; returns all finished."""
        if self._scheduler is None:
            return {}
        out = self.collect()
        out.update(self._scheduler.run())
        return out

    @property
    def idle(self) -> bool:
        """True when no requests are queued or in flight."""
        return self._scheduler is None or self._scheduler.idle

    @property
    def num_active(self) -> int:
        """Requests currently holding a decode slot."""
        return 0 if self._scheduler is None else self._scheduler.num_active

    @property
    def scheduler_stats(self):
        return self._scheduler.stats if self._scheduler else None

    def stats(self) -> EngineStats:
        """One structured serving snapshot (see `EngineStats`). A fresh
        engine reports its empty state without allocating the pools."""
        if self._scheduler is None:
            st, queued = SchedulerStats(), 0
            pager_stats = KVPager(self._pager_config()).stats()
        else:
            st = self._scheduler.stats
            queued = len(self._scheduler.queue) + len(self._scheduler.preempted)
            pager_stats = self._scheduler.pager.stats()
        pool_bytes = self.paged_kv_page_bytes() * pager_stats.pages_total
        valid = st.dispatched_positions - st.padded_positions
        fixed_total = valid + st.padded_positions_fixed
        return EngineStats(
            pager=pager_stats,
            dispatches=st.decode_steps,
            prefill_tokens=st.prefill_tokens,
            prefill_tokens_skipped=st.prefill_tokens_skipped,
            prefix_shared_pages=st.prefix_shared_pages,
            padding_waste=st.padding_waste,
            padding_waste_fixed=(st.padded_positions_fixed
                                 / max(fixed_total, 1)),
            acceptance_rate=st.acceptance_rate,
            spec_tokens_per_row=st.spec_tokens_per_row,
            draft_tokens=st.draft_tokens,
            accepted_tokens=st.accepted_tokens,
            rollbacks=st.rollbacks,
            spec_k_now=_SPEC_K,
            spec_fanout_now=1,
            preemptions=st.preemptions,
            pressure_spills=st.pressure_spills,
            restores=st.restores,
            spilled_pages=st.spilled_pages,
            restored_pages=st.restored_pages,
            pages_spilled_now=pager_stats.pages_spilled,
            restore_ms_mean=st.restore_time_s * 1e3 / max(st.restores, 1),
            model_axis=1,
            kv_pool_bytes=pool_bytes,
            kv_pool_bytes_per_device=pool_bytes,
            kv_bytes_per_token=self.paged_kv_bytes_per_token(),
            weight_bytes=self.weight_stream_bytes(),
            weight_bytes_per_token=self.weight_bytes_per_token(
                st.spec_tokens_per_row),
            queue_depth=queued,
            admission_headroom=max(
                0, pager_stats.pages_free - pager_stats.pages_reserved))

    def reset_stats(self) -> None:
        """Zero the cumulative counters behind `stats()` in place
        (`SchedulerStats.zero`): held references stay live. Occupancy is
        live state, not a counter, and is untouched."""
        if self._scheduler is not None:
            self._scheduler.stats.zero()

    def prefix_reuse_pages(self, tokens, prefix_id) -> int:
        """Exact count of already-resident KV pages a request with this
        prompt and ``prefix_id`` would alias instead of recomputing (the
        router's affinity signal; the prefix index is content-addressed).
        A fresh engine holds no pages and reports 0 without allocating."""
        if prefix_id is None or self._scheduler is None:
            return 0
        return len(self._scheduler.pager.match_prefix(tokens, prefix_id))

    # --------------------------------------------------- capacity accounting
    def paged_kv_page_bytes(self) -> int:
        """Bytes one physical page costs across all layers (codes + scale
        strips for int8 pools): the unit of the serving memory budget.
        Before serving starts the pools are laid out on the ``meta``
        device, so nothing is allocated."""
        if self._scheduler is not None:
            cache = self._paged_cache
            num_pages = self._scheduler.pager.cfg.num_pages
        else:
            num_pages = self._pager_config().num_pages
            cache = self.model.init_paged_cache(
                num_pages, self.page_size, kv_quant=self.kv_quant,
                device="meta")
        return _tensor_bytes(cache) // num_pages

    def paged_kv_bytes_per_token(self) -> float:
        """KV bytes per cached token in the page pools (all layers)."""
        return self.paged_kv_page_bytes() / self.page_size

    def weight_stream_bytes(self) -> int:
        """Resident bytes of the served params: what one decode step
        streams through the matmuls (`PackedLinear`s count their int4
        words plus scales, zeros and input scales)."""
        return _tensor_bytes(self.params)

    def weight_bytes_per_token(self, spec_tokens_per_row: float = 0.0
                               ) -> float:
        """Weight bytes streamed per emitted token: one weight pass per
        decode step, amortized over the tokens a row emits per step
        (> 1 only under speculative decoding)."""
        return self.weight_stream_bytes() / max(spec_tokens_per_row, 1.0)
