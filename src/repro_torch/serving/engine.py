"""Serving facade: static-batch generation + continuous-batching streaming.

  * `GenerationEngine(model, params)` — params may be float or AWQ-packed
    (`core.pipeline.quantize_params` output); every linear dispatches
    through `qlinear_apply`. The engine runs on the device its params
    live on.
  * static batch — `generate` (host loop over the dense cache, EOS early
    exit): the in-port oracle for greedy streams.
  * streaming — `submit()` / `step()` / `collect()` / `drain()` on top of
    `serving.scheduler` (continuous batching) and `serving.kv_pager`
    (paged KV). Every step is ONE token-budget dispatch of
    ``num_slots × c`` positions that packs prefill chunks and decode
    tokens of mixed requests (`Model.chunk_step`); ``kv_quant="int8"``
    stores the pools as int8 codes + f32 scale strips, read by kernel K2
    on the card. ``submit(..., prefix_id=...)`` aliases a shared
    prompt prefix's full pages across requests (refcounted, copy-on-write
    tail), and the aliased tokens are never recomputed; `pin_prefix`
    keeps a hot prefix resident across bursts. `warmup`,
    `prefix_reuse_pages` and `stats()` are what a fleet `Router` reads.

Not ported yet (each raises `NotImplementedError`): speculative decoding,
tree speculation, draft models, meshes, preemption, optimistic admission,
the one-shot prefill path (``chunked_prefill=False``) and parallel
sampling (``n > 1``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.packing import PackedLinear
from repro_torch.serving.kv_pager import KVPager, PagerConfig, PagerStats
from repro_torch.serving.scheduler import Request, Scheduler


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0    # 0 ⇒ greedy
    top_k: int = 0              # 0 ⇒ full softmax


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Serving snapshot (a subset of the reference's `EngineStats`)."""
    pager: PagerStats
    dispatches: int               # unified steps issued
    prefill_tokens: int           # prompt tokens run through the model
    prefill_tokens_skipped: int   # aliased prompt tokens never re-run
    prefix_shared_pages: int      # pages aliased instead of allocated
    padding_waste: float          # padding / dispatched positions
    kv_pool_bytes: int            # page-pool footprint, all layers
    kv_bytes_per_token: float
    weight_bytes: int             # resident bytes of the served params
    # load snapshot a fleet router scores: requests waiting for a slot,
    # and free pages an admission can still draw (free minus reservations)
    queue_depth: int
    admission_headroom: int


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (this slice serves the "
        f"chunked token-budget path only)")


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
                 "mesh-sharded serving (mesh)": mesh is not None,
                 "preemption": preemption,
                 "admission='optimistic'": admission == "optimistic",
                 "the one-shot prefill path (chunked_prefill=False)":
                     chunked_prefill is False}
        for what, requested in asked.items():
            if requested:
                raise _not_ported(what)
        if admission != "reserved":
            raise ValueError(f"unknown admission policy {admission!r}")
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

    # ------------------------------------------------------------ streaming
    def _serving_init(self) -> Scheduler:
        if self.max_seq % self.page_size:
            raise ValueError("max_seq must be a multiple of page_size")
        pages_per_slot = self.max_seq // self.page_size
        num_pages = self._num_pages
        if num_pages is None:   # full capacity: every slot can hit max_seq
            num_pages = self.num_slots * pages_per_slot + 1
        pager = KVPager(PagerConfig(num_pages=num_pages,
                                    page_size=self.page_size,
                                    num_slots=self.num_slots,
                                    pages_per_slot=pages_per_slot))
        self._paged_cache = self.model.init_paged_cache(
            num_pages, self.page_size, kv_quant=self.kv_quant,
            device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(self._seed)
        self._tables_version = -1
        self._tables_dev = None
        return Scheduler(pager, run_batch=self._exec_run_batch,
                         chunk_size=self.prefill_chunk)

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
        if not temps.any() and not topks.any():
            out = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            out = sample_batched(
                logits, torch.as_tensor(temps, dtype=torch.float32,
                                        device=dev),
                torch.as_tensor(topks, dtype=torch.int32, device=dev),
                self._gen)
        return out.cpu().numpy()

    def warmup(self) -> int:
        """Run one all-padding dispatch of every width the scheduler may
        pick (`scheduler.width_family`), so the first request pays no
        first-launch cost (kernel loads, allocator growth). Padding only
        touches the scratch page and no counter of `stats()`. Returns the
        number of dispatches run."""
        if self._scheduler is None:
            self._scheduler = self._serving_init()
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
               priority: int = 0, n: int = 1) -> int:
        """Queue one request; returns its request id.

        ``prefix_id`` opts the request into prefix sharing: requests
        carrying the same id alias any already-resident full KV pages
        whose token content matches their prompt's page-aligned prefix,
        copy-on-write on the partial tail page. Greedy streams are
        token-identical with or without it. ``priority`` orders
        admission (higher first, FIFO within a class).
        """
        if n != 1:
            raise _not_ported("parallel sampling (submit(n > 1))")
        if self._scheduler is None:
            self._scheduler = self._serving_init()
        s = sampler or self.sampler
        rid = self._next_rid
        self._next_rid += 1
        self._scheduler.submit(Request(
            rid=rid, tokens=np.asarray(tokens, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens, temperature=s.temperature,
            top_k=s.top_k, eos_id=self.eos_id if eos_id is None else eos_id,
            prefix_id=prefix_id, priority=priority))
        return rid

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

    def stats(self) -> EngineStats:
        """Serving snapshot (initializes serving state lazily)."""
        if self._scheduler is None:
            self._scheduler = self._serving_init()
        st = self._scheduler.stats
        pager_stats = self._scheduler.pager.stats()
        pool_bytes = _tensor_bytes(self._paged_cache)
        tokens = pager_stats.pages_total * self.page_size
        return EngineStats(
            pager=pager_stats,
            dispatches=st.decode_steps,
            prefill_tokens=st.prefill_tokens,
            prefill_tokens_skipped=st.prefill_tokens_skipped,
            prefix_shared_pages=st.prefix_shared_pages,
            padding_waste=st.padding_waste,
            kv_pool_bytes=pool_bytes,
            kv_bytes_per_token=pool_bytes / tokens,
            weight_bytes=_tensor_bytes(self.params),
            queue_depth=len(self._scheduler.queue),
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
