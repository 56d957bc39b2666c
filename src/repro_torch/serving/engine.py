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
    path, which is also the default for a model whose cache holds
    per-slot state (MLA's latents, SSM states, hymba's windowed rings:
    `_cache_chunkable`; mamba2's cache has no page pool at all); each
    admission runs a dense `Model.prefill` of the whole prompt
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
  * speculative decoding (chunked path only) — ``spec_decode="ngram"``
    (prompt-lookup self-drafting) or ``"draft_model"`` (a greedy draft
    model with its own dense ``[num_slots, max_seq]`` cache, prefilled
    per slot through `Model.prefill`, kernel K4 on the card; or a custom
    ``draft_fn``) proposes up to ``spec_k`` tokens per decoding slot. One
    chunk step verifies every draft in one weight pass and gathers
    ``spec_k + 1`` logits a row; acceptance runs on the device and only
    the fix token, the accepted count (and a tree's path) come back to
    the host, in one copy. ``spec_tree=True`` verifies token trees: each
    node's logical position is its depth and its row's ancestor mask is
    the attention mask of the span (kernel K2's ``rpos`` / ``amask`` on
    int8 pools), and the accepted branch's KV is compacted into the
    slots sequential decode would have written. Greedy streams equal
    sequential decode's; sampled rows use residual acceptance with the
    engine's seeded `torch.Generator`. ``spec_adaptive=True`` walks
    ``spec_k`` (and the tree's fanout) from the measured acceptance.
  * tensor parallelism — ``GenerationEngine(mesh=...)`` (chunked path:
    attention decoders, dense or MoE) serves the model over a mesh's ``model``
    axis from this one controller, as the reference does: one scheduler
    and host pager, page tables replicated; weights split by
    `distributed.sharding.param_pspec` (column-parallel q / k / v / gate
    / up, row-parallel o / down, a vocab-parallel embedding and tied
    head), page pools striped over KV heads by `paged_cache_pspec`, each
    shard's on its device; every layer runs per shard with explicit sums
    and joins between shards (`Model.chunk_step(mesh=...)`; int8 pools on
    the card read through K2-TP). Spill and handoff strips leave the mesh
    whole and re-stripe on the way in, so a strip adopts on any mesh.
    ``self.params`` stays unsharded: `generate()` keeps its single-device
    path. A mesh's first device must hold the params; an explicit device
    list may repeat a device (`distributed.serving_mesh`). A MoE layer's
    experts run per shard (`moe.moe_apply_tp`: packed, K3 on each shard's
    F stripe and K1 on its D stripe). Per-slot-state families (MLA, SSM,
    hybrid) keep the one-shot path and raise under a mesh, as in the
    reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.bridge import host_numpy
from repro_torch.core.packing import PackedLinear
from repro_torch.distributed.sharding import (model_devices,
                                              paged_cache_pspec,
                                              shard_params, split_dim,
                                              strip_gather, strip_scatter)
from repro_torch.serving.kv_pager import (KVPager, PagerConfig, PagerStats,
                                          _commit_dense_leaf, commit_prefill)
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerStats


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0    # 0 ⇒ greedy
    top_k: int = 0              # 0 ⇒ full softmax


# the draft length a one-shot scheduler reports (the scheduler's default)
_SPEC_K = 4


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """One structured serving snapshot: the reference's fields, in its
    order. Pager occupancy, dispatch / packing accounting, speculative
    acceptance, preemption and the host KV tier, and the memory footprint
    of the page pools (all shards', and one shard's under a mesh) and of
    the weights."""
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
    spec_k_now: int               # current draft length (adaptive)
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
    # streamed per emitted token (one weight pass per decode step,
    # amortized over spec-accepted tokens per row when speculating)
    weight_bytes: int
    weight_bytes_per_token: float
    # load snapshot a fleet router scores: requests waiting for a slot
    # (queued + parked), and free pages an admission can still draw
    # (free minus reservations)
    queue_depth: int = 0
    admission_headroom: int = 0


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


def _filter_logits(logits: torch.Tensor, temps: torch.Tensor,
                   topks: torch.Tensor) -> torch.Tensor:
    """logits ``[B, ..., V]`` scaled by each row's temperature (rows with
    ``temps == 0`` by 1) and cut to its top-k (``topks == 0``: no cut)."""
    v = logits.shape[-1]
    row = (-1,) + (1,) * (logits.dim() - 1)
    scaled = logits / torch.where(temps > 0, temps,
                                  torch.ones_like(temps)).view(row)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kidx = torch.clip(topks.long() - 1, 0, v - 1).view(row).expand(
        *scaled.shape[:-1], 1)
    kth = torch.gather(desc, -1, kidx)
    filtered = scaled.masked_fill(scaled < kth, -1e30)
    return torch.where((topks > 0).view(row), filtered, scaled)


def sample_batched(logits: torch.Tensor, temps: torch.Tensor,
                   topks: torch.Tensor,
                   gen: torch.Generator | None = None) -> torch.Tensor:
    """Per-row sampling params: logits [B, V], temps [B], topks [B] → [B].

    Rows with ``temps == 0`` are greedy — plain argmax, bit-identical to
    `sample` with temperature 0; ``topks == 0`` disables the top-k filter.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = _categorical(_filter_logits(logits, temps, topks),
                           gen).to(torch.int32)
    return torch.where(temps == 0.0, greedy, sampled)


def _spec_gather_drafts(tokens: torch.Tensor, sample_idx: torch.Tensor,
                        r: int):
    """draft_next [B, R]: the input token each gathered logit must
    predict — tokens at in-row index sample_idx + j + 1 (clipped;
    indices past a row's run are masked by n_draft downstream); and j
    [1, R]."""
    c = tokens.shape[1]
    j = torch.arange(r, dtype=torch.int32, device=tokens.device)[None, :]
    nxt = torch.clip(sample_idx[:, None] + j + 1, 0, c - 1).long()
    return torch.gather(tokens, 1, nxt), j


def _tree_walk_greedy(g, tokens, parents, n_draft, depth: int):
    """Device-side greedy tree acceptance: from the root (in-row index 0),
    follow the child whose token equals the target argmax at the current
    node, as deep as the matches go.

    g ``[B, R]`` — the target argmax after each in-row position; tokens /
    parents ``[B, C]`` (parent = in-row index, ``-1`` = none); n_draft
    ``[B]`` node counts (nodes sit at in-row indices ``1 … n_draft``).
    Returns ``(fix [B], n_acc [B], path [B, depth])`` int32 — the
    corrected / bonus token (argmax at the deepest accepted node), the
    accepted depth, and the accepted branch's in-row indices (0-padded).
    Emitting ``path`` tokens then ``fix`` reproduces sequential greedy
    decode token for token.
    """
    b, c = tokens.shape
    dev = tokens.device
    idx = torch.arange(c, device=dev)[None, :]
    rmax = g.shape[1] - 1
    cur = torch.zeros(b, dtype=torch.int64, device=dev)
    n_acc = torch.zeros(b, dtype=torch.int32, device=dev)
    path = torch.zeros((b, depth), dtype=torch.int32, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    for t in range(depth):
        g_cur = torch.gather(g, 1, cur.clip(0, rmax)[:, None])
        cand = ((parents == cur[:, None]) & (tokens == g_cur)
                & (idx >= 1) & (idx <= n_draft[:, None]) & alive[:, None])
        has = cand.any(1)
        child = torch.argmax(cand.to(torch.int32), 1)   # first candidate
        cur = torch.where(has, child, cur)
        n_acc += has.to(torch.int32)
        path[:, t] = torch.where(has, child, 0).to(torch.int32)
        alive &= has
    fix = torch.gather(g, 1, cur.clip(0, rmax)[:, None])[:, 0]
    return fix, n_acc, path


def _tree_walk_sampled(probs, tokens, parents, n_draft, depth: int,
                       gen: torch.Generator | None):
    """Multi-branch acceptance sampling over a token tree (SpecInfer-style
    point-mass residuals), distribution-faithful per row.

    At each accepted node the children are tried in in-row order: child
    token x is accepted with probability ``p(x) / mass`` where ``p`` is
    the target distribution at the node and ``mass`` the residual left by
    previously rejected siblings (whose point mass is zeroed). When every
    child is rejected the fix token is drawn from the residual; at a leaf
    (or full depth) from the plain target — the bonus draw. ``probs [B,
    R, V]`` must already be temperature / top-k filtered; one-hot rows
    reduce exactly to `_tree_walk_greedy`. Draws come from ``gen``.
    """
    b, c = tokens.shape
    dev = tokens.device
    rmax = probs.shape[1] - 1
    us = torch.rand((depth, c, b), generator=gen, device=dev)
    bidx = torch.arange(b, device=dev)

    def take_p(cur):
        return probs[bidx, cur.clip(0, rmax)]

    cur = torch.zeros(b, dtype=torch.int64, device=dev)
    n_acc = torch.zeros(b, dtype=torch.int32, device=dev)
    path = torch.zeros((b, depth), dtype=torch.int32, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    p_bonus = torch.zeros((b, probs.shape[-1]), dtype=probs.dtype,
                          device=dev)
    for t in range(depth):
        accepted = torch.zeros(b, dtype=torch.bool, device=dev)
        child = torch.zeros(b, dtype=torch.int64, device=dev)
        p_res = take_p(cur)
        for j in range(1, c):
            tok_j = tokens[:, j].long()
            is_cand = (alive & ~accepted & (parents[:, j] == cur)
                       & (j <= n_draft))
            p_tok = p_res[bidx, tok_j]
            mass = p_res.sum(1)
            acc = is_cand & (us[t, j] * mass < p_tok)        # P = p_tok / mass
            rej = is_cand & ~acc
            p_res[bidx, tok_j] = torch.where(rej, 0.0, p_tok)
            accepted |= acc
            child = torch.where(acc, j, child)
        stepped = alive & accepted
        p_bonus = torch.where((alive & ~accepted)[:, None], p_res, p_bonus)
        cur = torch.where(stepped, child, cur)
        n_acc += stepped.to(torch.int32)
        path[:, t] = torch.where(stepped, child, 0).to(torch.int32)
        alive = stepped
    p_bonus = torch.where(alive[:, None], take_p(cur), p_bonus)
    safe = torch.where(p_bonus.sum(1, keepdim=True) > 0, p_bonus, 1.0)
    fix = _categorical(torch.log(safe), gen).to(torch.int32)
    return fix, n_acc, path


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
                 spec_decode: str | None = None, spec_k: int = 4,
                 spec_ngram_max: int = 3, spec_adaptive: bool = False,
                 spec_tree: bool = False, spec_tree_fanout: int = 2,
                 draft_model=None, draft_params=None, draft_fn=None,
                 mesh=None, preemption: bool = False,
                 admission: str = "reserved"):
        if model.cfg.is_encoder:
            raise ValueError(f"{model.cfg.name} is encoder-only: no "
                             f"autoregressive decode step (serve it through "
                             f"Model.prefill / forward_logits)")
        # tensor-parallel serving over the mesh's `model` axis; an
        # indivisible head count fails HERE, not inside a kernel
        self._mesh = mesh
        if mesh is not None:
            if "model" not in mesh.axis_names:
                raise ValueError(
                    f"mesh axes {mesh.axis_names} carry no 'model' axis — "
                    f"serving tensor parallelism shards over 'model' "
                    f"(see distributed.serving_mesh)")
            msize = mesh.shape["model"]
            has_attn = any(kind.mixer in ("attn", "hymba")
                           for kind, _ in model.cfg.segments())
            if msize > 1 and has_attn \
                    and model.cfg.num_kv_heads % msize != 0:
                raise ValueError(
                    f"num_kv_heads={model.cfg.num_kv_heads} is not "
                    f"divisible by the {msize}-way 'model' mesh axis — "
                    f"page pools shard over KV heads; choose a mesh size "
                    f"that divides Hkv (or mesh=None)")
        # speculative decoding: "ngram" (prompt-lookup self-drafter, no
        # second model) or "draft_model" (greedy small-model drafter —
        # pass draft_model + draft_params, or a custom draft_fn)
        if spec_decode not in (None, "ngram", "draft_model"):
            raise ValueError(f"unknown spec_decode {spec_decode!r}")
        if spec_decode is not None and spec_k < 1:
            raise ValueError("spec_k must be ≥ 1")
        if spec_decode == "draft_model" and draft_model is None \
                and draft_fn is None:
            raise ValueError("spec_decode='draft_model' needs draft_model "
                             "(+ draft_params) or a draft_fn")
        if draft_model is not None and not self._cache_chunkable(
                draft_model.init_paged_cache(2, page_size, device="meta",
                                             num_slots=1,
                                             slot_seq=page_size)):
            raise ValueError(
                "draft_model keeps bounded per-slot sequential state "
                "(ring/SSM/MLA) — the draft cache must be pure dense "
                "full attention")
        # tree speculation: drafts branch (a primary chain + alternate
        # first tokens), one chunk step verifies every branch under the
        # ancestor mask, and the device-side walk + KV compaction keep
        # greedy streams token-identical to sequential decode
        if spec_tree and spec_decode is None:
            raise ValueError("spec_tree needs a drafter — set "
                             "spec_decode='ngram' or 'draft_model'")
        if spec_tree and spec_tree_fanout < 1:
            raise ValueError("spec_tree_fanout must be ≥ 1")
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        self.spec_adaptive = spec_adaptive
        self.spec_tree = spec_tree
        self.spec_tree_fanout = spec_tree_fanout
        self.spec_ngram_max = spec_ngram_max
        self.draft_model = draft_model
        self.draft_params = draft_params
        self._custom_draft_fn = draft_fn
        # KV positions `_tree_compact` moved (each one strip of every pool
        # leaf in every layer), counted on the device
        self.tree_moves = 0
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
        if mesh is not None and model_devices(mesh)[0] != self.device:
            raise ValueError(
                f"the mesh's first device {model_devices(mesh)[0]} must "
                f"hold the params (on {self.device}): replicated operands "
                f"and the logits live there")
        self._params_run = params
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
    def _prefill_batch(self, batch: dict, max_new_tokens: int):
        """(the batch on the engine's device, B, a dense cache for it): the
        whole batch goes to `Model.prefill`, a vision batch's ``images``
        included, and B is its first value's, as in the reference. The
        cache must hold the prompt (after the image span, at ``num_patches
        + S``) and the ``max_new_tokens - 1`` tokens fed back after it: a
        vision prompt that does not fit raises rather than being cut."""
        dev = {k: torch.as_tensor(
                   v if isinstance(v, torch.Tensor) else np.asarray(v),
                   dtype=torch.int32 if k == "tokens" else None,
                   device=self.device) for k, v in batch.items()}
        b = next(iter(dev.values())).shape[0]
        if "images" in dev:
            need = (dev["images"].shape[1] + dev["tokens"].shape[1]
                    + max_new_tokens - 1)
            if need > self.max_seq:
                raise ValueError(
                    f"max_seq {self.max_seq} does not hold the image span "
                    f"({dev['images'].shape[1]} patches), the "
                    f"{dev['tokens'].shape[1]}-token prompt and "
                    f"{max_new_tokens - 1} fed-back tokens ({need})")
        return dev, b, self.model.init_cache(b, self.max_seq,
                                             device=self.device)

    @torch.no_grad()
    def generate(self, batch: dict, max_new_tokens: int,
                 gen: torch.Generator | None = None) -> np.ndarray:
        """Host-loop generation with EOS early-exit. Returns [B, max_new]."""
        dev, b, cache = self._prefill_batch(batch, max_new_tokens)
        cache, logits, pos = self.model.prefill(self.params, dev, cache)
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
        dev, b, cache = self._prefill_batch(batch, max_new_tokens)
        cache, logits, pos = self.model.prefill(self.params, dev, cache)
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

    def _cache_layout(self, pcfg: PagerConfig, **where):
        """The paged cache for ``pcfg``, on ``where`` (``device=`` or
        ``mesh=``)."""
        return self.model.init_paged_cache(
            pcfg.num_pages, self.page_size, kv_quant=self.kv_quant,
            num_slots=self.num_slots,
            slot_seq=pcfg.pages_per_slot * self.page_size, **where)

    def _serving_init(self) -> Scheduler:
        pager = KVPager(self._pager_config())
        layout = self._cache_layout(pager.cfg, device="meta")
        chunkable = self._cache_chunkable(layout)
        chunked = chunkable if self.chunked_prefill is None \
            else self.chunked_prefill
        if chunked and not chunkable:
            raise ValueError(
                "chunked_prefill=True but the arch keeps bounded per-slot "
                "sequential state (ring/SSM/MLA): only pure paged-attention "
                "caches support the chunked path")
        if self.spec_decode is not None and not chunked:
            raise ValueError(
                "spec_decode requires the chunked serving path (verify "
                "runs are multi-token rows of the unified chunk dispatch)")
        if self._mesh is not None and not chunked:
            raise ValueError(
                "mesh-sharded serving requires the chunked (token-budget) "
                "path: archs with bounded per-slot sequential state "
                "(ring/SSM/MLA) and the one-shot baseline stay "
                "single-device — pass mesh=None")
        if self.preemption and not chunked:
            raise ValueError(
                "preemption requires the chunked serving path: restore "
                "re-enters the unified chunk dispatch at the commit "
                "watermark, which one-shot prefill does not track")
        if self._mesh is None:
            self._paged_cache = self._cache_layout(pager.cfg,
                                                   device=self.device)
        else:
            self._paged_cache = self._cache_layout(pager.cfg,
                                                   mesh=self._mesh)
            self._params_run = shard_params(self.params, self._mesh,
                                            self.cfg)
        # the dim each pool leaf's strips join and split over (None
        # without a mesh): the rule read on the unsharded layout
        self._strip_dims = {
            (seg, leaf): None if self._mesh is None else split_dim(
                paged_cache_pspec(leaf, t, self._mesh))
            for seg, layers in layout.items()
            for leaf, t in layers[0].get("kv_pool", {}).items()}
        self._gen = torch.Generator(device=self.device).manual_seed(self._seed)
        self._tables_version = -1
        self._tables_dev = None
        if chunked:
            draft_fn = None
            sched_spec = None
            if self.spec_decode is not None:
                sched_spec = "ngram" if self.spec_decode == "ngram" \
                    else "draft_fn"
                if self.spec_decode == "draft_model":
                    draft_fn = self._custom_draft_fn
                    if draft_fn is None:
                        self._draft_init()
                        draft_fn = self._draft_tree_fn if self.spec_tree \
                            else self._draft_fn
            return Scheduler(pager, run_batch=self._exec_run_batch,
                             chunk_size=self.prefill_chunk,
                             spec_decode=sched_spec, spec_k=self.spec_k,
                             adaptive_spec_k=self.spec_adaptive,
                             spec_tree=self.spec_tree,
                             spec_tree_fanout=self.spec_tree_fanout,
                             draft_fn=draft_fn,
                             ngram_max=self.spec_ngram_max,
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
                        topks, n_draft=None, tree=None):
        """One unified chunk step (the Scheduler's ``run_batch``). With
        drafts in ``n_draft`` it is a verify step returning ``(fix,
        n_acc)``; with ``tree`` a tree verify step returning ``(fix,
        n_acc, path)``, the accepted branch's KV already compacted. Only
        those integers come back to the host, in one copy."""
        dev = self.device
        tables = self._device_tables(self._context_bucket(int(pos.max())))
        page_table = tables[torch.as_tensor(row_slots, device=dev).long()]
        args = [torch.as_tensor(a, dtype=torch.int32, device=dev)
                for a in (tokens, pos, sample_idx)]
        greedy = not np.any(temps) and not np.any(topks)
        if tree is not None or (n_draft is not None and n_draft.any()):
            args.append(torch.as_tensor(n_draft, dtype=torch.int32,
                                        device=dev))
            if tree is not None:
                args += [torch.as_tensor(tree[k], device=dev)
                         for k in ("rpos", "amask", "parents")]
                fn = self._tree_greedy if greedy else self._tree_sampled
            else:
                fn = self._spec_greedy if greedy else self._spec_sampled
            if not greedy:
                args += [torch.as_tensor(temps, dtype=torch.float32,
                                         device=dev),
                         torch.as_tensor(topks, dtype=torch.int32,
                                         device=dev)]
            res = fn(page_table, *args)
            if tree is None:
                out = torch.stack(res, 1).cpu().numpy()
                return out[:, 0], out[:, 1]
            fix, n_acc, path, moved = res
            out = torch.cat([torch.stack([fix, n_acc, moved], 1), path],
                            1).cpu().numpy()
            self.tree_moves += int(out[:, 2].sum())
            return out[:, 0], out[:, 1], out[:, 3:]
        logits, self._paged_cache = self.model.chunk_step(
            self._params_run, self._paged_cache, *args, page_table=page_table,
            mesh=self._mesh)
        out = self._sample_rows(logits, temps, topks).cpu().numpy()
        if n_draft is None:
            return out
        return out, np.zeros(out.shape[0], np.int32)

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

    # --- speculative verify steps -----------------------------------------
    # A verify row is a multi-token decode row of the unified chunk step:
    # tokens[b, sample_idx[b] : sample_idx[b] + 1 + n_draft[b]] is the run
    # [last_sampled, d_1 … d_k] at consecutive positions, and
    # `chunk_step(num_logits = spec_k + 1)` returns the target
    # distribution after each of them. Acceptance runs on the device, so
    # the vocab-sized distributions never leave it: each row returns its
    # leading-accept count and ONE corrected/bonus token.

    def _verify_logits(self, page_table, tokens, pos, sample_idx,
                       rpos=None, amask=None) -> torch.Tensor:
        """One chunk step gathering ``spec_k + 1`` logits a row:
        ``[B, spec_k + 1, V]`` f32; the pools update in place."""
        logits, self._paged_cache = self.model.chunk_step(
            self._params_run, self._paged_cache, tokens, pos, sample_idx,
            page_table=page_table, num_logits=self.spec_k + 1, rpos=rpos,
            amask=amask, mesh=self._mesh)
        return logits

    def _spec_greedy(self, page_table, tokens, pos, sample_idx, n_draft):
        """Greedy verify: accept the longest draft prefix that matches the
        argmax chain; the fix token is the argmax after it (the corrected
        token on rejection, the bonus token on full acceptance) — exactly
        the tokens sequential greedy decode would emit."""
        logits = self._verify_logits(page_table, tokens, pos, sample_idx)
        g = torch.argmax(logits, dim=-1).to(torch.int32)        # [B, R]
        draft_next, j = _spec_gather_drafts(tokens, sample_idx, g.shape[1])
        ok = (draft_next == g) & (j < n_draft[:, None])
        n_acc = torch.cumprod(ok.to(torch.int32), 1).sum(1).to(torch.int32)
        fix = torch.gather(g, 1, n_acc.long()[:, None])[:, 0]
        return fix, n_acc

    def _spec_sampled(self, page_table, tokens, pos, sample_idx, n_draft,
                      temps, topks):
        """Acceptance sampling for point-mass drafts, distribution-faithful
        per row: draft d_j is accepted with probability p(d_j) under the
        row's (temperature / top-k filtered) target distribution; on the
        first rejection the fix token is drawn from the residual — the
        target with d_j removed, renormalized — and on full acceptance
        from the plain target at the bonus position. Greedy rows reduce to
        the argmax chain of `_spec_greedy`; rows with ``n_draft == 0`` to
        one plain sample at ``sample_idx``. Draws come from the engine's
        seeded generator."""
        logits = self._verify_logits(page_table, tokens, pos, sample_idx)
        v = logits.shape[-1]
        g = torch.argmax(logits, dim=-1).to(torch.int32)
        scaled = _filter_logits(logits, temps, topks)
        probs = torch.softmax(scaled, dim=-1)
        draft_next, j = _spec_gather_drafts(tokens, sample_idx, g.shape[1])
        p_draft = torch.gather(probs, -1, draft_next.long()[..., None])[..., 0]
        u = torch.rand(p_draft.shape, generator=self._gen,
                       device=p_draft.device)
        greedy = (temps == 0.0)[:, None]
        ok = torch.where(greedy, draft_next == g, u < p_draft)
        ok &= j < n_draft[:, None]
        n_acc = torch.cumprod(ok.to(torch.int32), 1).sum(1).to(torch.int32)
        dmask = torch.nn.functional.one_hot(draft_next.long(), v).bool()
        rej = _categorical(scaled.masked_fill(dmask, -1e30), self._gen)
        bon = _categorical(scaled, self._gen)
        # greedy rows: the residual argmax IS the global argmax (a greedy
        # rejection means draft ≠ argmax), and the bonus is the argmax too
        rej = torch.where(greedy, g, rej.to(torch.int32))
        bon = torch.where(greedy, g, bon.to(torch.int32))
        idx = n_acc.long()[:, None]
        fix = torch.where(n_acc == n_draft, torch.gather(bon, 1, idx)[:, 0],
                          torch.gather(rej, 1, idx)[:, 0])
        return fix, n_acc

    # --- tree-speculative verify steps ------------------------------------
    # A tree verify row carries a whole token TREE at contiguous KV slots
    # (node i at slot q + 1 + i, in node-index order): `chunk_step` runs
    # ONE weight pass with the per-row ancestor mask routing each node's
    # attention to exactly its own root path, and with ``rpos`` giving
    # nodes their LOGICAL position q + depth(i) (siblings share a depth,
    # so their RoPE angles match what sequential decode would use). The
    # device-side walk picks the deepest accepted branch, and that
    # branch's KV is compacted into the contiguous slots sequential
    # decode would have written; after the host truncates the losing
    # branches the pages hold what a sequential run would have written.

    def _tree_compact(self, pt, q, path, n_acc) -> torch.Tensor:
        """Move the accepted branch's strips into place; returns the moves
        a row ([B] int32).

        For accepted depth ``t`` (1-based) the node at in-row index
        ``path[:, t-1]`` moves from KV slot ``q + path[:, t-1]`` to slot
        ``q + t`` in every pool leaf (int8 codes and scale strips
        included). The pools are updated in place, so each leaf gathers
        every source strip into a temporary before its one scatter:
        chained moves within a row cannot clobber each other. No-op moves
        (node already in place), depths beyond ``n_acc`` and padding rows
        (``q < 0``) are redirected to offset 0 of the scratch page 0.
        Those duplicate destinations make the scatter's write order to
        that one position undefined on CUDA, which is harmless only
        because page 0 is never read: keep it so.
        """
        ps = self.page_size
        t = torch.arange(1, path.shape[1] + 1, dtype=torch.int32,
                         device=path.device)[None, :]
        live = (t <= n_acc[:, None]) & (path != t) & (q[:, None] >= 0)
        src = torch.where(live, q[:, None] + path, 0).long()
        dst = torch.where(live, q[:, None] + t, 0).long()
        pt = pt.long()
        sp = torch.where(live, torch.gather(pt, 1, src // ps), 0).reshape(-1)
        dp = torch.where(live, torch.gather(pt, 1, dst // ps), 0).reshape(-1)
        so, do = (src % ps).reshape(-1), (dst % ps).reshape(-1)
        for _, cache in self._shard_caches():
            for layers in cache.values():
                for entry in layers:
                    for leaf in entry["kv_pool"].values():
                        d = leaf.device
                        leaf.index_put_((dp.to(d), do.to(d)),
                                        leaf[sp.to(d), so.to(d)])
        return live.sum(1).to(torch.int32)

    def _tree_greedy(self, page_table, tokens, pos, sample_idx, n_draft,
                     rpos, amask, parents):
        """Greedy tree verify: one weight pass over every branch, then the
        argmax walk — emits exactly the tokens sequential greedy decode
        would (rows with ``n_draft == 0`` degenerate to plain decode).
        Returns ``(fix, n_acc, path, moves)``."""
        logits = self._verify_logits(page_table, tokens, pos, sample_idx,
                                     rpos, amask)
        g = torch.argmax(logits, dim=-1).to(torch.int32)
        fix, n_acc, path = _tree_walk_greedy(g, tokens, parents, n_draft,
                                             self.spec_k)
        moved = self._tree_compact(page_table, pos[:, 0], path, n_acc)
        return fix, n_acc, path, moved

    def _tree_sampled(self, page_table, tokens, pos, sample_idx, n_draft,
                      rpos, amask, parents, temps, topks):
        """Sampled tree verify: residual acceptance over sibling branches
        (`_tree_walk_sampled`); greedy rows ride a one-hot target, so
        mixed-sampler steps keep their greedy rows argmax-exact."""
        logits = self._verify_logits(page_table, tokens, pos, sample_idx,
                                     rpos, amask)
        v = logits.shape[-1]
        g = torch.argmax(logits, dim=-1)
        probs = torch.softmax(_filter_logits(logits, temps, topks), dim=-1)
        probs = torch.where(
            (temps == 0.0)[:, None, None],
            torch.nn.functional.one_hot(g, v).to(probs.dtype), probs)
        fix, n_acc, path = _tree_walk_sampled(probs, tokens, parents,
                                              n_draft, self.spec_k, self._gen)
        moved = self._tree_compact(page_table, pos[:, 0], path, n_acc)
        return fix, n_acc, path, moved

    # --- draft-model drafting (spec_decode="draft_model") -----------------
    # The draft model keeps a DENSE per-slot cache [num_slots, max_seq]
    # (it is small by construction — paging it would buy nothing): lazy
    # per-slot prefill when a request starts decoding, then k + 1 greedy
    # decode steps per scheduler step (the extra step writes the last
    # draft's KV, so after full acceptance the draft cache is already
    # caught up to the bonus token's position). Rejected-draft KV is
    # simply overwritten — positions are absolute, and the next step's
    # inputs rewrite every position past the accepted stream before any
    # causal read can see it.

    def _draft_init(self):
        self._draft_cache = self.draft_model.init_cache(
            self.num_slots, self.max_seq, device=self.device)
        self._draft_rid: dict[int, int] = {}

    def _draft_prefill(self, tokens: np.ndarray, slot: int) -> None:
        """tokens [S] → the draft cache's rows 0..S-1 of ``slot`` rewritten.

        ``tokens`` is the context zero-padded up to a geometric length
        bucket (`_draft_bucket`), the reference's bound on its compiled
        family. The pad tail's KV (a zero continuation of the real prefix)
        lands at positions ≥ the real context length — exactly the
        positions drafting rewrites before any causal read can see them,
        the same dead-KV argument that covers rejected drafts.
        """
        toks = torch.as_tensor(tokens, dtype=torch.int32,
                               device=self.device)[None]
        pre = self.draft_model.init_cache(1, toks.shape[1],
                                          device=self.device)
        pre, _, _ = self.draft_model.prefill(self.draft_params,
                                             {"tokens": toks}, pre)
        for seg, layers in self._draft_cache.items():
            for i, entry in enumerate(layers):
                for k, leaf in entry["kv"].items():
                    _commit_dense_leaf(leaf, pre[seg][i]["kv"][k], slot)

    def _draft_bucket(self, n: int) -> int:
        """Geometric draft-prefill length bucket covering ``n`` tokens."""
        b = 8
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def _draft_logits(self, tok: np.ndarray, posv: np.ndarray):
        dev = self.device
        logits, self._draft_cache = self.draft_model.decode_step(
            self.draft_params, self._draft_cache,
            torch.as_tensor(tok, dtype=torch.int32, device=dev),
            torch.as_tensor(posv, dtype=torch.int32, device=dev))
        return logits

    def _draft_step(self, tok: np.ndarray, posv: np.ndarray) -> np.ndarray:
        """One greedy draft decode step over every slot → argmax [B]."""
        return torch.argmax(self._draft_logits(tok, posv), dim=-1).to(
            torch.int32).cpu().numpy()

    def _draft_top(self, tok: np.ndarray, posv: np.ndarray, f: int
                   ) -> np.ndarray:
        """Top-``f`` next tokens per row (column 0 = the argmax) — the
        branching first step of tree drafting."""
        return torch.topk(self._draft_logits(tok, posv), f, dim=-1).indices \
            .to(torch.int32).cpu().numpy()

    def _draft_catch_up(self, reqs) -> None:
        """Prefill the draft cache of every slot whose request changed."""
        for slot, rid, ctx, q, *_ in reqs:
            if self._draft_rid.get(slot) != rid:   # slot reused: re-prefill
                padded = np.zeros(self._draft_bucket(q), np.int32)
                padded[:q] = ctx[:q]
                self._draft_prefill(padded, slot)
                self._draft_rid[slot] = rid

    @torch.no_grad()
    def _draft_fn(self, reqs):
        """Scheduler drafting hook: [(slot, rid, ctx, next_pos, k_eff)] →
        {slot: draft tokens} via greedy draft-model decode."""
        self._draft_catch_up(reqs)
        tok = np.zeros(self.num_slots, np.int32)
        posv = np.zeros(self.num_slots, np.int32)
        active: dict[int, int] = {}
        for slot, _rid, ctx, q, k in reqs:
            tok[slot] = int(ctx[-1])
            posv[slot] = q
            active[slot] = k
        props: dict[int, list[int]] = {slot: [] for slot in active}
        for i in range(max(active.values()) + 1):
            nxt = self._draft_step(tok, posv)
            for slot, k in active.items():
                if i < k:
                    props[slot].append(int(nxt[slot]))
                    tok[slot] = int(nxt[slot])
                    posv[slot] += 1
                # i ≥ k: frozen — the row idempotently rewrites its last
                # draft's KV (rows of inactive slots idle at position 0,
                # which the next per-slot prefill rewrites)
        return props

    @torch.no_grad()
    def _draft_tree_fn(self, reqs):
        """Tree drafting hook (``spec_tree``): the draft model's top-
        ``fanout`` first-step tokens branch the root — the top-1 opens
        the primary chain (continued greedily), the rest become depth-1
        alternates hedging a chain miss. Alternates consume node budget:
        the chain keeps ``k_eff − #alternates`` nodes, so the row width
        never exceeds the linear verify bucket. Same lazy per-slot
        dense-cache prefill and idempotent-rewrite argument as
        `_draft_fn`; requests carry a trailing ``fanout`` element."""
        self._draft_catch_up(reqs)
        tok = np.zeros(self.num_slots, np.int32)
        posv = np.zeros(self.num_slots, np.int32)
        chain: dict[int, int] = {}        # slot → chain length left
        fans: dict[int, int] = {}
        for slot, _rid, ctx, q, k, f in reqs:
            tok[slot] = int(ctx[-1])
            posv[slot] = q
            chain[slot] = k
            fans[slot] = f
        fmax = max(max(fans.values()), 1)
        nodes: dict[int, list[tuple[int, int]]] = {s: [] for s in chain}
        last: dict[int, int] = {}         # slot → chain tip node index
        alts: dict[int, list[int]] = {}
        for i in range(max(chain.values()) + 1):
            if i == 0:
                top = self._draft_top(tok, posv, fmax)
                nxt = top[:, 0]
            else:
                nxt = self._draft_step(tok, posv)
            for slot, k in chain.items():
                if i == 0:
                    a = [int(t) for t in top[slot, 1:fans[slot]]][:k - 1]
                    alts[slot] = a
                    chain[slot] = k - len(a)   # chain keeps the rest
                    nodes[slot].append((int(nxt[slot]), -1))
                    last[slot] = 0
                    tok[slot] = int(nxt[slot])
                    posv[slot] += 1
                elif i < chain[slot]:
                    nodes[slot].append((int(nxt[slot]), last[slot]))
                    last[slot] = len(nodes[slot]) - 1
                    tok[slot] = int(nxt[slot])
                    posv[slot] += 1
                # i ≥ chain length: frozen, same dead-KV argument as above
        for slot, a in alts.items():
            nodes[slot].extend((t, -1) for t in a)
        return nodes

    # --- host-memory page tier (preemption spill/restore) -----------------
    def _shard_caches(self) -> list:
        """(device, paged cache) of every shard: one without a mesh."""
        if self._mesh is None:
            return [(self.device, self._paged_cache)]
        return list(zip(model_devices(self._mesh), self._paged_cache))

    def _pool_leaves(self):
        """(seg, leaf name, the dim a mesh stripes it over or None, and a
        shard's [per-layer pool tensors] for every shard) for every pool
        leaf of the paged cache: codes and, for int8 pools, scale
        strips."""
        caches = [c for _, c in self._shard_caches()]
        for seg, layers in caches[0].items():
            for leaf in layers[0]["kv_pool"]:
                yield seg, leaf, self._strip_dims[seg, leaf], [
                    [e["kv_pool"][leaf] for e in c[seg]] for c in caches]

    def _exec_spill(self, phys_ids: list[int]) -> dict:
        """Scheduler spill hook: gather ``phys_ids``'s pool bytes BEFORE the
        pager releases those pages. The gather is enqueued on the device's
        stream ahead of any later write into the pages (the pools update
        in place), and each leaf's ``[L, n, P, ...]`` strip is copied into
        pinned host memory without blocking; ``event`` marks the copies'
        completion for a host reader (`handoff_wire`). Int8 pools leave
        as stored: codes plus scale strips, never re-inflated. Under a
        mesh each strip leaves whole: the shards' KV-head pieces joined
        (`distributed.sharding.strip_gather`)."""
        dev = self.device
        devices = [d for d, _ in self._shard_caches()]
        ids = torch.as_tensor(phys_ids, dtype=torch.long, device=dev)
        strips: dict = {}
        for seg, leaf, dim, shard_pools in self._pool_leaves():
            g = strip_gather([torch.stack([pool.index_select(0, ids.to(d))
                                           for pool in pools])
                              for d, pools in zip(devices, shard_pools)],
                             dim, devices)
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
        leaf, one host→device copy each; under a mesh the whole strip is
        re-striped over KV heads on the way in
        (`distributed.sharding.strip_scatter`)."""
        dev = self.device
        devices = [d for d, _ in self._shard_caches()]
        ids = torch.as_tensor(fresh_ids, dtype=torch.long, device=dev)
        for seg, leaf, dim, shard_pools in self._pool_leaves():
            src = torch.as_tensor(strips[seg][leaf]).view(
                shard_pools[0][0].dtype)
            pieces = strip_scatter(src.to(dev, non_blocking=True), dim,
                                   devices)
            for d, piece, pools in zip(devices, pieces, shard_pools):
                for layer, pool in enumerate(pools):
                    pool.index_copy_(0, ids.to(d), piece[layer])

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
        strips = {seg: {k: host_numpy(t) for k, t in leaves.items()}
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

    @torch.no_grad()
    def warmup(self) -> int:
        """Run one all-padding dispatch of every width the scheduler may
        pick (`scheduler.width_family`, verify widths included), so the
        first request pays no first-launch cost (kernel loads, allocator
        growth); under speculation each width of 2 or more also runs the
        greedy verify step (and the tree verify step, with an all-false
        ancestor mask). Padding only touches the scratch page and no
        counter of `stats()`. Returns the number of dispatches run: 0 on
        the one-shot path, whose prefill runs at each prompt's own
        length."""
        if self._scheduler is None:
            self._scheduler = self._serving_init()
        if not self._scheduler.chunked:
            return 0
        b, dev = self.num_slots, self.device
        n = 0
        for c in self._scheduler.width_buckets:
            tokens = np.zeros((b, c), np.int32)
            pos = np.full((b, c), -1, np.int32)
            zeros_i = np.zeros(b, np.int32)
            self._exec_run_batch(tokens, pos, zeros_i, zeros_i,
                                 np.zeros(b, np.float32), zeros_i)
            n += 1
            if self.spec_decode is None or c < 2:
                continue        # a width-1 row can never carry a draft
            page_table = self._device_tables(self._context_bucket(0))[
                torch.zeros(b, dtype=torch.long, device=dev)]
            args = [torch.as_tensor(a, device=dev)
                    for a in (tokens, pos, zeros_i, zeros_i)]
            self._spec_greedy(page_table, *args)
            n += 1
            if self.spec_tree:
                # padding rows: -1 logical positions and parents, and an
                # all-false ancestor mask (nothing visible in the span)
                none = args[1]
                self._tree_greedy(
                    page_table, *args, none,
                    torch.zeros((b, c, c), dtype=torch.bool, device=dev),
                    none)
                n += 1
        return n

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
            # what serving would start with: a chunked scheduler's draft
            # length and fanout, or a one-shot scheduler's defaults
            spec_k_now, fanout_now = (
                (self.spec_k, min(self.spec_tree_fanout, 2)
                 if self.spec_tree else 1)
                if self.chunked_prefill is not False else (_SPEC_K, 1))
        else:
            st = self._scheduler.stats
            queued = len(self._scheduler.queue) + len(self._scheduler.preempted)
            pager_stats = self._scheduler.pager.stats()
            spec_k_now = self._scheduler.spec_k_cur
            fanout_now = self._scheduler.fanout_cur
        pool_bytes, per_shard = self._pool_bytes()
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
            spec_k_now=spec_k_now,
            spec_fanout_now=fanout_now,
            preemptions=st.preemptions,
            pressure_spills=st.pressure_spills,
            restores=st.restores,
            spilled_pages=st.spilled_pages,
            restored_pages=st.restored_pages,
            pages_spilled_now=pager_stats.pages_spilled,
            restore_ms_mean=st.restore_time_s * 1e3 / max(st.restores, 1),
            model_axis=(1 if self._mesh is None
                        else int(self._mesh.shape.get("model", 1))),
            kv_pool_bytes=pool_bytes,
            kv_pool_bytes_per_device=per_shard,
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
    def _pool_bytes(self) -> tuple[int, int]:
        """(all shards', one shard's) page-pool bytes over all layers, from
        the pools' layout on the ``meta`` device (nothing is allocated).
        Only page pools count (an MLA layer's dense per-slot latents are
        not paged), as in the reference; a pool leaf a mesh stripes holds
        1/n of its bytes on a shard."""
        pcfg = self._pager_config()
        total = per_shard = 0
        n = 1 if self._mesh is None else self._mesh.shape["model"]
        for layers in self._cache_layout(pcfg, device="meta").values():
            for entry in layers:
                for leaf, t in entry.get("kv_pool", {}).items():
                    nbytes = _tensor_bytes(t)
                    total += nbytes
                    striped = self._mesh is not None and split_dim(
                        paged_cache_pspec(leaf, t, self._mesh)) is not None
                    per_shard += nbytes // n if striped else nbytes
        return total, per_shard

    def paged_kv_page_bytes(self) -> int:
        """Bytes one physical page costs across all layers (codes + scale
        strips for int8 pools), all shards together: the unit of the
        serving memory budget."""
        return self._pool_bytes()[0] // self._pager_config().num_pages

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
