"""Top-level model: embeddings / frontends → stack → (tied) f32 head.

One class serves every config, as in the reference:

  * decoder LMs      — token embedding → causal stack → (tied) head;
  * encoder (hubert) — stub frame features ``[B, S, frontend_dim]`` →
                       ``frame_proj`` → bidirectional stack → a head over
                       the codebook vocabulary at every frame;
  * vlm (phi3-v)     — stub patch embeddings → ``patch_proj``, prepended
                       to the token embeddings (labels masked over the
                       image span); decode is a plain LM step once
                       prefilled, at positions after the image span.

Entry points mirror the reference's `Model`: `prefill` + `decode_step`
over the dense cache (`GenerationEngine.generate`; under a ``mesh`` the
placed step, parameters by `param_pspec` and the cache by `cache_pspec`)
or, with a page table, over the page pools (the one-shot serving path),
`chunk_step` over the
paged pools (the chunked serving path), `forward_logits`, and `loss`, the
chunked-vocab causal-LM (or masked-unit) loss plus the MoE layers' router
aux losses (AWQ's calibration forward and the train step's objective,
`training.train_step`). The frontend linears run unnamed, so the
calibration capture records nothing for them, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype

from repro_torch.distributed.sharding import (all_sum, concat, model_devices,
                                              paged_cache_pspec,
                                              replica_meshes, shard_tree,
                                              split, split_batch)
from repro_torch.models import blocks, layers, stack
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (embed_lookup, embed_lookup_tp,
                                       gathered, linear, linear_tp, norm)
from repro_torch.numerics import free_rows, matmul_f32_rows, matmul_wide_rows
from repro_torch.utils.tree import layer_parts


def _remat_block_tp(ps, x, cfg, kind, mesh, positions):
    """One sharded train-mode block as the backward recomputes it (inside
    `numerics.free_rows`, as `stack._remat_block`)."""
    with free_rows():
        return blocks.block_apply_tp(ps, x, cfg, kind, mesh=mesh,
                                     positions=positions, mode="train")[0]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator | None = None, device=None) -> dict:
        """Random params (the reference's distributions). ``gen`` must live
        on ``device`` (cuda unless the caller asks for the CPU)."""
        cfg = self.cfg
        device = resolve_device(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        dtype = torch_dtype(cfg.param_dtype)
        params: dict = {
            "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, device=device),
            "segments": stack.stack_init(gen, cfg, dtype, device),
            "final_norm": layers.norm_init(cfg.d_model,
                                           norm_type=cfg.norm_type,
                                           dtype=dtype,
                                           plus_one=cfg.rms_plus_one,
                                           device=device),
        }
        if cfg.frontend != "none":
            proj = "frame_proj" if cfg.frontend == "audio" else "patch_proj"
            params["frontend"] = {proj: layers.linear_init(
                gen, cfg.frontend_dim, cfg.d_model, bias=True, dtype=dtype,
                device=device)}
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.linear_init(
                gen, cfg.d_model, cfg.vocab_size, dtype=dtype, device=device)
        return params

    # ------------------------------------------------------------ embeddings
    def _embed(self, params, batch: dict, devices: list | None = None):
        """→ (x [B, S, D], positions [B, S], labels or None).

        audio: ``frame_proj(features)``; vision with ``images`` in the
        batch: ``patch_proj(images)`` before the token embeddings, and the
        labels (when given) padded with -1 over the image span; positions
        ``arange(S)`` over the whole sequence. The frontend linears run
        unnamed (no calibration capture), as one product each
        (`numerics.free_rows`: a full-sequence input). Under a mesh
        (``devices``: the ``model`` shards' devices; ``params``: one tree
        a shard) the table is looked up over its shards
        (`layers.embed_lookup_tp`) and the frontend linear runs
        column-parallel, its columns joined: x is replicated."""
        cfg = self.cfg
        adt = torch_dtype(cfg.activation_dtype)
        labels = batch.get("labels")

        def front(name, feats):
            with free_rows():
                if devices is None:
                    return linear(params["frontend"][name], feats.to(adt))
                return gathered(linear_tp(
                    [p["frontend"][name] for p in params], feats.to(adt),
                    devices, cfg.frontend_dim, cfg.d_model), devices)

        if cfg.frontend == "audio":
            x = front("frame_proj", batch["features"])
        else:
            x = (embed_lookup(params["embed"], batch["tokens"],
                              scale=cfg.scale_embed) if devices is None
                 else embed_lookup_tp([p["embed"]["table"] for p in params],
                                      batch["tokens"], devices,
                                      cfg.vocab_size, cfg.d_model,
                                      scale=cfg.scale_embed)).to(adt)
            if cfg.frontend == "vision" and "images" in batch:
                img = front("patch_proj", batch["images"])
                x = torch.cat([img, x], dim=1)
                if labels is not None:
                    labels = torch.as_tensor(labels, device=x.device)
                    pad = torch.full(img.shape[:2], -1, dtype=labels.dtype,
                                     device=x.device)
                    labels = torch.cat([pad, labels], dim=1)
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        return x, positions, labels

    def _head_logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """f32 logits; the head (tied: the embedding table; untied:
        ``lm_head``, which the AWQ pipeline never quantizes) is a plain f32
        ``[.., D] × [D, V]`` product (the largest read of a decode step,
        outside any kernel), whose rows do not depend on how many share
        the call (`numerics.matmul_f32_rows`, also through `linear`): a
        verify step's rows equal the same rows decoded one step at a
        time."""
        if self.cfg.tie_embeddings:
            return matmul_f32_rows(x, params["embed"]["table"].t())
        return linear(params["lm_head"], x.to(torch.float32))

    def _head_logits_tp(self, params: list, x: torch.Tensor,
                        devices: list) -> torch.Tensor:
        """`_head_logits` over the shards: each shard's vocab slice of the
        (tied or untied) head, logits joined in shard order. The products
        sum over d, which no shard splits, so each slice's bits are the
        unsharded head's; a table split over d instead sums the shards'
        partial products, rounded once. Differentiable (the train step's
        head under a mesh)."""
        cfg = self.cfg
        if not cfg.tie_embeddings:
            return gathered(linear_tp([p["lm_head"] for p in params],
                                      x.to(torch.float32), devices,
                                      cfg.d_model, cfg.vocab_size), devices)
        tables = [p["embed"]["table"] for p in params]
        if tables[0].shape[0] < cfg.vocab_size:
            return concat([matmul_f32_rows(x.to(d), t.t())
                           for t, d in zip(tables, devices)], -1, devices)
        if tables[0].shape[1] < cfg.d_model:
            xs = split(x, -1, devices)
            return all_sum([matmul_wide_rows(xi, t.t())
                            for xi, t in zip(xs, tables)],
                           devices).to(torch.float32)
        return matmul_f32_rows(x, tables[0].t())

    # ----------------------------------------------------------------- loss
    def _replica_forward(self, ps: list, batch: dict, rmesh):
        """One data replica's full-sequence forward over its ``model``
        shards ``ps`` → (x after the final norm, labels, the head: a
        function of x's positions to their f32 logits). One shard runs
        the unsharded stack; more run `blocks.block_apply_tp` layer by
        layer (every family; remat checkpoints each block as
        `stack_apply` does)."""
        cfg = self.cfg
        devices = model_devices(rmesh)
        if len(devices) == 1:
            x, positions, labels = self._embed(ps[0], batch)
            x, _, _ = stack.stack_apply(ps[0]["segments"], x, cfg,
                                        mode="train", positions=positions)
            return (norm(ps[0]["final_norm"], x, cfg), labels,
                    lambda xc: self._head_logits(ps[0], xc))
        x, positions, labels = self._embed(ps, batch, devices)
        remat = cfg.remat and torch.is_grad_enabled()
        with free_rows():
            for si, (kind, n) in enumerate(cfg.segments()):
                seg = stack.seg_name(si)
                for i in range(n):
                    lps = [p["segments"][seg][i] for p in ps]
                    if remat:
                        x = checkpoint(_remat_block_tp, lps, x, cfg, kind,
                                       rmesh, positions, use_reentrant=False)
                    else:
                        x, _ = blocks.block_apply_tp(
                            lps, x, cfg, kind, mesh=rmesh,
                            positions=positions, mode="train")
        return (norm(ps[0]["final_norm"], x, cfg), labels,
                lambda xc: self._head_logits_tp(ps, xc, devices))

    def _loss_mesh(self, params: list, batch: dict, mesh):
        """`loss` over a mesh: replica r runs batch slice r
        (`split_batch`); the loss is the reference's over the whole
        batch, Σ tot / Σ cnt (summed in replica order) plus each MoE
        layer's aux over all replicas' tokens (`moe.global_aux`)."""
        cfg = self.cfg
        rms = replica_meshes(mesh)
        dev = rms[0].devices[0]
        tot = torch.zeros((), dtype=torch.float32, device=dev)
        cnt = torch.zeros((), dtype=torch.float32, device=dev)
        with moe_mod.route_log() as routes:
            for ps, b, rm in zip(params, split_batch(batch, mesh), rms):
                x, labels, head = self._replica_forward(ps, b, rm)
                t, c = self._ce_sums(head, x, labels)
                tot, cnt = tot + t.to(dev), cnt + c.to(dev)
        ce = tot / torch.clamp(cnt, min=1.0)
        aux = (moe_mod.global_aux(routes, len(rms), cfg).to(dev) if routes
               else torch.zeros((), dtype=torch.float32, device=dev))
        return ce + aux, {"ce": ce, "aux": aux, "tokens": cnt}

    def _ce_sums(self, head, x, labels):
        """(Σ token losses, Σ valid tokens) in f32, the logits formed
        ``logits_chunk`` positions at a time (`numerics.free_rows`)."""
        labels = torch.as_tensor(labels, device=x.device).long()
        s = x.shape[1]
        chunk = min(self.cfg.logits_chunk, s)
        if s % chunk:
            chunk = s
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, s, chunk):
            with free_rows():
                logits = head(x[:, c0:c0 + chunk])
            li = labels[:, c0:c0 + chunk]
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, li.clamp_min(0)[..., None])[..., 0]
            valid = (li >= 0).to(torch.float32)
            tot = tot + ((logz - ll) * valid).sum()
            cnt = cnt + valid.sum()
        return tot, cnt

    def loss(self, params, batch: dict, mesh=None
             ) -> tuple[torch.Tensor, dict]:
        """Chunked-vocab causal-LM loss: tokens / labels ``[B, S]``
        (hubert: features and codeword labels; phi3-v: labels over the
        text, padded over the image span by `_embed`), labels < 0
        ignored. The f32 logits are formed ``logits_chunk``
        positions at a time, never as one [B, S, V]. Differentiable: the
        train step calls ``backward()`` on it, and the attention of every
        layer runs K4 forward and K4b backward on the card. The head runs
        inside `numerics.free_rows` (one product a chunk): a training
        forward's rows are never held against serving rows.

        Under a ``mesh`` (``(data, model)``, or ``model`` alone),
        ``params`` is one list of ``model``-shard trees a data replica
        (`distributed.sharding.replica_params`); see `_loss_mesh`."""
        cfg = self.cfg
        if batch.get("labels") is None:
            raise ValueError("training batch needs labels")
        if mesh is not None:
            return self._loss_mesh(params, batch, mesh)
        x, positions, labels = self._embed(params, batch)
        x, _, aux = stack.stack_apply(params["segments"], x, cfg,
                                      mode="train", positions=positions)
        x = norm(params["final_norm"], x, cfg)
        tot, cnt = self._ce_sums(lambda xc: self._head_logits(params, xc),
                                 x, labels)
        ce = tot / torch.clamp(cnt, min=1.0)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": cnt}

    def unread_leaves(self, params, batch: dict) -> list[str]:
        """Paths (the reference's) of the leaves `loss` does not read for
        ``batch``: an audio encoder's token table (it embeds features
        through ``frame_proj`` and has its own head), a vision model's
        ``patch_proj`` when the batch has no ``images``. Their gradient
        is zero, as `jax.grad` gives it."""
        cfg = self.cfg
        prefixes = []
        if cfg.frontend == "audio" and not cfg.tie_embeddings:
            prefixes.append("embed/")
        if cfg.frontend == "vision" and "images" not in batch:
            prefixes.append("frontend/patch_proj/")
        return [path for path, _, _ in layer_parts(params)
                if path.startswith(tuple(prefixes))]

    # ---------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_seq: int | None = None,
                   dtype=torch.bfloat16, device=None) -> Any:
        return stack.stack_init_cache(self.cfg, batch,
                                      max_seq or self.cfg.max_seq_len,
                                      dtype, resolve_device(device))

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype=torch.bfloat16, kv_quant: str | None = None,
                         device=None, *, num_slots: int | None = None,
                         slot_seq: int | None = None, mesh=None) -> Any:
        """Page pools for the serving engine; ``kv_quant`` ("none" |
        "int8" | None = follow ``cfg.kv_quant``) picks their storage.
        Per-slot state stays dense beside them (`blocks.
        init_block_cache_paged`): MLA latents ``[num_slots, slot_seq,
        ...]`` in ``dtype``, SSM conv caches and states, a windowed hymba
        layer's ring; a model with such layers needs both ``num_slots``
        and ``slot_seq`` (it raises without them). mamba2's cache has no
        page pool at all. Under a ``mesh`` (``device`` is then unused):
        one cache a shard of its ``model`` axis, each pool striped over KV
        heads by `distributed.sharding.paged_cache_pspec` and allocated on
        its shard's device."""
        if mesh is not None:
            layout = stack.stack_init_paged_cache(
                self.cfg, num_pages, page_size, dtype, kv_quant, "meta",
                num_slots=num_slots, slot_seq=slot_seq)
            return shard_tree(layout, mesh, paged_cache_pspec)
        return stack.stack_init_paged_cache(self.cfg, num_pages, page_size,
                                            dtype, kv_quant,
                                            resolve_device(device),
                                            num_slots=num_slots,
                                            slot_seq=slot_seq)

    def prefill(self, params, batch: dict, cache: Any, mesh=None):
        """Full-sequence prefill → (cache, logits, next pos [B]): the last
        position's logits ``[B, V]``, or an encoder's at every frame
        ``[B, S, V]``. The cache must hold the whole sequence (a vision
        batch's image span included); an encoder's is written too, as in
        the reference, so size it at the batch's S.

        Under a ``mesh`` the step is placed: ``params`` one tree a
        ``model`` shard (`distributed.sharding.shard_params`; a list of
        such lists a data replica, `replica_params`, under several) and
        ``cache`` placed by `distributed.sharding.place_cache`; see
        `_step_mesh`."""
        if mesh is not None:
            return self._step_mesh(params, cache, batch, mesh, "prefill")
        cfg = self.cfg
        x, positions, _ = self._embed(params, batch)
        x, cache, _ = stack.stack_apply(params["segments"], x, cfg,
                                        mode="prefill", positions=positions,
                                        cache=cache)
        x = norm(params["final_norm"], x, cfg)
        if cfg.is_encoder:
            with free_rows():
                logits = self._head_logits(params, x)
            return cache, logits, positions[:, -1] + 1
        return cache, self._head_logits(params, x[:, -1]), positions[:, -1] + 1

    def decode_step(self, params, cache: Any, token: torch.Tensor,
                    pos: torch.Tensor,
                    page_table: torch.Tensor | None = None, mesh=None,
                    greedy: bool = False):
        """One token: token [B], pos [B] → (logits [B, V], cache); with
        ``greedy``, (each row's greedy token [B] int32, cache): `argmax`
        of the logits, the first maximum on a tie.

        ``page_table`` [B, pages] routes the reads and writes when
        ``cache`` came from `init_paged_cache`. Under a ``mesh``, params
        and cache as `prefill` takes them (`_step_mesh`); with
        ``greedy`` the head stays vocab-parallel and only each shard's
        ``[B]`` maxima and indices cross (`_greedy_tp`).
        """
        if mesh is not None:
            return self._step_mesh(params, cache, {"token": token,
                                                   "pos": pos}, mesh,
                                   "decode", greedy)
        cfg = self.cfg
        x = embed_lookup(params["embed"], token, scale=cfg.scale_embed).to(
            torch_dtype(cfg.activation_dtype))
        x, cache, _ = stack.stack_apply(params["segments"], x, cfg,
                                        mode="decode", positions=pos,
                                        cache=cache, page_table=page_table)
        x = norm(params["final_norm"], x, cfg)
        logits = self._head_logits(params, x)
        if greedy:
            return logits.argmax(-1).to(torch.int32), cache
        return logits, cache

    def _step_mesh(self, params, cache, batch: dict, mesh, mode: str,
                   greedy: bool = False):
        """The placed one-shot step (`prefill` / `decode_step` under a
        ``mesh``), the reference's step over arguments placed by
        `param_pspec` and `cache_pspec`: each data replica runs its rows
        (`split_batch`) over its ``model`` shards, as `chunk_step`'s mesh
        branch does: the table looked up over its shards (a frontend
        column-parallel, `_embed`), every block through
        `blocks.block_apply_tp` (its cache piece filled or read and
        written in place), the first shard's final norm, the head over the
        vocabulary's shards (`_head_logits_tp`, or `_greedy_tp`). The
        replicas' outputs are joined in replica order on the first
        device. prefill → (cache, logits, next pos); decode → (logits or
        tokens, cache)."""
        cfg = self.cfg
        rms = replica_meshes(mesh)
        grid = params if isinstance(params[0], list) else [params]
        caches = cache if len(rms) > 1 else [cache]
        if len(grid) != len(rms) or len(caches) != len(rms):
            raise ValueError(f"{len(grid)} params and {len(caches)} caches "
                             f"for {len(rms)} data replicas")
        outs, nxts = [], []
        for ps, c, b, rm in zip(grid, caches, split_batch(batch, mesh), rms):
            devices = model_devices(rm)
            if mode == "prefill":
                x, positions, _ = self._embed(ps, b, devices)
            else:
                positions = b["pos"]
                x = embed_lookup_tp([p["embed"]["table"] for p in ps],
                                    b["token"], devices, cfg.vocab_size,
                                    cfg.d_model, scale=cfg.scale_embed).to(
                    torch_dtype(cfg.activation_dtype))
            with free_rows(mode == "prefill"):
                for si, (kind, n) in enumerate(cfg.segments()):
                    seg = stack.seg_name(si)
                    for i in range(n):
                        x, _ = blocks.block_apply_tp(
                            [p["segments"][seg][i] for p in ps], x, cfg,
                            kind, mesh=rm, positions=positions, mode=mode,
                            cache=c[seg][i])
            x = norm(ps[0]["final_norm"], x, cfg)
            if mode == "decode":
                outs.append(self._greedy_tp(ps, x, devices) if greedy
                            else self._head_logits_tp(ps, x, devices))
                continue
            nxts.append(positions[:, -1] + 1)
            if cfg.is_encoder:
                with free_rows():
                    outs.append(self._head_logits_tp(ps, x, devices))
            else:
                outs.append(self._head_logits_tp(ps, x[:, -1], devices))
        dev = rms[0].devices[0]
        out = torch.cat([o.to(dev) for o in outs])
        if mode == "decode":
            return out, cache
        return cache, out, torch.cat([t.to(dev) for t in nxts])

    def _greedy_tp(self, params: list, x: torch.Tensor, devices: list
                   ) -> torch.Tensor:
        """Greedy tokens ``[B]`` int32 over a vocabulary-parallel head (the
        reference's fused-sample decode): each shard takes the argmax of
        its own vocab slice of the logits; the shards' ``[B]`` maxima and
        indices are joined (`concat`) and the first maximum in shard
        order wins, `argmax`'s tie rule. A head that is not split over
        the vocabulary forms its logits whole (`_head_logits_tp`) and
        takes their argmax."""
        cfg = self.cfg
        w, vdim = ((params[0]["embed"]["table"], 0) if cfg.tie_embeddings
                   else (params[0]["lm_head"]["w"], -1))
        if w.shape[vdim] == cfg.vocab_size:
            return self._head_logits_tp(params, x, devices).argmax(-1).to(
                torch.int32)
        vals, idxs = [], []
        for s, (p, d) in enumerate(zip(params, devices)):
            lg = self._head_logits(p, x.to(d))
            i = lg.argmax(dim=-1, keepdim=True)
            vals.append(torch.gather(lg, -1, i)[:, 0][None])
            idxs.append((i[:, 0] + s * lg.shape[-1]).to(torch.int32)[None])
        vals, idxs = concat(vals, 0, devices), concat(idxs, 0, devices)
        best = vals.argmax(dim=0, keepdim=True)     # the first in shard order
        return torch.gather(idxs, 0, best)[0]

    def chunk_step(self, params, cache: Any, tokens: torch.Tensor,
                   pos: torch.Tensor, sample_idx: torch.Tensor,
                   page_table: torch.Tensor, num_logits: int = 1,
                   rpos: torch.Tensor | None = None,
                   amask: torch.Tensor | None = None, mesh=None):
        """One token-budget step of the serving engine.

        tokens / pos ``[B, C]`` (``-1`` = padding), sample_idx ``[B]`` (the
        in-row index whose logits feed sampling), page_table
        ``[B, pages_per_slot]``. Returns (logits [B, V] for ``num_logits ==
        1``, else [B, num_logits, V]; cache) — the full ``[B, C, V]``
        logits are never materialized.

        Under a ``mesh``, ``params`` and ``cache`` are one tree a shard of
        its ``model`` axis (`distributed.sharding.shard_params`,
        `init_paged_cache(mesh=...)`); the other operands and the logits
        lie on the first shard's device. Only dense attention decoders
        serve under a mesh (`blocks.block_apply_tp`).
        """
        cfg = self.cfg
        adt = torch_dtype(cfg.activation_dtype)
        if mesh is None:
            x = embed_lookup(params["embed"], tokens,
                             scale=cfg.scale_embed).to(adt)
            x, cache, _ = stack.stack_apply(params["segments"], x, cfg,
                                            mode="chunk", positions=pos,
                                            cache=cache,
                                            page_table=page_table,
                                            rpos=rpos, amask=amask)
            x = norm(params["final_norm"], x, cfg)
        else:
            devices = model_devices(mesh)
            x = embed_lookup_tp([p["embed"]["table"] for p in params],
                                tokens, devices, cfg.vocab_size, cfg.d_model,
                                scale=cfg.scale_embed).to(adt)
            with free_rows(False):
                for si, (kind, n) in enumerate(cfg.segments()):
                    seg = stack.seg_name(si)
                    for i in range(n):
                        x, _ = blocks.block_apply_tp(
                            [p["segments"][seg][i] for p in params], x, cfg,
                            kind, mesh=mesh, positions=pos,
                            caches=[c[seg][i] for c in cache],
                            page_table=page_table, rpos=rpos, amask=amask)
            x = norm(params[0]["final_norm"], x, cfg)
        c = x.shape[1]
        idx = (sample_idx.long()[:, None]
               + torch.arange(num_logits, device=x.device)[None, :])
        idx = torch.clip(idx, 0, c - 1)
        x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        logits = (self._head_logits(params, x) if mesh is None
                  else self._head_logits_tp(params, x, model_devices(mesh)))
        return (logits[:, 0] if num_logits == 1 else logits), cache

    def forward_logits(self, params, batch: dict, mesh=None) -> torch.Tensor:
        """Full logits [B, S, V] (small models / eval only; an encoder's
        serving output). The head is one product, as in an encoder's
        `prefill` (`numerics.free_rows`), so the two give the same bits.
        Under a ``mesh``, ``params`` as `loss` takes them: each replica's
        logits (its batch slice; the head column-parallel over the vocab)
        joined in replica order on the first device."""
        cfg = self.cfg
        if mesh is not None:
            rms = replica_meshes(mesh)
            outs = []
            for ps, b, rm in zip(params, split_batch(batch, mesh), rms):
                x, _, head = self._replica_forward(ps, b, rm)
                with free_rows():
                    outs.append(head(x))
            return torch.cat([o.to(rms[0].devices[0]) for o in outs])
        x, positions, _ = self._embed(params, batch)
        x, _, _ = stack.stack_apply(params["segments"], x, cfg,
                                    mode="train", positions=positions)
        x = norm(params["final_norm"], x, cfg)
        with free_rows():
            return self._head_logits(params, x)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
