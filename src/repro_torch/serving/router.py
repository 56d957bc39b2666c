"""Fleet router: N engine replicas behind one engine-shaped API.

A numpy copy of the reference package's `serving/router.py` (host code,
the whole class). `Router` owns a list of **replicas** — each a
`GenerationEngine` (optionally tensor-parallel over its own ``model``
mesh, `distributed.serving_mesh`) or a `serving.disagg.DisaggController`
prefill/decode pair — and exposes the engine's ``submit() / step() /
collect() / drain()`` surface. A sharded replica answers the same
queries (its page tables and prefix index live on the one host), so
placement does not see the mesh.

Placement: within one engine, prefix sharing turns duplicate prompt
prefixes into aliased pages and skipped prefill; across a fleet that only
happens if requests with the same prefix land on the replica holding its
pages. The prefix index is content-addressed, so
`GenerationEngine.prefix_reuse_pages` is exact. Each `submit` scores
every live replica:

  * **prefix affinity** — ``affinity_weight`` per reusable page, counted
    only when the reuse reaches ``affinity_threshold`` pages;
  * **load** — ``queue_weight`` per waiting or in-flight request
    (`stats().queue_depth` + `num_active`), plus a tiny
    ``headroom_weight`` per free page (`stats().admission_headroom`) as a
    deterministic tiebreaker toward the emptier pool;
  * **SLO class** — interactive traffic (``priority > 0``) pays
    ``slo_weight`` per strictly lower-class request already routed to
    the replica.

Scoring is a pure function of the observable fleet state (ties break
toward the lowest index). ``submit(..., session_id=...)`` sticks a
session to the replica that served its first turn. `drain_replica`
takes a replica out of placement, re-routes its queued requests under
their global ids and lets its in-flight ones finish in place;
`add_replica` joins (or re-joins) one.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.engine import SamplerConfig


@dataclasses.dataclass
class RouterStats:
    """The placement ledger (fleet-level; per-replica engine metrics come
    from `Router.stats()`)."""
    placements: int = 0           # submit() calls placed by scoring
    affinity_hits: int = 0        # placements where the affinity term fired
    session_hits: int = 0         # placements short-circuited by a session
    reroutes: int = 0             # queued requests moved off a draining replica
    drains: int = 0               # drain_replica() calls
    joins: int = 0                # add_replica() calls (incl. re-joins)


class Router:
    """N replicas behind the `GenerationEngine` streaming API.

    ``replicas`` is a non-empty list of engine-shaped objects
    (`GenerationEngine` or `DisaggController`). The router never builds
    engines itself — construction stays explicit (or declarative via
    `launch.specs.FleetSpec.build`).

    ``placement`` selects the policy: ``"affinity"`` (the scored default),
    ``"round_robin"``, or ``"random"`` (seeded, placement-blind). Sessions stick under every policy except
    ``"random"``, which is deliberately memoryless.
    """

    def __init__(self, replicas, *, placement: str = "affinity",
                 affinity_threshold: int = 1, affinity_weight: float = 4.0,
                 queue_weight: float = 1.0, slo_weight: float = 8.0,
                 headroom_weight: float = 1.0 / 1024.0, seed: int = 0):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("Router needs at least one replica")
        if placement not in ("affinity", "round_robin", "random"):
            raise ValueError(f"unknown placement policy {placement!r}")
        if affinity_threshold < 1:
            raise ValueError("affinity_threshold must be >= 1 page")
        self._replicas = replicas
        self.placement_policy = placement
        self.affinity_threshold = affinity_threshold
        self.affinity_weight = affinity_weight
        self.queue_weight = queue_weight
        self.slo_weight = slo_weight
        self.headroom_weight = headroom_weight
        self._rng = np.random.default_rng(seed)
        self._rr_next = 0
        self._next_rid = 0
        # global rid → (replica, local rid, priority); removed on collect
        self._rid_map: dict[int, tuple[object, int, int]] = {}
        # per-replica local rid → global rid (keyed by id(replica))
        self._to_global: dict[int, dict[int, int]] = {
            id(r): {} for r in replicas}
        self._draining: set[int] = set()          # id(replica)
        self._sessions: dict[str, object] = {}    # session_id → replica
        self._finished: dict[int, np.ndarray] = {}  # from removed replicas
        self.router_stats = RouterStats()

    # ------------------------------------------------------------ placement
    @property
    def replicas(self) -> list:
        """The live fleet (placement-eligible AND draining replicas)."""
        return list(self._replicas)

    def _live_indices(self) -> list[int]:
        out = [i for i, r in enumerate(self._replicas)
               if id(r) not in self._draining]
        if not out:
            raise RuntimeError("every replica is draining — nothing can "
                               "accept placements (add_replica or re-join)")
        return out

    def _lower_class_backlog(self, rep, priority: int) -> int:
        """Unfinished requests of a strictly lower SLO class this router
        has placed on ``rep`` (the fleet-level 'batch-heavy' signal)."""
        rid_of = id(rep)
        return sum(1 for (r, _lrid, p) in self._rid_map.values()
                   if id(r) == rid_of and p < priority)

    def placement_scores(self, tokens, *, prefix_id=None,
                         priority: int = 0) -> list[float]:
        """Score every replica for this request (``-inf`` = draining).

        Pure in the fleet state: no placement, no mutation — `submit`
        calls this and takes the argmax (ties → lowest index), so the
        scores ARE the routing decision and tests can assert on them.
        """
        scores = []
        for rep in self._replicas:
            if id(rep) in self._draining:
                scores.append(float("-inf"))
                continue
            reuse = rep.prefix_reuse_pages(tokens, prefix_id)
            st = rep.stats()
            if isinstance(st, list) or not hasattr(st, "queue_depth"):
                st = None
            if st is None:     # DisaggController: per-side engine stats
                sides = (rep.prefill.engine.stats(),
                         rep.decode.engine.stats())
                queue_depth = sum(s.queue_depth for s in sides)
                headroom = sides[1].admission_headroom
            else:
                queue_depth = st.queue_depth
                headroom = st.admission_headroom
            score = 0.0
            if reuse >= self.affinity_threshold:
                score += self.affinity_weight * reuse
            score -= self.queue_weight * (queue_depth + rep.num_active)
            score += self.headroom_weight * headroom
            if priority > 0:
                score -= self.slo_weight \
                    * self._lower_class_backlog(rep, priority)
            scores.append(score)
        return scores

    def place(self, tokens, *, prefix_id=None, priority: int = 0,
              session_id: str | None = None) -> int:
        """Replica index `submit` would choose, without submitting."""
        live = self._live_indices()
        if self.placement_policy == "random":
            return live[int(self._rng.integers(len(live)))]
        if session_id is not None:
            rep = self._sessions.get(session_id)
            if rep is not None and id(rep) not in self._draining:
                for i, r in enumerate(self._replicas):
                    if r is rep:
                        return i
        if self.placement_policy == "round_robin":
            idx = live[self._rr_next % len(live)]
            return idx
        scores = self.placement_scores(tokens, prefix_id=prefix_id,
                                       priority=priority)
        best = max(scores)
        return scores.index(best)      # ties break toward the lowest index

    # ------------------------------------------------------------ streaming
    def submit(self, tokens, max_new_tokens: int,
               sampler: SamplerConfig | None = None,
               eos_id: int | None = None, prefix_id: str | None = None,
               priority: int = 0, n: int = 1,
               session_id: str | None = None) -> int | list[int]:
        """Place and queue one request; returns fleet-global rid(s).

        Same contract as `GenerationEngine.submit`, plus ``session_id``:
        multi-turn callers pass a stable id and every later turn returns
        to the replica holding the session's warm pages. ``n > 1``
        parallel-sampling siblings always land together (aliased prompt
        pages exist only within one pool).
        """
        idx = self.place(tokens, prefix_id=prefix_id, priority=priority,
                         session_id=session_id)
        rep = self._replicas[idx]
        stt = self.router_stats
        if session_id is not None and self._sessions.get(session_id) is rep \
                and self.placement_policy != "random":
            stt.session_hits += 1
        elif self.placement_policy == "affinity":
            stt.placements += 1
            if rep.prefix_reuse_pages(tokens, prefix_id) \
                    >= self.affinity_threshold:
                stt.affinity_hits += 1
        else:
            stt.placements += 1
        if self.placement_policy == "round_robin":
            self._rr_next += 1
        if session_id is not None and self.placement_policy != "random":
            self._sessions[session_id] = rep
        lrids = rep.submit(tokens, max_new_tokens, sampler=sampler,
                           eos_id=eos_id, prefix_id=prefix_id,
                           priority=priority, n=n)
        out = []
        for lrid in lrids if n > 1 else [lrids]:
            grid = self._next_rid
            self._next_rid += 1
            self._rid_map[grid] = (rep, lrid, priority)
            self._to_global[id(rep)][lrid] = grid
            out.append(grid)
        return out if n > 1 else out[0]

    def step(self) -> list[tuple[int, int]]:
        """Step every non-idle replica once (draining ones included —
        their in-flight requests must finish); merged (global rid, token)
        events in replica order, then emission order."""
        events: list[tuple[int, int]] = []
        for rep in list(self._replicas):
            if rep.idle:
                continue
            fwd = self._to_global[id(rep)]
            for lrid, tok in rep.step():
                grid = fwd.get(lrid)
                if grid is not None:
                    events.append((grid, tok))
        return events

    def collect(self) -> dict[int, np.ndarray]:
        """Finished streams accumulated so far, keyed by global rid."""
        out = dict(self._finished)
        self._finished.clear()
        for rep in self._replicas:
            fwd = self._to_global[id(rep)]
            for lrid, toks in rep.collect().items():
                grid = fwd.pop(lrid, None)
                if grid is not None:
                    out[grid] = toks
                    self._rid_map.pop(grid, None)
        return out

    def drain(self) -> dict[int, np.ndarray]:
        """Step until every replica is idle; all finished streams."""
        out = self.collect()
        wedged = 0
        while not self.idle:
            events = self.step()
            got = self.collect()
            out.update(got)
            wedged = 0 if (events or got) else wedged + 1
            if wedged > 1000:
                raise RuntimeError("router wedged: no replica can progress")
        out.update(self.collect())
        return out

    @property
    def idle(self) -> bool:
        return all(r.idle for r in self._replicas)

    @property
    def num_active(self) -> int:
        return sum(r.num_active for r in self._replicas)

    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    def warmup(self) -> int:
        """Run every replica's dispatch widths once (`GenerationEngine.
        warmup`)."""
        return sum(r.warmup() for r in self._replicas)

    def pin_prefix(self, prefix_id: str) -> int:
        """Pin on EVERY replica (sticky): whichever replica first serves
        the prefix keeps it resident, and the pin is a no-op (0 pages)
        everywhere else until pages register there."""
        return sum(r.pin_prefix(prefix_id) for r in self._replicas)

    def unpin_prefix(self, prefix_id: str) -> int:
        return sum(r.unpin_prefix(prefix_id) for r in self._replicas)

    def stats(self) -> list:
        """Per-replica engine snapshots, fleet order (`EngineStats` /
        `DisaggStats`); the placement ledger is `router_stats`."""
        return [r.stats() for r in self._replicas]

    def reset_stats(self) -> None:
        for r in self._replicas:
            r.reset_stats()
        self.router_stats = RouterStats()

    # --------------------------------------------------------- drain / join
    def drain_replica(self, i: int, *, reroute: bool = True,
                      wait: bool = True,
                      max_steps: int = 100_000) -> list[tuple[int, int]]:
        """Take replica ``i`` out of placement, losing nothing.

        1. The replica stops receiving placements (scores ``-inf``);
           its sessions re-score on their next turn and re-pin wherever
           they land.
        2. With ``reroute=True`` its **queued** requests — submitted but
           not yet admitted, so they hold no slot, no pages, and have
           emitted nothing — are moved to the rest of the fleet under
           their original global rids (greedy streams depend only on the
           prompt, so the move is invisible in the output).
        3. With ``wait=True`` the whole fleet keeps stepping (service
           continues) until the replica's in-flight requests finish;
           the (global rid, token) events produced meanwhile are
           returned so callers keep streaming. ``wait=False`` returns
           immediately — later `step()`/`drain()` calls finish the job.

        The drained replica stays in the fleet (idle, unplaceable) so
        `add_replica` can re-join it with its pages still warm; use
        `remove_replica` to drop it entirely.
        """
        rep = self._replicas[i]
        self._draining.add(id(rep))
        self.router_stats.drains += 1
        anyone_live = any(id(r) not in self._draining
                          for r in self._replicas)
        if reroute and anyone_live:
            self._reroute_queued(rep)   # no live target ⇒ serve in place
        events: list[tuple[int, int]] = []
        if wait:
            steps = 0
            while not rep.idle:
                events.extend(self.step())
                steps += 1
                if steps > max_steps:
                    raise RuntimeError(
                        f"drain_replica({i}) did not converge in "
                        f"{max_steps} steps")
        return events

    def _reroute_queued(self, rep) -> None:
        """Move ``rep``'s not-yet-admitted requests to live replicas."""
        sched = getattr(rep, "_scheduler", None)
        if sched is None or not sched.queue:
            return                      # disagg/fresh replica: nothing queued
        queued = list(sched.queue)
        sched.queue.clear()
        fwd = self._to_global[id(rep)]
        for req in queued:
            grid = fwd.pop(req.rid, None)
            if grid is None:
                continue                # not ours (defensive)
            self._rid_map.pop(grid, None)
            idx = self.place(req.tokens, prefix_id=req.prefix_id,
                             priority=req.priority)
            target = self._replicas[idx]
            lrid = target.submit(
                req.tokens, req.max_new_tokens,
                sampler=SamplerConfig(temperature=req.temperature,
                                      top_k=req.top_k),
                eos_id=req.eos_id, prefix_id=req.prefix_id,
                priority=req.priority)
            self._rid_map[grid] = (target, lrid, req.priority)
            self._to_global[id(target)][lrid] = grid
            self.router_stats.reroutes += 1

    def add_replica(self, replica, *, warmup: bool = False) -> int:
        """Join ``replica`` to the fleet (or re-join a drained one).

        A drained replica passed back in simply becomes placeable again —
        pages, pins, and sessions it still holds are warm immediately.
        A new replica is appended (and optionally warmed up so its first
        placement pays no first-launch cost). Returns its fleet index.
        """
        self.router_stats.joins += 1
        for i, r in enumerate(self._replicas):
            if r is replica:
                self._draining.discard(id(r))
                return i
        self._replicas.append(replica)
        self._to_global.setdefault(id(replica), {})
        if warmup:
            replica.warmup()
        return len(self._replicas) - 1

    def remove_replica(self, i: int):
        """Drop an **idle** replica from the fleet and return it.

        Raises if it still has queued or in-flight work — drain it first
        (`drain_replica`). Its already-finished streams are buffered and
        still come out of the next `collect()`.
        """
        rep = self._replicas[i]
        if not rep.idle:
            raise RuntimeError(
                f"replica {i} is not idle ({rep.num_active} active) — "
                "drain_replica() it first")
        if len(self._replicas) == 1:
            raise RuntimeError("cannot remove the last replica — the "
                               "router could no longer place anything")
        fwd = self._to_global.pop(id(rep), {})
        for lrid, toks in rep.collect().items():
            grid = fwd.pop(lrid, None)
            if grid is not None:
                self._finished[grid] = toks
                self._rid_map.pop(grid, None)
        self._draining.discard(id(rep))
        self._sessions = {s: r for s, r in self._sessions.items()
                          if r is not rep}
        del self._replicas[i]
        return rep
