"""One run of one cell: set-up, the measured window, the readers, the
check against the reference.

The system under test is the port's chunked serving path:
`GenerationEngine.submit` / `step` / `collect` → `Scheduler.step` →
`_exec_run_batch` → `Model.chunk_step` → `qlinear_apply` (K1, K3) and
`attention_chunk_paged` (K2 over int8 pages), greedy, no EOS, no
speculation, no prefix sharing. From the program the harness takes only
that engine, its scheduler's counters and its kernels' names; a traced
run also wraps the kernel entry points and the scheduler's dispatch from
here to read each call's shapes (host metadata, no synchronisation).

Set-up (``setup_s``) runs from the process's start to the window's
opening: the weights (drawn on the device from the seed, then each
layer's linears packed to int4 by the port's `quantize_params`), the
engine's pools and `warmup` (every width the scheduler may pick, and the
widest at the longest context), and the traffic's ramp: a closed loop's
first requests until each has its first token, an open loop's first
``warmup_s`` seconds of arrivals.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import check, manifest, stats, trace
from perfbench.traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read."""
    config: dict
    mix: dict
    device_kind: str
    spans: dict                     # name -> seconds, on the host clock
    window: stats.Window
    stats_open: dict                # scheduler counters at the opening
    stats_close: dict               # and at the close
    excluded: tuple = (0.0, 0.0)    # host-clock span the profiler held
    steps_pos: dict = dataclasses.field(default_factory=dict)  # step -> pos
    trace: trace.Trace | None = None
    calls: dict = dataclasses.field(default_factory=dict)  # kernel -> list

    def free_steps(self) -> list[int]:
        """Window steps outside the profiled span."""
        a, b = self.excluded
        return [i for i, s in enumerate(self.window.steps)
                if s[1] <= a or s[0] >= b]


class _Recorder:
    """Wraps the kernel entry points and the scheduler's dispatch while a
    traced run is on: shapes of each K1 / K3 / K2 call inside the profiled
    steps, and every step's host position array."""

    def __init__(self):
        self.on = False
        self.pos = None
        self.calls = {"k1": [], "k3": [], "k2": []}
        self.steps_pos: dict = {}
        self.step = -1
        self._undo = []

    def _patch(self, obj, name, make):
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self._undo.append((obj, name, orig))

    def install(self, eng):
        from repro_torch.kernels import awq_matmul as k1
        from repro_torch.kernels import paged_attention as k2

        def mm(orig):
            def wrapped(x, qweight, scales, zeros, group_size, *a, **kw):
                out = orig(x, qweight, scales, zeros, group_size, *a, **kw)
                if self.on:
                    self.calls["k1"].append(
                        (x.shape[0], qweight.shape[-2] * 8, qweight.shape[-1],
                         group_size, x.element_size(), out.element_size()))
                return out
            return wrapped

        def gu(orig):
            def wrapped(x, qw_gate, *a, **kw):
                out = orig(x, qw_gate, *a, **kw)
                if self.on:
                    self.calls["k3"].append(
                        (x.shape[0], qw_gate.shape[-2] * 8, qw_gate.shape[-1],
                         a[5], x.element_size(), out.element_size()))
                return out
            return wrapped

        def pa(orig):
            def wrapped(q, k_pool, ks, v_pool, vs, page_table, pos, **kw):
                if self.on:
                    self.calls["k2"].append((tuple(q.shape),
                                             page_table.shape[1], self.pos))
                return orig(q, k_pool, ks, v_pool, vs, page_table, pos, **kw)
            return wrapped

        def rb(orig):
            def wrapped(tokens, pos, *a, **kw):
                self.pos = pos
                self.steps_pos[self.step] = pos
                return orig(tokens, pos, *a, **kw)
            return wrapped

        self._patch(k1, "awq_matmul", mm)
        self._patch(k1, "awq_gateup", gu)
        self._patch(k2, "paged_attention_chunk", pa)
        self._patch(eng._scheduler, "_run_batch", rb)

    def uninstall(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo.clear()


def _counters(eng) -> dict:
    return dataclasses.asdict(eng.scheduler_stats)


def _build(cell: dict, seed: int, device):
    """(engine, build spans): weights from the seed, packed by the port,
    then the engine, its pools and its warm-up."""
    import importlib

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.pipeline import quantize_params
    from repro_torch.core.quantize import QuantConfig
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import GenerationEngine

    conf, mix = cell["config"], cell["mix"]
    fam = importlib.import_module(f"perfbench.models.{conf['family']}")
    port = conf["port"]
    qcfg = QuantConfig(bits=conf["quant"]["bits"],
                       group_size=conf["quant"]["group_size"])
    t0 = time.perf_counter()
    g = fam.global_floats(port, seed, device)
    layers = []
    for i in range(port["num_layers"]):
        layer = fam.port_layer(fam.layer_floats(port, seed, i, device))
        layers.append(quantize_params(layer, cfg=qcfg)[0])
        del layer
    params = fam.port_tree(g, layers)
    del g, layers
    _sync(device)
    t1 = time.perf_counter()
    e = mix["engine"]
    eng = GenerationEngine(
        Model(ModelConfig(**port)), params, max_seq=e["max_seq"],
        num_slots=e["num_slots"], page_size=e["page_size"],
        prefill_chunk=e["prefill_chunk"], kv_quant=e["kv_quant"],
        chunked_prefill=True, eos_id=-1, seed=seed)
    eng.warmup()
    _warm_long_context(eng)
    _sync(device)
    return eng, {"weights": t1 - t0, "warmup": time.perf_counter() - t1}


def _warm_long_context(eng) -> None:
    """One all-padding dispatch of every width at the longest context the
    cell's slots can reach (the widest page-table slice K2 reads), whose
    single valid row writes only the scratch page: `warmup` covers the
    widths at the shortest context."""
    b, top = eng.num_slots, eng.max_seq
    for c in eng._scheduler.width_buckets:
        pos = np.full((b, c), -1, np.int32)
        pos[0] = np.arange(top - c, top)
        z = np.zeros(b, np.int32)
        eng._exec_run_batch(np.zeros((b, c), np.int32), pos, z, z,
                            np.zeros(b, np.float32), z)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Loop:
    """The client side: submits requests, steps the engine, records the
    time of every token."""

    def __init__(self, eng, traffic: Traffic, rec: _Recorder | None,
                 spans_on: bool):
        self.eng, self.tr, self.rec = eng, traffic, rec
        self.reqs: dict[int, stats.Req] = {}
        self.prompts: dict[int, np.ndarray] = {}
        self.outputs: dict[int, np.ndarray] = {}
        self.client_of: dict[int, int] = {}
        self.next_index = 0
        self.steps: list = []
        self.spans_on = spans_on

    def _span(self, name):
        if self.spans_on:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def submit(self, toks, max_new, due, client=None):
        with self._span("perfbench.submit"):
            rid = self.eng.submit(toks, max_new)
        self.reqs[rid] = stats.Req(due=due)
        self.prompts[rid] = toks
        if client is not None:
            self.client_of[rid] = client
        return rid

    def step(self):
        st = self.eng.scheduler_stats
        before = st.prefill_tokens if st is not None else 0
        if self.rec is not None:
            self.rec.step = len(self.steps)
        t0 = time.perf_counter()
        with self._span("perfbench.step"):
            events = self.eng.step()
        t1 = time.perf_counter()
        for rid, _tok in events:
            self.reqs[rid].times.append(t1)
        with self._span("perfbench.collect"):
            done = self.eng.collect()
        for rid, toks in done.items():
            self.reqs[rid].finished = t1
            self.outputs[rid] = toks
        self.steps.append((t0, t1, len(events),
                           self.eng.scheduler_stats.prefill_tokens - before))
        return done


def _closed_loop(loop: _Loop, mix: dict, seconds: float, on_open,
                 profile):
    """Each client sends its next request when the last one finished; the
    window opens once every client's first request has its first token."""
    tr = loop.tr
    for c in range(int(mix["clients"])):
        toks, out = tr.first_request(c)
        loop.submit(toks, out, time.perf_counter(), client=c)
    loop.next_index = int(mix["clients"])
    first = set(loop.reqs)

    def refill(done):
        for rid in done:
            c = loop.client_of.pop(rid, None)
            if c is None:
                continue
            toks, out = tr.request(loop.next_index)
            loop.next_index += 1
            loop.submit(toks, out, time.perf_counter(), client=c)

    while any(not loop.reqs[r].times for r in first):
        refill(loop.step())
    win = stats.Window(t_open=time.perf_counter())
    on_open(win.t_open)
    while True:
        if profile is not None:
            profile.before_step(win, time.perf_counter(), True)
        refill(loop.step())
        if profile is not None:
            profile.after_step()
        if time.perf_counter() >= win.t_open + seconds:
            break
    win.t_close = loop.steps[-1][1]
    return win, []


def _open_loop(loop: _Loop, mix: dict, seconds: float, on_open, profile):
    """Arrivals on the mix's schedule whatever the engine's state; the
    window opens ``warmup_s`` after the first arrival's zero. Returns the
    window and how late the generator submitted each arrival."""
    warm = float(mix.get("warmup_s", 0.0))
    offsets = loop.tr.arrivals(warm + seconds)
    t_zero = time.perf_counter()
    win = stats.Window(t_open=t_zero + warm)
    late, i, opened, arrived = [], 0, False, False
    while True:
        now = time.perf_counter()
        if not opened and now >= win.t_open:
            opened = True
            on_open(win.t_open)
        while i < len(offsets) and t_zero + offsets[i] <= now:
            toks, out = loop.tr.request(i)
            loop.submit(toks, out, t_zero + offsets[i])
            late.append(time.perf_counter() - (t_zero + offsets[i]))
            i += 1
            arrived = True
        if now >= win.t_open + seconds:
            break
        if loop.eng.idle:
            nxt = t_zero + offsets[i] if i < len(offsets) else now + 1e-3
            time.sleep(max(0.0, min(nxt - now, 1e-3)))
            continue
        if profile is not None and opened:
            profile.before_step(win, now, arrived)
        arrived = False
        loop.step()
        if profile is not None:
            profile.after_step()
    win.t_close = time.perf_counter()
    return win, late


class _Profile:
    """Profiles ``steps`` consecutive steps of the loop (CPU and, on a card,
    CUDA activity; the benchmark's spans around submit, step and collect),
    from the first step after 40 % of the window that follows an arrival:
    in a closed loop every step does, in an open loop the profiled steps
    start with a prompt's first chunk and run on through the arrivals that
    follow, as the loop submits them."""

    def __init__(self, steps: int, seconds: float, rec: _Recorder, device):
        self.steps, self.seconds, self.rec = steps, seconds, rec
        self.device = device
        self.prof = None
        self.done = False
        self.count = 0
        self.span = (0.0, 0.0)
        self._window = None

    def before_step(self, win, now, arrived: bool):
        if (self.done or self.prof is not None or not arrived
                or now < win.t_open + 0.4 * self.seconds):
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        _sync(self.device)
        self.rec.on = True
        self._window = torch.profiler.record_function("perfbench.window")
        self._window.__enter__()
        self.span = (t0, t0)

    def after_step(self):
        if self.prof is None or self.done:
            return
        self.count += 1
        if self.count >= self.steps:
            self.stop()

    def stop(self):
        """End the profile (at its last step, or where the window closed
        first)."""
        if self.prof is None or self.done:
            return
        self.done = True
        _sync(self.device)
        self._window.__exit__(None, None, None)
        self.rec.on = False
        self.prof.stop()
        self.span = (self.span[0], time.perf_counter())


def _warm_profiler(device) -> None:
    """Start the profiler once during set-up (CUPTI's first start is
    slow), so the traced steps pay no first-use cost."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()


@dataclasses.dataclass
class Measured:
    """A run up to its check: the result line without ``correct``, and the
    sample of finished requests the check holds against the reference."""
    result: dict
    late: list
    rids: list
    outputs: dict
    prompts: dict
    window: stats.Window | None = None
    queued: tuple = (0, 0)          # requests waiting at open and close


def measure(root: Path, workload: str, seed: int, seconds: float,
            traced: bool, *, device: str = "cuda",
            t_start: float | None = None,
            mix_overrides: dict | None = None) -> Measured:
    """Set-up, the window, the readers; the program's state is freed
    before this returns. ``mix_overrides`` replaces entries of the mix
    (the rate sweep's offered loads)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    man = manifest.load(root)
    cell = manifest.cell(root, man, workload)
    cell["mix"].update(mix_overrides or {})
    conf, mix, limits = cell["config"], cell["mix"], cell["limits"]
    metric_entries = manifest.metrics(man, workload, traced)
    readers = {m["name"]: manifest.reader(root, m["name"])
               for m in metric_entries}
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    eng, spans = _build(cell, seed, device)
    rec = None
    if traced:
        rec = _Recorder()
        rec.install(eng)
        if cuda:
            _warm_profiler(device)
    traffic = Traffic(mix, seed, conf["port"]["vocab_size"])
    loop = _Loop(eng, traffic, rec, spans_on=traced)
    profile = (_Profile(int(mix["trace_steps"]), seconds, rec, device)
               if traced else None)
    st_open: dict = {}
    queued = []

    def on_open(t_open):
        st_open.update(_counters(eng))
        spans["setup"] = t_open - t_start
        queued.append(len(eng._scheduler.queue))

    drive = _closed_loop if mix["loop"] == "closed" else _open_loop
    win, late = drive(loop, mix, seconds, on_open, profile)
    if profile is not None:
        profile.stop()
    st_close = _counters(eng)
    queued.append(len(eng._scheduler.queue))
    win.steps = loop.steps
    win.reqs = loop.reqs
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(config=conf["port"], mix=mix, device_kind=kind, spans=spans,
              window=win, stats_open=st_open, stats_close=st_close)
    if rec is not None:
        rec.uninstall()
        run.steps_pos = rec.steps_pos
        run.calls = rec.calls
    if profile is not None and profile.prof is not None:
        run.excluded = profile.span
        run.trace = trace.reduce(profile.prof)

    metrics = {}
    for m in metric_entries:
        val = readers[m["name"]](run)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": int(cell["workload"]["chips"]),
                   "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": sum(
        1 for r in win.reqs.values() if r.due < win.t_close
        and (r.finished is None or r.finished > win.t_open)),
        "failed": 0, "metrics": metrics, "device": device_info}
    if run.trace is not None and cuda:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(10),
                               "idle_gaps": run.trace.idle_gaps(10)}

    # the sample the check compares: requests the window finished
    finished = {rid: out for rid, out in loop.outputs.items()
                if win.t_open < loop.reqs[rid].finished <= win.t_close}
    chk = limits["sample"]
    rids = check.sample(finished, loop.prompts, seed, chk["tokens"],
                        chk["max_requests"])
    out = Measured(result, late, rids, {r: finished[r] for r in rids},
                   {r: loop.prompts[r] for r in rids}, win, tuple(queued))
    del eng, loop, rec, profile, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def judge(root: Path, workload: str, seed: int, m: Measured, *,
          device: str = "cuda") -> tuple[dict, list[str]]:
    """The check against the reference: returns (the result line's object,
    the lines that end standard error: each number compared beside its
    limit)."""
    cell = manifest.cell(root, manifest.load(root), workload)
    conf, limits = cell["config"], cell["limits"]
    g = (check.served_gaps(conf, seed, m.rids, m.outputs, m.prompts, device)
         if m.rids else {"widest": None, "mean": None, "flip_share": None,
                         "tokens": 0})
    gap = {"value": g["mean"], "limit": limits["mean_logit_gap"]["limit"]}
    least = limits["sample"]["min_tokens"]
    checks = {"mean_logit_gap": gap,
              "tokens_checked": {"value": g["tokens"], "limit": least}}
    result = dict(m.result)
    result["correct"] = bool(gap["value"] is not None
                             and gap["value"] <= gap["limit"]
                             and g["tokens"] >= least)
    result["checks"] = checks
    err = []
    if m.late:
        err.append(f"generator lateness: median "
                   f"{stats.percentile(m.late, 50)} s, max {max(m.late)} s "
                   f"over {len(m.late)} arrivals")
    err.append(f"checked {len(m.rids)} requests, {g['tokens']} served "
               f"tokens: widest gap {g['widest']}, mean gap {g['mean']}, "
               f"share of tokens not the reference's best "
               f"{g['flip_share']}")
    err.append(f"check mean_logit_gap {gap['value']} <= limit "
               f"{gap['limit']}")
    err.append(f"check tokens_checked {g['tokens']} >= limit {least}")
    return result, err


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, *, device: str = "cuda",
             t_start: float | None = None) -> tuple[dict, list[str]]:
    """One run: `measure`, then `judge`."""
    m = measure(root, workload, seed, seconds, traced, device=device,
                t_start=t_start)
    return judge(root, workload, seed, m, device=device)
