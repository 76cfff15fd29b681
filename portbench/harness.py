"""Builds a cell's system from its files, serves the window, and keeps
the records that the end-to-end metrics and the per-layer readers read.

The system under test is the port's own serving path:
``ServingEngine.submit`` / ``step`` for a model alone, and
``MultiTenantGateway.submit`` / ``step`` for a configuration with a
``gateway`` section.  The benchmark wraps each engine's ``step`` from the
outside to time it and to stamp, when it returns, every token it served
(a prefill's first token and a decode step's token of one step get the
same stamp: the host hands both over then).  In a traced run it also
labels the host's work with ``record_function`` ranges (``pb.*``) and
records the shapes of the prefills and decode replays of the profiled
slice.  Nothing inside the program is changed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable

import numpy as np
import torch

from portbench import traffic, weights

clock = time.perf_counter

#: request numbers of the warm-up's prompts (drawn from seed 0, apart
#: from any run's)
WARM_UP_INDEX = 1 << 40

#: keys of a tenant's ``arch`` that set the program's ModelConfig fields
ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
             "vocab", "act", "rope_theta", "qkv_bias", "tie_embeddings",
             "dtype", "param_dtype", "kv_cache_dtype")


def model_config(model: str, arch: dict):
    """The program's config of ``model`` with every size the
    configuration's file states (the file holds the model as it is run)."""
    from repro_torch import configs
    return dataclasses.replace(configs.get(model),
                               **{k: arch[k] for k in ARCH_KEYS})


@dataclasses.dataclass
class Track:
    """One request as the benchmark sees it: when it was due and
    submitted (seconds from the window's start), and the host's stamp of
    each token it was served."""

    arrival: traffic.Arrival
    prompt: np.ndarray
    req: object
    due: float
    submitted: float
    stamps: list = dataclasses.field(default_factory=list)

    @property
    def tokens(self) -> list:
        return self.req.tokens


@dataclasses.dataclass
class Tenant:
    name: str
    arch: dict
    slots: int
    capacity: int
    engine: object


def profiler_activities() -> list:
    """What the profiled slice records: the host's activity, and the
    device's where there is one."""
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])


class _Labelled:
    """``fn`` called inside a profiler range; with ``record`` also called
    with the arguments while ``on()``."""

    def __init__(self, fn, name: str, record: Callable | None = None,
                 on: Callable | None = None):
        self.fn, self.name, self.record, self.on = fn, name, record, on

    def __call__(self, *args, **kw):
        if self.record is not None and self.on():
            self.record(*args, **kw)
        with torch.profiler.record_function(self.name):
            return self.fn(*args, **kw)


class System:
    """The tenants' engines, and the gateway that multiplexes them if the
    configuration has one."""

    def __init__(self, tenants: dict[str, Tenant], gateway=None, plan=None):
        self.tenants = tenants
        self.gateway = gateway
        #: (solver, solve seconds, predicted step ms by tenant) of a gateway
        self.plan = plan

    def submit(self, tenant: str, prompt: np.ndarray, max_new: int):
        if self.gateway is not None:
            return self.gateway.submit(tenant, prompt, max_new=max_new)
        return self.tenants[tenant].engine.submit(prompt, max_new=max_new)

    def step(self) -> None:
        if self.gateway is not None:
            self.gateway.step()
        else:
            for t in self.tenants.values():
                if t.engine.has_work:
                    t.engine.step()

    @property
    def has_work(self) -> bool:
        return any(t.engine.has_work for t in self.tenants.values())

    def reset(self) -> None:
        """Empty every queue and slot (admission overwrites a slot's whole
        state, so the caches need no clearing)."""
        for t in self.tenants.values():
            e = t.engine
            e.queue.clear()
            e.slots = [None] * e.max_slots
            e.lengths[:] = 0
            e.last_tok[:] = 0
            e.completed.clear()


def typical(lengths: dict) -> int:
    """The length a plan is made for: the median, or a uniform range's
    middle."""
    if "median" in lengths:
        return int(lengths["median"])
    return (int(lengths["min"]) + int(lengths["max"])) // 2


def build(config: dict, mix: dict, seed: int, device) -> System:
    """The cell's system, its weights drawn from ``seed``."""
    from repro_torch.models import build as build_model
    from repro_torch.serve.engine import ServingEngine

    specs = []
    for t in config["tenants"]:
        serving = mix["tenants"][t["model"]]
        specs.append((t["model"], t["arch"], int(serving["slots"]),
                      int(serving["capacity"])))
    if "gateway" not in config:
        tenants = {}
        for name, arch, slots, cap in specs:
            model = build_model(model_config(name, arch), device=device)
            weights.fill_model(model, seed, name)
            tenants[name] = Tenant(name, arch, slots, cap,
                                   ServingEngine(model, slots, cap))
        return System(tenants)

    from repro_torch.core import accelerators
    from repro_torch.serve.gateway import (GatewayConfig, MultiTenantGateway,
                                           TenantSpec)
    g = config["gateway"]
    plat = g["platform"]
    platform = getattr(accelerators, plat["kind"])(**plat["args"])
    gspecs = [TenantSpec(name, model_config(name, arch), max_slots=slots,
                         capacity=cap, prompt_len=typical(mix["prompt_len"]),
                         max_new=typical(mix["max_new"]))
              for name, arch, slots, cap in specs]
    gcfg = GatewayConfig(platform=platform, solver=g["solver"],
                         memory_budget_bytes=g["kv_budget_bytes"])
    t0 = clock()
    gw = MultiTenantGateway(gspecs, gcfg, device=device)
    boot_s = clock() - t0
    for name, *_ in specs:
        weights.fill_model(gw.engines[name].model, seed, name)
    plan = {"solver": gw.plan.plan.solver if gw.plan.plan else None,
            "solve_s": gw.plan.plan.solve_time_s if gw.plan.plan else None,
            "boot_s": boot_s,
            "predicted_step_ms": {n: gw.plan.predicted_decode_step_ms(n)
                                  for n, *_ in specs}}
    tenants = {name: Tenant(name, arch, slots, cap, gw.engines[name])
               for name, arch, slots, cap in specs}
    return System(tenants, gw, plan)


def warm_up(system: System, mix: dict, n_lengths: int) -> list[int]:
    """Serve prompts at ``n_lengths`` lengths spread over the mix's range
    (log-spaced, the shortest and longest among them) through every
    tenant, two tokens each, so that every kernel the window uses is
    built and loaded and the allocator holds the largest prefill's
    memory.  Returns the lengths."""
    lo, hi = int(mix["prompt_len"]["min"]), int(mix["prompt_len"]["max"])
    lengths = sorted({int(round(x)) for x in
                      np.geomspace(lo, hi, max(2, n_lengths))})
    for name, t in system.tenants.items():
        vocab = t.arch["vocab"]
        for i, n in enumerate(lengths):
            system.submit(name, traffic.prompt_ids(0, WARM_UP_INDEX + i, n,
                                                   vocab), 2)
    while system.has_work:
        system.step()
    system.reset()
    return lengths


class Window:
    """Serves the traffic for ``seconds`` and records what the metrics
    read.  ``slice_s`` > 0 profiles the window's last ``slice_s`` seconds
    (``torch.profiler``, host and device), labels the host's work, and
    records the prefill lengths and decode lengths of that slice."""

    def __init__(self, system: System, seed: int, slice_s: float = 0.0):
        self.system = system
        self.seed = seed
        self.slice_s = slice_s
        self.tracks: dict[str, list[Track]] = {n: [] for n in system.tenants}
        self.live: dict[str, list[Track]] = {n: [] for n in system.tenants}
        #: (tenant, t0, t1, decode ms, prompt tokens admitted)
        self.steps: list[tuple] = []
        #: (t0, t1) of each gateway step
        self.gateway_steps: list[tuple] = []
        self.counters0: dict = {}
        self.profiler = None
        self.profiled_from = None
        self.slice_prefills: dict[str, list[int]] = {n: [] for n in system.tenants}
        self.slice_decodes: dict[str, list[np.ndarray]] = {
            n: [] for n in system.tenants}
        self.lateness: list[float] = []
        self.t0 = 0.0
        self.end = 0.0
        self._wrap()

    # ---- instrumentation --------------------------------------------------
    def _profiling(self) -> bool:
        return self.profiler is not None

    def _wrap(self) -> None:
        label = self.slice_s > 0
        for name, t in self.system.tenants.items():
            eng = t.engine
            # wrap the class's methods, so that a later window replaces
            # this one's wrappers instead of wrapping them
            eng.step = self._timed_step(name, eng, type(eng).step.__get__(eng),
                                        label)
            model = eng.model
            model.__dict__.pop("prefill", None)
            if isinstance(eng.graph, _Labelled):
                eng.graph = eng.graph.fn
            if label:
                pre = self.slice_prefills[name]
                dec = self.slice_decodes[name]
                model.prefill = _Labelled(
                    model.prefill, "pb.prefill",
                    lambda batch, *a, pre=pre, **k: pre.append(
                        int(batch["token_ids"].shape[1])), self._profiling)
                eng.graph = _Labelled(
                    eng.graph, "pb.replay",
                    lambda tok, lengths, dec=dec: dec.append(lengths.copy()),
                    self._profiling)
        gw = self.system.gateway
        if gw is not None:
            orig = type(gw).step.__get__(gw)

            def gateway_step(*a, **k):
                t0 = clock() - self.t0
                with (torch.profiler.record_function("pb.gateway") if label
                      else contextlib.nullcontext()):
                    out = orig(*a, **k)
                self.gateway_steps.append((t0, clock() - self.t0))
                return out
            gw.step = gateway_step

    def _timed_step(self, name, eng, orig, label):
        live = self.live[name]

        def step():
            c = eng.counters
            steps0 = c.steps
            t0 = clock() - self.t0
            with (torch.profiler.record_function(f"pb.step.{name}") if label
                  else contextlib.nullcontext()):
                out = orig()
            t1 = clock() - self.t0
            admitted = 0
            still = []
            for tr in live:
                n = len(tr.req.tokens)
                if n > len(tr.stamps):
                    if not tr.stamps:
                        admitted += len(tr.prompt)
                    tr.stamps.extend([t1] * (n - len(tr.stamps)))
                if not tr.req.done:
                    still.append(tr)
            live[:] = still
            decode_ms = c.last_step_ms if c.steps > steps0 else 0.0
            self.steps.append((name, t0, t1, decode_ms, admitted))
            return out
        return step

    # ---- traffic ----------------------------------------------------------
    def _submit(self, a: traffic.Arrival, due: float, now: float) -> None:
        t = self.system.tenants[a.tenant]
        prompt = traffic.prompt_ids(self.seed, a.index, a.prompt_len,
                                    t.arch["vocab"])
        req = self.system.submit(a.tenant, prompt, a.max_new)
        tr = Track(a, prompt, req, due, now)
        self.tracks[a.tenant].append(tr)
        self.live[a.tenant].append(tr)
        self.lateness.append(now - due)

    def _start(self) -> None:
        gc.collect()
        gc.freeze()
        self.counters0 = self.counters()
        self.t0 = clock()

    def _maybe_profile(self, now: float, seconds: float) -> None:
        if self.slice_s > 0 and self.profiler is None \
                and now >= seconds - self.slice_s:
            from torch.profiler import profile
            self.profiler = profile(activities=profiler_activities())
            self.profiler.__enter__()
            self._slice = torch.profiler.record_function("pb.slice")
            self._slice.__enter__()
            self.profiled_from = clock() - self.t0

    def _finish(self) -> None:
        self.end = clock() - self.t0
        if self.profiler is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._slice.__exit__(None, None, None)
            self.profiler.__exit__(None, None, None)
        gc.unfreeze()

    def open_loop(self, arrivals: list[traffic.Arrival], seconds: float) -> None:
        """Submit each arrival when it is due; step while there is work."""
        label = self.slice_s > 0
        self._start()
        i, n = 0, len(arrivals)
        while True:
            now = clock() - self.t0
            if now >= seconds:
                break
            self._maybe_profile(now, seconds)
            if i < n and arrivals[i].at_s <= now:
                with (torch.profiler.record_function("pb.generator") if label
                      else contextlib.nullcontext()):
                    while i < n and arrivals[i].at_s <= now:
                        self._submit(arrivals[i], arrivals[i].at_s, now)
                        i += 1
            if self.system.has_work:
                self.system.step()
                continue
            nxt = min(arrivals[i].at_s if i < n else seconds, seconds)
            with (torch.profiler.record_function("pb.wait") if label
                  else contextlib.nullcontext()):
                time.sleep(max(0.0, nxt - (clock() - self.t0)))
        self._finish()

    def closed_loop(self, backlog, seconds: float) -> None:
        """Keep every tenant's queue longer than its slots, and step."""
        self._start()
        while True:
            now = clock() - self.t0
            if now >= seconds:
                break
            self._maybe_profile(now, seconds)
            while any(len(t.engine.queue) <= t.slots
                      for t in self.system.tenants.values()):
                self._submit(next(backlog), now, now)
            self.system.step()
        self._finish()

    # ---- what was recorded -------------------------------------------------
    def counters(self) -> dict:
        """The program's counters now: each engine's ``EngineMetrics`` and
        the kernels' launch counts."""
        from repro_torch.kernels import decode_attention, flash_attention
        out = {f"{n}.{k}": getattr(t.engine.counters, k)
               for n, t in self.system.tenants.items()
               for k in ("steps", "admitted", "tokens_out", "decode_ms_total")}
        out["flash_attention.launches"] = flash_attention.launches
        out["decode_attention.launches"] = decode_attention.launches
        if self.system.gateway is not None:
            out["gateway.reschedules"] = len(self.system.gateway.reschedules)
            out["gateway.deferred"] = self.system.gateway.deferred_admissions
        return out

    def done(self, tenant: str) -> list[Track]:
        """The tenant's requests finished inside the window, by index."""
        return [tr for tr in self.tracks[tenant]
                if tr.req.done and tr.stamps and tr.stamps[-1] <= self.end]


def percentile(values, q: float) -> float | None:
    v = np.asarray(values, np.float64)
    return float(np.percentile(v, q)) if len(v) else None
