"""Timed-execution harness: measured characterization (§3.2, step 1).

Two measurement surfaces share one timing discipline (warmup, repetition,
a synchronize of the caller's current CUDA stream, MAD outlier
rejection):

* **kernel workloads** — layer groups assembled from the port's own model
  configs and kernels (:mod:`repro_torch.kernels.ops` attention / decode
  attention + the FFN matmuls), timed on the card or, when asked, the CPU
  (:func:`measure_arch`).  Group FLOPs/bytes come from the same analytic
  cost model :mod:`repro_torch.models.graph_export` uses, so a
  measurement is a :class:`~repro_torch.core.characterize.GroupCosts`
  plus a wall-time :class:`Measurement` instead of a roofline estimate.
* **executor targets** — anything implementing ``run_group``/
  ``read_demand`` per (graph, group, accelerator), i.e. the deterministic
  :class:`~repro_torch.profiling.virtual.VirtualSoC` in CI and, on a real
  SoC, a device-runner shim (:func:`profile_graphs`, :func:`corun_sweep`).

``profile_graphs`` emits *measured* :class:`~repro_torch.core.graph.DNNGraph`
profiles (median standalone times + mean demand counter readouts);
``corun_sweep`` co-runs every (group, accelerator) against a swept
antagonist demand and emits the (own, external) → slowdown samples PCCS
calibration consumes (:mod:`repro_torch.profiling.calibrate`).

Counterpart of ``repro/profiling/harness.py``: the executor side is a
copy; ``measure_wallclock``, ``_group_runner``, ``measure_arch`` and
``local_device_provenance`` are written for PyTorch.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Protocol, Sequence

import torch

from ..core.accelerators import MS, Platform
from ..core.characterize import GroupCosts, roofline_time_ms
from ..core.graph import DNNGraph, LayerGroup

#: one (own demand, external demand, measured slowdown) calibration sample.
Sample = tuple[float, float, float]


# ---------------------------------------------------------------------------
# timing discipline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TimerConfig:
    """Repetition/outlier policy applied to every measurement."""

    #: discarded leading calls (kernel builds, cache and allocator warmup).
    warmup: int = 2
    #: timed calls per measurement.
    repeats: int = 7
    #: modified-z-score (MAD) threshold beyond which a sample is rejected.
    outlier_z: float = 3.5
    #: never reject below this many kept samples.
    min_kept: int = 3

    def __post_init__(self):
        if self.repeats < 1 or self.warmup < 0:
            raise ValueError("repeats must be >= 1 and warmup >= 0")
        if self.min_kept < 1:
            raise ValueError("min_kept must be >= 1")

    def to_dict(self) -> dict:
        return {"warmup": self.warmup, "repeats": self.repeats,
                "outlier_z": self.outlier_z, "min_kept": self.min_kept}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TimerConfig":
        return cls(**dict(d))


@dataclass(frozen=True)
class Measurement:
    """One repeated, outlier-rejected timing of a single quantity."""

    name: str
    kept_ms: tuple[float, ...]
    rejected_ms: tuple[float, ...] = ()

    @property
    def median_ms(self) -> float:
        return statistics.median(self.kept_ms)

    @property
    def mean_ms(self) -> float:
        return statistics.fmean(self.kept_ms)

    @property
    def std_ms(self) -> float:
        return statistics.pstdev(self.kept_ms) if len(self.kept_ms) > 1 \
            else 0.0

    @property
    def n_total(self) -> int:
        return len(self.kept_ms) + len(self.rejected_ms)


def reject_outliers(times_ms: Sequence[float], *, outlier_z: float = 3.5,
                    min_kept: int = 3) -> tuple[list[float], list[float]]:
    """Split samples into (kept, rejected) by modified z-score.

    The modified z-score ``0.6745 * (x - median) / MAD`` is robust to the
    very outliers it screens (preemptions, frequency ramps); when the MAD
    degenerates to 0 every sample is kept.  At most ``len - min_kept``
    samples are rejected, dropping the most extreme first.
    """
    times = [float(t) for t in times_ms]
    med = statistics.median(times)
    mad = statistics.median(abs(t - med) for t in times)
    if mad <= 0.0 or len(times) <= min_kept:
        return times, []
    scored = sorted(((abs(0.6745 * (t - med) / mad), i)
                     for i, t in enumerate(times)), reverse=True)
    reject_idx: set[int] = set()
    for z, i in scored:
        if z <= outlier_z or len(times) - len(reject_idx) <= min_kept:
            break
        reject_idx.add(i)
    kept = [t for i, t in enumerate(times) if i not in reject_idx]
    rejected = [t for i, t in enumerate(times) if i in reject_idx]
    return kept, rejected


def measurement_from_times(name: str, times_ms: Sequence[float],
                           timer: TimerConfig) -> Measurement:
    kept, rejected = reject_outliers(times_ms, outlier_z=timer.outlier_z,
                                     min_kept=timer.min_kept)
    return Measurement(name, tuple(kept), tuple(rejected))


def measure_samples(sample_fn: Callable[[], float], *,
                    timer: TimerConfig = TimerConfig(),
                    name: str = "") -> Measurement:
    """Measure a source that *returns* per-run milliseconds (an executor)."""
    for _ in range(timer.warmup):
        sample_fn()
    return measurement_from_times(
        name, [sample_fn() for _ in range(timer.repeats)], timer)


def _wait() -> None:
    """Wait for the work queued on the caller's current CUDA stream.

    Only that stream: a :class:`~repro_torch.profiling.probes.MemoryProbe`
    streams on its own, and a device-wide synchronize would charge the
    antagonist's queued passes to the target as slowdown.  CPU work is
    eager, so there is nothing to wait for before CUDA is initialized."""
    if torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


def measure_wallclock(fn: Callable[[], Any], *,
                      timer: TimerConfig = TimerConfig(),
                      name: str = "") -> Measurement:
    """Wall-clock timing of ``fn`` with async-dispatch discipline.

    After every call the caller's current CUDA stream is synchronized
    before the clock stops (:func:`_wait`), so asynchronously launched
    device work is charged to the call that launched it; warmup calls
    absorb kernel builds and allocator warm-up.
    """
    for _ in range(timer.warmup):
        fn()
        _wait()
    times = []
    for _ in range(timer.repeats):
        t0 = time.perf_counter()
        fn()
        _wait()
        times.append((time.perf_counter() - t0) * 1e3)  # s -> ms
    return measurement_from_times(name, times, timer)


#: :func:`measure_device`'s spin before each timed call: ~0.5 ms at an
#: H100's 1.98 GHz boost clock, past the host's launch of a wrapper
SPIN_CYCLES = 1_000_000


def measure_device(fn: Callable[[], Any], *,
                   timer: TimerConfig = TimerConfig(),
                   name: str = "") -> Measurement:
    """Device time of ``fn`` on the card: CUDA events recorded on the
    caller's current stream around each call (after ``timer.warmup``
    calls), the stream synchronized before each reading.  The port's
    calibration times its stream passes so: on an H100 a 1 GB pass lasts
    ~0.33 ms, and the ~0.04 ms the host adds to launch and wait for it
    varies more than the steps between the demand levels it measures.
    A spin of :data:`SPIN_CYCLES` is queued before each start event, so
    the stream is busy while the host launches ``fn``: on an idle stream
    the start event fires at once and the window holds the host's launch
    latency too (on an H100 a 1 GB pass then read 0.36-0.40 ms, swinging
    co-run ratios by 15%).  ``fn`` must run on the card (off it there is
    no device clock: use :func:`measure_wallclock`)."""
    for _ in range(timer.warmup):
        fn()
    _wait()
    times = []
    for _ in range(timer.repeats):
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return measurement_from_times(name, times, timer)


# ---------------------------------------------------------------------------
# executor profiling: measured graphs + co-run slowdown samples
# ---------------------------------------------------------------------------

class Executor(Protocol):
    """A measurable target: the virtual SoC, or a real-device shim."""

    platform: Platform

    def graph_names(self) -> tuple[str, ...]: ...
    def group_count(self, name: str) -> int: ...
    def accelerators_of(self, name: str, gi: int) -> tuple[str, ...]: ...
    def run_group(self, name: str, gi: int, acc: str,
                  external: float = 0.0) -> float: ...
    def read_demand(self, name: str, gi: int, acc: str) -> float: ...
    def out_bytes(self, name: str, gi: int) -> float: ...


def profile_graphs(ex: Executor, *, timer: TimerConfig = TimerConfig(),
                   demand_reads: int = 5) -> tuple[DNNGraph, ...]:
    """Measured standalone characterization of every graph on ``ex``.

    Per (group, accelerator): ``timer.repeats`` standalone executions →
    outlier-rejected median time; ``demand_reads`` counter readouts →
    mean requested throughput.  Returns schedulable measured graphs.
    """
    graphs = []
    for name in ex.graph_names():
        groups = []
        for gi in range(ex.group_count(name)):
            times: dict[str, float] = {}
            demand: dict[str, float] = {}
            for acc in ex.accelerators_of(name, gi):
                m = measure_samples(
                    lambda a=acc: ex.run_group(name, gi, a),
                    timer=timer, name=f"{name}[{gi}]@{acc}")
                times[acc] = m.median_ms
                demand[acc] = statistics.fmean(
                    ex.read_demand(name, gi, acc)
                    for _ in range(max(1, demand_reads)))
            groups.append(LayerGroup(
                name=f"{name}-g{gi}", times=times, mem_demand=demand,
                out_bytes=ex.out_bytes(name, gi)))
        graphs.append(DNNGraph(name, tuple(groups)))
    return tuple(graphs)


def corun_sweep(ex: Executor, measured: Sequence[DNNGraph], *,
                ext_levels: Sequence[float] = (0.15, 0.3, 0.45, 0.6,
                                               0.75, 0.9, 1.05),
                timer: TimerConfig = TimerConfig(),
                ) -> list[Sample]:
    """Co-run every (group, accelerator) against the antagonist sweep.

    The antagonist (:mod:`repro_torch.profiling.probes` on hardware; the
    ``external=`` knob of the virtual SoC) requests each level of the
    contention-domain capacity while the target group runs standalone-
    style repetitions; each pair yields one (own, external, slowdown)
    sample where slowdown = co-run median / measured standalone median.
    """
    by_name = {g.name: g for g in measured}
    samples: list[Sample] = []
    for name in ex.graph_names():
        mg = by_name[name]
        for gi in range(ex.group_count(name)):
            for acc in ex.accelerators_of(name, gi):
                own = mg.groups[gi].demand_on(acc)
                base = mg.groups[gi].time_on(acc)
                if own <= 0.0 or base <= 0.0:
                    continue
                for ext in ext_levels:
                    m = measure_samples(
                        lambda a=acc, e=ext: ex.run_group(name, gi, a, e),
                        timer=timer, name=f"{name}[{gi}]@{acc} ext={ext}")
                    samples.append((own, float(ext),
                                    max(1.0, m.median_ms / base)))
    return samples


# ---------------------------------------------------------------------------
# kernel workloads: measured GroupCosts from the repo's model substrate
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeasuredGroup:
    """One layer group's analytic costs plus its measured wall time."""

    costs: GroupCosts
    measurement: Measurement

    @property
    def ms(self) -> float:
        return self.measurement.median_ms


def _seeded_normal(device):
    """Standard-normal float32 operands of a group, drawn in call order
    from a generator seeded with 0 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)
    return normal


def _group_runner(cfg, span: Sequence[str], cell, backend: str, device):
    """A closure executing one group's layer kinds once, eagerly.

    Operands are made once, outside the closure, by :func:`_seeded_normal`
    in the reference's order (x, w1, w2; then q, k cache, v cache for
    attention; the gate and input for rglru; r, the decay and u for
    rwkv); the token mixers go through :mod:`repro_torch.kernels.ops`, so
    a CUDA tensor launches the flash (prefill) or decode kernel, the
    RG-LRU scan or the RWKV-6 scan."""
    from ..kernels import ops

    for kind in span:
        if kind not in ("attn", "local", "rglru", "rwkv"):
            raise ValueError(f"unknown layer kind {kind!r}")
    B = cell.global_batch
    S = 1 if cell.kind == "decode" else cell.seq_len
    kv_len = cell.seq_len
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    d, ff = cfg.d_model, cfg.d_ff
    normal = _seeded_normal(device)
    x = normal(B, S, d)
    w1 = normal(d, ff) * 0.02
    w2 = normal(ff, d) * 0.02
    # operand families are only materialized for layer kinds the span
    # actually contains — KV caches in particular scale with seq_len.
    if set(span) & {"attn", "local"}:
        q = normal(B, S, hq, dh)
        kcache = normal(B, kv_len, hkv, dh)
        vcache = normal(B, kv_len, hkv, dh)
        lengths = torch.full((B,), kv_len, dtype=torch.int32, device=device)
        # the kernel takes contiguous operands only (XLA sliced for free)
        kpre = kcache[:, :S].contiguous()
        vpre = vcache[:, :S].contiguous()
    if "rglru" in span:
        a_gate = torch.sigmoid(normal(B, S, cfg.d_rnn))
        b_in = normal(B, S, cfg.d_rnn)
    if "rwkv" in span:
        h_rwkv = cfg.n_heads or d // 64
        dh_rwkv = d // h_rwkv
        r = normal(B, S, h_rwkv, dh_rwkv)
        w_dec = torch.sigmoid(normal(B, S, h_rwkv, dh_rwkv) + 2.0)
        u = normal(h_rwkv, dh_rwkv) * 0.3

    def run_kind(kind, h):
        if kind == "rglru":
            hs, _ = ops.linear_scan(a_gate, b_in, backend=backend)
            h = h + hs.sum(-1, keepdim=True)
        elif kind == "rwkv":
            y, _ = ops.rwkv6(r, r * 0.3, r, w_dec, u, backend=backend)
            h = h + y.reshape(B, S, -1).sum(-1, keepdim=True)
        else:
            win = cfg.local_window if kind == "local" else None
            if cell.kind == "decode":
                o = ops.decode_attention(q, kcache, vcache, lengths,
                                         backend=backend)
            else:
                o = ops.attention(q, kpre, vpre, causal=True, window=win,
                                  backend=backend)
            h = h + o.reshape(B, S, -1).sum(-1, keepdim=True)
        # the FFN matmuls every block carries (rwkv folds its channel mix
        # into the same two-matmul shape in this cost model)
        return h + torch.relu(x @ w1) @ w2

    def run_once():
        h = torch.zeros((B, S, 1), dtype=torch.float32, device=device)
        for kind in span:
            h = run_kind(kind, h)
        return h

    return run_once


def measure_arch(cfg, cell, *, backend: str = "auto",
                 timer: TimerConfig = TimerConfig(),
                 layers_per_group: int | None = None,
                 max_groups: int | None = None,
                 device=None) -> list[MeasuredGroup]:
    """Measure a config's layer groups on ``device`` (``cuda`` unless
    asked otherwise).

    Groups follow the same span structure as
    :func:`repro_torch.models.graph_export.export_graph`; each group's
    kernels (attention via :mod:`repro_torch.kernels.ops` + the FFN
    matmuls) run under the harness timing discipline.  FLOPs/bytes reuse
    the analytic cost model, so the result pairs *measured* time with the
    same :class:`GroupCosts` the roofline path estimates from.

    On the card ``timer.warmup`` must be at least 1: the first call of a
    process builds the kernels with ``nvcc``, and a warmup of 0 would
    time the build.
    """
    from ..models.graph_export import _layer_bytes, _layer_flops
    from ..runtime import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and timer.warmup < 1:
        raise ValueError("measure_arch on cuda needs timer.warmup >= 1: "
                         "the first call builds the kernels")
    decode = cell.kind == "decode"
    tokens = cell.global_batch * (1 if decode else cell.seq_len)
    kinds = cfg.layer_kinds
    P = len(cfg.block_pattern)
    if layers_per_group is None:
        layers_per_group = max(P, (cfg.n_layers + 7) // 8 // P * P or P)
    out: list[MeasuredGroup] = []
    i = 0
    while i < len(kinds):
        if max_groups is not None and len(out) >= max_groups:
            break
        span = kinds[i:i + layers_per_group]
        fl = sum(_layer_flops(cfg, k, tokens, cell.seq_len) for k in span)
        by = sum(_layer_bytes(cfg, k, tokens, cell.seq_len, decode)
                 for k in span)
        costs = GroupCosts(
            name=f"L{i}-{i + len(span) - 1}", flops=fl, hbm_bytes=by,
            shared_bytes=by,
            out_bytes=tokens * cfg.d_model * 2)
        m = measure_wallclock(
            _group_runner(cfg, span, cell, backend, device),
            timer=timer, name=f"{cfg.name}:{costs.name}")
        out.append(MeasuredGroup(costs, m))
        i += len(span)
    return out


def graph_from_measurements(name: str, platform: Platform,
                            measured: Sequence[MeasuredGroup],
                            anchor: str | None = None,
                            domain: str | None = None) -> DNNGraph:
    """Schedulable graph from measured groups, anchored on one accelerator.

    The measured wall time pins the ``anchor`` accelerator column (default
    the platform's first); other accelerators are scaled by the ratio of
    their analytic roofline times — the same constrained-synthesis
    approach :mod:`repro_torch.core.profiles` uses where the paper publishes
    totals but not per-group columns.  Demand is the achieved shared-path
    byte rate over the domain capacity (clipped like ``characterize``).
    """
    anchor = anchor or platform.names[0]
    if domain is None and platform.domains:
        domain = next(iter(platform.domains))
    dom_bw = platform.domain_bw.get(domain) if domain else None
    dom_members = platform.domains.get(domain, ()) if domain else ()
    groups = []
    for mg in measured:
        t_anchor_analytic = roofline_time_ms(
            mg.costs, platform.acc(anchor), domain_bw=dom_bw)
        times: dict[str, float] = {}
        demand: dict[str, float] = {}
        for acc in platform.accelerators:
            ratio = (roofline_time_ms(mg.costs, acc, domain_bw=dom_bw)
                     / t_anchor_analytic) if t_anchor_analytic > 0 else 1.0
            t_ms = mg.ms if acc.name == anchor else mg.ms * ratio
            times[acc.name] = t_ms
            if dom_bw and acc.name in dom_members and t_ms > 0:
                shared = (mg.costs.shared_bytes
                          if mg.costs.shared_bytes is not None
                          else mg.costs.hbm_bytes)
                demand[acc.name] = min(1.5, (shared / (t_ms * MS)) / dom_bw)
        groups.append(LayerGroup(
            name=mg.costs.name, times=times, mem_demand=demand,
            out_bytes=mg.costs.out_bytes,
            can_transition_after=mg.costs.can_transition_after,
            flops=mg.costs.flops, hbm_bytes=mg.costs.hbm_bytes))
    return DNNGraph(name, tuple(groups))


def local_device_provenance(device=None) -> dict:
    """Backend/device identity recorded in measured bundles."""
    from ..runtime import resolve_device

    dev = resolve_device(device)
    prov = {"torch_backend": dev.type, "torch": torch.__version__}
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        prov.update(device=f"cuda:{props.name}",
                    n_devices=torch.cuda.device_count(),
                    sm_count=props.multi_processor_count,
                    memory_bytes=props.total_memory,
                    cuda=torch.version.cuda)
    else:
        prov.update(device="cpu", n_devices=1)
    return prov
