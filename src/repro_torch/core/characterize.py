"""Analytic (roofline) per-layer characterization (§3.2 decoupled step 1).

On the paper's SoCs, per-layer standalone times and memory throughputs come
from one-time offline profiling (TensorRT IProfiler / EMC counters).  The
analytic counterpart (copy of ``repro/core/characterize.py``): each layer
group carries FLOPs, HBM bytes and cross-boundary collective bytes from the
cost model (:mod:`repro_torch.models.graph_export`), and its standalone
time on a virtual accelerator is the roofline maximum of the three terms;
:mod:`repro_torch.profiling` replaces the estimate with a measured time.
The requested demand on the shared contention domain is the group's achieved
byte rate on that domain divided by the domain capacity — exactly the paper's
"requested memory throughput (%)" but derived instead of measured.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from .accelerators import MS, Accelerator, Platform
from .graph import DNNGraph, LayerGroup


@dataclass(frozen=True)
class GroupCosts:
    """Hardware-independent cost description of one layer group."""

    name: str
    flops: float
    hbm_bytes: float
    #: bytes this group moves over the shared contention domain while
    #: executing (collectives on a pod; DRAM traffic on an SoC where the
    #: shared domain *is* the memory path).
    shared_bytes: float | None = None
    #: activation bytes crossing a transition boundary after the group.
    out_bytes: float = 0.0
    can_transition_after: bool = True


def roofline_time_ms(costs: GroupCosts, acc: Accelerator,
                     compute_eff: float = 0.8,
                     domain_bw: float | None = None) -> float:
    """Standalone time = max(compute, memory, shared-path) roofline terms."""
    t_compute = costs.flops / (acc.peak_flops * compute_eff)
    t_memory = costs.hbm_bytes / acc.mem_bw
    t_shared = 0.0
    if costs.shared_bytes and domain_bw:
        t_shared = costs.shared_bytes / domain_bw
    return max(t_compute, t_memory, t_shared) / MS


def characterize(
    name: str,
    platform: Platform,
    costs: Sequence[GroupCosts],
    compute_eff: float | Mapping[str, float] = 0.8,
    domain: str | None = None,
) -> DNNGraph:
    """Build a schedulable :class:`DNNGraph` from analytic group costs."""
    if domain is None and platform.domains:
        domain = next(iter(platform.domains))
    dom_bw = platform.domain_bw.get(domain) if domain else None
    dom_members = platform.domains.get(domain, ()) if domain else ()

    groups = []
    for c in costs:
        times: dict[str, float] = {}
        demand: dict[str, float] = {}
        for acc in platform.accelerators:
            eff = (compute_eff.get(acc.name, 0.8)
                   if isinstance(compute_eff, Mapping) else compute_eff)
            t_ms = roofline_time_ms(c, acc, eff, dom_bw)
            times[acc.name] = t_ms
            if dom_bw and acc.name in dom_members and t_ms > 0:
                shared = (c.shared_bytes if c.shared_bytes is not None
                          else c.hbm_bytes)
                demand[acc.name] = min(1.5, (shared / (t_ms * MS)) / dom_bw)
        groups.append(LayerGroup(
            name=c.name, times=times, mem_demand=demand,
            out_bytes=c.out_bytes,
            can_transition_after=c.can_transition_after,
            flops=c.flops, hbm_bytes=c.hbm_bytes,
        ))
    return DNNGraph(name, tuple(groups))
