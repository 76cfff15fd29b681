"""DNN graph IR for the HaX-CoNN scheduler.

A DNN is an ordered chain of *layer groups* (the paper's atomic schedulable
units, §3.1).  Each group carries the decoupled characterization data of
§3.2-3.3:

  * ``times[a]``        — standalone execution time on accelerator ``a`` (ms)
  * ``mem_demand[a]``   — requested shared-resource bandwidth while running on
                          ``a``, as a *fraction of the contention-domain
                          capacity* (the paper's "Memory Thr. (%)" column)
  * ``out_bytes``       — activation bytes crossing a transition boundary
                          after this group (drives τ(L, a, OUT|IN))
  * ``can_transition_after`` — §3.1 legality (fusion / reformatting /
                          framework constraints collapse illegal boundaries)

Groups may be produced three ways: hand-calibrated paper profiles
(:mod:`repro_torch.core.profiles`), analytic roofline characterization
(:mod:`repro_torch.core.characterize`), or export from a JAX model
(:mod:`repro.models.graph_export`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Sequence


@dataclass(frozen=True)
class LayerGroup:
    """One atomic schedulable unit (a fused span of layers)."""

    name: str
    #: standalone execution time per accelerator name, in milliseconds.
    times: Mapping[str, float]
    #: requested bandwidth on the shared contention domain while executing on
    #: accelerator ``a``, as a fraction in [0, ~1.5] of domain capacity.
    mem_demand: Mapping[str, float] = field(default_factory=dict)
    #: bytes of activation output that must be flushed to shared memory if a
    #: transition happens after this group.
    out_bytes: float = 0.0
    #: whether an inter-accelerator transition is legal after this group.
    can_transition_after: bool = True
    #: bookkeeping: analytic FLOPs / HBM bytes for roofline-derived groups.
    flops: float = 0.0
    hbm_bytes: float = 0.0

    def time_on(self, acc: str) -> float:
        return float(self.times[acc])

    def demand_on(self, acc: str) -> float:
        return float(self.mem_demand.get(acc, 0.0))

    def with_times(self, times: Mapping[str, float]) -> "LayerGroup":
        return dataclasses.replace(self, times=dict(times))


@dataclass(frozen=True)
class DNNGraph:
    """An ordered chain of layer groups belonging to one network."""

    name: str
    groups: tuple[LayerGroup, ...]

    def __post_init__(self) -> None:
        if not self.groups:
            raise ValueError(f"DNN {self.name!r} has no layer groups")

    def __len__(self) -> int:
        return len(self.groups)

    def __iter__(self):
        return iter(self.groups)

    def __getitem__(self, i: int) -> LayerGroup:
        return self.groups[i]

    @property
    def accelerators(self) -> tuple[str, ...]:
        accs: set[str] = set(self.groups[0].times)
        for g in self.groups[1:]:
            accs &= set(g.times)
        return tuple(sorted(accs))

    def standalone_time(self, acc: str) -> float:
        """Total contention-free time if every group runs on ``acc``."""
        return sum(g.time_on(acc) for g in self.groups)

    def transition_points(self) -> tuple[int, ...]:
        """Indices i such that a transition after group i is legal."""
        return tuple(
            i for i, g in enumerate(self.groups[:-1]) if g.can_transition_after
        )

    def merged(self, boundaries: Sequence[int]) -> "DNNGraph":
        """Coarsen: keep only transition boundaries listed in ``boundaries``.

        Groups between consecutive kept boundaries are merged (times and
        demands combine: times add, demand is the time-weighted mean).
        Used to shrink solver instances for very deep networks.
        """
        keep = sorted(set(boundaries) | {len(self.groups) - 1})
        merged: list[LayerGroup] = []
        start = 0
        for b in keep:
            span = self.groups[start : b + 1]
            merged.append(_merge_span(span))
            start = b + 1
        return DNNGraph(self.name, tuple(merged))


def _merge_span(span: Sequence[LayerGroup]) -> LayerGroup:
    if len(span) == 1:
        return span[0]
    accs = set(span[0].times)
    for g in span[1:]:
        accs &= set(g.times)
    times = {a: sum(g.time_on(a) for g in span) for a in accs}
    demand = {}
    for a in accs:
        tot = times[a]
        demand[a] = (
            sum(g.demand_on(a) * g.time_on(a) for g in span) / tot if tot else 0.0
        )
    return LayerGroup(
        name=f"{span[0].name}..{span[-1].name}",
        times=times,
        mem_demand=demand,
        out_bytes=span[-1].out_bytes,
        can_transition_after=span[-1].can_transition_after,
        flops=sum(g.flops for g in span),
        hbm_bytes=sum(g.hbm_bytes for g in span),
    )
