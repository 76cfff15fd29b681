"""Layer grouping (§3.1): raw layers -> atomic schedulable layer groups.

Three grouping rules from the paper:
  1. *Preserve layer optimizations*: spans the framework would fuse
     (conv+bn+relu, attention qkv+softmax+proj, matmul+bias+act) must stay on
     one accelerator — fused layers merge into one group.
  2. *Avoid input/output reformatting*: boundaries whose tensor layout
     differs between accelerators pay a reformat penalty; layers flagged
     ``reformat_after`` are merged forward unless the boundary is also a
     natural (e.g. post-pooling, small-tensor) transition point.
  3. *Accelerator/software limitations*: boundaries after which a framework
     forbids transitions (TensorRT: no DLA->GPU right after Eltwise) collapse
     the boundary entirely.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

from .graph import DNNGraph, LayerGroup


@dataclass(frozen=True)
class RawLayer:
    """One framework-level layer before grouping."""

    name: str
    kind: str                       # conv / pool / fc / eltwise / attn / ...
    times: Mapping[str, float]
    mem_demand: Mapping[str, float] = field(default_factory=dict)
    out_bytes: float = 0.0
    #: rule 1 — this layer fuses with its successor.
    fuse_with_next: bool = False
    #: rule 3 — framework forbids an inter-accelerator transition after it.
    no_transition_after: bool = False
    #: rule 2 — transitioning here inserts a costly reformat.
    reformat_after: bool = False


#: layer kinds after which transitions are naturally cheap (small outputs,
#: pipeline-friendly — the paper observes pooling boundaries transition ~5x
#: cheaper, Table 2 groups 39-53 / 95-109).
CHEAP_BOUNDARY_KINDS = frozenset({"pool", "globalpool", "fc", "norm"})


def group_layers(name: str, layers: Sequence[RawLayer]) -> DNNGraph:
    """Apply rules 1-3 to produce the minimal atomic layer groups."""
    if not layers:
        raise ValueError("no layers")
    groups: list[list[RawLayer]] = []
    cur: list[RawLayer] = []
    for i, layer in enumerate(layers):
        cur.append(layer)
        last = i == len(layers) - 1
        if last:
            groups.append(cur)
            break
        if layer.fuse_with_next or layer.no_transition_after:
            continue                                  # rules 1 & 3: merge on
        if layer.reformat_after and layer.kind not in CHEAP_BOUNDARY_KINDS:
            continue                                  # rule 2: merge on
        groups.append(cur)
        cur = []

    out: list[LayerGroup] = []
    for gi, span in enumerate(groups):
        accs = set(span[0].times)
        for l in span[1:]:
            accs &= set(l.times)
        if not accs:
            raise ValueError(
                f"group {gi} of {name} has no common accelerator")
        times = {a: sum(l.times[a] for l in span) for a in accs}
        demand = {
            a: (sum(l.mem_demand.get(a, 0.0) * l.times[a] for l in span)
                / times[a] if times[a] else 0.0)
            for a in accs
        }
        out.append(LayerGroup(
            name=f"{span[0].name}..{span[-1].name}" if len(span) > 1
                 else span[0].name,
            times=times,
            mem_demand=demand,
            out_bytes=span[-1].out_bytes,
            can_transition_after=gi < len(groups) - 1 or True,
        ))
    return DNNGraph(name, tuple(out))
