"""Deterministic virtual SoC: a synthetic measurement target for CI.

The characterization→calibration pipeline (§4.1–4.2) needs something to
*measure*.  Real hardware measures itself; CI has no accelerator.  The
:class:`VirtualSoC` stands in: it "executes" layer groups of ground-truth
:class:`~repro_torch.core.graph.DNNGraph` profiles on a
:class:`~repro_torch.core.accelerators.Platform`, returning per-run wall
times synthesized from the group's standalone time, a *generating*
contention model (any :class:`~repro_torch.core.contention.
ContentionModel`) applied to the co-running antagonist demand, and
seeded measurement noise with occasional preemption-style outliers.

Because the generator is the repo's own contention machinery, the whole
pipeline is differentially testable without hardware: calibrate a
:class:`~repro_torch.core.contention.PiecewiseModel` from virtual co-run
measurements, then assert the fitted model reproduces the generating
model's slowdowns and that a schedule solved from the measured bundle
matches the plan solved from ground truth.

Determinism: one :class:`numpy.random.Generator` seeded at construction;
the same call sequence yields the same measurements bit-for-bit.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from ..core.accelerators import Platform
from ..core.contention import ContentionModel, PiecewiseModel
from ..core.graph import DNNGraph


def paper_like_pccs() -> PiecewiseModel:
    """A Fig.-6-shaped ground-truth PCCS surface (up to ~2.6x slowdown).

    Used as the default generating model of the virtual SoC: monotone in
    both demands, mild below half capacity, steep once combined demand
    oversubscribes the domain — the co-run slowdown magnitudes the paper
    reports (§5.2, up to ~70% performance loss).
    """
    return PiecewiseModel(
        own_knots=(0.1, 0.3, 0.5, 0.7, 0.9),
        ext_knots=(0.1, 0.3, 0.5, 0.7, 0.9),
        table=(
            (1.00, 1.02, 1.06, 1.12, 1.20),
            (1.02, 1.08, 1.18, 1.32, 1.50),
            (1.05, 1.15, 1.32, 1.55, 1.82),
            (1.08, 1.24, 1.48, 1.80, 2.18),
            (1.12, 1.34, 1.64, 2.05, 2.60),
        ))


class VirtualSoC:
    """Synthetic timed-execution target driven by a generating model.

    Implements the executor interface the harness profiles against:
    ``run_group`` (one timed execution under a given external antagonist
    demand), ``read_demand`` (the §3.2 requested-throughput counter
    readout) and ``out_bytes`` — all per (graph, group index, accelerator).

    ``noise`` is the relative σ of multiplicative Gaussian timing noise;
    ``outlier_rate`` injects occasional ``outlier_scale``× preemption
    spikes so the harness's outlier rejection has real work to do.
    """

    def __init__(self, platform: Platform,
                 graphs: Sequence[DNNGraph],
                 model: ContentionModel | Mapping[str, ContentionModel]
                 | None = None, *,
                 noise: float = 0.005,
                 outlier_rate: float = 0.0,
                 outlier_scale: float = 3.0,
                 seed: int = 0):
        self.platform = platform
        self.graphs: dict[str, DNNGraph] = {g.name: g for g in graphs}
        if len(self.graphs) != len(graphs):
            raise ValueError("duplicate graph names")
        model = paper_like_pccs() if model is None else model
        if hasattr(model, "slowdown"):
            self.models = {dom: model for dom in platform.domains} \
                or {"_": model}
            self._fallback = model
        else:
            self.models = dict(model)
            self._fallback = next(iter(self.models.values()))
        self.noise = float(noise)
        self.outlier_rate = float(outlier_rate)
        self.outlier_scale = float(outlier_scale)
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        #: executions performed (provenance: sample counts).
        self.runs = 0

    # -- executor interface -------------------------------------------------
    def graph_names(self) -> tuple[str, ...]:
        return tuple(self.graphs)

    def group(self, name: str, gi: int):
        return self.graphs[name].groups[gi]

    def group_count(self, name: str) -> int:
        return len(self.graphs[name])

    def accelerators_of(self, name: str, gi: int) -> tuple[str, ...]:
        return tuple(sorted(self.group(name, gi).times))

    def _domain_of(self, acc: str) -> str:
        for dom, members in self.platform.domains.items():
            if acc in members:
                return dom
        return "_"

    def true_slowdown(self, acc: str, own: float, external: float) -> float:
        """Generating-model slowdown (the quantity calibration recovers)."""
        if own <= 0.0 or external <= 0.0:
            return 1.0
        # an accelerator outside every domain contends through the
        # fallback model rather than crashing the sweep.
        model = self.models.get(self._domain_of(acc), self._fallback)
        return max(1.0, model.slowdown(own, external))

    def run_group(self, name: str, gi: int, acc: str,
                  external: float = 0.0) -> float:
        """One timed "execution": measured wall ms for this group on
        ``acc`` while the antagonist requests ``external`` of the domain
        capacity."""
        grp = self.group(name, gi)
        base = grp.time_on(acc)
        s = self.true_slowdown(acc, grp.demand_on(acc), external)
        t = base * s * max(0.5, 1.0 + self.noise * self._rng.standard_normal())
        if self.outlier_rate and self._rng.random() < self.outlier_rate:
            t *= self.outlier_scale
        self.runs += 1
        return t

    def read_demand(self, name: str, gi: int, acc: str) -> float:
        """Requested-throughput counter readout (noisy, >= 0)."""
        d = self.group(name, gi).demand_on(acc)
        return max(0.0, d * (1.0 + self.noise * self._rng.standard_normal()))

    def out_bytes(self, name: str, gi: int) -> float:
        return self.group(name, gi).out_bytes

    def describe(self) -> dict:
        """Provenance block for the bundle."""
        return {
            "executor": "virtual-soc",
            "platform": self.platform.name,
            "noise": self.noise,
            "outlier_rate": self.outlier_rate,
            "outlier_scale": self.outlier_scale,
            "seed": self.seed,
            "runs": self.runs,
            "generating_model": type(next(iter(self.models.values()))
                                     ).__name__,
        }
