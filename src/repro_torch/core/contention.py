"""Shared-resource contention modeling (§3.3).

The paper decouples contention estimation into (1) a one-time standalone
characterization of each layer's *requested memory throughput* and (2) a
processor-centric slowdown model (PCCS [67]) that maps

    slowdown = f(own requested throughput, external requested throughput)

without ever profiling layer *pairs*.  We implement two interchangeable
models:

* :class:`ProportionalShareModel` — the analytic default.  While total demand
  is below domain capacity nothing slows down; beyond capacity the domain
  serves requesters proportionally, and a layer's slowdown is weighted by the
  fraction of its runtime that is bandwidth-bound (its *memory-boundedness*,
  derived from the demand itself).  Piecewise-linear in (own, external),
  matching PCCS's model class.

* :class:`PiecewiseModel` — PCCS proper: an explicit piecewise-linear surface
  over (own, external) given as calibration knots, e.g. fitted from measured
  co-run slowdowns.  The paper-calibrated SoC platforms use this with knots
  chosen to reproduce the published co-run slowdowns (Fig. 6).

Both are pure functions — the exact timeline simulator calls them once per
contention interval (Eq. 7/8).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Protocol, Sequence


class ContentionModel(Protocol):
    def slowdown(self, own: float, external: float) -> float:
        """Multiplicative slowdown (>= 1) of a layer requesting ``own``
        (fraction of domain capacity) while other accelerators in the same
        domain request ``external`` in total."""
        ...


@dataclass(frozen=True)
class ProportionalShareModel:
    """Bandwidth-partitioning slowdown model.

    If own + external <= capacity: no slowdown.  Otherwise the requester's
    achieved bandwidth is its proportional share ``own / total`` of capacity,
    so its memory-bound phase dilates by ``total / capacity``; the
    compute-bound phase (fraction ``1 - boundedness``) is unaffected.
    ``boundedness`` defaults to the demand itself clipped to [0, 1]: a layer
    requesting 80% of domain bandwidth spends ~80% of its time on memory.
    """

    capacity: float = 1.0
    #: optional scaling of how strongly over-subscription converts to delay.
    sensitivity: float = 1.0

    def slowdown(self, own: float, external: float) -> float:
        own = max(0.0, own)
        external = max(0.0, external)
        if own == 0.0:
            return 1.0
        total = own + external
        if total <= self.capacity:
            return 1.0
        boundedness = min(1.0, own / self.capacity)
        dilation = total / self.capacity
        return 1.0 + self.sensitivity * boundedness * (dilation - 1.0)


@dataclass(frozen=True)
class PiecewiseModel:
    """PCCS-style explicit piecewise-linear slowdown surface.

    ``own_knots``/``ext_knots`` are strictly increasing axis grids and
    ``table[i][j]`` is the measured/calibrated slowdown at
    (own_knots[i], ext_knots[j]).  Bilinear interpolation inside the grid,
    clamped extension outside.
    """

    own_knots: tuple[float, ...]
    ext_knots: tuple[float, ...]
    table: tuple[tuple[float, ...], ...]

    def __post_init__(self):
        if len(self.table) != len(self.own_knots):
            raise ValueError("table rows must match own_knots")
        for row in self.table:
            if len(row) != len(self.ext_knots):
                raise ValueError("table cols must match ext_knots")
        for row in self.table:
            for v in row:
                if v < 1.0:
                    raise ValueError("slowdowns must be >= 1")

    @staticmethod
    def _locate(knots: Sequence[float], x: float) -> tuple[int, int, float]:
        if x <= knots[0]:
            return 0, 0, 0.0
        if x >= knots[-1]:
            return len(knots) - 1, len(knots) - 1, 0.0
        hi = bisect.bisect_right(knots, x)
        lo = hi - 1
        w = (x - knots[lo]) / (knots[hi] - knots[lo])
        return lo, hi, w

    def slowdown(self, own: float, external: float) -> float:
        if own <= 0.0 or external <= 0.0:
            return 1.0
        i0, i1, wi = self._locate(self.own_knots, own)
        j0, j1, wj = self._locate(self.ext_knots, external)
        t = self.table
        v0 = t[i0][j0] * (1 - wj) + t[i0][j1] * wj
        v1 = t[i1][j0] * (1 - wj) + t[i1][j1] * wj
        return v0 * (1 - wi) + v1 * wi


def estimate_blackbox_demand(gpu_demand: float, emc_util_gpu: float,
                             emc_util_dsa: float) -> float:
    """§3.3 four-step black-box DSA throughput estimation.

    DLAs (and other black-box DSAs) cannot be profiled with vendor counters.
    The paper observes EMC-utilization curves of GPU and DSA are proportional
    per layer, so a layer's DSA-side requested throughput is estimated by
    scaling its GPU-side throughput by the EMC utilization ratio.
    """
    if emc_util_gpu <= 0:
        raise ValueError("GPU EMC utilization must be positive")
    return gpu_demand * (emc_util_dsa / emc_util_gpu)


def pccs_from_pairs(pairs: Sequence[tuple[float, float, float]],
                    own_knots: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9),
                    ext_knots: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9),
                    ) -> PiecewiseModel:
    """Fit a :class:`PiecewiseModel` from (own, external, slowdown) samples.

    Nearest-sample fill per knot with inverse-distance weighting — adequate
    for the small calibration sets the paper uses (the model class matters,
    not the fitting algorithm).
    """
    table = []
    for ok in own_knots:
        row = []
        for ek in ext_knots:
            num = den = 0.0
            for own, ext, sd in pairs:
                d2 = (own - ok) ** 2 + (ext - ek) ** 2
                w = 1.0 / (d2 + 1e-6)
                num += w * sd
                den += w
            row.append(max(1.0, num / den))
        table.append(tuple(row))
    return PiecewiseModel(tuple(own_knots), tuple(ext_knots), tuple(table))
