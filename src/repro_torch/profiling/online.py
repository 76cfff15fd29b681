"""Closed-loop online recalibration: streaming PCCS re-fit from telemetry.

Offline calibration fits a :class:`ProfileBundle` once, and a drifting
platform (thermal throttling, co-runner churn, DVFS
policy changes) leaves every later re-solve pricing contention against a
stale surface.  MoCA-style adaptive execution (PAPERS.md) closes the loop:
the observed ``(own, external) → slowdown`` samples the runtime already
sees — the §4.4 ``SlowdownMonitor`` telemetry the fleet loop records per
completion — stream into an incremental re-fit, and
each re-fit publishes a new *versioned* bundle whose ``parent_hash`` chains
back to the offline ancestor.

* :class:`SampleWindow` — a bounded FIFO of recent telemetry samples
  (non-finite and sub-1 slowdowns are rejected at the door, so one torn
  counter read cannot poison a re-fit the way it used to poison the
  monitor).
* :class:`StreamingRecalibrator` — owns the live model: seeded from an
  offline bundle, it folds samples into the window and, once enough *new*
  evidence accumulated, re-fits.  Piecewise surfaces re-fit through
  :func:`~repro_torch.profiling.calibrate.fit_piecewise`'s warm-start mode —
  knots and initial table come from the previous surface, so each re-fit
  is a cheap Adam polish, not a cold ``lstsq`` — and every publish is a
  :meth:`ProfileBundle.derive` child carrying lineage.

The reference's fleet gateway (``repro/serve/fleet/loop.py``; the port's
is ROADMAP.md queue 1 item 5) drives this as its second control axis:
re-solve under the re-fitted model first, duty-cycle the violating tenant
when re-solving alone cannot meet the SLO.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Sequence

from ..core.contention import PiecewiseModel
from ..obs import get_registry, get_tracer
from .bundle import ProfileBundle
from .calibrate import CalibrationResult, fit_piecewise, fit_proportional
from .harness import Sample


class SampleWindow:
    """Bounded FIFO of (own, ext, slowdown) telemetry samples.

    ``observe`` rejects non-finite values and clips slowdowns to >= 1 —
    telemetry is live wall-clock data, and the §4.4 monitor-poisoning bug
    showed what one NaN does to a stateful consumer.  ``new_since_fit``
    counts evidence accumulated since the last :meth:`mark_fitted`, the
    quantity re-fit scheduling keys on.
    """

    def __init__(self, maxlen: int = 512,
                 seed_samples: Sequence[Sample] = ()):
        if maxlen < 8:
            raise ValueError("window maxlen must be >= 8")
        self._q: deque[Sample] = deque(maxlen=maxlen)
        for s in seed_samples:
            self._q.append(tuple(float(x) for x in s))
        self.new_since_fit = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._q)

    def observe(self, own: float, ext: float, slowdown: float) -> bool:
        """Fold one sample; returns False (and counts) a rejected one."""
        vals = (own, ext, slowdown)
        if not all(math.isfinite(v) for v in vals) or own < 0.0 \
                or ext < 0.0 or slowdown <= 0.0:
            self.rejected += 1
            return False
        self._q.append((float(own), float(ext), max(1.0, float(slowdown))))
        self.new_since_fit += 1
        return True

    def samples(self) -> tuple[Sample, ...]:
        return tuple(self._q)

    def mark_fitted(self) -> None:
        self.new_since_fit = 0


@dataclass
class RecalibrationEvent:
    """One published re-fit (telemetry / benchmark row)."""

    seq: int
    bundle_hash: str
    parent_hash: str
    n_samples: int
    rmse: float
    max_rel_err: float


@dataclass
class StreamingRecalibrator:
    """Incremental PCCS re-fit over a live telemetry window.

    Seeded from an offline :class:`ProfileBundle`; ``observe`` streams
    telemetry in, ``step`` re-fits and publishes once enough new evidence
    accumulated.  The published chain (``.lineage``) is root-first and
    every link is hash-verified by construction: each child is a
    :meth:`ProfileBundle.derive` of the previous head.

    ``fit_kind`` follows the seed bundle's model class by default:
    piecewise surfaces warm-start from the previous table (cheap polish,
    fixed knot geometry); proportional models re-fit their two parameters
    from the window.
    """

    bundle: ProfileBundle
    window: int = 512
    #: below this many window samples a re-fit is never attempted.
    min_samples: int = 24
    #: new samples since the last fit required before re-fitting again.
    min_new: int = 16
    #: Adam polish steps per streaming re-fit (the reference's budget:
    #: each step is a few dozen small eager ops on a 5x5 table); the warm
    #: start is what keeps knot geometry stable, not what shrinks the
    #: budget to nothing.
    refit_steps: int = 800
    lr: float = 0.05
    #: warm-start pull toward the previous table for unobserved knots.
    anchor_weight: float = 1e-4
    #: where re-fits run: ``cuda`` unless the caller asks for the CPU.
    device: str | None = None

    lineage: list[ProfileBundle] = field(init=False)
    events: list[RecalibrationEvent] = field(init=False)
    last_report: CalibrationResult | None = field(init=False, default=None)

    def __post_init__(self):
        # the window holds *live* evidence only: seeding it with the
        # offline bundle's samples would let stale pre-drift measurements
        # outvote fresh telemetry for a whole window length.  The offline
        # surface still informs every re-fit through the warm-start
        # anchor, which is the right weighting: it yields wherever the
        # live window actually has evidence.
        self._window = SampleWindow(self.window)
        self.lineage = [self.bundle]
        self.events = []
        if isinstance(self.bundle.model, PiecewiseModel):
            self._kind = "piecewise"
        else:
            self._kind = "proportional"

    # -- streaming ---------------------------------------------------------
    @property
    def model(self):
        """The live contention model (head of the lineage)."""
        return self.bundle.model

    @property
    def refits(self) -> int:
        return len(self.lineage) - 1

    def observe(self, own: float, ext: float, slowdown: float) -> bool:
        return self._window.observe(own, ext, slowdown)

    def ready(self) -> bool:
        return (len(self._window) >= self.min_samples
                and self._window.new_since_fit >= self.min_new)

    # -- re-fit ------------------------------------------------------------
    def refit(self) -> CalibrationResult:
        """Re-fit the live model from the current window (unconditional)."""
        samples = self._window.samples()
        if not samples:
            raise ValueError("no telemetry samples to re-fit from")
        if self._kind == "piecewise":
            result = fit_piecewise(
                samples, warm_start=self.bundle.model,
                steps=self.refit_steps, lr=self.lr,
                anchor_weight=self.anchor_weight, device=self.device)
        else:
            result = fit_proportional(samples, steps=max(self.refit_steps,
                                                         200),
                                      device=self.device)
        self.last_report = result
        return result

    def publish(self, result: CalibrationResult) -> ProfileBundle:
        """Derive + adopt a child bundle carrying the re-fitted model."""
        parent = self.bundle
        provenance = dict(parent.provenance)
        provenance["refit"] = {
            "seq": self.refits + 1,
            "kind": self._kind,
            "window": len(self._window),
            "rejected": self._window.rejected,
            **result.report.to_dict(),
        }
        child = parent.derive(model=result.model,
                              samples=self._window.samples(),
                              provenance=provenance)
        self.bundle = child
        self.lineage.append(child)
        self.events.append(RecalibrationEvent(
            seq=self.refits, bundle_hash=child.bundle_hash(),
            parent_hash=parent.bundle_hash(),
            n_samples=result.report.n_samples,
            rmse=result.report.rmse,
            max_rel_err=result.report.max_rel_err))
        self._window.mark_fitted()
        return child

    def step(self) -> ProfileBundle | None:
        """Re-fit + publish if enough new evidence accumulated, else None."""
        if not self.ready():
            return None
        parent_hash = self.bundle.bundle_hash()
        with get_tracer().span("recalibrate.refit", "recalibrate",
                               kind=self._kind, window=len(self._window),
                               parent=parent_hash[:12]) as sp:
            child = self.publish(self.refit())
            ev = self.events[-1]
            sp.set(seq=ev.seq, bundle=ev.bundle_hash[:12],
                   rmse=round(ev.rmse, 6),
                   max_rel_err=round(ev.max_rel_err, 6))
        reg = get_registry()
        reg.counter("recalibrations",
                    "streaming re-fit bundles published").inc()
        reg.gauge("recalibrate_max_rel_err",
                  "worst relative fit error of the latest published "
                  "re-fit").set(ev.max_rel_err)
        return child

    # -- audit -------------------------------------------------------------
    def max_rel_err_against(self, truth) -> float:
        """Worst relative error of the live model vs a reference model,
        evaluated at the window's observed (own, ext) points — the
        convergence number the drift benchmark gates on."""
        worst = 0.0
        for own, ext, _ in self._window.samples():
            want = truth.slowdown(own, ext)
            got = self.model.slowdown(own, ext)
            if want > 0:
                worst = max(worst, abs(got - want) / want)
        return worst

    def summary(self) -> str:
        head = self.bundle
        rows = [f"recalibrator kind={self._kind} window={len(self._window)}"
                f"/{self.window} refits={self.refits} "
                f"rejected={self._window.rejected}",
                f"  head {head.bundle_hash()[:12]} parent "
                f"{(head.parent_hash or 'offline-root')[:12]}"]
        if self.last_report is not None:
            rows.append("  last " + self.last_report.summary())
        return "\n".join(rows)
