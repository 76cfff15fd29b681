"""Measured characterization & PCCS calibration (§4.1–4.2 as a pipeline).

Closes the characterize → calibrate → schedule loop the paper treats as
offline one-time work:

* :mod:`~repro_torch.profiling.harness` — timed-execution harness
  (warmup / repetition / a synchronize of the current CUDA stream / MAD
  outlier rejection) over kernel workloads built from the port's model
  configs, or over any executor exposing ``run_group``/``read_demand``.
* :mod:`~repro_torch.profiling.probes` — controllable memory-traffic
  antagonist (the hand-written CUDA streaming kernel on its own stream,
  duty-cycled demand levels).
* :mod:`~repro_torch.profiling.calibrate` — PyTorch least-squares fits of
  :class:`~repro_torch.core.contention.PiecewiseModel` (monotone PCCS surface)
  and :class:`~repro_torch.core.contention.ProportionalShareModel` from co-run
  samples, with residual reports.
* :mod:`~repro_torch.profiling.bundle` — the content-hashed
  :class:`ProfileBundle` artifact + ``scheduler_from_bundle``.
* :mod:`~repro_torch.profiling.virtual` — the deterministic virtual SoC that
  makes the whole loop runnable and differentially testable in CI.

One-call form (the CLI ``repro_torch.launch.profile`` uses it)::

    from repro_torch.core.accelerators import xavier_agx
    from repro_torch.core.profiles import get_graph
    from repro_torch import profiling

    plat = xavier_agx()
    vsoc = profiling.VirtualSoC(
        plat, [get_graph(d, plat) for d in ("vgg19", "resnet152")])
    bundle = profiling.run_pipeline(vsoc)
    sched = profiling.scheduler_from_bundle(bundle)
    plan = sched.solve(list(bundle.graphs))
"""
from __future__ import annotations

from typing import Sequence

from .bundle import (FORMAT, ProfileBundle, platform_from_bundle,
                     scheduler_from_bundle, verify_lineage)
from .calibrate import (CalibrationResult, FitReport, fit, fit_piecewise,
                        fit_proportional, proportional_predict)
from .online import (RecalibrationEvent, SampleWindow,
                     StreamingRecalibrator)
from .harness import (Executor, MeasuredGroup, Measurement, Sample,
                      TimerConfig, corun_sweep, graph_from_measurements,
                      measure_arch, measure_samples, measure_wallclock,
                      profile_graphs, reject_outliers)
from .probes import MemoryProbe, measure_peak_bandwidth, stream_once
from .virtual import VirtualSoC, paper_like_pccs

__all__ = [
    "FORMAT", "ProfileBundle", "platform_from_bundle",
    "scheduler_from_bundle", "verify_lineage",
    "CalibrationResult", "FitReport", "fit", "fit_piecewise",
    "fit_proportional", "proportional_predict",
    "RecalibrationEvent", "SampleWindow", "StreamingRecalibrator",
    "Executor", "MeasuredGroup", "Measurement", "Sample", "TimerConfig",
    "corun_sweep", "graph_from_measurements", "measure_arch",
    "measure_samples", "measure_wallclock", "profile_graphs",
    "reject_outliers",
    "MemoryProbe", "measure_peak_bandwidth", "stream_once",
    "VirtualSoC", "paper_like_pccs",
    "run_pipeline",
]


def run_pipeline(executor: Executor, *,
                 timer: TimerConfig = TimerConfig(),
                 ext_levels: Sequence[float] = (0.15, 0.3, 0.45, 0.6,
                                                0.75, 0.9, 1.05),
                 fit_kind: str = "piecewise",
                 **fit_kwargs) -> ProfileBundle:
    """profile → calibrate → bundle, in one call.

    Measures standalone profiles of every graph on ``executor``, co-runs
    them against the antagonist demand sweep, fits a contention model of
    ``fit_kind`` to the samples and packs everything (with provenance and
    residuals) into a :class:`ProfileBundle`.  ``fit_kwargs`` go to
    :func:`~repro_torch.profiling.calibrate.fit`; its ``device`` is
    ``cuda`` unless the caller passes ``device="cpu"``.
    """
    measured = profile_graphs(executor, timer=timer)
    samples = corun_sweep(executor, measured, ext_levels=ext_levels,
                          timer=timer)
    result = fit(samples, fit_kind, **fit_kwargs)
    provenance = {
        "timer": timer.to_dict(),
        "ext_levels": [float(x) for x in ext_levels],
        "fit_kind": fit_kind,
        "fit": result.report.to_dict(),
    }
    if hasattr(executor, "describe"):
        provenance.update(executor.describe())
    return ProfileBundle(
        platform=executor.platform,
        graphs=measured,
        model=result.model,
        samples=tuple(samples),
        provenance=provenance,
    )
