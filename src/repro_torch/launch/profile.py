"""Profiling launcher of the port: ``python -m repro_torch.launch.profile``.

Runs the measured characterize → calibrate → bundle pipeline
(:mod:`repro_torch.profiling`) and writes a content-hashed
``ProfileBundle`` artifact that :class:`~repro_torch.core.scheduler.
Scheduler` can solve from directly (``Scheduler.from_bundle``).

Two executors:

* ``--executor virtual`` (default, CI-safe): the deterministic virtual
  SoC — ground-truth paper profiles + a generating contention model with
  seeded measurement noise.  With ``--solve`` the bundle is solved and
  compared against the plan under the generating model, closing the loop.

      python -m repro_torch.launch.profile --platform xavier-agx \\
          --dnns vgg19 resnet101 --out artifacts/profiles/xavier.json \\
          --solve --device cpu

* ``--executor torch``: real measurement on the card — layer groups built
  from a registered model config, at its published widths unless
  ``--reduced``, run under the harness timing discipline through the
  port's kernels, and the contention model is calibrated from genuine
  co-runs of the hand-written CUDA streaming antagonist
  (:mod:`repro_torch.profiling.probes`) against itself at swept duty
  cycles.

      python -m repro_torch.launch.profile --executor torch \\
          --arch stablelm-1.6b --seq 256 --batch 2 --solve --solver anneal

Everything runs on ``cuda`` unless ``--device cpu`` is given (then the
kernels' plain PyTorch versions run).
"""
from __future__ import annotations

import argparse
import time

from repro_torch import configs
from repro_torch.core.accelerators import PLATFORMS

#: largest relative fit error accepted without a warning: the reference's
#: calibration acceptance gate (tests/test_profiling.py:149-170)
FIT_GATE = 0.05
#: seconds the card's antagonist runs alone at full duty, for its rate
FULL_DUTY_S = 0.05


def _parse_levels(text: str) -> list[float]:
    try:
        levels = [float(x) for x in text.split(",") if x.strip()]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--ext-levels must be comma-separated floats, got {text!r}")
    if not levels or any(x <= 0 for x in levels):
        raise argparse.ArgumentTypeError("--ext-levels must be positive")
    return levels


def _virtual_bundle(args, timer):
    from repro_torch import profiling
    from repro_torch.core.contention import ProportionalShareModel
    from repro_torch.core.profiles import get_graph

    platform = PLATFORMS[args.platform]()
    graphs = [get_graph(d, platform) for d in args.dnns]
    true_model = (ProportionalShareModel(capacity=1.0, sensitivity=3.0)
                  if args.true_model == "proportional"
                  else profiling.paper_like_pccs())
    vsoc = profiling.VirtualSoC(
        platform, graphs, true_model, noise=args.noise,
        outlier_rate=args.outlier_rate, seed=args.seed)
    bundle = profiling.run_pipeline(
        vsoc, timer=timer, ext_levels=args.ext_levels, fit_kind=args.fit,
        device=args.device)
    return bundle, vsoc


def _torch_bundle(args, timer):
    from repro_torch import profiling
    from repro_torch.configs.base import ShapeCell
    from repro_torch.profiling import probes
    from repro_torch.runtime import resolve_device

    usable_levels = [e for e in args.ext_levels if e <= 1.0]
    if not usable_levels:
        raise SystemExit(
            f"--executor torch sweeps the antagonist by duty cycle, so "
            f"every --ext-levels entry must be <= 1.0 (got "
            f"{args.ext_levels})")
    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cell = ShapeCell(f"{args.kind}_{args.seq}", args.seq, args.batch,
                     args.kind)
    platform = PLATFORMS[args.platform]()
    print(f"measuring {cfg.name} layer groups on {device} ...")
    measured = profiling.measure_arch(cfg, cell, backend=args.backend,
                                      timer=timer,
                                      max_groups=args.max_groups,
                                      device=device)
    for mg in measured:
        m = mg.measurement
        print(f"  {m.name}: {m.median_ms:.3f} ms "
              f"(n={len(m.kept_ms)}/{m.n_total}, std={m.std_ms:.3f})")
    graph = profiling.graph_from_measurements(
        f"{args.arch}:{cell.name}", platform, measured)

    # pass sizes by device: on the card past its L2, on the CPU the
    # reference's (probes.probe_sizes)
    sizes = probes.probe_sizes(device)
    print(f"calibrating from streaming-antagonist co-runs ({sizes}) ...")
    peak = probes.measure_peak_bandwidth(mbytes=sizes.peak_mb,
                                         backend=args.backend, timer=timer,
                                         device=device)
    probe_info = sizes.to_dict()
    if device.type == "cuda" and args.backend in ("auto", "cuda"):
        # the card's capped antagonist alone at full duty, for its rate
        full = probes.MemoryProbe(demand=1.0, backend=args.backend,
                                  device=device)
        with full:
            time.sleep(FULL_DUTY_S)
        probe_info.update(blocks=full.blocks,
                          full_duty_bytes_per_s=full.achieved_bytes_per_s())
        print(f"  antagonist on {full.blocks} SMs at full duty: "
              f"{full.achieved_bytes_per_s() / 1e9:.2f} GB/s")
        del full
    # each level's slowdown: a co-run pass over the standalone pass timed
    # just before it
    base_ms, corun = probes.stream_slowdowns(
        usable_levels, sizes=sizes, backend=args.backend, timer=timer,
        device=device)
    own = min(1.0, (probes.pass_bytes(sizes.target_mb)
                    / (base_ms * 1e-3)) / peak)
    samples = [(own, c["ext"], c["slowdown"]) for c in corun]
    for c in corun:
        print(f"  ext={c['ext']:g}: co-run {c['co_ms']:.4f} ms over "
              f"{c['base_ms']:.4f} ms standalone, slowdown "
              f"{c['slowdown']:.4f}; antagonist "
              f"{c['probe_passes']:g} passes, "
              f"{c['probe_bytes_per_s'] / 1e9:.2f} GB/s")
    result = profiling.fit(samples, args.fit, device=device)
    print(f"  peak={peak / 1e9:.2f} GB/s  {result.summary()}")
    warning = None
    if result.report.max_rel_err > FIT_GATE:
        warning = (f"the fitted surface misses its samples by up to "
                   f"{result.report.max_rel_err:.0%} (gate {FIT_GATE:.0%}); "
                   f"plans solved from this bundle price contention loosely")
        print(f"WARNING: {warning}")
    bundle = profiling.ProfileBundle(
        platform=platform, graphs=(graph,), model=result.model,
        samples=tuple(samples),
        provenance={"executor": "torch-harness", "arch": args.arch,
                    "config": cfg.name, "cell": cell.name,
                    "backend": args.backend, "timer": timer.to_dict(),
                    "groups": [{"name": mg.costs.name,
                                "median_ms": mg.measurement.median_ms,
                                "n_kept": len(mg.measurement.kept_ms),
                                "n_total": mg.measurement.n_total,
                                "std_ms": mg.measurement.std_ms}
                               for mg in measured],
                    "peak_stream_bytes_per_s": peak,
                    "stream_base_ms": base_ms,
                    "probe": probe_info,
                    "corun": corun,
                    "fit_kind": args.fit,
                    "fit": result.report.to_dict(),
                    "fit_warning": warning,
                    **profiling.harness.local_device_provenance(device)})
    return bundle, None


def _measure_search_throughput(args, bundle):
    """Record the measured anneal-search candidates/s in the bundle
    provenance, so later ``budget_ms`` solves from the artifact skip the
    live probe.  Skipped quietly when the bundle's contention model has no
    lowerable surface (the search itself would refuse too).
    """
    import dataclasses

    from repro_torch.core import solver_anneal
    try:
        cps = solver_anneal.measure_search_throughput(
            bundle.platform, list(bundle.graphs), bundle.model,
            max_transitions=args.max_transitions, devices=args.devices,
            device=args.device)
    except (ValueError, RuntimeError) as exc:
        print(f"(search-throughput probe skipped: {exc})")
        return bundle
    print(f"measured anneal-search throughput: {cps:,.0f} candidates/s "
          f"on {args.device}")
    prov = {**bundle.provenance, "search_cands_per_s": float(cps)}
    if args.devices:
        prov["search_devices"] = int(args.devices)
    return dataclasses.replace(bundle, provenance=prov)


def _anneal_knobs(args, bundle) -> dict:
    knobs = {}
    if args.solver != "anneal":
        return knobs
    if args.devices:
        knobs["devices"] = args.devices
    if args.search_budget_ms:
        knobs["budget_ms"] = args.search_budget_ms
        cps = bundle.provenance.get("search_cands_per_s")
        if cps:
            knobs["cands_per_s"] = float(cps)
    return knobs


def _solve_from_bundle(args, bundle, vsoc) -> int:
    from repro_torch.core import Scheduler

    sched = Scheduler.from_bundle(bundle, device=args.device)
    if bundle.provenance.get("fit_warning"):
        print(f"WARNING: solving from bundle {bundle.bundle_hash()[:12]}: "
              f"{bundle.provenance['fit_warning']}")
    if len(bundle.platform.names) < 2:
        print("(platform has one accelerator: nothing to co-schedule)")
        return 0
    knobs = _anneal_knobs(args, bundle)
    plan = sched.solve(list(bundle.graphs), args.objective,
                       solver=args.solver,
                       max_transitions=args.max_transitions,
                       deadline_s=20.0, solver_knobs=knobs)
    print("solved from measured bundle:")
    print(plan.summary())
    if args.trace_out:
        from repro_torch.obs import timeline
        print(timeline.plan_ascii(plan))
        path = timeline.write_chrome(timeline.plan_chrome(plan),
                                     args.trace_out)
        print(f"timeline: schedule gantt -> {path} "
              f"(open at https://ui.perfetto.dev)")
    if vsoc is not None:
        truth_model = next(iter(vsoc.models.values()))
        truth = Scheduler(vsoc.platform, model=truth_model,
                          device=args.device).solve(
            list(vsoc.graphs.values()), args.objective, solver=args.solver,
            max_transitions=args.max_transitions, deadline_s=20.0,
            solver_knobs=knobs)
        rel = (abs(plan.objective - truth.objective)
               / max(abs(truth.objective), 1e-12))
        print(f"generating-model objective={truth.objective:.4f}  "
              f"measured-bundle objective={plan.objective:.4f}  "
              f"rel-diff={rel:.2%}")
        if rel > args.solve_tolerance:
            print(f"ERROR: objective deviates more than "
                  f"{args.solve_tolerance:.0%} from the generating model")
            return 1
    return 0


def main(argv=None) -> int:
    from repro_torch.profiling import ProfileBundle, TimerConfig

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--executor", choices=("virtual", "torch"),
                    default="virtual")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where measurements, the torch fit and the "
                         "search run")
    ap.add_argument("--platform", default="xavier-agx",
                    choices=sorted(PLATFORMS))
    ap.add_argument("--dnns", nargs="+", default=["vgg19", "resnet101"],
                    help="paper-profile DNNs to characterize (virtual)")
    ap.add_argument("--true-model", default="piecewise",
                    choices=("piecewise", "proportional"),
                    help="generating contention model of the virtual SoC")
    ap.add_argument("--noise", type=float, default=0.003,
                    help="relative timing-noise sigma of the virtual SoC")
    ap.add_argument("--outlier-rate", type=float, default=0.05,
                    help="probability of a preemption-style timing outlier")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=configs.ARCHS,
                    help="model config measured by --executor torch")
    ap.add_argument("--reduced", action="store_true",
                    help="measure the architecture's reduced (smoke) "
                         "config instead of its published widths")
    ap.add_argument("--kind", default="prefill",
                    choices=("prefill", "decode"))
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "cuda", "torch"),
                    help="kernel backend: the hand-written kernel (cuda), "
                         "its plain version (torch), or by device (auto)")
    ap.add_argument("--max-groups", type=int, default=None,
                    help="cap measured groups (torch executor)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--ext-levels", type=_parse_levels,
                    default=[0.15, 0.3, 0.45, 0.6, 0.75, 0.9, 1.05],
                    metavar="F,F,...",
                    help="antagonist demand sweep (fractions of capacity)")
    ap.add_argument("--fit", default=None,
                    choices=("piecewise", "proportional"),
                    help="model class to calibrate (default: piecewise for "
                         "virtual, proportional for torch)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="bundle path (default artifacts/profiles/"
                         "<platform-or-arch>.json)")
    ap.add_argument("--solve", action="store_true",
                    help="solve a schedule from the bundle; with the "
                         "virtual executor also compare against the "
                         "generating-model plan")
    ap.add_argument("--objective", default="latency")
    ap.add_argument("--solver", default="auto")
    ap.add_argument("--max-transitions", type=int, default=2)
    ap.add_argument("--solve-tolerance", type=float, default=0.05,
                    help="max generating-vs-measured objective deviation")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="run --solver anneal solves on N ranks with the "
                         "ring across them (the ranks may share the "
                         "devices there are)")
    ap.add_argument("--search-budget-ms", type=float, default=None,
                    metavar="MS",
                    help="wall-clock budget per anneal solve: population/"
                         "steps auto-tune from the bundle-measured search "
                         "throughput (recorded in provenance as "
                         "search_cands_per_s); requires --solver anneal")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="with --solve: write the solved schedule as a "
                         "per-accelerator Gantt in Chrome-trace/Perfetto "
                         "JSON (contention intervals and transitions "
                         "annotated) and print its ASCII rendering; open "
                         "at https://ui.perfetto.dev")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a JSON snapshot of the metrics registry "
                         "(solver counters, ...) to PATH")
    ap.add_argument("--log-level", default="info",
                    choices=("debug", "info", "warning", "error"))
    ap.add_argument("--log-json", action="store_true",
                    help="emit one JSON object per log line instead of "
                         "plain text")
    args = ap.parse_args(argv)

    from repro_torch.obs import configure_logging
    configure_logging(args.log_level, json=args.log_json)
    if args.trace_out and not args.solve:
        ap.error("--trace-out renders the solved schedule; it requires "
                 "--solve")
    if (args.devices or args.search_budget_ms) and args.solver != "anneal":
        ap.error("--devices/--search-budget-ms tune the device-resident "
                 "search; they require --solver anneal")
    if args.devices is not None:
        if args.devices < 1:
            ap.error(f"--devices {args.devices}: must be >= 1; nearest "
                     f"legal value: devices=1")
        # the reference's xla_env.apply(devices=N): N ranks may share
        from repro_torch.ranks import share_devices
        share_devices(args.devices)

    if args.fit is None:
        args.fit = "piecewise" if args.executor == "virtual" \
            else "proportional"
    timer = TimerConfig(warmup=args.warmup, repeats=args.repeats)
    if args.executor == "virtual":
        bundle, vsoc = _virtual_bundle(args, timer)
        default_out = f"artifacts/profiles/{args.platform}.json"
    else:
        bundle, vsoc = _torch_bundle(args, timer)
        default_out = f"artifacts/profiles/{args.arch}.json"

    if args.solver == "anneal" and len(bundle.platform.names) >= 2:
        bundle = _measure_search_throughput(args, bundle)

    path = bundle.save(args.out or default_out)
    # reload immediately: the tamper check re-verifies the content hash,
    # so a bundle that cannot round-trip never ships.
    reloaded = ProfileBundle.load(path)
    if reloaded.bundle_hash() != bundle.bundle_hash():
        raise RuntimeError(f"bundle {path} did not round-trip")
    print(bundle.summary())
    print(f"bundle {bundle.bundle_hash()[:12]} saved to {path} "
          f"(round-trip verified)")

    rc = 0
    if args.solve:
        rc = _solve_from_bundle(args, bundle, vsoc)
    if args.metrics_out:
        from repro_torch.obs import get_registry
        get_registry().write(args.metrics_out)
        print(f"metrics: registry snapshot -> {args.metrics_out}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
