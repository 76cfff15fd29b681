"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

The reference's modes (``repro.launch.serve``).  Single-model
continuous-batching service (random weights from a seeded generator,
prompts of 8 random tokens, greedy decoding)::

    python -m repro_torch.launch.serve --arch stablelm-1.6b --requests 4
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --reduced \
        --device cpu

``--co-arch`` alone plans HaX-CoNN co-serving of both full configs at
``--shape`` on the production pod split; ``--gateway`` also *serves* both
models concurrently through the contention-aware multi-tenant gateway
(phase-aware schedule, shared KV budget, §4.4 re-scheduling on the
engines' observed decode-step times)::

    python -m repro_torch.launch.serve --gateway --arch stablelm-1.6b \
        --co-arch llama3.2-3b [--budget-slots 3]
    # pre-solve and persist the plan, then boot from it with zero solves
    python -m repro_torch.launch.serve --gateway --arch A --co-arch B \
        --save-plan gw.json --plan-only
    python -m repro_torch.launch.serve --gateway --arch A --co-arch B \
        --plan gw.json

``--fleet`` replays a seeded arrival trace through the virtual-time fleet
gateway over a pool of solved plans; ``--solver anneal`` solves that pool
on the card through the slowdown and select kernels (as in the reference,
the pool's schedulers take the default evaluator: ``--evaluator`` reaches
the gateway's fresh solves only)::

    python -m repro_torch.launch.serve --fleet --arch stablelm-1.6b \
        --co-arch llama3.2-3b --slo p99=400 --cache-root plancache \
        --trace "bursty:base=150,burst=1200,n=10000,tenants=100,seed=7" \
        --solver anneal --evaluator torch
    # a second boot from the sharded cache makes zero solves
    python -m repro_torch.launch.serve --fleet ... --cache-root plancache \
        --expect-cached

Every architecture is served in every mode: attention (``attn``,
``local``) and recurrent (``rglru``, ``rwkv``) layer stacks, with an MLP
or a mixture of experts (dbrx-132b, qwen3-moe-235b-a22b) as the channel
mix.  Everything runs on ``cuda`` unless ``--device cpu`` asks otherwise
(the plan searches, the fits and the models).  ``--reduced`` serves the
architectures' reduced (smoke) configs; the gateway then still plans the
full ones, as the reference's launcher does, so the plan is the same
either way.  ``--trace-out`` writes the run's Perfetto trace (solver
spans, plan-cache hits, fleet spans, reschedule instants) and
``--metrics-out`` a snapshot of the metrics registry, both also when the
run fails; ``--log-level`` and ``--log-json`` shape the log lines::

    python -m repro_torch.launch.serve --gateway --arch stablelm-1.6b \
        --co-arch dbrx-132b --reduced --trace-out gw.trace.json \
        --metrics-out gw.metrics.json --log-json

``--devices N`` (with ``--solver anneal``) runs every fresh anneal solve
on N ranks with the ring across them; as the reference's
``xla_env.apply(devices=N)`` lets N emulated devices share a host,
``repro_torch.ranks.share_devices(N)`` lets the N ranks share the
devices there are (N ranks on ``cuda:0``, or N CPU processes).  The
N - 1 helper ranks start at the first solve and serve every later one::

    python -m repro_torch.launch.serve --gateway --arch stablelm-1.6b \
        --co-arch llama3.2-3b --solver anneal --devices 2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import build
from repro_torch.serve.engine import ServingEngine


def _with_obs(args, run) -> int:
    """Run one serving mode under the requested observability outputs.

    ``--trace-out`` installs a process-wide :class:`repro_torch.obs.Tracer`
    before the run (solver spans, cache hits, gateway/fleet instants all
    land on it) and writes the Perfetto JSON afterwards, even when the run
    exits nonzero or raises, so a failed boot still leaves its trace
    behind, and then puts back the tracer it replaced (the reference
    leaves its own installed).  ``--metrics-out`` snapshots the metrics
    registry the same way.
    """
    tracer = None
    if args.trace_out:
        from repro_torch.obs import Tracer, set_tracer
        tracer = Tracer()
        before = set_tracer(tracer)
    try:
        return run(args)
    finally:
        if tracer is not None:
            set_tracer(before)
            tracer.write(args.trace_out)
            print(f"trace: {len(tracer.events())} events -> "
                  f"{args.trace_out} (open at https://ui.perfetto.dev)")
        if args.metrics_out:
            from repro_torch.obs import get_registry
            get_registry().write(args.metrics_out)
            print(f"metrics: registry snapshot -> {args.metrics_out}")


def _solver_knobs(args) -> tuple:
    """--devices/--search-budget-ms as GatewayConfig.solver_knobs pairs."""
    knobs = {}
    if args.devices:
        knobs["devices"] = args.devices
    if args.search_budget_ms:
        knobs["budget_ms"] = args.search_budget_ms
    return tuple(sorted(knobs.items()))


def _run_gateway(args) -> int:
    from repro_torch.core.accelerators import tpu_pod_split
    from repro_torch.core.plan import Plan
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.serve.gateway import (GatewayConfig, MultiTenantGateway,
                                           TenantSpec, plan_gateway)
    specs = []
    for a in (args.arch, args.co_arch):
        cfg = configs.get(a)
        specs.append(TenantSpec(a, cfg.reduced() if args.reduced else cfg,
                                plan_cfg=cfg, max_slots=4, capacity=96,
                                max_new=args.max_new))
    budget = (args.budget_slots * max(s.kv_bytes_per_slot for s in specs)
              if args.budget_slots else None)
    platform = tpu_pod_split(4, 12, name="v5e-4x12-split")
    model = None
    if args.profile_bundle:
        from repro_torch.profiling import ProfileBundle
        bundle = ProfileBundle.load(args.profile_bundle)
        if len(bundle.platform.names) < 2:
            print(f"ERROR: profile bundle {args.profile_bundle} measured a "
                  f"single-accelerator platform; nothing to co-schedule")
            return 1
        platform, model = bundle.platform, bundle.model
        print(f"profile bundle {bundle.bundle_hash()[:12]}: planning on "
              f"measured platform {platform.name} with calibrated "
              f"{type(model).__name__}")
    gcfg = GatewayConfig(platform=platform, model=model,
                         memory_budget_bytes=budget, solver=args.solver,
                         solver_knobs=_solver_knobs(args))
    scheduler = Scheduler(gcfg.platform, gcfg.model,
                          evaluator=args.evaluator, device=args.device)
    if args.plan:
        loaded = Plan.load(args.plan)
        scheduler.cache.add(loaded)
        print(f"loaded plan {loaded.request_hash[:12]} "
              f"(solver={loaded.solver}, "
              f"solved offline in {loaded.solve_time_s:.3f}s)")

    if args.plan_only:
        plan = plan_gateway(specs, gcfg, scheduler=scheduler)
    else:
        gw = MultiTenantGateway(specs, gcfg, scheduler=scheduler)
        plan = gw.plan

    if args.plan:
        if scheduler.solves:
            print("ERROR: plan artifact did not cover the request — "
                  f"{scheduler.solves} fresh solver invocation(s)")
            return 1
        print(f"plan cache hit: booted from {args.plan} with zero solver "
              f"invocations")
    if args.save_plan:
        path = plan.plan.save(args.save_plan)
        print(f"plan {plan.plan.request_hash[:12]} "
              f"(solver={plan.plan.solver}) saved to {path}")
    print(plan.summary())
    if args.plan_only:
        return 0

    rng = np.random.default_rng(0)
    for name, s in gw.specs.items():
        for _ in range(args.requests):
            gw.submit(name, rng.integers(0, s.cfg.vocab, size=8))
    done = gw.run_until_drained()
    for name, reqs in done.items():
        print(f"{name}: served {len(reqs)} requests, "
              f"{sum(len(r.tokens) for r in reqs)} tokens (mean decode "
              f"step {gw.engines[name].counters.mean_step_ms:.3f} ms)")
    print(f"gateway steps={gw.total_steps} "
          f"deferred={gw.deferred_admissions} "
          f"reschedules={len(gw.reschedules)} on {scheduler.device}")
    return 0


def _run_fleet(args) -> int:
    from repro_torch.core.accelerators import tpu_pod_split
    from repro_torch.core.plan import ShardedPlanCache
    from repro_torch.serve.fleet import (FleetConfig, FleetGateway,
                                         build_pool, parse_slo,
                                         parse_trace_spec)
    from repro_torch.serve.gateway import GatewayConfig, TenantSpec

    trace = parse_trace_spec(args.trace)
    print(f"trace: kind={trace.kind} n={len(trace)} "
          f"tenants={trace.n_tenants} rate={trace.mean_rate_rps:.1f} req/s "
          f"burstiness={trace.burstiness():.2f} hash={trace.trace_hash()[:12]}")

    bundle = model = None
    if args.profile_bundle:
        from repro_torch.profiling import ProfileBundle
        bundle = ProfileBundle.load(args.profile_bundle)
        model = bundle.model
        print(f"profile bundle {bundle.bundle_hash()[:12]}: pool plans "
              f"priced under calibrated {type(model).__name__}")

    # full-size configs: the fleet loop bills service from the solved
    # schedule's predictions and never builds the models, so planning the
    # production shapes costs nothing extra.
    specs = [TenantSpec(a, configs.get(a), max_slots=4, capacity=256,
                        prompt_len=64, max_new=args.max_new)
             for a in (args.arch, args.co_arch)]
    cache = ShardedPlanCache(args.cache_root) if args.cache_root else None
    splits = [(4, 12), (8, 8), (12, 4)]
    plats = [tpu_pod_split(a, b, name=f"v5e-{a}x{b}-split")
             for a, b in splits]
    budget = (args.budget_slots * max(s.kv_bytes_per_slot for s in specs)
              if args.budget_slots else None)
    pool = build_pool(specs, plats,
                      GatewayConfig(solver=args.solver, model=model,
                                    solver_knobs=_solver_knobs(args)),
                      cache, slots=8, device=args.device)
    solves = sum(pp.scheduler.solves for pp in pool)
    print(f"pool: {len(pool)} plans, {solves} solver invocation(s)")
    if args.expect_cached and solves:
        print(f"ERROR: --expect-cached but {solves} fresh solve(s) — the "
              f"sharded cache at {args.cache_root} did not cover the pool")
        return 1

    recal = None
    if args.recalibrate:
        from repro_torch.profiling import StreamingRecalibrator
        recal = StreamingRecalibrator(
            bundle, window=args.recalibrate_window,
            min_new=args.recalibrate_min_new, device=args.device)
        print(f"closed-loop recalibration on: window="
              f"{args.recalibrate_window} min_new={args.recalibrate_min_new}")
    cfg = FleetConfig(policy=args.policy, default_slo=parse_slo(args.slo),
                      memory_budget_bytes=budget, throttle=args.throttle,
                      throttle_duty=args.throttle_duty)
    gw = FleetGateway(pool, n_tenants=trace.n_tenants, cfg=cfg,
                      capacity_hint=len(trace), recalibrator=recal)
    rep = gw.replay(trace)
    print(rep.summary())
    exported = gw.export_trace()
    if exported:
        print(f"trace: {exported} per-request queue/service spans exported")
    if recal is not None:
        head = recal.bundle
        print(f"recalibration: {recal.refits} re-fit(s) published, lineage "
              f"depth {len(recal.lineage)}, head {head.bundle_hash()[:12]} "
              f"(root {recal.lineage[0].bundle_hash()[:12]})")
    return 0


def _run_concurrent(args) -> int:
    from repro_torch.serve.concurrent import plan_concurrent_serving
    plan = plan_concurrent_serving(
        [configs.get(args.arch), configs.get(args.co_arch)],
        [args.shape, args.shape], objective="latency", deadline_s=20.0,
        device=args.device)
    print(plan.summary())
    return 0


def _run_single(args) -> int:
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.has_decode:
        print(f"{args.arch} is encoder-only: no decode service")
        return 1
    model = build(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    eng = ServingEngine(model, max_slots=4, capacity=128)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab, size=8), max_new=args.max_new)
    done = eng.run_until_drained()
    m = eng.metrics()
    print(f"served {len(done)} requests, "
          f"{sum(len(r.tokens) for r in done)} tokens, "
          f"{eng.steps} decode steps on {model.device} "
          f"(mean decode step {m['mean_step_ms']:.3f} ms)")
    return 0


def _check_registry(ap, args) -> None:
    """Unknown or unavailable --solver/--evaluator names fail listing the
    registered (or available) ones, as the reference's launcher does."""
    from repro_torch.core import registry
    if args.solver != "auto":
        try:
            sentry = registry.get_solver(args.solver)
        except KeyError as exc:       # UnknownEntryError: lists known names
            ap.error(str(exc))
        if not sentry.available():
            avail = [e.name for e in registry.auto_order()]
            ap.error(f"solver {args.solver!r} is registered but its "
                     f"backend is not available here (available: "
                     f"{', '.join(avail) or 'none'})")
    if args.evaluator != "auto":
        try:
            entry = registry.get_evaluator(args.evaluator)
        except KeyError as exc:       # UnknownEntryError: lists known names
            ap.error(str(exc))
        if not entry.available():
            avail = [e for e in registry.evaluator_names()
                     if registry.get_evaluator(e).available()]
            ap.error(f"evaluator {args.evaluator!r} is registered but its "
                     f"backend is not available here (available: "
                     f"{', '.join(avail) or 'none'})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true",
                    help="serve the architectures' reduced (smoke) configs "
                         "(the gateway still plans the full ones)")
    ap.add_argument("--co-arch", default=None, choices=configs.ARCHS,
                    help="plan concurrent serving with a second model")
    ap.add_argument("--gateway", action="store_true",
                    help="serve --arch and --co-arch concurrently through "
                         "the multi-tenant gateway (requires --co-arch)")
    ap.add_argument("--budget-slots", type=int, default=0,
                    help="shared KV budget in slot units (0 = unlimited)")
    ap.add_argument("--shape", default="decode_32k",
                    help="shape cell of the --co-arch plan")
    ap.add_argument("--fleet", action="store_true",
                    help="replay an arrival trace through the virtual-time "
                         "fleet gateway (requires --co-arch and --trace)")
    ap.add_argument("--trace", default=None, metavar="SPEC|PATH",
                    help="arrival trace: a saved trace JSON path or a "
                         "generator spec like "
                         "'poisson:rate=200,n=1000,tenants=100,seed=0', "
                         "'bursty:base=100,burst=1000,n=5000,tenants=200' "
                         "or 'diurnal:peak=300,n=5000,tenants=500'")
    ap.add_argument("--slo", default="p99=1000", metavar="SPEC",
                    help="default tenant SLO, e.g. 'p99=400,rps=5'")
    ap.add_argument("--policy", default="slo",
                    choices=("slo", "round_robin"),
                    help="fleet routing policy (round_robin = baseline)")
    ap.add_argument("--cache-root", default=None, metavar="DIR",
                    help="sharded disk-backed plan cache root shared by "
                         "every pool scheduler; a re-run over the same pool "
                         "boots with zero solver invocations")
    ap.add_argument("--expect-cached", action="store_true",
                    help="fail unless the pool booted entirely from "
                         "--cache-root (zero fresh solves)")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="boot the gateway from a serialized Plan artifact "
                         "(fails if the request is not covered: zero solver "
                         "invocations are asserted)")
    ap.add_argument("--save-plan", default=None, metavar="PATH",
                    help="serialize the solved gateway Plan to PATH")
    ap.add_argument("--plan-only", action="store_true",
                    help="plan (and optionally save) without serving")
    ap.add_argument("--profile-bundle", default=None, metavar="PATH",
                    help="plan from a measured ProfileBundle "
                         "(repro_torch.launch.profile). With --gateway the "
                         "bundle's platform and calibrated contention model "
                         "replace the built-in pod split + default model; "
                         "with --fleet the calibrated model prices every "
                         "pool plan and seeds --recalibrate")
    ap.add_argument("--recalibrate", action="store_true",
                    help="fleet mode: stream completion telemetry into a "
                         "StreamingRecalibrator seeded from "
                         "--profile-bundle; published re-fits are adopted "
                         "by every pool plan at reschedule time")
    ap.add_argument("--recalibrate-window", type=int, default=256,
                    metavar="N", help="telemetry window size (live "
                         "samples) for streaming re-fits")
    ap.add_argument("--recalibrate-min-new", type=int, default=128,
                    metavar="N", help="fresh samples required between "
                         "consecutive re-fits")
    ap.add_argument("--throttle", action="store_true",
                    help="fleet mode: duty-cycle tenants whose SLOs still "
                         "cannot be met after re-solving")
    ap.add_argument("--throttle-duty", type=float, default=0.5,
                    metavar="F", help="fraction of a throttled tenant's "
                         "arrivals admitted (deterministic token bucket)")
    ap.add_argument("--solver", default="auto", metavar="NAME",
                    help="registry solver entry for any fresh gateway "
                         "solve: z3 | bb | greedy | anneal (the search on "
                         "--device) | auto = best available by priority. "
                         "Unknown names fail listing the registered "
                         "solvers.")
    ap.add_argument("--evaluator", default="auto", metavar="NAME",
                    help="candidate-schedule evaluator for any fresh solve: "
                         "batch | torch (the PCCS slowdown kernel on "
                         "--device) | scalar | auto. Unknown names fail "
                         "listing the registered evaluators.")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="run the anneal search on N ranks with the "
                         "ring across them (torch.distributed; the ranks "
                         "may share the devices there are, as the "
                         "reference's emulated host devices do); requires "
                         "--solver anneal")
    ap.add_argument("--search-budget-ms", type=float, default=None,
                    metavar="MS",
                    help="wall-clock budget for each fresh anneal solve "
                         "(population/steps auto-tuned from it); requires "
                         "--solver anneal")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(solver spans, plan-cache hits, fleet "
                         "queue/service spans, reschedule/throttle/"
                         "recalibration instants) to PATH; open at "
                         "https://ui.perfetto.dev")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a JSON snapshot of the metrics registry "
                         "(counters/gauges/histograms) to PATH")
    ap.add_argument("--log-level", default="info",
                    choices=("debug", "info", "warning", "error"))
    ap.add_argument("--log-json", action="store_true",
                    help="emit one JSON object per log line instead of "
                         "plain text")
    args = ap.parse_args(argv)

    from repro_torch.obs import configure_logging
    configure_logging(args.log_level, json=args.log_json)

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
    _check_registry(ap, args)

    if args.fleet:
        if not args.co_arch:
            ap.error("--fleet requires --co-arch")
        if not args.trace:
            ap.error("--fleet requires --trace")
        if args.expect_cached and not args.cache_root:
            ap.error("--expect-cached requires --cache-root")
        if args.recalibrate and not args.profile_bundle:
            ap.error("--recalibrate requires --profile-bundle (the offline "
                     "seed of the lineage chain)")
        return _with_obs(args, _run_fleet)
    for flag in ("trace", "cache_root", "recalibrate", "throttle"):
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} requires --fleet")

    if args.plan or args.save_plan or args.plan_only:
        if not args.gateway:
            ap.error("--plan/--save-plan/--plan-only require --gateway")
    if args.profile_bundle and not args.gateway:
        ap.error("--profile-bundle requires --gateway or --fleet")
    if args.gateway:
        if not args.co_arch:
            ap.error("--gateway requires --co-arch")
        if args.co_arch == args.arch:
            ap.error("--gateway needs two distinct models")
        for a in (args.arch, args.co_arch):
            if not configs.get(a).has_decode:
                ap.error(f"{a} is encoder-only: no decode service")
        return _with_obs(args, _run_gateway)

    if args.co_arch:
        return _with_obs(args, _run_concurrent)

    return _with_obs(args, _run_single)


if __name__ == "__main__":
    raise SystemExit(main())
