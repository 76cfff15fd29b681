"""Run one cell of ``BENCHMARK.json`` once and print its result line::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for (it exits 2 and prints no result without them).  Set-up builds the
cell's system from its files, draws its weights on the device from the
seed, and warms up the shapes the cell's traffic uses; the window then
serves the traffic for ``--seconds``; after it, the program's state is
freed and a sample of what the window served is checked against the
plain reference (``check.py``).  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each compared number beside its limit, which are also the last lines of
standard error).  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, reading the last ``SLICE_S`` seconds
of the window through ``torch.profiler`` (its trace goes to ``TMPDIR``
and is deleted).

The kernels build into ``src/repro_torch/kernels/build/`` inside the
checkout, so only a checkout's first run compiles.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the package by its name (not this folder's modules as top-level names),
# and the program beside it
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np  # noqa: E402

from portbench import check, devtrace, harness, spec, traffic  # noqa: E402
from portbench import weights as wts  # noqa: E402

#: seconds at the end of a traced run's window that the profiler records
SLICE_S = 3.0
#: modules that must not be loaded (compared by whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: threads of the host's own PyTorch work
HOST_THREADS = 4


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return out[0] if out else "not read"


def end_to_end(win: harness.Window, peak_bytes: int, setup_s: float) -> dict:
    """Every end-to-end metric this run can give (the cell reports those
    ``BENCHMARK.json`` lists for it)."""
    end = win.end
    ttft, gaps, tokens = [], [], 0
    for tracks in win.tracks.values():
        for tr in tracks:
            st = [t for t in tr.stamps if t <= end]
            tokens += len(st)
            if st:
                ttft.append(1e3 * (st[0] - tr.due))
            gaps += [1e3 * (b - a) for a, b in zip(st, st[1:])]
    return {"tokens_per_s": tokens / end if end > 0 else None,
            "ttft_p95_ms": harness.percentile(ttft, 95),
            "itl_p95_ms": harness.percentile(gaps, 95),
            "peak_mem_gb": peak_bytes / 1e9 if peak_bytes else None,
            "setup_s": setup_s}


def profile_record(win: harness.Window) -> dict | None:
    """The profiled slice: its span, device operations, busy time and
    the shapes it served."""
    if win.profiler is None:
        return None
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        win.profiler.export_chrome_trace(path)
        events = devtrace.load(path)
    finally:
        os.unlink(path)
    spans = devtrace.host_spans(events)
    sl = [s for s in spans if s[2] == "pb.slice"]
    if not sl:
        return None
    lo, hi = sl[0][0], sl[0][1]
    ops = [o for o in devtrace.device_ops(events) if o[1] > lo and o[0] < hi]
    return {"lo_us": lo, "hi_us": hi, "ops": ops,
            "spans": [s for s in spans if s[2] != "pb.slice"],
            "busy_us": devtrace.busy_us(ops, lo, hi),
            "prefills": win.slice_prefills, "decodes": win.slice_decodes}


def breakdown(prof: dict) -> dict:
    top = sorted(devtrace.by_name(prof["ops"]).items(), key=lambda kv: -kv[1])
    gaps = sorted(devtrace.idle_gaps(prof["ops"], prof["lo_us"], prof["hi_us"]),
                  key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in top[:10]],
            "idle_gaps": [[devtrace.label_at(prof["spans"], (a + b) / 2),
                           (b - a) / 1e6] for a, b in gaps]}


def run(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", base: Path = spec.HERE, t_start: float = T_START,
        say=print, control: str | None = None) -> dict:
    """One run of cell ``cell_name``; returns the result line's object.
    ``say`` takes the lines printed before it (to standard error).
    ``control`` names a control of the reference (its ``CONTROLS``) that
    stands in the program's place in the comparison (``control.py``;
    never in the benchmark's own runs): on the same sample it serves the
    tokens the lower-precision reference puts first, which are judged as
    the program's are; each check keeps the program's own reading under
    ``program``."""
    import torch

    torch.set_num_threads(HOST_THREADS)
    on_card = torch.device(device).type == "cuda"
    cell = spec.cell(bench, cell_name)
    config = spec.config(cell["config"], base)
    mix = spec.traffic(cell["traffic"], base)
    seed_key = seed % (1 << 64)

    system = harness.build(config, mix, seed_key, device)
    lengths = harness.warm_up(system, mix, int(mix["warmup_lengths"]))
    slice_s = min(SLICE_S, seconds / 2) if trace else 0.0
    if trace:
        from torch.profiler import profile
        with profile(activities=harness.profiler_activities()):
            torch.zeros(1, device=device).add_(1)
    win = harness.Window(system, seed_key, slice_s)
    if on_card:
        torch.cuda.synchronize()
    setup_s = harness.clock() - t_start
    if mix["process"] == "closed":
        win.closed_loop(traffic.closed_loop(mix, seed_key), seconds)
    else:
        win.open_loop(traffic.open_loop(mix, seed_key, seconds), seconds)

    # -- the window has closed: read the device, then free the program --
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    counters = {k: v - win.counters0.get(k, 0) for k, v in win.counters().items()}
    e2e = end_to_end(win, peak, setup_s)
    rec = {"cell": cell_name, "gateway": system.gateway is not None,
           "measured_end": win.end - slice_s if trace else win.end,
           "tenants": {n: {"arch": t.arch, "slots": t.slots,
                           "capacity": t.capacity}
                       for n, t in system.tenants.items()},
           "steps": win.steps, "gateway_steps": win.gateway_steps,
           "tracks": win.tracks, "profile": profile_record(win)}
    samples = {n: check.sample(win.done(n), seed_key, int(mix["check_tokens"]))
               for n in system.tenants}
    attempted = sum(len(v) for v in win.tracks.values())
    win_profiled, win_end = win.profiled_from, win.end

    def rate(a, b):
        return sum(1 for s in win.steps if a <= s[1] and s[2] <= b) / (b - a)
    plan = system.plan
    say(f"portbench: cell {cell_name} seed {seed} seconds {seconds} "
        f"trace {int(trace)} on {device}; warm-up prompt lengths {lengths}")
    say(f"portbench: counters over the window {json.dumps(counters)}")
    late = np.asarray(win.lateness) * 1e3
    if len(late):
        say(f"portbench: requests {attempted}; generator lateness ms "
            f"p50 {np.percentile(late, 50):.3f} max {late.max():.3f}")
    if plan is not None:
        platform = config["gateway"]["platform"]["args"]["name"]
        say(f"portbench: gateway plan by {plan['solver']} in "
            f"{plan['solve_s']} s (boot {plan['boot_s']:.3f} s); predicted "
            f"decode step ms (simulated, {platform}) "
            f"{json.dumps(plan['predicted_step_ms'])}")
    if rec["profile"] is not None:
        p = rec["profile"]
        say(f"portbench: profiled slice {(p['hi_us'] - p['lo_us']) / 1e6:.3f} s "
            f"(from {win_profiled:.3f} s): "
            f"{sum(len(v) for v in p['decodes'].values())} decode replays, "
            f"{sum(len(v) for v in p['prefills'].values())} prefills, "
            f"device busy {p['busy_us'] / 1e6:.3f} s; engine steps a second "
            f"{rate(0.0, rec['measured_end']):.2f} unprofiled, "
            f"{rate(win_profiled, win_end):.2f} profiled")
    metrics_all = dict(e2e)
    if trace:
        for m in spec.per_layer(bench, cell_name):
            metrics_all[m["name"]] = spec.metric(m["name"], base).read(rec)
    say(f"portbench: every metric this run read {json.dumps(metrics_all)}")
    wanted = (spec.per_layer(bench, cell_name) if trace
              else spec.end_to_end(bench, cell_name))
    metrics = {m["name"]: {"value": metrics_all[m["name"]], "unit": m["unit"]}
               for m in wanted if metrics_all.get(m["name"]) is not None}
    prof = rec["profile"]
    del system, win, rec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- the comparison with the plain reference --
    checks, failed = {}, 0
    ref_mod = spec.reference(config["reference"], base)
    for t in config["tenants"]:
        name, arch = t["model"], t["arch"]
        reqs = samples[name]
        limit = float(t["max_logit_gap"])
        checks[f"gap.{name}"] = c = {"value": None, "limit": limit,
                                     "requests": len(reqs), "tokens": 0}
        if reqs:
            def weight(n, shape, dt, name=name):
                return wts.draw(seed_key, name, n, shape, dt, device)
            lg = check.reference_logits(ref_mod.Reference(arch, weight, device),
                                        reqs, device)
            c["value"], c["tokens"] = check.widest_gap(lg, reqs)
            if control:
                low, every = ref_mod.CONTROLS[control]
                ctl = check.reference_logits(
                    ref_mod.Reference(arch, weight, device, low=low,
                                      round_weights=every), reqs, device)
                c["program"] = c["value"]
                c["value"], _ = check.widest_gap(
                    lg, check.control_requests(reqs, ctl))
                del ctl
            del lg
        if c["value"] is None or c["value"] > limit:
            failed += max(1, len(reqs))
    if on_card:
        torch.cuda.empty_cache()

    result = {"correct": failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device,
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else device),
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if prof is not None:
        result["device"]["busy_s"] = prof["busy_us"] / 1e6
        result["device"]["window_s"] = (prof["hi_us"] - prof["lo_us"]) / 1e6
        result["breakdown"] = breakdown(prof)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def say(line):
        print(line, file=sys.stderr, flush=True)

    say(f"portbench: card {card()}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    result = run(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace), say=say)
    bad = forbidden_modules()
    if bad:
        say(f"portbench: forbidden modules loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"({c['requests']} requests, {c['tokens']} served tokens)")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
