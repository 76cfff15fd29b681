"""Finds the knee of an open-loop cell on the card and writes it into the
cell's traffic file::

    python3 portbench/sweep.py --workload cohost.chat --seed 1 --seconds 20 \\
        --rates 4,5,6,7,8,10 [--out <file>]

One process builds the cell's system once and serves a window of
``--seconds`` at each total rate in turn (every tenant scaled together,
the mix's sizes and weights unchanged), emptying the queues between
windows.  The queue *grows* at a rate when, at the window's end, more
than ``max(4, 5%)`` of the requests that arrived still wait for their
first token.  The knee is the highest rate below the first that grows;
the sweep stops once two rates have grown.  Where no swept rate grows,
or the first does, there is no knee and nothing is written.  ``--out``
(default: the traffic file itself) receives the mix with ``knee_rps``,
``rate_rps`` = ``rate_share_of_knee`` x knee, and ``knee_from``, which
holds the rule and every row as the sweep wrote it.  Prints one JSON row
a rate.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import harness, spec, traffic  # noqa: E402


#: the rule by which a window's queue grows (``window_row``)
GROWS = "more than max(4, 5%) of the window's arrivals wait for a first token at its end"


def window_row(win: harness.Window, rate: float) -> dict:
    """What one window at ``rate`` showed."""
    end = win.end
    arrived = [tr for v in win.tracks.values() for tr in v if tr.due <= end]
    started = [tr for tr in arrived if tr.stamps and tr.stamps[0] <= end]
    ttft = [1e3 * (tr.stamps[0] - tr.due) for tr in started]
    gaps = [1e3 * (b - a) for tr in arrived for a, b in
            zip(tr.stamps, tr.stamps[1:]) if b <= end]
    waiting = len(arrived) - len(started)
    return {"rate_rps": rate, "arrived": len(arrived), "first_tokens": len(started),
            "waiting_at_end": waiting,
            "grows": waiting > max(4, 0.05 * len(arrived)),
            "ttft_p50_ms": harness.percentile(ttft, 50),
            "ttft_p95_ms": harness.percentile(ttft, 95),
            "itl_p95_ms": harness.percentile(gaps, 95)}


def sweep(bench, cell_name: str, seed: int, seconds: float, rates, device,
          base=spec.HERE, say=print) -> tuple[float | None, list]:
    cell = spec.cell(bench, cell_name)
    mix = spec.traffic(cell["traffic"], base)
    if mix["process"] == "closed":
        raise ValueError(f"{cell_name} is a closed loop: it has no knee")
    config = spec.config(cell["config"], base)
    system = harness.build(config, mix, seed, device)
    harness.warm_up(system, mix, int(mix["warmup_lengths"]))
    rows = []
    for i, rate in enumerate(sorted(rates)):
        system.reset()
        win = harness.Window(system, seed + i)
        win.open_loop(traffic.open_loop(dict(mix, rate_rps=rate), seed + i,
                                        seconds), seconds)
        rows.append(window_row(win, rate))
        say(json.dumps(rows[-1]))
        if sum(r["grows"] for r in rows) == 2:
            break
    return knee_of(rows), rows


def knee_of(rows: list[dict]) -> float | None:
    """The rate of the row before the first that grows (rows by rate);
    ``None`` where none grows or the first does."""
    first = next((i for i, r in enumerate(rows) if r["grows"]), None)
    return rows[first - 1]["rate_rps"] if first else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated req/s")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep.py measures the card; none found", file=sys.stderr)
        return 2
    bench = spec.benchmark(ROOT)
    knee, rows = sweep(bench, args.workload, args.seed, args.seconds,
                       [float(r) for r in args.rates.split(",")], "cuda")
    if knee is None:
        print("no knee: either no swept rate grew (sweep higher rates) or "
              "the first did (sweep lower rates)", file=sys.stderr)
        return 1
    cell = spec.cell(bench, args.workload)
    path = spec.HERE / "traffic" / f"{cell['traffic']}.json"
    mix = spec.load_json(path)
    mix["knee_rps"] = knee
    mix["rate_rps"] = round(float(mix["rate_share_of_knee"]) * knee, 6)
    mix["knee_from"] = (f"portbench/sweep.py on {torch.cuda.get_device_name(0)}, "
                        f"{args.seconds:g} s a rate, seed {args.seed}; the "
                        f"queue grows where {GROWS}: {json.dumps(rows)}")
    out = Path(args.out) if args.out else path
    out.write_text(json.dumps(mix, indent=1) + "\n")
    print(json.dumps({"knee_rps": knee, "rate_rps": mix["rate_rps"],
                      "written": str(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
