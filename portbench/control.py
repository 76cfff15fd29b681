"""Reads a control of a cell's comparison on the card (it is not part
of the benchmark's runs)::

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds <s> [--control fp8|bf16]

For each seed, one run of the cell in this process (set-up, window,
sample, the program freed) in which the control stands in the program's
place: at each served position of the sample, the token that the
reference computed in a lower precision (the reference's ``CONTROLS``;
``fp8`` by default) puts first is served instead, and judged by the same
comparison and limit as the program's tokens, so ``correct`` is the
control's.  Each check keeps the program's own reading of that run under
``program``.  A limit lies between the largest program reading over a
dozen seeds or more and the smallest ``fp8`` reading.  Prints one JSON
line a seed.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
sys.path.insert(0, str(ROOT))

from portbench import run, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default="fp8")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py reads the control on the card; none found",
              file=sys.stderr)
        return 2
    bench = spec.benchmark(ROOT)
    for s in args.seeds.split(","):
        res = run.run(bench, args.workload, int(s), args.seconds, False,
                      t_start=time.perf_counter(), control=args.control,
                      say=lambda line: print(line, file=sys.stderr, flush=True))
        print(json.dumps({"seed": int(s), "control": args.control,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
