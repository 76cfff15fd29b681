"""Tables of the one-H100 dry run (counterpart of
``repro/analysis/report.py``).

    PYTHONPATH=src python -m repro_torch.analysis.report \\
        [--dir artifacts/dryrun_h100]

Prints markdown to stdout: a summary, the roofline table (the
reference's columns) and the dry-run table, which for one card reports
the memory verdict where the reference reports compile times and
collectives, one row an architecture.
"""
from __future__ import annotations

import argparse
import json
import pathlib

ARCH_ORDER = [
    "recurrentgemma-9b", "rwkv6-7b", "internvl2-2b", "stablelm-1.6b",
    "nemotron-4-15b", "qwen1.5-32b", "llama3.2-3b", "hubert-xlarge",
    "dbrx-132b", "qwen3-moe-235b-a22b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dir_: pathlib.Path, mesh: str = "h100"):
    recs = {}
    for f in dir_.glob(f"*_{mesh}.json"):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"])] = r
    return recs


def fmt_ms(x):
    if x >= 1000:
        return f"{x / 1e3:.2f}s"
    return f"{x:.1f}ms"


def roofline_table(recs) -> str:
    out = ["| arch | shape | status | t_compute | t_memory | t_collective |"
           " bound | useful (6ND/counted) | frac | note |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape))
            if r is None:
                out.append(f"| {arch} | {shape} | MISSING | | | | | | | |")
                continue
            if r["status"] == "skip":
                out.append(f"| {arch} | {shape} | SKIP | | | | | | | "
                           f"{r['reason']} |")
                continue
            rl = r["roofline"]
            out.append(
                f"| {arch} | {shape} | ok | {fmt_ms(rl['t_compute_ms'])} "
                f"| {fmt_ms(rl['t_memory_ms'])} "
                f"| {fmt_ms(rl['t_collective_ms'])} | {rl['bottleneck']} "
                f"| {rl['model_flops_ratio']:.2f} "
                f"| {rl['roofline_fraction']:.3f} ({rl['useful_metric']}) "
                f"| {rl['what_would_help'][:58]} |")
    return "\n".join(out)


def _verdict(r) -> str:
    if r is None:
        return "MISSING"
    if r["status"] != "ok":
        return "SKIP"
    m = r["memory"]
    depth = ("none" if m["deepest_depth"] < 0
             else f"{m['deepest_depth']}/{m['n_layers']}")
    return (f"{m['peak_estimate_gb']:.1f} {'yes' if m['fits'] else 'no'}; "
            f"{depth}; {m['largest_batch']}")


def dryrun_table(recs, mesh: str = "h100") -> str:
    """One row an architecture, one column a shape: the peak estimate in
    GB and whether it fits the card; the deepest depth that fits at the
    cell's batch; the largest batch that fits at full depth."""
    out = ["| arch | " + " | ".join(SHAPE_ORDER) + " |",
           "|---|" + "---|" * len(SHAPE_ORDER)]
    for arch in ARCH_ORDER:
        cells = [_verdict(recs.get((arch, shape))) for shape in SHAPE_ORDER]
        out.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def _limit(recs) -> str:
    for r in recs.values():
        if r["status"] == "ok":
            return f"{r['memory']['limit_bytes'] / 1e9:.0f}"
    return "?"


def summary_stats(recs) -> str:
    oks = [r for r in recs.values() if r["status"] == "ok"]
    skips = [r for r in recs.values() if r["status"] == "skip"]
    bounds = {}
    for r in oks:
        b = r["roofline"]["bottleneck"]
        bounds[b] = bounds.get(b, 0) + 1
    fr = sorted((r["roofline"]["roofline_fraction"],
                 r["arch"], r["shape"]) for r in oks)
    fit = sorted(f"{r['arch']} × {r['shape']}" for r in oks
                 if r["memory"]["fits"])
    lines = [f"- cells estimated: {len(oks)}; skipped per assignment rules: "
             f"{len(skips)}",
             f"- cells that fit one card: {len(fit)} ({', '.join(fit)})",
             f"- bottleneck split: {bounds}"]
    if fr:
        lines += [f"- worst roofline fraction: {fr[0][0]:.3f} "
                  f"({fr[0][1]} × {fr[0][2]})",
                  f"- best roofline fraction: {fr[-1][0]:.3f} "
                  f"({fr[-1][1]} × {fr[-1][2]})"]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_h100")
    ap.add_argument("--mesh", default="h100")
    args = ap.parse_args(argv)
    recs = load(pathlib.Path(args.dir), args.mesh)
    print(f"### Roofline (one H100)\n")
    print(summary_stats(recs) + "\n")
    print(roofline_table(recs) + "\n")
    print(f"### Dry run (one H100)\n")
    print(f"Each cell: peak GB, fits {_limit(recs)} GB; deepest depth at "
          "the cell's batch; largest batch at full depth.\n")
    print(dryrun_table(recs, args.mesh))


if __name__ == "__main__":
    main()
