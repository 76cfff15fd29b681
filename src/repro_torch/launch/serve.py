"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Single-model continuous-batching service, as ``repro.launch.serve``
without ``--co-arch``: random weights from a seeded generator, prompts of
8 random tokens, greedy decoding::

    python -m repro_torch.launch.serve --arch stablelm-1.6b --requests 4
    python -m repro_torch.launch.serve --arch rwkv6-7b
    python -m repro_torch.launch.serve --arch recurrentgemma-9b
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --reduced \
        --device cpu

Runs on ``cuda`` at the architecture's full width unless told otherwise;
``--reduced`` takes the reference's smoke-size sibling (what the
reference's single-model mode serves).  Attention (``attn``, ``local``)
and recurrent (``rglru``, ``rwkv``) layer stacks are served; MoE models
and the gateway, fleet and co-serving modes are not ported yet.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import build
from repro_torch.serve.engine import ServingEngine

#: reference modes not ported yet -> the ROADMAP.md queue-1 item.
_NOT_PORTED = {
    "gateway": "Gateway, co-serving and fleet",
    "fleet": "Gateway, co-serving and fleet",
    "co_arch": "Gateway, co-serving and fleet",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true",
                    help="serve the architecture's reduced (smoke) config")
    ap.add_argument("--co-arch", default=None, choices=configs.ARCHS)
    ap.add_argument("--gateway", action="store_true")
    ap.add_argument("--fleet", action="store_true")
    args = ap.parse_args(argv)

    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not ported to "
                     f"repro_torch yet (ROADMAP.md queue 1: {item}); use "
                     f"repro.launch.serve")

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


if __name__ == "__main__":
    raise SystemExit(main())
