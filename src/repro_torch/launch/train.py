"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (counterpart of ``repro/launch/train.py``).

Trains on the card by default (``--device cpu`` on the host).  The model
is built with ``backend="torch"``, the twin of the reference's ``xla``
backend: no CUDA kernel has a backward (nor has any Pallas kernel of the
reference), so the kernel path refuses a gradient, and a training step
on the card runs the plain PyTorch operations.  As in the reference,
``--reduced`` cannot be switched off (it is declared ``store_true`` with
a default of True), so the launcher trains the reduced smoke config;
full-width training is driven through ``Trainer`` directly
(``chip_smoke.py``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import build
from repro_torch.runtime import resolve_device
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="train the reduced smoke config (CPU container)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg, backend="torch", device=dev, layout="train")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                  global_batch=args.global_batch))
    trainer = Trainer(model, data, ckpt_dir=args.ckpt_dir)
    trainer.restore_or_init(
        torch.Generator(device=dev).manual_seed(args.seed))
    hist = trainer.run(args.steps, log_every=max(1, args.steps // 10),
                       on_metrics=lambda m: print(
                           f"step {m['step']:5d} loss={m['loss']:.4f} "
                           f"gnorm={m['grad_norm']:.2f}"))
    print(f"done: final loss {hist[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
