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

``--devices N`` trains on N ranks, a (data 1, model N) mesh under
``cfg.rules`` (ZeRO-3 for the dense and recurrent families, FSDP-TP for
the MoE ones): the launcher calls ``repro_torch.ranks.share_devices(N)``
(so N ranks may share one card or the CPU, as the reference's emulated
host devices do) and becomes rank 0 of a ``RankPool``; every rank builds
its blocks of the model and runs the same steps, and rank 0 prints.
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
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="train on N ranks, a (1, N) mesh under the "
                         "config's rules (N ranks may share the devices "
                         "there are)")
    args = ap.parse_args(argv)
    if args.devices is not None and args.devices < 1:
        ap.error(f"--devices {args.devices}: must be >= 1; nearest legal "
                 f"value: devices=1")
    if not args.devices:
        train(vars(args))
        return 0
    from repro_torch import ranks
    ranks.share_devices(args.devices)
    try:
        ranks.rank_pool(args.devices, resolve_device(args.device)).run(
            "repro_torch.launch.train:train", vars(args))
    finally:
        ranks.close_pool()
    return 0


def train(args: dict) -> list[dict]:
    """The run ``main`` parses, on this process or (``devices``) on every
    rank of the process group; rank 0 prints.  Returns the history."""
    import torch.distributed as dist
    dev = resolve_device(args["device"])
    cfg = configs.get(args["arch"])
    if args["reduced"]:
        cfg = cfg.reduced()
    mesh = None
    if args.get("devices"):
        from repro_torch.launch.mesh import device_mesh
        mesh = device_mesh((1, args["devices"]), device=dev.type)
    model = build(cfg, backend="torch", device=dev, layout="train",
                  mesh=mesh)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args["seq_len"],
                                  global_batch=args["global_batch"]))
    trainer = Trainer(model, data, ckpt_dir=args["ckpt_dir"])
    trainer.restore_or_init(
        torch.Generator(device=dev).manual_seed(args["seed"]))
    show = mesh is None or dist.get_rank() == 0
    hist = trainer.run(args["steps"], log_every=max(1, args["steps"] // 10),
                       on_metrics=lambda m: show and print(
                           f"step {m['step']:5d} loss={m['loss']:.4f} "
                           f"gnorm={m['grad_norm']:.2f}", flush=True))
    if show:
        where = "" if mesh is None else f" on {args['devices']} ranks"
        print(f"done{where}: final loss {hist[-1]['loss']:.4f}", flush=True)
    return hist


if __name__ == "__main__":
    raise SystemExit(main())
