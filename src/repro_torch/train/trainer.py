"""Training loop: microbatched grad accumulation, checkpoint/restart
(counterpart of ``repro/train/trainer.py``).

``make_train_step`` builds the step: loss and gradients over
``cfg.microbatches`` microbatches (the global batch never goes through
the model at once), global-norm clip, optimizer update.  ``Trainer``
wraps it with data, checkpointing (periodic + emergency-on-signal) and
restart (bitwise-resumable thanks to the counter-mode pipeline).

The model must have the training layout (``Model(..., layout="train")``):
its ``leaves`` are ``TrainState.params`` and its ``grads`` the gradient
buffers, both keyed and shaped as the reference's leaves, and the step
updates them in place (the reference donates its state).  On a card the
model runs the ``torch`` backend: the kernels have no backward and
refuse a gradient (``kernels/ops.py``).  ``Trainer(mesh=)`` stores its
mesh, as the reference's does; nothing reads it there either: a model
built on a mesh carries its own.

On a mesh (ZeRO-3 or FSDP-TP, ``Model(..., layout="train", mesh=m)``)
every rank builds its own ``Trainer`` over its blocks and makes the same
calls.  The step has the same form on every rank: it is given the whole
batch (every rank makes it, a pure function of the seed and step), each
microbatch is a slice of it as the reference's scan takes them, and the
model runs this rank's rows of each; the leaves, gradients and
optimizer state are this rank's blocks (``optimizer.for_model``), and
the reported loss and gradient norm are the batch's, equal on every
rank.  After each step the ranks agree on a preemption: a SIGTERM to
any of them makes all of them save the emergency checkpoint at that
step and raise (the reference's one controller decides alone).  A
checkpoint from ranks holds whole leaves, written once
(``checkpoint.save(shardings=)``), so either package and any mesh
restores it; ``restore_or_init`` reads it one array at a time and gives
each rank its blocks.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.data.pipeline import to_device
from repro_torch.models import Model
from . import checkpoint as ckpt_lib
from . import optimizer as opt_lib


@dataclass
class TrainState:
    step: int
    params: Any
    opt: Any


def make_train_step(model: Model, optimizer: opt_lib.Optimizer,
                    microbatches: int = 1) -> Callable:
    cfg = model.cfg
    if model.layout != "train":
        raise ValueError("training needs Model(..., layout='train')")
    optimizer = opt_lib.for_model(optimizer, model)
    clip = getattr(optimizer, "clip_by_global_norm",
                   opt_lib.clip_by_global_norm)

    def train_step(state: TrainState, batch):
        if state.params is not model.leaves:
            raise ValueError("state.params must be the model's leaves")
        model.zero_grads()
        if microbatches > 1:
            # grads sum over microbatches in the buffers (0 + g1 + g2 ...),
            # then divide, as the reference's scan accumulates
            lsum = 0.0
            for i in range(microbatches):
                mb = {k: v.chunk(microbatches)[i] for k, v in batch.items()}
                loss, met = model.loss_fn(mb)
                loss.backward()
                lsum = lsum + met["loss"].detach()
            for g in model.grads.values():
                g.div_(microbatches)
            loss = lsum / microbatches
            metrics = {}
        else:
            loss, metrics = model.loss_fn(batch)
            loss.backward()
            metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}
            loss = metrics["loss"]
        grads, gnorm = clip(model.grads, cfg.grad_clip)
        optimizer.apply_(grads, state.opt, state.params, state.step)
        out_metrics = dict(metrics)
        out_metrics.update(loss=loss, grad_norm=gnorm)
        state.step += 1
        return state, out_metrics

    return train_step


class Trainer:
    """Fault-tolerant training loop: one process, or every rank of a
    mesh in step (the module's doc).

    ``optimizer``: the reference builds its optimizer from the config
    (``cfg.optimizer`` under ``warmup_cosine(cfg.learning_rate)``); one
    given here replaces it.  ``mesh`` is stored and, as in the
    reference, read by nothing here."""

    def __init__(self, model: Model, data, ckpt_dir: str | None = None,
                 ckpt_every: int = 50, mesh=None,
                 optimizer: opt_lib.Optimizer | None = None):
        self.model = model
        cfg = model.cfg
        if optimizer is None:
            lr = opt_lib.warmup_cosine(cfg.learning_rate)
            optimizer = opt_lib.make(
                cfg.optimizer, lr, **({"weight_decay": cfg.weight_decay}
                                      if cfg.optimizer == "adamw" else {}))
        self.optimizer = opt_lib.for_model(optimizer, model)
        self.data = data
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.mesh = mesh
        self.step_fn = make_train_step(model, self.optimizer,
                                       cfg.microbatches)
        self.state: TrainState | None = None
        self._interrupted = False
        self._vote = _preemption_vote(model)

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None
                   ) -> TrainState:
        """Random weights from ``generator`` (on the model's device; seed
        0 when None) and a fresh optimizer state, on the model's
        device."""
        self.model.init(generator)
        opt = self.optimizer.init(self.model.leaves)
        self.state = TrainState(0, self.model.leaves, opt)
        return self.state

    def restore_or_init(self, generator: torch.Generator | None = None
                        ) -> TrainState:
        """The latest checkpoint under ``ckpt_dir``, else
        ``init_state(generator)``.  The checkpoint is read one whole
        array at a time: each (this rank's block of it, on a mesh) is
        copied into the model's storage or the optimizer state on the
        model's device before the next is read."""
        if not (self.ckpt_dir
                and ckpt_lib.latest_step(self.ckpt_dir) is not None):
            return self.init_state(generator)
        model, dev = self.model, self.model.device
        leaves = model.leaves
        meta = {k: torch.empty(s, dtype=leaves[k].dtype, device="meta")
                for k, s in model.leaf_shapes.items()}
        whole = getattr(self.optimizer, "whole_state", None)
        like = TrainState(0, meta, whole if whole is not None
                          else self.optimizer.init(meta))
        sh = self.shardings()
        where = {} if sh is None else ckpt_lib.flatten(sh)

        @torch.no_grad()
        def place(key, t):
            ns = where.get(key)
            block = t if ns is None else ns.shard_of(t)
            part, _, path = key.partition("/")
            if part == "params":
                return leaves[path].copy_(block)
            return block.to(dev, copy=True)
        got, _ = ckpt_lib.restore(self.ckpt_dir, like, place=place)
        self.state = TrainState(got.step, leaves, got.opt)
        return self.state

    def shardings(self) -> TrainState | None:
        """The state's shardings on the model's mesh (the step's none),
        or None off a mesh."""
        if self.model.leaf_shardings is None:
            return None
        return TrainState(None, self.model.leaf_shardings,
                          self.optimizer.shardings)

    def save(self) -> None:
        """A checkpoint of the state at its step; on a mesh every rank
        calls it at the same step, and whole leaves are written once."""
        ckpt_lib.save(self.ckpt_dir, int(self.state.step), self.state,
                      shardings=self.shardings())

    def _preempted(self) -> bool:
        """Whether to take the emergency checkpoint now: this process's
        flag, or on a mesh whether any rank's is set (every rank votes
        after every step, so that all of them act at the same one)."""
        if self._vote is None:
            return self._interrupted
        return self._vote(self._interrupted)

    # ------------------------------------------------------------------
    def _install_signal_handler(self):
        """Returns the handler it replaced, or None where it installed
        none (a non-main thread, as in tests)."""
        def handler(signum, frame):   # emergency checkpoint on preemption
            self._interrupted = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:            # non-main thread (tests)
            return None

    def run(self, steps: int, log_every: int = 10,
            on_metrics=None) -> list[dict]:
        """``steps`` steps under a SIGTERM handler that saves an emergency
        checkpoint (on a mesh, after the first step whose vote sees a
        flag); the handler it replaced comes back when it returns or
        raises, so that no handler keeps this trainer (and its model and
        state) alive after the run."""
        assert self.state is not None, "call restore_or_init first"
        before = self._install_signal_handler()
        try:
            return self._run(steps, log_every, on_metrics)
        finally:
            if before is not None:
                signal.signal(signal.SIGTERM, before)

    def _run(self, steps, log_every, on_metrics) -> list[dict]:
        history = []
        t0 = time.perf_counter()
        start = int(self.state.step)
        for step in range(start, steps):
            batch = to_device(self.data.batch_at(step), self.model.device)
            self.state, metrics = self.step_fn(self.state, batch)
            if self._preempted():
                if self.ckpt_dir:
                    self.save()
                raise KeyboardInterrupt("preempted; emergency ckpt saved")
            if self.ckpt_dir and (step + 1) % self.ckpt_every == 0:
                self.save()
            if (step + 1) % log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                m["wall_s"] = time.perf_counter() - t0
                history.append(m)
                if on_metrics:
                    on_metrics(m)
        if self.ckpt_dir:
            self.save()
        return history


def _preemption_vote(model) -> Callable[[bool], bool] | None:
    """On a mesh over ranks, a vote of every rank of the process group
    (which the mesh spans): ``vote(flag)`` is whether any rank gave True,
    a one-element max all-reduce of a host value over ``gloo`` (a group
    of its own, made here, when the default group is ``nccl``, so that
    the vote never waits on the card).  None off a mesh: no collective."""
    mesh = model.mesh
    if model.leaf_shardings is None or mesh.device_mesh is None:
        return None
    import torch.distributed as dist
    group = None if dist.get_backend() == "gloo" else dist.new_group(
        backend="gloo")

    def vote(flag: bool) -> bool:
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return bool(t.item())
    return vote

