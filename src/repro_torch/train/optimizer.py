"""Optimizers in PyTorch: AdamW and Adafactor (+ clip, schedules)
(counterpart of ``repro/train/optimizer.py``).

Parameters, gradients and optimizer states are dicts of tensors keyed by
the reference's leaf paths (``"emb/tok"``, ``"groups/0/t/wq"``, ...) in
the reference's shapes: each block-pattern group stacked on a leading
layer axis, attention heads unflattened.  The shapes matter to Adafactor:
it factors every leaf with ``ndim >= 2`` over its last two axes and clips
each leaf's update by one RMS over the whole leaf, so a stacked norm
scale ``(G, d)`` is factored over its layer axis and one RMS couples
every layer of a group, as in the reference.  States mirror the
reference's pytrees: AdamW ``{"m": {path: t}, "v": {path: t}}``,
Adafactor ``{path: {"vr": t, "vc": t}}`` (factored) or ``{path: {"v":
t}}``.  The math is float32, operation for operation the reference's.

``update`` is the reference's functional API; ``apply_`` is the same
arithmetic in place, one leaf at a time, so a step holds the temporaries
of one leaf rather than a second copy of every parameter: two leaf-sized
float32 temporaries for AdamW, one for Adafactor (whose update RMS is
taken as a vector norm, which sums the squares in another order than
the reference's mean of squares).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

F32 = torch.float32


def warmup_cosine(peak_lr: float, warmup: int = 100,
                  total: int = 10000, floor: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = peak_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in the dict's order, of each leaf's
    sum of squares in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """Scales ``grads`` in place; returns them and the norm before."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm


@dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``scalars(step)`` the step's shared
    float32 scalars; ``leaf(g, s, p, scalars, inplace) -> (update,
    new_s)`` for one leaf, ``new_s`` written over ``s`` when ``inplace``
    (each operation rounds as the reference's, in place or not);
    ``slot(state, path)`` that leaf's state dict."""
    init: Callable
    scalars: Callable
    leaf: Callable
    slot: Callable

    @torch.no_grad()
    def update(self, grads, state, params, step):
        """(updates, new state), the reference's ``update``; nothing is
        written."""
        sc = self.scalars(step)
        upds, slots = {}, {}
        for path, p in params.items():
            upds[path], slots[path] = self.leaf(
                grads[path], self.slot(state, path), p, sc, False)
        return upds, _regroup(state, slots)

    @torch.no_grad()
    def apply_(self, grads, state, params, step) -> None:
        """The same update with the new state written over the old and
        ``(p.float() + u).to(p.dtype)`` over each parameter, in place."""
        sc = self.scalars(step)
        for path, p in params.items():
            u, _ = self.leaf(grads[path], self.slot(state, path), p, sc,
                             True)
            if p.dtype == F32:
                p.add_(u)
            else:
                p.copy_((p.float() + u).to(p.dtype))
            del u               # before the next leaf's temporaries


def _regroup(state, slots):
    if set(state) == {"m", "v"}:
        return {k: {path: s[k] for path, s in slots.items()}
                for k in ("m", "v")}
    return slots


def adamw(lr: Callable | float, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=F32)    # noqa: E731
        return {"m": {k: z(p) for k, p in params.items()},
                "v": {k: z(p) for k, p in params.items()}}

    def scalars(step):
        step_f = torch.as_tensor(step, dtype=F32) + 1.0
        return dict(bc1=1.0 - b1 ** step_f, bc2=1.0 - b2 ** step_f,
                    lr=lr_fn(step))

    def leaf(g, s, p, sc, inplace):
        gf = g.float()
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        m = s["m"].mul_(b1) if inplace else s["m"] * b1
        m.add_((1 - b1) * gf)
        v = s["v"].mul_(b2) if inplace else s["v"] * b2
        v.add_(torch.square(gf).mul_(1 - b2))
        # u = (m / bc1) / (sqrt(v / bc2) + eps) + wd p
        d = torch.div(v, sc["bc2"]).sqrt_().add_(eps)
        u = torch.div(m, sc["bc1"]).div_(d)
        del d
        u.add_(weight_decay * p.float())
        return u.mul_(-sc["lr"]).to(p.dtype), {"m": m, "v": v}

    def slot(state, path):
        return {"m": state["m"][path], "v": state["v"][path]}

    return Optimizer(init, scalars, leaf, slot)


def adafactor(lr: Callable | float, eps=1e-30, clip_threshold=1.0,
              decay=0.8, weight_decay=0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def factored(p):
        return p.ndim >= 2

    def init(params):
        def one(p):
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=F32, device=p.device)}
            return {"v": torch.zeros_like(p, dtype=F32)}
        return {k: one(p) for k, p in params.items()}

    def scalars(step):
        step_f = torch.as_tensor(step, dtype=F32) + 1.0
        return dict(beta=1.0 - step_f ** -decay, lr=lr_fn(step))

    def leaf(g, s, p, sc, inplace):
        beta = sc["beta"]

        def ema(old, new):          # beta old + (1 - beta) new
            out = old.mul_(beta) if inplace else old * beta
            return out.add_(new.mul_(1 - beta))

        gf = g.float()
        g2 = torch.square(gf).add_(eps)
        if factored(p):
            vr = ema(s["vr"], g2.mean(-1))
            vc = ema(s["vc"], g2.mean(-2))
            del g2
            denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
            rhat = (vr / denom)[..., None]
            # u = g / (sqrt(rhat vc) + eps)
            d = torch.mul(rhat, vc[..., None, :]).sqrt_().add_(eps)
            u = torch.div(gf, d, out=d)
            new_s = {"vr": vr, "vc": vc}
        else:
            v = ema(s["v"], g2)
            u = gf / torch.sqrt(v).add_(eps)
            new_s = {"v": v}
        # sqrt(mean(u^2) + 1e-12), with no leaf-sized temporary
        rms = torch.sqrt(torch.linalg.vector_norm(u).square() / u.numel()
                         + 1e-12)
        u.div_(torch.clamp(rms / clip_threshold, min=1.0))
        if weight_decay:
            u.add_(weight_decay * p.float())
        return u.mul_(-sc["lr"]).to(p.dtype), new_s

    def slot(state, path):
        return state[path]

    return Optimizer(init, scalars, leaf, slot)


def make(name: str, lr, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(name)
