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

On a mesh (:func:`for_model` of a training model built on one) the
parameters, gradients and states are each rank's blocks: a parameter's
and its gradient's are ``model.leaf_shardings``, a state's follow the
reference's ``_opt_shardings`` (:func:`state_shardings`: the leaf's
logical axes where the shapes match, a factored moment dropping the
axis it averages over).  AdamW stays local; the global norm sums each
leaf's squares once over the mesh (one float32 all-reduce an axis); a
factored Adafactor moment sums over the ranks that split the dim it
averages, and its update's RMS over every rank that splits the leaf.
A leaf whose state the reference's rule blocks otherwise than the leaf
(it matches states to leaves by shape alone) is updated whole: its
gradient, parameter and state gathered, the one-device arithmetic, each
block cut back.
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
            _add(p, u)
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

    def leaf(g, s, p, sc, inplace, blocks=None):
        """``blocks`` (a :class:`_Blocks`): ``g``, ``s`` and ``p`` are a
        rank's blocks, and each mean sums over the ranks."""
        beta = sc["beta"]

        def ema(old, new):          # beta old + (1 - beta) new
            out = old.mul_(beta) if inplace else old * beta
            return out.add_(new.mul_(1 - beta))

        gf = g.float()
        g2 = torch.square(gf).add_(eps)
        if factored(p):
            if blocks is None:
                vr = ema(s["vr"], g2.mean(-1))
                vc = ema(s["vc"], g2.mean(-2))
            else:
                vr = ema(s["vr"], blocks.mean(g2, -1))
                vc = ema(s["vc"], blocks.mean(g2, -2))
            del g2
            vm = (vr.mean(-1, keepdim=True) if blocks is None
                  else blocks.mean(vr, -2, -1, keepdim=True))
            denom = torch.clamp(vm, min=eps)
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
        if blocks is None:
            sq = torch.linalg.vector_norm(u).square() / u.numel()
        else:
            sq = blocks.total(torch.linalg.vector_norm(u).square()) \
                / blocks.numel
        rms = torch.sqrt(sq + 1e-12)
        u.div_(torch.clamp(rms / clip_threshold, min=1.0))
        if weight_decay:
            u.add_(weight_decay * p.float())
        return u.mul_(-sc["lr"]).to(p.dtype), new_s

    def slot(state, path):
        return state[path]

    return Optimizer(init, scalars, leaf, slot)


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------

def _spec(ns, ndim: int) -> tuple:
    return tuple(ns.spec) + (None,) * (ndim - len(ns.spec))


class _Blocks:
    """Sums of a leaf's block over the ranks that split it (sharding
    ``ns`` of a leaf of whole ``shape``)."""

    def __init__(self, ns, shape):
        self.ns, self.shape = ns, tuple(shape)
        self.numel = math.prod(self.shape)

    def _reduce(self, t, axes):
        from repro_torch.models import collectives
        for a in axes:
            t = collectives.all_reduce(t, self.ns.mesh, a)
        return t

    def mean(self, t, dim: int, tdim: int | None = None,
             keepdim: bool = False):
        """The mean over the leaf's dim ``dim`` of ``t``, whose dim
        ``tdim`` (default ``dim``) is that dim's block."""
        dim %= len(self.shape)
        axes = _spec(self.ns, len(self.shape))[dim]
        axes = () if axes is None else (
            axes if isinstance(axes, tuple) else (axes,))
        total = self._reduce(t.sum(dim if tdim is None else tdim,
                                   keepdim=keepdim), axes)
        return total / self.shape[dim]

    def total(self, t):
        """``t`` (a sum over this rank's block) summed over every rank's
        block."""
        return self._reduce(t, self.ns.axes())


def state_shardings(mesh, rules, logical: dict, shapes: dict, state):
    """The shardings of an optimizer ``state`` (a tree of tensors of the
    whole leaves' shapes) over the leaves of ``shapes`` with ``logical``
    axes, by the reference's ``_opt_shardings``
    (``repro/launch/dryrun.py:142-166``): the logical axes of the first
    leaf, in tree order, of the state's shape, else of the first whose
    shape without its last dim, or without its second to last, is the
    state's (a factored moment), else none."""
    from repro_torch.models.sharding import named_sharding
    by_shape = {}
    for path, shape in shapes.items():
        by_shape.setdefault(tuple(shape), logical[path])

    def one(x):
        shape = tuple(x.shape)
        lg = by_shape.get(shape)
        if lg is None:
            for s, plg in by_shape.items():
                if shape == s[:-1]:
                    lg = plg[:-1]
                    break
                if shape == s[:-2] + s[-1:]:
                    lg = plg[:-2] + plg[-1:]
                    break
        if lg is None:
            lg = (None,) * len(shape)
        return named_sharding(mesh, rules, lg, shape)
    return _tree(state, one)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


class OnMesh:
    """``opt`` over the blocks of a training model on a mesh (the
    module's doc): ``init``, ``apply_``, ``clip_by_global_norm`` and
    ``global_norm`` as the one-device functions, on each rank's blocks.
    ``shardings`` is the state's tree of shardings and ``whole_state``
    its whole shapes (on ``meta``), for a checkpoint."""

    def __init__(self, opt: Optimizer, model):
        self.opt, self.mesh = opt, model.mesh
        self.params = model.leaf_shardings
        self.shapes = model.leaf_shapes
        meta = {k: torch.empty(s, dtype=F32, device="meta")
                for k, s in self.shapes.items()}
        self.whole_state = opt.init(meta)
        self.shardings = state_shardings(self.mesh, model.rules,
                                         model.leaf_logical, self.shapes,
                                         self.whole_state)
        #: leaves updated whole: a state blocked otherwise than its leaf
        self.whole = set()
        for path, ns in self.params.items():
            n = len(self.shapes[path])
            own = _spec(ns, n)
            for key, sh in opt.slot(self.shardings, path).items():
                want = {"vr": own[:-1], "vc": own[:-2] + own[-1:]}.get(key,
                                                                       own)
                if _spec(sh, len(want)) != want:
                    self.whole.add(path)

    def init(self, params):
        dev = next(iter(params.values())).device
        return tree_pair(self.whole_state, self.shardings,
                         lambda t, ns: torch.zeros(
                             ns.shard_shape(t.shape), dtype=t.dtype,
                             device=dev))

    def global_norm(self, grads):
        """sqrt of every leaf's squares over the whole mesh, each block
        counted once (a leaf the mesh does not split over an axis, by
        rank 0 of that axis alone)."""
        from repro_torch.models import collectives
        mesh = self.mesh
        total = None
        for path, g in grads.items():
            ns = self.params[path]
            split = set(ns.axes())
            if any(mesh.coordinate(a) for a in mesh.axis_names
                   if a not in split):
                part = torch.zeros((), dtype=F32, device=g.device)
            else:
                part = torch.sum(torch.square(g.float()))
            total = part if total is None else total + part
        for a in mesh.axis_names:
            total = collectives.all_reduce(total, mesh, a)
        return torch.sqrt(total)

    def clip_by_global_norm(self, grads, max_norm: float):
        norm = self.global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        for g in grads.values():
            g.mul_(scale)
        return grads, norm

    @torch.no_grad()
    def apply_(self, grads, state, params, step) -> None:
        opt = self.opt
        sc = opt.scalars(step)
        adafactor = "m" not in state
        for path, p in params.items():
            ns = self.params[path]
            s = opt.slot(state, path)
            if path in self.whole:
                self._apply_whole(path, grads[path], s, p, sc)
                continue
            kw = {"blocks": _Blocks(ns, self.shapes[path])} \
                if adafactor else {}
            u, _ = opt.leaf(grads[path], s, p, sc, True, **kw)
            _add(p, u)
            del u

    def _apply_whole(self, path, g, s, p, sc) -> None:
        ns = self.params[path]
        sh = self.opt.slot(self.shardings, path)
        whole = {k: sh[k].gather(t) for k, t in s.items()}
        pw = ns.gather(p)
        u, new = self.opt.leaf(ns.gather(g), whole, pw, sc, True)
        for k, t in s.items():
            t.copy_(sh[k].shard_of(new[k]))
        _add(p, ns.shard_of(u))


def tree_pair(tree, other, fn):
    """``fn(leaf, other's leaf)`` over a state tree (nested dicts) and a
    tree of the same keys, such as its shardings."""
    if isinstance(tree, dict):
        return {k: tree_pair(v, other[k], fn) for k, v in tree.items()}
    return fn(tree, other)


def _add(p, u) -> None:
    if p.dtype == F32:
        p.add_(u)
    else:
        p.copy_((p.float() + u).to(p.dtype))


def for_model(opt, model):
    """``opt`` as a training model's step uses it: over the blocks of a
    model on a mesh (:class:`OnMesh`), else itself."""
    if isinstance(opt, OnMesh) or getattr(model, "split", None) is None:
        return opt
    return OnMesh(opt, model)


def make(name: str, lr, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(name)
