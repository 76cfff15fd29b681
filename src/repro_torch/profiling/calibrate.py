"""PCCS calibration: fit contention models from co-run slowdown samples.

The harness's :func:`~repro_torch.profiling.harness.corun_sweep` emits
(own, external) → slowdown samples; this module fits the repo's
contention-model classes to them with PyTorch least squares and Adam:

* :func:`fit_piecewise` — PCCS proper.  The knot grid defaults to sample
  quantiles; table values are fitted by Adam on the *hat-basis bilinear*
  prediction (the same contraction the evaluators run,
  :func:`repro_torch.kernels.ref.piecewise_slowdown`), with a monotonicity
  penalty on negative finite differences along both demand axes and a
  floor penalty at 1.  After convergence the table is *exactly* projected
  onto the constraint set (cummax along both axes, clip at 1), so the
  returned :class:`~repro_torch.core.contention.PiecewiseModel` always
  validates — slowdown surfaces are physically monotone: more external
  traffic never speeds you up.
* :func:`fit_proportional` — the analytic 2-parameter model
  (capacity, sensitivity), positivity-constrained through softplus.

Both report residuals (:class:`FitReport`) of the *final, projected*
model against the input samples — the number the acceptance gate and
``BENCH_profile.json`` track.

Counterpart of ``repro/profiling/calibrate.py``.  The fits run in
float32, as the reference's do (x64 is off there), on ``device``: ``cuda``
unless the caller asks for the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..core.contention import (PiecewiseModel, ProportionalShareModel,
                               pccs_from_pairs)
from ..runtime import resolve_device
from .harness import Sample


@dataclass(frozen=True)
class FitReport:
    """Residuals of a calibrated model against its training samples."""

    rmse: float
    max_abs_err: float
    #: max |pred - measured| / measured — the acceptance-gate number.
    max_rel_err: float
    n_samples: int
    steps: int
    loss_init: float
    loss_final: float

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("rmse", "max_abs_err", "max_rel_err", "n_samples",
                 "steps", "loss_init", "loss_final")}


@dataclass(frozen=True)
class CalibrationResult:
    model: PiecewiseModel | ProportionalShareModel
    report: FitReport

    def summary(self) -> str:
        r = self.report
        return (f"{type(self.model).__name__} fitted on {r.n_samples} "
                f"samples: rmse={r.rmse:.4f} max_rel={r.max_rel_err:.2%} "
                f"({r.steps} steps, loss {r.loss_init:.3g} -> "
                f"{r.loss_final:.3g})")


def _as_arrays(samples: Sequence[Sample]):
    arr = np.asarray(samples, dtype=float)
    if arr.ndim != 2 or arr.shape[1] != 3 or not len(arr):
        raise ValueError(
            "samples must be a non-empty sequence of (own, ext, slowdown)")
    if (arr[:, 2] < 1.0 - 1e-9).any():
        raise ValueError("measured slowdowns must be >= 1")
    return arr[:, 0], arr[:, 1], np.maximum(1.0, arr[:, 2])


def default_knots(values: np.ndarray, n: int = 5) -> tuple[float, ...]:
    """Strictly increasing knot grid from sample quantiles.

    When the sweep used <= ``n`` distinct levels the knots *are* those
    levels (so the fit can interpolate the samples exactly); otherwise
    evenly spaced quantiles.
    """
    uniq = np.unique(np.round(values, 9))
    if len(uniq) <= n:
        knots = uniq
    else:
        knots = np.unique(np.quantile(uniq, np.linspace(0.0, 1.0, n)))
    if len(knots) < 2:   # degenerate sweep: widen to a valid 2-knot grid
        v = float(knots[0]) if len(knots) else 0.5
        knots = np.asarray([v * 0.5, v]) if v > 0 else np.asarray([0.0, 1.0])
    return tuple(float(k) for k in knots)


def _report(pred: np.ndarray, sd: np.ndarray, steps: int,
            loss0: float, loss1: float) -> FitReport:
    err = pred - sd
    return FitReport(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        max_abs_err=float(np.max(np.abs(err))),
        max_rel_err=float(np.max(np.abs(err) / sd)),
        n_samples=int(len(sd)), steps=steps,
        loss_init=float(loss0), loss_final=float(loss1))


def _adam(loss_fn, params: torch.Tensor, steps: int, lr: float):
    """Minimal Adam loop: the reference's update, step by step, with the
    gradient from autograd.  Returns the parameters and the loss before
    each step."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = params.detach().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    losses = []
    for i in range(steps):
        p.requires_grad_(True)
        loss = loss_fn(p)
        (g,) = torch.autograd.grad(loss, p)
        with torch.no_grad():
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g ** 2
            t = i + 1
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            p = p - lr * mhat / (torch.sqrt(vhat) + eps)
        losses.append(loss.detach())
    return p, torch.stack(losses)


def fit_piecewise(samples: Sequence[Sample], *,
                  own_knots: Sequence[float] | None = None,
                  ext_knots: Sequence[float] | None = None,
                  n_knots: int = 5, steps: int = 300, lr: float = 0.01,
                  ridge: float = 1e-3,
                  monotonicity_weight: float = 100.0,
                  warm_start: PiecewiseModel | None = None,
                  anchor_weight: float = 1e-3,
                  device=None) -> CalibrationResult:
    """Fit a monotone :class:`PiecewiseModel` surface by least squares.

    Given fixed knots the hat-basis prediction is *linear* in the table
    values, so the unconstrained optimum is one ``lstsq`` solve: the
    design matrix row of sample ``n`` is the outer product of its own/ext
    hat weights, Tikhonov-regularized toward the inverse-distance warm
    start so knots without sample support stay anchored instead of going
    to the minimum-norm zero.  Adam then polishes under the monotonicity
    penalty (only active when measurement noise makes the raw optimum
    non-monotone), and the result is exactly projected onto
    {monotone in both axes, >= 1}.

    The solve uses the ``gels`` (QR) driver, the one ``torch.linalg.lstsq``
    has on CUDA, on the CPU too; the ridge rows keep the system full rank.

    **Warm-start mode** (``warm_start=<previous PiecewiseModel>``): the
    streaming re-fit path.  Knot grids and the initial table come from the
    previous surface — no design matrix, no ``lstsq`` — and Adam polishes
    from there, with a weak ``anchor_weight`` pull toward the previous
    table so knots the new sample window does not cover hold their
    calibrated values instead of drifting.  Each online re-fit is a cheap
    polish of the live surface, and knot geometry stays fixed across the
    whole recalibration lineage (refit tables stay comparable and plan
    caches keyed on the model keep their locality).
    """
    from ..kernels.ref import _hat_weights, piecewise_slowdown

    device = resolve_device(device)
    own, ext, sd = _as_arrays(samples)
    if warm_start is not None:
        if own_knots is not None or ext_knots is not None:
            raise ValueError(
                "warm_start fixes the knot grids; do not pass "
                "own_knots/ext_knots alongside it")
        ok = np.asarray(warm_start.own_knots, dtype=float)
        ek = np.asarray(warm_start.ext_knots, dtype=float)
    else:
        ok = np.asarray(own_knots if own_knots is not None
                        else default_knots(own, n_knots), dtype=float)
        ek = np.asarray(ext_knots if ext_knots is not None
                        else default_knots(ext, n_knots), dtype=float)
    if (np.diff(ok) <= 0).any() or (np.diff(ek) <= 0).any():
        raise ValueError("knots must be strictly increasing")

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    own_t, ext_t, sd_t, ok_t, ek_t = (f32(a) for a in (own, ext, sd, ok, ek))

    if warm_start is not None:
        anchor = np.asarray(warm_start.table, dtype=float)
        init = f32(anchor)
    else:
        # anchor for unsupported knots: inverse-distance-weighted fill (the
        # pccs_from_pairs fitter the paper-calibrated profiles used).
        anchor = np.asarray(pccs_from_pairs(
            list(zip(own, ext, sd)), own_knots=tuple(ok), ext_knots=tuple(ek)
        ).table, dtype=float)
        # unconstrained optimum: ridge-regularized linear least squares.
        ho = _hat_weights(ok_t, own_t)                    # (N, K)
        he = _hat_weights(ek_t, ext_t)                    # (N, M)
        design = (ho[:, :, None] * he[:, None, :]).reshape(len(own), -1)
        r = float(np.sqrt(ridge))
        a = torch.cat([design, r * torch.eye(design.shape[1],
                                             device=device)])
        b = torch.cat([sd_t, r * f32(anchor.ravel())])
        init = torch.linalg.lstsq(a, b[:, None], driver="gels").solution
        init = init.reshape(len(ok), len(ek))

    anchor_t = f32(anchor)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def loss_fn(table):
        pred = piecewise_slowdown(own_t, ext_t, ok_t, ek_t, table)
        mse = torch.mean((pred - sd_t) ** 2)
        # physical constraints as penalties; exact projection afterwards.
        # torch.minimum against a zero tensor splits the gradient at a tie
        # as jnp.minimum does (clamp would not).
        neg_own = torch.minimum(torch.diff(table, dim=0), zero)
        neg_ext = torch.minimum(torch.diff(table, dim=1), zero)
        floor = torch.minimum(table - 1.0, zero)
        pen = (torch.sum(neg_own ** 2) + torch.sum(neg_ext ** 2)
               + torch.sum(floor ** 2))
        loss = mse + monotonicity_weight * pen
        if warm_start is not None:
            # weak pull toward the previous surface: unobserved knots keep
            # their calibrated values across streaming re-fits.
            loss = loss + anchor_weight * torch.mean((table - anchor_t) ** 2)
        return loss

    init_np = init.detach().cpu().numpy()
    already_feasible = warm_start is None and (
        (np.diff(init_np, axis=0) >= 0).all()
        and (np.diff(init_np, axis=1) >= 0).all()
        and (init_np >= 1.0).all())
    if already_feasible or steps <= 0:
        # the lstsq optimum is feasible: polishing could only trade fit
        # quality for nothing, so keep it exactly.
        with torch.no_grad():
            loss0 = loss_fn(init)
        table, losses = init, torch.stack([loss0, loss0])
        steps = 0
    else:
        table, losses = _adam(loss_fn, init, steps, lr)
    # exact projection onto {monotone in both axes, >= 1}.
    tab = np.maximum(1.0, table.detach().cpu().numpy())
    tab = np.maximum.accumulate(tab, axis=0)
    tab = np.maximum.accumulate(tab, axis=1)
    model = PiecewiseModel(tuple(ok), tuple(ek),
                           tuple(tuple(float(v) for v in row)
                                 for row in tab))
    pred = np.asarray([model.slowdown(o, e) for o, e in zip(own, ext)])
    return CalibrationResult(model, _report(
        pred, sd, steps, float(losses[0]), float(losses[-1])))


def proportional_predict(own, ext, capacity, sensitivity):
    """Vectorized :meth:`ProportionalShareModel.slowdown` (torch tensors).

    The differentiable form the proportional fitter optimizes.  Must stay
    numerically identical to the scalar model on every input (including
    the own=0 and total==capacity boundaries).  ``torch.minimum`` and
    ``torch.maximum`` against one-tensors split the gradient at a tie as
    ``jnp.minimum``/``jnp.maximum`` do.
    """
    one = torch.ones((), dtype=own.dtype, device=own.device)
    total = own + ext
    bound = torch.minimum(one, own / capacity)
    s = 1.0 + sensitivity * bound * (total / capacity - 1.0)
    return torch.where(total <= capacity, one, torch.maximum(one, s))


def fit_proportional(samples: Sequence[Sample], *, steps: int = 400,
                     lr: float = 0.05, device=None) -> CalibrationResult:
    """Fit :class:`ProportionalShareModel`'s (capacity, sensitivity) on
    ``device`` (``cuda`` unless asked otherwise)."""
    import torch.nn.functional as F

    device = resolve_device(device)
    own, ext, sd = _as_arrays(samples)
    own_t, ext_t, sd_t = (torch.as_tensor(a, dtype=torch.float32,
                                          device=device)
                          for a in (own, ext, sd))

    def loss_fn(p):
        cap = F.softplus(p[0])
        sens = F.softplus(p[1])
        pred = proportional_predict(own_t, ext_t, cap, sens)
        return torch.mean((pred - sd_t) ** 2)

    # softplus^-1 of (1.0, 1.5): a neutral proportional-share start.
    p0 = torch.tensor([0.5413, 1.2412], dtype=torch.float32, device=device)
    p, losses = _adam(loss_fn, p0, steps, lr)
    cap = float(F.softplus(p[0]))
    sens = float(F.softplus(p[1]))
    model = ProportionalShareModel(capacity=cap, sensitivity=sens)
    pred = np.asarray([model.slowdown(o, e) for o, e in zip(own, ext)])
    return CalibrationResult(model, _report(
        pred, sd, steps, float(losses[0]), float(losses[-1])))


def fit(samples: Sequence[Sample], kind: str = "piecewise",
        **kwargs) -> CalibrationResult:
    """Dispatch by model kind (the CLI's ``--fit`` knob)."""
    if kind == "piecewise":
        return fit_piecewise(samples, **kwargs)
    if kind == "proportional":
        return fit_proportional(samples, **kwargs)
    raise ValueError(
        f"unknown fit kind {kind!r}; one of: piecewise, proportional")
