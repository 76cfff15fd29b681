"""Port parity: online recalibration of repro_torch vs repro.

The drift scenarios of ``tests/test_recalibrate.py`` at a small size,
through both packages' ``StreamingRecalibrator`` on the same samples: the
evidence gating, the refit count and the lineage (every child's
``parent_hash`` is its predecessor's content hash) are equal, and both
re-fits land within the reference's 5% budget of the drifted truth.  The
warm-started Adam polish runs in float32 in both; their tables agree
within the recalibrator's learning rate, 0.05: Adam normalizes every
gradient to a step of up to ``lr``, so an entry whose gradient is near 0
(and of either sign in the two frameworks) can end up to ``lr`` apart.
"""
import json

import numpy as np
import pytest

from repro.core.accelerators import xavier_agx as j_xavier
from repro.core.contention import PiecewiseModel as JPiecewise
from repro.core.contention import ProportionalShareModel as JProportional
from repro.core.profiles import get_graph as j_get_graph
from repro.profiling import ProfileBundle as JBundle
from repro.profiling import StreamingRecalibrator as JRecal
from repro.profiling import paper_like_pccs as j_pccs
from repro.profiling import verify_lineage as j_verify
from repro.profiling.calibrate import fit_piecewise as j_fit_piecewise
from repro.profiling.online import SampleWindow as JWindow
from repro_torch.core.accelerators import xavier_agx as t_xavier
from repro_torch.core.contention import PiecewiseModel as TPiecewise
from repro_torch.core.contention import ProportionalShareModel as TProportional
from repro_torch.core.profiles import get_graph as t_get_graph
from repro_torch.profiling import ProfileBundle as TBundle
from repro_torch.profiling import StreamingRecalibrator as TRecal
from repro_torch.profiling import paper_like_pccs as t_pccs
from repro_torch.profiling import verify_lineage as t_verify
from repro_torch.profiling.calibrate import fit_piecewise as t_fit_piecewise
from repro_torch.profiling.online import SampleWindow as TWindow

from test_torch_core import one_thread  # noqa: F401

BUDGET = 0.05                   # the reference's re-fit budget
TABLE_TOL = 0.05                # StreamingRecalibrator.lr
CPU = "cpu"
TINY = ((0.0, 0.5, 1.0), (0.0, 0.5, 1.0),
        ((1.0, 1.0, 1.0), (1.0, 1.1, 1.2), (1.0, 1.2, 1.4)))


def bundles(j_model, t_model):
    """The same one-graph root bundle in each package."""
    jp, tp = j_xavier(), t_xavier()
    return (JBundle(platform=jp, graphs=(j_get_graph("vgg19", jp),),
                    model=j_model, samples=((0.3, 0.4, 1.1),)),
            TBundle(platform=tp, graphs=(t_get_graph("vgg19", tp),),
                    model=t_model, samples=((0.3, 0.4, 1.1),)))


def drifted(n, seed=7):
    """tests/test_recalibrate.py's drift: a proportional truth."""
    truth = JProportional(capacity=0.6, sensitivity=2.0)
    rng = np.random.default_rng(seed)
    own = rng.uniform(0.1, 0.9, n)
    ext = rng.uniform(0.1, 0.9, n)
    return truth, [(o, e, truth.slowdown(o, e)) for o, e in zip(own, ext)]


def test_roots_hash_alike():
    jb, tb = bundles(JPiecewise(*TINY), TPiecewise(*TINY))
    assert tb.bundle_hash() == jb.bundle_hash()


def test_sample_window_alike():
    stream = [(0.5, 0.5, 0.9), (float("nan"), 0.5, 1.2), (0.1, 0.2, 1.3),
              (-0.1, 0.5, 1.2), (0.5, 0.5, 0.0), (0.2, 0.3, float("inf"))]
    stream += [(0.1, 0.1, 1.0 + i) for i in range(10)]
    jw, tw = JWindow(maxlen=8), TWindow(maxlen=8)
    for s in stream:
        assert tw.observe(*s) == jw.observe(*s)
    assert tw.samples() == jw.samples()
    assert (tw.rejected, tw.new_since_fit) == (jw.rejected, jw.new_since_fit)


def test_gating_and_lineage_alike():
    jb, tb = bundles(JPiecewise(*TINY), TPiecewise(*TINY))
    kw = dict(window=64, min_samples=16, min_new=8, refit_steps=50)
    jr, tr = JRecal(jb, **kw), TRecal(tb, device=CPU, **kw)
    _, samples = drifted(48)
    published = []
    for s in samples:
        jr.observe(*s)
        tr.observe(*s)
        j_child, t_child = jr.step(), tr.step()
        assert (j_child is None) == (t_child is None)
        if t_child is not None:
            published.append(t_child)
    assert len(published) >= 2 and tr.refits == jr.refits == len(published)
    assert tr.lineage[0] is tb
    t_verify(tr.lineage)
    j_verify(jr.lineage)
    for parent, child in zip(tr.lineage, tr.lineage[1:]):
        assert child.parent_hash == parent.bundle_hash()
    assert tr.lineage[1].parent_hash == jr.lineage[1].parent_hash
    assert [e.seq for e in tr.events] == [e.seq for e in jr.events]
    assert tr.bundle.provenance["refit"]["seq"] == tr.refits
    # the port's lineage loads in the reference, link by link
    loaded = [JBundle.from_json(b.to_json()) for b in tr.lineage]
    j_verify(loaded)
    assert [b.bundle_hash() for b in loaded] == [
        b.bundle_hash() for b in tr.lineage]


def test_refit_defaults_to_cuda(monkeypatch):
    """Re-fits run on ``cuda`` unless the recalibrator is given a device,
    and raise where no card is visible."""
    _, tb = bundles(JPiecewise(*TINY), TPiecewise(*TINY))
    tr = TRecal(tb, window=64, min_samples=16, min_new=8)
    for s in drifted(16)[1]:
        tr.observe(*s)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.step()
    assert tr.refits == 0


def test_proportional_seed_refits_to_the_drift():
    jb, tb = bundles(JProportional(capacity=1.0, sensitivity=1.0),
                     TProportional(capacity=1.0, sensitivity=1.0))
    kw = dict(window=256, min_samples=64, min_new=32, refit_steps=400)
    jr, tr = JRecal(jb, **kw), TRecal(tb, device=CPU, **kw)
    truth, samples = drifted(256)
    for s in samples:
        jr.observe(*s)
        tr.observe(*s)
    assert jr.step() is not None and tr.step() is not None
    assert jr.max_rel_err_against(truth) < BUDGET
    assert tr.max_rel_err_against(truth) < BUDGET
    assert tr.model.capacity == pytest.approx(jr.model.capacity, rel=1e-3)
    assert tr.model.sensitivity == pytest.approx(jr.model.sensitivity,
                                                 rel=1e-3)


@pytest.mark.parametrize("inflate,seed", [(1.5, 6), (1.25, 8)])
def test_piecewise_seed_tracks_an_inflated_surface(inflate, seed):
    """A PCCS surface drifts by ``1 + inflate (s - 1)``: the streaming
    re-fit of both packages follows it within the budget."""
    jb, tb = bundles(j_pccs(), t_pccs())
    kw = dict(window=128, min_samples=64, min_new=32)     # 800 steps
    jr, tr = JRecal(jb, **kw), TRecal(tb, device=CPU, **kw)
    base = j_pccs()
    rng = np.random.default_rng(seed)
    own = rng.uniform(0.1, 0.9, 128)
    ext = rng.uniform(0.1, 0.9, 128)
    samples = [(o, e, 1.0 + inflate * (base.slowdown(o, e) - 1.0))
               for o, e in zip(own, ext)]
    for s in samples:
        jr.observe(*s)
        tr.observe(*s)
    assert jr.step() is not None and tr.step() is not None

    class Truth:
        def slowdown(self, o, e):
            return 1.0 + inflate * (base.slowdown(o, e) - 1.0)

    assert jr.max_rel_err_against(Truth()) < BUDGET
    assert tr.max_rel_err_against(Truth()) < BUDGET
    assert tr.model.own_knots == jr.model.own_knots == base.own_knots
    np.testing.assert_allclose(np.asarray(tr.model.table),
                               np.asarray(jr.model.table), atol=TABLE_TOL,
                               rtol=0)
    assert json.loads(tr.bundle.to_json())["parent_hash"] == \
        tb.bundle_hash()


def test_warm_start_polish_alike():
    """tests/test_recalibrate.py's polish of a uniformly inflated surface."""
    tiny = ((0.0, 0.5, 1.0), (0.0, 0.5, 1.0),
            ((1.0, 1.1, 1.2), (1.1, 1.3, 1.5), (1.2, 1.5, 1.9)))
    jprev, tprev = JPiecewise(*tiny), TPiecewise(*tiny)
    rng = np.random.default_rng(6)
    own = rng.uniform(0.05, 0.95, 200)
    ext = rng.uniform(0.05, 0.95, 200)
    sd = [1.0 + 1.5 * (jprev.slowdown(o, e) - 1.0) for o, e in zip(own, ext)]
    samples = list(zip(own, ext, sd))
    kw = dict(steps=600, lr=0.05, anchor_weight=1e-4)
    rj = j_fit_piecewise(samples, warm_start=jprev, **kw)
    rt = t_fit_piecewise(samples, warm_start=tprev, device=CPU, **kw)
    for r in (rj, rt):
        pred = np.asarray([r.model.slowdown(o, e) for o, e in zip(own, ext)])
        assert np.max(np.abs(pred - np.asarray(sd)) / np.asarray(sd)) \
            < BUDGET
    assert rt.model.own_knots == tprev.own_knots
    np.testing.assert_allclose(np.asarray(rt.model.table),
                               np.asarray(rj.model.table), atol=TABLE_TOL,
                               rtol=0)
    with pytest.raises(ValueError, match="warm_start"):
        t_fit_piecewise(samples, warm_start=tprev, own_knots=(0.0, 1.0),
                        device=CPU)
