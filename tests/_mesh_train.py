"""Shared parts of ``tests/test_torch_mesh_train*.py``: the cases' inputs,
``repro``'s GSPMD train step in a subprocess, the port's rank bodies and
the checks the files share.

Each case trains a reduced float32 config for two steps on a mesh.  Its
inputs are made here, with numpy from seeds: the reference's init with
the zero-initialised leaves (``conv_w``, ``conv_b``, ``u``, ``w_lora_b``,
and the norm scales) redrawn (``test_torch_recurrent.perturb``), and two
batches.

* ``repro`` runs in one subprocess on four emulated host devices
  (``--xla_force_host_platform_device_count``): ``jax.jit`` of
  ``make_train_step`` with ``in_shardings=(state_sh, b_sh)`` as
  ``repro.launch.dryrun.build_cell`` builds them (backend ``xla``), and
  the first step's gradients by ``jax.grad`` under the same shardings.
  Both sides take the ``Trainer``'s optimizer (:func:`optimizer`).
* The port runs on ``gloo`` ranks (``tests/_ranks.py``: a ``FileStore``
  under ``tmp_path``, timeouts on the rendezvous, the collectives and the
  join): ``Model(layout="train", mesh=)`` under ``cfg.rules`` from the
  same leaves cut to each rank (``convert.shard_leaves``), the trainer's
  step given the whole batch, and the results gathered whole
  (``convert.gather_leaves``, ``NamedSharding.gather``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: tests/test_torch_train.py's limits
LOSS_RTOL, GRAD_RTOL, TRAIN_RTOL, OPT_RTOL = 1e-5, 1e-4, 1e-5, 1e-4
STEPS = 2


def config(arch: str, M: int = 1, patch: dict | None = None, jax=False):
    """The reduced config of ``arch`` (float32) with ``M`` microbatches
    and ``patch``'s fields, from either package."""
    if jax:
        from repro import configs
    else:
        from repro_torch import configs
    return dataclasses.replace(configs.get(arch).reduced(), microbatches=M,
                               **(patch or {}))


def make_inputs(out: pathlib.Path, cases) -> None:
    """Each case's seeded leaves and batches, ``<name>.in.npz``."""
    import jax
    from repro.models import build
    from repro_torch.models.convert import leaves_from_jax
    from test_torch_recurrent import perturb
    for name, arch, _, B, S, M, patch in cases:
        cfg = config(arch, M, patch, jax=True)
        params = perturb(jax.tree.map(np.asarray, build(cfg).init(
            jax.random.PRNGKey(0))), np.random.default_rng(1))
        params = _fill_norms(params, np.random.default_rng(3))
        rng = np.random.default_rng(2)
        batches = {f"batch{i}.{k}": rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32) for i in range(STEPS) for k in ("token_ids", "labels")}
        np.savez(out / f"{name}.in.npz", **batches, **{
            f"leaf.{k}": v for k, v in leaves_from_jax(params).items()})


def optimizer(cfg, opt_lib):
    """Either package's ``Trainer`` optimizer: ``cfg.optimizer`` under
    ``warmup_cosine(cfg.learning_rate)`` (``build_cell``'s constant rate
    would make AdamW's first update sign(g) lr, so that a gradient at
    rounding level moves a leaf by up to 2 lr between two correct
    sums)."""
    return opt_lib.make(cfg.optimizer, opt_lib.warmup_cosine(
        cfg.learning_rate), **({"weight_decay": cfg.weight_decay}
                               if cfg.optimizer == "adamw" else {}))


def _fill_norms(tree, rng):
    """The norm scales, also zero at init, redrawn as N(0, 0.1^2): a leaf
    that starts at 0 holds only its updates, which carry the gradient's
    per-element rounding, not its rounding against the largest."""
    if isinstance(tree, dict):
        return {k: ((0.1 * rng.standard_normal(np.shape(v))).astype(
            np.float32) if k in ("ln", "final_ln", "ln_t", "ln_c")
            else _fill_norms(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fill_norms(v, rng) for v in tree)
    return tree


def load_inputs(path):
    with np.load(path) as z:
        leaves = {k[5:]: z[k] for k in z.files if k.startswith("leaf.")}
        batches = [{k: z[f"batch{i}.{k}"] for k in ("token_ids", "labels")}
                   for i in range(STEPS)]
    return leaves, batches


_REFERENCE = r"""
import json, math, pathlib, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
sys.path.insert(0, sys.argv[3])
import _mesh_train
from repro.configs.base import ShapeCell
from repro.launch import dryrun
from repro.train import optimizer as opt_lib
from repro.train.trainer import TrainState, make_train_step
from repro_torch.models.convert import leaves_from_jax
out, cases = pathlib.Path(sys.argv[1]), json.loads(sys.argv[2])


def tree_of(like, flat):
    def one(path, x):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", None)))
                       for p in path)
        return jnp.asarray(flat[key])
    return jax.tree_util.tree_map_with_path(one, like)


for name, arch, sizes, B, S, M, patch in cases:
    cfg = _mesh_train.config(arch, M, patch, jax=True)
    leaves, batches = _mesh_train.load_inputs(out / f"{name}.in.npz")
    mesh = Mesh(np.array(jax.devices()[:math.prod(sizes)]).reshape(sizes),
                ("data", "model"))
    with mesh:
        _, (state_abs, _), (state_sh, b_sh), model = dryrun.build_cell(
            arch, "train_4k", mesh, cfg_override=cfg,
            cell_override=ShapeCell("t", S, B, "train"), backend="xla")
        params = tree_of(state_abs.params, leaves)
        opt = _mesh_train.optimizer(cfg, opt_lib)
        state = TrainState(jnp.int32(0), params, opt.init(params))
        step = jax.jit(make_train_step(model, opt, M),
                       in_shardings=(state_sh, b_sh))

        def grads(p, b):
            mbs = [jax.tree.map(lambda x: x[i * (B // M):(i + 1) * (B // M)],
                                b) for i in range(M)]
            gs = [jax.grad(lambda q: model.loss_fn(q, mb)[0])(p)
                  for mb in mbs]
            return jax.tree.map(lambda *g: sum(g) / M, *gs)
        g1 = jax.jit(grads, in_shardings=(state_sh.params, b_sh))(
            params, batches[0])
        losses, gnorms = [], []
        for b in batches:
            state, met = step(jax.device_put(state, state_sh), b)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
    host = lambda t: jax.tree.map(np.asarray, t)
    np.savez(out / f"{name}.ref.npz", losses=np.array(losses),
             gnorms=np.array(gnorms),
             **{f"grad.{k}": v for k, v in leaves_from_jax(host(g1)).items()},
             **{f"leaf.{k}": v for k, v in
                leaves_from_jax(host(state.params)).items()},
             **{f"opt.{k}": v for k, v in
                leaves_from_jax(host(state.opt)).items()})
(out / "done").write_text("ok")
"""


class Reference:
    """``repro``'s run of ``cases`` in a subprocess, started with the
    module; :meth:`result` waits for it."""

    def __init__(self, out: pathlib.Path, cases):
        self.out = out
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        self.log = open(out / "reference.log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(out), json.dumps(cases),
             str(ROOT / "tests")], env=env, stdout=self.log,
            stderr=subprocess.STDOUT)

    def result(self) -> pathlib.Path:
        rc = self.proc.wait(timeout=300)
        assert rc == 0, (self.out / "reference.log").read_text()[-4000:]
        return self.out

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()


def reference(out: pathlib.Path, name: str) -> dict:
    with np.load(out / f"{name}.ref.npz") as z:
        got = {k: z[k] for k in z.files}
    return dict(losses=got["losses"], gnorms=got["gnorms"], **{
        part: {k[len(part) + 1:]: v for k, v in got.items()
               if k.startswith(part + ".")}
        for part in ("grad", "leaf", "opt")})


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _numpy(tree) -> dict:
    from repro_torch.train.checkpoint import flatten
    return {k: v.detach().numpy().copy() for k, v in flatten(tree).items()}


def mesh_model(arch, M, patch, m, leaves):
    """The training model of a case on mesh ``m``, holding this rank's
    blocks of ``leaves``."""
    from repro_torch.models import build
    from repro_torch.models.convert import shard_leaves
    cfg = config(arch, M, patch)
    model = build(cfg, backend="torch", device="cpu", layout="train", mesh=m)
    with torch.no_grad():
        for k, v in shard_leaves(model, leaves).items():
            model.leaves[k].copy_(v)
    return model


def train_ranks(rank, world, sizes, cases, planted=()):
    """Each ``(name, arch, sizes, B, S, M, patch, path)`` of ``cases``:
    two steps of the trainer's step on a mesh of ``sizes`` from the
    case's leaves.  Returns per case each step's loss and gradient norm,
    the first step's (clipped) gradients, the leaves and optimizer state
    after the last step, all whole, and the collectives of the first
    step.  For the names in ``planted``, also the gradients of one
    backward whose gathers for replicated work go back summed (a wrong
    backward that doubles a gradient over the model axis)."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import collectives
    from repro_torch.models.convert import gather_leaves
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import TrainState, make_train_step
    m = tmesh.device_mesh(sizes, device="cpu")
    out = {}
    for name, arch, _, B, S, M, patch, path in cases:
        leaves, batches = load_inputs(path)
        model = mesh_model(arch, M, patch, m, leaves)
        cfg = model.cfg
        opt = opt_lib.for_model(optimizer(cfg, opt_lib), model)
        state = TrainState(0, model.leaves, opt.init(model.leaves))
        step = make_train_step(model, opt, M)
        res = dict(losses=[], gnorms=[], whole=opt.whole)
        for i, b in enumerate(batches):
            collectives.reset()
            state, met = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
            if i == 0:
                res["records"] = list(collectives.records)
                res["grads"] = _numpy(gather_leaves(model, model.grads))
            res["losses"].append(float(met["loss"]))
            res["gnorms"].append(float(met["grad_norm"]))
        collectives.reset()
        res["leaves"] = _numpy(gather_leaves(model))
        res["opt"] = _numpy(_gather_state(state.opt, opt.shardings))
        if name in planted:
            res["planted"] = _planted(arch, M, patch, m, leaves, batches[0])
        out[name] = res
    return out


def _gather_state(state, shardings):
    from repro_torch.train.optimizer import tree_pair
    return tree_pair(state, shardings, lambda t, ns: ns.gather(t))


def _planted(arch, M, patch, m, leaves, batch) -> dict:
    from repro_torch.models import collectives
    from repro_torch.models.convert import gather_leaves
    model = mesh_model(arch, M, patch, m, leaves)
    apply = collectives._AllGather.apply

    def summed(x, mesh, axis, dim, back):
        return apply(x, mesh, axis, dim, "sum")
    collectives._AllGather.apply = summed
    try:
        loss, _ = model.loss_fn({k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        loss.backward()
    finally:
        collectives._AllGather.apply = apply
    return _numpy(gather_leaves(model, model.grads))


def rel(got, want) -> float:
    """max |got - want| / max |want| (0 when both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    diff = float(np.abs(got - want).max()) if want.size else 0.0
    return diff if scale == 0.0 else diff / scale


# ---------------------------------------------------------------------------
# the collectives' gradients, the sharded optimizer, checkpoints
# ---------------------------------------------------------------------------

def collective_grads(rank, world, inputs):
    """Each collective's forward and its gradient on this rank of a
    (1, world) mesh, float64, each under the loss its consumers give
    (``sum(c * y)``): ``inputs`` holds every rank's ``x``, a replicated
    ``xr``, every rank's weights ``cs`` (a gather's split consumer),
    ``ce`` (an entered tensor's and an all-to-all's) and ``crs`` (a
    reduce-scatter's), and the shared ``cg`` and ``ca`` (a gather's and a
    sum's replicated consumers)."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import collectives as C
    m = tmesh.device_mesh((1, world), device="cpu")
    out = {}

    def run(name, fn, x, c):
        x = torch.from_numpy(x).requires_grad_()
        y = fn(x)
        (y * torch.from_numpy(c)).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())

    x = inputs["x"][rank]
    C.reset()
    run("gather_sum", lambda t: C.all_gather(t, m, "model", 1, back="sum"),
        x, inputs["cs"][rank])
    run("gather_own", lambda t: C.all_gather(t, m, "model", 1), x,
        inputs["cg"])
    run("all_reduce", lambda t: C.all_reduce(t, m, "model"), x, inputs["ca"])
    run("enter", lambda t: C.enter(t, m, "model"), inputs["xr"],
        inputs["ce"][rank])
    run("reduce_scatter", lambda t: C.reduce_scatter(t, m, "model", 0), x,
        inputs["crs"][rank])
    run("all_to_all", lambda t: C.all_to_all(t, m, "model"), x,
        inputs["ce"][rank])
    out["records"] = [(op, str(dt), shape, n)
                      for op, dt, shape, n in C.records]
    return out


def optimizer_ranks(rank, world, sizes, cases):
    """Each ``(arch, optimizer, leaves, grads, state)`` of ``cases``: the
    sharded clip and update of a training model of ``arch`` on a mesh of
    ``sizes``, from whole numpy leaves, gradients and a nonzero state cut
    to this rank; returns the norm, and the leaves and state gathered
    whole."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.convert import gather_leaves, shard_leaves
    from repro_torch.train import optimizer as opt_lib
    m = tmesh.device_mesh(sizes, device="cpu")
    out = []
    for arch, name, leaves, grads, state in cases:
        model = mesh_model(arch, 1, None, m, leaves)
        opt = opt_lib.for_model(opt_lib.make(name, 1e-2), model)
        with torch.no_grad():
            for k, v in shard_leaves(model, grads).items():
                model.grads[k].copy_(v)
        st = opt_lib.tree_pair(state, opt.shardings, lambda t, ns: ns.shard_of(
            torch.from_numpy(t)).clone())
        _, norm = opt.clip_by_global_norm(model.grads, 1.0)
        opt.apply_(model.grads, st, model.leaves, 3)
        out.append(dict(norm=float(norm),
                        leaves=_numpy(gather_leaves(model)),
                        state=_numpy(_gather_state(st, opt.shardings)),
                        whole=opt.whole))
    return out


def checkpoint_ranks(rank, world, sizes, arch, path, ckpt_dirs):
    """A ``Trainer`` of ``arch`` on a mesh of ``sizes`` from the case's
    leaves: a step, a checkpoint into ``ckpt_dirs[0]`` (whole leaves,
    written once), the state gathered whole, and the next step's loss;
    then a fresh trainer restored from ``ckpt_dirs[1]`` (another
    package's checkpoint) gathered whole, and the loss of a step from
    it."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.convert import gather_leaves
    from repro_torch.train.trainer import Trainer, TrainState
    m = tmesh.device_mesh(sizes, device="cpu")
    leaves, _ = load_inputs(path)

    def trainer(ckpt_dir):
        model = mesh_model(arch, 1, None, m, leaves)
        data = SyntheticLM(DataConfig(model.cfg.vocab, 16, 4, seed=3))
        return Trainer(model, data, ckpt_dir=ckpt_dir)
    a = trainer(ckpt_dirs[0])
    a.state = TrainState(0, a.model.leaves, a.optimizer.init(a.model.leaves))
    a.run(1)
    saved = dict(leaves=_numpy(gather_leaves(a.model)),
                 opt=_numpy(_gather_state(a.state.opt, a.optimizer.shardings)))
    a.ckpt_dir = None
    next_loss = a.run(2)[-1]["loss"]
    b = trainer(ckpt_dirs[1])
    b.restore_or_init()
    b.ckpt_dir = None
    restored = dict(step=b.state.step, leaves=_numpy(gather_leaves(b.model)),
                    opt=_numpy(_gather_state(b.state.opt,
                                             b.optimizer.shardings)))
    restored["loss"] = b.run(b.state.step + 1)[-1]["loss"]
    return dict(saved=saved, next_loss=next_loss, restored=restored)


# ---------------------------------------------------------------------------
# a preemption, and the host memory of a checkpoint, on the ranks
# ---------------------------------------------------------------------------
PREEMPT_ARCH = "stablelm-1.6b"


def preempt_trainer(m, ckpt_dir=None):
    """A ``Trainer`` of the reduced ``PREEMPT_ARCH`` on mesh ``m`` from
    seeded weights and a fresh AdamW state."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build
    from repro_torch.train.trainer import Trainer
    cfg = config(PREEMPT_ARCH)
    model = build(cfg, backend="torch", device="cpu", layout="train", mesh=m)
    t = Trainer(model, SyntheticLM(DataConfig(cfg.vocab, 16, 4, seed=3)),
                ckpt_dir=ckpt_dir)
    t.init_state(torch.Generator().manual_seed(1))
    return t


def whole_state(t) -> dict:
    """A trainer's leaves and optimizer state gathered whole, keyed as in
    a checkpoint."""
    from repro_torch.models.convert import gather_leaves
    return {**{f"params/{k}": v for k, v in _numpy(gather_leaves(
        t.model)).items()}, **{f"opt/{k}": v for k, v in _numpy(
            _gather_state(t.state.opt, t.optimizer.shardings)).items()}}


def preempt_ranks(rank, world, sizes, flagged, ckpt_dir):
    """A trainer on a mesh of ``sizes`` asked for 4 steps, whose rank
    ``flagged`` alone gets a SIGTERM during its second step (sent from
    its data's ``batch_at``, after the first step's vote); then, in the
    same group, an uninterrupted trainer's 2 steps.  Returns what the
    first raised, its step, and the second's whole state."""
    import signal
    from repro_torch.launch import mesh as tmesh
    m = tmesh.device_mesh(sizes, device="cpu")
    t = preempt_trainer(m, ckpt_dir)
    if rank == flagged:
        batch_at = t.data.batch_at

        def signalled(step):
            if step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return batch_at(step)
        t.data.batch_at = signalled
    raised = None
    try:
        t.run(4)
    except KeyboardInterrupt as exc:
        raised = str(exc)
    u = preempt_trainer(m)
    u.run(2)
    return dict(raised=raised, step=t.state.step, whole=whole_state(u))


class _Live:
    """Weak references to the storages of whole tensors: :meth:`count` is
    how many are still alive, :meth:`add` takes one more."""

    def __init__(self):
        self.refs, self.most = [], 0

    def add(self, t) -> None:
        import weakref
        self.most = max(self.most, self.count())
        self.refs.append(weakref.ref(t.untyped_storage()))

    def count(self) -> int:
        return sum(r() is not None for r in self.refs)


def memory_ranks(rank, world, ckpt_dir, gather_bytes):
    """On a (1, world) mesh, a trainer's save after a step (gathering
    ``gather_bytes`` of a whole array at a time), then a fresh trainer's
    restore of it, watched: at every gather of the save
    (``NamedSharding.gather``) and at every whole array the restore
    reads (its ``place``), how many of the earlier ones are still alive
    (by storage), and the save's conversions to numpy.  Returns those,
    whether this rank wrote, and whether the restored state is the saved
    one bit for bit."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.sharding import NamedSharding
    from repro_torch.train import checkpoint as ckpt
    m = tmesh.device_mesh((1, world), device="cpu")
    ckpt.GATHER_BYTES = gather_bytes
    t = preempt_trainer(m)
    t.run(1)
    t.ckpt_dir = ckpt_dir
    gathered, numpy_calls = _Live(), [0]
    gather, to_numpy, restore = (NamedSharding.gather, ckpt._to_numpy,
                                 ckpt.restore)

    def watched_gather(self, block):
        out = gather(self, block)
        if out is not block:            # a leaf no axis splits stays put
            gathered.add(out)
        return out

    def counted(leaf):
        numpy_calls[0] += 1
        return to_numpy(leaf)
    NamedSharding.gather, ckpt._to_numpy = watched_gather, counted
    try:
        t.save()
    finally:
        NamedSharding.gather, ckpt._to_numpy = gather, to_numpy
    read = _Live()

    def watched_restore(ckpt_dir, like, shardings=None, step=None,
                        place=None):
        def watched(path, whole):
            read.add(whole)
            return place(path, whole)
        return restore(ckpt_dir, like, shardings, step, watched)
    u = preempt_trainer(m, ckpt_dir)
    ckpt.restore = watched_restore
    try:
        u.restore_or_init()
    finally:
        ckpt.restore = restore
    want, got = whole_state(t), whole_state(u)
    return dict(writer=m.coordinate("model") == 0,
                gathers=len(gathered.refs), gathered_most=gathered.most,
                numpy_calls=numpy_calls[0], reads=len(read.refs),
                read_most=read.most, step=u.state.step,
                equal=all(np.array_equal(got[k], v) for k, v in want.items()))


# ---------------------------------------------------------------------------
# the checks the test files share
# ---------------------------------------------------------------------------

def run_cases(cases, tmp_path_factory, planted=()):
    """The reference's results and every rank's, by mesh, all run at once
    (the reference's subprocess beside the rank groups)."""
    import _ranks
    inputs = tmp_path_factory.mktemp("mesh_train")
    make_inputs(inputs, cases)
    ref = Reference(inputs, cases)
    store = tmp_path_factory.mktemp("mesh_train_store")
    started = {}
    try:
        for sizes in sorted({c[2] for c in cases}):
            mine = [c + (str(inputs / f"{c[0]}.in.npz"),) for c in cases
                    if c[2] == sizes]
            started[sizes] = _ranks.start(train_ranks, sizes[0] * sizes[1],
                                          store / str(sizes[0]), sizes, mine,
                                          planted)
        ranks = {sizes: _ranks.collect(s) for sizes, s in started.items()}
        return ref.result(), ranks
    finally:
        for s in started.values():
            _ranks.stop(s)
        ref.close()


def check_step(name, runs, cases) -> None:
    """Every rank's losses and norms are the reference's, and equal bit
    for bit; rank 0's first-step gradients, last leaves and optimizer
    state, gathered whole, are the reference's."""
    out, ranks = runs
    sizes = next(c[2] for c in cases if c[0] == name)
    want = reference(out, name)
    got = ranks[sizes]
    for r, res in enumerate(got):
        res = res[name]
        for i in range(STEPS):
            assert rel(res["losses"][i], want["losses"][i]) <= LOSS_RTOL, \
                (r, i)
            assert rel(res["gnorms"][i], want["gnorms"][i]) <= GRAD_RTOL, \
                (r, i)
        assert res["losses"] == got[0][name]["losses"]
        assert res["gnorms"] == got[0][name]["gnorms"]
    res = got[0][name]
    # the buffers hold the clipped gradients (grad_clip 1.0)
    scale = min(1.0, 1.0 / max(float(want["gnorms"][0]), 1e-9))
    assert set(res["grads"]) == set(want["grad"])
    for k, g in want["grad"].items():
        assert rel(res["grads"][k], g * scale) <= GRAD_RTOL, k
    for k, v in want["leaf"].items():
        assert rel(res["leaves"][k], v) <= TRAIN_RTOL, k
    assert set(res["opt"]) == set(want["opt"])
    for k, v in want["opt"].items():
        assert rel(res["opt"][k], v) <= OPT_RTOL, k


def check_plan(name, runs, cases) -> list:
    """Every rank issued in the first step the collectives the dry run
    plans for it on a mesh description (in order), and the plan
    extrapolated over depth holds the same ones; returns the plan."""
    from collections import Counter
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh
    _, arch, sizes, B, S, M, patch = next(c for c in cases if c[0] == name)
    cfg = config(arch, M, patch)
    desc = tmesh.Mesh(("data", "model"), sizes)
    cell = ShapeCell("t", S, B, "train")
    plan, _ = dryrun.mesh_train_step(cfg, cell, desc, extrapolate=False)
    for res in runs[1][sizes]:
        assert res[name]["records"] == plan, name
    extrapolated, _ = dryrun.mesh_train_step(cfg, cell, desc)
    assert Counter(extrapolated) == Counter(plan)
    return plan


def grads_ranks(rank, world, sizes, cases):
    """Each ``(arch, rules, patch, leaves, batch)`` of ``cases``: one
    backward of a training model of ``arch`` built on a mesh of ``sizes``
    under ``rules``; its gradients gathered whole, and its loss."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import build
    from repro_torch.models.convert import gather_leaves, shard_leaves
    m = tmesh.device_mesh(sizes, device="cpu")
    out = []
    for arch, rules, patch, leaves, batch in cases:
        cfg = config(arch, 1, patch)
        model = build(cfg, backend="torch", device="cpu", layout="train",
                      mesh=m, rules=rules)
        with torch.no_grad():
            for k, v in shard_leaves(model, leaves).items():
                model.leaves[k].copy_(v)
        loss, met = model.loss_fn({k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        loss.backward()
        out.append(dict(loss=float(met["loss"]),
                        grads=_numpy(gather_leaves(model, model.grads))))
    return out
