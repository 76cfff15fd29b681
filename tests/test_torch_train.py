"""Port parity: training (``repro_torch.{data,train}``, ``Model.loss_fn``
and the training layout) against ``repro``.

The same inputs, made with numpy from a seed, go through both packages on
the CPU in float32: the data pipeline (bit for bit), both optimizers over
the reference's stacked leaves (1e-6 relative), the loss and gradients of
every reduced architecture (1e-5 / 1e-4 relative; the reference runs its
``xla`` backend, the twin of the port's ``torch`` backend), the
``rmsnorm`` backward in bfloat16 (``tests/test_kernels.py``'s bf16
tolerance), multi-step ``Trainer`` runs (1e-5) and checkpoints in both
directions (exactly).

``init_rglru`` and ``init_rwkv`` leave ``conv_w``, ``conv_b``, ``u`` and
``w_lora_b`` at zero, so the reference's params get seeded values there
before both packages use them (``test_torch_recurrent.perturb``).
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jdata
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import ops as tops
from repro_torch.models import build as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import leaves_from_jax
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

from test_torch_recurrent import perturb

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
OPT_RTOL = 1e-6
TRAIN_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    """max |got - want| / max |want| (0 when both are 0)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    diff = float(np.abs(got - want).max()) if want.size else 0.0
    return diff if scale == 0.0 else diff / scale


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1234, 99])
@pytest.mark.parametrize("step", [0, 1, 17, 1000])
@pytest.mark.parametrize("rank", [0, 1])
def test_synthetic_batches_bit_equal(seed, step, rank):
    jcfg = jdata.DataConfig(vocab=1000, seq_len=33, global_batch=8,
                            seed=seed)
    tcfg = tdata.DataConfig(vocab=1000, seq_len=33, global_batch=8,
                            seed=seed)
    want = jdata.SyntheticLM(jcfg, rank, 2).batch_at(step)
    got = tdata.SyntheticLM(tcfg, rank, 2).batch_at(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_file_backed_batches_bit_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 50_000, 10_007).astype(
        np.int32).tofile(path)
    for rank in (0, 1):
        want = jdata.FileBackedLM(str(path), jdata.DataConfig(
            50_000, 31, 6), rank, 2)
        got = tdata.FileBackedLM(str(path), tdata.DataConfig(
            50_000, 31, 6), rank, 2)
        for step in (0, 3, 57):
            a, b = want.batch_at(step), got.batch_at(step)
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])


def test_to_device_keeps_values():
    batch = tdata.SyntheticLM(tdata.DataConfig(100, 8, 2)).batch_at(0)
    out = tdata.to_device(batch, "cpu")
    for k, v in batch.items():
        assert out[k].dtype == torch.int32
        np.testing.assert_array_equal(out[k].numpy(), v)


# ---------------------------------------------------------------------------
# optimizers over the reference's leaves
# ---------------------------------------------------------------------------
#: a stacked norm scale (G, d), a 4-D stacked wq (G, d, H, dh), a 1-D
#: leaf, a 2-D table and a 3-D stacked expert weight
LEAVES = {"emb/final_ln": (24,), "emb/tok": (40, 24),
          "groups/0/c/wi": (2, 3, 24, 20), "groups/0/t/ln": (2, 24),
          "groups/0/t/wq": (2, 24, 4, 6)}


def leaf_draws(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in LEAVES.items()}


def tree_leaves(tree):
    return leaves_from_jax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", dict(weight_decay=0.0)),
    ("adafactor", {}), ("adafactor", dict(weight_decay=0.1)),
    ("adafactor", dict(clip_threshold=0.05))])
@pytest.mark.parametrize("steps", [1, 3])
def test_optimizer_matches_reference(name, kw, steps):
    lr = 3e-3 if name == "adamw" else 1e-2
    jo, to = jopt.make(name, lr, **kw), topt.make(name, lr, **kw)
    params = leaf_draws(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    assert tree_leaves(js).keys() == {k: 0 for k in tckpt.flatten(ts)}.keys()
    for step in range(steps):
        grads = leaf_draws(10 + step)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp, jnp.asarray(step, jnp.int32))
        tu, ts_new = to.update({k: torch.from_numpy(v) for k, v in
                                grads.items()}, ts, tp, step)
        for k in params:
            assert rel(tu[k], ju[k]) <= OPT_RTOL, (step, k)
        jp = {k: (jp[k].astype(jnp.float32) + ju[k]) for k in jp}
        # the in-place form gives the functional form's numbers
        to.apply_({k: torch.from_numpy(v) for k, v in grads.items()}, ts,
                  tp, step)
        for path, t in tckpt.flatten(ts_new).items():
            assert torch.equal(t, tckpt.flatten(ts)[path]), path
    want_s = tree_leaves(js)
    for path, t in tckpt.flatten(ts).items():
        assert t.shape == want_s[path].shape, path
        assert rel(t, want_s[path]) <= OPT_RTOL, path
    for k in params:
        assert rel(tp[k], jp[k]) <= OPT_RTOL, k


def test_adafactor_factors_the_reference_leaves():
    """A stacked (G, d) norm is factored over its layer axis; a 4-D wq
    over (H, dh); a 1-D leaf is not factored."""
    s = topt.adafactor(1e-2).init(
        {k: torch.zeros(v) for k, v in LEAVES.items()})
    assert set(s["groups/0/t/ln"]) == {"vr", "vc"}
    assert s["groups/0/t/ln"]["vr"].shape == (2,)
    assert s["groups/0/t/ln"]["vc"].shape == (24,)
    assert s["groups/0/t/wq"]["vr"].shape == (2, 24, 4)
    assert s["groups/0/t/wq"]["vc"].shape == (2, 24, 6)
    assert set(s["emb/final_ln"]) == {"v"}


@pytest.mark.parametrize("step", [0, 50, 100, 5000, 10000])
def test_warmup_cosine(step):
    want = float(jopt.warmup_cosine(3e-4)(jnp.asarray(step, jnp.int32)))
    got = float(topt.warmup_cosine(3e-4)(step))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm(max_norm):
    grads = leaf_draws(7)
    jg, jn = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    tg, tn = topt.clip_by_global_norm(
        {k: torch.from_numpy(v.copy()) for k, v in grads.items()}, max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for k in grads:
        assert rel(tg[k], jg[k]) <= OPT_RTOL


# ---------------------------------------------------------------------------
# loss and gradients of every reduced architecture
# ---------------------------------------------------------------------------
def reference_params(cfg, seed=0):
    params = jbuild(cfg).init(jax.random.PRNGKey(seed))
    return perturb(jax.tree.map(np.asarray, params),
                   np.random.default_rng(seed + 1))


def train_model(tcfg, params, device="cpu"):
    model = tbuild(tcfg, backend="torch", device=device, layout="train")
    flat = leaves_from_jax(params)
    assert list(flat) == list(model.leaves)
    with torch.no_grad():
        for k, v in flat.items():
            model.leaves[k].copy_(torch.from_numpy(v))
    return model


def make_batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.embeds_only:
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    else:
        batch["token_ids"] = rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)
    if cfg.mm_prefix:
        batch["mm_embeds"] = rng.standard_normal(
            (B, cfg.mm_prefix, cfg.mm_embed_dim)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg = jconfigs.get(arch).reduced(), tconfigs.get(arch).reduced()
    params = reference_params(jcfg)
    batch = make_batch(jcfg)
    jm = jbuild(jcfg, backend="xla")
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                 batch.items()}), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model = train_model(tcfg, params)
    tl, tmet = model.loss_fn({k: torch.from_numpy(v) for k, v in
                              batch.items()})
    tl.backward()
    assert rel(tl, jl) <= LOSS_RTOL
    assert set(tmet) == set(jmet)
    for k in jmet:
        assert rel(tmet[k], jmet[k]) <= LOSS_RTOL, k
    if jcfg.moe is not None:
        assert float(tmet["moe_aux"].detach()) > 0
        assert float(tmet["moe_z"].detach()) > 0
    want = leaves_from_jax(jax.tree.map(np.asarray, jg))
    assert list(want) == list(model.grads)
    for k, g in want.items():
        assert rel(model.grads[k], g) <= GRAD_RTOL, k
        if np.abs(g).max() > 0:
            assert float(model.grads[k].abs().max()) > 0, k


def test_mm_embeds_reach_the_gradient():
    """internvl2-2b's projector gets a gradient only through the
    multimodal prefix."""
    cfg = tconfigs.get("internvl2-2b").reduced()
    model = train_model(cfg, reference_params(jconfigs.get(
        "internvl2-2b").reduced()))
    batch = make_batch(cfg)
    model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})[
        0].backward()
    assert float(model.grads["emb/mm_proj"].abs().max()) > 0


def test_serving_layout_loss_equals_training_layout():
    cfg = tconfigs.get("stablelm-1.6b").reduced()
    gen = lambda: torch.Generator().manual_seed(5)   # noqa: E731
    serve = tbuild(cfg, device="cpu").init(gen())
    train = tbuild(cfg, device="cpu", layout="train").init(gen())
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    assert torch.equal(serve.loss_fn(batch)[0], train.loss_fn(batch)[0])
    with pytest.raises(ValueError, match="serving layout"):
        train.prefill({"token_ids": batch["token_ids"]})


@pytest.mark.parametrize("shape", [(2, 8, 64), (3, 5, 128)])
def test_rmsnorm_backward_bf16(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jy, vjp = jax.vjp(jlayers.rmsnorm, jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    ty = tlayers.rmsnorm(tx, ts)
    ty.backward(torch.from_numpy(g).bfloat16())
    assert ty.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    assert ts.grad.dtype == torch.float32
    tol = dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(ty.float().detach().numpy(),
                               np.asarray(jy.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), **tol)


def test_remat_changes_nothing():
    cfg = tconfigs.get("recurrentgemma-9b").reduced()
    params = reference_params(jconfigs.get("recurrentgemma-9b").reduced())
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    grads = []
    for remat in (True, False):
        m = train_model(dataclasses.replace(cfg, remat=remat), params)
        m.loss_fn(batch)[0].backward()
        grads.append(m.grads)
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Trainer against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_matches_reference(arch, microbatches):
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(),
                               microbatches=microbatches)
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(),
                               microbatches=microbatches)
    steps = 5
    dcfg = dict(vocab=jcfg.vocab, seq_len=16, global_batch=4, seed=7)
    jt = jtrainer.Trainer(jbuild(jcfg, backend="xla"),
                          jdata.SyntheticLM(jdata.DataConfig(**dcfg)))
    jt.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jt.state.params)
    jhist = jt.run(steps, log_every=1)

    tt = ttrainer.Trainer(train_model(tcfg, params),
                          tdata.SyntheticLM(tdata.DataConfig(**dcfg)))
    tt.state = ttrainer.TrainState(0, tt.model.leaves,
                                   tt.optimizer.init(tt.model.leaves))
    thist = tt.run(steps, log_every=1)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist]
    for a, b in zip(thist, jhist):
        assert set(a) == set(b)
        for k in ("loss", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=TRAIN_RTOL), (a, b)
    want = leaves_from_jax(jax.tree.map(np.asarray, jt.state.params))
    for k, v in want.items():
        assert rel(tt.model.leaves[k], v) <= TRAIN_RTOL, k
    assert tt.state.step == int(jt.state.step) == steps


def test_trainer_refuses_the_serving_layout_and_a_mesh():
    cfg = tconfigs.get("stablelm-1.6b").reduced()
    data = tdata.SyntheticLM(tdata.DataConfig(cfg.vocab, 8, 2))
    with pytest.raises(ValueError, match="layout"):
        ttrainer.Trainer(tbuild(cfg, device="cpu"), data)
    # a mesh is stored, as the reference's Trainer stores it
    mesh = object()
    t = ttrainer.Trainer(tbuild(cfg, device="cpu", layout="train"), data,
                         mesh=mesh)
    assert t.mesh is mesh


def test_loss_falls_on_synthetic_data():
    cfg = tconfigs.get("stablelm-1.6b").reduced()
    model = tbuild(cfg, backend="torch", device="cpu", layout="train")
    t = ttrainer.Trainer(model, tdata.SyntheticLM(tdata.DataConfig(
        cfg.vocab, 32, 8)), optimizer=topt.make("adamw", 3e-3))
    t.init_state(torch.Generator().manual_seed(0))
    hist = t.run(15, log_every=1)
    first, last = hist[0]["loss"], np.mean([h["loss"] for h in hist[-5:]])
    assert last < first
    assert all(np.isfinite(h["grad_norm"]) for h in hist)


# ---------------------------------------------------------------------------
# checkpoints: both directions, atomic, GC, shapes, bitwise restart
# ---------------------------------------------------------------------------
def trained(arch, steps, ckpt_dir=None, microbatches=1):
    cfg = dataclasses.replace(tconfigs.get(arch).reduced(),
                              microbatches=microbatches)
    model = tbuild(cfg, backend="torch", device="cpu", layout="train")
    t = ttrainer.Trainer(model, tdata.SyntheticLM(tdata.DataConfig(
        cfg.vocab, 16, 4, seed=3)), ckpt_dir=ckpt_dir, ckpt_every=2)
    t.restore_or_init(torch.Generator().manual_seed(1))
    if steps:
        t.run(steps, log_every=1)
    return t


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b"])
def test_port_checkpoint_restores_in_reference(arch, tmp_path):
    t = trained(arch, 2)
    tckpt.save(tmp_path, t.state.step, t.state)
    jcfg = jconfigs.get(arch).reduced()
    jm = jbuild(jcfg)
    opt = jopt.make(jcfg.optimizer, 1e-3)
    like = jax.eval_shape(lambda: jtrainer.TrainState(
        jnp.zeros((), jnp.int32), jm.abstract_params(),
        opt.init(jm.abstract_params())))
    got, step = jckpt.restore(tmp_path, like)
    assert step == 2 and int(got.step) == 2
    mine = tckpt.flatten(t.state)
    theirs = leaves_from_jax({"params": jax.tree.map(np.asarray, got.params),
                              "opt": jax.tree.map(np.asarray, got.opt)})
    assert set(theirs) == set(mine) - {"step"}
    for k, v in theirs.items():
        np.testing.assert_array_equal(v, mine[k].numpy(), err_msg=k)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b"])
def test_reference_checkpoint_restores_in_port(arch, tmp_path):
    jcfg = jconfigs.get(arch).reduced()
    jt = jtrainer.Trainer(jbuild(jcfg, backend="xla"), jdata.SyntheticLM(
        jdata.DataConfig(jcfg.vocab, 16, 4)), ckpt_dir=str(tmp_path))
    jt.init_state(jax.random.PRNGKey(2))
    jt.run(2, log_every=1)                  # saves at the end
    t = trained(arch, 0, ckpt_dir=str(tmp_path))
    assert t.state.step == 2
    want = leaves_from_jax({"params": jax.tree.map(np.asarray,
                                                   jt.state.params),
                            "opt": jax.tree.map(np.asarray, jt.state.opt)})
    mine = tckpt.flatten(t.state)
    assert set(want) == set(mine) - {"step"}
    for k, v in want.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)


def test_atomic_save_and_gc(tmp_path):
    state = ttrainer.TrainState(0, {"a": torch.arange(4.0)}, {})
    for step in range(5):
        state.step = step
        tckpt.save(tmp_path, step, state, keep=2)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt_00000003.npz", "ckpt_00000004.npz", "latest"]
    assert tckpt.latest_step(tmp_path) == 4
    assert not list(tmp_path.glob("*.tmp"))


def test_save_failure_leaves_no_partial_file(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        tckpt.save(tmp_path, 1, {"a": torch.zeros(2)})
    assert list(tmp_path.iterdir()) == []
    assert tckpt.latest_step(tmp_path) is None


def test_restore_refuses_a_shape_mismatch_and_shardings(tmp_path):
    tckpt.save(tmp_path, 3, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(tmp_path, {"w": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="shardings have no entry for w"):
        tckpt.restore(tmp_path, {"w": torch.zeros(2, 3)}, shardings={})
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "none", {"w": torch.zeros(2, 3)})


@pytest.mark.parametrize("arch,microbatches", [("stablelm-1.6b", 1),
                                               ("dbrx-132b", 2)])
def test_bitwise_restart(arch, microbatches, tmp_path):
    straight = trained(arch, 4, microbatches=microbatches)
    trained(arch, 2, ckpt_dir=str(tmp_path), microbatches=microbatches)
    resumed = trained(arch, 0, ckpt_dir=str(tmp_path),
                      microbatches=microbatches)
    assert resumed.state.step == 2
    resumed.run(4, log_every=1)
    a, b = tckpt.flatten(straight.state), tckpt.flatten(resumed.state)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_emergency_checkpoint_on_sigterm(tmp_path):
    t = trained("stablelm-1.6b", 0, ckpt_dir=str(tmp_path))
    step_fn = t.step_fn

    def step_then_term(state, batch):
        out = step_fn(state, batch)
        os.kill(os.getpid(), signal.SIGTERM)
        return out
    t.step_fn = step_then_term
    old = signal.getsignal(signal.SIGTERM)
    try:
        with pytest.raises(KeyboardInterrupt, match="emergency"):
            t.run(10)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert tckpt.latest_step(tmp_path) == 1


def test_run_gives_back_the_signal_handler():
    """A run's SIGTERM handler refers to its trainer; left installed, it
    kept the last trainer's model and state alive for the process's life
    (found on the card: 62 GB of a dbrx-132b trainer held after its
    run)."""
    import gc
    import weakref
    old = signal.getsignal(signal.SIGTERM)
    t = trained("stablelm-1.6b", 1)
    assert signal.getsignal(signal.SIGTERM) is old
    ref = weakref.ref(t)
    del t
    gc.collect()
    assert ref() is None


def test_launcher_trains_reduced_on_cpu(capsys):
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", "stablelm-1.6b", "--steps", "3",
                              "--device", "cpu", "--seq-len", "16"]) == 0
    assert "done: final loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the kernel path refuses a gradient
# ---------------------------------------------------------------------------
def test_stub_backend_has_no_matrix_products():
    from torch.utils.flop_counter import FlopCounterMode
    q = torch.randn(1, 8, 4, 16)
    k = torch.randn(1, 8, 2, 16)
    with FlopCounterMode(display=False) as fc:
        out = tops.attention(q, k, k, backend="stub")
    assert out.shape == q.shape and fc.get_total_flops() == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_path_refuses_a_gradient(cuda_device):
    q = torch.randn(1, 64, 4, 64, device=cuda_device, requires_grad=True)
    k = torch.randn(1, 64, 4, 64, device=cuda_device)
    for backend in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="backend='torch'"):
            tops.attention(q, k, k, backend=backend)
    with torch.no_grad():
        assert tops.attention(q, k, k).shape == q.shape
    cfg = tconfigs.get("stablelm-1.6b").reduced()
    model = tbuild(cfg, backend="auto", device=cuda_device, layout="train")
    model.init(torch.Generator(device=cuda_device).manual_seed(0))
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in make_batch(cfg).items()}
    with pytest.raises(RuntimeError, match="backend='torch'"):
        model.loss_fn(batch)
