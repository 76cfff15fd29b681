"""The parts of training on a mesh: the collectives' gradients, the
sharded optimizer, checkpoints from ranks, a model's blocks, and the dry
run's ``train_4k`` cells.

* Each autograd collective on 2 ``gloo`` ranks (float64) against the
  gradient of the whole computation each stands for, written out here:
  a gather feeding split work goes back reduce-scattered, one feeding
  replicated work as this rank's block; a sum of partials as the
  identity, its conjugate (``enter``) as an all-reduce; a reduce-scatter
  as an all-gather; an all-to-all by the same exchange.  The backward's
  collectives are recorded.
* The training forms no reference case takes (RWKV-6 and RG-LRU split
  over "rnn" under ``RULES_FSDP_TP``, a kv head the model axis does not
  divide, the MoE under ``RULES_ZERO3``): one backward on 2 ranks against
  the one-device model's gradients.
* The sharded clip and update (``optimizer.for_model``) on 2 ranks
  against the one-device functions at 1e-6: Adafactor's factored
  moments over dbrx-132b's leaves (FSDP-TP), AdamW over llama3.2-3b's
  (ZeRO-3) and over rwkv6-7b's, some of which are updated whole.
* A checkpoint from 2 ranks restored by ``repro.train.checkpoint`` and
  by a one-device port trainer, and ``repro``'s restored onto the ranks,
  bit for bit; the restored trainer's next loss is the uninterrupted
  one's.
* ``init`` on a mesh keeps the blocks of the one-device model's numbers.
* Every ``train_4k`` cell plans with status ``ok`` on both production
  meshes, and the CLI writes it.
"""
import json

import jax
import numpy as np
import pytest
import torch

import _mesh_train as mt
import _ranks
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.trainer import TrainState as JState
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build
from repro_torch.models.convert import shard_leaves
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import flatten
from repro_torch.train.trainer import Trainer

OPT_RTOL = 1e-6
W = 2                                   # ranks
CKPT_ARCH = "dbrx-132b"
#: the families under the other rules than their own, on (1, 2) against
#: one device: (arch, rules, config fields); recurrentgemma-9b's one kv
#: head stays whole while its query heads split
TP_CASES = (("rwkv6-7b", "RULES_FSDP_TP", None),
            ("recurrentgemma-9b", "RULES_FSDP_TP", None),
            ("llama3.2-3b", "RULES_FSDP_TP", {"n_kv_heads": 1}),
            ("dbrx-132b", "RULES_ZERO3", None))
#: the optimizer cases: (arch, optimizer, mesh)
OPT_CASES = (("dbrx-132b", "adafactor", (1, 2)),
             ("llama3.2-3b", "adamw", (2, 1)),
             ("rwkv6-7b", "adamw", (1, 2)))


def collective_inputs():
    rng = np.random.default_rng(11)

    def n(*shape):
        return rng.standard_normal(shape)
    return dict(x=[n(4, 6) for _ in range(W)], xr=n(4, 6),
                cs=[n(4, 6 * W) for _ in range(W)], cg=n(4, 6 * W),
                ca=n(4, 6), ce=[n(4, 6) for _ in range(W)],
                crs=[n(4 // W, 6) for _ in range(W)])


def optimizer_case(arch, name, seed):
    cfg = tconfigs.get(arch).reduced()
    one = build(cfg, device="cpu", layout="train").init(
        torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    leaves = {k: v.numpy().copy() for k, v in one.leaves.items()}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in leaves.items()}
    # a moment of some steps
    state = _map(topt.make(name, 1e-2).init(one.leaves), lambda t: (np.abs(
        rng.standard_normal(t.shape)) * 1e-3).astype(np.float32))
    return arch, name, leaves, grads, state


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _nest(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def tp_case(arch, rules, patch):
    """Seeded leaves (the zero-init ones and the norms redrawn) and a
    batch for one backward of ``arch`` under ``rules``."""
    from repro_torch.configs import base
    cfg = mt.config(arch, 1, patch)
    one = build(cfg, device="cpu", layout="train").init(
        torch.Generator().manual_seed(9))
    rng = np.random.default_rng(9)
    leaves = {k: (v.numpy().copy() if v.abs().max() > 0 else
                  0.1 * rng.standard_normal(v.shape).astype(np.float32))
              for k, v in one.leaves.items()}
    batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
             for k in ("token_ids", "labels")}
    return arch, getattr(base, rules), patch, leaves, batch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every group's results, all run at once."""
    work = tmp_path_factory.mktemp("mesh_parts")
    mt.make_inputs(work, [("ckpt", CKPT_ARCH, (1, W), 4, 16, 1, None)])
    # repro's checkpoint of a state from the same leaves, step 1
    leaves, _ = mt.load_inputs(work / "ckpt.in.npz")
    jparams = _nest(leaves)
    jstate = JState(np.int32(1), jparams, jax.tree.map(
        lambda x: np.asarray(x) + 1e-3,
        jopt.make(mt.config(CKPT_ARCH, jax=True).optimizer, 1e-3).init(
            jparams)))
    jckpt.save(work / "repro_ckpt", 1, jstate)
    opt_cases = {sizes: [optimizer_case(a, n, i) for i, (a, n, s) in
                         enumerate(OPT_CASES) if s == sizes]
                 for sizes in {c[2] for c in OPT_CASES}}
    started = {}
    try:
        started["coll"] = _ranks.start(mt.collective_grads, W,
                                       work / "s_coll", collective_inputs())
        for sizes, cases in opt_cases.items():
            started[sizes] = _ranks.start(mt.optimizer_ranks, W,
                                          work / f"s_opt{sizes[0]}", sizes,
                                          cases)
        started["tp"] = _ranks.start(mt.grads_ranks, W, work / "s_tp", (1, W),
                                     [tp_case(*c) for c in TP_CASES])
        started["ckpt"] = _ranks.start(
            mt.checkpoint_ranks, W, work / "s_ckpt", (1, W), CKPT_ARCH,
            str(work / "ckpt.in.npz"),
            (str(work / "mesh_ckpt"), str(work / "repro_ckpt")))
        out = {k: _ranks.collect(s) for k, s in started.items()}
    finally:
        for s in started.values():
            _ranks.stop(s)
    out["work"], out["opt_cases"], out["jstate"] = work, opt_cases, jstate
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _expected(inputs):
    """Per op, each rank's (forward, gradient) of the whole computation."""
    x, cs, ce, crs = (inputs[k] for k in ("x", "cs", "ce", "crs"))
    cg, ca, xr = inputs["cg"], inputs["ca"], inputs["xr"]
    cols = [slice(6 * r, 6 * (r + 1)) for r in range(W)]
    rows = [slice(4 // W * r, 4 // W * (r + 1)) for r in range(W)]
    cat = np.concatenate(x, 1)
    total = sum(x)
    a2a = [np.concatenate([x[j][rows[r]] for j in range(W)]) for r in range(W)]
    return {
        "gather_sum": [(cat, sum(c[:, cols[r]] for c in cs))
                       for r in range(W)],
        "gather_own": [(cat, cg[:, cols[r]]) for r in range(W)],
        "all_reduce": [(total, ca) for r in range(W)],
        "enter": [(xr, sum(ce)) for r in range(W)],
        "reduce_scatter": [(total[rows[r]], np.concatenate(crs))
                           for r in range(W)],
        "all_to_all": [(a2a[r], np.concatenate([ce[q][rows[r]]
                                               for q in range(W)]))
                       for r in range(W)],
    }


@pytest.mark.parametrize("op", ["gather_sum", "gather_own", "all_reduce",
                                "enter", "reduce_scatter", "all_to_all"])
def test_collective_gradients(op, ranks):
    want = _expected(collective_inputs())[op]
    for r, res in enumerate(ranks["coll"]):
        y, g = res[op]
        np.testing.assert_allclose(y, want[r][0], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g, want[r][1], rtol=1e-12, atol=1e-12)


def test_the_backward_collectives_are_recorded(ranks):
    ops = [op for op, *_ in ranks["coll"][0]["records"]]
    # gather + reduce-scatter back; gather; sum; enter's sum back; a
    # reduce-scatter + gather back; an exchange each way
    assert ops == ["all-gather", "reduce-scatter", "all-gather", "all-reduce",
                   "all-reduce", "reduce-scatter", "all-gather", "all-to-all",
                   "all-to-all"]


# ---------------------------------------------------------------------------
# every family under either rule set
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(TP_CASES)),
                         ids=[f"{a}-{r}" for a, r, _ in TP_CASES])
def test_other_rules_give_the_one_device_gradients(i, ranks):
    """The tensor-parallel training forms no reference case takes (RWKV-6
    and RG-LRU split over "rnn", a kv head replicated while the query
    heads split) and ZeRO-3 on the MoE: one backward on 2 ranks, gathered
    whole, against the one-device model's (GRAD_RTOL)."""
    arch, rules, patch, leaves, batch = tp_case(*TP_CASES[i])
    one = build(mt.config(arch, 1, patch), backend="torch", device="cpu",
                layout="train")
    with torch.no_grad():
        for k, v in leaves.items():
            one.leaves[k].copy_(torch.from_numpy(v))
    loss, _ = one.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    for res in ranks["tp"]:
        got = res[i]
        assert mt.rel(got["loss"], float(loss)) <= mt.LOSS_RTOL
        for k, g in one.grads.items():
            assert mt.rel(got["grads"][k], g.numpy()) <= mt.GRAD_RTOL, k


# ---------------------------------------------------------------------------
# the sharded optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(OPT_CASES)),
                         ids=[c[0] for c in OPT_CASES])
def test_sharded_update_equals_one_device(i, ranks):
    arch, name, sizes = OPT_CASES[i]
    cases = ranks["opt_cases"][sizes]
    j = [c[0] for c in cases].index(arch)
    _, _, leaves, grads, state = cases[j]
    params = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
    g = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    st = _map(state, lambda t: torch.from_numpy(t.copy()))
    opt = topt.make(name, 1e-2)
    _, norm = topt.clip_by_global_norm(g, 1.0)
    opt.apply_(g, st, params, 3)
    want_state = {k: v.numpy() for k, v in flatten(st).items()}
    for res in ranks[sizes]:
        got = res[j]
        assert got["norm"] == pytest.approx(float(norm), rel=OPT_RTOL)
        for k, v in params.items():
            assert mt.rel(got["leaves"][k], v.numpy()) <= OPT_RTOL, k
        assert set(got["state"]) == set(want_state)
        for k, v in want_state.items():
            assert mt.rel(got["state"][k], v) <= OPT_RTOL, k
    if arch == "rwkv6-7b":
        assert ranks[sizes][0][j]["whole"]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_a_checkpoint_from_ranks_restores_in_repro_and_one_device(ranks):
    work = ranks["work"]
    saved = ranks["ckpt"][0]["saved"]
    like = jax.tree.map(np.asarray, ranks["jstate"])
    got, step = jckpt.restore(work / "mesh_ckpt", like)
    assert step == 1
    flat = _flat_j(got)
    for k, v in saved["leaves"].items():
        np.testing.assert_array_equal(flat[f"params/{k}"], v)
    for k, v in saved["opt"].items():
        np.testing.assert_array_equal(flat[f"opt/{k}"], v)
    # a one-device port trainer restores it too
    cfg = mt.config(CKPT_ARCH)
    t = Trainer(build(cfg, backend="torch", device="cpu", layout="train"),
                None, ckpt_dir=str(work / "mesh_ckpt"))
    t.restore_or_init()
    assert t.state.step == 1
    for k, v in saved["leaves"].items():
        np.testing.assert_array_equal(t.model.leaves[k].numpy(), v)
    for k, v in flatten(t.state.opt).items():
        np.testing.assert_array_equal(v.numpy(), saved["opt"][k])
    # both ranks gathered the same state
    other = ranks["ckpt"][1]["saved"]
    for k, v in saved["leaves"].items():
        np.testing.assert_array_equal(other["leaves"][k], v)


def _flat_j(tree) -> dict:
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(
            p, "name", None)))) for p in path)
        out[key] = np.asarray(v)
    return out


def test_repro_checkpoint_restores_onto_the_ranks(ranks):
    """``repro``'s checkpoint restored on 2 ranks gives each its blocks:
    gathered, the saved arrays bit for bit; the restored trainer steps."""
    want = _flat_j(ranks["jstate"])
    for res in ranks["ckpt"]:
        got = res["restored"]
        assert got["step"] == 1
        for k, v in got["leaves"].items():
            np.testing.assert_array_equal(v, want[f"params/{k}"])
        for k, v in got["opt"].items():
            np.testing.assert_array_equal(v, want[f"opt/{k}"])
        assert np.isfinite(got["loss"])


def test_restart_on_the_mesh_is_bitwise(ranks, tmp_path):
    """A mesh trainer restored from the ranks' own checkpoint takes the
    step the uninterrupted trainer took, bit for bit."""
    work = ranks["work"]
    started = _ranks.start(mt.checkpoint_ranks, W, tmp_path / "s", (1, W),
                           CKPT_ARCH, str(work / "ckpt.in.npz"),
                           (str(tmp_path / "again"), str(work / "mesh_ckpt")))
    try:
        res = _ranks.collect(started)
    finally:
        _ranks.stop(started)
    for r in range(W):
        assert res[r]["restored"]["loss"] == ranks["ckpt"][r]["next_loss"]


# ---------------------------------------------------------------------------
# a model's blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-3b", "dbrx-132b",
                                  "recurrentgemma-9b"])
def test_init_on_a_mesh_keeps_the_one_device_blocks(arch):
    """On a (2, 2) mesh description (rank 0's blocks) every leaf is its
    sharding's block of the one-device model's, drawn from one seed, and
    no leaf is held whole where the rules split it."""
    cfg = tconfigs.get(arch).reduced()
    one = build(cfg, device="cpu", layout="train").init(
        torch.Generator().manual_seed(4))
    desc = tmesh.Mesh(("data", "model"), (2, 2))
    model = build(cfg, device="cpu", layout="train", mesh=desc).init(
        torch.Generator().manual_seed(4))
    blocks = shard_leaves(model, one.leaves)
    split = 0
    for k, v in model.leaves.items():
        assert torch.equal(v, blocks[k]), k
        assert model.grads[k].shape == v.shape
        split += v.numel() < one.leaves[k].numel()
    assert split > len(model.leaves) // 2


# ---------------------------------------------------------------------------
# the dry run's training cells on a mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_every_train_cell_plans_on_the_production_meshes(arch):
    for name, mesh in dryrun.MESHES.items():
        rec = dryrun.mesh_cell(arch, "train_4k", mesh(), name)
        assert rec["status"] == "ok", (name, rec.get("reason"))
        m = rec["memory"]
        assert m["peak_bytes"] >= m["weights_bytes"] * 2 + \
            m["optimizer_bytes"]
        ops = rec["collectives"]["op_counts"]
        assert ops.get("all-gather", 0) > 0
        assert rec["roofline"]["t_collective_ms"] > 0
    cfg = tconfigs.get(arch)
    if cfg.moe is not None:         # 4096 tokens a data shard: all-to-alls
        assert ops["all-to-all"] > 0


def test_cli_writes_mesh_train_records(tmp_path):
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "stablelm-1.6b_train_4k_single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["memory"]["fits"] and rec["memory"]["deepest_depth"] == 24
    assert rec["per_device"]["optimizer_bytes"] == \
        2 * rec["per_device"]["params_bytes"]
    # ZeRO-3: a gather and a reduce-scatter of every weight a layer
    assert rec["collectives"]["op_counts"]["reduce-scatter"] > 24
