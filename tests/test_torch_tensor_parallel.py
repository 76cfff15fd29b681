"""Port parity of tensor-parallel serving: a model built on a mesh of
``gloo`` ranks under ``cfg.serve_rules`` against ``repro`` under GSPMD.

``repro`` runs in one subprocess on four emulated host devices
(``--xla_force_host_platform_device_count``), as the reference's dry run
builds its cells: ``jax.jit(..., in_shardings=tree_shardings(...))`` over
params, caches and batch with backend ``xla``.  The port's ranks
(``tests/_ranks.py``: a ``FileStore`` under ``tmp_path``, timeouts on
the rendezvous, the collectives and the join) load the reference's
weights cut to each rank (``convert.shard_params``).

* Prefill logits and 4 decode steps at meshes (1, 2) and (2, 2), float32
  at the reduced widths, within atol = rtol = 1e-5, for dense GQA
  (llama3.2-3b), RG-LRU + local attention with one kv head
  (recurrentgemma-9b, its prompt past the window, so the ring cache
  wraps), RWKV-6 and both MoE models (``RULES_TP_2D``); the same against
  the port's one-device model; a capacity the model axis does not divide
  (the replicated cache) and a batch the data axis does not divide.
* The collectives every rank issued equal those the dry run plans for
  the same pass on a mesh description, and written as HLO lines they
  give ``repro``'s ``parse_collectives`` the port's ``CollectiveStats``.
* The decode kernel's partials (split pass) over tp chunks, combined,
  against ``repro.kernels.ops.decode_attention`` at
  ``tests/test_kernels.py``'s tolerances.

The zero-initialised leaves (``conv_w``, ``conv_b``, ``u``,
``w_lora_b``) are filled with seeded values before either package runs,
as ``tests/test_torch_recurrent.py`` does.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _ranks
from repro.analysis import roofline as jroof
from repro.kernels import ops as jops
from repro_torch import configs as tconfigs
from repro_torch.analysis import roofline as troof
from repro_torch.kernels import decode_attention as tdec
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build, collectives

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
STEPS = 4
#: (name, arch, mesh, capacity, batch, prompt length)
CASES = (("llama12", "llama3.2-3b", (1, 2), 24, 2, 11),
         ("llama12_odd", "llama3.2-3b", (1, 2), 23, 2, 11),
         ("rgemma12", "recurrentgemma-9b", (1, 2), 48, 2, 37),
         ("rwkv12", "rwkv6-7b", (1, 2), 24, 2, 11),
         ("dbrx12", "dbrx-132b", (1, 2), 24, 2, 11),
         ("qwen12", "qwen3-moe-235b-a22b", (1, 2), 24, 2, 11),
         ("llama22", "llama3.2-3b", (2, 2), 24, 2, 11),
         ("llama22_odd", "llama3.2-3b", (2, 2), 23, 3, 11),
         ("rgemma22", "recurrentgemma-9b", (2, 2), 48, 2, 37),
         ("rwkv22", "rwkv6-7b", (2, 2), 24, 2, 11),
         ("dbrx22", "dbrx-132b", (2, 2), 24, 2, 11),
         ("qwen22", "qwen3-moe-235b-a22b", (2, 2), 24, 2, 11))
NAMES = [c[0] for c in CASES]


_REFERENCE = r"""
import json, math, pathlib, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.launch.dryrun import batch_logical, cache_logical
from repro.models import build, sharding
from repro_torch import configs as tconfigs
from repro_torch.models.convert import params_from_jax
out, cases, steps = pathlib.Path(sys.argv[1]), json.loads(sys.argv[2]), \
    int(sys.argv[3])
FILL = ("conv_w", "conv_b", "u", "w_lora_b")
host = lambda tree: jax.tree.map(np.asarray, tree)
for name, arch, sizes, cap, B, S in cases:
    cfg = configs.get(arch).reduced()
    rules = cfg.serve_rules
    model = build(cfg, rules=rules, backend="xla")
    rng = np.random.default_rng(7)

    def fill(path, x):
        if getattr(path[-1], "key", None) not in FILL:
            return np.asarray(x)
        fan = x.shape[-2] if x.ndim > 1 and x.shape[-2] > 4 else x.shape[-1]
        return (rng.standard_normal(x.shape) * fan ** -0.5).astype(x.dtype)
    params = jax.tree_util.tree_map_with_path(
        fill, model.init(jax.random.PRNGKey(0)))
    ids = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab, (steps, B, 1)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:math.prod(sizes)]).reshape(sizes),
                ("data", "model"))

    def sh(logical, tree):
        return sharding.tree_shardings(mesh, rules, logical, tree)
    with mesh:
        p_sh = sh(model.specs(), params)
        batch = {"token_ids": ids}
        logits, caches = jax.jit(
            lambda p, b: model.prefill(p, b, capacity=cap),
            in_shardings=(p_sh, sh(batch_logical(batch), batch)))(
                params, batch)
        got = [np.asarray(logits)]
        c_sh = sh(cache_logical(model), caches)
        step = None
        for i, t in enumerate(toks):
            batch = {"token_ids": t,
                     "lengths": np.full((B,), S + i, np.int32)}
            if step is None:
                step = jax.jit(model.decode_step, in_shardings=(
                    p_sh, c_sh, sh(batch_logical(batch), batch)))
            logits, caches = step(params, host(caches), batch)
            got.append(np.asarray(logits))
    state = params_from_jax(tconfigs.get(arch).reduced(), params)
    np.savez(out / f"{name}.npz", ids=ids, toks=toks, cap=cap,
             logits=np.stack(got),
             **{f"state.{k}": v.numpy() for k, v in state.items()})
(out / "done").write_text("ok")
"""


class _Reference:
    """``repro``'s run in a subprocess, started with the module;
    :meth:`result` waits for it."""

    def __init__(self, out):
        self.out = out
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        self.log = open(out / "reference.log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(out), json.dumps(CASES),
             str(STEPS)], env=env, stdout=self.log, stderr=subprocess.STDOUT)

    def result(self) -> pathlib.Path:
        rc = self.proc.wait(timeout=300)
        assert rc == 0, (self.out / "reference.log").read_text()[-4000:]
        return self.out

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    run = _Reference(tmp_path_factory.mktemp("tp_reference"))
    try:
        yield run.result()
    finally:
        run.close()


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Every rank's results, by mesh: the 2-rank group's and the 4-rank
    group's, run at once."""
    store = tmp_path_factory.mktemp("tp_store")
    started = {}
    try:
        for sizes in ((1, 2), (2, 2)):
            cases = [(name, arch, str(reference / f"{name}.npz"))
                     for name, arch, s, *_ in CASES if s == sizes]
            started[sizes] = _ranks.start(_ranks.tp_ranks, sizes[0] * sizes[1],
                                          store / str(sizes[0]), sizes, cases)
        return {sizes: _ranks.collect(s) for sizes, s in started.items()}
    finally:
        for s in started.values():
            _ranks.stop(s)


def case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_serving_equals_the_reference(name, reference, ranks):
    """Every rank returns the whole batch's logits, the reference's."""
    sizes = case(name)[2]
    want = _ranks.tp_case(reference / f"{name}.npz")[4]
    for r, res in enumerate(ranks[sizes]):
        for i, got in enumerate(res[name]["logits"]):
            np.testing.assert_allclose(got, want[i], **TOL,
                                       err_msg=f"{name} rank {r} pass {i}")


@pytest.mark.parametrize("name", NAMES)
def test_mesh_serving_equals_one_device(name, reference, ranks):
    """The port's one-device model on the same weights gives the same
    logits, and rank 0's logits equal them."""
    _, arch, sizes, *_ = case(name)
    state, ids, toks, cap, _ = _ranks.tp_case(reference / f"{name}.npz")
    model = build(tconfigs.get(arch).reduced(), device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        one = _ranks.serve_pass(model, ids, toks, cap)
    for i, got in enumerate(ranks[sizes][0][name]["logits"]):
        np.testing.assert_allclose(got, one[i], **TOL, err_msg=f"pass {i}")


@pytest.mark.parametrize("name", NAMES)
def test_the_dry_run_plans_the_collectives_the_ranks_issue(name, ranks):
    sizes = case(name)[2]
    for r, res in enumerate(ranks[sizes]):
        got = res[name]
        assert got["records"] == got["planned"], (name, r)
        assert got["records"], name


def test_the_cache_is_split_by_sequence_where_it_divides(ranks):
    """A KV cache of 24 slots holds 12 a rank on the model axis; one of
    23 stays whole (the divisibility fallback)."""
    res = ranks[(1, 2)][0]
    assert res["llama12"]["kv_bytes"] * 2 == res["llama12_odd"]["kv_bytes"] \
        * 24 // 23
    one = build(tconfigs.get("llama3.2-3b").reduced(), device="cpu")
    whole = sum(t.numel() * t.element_size()
                for c in one.init_cache(2, 24) for x in c.values()
                for t in x.values())
    assert res["llama12"]["kv_bytes"] * 2 == whole


@pytest.mark.parametrize("name", ["llama12", "dbrx22", "rgemma22"])
def test_recorded_collectives_parse_as_the_reference_parses(name, ranks):
    """The ranks' records, written as HLO lines, give ``repro``'s
    ``parse_collectives`` the port's ``CollectiveStats``."""
    recs = ranks[case(name)[2]][0][name]["records"]
    text = collectives.hlo_text(recs)
    want, got = jroof.parse_collectives(text), troof.parse_collectives(text)
    assert got.op_counts == want.op_counts and sum(got.op_counts.values()) \
        == len(recs)
    assert got.operand_bytes == want.operand_bytes
    assert got.moved_bytes == want.moved_bytes
    assert got.top == [tuple(t) for t in want.top]


def test_a_production_cell_parses_as_the_reference_parses():
    """A decode cell of dbrx-132b planned on the (16, 16) mesh: its
    reduce-scatters, all-gathers and all-reduces by the reference's
    formulas."""
    cfg = tconfigs.get("dbrx-132b")
    recs, _ = dryrun.mesh_pass(dryrun.serve_config(cfg),
                               dryrun.SHAPES["decode_32k"],
                               tmesh.make_production_mesh())
    text = collectives.hlo_text(recs)
    want, got = jroof.parse_collectives(text), troof.parse_collectives(text)
    assert got.op_counts == want.op_counts
    assert {"all-reduce", "all-gather", "reduce-scatter"} <= set(
        got.op_counts)
    assert (got.operand_bytes, got.moved_bytes) == (want.operand_bytes,
                                                    want.moved_bytes)


# ---------------------------------------------------------------------------
# the decode kernel's split pass over chunks, and its combine
# ---------------------------------------------------------------------------

S = 192
GROUPS = {1: (2, 2), 3: (6, 2), 16: (16, 1)}      # G -> (Hq, Hkv)
D = 32
KTOL = dict(atol=2e-5, rtol=2e-5)                 # tests/test_kernels.py


def _lengths(tp: int) -> list[int]:
    c = S // tp
    return sorted({0, 1, c - 1, c, c + 1, 2 * c, S - 1, S})


@pytest.fixture(scope="module", params=sorted(GROUPS), ids=lambda g: f"G{g}")
def decode_inputs(request):
    G = request.param
    Hq, Hkv = GROUPS[G]
    lengths = sorted(set(sum((_lengths(tp) for tp in (2, 3, 4)), [])))
    B = len(lengths)
    rng = np.random.default_rng(G)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    want = np.asarray(jops.decode_attention(
        *(jnp.asarray(x) for x in (q, k, v)),
        jnp.asarray(np.array(lengths, np.int32)),
        backend="pallas_interpret"))
    return (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            lengths, want)


def _chunked(q, k, v, lengths, tp, splits=1):
    """Every chunk's partials, concatenated, through the combine."""
    c = S // tp
    parts = [tdec.decode_attention_partials_torch(
        q, k[:, r * c:(r + 1) * c], v[:, r * c:(r + 1) * c], lengths,
        r * c, splits) for r in range(tp)]
    return tdec.decode_attention_combine(torch.cat([p[0] for p in parts], 2),
                                         torch.cat([p[1] for p in parts], 2))


@pytest.mark.parametrize("tp", [1, 2, 3, 4])
@pytest.mark.parametrize("splits", [1, 3])
def test_partials_over_chunks_equal_the_reference(decode_inputs, tp, splits):
    q, k, v, lengths, want = decode_inputs
    got = _chunked(q, k, v, torch.tensor(lengths, dtype=torch.int32), tp,
                   splits)
    np.testing.assert_allclose(got.numpy(), want, **KTOL)
    zero = [i for i, n in enumerate(lengths) if n == 0]
    assert zero and not got[zero].abs().any()      # length 0 gives 0


def test_ring_chunks_take_the_clamped_length(decode_inputs):
    """A ring cache's valid count is ``min(length, capacity)``: lengths
    past the cache read all of it, over every chunk."""
    q, k, v, lengths, _ = decode_inputs
    past = torch.tensor([S + 1 + i for i in range(len(lengths))],
                        dtype=torch.int32)
    want = np.asarray(jops.decode_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)),
        jnp.asarray(np.minimum(past.numpy(), S)), backend="pallas_interpret"))
    for tp in (2, 4):
        got = _chunked(q, k, v, past.clamp_max(S), tp)
        np.testing.assert_allclose(got.numpy(), want, **KTOL)


def test_empty_chunks_contribute_nothing():
    """A chunk at or past the length gives m = -1e30, l = 0, acc = 0."""
    q, k = torch.randn(2, 1, 4, 16), torch.randn(2, 64, 2, 16)
    ml, acc = tdec.decode_attention_partials_torch(
        q, k, k, torch.tensor([0, 10], dtype=torch.int32), 10, splits=2)
    assert (ml[..., 0] == -1e30).all() and not ml[..., 1].any()
    assert not acc.any()


def test_the_engine_refuses_a_model_on_a_mesh():
    """``ServingEngine`` has no tensor-parallel mode (nor has the
    reference's): a model built on a mesh is refused, a one-device one
    served."""
    from repro_torch.serve.engine import ServingEngine
    cfg = tconfigs.get("llama3.2-3b").reduced()
    mesh = tmesh.Mesh(("data", "model"), (1, 2))
    with pytest.raises(ValueError, match="built on a mesh"):
        ServingEngine(build(cfg, device="cpu", mesh=mesh,
                            rules=cfg.serve_rules), capacity=16)
    ServingEngine(build(cfg, device="cpu", mesh=tmesh.make_host_mesh()),
                  capacity=16)
