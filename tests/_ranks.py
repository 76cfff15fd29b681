"""Rank bodies of ``tests/test_torch_multidevice.py``.

Each body runs in a process of its own, one per rank, started by
:func:`start` or :func:`spawn` (the ``spawn`` start method, so every rank
imports this module afresh: it imports torch and ``repro_torch``, never
jax).  The ranks meet through a ``FileStore`` under the test's
``tmp_path`` (``repro_torch.ranks.init_ranks``), with a timeout on
the rendezvous and on every collective; :func:`collect` waits for every
rank with a timeout of its own and fails on any exit code but 0.
"""
from __future__ import annotations

import dataclasses
import pathlib
import queue
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a rank waits at the rendezvous and in a collective
INIT_TIMEOUT_S = 60.0
#: seconds the test waits for every rank's result and exit
JOIN_TIMEOUT_S = 240.0


def spawn(fn, world: int, store_dir, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` ranks; returns the results
    by rank."""
    return collect(start(fn, world, store_dir, *args))


def start(fn, world: int, store_dir, *args):
    """:func:`spawn` without the wait: the ranks start and run while the
    caller goes on; :func:`collect` waits for them."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, str(store_dir), results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, results, time.monotonic() + JOIN_TIMEOUT_S


def stop(started) -> None:
    """End :func:`start`'s ranks without their results."""
    for p in started[0]:
        if p.is_alive():
            p.kill()
        p.join()


def collect(started) -> list:
    """The results of :func:`start`'s ranks by rank, once every rank has
    given one and exited 0 (the queue drained before the join)."""
    procs, results, deadline = started
    world = len(procs)
    out = {}
    try:
        while len(out) < world:
            try:
                rank, res = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead:
                    raise RuntimeError(f"a rank exited with {dead}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks gave {sorted(out)} of "
                                       f"{world} results in time")
                continue
            out[rank] = res
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


def _entry(fn, rank, world, store_dir, results, args):
    from repro_torch import ranks
    torch.set_num_threads(1)
    ranks.init_ranks(world, rank, store_dir, device="cpu",
                     timeout_s=INIT_TIMEOUT_S)
    try:
        res = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    results.put((rank, res))


def outcome_key(out):
    return (out.assignment, out.objective, out.chain)


# ---------------------------------------------------------------------------
# the ring search
# ---------------------------------------------------------------------------

def search_ranks(rank, world, problems):
    """Every rank runs each ``(tables, kw)`` of ``problems`` at
    ``devices=world``; then a call whose ``devices`` is not the world size,
    and one in which rank 1 fails before its first step."""
    from repro_torch.core import search_torch
    from repro_torch.ranks import RankFailure
    got = [search_torch.anneal_search(t, devices=world, device="cpu", **kw)
           for t, kw in problems]
    res = {"keys": [outcome_key(o) for o in got],
           "resolved": [(o.devices, o.migrate, o.fanout) for o in got]}
    tables, kw = problems[0]
    try:
        search_torch.anneal_search(tables, devices=2 * world, device="cpu",
                                   **kw)
    except ValueError as exc:
        res["wrong_devices"] = str(exc)
    evaluate = search_torch._Chains.evaluate
    if rank == 1:
        def boom(self, asg):
            raise RuntimeError("injected fault on rank 1")
        search_torch._Chains.evaluate = boom
    try:
        search_torch.anneal_search(tables, devices=world, device="cpu", **kw)
    except RankFailure as exc:
        res["failure"] = str(exc)
    finally:
        search_torch._Chains.evaluate = evaluate
    # the group still works after a failed call
    res["after_failure"] = outcome_key(search_torch.anneal_search(
        tables, devices=world, device="cpu", **kw))
    return res


# ---------------------------------------------------------------------------
# the expert-parallel MoE block
# ---------------------------------------------------------------------------

def moe_config(arch: str, cf: float):
    from repro_torch import configs
    cfg = configs.get(arch).reduced()
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def moe_state(z) -> dict:
    return {k: torch.from_numpy(z[k])
            for k in ("ln", "router", "wi_gate", "wi", "wo") if k in z}


def moe_ranks(rank, world, arch, sizes, cases):
    """Each ``(cf, npz)`` of ``cases``: the block of ``arch`` at capacity
    factor ``cf`` on a mesh of ``sizes`` (data, model) over the ranks, on
    the npz's ``x`` and weights, twice: built on the mesh, holding this
    rank's slice of the experts (``"sliced"``), and built without one and
    run under ``with mesh:``, holding every expert (``"whole"``).  Each
    gives the output, the aux losses, whether the expert-parallel path
    ran and the experts the block held, or the message a sliced block
    refused the call with.  Last, a model built on the mesh prefills
    ``EP_MIN_TOKENS`` tokens a data shard and decodes a step, on the
    reference's weights (the npz ``decode<rows>.npz`` beside the
    cases')."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import moe
    from repro_torch.models.convert import shard_experts
    m = tmesh.device_mesh(sizes, device="cpu")

    def run(block, x):
        try:
            with torch.no_grad():
                y, aux = block(x)
        except ValueError as exc:
            return dict(refused=str(exc), held=block.wi.shape[0])
        return dict(y=y.numpy(), aux={k: float(v) for k, v in aux.items()},
                    ep_calls=block.ep_calls, held=block.wi.shape[0],
                    first=block.first)

    out = []
    for cf, path in cases:
        cfg = moe_config(arch, cf)
        with np.load(path) as z:
            x = torch.from_numpy(z["x"])
            sliced = moe.MoE(cfg, "cpu", mesh=m)
            sliced.load_state_dict(shard_experts(cfg, moe_state(z),
                                                 sliced.rules, m))
            whole = moe.MoE(cfg, "cpu")
            whole.load_state_dict(moe_state(z))
            with m:
                out.append(dict(sliced=run(sliced, x), whole=run(whole, x)))
    rows = m.shape["data"]          # EP_MIN_TOKENS a data shard
    path = pathlib.Path(cases[0][1]).parent / f"decode{rows}.npz"
    return dict(cases=out, decode=model_decode(arch, m, path))


def model_decode(arch, m, path) -> dict:
    """A model of ``arch`` built on mesh ``m`` (under its training rules)
    from the reference's weights in ``path``: the expert-parallel blocks
    its prefill of ``EP_MIN_TOKENS`` tokens a data shard took, and its
    prefill's and decode step's logits."""
    from repro_torch.models import build
    from repro_torch.models.convert import shard_params
    from repro_torch.models.moe import EP_MIN_TOKENS
    cfg = moe_config(arch, 8.0)
    model = build(cfg, device="cpu", mesh=m)
    with np.load(path) as z:
        ids = torch.from_numpy(z["ids"])
        state = {k[6:]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith("state.")}
    model.load_state_dict(shard_params(cfg, state, model.rules, m))
    with torch.no_grad():
        logits, caches = model.prefill({"token_ids": ids},
                                       capacity=EP_MIN_TOKENS + 1)
        res = dict(ep_calls=sum(layer.c.ep_calls for layer in model.layers),
                   prefill=logits.numpy())
        step, _ = model.decode_step(caches, {
            "token_ids": ids[:, :1],
            "lengths": torch.full((ids.shape[0],), EP_MIN_TOKENS,
                                  dtype=torch.int32)})
    res["decode"] = step.numpy()
    return res


def group_ranks(rank, world, problems, data=None):
    """:func:`search_ranks`, then (given ``(rules, batch, ckpts)``)
    :func:`data_ranks`, in one group."""
    res = {"search": search_ranks(rank, world, problems)}
    if data is not None:
        res["data"] = data_ranks(rank, world, *data)
    return res


# ---------------------------------------------------------------------------
# batches and checkpoints on a mesh
# ---------------------------------------------------------------------------

def data_ranks(rank, world, rules, batch, ckpts):
    """``device_put_batch`` of ``batch`` on a (world, 1) and a (1, world)
    mesh, and each ``(dir, like, logical)`` of ``ckpts`` restored onto
    the (1, world) mesh under its logical axes; returns each local block
    and each whole tensor reassembled from the ranks."""
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import sharding
    from repro_torch.train import checkpoint
    res = {"batch": {}, "ckpt": []}
    for sizes in ((world, 1), (1, world)):
        m = tmesh.device_mesh(sizes, device="cpu")
        placed = device_put_batch(batch, m, rules)
        res["batch"][sizes] = {
            k: (v.to_local().numpy(), tuple(map(str, v.placements)),
                v.full_tensor().numpy()) for k, v in placed.items()}
    m = tmesh.device_mesh((1, world), device="cpu")
    for ckpt_dir, like, logical in ckpts:
        shardings = sharding.tree_shardings(
            m, rules, logical, {k: v for k, v in like.items()
                                if isinstance(v, torch.Tensor)})
        state, step = checkpoint.restore(ckpt_dir, like, shardings=shardings)
        res["ckpt"].append(dict(step=step, local={
            k: (v.to_local().numpy(), v.full_tensor().numpy())
            for k, v in state.items() if hasattr(v, "to_local")}))
    return res


# ---------------------------------------------------------------------------
# tensor-parallel serving
# ---------------------------------------------------------------------------

def tp_case(path) -> tuple:
    """The reference's run of one case (``tests/test_torch_tensor_parallel
    .py``): its state dict for the port, prompt, decode tokens, capacity
    and logits (prefill, then each step)."""
    with np.load(path) as z:
        state = {k[6:]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith("state.")}
        return (state, torch.from_numpy(z["ids"]), torch.from_numpy(z["toks"]),
                int(z["cap"]), z["logits"])


def serve_pass(model, ids, toks, cap) -> list:
    """Prefill ``ids`` into caches of ``cap`` slots, then one decode step
    a row of ``toks``; the logits of each (f32 numpy)."""
    logits, caches = model.prefill({"token_ids": ids}, capacity=cap)
    out = [logits.float().numpy()]
    lengths = torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32,
                         device=ids.device)
    for t in toks:
        logits, caches = model.decode_step(
            caches, {"token_ids": t, "lengths": lengths})
        out.append(logits.float().numpy())
        lengths = lengths + 1
    return out


def tp_ranks(rank, world, sizes, cases):
    """Each ``(name, arch, path)`` of ``cases`` on a mesh of ``sizes``: the
    model built on the mesh under ``serve_rules`` from the reference's
    state dict cut to this rank (``shard_params``) serves the case.
    Returns per case the logits, the collectives recorded, the ones the
    dry run plans for the same pass on a mesh description, and this
    rank's KV cache bytes."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import build, collectives
    from repro_torch.models.convert import shard_params
    m = tmesh.device_mesh(sizes, device="cpu")
    desc = tmesh.Mesh(("data", "model"), tuple(sizes))
    out = {}
    for name, arch, path in cases:
        cfg = configs.get(arch).reduced()
        state, ids, toks, cap, _ = tp_case(path)
        model = build(cfg, device="cpu", mesh=m, rules=cfg.serve_rules)
        model.load_state_dict(shard_params(cfg, state, cfg.serve_rules, m))
        collectives.reset()
        with torch.no_grad():
            logits = serve_pass(model, ids, toks, cap)
        got = list(collectives.records)
        planned = dryrun.mesh_model(cfg, desc, backend="torch")
        collectives.reset()
        with torch.no_grad():
            _plan(planned, ids, toks, cap)
        want = list(collectives.records)
        collectives.reset()
        kv = sum(t.numel() * t.element_size()
                 for c in model.init_cache(ids.shape[0], cap)
                 for x in c.values() if isinstance(x, dict)
                 for t in x.values())
        out[name] = dict(logits=logits, records=got, planned=want,
                         kv_bytes=kv)
    return out


def _plan(model, ids, toks, cap) -> None:
    """``serve_pass`` on ``meta`` (a model on a mesh description)."""
    meta = torch.device("meta")
    _, caches = model.prefill({"token_ids": ids.to(meta)}, capacity=cap)
    lengths = torch.zeros((ids.shape[0],), dtype=torch.int32, device=meta)
    for t in toks:
        model.decode_step(caches, {"token_ids": t.to(meta),
                                   "lengths": lengths})
