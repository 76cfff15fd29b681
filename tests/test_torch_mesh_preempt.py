"""A preemption and the host memory of a checkpoint on the ranks of a
mesh, and the mesh entry points' device.

* One rank of a (1, 2) or (2, 2) mesh of ``gloo`` ranks gets a SIGTERM
  during the second step of a reduced stablelm-1.6b ``Trainer(ckpt_dir=)``
  (``tests/_mesh_train.py::preempt_ranks``).  The ranks agree on it after
  that step: every rank raises ``KeyboardInterrupt``, and the one
  checkpoint, at step 2, is bit for bit the whole state of an
  uninterrupted run after its second step, and restores in
  ``repro.train.checkpoint``.
* ``python -m repro_torch.launch.train --devices 2`` sent a SIGTERM at
  its own pid (which reaches rank 0 alone) exits with the emergency
  checkpoint, which a rerun resumes.
* On 2 ranks a save holds one gathered array (or piece of one) at a time
  and the rank that does not write converts none to numpy; a restore
  holds one whole array at a time (weak references to the storages).
* Off a mesh the trainer votes on nothing; ``device_mesh`` and
  ``init_ranks`` default to the card and raise without one.
"""
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _mesh_train as mt
import _ranks
from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.trainer import TrainState as JState
from repro_torch import ranks as trank
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build
from repro_torch.models.convert import leaves_from_jax
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.trainer import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESSAGE = "preempted; emergency ckpt saved"
#: (mesh, the rank the SIGTERM goes to)
CASES = (((1, 2), 0), ((1, 2), 1), ((2, 2), 3))
IDS = [f"{a}x{b}-rank{r}" for (a, b), r in CASES]
#: the bytes of a whole array a save gathers at a time: the default (every
#: reduced array at once) and 4 kB (the largest, 64 kB, in 16 pieces)
GATHERS = {"whole": tckpt.GATHER_BYTES, "pieces": 4096}
#: seconds each wait of the launcher test may take
LATEST_TIMEOUT_S, EXIT_TIMEOUT_S, RERUN_TIMEOUT_S = 120.0, 120.0, 120.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every group's results, all run at once."""
    work = tmp_path_factory.mktemp("mesh_preempt")
    started = {}
    try:
        for i, (sizes, flagged) in enumerate(CASES):
            started[i] = _ranks.start(
                mt.preempt_ranks, sizes[0] * sizes[1], work / f"s{i}", sizes,
                flagged, str(work / f"ckpt{i}"))
        for name, size in GATHERS.items():
            started[name] = _ranks.start(mt.memory_ranks, 2,
                                         work / f"s_{name}",
                                         str(work / f"ckpt_{name}"), size)
        out = {k: _ranks.collect(s) for k, s in started.items()}
    finally:
        for s in started.values():
            _ranks.stop(s)
    out["work"] = work
    return out


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# a preemption on one rank
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_a_sigterm_to_one_rank_saves_once_on_every_rank(i, ranks):
    """Every rank raises the reference's ``KeyboardInterrupt`` after step
    2; the one checkpoint is at step 2 and holds, bit for bit, the whole
    state of an uninterrupted run after its second step."""
    for res in ranks[i]:
        assert res["raised"] == MESSAGE
        assert res["step"] == 2
    ckpt_dir = ranks["work"] / f"ckpt{i}"
    assert sorted(p.name for p in ckpt_dir.iterdir()) == [
        "ckpt_00000002.npz", "latest"]
    got = _npz(ckpt_dir / "ckpt_00000002.npz")
    want = ranks[i][0]["whole"]
    assert int(got["step"]) == 2 and int(got["__step__"]) == 2
    assert set(got) == set(want) | {"step", "__step__"}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for res in ranks[i][1:]:        # the ranks agree on the whole state
        for k, v in want.items():
            np.testing.assert_array_equal(res["whole"][k], v, err_msg=k)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_the_emergency_checkpoint_restores_in_repro(i, ranks):
    jcfg = jconfigs.get(mt.PREEMPT_ARCH).reduced()
    jm = jbuild(jcfg)
    opt = jopt.make(jcfg.optimizer, 1e-3)
    like = jax.eval_shape(lambda: JState(
        jnp.zeros((), jnp.int32), jm.abstract_params(),
        opt.init(jm.abstract_params())))
    got, step = jckpt.restore(ranks["work"] / f"ckpt{i}", like)
    assert step == 2 and int(got.step) == 2
    theirs = leaves_from_jax({"params": jax.tree.map(np.asarray, got.params),
                              "opt": jax.tree.map(np.asarray, got.opt)})
    want = ranks[i][0]["whole"]
    assert set(theirs) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(theirs[k], v, err_msg=k)


def test_a_sigterm_to_the_launcher_saves_and_a_rerun_resumes(tmp_path):
    """``launch.train --devices 2``: a SIGTERM at the launcher's pid alone
    (rank 0; the helper rank is a process of its own) after the step-50
    checkpoint ends the run nonzero with the emergency checkpoint, which
    a rerun with one more step resumes and finishes.  Short sequences
    and one thread a rank keep the steps quick."""
    ckpt_dir = tmp_path / "ckpt"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
    env.pop(trank.SHARE_ENV, None)

    def launch(steps):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             mt.PREEMPT_ARCH, "--device", "cpu", "--devices", "2",
             "--steps", str(steps), "--seq-len", "16", "--global-batch",
             "4", "--ckpt-dir", str(ckpt_dir)], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc = launch(100000)
    try:
        deadline = time.monotonic() + LATEST_TIMEOUT_S
        while not (ckpt_dir / "latest").exists():
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline, "no step-50 checkpoint"
            time.sleep(0.1)
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=EXIT_TIMEOUT_S)
        exit_s = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode != 0
    assert MESSAGE in err, err[-2000:]
    assert exit_s < EXIT_TIMEOUT_S
    step = tckpt.latest_step(ckpt_dir)
    assert step >= 50
    rerun = launch(step + 1)
    try:
        out, err = rerun.communicate(timeout=RERUN_TIMEOUT_S)
    finally:
        if rerun.poll() is None:
            rerun.kill()
            rerun.communicate()
    assert rerun.returncode == 0, err[-2000:]
    # resumed: one step taken (printed), not step + 1 from the start
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("step")] == [str(step + 1)], out
    assert "done on 2 ranks" in out
    assert tckpt.latest_step(ckpt_dir) == step + 1


# ---------------------------------------------------------------------------
# the host memory of a save and a restore on ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gather", list(GATHERS))
def test_a_save_on_ranks_holds_one_gathered_array_at_a_time(gather, ranks):
    """No gathered tensor (or piece) outlives the next gather on the rank
    that does not write, which converts nothing to numpy; the writer
    keeps its host copies."""
    res = ranks[gather]
    writer, other = sorted(res, key=lambda r: not r["writer"])
    assert writer["writer"] and not other["writer"]
    assert other["gathers"] == writer["gathers"] > 0
    assert other["gathered_most"] == 0
    assert other["numpy_calls"] == 0
    assert writer["numpy_calls"] > writer["gathers"]
    # in pieces, more gathers than arrays
    assert (writer["gathers"] > writer["reads"]) == (gather == "pieces")


@pytest.mark.parametrize("gather", list(GATHERS))
def test_a_restore_on_ranks_holds_one_whole_array_at_a_time(gather, ranks):
    """Each whole array the restore reads is gone before the next is
    read, on every rank; the restored state is the saved one, bit for
    bit (so a save in pieces writes the whole arrays)."""
    for res in ranks[gather]:
        assert res["reads"] > 0
        assert res["read_most"] == 0
        assert res["step"] == 1 and res["equal"]


# ---------------------------------------------------------------------------
# off a mesh; the entry points' device
# ---------------------------------------------------------------------------
def test_off_a_mesh_the_trainer_votes_on_nothing(tmp_path, monkeypatch):
    """A one-device trainer flagged during its second step saves at step
    2 and raises, without a collective."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective off a mesh")
    for name in ("all_reduce", "new_group", "barrier", "all_gather"):
        monkeypatch.setattr(dist, name, refuse)
    cfg = mt.config(mt.PREEMPT_ARCH)
    t = Trainer(build(cfg, backend="torch", device="cpu", layout="train"),
                SyntheticLM(DataConfig(cfg.vocab, 16, 4, seed=3)),
                ckpt_dir=str(tmp_path))
    t.init_state(torch.Generator().manual_seed(1))
    batch_at = t.data.batch_at

    def flagged(step):
        t._interrupted = t._interrupted or step == 1
        return batch_at(step)
    t.data.batch_at = flagged
    with pytest.raises(KeyboardInterrupt, match=MESSAGE):
        t.run(4)
    assert t._vote is None
    assert tckpt.latest_step(tmp_path) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000002.npz", "latest"]


@pytest.mark.parametrize("entry", ["device_mesh", "init_ranks"])
def test_the_mesh_entry_points_default_to_the_card(entry, tmp_path,
                                                   monkeypatch):
    """Without ``device`` both ask for the card and, with none visible,
    raise the runtime's error before touching ``torch.distributed``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def untouched(*args, **kwargs):
        raise AssertionError("torch.distributed touched")
    for name in ("get_world_size", "init_process_group", "FileStore"):
        monkeypatch.setattr(dist, name, untouched)
    with pytest.raises(RuntimeError, match="runs on CUDA by default"):
        if entry == "device_mesh":
            tmesh.device_mesh((1, 2))
        else:
            trank.init_ranks(2, 0, tmp_path / "store")
    assert not (tmp_path / "store").exists()
    assert not dist.is_initialized()
