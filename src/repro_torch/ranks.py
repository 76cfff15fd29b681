"""Ranks on one host over ``torch.distributed`` (the role
``repro/core/xla_env.py``'s ``apply(devices=N)`` plays in the reference,
and the rank start-up beside ``repro/launch/mesh.py``).

A layer below the search (``core.search_torch``), the models and the
launchers, all of which may import it; it imports none of them.

Ranks.  Every rank of this package runs on one host.  They meet through a
``FileStore`` in a directory (no TCP port to collide on), with an
explicit timeout.  The backend is chosen, never guessed, and reported by
:func:`init_ranks`: ``nccl`` when each rank has a card of its own,
``gloo`` when ranks share a card or run on the CPU (NCCL refuses two ranks
on one card).

Sharing.  The reference emulates N host devices with
``xla_env.apply(devices=N)``; the port's opt-in is :func:`share_devices`:
it lets N ranks share the devices that exist (N CPU processes, or N ranks
on ``cuda:0``).  Without it, asking for more ranks than visible devices
raises.  Like the reference's flag it lives in the environment
(:data:`SHARE_ENV`), so processes started later inherit it.

Helper ranks.  A plain single process that asks for N ranks (the
launchers, ``GatewayConfig.solver_knobs``) gets a :class:`RankPool`: it
becomes rank 0 and starts N - 1 helper processes (``python -m
repro_torch.ranks``), which wait for work; each call broadcasts a
function name and its arguments, and every rank runs it.  The pool lives
for the process's life and is closed at exit.
"""
from __future__ import annotations

import atexit
import datetime
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .obs import get_logger
from .runtime import resolve_device

log = get_logger(__name__)

#: ranks allowed to share the visible devices (set by share_devices)
SHARE_ENV = "REPRO_TORCH_SHARED_RANKS"
#: seconds a rank waits at the rendezvous and in any collective
DEFAULT_TIMEOUT_S = 300.0


# ---------------------------------------------------------------------------
# how many ranks may run, and on which backend
# ---------------------------------------------------------------------------

def share_devices(devices: int, env=os.environ) -> int:
    """Let ``devices`` ranks share the visible devices (the port's
    ``xla_env.apply(devices=N)``).  Writes :data:`SHARE_ENV` into ``env``
    (this process's environment by default, which helper ranks
    inherit); returns ``devices``."""
    devices = int(devices)
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    env[SHARE_ENV] = str(devices)
    return devices


def visible_devices(device: str | torch.device) -> int:
    """Devices of ``device``'s type this process sees: the cards, or 1
    for the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def rank_capacity(device: str | torch.device) -> int:
    """How many ranks may run here: the visible devices, or more where
    :func:`share_devices` allowed it."""
    return max(visible_devices(device), int(os.environ.get(SHARE_ENV, 0)))


def choose_backend(world: int, device: str | torch.device) -> str:
    """``nccl`` when each of ``world`` ranks has a card of its own,
    ``gloo`` when they share one or run on the CPU."""
    if (torch.device(device).type == "cuda"
            and world <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def init_ranks(world: int, rank: int, store_dir: str | Path, *,
               device: str | torch.device | None = None,
               backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join (as ``rank``) the default process group of ``world`` ranks
    that meet through a ``FileStore`` in ``store_dir``, on ``device``:
    the card by default (``runtime.resolve_device``, which raises
    without one, before anything touches ``torch.distributed``);
    ``device="cpu"`` on the host.  Returns the backend, chosen by
    :func:`choose_backend` unless given.  Every wait, the rendezvous's
    and each collective's, ends after ``timeout_s``."""
    device = resolve_device(device)
    backend = backend or choose_backend(world, device)
    if device.type == "cuda":
        # a card of its own under nccl; ranks sharing cards take turns
        torch.cuda.set_device(rank % torch.cuda.device_count())
    # the ranks are on one host: gloo needs no name resolution then
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timeout = datetime.timedelta(seconds=timeout_s)
    Path(store_dir).mkdir(parents=True, exist_ok=True)
    store = dist.FileStore(str(Path(store_dir) / "store"), world)
    store.set_timeout(timeout)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    if rank == 0:
        log.info("%d ranks on %s over %s", world, device.type, backend)
    return backend


# ---------------------------------------------------------------------------
# helper ranks for a single-process caller
# ---------------------------------------------------------------------------

def _resolve(name: str):
    module, _, attr = name.partition(":")
    return getattr(importlib.import_module(module), attr)


class RankFailure(RuntimeError):
    """A rank failed, and every rank of the call knows it and raised."""


class RankPool:
    """The caller as rank 0 of ``world`` ranks on ``device``, the other
    ``world - 1`` helper processes started here.  :meth:`run` has every
    rank call one function; :meth:`close` stops the helpers and checks
    their exit codes."""

    def __init__(self, world: int, device: str | torch.device,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if dist.is_initialized():
            raise RuntimeError("this process is already in a process group; "
                               "call the function on every rank instead")
        self.world, self.device = world, torch.device(device)
        self.timeout_s = timeout_s
        self.broken = False
        self.dir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        src = str(Path(__file__).resolve().parents[1])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (src, os.environ.get("PYTHONPATH")) if p))
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.ranks",
             "--rank", str(r), "--world", str(world), "--store", self.dir,
             "--device", self.device.type, "--timeout", str(timeout_s),
             "--threads", str(torch.get_num_threads()),
             "--parent", str(os.getpid())], env=env)
            for r in range(1, world)]
        try:
            self.backend = init_ranks(world, 0, self.dir, device=device,
                                      timeout_s=timeout_s)
        except BaseException:
            self._reap(kill=True)
            raise

    def run(self, name: str, *args):
        """``module:function`` called as ``function(*args)`` on every
        rank; returns rank 0's result."""
        for p in self.procs:
            if p.poll() is not None:
                raise RuntimeError(f"helper rank exited with code "
                                   f"{p.returncode}")
        dist.broadcast_object_list([(name, args)], src=0)
        try:
            return _resolve(name)(*args)
        except RankFailure:
            raise                   # every rank knows: the pool still works
        except BaseException:
            self.broken = True      # the helpers may wait in a collective
            raise

    def close(self) -> None:
        """Stop the helpers (each must exit 0) and leave the group; after
        a call that failed on this rank alone, kill them."""
        try:
            if not self.broken:
                dist.broadcast_object_list([None], src=0)
        finally:
            dist.destroy_process_group()
            codes = self._reap(kill=self.broken)
        if self.broken:
            return
        bad = [c for c in codes if c != 0]
        if bad:
            raise RuntimeError(f"helper ranks exited with codes {codes}")

    def _reap(self, kill: bool) -> list[int]:
        codes = []
        for p in self.procs:
            if kill:
                p.kill()
            try:
                codes.append(p.wait(timeout=self.timeout_s))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        shutil.rmtree(self.dir, ignore_errors=True)
        return codes


_POOL: RankPool | None = None


def rank_pool(world: int, device: str | torch.device) -> RankPool:
    """The process's pool of ``world`` ranks on ``device``, started on
    first use; a pool of another size or device is closed first."""
    global _POOL
    device = torch.device(device)
    if _POOL is not None and (_POOL.world, _POOL.device) == (world, device):
        return _POOL
    close_pool()
    _POOL = RankPool(world, device)
    return _POOL


def close_pool() -> None:
    global _POOL
    pool, _POOL = _POOL, None
    if pool is not None:
        pool.close()


def in_pool() -> bool:
    """Whether this process's process group is a :class:`RankPool`'s."""
    return _POOL is not None


atexit.register(close_pool)


def _exit_with_parent(parent: int) -> None:
    """End this helper once rank 0's process is gone (killed, say, while
    this helper waits in a collective that would otherwise hold it until
    the timeout)."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _helper_main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="a helper rank of RankPool")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--parent", type=int, default=0)
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.parent:
        threading.Thread(target=_exit_with_parent, args=(args.parent,),
                         daemon=True).start()
    init_ranks(args.world, args.rank, args.store, device=args.device,
               timeout_s=args.timeout)
    try:
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            if box[0] is None:
                return 0
            name, fn_args = box[0]
            try:
                _resolve(name)(*fn_args)
            except RankFailure:
                pass        # every rank raised it; rank 0 reports it
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(_helper_main())
