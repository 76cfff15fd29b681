"""Deterministic, resumable synthetic LM data pipeline (counterpart of
``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step, dp_rank) — a counter-mode
PRNG stream — so:
  * restart-from-checkpoint replays the exact token stream (bitwise
    resumability, tested),
  * no host state needs checkpointing beyond the step counter,
  * a straggling/replaced host can regenerate any shard on demand
    (straggler recovery without data redistribution),
  * elastic rescale re-partitions rank streams deterministically.

Batches are Zipf-distributed token ids (vocab-shaped like natural text)
with next-token labels; a file-backed reader with the same interface covers
real corpora.  ``DataConfig``, ``SyntheticLM`` and ``FileBackedLM`` are
the reference's, NumPy only, and give its batches bit for bit.
``device_put_batch`` shards a batch over a mesh of ranks, as the
reference's does; ``to_device`` moves a batch to one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2


class SyntheticLM:
    """Counter-mode synthetic LM stream."""

    def __init__(self, cfg: DataConfig, dp_rank: int = 0, dp_size: int = 1):
        if cfg.global_batch % dp_size:
            raise ValueError("global_batch must divide by dp_size")
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.local_batch = cfg.global_batch // dp_size

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=[0, 0, step, self.dp_rank]))
        # Zipf over the vocab, clipped; heavier head like text
        toks = rng.zipf(cfg.zipf_a,
                        size=(self.local_batch, cfg.seq_len + 1))
        toks = np.minimum(toks - 1, cfg.vocab - 1).astype(np.int32)
        return {"token_ids": toks[:, :-1],
                "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileBackedLM:
    """Same interface over a flat token file (np.memmap of int32)."""

    def __init__(self, path: str, cfg: DataConfig, dp_rank: int = 0,
                 dp_size: int = 1):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.local_batch = cfg.global_batch // dp_size
        self._per_step = cfg.global_batch * (cfg.seq_len + 1)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        base = (step * self._per_step
                + self.dp_rank * self.local_batch * (cfg.seq_len + 1))
        n = self.local_batch * (cfg.seq_len + 1)
        flat = np.array(self.tokens[base % (len(self.tokens) - n):]
                        [:n]).reshape(self.local_batch, cfg.seq_len + 1)
        return {"token_ids": flat[:, :-1].astype(np.int32),
                "labels": flat[:, 1:].astype(np.int32)}


def to_device(batch: dict[str, np.ndarray],
              device: str | torch.device) -> dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on ``device`` (the one-device
    counterpart of the reference's ``device_put_batch``)."""
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def device_put_batch(batch, mesh, rules) -> dict:
    """Host numpy batch -> DTensors over ``mesh`` (a
    ``repro_torch.launch.mesh.Mesh`` over ranks), each dim split as
    ``sharding.spec`` resolves ("batch", "seq"[, None]) under ``rules``.
    Every rank holds the whole batch (a pure function of the seed and
    step) and keeps its own block: nothing crosses ranks."""
    from repro_torch.models import sharding
    out = {}
    for k, v in batch.items():
        logical = ("batch", "seq") if v.ndim == 2 else ("batch", "seq", None)
        out[k] = sharding.named_sharding(mesh, rules, logical).place(
            torch.as_tensor(np.ascontiguousarray(v)))
    return out
