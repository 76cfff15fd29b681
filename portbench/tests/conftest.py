"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's folder
holding a cell cut to a size the CPU runs in seconds.

Run from the repository's root: ``python -m pytest portbench/tests -q``
(the repository's own ``pytest`` collects ``tests/`` only).  Tests that
need the card carry the ``cuda`` marker and skip without one.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import spec  # noqa: E402

#: a nemotron-4-15b-shaped model at a size the CPU serves in seconds,
#: in the configuration's precision
TINY_ARCH = {"n_layers": 4, "d_model": 128, "n_heads": 4, "n_kv_heads": 2,
             "d_head": 32, "d_ff": 256, "vocab": 512, "act": "squared_relu",
             "rope_theta": 10000.0, "qkv_bias": False, "tie_embeddings": False,
             "dtype": "bfloat16", "param_dtype": "float32",
             "kv_cache_dtype": "bfloat16"}
#: the tiny cell's limit: sound bf16 runs read 0-0.014 at this size and
#: the float8 control 0.15-0.28 (CPU, 6 seeds each)
TINY_LIMIT = 0.05


def tiny_base(tmp: Path, process: str = "poisson", gateway: bool = False,
              arch: dict | None = None) -> tuple[dict, Path]:
    """A benchmark folder at ``tmp``: the real references and metrics, and
    a cell ``tiny`` (config ``tiny``, traffic ``tiny``); returns the
    ``BENCHMARK.json`` object that lists it."""
    tmp = Path(tmp)
    for d in ("metrics", "references"):
        shutil.copytree(spec.HERE / d, tmp / d)
    (tmp / "configs").mkdir()
    (tmp / "traffic").mkdir()
    arch = dict(TINY_ARCH, **(arch or {}))
    tenants = [{"model": "nemotron-4-15b", "arch": arch,
                "max_logit_gap": TINY_LIMIT}]
    cfg = {"name": "tiny", "reference": "dense_decoder", "tenants": tenants}
    mix = {"process": process, "rate_rps": 20.0, "pool": 64,
           "prompt_len": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                          "min": 4, "max": 40},
           "max_new": {"dist": "uniform", "min": 8, "max": 16},
           "tenants": {"nemotron-4-15b": {"weight": 1.0, "slots": 4,
                                          "capacity": 64}},
           "sizes_seed": 5, "check_tokens": 64, "warmup_lengths": 3}
    if gateway:
        small = dict(arch, act="swiglu", n_kv_heads=4, vocab=384)
        cfg["tenants"].insert(0, {"model": "stablelm-1.6b", "arch": small,
                                  "max_logit_gap": TINY_LIMIT})
        cfg["gateway"] = {"platform": {"kind": "tpu_pod_split", "args": {
            "n_chips_a": 4, "n_chips_b": 12, "name": "v5e-4x12-split"}},
            "solver": "auto", "kv_budget_bytes": None}
        mix["tenants"]["stablelm-1.6b"] = {"weight": 3.0, "slots": 4,
                                           "capacity": 64}
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp / "traffic" / "tiny.json").write_text(json.dumps(mix))
    bench = spec.benchmark(ROOT)
    bench = dict(bench, workloads=[{"name": "tiny", "config": "tiny",
                                    "traffic": "tiny", "chips": 1,
                                    "why": "CPU test"}])
    bench["end_to_end"] = [{k: v for k, v in m.items() if k != "workloads"}
                           for m in bench["end_to_end"]]
    bench["per_layer"] = [{k: v for k, v in m.items() if k != "workloads"}
                          for m in bench["per_layer"]]
    return bench, tmp


@pytest.fixture
def tiny(tmp_path):
    return tiny_base(tmp_path)


@pytest.fixture
def card():
    """Skips a test unless a CUDA device is here (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
