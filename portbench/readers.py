"""Arithmetic that the per-layer readers (``metrics/<name>.py``) share.

A reader gets the run's record (``run.record``): the window's engine and
gateway steps and request stamps up to ``measured_end`` (the window less
its profiled slice, so that the profiler's cost is in none of these), the
tenants' sizes, and in a traced run the profiled slice (``profile``).
Every reader returns ``None`` where it finds nothing to read.
"""
from __future__ import annotations

import re

from portbench import devtrace, roofline

#: the port's kernel names (``csrc/*.cu``), as the profiler shows them
FLASH = re.compile(r"\bflash_(sm90_f32|sm90|mma|kernel)\b")
DECODE_ATTENTION = re.compile(r"\b(split_mma|split_simt|combine)<")


def steps(rec) -> list[tuple]:
    """Engine steps ended inside the measured part: (tenant, t0, t1,
    decode ms, prompt tokens admitted)."""
    return [s for s in rec["steps"] if s[2] <= rec["measured_end"]]


def gateway_steps(rec) -> list[tuple]:
    return [s for s in rec["gateway_steps"] if s[1] <= rec["measured_end"]]


def gateway_step_ms(rec) -> float | None:
    w = [b - a for a, b in gateway_steps(rec)]
    return 1e3 * sum(w) / len(w) if w else None


def decode_step_ms(rec) -> float | None:
    """The engines' decode ms (``EngineMetrics.last_step_ms``) over their
    decode steps; behind a gateway, the tenants' decode ms summed over the
    gateway's steps."""
    st = steps(rec)
    total = sum(s[3] for s in st)
    if rec["gateway"]:
        n = len(gateway_steps(rec))
    else:
        n = sum(1 for s in st if s[3] > 0)
    return total / n if n and total > 0 else None


def prefill_ms_per_ktok(rec) -> float | None:
    """Admission ms (a step's wall less its decode ms, in steps that
    admitted) per thousand prompt tokens admitted."""
    st = [s for s in steps(rec) if s[4] > 0]
    toks = sum(s[4] for s in st)
    if not toks:
        return None
    ms = sum(1e3 * (s[2] - s[1]) - s[3] for s in st)
    return 1e3 * ms / toks


def model_flops(rec) -> float:
    """The model FLOPs of the measured part: each prefill whose first
    token came in it, and each decoded token, at its cached length."""
    end = rec["measured_end"]
    total = 0.0
    for tenant, tracks in rec["tracks"].items():
        arch = rec["tenants"][tenant]["arch"]
        for tr in tracks:
            P = len(tr.prompt)
            n = sum(1 for t in tr.stamps if t <= end)
            if n == 0:
                continue
            total += roofline.prefill_flops(arch, P)
            if n > 1:
                # decode tokens 1..n-1 at cached lengths P .. P + n - 2
                total += roofline.decode_flops(arch, range(P, P + n - 1))
    return total


def mfu(rec) -> float | None:
    end = rec["measured_end"]
    flops = model_flops(rec)
    if end <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (end * roofline.PEAK_BF16_FLOPS)


def _slice_ops(rec, pattern):
    p = rec.get("profile")
    if not p:
        return None, None
    ops = [o for o in p["ops"] if pattern.search(o[2])]
    ms = devtrace.busy_us(ops, p["lo_us"], p["hi_us"]) / 1e3
    return p, ms


def flash_roofline(rec) -> float | None:
    """The bound of the profiled slice's prefills' attention, every layer,
    over the device ms of the flash kernels in the slice."""
    p, ms = _slice_ops(rec, FLASH)
    if not ms:
        return None
    bound = sum(roofline.flash_bound_ms(rec["tenants"][t]["arch"], S)
                * rec["tenants"][t]["arch"]["n_layers"]
                for t, lens in p["prefills"].items() for S in lens)
    return 100.0 * bound / ms if bound else None


def decode_attention_roofline(rec) -> float | None:
    """The bound of the profiled slice's decode replays' attention (every
    slot at the length the step gave it, every layer) over the device ms
    of the decode attention kernels in the slice."""
    p, ms = _slice_ops(rec, DECODE_ATTENTION)
    if not ms:
        return None
    bound = sum(roofline.decode_attention_bound_ms(rec["tenants"][t]["arch"], L)
                * rec["tenants"][t]["arch"]["n_layers"]
                for t, reps in p["decodes"].items() for L in reps)
    return 100.0 * bound / ms if bound else None


def idle_share(rec) -> float | None:
    p = rec.get("profile")
    if not p or p["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_us"] / (p["hi_us"] - p["lo_us"]))
