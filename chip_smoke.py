"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root (``src/`` is put on ``sys.path`` here).
Phases, each fatal on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: all five CUDA kernels from ``src/repro_torch/kernels/csrc/`` for
   ``sm_90a``, one ``nvcc`` per source, started together;
3. kernels: each kernel against its plain PyTorch version on the card
   (attention: float32 at atol = rtol = 2e-5, bfloat16 at 2e-2, the
   tolerances of ``tests/test_kernels.py``; PCCS slowdown: float64 at
   atol = rtol = 1e-12, float32 at 5e-6; annealing select and the
   streaming antagonist: bit for bit, with poisoned lanes, special values
   and offset views), then timed (CUDA events, L2 flushed before each
   call, median) beside its plain version, its roofline bound and a
   library yardstick where one PyTorch call computes the same function
   (``F.scaled_dot_product_attention`` for attention, ``torch.add(y, x,
   alpha=c)`` for the stream; none for the other two).  The stream is
   timed at the probe's 32 MB pass and at a 1 GB pass, whose rate must
   not exceed 105% of the card's memory rate;
4. serve: full-width stablelm-1.6b with random weights from a seeded
   generator, 4 requests through ``ServingEngine``; every request must get
   its 16 tokens, both kernels must have launched (24 flash launches per
   prefill, 24 decode launches per decode step), and each prompt's prefill
   through the kernels must match the plain path (same argmax, relative
   logits error <= 2e-2);
5. float32 end to end: the same prefills on full-width stablelm-1.6b with
   float32 weights, activations and KV cache, kernel path against plain
   path (same argmax, relative logits error <= E2E_F32_REL_TOL).  With no
   bf16 rounding to amplify, this is the check that can tell a kernel
   fault from rounding;
6. search: the schedule search of ``repro_torch.core`` on the card under
   the paper's PCCS surface, ``Scheduler(..., evaluator="torch").solve(
   ..., solver="anneal")``, on the three golden Table-6 fixtures.  The
   orin fixture in float64 at population 4096 must give on the card the
   incumbent the same search gives on the CPU (where the plain versions
   run), and its device objective must match the scalar re-simulation;
   every fixture at population 1024 (128 steps) must be no worse than
   greedy; both search kernels must have launched in each solve;
7. characterize: the port's profiling CLI (``repro_torch.launch.profile
   --executor torch --arch stablelm-1.6b --fit piecewise --solve --solver
   anneal``) measures the 8 layer groups of full-width stablelm-1.6b
   through the flash kernel (3 x (warmup + repeats) launches in each),
   calibrates PCCS from co-runs of the streaming antagonist (which must
   launch in the peak measurement and at every demand level), writes a
   bundle that must round-trip, and solves from it; then
   ``Scheduler.from_bundle(bundle, evaluator="torch")`` must solve on the
   card through both search kernels, no worse than greedy.

The last line is the contract line ``{"ok": true, "device": {...}}``;
before it come the ``{"serve": ...}``, ``{"search": ...}`` and
``{"characterize": ...}`` lines, one ``{"kernels": [...]}`` line and the
card's ``nvidia-smi`` name and power limit.  Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 bytes/s
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
#: PCCS slowdown kernel vs plain version (tests/test_kernels.py:185 for
#: float32; float64 differs only in summation order)
SLOWDOWN_TOL = {torch.float64: 1e-12, torch.float32: 5e-6}
KERNEL_SOURCES = ("flash_attention", "decode_attention", "slowdown",
                  "search", "stream")
#: stream kernel checks: lengths, the last a 1 GB operand
STREAM_NS = (1, 3, 4097, (1 << 20) + 3, 1 << 28)
#: the probe's peak pass (repro/profiling/probes.py:95) and a pass larger
#: than the 50 MB L2
STREAM_TIMED_MB = (32.0, 1000.0)
#: the antagonist's and the co-run target's pass (probes.py:121), checked
#: bitwise with the timed passes
STREAM_CORUN_MB = 8.0
E2E_REL_TOL = 2e-2
E2E_F32_REL_TOL = 1e-4
PROMPT_LENS = (8, 100, 513, 1000)
MAX_NEW = 16


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
class Timer:
    """Median device time of one call, L2 flushed before each call.

    The flush (a 256 MB memset) is queued before the start event, so the
    card is busy while the host queues the timed call: the events bracket
    the call's device time, not the host's launch latency."""

    def __init__(self, device, reps: int = 15, warmup: int = 3):
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device=device)
        self.reps, self.warmup = reps, warmup

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------
def compare(name, got, want, dtype) -> float:
    tol = TOL[dtype]
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    err = (g - w).abs()
    ok = bool((err <= tol["atol"] + tol["rtol"] * w.abs()).all())
    mae = float(err.max())
    print(f"  {name}: max_abs_err={mae:.3e} "
          f"(atol=rtol={tol['atol']:g}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return mae


def flash_checks(fa, gen, dev) -> int:
    # (B, Sq, Skv, Hq, Hkv, D, causal, window)
    cases = []
    for s in (8, 100, 513, 1000, 1024):      # the served prompts + 1024
        cases.append((1, s, s, 32, 32, 64, True, None))
    cases += [(1, 100, 513, 32, 32, 64, True, None),     # Sq < Skv offset
              (1, 513, 513, 24, 8, 128, True, None),     # GQA, D = 128
              (2, 300, 300, 8, 2, 64, True, 100),        # local window
              (1, 513, 513, 32, 32, 64, False, None)]    # bidirectional
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, Hq, Hkv, D, causal, window in cases:
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                     (B, Skv, Hkv, D)))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.attention_torch(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            compare(f"flash {str(dtype)[6:]} B{B} Sq{Sq} Skv{Skv} "
                    f"H{Hq}/{Hkv} D{D} causal={causal} window={window}",
                    got, want, dtype)
            n += 1
    return n


def decode_checks(da, gen, dev) -> int:
    cases = [(4, 2048, 32, 32, 64, (9, 200, 514, 2047)),
             (4, 2048, 24, 8, 128, (0, 1, 513, 2048))]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, Hq, Hkv, D, lens in cases:
            q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = da.decode_attention(q, k, v, lengths)
            want = da.decode_attention_torch(q, k, v, lengths)
            torch.cuda.synchronize()
            compare(f"decode {str(dtype)[6:]} B{B} S{S} H{Hq}/{Hkv} D{D} "
                    f"lengths={list(lens)}", got, want, dtype)
            n += 1
    return n


def time_flash(fa, timer, gen, dev) -> dict:
    """Slice shape: one 1024-token causal prefill, 32 heads of 64, bf16."""
    B, S, H, D = 1, 1024, 32, 64
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    err = compare("flash timed shape", fa.flash_attention(q, k, v),
                  fa.attention_torch(q, k, v), torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = S * (S + 1) // 2                           # live (q, k) pairs
    flops = 4 * B * H * D * pairs
    nbytes = 4 * B * S * H * D * 2                 # q, k, v read; o written
    b_ms, b_by = bound(flops, nbytes)
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:113",
        shape=f"B{B} S{S} H{H}/{H} D{D} bf16 causal",
        max_abs_err=err,
        ms=timer(lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=timer(lambda: fa.attention_torch(q, k, v, causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)))


def time_decode(da, timer, gen, dev) -> dict:
    """Slice shape: 4 sequences over a 2048-slot cache, 32 heads of 64,
    bf16, lengths {9, 200, 514, 2047}."""
    B, S, H, D = 4, 2048, 32, 64
    lens = (9, 200, 514, 2047)
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, S, H, D, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    err = compare("decode timed shape", da.decode_attention(q, k, v, lengths),
                  da.decode_attention_torch(q, k, v, lengths), torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]
    live = sum(lens)
    flops = 4 * H * D * live
    nbytes = 2 * live * H * D * 2 + 2 * B * H * D * 2 + B * 4
    b_ms, b_by = bound(flops, nbytes)
    return dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:72",
        shape=f"B{B} S{S} H{H}/{H} D{D} bf16 lengths={list(lens)}",
        max_abs_err=err,
        ms=timer(lambda: da.decode_attention(q, k, v, lengths)),
        plain_ms=timer(lambda: da.decode_attention_torch(q, k, v, lengths)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)))


PCCS_KNOTS = (0.1, 0.3, 0.5, 0.7, 0.9)
# the Fig.-6-shaped PCCS surface of repro/profiling/virtual.py:42-50
PCCS_TABLE = ((1.00, 1.02, 1.06, 1.12, 1.20),
              (1.02, 1.08, 1.18, 1.32, 1.50),
              (1.05, 1.15, 1.32, 1.55, 1.82),
              (1.08, 1.24, 1.48, 1.80, 2.18),
              (1.12, 1.34, 1.64, 2.05, 2.60))


def pccs_tensors(dev, dtype=torch.float64):
    knots = torch.tensor(PCCS_KNOTS, dtype=dtype, device=dev)
    return knots, knots, torch.tensor(PCCS_TABLE, dtype=dtype, device=dev)


def demands(n, gen, dev, dtype):
    """Demands over [-0.1, 1.1): zeros, negatives, values outside the
    knots, and a quarter exactly on knots."""
    own, ext = ((torch.rand(n, generator=gen, device=dev,
                            dtype=torch.float64) * 1.2 - 0.1).to(dtype)
                for _ in range(2))
    knots = torch.tensor(PCCS_KNOTS, dtype=dtype, device=dev)
    on = torch.arange(n // 4, device=dev)
    own[on] = knots[on % 5]
    ext[on[::2]] = knots[(on[::2] // 5) % 5]
    own[n // 4:n // 4 + n // 16] = 0.0
    ext[-(n // 16) - 1:] = 0.0
    return own, ext


def slowdown_checks(sd, gen, dev) -> float:
    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        ok, ek, tab = pccs_tensors(dev, dtype)
        for n in (1, 1000, 1 << 20):
            own, ext = demands(n, gen, dev, dtype)
            got = sd.piecewise_slowdown(own, ext, ok, ek, tab)
            want = sd.piecewise_slowdown_torch(own, ext, ok, ek, tab)
            torch.cuda.synchronize()
            tol = SLOWDOWN_TOL[dtype]
            err = (got - want).abs()
            good = bool((err <= tol + tol * want.abs()).all())
            mae = float(err.max())
            worst = max(worst, mae)
            print(f"  slowdown {str(dtype)[6:]} N={n}: max_abs_err={mae:.3e} "
                  f"(atol=rtol={tol:g}) {'ok' if good else 'FAIL'}")
            require(good, "slowdown: kernel disagrees with its plain version")
    return worst


def select_inputs(P, L, gen, dev, dtype):
    cur, prop, best = (torch.randint(0, 3, (P, L), generator=gen, device=dev,
                                     dtype=torch.int32) for _ in range(3))
    cur_obj, prop_obj, best_obj = (
        (torch.rand(P, generator=gen, device=dev, dtype=torch.float64) * 9
         + 1).to(dtype) for _ in range(3))
    prop_obj[::7] = float("inf")               # error-poisoned proposals
    cur_obj[::14] = float("inf")               # inf - inf = NaN delta
    prop_obj[3::11] = float("nan")
    prop_obj[5::13] = -float("inf")
    prop_obj[1::17] = best_obj[1::17]          # ties: strict < keeps best
    u = torch.rand(P, generator=gen, device=dev,
                   dtype=torch.float64).to(dtype)
    return cur, prop, best, cur_obj, prop_obj, best_obj, u


def bit_equal(a, b) -> bool:
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int64 if a.dtype == torch.float64
                      else torch.int32), b.view(
            torch.int64 if b.dtype == torch.float64 else torch.int32)
    return bool(torch.equal(a, b))


def max_abs_diff(got, want) -> float:
    """Largest |got - want|, counting equal values (equal infinities, NaN
    against NaN) as no difference."""
    same = (got == want) | (got.isnan() & want.isnan())
    return float(torch.where(same, 0.0, (got - want).abs()).max())


def select_checks(se, gen, dev, L: int) -> int:
    n = 0
    for dtype in (torch.float64, torch.float32):
        for P in (32, 4096, 65536):
            for temp in (0.37, 1e-40):         # 1e-40 takes the 1e-30 clamp
                args = select_inputs(P, L, gen, dev, dtype)
                got = se.anneal_select(*args, temp)
                want = se.anneal_select_torch(*args, temp)
                torch.cuda.synchronize()
                same = all(bit_equal(g, w) for g, w in zip(got, want))
                print(f"  select {str(dtype)[6:]} P={P} L={L} temp={temp:g}:"
                      f" bitwise {'equal' if same else 'DIFFERENT'}")
                require(same, "select: kernel differs from its plain version")
                n += 1
    return n


def time_slowdown(sd, timer, gen, dev, n) -> dict:
    """Search shape: one wave of the float64 search, N = chains x
    workloads demand pairs."""
    dtype = torch.float64
    ok, ek, tab = pccs_tensors(dev, dtype)
    own, ext = demands(n, gen, dev, dtype)
    err = float((sd.piecewise_slowdown(own, ext, ok, ek, tab)
                 - sd.piecewise_slowdown_torch(own, ext, ok, ek, tab))
                .abs().max())
    b_ms, b_by = bound(0.0, 3 * n * 8)             # own, ext in; s out
    return dict(
        name="piecewise_slowdown", route="cuda",
        source="src/repro_torch/kernels/csrc/slowdown.cu",
        replaces="src/repro/kernels/slowdown.py:75",
        shape=f"N={n} float64, 5x5 PCCS table",
        max_abs_err=err,
        ms=timer(lambda: sd.piecewise_slowdown(own, ext, ok, ek, tab)),
        plain_ms=timer(lambda: sd.piecewise_slowdown_torch(own, ext, ok, ek,
                                                           tab)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def time_select(se, timer, gen, dev, P, L) -> dict:
    """Search shape: one step of the float64 search, P chains of L =
    workloads x padded groups."""
    dtype = torch.float64
    args = select_inputs(P, L, gen, dev, dtype)
    got = se.anneal_select(*args, 0.37)
    want = se.anneal_select_torch(*args, 0.37)
    diff = sum(int((g != w).sum()) for g, w in zip(got[::2], want[::2]))
    diff += sum(int((~((g == w) | (g.isnan() & w.isnan()))).sum())
                for g, w in zip(got[1::2], want[1::2]))
    nbytes = 3 * P * L * 4 + 4 * P * 8 + 2 * P * L * 4 + 2 * P * 8
    b_ms, b_by = bound(0.0, nbytes)
    return dict(
        name="anneal_select", route="cuda",
        source="src/repro_torch/kernels/csrc/search.cu",
        replaces="src/repro/kernels/search.py:76",
        shape=f"P={P} L={L} float64",
        max_abs_err=float(diff),
        ms=timer(lambda: se.anneal_select(*args, 0.37)),
        plain_ms=timer(lambda: se.anneal_select_torch(*args, 0.37)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def stream_operands(n, gen, dev):
    """Signed float32 values over twelve decades; the first ten slots of x
    and y hold +-0, subnormals, +-inf, NaN and values near the largest."""
    x, y = (torch.randn(n, generator=gen, device=dev)
            * 10.0 ** torch.randint(-6, 7, (n,), generator=gen, device=dev)
            for _ in range(2))
    specials = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1e-45, float("inf"),
                             -float("inf"), float("nan"), 3.4e38, -3.4e38],
                            device=dev)
    k = min(n, specials.numel())
    x[:k] = specials[:k]
    y[:k] = specials.flip(0)[:k]
    return x, y


def stream_checks(st, gen, dev) -> int:
    """The stream kernel equals its plain version bit for bit: aligned,
    at a 4-byte offset (x[1:], y[1:]: the float4 path after a scalar
    head), and with x and y at different offsets (the scalar path)."""
    n_checks = 0
    for n in STREAM_NS:
        x, y = stream_operands(n + 2, gen, dev)
        cases = [("aligned", x[:n], y[:n]), ("offset 1", x[1:n + 1],
                                             y[1:n + 1])]
        if n == STREAM_NS[2]:
            cases.append(("offsets 1/2", x[1:n + 1], y[2:n + 2]))
        for label, a, b in cases:
            got = st.stream(a, b)
            want = st.stream_torch(a, b)
            torch.cuda.synchronize()
            same = bit_equal(got, want)
            print(f"  stream N={n} {label}: bitwise "
                  f"{'equal' if same else 'DIFFERENT'}")
            require(same, "stream: kernel differs from its plain version")
            n_checks += 1
        del x, y, got, want
        torch.cuda.empty_cache()
    return n_checks


def time_stream(st, probes, timer, dev) -> dict:
    """Probe shapes: the 32 MB peak pass of the main path, and a 1 GB pass
    (past the L2), through the probe's own buffers."""
    x, y = probes.make_buffers(STREAM_CORUN_MB, device=dev)
    same = bit_equal(st.stream(x, y), st.stream_torch(x, y))
    print(f"  stream N={x.numel()} ({STREAM_CORUN_MB:g} MB co-run pass): "
          f"bitwise {'equal' if same else 'DIFFERENT'}")
    require(same, "stream: kernel differs from its plain version at the "
            "co-run pass")
    rows = {}
    for mb in STREAM_TIMED_MB:
        x, y = probes.make_buffers(mb, device=dev)
        n = x.numel()
        want = st.stream_torch(x, y)
        got = st.stream(x, y)
        require(bit_equal(got, want),
                f"stream {mb} MB: kernel differs from its plain version")
        err = max_abs_diff(got, want)
        lib_err = max_abs_diff(torch.add(y, x, alpha=st.SCALE), want)
        b_ms, b_by = bound(2.0 * n, 3 * n * 4, PEAK_F32_FLOPS)
        ms = timer(lambda: st.stream(x, y))
        rows[mb] = dict(
            shape=f"N={n} float32 ({mb:g} MB pass)", max_abs_err=err, ms=ms,
            plain_ms=timer(lambda: st.stream_torch(x, y)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=timer(lambda: torch.add(y, x, alpha=st.SCALE)),
            library_max_abs_err=lib_err,
            bytes_per_s=3 * n * 4 / (ms * 1e-3))
        del x, y, got, want
    big = rows[STREAM_TIMED_MB[1]]
    print(f"  stream at {big['shape']}: {big['ms']:.4f} ms = "
          f"{big['bytes_per_s'] / 1e9:.1f} GB/s (bound {PEAK_BYTES / 1e9:g}"
          f" GB/s), plain {big['plain_ms']:.4f} ms, library "
          f"{big['library_ms']:.4f} ms (max abs diff "
          f"{big['library_max_abs_err']:.3e})")
    require(big["bytes_per_s"] <= 1.05 * PEAK_BYTES,
            f"stream reads {big['bytes_per_s'] / 1e9:.1f} GB/s, above 105% "
            f"of {PEAK_BYTES / 1e9:g} GB/s: a timing fault")
    return dict(name="stream", route="cuda",
                source="src/repro_torch/kernels/csrc/stream.cu",
                replaces="src/repro/profiling/probes.py:51",
                **rows[STREAM_TIMED_MB[0]], at_1GB=big)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
def make_prompts(vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n) for n in PROMPT_LENS]


def serve(fa, da, dev) -> dict:
    from repro_torch import configs
    from repro_torch.models import build, kvcache
    from repro_torch.serve.engine import ServingEngine

    cfg = configs.get("stablelm-1.6b")
    t0 = time.perf_counter()
    model = build(cfg, backend="auto", device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  built {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {sum(p.numel() for p in model.parameters()):,} "
          f"parameters in {time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(model, max_slots=4, capacity=2048)
    prompts = make_prompts(cfg.vocab)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    da.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    peak = torch.cuda.max_memory_allocated()

    require(len(done) == len(prompts), f"served {len(done)}/{len(prompts)}")
    for r in done:
        require(len(r.tokens) == MAX_NEW,
                f"request {r.rid} got {len(r.tokens)} tokens, not {MAX_NEW}")
    m = eng.metrics()
    L = cfg.n_layers
    require(launches["flash_attention"] == L * len(prompts),
            f"flash launches {launches['flash_attention']} != "
            f"{L} layers x {len(prompts)} prefills")
    require(launches["decode_attention"] == L * m["steps"],
            f"decode launches {launches['decode_attention']} != "
            f"{L} layers x {m['steps']} steps")
    print(f"  served {len(done)} requests, {m['tokens_out']} tokens, "
          f"{m['steps']} decode steps in {wall:.3f} s; launches {launches}")

    # kernel path vs plain path, end to end, one prefill per prompt, each
    # written into slot 0 of the engine's cache as the engine does
    views = [{name: kvcache.select(c[name], 0) for name in c}
             for c in eng.caches]
    prefill_ms, rel_errs, floor = [], [], []
    for p in prompts:
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        out = {}
        for backend in ("cuda", "torch", "ref"):
            model.backend = backend
            out[backend], _ = model.prefill(batch, cache_out=views)
        model.backend = "auto"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(batch, cache_out=views)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        g, w, r = (out[b][0, -1] for b in ("cuda", "torch", "ref"))
        require(bool(torch.isfinite(g).all()), "non-finite prefill logits")
        rel = float((g - w).norm() / w.norm())
        # the plain path against the naive oracle: how far bf16 rounding
        # alone moves these logits through 24 random layers
        floor.append(float((r - w).norm() / w.norm()))
        top_g, top_w = int(g.argmax()), int(w.argmax())
        print(f"  prefill S={len(p)}: kernel-vs-plain logits rel err "
              f"{rel:.3e} (oracle-vs-plain {floor[-1]:.3e}), argmax "
              f"{top_g} vs {top_w}, {prefill_ms[-1]:.2f} ms")
        require(top_g == top_w, f"S={len(p)}: argmax differs")
        require(rel <= E2E_REL_TOL, f"S={len(p)}: rel err {rel} > "
                f"{E2E_REL_TOL}")
        rel_errs.append(rel)

    return dict(arch=cfg.name, requests=len(done), max_new=MAX_NEW,
                prompt_lens=list(PROMPT_LENS), capacity=2048,
                launches=launches, decode_steps=m["steps"],
                tokens_out=m["tokens_out"], wall_s=wall,
                tokens_per_s=m["tokens_out"] / wall,
                mean_decode_step_ms=m["mean_step_ms"],
                prefill_ms=prefill_ms, e2e_logits_rel_err=rel_errs,
                oracle_vs_plain_rel_err=floor,
                max_memory_allocated=peak,
                profile=profile_decode(eng, prompts))


def e2e_f32(dev) -> list[float]:
    """Kernel path against plain path, float32 end to end.

    Full-width stablelm-1.6b with float32 weights, activations and KV
    cache (TF32 off), one prefill per served prompt.  The two paths differ
    only in summation order, so their last-token logits agree far inside
    the bf16 check's limit; every reading is printed before the limit is
    applied."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build

    cfg = dataclasses.replace(configs.get("stablelm-1.6b"), dtype="float32",
                              kv_cache_dtype="float32")
    model = build(cfg, backend="cuda", device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    rels, same = [], []
    for p in make_prompts(cfg.vocab):
        batch = {"token_ids": torch.as_tensor(p[None], device=dev)}
        out = {}
        for backend in ("cuda", "torch"):
            model.backend = backend
            out[backend] = model.prefill(batch)[0][0, -1]
        g, w = out["cuda"], out["torch"]
        require(bool(torch.isfinite(g).all()), "non-finite f32 logits")
        rels.append(float((g - w).norm() / w.norm()))
        same.append(int(g.argmax()) == int(w.argmax()))
        print(f"  f32 prefill S={len(p)}: kernel-vs-plain logits rel err "
              f"{rels[-1]:.3e}, same argmax {same[-1]}")
    del model
    torch.cuda.empty_cache()
    require(all(same), "f32: argmax differs")
    require(max(rels) <= E2E_F32_REL_TOL,
            f"f32: rel err {max(rels)} > {E2E_F32_REL_TOL}")
    return rels


def device_ms_by_kernel(prof) -> tuple[dict, int]:
    """Device ms by kernel name, and the number of kernels, of a
    ``torch.profiler`` window."""
    kernels, count = {}, 0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0))
        if t > 0 and evt.device_type.name == "CUDA":
            kernels[evt.key] = kernels.get(evt.key, 0.0) + t / 1e3
            count += evt.count
    return kernels, count


def profile_decode(eng, prompts, steps: int = 4) -> dict:
    """Device busy share and top kernels over a few steady decode steps
    (torch.profiler; "not measured" if it records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    eng.step()                                   # admit all, first decode
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, _ = device_ms_by_kernel(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps}
    if busy == 0:
        out["device_busy_share"] = "not measured"
    else:
        out["device_busy_share"] = busy / wall_ms
        out["top_kernels_ms_per_step"] = {k[:60]: v / steps for k, v in top}
    print(f"  profiled {steps} decode steps: {out}")
    return out


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------
SEARCH_STEPS = 64
#: the fixtures' 1024-chain solves run 128 steps: at 64 the orin fixture
#: stops at 4.2745 ms under PCCS, above greedy's 4.2663 ms (the same
#: chains on the CPU); 128 steps reach 4.1500 ms
FIXTURE_STEPS = 128
ORIN = "scenario4-exp8-orin-resnet101-googlenet-inception"


def fixture_requests() -> dict:
    """The golden Table-6 requests, loaded by the port, under PCCS."""
    from repro_torch.core import Plan
    from repro_torch.core.contention import PiecewiseModel

    pccs = PiecewiseModel(PCCS_KNOTS, PCCS_KNOTS, PCCS_TABLE)
    out = {}
    for path in sorted((ROOT / "tests" / "fixtures" / "plans")
                       .glob("*.json")):
        req = Plan.load(path).request
        out[path.stem] = (req, pccs)
    require(len(out) == 3 and ORIN in out, f"fixtures: {sorted(out)}")
    return out


def solve(sd, se, req, model, device, **knobs) -> tuple:
    """One ``Scheduler.solve`` with the kernel counts read around it."""
    from repro_torch.core import Scheduler

    sched = Scheduler(req.platform, model=model, evaluator="torch",
                      device=device)
    sd.launches = se.launches = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = sched.solve(list(req.graphs), req.objective,
                       max_transitions=req.max_transitions,
                       iterations=list(req.iterations),
                       depends_on=list(req.depends_on), **knobs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"piecewise_slowdown": sd.launches,
                "anneal_select": se.launches}
    row = dict(device=device.type, solver=plan.solver,
               objective=plan.objective,
               assignments=[list(a) for a in plan.assignments], wall_s=wall,
               launches=launches)
    if plan.solver == "anneal":
        p = plan.solver_params
        evaluated = p["population"] * (p["steps"] + 1)
        row.update(device_objective=p["device_objective"], chain=p["chain"],
                   population=p["population"], steps=p["steps"],
                   precision=p["precision"], evaluated=evaluated,
                   cands_per_s=evaluated / wall)
    print(f"  {req.graphs[0].name}+.. {plan.solver} on {device.type}: "
          f"{req.objective} {plan.objective:.12g} in {wall:.2f} s, "
          f"launches {launches}"
          + (f", {row['evaluated']} candidates, "
             f"{row['cands_per_s']:.0f}/s" if "evaluated" in row else ""))
    return plan, row


def search(sd, se, dev) -> dict:
    reqs = fixture_requests()
    cpu = torch.device("cpu")
    req, model = reqs[ORIN]
    x64 = dict(solver="anneal", precision="x64", population=4096,
               steps=SEARCH_STEPS, seed=0)
    gpu_plan, gpu = solve(sd, se, req, model, dev, **x64)
    require(gpu["launches"]["piecewise_slowdown"] > 0
            and gpu["launches"]["anneal_select"] == SEARCH_STEPS,
            f"search kernels did not launch: {gpu['launches']}")
    cpu_plan, cpu_row = solve(sd, se, req, model, cpu, **x64)
    require(cpu_row["launches"] == {"piecewise_slowdown": 0,
                                    "anneal_select": 0},
            "a kernel launched for CPU tensors")
    d_gpu, d_cpu = gpu["device_objective"], cpu_row["device_objective"]
    rel = abs(d_gpu - d_cpu) / abs(d_cpu)
    same = gpu_plan.assignments == cpu_plan.assignments
    print(f"  orin x64 cuda vs cpu: chain {gpu['chain']} vs "
          f"{cpu_row['chain']}, same assignment {same}, device objective "
          f"{d_gpu!r} vs {d_cpu!r} (rel {rel:.2e})")
    if not same:
        print(f"  tie: cuda {gpu['assignments']}\n       cpu  "
              f"{cpu_row['assignments']}")
    require(rel <= 1e-9, f"cuda and cpu incumbents differ: rel {rel}")
    resim = abs(gpu_plan.objective - d_gpu) / abs(gpu_plan.objective)
    print(f"  device objective vs scalar re-simulation: rel {resim:.2e}")
    require(resim <= 1e-6, f"device objective off the scalar one: {resim}")

    fixtures = {}
    for name, (req_i, model_i) in reqs.items():
        _, row = solve(sd, se, req_i, model_i, dev, solver="anneal",
                       precision="x64", population=1024,
                       steps=FIXTURE_STEPS, seed=0)
        require(row["launches"]["anneal_select"] == FIXTURE_STEPS,
                f"{name}: select launches {row['launches']}")
        _, greedy = solve(sd, se, req_i, model_i, dev, solver="greedy")
        ok = row["objective"] <= greedy["objective"] \
            + 1e-9 * abs(greedy["objective"])
        print(f"  {name}: anneal {row['objective']:.12g} vs greedy "
              f"{greedy['objective']:.12g} {'ok' if ok else 'WORSE'}")
        require(ok, f"{name}: anneal worse than greedy")
        fixtures[name] = dict(anneal=row, greedy=greedy)

    _, f32 = solve(sd, se, req, model, dev, solver="anneal",
                   precision="float32", population=4096,
                   steps=SEARCH_STEPS, seed=0)
    return dict(model="PCCS 5x5 (repro/profiling/virtual.py:42-50)",
                steps=SEARCH_STEPS, fixture_steps=FIXTURE_STEPS, orin_x64_cuda=gpu, orin_x64_cpu=cpu_row,
                same_assignment=same, device_objective_rel=rel,
                scalar_resim_rel=resim, fixtures=fixtures, orin_float32=f32,
                profile=profile_search(req, model, dev))


def profile_search(req, model, dev, steps: int = 8) -> dict:
    """Device busy share of one short float32 solve (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Scheduler

    sched = Scheduler(req.platform, model=model, evaluator="torch",
                      device=dev)
    kw = dict(max_transitions=req.max_transitions,
              iterations=list(req.iterations),
              depends_on=list(req.depends_on), solver="anneal",
              precision="float32", population=1024, steps=steps, seed=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.solve(list(req.graphs), req.objective, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches = device_ms_by_kernel(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out = {"population": 1024, "steps": steps, "precision": "float32",
           "wall_ms": wall_ms, "device_kernels": launches}
    if busy == 0:
        out["device_busy_share"] = "not measured"
    else:
        out["device_busy_share"] = busy / wall_ms
        out["device_ms"] = busy
        out["top_kernels_ms"] = {k[:60]: v for k, v in top}
        # the two hand-written search kernels' share of the device time
        out["search_kernels_ms"] = {
            name: sum(v for k, v in kernels.items() if name in k)
            for name in ("slowdown_kernel", "select_kernel")}
    print(f"  profiled one solve: {out}")
    return out


# ---------------------------------------------------------------------------
# characterize
# ---------------------------------------------------------------------------
def characterize(fa, da, sd, se, st) -> dict:
    """The port's profiling CLI on full-width stablelm-1.6b, then a solve
    from its bundle through ``Scheduler.from_bundle``."""
    from repro_torch.core import Scheduler
    from repro_torch.launch.profile import main as profile_main
    from repro_torch.profiling import ProfileBundle, harness

    # the flash count where each group's runner is made: the CLI drives
    # the groups one after another, so the differences are per group
    marks = []
    make_runner = harness._group_runner

    def marked_runner(*args, **kwargs):
        marks.append(fa.launches)
        return make_runner(*args, **kwargs)

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "stablelm-1.6b.json"
        argv = ["--executor", "torch", "--arch", "stablelm-1.6b", "--fit",
                "piecewise", "--solve", "--solver", "anneal", "--out",
                str(path)]
        print(f"  python -m repro_torch.launch.profile {' '.join(argv)}")
        harness._group_runner = marked_runner
        fa.launches = da.launches = sd.launches = se.launches = 0
        st.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            rc = profile_main(argv)
        finally:
            harness._group_runner = make_runner
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches,
                    "decode_attention": da.launches,
                    "piecewise_slowdown": sd.launches,
                    "anneal_select": se.launches, "stream": st.launches}
        require(rc == 0, f"profile CLI exited {rc}")
        bundle = ProfileBundle.load(path)
    prov = bundle.provenance
    calls = prov["timer"]["warmup"] + prov["timer"]["repeats"]
    per_group = [b - a for a, b in zip(marks, marks[1:] + [fa.launches])]
    for g, n in zip(prov["groups"], per_group):
        print(f"  {g['name']}: {g['median_ms']:.4f} ms (n={g['n_kept']}/"
              f"{g['n_total']}, std {g['std_ms']:.4f}), {n} flash launches")
    print(f"  probe peak {prov['peak_stream_bytes_per_s'] / 1e9:.2f} GB/s "
          f"(32 MB pass); target pass {prov['stream_base_ms']:.4f} ms")
    for c in prov["corun"]:
        print(f"  demand {c['ext']:g}: co-run {c['co_ms']:.4f} ms, ratio "
              f"{c['ratio']:.4f}, slowdown {c['slowdown']:.4f}, "
              f"antagonist {c['probe_passes']} passes x "
              f"{c['probe_bytes_per_pass'] / 1e6:.1f} MB in "
              f"{c['probe_s']:.3f} s = {c['probe_bytes_per_s'] / 1e9:.2f} "
              f"GB/s")
    fit = prov["fit"]
    print(f"  fit {type(bundle.model).__name__}: rmse {fit['rmse']:.4f}, "
          f"max_rel {fit['max_rel_err']:.2%}, {fit['steps']} Adam steps; "
          f"bundle {bundle.bundle_hash()}; launches {launches}; "
          f"{wall:.1f} s")
    layers = 3                          # per group: 24 layers in 8 groups
    require(len(bundle.graphs) == 1 and len(bundle.graphs[0]) == 8
            and len(per_group) == 8,
            f"expected 8 measured groups, got {per_group}")
    require(all(n == layers * calls for n in per_group),
            f"flash launches per group {per_group} != {layers} x {calls}")
    stream_calls = 2 * calls + sum(calls + c["probe_passes"]
                                   for c in prov["corun"])
    require(all(c["probe_passes"] > 0 for c in prov["corun"]),
            "the antagonist made no pass at some demand level")
    require(launches["stream"] == stream_calls,
            f"stream launches {launches['stream']} != {stream_calls} "
            f"(peak and target {calls} each, plus each level's target "
            f"calls and antagonist passes)")
    require(launches["piecewise_slowdown"] > 0
            and launches["anneal_select"] > 0,
            f"the CLI's anneal solve launched no search kernel: {launches}")
    again = ProfileBundle.from_json(bundle.to_json())
    require(again.bundle_hash() == bundle.bundle_hash(),
            "bundle did not round-trip")
    # each sample is its level's measured co-run over the standalone pass,
    # floored at 1 (a co-run read faster than standalone is noise)
    want = [(c["ext"], max(1.0, c["co_ms"] / prov["stream_base_ms"]))
            for c in prov["corun"]]
    require(len(bundle.samples) == len(want) and all(
        s[1] == e and s[2] == w >= 1.0
        for s, (e, w) in zip(bundle.samples, want)),
        f"co-run samples {bundle.samples} are not the measured slowdowns "
        f"{want}")
    print(f"  fit warning: {prov['fit_warning']}")

    sched = Scheduler.from_bundle(bundle, evaluator="torch")
    require(sched.device.type == "cuda", f"solved on {sched.device}")
    sd.launches = se.launches = 0
    steps = 64
    t0 = time.perf_counter()
    plan = sched.solve(list(bundle.graphs), "latency", solver="anneal",
                       max_transitions=2, population=1024, steps=steps,
                       seed=0)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    search_launches = {"piecewise_slowdown": sd.launches,
                       "anneal_select": se.launches}
    greedy = sched.solve(list(bundle.graphs), "latency", solver="greedy",
                         max_transitions=2)
    print(f"  from_bundle(evaluator='torch') on cuda: {plan.summary()}")
    print(f"  anneal {plan.objective!r} in {solve_s:.2f} s (launches "
          f"{search_launches}) vs greedy {greedy.objective!r}")
    require(search_launches["piecewise_slowdown"] > 0
            and search_launches["anneal_select"] == steps,
            f"search kernels did not launch: {search_launches}")
    require(plan.objective <= greedy.objective
            + 1e-9 * abs(greedy.objective), "anneal worse than greedy")
    return dict(argv=argv, wall_s=wall, launches=launches,
                flash_per_group=per_group, groups=prov["groups"],
                peak_stream_bytes_per_s=prov["peak_stream_bytes_per_s"],
                stream_base_ms=prov["stream_base_ms"], corun=prov["corun"],
                samples=[list(x) for x in bundle.samples], fit=fit,
                model=type(bundle.model).__name__,
                bundle_hash=bundle.bundle_hash(),
                search_cands_per_s=prov.get("search_cands_per_s"),
                device=prov.get("device"),
                from_bundle=dict(objective=plan.objective,
                                 assignments=[list(a) for a in
                                              plan.assignments],
                                 solve_s=solve_s, launches=search_launches,
                                 greedy_objective=greedy.objective))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import search as se
    from repro_torch.kernels import slowdown as sd
    from repro_torch.kernels import stream as st
    from repro_torch.profiling import probes
    from repro_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    print("[1/7] environment")
    print(f"  card: {card_line()}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    print("[2/7] build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:      # one nvcc per source, at once
        list(pool.map(_build.load, KERNEL_SOURCES))
    build_s = time.perf_counter() - t0
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)}: {len(KERNEL_SOURCES)} "
          f"kernels built in {build_s:.1f} s")

    print("[3/7] kernels vs plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = flash_checks(fa, gen, dev) + decode_checks(da, gen, dev)
    slowdown_checks(sd, gen, dev)
    n += 6 + select_checks(se, gen, dev, L=2 * 32)
    n += stream_checks(st, gen, dev)
    timer = Timer(dev)
    # the orin fixture's search: 4096 chains x 2 workloads x 32 groups
    kernels = [time_flash(fa, timer, gen, dev),
               time_decode(da, timer, gen, dev),
               time_slowdown(sd, timer, gen, dev, n=4096 * 2),
               time_select(se, timer, gen, dev, P=4096, L=2 * 32),
               time_stream(st, probes, timer, dev)]
    for kr in kernels:
        lib = ("none" if kr["library_ms"] is None
               else f"{kr['library_ms']:.4f} ms")
        print(f"  {kr['name']} at {kr['shape']}: {kr['ms']:.4f} ms, plain "
              f"{kr['plain_ms']:.4f} ms, library {lib}, "
              f"bound {kr['bound_ms']:.4f} ms ({kr['bound_by']})")
    print(f"  {n} comparisons passed")

    print("[4/7] serve full-width stablelm-1.6b")
    result = serve(fa, da, dev)
    print("[5/7] float32 end to end, kernel path vs plain path")
    result["e2e_f32_logits_rel_err"] = e2e_f32(dev)
    print("[6/7] schedule search under PCCS on the golden fixtures")
    found = search(sd, se, dev)
    print("[7/7] characterize full-width stablelm-1.6b, calibrate, solve")
    t0 = time.perf_counter()
    measured = characterize(fa, da, sd, se, st)
    measured["phase_s"] = time.perf_counter() - t0
    print(f"  characterize phase {measured['phase_s']:.1f} s")
    launches = dict(result["launches"], **found["orin_x64_cuda"]["launches"],
                    stream=measured["launches"]["stream"])
    for kr in kernels:
        kr["launches"] = launches[kr["name"]]
    found["build_s"] = build_s
    print(json.dumps({"serve": result}))
    print(json.dumps({"search": found}))
    print(json.dumps({"characterize": measured}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
