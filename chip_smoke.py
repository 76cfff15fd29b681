"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root (``src/`` is put on ``sys.path`` here).
Phases, each fatal on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc/`` for
   ``sm_90a``, one ``nvcc`` per source, started together;
3. kernels: each kernel against its plain PyTorch version on the card
   (float32 at atol = rtol = 2e-5, bfloat16 at 2e-2: the tolerances of
   ``tests/test_kernels.py``), then timed (CUDA events, L2 flushed before
   each call, median) beside its plain version, its roofline bound and
   ``F.scaled_dot_product_attention`` as the library yardstick;
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
   fault from rounding.

The last line is the contract line ``{"ok": true, "device": {...}}``;
before it come one ``{"kernels": [...]}`` line and the card's
``nvidia-smi`` name and power limit.  Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 bytes/s
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
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
    kernels = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0))
        if t > 0 and evt.device_type.name == "CUDA":
            kernels[evt.key] = kernels.get(evt.key, 0.0) + t / 1e3
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    print("[1/5] environment")
    print(f"  card: {card_line()}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    print("[2/5] build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:      # one nvcc per source, at once
        list(pool.map(_build.load, ("flash_attention", "decode_attention")))
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)}: both kernels built in "
          f"{time.perf_counter() - t0:.1f} s")

    print("[3/5] kernels vs plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = flash_checks(fa, gen, dev) + decode_checks(da, gen, dev)
    timer = Timer(dev)
    kernels = [time_flash(fa, timer, gen, dev),
               time_decode(da, timer, gen, dev)]
    for kr in kernels:
        print(f"  {kr['name']} at {kr['shape']}: {kr['ms']:.4f} ms, plain "
              f"{kr['plain_ms']:.4f} ms, library {kr['library_ms']:.4f} ms, "
              f"bound {kr['bound_ms']:.4f} ms ({kr['bound_by']})")
    print(f"  {n} comparisons passed")

    print("[4/5] serve full-width stablelm-1.6b")
    result = serve(fa, da, dev)
    print("[5/5] float32 end to end, kernel path vs plain path")
    result["e2e_f32_logits_rel_err"] = e2e_f32(dev)
    for kr in kernels:
        kr["launches"] = result["launches"][kr["name"]]
    print(json.dumps({"serve": result}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
