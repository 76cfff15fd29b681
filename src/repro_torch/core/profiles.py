"""Paper-calibrated DNN layer-group profiles (§3.2, Tables 2 & 5).

The paper publishes (a) full per-group profiles for GoogleNet on Xavier
(Table 2: GPU/DLA times, G→D transition times, requested memory throughput),
(b) whole-network standalone runtimes for ten DNNs on both NVIDIA platforms
(Table 5), and (c) qualitative per-network characteristics (D/G ratio ranges
per net, which nets are compute- vs memory-intensive, where DLA is
proportionally fast).  We reconstruct layer-group profiles as follows:

  * GoogleNet uses Table 2 verbatim, rescaled so column totals match the
    Table 5 standalone totals of the target platform.
  * Every other network gets a documented group template: per-group GPU time
    weights (sum 1), per-group DLA/GPU ratios (inside the published per-net
    ranges: VGG-19 1.2–3.4x, ResNet152 1.3–1.9x, GoogleNet 1.40–2.02x),
    per-group requested memory throughput (shaped like Table 2: higher for
    early large-activation groups; low overall for compute-dense CaffeNet per
    §5.4 obs. 3), and boundary activation sizes (decreasing with depth, cheap
    after pooling, Table 2 col 5).  Totals are rescaled to Table 5.
  * Snapdragon 865 profiles are anchored to the Table 6 GPU-only latencies of
    experiments 9–10 with a uniform DSP/GPU ratio of 1.5 (the paper: "GPU &
    DSP are more balanced ... in this platform").

Absolute times therefore match the paper where published; where only totals
or ranges are published the shapes are synthetic-but-constrained, and
EXPERIMENTS.md compares *improvement percentages* (the paper's headline
claims) rather than absolute milliseconds.
"""
from __future__ import annotations

from dataclasses import dataclass

from .accelerators import MS, Platform
from .graph import DNNGraph, LayerGroup

KB = 1e3
MB = 1e6

# ---------------------------------------------------------------------------
# Table 5 standalone runtimes (ms): (orin_gpu, orin_dla, xavier_gpu, xavier_dla)
# ---------------------------------------------------------------------------
TABLE5 = {
    "caffenet":   (0.74, 1.79, 2.26, 5.51),
    "densenet":   (2.19, 3.10, 7.84, None),
    "googlenet":  (0.99, 1.52, 1.98, 3.68),
    "inc-res-v2": (3.06, 5.15, 15.12, 17.95),
    "inception":  (2.49, 5.66, 8.31, 15.94),
    "resnet18":   (0.41, 0.74, 1.37, 2.81),
    "resnet50":   (0.91, 1.67, 2.88, 6.01),
    "resnet101":  (1.56, 2.47, 5.34, 10.60),
    "resnet152":  (2.19, 3.26, 7.70, 12.71),
    "vgg19":      (1.07, 2.93, 5.95, 19.05),
    # not in Table 5 — calibrated from experiment rows / sized analogues:
    "alexnet":    (0.74, 1.79, 2.26, 5.51),   # CaffeNet twin (AlexNet deploy)
    "fcn-resnet18": (1.60, 2.70, 5.70, 11.40),  # Exp 5 residual budget
    "mobilenet":  (0.60, 1.00, 1.90, 3.60),
    "vgg16":      (0.95, 2.60, 5.30, 17.00),
}

# ---------------------------------------------------------------------------
# Table 2: GoogleNet on Xavier — (gpu_ms, dla_ms, trans_G2D_ms, mem_thr_frac)
# ---------------------------------------------------------------------------
TABLE2_GOOGLENET = (
    ("g0-9",     0.45, 0.75, 0.056, 0.4197),
    ("g10-24",   0.19, 0.34, 0.075, 0.6221),
    ("g25-38",   0.31, 0.45, 0.062, 0.7849),
    ("g39-53",   0.18, 0.37, 0.011, 0.5341),
    ("g54-66",   0.16, 0.31, 0.055, 0.5570),
    ("g67-80",   0.17, 0.33, 0.024, 0.5924),
    ("g81-94",   0.21, 0.31, 0.058, 0.6260),
    ("g95-109",  0.25, 0.35, 0.030, 0.7612),
    ("g110-123", 0.16, 0.27, 0.024, 0.6695),
    ("g124-140", 0.24, 0.36, 0.007, 0.4796),
)

# ---------------------------------------------------------------------------
# Group templates for the other networks:
#   (weight of GPU time, DLA/GPU ratio, GPU mem demand, boundary out bytes)
# Ratios stay inside published ranges; demands follow the Table-2 shape.
# ---------------------------------------------------------------------------
_T = {
    "vgg19": [   # paper: ratios 1.2-3.4; DLA proportionally fast EARLY
        (0.22, 1.25, 0.82, 3.2 * MB), (0.18, 1.60, 0.74, 1.6 * MB),
        (0.20, 2.60, 0.60, 0.8 * MB), (0.16, 3.40, 0.48, 0.4 * MB),
        (0.14, 3.20, 0.42, 0.2 * MB), (0.10, 2.40, 0.30, 40 * KB),
    ],
    "vgg16": [
        (0.24, 1.30, 0.80, 3.2 * MB), (0.20, 1.70, 0.72, 1.6 * MB),
        (0.22, 2.70, 0.58, 0.8 * MB), (0.18, 3.30, 0.46, 0.4 * MB),
        (0.16, 2.50, 0.32, 40 * KB),
    ],
    "resnet101": [  # ratios 1.3-1.9 (ResNet-152 range shared)
        (0.08, 1.90, 0.78, 1.6 * MB), (0.10, 1.80, 0.66, 0.8 * MB),
        (0.13, 1.70, 0.60, 0.8 * MB), (0.13, 1.60, 0.56, 0.4 * MB),
        (0.13, 1.55, 0.52, 0.4 * MB), (0.13, 1.45, 0.50, 0.4 * MB),
        (0.20, 1.30, 0.44, 0.2 * MB), (0.10, 1.40, 0.34, 16 * KB),
    ],
    "resnet152": [
        (0.07, 1.90, 0.78, 1.6 * MB), (0.09, 1.80, 0.66, 0.8 * MB),
        (0.12, 1.72, 0.62, 0.8 * MB), (0.14, 1.62, 0.58, 0.4 * MB),
        (0.14, 1.55, 0.54, 0.4 * MB), (0.14, 1.48, 0.50, 0.4 * MB),
        (0.20, 1.32, 0.44, 0.2 * MB), (0.10, 1.40, 0.34, 16 * KB),
    ],
    "resnet50": [
        (0.12, 1.85, 0.76, 1.6 * MB), (0.18, 1.70, 0.64, 0.8 * MB),
        (0.22, 1.60, 0.56, 0.4 * MB), (0.28, 1.45, 0.48, 0.2 * MB),
        (0.20, 1.35, 0.36, 16 * KB),
    ],
    "resnet18": [
        (0.18, 1.95, 0.74, 0.8 * MB), (0.24, 1.80, 0.62, 0.4 * MB),
        (0.28, 1.65, 0.52, 0.2 * MB), (0.30, 1.50, 0.40, 16 * KB),
    ],
    "inception": [  # Inception-V4; avg ratio ~1.9
        (0.10, 2.10, 0.72, 1.2 * MB), (0.11, 2.00, 0.66, 0.8 * MB),
        (0.12, 1.95, 0.62, 0.8 * MB), (0.12, 1.90, 0.58, 0.6 * MB),
        (0.12, 1.88, 0.56, 0.6 * MB), (0.11, 1.85, 0.54, 0.4 * MB),
        (0.11, 1.82, 0.50, 0.4 * MB), (0.11, 1.78, 0.46, 0.2 * MB),
        (0.10, 1.70, 0.38, 24 * KB),
    ],
    "inc-res-v2": [  # 985 layers -> most groups; avg ratio ~1.19
        (0.08, 1.35, 0.70, 1.2 * MB), (0.08, 1.30, 0.66, 0.8 * MB),
        (0.09, 1.28, 0.62, 0.8 * MB), (0.09, 1.25, 0.60, 0.6 * MB),
        (0.09, 1.22, 0.58, 0.6 * MB), (0.09, 1.20, 0.56, 0.6 * MB),
        (0.08, 1.18, 0.54, 0.4 * MB), (0.08, 1.16, 0.52, 0.4 * MB),
        (0.08, 1.14, 0.50, 0.4 * MB), (0.08, 1.12, 0.46, 0.2 * MB),
        (0.08, 1.10, 0.42, 0.2 * MB), (0.08, 1.08, 0.36, 24 * KB),
    ],
    "caffenet": [  # compute-dense, little contention pressure (§5.4 obs. 3)
        (0.26, 2.60, 0.38, 1.0 * MB), (0.22, 2.50, 0.32, 0.6 * MB),
        (0.20, 2.45, 0.28, 0.3 * MB), (0.18, 2.35, 0.22, 0.2 * MB),
        (0.14, 2.25, 0.16, 16 * KB),
    ],
    "alexnet": [
        (0.26, 2.60, 0.38, 1.0 * MB), (0.22, 2.50, 0.32, 0.6 * MB),
        (0.20, 2.45, 0.28, 0.3 * MB), (0.18, 2.35, 0.22, 0.2 * MB),
        (0.14, 2.25, 0.16, 16 * KB),
    ],
    "densenet": [  # DLA proportionally fast LATE (§5.4 obs. 2)
        (0.14, 1.75, 0.76, 1.2 * MB), (0.14, 1.65, 0.70, 0.8 * MB),
        (0.13, 1.55, 0.66, 0.8 * MB), (0.13, 1.45, 0.62, 0.6 * MB),
        (0.12, 1.35, 0.58, 0.4 * MB), (0.12, 1.25, 0.52, 0.4 * MB),
        (0.12, 1.12, 0.46, 0.2 * MB), (0.10, 1.05, 0.38, 24 * KB),
    ],
    "fcn-resnet18": [
        (0.16, 2.10, 0.78, 1.6 * MB), (0.20, 2.00, 0.70, 0.8 * MB),
        (0.22, 1.90, 0.62, 0.8 * MB), (0.22, 1.95, 0.66, 1.6 * MB),
        (0.20, 2.05, 0.72, 3.2 * MB),   # upsampling head: big activations
    ],
    "mobilenet": [
        (0.22, 1.70, 0.60, 0.6 * MB), (0.26, 1.60, 0.54, 0.3 * MB),
        (0.28, 1.55, 0.48, 0.2 * MB), (0.24, 1.45, 0.36, 16 * KB),
    ],
}

DNN_SET = ("caffenet", "densenet", "googlenet", "inc-res-v2", "inception",
           "resnet18", "resnet50", "resnet101", "resnet152", "vgg19")


@dataclass(frozen=True)
class _PlatKey:
    gpu_col: int
    dla_col: int
    dsa_name: str


_PLATFORM_COLS = {
    "agx-orin": _PlatKey(0, 1, "DLA"),
    "xavier-agx": _PlatKey(2, 3, "DLA"),
}

# Snapdragon 865: GPU anchored to Table-6 GPU-only rows (exp 9-10), DSP=1.5x.
_SD865_GPU_SCALE = 13.4   # x Xavier-GPU ms; fits 98.3ms (exp9), 219.6 (exp10)
_SD865_DSP_RATIO = 1.5


def _transition_bytes(platform: Platform, trans_ms: float,
                      src: str = "GPU", dst: str = "DLA") -> float:
    fixed = (platform.acc(src).transition_out_ms
             + platform.acc(dst).transition_in_ms)
    return max(0.0, (trans_ms - fixed) * MS) * platform.transition_bw


def get_graph(dnn: str, platform: Platform) -> DNNGraph:
    """Layer-group graph of ``dnn`` calibrated for ``platform``."""
    dnn = dnn.lower()
    if dnn not in TABLE5:
        raise KeyError(f"unknown DNN {dnn!r}; have {sorted(TABLE5)}")

    if platform.name == "snapdragon-865":
        g_tot = TABLE5[dnn][2] * _SD865_GPU_SCALE
        d_tot = g_tot * _SD865_DSP_RATIO
        dsa = "DSP"
    elif platform.name in _PLATFORM_COLS:
        key = _PLATFORM_COLS[platform.name]
        g_tot = TABLE5[dnn][key.gpu_col]
        d_tot = TABLE5[dnn][key.dla_col]
        dsa = key.dsa_name
    else:
        raise ValueError(f"no paper profiles for platform {platform.name!r}")

    if dnn == "googlenet":
        gpu_raw = sum(r[1] for r in TABLE2_GOOGLENET)
        dla_raw = sum(r[2] for r in TABLE2_GOOGLENET)
        groups = []
        for name, g, d, tr, thr in TABLE2_GOOGLENET:
            t_gpu = g * g_tot / gpu_raw
            times = {"GPU": t_gpu}
            demand = {"GPU": thr}
            if d_tot is not None:
                t_dla = d * d_tot / dla_raw
                times[dsa] = t_dla
                # §3.3 black-box estimate: scale GPU demand by the EMC
                # utilization ratio (calibrated as sqrt of the time ratio —
                # DLA moves the same bytes over a longer window but with
                # burstier, less latency-tolerant access).
                demand[dsa] = thr * (t_gpu / t_dla) ** 0.5
            groups.append(LayerGroup(
                name=name, times=times, mem_demand=demand,
                out_bytes=_transition_bytes(
                    platform, tr, "GPU",
                    dsa if dsa in times else platform.names[-1]),
            ))
        return DNNGraph(dnn, tuple(groups))

    tpl = _T[dnn]
    wsum = sum(w for w, *_ in tpl)
    groups = []
    for gi, (w, ratio, thr, out_b) in enumerate(tpl):
        t_gpu = g_tot * w / wsum
        times = {"GPU": t_gpu}
        demand = {"GPU": thr}
        if d_tot is not None:
            # per-group ratios are shape; normalize so DLA total matches.
            ratio_norm = d_tot / g_tot
            ratio_scale = ratio_norm / (
                sum(wi * ri for wi, ri, *_ in tpl) / wsum)
            t_dla = t_gpu * ratio * ratio_scale
            times[dsa] = t_dla
            demand[dsa] = thr * (t_gpu / t_dla) ** 0.5
        groups.append(LayerGroup(
            name=f"{dnn}-g{gi}", times=times, mem_demand=demand,
            out_bytes=out_b))
    return DNNGraph(dnn, tuple(groups))


def chain(*graphs: DNNGraph) -> DNNGraph:
    """Serially-dependent DNNs as one schedulable chain (Scenario 4 pairs)."""
    groups = []
    for g in graphs:
        groups.extend(g.groups)
    return DNNGraph("+".join(g.name for g in graphs), tuple(groups))
