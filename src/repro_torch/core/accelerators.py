"""Accelerator and platform specifications.

A :class:`Platform` is a set of accelerators plus the *contention domains*
that tie them together.  On the paper's SoCs the single domain is the external
memory controller (EMC) shared by GPU and DLA/DSP; on a TPU pod a domain is
the shared ICI boundary between two submeshes (and optionally per-chip HBM
for co-resident streams).  The scheduler only ever sees accelerator names,
per-layer times/demands, transition costs and a contention model — so SoC and
pod platforms are interchangeable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping

MS = 1e-3
GB = 1e9


@dataclass(frozen=True)
class Accelerator:
    """One schedulable processing unit (DSA, GPU, or TPU submesh)."""

    name: str
    #: peak dense compute, FLOP/s (used by analytic characterization).
    peak_flops: float
    #: private memory bandwidth available to this accelerator, bytes/s.
    mem_bw: float
    #: fixed per-transition overhead entering/leaving this accelerator (ms).
    #: Models reformatting (SoC) / layout+dispatch latency (TPU).
    transition_in_ms: float = 0.0
    transition_out_ms: float = 0.0
    #: chips composing this accelerator (1 for an SoC DSA; >1 for a submesh).
    n_chips: int = 1


@dataclass(frozen=True)
class Platform:
    """Accelerator set + shared-resource topology + transition bandwidth."""

    name: str
    accelerators: tuple[Accelerator, ...]
    #: bandwidth of the shared path used by inter-accelerator transitions
    #: (EMC on the SoC, ICI bisection on the pod), bytes/s.
    transition_bw: float
    #: contention domains: domain name -> member accelerator names.  Layers
    #: running concurrently on accelerators of the same domain contend.
    domains: Mapping[str, tuple[str, ...]] = field(default_factory=dict)
    #: capacity of each contention domain's shared path, bytes/s (EMC
    #: bandwidth on the SoC, ICI boundary bandwidth on a pod).  Demand
    #: fractions in LayerGroup.mem_demand are relative to this.
    domain_bw: Mapping[str, float] = field(default_factory=dict)
    #: ε of Eq. 9 — tolerated same-accelerator overlap (ms).
    epsilon_ms: float = 0.05

    def __post_init__(self):
        names = [a.name for a in self.accelerators]
        if len(set(names)) != len(names):
            raise ValueError("duplicate accelerator names")
        for dom, members in self.domains.items():
            for m in members:
                if m not in names:
                    raise ValueError(f"domain {dom} references unknown acc {m}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.accelerators)

    def acc(self, name: str) -> Accelerator:
        for a in self.accelerators:
            if a.name == name:
                return a
        raise KeyError(name)

    def shared_domain_of(self, a: str, b: str) -> str | None:
        """First contention domain containing both accelerators, if any."""
        for dom, members in self.domains.items():
            if a in members and b in members:
                return dom
        return None

    def transition_cost_ms(self, out_bytes: float, src: str, dst: str) -> float:
        """τ(L, src, OUT) + τ(L', dst, IN) of Eq. 2 for a given boundary."""
        if src == dst:
            return 0.0
        move = out_bytes / self.transition_bw / MS if self.transition_bw else 0.0
        return move + self.acc(src).transition_out_ms + self.acc(dst).transition_in_ms


# ---------------------------------------------------------------------------
# Paper platforms (Table 4).  peak_flops/mem_bw are the published specs; the
# calibrated profiles in profiles.py carry the actual per-layer timings, so
# these constants only matter for analytic (roofline) characterization.
# ---------------------------------------------------------------------------

def xavier_agx() -> Platform:
    return Platform(
        name="xavier-agx",
        accelerators=(
            Accelerator("GPU", peak_flops=11e12, mem_bw=136.5 * GB,
                        transition_out_ms=0.002, transition_in_ms=0.002),
            Accelerator("DLA", peak_flops=5.7e12, mem_bw=136.5 * GB,
                        transition_out_ms=0.004, transition_in_ms=0.004),
        ),
        transition_bw=136.5 * GB,
        domains={"EMC": ("GPU", "DLA")},
        domain_bw={"EMC": 136.5 * GB},
    )


def agx_orin() -> Platform:
    return Platform(
        name="agx-orin",
        accelerators=(
            Accelerator("GPU", peak_flops=42e12, mem_bw=204.8 * GB,
                        transition_out_ms=0.001, transition_in_ms=0.001),
            Accelerator("DLA", peak_flops=11e12, mem_bw=204.8 * GB,
                        transition_out_ms=0.002, transition_in_ms=0.002),
        ),
        transition_bw=204.8 * GB,
        domains={"EMC": ("GPU", "DLA")},
        domain_bw={"EMC": 204.8 * GB},
    )


def snapdragon_865() -> Platform:
    return Platform(
        name="snapdragon-865",
        accelerators=(
            Accelerator("GPU", peak_flops=1.8e12, mem_bw=34.1 * GB,
                        transition_out_ms=0.05, transition_in_ms=0.05),
            Accelerator("DSP", peak_flops=1.0e12, mem_bw=34.1 * GB,
                        transition_out_ms=0.08, transition_in_ms=0.08),
        ),
        transition_bw=34.1 * GB,
        domains={"EMC": ("GPU", "DSP")},
        domain_bw={"EMC": 34.1 * GB},
    )


# ---------------------------------------------------------------------------
# TPU v5e pod platforms: virtual accelerators = disjoint submeshes.
# ---------------------------------------------------------------------------

V5E_PEAK_FLOPS = 197e12      # bf16 / chip
V5E_HBM_BW = 819 * GB        # / chip
V5E_ICI_BW = 50 * GB         # / link


def tpu_pod_split(n_chips_a: int = 128, n_chips_b: int = 128,
                  name: str = "v5e-pod-split") -> Platform:
    """One pod split into two virtual accelerators sharing the ICI boundary.

    The split boundary of a (16,16) pod crossed by 16 links gives the shared
    domain capacity used by the contention model; transitions between
    submeshes reshard activations across the same boundary.
    """
    links = 16
    return Platform(
        name=name,
        accelerators=(
            Accelerator("MESH_A", peak_flops=n_chips_a * V5E_PEAK_FLOPS,
                        mem_bw=n_chips_a * V5E_HBM_BW, n_chips=n_chips_a,
                        transition_out_ms=0.01, transition_in_ms=0.01),
            Accelerator("MESH_B", peak_flops=n_chips_b * V5E_PEAK_FLOPS,
                        mem_bw=n_chips_b * V5E_HBM_BW, n_chips=n_chips_b,
                        transition_out_ms=0.01, transition_in_ms=0.01),
        ),
        transition_bw=links * V5E_ICI_BW,
        domains={"ICI": ("MESH_A", "MESH_B")},
        domain_bw={"ICI": links * V5E_ICI_BW},
        epsilon_ms=0.02,
    )


PLATFORMS: dict[str, Callable[[], Platform]] = {
    "xavier-agx": xavier_agx,
    "agx-orin": agx_orin,
    "snapdragon-865": snapdragon_865,
    "v5e-pod-split": tpu_pod_split,
}
