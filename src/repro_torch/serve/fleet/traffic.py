"""Seeded open-loop arrival traces for fleet-scale serving.

Production traffic is *open-loop*: users do not wait for the previous
response before sending the next request, so the arrival process — not the
server — sets the offered load, and queueing explodes the moment sustained
arrival rate crosses service capacity.  This module generates the three
arrival shapes the serving literature calls out as production-like (MoCA's
multi-tenant QoS mixes; the mobile-SoC LLM characterization's bursty and
diurnal request streams, see PAPERS.md):

* :func:`poisson_trace` — memoryless constant-rate arrivals (the classic
  M/G/k offered load);
* :func:`bursty_trace` — a 2-state Markov-modulated Poisson process
  (MMPP-2): exponentially-dwelling calm/burst states with different rates,
  producing the heavy-tailed queueing that defeats mean-rate provisioning;
* :func:`diurnal_trace` — a piecewise-constant daily rate profile replayed
  over as many days as needed (non-homogeneous Poisson per bucket).

Every generator is **bit-deterministic for a fixed seed** (one
``numpy.random.default_rng(seed)`` stream, fixed draw order) and returns an
:class:`ArrivalTrace` — a frozen, array-backed, content-hashable artifact
with a versioned JSON format (:meth:`ArrivalTrace.save` /
:meth:`ArrivalTrace.load`), so a million-request load test is a few dozen
bytes of generator parameters plus a seed, and a *measured* production
trace can be replayed through the same interface.

Times are milliseconds, rates requests/second; ``tenant`` is an integer id
in ``[0, n_tenants)`` — the fleet loop maps tenants onto model classes.
"""
from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np

from repro_torch.core.plan import canonical_hash

FORMAT = 1
KINDS = ("poisson", "bursty", "diurnal", "custom")

#: default relative load per hour-of-day for :func:`diurnal_trace` — a
#: stylized consumer curve: overnight trough, morning ramp, evening peak.
DIURNAL_PROFILE = (
    0.15, 0.10, 0.08, 0.08, 0.10, 0.15, 0.25, 0.40, 0.55, 0.65, 0.70, 0.75,
    0.80, 0.75, 0.70, 0.70, 0.75, 0.85, 1.00, 0.95, 0.80, 0.60, 0.40, 0.25,
)


@dataclass(frozen=True)
class ArrivalTrace:
    """A frozen, array-backed open-loop arrival trace."""

    kind: str
    seed: int
    n_tenants: int
    #: generator parameters (JSON-serializable; provenance only).
    params: Mapping[str, Any]
    t_ms: np.ndarray                     # (N,) float64, non-decreasing
    tenant: np.ndarray                   # (N,) int32 in [0, n_tenants)
    prompt_len: np.ndarray               # (N,) int32 >= 1
    max_new: np.ndarray                  # (N,) int32 >= 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown trace kind {self.kind!r}; "
                             f"one of {', '.join(KINDS)}")
        if self.n_tenants < 1:
            raise ValueError("n_tenants must be >= 1")
        arrays = {
            "t_ms": np.ascontiguousarray(self.t_ms, np.float64),
            "tenant": np.ascontiguousarray(self.tenant, np.int32),
            "prompt_len": np.ascontiguousarray(self.prompt_len, np.int32),
            "max_new": np.ascontiguousarray(self.max_new, np.int32),
        }
        n = len(arrays["t_ms"])
        for name, arr in arrays.items():
            if arr.ndim != 1 or len(arr) != n:
                raise ValueError(f"{name} must be 1-D with {n} entries")
            arr.setflags(write=False)
            object.__setattr__(self, name, arr)
        if n:
            if np.any(np.diff(arrays["t_ms"]) < 0.0):
                raise ValueError("arrival times must be non-decreasing")
            if arrays["t_ms"][0] < 0.0:
                raise ValueError("arrival times must be >= 0")
            t = arrays["tenant"]
            if t.min() < 0 or t.max() >= self.n_tenants:
                raise ValueError(f"tenant ids must be in [0, "
                                 f"{self.n_tenants})")
            if arrays["prompt_len"].min() < 1 or arrays["max_new"].min() < 1:
                raise ValueError("prompt_len and max_new must be >= 1")
        object.__setattr__(self, "params", dict(self.params))

    # -- views -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.t_ms)

    @property
    def duration_ms(self) -> float:
        return float(self.t_ms[-1] - self.t_ms[0]) if len(self) else 0.0

    @property
    def mean_rate_rps(self) -> float:
        if len(self) < 2 or self.duration_ms <= 0.0:
            return 0.0
        return 1e3 * (len(self) - 1) / self.duration_ms

    def burstiness(self) -> float:
        """Coefficient of variation of inter-arrival gaps (1.0 = Poisson)."""
        gaps = np.diff(self.t_ms)
        if len(gaps) < 2 or gaps.mean() <= 0.0:
            return 0.0
        return float(gaps.std() / gaps.mean())

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "format": FORMAT,
            "kind": self.kind,
            "seed": self.seed,
            "n_tenants": self.n_tenants,
            "params": dict(self.params),
            "t_ms": [float(t) for t in self.t_ms],
            "tenant": [int(t) for t in self.tenant],
            "prompt_len": [int(p) for p in self.prompt_len],
            "max_new": [int(m) for m in self.max_new],
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ArrivalTrace":
        if d.get("format") != FORMAT:
            raise ValueError(
                f"unsupported trace format {d.get('format')!r} "
                f"(this build reads format {FORMAT})")
        return cls(kind=d["kind"], seed=d["seed"],
                   n_tenants=d["n_tenants"], params=dict(d["params"]),
                   t_ms=np.asarray(d["t_ms"], np.float64),
                   tenant=np.asarray(d["tenant"], np.int32),
                   prompt_len=np.asarray(d["prompt_len"], np.int32),
                   max_new=np.asarray(d["max_new"], np.int32))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "ArrivalTrace":
        return cls.from_dict(json.loads(s))

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "ArrivalTrace":
        return cls.from_json(pathlib.Path(path).read_text())

    def trace_hash(self) -> str:
        """Content hash of the canonical JSON form (replay provenance)."""
        return canonical_hash(self.to_dict())


# ---------------------------------------------------------------------------
# shared sampling helpers
# ---------------------------------------------------------------------------

def _tenant_weights(n_tenants: int, skew: float) -> np.ndarray:
    """Zipf-like tenant popularity: p(i) ∝ (i+1)^-skew (skew=0 uniform)."""
    w = (np.arange(n_tenants, dtype=np.float64) + 1.0) ** -float(skew)
    return w / w.sum()


def _sample_request_columns(rng: np.random.Generator, n: int,
                            n_tenants: int, skew: float,
                            prompt_len: tuple[int, int],
                            max_new: tuple[int, int]):
    tenant = rng.choice(n_tenants, size=n,
                        p=_tenant_weights(n_tenants, skew)).astype(np.int32)
    plen = rng.integers(prompt_len[0], prompt_len[1] + 1,
                        size=n).astype(np.int32)
    mnew = rng.integers(max_new[0], max_new[1] + 1, size=n).astype(np.int32)
    return tenant, plen, mnew


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def poisson_trace(rate_rps: float, n_requests: int, n_tenants: int,
                  seed: int = 0, *, skew: float = 0.0,
                  prompt_len: tuple[int, int] = (8, 64),
                  max_new: tuple[int, int] = (4, 32),
                  start_ms: float = 0.0) -> ArrivalTrace:
    """Memoryless constant-rate arrivals (homogeneous Poisson process)."""
    if rate_rps <= 0.0:
        raise ValueError("rate_rps must be > 0")
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1e3 / rate_rps, size=n_requests)
    t = start_ms + np.cumsum(gaps)
    tenant, plen, mnew = _sample_request_columns(
        rng, n_requests, n_tenants, skew, prompt_len, max_new)
    return ArrivalTrace(
        kind="poisson", seed=seed, n_tenants=n_tenants,
        params={"rate_rps": rate_rps, "n_requests": n_requests,
                "skew": skew, "prompt_len": list(prompt_len),
                "max_new": list(max_new), "start_ms": start_ms},
        t_ms=t, tenant=tenant, prompt_len=plen, max_new=mnew)


def bursty_trace(base_rps: float, burst_rps: float, n_requests: int,
                 n_tenants: int, seed: int = 0, *,
                 mean_calm_s: float = 20.0, mean_burst_s: float = 4.0,
                 skew: float = 0.0,
                 prompt_len: tuple[int, int] = (8, 64),
                 max_new: tuple[int, int] = (4, 32)) -> ArrivalTrace:
    """2-state Markov-modulated Poisson process (calm rate / burst rate).

    The state dwells exponentially (``mean_calm_s`` / ``mean_burst_s``)
    and arrivals within a dwell are homogeneous Poisson at the state's
    rate — the canonical bursty load model: mean rate can be far below
    capacity while bursts transiently oversubscribe it.
    """
    if base_rps <= 0.0 or burst_rps <= 0.0:
        raise ValueError("rates must be > 0")
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    rng = np.random.default_rng(seed)
    times: list[np.ndarray] = []
    total, t0, state = 0, 0.0, 0        # state 0 = calm, 1 = burst
    while total < n_requests:
        dwell_ms = rng.exponential(
            1e3 * (mean_burst_s if state else mean_calm_s))
        rate = burst_rps if state else base_rps
        k = int(rng.poisson(rate * dwell_ms / 1e3))
        if k:
            seg = np.sort(rng.uniform(t0, t0 + dwell_ms, size=k))
            times.append(seg)
            total += k
        t0 += dwell_ms
        state ^= 1
    t = np.concatenate(times)[:n_requests]
    tenant, plen, mnew = _sample_request_columns(
        rng, n_requests, n_tenants, skew, prompt_len, max_new)
    return ArrivalTrace(
        kind="bursty", seed=seed, n_tenants=n_tenants,
        params={"base_rps": base_rps, "burst_rps": burst_rps,
                "n_requests": n_requests, "mean_calm_s": mean_calm_s,
                "mean_burst_s": mean_burst_s, "skew": skew,
                "prompt_len": list(prompt_len), "max_new": list(max_new)},
        t_ms=t, tenant=tenant, prompt_len=plen, max_new=mnew)


def diurnal_trace(peak_rps: float, n_requests: int, n_tenants: int,
                  seed: int = 0, *, day_s: float = 86_400.0,
                  profile: tuple[float, ...] = DIURNAL_PROFILE,
                  skew: float = 0.0,
                  prompt_len: tuple[int, int] = (8, 64),
                  max_new: tuple[int, int] = (4, 32)) -> ArrivalTrace:
    """Daily rate-profile replay (non-homogeneous Poisson, piecewise rate).

    ``profile`` gives one relative rate per equal bucket of the day (24
    hourly buckets by default); the instantaneous rate in bucket ``b`` is
    ``peak_rps * profile[b] / max(profile)``.  Days repeat until
    ``n_requests`` arrivals are generated — a compressed ``day_s`` (e.g.
    60 s) replays the whole diurnal swing inside one benchmark run.
    """
    if peak_rps <= 0.0:
        raise ValueError("peak_rps must be > 0")
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    prof = np.asarray(profile, np.float64)
    if prof.ndim != 1 or len(prof) < 1 or prof.min() < 0.0 or prof.max() <= 0:
        raise ValueError("profile must be non-negative with a positive peak")
    rng = np.random.default_rng(seed)
    bucket_ms = 1e3 * day_s / len(prof)
    rates = peak_rps * prof / prof.max()
    times: list[np.ndarray] = []
    total, t0, b = 0, 0.0, 0
    while total < n_requests:
        rate = rates[b % len(rates)]
        k = int(rng.poisson(rate * bucket_ms / 1e3)) if rate > 0 else 0
        if k:
            seg = np.sort(rng.uniform(t0, t0 + bucket_ms, size=k))
            times.append(seg)
            total += k
        t0 += bucket_ms
        b += 1
    t = np.concatenate(times)[:n_requests]
    tenant, plen, mnew = _sample_request_columns(
        rng, n_requests, n_tenants, skew, prompt_len, max_new)
    return ArrivalTrace(
        kind="diurnal", seed=seed, n_tenants=n_tenants,
        params={"peak_rps": peak_rps, "n_requests": n_requests,
                "day_s": day_s, "profile": [float(p) for p in prof],
                "skew": skew, "prompt_len": list(prompt_len),
                "max_new": list(max_new)},
        t_ms=t, tenant=tenant, prompt_len=plen, max_new=mnew)


GENERATORS = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
    "diurnal": diurnal_trace,
}

#: CLI spec aliases -> generator kwargs (``parse_trace_spec``).
_SPEC_KEYS = {
    "rate": "rate_rps", "base": "base_rps", "burst": "burst_rps",
    "peak": "peak_rps", "n": "n_requests", "tenants": "n_tenants",
    "seed": "seed", "skew": "skew", "calm_s": "mean_calm_s",
    "burst_s": "mean_burst_s", "day_s": "day_s",
}
_INT_KEYS = {"n_requests", "n_tenants", "seed"}


def parse_trace_spec(spec: str) -> ArrivalTrace:
    """Build a trace from a CLI spec: a JSON file path, or
    ``kind:key=value,...`` (e.g. ``poisson:rate=200,n=1000,tenants=64`` or
    ``bursty:base=50,burst=400,n=5000,tenants=128,seed=7``)."""
    path = pathlib.Path(spec)
    if path.exists():
        return ArrivalTrace.load(path)
    kind, _, rest = spec.partition(":")
    if kind not in GENERATORS:
        raise ValueError(
            f"unknown trace spec {spec!r}: not a file, and kind {kind!r} "
            f"is not one of {', '.join(GENERATORS)}")
    kwargs: dict[str, Any] = {}
    for item in filter(None, rest.split(",")):
        key, _, val = item.partition("=")
        name = _SPEC_KEYS.get(key, key)
        kwargs[name] = int(val) if name in _INT_KEYS else float(val)
    missing = ({"rate_rps"} if kind == "poisson"
               else {"base_rps", "burst_rps"} if kind == "bursty"
               else {"peak_rps"})
    missing |= {"n_requests", "n_tenants"}
    missing -= set(kwargs)
    if missing:
        raise ValueError(f"trace spec {spec!r} is missing "
                         f"{', '.join(sorted(missing))}")
    n = kwargs.pop("n_requests")
    tenants = kwargs.pop("n_tenants")
    if kind == "poisson":
        return poisson_trace(kwargs.pop("rate_rps"), n, tenants, **kwargs)
    if kind == "bursty":
        return bursty_trace(kwargs.pop("base_rps"),
                            kwargs.pop("burst_rps"), n, tenants, **kwargs)
    return diurnal_trace(kwargs.pop("peak_rps"), n, tenants, **kwargs)
