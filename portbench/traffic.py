"""The one generator that every traffic mix (``traffic/<mix>.json``) runs.

Copied from ``src/repro_torch/serve/fleet/traffic.py`` (its Poisson and
two-state Markov-modulated Poisson arrival processes and its tenant
weights), frozen here so that a change to the program cannot move the
offered load; lognormal lengths are added, since real prompt and output
lengths are heavy-tailed where the original draws them uniformly.

A mix fixes the work and the run's seed where it starts: the gaps
between arrivals and the request sizes (tenant, prompt length, output
length) are one sequence drawn from the mix's own ``sizes_seed``, and
``--seed`` picks the rotation of that sequence the run starts from, and
draws the token ids.  Every seed so offers the same gaps and sizes in
another order, with the same neighbours; a tail such as a 95th
percentile then reads what the system does with the work, not which
requests the seed happened to put side by side (measured on the card:
with the sizes shuffled anew for each seed, the p95s of one cell spread
three to ten times wider across seeds than across runs of one seed).

Mix keys (see the files under ``traffic/``):

* ``process``: ``poisson`` (open loop at ``rate_rps``), ``bursty`` (open
  loop, ``calm_rps`` / ``burst_rps`` with mean dwells ``calm_s`` /
  ``burst_s``; its arrival times follow the run's seed, as a modulated
  process cannot be permuted) or ``closed`` (a backlog: the queue always
  holds more requests than free slots; ``pool`` sizes are drawn);
* ``prompt_len``, ``max_new``: ``{"dist": "lognormal", "median", "sigma",
  "min", "max"}`` or ``{"dist": "uniform", "min", "max"}``, in tokens;
* ``tenants``: ``{model: {"weight", "slots", "capacity"}}``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request: when it is due (seconds into the window; ``None`` in a
    closed loop, where it is due when a slot asks for it), its tenant and
    its sizes.  ``index`` numbers it within the run (its token ids)."""

    index: int
    at_s: float | None
    tenant: str
    prompt_len: int
    max_new: int


def draw_lengths(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` lengths of the distribution ``spec`` (int64, within
    ``[min, max]``)."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if not 1 <= lo <= hi:
        raise ValueError(f"lengths need 1 <= min <= max, got {spec}")
    if spec["dist"] == "lognormal":
        x = np.exp(rng.normal(math.log(spec["median"]), spec["sigma"], n))
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, size=n).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def tenant_labels(tenants: dict, n: int) -> list[str]:
    """``n`` tenant names in the proportions of the tenants' weights
    (largest remainder), in tenant order."""
    names = list(tenants)
    w = np.array([float(tenants[t]["weight"]) for t in names])
    if (w <= 0).any():
        raise ValueError("tenant weights must be > 0")
    exact = w / w.sum() * n
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts), kind="stable")[:n - counts.sum()]:
        counts[i] += 1
    return [t for t, c in zip(names, counts) for _ in range(c)]


def _sizes(mix: dict, rng: np.random.Generator, n: int):
    """``n`` request sizes in the mix's fixed order: tenants shuffled
    once by ``rng`` (the mix's ``sizes_seed``), lengths drawn from it."""
    labels = tenant_labels(mix["tenants"], n)
    tenants = [labels[i] for i in rng.permutation(n)]
    return (tenants, draw_lengths(mix["prompt_len"], rng, n),
            draw_lengths(mix["max_new"], rng, n))


def rotation(seed: int, n: int) -> np.ndarray:
    """The order in which a run of ``seed`` takes a sequence of ``n``."""
    r = int(np.random.default_rng([seed, 1]).integers(n)) if n else 0
    return (r + np.arange(n)) % n


def poisson_gaps(rng: np.random.Generator, rate_rps: float,
                 seconds: float) -> np.ndarray:
    """Exponential gaps (seconds) of a Poisson process at ``rate_rps``,
    as many as arrive within ``seconds``."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    gaps = np.zeros(0)
    while gaps.sum() < seconds:
        more = rng.exponential(1.0 / rate_rps,
                               size=max(16, int(rate_rps * seconds)))
        gaps = np.concatenate([gaps, more])
    return gaps[np.cumsum(gaps) < seconds]


def mmpp_times(rng: np.random.Generator, calm_rps: float, burst_rps: float,
               calm_s: float, burst_s: float, seconds: float) -> np.ndarray:
    """Arrival times (seconds, sorted, below ``seconds``) of the original's
    two-state Markov-modulated Poisson process, starting calm."""
    times, t0, state = [], 0.0, 0
    while t0 < seconds:
        dwell = rng.exponential(burst_s if state else calm_s)
        rate = burst_rps if state else calm_rps
        k = int(rng.poisson(rate * dwell))
        if k:
            times.append(np.sort(rng.uniform(t0, t0 + dwell, size=k)))
        t0 += dwell
        state ^= 1
    t = np.concatenate(times) if times else np.zeros(0)
    return t[t < seconds]


def open_loop(mix: dict, seed: int, seconds: float) -> list[Arrival]:
    """The arrivals of an open-loop mix over a window of ``seconds``."""
    sizes_rng = np.random.default_rng(mix["sizes_seed"])
    if mix["process"] == "poisson":
        gaps = poisson_gaps(sizes_rng, float(mix["rate_rps"]), seconds)
        order = rotation(seed, len(gaps))
        at = np.cumsum(gaps[order])
    elif mix["process"] == "bursty":
        at = mmpp_times(np.random.default_rng([seed, 2]),
                        float(mix["calm_rps"]), float(mix["burst_rps"]),
                        float(mix["calm_s"]), float(mix["burst_s"]), seconds)
        order = rotation(seed, len(at))
    else:
        raise ValueError(f"{mix['process']!r} is not an open-loop process")
    tenants, plen, mnew = _sizes(mix, sizes_rng, len(at))
    return [Arrival(i, float(at[i]), tenants[j], int(plen[j]), int(mnew[j]))
            for i, j in enumerate(order)]


def closed_loop(mix: dict, seed: int):
    """An endless backlog: the mix's ``pool`` of sizes from the seed's
    rotation, over and over."""
    if mix["process"] != "closed":
        raise ValueError(f"{mix['process']!r} is not a closed loop")
    n = int(mix["pool"])
    tenants, plen, mnew = _sizes(mix, np.random.default_rng(mix["sizes_seed"]),
                                 n)
    order = rotation(seed, n)
    index = 0
    while True:
        for j in order:
            yield Arrival(index, None, tenants[j], int(plen[j]), int(mnew[j]))
            index += 1


def prompt_ids(seed: int, index: int, length: int, vocab: int) -> np.ndarray:
    """The token ids of request ``index`` of the run of ``seed``: uniform
    over the vocabulary, drawn on their own so that any request's ids can
    be made again without the others."""
    rng = np.random.default_rng([seed, index])
    return rng.integers(0, vocab, size=length, dtype=np.int64).astype(np.int32)
