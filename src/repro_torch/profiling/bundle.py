"""ProfileBundle: the measured-characterization artifact.

A schedule's quality is bounded by its characterization, so the
characterization deserves the same artifact treatment as the schedule
itself (:class:`~repro_torch.core.plan.Plan`): a :class:`ProfileBundle` packs
the measured platform, the measured per-group graphs, the calibrated
contention model and the raw (own, external) → slowdown samples into one
versioned, **content-hashed** JSON document with provenance (executor,
backend/device, timer config, sample counts, fit residuals).

Loading recomputes the payload hash and refuses a mismatch — a
hand-edited or format-drifted bundle fails loudly instead of silently
mis-costing every schedule solved from it.  ``platform_from_bundle`` /
``scheduler_from_bundle`` close the loop: a
:class:`~repro_torch.core.scheduler.Scheduler` solves directly from measured
profiles, no paper tables involved.

**Lineage.**  Online recalibration (:mod:`repro_torch.profiling.online`)
republishes bundles as the platform drifts; every such bundle carries
``parent_hash`` — the content hash of the bundle its model was warm-started
from — inside the hashed payload, so a live surface is auditable back to
its offline ancestor and the chain itself is tamper-evident
(:meth:`ProfileBundle.derive`, :func:`verify_lineage`).  Payload fields
are frozen after construction: the content hash is cached on first use,
and a mutable payload would let ``save()`` emit a stale hash that
``from_dict`` then rejects as corruption.  Non-identity metadata
(``provenance``, ``created_at``) stays writable.
"""
from __future__ import annotations

import json
import pathlib
import time
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

from ..core import registry
from ..core.accelerators import Platform
from ..core.graph import DNNGraph
from ..core.plan import (canonical_hash, graph_from_dict, graph_to_dict,
                         platform_from_dict, platform_to_dict)
from .harness import Sample

FORMAT = 1


@dataclass
class ProfileBundle:
    """Measured platform + graphs + calibrated model, content-addressed."""

    platform: Platform
    graphs: tuple[DNNGraph, ...]
    #: the calibrated contention model (any registered codec kind).
    model: Any
    #: raw calibration samples, kept for re-fits and residual audits.
    samples: tuple[Sample, ...] = ()
    #: executor/backend/device/timer/residual metadata; not part of the
    #: content hash (it carries timestamps and wall-clock counts).
    provenance: dict = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    #: content hash of the bundle this one was recalibrated from (online
    #: re-fit lineage); None for offline root bundles.  Part of the hashed
    #: payload when set, so the lineage chain is itself tamper-evident.
    parent_hash: str | None = None

    #: payload fields sealed after __post_init__ — the content hash is
    #: cached on first use and must never go stale against the payload.
    _PAYLOAD_FIELDS = frozenset(
        {"platform", "graphs", "model", "samples", "parent_hash"})

    def __post_init__(self):
        if not self.graphs:
            raise ValueError("bundle has no measured graphs")
        self.graphs = tuple(self.graphs)
        self.samples = tuple(tuple(float(x) for x in s)
                             for s in self.samples)
        names = set(self.platform.names)
        for g in self.graphs:
            if not names & set(g.accelerators):
                raise ValueError(
                    f"measured graph {g.name!r} covers no accelerator of "
                    f"platform {self.platform.name!r}")
        self.__dict__["_sealed"] = True

    def __setattr__(self, name: str, value) -> None:
        if name in self._PAYLOAD_FIELDS and self.__dict__.get("_sealed"):
            raise AttributeError(
                f"ProfileBundle payload is frozen: {name!r} participates "
                f"in the content hash; build a new bundle (see .derive()) "
                f"instead of mutating this one")
        super().__setattr__(name, value)

    # -- identity ---------------------------------------------------------
    def payload_dict(self) -> dict:
        """The hashed content: everything that affects a solve."""
        d = {
            "format": FORMAT,
            "platform": platform_to_dict(self.platform),
            "graphs": [graph_to_dict(g) for g in self.graphs],
            "model": registry.encode_model(self.model),
            "samples": [list(s) for s in self.samples],
        }
        # omitted when unset so pre-lineage format-1 hashes stay valid.
        if self.parent_hash is not None:
            d["parent_hash"] = self.parent_hash
        return d

    def bundle_hash(self) -> str:
        cached = self.__dict__.get("_hash")
        if cached is None:
            cached = canonical_hash(self.payload_dict())
            self.__dict__["_hash"] = cached
        return cached

    def derive(self, *, model: Any | None = None,
               samples: Sequence | None = None,
               provenance: Mapping[str, Any] | None = None,
               ) -> "ProfileBundle":
        """A child bundle with ``parent_hash`` pointing back at this one.

        The online recalibrator publishes every re-fit through here:
        platform and measured graphs carry over, the model (and usually
        the supporting sample window) are replaced, and the returned
        bundle's hash covers the lineage pointer.
        """
        return ProfileBundle(
            platform=self.platform,
            graphs=self.graphs,
            model=self.model if model is None else model,
            samples=self.samples if samples is None else tuple(samples),
            provenance=dict(provenance if provenance is not None
                            else self.provenance),
            parent_hash=self.bundle_hash(),
        )

    @property
    def graph_names(self) -> tuple[str, ...]:
        return tuple(g.name for g in self.graphs)

    def graph(self, name: str) -> DNNGraph:
        for g in self.graphs:
            if g.name == name:
                return g
        raise KeyError(
            f"no measured graph {name!r}; bundle has: "
            f"{', '.join(self.graph_names)}")

    def summary(self) -> str:
        prov = self.provenance
        rows = [f"profile-bundle {self.bundle_hash()[:12]} "
                f"platform={self.platform.name} "
                f"model={type(self.model).__name__} "
                f"samples={len(self.samples)}"]
        if "fit" in prov:
            f = prov["fit"]
            rows.append(f"  fit: rmse={f.get('rmse', float('nan')):.4f} "
                        f"max_rel={f.get('max_rel_err', float('nan')):.2%}")
        rows.append(f"  executor={prov.get('executor', '?')} "
                    f"backend={prov.get('torch_backend', 'n/a')} "
                    f"device={prov.get('device', 'n/a')}")
        for g in self.graphs:
            accs = ", ".join(f"{a}={g.standalone_time(a):.3f}ms"
                             for a in g.accelerators)
            rows.append(f"    {g.name}: {len(g)} groups ({accs})")
        return "\n".join(rows)

    # -- (de)serialization ------------------------------------------------
    def to_dict(self) -> dict:
        return {**self.payload_dict(),
                "bundle_hash": self.bundle_hash(),
                "provenance": dict(self.provenance),
                "created_at": self.created_at}

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ProfileBundle":
        if d.get("format") != FORMAT:
            raise ValueError(
                f"unsupported profile-bundle format {d.get('format')!r} "
                f"(this build reads format {FORMAT})")
        bundle = cls(
            platform=platform_from_dict(d["platform"]),
            graphs=tuple(graph_from_dict(g) for g in d["graphs"]),
            model=registry.decode_model(d["model"]),
            samples=tuple(tuple(s) for s in d["samples"]),
            provenance=dict(d.get("provenance", {})),
            created_at=d.get("created_at", 0.0),
            parent_hash=d.get("parent_hash"),
        )
        recomputed = bundle.bundle_hash()
        if recomputed != d["bundle_hash"]:
            raise ValueError(
                "profile bundle is corrupt or was produced by an "
                f"incompatible build: stored hash {d['bundle_hash'][:12]} "
                f"!= recomputed {recomputed[:12]}")
        return bundle

    @classmethod
    def from_json(cls, s: str) -> "ProfileBundle":
        return cls.from_dict(json.loads(s))

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "ProfileBundle":
        return cls.from_json(pathlib.Path(path).read_text())


def verify_lineage(chain: Sequence[ProfileBundle]) -> None:
    """Validate a root-first recalibration chain.

    Each bundle after the first must carry ``parent_hash`` equal to its
    predecessor's content hash (which :meth:`ProfileBundle.bundle_hash`
    recomputes over the payload, so a tampered ancestor breaks every
    descendant).  Raises ``ValueError`` on the first broken link.
    """
    for i in range(1, len(chain)):
        want = chain[i - 1].bundle_hash()
        got = chain[i].parent_hash
        if got != want:
            raise ValueError(
                f"broken bundle lineage at link {i}: parent_hash "
                f"{(got or 'none')[:12]} != ancestor {want[:12]}")


def platform_from_bundle(bundle: ProfileBundle | str | pathlib.Path
                         ) -> Platform:
    """The measured platform of a bundle (accepts a path for CLI use)."""
    if not isinstance(bundle, ProfileBundle):
        bundle = ProfileBundle.load(bundle)
    return bundle.platform


def scheduler_from_bundle(bundle: ProfileBundle | str | pathlib.Path,
                          **kwargs):
    """A :class:`~repro_torch.core.scheduler.Scheduler` solving from measured
    profiles: the bundle's platform + its calibrated contention model.

    Schedule the bundle's *measured* graphs by passing them (or their
    names resolved via :meth:`ProfileBundle.graph`) to ``solve``::

        sched = scheduler_from_bundle("artifacts/profiles/orin.json")
        plan = sched.solve([b.graph("vgg19"), b.graph("resnet152")])
    """
    from ..core.scheduler import Scheduler

    if not isinstance(bundle, ProfileBundle):
        bundle = ProfileBundle.load(bundle)
    kwargs.setdefault("model", bundle.model)
    return Scheduler(bundle.platform, **kwargs)
