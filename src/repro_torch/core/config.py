"""Typed configuration objects for the island engine (a copy of
``repro.core.config`` with two more fields on :class:`EvalConfig`).

:class:`IslandEvolution` takes ~20 flat keyword arguments; this module
collapses them into three composable dataclasses —

  :class:`EvalConfig`       how candidates are scored: backend name (resolved
                            through the evals backend registry), worker
                            counts, elasticity, the service bind address, the
                            multi-fidelity cascade knobs, and (the port's
                            two) the device workers score on and rung 0's
                            machine
  :class:`MigrationConfig`  the epoch-barrier migration policy: topology,
                            interval, migrant payload policy
  :class:`EngineConfig`     everything else the engine itself owns: island
                            count/specs, suite, seed, persistence,
                            pipelining, prefetch — plus the two sections

— accepted as ``IslandEvolution(config=EngineConfig(...))``.  The old flat
kwargs keep working through :func:`engine_config_from_legacy`, a mapping shim
that emits one :class:`DeprecationWarning` per alias per process, so every
existing call site migrates on its own schedule.

Configs round-trip through the archipelago persistence payload
(:meth:`EngineConfig.to_payload` / :meth:`EngineConfig.from_payload`): a run
persisted by a kwarg-path engine resumes under the config path, and
``IslandEvolution.resume(path)`` can rebuild the whole engine from the
payload alone.  Runtime-only fields (an injected shared coordinator, the
scheduling tenant) are deliberately excluded from the payload — they name
live resources of ONE process, not search state.  ``device`` and ``machine``
are persisted as strings.  The cascade fields stay so that the payload keeps
the reference's shape; the port's engine refuses ``cascade_eta`` until the
cascade is ported.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

from repro_torch.core.perfmodel import BenchConfig

__all__ = ["EvalConfig", "MigrationConfig", "EngineConfig",
           "engine_config_from_legacy", "reset_deprecation_warnings"]


@dataclass
class EvalConfig:
    """How the engine pays for scoring.  ``backend`` names an entry in the
    evals backend registry (``registered_backends()``); ``coordinator`` /
    ``tenant`` are runtime-only injection points the search frontier uses to
    run many engines against one shared worker fleet (never persisted).
    ``device`` is where every evaluation scores (``None``: the card;
    ``"cpu"``: the plain PyTorch path) and ``machine`` rung 0's model
    (``None``: the default, ``"tpu_v5e"``; or ``"h100"``)."""
    backend: str = "thread"
    check_correctness: bool = True
    elastic_workers: int = 0         # process backend: ElasticProcessPool cap
    service_workers: int = 0         # service backend: localhost workers
    service_listen: str = "127.0.0.1:0"
    cascade_eta: Optional[int] = None    # >= 2 turns on the fidelity cascade
    cascade_slate: int = 8
    cascade_promote: bool = True
    device: Optional[str] = None          # None: the card
    machine: Optional[str] = None         # rung 0's model; None: tpu_v5e
    coordinator: Optional[object] = None  # runtime-only: shared EvalCoordinator
    tenant: str = ""                      # runtime-only: scheduling tenant


@dataclass
class MigrationConfig:
    """The epoch-barrier migration policy."""
    topology: Union[str, object] = "ring"   # name or MigrationTopology
    interval: int = 4                       # steps per epoch barrier
    migrant_policy: str = "best"            # 'best' | 'top-k'
    migrant_k: int = 3


@dataclass
class EngineConfig:
    """The full engine configuration: engine-owned fields at the top level,
    scoring under ``evals``, migration under ``migration``."""
    n_islands: int = 4
    specs: Optional[Sequence] = None        # Sequence[IslandSpec]
    suite: Optional[Sequence[BenchConfig]] = None
    seed: int = 0
    persist_path: Optional[str] = None
    max_workers: Optional[int] = None
    supervisor_patience: int = 3
    prefetch: int = 0
    prefetch_budget: Optional[int] = None
    pipeline: bool = False
    evals: EvalConfig = field(default_factory=EvalConfig)
    migration: MigrationConfig = field(default_factory=MigrationConfig)

    @classmethod
    def from_kwargs(cls, **kw) -> "EngineConfig":
        """Build a config from the historical flat kwargs WITHOUT deprecation
        warnings — the supported flat constructor for scripts that want one
        call (benchmarks, tests): ``EngineConfig.from_kwargs(backend=...,
        topology=..., n_islands=...)``."""
        return _from_flat(kw)

    # -- persistence ---------------------------------------------------------
    def to_payload(self) -> dict:
        """JSON/pickle-safe payload for the archipelago save file.  Runtime-
        only fields (coordinator, tenant) are excluded; a non-string topology
        instance serializes as its ``name`` (its *state* rides separately in
        the engine payload); specs serialize only when fully declarative
        (string operators) — an engine built around live operator objects
        persists its lineages, not its constructors."""
        ev = {f.name: getattr(self.evals, f.name)
              for f in dataclasses.fields(self.evals)
              if f.name not in ("coordinator", "tenant")}
        for name in ("device", "machine"):
            if ev[name] is not None:
                ev[name] = str(ev[name])
        topo = self.migration.topology
        mig = dataclasses.asdict(self.migration)
        mig["topology"] = topo if isinstance(topo, str) \
            else getattr(topo, "name", "ring")
        payload = {
            "n_islands": self.n_islands,
            "seed": self.seed,
            "persist_path": self.persist_path,
            "max_workers": self.max_workers,
            "supervisor_patience": self.supervisor_patience,
            "prefetch": self.prefetch,
            "prefetch_budget": self.prefetch_budget,
            "pipeline": self.pipeline,
            "evals": ev,
            "migration": mig,
        }
        if self.suite is not None:
            payload["suite"] = [dataclasses.asdict(c) for c in self.suite]
        if self.specs is not None and all(
                isinstance(getattr(s, "operator", None), str)
                for s in self.specs):
            payload["specs"] = [
                {"name": s.name, "operator": s.operator,
                 "target_suite": s.target_suite,
                 "init_genome": (list(s.init_genome.to_edits())
                                 if s.init_genome is not None else None),
                 "agent_kwargs": dict(s.agent_kwargs)}
                for s in self.specs]
        return payload

    @classmethod
    def from_payload(cls, payload: dict) -> "EngineConfig":
        """Inverse of :meth:`to_payload`; tolerant of missing keys so
        archipelago payloads written before the config objects existed (and
        the reference's, which carry no device or machine) load as
        defaults."""
        from repro_torch.core.islands import IslandSpec
        from repro_torch.core.search_space import KernelGenome
        ev_fields = {f.name for f in dataclasses.fields(EvalConfig)}
        ev = EvalConfig(**{k: v for k, v in payload.get("evals", {}).items()
                           if k in ev_fields})
        mig_fields = {f.name for f in dataclasses.fields(MigrationConfig)}
        mig = MigrationConfig(
            **{k: v for k, v in payload.get("migration", {}).items()
               if k in mig_fields})
        suite = payload.get("suite")
        if suite is not None:
            suite = [BenchConfig(**c) for c in suite]
        specs = payload.get("specs")
        if specs is not None:
            specs = [IslandSpec(
                name=s.get("name", ""),
                operator=s.get("operator", "avo"),
                target_suite=s.get("target_suite"),
                init_genome=(KernelGenome.from_edits(
                    [tuple(e) for e in s["init_genome"]])
                    if s.get("init_genome") is not None else None),
                agent_kwargs=dict(s.get("agent_kwargs", ())))
                for s in specs]
        top_fields = {f.name for f in dataclasses.fields(cls)
                      if f.name not in ("evals", "migration", "suite",
                                        "specs")}
        top = {k: v for k, v in payload.items() if k in top_fields}
        return cls(suite=suite, specs=specs, evals=ev, migration=mig, **top)


# flat legacy kwarg -> (section, field); None section = EngineConfig itself
_LEGACY_MAP: dict[str, tuple[Optional[str], str]] = {
    "n_islands": (None, "n_islands"),
    "specs": (None, "specs"),
    "suite": (None, "suite"),
    "seed": (None, "seed"),
    "persist_path": (None, "persist_path"),
    "max_workers": (None, "max_workers"),
    "supervisor_patience": (None, "supervisor_patience"),
    "prefetch": (None, "prefetch"),
    "prefetch_budget": (None, "prefetch_budget"),
    "pipeline": (None, "pipeline"),
    "backend": ("evals", "backend"),
    "check_correctness": ("evals", "check_correctness"),
    "elastic_workers": ("evals", "elastic_workers"),
    "service_workers": ("evals", "service_workers"),
    "service_listen": ("evals", "service_listen"),
    "cascade_eta": ("evals", "cascade_eta"),
    "cascade_slate": ("evals", "cascade_slate"),
    "cascade_promote": ("evals", "cascade_promote"),
    "device": ("evals", "device"),
    "machine": ("evals", "machine"),
    "topology": ("migration", "topology"),
    "migration_interval": ("migration", "interval"),
    "migrant_policy": ("migration", "migrant_policy"),
    "migrant_k": ("migration", "migrant_k"),
}

# aliases already warned about this process — "exactly once per alias"
_WARNED: set[str] = set()


def reset_deprecation_warnings() -> None:
    """Test hook: forget which legacy kwargs have warned, so a test can
    assert the warning fires (it fires once per alias per process)."""
    _WARNED.clear()


def _from_flat(kw: dict) -> EngineConfig:
    unknown = set(kw) - set(_LEGACY_MAP)
    if unknown:
        raise TypeError("unknown IslandEvolution arguments: "
                        f"{sorted(unknown)}; known: {sorted(_LEGACY_MAP)}")
    top, ev, mig = {}, {}, {}
    for name, value in kw.items():
        section, fname = _LEGACY_MAP[name]
        (top if section is None else ev if section == "evals" else mig)[
            fname] = value
    return EngineConfig(evals=EvalConfig(**ev), migration=MigrationConfig(
        **mig), **top)


def engine_config_from_legacy(kw: dict) -> EngineConfig:
    """The deprecation shim behind ``IslandEvolution(**flat_kwargs)``: map
    the historical flat kwargs onto an :class:`EngineConfig`, warning once
    per alias per process.  Unknown names raise TypeError (as the old
    signature did)."""
    for name in kw:
        if name in _LEGACY_MAP and name not in _WARNED:
            _WARNED.add(name)
            section, fname = _LEGACY_MAP[name]
            dest = f"EngineConfig.{fname}" if section is None \
                else f"EngineConfig.{section}.{fname}"
            warnings.warn(
                f"IslandEvolution({name}=...) is deprecated; pass "
                f"IslandEvolution(config=EngineConfig(...)) with {dest} "
                "(or EngineConfig.from_kwargs for the flat spelling)",
                DeprecationWarning, stacklevel=3)
    return _from_flat(kw)
