"""Pluggable migration topologies for the island engine (a copy of
``repro.core.topology``; pure Python, no device code).

The archipelago's one coordination decision is *which* islands exchange
candidates.  The paper's §4.3 transfer result (an MHA-evolved genome
warm-starting the GQA island in minutes) is driven entirely by cross-lineage
migration, and island systems in the FunSearch / EvoPrompting family
consistently find that the exchange graph matters as much as the island
count.  This module makes that graph a policy object, as the evaluation
backends are:

  ``RingTopology``      island *i* donates to *i+1* (mod N) — the
                        original static ring, and still the default;
  ``StarTopology``      every spoke donates to the hub and the hub donates
                        back; the hub is re-elected each barrier as the
                        current best-coverage island, so the strongest
                        lineage both collects and broadcasts;
  ``AllToAllTopology``  every ordered pair — maximum mixing, O(N^2) rescoring
                        cost per barrier;
  ``ExplicitTopology``  a fixed user-supplied edge list with add/remove —
                        the escape hatch for custom graphs and for tests;
  ``AdaptiveTopology``  starts as the ring and *learns* the graph: per-edge
                        acceptance-rate EMAs (tracked in ``MigrationStats``)
                        prune edges that keep donating rejected migrants and
                        trial new edges on a deterministic seeded schedule.

Determinism contract: ``edges()`` must be a pure function of (its own
serializable state, ``n_islands``, the stats record).  Every topology
round-trips through ``state()`` / ``load_state()``, and the engine persists
that state (plus the stats) at each epoch barrier — so a killed
``AdaptiveTopology`` run resumes with the exact EMA values, pruned edge set,
and trial schedule position it died with, and makes the same migration
decisions an uninterrupted run would have made.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterable, Optional, Protocol, runtime_checkable

Edge = tuple[int, int]


# -- acceptance accounting -------------------------------------------------------


@dataclass
class EdgeStat:
    """Lifetime accounting for one directed migration edge."""
    attempts: int = 0
    accepts: int = 0
    ema: float = 0.0     # exponential moving average of accept (1) / reject (0)


class MigrationStats:
    """Per-edge migration acceptance record, shared engine <-> topology.

    The engine calls :meth:`record` for every *attempted* migration (donor had
    a best commit and the edge was scheduled); adaptive topologies read the
    EMAs back through :meth:`ema`.  ``island_best`` is refreshed by the engine
    at each barrier (per-island best geomean on its own suite) so topologies
    can rank islands — e.g. the star's hub election — without reaching into
    engine internals.  Only the edge record is persistent state; island_best
    is recomputed every barrier.
    """

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self.edges: dict[Edge, EdgeStat] = {}
        self.island_best: list[float] = []

    def record(self, src: int, dst: int, accepted: bool) -> None:
        st = self.edges.setdefault((src, dst), EdgeStat())
        x = 1.0 if accepted else 0.0
        st.ema = x if st.attempts == 0 else \
            (1.0 - self.alpha) * st.ema + self.alpha * x
        st.attempts += 1
        st.accepts += int(accepted)

    def attempts(self, edge: Edge) -> int:
        st = self.edges.get(edge)
        return st.attempts if st else 0

    def accepts(self, edge: Edge) -> int:
        st = self.edges.get(edge)
        return st.accepts if st else 0

    def ema(self, edge: Edge, default: float = 0.0) -> float:
        st = self.edges.get(edge)
        return st.ema if st else default

    def donor_quality(self, src: int, default: float = 0.5) -> float:
        """Mean acceptance EMA over this donor's observed outgoing edges —
        how often the rest of the archipelago finds its migrants useful."""
        emas = [st.ema for (s, _), st in self.edges.items() if s == src]
        return sum(emas) / len(emas) if emas else default

    # -- persistence (sorted for stable file content) -----------------------------
    def to_payload(self) -> dict:
        return {"alpha": self.alpha,
                "edges": [[s, d, st.attempts, st.accepts, st.ema]
                          for (s, d), st in sorted(self.edges.items())]}

    @classmethod
    def from_payload(cls, payload: dict) -> "MigrationStats":
        out = cls(alpha=payload.get("alpha", 0.5))
        for s, d, attempts, accepts, ema in payload.get("edges", []):
            out.edges[(int(s), int(d))] = EdgeStat(int(attempts), int(accepts),
                                                   float(ema))
        return out


# -- the protocol ----------------------------------------------------------------


@runtime_checkable
class MigrationTopology(Protocol):
    """What the engine needs from a topology: an ordered edge list per barrier
    plus exact state round-tripping for killed-run resume."""

    name: str

    def edges(self, n_islands: int, stats: MigrationStats) -> list[Edge]:
        """Directed (donor, recipient) pairs for this barrier, in the order
        migrations are attempted.  Must be deterministic given (state, n,
        stats); may advance internal state (e.g. the adaptive epoch counter).
        """
        ...

    def state(self) -> dict:
        ...

    def load_state(self, state: dict) -> None:
        ...


def ring_edges(n: int) -> list[Edge]:
    """i -> i+1 (mod n); no self-migration, so a single island has no edges."""
    return [(i, (i + 1) % n) for i in range(n)] if n > 1 else []


class _StatelessTopology:
    """Base for topologies whose edge list is a pure function of (n, stats)."""

    name = "stateless"

    def state(self) -> dict:
        return {}

    def load_state(self, state: dict) -> None:
        pass

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class RingTopology(_StatelessTopology):
    """The static ring — still the default, bit-for-bit unchanged."""

    name = "ring"

    def edges(self, n_islands: int, stats: MigrationStats) -> list[Edge]:
        return ring_edges(n_islands)


class StarTopology(_StatelessTopology):
    """Spokes donate to the hub, then the hub donates back to every spoke.

    The hub is re-elected every barrier: the island with the current best
    geomean on its own suite (``stats.island_best``; ties break to the lowest
    index, and an empty record elects island 0).  Spoke->hub edges run first
    so the order is deterministic; donors are snapshotted by the engine, so
    the hub's outbound migrant is its *pre-barrier* best either way.
    """

    name = "star"

    @staticmethod
    def hub(n_islands: int, stats: MigrationStats) -> int:
        best = stats.island_best[:n_islands]
        if not best:
            return 0
        return max(range(len(best)), key=lambda i: (best[i], -i))

    def edges(self, n_islands: int, stats: MigrationStats) -> list[Edge]:
        if n_islands <= 1:
            return []
        hub = self.hub(n_islands, stats)
        spokes = [i for i in range(n_islands) if i != hub]
        return [(i, hub) for i in spokes] + [(hub, i) for i in spokes]


class AllToAllTopology(_StatelessTopology):
    """Every ordered pair — maximum mixing at O(N^2) rescoring per barrier."""

    name = "all-to-all"

    def edges(self, n_islands: int, stats: MigrationStats) -> list[Edge]:
        return [(i, j) for i in range(n_islands)
                for j in range(n_islands) if i != j]


class ExplicitTopology:
    """A fixed user-supplied edge list (plus add/remove for live rewiring).

    Invalid edges — self-loops or endpoints outside the archipelago — are
    skipped at ``edges()`` time rather than rejected at construction, so one
    instance works across engines of different sizes.
    """

    name = "explicit"

    def __init__(self, edges: Iterable[Edge] = ()):
        self._edges: list[Edge] = [(int(s), int(d)) for s, d in edges]

    def add_edge(self, src: int, dst: int) -> None:
        if (src, dst) not in self._edges:
            self._edges.append((src, dst))

    def remove_edge(self, src: int, dst: int) -> None:
        self._edges = [e for e in self._edges if e != (src, dst)]

    def edges(self, n_islands: int, stats: MigrationStats) -> list[Edge]:
        return [(s, d) for s, d in self._edges
                if s != d and 0 <= s < n_islands and 0 <= d < n_islands]

    def state(self) -> dict:
        return {"edges": [list(e) for e in self._edges]}

    def load_state(self, state: dict) -> None:
        self._edges = [(int(s), int(d)) for s, d in state.get("edges", [])]

    def __repr__(self) -> str:
        return f"ExplicitTopology({self._edges!r})"


class AdaptiveTopology:
    """Ring-seeded learned topology: prune dead edges, trial promising ones.

    Each barrier, in order:

      1. **prune** — an active edge whose acceptance EMA has decayed below
         ``prune_below`` after at least ``prune_after`` attempted migrations
         is removed, *unless* removal would leave its donor with no outgoing
         edge or its recipient with no incoming edge (every island keeps
         donating and receiving, so no lineage is ever isolated);
      2. **trial** — every ``trial_interval``-th barrier, one currently
         inactive edge is added, sampled with weights
         ``trial_floor + donor_quality(src)`` (donors whose migrants the
         archipelago has historically accepted get trialled more, unobserved
         donors still get the floor) from ``random.Random`` seeded by the
         string ``"seed:epoch:n"`` — a counter-based schedule with no
         carried RNG state, so resuming from a persisted epoch counter
         replays the exact same trials.

    All decision state is {epoch counter, active edge set}; the EMAs live in
    the engine-owned :class:`MigrationStats`, which the engine persists right
    next to this topology's :meth:`state` — together they make kill/resume
    decisions identical to an uninterrupted run, step for step.
    """

    name = "adaptive"

    def __init__(self, seed: int = 0, trial_interval: int = 2,
                 prune_after: int = 4, prune_below: float = 0.15,
                 trial_floor: float = 0.25):
        self.seed = seed
        self.trial_interval = max(1, trial_interval)
        self.prune_after = prune_after
        self.prune_below = prune_below
        self.trial_floor = trial_floor
        self._epoch = 0
        self._n: Optional[int] = None
        self._active: list[Edge] = []

    # -- the per-barrier decision --------------------------------------------------
    def edges(self, n_islands: int, stats: MigrationStats) -> list[Edge]:
        n = n_islands
        if n <= 1:
            return []
        if self._n != n:
            self._n = n                       # (re)seed from the ring
            self._active = ring_edges(n)
        epoch, self._epoch = self._epoch, self._epoch + 1

        # prune: drop persistently-rejected edges, never isolating an island
        out_deg = {i: 0 for i in range(n)}
        in_deg = {i: 0 for i in range(n)}
        for s, d in self._active:
            out_deg[s] += 1
            in_deg[d] += 1
        kept: list[Edge] = []
        for s, d in sorted(self._active):
            dead = (stats.attempts((s, d)) >= self.prune_after
                    and stats.ema((s, d)) < self.prune_below)
            if dead and out_deg[s] > 1 and in_deg[d] > 1:
                out_deg[s] -= 1
                in_deg[d] -= 1
            else:
                kept.append((s, d))
        self._active = kept

        # trial: deterministically sample one new edge on the schedule
        if epoch > 0 and epoch % self.trial_interval == 0:
            active = set(self._active)
            candidates = [(i, j) for i in range(n) for j in range(n)
                          if i != j and (i, j) not in active]
            if candidates:
                weights = [self.trial_floor + stats.donor_quality(s)
                           for s, _ in candidates]
                rng = random.Random(f"{self.seed}:{epoch}:{n}")
                self._active.append(
                    rng.choices(candidates, weights=weights, k=1)[0])

        self._active = sorted(set(self._active))
        return list(self._active)

    # -- persistence ---------------------------------------------------------------
    def state(self) -> dict:
        return {"epoch": self._epoch, "n": self._n,
                "active": [list(e) for e in self._active]}

    def load_state(self, state: dict) -> None:
        self._epoch = int(state.get("epoch", 0))
        n = state.get("n")
        self._n = int(n) if n is not None else None
        self._active = [(int(s), int(d)) for s, d in state.get("active", [])]

    def __repr__(self) -> str:
        return (f"AdaptiveTopology(seed={self.seed}, epoch={self._epoch}, "
                f"active={self._active})")


# -- registry --------------------------------------------------------------------

TOPOLOGIES: dict[str, type] = {
    "ring": RingTopology,
    "star": StarTopology,
    "all-to-all": AllToAllTopology,
    "adaptive": AdaptiveTopology,
}


def topology_names() -> tuple[str, ...]:
    """Registered topology names, for CLI choices and benchmark sweeps."""
    return tuple(TOPOLOGIES)


def make_topology(spec: "str | MigrationTopology" = "ring", *,
                  seed: int = 0) -> MigrationTopology:
    """Build a topology from a spec string ('ring' | 'star' | 'all-to-all' |
    'adaptive') or pass an instance through unchanged.  ``seed`` feeds the
    adaptive trial schedule; stateless topologies ignore it."""
    if not isinstance(spec, str):
        return spec
    name = spec.lower().replace("_", "-")
    if name in ("alltoall", "all2all", "full"):
        name = "all-to-all"
    cls = TOPOLOGIES.get(name)
    if cls is None:
        raise ValueError(f"unknown topology {spec!r}; "
                         f"known: {', '.join(TOPOLOGIES)}")
    return cls(seed=seed) if cls is AdaptiveTopology else cls()
