"""The agent's tool interface (paper Fig. 2: previous solutions, evaluation
utilities, tools, persistent memory).

Every call is counted — the paper reports "over 500 optimization directions"
of internal exploration; ``stats()`` reproduces that accounting.

The refuted-edit memory is a first-class object (``RefutedMemory``) so it can
be *shared*: in the island engine several Toolbelts point at one memory and an
edit falsified on one island is never re-trialled on another.
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from repro_torch.core import obs
from repro_torch.core.evals import Scorer, ScoreVector
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.population import Lineage
from repro_torch.core.search_space import KernelGenome


@dataclass
class ToolCall:
    tool: str
    detail: str = ""


class RefutedMemory:
    """Thread-safe set of refuted (genome, edit) pairs.

    A single instance may back many Toolbelts concurrently (island engine);
    all mutation happens under a lock.  ``snapshot``/``merge`` support the
    epoch-synchronized sharing the island engine uses for determinism.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: set = set()
        self.notes: list[str] = []

    def add(self, entry, note: str = "") -> None:
        with self._lock:
            self._entries.add(entry)
            if note:
                self.notes.append(note)

    def __contains__(self, entry) -> bool:
        with self._lock:
            return entry in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> frozenset:
        with self._lock:
            return frozenset(self._entries)

    def merge(self, entries: Iterable) -> None:
        with self._lock:
            self._entries.update(entries)

    # -- persistence (entries are (genome_key, ((field, value), ...)) pairs) ----
    def to_payload(self) -> list:
        """JSON-serializable entry list, sorted for stable file content."""
        with self._lock:
            entries = list(self._entries)
        payload = [[key, [list(p) for p in pairs]] for key, pairs in entries]
        return sorted(payload, key=json.dumps)

    def load_payload(self, payload: Iterable) -> None:
        """Replace the entries with a ``to_payload`` round-trip (resume)."""
        entries = {(key, tuple(tuple(p) for p in pairs))
                   for key, pairs in payload}
        with self._lock:
            self._entries = entries


class Toolbelt:
    def __init__(self, scorer: Scorer, kb: KnowledgeBase, lineage: Lineage,
                 memory: Optional[RefutedMemory] = None):
        self.scorer = scorer
        self.kb = kb
        self.lineage = lineage
        self.calls: list[ToolCall] = []
        self.n_evaluate_calls = 0     # this belt's requests (incl. cache hits)
        self.n_speculative_submits = 0  # proposal-phase submissions (pipelined)
        # persistent memory across variation steps: refuted edits per context
        self.memory_refuted = memory if memory is not None else RefutedMemory()
        self.memory_notes = self.memory_refuted.notes

    def _call(self, tool: str, detail: str = "") -> None:
        """Record one tool invocation: the per-belt call log the traces keep,
        plus a process-wide registry counter per tool name (the aggregate
        '500 optimization directions' accounting, readable without walking
        every belt)."""
        self.calls.append(ToolCall(tool, detail))
        obs.REGISTRY.counter("tool_calls", tool=tool).inc()

    # -- lineage access (the P_t the agent can consult) -------------------------
    def best_commit(self):
        self._call("lineage.best")
        return self.lineage.best()

    def recent_commits(self, n: int = 5):
        self._call("lineage.recent", f"n={n}")
        return self.lineage.commits[-n:]

    def diff(self, a: KernelGenome, b: KernelGenome):
        self._call("lineage.diff")
        return a.diff(b)

    # -- evaluation utility f ----------------------------------------------------
    def evaluate(self, genome: KernelGenome) -> ScoreVector:
        self._call("evaluate", genome.key())
        self.n_evaluate_calls += 1
        return self.scorer(genome)

    def evaluate_many(self, genomes: Sequence[KernelGenome]) -> list[ScoreVector]:
        """Batched evaluation: one call, many candidates.  Dispatches to the
        selected evaluation backend's ``map`` when available (thread and
        process backends run the batch on their executors; the service
        backend fans it out over its remote worker fleet; inline falls back
        to a serial loop)."""
        self._call("evaluate_many", f"n={len(genomes)}")
        self.n_evaluate_calls += len(genomes)
        if hasattr(self.scorer, "map"):
            return self.scorer.map(genomes)
        return [self.scorer(g) for g in genomes]

    def submit_evaluations(self, genomes: Sequence[KernelGenome]) -> int:
        """Speculative async surface (the pipelined engine's proposal phase):
        enqueue evaluations on the backend and return immediately.  Results
        land in the shared cache; duplicate/in-flight submissions collapse.
        Counted separately from ``evaluate`` — speculation is not an agent
        tool call and must not inflate its accounting.  No-op (returns 0) on
        backends that cannot overlap (inline)."""
        submit = getattr(self.scorer, "submit", None)
        if submit is None or not getattr(self.scorer, "overlapping", False):
            return 0
        cache = getattr(self.scorer, "cache", None)
        # peek under the backend's own (fidelity-aware) key when it has one,
        # so a rung-0 cache entry never masks a higher-rung submission
        keyer = getattr(self.scorer, "score_key", None)
        score_key = keyer if keyer is not None else \
            (lambda g: g.key())
        todo = [g for g in genomes
                if cache is None or cache.peek(score_key(g)) is None]
        submit_many = getattr(self.scorer, "submit_many", None)
        if submit_many is not None:
            # one batched dispatch: on the service backend the whole burst
            # rides to each worker in a single tasks frame
            if todo:
                submit_many(todo)
            n = len(todo)
        else:
            n = 0
            for g in todo:
                submit(g)
                n += 1
        self.n_speculative_submits += n
        return n

    def profile(self, sv: ScoreVector) -> dict:
        """Per-config time breakdown — the profiler the agent reads."""
        self._call("profile")
        return {name: p.breakdown() for name, p in sv.profiles.items() if p.feasible}

    # -- knowledge base K ----------------------------------------------------------
    def consult_kb(self, genome, sv, *tags):
        self._call("consult_kb", ",".join(tags))
        return self.kb.suggestions(genome, sv, self.scorer.suite, *tags)

    # -- persistent memory -----------------------------------------------------------
    @staticmethod
    def _memory_key(genome: KernelGenome, edit: dict):
        return (genome.key(), tuple(sorted(edit.items())))

    def remember_refuted(self, genome: KernelGenome, edit: dict, why: str):
        self.memory_refuted.add(
            self._memory_key(genome, edit),
            f"refuted {edit} on {genome.key()[:48]}…: {why}")

    def is_refuted(self, genome: KernelGenome, edit: dict) -> bool:
        return self._memory_key(genome, edit) in self.memory_refuted

    # -- accounting ---------------------------------------------------------------------
    def stats(self) -> dict:
        """``evaluations`` is the scorer's paid-evaluation total — for a
        shared BatchScorer that is the whole suite group, not just this belt;
        ``evaluate_calls`` is this belt's own request count.
        ``correctness_memo`` is the process-wide structural-memo view:
        authoritative for inline/thread backends, parent-side (workers keep
        their own memos) for process/service."""
        from repro_torch.core.evals import correctness_memo_stats
        return {
            "tool_calls": len(self.calls),
            "evaluations": self.scorer.n_evaluations,
            "evaluate_calls": self.n_evaluate_calls,
            "speculative_submits": self.n_speculative_submits,
            "kb_consults": self.kb.n_consults,
            "refuted_memories": len(self.memory_refuted),
            "eval_workers": getattr(self.scorer, "max_workers", None),
            "score_cache": (self.scorer.cache.stats()
                            if hasattr(getattr(self.scorer, "cache", None),
                                       "stats") else {}),
            "correctness_memo": correctness_memo_stats(),
        }
