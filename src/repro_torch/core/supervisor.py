"""Self-supervision (paper §3.3): detect stalls and unproductive cycles in
the long-running evolution and intervene by steering the search.

Stall      = no committed improvement in `patience` consecutive variation
             steps (the agent 'exhausted its current line of exploration').
Cycle      = the same bottleneck attacked repeatedly with no commit.

On trigger, the supervisor reviews the trajectory and emits a Directive that
redirects exploration: first widening the candidate pool ('explore'), then
rotating focus to the least-recently-attacked bottleneck ('refocus').
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.agent import Directive
from repro_torch.core.population import Lineage

_ALL_TAGS = ("mxu", "vpu", "dma", "overhead", "bubble")


@dataclass
class Supervisor:
    patience: int = 3
    focus_offset: int = 0    # islands start the refocus rotation at different
    interventions: int = 0   # tags so stalled islands diverge, not pile up
    log: list = field(default_factory=list)
    _steps_since_commit: int = 0
    _focus_rotation: int = 0

    def observe(self, committed: bool) -> None:
        self._steps_since_commit = 0 if committed else self._steps_since_commit + 1

    # -- persistence: the counters ARE the intervention timing --------------------
    def state(self) -> dict:
        return {"interventions": self.interventions,
                "steps_since_commit": self._steps_since_commit,
                "focus_rotation": self._focus_rotation}

    def load_state(self, state: dict) -> None:
        self.interventions = int(state.get("interventions", 0))
        self._steps_since_commit = int(state.get("steps_since_commit", 0))
        self._focus_rotation = int(state.get("focus_rotation", 0))

    def _decide(self) -> tuple:
        """(kind, tag) the current counters imply — the ONE place the
        patience thresholds and the focus rotation live, shared by the
        non-mutating :meth:`peek` and the authoritative :meth:`check` so the
        two can never drift apart."""
        if self._steps_since_commit < self.patience:
            return "none", None
        if self._steps_since_commit < 2 * self.patience:
            return "explore", None
        return "refocus", _ALL_TAGS[(self.focus_offset + self._focus_rotation)
                                    % len(_ALL_TAGS)]

    def peek(self, lineage: Lineage) -> Directive:
        """Non-mutating preview of what :meth:`check` would return right now.

        The pipelined engine's proposal phase speculates with this — it must
        not consume an intervention or advance the focus rotation, because the
        authoritative :meth:`check` still runs at harvest time (and between
        peek and check a migrant may land, changing the answer)."""
        kind, tag = self._decide()
        if kind == "none":
            return Directive()
        if kind == "explore":
            return Directive(kind="explore",
                             exploration_depth=self._steps_since_commit)
        return Directive(kind="refocus", focus_tags=(tag,))

    def check(self, lineage: Lineage) -> Directive:
        kind, tag = self._decide()
        if kind == "none":
            return Directive()
        self.interventions += 1
        # review the trajectory: what has already been tried?
        recent_notes = " ".join(c.note for c in lineage.commits[-8:])
        if kind == "explore":
            d = Directive(kind="explore",
                          note=(f"intervention #{self.interventions}: plateau for "
                                f"{self._steps_since_commit} steps — widen the "
                                f"candidate pool across all subsystems"),
                          exploration_depth=self._steps_since_commit)
        else:
            self._focus_rotation += 1
            d = Directive(kind="refocus", focus_tags=(tag,),
                          note=(f"intervention #{self.interventions}: rotate focus "
                                f"to '{tag}' (recent commits: {recent_notes[:120]})"))
        self.log.append(d.note)
        return d
