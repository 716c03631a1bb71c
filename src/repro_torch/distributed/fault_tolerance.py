"""Fault tolerance for long multi-pod runs: heartbeat/straggler detection,
failure-tolerant step execution with checkpoint-restart, elastic re-meshing.

On a real deployment the heartbeat source is the coordination service
(jax.distributed / GCS); here it is injectable, which is also how the tests
simulate dead hosts and stragglers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.checkpoint import Checkpointer


@dataclass
class HostStatus:
    host_id: int
    last_heartbeat: float
    last_step: int = -1


class HeartbeatMonitor:
    """Tracks per-host liveness + step progress; classifies stragglers."""

    def __init__(self, n_hosts: int, dead_after_s: float = 60.0,
                 straggler_factor: float = 2.0, clock: Callable = time.monotonic):
        self.clock = clock
        self.dead_after_s = dead_after_s
        self.straggler_factor = straggler_factor
        now = clock()
        self.hosts = {h: HostStatus(h, now) for h in range(n_hosts)}
        self._step_durations: list[float] = []

    def beat(self, host_id: int, step: int) -> None:
        st = self.hosts[host_id]
        now = self.clock()
        if st.last_step >= 0 and step > st.last_step:
            self._step_durations.append(now - st.last_heartbeat)
            self._step_durations = self._step_durations[-256:]
        st.last_heartbeat = now
        st.last_step = step

    def median_step_s(self) -> float:
        if not self._step_durations:
            return 0.0
        s = sorted(self._step_durations)
        return s[len(s) // 2]

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_heartbeat > self.dead_after_s]

    def stragglers(self) -> list[int]:
        med = self.median_step_s()
        if med <= 0:
            return []
        cur = max(st.last_step for st in self.hosts.values())
        out = []
        now = self.clock()
        for h, st in self.hosts.items():
            behind = st.last_step < cur
            slow = (now - st.last_heartbeat) > self.straggler_factor * med
            if behind and slow and h not in self.dead_hosts():
                out.append(h)
        return out


@dataclass
class FaultPolicy:
    max_restarts: int = 5
    checkpoint_every: int = 50
    # straggler mitigation: "wait" (synchronous), "drop" (re-mesh without the
    # slow host — elastic), "redundant" (backup execution; needs spare hosts)
    straggler_action: str = "drop"


class ResilientRunner:
    """Wraps a step function with checkpoint-restart semantics.

    ``step_fn(state, step_idx) -> state`` may raise (simulated preemption /
    hardware fault); the runner restores from the last checkpoint and
    continues, up to ``policy.max_restarts`` times.

    Under a mesh every rank runs the runner with the same policy.  Saving
    is then a collective (``Checkpointer.save``), and a fault raised on
    every rank at the same step (a preempted job) restores every rank from
    one checkpoint: the restore hands ``load_state_fn`` whole tensors, and
    the caller's ``load_state_fn`` places them
    (``checkpoint.place(tree, shardings)``, with
    ``sharding.train_state_shardings``).  A fault on some ranks only leaves
    the others in a collective; the runner does not recover from that.
    """

    def __init__(self, checkpointer: Checkpointer, policy: FaultPolicy,
                 save_state_fn: Callable, load_state_fn: Callable):
        self.ckpt = checkpointer
        self.policy = policy
        self.save_state_fn = save_state_fn   # state -> (pytree, extra)
        self.load_state_fn = load_state_fn   # (pytree, extra) -> state
        self.restarts = 0
        self.events: list[str] = []

    def run(self, state, step_fn: Callable, start_step: int, n_steps: int):
        step = start_step
        while step < start_step + n_steps:
            try:
                state = step_fn(state, step)
                step += 1
                if step % self.policy.checkpoint_every == 0:
                    tree, extra = self.save_state_fn(state)
                    self.ckpt.save(step, tree, dict(extra, step=step))
                    self.events.append(f"checkpoint@{step}")
            except Exception as e:  # noqa: BLE001 — any fault triggers restart
                self.restarts += 1
                self.events.append(f"fault@{step}: {type(e).__name__}: {e}")
                if self.restarts > self.policy.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.policy.max_restarts} restarts") from e
                last = self.ckpt.latest_step()
                if last is None:
                    step = start_step
                    continue
                s, tree, extra = self.ckpt.restore(last)
                state = self.load_state_fn(tree, extra)
                step = s
                self.events.append(f"restored@{step}")
        return state, step
