"""The port's checkpointer and fault tolerance (``repro_torch.checkpoint``,
``repro_torch.distributed.fault_tolerance``): the counterparts of
tests/test_distributed.py's heartbeat, straggler, resilient-runner and
checkpoint tests, and checkpoints that cross packages in both directions
with identical arrays (the same on-disk format)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.distributed.fault_tolerance import (FaultPolicy, HeartbeatMonitor,
                                                     ResilientRunner)


def _state():
    return {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "b": torch.tensor([0.5, -1.5], requires_grad=True)},
            "opt": {"mu": torch.zeros((3, 4)), "step": torch.tensor(7, dtype=torch.int32)}}


# -- fault tolerance ----------------------------------------------------------


def test_heartbeat_dead_host_detection():
    t = [0.0]
    mon = HeartbeatMonitor(n_hosts=4, dead_after_s=10.0, clock=lambda: t[0])
    for h in range(4):
        mon.beat(h, step=1)
    t[0] = 5.0
    for h in (0, 1, 2):
        mon.beat(h, step=2)
    assert mon.dead_hosts() == []
    t[0] = 12.0
    assert mon.dead_hosts() == [3]
    assert mon.median_step_s() == 5.0


def test_straggler_detection():
    t = [0.0]
    mon = HeartbeatMonitor(n_hosts=3, dead_after_s=1e9, straggler_factor=2.0,
                           clock=lambda: t[0])
    mon.beat(2, 1)
    for step in range(1, 6):
        t[0] = float(step)
        mon.beat(0, step)
        mon.beat(1, step)
    assert 2 in mon.stragglers()
    assert 0 not in mon.stragglers()


def test_resilient_runner_restarts_from_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    crashes = {"left": 2}

    def step_fn(state, step):
        if step == 5 and crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("simulated node failure")
        return {"x": state["x"] + 1.0}

    runner = ResilientRunner(
        ck, FaultPolicy(max_restarts=3, checkpoint_every=2),
        save_state_fn=lambda s: ({"x": s["x"]}, {}),
        load_state_fn=lambda tree, extra: {"x": tree["x"]})
    final, end_step = runner.run({"x": torch.tensor(0.0)}, step_fn, start_step=0, n_steps=8)
    assert float(final["x"]) == 8.0 and end_step == 8
    assert runner.restarts == 2
    assert any(e.startswith("restored@4") for e in runner.events)


def test_resilient_runner_gives_up_after_max_restarts(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)

    def bad_step(state, step):
        raise RuntimeError("always fails")

    runner = ResilientRunner(ck, FaultPolicy(max_restarts=1, checkpoint_every=1),
                             save_state_fn=lambda s: (dict(s), {}),
                             load_state_fn=lambda tree, extra: dict(tree))
    with pytest.raises(RuntimeError, match="restarts"):
        runner.run({"x": 0}, bad_step, start_step=0, n_steps=3)


# -- checkpointing ----------------------------------------------------------


def _assert_tree_equal(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        if isinstance(ours[k], dict):
            _assert_tree_equal(ours[k], theirs[k])
        else:
            a = ours[k].detach().cpu().numpy() if isinstance(ours[k], torch.Tensor) \
                else np.asarray(ours[k])
            b = theirs[k].detach().cpu().numpy() if isinstance(theirs[k], torch.Tensor) \
                else np.asarray(theirs[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(10, _state(), extra={"loss": 1.5, "pipeline": {"step": 10}})
    step, state, extra = ck.restore()
    assert step == 10 and extra == {"loss": 1.5, "pipeline": {"step": 10}}
    _assert_tree_equal(state, _state())
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in (state["params"]["w"], state["opt"]["step"]))
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].dim() == 0


def test_checkpoint_keeps_tuples(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"opt": (torch.tensor(3), {"w": torch.ones(2)}, {"w": torch.zeros(2)})})
    _, state, _ = ck.restore(1, device="cpu")
    assert isinstance(state["opt"], tuple) and int(state["opt"][0]) == 3


def test_checkpoint_refuses_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(ValueError, match="bf16"):
        ck.save(1, {"w": torch.ones(2, dtype=torch.bfloat16)})
    assert ck.all_steps() == [] and os.listdir(tmp_path) == []


def test_checkpoint_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state())
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state())
    os.makedirs(tmp_path / "step_00000002.tmp", exist_ok=True)
    (tmp_path / "step_00000002.tmp" / "garbage.npz").write_bytes(b"xx")
    assert ck.latest_step() == 1
    step, _, _ = ck.restore()
    assert step == 1


def test_checkpoint_corrupt_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    p = ck.save(3, _state())
    with open(os.path.join(p, "arrays.npz"), "r+b") as fh:
        fh.seek(10)
        fh.write(b"\x00\xff\x00\xff")
    with pytest.raises(IOError, match="corrupt"):
        ck.restore(3)


def test_restore_without_checkpoints(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).restore()


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    Checkpointer(str(tmp_path)).save(5, _state(), extra={"pipeline": {"step": 5}})
    step, state, extra = JaxCheckpointer(str(tmp_path)).restore()
    assert step == 5 and extra == {"pipeline": {"step": 5}}
    _assert_tree_equal(_state(), state)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    jstate = {"params": {"w": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32)},
              "opt_state": {"step": jnp.asarray(2, jnp.int32),
                            "mu": {"w": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32)}},
              "residual": {"w": np.zeros((4, 3), np.float32)}}
    JaxCheckpointer(str(tmp_path)).save(9, jstate, extra={"loss": 2.5})
    step, state, extra = Checkpointer(str(tmp_path)).restore(device="cpu")
    assert step == 9 and extra == {"loss": 2.5}
    _assert_tree_equal(state, jstate)
    assert state["opt_state"]["step"].dtype == torch.int32
