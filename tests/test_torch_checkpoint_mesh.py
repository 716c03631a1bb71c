"""A sharded training state saved and restored on gloo ranks of the CPU
(``repro_torch.checkpoint`` under a mesh): a restart on the same mesh
against an uninterrupted run, restores onto other meshes, the pod=2 int8
residual saved and restored as the sum over the pods, and checkpoints that
cross packages.

The harness is ``test_torch_mesh.py``'s: ranks are spawned and meet through
a ``file://`` store under a temporary directory; JAX runs in the parent
only, which hands the ranks the JAX package's weights (``init_params``,
seed 0) as numpy arrays.  Two spawns serve every test of the file (a
module fixture): 4 ranks, then 2 ranks, which restore the 4-rank run's
checkpoint.

The runs: reduced qwen2-7b and mixtral-8x22b (experts sharded over
"model"), global batch 8 of 16 tokens in 2 microbatches (which divide over
4 and over 2 data ranks), ``test_torch_mesh.OPT`` (eps 1.0; see its
``_train``).  Tolerances: a restart on the same mesh equals the
uninterrupted run exactly; a restore onto another mesh changes the order
of sums, so the two steps after it hold ``test_torch_mesh``'s REL (losses,
grad norms) and GRAD_REL (each parameter leaf, of its largest magnitude).
Restored shards equal their slices of the saved arrays exactly.  A pod=2
int8_ef restore splits the residual otherwise over the pods, so the steps
after it hold INT8_REL, two int8 steps of the gradient's scale.
"""
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_mesh import GRAD_REL, OPT, REL, _cfg, _jax_weights, _place, _rel, _weights

ARCHS = ("qwen2-7b", "mixtral-8x22b")
B, S, NM = 8, 16, 2
STEPS, EVERY, FAULT_AT = 6, 2, 3      # the runner: checkpoints at 2, 4, 6; a fault at 3
REMESH_AT, REMESH_STEPS = 2, 2        # the checkpoint restored onto other meshes
POD2_STEPS = 2                        # the steps after the pod=2 restore
INT8_REL = 2 / 127                    # two runs' int8 reductions over 2 pods (see its test)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _whole_tree(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t: (t.detach().full_tensor() if isinstance(t, DTensor)
                               else t.detach()).clone(), tree)


def _shardings(cfg, template, residual=False):
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed.sharding import train_state_shardings
    return train_state_shardings(template, ctx.get_mesh(), cfg, residual=residual)


class _Run:
    """A train state on the active mesh from the JAX package's weights, its
    step function and pipeline, and the loss and grad norm of every step
    taken (a step taken again after a restore overwrites its entry)."""

    def __init__(self, arch, npw, compression="none"):
        from repro_torch.data import TokenPipeline
        from repro_torch.distributed.collectives import compress_init
        from repro_torch.launch.train import make_train_step
        from repro_torch.optim import AdamWConfig, adamw_init
        from repro_torch.tree import tree_leaves
        self.cfg = _cfg(arch)
        self.template = _weights(self.cfg, npw)
        params = _place(_weights(self.cfg, npw), self.cfg)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        residual = compress_init(params) if compression == "int8_ef" else None
        self.state = (params, adamw_init(params), residual)
        self.compression = compression
        self.step = make_train_step(self.cfg, AdamWConfig(**OPT), n_microbatches=NM,
                                    compression=compression, compute_dtype=torch.float32)
        self.pipe = TokenPipeline(self.cfg, S, B, seed=1)
        self.log = {}

    def step_fn(self, state, i):
        from repro_torch.launch.train import batch_to_device
        params, opt, residual, m = self.step(*state, batch_to_device(self.pipe.next_batch(),
                                                                     "cpu"))
        self.log[i] = (float(m["loss"]), float(m["grad_norm"]))
        return params, opt, residual

    def tree(self, state):
        tree = {"params": state[0], "opt_state": state[1]._asdict()}
        if state[2] is not None:
            tree["residual"] = state[2]
        return tree

    def save_state(self, state):
        return self.tree(state), {"pipeline": self.pipe.state_dict()}

    def shardings(self):
        return _shardings(self.cfg, self.template, self.compression == "int8_ef")

    def load_state(self, tree, extra):
        """The runner's restore: whole tensors, placed here."""
        from repro_torch.checkpoint import place
        return self.adopt(place(tree, self.shardings()), extra)

    def adopt(self, tree, extra):
        from repro_torch.optim import AdamWState
        self.pipe.load_state_dict(extra["pipeline"])
        return tree["params"], AdamWState(**tree["opt_state"]), tree.get("residual")

    def steps(self, start, n):
        for i in range(start, start + n):
            self.state = self.step_fn(self.state, i)

    def result(self):
        return {"log": dict(self.log), "params": _whole_tree(self.state[0])}


def _expected_local(whole, placements, mesh):
    """This rank's part of ``whole`` under ``placements``, cut by hand:
    torch.chunk along each sharded dim in mesh order; zeros off index 0 of
    a Partial axis."""
    from torch.distributed.tensor import Partial, Shard
    t = whole
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(i), p.dim)[mesh.get_local_rank(i)]
    if any(isinstance(p, Partial) and mesh.get_local_rank(i) for i, p in enumerate(placements)):
        t = torch.zeros_like(t)
    return t


def _shard_faults(placed, whole, shardings, mesh) -> list:
    """The keys, over every rank, whose restored leaf is not the DTensor
    ``shardings`` asks for with this rank's part of ``whole`` (or, where the
    entry is None, not ``whole`` itself)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.checkpointer import _leaves, _placement_leaves
    got, want, spec = _leaves(placed), _leaves(whole), _placement_leaves(shardings)
    bad = []
    for key, t in got.items():
        if spec[key] is None:
            ok = not isinstance(t, DTensor) and torch.equal(t, want[key])
        else:
            ok = (isinstance(t, DTensor) and tuple(t.placements) == spec[key]
                  and t.device_mesh is mesh and t.shape == want[key].shape
                  and torch.equal(t.to_local(), _expected_local(want[key], spec[key], mesh)))
        if not ok:
            bad.append(key)
    return _on_every_rank(bad)


def _remesh(arch, npw, directory):
    """The REMESH_AT checkpoint restored onto the active mesh (its shards
    against the saved arrays), then REMESH_STEPS steps."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import context as ctx
    run = _Run(arch, npw)
    ck = Checkpointer(directory)
    step, whole, _ = ck.restore(REMESH_AT)
    step, tree, extra = ck.restore(REMESH_AT, shardings=run.shardings())
    out = {"shard_faults": _shard_faults(tree, whole, run.shardings(), ctx.get_mesh())}
    run.state = run.adopt(tree, extra)
    run.steps(step, REMESH_STEPS)
    return {**out, **run.result()}


def _world_four(rank, directory, jax_dir, weights):
    """(data=2, model=2): per architecture, the uninterrupted run, the
    runner with one fault on every rank, the step-2 checkpoint onto
    (data=4, model=1), and the JAX package's checkpoint onto the mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import context as ctx
    from repro_torch.distributed.fault_tolerance import FaultPolicy, ResilientRunner
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=2, device="cpu")
    wide = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    out = {}
    for arch in ARCHS:
        ctx.set_mesh(mesh)
        clean = _Run(arch, weights[arch])
        clean.steps(0, REMESH_AT + REMESH_STEPS)
        out[("clean_remesh", arch)] = clean.result()
        clean.steps(REMESH_AT + REMESH_STEPS, STEPS - REMESH_AT - REMESH_STEPS)
        out[("clean", arch)] = clean.result()

        run = _Run(arch, weights[arch])
        raised = []

        def step_fn(state, i, run=run, raised=raised):
            if i == FAULT_AT and not raised:
                raised.append(i)
                raise RuntimeError(f"simulated preemption at step {i}")
            return run.step_fn(state, i)

        d = os.path.join(directory, arch)
        runner = ResilientRunner(Checkpointer(d, keep=3),
                                 FaultPolicy(max_restarts=1, checkpoint_every=EVERY),
                                 run.save_state, run.load_state)
        final, end = runner.run(run.state, step_fn, start_step=0, n_steps=STEPS)
        run.state = final
        out[("restart", arch)] = {**run.result(), "end": end, "restarts": runner.restarts,
                                  "events": runner.events, "steps": runner.ckpt.all_steps(),
                                  "saved": _whole_tree(run.tree(final))}

        ctx.set_mesh(wide)
        out[("remesh_4x1", arch)] = _remesh(arch, weights[arch], d)

        ctx.set_mesh(mesh)
        cfg = _cfg(arch)
        ck = Checkpointer(os.path.join(jax_dir, arch))
        _, whole, _ = ck.restore()
        _, tree, _ = ck.restore(shardings=_shardings(cfg, _weights(cfg, weights[arch])))
        want = {"params": distribute_params(whole["params"], mesh, cfg),
                "opt_state": {"step": whole["opt_state"]["step"],
                              **{m: distribute_params(whole["opt_state"][m], mesh, cfg)
                                 for m in ("mu", "nu")}}}
        out[("from_jax", arch)] = _distribute_faults(tree, want)
    ctx.set_mesh(None)
    return out


def _distribute_faults(got, want) -> list:
    """The keys, over every rank, where ``got`` and ``want`` differ in
    placements or local shard."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.checkpointer import _leaves

    def same(a, b):
        if isinstance(a, DTensor) and isinstance(b, DTensor):
            return a.placements == b.placements and torch.equal(a.to_local(), b.to_local())
        return not isinstance(a, DTensor) and not isinstance(b, DTensor) and torch.equal(a, b)

    g, w = _leaves(got), _leaves(want)
    return _on_every_rank([k for k in sorted(set(g) | set(w))
                           if k not in g or k not in w or not same(g[k], w[k])])


def _on_every_rank(bad: list) -> list:
    """The union of every rank's ``bad`` keys."""
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, bad)
    return sorted({k for b in every for k in b})


def _pods(r) -> list:
    """Both pods' local shards of ``r``."""
    import torch.distributed as dist
    parts = [torch.empty_like(r.to_local()) for _ in range(2)]
    dist.all_gather(parts, r.to_local().contiguous())
    return parts


def _world_two(rank, directory, weights):
    """(data=1, model=2): the 4-rank run's step-2 checkpoint restored and
    continued.  (pod=2, data=1, model=1): two int8_ef steps of qwen2-7b,
    the residual's full_tensor() against the sum of the pods' residuals,
    saved and restored; then POD2_STEPS steps of the restored state and of
    the run that was saved."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _leaves
    from repro_torch.distributed import context as ctx
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    ctx.set_mesh(make_host_mesh(model=2, device="cpu"))
    for arch in ARCHS:
        out[("remesh_1x2", arch)] = _remesh(arch, weights[arch], os.path.join(directory, arch))

    mesh = make_host_mesh(model=1, device="cpu", pod=2)
    ctx.set_mesh(mesh)
    run = _Run("qwen2-7b", weights["qwen2-7b"], compression="int8_ef")
    run.steps(0, 2)
    res = _leaves(run.state[2])
    pods = {k: _pods(r) for k, r in res.items()}
    full = {k: r.full_tensor() for k, r in res.items()}
    d = os.path.join(directory, "pod2")
    ck = Checkpointer(d)
    ck.save(2, run.tree(run.state), {"pipeline": run.pipe.state_dict()})
    with np.load(os.path.join(d, "step_0000000002", "arrays.npz")) as npz:
        saved = {k: torch.from_numpy(npz["residual\x1f" + k.replace("/", "\x1f")])
                 for k in res}
    _, tree, extra = ck.restore(2, shardings=run.shardings())
    restored = {k: {"placements": tuple(r.placements), "parts": _pods(r)}
                for k, r in _leaves(tree["residual"]).items()}
    out["pod2"] = {"pods": pods, "full": full, "saved": saved, "restored": restored,
                   "placements": {k: tuple(r.placements) for k, r in res.items()},
                   "param_placements": {k: tuple(p.placements)
                                        for k, p in _leaves(run.state[0]).items()}}
    at_restore = _whole_tree(run.state[0])
    again = _Run("qwen2-7b", weights["qwen2-7b"], compression="int8_ef")
    again.state = again.adopt(tree, extra)
    for r in (run, again):
        r.steps(2, POD2_STEPS)
    out["pod2_restart"] = {"uninterrupted": run.result(), "restored": again.result(),
                           "at_restore": at_restore}
    ctx.set_mesh(None)
    return out


WORLDS = {"four": _world_four, "two": _world_two}


def _rank_main(rank, world, store, out_dir, job, kw):
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group
    torch.set_num_threads(1)
    init_process_group(store, rank, world, device="cpu")
    try:
        result = WORLDS[job](rank, **kw)
        if rank == 0:
            torch.save(result, os.path.join(out_dir, f"{job}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(tmp, world, job, **kw):
    """Start the ranks; ``finish()`` waits for them (raising a rank's
    error) and returns rank 0's result."""
    procs = mp.start_processes(_rank_main, args=(world, os.path.join(tmp, f"store-{job}"),
                                                 tmp, job, kw),
                               nprocs=world, start_method="spawn", join=False)

    def finish():
        while not procs.join():
            pass
        return torch.load(os.path.join(tmp, f"{job}.pt"), weights_only=False)
    return finish


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _jax_checkpoint(directory, arch):
    """The JAX package's checkpoint of its weights and zero AdamW moments."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    from repro.optim import adamw_init
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_weights(arch))
    JaxCheckpointer(os.path.join(directory, arch)).save(
        0, {"params": jp, "opt_state": adamw_init(jp)._asdict()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ckpt_mesh"))
    ckpt, jax_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "jax")
    weights = {a: _jax_weights(a) for a in ARCHS}
    for arch in ARCHS:
        _jax_checkpoint(jax_dir, arch)
    four = _spawn(tmp, 4, "four", directory=ckpt, jax_dir=jax_dir, weights=weights)()
    two = _spawn(tmp, 2, "two", directory=ckpt, weights=weights)()
    return {"four": four, "two": two, "ckpt": ckpt}


@pytest.mark.parametrize("arch", ARCHS)
def test_same_mesh_restart_equals_uninterrupted(runs, arch):
    """(data=2, model=2): a ResilientRunner checkpointing every 2 steps,
    every rank preempted once at step 3, ends equal to the uninterrupted
    run: losses, grad norms and parameters exactly."""
    from repro_torch.tree import tree_leaves
    got, want = runs["four"][("restart", arch)], runs["four"][("clean", arch)]
    assert got["end"] == STEPS and got["restarts"] == 1
    assert f"fault@{FAULT_AT}: RuntimeError: simulated preemption at step {FAULT_AT}" \
        in got["events"] and "restored@2" in got["events"]
    assert got["steps"] == [2, 4, 6]
    assert got["log"] == want["log"] and sorted(got["log"]) == list(range(STEPS))
    leaves = tree_leaves(got["params"])
    assert len(leaves) == len(tree_leaves(want["params"])) > 0
    for a, b in zip(leaves, tree_leaves(want["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mesh", ("remesh_4x1", "remesh_1x2"))
@pytest.mark.parametrize("arch", ARCHS)
def test_restore_onto_another_mesh(runs, arch, mesh):
    """The step-2 checkpoint of the (data=2, model=2) run restored onto
    (data=4, model=1) on the same 4 ranks, and onto 2 ranks as (data=1,
    model=2): every shard its slice of the saved array exactly, and two
    further steps within REL (losses, grad norms) and GRAD_REL (each
    parameter leaf) of the uninterrupted run."""
    from repro_torch.tree import tree_leaves
    got = runs["four" if mesh == "remesh_4x1" else "two"][(mesh, arch)]
    want = runs["four"][("clean_remesh", arch)]
    assert got["shard_faults"] == []
    assert sorted(got["log"]) == list(range(REMESH_AT, REMESH_AT + REMESH_STEPS))
    for i, (loss, norm) in got["log"].items():
        w_loss, w_norm = want["log"][i]
        assert abs(loss - w_loss) <= REL * abs(w_loss), (i, loss, w_loss)
        assert abs(norm - w_norm) <= REL * abs(w_norm), (i, norm, w_norm)
    leaves = tree_leaves(got["params"])
    assert len(leaves) == len(tree_leaves(want["params"])) > 0
    for a, b in zip(leaves, tree_leaves(want["params"])):
        assert a.shape == b.shape and _rel(a, b) <= GRAD_REL, _rel(a, b)


def test_pod2_residual_is_the_sum_over_pods(runs):
    """pod=2, int8_ef: the pods' residuals differ; full_tensor() of each is
    their sum, the checkpoint holds that sum, and after a restore pod 0
    holds it and pod 1 zeros, which sum to it exactly."""
    from torch.distributed.tensor import Partial, Replicate
    res = runs["two"]["pod2"]
    assert res["pods"] and any(not torch.equal(*p) for p in res["pods"].values())
    for key, (p0, p1) in res["pods"].items():
        total = p0 + p1
        want = (Partial(),) + res["param_placements"][key][1:]
        assert res["param_placements"][key][0] == Replicate(), key
        assert res["placements"][key] == want, key
        assert torch.equal(res["full"][key], total), key
        assert torch.equal(res["saved"][key], total), key
        got = res["restored"][key]
        assert got["placements"] == want, key
        assert torch.equal(got["parts"][0], total) and not got["parts"][1].any(), key
        assert torch.equal(got["parts"][0] + got["parts"][1], total), key


def test_pod2_restore_continues_within_the_int8_bound(runs):
    """pod=2, int8_ef: the step-2 checkpoint restored (pod 0 holding the
    residuals' sum, pod 1 zeros) and run POD2_STEPS steps, against the same
    run uninterrupted.  The first step starts from equal parameters, so its
    loss is equal exactly.  The residuals are split otherwise over the pods,
    so each reduction quantises other values: each run's reduced gradient
    is off the exact sum by up to half an int8 step (1/127 of max|g + r|)
    on each of the 2 pods, and the two runs differ by up to INT8_REL = 2/127
    of it.  Losses and grad norms are held to INT8_REL relative, and each
    parameter leaf's difference to INT8_REL of that leaf's largest change
    over the steps in the uninterrupted run (OPT's eps of 1.0 keeps the
    update linear in the gradient)."""
    from repro_torch.checkpoint.checkpointer import _leaves
    res = runs["two"]["pod2_restart"]
    got, want = res["restored"], res["uninterrupted"]
    first = 2
    assert sorted(got["log"]) == list(range(first, first + POD2_STEPS))
    assert got["log"][first][0] == want["log"][first][0]
    for i, (loss, norm) in got["log"].items():
        w_loss, w_norm = want["log"][i]
        assert abs(loss - w_loss) <= INT8_REL * abs(w_loss), (i, loss, w_loss)
        assert abs(norm - w_norm) <= INT8_REL * abs(w_norm), (i, norm, w_norm)
    g, w, at = _leaves(got["params"]), _leaves(want["params"]), _leaves(res["at_restore"])
    assert sorted(g) == sorted(w) and len(w) > 3
    for key in w:
        moved = (w[key] - at[key]).double().abs().max()
        diff = (g[key] - w[key]).double().abs().max()
        assert moved > 0 and diff <= INT8_REL * moved, (key, float(diff), float(moved))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_checkpoint_restores_in_the_jax_package(runs, arch):
    """The runner's last checkpoint, written from DTensors on 4 ranks, read
    by ``repro.checkpoint.Checkpointer``: every array equals the ranks'
    full_tensor()."""
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    from repro_torch.checkpoint.checkpointer import _leaves
    got = runs["four"][("restart", arch)]
    step, state, _ = JaxCheckpointer(os.path.join(runs["ckpt"], arch)).restore()
    assert step == STEPS
    theirs, ours = _leaves(state), _leaves(got["saved"])
    assert sorted(theirs) == sorted(ours) and len(ours) > 3
    for key, t in ours.items():
        a = np.asarray(theirs[key])
        assert a.dtype == t.numpy().dtype and a.shape == tuple(t.shape), key
        np.testing.assert_array_equal(a, t.numpy(), err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_onto_the_mesh(runs, arch):
    """A checkpoint of the JAX package (its weights, zero moments) restored
    onto (data=2, model=2): every shard equal to distribute_params of the
    same arrays, the AdamW step a plain tensor."""
    assert runs["four"][("from_jax", arch)] == []


def test_restore_errors_and_the_one_rank_mesh(tmp_path):
    """``shardings`` without a mesh raises, and a tree that does not match
    the checkpoint raises naming the key; on a one-rank mesh a Partial
    entry is the saved array and the step stays a plain tensor."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import context as ctx
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
             "opt_state": {"step": torch.tensor(3, dtype=torch.int32)}}
    spec = {"params": {"w": (Shard(0), Partial())}, "opt_state": {"step": None}}
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, state)
    with pytest.raises(RuntimeError, match="mesh"):
        ck.restore(1, shardings=spec)
    init_process_group(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        ctx.set_mesh(make_host_mesh(device="cpu"))
        assert ck.save(2, state) == str(tmp_path / "ck" / "step_0000000002")
        with pytest.raises(ValueError, match="'opt_state/step' is only in the checkpoint"):
            ck.restore(2, shardings={"params": spec["params"]})
        with pytest.raises(ValueError, match="'params/b' is only in shardings"):
            ck.restore(2, shardings={**spec, "params": {**spec["params"], "b": None}})
        with pytest.raises(ValueError, match="1 placements for a mesh of 2"):
            ck.restore(2, shardings={**spec, "params": {"w": (Replicate(),)}})
        step, got, _ = ck.restore(2, shardings=spec)
        w = got["params"]["w"]
        assert step == 2 and isinstance(w, DTensor)
        assert tuple(w.placements) == (Shard(0), Partial())
        assert torch.equal(w.full_tensor(), state["params"]["w"])
        assert not isinstance(got["opt_state"]["step"], DTensor)
        assert int(got["opt_state"]["step"]) == 3
    finally:
        ctx.set_mesh(None)
        dist.destroy_process_group()
