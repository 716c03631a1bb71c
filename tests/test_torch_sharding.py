"""The port's sharding rules against the JAX package's: ``_spec_for`` on the
seeded cases of ``tests/test_distributed.py`` (the same generator, seed and
duck-typed meshes), its invariants, ``placements`` on hand-worked cases, and
the parameter rules over the reduced architectures."""
import dataclasses
import random

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.distributed.sharding import _spec_for as jax_spec_for
from repro.models import init_params as jax_init_params
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.distributed.sharding import _spec_for, param_shardings, placements
from repro_torch.models import init_params
from repro_torch.tree import tree_leaves, tree_map_with_path


class FakeMesh:
    """Duck-typed mesh (axis_names + shape only), as tests/test_distributed.py."""
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


MESHES = [FakeMesh(data=16, model=16), FakeMesh(pod=2, data=16, model=16),
          FakeMesh(data=4, model=2), FakeMesh(data=1, model=1)]

PARAM_NAMES = ["embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up",
               "w_down", "router", "in_proj", "out_proj", "norm", "bias"]


def _spec_cases(n=120, rng_seed=0):
    """tests/test_distributed.py's sample: the same 120 cases."""
    r = random.Random(rng_seed)
    dims = [1, 4, 16, 64, 256, 1024, 4096, 150528]
    cases = []
    for _ in range(n):
        shape = [r.choice(dims) for _ in range(r.randint(1, 4))]
        cases.append((r.choice(PARAM_NAMES), r.choice(["dec", "enc", ""]),
                      r.randrange(len(MESHES)), shape))
    return cases


@pytest.mark.parametrize("name,prefix,mesh_i,shape", _spec_cases())
def test_spec_for_equals_jax_and_keeps_invariants(name, prefix, mesh_i, shape):
    """The same spec as the JAX package's, exactly; and (1) no mesh axis used
    twice, (2) every sharded dim divisible by its axis size, (3) the leading
    stacked dim never sharded."""
    mesh = MESHES[mesh_i]
    path = (prefix + "/" if prefix else "") + name
    spec = _spec_for(path, tuple(shape), mesh, get_arch("mixtral-8x22b"))
    assert spec == tuple(jax_spec_for(path, tuple(shape), mesh, JAX_ARCHS["mixtral-8x22b"]))
    flat = [a for a in spec if a is not None]
    assert len(flat) == len(set(flat)), f"duplicate axis in {spec}"
    for i, axis in enumerate(spec):
        if axis is not None:
            assert shape[i] % mesh.shape[axis] == 0, (path, shape, spec)
    if prefix in ("dec", "enc") and spec:
        assert spec[0] is None


@pytest.mark.parametrize("spec,axes,want", [
    ((("pod", "data"), None, "model"), ("pod", "data", "model"),
     (Shard(0), Shard(0), Shard(2))),
    ((None, "data"), ("data", "model"), (Shard(1), Replicate())),
    (("model", "data"), ("data", "model"), (Shard(1), Shard(0))),
    ((None, None, "model"), ("data", "model"), (Replicate(), Shard(2))),
    ((("data",), None), ("pod", "data", "model"), (Replicate(), Shard(0), Replicate())),
    ((), ("pod", "data", "model"), (Replicate(),) * 3),
])
def test_placements_hand_worked(spec, axes, want):
    assert placements(spec, FakeMesh(**{a: 2 for a in axes})) == want


@pytest.mark.parametrize("spec", [(("data", "pod"),), ("data", "data")])
def test_placements_refuse_a_bad_spec(spec):
    """A tuple out of the mesh's order (it would shard minor to major) and
    an axis that shards two dims are refused."""
    with pytest.raises(ValueError):
        placements(spec, FakeMesh(pod=2, data=2, model=2))


def _jax_path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shardings_cover_the_tree_as_jax_assigns(arch):
    """Every leaf of the reduced architecture's parameters gets the JAX
    package's spec for its path and shape, on a (pod, data, model) mesh."""
    mesh = FakeMesh(pod=2, data=4, model=2)
    cfg = ARCHS[arch].reduced()
    specs = param_shardings(init_params(cfg, torch.Generator().manual_seed(0)), mesh, cfg)
    jp = jax_init_params(JAX_ARCHS[arch].reduced(), jax.random.PRNGKey(0))
    want = {_jax_path(kp): tuple(jax_spec_for(_jax_path(kp), leaf.shape, mesh,
                                              JAX_ARCHS[arch].reduced()))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {}
    tree_map_with_path(lambda p, s: got.__setitem__("/".join(p), s), specs)
    assert got == want
    assert any(any(a is not None for a in s) for s in got.values())


def test_distribute_params_on_one_rank_wraps_without_a_copy(tmp_path):
    """A one-rank gloo mesh: every leaf becomes a DTensor over the same
    storage, placed by its spec."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    init_process_group(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        mesh = make_host_mesh(device="cpu")
        cfg = dataclasses.replace(ARCHS["qwen2-7b"].reduced())
        params = init_params(cfg, torch.Generator().manual_seed(0))
        placed = distribute_params(params, mesh, cfg)
        for a, b in zip(tree_leaves(params), tree_leaves(placed)):
            assert isinstance(b, DTensor) and b.to_local().data_ptr() == a.data_ptr()
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
    finally:
        dist.destroy_process_group()
