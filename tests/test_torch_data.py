"""The port's copy of the data pipeline (``repro_torch.data``) against the
JAX package's: numpy only on both sides, so every batch must be bit-equal,
over seeds, steps, shard layouts and the vision prefix field; and the
counterparts of tests/test_data_optim.py's pipeline tests."""
import numpy as np
import pytest

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro_torch.configs.registry import ARCHS
from repro_torch.data import PipelineState, TokenPipeline

CFG = ARCHS["qwen2-7b"].reduced()


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["qwen2-7b", "phi-3-vision-4.2b", "gemma2-27b"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_batches_bit_equal_to_jax(name, seed, num_shards):
    cfg, jcfg = ARCHS[name].reduced(), JAX_ARCHS[name].reduced()
    for shard in range(num_shards):
        ours = TokenPipeline(cfg, 16, 8, seed=seed, shard_index=shard, num_shards=num_shards)
        theirs = JaxPipeline(jcfg, 16, 8, seed=seed, shard_index=shard, num_shards=num_shards)
        for step in range(3):
            _equal(ours.next_batch(), theirs.next_batch())
        _equal(ours.batch_at(11), theirs.batch_at(11))
        if cfg.n_prefix_embeds:
            b = ours.batch_at(0)
            assert b["prefix_embeds"].shape == (8 // num_shards, cfg.n_prefix_embeds,
                                                cfg.d_model)
            assert (b["labels"][:, :cfg.n_prefix_embeds] == -1).all()


def test_full_width_vocab_batch_bit_equal_to_jax():
    """qwen2-7b's published vocab (152064), the full-width training phase's
    stream on the card."""
    ours = TokenPipeline(ARCHS["qwen2-7b"], 64, 2, seed=0).batch_at(1)
    theirs = JaxPipeline(JAX_ARCHS["qwen2-7b"], 64, 2, seed=0).batch_at(1)
    _equal(ours, theirs)
    assert ours["tokens"].max() < 152064


def test_batches_are_pure_functions_of_step():
    p1, p2 = TokenPipeline(CFG, 16, 8, seed=3), TokenPipeline(CFG, 16, 8, seed=3)
    for _ in range(3):
        _equal(p1.next_batch(), p2.next_batch())
    assert not np.array_equal(TokenPipeline(CFG, 16, 8, seed=0).next_batch()["tokens"],
                              TokenPipeline(CFG, 16, 8, seed=1).next_batch()["tokens"])


def test_labels_are_the_next_tokens():
    b = TokenPipeline(CFG, 16, 4, seed=0).next_batch()
    assert b["tokens"].shape == b["labels"].shape == (4, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_state_round_trip():
    p = TokenPipeline(CFG, 16, 4, seed=0)
    for _ in range(3):
        p.next_batch()
    q = TokenPipeline(CFG, 16, 4, seed=0)
    q.load_state_dict(p.state_dict())
    assert p.state_dict() == {"step": 3}
    assert PipelineState.from_json(p.state.to_json()) == p.state
    _equal(p.next_batch(), q.next_batch())


def test_reshard_preserves_step_and_matches_jax():
    p = TokenPipeline(CFG, 16, 8, seed=0)
    p.next_batch()
    q = p.reshard(1, 2)
    assert q.state.step == p.state.step == 1 and q.local_batch == 4
    jq = JaxPipeline(JAX_ARCHS["qwen2-7b"].reduced(), 16, 8, seed=0).reshard(1, 2)
    jq.state.step = 1
    _equal(q.next_batch(), jq.next_batch())
