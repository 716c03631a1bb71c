"""The Hopper knowledge base (``core/knowledge_h100.py``): one counterpart per
TPU fact, texts about the card, and predicted gains that are the H100
model's own geomean ratios."""
import math
import re

import pytest

from repro_torch.core import perfmodel_h100
from repro_torch.core.evals import Scorer
from repro_torch.core.knowledge import FACTS, KnowledgeBase
from repro_torch.core.knowledge_h100 import HOPPER_FACTS, knowledge_for
from repro_torch.core.perfmodel import decode_suite, gqa_suite, mha_suite
from repro_torch.core.search_space import KernelGenome, full_space, seed_genome

SUITES = {"mha": mha_suite, "gqa": gqa_suite, "decode": decode_suite}
TAGS = {"mxu", "vpu", "dma", "overhead", "bubble", "vmem"}
TPU_WORDS = re.compile(r"\b(tpu|vmem|mxu|mosaic)\b", re.IGNORECASE)
PIPELINED = KernelGenome(128, 128, "branchless", "block_skip", "deferred", True)


def _genomes():
    return [seed_genome(), PIPELINED,
            PIPELINED.with_(block_q=512, block_k=1024, rescale_mode="branched"),
            PIPELINED.with_(gqa_pack=True, kv_in_grid=False),
            PIPELINED.with_(acc_dtype="bf16", div_mode="eager", block_q=64)] + \
        list(full_space())[3::211]


def _suggestions(g, suite):
    sv = Scorer(suite=suite, check_correctness=False, machine="h100",
                device="cpu")(g)
    return [(f.id, s) for f in HOPPER_FACTS for s in f.suggest(g, sv, suite)]


def test_one_counterpart_per_tpu_fact():
    assert [f.id for f in HOPPER_FACTS] == [f.id for f in FACTS]
    for fact in HOPPER_FACTS:
        assert fact.tags and fact.tags <= TAGS, fact.id
    assert {f.id for f in HOPPER_FACTS if "vmem" in f.tags} >= {"vmem-budget"}


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_texts_speak_of_the_card(suite):
    """No fact text or suggestion rationale names a TPU, VMEM, the MXU or
    Mosaic."""
    for fact in HOPPER_FACTS:
        assert not TPU_WORDS.search(fact.text), (fact.id, fact.text)
    for g in _genomes():
        for fid, s in _suggestions(g, SUITES[suite]()):
            assert not TPU_WORDS.search(s.rationale), (fid, s.rationale)


def _model_ratio(g, edit, suite):
    def geo(x):
        vals = [perfmodel_h100.estimate(x, c).tflops for c in suite]
        return math.exp(sum(math.log(v) for v in vals) / len(vals))
    return geo(g.with_(**edit)) / geo(g) - 1.0


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_predicted_gain_is_the_model_ratio(suite):
    cfgs = SUITES[suite]()
    seen = 0
    for g in _genomes():
        for fid, s in _suggestions(g, cfgs):
            assert s.fact_id == fid
            assert s.predicted_gain == pytest.approx(_model_ratio(g, s.edit, cfgs),
                                                     rel=1e-12, abs=1e-15)
            assert s.predicted_gain != 0.0
            assert g.with_(**s.edit) != g
            seen += 1
    assert seen >= 10


def test_no_op_edits_are_never_suggested():
    """The loop body ignores rescale_mode and div_mode, and a gqa_pack edit
    on a suite without GQA changes nothing: no fact proposes them."""
    loop = seed_genome()
    ids = {fid for fid, _ in _suggestions(loop, mha_suite())}
    assert "branchless-rescale" not in ids and "deferred-div" not in ids
    assert "gqa-pack" not in ids
    assert not _suggestions(PIPELINED.with_(gqa_pack=True), mha_suite())


def test_seed_plan_follows_the_model():
    """From the seed the Hopper KB ranks the ring first, then block_skip, at
    the gains the model predicts; at the pipelined genome nothing is left
    that the model sees gain."""
    cfgs = mha_suite()
    kb = knowledge_for("h100")
    sv = Scorer(suite=cfgs, check_correctness=False, machine="h100",
                device="cpu")(seed_genome())
    ranked = kb.suggestions(seed_genome(), sv, cfgs, sv.dominant_bottleneck())
    assert ranked[0].fact_id == "dma-overlap"
    assert ranked[0].edit == {"kv_in_grid": True, "div_mode": "deferred"}
    assert ranked[0].predicted_gain > 0.3
    assert [s.fact_id for s in ranked][:2] == ["dma-overlap", "block-skip"]
    sv = Scorer(suite=cfgs, check_correctness=False, machine="h100",
                device="cpu")(PIPELINED)
    every = kb.suggestions(PIPELINED, sv, cfgs, *TAGS)
    assert all(s.predicted_gain < 0 for s in every)


def test_knowledge_for_picks_the_machine():
    assert knowledge_for("h100").facts == HOPPER_FACTS
    assert knowledge_for("tpu_v5e").facts == KnowledgeBase().facts == FACTS
    with pytest.raises(ValueError, match="unknown machine"):
        knowledge_for("a100")


def test_larger_blocks_point_back_to_the_tile():
    """block-sizing proposes 128-row and 128-key logical blocks from larger
    ones on causal suites, where the model sees a gain; a larger logical
    block never gains."""
    for bq, bk in ((1024, 512), (512, 1024), (2048, 256)):
        g = PIPELINED.with_(block_q=bq, block_k=bk)
        out = [s for fid, s in _suggestions(g, mha_suite()) if fid == "block-sizing"]
        edits = {tuple(sorted(s.edit.items())) for s in out}
        assert (("block_k", 128), ("block_q", 128)) in edits
        assert edits <= {(("block_q", 128),), (("block_k", 128),),
                         (("block_k", 128), ("block_q", 128))}
        assert all(s.predicted_gain > 0 for s in out)
