"""The dry run of the port (``repro_torch.launch.specs``, ``dryrun`` and the
collective and memory counts of ``trace_analysis``) on the CPU.

* The meta-device specs, as ``test_launch_specs.py`` checks the JAX
  package's: shapes and dtypes of every cell's batch, the modality extras,
  mixtral-8x22b's parameters without allocation, the decode cache.
* One device against the JAX package: the port's meta trace and
  ``HloAnalysis`` of the jitted reference function, on reduced dense, MoE,
  hybrid and encoder-decoder configs, the same (B, S) on both sides.
  Prefill and decode dot FLOPs are equal exactly (seamless's prefill after
  adding back the cross K/V projection the reference repeats for its
  cache).  The train step's are equal exactly: the port's blocked attention
  and chunked SSD recompute each block's products in the backward as the
  reference's checkpointed steps do; on jamba 0.67 % fewer remain, which
  :data:`SSD_EINSUM_REL` bounds.  Total FLOPs within :data:`FLOPS_REL`.
  Bytes are not compared: the port runs eagerly and fuses nothing, so it
  moves 0.6-1.7x the bytes XLA's fused program does.
* Collectives on a fake (data=2, model=2) mesh against a hand count from
  the rules of ``distributed/sharding.py``.
* The CLI on the 256- and 512-rank meshes, against the JAX package's own
  record of the same cell, and a cell that raises.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch.hlo_analysis import HloAnalysis
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeCell, cells_for
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.trace_analysis import trace_summary
from repro_torch.models import init_decode_cache
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOUR = ("qwen2-7b", "mixtral-8x22b", "jamba-v0.1-52b", "seamless-m4t-medium")
SHAPES = {"prefill": (2, 256), "decode": (2, 128), "train": (4, 128)}
NM = 2                      # the train step's microbatches on both sides
# Total FLOPs: the port counts an elementwise FLOP per output element of
# every eager op, XLA one per element of its fused HLO; the port reads
# 0.89-0.985 of the reference on these configs, so it must lie within 15 %
# below it and never above.
FLOPS_REL = 0.15
# jamba's train step: the port counts 0.67 % fewer dot FLOPs.  The SSD's two
# three-operand einsums contract a broadcast operand in their backward, which
# XLA emits as a dot_general and PyTorch's autograd as a multiply and a sum
# (elementwise FLOPs); bound: 1 %.
SSD_EINSUM_REL = 0.01
# mamba2-780m decode_32k on the 256-rank mesh: the pod1 record's dot FLOPs
# and collective bytes by kind (chip_smoke.py's dryrun phase pins the same)
PINNED_POD1 = {"hlo_dot_flops": 808230912.0,
               "collective_bytes": {"all-gather": 11392000, "all-to-all": 2408448,
                                      "all-reduce": 12694528}}


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    return env


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def test_batch_specs_every_cell():
    for name in ARCHS:
        cfg = get_arch(name)
        for cell in cells_for(name):
            b = S.batch_specs(cfg, cell)
            for k in ("tokens", "labels"):
                assert b[k].shape == (cell.global_batch, cell.seq_len)
                assert b[k].dtype == torch.int64 and b[k].device.type == "meta"


def test_batch_specs_modality_extras():
    cell = SHAPES_BY_NAME["train_4k"]
    vlm = S.batch_specs(get_arch("phi-3-vision-4.2b"), cell)
    cfg = get_arch("phi-3-vision-4.2b")
    assert vlm["prefix_embeds"].shape == (256, cfg.n_prefix_embeds, cfg.d_model)
    aud = S.batch_specs(get_arch("seamless-m4t-medium"), cell)
    assert aud["enc_frames"].shape == (256, 4096, 1024)
    assert aud["enc_frames"].dtype == torch.bfloat16
    assert "enc_frames" not in S.batch_specs(get_arch("qwen2-7b"), cell)


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def test_param_specs_mixtral_allocates_nothing():
    before = _rss()
    params, spec = S.param_specs(get_arch("mixtral-8x22b"))     # ~141e9 parameters
    leaves = tree_leaves(params)
    grown = _rss() - before
    assert spec is None                                          # no mesh
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 100e9
    assert grown < 200 * 2**20, grown


def test_cache_and_opt_specs():
    cfg = get_arch("qwen2-7b")
    cell = SHAPES_BY_NAME["decode_32k"]
    cache = S.cache_specs(cfg, cell)
    k = cache["layers"]["pos0"]["k"]
    assert k.device.type == "meta"
    assert k.shape == (cfg.n_periods, 128, cfg.n_kv_heads, 32768, cfg.head_dim)
    pos = cache["pos"]          # a meta tensor: its value from the helper on the CPU
    assert pos.device.type == "meta" and pos.shape == () and pos.dtype == torch.int32
    assert init_decode_cache(cfg.reduced(), 1, cell.seq_len)["pos"] == 32767
    tok = S.token_specs(cfg, cell)
    assert tok.shape == (128,) and tok.dtype == torch.int64
    params, _ = S.param_specs(cfg.reduced())
    opt = S.opt_specs(params)
    assert opt.step.device.type == "cpu" and opt.step.dim() == 0
    assert all(t.device.type == "meta" for t in tree_leaves(opt.mu))


# ---------------------------------------------------------------------------
# one device against the JAX package
# ---------------------------------------------------------------------------


def _sds(tree):
    return jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)


def _jax_analysis(arch: str, kind: str) -> HloAnalysis:
    """``HloAnalysis`` of the JAX package's jitted step on one device, on
    abstract inputs of the shapes ``launch.specs`` gives (no mesh)."""
    from repro.distributed.context import set_mesh
    from repro.models import decode_step, init_decode_cache, init_params, prefill
    set_mesh(None)
    cfg = JAX_ARCHS[arch].reduced()
    B, L = SHAPES[kind]
    params = _sds(jax.eval_shape(functools.partial(init_params, cfg), jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((B, L), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, L), jnp.int32)}
    if cfg.enc_dec:
        batch["enc_frames"] = jax.ShapeDtypeStruct((B, L, cfg.d_model), jnp.bfloat16)
    if kind == "train":
        from repro.launch.train import make_train_step
        from repro.optim import adamw_init
        step = make_train_step(cfg, n_microbatches=NM, impl="blocked")
        lowered = jax.jit(step).lower(params, _sds(jax.eval_shape(adamw_init, params)),
                                      None, batch)
    elif kind == "prefill":
        extras = {k: v for k, v in batch.items() if k == "enc_frames"}
        lowered = jax.jit(lambda p, t, **ex: prefill(
            p, cfg, t, L, compute_dtype=jnp.bfloat16, cache_dtype=jnp.bfloat16,
            impl="blocked", **ex)).lower(params, batch["tokens"], **extras)
    else:
        enc_len = min(L, 4096) if cfg.enc_dec else 0
        cache = _sds(jax.eval_shape(functools.partial(init_decode_cache, cfg, B, L,
                                                      enc_len=enc_len)))
        lowered = jax.jit(lambda p, c, t: decode_step(
            p, cfg, c, t, compute_dtype=jnp.bfloat16, impl="blocked")).lower(
            params, cache, jax.ShapeDtypeStruct((B,), jnp.int32))
    return HloAnalysis(lowered.compile().as_text())


def _cross_cache_dot_flops(cfg, B: int, L: int) -> float:
    """The cross K and V projections of the memory, which the JAX package's
    prefill computes a second time for the cross cache (ROADMAP, known
    differences); the port keeps the cross-attention's own."""
    n_cross = cfg.n_periods * sum(1 for b in cfg.pattern if b.kind == "attn" and b.cross_attn)
    return n_cross * 2 * (2.0 * B * L * cfg.d_model * cfg.n_kv_heads * cfg.head_dim)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FOUR)
def test_one_device_counts_match_the_reference(arch, kind):
    cfg = ARCHS[arch].reduced()
    B, L = SHAPES[kind]
    ref = HloAnalysis.summary(_jax_analysis(arch, kind))
    traced = dryrun.trace_cell(cfg, ShapeCell("small", L, B, kind), None,
                               n_microbatches=NM)
    port = traced.counter.summary()
    assert port["collective_bytes"] == {} and port["collective_total_bytes"] == 0
    if kind == "prefill":
        assert port["dot_flops"] + _cross_cache_dot_flops(cfg, B, L) == ref["dot_flops"]
    elif kind == "decode":
        assert port["dot_flops"] == ref["dot_flops"]
    else:
        assert traced.n_microbatches == NM
        if cfg.ssm is None:
            assert port["dot_flops"] == ref["dot_flops"]
        else:
            assert 0 <= ref["dot_flops"] - port["dot_flops"] <= SSD_EINSUM_REL * ref["dot_flops"]
    assert (1 - FLOPS_REL) * ref["flops"] <= port["flops"] <= ref["flops"]


def test_trace_summary_without_a_mesh_is_rung1s():
    """Rung 1's dict: the same keys, collectives empty, and the counts of
    a hand-computed chain (test_torch_cascade's)."""
    def chain(a, b):
        return torch.exp(a @ b).sum()
    a = torch.empty(4, 8, device="meta")
    b = torch.empty(8, 3, device="meta")
    assert trace_summary(chain, a, b) == {
        "flops": 2 * 4 * 3 * 8 + 12 + 12, "dot_flops": 2 * 4 * 3 * 8, "ew_flops": 24,
        "bytes_accessed": (4 * 8 + 8 * 3 + 4 * 3) * 4 + 2 * 12 * 4 + 12 * 4 + 4,
        "collective_bytes": {}, "collective_count": {}, "collective_total_bytes": 0}


# ---------------------------------------------------------------------------
# collectives on a fake mesh, by hand
# ---------------------------------------------------------------------------

_FAKE_MESH = """
import json, torch
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
dryrun.fake_world(4)
mesh = make_host_mesh(model=2, device="cpu")
t = dryrun.trace_cell(get_arch("qwen2-7b").reduced(), ShapeCell("d", 16, 4, "decode"), mesh)
c = t.counter
print(json.dumps({"bytes": c.coll_bytes, "count": c.coll_count, "axis": c.coll_axis_bytes,
                  "sites": dict(c.coll_sites), "cuda": torch.cuda.is_initialized()}))
"""


def test_collectives_on_a_fake_mesh_equal_a_hand_count():
    """Reduced qwen2-7b (d_model 64, 4 Q heads and 1 KV head of 16, d_ff
    128, vocab 256, 2 layers, untied head), one decode step of batch 4 on
    (data=2, model=2): 2 rows a rank, bf16 activations, fp32 partials.
    Decode multiplies each weight on its shard (``spmd.dot``): FSDP shards
    every weight's other dim over "data", so a product that contracts it
    takes every data rank's rows of this rank's slice (an all-to-all of
    this rank's 2 x 64 inputs) and sums the fp32 partials over "data" (an
    all-reduce of all 4 rows), and one whose output dim it shards (wo,
    w_down, the table) gathers the 4 rows whole and sends each rank its
    rows of its columns (an all-to-all).  Q heads, the MLP hidden dim and
    the vocab split over "model"; the one KV head does not divide, so wk
    and wv gather their columns over "model"; the table's vocab rows are
    summed over "model" (each rank reads the tokens it holds).  Each
    split's output is summed over "model" in bf16.  No weight is
    gathered."""
    out = subprocess.run([sys.executable, "-c", _FAKE_MESH], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    bf16, f32, rows, rank_rows = 2, 4, 4, 2
    a2a_in = bf16 * rank_rows * 64                  # this rank's rows of a 64-wide input
    # per layer, over "data": (all-to-all in, fp32 partials) of wq (32 Q
    # columns a rank), wk and wv (8), w_gate and w_up (64); wo and w_down
    # (rows gathered whole: 32 and 64 wide; this rank's 32 columns out)
    data_a2a = 7 * a2a_in
    data_reduce = f32 * rows * (32 + 8 + 8 + 64 + 64)
    data_gather = bf16 * rows * (32 + 64)
    # per layer, over "model": wk and wv's 16 columns; the attention's and
    # the MLP's outputs summed
    model_gather = 2 * bf16 * rank_rows * 16
    model_reduce = 2 * bf16 * rank_rows * 64
    # the table (ids gathered over "data", rows summed over "model", its 32
    # columns out) and the head (256 / 2 vocab columns a rank)
    ids, table_sum, table_out = 8 * rows, bf16 * rows * 32, a2a_in
    head = a2a_in + f32 * rows * 128
    assert got["count"] == {"all-gather": 1 + 2 * 4, "all-reduce": 1 + 2 * 7 + 1,
                            "all-to-all": 1 + 2 * 7 + 1}
    assert got["bytes"] == {
        "all-gather": ids + 2 * (data_gather + model_gather),
        "all-reduce": table_sum + 2 * (data_reduce + model_reduce) + f32 * rows * 128,
        "all-to-all": table_out + 2 * data_a2a + a2a_in}
    assert got["axis"] == {
        "data": ids + table_out + 2 * (data_a2a + data_reduce + data_gather) + head,
        "model": table_sum + 2 * (model_gather + model_reduce)}
    # mlp_apply's sites, 2 layers each: w_gate and w_up (all-to-all and
    # partials), w_down (rows gathered, columns sent back), the sum of its
    # output over "model"; none gathers a weight
    mlp = sorted(b for site, b in got["sites"].items() if "models/layers.py" in site
                 and "mlp_apply" in site)
    assert mlp == sorted([2 * (a2a_in + f32 * rows * 64)] * 2
                         + [2 * bf16 * rows * 64, 2 * a2a_in, 2 * bf16 * rank_rows * 64])
    assert any("models/attention.py" in site for site in got["sites"])
    assert not any(">use" in site or "[use" in site for site in got["sites"])
    assert not got["cuda"]


_LOSS_SHARDS = """
import json
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer
dryrun.fake_world(4)
mesh = make_host_mesh(model=2, device="cpu")
t = dryrun.trace_cell(get_arch("qwen2-7b").reduced(), ShapeCell("t", 16, 4, "train"), mesh)
c = t.counter
print(json.dumps({"axis": c.coll_axis_bytes, "sites": dict(c.coll_sites),
                  "loss_shards": transformer.counts["loss_shards"]}))
"""
# the trace above with the loss's all-gather of the whole logits over
# "model" (the tree before the sharded log-softmax): its "model" bytes
# and that gather's, 2 rows x 16 positions x 256 fp32 logits
MODEL_BYTES_WITH_GATHER, LOSS_GATHER_BYTES = 168740, 2 * 16 * 256 * 4


def test_train_loss_reduces_the_vocab_shards_without_a_gather():
    """Reduced qwen2-7b (vocab 256), one train step of batch 4 and 16
    tokens on the fake (data=2, model=2) mesh: 2 rows a rank, 128 vocab
    columns a model rank.  ``lm_loss`` takes the log-softmax over each
    model rank's shard (``transformer._ShardNLL``): its only "model"
    collectives are three (2, 16) fp32 all-reduces (the row max, the sum
    of exponentials, the label's logit), 3 x 2 x 16 x 4 = 384 B, and none
    in the backward, where the whole logits were gathered (32 768 B).  The
    "model" bytes fall by that gather less those 384 B."""
    run = subprocess.run([sys.executable, "-c", _LOSS_SHARDS], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["loss_shards"] == 1                    # one microbatch, one loss call
    loss = {site: b for site, b in got["sites"].items()
            if "models/transformer.py" in site and site.split()[1] in ("lm_loss", "forward")}
    assert not any("gather" in site for site in loss), loss
    shards = {site: b for site, b in loss.items() if "[reduce_over]" in site}
    rows, seq, f32 = 2, 16, 4
    assert sorted(shards.values()) == [rows * seq * f32] * 3, shards
    assert sum(shards.values()) == 384
    assert got["axis"]["model"] == MODEL_BYTES_WITH_GATHER - LOSS_GATHER_BYTES + 384


_DECODE_RECORDS = """
import contextlib, json
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import spmd
from repro_torch.launch import dryrun
mesh = dryrun.production_mesh(False)
out = {}
for arch, cell in (("qwen2-7b", "decode_32k"), ("jamba-v0.1-52b", "long_500k")):
    cfg, c = get_arch(arch), SHAPES_BY_NAME[cell]
    for tag in ("shards", "gathered"):
        scope = spmd.stationary
        if tag == "gathered":                # every weight gathered, as prefill takes them
            spmd.stationary = contextlib.nullcontext
        rec = dryrun.analyze(cfg, c, dryrun.trace_cell(cfg, c, mesh), mesh)
        spmd.stationary = scope
        out[arch + " " + tag] = {k: rec[k] for k in ("collectives", "dominant", "hlo_dot_flops",
                                                     "top_collective_sites", "memory")}
print(json.dumps(out))
"""
# collective bytes a rank of a decode step on the 256-rank mesh, at most
DECODE_COLLECTIVE_BOUND = {"qwen2-7b": 1e9, "jamba-v0.1-52b": 0.5e9}


def test_decode_records_multiply_the_weight_shards():
    """qwen2-7b decode_32k (batch 128, 8 rows a data rank, the head
    fallback: 28 heads over model = 16) and jamba-v0.1-52b long_500k
    (batch 1, the rows whole on every rank) at full width on the fake
    256-rank mesh, against the same traces with every weight gathered
    (``spmd.stationary`` off): collective bytes a rank within
    ``DECODE_COLLECTIVE_BOUND``, the memory term dominant, dot FLOPs no
    higher (jamba's at least 4x lower: each data rank multiplies 1/16 of
    each weight), the live temp no higher (jamba's lower; qwen2-7b's peak
    is the blocked attention's scratch), and no top collective site gathers
    a product's weight or the table (``dot>use``, ``lookup>use``), as the
    gathered trace's top three do."""
    run = subprocess.run([sys.executable, "-c", _DECODE_RECORDS], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    for arch, bound in DECODE_COLLECTIVE_BOUND.items():
        new, old = got[arch + " shards"], got[arch + " gathered"]
        assert new["collectives"]["total_bytes"] <= bound, (arch, new["collectives"])
        assert old["collectives"]["total_bytes"] > 5 * bound, (arch, old["collectives"])
        assert new["dominant"] == "memory", (arch, new)
        assert new["hlo_dot_flops"] <= old["hlo_dot_flops"]
        assert new["memory"]["temp_bytes"] <= old["memory"]["temp_bytes"]
        assert not any(">use" in site for site, _ in new["top_collective_sites"]), arch
        assert all(">use" in site for site, _ in old["top_collective_sites"][:3]), arch
    new, old = got["jamba-v0.1-52b shards"], got["jamba-v0.1-52b gathered"]
    assert 4 * new["hlo_dot_flops"] <= old["hlo_dot_flops"]
    assert new["memory"]["temp_bytes"] < old["memory"]["temp_bytes"]


_ROW_SPLIT = """
import dataclasses, json
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.models import attention
mesh = dryrun.production_mesh(False)
cfg, cell = dataclasses.replace(get_arch("qwen2-7b"), n_layers=2), SHAPES_BY_NAME["prefill_32k"]
out = {}
for tag in ("rows", "heads"):
    if tag == "heads":                       # the head fallback: every rank all rows
        attention._row_split = lambda cfg, S: None
    attention.counts["row_split"] = 0
    c = dryrun.trace_cell(cfg, cell, mesh).counter
    out[tag] = {"sites": {s: f for s, f in c.dot_sites.items() if "models/attention.py" in s},
                "row_split": attention.counts["row_split"]}
print(json.dumps(out))
"""


def test_row_split_divides_the_attention_and_q_o_products():
    """qwen2-7b ``prefill_32k`` at full width, 2 of 28 layers, on the fake
    256-rank mesh: 32 rows over 16 data ranks, 2 a rank, S = 32768.  Its 28
    Q heads do not divide model = 16, so each self-attention takes the row
    split: each model rank's Q and O products and its blocked attention
    (QK^T and PV over all S keys) cover S / 16 query rows, K and V are
    projected from all S rows.  The dot FLOPs of ``models/attention.py``'s
    sites equal that hand count, and the same trace with the row split off
    (the head fallback) counts 16x the Q, O and attention FLOPs."""
    run = subprocess.run([sys.executable, "-c", _ROW_SPLIT], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    cfg = get_arch("qwen2-7b")
    L, Br, S, m = 2, 2, 32768, 16
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def count(rows):            # per site: wq, wo, the attention; wk and wv
        qo = L * 2.0 * Br * rows * D * Hq * Dh
        attn = L * 4.0 * Br * Hq * rows * S * Dh
        kv = L * 2.0 * Br * S * D * Hkv * Dh
        return sorted([qo, qo, attn, kv, kv])
    assert got["rows"]["row_split"] == L and got["heads"]["row_split"] == 0
    assert sorted(got["rows"]["sites"].values()) == count(S // m)
    assert sorted(got["heads"]["sites"].values()) == count(S)


_OWN_COLUMNS = """
import dataclasses, json
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.models import ssm
mesh = dryrun.production_mesh(False)
cfg, cell = dataclasses.replace(get_arch("mamba2-780m"), n_layers=2), SHAPES_BY_NAME["prefill_32k"]
out = {}
for tag in ("own", "whole"):
    if tag == "whole":                       # every column on every model rank
        ssm._own_route = lambda cfg: False
    ssm.counts["own_columns"] = 0
    c = dryrun.trace_cell(cfg, cell, mesh).counter
    out[tag] = {"sites": {s: f for s, f in c.dot_sites.items() if "models/ssm.py" in s},
                "own_columns": ssm.counts["own_columns"]}
print(json.dumps(out))
"""


def test_own_columns_divide_the_mamba_input_projection():
    """mamba2-780m ``prefill_32k`` at full width, 2 of 48 layers, on the
    fake 256-rank mesh: 32 rows over 16 data ranks, 2 a rank, S = 32768.
    Its 48 SSD heads split 3 a model rank, so each Mamba block projects
    only this rank's columns of ``in_proj``: z's and x's 192 channels, B
    and C whole (2 x 128) and dt's 3 heads, 643 of 6448.  The dot FLOPs of
    ``models/ssm.py``'s projection site equal that hand count, and the same
    trace with every column projected (``ssm._own_route`` off) counts the
    whole 6448; ``out_proj``'s site reads this rank's 192 channels in both,
    and the scan's site the same in both."""
    run = subprocess.run([sys.executable, "-c", _OWN_COLUMNS], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    cfg = get_arch("mamba2-780m")
    L, Br, S, m, D = 2, 2, 32768, 16, cfg.d_model
    s = cfg.ssm
    d_in = s.expand * D
    H = d_in // s.head_dim
    gn, n = s.n_groups * s.d_state, H // m
    own, whole = 2 * n * s.head_dim + 2 * gn + n, 2 * d_in + 2 * gn + H
    assert (own, whole) == (643, 6448)

    def by_function(sites):
        found = {}
        for site, flops in sites.items():
            name = site.split()[1]
            found[name] = found.get(name, 0) + flops
        return found
    a, b = by_function(got["own"]["sites"]), by_function(got["whole"]["sites"])
    assert set(a) == set(b) == {"_project", "_out", "mamba_apply"}, (a, b)
    assert got["own"]["own_columns"] == L and got["whole"]["own_columns"] == 0
    assert a["_project"] == L * 2.0 * Br * S * D * own
    assert b["_project"] == L * 2.0 * Br * S * D * whole
    assert a["_out"] == b["_out"] == L * 2.0 * Br * S * n * s.head_dim * D
    assert a["mamba_apply"] == b["mamba_apply"] > 0


_KV_COLUMNS = """
import dataclasses, json
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.models import attention
mesh = dryrun.production_mesh(False)
cfg, cell = dataclasses.replace(get_arch("h2o-danube-3-4b"), n_layers=2), SHAPES_BY_NAME["train_4k"]
out = {}
for tag in ("own", "whole"):
    if tag == "whole":                       # every KV head on every model rank
        attention._own_kv = lambda kv_range, return_kv: False
    attention.counts["kv_columns"] = 0
    c = dryrun.trace_cell(cfg, cell, mesh).counter
    out[tag] = {"sites": {s: f for s, f in c.dot_sites.items() if "models/attention.py" in s},
                "kv_columns": attention.counts["kv_columns"]}
print(json.dumps(out))
"""


def test_own_kv_heads_divide_the_k_v_projections():
    """h2o-danube-3-4b ``train_4k`` at full width, 2 of 24 layers, on the
    fake 256-rank mesh: 16 rows of 4096 over each of 16 data ranks.  Its 32
    Q heads split 2 a model rank and its 8 KV heads do not divide 16, so
    each model rank reads one KV head and, keeping no cache, projects only
    that head's 120 columns of ``wk`` and ``wv`` (``attention._own_kv``).
    The dot FLOPs of ``attn_apply``'s K and V sites (the forward and the
    per-layer recompute) equal that hand count, and the same trace with
    every KV head projected counts the whole 960 columns; the Q, O and
    attention sites are equal in both."""
    run = subprocess.run([sys.executable, "-c", _KV_COLUMNS], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    cfg = get_arch("h2o-danube-3-4b")
    L, passes, Br, S, m = 2, 2, 16, 4096, 16
    D, Dh = cfg.d_model, cfg.head_dim

    def count(cols):
        return L * passes * 2.0 * Br * S * D * cols
    own, whole = got["own"]["sites"], got["whole"]["sites"]
    assert got["own"]["kv_columns"] == L * passes and got["whole"]["kv_columns"] == 0
    shared = set(own) & set(whole)             # Q, O and the attention: the same lines
    assert len(shared) == 3 and all(own[s] == whole[s] for s in shared), (own, whole)
    assert sorted(own[s] for s in shared if "[dot]" in s) == [count(cfg.n_heads // m * Dh)] * 2
    assert sorted(f for s, f in own.items() if s not in shared) == [count(Dh)] * 2
    assert sorted(f for s, f in whole.items() if s not in shared) == \
        [count(cfg.n_kv_heads * Dh)] * 2


_LENGTH_MODEL = """
import dataclasses, json
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.models import attention, transformer
mesh = dryrun.production_mesh(False)
cfg, cell = dataclasses.replace(get_arch("qwen2-7b"), n_layers=2), SHAPES_BY_NAME["decode_32k"]
out = {}
for tag in ("split", "whole"):
    if tag == "whole":                       # the length kept whole on every model rank
        transformer._length_axes = lambda cfg, batch, length: None
    attention.counts["length_model"] = 0
    traced = dryrun.trace_cell(cfg, cell, mesh)
    rec = dryrun.analyze(cfg, cell, traced, mesh)
    out[tag] = {"sites": {s: f for s, f in traced.counter.dot_sites.items()
                          if "attn_decode" in s},
                "args": rec["memory"]["argument_bytes"],
                "coll": rec["collectives"]["by_axis"],
                "length_model": attention.counts["length_model"]}
print(json.dumps(out))
"""


def test_decode_32k_splits_the_cache_length_over_model():
    """qwen2-7b ``decode_32k`` at full width, 2 of 28 layers, on the fake
    256-rank mesh: 128 rows over 16 data ranks, 8 a rank, 32 768 keys.
    Its 28 Q heads and 4 KV heads divide no model axis of 16, so decode
    keeps every head on every model rank and splits each cache's length
    over "model": 2048 slots a rank.  Against the same trace with the
    length whole (``transformer._length_axes`` off): the attention's dot
    FLOPs (q K^T and p V over 28 heads) fall by 15/16, the cache's bytes
    among the arguments by 15/16, and the collective bytes over "model"
    rise by the partials' gather alone, B x Hq x (D + 2) fp32 from each of
    the 16 ranks a layer; the projections' sites are equal."""
    run = subprocess.run([sys.executable, "-c", _LENGTH_MODEL], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    split, whole = got["split"], got["whole"]
    L, Br, Hq, Hkv, Dh, Lc, m = 2, 8, 28, 4, 128, 32768, 16
    attn = L * 2 * 2 * Br * Hq * Lc * Dh
    kv = L * 2 * Br * Hkv * Lc * Dh * 2                 # bf16 K and V
    gathered = L * m * Br * Hq * (Dh + 2) * 4
    assert split["length_model"] == L and whole["length_model"] == 0
    assert max(whole["sites"].values()) == attn
    assert max(split["sites"].values()) == attn // m
    assert sum(whole["sites"].values()) - sum(split["sites"].values()) == attn - attn // m
    assert whole["args"] - split["args"] == kv - kv // m
    assert split["coll"]["model"] - whole["coll"].get("model", 0) == gathered
    assert split["coll"]["data"] == whole["coll"]["data"]


_HEAD_COLUMNS = """
import dataclasses, json
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.models import transformer
mesh = dryrun.production_mesh(False)
cell = SHAPES_BY_NAME["decode_32k"]
out = {}
for arch in ("seamless-m4t-medium", "mamba2-780m"):
    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    for tag in ("split", "whole"):
        split = transformer._uneven_vocab
        if tag == "whole":                   # every vocab column on every model rank
            transformer._uneven_vocab = lambda cfg: False
        transformer.counts["head_columns"] = 0
        traced = dryrun.trace_cell(cfg, cell, mesh)
        rec = dryrun.analyze(cfg, cell, traced, mesh)
        transformer._uneven_vocab = split
        out[arch + " " + tag] = {"sites": traced.counter.dot_sites,
                                 "coll": rec["collectives"]["by_axis"],
                                 "head_columns": transformer.counts["head_columns"]}
print(json.dumps(out))
"""


def test_decode_32k_splits_the_head_columns_over_model():
    """seamless-m4t-medium (untied head, V = 256 206) and mamba2-780m (tied,
    V = 50 280) ``decode_32k`` at full width, 2 layers, on the fake
    256-rank mesh: 128 rows over 16 data ranks.  Neither vocab divides
    model = 16, so the head's weight keeps its vocab whole over "model"
    and its d_model over "data" (64 and 96 rows a rank); each model rank
    computes only its ceil(V / 16) columns (16 013 and 3 143 on rank 0).
    Against the same trace with every column on every model rank
    (``transformer._uneven_vocab`` off): the head's dot FLOPs fall from
    2 x 128 x d x V to 2 x 128 x d x ceil(V / 16), the collective bytes
    over "data" by the fp32 partial logits of the other columns, 128 x (V -
    ceil(V / 16)) x 4, and "model"'s bytes and every other site are
    equal."""
    run = subprocess.run([sys.executable, "-c", _HEAD_COLUMNS], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    rows, m = 128, 16
    for arch, (d, V, own) in {"seamless-m4t-medium": (64, 256206, 16013),
                              "mamba2-780m": (96, 50280, 3143)}.items():
        split, whole = got[arch + " split"], got[arch + " whole"]
        assert own == -(-V // m) and d == get_arch(arch).d_model // m
        assert split["head_columns"] == 1 and whole["head_columns"] == 0
        head = [s for s in split["sites"] if "_head" in s]
        assert len(head) == 1 and set(split["sites"]) == set(whole["sites"]), arch
        assert split["sites"][head[0]] == 2 * rows * d * own
        assert whole["sites"][head[0]] == 2 * rows * d * V
        assert {s: f for s, f in split["sites"].items() if s not in head} == \
            {s: f for s, f in whole["sites"].items() if s not in head}
        assert whole["coll"]["data"] - split["coll"]["data"] == rows * (V - own) * 4
        assert split["coll"]["model"] == whole["coll"]["model"]


# ---------------------------------------------------------------------------
# the CLI on the production meshes
# ---------------------------------------------------------------------------


def test_cli_both_meshes_against_the_reference_record(tmp_path):
    cmd = ["--arch", "mamba2-780m", "--cell", "decode_32k", "--mesh", "both"]
    port = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *cmd,
                           "--out", str(tmp_path / "port")], env=_env(), cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", *cmd,
                          "--out", str(tmp_path / "ref")], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert port.returncode == 0, port.stdout[-2000:] + port.stderr[-2000:]
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-2000:]
    for tag, n in (("pod1", 256), ("pod2", 512)):
        name = f"mamba2-780m__decode_32k__{tag}.json"
        rec = json.loads((tmp_path / "port" / name).read_text())
        jrec = json.loads((tmp_path / "ref" / name).read_text())
        assert set(jrec) <= set(rec)
        assert rec["n_chips"] == jrec["n_chips"] == n
        assert rec["model_flops"] == jrec["model_flops"]
        assert rec["model_flops_per_chip"] == jrec["model_flops_per_chip"]
        assert rec["hlo_flops"] > 0
        assert rec["terms_s"]["memory"] > 0
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert rec["memory"]["temp_bytes"] < 80 * 2**30
        assert 0 < rec["useful_flops_frac"] < 5.0
        assert set(rec["collectives"]["by_axis"]) <= set(("pod", "data", "model")[-len(rec["mesh"]):])
        if tag == "pod1":
            assert rec["hlo_dot_flops"] == PINNED_POD1["hlo_dot_flops"]
            assert rec["collectives"]["bytes"] == PINNED_POD1["collective_bytes"]


def test_cli_exits_1_on_a_cell_that_raises(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--cell", "decode_32k", "--mesh", "single",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "FAIL" in capsys.readouterr().out
