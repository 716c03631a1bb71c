"""The mesh on the card: a one-rank NCCL process group, a (data=1,
model=1) mesh, and a reduced model's forward under it through the kernels
on each rank's local shards, against the same forward off the mesh.  Every
test needs a CUDA device and skips without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_mesh_gpu.py -m gpu -q
"""
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.distributed import context as ctx
from repro_torch.distributed.sharding import distribute_params
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ssd as sm
from repro_torch.launch.mesh import init_process_group, make_host_mesh
from repro_torch.models import decode_step, init_params, lm_logits, prefill

REL = 1e-5          # fp32, the same products on one rank


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sm_90a kernels have no CPU mode")
    resolve_device("cuda")


@pytest.mark.gpu
def test_one_rank_nccl_mesh_runs_the_kernels_on_local_shards(tmp_path):
    import torch.distributed as dist
    _need_card()
    assert init_process_group(str(tmp_path / "store"), 0, 1) == "nccl"
    try:
        mesh = make_host_mesh()
        assert mesh.device_type == "cuda" and tuple(mesh.mesh_dim_names) == ("data", "model")
        cfg = get_arch("jamba-v0.1-52b").reduced()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(1))
        kw = dict(compute_dtype=torch.float32, impl="kernel")
        with torch.no_grad():
            want = lm_logits(params, cfg, toks, **kw)
            want_tokens = []
            logits, cache = prefill(params, cfg, toks, 72, cache_dtype=torch.float32, **kw)
            for _ in range(4):
                want_tokens.append(torch.argmax(logits, -1))
                logits, cache = decode_step(params, cfg, cache, want_tokens[-1], **kw)
            ctx.set_mesh(mesh)
            try:
                placed = distribute_params(params, mesh, cfg)
                for fn in (fa.flash_attention, fd.flash_decode, sm.ssd_chunked):
                    fn.launches = 0
                got = lm_logits(placed, cfg, toks, **kw).full_tensor()
                got_tokens = []
                logits, cache = prefill(placed, cfg, toks, 72, cache_dtype=torch.float32, **kw)
                for _ in range(4):
                    got_tokens.append(torch.argmax(logits.full_tensor(), -1))
                    logits, cache = decode_step(placed, cfg, cache, got_tokens[-1], **kw)
            finally:
                ctx.set_mesh(None)
        assert float((got - want).abs().max() / want.abs().max()) <= REL
        assert all(torch.equal(a, b) for a, b in zip(got_tokens, want_tokens))
        assert fa.flash_attention.launches > 0 and sm.ssd_chunked.launches > 0
        assert fd.flash_decode.launches > 0
    finally:
        dist.destroy_process_group()
