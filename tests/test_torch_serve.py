"""The port's BatchedServer against the JAX package's: reduced Jamba (an
attention layer, Mamba layers, dense and MoE MLPs), reduced gemma2-27b and
reduced seamless-m4t-medium (encoder-decoder, fed zero frames by both
servers), the same weights (``params_from_jax``), the same requests, greedy
decoding in fp32 on both sides.  The tokens must be the same."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro.launch.serve import Request as JaxRequest
from repro.models import init_params as jax_init_params
from repro_torch import serve as serve_cli
from repro_torch.configs.registry import get_arch
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import params_from_jax


def _requests(cls, cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, cfg.vocab_size, (int(rng.integers(3, 15)),))
                .astype(np.int32), max_new_tokens=int(rng.integers(4, 9)))
            for i in range(n)]


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "gemma2-27b", "seamless-m4t-medium"])
def test_batched_server_gives_the_jax_tokens(name):
    jcfg, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp))
    theirs = JaxBatchedServer(jcfg, jp, batch_size=2, max_len=32).run(
        _requests(JaxRequest, jcfg))
    server = BatchedServer(cfg, tp, batch_size=2, max_len=32)
    ours = server.run(_requests(Request, cfg))
    assert [r.output for r in ours] == [r.output for r in theirs]
    assert all(r.done for r in ours)
    assert [t["batch"] for t in server.timings] == [2, 2, 1]
    assert [len(t["decode_ms"]) for t in server.timings] == [
        max(r.max_new_tokens for r in ours[i:i + 2]) - 1 for i in (0, 2, 4)]


def test_serve_cli_runs_on_the_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--reduced", "--requests", "3",
                    "--batch-size", "2", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "serving jamba-v0.1-52b on cpu" in out
    assert out.count("req ") == 3 and "tok/s" in out


def test_serve_cli_serves_the_encoder_decoder_on_the_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--reduced", "--arch", "seamless-m4t-medium",
                    "--requests", "3", "--batch-size", "2", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "serving seamless-m4t-medium on cpu" in out
    assert out.count("req ") == 3 and "9 tokens in" in out


def test_serve_cli_refuses_to_guess_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--reduced"])
