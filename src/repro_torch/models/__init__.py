"""The LM stack of the port: the JAX package's ``repro.models`` for the
decoder-only and encoder-decoder architectures (the encoder, the loss,
prefill and decode)."""
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import (decode_step, encode, init_decode_cache,
                                            init_params, lm_logits, lm_loss, prefill)

__all__ = ["decode_step", "encode", "init_decode_cache", "init_params", "lm_logits",
           "lm_loss", "params_from_jax", "prefill"]
