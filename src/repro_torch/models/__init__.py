"""The LM stack of the port: the JAX package's ``repro.models`` for the
decoder-only architectures (the loss, prefill and decode).  ``encode`` and
``init_decode_cache`` are not ported yet and are not exported."""
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import (decode_step, init_params, lm_logits,
                                            lm_loss, prefill)

__all__ = ["decode_step", "init_params", "lm_logits", "lm_loss", "params_from_jax",
           "prefill"]
