"""The LM stack of the port: the serving path of the JAX package's
``repro.models`` (prefill and decode for the decoder-only architectures).
``encode``, ``lm_loss`` and ``init_decode_cache`` are not ported yet and are
not exported."""
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import (decode_step, init_params, lm_logits,
                                            prefill)

__all__ = ["decode_step", "init_params", "lm_logits", "params_from_jax", "prefill"]
