"""seamless-m4t-medium [audio] — encoder-decoder, multimodal backbone.

12L d_model=1024 16H (kv=16 => MHA) d_ff=4096 vocab=256206  [arXiv:2308.11596; hf]

Backbone only per the brief: the speech frontend is a STUB — ``input_specs()``
provides precomputed frame embeddings (B, S_enc, d_model) consumed by the
encoder.  12 encoder + 12 decoder layers (the "12L" of the assignment applied
to each stack, matching the HF config's 12-layer text decoder / 12-layer
speech-encoder adaptor).  Decoder blocks carry cross-attention.
"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                   # decoder depth
    n_enc_layers=12,               # encoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    pattern=(Block(kind="attn", mlp="relu", cross_attn=True),),
    enc_dec=True,
    modality="audio",
    norm="layernorm",
    tie_embeddings=False,
)
