"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).

32L d_model=3072 32H (GQA kv=32 => MHA) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The modality frontend is a STUB per the brief: ``input_specs()`` provides
precomputed patch embeddings (already projected to d_model) that the model
splices over the first ``n_prefix_embeds`` sequence positions.
"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    pattern=(Block(kind="attn", window=None, mlp="gated_silu"),),
    modality="vision",
    n_prefix_embeds=144,          # 12x12 pooled CLIP patch grid, pre-projected
    tie_embeddings=False,
)
