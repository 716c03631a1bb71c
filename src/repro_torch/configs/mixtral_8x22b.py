"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ArchConfig, Block, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=(Block(kind="attn", window=4096, mlp="moe"),),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
    tie_embeddings=False,
)
