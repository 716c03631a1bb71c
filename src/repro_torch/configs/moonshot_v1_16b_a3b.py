"""moonshot-v1-16b-a3b [moe] — kimi/moonlight family, 64 experts top-6.

48L d_model=2048 16H (GQA kv=16 => MHA) d_ff=1408 vocab=163840, MoE 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ArchConfig, Block, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=163840,
    pattern=(Block(kind="attn", mlp="moe"),),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408),
    tie_embeddings=False,
)
