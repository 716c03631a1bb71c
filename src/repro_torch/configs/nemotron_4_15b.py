"""nemotron-4-15b [dense] — GQA with squared-ReLU MLP (ungated).

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000  [arXiv:2402.16819; unverified]
"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=256000,
    pattern=(Block(kind="attn", mlp="squared_relu"),),
    norm="layernorm",
    tie_embeddings=False,
)
